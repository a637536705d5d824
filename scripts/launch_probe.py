#!/usr/bin/env python3
"""Probe the two launch fusions of the MNIST training path on the card:
the bias step carried by the dw launch (``csrc/gemm.cu``) and one gather
launch a minibatch (``csrc/gather.cu``), beside another version's
separate launches.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/launch_probe.py [--parent DIR] [--out FILE]

``--parent DIR`` is the root of another version's checkout (e.g. ``git
archive`` of the parent commit unpacked under ``build/``), whose
``csrc/gemm.cu`` has the separate ``veles_gd_db`` entry and whose
``csrc/gather.cu`` has ``veles_gather_rows`` and ``veles_gather_norm``.
Its two sources are built beside this checkout's (one ``nvcc`` each, in
parallel) and loaded with ctypes.  Every call is held against the plain
version first, then timed as device time a call (calls queued behind a
spinning kernel, one CUDA-event pair around them:
``chip_smoke.device_ms``), back to back on the same operands, in the
order parent, change, change, parent:

- the GD step's dw and bias at layer 1 (100 x 784 x 100, tanh, split 4),
  layer 2 (100 x 100 x 10, linear, split 4) and 4096^3 (tanh, the big
  tile): the parent's dw launch and db launch, each and the pair; this
  version's dw launch carrying the bias step, and the same launch
  without it; and, between the change's two passes, dw without the
  bias step in two copies of this version's ``gemm.cu`` with one edit
  each (``VARIANTS``: the bias code compiled out; act'(y) left to the
  compiler's contraction, as the parent computes it), which tell what
  dw alone pays for each;
- a minibatch's gather: the eager route's 100 rows of a (7000, 784) f32
  table and of the (7000,) int32 labels, and the stitched head's u8 rows
  normalized with the labels: the parent's two launches, each and the
  pair; this version's one group launch.

Then, with ``--parent``, the stitched MNIST route's steady epoch
(``chip_smoke._mnist_stitched_profile``: epoch 1 of a ``max_epochs=3``
run under ``torch.profiler``) in a fresh process of each checkout,
parent, change, change, parent: wall and busy time, kernels a
minibatch, device time of the GEMM and gather groups.  Prints the
card's name and power limit, then one JSON object a line, and writes
them all to ``--out``.
"""

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: (batch, inputs, neurons, activation) of the GD shapes probed
GD_SHAPES = ((100, 784, 100, "tanh"), (100, 100, 10, None),
             (4096, 4096, 4096, "tanh"))
GD_HP = (0.03, 0.03, 0.0005, 0.0005, 0.9, 0.9)
#: the MNIST tables: rows, features, minibatch
GATHER = (7000, 784, 100)
#: copies of this version's gemm.cu with one edit each: name -> (text,
#: its replacement)
VARIANTS = {
    "no_bias_code": ("const bool bias_block = BIAS && P.b != nullptr &&",
                     "const bool bias_block = false && P.b != nullptr &&"),
    "contracted_derivative": (
        "return __fadd_rn(__fmul_rn(__fmul_rn(y, y), -0.388484177f),\n"
        "                       1.14381894f);",
        "return y * y * (-0.388484177f) + 1.14381894f;"),
}
_P, _I, _L, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_ulonglong, ctypes.c_float)
#: the parent's C entries this probe calls: symbol -> argtypes
PARENT_ENTRIES = {
    "gemm": {"veles_gd_dw": [_P] * 5 + [_I] * 3 + [_L] * 2 + [_I] * 2
             + [_F] * 4 + [_P] * 3 + [_I] * 2 + [_P],
             "veles_gd_db": [_P] * 4 + [_I] * 3 + [_F] * 4 + [_P] * 4},
    "gather": {"veles_gather_rows": [_P] * 3 + [_L, _I, _L, _U, _P],
               "veles_gather_norm": [_P, _I, _P, _P, _L, _I, _L, _P, _P,
                                     _I, _P]}}
#: the stitched epoch's profile, run in a fresh process of a checkout:
#: prints its summary as the last line
EPOCH_SCRIPT = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from veles_tpu_torch.backends import set_precision
from veles_tpu_torch.config import root
root.common.engine.precision_level = 2
set_precision()
with cs.engine_knobs(stitch="on", loader="auto", epoch_scan="off"):
    summary = cs._mnist_stitched_profile(torch.device("cuda", 0))
if isinstance(summary, tuple):
    summary = summary[0]
print(json.dumps(summary))
"""


def emit(rows, obj):
    rows.append(obj)
    print(json.dumps(obj), flush=True)


def ptxas_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def build_copies(parent, work):
    """The parent's gemm.cu and gather.cu (with ``parent``) and this
    version's ``VARIANTS``, one nvcc each in parallel: ``{symbol or
    variant: loaded entry}`` and the ptxas lines."""
    from veles_tpu_torch.ops import build, gemm
    sources = {}
    if parent:
        for name in PARENT_ENTRIES:
            sources["parent_" + name] = (
                Path(parent) / "veles_tpu_torch" / "csrc" / (name + ".cu"))
    text = (build.CSRC_DIR / "gemm.cu").read_text()
    for name, (old, new) in VARIANTS.items():
        if text.count(old) != 1:
            raise RuntimeError("variant %s: its text is not in gemm.cu"
                               % name)
        sources[name] = work / (name + ".cu")
        sources[name].write_text(text.replace(old, new))
    procs = {}
    for label, src in sources.items():
        target = work / ("lib%s.so" % label)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
               "-o", str(target), str(src)]
        procs[label] = (target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    entries, reports = {}, {}
    for label, (target, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed on %s:\n%s" % (label, out))
        reports[label] = ptxas_lines(out)
        lib = ctypes.CDLL(str(target))
        if label in VARIANTS:
            symbol, argtypes = gemm._ARGTYPES["gd_dw"]
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            entries[label] = fn
            continue
        for symbol, argtypes in PARENT_ENTRIES[label[7:]].items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            entries[symbol] = fn
    return entries, reports


def _checked(status, name):
    if status:
        raise RuntimeError("%s launch failed: CUDA error %d" % (name, status))


def parent_gd(entries, x, eo, y, w, vw, b, vb, act, tile_split):
    """The parent's dw launch and db launch: ``(dw, db)`` closures over
    the given tensors (updated in place)."""
    from veles_tpu_torch.ops import gemm
    from veles_tpu_torch.ops.util import stream_handle
    batch, n = eo.shape
    f = x.shape[1]
    code = gemm.ACTIVATION_CODES[act]
    stream = stream_handle(eo.device)
    lr, lr_b, decay, decay_b, moment, moment_b = GD_HP

    def dw():
        _checked(entries["veles_gd_dw"](
            x.data_ptr(), eo.data_ptr(), y.data_ptr(), w.data_ptr(),
            vw.data_ptr(), batch, f, n, x.stride(0), x.stride(1), 0, code,
            1.0 / batch, lr, decay, moment, None, None, None, *tile_split,
            stream), "parent gd_dw")

    def db():
        _checked(entries["veles_gd_db"](
            eo.data_ptr(), y.data_ptr(), b.data_ptr(), vb.data_ptr(), batch,
            n, code, 1.0 / batch, lr_b, decay_b, moment_b, None, None, None,
            stream), "parent gd_db")
    return dw, db


@contextlib.contextmanager
def dw_entry(fn):
    """The package's gd_dw wrapper launches ``fn`` inside the block."""
    from veles_tpu_torch.ops import gemm
    saved = dict(gemm._entries)
    gemm._entries["gd_dw"] = fn
    try:
        yield
    finally:
        gemm._entries.clear()
        gemm._entries.update(saved)


def probe_gd(rows, entries, device, order):
    import chip_smoke
    from veles_tpu_torch.ops import gemm
    rng = numpy.random.default_rng(0)
    half = len(order) // 2        # the variants between the change's passes
    order = order[:half] + list(VARIANTS) + list(VARIANTS)[::-1] \
        + order[half:]
    for batch, f, n, act in GD_SHAPES:
        big = batch == 4096
        tol = chip_smoke.GEMM_BIG_TOL if big else chip_smoke.GEMM_TOL
        x, y, eo, w, b, vw, vb = chip_smoke._gd_operands(
            rng, device, batch, f, n, False, big)
        want = gemm._gd_ref(x, y, eo, w, b, vw, vb, *GD_HP, activation=act)
        tile_split = gemm.plan(f, n, batch)
        reps = 5 if big else 20
        for version in order:
            params = [t.clone() for t in (w, vw, b, vb)]
            if version in VARIANTS:
                with dw_entry(entries[version]):
                    gemm._gd_dw_cuda(x, eo, y, params[0], params[1],
                                     1.0 / batch, *GD_HP[0::2], act, False)
                    ok = all(chip_smoke._within(got, ref, tol)["outside_tol"]
                             == 0 for got, ref in zip(params[:2],
                                                      (want[0], want[2])))
                    alone = chip_smoke.device_ms(lambda: gemm._gd_dw_cuda(
                        x, eo, y, params[0], params[1], 1.0 / batch,
                        *GD_HP[0::2], act, False), reps)
                emit(rows, {"probe": "gd", "version": version,
                            "shape": [batch, f, n], "activation": act,
                            "ok": ok, "dw_alone_ms": alone})
                continue
            if version == "parent":
                dw, db = parent_gd(entries, x, eo, y, *params, act,
                                   tile_split)
                dw()
                db()
            else:
                def dw(with_bias=True, p=params):
                    gemm._gd_dw_cuda(
                        x, eo, y, p[0], p[1], 1.0 / batch, *GD_HP[0::2], act,
                        False, bias=(p[2], p[3], *GD_HP[1::2])
                        if with_bias else None)
                dw()
            errors = [chip_smoke._within(got, ref, tol) for got, ref in zip(
                params, (want[0], want[2], want[1], want[3]))]
            row = {"probe": "gd", "version": version,
                   "shape": [batch, f, n], "activation": act,
                   "tile_split": list(tile_split),
                   "ok": not any(e["outside_tol"] for e in errors),
                   "max_abs_err": max(e["max_abs_err"] for e in errors)}
            if version == "parent":
                row.update(
                    dw_ms=chip_smoke.device_ms(dw, reps),
                    db_ms=chip_smoke.device_ms(db, reps),
                    pair_ms=chip_smoke.device_ms(lambda: (dw(), db()),
                                                 reps))
            else:
                row.update(
                    dw_bias_ms=chip_smoke.device_ms(dw, reps),
                    dw_alone_ms=chip_smoke.device_ms(lambda: dw(False),
                                                     reps))
            emit(rows, row)
        del x, y, eo, w, b, vw, vb
        torch.cuda.empty_cache()


def parent_gathers(entries, data, labels, idx, norm):
    """The parent's launches of one minibatch: the data row (gather_rows,
    or gather_norm where ``norm`` is given) and the labels
    (gather_rows, pad -1), as closures, and their outputs."""
    from veles_tpu_torch.ops import gather
    from veles_tpu_torch.ops.util import stream_handle
    stream = stream_handle(data.device)
    n_idx = idx.shape[0]
    out = torch.empty((n_idx,) + tuple(data.shape[1:]), device=data.device,
                      dtype=torch.float32 if norm else data.dtype)
    out_labels = torch.empty(n_idx, dtype=labels.dtype, device=data.device)
    f = data[0].numel()

    def rows():
        if norm:
            _checked(entries["veles_gather_norm"](
                data.data_ptr(), gather.NORM_DTYPES[data.dtype],
                idx.data_ptr(), out.data_ptr(), data.shape[0], n_idx, f,
                norm[0].data_ptr(), norm[1].data_ptr(), 0, stream),
                "parent gather_norm")
        else:
            _checked(entries["veles_gather_rows"](
                data.data_ptr(), idx.data_ptr(), out.data_ptr(),
                data.shape[0], n_idx, f * data.element_size(),
                gather._pad_pattern(0, data.dtype), stream),
                "parent gather")

    def label_rows():
        _checked(entries["veles_gather_rows"](
            labels.data_ptr(), idx.data_ptr(), out_labels.data_ptr(),
            labels.shape[0], n_idx, labels.element_size(),
            gather._pad_pattern(-1, labels.dtype), stream), "parent gather")
    return rows, label_rows, [out, out_labels]


def probe_gather(rows_out, entries, device, order):
    import chip_smoke
    from veles_tpu_torch.ops import gather
    rng = numpy.random.default_rng(1)
    n, f, b = GATHER
    idx = chip_smoke._gather_indices(rng, device, n, b)
    labels = chip_smoke._gather_table(rng, device, torch.int32, (n,))
    norm = gather.affine_tensors((1.0 / 255.0, 0.0), device)
    for route, dtype, how in (("eager", torch.float32, 0),
                              ("stitched", torch.uint8, norm)):
        data = chip_smoke._gather_table(rng, device, dtype, (n, f))
        tables = [(data, how), (labels, -1)]
        want = gather._gather_group_ref(tables, idx)
        for version in order:
            if version == "parent":
                data_fn, labels_fn, outs = parent_gathers(
                    entries, data, labels, idx, how if how != 0 else None)
                data_fn()
                labels_fn()
                times = {"data_ms": chip_smoke.device_ms(data_fn),
                         "labels_ms": chip_smoke.device_ms(labels_fn),
                         "pair_ms": chip_smoke.device_ms(
                             lambda: (data_fn(), labels_fn()))}
            else:
                outs = gather._gather_group_cuda(tables, idx)
                times = {"group_ms": chip_smoke.device_ms(
                    lambda: gather._gather_group_cuda(tables, idx))}
            chip_smoke.gpu_sync()
            exact = all(torch.equal(o, w) for o, w in zip(outs, want))
            emit(rows_out, dict(times, probe="gather", route=route,
                                version=version, exact=exact))


def probe_epoch(rows, parent, order):
    """The stitched steady epoch in a fresh process of each checkout."""
    roots = {"parent": Path(parent), "change": REPO}
    for version in order:
        tic = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", EPOCH_SCRIPT],
                              cwd=str(roots[version]), capture_output=True,
                              text=True, timeout=900)
        if proc.returncode:
            raise RuntimeError("the %s epoch failed:\n%s" % (
                version, proc.stderr[-3000:]))
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        by_group = summary["device_ms_by_group"]
        emit(rows, {"probe": "stitched_epoch", "version": version,
                    "process_s": time.perf_counter() - tic,
                    **{key: summary[key] for key in (
                        "wall_ms", "device_busy_ms", "busy_share",
                        "minibatches", "kernels_per_minibatch",
                        "host_gaps_ms_total", "kernels_by_group")},
                    "device_ms_by_group": by_group})


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="the root of another version's "
                        "checkout (its csrc/gemm.cu and csrc/gather.cu)")
    parser.add_argument("--out", default="build/launch_probe/probe.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("launch_probe: no CUDA device", file=sys.stderr)
        return 1
    from veles_tpu_torch.backends import set_precision
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import build
    root.common.engine.precision_level = 2
    set_precision()
    device = torch.device("cuda", 0)
    rows = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    emit(rows, {"probe": "device", "nvidia_smi": smi})
    tic = time.perf_counter()
    work = build.BUILD_DIR.parent / "launch_probe"
    work.mkdir(parents=True, exist_ok=True)
    entries, reports = build_copies(args.parent, work)
    order = ["parent", "change", "change", "parent"] if args.parent \
        else ["change"]
    build.build_all(("gemm", "gather"))
    emit(rows, {"probe": "build", "seconds": time.perf_counter() - tic,
                "ptxas": {name: ptxas_lines(build.build_log[name]["ptxas"])
                          for name in ("gemm", "gather")},
                "copies_ptxas": reports})
    probe_gd(rows, entries, device, order)
    probe_gather(rows, entries, device, order)
    if args.parent:
        probe_epoch(rows, args.parent, order)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
