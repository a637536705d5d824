#!/usr/bin/env python3
"""Probe the f32 GEMM body of ``csrc/gemm.cu`` on the card: tiles, K
splits, and another version beside this one.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/gemm_probe.py [--parent DIR] [--out FILE]

It builds ``csrc/gemm.cu`` as the package does, and copies with another
constant (``VARIANTS``: a 64 x 64 split tile instead of 32 x 32; the big
tile at one block an SM instead of two), all compiled in parallel, and
prints each build's ptxas report.  At the MNIST main-path shapes (layer
1's forward and dw, layer 2's forward, dx and dw) every GEMM entry runs
on the split tile under each K split (1, 2, 4, 8) in both sizes and on
the big 128 x 128 tile; at 4096^3 on the big tiles and the unsplit
split tiles.  Each run is held against its plain version (``_matmul_ref``,
``_gd_ref``), then timed as device time per launch: 20 launches queued
behind a spinning kernel, one CUDA-event pair around them.  The
``torch.addmm`` / ``torch.mm`` call of the same product is timed on the
same measure.  With ``--parent DIR`` (a directory holding another
version's ``gemm.cu``, with the C entries of the body before the tile and
split arguments) that version is built and timed beside it in the same
run.  Last, one steady-state epoch of the stitched MNIST route (the
``mnist_stitched`` profile window of ``chip_smoke.py``: 70 minibatches,
two CUDA graph replays each on train minibatches) runs under the
profiler with the package's GEMM entries bound to each build in turn,
parent, change, change, parent, in the same process; its wall time,
device busy time and GEMM device time are printed.  Prints one JSON
object a line and writes them all to ``--out``.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SPLITS = (1, 2, 4, 8)
#: name -> csrc/gemm.cu's constants in that copy
VARIANTS = {"split64": {"SPLIT_BM": 64, "SPLIT_BN": 64},
            "big_b1": {"BIG_MIN_BLOCKS": 1}}
BIG = 4096
GD_HP = (0.03, 0.0005, 0.9)            # lr, decay, moment
TOL = (1e-5, 1e-5)
BIG_TOL = (1e-4, 1e-4)
#: (kernel, (M, K, N) of the product, activation): the MNIST main path's
#: calls, then 4096^3
CASES = (("matmul", (100, 784, 100), "tanh"),
         ("matmul", (100, 100, 10), None),
         ("gd_dx", (100, 10, 100), None),
         ("gd_dw", (784, 100, 100), "tanh"),
         ("gd_dw", (100, 100, 10), None),
         ("matmul", (BIG, BIG, BIG), None),
         ("gd_dx", (BIG, BIG, BIG), "tanh"),
         ("gd_dw", (BIG, BIG, BIG), "tanh"))
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
#: the C entries before they took (tile, split)
PARENT_ARGTYPES = {
    "matmul": [_P] * 4 + [_I] * 3 + [_L] * 4 + [_I, _P],
    "gd_dx": [_P] * 4 + [_I] * 3 + [_L] * 2 + [_I, _P],
    "gd_dw": [_P] * 5 + [_I] * 3 + [_L] * 2 + [_I] * 2 + [_F] * 4
    + [_P] * 4,
}


def emit(rows, obj):
    rows.append(obj)
    print(json.dumps(obj), flush=True)


def device_ms(fn, reps=20):
    """Device time of one call: ``reps`` calls queued behind a spinning
    kernel run back to back once it ends, one event pair around them."""
    fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - tic
    torch.cuda.synchronize()
    cycles = int(4 * host_s * 2.0e9) + 100000
    for _ in range(4):
        spin = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        tic = time.perf_counter()
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_ms = (time.perf_counter() - tic) * 1e3
        end.synchronize()
        if queued_ms < spin.elapsed_time(start):
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("the host queued the calls more slowly than the "
                       "spin lasted")


def ptxas_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def build_copies(copies):
    """``{label: (source path, target .so)}``: one nvcc each, in
    parallel, headers from ``csrc/``; returns ``{label: ptxas lines}``."""
    from veles_tpu_torch.ops import build
    procs = {}
    for label, (src, target) in copies.items():
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
               "-o", str(target), str(src)]
        procs[label] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    reports = {}
    for label, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed on %s:\n%s" % (label, out))
        reports[label] = ptxas_lines(out)
    return reports


class Library(object):
    """One build's three GEMM entries; ``planned`` ones take (tile,
    split), the parent's do not."""

    def __init__(self, path, planned):
        from veles_tpu_torch.ops import gemm
        lib = ctypes.CDLL(str(path))
        self.planned = planned
        self.entries = {}
        for name in ("matmul", "gd_dx", "gd_dw"):
            symbol, argtypes = gemm._ARGTYPES[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes if planned else PARENT_ARGTYPES[name]
            fn.restype = ctypes.c_int
            self.entries[name] = fn

    def call(self, name, args, tile_split, stream):
        from veles_tpu_torch.ops.util import check_status
        extra = list(tile_split) if self.planned else []
        check_status(name, self.entries[name](*args, *extra, stream))


def operands(rng, device, kernel, shape, act):
    """The C arguments (without tile, split, stream), the plain
    version's outputs, the outputs the call writes, the one PyTorch call
    of the same product, a reset of the outputs updated in place, and
    the tensors the arguments point into (kept alive by the caller)."""
    from veles_tpu_torch.ops import gemm
    m, k, n = shape
    big = m == BIG

    def rand(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(
            numpy.float32)).to(device)
    code = gemm.ACTIVATION_CODES[act]
    if kernel == "matmul":
        a, w, bias = rand(m, k), rand(k, n, scale=k ** -0.5), rand(n)
        out = torch.empty((m, n), device=device)
        args = [a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                m, n, k, a.stride(0), a.stride(1), w.stride(0), w.stride(1),
                code]
        return (args, [gemm._matmul_ref(a, w, bias, act)], [out],
                lambda: torch.addmm(bias, a, w), None, (a, w, bias))
    # gd_dx: err_input (batch = m, f = n) from n neurons = k;
    # gd_dw: dW (f = m, neurons = n) over the batch = k
    batch, f, neurons = (m, n, k) if kernel == "gd_dx" else (k, m, n)
    x = rand(batch, f, scale=batch ** -0.5 if big else 1.0)
    y = torch.tanh(rand(batch, neurons))
    eo = rand(batch, neurons)
    w = rand(f, neurons, scale=(neurons if big else f) ** -0.5)
    vw = rand(f, neurons, scale=0.01)
    b, vb = torch.zeros(neurons, device=device), torch.zeros(
        neurons, device=device)
    delta = eo * gemm._derivative(y, act)
    want = gemm._gd_ref(x, y, eo, w, b, vw, vb, GD_HP[0], GD_HP[0],
                        GD_HP[1], GD_HP[1], GD_HP[2], GD_HP[2],
                        activation=act)
    if kernel == "gd_dx":
        out = torch.empty((batch, f), device=device)
        args = [eo.data_ptr(), y.data_ptr(), w.data_ptr(), out.data_ptr(),
                batch, neurons, f, w.stride(1), w.stride(0), code]
        return (args, [want[4]], [out], lambda: torch.mm(delta, w.t()),
                None, (eo, y, w))
    w1, vw1 = w.clone(), vw.clone()
    args = [x.data_ptr(), eo.data_ptr(), y.data_ptr(), w1.data_ptr(),
            vw1.data_ptr(), batch, f, neurons, x.stride(0), x.stride(1), 0,
            code, 1.0 / batch, *GD_HP, None, None, None]

    def reset():
        w1.copy_(w)
        vw1.copy_(vw)
    return (args, [want[0], want[2]], [w1, vw1],
            lambda: torch.mm(x.t(), delta), reset, (x, eo, y, w, vw))


def configs(shape):
    """(build, (tile, split)) pairs timed at a shape."""
    if shape[0] == BIG:
        return [("change", (1, 1)), ("big_b1", (1, 1)), ("change", (0, 1)),
                ("split64", (0, 1))]
    return ([("change", (1, 1)), ("big_b1", (1, 1))]
            + [(label, (0, s)) for label in ("change", "split64")
               for s in SPLITS])


def probe(rows, libraries, device):
    from veles_tpu_torch.ops import gemm
    from veles_tpu_torch.ops.util import stream_handle
    stream = stream_handle(device)
    rng = numpy.random.default_rng(0)
    for kernel, shape, act in CASES:
        args, want, outs, library, reset, _keep = operands(
            rng, device, kernel, shape, act)
        tol = BIG_TOL if shape[0] == BIG else TOL
        reps = 5 if shape[0] == BIG else 20
        runs = [(label, ts) for label, ts in configs(shape)
                if label in libraries]
        if "parent" in libraries:
            runs.append(("parent", None))
        for label, tile_split in runs:
            lib = libraries[label]

            def call(lib=lib, tile_split=tile_split):
                lib.call(kernel, args, tile_split, stream)
            if reset is not None:
                reset()
            call()
            torch.cuda.synchronize()
            err = max(float((o - w).abs().max()) for o, w in zip(outs, want))
            ok = all(bool(((o - w).abs() <= tol[0] + tol[1] * w.abs()).all())
                     for o, w in zip(outs, want))
            first = [o.clone() for o in outs]
            if reset is not None:
                reset()
            call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(first, outs))
            emit(rows, {"probe": "gemm", "kernel": kernel, "shape": shape,
                        "activation": act, "version": label,
                        "tile_split": tile_split, "max_abs_err": err,
                        "ok": ok, "bit_equal_relaunch": same,
                        "device_ms": device_ms(call, reps)})
        emit(rows, {"probe": "gemm", "kernel": kernel, "shape": shape,
                    "version": "library", "plan": gemm.plan(
                        *((shape[0], shape[2], shape[1]))),
                    "device_ms": device_ms(library, reps)})


def probe_mnist(rows, libraries, device):
    """``chip_smoke.py``'s profiled stitched MNIST epoch with the GEMM
    entries of each build (the parent's take no tile and split, so they
    are dropped before the stream)."""
    import chip_smoke
    from veles_tpu_torch.ops import gemm
    own = gemm._entry
    order = (["parent", "change", "change", "parent"]
             if "parent" in libraries else ["change"])
    for label in order:
        lib = libraries[label]

        def entry(name, lib=lib):
            if name not in lib.entries:
                return own(name)
            if lib.planned:
                return lib.entries[name]
            fn = lib.entries[name]
            return lambda *args: fn(*args[:-3], args[-1])
        gemm._entry = entry
        try:
            with chip_smoke.engine_knobs(stitch="on", loader="auto",
                                         epoch_scan="off"):
                summary = chip_smoke._mnist_stitched_profile(device)
        finally:
            gemm._entry = own
        groups = summary["device_ms_by_group"]
        emit(rows, {"probe": "mnist_stitched_epoch", "version": label,
                    "minibatches": summary["minibatches"],
                    "wall_ms": summary["wall_ms"],
                    "device_busy_ms": summary["device_busy_ms"],
                    "busy_share": summary["busy_share"],
                    "host_gaps_ms_total": summary["host_gaps_ms_total"],
                    "gemm_device_ms": {g: groups.get(g, 0.0) for g in (
                        "veles_matmul", "veles_gd_dx", "veles_gd_dw")},
                    "device_ms_by_group": groups})


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="a directory with another "
                        "version's gemm.cu")
    parser.add_argument("--out", default="build/gemm_probe/gemm_probe.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gemm_probe: no CUDA device", file=sys.stderr)
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
    emit(rows, {"probe": "device", "nvidia_smi": smi})

    tic = time.perf_counter()
    build.build_all(("gemm",))
    work = build.BUILD_DIR.parent / "gemm_probe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = (build.CSRC_DIR / "gemm.cu").read_text()
    copies = {}
    for label, edits in VARIANTS.items():
        text = base
        for name, value in edits.items():
            text, count = re.subn(r"constexpr int %s = \d+;" % name,
                                  "constexpr int %s = %d;" % (name, value),
                                  text)
            if count != 1:
                raise RuntimeError("no single constant %s to edit" % name)
        (work / ("gemm_%s.cu" % label)).write_text(text)
        copies[label] = (work / ("gemm_%s.cu" % label),
                         work / ("lib%s.so" % label))
    if args.parent:
        copies["parent"] = (Path(args.parent) / "gemm.cu",
                            work / "libparent_gemm.so")
    reports = build_copies(copies)
    emit(rows, {"probe": "build", "seconds": time.perf_counter() - tic,
                "ptxas": ptxas_lines(build.build_log["gemm"]["ptxas"]),
                "variants_ptxas": reports})
    libraries = {"change": Library(build.library_path("gemm"), True)}
    for label in VARIANTS:
        libraries[label] = Library(copies[label][1], True)
    if args.parent:
        libraries["parent"] = Library(copies["parent"][1], False)
    probe(rows, libraries, device)
    probe_mnist(rows, libraries, device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
