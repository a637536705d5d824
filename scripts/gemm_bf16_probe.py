#!/usr/bin/env python3
"""Time the bf16 GEMM bodies (``csrc/gemm_bf16.cu``
``veles_matmul_bf16``) on the card at their main-path shapes, beside
another version's and ``torch.addmm``'s.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/gemm_bf16_probe.py [--check] [--variants] [--trace]
        [--experiments] [--parent DIR] [--out FILE]

At each shape of ``chip_smoke.GEMM_BF16_TIMED`` (the fused MNIST step's
products, AlexNet's fc6 and fc7 products at batch 128 with their
transposed views, 4096^3) it times this checkout's wrapper
(``gemm._matmul_cuda``: the body, tile and split its plan picks) as
device time per call: calls queued behind a spinning kernel, one
CUDA-event pair around them, on cycled copies of the operands where one
call's bytes exceed ``chip_smoke.BF16_COLD_BYTES`` (so that W is read
from device memory, as in a training step, not from the 50 MB L2).
``torch.addmm`` in bf16 is timed the same way, and each output is held
against the plain version.
With ``--parent DIR`` (a checkout whose ``veles_tpu_torch/csrc/gemm.cu``
holds the C entry without body, tile and split arguments) that version is
built and timed beside it, parent, change, change, parent.  ``--check``
first runs ``chip_smoke.py``'s bf16 cases (every layout pair, both
bodies, split above 1, unaligned views) and relaunches; ``--variants``
also times every tile and split of the body each shape takes, and
``--trace`` reads each call's kernels' own time from a profiler window
(the device time above also holds the gaps between launches);
``--experiments`` builds the copies of ``EXPERIMENTS`` (one edit each)
and times them at their products.  Prints
one JSON object a line and writes them all to ``--out``.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C entry before it took (body, tile, split)
PARENT_ARGTYPES = [_P] * 4 + [_I] * 3 + [_L] * 4 + [_I, _P]


def emit(rows, obj):
    rows.append(obj)
    print(json.dumps(obj), flush=True)


def build_parent(parent):
    from veles_tpu_torch.ops import build
    src = Path(parent) / "veles_tpu_torch" / "csrc" / "gemm.cu"
    out_dir = REPO / "build" / "bf16_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / "libgemm_parent.so"
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-o",
           str(target), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed on %s:\n%s%s" % (src, proc.stdout,
                                                         proc.stderr))
    fn = ctypes.CDLL(str(target)).veles_matmul_bf16
    fn.argtypes = PARENT_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def parent_call(fn, a, w, bias, act, out):
    from veles_tpu_torch.ops import gemm
    from veles_tpu_torch.ops.util import check_status, stream_handle
    m, k = a.shape
    n = w.shape[1]
    status = fn(a.data_ptr(), w.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                m, n, k, a.stride(0), a.stride(1), w.stride(0), w.stride(1),
                gemm.ACTIVATION_CODES[act], stream_handle(a.device))
    check_status("parent matmul_bf16", status)
    return out


def variants(a, w, bias, act, timed):
    """Device ms of the plan's body at each tile (body W: 128 and 256
    columns) and each split (1, 2, 4, 8) that leaves every rank a K
    tile."""
    from veles_tpu_torch.ops import gemm
    m, k = a.shape
    body, _tile, _split = gemm.plan_bf16(
        m, w.shape[1], k, (a.stride(0), a.stride(1), w.stride(0),
                           w.stride(1)), (a.data_ptr(), w.data_ptr()))
    tiles = (128, 256) if body == gemm.BF16_BODY_W else (64,)
    k_tiles = -(-k // gemm.BF16_BLOCK_K)
    out = {}
    for tile in tiles:
        for split in (1, 2, 4, 8):
            if split > k_tiles:
                continue
            plan = (body, tile, split)
            out["%d/%d" % (tile, split)] = timed(
                lambda a, w, b, _out, plan=plan: gemm._matmul_cuda(
                    a, w, b, act, tile_split=plan))
    return out


#: copies of csrc/gemm_bf16.cu with one edit each (the text replaced, its
#: replacement) and the GEMM_BF16_TIMED products each is timed at: body
#: W's epilogue without its TMA stores (what the weight gradients' stores
#: cost), and body S at two ring stages instead of three
EXPERIMENTS = {
    "w_no_store": (("        tma_store(map_out, stage + b * 64 * 128, "
                    "n0 + 64 * b, row0);\n", "        (void)b;\n"),
                   ("fc6_dw", "fc7_dw", "big")),
    "s_two_stages": (("constexpr int BM = 64, BN = 64, THREADS = 128, "
                      "STAGES = 3;",
                      "constexpr int BM = 64, BN = 64, THREADS = 128, "
                      "STAGES = 2;"),
                     ("mnist_fwd", "mnist_dw", "mnist_layer2")),
}


def build_experiments():
    """``{name: the C entry of its copy}``, the copies built in
    parallel."""
    from veles_tpu_torch.ops import build, gemm
    src = build.CSRC_DIR / "gemm_bf16.cu"
    out_dir = REPO / "build" / "bf16_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    procs = {}
    for name, ((old, new), _names) in EXPERIMENTS.items():
        if old not in text:
            raise RuntimeError("experiment %s: its text is not in %s"
                               % (name, src))
        copy = out_dir / ("gemm_bf16_%s.cu" % name)
        copy.write_text(text.replace(old, new))
        target = out_dir / ("libgemm_bf16_%s.so" % name)
        procs[name] = (target, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
             "-o", str(target), str(copy)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (target, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed on %s:\n%s" % (name, out))
        fn = ctypes.CDLL(str(target)).veles_matmul_bf16
        fn.argtypes = gemm._ARGTYPES["matmul_bf16"][1]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def experiment_call(fn, a, w, bias, act, out):
    """One launch of a copy's C entry on the plan's body, tile and
    split."""
    from veles_tpu_torch.ops import gemm
    from veles_tpu_torch.ops.util import check_status, stream_handle
    m, k = a.shape
    n = w.shape[1]
    strides = (a.stride(0), a.stride(1), w.stride(0), w.stride(1))
    plan = gemm.plan_bf16(m, n, k, strides, (a.data_ptr(), w.data_ptr()))
    check_status("experiment", fn(
        a.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, k, *strides, gemm.ACTIVATION_CODES[act],
        *plan, stream_handle(a.device)))
    return out


def kernel_us(fn, calls=20):
    """Mean device time of each kernel ``fn`` launches, in microseconds,
    from a ``torch.profiler`` window of ``calls`` calls: the kernels'
    own durations, without the gaps between launches that the event
    times hold."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name[:60]
            out[name] = out.get(name, 0.0) + ev.device_time_total / calls
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--variants", action="store_true",
                        help="also time every tile and split of the body "
                             "the plan picks")
    parser.add_argument("--experiments", action="store_true",
                        help="also time the copies of EXPERIMENTS")
    parser.add_argument("--trace", action="store_true",
                        help="also give each call's kernels' own device "
                             "time from a profiler window")
    parser.add_argument("--check", action="store_true",
                        help="first run chip_smoke.py's bf16 cases and "
                             "relaunches")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_bf16_probe: no CUDA card", file=sys.stderr)
        return 2
    from veles_tpu_torch.backends import bound_seconds, set_precision
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import build, gemm
    root.common.engine.precision_level = 2
    set_precision()
    device = torch.device("cuda", 0)
    rows = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    build.build_all(("gemm_bf16",))
    emit(rows, {"nvidia_smi": smi, "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "ptxas": [ln.strip() for ln in
                          build.build_log["gemm_bf16"]["ptxas"]
                          .splitlines()
                          if "registers" in ln or "spill" in ln
                          or "entry function" in ln]})
    if args.check:
        cases = cs._gemm_bf16_cases(device)
        bad = [c for c in cases if not c["ok"]]
        emit(rows, {"cases": len(cases), "bad": bad[:12],
                    "bodies": sorted({(c["body"], c["tile"], c["split"])
                                      for c in cases}),
                    "worst_err": max(c["max_abs_err"] for c in cases),
                    "relaunch": cs._gemm_bf16_repeatable(device)})
    parent = build_parent(args.parent) if args.parent else None
    experiments = build_experiments() if args.experiments else {}
    rng = numpy.random.default_rng(cs.SEED + 29)
    for (m, k, n), act, view, name in cs.GEMM_BF16_TIMED:
        nbytes = 2 * (m * k + k * n + n + m * n)
        copies = cs._bf16_copies(m, k, n)
        ops = [cs._bf16_operands(rng, device, m, k, n, view)
               for _ in range(copies)]
        outs = [torch.empty((m, n), dtype=torch.bfloat16, device=device)
                for _ in range(copies)]
        a, w, bias = ops[0]
        want = gemm._matmul_ref(a, w, bias, act)
        got = gemm.matmul(a, w, bias, act)
        err = cs._within(got, want, cs.BF16_GEMM_TOL)
        row = {"name": name, "shape": [m, k, n], "activation": act,
               "view": view, "strides": [list(a.stride()),
                                         list(w.stride())],
               "plan": list(cs._bf16_plan(a, w)), "copies": copies,
               "max_abs_err": err["max_abs_err"],
               "outside_tol": err["outside_tol"]}
        bound, by = bound_seconds(nbytes, 2 * m * n * k, "bfloat16")
        row.update(bound_ms=bound * 1e3, bound_by=by)
        reps = 5 if m * n * k >= 4096 ** 3 else args.reps
        reps = max(reps, copies)

        def timed(call):
            return cs.cold_device_ms(
                [lambda o=o, out=out: call(*o, out) for o, out in
                 zip(ops, outs)], reps) if copies > 1 else cs.device_ms(
                lambda: call(*ops[0], outs[0]), reps)

        def change(a, w, bias, out):
            return gemm._matmul_cuda(a, w, bias, act)

        def library(a, w, bias, out):
            return torch.addmm(bias, a, w)
        if parent is not None:
            err_p = cs._within(parent_call(parent, a, w, bias, act, outs[0]),
                               want, cs.BF16_GEMM_TOL)
            row["parent_max_abs_err"] = err_p["max_abs_err"]

            def par(a, w, bias, out):
                return parent_call(parent, a, w, bias, act, out)
            order = [("parent", par), ("change", change), ("change", change),
                     ("parent", par)]
        else:
            order = [("change", change), ("change", change)]
        for label, call in order:
            row.setdefault(label + "_ms", []).append(timed(call))
        row["library_ms"] = timed(library)
        if args.variants:
            row["variants"] = variants(a, w, bias, act, timed)
        for exp, (_edit, names) in EXPERIMENTS.items():
            if experiments and name in names:
                row.setdefault("experiments", {})[exp] = timed(
                    lambda a, w, b, out, fn=experiments[exp]:
                    experiment_call(fn, a, w, b, act, out))
        if args.trace:
            row["kernel_us"] = {
                "change": kernel_us(lambda: gemm._matmul_cuda(a, w, bias,
                                                              act)),
                "library": kernel_us(lambda: torch.addmm(bias, a, w))}
        row["wrapper_ms"] = cs.time_ms(lambda: gemm._matmul_cuda(
            a, w, bias, act))
        emit(rows, row)
        del ops, outs
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows)
                                  + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
