#!/usr/bin/env python3
"""Probe the tensor-core flash forward and int8 qmatmul bodies on the card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/tc_probe.py [--parent DIR] [--out FILE]

It builds ``veles_tpu_torch/csrc`` as the package does, then copies of
``csrc/flash_fwd.cu`` with another shape of its tensor-core body (warps a
block, so rows a Q tile; stages of the K/V ring; the blocks an SM that
``__launch_bounds__`` asks for), all compiled in parallel, and prints
each copy's ptxas report.  Each variant is held against ``_mha_ref`` at
small shapes, then timed at (1, 2048, 16, 64) and (8, 2048, 16, 64) bf16
causal on strided views of one projection: 10 launches back to back
between one CUDA-event pair, median of 7, per launch.  SDPA is timed on
the same measure.  qmatmul's tensor-core body is timed at CONFIG's four
block shapes at M = 2048, 256 and 32 under every K split (the cluster
size the C entry takes), each split held against ``_qmatmul_ref``.
With ``--parent DIR`` (a directory holding another version's
``flash_fwd.cu`` and ``qgemm.cu``, whose qmatmul entry takes no column
tile, as before the decode body) that version is built and timed beside
it in the same run.  Prints one JSON object a line and writes them all
to ``--out``.
"""

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: name -> csrc/flash_fwd.cu's constants in that variant: warps a block
#: (16 query rows each), stages of the K/V ring, blocks an SM at D <= 64
FWD_VARIANTS = {
    "w4_s2_b4": {"TC_WARPS": 4, "STAGES": 2, "TC_MIN_BLOCKS_64": 4},
    "w4_s2_b3": {"TC_WARPS": 4, "STAGES": 2, "TC_MIN_BLOCKS_64": 3},
    "w8_s2_b2": {"TC_WARPS": 8, "STAGES": 2, "TC_MIN_BLOCKS_64": 2},
    "w8_s3_b2": {"TC_WARPS": 8, "STAGES": 3, "TC_MIN_BLOCKS_64": 2},
}
QMM_LAYER = (("wqkv", 1024, 3072, False, None),
             ("wo", 1024, 1024, False, None),
             ("w1", 1024, 4096, True, "gelu"),
             ("w2", 4096, 1024, True, None))


def emit(rows, obj):
    rows.append(obj)
    print(json.dumps(obj), flush=True)


def per_launch_ms(fn, n=10, reps=7):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def variant_source(text, edits):
    for name, value in edits.items():
        text, count = re.subn(r"constexpr int %s = \d+;" % name,
                              "constexpr int %s = %d;" % (name, value), text)
        if count != 1:
            raise RuntimeError("no single constant %s to edit" % name)
    return text


def build_copies(copies):
    """``{label: (source path, target .so)}``: one nvcc each, in
    parallel; returns ``{label: ptxas report}``."""
    from veles_tpu_torch.ops import build
    procs = {}
    for label, (src, target) in copies.items():
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(target), str(src)]
        procs[label] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    reports = {}
    for label, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed on %s:\n%s" % (label, out))
        reports[label] = [ln.strip() for ln in out.splitlines()
                          if "registers" in ln or "spill" in ln
                          or "entry function" in ln]
    return reports


def fwd_entry(path):
    from veles_tpu_torch.ops import attention
    fn = ctypes.CDLL(str(path)).veles_flash_fwd
    fn.argtypes = attention._ARGTYPES["flash_fwd"][2]
    fn.restype = ctypes.c_int
    return fn


def qmm_entry(path, parent=False):
    """``veles_qmatmul`` of a build, called with this version's arguments;
    a parent's entry, which takes no column tile (``block_n``, read by
    the decode body only), gets them without it."""
    from veles_tpu_torch.ops import qgemm
    fn = ctypes.CDLL(str(path)).veles_qmatmul
    fn.argtypes = (qgemm._ARGTYPES[:-2] + qgemm._ARGTYPES[-1:] if parent
                   else qgemm._ARGTYPES)
    fn.restype = ctypes.c_int
    return (lambda *args: fn(*args[:-2], args[-1])) if parent else fn


def run_fwd(entry, q, k, v, causal, q_off=0):
    from veles_tpu_torch.ops.util import check_status, stream_handle
    b, sq, h, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = [x for t in (q, k, v) for x in t.stride()[:3]]
    check_status("flash_fwd", entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), 1, b, h, sq, k.shape[1], d, *strides,
        int(causal), q_off, 0, 1.0 / d ** 0.5, stream_handle(q.device)))
    return o, lse


def qkv(rng, device, b, s, h, d):
    x = rng.standard_normal((b, s, 3, h, d)).astype(numpy.float32)
    x[:, :, 2] = rng.uniform(-1, 1, x[:, :, 2].shape)
    t = torch.from_numpy(x).to(device, torch.bfloat16)
    return t[:, :, 0], t[:, :, 1], t[:, :, 2]


def fwd_error(entry, rng, device, b, s, h, d, causal, q_off=0):
    from veles_tpu_torch.ops.attention import _mha_ref
    q, k, v = qkv(rng, device, b, s, h, d)
    o, lse = run_fwd(entry, q, k, v, causal, q_off)
    ro, rlse = _mha_ref(q, k, v, causal, q_off)
    torch.cuda.synchronize()
    return max(float((o.float() - ro.float()).abs().max()),
               float((lse - rlse).abs().max()))


def probe_fwd(rows, entries, device):
    rng = numpy.random.default_rng(0)
    shapes = [(1, 2048, 16, 64), (8, 2048, 16, 64)]
    operands = {shape: qkv(rng, device, *shape) for shape in shapes}
    for label, entry in entries.items():
        errors = {
            "(2,77,3,64) causal q_off 40": fwd_error(entry, rng, device, 2, 77,
                                                     3, 64, True, 40),
            "(1,300,16,64) full": fwd_error(entry, rng, device, 1, 300, 16,
                                            64, False),
            "(2,65,3,7) causal": fwd_error(entry, rng, device, 2, 65, 3, 7,
                                           True),
            "(1,2048,16,64) causal": fwd_error(entry, rng, device, 1, 2048,
                                               16, 64, True)}
        times = {}
        for shape, (q, k, v) in operands.items():
            times[str(list(shape))] = per_launch_ms(
                lambda: run_fwd(entry, q, k, v, True))
        emit(rows, {"probe": "flash_fwd", "variant": label,
                    "max_abs_err": errors, "ms_per_launch": times})
    times = {}
    for shape, (q, k, v) in operands.items():
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        times[str(list(shape))] = per_launch_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True))
    emit(rows, {"probe": "flash_fwd", "variant": "sdpa",
                "ms_per_launch": times})


def probe_qmm(rows, entries, device):
    from veles_tpu_torch.ops import qgemm
    from veles_tpu_torch.ops.util import check_status, stream_handle
    rng = numpy.random.default_rng(1)
    for m in (2048, 256, 32):
        for label, k, n, has_bias, act in QMM_LAYER:
            a = torch.from_numpy(rng.standard_normal((m, k)).astype(
                numpy.float32)).to(device, torch.bfloat16)
            q = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(
                numpy.int8)).to(device)
            scale = torch.from_numpy((rng.uniform(0.25, 0.75, n) / 127
                                      / numpy.sqrt(k)).astype(
                numpy.float32)).to(device)
            bias = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(
                numpy.float32)).to(device, torch.bfloat16) \
                if has_bias else None
            want = qgemm._qmatmul_ref(a, q, scale, bias, act)
            out = torch.empty((m, n), dtype=torch.bfloat16, device=device)
            for version, entry in entries.items():
                by_split = {}
                for split in (1, 2, 4, 8):

                    def call(entry=entry, split=split):
                        check_status("qmatmul", entry(
                            a.data_ptr(), q.data_ptr(), scale.data_ptr(),
                            None if bias is None else bias.data_ptr(),
                            out.data_ptr(), m, n, k, a.stride(0), 1,
                            int(bias is not None), 1,
                            qgemm.ACTIVATION_CODES[act], split, 0,
                            stream_handle(device)))
                    call()
                    torch.cuda.synchronize()
                    err = float((out.float() - want.float()).abs().max())
                    by_split[split] = {"ms": per_launch_ms(call),
                                       "max_abs_err": err}
                emit(rows, {"probe": "qmatmul", "version": version,
                            "weight": label, "shape": [m, k, n],
                            "split_k": qgemm.split_k(m, n, k,
                                                     torch.bfloat16),
                            "by_split": by_split})


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="a directory with another "
                        "version's flash_fwd.cu and qgemm.cu")
    parser.add_argument("--out", default="build/tc_probe/tc_probe.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tc_probe: no CUDA device", file=sys.stderr)
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
    build.build_all()
    work = build.BUILD_DIR.parent / "tc_probe"
    shutil.rmtree(work, ignore_errors=True)
    copies = {}
    base = (build.CSRC_DIR / "flash_fwd.cu").read_text()
    for label, edits in FWD_VARIANTS.items():
        folder = work / label
        folder.mkdir(parents=True)
        shutil.copy(build.CSRC_DIR / "mma.cuh", folder / "mma.cuh")
        (folder / "flash_fwd.cu").write_text(variant_source(base, edits))
        copies[label] = (folder / "flash_fwd.cu", folder / "libfwd.so")
    if args.parent:
        for name in ("flash_fwd", "qgemm"):
            copies["parent_" + name] = (Path(args.parent) / (name + ".cu"),
                                        work / ("libparent_%s.so" % name))
    reports = build_copies(copies)
    emit(rows, {"probe": "build", "seconds": time.perf_counter() - tic,
                "ptxas": {name: [ln.strip() for ln in log["ptxas"]
                                 .splitlines() if "_tc" in ln or "spill" in ln
                                 or "registers" in ln]
                          for name, log in build.build_log.items()
                          if name in ("flash_fwd", "qgemm", "flash_bwd")},
                "variants_ptxas": reports})

    entries = {label: fwd_entry(copies[label][1]) for label in FWD_VARIANTS}
    if args.parent:
        entries["parent"] = fwd_entry(copies["parent_flash_fwd"][1])
    probe_fwd(rows, entries, device)
    qmm = {"change": qmm_entry(build.library_path("qgemm"))}
    if args.parent:
        qmm["parent"] = qmm_entry(copies["parent_qgemm"][1], parent=True)
    probe_qmm(rows, qmm, device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
