#!/usr/bin/env python3
"""Probe the decode step's two kernels on the card: decode attention
(``csrc/decode_attn.cu``, both entries) and qmatmul's decode body
(``csrc/qgemm.cu``, bf16 at M <= 16), beside another version of both.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/decode_probe.py [--parent DIR] [--out FILE]

It builds both sources as the package does, and copies of
``decode_attn.cu`` with other constants (``VARIANTS``: 64 KB or 48 KB of
rings a block, so four or three warps at D = 64 bf16, against the 32 KB
and two warps of the source), all compiled in parallel, and prints each build's ptxas report.  With ``--parent DIR``
(a directory holding another version's ``decode_attn.cu`` and
``qgemm.cu``, whose C entries take no split and no column tile) that
version is built too.  Every version runs through the package's own
wrappers (its C entries swapped in), so each gets the same operands.

Decode attention is held against its plain version (``_decode_ref``,
``_verify_ref``, ``_paged_decode_ref``) and timed at the serving shapes:
4 slots x 16 heads of 64, bf16, the contiguous (4, 2048, 16, 64) cache at
lengths [1, 17, 1000, 2048] (decode, and a 5-row verify), and the paged
``chip_smoke.PAGED_SHAPE`` pool at its lengths (decode and 5-row
verify), beside SDPA with a mask on the contiguous cache.  This build
runs each at every split (1, 2, 4, 8).  qmatmul is held against
``_qmatmul_ref`` and timed at CONFIG's four block products at M = 4 and
M = 16 (the decode step and the 16-row prefill bucket), this build at
every column tile and split, beside ``torch.mm`` / ``addmm`` on a
dequantized bf16 copy plus the epilogue.  Every time is device time per
call (20 calls queued behind a spinning kernel, one CUDA-event pair
around them, each call on the next of 12 copies of the cache or the
weights, so that none is served from L2: ``chip_smoke.cold_device_ms``);
the headline rows are timed parent, change, change, parent.  Prints one JSON object a line and
writes them all to ``--out``.
"""

import argparse
import contextlib
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
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SPLITS = (1, 2, 4, 8)
#: name -> csrc/decode_attn.cu's constants in that copy
VARIANTS = {"ring64k": {"RING_BUDGET": 65536}, "ring48k": {"RING_BUDGET": 49152}}
DECODE_LENGTHS = [1, 17, 1000, 2048]
QMM_MS = (4, 16)


def emit(rows, obj):
    rows.append(obj)
    print(json.dumps(obj), flush=True)


def ptxas_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def build_copies(copies):
    """``{label: (source, target .so)}``: one nvcc each, in parallel,
    headers from ``csrc/``; returns ``{label: ptxas lines}``."""
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


class Version(object):
    """One build's C entries, installed in the package's wrappers by
    :meth:`use`.  A parent's entries take no split (decode attention)
    and no column tile (qmatmul): they are dropped before the stream."""

    def __init__(self, decode_lib, qgemm_lib, parent=False):
        from veles_tpu_torch.ops import attention, qgemm
        self.entries = {}
        if decode_lib is not None:
            lib = ctypes.CDLL(str(decode_lib))
            for name in ("decode_attn", "paged_decode_attn"):
                _src, symbol, argtypes = attention._ARGTYPES[name]
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes[:-2] + argtypes[-1:] if parent \
                    else argtypes
                fn.restype = ctypes.c_int
                self.entries[name] = (lambda f: lambda *a: f(
                    *a[:-2], a[-1]))(fn) if parent else fn
        self.qmatmul = None
        if qgemm_lib is not None:
            fn = ctypes.CDLL(str(qgemm_lib)).veles_qmatmul
            fn.argtypes = qgemm._ARGTYPES[:-2] + qgemm._ARGTYPES[-1:] \
                if parent else qgemm._ARGTYPES
            fn.restype = ctypes.c_int
            self.qmatmul = (lambda f: lambda *a: f(*a[:-2], a[-1]))(fn) \
                if parent else fn

    @contextlib.contextmanager
    def use(self):
        from veles_tpu_torch.ops import attention, qgemm
        saved = dict(attention._entries), list(qgemm._entry_fn)
        attention._entries.update(self.entries)
        if self.qmatmul is not None:
            qgemm._entry_fn[:] = [self.qmatmul]
        try:
            yield
        finally:
            attention._entries.clear()
            attention._entries.update(saved[0])
            qgemm._entry_fn[:] = saved[1]


def decode_operands(rng, device):
    """The contiguous decode and verify cases and the paged ones:
    ``{label: (calls(split), plain(), bytes, sdpas or None, operands)}``,
    where ``calls(split)`` and ``sdpas`` are one closure a copy of the
    cache (``chip_smoke.COLD_COPIES`` copies, cycled by
    ``chip_smoke.cold_device_ms`` so that no call finds it in L2)."""
    import chip_smoke
    from veles_tpu_torch.ops import attention
    b, h, d, seq = 4, 16, 64, 2048
    cases = {}
    for nq, row_step in ((1, 0), (5, 1)):
        lengths = DECODE_LENGTHS if not row_step else [
            n - row_step * (nq - 1) if n == seq else n
            for n in DECODE_LENGTHS]
        q = chip_smoke._rand(rng, (b, nq, h, d), torch.bfloat16, device)
        k = chip_smoke._rand(rng, (b, seq, h, d), torch.bfloat16, device)
        v = chip_smoke._rand(rng, (b, seq, h, d), torch.bfloat16, device,
                             uniform=True)
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        keys = sum(n + row_step * (nq - 1) for n in lengths)
        nbytes = 2 * keys * h * d * 2 + 2 * b * nq * h * d * 2 + b * 4
        plain = attention._verify_ref if row_step else attention._decode_ref
        copies = [(k, v)] + [(k.clone(), v.clone())
                             for _ in range(chip_smoke.COLD_COPIES - 1)]
        sdpas = None
        if not row_step:
            mask = (torch.arange(seq, device=device)[None, :]
                    < lens[:, None].long())[:, None, None, :]
            sdpas = [lambda k=k_, v=v_, mask=mask, q=q:
                     F.scaled_dot_product_attention(
                         q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), attn_mask=mask)
                     for k_, v_ in copies]
        cases["contiguous_nq%d" % nq] = (
            (lambda split, q=q, lens=lens, rs=row_step, copies=copies:
             [lambda k=k_, v=v_: attention._decode_cuda(q, k, v, lens, rs,
                                                        split)
              for k_, v_ in copies]),
            (lambda q=q, k=k, v=v, lens=lens, plain=plain:
             plain(q, k, v, lens)), nbytes, sdpas, copies)
    sh = chip_smoke.PAGED_SHAPE
    for nq, row_step in ((1, 0), (5, 1)):
        args = chip_smoke._paged_pool(
            rng, device, torch.bfloat16, chip_smoke.PAGED_TIMED_LENGTHS, nq,
            row_step, sh["b"], sh["h"], sh["d"], sh["bs"], sh["max_blocks"],
            sh["num_blocks"])
        keys = sum(n + row_step * (nq - 1)
                   for n in chip_smoke.PAGED_TIMED_LENGTHS)
        nbytes = (2 * keys * h * d * 2 + args[3].numel() * 4
                  + 2 * b * nq * h * d * 2 + b * 4)
        q, kp, vp, tables, lens = args
        copies = [(kp, vp)] + [(kp.clone(), vp.clone())
                               for _ in range(chip_smoke.COLD_COPIES - 1)]
        cases["paged_nq%d" % nq] = (
            (lambda split, q=q, tables=tables, lens=lens, rs=row_step,
             copies=copies:
             [lambda kp=kp_, vp=vp_: attention._paged_decode_cuda(
                 q, kp, vp, tables, lens, rs, split) for kp_, vp_ in copies]),
            (lambda args=args, rs=row_step:
             attention._paged_decode_ref(*args, rs)), nbytes, None,
            (args, copies))
    return cases


def probe_decode(rows, versions, order, device):
    import chip_smoke
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import attention
    rng = numpy.random.default_rng(0)
    cases = decode_operands(rng, device)
    for label, (calls, plain, nbytes, sdpas, _keep) in cases.items():
        want = plain()
        bound = bound_seconds(nbytes, 0, "bfloat16")[0] * 1e3
        default = attention.decode_split(4 * 16)
        for version in order:
            splits = SPLITS if version == "change" else (default,)
            for split in splits:
                with versions[version].use():
                    each = calls(split)
                    out = each[0]()
                    torch.cuda.synchronize()
                    err = float((out.float() - want.float()).abs().max())
                    again = torch.equal(out, each[0]())
                    dev = chip_smoke.cold_device_ms(each)
                emit(rows, {"probe": "decode_attn", "case": label,
                            "version": version, "split": split
                            if version != "parent" else None,
                            "max_abs_err": err, "bit_equal_relaunch": again,
                            "device_ms": dev, "bound_ms": bound,
                            "bound_share": bound / dev})
        if sdpas is not None:
            emit(rows, {"probe": "decode_attn", "case": label,
                        "version": "sdpa",
                        "device_ms": chip_smoke.cold_device_ms(sdpas),
                        "bound_ms": bound})


def parent_split(m, n, k):
    """The split the first FMA body took at M <= 16 (16 x 64 tiles, K
    steps of 64): doubled, up to 8, while its grid covered the SMs less
    than twice and every split kept a K step."""
    tiles, k_tiles, split = -(-n // 64) * -(-m // 16), -(-k // 64), 1
    while split < 8 and tiles * split < 2 * 132 and k_tiles >= 2 * split:
        split *= 2
    return split


def probe_qmatmul(rows, versions, order, device):
    import chip_smoke
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import qgemm
    rng = numpy.random.default_rng(1)
    for m in QMM_MS:
        layer = {}
        for label, k, n, has_bias, act in chip_smoke.QMM_LAYER:
            a, q, scale, bias = chip_smoke._qmm_operands(
                rng, device, m, k, n, torch.bfloat16, has_bias)
            want = qgemm._qmatmul_ref(a, q, scale, bias, act)
            wd = (q.float() * scale).to(torch.bfloat16)

            def library(a=a, wd=wd, bias=bias, act=act):
                out = torch.addmm(bias, a, wd) if bias is not None \
                    else torch.mm(a, wd)
                return F.gelu(out, approximate="tanh") \
                    if act == "gelu" else out

            def call(plan=None, q=q, a=a, scale=scale, bias=bias, act=act):
                return qgemm._qmatmul_cuda(a, q, scale, bias, act,
                                           torch.bfloat16, plan)
            copies = [(q, wd)] + [(q.clone(), wd.clone()) for _ in range(
                chip_smoke.COLD_COPIES - 1)]
            nbytes = chip_smoke._qmm_bytes(m, k, n, torch.bfloat16, has_bias)
            bound = bound_seconds(nbytes, 2 * m * k * n, "bfloat16")[0] * 1e3
            default = qgemm.decode_plan(n, k)
            for version in order:
                plans = ([(bn, s) for bn in qgemm.DECODE_BLOCK_N
                          for s in SPLITS] if version == "change"
                         else [(0, parent_split(m, n, k))])
                for plan in plans:
                    with versions[version].use():
                        out = call(plan)
                        torch.cuda.synchronize()
                        err = float((out.float() - want.float()).abs().max())
                        again = torch.equal(out, call(plan))
                        dev = chip_smoke.cold_device_ms([
                            lambda q=q_, plan=plan: call(plan, q)
                            for q_, _w in copies])
                    if plan == default or version == "parent":
                        layer.setdefault(version, []).append(dev)
                    emit(rows, {"probe": "qmatmul", "weight": label,
                                "shape": [m, k, n], "version": version,
                                "plan": list(plan) if version != "parent"
                                else None, "default_plan": list(default),
                                "max_abs_err": err,
                                "bit_equal_relaunch": again,
                                "device_ms": dev, "bound_ms": bound,
                                "bound_share": bound / dev})
            lib_ms = chip_smoke.cold_device_ms([
                lambda wd=w_: library(wd=wd) for _q, w_ in copies])
            del copies
            layer.setdefault("library", []).append(lib_ms)
            emit(rows, {"probe": "qmatmul", "weight": label,
                        "shape": [m, k, n], "version": "library",
                        "device_ms": lib_ms, "bound_ms": bound})
        # each version's layer at its default plan, in the order timed
        # (parent, change, change, parent: the two passes averaged)
        emit(rows, {"probe": "qmatmul_layer", "m": m, "device_ms": {
            version: sum(times) / (len(times) // 4)
            for version, times in layer.items()}})


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="a directory with another "
                        "version's decode_attn.cu and qgemm.cu")
    parser.add_argument("--out", default="build/decode_probe/probe.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
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
    build.build_all(("decode_attn", "qgemm"))
    work = build.BUILD_DIR.parent / "decode_probe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = (build.CSRC_DIR / "decode_attn.cu").read_text()
    copies = {}
    for label, edits in VARIANTS.items():
        text = base
        for name, value in edits.items():
            text, count = re.subn(r"constexpr int %s = \d+;" % name,
                                  "constexpr int %s = %d;" % (name, value),
                                  text)
            if count != 1:
                raise RuntimeError("no single constant %s to edit" % name)
        (work / ("decode_%s.cu" % label)).write_text(text)
        copies[label] = (work / ("decode_%s.cu" % label),
                         work / ("lib%s.so" % label))
    if args.parent:
        for name in ("decode_attn", "qgemm"):
            copies["parent_" + name] = (Path(args.parent) / (name + ".cu"),
                                        work / ("libparent_%s.so" % name))
    reports = build_copies(copies)
    emit(rows, {"probe": "build", "seconds": time.perf_counter() - tic,
                "ptxas": {name: ptxas_lines(build.build_log[name]["ptxas"])
                          for name in ("decode_attn", "qgemm")},
                "copies_ptxas": reports})

    versions = {"change": Version(build.library_path("decode_attn"),
                                  build.library_path("qgemm"))}
    for label in VARIANTS:
        versions[label] = Version(copies[label][1], None)
    order = ["change"]
    if args.parent:
        versions["parent"] = Version(copies["parent_decode_attn"][1],
                                     copies["parent_qgemm"][1], parent=True)
        order = ["parent", "change", "change", "parent"]
    probe_decode(rows, versions, order + list(VARIANTS), device)
    probe_qmatmul(rows, versions, order, device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
