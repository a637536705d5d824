#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port (``veles_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. ``device``  — the card's name and power limit (``nvidia-smi``).
2. ``build``   — compile every kernel of ``veles_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all at once) and load them.
3. ``kernels`` — hold each kernel against its plain PyTorch version on
   the same CUDA tensors: the flash-prefill kernel against ``_mha_ref``
   on strided q/k/v views of one projection, as prefill hands them over
   (float32 with TF32 off, max abs error <= 1e-4 on ``o`` and ``lse``;
   bfloat16, <= 2e-2) and the decode kernel against ``_decode_ref`` /
   ``_verify_ref`` (same tolerances).  V is drawn from U(-1, 1) so a
   bfloat16 output lies in [-1, 1], where one ulp is <= 2^-7.  The
   flash backward pair (dq; dk/dv) against ``_bwd_ref`` on strided
   views of one projection and the forward kernel's ``(o, lse)``: every
   element of dq, dk and dv within ``atol + rtol·|plain|`` (float32
   1e-4 + 1e-4; bfloat16 2e-3 + 2^-7, one ulp relative, since each side
   rounds a gradient once on output), with the median |plain| printed
   beside it.  At the timed shape three faults planted in the kernels'
   inputs (delta's sign flipped, the last K tile dropped from dq, the
   last Q tile dropped from dk/dv) must each be reported.  Each kernel
   is timed at its main path's shape (bfloat16, median of 20 CUDA-event
   timings).
4. ``serve``   — the main path at full width: ``GenerativeEngine`` over
   ``TransformerGenModel(CONFIG)`` in bfloat16 (4 slots, max_seq 2048)
   behind a ``GenerativeScheduler`` worker thread, 8 seeded requests of
   16..1500 prompt tokens and 64 new tokens each.  Every request must
   return exactly its budget, and both kernels' launch counts (set to 0
   just before the session, read just after) must show 12 launches per
   prefill and per decode step.  After the counted session, two
   windows under ``torch.profiler`` (filling the 4 slots with prefills,
   then 16 decode steps) give the device time by kernel group and the
   device's busy share of the wall time.
5. ``parity``  — CONFIG width cut to 2 layers, float32 with TF32 off:
   4 seeded requests x 16 tokens on the card (kernels) and on the CPU
   (plain versions) must give equal token streams, unless the CPU
   logits at the first diverging step had a top-2 gap below 1e-3; and
   ``calibration_logits`` of one 256-token prompt must agree within
   max abs 1e-3.
6. ``train``   — the training path at full width: ``build_train(CONFIG)``
   (bf16 compute, remat, ce_chunk 128, SGD with momentum) on
   ``synthetic_tokens(CONFIG, 8)``, one warm-up step and 5 timed ones.
   Every loss must be finite and every step must launch the forward
   kernel 24 times (forward and remat recompute) and each backward
   kernel 12 times (counts set to 0 just before the steps, read just
   after each).  Then one step under ``torch.profiler`` gives the
   device time by kernel group and the busy share.
7. ``train_parity`` — CONFIG width cut to 2 layers and seq_len 256,
   batch 2, float32 with TF32 off: 2 steps from the same numpy params
   on the card (kernels) and on the CPU (plain versions); the losses
   must agree within relative 1e-6, the params after 2 steps within
   max abs 1e-5, and the velocity (``-lr`` times a running gradient
   sum) leaf by leaf within max |card - cpu| <= 1e-4 · max |cpu|.  A
   third run on the card with its dq zeroed must fail that velocity
   check.

Then it prints the per-kernel JSON line (launches on the main paths,
serve and train, max abs error, kernel / plain / library times,
roofline bound), the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, it exits non-zero and prints no
result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy
import torch
import torch.nn.functional as F

SEED = 0
F32_TOL = 1e-4
BF16_TOL = 2e-2
# backward gradients, element by element within atol + rtol·|plain|:
# bfloat16 one ulp relative (each side rounds once on output) plus 2e-3
# for the small values, about a sixth of a typical |dq| at s = 2048
BWD_F32_TOL = (1e-4, 1e-4)
BWD_BF16_TOL = (2e-3, 2 ** -7)
BWD_TILE = 64                     # BLOCK_Q = BLOCK_K of csrc/flash_bwd.cu
SERVE_REQUESTS = 8
SERVE_NEW_TOKENS = 64
PARITY_REQUESTS = 4
PARITY_NEW_TOKENS = 16
PARITY_LOGIT_TOL = 1e-3
TIE_GAP = 1e-3
TRAIN_BATCH = 8
TRAIN_STEPS = 5
TRAIN_PARITY_STEPS = 2
TRAIN_LOSS_RTOL = 1e-6
TRAIN_PARAM_TOL = 1e-5
TRAIN_VELOCITY_RTOL = 1e-4
H100_BF16_FLOPS = 989e12


class PhaseFailed(Exception):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, phase, msg):
    if not cond:
        raise PhaseFailed("%s: %s" % (phase, msg))


def gpu_sync():
    torch.cuda.synchronize()


def time_ms(fn, reps=20, warm=3, flush=None):
    """Median device time of ``fn`` in ms (CUDA events around each call;
    ``flush`` runs before each timed call, outside the events)."""
    for _ in range(warm):
        fn()
    gpu_sync()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernel_group(name):
    for group in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if group + "_kernel" in name:
            return group
    if "decode_kernel" in name:
        return "decode_attn"
    if any(tag in name.lower() for tag in ("gemm", "xmma", "cutlass",
                                           "nvjet")):
        return "matmul"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copy"
    return "other"


def profile_window(fn):
    """Run ``fn`` once under ``torch.profiler`` and return its host wall
    time, the device time of every kernel summed by group (flash_fwd,
    flash_bwd_dq, flash_bwd_dkv, decode_attn, matmul, copy, other), the
    12 kernels that took most of it, and the device's busy share of the
    wall time.  Kernels run on one stream, so their times add."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gpu_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        gpu_sync()
        wall_us = (time.perf_counter() - tic) * 1e6
    groups, names = {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.device_time_total
        group = _kernel_group(ev.name)
        groups[group] = groups.get(group, 0.0) + us
        names[ev.name] = names.get(ev.name, 0.0) + us
    busy = sum(groups.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / wall_us if busy else None,
            "device_ms_by_group": {g: t / 1e3 for g, t in groups.items()},
            "top_kernels_ms": [[n[:200], t / 1e3] for n, t in top]}


def make_l2_flush(device):
    buf = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=device)

    def flush():
        buf.zero_()
    return flush


# -- phases ----------------------------------------------------------------

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, "device", "nvidia-smi failed: %s"
          % smi.stderr.strip())
    line = smi.stdout.strip().splitlines()[0]
    info = {"phase": "device", "nvidia_smi": line,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build():
    from veles_tpu_torch.ops import build
    tic = time.perf_counter()
    seconds = build.build_all()
    wall = time.perf_counter() - tic
    ptxas = {name: [ln.strip() for ln in log["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name, log in build.build_log.items()}
    emit({"phase": "build", "ok": True, "wall_s": wall,
          "nvcc_s": seconds, "ptxas": ptxas})


def _rand(rng, shape, dtype, device, uniform=False):
    x = (rng.uniform(-1.0, 1.0, shape) if uniform
         else rng.standard_normal(shape))
    return torch.from_numpy(x.astype(numpy.float32)).to(device=device,
                                                        dtype=dtype)


def _flash_case(rng, device, dtype, b, s, h, d, causal, q_off=0, k_off=0):
    from veles_tpu_torch.ops.attention import _flash_fwd_cuda, _mha_ref
    # strided views of one (b, s, 3, h, d) projection, as prefill makes
    qkv = torch.cat([_rand(rng, (b, s, 2, h, d), dtype, device),
                     _rand(rng, (b, s, 1, h, d), dtype, device,
                           uniform=True)], dim=2)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, lse = _flash_fwd_cuda(q, k, v, causal, q_off, k_off)
    ro, rlse = _mha_ref(q, k, v, causal, q_off, k_off)
    gpu_sync()
    err = max(float((o.float() - ro.float()).abs().max()),
              float((lse - rlse).abs().max()))
    return (q, k, v), err


def _decode_case(rng, device, dtype, lengths, nq, row_step, slots=4,
                 seq=2048, h=16, d=64):
    from veles_tpu_torch.ops.attention import (_decode_cuda, _decode_ref,
                                               _verify_ref)
    q = _rand(rng, (slots, nq, h, d), dtype, device)
    k = _rand(rng, (slots, seq, h, d), dtype, device)
    v = _rand(rng, (slots, seq, h, d), dtype, device, uniform=True)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    out = _decode_cuda(q, k, v, lens, row_step)
    ref = (_verify_ref if row_step else _decode_ref)(q, k, v, lens)
    gpu_sync()
    return (q, k, v, lens), float((out.float() - ref.float()).abs().max())


def _bwd_limits(dtype):
    return BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL


def _bwd_agree(names, got, want, dtype):
    """Each gradient against its plain version: the max abs error, the
    max and median abs plain value, the count of elements outside
    ``atol + rtol·|plain|``, and whether there are none."""
    atol, rtol = _bwd_limits(dtype)
    report, ok = {}, True
    for name, g, w in zip(names, got, want):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        outside = int((diff > atol + rtol * w.abs()).sum())
        ok = ok and outside == 0
        report[name] = {"max_abs_err": float(diff.max()),
                        "max_abs_plain": float(w.abs().max()),
                        "median_abs_plain": float(w.abs().median()),
                        "outside_tol": outside}
    return report, ok


def _bwd_case(rng, device, dtype, b, s, h, d, causal, q_off=0):
    """Both backward kernels against ``_bwd_ref`` on strided q/k/v views
    of one projection, from the forward kernel's ``(o, lse)``.  Returns
    the operands, the report of :func:`_bwd_agree` and its verdict."""
    from veles_tpu_torch.ops.attention import (_bwd_ref, _flash_bwd,
                                               _flash_fwd_cuda)
    qkv = torch.cat([_rand(rng, (b, s, 2, h, d), dtype, device),
                     _rand(rng, (b, s, 1, h, d), dtype, device,
                           uniform=True)], dim=2)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = _rand(rng, (b, s, h, d), dtype, device, uniform=True)
    o, lse = _flash_fwd_cuda(q, k, v, causal, q_off, 0)
    got = _flash_bwd(q, k, v, o, lse, do, causal, q_off, 0)
    want = _bwd_ref(q, k, v, o, lse, do, causal, q_off, 0)
    gpu_sync()
    report, ok = _bwd_agree(("dq", "dk", "dv"), got, want, dtype)
    return (q, k, v, o, lse, do), report, ok


def _bwd_planted_faults(q, k, v, o, lse, do, delta):
    """Three faults planted in the kernels' inputs at the timed shape,
    each of which the agreement check must report: the sign of delta
    flipped (dq and dk), the last K tile dropped from dq's keys (what an
    off-by-one in the causal skip would do to the last query rows) and
    the last Q tile dropped from dk/dv's queries."""
    from veles_tpu_torch.ops.attention import (_bwd_dkv_cuda, _bwd_dq_cuda,
                                               _bwd_ref)
    want = _bwd_ref(q, k, v, o, lse, do, True, delta=delta)
    cut = q.shape[1] - BWD_TILE
    faults = {}
    args = (q, k, v, do, lse, -delta, True, 0, 0)
    faults["delta_sign_flipped"] = _bwd_agree(
        ("dq", "dk"), [_bwd_dq_cuda(*args), _bwd_dkv_cuda(*args)[0]],
        want[:2], q.dtype)
    faults["last_k_tile_dropped_from_dq"] = _bwd_agree(
        ("dq",), [_bwd_dq_cuda(q, k[:, :cut], v[:, :cut], do, lse, delta,
                               True, 0, 0)], want[:1], q.dtype)
    faults["last_q_tile_dropped_from_dkv"] = _bwd_agree(
        ("dk", "dv"), _bwd_dkv_cuda(q[:, :cut], k, v, do[:, :cut],
                                    lse[..., :cut].contiguous(),
                                    delta[..., :cut].contiguous(), True, 0,
                                    0), want[1:], q.dtype)
    gpu_sync()
    return {name: {"report": report, "caught": not ok}
            for name, (report, ok) in faults.items()}


def _bwd_timed(rng, device):
    """The backward pair at the training shape (the ``train`` phase's
    batch at CONFIG width): each kernel's time and bound, the plain
    version's time, and SDPA's backward as the library time of the pair
    (its forward + backward less its forward)."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops.attention import (_bwd_dkv_cuda, _bwd_dq_cuda,
                                               _bwd_ref, _delta)
    from veles_tpu_torch.samples.transformer import CONFIG
    b, s, h = TRAIN_BATCH, CONFIG["seq_len"], CONFIG["heads"]
    d = CONFIG["dim"] // h
    (q, k, v, o, lse, do), report, ok = _bwd_case(
        rng, device, torch.bfloat16, b, s, h, d, True)
    delta = _delta(o, do).contiguous()
    planted = _bwd_planted_faults(q, k, v, o, lse, do, delta)
    ok = ok and all(f["caught"] for f in planted.values())
    report = dict(report, planted_faults=planted)
    args = (q, k, v, do, lse, delta, True, 0, 0)
    plain_ms = time_ms(lambda: _bwd_ref(q, k, v, o, lse, do, True), reps=5)

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    library_ms = (time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                      dot))
                  - time_ms(sdpa))

    elem, pairs = 2, b * h * s * (s + 1) // 2      # unmasked (q, k) pairs
    product = 2 * d * pairs                        # one s×s×d product
    operand = b * s * h * d * elem
    read = 4 * operand + 2 * b * h * s * 4         # q k v do, lse delta
    rows = []
    for name, fn, out_bytes, products in (
            ("flash_bwd_dq", lambda: _bwd_dq_cuda(*args), operand, 3),
            ("flash_bwd_dkv", lambda: _bwd_dkv_cuda(*args), 2 * operand,
             4)):
        bound, by = bound_seconds(read + out_bytes, products * product,
                                  "bfloat16")
        outputs = ("dq",) if name == "flash_bwd_dq" else ("dk", "dv")
        rows.append({
            "name": name, "route": "cuda",
            "source": "veles_tpu_torch/csrc/flash_bwd.cu",
            "replaces": ("veles_tpu/ops/attention.py:202"
                         if name == "flash_bwd_dq"
                         else "veles_tpu/ops/attention.py:248"),
            "shape": [b, s, h, d], "dtype": "bfloat16", "causal": True,
            "max_abs_err": max(report[o_]["max_abs_err"] for o_ in outputs),
            "ms": time_ms(fn), "plain_ms": plain_ms,
            "plain_of": "_bwd_ref, the pair (dq, dk, dv)",
            "library_ms": library_ms,
            "library_of": "SDPA backward, the pair (fwd+bwd less fwd)",
            "bound_ms": bound * 1e3, "bound_by": by, "products": products,
        })
    return rows, report, ok


def phase_kernels(device):
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops.attention import (_decode_cuda, _decode_ref,
                                               _flash_fwd_cuda, _mha_ref)
    rng = numpy.random.default_rng(SEED)
    cases = []
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).replace("torch.", "")
        for s, causal, q_off in ((7, True, 0), (300, True, 0),
                                 (300, False, 0), (1024, True, 512)):
            _, report, ok = _bwd_case(rng, device, dtype, 1, s, 16, 64,
                                      causal, q_off)
            atol, rtol = _bwd_limits(dtype)
            cases.append({"kernel": "flash_bwd_dq+flash_bwd_dkv",
                          "dtype": name, "shape": [1, s, 16, 64],
                          "causal": causal, "q_offset": q_off,
                          "strided_views": True, "errors": report,
                          "max_abs_err": max(r["max_abs_err"]
                                             for r in report.values()),
                          "tol": atol, "tol_rel": rtol, "ok": ok})
        for s in (7, 300, 2048):
            _, err = _flash_case(rng, device, dtype, 1, s, 16, 64, True)
            cases.append({"kernel": "flash_fwd", "dtype": name,
                          "shape": [1, s, 16, 64], "causal": True,
                          "max_abs_err": err, "tol": tol})
        _, err = _flash_case(rng, device, dtype, 1, 300, 16, 64, False)
        cases.append({"kernel": "flash_fwd", "dtype": name,
                      "shape": [1, 300, 16, 64], "causal": False,
                      "max_abs_err": err, "tol": tol})
        _, err = _flash_case(rng, device, dtype, 1, 1024, 16, 64, True,
                             q_off=512, k_off=0)
        cases.append({"kernel": "flash_fwd", "dtype": name,
                      "shape": [1, 1024, 16, 64], "causal": True,
                      "q_offset": 512, "max_abs_err": err, "tol": tol})
        _, err = _decode_case(rng, device, dtype, [1, 17, 1000, 2048], 1, 0)
        cases.append({"kernel": "decode_attn", "dtype": name,
                      "q": [4, 1, 16, 64], "cache": [4, 2048, 16, 64],
                      "lengths": [1, 17, 1000, 2048],
                      "max_abs_err": err, "tol": tol})
        _, err = _decode_case(rng, device, dtype, [1, 17, 1000, 2044], 5, 1)
        cases.append({"kernel": "decode_attn", "dtype": name,
                      "q": [4, 5, 16, 64], "cache": [4, 2048, 16, 64],
                      "lengths": [1, 17, 1000, 2044], "row_step": 1,
                      "max_abs_err": err, "tol": tol})
    bad = [c for c in cases
           if not c.get("ok", c["max_abs_err"] <= c["tol"])]

    # times at the main path's shapes: the largest prefill bucket, and a
    # decode step of 4 slots against the 2048-row cache, both bfloat16
    flush = make_l2_flush(device)
    (q, k, v), ferr = _flash_case(rng, device, torch.bfloat16,
                                  1, 2048, 16, 64, True)
    s, h, d = 2048, 16, 64
    elem = 2
    f_bytes = 4 * s * h * d * elem + h * s * 4     # q k v o, lse
    f_ops = 4 * d * h * s * (s + 1) // 2           # unmasked pairs only
    f_bound, f_by = bound_seconds(f_bytes, f_ops, "bfloat16")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    flash = {
        "name": "flash_fwd", "route": "cuda",
        "source": "veles_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "veles_tpu/ops/attention.py:58",
        "shape": [1, s, h, d], "dtype": "bfloat16", "causal": True,
        "max_abs_err": ferr,
        "ms": time_ms(lambda: _flash_fwd_cuda(q, k, v, True, 0, 0)),
        "plain_ms": time_ms(lambda: _mha_ref(q, k, v, True)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "bound_ms": f_bound * 1e3, "bound_by": f_by,
    }
    lengths = [1, 17, 1000, 2048]
    (q, k, v, lens), derr = _decode_case(rng, device, torch.bfloat16,
                                         lengths, 1, 0)
    slots, seq = 4, 2048
    d_bytes = (2 * sum(lengths) * h * d * elem      # valid K and V rows
               + 2 * slots * h * d * elem + slots * 4)
    d_ops = 4 * d * h * sum(lengths)
    d_bound, d_by = bound_seconds(d_bytes, d_ops, "bfloat16")
    mask = (torch.arange(seq, device=device)[None, :]
            < lens[:, None].long())[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    decode = {
        "name": "decode_attn", "route": "cuda",
        "source": "veles_tpu_torch/csrc/decode_attn.cu",
        "replaces": "veles_tpu/ops/attention.py:423",
        "q": [slots, 1, h, d], "cache": [slots, seq, h, d],
        "lengths": lengths, "dtype": "bfloat16", "max_abs_err": derr,
        "ms": time_ms(lambda: _decode_cuda(q, k, v, lens, 0), flush=flush),
        "plain_ms": time_ms(lambda: _decode_ref(q, k, v, lens),
                            flush=flush),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), flush=flush),
        "bound_ms": d_bound * 1e3, "bound_by": d_by,
    }
    bwd_rows, bwd_report, bwd_ok = _bwd_timed(rng, device)
    timed = [flash] + bwd_rows + [decode]
    ok = not bad and ferr <= BF16_TOL and derr <= BF16_TOL and bwd_ok
    emit({"phase": "kernels", "ok": ok, "cases": cases,
          "timed_backward_errors": bwd_report, "timed": timed})
    check(ok, "kernels", "kernel disagrees with its plain version: %s"
          % (bad or timed))
    return timed


def phase_serve(device, smi):
    from veles_tpu_torch import trace
    from veles_tpu_torch.config import root
    from veles_tpu_torch.gen import (GenerativeEngine, GenerativeScheduler,
                                     TransformerGenModel)
    from veles_tpu_torch.ops import attention
    from veles_tpu_torch.samples.transformer import CONFIG

    tic = time.perf_counter()
    model = TransformerGenModel(CONFIG, compute_dtype=torch.bfloat16,
                                device=device)
    engine = GenerativeEngine(model, max_slots=4, max_seq=2048,
                              seed=SEED, device=device)
    setup_s = time.perf_counter() - tic
    tic = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - tic

    rng = numpy.random.default_rng(SEED)
    lengths = numpy.linspace(16, 1500, SERVE_REQUESTS).astype(int)
    rng.shuffle(lengths)
    workload = [rng.integers(0, CONFIG["vocab"], int(n)).tolist()
                for n in lengths]

    root.common.engine.trace = "on"
    trace.configure()
    trace.recorder.clear()
    torch.cuda.reset_peak_memory_stats(device)
    attention.reset_launches()
    prefill0, decode0 = engine.prefill_calls, engine.decode_calls
    scheduler = GenerativeScheduler(engine, name="chip-smoke").start()
    try:
        tic = time.perf_counter()
        futures = [scheduler.submit(toks, SERVE_NEW_TOKENS)
                   for toks in workload]
        results = [f.result(timeout=600) for f in futures]
        elapsed = time.perf_counter() - tic
    finally:
        scheduler.stop()
    launches = dict(attention.launches)
    prefills = engine.prefill_calls - prefill0
    steps = engine.decode_calls - decode0
    events = trace.recorder.events()
    root.common.engine.trace = "off"
    trace.configure()

    decode_ms = [ev[4] / 1e6 for ev in events
                 if ev[0] == "X" and ev[2] == "decode"]
    per_bucket = {}
    for ev in events:
        if ev[0] == "X" and ev[2] == "prefill":
            per_bucket.setdefault(ev[6]["bucket"], []).append(ev[4] / 1e6)
    tokens = sum(len(r) for r in results)
    layers = CONFIG["layers"]
    info = {
        "phase": "serve", "nvidia_smi": smi,
        "config": dict(CONFIG), "compute_dtype": "bfloat16",
        "requests": len(workload), "prompt_lengths": lengths.tolist(),
        "new_tokens": SERVE_NEW_TOKENS, "tokens": tokens,
        "elapsed_s": elapsed, "tokens_per_s": tokens / elapsed,
        "ttft_mean_ms": scheduler.ttft.mean * 1e3,
        "decode_steps": steps, "prefills": prefills,
        "decode_step_median_ms": statistics.median(decode_ms),
        "prefill_ms_by_bucket": {str(b): statistics.median(t)
                                 for b, t in sorted(per_bucket.items())},
        "batch_fill": scheduler.batch_fill(),
        "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device),
        "params_bytes": engine.params_nbytes,
        "kv_cache_bytes": engine.kv_cache_bytes,
        "setup_s": setup_s, "warmup_s": warmup_s,
    }
    budgets_ok = all(len(r) == SERVE_NEW_TOKENS for r in results)
    in_vocab = all(0 <= t < CONFIG["vocab"] for r in results for t in r)
    counted = (launches["flash_fwd"] >= layers * prefills > 0
               and launches["decode_attn"] >= layers * steps > 0)
    info["ok"] = budgets_ok and in_vocab and counted
    info["breakdown"] = profile_breakdown(engine, workload)
    emit(info)
    engine.close()
    check(budgets_ok, "serve", "a request did not get exactly %d tokens"
          % SERVE_NEW_TOKENS)
    check(in_vocab, "serve", "a token lies outside the vocabulary")
    check(counted, "serve", "the kernels were not on the main path: "
          "launches %s for %d prefills and %d decode steps"
          % (launches, prefills, steps))
    return launches


def profile_breakdown(engine, workload, decode_steps=16):
    """Where a serving step's time goes, after the counted session: one
    profiled window that fills every slot (one prefill each, through
    the engine's own entry point) and one of ``decode_steps`` decode
    steps over the full batch."""
    prompts = workload[:engine.max_slots]
    slots = []
    prefill = profile_window(
        lambda: slots.extend(engine.prefill(p)[0] for p in prompts))
    prefill["buckets"] = [engine.bucket_for(len(p)) for p in prompts]
    decode = profile_window(
        lambda: [engine.decode_step() for _ in range(decode_steps)])
    decode["steps"] = decode_steps
    for slot in slots:
        engine.release_slot(slot)
    return {"prefill_window": prefill, "decode_window": decode}


def phase_parity(device):
    from veles_tpu_torch.gen import (GenerativeEngine, GenerativeScheduler,
                                     TransformerGenModel, params_from_numpy)
    from veles_tpu_torch.samples.transformer import CONFIG

    cfg = dict(CONFIG, layers=2)
    rng = numpy.random.default_rng(SEED + 1)
    workload = [rng.integers(0, cfg["vocab"], int(n)).tolist()
                for n in rng.integers(8, 200, PARITY_REQUESTS)]
    calibration_prompt = rng.integers(0, cfg["vocab"], 256).tolist()
    host_params = TransformerGenModel(cfg, device="cpu").init_params(SEED)

    def session(dev):
        model = TransformerGenModel(cfg, device=dev)
        engine = GenerativeEngine(
            model, params_from_numpy(host_params, dev), max_slots=4,
            max_seq=512, device=dev)
        scheduler = GenerativeScheduler(engine)
        futures = [scheduler.submit(t, PARITY_NEW_TOKENS) for t in workload]
        scheduler.run_until_idle()
        streams = [f.result(0) for f in futures]
        with torch.inference_mode():
            logits = model.calibration_logits(engine._params,
                                              calibration_prompt)
        return model, engine, streams, logits.float().cpu()

    _gm, gengine, gpu_streams, gpu_logits = session(device)
    gengine.close()
    cmodel, cengine, cpu_streams, cpu_logits = session(torch.device("cpu"))
    logit_err = float((gpu_logits - cpu_logits).abs().max())

    diverged, ties = 0, 0
    for prompt, got, want in zip(workload, gpu_streams, cpu_streams):
        if got == want:
            continue
        diverged += 1
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        with torch.inference_mode():
            top2 = torch.topk(cmodel.calibration_logits(
                cengine._params, list(prompt) + want[:j]), 2).values
        if float(top2[0] - top2[1]) < TIE_GAP:
            ties += 1
    cengine.close()
    ok = (logit_err <= PARITY_LOGIT_TOL and diverged == ties
          and all(len(s) == PARITY_NEW_TOKENS for s in gpu_streams))
    emit({"phase": "parity", "ok": ok, "config": cfg,
          "dtype": "float32", "tf32": False,
          "requests": PARITY_REQUESTS, "new_tokens": PARITY_NEW_TOKENS,
          "streams_equal": PARITY_REQUESTS - diverged,
          "diverged": diverged, "diverged_at_near_tie": ties,
          "calibration_logits_max_abs_err": logit_err,
          "tol": PARITY_LOGIT_TOL})
    check(ok, "parity", "card and CPU disagree (logit err %.3g, %d streams "
          "diverged, %d at a near-tie)" % (logit_err, diverged, ties))


def phase_train(device, smi):
    from veles_tpu_torch.ops import attention
    from veles_tpu_torch.samples import transformer as T

    cfg, batch = T.CONFIG, TRAIN_BATCH
    tic = time.perf_counter()
    params, velocity, step = T.build_train(cfg, seed=SEED, device=device)
    tokens = T._as_tokens(T.synthetic_tokens(cfg, batch, seed=SEED), device)
    gpu_sync()
    setup_s = time.perf_counter() - tic
    want = {"flash_fwd": 2 * cfg["layers"], "flash_bwd_dq": cfg["layers"],
            "flash_bwd_dkv": cfg["layers"], "decode_attn": 0}

    torch.cuda.reset_peak_memory_stats(device)
    attention.reset_launches()
    losses, step_ms, per_step = [], [], []
    for _ in range(1 + TRAIN_STEPS):          # one warm-up, then timed
        before = dict(attention.launches)
        gpu_sync()
        tic = time.perf_counter()
        params, velocity, metrics = step(params, velocity, tokens)
        losses.append(float(metrics["loss"]))
        gpu_sync()
        step_ms.append((time.perf_counter() - tic) * 1e3)
        per_step.append({name: attention.launches[name] - before[name]
                         for name in before})
    launches = dict(attention.launches)
    peak = torch.cuda.max_memory_allocated(device)

    median_ms = statistics.median(step_ms[1:])
    flops = T.train_step_flops(cfg, batch)
    finite = all(numpy.isfinite(x) for x in losses)
    counted = all(counts == want for counts in per_step)
    info = {
        "phase": "train", "nvidia_smi": smi, "config": dict(cfg),
        "batch": batch, "compute_dtype": "bfloat16", "remat": True,
        "ce_chunk": 128, "lr": 3e-4, "seed": SEED,
        "losses": losses, "step_ms": step_ms,
        "step_median_ms": median_ms,
        "tokens_per_s": batch * cfg["seq_len"] / (median_ms / 1e3),
        "train_step_flops": flops,
        "flops_share_of_989T": flops / (median_ms / 1e3) / H100_BF16_FLOPS,
        "max_memory_allocated": peak, "setup_s": setup_s,
        "launches": launches, "launches_per_step": per_step,
        "launches_per_step_expected": want,
        "ok": finite and counted,
    }
    info["breakdown"] = profile_window(
        lambda: step(params, velocity, tokens))
    emit(info)
    check(finite, "train", "a loss is not finite: %s" % losses)
    check(counted, "train", "the kernels were not on the main path as "
          "expected: %s per step, want %s" % (per_step, want))
    return launches


def phase_train_parity(device):
    from veles_tpu_torch.gen.model import params_from_numpy, params_to_numpy
    from veles_tpu_torch.ops import attention
    from veles_tpu_torch.samples import transformer as T

    cfg, batch = dict(T.CONFIG, layers=2, seq_len=256), 2
    host = T.init_params(cfg, seed=SEED)
    zeros = T._build_params(host, numpy.zeros_like)
    tokens = T.synthetic_tokens(cfg, batch, seed=SEED + 2)

    def run(dev):
        step = T.make_train_step(cfg, compute_dtype=torch.float32)
        params = params_from_numpy(host, dev)
        velocity = params_from_numpy(zeros, dev)
        losses = [float(step(params, velocity, tokens)[2]["loss"])
                  for _ in range(TRAIN_PARITY_STEPS)]
        return losses, params_to_numpy(params), params_to_numpy(velocity)

    def velocity_errors(got):
        # the velocity is -lr times a running gradient sum: leaf by leaf,
        # max |card - cpu| over max |cpu|, so it reads the gradients
        return {name: float(numpy.abs(a - b).max()
                            / max(float(numpy.abs(b).max()), 1e-30))
                for (name, a), b in zip(_named_leaves(got),
                                        T._leaves(cpu_velocity))}

    attention.reset_launches()
    gpu_losses, gpu_params, gpu_velocity = run(device)
    launches = dict(attention.launches)
    cpu_losses, cpu_params, cpu_velocity = run(torch.device("cpu"))

    # a planted fault the check must report: the card's dq zeroed
    flash_bwd = attention._flash_bwd

    def zero_dq(*args, **kwargs):
        dq, dk, dv = flash_bwd(*args, **kwargs)
        return torch.zeros_like(dq), dk, dv

    attention._flash_bwd = zero_dq
    try:
        _l, _p, planted_velocity = run(device)
    finally:
        attention._flash_bwd = flash_bwd
    planted = max(velocity_errors(planted_velocity).values())

    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gpu_losses,
                                                       cpu_losses))
    param_err = max(float(numpy.abs(a - b).max()) for a, b in
                    zip(T._leaves(gpu_params), T._leaves(cpu_params)))
    v_errs = velocity_errors(gpu_velocity)
    worst = max(v_errs, key=v_errs.get)
    ok = (loss_rel <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_TOL
          and v_errs[worst] <= TRAIN_VELOCITY_RTOL
          and planted > TRAIN_VELOCITY_RTOL
          and launches["flash_bwd_dq"] > 0 and launches["flash_bwd_dkv"] > 0)
    emit({"phase": "train_parity", "ok": ok, "config": cfg, "batch": batch,
          "dtype": "float32", "tf32": False, "steps": TRAIN_PARITY_STEPS,
          "gpu_losses": gpu_losses, "cpu_losses": cpu_losses,
          "loss_max_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
          "params_max_abs_err": param_err, "params_tol": TRAIN_PARAM_TOL,
          "velocity_rel_err_by_leaf": v_errs,
          "velocity_worst_leaf": [worst, v_errs[worst]],
          "velocity_rtol": TRAIN_VELOCITY_RTOL,
          "planted_zero_dq_velocity_rel_err": planted,
          "planted_zero_dq_caught": planted > TRAIN_VELOCITY_RTOL,
          "gpu_launches": launches})
    check(ok, "train_parity", "card and CPU training disagree, or the "
          "planted zero dq went unseen (loss rel %.3g, params %.3g, "
          "velocity %s %.3g, planted %.3g, launches %s)"
          % (loss_rel, param_err, worst, v_errs[worst], planted, launches))


def _named_leaves(tree, prefix=""):
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _named_leaves(leaf, prefix + key + ".")
        else:
            yield prefix + key, leaf


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import veles_tpu_torch  # noqa: F401
    except ImportError as exc:
        print("chip_smoke: the veles_tpu_torch package is not beside "
              "this script (%s)" % exc, file=sys.stderr)
        return 1
    from veles_tpu_torch.backends import set_precision
    set_precision()
    device = torch.device("cuda", 0)
    try:
        info = phase_device()
        phase_build()
        timed = phase_kernels(device)
        paths = {"serve": phase_serve(device, info["nvidia_smi"])}
        phase_parity(device)
        paths["train"] = phase_train(device, info["nvidia_smi"])
        phase_train_parity(device)
    except PhaseFailed as exc:
        print("chip_smoke FAILED in phase %s" % exc, file=sys.stderr)
        return 1
    for entry in timed:
        entry["launches_by_path"] = {path: counts[entry["name"]]
                                     for path, counts in paths.items()
                                     if counts[entry["name"]]}
        entry["launches"] = sum(entry["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{key: entry[key] for key in keys}
                      for entry in timed]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
