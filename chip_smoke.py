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
   timings); the backward pair's rows also give the body that ran, read
   from the kernels' names in a profile of the pair (it must be the
   tensor-core body), TFLOP/s and the share of the bound at that time,
   and the device time per call (``device_ms``, as the GEMM rows below).
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
6. ``serve_int8`` — the int8 deploy at full width: ``serve``'s model,
   weights, 8 requests and worker thread with ``quantize_int8(
   calibration_tokens=<first prompt>, tol=0.05)`` before warmup (the
   measured drift printed).  Exact budgets; ``qmatmul`` launches (set to
   0 just before the session, read just after) exactly 48 a prefill and
   a decode step (4 a layer); every block weight int8.  A 16-step
   decode window under ``torch.profiler`` must hold at least 48 cuBLAS
   kernels a step fewer than ``serve``'s bf16 window, where each of the
   48 block products launches at least one (so none went through the
   library here), and gives qmatmul's device time a launch against its
   bound by bytes.  Params bytes and their ratio to the
   bf16 twin's, tokens/s, TTFT, the median decode step and the share of
   tokens equal to ``serve``'s streams are printed.
7. ``serve_int8_parity`` — CONFIG cut to 2 layers, f32, TF32 off: one
   host-quantized tree serves on the card (the kernel) and on the CPU
   (the plain version), contiguous and paged with a 64-token prefill
   chunk; the streams must be equal, unless the CPU logits at the first
   divergence had a top-2 gap below 1e-3, and ``calibration_logits``
   must agree within 1e-3.
8. ``serve_paged`` — the paged path at full width: the same model and
   weights with ``kv="paged"`` (pages of 16, the default 513-page
   pool), ``prefill_chunk=256`` and ``prefix_cache="on"`` behind the
   worker thread; 8 requests, each a shared seeded 512-token stem plus
   its own tail of 16..1000 tokens, 64 new tokens each.  Exact budgets;
   launches (set to 0 just before, read just after) exactly 12
   ``paged_decode_attn`` a decode dispatch and 12 ``flash_fwd`` a chunk,
   no ``decode_attn``; at least 32 shared pages (a later admission
   adopted both stem chunks); no preemption.  Tokens/s, TTFT, step and
   chunk times, prefix hit rate, peak pages, pool bytes, host→device
   bytes a decode step, and a 16-step decode window under
   ``torch.profiler``.
9. ``serve_spec`` — as ``serve_paged`` with ``speculative="ngram"``,
   ``draft_k=4`` and tails that repeat a seeded 24-token phrase: exact
   budgets, every decode dispatch a verify, 12 ``paged_decode_attn``
   launches a verify; accept rate, tokens a dispatch, verify step,
   host time in ``propose``.
10. ``serve_paged_parity`` — CONFIG cut to 2 layers, f32, TF32 off,
   max_seq 512: 6 requests (a 64-token stem plus 8..150-token tails) x
   16 tokens.  R, the card's contiguous streams: the CPU's agree with R
   under the near-tie rule of ``parity``; the card's paged engine gives
   R exactly; chunked (64) with the prefix cache, paged and contiguous
   n-gram speculation, and a 33-page pool that preempts agree with R
   under the near-tie rule (the card's contiguous model the judge); two
   tight-pool runs give equal streams and preemption counts.
11. ``train``   — the training path at full width: ``build_train(CONFIG)``
   (bf16 compute, remat, ce_chunk 128, SGD with momentum) on
   ``synthetic_tokens(CONFIG, 8)``, one warm-up step and 5 timed ones.
   Every loss must be finite and every step must launch the forward
   kernel 24 times (forward and remat recompute) and each backward
   kernel 12 times (counts set to 0 just before the steps, read just
   after each).  Then one step under ``torch.profiler`` gives the device
   time by kernel group and the busy share, and its 12 + 12 backward
   kernels must all be the tensor-core body (``*_kernel_tc``).
12. ``train_parity`` — CONFIG width cut to 2 layers and seq_len 256,
   batch 2, float32 with TF32 off: 2 steps from the same numpy params
   on the card (kernels) and on the CPU (plain versions); the losses
   must agree within relative 1e-6, the params after 2 steps within
   max abs 1e-5, and the velocity (``-lr`` times a running gradient
   sum) leaf by leaf within max |card - cpu| <= 1e-4 · max |cpu|.  A
   third run on the card with its dq zeroed must fail that velocity
   check.
13. ``mnist``   — the MNIST MLP (784→100 tanh, 100→10 softmax, lr 0.03,
   momentum 0.9, decay 0.0005, f32) trained through the eager workflow
   (``samples.mnist.create_workflow(max_epochs=3)`` with
   ``engine.stitch=off``, minibatch 100) on the synthetic stand-in: the
   kernel counts (set to 0 just before ``run()``, read just after) must
   be exactly 300 matmul, 120 gd_dx, 240 gd_dw, 240 gd_db and 300
   gather (the fill's data and label rows); every n_err finite and the
   last validation
   error below the first.  Epochs/s, samples/s, the median train
   minibatch wall time, host→device bytes per minibatch and peak memory;
   then one epoch (``max_epochs=2``) under ``torch.profiler``: device
   time by kernel group, busy share, the largest idle gaps.
14. ``mnist_parity`` — the same seed, ``max_epochs=2`` (one train pass),
   on the card (kernels) and on the CPU (plain versions): per-epoch
   per-class n_err and confusion matrices equal, the weights, biases
   and momenta leaf by leaf within max |card − cpu| <= 1e-4 · max |cpu|;
   a third card run with gd_dx planted to return zeros must fail it.
15. ``mnist_stitched`` — the default route: ``create_workflow(native=
   True, max_epochs=3)`` with ``engine.stitch=on``: the u8 dataset
   resident, each minibatch one replay of the forward segment's CUDA
   graph (loader head, both forwards, evaluator) and, on train
   minibatches, one of the GD segment's.  Exactly 150 and 120
   dispatches, 2 captures, 0 recaptures; launches 150 gather_norm, 150
   gather, 300 matmul, 120 gd_dx, 240 gd_dw, 240 gd_db; host→device
   bytes per minibatch median <= 64 (the scalar blocks); one
   device→host copy per class close; n_err finite and falling.
   Epochs/s (over the run, and after both captures: a capture
   synchronizes and collects garbage), samples/s, the median train
   minibatch, resident bytes;
   then one steady-state epoch (epoch 1 of a ``max_epochs=3`` run)
   under ``torch.profiler``: device time by kernel, kernels per
   minibatch, host gaps, busy share.
16. ``mnist_stitched_parity`` — the stitched card run against the
   CPU's (native, one train pass), the card's stitch on against off
   (f32 dataset), a minibatch-96 run (short tails) against the CPU's,
   and a run whose GD learning rates are halved at epoch 1 against the
   CPU's (a frozen hyperparameter would fail): n_err and confusion
   equal, parameters and momenta within 1e-4 · max |cpu|.  A card run
   whose loader scalar block is written once and never again (a stale
   offset) must fail that check.
17. ``ops`` — the ops API on the card: ``matrix_reduce`` of a (4096,
   4096) f32 matrix under ``root.common.engine.pallas_reduce = True``
   launches the reduce kernel once a call (every op and axis) and agrees
   with ``_reduce_ref``; with the knob off it launches nothing.
   ``uniform_pallas(seed, (4096, 4096))`` launches once, gives the same
   bits as the same call with ``device="cpu"``, and another seed gives
   other bits.

The ``kernels`` phase also holds the paged decode kernel against
``_paged_decode_ref`` (f32 <= 1e-4, bf16 <= 2e-2) for decode (1 row)
and verify (5 and 8 rows), pages of 4, 8 and 16 keys in shuffled order,
lengths of 1, a page edge -1 and +1 and a verify limit at max_blocks·BS;
requires it to equal the contiguous decode kernel bit for bit on a pool
that mirrors a contiguous cache, to ignore garbage (1e4) in the trash
and unowned pages, and to report two planted faults (one row's first
and last table entries swapped, one row's length + 1); and times it at
the serving shape (bf16, 513-page pool, lengths up to 1564, decode and
5-row verify) beside the contiguous kernel on the mirrored cache, the
plain version and its bound by bytes (no one PyTorch call reads through
a block table, so ``library_ms`` is null).  It holds the GEMM kernel
(``matmul``: every activation × bias on/off) and the fused GD trio (every activation ×
both storage layouts × need_err_input × has_bias) against
``_matmul_ref`` / ``_gd_ref`` at 37×70×50, the MNIST shapes and 4096³,
every element within 1e-5 + 1e-5·|plain| (4096³: 1e-4 + 1e-4·|plain|,
a 4096-long f32 sum in another order), checks bit-equal relaunches,
reports three planted faults (the last K tile dropped from matmul, dx
launched after dw, the last batch tile dropped from dw) and times each
kernel at the MNIST shapes and 4096³ beside its f32 bound, the plain
version and one PyTorch call (``addmm``, ``mm``, ``sum``).  These
times are device times of back-to-back calls (queued behind a spin
kernel, one CUDA-event pair around them, per call): at the MNIST
shapes a CUDA-event pair around one call times the host wrapper, which
is kept as ``wrapper_ms``.  It holds the gather kernels (``gather``:
pads 0 and -1; ``gather_norm``: scalar and per-feature affines) on u8,
f32 and int32 tables with negative and out-of-range indices and rows of
1, 13 (no 16-B word) and 784 elements, exactly; two planted faults per
kernel (every index off by one, negative indices not zeroed) must be
reported; each is timed at 100 rows of a (7000, 784) table and at 4096
rows of a (70000, 784) u8 table beside its bound by bytes.  It holds
the int8 GEMM (``qmatmul``) against ``_qmatmul_ref`` at CONFIG's four
block shapes at M = 4 and 2048 in bf16 and M = 20 in f32, and at (5,
200, 130) and (20, 1024, 1024) with every activation (gelu included),
bias and no bias, f32 and bf16 (f32 within 1e-4 of max |plain|, bf16
within 2e-2); two planted faults (shuffled scales, the last K tile
dropped) must be reported; it is timed at the four shapes at decode (L2
flushed) and prefill beside its bound, the plain version and
``torch.mm`` on a dequantized bf16 copy plus the epilogue.  It holds the
reduce kernel against ``_reduce_ref`` at (4096, 4096), (37, 53), (24,
256), (1, 5000) and (5000, 1), f32 and bf16, every op and axis, with and
without ±inf and NaN (max and min equal, NaN where the plain version has
it; sums within 1e-6·Σ|a|, plus one bf16 ulp for bf16); a dropped last
row block and a dropped last column block must be reported; it is timed
at (4096, 4096) f32 beside ``torch.sum`` / ``amax`` / ``amin``.  It holds
the uniform kernel bit for bit against ``_uniform_ref`` at (4096, 4096)
and (1000,), f32 and bf16, in [low, high) and with mean and variance
within 5 sigma of U(low, high), and times it (L2 flushed) beside
``torch.rand``.
Every phase runs with ``precision_level`` 2 (TF32 off).

Then it prints the per-kernel JSON line, all 14 TPU kernels (launches on
the main paths, serve, serve_int8, serve_paged, serve_spec, train,
mnist, mnist_stitched and ops, max
abs error, kernel / plain / library times,
roofline bound), the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, it exits non-zero and prints no
result.
"""

import contextlib
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
# BLOCK_Q = BLOCK_K of csrc/flash_bwd.cu, both bodies: the rows a planted
# "last tile dropped" fault cuts
BWD_TILE = 64
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
# GEMM / fused GD against their plain versions, element by element within
# atol + rtol·|plain|: f32 on both sides with TF32 off, one product summed
# in another order (1/B multiplied in the kernels, divided in _gd_ref);
# at 4096^3 a 4096-long f32 sum in another order than cuBLAS's
GEMM_TOL = (1e-5, 1e-5)
GEMM_BIG_TOL = (1e-4, 1e-4)
GEMM_BIG = 4096
GEMM_ACTIVATIONS = (None, "tanh", "sigmoid", "relu", "strict_relu")
GEMM_TILE_K = 16                  # BK of csrc/gemm.cu
GD_HP = (0.03, 0.03, 0.0005, 0.0005, 0.9, 0.9)   # MNIST's <- parameters
MNIST_EPOCHS = 3
MNIST_PARITY_EPOCHS = 2
MNIST_PARAM_RTOL = 1e-4
# the JAX package's schedule for max_epochs=3: 3 validation passes of 10
# minibatches and 2 train passes of 60, two layers; only the softmax
# layer's GD computes err_input
MNIST_LAUNCHES = {"matmul": 300, "gd_dx": 120, "gd_dw": 240, "gd_db": 240,
                  "gather": 300, "gather_norm": 0}
# the stitched native route, max_epochs=3: the forward segment dispatches
# every minibatch (150), the GD segment every train minibatch (120); its
# head gathers the u8 data row (gather_norm) and the labels (gather)
MNIST_STITCHED_LAUNCHES = {"matmul": 300, "gd_dx": 120, "gd_dw": 240,
                           "gd_db": 240, "gather": 150, "gather_norm": 150}
MNIST_STITCHED_DISPATCHES = [150, 120]
# per minibatch: the loader's (offset, size), int32, and on train
# minibatches 2 layers x 6 GD hyperparameters, float32
MNIST_STITCHED_H2D_MAX = 64


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


#: spin-kernel clock rate assumed when sizing the spin (the H100's
#: highest boost clock; a slower clock only spins longer)
SPIN_CYCLES_PER_S = 2.0e9


def device_ms(fn, reps=20):
    """Device time of one call of ``fn`` in ms: ``reps`` calls queued
    behind a spinning kernel (``torch.cuda._sleep``) run back to back
    once it ends, and one CUDA-event pair around them is divided by
    ``reps``.  Unlike an event pair around one call, this leaves out the
    host's launch time, which at the MNIST shapes is longer than the
    kernel.  The spin must outlast the host's queueing of the calls;
    it is lengthened until it does."""
    fn()
    gpu_sync()
    tic = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - tic
    gpu_sync()
    cycles = int(2 * host_s * SPIN_CYCLES_PER_S) + 100000
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
    raise PhaseFailed("kernels: the host queued %d calls more slowly "
                      "than the spin lasted" % reps)


#: a launch counter's name -> its kernel group in a profile, where the two
#: differ
_PROFILE_GROUP = {"gather": "veles_gather_rows",
                  "gather_norm": "veles_gather_norm"}

#: csrc/gemm.cu's kernels by (demangled) name: one GEMM body templated
#: on its epilogue, and the db kernel
_GEMM_GROUPS = (("veles_gemm_kernel<0>", "veles_matmul"),
                ("veles_gemm_kernel<1>", "veles_gd_dx"),
                ("veles_gemm_kernel<2>", "veles_gd_dw"),
                ("veles_gd_db_kernel", "veles_gd_db"))


def _kernel_group(name):
    for tag, group in (("qmatmul_kernel", "qmatmul"),
                       ("reduce_rows_kernel", "reduce"),
                       ("reduce_cols_kernel", "reduce"),
                       ("uniform_kernel", "uniform")):
        if tag in name:
            return group
    for tag, group in _GEMM_GROUPS:
        if tag in name:
            return group
    for group in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if group + "_kernel" in name:
            return group
    if "veles_gather_norm_kernel" in name:
        return "veles_gather_norm"
    if "veles_gather_rows_kernel" in name:
        return "veles_gather_rows"
    if "decode_kernel" in name:
        return "paged_decode_attn" if "PagedKeys" in name else "decode_attn"
    if any(tag in name.lower() for tag in ("gemm", "xmma", "cutlass",
                                           "nvjet")):
        return "matmul"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copy"
    return "other"


def profile_window(fn, names_of=()):
    """Run ``fn`` once under ``torch.profiler`` and return its host wall
    time, the device time and the number of kernels of every group
    (flash_fwd, flash_bwd_dq, flash_bwd_dkv, decode_attn, the GEMM and
    gather kernels, matmul, copy, other), the 12 kernels that took most
    of it,
    and the device's busy share of the wall time; ``kernel_names``
    counts the kernels of the groups ``names_of`` by name.  Kernels run
    on one stream, so their times add."""
    from torch.profiler import ProfilerActivity, profile
    gpu_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        gpu_sync()
        wall_us = (time.perf_counter() - tic) * 1e6
    return _profile_summary(prof, wall_us, names_of)


def _profile_summary(prof, wall_us, names_of=()):
    """:func:`profile_window`'s summary of a finished profile."""
    from torch.autograd import DeviceType
    groups, counts, names, spans, named = {}, {}, {}, [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.device_time_total
        group = _kernel_group(ev.name)
        groups[group] = groups.get(group, 0.0) + us
        counts[group] = counts.get(group, 0) + 1
        names[ev.name] = names.get(ev.name, 0.0) + us
        if group in names_of:
            named[ev.name[:200]] = named.get(ev.name[:200], 0) + 1
        spans.append((ev.time_range.start, ev.time_range.end))
    busy = sum(groups.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    # idle stretches of the device between one kernel's end and the next
    # one's start: where the host held the card back
    spans.sort()
    gaps = sorted((b[0] - a[1] for a, b in zip(spans, spans[1:])
                   if b[0] > a[1]), reverse=True)
    summary = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
               "busy_share": busy / wall_us if busy else None,
               "device_ms_by_group": {g: t / 1e3
                                      for g, t in groups.items()},
               "kernels_by_group": counts,
               "top_kernels_ms": [[n[:200], t / 1e3] for n, t in top],
               "device_kernels": len(spans),
               "top_host_gaps_ms": [g / 1e3 for g in gaps[:5]],
               "host_gaps_ms_total": sum(gaps) / 1e3}
    if names_of:
        summary["kernel_names"] = named
    return summary


def _bwd_bodies(names):
    """Backward kernels by the body of ``csrc/flash_bwd.cu`` their
    profiled names belong to: ``*_kernel_tc`` is the bf16 tensor-core
    body, the rest the f32 FMA body."""
    bodies = {"tensor_core": 0, "fma": 0}
    for name, n in names.items():
        bodies["tensor_core" if "_kernel_tc<" in name else "fma"] += n
    return bodies


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
    batch at CONFIG width): each kernel's time, as the other attention
    rows take it (:func:`time_ms`, one wrapper call between CUDA events),
    with its device time per call beside it (:func:`device_ms`, without
    the host's checks and allocation), its bound, the body that ran (the
    kernels' names in a profile of the pair), the plain version's time,
    and SDPA's backward as the library time of the pair (its forward +
    backward less its forward)."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops.attention import (_bwd_dkv_cuda, _bwd_dq_cuda,
                                               _bwd_ref, _delta, _flash_bwd)
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
    # the pair with delta's reduction, so the window holds a PyTorch
    # kernel too (around ctypes launches alone the profiler saw nothing)
    names = profile_window(lambda: _flash_bwd(q, k, v, o, lse, do, True),
                           names_of=("flash_bwd_dq", "flash_bwd_dkv")
                           )["kernel_names"]

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
        bodies = _bwd_bodies({n_: c for n_, c in names.items()
                              if name + "_kernel" in n_})
        body = "+".join(b_ for b_, n_ in bodies.items() if n_)
        ok = ok and bodies == {"tensor_core": 1, "fma": 0}
        ms = time_ms(fn)
        rows.append({
            "name": name, "route": "cuda",
            "source": "veles_tpu_torch/csrc/flash_bwd.cu",
            "replaces": ("veles_tpu/ops/attention.py:202"
                         if name == "flash_bwd_dq"
                         else "veles_tpu/ops/attention.py:248"),
            "shape": [b, s, h, d], "dtype": "bfloat16", "causal": True,
            "max_abs_err": max(report[o_]["max_abs_err"] for o_ in outputs),
            "body": body,
            "ms": ms, "device_ms": device_ms(fn),
            "tflops": products * product / (ms / 1e3) / 1e12,
            "bound_share": bound * 1e3 / ms, "plain_ms": plain_ms,
            "plain_of": "_bwd_ref, the pair (dq, dk, dv)",
            "library_ms": library_ms,
            "library_of": "SDPA backward, the pair (fwd+bwd less fwd)",
            "bound_ms": bound * 1e3, "bound_by": by, "products": products,
        })
    return rows, report, ok


def _within(got, want, tol):
    """Max abs error, median |plain| and the count of elements outside
    ``atol + rtol·|plain|`` of one output against its plain version."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    outside = int((diff > tol[0] + tol[1] * want.abs()).sum())
    return {"max_abs_err": float(diff.max()) if diff.numel() else 0.0,
            "median_abs_plain": float(want.abs().median())
            if want.numel() else 0.0,
            "outside_tol": outside}


def _gemm_operands(rng, device, m, k, n, w_transposed=False):
    """a (m, k), w (k, n) (a transposed view of (n, k) storage when
    asked), bias (n,); w scaled by 1/sqrt(k), so outputs are O(1)."""
    a = _rand(rng, (m, k), torch.float32, device)
    w = _rand(rng, (n, k) if w_transposed else (k, n), torch.float32,
              device) / numpy.sqrt(k)
    bias = _rand(rng, (n,), torch.float32, device)
    return a, (w.t() if w_transposed else w), bias


def _gd_operands(rng, device, batch, f, n, transposed, scaled):
    """(x, y, eo, w, b, vw, vb) of one GD step; at the large shape x is
    scaled by 1/sqrt(batch) and w by 1/sqrt(n), so dW and err_input are
    O(1)."""
    x = _rand(rng, (batch, f), torch.float32, device)
    if scaled:
        x = x / numpy.sqrt(batch)
    y = torch.tanh(_rand(rng, (batch, n), torch.float32, device))
    eo = _rand(rng, (batch, n), torch.float32, device)
    w = _rand(rng, (n, f) if transposed else (f, n), torch.float32,
              device) / numpy.sqrt(n if scaled else f)
    b = _rand(rng, (n,), torch.float32, device)
    vw = _rand(rng, tuple(w.shape), torch.float32, device) * 0.01
    vb = _rand(rng, (n,), torch.float32, device) * 0.01
    return x, y, eo, w, b, vw, vb


def _gemm_cases(rng, device):
    """Every activation × bias on/off for matmul, and activation ×
    layout × need_err_input × has_bias for the GD trio, at the ragged,
    MNIST and 4096^3 shapes; each output element within its tolerance."""
    from veles_tpu_torch.ops import gemm
    cases = []
    shapes = ((37, 70, 50), (100, 784, 100), (100, 100, 10),
              (GEMM_BIG, GEMM_BIG, GEMM_BIG))
    for m, k, n in shapes:
        big = m == GEMM_BIG
        tol = GEMM_BIG_TOL if big else GEMM_TOL
        for activation in GEMM_ACTIVATIONS:
            for with_bias in (True, False):
                a, w, bias = _gemm_operands(rng, device, m, k, n,
                                            w_transposed=not with_bias)
                bias = bias if with_bias else None
                report = _within(gemm.matmul(a, w, bias, activation),
                                 gemm._matmul_ref(a, w, bias, activation),
                                 tol)
                cases.append(dict(report, kernel="matmul",
                                  shape=[m, k, n], activation=activation,
                                  bias=with_bias,
                                  w_transposed=not with_bias,
                                  tol=list(tol),
                                  ok=report["outside_tol"] == 0))
        for activation in GEMM_ACTIVATIONS:
            for transposed in (False, True):
                for need_err_input in (True, False):
                    for has_bias in (True, False):
                        args = _gd_operands(rng, device, m, k, n,
                                            transposed, big)
                        flags = dict(activation=activation,
                                     need_err_input=need_err_input,
                                     has_bias=has_bias,
                                     transposed=transposed)
                        want = gemm._gd_ref(*args, *GD_HP, **flags)
                        got = gemm.gd_fused(*args, *GD_HP, **flags)
                        errors = {
                            name: _within(g, w_, tol) for name, g, w_ in
                            zip(("w", "b", "vw", "vb", "err_input"), got,
                                want) if w_ is not None
                            and (has_bias or name not in ("b", "vb"))}
                        cases.append({
                            "kernel": "gd_dx+gd_dw+gd_db",
                            "shape": [m, k, n], **flags,
                            "errors": errors, "tol": list(tol),
                            "max_abs_err": max(e["max_abs_err"]
                                               for e in errors.values()),
                            "ok": all(e["outside_tol"] == 0
                                      for e in errors.values())})
    gpu_sync()
    return cases


def _gemm_repeatable(rng, device):
    """Two launches of each kernel give the same bits."""
    from veles_tpu_torch.ops import gemm
    a, w, bias = _gemm_operands(rng, device, 100, 784, 100)
    same = torch.equal(gemm.matmul(a, w, bias, "tanh"),
                       gemm.matmul(a, w, bias, "tanh"))
    args = _gd_operands(rng, device, 100, 784, 100, False, False)
    runs = []
    for _ in range(2):
        params = [t.clone() for t in args[3:]]
        runs.append(gemm.gd_fused(*args[:3], *params, *GD_HP,
                                  activation="tanh"))
    gpu_sync()
    return same and all(torch.equal(p, q) for p, q in zip(*runs))


def _gemm_planted_faults(rng, device):
    """Faults planted in the kernels' inputs at the MNIST shapes, each of
    which the tolerance must report: the last K tile dropped from
    matmul, dx launched after dw, the last batch tile dropped from dw."""
    from veles_tpu_torch.ops import gemm
    faults = {}
    a, w, bias = _gemm_operands(rng, device, 100, 784, 100)
    cut = (784 - 1) // GEMM_TILE_K * GEMM_TILE_K
    faults["last_k_tile_dropped_from_matmul"] = _within(
        gemm.matmul(a[:, :cut], w[:cut], bias, "tanh"),
        gemm._matmul_ref(a, w, bias, "tanh"), GEMM_TOL)
    x, y, eo, w, b, vw, vb = _gd_operands(rng, device, 100, 100, 10, False,
                                          False)
    want = gemm._gd_ref(x, y, eo, w, b, vw, vb, *GD_HP)
    gemm._gd_dw_cuda(x, eo, y, w, vw, 1.0 / 100, GD_HP[0], GD_HP[2],
                     GD_HP[4], None, False)
    faults["dx_launched_after_dw"] = _within(
        gemm._gd_dx_cuda(eo, y, w, None, False), want[4], GEMM_TOL)
    x, y, eo, w, b, vw, vb = _gd_operands(rng, device, 100, 784, 100, False,
                                          False)
    want = gemm._gd_ref(x, y, eo, w, b, vw, vb, *GD_HP, activation="tanh")
    cut = (100 - 1) // GEMM_TILE_K * GEMM_TILE_K
    gemm._gd_dw_cuda(x[:cut], eo[:cut], y[:cut], w, vw, 1.0 / 100,
                     GD_HP[0], GD_HP[2], GD_HP[4], "tanh", False)
    faults["last_batch_tile_dropped_from_dw"] = _within(vw, want[2],
                                                        GEMM_TOL)
    gpu_sync()
    return {name: dict(report, caught=report["outside_tol"] > 0)
            for name, report in faults.items()}


def _gemm_timed(rng, device):
    """Each kernel's device time per call (:func:`device_ms`) at the
    MNIST shapes and at 4096^3, beside its bound and the device times of
    the plain version and of one PyTorch call; ``wrapper_ms`` is the
    median of 20 CUDA-event timings around one wrapper call.  The first
    shape listed for each kernel is one the main path gives it (layer 1;
    layer 2 for gd_dx)."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import gemm
    rows = {}

    def timed(kernel, plain, library, big):
        reps = 5 if big else 20
        return (device_ms(kernel, reps), time_ms(kernel),
                device_ms(plain, reps), device_ms(library, reps))

    def row(name, shape, times, nbytes, ops, err, plain_of, library_of):
        ms, wrapper_ms, plain_ms, library_ms = times
        bound, by = bound_seconds(nbytes, ops, "float32")
        entry = rows.setdefault(name, {
            "name": name, "route": "cuda",
            "source": "veles_tpu_torch/csrc/gemm.cu",
            "replaces": "veles_tpu/ops/gemm.py:%d" % {
                "matmul": 56, "gd_dx": 322, "gd_dw": 263,
                "gd_db": 298}[name],
            "dtype": "float32", "plain_of": plain_of,
            "library_of": library_of, "by_shape": []})
        entry["by_shape"].append({
            "shape": shape, "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound * 1e3,
            "bound_by": by, "max_abs_err": err})

    # matmul: layer 1 (tanh), layer 2 (linear), 4096^3 (linear)
    for (m, k, n), act in (((100, 784, 100), "tanh"),
                           ((100, 100, 10), None),
                           ((GEMM_BIG,) * 3, None)):
        a, w, bias = _gemm_operands(rng, device, m, k, n)
        err = _within(gemm.matmul(a, w, bias, act),
                      gemm._matmul_ref(a, w, bias, act),
                      GEMM_TOL)["max_abs_err"]
        row("matmul", [m, k, n],
            timed(lambda: gemm._matmul_cuda(a, w, bias, act),
                  lambda: gemm._matmul_ref(a, w, bias, act),
                  lambda: torch.addmm(bias, a, w), m == GEMM_BIG),
            4 * (m * k + k * n + n + m * n), 2 * m * n * k, err,
            "_matmul_ref", "torch.addmm (no activation)")
    # GD: layer 1 (tanh, no err_input), layer 2 (the softmax layer, the
    # only one that launches gd_dx), 4096^3
    for (batch, f, n), act in (((100, 784, 100), "tanh"),
                               ((100, 100, 10), None),
                               ((GEMM_BIG,) * 3, "tanh")):
        big = batch == GEMM_BIG
        x, y, eo, w, b, vw, vb = _gd_operands(rng, device, batch, f, n,
                                              False, big)
        want = gemm._gd_ref(x, y, eo, w, b, vw, vb, *GD_HP, activation=act)

        def plain():
            gemm._gd_ref(x, y, eo, w, b, vw, vb, *GD_HP, activation=act)
        delta = eo * gemm._derivative(y, act)
        tol = GEMM_BIG_TOL if big else GEMM_TOL
        dx_err = _within(gemm._gd_dx_cuda(eo, y, w, act, False), want[4],
                         tol)["max_abs_err"]
        if (batch, f, n) != (100, 784, 100):
            row("gd_dx", [batch, n, f],
                timed(lambda: gemm._gd_dx_cuda(eo, y, w, act, False),
                      plain, lambda: torch.mm(delta, w.t()), big),
                4 * (2 * batch * n + n * f + batch * f),
                2 * batch * n * f, dx_err, "_gd_ref, the whole step",
                "torch.mm(delta, W^T)")
        w1, vw1, b1, vb1 = w.clone(), vw.clone(), b.clone(), vb.clone()
        gemm._gd_dw_cuda(x, eo, y, w1, vw1, 1.0 / batch, GD_HP[0],
                         GD_HP[2], GD_HP[4], act, False)
        gemm._gd_db_cuda(eo, y, b1, vb1, 1.0 / batch, GD_HP[1], GD_HP[3],
                         GD_HP[5], act)
        dw_err = max(_within(w1, want[0], tol)["max_abs_err"],
                     _within(vw1, want[2], tol)["max_abs_err"])
        db_err = max(_within(b1, want[1], tol)["max_abs_err"],
                     _within(vb1, want[3], tol)["max_abs_err"])
        # timed on copies, so the repeated in-place updates stay in range
        row("gd_dw", [batch, f, n],
            timed(lambda: gemm._gd_dw_cuda(
                x, eo, y, w1, vw1, 1.0 / batch, GD_HP[0], GD_HP[2],
                GD_HP[4], act, False),
                plain, lambda: torch.mm(x.t(), delta), big),
            4 * (batch * f + 2 * batch * n + 2 * f * n) + 4 * 2 * f * n,
            2 * batch * f * n, dw_err, "_gd_ref, the whole step",
            "torch.mm(x^T, delta)")
        row("gd_db", [batch, n],
            timed(lambda: gemm._gd_db_cuda(
                eo, y, b1, vb1, 1.0 / batch, GD_HP[1], GD_HP[3], GD_HP[5],
                act),
                plain, lambda: delta.sum(0), big),
            4 * (2 * batch * n + 2 * n) + 4 * 2 * n, 2 * batch * n, db_err,
            "_gd_ref, the whole step", "delta.sum(0)")
    gpu_sync()
    timed = []
    for name in ("matmul", "gd_dx", "gd_dw", "gd_db"):
        entry = rows[name]
        main = entry["by_shape"][0]       # the main path's shape
        entry.update({key: main[key] for key in (
            "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err")})
        timed.append(entry)
    return timed


def _gemm_kernels(device):
    """The ``kernels`` phase's GEMM half: cases, repeatability, planted
    faults and timings of the four kernels of csrc/gemm.cu."""
    rng = numpy.random.default_rng(SEED + 3)
    cases = _gemm_cases(rng, device)
    repeatable = _gemm_repeatable(rng, device)
    planted = _gemm_planted_faults(rng, device)
    timed = _gemm_timed(rng, device)
    ok = (all(c["ok"] for c in cases) and repeatable
          and all(f["caught"] for f in planted.values()))
    return {"cases": cases, "bit_equal_relaunch": repeatable,
            "planted_faults": planted}, timed, ok


# -- the gather kernels (csrc/gather.cu) ------------------------------------

#: (table dtype, table shape) the gather kernels are held on: MNIST's u8
#: and f32 data and int32 labels, rows of 1 element, of 13 B (neither a
#: 16-B nor a 4-B word) and of (3, 9, 9)
GATHER_TABLES = ((torch.uint8, (7000, 784)), (torch.float32, (7000, 784)),
                 (torch.int32, (7000,)), (torch.uint8, (50, 1)),
                 (torch.uint8, (50, 13)), (torch.float32, (50, 3, 9, 9)),
                 (torch.int32, (50, 784)))
GATHER_MAIN = (7000, 784, 100)          # the MNIST tables, minibatch 100
GATHER_BIG = (70000, 784, 4096)         # real MNIST's size, 4096 rows


def _gather_table(rng, device, dtype, shape):
    if dtype == torch.float32:
        return torch.from_numpy(rng.standard_normal(shape).astype(
            numpy.float32)).to(device)
    high = 256 if dtype == torch.uint8 else 2 ** 20
    return torch.from_numpy(rng.integers(0, high, shape)).to(dtype).to(
        device)


def _gather_indices(rng, device, n_rows, n_idx, invalid=True):
    """int32 indices; with ``invalid`` three are -1 (one at the end) and
    one is past the table, which the kernels pad as well."""
    idx = rng.integers(0, n_rows, n_idx).astype(numpy.int32)
    if invalid:
        idx[[3, 17, n_idx - 1]] = -1
        idx[5] = n_rows
    return torch.from_numpy(idx).to(device)


def _exact(got, want):
    diff = (got.double() - want.double()).abs()
    return {"max_abs_err": float(diff.max()) if diff.numel() else 0.0,
            "exact": bool(torch.equal(got, want))}


def _gather_cases(rng, device):
    """Each kernel against its plain version on every table, pads 0 and
    -1 (255 in u8), scalar and per-feature affines: exact."""
    from veles_tpu_torch.ops import gather
    cases = []
    for dtype, shape in GATHER_TABLES:
        data = _gather_table(rng, device, dtype, shape)
        idx = _gather_indices(rng, device, shape[0], 100)
        name = str(dtype).replace("torch.", "")
        for pad in (0, 255 if dtype == torch.uint8 else -1):
            report = _exact(gather.take_rows(data, idx, pad),
                            gather._gather_ref(data, idx, pad))
            cases.append(dict(report, kernel="gather", dtype=name,
                              table=list(shape), pad=pad,
                              ok=report["exact"]))
        if len(shape) == 1:
            continue
        f = int(numpy.prod(shape[1:]))
        for per_feature in (False, True):
            norm = gather.affine_tensors(
                (rng.uniform(0.5, 2.0, f), rng.standard_normal(f))
                if per_feature else (1.0 / 255.0, 0.0), device)
            got = gather.take_rows_norm(data, idx, norm)
            report = _exact(got, gather._gather_norm_ref(data, idx, *norm))
            zeroed = not bool(got[idx < 0].any())
            cases.append(dict(report, kernel="gather_norm", dtype=name,
                              table=list(shape), per_feature=per_feature,
                              negative_rows_zero=zeroed,
                              ok=report["exact"] and zeroed))
    gpu_sync()
    return cases


def _gather_repeatable(rng, device):
    from veles_tpu_torch.ops import gather
    data = _gather_table(rng, device, torch.uint8, GATHER_MAIN[:2])
    idx = _gather_indices(rng, device, GATHER_MAIN[0], GATHER_MAIN[2])
    norm = gather.affine_tensors((1.0 / 255.0, 0.0), device)
    same = (torch.equal(gather.take_rows(data, idx),
                        gather.take_rows(data, idx))
            and torch.equal(gather.take_rows_norm(data, idx, norm),
                            gather.take_rows_norm(data, idx, norm)))
    gpu_sync()
    return same


def _gather_planted_faults(rng, device):
    """Faults planted in the kernels' inputs at the main path's shape,
    each of which the exact check must report: every valid index off by
    one, and the negative indices given as 0 (a row not zeroed)."""
    from veles_tpu_torch.ops import gather
    data = _gather_table(rng, device, torch.uint8, GATHER_MAIN[:2])
    idx = _gather_indices(rng, device, GATHER_MAIN[0], GATHER_MAIN[2])
    norm = gather.affine_tensors((1.0 / 255.0, 0.0), device)
    valid = (idx >= 0) & (idx < GATHER_MAIN[0] - 1)
    shifted = torch.where(valid, idx + 1, idx)
    unzeroed = torch.where(idx < 0, 0, idx)
    want_rows = gather._gather_ref(data, idx)
    want_norm = gather._gather_norm_ref(data, idx, *norm)
    faults = {
        "gather_index_off_by_one": _exact(
            gather.take_rows(data, shifted), want_rows),
        "gather_negative_index_not_padded": _exact(
            gather.take_rows(data, unzeroed), want_rows),
        "gather_norm_index_off_by_one": _exact(
            gather.take_rows_norm(data, shifted, norm), want_norm),
        "gather_norm_negative_index_not_zeroed": _exact(
            gather.take_rows_norm(data, unzeroed, norm), want_norm),
    }
    gpu_sync()
    return {name: dict(report, caught=not report["exact"])
            for name, report in faults.items()}


def _gather_bytes(data, idx, out, extra=0):
    """Bytes the call must move: the indices, the rows of the valid
    indices (this run's data), the output, and ``extra``."""
    valid = int(((idx >= 0) & (idx < data.shape[0])).sum())
    row = data[0].numel() * data.element_size()
    return (idx.numel() * idx.element_size() + valid * row
            + out.numel() * out.element_size() + extra)


def _gather_timed(rng, device):
    """Each kernel's device time per call (:func:`device_ms`) at the
    main path's shape (100 rows of a (7000, 784) table: f32 for gather,
    the eager route's data row, u8 for gather_norm, the stitched head's)
    and at 4096 rows of a (70000, 784) u8 table, beside its bound by
    bytes, the plain version's time and ``torch.index_select``'s on the
    same, all-valid, indices (gather only: no one PyTorch call computes
    gather_norm).  The label row (100 of 7000 int32) is timed too.
    Calls run back to back on the same indices, so rows a call reads
    may be in L2."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import gather
    rows = {}

    def row(name, shape, dtype, kernel, plain, library, nbytes, ops, err):
        bound, by = bound_seconds(nbytes, ops, "float32")
        entry = rows.setdefault(name, {
            "name": name, "route": "cuda",
            "source": "veles_tpu_torch/csrc/gather.cu",
            "replaces": "veles_tpu/ops/gather.py:%d" % {
                "gather": 204, "gather_norm": 146}[name],
            "plain_of": "_gather_ref" if name == "gather"
            else "_gather_norm_ref",
            "library_of": "torch.index_select" if name == "gather"
            else None, "by_shape": []})
        entry["by_shape"].append({
            "table": list(shape), "dtype": dtype,
            "ms": device_ms(kernel), "wrapper_ms": time_ms(kernel),
            "plain_ms": device_ms(plain),
            "library_ms": device_ms(library) if library else None,
            "bound_ms": bound * 1e3, "bound_by": by, "max_abs_err": err})

    for (n, f, b), dtype in ((GATHER_MAIN, torch.float32),
                             ((GATHER_MAIN[0], None, GATHER_MAIN[2]),
                              torch.int32),
                             (GATHER_BIG, torch.uint8)):
        shape = (n,) if f is None else (n, f)
        data = _gather_table(rng, device, dtype, shape)
        idx = _gather_indices(rng, device, n, b, invalid=False)
        out = gather.take_rows(data, idx)
        err = _exact(out, gather._gather_ref(data, idx))["max_abs_err"]
        row("gather", shape, str(dtype).replace("torch.", ""),
            lambda: gather._gather_cuda(data, idx, 0),
            lambda: gather._gather_ref(data, idx, 0),
            lambda: torch.index_select(data, 0, idx),
            _gather_bytes(data, idx, out), 0, err)
    for n, f, b in (GATHER_MAIN, GATHER_BIG):
        data = _gather_table(rng, device, torch.uint8, (n, f))
        idx = _gather_indices(rng, device, n, b, invalid=False)
        scale, shift = gather.affine_tensors((1.0 / 255.0, 0.0), device)
        out = gather.take_rows_norm(data, idx, (scale, shift))
        err = _exact(out, gather._gather_norm_ref(data, idx, scale,
                                                  shift))["max_abs_err"]
        row("gather_norm", (n, f), "uint8",
            lambda: gather._gather_norm_cuda(data, idx, scale, shift),
            lambda: gather._gather_norm_ref(data, idx, scale, shift),
            None, _gather_bytes(data, idx, out, extra=8), 2 * b * f, err)
    gpu_sync()
    timed = []
    for name in ("gather_norm", "gather"):
        entry = rows[name]
        main = entry["by_shape"][0]       # the main path's shape
        entry.update({key: main[key] for key in (
            "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err")})
        timed.append(entry)
    return timed


def _gather_kernels(device):
    """The ``kernels`` phase's gather half: cases, repeatability,
    planted faults and timings of the two kernels of csrc/gather.cu."""
    rng = numpy.random.default_rng(SEED + 4)
    cases = _gather_cases(rng, device)
    repeatable = _gather_repeatable(rng, device)
    planted = _gather_planted_faults(rng, device)
    timed = _gather_timed(rng, device)
    ok = (all(c["ok"] for c in cases) and repeatable
          and all(f["caught"] for f in planted.values()))
    return {"cases": cases, "bit_equal_relaunch": repeatable,
            "planted_faults": planted}, timed, ok


# -- the paged decode kernel (csrc/decode_attn.cu, second entry) ------------

#: the serving shape of the paged paths: 4 slots, 16 heads of 64, pages
#: of 16 keys, 128 pages a row (max_seq 2048), the default 513-page pool
PAGED_SHAPE = dict(b=4, h=16, d=64, bs=16, max_blocks=128, num_blocks=513)
#: the four longest prompts of serve_paged's workload (512-token stem +
#: tails up to 1000), 52 tokens into their decode
PAGED_TIMED_LENGTHS = [1142, 1282, 1423, 1564]


def _paged_pool(rng, device, dtype, lengths, nq, row_step, b, h, d, bs,
                max_blocks, num_blocks=None, fill=None):
    """q, K and V pools with the pages in shuffled order, tables (trash
    block 0 past each row's pages) and lengths, on the card.  ``fill``
    overwrites the trash block and every page no row owns."""
    num_blocks = num_blocks or b * max_blocks + 1
    q = _rand(rng, (b, nq, h, d), dtype, device)
    kp = _rand(rng, (num_blocks, bs, h, d), dtype, device)
    vp = _rand(rng, (num_blocks, bs, h, d), dtype, device, uniform=True)
    pages = rng.permutation(numpy.arange(1, num_blocks))
    tables = numpy.zeros((b, max_blocks), numpy.int32)
    used = 0
    for i, n in enumerate(lengths):
        need = min(max_blocks, -(-(n + row_step * (nq - 1)) // bs))
        tables[i, :need] = pages[used:used + need]
        used += need
    if fill is not None:
        owned = torch.zeros(num_blocks, dtype=torch.bool, device=device)
        owned[torch.from_numpy(tables[tables > 0]).long().to(device)] = True
        kp[~owned] = fill
        vp[~owned] = fill
    return (q, kp, vp, torch.from_numpy(tables).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


def _paged_out(args, row_step):
    from veles_tpu_torch.ops.attention import _paged_decode_cuda
    out = _paged_decode_cuda(*args, row_step)
    gpu_sync()
    return out


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def _paged_cases(rng, device):
    """The kernel against ``_paged_decode_ref`` (f32 <= 1e-4, bf16 <=
    2e-2): decode (nq 1) and verify (nq 5, 8), pages of 4, 8 and 16
    keys, lengths of 1, a page edge -1 and +1 and a verify limit that
    reaches max_blocks·BS, pages in shuffled order."""
    from veles_tpu_torch.ops.attention import _paged_decode_ref
    cases = []
    b, h, d = 4, 16, 64
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for bs in (4, 8, 16):
            max_blocks = 2048 // bs
            for nq, row_step in ((1, 0), (5, 1), (8, 1)):
                lengths = [1, 7 * bs - 1, 7 * bs + 1,
                           max_blocks * bs - row_step * (nq - 1)]
                args = _paged_pool(rng, device, dtype, lengths, nq,
                                   row_step, b, h, d, bs, max_blocks)
                err = _max_err(_paged_out(args, row_step),
                               _paged_decode_ref(*args, row_step))
                cases.append({"kernel": "paged_decode_attn",
                              "dtype": str(dtype).replace("torch.", ""),
                              "q": [b, nq, h, d], "block_size": bs,
                              "max_blocks": max_blocks, "lengths": lengths,
                              "row_step": row_step, "max_abs_err": err,
                              "tol": tol, "ok": err <= tol})
    return cases


def _paged_mirror(rng, device):
    """On a pool that mirrors a contiguous cache page by page (shuffled,
    garbage in the trash block), the paged kernel's output equals the
    contiguous kernel's bit for bit, f32 and bf16, decode and verify."""
    from veles_tpu_torch.ops.attention import _decode_cuda
    report, ok = [], True
    b, h, d, bs, mb = 4, 16, 64, 16, 128
    for dtype in (torch.float32, torch.bfloat16):
        for nq, row_step in ((1, 0), (5, 1)):
            k = _rand(rng, (b, mb * bs, h, d), dtype, device)
            v = _rand(rng, (b, mb * bs, h, d), dtype, device, uniform=True)
            q = _rand(rng, (b, nq, h, d), dtype, device)
            lens = torch.tensor([1, 17, 1000, mb * bs - row_step * (nq - 1)],
                                dtype=torch.int32, device=device)
            tables = torch.from_numpy(rng.permutation(numpy.arange(
                1, b * mb + 1)).reshape(b, mb).astype(numpy.int32)).to(device)
            kp = torch.full((b * mb + 1, bs, h, d), 1e4, dtype=dtype,
                            device=device)
            vp = kp.clone()
            kp[tables.long()] = k.reshape(b, mb, bs, h, d)
            vp[tables.long()] = v.reshape(b, mb, bs, h, d)
            paged = _paged_out((q, kp, vp, tables, lens), row_step)
            contiguous = _decode_cuda(q, k, v, lens, row_step)
            gpu_sync()
            equal = bool(torch.equal(paged, contiguous))
            ok = ok and equal
            report.append({"dtype": str(dtype).replace("torch.", ""),
                           "nq": nq, "row_step": row_step,
                           "bit_equal": equal})
    return report, ok


def _paged_garbage_and_faults(rng, device):
    """Finite garbage (1e4) in the trash block and every unowned page
    leaves the output as it is with zeros there; and two faults planted
    in the inputs (one row's first and last table entries swapped, one
    row's length + 1) must each move the output past the f32 tolerance
    of the plain version on the true inputs."""
    from veles_tpu_torch.ops.attention import _paged_decode_ref
    sh = PAGED_SHAPE
    out = {}
    for nq, row_step in ((1, 0), (8, 1)):
        lengths = [1, 7 * sh["bs"] + 1, 1000, 2048 - row_step * (nq - 1)]
        seed = int(rng.integers(1 << 30))
        clean = _paged_pool(numpy.random.default_rng(seed), device,
                            torch.float32, lengths, nq, row_step, sh["b"],
                            sh["h"], sh["d"], sh["bs"], sh["max_blocks"],
                            fill=0.0)
        dirty = _paged_pool(numpy.random.default_rng(seed), device,
                            torch.float32, lengths, nq, row_step, sh["b"],
                            sh["h"], sh["d"], sh["bs"], sh["max_blocks"],
                            fill=1e4)
        out["garbage_row_step%d" % row_step] = {"bit_equal": bool(
            torch.equal(_paged_out(clean, row_step),
                        _paged_out(dirty, row_step)))}
        want = _paged_decode_ref(*clean, row_step)
        q, kp, vp, tables, lens = clean
        swapped = tables.clone()
        last = (lengths[1] + row_step * (nq - 1) - 1) // sh["bs"]
        swapped[1, 0], swapped[1, last] = tables[1, last], tables[1, 0]
        longer = lens.clone()
        longer[2] += 1
        for name, args in (("tables_swapped", (q, kp, vp, swapped, lens)),
                           ("length_plus_one", (q, kp, vp, tables, longer))):
            err = _max_err(_paged_out(args, row_step), want)
            out["%s_row_step%d" % (name, row_step)] = {
                "max_abs_err": err, "caught": err > F32_TOL}
    ok = all(v.get("bit_equal", v.get("caught")) for v in out.values())
    return out, ok


def _paged_timed(rng, device):
    """The kernel at the serving shape (bf16, 513-page shuffled pool,
    lengths as serve_paged reaches them), decode and 5-row verify,
    beside the contiguous kernel on the mirrored cache, the plain version
    and the bound by bytes."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops.attention import (_decode_cuda,
                                               _paged_decode_cuda,
                                               _paged_decode_ref)
    sh = PAGED_SHAPE
    b, h, d, bs, mb = sh["b"], sh["h"], sh["d"], sh["bs"], sh["max_blocks"]
    flush = make_l2_flush(device)
    row = {"name": "paged_decode_attn", "route": "cuda",
           "source": "veles_tpu_torch/csrc/decode_attn.cu",
           "replaces": "veles_tpu/ops/attention.py:597",
           "q": [b, 1, h, d], "pool": [sh["num_blocks"], bs, h, d],
           "tables": [b, mb], "lengths": PAGED_TIMED_LENGTHS,
           "dtype": "bfloat16", "library_ms": None,
           "library": "none: no one PyTorch call reads through a block "
                      "table (a gather plus SDPA is two)"}
    for nq, row_step, tag in ((1, 0, ""), (5, 1, "verify_")):
        args = _paged_pool(rng, device, torch.bfloat16, PAGED_TIMED_LENGTHS,
                           nq, row_step, b, h, d, bs, mb, sh["num_blocks"])
        q, kp, vp, tables, lens = args
        err = _max_err(_paged_out(args, row_step),
                       _paged_decode_ref(*args, row_step))
        # the contiguous cache the pool mirrors
        k = kp[tables.long()].reshape(b, mb * bs, h, d)
        v = vp[tables.long()].reshape(b, mb * bs, h, d)
        keys = sum(min(n + row_step * (nq - 1), mb * bs)
                   for n in PAGED_TIMED_LENGTHS)
        nbytes = (2 * keys * h * d * 2 + tables.numel() * 4
                  + 2 * b * nq * h * d * 2 + b * 4)
        ops = 4 * d * h * sum(min(n + row_step * r, mb * bs)
                              for n in PAGED_TIMED_LENGTHS
                              for r in range(nq))
        bound, by = bound_seconds(nbytes, ops, "bfloat16")
        row.update({
            tag + "max_abs_err": err,
            tag + "ms": time_ms(lambda: _paged_decode_cuda(*args, row_step),
                                flush=flush),
            tag + "contiguous_ms": time_ms(
                lambda: _decode_cuda(q, k, v, lens, row_step), flush=flush),
            tag + "plain_ms": time_ms(
                lambda: _paged_decode_ref(*args, row_step), flush=flush),
            tag + "bound_ms": bound * 1e3, tag + "bound_by": by})
    return row


def _paged_kernels(device):
    """The ``kernels`` phase's paged half: cases, the mirror check, the
    garbage check, planted faults and the timed row."""
    rng = numpy.random.default_rng(SEED + 5)
    cases = _paged_cases(rng, device)
    mirror, mirror_ok = _paged_mirror(rng, device)
    faults, faults_ok = _paged_garbage_and_faults(rng, device)
    row = _paged_timed(rng, device)
    ok = (all(c["ok"] for c in cases) and mirror_ok and faults_ok
          and row["max_abs_err"] <= BF16_TOL
          and row["verify_max_abs_err"] <= BF16_TOL)
    return {"cases": cases, "mirror": mirror,
            "garbage_and_planted_faults": faults}, [row], ok


# -- the int8 GEMM (csrc/qgemm.cu) ------------------------------------------

#: CONFIG's block weights, (K, N) and the epilogue the model gives each:
#: wqkv, wo, w1 (bias + gelu), w2 (bias); 4 calls a layer
QMM_LAYER = (("wqkv", 1024, 3072, False, None),
             ("wo", 1024, 1024, False, None),
             ("w1", 1024, 4096, True, "gelu"),
             ("w2", 4096, 1024, True, None))
QMM_DECODE_M = 4                 # a decode step of 4 slots
QMM_VERIFY_M = 20                # a verify step: 4 slots x 5 rows
QMM_PREFILL_M = 2048             # the largest prefill bucket
QMM_ACTIVATIONS = (None, "tanh", "sigmoid", "relu", "strict_relu", "gelu")
QMM_TILE_K = 64                  # BK of csrc/qgemm.cu


def _qmm_operands(rng, device, m, k, n, dtype, bias=True):
    """a (m, k), int8 q (k, n) over the full range, per-channel scales,
    and a bias (n,) in a's dtype: scaled so outputs stay below 4, where a
    bf16 ulp (<= 2^-6) is inside BF16_TOL."""
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(
        numpy.float32)).to(device, dtype)
    q = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(
        numpy.int8)).to(device)
    scale = torch.from_numpy((rng.uniform(0.25, 0.75, n) / 127
                              / numpy.sqrt(k)).astype(numpy.float32))
    scale = scale.to(device)
    b = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(
        numpy.float32)).to(device, dtype) if bias else None
    return a, q, scale, b


def _qmm_err(got, want, dtype):
    """Max abs error of a qmatmul output and whether it is inside the
    tolerance: f32 within 1e-4 of max |plain|, bf16 within BF16_TOL."""
    err = float((got.float() - want.float()).abs().max())
    tol = (F32_TOL * float(want.float().abs().max())
           if dtype == torch.float32 else BF16_TOL)
    return {"max_abs_err": err, "tol": tol, "ok": err <= tol}


def _qgemm_cases(rng, device):
    """The four layer shapes at M = 4 and M = 2048 in bf16 and at M = 20
    in f32; a ragged (5, 200, 130) and a (20, 1024, 1024) case with every
    activation, bias and no bias, in f32 and bf16."""
    from veles_tpu_torch.ops import qgemm
    cases = []

    def case(m, k, n, dtype, has_bias, activation, label):
        a, q, scale, b = _qmm_operands(rng, device, m, k, n, dtype, has_bias)
        report = _qmm_err(qgemm.qmatmul(a, q, scale, b, activation),
                          qgemm._qmatmul_ref(a, q, scale, b, activation),
                          dtype)
        cases.append(dict(report, kernel="qmatmul", weight=label,
                          shape=[m, k, n], dtype=str(dtype)[6:],
                          bias=has_bias, activation=activation,
                          split=qgemm.split_k(m, n, k)))

    for m, dtype in ((QMM_DECODE_M, torch.bfloat16),
                     (QMM_PREFILL_M, torch.bfloat16),
                     (QMM_VERIFY_M, torch.float32)):
        for label, k, n, has_bias, activation in QMM_LAYER:
            case(m, k, n, dtype, has_bias, activation, label)
    for m, k, n in ((5, 200, 130), (QMM_VERIFY_M, 1024, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            for activation in QMM_ACTIVATIONS:
                for has_bias in (True, False):
                    case(m, k, n, dtype, has_bias, activation, None)
    gpu_sync()
    return cases


def _qgemm_planted_faults(rng, device):
    """Faults planted in the kernel's inputs at the decode shape of wqkv,
    each of which the tolerance must report: the scales shuffled, and
    the last K tile dropped."""
    from veles_tpu_torch.ops import qgemm
    m, k, n = QMM_DECODE_M, 1024, 3072
    a, q, scale, _b = _qmm_operands(rng, device, m, k, n, torch.bfloat16)
    want = qgemm._qmatmul_ref(a, q, scale)
    perm = torch.from_numpy(rng.permutation(n)).to(device)
    cut = k - QMM_TILE_K
    faults = {
        "scales_shuffled": _qmm_err(qgemm.qmatmul(a, q, scale[perm]), want,
                                    torch.bfloat16),
        "last_k_tile_dropped": _qmm_err(
            qgemm.qmatmul(a[:, :cut], q[:cut].contiguous(), scale), want,
            torch.bfloat16)}
    gpu_sync()
    return {name: dict(report, caught=not report["ok"])
            for name, report in faults.items()}


def _qmm_bytes(m, k, n, dtype, has_bias):
    elem = 2 if dtype == torch.bfloat16 else 4
    return m * k * elem + k * n + 4 * n + (n * elem if has_bias else 0) \
        + m * n * elem


def _qgemm_timed(rng, device):
    """The kernel at each of a layer's four shapes, at decode (M = 4,
    bound by bytes, L2 flushed before each call) and at the largest
    prefill bucket (M = 2048), bf16: median of 20 CUDA-event timings
    beside the bound, the plain version and one library call (torch.mm,
    or addmm with the bias, on a dequantized bf16 copy, then gelu where
    the model fuses it).  The row's headline is one decode layer: the sum
    of the four decode calls."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import qgemm
    flush = make_l2_flush(device)
    by_shape = []
    for m in (QMM_DECODE_M, QMM_PREFILL_M):
        for label, k, n, has_bias, activation in QMM_LAYER:
            dtype = torch.bfloat16
            a, q, scale, b = _qmm_operands(rng, device, m, k, n, dtype,
                                           has_bias)
            err = _qmm_err(qgemm.qmatmul(a, q, scale, b, activation),
                           qgemm._qmatmul_ref(a, q, scale, b, activation),
                           dtype)["max_abs_err"]
            wd = (q.float() * scale).to(dtype)

            def library(a=a, wd=wd, b=b, activation=activation):
                out = torch.addmm(b, a, wd) if b is not None \
                    else torch.mm(a, wd)
                return F.gelu(out, approximate="tanh") \
                    if activation == "gelu" else out
            nbytes = _qmm_bytes(m, k, n, dtype, has_bias)
            bound, by = bound_seconds(nbytes, 2 * m * k * n, "bfloat16")
            cold = flush if by == "bytes" else None
            by_shape.append({
                "weight": label, "shape": [m, k, n], "dtype": "bfloat16",
                "bias": has_bias, "activation": activation,
                "split": qgemm.split_k(m, n, k),
                "ms": time_ms(lambda: qgemm._qmatmul_cuda(
                    a, q, scale, b, activation, dtype), flush=cold),
                "plain_ms": time_ms(lambda: qgemm._qmatmul_ref(
                    a, q, scale, b, activation), flush=cold),
                "library_ms": time_ms(library, flush=cold),
                "bound_ms": bound * 1e3, "bound_by": by,
                "max_abs_err": err})
    gpu_sync()
    decode = [s for s in by_shape if s["shape"][0] == QMM_DECODE_M]
    row = {"name": "qmatmul", "route": "cuda",
           "source": "veles_tpu_torch/csrc/qgemm.cu",
           "replaces": "veles_tpu/ops/qgemm.py:57",
           "dtype": "bfloat16", "shape": "one decode layer: the 4 calls "
           "at M=%d (wqkv, wo, w1, w2)" % QMM_DECODE_M,
           "plain_of": "_qmatmul_ref",
           "library_of": "torch.mm / addmm on a dequantized bf16 copy, "
           "then the epilogue", "by_shape": by_shape,
           "bound_by": "bytes",
           "max_abs_err": max(s["max_abs_err"] for s in decode)}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        row[key] = sum(s[key] for s in decode)
    return row


def _qgemm_kernels(device):
    """The ``kernels`` phase's int8 part: cases, repeatability, planted
    faults and timings of csrc/qgemm.cu."""
    from veles_tpu_torch.ops import qgemm
    rng = numpy.random.default_rng(SEED + 5)
    cases = _qgemm_cases(rng, device)
    a, q, scale, b = _qmm_operands(rng, device, QMM_DECODE_M, 4096, 1024,
                                   torch.bfloat16)
    repeatable = torch.equal(qgemm.qmatmul(a, q, scale, b),
                             qgemm.qmatmul(a, q, scale, b))
    planted = _qgemm_planted_faults(rng, device)
    row = _qgemm_timed(rng, device)
    ok = (all(c["ok"] for c in cases) and repeatable
          and all(f["caught"] for f in planted.values()))
    return {"cases": cases, "bit_equal_relaunch": repeatable,
            "planted_faults": planted}, [row], ok


# -- the reduction (csrc/reduce.cu) ------------------------------------------

REDUCE_BIG = (4096, 4096)
REDUCE_SHAPES = (REDUCE_BIG, (37, 53), (24, 256), (1, 5000), (5000, 1))
REDUCE_SUM_RTOL = 1e-6
REDUCE_BLOCK = 512               # the Pallas kernel's rows (columns) a block


def _reduce_matrix(rng, device, shape, dtype, specials):
    a = rng.standard_normal(shape).astype(numpy.float32)
    if specials and min(shape) > 1:
        m, n = shape
        a[0, n - 1], a[m - 1, 0], a[m // 2, n // 2] = \
            numpy.inf, -numpy.inf, numpy.nan
        a[m // 3, :] = numpy.inf                  # a whole row of +inf
    return torch.from_numpy(a).to(device, dtype)


def _reduce_agree(got, want, a, op, axis):
    """max / min: equal, NaN where the plain version has NaN; sum: NaN
    and inf where the plain version has them, and elsewhere within
    1e-6·Σ|a| (finite entries) plus one bf16 ulp of |plain| for a bf16
    output, whose f32 sum each side rounds once."""
    g, w = got.float(), want.float()
    nan = torch.isnan(w)
    same_nan = bool(torch.equal(torch.isnan(g), nan))
    if op != "sum":
        exact = bool(torch.equal(g[~nan], w[~nan]))
        diff = (g - w).abs()[~nan]
        return {"max_abs_err": float(diff.max()) if diff.numel() else 0.0,
                "bit_equal": exact, "ok": same_nan and exact}
    inf = torch.isinf(w)
    same_inf = bool(torch.equal(g[inf], w[inf]))
    scale = a.float().nan_to_num(0.0, 0.0, 0.0).abs().sum(axis)
    tol = REDUCE_SUM_RTOL * scale
    if a.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * w.abs()
    ok = ~nan & ~inf
    diff = (g - w).abs()
    outside = int((diff[ok] > tol[ok]).sum())
    return {"max_abs_err": float(diff[ok].max()) if ok.any() else 0.0,
            "outside_tol": outside,
            "ok": same_nan and same_inf and outside == 0}


def _reduce_cases(rng, device):
    from veles_tpu_torch.ops import reduce
    cases = []
    for shape in REDUCE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for specials in (False, True):
                a = _reduce_matrix(rng, device, shape, dtype, specials)
                for op in ("sum", "max", "min"):
                    for axis in (0, 1):
                        report = _reduce_agree(
                            reduce.matrix_reduce(a, axis, op, use_pallas=True),
                            reduce._reduce_ref(a, axis, op), a, op, axis)
                        cases.append(dict(
                            report, kernel="reduce", shape=list(shape),
                            dtype=str(dtype)[6:], op=op, axis=axis,
                            nan_inf=specials and min(shape) > 1))
    gpu_sync()
    return cases


def _reduce_planted_faults(rng, device):
    """The last row block (512 rows, the Pallas kernel's block) dropped
    from a sum over axis 0, and the last column block from a max over
    axis 1, at the main shape: each must be reported."""
    from veles_tpu_torch.ops import reduce
    a = _reduce_matrix(rng, device, REDUCE_BIG, torch.float32, False)
    cut = REDUCE_BIG[0] - REDUCE_BLOCK
    faults = {
        "last_row_block_dropped_sum_axis0": _reduce_agree(
            reduce.matrix_reduce(a[:cut], 0, "sum", use_pallas=True),
            reduce._reduce_ref(a, 0, "sum"), a, "sum", 0),
        "last_column_block_dropped_max_axis1": _reduce_agree(
            reduce.matrix_reduce(a[:, :cut], 1, "max", use_pallas=True),
            reduce._reduce_ref(a, 1, "max"), a, "max", 1)}
    gpu_sync()
    return {name: dict(report, caught=not report["ok"])
            for name, report in faults.items()}


def _reduce_timed(rng, device):
    """Every op and axis at (4096, 4096) f32, L2 flushed before each
    call: median of 20 CUDA-event timings beside the byte bound, the
    plain version and torch's one call (sum, amax, amin along the
    axis); the headline is the sum over axis 0, the reference's default
    axis."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import reduce
    flush = make_l2_flush(device)
    a = _reduce_matrix(rng, device, REDUCE_BIG, torch.float32, False)
    m, n = REDUCE_BIG
    library = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}
    by_shape = []
    for op in ("sum", "max", "min"):
        for axis in (0, 1):
            out = n if axis == 0 else m
            bound, by = bound_seconds(4 * (m * n + out), m * n, "float32")
            err = _reduce_agree(reduce.matrix_reduce(a, axis, op, True),
                                reduce._reduce_ref(a, axis, op), a, op,
                                axis)["max_abs_err"]
            by_shape.append({
                "shape": [m, n], "dtype": "float32", "op": op, "axis": axis,
                "ms": time_ms(lambda: reduce._reduce_cuda(a, axis, op),
                              flush=flush),
                "plain_ms": time_ms(lambda: reduce._reduce_ref(a, axis, op),
                                    flush=flush),
                "library_ms": time_ms(lambda: library[op](a, dim=axis),
                                      flush=flush),
                "bound_ms": bound * 1e3, "bound_by": by, "max_abs_err": err})
    gpu_sync()
    row = {"name": "reduce", "route": "cuda",
           "source": "veles_tpu_torch/csrc/reduce.cu",
           "replaces": "veles_tpu/ops/reduce.py:44",
           "plain_of": "_reduce_ref",
           "library_of": "torch.sum / torch.amax / torch.amin",
           "by_shape": by_shape}
    row.update({key: by_shape[0][key] for key in (
        "shape", "dtype", "op", "axis", "ms", "plain_ms", "library_ms",
        "bound_ms", "bound_by", "max_abs_err")})
    return row


def _reduce_kernels(device):
    from veles_tpu_torch.ops import reduce
    rng = numpy.random.default_rng(SEED + 6)
    cases = _reduce_cases(rng, device)
    a = _reduce_matrix(rng, device, REDUCE_BIG, torch.float32, False)
    repeatable = all(torch.equal(reduce.matrix_reduce(a, ax, "sum", True),
                                 reduce.matrix_reduce(a, ax, "sum", True))
                     for ax in (0, 1))
    planted = _reduce_planted_faults(rng, device)
    row = _reduce_timed(rng, device)
    ok = (all(c["ok"] for c in cases) and repeatable
          and all(f["caught"] for f in planted.values()))
    return {"cases": cases, "bit_equal_relaunch": repeatable,
            "planted_faults": planted}, [row], ok


# -- the uniform fill (csrc/random.cu) ----------------------------------------

UNIFORM_BIG = (4096, 4096)


def _uniform_moments(x, low, high):
    """Mean and variance of a fill against U(low, high): each within 5
    sigma (the variance's sigma from the fourth central moment (high -
    low)^4 / 80), plus half a bf16 ulp of max(|low|, |high|) for a bf16
    fill's rounding."""
    n = x.numel()
    xd = x.double()
    mean, var = (low + high) / 2, (high - low) ** 2 / 12
    slack = 0.0 if x.dtype == torch.float32 else \
        2.0 ** -8 * max(abs(low), abs(high))
    mean_err = abs(float(xd.mean()) - mean)
    var_err = abs(float(xd.var()) - var)
    mean_tol = 5 * (var / n) ** 0.5 + slack
    var_tol = 5 * (((high - low) ** 4 / 80 - var ** 2) / n) ** 0.5 \
        + 2 * slack * (high - low)
    return {"mean_err": mean_err, "mean_tol": mean_tol, "var_err": var_err,
            "var_tol": var_tol, "in_range": bool(float(x.min()) >= low
                                                 and float(x.max()) < high),
            "ok": mean_err <= mean_tol and var_err <= var_tol}


def _uniform_cases(device):
    from veles_tpu_torch.ops import random
    cases = []
    for shape in (UNIFORM_BIG, (1000,)):
        for dtype in (torch.float32, torch.bfloat16):
            for low, high in ((0.0, 1.0), (-2.0, 3.0)):
                got = random.uniform_pallas(SEED + 11, shape, dtype, low,
                                            high)
                want = random._uniform_ref(SEED + 11, shape, dtype, low,
                                           high, device=device)
                moments = _uniform_moments(got, low, high)
                same = bool(torch.equal(got, want))
                cases.append(dict(moments, kernel="uniform",
                                  shape=list(shape), dtype=str(dtype)[6:],
                                  low=low, high=high, bit_equal=same,
                                  ok=same and moments["in_range"]
                                  and moments["ok"]))
    gpu_sync()
    return cases


def _uniform_timed(device):
    """(4096, 4096) f32 in [0, 1): median of 20 CUDA-event timings, L2
    flushed before each call, beside the bound by bytes written, the
    plain version (Philox in torch int64 on the card) and torch.rand
    with a CUDA generator."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import random
    flush = make_l2_flush(device)
    shape = UNIFORM_BIG
    count = shape[0] * shape[1]
    gen = torch.Generator(device=device).manual_seed(SEED)
    bound, by = bound_seconds(4 * count, 0, "float32")
    err = float((random.uniform_pallas(SEED, shape)
                 - random._uniform_ref(SEED, shape, device=device)
                 ).abs().max())
    row = {"name": "uniform", "route": "cuda",
           "source": "veles_tpu_torch/csrc/random.cu",
           "replaces": "veles_tpu/ops/random.py:36",
           "shape": list(shape), "dtype": "float32",
           "plain_of": "_uniform_ref",
           "library_of": "torch.rand with a CUDA generator",
           "ms": time_ms(lambda: random._uniform_cuda(
               SEED, shape, torch.float32, 0.0, 1.0, device), flush=flush),
           "plain_ms": time_ms(lambda: random._uniform_ref(
               SEED, shape, device=device), flush=flush),
           "library_ms": time_ms(lambda: torch.rand(
               shape, generator=gen, device=device), flush=flush),
           "bound_ms": bound * 1e3, "bound_by": by, "max_abs_err": err}
    gpu_sync()
    return row


def _uniform_kernels(device):
    cases = _uniform_cases(device)
    row = _uniform_timed(device)
    ok = all(c["ok"] for c in cases) and row["max_abs_err"] == 0.0
    return {"cases": cases}, [row], ok


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
    gemm_report, gemm_rows, gemm_ok = _gemm_kernels(device)
    gather_report, gather_rows, gather_ok = _gather_kernels(device)
    paged_report, paged_rows, paged_ok = _paged_kernels(device)
    qgemm_report, qgemm_rows, qgemm_ok = _qgemm_kernels(device)
    reduce_report, reduce_rows, reduce_ok = _reduce_kernels(device)
    uniform_report, uniform_rows, uniform_ok = _uniform_kernels(device)
    timed = ([flash] + bwd_rows + [decode] + paged_rows + gemm_rows
             + gather_rows + qgemm_rows + reduce_rows + uniform_rows)
    ok = (not bad and ferr <= BF16_TOL and derr <= BF16_TOL and bwd_ok
          and gemm_ok and gather_ok and paged_ok and qgemm_ok and reduce_ok
          and uniform_ok)
    emit({"phase": "kernels", "ok": ok, "cases": cases,
          "timed_backward_errors": bwd_report, "gemm": gemm_report,
          "gather": gather_report, "paged": paged_report,
          "qgemm": qgemm_report, "reduce": reduce_report,
          "uniform": uniform_report, "timed": timed})
    gemm_bad = [c for c in gemm_report["cases"] if not c["ok"]]
    gather_bad = [c for c in gather_report["cases"] if not c["ok"]]
    paged_bad = [c for c in paged_report["cases"] if not c["ok"]]
    new_bad = [c for report in (qgemm_report, reduce_report, uniform_report)
               for c in report["cases"] if not c["ok"]]
    check(ok, "kernels", "kernel disagrees with its plain version, or a "
          "planted fault went unseen: %s" % (
              bad or gemm_bad[:4] or gather_bad[:4] or paged_bad[:4]
              or new_bad[:4]
              or [gemm_report["planted_faults"],
                  gather_report["planted_faults"],
                  paged_report["mirror"],
                  paged_report["garbage_and_planted_faults"],
                  qgemm_report["planted_faults"],
                  reduce_report["planted_faults"],
                  qgemm_report["bit_equal_relaunch"],
                  reduce_report["bit_equal_relaunch"], uniform_rows]))
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

    lengths, workload = serve_workload(CONFIG["vocab"])

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
    window = info["breakdown"]["decode_window"]
    blas_per_step = window["kernels_by_group"].get("matmul", 0) / float(
        window["steps"])
    emit(info)
    engine.close()
    check(budgets_ok, "serve", "a request did not get exactly %d tokens"
          % SERVE_NEW_TOKENS)
    check(in_vocab, "serve", "a token lies outside the vocabulary")
    check(counted, "serve", "the kernels were not on the main path: "
          "launches %s for %d prefills and %d decode steps"
          % (launches, prefills, steps))
    return launches, results, info["params_bytes"], blas_per_step


def serve_workload(vocab):
    """The serving sessions' 8 seeded prompts of 16..1500 tokens, evenly
    spread and shuffled: ``(lengths, prompts)``."""
    rng = numpy.random.default_rng(SEED)
    lengths = numpy.linspace(16, 1500, SERVE_REQUESTS).astype(int)
    rng.shuffle(lengths)
    return lengths, [rng.integers(0, vocab, int(n)).tolist()
                     for n in lengths]


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


# -- the int8 deploy --------------------------------------------------------

INT8_TOL = 0.05                  # the drift gate of the JAX smoke's phase 3
QMM_PER_LAYER = 4                # wqkv, wo, w1, w2
INT8_PARITY_CHUNK = 64


def phase_serve_int8(device, smi, serve_streams, bf16_params_bytes,
                     bf16_blas_per_step):
    """``serve``'s model, weights, workload and worker thread with the
    block weights quantized to int8 before warmup (drift gate at 0.05
    on the first prompt): exact budgets; exactly 48 qmatmul launches a
    prefill and a decode step over the session; in a profiled 16-step
    decode window, at least 48 cuBLAS kernels a step fewer than the bf16
    twin's window (``bf16_blas_per_step``, from ``serve``), whose 48
    block products each launch at least one (so no block product went
    through the library); every block weight int8.  Prints the bytes against the bf16 twin's,
    tokens/s, TTFT, the decode step, the share of tokens equal to
    ``serve``'s, and qmatmul's device time a launch in a profiled
    16-step decode window against its byte bound."""
    from veles_tpu_torch import quant, trace
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.config import root
    from veles_tpu_torch.gen import (GenerativeEngine, GenerativeScheduler,
                                     TransformerGenModel)
    from veles_tpu_torch.ops import attention, gemm, qgemm
    from veles_tpu_torch.samples.transformer import CONFIG

    lengths, workload = serve_workload(CONFIG["vocab"])
    tic = time.perf_counter()
    model = TransformerGenModel(CONFIG, compute_dtype=torch.bfloat16,
                                device=device)
    engine = GenerativeEngine(model, max_slots=4, max_seq=2048, seed=SEED,
                              device=device)
    with torch.inference_mode():
        ref_logits = model.calibration_logits(engine._params, workload[0])
    engine.quantize_int8(calibration_tokens=workload[0], tol=INT8_TOL)
    with torch.inference_mode():
        drift = quant.relative_drift(
            ref_logits.float().cpu().numpy(), model.calibration_logits(
                engine._params, workload[0]).float().cpu().numpy())
    quantize_s = time.perf_counter() - tic
    tic = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - tic
    blocks = engine._params["blocks"]
    int8_blocks = {key: str(blocks[key]["q"].dtype)[6:]
                   if isinstance(blocks[key], dict) else str(blocks[key].dtype)
                   for key in ("wqkv", "wo", "w1", "w2")}

    root.common.engine.trace = "on"
    trace.configure()
    trace.recorder.clear()
    reset_all_launches()
    prefill0, decode0 = engine.prefill_calls, engine.decode_calls
    scheduler = GenerativeScheduler(engine, name="chip-smoke-int8").start()
    try:
        tic = time.perf_counter()
        futures = [scheduler.submit(toks, SERVE_NEW_TOKENS)
                   for toks in workload]
        results = [f.result(timeout=600) for f in futures]
        elapsed = time.perf_counter() - tic
    finally:
        scheduler.stop()
    launches = {**attention.launches, **gemm.launches, **qgemm.launches}
    prefills = engine.prefill_calls - prefill0
    steps = engine.decode_calls - decode0
    events = trace.recorder.events()
    root.common.engine.trace = "off"
    trace.configure()

    decode_ms = [ev[4] / 1e6 for ev in events
                 if ev[0] == "X" and ev[2] == "decode"]
    tokens = sum(len(r) for r in results)
    same = sum(a == b for got, want in zip(results, serve_streams)
               for a, b in zip(got, want))
    layers = CONFIG["layers"]
    want_qmm = QMM_PER_LAYER * layers * (prefills + steps)
    breakdown = profile_breakdown(engine, workload)
    window = breakdown["decode_window"]
    blas_per_step = window["kernels_by_group"].get("matmul", 0) / float(
        window["steps"])
    qmm_ms = window["device_ms_by_group"].get("qmatmul", 0.0)
    qmm_launches = QMM_PER_LAYER * layers * window["steps"]
    step_bytes = layers * sum(_qmm_bytes(QMM_DECODE_M, k, n, torch.bfloat16,
                                         has_bias)
                              for _l, k, n, has_bias, _a in QMM_LAYER)
    step_bound, _by = bound_seconds(step_bytes, 0, "bfloat16")
    info = {
        "phase": "serve_int8", "nvidia_smi": smi,
        "config": dict(CONFIG), "compute_dtype": "bfloat16",
        "quantize": engine.describe()["quantize"],
        "block_weight_dtypes": int8_blocks,
        "calibration_drift": drift, "drift_tol": INT8_TOL,
        "requests": len(workload), "prompt_lengths": lengths.tolist(),
        "new_tokens": SERVE_NEW_TOKENS, "tokens": tokens,
        "elapsed_s": elapsed, "tokens_per_s": tokens / elapsed,
        "ttft_mean_ms": scheduler.ttft.mean * 1e3,
        "decode_steps": steps, "prefills": prefills,
        "decode_step_median_ms": statistics.median(decode_ms),
        "launches": launches, "launches_expected_qmatmul": want_qmm,
        "params_bytes": engine.params_nbytes,
        "bf16_params_bytes": bf16_params_bytes,
        "params_ratio_to_bf16": engine.params_nbytes / bf16_params_bytes,
        "tokens_equal_to_serve": same,
        "tokens_equal_share": same / tokens if tokens else None,
        "decode_window_qmatmul_ms_per_launch": qmm_ms / qmm_launches,
        "decode_step_qmatmul_bound_ms": step_bound * 1e3,
        "decode_window_qmatmul_ms_per_step": qmm_ms / window["steps"],
        "decode_window_cublas_kernels_per_step": blas_per_step,
        "bf16_decode_window_cublas_kernels_per_step": bf16_blas_per_step,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device),
        "quantize_s": quantize_s, "warmup_s": warmup_s,
        "breakdown": breakdown,
    }
    budgets_ok = all(len(r) == SERVE_NEW_TOKENS for r in results)
    counted = (prefills > 0 and steps > 0
               and launches["qmatmul"] == want_qmm)
    no_library = (bf16_blas_per_step - blas_per_step
                  >= QMM_PER_LAYER * layers)
    all_int8 = set(int8_blocks.values()) == {"int8"}
    info["ok"] = budgets_ok and counted and no_library and all_int8
    emit(info)
    engine.close()
    check(budgets_ok, "serve_int8", "a request did not get exactly %d "
          "tokens" % SERVE_NEW_TOKENS)
    check(counted, "serve_int8", "qmatmul launches %d for %d prefills and "
          "%d decode steps (want %d)"
          % (launches["qmatmul"], prefills, steps, want_qmm))
    check(no_library, "serve_int8", "%g cuBLAS kernels a decode step, "
          "against %g for the bf16 twin: a block product went through "
          "the library" % (blas_per_step, bf16_blas_per_step))
    check(all_int8, "serve_int8", "block weights not int8: %s" % int8_blocks)
    return launches


def phase_serve_int8_parity(device):
    """CONFIG cut to 2 layers, f32, TF32 off: one host-quantized tree
    serves on the card (the kernel) and on the CPU (the plain version),
    contiguous and paged with chunked prefill; the streams must be equal
    unless the CPU logits at the first divergence had a top-2 gap below
    1e-3, and ``calibration_logits`` must agree within 1e-3."""
    from veles_tpu_torch import quant
    from veles_tpu_torch.gen import (GenerativeEngine, GenerativeScheduler,
                                     TransformerGenModel, params_from_numpy)
    from veles_tpu_torch.ops import qgemm
    from veles_tpu_torch.samples.transformer import CONFIG

    cfg = dict(CONFIG, layers=2)
    rng = numpy.random.default_rng(SEED + 12)
    workload = [rng.integers(0, cfg["vocab"], int(n)).tolist()
                for n in rng.integers(8, 200, PARITY_REQUESTS)]
    calibration_prompt = rng.integers(0, cfg["vocab"], 256).tolist()
    host = quant.quantize_transformer_params(
        TransformerGenModel(cfg, device="cpu").init_params(SEED))
    modes = {"contiguous": {},
             "paged_chunked": dict(kv="paged", block_size=16,
                                   prefill_chunk=INT8_PARITY_CHUNK)}

    def session(dev, options):
        model = TransformerGenModel(cfg, device=dev)
        engine = GenerativeEngine(model, params_from_numpy(host, dev),
                                  max_slots=4, max_seq=512, device=dev,
                                  **options)
        qgemm.reset_launches()
        scheduler = GenerativeScheduler(engine)
        futures = [scheduler.submit(t, PARITY_NEW_TOKENS) for t in workload]
        scheduler.run_until_idle()
        streams = [f.result(0) for f in futures]
        launched = qgemm.launches["qmatmul"]
        with torch.inference_mode():
            logits = model.calibration_logits(engine._params,
                                              calibration_prompt)
        return model, engine, streams, logits.float().cpu(), launched

    report, ok = {}, True
    for name, options in modes.items():
        _gm, gengine, gpu_streams, gpu_logits, launched = session(device,
                                                                  options)
        gengine.close()
        cmodel, cengine, cpu_streams, cpu_logits, _n = session(
            torch.device("cpu"), options)
        logit_err = float((gpu_logits - cpu_logits).abs().max())
        diverged, ties = _near_tie_agreement(cmodel, cengine, workload,
                                             cpu_streams, gpu_streams)
        cengine.close()
        mode_ok = (logit_err <= PARITY_LOGIT_TOL and diverged == ties
                   and launched > 0
                   and all(len(s) == PARITY_NEW_TOKENS for s in gpu_streams))
        report[name] = {"streams_equal": PARITY_REQUESTS - diverged,
                        "diverged": diverged, "diverged_at_near_tie": ties,
                        "calibration_logits_max_abs_err": logit_err,
                        "qmatmul_launches": launched, "ok": mode_ok}
        ok = ok and mode_ok
    emit({"phase": "serve_int8_parity", "ok": ok, "config": cfg,
          "dtype": "float32", "tf32": False, "quantize": "int8",
          "requests": PARITY_REQUESTS, "new_tokens": PARITY_NEW_TOKENS,
          "tol": PARITY_LOGIT_TOL, "modes": report})
    check(ok, "serve_int8_parity", "card and CPU int8 serving disagree: %s"
          % report)


OPS_SEED = 1234


def phase_ops(device):
    """The ops API on the card: ``matrix_reduce`` of a (4096, 4096) f32
    matrix under ``root.common.engine.pallas_reduce = True`` launches the
    kernel once a call (every op and axis) and agrees with ``_reduce_ref``
    (max / min equal, sums within 1e-6·Σ|a|); with the knob off it
    launches nothing.  ``uniform_pallas(seed, (4096, 4096))`` launches
    once and gives the same bits as the same call on the CPU; another
    seed gives other bits.  The launches of the knob-on calls and the
    two card fills are the path's count."""
    from veles_tpu_torch import ops
    from veles_tpu_torch.ops import random, reduce

    a = _reduce_matrix(numpy.random.default_rng(SEED + 13), device,
                       REDUCE_BIG, torch.float32, False)
    calls = [(op, axis) for op in ("sum", "max", "min") for axis in (0, 1)]
    reset_all_launches()
    with engine_knobs(pallas_reduce=True):
        reduced = [ops.matrix_reduce(a, axis, op) for op, axis in calls]
    fill = random.uniform_pallas(OPS_SEED, UNIFORM_BIG)
    other = random.uniform_pallas(OPS_SEED + 1, UNIFORM_BIG)
    gpu_sync()
    launches = {**reduce.launches, **random.launches}
    agree = {"%s_axis%d" % call: _reduce_agree(
        out, reduce._reduce_ref(a, call[1], call[0]), a, call[0], call[1])
        for call, out in zip(calls, reduced)}
    with engine_knobs(pallas_reduce=False):
        ops.matrix_reduce(a, 0, "sum")
    knob_off_launches = reduce.launches["reduce"] - launches["reduce"]
    cpu = random.uniform_pallas(OPS_SEED, UNIFORM_BIG, device="cpu")
    same_bits = bool(torch.equal(fill.cpu(), cpu))
    other_bits = not bool(torch.equal(fill, other))
    ok = (launches == {"reduce": len(calls), "uniform": 2}
          and knob_off_launches == 0 and same_bits and other_bits
          and all(r["ok"] for r in agree.values()))
    emit({"phase": "ops", "ok": ok, "shape": list(REDUCE_BIG),
          "launches": launches, "knob_off_launches": knob_off_launches,
          "reduce": agree, "uniform_card_equals_cpu": same_bits,
          "uniform_other_seed_differs": other_bits})
    check(ok, "ops", "the ops API did not take its kernels as expected: "
          "launches %s (knob off %d), card == cpu %s, other seed differs "
          "%s, reduce %s" % (launches, knob_off_launches, same_bits,
                              other_bits, {k: v["ok"]
                                           for k, v in agree.items()}))
    return launches


# -- the paged serving paths ------------------------------------------------

PAGED_STEM = 512
PAGED_CHUNK = 256
PAGED_PHRASE = 24
PAGED_PARITY_REQUESTS = 6
PAGED_PARITY_STEM = 64
# pages of the tight pool of serve_paged_parity: one max_seq sequence
# (32 pages of 16) + the trash block, so that the workload preempts
PAGED_PARITY_TIGHT_BLOCKS = 33


def paged_workload(vocab, seed, requests, stem_len, tail_lo, tail_hi,
                   phrase=False):
    """Prompts of one shared seeded stem plus each request's own tail
    (``tail_lo``..``tail_hi`` tokens, evenly spread, shuffled): random
    tokens, or with ``phrase`` a seeded 24-token phrase repeated to
    length, which prompt lookup can match."""
    rng = numpy.random.default_rng(seed)
    stem = rng.integers(0, vocab, stem_len).tolist()
    tails = numpy.linspace(tail_lo, tail_hi, requests).astype(int)
    rng.shuffle(tails)
    prompts = []
    for n in tails:
        if phrase:
            words = rng.integers(0, vocab, PAGED_PHRASE).tolist()
            tail = (words * (int(n) // PAGED_PHRASE + 1))[:int(n)]
        else:
            tail = rng.integers(0, vocab, int(n)).tolist()
        prompts.append(stem + tail)
    return prompts


def _paged_engine(device, cfg, dtype, **options):
    from veles_tpu_torch.gen import GenerativeEngine, TransformerGenModel
    model = TransformerGenModel(cfg, compute_dtype=dtype, device=device)
    return GenerativeEngine(model, max_slots=4, max_seq=2048, seed=SEED,
                            device=device, kv="paged", block_size=16,
                            prefill_chunk=PAGED_CHUNK, prefix_cache="on",
                            **options)


def _serve_paged_session(engine, workload, label):
    """One counted session behind the worker thread: launches (set to 0
    just before, read just after), dispatch counts, span times, the
    peak pages in use (sampled after each admission and decode step) and
    the host time of the speculative proposals."""
    from veles_tpu_torch import trace
    from veles_tpu_torch.config import root
    from veles_tpu_torch.gen import GenerativeScheduler
    from veles_tpu_torch.ops import attention

    peak = [0]
    propose_s = []

    def sampled(fn):
        def run(*args):
            out = fn(*args)
            peak[0] = max(peak[0], engine.blocks_total - engine.blocks_free)
            return out
        return run

    def timed(fn):
        def run(*args):
            tic = time.perf_counter()
            out = fn(*args)
            propose_s.append(time.perf_counter() - tic)
            return out
        return run

    engine.admit = sampled(engine.admit)
    engine.decode_step = sampled(engine.decode_step)
    engine.spec_decode_step = sampled(engine.spec_decode_step)
    engine.propose = timed(engine.propose)
    root.common.engine.trace = "on"
    trace.configure()
    trace.recorder.clear()
    before = {name: getattr(engine, name) for name in (
        "prefill_calls", "decode_calls", "spec_dispatches",
        "preemptions_total", "prefix_shared_pages_total")}
    attention.reset_launches()
    scheduler = GenerativeScheduler(engine, name=label).start()
    try:
        tic = time.perf_counter()
        futures = [scheduler.submit(toks, SERVE_NEW_TOKENS)
                   for toks in workload]
        results = [f.result(timeout=600) for f in futures]
        elapsed = time.perf_counter() - tic
    finally:
        scheduler.stop()
    launches = dict(attention.launches)
    events = trace.recorder.events()
    root.common.engine.trace = "off"
    trace.configure()
    for name in ("admit", "decode_step", "spec_decode_step", "propose"):
        del engine.__dict__[name]
    counts = {name: getattr(engine, name) - value
              for name, value in before.items()}

    def span_ms(name):
        return [ev[4] / 1e6 for ev in events
                if ev[0] == "X" and ev[2] == name]

    tokens = sum(len(r) for r in results)
    steps = counts["decode_calls"]
    return results, {
        "requests": len(workload),
        "prompt_lengths": [len(t) for t in workload],
        "new_tokens": SERVE_NEW_TOKENS, "tokens": tokens,
        "elapsed_s": elapsed, "tokens_per_s": tokens / elapsed,
        "ttft_mean_ms": scheduler.ttft.mean * 1e3,
        "chunks": counts["prefill_calls"], "decode_dispatches": steps,
        "spec_dispatches": counts["spec_dispatches"],
        "preemptions": counts["preemptions_total"],
        "prefix_shared_pages": counts["prefix_shared_pages_total"],
        "prefix_hit_rate": engine.prefix_hit_rate(),
        "peak_pages_in_use": peak[0], "pages_total": engine.blocks_total,
        "kv_cache_bytes": engine.kv_cache_bytes,
        "decode_step_median_ms": (statistics.median(span_ms("decode"))
                                  if span_ms("decode") else None),
        "verify_step_median_ms": (statistics.median(span_ms("spec_verify"))
                                  if span_ms("spec_verify") else None),
        "chunk_span_median_ms": statistics.median(span_ms("prefill_chunk")),
        "propose_ms_per_step": (sum(propose_s) * 1e3 / steps
                                if propose_s and steps else None),
        "batch_fill": scheduler.batch_fill(),
        "launches": launches,
    }


def paged_breakdown(engine, prompts, decode_steps=16):
    """After the counted session: each chunk of four fresh prompts (the
    session's stem, new tails) timed on its own between two
    synchronizations, the host→device bytes and the table upload of a
    decode step, and ``decode_steps`` decode steps over the full batch
    under ``torch.profiler``."""
    from veles_tpu_torch.memory import Watcher
    slots, chunk_ms = [], []
    for prompt in prompts[:engine.max_slots]:
        slot, _tok = engine.admit(prompt)
        slots.append(slot)
        while slot in engine._chunking:
            gpu_sync()
            tic = time.perf_counter()
            engine.prefill_step(slot)
            gpu_sync()
            chunk_ms.append((time.perf_counter() - tic) * 1e3)
    h2d0 = Watcher.transfers()["h2d_bytes"]
    window = profile_window(
        lambda: [engine.decode_step() for _ in range(decode_steps)])
    h2d = (Watcher.transfers()["h2d_bytes"] - h2d0) / decode_steps
    window["steps"] = decode_steps
    tables = engine._pool.tables

    def upload():
        engine._put(tables, torch.int32)
        gpu_sync()
    upload()
    upload_ms = []
    for _ in range(20):
        tic = time.perf_counter()
        upload()
        upload_ms.append((time.perf_counter() - tic) * 1e3)
    for slot in slots:
        engine.release_slot(slot)
    return {"chunks_timed": len(chunk_ms),
            "chunk_median_ms": statistics.median(chunk_ms),
            "h2d_bytes_per_decode_step": h2d,
            "tables_bytes": int(tables.nbytes),
            "tables_upload_median_ms": statistics.median(upload_ms),
            "decode_window": window}


def _check_paged_launches(info, layers, dispatches, phase):
    launches = info["launches"]
    want = {"paged_decode_attn": layers * dispatches,
            "flash_fwd": layers * info["chunks"], "decode_attn": 0}
    info["launches_expected"] = want
    check(dispatches > 0 and info["chunks"] > 0
          and all(launches[k] == v for k, v in want.items()), phase,
          "the kernels were not on the main path as expected: launches "
          "%s, want %s" % (launches, want))


def phase_serve_paged(device, smi):
    from veles_tpu_torch.samples.transformer import CONFIG

    tic = time.perf_counter()
    engine = _paged_engine(device, CONFIG, torch.bfloat16)
    setup_s = time.perf_counter() - tic
    tic = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - tic
    workload = paged_workload(CONFIG["vocab"], SEED + 7, SERVE_REQUESTS,
                              PAGED_STEM, 16, 1000)
    torch.cuda.reset_peak_memory_stats(device)
    results, info = _serve_paged_session(engine, workload, "serve-paged")
    info.update({"phase": "serve_paged", "nvidia_smi": smi,
                 "config": dict(CONFIG), "compute_dtype": "bfloat16",
                 "kv": "paged", "block_size": 16,
                 "prefill_chunk": PAGED_CHUNK, "prefix_cache": "on",
                 "max_memory_allocated":
                 torch.cuda.max_memory_allocated(device),
                 "setup_s": setup_s, "warmup_s": warmup_s})
    fresh = paged_workload(CONFIG["vocab"], SEED + 8, SERVE_REQUESTS,
                           PAGED_STEM, 16, 1000)
    fresh = [workload[0][:PAGED_STEM] + p[PAGED_STEM:]
             for p in sorted(fresh, key=len)[-engine.max_slots:]]
    info["breakdown"] = paged_breakdown(engine, fresh)
    budgets_ok = all(len(r) == SERVE_NEW_TOKENS for r in results)
    in_vocab = all(0 <= t < CONFIG["vocab"] for r in results for t in r)
    info["ok"] = (budgets_ok and in_vocab and info["preemptions"] == 0
                  and info["prefix_shared_pages"] >= 2 * PAGED_CHUNK // 16)
    emit(info)
    engine.close()
    check(budgets_ok, "serve_paged", "a request did not get exactly %d "
          "tokens" % SERVE_NEW_TOKENS)
    check(in_vocab, "serve_paged", "a token lies outside the vocabulary")
    check(info["preemptions"] == 0, "serve_paged", "the default pool "
          "preempted %d times" % info["preemptions"])
    check(info["prefix_shared_pages"] >= 2 * PAGED_CHUNK // 16,
          "serve_paged", "no admission adopted both stem chunks (%d shared "
          "pages)" % info["prefix_shared_pages"])
    _check_paged_launches(info, CONFIG["layers"], info["decode_dispatches"],
                          "serve_paged")
    return info


def phase_serve_spec(device, smi, paged_tokens_per_s):
    from veles_tpu_torch.samples.transformer import CONFIG

    engine = _paged_engine(device, CONFIG, torch.bfloat16,
                           speculative="ngram", draft_k=4).warmup()
    workload = paged_workload(CONFIG["vocab"], SEED + 9, SERVE_REQUESTS,
                              PAGED_STEM, 16, 1000, phrase=True)
    results, info = _serve_paged_session(engine, workload, "serve-spec")
    info.update({"phase": "serve_spec", "nvidia_smi": smi,
                 "config": dict(CONFIG), "compute_dtype": "bfloat16",
                 "kv": "paged", "block_size": 16,
                 "prefill_chunk": PAGED_CHUNK, "prefix_cache": "on",
                 "speculative": "ngram", "draft_k": 4,
                 "spec_accept_rate": engine.spec_accept_rate(),
                 "spec_tokens_per_dispatch":
                 engine.spec_tokens_per_dispatch(),
                 "serve_paged_tokens_per_s": paged_tokens_per_s})
    budgets_ok = all(len(r) == SERVE_NEW_TOKENS for r in results)
    verified = (info["spec_dispatches"] >= 1
                and info["spec_dispatches"] == info["decode_dispatches"])
    info["ok"] = budgets_ok and verified
    emit(info)
    engine.close()
    check(budgets_ok, "serve_spec", "a request did not get exactly %d "
          "tokens" % SERVE_NEW_TOKENS)
    check(verified, "serve_spec", "%d verify dispatches of %d decode "
          "dispatches" % (info["spec_dispatches"],
                          info["decode_dispatches"]))
    _check_paged_launches(info, CONFIG["layers"], info["spec_dispatches"],
                          "serve_spec")
    return info


def _near_tie_agreement(judge, engine, workload, reference, streams):
    """Streams against the reference: equal, or first diverging where the
    judge model's logits after the reference prefix had a top-2 gap
    below TIE_GAP.  Returns (diverged, at_near_tie)."""
    diverged, ties = 0, 0
    for prompt, got, want in zip(workload, streams, reference):
        if got == want:
            continue
        diverged += 1
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        with torch.inference_mode():
            top2 = torch.topk(judge.calibration_logits(
                engine._params, list(prompt) + want[:j]), 2).values
        if float(top2[0] - top2[1]) < TIE_GAP:
            ties += 1
    return diverged, ties


def phase_serve_paged_parity(device):
    """The paged engine's gates on the card, 2-layer CONFIG in f32 with
    TF32 off: the card's contiguous plain streams R; the CPU's agree
    with R under the near-tie rule; the card's paged engine gives R
    exactly (the paged kernel mirrors the contiguous one); chunked with
    the prefix cache, paged and contiguous speculation and a tight pool
    agree with R under the near-tie rule, the card's contiguous model
    the judge; two tight-pool runs give equal streams and preemptions."""
    from veles_tpu_torch.gen import (GenerativeEngine, GenerativeScheduler,
                                     TransformerGenModel, params_from_numpy)
    from veles_tpu_torch.ops import attention
    from veles_tpu_torch.samples.transformer import CONFIG

    cfg = dict(CONFIG, layers=2)
    workload = paged_workload(cfg["vocab"], SEED + 11,
                              PAGED_PARITY_REQUESTS, PAGED_PARITY_STEM, 8,
                              150)
    host_params = TransformerGenModel(cfg, device="cpu").init_params(SEED)

    def session(dev, keep=False, **options):
        model = TransformerGenModel(cfg, device=dev)
        engine = GenerativeEngine(
            model, params_from_numpy(host_params, dev), max_slots=4,
            max_seq=512, device=dev, **options)
        attention.reset_launches()
        scheduler = GenerativeScheduler(engine)
        futures = [scheduler.submit(t, PARITY_NEW_TOKENS) for t in workload]
        scheduler.run_until_idle()
        streams = [f.result(0) for f in futures]
        counts = {"launches": dict(attention.launches),
                  "preemptions": engine.preemptions_total,
                  "prefix_shared_pages": engine.prefix_shared_pages_total,
                  "spec_dispatches": engine.spec_dispatches,
                  "spec_accepted": engine.spec_accepted_total}
        if not keep:
            engine.close()
        return streams, counts, (model, engine)

    reference, ref_counts, (gmodel, gengine) = session(device, keep=True)
    report = {"contiguous": ref_counts}
    cpu_streams, _c, (cmodel, cengine) = session(torch.device("cpu"),
                                                 keep=True)
    cpu = _near_tie_agreement(cmodel, cengine, workload, reference,
                              cpu_streams)
    cengine.close()
    paged, report["paged"], _m = session(device, kv="paged", block_size=16)
    runs = {
        "chunked_prefix": dict(kv="paged", block_size=16, prefill_chunk=64,
                               prefix_cache="on"),
        "paged_ngram": dict(kv="paged", block_size=16, speculative="ngram",
                            draft_k=4),
        "contiguous_ngram": dict(speculative="ngram", draft_k=4),
        "tight_pool": dict(kv="paged", block_size=16, prefill_chunk=64,
                           num_blocks=PAGED_PARITY_TIGHT_BLOCKS),
    }
    agreement = {}
    streams = {}
    for name, options in runs.items():
        streams[name], report[name], _m = session(device, **options)
        agreement[name] = _near_tie_agreement(
            gmodel, gengine, workload, reference, streams[name])
    again, again_counts, _m = session(device, **runs["tight_pool"])
    gengine.close()
    repeat_ok = (again == streams["tight_pool"]
                 and again_counts["preemptions"]
                 == report["tight_pool"]["preemptions"])
    ok = (cpu[0] == cpu[1] and paged == reference
          and all(d == t for d, t in agreement.values())
          and report["chunked_prefix"]["prefix_shared_pages"] >= 1
          and report["paged_ngram"]["spec_dispatches"] >= 1
          and report["contiguous_ngram"]["launches"]["decode_attn"] > 0
          and report["tight_pool"]["preemptions"] >= 1 and repeat_ok
          and all(len(s) == PARITY_NEW_TOKENS for s in reference))
    emit({"phase": "serve_paged_parity", "ok": ok, "config": cfg,
          "dtype": "float32", "tf32": False, "max_seq": 512,
          "prompt_lengths": [len(t) for t in workload],
          "new_tokens": PARITY_NEW_TOKENS,
          "cpu_contiguous": {"diverged": cpu[0], "at_near_tie": cpu[1]},
          "paged_equals_contiguous_exactly": paged == reference,
          "runs": {name: {"diverged": d, "at_near_tie": t,
                          "counts": report[name]}
                   for name, (d, t) in agreement.items()},
          "tight_pool_repeat_equal": repeat_ok,
          "counts": {k: report[k] for k in ("contiguous", "paged")}})
    check(ok, "serve_paged_parity", "the paged engine's gates failed on "
          "the card (cpu %s, paged exact %s, runs %s, repeat %s)"
          % (cpu, paged == reference, agreement, repeat_ok))


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
            "flash_bwd_dkv": cfg["layers"], "decode_attn": 0,
            "paged_decode_attn": 0}

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
    }
    info["breakdown"] = profile_window(
        lambda: step(params, velocity, tokens),
        names_of=("flash_bwd_dq", "flash_bwd_dkv"))
    # every backward kernel of the profiled step is the tensor-core body
    want_bodies = {"tensor_core": 2 * cfg["layers"], "fma": 0}
    bodies = _bwd_bodies(info["breakdown"]["kernel_names"])
    on_tensor_cores = bodies == want_bodies
    info.update(bwd_bodies=bodies, bwd_bodies_expected=want_bodies,
                ok=finite and counted and on_tensor_cores)
    emit(info)
    check(finite, "train", "a loss is not finite: %s" % losses)
    check(counted, "train", "the kernels were not on the main path as "
          "expected: %s per step, want %s" % (per_step, want))
    check(on_tensor_cores, "train", "a profiled step's backward kernels "
          "were not all the tensor-core body: %s, want %s"
          % (bodies, want_bodies))
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


def _record_closes(wf, out):
    """Wrap the Decision's class close: (epoch, class, n_err, samples,
    confusion matrix so far) at every close."""
    dec, ev = wf.decision, wf.evaluator
    close = dec._close_class

    def recording(cls, check_epoch_end):
        ev.confusion_matrix.map_read()
        out.append({"epoch": int(dec.epoch_number), "cls": cls,
                    "n_err": float(dec.epoch_n_err[cls]),
                    "samples": int(dec.epoch_samples[cls]),
                    "confusion": numpy.array(ev.confusion_matrix.mem)})
        return close(cls, check_epoch_end)
    dec._close_class = recording


@contextlib.contextmanager
def engine_knobs(**knobs):
    """Set ``root.common.engine`` knobs of the port, restored after."""
    from veles_tpu_torch.config import root
    eng = root.common.engine
    saved = {key: eng.get(key) for key in knobs}
    for key, value in knobs.items():
        setattr(eng, key, value)
    try:
        yield eng
    finally:
        for key, value in saved.items():
            setattr(eng, key, value)


def reset_all_launches():
    from veles_tpu_torch.ops import (attention, gather, gemm, qgemm, random,
                                     reduce)
    for module in (attention, gather, gemm, qgemm, random, reduce):
        module.reset_launches()


def mnist_launches():
    from veles_tpu_torch.ops import gather, gemm
    return {**gemm.launches, **gather.launches}


def phase_mnist(device, smi):
    """The MNIST MLP's training through the eager workflow at full width
    (784→100→10, minibatch 100) on the synthetic stand-in: launch counts,
    rates, per-minibatch transfers, then one epoch under the profiler."""
    with engine_knobs(stitch="off"):
        return _phase_mnist(device, smi)


def _phase_mnist(device, smi):
    from veles_tpu_torch import prng
    from veles_tpu_torch.memory import Watcher
    from veles_tpu_torch.samples import mnist

    prng.seed_all(SEED)
    tic = time.perf_counter()
    wf = mnist.create_workflow(device=device, max_epochs=MNIST_EPOCHS)
    gpu_sync()
    setup_s = time.perf_counter() - tic
    starts = []
    loader_run = wf.loader.run

    def timed_run():
        tic_, moved = time.perf_counter(), Watcher.transfers()
        loader_run()
        starts.append((tic_, moved, int(wf.loader.minibatch_class)))
    wf.loader.run = timed_run

    torch.cuda.reset_peak_memory_stats(device)
    in_use = torch.cuda.memory_allocated(device)
    before = Watcher.transfers()
    reset_all_launches()
    tic = time.perf_counter()
    wf.run()
    gpu_sync()
    end = time.perf_counter()
    launches = mnist_launches()
    after = Watcher.transfers()
    elapsed = end - tic
    peak = torch.cuda.max_memory_allocated(device)
    closes = wf.decision.history

    served = wf.loader.samples_served
    bounds = [t for t, _x, _c in starts] + [end]
    train_ms = [(bounds[i + 1] - bounds[i]) * 1e3
                for i, (_t, _x, cls) in enumerate(starts) if cls == 2]
    h2d_steps = [starts[i + 1][1]["h2d_bytes"] - starts[i][1]["h2d_bytes"]
                 for i in range(len(starts) - 1)]
    errors = [c["n_err"] for c in closes]
    valid = [c["n_err_pt"] for c in closes if c["cls"] == "validation"]
    finite = all(numpy.isfinite(e) for e in errors)
    learned = len(valid) == MNIST_EPOCHS and valid[-1] < valid[0]
    counted = launches == MNIST_LAUNCHES
    info = {
        "phase": "mnist", "nvidia_smi": smi,
        "layers": "784-100 all2all_tanh, 100-10 softmax", "minibatch": 100,
        "max_epochs": MNIST_EPOCHS, "data": "synthetic stand-in, seed 1234",
        "stitch": "off", "seed": SEED, "setup_s": setup_s,
        "elapsed_s": elapsed,
        "minibatches": len(starts), "samples": served,
        "epochs_per_s": served / wf.loader.total_samples / elapsed,
        "samples_per_s": served / elapsed,
        "train_minibatch_median_ms": statistics.median(train_ms),
        "h2d_bytes": after["h2d_bytes"] - before["h2d_bytes"],
        "h2d_bytes_per_minibatch_median": statistics.median(h2d_steps),
        "h2d_bytes_per_minibatch_mean":
            (after["h2d_bytes"] - before["h2d_bytes"]) / len(starts),
        "d2h_transfers": after["d2h_transfers"] - before["d2h_transfers"],
        "max_memory_allocated": peak,
        "max_memory_above_start": peak - in_use,
        "hbm_ledger": Watcher.hbm_ledger(),
        "class_closes": closes,
        "results": wf.gather_results(),
        "launches": launches, "launches_expected": MNIST_LAUNCHES,
        "ok": finite and learned and counted,
    }
    profiled = mnist.create_workflow(device=device, max_epochs=2)
    reset_all_launches()
    info["breakdown"] = profile_window(profiled.run)
    info["breakdown"]["window"] = ("one epoch: 2 validation passes and 1 "
                                   "train pass (max_epochs=2)")
    # device time of one launch on the main path, from the profile
    by_group = info["breakdown"]["device_ms_by_group"]
    info["breakdown"]["device_us_per_launch"] = {
        name: by_group.get(_PROFILE_GROUP.get(name, "veles_" + name),
                           0.0) * 1e3 / count
        for name, count in mnist_launches().items() if count}
    emit(info)
    check(finite, "mnist", "an n_err is not finite: %s" % errors)
    check(learned, "mnist", "validation error did not fall: %s" % valid)
    check(counted, "mnist", "the kernels were not on the main path as "
          "expected: %s, want %s" % (launches, MNIST_LAUNCHES))
    return launches


def phase_mnist_parity(device):
    """The same seed on the card (kernels) and on the CPU (plain
    versions), one train pass of the eager chain: per-epoch per-class
    n_err and confusion matrices equal, parameters and momenta leaf by
    leaf within max |card − cpu| <= 1e-4 · max |cpu|; a card run with
    gd_dx planted to return zeros must fail that check."""
    with engine_knobs(stitch="off"):
        _phase_mnist_parity(device)


def _phase_mnist_parity(device):
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import gemm
    from veles_tpu_torch.samples import mnist

    def run(dev):
        prng.seed_all(SEED)
        wf = mnist.create_workflow(device=dev, max_epochs=MNIST_PARITY_EPOCHS)
        closes = []
        _record_closes(wf, closes)
        wf.run()
        return closes, wf.params_to_numpy()

    def param_errors(got):
        return {name: float(numpy.abs(got[name] - ref).max()
                            / max(float(numpy.abs(ref).max()), 1e-30))
                for name, ref in cpu_params.items()}

    reset_all_launches()
    gpu_closes, gpu_params = run(device)
    launches = mnist_launches()
    cpu_closes, cpu_params = run(torch.device("cpu"))

    dx = gemm._gd_dx_cuda

    def zero_dx(*args, **kwargs):
        return torch.zeros_like(dx(*args, **kwargs))

    gemm._gd_dx_cuda = zero_dx
    try:
        _c, planted_params = run(device)
    finally:
        gemm._gd_dx_cuda = dx
    planted = max(param_errors(planted_params).values())

    counts_equal = ([(c["epoch"], c["cls"], c["n_err"], c["samples"])
                     for c in gpu_closes]
                    == [(c["epoch"], c["cls"], c["n_err"], c["samples"])
                        for c in cpu_closes])
    confusion_equal = len(gpu_closes) == len(cpu_closes) and all(
        numpy.array_equal(g["confusion"], c["confusion"])
        for g, c in zip(gpu_closes, cpu_closes))
    errs = param_errors(gpu_params)
    worst = max(errs, key=errs.get)
    ok = (counts_equal and confusion_equal
          and errs[worst] <= MNIST_PARAM_RTOL
          and planted > MNIST_PARAM_RTOL
          and all(launches[k] > 0 for k, n in MNIST_LAUNCHES.items() if n))
    emit({"phase": "mnist_parity", "ok": ok,
          "max_epochs": MNIST_PARITY_EPOCHS, "dtype": "float32",
          "tf32": False,
          "gpu_n_err": [c["n_err"] for c in gpu_closes],
          "cpu_n_err": [c["n_err"] for c in cpu_closes],
          "n_err_equal": counts_equal, "confusion_equal": confusion_equal,
          "param_rel_err_by_leaf": errs, "param_worst_leaf": [worst,
                                                              errs[worst]],
          "param_rtol": MNIST_PARAM_RTOL,
          "planted_zero_dx_param_rel_err": planted,
          "planted_zero_dx_caught": planted > MNIST_PARAM_RTOL,
          "gpu_launches": launches})
    check(ok, "mnist_parity", "card and CPU training disagree, or the "
          "planted zero dx went unseen (n_err equal %s, confusion equal "
          "%s, params %s %.3g, planted %.3g, launches %s)"
          % (counts_equal, confusion_equal, worst, errs[worst], planted,
             launches))


# -- the stitched route -----------------------------------------------------

def _mnist_stitched_profile(device):
    """One steady-state epoch of the stitched native route under
    ``torch.profiler``: a ``max_epochs=3`` run whose profile window
    opens at epoch 1's first dispatch (both graphs captured in epoch 0)
    and closes at epoch 2's, so it holds one validation pass and one
    train pass, 70 minibatches."""
    from torch.profiler import ProfilerActivity, profile

    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import mnist
    prng.seed_all(SEED)
    wf = mnist.create_workflow(device=device, max_epochs=MNIST_EPOCHS,
                               native=True)
    head = wf.stitch_segments[0].stages[0]
    prelude, loader = head.prelude, wf.loader
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def watched():
        # an epoch starts in the prelude that wraps the offset
        at = (loader.epoch_number,
              loader.global_offset >= loader.total_samples)
        if "tic" not in window and at == (0, True):
            gpu_sync()
            prof.start()
            window["tic"] = time.perf_counter()
            window["minibatches"] = 0
        elif "tic" in window and "toc" not in window and at == (1, True):
            gpu_sync()
            window["toc"] = time.perf_counter()
            prof.stop()
        if "tic" in window and "toc" not in window:
            window["minibatches"] += 1
        prelude()
    head.prelude = watched
    wf.run()
    gpu_sync()
    if "toc" not in window:
        prof.stop()
        window["toc"] = time.perf_counter()
    summary = _profile_summary(prof, (window["toc"] - window["tic"]) * 1e6)
    summary["window"] = ("one steady-state epoch: epoch 1's validation "
                         "and train passes (%d minibatches)"
                         % window["minibatches"])
    summary["minibatches"] = window["minibatches"]
    summary["kernels_per_minibatch"] = (summary["device_kernels"]
                                        / window["minibatches"])
    return summary


def phase_mnist_stitched(device, smi):
    """The stitched native route at full width (784→100→10, minibatch
    100, u8 dataset scaled in the loader head): each minibatch is one
    forward-segment graph replay and, on train minibatches, one GD
    replay.  Exact dispatch, capture and launch counts, the per-minibatch
    host→device bytes (the scalar blocks), rates, resident bytes, then
    one steady-state epoch under the profiler."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.memory import Watcher
    from veles_tpu_torch.samples import mnist

    with engine_knobs(stitch="on", loader="auto", epoch_scan="off"):
        prng.seed_all(SEED)
        Watcher.reset()
        tic = time.perf_counter()
        wf = mnist.create_workflow(device=device, max_epochs=MNIST_EPOCHS,
                                   native=True)
        gpu_sync()
        setup_s = time.perf_counter() - tic
        resident = Watcher.hbm_ledger()
        head = wf.stitch_segments[0].stages[0]
        prelude, loader, starts = head.prelude, wf.loader, []

        def timed_prelude():
            starts.append((time.perf_counter(), Watcher.transfers()))
            prelude()
            starts[-1] += (int(loader.minibatch_class),)
        head.prelude = timed_prelude

        torch.cuda.reset_peak_memory_stats(device)
        in_use = torch.cuda.memory_allocated(device)
        before = Watcher.transfers()
        reset_all_launches()
        tic = time.perf_counter()
        wf.run()
        gpu_sync()
        end = time.perf_counter()
        launches = mnist_launches()
        after = Watcher.transfers()
        elapsed = end - tic
        peak = torch.cuda.max_memory_allocated(device)
        report = wf.stitch_report()
        closes = wf.decision.history

        served = loader.samples_served
        bounds = [t for t, _x, _c in starts] + [end]
        train_ms = [(bounds[i + 1] - bounds[i]) * 1e3
                    for i, (_t, _x, cls) in enumerate(starts) if cls == 2]
        # after both captures: the GD segment captures at the second
        # train minibatch, so time from the dispatch after it
        steady = [i for i, (_t, _x, cls) in enumerate(starts)
                  if cls == 2][1] + 1
        steady_s = end - starts[steady][0]
        moved = [x for _t, x, _c in starts] + [after]
        h2d_steps = [b["h2d_bytes"] - a["h2d_bytes"]
                     for a, b in zip(moved, moved[1:])]
        errors = [c["n_err"] for c in closes]
        valid = [c["n_err_pt"] for c in closes if c["cls"] == "validation"]
        finite = all(numpy.isfinite(e) for e in errors)
        learned = len(valid) == MNIST_EPOCHS and valid[-1] < valid[0]
        counted = launches == MNIST_STITCHED_LAUNCHES
        dispatched = ([r["dispatches"] for r in report]
                      == MNIST_STITCHED_DISPATCHES
                      and [r["captures"] for r in report] == [1, 1]
                      and all(r["recaptures"] == 0 for r in report))
        h2d_ok = statistics.median(h2d_steps) <= MNIST_STITCHED_H2D_MAX
        d2h = after["d2h_transfers"] - before["d2h_transfers"]
        d2h_ok = d2h == len(closes)
        info = {
            "phase": "mnist_stitched", "nvidia_smi": smi,
            "layers": "784-100 all2all_tanh, 100-10 softmax",
            "minibatch": 100, "max_epochs": MNIST_EPOCHS,
            "data": "synthetic stand-in as u8 (load_mnist(raw=True)), "
                    "scale 1/255 in the loader head",
            "stitch": "on", "native": True, "seed": SEED,
            "setup_s": setup_s, "elapsed_s": elapsed,
            "minibatches": len(starts), "samples": served,
            "epochs_per_s": served / loader.total_samples / elapsed,
            "samples_per_s": served / elapsed,
            "epochs_per_s_after_captures": (len(starts) - steady)
            * loader.max_minibatch_size / loader.total_samples / steady_s,
            "train_minibatch_median_ms": statistics.median(train_ms),
            "segments": report,
            "h2d_bytes": after["h2d_bytes"] - before["h2d_bytes"],
            "h2d_bytes_per_minibatch_median":
                statistics.median(h2d_steps),
            "h2d_bytes_per_minibatch_max_steady": max(
                h2d_steps[2:10] + h2d_steps[11:]),
            "h2d_inplace_bytes": after["h2d_inplace_bytes"]
            - before["h2d_inplace_bytes"],
            "h2d_inplace_transfers": after["h2d_inplace_transfers"]
            - before["h2d_inplace_transfers"],
            "d2h_transfers": d2h, "class_closes_count": len(closes),
            "resident_at_setup": resident,
            "resident_after_run": Watcher.hbm_ledger(),
            "max_memory_allocated": peak,
            "max_memory_above_start": peak - in_use,
            "class_closes": closes, "results": wf.gather_results(),
            "launches": launches,
            "launches_expected": MNIST_STITCHED_LAUNCHES,
            "ok": (finite and learned and counted and dispatched and h2d_ok
                   and d2h_ok),
        }
        reset_all_launches()
        info["breakdown"] = _mnist_stitched_profile(device)
        by_group = info["breakdown"]["device_ms_by_group"]
        n = info["breakdown"]["minibatches"]
        info["breakdown"]["device_us_per_minibatch_by_group"] = {
            g: t * 1e3 / n for g, t in by_group.items()}
    emit(info)
    check(finite, "mnist_stitched", "an n_err is not finite: %s" % errors)
    check(learned, "mnist_stitched", "validation error did not fall: %s"
          % valid)
    check(counted, "mnist_stitched", "the kernels were not on the main "
          "path as expected: %s, want %s"
          % (launches, MNIST_STITCHED_LAUNCHES))
    check(dispatched, "mnist_stitched", "segments dispatched, captured or "
          "recaptured other than expected: %s" % report)
    check(h2d_ok, "mnist_stitched", "host->device bytes per minibatch: "
          "median %s > %d" % (statistics.median(h2d_steps),
                              MNIST_STITCHED_H2D_MAX))
    check(d2h_ok, "mnist_stitched", "%d device->host copies for %d class "
          "closes" % (d2h, len(closes)))
    return launches


def _close_record(closes):
    return [(c["epoch"], c["cls"], c["n_err"], c["samples"])
            for c in closes]


def _agreement(a, b):
    """Two runs' ``(closes, params)``: counts and confusion matrices
    equal, and each parameter leaf's max |a − b| / max |b|."""
    (ca, pa), (cb, pb) = a, b
    counts = _close_record(ca) == _close_record(cb)
    confusion = len(ca) == len(cb) and all(
        numpy.array_equal(x["confusion"], y["confusion"])
        for x, y in zip(ca, cb))
    errs = {name: float(numpy.abs(pa[name] - ref).max()
                        / max(float(numpy.abs(ref).max()), 1e-30))
            for name, ref in pb.items()}
    worst = max(errs.values())
    return {"n_err_equal": counts, "confusion_equal": confusion,
            "param_worst_rel_err": worst,
            "n_err": [c["n_err"] for c in ca],
            "ok": counts and confusion and worst <= MNIST_PARAM_RTOL}


def phase_mnist_stitched_parity(device):
    """The stitched route on the card held against: the CPU's stitched
    run from the same seed (native, one train pass); the card's eager
    run (native=False, stitch on against off); a minibatch-96 run (every
    class ends in a short batch); and a run whose GD learning rates are
    halved at epoch 1's validation close (max_epochs=3), card and CPU
    alike.  Each within: n_err and confusion equal, every parameter and
    momentum within 1e-4 · max |cpu|.  A card run whose loader scalar
    block is written once and never again (the prelude's write skipped:
    a stale offset) must fail that check."""
    from veles_tpu_torch import prng, stitch
    from veles_tpu_torch.samples import mnist

    def run(dev, native=True, stitch_mode="on", minibatch=100,
            epochs=MNIST_PARITY_EPOCHS, halve_lr=False):
        with engine_knobs(stitch=stitch_mode, loader="auto"):
            prng.seed_all(SEED)
            wf = mnist.create_workflow(device=dev, max_epochs=epochs,
                                       minibatch_size=minibatch,
                                       native=native)
            closes = []
            _record_closes(wf, closes)
            if halve_lr:
                dec = wf.decision
                close = dec._close_class

                def closing(cls, check_epoch_end):
                    if int(dec.epoch_number) == 1 and cls == 1:
                        for unit in wf.gds:
                            unit.learning_rate *= 0.5
                            unit.learning_rate_bias *= 0.5
                    return close(cls, check_epoch_end)
                dec._close_class = closing
            wf.run()
            gpu_sync()
            report = wf.stitch_report()
            return (closes, wf.params_to_numpy()), report

    cpu = torch.device("cpu")
    results = {}
    card, card_report = run(device)
    results["card_vs_cpu"] = _agreement(card, run(cpu)[0])
    on, _r = run(device, native=False)
    off, _r = run(device, native=False, stitch_mode="off")
    results["stitch_on_vs_off_card_f32"] = _agreement(on, off)
    short, short_report = run(device, minibatch=96)
    results["minibatch_96_card_vs_cpu"] = _agreement(
        short, run(cpu, minibatch=96)[0])
    halved, _r = run(device, epochs=MNIST_EPOCHS, halve_lr=True)
    results["lr_halved_card_vs_cpu"] = _agreement(
        halved, run(cpu, epochs=MNIST_EPOCHS, halve_lr=True)[0])
    unchanged, _r = run(device, epochs=MNIST_EPOCHS)
    lr_moved = _agreement(halved, unchanged)["param_worst_rel_err"]

    write = stitch.ScalarBlock.write
    written = set()

    def stale(self, values):
        if self.dtype == torch.int32 and id(self) in written:
            return
        written.add(id(self))
        write(self, values)
    stitch.ScalarBlock.write = stale
    try:
        planted, _r = run(device)
    finally:
        stitch.ScalarBlock.write = write
    planted_check = _agreement(planted, run(cpu)[0])
    recaptures = sum(r["recaptures"] for r in card_report + short_report)
    ok = (all(r["ok"] for r in results.values())
          and lr_moved > MNIST_PARAM_RTOL and not planted_check["ok"]
          and recaptures == 0)
    emit({"phase": "mnist_stitched_parity", "ok": ok, "dtype": "float32",
          "tf32": False, "param_rtol": MNIST_PARAM_RTOL,
          "comparisons": results, "card_segments": card_report,
          "minibatch_96_segments": short_report,
          "lr_halved_vs_unchanged_param_rel_err": lr_moved,
          "planted_stale_offset": planted_check,
          "planted_stale_offset_caught": not planted_check["ok"]})
    check(ok, "mnist_stitched_parity", "the stitched card run disagrees, "
          "the LR change did not move the parameters, a recapture "
          "happened, or the planted stale offset went unseen: %s, "
          "lr moved %.3g, planted %s, recaptures %d"
          % ({k: v["ok"] for k, v in results.items()}, lr_moved,
             planted_check, recaptures))


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
    from veles_tpu_torch.config import root
    # every phase runs full f32 in cuBLAS (TF32 off), as the parity
    # gates' tolerances assume
    root.common.engine.precision_level = 2
    set_precision()
    device = torch.device("cuda", 0)
    try:
        info = phase_device()
        phase_build()
        timed = phase_kernels(device)
        serve_launches, serve_streams, serve_bytes, serve_blas = \
            phase_serve(device, info["nvidia_smi"])
        paths = {"serve": serve_launches}
        phase_parity(device)
        paths["serve_int8"] = phase_serve_int8(
            device, info["nvidia_smi"], serve_streams, serve_bytes,
            serve_blas)
        phase_serve_int8_parity(device)
        paged = phase_serve_paged(device, info["nvidia_smi"])
        paths["serve_paged"] = paged["launches"]
        paths["serve_spec"] = phase_serve_spec(
            device, info["nvidia_smi"], paged["tokens_per_s"])["launches"]
        phase_serve_paged_parity(device)
        paths["train"] = phase_train(device, info["nvidia_smi"])
        phase_train_parity(device)
        paths["mnist"] = phase_mnist(device, info["nvidia_smi"])
        phase_mnist_parity(device)
        paths["mnist_stitched"] = phase_mnist_stitched(
            device, info["nvidia_smi"])
        phase_mnist_stitched_parity(device)
        paths["ops"] = phase_ops(device)
    except PhaseFailed as exc:
        print("chip_smoke FAILED in phase %s" % exc, file=sys.stderr)
        return 1
    for entry in timed:
        entry["launches_by_path"] = {path: counts[entry["name"]]
                                     for path, counts in paths.items()
                                     if counts.get(entry["name"])}
        entry["launches"] = sum(entry["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    # the GEMM kernels also carry wrapper_ms, the time of one wrapper
    # call; the paged kernel the contiguous kernel's time on the mirrored
    # cache and its verify (5 rows) times; the backward pair its body,
    # rate, share of its bound and device time per call
    extra = ("wrapper_ms", "contiguous_ms", "verify_ms",
             "verify_contiguous_ms", "verify_plain_ms", "verify_bound_ms",
             "body", "tflops", "bound_share", "device_ms")
    emit({"kernels": [{key: entry[key] for key in keys + extra
                       if key in keys or key in entry}
                      for entry in timed]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
