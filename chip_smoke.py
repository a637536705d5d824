#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port (``veles_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. ``device``  — the card's name and power limit (``nvidia-smi``).
2. ``build``   — compile every kernel of ``veles_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all at once) and load them, and,
   in the same parallel batch, thirteen builds with a fault planted
   (``-DVELES_PLANTED_FAULT``: decode attention's last rank dropped, or
   its acc not rescaled; qmatmul's decode body's last rank's K chunk
   dropped, or its scale applied twice; reduce's last rank dropped from
   axis 0's merge, or its NaN flag ignored; uniform's second word of a
   counter written over its first, or every counter one block off; the
   dw launch's bias merge without the last rank's sums, or its update
   applied by two ranks; the group gather's second table taken at index
   + 1, or a raw table's pad rows left unwritten, or the served launch
   serving row ``size``, one past a short tail, as valid).
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
   timings); the flash rows also give the body that ran, read from the
   kernels' names in a profile (it must be the tensor-core body; a
   window that saw none of the kernels it reads is taken again, at most
   3 windows, as the qmatmul window below),
   TFLOP/s and the share of the bound at that time, and the device time
   per call (``device_ms``, as the GEMM rows below).  The forward is
   timed at (1, 2048, 16, 64) and at the train step's (8, 2048, 16, 64),
   SDPA on both measures beside it, and two faults planted in its inputs
   (V's row 64 zeroed, q_offset off by one) must each be reported.  The
   decode kernel, whose (batch, head) rows split their keys over a
   cluster of up to 8 blocks, is held against ``_decode_ref`` /
   ``_verify_ref`` at the serving shape (4 x 16 heads of 64, a 2048-row
   cache, lengths 1, 17, 1000, 2048) under every split (1, 2, 4, 8), f32
   and bf16, decode and 5-row verify, each relaunch bit-equal; the two
   planted builds of its merge must each be reported in f32; it is timed
   (bf16) as one wrapper call's event time with L2 flushed and as device
   time a call on cold operands (``cold_device_ms``: 12 copies of the
   cache cycled, so no call finds its 12.6 MB in L2), SDPA with the
   length mask on both measures, with its split, its share of the bound
   and its body read from the profiled names (``decode_kernel_split``).
4. ``serve``   — the main path at full width: ``GenerativeEngine`` over
   ``TransformerGenModel(CONFIG)`` in bfloat16 (4 slots, max_seq 2048)
   behind a ``GenerativeScheduler`` worker thread, 8 seeded requests of
   16..1500 prompt tokens and 64 new tokens each.  Every request must
   return exactly its budget, and both kernels' launch counts (set to 0
   just before the session, read just after) must show 12 launches per
   prefill and per decode step.  After the counted session, two
   windows under ``torch.profiler`` (filling the 4 slots with prefills,
   then 16 decode steps, taken again, at most 6 windows, while it
   counted the library or qmatmul kernels of only part of its steps)
   give the device time by kernel group and the device's busy share of
   the wall time; every decode-attention kernel the decode window names
   is the split body.
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
   a decode step (4 a layer); every block weight int8; in a profiled
   prefill window of 4 prompts, every block product of a bucket above
   16 rows runs the tensor-core body (``qmatmul_kernel_tc``), of a
   16-row bucket the decode body, the window's qmatmul device time
   printed.  A 16-step decode window under ``torch.profiler`` must name
   the decode body (``qmatmul_kernel_dec``) and no other, must hold at
   least 48 cuBLAS kernels a step fewer than ``serve``'s bf16 window,
   where each of the 48 block products launches at least one (so none
   went through the library here), and gives qmatmul's device time a
   launch against its bound by bytes.  Params bytes and their ratio to the
   bf16 twin's, tokens/s, TTFT, the median decode step and the share of
   tokens equal to ``serve``'s streams are printed.
7. ``serve_int8_parity`` — CONFIG cut to 2 layers, f32, TF32 off: one
   host-quantized tree serves on the card (the kernel) and on the CPU
   (the plain version), contiguous and paged with a 64-token prefill
   chunk; the streams must be equal, unless the CPU logits at the first
   divergence had a top-2 gap below 1e-3, and ``calibration_logits``
   must agree within 1e-3.
8. ``serve_generate`` — generative serving through the front door:
   ``serve``'s warmed engine deployed with
   ``ModelRegistry.deploy_generative("lm", ...)`` at the default V-S01
   preflight (``warn``; the report printed, no error allowed) behind
   ``ServingServer`` on 127.0.0.1.  ``serve``'s 8 prompts from 8 client
   threads, 4 of them ``"stream": true`` (chunked ndjson), traced: every
   reply's tokens equal ``serve``'s stream for its prompt bit for bit,
   each stream's events are indices 0..63 whose tokens are its final
   document's, every ``traceparent`` is echoed, the launches (set to 0
   just before, read just after) are exactly 12 ``flash_fwd`` a
   prefill and 12 ``decode_attn`` a decode step, and ``/metrics`` shows
   the JAX scheduler's ``gen_*`` gauges for ``model="lm"`` with
   ``gen_tokens_total`` 512 and ``gen_ttft_seconds_count`` 8.  The same
   traffic in a profiled window gives the busy share.  A drain swap to a
   seed + 1 engine under 4 streams: each stream finishes its 64 tokens
   as ``serve``'s, a new request is answered as version 2, and
   ``torch.cuda.memory_allocated`` falls by at least v1's KV bytes.  The
   int8 deploy (``deploy_generative("lm8", ..., quantize="int8")``):
   the 8 prompts give ``serve_int8``'s streams, exactly 48 qmatmul
   launches a prefill and a decode step (counted from 0 after the
   deploy's warmup: the ``serve_generate_int8`` path), and a profiled
   window names both the tensor-core and the decode body.  Requests/s,
   tokens/s and TTFT p50/p99 of the counted session's 8 requests over
   HTTP beside ``serve``'s direct tokens/s, the streamed share's
   tokens/s beside the whole replies', and each streamed request's
   first event are printed.
9. ``serve_paged`` — the paged path at full width: the same model and
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
10. ``serve_spec`` — as ``serve_paged`` with ``speculative="ngram"``,
   ``draft_k=4`` and tails that repeat a seeded 24-token phrase: exact
   budgets, every decode dispatch a verify, 12 ``paged_decode_attn``
   launches a verify; accept rate, tokens a dispatch, verify step,
   host time in ``propose``.
11. ``serve_paged_parity`` — CONFIG cut to 2 layers, f32, TF32 off,
   max_seq 512: 6 requests (a 64-token stem plus 8..150-token tails) x
   16 tokens.  R, the card's contiguous streams: the CPU's agree with R
   under the near-tie rule of ``parity``; the card's paged engine gives
   R exactly; chunked (64) with the prefix cache, paged and contiguous
   n-gram speculation, and a 33-page pool that preempts agree with R
   under the near-tie rule (the card's contiguous model the judge); two
   tight-pool runs give equal streams and preemption counts.
12. ``train``   — the training path at full width: ``build_train(CONFIG)``
   (bf16 compute, remat, ce_chunk 128, SGD with momentum) on
   ``synthetic_tokens(CONFIG, 8)``, one warm-up step and 5 timed ones.
   Every loss must be finite and every step must launch the forward
   kernel 24 times (forward and remat recompute) and each backward
   kernel 12 times (counts set to 0 just before the steps, read just
   after each).  Then one step under ``torch.profiler`` gives the device
   time by kernel group and the busy share, and its 24 forward and 12 +
   12 backward kernels must all be the tensor-core bodies
   (``*_kernel_tc``); a window that counted other numbers is taken
   again, at most PROFILE_TRIES windows.
13. ``train_parity`` — CONFIG width cut to 2 layers and seq_len 256,
   batch 2, float32 with TF32 off: 2 steps from the same numpy params
   on the card (kernels) and on the CPU (plain versions); the losses
   must agree within relative 1e-6, the params after 2 steps within
   max abs 1e-5, and the velocity (``-lr`` times a running gradient
   sum) leaf by leaf within max |card - cpu| <= 1e-4 · max |cpu|.  A
   third run on the card with its dq zeroed must fail that velocity
   check.
14. ``mnist``   — the MNIST MLP (784→100 tanh, 100→10 softmax, lr 0.03,
   momentum 0.9, decay 0.0005, f32) trained through the eager workflow
   (``samples.mnist.create_workflow(max_epochs=3)`` with
   ``engine.stitch=off``, minibatch 100) on the synthetic stand-in: the
   kernel counts (set to 0 just before ``run()``, read just after) must
   be exactly 300 matmul, 120 gd_dx, 240 gd_dw (each carrying the bias
   step: ``gemm.bias_in_dw`` 240, gd_db 0) and 150 gather serving 300
   tables (the fill's data and label rows in one launch), of which
   exactly 300 matmul and 240 gd_dw launches split K over a cluster
   (``gemm.split_launches``); every n_err finite and the last validation
   error below the first.  Epochs/s, samples/s, the median train
   minibatch wall time, host→device bytes per minibatch and peak memory;
   then one epoch (``max_epochs=2``) under ``torch.profiler``: device
   time by kernel group, busy share, the largest idle gaps, and the GEMM
   bodies by name: only the split tile's ``veles_gemm_kernel<KIND, 0>``,
   each of the three seen at least once, and no other GEMM body; every
   minibatch run seen (two forward GEMMs each), exactly one gather
   kernel a minibatch, the group's, and none named after the db step (a
   window that fails it is taken again, at most 3 windows).  Every
   profiler window first launches PROFILE_PRIMER small kernels and
   counts only what starts after them: late in the process the
   profiler loses the first device records of each window.
15. ``mnist_parity`` — the same seed, ``max_epochs=2`` (one train pass),
   on the card (kernels) and on the CPU (plain versions): per-epoch
   per-class n_err and confusion matrices equal, the weights, biases
   and momenta leaf by leaf within max |card − cpu| <= 1e-4 · max |cpu|;
   a third card run with gd_dx planted to return zeros must fail it.
16. ``mnist_stitched`` — the default route: ``create_workflow(native=
   True, max_epochs=3)`` with ``engine.stitch=on``: the u8 dataset
   resident, each minibatch one replay of the forward segment's CUDA
   graph (loader head, both forwards, evaluator) and, on train
   minibatches, one of the GD segment's.  Exactly 150 and 120
   dispatches, 2 captures, 0 recaptures; launches 150 gather_norm (each
   serving the normalized data and the labels: 150 + 150 tables), 0
   gather, 300 matmul, 120 gd_dx, 240 gd_dw (bias_in_dw 240, gd_db 0),
   the graph replays of 300 matmul and 240 gd_dw splitting K over a
   cluster;
   host→device bytes per minibatch median <= 64 (the scalar blocks); one
   device→host copy per class close; n_err finite and falling.
   Epochs/s (over the run, and after both captures: a capture
   synchronizes and collects garbage), samples/s, the median train
   minibatch, resident bytes; every gather launch the served one
   (``gather.entry_launches``: 150 ``veles_gather_served``, 0
   ``veles_gather_group``; ``mnist``: the reverse); the loader head
   stage's function, run once eagerly under ``torch.profiler``,
   launches exactly one device kernel, the served gather; then one
   steady-state epoch (epoch 1 of a ``max_epochs=3`` run) under
   ``torch.profiler``: device time by kernel, kernels per minibatch
   (beside the 54.47 of the head with seven index kernels), host gaps,
   busy share, the GEMM bodies by name and one gather kernel a
   minibatch, as in ``mnist``.
17. ``mnist_stitched_parity`` — the stitched card run against the
   CPU's (native, one train pass), the card's stitch on against off
   (f32 dataset), a minibatch-96 run (short tails) against the CPU's,
   and a run whose GD learning rates are halved at epoch 1 against the
   CPU's (a frozen hyperparameter would fail): n_err and confusion
   equal, parameters and momenta within 1e-4 · max |cpu|.  A card run
   whose loader scalar block is written once and never again (a stale
   offset) must fail that check.
18. ``mnist_scan`` — the stitched native route of ``mnist_stitched``
   under ``engine.epoch_scan=auto`` (``veles_tpu_torch/epoch_scan.py``),
   4 epochs: each class pass is one window (validation 10 steps with the
   device verdict in its graph, train 60 steps), epoch 0's windows run
   eagerly, epoch 1's are captured, the rest replay.  Exactly 2 windows
   and 70 steps in each full epoch and 7 ``segment/dispatch`` spans in
   all (the per-step segments never dispatch), the window graphs' keys
   ``(False, 10, True)`` and ``(True, 60, False)``, each captured once
   and never again, with K times a step's launches a replay; launches
   over the run exactly 440 matmul, 180 gd_dx, 360 gd_dw (bias_in_dw
   360), 220 served gathers (220 + 220 tables); the device verdict equal
   to the host close at every validated close; capture seconds, pool
   bytes, each epoch's wall time and the host serving and dispatch time
   of the steady epoch's windows; two more epochs with each window
   graph's replays under the profiler (its nodes a replay, which the
   ``tooling`` phase holds its own to); then epoch 2 under
   ``torch.profiler`` (kernels a minibatch, busy share, device time by
   group, one gather kernel a minibatch, the split tile's GEMM bodies
   only).
19. ``mnist_scan_parity`` — 3 epochs (eager, captured and replayed
   windows): the card's window route against the card's per-step
   stitched route from the same seed, weights, momenta, confusion and
   closes bit for bit; against the port on the CPU, closes exact and
   parameters within 1e-4 · max |cpu|; under ``metrics_every=25``,
   which misdivides the train pass (windows of 25, 25 and 10 steps),
   each window key captured once at its second window and never again,
   and the run bit for bit the per-step one.  A card window run whose
   stacked offset column repeats row 0 must fail the CPU check.
20. ``mnist_ae`` — the MLP autoencoder (``samples/mnist_ae.py``,
   784→100 sigmoid→784 sigmoid, f32, MSE, minibatch 100, the stand-in
   as data and targets) stitched with ``epoch_scan`` off and auto, 4
   epochs each: the rmse closes, exactly 440 matmul, 180 gd_dx, 360
   gd_dw and 220 served gathers of the data and targets (440 raw
   tables) on both, the window graphs as in ``mnist_scan``, and the
   two runs' weights bit for bit.
21. ``mnist_ae_parity`` — the autoencoder under epoch_scan=auto on the
   card against the CPU, 3 epochs: the same closes, each rmse within
   relative 1e-5, parameters within 1e-4 · max |cpu|.
22. ``ops`` — the ops API on the card: ``matrix_reduce`` of a (4096,
   4096) f32 matrix under ``root.common.engine.pallas_reduce = True``
   launches the reduce kernel once a call (every op and axis) and agrees
   with ``_reduce_ref``; with the knob off it launches nothing.
   ``uniform_pallas(seed, (4096, 4096))`` launches once, gives the same
   bits as the same call with ``device="cpu"``, and another seed gives
   other bits.

23. ``serve_batch`` — the batch serving path at MNIST width: the MLP
   (784→100 tanh→10 softmax, f32) trained through the stitched workflow
   (``create_workflow(max_epochs=2)``: one validation and one train
   pass; its second validation n_err must fall), served by
   ``InferenceEngine.from_workflow(wf, max_batch_size=64)`` (buckets 1
   … 64, one CUDA graph each) deployed as ``mnist`` in a
   ``ModelRegistry`` behind ``ServingServer`` on 127.0.0.1.  256
   requests of 1–4 stand-in test rows from 16 client threads, half JSON
   and half base64: every reply equal to ``reference_forward`` of its
   rows bit for bit and within 1e-5 of the plain forward
   (``_matmul_ref`` + softmax) on the card; 7 captures, 0 recaptures,
   ``compile_count`` 7 before and after; fewer infer calls than
   requests, and exactly 2 GEMM launches an infer call (counts set to 0
   just before the traffic, read just after; the graphs' replays count
   their launches).  A profile of 24 replays must name 2 GEMM kernels a
   call and no cuBLAS kernel; a profiled window of 64 served requests
   gives the device's busy share.  A second engine with its weights
   and biases halved is deployed under traffic from 8 threads: every
   reply is v1's or v2's forward whole, and both are seen.  The int8
   deploy (``quantize="int8"``, a 100-row calibration batch) as
   ``mnist_int8``: 64 requests, exactly 2 qmatmul launches an infer
   call and no GEMM, replies within 1e-5 of the plain ``_qmatmul_ref``
   forward, drift under ``quant.DRIFT_TOL``, params at most 0.35x the
   float engine's, a replay profile naming 2 qmatmul kernels a call;
   whether 16 rows give the same bits in the 16- and the 32-row bucket
   is recorded for float and int8.  Requests/s, p50/p95/p99 latency,
   rows per infer call and the batch fill ratio are printed, and the
   GEMM's and qmatmul's device time per call at M = 1, 8 and 64 on the
   served layers (784×100 tanh, 100×10) beside the plain version,
   ``addmm`` (on a dequantized f32 copy for qmatmul) and the bound;
   these ride in the kernels line's ``serving_buckets``.
24. ``tooling`` — ROADMAP 6(c) on the card: ``mnist_scan``'s windows
   (4 epochs, epoch_scan=auto) with ``engine.health`` off and then on,
   from the same seed: weights and momenta bit for bit, launches
   exactly ``mnist_scan``'s; two more epochs whose windows' ledger
   rows (device time, flops, MFU of the replays alone) are printed, and
   two more with each window
   graph's replays under the profiler (the count of the window that saw
   the most): with health off its nodes equal ``mnist_scan``'s
   (profiled the same way after its counted run), with health on the
   nodes and busy time it adds are printed.  The
   first train window's health statistics on the card agree with the
   CPU route's over the same window within 1e-4 relative, non-finite
   counts exact.  Under ``strict`` a NaN planted in layer 1's weights
   raises ``HealthError`` at the first window boundary naming the leaf
   and step the CPU route names.  ``prof``'s ``run_smoke`` over the
   sample on the card (flops on every segment, a report row each, 0
   recompiles) passes; ``watch``'s ``run_smoke`` runs where ``import
   zmq`` succeeds (printed either way).  The ledger's rows for every
   entry the run's paths registered (segments, windows, serve buckets,
   prefill, chunk, decode and verify programs) are printed with their
   MFU against the card's rate for their type, beside ``nvidia-smi``'s
   name and power limit: every entry has non-zero flops and the run 0
   recompiles.  ``trace.device_trace`` around a warm stitched epoch
   writes a Chrome trace naming ``veles_gemm_kernel<0, .>`` (matmul),
   ``veles_gemm_kernel<2, .>`` (the body ``veles_gd_dw`` launches) and
   ``veles_gather_served_kernel``.  The phase's wall time is printed.
25. ``snapshot`` — ROADMAP 7(a) on the card: the native stitched MNIST
   MLP (full width, stand-in data) trained 3 epochs with
   ``snapshot_dir`` (a snapshot at every improvement: ``time_interval``
   0) under ``epoch_scan=auto``: the windows are refused
   with the JAX reason ("units hang off DecisionGD in the training
   loop"), the per-step route launches exactly ``mnist_stitched``'s
   counts, and at least one artifact is written.  The last artifact is
   resumed under the JAX package's protocol (load, ``max_epochs`` 5,
   ``complete`` cleared, ``initialize``, ``run``) on the card — new
   segments, captured once each over the new tensors, no recapture,
   exact launches — and on the CPU from the same stream positions: the
   per-class n_err and confusion matrices equal, every parameter and
   momentum within 1e-4 of its leaf's largest value.  A process started
   with ``CUDA_VISIBLE_DEVICES=`` loads the artifact and its params
   equal, bit for bit, the card's ``params_to_numpy()`` read right
   before that snapshot's capture.  Printed: the artifact's bytes, each
   synchronous capture and background write in ms, the resume's
   ``initialize`` plus capture ms, captures and recaptures, launches.
26. ``snapshot_serve`` — ``ModelRegistry.load_snapshot`` of that
   artifact on the card (``serve.preflight = "off"``): the engine's
   params equal the artifact's, and 64 requests of 1–4 rows (the
   validation rows scaled by 1/255, as the loader head scales them)
   from 8 threads each get a reply bit-equal to ``reference_forward``,
   with 2 GEMM launches an infer call and no capture after warmup; their
   error rate is within 10 points of the artifact's validation error.
27. ``checkpoint`` — the train-state checkpoint on the window route
   (``epoch_scan=auto``): 2 epochs, ``capture_train_state`` →
   ``TrainCheckpointer.save``, a workflow built from another seed,
   ``restore`` onto its own state → ``restore_train_state`` → on to 4
   epochs (the pending minibatch served again first, one step, then
   windows), on the card and on the CPU: held together as in
   ``snapshot``, with the continued card run's exact launches and the
   step directory's bytes and the save and restore ms.
28. ``mnist_rnn`` — ``samples/mnist_rnn.py`` at full width (an LSTM of
   128 over the stand-in's 28 rows of 28 pixels, a softmax of 10,
   minibatch 100), 3 epochs on the eager, stitched and fused routes:
   exact GEMM, GD and gather launches, the graphs' captures and
   recaptures (0), the steady epoch's wall ms and MFU by the JAX formula
   ``lstm_train_flops``, and a profile's device ms by group (the gates'
   cuBLAS products, elementwise, the GEMM and gather kernels, copies).
29. ``mnist_rnn_parity`` — 2 epochs on the card (eager, stitched)
   against the CPU: closes and confusion equal, every leaf within
   ``MNIST_RNN_PARAM_RTOL``; a 1 % error planted in the LSTM's weight
   gradient must fail the bound.
30. ``mnist_ae_rbm`` — ``mnist_ae(rbm_pretrain=True)``: the RBM's 20
   CD-1 steps on the card and on the CPU, the flipped Bernoulli draws
   counted step by step (at most ``RBM_MAX_FLIPS``), the weights held
   together step by step up to the first flip and at the end; a card
   run with a planted sampler (``>=`` for ``<``) must fail; the
   fine-tune's exact launches and falling rmse.
31. ``kohonen`` — the SOM sample, card against CPU: the winners that
   moved counted (at most ``KOHONEN_MAX_MOVED``), the codebook step by
   step up to the first move and the quantization error; a card run
   with a planted winner (the second nearest) must fail; one gather
   launch a step (the eager fill's: the trainer is a barrier).
32. ``data_side`` — every normalizer through the stitched MNIST head:
   an affine one over the u8-resident stand-in, applied by the head's
   served gather launch, any other on the host at initialize; the
   served minibatches against the CPU route's and the host
   ``normalize`` of the same rows, the launches counted; MeanDisp, the
   joiner, the avatar and HOG on CUDA tensors against the CPU; the MNIST
   MLP over the all-TRAIN stand-in with ``validation_ratio`` 0.1, card
   against CPU (the same index sequence, closes and parameters); a
   ``MinibatchesSaver`` dump of a card loader replayed exactly.
33. ``spmd_group`` — ``parallel.multihost.initialize`` on the card: a
   one-rank NCCL group (one card allows one NCCL rank; the multi-rank
   cases run as gloo worlds in the CPU tests), which the next four
   phases run their collectives on, each reporting the collectives it
   issued by kind (``parallel.comm.counts``).
34. ``spmd_train`` — the ``train`` phase's CONFIG step through
   ``build_train(mesh=mesh_from_topology("data=1,seq=1,model=1"))``
   beside the no-mesh step, 6 steps each: losses, params and velocity
   bit-equal, 24/12/12 flash launches and exactly 61 all-reduces a step,
   step ms and tokens/s of both; a 2-layer f32 mesh step against the
   CPU at ``train_parity``'s bounds.
35. ``ring`` — ring-flash at (8, 2048, 16, 64), bf16 and f32, as 4
   virtual ranks of 512 positions: ``ring.forward_hop`` /
   ``backward_hop`` for each (rank, hop), 16 forward and 16 backward
   pairs at global causal offsets; the merged o, lse, dq, dk, dv against
   the single-shard flash kernels at the kernels phase's tolerances and
   against the ring's plain version (the gradients within the sum of
   the hops' bounds); a k_offset one block off must be caught; then
   ``ring_attention`` and ``ulysses_attention`` on the one-rank group
   equal to the flash attention bit for bit.
36. ``moe`` — ``samples/moe.py`` at CONFIG, batch 8: ``moe_mlp`` on the
   one-rank group equal to ``moe_reference`` (capacity factor = the
   experts), 5 mesh train steps bit-equal to the no-mesh steps with a
   falling loss, tokens/s.
37. ``fused_dp`` — the fused MNIST trainer with ``mesh_axes={"data":
   -1}``, 3 epochs, bit-equal to the no-mesh run, one capture a step
   shape, no recapture, exact GEMM and gather launches, the step's
   all-reduce captured in its graph; AlexNet's f32 step at batch 128
   over the data mesh bit-equal to the no-mesh step, 3 captured steps.
38. ``jobs`` — the job layer (``parallel/jobs.py`` on the standard
   library's TCP wire): an in-process ``JobServer`` over the MNIST
   master workflow (full width, native, stitched) and one ``JobClient``
   slave in the same process, both on the card, ``MNIST_EPOCHS`` to the
   Decision's end: every job applied exactly once, the master's
   weights moved, the slave's launches exactly ``MNIST_STITCHED_
   LAUNCHES`` (its segments captured once, no recapture after the first
   job); wall ms, jobs/s, the job round trip's p50/p99 and the bytes
   each job moves each way.
39. ``jobs_parity`` — that session on the card and on the CPU for
   ``MNIST_PARITY_EPOCHS``: closes equal, the master's weights within
   ``MNIST_PARAM_RTOL``.
40. ``jobs_fused`` — a fused slave: the step graphs' GEMM launches (5 a
   train job, 2 an eval job), one capture a step shape and no
   recapture, the master's weights within ``MNIST_PARAM_RTOL`` of the
   CPU's fused session.
41. ``jobs_chaos`` — the chaos gate's seeded schedule on the card's
   MNIST session (a slave kill, a dropped job frame, a duplicated
   update, a master kill and a resume from its checkpoint): completes,
   each seq applied once a generation, ``dedup_dropped`` >= the
   duplicates, ``lost_requeued`` > 0, the resume within one checkpoint
   interval.
42. ``cli`` — ``python -m veles_tpu_torch veles_tpu_torch.samples.mnist
   -l 127.0.0.1:0 -n 'localhost x2' --slave-launch-transform 'sh -c'
   --result-file ... --profile ...`` as a subprocess: exit code 0, both
   spawned slaves did jobs (the session bundle), the result file holds
   the Decision's metrics, every spawned process gone.

The ``kernels`` phase also holds the paged decode kernel against
``_paged_decode_ref`` (f32 <= 1e-4, bf16 <= 2e-2) for decode (1 row)
and verify (5 and 8 rows), pages of 4, 8 and 16 keys in shuffled order,
lengths of 1, a page edge -1 and +1 and a verify limit at max_blocks·BS;
requires it to equal the contiguous decode kernel bit for bit on a pool
that mirrors a contiguous cache at every split, to ignore garbage (1e4)
in the trash and unowned pages, and to report two planted faults (one
row's first and last table entries swapped, one row's length + 1); and
times it at the serving shape (bf16, 513-page pool, lengths up to 1564,
decode and 5-row verify), on both measures, beside the contiguous kernel
on the mirrored cache, the plain version and its bound by bytes (no one
PyTorch call reads through a block table, so ``library_ms`` is null),
with its split and body.  It holds the GEMM kernel
(``matmul``: every activation × bias on/off) and the fused GD step (dx,
then dw carrying the bias step; every activation ×
both storage layouts × need_err_input × has_bias) against
``_matmul_ref`` / ``_gd_ref`` at 37×70×50, the MNIST shapes, 8×20×8,
30×140×30 (K split 2 over less than 2·16, split 8 over 9 K tiles), the
autoencoder's second layer 100×100×784 (its first is MNIST's 100×784×100)
and 4096³, every element within 1e-5 + 1e-5·|plain| (4096³: 1e-4 +
1e-4·|plain|, a 4096-long f32 sum in another order); dw with the bias
step on every (tile, split) at those shapes (4096³ on the host rule's),
every activation and layout, relaunched bit-equal, its bias sums bit
for bit against ``_bias_sum_plan_ref`` (the plain model of their
order); checks bit-equal relaunches, reports eight planted faults (the
last K tile dropped from matmul, dx launched after dw, the last batch
tile dropped from dw, the last rank's K chunk dropped from matmul, dx
and dw where the host rule splits K, and the two planted builds of the
bias merge) and times each kernel at the MNIST shapes and 4096³ beside
its f32 bound, the plain version and one PyTorch call (``addmm``,
``mm``, ``sum``), with the (tile, split) it ran: dw with the bias step
as the main path launches it and without, and gd_db as the time the
bias step adds to the dw launch.  The bf16 GEMM (``csrc/gemm_bf16.cu``)
is held on both of its bodies (W: TMA + wgmma; S: ldmatrix + mma.sync)
within one bf16 ulp of the plain version and of the plain model of its
split sum, at the fused MNIST step's products, AlexNet's six bf16 fc
products, 4096^3, two ragged shapes in each of the four layout pairs
(split 4, and unsplit through the TMA stores), an output pitch TMA
cannot store and unaligned views; each body's relaunch is bit-equal,
and each main-path product is timed beside its bound, ``addmm`` and
the body, tile and split it took.  These
times are device times of back-to-back calls (queued behind a spin
kernel, one CUDA-event pair around them, per call): at the MNIST
shapes a CUDA-event pair around one call times the host wrapper, which
is kept as ``wrapper_ms``.  It holds the group gather (``take_rows``:
pads 0 and -1; ``take_rows_norm``: scalar and per-feature affines; and
groups of up to four tables in one launch, also replayed from a graph
over outputs filled with 7) on u8, f32 and int32 tables with negative
and out-of-range indices and rows of 1, 13 (no 16-B word) and 784
elements, exactly; the served launch (``take_rows_served``: the
stitched head's rows, their index computed in the launch from a
shuffled buffer and 0-d int32 offset and size on the card) against
``_gather_served_ref`` bit for bit at sizes 100, 60, 1 and 0, the
buffer's last row, a batch running past the buffer's end and an offset
at it, for u8 data normalized with the labels, f32 data raw with the
labels, int32 and f32 tables normalized per feature, and the
autoencoder's two raw f32 tables (data and targets, pad 0), each also
replayed from one graph with the scalars rewritten between replays; seven planted
faults (every index off by one, negative indices not zeroed, for each
kind, and the kernel's three planted builds) must be reported; it is
timed as each route's minibatch launches it (the eager group: 100 rows
of (7000, 784) f32 data with the int32 labels; the stitched served
launch: u8 normalized with the labels at sizes 100 and 60, beside the
head's earlier form, five index ops (seven kernels, each op timed)
and the group launch), each table alone, and 4096 rows of a (70000, 784) u8 table
(served with its labels), beside its bound by bytes.  The GEMM half
also requires ``matmul`` through a transposed view of (N, K) weights to
equal the same call on its contiguous copy bit for bit at (100, 784,
100).  It holds
the int8 GEMM (``qmatmul``) against ``_qmatmul_ref`` at CONFIG's four
block shapes at M = 4 and 2048 in bf16 and M = 20 in f32, and at (5,
200, 130) and (20, 1024, 1024) with every activation (gelu included),
bias and no bias, f32 and bf16 (f32 within 1e-4 of max |plain|, bf16
within 2e-2), and the decode body (bf16, M <= 16) at (4, 1024, 1024),
(16, 4096, 1024) and (5, 200, 130) under every column tile and split,
each relaunch bit-equal; four planted faults (shuffled scales, the last
K tile dropped, and the decode body's two planted builds) must be
reported; relaunches of the tensor-core body, split and not, must give
equal bits; it is timed at the four shapes at decode (event time with L2
flushed, and device time on 12 cycled copies of the weights) and at
prefill (M = 2048, the row's headline; device time too) beside its
bound, the plain version and ``torch.mm`` on a dequantized bf16 copy
plus the epilogue, on the same measures, and a profile of each M's calls
must name the tensor-core body at M = 2048 and the decode body
(``qmatmul_kernel_dec``) at decode, and no other.  It holds the
reduce kernel against ``_reduce_ref`` at (4096, 4096), (37, 53), (24,
256), (1, 5000) and (5000, 1), f32 and bf16, every op and axis, with and
without ±inf and NaN (max and min equal, NaN where the plain version has
it; sums within 1e-6·Σ|a|, plus one bf16 ulp for bf16), at every split
(1, 2, 4, 8) at (4096, 4096) with ±inf and NaN (the sums also bit for
bit against ``_reduce_plan_ref``, the plain model of the kernel's
order), and on row strides past n (1032, 16-byte aligned, and 1031);
a dropped last row block and a dropped last column block (in the
inputs) and its two planted builds must be reported; a profile of the
six calls must name ``reduce_axis0_kernel`` and ``reduce_axis1_kernel``
and no other reduce kernel; it is timed at (4096, 4096) f32 beside
``torch.sum`` / ``amax`` / ``amin`` as event time with L2 flushed and as
device time on 4 cycled copies.  It holds the uniform kernel bit for
bit against ``_uniform_ref`` at (4096, 4096) (in [low, high), mean and
variance within 5 sigma of U(low, high)) and at fills whose last
counter holds 4, 1, 2 or 3 values, f32 and bf16; its two planted builds
must be reported; it is timed as event time with L2 flushed and as
device time back to back beside ``torch.rand`` and ``fill_`` of the
same 64 MiB.  Event times "with L2 flushed" run a 96 MiB read before
each timed call (``make_l2_flush``), which leaves L2 clean: the earlier
zeroing flush left ~50 MB of dirty lines that were written back inside
the next timed call.
Every phase runs with ``precision_level`` 2 (TF32 off).

Then it prints the per-kernel JSON line, all 14 TPU kernels (launches on
the main paths, serve, serve_int8, serve_generate,
serve_generate_int8, serve_paged,
serve_spec, train, mnist, mnist_stitched, mnist_scan, mnist_ae,
serve_batch, ops, tooling, the snapshot and checkpoint phases,
mnist_rnn on its three routes, mnist_ae_rbm, kohonen, data_side and
data_side_norms, spmd_train, ring, fused_dp, pod, fused_shard, serve_tp,
jobs, jobs_fused, jobs_chaos, max
abs error, kernel / plain / library times,
roofline bound), the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, it exits non-zero and prints no
result.
"""

import contextlib
import copy
import itertools
import json
import re
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
GEMM_TILE_K = 16                  # BK of csrc/gemm.cu's split tile
GD_HP = (0.03, 0.03, 0.0005, 0.0005, 0.9, 0.9)   # MNIST's <- parameters
MNIST_EPOCHS = 3
MNIST_PARITY_EPOCHS = 2
MNIST_PARAM_RTOL = 1e-4
# the JAX package's schedule for max_epochs=3: 3 validation passes of 10
# minibatches and 2 train passes of 60, two layers; only the softmax
# layer's GD computes err_input; the bias step rides in every dw launch
# (gd_db_in_dw), and one gather launch a minibatch serves its data and
# labels (two raw tables)
MNIST_LAUNCHES = {"matmul": 300, "matmul_bf16": 0, "gd_dx": 120,
                  "gd_dw": 240, "gd_db": 0,
                  "gd_db_in_dw": 240, "gather": 150, "gather_norm": 0,
                  "gather_tables": 300, "gather_norm_tables": 0}
# the stitched native route, max_epochs=3: the forward segment dispatches
# every minibatch (150), the GD segment every train minibatch (120); its
# head's one gather launch normalizes the u8 data row and takes the
# labels (counted under gather_norm)
MNIST_STITCHED_LAUNCHES = {"matmul": 300, "matmul_bf16": 0, "gd_dx": 120,
                           "gd_dw": 240,
                           "gd_db": 0, "gd_db_in_dw": 240, "gather": 0,
                           "gather_norm": 150, "gather_tables": 150,
                           "gather_norm_tables": 150}
MNIST_STITCHED_DISPATCHES = [150, 120]
# the same launches by csrc/gather.cu's entry: the eager fill's group
# launch, the stitched head's served launch
MNIST_ENTRY_LAUNCHES = {"veles_gather_group": 150, "veles_gather_served": 0}
MNIST_STITCHED_ENTRY_LAUNCHES = {"veles_gather_group": 0,
                                 "veles_gather_served": 150}
# kernels a minibatch of the stitched steady epoch while the head ran five
# int32 index ops (seven kernels: each where against a scalar also fills)
# ahead of its group gather (scripts/launch_probe.py on an H100 80GB HBM3
# at 700 W; PERF.md section 5): the served launch takes them into itself
MNIST_STITCHED_KERNELS_WITH_INDEX_OPS = 54.47
# both routes: every forward splits K (layer 1: 16 tiles split 8; layer 2:
# 4 tiles split 4), so does every dw (layer 1: 100 tiles split 4; layer
# 2: 4 tiles split 4); layer 2's dx has one K tile
MNIST_SPLIT_LAUNCHES = {"matmul_split": 300, "gd_dx_split": 0,
                        "gd_dw_split": 240}
# the GEMM bodies (KIND, TILE) of both routes' calls: all on the split tile
MNIST_GEMM_BODIES = {(0, 0), (1, 0), (2, 0)}
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


#: copies of a byte-bound call's operands that :func:`cold_device_ms`
#: cycles through: 12 copies of the decode step's 12.6 MB of K and V (or
#: of a qmatmul layer's int8 weights) pass 150 MB, three times the 50 MB
#: L2, between two calls on the same copy, as a serving step's 12 layers
#: do
COLD_COPIES = 12


def cold_device_ms(calls, reps=2 * COLD_COPIES):
    """:func:`device_ms` of a byte-bound call with each call on the next
    of ``calls`` (one closure a copy of the operands, cycled), so that
    none finds its operands in L2: back to back on one copy, the decode
    step's bytes would be served from L2 after the first call."""
    it = itertools.cycle(calls)
    return device_ms(lambda: next(it)(), reps)


#: a launch counter's name -> its kernel group in a profile, where the two
#: differ: both gather counters count launches of csrc/gather.cu's two
#: kernels, which share one profile group
_GATHER_GROUP = "veles_gather_group"
_PROFILE_GROUP = {"gather": _GATHER_GROUP, "gather_norm": _GATHER_GROUP}
#: csrc/gather.cu's kernels by name: the group launch over an index
#: vector, and the stitched head's served launch
_GATHER_KERNELS = ("veles_gather_group_kernel", "veles_gather_served_kernel")

#: csrc/gemm.cu's kernels by (demangled) name, blanks removed: one GEMM
#: body templated on its kind (0 matmul, 1 gd_dx, 2 gd_dw, 3 gd_dw into
#: the transposed storage; the bias step rides in 2 and 3) and tile (0 the
#: split tile, 1 the big tile)
_GEMM_GROUPS = (("veles_gemm_kernel<0,0>", "veles_matmul"),
                ("veles_gemm_kernel<0,1>", "veles_matmul"),
                ("veles_gemm_kernel<1,0>", "veles_gd_dx"),
                ("veles_gemm_kernel<1,1>", "veles_gd_dx"),
                ("veles_gemm_kernel<2,0>", "veles_gd_dw"),
                ("veles_gemm_kernel<2,1>", "veles_gd_dw"),
                ("veles_gemm_kernel<3,0>", "veles_gd_dw"),
                ("veles_gemm_kernel<3,1>", "veles_gd_dw"))
#: a GEMM body's profiled name -> its kind and tile
_GEMM_BODY = re.compile(r"veles_gemm_kernel<(\d+),\s*(\d+)>")


def _kernel_group(name):
    for tag, group in (("qmatmul_kernel", "qmatmul"),
                       ("veles_gemm_bf16_tma", "veles_matmul_bf16"),
                       ("veles_gemm_bf16_ldsm", "veles_matmul_bf16"),
                       ("reduce_axis0_kernel", "reduce"),
                       ("reduce_axis1_kernel", "reduce"),
                       ("reduce_rows_kernel", "reduce"),
                       ("reduce_cols_kernel", "reduce"),
                       ("uniform_kernel", "uniform")):
        if tag in name:
            return group
    for tag, group in _GEMM_GROUPS:
        if tag in name.replace(" ", ""):
            return group
    for group in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if group + "_kernel" in name:
            return group
    if any(kernel in name for kernel in _GATHER_KERNELS):
        return _GATHER_GROUP
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
        prime_window()
        tic = time.perf_counter()
        fn()
        gpu_sync()
        wall_us = (time.perf_counter() - tic) * 1e6
    return _profile_summary(prof, wall_us, names_of)


#: small kernels launched inside a profiler window before the profiled
#: work.  Late in a process the profiler loses the first device records
#: of every window (scripts/profile_window_probe.py on an H100: 8 of 200
#: kernels after the ``kernels`` phase, none in a fresh process), which
#: took a train step's first flash forward, an MNIST window's first
#: minibatch, or all of a short window's kernels.  The primer's kernels
#: take that loss; the summary counts only the kernels that start after
#: WORK_MARKER, and records how many of the primer's it saw
PROFILE_PRIMER = 256
WORK_MARKER = "chip_smoke.profiled_work"
#: the primer's device (the CPU tests run it on the CPU)
_PRIMER_DEVICE = "cuda"


def prime_window():
    """Inside an open profiler window: launch PROFILE_PRIMER kernels,
    wait for them, and mark where the profiled work starts."""
    from torch.autograd.profiler import record_function
    primer = torch.empty(1, device=_PRIMER_DEVICE)
    for _ in range(PROFILE_PRIMER):
        primer.add_(1.0)
    gpu_sync()
    time.sleep(0.005)      # the marker well after the primer's last kernel
    with record_function(WORK_MARKER):
        pass


#: windows a kernel-name check may take (before PROFILE_PRIMER, a short
#: window at times recorded none of its kernels: the ``qmatmul`` window
#: once saw none of its 8)
PROFILE_TRIES = 3


def profiled_names(fn, names_of, seen):
    """The names of the kernels of the groups ``names_of`` that a
    :func:`profile_window` around ``fn`` saw, ``{name: count}``, and the
    number of windows taken: a window is taken again, at most
    PROFILE_TRIES in all, while ``seen(names)`` is false.  The caller's
    check of the names stays as strict: a body that ran is seen, and a
    body that never ran is never seen, in any window."""
    for tries in range(1, PROFILE_TRIES + 1):
        names = profile_window(fn, names_of)["kernel_names"]
        if seen(names):
            break
    return names, tries


def _profile_summary(prof, wall_us, names_of=()):
    """:func:`profile_window`'s summary of a finished profile."""
    from torch.autograd import DeviceType
    groups, counts, names, spans, named = {}, {}, {}, [], {}
    events = prof.events()
    work = min((ev.time_range.start for ev in events
                if ev.name == WORK_MARKER), default=None)
    primer = 0
    for ev in events:
        if ev.device_type != DeviceType.CUDA or ev.name == WORK_MARKER:
            continue
        if work is not None and ev.time_range.start < work:
            primer += 1
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
               "host_gaps_ms_total": sum(gaps) / 1e3,
               "primer_kernels_seen": primer,
               "primer_kernels_run": PROFILE_PRIMER}
    if names_of:
        summary["kernel_names"] = named
    return summary


#: the profile groups whose kernel names the MNIST phases read: the GEMM
#: bodies, and "matmul", where any other GEMM would land; and the gather
#: kernel and "other", where a kernel of no known group lands
_GEMM_NAMES = ("veles_matmul", "veles_gd_dx", "veles_gd_dw", "matmul")
_MNIST_NAMES = _GEMM_NAMES + (_GATHER_GROUP, "other")


def _gemm_bodies(names):
    """The GEMM bodies among a profile's kernel names, ``{"KIND,TILE":
    count}``, and the names of any other ``veles_gemm_kernel`` (the
    shape before the tile parameter)."""
    bodies, other = {}, []
    for name, n in names.items():
        if "veles_gemm_kernel" not in name:
            continue
        found = _GEMM_BODY.search(name)
        if found is None:
            other.append(name[:120])
            continue
        key = "%s,%s" % found.groups()
        bodies[key] = bodies.get(key, 0) + n
    return bodies, other


def _gemm_bodies_ok(breakdown):
    """Records the GEMM bodies of an MNIST profile in ``breakdown`` and
    says whether they are MNIST_GEMM_BODIES, each seen at least once (the
    profiler may miss some launches), and nothing else."""
    bodies, other = _gemm_bodies(breakdown.get("kernel_names", {}))
    breakdown["gemm_bodies"] = bodies
    breakdown["gemm_bodies_expected"] = sorted(
        "%d,%d" % b for b in MNIST_GEMM_BODIES)
    return not other and set(bodies) == set(breakdown["gemm_bodies_expected"])


def _mnist_kernels_ok(breakdown, minibatches):
    """Records in an MNIST profile's ``breakdown`` its gather-family
    kernels (any name holding ``veles_gather``), the minibatches it saw
    (half its forward GEMM bodies: each minibatch launches the matmul
    twice) and any kernel named after the db step, and says whether it
    saw every one of the ``minibatches`` it ran, exactly one gather
    kernel for each, the group's (the eager fill) or the served one (the
    stitched head), and no db kernel."""
    names = breakdown.get("kernel_names", {})
    gathers = {name: n for name, n in names.items()
               if "veles_gather" in name}
    forwards = _gemm_bodies(names)[0].get("0,0", 0)
    breakdown["gather_kernels"] = sum(gathers.values())
    breakdown["minibatches_seen"] = forwards / 2
    breakdown["minibatches_run"] = minibatches
    breakdown["gd_db_kernels"] = {name: n for name, n in names.items()
                                  if "gd_db" in name}
    return (breakdown["gather_kernels"] == minibatches
            and forwards == 2 * minibatches
            and all(any(kernel in name for kernel in _GATHER_KERNELS)
                    for name in gathers)
            and not breakdown["gd_db_kernels"])


def _mnist_profiled(window):
    """``window()`` -> ``(breakdown, minibatches)`` of one profiled MNIST
    window, taken again, at most PROFILE_TRIES windows, while its
    gather kernels and minibatches disagree; the last window's
    breakdown, its windows recorded."""
    for tries in range(1, PROFILE_TRIES + 1):
        breakdown, minibatches = window()
        ok = _mnist_kernels_ok(breakdown, minibatches)
        if ok:
            break
    breakdown["profile_windows"] = tries
    return breakdown, ok


def _bodies(names):
    """Kernels by the body their profiled names belong to: ``*_kernel_tc``
    is the bf16 tensor-core body (of ``csrc/flash_fwd.cu``,
    ``csrc/flash_bwd.cu`` or ``csrc/qgemm.cu``), ``qmatmul_kernel_dec``
    qmatmul's decode body (bf16 at M <= 16), the rest the FMA body."""
    bodies = {"tensor_core": 0, "decode": 0, "fma": 0}
    for name, n in names.items():
        body = ("tensor_core" if "_kernel_tc<" in name else "decode"
                if "qmatmul_kernel_dec<" in name else "fma")
        bodies[body] += n
    return bodies


def make_l2_flush(device, dirty=False):
    """A flush of the 50 MB L2 to run before a timed call: a read of 96
    MiB, which evicts the previous call's dirty lines (their write-backs
    land inside the flush, outside the timed events) and leaves L2 full
    of clean, unrelated lines.  ``dirty=True`` is the zeroing flush the
    earlier event-time rows were taken under: its own ~50 MB of dirty
    lines are written back inside the next timed call, which is billed
    for them (kept to compare the two measures in scripts/ops_probe.py)."""
    buf = torch.ones(24 * 2 ** 20, dtype=torch.float32, device=device)
    if dirty:
        return buf.zero_

    def flush():
        torch.amax(buf)
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


#: builds of a source with a fault planted in its cluster merge
#: (``-DVELES_PLANTED_FAULT=n``), which the ``kernels`` phase's
#: tolerances must report: (source, n) -> what the fault does
PLANTED_BUILDS = {
    ("decode_attn", 1): "last_rank_partial_dropped",
    ("decode_attn", 2): "last_rank_acc_not_rescaled",
    ("qgemm", 1): "last_rank_k_chunk_dropped",
    ("qgemm", 2): "scale_applied_twice",
    ("reduce", 1): "last_rank_partial_dropped",
    ("reduce", 2): "nan_flag_ignored",
    ("random", 1): "second_word_over_first",
    ("random", 2): "counter_offset_one_block",
    ("gemm", 1): "bias_last_rank_partial_dropped",
    ("gemm", 2): "bias_update_applied_by_two_ranks",
    ("gather", 1): "second_table_rows_at_index_plus_one",
    ("gather", 2): "raw_pad_rows_unwritten",
    ("gather", 3): "served_row_one_past_the_tail"}
#: (source, n) -> the built library
planted_libraries = {}


def phase_build():
    from veles_tpu_torch.ops import build
    tic = time.perf_counter()
    folder = build.BUILD_DIR / "planted"
    folder.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source, fault in PLANTED_BUILDS:
        target = folder / ("lib%s_fault%d.so" % (source, fault))
        cmd = [build.nvcc(), *build.NVCC_FLAGS,
               "-DVELES_PLANTED_FAULT=%d" % fault, "-o", str(target),
               str(build.CSRC_DIR / (source + ".cu"))]
        procs[source, fault] = (target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        seconds = build.build_all()
        for key, (target, proc) in procs.items():
            out, _ = proc.communicate()
            check(proc.returncode == 0, "build", "nvcc failed on the "
                  "planted build %s:\n%s" % (key, out))
            planted_libraries[key] = target
    finally:
        for _target, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - tic
    ptxas = {name: [ln.strip() for ln in log["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name, log in build.build_log.items()}
    emit({"phase": "build", "ok": True, "wall_s": wall,
          "nvcc_s": seconds, "ptxas": ptxas,
          "planted_builds": sorted("%s:%d" % key for key in PLANTED_BUILDS)})


@contextlib.contextmanager
def planted(source, fault):
    """The package's wrappers of ``source``'s kernels launch the planted
    build ``fault`` inside the block (same C entries, same arguments)."""
    import ctypes
    from veles_tpu_torch.ops import (attention, gather, gemm, qgemm, random,
                                     reduce)
    lib = ctypes.CDLL(str(planted_libraries[source, fault]))
    if source == "gather":
        saved = dict(gather._entries)
        for symbol, argtypes in gather._ARGTYPES.items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            gather._entries[symbol] = fn
        try:
            yield
        finally:
            gather._entries.clear()
            gather._entries.update(saved)
        return
    if source == "gemm":
        symbol, argtypes = gemm._ARGTYPES["gd_dw"]
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        saved = dict(gemm._entries)
        gemm._entries["gd_dw"] = fn
        try:
            yield
        finally:
            gemm._entries.clear()
            gemm._entries.update(saved)
        return
    if source in ("reduce", "random"):
        module = reduce if source == "reduce" else random
        fn = getattr(lib, "veles_" + ("reduce" if source == "reduce"
                                      else "uniform"))
        fn.argtypes, fn.restype = module._ARGTYPES, ctypes.c_int
        saved = list(module._entry_fn)
        module._entry_fn[:] = [fn]
        try:
            yield
        finally:
            module._entry_fn[:] = saved
        return
    if source == "qgemm":
        fn = lib.veles_qmatmul
        fn.argtypes, fn.restype = qgemm._ARGTYPES, ctypes.c_int
        saved = list(qgemm._entry_fn)
        qgemm._entry_fn[:] = [fn]
        try:
            yield
        finally:
            qgemm._entry_fn[:] = saved
        return
    saved = dict(attention._entries)
    for name in ("decode_attn", "paged_decode_attn"):
        _src, symbol, argtypes = attention._ARGTYPES[name]
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        attention._entries[name] = fn
    try:
        yield
    finally:
        attention._entries.clear()
        attention._entries.update(saved)


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


def _fwd_planted_faults(q, k, v):
    """Two faults planted in the forward's inputs at the timed shape, each
    of which the tolerance must report: V's row 64 (the first of the
    second K tile) zeroed, what a misplaced row of the ring would do, and
    q_offset off by one, each query seeing one key too many."""
    from veles_tpu_torch.ops.attention import _flash_fwd_cuda, _mha_ref
    want_o, want_lse = _mha_ref(q, k, v, True)
    v_bad = v.clone()
    v_bad[:, BWD_TILE] = 0
    faults = {"v_row_64_zeroed": _flash_fwd_cuda(q, k, v_bad, True, 0, 0),
              "q_offset_plus_one": _flash_fwd_cuda(q, k, v, True, 1, 0)}
    gpu_sync()
    out = {}
    for name, (o, lse) in faults.items():
        err = max(float((o.float() - want_o.float()).abs().max()),
                  float((lse - want_lse).abs().max()))
        out[name] = {"max_abs_err": err, "tol": BF16_TOL,
                     "caught": err > BF16_TOL}
    return out


def _fwd_timed(rng, device):
    """The forward at CONFIG's heads and the largest prefill bucket, (1,
    2048, 16, 64), and at the ``train`` step's batch, (8, 2048, 16, 64),
    bf16 causal on strided views of one projection: one wrapper call's
    event time (:func:`time_ms`) and the device time per call
    (:func:`device_ms`), TFLOP/s and the share of the bound on both
    measures, the plain version's time, and SDPA's on both measures.  The
    row's headline is (1, 2048, 16, 64), as the earlier rows; the body
    that ran is read from the kernel's name in a profile; two planted
    faults must be reported."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops.attention import _flash_fwd_cuda, _mha_ref
    from veles_tpu_torch.samples.transformer import CONFIG
    h, s = CONFIG["heads"], CONFIG["seq_len"]
    d = CONFIG["dim"] // h
    by_shape, first = [], None
    for b in (1, TRAIN_BATCH):
        (q, k, v), err = _flash_case(rng, device, torch.bfloat16, b, s, h,
                                     d, True)
        first = first or (q, k, v)
        nbytes = 4 * b * s * h * d * 2 + b * h * s * 4   # q k v o, lse
        ops = 4 * d * h * b * s * (s + 1) // 2           # unmasked pairs
        bound, by = bound_seconds(nbytes, ops, "bfloat16")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def kernel(q=q, k=k, v=v):
            return _flash_fwd_cuda(q, k, v, True, 0, 0)

        def sdpa(qt=qt, kt=kt, vt=vt):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=True)
        ms, dev = time_ms(kernel), device_ms(kernel)
        by_shape.append({
            "shape": [b, s, h, d], "max_abs_err": err, "ms": ms,
            "device_ms": dev, "tflops": ops / (ms / 1e3) / 1e12,
            "tflops_device": ops / (dev / 1e3) / 1e12,
            "bound_share": bound * 1e3 / ms,
            "bound_share_device": bound * 1e3 / dev,
            "plain_ms": time_ms(lambda: _mha_ref(q, k, v, True), reps=5),
            "library_ms": time_ms(sdpa), "library_device_ms": device_ms(sdpa),
            "bound_ms": bound * 1e3, "bound_by": by})
    planted = _fwd_planted_faults(*first)
    # the call with a PyTorch kernel beside it, so the window sees the
    # card (around ctypes launches alone the profiler saw nothing)
    names, tries = profiled_names(
        lambda: _flash_fwd_cuda(*first, True, 0, 0)[0].float().sum(),
        ("flash_fwd",), bool)
    bodies = _bodies(names)
    row = dict(by_shape[0], name="flash_fwd", route="cuda",
               source="veles_tpu_torch/csrc/flash_fwd.cu",
               replaces="veles_tpu/ops/attention.py:58", dtype="bfloat16",
               causal=True, body="+".join(b_ for b_, n_ in bodies.items()
                                          if n_),
               plain_of="_mha_ref", library_of="SDPA, is_causal",
               by_shape=by_shape, train_shape=by_shape[1],
               planted_faults=planted, profile_windows=tries)
    ok = (bodies == {"tensor_core": 1, "decode": 0, "fma": 0}
          and all(f["caught"] for f in planted.values())
          and all(r["max_abs_err"] <= BF16_TOL for r in by_shape))
    return row, ok


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
    names, tries = profiled_names(
        lambda: _flash_bwd(q, k, v, o, lse, do, True),
        ("flash_bwd_dq", "flash_bwd_dkv"),
        lambda seen: all(any(g + "_kernel" in n_ for n_ in seen)
                         for g in ("flash_bwd_dq", "flash_bwd_dkv")))
    report = dict(report, profile_windows=tries)

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
        bodies = _bodies({n_: c for n_, c in names.items()
                              if name + "_kernel" in n_})
        body = "+".join(b_ for b_, n_ in bodies.items() if n_)
        ok = ok and bodies == {"tensor_core": 1, "decode": 0, "fma": 0}
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
    MNIST, split (K split 2 over 20, split 8 over 9 K tiles), the
    autoencoder's (100, 100, 784) and 4096^3 shapes, and matmul at the
    fused step's backward products (:func:`_gemm_fused_cases`); each
    output element within its tolerance."""
    from veles_tpu_torch.ops import gemm
    cases = []
    shapes = ((37, 70, 50), (100, 784, 100), (100, 100, 10), (8, 20, 8),
              (30, 140, 30), (100, 100, 784), (GEMM_BIG, GEMM_BIG, GEMM_BIG))
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
                                  shape=[m, k, n],
                                  tile_split=list(gemm.plan(m, n, k)),
                                  activation=activation,
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
                            "kernel": "gd_dx+gd_dw(+bias)",
                            "shape": [m, k, n], **flags,
                            "errors": errors, "tol": list(tol),
                            "max_abs_err": max(e["max_abs_err"]
                                               for e in errors.values()),
                            "ok": all(e["outside_tol"] == 0
                                      for e in errors.values())})
    cases.extend(_gemm_fused_cases(device))
    cases.extend(_gemm_zoo_cases(device))
    gpu_sync()
    return cases


#: (M, K, N) and which operand is a transposed view in the fused f32
#: step's backward products (lower_specs' MatMul.backward): layer 1's
#: weight gradient x^T·δ (784, 100, 100) and layer 2's h^T·δ (100, 100,
#: 10) read a transposed view of A, layer 2's input gradient δ·W^T
#: (100, 10, 100) a transposed view of W
GEMM_FUSED_SHAPES = (((784, 100, 100), "a"), ((100, 100, 10), "a"),
                     ((100, 10, 100), "w"))


def _as_view(a, w, view):
    """``a``, ``w`` or both (``view`` "a", "w" or "aw") as the transposed
    view of a contiguous copy: the same values through the other
    strides."""
    if view and "a" in view:
        a = a.t().contiguous().t()
    if view and "w" in view:
        w = w.t().contiguous().t()
    return a, w


def _gemm_fused_cases(device):
    """The f32 body at the fused step's backward shapes and layouts
    (GEMM_FUSED_SHAPES), every activation × bias on/off, against the
    plain version within GEMM_TOL; its own stream of operands."""
    from veles_tpu_torch.ops import gemm
    rng = numpy.random.default_rng(SEED + 20)
    cases = []
    for (m, k, n), view in GEMM_FUSED_SHAPES:
        for activation in GEMM_ACTIVATIONS:
            for with_bias in (True, False):
                a, w, bias = _gemm_operands(rng, device, m, k, n)
                a, w = _as_view(a, w, view)
                bias = bias if with_bias else None
                report = _within(gemm.matmul(a, w, bias, activation),
                                 gemm._matmul_ref(a, w, bias, activation),
                                 GEMM_TOL)
                cases.append(dict(report, kernel="matmul",
                                  shape=[m, k, n], view=view,
                                  strides=[list(a.stride()),
                                           list(w.stride())],
                                  tile_split=list(gemm.plan(m, n, k)),
                                  activation=activation, bias=with_bias,
                                  tol=list(GEMM_TOL),
                                  ok=report["outside_tol"] == 0))
    return cases


#: the conv nets' fully-connected products: (M, K, N), which operand is a
#: transposed view, and the layer's activation for a forward product
#: (held with and without the bias) or None for a backward one
#: (MatMul.backward: no bias, no activation).  mnist_conv: 800→500 tanh
#: and 500→10 softmax at minibatch 100; AlexNet: fc6 9216→4096 and fc7
#: 4096→4096 strict relu, fc8 4096→1000 softmax, at batch 128; each
#: one's weight gradient x^T·δ (a transposed A) and input gradient δ·W^T
#: (a transposed W)
GEMM_ZOO_SHAPES = (
    ((100, 800, 500), None, "tanh"), ((100, 500, 10), None, "linear"),
    ((800, 100, 500), "a", None), ((100, 500, 800), "w", None),
    ((500, 100, 10), "a", None), ((100, 10, 500), "w", None),
    ((128, 9216, 4096), None, "strict_relu"),
    ((128, 4096, 4096), None, "strict_relu"),
    ((128, 4096, 1000), None, "linear"),
    ((9216, 128, 4096), "a", None), ((4096, 128, 4096), "a", None),
    ((4096, 128, 1000), "a", None),
    ((128, 4096, 9216), "w", None), ((128, 4096, 4096), "w", None),
    ((128, 1000, 4096), "w", None))


def _gemm_zoo_cases(device):
    """The f32 body at GEMM_ZOO_SHAPES against the plain version within
    GEMM_TOL (K up to 9216: on an H100 the largest error was 1.26e-5,
    each element inside 1e-5 + 1e-5·|plain|); its own stream of
    operands."""
    from veles_tpu_torch.ops import gemm
    rng = numpy.random.default_rng(SEED + 21)
    cases = []
    for (m, k, n), view, layer_activation in GEMM_ZOO_SHAPES:
        forward = layer_activation is not None
        variants = ([(layer_activation, True), (layer_activation, False)]
                    if forward else [(None, False)])
        for activation, with_bias in variants:
            a, w, bias = _gemm_operands(rng, device, m, k, n)
            a, w = _as_view(a, w, view)
            bias = bias if with_bias else None
            got = gemm.matmul(a, w, bias, activation)
            want = gemm._matmul_ref(a, w, bias, activation)
            report = _within(got, want, GEMM_TOL)
            cases.append(dict(
                report, kernel="matmul", shape=[m, k, n], view=view,
                layer="zoo forward" if forward else "zoo backward",
                tile_split=list(gemm.plan(m, n, k)),
                activation=activation, bias=with_bias, tol=list(GEMM_TOL),
                ok=report["outside_tol"] == 0))
    return cases


#: (batch, inputs, neurons) and (tile, split) the dw launch's bias step is
#: held on: the GD shapes of ``_gemm_cases`` at every configuration (K =
#: the batch: split 2 over 8 rows, split 8 over 7 K tiles of 100 and over
#: 2 of 30), and 4096^3 on the host rule's (the big tile)
GD_BIAS_SHAPES = ((37, 70, 50), (100, 784, 100), (100, 100, 10),
                  (8, 20, 8), (30, 140, 30))
GD_BIAS_CONFIGS = ((0, 1), (0, 2), (0, 4), (0, 8), (1, 1))


def _gd_bias_cases(rng, device):
    """dw with the bias step on every (tile, split), activation and
    storage layout: W, vW, b and vb against ``_gd_ref`` within the GEMM
    tolerance; a relaunch bit-equal; and the bias sums bit for bit
    against ``_bias_sum_plan_ref``, the plain model of their order, read
    as minus vb from a launch with inv_batch 1, lr 1, decay 0 and
    momentum 0 (delta from the plain version on the card).  Returns the
    case count, the failed cases and the worst error."""
    from veles_tpu_torch.ops import gemm
    configs = [(shape, ts) for shape in GD_BIAS_SHAPES
               for ts in GD_BIAS_CONFIGS]
    configs.append(((GEMM_BIG,) * 3, gemm.plan(GEMM_BIG, GEMM_BIG,
                                               GEMM_BIG)))
    failed, worst, count = [], 0.0, 0
    for (batch, f, n), tile_split in configs:
        big = batch == GEMM_BIG
        tol = GEMM_BIG_TOL if big else GEMM_TOL
        for activation in ("tanh",) if big else GEMM_ACTIVATIONS:
            for transposed in (False, True):
                x, y, eo, w, b, vw, vb = _gd_operands(
                    rng, device, batch, f, n, transposed, big)
                want = gemm._gd_ref(x, y, eo, w, b, vw, vb, *GD_HP,
                                    activation=activation,
                                    transposed=transposed)
                runs = []
                for _ in range(2):
                    params = [t.clone() for t in (w, vw, b, vb)]
                    gemm._gd_dw_cuda(x, eo, y, params[0], params[1],
                                     1.0 / batch, *GD_HP[0::2], activation,
                                     transposed, tile_split,
                                     bias=(params[2], params[3],
                                           *GD_HP[1::2]))
                    runs.append(params)
                errors = [_within(got, ref, tol) for got, ref in zip(
                    runs[0], (want[0], want[2], want[1], want[3]))]
                delta = eo * gemm._derivative(y, activation)
                model = gemm._bias_sum_plan_ref(delta, tile_split[1],
                                                tile_split[0])
                sums = vb.clone()
                gemm._gd_dw_cuda(x, eo, y, w.clone(), vw.clone(), 1.0,
                                 *GD_HP[0::2], activation, transposed,
                                 tile_split,
                                 bias=(b.clone(), sums, 1.0, 0.0, 0.0))
                case = {"shape": [batch, f, n],
                        "tile_split": list(tile_split),
                        "activation": activation, "transposed": transposed,
                        "outside_tol": sum(e["outside_tol"]
                                           for e in errors),
                        "bit_equal_relaunch": all(
                            torch.equal(p, q) for p, q in zip(*runs)),
                        "sums_equal_model": bool(torch.equal(-sums, model))}
                worst = max([worst] + [e["max_abs_err"] for e in errors])
                count += 1
                if case["outside_tol"] or not case["bit_equal_relaunch"] \
                        or not case["sums_equal_model"]:
                    failed.append(case)
    gpu_sync()
    return {"kernel": "gd_dw+bias", "cases": count, "failed": failed,
            "max_abs_err": worst, "ok": not failed}


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
    """Faults planted at the MNIST shapes, each of which the tolerance
    must report: in the kernels' inputs, the last K tile dropped from
    matmul, dx launched after dw, the last batch tile dropped from dw,
    and the last rank's K chunk dropped (K cut by it) from matmul (split
    8), dx and dw (split 4) at layer 1's shapes; and the two planted
    builds of dw's bias merge (the last rank's sums dropped, the update
    applied by two ranks) at layer 1's dw, on b and vb."""
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
    # the last rank's chunk: K ends where it began
    a, w, bias = _gemm_operands(rng, device, 100, 784, 100)
    split = gemm.plan(100, 100, 784)[1]
    cut = gemm.k_range(split - 1, split, 784)[0]
    faults["last_rank_chunk_dropped_from_matmul"] = dict(_within(
        gemm.matmul(a[:, :cut], w[:cut], bias, "tanh"),
        gemm._matmul_ref(a, w, bias, "tanh"), GEMM_TOL), split=split)
    x, y, eo, w, b, vw, vb = _gd_operands(rng, device, 100, 784, 100, False,
                                          False)
    want = gemm._gd_ref(x, y, eo, w, b, vw, vb, *GD_HP, activation="tanh")
    split = gemm.plan(100, 784, 100)[1]          # dx: K = the 100 neurons
    cut = gemm.k_range(split - 1, split, 100)[0]
    faults["last_rank_chunk_dropped_from_dx"] = dict(_within(
        gemm._gd_dx_cuda(eo[:, :cut].contiguous(), y[:, :cut].contiguous(),
                         w[:, :cut], "tanh", False), want[4], GEMM_TOL),
        split=split)
    split = gemm.plan(784, 100, 100)[1]          # dw: K = the batch of 100
    cut = gemm.k_range(split - 1, split, 100)[0]
    gemm._gd_dw_cuda(x[:cut], eo[:cut], y[:cut], w, vw, 1.0 / 100,
                     GD_HP[0], GD_HP[2], GD_HP[4], "tanh", False)
    faults["last_rank_chunk_dropped_from_dw"] = dict(_within(
        vw, want[2], GEMM_TOL), split=split)
    # the planted builds of the bias merge, at layer 1's dw (split 4)
    x, y, eo, w, b, vw, vb = _gd_operands(rng, device, 100, 784, 100, False,
                                          False)
    want = gemm._gd_ref(x, y, eo, w, b, vw, vb, *GD_HP, activation="tanh")
    for (source, fault), name in PLANTED_BUILDS.items():
        if source != "gemm":
            continue
        b1, vb1 = b.clone(), vb.clone()
        with planted(source, fault):
            gemm.gd_fused(x, y, eo, w.clone(), b1, vw.clone(), vb1, *GD_HP,
                          activation="tanh", need_err_input=False)
        faults[name] = dict(_within(torch.cat([b1, vb1]),
                                    torch.cat([want[1], want[3]]), GEMM_TOL),
                            split=split)
    gpu_sync()
    return {name: dict(report, caught=report["outside_tol"] > 0)
            for name, report in faults.items()}


def _gemm_timed(rng, device):
    """Each kernel's device time per call (:func:`device_ms`) at the
    MNIST shapes and at 4096^3, beside its bound and the device times of
    the plain version and of one PyTorch call; ``wrapper_ms`` is the
    median of 20 CUDA-event timings around one wrapper call.  The first
    shape listed for each kernel is one the main path gives it (layer 1;
    layer 2 for gd_dx).  gd_dw is timed as the main path launches it,
    with the bias step (``without_bias_ms``: the same launch without);
    gd_db, which rides in that launch, gives the time the bias step
    adds to it (``ms``: with minus without, ``carrier_ms``: with)."""
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
        tile_split = None                  # (M, K, N) of the product
        if name in ("matmul", "gd_dx"):
            tile_split = list(gemm.plan(shape[0], shape[2], shape[1]))
        elif name == "gd_dw":
            tile_split = list(gemm.plan(shape[1], shape[2], shape[0]))
        entry["by_shape"].append({
            "shape": shape, "tile_split": tile_split,
            "ms": ms, "wrapper_ms": wrapper_ms,
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
        bias = (b1, vb1, *GD_HP[1::2])
        gemm._gd_dw_cuda(x, eo, y, w1, vw1, 1.0 / batch, *GD_HP[0::2], act,
                         False, bias=bias)
        dw_err = max(_within(w1, want[0], tol)["max_abs_err"],
                     _within(vw1, want[2], tol)["max_abs_err"])
        db_err = max(_within(b1, want[1], tol)["max_abs_err"],
                     _within(vb1, want[3], tol)["max_abs_err"])

        # timed on copies, so the repeated in-place updates stay in range
        def dw(with_bias=True):
            gemm._gd_dw_cuda(x, eo, y, w1, vw1, 1.0 / batch, *GD_HP[0::2],
                             act, False, bias=bias if with_bias else None)
        reps = 5 if big else 20
        alone = device_ms(lambda: dw(False), reps)
        times = timed(dw, plain, lambda: torch.mm(x.t(), delta), big)
        row("gd_dw", [batch, f, n], times,
            4 * (batch * f + 2 * batch * n + 2 * f * n + 4 * n)
            + 4 * 2 * f * n, 2 * batch * f * n + batch * n,
            max(dw_err, db_err), "_gd_ref, the whole step",
            "torch.mm(x^T, delta)")
        rows["gd_dw"]["by_shape"][-1]["without_bias_ms"] = alone
        row("gd_db", [batch, n],
            (times[0] - alone, None, times[2],
             device_ms(lambda: delta.sum(0), reps)),
            4 * (2 * batch * n + 2 * n) + 4 * 2 * n, 2 * batch * n, db_err,
            "_gd_ref, the whole step", "delta.sum(0)")
        rows["gd_db"]["by_shape"][-1].update(
            rides_in="gd_dw", carrier_ms=times[0], without_bias_ms=alone)
    gpu_sync()
    timed = []
    for name in ("matmul", "gd_dx", "gd_dw", "gd_db"):
        entry = rows[name]
        main = entry["by_shape"][0]       # the main path's shape
        entry.update({key: main[key] for key in (
            "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err", "without_bias_ms", "carrier_ms")
            if key in main})
        timed.append(entry)
    # the bias step has no launch of its own: its launches are the dw
    # launches that carried it
    rows["gd_db"].update(
        counted_as="gd_db_in_dw",
        rides_in="veles_gd_dw (veles_gemm_kernel<2|3, TILE>): the bias "
                 "epilogue of the dw launch; ms is the device time it adds")
    return timed


def _gemm_layout_case(rng, device):
    """matmul through a transposed view of (N, K) weights and through its
    contiguous copy, at MNIST's layer 1 (100, 784, 100) tanh: bit for
    bit, as the plain version gives the same bits from either storage."""
    from veles_tpu_torch.ops import gemm
    a = torch.from_numpy(rng.standard_normal((100, 784)).astype(
        numpy.float32)).to(device)
    w_nk = torch.from_numpy((rng.standard_normal((100, 784)) / 28.0).astype(
        numpy.float32)).to(device)
    report = _exact(gemm.matmul(a, w_nk.t(), None, "tanh"),
                    gemm.matmul(a, w_nk.t().contiguous(), None, "tanh"))
    gpu_sync()
    return dict(report, kernel="matmul", shape=[100, 784, 100],
                check="transposed_view_equals_contiguous_copy",
                ok=report["exact"])


def _gemm_kernels(device):
    """The ``kernels`` phase's GEMM half: cases, repeatability, planted
    faults and timings of the four kernels of csrc/gemm.cu."""
    rng = numpy.random.default_rng(SEED + 3)
    cases = _gemm_cases(rng, device)
    cases.append(_gd_bias_cases(rng, device))
    cases.append(_gemm_layout_case(rng, device))
    repeatable = _gemm_repeatable(rng, device)
    planted = _gemm_planted_faults(rng, device)
    timed = _gemm_timed(rng, device)
    ok = (all(c["ok"] for c in cases) and repeatable
          and all(f["caught"] for f in planted.values()))
    return {"cases": cases, "bit_equal_relaunch": repeatable,
            "planted_faults": planted}, timed, ok


# -- the bf16 bodies of the GEMM (csrc/gemm_bf16.cu veles_matmul_bf16) ------

#: bf16 products against the plain version (the f32 product of the same
#: bf16 operands, rounded once): within one bf16 ulp (2^-7 relative) and
#: 2^-8 absolute, for outputs near 0 that another f32 summation order
#: rounds to the other side
BF16_GEMM_TOL = (2.0 ** -8, 2.0 ** -7)
#: AlexNet's fully-connected layers' activations: strict relu (fc6, fc7)
#: and linear (a backward product: no bias, no activation)
ALEXNET_FC_ACTIVATIONS = ("strict_relu", None)
#: (M, K, N), which operand is a transposed view ("a", "w" or both:
#: "aw"), and the activations held there, each with and without the
#: bias: a ragged shape and the fused MNIST step's products (layer 1's
#: forward, its weight gradient a^T·δ through a transposed view of a, the
#: (100, 100, 10) layer-2 product) at every activation; AlexNet's bf16
#: products at batch 128 (fc6 9216 -> 4096 and fc7 4096 -> 4096: each
#: forward, input gradient δ·W^T through W's transposed view and weight
#: gradient x^T·δ through x's) at its layers' two; 4096^3
GEMM_BF16_SHAPES = (
    ((37, 70, 50), "a", GEMM_ACTIVATIONS),
    ((100, 784, 100), None, GEMM_ACTIVATIONS),
    ((784, 100, 100), "a", GEMM_ACTIVATIONS),
    ((100, 100, 10), "w", GEMM_ACTIVATIONS),
    ((128, 9216, 4096), None, ALEXNET_FC_ACTIVATIONS),
    ((128, 4096, 9216), "w", ALEXNET_FC_ACTIVATIONS),
    ((9216, 128, 4096), "a", ALEXNET_FC_ACTIVATIONS),
    ((128, 4096, 4096), None, ALEXNET_FC_ACTIVATIONS),
    ((128, 4096, 4096), "w", ALEXNET_FC_ACTIVATIONS),
    ((4096, 128, 4096), "a", ALEXNET_FC_ACTIVATIONS),
    ((GEMM_BIG,) * 3, None, GEMM_ACTIVATIONS))
#: ragged shapes whose operands' row pitches are multiples of 16 bytes in
#: every layout, held in each of the four layout pairs (a K- or M-major,
#: w N- or K-major), and whether body W splits K there: (200, 328, 264)
#: at split 4 (the rank-order reduction), (2000, 72, 2200) unsplit on
#: 128 x 256 tiles (the persistent walk and the TMA stores)
GEMM_BF16_RAGGED = (((200, 328, 264), True), ((2000, 72, 2200), False))
GEMM_BF16_LAYOUTS = (None, "a", "w", "aw")
#: body W unsplit where TMA cannot store the output (a pitch of 2201
#: bf16): the epilogue copies its staged rows out itself
GEMM_BF16_ODD_PITCH = ((2000, 72, 2201), "w")
#: views with an unaligned base, which TMA cannot describe: a = a'[:, 1:]
#: of a (100, 785) a' (2-byte base, odd pitch: element loads) and w =
#: w'[1:] of a (785, 100) w' (200-byte base: 8-byte copies)
GEMM_BF16_UNALIGNED = (100, 784, 100)
#: the shapes timed, (M, K, N), activation, which operand is a transposed
#: view, and the product's name: the fused MNIST step's bf16 products
#: (layer 1's forward, its weight gradient a^T·δ) and the (100, 100, 10)
#: layer-2 product; AlexNet's bf16 fc6 and fc7 at batch 128, each one's
#: forward, input gradient δ·W^T and weight gradient a^T·δ; 4096^3
GEMM_BF16_TIMED = (
    ((100, 784, 100), "tanh", None, "mnist_fwd"),
    ((784, 100, 100), None, "a", "mnist_dw"),
    ((100, 100, 10), None, None, "mnist_layer2"),
    ((128, 9216, 4096), "strict_relu", None, "fc6_fwd"),
    ((128, 4096, 9216), None, "w", "fc6_dx"),
    ((9216, 128, 4096), None, "a", "fc6_dw"),
    ((128, 4096, 4096), "strict_relu", None, "fc7_fwd"),
    ((128, 4096, 4096), None, "w", "fc7_dx"),
    ((4096, 128, 4096), None, "a", "fc7_dw"),
    ((GEMM_BIG,) * 3, None, None, "big"))
#: the bodies each shape must take: (body name, split above 1 or not)
#: by GEMM_BF16_TIMED name; MNIST's 200-byte row pitches take body S
GEMM_BF16_BODIES = {"mnist_fwd": ("ldmatrix", True),
                    "mnist_dw": ("ldmatrix", True),
                    "mnist_layer2": ("ldmatrix", True),
                    "fc6_fwd": ("wgmma", True), "fc6_dx": ("wgmma", False),
                    "fc6_dw": ("wgmma", False), "fc7_fwd": ("wgmma", True),
                    "fc7_dx": ("wgmma", True), "fc7_dw": ("wgmma", False),
                    "big": ("wgmma", False)}
#: a call whose operands and output pass this many bytes is timed on
#: copies cycled so that the bytes between two calls on one copy pass the
#: 50 MB L2 three times: a training step reads W from device memory
BF16_COLD_BYTES = 8 << 20


def _bf16_operands(rng, device, m, k, n, view=None):
    """bf16 a (m, k), w (k, n) scaled by 1/sqrt(k) and bias (n,), drawn on
    ``device`` by a generator seeded from ``rng`` (numpy would take
    seconds a product at AlexNet's sizes); ``view`` as _as_view."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    a = torch.randn((m, k), generator=gen, device=device)
    w = torch.randn((k, n), generator=gen, device=device) * k ** -0.5
    bias = torch.randn((n,), generator=gen, device=device)
    a, w = _as_view(a.bfloat16(), w.bfloat16(), view)
    return a, w, bias.bfloat16()


def _bf16_plan(a, w):
    """``gemm.plan_bf16`` of the product ``a @ w``: (body name, tile,
    split)."""
    from veles_tpu_torch.ops import gemm
    body, tile, split = gemm.plan_bf16(
        a.shape[0], w.shape[1], a.shape[1],
        (a.stride(0), a.stride(1), w.stride(0), w.stride(1)),
        (a.data_ptr(), w.data_ptr()))
    return gemm.BF16_BODIES[body], tile, split


def _bf16_case(a, w, bias, activation, **info):
    """One launch against the plain version and against the plain model
    of the body's split sum, within BF16_GEMM_TOL."""
    from veles_tpu_torch.ops import gemm
    body, tile, split = _bf16_plan(a, w)
    got = gemm.matmul(a, w, bias, activation)
    report = _within(got, gemm._matmul_ref(a, w, bias, activation),
                     BF16_GEMM_TOL)
    model = _within(got, gemm._matmul_bf16_split_ref(a, w, bias, activation,
                                                      split), BF16_GEMM_TOL)
    return dict(report, kernel="matmul_bf16", shape=[a.shape[0], a.shape[1],
                                                     w.shape[1]],
                strides=[list(a.stride()), list(w.stride())],
                activation=activation, bias=bias is not None, body=body,
                tile=tile, split=split,
                split_model_max_abs_err=model["max_abs_err"],
                dtype=str(got.dtype), tol=list(BF16_GEMM_TOL),
                ok=report["outside_tol"] == 0 and model["outside_tol"] == 0
                and got.dtype == torch.bfloat16, **info)


def _gemm_bf16_cases(device):
    """Every case of the bf16 bodies: GEMM_BF16_SHAPES, the ragged shape
    in each layout pair on body W at split > 1, and the unaligned views
    on body S; each case checks the body it must take."""
    rng = numpy.random.default_rng(SEED + 19)
    cases = []
    for (m, k, n), view, activations in GEMM_BF16_SHAPES:
        for activation in activations:
            for with_bias in (True, False):
                a, w, bias = _bf16_operands(rng, device, m, k, n, view)
                cases.append(_bf16_case(a, w, bias if with_bias else None,
                                        activation, view=view))
        torch.cuda.empty_cache()
    for (m, k, n), split in GEMM_BF16_RAGGED:
        for view in GEMM_BF16_LAYOUTS:
            for activation in GEMM_ACTIVATIONS:
                for with_bias in (True, False):
                    a, w, bias = _bf16_operands(rng, device, m, k, n, view)
                    case = _bf16_case(a, w, bias if with_bias else None,
                                      activation, view=view,
                                      check="layout_pair")
                    case["ok"] = (case["ok"] and case["body"] == "wgmma"
                                  and (case["split"] > 1) == split)
                    cases.append(case)
    (m, k, n), view = GEMM_BF16_ODD_PITCH
    for activation in GEMM_ACTIVATIONS:
        for with_bias in (True, False):
            a, w, bias = _bf16_operands(rng, device, m, k, n, view)
            case = _bf16_case(a, w, bias if with_bias else None, activation,
                              view=view, check="odd_output_pitch")
            case["ok"] = (case["ok"] and case["body"] == "wgmma"
                          and case["split"] == 1)
            cases.append(case)
    m, k, n = GEMM_BF16_UNALIGNED
    for activation in GEMM_ACTIVATIONS:
        for with_bias in (True, False):
            a, w, bias = _bf16_operands(rng, device, m, k + 1, n)
            _, w, _ = _bf16_operands(rng, device, 1, k + 1, n)
            a, w = a[:, 1:], w[1:]
            case = _bf16_case(a, w, bias if with_bias else None, activation,
                              view="a[:, 1:], w[1:]",
                              base_offsets=[a.data_ptr() % 16,
                                            w.data_ptr() % 16],
                              check="unaligned_base")
            case["ok"] = case["ok"] and case["body"] == "ldmatrix"
            cases.append(case)
    return cases


def _gemm_bf16_repeatable(device):
    """A relaunch is bit-equal on each body: body W at split 4 (the ragged
    shape) and 2 (AlexNet's fc6 forward) and unsplit (the persistent
    walk), body S at split 8 (MNIST's layer 1)."""
    from veles_tpu_torch.ops import gemm
    rng = numpy.random.default_rng(SEED + 23)
    out = {}
    for name, (m, k, n), act in (
            ("wgmma_ragged", GEMM_BF16_RAGGED[0][0], "tanh"),
            ("wgmma_unsplit", GEMM_BF16_RAGGED[1][0], "tanh"),
            ("wgmma_fc6_fwd", (128, 9216, 4096), "strict_relu"),
            ("ldmatrix_mnist_fwd", (100, 784, 100), "tanh")):
        a, w, bias = _bf16_operands(rng, device, m, k, n)
        body, tile, split = _bf16_plan(a, w)
        first = gemm.matmul(a, w, bias, act)
        out[name] = {"body": body, "tile": tile, "split": split,
                     "bit_equal": all(torch.equal(first, gemm.matmul(
                         a, w, bias, act)) for _ in range(3))}
    return out


def _bf16_copies(m, k, n):
    """Copies of a product's operands to cycle when timing it: enough for
    its bytes to pass the L2 three times between two calls on a copy."""
    nbytes = 2 * (m * k + k * n + n + m * n)
    return 1 if nbytes <= BF16_COLD_BYTES else max(
        2, -(-3 * (50 << 20) // nbytes))


def _gemm_bf16_timed(device):
    """Device time of each GEMM_BF16_TIMED product on the body its plan
    picks (on cycled copies where its bytes pass BF16_COLD_BYTES), one
    wrapper call's event time, the plain version's and ``torch.addmm``'s
    in bf16, beside the bound; and whether each took its body."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import gemm
    rng = numpy.random.default_rng(SEED + 29)
    rows = []
    for (m, k, n), act, view, name in GEMM_BF16_TIMED:
        copies = _bf16_copies(m, k, n)
        ops = [_bf16_operands(rng, device, m, k, n, view)
               for _ in range(copies)]
        a, w, bias = ops[0]
        body, tile, split = _bf16_plan(a, w)
        reps = max(5 if m == GEMM_BIG else 20, copies)

        def timed(call):
            if copies == 1:
                return device_ms(lambda: call(*ops[0]), reps)
            return cold_device_ms([lambda o=o: call(*o) for o in ops], reps)
        err = _within(gemm.matmul(a, w, bias, act),
                      gemm._matmul_ref(a, w, bias, act),
                      BF16_GEMM_TOL)["max_abs_err"]
        bound, by = bound_seconds(2 * (m * k + k * n + n + m * n),
                                  2 * m * n * k, "bfloat16")
        rows.append({
            "name": name, "shape": [m, k, n], "activation": act,
            "view": view, "body": body, "tile": tile, "split": split,
            "body_ok": (body, split > 1) == GEMM_BF16_BODIES[name],
            "copies": copies,
            "ms": timed(lambda a, w, b: gemm._matmul_cuda(a, w, b, act)),
            "wrapper_ms": time_ms(lambda: gemm._matmul_cuda(a, w, bias,
                                                            act)),
            "plain_ms": timed(lambda a, w, b: gemm._matmul_ref(a, w, b,
                                                               act)),
            "library_ms": timed(lambda a, w, b: torch.addmm(b, a, w)),
            "bound_ms": bound * 1e3, "bound_by": by, "max_abs_err": err})
        del ops
        torch.cuda.empty_cache()
    gpu_sync()
    return rows


def _gemm_bf16_kernels(device):
    """The bf16 bodies: their cases (_gemm_bf16_cases), a relaunch bit for
    bit on each body, and the device times at GEMM_BF16_TIMED beside the
    bf16 bound, the plain version's and ``torch.addmm``'s in bf16."""
    cases = _gemm_bf16_cases(device)
    repeatable = _gemm_bf16_repeatable(device)
    by_shape = _gemm_bf16_timed(device)
    main = by_shape[0]
    row = {"name": "matmul_bf16", "route": "cuda",
           "source": "veles_tpu_torch/csrc/gemm_bf16.cu",
           "replaces": "veles_tpu/ops/gemm.py:56", "dtype": "bfloat16",
           "entry": "veles_matmul_bf16", "plain_of": "_matmul_ref",
           "library_of": "torch.addmm in bf16 (no activation)",
           "by_shape": by_shape}
    row.update({key: main[key] for key in (
        "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "max_abs_err", "body", "split")})
    layouts = {(c["split"] > 1, c["view"]) for c in cases
               if c.get("check") == "layout_pair" and c["ok"]}
    ok = (all(c["ok"] for c in cases)
          and all(r["bit_equal"] for r in repeatable.values())
          and all(r["body_ok"] for r in by_shape)
          and layouts == {(split, view) for _s, split in GEMM_BF16_RAGGED
                          for view in GEMM_BF16_LAYOUTS})
    return {"cases": cases, "bit_equal_relaunch": repeatable,
            "bodies": {r["name"]: [r["body"], r["tile"], r["split"]]
                       for r in by_shape}}, [row], ok


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
    cases += _gather_group_cases(rng, device)
    cases += _gather_served_cases(rng, device)
    gpu_sync()
    return cases


def _gather_group_cases(rng, device):
    """Groups of one launch against their plain version, table by table,
    exactly: MNIST's eager and stitched minibatches (with negative and
    out-of-range indices), every table kind at once (a (50, 13) u8 table
    beside (7000, ...) ones: most indices out of its range), and four raw
    tables of 50 rows; each also replayed from a CUDA graph over outputs
    filled with 7, so a row left unwritten would show."""
    from veles_tpu_torch.ops import gather
    n, f, b = GATHER_MAIN
    f32 = _gather_table(rng, device, torch.float32, (n, f))
    u8 = _gather_table(rng, device, torch.uint8, (n, f))
    labels = _gather_table(rng, device, torch.int32, (n,))
    scalar = gather.affine_tensors((1.0 / 255.0, 0.0), device)
    per_feature = gather.affine_tensors(
        (rng.uniform(0.5, 2.0, f), rng.standard_normal(f)), device)
    small = [_gather_table(rng, device, dtype, shape)
             for dtype, shape in GATHER_TABLES[3:]]
    idx = _gather_indices(rng, device, n, b)
    idx_small = _gather_indices(rng, device, 50, b)
    groups = {
        "mnist_eager": ([(f32, 0), (labels, -1)], idx),
        "mnist_stitched": ([(u8, scalar), (labels, -1)], idx),
        "every_kind": ([(f32, 0), (u8, per_feature), (labels, -1),
                        (small[1], 255)], idx),
        "four_raw_of_50_rows": ([(t, pad) for t, pad in zip(
            small, (0, 255, -1, 3))], idx_small),
    }
    cases = []
    for name, (tables, index) in groups.items():
        want = gather._gather_group_ref(tables, index)
        for route, got in (("eager", gather.take_rows_group(tables, index)),
                           ("graph_replay",
                            _group_replayed(tables, index))):
            exact = [_exact(g, w) for g, w in zip(got, want)]
            cases.append({"kernel": "gather_group", "group": name,
                          "route": route, "tables": len(tables),
                          "max_abs_err": max(e["max_abs_err"]
                                             for e in exact),
                          "ok": all(e["exact"] for e in exact)})
    return cases


def _group_replayed(tables, idx):
    """The group launch captured in a CUDA graph and replayed over its
    outputs filled with 7: a row the kernel leaves unwritten keeps the
    7."""
    from veles_tpu_torch.ops import gather
    gather.take_rows_group(tables, idx)
    gpu_sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = gather.take_rows_group(tables, idx)
    for out in outs:
        out.fill_(7)
    graph.replay()
    gpu_sync()
    return outs


#: (offset, size) of the served cases over GATHER_MAIN's 7000-row buffer
#: and 100 rows: a whole batch, a short tail, one row, none, the buffer's
#: last row, a batch running 60 rows past the buffer's end, and an offset
#: at the end (every row a pad row)
GATHER_SERVED_SPANS = ((0, 100), (940, 60), (3, 1), (500, 0), (6999, 1),
                       (6960, 100), (7000, 100))


def _scalars(device, offset, size):
    """``offset`` and ``size`` as the segment's scalar block hands them
    over: 0-d int32 views of one device buffer."""
    block = torch.tensor([offset, size], dtype=torch.int32, device=device)
    return block, block[0], block[1]


def _gather_served_cases(rng, device):
    """The served entry (``take_rows_served``) against its plain version,
    ``_gather_served_ref``, exactly, at every GATHER_SERVED_SPANS over a
    shuffled permutation: the native head's u8 data normalized with the
    labels, the f32-dataset head's raw data with the labels, an int32
    and an f32 table normalized per feature, and the autoencoder's head
    (the f32 data and targets, raw); each group also captured
    once in a CUDA graph and replayed over outputs filled with 7 with
    the scalars rewritten in place between replays (a scalar read at
    capture, or a row left unwritten, would show)."""
    from veles_tpu_torch.ops import gather
    n, f, b = GATHER_MAIN
    shuffled = torch.from_numpy(rng.permutation(n).astype(
        numpy.int32)).to(device)
    labels = _gather_table(rng, device, torch.int32, (n,))
    per_feature = gather.affine_tensors(
        (rng.uniform(0.5, 2.0, f), rng.standard_normal(f)), device)
    groups = {
        "u8_normalized+labels": [
            (_gather_table(rng, device, torch.uint8, (n, f)),
             gather.affine_tensors((1.0 / 255.0, 0.0), device)),
            (labels, -1)],
        "f32_raw+labels": [
            (_gather_table(rng, device, torch.float32, (n, f)), 0),
            (labels, -1)],
        "int32_normalized+labels": [
            (_gather_table(rng, device, torch.int32, (n, f)), per_feature),
            (labels, -1)],
        "f32_normalized": [
            (_gather_table(rng, device, torch.float32, (n, f)),
             per_feature)],
        # the autoencoder's head: the data and its targets, both raw f32
        "f32_data+f32_targets": [
            (_gather_table(rng, device, torch.float32, (n, f)), 0),
            (_gather_table(rng, device, torch.float32, (n, f)), 0)],
    }
    cases = []
    for name, tables in groups.items():
        for offset, size in GATHER_SERVED_SPANS:
            _block, at, count = _scalars(device, offset, size)
            got = gather.take_rows_served(tables, shuffled, at, count, b)
            want = gather._gather_served_ref(tables, shuffled, at, count, b)
            exact = [_exact(g, w) for g, w in zip(got, want)]
            cases.append({"kernel": "gather_served", "group": name,
                          "route": "eager", "offset": offset, "size": size,
                          "max_abs_err": max(e["max_abs_err"]
                                             for e in exact),
                          "ok": all(e["exact"] for e in exact)})
        replays = _served_replayed(tables, shuffled, b)
        cases.append({"kernel": "gather_served", "group": name,
                      "route": "graph_replay",
                      "spans": [list(span) for span in GATHER_SERVED_SPANS],
                      "max_abs_err": max(e["max_abs_err"] for e in replays),
                      "ok": all(e["exact"] for e in replays)})
    return cases


def _served_replayed(tables, shuffled, count, spans=GATHER_SERVED_SPANS):
    """One served launch captured in a CUDA graph, replayed once a span
    with the scalars written into the captured block and the outputs
    filled with 7: each replay against the plain version."""
    from veles_tpu_torch.ops import gather
    device = shuffled.device
    block, at, size = _scalars(device, *spans[0])
    gather.take_rows_served(tables, shuffled, at, size, count)
    gpu_sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = gather.take_rows_served(tables, shuffled, at, size, count)
    reports = []
    for span in spans[::-1]:
        block.copy_(torch.tensor(span, dtype=torch.int32))
        for out in outs:
            out.fill_(7)
        graph.replay()
        want = gather._gather_served_ref(tables, shuffled, at, size, count)
        gpu_sync()
        exact = [_exact(g, w) for g, w in zip(outs, want)]
        reports.append({"max_abs_err": max(e["max_abs_err"] for e in exact),
                        "exact": all(e["exact"] for e in exact)})
    return reports


def _gather_repeatable(rng, device):
    from veles_tpu_torch.ops import gather
    data = _gather_table(rng, device, torch.uint8, GATHER_MAIN[:2])
    idx = _gather_indices(rng, device, GATHER_MAIN[0], GATHER_MAIN[2])
    norm = gather.affine_tensors((1.0 / 255.0, 0.0), device)
    labels = _gather_table(rng, device, torch.int32, GATHER_MAIN[:1])
    tables = [(data, norm), (labels, -1)]
    same = (torch.equal(gather.take_rows(data, idx),
                        gather.take_rows(data, idx))
            and torch.equal(gather.take_rows_norm(data, idx, norm),
                            gather.take_rows_norm(data, idx, norm))
            and all(torch.equal(p, q) for p, q in zip(
                gather.take_rows_group(tables, idx),
                gather.take_rows_group(tables, idx))))
    shuffled = torch.from_numpy(rng.permutation(GATHER_MAIN[0]).astype(
        numpy.int32)).to(device)
    _block, at, size = _scalars(device, 940, 60)
    same = same and all(torch.equal(p, q) for p, q in zip(
        gather.take_rows_served(tables, shuffled, at, size, GATHER_MAIN[2]),
        gather.take_rows_served(tables, shuffled, at, size, GATHER_MAIN[2])))
    gpu_sync()
    return same


def _gather_planted_faults(rng, device):
    """Faults planted at the main path's shape, each of which the exact
    check must report: in the inputs, every valid index off by one, and
    the negative indices given as 0 (a row not zeroed); and the kernel's
    three planted builds (the second table's rows taken at index + 1, a
    raw table's pad rows left unwritten: on the eager minibatch's group;
    row ``size`` served as valid: on the served launch of a 60-row tail)
    over f32 data and int32 labels, replayed from a graph over outputs
    filled with 7."""
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
    tables = [(_gather_table(rng, device, torch.float32, GATHER_MAIN[:2]), 0),
              (_gather_table(rng, device, torch.int32, GATHER_MAIN[:1]), -1)]
    want = gather._gather_group_ref(tables, idx)
    shuffled = torch.from_numpy(rng.permutation(GATHER_MAIN[0]).astype(
        numpy.int32)).to(device)
    tail = ((940, 60),)                  # a short tail: row 60 must pad
    for (source, fault), name in PLANTED_BUILDS.items():
        if source != "gather":
            continue
        with planted(source, fault):
            if fault == 3:
                faults[name] = _served_replayed(
                    tables, shuffled, GATHER_MAIN[2], tail)[0]
                continue
            got = _group_replayed(tables, idx)
        faults[name] = _exact(torch.cat([g.reshape(-1).float() for g in got]),
                              torch.cat([w.reshape(-1).float()
                                         for w in want]))
    gpu_sync()
    return {name: dict(report, caught=not report["exact"])
            for name, report in faults.items()}


def _gather_bytes(tables, idx, outs, extra=0, index_bytes=None):
    """Bytes a launch must move: the indices once (``index_bytes``, else
    the whole index vector), the rows of the valid indices of each table
    (this run's data), the outputs, and ``extra``."""
    total = (idx.numel() * idx.element_size() if index_bytes is None
             else index_bytes) + extra
    for data, out in zip(tables, outs):
        valid = int(((idx >= 0) & (idx < data.shape[0])).sum())
        total += (valid * data[0].numel() * data.element_size()
                  + out.numel() * out.element_size())
    return total


def _parent_head(tables, shuffled, at, size, count):
    """The stitched head as it stood before the served launch: five
    int32 ops of index arithmetic (``lt``, ``add``, ``where``,
    ``index_select``, ``where``; seven kernels, since each ``where``
    against a scalar first fills a tensor with it), then the group
    launch; the closures of each index op alone, and of the whole
    head."""
    from veles_tpu_torch.ops import gather
    pos = torch.arange(count, dtype=torch.int32, device=shuffled.device)
    valid = pos < size
    at_pos = pos + at
    picked = torch.where(valid, at_pos, 0)
    served = shuffled.index_select(0, picked)

    def head():
        v = pos < size
        got = shuffled.index_select(0, torch.where(v, pos + at, 0))
        return gather.take_rows_group(tables, torch.where(v, got, -1))
    ops = {"lt": lambda: pos < size, "add": lambda: pos + at,
           "where": lambda: torch.where(valid, at_pos, 0),
           "index_select": lambda: shuffled.index_select(0, picked),
           "where_pad": lambda: torch.where(valid, served, -1)}
    return ops, head


def _gather_timed(rng, device):
    """The gather kernels' device time per launch (:func:`device_ms`)
    as each route's minibatch makes it, beside the bound by bytes and
    the plain version's time.  Row ``gather`` (``_gather_kernel``): the
    eager route's group launch of f32 data and int32 labels
    (``library_ms`` is ``torch.index_select`` of the data table: one
    call gathers one table), each table alone, and 4096 rows of a
    (70000, 784) u8 table.  Row ``gather_norm``
    (``_gather_norm_kernel``): the stitched head's served launch of u8
    data normalized and the labels from a shuffled buffer at size 100
    (the main path's launch), at a 60-row tail, and 4096 rows of the
    (70000, 784) table with its labels; beside each, the head in its
    earlier form (five index ops, then the group launch: each op alone
    and the whole head) and the group launch alone at the
    same rows; and the group launch of the normalized data alone (no one
    PyTorch call normalizes).  Calls run back to back on the same
    operands, so rows a call reads may be in L2."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import gather
    rows = {}

    def entry_of(name):
        return rows.setdefault(name, {
            "name": name, "route": "cuda",
            "source": "veles_tpu_torch/csrc/gather.cu",
            "replaces": "veles_tpu/ops/gather.py:%d" % {
                "gather": 204, "gather_norm": 146}[name],
            "entry": {"gather": "veles_gather_group",
                      "gather_norm": "veles_gather_served"}[name],
            "plain_of": {"gather": "_gather_group_ref",
                         "gather_norm": "_gather_served_ref"}[name],
            "library_of": "torch.index_select of the data table"
            if name == "gather" else None,
            "rides_in": {
                "gather": "veles_gather_group: the eager fill's one launch "
                          "a minibatch of its data and labels; its raw "
                          "tables also ride in the stitched head's "
                          "veles_gather_served launch",
                "gather_norm": "veles_gather_served: the stitched head's "
                               "one launch a minibatch, which computes the "
                               "served index and gathers the normalized "
                               "data and the labels (counted under "
                               "gather_norm)"}[name],
            "by_shape": []})

    def row(name, label, tables, idx, library, extra=0, ops=0):
        outs = gather._gather_group_cuda(tables, idx)
        want = gather._gather_group_ref(tables, idx)
        err = max(_exact(o, w)["max_abs_err"] for o, w in zip(outs, want))
        bound, by = bound_seconds(
            _gather_bytes([t for t, _how in tables], idx, outs, extra), ops,
            "float32")
        entry_of(name)["by_shape"].append({
            "tables": label, "entry": "veles_gather_group",
            "ms": device_ms(lambda: gather._gather_group_cuda(tables, idx)),
            "wrapper_ms": time_ms(
                lambda: gather._gather_group_cuda(tables, idx)),
            "plain_ms": device_ms(
                lambda: gather._gather_group_ref(tables, idx)),
            "library_ms": device_ms(library) if library else None,
            "bound_ms": bound * 1e3, "bound_by": by, "max_abs_err": err})

    def served_row(label, tables, shuffled, offset, size, count, ops=0):
        _block, at, n = _scalars(device, offset, size)
        outs = gather._gather_served_cuda(tables, shuffled, at, n, count)
        want = gather._gather_served_ref(tables, shuffled, at, n, count)
        err = max(_exact(o, w)["max_abs_err"] for o, w in zip(outs, want))
        idx = gather._served_indices(shuffled, at, n, count)
        # the two scalars, the served part of the buffer, each table's
        # valid rows, the outputs, and the normalized table's scale and
        # shift
        bound, by = bound_seconds(_gather_bytes(
            [t for t, _how in tables], idx, outs, extra=8 + 8,
            index_bytes=4 * int((idx >= 0).sum())), ops, "float32")
        index_ops, head = _parent_head(tables, shuffled, at, n, count)
        parent = gather._gather_group_ref(
            tables, gather._served_indices(shuffled, at, n, count))
        head_exact = all(torch.equal(g, w) for g, w in zip(head(), parent))
        group_idx = idx.clone()
        entry_of("gather_norm")["by_shape"].append({
            "tables": label, "entry": "veles_gather_served",
            "offset": offset, "size": size, "count": count,
            "ms": device_ms(lambda: gather._gather_served_cuda(
                tables, shuffled, at, n, count)),
            "wrapper_ms": time_ms(lambda: gather._gather_served_cuda(
                tables, shuffled, at, n, count)),
            "plain_ms": device_ms(lambda: gather._gather_served_ref(
                tables, shuffled, at, n, count)),
            "library_ms": None,
            "bound_ms": bound * 1e3, "bound_by": by, "max_abs_err": err,
            "parent_head_ms": device_ms(head),
            "parent_head_exact": head_exact,
            "parent_index_kernels_ms": {
                op: device_ms(fn) for op, fn in index_ops.items()},
            "group_alone_ms": device_ms(
                lambda: gather._gather_group_cuda(tables, group_idx))})

    n, f, b = GATHER_MAIN
    idx = _gather_indices(rng, device, n, b, invalid=False)
    f32 = _gather_table(rng, device, torch.float32, (n, f))
    u8 = _gather_table(rng, device, torch.uint8, (n, f))
    labels = _gather_table(rng, device, torch.int32, (n,))
    norm = gather.affine_tensors((1.0 / 255.0, 0.0), device)
    shuffled = torch.from_numpy(rng.permutation(n).astype(
        numpy.int32)).to(device)
    row("gather", "(7000, 784) f32 + (7000,) int32 labels",
        [(f32, 0), (labels, -1)], idx,
        lambda: torch.index_select(f32, 0, idx))
    row("gather", "(7000, 784) f32", [(f32, 0)], idx,
        lambda: torch.index_select(f32, 0, idx))
    row("gather", "(7000,) int32 labels", [(labels, -1)], idx,
        lambda: torch.index_select(labels, 0, idx))
    served_row("(7000, 784) u8 normalized + (7000,) int32 labels, served "
               "from the shuffled buffer", [(u8, norm), (labels, -1)],
               shuffled, 1000, b, b, ops=2 * b * f)
    served_row("the same, a 60-row tail", [(u8, norm), (labels, -1)],
               shuffled, 940, 60, b, ops=2 * 60 * f)
    row("gather_norm", "(7000, 784) u8 normalized (the group launch)",
        [(u8, norm)], idx, None, extra=8, ops=2 * b * f)
    n, f, b = GATHER_BIG
    idx = _gather_indices(rng, device, n, b, invalid=False)
    big = _gather_table(rng, device, torch.uint8, (n, f))
    big_labels = _gather_table(rng, device, torch.int32, (n,))
    big_shuffled = torch.from_numpy(rng.permutation(n).astype(
        numpy.int32)).to(device)
    row("gather", "4096 of (70000, 784) u8", [(big, 0)], idx,
        lambda: torch.index_select(big, 0, idx))
    served_row("4096 of (70000, 784) u8 normalized + (70000,) int32 "
               "labels, served", [(big, norm), (big_labels, -1)],
               big_shuffled, n // 4, b, b, ops=2 * b * f)
    gpu_sync()
    timed = []
    for name in ("gather_norm", "gather"):
        entry = rows[name]
        main = entry["by_shape"][0]       # the main path's launch
        entry.update({key: main[key] for key in (
            "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err")})
        if name == "gather_norm":
            entry.update({key: main[key] for key in (
                "parent_head_ms", "group_alone_ms")})
        timed.append(entry)
    return timed


def _gather_kernels(device):
    """The ``kernels`` phase's gather half: cases, repeatability,
    planted faults and timings of csrc/gather.cu's group kernel, as
    ``_gather_kernel``'s and ``_gather_norm_kernel``'s rows."""
    rng = numpy.random.default_rng(SEED + 4)
    cases = _gather_cases(rng, device)
    repeatable = _gather_repeatable(rng, device)
    planted = _gather_planted_faults(rng, device)
    timed = _gather_timed(rng, device)
    ok = (all(c["ok"] for c in cases) and repeatable
          and all(f["caught"] for f in planted.values()))
    return {"cases": cases, "bit_equal_relaunch": repeatable,
            "planted_faults": planted}, timed, ok


# -- the decode kernel (csrc/decode_attn.cu, first entry) --------------------

#: the serving decode step: 4 slots x 16 heads of 64 against the 2048-row
#: cache, at lengths short, mid and full (a 5-row verify reaches 2048)
DECODE_SHAPE = dict(b=4, h=16, d=64, seq=2048)
DECODE_LENGTHS = [1, 17, 1000, 2048]
DECODE_SPLITS = (1, 2, 4, 8)
#: the cluster merge's body, by its profiled name.  Its name windows hold
#: 12 launches: late in this process a window around ctypes launches has
#: seen none of one launch three times over, and 1 of 4 (a fresh process
#: sees every one)
DECODE_BODY = "decode_kernel_split<"


def _decode_split_cases(rng, device):
    """The contiguous kernel at the serving shape under every split,
    f32 and bf16, decode and 5-row verify, against ``_decode_ref`` /
    ``_verify_ref`` (f32 <= 1e-4, bf16 <= 2e-2), and each relaunch
    bit-equal."""
    from veles_tpu_torch.ops.attention import (_decode_cuda, _decode_ref,
                                               _verify_ref)
    cases, same = [], True
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for nq, row_step in ((1, 0), (5, 1)):
            lengths = DECODE_LENGTHS[:-1] + [2048 - row_step * (nq - 1)]
            (q, k, v, lens), _err = _decode_case(rng, device, dtype, lengths,
                                                 nq, row_step)
            want = (_verify_ref if row_step else _decode_ref)(q, k, v, lens)
            for split in DECODE_SPLITS:
                out = _decode_cuda(q, k, v, lens, row_step, split)
                again = _decode_cuda(q, k, v, lens, row_step, split)
                gpu_sync()
                same = same and torch.equal(out, again)
                err = _max_err(out, want)
                cases.append({"kernel": "decode_attn",
                              "dtype": str(dtype)[6:], "q": [4, nq, 16, 64],
                              "lengths": lengths, "row_step": row_step,
                              "split": split, "max_abs_err": err,
                              "tol": tol, "ok": err <= tol})
    return cases, same


def _decode_planted_faults(rng, device):
    """The planted builds of decode_attn.cu (the last rank's partial
    dropped from the cluster merge; the last rank's acc taken without
    rescaling by its m) at the serving shape in f32, where the rule
    splits each row over 8 blocks: each must move the output past the
    f32 tolerance of the plain version."""
    from veles_tpu_torch.ops.attention import (_decode_cuda, _decode_ref,
                                               decode_split)
    (q, k, v, lens), _err = _decode_case(rng, device, torch.float32,
                                         DECODE_LENGTHS, 1, 0)
    want = _decode_ref(q, k, v, lens)
    split = decode_split(DECODE_SHAPE["b"] * DECODE_SHAPE["h"])
    out = {}
    for (source, fault), name in PLANTED_BUILDS.items():
        if source != "decode_attn":
            continue
        with planted(source, fault):
            got = _decode_cuda(q, k, v, lens, 0)
        err = _max_err(got, want)
        out[name] = {"max_abs_err": err, "tol": F32_TOL, "split": split,
                     "caught": err > F32_TOL}
    return out


def _decode_timed(rng, device):
    """The kernel at the serving decode step (bf16): one wrapper call's
    event time with L2 flushed (``ms``, the earlier rows' measure) and
    the device time a call on cold operands (:func:`cold_device_ms`),
    each beside SDPA with the length mask on the same measure; the plain
    version, the bound by bytes and its share, the split, and the body
    read from the profiled kernel names."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops.attention import (_decode_cuda, _decode_ref,
                                               decode_split)
    b, h, d, seq = (DECODE_SHAPE[x] for x in ("b", "h", "d", "seq"))
    (q, k, v, lens), err = _decode_case(rng, device, torch.bfloat16,
                                        DECODE_LENGTHS, 1, 0)
    nbytes = (2 * sum(DECODE_LENGTHS) * h * d * 2      # valid K and V rows
              + 2 * b * h * d * 2 + b * 4)
    bound, by = bound_seconds(nbytes, 4 * d * h * sum(DECODE_LENGTHS),
                              "bfloat16")
    mask = (torch.arange(seq, device=device)[None, :]
            < lens[:, None].long())[:, None, None, :]
    copies = [(k, v)] + [(k.clone(), v.clone())
                         for _ in range(COLD_COPIES - 1)]
    kernels = [lambda k=k_, v=v_: _decode_cuda(q, k, v, lens, 0)
               for k_, v_ in copies]
    sdpas = [lambda k=k_, v=v_: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask) for k_, v_ in copies]
    flush = make_l2_flush(device)
    dev, lib_dev = cold_device_ms(kernels), cold_device_ms(sdpas)
    names, tries = profiled_names(
        lambda: [fn().float().sum() for fn in kernels], ("decode_attn",),
        bool)
    row = {
        "name": "decode_attn", "route": "cuda",
        "source": "veles_tpu_torch/csrc/decode_attn.cu",
        "replaces": "veles_tpu/ops/attention.py:423",
        "q": [b, 1, h, d], "cache": [b, seq, h, d],
        "lengths": DECODE_LENGTHS, "dtype": "bfloat16", "max_abs_err": err,
        "ms": time_ms(kernels[0], flush=flush),
        "plain_ms": time_ms(lambda: _decode_ref(q, k, v, lens),
                            flush=flush),
        "library_ms": time_ms(sdpas[0], flush=flush),
        "device_ms": dev, "library_device_ms": lib_dev,
        "bound_ms": bound * 1e3, "bound_by": by,
        "bound_share_device": bound * 1e3 / dev,
        "split": decode_split(b * h),
        "body": "split" if names and all(DECODE_BODY in n_ for n_ in names)
        else "not the split body", "kernel_names": names,
        "profile_windows": tries, "library_of": "SDPA, length mask"}
    return row


def _decode_kernels(device):
    """The ``kernels`` phase's decode part: every split's cases, the
    relaunches, the planted builds and the timed row."""
    rng = numpy.random.default_rng(SEED + 7)
    cases, same = _decode_split_cases(rng, device)
    planted_faults = _decode_planted_faults(rng, device)
    row = _decode_timed(rng, device)
    ok = (all(c["ok"] for c in cases) and same
          and all(f["caught"] for f in planted_faults.values())
          and row["max_abs_err"] <= BF16_TOL and row["body"] == "split")
    return {"cases": cases, "bit_equal_relaunch": same,
            "planted_faults": planted_faults}, [row], ok


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
    contiguous kernel's bit for bit, f32 and bf16, decode and verify, at
    every split."""
    from veles_tpu_torch.ops.attention import (_decode_cuda,
                                               _paged_decode_cuda)
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
            for split in DECODE_SPLITS:
                paged = _paged_decode_cuda(q, kp, vp, tables, lens,
                                           row_step, split)
                contiguous = _decode_cuda(q, k, v, lens, row_step, split)
                gpu_sync()
                equal = bool(torch.equal(paged, contiguous))
                ok = ok and equal
                report.append({"dtype": str(dtype).replace("torch.", ""),
                               "nq": nq, "row_step": row_step,
                               "split": split, "bit_equal": equal})
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
    and the bound by bytes: one wrapper call's event time with L2 flushed
    and the device time a call on cold operands (:func:`cold_device_ms`),
    the split and the body read from the profiled kernel names."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops.attention import (_decode_cuda,
                                               _paged_decode_cuda,
                                               _paged_decode_ref,
                                               decode_split)
    sh = PAGED_SHAPE
    b, h, d, bs, mb = sh["b"], sh["h"], sh["d"], sh["bs"], sh["max_blocks"]
    flush = make_l2_flush(device)
    row = {"name": "paged_decode_attn", "route": "cuda",
           "source": "veles_tpu_torch/csrc/decode_attn.cu",
           "replaces": "veles_tpu/ops/attention.py:597",
           "q": [b, 1, h, d], "pool": [sh["num_blocks"], bs, h, d],
           "tables": [b, mb], "lengths": PAGED_TIMED_LENGTHS,
           "dtype": "bfloat16", "library_ms": None,
           "library_device_ms": None, "split": decode_split(b * h),
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
        copies = [(kp, vp, k, v)] + [
            (kp.clone(), vp.clone(), k.clone(), v.clone())
            for _ in range(COLD_COPIES - 1)]
        dev = cold_device_ms([
            lambda kp=c[0], vp=c[1]: _paged_decode_cuda(
                q, kp, vp, tables, lens, row_step) for c in copies])
        contiguous_dev = cold_device_ms([
            lambda k=c[2], v=c[3]: _decode_cuda(q, k, v, lens, row_step)
            for c in copies])
        del copies
        row.update({
            tag + "device_ms": dev, tag + "contiguous_device_ms":
            contiguous_dev, tag + "bound_share_device": bound * 1e3 / dev,
            tag + "max_abs_err": err,
            tag + "ms": time_ms(lambda: _paged_decode_cuda(*args, row_step),
                                flush=flush),
            tag + "contiguous_ms": time_ms(
                lambda: _decode_cuda(q, k, v, lens, row_step), flush=flush),
            tag + "plain_ms": time_ms(
                lambda: _paged_decode_ref(*args, row_step), flush=flush),
            tag + "bound_ms": bound * 1e3, tag + "bound_by": by})
    names, tries = profiled_names(
        lambda: [_paged_decode_cuda(*args, 1).float().sum()
                 for _ in range(COLD_COPIES)], ("paged_decode_attn",), bool)
    row.update(body="split" if names and all(DECODE_BODY in n_
                                             for n_ in names)
               else "not the split body", kernel_names=names,
               profile_windows=tries)
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
          and row["verify_max_abs_err"] <= BF16_TOL
          and row["body"] == "split")
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
QMM_TILE_K = 64                  # BK of csrc/qgemm.cu's decode and FMA bodies


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
                          split=qgemm.split_k(m, n, k, dtype)))

    def plans(m, k, n):
        """The decode body at every column tile and split, bf16, a bias
        and gelu, each relaunch bit-equal."""
        a, q, scale, b = _qmm_operands(rng, device, m, k, n, torch.bfloat16)
        want = qgemm._qmatmul_ref(a, q, scale, b, "gelu")
        for plan in [(bn, s_) for bn in qgemm.DECODE_BLOCK_N
                     for s_ in (1, 2, 4, 8)]:
            got = qgemm._qmatmul_cuda(a, q, scale, b, "gelu",
                                      torch.bfloat16, plan)
            again = qgemm._qmatmul_cuda(a, q, scale, b, "gelu",
                                        torch.bfloat16, plan)
            gpu_sync()
            cases.append(dict(_qmm_err(got, want, torch.bfloat16),
                              kernel="qmatmul", shape=[m, k, n],
                              dtype="bfloat16", bias=True, activation="gelu",
                              plan=list(plan),
                              bit_equal_relaunch=torch.equal(got, again)))

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
    for m, k, n in ((QMM_DECODE_M, 1024, 1024), (16, 4096, 1024),
                    (5, 200, 130)):
        plans(m, k, n)
    gpu_sync()
    for c in cases:
        c["ok"] = c["ok"] and c.get("bit_equal_relaunch", True)
    return cases


def _qgemm_planted_faults(rng, device):
    """Faults planted at the decode shape of wqkv (split 8), each of which
    the tolerance must report: in the kernel's inputs, the scales
    shuffled and the last K tile dropped; in the planted builds of the
    decode body, the last rank's K chunk dropped from the cluster sum and
    the scale applied twice."""
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
    for (source, fault), name in PLANTED_BUILDS.items():
        if source == "qgemm":
            with planted(source, fault):
                faults[name] = dict(_qmm_err(qgemm.qmatmul(a, q, scale),
                                             want, torch.bfloat16),
                                    split=qgemm.split_k(m, n, k,
                                                        torch.bfloat16))
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
    prefill bucket (M = 2048), bf16: median of 20 CUDA-event timings of
    one wrapper call beside the bound, the plain version and one library
    call (torch.mm, or addmm with the bias, on a dequantized bf16 copy,
    then gelu where the model fuses it); also the device time per call,
    at M = 2048 back to back (:func:`device_ms`), at decode each call on
    its own copy of the weights (:func:`cold_device_ms`), for the kernel
    and the library call.  The row's headline is one prefill layer, the
    sum of the four M = 2048 calls; one decode layer, the sum of the four
    decode calls, stands beside it with its plans (column tile, split).
    The body each M ran is read from the kernels' names in a profile of
    that M's calls."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import qgemm
    flush = make_l2_flush(device)
    by_shape, calls = [], []
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

            def kernel(a=a, q=q, scale=scale, b=b, activation=activation):
                return qgemm._qmatmul_cuda(a, q, scale, b, activation,
                                           dtype)
            calls.append(kernel)
            nbytes = _qmm_bytes(m, k, n, dtype, has_bias)
            bound, by = bound_seconds(nbytes, 2 * m * k * n, "bfloat16")
            cold = flush if by == "bytes" else None
            entry = {
                "weight": label, "shape": [m, k, n], "dtype": "bfloat16",
                "bias": has_bias, "activation": activation,
                "split": qgemm.split_k(m, n, k, dtype),
                "block_n": qgemm.decode_plan(n, k)[0]
                if m <= 16 else qgemm.TC_TILE[1],
                "ms": time_ms(kernel, flush=cold),
                "plain_ms": time_ms(lambda: qgemm._qmatmul_ref(
                    a, q, scale, b, activation), flush=cold),
                "library_ms": time_ms(library, flush=cold),
                "bound_ms": bound * 1e3, "bound_by": by,
                "max_abs_err": err}
            if m == QMM_PREFILL_M:
                entry["device_ms"] = device_ms(kernel)
                entry["tflops_device"] = 2 * m * k * n / entry[
                    "device_ms"] / 1e9
                entry["library_device_ms"] = device_ms(library)
            else:
                copies = [(q, wd)] + [(q.clone(), wd.clone())
                                      for _ in range(COLD_COPIES - 1)]
                entry["device_ms"] = cold_device_ms([
                    lambda q=q_, kernel=kernel: kernel(q=q)
                    for q_, _w in copies])
                entry["library_device_ms"] = cold_device_ms([
                    lambda wd=w_, library=library: library(wd=wd)
                    for _q, w_ in copies])
                del copies
            entry["bound_share_device"] = bound * 1e3 / entry["device_ms"]
            by_shape.append(entry)
    gpu_sync()
    # each M's four calls in a window of their own, beside a PyTorch
    # kernel so the window sees the card: at decode the decode body, at
    # M = 2048 the tensor-core body, and no other.  A window may see only
    # some of the launches (the serving windows see every one), so a body
    # counts as named when the profile saw it at least once and saw no
    # other body
    bodies, tries, named = {}, {}, {}
    for key, want, part in (("decode", "decode", calls[:4]),
                            ("prefill", "tensor_core", calls[4:])):
        names, tries[key] = profiled_names(
            lambda part=part: [fn().float().sum() for fn in part],
            ("qmatmul",), bool)
        bodies[key] = _bodies(names)
        named[key] = bodies[key][want] > 0 and sum(bodies[key].values()) \
            == bodies[key][want]

    def layer(m):
        calls_m = [e for e in by_shape if e["shape"][0] == m]
        out = {key: sum(e[key] for e in calls_m)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                           "device_ms", "library_device_ms")}
        out["max_abs_err"] = max(e["max_abs_err"] for e in calls_m)
        out["bound_share_device"] = out["bound_ms"] / out["device_ms"]
        return out
    prefill = layer(QMM_PREFILL_M)
    row = dict(prefill, name="qmatmul", route="cuda",
               source="veles_tpu_torch/csrc/qgemm.cu",
               replaces="veles_tpu/ops/qgemm.py:57", dtype="bfloat16",
               shape="one prefill layer: the 4 calls at M=%d (wqkv, wo, "
               "w1, w2)" % QMM_PREFILL_M, bound_by="operations",
               body="tensor_core" if named["prefill"]
               else "not the tensor cores",
               decode_layer=dict(layer(QMM_DECODE_M), bound_by="bytes",
                                 shape="the 4 calls at M=%d"
                                 % QMM_DECODE_M, body="decode"
                                 if named["decode"]
                                 else "not the decode body",
                                 plans=[[e["block_n"], e["split"]]
                                        for e in by_shape
                                        if e["shape"][0] == QMM_DECODE_M]),
               plain_of="_qmatmul_ref",
               library_of="torch.mm / addmm on a dequantized bf16 copy, "
               "then the epilogue", by_shape=by_shape,
               profile_windows=tries)
    return row, bodies, all(named.values())


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
    # the tensor-core body, unsplit and split
    for m, n in ((QMM_PREFILL_M, 4096), (256, 1024)):
        a, q, scale, b = _qmm_operands(rng, device, m, 1024, n,
                                       torch.bfloat16)
        repeatable = repeatable and torch.equal(
            qgemm.qmatmul(a, q, scale, b, "gelu"),
            qgemm.qmatmul(a, q, scale, b, "gelu"))
    planted = _qgemm_planted_faults(rng, device)
    row, bodies, named = _qgemm_timed(rng, device)
    ok = (all(c["ok"] for c in cases) and repeatable
          and all(f["caught"] for f in planted.values()) and named)
    return {"cases": cases, "bit_equal_relaunch": repeatable,
            "planted_faults": planted, "bodies": bodies}, [row], ok


# -- the reduction (csrc/reduce.cu) ------------------------------------------

REDUCE_BIG = (4096, 4096)
REDUCE_SHAPES = (REDUCE_BIG, (37, 53), (24, 256), (1, 5000), (5000, 1))
REDUCE_SPLITS = (1, 2, 4, 8)
REDUCE_SUM_RTOL = 1e-6
REDUCE_BLOCK = 512               # the Pallas kernel's rows (columns) a block
#: copies of the (4096, 4096) matrix a reduction's device time cycles
#: through: 256 MiB, five times L2, between two calls on one copy
REDUCE_COPIES = 4
#: the reduce kernels' profiled names (``reduce_rows_kernel`` and
#: ``reduce_cols_kernel`` were an earlier body's)
REDUCE_BODIES = ("reduce_axis0_kernel", "reduce_axis1_kernel")


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


def _model_bits(got, model):
    """The kernel's result equals its plain model's (NaN alike)."""
    g, w = got.float().cpu(), model.float().cpu()
    nan = torch.isnan(w)
    return bool(torch.equal(torch.isnan(g), nan)
                and torch.equal(g[~nan], w[~nan]))


def _reduce_cases(rng, device):
    """Every shape, dtype, op and axis at the plan's split; every split
    at (4096, 4096) with ±inf and NaN (the sums also against the plain
    model of the kernel's order, bit for bit); row strides past n, 16-byte
    aligned and not."""
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
                            split=reduce.launch_plan(a, axis).split,
                            nan_inf=specials and min(shape) > 1))
    a = _reduce_matrix(rng, device, REDUCE_BIG, torch.float32, True)
    for split in REDUCE_SPLITS:
        for op in ("sum", "max", "min"):
            for axis in (0, 1):
                got = reduce._reduce_cuda(a, axis, op, split)
                report = _reduce_agree(got, reduce._reduce_ref(a, axis, op),
                                       a, op, axis)
                if op == "sum":
                    report["model_bits"] = _model_bits(
                        got, reduce._reduce_plan_ref(
                            a, axis, op, reduce.launch_plan(a, axis, split)))
                    report["ok"] = report["ok"] and report["model_bits"]
                cases.append(dict(report, kernel="reduce",
                                  shape=list(REDUCE_BIG), dtype="float32",
                                  op=op, axis=axis, split=split,
                                  forced_split=True, nan_inf=True))
    for cols, n in ((1032, 1000), (1031, 1000)):
        for dtype in (torch.float32, torch.bfloat16):
            wide = _reduce_matrix(rng, device, (300, cols), dtype, True)
            a = wide[:, :n]
            for op in ("sum", "max", "min"):
                for axis in (0, 1):
                    report = _reduce_agree(
                        reduce.matrix_reduce(a, axis, op, use_pallas=True),
                        reduce._reduce_ref(a, axis, op), a, op, axis)
                    cases.append(dict(
                        report, kernel="reduce", shape=[300, n], lda=cols,
                        dtype=str(dtype)[6:], op=op, axis=axis,
                        vec=reduce.launch_plan(a, axis).vec, nan_inf=True))
    gpu_sync()
    return cases


def _reduce_planted_faults(rng, device):
    """Faults that must be reported: the last row block (512 rows, the
    Pallas kernel's block) dropped from a sum over axis 0 and the last
    column block from a max over axis 1 (in the inputs), and the planted
    builds: the last rank's partial dropped from axis 0's merge (sum and
    max at split 8) and the NaN flag ignored (max and min on the NaN
    matrix, both axes)."""
    from veles_tpu_torch.ops import reduce
    a = _reduce_matrix(rng, device, REDUCE_BIG, torch.float32, False)
    special = _reduce_matrix(rng, device, REDUCE_BIG, torch.float32, True)
    cut = REDUCE_BIG[0] - REDUCE_BLOCK
    faults = {
        "last_row_block_dropped_sum_axis0": [_reduce_agree(
            reduce.matrix_reduce(a[:cut], 0, "sum", use_pallas=True),
            reduce._reduce_ref(a, 0, "sum"), a, "sum", 0)],
        "last_column_block_dropped_max_axis1": [_reduce_agree(
            reduce.matrix_reduce(a[:, :cut], 1, "max", use_pallas=True),
            reduce._reduce_ref(a, 1, "max"), a, "max", 1)]}
    with planted("reduce", 1):
        faults["last_rank_partial_dropped"] = [_reduce_agree(
            reduce._reduce_cuda(a, 0, op, 8), reduce._reduce_ref(a, 0, op),
            a, op, 0) for op in ("sum", "max")]
    with planted("reduce", 2):
        faults["nan_flag_ignored"] = [_reduce_agree(
            reduce._reduce_cuda(special, axis, op),
            reduce._reduce_ref(special, axis, op), special, op, axis)
            for op in ("max", "min") for axis in (0, 1)]
    gpu_sync()
    return {name: {"reports": reports,
                   "caught": not any(r["ok"] for r in reports)}
            for name, reports in faults.items()}


def _reduce_timed(rng, device):
    """Every op and axis at (4096, 4096) f32: the kernel, the plain
    version and torch's one call (sum, amax, amin along the axis) as one
    call's event time with L2 flushed (``ms``: the median of 20, each
    after the clean flush) and the kernel and torch's call as device time
    a call on REDUCE_COPIES cycled copies (``device_ms``: none finds its
    operand in L2), beside the byte bound; the headline is the sum over
    axis 0, the reference's default axis."""
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import reduce
    flush = make_l2_flush(device)
    copies = [_reduce_matrix(rng, device, REDUCE_BIG, torch.float32, False)
              for _ in range(REDUCE_COPIES)]
    a = copies[0]
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
            lib = library[op]
            dev = cold_device_ms([
                lambda c=c: reduce._reduce_cuda(c, axis, op)
                for c in copies], reps=4 * REDUCE_COPIES)
            by_shape.append({
                "shape": [m, n], "dtype": "float32", "op": op, "axis": axis,
                "split": reduce.launch_plan(a, axis).split,
                "ms": time_ms(lambda: reduce._reduce_cuda(a, axis, op),
                              flush=flush),
                "device_ms": dev,
                "plain_ms": time_ms(lambda: reduce._reduce_ref(a, axis, op),
                                    flush=flush),
                "library_ms": time_ms(lambda: lib(a, dim=axis), flush=flush),
                "library_device_ms": cold_device_ms([
                    lambda c=c: lib(c, dim=axis) for c in copies],
                    reps=4 * REDUCE_COPIES),
                "bound_ms": bound * 1e3, "bound_by": by,
                "bound_share_device": bound * 1e3 / dev,
                "max_abs_err": err})
    gpu_sync()
    row = {"name": "reduce", "route": "cuda",
           "source": "veles_tpu_torch/csrc/reduce.cu",
           "replaces": "veles_tpu/ops/reduce.py:44",
           "plain_of": "_reduce_ref",
           "library_of": "torch.sum / torch.amax / torch.amin",
           "calls": by_shape}
    row.update({key: by_shape[0][key] for key in (
        "shape", "dtype", "op", "axis", "split", "ms", "device_ms",
        "plain_ms", "library_ms", "library_device_ms", "bound_ms",
        "bound_by", "bound_share_device", "max_abs_err")})
    return row


def _reduce_kernels(device):
    from veles_tpu_torch.ops import reduce
    rng = numpy.random.default_rng(SEED + 6)
    cases = _reduce_cases(rng, device)
    a = _reduce_matrix(rng, device, REDUCE_BIG, torch.float32, False)
    repeatable = all(torch.equal(reduce.matrix_reduce(a, ax, "sum", True),
                                 reduce.matrix_reduce(a, ax, "sum", True))
                     for ax in (0, 1))
    planted_faults = _reduce_planted_faults(rng, device)
    # the six calls twice (a short window around ctypes launches may see
    # none of them), each with a PyTorch kernel beside it, so the window
    # sees the card: only this body's kernels may be named, both of them
    names, tries = profiled_names(
        lambda: [reduce._reduce_cuda(a, axis, op).sum()
                 for _ in range(2) for op in ("sum", "max", "min")
                 for axis in (0, 1)],
        ("reduce",), lambda seen: all(any(b in n_ for n_ in seen)
                                      for b in REDUCE_BODIES))
    named = bool(names) and all(any(b in n_ for b in REDUCE_BODIES)
                                for n_ in names)
    row = _reduce_timed(rng, device)
    row.update(body="+".join(b for b in REDUCE_BODIES
                             if any(b in n_ for n_ in names)),
               profile_windows=tries)
    ok = (all(c["ok"] for c in cases) and repeatable and named
          and all(f["caught"] for f in planted_faults.values()))
    return {"cases": cases, "bit_equal_relaunch": repeatable,
            "planted_faults": planted_faults, "kernel_names": names,
            "names_ok": named}, [row], ok


# -- the uniform fill (csrc/random.cu) ----------------------------------------

UNIFORM_BIG = (4096, 4096)
#: fills whose last counter is whole, or holds 1, 2 or 3 values
UNIFORM_TAILS = ((1000,), (1001,), (1002,), (1025, 1023), (3,))


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
    """(4096, 4096) in both ranges and dtypes, bit for bit and by its
    moments; every tail of a counter's four values, bit for bit."""
    from veles_tpu_torch.ops import random
    cases = []
    for shape in (UNIFORM_BIG,) + UNIFORM_TAILS:
        for dtype in (torch.float32, torch.bfloat16):
            for low, high in ((0.0, 1.0), (-2.0, 3.0)):
                got = random.uniform_pallas(SEED + 11, shape, dtype, low,
                                            high)
                want = random._uniform_ref(SEED + 11, shape, dtype, low,
                                           high, device=device)
                same = bool(torch.equal(got, want))
                case = dict(kernel="uniform", shape=list(shape),
                            dtype=str(dtype)[6:], low=low, high=high,
                            numel_mod_4=got.numel() % 4, bit_equal=same,
                            in_range=bool(float(got.min()) >= low
                                          and float(got.max()) < high))
                if shape == UNIFORM_BIG:
                    case.update(_uniform_moments(got, low, high))
                case["ok"] = (same and case["in_range"]
                              and case.get("ok", True))
                cases.append(case)
    gpu_sync()
    return cases


def _uniform_planted_faults(device):
    """The planted builds of csrc/random.cu must each be reported: a
    counter's second word written over its first, every counter one
    block off."""
    from veles_tpu_torch.ops import random
    want = random._uniform_ref(SEED, UNIFORM_BIG, device=device)
    faults = {}
    for fault, name in ((1, "second_word_over_first"),
                        (2, "counter_offset_one_block")):
        with planted("random", fault):
            got = random.uniform_pallas(SEED, UNIFORM_BIG)
        faults[name] = {"bit_equal": bool(torch.equal(got, want)),
                        "caught": not bool(torch.equal(got, want))}
    return faults


def _uniform_timed(device):
    """(4096, 4096) f32 in [0, 1): one call's event time with L2 flushed
    (the median of 20, each after the clean flush) and device time a call
    back to back on one output (each call pays for the previous one's
    write-backs, as a fill in steady state does), beside the bound by
    bytes written, the plain version (Philox in torch int64 on the card),
    torch.rand with a CUDA generator and ``fill_`` of the same 64 MiB
    (the card's practical write ceiling), on the same measures."""
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

    def kernel():
        return random._uniform_cuda(SEED, shape, torch.float32, 0.0, 1.0,
                                    device)

    def rand():
        return torch.rand(shape, generator=gen, device=device)
    filled = torch.empty(shape, device=device)
    dev = device_ms(kernel)
    row = {"name": "uniform", "route": "cuda",
           "source": "veles_tpu_torch/csrc/random.cu",
           "replaces": "veles_tpu/ops/random.py:36",
           "shape": list(shape), "dtype": "float32",
           "plain_of": "_uniform_ref",
           "library_of": "torch.rand with a CUDA generator",
           "ms": time_ms(kernel, flush=flush), "device_ms": dev,
           "plain_ms": time_ms(lambda: random._uniform_ref(
               SEED, shape, device=device), flush=flush),
           "library_ms": time_ms(rand, flush=flush),
           "library_device_ms": device_ms(rand),
           "fill_ms": time_ms(lambda: filled.fill_(0.5), flush=flush),
           "fill_device_ms": device_ms(lambda: filled.fill_(0.5)),
           "bound_ms": bound * 1e3, "bound_by": by,
           "bound_share_device": bound * 1e3 / dev, "max_abs_err": err}
    gpu_sync()
    return row


def _uniform_kernels(device):
    from veles_tpu_torch.ops import random
    cases = _uniform_cases(device)
    planted_faults = _uniform_planted_faults(device)
    # 12 fills, each with a PyTorch kernel beside it (one launch alone was
    # seen in none of 3 windows late in the process)
    names, tries = profiled_names(
        lambda: [random.uniform_pallas(SEED, UNIFORM_BIG).sum()
                 for _ in range(12)], ("uniform",), bool)
    named = bool(names) and all("uniform_kernel" in n_ for n_ in names)
    row = _uniform_timed(device)
    row.update(profile_windows=tries)
    ok = (all(c["ok"] for c in cases) and row["max_abs_err"] == 0.0
          and named and all(f["caught"] for f in planted_faults.values()))
    return {"cases": cases, "planted_faults": planted_faults,
            "kernel_names": names, "names_ok": named}, [row], ok


def phase_kernels(device):
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
    bad = [c for c in cases
           if not c.get("ok", c["max_abs_err"] <= c["tol"])]

    # times at the main path's shapes: the forward at the largest prefill
    # bucket and the train step's batch, all bfloat16; the decode kernel
    # in _decode_kernels
    flash, flash_ok = _fwd_timed(rng, device)
    bwd_rows, bwd_report, bwd_ok = _bwd_timed(rng, device)
    gemm_report, gemm_rows, gemm_ok = _gemm_kernels(device)
    bf16_report, bf16_rows, bf16_ok = _gemm_bf16_kernels(device)
    gemm_report["bf16"] = bf16_report
    gemm_rows += bf16_rows
    gemm_ok = gemm_ok and bf16_ok
    gather_report, gather_rows, gather_ok = _gather_kernels(device)
    paged_report, paged_rows, paged_ok = _paged_kernels(device)
    qgemm_report, qgemm_rows, qgemm_ok = _qgemm_kernels(device)
    reduce_report, reduce_rows, reduce_ok = _reduce_kernels(device)
    uniform_report, uniform_rows, uniform_ok = _uniform_kernels(device)
    decode_report, decode_rows, decode_ok = _decode_kernels(device)
    timed = ([flash] + bwd_rows + decode_rows + paged_rows + gemm_rows
             + gather_rows + qgemm_rows + reduce_rows + uniform_rows)
    ok = (not bad and flash_ok and decode_ok and bwd_ok
          and gemm_ok and gather_ok and paged_ok and qgemm_ok and reduce_ok
          and uniform_ok)
    emit({"phase": "kernels", "ok": ok, "cases": cases,
          "decode": decode_report,
          "timed_backward_errors": bwd_report, "gemm": gemm_report,
          "gather": gather_report, "paged": paged_report,
          "qgemm": qgemm_report, "reduce": reduce_report,
          "uniform": uniform_report, "timed": timed})
    gemm_bad = [c for c in gemm_report["cases"] + bf16_report["cases"]
                if not c["ok"]]
    gather_bad = [c for c in gather_report["cases"] if not c["ok"]]
    paged_bad = [c for c in paged_report["cases"] if not c["ok"]]
    new_bad = [c for report in (decode_report, qgemm_report, reduce_report,
                                uniform_report)
               for c in report["cases"] if not c["ok"]]
    check(ok, "kernels", "kernel disagrees with its plain version, or a "
          "planted fault went unseen: %s" % (
              bad or gemm_bad[:4] or gather_bad[:4] or paged_bad[:4]
              or new_bad[:4]
              or [gemm_report["planted_faults"],
                  gather_report["planted_faults"],
                  paged_report["mirror"],
                  paged_report["garbage_and_planted_faults"],
                  flash["planted_faults"], flash["body"],
                  decode_report["planted_faults"],
                  decode_report["bit_equal_relaunch"], decode_rows[0]["body"],
                  qgemm_report["planted_faults"], qgemm_report["bodies"],
                  reduce_report["planted_faults"],
                  reduce_report["kernel_names"],
                  uniform_report["planted_faults"],
                  uniform_report["kernel_names"],
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
    info["breakdown"] = profile_breakdown(engine, workload,
                                          names_of=("decode_attn",))
    window = info["breakdown"]["decode_window"]
    # every decode-attention kernel the window saw is the split body
    split_body = bool(window["kernel_names"]) and all(
        DECODE_BODY in name for name in window["kernel_names"])
    info["ok"] = budgets_ok and in_vocab and counted and split_body
    blas_per_step = window["kernels_by_group"].get("matmul", 0) / float(
        window["steps"])
    emit(info)
    check(budgets_ok, "serve", "a request did not get exactly %d tokens"
          % SERVE_NEW_TOKENS)
    check(in_vocab, "serve", "a token lies outside the vocabulary")
    check(counted, "serve", "the kernels were not on the main path: "
          "launches %s for %d prefills and %d decode steps"
          % (launches, prefills, steps))
    check(split_body, "serve", "the decode window's attention kernels "
          "are not all the split body: %s" % window["kernel_names"])
    # the warmed engine stays open: serve_generate deploys it
    return (launches, results, info["params_bytes"], blas_per_step,
            engine, info["tokens_per_s"])


def serve_workload(vocab):
    """The serving sessions' 8 seeded prompts of 16..1500 tokens, evenly
    spread and shuffled: ``(lengths, prompts)``."""
    rng = numpy.random.default_rng(SEED)
    lengths = numpy.linspace(16, 1500, SERVE_REQUESTS).astype(int)
    rng.shuffle(lengths)
    return lengths, [rng.integers(0, vocab, int(n)).tolist()
                     for n in lengths]


#: decode windows :func:`profile_breakdown` may take: a serving window
#: has missed some of its kernels in two windows running
DECODE_WINDOW_TRIES = 6


def _whole_steps(window, steps, groups=("matmul", "qmatmul")):
    """Every decode step launches the same kernels, so a window of
    ``steps`` steps that counted a group's kernels a number of times that
    is not a multiple of ``steps`` missed some: the profiler drops events
    at times (a bf16 window once counted 779 cuBLAS kernels for 16 steps
    of 49)."""
    counts = window["kernels_by_group"]
    return all(counts.get(group, 0) % steps == 0 for group in groups)


def profile_breakdown(engine, workload, decode_steps=16, names_of=()):
    """Where a serving step's time goes, after the counted session: one
    profiled window that fills every slot (one prefill each, through
    the engine's own entry point) and one of ``decode_steps`` decode
    steps over the full batch, taken again (at most DECODE_WINDOW_TRIES
    windows) while it missed some of the steps' library or qmatmul
    kernels (:func:`_whole_steps`), whose counts the serving checks read;
    in both the kernels of the groups ``names_of`` are counted by
    name."""
    prompts = workload[:engine.max_slots]
    slots = []
    prefill = profile_window(
        lambda: slots.extend(engine.prefill(p)[0] for p in prompts),
        names_of)
    prefill["buckets"] = [engine.bucket_for(len(p)) for p in prompts]
    for tries in range(1, DECODE_WINDOW_TRIES + 1):
        decode = profile_window(
            lambda: [engine.decode_step() for _ in range(decode_steps)],
            names_of)
        if _whole_steps(decode, decode_steps):
            break
    decode["steps"] = decode_steps
    decode["windows"] = tries
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
    breakdown = profile_breakdown(engine, workload, names_of=("qmatmul",))
    window = breakdown["decode_window"]
    # the prefill window: each layer's 4 block products of a bucket above
    # 16 rows on the tensor-core body, of a 16-row bucket on the decode
    # body
    prefill_window = breakdown["prefill_window"]
    above = sum(bucket > 16 for bucket in prefill_window["buckets"])
    want_prefill_bodies = {
        "tensor_core": QMM_PER_LAYER * layers * above,
        "decode": QMM_PER_LAYER * layers * (len(prefill_window["buckets"])
                                            - above), "fma": 0}
    prefill_bodies = _bodies(prefill_window["kernel_names"])
    # the profiler may miss launches (see _qgemm_timed): the tensor-core
    # body must be named, the decode body only when a bucket of 16 rows
    # was filled, and the FMA body (f32) never
    on_tensor_cores = (prefill_bodies["tensor_core"] > 0
                       and prefill_bodies["fma"] == 0
                       and (prefill_bodies["decode"] == 0
                            or want_prefill_bodies["decode"] > 0))
    # every decode step's block products (M = 4) on the decode body
    decode_bodies = _bodies(window["kernel_names"])
    on_decode_body = (decode_bodies["decode"] > 0
                      and decode_bodies["decode"]
                      == sum(decode_bodies.values()))
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
        "prefill_window_buckets": prefill_window["buckets"],
        "prefill_window_qmatmul_ms": prefill_window[
            "device_ms_by_group"].get("qmatmul", 0.0),
        "prefill_window_busy_ms": prefill_window["device_busy_ms"],
        "prefill_window_wall_ms": prefill_window["wall_ms"],
        "prefill_window_qmatmul_bodies": prefill_bodies,
        "prefill_window_qmatmul_bodies_launched": want_prefill_bodies,
        "decode_window_qmatmul_bodies": decode_bodies,
        "decode_window_qmatmul_kernels_seen": window[
            "kernels_by_group"].get("qmatmul", 0),
        "decode_window_qmatmul_launches": qmm_launches,
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
    info["ok"] = (budgets_ok and counted and no_library and all_int8
                  and on_tensor_cores and on_decode_body)
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
    check(on_tensor_cores, "serve_int8", "the prefill window's qmatmul "
          "kernels by body %s, want %s" % (prefill_bodies,
                                           want_prefill_bodies))
    check(on_decode_body, "serve_int8", "the decode window's qmatmul "
          "kernels by body %s, want the decode body only" % decode_bodies)
    return launches, results


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


#: serve_generate: the clients that ask for the ndjson stream (of the 8),
#: the streams in flight across the drain swap, and each HTTP call's
#: time limit
SERVE_GEN_STREAMED = (0, 2, 4, 6)
SERVE_GEN_SWAP_STREAMS = 4
SERVE_GEN_HTTP_TIMEOUT = 300
#: the gen_* gauges a contiguous engine's scheduler shows, as the JAX
#: scheduler registers them
SERVE_GEN_GAUGES = ("gen_queue_depth", "gen_slot_occupancy",
                    "gen_admitted_total", "gen_tokens_total",
                    "gen_batch_fill", "gen_ttft_p99_ms",
                    "gen_preemptions_total", "gen_hbm_per_request_bytes")


def _gen_post(port, name, tokens, stream, ctx=None, on_event=None):
    """One ``POST /generate/<name>`` of ``tokens`` for SERVE_NEW_TOKENS:
    the status, the headers, the final document, the streamed events
    (None for a whole reply), the seconds to the first streamed event
    and to the end.  ``on_event`` sees each streamed event as it
    arrives."""
    import urllib.error
    import urllib.request
    headers = {"Content-Type": "application/json"}
    if ctx is not None:
        headers["traceparent"] = ctx.traceparent()
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate/%s" % (port, name),
        data=json.dumps({"tokens": [int(t) for t in tokens],
                         "max_new_tokens": SERVE_NEW_TOKENS,
                         "stream": bool(stream)}).encode(),
        headers=headers)
    out = {"events": None, "first_s": None}
    tic = time.perf_counter()
    try:
        with urllib.request.urlopen(
                req, timeout=SERVE_GEN_HTTP_TIMEOUT) as resp:
            out["status"], out["headers"] = resp.status, dict(resp.headers)
            if stream:
                events = []
                for line in resp:
                    if out["first_s"] is None:
                        out["first_s"] = time.perf_counter() - tic
                    events.append(json.loads(line))
                    if on_event is not None:
                        on_event(events[-1])
                out["doc"], out["events"] = events[-1], events[:-1]
            else:
                out["doc"] = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        out["status"], out["headers"] = e.code, dict(e.headers)
        out["doc"] = json.loads(e.read() or b"{}")
    out["start"], out["end"] = tic, time.perf_counter()
    return out


def _gen_clients(port, name, prompts, streamed, ctxs=None):
    """``prompts`` from one client thread each, those at ``streamed``
    asking for the stream: the replies in prompt order, and the wall
    time from the first send to the last reply."""
    import threading
    replies = [None] * len(prompts)

    def client(i):
        replies[i] = _gen_post(port, name, prompts[i], i in streamed,
                               ctxs[i] if ctxs else None)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    tic = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return replies, time.perf_counter() - tic


def _replies_ok(replies, want, version, streamed):
    """Every reply a 200 of ``version`` whose tokens equal ``want``'s bit
    for bit; a streamed reply's events indexed 0..n-1 and their tokens
    the final document's.  Returns the faults found, by reply."""
    faults = {}
    for i, (reply, tokens) in enumerate(zip(replies, want)):
        doc = reply["doc"]
        if reply["status"] != 200 or doc.get("version") != version:
            faults[i] = "status %s, %s" % (reply["status"], doc)
        elif doc["tokens"] != list(tokens):
            faults[i] = "tokens differ from index %d" % next(
                (j for j, (a, b) in enumerate(zip(doc["tokens"], tokens))
                 if a != b), min(len(doc["tokens"]), len(tokens)))
        elif (i in streamed) != (reply["events"] is not None):
            faults[i] = "streamed %s, asked %s" % (
                reply["events"] is not None, i in streamed)
        elif reply["events"] is not None and (
                [e["index"] for e in reply["events"]]
                != list(range(len(tokens)))
                or [e["token"] for e in reply["events"]] != doc["tokens"]
                or doc.get("done") is not True):
            faults[i] = "stream framing %s ... %s" % (reply["events"][:2],
                                                      doc)
    return faults


def _share_rate(replies, members):
    """Tokens a second of the replies ``members``, over their span."""
    picked = [replies[i] for i in members]
    tokens = sum(len(r["doc"].get("tokens", ())) for r in picked)
    span = max(r["end"] for r in picked) - min(r["start"] for r in picked)
    return tokens / span


def _gen_metrics(port):
    """``GET /metrics``: the ``veles_serve_gen_*`` lines of the page,
    ``{name with labels: value}``."""
    import urllib.request
    with urllib.request.urlopen("http://127.0.0.1:%d/metrics" % port,
                                timeout=SERVE_GEN_HTTP_TIMEOUT) as resp:
        page = resp.read().decode()
    out = {}
    for line in page.splitlines():
        if line.startswith("veles_serve_gen_"):
            key, _, value = line.rpartition(" ")
            out[key[len("veles_serve_"):]] = float(value)
    return out


def phase_serve_generate(device, smi, engine, serve_streams,
                         serve_tokens_per_s, int8_streams):
    """Generative serving through the front door: ``serve``'s warmed
    CONFIG engine deployed with ``ModelRegistry.deploy_generative`` at
    the default V-S01 preflight (``warn``), behind ``ServingServer``.
    ``serve``'s 8 prompts from 8 client threads over HTTP, 4 of them
    streamed (chunked ndjson), traced: every reply equals ``serve``'s
    stream bit for bit, every traceparent is echoed, exactly 12 flash
    forward launches a prefill and 12 decode launches a step, and
    ``/metrics`` shows the gen_* gauges (512 tokens, 8 TTFT samples).
    The same traffic again in a profiled window (busy share).  A drain
    swap to a seed + 1 engine under 4 streams: each finishes its 64
    tokens as ``serve``'s, a new request is version 2, and v1's KV
    cache leaves the card.  An int8 deploy (``quantize="int8"``) gives
    ``serve_int8``'s streams over HTTP, with both qmatmul bodies named
    in a profiled window and exactly 48 qmatmul launches a prefill and
    a step.  Returns the launches of the counted HTTP session and those
    of the int8 round, each set to 0 just before and read just after."""
    import threading
    from veles_tpu_torch import obs, trace
    from veles_tpu_torch.analyze import check_generative
    from veles_tpu_torch.config import root
    from veles_tpu_torch.gen import GenerativeEngine, TransformerGenModel
    from veles_tpu_torch.ops import attention, gemm, qgemm
    from veles_tpu_torch.samples.transformer import CONFIG
    from veles_tpu_torch.serve import (ModelRegistry, ServingMetrics,
                                       ServingServer)
    phase = "serve_generate"
    layers = CONFIG["layers"]
    lengths, workload = serve_workload(CONFIG["vocab"])
    streamed = SERVE_GEN_STREAMED

    def new_engine(seed):
        model = TransformerGenModel(CONFIG, compute_dtype=torch.bfloat16,
                                    device=device)
        return GenerativeEngine(model, max_slots=4, max_seq=2048, seed=seed,
                                device=device)

    report = check_generative(engine)
    print(report.render_text(), flush=True)
    check(not report.has_errors, phase, "V-S01 refuses the serving plan")
    metrics = ServingMetrics()
    registry = ModelRegistry(metrics=metrics)
    server = None
    tic = time.perf_counter()
    registry.deploy_generative("lm", engine, warmup=False)
    deploy_s = time.perf_counter() - tic
    try:
        server = ServingServer(registry=registry).start()
        scheduler = registry.get("lm").scheduler

        # the counted, traced session
        root.common.engine.trace = "on"
        trace.configure()
        trace.recorder.clear()
        reset_all_launches()
        prefill0, decode0 = engine.prefill_calls, engine.decode_calls
        ctxs = [obs.mint() for _ in workload]
        replies, elapsed = _gen_clients(server.port, "lm", workload,
                                        streamed, ctxs)
        counted = {**attention.launches, **gemm.launches,
                   **qgemm.launches}
        prefills = engine.prefill_calls - prefill0
        steps = engine.decode_calls - decode0
        events = trace.recorder.events()
        root.common.engine.trace = "off"
        trace.configure()
        scraped = _gen_metrics(server.port)
        # the counted session's TTFT samples alone: the rounds below
        # add theirs to the same histogram
        ttft = scheduler.ttft
        ttft_ms = {"samples": ttft.count, "p50": ttft.percentile(50) * 1e3,
                   "p99": ttft.percentile(99) * 1e3}
        faults = _replies_ok(replies, serve_streams, 1, streamed)
        echoed = [ctx.trace_id in (r["headers"].get("traceparent") or "")
                  for ctx, r in zip(ctxs, replies)]
        label = '{model="lm"}'
        missing = [g for g in SERVE_GEN_GAUGES if g + label not in scraped]
        tokens = sum(len(r["doc"].get("tokens", ())) for r in replies)
        decode_ms = [ev[4] / 1e6 for ev in events
                     if ev[0] == "X" and ev[2] == "decode"]
        whole = [i for i in range(len(workload)) if i not in streamed]
        first_ms = [replies[i]["first_s"] * 1e3 for i in streamed]

        # the same traffic in a profiled window: the device's busy share
        replies2 = []
        window = profile_window(lambda: replies2.extend(_gen_clients(
            server.port, "lm", workload, streamed)[0]))
        faults2 = _replies_ok(replies2, serve_streams, 1, streamed)

        # the drain swap under SERVE_GEN_SWAP_STREAMS streams
        v1_kv = engine.kv_cache_bytes
        tic = time.perf_counter()
        v2 = new_engine(SEED + 1).warmup()
        v2_build_s = time.perf_counter() - tic
        n = SERVE_GEN_SWAP_STREAMS
        first_seen = [threading.Event() for _ in range(n)]
        swap_replies = [None] * n

        def swap_client(i):
            swap_replies[i] = _gen_post(
                server.port, "lm", workload[i], True,
                on_event=lambda _e: first_seen[i].set())

        threads = [threading.Thread(target=swap_client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        in_flight = all(e.wait(SERVE_GEN_HTTP_TIMEOUT) for e in first_seen)
        gpu_sync()
        mem_before = torch.cuda.memory_allocated(device)
        tic = time.perf_counter()
        registry.deploy_generative("lm", v2, warmup=False)
        swap_s = time.perf_counter() - tic
        gpu_sync()
        mem_after = torch.cuda.memory_allocated(device)
        for t in threads:
            t.join()
        swap_faults = _replies_ok(swap_replies, serve_streams[:n], 1,
                                  range(n))
        after_swap = _gen_post(server.port, "lm", workload[0], False)

        # the int8 deploy
        tic = time.perf_counter()
        e8 = new_engine(SEED)
        registry.deploy_generative("lm8", e8, quantize="int8")
        int8_deploy_s = time.perf_counter() - tic
        # the int8 round's own launches: set to 0 after the deploy's
        # warmup, read right after the round
        reset_all_launches()
        p8, d8 = e8.prefill_calls, e8.decode_calls
        replies8 = []
        window8 = profile_window(lambda: replies8.extend(_gen_clients(
            server.port, "lm8", workload, streamed)[0]),
            names_of=("qmatmul",))
        counted8 = {**attention.launches, **gemm.launches,
                    **qgemm.launches}
        qmm = counted8["qmatmul"]
        prefills8, steps8 = e8.prefill_calls - p8, e8.decode_calls - d8
        faults8 = _replies_ok(replies8, int8_streams, 1, streamed)
        bodies8 = _bodies(window8["kernel_names"])
    finally:
        root.common.engine.trace = "off"
        trace.configure()
        if server is not None:
            server.stop()
        else:
            registry.stop()
    info = {
        "phase": phase, "nvidia_smi": smi,
        "config": dict(CONFIG), "compute_dtype": "bfloat16",
        "preflight": [f.to_dict() for f in report],
        "deploy_s": deploy_s,
        "requests": len(workload), "streamed": list(streamed),
        "prompt_lengths": lengths.tolist(), "new_tokens": SERVE_NEW_TOKENS,
        "tokens": tokens, "elapsed_s": elapsed,
        "requests_per_s": len(workload) / elapsed,
        "tokens_per_s": tokens / elapsed,
        "direct_tokens_per_s": serve_tokens_per_s,
        "http_over_direct": tokens / elapsed / serve_tokens_per_s,
        "streamed_tokens_per_s": _share_rate(replies, streamed),
        "whole_tokens_per_s": _share_rate(replies, whole),
        "ttft_samples": ttft_ms["samples"],
        "ttft_p50_ms": ttft_ms["p50"], "ttft_p99_ms": ttft_ms["p99"],
        "streamed_first_event_ms": first_ms,
        # a streamed reply's inter-token time at the client, first event
        # to the end, beside each whole reply's time: the streamed share
        # against the whole one, apart from the order of admission
        "streamed_ms_per_token": [
            (replies[i]["end"] - replies[i]["start"] - replies[i]["first_s"])
            * 1e3 / max(1, len(replies[i]["doc"]["tokens"]) - 1)
            for i in streamed],
        "reply_s": [r["end"] - r["start"] for r in replies],
        "decode_step_median_ms": statistics.median(decode_ms),
        "prefills": prefills, "decode_steps": steps,
        "launches": counted, "replies_bit_equal_to_serve":
            len(workload) - len(faults), "faults": faults,
        "traceparent_echoed": sum(echoed), "gauges_missing": missing,
        "gen_tokens_total": scraped.get("gen_tokens_total" + label),
        "gen_ttft_seconds_count":
            scraped.get("gen_ttft_seconds_count" + label),
        "profiled": {k: window[k] for k in (
            "wall_ms", "device_busy_ms", "busy_share", "device_ms_by_group",
            "kernels_by_group", "top_host_gaps_ms", "host_gaps_ms_total")},
        "profiled_faults": faults2,
        "swap": {"v2_build_s": v2_build_s, "deploy_s": swap_s,
                 "streams_in_flight": in_flight, "faults": swap_faults,
                 "memory_before": mem_before, "memory_after": mem_after,
                 "freed_bytes": mem_before - mem_after,
                 "v1_kv_cache_bytes": v1_kv,
                 "new_request": {"status": after_swap["status"],
                                 "version": after_swap["doc"].get(
                                     "version")}},
        "int8": {"deploy_s": int8_deploy_s, "prefills": prefills8,
                 "decode_steps": steps8, "qmatmul_launches": qmm,
                 "launches": counted8,
                 "faults": faults8, "bodies": bodies8,
                 "busy_share": window8["busy_share"],
                 "wall_ms": window8["wall_ms"]},
    }
    ok = {
        "replies": not faults and not faults2,
        "traceparent": all(echoed),
        "launches": (prefills == len(workload) and steps > 0
                     and counted["flash_fwd"] == layers * prefills
                     and counted["decode_attn"] == layers * steps),
        "metrics": (not missing
                    and info["gen_tokens_total"]
                    == SERVE_REQUESTS * SERVE_NEW_TOKENS
                    and info["gen_ttft_seconds_count"] == len(workload)
                    and ttft_ms["samples"] == len(workload)),
        "swap": (in_flight and not swap_faults
                 and after_swap["status"] == 200
                 and after_swap["doc"].get("version") == 2
                 and mem_before - mem_after >= v1_kv),
        "int8": (not faults8 and bodies8["tensor_core"] > 0
                 and bodies8["decode"] > 0 and prefills8 > 0
                 and qmm == QMM_PER_LAYER * layers * (prefills8 + steps8)),
    }
    info["checks"] = ok
    info["ok"] = all(ok.values())
    emit(info)
    check(ok["replies"], phase, "replies that are not serve's streams: %s "
          "(profiled round: %s)" % (faults, faults2))
    check(ok["traceparent"], phase, "traceparent not echoed: %s" % echoed)
    check(ok["launches"], phase, "launches %s for %d prefills and %d decode "
          "steps" % (counted, prefills, steps))
    check(ok["metrics"], phase, "/metrics: missing %s, tokens %s, TTFT "
          "samples %s" % (missing, info["gen_tokens_total"],
                          info["gen_ttft_seconds_count"]))
    check(ok["swap"], phase, "drain swap: %s" % info["swap"])
    check(ok["int8"], phase, "int8 deploy: %s" % info["int8"])
    return counted, counted8


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
    # every attention kernel of the profiled step is the tensor-core body:
    # 24 forward (forward and remat recompute), 12 + 12 backward.  A
    # window that saw other counts is taken again, at most PROFILE_TRIES
    # in all; the check reads the last window, as exact
    want_bodies = {"fwd": {"tensor_core": 2 * cfg["layers"], "decode": 0,
                           "fma": 0},
                   "bwd": {"tensor_core": 2 * cfg["layers"], "decode": 0,
                           "fma": 0}}
    for tries in range(1, PROFILE_TRIES + 1):
        info["breakdown"] = profile_window(
            lambda: step(params, velocity, tokens),
            names_of=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        names = info["breakdown"]["kernel_names"]
        bodies = {"fwd": _bodies({n_: c for n_, c in names.items()
                                  if "flash_fwd_kernel" in n_}),
                  "bwd": _bodies({n_: c for n_, c in names.items()
                                  if "flash_bwd_" in n_})}
        if bodies == want_bodies:
            break
    info["breakdown"]["profile_windows"] = tries
    on_tensor_cores = bodies == want_bodies
    info.update(attention_bodies=bodies,
                attention_bodies_expected=want_bodies,
                ok=finite and counted and on_tensor_cores)
    emit(info)
    check(finite, "train", "a loss is not finite: %s" % losses)
    check(counted, "train", "the kernels were not on the main path as "
          "expected: %s per step, want %s" % (per_step, want))
    check(on_tensor_cores, "train", "a profiled step's attention kernels "
          "were not all the tensor-core bodies: %s, want %s"
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
    """The GEMM and gather launch counts, the dw launches that carried
    the bias step and the tables the gather launches served."""
    from veles_tpu_torch.ops import gather, gemm
    return {**gemm.launches, **gemm.bias_in_dw, **gather.launches,
            **gather.tables_served}


def phase_mnist(device, smi):
    """The MNIST MLP's training through the eager workflow at full width
    (784→100→10, minibatch 100) on the synthetic stand-in: launch counts,
    rates, per-minibatch transfers, then one epoch under the profiler."""
    with engine_knobs(stitch="off"):
        return _phase_mnist(device, smi)


def _phase_mnist(device, smi):
    from veles_tpu_torch import prng
    from veles_tpu_torch.memory import Watcher
    from veles_tpu_torch.ops import gather, gemm
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
    entries = dict(gather.entry_launches)
    splits = dict(gemm.split_launches)
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
    counted = (launches == MNIST_LAUNCHES
               and entries == MNIST_ENTRY_LAUNCHES)
    split_ok = splits == MNIST_SPLIT_LAUNCHES
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
        "entry_launches": entries,
        "entry_launches_expected": MNIST_ENTRY_LAUNCHES,
        "split_launches": splits,
        "split_launches_expected": MNIST_SPLIT_LAUNCHES,
        "ok": finite and learned and counted and split_ok,
    }
    def window():
        profiled = mnist.create_workflow(device=device, max_epochs=2)
        served, inner = [], profiled.loader.run
        profiled.loader.run = lambda: served.append(inner())
        reset_all_launches()
        return profile_window(profiled.run, _MNIST_NAMES), len(served)
    info["breakdown"], kernels_ok = _mnist_profiled(window)
    bodies_ok = _gemm_bodies_ok(info["breakdown"])
    info["ok"] = info["ok"] and bodies_ok and kernels_ok
    info["breakdown"]["window"] = ("one epoch: 2 validation passes and 1 "
                                   "train pass (max_epochs=2)")
    # device time of one launch on the main path, from the profile
    by_group = info["breakdown"]["device_ms_by_group"]
    info["breakdown"]["device_us_per_launch"] = {
        name: by_group.get(_PROFILE_GROUP.get(name, "veles_" + name),
                           0.0) * 1e3 / count
        for name, count in {**gemm.launches, **gather.launches}.items()
        if count}
    emit(info)
    check(finite, "mnist", "an n_err is not finite: %s" % errors)
    check(learned, "mnist", "validation error did not fall: %s" % valid)
    check(counted, "mnist", "the kernels were not on the main path as "
          "expected: %s %s, want %s %s" % (launches, entries, MNIST_LAUNCHES,
                                           MNIST_ENTRY_LAUNCHES))
    check(split_ok, "mnist", "K split in %s launches, want %s"
          % (splits, MNIST_SPLIT_LAUNCHES))
    check(bodies_ok, "mnist", "GEMM bodies in the profile: %s, want each "
          "of %s and no other" % (info["breakdown"]["gemm_bodies"],
                                  info["breakdown"]["gemm_bodies_expected"]))
    check(kernels_ok, "mnist", "the profile saw %d gather kernels for %s "
          "minibatches (of %d run) and db kernels %s" % (
              info["breakdown"]["gather_kernels"],
              info["breakdown"]["minibatches_seen"],
              info["breakdown"]["minibatches_run"],
              info["breakdown"]["gd_db_kernels"]))
    return dict(launches, **entries)


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
            prime_window()
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
    summary = _profile_summary(prof, (window["toc"] - window["tic"]) * 1e6,
                               _MNIST_NAMES)
    summary["window"] = ("one steady-state epoch: epoch 1's validation "
                         "and train passes (%d minibatches)"
                         % window["minibatches"])
    summary["minibatches"] = window["minibatches"]
    summary["kernels_per_minibatch"] = (summary["device_kernels"]
                                        / window["minibatches"])
    return summary, window["minibatches"]


def phase_mnist_stitched(device, smi):
    """The stitched native route at full width (784→100→10, minibatch
    100, u8 dataset scaled in the loader head): each minibatch is one
    forward-segment graph replay and, on train minibatches, one GD
    replay.  Exact dispatch, capture and launch counts, the per-minibatch
    host→device bytes (the scalar blocks), rates, resident bytes, then
    one steady-state epoch under the profiler."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.memory import Watcher
    from veles_tpu_torch.ops import gather, gemm
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
        entries = dict(gather.entry_launches)
        splits = dict(gemm.split_launches)
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
        counted = (launches == MNIST_STITCHED_LAUNCHES
                   and entries == MNIST_STITCHED_ENTRY_LAUNCHES)
        split_ok = splits == MNIST_SPLIT_LAUNCHES
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
            "entry_launches": entries,
            "entry_launches_expected": MNIST_STITCHED_ENTRY_LAUNCHES,
            "split_launches": splits,
            "split_launches_expected": MNIST_SPLIT_LAUNCHES,
            "ok": (finite and learned and counted and split_ok and dispatched
                   and h2d_ok and d2h_ok),
        }
        info["head_stage"] = _head_stage_launches(wf, device)
        head_ok = info["head_stage"]["ok"]
        reset_all_launches()
        info["breakdown"], kernels_ok = _mnist_profiled(
            lambda: _mnist_stitched_profile(device))
        bodies_ok = _gemm_bodies_ok(info["breakdown"])
        info["ok"] = info["ok"] and bodies_ok and kernels_ok and head_ok
        by_group = info["breakdown"]["device_ms_by_group"]
        n = info["breakdown"]["minibatches"]
        info["breakdown"]["device_us_per_minibatch_by_group"] = {
            g: t * 1e3 / n for g, t in by_group.items()}
        info["breakdown"]["kernels_per_minibatch_with_index_ops"] = \
            MNIST_STITCHED_KERNELS_WITH_INDEX_OPS
    emit(info)
    check(finite, "mnist_stitched", "an n_err is not finite: %s" % errors)
    check(learned, "mnist_stitched", "validation error did not fall: %s"
          % valid)
    check(counted, "mnist_stitched", "the kernels were not on the main "
          "path as expected: %s %s, want %s %s"
          % (launches, entries, MNIST_STITCHED_LAUNCHES,
             MNIST_STITCHED_ENTRY_LAUNCHES))
    check(head_ok, "mnist_stitched", "the head stage's fn, run once, "
          "launched other than the one served gather kernel: %s"
          % info["head_stage"])
    check(split_ok, "mnist_stitched", "K split in %s launches (graph "
          "replays included), want %s" % (splits, MNIST_SPLIT_LAUNCHES))
    check(bodies_ok, "mnist_stitched", "GEMM bodies in the profile: %s, "
          "want each of %s and no other"
          % (info["breakdown"]["gemm_bodies"],
             info["breakdown"]["gemm_bodies_expected"]))
    check(kernels_ok, "mnist_stitched", "the profile saw %d gather kernels "
          "for %s minibatches (of %d run) and db kernels %s" % (
              info["breakdown"]["gather_kernels"],
              info["breakdown"]["minibatches_seen"],
              info["breakdown"]["minibatches_run"],
              info["breakdown"]["gd_db_kernels"]))
    check(dispatched, "mnist_stitched", "segments dispatched, captured or "
          "recaptured other than expected: %s" % report)
    check(h2d_ok, "mnist_stitched", "host->device bytes per minibatch: "
          "median %s > %d" % (statistics.median(h2d_steps),
                              MNIST_STITCHED_H2D_MAX))
    check(d2h_ok, "mnist_stitched", "%d device->host copies for %d class "
          "closes" % (d2h, len(closes)))
    return dict(launches, **entries)


def _head_stage_launches(wf, device):
    """The loader head stage's ``fn`` run once eagerly under the
    profiler, at a 60-row tail of the shuffled buffer, its scalars 0-d
    views of one device buffer as the segment's scalar block hands them
    over: the device kernels it launched (exactly one, the served gather,
    is required) and its launch counts.  A window that saw no kernel is
    taken again, at most PROFILE_TRIES windows."""
    from veles_tpu_torch.ops import gather
    stage = wf.stitch_segments[0].stages[0]
    t = {name: vec.devmem for name, vec in stage.params.items()}
    _block, t["offset"], t["size"] = _scalars(device, 940, 60)
    gpu_sync()
    for tries in range(1, PROFILE_TRIES + 1):
        reset_all_launches()
        summary = profile_window(lambda: stage.fn(t),
                                 (_GATHER_GROUP, "other", "copy", "matmul"))
        if summary["device_kernels"]:
            break
    names = summary["kernel_names"]
    counts = {**gather.launches, **gather.entry_launches}
    reset_all_launches()
    return {"device_kernels": summary["device_kernels"],
            "kernel_names": names, "windows": tries, "launches": counts,
            "ok": (summary["device_kernels"] == 1 and len(names) == 1
                   and "veles_gather_served_kernel" in next(iter(names))
                   and counts["veles_gather_served"] == 1
                   and counts["gather_norm"] == 1)}


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


# -- the epoch-scan windows -------------------------------------------------

MNIST_SCAN_EPOCHS = 4
# the stand-in's windows under epoch_scan=auto: the validation pass (10
# steps, a validated class close: the verdict runs in the graph) and the
# train pass (60 steps); (train, K, verdict)
MNIST_SCAN_KEYS = [(False, 10, True), (True, 60, False)]
# one step's launches in each segment of the native stitched route: the
# forward segment (two split forwards, the served gather of the u8 data
# and the labels) and the GD segment (one dx, two split dw carrying the
# bias step)
MNIST_STEP_LAUNCHES = (
    {"matmul": 2, "matmul_split": 2, "gather_norm": 1,
     "gather_norm_tables": 1, "gather_tables": 1,
     "veles_gather_served": 1},
    {"gd_dx": 1, "gd_dw": 2, "gd_db_in_dw": 2, "gd_dw_split": 2})
# max_epochs=4: 4 validation passes of 10 steps, 3 train passes of 60
MNIST_SCAN_STEPS = (4 * 10 + 3 * 60, 3 * 60)
MNIST_AE_EPOCHS = 4
MNIST_AE_RMSE_RTOL = 1e-5
# the autoencoder's step: two sigmoid forwards, the served gather of the
# f32 data and targets (two raw tables); one dx (layer 2), two dw
MNIST_AE_STEP_LAUNCHES = (
    {"matmul": 2, "matmul_split": 2, "gather": 1, "gather_tables": 2,
     "veles_gather_served": 1},
    {"gd_dx": 1, "gd_dx_split": 1, "gd_dw": 2, "gd_db_in_dw": 2,
     "gd_dw_split": 2})


def _launches_of(steps, per_step):
    """``{counter: launches}`` of ``steps`` (forward steps, train steps)
    of each segment's launches a step (MNIST_STEP_LAUNCHES or its AE
    twin)."""
    counts = {}
    for launches, n in zip(per_step, steps):
        for name, count in launches.items():
            if count * n:
                counts[name] = counts.get(name, 0) + count * n
    return counts


def _counted():
    """Every GEMM and gather counter as the run left them."""
    from veles_tpu_torch.ops import gather, gemm
    counts = {}
    for counters in (gemm.launches, gemm.bias_in_dw, gemm.split_launches,
                     gather.launches, gather.tables_served,
                     gather.entry_launches):
        counts.update(counters)
    return counts


def _counted_expected(expected):
    """``expected`` over every counter :func:`_counted` reads (0 where
    it names none)."""
    return {name: expected.get(name, 0) for name in _counted()}


def _window_log(wf):
    """Wrap the runner's window: one record a window (epoch, class,
    steps)."""
    runner, loader = wf.epoch_runner, wf.loader
    execute, log = runner._execute_window, []

    def logged(k_max):
        steps = runner.steps
        execute(k_max)
        log.append({"epoch": int(loader.epoch_number),
                    "cls": int(loader.minibatch_class),
                    "steps": runner.steps - steps})
    runner._execute_window = logged
    return log


def _verdict_log(wf):
    """Wrap the Decision's class close: at each validated close that
    ends an epoch, whether the window's device verdict agrees with the
    host close (improved and complete)."""
    dec, out = wf.decision, []
    close = dec._close_class

    def checked(cls, check_epoch_end):
        result = close(cls, check_epoch_end)
        if dec._validated(cls) and check_epoch_end:
            v = dec.scan_verdict
            out.append({
                "epoch": int(dec.epoch_number), "cls": cls,
                "verdict": None if v is None else {
                    "improved": bool(v["improved"]),
                    "stop": bool(v["stop"]), "epoch": v["epoch"],
                    "cls": v["cls"], "steps": v["steps"]},
                "host": {"improved": bool(dec.improved),
                         "complete": bool(dec.complete)}})
            out[-1]["agree"] = (
                v is not None and v["epoch"] == int(dec.epoch_number)
                and v["cls"] == cls
                and bool(v["improved"]) == bool(dec.improved)
                and bool(v["stop"]) == bool(dec.complete))
        return result
    dec._close_class = checked
    return out


def _hook_steps(wf, mode, hook):
    """Call ``hook()`` before each served step of a stitched run: the
    loader head's prelude per step, or each step of a window's serving
    loop under epoch_scan."""
    loader = wf.loader
    if mode == "off":
        stage = wf.stitch_segments[0].stages[0]
        inner = stage.prelude
    else:
        inner = loader.scan_window_step

    def step():
        hook()
        inner()
    if mode == "off":
        stage.prelude = step
    else:
        loader.scan_window_step = step


def _scan_profile(device, create, epochs, names_of, steady_epoch=2,
                  mode="auto"):
    """One steady epoch of a stitched sample under ``epoch_scan=mode``
    in the profiler: a ``max_epochs=epochs`` run whose window opens as
    ``steady_epoch`` starts (its graphs captured in the epochs before)
    and closes as the next starts.  Returns ``(summary,
    minibatches)``."""
    from torch.profiler import ProfilerActivity, profile

    from veles_tpu_torch import prng
    with engine_knobs(stitch="on", loader="auto", epoch_scan=mode):
        prng.seed_all(SEED)
        wf = create(device=device, max_epochs=epochs)
        loader = wf.loader
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        window = {}

        def watched():
            # an epoch starts in the step that wraps the offset
            at = (loader.epoch_number,
                  loader.global_offset >= loader.total_samples)
            if "tic" not in window and at == (steady_epoch - 1, True):
                gpu_sync()
                prof.start()
                prime_window()
                window["tic"] = time.perf_counter()
                window["minibatches"] = 0
            elif "tic" in window and "toc" not in window \
                    and at == (steady_epoch, True):
                gpu_sync()
                window["toc"] = time.perf_counter()
                prof.stop()
            if "tic" in window and "toc" not in window:
                window["minibatches"] += 1
        _hook_steps(wf, mode, watched)
        wf.run()
        gpu_sync()
        if "toc" not in window:
            prof.stop()
            window["toc"] = time.perf_counter()
    summary = _profile_summary(prof, (window["toc"] - window["tic"]) * 1e6,
                               names_of)
    summary["window"] = ("one steady epoch under epoch_scan=%s: epoch "
                         "%d (%d minibatches)"
                         % (mode, steady_epoch, window["minibatches"]))
    summary["minibatches"] = window["minibatches"]
    summary["kernels_per_minibatch"] = (summary["device_kernels"]
                                        / window["minibatches"])
    return summary, window["minibatches"]


def _scan_counted_run(device, create, epochs, mode, prepare=None):
    """A sample's stitched run under ``epoch_scan=mode`` with the trace
    on: ``(wf, info)`` with the launches, the windows by epoch, the
    ``segment/dispatch`` and ``window_serve`` spans, the verdict checks
    and the wall times.  ``prepare(wf)`` runs before the run."""
    from veles_tpu_torch import prng, trace
    with engine_knobs(stitch="on", loader="auto", epoch_scan=mode,
                      trace="on"):
        prng.seed_all(SEED)
        wf = create(device=device, max_epochs=epochs)
        if prepare is not None:
            prepare(wf)
        trace.recorder.clear()
        log = _window_log(wf) if mode != "off" else []
        verdicts = _verdict_log(wf) if mode != "off" else []
        loader, starts = wf.loader, []

        def epoch_start():
            if not starts or loader.global_offset >= loader.total_samples:
                starts.append(time.perf_counter())
        _hook_steps(wf, mode, epoch_start)
        reset_all_launches()
        gpu_sync()
        tic = time.perf_counter()
        wf.run()
        gpu_sync()
        elapsed = time.perf_counter() - tic
        events = trace.recorder.events()
    trace.configure()
    trace.recorder.clear()
    dispatch = [e for e in events if e[1:3] == ("segment", "dispatch")]
    serve = [e for e in events if e[1:3] == ("segment", "window_serve")]
    info = {"elapsed_s": elapsed, "dispatch_spans": len(dispatch),
            "epoch_wall_ms": [(b - a) * 1e3
                              for a, b in zip(starts, starts[1:])],
            "segments": wf.stitch_report(),
            "epoch_scan": wf.epoch_scan_report(), "verdicts": verdicts,
            "closes": wf.decision.history}
    if log:
        for record, d, w in zip(log, dispatch, serve):
            record["dispatch_host_ms"] = d[4] / 1e6
            record["serve_host_ms"] = w[4] / 1e6
        epochs_seen = sorted({r["epoch"] for r in log})
        info["windows_by_epoch"] = [
            sum(1 for r in log if r["epoch"] == e) for e in epochs_seen]
        info["steps_by_epoch"] = [
            sum(r["steps"] for r in log if r["epoch"] == e)
            for e in epochs_seen]
        info["windows"] = log
    return wf, info


def _replay_nodes(wf, epochs=2):
    """Run ``epochs`` more epochs of a windowed workflow, each captured
    window graph's replays under the profiler: ``{graph name: {"nodes",
    "busy_ms", "by_group", "windows"}}``, the kernels and copies a replay
    put on the card, less the block copies and the prior's fill that
    run before it (``scripts/scan_probe.py``'s count), from the window
    that saw the most of them (late in a process the profiler at times
    loses a window's records, ``prime_window``)."""
    from veles_tpu_torch.epoch_scan import WindowGraph
    execute, seen = WindowGraph.execute, {}

    def profiled(self, rows, prior, preds=None, timer=None):
        if not self.graph.captures:
            return execute(self, rows, prior, preds, timer)
        out = {}
        summary = profile_window(
            lambda: out.update(r=execute(self, rows, prior, preds,
                                         timer)))
        before = len(self.blocks) + (self.preds is not None) + 1
        row = {"nodes": summary["device_kernels"] - before,
               "busy_ms": summary["device_busy_ms"],
               "by_group": summary["kernels_by_group"]}
        best = seen.get(self.name)
        row["windows"] = best["windows"] + 1 if best else 1
        if best is None or row["nodes"] > best["nodes"]:
            seen[self.name] = row
        else:
            best["windows"] = row["windows"]
        return out["r"]
    WindowGraph.execute = profiled
    try:
        with engine_knobs(stitch="on", loader="auto", epoch_scan="auto"):
            wf.decision.complete <<= False
            wf.decision.max_epochs += epochs
            wf.run()
            gpu_sync()
    finally:
        WindowGraph.execute = execute
    return seen


def _scan_graphs_ok(report, keys, step_launches):
    """The runner's graphs: exactly ``keys``, each captured once, never
    again, with K times a step's launches a replay."""
    graphs = report["graphs"] if report else {}
    launches_ok = all(
        graphs[key]["graph_launches"] == _launches_of(
            (key[1], key[1] if key[0] else 0), step_launches)
        for key in keys if key in graphs)
    return (report is not None and report["eligible"]
            and sorted(graphs) == sorted(keys)
            and all(g["captures"] == 1 and g["recaptures"] == 0
                    for g in graphs.values()) and launches_ok)


def phase_mnist_scan(device, smi):
    """The stitched native MNIST route under epoch_scan=auto at full
    width (784→100 tanh→10 softmax, minibatch 100, the stand-in), 4
    epochs: a class pass is one window, epoch 0's windows run eagerly,
    epoch 1's capture, the rest replay.  Windows and steps per epoch,
    the host dispatches (``segment/dispatch`` spans) a steady epoch, the
    window graphs' keys, captures, recaptures and launches a replay,
    exact launches over the run, the device verdict against the host
    close, then one steady epoch under the profiler."""
    from veles_tpu_torch.samples import mnist

    def create(device, max_epochs):
        return mnist.create_workflow(device=device, max_epochs=max_epochs,
                                     native=True)
    wf, info = _scan_counted_run(device, create, MNIST_SCAN_EPOCHS, "auto")
    expected = _launches_of(MNIST_SCAN_STEPS, MNIST_STEP_LAUNCHES)
    launches = _counted()
    report = info["epoch_scan"]
    graphs_ok = _scan_graphs_ok(report, MNIST_SCAN_KEYS,
                                MNIST_STEP_LAUNCHES)
    counted = launches == _counted_expected(expected)
    epochs_ok = (info["windows_by_epoch"] == [2, 2, 2, 1]
                 and info["steps_by_epoch"] == [70, 70, 70, 10]
                 and info["dispatch_spans"] == 7)
    per_step_idle = all(r["dispatches"] == 0 for r in info["segments"])
    verdicts_ok = (len(info["verdicts"]) == MNIST_SCAN_EPOCHS
                   and all(v["agree"] for v in info["verdicts"]))
    errors = [c["n_err"] for c in info["closes"]]
    valid = [c["n_err_pt"] for c in info["closes"]
             if c["cls"] == "validation"]
    learned = (all(numpy.isfinite(e) for e in errors)
               and valid[-1] < valid[0])
    steady = [w for w in info["windows"] if w["epoch"] == 2]
    info.update({
        "phase": "mnist_scan", "nvidia_smi": smi,
        "layers": "784-100 all2all_tanh, 100-10 softmax",
        "minibatch": 100, "max_epochs": MNIST_SCAN_EPOCHS,
        "data": "synthetic stand-in as u8, scale 1/255 in the loader head",
        "epoch_scan": report, "launches": launches,
        "launches_expected": _counted_expected(expected),
        "dispatches_per_steady_epoch": len(steady),
        "steady_epoch_wall_ms": info["epoch_wall_ms"][2],
        "steady_epoch_serve_host_ms": sum(w["serve_host_ms"]
                                          for w in steady),
        "steady_epoch_dispatch_host_ms": sum(w["dispatch_host_ms"]
                                             for w in steady),
        "capture_s": {str(k): g["capture_s"]
                      for k, g in report["graphs"].items()},
        "pool_reserved_bytes": {str(k): g["pool_reserved_bytes"]
                                for k, g in report["graphs"].items()},
        "pool_allocated_bytes": {str(k): g["pool_allocated_bytes"]
                                 for k, g in report["graphs"].items()},
    })
    info["epoch_scan"] = {k: v for k, v in report.items() if k != "graphs"}
    info["graphs"] = {str(k): g for k, g in report["graphs"].items()}
    # two more epochs: each window graph's replays under the profiler
    # (the nodes the tooling phase holds its health-off graphs to)
    info["replay_nodes"] = _replay_nodes(wf)
    reset_all_launches()
    info["breakdown"], kernels_ok = _mnist_profiled(
        lambda: _scan_profile(device, create, MNIST_SCAN_EPOCHS,
                              _MNIST_NAMES))
    bodies_ok = _gemm_bodies_ok(info["breakdown"])
    info["ok"] = (graphs_ok and counted and epochs_ok and per_step_idle
                  and verdicts_ok and learned and kernels_ok and bodies_ok)
    emit(info)
    check(graphs_ok, "mnist_scan", "window graphs other than expected: %s"
          % info["graphs"])
    check(counted, "mnist_scan", "launches %s, want %s"
          % (launches, info["launches_expected"]))
    check(epochs_ok and per_step_idle, "mnist_scan", "windows %s, steps "
          "%s by epoch, %d dispatch spans, segments %s"
          % (info["windows_by_epoch"], info["steps_by_epoch"],
             info["dispatch_spans"], info["segments"]))
    check(verdicts_ok, "mnist_scan", "the device verdict disagrees with "
          "the host close: %s" % info["verdicts"])
    check(learned, "mnist_scan", "n_err %s, validation %s" % (errors, valid))
    check(kernels_ok and bodies_ok, "mnist_scan", "the steady epoch's "
          "profile: gather kernels %s for %s minibatches, bodies %s"
          % (info["breakdown"].get("gather_kernels"),
             info["breakdown"].get("minibatches_seen"),
             info["breakdown"].get("gemm_bodies")))
    check(len(info["replay_nodes"]) == len(MNIST_SCAN_KEYS), "mnist_scan",
          "replays profiled: %s" % info["replay_nodes"])
    return launches, info["replay_nodes"]


def _exact_agreement(a, b):
    """Two runs' ``(closes, params)``: closes (n_err, samples, confusion)
    and every parameter and momentum bit for bit."""
    (ca, pa), (cb, pb) = a, b
    closes = _close_record(ca) == _close_record(cb) and all(
        numpy.array_equal(x["confusion"], y["confusion"])
        for x, y in zip(ca, cb))
    differing = sorted(name for name in pb
                       if not numpy.array_equal(pa[name], pb[name]))
    return {"closes_equal": closes, "params_differing": differing,
            "ok": closes and not differing}


#: a metrics_every that misdivides the stand-in's 60-step train pass:
#: its windows take 25, 25 and 10 steps (keys (True, 25, False) and
#: (True, 10, False)), the validation pass 10
MNIST_SCAN_EVERY = 25


def phase_mnist_scan_parity(device):
    """The window route on the card (native, 3 epochs: eager, captured
    and replayed windows) against the card's per-step stitched route
    from the same seed, bit for bit (weights, momenta, confusion,
    closes), and against the port on the CPU (closes exact, parameters
    within 1e-4 · max |cpu|).  Under metrics_every=25 the train pass
    takes windows of 25, 25 and 10 steps: each key captured once, at
    its second window, never again, and the run bit for bit the
    per-step one.  A card window run whose stacked offset column repeats
    row 0 must fail the CPU check."""
    from veles_tpu_torch import prng, stitch
    from veles_tpu_torch.samples import mnist

    def run(dev, mode, every=0):
        with engine_knobs(stitch="on", loader="auto", epoch_scan=mode,
                          metrics_every=every):
            prng.seed_all(SEED)
            wf = mnist.create_workflow(device=dev, max_epochs=MNIST_EPOCHS,
                                       native=True)
            closes = []
            _record_closes(wf, closes)
            wf.run()
            gpu_sync()
            return (closes, wf.params_to_numpy()), wf.epoch_scan_report()

    cpu = torch.device("cpu")
    window, report = run(device, "auto")
    per_step, _r = run(device, "off")
    on_cpu, _r = run(cpu, "auto")
    misdivided, every_report = run(device, "auto", MNIST_SCAN_EVERY)
    results = {"window_vs_per_step_card": _exact_agreement(window, per_step),
               "window_card_vs_cpu": _agreement(window, on_cpu),
               "metrics_every_%d_window_vs_per_step_card"
               % MNIST_SCAN_EVERY: _exact_agreement(misdivided, per_step)}
    every_graphs = every_report["graphs"]
    every_ok = (sorted(every_graphs) == [(False, 10, True),
                                         (True, 10, False),
                                         (True, 25, False)]
                and all(g["captures"] == 1 and g["recaptures"] == 0
                        and g["replays"] == g["runs"] - 1
                        for g in every_graphs.values()))
    write = stitch.ScalarBlock.write

    def stale(self, values):
        if self.dtype == torch.int32 and self.tensor.dim() == 2:
            # the loader's offset is the window's int column 0
            values = [[values[0][0]] + list(row[1:]) for row in values]
        write(self, values)
    stitch.ScalarBlock.write = stale
    try:
        planted, _r = run(device, "auto")
    finally:
        stitch.ScalarBlock.write = write
    planted_check = _agreement(planted, on_cpu)
    graphs = report["graphs"]
    recaptures = sum(g["recaptures"] for g in graphs.values())
    captured = all(g["captures"] == 1 and g["replays"] >= 1
                   for g in graphs.values())
    ok = (all(r["ok"] for r in results.values()) and not planted_check["ok"]
          and recaptures == 0 and captured and every_ok)
    emit({"phase": "mnist_scan_parity", "ok": ok, "dtype": "float32",
          "tf32": False, "param_rtol": MNIST_PARAM_RTOL,
          "max_epochs": MNIST_EPOCHS, "comparisons": results,
          "graphs": {str(k): g for k, g in graphs.items()},
          "metrics_every": MNIST_SCAN_EVERY,
          "metrics_every_graphs": {str(k): g
                                   for k, g in every_graphs.items()},
          "planted_stale_window_offsets": planted_check,
          "planted_stale_window_offsets_caught": not planted_check["ok"]})
    check(ok, "mnist_scan_parity", "the window route disagrees, a graph "
          "recaptured or never replayed, or the planted stale offsets "
          "went unseen: %s, planted %s, recaptures %d, metrics_every "
          "graphs %s" % ({k: v["ok"] for k, v in results.items()},
                         planted_check, recaptures, every_graphs))


def _rmse_agreement(a, b, rtol=MNIST_AE_RMSE_RTOL):
    """Two autoencoder runs' ``(history, params)``: the same closes with
    each rmse within ``rtol``, and each parameter leaf's max |a − b| /
    max |b|."""
    (ha, pa), (hb, pb) = a, b
    same = [(h["epoch"], h["cls"], h["batches"]) for h in ha] == \
        [(h["epoch"], h["cls"], h["batches"]) for h in hb]
    rel = max((abs(x["mse"] - y["mse"]) / abs(y["mse"])
               for x, y in zip(ha, hb)), default=float("inf"))
    errs = {name: float(numpy.abs(pa[name] - ref).max()
                        / max(float(numpy.abs(ref).max()), 1e-30))
            for name, ref in pb.items()}
    worst = max(errs.values())
    return {"closes_equal": same, "rmse_worst_rel_err": rel,
            "param_worst_rel_err": worst,
            "rmse": [h["mse"] for h in ha],
            "ok": same and rel <= rtol and worst <= MNIST_PARAM_RTOL}


def phase_mnist_ae(device, smi):
    """The MLP autoencoder (784→100 sigmoid→784 sigmoid, f32, MSE,
    minibatch 100, the stand-in as data and targets) stitched, with
    epoch_scan off and auto, 4 epochs each: the rmse closes, exact
    launches on both, the window graphs (keys, one capture each, K
    times a step's launches a replay) and the weights of the two runs
    bit for bit."""
    from veles_tpu_torch.samples import mnist_ae
    expected = _launches_of(MNIST_SCAN_STEPS, MNIST_AE_STEP_LAUNCHES)
    runs, infos = {}, {}
    for mode in ("off", "auto"):
        wf, info = _scan_counted_run(device, mnist_ae.create_workflow,
                                     MNIST_AE_EPOCHS, mode)
        info["launches"] = _counted()
        infos[mode] = info
        runs[mode] = wf.params_to_numpy()
        loader = wf.loader
        info["epochs_per_s"] = (loader.samples_served
                                / loader.total_samples / info["elapsed_s"])
    want = _counted_expected(expected)
    graphs_ok = _scan_graphs_ok(infos["auto"]["epoch_scan"],
                                MNIST_SCAN_KEYS, MNIST_AE_STEP_LAUNCHES)
    for info in infos.values():
        if info["epoch_scan"]:
            info["epoch_scan"]["graphs"] = {
                str(k): g for k, g in info["epoch_scan"]["graphs"].items()}
    counted = {mode: infos[mode]["launches"] == want for mode in infos}
    differing = sorted(name for name in runs["off"]
                       if not numpy.array_equal(runs["off"][name],
                                                runs["auto"][name]))
    rmse = [h["mse"] for h in infos["auto"]["closes"]
            if h["cls"] == "validation"]
    learned = (all(numpy.isfinite(h["mse"])
                   for i in infos.values() for h in i["closes"])
               and rmse[-1] < rmse[0])
    same_closes = ([(h["epoch"], h["cls"]) for h in infos["off"]["closes"]]
                   == [(h["epoch"], h["cls"])
                       for h in infos["auto"]["closes"]])
    ok = (graphs_ok and all(counted.values()) and not differing and learned
          and same_closes and infos["auto"]["windows_by_epoch"]
          == [2, 2, 2, 1])
    emit({"phase": "mnist_ae", "nvidia_smi": smi, "ok": ok,
          "layers": "784-100 all2all_sigmoid, 100-784 all2all_sigmoid",
          "loss": "mse (rmse per minibatch)", "minibatch": 100,
          "max_epochs": MNIST_AE_EPOCHS,
          "data": "synthetic stand-in (f32) as data and targets",
          "runs": infos, "launches_expected": want,
          "params_differing_off_vs_auto": differing,
          "window_graphs_ok": graphs_ok})
    check(ok, "mnist_ae", "graphs ok %s, launches exact %s, params "
          "differing off vs auto %s, rmse %s, windows %s"
          % (graphs_ok, counted, differing, rmse,
             infos["auto"].get("windows_by_epoch")))
    return infos["auto"]["launches"]


def phase_mnist_ae_parity(device):
    """The autoencoder under epoch_scan=auto on the card against the
    port on the CPU from the same seed (3 epochs): the same closes, each
    rmse within relative 1e-5, parameters within 1e-4 · max |cpu|."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import mnist_ae

    def run(dev):
        with engine_knobs(stitch="on", loader="auto", epoch_scan="auto"):
            prng.seed_all(SEED)
            wf = mnist_ae.create_workflow(device=dev,
                                          max_epochs=MNIST_EPOCHS)
            wf.run()
            gpu_sync()
            return wf.decision.history, wf.params_to_numpy()

    result = _rmse_agreement(run(device), run(torch.device("cpu")))
    emit({"phase": "mnist_ae_parity", "ok": result["ok"],
          "dtype": "float32", "tf32": False, "max_epochs": MNIST_EPOCHS,
          "rmse_rtol": MNIST_AE_RMSE_RTOL, "param_rtol": MNIST_PARAM_RTOL,
          "card_vs_cpu": result})
    check(result["ok"], "mnist_ae_parity", "card and CPU disagree: %s"
          % result)


def _named_leaves(tree, prefix=""):
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _named_leaves(leaf, prefix + key + ".")
        else:
            yield prefix + key, leaf


# -- the fused trainer (ROADMAP 7(b)) ---------------------------------------

MNIST_FUSED_EPOCHS = 4
MNIST_FUSED_PARITY_EPOCHS = 3
# GEMM launches of the fused step: a train step runs 2 forward products,
# the softmax layer's da and dw and layer 1's dw (its input is data: no
# da); an eval step the 2 forward products
FUSED_TRAIN_PRODUCTS = 5
FUSED_EVAL_PRODUCTS = 2
# bf16: layer 1's forward and weight gradient take the bf16 body; the
# softmax layer widens to f32 (its forward, da and dw), and an eval step
# meets the f32 master weights with the bf16-cast u8 input, so both of
# its products are f32
FUSED_BF16_TRAIN = {"matmul_bf16": 2, "matmul": 3}
FUSED_BF16_EVAL = {"matmul_bf16": 0, "matmul": 2}
# ... both on body S (w (784, 100) and delta (100, 100) have a 200-byte
# row pitch, which TMA cannot describe), both with K split
FUSED_BF16_TRAIN_BODIES = {"wgmma": 0, "ldmatrix": 2, "wgmma_split": 0,
                           "ldmatrix_split": 2}
# bf16 card against CPU: each class close's n_err within 1% of its
# samples, each parameter leaf within 1e-2 of its largest value.  Both
# take the same bf16 operands, but the card's tensor cores and the CPU's
# f32 product sum in other orders, so a result near a bf16 rounding
# boundary rounds the other way, and those ulps (2^-8 relative) feed
# the next steps
MNIST_FUSED_BF16_ERR = 0.01
MNIST_FUSED_BF16_RTOL = 1e-2


def _fused_workflow(device, epochs, fused_config=None):
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import mnist
    prng.seed_all(SEED)
    wf = mnist.create_workflow(device=device, max_epochs=epochs, native=True,
                               fused=True, fused_config=fused_config)
    train_closes = []
    close = wf.decision._close_class

    def timed_close(cls, check_epoch_end):
        out = close(cls, check_epoch_end)
        if cls == 2:             # the class close fetched: a host sync
            train_closes.append(time.perf_counter())
        return out
    wf.decision._close_class = timed_close
    wf.train_closes = train_closes
    return wf


def _fused_confusion(wf):
    """The validation confusion matrix of the trained weights (the
    forwards', synced from the trainer), on the host in float64."""
    loader = wf.loader
    scale, shift = loader.input_norm
    n = int(loader.class_lengths[1])
    start = int(loader.class_end_offsets[0])
    x = numpy.array(loader.original_data.mem[start:start + n],
                    numpy.float64) * scale + shift
    labels = numpy.array(loader.original_labels[start:start + n])
    params = wf.params_to_numpy()
    h = numpy.tanh((x @ params["0.weights"] + params["0.bias"]) * 0.6666) \
        * 1.7159
    pred = (h @ params["1.weights"] + params["1.bias"]).argmax(axis=1)
    out = numpy.zeros((10, 10), numpy.int64)
    numpy.add.at(out, (pred, labels), 1)
    return out


def _fused_run(device, epochs, fused_config=None):
    wf = _fused_workflow(device, epochs, fused_config)
    wf.run()
    if device.type == "cuda":
        gpu_sync()
    wf.fused_trainer.sync_weights()
    closes = [(c["epoch"], c["cls"], c["n_err"], c["samples"])
              for c in wf.decision.history]
    return wf, closes, _fused_confusion(wf), wf.params_to_numpy()


def _param_rel_errors(got, want):
    return {name: float(numpy.abs(got[name] - ref).max()
                        / max(float(numpy.abs(ref).max()), 1e-30))
            for name, ref in want.items()}


def _steady_epoch_ms(wf):
    """Wall ms of each epoch after the first (a validation pass and a
    train pass, from one train close to the next): every graph was
    captured in the first."""
    t = wf.train_closes
    return [(b - a) * 1e3 for a, b in zip(t, t[1:])]


def _graphs_expected(report, train_steps, eval_steps):
    """One eager step and one capture a shape, no recapture, the rest
    replays."""
    return (report.get("train_100", {}).get("eager") == 1
            and report["train_100"].get("captures") == 1
            and report["train_100"].get("replays") == train_steps - 1
            and report.get("eval_100", {}).get("eager") == 1
            and report["eval_100"].get("captures") == 1
            and report["eval_100"].get("replays") == eval_steps - 1
            and all(r.get("recaptures", 0) == 0 for r in report.values()))


def phase_mnist_fused(device, smi):
    """The fused trainer at full width (784→100 tanh→10 softmax,
    minibatch 100, u8-resident, 1/255 in the step), f32: one CUDA graph
    a step shape, the minibatch's gather inside it.  Exact GEMM launches
    (5 a train step, 2 an eval step, over the eager steps and the
    replays), one gather launch in each step graph, the graphs' captures,
    recaptures (0) and replays, and the wall ms of a steady epoch beside
    the stitched route's in the same run."""
    from veles_tpu_torch.ops import gather, gemm
    from veles_tpu_torch.samples import mnist
    reset_all_launches()
    tic = time.perf_counter()
    wf, closes, confusion, _params = _fused_run(device, MNIST_FUSED_EPOCHS)
    elapsed = time.perf_counter() - tic
    launches = mnist_launches()
    entries = dict(gather.entry_launches)
    report = wf.fused_trainer.graph_report()
    train_steps = sum(c[3] for c in closes if c[1] == "train") // 100
    eval_steps = sum(c[3] for c in closes if c[1] == "validation") // 100
    products = (FUSED_TRAIN_PRODUCTS * train_steps
                + FUSED_EVAL_PRODUCTS * eval_steps)
    counted = (launches["matmul"] == products
               and launches["matmul_bf16"] == 0
               and launches["gd_dx"] == launches["gd_dw"] == 0
               and entries["veles_gather_group"] == train_steps + eval_steps
               and report["train_100"].get("graph_launches", {}).get(
                   "matmul") == FUSED_TRAIN_PRODUCTS
               and report["eval_100"].get("graph_launches", {}).get(
                   "matmul") == FUSED_EVAL_PRODUCTS
               # the minibatch's gather rides in each step's graph
               and all(report[key].get("graph_launches", {}).get(
                   "veles_gather_group") == 1
                   for key in ("train_100", "eval_100")))
    graphs_ok = _graphs_expected(report, train_steps, eval_steps)
    valid = [c[2] for c in closes if c[1] == "validation"]
    learned = valid[-1] < valid[0]
    fused_ms = _steady_epoch_ms(wf)
    # the stitched route of the same workflow, timed the same way
    with engine_knobs(stitch="on", loader="auto", epoch_scan="off"):
        from veles_tpu_torch import prng
        prng.seed_all(SEED)
        stitched = mnist.create_workflow(device=device,
                                         max_epochs=MNIST_FUSED_EPOCHS,
                                         native=True)
        stamps = []
        close = stitched.decision._close_class

        def timed_close(cls, check_epoch_end):
            out = close(cls, check_epoch_end)
            if cls == 2:
                stamps.append(time.perf_counter())
            return out
        stitched.decision._close_class = timed_close
        stitched.run()
        gpu_sync()
    stitched_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    ok = counted and graphs_ok and learned
    emit({"phase": "mnist_fused", "nvidia_smi": smi, "ok": ok,
          "layers": "784-100 all2all_tanh, 100-10 softmax",
          "minibatch": 100, "max_epochs": MNIST_FUSED_EPOCHS,
          "data": "synthetic stand-in as u8, 1/255 in the fused step",
          "compute_dtype": "float32", "elapsed_s": elapsed,
          "train_steps": train_steps, "eval_steps": eval_steps,
          "launches": launches, "entry_launches": entries,
          "matmul_expected": products, "graphs": report,
          "class_closes": closes, "confusion": confusion.tolist(),
          "steady_epoch_ms": fused_ms,
          "stitched_steady_epoch_ms": stitched_ms,
          "epoch": "one validation pass (10 minibatches) and one train "
                   "pass (60) of the stand-in"})
    check(counted, "mnist_fused", "GEMM launches %s (want matmul %d, no "
          "GD kernel), gather entries %s, graph launches %s"
          % (launches, products, entries, report))
    check(graphs_ok, "mnist_fused", "the step graphs were not one eager "
          "step, one capture and replays with no recapture: %s" % report)
    check(learned, "mnist_fused", "validation error did not fall: %s"
          % valid)
    return dict(launches, **entries)


def phase_mnist_fused_parity(device):
    """The fused f32 route on the card against the CPU route from one
    seed: each class close's n_err and the validation confusion matrix
    equal, every parameter leaf within MNIST_PARAM_RTOL of its largest
    value (mnist_parity's tolerance)."""
    _wf, g_closes, g_conf, g_params = _fused_run(device,
                                                 MNIST_FUSED_PARITY_EPOCHS)
    _wf, c_closes, c_conf, c_params = _fused_run(torch.device("cpu"),
                                                 MNIST_FUSED_PARITY_EPOCHS)
    errs = _param_rel_errors(g_params, c_params)
    worst = max(errs, key=errs.get)
    ok = (g_closes == c_closes and numpy.array_equal(g_conf, c_conf)
          and errs[worst] <= MNIST_PARAM_RTOL)
    emit({"phase": "mnist_fused_parity", "ok": ok, "dtype": "float32",
          "max_epochs": MNIST_FUSED_PARITY_EPOCHS,
          "gpu_closes": g_closes, "cpu_closes": c_closes,
          "confusion_equal": bool(numpy.array_equal(g_conf, c_conf)),
          "param_rel_err_by_leaf": errs, "param_rtol": MNIST_PARAM_RTOL})
    check(ok, "mnist_fused_parity", "card and CPU fused training disagree "
          "(closes %s vs %s, params %s %.3g)"
          % (g_closes, c_closes, worst, errs[worst]))


def phase_mnist_fused_bf16(device):
    """``engine.precision_type="bfloat16"``: the fused step's layer-1
    products on the bf16 body, the master weights f32; card against the
    CPU route within MNIST_FUSED_BF16_ERR (n_err, of each close's
    samples) and MNIST_FUSED_BF16_RTOL (parameters), and the launches
    exact by body."""
    from veles_tpu_torch.ops import gemm
    with engine_knobs(precision_type="bfloat16"):
        reset_all_launches()
        wf, g_closes, g_conf, g_params = _fused_run(
            device, MNIST_FUSED_PARITY_EPOCHS)
        launches = mnist_launches()
        bodies = dict(gemm.bf16_bodies)
        report = wf.fused_trainer.graph_report()
        dtypes = {k: str(v.dtype) for k, v in
                  wf.fused_trainer._params_[0].items()}
        _wf, c_closes, c_conf, c_params = _fused_run(
            torch.device("cpu"), MNIST_FUSED_PARITY_EPOCHS)
    train_steps = sum(c[3] for c in g_closes if c[1] == "train") // 100
    eval_steps = sum(c[3] for c in g_closes if c[1] == "validation") // 100
    want = {k: FUSED_BF16_TRAIN[k] * train_steps
            + FUSED_BF16_EVAL[k] * eval_steps for k in FUSED_BF16_TRAIN}
    want_bodies = {k: v * train_steps
                   for k, v in FUSED_BF16_TRAIN_BODIES.items()}
    counted = (all(launches[k] == v for k, v in want.items())
               and bodies == want_bodies)
    errs = _param_rel_errors(g_params, c_params)
    worst = max(errs, key=errs.get)
    close_ok = len(g_closes) == len(c_closes) and all(
        g[:2] == c[:2] and g[3] == c[3]
        and abs(g[2] - c[2]) <= MNIST_FUSED_BF16_ERR * c[3]
        for g, c in zip(g_closes, c_closes))
    ok = (counted and close_ok and errs[worst] <= MNIST_FUSED_BF16_RTOL
          and dtypes["w"] == "torch.float32"
          and _graphs_expected(report, train_steps, eval_steps))
    emit({"phase": "mnist_fused_bf16", "ok": ok, "dtype": "bfloat16",
          "master_dtypes": dtypes, "max_epochs": MNIST_FUSED_PARITY_EPOCHS,
          "launches": launches, "launches_expected": want,
          "bf16_bodies": bodies, "bf16_bodies_expected": want_bodies,
          "graphs": report, "gpu_closes": g_closes, "cpu_closes": c_closes,
          "confusion_equal": bool(numpy.array_equal(g_conf, c_conf)),
          "n_err_tol_of_samples": MNIST_FUSED_BF16_ERR,
          "param_rel_err_by_leaf": errs,
          "param_rtol": MNIST_FUSED_BF16_RTOL})
    check(ok, "mnist_fused_bf16", "bf16 card and CPU training disagree or "
          "the launches are off (launches %s want %s, bodies %s want %s, "
          "closes %s vs %s, params %s %.3g, graphs %s)" % (
              launches, want, bodies, want_bodies, g_closes, c_closes,
              worst, errs[worst], report))
    return dict(launches, **bodies)


def phase_mnist_fused_epoch(device):
    """``fused_config={"epoch_mode": True}``: a train epoch is one window
    graph of K = 60 steps (the whole epoch) replayed once an epoch after
    the first (eager) epoch; the card's permutation is the CPU's (the
    same CPU generator, copied into the graph's index buffer), and the
    card's run equals the CPU's as in mnist_fused_parity."""
    from veles_tpu_torch.ops import gather
    reset_all_launches()
    tic = time.perf_counter()
    wf, g_closes, g_conf, g_params = _fused_run(
        device, MNIST_FUSED_EPOCHS, {"epoch_mode": True})
    elapsed = time.perf_counter() - tic
    launches = mnist_launches()
    entries = dict(gather.entry_launches)
    trainer = wf.fused_trainer
    report = trainer.graph_report()
    epochs = trainer.epoch_key_counter
    order_ok = torch.equal(trainer._epoch_["idx"].cpu(),
                           trainer.epoch_order(epochs - 1))
    cwf, c_closes, c_conf, c_params = _fused_run(
        torch.device("cpu"), MNIST_FUSED_EPOCHS, {"epoch_mode": True})
    same_orders = all(torch.equal(trainer.epoch_order(k),
                                  cwf.fused_trainer.epoch_order(k))
                      for k in range(epochs))
    errs = _param_rel_errors(g_params, c_params)
    worst = max(errs, key=errs.get)
    window = report.get("window_0_60", {})
    windows_ok = (window.get("eager") == 1 and window.get("captures") == 1
                  and window.get("recaptures") == 0
                  and window.get("replays") == epochs - 1
                  and window.get("graph_launches", {}).get("matmul")
                  == FUSED_TRAIN_PRODUCTS * 60
                  and window.get("graph_launches", {}).get(
                      "veles_gather_group") == 60)
    ok = (windows_ok and order_ok and same_orders and g_closes == c_closes
          and numpy.array_equal(g_conf, c_conf)
          and errs[worst] <= MNIST_PARAM_RTOL)
    emit({"phase": "mnist_fused_epoch", "ok": ok, "window_steps": 60,
          "window_steps_chosen": "the whole train epoch (60 minibatches; "
                                 "the trainer's limit is 1024)",
          "epochs_trained": epochs, "elapsed_s": elapsed,
          "graphs": report, "launches": launches, "entry_launches": entries,
          "index_buffer_is_the_cpu_order": order_ok,
          "card_and_cpu_orders_equal": same_orders,
          "steady_epoch_ms": _steady_epoch_ms(wf),
          "gpu_closes": g_closes, "cpu_closes": c_closes,
          "confusion_equal": bool(numpy.array_equal(g_conf, c_conf)),
          "param_rel_err_by_leaf": errs, "param_rtol": MNIST_PARAM_RTOL})
    check(ok, "mnist_fused_epoch", "epoch mode: windows %s, orders %s %s, "
          "closes %s vs %s, params %s %.3g" % (
              report, order_ok, same_orders, g_closes, c_closes, worst,
              errs[worst]))
    return dict(launches, **entries)


# -- the conv layer zoo (ROADMAP 7(c)) --------------------------------------

MNIST_CONV_EPOCHS = 3
MNIST_CONV_PARITY_EPOCHS = 2
#: card against CPU, the conv workflow after 2 epochs: each weight and
#: bias leaf within this share of its largest value, and each momentum
#: leaf (after a step, the learning rate times a gradient) within
#: MOMENTUM_RTOL.  The cause, measured on an H100 with
#: scripts/conv_drift_probe.py: f32 rounding, which a max pooling's or a
#: relu mask's near ties carry from step to step, not the card.  Run as
#: one fused step 120 times, the CPU's f32 run lands as far from a
#: float64 run (weights 2.9e-3, momenta 3.2e-2) as the card's (9.8e-3,
#: 2.3e-2); the same stack with tanh convs and average pooling (no
#: choices) stays within 1.5e-6 of it on both; with cuDNN's algorithms
#: pinned (precision levels 1 and 2) two card runs are bit-equal, and the
#: card stays 1.3e-3 (weights) and 3.0e-2 (momenta) from the CPU.  So two
#: f32 runs may sit twice one run's 3.2e-2 apart in the momenta: 1e-1 is
#: that with a 1.6x margin, and 5e-3 is 3.9x the weights' 1.3e-3 (H100
#: runs before the pin: up to 1.7e-3 and 4.3e-2).  AlexNet's one step
#: at batch 8 leaves its conv momenta 1.66e-2 from the CPU's, and the
#: CPU's f32 step is 1.66e-2 from float64 itself.  The tie-free check
#: below is the one that sees a wrong conv gradient.
MNIST_CONV_PARAM_RTOL = 5e-3
MOMENTUM_RTOL = 1e-1
#: the tie-free copy of the LeNet stack (tanh convs, average pooling),
#: card against CPU after the same 2 epochs: every weight and momentum
#: leaf within this share of its largest value.  With no choice for a sum
#: to break apart the runs stay at f32 size (on an H100: 3.0e-7 weights,
#: 2.6e-6 momenta); 2.5e-5 is the momenta's with a 9.6x margin.  A 1 %
#: error planted in the first conv layer's weight gradient
#: (TIE_FREE_PLANTED_SCALE) must fail it.
TIE_FREE_RTOL = 2.5e-5
TIE_FREE_PLANTED_SCALE = 1.01
#: AlexNet at full width: captured steps timed at each dtype, and the
#: batch of the one step held against the CPU step
ALEXNET_BATCH = 128
ALEXNET_STEPS = 10
ALEXNET_PARITY_BATCH = 8
#: one f32 step, card against CPU, each weight and bias leaf within this
#: share of its largest value (momenta: MOMENTUM_RTOL)
ALEXNET_PARAM_RTOL = 1e-5
#: the GEMM launches of one AlexNet step: fc6, fc7 and fc8 forward, and
#: each one's weight and input gradients (fc6's input comes from the
#: convs, which train: it needs its gradient); bf16 runs fc6 and fc7 on
#: the bf16 body, the softmax layer (fc8) widens to f32
ALEXNET_STEP_LAUNCHES = {"float32": {"matmul": 9, "matmul_bf16": 0},
                         "bfloat16": {"matmul": 3, "matmul_bf16": 6}}
#: ... the bf16 body of each: all six on body W (TMA describes every
#: operand), the forwards and fc7's input gradient with K split (32
#: tiles of 128 x 128 in clusters of 2), fc6's input gradient (72 tiles)
#: and the weight gradients (K = 128, tiles of 128 x 256) unsplit
ALEXNET_BF16_STEP_BODIES = {"wgmma": 6, "ldmatrix": 0, "wgmma_split": 3,
                            "ldmatrix_split": 0}
VGG_BATCH = 32
#: the aten ops that would run a cuBLAS GEMM: none may run in a zoo
#: profile window (the all2all layers run on the hand-written kernel)
_BLAS_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
             "aten::matmul", "aten::linear", "aten::addmv", "aten::mv")
#: kernel-name tags of cuDNN's convolutions: its direct and implicit-GEMM
#: bodies, its layout transforms, and its FFT algorithm's transforms and
#: complex products (cuBLAS's ``cf32`` GEMM, which only the FFT convs
#: call)
_CONV_TAGS = ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit",
              "nchwtonhwc", "nhwctonchw", "fft", "complex", "cf32")


def _zoo_group(name):
    """A kernel's group in a zoo window: ``conv`` (cuDNN, its FFT
    algorithm's complex GEMM included), the hand-written GEMM and gather
    groups, ``matmul`` (any other GEMM), ``copy``, and ``elementwise``
    for the rest (pooling, LRN, dropout, activations, the solver's
    updates, reductions)."""
    lower = name.lower()
    if any(tag in lower for tag in _CONV_TAGS):
        return "conv"
    group = _kernel_group(name)
    return "elementwise" if group == "other" else group


def zoo_profile(fn):
    """Run ``fn`` under ``torch.profiler``: device ms and kernels by
    :func:`_zoo_group`, the 12 kernels that took most, the aten ops of
    _BLAS_OPS that ran (a cuBLAS GEMM is reached through one of them),
    the cuDNN convolution ops (``aten::cudnn_convolution*``) and the
    device's busy share of the wall time.  A cuDNN kernel whose name has
    no conv tag (a runtime-compiled CUTLASS body) lands in ``matmul``:
    the ops, not the kernel names, tell cuDNN from cuBLAS."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gpu_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prime_window()
        tic = time.perf_counter()
        fn()
        gpu_sync()
        wall_us = (time.perf_counter() - tic) * 1e6
    events = prof.events()
    work = min((ev.time_range.start for ev in events
                if ev.name == WORK_MARKER), default=None)
    groups, counts, names, blas, cudnn = {}, {}, {}, {}, {}
    for ev in events:
        if work is not None and ev.time_range.start < work:
            continue
        if ev.device_type != DeviceType.CUDA:
            if ev.name in _BLAS_OPS:
                blas[ev.name] = blas.get(ev.name, 0) + 1
            elif "cudnn_convolution" in ev.name:
                cudnn[ev.name] = cudnn.get(ev.name, 0) + 1
            continue
        if ev.name == WORK_MARKER:
            continue
        group = _zoo_group(ev.name)
        groups[group] = groups.get(group, 0.0) + ev.device_time_total
        counts[group] = counts.get(group, 0) + 1
        names[ev.name] = names.get(ev.name, 0.0) + ev.device_time_total
    busy = sum(groups.values())
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / wall_us if wall_us else None,
            "device_ms_by_group": {g: t / 1e3 for g, t in groups.items()},
            "kernels_by_group": counts, "blas_ops": blas,
            "cudnn_conv_ops": cudnn,
            "top_kernels_ms": [[n[:160], t / 1e3] for n, t in sorted(
                names.items(), key=lambda kv: -kv[1])[:12]]}


def _conv_workflow(device, epochs, stitch, layers=None):
    """mnist_conv at full width (its LAYERS, or ``layers``, minibatch
    100) over the synthetic stand-in, stitched or eager; the wall clock
    stamped at every train close."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import mnist_conv
    with engine_knobs(stitch=stitch, loader="auto", epoch_scan="off"):
        prng.seed_all(SEED)
        wf = mnist_conv.create_workflow(device=device, max_epochs=epochs,
                                        layers=layers)
    stamps = []
    close = wf.decision._close_class

    def timed_close(cls, check_epoch_end):
        out = close(cls, check_epoch_end)
        if cls == 2:
            stamps.append(time.perf_counter())
        return out
    wf.decision._close_class = timed_close
    wf.train_closes = stamps
    return wf


def _conv_run(device, epochs, stitch, layers=None, prepare=None):
    """Train it (``prepare(wf)`` first, where given); its closes, the
    evaluator's confusion matrix and the parameters and momenta."""
    wf = _conv_workflow(device, epochs, stitch, layers)
    if prepare is not None:
        prepare(wf)
    with engine_knobs(stitch=stitch, loader="auto", epoch_scan="off"):
        wf.run()
    if device.type == "cuda":
        gpu_sync()
    wf.evaluator.confusion_matrix.map_read()
    closes = [(c["epoch"], c["cls"], c["n_err"], c["samples"])
              for c in wf.decision.history]
    return (wf, closes, numpy.array(wf.evaluator.confusion_matrix.mem),
            wf.params_to_numpy())


def _conv_expected(closes, stitched):
    """The launches of a run whose closes are ``closes``: two GEMM
    layers a minibatch; on train minibatches both all2all GD units
    compute err_input (the convs below train) and carry the bias step in
    dw; one gather launch a minibatch serves the data and the labels
    (two f32 tables), by the eager fill's entry or the stitched head's."""
    n = sum(c[3] for c in closes) // 100
    train = sum(c[3] for c in closes if c[1] == "train") // 100
    launches = {"matmul": 2 * n, "matmul_bf16": 0, "gd_dx": 2 * train,
                "gd_dw": 2 * train, "gd_db": 0, "gd_db_in_dw": 2 * train,
                "gather": n, "gather_norm": 0, "gather_tables": 2 * n,
                "gather_norm_tables": 0}
    entries = {"veles_gather_group": 0 if stitched else n,
               "veles_gather_served": n if stitched else 0}
    return launches, entries, n, train


def phase_mnist_conv(device, smi):
    """The MNIST convnet (mnist_conv's LAYERS: two cuDNN convs, two max
    poolings, the 800→500 tanh and 500→10 softmax layers on the GEMM
    kernel) at full width, minibatch 100, on the eager and the stitched
    routes: each route's launches counted exactly, the wall ms of a
    steady epoch, the stitched graphs' captures and recaptures (0); then
    a 2-epoch run of each route under the profiler: cuDNN convs, the
    hand-written GEMM and GD kernels, and no cuBLAS GEMM."""
    from veles_tpu_torch.ops import gather
    out, paths, ok = {}, {}, True
    for route, stitch in (("eager", "off"), ("stitched", "on")):
        reset_all_launches()
        tic = time.perf_counter()
        wf, closes, _conf, _params = _conv_run(device, MNIST_CONV_EPOCHS,
                                               stitch)
        elapsed = time.perf_counter() - tic
        launches = mnist_launches()
        entries = dict(gather.entry_launches)
        want, want_entries, n, train = _conv_expected(closes,
                                                      stitch == "on")
        counted = launches == want and entries == want_entries
        report = wf.stitch_report()
        graphs_ok = (stitch == "off" and report == []) or (
            len(report) == 2
            and [r["dispatches"] for r in report] == [n, train]
            and all(r["captures"] == 1 and r["recaptures"] == 0
                    for r in report))
        # the sample does not learn the stand-in in three epochs on either
        # package (the JAX package's closes on the CPU: 888, 895, 895 of
        # 1000): the parity phase holds its numbers, this one its routes
        learned = all(numpy.isfinite(c[2]) for c in closes)
        # one train minibatch under the profiler: the last pass's first
        profiled = _conv_workflow(device, 2, stitch)
        served = []
        inner = profiled.loader.run

        def counting_run():
            served.append(int(profiled.loader.minibatch_class))
            inner()
        profiled.loader.run = counting_run
        with engine_knobs(stitch=stitch, loader="auto", epoch_scan="off"):
            window = zoo_profile(profiled.run)
        kinds = window["kernels_by_group"]
        profile_ok = (bool(window["cudnn_conv_ops"])
                      and kinds.get("veles_matmul", 0) > 0
                      and kinds.get("veles_gd_dw", 0) > 0
                      and not window["blas_ops"])
        route_ok = counted and graphs_ok and learned and profile_ok
        ok = ok and route_ok
        out[route] = {
            "ok": route_ok, "elapsed_s": elapsed,
            "steady_epoch_ms": _steady_epoch_ms(wf), "class_closes": closes,
            "launches": launches, "launches_expected": want,
            "entry_launches": entries, "entry_expected": want_entries,
            "minibatches": n, "train_minibatches": train,
            "graphs": report,
            "profile": dict(window, window="max_epochs=2: 2 validation "
                            "passes and 1 train pass (%d minibatches)"
                            % len(served))}
        paths["mnist_conv" if stitch == "off" else "mnist_conv_stitched"] = \
            dict(launches, **entries)
    emit({"phase": "mnist_conv", "nvidia_smi": smi, "ok": ok,
          "layers": "28x28x1: 20C5 strict_relu, MP2, 50C5 strict_relu, MP2, "
                    "800-500 tanh, 500-10 softmax", "minibatch": 100,
          "max_epochs": MNIST_CONV_EPOCHS,
          "data": "synthetic stand-in (6000 train, 1000 validation)",
          "epoch": "one validation pass (10 minibatches) and one train "
                   "pass (60)", **out})
    for route, info in out.items():
        check(info["ok"], "mnist_conv", "%s route: launches %s (want %s), "
              "entries %s (want %s), graphs %s, closes %s, profile groups "
              "%s, blas ops %s, cudnn ops %s" % (
                  route, info["launches"], info["launches_expected"],
                  info["entry_launches"], info["entry_expected"],
                  info["graphs"], info["class_closes"],
                  info["profile"]["kernels_by_group"],
                  info["profile"]["blas_ops"],
                  info["profile"]["cudnn_conv_ops"]))
    return paths


def _tie_free_layers():
    """mnist_conv's LAYERS with tanh convs and average pooling."""
    from veles_tpu_torch.samples import mnist_conv
    layers = copy.deepcopy(mnist_conv.LAYERS)
    for spec in layers:
        spec["type"] = {"conv_strict_relu": "conv_tanh",
                        "max_pooling": "avg_pooling"}.get(spec["type"],
                                                          spec["type"])
    return layers


def _plant_conv_gradient(wf):
    """Scale the first conv layer's weight gradient by
    TIE_FREE_PLANTED_SCALE in its GD unit's update."""
    gd = next(g for g in wf.gds
              if getattr(g, "forward", None) is wf.forwards[0])
    update = gd._update

    def planted_update(param, state, grad, hyper, key):
        if key == "w":
            grad = grad * TIE_FREE_PLANTED_SCALE
        return update(param, state, grad, hyper, key)
    gd._update = planted_update


def _tie_free_parity(device):
    """The tie-free stack, card (eager) against CPU, after
    MNIST_CONV_PARITY_EPOCHS; and the same card run with the planted
    gradient error, which must fail the bound."""
    layers = _tie_free_layers()
    _wf, c_closes, _conf, c_params = _conv_run(
        torch.device("cpu"), MNIST_CONV_PARITY_EPOCHS, "off", layers)
    out = {}
    for name, prepare in (("clean", None), ("planted", _plant_conv_gradient)):
        _wf, closes, _conf, params = _conv_run(
            device, MNIST_CONV_PARITY_EPOCHS, "off", layers, prepare)
        errs = _param_rel_errors(params, c_params)
        worst = max(errs, key=errs.get)
        out[name] = {"closes_equal": closes == c_closes,
                     "worst_leaf": worst, "rel_err": errs[worst],
                     "rel_err_by_leaf": errs,
                     "within": errs[worst] <= TIE_FREE_RTOL}
    out["ok"] = out["clean"]["within"] and out["clean"]["closes_equal"] \
        and not out["planted"]["within"]
    return out


def phase_mnist_conv_parity(device):
    """mnist_conv on the card (eager twice, and stitched) against the
    port's CPU route from one seed: every class close and the confusion
    matrix equal, each parameter leaf within MNIST_CONV_PARAM_RTOL of its
    largest value, each momentum within MOMENTUM_RTOL; the two eager card
    runs bit-equal (cuDNN's algorithms pinned at precision level 2); the
    tie-free stack within TIE_FREE_RTOL, and its planted gradient error
    caught."""
    _wf, c_closes, c_conf, c_params = _conv_run(
        torch.device("cpu"), MNIST_CONV_PARITY_EPOCHS, "on")
    runs = {}
    for name, stitch in (("eager", "off"), ("eager_again", "off"),
                         ("stitched", "on")):
        _wf, closes, conf, params = _conv_run(
            device, MNIST_CONV_PARITY_EPOCHS, stitch)
        errs = _param_rel_errors(params, c_params)
        weights, momenta = _split_leaves(errs, "gradient_")
        runs[name] = {"closes": closes, "confusion": conf,
                      "params": params, "rel_err_by_leaf": errs,
                      "param_rel_err": max(weights.values()),
                      "momentum_rel_err": max(momenta.values()),
                      "ok": (closes == c_closes
                             and numpy.array_equal(conf, c_conf)
                             and max(weights.values())
                             <= MNIST_CONV_PARAM_RTOL
                             and max(momenta.values()) <= MOMENTUM_RTOL)}
    a, b = runs["eager"]["params"], runs["eager_again"]["params"]
    repeat_gap = max(float(numpy.abs(a[k] - b[k]).max()) for k in a)
    tie_free = _tie_free_parity(device)
    ok = (all(r["ok"] for r in runs.values()) and repeat_gap == 0.0
          and tie_free["ok"])
    emit({"phase": "mnist_conv_parity", "ok": ok,
          "max_epochs": MNIST_CONV_PARITY_EPOCHS, "cpu_closes": c_closes,
          "param_rtol": MNIST_CONV_PARAM_RTOL,
          "momentum_rtol": MOMENTUM_RTOL,
          "cudnn_deterministic": torch.backends.cudnn.deterministic,
          "card_runs_bit_equal": repeat_gap == 0.0,
          "card_repeat_max_abs_gap": repeat_gap,
          "tie_free": dict(tie_free, rtol=TIE_FREE_RTOL,
                           planted_scale=TIE_FREE_PLANTED_SCALE,
                           layers="28x28x1: 20C5 tanh, AP2, 50C5 tanh, AP2, "
                                  "800-500 tanh, 500-10 softmax"),
          **{name: {"closes": r["closes"],
                    "confusion_equal": bool(numpy.array_equal(
                        r["confusion"], c_conf)),
                    "rel_err_by_leaf": r["rel_err_by_leaf"],
                    "param_rel_err": r["param_rel_err"],
                    "momentum_rel_err": r["momentum_rel_err"],
                    "ok": r["ok"]}
             for name, r in runs.items()}})
    for name, r in runs.items():
        check(r["ok"], "mnist_conv_parity", "%s card run against the CPU: "
              "closes %s vs %s, weights %.3g, momenta %.3g" % (
                  name, r["closes"], c_closes, r["param_rel_err"],
                  r["momentum_rel_err"]))
    check(repeat_gap == 0.0, "mnist_conv_parity", "two eager card runs "
          "differ by %.3g with cuDNN's algorithms pinned" % repeat_gap)
    check(tie_free["ok"], "mnist_conv_parity", "tie-free stack: clean %s "
          "%.3g, planted %s %.3g (bound %g)" % (
              tie_free["clean"]["worst_leaf"], tie_free["clean"]["rel_err"],
              tie_free["planted"]["worst_leaf"],
              tie_free["planted"]["rel_err"], TIE_FREE_RTOL))


def _split_leaves(errs, momentum_mark):
    """``errs`` split into the parameters' leaves and the momenta's
    (whose names hold ``momentum_mark``)."""
    momenta = {k: v for k, v in errs.items() if momentum_mark in k}
    return ({k: v for k, v in errs.items() if k not in momenta}, momenta)


def _alexnet_steps(device, dtype, layers=None, input_shape=None, batch=None,
                   steps=ALEXNET_STEPS, build=None):
    """``steps`` captured steps of a fused conv net on one fixed
    synthetic batch after its eager and captured first two: the losses,
    images/s, the launches of the timed steps and the step's graph
    report."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import alexnet
    from veles_tpu_torch.ops import gemm
    build = build or alexnet.build_fused
    prng.seed_all(SEED)
    kwargs = {} if layers is None else {"layers": layers}
    if input_shape is not None:
        kwargs["input_shape"] = input_shape
    shape = input_shape or alexnet.INPUT_SHAPE
    params, step, _eval, _apply = build(
        device=device, compute_dtype=None if dtype == "float32" else dtype,
        **kwargs)
    x, labels = alexnet.synthetic_imagenet_batch(batch, shape=shape)
    x = torch.from_numpy(x).to(device)
    labels = torch.from_numpy(labels).to(device)
    losses = []
    for _ in range(2):
        _p, metrics = step(params, x, labels)
        losses.append(float(metrics["loss"]))
    gpu_sync()
    reset_all_launches()
    tic = time.perf_counter()
    for _ in range(steps):
        _p, metrics = step(params, x, labels)
        losses.append(float(metrics["loss"]))
    elapsed = time.perf_counter() - tic
    launches = {k: gemm.launches[k] for k in ("matmul", "matmul_bf16")}
    return {"losses": losses, "images_per_s": steps * batch / elapsed,
            "step_ms": elapsed * 1e3 / steps, "launches": launches,
            "bf16_bodies": dict(gemm.bf16_bodies),
            "graphs": step.report(), "step": step, "params": params,
            "x": x, "labels": labels}


def _alexnet_parity():
    """One f32 AlexNet step at ALEXNET_PARITY_BATCH, card against CPU
    from one seed (the same dropout masks): each leaf's max abs error
    over its largest value."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import alexnet
    from veles_tpu_torch.znicz.fused_graph import to_numpy
    x, labels = alexnet.synthetic_imagenet_batch(ALEXNET_PARITY_BATCH)
    out = {}
    for dev in (torch.device("cuda", 0), torch.device("cpu")):
        prng.seed_all(SEED)
        params, step, _e, _a = alexnet.build_fused(device=dev)
        _p, metrics = step(params, torch.from_numpy(x).to(dev),
                           torch.from_numpy(labels).to(dev))
        out[dev.type] = (to_numpy(params), float(metrics["loss"]))
    errs = {}
    for i, (g, c) in enumerate(zip(out["cuda"][0], out["cpu"][0])):
        for key, ref in c.items():
            if ref is None or key == "seed":
                continue
            errs["%d.%s" % (i, key)] = float(
                numpy.abs(g[key] - ref).max()
                / max(float(numpy.abs(ref).max()), 1e-30))
    seeds_equal = all(numpy.array_equal(g["seed"], c["seed"])
                      for g, c in zip(out["cuda"][0], out["cpu"][0])
                      if "seed" in c)
    return errs, out["cuda"][1], out["cpu"][1], seeds_equal


def phase_alexnet_fused(device, smi):
    """``alexnet.build_fused()`` at full width (227×227×3, 1000 classes,
    batch 128), f32 and bf16: ALEXNET_STEPS captured steps each on one
    fixed batch, images/s, the GEMM launches a step (exact), one capture
    and no recapture, a finite loss that falls; a profile of two f32
    steps (where the time goes: cuDNN convs, the GEMM kernel, elementwise
    work, copies) and of one eager step (no aten GEMM op: no cuBLAS in
    the fully-connected layers); one f32 step at batch 8 held against
    the port's CPU step; one captured VGG-A step at full width (224×224×3,
    batch 32) with a finite loss."""
    from veles_tpu_torch.samples import vgg
    runs, paths, ok = {}, {}, True
    for dtype in ("float32", "bfloat16"):
        run = _alexnet_steps(device, dtype, batch=ALEXNET_BATCH)
        per_step = {k: v / ALEXNET_STEPS for k, v in run["launches"].items()}
        graph = run["graphs"]["step_%d" % ALEXNET_BATCH]
        losses = run["losses"]
        finite = all(numpy.isfinite(v) for v in losses)
        falls = finite and numpy.mean(losses[-3:]) < numpy.mean(losses[:3])
        bodies = {k: v / ALEXNET_STEPS
                  for k, v in run["bf16_bodies"].items()}
        counted = per_step == ALEXNET_STEP_LAUNCHES[dtype] and (
            dtype == "float32" or bodies == ALEXNET_BF16_STEP_BODIES)
        graphs_ok = (graph.get("eager") == 1 and graph.get("captures") == 1
                     and graph.get("recaptures") == 0
                     and graph.get("replays") == ALEXNET_STEPS + 1)
        step, params = run["step"], run["params"]
        x, labels = run["x"], run["labels"]

        def two_steps():
            for _ in range(2):
                step(params, x, labels)
        profile = zoo_profile(two_steps)
        run["profile"] = profile
        kinds = profile["kernels_by_group"]
        if dtype == "float32":
            # a graph replay records no aten op: one eager step shows
            # that no aten GEMM op runs (the fully-connected products
            # are the 9 GEMM launches); the "matmul" kernels of the
            # replays are then cuDNN's own (its im2col convs call
            # cuBLAS)
            eager = zoo_profile(lambda: step.step_fn(params, x, labels))
            run["eager_profile"] = eager
            want = ALEXNET_STEP_LAUNCHES[dtype]["matmul"]
            profile_ok = (bool(eager["cudnn_conv_ops"])
                          and not eager["blas_ops"]
                          and eager["kernels_by_group"].get(
                              "veles_matmul", 0) == want
                          and kinds.get("conv", 0) > 0
                          and kinds.get("veles_matmul", 0) == 2 * want)
        else:
            # the six bf16 products of each step on the bf16 bodies
            want = ALEXNET_STEP_LAUNCHES[dtype]["matmul_bf16"]
            profile_ok = kinds.get("veles_matmul_bf16", 0) == 2 * want
        busy = profile["device_busy_ms"]
        run["gemm_share"] = sum(
            profile["device_ms_by_group"].get(g, 0.0)
            for g in ("veles_matmul", "veles_matmul_bf16")) / busy \
            if busy else None
        run_ok = finite and falls and counted and graphs_ok and profile_ok
        ok = ok and run_ok
        runs[dtype] = {
            "ok": run_ok, "images_per_s": run["images_per_s"],
            "step_ms": run["step_ms"], "losses": losses,
            "launches_per_step": per_step,
            "launches_per_step_expected": ALEXNET_STEP_LAUNCHES[dtype],
            "bf16_bodies_per_step": bodies,
            "graphs": run["graphs"], "profile": run.get("profile"),
            "gemm_share_of_busy": run.get("gemm_share"),
            "eager_step_profile": run.get("eager_profile")}
        paths["alexnet_fused_" + dtype] = dict(run["launches"],
                                               **run["bf16_bodies"])
        del run
        torch.cuda.empty_cache()
    errs, g_loss, c_loss, seeds_equal = _alexnet_parity()
    weights, momenta = _split_leaves(errs, ".v")
    worst = max(weights, key=weights.get)
    worst_momentum = max(momenta, key=momenta.get)
    parity_ok = (weights[worst] <= ALEXNET_PARAM_RTOL
                 and momenta[worst_momentum] <= MOMENTUM_RTOL
                 and seeds_equal
                 and abs(g_loss - c_loss) <= 1e-4 * abs(c_loss))
    torch.cuda.empty_cache()
    vgg_run = _alexnet_steps(device, "float32", batch=VGG_BATCH, steps=1,
                             input_shape=vgg.INPUT_SHAPE,
                             build=vgg.build_fused)
    vgg_graph = vgg_run["graphs"]["step_%d" % VGG_BATCH]
    vgg_ok = (all(numpy.isfinite(v) for v in vgg_run["losses"])
              and vgg_graph.get("captures") == 1
              and vgg_graph.get("recaptures") == 0)
    paths["vgg_fused"] = dict(vgg_run["launches"])
    vgg_info = {"ok": vgg_ok, "losses": vgg_run["losses"],
                "step_ms": vgg_run["step_ms"],
                "images_per_s": vgg_run["images_per_s"],
                "graphs": vgg_run["graphs"], "remat": True}
    del vgg_run
    torch.cuda.empty_cache()
    ok = ok and parity_ok and vgg_ok
    emit({"phase": "alexnet_fused", "nvidia_smi": smi, "ok": ok,
          "input": "227x227x3, 1000 classes", "batch": ALEXNET_BATCH,
          "steps_timed": ALEXNET_STEPS,
          "data": "one synthetic N(0,1) batch (seed 0), the JAX "
                  "package's stand-in", **runs,
          "parity": {"batch": ALEXNET_PARITY_BATCH, "dtype": "float32",
                     "param_rel_err_by_leaf": errs, "worst_leaf": worst,
                     "worst_momentum_leaf": worst_momentum,
                     "param_rtol": ALEXNET_PARAM_RTOL,
                     "momentum_rtol": MOMENTUM_RTOL, "card_loss": g_loss,
                     "cpu_loss": c_loss, "seeds_equal": seeds_equal,
                     "ok": parity_ok},
          "vgg": dict(vgg_info, input="224x224x3", batch=VGG_BATCH)})
    for dtype, info in runs.items():
        check(info["ok"], "alexnet_fused", "%s: launches a step %s (want "
              "%s), bf16 bodies %s (want %s), graphs %s, losses %s, "
              "profile %s" % (
                  dtype, info["launches_per_step"],
                  info["launches_per_step_expected"],
                  info["bf16_bodies_per_step"], ALEXNET_BF16_STEP_BODIES,
                  info["graphs"],
                  info["losses"], info["profile"] and
                  (info["profile"]["kernels_by_group"],
                   info["profile"]["blas_ops"])))
    check(parity_ok, "alexnet_fused", "card step against the CPU step: %s "
          "%.3g (bound %g), %s %.3g (bound %g), losses %r %r, seeds equal "
          "%s" % (worst, errs[worst], ALEXNET_PARAM_RTOL, worst_momentum,
                  errs[worst_momentum], MOMENTUM_RTOL, g_loss, c_loss,
                  seeds_equal))
    check(vgg_ok, "alexnet_fused", "VGG-A step: %s" % vgg_info)
    return paths


# -- the batch serving path -------------------------------------------------

SERVE_BATCH_EPOCHS = 2           # one validation and one train pass
SERVE_BATCH_MAX = 64             # buckets 1, 2, 4, ..., 64
SERVE_BATCH_REQUESTS = 256
SERVE_BATCH_CLIENTS = 16
SERVE_BATCH_ROWS = (1, 4)        # rows a request, inclusive
SERVE_BATCH_TOL = 1e-5           # replies against the plain forward
SERVE_BATCH_SWAP_CLIENTS = 8
SERVE_BATCH_SWAP_SCALE = 0.5     # v2's weights and biases: v1's times this
SERVE_BATCH_INT8_REQUESTS = 64
SERVE_BATCH_CALIBRATION = 100
SERVE_BATCH_INT8_BYTES = 0.35    # int8 params bytes <= this x float's
SERVE_BATCH_PROFILE_CALLS = 24
SERVE_BATCH_TIMED_M = (1, 8, 64)
SERVE_BATCH_LAYERS = ((784, 100, "tanh"), (100, 10, None))
SERVE_BATCH_HTTP_TIMEOUT = 60


def _post_rows(port, name, rows, b64):
    """One ``POST /service/<name>`` of ``rows`` as JSON lists or base64
    float32 bytes: ``(status, result rows or None)``."""
    import base64
    import urllib.error
    import urllib.request
    if b64:
        payload = {"input_b64": base64.b64encode(rows.tobytes()).decode(),
                   "shape": list(rows.shape), "dtype": "float32"}
    else:
        payload = {"input": rows.tolist()}
    req = urllib.request.Request(
        "http://127.0.0.1:%d/service/%s" % (port, name),
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(
                req, timeout=SERVE_BATCH_HTTP_TIMEOUT) as resp:
            body = json.loads(resp.read())
            return resp.status, numpy.asarray(body["result"],
                                              numpy.float32)
    except urllib.error.HTTPError as e:
        return e.code, None


def _serve_requests(port, name, pool, count, clients, seed):
    """``count`` requests of 1..4 rows drawn from ``pool``, half JSON
    and half base64, from ``clients`` threads:
    ``[(rows, status, reply)]`` in request order and the wall time."""
    import threading
    rng = numpy.random.default_rng(seed)
    requests = []
    for i in range(count):
        n = int(rng.integers(SERVE_BATCH_ROWS[0], SERVE_BATCH_ROWS[1] + 1))
        rows = numpy.ascontiguousarray(
            pool[rng.integers(0, len(pool), n)], numpy.float32)
        requests.append((rows, i % 2 == 1))
    out = [None] * count

    def client(k):
        for i in range(k, count, clients):
            rows, b64 = requests[i]
            out[i] = (rows,) + _post_rows(port, name, rows, b64)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    tic = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, time.perf_counter() - tic


def _plain_forward(params, rows, device):
    """The served MLP's plain version on the card: ``_matmul_ref`` (or
    ``_qmatmul_ref`` for an int8 weight) with the activation, then the
    softmax."""
    from veles_tpu_torch.ops import gemm, qgemm
    from veles_tpu_torch.znicz.all2all import _softmax
    h = torch.from_numpy(rows).to(device)
    for (_k, _n, act), p in zip(SERVE_BATCH_LAYERS, params):
        if isinstance(p["w"], dict):
            h = qgemm._qmatmul_ref(h, p["w"]["q"], p["w"]["scale"], p["b"],
                                   act, out_dtype=torch.float32)
        else:
            h = gemm._matmul_ref(h, p["w"], p["b"], act)
    return _softmax(h).cpu().numpy()


def _graphs_of(engine):
    graphs = [b.graph for b in engine._buckets.values()]
    return {"captures": sum(g.captures for g in graphs),
            "recaptures": sum(g.recaptures for g in graphs),
            "replays": sum(g.replays for g in graphs),
            "capture_s": sum(g.capture_seconds for g in graphs),
            "pool_reserved_bytes": sum(g.pool_reserved_bytes
                                       for g in graphs)}


def _serving_replays_window(engine, pool, groups):
    """A profile of SERVE_BATCH_PROFILE_CALLS direct ``infer`` calls at
    1..64 rows (each one bucket replay): its summary, taken again, at
    most PROFILE_TRIES windows, while it counted other than 2 kernels of
    ``groups`` a call."""
    sizes = [1 + (7 * i) % SERVE_BATCH_MAX
             for i in range(SERVE_BATCH_PROFILE_CALLS)]

    def work():
        for n in sizes:
            engine.infer(pool[:n])

    for tries in range(1, PROFILE_TRIES + 1):
        window = profile_window(work, ("veles_matmul", "qmatmul",
                                       "matmul"))
        counted = sum(window["kernels_by_group"].get(g, 0) for g in groups)
        if counted == 2 * len(sizes):
            break
    window["profile_windows"] = tries
    window["calls"] = len(sizes)
    return window


def _serving_timed(device):
    """The GEMM (``_matmul_cuda``) and qmatmul (``_qmatmul_cuda``, f32
    activations) at the served layers' shapes and M = 1, 8 and 64: device
    time per call (:func:`device_ms`) beside the plain version, one
    library call (``addmm``; ``addmm`` on a dequantized f32 copy for
    qmatmul) and the bound of each."""
    from veles_tpu_torch import quant
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import gemm, qgemm
    rng = numpy.random.default_rng(SEED + 29)
    rows = {"matmul": [], "qmatmul": []}
    for k, n, act in SERVE_BATCH_LAYERS:
        w = rng.standard_normal((k, n)).astype(numpy.float32) / k ** 0.5
        pair = quant.quantize_array(w, (0,))
        q = torch.from_numpy(pair["q"]).to(device)
        scale = torch.from_numpy(pair["scale"]).to(device).reshape(-1)
        wt = torch.from_numpy(w).to(device)
        deq = (q.float() * scale).contiguous()
        b = torch.from_numpy(rng.standard_normal(n).astype(
            numpy.float32)).to(device)
        for m in SERVE_BATCH_TIMED_M:
            a = torch.from_numpy(rng.standard_normal((m, k)).astype(
                numpy.float32)).to(device)
            ops = 2 * m * n * k
            f_bytes = 4 * (m * k + k * n + n + m * n)
            q_bytes = 4 * m * k + k * n + 4 * n + 4 * n + 4 * m * n
            for name, kernel, plain, library, nbytes in (
                    ("matmul",
                     lambda: gemm._matmul_cuda(a, wt, b, act),
                     lambda: gemm._matmul_ref(a, wt, b, act),
                     lambda: torch.addmm(b, a, wt), f_bytes),
                    ("qmatmul",
                     lambda: qgemm._qmatmul_cuda(a, q, scale, b, act,
                                                 torch.float32),
                     lambda: qgemm._qmatmul_ref(a, q, scale, b, act,
                                                torch.float32),
                     lambda: torch.addmm(b, a, deq), q_bytes)):
                bound, by = bound_seconds(nbytes, ops, "float32")
                err = float((kernel() - plain()).abs().max())
                rows[name].append({
                    "shape": [m, k, n], "activation": act,
                    "ms": device_ms(kernel), "plain_ms": device_ms(plain),
                    "library_ms": device_ms(library),
                    "bound_ms": bound * 1e3, "bound_by": by,
                    "max_abs_err": err})
    return rows


def phase_serve_batch(device, smi):
    """The batch serving path at MNIST width: the port's MLP trained
    through its stitched workflow, served by ``InferenceEngine`` (one
    CUDA graph a bucket) behind ``ModelRegistry`` and ``ServingServer``,
    float and int8.  Returns the GEMM and qmatmul launches of the
    counted float and int8 traffic, and the serving timings."""
    import threading
    from veles_tpu_torch import quant
    from veles_tpu_torch.ops import gemm, qgemm
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch.serve import (InferenceEngine, ModelRegistry,
                                       ServingMetrics, ServingServer)
    phase = "serve_batch"
    tic = time.perf_counter()
    wf = mnist.create_workflow(max_epochs=SERVE_BATCH_EPOCHS)
    wf.run()
    wf.device.sync()
    train_s = time.perf_counter() - tic
    closes = [h["n_err"] for h in wf.decision.history
              if h["cls"] == "validation"]
    check(len(closes) == 2 and closes[-1] < closes[0], phase,
          "the workflow did not learn: validation n_err %s" % closes)
    wf.loader.original_data.map_read()
    # the stand-in's test rows: the validation class, first in the data
    test_rows = numpy.array(
        wf.loader.original_data.mem[:wf.loader.class_lengths[1]],
        numpy.float32)

    engine = InferenceEngine.from_workflow(wf, max_batch_size=SERVE_BATCH_MAX)
    check(engine.device.type == "cuda", phase, "the engine is not on the card")
    metrics = ServingMetrics()
    registry = ModelRegistry(metrics=metrics)
    registry.deploy("mnist", engine)
    warm = engine.compile_count
    warm_graphs = _graphs_of(engine)
    check(warm == len(engine.buckets) == 7 and warm_graphs["captures"] == 7
          and warm_graphs["recaptures"] == 0, phase,
          "warmup: compile_count %d for buckets %s, graphs %s"
          % (warm, engine.buckets, warm_graphs))
    server = ServingServer(registry=registry, host="127.0.0.1",
                           port=0).start()
    try:
        # -- the counted float traffic
        reset_all_launches()
        calls0, batches0 = engine.infer_calls, metrics.batches_total
        replies, wall = _serve_requests(server.port, "mnist", test_rows,
                                        SERVE_BATCH_REQUESTS,
                                        SERVE_BATCH_CLIENTS, SEED + 31)
        gpu_sync()
        float_launches = {"matmul": gemm.launches["matmul"],
                          "qmatmul": qgemm.launches["qmatmul"]}
        calls = engine.infer_calls - calls0
        batches = metrics.batches_total - batches0
        graphs = _graphs_of(engine)
        statuses = sorted({r[1] for r in replies})
        check(statuses == [200], phase, "replies %s" % statuses)
        rows_sent = sum(len(r[0]) for r in replies)
        exact = sum(r[2].tobytes() == engine.reference_forward(r[0])
                    .tobytes() for r in replies)
        plain_err = max(float(numpy.abs(
            r[2] - _plain_forward(engine._params, r[0], device)).max())
            for r in replies)
        ok = (exact == len(replies) and plain_err <= SERVE_BATCH_TOL
              and engine.compile_count == warm
              and graphs["captures"] == 7 and graphs["recaptures"] == 0
              and calls < SERVE_BATCH_REQUESTS and calls == batches
              and float_launches == {"matmul": 2 * calls, "qmatmul": 0})
        latency = {"p%d" % q: metrics.request_latency.percentile(q) * 1e3
                   for q in (50, 95, 99)}
        latency["mean"] = metrics.request_latency.mean * 1e3
        traffic = {
            "requests": len(replies), "rows": rows_sent,
            "clients": SERVE_BATCH_CLIENTS, "wall_s": wall,
            "requests_per_s": len(replies) / wall,
            "rows_per_s": rows_sent / wall,
            "latency_ms": latency,
            "batch_latency_ms": {
                "p%d" % q: metrics.batch_latency.percentile(q) * 1e3
                for q in (50, 99)},
            "infer_calls": calls, "rows_per_infer_call": rows_sent / calls,
            "batch_fill_ratio": metrics.batch_fill_ratio(),
            "launches": float_launches, "replies_bit_equal": exact,
            "max_abs_err_vs_plain": plain_err,
            "compile_count": engine.compile_count, "graphs": graphs}
        emit({"phase": phase, "step": "float", "ok": ok,
              "train_s": train_s, "validation_n_err": closes, **traffic})
        check(ok, phase, "float traffic: %d of %d replies bit-equal to "
              "reference_forward, max err %.3g vs the plain forward, "
              "compile_count %d (warm %d), graphs %s, %d infer calls for "
              "%d requests (%d batches), launches %s"
              % (exact, len(replies), plain_err, engine.compile_count, warm,
                 graphs, calls, len(replies), batches, float_launches))

        # -- replays under the profiler: the GEMM kernel, never cuBLAS
        window = _serving_replays_window(engine, test_rows,
                                         ("veles_matmul",))
        got = window["kernels_by_group"]
        ok = (got.get("veles_matmul", 0) == 2 * window["calls"]
              and got.get("matmul", 0) == 0 and not got.get("qmatmul"))
        emit({"phase": phase, "step": "replay_profile", "ok": ok,
              **{k: window[k] for k in (
                  "calls", "profile_windows", "kernels_by_group",
                  "device_ms_by_group", "busy_share", "wall_ms",
                  "kernel_names")}})
        check(ok, phase, "a replay window of %d calls counted kernels %s"
              % (window["calls"], got))

        # -- a profiled window of served HTTP traffic: the busy share
        served = {}

        def http_window():
            served["out"] = _serve_requests(
                server.port, "mnist", test_rows, 64, SERVE_BATCH_CLIENTS,
                SEED + 37)

        busy = profile_window(http_window)
        emit({"phase": phase, "step": "http_profile",
              "requests": len(served["out"][0]),
              **{k: busy[k] for k in (
                  "wall_ms", "device_busy_ms", "busy_share",
                  "device_ms_by_group", "kernels_by_group",
                  "device_kernels", "host_gaps_ms_total",
                  "top_host_gaps_ms")}})

        # -- bucket rows at M = 16 and 32 against the exact shape
        probe = test_rows[:16]
        bucket16 = engine.infer(probe)
        bucket32 = engine.infer(test_rows[:17])[:16]
        float_16_32 = bucket16.tobytes() == bucket32.tobytes()

        # -- hot swap under traffic: every reply v1's or v2's, whole
        v1_host = quant.core._host(engine._params)
        v2 = InferenceEngine.from_workflow(wf, max_batch_size=SERVE_BATCH_MAX)
        v2.update_params([{k: v * SERVE_BATCH_SWAP_SCALE
                           for k, v in state.items()}
                          for state in v1_host])
        stop = threading.Event()
        swap_replies = []
        rng = numpy.random.default_rng(SEED + 41)
        picks = [rng.integers(0, len(test_rows), int(rng.integers(1, 5)))
                 for _ in range(4096)]

        def swap_client(k):
            i = k
            while not stop.is_set() and i < len(picks):
                rows = numpy.ascontiguousarray(test_rows[picks[i]])
                status, reply = _post_rows(server.port, "mnist", rows,
                                           i % 2 == 1)
                swap_replies.append((rows, status, reply))
                i += SERVE_BATCH_SWAP_CLIENTS

        threads = [threading.Thread(target=swap_client, args=(k,))
                   for k in range(SERVE_BATCH_SWAP_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        registry.deploy("mnist", v2)
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join()
        versions = {"v1": 0, "v2": 0, "torn": 0}
        for rows, status, reply in swap_replies:
            if status != 200:
                versions["torn"] += 1
            elif reply.tobytes() == engine.reference_forward(rows).tobytes():
                versions["v1"] += 1
            elif reply.tobytes() == v2.reference_forward(rows).tobytes():
                versions["v2"] += 1
            else:
                versions["torn"] += 1
        ok = (versions["torn"] == 0 and versions["v1"] > 0
              and versions["v2"] > 0 and registry.get("mnist").swaps == 1
              and v2.compile_count == 7 and _graphs_of(v2)["recaptures"] == 0)
        emit({"phase": phase, "step": "hot_swap", "ok": ok,
              "replies": len(swap_replies), **versions,
              "v2_compile_count": v2.compile_count})
        check(ok, phase, "hot swap: replies by version %s" % versions)

        # -- int8: the same path through the qmatmul kernel
        calibration = test_rows[:SERVE_BATCH_CALIBRATION]
        e8 = InferenceEngine.from_workflow(wf, max_batch_size=SERVE_BATCH_MAX)
        float_bytes = e8.params_nbytes
        float_calibration = e8.reference_forward(calibration)
        registry.deploy("mnist_int8", e8, quantize="int8",
                        calibration=calibration)
        drift = quant.relative_drift(float_calibration,
                                     e8.reference_forward(calibration))
        reset_all_launches()
        calls0 = e8.infer_calls
        replies8, wall8 = _serve_requests(
            server.port, "mnist_int8", test_rows, SERVE_BATCH_INT8_REQUESTS,
            SERVE_BATCH_CLIENTS, SEED + 43)
        gpu_sync()
        int8_launches = {"matmul": gemm.launches["matmul"],
                         "qmatmul": qgemm.launches["qmatmul"]}
        calls8 = e8.infer_calls - calls0
        statuses = sorted({r[1] for r in replies8})
        plain8 = max(float(numpy.abs(
            r[2] - _plain_forward(e8._params, r[0], device)).max())
            for r in replies8) if statuses == [200] else None
        exact8 = sum(r[2] is not None and r[2].tobytes()
                     == e8.reference_forward(r[0]).tobytes()
                     for r in replies8)
        int8_16 = e8.infer(probe)
        int8_32 = e8.infer(test_rows[:17])[:16]
        window8 = _serving_replays_window(e8, test_rows, ("qmatmul",))
        got8 = window8["kernels_by_group"]
        ok = (statuses == [200] and plain8 <= SERVE_BATCH_TOL
              and drift < quant.DRIFT_TOL
              and e8.params_nbytes <= SERVE_BATCH_INT8_BYTES * float_bytes
              and int8_launches == {"matmul": 0, "qmatmul": 2 * calls8}
              and e8.compile_count == 7
              and _graphs_of(e8)["recaptures"] == 0
              and got8.get("qmatmul", 0) == 2 * window8["calls"]
              and got8.get("matmul", 0) == 0
              and not got8.get("veles_matmul"))
        emit({"phase": phase, "step": "int8", "ok": ok,
              "requests": len(replies8), "wall_s": wall8,
              "requests_per_s": len(replies8) / wall8,
              "infer_calls": calls8, "launches": int8_launches,
              "max_abs_err_vs_plain": plain8, "drift": drift,
              "drift_tol": quant.DRIFT_TOL,
              "params_bytes": e8.params_nbytes, "float_params_bytes":
              float_bytes, "params_ratio": e8.params_nbytes / float_bytes,
              "replies_bit_equal_reference": exact8,
              "rows_equal_at_16_and_32": {
                  "float": float_16_32,
                  "int8": int8_16.tobytes() == int8_32.tobytes(),
                  "int8_max_abs_diff": float(numpy.abs(
                      int8_16 - int8_32).max())},
              "replay_profile": {k: window8[k] for k in (
                  "calls", "profile_windows", "kernels_by_group",
                  "device_ms_by_group", "kernel_names")}})
        check(ok, phase, "int8: statuses %s, max err %s vs the plain "
              "forward, drift %.4g, params %d of %d bytes, launches %s for "
              "%d calls, compile_count %d, replay kernels %s"
              % (statuses, plain8, drift, e8.params_nbytes, float_bytes,
                 int8_launches, calls8, e8.compile_count, got8))
        text = server.metrics_page()
        check("veles_serve_requests_total" in text
              and "veles_prof_recompiles_total 0" in text
              and "veles_slo_batch_fill" in text, phase,
              "the /metrics page lacks its serving lines")
    finally:
        server.stop()
    timed = _serving_timed(device)
    emit({"phase": phase, "step": "timed", "nvidia_smi": smi, **timed})
    emit({"phase": phase, "ok": True, "nvidia_smi": smi,
          "requests_per_s": traffic["requests_per_s"],
          "latency_ms_p50": traffic["latency_ms"]["p50"],
          "latency_ms_p99": traffic["latency_ms"]["p99"],
          "rows_per_infer_call": traffic["rows_per_infer_call"],
          "batch_fill_ratio": traffic["batch_fill_ratio"],
          "http_busy_share": busy["busy_share"]})
    return {"matmul": float_launches["matmul"],
            "qmatmul": int8_launches["qmatmul"]}, timed


#: the card's first train window's health statistics against the CPU
#: route's over the same window
TOOLING_STATS_RTOL = 1e-4
TOOLING_STATS = ("grad_norm", "weight_norm", "update_norm", "update_ratio")
#: the kernels the device trace of a warm stitched epoch must name: the
#: forward GEMM body, the dw body (``veles_gd_dw``'s launch) and the
#: served gather
TOOLING_TRACE_NAMES = ("veles_gemm_kernel<0,", "veles_gemm_kernel<2,",
                       "veles_gather_served_kernel")


def _steady_windows(wf, epochs=2):
    """``epochs`` more unprofiled epochs of a windowed workflow whose
    graphs are captured: each window entry's share of the ledger over
    just those epochs (replays only), ``{name: {"dispatches", "steps",
    "device_ms", "flops", "achieved_flops", "mfu"}}``."""
    from veles_tpu_torch import prof
    entries = [e for e in prof.ledger.entries("segment")
               if e.name.startswith("scan:") and e.device == "cuda"]
    before = {id(e): (e.dispatches, e.steps, e.dispatch_ns,
                      e.flops_dispatched) for e in entries}
    with engine_knobs(stitch="on", loader="auto", epoch_scan="auto"):
        wf.decision.complete <<= False
        wf.decision.max_epochs += epochs
        wf.run()
        gpu_sync()
    rows = {}
    for e in entries:
        d0, s0, ns0, f0 = before[id(e)]
        if e.dispatches == d0:
            continue
        ns, flops = e.dispatch_ns - ns0, e.flops_dispatched - f0
        achieved = flops / (ns / 1e9) if ns else 0.0
        peak = e.peak_for(prof.peak_flops())
        rows[e.name] = {"dispatches": e.dispatches - d0,
                        "steps": e.steps - s0, "device_ms": ns / 1e6,
                        "flops": flops, "achieved_flops": achieved,
                        "mfu": achieved / peak if peak else None,
                        "peak_dtype": e.peak_dtype}
    return rows


def _mnist_native(device, max_epochs):
    from veles_tpu_torch.samples import mnist
    return mnist.create_workflow(device=device, max_epochs=max_epochs,
                                 native=True)


def _first_train_snapshot(out):
    """A ``_scan_counted_run`` ``prepare``: the health snapshot right
    after the first window that observed train steps, into ``out``."""
    def prepare(wf):
        from veles_tpu_torch import watch
        runner = wf.epoch_runner
        execute = runner._execute_window

        def watched(k_max):
            execute(k_max)
            if "snapshot" not in out and watch.monitor.steps:
                out["snapshot"] = watch.monitor.snapshot()
        runner._execute_window = watched
    return prepare


def _poisoned(wf):
    weights = wf.forwards[0].weights
    weights.map_write()
    weights.mem[0, 0] = numpy.nan


def _strict_verdict(device):
    """The HealthError of a strict windowed run with a NaN planted in
    layer 1's weights: ``{"leaf", "count", "step", "windows"}``, or None
    when none was raised."""
    from veles_tpu_torch import trace
    from veles_tpu_torch.watch import HealthError
    box = {}

    def prepare(wf):
        _poisoned(wf)
        box["wf"] = wf
    try:
        with engine_knobs(health="strict"):
            _scan_counted_run(device, _mnist_native, MNIST_SCAN_EPOCHS,
                              "auto", prepare=prepare)
    except HealthError as exc:
        return {"leaf": exc.leaf, "count": exc.count, "step": exc.step,
                "windows": box["wf"].epoch_runner.windows}
    finally:
        trace.configure()
        trace.recorder.clear()
    return None


def _stats_agree(got, want):
    """Every group's statistics within TOOLING_STATS_RTOL of ``want``'s
    and its non-finite counts equal: ``(ok, worst relative error)``."""
    worst, ok = 0.0, set(got["groups"]) == set(want["groups"])
    for name, group in want["groups"].items():
        mine = got["groups"].get(name, {})
        for stat in TOOLING_STATS:
            err = abs(mine.get(stat, numpy.inf) - group[stat]) \
                / max(abs(group[stat]), 1e-30)
            worst = max(worst, err)
        ok = ok and mine.get("nonfinite") == group["nonfinite"] \
            and mine.get("leaves") == group["leaves"]
    return ok and worst <= TOOLING_STATS_RTOL, worst


def _device_traced(device):
    """A stitched epoch (per-step graphs, captured in the epoch before)
    under ``trace.device_trace``: the trace's path and which of
    TOOLING_TRACE_NAMES it names."""
    import os

    from veles_tpu_torch import prng, trace
    with engine_knobs(stitch="on", loader="auto", epoch_scan="off"):
        prng.seed_all(SEED)
        wf = _mnist_native(device, 1)
        wf.run()
        wf.decision.complete <<= False
        wf.decision.max_epochs += 1
        with trace.device_trace(logdir=os.path.join(
                "build", "torch_trace")) as ctx:
            wf.run()
    if ctx.path is None:
        return None, {}
    with open(ctx.path) as fin:
        text = fin.read()
    return ctx.path, {name: name in text for name in TOOLING_TRACE_NAMES}


def phase_tooling(device, smi, scan_nodes):
    """The tooling on the card (the docstring's phase 24); returns the
    health-on window run's launches."""
    import veles_tpu_torch.prof.__main__ as prof_cli
    import veles_tpu_torch.watch.__main__ as watch_cli
    from veles_tpu_torch import prof, trace
    tic = time.perf_counter()
    info = {"phase": "tooling", "nvidia_smi": smi}
    # the windows with health off, then on, from the same seed
    runs, params = {}, {}
    first = {}
    for mode in ("off", "on"):
        with engine_knobs(health=mode):
            wf, counted = _scan_counted_run(
                device, _mnist_native, MNIST_SCAN_EPOCHS, "auto",
                prepare=_first_train_snapshot(first) if mode == "on"
                else None)
            launches = _counted()
            params[mode] = wf.params_to_numpy()
            steady = _steady_windows(wf)
            nodes = _replay_nodes(wf)
        runs[mode] = {"launches": launches, "replay_nodes": nodes,
                      "steady_windows": steady,
                      "graphs": {str(k): g["graph_launches"] for k, g
                                 in counted["epoch_scan"]["graphs"].items()},
                      "steady_epoch_wall_ms": counted["epoch_wall_ms"][2]}
        trace.configure()
    expected = _counted_expected(_launches_of(MNIST_SCAN_STEPS,
                                              MNIST_STEP_LAUNCHES))
    bit_equal = sorted(params["off"]) == sorted(params["on"]) and all(
        numpy.array_equal(numpy.asarray(params["off"][k]),
                          numpy.asarray(params["on"][k]))
        for k in params["off"])
    off_nodes = {k: v["nodes"] for k, v in runs["off"]["replay_nodes"].items()}
    want_nodes = {k: v["nodes"] for k, v in scan_nodes.items()}
    added = {k: {"nodes": v["nodes"] - runs["off"]["replay_nodes"][k]["nodes"],
                 "busy_ms": v["busy_ms"]
                 - runs["off"]["replay_nodes"][k]["busy_ms"]}
             for k, v in runs["on"]["replay_nodes"].items()
             if k in runs["off"]["replay_nodes"]}
    info.update({"runs": runs, "weights_bit_equal": bit_equal,
                 "mnist_scan_replay_nodes": want_nodes,
                 "health_added_per_replay": added,
                 "launches_expected": expected})
    # the card's first train window against the CPU route's
    cpu = {}
    with engine_knobs(health="on"):
        # two epochs: the first is the validation pass alone
        _scan_counted_run("cpu", _mnist_native, 2, "auto",
                          prepare=_first_train_snapshot(cpu))
    trace.configure()
    stats_ok, worst = (False, None)
    if "snapshot" in first and "snapshot" in cpu:
        stats_ok, worst = _stats_agree(first["snapshot"], cpu["snapshot"])
    info["first_window_stats"] = {"card": first.get("snapshot"),
                                  "cpu": cpu.get("snapshot"),
                                  "worst_rel_err": worst,
                                  "rtol": TOOLING_STATS_RTOL}
    # strict, a NaN planted in layer 1's weights, card and CPU
    strict = {"card": _strict_verdict(device),
              "cpu": _strict_verdict("cpu")}
    strict_ok = (strict["card"] is not None and strict["cpu"] is not None
                 and strict["card"]["leaf"] == strict["cpu"]["leaf"]
                 and strict["card"]["step"] == strict["cpu"]["step"]
                 == MNIST_SCAN_KEYS[1][1]
                 and strict["card"]["windows"] == 2)
    info["strict"] = strict
    # the smokes
    try:
        import zmq  # noqa: F401
        has_zmq = True
    except ImportError:
        has_zmq = False
    print("tooling: pyzmq %s; the watch smoke %s"
          % ("imports" if has_zmq else "is not installed",
             "runs" if has_zmq else "does not run"), flush=True)
    recompiles0 = prof.ledger.recompiles
    info["prof_smoke_rc"] = prof_cli.run_smoke(
        "veles_tpu_torch.samples.mnist")
    info["watch_smoke_rc"] = watch_cli.run_smoke() if has_zmq else None
    smokes_ok = (info["prof_smoke_rc"] == 0
                 and info["watch_smoke_rc"] in (0, None)
                 and prof.ledger.recompiles == recompiles0)
    # the device trace
    info["device_trace"], names = _device_traced(device)
    info["device_trace_names"] = names
    trace_ok = bool(names) and all(names.values())
    # the ledger's rows, every path of the run
    summary = prof.summary()
    rows = summary["entries"]
    info["ledger"] = {"card": smi, "device_kind": summary["device_kind"],
                      "peak_flops_bf16": summary["peak_flops"],
                      "totals": summary["totals"], "rows": rows}
    kinds = sorted({r["kind"] for r in rows if r.get("device") == "cuda"})
    ledger_ok = (all(r["flops"] > 0 for r in rows)
                 and all(r["mfu"] is not None for r in rows
                         if r["dispatches"] and r.get("device") == "cuda")
                 and summary["totals"]["recompiles"] == 0
                 and {"segment", "bucket", "prefill", "decode"} <= set(kinds))
    print(prof.report_text(summary), end="", flush=True)
    info["tooling_s"] = time.perf_counter() - tic
    info["ok"] = (bit_equal and off_nodes == want_nodes
                  and runs["off"]["launches"] == expected
                  and runs["on"]["launches"] == expected and stats_ok
                  and strict_ok and smokes_ok and trace_ok and ledger_ok)
    emit(info)
    check(bit_equal, "tooling", "health on changed the weights")
    check(off_nodes == want_nodes, "tooling", "health off: nodes a replay "
          "%s, mnist_scan's %s" % (off_nodes, want_nodes))
    check(runs["off"]["launches"] == expected
          and runs["on"]["launches"] == expected, "tooling",
          "launches off %s, on %s, want %s"
          % (runs["off"]["launches"], runs["on"]["launches"], expected))
    check(stats_ok, "tooling", "first window's stats card vs CPU: %s"
          % info["first_window_stats"])
    check(strict_ok, "tooling", "strict verdicts %s" % strict)
    check(smokes_ok, "tooling", "smokes: prof %s, watch %s"
          % (info["prof_smoke_rc"], info["watch_smoke_rc"]))
    check(trace_ok, "tooling", "device trace %s names %s"
          % (info["device_trace"], names))
    check(ledger_ok, "tooling", "ledger kinds %s, totals %s, rows %s"
          % (kinds, summary["totals"], rows))
    return runs["on"]["launches"]


# -- checkpoints (ROADMAP 7(a)) ---------------------------------------------

SNAPSHOT_EPOCHS = 3
SNAPSHOT_RESUME_EPOCHS = 5
SNAPSHOT_SERVE_REQUESTS = 64
SNAPSHOT_SERVE_CLIENTS = 8
# the served rows' error rate (157 of the validation rows) may exceed the
# artifact's validation error over all 1000 by this many points
SNAPSHOT_SERVE_ERROR_SLACK_PT = 10.0
CHECKPOINT_EPOCHS = 2
CHECKPOINT_RESUME_EPOCHS = 4
# the JAX package's refusal of the windows with a unit off the Decision
SNAPSHOT_SCAN_REASON = "units hang off DecisionGD in the training loop"
# a stand-in epoch: 10 validation and 60 train minibatches of 100
STAND_IN_STEPS = (10, 60)


@contextlib.contextmanager
def _class_closes(decision_cls):
    """Every class close of ``decision_cls``'s instances, recorded as
    ``_record_closes`` records it, by Decision (weakly held): patched on
    the class, since a snapshot pickles the instances."""
    import weakref
    records = weakref.WeakKeyDictionary()
    close = decision_cls._close_class

    def recording(self, cls, check_epoch_end):
        ev = self.evaluator
        ev.confusion_matrix.map_read()
        records.setdefault(self, []).append({
            "epoch": int(self.epoch_number), "cls": cls,
            "n_err": float(self.epoch_n_err[cls]),
            "samples": int(self.epoch_samples[cls]),
            "confusion": numpy.array(ev.confusion_matrix.mem)})
        return close(self, cls, check_epoch_end)
    decision_cls._close_class = recording
    try:
        yield records
    finally:
        decision_cls._close_class = close


@contextlib.contextmanager
def _snapshot_timings():
    """The snapshotter's synchronous capture (the pickle at the gate)
    and its background write, each in ms, with the card's params read
    right before each capture and the artifacts' paths."""
    from veles_tpu_torch import snapshotter
    dumps = snapshotter.checked_dumps
    export = snapshotter.SnapshotterToFile.export
    write = snapshotter.SnapshotterToFile._write
    out = {"capture_ms": [], "write_ms": [], "params": [], "paths": []}

    def timed_dumps(obj, logger=None):
        tic = time.perf_counter()
        data = dumps(obj, logger=logger)
        out["capture_ms"].append((time.perf_counter() - tic) * 1e3)
        return data

    def recorded_export(self):
        gpu_sync()
        out["params"].append(self.workflow.params_to_numpy())
        export(self)
        out["paths"].append(self._destination)

    def timed_write(self, data, path, name, ext):
        tic = time.perf_counter()
        write(self, data, path, name, ext)
        out["write_ms"].append((time.perf_counter() - tic) * 1e3)
    snapshotter.checked_dumps = timed_dumps
    snapshotter.SnapshotterToFile.export = recorded_export
    snapshotter.SnapshotterToFile._write = timed_write
    try:
        yield out
    finally:
        snapshotter.checked_dumps = dumps
        snapshotter.SnapshotterToFile.export = export
        snapshotter.SnapshotterToFile._write = write


def _mnist_counts():
    """``mnist_launches`` with the gather launches by C entry and the
    GEMM launches that split K."""
    from veles_tpu_torch.ops import gather, gemm
    return dict(mnist_launches(), **gather.entry_launches,
                **gemm.split_launches)


def _prng_states():
    from veles_tpu_torch import prng
    return {name: gen.__getstate__() for name, gen in prng._streams.items()}


def _set_prng_states(states):
    from veles_tpu_torch import prng
    for name, state in states.items():
        prng.get(name).__setstate__(state)


def _resume_snapshot(path, dev, epochs, records, directory):
    """The JAX package's resume protocol on ``dev``: load, raise
    ``max_epochs``, clear ``complete``, ``initialize``, ``run``.
    Returns the workflow, its ``(closes, params)``, the ms of
    ``initialize`` and of the run."""
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.snapshotter import load_snapshot
    wf = load_snapshot(path)
    wf.launcher = DummyLauncher()
    wf.snapshotter.directory = directory
    wf.decision.max_epochs = epochs
    wf.decision.complete <<= False
    tic = time.perf_counter()
    wf.initialize(device=dev)
    init_ms = (time.perf_counter() - tic) * 1e3
    tic = time.perf_counter()
    wf.run()
    if dev.type == "cuda":
        gpu_sync()
    run_ms = (time.perf_counter() - tic) * 1e3
    wf.stop()
    return wf, (records.get(wf.decision, []),
                wf.params_to_numpy()), init_ms, run_ms


def _load_without_cuda(path):
    """The artifact's params, loaded by a Python process that sees no
    card (``CUDA_VISIBLE_DEVICES=``): ``(params, report)``."""
    import os
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, numpy, torch\n"
            "from veles_tpu_torch.snapshotter import load_snapshot\n"
            "wf = load_snapshot(sys.argv[1])\n"
            "numpy.savez(sys.argv[2], **wf.params_to_numpy())\n"
            "print(torch.cuda.is_available(), torch.cuda.device_count())\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = here + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "params.npz")
        tic = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code, path, out],
                              cwd=here, env=env, capture_output=True,
                              text=True, timeout=600)
        wall = time.perf_counter() - tic
        report = {"rc": proc.returncode, "stdout": proc.stdout.strip(),
                  "stderr_tail": proc.stderr[-2000:], "wall_s": wall}
        if proc.returncode != 0:
            return None, report
        with numpy.load(out, allow_pickle=False) as archive:
            return {name: archive[name] for name in archive.files}, report


def phase_snapshot(device, smi, tmp):
    """ROADMAP 7(a) on the card: the native stitched MNIST MLP trained
    with ``snapshot_dir`` (3 epochs; ``epoch_scan=auto``, which the
    snapshotter off the Decision must refuse with the JAX reason), its
    last artifact resumed on the card and on the CPU to 5 epochs under
    the JAX resume protocol and held together, and the artifact loaded
    by a process that sees no card.  Returns the training run's and the
    card resume's launches, and the artifact's path."""
    import os

    from veles_tpu_torch import prng
    from veles_tpu_torch.memory import Watcher
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch.znicz.decision import DecisionGD
    phase = "snapshot"
    snap_dir = os.path.join(tmp, "snapshots")
    with engine_knobs(stitch="on", loader="auto", epoch_scan="auto"), \
            _class_closes(DecisionGD) as records:
        prng.seed_all(SEED)
        Watcher.reset()
        wf = mnist.create_workflow(device=device, max_epochs=SNAPSHOT_EPOCHS,
                                   native=True, snapshot_dir=snap_dir)
        # a snapshot at every improvement: the card runs a stand-in epoch
        # in well under the default second between two snapshots
        wf.snapshotter.time_interval = 0.0
        with _snapshot_timings() as timings:
            reset_all_launches()
            tic = time.perf_counter()
            wf.run()
            gpu_sync()
            train_s = time.perf_counter() - tic
            launches = _mnist_counts()
            wf.stop()
        scan = wf.epoch_scan_report()
        report = wf.stitch_report()
        path = timings["paths"][-1]
        artifacts = sorted(name for name in os.listdir(snap_dir)
                           if "_current" not in name)
        refused = (not scan["eligible"]
                   and str(scan["reason"]).startswith(SNAPSHOT_SCAN_REASON)
                   and scan["windows"] == 0)
        trained = (launches == dict(MNIST_STITCHED_LAUNCHES,
                                    **MNIST_STITCHED_ENTRY_LAUNCHES,
                                    **MNIST_SPLIT_LAUNCHES)
                   and [r["dispatches"] for r in report]
                   == MNIST_STITCHED_DISPATCHES
                   and [r["captures"] for r in report] == [1, 1]
                   and all(r["recaptures"] == 0 for r in report))
        written = (len(artifacts) >= 1 and len(timings["write_ms"])
                   == len(timings["capture_ms"]) == len(timings["paths"])
                   and os.path.getsize(path) > 0)

        # -- the resume, on the card and then on the CPU, from the same
        # stream positions (the streams are the process's, as in the JAX
        # package: a resumed run draws from where they are)
        states = _prng_states()
        from veles_tpu_torch.snapshotter import load_snapshot
        artifact = load_snapshot(path)
        start_epoch = int(artifact.loader.epoch_number)
        steps = _resume_steps(start_epoch, SNAPSHOT_RESUME_EPOCHS)
        reset_all_launches()
        card_wf, card, init_ms, run_ms = _resume_snapshot(
            path, device, SNAPSHOT_RESUME_EPOCHS, records,
            os.path.join(tmp, "resumed_card"))
        resume_launches = _mnist_counts()
        resume_report = card_wf.stitch_report()
        _set_prng_states(states)
        _cpu_wf, cpu, _i, cpu_run_ms = _resume_snapshot(
            path, torch.device("cpu"), SNAPSHOT_RESUME_EPOCHS, records,
            os.path.join(tmp, "resumed_cpu"))
    agreement = _agreement(card, cpu)
    want_resume = dict(_launches_of(steps, MNIST_STEP_LAUNCHES),
                       veles_gather_group=0)
    resumed = (resume_launches == _with_zeros(want_resume, resume_launches)
               and [r["dispatches"] for r in resume_report] == list(steps)
               and [r["captures"] for r in resume_report] == [1, 1]
               and all(r["recaptures"] == 0 for r in resume_report)
               and card_wf.epoch_scan_report()["windows"] == 0
               and card[0][0]["epoch"] == start_epoch
               and card[0][0]["cls"] == 2)

    # -- the artifact in a process without a card
    loaded, sub = _load_without_cuda(path)
    at_export = timings["params"][-1]
    bitwise = loaded is not None and sorted(loaded) == sorted(at_export) \
        and all(numpy.array_equal(loaded[k], at_export[k])
                for k in at_export)
    no_card = sub["stdout"].startswith("False 0")
    info = {
        "phase": phase, "nvidia_smi": smi, "ok": False,
        "layers": "784-100 all2all_tanh, 100-10 softmax", "native": True,
        "minibatch": 100, "max_epochs": SNAPSHOT_EPOCHS,
        "resume_to": SNAPSHOT_RESUME_EPOCHS, "seed": SEED,
        "train_s": train_s, "epoch_scan": _scan_json(scan),
        "windows_refused": refused, "segments": report,
        "launches": launches,
        "artifacts": artifacts,
        "artifact": os.path.basename(path),
        "artifact_bytes": os.path.getsize(path),
        "artifact_epoch": start_epoch,
        "capture_ms": timings["capture_ms"],
        "background_write_ms": timings["write_ms"],
        "resume_card": {"initialize_ms": init_ms,
                        "capture_ms": sum(r["capture_s"]
                                          for r in resume_report) * 1e3,
                        "initialize_plus_capture_ms": init_ms + sum(
                            r["capture_s"] for r in resume_report) * 1e3,
                        "run_ms": run_ms, "segments": resume_report,
                        "captures": sum(r["captures"]
                                        for r in resume_report),
                        "recaptures": sum(r["recaptures"]
                                          for r in resume_report),
                        "launches": resume_launches,
                        "launches_expected": want_resume,
                        "epoch_scan": _scan_json(
                            card_wf.epoch_scan_report())},
        "resume_cpu_run_ms": cpu_run_ms,
        "card_vs_cpu_resume": agreement,
        "param_rtol": MNIST_PARAM_RTOL,
        "no_card_process": dict(sub, params_bit_equal=bitwise),
    }
    info["ok"] = (refused and trained and written and resumed
                  and agreement["ok"] and bitwise and no_card)
    emit(info)
    check(refused, phase, "the windows were not refused with the JAX "
          "reason: %s" % scan)
    check(trained, phase, "the training run's launches or segments: %s %s"
          % (launches, report))
    check(written, phase, "artifacts %s, timings %s" % (
        artifacts, {k: v for k, v in timings.items() if k != "params"}))
    check(resumed, phase, "the card resume's launches %s (want %s) or "
          "segments %s" % (resume_launches, want_resume, resume_report))
    check(agreement["ok"], phase, "the card resume disagrees with the "
          "CPU resume: %s" % agreement)
    check(no_card and bitwise, phase, "the artifact in a process without "
          "a card: %s, params bit-equal %s" % (sub, bitwise))
    return launches, resume_launches, path


def _scan_json(report):
    """An ``epoch_scan_report()`` with its graphs keyed by strings."""
    return dict(report, graphs={str(key): value for key, value in
                                report.get("graphs", {}).items()})


def _resume_steps(start_epoch, epochs):
    """(forward, train) steps of a resume from the validation close of
    ``start_epoch`` to ``epochs``: that epoch's train pass, the full
    epochs after it, and the last epoch's validation pass."""
    valid, train = STAND_IN_STEPS
    full = epochs - 2 - start_epoch
    return (train + full * (valid + train) + valid,
            train * (epochs - 1 - start_epoch))


def _with_zeros(want, got):
    """``want`` with the counters ``got`` has and ``want`` lacks at 0."""
    return dict({name: 0 for name in got}, **want)


def phase_snapshot_serve(device, smi, path):
    """``ModelRegistry.load_snapshot`` of the snapshot phase's artifact
    on the card (the preflight off): 64 requests of 1–4 rows from 8
    threads, each reply bit-equal to ``reference_forward`` of the
    unpickled workflow's engine, 2 GEMM launches an infer call.
    Returns the counted requests' launches."""
    import threading

    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import gemm
    from veles_tpu_torch.serve import ModelRegistry, ServingMetrics
    from veles_tpu_torch.snapshotter import load_snapshot
    phase = "snapshot_serve"
    artifact = load_snapshot(path)
    loader = artifact.loader
    rows_u8 = numpy.array(loader.original_data.mem[:loader.class_lengths[1]])
    # the rows as the loader head hands them to the first layer
    pool = (rows_u8.astype(numpy.float32)
            * numpy.float32(1.0 / 255.0)).astype(numpy.float32)
    labels = numpy.array(loader.original_labels[:loader.class_lengths[1]])
    best_pt = float(artifact.decision.best_n_err_pt)
    serve = root.common.serve
    saved = serve.get("preflight")
    serve.preflight = "off"
    registry = ModelRegistry(metrics=ServingMetrics())
    try:
        tic = time.perf_counter()
        model = registry.load_snapshot("mnist", path, engine_config={
            "max_batch_size": SERVE_BATCH_MAX})
        load_s = time.perf_counter() - tic
        engine = model.engine
        graphs = _graphs_of(engine)
        params_equal = all(
            numpy.array_equal(engine._params[i]["w"].cpu().numpy(),
                              fwd.weights.mem)
            and numpy.array_equal(engine._params[i]["b"].cpu().numpy(),
                                  fwd.bias.mem)
            for i, fwd in enumerate(artifact.forwards))
        rng = numpy.random.default_rng(SEED + 41)
        requests = []
        for _ in range(SNAPSHOT_SERVE_REQUESTS):
            n = int(rng.integers(1, 5))
            start = int(rng.integers(0, len(pool) - n))
            requests.append((start, n))
        replies = [None] * len(requests)

        def client(k):
            for i in range(k, len(requests), SNAPSHOT_SERVE_CLIENTS):
                start, n = requests[i]
                replies[i] = registry.infer("mnist", pool[start:start + n])
        reset_all_launches()
        calls0 = engine.infer_calls
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SNAPSHOT_SERVE_CLIENTS)]
        tic = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        gpu_sync()
        wall = time.perf_counter() - tic
        launches = dict(gemm.launches)
        calls = engine.infer_calls - calls0
        exact = sum(
            replies[i].tobytes() == engine.reference_forward(
                pool[s:s + n]).tobytes()
            for i, (s, n) in enumerate(requests))
        predicted = numpy.concatenate([numpy.argmax(r, axis=1)
                                       for r in replies])
        truth = numpy.concatenate([labels[s:s + n] for s, n in requests])
        after = _graphs_of(engine)
        info = {
            "phase": phase, "nvidia_smi": smi,
            "artifact": path.rsplit("/", 1)[-1], "load_s": load_s,
            "device": str(engine.device), "buckets": engine.buckets,
            "requests": len(requests), "clients": SNAPSHOT_SERVE_CLIENTS,
            "rows": int(sum(n for _s, n in requests)), "wall_s": wall,
            "requests_per_s": len(requests) / wall, "infer_calls": calls,
            "launches": launches, "bit_equal_replies": exact,
            "params_equal_artifact": params_equal,
            "graphs_after_warmup": graphs, "graphs_after": after,
            "error_rate": float(numpy.mean(predicted != truth)),
            "artifact_best_validation_error_pt": best_pt,
        }
        info["ok"] = (engine.device.type == "cuda" and params_equal
                      and exact == len(requests)
                      and graphs["captures"] == len(engine.buckets)
                      and after["captures"] == graphs["captures"]
                      and after["recaptures"] == 0
                      and launches.get("matmul") == 2 * calls
                      and launches.get("gd_dx", 0) == 0
                      and info["error_rate"] * 100 <= best_pt
                      + SNAPSHOT_SERVE_ERROR_SLACK_PT)
        emit(info)
    finally:
        registry.stop()
        if saved is None:
            serve.__dict__.pop("preflight", None)
        else:
            serve.preflight = saved
    check(info["ok"], phase, "replies %d of %d bit-equal, launches %s "
          "for %d calls, graphs %s -> %s, params equal %s, error rate "
          "%.4f against the artifact's %.2f %%"
          % (exact, len(requests), launches, calls, graphs, after,
             params_equal, info["error_rate"], best_pt))
    return launches


def _checkpoint_run(dev, tmp, records):
    """The window route's train-state protocol on ``dev``: train 2
    epochs, ``capture_train_state`` → ``TrainCheckpointer.save``, a
    freshly built workflow, ``restore`` onto its own state → 
    ``restore_train_state`` → run on to 4 epochs.  Returns the continued
    run's ``(closes, params)``, its launches and workflow, and the
    checkpoint's numbers."""
    import os

    from veles_tpu_torch import prng
    from veles_tpu_torch.checkpoint import TrainCheckpointer
    prng.seed_all(SEED)
    wf = _mnist_native(dev, CHECKPOINT_EPOCHS)
    wf.run()
    windows_before = wf.epoch_scan_report()["windows"]
    import tempfile
    folder = tempfile.mkdtemp(prefix="checkpoint_%s_" % dev.type, dir=tmp)
    ckpt = TrainCheckpointer(folder)
    tic = time.perf_counter()
    train, meta = wf.capture_train_state()
    ckpt.save(CHECKPOINT_EPOCHS, train, meta)
    save_ms = (time.perf_counter() - tic) * 1e3
    step_dir = os.path.join(folder, str(CHECKPOINT_EPOCHS))
    step_bytes = sum(os.path.getsize(os.path.join(step_dir, name))
                     for name in os.listdir(step_dir))
    prng.seed_all(SEED + 1)
    fresh = _mnist_native(dev, CHECKPOINT_RESUME_EPOCHS)
    abstract, _meta = fresh.capture_train_state()
    tic = time.perf_counter()
    _step, got_train, got_meta = ckpt.restore(abstract)
    restored = fresh.restore_train_state(got_train, got_meta)
    if dev.type == "cuda":
        gpu_sync()
    restore_ms = (time.perf_counter() - tic) * 1e3
    ckpt.close()
    fresh.decision.complete <<= False
    reset_all_launches()
    fresh.run()
    if dev.type == "cuda":
        gpu_sync()
    launches = _mnist_counts()
    numbers = {"save_ms": save_ms, "restore_ms": restore_ms,
               "step_dir_bytes": step_bytes, "units_restored": restored,
               "windows_before": windows_before,
               "pending": meta["u002_MnistLoader"]["pending"]}
    return ((records.get(fresh.decision, []), fresh.params_to_numpy()),
            launches, fresh, numbers)


def phase_checkpoint(device, smi, tmp):
    """``TrainCheckpointer`` on the window route (``epoch_scan=auto``, no
    snapshotter): ``_checkpoint_run`` on the card and on the CPU, held
    together (n_err and confusion equal, parameters within 1e-4 of each
    leaf's largest value), with the continued card run's exact launches
    (the pending minibatch served again one step, then windows) and the
    step directory's bytes, save and restore ms.  Returns the continued
    card run's launches."""
    from veles_tpu_torch.znicz.decision import DecisionGD
    phase = "checkpoint"
    with engine_knobs(stitch="on", loader="auto", epoch_scan="auto"), \
            _class_closes(DecisionGD) as records:
        card, launches, card_wf, numbers = _checkpoint_run(device, tmp,
                                                          records)
        cpu, _l, _wf, cpu_numbers = _checkpoint_run(torch.device("cpu"),
                                                    tmp, records)
    agreement = _agreement(card, cpu)
    # the pending (last validation) minibatch again, then the train pass
    # of epoch 1, epoch 2 whole and epoch 3's validation pass
    valid, train = STAND_IN_STEPS
    steps = (1 + train + (valid + train) + valid, 2 * train)
    want = dict(_launches_of(steps, MNIST_STEP_LAUNCHES),
                veles_gather_group=0)
    scan = card_wf.epoch_scan_report()
    counted = launches == _with_zeros(want, launches)
    ok = (agreement["ok"] and counted and numbers["windows_before"] > 0
          and scan["windows"] > 0 and numbers["units_restored"] == 4
          and len(numbers["pending"]) == 1)
    emit({"phase": phase, "nvidia_smi": smi, "ok": ok,
          "epochs": CHECKPOINT_EPOCHS,
          "continued_to": CHECKPOINT_RESUME_EPOCHS, "route": "windows",
          "card": numbers, "cpu": cpu_numbers,
          "card_vs_cpu": agreement, "param_rtol": MNIST_PARAM_RTOL,
          "launches": launches, "launches_expected": want,
          "epoch_scan": _scan_json(scan)})
    check(counted, phase, "launches %s, want %s" % (launches, want))
    check(ok, phase, "the continued card run disagrees with the CPU's, or "
          "ran no windows: %s, %s, %s" % (agreement, numbers, scan))
    return launches


# -- the rest of the layer zoo and the data side (ROADMAP 7(c)) ---------------

#: three epochs, two train passes: the steady epoch is the second
#: (a validation pass and a train pass, every graph captured in the
#: first)
MNIST_RNN_EPOCHS = 3
MNIST_RNN_PARITY_EPOCHS = 2
#: mnist_rnn's shape: T rows of D pixels, H hidden units, C classes
MNIST_RNN_SHAPE = dict(t=28, d=28, h=128, classes=10)
#: card against CPU after MNIST_RNN_PARITY_EPOCHS (eager and stitched):
#: each weight, bias and momentum leaf within this share of its largest
#: value.  The LSTM has no max or relu to turn a rounding into a choice,
#: so two f32 runs that sum their products in other orders (cuBLAS on
#: the card, MKL on the CPU, TF32 off) stay f32 noise apart after the
#: 60 steps: on an H100 8.7e-7 (the head's momentum; the LSTM's weights
#: 1.7e-7), so 1e-5 leaves an 11x margin.  A 1 % error planted in the
#: LSTM's weight gradient (MNIST_RNN_PLANTED_SCALE) must fail it (on
#: an H100: 1.2e-2, and the closes move).
MNIST_RNN_PARAM_RTOL = 1e-5
MNIST_RNN_PLANTED_SCALE = 1.01
#: the softmax head's GEMM launches a fused step: its forward (train and
#: eval), its input gradient and weight gradient (the LSTM below trains)
RNN_FUSED_TRAIN_PRODUCTS = 3
RNN_FUSED_EVAL_PRODUCTS = 1
#: mnist_ae's RBM pretraining (hidden 100, CD-1, lr 0.1, the first 2000
#: train images, minibatch 100): a flipped Bernoulli draw moves the
#: weights of its hidden unit's column by at most lr/batch = 1e-3 (a
#: visible value and a probability both lie in [0, 1]), and the steps
#: after it carry that on (a flip of a step's last sample, which CD-k
#: does not use, moves nothing); card against CPU the weights must stay
#: within RBM_FLIP_ABS · (1 + flipped draws) max abs at the end, and
#: within RBM_RTOL of the largest weight after every step before the
#: first flip (all of them when none flipped).  At most RBM_MAX_FLIPS of
#: the 400,000 draws may flip (1e-5 of them; an H100 flipped 1): a
#: sampler that is wrong on the card flips about half, and a planted one
#: (``>=`` for ``<``) must fail the count
RBM_FLIP_ABS = 1e-3
RBM_RTOL = 1e-4
RBM_MAX_FLIPS = 4
MNIST_AE_RBM_EPOCHS = 2
KOHONEN_EPOCHS = 10
#: the SOM card against CPU: at most KOHONEN_MAX_MOVED of the 10,100
#: winners may move (a near tie of two distances; an H100 moved none),
#: the codebook within KOHONEN_RTOL of its largest value after every
#: step before the first move (f32 sums in other orders; an H100:
#: 1.6e-7 after all 101 steps), the quantization error within
#: KOHONEN_QERR_RTOL.  A planted argmin (each winner one neuron on)
#: must fail
KOHONEN_RTOL = 1e-4
KOHONEN_MAX_MOVED = 4
KOHONEN_QERR_RTOL = 1e-3
#: MeanDisp, the joiner, the avatar and HOG, card against CPU: max abs
DATA_SIDE_TOL = 1e-5
#: the normalizers that ``as_affine()`` cannot express (a per-sample
#: map, a non-linear one): the host normalizes the dataset at
#: initialize and the head gathers it raw
HOST_ONLY_NORMS = ("exp", "linear")
#: a normalizer's served minibatches, card against CPU and against the
#: host ``normalize``: the largest gap within this share of the largest
#: served value (the kernel's f32 x·scale + shift against numpy's own
#: order of the same map: a few ulps of the largest value)
NORM_SERVED_RTOL = 1e-5
DATA_SIDE_EPOCHS = 2
#: the validation_ratio MLP, card against CPU: MNIST_PARAM_RTOL's bound
DATA_SIDE_PARAM_RTOL = 1e-4


def _rnn_workflow(device, epochs, route, layers=None):
    """mnist_rnn at full width (its LAYERS, or ``layers``, minibatch
    100) over the synthetic stand-in on ``route`` (eager, stitched or
    fused); the wall clock stamped at every train close."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import mnist_rnn
    with engine_knobs(stitch="off" if route == "eager" else "on",
                      loader="auto", epoch_scan="off"):
        prng.seed_all(SEED)
        wf = mnist_rnn.create_workflow(device=device, max_epochs=epochs,
                                       layers=layers,
                                       fused=(route == "fused"))
    stamps = []
    close = wf.decision._close_class

    def timed_close(cls, check_epoch_end):
        out = close(cls, check_epoch_end)
        if cls == 2:
            stamps.append(time.perf_counter())
        return out
    wf.decision._close_class = timed_close
    wf.train_closes = stamps
    return wf


def _rnn_run(device, epochs, route, layers=None, prepare=None):
    """Train it (``prepare(wf)`` first, where given); its closes, the
    evaluator's confusion matrix (None on the fused route, which runs no
    evaluator unit) and the parameters and momenta."""
    wf = _rnn_workflow(device, epochs, route, layers)
    if prepare is not None:
        prepare(wf)
    with engine_knobs(stitch="off" if route == "eager" else "on",
                      loader="auto", epoch_scan="off"):
        wf.run()
    if device.type == "cuda":
        gpu_sync()
    confusion = None
    if route == "fused":
        wf.fused_trainer.sync_weights()
    else:
        wf.evaluator.confusion_matrix.map_read()
        confusion = numpy.array(wf.evaluator.confusion_matrix.mem)
    closes = [(c["epoch"], c["cls"], c["n_err"], c["samples"])
              for c in wf.decision.history]
    return wf, closes, confusion, wf.params_to_numpy()


def _rnn_expected(closes, route):
    """The kernel launches of a run whose closes are ``closes``: the
    softmax head's GEMM a minibatch; on train minibatches its GD unit's
    dx (the LSTM below trains) and dw with the bias step; one gather
    launch a minibatch for the rows and the labels (two tables), by the
    eager fill's entry or the stitched head's.  The fused step runs the
    head's three products through the GEMM kernel's autograd and gathers
    inside its graph."""
    n = sum(c[3] for c in closes) // 100
    train = sum(c[3] for c in closes if c[1] == "train") // 100
    if route == "fused":
        launches = {"matmul": RNN_FUSED_TRAIN_PRODUCTS * train
                    + RNN_FUSED_EVAL_PRODUCTS * (n - train),
                    "matmul_bf16": 0, "gd_dx": 0, "gd_dw": 0, "gd_db": 0,
                    "gd_db_in_dw": 0}
        entries = {"veles_gather_group": n, "veles_gather_served": 0}
        return launches, entries, n, train
    launches = {"matmul": n, "matmul_bf16": 0, "gd_dx": train,
                "gd_dw": train, "gd_db": 0, "gd_db_in_dw": train,
                "gather": n, "gather_norm": 0, "gather_tables": 2 * n,
                "gather_norm_tables": 0}
    stitched = route == "stitched"
    entries = {"veles_gather_group": 0 if stitched else n,
               "veles_gather_served": n if stitched else 0}
    return launches, entries, n, train


def _rnn_epoch_flops(train, evals):
    """One epoch's work by the JAX formulas: ``train`` train steps of
    ``lstm_train_flops`` and ``evals`` forwards of ``lstm_fwd_flops``,
    the softmax head included, at minibatch 100."""
    from veles_tpu_torch.znicz.rnn import lstm_fwd_flops, lstm_train_flops
    s = MNIST_RNN_SHAPE
    args = (100, s["t"], s["d"], s["h"], 4, s["classes"])
    return train * lstm_train_flops(*args) + evals * lstm_fwd_flops(*args)


def phase_mnist_rnn(device, smi):
    """mnist_rnn (an LSTM of 128 over 28 rows of 28 pixels, its last
    state into a softmax of 10, minibatch 100, lr 0.01, momentum 0.9) at
    full width on the stand-in on each route: eager units,
    stitched segments (each one CUDA graph: the loader head, the LSTM's
    28 steps, the head and the evaluator; the head's GD and the LSTM's
    VJP) and the fused step (one graph a step shape), 3 epochs (two
    train passes) on each.  Each route's GEMM,
    GD and gather launches counted exactly, the graphs' captures and
    recaptures (0), the wall ms of the steady epoch, its MFU by
    ``lstm_train_flops``, and a 2-epoch run under the profiler: device ms
    by group (the gates' cuBLAS products, elementwise, the hand-written
    GEMM and gather kernels, copies)."""
    from veles_tpu_torch.backends import peak_ops
    from veles_tpu_torch.ops import gather
    peak = peak_ops(torch.cuda.get_device_name(0), "float32")
    out, paths, ok = {}, {}, True
    for route in ("eager", "stitched", "fused"):
        reset_all_launches()
        tic = time.perf_counter()
        wf, closes, _conf, _params = _rnn_run(device, MNIST_RNN_EPOCHS,
                                              route)
        elapsed = time.perf_counter() - tic
        launches = mnist_launches()
        entries = dict(gather.entry_launches)
        want, want_entries, n, train = _rnn_expected(closes, route)
        counted = (all(launches[k] == v for k, v in want.items())
                   and entries == want_entries)
        if route == "fused":
            report = wf.fused_trainer.graph_report()
            graphs_ok = (_graphs_expected(report, train, n - train)
                         and report["train_100"].get("graph_launches", {})
                         .get("matmul") == RNN_FUSED_TRAIN_PRODUCTS
                         and report["eval_100"].get("graph_launches", {})
                         .get("matmul") == RNN_FUSED_EVAL_PRODUCTS)
        else:
            report = wf.stitch_report()
            graphs_ok = (route == "eager" and report == []) or (
                len(report) == 2
                and [r["dispatches"] for r in report] == [n, train]
                and all(r["captures"] == 1 and r["recaptures"] == 0
                        for r in report))
        learned = all(numpy.isfinite(c[2]) for c in closes)
        steady = _steady_epoch_ms(wf)
        epoch_flops = _rnn_epoch_flops(60, 10)
        mfu = (epoch_flops / (steady[-1] / 1e3) / peak
               if steady and peak else None)
        profiled = _rnn_workflow(device, 2, route)
        with engine_knobs(stitch="off" if route == "eager" else "on",
                          loader="auto", epoch_scan="off"):
            window = zoo_profile(profiled.run)
        groups = window["kernels_by_group"]
        profile_ok = (groups.get("veles_matmul", 0) > 0
                      and groups.get("matmul", 0) > 0
                      and not window["cudnn_conv_ops"])
        if route != "fused":
            profile_ok = profile_ok and groups.get("veles_gd_dw", 0) > 0
        window["device_ms_by_group"] = {
            {"matmul": "cublas_gates"}.get(g, g): t
            for g, t in window["device_ms_by_group"].items()}
        route_ok = counted and graphs_ok and learned and profile_ok
        ok = ok and route_ok
        out[route] = {
            "ok": route_ok, "elapsed_s": elapsed, "steady_epoch_ms": steady,
            "epoch_flops": epoch_flops, "mfu_f32": mfu,
            "class_closes": closes, "launches": launches,
            "launches_expected": want, "entry_launches": entries,
            "entry_expected": want_entries, "minibatches": n,
            "train_minibatches": train, "graphs": report,
            "profile": dict(window, window="max_epochs=2: 2 validation "
                            "passes and 1 train pass")}
        paths["mnist_rnn" if route == "eager" else "mnist_rnn_" + route] = \
            dict(launches, **entries)
    emit({"phase": "mnist_rnn", "nvidia_smi": smi, "ok": ok,
          "layers": "(28, 28) rows: LSTM 128 last_only, 128-10 softmax",
          "minibatch": 100, "max_epochs": MNIST_RNN_EPOCHS,
          "data": "synthetic stand-in (6000 train, 1000 validation)",
          "epoch": "one validation pass (10 minibatches) and one train "
                   "pass (60)", "peak_f32_flops": peak, **out})
    for route, info in out.items():
        check(info["ok"], "mnist_rnn", "%s route: launches %s (want %s), "
              "entries %s (want %s), graphs %s, closes %s, profile groups "
              "%s" % (route, info["launches"], info["launches_expected"],
                      info["entry_launches"], info["entry_expected"],
                      info["graphs"], info["class_closes"],
                      info["profile"]["kernels_by_group"]))
    return paths


def _plant_lstm_gradient(wf):
    """Scale the LSTM's weight gradient by MNIST_RNN_PLANTED_SCALE in
    its GD unit's update."""
    gd = next(g for g in wf.gds
              if getattr(g, "forward", None) is wf.forwards[0])
    update = gd._update

    def planted_update(param, state, grad, hyper, key):
        if key == "w":
            grad = grad * MNIST_RNN_PLANTED_SCALE
        return update(param, state, grad, hyper, key)
    gd._update = planted_update


def phase_mnist_rnn_parity(device):
    """mnist_rnn on the card (eager, stitched, and eager with a 1 % error
    planted in the LSTM's weight gradient) against the port's CPU route
    from one seed, 2 epochs: every class close and the confusion matrix
    equal, each leaf within MNIST_RNN_PARAM_RTOL of its largest value;
    the planted run must fail the bound."""
    cpu = torch.device("cpu")
    _wf, c_closes, c_conf, c_params = _rnn_run(
        cpu, MNIST_RNN_PARITY_EPOCHS, "eager")
    runs = {}
    for name, route, prepare in (("eager", "eager", None),
                                 ("stitched", "stitched", None),
                                 ("planted", "eager", _plant_lstm_gradient)):
        _wf, closes, conf, params = _rnn_run(
            device, MNIST_RNN_PARITY_EPOCHS, route, prepare=prepare)
        errs = _param_rel_errors(params, c_params)
        worst = max(errs, key=errs.get)
        runs[name] = {"closes": closes,
                      "closes_equal": closes == c_closes,
                      "confusion_equal": bool(numpy.array_equal(conf,
                                                                c_conf)),
                      "worst_leaf": worst, "rel_err": errs[worst],
                      "rel_err_by_leaf": errs,
                      "within": errs[worst] <= MNIST_RNN_PARAM_RTOL}
    ok = (all(runs[n]["within"] and runs[n]["closes_equal"]
              and runs[n]["confusion_equal"] for n in ("eager", "stitched"))
          and not runs["planted"]["within"])
    emit({"phase": "mnist_rnn_parity", "ok": ok,
          "max_epochs": MNIST_RNN_PARITY_EPOCHS, "cpu_closes": c_closes,
          "param_rtol": MNIST_RNN_PARAM_RTOL,
          "planted_scale": MNIST_RNN_PLANTED_SCALE, **runs})
    for name in ("eager", "stitched"):
        r = runs[name]
        check(r["within"] and r["closes_equal"] and r["confusion_equal"],
              "mnist_rnn_parity", "%s card run against the CPU: closes %s "
              "vs %s, confusion equal %s, %s %.3g (bound %g)" % (
                  name, r["closes"], c_closes, r["confusion_equal"],
                  r["worst_leaf"], r["rel_err"], MNIST_RNN_PARAM_RTOL))
    check(not runs["planted"]["within"], "mnist_rnn_parity", "the planted "
          "1 %% LSTM gradient error stayed within the bound: %s %.3g" % (
              runs["planted"]["worst_leaf"], runs["planted"]["rel_err"]))


def _rbm_pretrain_recorded(device, planted=False):
    """mnist_ae's RBM pretraining on ``device`` from SEED, each CD step's
    hidden samples and new weights recorded (host copies); ``planted``:
    the sampler draws ``uniform >= p`` in place of ``uniform < p``."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import mnist_ae
    from veles_tpu_torch.samples.datasets import load_mnist
    from veles_tpu_torch.znicz import rbm
    tr_x = load_mnist()[0]
    data = numpy.ascontiguousarray(tr_x.reshape(len(tr_x), -1)[:2000],
                                   dtype=numpy.float32)
    steps, weights = [], []
    inner, bernoulli = rbm._cd_step, rbm.threefry_bernoulli

    def recording(*args, **kwargs):
        samples = []
        result = inner(*args, samples=samples, **kwargs)
        steps.append([s.cpu().numpy() for s in samples])
        weights.append(result[0].cpu().numpy().copy())
        return result
    prng.seed_all(SEED)
    rbm._cd_step = recording
    if planted:
        rbm.threefry_bernoulli = lambda key, p: ~bernoulli(key, p)
    try:
        tic = time.perf_counter()
        trainer = mnist_ae.pretrain_rbm(data, hidden=100, epochs=1,
                                        device=device)
        if device.type == "cuda":
            gpu_sync()
        elapsed = time.perf_counter() - tic
    finally:
        rbm._cd_step, rbm.threefry_bernoulli = inner, bernoulli
    return trainer, steps, weights, elapsed


def _rbm_agreement(card, card_steps, card_w, cpu, cpu_steps, cpu_w):
    """The flipped draws of each step, the weights' gap after each step
    before the first flip, and the final parameters' gaps; ``ok`` by
    RBM_MAX_FLIPS, RBM_RTOL and RBM_FLIP_ABS."""
    flips = [int(sum((a != b).sum() for a, b in zip(x, y)))
             for x, y in zip(card_steps, cpu_steps)]
    flipped = sum(flips)
    first = next((i for i, f in enumerate(flips) if f), len(flips))
    scale = max(float(numpy.abs(cpu_w[-1]).max()), 1e-30)
    before = max([float(numpy.abs(a - b).max()) / scale
                  for a, b in zip(card_w[:first], cpu_w[:first])] or [0.0])
    gaps = {}
    for name in ("weights", "vbias", "hbias"):
        got = getattr(card, name).mem
        want = getattr(cpu, name).mem
        gaps[name] = {"max_abs": float(numpy.abs(got - want).max()),
                      "rel": float(numpy.abs(got - want).max()
                                   / max(float(numpy.abs(want).max()),
                                         1e-30))}
    ok = (len(card_steps) == len(cpu_steps) == 20
          and flipped <= RBM_MAX_FLIPS and before <= RBM_RTOL
          and all(g["max_abs"] <= RBM_FLIP_ABS * (1 + flipped)
                  for g in gaps.values())
          and (flipped or gaps["weights"]["rel"] <= RBM_RTOL))
    return {"ok": ok, "flipped_draws_by_step": flips,
            "flipped_draws": flipped, "first_flipped_step": first,
            "weights_rel_before_first_flip": before, "param_gaps": gaps}


def phase_mnist_ae_rbm(device, smi):
    """``mnist_ae(rbm_pretrain=True)``: the RBM's CD-1 pretraining (20
    steps of 100 images, 784 visible, 100 hidden) on the card and on the
    CPU from one seed, the flipped Bernoulli draws counted step by step
    and the weights held together (RBM_MAX_FLIPS, RBM_RTOL,
    RBM_FLIP_ABS); a card run with a planted sampler must fail them;
    then the autoencoder fine-tuned from the card's RBM on the card, 2
    epochs stitched: exact GEMM/GD/gather launches and a falling
    rmse."""
    card, card_steps, card_w, card_s = _rbm_pretrain_recorded(device)
    cpu, cpu_steps, cpu_w, cpu_s = _rbm_pretrain_recorded(
        torch.device("cpu"))
    draws = int(sum(s.size for step in cpu_steps for s in step))
    agreement = _rbm_agreement(card, card_steps, card_w, cpu, cpu_steps,
                               cpu_w)
    bad, bad_steps, bad_w, _s = _rbm_pretrain_recorded(device, planted=True)
    planted = _rbm_agreement(bad, bad_steps, bad_w, cpu, cpu_steps, cpu_w)
    rbm_ok = agreement["ok"] and not planted["ok"]
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import gather
    from veles_tpu_torch.samples import mnist_ae
    with engine_knobs(stitch="on", loader="auto", epoch_scan="off"):
        prng.seed_all(SEED)
        tic = time.perf_counter()
        wf = mnist_ae.create_workflow(device=device,
                                      max_epochs=MNIST_AE_RBM_EPOCHS,
                                      rbm_pretrain=True)
        reset_all_launches()
        wf.run()
        gpu_sync()
        elapsed = time.perf_counter() - tic
    launches = mnist_launches()
    entries = dict(gather.entry_launches)
    closes = [(h["epoch"], h["cls"], h["batches"]) for h in
              wf.decision.history]
    n = sum(c[2] for c in closes)
    train = sum(c[2] for c in closes if c[1] == "train")
    want = {"matmul": 2 * n, "gd_dx": train, "gd_dw": 2 * train,
            "gd_db_in_dw": 2 * train, "veles_gather_served": n}
    counted = all(dict(launches, **entries).get(k) == v
                  for k, v in want.items())
    rmse = [h["mse"] for h in wf.decision.history if h["cls"] ==
            "validation"]
    tuned = all(numpy.isfinite(v) for v in rmse) and rmse[-1] < rmse[0]
    ok = rbm_ok and counted and tuned
    emit({"phase": "mnist_ae_rbm", "nvidia_smi": smi, "ok": ok,
          "rbm": "784-100, CD-1, lr 0.1, 20 steps of 100 (the first 2000 "
                 "train images)", "pretrain_s": {"card": card_s,
                                                "cpu": cpu_s},
          "draws": draws, **{k: v for k, v in agreement.items()
                             if k != "ok"},
          "flip_abs": RBM_FLIP_ABS, "rtol": RBM_RTOL,
          "max_flips": RBM_MAX_FLIPS,
          "planted_sampler": {k: planted[k] for k in (
              "ok", "flipped_draws", "first_flipped_step", "param_gaps")},
          "finetune": {"layers": "784-100 sigmoid, 100-784 sigmoid (from "
                                 "the RBM)", "max_epochs":
                       MNIST_AE_RBM_EPOCHS, "elapsed_s": elapsed,
                       "closes": closes, "validation_rmse": rmse,
                       "launches": launches, "entry_launches": entries,
                       "launches_expected": want}})
    check(agreement["ok"], "mnist_ae_rbm", "RBM card against CPU: %s"
          % agreement)
    check(not planted["ok"], "mnist_ae_rbm", "the planted sampler passed: "
          "%d flipped draws" % planted["flipped_draws"])
    check(counted, "mnist_ae_rbm", "fine-tune launches %s %s, want %s"
          % (launches, entries, want))
    check(tuned, "mnist_ae_rbm", "fine-tune rmse did not fall: %s" % rmse)
    return dict(launches, **entries)


def _kohonen_run(device, planted=False):
    """The SOM sample on ``device`` from SEED; each step's winners and
    codebook recorded (host copies).  ``planted``: each step's winner is
    taken one neuron on from the argmin."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import kohonen
    from veles_tpu_torch.znicz import kohonen as units
    inner = units._som_step

    def planted_step(weights, grid, x, radius, learning_rate):
        _w, winners = inner(weights, grid, x, radius, learning_rate)
        winners = (winners + 1) % weights.shape[0]
        h = torch.exp(-torch.sum((grid[None] - grid[winners][:, None]) ** 2,
                                 dim=2) / (2.0 * float(radius) ** 2))
        den = torch.sum(h, dim=0)[:, None]
        delta = (h.t() @ x) / torch.clamp(den, min=1e-8) - weights
        return (weights + float(learning_rate) * delta * (den > 1e-8),
                winners)
    prng.seed_all(SEED)
    with engine_knobs(stitch="on", loader="auto", epoch_scan="off"):
        wf = kohonen.create_workflow(device=device,
                                     max_epochs=KOHONEN_EPOCHS)
        winners, codebooks = [], []
        run = wf.trainer.run

        def recording_run():
            run()
            winners.append(wf.trainer.winners.mem.copy())
            codebooks.append(
                wf.trainer.weights.devmem.cpu().numpy().copy())
        wf.trainer.run = recording_run
        if planted:
            units._som_step = planted_step
        try:
            tic = time.perf_counter()
            wf.run()
            if device.type == "cuda":
                gpu_sync()
            elapsed = time.perf_counter() - tic
        finally:
            units._som_step = inner
    return wf, winners, codebooks, elapsed


def _kohonen_agreement(wf, winners, codebooks, cpu, cpu_winners,
                       cpu_codebooks):
    """The winners moved at each step, the codebook's gap after each
    step before the first move (every step when none moved) and the
    quantization errors; ``ok`` by KOHONEN_MAX_MOVED, KOHONEN_RTOL and
    KOHONEN_QERR_RTOL."""
    moved = [int((a != b).sum()) for a, b in zip(winners, cpu_winners)]
    first = next((i for i, m in enumerate(moved) if m), len(moved))
    scale = max(float(numpy.abs(cpu_codebooks[-1]).max()), 1e-30)
    before = max([float(numpy.abs(a - b).max()) / scale for a, b in
                  zip(codebooks[:first], cpu_codebooks[:first])] or [0.0])
    qerr = (wf.get_metric_values()["quantization_error"],
            cpu.get_metric_values()["quantization_error"])
    ok = (len(winners) == len(cpu_winners) == len(codebooks)
          and sum(moved) <= KOHONEN_MAX_MOVED and before <= KOHONEN_RTOL
          and abs(qerr[0] - qerr[1])
          <= KOHONEN_QERR_RTOL * max(qerr[1], 1e-6))
    return {"ok": ok, "winners_moved_by_step": moved,
            "winners_moved": sum(moved), "first_moved_step": first,
            "codebook_rel_before_first_move": before,
            "quantization_error": {"card": qerr[0], "cpu": qerr[1]}}


def phase_kohonen(device, smi):
    """The Kohonen SOM sample (an 8x8 map over 1000 points of a 2-D
    Gaussian mixture, minibatch 100, 10 epochs) on the card and on the
    CPU from one seed: the winners of every step compared (the ones that
    moved counted: a near tie of two distances), the codebook after
    each step before the first move and the quantization error
    (KOHONEN_MAX_MOVED, KOHONEN_RTOL, KOHONEN_QERR_RTOL); a card run
    with a planted argmin must fail them; exact gather launches: one a
    step by the eager fill's entry (the trainer is a barrier, so the
    loader heads no segment)."""
    from veles_tpu_torch.ops import gather
    reset_all_launches()
    wf, winners, codebooks, elapsed = _kohonen_run(device)
    launches = mnist_launches()
    entries = dict(gather.entry_launches)
    cpu, cpu_winners, cpu_codebooks, cpu_elapsed = _kohonen_run(
        torch.device("cpu"))
    steps = wf.trainer._step
    counted = (steps == len(winners) == len(cpu_winners)
               and launches["gather"] == steps
               and entries["veles_gather_group"] == steps)
    agreement = _kohonen_agreement(wf, winners, codebooks, cpu,
                                   cpu_winners, cpu_codebooks)
    bad, bad_winners, bad_codebooks, _s = _kohonen_run(device, planted=True)
    planted = _kohonen_agreement(bad, bad_winners, bad_codebooks, cpu,
                                 cpu_winners, cpu_codebooks)
    ok = counted and agreement["ok"] and not planted["ok"]
    emit({"phase": "kohonen", "nvidia_smi": smi, "ok": ok,
          "map": "8x8 over 2-D points (1000, 6 centres), minibatch 100",
          "max_epochs": KOHONEN_EPOCHS, "steps": steps,
          "elapsed_s": {"card": elapsed, "cpu": cpu_elapsed},
          **{k: v for k, v in agreement.items() if k != "ok"},
          "codebook_rel_err": float(
              numpy.abs(codebooks[-1] - cpu_codebooks[-1]).max()
              / numpy.abs(cpu_codebooks[-1]).max()),
          "rtol": KOHONEN_RTOL, "max_moved": KOHONEN_MAX_MOVED,
          "planted_argmin": {k: planted[k] for k in (
              "ok", "winners_moved", "first_moved_step",
              "quantization_error")},
          "launches": launches, "entry_launches": entries})
    check(counted, "kohonen", "gather launches %s %s for %d steps"
          % (launches, entries, steps))
    check(agreement["ok"], "kohonen", "card against CPU: %s" % {
        k: v for k, v in agreement.items() if k != "winners_moved_by_step"})
    check(not planted["ok"], "kohonen", "the planted argmin passed: %d "
          "winners moved" % planted["winners_moved"])
    return dict(launches, **entries)


def _gap(a, b):
    """:func:`_max_err` of two host or device arrays, on the host."""
    return _max_err(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu())


def _served_norm_run(device, name):
    """The MNIST MLP, stitched, 2 epochs (two validation passes and a
    train pass: 80 minibatches), its loader normalized by the
    ``name`` normalizer.  An affine normalizer (``as_affine()``) rides
    on the u8-resident stand-in (``native_device_dtype``): the stitched
    head's served gather launch normalizes each row on the device; any
    other normalizes the float32 dataset once on the host at
    initialize, and the head gathers it.  Each served minibatch,
    recorded after its head segment's dispatch: its indices and its
    rows (host copies); the loader; the launch counts of the run."""
    from veles_tpu_torch import prng, stitch
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch.samples.datasets import load_mnist
    from veles_tpu_torch.ops import gather
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    native = name not in HOST_ONLY_NORMS
    params = {}
    if name == "external_mean":
        params["mean_source"] = load_mnist(raw=native)[0].reshape(
            -1, 784).mean(0)
    served = []
    execute = stitch.StitchSegment.execute

    def recording(segment):
        execute(segment)
        head = segment.head
        if head is wf.loader:
            size = int(head.minibatch_size)
            served.append((head.minibatch_indices.mem[:size].copy(),
                           head.minibatch_data.devmem[:size].cpu().numpy()
                           .copy()))
    reset_all_launches()
    with engine_knobs(stitch="on", loader="auto", epoch_scan="off"):
        prng.seed_all(SEED)
        wf = StandardWorkflow(
            None, loader_factory=lambda w: mnist.MnistLoader(
                w, minibatch_size=100, native_device_dtype=native,
                normalization_type=name, normalization_parameters=params),
            layers=[dict(s) for s in mnist.LAYERS],
            decision_config={"max_epochs": 2})
        wf.launcher = DummyLauncher()
        wf.initialize(device=device)
        stitch.StitchSegment.execute = recording
        try:
            wf.run()
        finally:
            stitch.StitchSegment.execute = execute
    if device.type == "cuda":
        gpu_sync()
    return served, wf.loader, dict(mnist_launches(), **gather.entry_launches)


def _served_norm_check(device, name):
    """One normalizer's served minibatches on the card against the
    CPU route's (:func:`_served_norm_run` there, the served gather's
    plain version) and against the host ``normalize`` of the same
    dataset rows, as the largest gap over the largest served value;
    the head's gather launches counted (one a minibatch, the data table
    normalized in it where affine)."""
    card, loader, launches = _served_norm_run(device, name)
    cpu, _cpu_loader, _ = _served_norm_run(torch.device("cpu"), name)
    native = loader.native_device_dtype
    scale = max(max(float(numpy.abs(rows).max()) for _i, rows in cpu),
                1e-30)
    raw = loader.original_data.mem
    host_gap = cpu_gap = 0.0
    for (idx, rows), (_c_idx, c_rows) in zip(card, cpu):
        want = numpy.array(raw[idx], dtype=numpy.float32)
        if native:
            loader.normalizer.normalize(want)
        host_gap = max(host_gap, float(numpy.abs(rows - want).max()))
        cpu_gap = max(cpu_gap, float(numpy.abs(rows - c_rows).max()))
    n = len(card)
    counted = (launches["gather_norm" if native else "gather"] == n
               and launches["gather_norm_tables"] == (n if native else 0)
               and launches["veles_gather_served"] == n)
    same = (n == len(cpu) == 80 and all(
        numpy.array_equal(a[0], b[0]) for a, b in zip(card, cpu)))
    info = {"native_u8": native, "minibatches": n,
            "indices_equal": same,
            "card_vs_cpu": cpu_gap / scale,
            "card_vs_host_normalize": host_gap / scale,
            "launches": {k: launches[k] for k in (
                "gather", "gather_norm", "gather_tables",
                "gather_norm_tables", "veles_gather_served")}}
    info["ok"] = (same and counted
                  and info["card_vs_cpu"] <= NORM_SERVED_RTOL
                  and info["card_vs_host_normalize"] <= NORM_SERVED_RTOL)
    return info, launches


def _data_side_units(device):
    """MeanDisp, the joiner and the avatar as units on ``device`` over
    one seed's inputs: their outputs on the host."""
    from veles_tpu_torch.avatar import Avatar
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.input_joiner import InputJoiner
    from veles_tpu_torch.mean_disp_normalizer import MeanDispNormalizer
    from veles_tpu_torch.memory import Vector
    dev = make_device(device)
    rng = numpy.random.default_rng(SEED)
    x = rng.integers(0, 256, (100, 28, 28)).astype(numpy.uint8)
    unit = MeanDispNormalizer(DummyWorkflow())
    unit.input = Vector(x)
    unit.mean.reset(rng.random((28, 28)).astype(numpy.float32) * 128)
    unit.rdisp.reset(rng.random((28, 28)).astype(numpy.float32) / 64)
    unit.initialize(device=dev)
    unit.run()
    parts = [rng.standard_normal((100, 784)).astype(numpy.float32),
             rng.standard_normal((100, 10, 5)).astype(numpy.float32)]
    joiner = InputJoiner(DummyWorkflow(), inputs=[Vector(p) for p in parts])
    joiner.initialize(device=dev)
    joiner.run()

    class Source(object):
        minibatch_class, minibatch_size = 2, 100
        minibatch_offset, epoch_number = 100, 0
        minibatch_data = Vector(parts[0])
        minibatch_labels = Vector(numpy.arange(100, dtype=numpy.int32))
    for vec in (Source.minibatch_data, Source.minibatch_labels):
        vec.initialize(dev)
    avatar = Avatar(DummyWorkflow(), source=Source())
    avatar.initialize()
    avatar.run()
    return {"mean_disp": unit.output.mem, "joiner": joiner.output.mem,
            "avatar": avatar.minibatch_data.mem,
            "avatar_labels": avatar.minibatch_labels.mem}


class _AllTrainMnist(object):
    """A mixin: the stand-in's 7000 images all TRAIN, so
    ``validation_ratio`` carves the validation set."""

    def load_data(self):
        super(_AllTrainMnist, self).load_data()
        self.class_lengths[:] = [0, 0, sum(self.class_lengths)]


def _ratio_run(device):
    """The MNIST MLP over the all-TRAIN stand-in with validation_ratio
    0.1, stitched, 2 epochs; its closes, the served index sequence and
    the parameters."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    from veles_tpu_torch.dummy import DummyLauncher

    class Loader(_AllTrainMnist, mnist.MnistLoader):
        pass
    served = []
    fill = Loader.fill_indices

    def recording(self, start, count):
        served.append(int(self.shuffled_indices.mem[start]))
        return fill(self, start, count)
    Loader.fill_indices = recording
    with engine_knobs(stitch="on", loader="auto", epoch_scan="off"):
        prng.seed_all(SEED)
        wf = StandardWorkflow(
            None, loader_factory=lambda w: Loader(
                w, minibatch_size=100, validation_ratio=0.1),
            layers=[dict(s) for s in mnist.LAYERS],
            decision_config={"max_epochs": DATA_SIDE_EPOCHS})
        wf.launcher = DummyLauncher()
        wf.initialize(device=device)
        wf.run()
    if device.type == "cuda":
        gpu_sync()
    closes = [(c["epoch"], c["cls"], c["n_err"], c["samples"])
              for c in wf.decision.history]
    return wf, closes, served, wf.params_to_numpy()


def _saver_replay(device, tmp):
    """A stitched-free MNIST loader on ``device`` dumped by
    MinibatchesSaver for 12 serves, then replayed by MinibatchesLoader
    on ``device``: the replayed minibatches against the served ones."""
    import os
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.loader import saver
    from veles_tpu_torch.samples import mnist
    prng.seed_all(SEED)
    with engine_knobs(stitch="off"):
        device = make_device(device)
        loader = mnist.MnistLoader(DummyWorkflow(), minibatch_size=100)
        loader.initialize(device=device)
        path = os.path.join(tmp, "minibatches.dump.gz")
        dump = saver.MinibatchesSaver(DummyWorkflow(), file_name=path)
        dump.minibatch_data = loader.minibatch_data
        dump.minibatch_labels = loader.minibatch_labels
        dump.initialize()
        served = []
        for _ in range(12):
            loader.run()
            dump.minibatch_class = loader.minibatch_class
            dump.minibatch_size = loader.minibatch_size
            dump.run()
            served.append(numpy.array(loader.minibatch_data.mem))
        dump.stop()
        replay = saver.MinibatchesLoader(DummyWorkflow(), file_name=path)
        replay.initialize(device=device)
        gaps = []
        for want in served:
            replay.run()
            gaps.append(float(numpy.abs(replay.minibatch_data.mem
                                        - want).max()))
    return gaps


def phase_data_side(device, smi):
    """The data side on CUDA tensors against the CPU: each normalizer's
    affine form applied on the card (against its own host ``normalize``
    and the CPU), MeanDispNormalizer, InputJoiner and Avatar as units,
    ``hog_batch`` over 100 stand-in images (cell 4, block 2, 9 bins) and
    an RGB batch; the MNIST MLP over the all-TRAIN stand-in with
    ``validation_ratio`` 0.1, stitched, card against CPU (the served
    index sequence equal, closes and parameters); a MinibatchesSaver dump
    of a card loader replayed by MinibatchesLoader on the card."""
    import tempfile
    from veles_tpu_torch import normalization
    from veles_tpu_torch.ops import gather, hog
    from veles_tpu_torch.samples.datasets import load_mnist
    results, ok = {}, True
    rng = numpy.random.default_rng(SEED)
    norms, norm_launches = {}, {}
    for name in sorted(normalization.NormalizerRegistry.normalizers):
        norms[name], launches = _served_norm_check(device, name)
        for key, value in launches.items():
            norm_launches[key] = norm_launches.get(key, 0) + value
        ok = ok and norms[name]["ok"]
    results["normalizers"] = norms
    card, cpu = _data_side_units(device), _data_side_units("cpu")
    results["units"] = {k: _gap(card[k], cpu[k]) for k in card}
    ok = ok and all(v <= DATA_SIDE_TOL for v in results["units"].values())
    images = load_mnist()[0][:100].reshape(100, 28, 28)
    rgb = rng.random((8, 32, 32, 3)).astype(numpy.float32)
    hogs = {}
    for name, x, kwargs in (("mnist_gray", images, {"cell": 4}),
                            ("rgb", rgb, {"cell": 8, "orientations": 6})):
        t = torch.as_tensor(numpy.ascontiguousarray(x, numpy.float32))
        got = hog.hog_batch(t.to(device), **kwargs)
        want = hog.hog_batch(t, **kwargs)
        hogs[name] = {"shape": list(got.shape), "card_vs_cpu": _gap(got,
                                                                    want)}
        ok = ok and hogs[name]["card_vs_cpu"] <= DATA_SIDE_TOL
    results["hog"] = hogs
    reset_all_launches()
    wf, closes, served, params = _ratio_run(device)
    launches = mnist_launches()
    entries = dict(gather.entry_launches)
    _cwf, c_closes, c_served, c_params = _ratio_run(torch.device("cpu"))
    errs = _param_rel_errors(params, c_params)
    ratio_ok = (served == c_served and closes == c_closes
                and wf.loader.class_lengths == [0, 700, 6300]
                and max(errs.values()) <= DATA_SIDE_PARAM_RTOL
                and entries["veles_gather_served"] == len(served)
                and launches["matmul"] == 2 * len(served))
    results["validation_ratio"] = {
        "class_lengths": wf.loader.class_lengths, "closes": closes,
        "served_equal": served == c_served, "closes_equal":
        closes == c_closes, "param_rel_err": max(errs.values()),
        "param_rtol": DATA_SIDE_PARAM_RTOL, "launches": launches,
        "entry_launches": entries, "ok": ratio_ok}
    with tempfile.TemporaryDirectory() as tmp:
        gaps = _saver_replay(device, tmp)
    results["saver_replay_gaps"] = gaps
    replay_ok = len(gaps) == 12 and max(gaps) == 0.0
    ok = ok and ratio_ok and replay_ok
    emit({"phase": "data_side", "nvidia_smi": smi, "ok": ok,
          "tol": DATA_SIDE_TOL, **results})
    check(ok, "data_side", "normalizers %s, units %s, hog %s, "
          "validation_ratio %s, saver replay %s" % (
              norms, results["units"], hogs, results["validation_ratio"],
              gaps))
    return {"data_side": dict(launches, **entries),
            "data_side_norms": norm_launches}


# -- ROADMAP 7(d), part 1: the SPMD library on a one-rank NCCL group ---------

SPMD_TRAIN_STEPS = 6
SPMD_PARITY_STEPS = 2
RING_RANKS = 4                   # virtual ranks of the ring phase
RING_SHAPE = (8, 2048, 16, 64)   # the train step's attention
MOE_BATCH = 8
MOE_STEPS = 5
MOE_REF_RTOL = 1e-5              # moe_mlp vs moe_reference, of max |ref|
FUSED_DP_EPOCHS = 3
ALEXNET_DP_STEPS = 3


def spmd_counts():
    from veles_tpu_torch.parallel import comm
    return {kind: comm.counts[kind] for kind in comm.KINDS}


def phase_spmd_group(device):
    """The one-rank NCCL group the SPMD phases run on (one card: NCCL
    refuses two ranks on one GPU, so the multi-rank behaviour is proven
    on the CPU with gloo ranks): ``multihost.initialize`` on the card,
    its backend, rank and world size."""
    import torch.distributed as dist
    from veles_tpu_torch.parallel import multihost
    dev = multihost.initialize(device=device)
    info = {"phase": "spmd_group", "backend": str(dist.get_backend()),
            "rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "device": str(dev)}
    info["ok"] = info["backend"] == "nccl" and info["world_size"] == 1
    emit(info)
    check(info["ok"], "spmd_group", "want a one-rank NCCL group: %s" % info)


def _steps_timed(step, params, velocity, tokens, steps):
    """``steps`` steps: each's loss, wall ms (synchronised), flash
    launches and collectives."""
    from veles_tpu_torch.ops import attention
    from veles_tpu_torch.parallel import comm
    out = {"losses": [], "step_ms": [], "launches": [], "collectives": []}
    for _ in range(steps):
        before, issued = dict(attention.launches), dict(comm.counts)
        gpu_sync()
        tic = time.perf_counter()
        params, velocity, metrics = step(params, velocity, tokens)
        out["losses"].append(float(metrics["loss"]))
        gpu_sync()
        out["step_ms"].append((time.perf_counter() - tic) * 1e3)
        out["launches"].append({k: attention.launches[k] - before[k]
                                for k in ("flash_fwd", "flash_bwd_dq",
                                          "flash_bwd_dkv")})
        out["collectives"].append({k: comm.counts[k] - issued.get(k, 0)
                                   for k in comm.KINDS})
    return out


def _trees_equal(a, b):
    from veles_tpu_torch.samples import transformer as T
    return all(torch.equal(x, y) for x, y in zip(T._leaves(a), T._leaves(b)))


def phase_spmd_train(device, smi):
    """The transformer at CONFIG width (bf16, remat, batch 8) through
    ``build_train(mesh=mesh_from_topology("data=1,seq=1,model=1"))`` on
    the one-rank NCCL group, SPMD_TRAIN_STEPS steps, beside the no-mesh
    ``build_train`` in the same run: losses and params bit-equal, the
    flash launches the train phase's 24/12/12 a step, the collectives a
    step exact (the Megatron pair's all-reduces: 2 a layer forward, 2
    backward and 1 in the remat recompute, which stops after the block's
    last saved tensor, before the second; one flat all-reduce of the
    gradients and the loss), step time and tokens/s beside the no-mesh
    step's.  Then a 2-layer f32 mesh step on the card against the CPU's
    step at the train_parity bounds."""
    from veles_tpu_torch.gen.model import params_to_numpy
    from veles_tpu_torch.ops import attention
    from veles_tpu_torch.parallel import comm
    from veles_tpu_torch.parallel.mesh import mesh_from_topology
    from veles_tpu_torch.samples import transformer as T

    cfg, batch = T.CONFIG, TRAIN_BATCH
    layers = cfg["layers"]
    mesh = mesh_from_topology("data=1,seq=1,model=1")
    tokens = T._as_tokens(T.synthetic_tokens(cfg, batch, seed=SEED), device)
    runs = {}
    attention.reset_launches()
    comm.reset_counts()
    path_launches = {}
    for name, m in (("no_mesh", None), ("mesh", mesh)):
        params, velocity, step = T.build_train(cfg, mesh=m, seed=SEED,
                                               device=device)
        before = dict(attention.launches)
        runs[name] = _steps_timed(step, params, velocity, tokens,
                                  SPMD_TRAIN_STEPS)
        if m is not None:
            path_launches = {k: attention.launches[k] - before[k]
                             for k in before}
        runs[name]["params"], runs[name]["velocity"] = params, velocity
    equal = (runs["mesh"]["losses"] == runs["no_mesh"]["losses"]
             and _trees_equal(runs["mesh"]["params"],
                              runs["no_mesh"]["params"])
             and _trees_equal(runs["mesh"]["velocity"],
                              runs["no_mesh"]["velocity"]))
    want_launches = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers,
                     "flash_bwd_dkv": layers}
    want_coll = {"all_reduce": 5 * layers + 1, "all_to_all": 0,
                 "ring_shift": 0, "all_gather": 0}
    counted = (all(c == want_launches for c in runs["mesh"]["launches"])
               and all(c == want_coll for c in runs["mesh"]["collectives"]))
    timing = {}
    for name, run in runs.items():
        median = statistics.median(run["step_ms"][1:])
        timing[name] = {"step_ms": run["step_ms"], "step_median_ms": median,
                        "tokens_per_s": batch * cfg["seq_len"]
                        / (median / 1e3)}
    del runs["mesh"]["params"], runs["no_mesh"]["params"]
    del runs["mesh"]["velocity"], runs["no_mesh"]["velocity"]

    # the 2-layer f32 mesh step, card against the CPU (no-mesh: the CPU
    # has no NCCL rank; at world 1 the mesh step is the no-mesh step)
    pcfg = dict(cfg, layers=2, seq_len=256)
    ptokens = T.synthetic_tokens(pcfg, 2, seed=SEED + 2)
    parity = {}
    for name, dev, m in (("card", device, mesh),
                         ("cpu", torch.device("cpu"), None)):
        p, v, step = T.build_train(pcfg, mesh=m, seed=SEED, device=dev,
                                   compute_dtype=torch.float32)
        losses = [float(step(p, v, ptokens)[2]["loss"])
                  for _ in range(SPMD_PARITY_STEPS)]
        parity[name] = (losses, params_to_numpy(p), params_to_numpy(v))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(parity["card"][0],
                                                       parity["cpu"][0]))
    param_err = max(float(numpy.abs(a - b).max()) for a, b in zip(
        T._leaves(parity["card"][1]), T._leaves(parity["cpu"][1])))
    v_err = max(float(numpy.abs(a - b).max()
                      / max(float(numpy.abs(b).max()), 1e-30))
                for a, b in zip(T._leaves(parity["card"][2]),
                                T._leaves(parity["cpu"][2])))
    parity_ok = (loss_rel <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_TOL
                 and v_err <= TRAIN_VELOCITY_RTOL)
    ok = equal and counted and parity_ok
    emit({"phase": "spmd_train", "nvidia_smi": smi, "ok": ok,
          "config": dict(cfg), "batch": batch, "compute_dtype": "bfloat16",
          "remat": True, "mesh": dict(mesh.shape), "backend": "nccl",
          "steps": SPMD_TRAIN_STEPS, "bit_equal_to_no_mesh": equal,
          "losses": runs["mesh"]["losses"],
          "no_mesh_losses": runs["no_mesh"]["losses"],
          "launches_per_step": runs["mesh"]["launches"],
          "launches_per_step_expected": want_launches,
          "collectives_per_step": runs["mesh"]["collectives"],
          "collectives_per_step_expected": want_coll,
          "timing": timing,
          "parity": {"config": pcfg, "dtype": "float32",
                     "card_losses": parity["card"][0],
                     "cpu_losses": parity["cpu"][0],
                     "loss_max_rel_err": loss_rel,
                     "params_max_abs_err": param_err,
                     "velocity_max_rel_err": v_err,
                     "bounds": [TRAIN_LOSS_RTOL, TRAIN_PARAM_TOL,
                                TRAIN_VELOCITY_RTOL], "ok": parity_ok}})
    check(equal, "spmd_train", "the mesh step at world 1 is not the no-mesh "
          "step bit for bit: %s vs %s" % (runs["mesh"]["losses"],
                                          runs["no_mesh"]["losses"]))
    check(counted, "spmd_train", "launches %s / collectives %s a step, want "
          "%s / %s" % (runs["mesh"]["launches"], runs["mesh"]["collectives"],
                       want_launches, want_coll))
    check(parity_ok, "spmd_train", "card and CPU disagree: loss rel %.3g, "
          "params %.3g, velocity %.3g" % (loss_rel, param_err, v_err))
    return path_launches


def _ring_virtual(q, k, v, do, ranks, k_shift=0):
    """Ring-flash over ``ranks`` virtual ranks in one process: each
    (rank, hop) runs ring.py's forward hop, then its backward hop, the
    blocks rotated here; ``k_shift`` blocks added to every k_offset
    (the planted fault).  The merged ``(o, lse, dq, dk, dv)`` and, for
    dq, dk and dv, the sum over the hops of each hop's |share|."""
    from veles_tpu_torch.ops import attention
    from veles_tpu_torch.parallel import ring
    s = q.shape[1] // ranks
    b, _, h, d = q.shape
    cut = [slice(r * s, (r + 1) * s) for r in range(ranks)]
    outs, lses = [], []
    for r in range(ranks):
        o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, s), ring.NEG_INF, dtype=torch.float32,
                         device=q.device)
        for t in range(ranks):
            blk = (r - t) % ranks
            o, lse = ring.forward_hop(q[:, cut[r]], k[:, cut[blk]],
                                      v[:, cut[blk]], o, lse, True, r * s,
                                      (blk + k_shift) * s)
        outs.append(o.to(q.dtype))
        lses.append(lse)
    zeros = [torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
             for _ in range(6 * ranks)]
    dq, dk, dv, mq, mk, mv = (zeros[i * ranks:(i + 1) * ranks]
                              for i in range(6))
    for r in range(ranks):
        delta = attention._delta(outs[r], do[:, cut[r]])
        for t in range(ranks):
            blk = (r - t) % ranks
            before = (dq[r], dk[blk], dv[blk])
            dq[r], dk[blk], dv[blk] = ring.backward_hop(
                q[:, cut[r]], k[:, cut[blk]], v[:, cut[blk]], outs[r],
                lses[r], do[:, cut[r]], delta, True, r * s,
                (blk + k_shift) * s, dq[r], dk[blk], dv[blk])
            for mag, new, old in zip((mq[r], mk[blk], mv[blk]),
                                     (dq[r], dk[blk], dv[blk]), before):
                mag.add_((new - old).abs())
    return (torch.cat(outs, 1), torch.cat(lses, 2),
            torch.cat(dq, 1).to(q.dtype), torch.cat(dk, 1).to(k.dtype),
            torch.cat(dv, 1).to(v.dtype)), tuple(
                torch.cat(m, 1) for m in (mq, mk, mv))


def _bwd_gap(got, want, tol):
    """Largest excess of |got - want| over atol + rtol·|want| (<= 0
    within tolerance) and the largest absolute error."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    return (float((diff - atol - rtol * want.float().abs()).max()),
            float(diff.max()))


@contextlib.contextmanager
def _plain_flash():
    """The flash wrappers' CUDA launches replaced by their plain
    versions on the same CUDA tensors (nothing counted)."""
    from veles_tpu_torch.ops import attention
    saved = (attention._flash_fwd_cuda, attention._bwd_dq_cuda,
             attention._bwd_dkv_cuda)

    def bwd(q, k, v, do, lse, delta, causal, q_offset, k_offset):
        return attention._bwd_ref(q, k, v, None, lse, do, causal, q_offset,
                                  k_offset, delta)
    attention._flash_fwd_cuda = attention._mha_ref
    attention._bwd_dq_cuda = lambda *args: bwd(*args)[0]
    attention._bwd_dkv_cuda = lambda *args: bwd(*args)[1:]
    try:
        yield
    finally:
        (attention._flash_fwd_cuda, attention._bwd_dq_cuda,
         attention._bwd_dkv_cuda) = saved


def phase_ring(device, smi):
    """Ring-flash at the train step's attention shape (8, 2048, 16, 64),
    bf16 and f32, split into RING_RANKS virtual ranks of 512 positions in
    one process: ring.py's forward and backward hops for each (rank,
    hop), 16 forward launches and 16 backward pairs at the global causal
    offsets (the fully masked hops included).  The merged o, lse, dq, dk
    and dv are held against the single-shard flash kernels on the card
    at the kernels phase's tolerances, and against the ring's plain
    version (the same hops over ``_mha_ref`` and ``_bwd_ref``): the
    forward at those tolerances, each gradient within the sum of its
    hops' bounds (RING_RANKS times the atol, the rtol times the sum of
    the hops' |shares|: each hop is one launch, held to the kernels
    phase's bound of its own share); a k_offset one block off must be
    caught.  The ring's wall and the single-shard forward and backward's
    are printed.  Then ``ring_attention`` and ``ulysses_attention`` on
    the one-rank group equal the flash attention (forward and gradients)
    bit for bit."""
    from veles_tpu_torch.ops import attention
    from veles_tpu_torch.parallel import comm
    from veles_tpu_torch.parallel.mesh import mesh_from_topology
    from veles_tpu_torch.parallel.ring import (ring_attention,
                                               ulysses_attention)
    gen = torch.Generator(device=device).manual_seed(SEED)
    results, ok, hop_launches = {}, True, {}
    for dtype, fwd_tol, bwd_tol in ((torch.bfloat16, BF16_TOL, BWD_BF16_TOL),
                                    (torch.float32, F32_TOL, BWD_F32_TOL)):
        name = str(dtype).split(".")[-1]
        # the kernels phase's operands, whose tolerances these are:
        # q, k ~ N(0, 1), v and do ~ U(-1, 1)
        q, k = (torch.randn(RING_SHAPE, generator=gen, device=device)
                .to(dtype) for _ in range(2))
        v, do = ((torch.rand(RING_SHAPE, generator=gen, device=device) * 2
                  - 1).to(dtype) for _ in range(2))
        attention.reset_launches()
        tic = time.perf_counter()
        ring_out, _mags = _ring_virtual(q, k, v, do, RING_RANKS)
        gpu_sync()
        ring_ms = (time.perf_counter() - tic) * 1e3
        launches = {k_: attention.launches[k_] for k_ in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        for k_, n in launches.items():
            hop_launches[k_] = hop_launches.get(k_, 0) + n
        gpu_sync()
        tic = time.perf_counter()
        o, lse = attention._flash_fwd(q, k, v, True)
        flash = (o, lse) + attention._flash_bwd(q, k, v, o, lse, do, True)
        gpu_sync()
        single_ms = (time.perf_counter() - tic) * 1e3
        with _plain_flash():
            plain, mags = _ring_virtual(q, k, v, do, RING_RANKS)
        gaps = {}
        for against, ref in (("flash", flash), ("plain", plain)):
            row = {}
            for i, part in enumerate(("o", "lse", "dq", "dk", "dv")):
                if i < 2:
                    err = float((ring_out[i].float() - ref[i].float())
                                .abs().max())
                    row[part] = {"max_abs_err": err, "tol": fwd_tol,
                                 "ok": err <= fwd_tol}
                elif against == "flash":
                    excess, err = _bwd_gap(ring_out[i], ref[i], bwd_tol)
                    row[part] = {"max_abs_err": err, "excess": excess,
                                 "tol": bwd_tol, "ok": excess <= 0}
                else:
                    # hop by hop: each hop one launch within the kernels
                    # phase's bound of its own share, the sum within the
                    # sum of the hops' bounds
                    atol, rtol = bwd_tol
                    diff = (ring_out[i].float() - ref[i].float()).abs()
                    over = diff - RING_RANKS * atol - rtol * mags[i - 2]
                    worst = int(over.argmax())
                    excess = float(over.reshape(-1)[worst])
                    row[part] = {"max_abs_err": float(diff.max()),
                                 "excess": excess, "tol": bwd_tol,
                                 "bound": "the hops' summed bounds",
                                 "worst": {"err": float(
                                     diff.reshape(-1)[worst]),
                                     "plain": float(ref[i].float()
                                                    .reshape(-1)[worst]),
                                     "hops_abs_sum": float(
                                         mags[i - 2].reshape(-1)[worst])},
                                 "ok": excess <= 0}
            gaps[against] = row
        planted = _ring_virtual(q, k, v, do, RING_RANKS, k_shift=1)[0]
        planted_err = float((planted[0].float() - flash[0].float()).abs()
                            .max())
        caught = planted_err > fwd_tol
        want = {"flash_fwd": RING_RANKS ** 2,
                "flash_bwd_dq": RING_RANKS ** 2,
                "flash_bwd_dkv": RING_RANKS ** 2}
        row_ok = (launches == want and caught and all(
            cell["ok"] for row in gaps.values() for cell in row.values()))
        ok = ok and row_ok
        results[name] = {"hop_launches": launches,
                         "hop_launches_expected": want, "gaps": gaps,
                         "planted_k_offset_err": planted_err,
                         "planted_caught": caught, "ring_ms": ring_ms,
                         "single_shard_ms": single_ms, "ok": row_ok}
        del q, k, v, do, ring_out, flash, plain, planted
    # the library functions on the one-rank group: exact at world 1
    mesh = mesh_from_topology("data=1,seq=1")
    comm.reset_counts()
    q, k, v = (torch.randn((2, 512, 16, 64), generator=gen, device=device)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    cot = torch.randn((2, 512, 16, 64), generator=gen,
                      device=device).to(torch.bfloat16)
    ref = attention.flash_attention(q, k, v, True)
    ref_grads = torch.autograd.grad((ref.float() * cot.float()).sum(),
                                    (q, k, v))
    exact = {}
    for name, fn in (("ring_attention", ring_attention),
                     ("ulysses_attention", ulysses_attention)):
        before = dict(comm.counts)
        out = fn(q, k, v, mesh, causal=True)
        grads = torch.autograd.grad((out.float() * cot.float()).sum(),
                                    (q, k, v))
        gpu_sync()
        exact[name] = {
            "equal": bool(torch.equal(out, ref) and all(
                torch.equal(a, b) for a, b in zip(grads, ref_grads))),
            "collectives": {k_: comm.counts[k_] - before.get(k_, 0)
                            for k_ in comm.KINDS}}
    library_ok = (all(e["equal"] for e in exact.values())
                  and exact["ulysses_attention"]["collectives"][
                      "all_to_all"] == 8
                  and exact["ring_attention"]["collectives"][
                      "ring_shift"] == 0)
    ok = ok and library_ok
    emit({"phase": "ring", "nvidia_smi": smi, "ok": ok, "shape": RING_SHAPE,
          "virtual_ranks": RING_RANKS, "causal": True, "dtypes": results,
          "library_on_one_rank": exact})
    check(ok, "ring", "dtypes %s, library %s" % (
        {k_: r["ok"] for k_, r in results.items()}, exact))
    return hop_launches


def phase_moe(device, smi):
    """``samples/moe.py`` at CONFIG (vocab 32000, dim 512, ffn 2048, 8
    experts, seq 256), batch 8: ``moe_mlp`` on the one-rank group
    (expert axis of 1; capacity factor = the experts, so nothing drops)
    against ``moe_reference`` within MOE_REF_RTOL of max |ref|; then
    MOE_STEPS train steps through ``build_train(mesh=...)``, equal to the
    no-mesh steps bit for bit, with a falling loss, tokens/s and the
    collectives a step."""
    from veles_tpu_torch.parallel import comm
    from veles_tpu_torch.parallel.mesh import mesh_from_topology
    from veles_tpu_torch.parallel.moe import moe_mlp, moe_reference
    from veles_tpu_torch.samples import moe
    cfg = moe.CONFIG
    mesh = mesh_from_topology("expert=1,data=1")
    host = moe.init_params(cfg, seed=SEED)
    params = {k: torch.tensor(v, device=device) for k, v in host.items()}
    tokens = torch.as_tensor(moe.synthetic_tokens(cfg, MOE_BATCH, seed=SEED),
                             device=device).long()
    comm.reset_counts()
    with torch.no_grad():
        h = params["embed"][tokens]
        y = moe_mlp(h, moe.moe_params(params), mesh, expert_axis="expert",
                    capacity_factor=float(cfg["experts"]))
        ref = moe_reference(h, moe.moe_params(params))
    gpu_sync()
    mlp_coll = spmd_counts()
    rel = float((y - ref).abs().max() / ref.abs().max())
    runs = {}
    for name, m in (("no_mesh", None), ("mesh", mesh)):
        p, v, step = moe.build_train(cfg, mesh=m, seed=SEED, device=device)
        losses, step_ms = [], []
        comm.reset_counts()
        for _ in range(MOE_STEPS):
            gpu_sync()
            tic = time.perf_counter()
            losses.append(float(step(p, v, tokens)[2]["loss"]))
            gpu_sync()
            step_ms.append((time.perf_counter() - tic) * 1e3)
        median = statistics.median(step_ms[1:])
        runs[name] = {"losses": losses, "step_ms": step_ms,
                      "tokens_per_s": MOE_BATCH * cfg["seq_len"]
                      / (median / 1e3),
                      "collectives": spmd_counts(), "params": p}
    equal = (runs["mesh"]["losses"] == runs["no_mesh"]["losses"]
             and all(torch.equal(runs["mesh"]["params"][k],
                                 runs["no_mesh"]["params"][k])
                     for k in runs["mesh"]["params"]))
    for run in runs.values():
        del run["params"]
    losses = runs["mesh"]["losses"]
    falls = all(numpy.isfinite(losses)) and losses[-1] < losses[0]
    coll_ok = (mlp_coll["all_to_all"] == 2 and runs["mesh"]["collectives"][
        "all_reduce"] == 2 * MOE_STEPS)
    ok = rel <= MOE_REF_RTOL and equal and falls and coll_ok
    emit({"phase": "moe", "nvidia_smi": smi, "ok": ok, "config": cfg,
          "batch": MOE_BATCH, "mesh": dict(mesh.shape),
          "moe_mlp_vs_reference_rel_err": rel, "rtol": MOE_REF_RTOL,
          "moe_mlp_collectives": mlp_coll, "runs": runs,
          "mesh_equals_no_mesh": equal, "loss_falls": falls})
    check(ok, "moe", "moe_mlp vs reference %.3g, mesh == no mesh %s, "
          "losses %s, collectives %s / %s" % (
              rel, equal, losses, mlp_coll, runs["mesh"]["collectives"]))


def phase_fused_dp(device, smi):
    """The fused trainer over the one-rank data mesh: MNIST
    ``create_workflow(fused=True, native=True, fused_config={"mesh_axes":
    {"data": -1}})`` for FUSED_DP_EPOCHS epochs against the no-mesh run
    bit for bit (closes, confusion, every parameter), one eager step and
    one capture a step shape and no recapture, the GEMM and gather
    launches exact, the step's all-reduce inside its graph (issued by
    the eager step and the capture, then replayed); then
    ``alexnet.build_fused(mesh=...)`` at batch 128, f32, ALEXNET_DP_STEPS
    captured steps against the no-mesh step, losses and params bit for
    bit, and the wall ms a step of both."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import gather
    from veles_tpu_torch.parallel import comm
    from veles_tpu_torch.parallel.mesh import make_mesh
    from veles_tpu_torch.samples import alexnet
    from veles_tpu_torch.znicz.fused_graph import to_numpy
    runs = {}
    for name, config in (("no_mesh", None),
                         ("mesh", {"mesh_axes": {"data": -1}})):
        reset_all_launches()
        comm.reset_counts()
        wf, closes, confusion, params = _fused_run(device, FUSED_DP_EPOCHS,
                                                   config)
        runs[name] = {"closes": closes, "confusion": confusion,
                      "params": params, "launches": mnist_launches(),
                      "entries": dict(gather.entry_launches),
                      "graphs": wf.fused_trainer.graph_report(),
                      "collectives": spmd_counts(),
                      "steady_epoch_ms": _steady_epoch_ms(wf)}
    mesh_run, plain = runs["mesh"], runs["no_mesh"]
    equal = (mesh_run["closes"] == plain["closes"]
             and numpy.array_equal(mesh_run["confusion"], plain["confusion"])
             and all(numpy.array_equal(mesh_run["params"][k], plain["params"][k])
                     for k in plain["params"]))
    train_steps = sum(c[3] for c in mesh_run["closes"]
                      if c[1] == "train") // 100
    eval_steps = sum(c[3] for c in mesh_run["closes"]
                     if c[1] == "validation") // 100
    products = (FUSED_TRAIN_PRODUCTS * train_steps
                + FUSED_EVAL_PRODUCTS * eval_steps)
    report = mesh_run["graphs"]
    counted = (mesh_run["launches"]["matmul"] == products
               and mesh_run["entries"]["veles_gather_group"]
               == train_steps + eval_steps
               and mesh_run["launches"] == plain["launches"]
               # the warm-up, the eager step and the capture issue it; the
               # replays run the captured all-reduce
               and mesh_run["collectives"]["all_reduce"] == 3
               and plain["collectives"]["all_reduce"] == 0)
    graphs_ok = _graphs_expected(report, train_steps, eval_steps)
    path = dict(mesh_run["launches"], **mesh_run["entries"])
    for run in runs.values():
        run["confusion"] = run["confusion"].tolist()
        del run["params"]
    # AlexNet's fused step over the data mesh against the one-device step
    alex = {}
    x, labels = alexnet.synthetic_imagenet_batch(ALEXNET_BATCH)
    x, labels = torch.from_numpy(x).to(device), torch.from_numpy(labels).to(
        device)
    for name, mesh in (("no_mesh", None), ("mesh", make_mesh({"data": -1}))):
        prng.seed_all(SEED)
        params, step, _e, _a = alexnet.build_fused(mesh=mesh, device=device)
        losses, step_ms = [], []
        for _ in range(2 + ALEXNET_DP_STEPS):
            gpu_sync()
            tic = time.perf_counter()
            losses.append(float(step(params, x, labels)[1]["loss"]))
            gpu_sync()
            step_ms.append((time.perf_counter() - tic) * 1e3)
        alex[name] = {"losses": losses, "step_ms": step_ms,
                      "graphs": step.report(), "state": to_numpy(params)}
    alex_equal = alex["mesh"]["losses"] == alex["no_mesh"]["losses"] and all(
        numpy.array_equal(a[k], b[k]) for a, b in zip(
            alex["mesh"]["state"], alex["no_mesh"]["state"])
        for k in a if a[k] is not None)
    graph = alex["mesh"]["graphs"]["step_%d" % ALEXNET_BATCH]
    alex_graph_ok = graph.get("captures") == 1 and graph.get(
        "recaptures") == 0
    for run in alex.values():
        del run["state"]
    ok = equal and counted and graphs_ok and alex_equal and alex_graph_ok
    emit({"phase": "fused_dp", "nvidia_smi": smi, "ok": ok,
          "epochs": FUSED_DP_EPOCHS, "mnist": runs,
          "mnist_bit_equal": equal, "matmul_expected": products,
          "alexnet": alex, "alexnet_batch": ALEXNET_BATCH,
          "alexnet_bit_equal": alex_equal})
    check(equal, "fused_dp", "the data-mesh run is not the no-mesh run bit "
          "for bit: closes %s vs %s" % (mesh_run["closes"], plain["closes"]))
    check(counted, "fused_dp", "launches %s / %s, collectives %s" % (
        mesh_run["launches"], mesh_run["entries"],
        mesh_run["collectives"]))
    check(graphs_ok, "fused_dp", "graphs %s" % report)
    check(alex_equal and alex_graph_ok, "fused_dp", "AlexNet over the data "
          "mesh: losses %s vs %s, graph %s" % (
              alex["mesh"]["losses"], alex["no_mesh"]["losses"], graph))
    return path


# -- 7(d) part 2: the pod, the sharded fused trainer, the TP engine ---------

POD_EPOCHS = MNIST_EPOCHS
# a one-rank pod: the forward segment's evaluator sums over the data group
# (2 all-reduces a step), each GD layer all-gathers x, y and err_output (3
# all-gathers a layer a step); the eager first dispatch and the capture of
# each segment issue them, every replay runs the captured ones
POD_SEGMENT_COLLECTIVES = {"all_reduce": 2, "all_gather": 6}
#: the payload of one pod dispatch's collectives at MNIST's width: the
#: GD segment all-gathers x, y and err_output of both layers (100 rows,
#: 100 + 10 + 10 + 784 + 100 + 100 f32 columns), the evaluator
#: all-reduces 3 f32 sums and the 10x10 int64 confusion counts
POD_SEGMENT_BYTES = {"GDSoftmax+GDTanh": 4 * 100 * 1104,
                     "MnistLoader+All2AllTanh+All2AllSoftmax"
                     "+EvaluatorSoftmax": 3 * 4 + 10 * 10 * 8}
FUSED_SHARD_EPOCHS = 3
SERVE_TP_SHARDS = 2              # virtual model shards of the serve_tp phase
SERVE_TP_LOGIT_RTOL = 1e-5       # the 2-layer f32 copy against one device


def _mnist_pod_run(device, epochs, pod, scan="off", health="off"):
    """The stitched native MNIST route (as mnist_stitched) for ``epochs``
    epochs, under a PodRuntime over the one-rank group when ``pod``:
    closes, launches, collectives, segment and window reports, the
    weights and momenta, the health snapshot and each train close's
    host time."""
    from veles_tpu_torch import prng, prof
    from veles_tpu_torch.ops import gather
    from veles_tpu_torch.parallel import comm
    from veles_tpu_torch.parallel.mesh import mesh_from_topology
    from veles_tpu_torch.pod import PodRuntime
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch.watch import health as watch_health
    with engine_knobs(stitch="on", loader="auto", epoch_scan=scan,
                      health=health):
        prng.seed_all(SEED)
        wf = mnist.create_workflow(device=device, max_epochs=epochs,
                                   native=True)
        runtime = None
        if pod:
            runtime = PodRuntime(wf, mesh=mesh_from_topology(
                {"data": -1})).install()
        closes = []
        _record_closes(wf, closes)
        times = []
        close = wf.decision._close_class

        def timed_close(cls, check_epoch_end):
            out = close(cls, check_epoch_end)
            if cls == 2:
                times.append(time.perf_counter())
            return out
        wf.decision._close_class = timed_close

        def ledger_now():
            # this device's entries: the CPU parity phases keep their own
            # under the same names
            return {e.name: (e.shards, e.collective_bytes, e.dispatches)
                    for e in prof.ledger.entries("segment")
                    if e.device == device.type}
        ledger_before = ledger_now()
        reset_all_launches()
        comm.reset_counts()
        wf.run()
        gpu_sync()
        out = {"closes": [(c["epoch"], c["cls"], c["n_err"], c["samples"])
                          for c in closes],
               "confusion": [c["confusion"].tolist() for c in closes],
               "launches": dict(mnist_launches(),
                                **gather.entry_launches),
               "collectives": spmd_counts(),
               "segments": wf.stitch_report(),
               "scan": wf.epoch_scan_report(),
               "steady_epoch_ms": [(b - a) * 1e3
                                   for a, b in zip(times, times[1:])],
               "health": watch_health.monitor.snapshot()
               if health != "off" else None,
               "state": {k: v.copy() for k, v in wf.params_to_numpy()
                         .items()}}
        for i, gd in enumerate(reversed(wf.gds)):
            for name in ("gradient_weights", "gradient_bias"):
                vec = getattr(gd, name)
                vec.map_read()
                out["state"]["%d.%s" % (i, name)] = numpy.array(vec.mem)
        if runtime is not None:
            out["pod"] = runtime.describe()
            names = {"+".join(seg.names) for seg in wf.stitch_segments}
            # this run's share of each entry
            out["ledger"] = {
                name: {"shards": shards,
                       "collective_bytes": moved - ledger_before.get(
                           name, (0, 0, 0))[1],
                       "dispatches": dispatches - ledger_before.get(
                           name, (0, 0, 0))[2]}
                for name, (shards, moved, dispatches) in ledger_now().items()
                if (name in names or name.startswith("scan:"))
                and dispatches > ledger_before.get(name, (0, 0, 0))[2]}
            runtime.uninstall()
    return out


def _states_equal(a, b):
    return sorted(a) == sorted(b) and all(
        numpy.array_equal(a[k], b[k]) for k in a)


def phase_pod(device, smi):
    """The stitched MNIST stand-in at MNIST's width (784→100→10,
    minibatch 100, u8 scaled in the head) under PodRuntime over the
    one-rank NCCL group: bit-equal to the plain stitched run (closes,
    confusion, weights, momenta), its launches the plain run's, one
    capture a segment, the collectives issued by each segment's eager
    dispatch and its capture only (the replays run them inside the
    graphs), a steady epoch's wall beside the plain run's; then
    mnist_scan's windows (epoch_scan=auto, 4 epochs) with health on, pod
    against plain: bit-equal, the same windows, the same health
    statistics, and the windows' collectives issued by each key's eager
    run and capture only."""
    runs = {}
    for name in ("plain", "pod"):
        runs[name] = _mnist_pod_run(device, POD_EPOCHS, name == "pod")
    plain, pod = runs["plain"], runs["pod"]
    equal = (pod["closes"] == plain["closes"]
             and pod["confusion"] == plain["confusion"]
             and _states_equal(pod["state"], plain["state"]))
    want = {kind: 2 * count for kind, count in
            POD_SEGMENT_COLLECTIVES.items()}
    collectives_ok = all(pod["collectives"][k] == v
                         for k, v in want.items()) \
        and plain["collectives"]["all_gather"] == 0
    launches_ok = pod["launches"] == plain["launches"] and \
        {k: pod["launches"][k] for k in MNIST_STITCHED_LAUNCHES} \
        == MNIST_STITCHED_LAUNCHES
    # the ledger's collective_bytes: each dispatch's payload, counted
    # where the stages issue it (a replay moves what its capture counted)
    bytes_ok = all(
        pod["ledger"].get(name, {}).get("dispatches", 0) > 0
        and pod["ledger"][name]["collective_bytes"]
        == per * pod["ledger"][name]["dispatches"]
        for name, per in POD_SEGMENT_BYTES.items())
    segments_ok = ([r["dispatches"] for r in pod["segments"]]
                   == MNIST_STITCHED_DISPATCHES
                   and [r["captures"] for r in pod["segments"]] == [1, 1]
                   and all(r["recaptures"] == 0 for r in pod["segments"]))
    scans = {}
    for name in ("plain", "pod"):
        scans[name] = _mnist_pod_run(device, MNIST_SCAN_EPOCHS,
                                     name == "pod", scan="auto",
                                     health="on")
    sp, sd = scans["plain"], scans["pod"]
    scan_equal = (sd["closes"] == sp["closes"]
                  and _states_equal(sd["state"], sp["state"])
                  and sd["health"]["groups"] == sp["health"]["groups"])
    train_k, valid_k = 60, 10
    scan_want = {"all_gather": 2 * train_k * 6,
                 "all_reduce": 2 * (train_k + valid_k) * 2}
    scan_ok = (sd["scan"]["windows"] == sp["scan"]["windows"] > 0
               and sd["collectives"]["all_gather"] == scan_want["all_gather"]
               and sd["collectives"]["all_reduce"] == scan_want["all_reduce"]
               and all(g["recaptures"] == 0
                       for g in sd["scan"]["graphs"].values()))
    for run in list(runs.values()) + list(scans.values()):
        run.pop("state")
        run.pop("confusion")
    ok = equal and collectives_ok and launches_ok and segments_ok \
        and bytes_ok and scan_equal and scan_ok
    emit({"phase": "pod", "nvidia_smi": smi, "ok": ok,
          "epochs": POD_EPOCHS, "per_step": runs, "bit_equal": equal,
          "collectives_expected": want,
          "collective_bytes_expected": POD_SEGMENT_BYTES, "windows": {
              "epochs": MNIST_SCAN_EPOCHS, "runs": {
                  k: {key: v[key] for key in ("closes", "collectives",
                                              "steady_epoch_ms", "health",
                                              "pod", "ledger") if key in v}
                  for k, v in scans.items()},
              "scan": {k: {key: v["scan"][key] for key in ("windows",
                                                           "steps")}
                       for k, v in scans.items()},
              "bit_equal": scan_equal,
              "collectives_expected": scan_want}})
    check(equal, "pod", "the one-rank pod is not the stitched run bit for "
          "bit: closes %s vs %s" % (pod["closes"], plain["closes"]))
    check(collectives_ok, "pod", "collectives %s, want %s"
          % (pod["collectives"], want))
    check(launches_ok, "pod", "launches %s vs %s" % (pod["launches"],
                                                    plain["launches"]))
    check(segments_ok, "pod", "segments %s" % pod["segments"])
    check(bytes_ok, "pod", "ledger %s, want %s bytes a dispatch"
          % (pod["ledger"], POD_SEGMENT_BYTES))
    check(scan_equal, "pod", "the pod's windows are not the plain "
          "windows bit for bit (closes %s vs %s, health %s vs %s)"
          % (sd["closes"], sp["closes"], sd["health"], sp["health"]))
    check(scan_ok, "pod", "windows %s / %s, collectives %s, want %s" % (
        sd["scan"]["windows"], sp["scan"]["windows"], sd["collectives"],
        scan_want))
    return pod["launches"]


def phase_fused_shard(device, smi):
    """The fused MNIST trainer (native, minibatch 100) with ``fsdp=True``
    over ``{"data": -1}`` and ``tp=True`` over ``{"data": 1, "model": 1}``
    on the one-rank NCCL group, each bit-equal to the unsharded fused run
    (closes, confusion, weights, the whole solver state), launches
    equal, one capture a step shape; then AlexNet's bf16 step at batch
    128 with ``fsdp`` over the one-rank data mesh against the no-mesh
    bf16 step, losses and params bit for bit."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import gather
    from veles_tpu_torch.parallel import comm
    from veles_tpu_torch.parallel.mesh import make_mesh
    from veles_tpu_torch.samples import alexnet
    from veles_tpu_torch.znicz.fused_graph import to_numpy
    runs = {}
    for name, config in (
            ("no_mesh", None),
            ("fsdp", {"mesh_axes": {"data": -1}, "fsdp": True}),
            ("tp", {"mesh_axes": {"data": 1, "model": 1}, "tp": True})):
        reset_all_launches()
        comm.reset_counts()
        wf, closes, confusion, params = _fused_run(
            device, FUSED_SHARD_EPOCHS, config)
        trainer = wf.fused_trainer
        runs[name] = {"closes": closes, "confusion": confusion.tolist(),
                      "params": params, "solver": trainer.capture_state(),
                      "launches": dict(mnist_launches(),
                                       **gather.entry_launches),
                      "graphs": trainer.graph_report(),
                      "collectives": spmd_counts(),
                      "specs": None if trainer._specs_ is None else [
                          {k: list(v) for k, v in layer.items()}
                          for layer in trainer._specs_],
                      "steady_epoch_ms": _steady_epoch_ms(wf)}
    plain = runs["no_mesh"]

    def same(run):
        return (run["closes"] == plain["closes"]
                and run["confusion"] == plain["confusion"]
                and _states_equal(run["params"], plain["params"])
                and all(_states_equal(
                    {k: v for k, v in a.items() if v is not None},
                    {k: v for k, v in b.items() if v is not None})
                    for a, b in zip(run["solver"], plain["solver"])))
    equal = {name: same(runs[name]) for name in ("fsdp", "tp")}
    launches_ok = all(runs[n]["launches"] == plain["launches"]
                      for n in ("fsdp", "tp"))
    graphs_ok = all(
        r.get("captures", 0) <= 1 and r.get("recaptures", 0) == 0
        for n in ("fsdp", "tp") for r in runs[n]["graphs"].values())
    specs_ok = (runs["fsdp"]["specs"][0]["w"] == ["data", None]
                and runs["tp"]["specs"][0]["w"] == [None, "model"])
    for run in runs.values():
        del run["params"], run["solver"]
    alex = {}
    x, labels = alexnet.synthetic_imagenet_batch(ALEXNET_BATCH)
    x, labels = torch.from_numpy(x).to(device), torch.from_numpy(labels).to(
        device)
    for name, kwargs in (("no_mesh", {}),
                         ("fsdp", {"mesh": make_mesh({"data": -1}),
                                   "fsdp": True})):
        prng.seed_all(SEED)
        params, step, _e, _a = alexnet.build_fused(
            device=device, compute_dtype="bfloat16", **kwargs)
        losses, step_ms = [], []
        for _ in range(2 + ALEXNET_DP_STEPS):
            gpu_sync()
            tic = time.perf_counter()
            losses.append(float(step(params, x, labels)[1]["loss"]))
            gpu_sync()
            step_ms.append((time.perf_counter() - tic) * 1e3)
        alex[name] = {"losses": losses, "step_ms": step_ms,
                      "graphs": step.report(), "state": to_numpy(params)}
    alex_equal = alex["fsdp"]["losses"] == alex["no_mesh"]["losses"] and all(
        numpy.array_equal(a[k], b[k]) for a, b in zip(
            alex["fsdp"]["state"], alex["no_mesh"]["state"])
        for k in a if a[k] is not None)
    for run in alex.values():
        del run["state"]
    ok = all(equal.values()) and launches_ok and graphs_ok and specs_ok \
        and alex_equal
    emit({"phase": "fused_shard", "nvidia_smi": smi, "ok": ok,
          "epochs": FUSED_SHARD_EPOCHS, "mnist": runs, "bit_equal": equal,
          "alexnet": alex, "alexnet_batch": ALEXNET_BATCH,
          "alexnet_dtype": "bfloat16", "alexnet_bit_equal": alex_equal})
    check(all(equal.values()), "fused_shard", "a sharded run is not the "
          "unsharded run bit for bit: %s" % equal)
    check(launches_ok and graphs_ok and specs_ok, "fused_shard",
          "launches %s, graphs %s, specs %s" % (
              {n: r["launches"] for n, r in runs.items()},
              {n: r["graphs"] for n, r in runs.items()},
              {n: r["specs"] for n, r in runs.items()}))
    check(alex_equal, "fused_shard", "AlexNet bf16 with fsdp: losses %s vs "
          "%s" % (alex["fsdp"]["losses"], alex["no_mesh"]["losses"]))
    return runs["fsdp"]["launches"]


def phase_serve_tp(device, smi, serve_streams, serve_tokens_per_s):
    """The generative engine at full width (CONFIG: 16x64 heads, 12
    layers, bf16) as two virtual model shards on the card
    (:class:`veles_tpu_torch.gen.model.VirtualShards`: each shard an
    engine over ``TransformerGenModel.shard`` in its own thread, the
    ``wo`` and ``w2`` float32 partials summed in rank order where the
    all-reduce would go), contiguous and paged: the 8 serve requests'
    greedy streams over 64 new tokens equal to the serve engine's, the
    flash and decode kernels launched at 8 heads, their launches and
    local-head shapes, tokens/s beside serve's; then a 2-layer f32 copy's
    last-position logits against the single-device model's within
    SERVE_TP_LOGIT_RTOL relative."""
    from veles_tpu_torch.gen import (GenerativeEngine, GenerativeScheduler,
                                     TransformerGenModel)
    from veles_tpu_torch.gen import model as gen_model
    from veles_tpu_torch.ops import attention
    from veles_tpu_torch.samples.transformer import CONFIG
    lengths, workload = serve_workload(CONFIG["vocab"])
    heads_seen = {}
    wrapped = {}
    for name in ("flash_attention", "decode_attention",
                 "paged_decode_attention"):
        inner = getattr(gen_model, name)

        def recording(q, *args, _name=name, _inner=inner, **kwargs):
            heads_seen.setdefault(_name, set()).add(int(q.shape[2]))
            return _inner(q, *args, **kwargs)
        wrapped[name] = inner
        setattr(gen_model, name, recording)
    info = {"phase": "serve_tp", "nvidia_smi": smi,
            "config": dict(CONFIG), "compute_dtype": "bfloat16",
            "shards": SERVE_TP_SHARDS, "requests": len(workload),
            "prompt_lengths": lengths.tolist(),
            "new_tokens": SERVE_NEW_TOKENS,
            "serve_tokens_per_s": serve_tokens_per_s}
    try:
        model = TransformerGenModel(CONFIG, compute_dtype=torch.bfloat16,
                                    device=device)
        full = model.init_params(seed=SEED)
        for kv in ("contiguous", "paged"):
            group = gen_model.VirtualShards(SERVE_TP_SHARDS)
            shards = [model.shard(r, SERVE_TP_SHARDS, group)
                      for r in range(SERVE_TP_SHARDS)]
            options = {"kv": "paged"} if kv == "paged" else {}
            engines = [GenerativeEngine(
                part, params=part.shard_params(full), max_slots=4,
                max_seq=2048, seed=SEED, device=device, **options)
                for part in shards]
            group.run(lambda r: engines[r].warmup())
            gpu_sync()
            attention.reset_launches()
            reductions0 = group.reductions
            tic = time.perf_counter()

            def serve(rank):
                scheduler = GenerativeScheduler(engines[rank])
                futures = [scheduler.submit(toks, SERVE_NEW_TOKENS)
                           for toks in workload]
                scheduler.run_until_idle()
                return [f.result(0) for f in futures]
            streams = group.run(serve)
            gpu_sync()
            elapsed = time.perf_counter() - tic
            tokens = sum(len(s) for s in streams[0])
            info[kv] = {
                "elapsed_s": elapsed, "tokens": tokens,
                "tokens_per_s": tokens / elapsed,
                "launches": dict(attention.launches),
                "local_heads": {k: sorted(v) for k, v in heads_seen.items()},
                "cache_heads": int(engines[0]._cache["k"].shape[3]),
                "reductions": group.reductions - reductions0,
                "prefills": engines[0].prefill_calls,
                "decode_steps": engines[0].decode_calls,
                "shards_agree": all(s == streams[0] for s in streams),
                "equal_serve": streams[0] == serve_streams}
            heads_seen.clear()
            for engine in engines:
                engine.close()
            del engines
    finally:
        for name, inner in wrapped.items():
            setattr(gen_model, name, inner)
    small = dict(CONFIG, layers=2)
    one = TransformerGenModel(small, device=device)
    params = one.init_params(seed=SEED)
    tokens = torch.tensor(workload[0][:256], dtype=torch.long)
    want = one.calibration_logits(params, tokens)
    group = gen_model.VirtualShards(SERVE_TP_SHARDS)
    parts = [one.shard(r, SERVE_TP_SHARDS, group)
             for r in range(SERVE_TP_SHARDS)]
    got = group.run(lambda r: parts[r].calibration_logits(
        parts[r].shard_params(params), tokens))
    rel = float((got[0] - want).abs().max() / want.abs().max())
    info["logits_rel_err"] = rel
    layers = CONFIG["layers"]
    half = CONFIG["heads"] // SERVE_TP_SHARDS
    ok = True
    for kv in ("contiguous", "paged"):
        run = info[kv]
        decode = "paged_decode_attention" if kv == "paged" \
            else "decode_attention"
        run["ok"] = (run["equal_serve"] and run["shards_agree"]
                     and run["cache_heads"] == half
                     and run["local_heads"].get("flash_attention") == [half]
                     and run["local_heads"].get(decode) == [half]
                     and run["prefills"] > 0 and run["decode_steps"] > 0
                     # one launch a shard, a layer and a call
                     and run["launches"].get("flash_fwd", 0)
                     == SERVE_TP_SHARDS * layers * run["prefills"]
                     and run["launches"].get(
                         "paged_decode_attn" if kv == "paged"
                         else "decode_attn", 0)
                     == SERVE_TP_SHARDS * layers * run["decode_steps"]
                     and run["reductions"] > 0)
        ok = ok and run["ok"]
    info["ok"] = ok and rel <= SERVE_TP_LOGIT_RTOL
    emit(info)
    for kv in ("contiguous", "paged"):
        check(info[kv]["ok"], "serve_tp", "%s: %s" % (kv, info[kv]))
    check(rel <= SERVE_TP_LOGIT_RTOL, "serve_tp", "the 2-layer f32 copy's "
          "logits are %.3g relative from one device's" % rel)
    # both runs' launches: the contiguous and the paged decode kernels
    return {k: info["contiguous"]["launches"].get(k, 0)
            + info["paged"]["launches"].get(k, 0)
            for k in set(info["contiguous"]["launches"])
            | set(info["paged"]["launches"])}


# -- the job layer and the entry point (ROADMAP 7(e), first part) ------------

#: the chaos phase's faults on the card's MNIST session: slave A killed
#: holding its 2nd job, the 5th job frame dropped, the 4th update frame
#: duplicated (the CPU gate's, tests/test_torch_chaos.py)
JOBS_CHAOS_SCHEDULE = [
    {"site": "slave_job", "action": "slave_kill", "nth": 2},
    {"site": "master_send", "action": "drop", "op": "job", "nth": 5},
    {"site": "slave_send", "action": "dup", "op": "update", "nth": 4},
]
#: the master checkpoints every 10 applied updates (and at each epoch's
#: start); the surviving slave's 40th job waits for the master's kill,
#: so the kill lands mid-run, after the lost frame's requeue
JOBS_CHAOS_EVERY = 10
JOBS_CHAOS_HOLD_AT = 40
JOBS_CHAOS_SEED = 7
#: the bootstrapped CLI session's epochs (root.mnist.max_epochs) and its
#: time limit
JOBS_CLI_EPOCHS = 3
JOBS_CLI_TIMEOUT_S = 300


def _job_workflow(device, epochs, role, fused=False):
    """The MNIST sample's workflow (native u8, full width) as a job
    master or slave on ``device``: built through ``launcher=`` and
    initialized there, as the entry point does."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.samples import mnist
    prng.seed_all(SEED)
    launcher = DummyLauncher(is_master=role == "master",
                             is_slave=role == "slave")
    wf = mnist.create_workflow(device=device, max_epochs=epochs,
                               native=True, fused=fused, launcher=launcher)
    wf.initialize(device=make_device(device))
    return wf


def _weights(wf):
    """The master's weights and biases (its momenta never move)."""
    return {name: value for name, value in wf.params_to_numpy().items()
            if name.endswith((".weights", ".bias"))}


def _job_session(device, epochs, fused=False):
    """One in-process JobServer over the MNIST master workflow and one
    synchronous JobClient slave (``client.run()``), both on ``device``,
    to the Decision's end.  The kernel launches are counted from the
    slave's first job request to its last update (the master runs no
    kernel); the frames each job moves are measured as pickled."""
    import pickle

    from veles_tpu_torch.memory import Watcher
    from veles_tpu_torch.ops import gather
    from veles_tpu_torch.parallel.jobs import JobClient, JobServer
    master = _job_workflow(device, epochs, "master", fused)
    slave = _job_workflow(device, epochs, "slave", fused)
    before_weights = _weights(master)
    server = JobServer(master)
    frames = {"job": [], "update": []}
    served = []
    send = server._send

    def counted_send(identity, msg):
        if msg.get("op") == "job":
            served.append(msg["job"]["seq"])
            frames["job"].append(len(pickle.dumps(
                msg, pickle.HIGHEST_PROTOCOL)))
        return send(identity, msg)
    server._send = counted_send
    server.start()
    try:
        client = JobClient(slave, server.endpoint)
        chaos_send = client._chaos_send

        def counted_chaos_send(msg):
            if msg.get("op") == "update":
                frames["update"].append(len(pickle.dumps(
                    msg, pickle.HIGHEST_PROTOCOL)))
            return chaos_send(msg)
        client._chaos_send = counted_chaos_send
        client.handshake()
        reset_all_launches()
        moved = Watcher.transfers()
        tic = time.perf_counter()
        finished = client.run()
        if device.type == "cuda":
            gpu_sync()
        wall_s = time.perf_counter() - tic
        launches = dict(mnist_launches(), **gather.entry_launches)
        moved = {key: value - moved[key]
                 for key, value in Watcher.transfers().items()}
        hist = server.slaves[client.sid].latency
        latency = {"count": hist.count, "mean_ms": hist.mean * 1e3,
                   "p50_ms": hist.percentile(50) * 1e3,
                   "p95_ms": hist.percentile(95) * 1e3,
                   "p99_ms": hist.percentile(99) * 1e3}
        client.close()
    finally:
        server.stop()
    jobs = client.jobs_done
    applied = list(server._applied_order)
    return {
        "master": master, "slave": slave, "server": server,
        "finished": finished, "jobs": jobs, "wall_s": wall_s,
        "launches": launches, "served": served, "applied": applied,
        "exactly_once": (applied == served and len(set(applied)) == jobs
                         and server._updates_applied == jobs
                         and server.dedup_dropped == 0
                         and server.stale_rejected == 0
                         and server.lost_requeued == 0),
        "moved": not all(numpy.array_equal(before_weights[k], v)
                         for k, v in _weights(master).items()),
        "closes": [(c["epoch"], c["cls"], c["n_err"], c["samples"])
                   for c in master.decision.history],
        "latency": latency,
        "frame_bytes": {
            "job_median": statistics.median(frames["job"]),
            "update_median": statistics.median(frames["update"]),
            "jobs_sent": len(frames["job"]),
            "updates_sent": len(frames["update"])},
        "transfers_per_job": {key: value / max(jobs, 1)
                              for key, value in moved.items()},
    }


def _session_json(s):
    return {key: s[key] for key in ("finished", "jobs", "wall_s",
                                    "launches", "exactly_once", "moved",
                                    "closes", "latency", "frame_bytes",
                                    "transfers_per_job")}


def _job_span_breakdown(device):
    """A 2-epoch session with the span recorder on: the mean and median
    ms of each ``jobs`` span (the master's job generation and update
    apply, the slave's job request, ``do_job`` and update rpcs) and of
    the slave's segment dispatches, and the jobs each covers."""
    from veles_tpu_torch import trace
    with engine_knobs(stitch="on", loader="auto", epoch_scan="off",
                      trace="on"):
        trace.recorder.clear()
        session = _job_session(device, MNIST_PARITY_EPOCHS)
        events = trace.normalize()
    trace.configure()
    trace.recorder.clear()
    spans = {}
    for ev in events:
        if ev["ph"] == "X" and ev["cat"] in ("jobs", "segment"):
            spans.setdefault("%s:%s" % (ev["cat"], ev["name"]), []).append(
                ev["dur_us"] / 1e3)
    return {"jobs": session["jobs"], "wall_ms": session["wall_s"] * 1e3,
            "spans_ms": {key: {"count": len(v),
                               "mean": statistics.mean(v),
                               "median": statistics.median(v)}
                         for key, v in sorted(spans.items())}}


def phase_jobs(device, smi):
    """The job layer on the card: an in-process JobServer over the MNIST
    master workflow (full width, native, stitched) and one JobClient
    slave in the same process, both on the card, MNIST_EPOCHS to the
    Decision's end.  Every job applied exactly once (served seqs ==
    applied seqs, no dedup, stale or requeue), the master's weights
    moved, and the slave's launches exactly the stitched route's
    (MNIST_STITCHED_LAUNCHES: a job is one minibatch through the two
    segments, one capture each, no recapture after the first job); the
    session's wall ms, jobs/s, the job round trip's percentiles and the
    bytes each job moves each way; then a traced 2-epoch session's
    span means (where a job's time goes)."""
    phase = "jobs"
    with engine_knobs(stitch="on", loader="auto", epoch_scan="off"):
        s = _job_session(device, MNIST_EPOCHS)
    launches = {key: s["launches"].get(key, 0)
                for key in MNIST_STITCHED_LAUNCHES}
    entries = {key: s["launches"].get(key, 0)
               for key in MNIST_STITCHED_ENTRY_LAUNCHES}
    report = s["slave"].stitch_report()
    counted = (launches == MNIST_STITCHED_LAUNCHES
               and entries == MNIST_STITCHED_ENTRY_LAUNCHES)
    graphs_ok = ([r["dispatches"] for r in report] == MNIST_STITCHED_DISPATCHES
                 and [r["captures"] for r in report] == [1, 1]
                 and all(r["recaptures"] == 0 for r in report))
    valid = [c[2] for c in s["closes"] if c[1] == "validation"]
    learned = len(valid) == MNIST_EPOCHS and valid[-1] < valid[0]
    complete = bool(s["master"].decision.complete) and s["finished"]
    info = dict(_session_json(s), phase=phase, nvidia_smi=smi,
                layers="784-100 all2all_tanh, 100-10 softmax",
                minibatch=100, max_epochs=MNIST_EPOCHS,
                data="synthetic stand-in as u8, 1/255 in the loader head",
                route="stitched slave, in-process master, stdlib TCP wire",
                wall_ms=s["wall_s"] * 1e3,
                jobs_per_s=s["jobs"] / s["wall_s"],
                launches_expected=MNIST_STITCHED_LAUNCHES,
                entry_launches_expected=MNIST_STITCHED_ENTRY_LAUNCHES,
                segments=report,
                ok=counted and graphs_ok and learned and complete
                and s["exactly_once"] and s["moved"])
    info["traced"] = _job_span_breakdown(device)
    emit(info)
    check(complete, phase, "the session did not reach the Decision's end")
    check(s["exactly_once"], phase, "jobs not applied exactly once: "
          "served %s, applied %s" % (s["served"], s["applied"]))
    check(s["moved"], phase, "the master's weights did not move")
    check(counted, phase, "the slave's launches %s %s, want %s %s"
          % (launches, entries, MNIST_STITCHED_LAUNCHES,
             MNIST_STITCHED_ENTRY_LAUNCHES))
    check(graphs_ok, phase, "the slave's segments dispatched, captured or "
          "recaptured other than expected: %s" % report)
    check(learned, phase, "validation error did not fall: %s" % valid)
    return s["launches"]


def phase_jobs_parity(device):
    """The one-slave synchronous session on the card and on the CPU (the
    port's plain kernels) for MNIST_PARITY_EPOCHS: each class close's
    n_err equal and the master's weights within MNIST_PARAM_RTOL of each
    leaf's largest value."""
    phase = "jobs_parity"
    with engine_knobs(stitch="on", loader="auto", epoch_scan="off"):
        card = _job_session(device, MNIST_PARITY_EPOCHS)
        cpu = _job_session(torch.device("cpu"), MNIST_PARITY_EPOCHS)
    errors = _param_rel_errors(_weights(card["master"]),
                               _weights(cpu["master"]))
    closes_ok = card["closes"] == cpu["closes"]
    params_ok = max(errors.values()) <= MNIST_PARAM_RTOL
    once = card["exactly_once"] and cpu["exactly_once"]
    emit({"phase": phase, "ok": closes_ok and params_ok and once,
          "epochs": MNIST_PARITY_EPOCHS, "card_closes": card["closes"],
          "cpu_closes": cpu["closes"], "param_rel_errors": errors,
          "param_rtol": MNIST_PARAM_RTOL, "card_jobs": card["jobs"],
          "cpu_jobs": cpu["jobs"]})
    check(once, phase, "a session did not apply its jobs exactly once")
    check(closes_ok, phase, "class closes differ: card %s, cpu %s"
          % (card["closes"], cpu["closes"]))
    check(params_ok, phase, "master weights differ: %s" % errors)


def phase_jobs_fused(device, smi):
    """A fused slave on the card (``--fused``: one FusedTrainer step a
    job): its GEMM launches are the step graphs' (5 a train job, 2 an
    eval job, the minibatch's gather in each graph), one eager step and
    one capture a step shape and no recapture after (each job's weights
    go into the captured parameters in place); the master's weights
    within MNIST_PARAM_RTOL of the CPU's fused session and the closes
    equal."""
    phase = "jobs_fused"
    card = _job_session(device, MNIST_PARITY_EPOCHS, fused=True)
    cpu = _job_session(torch.device("cpu"), MNIST_PARITY_EPOCHS, fused=True)
    launches = card["launches"]
    report = card["slave"].fused_trainer.graph_report()
    train_steps = sum(c[3] for c in card["closes"] if c[1] == "train") // 100
    eval_steps = sum(c[3] for c in card["closes"]
                     if c[1] == "validation") // 100
    products = (FUSED_TRAIN_PRODUCTS * train_steps
                + FUSED_EVAL_PRODUCTS * eval_steps)
    counted = (launches["matmul"] == products
               and launches["matmul_bf16"] == 0
               and launches["gd_dx"] == launches["gd_dw"] == 0
               and launches["veles_gather_group"]
               == train_steps + eval_steps
               and all(report[key].get("graph_launches", {}).get(
                   "veles_gather_group") == 1
                   for key in ("train_100", "eval_100")))
    graphs_ok = _graphs_expected(report, train_steps, eval_steps)
    errors = _param_rel_errors(_weights(card["master"]),
                               _weights(cpu["master"]))
    params_ok = max(errors.values()) <= MNIST_PARAM_RTOL
    closes_ok = card["closes"] == cpu["closes"]
    once = card["exactly_once"] and cpu["exactly_once"]
    emit(dict(_session_json(card), phase=phase, nvidia_smi=smi,
              ok=counted and graphs_ok and params_ok and closes_ok and once,
              epochs=MNIST_PARITY_EPOCHS, train_steps=train_steps,
              eval_steps=eval_steps, matmul_expected=products,
              graphs=report, cpu_closes=cpu["closes"],
              param_rel_errors=errors, param_rtol=MNIST_PARAM_RTOL,
              wall_ms=card["wall_s"] * 1e3,
              jobs_per_s=card["jobs"] / card["wall_s"]))
    check(once, phase, "a session did not apply its jobs exactly once")
    check(counted, phase, "launches %s, want matmul %d and one gather a "
          "job inside the step graphs %s" % (launches, products, report))
    check(graphs_ok, phase, "the step graphs were not one eager step, one "
          "capture and replays with no recapture: %s" % report)
    check(closes_ok, phase, "class closes differ: card %s, cpu %s"
          % (card["closes"], cpu["closes"]))
    check(params_ok, phase, "master weights differ: %s" % errors)
    return launches


def phase_jobs_chaos(device, smi):
    """The chaos gate's seeded schedule on the card's MNIST session
    (stitched slaves, in-process masters): slave A killed holding its
    2nd job, the 5th job frame dropped, the 4th update frame duplicated,
    and the master killed once the dropped frame was requeued and a
    checkpoint written (slave B's JOBS_CHAOS_HOLD_AT-th job waits for
    the kill); a fresh master resumes the latest checkpoint on the same
    port.  The session completes, every seq is applied once within each
    generation, ``dedup_dropped`` >= the duplicates injected,
    ``lost_requeued`` > 0, and the resume is within one checkpoint
    interval of the kill."""
    import tempfile
    import threading

    from veles_tpu_torch import chaos
    from veles_tpu_torch.parallel.jobs import JobClient, JobServer
    phase = "jobs_chaos"
    reset_all_launches()
    tic = time.perf_counter()
    with engine_knobs(stitch="on", loader="auto", epoch_scan="off"), \
            tempfile.TemporaryDirectory() as ckdir:
        chaos.controller.arm(list(JOBS_CHAOS_SCHEDULE), seed=JOBS_CHAOS_SEED)
        try:
            m1 = _job_workflow(device, MNIST_EPOCHS, "master")
            server1 = JobServer(m1, checkpoint_dir=ckdir,
                                checkpoint_every=JOBS_CHAOS_EVERY,
                                slave_timeout=5.0,
                                heartbeat_interval=0.3).start()
            port = server1.port
            client_a = JobClient(_job_workflow(device, MNIST_EPOCHS,
                                               "slave"),
                                 server1.endpoint, rpc_timeout_ms=1200,
                                 reconnect_max_wait=10.0)
            client_a.handshake()
            a_died = client_a.run() is False
            client_a.close()
            slave_b = _job_workflow(device, MNIST_EPOCHS, "slave")
            killed = threading.Event()
            jobs_seen = []
            do_job = slave_b.do_job

            def held_do_job(data, callback):
                jobs_seen.append(1)
                if len(jobs_seen) == JOBS_CHAOS_HOLD_AT:
                    killed.wait(60)
                do_job(data, callback)
            slave_b.do_job = held_do_job
            client_b = JobClient(slave_b, server1.endpoint,
                                 rpc_timeout_ms=1200,
                                 reconnect_max_wait=25.0)
            client_b.handshake()
            done = []
            runner = threading.Thread(
                target=lambda: done.append(client_b.run()))
            runner.start()
            deadline = time.time() + 60
            ckpt = server1._checkpointer()
            while time.time() < deadline and not (
                    len(jobs_seen) >= JOBS_CHAOS_HOLD_AT
                    and server1.lost_requeued
                    and not server1._ckpt_busy.is_set()
                    and ckpt.latest_step() is not None
                    and server1._updates_applied - ckpt.latest_step()
                    <= JOBS_CHAOS_EVERY):
                time.sleep(0.01)
            killed_at = server1._updates_applied
            checkpointed = ckpt.latest_step()
            server1.kill()
            killed.set()
            m2 = _job_workflow(device, MNIST_EPOCHS, "master")
            server2 = JobServer(m2, port=port, checkpoint_dir=ckdir,
                                checkpoint_every=JOBS_CHAOS_EVERY,
                                slave_timeout=5.0, heartbeat_interval=0.3)
            resumed_step = server2.resume_from_checkpoint()
            server2.start()
            try:
                runner.join(120)
                hung = runner.is_alive()
                client_b.close()
            finally:
                server2.stop()
            snap = chaos.controller.snapshot()
        finally:
            chaos.controller.disarm()
    if device.type == "cuda":
        gpu_sync()
    elapsed = time.perf_counter() - tic
    injected = snap["injected"]
    once = all(len(list(srv._applied_order))
               == len(set(srv._applied_order)) for srv in (server1, server2))
    dedup = server1.dedup_dropped + server2.dedup_dropped
    complete = (not hung and done == [True] and bool(m2.decision.complete))
    ok = (a_died and complete and once
          and injected.get("slave_kill") == 1
          and dedup >= injected.get("dup", 0) >= 1
          and server1.lost_requeued > 0
          and killed_at - resumed_step <= JOBS_CHAOS_EVERY
          and server2.generation == 2)
    closes = [(c["epoch"], c["cls"], c["n_err"], c["samples"])
              for c in m2.decision.history]
    emit({"phase": phase, "nvidia_smi": smi, "ok": ok,
          "schedule": JOBS_CHAOS_SCHEDULE, "seed": JOBS_CHAOS_SEED,
          "checkpoint_every": JOBS_CHAOS_EVERY,
          "hold_at": JOBS_CHAOS_HOLD_AT, "injected": injected,
          "slave_a_died": a_died, "complete": complete,
          "killed_at_update": killed_at, "checkpoint_step": checkpointed,
          "resumed_step": resumed_step,
          "dedup_dropped": dedup,
          "stale_rejected": server1.stale_rejected
          + server2.stale_rejected,
          "lost_requeued": server1.lost_requeued + server2.lost_requeued,
          "applied": [len(server1._applied_order),
                      len(server2._applied_order)],
          "closes_after_resume": closes, "elapsed_s": elapsed,
          "launches": dict(mnist_launches())})
    check(a_died, phase, "the scheduled slave kill did not fire")
    check(complete, phase, "the chaos session did not complete (hung %s, "
          "run %s, complete %s)" % (hung, done, bool(m2.decision.complete)))
    check(once, phase, "a seq was applied twice in one generation")
    check(dedup >= injected.get("dup", 0) >= 1, phase,
          "%d duplicates deduplicated for %s injected"
          % (dedup, injected.get("dup")))
    check(server1.lost_requeued > 0, phase, "the dropped job frame was "
          "never requeued")
    check(killed_at - resumed_step <= JOBS_CHAOS_EVERY, phase,
          "resumed at step %d, killed at %d: more than one interval (%d)"
          % (resumed_step, killed_at, JOBS_CHAOS_EVERY))
    return dict(mnist_launches())


def phase_cli(device, smi):
    """The entry point as a user runs it: ``python -m veles_tpu_torch
    veles_tpu_torch.samples.mnist -l 127.0.0.1:0 -n 'localhost x2'
    --slave-launch-transform 'sh -c' --result-file ... --profile ...``
    (on the card: no ``-d``), a subprocess whose master bootstraps two
    slave processes on this card.  Exit code 0; both slaves did jobs (the
    session bundle's ``do_job`` spans by slave role); the result file
    holds the Decision's final metrics; every spawned process is gone
    when the master exits."""
    import os
    import tempfile
    phase = "cli"
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "result.json")
        profile = os.path.join(tmp, "profile")
        cmd = [sys.executable, "-m", "veles_tpu_torch",
               "veles_tpu_torch.samples.mnist", "-l", "127.0.0.1:0", "-n",
               "localhost x2", "--slave-launch-transform", "sh -c",
               "--result-file", result, "--profile", profile,
               "--no-logo", "-v", "warning",
               "root.mnist.max_epochs=%d" % JOBS_CLI_EPOCHS]
        checkout = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=checkout)
        tic = time.perf_counter()
        proc = subprocess.run(cmd, cwd=checkout, env=env,
                              capture_output=True, text=True,
                              timeout=JOBS_CLI_TIMEOUT_S)
        elapsed = time.perf_counter() - tic
        results = None
        if os.path.exists(result):
            with open(result) as fin:
                results = json.load(fin)
        jobs_by_slave = {}
        bundle_path = os.path.join(profile, "session_profile.json")
        if os.path.exists(bundle_path):
            with open(bundle_path) as fin:
                bundle = json.load(fin)
            for sid, shipped in bundle["slaves"].items():
                jobs_by_slave[sid] = sum(
                    1 for ev in shipped["events"]
                    if ev.get("cat") == "jobs" and ev.get("name") == "do_job"
                    and ev.get("role") == "slave-%s" % sid)
        pids = [int(name[:-len(".json")].rsplit("_", 1)[1])
                for name in (os.listdir(profile)
                             if os.path.isdir(profile) else [])
                if name.startswith("trace_slave_")]
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    ok = (proc.returncode == 0 and len(jobs_by_slave) == 2
          and all(n > 0 for n in jobs_by_slave.values())
          and results is not None
          and {"best_validation_error_pt", "best_epoch",
               "errors_pt"} <= set(results)
          and results["Total epochs"] == JOBS_CLI_EPOCHS - 1
          and len(pids) == 2 and not alive)
    emit({"phase": phase, "nvidia_smi": smi, "ok": ok,
          "command": " ".join(cmd[1:]), "returncode": proc.returncode,
          "elapsed_s": elapsed, "jobs_by_slave": jobs_by_slave,
          "results": results, "slave_pids": pids, "alive": alive,
          "stderr_tail": proc.stderr[-2000:] if not ok else ""})
    check(proc.returncode == 0, phase, "exit code %d: %s"
          % (proc.returncode, proc.stderr[-3000:]))
    check(len(jobs_by_slave) == 2 and all(n > 0 for n in
                                          jobs_by_slave.values()),
          phase, "not both spawned slaves did jobs: %s" % jobs_by_slave)
    check(results is not None and results.get("Total epochs")
          == JOBS_CLI_EPOCHS - 1, phase, "result file: %s" % results)
    check(len(pids) == 2 and not alive, phase, "spawned slaves %s, still "
          "alive %s" % (pids, alive))


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
        (serve_launches, serve_streams, serve_bytes, serve_blas,
         serve_engine, serve_tokens_per_s) = phase_serve(
             device, info["nvidia_smi"])
        paths = {"serve": serve_launches}
        phase_parity(device)
        paths["serve_int8"], int8_streams = phase_serve_int8(
            device, info["nvidia_smi"], serve_streams, serve_bytes,
            serve_blas)
        phase_serve_int8_parity(device)
        (paths["serve_generate"],
         paths["serve_generate_int8"]) = phase_serve_generate(
             device, info["nvidia_smi"], serve_engine, serve_streams,
             serve_tokens_per_s, int8_streams)
        del serve_engine
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
        paths["mnist_scan"], scan_nodes = phase_mnist_scan(
            device, info["nvidia_smi"])
        phase_mnist_scan_parity(device)
        paths["mnist_ae"] = phase_mnist_ae(device, info["nvidia_smi"])
        phase_mnist_ae_parity(device)
        paths["mnist_fused"] = phase_mnist_fused(device, info["nvidia_smi"])
        phase_mnist_fused_parity(device)
        paths["mnist_fused_bf16"] = phase_mnist_fused_bf16(device)
        paths["mnist_fused_epoch"] = phase_mnist_fused_epoch(device)
        paths.update(phase_mnist_conv(device, info["nvidia_smi"]))
        phase_mnist_conv_parity(device)
        paths.update(phase_alexnet_fused(device, info["nvidia_smi"]))
        paths["serve_batch"], serving_timed = phase_serve_batch(
            device, info["nvidia_smi"])
        paths["ops"] = phase_ops(device)
        paths["tooling"] = phase_tooling(device, info["nvidia_smi"],
                                         scan_nodes)
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            (paths["snapshot"], paths["snapshot_resume"],
             artifact) = phase_snapshot(device, info["nvidia_smi"], tmp)
            paths["snapshot_serve"] = phase_snapshot_serve(
                device, info["nvidia_smi"], artifact)
            paths["checkpoint"] = phase_checkpoint(
                device, info["nvidia_smi"], tmp)
        paths.update(phase_mnist_rnn(device, info["nvidia_smi"]))
        phase_mnist_rnn_parity(device)
        paths["mnist_ae_rbm"] = phase_mnist_ae_rbm(device,
                                                   info["nvidia_smi"])
        paths["kohonen"] = phase_kohonen(device, info["nvidia_smi"])
        paths.update(phase_data_side(device, info["nvidia_smi"]))
        phase_spmd_group(device)
        paths["spmd_train"] = phase_spmd_train(device, info["nvidia_smi"])
        paths["ring"] = phase_ring(device, info["nvidia_smi"])
        phase_moe(device, info["nvidia_smi"])
        paths["fused_dp"] = phase_fused_dp(device, info["nvidia_smi"])
        paths["pod"] = phase_pod(device, info["nvidia_smi"])
        paths["fused_shard"] = phase_fused_shard(device, info["nvidia_smi"])
        paths["serve_tp"] = phase_serve_tp(
            device, info["nvidia_smi"], serve_streams, serve_tokens_per_s)
        paths["jobs"] = phase_jobs(device, info["nvidia_smi"])
        phase_jobs_parity(device)
        paths["jobs_fused"] = phase_jobs_fused(device, info["nvidia_smi"])
        paths["jobs_chaos"] = phase_jobs_chaos(device, info["nvidia_smi"])
        phase_cli(device, info["nvidia_smi"])
    except PhaseFailed as exc:
        print("chip_smoke FAILED in phase %s" % exc, file=sys.stderr)
        return 1
    for entry in timed:
        if entry["name"] in serving_timed:
            entry["serving_buckets"] = serving_timed[entry["name"]]
        # a row whose function rides in another launch counts those
        # launches (gd_db: the dw launches that carried the bias step);
        # the gather rows also give the tables their launches served
        counter = entry.get("counted_as", entry["name"])
        entry["launches_by_path"] = {path: counts[counter]
                                     for path, counts in paths.items()
                                     if counts.get(counter)}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if entry["name"] == "matmul_bf16":
            entry["launches_by_body"] = {
                path: {body: counts[body] for body in (
                    "wgmma", "ldmatrix", "wgmma_split", "ldmatrix_split")
                    if counts.get(body)}
                for path, counts in paths.items()
                if counts.get("wgmma") or counts.get("ldmatrix")}
        if entry["name"] in ("gather", "gather_norm"):
            entry["launches_by_entry"] = {
                path: {name: counts[name] for name in (
                    "veles_gather_group", "veles_gather_served")
                    if counts.get(name)}
                for path, counts in paths.items()
                if counts.get("veles_gather_group")
                or counts.get("veles_gather_served")}
            entry["tables_by_path"] = {
                path: {kind: counts[kind] for kind in (
                    "gather_tables", "gather_norm_tables") if counts[kind]}
                for path, counts in paths.items()
                if counts.get("gather_tables")
                or counts.get("gather_norm_tables")}
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    # gd_db and the gather rows say which launch they ride in (gd_db its
    # carrier's times with and without it, the gather rows their C entry,
    # the launches by entry, the tables served, and gather_norm the
    # head's earlier form of five index ops and the group launch);
    # the GEMM kernels also carry wrapper_ms, the time of one
    # wrapper call; the paged kernel the contiguous kernel's time on the
    # mirrored cache and its verify (5 rows) times; the flash kernels
    # their body, rate, share of their bound, device time per call (the
    # forward also SDPA's, and its numbers at the train step's batch);
    # the decode kernels their split, body, device time on cold operands
    # and its share of the bound (the contiguous one SDPA's device time);
    # qmatmul its prefill layer's device times and its decode layer
    # (device times, plans, body)
    extra = ("entry", "rides_in", "launches_by_entry", "launches_by_body",
             "tables_by_path",
             "parent_head_ms", "group_alone_ms", "without_bias_ms",
             "carrier_ms",
             "wrapper_ms", "contiguous_ms", "verify_ms",
             "verify_contiguous_ms", "verify_plain_ms", "verify_bound_ms",
             "body", "split", "tflops", "bound_share", "device_ms",
             "bound_share_device", "library_device_ms", "contiguous_device_ms",
             "verify_device_ms", "verify_contiguous_device_ms",
             "verify_bound_share_device", "train_shape", "decode_layer",
             "fill_ms", "fill_device_ms", "calls", "serving_buckets")
    emit({"kernels": [{key: entry[key] for key in keys + extra
                       if key in keys or key in entry}
                      for entry in timed]})
    from veles_tpu_torch.parallel import multihost
    multihost.shutdown()
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
