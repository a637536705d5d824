"""Rule V-S01, the generative serving preflight.

The port's counterpart of :mod:`veles_tpu.analyze.shapes`, trimmed to
:func:`check_generative`: the rest of the shape pass (shape and dtype
propagation, the AST hazard scans) and V-P02 wait for ROADMAP item
7(e).  The findings, their severities and their numbers are the JAX
package's; three messages that named TPU things are worded for the
card (the warmed-program count, and the page alignment, twice).
"""

import math

from veles_tpu_torch.analyze import pricing
from veles_tpu_torch.analyze.findings import Finding, Report

RULES = {
    "V-S01": ("error",
              "generative serving preflight: the engine's slot-major "
              "KV cache does not fit device HBM next to the params, "
              "the slot/bucket plan is unservable (bucket beyond "
              "max_seq, max_seq beyond the model's positional table, "
              "zero slots), or the model is not causal — "
              "autoregressive decode over a cache is meaningless "
              "without a causal mask; checked at ModelRegistry"
              ".deploy_generative time"),
}


def _rule(rule_id):
    severity, _desc = RULES[rule_id]
    return severity, rule_id


def check_generative(engine, hbm_bytes=None, mean_seq_len=None):
    """Deploy-time plan check for a :class:`veles_tpu_torch.gen.engine
    .GenerativeEngine` (rule V-S01): pure host arithmetic over the
    engine's declared plan, no kernel, no device work.

    Four failure families, one rule ID:

    - **model shape** — a non-causal model cannot be decoded
      autoregressively against a KV cache (every step would need the
      future it has not generated);
    - **slot/bucket plan** — buckets beyond ``max_seq``, ``max_seq``
      beyond the model's positional table, or zero slots are
      unservable by construction;
    - **paged plan** — a ``block_size`` that is not a multiple of 8
      (the JAX package's decode kernel tiles pages in 8 sublanes; the
      port's kernel takes any page size, and the rule stays as the
      parity gate's alignment) or does not divide ``max_seq`` (the
      bitwise-parity alignment), a pool too small for ONE full
      sequence (deadlock at the first long request), or — warning —
      a pool that cannot hold ``max_slots`` sequences at the
      observed-mix mean length (``mean_seq_len``, default
      ``max_seq / 2``): admission is priced per page, so this plan
      would preempt constantly instead of batching;
    - **KV footprint** — the cache (``num_blocks × block_size`` pages
      in paged mode, ``slots × max_seq`` rows contiguous) + params
      must fit the device's memory (``hbm_bytes`` override for tests;
      else the engine's card, :func:`veles_tpu_torch.analyze.pricing
      .resolve_device_hbm`, and a CPU engine degrades to plan-sanity
      only).  Params are priced from the ACTUAL leaves — an
      int8-quantized deploy (``veles_tpu_torch.quant``) counts one
      byte per weight element plus its float scales, so quantizing is
      the remedy this check's over-budget error can point at
      honestly.

    Returns a :class:`~veles_tpu_torch.analyze.findings.Report`;
    ``ModelRegistry.deploy_generative`` maps its errors through
    ``root.common.serve.preflight``.
    """
    findings = []
    model = getattr(engine, "model", None)
    if model is not None and not getattr(model, "causal", True):
        findings.append(Finding(
            *_rule("V-S01"),
            message="model %s is not causal — autoregressive decode "
                    "over a KV cache requires a causal mask"
                    % type(model).__name__,
            fix="serve this model through the request/response "
                "engine (ModelRegistry.deploy), or make its "
                "attention causal"))
    max_slots = int(getattr(engine, "max_slots", 0) or 0)
    max_seq = int(getattr(engine, "max_seq", 0) or 0)
    buckets = tuple(getattr(engine, "prefill_buckets", ()) or ())
    if max_slots < 1:
        findings.append(Finding(
            *_rule("V-S01"),
            message="max_slots is %d — no KV slot can ever be "
                    "admitted" % max_slots,
            fix="configure at least one slot"))
    if not buckets:
        findings.append(Finding(
            *_rule("V-S01"),
            message="no prefill buckets declared — no prompt length "
                    "is servable",
            fix="declare at least one prefill bucket <= max_seq"))
    elif buckets[-1] > max_seq:
        findings.append(Finding(
            *_rule("V-S01"),
            message="largest prefill bucket %d exceeds max_seq %d — "
                    "its prompts could never decode" % (buckets[-1],
                                                        max_seq),
            fix="drop buckets beyond max_seq (or raise max_seq)"))
    seq_limit = int(getattr(model, "seq_limit", max_seq) or max_seq)
    if max_seq > seq_limit:
        findings.append(Finding(
            *_rule("V-S01"),
            message="max_seq %d exceeds the model's positional table "
                    "%d — decode would index past the trained "
                    "embeddings" % (max_seq, seq_limit),
            fix="cap max_seq at the model's seq_len"))
    if buckets and len(buckets) > 8:
        findings.append(Finding(
            "warning", "V-S01",
            message="%d prefill buckets — every one is a prefill "
                    "shape warmup() runs; a handful of powers of two "
                    "usually covers the prompt distribution"
                    % len(buckets),
            fix="thin the bucket set"))
    chunk = getattr(engine, "prefill_chunk", None)
    if chunk and max_seq % int(chunk):
        findings.append(Finding(
            *_rule("V-S01"),
            message="prefill_chunk %d does not divide max_seq %d — "
                    "the final chunk of a near-max_seq prompt would "
                    "write past the cache" % (int(chunk), max_seq),
            fix="pick prefill_chunk | max_seq"))

    # paged plan: block geometry + pool capacity priced per page
    if getattr(engine, "kv_mode", "contiguous") == "paged":
        block_size = int(getattr(engine, "block_size", 0) or 0)
        num_blocks = int(getattr(engine, "num_blocks", 0) or 0)
        if block_size < 8 or block_size % 8:
            findings.append(Finding(
                *_rule("V-S01"),
                message="block_size %d is not a multiple of 8 — the "
                        "paged gate's page alignment (the card's paged "
                        "decode kernel takes any page size; the JAX "
                        "package's, the parity reference, tiles pages "
                        "in 8 rows)" % block_size,
                fix="use a block_size that is a multiple of 8"))
        elif max_seq % block_size:
            findings.append(Finding(
                *_rule("V-S01"),
                message="max_seq %d is not a multiple of block_size "
                        "%d — the paged gather cannot mirror the "
                        "contiguous cache bitwise (the parity gate's "
                        "alignment)" % (max_seq, block_size),
                fix="pick block_size | max_seq"))
        usable = max(0, num_blocks - 1)      # block 0 is the trash sink
        if block_size > 0 and usable * block_size < max_seq:
            findings.append(Finding(
                *_rule("V-S01"),
                message="pool of %d usable pages (%d tokens) cannot "
                        "hold ONE max_seq=%d sequence — the engine "
                        "would deadlock at its first long request"
                        % (usable, usable * block_size, max_seq),
                fix="grow num_blocks past max_seq / block_size + 1"))
        elif block_size > 0 and max_slots > 0:
            mean_len = float(mean_seq_len or max_seq / 2.0)
            need = max_slots * math.ceil(mean_len / block_size)
            # refcount-aware pricing: a prefix-cached pool serves a
            # shared page ONCE however many slots name it, so the
            # OBSERVED sharing credit counts against the demand (a
            # fresh engine has none and prices worst-case)
            saved = 0
            pool = getattr(engine, "_pool", None)
            if getattr(engine, "prefix_cache", False) \
                    and pool is not None:
                saved = int(pool.pages_saved())
            if usable + saved < need:
                findings.append(Finding(
                    "warning", "V-S01",
                    message="pool of %d usable pages holds fewer than "
                            "%d slots x %.0f-token sequences (%d "
                            "pages at the observed-mix mean%s) — "
                            "admission is priced per page, so this "
                            "plan preempts instead of batching"
                            % (usable, max_slots, mean_len, need,
                               ", %d credited to prefix sharing"
                               % saved if saved else ""),
                    fix="grow num_blocks (or admit fewer slots)"))
        if chunk is None and buckets and buckets[-1] < max_seq:
            findings.append(Finding(
                "warning", "V-S01",
                message="paged pool with whole-prompt prefill and "
                        "largest bucket %d < max_seq %d — a preempted "
                        "sequence's prefix can outgrow every bucket "
                        "and become unservable on requeue"
                        % (buckets[-1], max_seq),
                fix="set root.common.gen.prefill_chunk (chunked "
                    "admission serves any prefix) or bucket up to "
                    "max_seq"))

    # speculative plan: a draft model proposing into a different token
    # space never matches the target's greedy choices
    proposer = getattr(engine, "proposer", None)
    draft = getattr(proposer, "model", None)
    if model is not None and draft is not None \
            and int(getattr(draft, "vocab", 0) or 0) \
            != int(getattr(model, "vocab", 0) or 0):
        findings.append(Finding(
            "warning", "V-S01",
            message="draft model %r vocab %d != target vocab %d — "
                    "proposals index a different token space, so "
                    "speculative acceptance will collapse to zero "
                    "(pure overhead)"
                    % (getattr(engine, "speculative", "?"),
                       int(getattr(draft, "vocab", 0) or 0),
                       int(getattr(model, "vocab", 0) or 0)),
            fix="register a draft model sharing the target's "
                "tokenizer/vocab (or use speculative=\"ngram\")"))

    kv_bytes = int(getattr(engine, "kv_cache_bytes", 0) or 0)
    params_bytes = 0
    try:
        params_bytes = pricing.params_nbytes(
            getattr(engine, "_params", None) or ())
    except Exception:
        pass
    hbm_bytes = pricing.resolve_device_hbm(hbm_bytes,
                                           getattr(engine, "device", None))
    if hbm_bytes:
        budget = pricing.hbm_budget(hbm_bytes)
        if kv_bytes + params_bytes > budget:
            findings.append(Finding(
                *_rule("V-S01"),
                message="KV cache %.2f GiB + params %.2f GiB exceed "
                        "90%% of device HBM (%.1f GiB) — admission "
                        "would OOM at the first full batch"
                        % (kv_bytes / 2 ** 30, params_bytes / 2 ** 30,
                           hbm_bytes / 2 ** 30),
                fix="shrink max_slots/max_seq, shard the cache over "
                    "more devices (mesh model axis), or serve a "
                    "smaller model"))
        elif kv_bytes > 0.5 * float(hbm_bytes):
            findings.append(Finding(
                "warning", "V-S01",
                message="KV cache %.2f GiB is over half of device HBM "
                        "(%.1f GiB) — params + activations share the "
                        "rest" % (kv_bytes / 2 ** 30,
                                  hbm_bytes / 2 ** 30),
                fix="consider fewer slots or a shorter max_seq"))
    return Report(findings, passes=["generative"])
