"""GenerativeEngine: prefill buckets (or one chunk shape) + ONE decode
step over a device-resident KV cache, contiguous or paged.

Counterpart of :mod:`veles_tpu.gen.engine`.  The KV cache is either
slot-major (``{"k", "v"}: [layers, slots, max_seq, heads, head_dim]``)
or, with ``kv="paged"``, the shared block pool of
:mod:`veles_tpu_torch.gen.paged` (``[layers, num_blocks, block_size,
heads, head_dim]`` plus per-slot block tables uploaded with every
step); either is held in the HBM ledger's ``kv`` category.
``prefill_chunk=C`` replaces the whole-prompt bucket prefills with one
chunk shape fed at the decode cadence; ``prefix_cache="on"`` (paged
only) shares full prompt pages through the radix tree of
:mod:`veles_tpu_torch.gen.prefix`; ``speculative="ngram"`` (or the name
of a registered draft model) scores up to ``draft_k`` drafted tokens a
slot in one verify call, accepting exactly what plain greedy decode
would have emitted.  Pool exhaustion raises
:class:`~veles_tpu_torch.gen.paged.PoolExhausted`; the scheduler answers
with youngest-first preemption, which is lossless.

The JAX engine compiles one program per shape ahead of time; PyTorch
runs eagerly, so :meth:`warmup` instead builds the CUDA kernels and runs
each entry point once.  Not ported here, each raising
``NotImplementedError`` naming its ROADMAP item: the fleet page handoff
(``warm_handoff``, ``export_slot``, ``adopt_sequence``: item 7(e), behind
the job protocol).  int8 weights (W8A16) come in as a quantized params
tree or through :meth:`GenerativeEngine.quantize_int8` before warmup, and
every entry point serves them through the qmatmul kernel.

``mesh``: a :class:`~veles_tpu_torch.parallel.mesh.Mesh` whose ``model``
axis is wider than 1 makes this rank's engine a model shard
(:meth:`TransformerGenModel.shard`): its heads of the params and of the
KV cache or block pool, the attention kernels on the local heads, the
``wo`` / ``w2`` partials all-reduced over the axis; every rank of the
axis serves the same requests in lockstep.  A mesh without such an axis
is the single-device path.  An axis that does not divide the heads, and
int8 params with a mesh, raise ``ValueError``, as in the JAX package.

Each program has a performance-ledger entry (:mod:`veles_tpu_torch.prof`):
``prefill`` entries for every prefill bucket (``p<bucket>``) and the
chunk (``chunk<C>``), ``decode`` entries for the decode step and the
verify (``verify<K>``).  The steps run eagerly, so a step's cost is
what its kernel wrappers tallied (:mod:`veles_tpu_torch.ops.cost`): a
program's first served step registers its entry (its compile; there
is nothing to recompile), and each served step dispatches its own
tally, timed on the device.  ``items`` count tokens: the prompt tokens
a prefill or chunk processed (as in the JAX package) and the tokens a
decode or verify step emitted.  Each entry is judged against the rate
its products run at: f32 engines the f32 rate, bf16 ones the bf16
rate, and quantized ones ``"int8"``, which the peak table maps to the
bf16 rate their tensor-core qmatmul runs at.
"""

import bisect
import itertools

import numpy
import torch

from veles_tpu_torch import prof, quant, trace
from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.config import root
from veles_tpu_torch.gen.model import params_from_numpy
from veles_tpu_torch.gen.paged import BlockPool
from veles_tpu_torch.gen.prefix import PrefixCache
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.memory import Watcher
from veles_tpu_torch.obs import context as obs_context
from veles_tpu_torch.ops import cost
from veles_tpu_torch.ops.attention import flash_attention
from veles_tpu_torch.samples.transformer import _not_ported


#: per-process engine sequence for performance-ledger entry names
_GEN_SEQ = itertools.count()


def _round_up(x, mult):
    return (x + mult - 1) // mult * mult


def _power_of_two_buckets(lo, hi):
    buckets, b = [], lo
    while b < hi:
        buckets.append(b)
        b *= 2
    buckets.append(hi)
    return tuple(buckets)


#: registry of small draft models for model-based speculation:
#: ``speculative=<name>`` selects an entry
DRAFT_MODELS = {}


def register_draft_model(name, model, params=None):
    """Register a small generative model as a speculative-decode
    proposer.  ``params`` (host tree) defaults to
    ``model.init_params(seed=0)`` at engine construction.  Returns
    ``model`` (chainable)."""
    DRAFT_MODELS[str(name)] = (model, params)
    return model


class NGramProposer(object):
    """Prompt-lookup drafting (training-free): propose the ``k`` tokens
    that FOLLOWED the most recent earlier occurrence of the stream's
    longest matching suffix n-gram.  Pure host work and deterministic.
    A bad proposal costs only speed: the target verifies every draft, so
    the output stream is plain greedy decode's."""

    name = "ngram"

    def __init__(self, max_ngram=3, min_ngram=1):
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, stream, k):
        toks = [int(t) for t in stream]
        n = len(toks)
        for g in range(min(self.max_ngram, n - 1),
                       self.min_ngram - 1, -1):
            suffix = toks[n - g:]
            for start in range(n - g - 1, -1, -1):
                if toks[start:start + g] == suffix:
                    # copy forward through the VIRTUAL stream (the draft
                    # extends it), so an overlapping match near the end
                    # still yields k tokens
                    cont, p = [], start + g
                    for _ in range(int(k)):
                        cont.append(toks[p] if p < n else cont[p - n])
                        p += 1
                    return cont
        return []


class DraftModelProposer(object):
    """Model-based drafting: ``k`` sequential greedy steps of a
    REGISTERED small model over a fixed recent-token window, without a
    cache, so drafting is stateless and preemption can never
    desynchronise a draft cache.  Draft quality only affects tokens per
    dispatch; the target's verify owns correctness."""

    def __init__(self, name, model, params):
        self.name = str(name)
        self.model = model
        #: draft context window, bounded so the draft forward stays cheap
        #: next to the target verify it feeds
        self.window = int(min(32, model.seq_limit))
        if params is None:
            params = model.init_params(seed=0)
        self.params = model.serving_params(
            params_from_numpy(params, model.device))

    def _next(self, tokens, length):
        model = self.model
        h = (self.params["embed"][tokens]
             + self.params["pos"][:self.window])

        def kv_hook(kc, vc, q, k, v):
            return flash_attention(q, k, v, True)

        h = model._run_layers(self.params, None, h, kv_hook)
        return model._greedy_at(self.params, h, length - 1)

    def propose(self, stream, k):
        toks = [int(t) for t in stream]
        out = []
        with torch.inference_mode():
            for _ in range(int(k)):
                win = toks[-self.window:]
                padded = numpy.zeros((1, self.window), numpy.int64)
                padded[0, :len(win)] = win
                tok = int(self._next(
                    torch.from_numpy(padded).to(self.model.device),
                    len(win)))
                out.append(tok)
                toks.append(tok)
        return out


class GenerativeEngine(Logger):
    """Slot-based generative inference over a protocol model
    (:mod:`veles_tpu_torch.gen.model`).

    Host-side slot bookkeeping (lengths, last tokens, free list, the
    block pool) lives here; the scheduler
    (:mod:`veles_tpu_torch.gen.scheduler`) decides WHEN to admit, evict
    and preempt.  Greedy sampling happens on the device: tokens come back
    as integers, never logits, so the parity gates are bitwise token
    comparisons.  ``device`` defaults to ``cuda`` (raising without a
    card) and must be the model's.
    """

    def __init__(self, model, params=None, *, max_slots=4, max_seq=None,
                 prefill_buckets=None, mesh=None, eos_id=None, seed=0,
                 kv=None, block_size=None, num_blocks=None,
                 prefill_chunk=None, prefix_cache=None, speculative=None,
                 draft_k=None, device=None, **kwargs):
        super(GenerativeEngine, self).__init__(**kwargs)
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError("engine device %s differs from the model's "
                             "%s" % (self.device, model.device))
        self.model = model
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_seq = int(max_seq or model.seq_limit)
        if self.max_seq < 2 or self.max_seq > model.seq_limit:
            raise ValueError(
                "max_seq %d out of range (2..%d, the model's "
                "positional table)" % (self.max_seq, model.seq_limit))
        # a mesh without a >1 model axis IS the single-device path
        self.mesh = mesh if (mesh is not None and
                             mesh.shape.get("model", 1) > 1) else None
        if self.mesh is not None and \
                model.heads % self.mesh.shape["model"]:
            raise ValueError("model axis %d does not divide %d heads"
                             % (self.mesh.shape["model"], model.heads))

        gen_cfg = root.common.gen
        self.kv_mode = str(kv or gen_cfg.get("kv", "contiguous"))
        if self.kv_mode not in ("contiguous", "paged"):
            raise ValueError("root.common.gen.kv must be 'contiguous' or "
                             "'paged', got %r" % self.kv_mode)
        chunk = prefill_chunk if prefill_chunk is not None \
            else gen_cfg.get("prefill_chunk", None)
        self.prefill_chunk = int(chunk) if chunk else None
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        pc = prefix_cache if prefix_cache is not None \
            else gen_cfg.get("prefix_cache", "off")
        if pc in (True, "on"):
            self.prefix_cache = True
        elif pc in (False, None, "off"):
            self.prefix_cache = False
        else:
            raise ValueError("root.common.gen.prefix_cache must be 'on' or "
                             "'off', got %r" % (pc,))
        if self.prefix_cache and self.kv_mode != "paged":
            raise ValueError("prefix_cache requires kv='paged': the "
                             "contiguous engine has no shareable pages")
        spec = speculative if speculative is not None \
            else gen_cfg.get("speculative", "off")
        self.speculative = None if spec in (False, None, "off") \
            else str(spec)
        dk = draft_k if draft_k is not None else gen_cfg.get("draft_k", 4)
        self.draft_k = int(dk)
        if self.speculative is not None and not 1 <= self.draft_k <= 7:
            raise ValueError("draft_k must be 1..7 (the K+1 verify query "
                             "rows the kernel takes), got %d"
                             % self.draft_k)

        self._pool = None
        self.block_size = None
        self.num_blocks = None
        if self.kv_mode == "paged":
            self.block_size = int(block_size
                                  or gen_cfg.get("block_size", 16))
            if self.block_size < 1:
                raise ValueError("block_size must be >= 1")
            if self.max_seq % self.block_size:
                # the gathered [max_blocks*BS] view must equal the
                # contiguous [max_seq] layout exactly, or paged ==
                # contiguous stops being bitwise
                raise ValueError(
                    "max_seq %d is not a multiple of block_size %d: the "
                    "paged read could not mirror the contiguous cache "
                    "bitwise" % (self.max_seq, self.block_size))
            max_blocks = self.max_seq // self.block_size
            self.num_blocks = int(num_blocks
                                  or gen_cfg.get("num_blocks", None)
                                  or self.max_slots * max_blocks + 1)
            self._pool = BlockPool(self.max_slots, max_blocks,
                                   self.num_blocks, self.block_size)
            if self.prefill_chunk is not None:
                self.prefill_chunk = _round_up(self.prefill_chunk,
                                               self.block_size)
        self._prefix = PrefixCache(self._pool) if self.prefix_cache \
            else None
        if self.prefill_chunk is not None \
                and self.max_seq % self.prefill_chunk:
            # the final chunk of a near-max_seq prompt pads to a whole
            # chunk; a non-divisor would write it past the cache
            raise ValueError("prefill_chunk %d must divide max_seq %d"
                             % (self.prefill_chunk, self.max_seq))

        buckets = tuple(sorted(set(
            int(b) for b in (prefill_buckets
                             or _power_of_two_buckets(
                                 min(8, self.max_seq), self.max_seq)))))
        if self._pool is not None:
            # bucket shapes scatter whole pages: round each up to the
            # page size (the padded tail routes to the trash block)
            buckets = tuple(sorted(set(
                _round_up(b, self.block_size) for b in buckets)))
        if buckets[0] < 1 or buckets[-1] > self.max_seq:
            raise ValueError("prefill buckets %s must lie in 1..max_seq=%d"
                             % (buckets, self.max_seq))
        self.prefill_buckets = buckets
        self.eos_id = None if eos_id is None else int(eos_id)

        if params is None:
            params = model.init_params(seed=seed)
        #: "int8" when the params tree carries quantized pairs (given to
        #: the constructor or made by quantize_int8()); None = float
        self.quantized = "int8" if quant.tree_is_quantized(params) \
            else None
        if self.quantized and self.mesh is not None:
            raise ValueError(
                "int8-quantized params cannot shard over a model-axis mesh "
                "yet - serve the quantized deploy replicated (or keep the "
                "TP deploy float)")
        if self.mesh is not None:
            # this rank's model shard: its heads of everything
            model = model.shard(self.mesh.index("model"),
                                self.mesh.shape["model"],
                                self.mesh.group("model"))
            self.model = model
            params = model.shard_params(params)
        #: the float params as given (held by reference until warmup()
        #: or quantize_int8()): quantize_int8() quantizes these, as the
        #: JAX engine quantizes its float32 masters, and not the served
        #: tree, whose block weights are rounded to a bf16 compute_dtype
        self._masters = None if self.quantized else params
        if not isinstance(_first_leaf(params), torch.Tensor):
            params = params_from_numpy(params, self.device)
        self._params = model.serving_params(params)
        if self._pool is not None:
            self._cache = model.init_paged_cache(self.num_blocks,
                                                 self.block_size)
            self.kv_cache_bytes = model.paged_cache_nbytes(
                self.num_blocks, self.block_size)
        else:
            self._cache = model.init_cache(self.max_slots, self.max_seq)
            self.kv_cache_bytes = model.cache_nbytes(self.max_slots,
                                                     self.max_seq)
        Watcher.track(self.kv_cache_bytes, "kv")
        self._kv_tracked = True
        self.params_nbytes = quant.tree_nbytes(self._params)
        Watcher.track(self.params_nbytes, "params")
        self._params_tracked = True
        self._ledger_gen = Watcher.generation
        #: performance-ledger identity and entries by (kind, program)
        self.prof_name = "gen%d" % next(_GEN_SEQ)
        self._prof_entries = {}

        self.slot_len = numpy.zeros(self.max_slots, numpy.int32)
        self.slot_token = numpy.zeros(self.max_slots, numpy.int32)
        self.slot_active = numpy.zeros(self.max_slots, bool)
        self._free = list(range(self.max_slots))
        #: slot -> in-flight chunked-prefill state
        self._chunking = {}
        #: slot -> its occupant's distributed-trace id (None untraced),
        #: stamped at admission from the ambient obs context, so the
        #: shared decode span names the requests each step served
        self.slot_trace = [None] * self.max_slots

        #: the speculative proposer (None = plain decode): n-gram prompt
        #: lookup, or a registered small draft model
        self.proposer = None
        if self.speculative == "ngram":
            self.proposer = NGramProposer()
        elif self.speculative is not None:
            entry = DRAFT_MODELS.get(self.speculative)
            if entry is None:
                raise ValueError(
                    "speculative=%r names no registered draft model (see "
                    "register_draft_model) and is not 'ngram'"
                    % self.speculative)
            draft_model, draft_params = entry
            if draft_model.device != self.device:
                raise ValueError("draft model %r lies on %s, the engine "
                                 "on %s" % (self.speculative,
                                            draft_model.device, self.device))
            if int(draft_model.vocab) != int(model.vocab):
                self.warning(
                    "draft model %r vocab %d != target vocab %d: "
                    "proposals index another token space, so acceptance "
                    "will collapse to zero", self.speculative,
                    draft_model.vocab, model.vocab)
            self.proposer = DraftModelProposer(self.speculative,
                                               draft_model, draft_params)

        self.decode_calls = 0
        self.prefill_calls = 0
        self.preemptions_total = 0
        # prefix-cache admission accounting (hit rate = shared / total)
        self.prefix_pages_total = 0
        self.prefix_shared_pages_total = 0
        # speculative-decode accounting
        self.spec_dispatches = 0
        self.spec_drafted_total = 0
        self.spec_accepted_total = 0
        self.spec_tokens_total = 0
        self._warmed = False

    # -- host -> device ------------------------------------------------------
    def _put(self, array, dtype=torch.long):
        """One host array on the engine's device (counted in
        ``Watcher``'s host→device traffic on the card)."""
        tensor = torch.from_numpy(numpy.ascontiguousarray(array)).to(dtype)
        if self.device.type == "cuda":
            Watcher.track_h2d(tensor.numel() * tensor.element_size())
        return tensor.to(self.device)

    # -- int8 deploy -------------------------------------------------------
    def quantize_int8(self, calibration_tokens=None, tol=None):
        """Quantize the served block weights in place (per-output-channel
        symmetric int8, :func:`veles_tpu_torch.quant.quantize_gen_params`)
        and re-price ``params_nbytes`` and the ledger's params hold.
        Must run BEFORE :meth:`warmup` and any served step, as in the JAX
        package, whose programs compile once against the tree.  The walk
        starts from the float params given to the constructor (or its
        seeded ones), not from the served tree, so at a bf16
        ``compute_dtype`` the int8 weights are the JAX engine's, made
        from float32 masters.  ``calibration_tokens`` arms the drift gate:
        relative logit drift beyond ``tol`` (default
        :data:`veles_tpu_torch.quant.DRIFT_TOL`) raises a typed
        :class:`~veles_tpu_torch.quant.QuantizationError` naming the worst
        block weight.  Returns self (chainable)."""
        if self._warmed or self.prefill_calls or self.decode_calls:
            raise RuntimeError(
                "quantize_int8 must run before warmup() and any served "
                "step: the JAX package would recompile every program in "
                "steady state")
        if self.mesh is not None:
            raise ValueError(
                "int8-quantized params cannot shard over a model-axis mesh "
                "yet - serve the quantized deploy replicated")
        if self.quantized:
            return self
        qparams = quant.quantize_gen_params(
            self.model, self._masters, calibration_tokens=calibration_tokens,
            tol=quant.DRIFT_TOL if tol is None else tol)
        self._params = self.model.serving_params(
            params_from_numpy(qparams, self.device))
        self.quantized = "int8"
        self._masters = None
        if self._params_tracked and self._ledger_gen == Watcher.generation:
            Watcher.untrack(self.params_nbytes, "params")
        self.params_nbytes = quant.tree_nbytes(self._params)
        Watcher.track(self.params_nbytes, "params")
        self._params_tracked = True
        self._ledger_gen = Watcher.generation
        self.info("quantized params to int8 (%d bytes resident)",
                  self.params_nbytes)
        return self

    # -- warmup ------------------------------------------------------------
    def warmup(self):
        """Build the CUDA kernels (on the card) and run each entry point
        the engine serves from once, so the first request pays no build
        or library set-up: one chunk (chunked) or every prefill bucket,
        a decode step, and a verify when speculation is on.  The runs
        occupy no slot: their K/V land in the trash block (paged) or
        beyond every length a later read sees (contiguous).  Returns
        self (chainable)."""
        if self.device.type == "cuda":
            from veles_tpu_torch.ops import build
            build.build_all()
        model, params, cache = self.model, self._params, self._cache
        slots = self.max_slots
        pool = self._pool
        with torch.inference_mode():
            if self.prefill_chunk is not None:
                tokens = self._put(numpy.zeros((1, self.prefill_chunk)))
                if pool is not None:
                    model.paged_prefill_chunk(
                        params, cache, tokens,
                        self._put(numpy.zeros(
                            self.prefill_chunk // self.block_size)),
                        self._put(numpy.zeros(pool.max_blocks)), 0, 1)
                else:
                    model.prefill_chunk(params, cache, tokens, 0, 0, 1)
            else:
                for bucket in self.prefill_buckets:
                    tokens = self._put(numpy.zeros((1, bucket)))
                    if pool is not None:
                        model.paged_prefill(
                            params, cache, tokens, self._put(
                                numpy.zeros(bucket // self.block_size)), 1)
                    else:
                        model.prefill(params, cache, tokens, 0, 1)
            zeros = numpy.zeros(slots)
            idle = self._put(numpy.zeros(slots, bool), torch.bool)
            if pool is not None:
                model.paged_decode(params, cache, self._put(pool.tables,
                                                            torch.int32),
                                   self._put(zeros), self._put(zeros), idle)
            else:
                model.decode(params, cache, self._put(zeros),
                             self._put(zeros), idle)
            if self.proposer is not None:
                grid = self._put(numpy.zeros((slots, self.draft_k + 1)))
                if pool is not None:
                    model.paged_verify(params, cache,
                                       self._put(pool.tables, torch.int32),
                                       grid, self._put(zeros),
                                       self._put(zeros), idle)
                else:
                    model.verify(params, cache, grid, self._put(zeros),
                                 self._put(zeros), idle)
                if isinstance(self.proposer, DraftModelProposer):
                    self.proposer.propose([0], 1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed = True
        self._masters = None
        return self

    def _account(self, kind, name, tally, timer, items):
        """One served step of program ``name`` in the ledger: its entry
        registered (the compile) at the program's first step, then the
        step dispatched with its own tally, its ``timer`` and ``items``
        tokens."""
        entry = self._prof_entries.get((kind, name))
        if entry is None:
            entry = self._prof_entries[(kind, name)] = prof.ledger.entry(
                kind, "%s[%s]" % (self.prof_name, name), self.device.type)
            if self.model.compute_dtype == torch.float32:
                entry.peak_dtype = "float32"
            else:
                entry.peak_dtype = self.quantized or "bfloat16"
            step_cost, args = prof.span_cost_args(
                tally.cost(), {"program": name, "engine": self.prof_name},
                peak_dtype=entry.peak_dtype)
            prof.ledger.record_compile(entry, cost=step_cost)
            trace.instant("serve", "compile_gen", args, role="server")
        prof.ledger.record_dispatch(entry, timer, items=items,
                                    cost=tally.cost())

    def warm_handoff(self):
        _not_ported("the fleet page handoff (warm_handoff)", "7(e)")

    # -- slot accounting ---------------------------------------------------
    def bucket_for(self, n):
        for b in self.prefill_buckets:
            if b >= n:
                return b
        raise ValueError(
            "prompt of %d tokens exceeds the largest prefill bucket "
            "%d" % (n, self.prefill_buckets[-1]))

    @property
    def free_slots(self):
        return len(self._free)

    def active_slots(self):
        return int(self.slot_active.sum())

    def prefilling_slots(self):
        return len(self._chunking)

    def occupancy(self):
        """Occupied slots (decoding or mid chunked prefill) over
        ``max_slots``: host counters only, so a ``/metrics`` scrape
        never waits on the card."""
        return (self.active_slots() + len(self._chunking)) \
            / float(self.max_slots)

    def _validate_prompt_len(self, n):
        """The two guards every admission path shares."""
        n = int(n)
        if n < 1:
            raise ValueError("empty prompt")
        if n >= self.max_seq:
            raise ValueError(
                "prompt of %d tokens leaves no room to generate "
                "(max_seq %d)" % (n, self.max_seq))
        return n

    def check_prompt(self, n):
        """Raise ``ValueError`` when a prompt of ``n`` tokens can never
        be admitted: the scheduler's door check, in every kv and prefill
        mode."""
        n = self._validate_prompt_len(n)
        if self._pool is not None and \
                self._pool.blocks_for(n) > self._pool.blocks_total:
            raise ValueError(
                "prompt of %d tokens needs %d pages but the pool has %d"
                % (n, self._pool.blocks_for(n), self._pool.blocks_total))
        if self.prefill_chunk is None:
            self.bucket_for(n)          # raises when over the buckets

    def _appends_needed(self):
        """Pages the CURRENT residents' next decode step will claim
        (slots whose write position sits on a page boundary)."""
        if self._pool is None:
            return 0
        return sum(
            1 for slot in range(self.max_slots)
            if self.slot_active[slot]
            and self.slot_len[slot] < self.max_seq
            and self._pool.needs_append(slot, int(self.slot_len[slot])))

    def _prefix_tag(self, n):
        """Identity tag of the shape that wrote a prefix-cache page:
        pages are shared only between prefills of the same shape, whose
        reductions round alike.  Chunked engines have one chunk shape;
        whole-bucket engines tag by bucket."""
        if self.prefill_chunk is not None:
            return "chunk%d" % self.prefill_chunk
        return "b%d" % self.bucket_for(n)

    def _shared_usable(self, bids):
        """Matched prefix pages an admission may adopt: chunked prefill
        skips WHOLE chunks, so the adopted span rounds down to a chunk
        boundary (whole-bucket mode adopts every matched page; its
        prefill recomputes them and routes their writes to trash)."""
        if self.prefill_chunk is not None:
            per = self.prefill_chunk // self.block_size
            return bids[:len(bids) // per * per]
        return bids

    def can_admit(self, n, tokens=None):
        """True when a prompt (or preempted prefix) of ``n`` tokens is
        admissible now: a free slot and, paged, the pool holding its
        pages ON TOP of the pages the residents' next decode step claims
        (without that reservation a tight pool would admit, preempt the
        newcomer and re-admit it once per resident token).  With the
        prefix cache on, ``tokens`` prices only the unshared suffix and
        counts cache-only pages the LRU reclaimer would evict as
        headroom."""
        if not self._free:
            return False
        if self._pool is None:
            return True
        n = int(n)
        need = self._pool.blocks_for(n)
        reclaimable = 0
        if self._prefix is not None:
            reclaimable = self._prefix.reclaimable()
            if tokens is not None:
                bids = self._shared_usable(
                    self._prefix.match(tokens, self._prefix_tag(n)))
                need -= len(bids)
                # matched pages are adopted, not evicted
                reclaimable -= sum(1 for bid in bids
                                   if self._pool.refcount(bid) == 1)
                reclaimable = max(0, reclaimable)
        if n % self.block_size == 0:
            # a prefix filling its pages exactly appends a fresh page on
            # its FIRST decode step: price it now
            need += 1
        return (need + self._appends_needed()
                <= self._pool.blocks_free + reclaimable)

    def release_slot(self, slot):
        if slot in self._chunking:
            # a chunked prefill abandoned mid-flight (stop or preemption)
            del self._chunking[slot]
        elif not self.slot_active[slot]:
            raise ValueError("slot %d is not active" % slot)
        self.slot_active[slot] = False
        self.slot_len[slot] = 0
        self.slot_trace[slot] = None
        if self._pool is not None:
            self._pool.release(slot)
        # deterministic admission: the free list stays sorted
        bisect.insort(self._free, slot)

    def preempt(self, slot):
        """Pool-exhaustion eviction: free the slot AND its pages without
        finishing the request; the scheduler requeues its tokens so far
        and greedy decode reproduces the stream (lossless)."""
        if not self.slot_active[slot] and slot not in self._chunking:
            raise ValueError("slot %d is not occupied" % slot)
        self.release_slot(slot)
        self.preemptions_total += 1

    def decode_block_deficit(self):
        """Pages the NEXT decode step needs beyond the free list; the
        scheduler preempts until this is 0.  Always 0 in contiguous
        mode."""
        if self._pool is None:
            return 0
        return max(0, self._appends_needed() - self._pool.blocks_free)

    # -- serving -----------------------------------------------------------
    def _claim(self, tokens, n):
        """Pop the lowest free slot and, paged, allocate the prompt's
        pages (prefix-cache hits adopted by reference).  Returns
        ``(slot, shared, tag, ids)``; on a failed allocation the slot
        goes back and the error propagates."""
        if not self._free:
            raise RuntimeError("no free slot (all %d busy)"
                               % self.max_slots)
        slot = self._free.pop(0)
        shared, tag, ids = [], None, []
        if self._pool is not None:
            if self._prefix is not None:
                tag = self._prefix_tag(n)
                shared = self._shared_usable(self._prefix.match(tokens,
                                                                tag))
            try:
                ids = self._pool.admit(slot, n, shared=shared)
            except Exception:
                bisect.insort(self._free, slot)
                raise
            if self._prefix is not None:
                self.prefix_pages_total += len(ids)
                self.prefix_shared_pages_total += len(shared)
        return slot, shared, tag, ids

    def _register_prefix(self, slot, tokens, n, tag):
        """Register every FULL prompt page now that its K/V is resident
        (full pages are immutable: decode writes start at position n)."""
        if self._prefix is None:
            return
        m = n // self.block_size
        if m:
            self._prefix.insert(tokens[:m * self.block_size],
                                self._pool.owned(slot)[:m], tag)

    def prefill(self, tokens):
        """Admit one prompt into a free slot with ONE whole-bucket
        prefill: returns ``(slot, first_token)``.  Raises
        ``RuntimeError`` when no slot is free,
        :class:`~veles_tpu_torch.gen.paged.PoolExhausted` when the pool
        cannot hold the prompt's pages and ``ValueError`` on an
        unservable prompt."""
        tokens = numpy.ascontiguousarray(tokens, numpy.int32).ravel()
        n = self._validate_prompt_len(len(tokens))
        bucket = self.bucket_for(n)
        slot, shared, tag, ids = self._claim(tokens, n)
        padded = numpy.zeros((1, bucket), numpy.int32)
        padded[0, :n] = tokens
        self.prefill_calls += 1
        self.slot_trace[slot] = obs_context.current_trace_id()
        with trace.span("gen", "prefill",
                        obs_context.tag({"bucket": bucket, "slot": slot,
                                         "len": n}),
                        role="server"), torch.inference_mode(), \
                cost.Tally() as tally, \
                prof.DispatchTimer(self.device) as timer:
            if self._pool is not None:
                block_ids = numpy.zeros(bucket // self.block_size,
                                        numpy.int32)
                block_ids[:len(ids)] = ids
                # never rewrite a shared page (a co-resident reads it);
                # this call's attention reads the bucket itself, so the
                # token is unchanged
                block_ids[:len(shared)] = self._pool.TRASH
                _cache, tok = self.model.paged_prefill(
                    self._params, self._cache, self._put(padded),
                    self._put(block_ids), n)
            else:
                _cache, tok = self.model.prefill(
                    self._params, self._cache, self._put(padded), slot, n)
            tok = int(tok)
        self._account("prefill", "p%d" % bucket, tally, timer, n)
        self.slot_len[slot] = n
        self.slot_token[slot] = tok
        self.slot_active[slot] = True
        self._register_prefix(slot, tokens, n, tag)
        return slot, tok

    def admit(self, tokens):
        """The admission door the scheduler calls: whole-prompt engines
        prefill in one call and return ``(slot, first_token)``; chunked
        engines claim the slot (and, paged, ALL the prompt's pages) and
        return ``(slot, None)``, and the scheduler then pumps
        :meth:`prefill_step` once a step until the first token comes."""
        if self.prefill_chunk is None:
            return self.prefill(tokens)
        tokens = numpy.ascontiguousarray(tokens, numpy.int32).ravel()
        n = self._validate_prompt_len(len(tokens))
        slot, shared, tag, _ids = self._claim(tokens, n)
        # chunked prefill SKIPS the shared prefix outright: chunks begin
        # at the first unshared page, a chunk boundary
        start0 = len(shared) * self.block_size if shared else 0
        chunk = self.prefill_chunk
        padded = numpy.zeros(start0 + _round_up(n - start0, chunk),
                             numpy.int32)
        padded[:n] = tokens
        self._chunking[slot] = {"tokens": padded, "n": n, "done": start0,
                                "tag": tag}
        self.slot_trace[slot] = obs_context.current_trace_id()
        return slot, None

    def prefill_step(self, slot):
        """Feed ONE chunk of the slot's pending prompt.  Returns the
        first generated token when the prompt completes, else
        ``None``."""
        state = self._chunking[slot]
        chunk = self.prefill_chunk
        start = state["done"]
        chunk_len = min(chunk, state["n"] - start)
        tokens = state["tokens"][None, start:start + chunk]
        self.prefill_calls += 1
        with trace.span("gen", "prefill_chunk",
                        obs_context.tag({"slot": slot, "start": start,
                                         "len": chunk_len}),
                        role="server"), torch.inference_mode(), \
                cost.Tally() as tally, \
                prof.DispatchTimer(self.device) as timer:
            if self._pool is not None:
                first = start // self.block_size
                chunk_ids = self._pool.tables[
                    slot, first:first + chunk // self.block_size]
                _cache, tok = self.model.paged_prefill_chunk(
                    self._params, self._cache, self._put(tokens),
                    self._put(chunk_ids), self._put(self._pool.tables[slot]),
                    start, chunk_len)
            else:
                _cache, tok = self.model.prefill_chunk(
                    self._params, self._cache, self._put(tokens), slot,
                    start, chunk_len)
        self._account("prefill", "chunk%d" % chunk, tally, timer,
                      chunk_len)
        state["done"] = start + chunk_len
        if state["done"] < state["n"]:
            return None
        del self._chunking[slot]
        tok = int(tok)
        n = state["n"]
        self.slot_len[slot] = n
        self.slot_token[slot] = tok
        self.slot_active[slot] = True
        self._register_prefix(slot, state["tokens"], n, state["tag"])
        return tok

    def decode_step(self):
        """ONE decode iteration over every slot.  Returns ``(tokens,
        active)`` host arrays (``tokens[slot]`` meaningful only where
        ``active[slot]``) or ``None`` when nothing can decode.  Slots
        parked at ``max_seq`` are excluded; the scheduler finishes them.
        Paged, the host half of the fused page append runs first
        (raising ``PoolExhausted`` on direct use; the scheduler preempts
        before, through :meth:`decode_block_deficit`)."""
        active = self.slot_active & (self.slot_len < self.max_seq)
        if not active.any():
            return None
        if self._pool is not None:
            for slot in numpy.nonzero(active)[0]:
                self._pool.append(int(slot), int(self.slot_len[slot]))
        positions = numpy.where(active, self.slot_len, 0)
        toks = numpy.where(active, self.slot_token, 0)
        self.decode_calls += 1
        decode_args = {"active": int(active.sum())}
        if trace.enabled():
            # which requests this shared step decoded: the decode half
            # of every co-resident's waterfall, one span
            traces = sorted({t for s, t in enumerate(self.slot_trace)
                             if t is not None and active[s]})
            if traces:
                decode_args["traces"] = traces
        with trace.span("gen", "decode", decode_args,
                        role="server"), torch.inference_mode(), \
                cost.Tally() as tally, \
                prof.DispatchTimer(self.device) as timer:
            args = (self._put(toks), self._put(positions),
                    self._put(active, torch.bool))
            if self._pool is not None:
                _cache, out = self.model.paged_decode(
                    self._params, self._cache,
                    self._put(self._pool.tables, torch.int32), *args)
            else:
                _cache, out = self.model.decode(self._params, self._cache,
                                                *args)
            out = out.cpu().numpy().astype(numpy.int32)
        self._account("decode", "decode", tally, timer, int(active.sum()))
        self.slot_len[active] += 1
        self.slot_token[active] = out[active]
        return out, active

    # -- speculative decode (draft K, verify in one call) ------------------
    def propose(self, stream):
        """Draft up to ``draft_k`` continuation tokens for one slot's
        whole stream (prompt + generated, the last element the slot's
        pending token).  Empty: the slot decodes plainly this round."""
        if self.proposer is None:
            return []
        return list(self.proposer.propose(stream, self.draft_k))[
            :self.draft_k]

    def spec_decode_step(self, proposals):
        """ONE draft-then-verify iteration over every decoding slot:
        ``proposals`` maps slot -> drafted tokens (at most ``draft_k``;
        missing or empty entries decode plainly).  Every slot verifies in
        one call; greedy acceptance emits, per slot, the drafted prefix
        that matched the target's own greedy choices plus the target's
        first divergent token, ``a + 1`` tokens that are plain decode's
        stream.  Returns ``{slot: [tokens...]}`` or ``None`` when nothing
        decodes.  Draft spans shrink per slot against ``max_seq`` and
        the pool's headroom after the residents' plain-decode appends,
        so speculation never preempts where plain decode would not."""
        if self.proposer is None:
            raise RuntimeError("speculative decode is off "
                               "(root.common.gen.speculative)")
        active = self.slot_active & (self.slot_len < self.max_seq)
        if not active.any():
            return None
        pool = self._pool
        tokens = numpy.zeros((self.max_slots, self.draft_k + 1),
                             numpy.int32)
        drafts = numpy.zeros(self.max_slots, numpy.int32)
        tokens[:, 0] = numpy.where(active, self.slot_token, 0)
        order = [int(s) for s in numpy.nonzero(active)[0]]
        budget = None
        if pool is not None:
            # reserve what PLAIN decode would claim for every slot first;
            # drafts spend only what remains
            budget = pool.blocks_free - sum(
                max(0, int(self.slot_len[slot]) // self.block_size + 1
                    - len(pool.owned(slot))) for slot in order)
        for slot in order:
            p = int(self.slot_len[slot])
            # the span p..p+D writes D+1 positions inside max_seq
            prop = list(proposals.get(slot, ()))[
                :max(0, min(self.draft_k, self.max_seq - p - 1))]
            if pool is not None:
                while True:
                    extra = ((p + len(prop)) // self.block_size
                             - p // self.block_size)
                    if extra <= budget or not prop:
                        break
                    prop.pop()
                budget -= extra
            drafts[slot] = len(prop)
            tokens[slot, 1:1 + len(prop)] = prop
            self.spec_drafted_total += len(prop)
        if pool is not None:
            # host half of the fused append, draft-span sized
            for slot in order:
                last = int(self.slot_len[slot]) + int(drafts[slot])
                while len(pool.owned(slot)) * self.block_size <= last:
                    pool.append(slot,
                                len(pool.owned(slot)) * self.block_size)
        positions = numpy.where(active, self.slot_len, 0)
        self.decode_calls += 1
        self.spec_dispatches += 1
        with trace.span("gen", "spec_verify",
                        {"active": len(order), "draft_k": self.draft_k},
                        role="server"), torch.inference_mode(), \
                cost.Tally() as tally, \
                prof.DispatchTimer(self.device) as timer:
            args = (self._put(tokens), self._put(positions),
                    self._put(drafts), self._put(active, torch.bool))
            if pool is not None:
                _cache, out = self.model.paged_verify(
                    self._params, self._cache,
                    self._put(pool.tables, torch.int32), *args)
            else:
                _cache, out = self.model.verify(self._params, self._cache,
                                                *args)
            out = out.cpu().numpy().astype(numpy.int32)
        results = {}
        for slot in order:
            d = int(drafts[slot])
            a = 0
            while a < d and tokens[slot, a + 1] == out[slot, a]:
                a += 1
            emitted = [int(t) for t in out[slot, :a + 1]]
            self.slot_len[slot] += a + 1
            self.slot_token[slot] = emitted[-1]
            if pool is not None:
                # the rejected tail's pages go back (its stale K/V lies
                # past the new length and is masked)
                pool.truncate(slot, int(self.slot_len[slot]))
            self.spec_accepted_total += a
            self.spec_tokens_total += a + 1
            results[slot] = emitted
        self._account("decode", "verify%d" % self.draft_k, tally, timer,
                      sum(len(tokens) for tokens in results.values()))
        return results

    # -- the fleet page handoff (item 7(e)) --------------------------------
    def export_slot(self, slot):
        _not_ported("the fleet page handoff (export_slot)", "7(e)")

    def adopt_sequence(self, payload):
        _not_ported("the fleet page handoff (adopt_sequence)", "7(e)")

    # -- lifecycle / introspection -----------------------------------------
    @property
    def blocks_total(self):
        return self._pool.blocks_total if self._pool else 0

    @property
    def blocks_free(self):
        return self._pool.blocks_free if self._pool else 0

    def hbm_per_request_bytes(self):
        """Device bytes held per in-flight sequence: its KV share (a
        whole ``max_seq`` slot contiguous; the pages in use paged, pages
        only the prefix cache holds left out) plus the params amortised
        over the occupants."""
        occupants = self.active_slots() + len(self._chunking)
        if not occupants:
            return 0
        if self._pool is not None:
            per_block = self.kv_cache_bytes // self.num_blocks
            blocks = self._pool.blocks_used
            if self._prefix is not None:
                blocks -= self._prefix.cache_only_pages()
            kv = blocks * per_block // occupants
        else:
            kv = self.kv_cache_bytes // self.max_slots
        return kv + self.params_nbytes // occupants

    def prefix_hit_rate(self):
        """Fraction of admitted pages served from the prefix cache
        instead of prefill compute (0.0 with the cache off)."""
        if not self.prefix_pages_total:
            return 0.0
        return self.prefix_shared_pages_total / float(
            self.prefix_pages_total)

    def spec_accept_rate(self):
        """Fraction of drafted tokens the verify accepted."""
        if not self.spec_drafted_total:
            return 0.0
        return self.spec_accepted_total / float(self.spec_drafted_total)

    def spec_tokens_per_dispatch(self):
        """Tokens emitted per verify call: 1.0 is plain decode's rate."""
        if not self.spec_dispatches:
            return 0.0
        return self.spec_tokens_total / float(self.spec_dispatches)

    def describe(self):
        """The engine's configuration and counters.  ``params_bytes``
        counts every storage of the served tree once: at float32 it is
        the JAX engine's ``params_nbytes`` (float or int8); at a bf16
        ``compute_dtype`` the block weights are held in bf16 and the
        readout's bf16 copy of the embedding (``embed_cd``) is counted,
        a copy the JAX tree does not hold."""
        info = {
            "model": type(self.model).__name__,
            "device": str(self.device),
            "max_slots": self.max_slots,
            "max_seq": self.max_seq,
            "prefill_buckets": list(self.prefill_buckets),
            "kv_cache_bytes": self.kv_cache_bytes,
            "kv": self.kv_mode,
            "compute_dtype": str(self.model.compute_dtype),
            "quantize": self.quantized,
            "params_bytes": self.params_nbytes,
            "prefill_chunk": self.prefill_chunk,
            "active_slots": self.active_slots(),
            "prefilling_slots": len(self._chunking),
            "decode_calls": self.decode_calls,
            "prefill_calls": self.prefill_calls,
            "preemptions_total": self.preemptions_total,
            "hbm_per_request_bytes": self.hbm_per_request_bytes(),
            "prefix_cache": "on" if self.prefix_cache else "off",
            "speculative": self.speculative or "off",
            "sharded": self.mesh is not None,
        }
        if self.mesh is not None:
            info["mesh"] = dict(self.mesh.shape)
            info["local_heads"] = self.model.heads
        if self.speculative:
            info.update({
                "draft_k": self.draft_k,
                "spec_dispatches": self.spec_dispatches,
                "spec_drafted_total": self.spec_drafted_total,
                "spec_accepted_total": self.spec_accepted_total,
                "spec_accept_rate": round(self.spec_accept_rate(), 4),
                "spec_tokens_per_dispatch": round(
                    self.spec_tokens_per_dispatch(), 4)})
        if self._prefix is not None:
            info["prefix_hit_rate"] = round(self.prefix_hit_rate(), 4)
            info.update(self._prefix.describe())
        if self._pool is not None:
            info.update(self._pool.describe())
        return info

    def close(self):
        """Release the KV cache (pool) and params, and their ledger
        holds.  Idempotent."""
        stale = self._ledger_gen != Watcher.generation
        if self._kv_tracked:
            if not stale:
                Watcher.untrack(self.kv_cache_bytes, "kv")
            self._kv_tracked = False
        if self._params_tracked:
            if not stale:
                Watcher.untrack(self.params_nbytes, "params")
            self._params_tracked = False
        self._cache = None
        self._params = None


def _first_leaf(tree):
    for leaf in tree.values():
        return _first_leaf(leaf) if isinstance(leaf, dict) else leaf
    return None
