"""GenerativeEngine: prefill buckets + ONE decode step over a slot-major,
device-resident KV cache.

Counterpart of :mod:`veles_tpu.gen.engine` in its default
configuration: contiguous KV (``{"k", "v"}: [layers, slots, max_seq,
heads, head_dim]`` tensors on the device, held in the HBM ledger's
``kv`` category), whole-prompt prefill in power-of-two buckets, float
weights, one device.  The JAX engine compiles one program per bucket
ahead of time; PyTorch runs eagerly, so :meth:`warmup` instead builds
the CUDA kernels and runs every bucket and the decode step once.

The paged KV pool, chunked prefill, the prefix cache, speculative
decode, a tensor-parallel mesh and int8 params are later slices of the
port: asking for any of them raises ``NotImplementedError`` naming its
ROADMAP item.
"""

import bisect

import numpy
import torch

from veles_tpu_torch import trace
from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.config import root
from veles_tpu_torch.gen.model import (_not_ported, params_from_numpy,
                                       tree_nbytes)
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.memory import Watcher


def _power_of_two_buckets(lo, hi):
    buckets, b = [], lo
    while b < hi:
        buckets.append(b)
        b *= 2
    buckets.append(hi)
    return tuple(buckets)


def _is_quantized(tree):
    return any(isinstance(leaf, dict) and ("q" in leaf or
                                           _is_quantized(leaf))
               for leaf in tree.values())


class GenerativeEngine(Logger):
    """Slot-based generative inference over a protocol model
    (:mod:`veles_tpu_torch.gen.model`).

    Host-side slot bookkeeping (lengths, last tokens, free list) lives
    here; the scheduler (:mod:`veles_tpu_torch.gen.scheduler`) decides
    WHEN to admit and evict.  Greedy sampling happens on the device —
    tokens come back as integers, never logits, so a decode step moves
    ``slots`` tokens device → host and the parity gate is a bitwise
    token comparison.  ``device`` defaults to ``cuda`` (raising
    without a card) and must be the model's.
    """

    def __init__(self, model, params=None, *, max_slots=4, max_seq=None,
                 prefill_buckets=None, mesh=None, eos_id=None, seed=0,
                 kv=None, prefill_chunk=None, prefix_cache=None,
                 speculative=None, device=None, **kwargs):
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

        gen_cfg = root.common.gen
        self.kv_mode = str(kv or gen_cfg.get("kv", "contiguous"))
        if self.kv_mode == "paged":
            _not_ported("kv='paged' (the block-pool KV cache)", 2)
        if self.kv_mode != "contiguous":
            raise ValueError("root.common.gen.kv must be 'contiguous' or "
                             "'paged', got %r" % self.kv_mode)
        chunk = prefill_chunk if prefill_chunk is not None \
            else gen_cfg.get("prefill_chunk", None)
        if chunk:
            _not_ported("prefill_chunk (chunked prefill)", 2)
        pc = prefix_cache if prefix_cache is not None \
            else gen_cfg.get("prefix_cache", "off")
        if pc not in (False, None, "off"):
            _not_ported("prefix_cache (the radix prefix cache)", 2)
        spec = speculative if speculative is not None \
            else gen_cfg.get("speculative", "off")
        if spec not in (False, None, "off"):
            _not_ported("speculative decode", 2)
        if mesh is not None:
            _not_ported("a tensor-parallel mesh", 7)

        buckets = tuple(sorted(set(
            int(b) for b in (prefill_buckets
                             or _power_of_two_buckets(
                                 min(8, self.max_seq), self.max_seq)))))
        if buckets[0] < 1 or buckets[-1] > self.max_seq:
            raise ValueError("prefill buckets %s must lie in 1..max_seq=%d"
                             % (buckets, self.max_seq))
        self.prefill_buckets = buckets
        self.eos_id = None if eos_id is None else int(eos_id)

        if params is None:
            params = model.init_params(seed=seed)
        if _is_quantized(params):
            _not_ported("int8-quantized params", 3)
        if not isinstance(_first_leaf(params), torch.Tensor):
            params = params_from_numpy(params, self.device)
        self._params = model.serving_params(params)
        self._cache = model.init_cache(self.max_slots, self.max_seq)
        self.kv_cache_bytes = model.cache_nbytes(self.max_slots,
                                                 self.max_seq)
        Watcher.track(self.kv_cache_bytes, "kv")
        self._kv_tracked = True
        self.params_nbytes = tree_nbytes(self._params)
        Watcher.track(self.params_nbytes, "params")
        self._params_tracked = True
        self._ledger_gen = Watcher.generation

        self.slot_len = numpy.zeros(self.max_slots, numpy.int32)
        self.slot_token = numpy.zeros(self.max_slots, numpy.int32)
        self.slot_active = numpy.zeros(self.max_slots, bool)
        self._free = list(range(self.max_slots))
        self.decode_calls = 0
        self.prefill_calls = 0
        self._warmed = False

    # -- warmup ------------------------------------------------------------
    def warmup(self):
        """Build the CUDA kernels (on the card) and run every prefill
        bucket and the decode step once, so the first request pays no
        build or library set-up.  The runs use no slot: nothing is
        active, and the K/V they leave behind lies beyond every length
        a later prefill or decode reads.  Returns self (chainable)."""
        if self.device.type == "cuda":
            from veles_tpu_torch.ops import build
            build.build_all()
        with torch.inference_mode():
            for bucket in self.prefill_buckets:
                tokens = torch.zeros((1, bucket), dtype=torch.long,
                                     device=self.device)
                self.model.prefill(self._params, self._cache, tokens, 0, 1)
            zeros = torch.zeros(self.max_slots, dtype=torch.long,
                                device=self.device)
            self.model.decode(self._params, self._cache, zeros, zeros,
                              zeros.bool())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed = True
        return self

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

    def _validate_prompt_len(self, n):
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
        be admitted — the scheduler's door check."""
        self.bucket_for(self._validate_prompt_len(n))

    def can_admit(self, n, tokens=None):
        """True when a prompt of ``n`` tokens is admissible right now:
        a free slot (capacity was reserved per slot up front)."""
        return bool(self._free)

    def release_slot(self, slot):
        if not self.slot_active[slot]:
            raise ValueError("slot %d is not active" % slot)
        self.slot_active[slot] = False
        self.slot_len[slot] = 0
        # deterministic admission: the free list stays sorted
        bisect.insort(self._free, slot)

    # -- serving -----------------------------------------------------------
    def prefill(self, tokens):
        """Admit one prompt into a free slot with ONE whole-bucket
        prefill: returns ``(slot, first_token)``.  Raises
        ``RuntimeError`` when no slot is free and ``ValueError`` on an
        unservable prompt."""
        tokens = numpy.ascontiguousarray(tokens, numpy.int32).ravel()
        n = self._validate_prompt_len(len(tokens))
        bucket = self.bucket_for(n)
        if not self._free:
            raise RuntimeError("no free slot (all %d busy)"
                               % self.max_slots)
        slot = self._free.pop(0)
        padded = numpy.zeros((1, bucket), numpy.int64)
        padded[0, :n] = tokens
        self.prefill_calls += 1
        with trace.span("gen", "prefill",
                        {"bucket": bucket, "slot": slot, "len": n},
                        role="server"), torch.inference_mode():
            _cache, tok = self.model.prefill(
                self._params, self._cache,
                torch.from_numpy(padded).to(self.device), slot, n)
            tok = int(tok)
        self.slot_len[slot] = n
        self.slot_token[slot] = tok
        self.slot_active[slot] = True
        return slot, tok

    def admit(self, tokens):
        """The admission door the scheduler calls: whole-prompt prefill,
        ``(slot, first_token)``."""
        return self.prefill(tokens)

    def decode_step(self):
        """ONE fixed-shape decode iteration over every slot.  Returns
        ``(tokens, active)`` host arrays — ``tokens[slot]`` is only
        meaningful where ``active[slot]`` — or ``None`` when nothing
        can decode.  Slots parked at ``max_seq`` are excluded."""
        active = self.slot_active & (self.slot_len < self.max_seq)
        if not active.any():
            return None
        positions = numpy.where(active, self.slot_len, 0).astype(
            numpy.int64)
        toks = numpy.where(active, self.slot_token, 0).astype(numpy.int64)
        self.decode_calls += 1
        with trace.span("gen", "decode", {"active": int(active.sum())},
                        role="server"), torch.inference_mode():
            _cache, out = self.model.decode(
                self._params, self._cache,
                torch.from_numpy(toks).to(self.device),
                torch.from_numpy(positions).to(self.device),
                torch.from_numpy(active).to(self.device))
            out = out.cpu().numpy().astype(numpy.int32)
        self.slot_len[active] += 1
        self.slot_token[active] = out[active]
        return out, active

    # -- lifecycle / introspection -----------------------------------------
    def hbm_per_request_bytes(self):
        """Device bytes held per in-flight sequence: its KV slot plus
        the params amortised over the occupants."""
        occupants = self.active_slots()
        if not occupants:
            return 0
        return (self.kv_cache_bytes // self.max_slots
                + self.params_nbytes // occupants)

    def describe(self):
        return {
            "model": type(self.model).__name__,
            "device": str(self.device),
            "max_slots": self.max_slots,
            "max_seq": self.max_seq,
            "prefill_buckets": list(self.prefill_buckets),
            "kv_cache_bytes": self.kv_cache_bytes,
            "kv": self.kv_mode,
            "compute_dtype": str(self.model.compute_dtype),
            "params_bytes": self.params_nbytes,
            "active_slots": self.active_slots(),
            "decode_calls": self.decode_calls,
            "prefill_calls": self.prefill_calls,
            "hbm_per_request_bytes": self.hbm_per_request_bytes(),
        }

    def close(self):
        """Release the KV cache and params (and their ledger holds).
        Idempotent."""
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
