"""Generative model protocol and the decoder-only transformer adapter.

Counterpart of :mod:`veles_tpu.gen.model`.  The
:class:`~veles_tpu_torch.gen.engine.GenerativeEngine` drives a model
object through this protocol:

- ``causal`` (bool), ``vocab``, ``seq_limit``, ``device`` attributes;
- ``init_params(seed)`` → host (numpy) param tree;
- ``init_cache(slots, max_seq)`` → slot-major KV cache
  (``{"k": [L, slots, S, h, dh], "v": ...}`` tensors on ``device``);
- ``prefill(params, cache, tokens, slot, length)`` → ``(cache,
  next_token)``;
- ``decode(params, cache, tokens, positions, active)`` → ``(cache,
  next_tokens)`` — ONE autoregressive step over every slot at once.

The PAGED half mirrors these over a shared block pool
(:mod:`veles_tpu_torch.gen.paged`): ``init_paged_cache(num_blocks,
block_size)`` (``{"k", "v"}: [L, num_blocks, BS, h, dh]``),
``paged_prefill`` and ``paged_decode`` (a block-id scatter and a read
through the block tables, the page append fused into the decode step),
the chunked-prefill pair ``prefill_chunk`` / ``paged_prefill_chunk``
(one chunk of a prompt per call) and the speculative pair ``verify`` /
``paged_verify`` (a slot's pending token and up to 7 drafts scored in
one call).  Writes that must not land in a live page (inactive slots,
rows past a slot's drafts, bucket tails past the allocation, pages
shared through the prefix cache) route to the trash block 0, which
nothing reads unmasked.

Unlike the JAX model, whose programs return a successor cache, these
update the cache tensors IN PLACE (the returned ``cache`` is the same
object): PyTorch runs eagerly and a copy of a 0.4 GB cache per step
would cost more than the step.  Both are row-independent across slots:
slot ``i``'s outputs depend only on slot ``i``'s query and its valid
cache prefix, which is what makes continuous batching bit-exact against
sequential decode.

Prefill attention runs :func:`~veles_tpu_torch.ops.attention
.flash_attention` (the flash-prefill kernel on the card), chunked
prefill :func:`~veles_tpu_torch.ops.attention.chunk_attention` (the
same kernel at a runtime query offset), decode and contiguous verify
attention :func:`~veles_tpu_torch.ops.attention.decode_attention` (the
decode kernel), paged decode and verify
:func:`~veles_tpu_torch.ops.attention.paged_decode_attention` (its
paged entry).  A block weight quantized to an ``{"q", "scale"}`` int8
pair (:mod:`veles_tpu_torch.quant`) runs its product through
:func:`~veles_tpu_torch.ops.qgemm.qmatmul` (the qmatmul kernel on the
card: four per layer when all four are quantized, the MLP's bias and
gelu in the epilogues); every other block product is a plain
``torch.matmul``.

Tensor parallelism (:meth:`TransformerGenModel.shard`): a model shard
``r`` of ``m`` over a ``model`` axis holds the JAX specs' slices
(:meth:`~TransformerGenModel.param_specs`: ``wqkv`` and its heads, ``w1``
/ ``b1`` column-parallel, ``wo`` and ``w2`` row-parallel, the rest
replicated) and its heads of the KV cache or the block pool
(:meth:`~TransformerGenModel.cache_spec`; the block tables stay
replicated), so the attention kernels run on ``heads / m`` heads.  The
row-parallel ``wo`` and ``w2`` products give float32 partials, which
the shard's group sums (``torch.distributed`` ranks, or
:class:`VirtualShards` on one device, in rank order) before the one
rounding to the compute type a single product makes; ``b2`` is added
after the sum.
"""

import numpy
import torch
import torch.nn.functional as F

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.ops import cost, qgemm
from veles_tpu_torch.ops.attention import (chunk_attention,
                                           decode_attention,
                                           flash_attention,
                                           paged_decode_attention,
                                           paged_verify_attention,
                                           verify_attention)
from veles_tpu_torch.quant.core import is_quantized_leaf
from veles_tpu_torch.samples.transformer import _layernorm, init_params

#: block weights whose matmul operands are cast to ``compute_dtype``
_MATMUL_LEAVES = ("wqkv", "wo", "w1", "b1", "w2", "b2")

#: the block leaves a model shard slices, and the dim (of the stacked
#: leaf) it slices: the heads of wqkv [L, d, 3, h, dh] and wo [L, h, dh,
#: d], the hidden units of w1 [L, d, f], b1 [L, f] and w2 [L, f, d]
TP_DIMS = {"wqkv": 3, "wo": 1, "w1": 2, "b1": 1, "w2": 1}


class VirtualShards(object):
    """The group of ``size`` model shards run by threads of one process
    on one device: :meth:`all_reduce` returns, to every shard, the sum of
    the shards' tensors in rank order (where a rank's all-reduce would
    go), and :meth:`run` runs ``fn(rank)`` on every shard at once."""

    def __init__(self, size):
        import threading
        self.size = int(size)
        self._parts = [None] * self.size
        self._sum = None
        self._barrier = threading.Barrier(self.size)
        #: the sums made, as a group's all-reduce count
        self.reductions = 0

    def all_reduce(self, tensor, rank):
        self._parts[rank] = tensor
        self._barrier.wait()
        if rank == 0:
            total = self._parts[0]
            for part in self._parts[1:]:
                total = total + part
            self._sum = total
            self.reductions += 1
        self._barrier.wait()
        out = self._sum
        self._barrier.wait()
        return out

    def run(self, fn):
        """``[fn(rank) for rank]``, every rank in its own thread."""
        import threading
        results, errors = [None] * self.size, []

        def body(rank):
            try:
                results[rank] = fn(rank)
            except BaseException as exc:  # pragma: no cover - re-raised
                errors.append(exc)
                self._barrier.abort()
        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.size)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        if errors:
            raise errors[0]
        return results


def params_from_numpy(tree, device, dtype=torch.float32):
    """Carry a numpy param tree (``veles_tpu.samples.transformer
    .init_params``, this package's copy, or a trained JAX run's arrays)
    into tensors of ``dtype`` on ``device``, keeping the tree's
    structure; a quantized ``{"q", "scale"}`` pair keeps ``q`` int8 and
    ``scale`` float32.  The tensors are copies: an in-place update (the
    train step's) never writes through to the numpy arrays."""
    device = torch.device(device)
    if is_quantized_leaf(tree):
        return {"q": torch.tensor(numpy.asarray(tree["q"]), dtype=torch.int8,
                                  device=device),
                "scale": torch.tensor(numpy.asarray(tree["scale"]),
                                      dtype=torch.float32, device=device)}
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out[key] = params_from_numpy(leaf, device, dtype)
        else:
            out[key] = torch.tensor(numpy.asarray(leaf), dtype=dtype,
                                    device=device)
    return out


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: a tree of tensors (on
    any device) as numpy copies of the same structure, float leaves as
    float32 and int8 leaves as they are."""
    return {key: (params_to_numpy(leaf) if isinstance(leaf, dict)
                  else leaf.detach().to(
                      "cpu", torch.float32 if leaf.is_floating_point()
                      else leaf.dtype, copy=True).numpy())
            for key, leaf in tree.items()}


def _layer_slice(leaf, i):
    """Layer ``i`` of a stacked block leaf (a tensor or a quantized
    pair)."""
    if isinstance(leaf, dict):
        return {"q": leaf["q"][i], "scale": leaf["scale"][i]}
    return leaf[i]


class TransformerGenModel(object):
    """Decoder-only transformer (``samples/transformer.py`` params) with
    a slot-major KV cache.

    ``compute_dtype`` defaults to float32 (the parity tests' substrate);
    serving on the card passes ``torch.bfloat16``, like the TPU deploy.
    The residual stream stays in the parameters' dtype; only matmul
    operands are cast.  ``device`` defaults to ``cuda`` and raises
    without a card unless ``"cpu"`` is asked for.
    """

    causal = True

    def __init__(self, cfg, compute_dtype=None, device=None):
        self.cfg = dict(cfg)
        self.vocab = int(cfg["vocab"])
        self.dim = int(cfg["dim"])
        self.heads = int(cfg["heads"])
        self.layers = int(cfg["layers"])
        if self.dim % self.heads:
            raise ValueError("dim %d not divisible by heads %d"
                             % (self.dim, self.heads))
        self.head_dim = self.dim // self.heads
        self.seq_limit = int(cfg["seq_len"])
        self.compute_dtype = compute_dtype or torch.float32
        self.device = resolve_device(device)
        #: a model shard's place: (rank, size, group) over the model
        #: axis; None for the whole model
        self.tp = None

    # -- tensor parallelism ------------------------------------------------
    def shard(self, rank, size, group):
        """Model shard ``rank`` of ``size`` (see the module): the same
        model over ``heads / size`` heads, summing its row-parallel
        partials over ``group`` (a ``comm.Group`` or a
        :class:`VirtualShards`).  Raises ``ValueError`` when the axis
        does not divide the heads."""
        import copy
        if self.heads % int(size):
            raise ValueError("model axis %d does not divide %d heads"
                             % (size, self.heads))
        part = copy.copy(self)
        part.cfg = dict(self.cfg)
        part.heads = self.heads // int(size)
        part.tp = (int(rank), int(size), group)
        return part

    def param_specs(self):
        """The spec tree (tuples, as ``P(...)``) of :meth:`init_params`
        over a ``model`` axis: the JAX model's Megatron column -> row
        pairs (:data:`TP_DIMS`), everything else replicated."""
        from veles_tpu_torch.parallel.tp import shard_dim

        def walk(tree):
            return {key: walk(leaf) if isinstance(leaf, dict)
                    else (shard_dim(numpy.ndim(leaf), TP_DIMS[key])
                          if key in TP_DIMS else ())
                    for key, leaf in tree.items()}
        return walk(self.init_params(seed=0))

    def cache_spec(self):
        """The KV cache sharded over heads (dim 3 of [L, slots, S, h,
        dh])."""
        spec = (None, None, None, "model", None)
        return {"k": spec, "v": spec}

    def paged_cache_spec(self):
        """The block pool sharded over heads (dim 3 of [L, num_blocks,
        BS, h, dh]); the block tables stay replicated."""
        return self.cache_spec()

    def shard_params(self, params):
        """This shard's slices of a whole params tree (numpy or torch
        leaves), as :meth:`param_specs` lays them out."""
        if self.tp is None:
            return params
        rank, size, _group = self.tp
        blocks = {}
        for key, leaf in params["blocks"].items():
            dim = TP_DIMS.get(key)
            if dim is None:
                blocks[key] = leaf
                continue
            step = leaf.shape[dim] // size
            cut = [slice(None)] * dim + [slice(rank * step,
                                               (rank + 1) * step)]
            part = leaf[tuple(cut)]
            blocks[key] = part.contiguous() \
                if isinstance(part, torch.Tensor) \
                else numpy.ascontiguousarray(part)
        return dict(params, blocks=blocks)

    def _tp_sum(self, partial):
        """A row-parallel product's float32 partial summed over the
        shard's group."""
        rank, _size, group = self.tp
        if isinstance(group, VirtualShards):
            return group.all_reduce(partial, rank)
        from veles_tpu_torch.parallel.comm import all_reduce
        return all_reduce(partial, group)

    def _mm_partial(self, x2, leaf, nc):
        """A row-parallel block product's partial in float32 (its
        operands exact in float32), for :meth:`_tp_sum`."""
        k = 1
        for dim in leaf.shape[:nc]:
            k *= int(dim)
        w = leaf.to(x2.dtype).reshape(k, -1)
        y = x2.float() @ w.float()
        cost.add(cost.product(y.shape[0], y.shape[1], k),
                 cost.nbytes(x2, w, y))
        return y

    # -- params / cache ----------------------------------------------------
    def init_params(self, seed=0):
        """Host (numpy, float32) params, bit-identical to the JAX
        package's for the same seed."""
        return init_params(self.cfg, seed=seed)

    def serving_params(self, params):
        """The tree the engine serves from: ``params`` with the block
        matmul weights cast ONCE to ``compute_dtype`` and a cast copy
        of the tied embedding for the readout (``embed_cd``).  The casts
        are the ones :meth:`_run_layers` would make on every call, so
        the results are bit-identical; the embedding gather and the
        positional table stay in the params' dtype.  Quantized block
        weights (``{"q", "scale"}`` pairs) stay as they are: the qmatmul
        kernel reads ``q`` as stored.  At float32 the casts return the
        tensors themselves, so ``embed_cd`` is ``embed``."""
        cd = self.compute_dtype
        out = dict(params)
        out["blocks"] = {
            key: (leaf.to(cd) if key in _MATMUL_LEAVES
                  and not isinstance(leaf, dict) else leaf)
            for key, leaf in params["blocks"].items()}
        out["embed_cd"] = params["embed"].to(cd)
        return out

    def cache_shape(self, slots, max_seq):
        return (self.layers, int(slots), int(max_seq), self.heads,
                self.head_dim)

    def init_cache(self, slots, max_seq, dtype=None):
        shape = self.cache_shape(slots, max_seq)
        dtype = dtype or self.compute_dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    def cache_nbytes(self, slots, max_seq, dtype=None):
        return self._nbytes(self.cache_shape(slots, max_seq), dtype)

    def _nbytes(self, shape, dtype):
        itemsize = torch.empty((), dtype=dtype or self.compute_dtype
                               ).element_size()
        return 2 * int(numpy.prod(shape)) * itemsize

    # -- paged cache (shared block pool + per-slot block tables) -----------
    def paged_cache_shape(self, num_blocks, block_size):
        return (self.layers, int(num_blocks), int(block_size), self.heads,
                self.head_dim)

    def init_paged_cache(self, num_blocks, block_size, dtype=None):
        shape = self.paged_cache_shape(num_blocks, block_size)
        dtype = dtype or self.compute_dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    def paged_cache_nbytes(self, num_blocks, block_size, dtype=None):
        return self._nbytes(self.paged_cache_shape(num_blocks, block_size),
                            dtype)

    # -- forwards ----------------------------------------------------------
    def _mm(self, x2, leaf, nc, bias=None, gelu=False):
        """One block matmul of the rows ``x2`` (n, K) over one layer's
        slice of a block weight, then ``bias`` and the tanh gelu
        (``jax.nn.gelu``'s default) when asked.  The leaf's first ``nc``
        axes are the contraction (K) and the rest flatten into output
        channels (N), so every block weight reduces to one 2-D product.
        A quantized ``{"q", "scale"}`` leaf runs it through
        :func:`~veles_tpu_torch.ops.qgemm.qmatmul` (the kernel on the
        card: int8 weights read as stored, the scale, bias and gelu in
        the epilogue); a float leaf through a plain ``torch.matmul`` in
        ``x2``'s dtype."""
        quantized = isinstance(leaf, dict)
        w = leaf["q"] if quantized else leaf
        k = 1
        for dim in w.shape[:nc]:
            k *= int(dim)
        if quantized:
            return qgemm.qmatmul(x2, w.reshape(k, -1),
                                 leaf["scale"].reshape(-1), bias,
                                 "gelu" if gelu else None,
                                 out_dtype=x2.dtype)
        y = x2 @ w.to(x2.dtype).reshape(k, -1)
        # a plain product through cuBLAS: 2·M·N·K, the bias and the gelu
        # per output element; x2 and w read, y written
        cost.add(cost.product(y.shape[0], y.shape[1], k, bias is not None,
                              "gelu" if gelu else None),
                 cost.nbytes(x2, w, bias, y))
        if bias is not None:
            y = y + bias
        return F.gelu(y, approximate="tanh") if gelu else y

    def _run_layers(self, params, cache, h, kv_hook):
        """The ONE shared layer body over the stacked block axis (a
        Python loop in place of ``lax.scan``).  ``kv_hook(kc, vc, q, k,
        v) -> att`` is what the entry points differ in: where this
        layer's K/V land (written in place into ``kc``/``vc``, the
        layer's cache views, or None without a cache) and what the
        attention reads.  Each of the four block products goes through
        :meth:`_mm`, float or quantized leaf alike (each independently:
        the calibration blame probe quantizes one key at a time), so
        every entry point (prefill, decode, paged, chunked, verify)
        serves int8 through this one body.  Returns the final-normed
        ``h``."""
        cd = self.compute_dtype
        blocks = params["blocks"]
        for i in range(self.layers):
            blk = {key: _layer_slice(leaf, i) for key, leaf in blocks.items()}
            b_, s_ = h.shape[0], h.shape[1]
            x = _layernorm(h, blk["ln1_g"], blk["ln1_b"])
            qkv = self._mm(x.reshape(b_ * s_, -1).to(cd), blk["wqkv"], 1)
            qkv = qkv.view(b_, s_, 3, self.heads, self.head_dim)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            kc = vc = None
            if cache is not None:
                kc, vc = cache["k"][i], cache["v"][i]
            att = kv_hook(kc, vc, q, k, v)
            if self.tp is None:
                proj = self._mm(att.reshape(b_ * s_, -1).to(cd),
                                blk["wo"], 2)
            else:
                # the heads' partials summed, then rounded once
                proj = self._tp_sum(self._mm_partial(
                    att.reshape(b_ * s_, -1).to(cd), blk["wo"], 2)).to(cd)
            h = h + proj.reshape(b_, s_, -1).to(h.dtype)
            x = _layernorm(h, blk["ln2_g"], blk["ln2_b"])
            # bias + gelu ride the up-projection's epilogue, the bias the
            # down-projection's
            up = self._mm(x.reshape(b_ * s_, -1).to(cd), blk["w1"], 1,
                          bias=blk["b1"].to(cd), gelu=True)
            if self.tp is None:
                down = self._mm(up, blk["w2"], 1, bias=blk["b2"].to(cd))
            else:
                down = self._tp_sum(self._mm_partial(
                    up, blk["w2"], 1)).to(cd) + blk["b2"].to(cd)
            h = h + down.reshape(b_, s_, -1).to(h.dtype)
        return _layernorm(h, params["lnf_g"], params["lnf_b"])

    def _readout(self, params, rows):
        """Tied readout of ``rows`` (n, d) → f32 logits (n, vocab), in
        ``compute_dtype`` like the JAX einsum."""
        cd = self.compute_dtype
        embed = params.get("embed_cd")
        if embed is None:
            embed = params["embed"].to(cd)
        logits = rows.to(cd) @ embed.t()
        # the tied readout, 2·rows·d·vocab; rows and the table read, the
        # logits written
        cost.add(cost.product(logits.shape[0], logits.shape[1],
                              rows.shape[1]),
                 cost.nbytes(rows, embed, logits))
        return logits.float()

    def _tokens(self, params, tokens):
        return torch.as_tensor(tokens, dtype=torch.long).to(
            params["embed"].device)

    def _greedy_at(self, params, h, index):
        """h (1, S, d) → the greedy token of row ``index`` (0-d)."""
        return torch.argmax(self._readout(params, h[0, index:index + 1])[0])

    def _greedy_grid(self, params, h):
        """h (slots, K+1, d) → the greedy token of EVERY row (slots,
        K+1): the verify step's readout, row by row the same tied
        readout as :meth:`decode`'s."""
        slots, kp1, dim = h.shape
        logits = self._readout(params, h.reshape(slots * kp1, dim))
        return torch.argmax(logits, dim=-1).reshape(slots, kp1)

    def _pages(self, rows, n_blk):
        """(S, h, dh) rows as (n_blk, S // n_blk, h, dh) pages."""
        return rows.reshape(n_blk, -1, self.heads, self.head_dim)

    def calibration_logits(self, params, tokens):
        """Last-position f32 logits (vocab,) of ONE prompt through the
        shared layer body; no cache is read or written.  ``params`` is a
        tree of tensors on the model's device, or a host numpy tree
        (the quantization walk's), carried there first."""
        if not isinstance(params["embed"], torch.Tensor):
            params = params_from_numpy(params, self.device)
        tokens = self._tokens(params, tokens).reshape(1, -1)
        s = tokens.shape[1]
        h = params["embed"][tokens] + params["pos"][:s]

        def kv_hook(kc, vc, q, k, v):
            return flash_attention(q, k, v, True)

        h = self._run_layers(params, None, h, kv_hook)
        return self._readout(params, h[0, -1:])[0]

    def prefill(self, params, cache, tokens, slot, length):
        """tokens (1, bucket) (zero-padded past ``length``), ``slot`` and
        ``length`` ints → ``(cache, greedy next token)`` as a 0-d
        tensor.  The WHOLE bucket's K/V (padded tail included) lands in
        cache row ``slot``; attention reads the chunk's own q/k/v, and
        the causal mask keeps the padded tail invisible to position
        ``length - 1``."""
        tokens = self._tokens(params, tokens)
        bucket = tokens.shape[1]
        h = params["embed"][tokens] + params["pos"][:bucket]

        def kv_hook(kc, vc, q, k, v):
            att = flash_attention(q, k, v, True)
            kc[slot, :bucket] = k[0].to(kc.dtype)
            vc[slot, :bucket] = v[0].to(vc.dtype)
            return att

        h = self._run_layers(params, cache, h, kv_hook)
        return cache, self._greedy_at(params, h, length - 1)

    def decode(self, params, cache, tokens, positions, active):
        """ONE decode step over every slot: tokens (slots,) (each slot's
        last token), positions (slots,) (the cache index this step
        writes = the slot's current length), active (slots,) bool.
        Inactive slots ride along at position 0 and their K/V write is
        a no-op.  Returns ``(cache, next_tokens)``."""
        tokens = self._tokens(params, tokens)
        positions = self._tokens(params, positions)
        active = torch.as_tensor(active, dtype=torch.bool).to(
            tokens.device)
        slots = tokens.shape[0]
        h = (params["embed"][tokens]
             + params["pos"][positions])[:, None, :]      # (slots, 1, d)
        idx = torch.arange(slots, device=tokens.device)
        keep = active[:, None, None]
        lengths = (positions + 1).to(torch.int32)

        def kv_hook(kc, vc, q, k, v):
            kc[idx, positions] = torch.where(
                keep, k[:, 0].to(kc.dtype), kc[idx, positions])
            vc[idx, positions] = torch.where(
                keep, v[:, 0].to(vc.dtype), vc[idx, positions])
            return decode_attention(q, kc, vc, lengths)

        h = self._run_layers(params, cache, h, kv_hook)
        logits = self._readout(params, h[:, 0])
        return cache, torch.argmax(logits, dim=-1)

    # -- paged forwards (block-pool cache, veles_tpu_torch.gen.paged) -----
    def paged_prefill(self, params, cache, tokens, block_ids, length):
        """Whole-prompt prefill into the PAGED pool: tokens (1, bucket)
        (bucket a multiple of block_size), block_ids (bucket //
        block_size,) — the prompt's pages in position order, entries past
        its allocation (and pages shared through the prefix cache) at the
        trash block 0.  Same forward as :meth:`prefill`; only where the
        K/V land differs."""
        tokens = self._tokens(params, tokens)
        block_ids = self._tokens(params, block_ids)
        bucket = tokens.shape[1]
        n_blk = block_ids.shape[0]
        h = params["embed"][tokens] + params["pos"][:bucket]

        def kv_hook(kc, vc, q, k, v):
            att = flash_attention(q, k, v, True)
            kc[block_ids] = self._pages(k[0], n_blk).to(kc.dtype)
            vc[block_ids] = self._pages(v[0], n_blk).to(vc.dtype)
            return att

        h = self._run_layers(params, cache, h, kv_hook)
        return cache, self._greedy_at(params, h, length - 1)

    def paged_decode(self, params, cache, tables, tokens, positions,
                     active):
        """ONE decode step over every slot against the PAGED pool: tables
        (slots, max_blocks) int32, the rest as :meth:`decode`.  The page
        append is fused in: position ``p`` scatters into page
        ``tables[slot, p // BS]`` at offset ``p % BS`` (inactive slots
        to the trash block), and the attention reads through the
        tables."""
        tokens = self._tokens(params, tokens)
        positions = self._tokens(params, positions)
        tables = torch.as_tensor(tables, dtype=torch.int32).to(
            tokens.device)
        active = torch.as_tensor(active, dtype=torch.bool).to(
            tokens.device)
        slots = tokens.shape[0]
        bs = cache["k"].shape[2]               # [L, NB, BS, h, dh]
        h = (params["embed"][tokens]
             + params["pos"][positions])[:, None, :]   # (slots, 1, d)
        idx = torch.arange(slots, device=tokens.device)
        zero = torch.zeros_like(positions)
        blk_idx = torch.where(active, tables[idx, positions // bs].long(),
                              zero)
        blk_off = torch.where(active, positions % bs, zero)
        lengths = (positions + 1).to(torch.int32)

        def kv_hook(kc, vc, q, k, v):
            # rows routed to the trash block collide there; nothing reads
            # block 0 unmasked, so which of them lands does not matter
            kc[blk_idx, blk_off] = k[:, 0].to(kc.dtype)
            vc[blk_idx, blk_off] = v[:, 0].to(vc.dtype)
            return paged_decode_attention(q, kc, vc, tables, lengths)

        h = self._run_layers(params, cache, h, kv_hook)
        return cache, torch.argmax(self._readout(params, h[:, 0]), dim=-1)

    # -- speculative verify (K drafts scored in ONE call) ------------------
    def _verify_rows(self, params, tokens, positions, drafts, active):
        """The verify entries' shared set-up: the (slots, K+1) input
        rows, the global positions, and which rows write their K/V
        (active slots, rows ``j <= drafts``); masked rows park at
        position 0."""
        tokens = self._tokens(params, tokens)
        positions = self._tokens(params, positions)
        drafts = self._tokens(params, drafts)
        active = torch.as_tensor(active, dtype=torch.bool).to(
            tokens.device)
        kp1 = tokens.shape[1]
        offs = torch.arange(kp1, device=tokens.device)
        gpos = positions[:, None] + offs[None, :]     # (slots, K+1)
        h = (params["embed"][tokens]
             + params["pos"][gpos.clamp(0, self.seq_limit - 1)])
        keep = active[:, None] & (offs[None, :] <= drafts[:, None])
        safe = torch.where(keep, gpos, torch.zeros_like(gpos))
        return h, positions, keep, safe

    def verify(self, params, cache, tokens, positions, drafts, active):
        """Score a slot's pending token plus its K draft continuations in
        ONE call against the CONTIGUOUS cache: tokens (slots, K+1) (row 0
        each slot's last emitted token, rows 1..K the drafts), positions
        (slots,) (row 0's write position), drafts (slots,) (how many
        draft rows are real, 0..K), active (slots,) bool.  K/V for rows
        ``j <= drafts`` land at ``positions + j``; masked rows re-write
        the old value at position 0 (live slots have positions >= 1).
        Returns ``(cache, out)``, ``out[s, j]`` the greedy token after
        the prefix plus ``tokens[s, :j+1]``."""
        h, positions, keep, safe = self._verify_rows(
            params, tokens, positions, drafts, active)
        slots, kp1 = safe.shape
        rows = torch.arange(slots, device=safe.device)[:, None].expand(
            slots, kp1)
        lengths = (positions + 1).to(torch.int32)
        keep4 = keep[..., None, None]

        def kv_hook(kc, vc, q, k, v):
            kc[rows, safe] = torch.where(keep4, k.to(kc.dtype),
                                         kc[rows, safe])
            vc[rows, safe] = torch.where(keep4, v.to(vc.dtype),
                                         vc[rows, safe])
            return verify_attention(q, kc, vc, lengths)

        h = self._run_layers(params, cache, h, kv_hook)
        return cache, self._greedy_grid(params, h)

    def paged_verify(self, params, cache, tables, tokens, positions,
                     drafts, active):
        """The PAGED twin of :meth:`verify`: K/V rows scatter through the
        block tables like :meth:`paged_decode`'s append (the engine has
        allocated every page the draft span touches), rows past
        ``drafts`` and inactive slots to the trash block, and the
        attention reads through the tables with the verify mask."""
        h, positions, keep, safe = self._verify_rows(
            params, tokens, positions, drafts, active)
        tables = torch.as_tensor(tables, dtype=torch.int32).to(
            safe.device)
        slots = safe.shape[0]
        bs = cache["k"].shape[2]               # [L, NB, BS, h, dh]
        idx = torch.arange(slots, device=safe.device)[:, None]
        zero = torch.zeros_like(safe)
        blk_idx = torch.where(keep, tables[idx, safe // bs].long(), zero)
        blk_off = torch.where(keep, safe % bs, zero)
        lengths = (positions + 1).to(torch.int32)

        def kv_hook(kc, vc, q, k, v):
            kc[blk_idx, blk_off] = k.to(kc.dtype)
            vc[blk_idx, blk_off] = v.to(vc.dtype)
            return paged_verify_attention(q, kc, vc, tables, lengths)

        h = self._run_layers(params, cache, h, kv_hook)
        return cache, self._greedy_grid(params, h)

    # -- chunked prefill (one chunk per decode-step cadence) ---------------
    def prefill_chunk(self, params, cache, tokens, slot, start, chunk_len):
        """ONE chunk of a prompt through the CONTIGUOUS cache: tokens (1,
        C) (zero-padded past ``chunk_len`` on the final chunk); writes
        K/V at [slot, start:start+C) and attends the chunk's queries
        causally against the slot's whole cache row (keys >= start+C
        hidden by the causal offset).  Returns ``(cache, token)``, the
        token meaningful on the final chunk only."""
        tokens = self._tokens(params, tokens)
        chunk = tokens.shape[1]
        h = params["embed"][tokens] + params["pos"][start:start + chunk]

        def kv_hook(kc, vc, q, k, v):
            kc[slot, start:start + chunk] = k[0].to(kc.dtype)
            vc[slot, start:start + chunk] = v[0].to(vc.dtype)
            return chunk_attention(q, kc[slot:slot + 1], vc[slot:slot + 1],
                                   start)

        h = self._run_layers(params, cache, h, kv_hook)
        return cache, self._greedy_at(params, h, chunk_len - 1)

    def paged_prefill_chunk(self, params, cache, tokens, chunk_ids, table,
                            start, chunk_len):
        """ONE chunk of a prompt through the PAGED pool: chunk_ids (C //
        block_size,) the pages covering [start, start+C) (trash past the
        allocation), table (max_blocks,) the sequence's whole block table
        for the attention's read, gathered by a plain index as the JAX
        package gathers it outside any kernel.  Otherwise as
        :meth:`prefill_chunk`."""
        tokens = self._tokens(params, tokens)
        chunk_ids = self._tokens(params, chunk_ids)
        table = self._tokens(params, table)
        chunk = tokens.shape[1]
        n_blk = chunk_ids.shape[0]
        h = params["embed"][tokens] + params["pos"][start:start + chunk]

        def kv_hook(kc, vc, q, k, v):
            kc[chunk_ids] = self._pages(k[0], n_blk).to(kc.dtype)
            vc[chunk_ids] = self._pages(v[0], n_blk).to(vc.dtype)
            kg, vg = (c[table].reshape(1, -1, self.heads, self.head_dim)
                      for c in (kc, vc))
            return chunk_attention(q, kg, vg, start)

        h = self._run_layers(params, cache, h, kv_hook)
        return cache, self._greedy_at(params, h, chunk_len - 1)

    # -- analytic FLOPs ----------------------------------------------------
    def _per_token_layer_flops(self, attended):
        d, f = self.dim, self.cfg["mlp_ratio"] * self.dim
        return (2.0 * d * 3 * d          # qkv projection
                + 4.0 * attended * d     # QK^T + AV over the read KV
                + 2.0 * d * d            # output projection
                + 4.0 * d * f)           # mlp up + down

    def prefill_flops(self, bucket):
        """Forward FLOPs of one bucket prefill (causal-discounted
        attention) + one readout."""
        per_token = self.layers * self._per_token_layer_flops(
            bucket / 2.0)
        return bucket * per_token + 2.0 * self.dim * self.vocab

    def prefill_chunk_flops(self, chunk, max_seq):
        """Forward FLOPs of one prefill chunk: each chunk token attends to
        its whole prefix, counted at the ``max_seq / 2`` mean extent, +
        one readout."""
        per_token = self.layers * self._per_token_layer_flops(
            max_seq / 2.0)
        return chunk * per_token + 2.0 * self.dim * self.vocab

    def verify_flops(self, slots, k, max_seq):
        """FLOPs of one K-draft verify step: K+1 query rows per slot,
        each counted like a decode row."""
        return (k + 1.0) * self.decode_flops(slots, max_seq)

    def decode_flops(self, slots, max_seq):
        """FLOPs of one decode step, counting every slot's attention at
        the full ``max_seq`` extent (an upper bound: the decode kernel
        reads only the valid keys)."""
        per_token = (self.layers
                     * self._per_token_layer_flops(float(max_seq))
                     + 2.0 * self.dim * self.vocab)
        return slots * per_token
