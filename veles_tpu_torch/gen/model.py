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

Unlike the JAX model, whose programs return a successor cache, these
update the cache tensors IN PLACE (the returned ``cache`` is the same
object): PyTorch runs eagerly and a copy of a 0.4 GB cache per step
would cost more than the step.  Both are row-independent across slots:
slot ``i``'s outputs depend only on slot ``i``'s query and its valid
cache prefix, which is what makes continuous batching bit-exact against
sequential decode.

Prefill attention runs :func:`~veles_tpu_torch.ops.attention
.flash_attention` (the flash-prefill kernel on the card), decode
attention :func:`~veles_tpu_torch.ops.attention.decode_attention` (the
decode kernel); every other product is a plain ``torch.matmul``.
"""

import numpy
import torch
import torch.nn.functional as F

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.ops.attention import decode_attention, flash_attention
from veles_tpu_torch.samples.transformer import (_layernorm, _not_ported,
                                                 init_params)

#: block weights whose matmul operands are cast to ``compute_dtype``
_MATMUL_LEAVES = ("wqkv", "wo", "w1", "b1", "w2", "b2")


def params_from_numpy(tree, device, dtype=torch.float32):
    """Carry a numpy param tree (``veles_tpu.samples.transformer
    .init_params``, this package's copy, or a trained JAX run's arrays)
    into tensors of ``dtype`` on ``device``, keeping the tree's
    structure.  The tensors are copies: an in-place update (the train
    step's) never writes through to the numpy arrays."""
    device = torch.device(device)
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
    any device) as float32 numpy copies of the same structure."""
    return {key: (params_to_numpy(leaf) if isinstance(leaf, dict)
                  else leaf.detach().to("cpu", torch.float32,
                                        copy=True).numpy())
            for key, leaf in tree.items()}


def tree_nbytes(tree):
    """Bytes held by every tensor of a (nested dict) tree."""
    return sum(tree_nbytes(leaf) if isinstance(leaf, dict)
               else leaf.numel() * leaf.element_size()
               for leaf in tree.values())


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
        positional table stay in the params' dtype."""
        cd = self.compute_dtype
        out = dict(params)
        out["blocks"] = {
            key: leaf.to(cd) if key in _MATMUL_LEAVES else leaf
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
        shape = self.cache_shape(slots, max_seq)
        itemsize = torch.empty((), dtype=dtype or self.compute_dtype
                               ).element_size()
        return 2 * int(numpy.prod(shape)) * itemsize

    # -- forwards ----------------------------------------------------------
    def _run_layers(self, params, cache, h, kv_hook):
        """The ONE shared layer body over the stacked block axis (a
        Python loop in place of ``lax.scan``).  ``kv_hook(kc, vc, q, k,
        v) -> att`` is what the entry points differ in: where this
        layer's K/V land (written in place into ``kc``/``vc``, the
        layer's cache views, or None without a cache) and what the
        attention reads.  Returns the final-normed ``h``."""
        cd = self.compute_dtype
        blocks = params["blocks"]
        for i in range(self.layers):
            blk = {key: leaf[i] for key, leaf in blocks.items()}
            b_, s_ = h.shape[0], h.shape[1]
            x = _layernorm(h, blk["ln1_g"], blk["ln1_b"])
            qkv = (x.to(cd) @ blk["wqkv"].to(cd).reshape(self.dim, -1)
                   ).view(b_, s_, 3, self.heads, self.head_dim)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            kc = vc = None
            if cache is not None:
                kc, vc = cache["k"][i], cache["v"][i]
            att = kv_hook(kc, vc, q, k, v)
            proj = (att.to(cd).reshape(b_, s_, -1)
                    @ blk["wo"].to(cd).reshape(-1, self.dim))
            h = h + proj.to(h.dtype)
            x = _layernorm(h, blk["ln2_g"], blk["ln2_b"])
            # jax.nn.gelu defaults to the tanh approximation
            up = x.to(cd) @ blk["w1"].to(cd) + blk["b1"].to(cd)
            down = (F.gelu(up, approximate="tanh") @ blk["w2"].to(cd)
                    + blk["b2"].to(cd))
            h = h + down.to(h.dtype)
        return _layernorm(h, params["lnf_g"], params["lnf_b"])

    def _readout(self, params, rows):
        """Tied readout of ``rows`` (n, d) → f32 logits (n, vocab), in
        ``compute_dtype`` like the JAX einsum."""
        cd = self.compute_dtype
        embed = params.get("embed_cd")
        if embed is None:
            embed = params["embed"].to(cd)
        return (rows.to(cd) @ embed.t()).float()

    def _tokens(self, params, tokens):
        return torch.as_tensor(tokens, dtype=torch.long).to(
            params["embed"].device)

    def calibration_logits(self, params, tokens):
        """Last-position f32 logits (vocab,) of ONE prompt through the
        shared layer body; no cache is read or written."""
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
        logits = self._readout(params, h[0, length - 1:length])
        return cache, torch.argmax(logits[0])

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

    # -- entry points of later slices ----------------------------------------
    def init_paged_cache(self, num_blocks, block_size, dtype=None):
        _not_ported("the paged KV cache", 2)

    def paged_prefill(self, *args, **kwargs):
        _not_ported("paged prefill", 2)

    def paged_decode(self, *args, **kwargs):
        _not_ported("paged decode", 2)

    def prefill_chunk(self, *args, **kwargs):
        _not_ported("chunked prefill", 2)

    def paged_prefill_chunk(self, *args, **kwargs):
        _not_ported("paged chunked prefill", 2)

    def verify(self, *args, **kwargs):
        _not_ported("speculative verify", 2)

    def paged_verify(self, *args, **kwargs):
        _not_ported("paged speculative verify", 2)

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

    def decode_flops(self, slots, max_seq):
        """FLOPs of one decode step, counting every slot's attention at
        the full ``max_seq`` extent (an upper bound: the decode kernel
        reads only the valid keys)."""
        per_token = (self.layers
                     * self._per_token_layer_flops(float(max_seq))
                     + 2.0 * self.dim * self.vocab)
        return slots * per_token
