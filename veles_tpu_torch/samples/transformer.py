"""Decoder-only transformer LM: configurations, parameter layout and the
single-card training step.

Counterpart of :mod:`veles_tpu.samples.transformer`.  ``CONFIG``,
``TINY``, the shape table and ``init_params`` are the port's own copy:
they draw from the same ``numpy.random.default_rng(seed)`` in the same
order, so one seed gives bit-identical weights in both packages.

The training step (:func:`make_train_step`, :func:`build_train`) is the
JAX one: pre-LN blocks over the stacked layer axis (a Python loop in
place of ``lax.scan``), ``torch.utils.checkpoint`` on each block when
``remat`` (the counterpart of ``jax.checkpoint``), attention through
:func:`~veles_tpu_torch.ops.attention.flash_attention` (the flash
forward kernel, and the dq and dk/dv kernels in the backward, on the
card), a chunked cross-entropy that never holds the whole ``[B, S, V]``
logits, and SGD with momentum.

Over a :class:`~veles_tpu_torch.parallel.mesh.Mesh` (``build_train(mesh=
...)``) the step is DP × SP × TP as the JAX one is, each rank holding its
shards (:func:`param_specs`) and running on its slice of the global
tokens: batch rows over ``data``, positions over ``seq_axis`` (the
position table sliced at the rank's offset; each position's next-token
target sliced from the global tokens, so a shard's last position reads
the next shard's first token), heads and the MLP hidden over ``model``.
Attention is the ring over the flash kernels when the seq axis is
sharded (:func:`~veles_tpu_torch.parallel.ring.ring_attention`), else
the local flash attention on the rank's shard.  The Megatron placement:
``wqkv`` column-parallel by heads and ``wo`` row-parallel, ``w1``/``b1``
column-parallel and ``w2`` row-parallel, each pair entered through
:func:`~veles_tpu_torch.parallel.comm.copy_to_group` and left through
:func:`~veles_tpu_torch.parallel.comm.reduce_from_group` (``b2`` added
after the reduction).  The loss is the mean over all ``B·(S-1)``
targets: each rank's share of the sum over that count, the gradients
and the shares summed over the data and seq axes (on which every leaf
is replicated and the activations sharded) in one all-reduce a step;
over ``model`` a replicated leaf's gradient is already whole on every
rank (the copy's backward summed its input gradient).  The chunked
cross-entropy applies only when the seq axis is unsharded, as in the
JAX step.  ``python -m veles_tpu_torch.samples.transformer [--device
cpu]`` prints the tokens per second of the step.

Not ported: the ``engine.kernels=xla`` dense-attention hatch (refused by
:func:`make_train_step` and :func:`_attend`) and ``param_shapes`` (a
probe of the JAX planner): ROADMAP.md, 'Slices still to port', item 7.
"""

import argparse
import math
import time

import numpy
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from veles_tpu_torch.backends import check_kernels, resolve_device
from veles_tpu_torch.ops.attention import flash_attention

CONFIG = {
    "vocab": 32000, "dim": 1024, "heads": 16, "layers": 12,
    "mlp_ratio": 4, "seq_len": 2048,
}
TINY = {
    "vocab": 64, "dim": 32, "heads": 4, "layers": 2,
    "mlp_ratio": 2, "seq_len": 16,
}
#: SGD momentum of the training step, as in the JAX package
MOMENTUM = 0.9


def _shape_table(cfg):
    """The one parameter-layout table: ``name -> (shape, init)`` with
    ``init`` = ("randn", scale) | ("ones",) | ("zeros",).  Entry order
    is the RNG draw order of :func:`init_params`."""
    d, h, L = cfg["dim"], cfg["heads"], cfg["layers"]
    dh = d // h
    f = cfg["mlp_ratio"] * d
    sq = math.sqrt
    return {
        "embed": ((cfg["vocab"], d), ("randn", 0.02)),
        "pos": ((cfg["seq_len"], d), ("randn", 0.02)),
        "blocks": {
            "ln1_g": ((L, d), ("ones",)),
            "ln1_b": ((L, d), ("zeros",)),
            "wqkv": ((L, d, 3, h, dh), ("randn", 1 / sq(d))),
            "wo": ((L, h, dh, d), ("randn", 1 / sq(d) / sq(2 * L))),
            "ln2_g": ((L, d), ("ones",)),
            "ln2_b": ((L, d), ("zeros",)),
            "w1": ((L, d, f), ("randn", 1 / sq(d))),
            "b1": ((L, f), ("zeros",)),
            "w2": ((L, f, d), ("randn", 1 / sq(f) / sq(2 * L))),
            "b2": ((L, d), ("zeros",)),
        },
        "lnf_g": ((d,), ("ones",)),
        "lnf_b": ((d,), ("zeros",)),
    }


def _build_params(table, make):
    """Walk the shape table in INSERTION order (dict order is the RNG
    draw order)."""
    out = {}
    for name, entry in table.items():
        out[name] = (_build_params(entry, make)
                     if isinstance(entry, dict) else make(entry))
    return out


def init_params(cfg, seed=0, dtype=numpy.float32):
    """Stacked-block GPT params as a numpy tree (leading axis = layer)."""
    rng = numpy.random.default_rng(seed)

    def make(entry):
        shape, init = entry
        if init[0] == "randn":
            return (rng.standard_normal(shape)
                    * init[1]).astype(dtype)
        fn = numpy.ones if init[0] == "ones" else numpy.zeros
        return fn(shape, dtype)

    return _build_params(_shape_table(cfg), make)


def _not_ported(entry, item):
    raise NotImplementedError(
        "%s is not ported to veles_tpu_torch yet (ROADMAP.md, 'Slices "
        "still to port', item %s)" % (entry, item))


def param_specs(params, seq_axis="seq"):
    """The spec tree of the Megatron rules: ``wqkv`` sharded on its
    heads, ``wo`` on its heads in, ``w1``/``b1`` on the hidden out,
    ``w2`` on the hidden in (over ``model``); every other leaf
    replicated (``()``)."""
    from veles_tpu_torch.parallel.tp import column_parallel, shard_dim
    rules = {
        "wqkv": shard_dim(5, 3),      # heads: column-parallel attention
        "wo": shard_dim(4, 1),        # heads in: row-parallel
        "w1": column_parallel(3),
        "b1": column_parallel(2),
        "w2": shard_dim(3, 1),        # hidden in: row-parallel
    }
    return {key: (param_specs(leaf, seq_axis) if isinstance(leaf, dict)
                  else rules.get(key, ()))
            for key, leaf in params.items()}


class _Layout(object):
    """This rank's place in a mesh step: its rows and positions of the
    global tokens and the groups its collectives run over."""

    def __init__(self, mesh, seq_axis):
        from veles_tpu_torch.parallel.comm import (copy_to_group,
                                                   reduce_from_group)
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.n_seq = mesh.shape.get(seq_axis, 1) if seq_axis else 1
        self.model = mesh.group("model") if "model" in mesh.shape else None
        self.reduce = mesh.group("data", seq_axis)
        self._enter, self._leave = copy_to_group, reduce_from_group

    def enter(self, x):
        """Into a column-parallel product (Megatron's ``f``)."""
        return x if self.model is None else self._enter(x, self.model)

    def leave(self, x):
        """Out of a row-parallel product (Megatron's ``g``)."""
        return x if self.model is None else self._leave(x, self.model)

    def rows(self, tokens):
        """``(local tokens, targets, valid, offset)``: this rank's block
        of the global ``tokens`` [B, S], each position's next token (0
        and invalid past the sequence's end) and its first position."""
        b, s = tokens.shape
        parts = (self.mesh.shape.get("data", 1), self.n_seq)
        if b % parts[0] or s % parts[1]:
            raise ValueError("tokens %s do not split over data x seq %s"
                             % (tuple(tokens.shape), parts))
        bl, sl = b // parts[0], s // parts[1]
        b0 = self.mesh.index("data") * bl
        off = (self.mesh.index(self.seq_axis) if self.seq_axis else 0) * sl
        rows = tokens[b0:b0 + bl]
        targets = torch.zeros((bl, sl), dtype=tokens.dtype,
                              device=tokens.device)
        nxt = rows[:, off + 1:off + sl + 1]
        targets[:, :nxt.shape[1]] = nxt
        valid = torch.arange(off, off + sl, device=tokens.device) < s - 1
        return rows[:, off:off + sl], targets, valid, off


def _layernorm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * g + b


def _attend(q, k, v, layout=None):
    """Attention of a block: the ring over the flash kernels when the
    seq axis is sharded, else the flash kernels on the rank's shard
    (start-aligned causal)."""
    check_kernels("the transformer's dense-attention hatch")
    if layout is not None and layout.n_seq > 1:
        from veles_tpu_torch.parallel.ring import ring_attention
        return ring_attention(q, k, v, layout.mesh, causal=True,
                              seq_axis=layout.seq_axis)
    return flash_attention(q, k, v, True)


def _block(h, blk, compute_dtype, layout=None):
    """One pre-LN transformer block; wqkv [d,3,H,dh], wo [H,dh,d] (this
    rank's heads and hidden units under a mesh).

    The JAX block's mixed-precision discipline: the residual stream
    stays in the params' dtype, every matmul operand (biases included)
    is cast to ``compute_dtype`` and its result stays there, and GELU is
    the tanh approximation (``jax.nn.gelu``'s default)."""
    cd = compute_dtype
    B, S, d = h.shape
    enter, leave = ((layout.enter, layout.leave) if layout is not None
                    else (lambda x: x, lambda x: x))
    x = enter(_layernorm(h, blk["ln1_g"], blk["ln1_b"]))
    qkv = (x.to(cd) @ blk["wqkv"].to(cd).reshape(d, -1)).view(
        B, S, *blk["wqkv"].shape[1:])
    # strided views of one (B, S, 3, H, dh) projection, as the kernels take
    att = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], layout)
    proj = leave(att.to(cd).reshape(B, S, -1)
                 @ blk["wo"].to(cd).reshape(-1, d))
    h = h + proj.to(h.dtype)
    x = enter(_layernorm(h, blk["ln2_g"], blk["ln2_b"]))
    up = x.to(cd) @ blk["w1"].to(cd) + blk["b1"].to(cd)
    down = leave(F.gelu(up, approximate="tanh") @ blk["w2"].to(cd))
    down = down + blk["b2"].to(cd)
    return h + down.to(h.dtype)


def hidden_fn(params, tokens, compute_dtype=torch.bfloat16, remat=True,
              layout=None, offset=0):
    """tokens [B, S] (int64 on the params' device; this rank's block
    under a mesh ``layout``, its first position at ``offset``) →
    final-LN hidden states [B, S, d]."""
    h = (params["embed"][tokens]
         + params["pos"][offset:offset + tokens.shape[1]])
    # one unbind per stacked leaf: its backward stacks the layers' grads
    # once, where indexing layer by layer would add 12 full-size zeros
    layers = [dict(zip(params["blocks"], leaves)) for leaves in zip(
        *(leaf.unbind(0) for leaf in params["blocks"].values()))]
    for blk in layers:
        if remat:
            h = checkpoint(_block, h, blk, compute_dtype, layout,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            h = _block(h, blk, compute_dtype, layout)
    return _layernorm(h, params["lnf_g"], params["lnf_b"])


def apply_fn(params, tokens, compute_dtype=torch.bfloat16, remat=True):
    """tokens [B, S] → logits [B, S, V] in ``compute_dtype`` (the
    weight-tied readout, bf16 by design as in the JAX package)."""
    h = hidden_fn(params, tokens, compute_dtype, remat)
    return h.to(compute_dtype) @ params["embed"].to(compute_dtype).t()


def _chunk_nll_sum(hc, tc, mask, emb, compute_dtype):
    """Summed NLL of one sequence chunk: the readout in
    ``compute_dtype``, the softmax arithmetic in f32."""
    logits = (hc.to(compute_dtype) @ emb.to(compute_dtype).t()).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, tc[..., None])[..., 0]
    return ((lse - picked) * mask).sum()


def _as_tokens(tokens, device):
    """Token ids (numpy, list or tensor) as int64 on ``device``."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.as_tensor(numpy.asarray(tokens))
    return tokens.to(device=device, dtype=torch.long)


def make_train_step(cfg, mesh=None, seq_axis="seq", lr=3e-4,
                    compute_dtype=torch.bfloat16, remat=True, ce_chunk=128):
    """``step(params, velocity, tokens) -> (params, velocity, {"loss"})``:
    next-token cross-entropy, its gradient, and the SGD+momentum update
    ``v ← 0.9·v − lr·g; p ← p + v`` on every leaf.

    ``ce_chunk``: the loss is summed over sequence chunks of that many
    positions (padded to a multiple, the pad masked), each under
    ``checkpoint`` so the backward recomputes the chunk's logits and
    only ``[B, chunk, V]`` of them is ever live; the mean is over
    ``B·(S-1)``.  ``ce_chunk=0`` is the plain full-logits path, and so
    is a mesh whose seq axis is sharded.

    ``cfg`` is taken for the JAX package's signature: the widths come
    from the params.  ``params`` and ``velocity`` are nested dicts of
    tensors (as :func:`build_train` makes them: this rank's shards under
    ``mesh``) and are updated IN PLACE under ``no_grad`` — the port's
    stand-in for the JAX step's donated buffers; the returned trees are
    the same objects.  ``tokens`` is the global int array [B, S] (numpy
    or tensor) on every rank."""
    check_kernels("the transformer's dense-attention hatch")
    kw = dict(compute_dtype=compute_dtype, remat=remat)
    layout = _Layout(mesh, seq_axis) if mesh is not None else None
    use_chunks = bool(ce_chunk) and (layout is None or layout.n_seq <= 1)

    def chunked_nll(hs, targets, emb):
        batch, n, _d = hs.shape
        chunk = min(ce_chunk, n)
        k = -(-n // chunk)
        pad = k * chunk - n
        hs = F.pad(hs, (0, 0, 0, pad))
        tg = F.pad(targets, (0, pad))
        valid = (torch.arange(k * chunk, device=hs.device) < n).reshape(
            k, chunk)
        total = torch.zeros((), dtype=torch.float32, device=hs.device)
        for i in range(k):
            cut = slice(i * chunk, (i + 1) * chunk)
            total = total + checkpoint(
                _chunk_nll_sum, hs[:, cut], tg[:, cut], valid[i], emb,
                compute_dtype, use_reentrant=False,
                preserve_rng_state=False)
        return total

    def loss_fn(params, tokens):
        emb = params["embed"]
        if layout is None:
            targets = tokens[:, 1:]
            if not use_chunks:
                logits = apply_fn(params, tokens, **kw)
                logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
                return -logp.gather(-1, targets[..., None]).mean()
            hs = hidden_fn(params, tokens, **kw)[:, :-1]
            return chunked_nll(hs, targets, emb) / (hs.shape[0]
                                                    * hs.shape[1])
        # this rank's share of the global mean over B·(S-1) targets
        count = tokens.shape[0] * (tokens.shape[1] - 1)
        local, targets, valid, offset = layout.rows(tokens)
        h = hidden_fn(params, local, layout=layout, offset=offset, **kw)
        if use_chunks:
            return chunked_nll(h[:, :-1], local[:, 1:], emb) / count
        logits = h.to(compute_dtype) @ emb.to(compute_dtype).t()
        logp = torch.log_softmax(logits.float(), dim=-1)
        picked = logp.gather(-1, targets[..., None])[..., 0]
        return -(picked * valid).sum() / count

    def step(params, velocity, tokens):
        leaves, vels = _leaves(params), _leaves(velocity)
        for leaf in leaves:
            leaf.requires_grad_(True)
        tokens = _as_tokens(tokens, leaves[0].device)
        loss = loss_fn(params, tokens)
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if layout is not None and layout.reduce is not None:
            grads, loss = _reduce_shares(grads, loss, layout.reduce)
        with torch.no_grad():
            for p, v, g in zip(leaves, vels, grads):
                v.mul_(MOMENTUM).sub_(lr * g)
                p.add_(v)
        return params, velocity, {"loss": loss}

    return step


def _reduce_shares(grads, loss, group):
    """The gradients and the loss share (or None) summed over ``group``:
    one all-reduce of one flat buffer."""
    from veles_tpu_torch.parallel.comm import all_reduce
    extra = [] if loss is None else [loss.reshape(1)]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads] + extra),
                      group)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return out, None if loss is None else flat[offset]


def _leaves(tree):
    out = []
    for leaf in tree.values():
        out.extend(_leaves(leaf) if isinstance(leaf, dict) else [leaf])
    return out


def _shard_tree(tree, specs, mesh):
    from veles_tpu_torch.parallel.mesh import shard
    return {key: (_shard_tree(leaf, specs[key], mesh)
                  if isinstance(leaf, dict)
                  else shard(leaf, specs[key], mesh))
            for key, leaf in tree.items()}


def build_train(cfg=None, mesh=None, seq_axis="seq", lr=3e-4,
                compute_dtype=torch.bfloat16, remat=True, seed=0,
                ce_chunk=128, device=None):
    """``(params, velocity, step)``: f32 params from :func:`init_params`
    (``seed``) and zero velocity as tensors on ``device`` (``cuda`` by
    default; raises without a card unless ``"cpu"`` is asked for), and
    the step of :func:`make_train_step`, which updates both in place.
    With ``mesh`` each rank holds its shards of both trees
    (:func:`param_specs`)."""
    from veles_tpu_torch.gen.model import params_from_numpy
    cfg = cfg or CONFIG
    device = resolve_device(device)
    host = init_params(cfg, seed=seed)
    if mesh is not None:
        host = _shard_tree(host, param_specs(host, seq_axis), mesh)
    params = params_from_numpy(host, device)
    velocity = params_from_numpy(
        _build_params(host, numpy.zeros_like), device)
    step = make_train_step(cfg, mesh=mesh, seq_axis=seq_axis, lr=lr,
                           compute_dtype=compute_dtype, remat=remat,
                           ce_chunk=ce_chunk)
    return params, velocity, step


def train_step_flops(cfg, batch):
    """Analytic FLOPs of one LM train step (forward + backward ≈ 3× the
    forward matmuls, the standard MFU convention; remat's forward
    recompute is not counted as useful work).  Attention is counted
    causal-discounted (each token attends to ~S/2 keys)."""
    d, L, S, V = cfg["dim"], cfg["layers"], cfg["seq_len"], cfg["vocab"]
    f = cfg["mlp_ratio"] * d
    per_token_layer = (
        2.0 * d * 3 * d          # qkv projection
        + 2.0 * S * d            # QK^T + AV, causal-averaged S/2 each
        + 2.0 * d * d            # output projection
        + 4.0 * d * f)           # mlp up + down
    per_token = L * per_token_layer + 2.0 * d * V   # tied readout
    return 3.0 * batch * S * per_token


def synthetic_tokens(cfg, batch, seed=0):
    rng = numpy.random.default_rng(seed)
    return rng.integers(0, cfg["vocab"],
                        (batch, cfg["seq_len"])).astype(numpy.int32)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark(cfg=None, batch=8, steps=5, device=None):
    """Tokens/sec of the train step: one warm-up step, then ``steps``
    timed ones on the host clock, ended by a device synchronise."""
    cfg = cfg or CONFIG
    params, vel, step = build_train(cfg, device=device)
    dev = params["embed"].device
    tokens = _as_tokens(synthetic_tokens(cfg, batch), dev)
    params, vel, _m = step(params, vel, tokens)
    _sync(dev)
    tic = time.perf_counter()
    for _ in range(steps):
        params, vel, _m = step(params, vel, tokens)
    _sync(dev)
    return steps * batch * cfg["seq_len"] / (time.perf_counter() - tic)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.samples.transformer",
        description="Tokens/sec of the transformer LM train step at batch "
        "8: CONFIG on the card, TINY on the CPU.")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    device = resolve_device(parser.parse_args(argv).device)
    name, cfg = (("tiny", TINY) if device.type == "cpu"
                 else ("config", CONFIG))
    rate = benchmark(cfg, device=device)
    print("LM train step (%s, %s): %.0f tokens/sec" % (name, device, rate))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
