"""Sequence parallelism: ring attention and Ulysses all-to-all.
Counterpart of :mod:`veles_tpu.parallel.ring`.

The functions here take THIS RANK's shards, [B, S/n, H, D] slices of the
``(batch_axis, seq_axis, head_axis, None)`` layout, where the JAX
functions take global arrays and shard them in ``shard_map``; they
return this rank's slice of the output.

* :func:`ring_attention` keeps the rank's query shard and moves every
  key/value shard past it around the seq group, one
  ``batch_isend_irecv`` a hop (:func:`~veles_tpu_torch.parallel.comm
  .ring_shift`).  ``use_flash=True`` is ring-FLASH: each hop's block is
  one launch of the flash forward kernel at the GLOBAL causal offsets
  (:func:`forward_hop`), the hops merged by the stable two-softmax
  rule; the backward is a second ring (:func:`backward_hop`: the dq
  and dk/dv kernels against the global ``lse``, ``delta`` computed
  once), in which the dk/dv accumulators travel with their blocks and
  come home after the last hop.  ``use_flash=False`` is the dense
  online-softmax body with plain autograd, the equivalence oracle.
* :func:`ulysses_attention`: two all-to-alls re-shard seq-sharded
  activations to head-sharded ones around the local flash attention.

A hop whose keys all lie after its queries is fully masked under
causal masking; there the kernel's ``o`` and ``lse`` differ from the
dense reference's (the kernel keeps the masked score as a row's
``lse``, the reference gives the mean of ``v``), and both weigh 0 in the
merge, so only merged results compare.
"""

import math

import torch

from veles_tpu_torch.ops import attention
from veles_tpu_torch.parallel.comm import (all_to_all_grad, ring_shift,
                                           ring_shift_grad)

NEG_INF = -1e30


def mha_reference(q, k, v, causal=False, q_offset=0, k_offset=0):
    """Dense multi-head attention, the golden reference: q [B, Sq, H, D],
    k/v [B, Sk, H, D] → [B, Sq, H, D]; ``q_offset``/``k_offset`` are the
    global positions of element 0."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _block_update(carry, q, k_blk, v_blk, mask):
    """Online-softmax accumulation of one K/V block."""
    o, m, l = carry
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_blk.float()) * scale
    scores = torch.where(mask, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    # fully masked rows: p exactly zero (exp(NEG_INF - NEG_INF) = 1)
    p = torch.where(mask, p, 0.0)
    l = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v_blk.dtype), v_blk)
    o = o * correction.transpose(1, 2)[..., None] + pv
    return o, m_new, l


def _ring_attention_local(q, k, v, group, n, idx, causal):
    """The dense oracle: online softmax over the hops, k/v moved by the
    differentiable ring shift, plain autograd."""
    b, s_local, h, _d = q.shape
    qpos = idx * s_local + torch.arange(s_local, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_local), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    k_cur, v_cur = k, v
    for t in range(n):
        # after t shifts, this rank holds block (idx - t) mod n
        blk = (idx - t) % n
        kpos = blk * s_local + torch.arange(s_local, device=q.device)
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
        else:
            mask = torch.ones((s_local, s_local), dtype=torch.bool,
                              device=q.device)
        mask = mask[None, None].expand(b, h, s_local, s_local)
        o, m, l = _block_update((o, m, l), q, k_cur, v_cur, mask)
        if t < n - 1:
            k_cur = ring_shift_grad(k_cur, group)
            v_cur = ring_shift_grad(v_cur, group)
    l = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (o / l).to(q.dtype)


# -- ring-FLASH: the flash kernels a hop, a hand-written backward ring -------

def forward_hop(q, k_blk, v_blk, o, lse, causal, q_offset, k_offset):
    """Merge one hop into the running ``(o, lse)`` (f32 [B, S, H, D] and
    [B, H, S]): the flash forward of ``q`` against the block at the
    global offsets, weighed by the stable two-softmax rule."""
    o_i, lse_i = attention._flash_fwd(q, k_blk, v_blk, causal, q_offset,
                                      k_offset)
    m = torch.maximum(lse, lse_i)
    # a fully masked hop's lse_i is ~NEG_INF: its weight is exactly 0
    e_prev = torch.exp(lse - m)
    e_new = torch.exp(lse_i - m)
    denom = torch.clamp(e_prev + e_new, min=1e-30)
    w_prev = (e_prev / denom).transpose(1, 2)[..., None]
    w_new = (e_new / denom).transpose(1, 2)[..., None]
    o = o * w_prev + o_i.float() * w_new
    return o, m + torch.log(denom)


def backward_hop(q, k_blk, v_blk, o, lse, do, delta, causal, q_offset,
                 k_offset, dq, dk, dv):
    """Add one hop's ``(dq, dk_blk, dv_blk)`` to the f32 accumulators:
    the dq and dk/dv kernels against the GLOBAL ``(o, lse)`` (the flash
    identity ``p = exp(s - lse)`` makes each hop's share exact)."""
    dq_i, dk_i, dv_i = attention._flash_bwd(
        q, k_blk, v_blk, o, lse, do, causal, q_offset, k_offset,
        delta=delta)
    return dq + dq_i.float(), dk + dk_i.float(), dv + dv_i.float()


def ring_flash_forward(q, k, v, group, n, idx, causal):
    """The forward ring: ``(o, lse)`` after ``n`` hops (k/v shifted
    between hops, ``n - 1`` shifts)."""
    b, s_local, h, _d = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s_local), NEG_INF, dtype=torch.float32,
                     device=q.device)
    k_cur, v_cur = k, v
    for t in range(n):
        blk = (idx - t) % n
        o, lse = forward_hop(q, k_cur, v_cur, o, lse, causal,
                             idx * s_local, blk * s_local)
        if t < n - 1:
            k_cur, v_cur = ring_shift([k_cur, v_cur], group)
    return o.to(q.dtype), lse


def ring_flash_backward(q, k, v, o, lse, do, group, n, idx, causal):
    """The backward ring: each hop adds this rank's share to the dk/dv
    of the block it holds, which then moves on with the block; after
    the last hop one more shift brings every block's dk/dv home."""
    s_local = q.shape[1]
    delta = attention._delta(o, do)          # hop-invariant: once
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for t in range(n):
        blk = (idx - t) % n
        dq, dk, dv = backward_hop(q, k_cur, v_cur, o, lse, do, delta,
                                  causal, idx * s_local, blk * s_local,
                                  dq, dk, dv)
        if t < n - 1:
            k_cur, v_cur, dk, dv = ring_shift([k_cur, v_cur, dk, dv], group)
        elif n > 1:
            dk, dv = ring_shift([dk, dv], group)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The ring-flash forward saving ``(q, k, v, o, lse)``; its backward
    is :func:`ring_flash_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, group, n, idx, causal):
        o, lse = ring_flash_forward(q, k, v, group, n, idx, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring = (group, n, idx, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ring_flash_backward(q, k, v, o, lse, do, *ctx.ring)
        return dq, dk, dv, None, None, None, None


def _seq_ring(mesh, seq_axis):
    n = mesh.shape.get(seq_axis, 1)
    return mesh.group(seq_axis), n, mesh.index(seq_axis)


def ring_attention(q, k, v, mesh, causal=False, seq_axis="seq",
                   batch_axis="data", head_axis=None, use_flash=True):
    """Exact attention over a ``seq``-sharded sequence; q/k/v and the
    result are this rank's shards (see the module).  ``batch_axis`` and
    ``head_axis`` name the axes that shard B and H (their shards are
    independent, so only the seq group takes part)."""
    del batch_axis, head_axis
    group, n, idx = _seq_ring(mesh, seq_axis)
    if use_flash:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return _RingFlash.apply(q, k, v, group, n, idx, causal)
        return ring_flash_forward(q, k, v, group, n, idx, causal)[0]
    return _ring_attention_local(q, k, v, group, n, idx, causal)


def _scatter_heads(x, group, n):
    """[B, S/n, H, D] → [B, S, H/n, D]: head chunk i to rank i, the
    received sequence chunks concatenated in rank order."""
    b, s, h, d = x.shape
    parts = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    out = all_to_all_grad(parts, group)          # (n_src, B, S/n, H/n, D)
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _gather_heads(x, group, n):
    """[B, S, H/n, D] → [B, S/n, H, D], the inverse exchange."""
    b, s, h, d = x.shape
    parts = x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4)
    out = all_to_all_grad(parts, group)          # (n_src, B, S/n, H/n, D)
    return out.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


def ulysses_attention(q, k, v, mesh, causal=False, seq_axis="seq",
                      batch_axis="data"):
    """All-to-all sequence parallelism (Ulysses) on this rank's
    [B, S/n, H, D] shards.  Requires ``H % mesh.shape[seq_axis] == 0``."""
    del batch_axis
    group, n, _idx = _seq_ring(mesh, seq_axis)
    if q.shape[2] % n:
        raise ValueError(
            "ulysses needs heads (%d) divisible by seq axis (%d)"
            % (q.shape[2], n))
    if group is None:
        return attention.flash_attention(q, k, v, causal)
    qh, kh, vh = (_scatter_heads(t, group, n) for t in (q, k, v))
    out = attention.flash_attention(qh, kh, vh, causal)
    return _gather_heads(out, group, n)
