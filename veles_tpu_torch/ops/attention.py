"""Attention for serving and training: the flash forward, the flash
backward pair, the decode kernel and its paged twin, each beside its
plain PyTorch version.

Counterpart of :mod:`veles_tpu.ops.attention`.  The public functions
keep the JAX layout ``(batch, seq, heads, head_dim)`` and the JAX
semantics: the START-aligned causal mask (key ``k_offset + j`` is
visible to query ``q_offset + i`` iff ``k_offset + j <= q_offset +
i``), masked scores of ``NEG_INF = -1e30`` and a softmax scale of
``1/sqrt(head_dim)``.

Dispatch is by where the tensors lie: CPU tensors take the plain
version (``_mha_ref``, ``_bwd_ref``, ``_decode_ref``, ``_verify_ref``,
``_paged_decode_ref``); CUDA tensors launch the hand-written kernel
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, ``csrc/decode_attn.cu``,
whose second entry is the paged kernel) or raise.  There is no
fallback from a CUDA tensor to the plain version.  The flash kernels'
C entries pick their body by the dtype: bf16 runs the tensor-core
bodies (``*_kernel_tc``: bf16 ``mma.sync`` with f32 sums), f32 the FMA
bodies.  The decode kernels split each (batch, head) row's keys over a
cluster of :func:`decode_split` blocks (:func:`key_range` gives a rank's
share).  ``launches`` counts kernel launches by kernel name; only a
launch adds to it.

:func:`flash_attention` is differentiable: under autograd it runs
through :class:`_FlashAttention`, whose backward is the dq and dk/dv
kernel pair (the counterpart of the JAX ``custom_vjp``).
"""

import ctypes

import numpy
import torch

from veles_tpu_torch.ops import cost
from veles_tpu_torch.ops.util import check_status, on_gpu, stream_handle

NEG_INF = -1e30
#: the kernels hold head_dim in registers in 32-wide pieces
MAX_HEAD_DIM = 128
#: decode / verify query rows per (batch, head) the kernel takes
MAX_QUERY_ROWS = 8
#: keys a warp of csrc/decode_attn.cu takes at a time: a rank's share of
#: a row is a whole number of chunks
DECODE_CHUNK = 32
#: the H100's SMs, and the portable cluster size that bounds the split
_SMS = 132
_MAX_SPLIT = 8

#: kernel name -> launches since the last reset_launches()
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode_attn": 0, "paged_decode_attn": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: kernel name -> (library = csrc source, C symbol, ctypes argtypes)
_ARGTYPES = {
    "flash_fwd": ("flash_fwd", "veles_flash_fwd",
                  [_P] * 5 + [_I] * 6 + [_L] * 9 + [_I] * 3
                  + [ctypes.c_float, _P]),
    "flash_bwd_dq": ("flash_bwd", "veles_flash_bwd_dq",
                     [_P] * 7 + [_I] * 6 + [_L] * 12 + [_I] * 3
                     + [ctypes.c_float, _P]),
    "flash_bwd_dkv": ("flash_bwd", "veles_flash_bwd_dkv",
                      [_P] * 8 + [_I] * 6 + [_L] * 12 + [_I] * 3
                      + [ctypes.c_float, _P]),
    "decode_attn": ("decode_attn", "veles_decode_attn",
                    [_P] * 5 + [_I] * 6 + [_L] * 9 + [_I] * 2
                    + [ctypes.c_float, _I, _P]),
    "paged_decode_attn": ("decode_attn", "veles_paged_decode_attn",
                          [_P] * 6 + [_I] * 7 + [_L] * 10 + [_I] * 2
                          + [ctypes.c_float, _I, _P]),
}
_entries = {}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _entry(name):
    """The C entry of kernel ``name`` with its ctypes signature,
    building the library at first use."""
    fn = _entries.get(name)
    if fn is None:
        from veles_tpu_torch.ops import build
        source, symbol, argtypes = _ARGTYPES[name]
        fn = getattr(build.library(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _check_bshd(name, *tensors):
    """Validate the kernels' operand contract before any pointer is
    taken: 4-D (b, s, h, d), one supported dtype, unit stride on d."""
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError("%s kernel takes float32 or bfloat16, got %s"
                        % (name, dtype))
    for t in tensors:
        if t.dim() != 4:
            raise ValueError("%s expects (b, s, h, d) tensors, got shape "
                             "%s" % (name, tuple(t.shape)))
        if t.dtype != dtype:
            raise TypeError("%s operands differ in dtype: %s vs %s"
                            % (name, t.dtype, dtype))
        if t.stride(-1) != 1:
            raise ValueError("%s needs a unit stride on head_dim" % name)
        if t.device != tensors[0].device:
            raise ValueError("%s operands on different devices" % name)
    b, _s, h, d = tensors[0].shape
    for t in tensors[1:]:
        if t.shape[0] != b or t.shape[2] != h or t.shape[3] != d:
            raise ValueError("%s operand shapes disagree: %s"
                             % (name, [tuple(x.shape) for x in tensors]))
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError("%s kernel takes head_dim 1..%d, got %d"
                         % (name, MAX_HEAD_DIM, d))
    return dtype


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


# -- plain versions (the CPU path and the kernels' references) -------------

def _mha_ref(q, k, v, causal, q_offset=0, k_offset=0):
    """Dense attention, mirroring ``_mha_jnp``: f32 scores, start-aligned
    causal mask, logsumexp softmax; returns ``(o, lse)`` with ``o`` in
    q's dtype and ``lse`` (b, h, sq) f32."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / (d ** 0.5)
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        dev = scores.device
        mask = ((k_offset + torch.arange(sk, device=dev))[None, :]
                <= (q_offset + torch.arange(sq, device=dev))[:, None])
        scores = torch.where(mask, scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype), lse


def _delta(o, do):
    """``rowsum(do ⊙ o)`` in f32, (b, h, sq): the flash backward's
    preprocessing, which the JAX package also runs outside its kernels."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(), o.float())


def _bwd_ref(q, k, v, o, lse, do, causal, q_offset=0, k_offset=0,
             delta=None, block_k=128):
    """Flash backward ``(dq, dk, dv)`` from the saved ``(q, k, v, o,
    lse)``, mirroring ``_bwd_blockwise``: K blocks of ``block_k`` keys,
    probabilities recomputed from ``lse``, extended with the
    start-aligned ``q_offset``/``k_offset`` of ``_flash_bwd``.  Matmul
    operands keep the inputs' dtype (``do`` is cast to q's; ``p`` before
    ``pᵀ·do`` and ``ds`` before ``ds·k`` and ``dsᵀ·q`` are rounded to
    it) and every product sums in f32, as the TPU kernels do; the
    softmax arithmetic is f32."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    if delta is None:
        delta = _delta(o, do)
    mm = q.dtype
    q32 = q.float()
    do32 = do.to(mm).float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    dq = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, sk, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].float()
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, kb) * scale
        p = torch.exp(scores - lse[..., None])
        if causal:
            k_pos = k_offset + k0 + torch.arange(kb.shape[1],
                                                 device=q.device)
            p = torch.where(k_pos[None, :] <= q_pos[:, None], p, 0.0)
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p.to(mm).float(), do32))
        dp = torch.einsum("bqhd,bkhd->bhqk", do32, vb)
        ds = (p * (dp - delta[..., None]) * scale).to(mm).float()
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, q32))
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


def _masked_ref(q, k, v, limits):
    """Dense attention of q (b, nq, h, d) against the keys of each row
    below ``limits`` (b, nq)."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / (d ** 0.5)
    keys = torch.arange(k.shape[1], device=k.device)
    mask = keys[None, None, None, :] < limits[:, None, :, None]
    scores = torch.where(mask, scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def _decode_ref(q, k, v, lengths):
    """Mirror of ``_decode_jnp``: every query row of sequence ``i``
    reads the first ``lengths[i]`` keys."""
    limits = lengths.long()[:, None].expand(q.shape[0], q.shape[1])
    return _masked_ref(q, k, v, limits)


def _verify_ref(q, k, v, lengths):
    """Mirror of ``_verify_jnp``: row ``j`` of sequence ``i`` reads the
    keys ``< lengths[i] + j`` (the staggered verify mask)."""
    rows = torch.arange(q.shape[1], device=q.device)
    limits = lengths.long()[:, None] + rows[None, :]
    return _masked_ref(q, k, v, limits)


def _gather_pool(pool, tables):
    """(num_blocks, BS, h, d) pool + (b, max_blocks) int32 tables → the
    (b, max_blocks·BS, h, d) contiguous copy of each sequence, as
    ``veles_tpu.ops.attention._gather_pool``.  Entries past a sequence's
    allocation point at the trash block 0, whose keys lie past
    ``lengths`` and are masked."""
    g = pool[tables.long()]                # (b, mb, BS, h, d)
    b, mb, bs = g.shape[:3]
    return g.reshape(b, mb * bs, g.shape[3], g.shape[4])


def _paged_decode_ref(q, k_pool, v_pool, tables, lengths, row_step=0):
    """Mirror of ``_paged_decode_jnp`` (``row_step=0``) and of the dense
    path of ``paged_verify_attention`` (``row_step=1``): gather the pool
    through the tables into the contiguous layout, then run
    :func:`_decode_ref` or :func:`_verify_ref`."""
    ref = _verify_ref if row_step else _decode_ref
    return ref(q, _gather_pool(k_pool, tables), _gather_pool(v_pool, tables),
               lengths)


# -- kernel wrappers --------------------------------------------------------

def _flash_fwd_cuda(q, k, v, causal, q_offset, k_offset):
    dtype = _check_bshd("flash_fwd", q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if v.shape[1] != sk:
        raise ValueError("flash_fwd: k has %d rows, v %d" % (sk, v.shape[1]))
    o = torch.empty((b, sq, h, d), dtype=dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    status = _entry("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _DTYPE_CODES[dtype], b, h, sq, sk, d,
        *_strides(q), *_strides(k), *_strides(v),
        int(bool(causal)), int(q_offset), int(k_offset),
        1.0 / (d ** 0.5), stream_handle(q.device))
    check_status("flash_fwd", status)
    launches["flash_fwd"] += 1
    return o, lse


def _pairs(q, k, causal, q_offset, k_offset):
    """(query, key) pairs a (b, s, h, d) attention computes for each
    (b, h): every pair, or under the causal mask the keys at or before
    each query's position."""
    sq, sk = q.shape[1], k.shape[1]
    if not causal:
        return sq * sk
    return int(numpy.clip(numpy.arange(sq)
                          + (int(q_offset) - int(k_offset) + 1),
                          0, sk).sum())


def _tally_flash(q, k, v, causal, q_offset, k_offset, products, nbytes):
    """The cost of a flash launch: ``products`` products of 2·d flops
    per visible (query, key) pair and (b, h) (the forward's QKᵀ and PV
    are two; the dq kernel's S, dP and dS·K three; the dk/dv kernel's
    S, dP, dV and dK four), and ``nbytes``."""
    b, _, h, d = q.shape
    cost.add(2.0 * products * d * b * h
             * _pairs(q, k, causal, q_offset, k_offset), nbytes)


def _flash_fwd(q, k, v, causal=False, q_offset=0, k_offset=0):
    """``(o, lse)`` of attention over (b, s, h, d) tensors: the kernel on
    CUDA tensors, :func:`_mha_ref` on CPU tensors.  ``q_offset`` and
    ``k_offset`` are the global causal positions of element 0."""
    # q, k and v read once; o and the f32 lse (b, h, sq) written
    b, sq, h, _ = q.shape
    _tally_flash(q, k, v, causal, q_offset, k_offset, 2,
                 2 * cost.nbytes(q) + cost.nbytes(k, v) + 4 * b * h * sq)
    if on_gpu(q, k, v):
        return _flash_fwd_cuda(q, k, v, causal, int(q_offset),
                               int(k_offset))
    return _mha_ref(q, k, v, causal, int(q_offset), int(k_offset))


def _bwd_check(q, k, v, do, lse, delta):
    dtype = _check_bshd("flash_bwd", q, k, v, do)
    b, sq, h, _d = q.shape
    if v.shape[1] != k.shape[1] or do.shape[1] != sq:
        raise ValueError("flash_bwd: q/do rows %d/%d, k/v rows %d/%d"
                         % (sq, do.shape[1], k.shape[1], v.shape[1]))
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError("flash_bwd needs a contiguous float32 %s of "
                             "shape %s on %s" % (name, (b, h, sq), q.device))
    return dtype


def _bwd_dq_cuda(q, k, v, do, lse, delta, causal, q_offset, k_offset):
    """dq by the dq kernel; ``do`` in q's dtype, ``lse``/``delta``
    contiguous (b, h, sq) f32."""
    dtype = _bwd_check(q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    dq = torch.empty((b, sq, h, d), dtype=dtype, device=q.device)
    status = _entry("flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _DTYPE_CODES[dtype],
        b, h, sq, k.shape[1], d, *_strides(q), *_strides(k), *_strides(v),
        *_strides(do), int(bool(causal)), int(q_offset), int(k_offset),
        1.0 / (d ** 0.5), stream_handle(q.device))
    check_status("flash_bwd_dq", status)
    launches["flash_bwd_dq"] += 1
    return dq


def _bwd_dkv_cuda(q, k, v, do, lse, delta, causal, q_offset, k_offset):
    """(dk, dv) by the dk/dv kernel; operands as :func:`_bwd_dq_cuda`."""
    dtype = _bwd_check(q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dk = torch.empty((b, sk, h, d), dtype=dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=dtype, device=q.device)
    status = _entry("flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODES[dtype], b, h, sq, sk, d, *_strides(q), *_strides(k),
        *_strides(v), *_strides(do), int(bool(causal)), int(q_offset),
        int(k_offset), 1.0 / (d ** 0.5), stream_handle(q.device))
    check_status("flash_bwd_dkv", status)
    launches["flash_bwd_dkv"] += 1
    return dk, dv


def _flash_bwd(q, k, v, o, lse, do, causal=False, q_offset=0, k_offset=0,
               delta=None):
    """``(dq, dk, dv)`` of attention from the forward's ``(q, k, v, o,
    lse)`` and the output gradient ``do``: the dq and dk/dv kernels on
    CUDA tensors, :func:`_bwd_ref` on CPU tensors.  ``delta`` (b, h, sq)
    f32 may be passed precomputed; otherwise it is ``rowsum(do ⊙ o)``.
    ``do`` is cast to q's dtype, as the JAX function does."""
    if delta is None:
        delta = _delta(o, do)
    do = do.to(q.dtype)
    # each kernel reads q, k, v, do, lse and delta once; dq writes a
    # q-sized output, dk/dv two k-sized ones
    read = cost.nbytes(q, k, v, do, lse, delta)
    _tally_flash(q, k, v, causal, q_offset, k_offset, 3,
                 read + cost.nbytes(q))
    _tally_flash(q, k, v, causal, q_offset, k_offset, 4,
                 read + cost.nbytes(k, v))
    if on_gpu(q, k, v, o, lse, do, delta):
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = delta.contiguous()
        args = (q, k, v, do, lse, delta, causal, int(q_offset),
                int(k_offset))
        dq = _bwd_dq_cuda(*args)
        dk, dv = _bwd_dkv_cuda(*args)
        return dq, dk, dv
    return _bwd_ref(q, k, v, o, lse, do, causal, int(q_offset),
                    int(k_offset), delta)


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``custom_vjp`` of ``flash_attention``: the
    forward kernel saves ``(q, k, v, o, lse)`` and the backward is the
    dq and dk/dv kernel pair.  Nothing outside ``ctx`` is kept, so under
    ``torch.utils.checkpoint`` a recomputed forward stands alone."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        o, lse = _flash_fwd(q, k, v, causal, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.masks = (causal, q_offset, k_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, *ctx.masks)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, q_offset=0, k_offset=0):
    """Tiled attention ``softmax(q·kᵀ/√d)·v`` over (b, s, h, d) tensors.

    Differentiable in q, k and v: when autograd records (grad enabled
    and an input requires grad) it runs through :class:`_FlashAttention`,
    whose backward launches the backward kernels; otherwise (serving,
    ``torch.no_grad()``, inference mode) it is the forward alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, q_offset, k_offset)
    return _flash_fwd(q, k, v, causal, q_offset, k_offset)[0]


def decode_split(rows):
    """The cluster size the decode kernels launch with for ``rows`` =
    batch x heads (batch, head) rows: doubled, up to 8, while the grid
    of ``rows * split`` blocks covers the SMs less than twice.  The host
    does not know the lengths (they stay on the device), so the split
    follows the grid alone; each block finds its share of its row's keys
    itself."""
    split = 1
    while split < _MAX_SPLIT and rows * split < 2 * _SMS:
        split *= 2
    return split


def key_range(rank, split, kend):
    """``[begin, end)``: the keys rank ``rank`` of a ``split``-block
    cluster reads of a row whose keys end at ``kend`` (``min(kmax,
    lengths[b] + row_step * (nq - 1))``), as the kernel computes them:
    chunks ``[rank C / split, (rank + 1) C / split)`` of ``C =
    ceil(kend / DECODE_CHUNK)``, in rank order.  A rank's range is empty
    when the row has fewer chunks than ranks."""
    chunks = -(-kend // DECODE_CHUNK)
    return (min(kend, rank * chunks // split * DECODE_CHUNK),
            min(kend, (rank + 1) * chunks // split * DECODE_CHUNK))


def _check_split(name, split, rows):
    if split is None:
        return decode_split(rows)
    if split not in (1, 2, 4, 8):
        raise ValueError("%s splits a row over 1, 2, 4 or 8 blocks, got %r"
                         % (name, split))
    return split


def _check_lengths(name, lengths, b, device):
    if (lengths.dtype != torch.int32 or lengths.shape != (b,)
            or lengths.device != device or not lengths.is_contiguous()):
        raise ValueError("%s needs contiguous int32 lengths of shape (%d,) "
                         "on %s" % (name, b, device))


def _decode_cuda(q, k, v, lengths, row_step, split=None):
    """``veles_decode_attn``; ``split`` forces the cluster size (the
    card tests try each), else :func:`decode_split`."""
    dtype = _check_bshd("decode_attn", q, k, v)
    b, nq, h, d = q.shape
    seq = k.shape[1]
    if v.shape[1] != seq:
        raise ValueError("decode_attn: k has %d rows, v %d"
                         % (seq, v.shape[1]))
    if not 1 <= nq <= MAX_QUERY_ROWS:
        raise ValueError("decode_attn takes 1..%d query rows, got %d"
                         % (MAX_QUERY_ROWS, nq))
    _check_lengths("decode_attn", lengths, b, q.device)
    split = _check_split("decode_attn", split, b * h)
    width = 16 // q.element_size()
    vec = int(d % width == 0
              and all(s % width == 0 for s in _strides(k) + _strides(v))
              and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)
    o = torch.empty((b, nq, h, d), dtype=dtype, device=q.device)
    status = _entry("decode_attn")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), _DTYPE_CODES[dtype], b, h, nq, seq, d,
        *_strides(q), *_strides(k), *_strides(v), int(row_step), vec,
        1.0 / (d ** 0.5), split, stream_handle(q.device))
    check_status("decode_attn", status)
    launches["decode_attn"] += 1
    return o


def _tally_decode(q, keys, nbytes):
    """The cost of a decode launch: QKᵀ and PV, 4·d flops a key, for
    every query row and head over ``keys`` keys, the cache's full
    extent.  The valid lengths live on the device, so this is the upper
    bound the JAX package's analytic decode count also takes."""
    b, nq, h, d = q.shape
    cost.add(4.0 * d * keys * b * nq * h, nbytes)


def decode_attention(q, k, v, lengths, row_step=0):
    """Attention of a few query rows against a masked KV buffer — the
    decode step's hot op.

    ``q``: (b, nq, h, d) with nq <= 8, or (b, h, d); ``k``/``v``: (b, S,
    h, d) cache buffers of which the first ``lengths[i]`` (int32, each
    >= 1) keys of row ``i`` are valid.  ``row_step=1`` is the verify
    mask: query row ``j`` reads the keys ``< lengths[i] + j``.  Row
    ``i``'s output depends only on row ``i``'s query and valid keys."""
    if row_step not in (0, 1):
        raise ValueError("row_step must be 0 (decode) or 1 (verify), "
                         "got %r" % (row_step,))
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    _tally_decode(q, k.shape[1], cost.nbytes(q, q, k, v, lengths))
    if on_gpu(q, k, v, lengths):
        out = _decode_cuda(q, k, v, lengths, row_step)
    elif row_step:
        out = _verify_ref(q, k, v, lengths)
    else:
        out = _decode_ref(q, k, v, lengths)
    return out[:, 0] if squeeze else out


def verify_attention(q, k, v, lengths):
    """K-token causal verify against a contiguous cache (speculative
    decode): ``q`` (b, K+1, h, d), row ``j`` of sequence ``i`` reads the
    keys ``< lengths[i] + j``.  The decode kernel with ``row_step=1``."""
    return decode_attention(q, k, v, lengths, row_step=1)


def chunk_attention(q, k, v, start):
    """Causal attention of ONE prefill chunk against the sequence's whole
    KV buffer: ``q`` (1, C, h, d) at global positions ``start + i``,
    ``k``/``v`` (1, S, h, d) with the chunk's K/V already written at
    [start, start+C).  Keys at or past ``start + C`` are hidden by the
    causal offset.  The flash forward with ``q_offset=start``."""
    return _flash_fwd(q, k, v, causal=True, q_offset=int(start))[0]


def _paged_decode_cuda(q, k_pool, v_pool, tables, lengths, row_step,
                       split=None):
    """``veles_paged_decode_attn``; ``split`` as :func:`_decode_cuda`."""
    dtype = q.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError("paged_decode_attn kernel takes float32 or "
                        "bfloat16, got %s" % dtype)
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError("paged_decode_attn expects q (b, nq, h, d) and "
                         "pools (num_blocks, BS, h, d)")
    b, nq, h, d = q.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[2:] != (h, d):
        raise ValueError("paged_decode_attn operand shapes disagree: q %s, "
                         "pools %s %s" % (tuple(q.shape),
                                          tuple(k_pool.shape),
                                          tuple(v_pool.shape)))
    for t in (k_pool, v_pool):
        if t.dtype != dtype:
            raise TypeError("paged_decode_attn operands differ in dtype: "
                            "%s vs %s" % (t.dtype, dtype))
    for t in (q, k_pool, v_pool):
        if t.stride(-1) != 1:
            raise ValueError("paged_decode_attn needs a unit stride on "
                             "head_dim")
        if t.device != q.device:
            raise ValueError("paged_decode_attn operands on different "
                             "devices")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError("paged_decode_attn takes head_dim 1..%d, got %d"
                         % (MAX_HEAD_DIM, d))
    if not 1 <= nq <= MAX_QUERY_ROWS:
        raise ValueError("paged_decode_attn takes 1..%d query rows, got %d"
                         % (MAX_QUERY_ROWS, nq))
    if (tables.dtype != torch.int32 or tables.dim() != 2
            or tables.shape[0] != b or tables.shape[1] < 1
            or tables.stride(1) != 1 or tables.device != q.device):
        raise ValueError("paged_decode_attn needs int32 tables of shape "
                         "(%d, max_blocks) with a unit last stride on %s"
                         % (b, q.device))
    _check_lengths("paged_decode_attn", lengths, b, q.device)
    split = _check_split("paged_decode_attn", split, b * h)
    width = 16 // q.element_size()
    vec = int(d % width == 0
              and all(s % width == 0 for s in _strides(k_pool)
                      + _strides(v_pool))
              and k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0)
    o = torch.empty((b, nq, h, d), dtype=dtype, device=q.device)
    status = _entry("paged_decode_attn")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        _DTYPE_CODES[dtype], b, h, nq, tables.shape[1], k_pool.shape[1], d,
        *_strides(q), *_strides(k_pool), *_strides(v_pool), tables.stride(0),
        int(row_step), vec, 1.0 / (d ** 0.5), split, stream_handle(q.device))
    check_status("paged_decode_attn", status)
    launches["paged_decode_attn"] += 1
    return o


def paged_decode_attention(q, k_pool, v_pool, tables, lengths, row_step=0):
    """A few query rows against a PAGED KV pool — the decode (and, with
    ``row_step=1``, the verify) hot op of the block-pool cache.

    ``q``: (b, nq, h, d) with nq <= 8, or (b, h, d); ``k_pool``/
    ``v_pool``: (num_blocks, BS, h, d) shared pools; ``tables``: (b,
    max_blocks) int32, row ``i``'s sequence in blocks ``tables[i]`` in
    order, entries past its allocation pointing at the trash block 0;
    ``lengths``: (b,) int32 valid key counts (each >= 1).  Row ``j``
    reads the keys ``< lengths[i] + row_step·j``, never past
    ``max_blocks·BS``.  Same row independence as
    :func:`decode_attention`."""
    if row_step not in (0, 1):
        raise ValueError("row_step must be 0 (decode) or 1 (verify), "
                         "got %r" % (row_step,))
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    # the keys of every table's blocks, read through the tables
    keys = tables.shape[1] * k_pool.shape[1]
    _tally_decode(q, keys, cost.nbytes(q, q, tables, lengths)
                  + 2 * q.shape[0] * keys * k_pool.shape[2]
                  * k_pool.shape[3] * k_pool.element_size())
    if on_gpu(q, k_pool, v_pool, tables, lengths):
        out = _paged_decode_cuda(q, k_pool, v_pool, tables, lengths,
                                 row_step)
    else:
        out = _paged_decode_ref(q, k_pool, v_pool, tables, lengths,
                                row_step)
    return out[:, 0] if squeeze else out


def paged_verify_attention(q, k_pool, v_pool, tables, lengths):
    """The paged twin of :func:`verify_attention`: the staggered verify
    mask over keys gathered through the block tables."""
    return paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                  row_step=1)
