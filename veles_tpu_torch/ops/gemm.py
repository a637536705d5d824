"""GEMM with a fused bias + activation epilogue, and the fused
gradient-descent trio, each beside its plain PyTorch version.

Counterpart of :mod:`veles_tpu.ops.gemm`:

- :func:`matmul` is ``act(a @ w + bias)``: the kernel
  (``csrc/gemm.cu`` ``veles_matmul``, replacing ``_matmul_kernel``) on
  CUDA tensors, :func:`_matmul_ref` (the counterpart of ``_matmul_jnp``)
  on CPU tensors.
- :func:`gd_fused` is one GD step of a fully-connected layer: δ =
  err_output ⊙ act′(y) (the derivative taken from the output, Znicz
  style), ``err_input = δ·Wᵀ`` (``δ·W`` in transposed storage) from the
  weights BEFORE the update, ``dW = xᵀδ/B``, ``v′ = m·v − lr·(dW +
  λW)``, ``W′ = W + v′``, and the same for the bias.  On CUDA tensors
  it launches ``veles_gd_dx`` (replacing ``_gd_dx_kernel``), then
  ``veles_gd_dw`` (replacing ``_gd_dw_kernel``), on one stream: dx must
  read W before dw updates it in place.  The bias step
  (``_gd_db_kernel``'s function) has no launch of its own: it rides in
  dw's launch, whose blocks already stage δ (``bias_in_dw`` counts those
  launches).  On CPU tensors it takes :func:`_gd_ref` (the counterpart
  of ``znicz.gd._gd_math``).  Either way W, vW, b and vb are updated IN
  PLACE (the JAX package donates them) and returned with err_input.

:func:`matmul` is differentiable: it is a ``torch.autograd.Function``
(:class:`MatMul`, the counterpart of ``matmul.defvjp(_matmul_fwd,
_matmul_bwd)``) whenever a gradient is wanted.  Its backward takes
act′ from the saved OUTPUT by the JAX formulas (the forward saves it
only for a non-linear activation), casts it to ``a``'s type and runs
``da = act′·Wᵀ`` and ``dW = aᵀ·act′`` through the same wrapper, so
through the same kernel on the card, reading the transposed views
through their strides; ``da`` is skipped when ``a`` needs no gradient
(the first layer, whose input is data).  ``db = Σ act′`` is a plain
sum.

The GD kernels take f32 only.  ``matmul`` takes f32 or bf16 operands
of one type: f32 runs ``veles_matmul``, which computes full f32 at
every ``precision_level``; bf16 runs ``veles_matmul_bf16``
(``csrc/gemm_bf16.cu``, the bf16 body of ``_matmul_kernel``: bf16
products on the tensor cores, f32 sums and epilogue, a bf16 result;
``launches["matmul_bf16"]``).  :func:`plan_bf16` picks its body, tile
and K split before each launch: body W (TMA + ``wgmma``, a 128-row
tile) where TMA can describe both operands (:func:`tma_major`), else
body S (``cp.async`` + ``ldmatrix`` + ``mma.sync``, a 64 × 64 tile);
``bf16_bodies`` counts the launches of each.  Its plain version computes
the f32 product of the widened operands and rounds once to bf16, as
``_matmul_jnp`` does; :func:`_matmul_bf16_split_ref` is the plain model
of the bodies' order of sums over a split K.  float64 is for CPU
debugging (the JAX package's ``dtypes``): a CUDA tensor of it raises
``TypeError``.  :func:`plan` picks the
GEMM body's tile and K split from the shape (the ``tile`` and ``split``
of every launch): the 128 × 128 tile where its grid covers the card's
SMs, else the 32 × 32 tile with K split over a thread block cluster of
up to 8 blocks, summed in rank order (no atomics: a launch gives the
same bits every time).  A grid covers the SMs when it holds a 256-thread
block's worth of threads for each.  The bias sums follow the same order
(:func:`_bias_sum_plan_ref` is its plain model).  The hyperparameters
are plain kernel arguments when given as numbers; given as 0-d f32
tensors on the card, the dw kernel reads them from device memory when it
runs, so a CUDA graph that captured the launch sees the values written
before each replay.  The kernels scale by ``1/B`` as a multiply, as the
Pallas kernels do; ``_gd_ref`` divides, as ``_gd_math`` does, so the two
differ in the last bit.  There is no fallback from a CUDA tensor to the
plain version.  ``launches`` counts kernel launches by kernel name; only
a launch adds to it (``"gd_db"`` stays 0: db has no launch of its own),
``bias_in_dw`` counts the dw launches that carried the bias step, and
``split_launches`` the GEMM launches that split K over a cluster.
"""

import ctypes
import operator

import torch

from veles_tpu_torch.backends import check_pallas_knob
from veles_tpu_torch.ops import cost
from veles_tpu_torch.ops.util import check_status, on_gpu, stream_handle

#: activation name -> the kernels' code; ``None`` and "linear" are one
ACTIVATION_CODES = {None: 0, "linear": 0, "tanh": 1, "sigmoid": 2,
                    "relu": 3, "strict_relu": 4}

#: kernel name -> launches since the last reset_launches(); "gd_db" stays
#: 0, as the bias step rides in gd_dw's launch
launches = {"matmul": 0, "matmul_bf16": 0, "gd_dx": 0, "gd_dw": 0,
            "gd_db": 0}
#: "gd_db_in_dw" -> the gd_dw launches that carried the bias step
bias_in_dw = {"gd_db_in_dw": 0}
#: "<GEMM kernel name>_split" -> those of its launches that split K
split_launches = {"matmul_split": 0, "gd_dx_split": 0, "gd_dw_split": 0}
#: the bf16 body -> its launches ("<body>_split": those that split K)
bf16_bodies = {"wgmma": 0, "ldmatrix": 0, "wgmma_split": 0,
               "ldmatrix_split": 0}

#: csrc/gemm.cu's tile configurations (``TileOf<TILE>``): code -> (BM,
#: BN, BK, threads) of the output tile, the K step and the block
SPLIT_TILE, BIG_TILE = 0, 1
TILES = {SPLIT_TILE: (32, 32, 16, 64), BIG_TILE: (128, 128, 8, 256)}
_SMS = 132                # the H100's SMs
_COVER = _SMS * 256       # threads of a grid that covers them once
_MAX_SPLIT = 8            # the portable cluster size

#: csrc/gemm_bf16.cu's bodies of ``veles_matmul_bf16`` (its ``body``
#: argument) by name
BF16_BODY_S, BF16_BODY_W = 0, 1
BF16_BODIES = {BF16_BODY_S: "ldmatrix", BF16_BODY_W: "wgmma"}
#: the K tile of both bf16 bodies, and their output tiles' rows: body
#: S's tile is 64 x 64, body W's 128 x 128 or 128 x 256
BF16_BLOCK_K = 64
BF16_BLOCK_M = {BF16_BODY_S: 64, BF16_BODY_W: 128}
#: body W's K split stops doubling past this many blocks: on an H100
#: AlexNet's batch-128 products ran fastest at 64-72 blocks (32 tiles in
#: clusters of 2, 72 unsplit) and 1.2-1.5x slower at 128
#: (scripts/gemm_bf16_probe.py --variants)
_BF16_SPLIT_BLOCKS = 96

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
#: kernel name -> (C symbol, ctypes argtypes), all in csrc/gemm.cu
_ARGTYPES = {
    "matmul": ("veles_matmul", [_P] * 4 + [_I] * 3 + [_L] * 4 + [_I] * 3
               + [_P]),
    "matmul_bf16": ("veles_matmul_bf16", [_P] * 4 + [_I] * 3 + [_L] * 4
                    + [_I] * 4 + [_P]),
    "gd_dx": ("veles_gd_dx", [_P] * 4 + [_I] * 3 + [_L] * 2 + [_I] * 3
              + [_P]),
    "gd_dw": ("veles_gd_dw", [_P] * 5 + [_I] * 3 + [_L] * 2 + [_I] * 2
              + [_F] * 4 + [_P] * 5 + [_F] * 3 + [_P] * 3 + [_I] * 2
              + [_P]),
}
#: the kernels whose source is not csrc/gemm.cu
_LIBRARIES = {"matmul_bf16": "gemm_bf16"}
_entries = {}


def reset_launches():
    for counter in (launches, bias_in_dw, split_launches, bf16_bodies):
        for name in counter:
            counter[name] = 0


def grid_threads(m, n, tile, split=1):
    """Threads of the grid of ``tile`` over an (M, N) output, split K
    ways."""
    block_m, block_n, _, threads = TILES[tile]
    return -(-m // block_m) * -(-n // block_n) * threads * split


def plan(m, n, k):
    """``(tile, split)`` of the GEMM body for an (M, K) by (K, N)
    product: the big tile where its grid covers the SMs (split 1), else
    the split tile with K split over a cluster, doubled up to 8 while
    the grid covers the SMs less than once and every rank keeps a K
    tile."""
    if grid_threads(m, n, BIG_TILE) >= _COVER:
        return BIG_TILE, 1
    k_tiles = -(-k // TILES[SPLIT_TILE][2])
    split = 1
    while (split < _MAX_SPLIT
           and grid_threads(m, n, SPLIT_TILE, split) < _COVER
           and k_tiles >= 2 * split):
        split *= 2
    return SPLIT_TILE, split


def k_range(rank, split, k, tile=SPLIT_TILE, block_k=None):
    """``[k_begin, k_end)``: the K elements rank ``rank`` of a split
    launch sums, as the kernel computes them: K tiles ``[rank T / split,
    (rank + 1) T / split)`` of ``T = ceil(K / BK)``, so the chunks
    differ by at most one tile and only the last one is ragged.  BK is
    ``tile``'s, or ``block_k`` where given (the bf16 bodies':
    BF16_BLOCK_K)."""
    block_k = block_k or TILES[tile][2]
    k_tiles = -(-k // block_k)
    return (rank * k_tiles // split * block_k,
            min(k, (rank + 1) * k_tiles // split * block_k))


def tma_major(s0, s1, data_ptr):
    """Which index of a 2-D bf16 operand with strides ``(s0, s1)``
    (elements) TMA reads along: 1 where ``s1`` is the unit stride, 0
    where ``s0`` is, with the other stride a positive multiple of 16
    bytes and the base 16-byte aligned; None where TMA cannot describe
    the operand (a 200-byte row pitch, a sliced view's unaligned base, no
    unit stride).  csrc/gemm_bf16.cu ``tma_major`` is the same rule."""
    if data_ptr % 16:
        return None
    if s1 == 1 and s0 > 0 and s0 % 8 == 0:
        return 1
    if s0 == 1 and s1 > 0 and s1 % 8 == 0:
        return 0
    return None


def plan_bf16(m, n, k, strides, data_ptrs):
    """``(body, tile, split)`` of ``veles_matmul_bf16`` for an (M, K) by
    (K, N) product of bf16 operands ``a`` and ``w`` with ``strides``
    ``(a.stride(0), a.stride(1), w.stride(0), w.stride(1))`` at
    ``data_ptrs`` ``(a.data_ptr(), w.data_ptr())``.

    Body W where TMA can describe both operands: a 128 × 256 tile where
    that grid alone fills the SMs (4096³, the weight gradients' K of
    128), else 128 × 128 with K split over a cluster, doubled up to 8
    while the grid stays within _BF16_SPLIT_BLOCKS blocks and every rank
    keeps a K tile (AlexNet's forwards and input gradients at batch 128,
    which ran 4-14 % faster so than on 128 × 256 tiles).  An unsplit
    grid is walked by one block an SM.  Body S otherwise: a 64 × 64
    tile, K split doubled up to 8 while the grid covers the SMs less
    than once and every rank keeps a K tile.  ``tile`` is body W's
    columns or body S's 64."""
    sam, sak, swk, swn = strides
    k_tiles = -(-k // BF16_BLOCK_K)
    if (tma_major(sam, sak, data_ptrs[0]) is not None
            and tma_major(swk, swn, data_ptrs[1]) is not None):
        m_tiles = -(-m // BF16_BLOCK_M[BF16_BODY_W])
        if m_tiles * -(-n // 256) >= _SMS:
            return BF16_BODY_W, 256, 1
        tiles, split = m_tiles * -(-n // 128), 1
        while (split < _MAX_SPLIT and k_tiles >= 2 * split
               and tiles * 2 * split <= _BF16_SPLIT_BLOCKS):
            split *= 2
        return BF16_BODY_W, 128, split
    split = 1
    tile = BF16_BLOCK_M[BF16_BODY_S]
    tiles = -(-m // tile) * -(-n // tile)
    while split < _MAX_SPLIT and k_tiles >= 2 * split and tiles * split < _SMS:
        split *= 2
    return BF16_BODY_S, tile, split


def _launched(name, split):
    launches[name] += 1
    if split > 1:
        split_launches[name + "_split"] += 1


def _entry(name):
    """The C entry of kernel ``name``, building ``csrc/gemm.cu`` at first
    use."""
    fn = _entries.get(name)
    if fn is None:
        from veles_tpu_torch.ops import build
        symbol, argtypes = _ARGTYPES[name]
        fn = getattr(build.library(_LIBRARIES.get(name, "gemm")), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


# -- plain versions (the CPU path and the kernels' references) -------------

def _activate(x, activation):
    """The activations of ``_ACTIVATIONS`` (Znicz scaled tanh, smooth
    relu clamped at 30)."""
    if activation in (None, "linear"):
        return x
    if activation == "tanh":
        return torch.tanh(x * 0.6666) * 1.7159
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation == "relu":
        return torch.log1p(torch.exp(torch.clamp(x, max=30.0)))
    if activation == "strict_relu":
        return torch.clamp(x, min=0.0)
    raise ValueError("unknown activation %r" % (activation,))


def _derivative(y, activation):
    """act′ from the output y (``_GD_DERIVS``)."""
    if activation in (None, "linear"):
        return torch.ones_like(y)
    if activation == "tanh":
        return y * y * (-0.388484177) + 1.14381894
    if activation == "sigmoid":
        return y * (1.0 - y)
    if activation == "relu":
        return 1.0 - torch.exp(-y)
    if activation == "strict_relu":
        return (y > 0).to(y.dtype)
    raise ValueError("unknown activation %r" % (activation,))


def _matmul_ref(a, w, bias=None, activation=None):
    """Mirror of ``_matmul_jnp``: an f32 product, then the bias, then
    the activation.  The product reads a contiguous copy of ``w``, so a
    transposed view and its contiguous storage give the same bits (CPU
    BLAS takes another kernel for a transposed operand).  On the CPU
    each row is its own (1, K) product: MKL picks its kernel by M, so a
    row of one M-row product need not equal the same row of another
    (at fan-in 784), and a padded bucket's rows must equal the
    unbatched forward's bit for bit."""
    a32, w32 = a.float(), w.float().contiguous()
    if a32.is_cuda or a32.shape[0] <= 1:
        out = torch.mm(a32, w32)
    else:
        out = torch.cat([torch.mm(row, w32) for row in a32.split(1)])
    if bias is not None:
        out = out + bias.float()
    return _activate(out, activation).to(a.dtype)


def _matmul_bf16_split_ref(a, w, bias=None, activation=None, split=1):
    """The plain model of the bf16 bodies' sums: rank r of a ``split``
    launch takes the f32 product of the widened operands over its K chunk
    (:func:`k_range` at BF16_BLOCK_K), the partials are added into zero
    in rank order, then the bias and the activation in f32, and the
    result is rounded once to ``a``'s type.  Each rank's own sum runs in
    another order than the kernel's, so the two agree within a bf16
    rounding, not bit for bit."""
    a32, w32 = a.float(), w.float()
    total = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32,
                        device=a.device)
    for rank in range(split):
        begin, end = k_range(rank, split, a.shape[1],
                             block_k=BF16_BLOCK_K)
        total = total + torch.mm(a32[:, begin:end], w32[begin:end])
    if bias is not None:
        total = total + bias.float()
    return _activate(total, activation).to(a.dtype)


def _gd_ref(x, y, err_output, w, b, vw, vb, lr, lr_bias, decay,
            decay_bias, moment, moment_bias, activation=None,
            need_err_input=True, has_bias=True, transposed=False):
    """Mirror of ``znicz.gd._gd_math``: returns new ``(w, b, vw, vb,
    err_input)`` (``b``/``vb`` as given when not ``has_bias``,
    ``err_input`` None when not needed); the inputs are not touched."""
    batch = x.shape[0]
    delta = err_output.reshape(batch, -1).float() * _derivative(
        y.reshape(batch, -1).float(), activation)
    x2 = x.reshape(batch, -1).float()
    grad_w = torch.mm(x2.t(), delta) / batch
    if need_err_input:
        # Wᵀ as a contiguous (N, F) copy in both layouts: the same bits
        # from either storage, as in _matmul_ref
        err_input = torch.mm(delta,
                             (w if transposed else w.t()).contiguous())
    else:
        err_input = None
    if transposed:
        grad_w = grad_w.t()
    vw = moment * vw - lr * (grad_w + decay * w)
    w = w + vw
    if has_bias:
        grad_b = delta.sum(dim=0) / batch
        vb = moment_bias * vb - lr_bias * (grad_b + decay_bias * b)
        b = b + vb
    return w, b, vw, vb, err_input


def _bias_sum_plan_ref(delta, split, tile=SPLIT_TILE):
    """Σ over the batch of δ (B, N) in the dw kernel's order, the plain
    model of its bias sums: rank r of a ``split`` launch adds the rows of
    its K chunk (:func:`k_range`) one after another into zero, and the
    ranks' sums are added into zero in rank order (a split-1 launch keeps
    its one sum).  On the same δ the kernel gives these bits."""
    delta = delta.float()
    sums = []
    for rank in range(split):
        begin, end = k_range(rank, split, delta.shape[0], tile)
        s = torch.zeros(delta.shape[1], dtype=torch.float32,
                        device=delta.device)
        for row in range(begin, end):
            s = s + delta[row]
        sums.append(s)
    if split == 1:
        return sums[0]
    total = torch.zeros_like(sums[0])
    for s in sums:
        total = total + s
    return total


# -- kernel wrappers --------------------------------------------------------

def _check_f32(name, *tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError("%s kernel takes float32 only, got %s"
                            % (name, t.dtype))
        if t.device != tensors[0].device:
            raise ValueError("%s operands on different devices" % name)


#: the operand types of the matmul kernels
MATMUL_DTYPES = (torch.float32, torch.bfloat16)


def _check_operands(name, *tensors):
    """One operand type for every tensor, f32 or bf16, on one device."""
    dtype = tensors[0].dtype
    for t in tensors:
        if t.dtype not in MATMUL_DTYPES or t.dtype != dtype:
            raise TypeError("%s kernel takes float32 or bfloat16 operands "
                            "of one type, got %s"
                            % (name, [str(x.dtype) for x in tensors]))
        if t.device != tensors[0].device:
            raise ValueError("%s operands on different devices" % name)


def _check_2d(name, **tensors):
    for label, t in tensors.items():
        if t.dim() != 2:
            raise ValueError("%s expects a 2-D %s, got shape %s"
                             % (name, label, tuple(t.shape)))


def _check_contiguous(name, **tensors):
    for label, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError("%s needs a contiguous %s" % (name, label))


def _matmul_cuda(a, w, bias, activation, tile_split=None):
    """The ``veles_matmul`` kernel (f32) or ``veles_matmul_bf16`` (bf16):
    a (M, K) and w (K, N) read through their strides (a transposed view
    needs no copy), bias (N,) contiguous or None, all of one type;
    ``tile_split`` overrides the plan: ``(tile, split)`` of :func:`plan`
    for f32, ``(body, tile, split)`` of :func:`plan_bf16` for bf16."""
    _check_2d("matmul", a=a, w=w)
    _check_operands("matmul", a, w, *(() if bias is None else (bias,)))
    m, k = a.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError("matmul: a is %s, w is %s" % (tuple(a.shape),
                                                       tuple(w.shape)))
    if bias is not None and (tuple(bias.shape) != (n,)
                             or not bias.is_contiguous()):
        raise ValueError("matmul needs a contiguous bias of shape (%d,)"
                         % n)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    bias_ptr = None if bias is None else bias.data_ptr()
    if a.dtype == torch.bfloat16:
        strides = (a.stride(0), a.stride(1), w.stride(0), w.stride(1))
        body, tile, split = tile_split or plan_bf16(
            m, n, k, strides, (a.data_ptr(), w.data_ptr()))
        status = _entry("matmul_bf16")(
            a.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(), m, n, k,
            *strides, ACTIVATION_CODES[activation], body, tile, split,
            stream_handle(a.device))
        check_status("matmul_bf16", status)
        launches["matmul_bf16"] += 1
        name = BF16_BODIES[body]
        bf16_bodies[name] += 1
        if split > 1:
            bf16_bodies[name + "_split"] += 1
        return out
    tile, split = tile_split or plan(m, n, k)
    status = _entry("matmul")(
        a.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(),
        m, n, k, a.stride(0), a.stride(1), w.stride(0), w.stride(1),
        ACTIVATION_CODES[activation], tile, split, stream_handle(a.device))
    check_status("matmul", status)
    _launched("matmul", split)
    return out


def _matmul_call(a, w, bias, activation):
    """One product, no autograd: the cost tallied, then the kernel on
    CUDA tensors or :func:`_matmul_ref` on CPU tensors."""
    tensors = (a, w) if bias is None else (a, w, bias)
    # 2·M·N·K, the bias and the activation per output element; a, w and
    # the bias read once, the (M, N) output written once
    m, n = a.shape[0], w.shape[-1]
    cost.add(cost.product(m, n, a.shape[-1], bias is not None, activation),
             cost.nbytes(*tensors) + a.element_size() * m * n)
    if on_gpu(*tensors):
        return _matmul_cuda(a, w, bias, activation)
    return _matmul_ref(a, w, bias, activation)


class MatMul(torch.autograd.Function):
    """``activation(a @ w + bias)`` with its gradient through the same
    kernel: the counterpart of the JAX ``matmul``'s custom VJP
    (``_matmul_fwd`` / ``_matmul_bwd``)."""

    @staticmethod
    def forward(ctx, a, w, bias, activation):
        out = _matmul_call(a, w, bias, activation)
        ctx.activation = activation
        ctx.bias_dtype = None if bias is None else bias.dtype
        # a linear backward never reads the output: it is not saved
        ctx.save_for_backward(
            a, w, None if activation in (None, "linear") else out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, w, out = ctx.saved_tensors
        g = g.float()
        if ctx.activation in (None, "linear"):
            dact = g
        else:
            dact = g * _derivative(out.float(), ctx.activation)
        dact = dact.to(a.dtype)
        da = dw = dbias = None
        if ctx.needs_input_grad[0]:
            da = _matmul_call(dact, w.t(), None, None).to(a.dtype)
        if ctx.needs_input_grad[1]:
            dw = _matmul_call(a.t(), dact, None, None).to(w.dtype)
        if ctx.needs_input_grad[2]:
            dbias = dact.sum(dim=0).to(ctx.bias_dtype)
        return da, dw, dbias, None


def matmul(a, w, bias=None, activation=None):
    """``activation(a @ w + bias)``: the kernel on CUDA tensors,
    :func:`_matmul_ref` on CPU tensors.  a: (M, K); w: (K, N), any
    strides; bias: (N,) or None; f32 or bf16, one type, the result in
    it.  Through :class:`MatMul` when a gradient is wanted."""
    if activation not in ACTIVATION_CODES:
        raise ValueError("unknown activation %r" % (activation,))
    check_pallas_knob("pallas_gemm", "the dense matmul", operator.not_)
    tensors = (a, w) if bias is None else (a, w, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return MatMul.apply(a, w, bias, activation)
    return _matmul_call(a, w, bias, activation)


def _gd_check(name, eo, y, w, transposed, x=None):
    _check_2d(name, err_output=eo, y=y, w=w)
    _check_f32(name, eo, y, w, *(() if x is None else (x,)))
    _check_contiguous(name, err_output=eo, y=y)
    if eo.shape != y.shape:
        raise ValueError("%s: err_output %s and y %s differ"
                         % (name, tuple(eo.shape), tuple(y.shape)))
    n = eo.shape[1]
    f = w.shape[1] if transposed else w.shape[0]
    if (w.shape[0] if transposed else w.shape[1]) != n:
        raise ValueError("%s: weights %s do not match %d neurons%s"
                         % (name, tuple(w.shape), n,
                            " (transposed)" if transposed else ""))
    if x is not None:
        _check_2d(name, x=x)
        if tuple(x.shape) != (eo.shape[0], f):
            raise ValueError("%s: x is %s, want %s" % (
                name, tuple(x.shape), (eo.shape[0], f)))
    return f


def _hyperparameters(name, device, *values):
    """The kernels' ``(floats, pointers)`` for the hyperparameters:
    numbers go by value (null pointers), 0-d f32 tensors on ``device``
    by address (zeros by value).  One call takes one kind."""
    tensors = [isinstance(v, torch.Tensor) for v in values]
    if not any(tensors):
        return [float(v) for v in values], [None] * len(values)
    for v in values:
        if not isinstance(v, torch.Tensor) or v.dtype != torch.float32 \
                or v.numel() != 1 or v.device != device:
            raise ValueError("%s takes its hyperparameters as numbers or "
                             "all as one-element f32 tensors on %s"
                             % (name, device))
    return [0.0] * len(values), [v.data_ptr() for v in values]


def _gd_dx_cuda(eo, y, w, activation, transposed, tile_split=None):
    """``veles_gd_dx``: err_input (B, F) = δ·Wᵀ (δ·W when transposed),
    δ rebuilt per tile from eo and y; w read through its strides;
    ``tile_split`` overrides :func:`plan`."""
    f = _gd_check("gd_dx", eo, y, w, transposed)
    batch, n = eo.shape
    out = torch.empty((batch, f), dtype=torch.float32, device=eo.device)
    # w as the (n, f) operand of δ·(.)
    s_nf = (w.stride(0), w.stride(1)) if transposed \
        else (w.stride(1), w.stride(0))
    tile, split = tile_split or plan(batch, f, n)
    status = _entry("gd_dx")(
        eo.data_ptr(), y.data_ptr(), w.data_ptr(), out.data_ptr(),
        batch, n, f, *s_nf, ACTIVATION_CODES[activation], tile, split,
        stream_handle(eo.device))
    check_status("gd_dx", status)
    _launched("gd_dx", split)
    return out


def _gd_dw_cuda(x, eo, y, w, vw, inv_batch, lr, decay, moment, activation,
                transposed, tile_split=None, bias=None):
    """``veles_gd_dw``: dW = xᵀδ (δᵀx in (N, F) storage) times
    ``inv_batch``, then the momentum update of the contiguous ``w`` and
    ``vw`` in place; ``lr``, ``decay``, ``moment`` numbers or 0-d f32
    tensors on the card; ``tile_split`` overrides :func:`plan`.  ``bias``
    ``(b, vb, lr, decay, moment)`` makes the same launch take the bias
    step: db = Σδ times ``inv_batch``, then the momentum update of the
    contiguous (N,) ``b`` and ``vb`` in place, its hyperparameters of the
    same kind as W's."""
    _gd_check("gd_dw", eo, y, w, transposed, x=x)
    _check_contiguous("gd_dw", w=w, vw=vw)
    if vw.shape != w.shape or vw.dtype != w.dtype or vw.device != w.device:
        raise ValueError("gd_dw: vw %s does not match w %s"
                         % (tuple(vw.shape), tuple(w.shape)))
    batch, n = eo.shape
    hyper = (lr, decay, moment) + (() if bias is None else tuple(bias[2:]))
    values, pointers = _hyperparameters("gd_dw", eo.device, *hyper)
    b_ptrs = [None, None]
    if bias is None:
        values, pointers = values + [0.0] * 3, pointers + [None] * 3
    else:
        b, vb = bias[:2]
        _check_f32("gd_dw", eo, b, vb)
        _check_contiguous("gd_dw", b=b, vb=vb)
        if tuple(b.shape) != (n,) or tuple(vb.shape) != (n,):
            raise ValueError("gd_dw: b %s and vb %s, want (%d,) each"
                             % (tuple(b.shape), tuple(vb.shape), n))
        b_ptrs = [b.data_ptr(), vb.data_ptr()]
    f = x.shape[1]
    tile, split = tile_split or plan(*((n, f) if transposed else (f, n)),
                                     batch)
    status = _entry("gd_dw")(
        x.data_ptr(), eo.data_ptr(), y.data_ptr(), w.data_ptr(),
        vw.data_ptr(), batch, f, n, x.stride(0), x.stride(1),
        int(bool(transposed)), ACTIVATION_CODES[activation],
        float(inv_batch), *values[:3], *pointers[:3], *b_ptrs,
        *values[3:], *pointers[3:], tile, split, stream_handle(eo.device))
    check_status("gd_dw", status)
    _launched("gd_dw", split)
    if bias is not None:
        bias_in_dw["gd_db_in_dw"] += 1


def _tally_gd(x2, eo, w, b, activation, need_err_input):
    """The cost of one GD step (batch B, F inputs, N neurons).  dx:
    2·B·N·F and δ rebuilt per element (act' and the product with the
    error); eo, y and W read, the (B, F) output written.  dw: 2·B·F·N,
    δ again, the momentum step per weight; x, eo and y read, W and vW
    read and written.  The bias step in dw's launch: Σδ over the batch
    and the momentum step per bias; b and vb read and written."""
    batch, f = x2.shape
    n = eo.shape[1]
    delta = cost.DERIVATIVE_FLOPS[activation] * batch * n
    flops = 2.0 * batch * f * n + delta + cost.UPDATE_FLOPS * f * n
    nbytes = cost.nbytes(x2, eo, eo) + 4 * cost.nbytes(w)
    if need_err_input:
        flops += 2.0 * batch * n * f + delta
        nbytes += cost.nbytes(eo, eo, w) + 4 * batch * f
    if b is not None:
        flops += batch * n + cost.UPDATE_FLOPS * n
        nbytes += 4 * cost.nbytes(b)
    cost.add(flops, nbytes)


def gd_fused(x, y, err_output, w, b, vw, vb, lr, lr_bias, decay,
             decay_bias, moment, moment_bias, activation=None,
             need_err_input=True, has_bias=True, transposed=False):
    """One fused GD step of a fully-connected layer (the counterpart of
    ``gd_fused_pallas``, same arguments and returns ``(w, b, vw, vb,
    err_input)``).  ``w``/``vw`` are (F, N), or (N, F) when
    ``transposed``; ``x``, ``y`` and ``err_output`` have the batch
    first.  W, vW (and b, vb when ``has_bias``) are updated in place.
    The six hyperparameters are numbers, or 0-d f32 tensors on the
    parameters' device (the stitched GD stage's scalar block)."""
    if activation not in ACTIVATION_CODES:
        raise ValueError("unknown activation %r" % (activation,))
    batch = x.shape[0]
    x2 = x.reshape(batch, -1)
    eo = err_output.reshape(batch, -1)
    y2 = y.reshape(batch, -1)
    params = (w, vw, b, vb) if has_bias else (w, vw)
    _tally_gd(x2, eo, w, b if has_bias else None, activation,
              need_err_input)
    if not on_gpu(x2, eo, y2, *params):
        new = _gd_ref(x2, y2, eo, w, b, vw, vb, lr, lr_bias, decay,
                      decay_bias, moment, moment_bias, activation,
                      need_err_input, has_bias, transposed)
        for buf, value in zip((w, b, vw, vb), new[:4]):
            if buf is not value:
                buf.copy_(value)
        return w, b, vw, vb, new[4]
    eo, y2 = eo.contiguous(), y2.contiguous()
    inv_batch = 1.0 / batch
    # dx FIRST: it reads W before dw updates it in place (one stream)
    err_input = _gd_dx_cuda(eo, y2, w, activation, transposed) \
        if need_err_input else None
    _gd_dw_cuda(x2, eo, y2, w, vw, inv_batch, lr, decay, moment,
                activation, transposed,
                bias=(b, vb, lr_bias, decay_bias, moment_bias)
                if has_bias else None)
    return w, b, vw, vb, err_input
