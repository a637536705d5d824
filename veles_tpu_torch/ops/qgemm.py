"""Quantized (int8-weight, W8A16) matmul, beside its plain version.

Counterpart of :mod:`veles_tpu.ops.qgemm`.  :func:`qmatmul` is
``act((a @ q) · scale[N] + bias)`` with int8 weights: on CUDA tensors
the kernel (``csrc/qgemm.cu`` ``veles_qmatmul``, replacing
``_qmatmul_kernel``), on CPU tensors :func:`_qmatmul_ref` (the
counterpart of ``_qmatmul_jnp``).  Both widen ``q`` exactly (|q| <= 127
fits the mantissa of bf16 and f32), accumulate the product in f32,
apply the per-output-channel scale ONCE after the K loop
(dot-then-scale, as the Pallas epilogue does), then the bias and the
activation in f32, and cast to ``out_dtype or a.dtype``.

The activations are the GEMM table
(:data:`veles_tpu_torch.ops.gemm.ACTIVATION_CODES`, with the Znicz
scaled tanh) plus ``gelu``, the tanh approximation (``jax.nn.gelu``'s
default), which the transformer MLP's up-projection fuses.  The kernel
picks its body by the activations: bf16 at M > 16 (prefill) runs
bf16 products on the tensor cores with f32 sums; bf16 at M <= 16
(decode) the decode body, f32 FMA over the real rows with a rank's whole
K chunk of q in flight at once (:func:`decode_plan` picks its column
tile and split); f32 activations the first version's FMA body, at every
``precision_level``.  Each body takes fixed tiles (:func:`tile`): the
autotune DB row ``ratings["gemm_int8"]``, ``tiles`` and ``use_pallas``
wait for ROADMAP item 7, and on the card :func:`qmatmul`
always runs the kernel, as :func:`veles_tpu_torch.ops.gemm.matmul` does.
There is no fallback from a CUDA tensor to the plain version.  No
gradient is defined: quantized params are served, not trained through.
``launches["qmatmul"]`` counts kernel launches; only a launch adds to
it.
"""

import ctypes
import operator

import torch
import torch.nn.functional as F

from veles_tpu_torch.backends import check_pallas_knob
from veles_tpu_torch.ops.gemm import ACTIVATION_CODES as _GEMM_CODES
from veles_tpu_torch.ops.gemm import _activate
from veles_tpu_torch.ops import cost
from veles_tpu_torch.ops.util import check_status, on_gpu, stream_handle

#: activation name -> the kernel's code: the GEMM table plus gelu
ACTIVATION_CODES = dict(_GEMM_CODES, gelu=5)

#: kernel name -> launches since the last reset_launches()
launches = {"qmatmul": 0}

#: (BM, BN, BK) of csrc/qgemm.cu's bodies: the decode body (bf16 at M <=
#: 16: up to 16 rows, 128 columns or the 64 of DECODE_BLOCK_N where
#: :func:`decode_plan` narrows it, 64 K rows a stage), the FMA body (f32;
#: 16 rows a tile at M <= 16) and the tensor-core body (bf16 at M > 16)
DECODE_TILE = (16, 128, 64)
FMA_SMALL_TILE = (16, 64, 64)
FMA_TILE = (64, 64, 64)
TC_TILE = (128, 128, 32)
#: the decode body's column tiles, widest first: 128 columns read whole
#: 128-byte lines of q a K row; 64 doubles the tiles of a narrow N
DECODE_BLOCK_N = (128, 64)
#: SMs of the H100: the kernel splits K over a cluster of up to 8
#: blocks until the grid covers them twice (the FMA body) or once (the
#: tensor-core body, whose 128 x 128 tile is four FMA tiles of work: a
#: timed probe on the card, scripts/tc_probe.py, found that split the
#: fastest, or within 10 % of it, for 11 of 12 products (CONFIG's four
#: block shapes at M = 2048, 256 and 32; w1 at 256 ran 26 % slower than
#: at a split of 2)
_SMS = 132
_MAX_SPLIT = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 4 + [_I] * 6 + [_P]
_entry_fn = []


def reset_launches():
    for name in launches:
        launches[name] = 0


def _entry():
    """The C entry ``veles_qmatmul``, building ``csrc/qgemm.cu`` at first
    use."""
    if not _entry_fn:
        from veles_tpu_torch.ops import build
        fn = build.library("qgemm").veles_qmatmul
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entry_fn.append(fn)
    return _entry_fn[0]


# -- the plain version (the CPU path and the kernel's reference) ------------

def _qactivate(x, activation):
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")
    return _activate(x, activation)


def _qmatmul_ref(a, q, scale, bias=None, activation=None, out_dtype=None):
    """Mirror of ``_qmatmul_jnp``: q widened (exactly) and the product
    accumulated in f32, then ``* scale``, ``+ bias`` and the activation
    in f32, cast to ``out_dtype or a.dtype``.  On CPU tensors the
    product accumulates in float64 and rounds to f32 once: an f32 times
    an int8 is exact there, so terms that cancel give exactly zero, as
    the JAX package's quantized forward does (an f32 ``mm`` on the CPU
    fuses multiply and add and leaves a residue)."""
    if a.is_cuda:
        out = torch.mm(a.float(), q.float())
    else:
        out = torch.mm(a.double(), q.double()).float()
    out = out * scale.reshape(-1).float()
    if bias is not None:
        out = out + bias.float()
    return _qactivate(out, activation).to(out_dtype or a.dtype)


# -- the kernel wrapper -----------------------------------------------------

def tile(m, dtype=torch.float32):
    """``(BM, BN, BK)`` of the body ``veles_qmatmul`` runs for M rows of
    ``dtype`` activations: for bf16 the decode body at M <= 16 and the
    tensor-core body above, for f32 the FMA body (16 rows a tile at M <=
    16)."""
    if dtype == torch.bfloat16:
        return DECODE_TILE if m <= 16 else TC_TILE
    return FMA_SMALL_TILE if m <= 16 else FMA_TILE


def decode_plan(n, k):
    """``(block_n, split)`` of the decode body (bf16, M <= 16) for a (K,
    N) weight: the widest column tile of DECODE_BLOCK_N whose grid, with
    K split over a cluster doubled up to 8 while the grid covers the SMs
    less than once and every rank keeps a stage of K, covers them; else
    the narrowest with its split.  CONFIG's decode products: wqkv and w1
    take (128, 8), wo and w2 (64, 8)."""
    k_tiles = -(-k // DECODE_TILE[2])
    for block_n in DECODE_BLOCK_N:
        tiles = -(-n // block_n)
        split = 1
        while (split < _MAX_SPLIT and tiles * split < _SMS
               and k_tiles >= 2 * split):
            split *= 2
        if tiles * split >= _SMS:
            break
    return block_n, split


def k_range(rank, split, k, block_k):
    """``[k_begin, k_end)``: the K rows rank ``rank`` of a split launch
    sums, as every body computes them: chunks of ``ceil(T / split)`` K
    tiles of ``T = ceil(K / block_k)``, so only the last ranks may be
    short or empty."""
    k_tiles = -(-k // block_k)
    chunk = -(-k_tiles // split) * block_k
    return min(k, rank * chunk), min(k, (rank + 1) * chunk)


def split_k(m, n, k, dtype=torch.float32):
    """The K split (cluster size) the kernel launches with for an (M, K)
    by (K, N) product of ``dtype`` activations: the decode body's from
    :func:`decode_plan`; else doubled, up to 8, while the grid of the
    body's output tiles covers the SMs less than twice (the FMA body) or
    once (the tensor-core body) and every split keeps a K tile."""
    if dtype == torch.bfloat16 and m <= 16:
        return decode_plan(n, k)[1]
    block_m, block_n, block_k = tile(m, dtype)
    tiles = -(-n // block_n) * -(-m // block_m)
    k_tiles = -(-k // block_k)
    cover = 1 if (block_m, block_n, block_k) == TC_TILE else 2
    split = 1
    while (split < _MAX_SPLIT and tiles * split < cover * _SMS
           and k_tiles >= 2 * split):
        split *= 2
    return split


def _qmatmul_cuda(a, q, scale, bias, activation, out_dtype, plan=None):
    """``veles_qmatmul``: a (M, K) f32 or bf16 with unit column stride,
    q (K, N) int8 contiguous, scale (N,) f32, bias (N,) f32 or a's dtype
    or None; out (M, N) in ``out_dtype`` (f32 or bf16).  ``plan`` forces
    ``(block_n, split)`` (the card tests try each; block_n is read by
    the decode body only), else :func:`decode_plan` / :func:`split_k`."""
    if a.dim() != 2 or q.dim() != 2:
        raise ValueError("qmatmul expects a 2-D a and q, got %s and %s"
                         % (tuple(a.shape), tuple(q.shape)))
    m, k = a.shape
    k2, n = q.shape
    if k != k2:
        raise ValueError("qmatmul: a is %s, q is %s" % (tuple(a.shape),
                                                        tuple(q.shape)))
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("qmatmul takes float32 or bfloat16 activations, "
                        "got %s" % a.dtype)
    if q.dtype != torch.int8 or not q.is_contiguous():
        raise TypeError("qmatmul takes contiguous int8 weights, got %s%s"
                        % (q.dtype, "" if q.is_contiguous()
                           else " (not contiguous)"))
    if a.stride(1) != 1 and k > 1:
        raise ValueError("qmatmul needs a with unit column stride")
    scale = scale.reshape(-1)
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,) \
            or not scale.is_contiguous():
        raise ValueError("qmatmul needs a contiguous float32 scale of "
                         "shape (%d,)" % n)
    if bias is not None and (tuple(bias.shape) != (n,)
                             or not bias.is_contiguous()
                             or bias.dtype not in (torch.float32, a.dtype)):
        raise ValueError("qmatmul needs a contiguous bias of shape (%d,) "
                         "in float32 or a's dtype" % n)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("qmatmul writes float32 or bfloat16, not %s"
                        % out_dtype)
    devices = {t.device for t in (a, q, scale) + (
        () if bias is None else (bias,))}
    if len(devices) != 1:
        raise ValueError("qmatmul operands on different devices")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if plan is None:
        decode = a.dtype == torch.bfloat16 and m <= 16
        plan = (decode_plan(n, k) if decode
                else (0, split_k(m, n, k, a.dtype)))
    block_n, split = plan
    if split not in (1, 2, 4, 8):
        raise ValueError("qmatmul splits K over 1, 2, 4 or 8 blocks, got %r"
                         % (split,))
    status = _entry()(
        a.data_ptr(), q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        m, n, k, a.stride(0),
        int(a.dtype == torch.bfloat16),
        int(bias is not None and bias.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), ACTIVATION_CODES[activation],
        split, block_n, stream_handle(a.device))
    check_status("qmatmul", status)
    launches["qmatmul"] += 1
    return out


def qmatmul(a, q, scale, bias=None, activation=None, out_dtype=None):
    """``activation((a @ q) * scale + bias)`` with int8 weights.

    a: (M, K) bf16/f32 activations; q: (K, N) **int8** weights as
    stored; scale: (N,) (or any shape of N elements) float32
    per-output-channel dequant factors; bias: (N,) or None.  The kernel
    on CUDA tensors, :func:`_qmatmul_ref` on CPU tensors."""
    if activation not in ACTIVATION_CODES:
        raise ValueError("unknown activation %r" % (activation,))
    check_pallas_knob("pallas_gemm", "the dequantized dense product",
                      operator.not_)
    out_dtype = out_dtype or a.dtype
    tensors = (a, q, scale) if bias is None else (a, q, scale, bias)
    # 2·M·N·K, then the scale, the bias and the activation per output
    # element; a, q (int8), scale and bias read once, the output written
    m, n = a.shape[0], q.shape[1]
    cost.add(cost.product(m, n, a.shape[1], bias is not None, activation)
             + m * n, cost.nbytes(*tensors)
             + m * n * torch.empty((), dtype=out_dtype).element_size())
    if on_gpu(*tensors):
        return _qmatmul_cuda(a, q, scale, bias, activation, out_dtype)
    return _qmatmul_ref(a, q, scale, bias, activation, out_dtype)
