"""Random fills: torch's generators, and a counter-based uniform kernel.

Counterpart of :mod:`veles_tpu.ops.random`.  Two paths, as there:

* :func:`uniform`, :func:`normal` and :func:`dropout_mask` draw from an
  explicit ``torch.Generator`` (the JAX package's ``jax.random`` key);
  they are plain torch, and are held to the distribution, not to
  threefry's bits.
* :func:`threefry_bits`, :func:`threefry_uniform`,
  :func:`threefry_bernoulli` and :func:`threefry_split` give the bits of
  ``jax.random.bits``, ``uniform``, ``bernoulli`` and ``split`` over a
  key, ``jax.random.key(seed)`` or one split from it (the threefry2x32
  stream of JAX's default implementation, with
  ``jax_threefry_partitionable`` on): the masks of dropout and
  stochastic pooling, which the JAX units draw from an int32 seed, and
  the RBM's Gibbs samples, drawn over split keys.  They
  are plain torch integer arithmetic over int64 tensors holding uint32
  words, on the seed's device, so the seed may be a device tensor that a
  CUDA graph advances in place.
* :func:`uniform_pallas` fills ``[low, high)`` from ``(seed, shape)``
  alone: on the card the kernel (``csrc/random.cu`` ``veles_uniform``,
  replacing ``_uniform_kernel``), elsewhere :func:`_uniform_ref`.  Both
  run Philox4x32-10 with the seed as key and the flat element index
  divided by 4 as counter, map the top 24 bits of a word to [0, 1), then
  ``u * (high - low) + low`` in f32 (two roundings) and the cast to
  ``dtype``, keeping a value that rounded up to ``high`` below it.  So
  the card and the CPU give the same bits for the same (seed, shape),
  which the reference does not promise: its TPU bits and its off-TPU
  threefry fallback differ.

``launches["uniform"]`` counts kernel launches; only a launch adds to
it.
"""

import ctypes
import math

import numpy
import torch

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.ops import cost
from veles_tpu_torch.ops.util import check_status, stream_handle

#: kernel name -> launches since the last reset_launches()
launches = {"uniform": 0}

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_DTYPES = (torch.float32, torch.bfloat16)

#: ``veles_uniform``'s ctypes argtypes
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
             ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_entry_fn = []


def reset_launches():
    for name in launches:
        launches[name] = 0


def _entry():
    """The C entry ``veles_uniform``, building ``csrc/random.cu`` at first
    use."""
    if not _entry_fn:
        from veles_tpu_torch.ops import build
        fn = build.library("random").veles_uniform
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entry_fn.append(fn)
    return _entry_fn[0]


# -- torch's generators -----------------------------------------------------

def uniform(generator, shape, dtype=torch.float32, low=0.0, high=1.0):
    """U[low, high) of ``shape`` from ``generator``, on its device."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.uniform_(low, high, generator=generator)


def normal(generator, shape, dtype=torch.float32, mean=0.0, stddev=1.0):
    """N(mean, stddev²) of ``shape`` from ``generator``, on its device."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.normal_(0.0, 1.0, generator=generator) * stddev + mean


def dropout_mask(generator, shape, keep_prob, dtype=torch.float32):
    """Inverted-dropout multiplier: 0 with prob (1-keep), else 1/keep
    (ref Znicz ``dropout.DropoutForward`` semantics)."""
    draw = torch.rand(shape, generator=generator, device=generator.device)
    keep = draw < keep_prob
    return keep.to(dtype) / torch.tensor(keep_prob, dtype=dtype,
                                         device=generator.device)


# -- threefry2x32: the bits of jax.random over jax.random.key(seed) ---------

#: the rotations of threefry2x32's even and odd groups of four rounds
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key = (k0, k1)``: int64 tensors (or ints) holding uint32 values;
    returns the two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _key_words(key):
    """The two uint32 words of a key: ``(k0, k1)`` given as a pair (ints
    or 0-d int64 tensors), or a seed (an int or a 0-d integer tensor,
    taken as uint32 as the JAX units cast their int32 seed), whose key
    is ``jax.random.key(seed)``'s ``(0, seed)``."""
    if isinstance(key, (tuple, list)):
        k0, k1 = key
    else:
        k0, k1 = 0, key
    words = []
    for k in (k0, k1):
        if isinstance(k, torch.Tensor):
            words.append(k.to(torch.int64) & _M32)
        else:
            words.append(int(k) & _M32)
    return tuple(words)


def _key_device(key, device):
    for k in (key if isinstance(key, (tuple, list)) else (key,)):
        if isinstance(k, torch.Tensor):
            return k.device
    return device or "cpu"


def threefry_split(key, num=2):
    """``jax.random.split(key, num)``: a list of ``num`` keys (pairs of
    words, ints for an int key), key ``i`` being the two output words of
    threefry2x32 over the counter ``(0, i)`` (the partitionable
    layout)."""
    words = _key_words(key)
    return [threefry2x32(words, 0, i) for i in range(int(num))]


def threefry_bits(key, shape, device=None):
    """``jax.random.bits(key, shape)`` (uint32 words in an int64 tensor)
    for a key pair or a seed (:func:`_key_words`).  The partitionable
    layout: element ``i`` (row-major) hashes the counter ``(i >> 32, i &
    0xFFFFFFFF)`` and its bits are the XOR of the two output words.  On
    the key's device when a word is a tensor, else ``device`` (the CPU
    by default)."""
    device = _key_device(key, device)
    words = _key_words(key)
    shape = tuple(int(s) for s in shape)
    count = math.prod(shape)
    idx = torch.arange(count, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(words, idx >> 32, idx & _M32)
    return (x0 ^ x1).reshape(shape)


def threefry_uniform(key, shape, device=None):
    """``jax.random.uniform(key, shape)`` in float32: the top 23 bits of
    each word as the mantissa of a float in [1, 2), minus 1."""
    bits = threefry_bits(key, shape, device)
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def threefry_bernoulli(key, p, shape=None, device=None):
    """``jax.random.bernoulli(key, p, shape)``: the float32 uniform draw
    below ``p``.  A tensor ``p`` gives the shape and the device when
    they are not given (the JAX call with ``shape=None``); a float ``p``
    is rounded to float32 first, as JAX casts it."""
    if isinstance(p, torch.Tensor):
        if shape is None:
            shape = p.shape
        if device is None:
            device = p.device
        return threefry_uniform(key, shape, device) < p.to(torch.float32)
    return threefry_uniform(key, shape, device) < numpy.float32(p)


# -- the counter-based uniform fill -----------------------------------------

def _key(seed):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _M32, seed >> 32


def _affine(dtype, low, high):
    """``(span, lo, cap)``: f32 ``high - low`` and ``low``, and the
    largest value of ``dtype`` below ``high`` (as a float)."""
    if dtype not in _DTYPES:
        raise TypeError("uniform_pallas fills float32 or bfloat16, not %s"
                        % dtype)
    low, high = float(low), float(high)
    if not (math.isfinite(low) and math.isfinite(high) and low < high):
        raise ValueError("uniform_pallas needs finite low < high, got "
                         "[%r, %r)" % (low, high))
    cap = torch.tensor(high, dtype=torch.float64).to(dtype)
    down = torch.tensor(-math.inf, dtype=dtype)
    while float(cap) >= high:
        cap = torch.nextafter(cap, down)
    return (float(numpy.float32(high - low)), float(numpy.float32(low)),
            float(cap))


def _mulhilo(a, b):
    """(hi, lo) 32-bit halves of the constant ``a`` times the int64
    tensor ``b`` (both < 2^32) without overflowing int64: b is split
    into 16-bit halves."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (t >> 32)) & _M32, t & _M32


def philox_words(seed, count, device="cpu"):
    """The first ``count`` 32-bit words (int64 tensor) of Philox4x32-10
    keyed by ``seed``: word ``i`` is word ``i % 4`` of counter ``i //
    4``."""
    k0, k1 = _key(seed)
    n_ctr = -(-int(count) // 4)
    idx = torch.arange(n_ctr, dtype=torch.int64, device=device)
    c0, c1 = idx & _M32, idx >> 32
    c2 = torch.zeros_like(idx)
    c3 = torch.zeros_like(idx)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack((c0, c1, c2, c3), dim=1).reshape(-1)[:count]


def _uniform_ref(seed, shape, dtype=torch.float32, low=0.0, high=1.0,
                 device="cpu"):
    """The plain version of the kernel, the same bits: Philox in torch
    int64 on ``device``."""
    span, lo, cap = _affine(dtype, low, high)
    shape = tuple(int(s) for s in shape)
    count = int(numpy.prod(shape, dtype=numpy.int64))
    words = philox_words(seed, count, device)
    u = (words >> 8).to(torch.float32) * (1.0 / (1 << 24))
    f32 = dict(dtype=torch.float32, device=u.device)
    value = torch.add(torch.mul(u, torch.tensor(span, **f32)),
                      torch.tensor(lo, **f32))
    return torch.clamp(value.to(dtype), max=cap).reshape(shape)


def _uniform_cuda(seed, shape, dtype, low, high, device):
    span, lo, cap = _affine(dtype, low, high)
    shape = tuple(int(s) for s in shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    k0, k1 = _key(seed)
    status = _entry()(out.data_ptr(), out.numel(), k0, k1, span, lo, cap,
                      int(dtype == torch.bfloat16), stream_handle(device))
    check_status("uniform", status)
    launches["uniform"] += 1
    return out


def uniform_pallas(seed, shape, dtype=torch.float32, low=0.0, high=1.0,
                   device=None):
    """Uniform ``[low, high)`` fill from ``(seed, shape)``: the kernel on
    the card (``device`` defaults to ``cuda`` and raises without one),
    :func:`_uniform_ref` on the CPU; the same bits on both."""
    device = resolve_device(device)
    # the affine to [low, high), two flops an element (the Philox rounds
    # are integer work); the output written once
    count = math.prod(shape) if not isinstance(shape, int) else shape
    cost.add(2 * count, count * torch.empty((), dtype=dtype).element_size())
    if device.type == "cuda":
        return _uniform_cuda(seed, shape, dtype, low, high, device)
    return _uniform_ref(seed, shape, dtype, low, high, device)


def threefry_permutation(key, n):
    """``jax.random.permutation(key, n)``: ``ceil(3 ln n / ln(2^32 -
    1))`` rounds, each splitting the key (:func:`threefry_split`) and
    stably sorting the order by the subkey's uint32 bits
    (:func:`threefry_bits`).  An int64 CPU tensor."""
    rounds = int(math.ceil(3 * math.log(max(1, n))
                           / math.log(0xFFFFFFFF)))
    order = torch.arange(n, dtype=torch.int64)
    for _ in range(rounds):
        key, subkey = threefry_split(key, 2)
        bits = threefry_bits(subkey, (n,))
        order = order[torch.sort(bits, stable=True).indices]
    return order
