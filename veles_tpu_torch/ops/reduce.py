"""Matrix reduction, beside its plain version.

Counterpart of :mod:`veles_tpu.ops.reduce`.  :func:`matrix_reduce`
reduces a 2-D matrix along ``axis`` (0: over rows, a per-column result
``(n,)``; 1: over columns, a per-row result ``(m,)``) with ``sum``,
``max`` or ``min``, accumulating in f32 and returning the input dtype
(f32 or bf16).  Which route it takes follows the JAX package: with
``root.common.engine.pallas_reduce`` off (the default) and no
``use_pallas``, :func:`_reduce_ref` (torch's own reduction in f32, the
counterpart of ``_reduce_jnp``); with the knob on or
``use_pallas=True``, a CUDA tensor launches the kernel
(``csrc/reduce.cu`` ``veles_reduce``, replacing ``_reduce_kernel``) or
raises, and a CPU tensor takes :func:`_reduce_ref`.  max and min
propagate NaN on both routes.  ``launches["reduce"]`` counts kernel
launches; only a launch adds to it.

:func:`plan` picks a launch's vector width and split from the shape
(the kernel's design is in ``csrc/reduce.cu``): axis 0 splits a column
strip's rows over a cluster of up to 8 blocks (:func:`row_range` gives
a rank's rows), axis 1 a row over up to 8 warps.  The kernel's max and
min are exact in any order; its sum is taken in another order than
torch's, which :func:`_reduce_plan_ref` models on the CPU for the tests.
"""

import collections
import ctypes
import math

import torch

from veles_tpu_torch.ops import cost
from veles_tpu_torch.ops.util import check_status, on_gpu, stream_handle

OPS = {"sum": 0, "max": 1, "min": 2}

#: kernel name -> launches since the last reset_launches()
launches = {"reduce": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``veles_reduce``'s ctypes argtypes
_ARGTYPES = [_P, _P] + [_I] * 8 + [_P]
_entry_fn = []

_SMS = 132                # the H100's SMs
WARPS = 8                 # warps a block (csrc/reduce.cu)
#: 16-byte loads a lane keeps in flight, along axis 0 and axis 1
LOADS = {0: 4, 1: 8}
MAX_SPLIT = 8             # the portable cluster size
_IDENTITY = {"sum": 0.0, "max": -math.inf, "min": math.inf}

#: A launch's plan.  ``vec``: values a load (1, or 16 bytes: 4 f32, 8
#: bf16).  ``split``: axis 0, the blocks of a cluster that share a
#: strip's rows; axis 1, the warps that share a row (1, 2, 4 or 8).
#: ``strip``: axis 0, the columns a block (32 loads wide); axis 1, the
#: rows a block.  ``warps``: a block's.
Plan = collections.namedtuple("Plan", "axis vec split strip warps")


def reset_launches():
    for name in launches:
        launches[name] = 0


def _entry():
    """The C entry ``veles_reduce``, building ``csrc/reduce.cu`` at first
    use."""
    if not _entry_fn:
        from veles_tpu_torch.ops import build
        fn = build.library("reduce").veles_reduce
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entry_fn.append(fn)
    return _entry_fn[0]


def vector_width(dtype):
    """Values in a 16-byte load of ``dtype``."""
    return 8 if dtype == torch.bfloat16 else 4


def plan(m, n, axis, dtype=torch.float32, aligned=True, split=None):
    """The launch of an (m, n) reduction along ``axis``: 16-byte loads
    where every row starts 16-byte ``aligned``, and a split that doubles
    (to 8 at most) while the grid covers the 132 SMs less than twice and
    each share keeps a warp's loads in flight (LOADS) busy twice over:
    axis 0 splits the rows (8 at (4096, 4096): 256 blocks), axis 1 a row
    over warps (1 at (4096, 4096): 512 blocks).  ``split`` forces
    one."""
    vec = vector_width(dtype) if aligned else 1
    if split is None:
        split = 1
        if axis == 0:
            strips = -(-n // (32 * vec))
            while (split < MAX_SPLIT and strips * split < 2 * _SMS
                   and m >= 2 * split * WARPS * LOADS[0]):
                split *= 2
        else:
            while (split < MAX_SPLIT
                   and -(-m * split // WARPS) < 2 * _SMS
                   and n >= 2 * split * 32 * vec * LOADS[1]):
                split *= 2
    if split not in (1, 2, 4, 8):
        raise ValueError("split must be 1, 2, 4 or 8, got %r" % (split,))
    strip = 32 * vec if axis == 0 else WARPS // split
    return Plan(axis, vec, split, strip, WARPS)


def launch_plan(a, axis, split=None):
    """:func:`plan` for the matrix ``a`` as the wrapper launches it:
    16-byte loads when its pointer and its row stride in bytes are
    multiples of 16."""
    m, n = a.shape
    row_bytes = a.stride(0) * a.element_size()
    aligned = a.data_ptr() % 16 == 0 and (m == 1 or row_bytes % 16 == 0)
    return plan(m, n, axis, a.dtype, aligned, split)


def row_range(rank, split, m):
    """Axis 0: the rows ``[r0, r1)`` of ``rank`` of ``split``, the
    rank-th of ``split`` contiguous chunks of ceil(m / split) rows (the
    kernel's arithmetic; a rank past the end gets none)."""
    chunk = -(-m // split)
    r0 = min(m, rank * chunk)
    return r0, min(m, r0 + chunk)


def _reduce_ref(a, axis, op):
    """Mirror of ``_reduce_jnp``: the reduction in f32, cast back."""
    fn = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}[op]
    return fn(a.float(), dim=axis).to(a.dtype)


def _fold(op, acc, x):
    """The lanes' fold: the sum, or fmax / fmin, which drop a NaN."""
    if op == "sum":
        return acc + x
    return torch.fmax(acc, x) if op == "max" else torch.fmin(acc, x)


def _merge(op, acc, x):
    """The merges' fold: the sum, or max / min where NaN wins."""
    if op == "sum":
        return acc + x
    return torch.maximum(acc, x) if op == "max" else torch.minimum(acc, x)


def _lanes(op, x):
    """Each lane's accumulators over its loads, ``x`` (loads, ...) in
    the lane's order, and their NaN flags turned into NaN (the kernel's
    ``Lane``); f32, in that order."""
    acc = torch.full(x.shape[1:], _IDENTITY[op], dtype=torch.float32)
    nan = torch.zeros(x.shape[1:], dtype=torch.bool)
    for load in x:
        acc = _fold(op, acc, load)
        nan |= torch.isnan(load)
    return torch.where(nan, torch.full_like(acc, math.nan), acc)


def _pad(x, dim, size, op):
    """``x`` padded along ``dim`` to ``size`` with the op's identity."""
    extra = size - x.shape[dim]
    if extra <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, torch.full(shape, _IDENTITY[op],
                                    dtype=x.dtype)], dim)


def _reduce_plan_ref(a, axis, op, launch):
    """A plain model of the kernel's order under the plan ``launch``,
    on the CPU, for the tests (the kernel on the card is held against
    :func:`_reduce_ref`).  Axis 0: warp w of rank k folds the rows w, w
    + 8, ... of :func:`row_range`, the 8 warps are merged in warp order
    and the ranks in rank order.  Axis 1: lane g of a row's 32 x split
    lanes folds the row's vectors g, g + 32 x split, ..., a lane's
    values are merged in order, the lanes of a warp by a butterfly of
    shuffles (16, 8, 4, 2, 1) and the warps in order.  Padding stands in
    for the kernel's masking with the same identities."""
    x = a.detach().float().cpu()
    m, n = x.shape
    if axis == 0:
        total = None
        for rank in range(launch.split):
            r0, r1 = row_range(rank, launch.split, m)
            steps = -(-(r1 - r0) // WARPS)
            rows = _pad(x[r0:r1], 0, steps * WARPS, op)
            acc = _lanes(op, rows.reshape(steps, WARPS, n))
            part = acc[0]
            for w in range(1, WARPS):
                part = _merge(op, part, acc[w])
            total = part if total is None else _merge(op, total, part)
        return total.to(a.dtype)
    lanes, vec = 32 * launch.split, launch.vec
    steps = -(-n // (lanes * vec))
    loads = _pad(x, 1, steps * lanes * vec, op).reshape(m, steps, lanes,
                                                        vec)
    acc = _lanes(op, loads.permute(1, 0, 2, 3))          # (m, lanes, vec)
    total = acc[..., 0]
    for c in range(1, vec):
        total = _merge(op, total, acc[..., c])
    warps = total.reshape(m, launch.split, 32)
    for offset in (16, 8, 4, 2, 1):
        warps = _merge(op, warps[..., :offset], warps[..., offset:2 * offset])
    out = warps[:, 0, 0]
    for w in range(1, launch.split):
        out = _merge(op, out, warps[:, w, 0])
    return out.to(a.dtype)


def _reduce_cuda(a, axis, op, split=None):
    """``veles_reduce``: a (m, n) f32 or bf16 with unit column stride;
    out (n,) for axis 0, (m,) for axis 1, in a's dtype.  ``split``
    forces the plan's split."""
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("matrix_reduce kernel takes float32 or bfloat16, "
                        "got %s" % a.dtype)
    m, n = a.shape
    if m == 0 or n == 0:
        raise ValueError("matrix_reduce of an empty %s matrix"
                         % (tuple(a.shape),))
    if a.stride(1) != 1 and n > 1:
        a = a.contiguous()
    out = torch.empty((n,) if axis == 0 else (m,), dtype=a.dtype,
                      device=a.device)
    launch = launch_plan(a, axis, split)
    status = _entry()(a.data_ptr(), out.data_ptr(), m, n, a.stride(0),
                      axis, OPS[op], int(a.dtype == torch.bfloat16),
                      launch.vec, launch.split, stream_handle(a.device))
    check_status("reduce", status)
    launches["reduce"] += 1
    return out


def matrix_reduce(a, axis=0, op="sum", use_pallas=None):
    """Reduce a 2D matrix along ``axis`` (0: over rows → per-column
    result, like the reference's default; 1: over columns → per-row)."""
    if a.dim() != 2:
        raise ValueError("matrix_reduce expects a 2-D matrix, got shape %s"
                         % (tuple(a.shape),))
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1, got %r" % (axis,))
    if op not in OPS:
        raise ValueError("op must be one of %s, got %r" % (sorted(OPS), op))
    if use_pallas is None:
        from veles_tpu_torch.config import root
        use_pallas = bool(root.common.engine.get("pallas_reduce", False))
    # one operation an element; the matrix read once, one row or column
    # of results written
    cost.add(a.numel(), cost.nbytes(a)
             + a.shape[1 - axis] * a.element_size())
    if use_pallas and on_gpu(a):
        return _reduce_cuda(a, axis, op)
    return _reduce_ref(a, axis, op)
