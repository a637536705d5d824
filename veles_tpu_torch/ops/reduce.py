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
"""

import ctypes

import torch

from veles_tpu_torch.ops.util import check_status, on_gpu, stream_handle

OPS = {"sum": 0, "max": 1, "min": 2}

#: kernel name -> launches since the last reset_launches()
launches = {"reduce": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_entry_fn = []


def reset_launches():
    for name in launches:
        launches[name] = 0


def _entry():
    """The C entry ``veles_reduce``, building ``csrc/reduce.cu`` at first
    use."""
    if not _entry_fn:
        from veles_tpu_torch.ops import build
        fn = build.library("reduce").veles_reduce
        fn.argtypes = [_P, _P] + [_I] * 6 + [_P]
        fn.restype = ctypes.c_int
        _entry_fn.append(fn)
    return _entry_fn[0]


def _reduce_ref(a, axis, op):
    """Mirror of ``_reduce_jnp``: the reduction in f32, cast back."""
    fn = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}[op]
    return fn(a.float(), dim=axis).to(a.dtype)


def _reduce_cuda(a, axis, op):
    """``veles_reduce``: a (m, n) f32 or bf16 with unit column stride;
    out (n,) for axis 0, (m,) for axis 1, in a's dtype."""
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
    status = _entry()(a.data_ptr(), out.data_ptr(), m, n, a.stride(0),
                      axis, OPS[op], int(a.dtype == torch.bfloat16),
                      stream_handle(a.device))
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
    if use_pallas and on_gpu(a):
        return _reduce_cuda(a, axis, op)
    return _reduce_ref(a, axis, op)
