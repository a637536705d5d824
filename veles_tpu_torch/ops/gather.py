"""Minibatch gather: rows of a device-resident table selected by index,
each beside its plain PyTorch version.

Counterpart of :mod:`veles_tpu.ops.gather`:

- :func:`take_rows` is ``data[indices]`` along axis 0 with ``pad`` rows
  where an index is negative (the empty slots of a short minibatch):
  the kernel (``csrc/gather.cu`` ``veles_gather_rows``, replacing
  ``_gather_kernel``) on CUDA tensors, :func:`_gather_ref` (the
  counterpart of ``_gather_jnp``) on CPU tensors.  The pad is 0 for
  data, as the TPU kernel writes, and -1 for labels, as the stitched
  loader head writes.
- :func:`take_rows_norm` is float32 ``data[indices] * scale + shift``
  with ZERO rows where an index is negative: the kernel
  (``veles_gather_norm``, replacing ``_gather_norm_kernel``) on CUDA
  tensors, :func:`_gather_norm_ref` (``_gather_norm_jnp``) on CPU
  tensors.  It is the head of a uint8-resident dataset: the raw bytes
  are read once and the first forward sees normalized float32.

An index outside ``[0, len(data))`` gives the pad row on both routes.
The JAX module's autotune verdicts, its negative cache of rejected
shapes and its silent fallback to XLA have no counterpart: a CUDA
tensor launches the kernel or raises.  ``launches`` counts kernel
launches by kernel name; only a launch adds to it.
"""

import ctypes
import math

import torch

from veles_tpu_torch.ops.util import check_status, on_gpu, stream_handle

#: kernel name -> launches since the last reset_launches()
launches = {"gather": 0, "gather_norm": 0}

#: the gather_norm kernel's table types and their codes
NORM_DTYPES = {torch.uint8: 0, torch.int32: 1, torch.float32: 2}

_P, _I, _L, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_ulonglong)
#: kernel name -> (C symbol, ctypes argtypes), all in csrc/gather.cu
_ARGTYPES = {
    "gather": ("veles_gather_rows", [_P] * 3 + [_L, _I, _L, _U, _P]),
    "gather_norm": ("veles_gather_norm",
                    [_P, _I, _P, _P, _L, _I, _L, _P, _P, _I, _P]),
}
_entries = {}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _entry(name):
    """The C entry of kernel ``name``, building ``csrc/gather.cu`` at
    first use."""
    fn = _entries.get(name)
    if fn is None:
        from veles_tpu_torch.ops import build
        symbol, argtypes = _ARGTYPES[name]
        fn = getattr(build.library("gather"), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


# -- plain versions (the CPU path and the kernels' references) -------------

def _valid(data, indices):
    idx = indices.long()
    return idx, (idx >= 0) & (idx < data.shape[0])


def _gather_ref(data, indices, pad=0):
    """Mirror of ``_gather_jnp``: ``data[indices]`` with ``pad`` rows
    for an index outside the table."""
    idx, valid = _valid(data, indices)
    rows = data.index_select(0, torch.where(valid, idx, 0))
    mask = valid.reshape((-1,) + (1,) * (data.dim() - 1))
    return torch.where(mask, rows, torch.full_like(rows, pad))


def _gather_norm_ref(data, indices, scale, shift):
    """Mirror of ``_gather_norm_jnp``: float32 ``data[indices] * scale +
    shift`` (a multiply, then an add), zero rows for an index outside
    the table; ``scale``/``shift`` are f32 tensors of one value or one
    per feature."""
    idx, valid = _valid(data, indices)
    rows = data.index_select(0, torch.where(valid, idx, 0))
    flat = rows.reshape(rows.shape[0], -1).float()
    normed = flat * scale.reshape(1, -1) + shift.reshape(1, -1)
    normed = torch.where(valid[:, None], normed, torch.zeros_like(normed))
    return normed.reshape(rows.shape)


# -- kernel wrappers --------------------------------------------------------

def _check_indices(name, data, indices):
    if indices.dtype != torch.int32 or indices.dim() != 1 \
            or not indices.is_contiguous():
        raise ValueError("%s takes contiguous 1-D int32 indices, got %s %s"
                         % (name, indices.dtype, tuple(indices.shape)))
    if data.dim() < 1 or not data.is_contiguous():
        raise ValueError("%s needs a contiguous table of at least one "
                         "dimension, got %s" % (name, tuple(data.shape)))
    if indices.device != data.device:
        raise ValueError("%s operands on different devices" % name)


def _pad_pattern(pad, dtype):
    """The pad element's bytes repeated into 8 (the kernel's pattern)."""
    element = torch.full((1,), pad, dtype=dtype).view(torch.uint8)
    size = element.numel()
    if 8 % size:
        raise TypeError("gather pads elements of 1, 2, 4 or 8 bytes, "
                        "not %s" % dtype)
    return int.from_bytes(bytes(element.tolist()) * (8 // size), "little")


def _gather_cuda(data, indices, pad):
    """``veles_gather_rows``: a contiguous table of any element type,
    rows moved as raw bytes."""
    _check_indices("gather", data, indices)
    out = torch.empty((indices.shape[0],) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    if out.numel() == 0:
        return out
    row_bytes = math.prod(data.shape[1:]) * data.element_size()
    status = _entry("gather")(
        data.data_ptr(), indices.data_ptr(), out.data_ptr(), data.shape[0],
        indices.shape[0], row_bytes, _pad_pattern(pad, data.dtype),
        stream_handle(data.device))
    check_status("gather", status)
    launches["gather"] += 1
    return out


def _gather_norm_cuda(data, indices, scale, shift):
    """``veles_gather_norm``: a contiguous u8, int32 or f32 table; scale
    and shift f32 on the card, one value each or one per feature."""
    _check_indices("gather_norm", data, indices)
    if data.dtype not in NORM_DTYPES:
        raise TypeError("gather_norm takes %s tables, got %s"
                        % (sorted(str(t) for t in NORM_DTYPES), data.dtype))
    f = math.prod(data.shape[1:])
    sizes = {scale.numel(), shift.numel()}
    for t in (scale, shift):
        if t.dtype != torch.float32 or t.device != data.device \
                or not t.is_contiguous():
            raise ValueError("gather_norm takes contiguous f32 scale and "
                             "shift on the table's device")
    if sizes not in ({1}, {f}):
        raise ValueError("gather_norm: scale and shift hold %s values, "
                         "want 1 or %d each" % (sorted(sizes), f))
    out = torch.empty((indices.shape[0],) + tuple(data.shape[1:]),
                      dtype=torch.float32, device=data.device)
    if out.numel() == 0:
        return out
    status = _entry("gather_norm")(
        data.data_ptr(), NORM_DTYPES[data.dtype], indices.data_ptr(),
        out.data_ptr(), data.shape[0], indices.shape[0], f,
        scale.data_ptr(), shift.data_ptr(), int(sizes != {1}),
        stream_handle(data.device))
    check_status("gather_norm", status)
    launches["gather_norm"] += 1
    return out


def affine_tensors(norm, device):
    """``(scale, shift)`` of an affine normalizer (``as_affine()``: a
    number or one per feature each) as flat f32 tensors on ``device``,
    rounded to f32 as the JAX package's ``_norm_row`` rounds them."""
    return tuple(torch.as_tensor(v, dtype=torch.float32).reshape(-1)
                 .to(device) for v in norm)


def take_rows(data, indices, pad=0):
    """``data[indices]`` along axis 0 with ``pad`` rows where an index
    is negative: the kernel on CUDA tensors, :func:`_gather_ref` on CPU
    tensors.  ``indices`` are int32."""
    if on_gpu(data, indices):
        return _gather_cuda(data, indices, pad)
    return _gather_ref(data, indices, pad)


def take_rows_norm(data, indices, norm):
    """Fused gather + affine normalize: float32 ``data[indices] * scale
    + shift``, zero rows where an index is negative.  ``norm`` is
    ``(scale, shift)`` as :func:`affine_tensors` gives them (tensors on
    the table's device, which a captured graph needs), or as numbers or
    arrays."""
    scale, shift = norm
    if not isinstance(scale, torch.Tensor) \
            or not isinstance(shift, torch.Tensor):
        scale, shift = affine_tensors(norm, data.device)
    if on_gpu(data, indices, scale, shift):
        return _gather_norm_cuda(data, indices, scale, shift)
    return _gather_norm_ref(data, indices, scale, shift)
