"""Minibatch gather: rows of device-resident tables selected by index,
each beside its plain PyTorch version.

Counterpart of :mod:`veles_tpu.ops.gather`:

- :func:`take_rows` is ``data[indices]`` along axis 0 with ``pad`` rows
  where an index is negative (the empty slots of a short minibatch);
  its plain version is :func:`_gather_ref` (the counterpart of
  ``_gather_jnp``).  The pad is 0 for data, as the TPU kernel writes,
  and -1 for labels, as the stitched loader head writes.
- :func:`take_rows_norm` is float32 ``data[indices] * scale + shift``
  with ZERO rows where an index is negative; its plain version is
  :func:`_gather_norm_ref` (``_gather_norm_jnp``).  It is the head of a
  uint8-resident dataset: the raw bytes are read once and the first
  forward sees normalized float32.
- :func:`take_rows_group` gathers the same indices from up to four
  tables, each raw (as :func:`take_rows`) or, one of them, normalized
  (as :func:`take_rows_norm`), in ONE launch: a minibatch's data and
  labels.  Its plain version applies the two plain versions table by
  table (:func:`_gather_group_ref`).
- :func:`take_rows_served` is the same group over the rows the stitched
  loader head serves: row ``i`` is taken at ``shuffled[offset + i]``
  where ``i < size`` and ``offset + i`` lies in the shuffled-index
  buffer, and is a pad row otherwise; ``offset`` and ``size`` are 0-d
  int32 tensors (the segment's scalar block), read on the device.  Its
  plain version, :func:`_gather_served_ref`, computes that index with
  five tensor ops (as the JAX head's ``where``/``take``) and then
  :func:`_gather_group_ref`.

On CUDA tensors the group launches ``csrc/gather.cu``
``veles_gather_group`` and the served rows ``veles_gather_served``
(both replacing ``_gather_kernel`` and ``_gather_norm_kernel``: one
block a row of every table; the served entry computes the index in the
same launch); on CPU tensors they take the plain versions.  An index
outside ``[0, len(data))`` gives the pad row on both routes.  The JAX
module's autotune verdicts, its negative cache of rejected shapes and
its silent fallback to XLA have no counterpart: a CUDA tensor launches
the kernel or raises.  ``launches`` counts launches of either entry,
under ``"gather_norm"`` when the group holds a normalized table, else
under ``"gather"``; ``tables_served`` counts the raw
(``"gather_tables"``) and normalized (``"gather_norm_tables"``) tables
those launches served, and ``entry_launches`` the launches of each C
entry.  Only a launch adds to them.
"""

import ctypes
import math

import torch

from veles_tpu_torch.backends import check_pallas_knob
from veles_tpu_torch.ops import cost
from veles_tpu_torch.ops.util import check_status, on_gpu, stream_handle

#: launches since the last reset_launches(), under "gather_norm" when the
#: group held a normalized table, else under "gather"
launches = {"gather": 0, "gather_norm": 0}
#: tables those launches served: raw ("gather_tables") and normalized
tables_served = {"gather_tables": 0, "gather_norm_tables": 0}
#: the same launches by C entry
entry_launches = {"veles_gather_group": 0, "veles_gather_served": 0}

#: the normalized table's types and their codes
NORM_DTYPES = {torch.uint8: 0, torch.int32: 1, torch.float32: 2}
#: tables one launch serves
MAX_TABLES = 4


class _Table(ctypes.Structure):
    """One table of a launch, as ``csrc/gather.cu`` ``GatherTableArg``:
    ``kind`` -1 moves rows of ``width`` bytes raw with the ``pad``
    pattern, 0 / 1 / 2 normalizes rows of ``width`` features (u8, int32,
    f32) with ``scale`` and ``shift`` (``stride`` 1: per feature)."""
    _fields_ = [("data", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n_rows", ctypes.c_longlong), ("width", ctypes.c_longlong),
                ("kind", ctypes.c_int), ("stride", ctypes.c_int),
                ("pad", ctypes.c_ulonglong), ("scale", ctypes.c_void_p),
                ("shift", ctypes.c_void_p)]


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: each C entry's argument types: (tables, n_tables, ...)
_ARGTYPES = {"veles_gather_group": [_P, _I, _P, _I, _P],
             "veles_gather_served": [_P, _I, _P, _L, _P, _P, _I, _P]}
#: the loaded C entries by name (a dict, so a test can swap in another
#: build's)
_entries = {}


def reset_launches():
    for counter in (launches, tables_served, entry_launches):
        for name in counter:
            counter[name] = 0


def _entry(name):
    """The C entry ``name``, building ``csrc/gather.cu`` at first use."""
    if name not in _entries:
        from veles_tpu_torch.ops import build
        fn = getattr(build.library("gather"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return _entries[name]


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


def _is_norm(how):
    """A table's ``how``: a ``(scale, shift)`` pair normalizes, a number
    is a raw table's pad."""
    return isinstance(how, (tuple, list))


def _gather_group_ref(tables, indices):
    """:func:`take_rows_group`'s plain version: :func:`_gather_norm_ref`
    or :func:`_gather_ref` table by table."""
    return [_gather_norm_ref(data, indices, *how) if _is_norm(how)
            else _gather_ref(data, indices, how) for data, how in tables]


def _served_indices(shuffled, offset, size, count):
    """The served rows' int32 indices, as the stitched head computes
    them: ``shuffled[offset + i]`` where ``i < size`` and ``offset + i``
    lies in ``shuffled``, else -1."""
    pos = torch.arange(count, dtype=torch.int64, device=shuffled.device)
    valid = pos < size.long()
    at = pos + offset.long()
    valid = valid & (at >= 0) & (at < shuffled.shape[0])
    served = shuffled.index_select(0, torch.where(valid, at, 0))
    return torch.where(valid, served, -1).to(torch.int32)


def _gather_served_ref(tables, shuffled, offset, size, count):
    """:func:`take_rows_served`'s plain version: the served indices
    (:func:`_served_indices`), then :func:`_gather_group_ref`."""
    return _gather_group_ref(tables,
                             _served_indices(shuffled, offset, size, count))


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


def _norm_table(data, scale, shift):
    """The normalized table's checks; its feature count."""
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
    return f


def _table_args(tables, indices, n_out):
    """The C tables of one launch of ``n_out`` rows over ``indices`` (the
    index vector, or the shuffled-index buffer) and their outputs; the
    count of normalized tables."""
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError("gather serves 1 to %d tables a launch, not %d"
                         % (MAX_TABLES, len(tables)))
    norms = sum(_is_norm(how) for _data, how in tables)
    if norms > 1:
        raise ValueError("gather normalizes at most one table a launch, "
                         "not %d" % norms)
    args = (_Table * len(tables))()
    outs = []
    for arg, (data, how) in zip(args, tables):
        _check_indices("gather_norm" if _is_norm(how) else "gather", data,
                       indices)
        shape = (n_out,) + tuple(data.shape[1:])
        if _is_norm(how):
            scale, shift = how
            f = _norm_table(data, scale, shift)
            out = torch.empty(shape, dtype=torch.float32, device=data.device)
            arg.kind, arg.width = NORM_DTYPES[data.dtype], f
            arg.stride = int(scale.numel() != 1)
            arg.scale, arg.shift = scale.data_ptr(), shift.data_ptr()
        else:
            out = torch.empty(shape, dtype=data.dtype, device=data.device)
            arg.kind = -1
            arg.width = math.prod(data.shape[1:]) * data.element_size()
            arg.pad = _pad_pattern(how, data.dtype)
        arg.data, arg.out, arg.n_rows = (data.data_ptr(), out.data_ptr(),
                                         data.shape[0])
        outs.append(out)
    return args, outs, norms


def _launched(entry, tables, norms):
    launches["gather_norm" if norms else "gather"] += 1
    tables_served["gather_norm_tables"] += norms
    tables_served["gather_tables"] += tables - norms
    entry_launches[entry] += 1


def _gather_group_cuda(tables, indices):
    """``veles_gather_group``: one launch over 1 to 4 contiguous tables,
    ``(data, pad)`` raw (any element type, rows moved as bytes) or one
    ``(data, (scale, shift))`` normalized (a u8, int32 or f32 table;
    scale and shift f32 tensors on the card, one value each or one per
    feature).  Returns the outputs, table by table."""
    args, outs, norms = _table_args(tables, indices, indices.shape[0])
    if not any(out.numel() for out in outs):
        return outs
    entry = "veles_gather_group"
    status = _entry(entry)(args, len(tables), indices.data_ptr(),
                           indices.shape[0], stream_handle(indices.device))
    check_status("gather", status)
    _launched(entry, len(tables), norms)
    return outs


def _check_scalars(shuffled, offset, size, count):
    for name, t in (("offset", offset), ("size", size)):
        if not isinstance(t, torch.Tensor) or t.dim() != 0 \
                or t.dtype != torch.int32 or t.device != shuffled.device:
            raise ValueError("take_rows_served takes %s as a 0-d int32 "
                             "tensor on the shuffled indices' device"
                             % name)
    if count < 0:
        raise ValueError("take_rows_served: count %d < 0" % count)


def _gather_served_cuda(tables, shuffled, offset, size, count):
    """``veles_gather_served``: the tables as for
    :func:`_gather_group_cuda`, ``count`` rows taken at the served
    indices, which the launch computes from the int32 ``shuffled``
    buffer and the 0-d int32 ``offset`` and ``size`` on the card (read
    when the kernel runs: a captured graph reads each replay's)."""
    _check_scalars(shuffled, offset, size, count)
    args, outs, norms = _table_args(tables, shuffled, count)
    if not any(out.numel() for out in outs):
        return outs
    entry = "veles_gather_served"
    status = _entry(entry)(args, len(tables), shuffled.data_ptr(),
                           shuffled.shape[0], offset.data_ptr(),
                           size.data_ptr(), count,
                           stream_handle(shuffled.device))
    check_status("gather", status)
    _launched(entry, len(tables), norms)
    return outs


def affine_tensors(norm, device):
    """``(scale, shift)`` of an affine normalizer (``as_affine()``: a
    number or one per feature each) as flat f32 tensors on ``device``,
    rounded to f32 as the JAX package's ``_norm_row`` rounds them.  A
    number beside one per feature (``internal_mean``, ``external_mean``)
    is repeated to the feature count: the kernel reads both with one
    stride."""
    scale, shift = (torch.as_tensor(v, dtype=torch.float32).reshape(-1)
                    for v in norm)
    if 1 in (scale.numel(), shift.numel()):
        n = max(scale.numel(), shift.numel())
        scale, shift = (t.expand(n).contiguous() for t in (scale, shift))
    return scale.to(device), shift.to(device)


def take_rows(data, indices, pad=0):
    """``data[indices]`` along axis 0 with ``pad`` rows where an index
    is negative: the group kernel with one table on CUDA tensors,
    :func:`_gather_ref` on CPU tensors.  ``indices`` are int32."""
    return take_rows_group([(data, pad)], indices)[0]


def take_rows_norm(data, indices, norm):
    """Fused gather + affine normalize: float32 ``data[indices] * scale
    + shift``, zero rows where an index is negative.  ``norm`` is
    ``(scale, shift)`` as :func:`affine_tensors` gives them (tensors on
    the table's device, which a captured graph needs), or as numbers or
    arrays."""
    return take_rows_group([(data, norm)], indices)[0]


def _specs(tables):
    """The tables with each normalized table's affine as tensors on its
    device, and every tensor they hold."""
    specs, tensors = [], []
    for data, how in tables:
        if _is_norm(how):
            how = tuple(how)
            if not all(isinstance(v, torch.Tensor) for v in how):
                how = affine_tensors(how, data.device)
            tensors += how
        specs.append((data, how))
        tensors.append(data)
    return specs, tensors


def _forced_off(value):
    """``pallas_gather`` picks the JAX package's jnp gather only when it
    is the boolean False (``veles_tpu/ops/gather.py`` honours a bool)."""
    return value is False


def _tally(specs, rows):
    """The cost of one gather launch of ``rows`` rows: each table's
    rows read and written once (its element type in, f32 out where it
    is normalized), the int32 index of each row read, and the scale and
    shift, two flops an element of a normalized table."""
    flops, nbytes = 0, 4 * rows
    for data, how in specs:
        row = math.prod(data.shape[1:])
        nbytes += rows * row * data.element_size()
        if _is_norm(how):
            flops += 2 * rows * row
            nbytes += 4 * rows * row
        else:
            nbytes += rows * row * data.element_size()
    cost.add(flops, nbytes)


def take_rows_group(tables, indices):
    """Rows ``indices`` (int32) of every table in one launch: ``tables``
    holds up to four ``(data, how)`` pairs, ``how`` a raw table's pad
    (:func:`take_rows`) or, for at most one table, a ``(scale, shift)``
    pair that normalizes it (:func:`take_rows_norm`).  Returns one
    output per table: the kernel on CUDA tensors,
    :func:`_gather_group_ref` on CPU tensors."""
    check_pallas_knob("pallas_gather", "the jnp row gather",
                      _forced_off)
    specs, tensors = _specs(tables)
    _tally(specs, indices.shape[0])
    if on_gpu(indices, *tensors):
        return _gather_group_cuda(specs, indices)
    return _gather_group_ref(specs, indices)


def take_rows_served(tables, shuffled, offset, size, count):
    """The stitched loader head's minibatch in one launch: ``count``
    rows of every table (``tables`` as for :func:`take_rows_group`),
    row ``i`` taken at ``shuffled[offset + i]`` where ``i < size`` and
    ``offset + i`` lies in ``shuffled`` (int32), a pad row otherwise.
    ``offset`` and ``size`` are 0-d int32 tensors, read on the device;
    ``count`` is the static row count (the largest minibatch).  The
    kernel on CUDA tensors, :func:`_gather_served_ref` on CPU tensors."""
    check_pallas_knob("pallas_gather", "the jnp row gather",
                      _forced_off)
    specs, tensors = _specs(tables)
    # the served rows' indices are read from ``shuffled`` too
    _tally(specs, count)
    if on_gpu(shuffled, offset, size, *tensors):
        return _gather_served_cuda(specs, shuffled, offset, size, count)
    return _gather_served_ref(specs, shuffled, offset, size, count)
