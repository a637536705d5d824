"""Tensor parallelism helpers (Megatron-style sharding rules).
Counterpart of :mod:`veles_tpu.parallel.tp`.

The JAX package declares TP: parameters get shardings over the
``model`` axis and GSPMD inserts the all-reduces.  The port writes them:
a column-parallel product takes its input through
:func:`copy_to_group` (identity forward, all-reduce of the input
gradient backward) and a row-parallel product gives its output through
:func:`reduce_from_group` (all-reduce forward, identity backward), one
pair a column → row pair of products.  A spec is a tuple, as ``P(...)``
is (:mod:`veles_tpu_torch.parallel.mesh`).
"""

import torch

from veles_tpu_torch.parallel.comm import (  # noqa: F401 - exported
    all_gather, copy_to_group, reduce_from_group)
from veles_tpu_torch.parallel.mesh import Sharding, _axes_of


class _GatherColumns(torch.autograd.Function):
    """A column-parallel product's output made whole: forward an
    all-gather of the last dim over the group, backward this rank's
    columns of the gradient (every rank computes the same gradient of
    the whole output downstream)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return all_gather(x, group, x.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        first = ctx.group.index * ctx.width
        return grad[..., first:first + ctx.width].contiguous(), None


def gather_columns(x, group):
    return _GatherColumns.apply(x, group)


def shard_dim(ndim, dim, axis="model"):
    """The spec sharding exactly ``dim`` of an ``ndim``-rank weight over
    ``axis``."""
    spec = [None] * ndim
    spec[dim] = axis
    return tuple(spec)


def column_parallel(ndim=2, axis="model"):
    """Weight [in, out]: shard the OUTPUT features."""
    return shard_dim(ndim, ndim - 1, axis)


def row_parallel(ndim=2, axis="model"):
    """Weight [in, out]: shard the INPUT features (its input arrives
    feature-sharded from a column-parallel producer)."""
    return shard_dim(ndim, 0, axis)


def constrain(x, mesh, *spec, global_shape=None):
    """Check that ``x`` is laid out as ``spec`` on ``mesh``: no compiler
    takes a layout hint here, so the port checks what the JAX hint
    anchors.  Every axis the spec names must be the mesh's, the spec no
    longer than ``x``'s dims, and with ``global_shape`` each dim's local
    extent its global one over its axes' size.  Returns ``x``."""
    if len(spec) > x.dim():
        raise ValueError("constrain: spec %r for a %d-d tensor"
                         % (spec, x.dim()))
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        missing = [a for a in axes if a not in mesh.shape]
        if missing:
            raise ValueError("constrain: mesh %r has no axis %r"
                             % (mesh.shape, missing[0]))
        if global_shape is None:
            continue
        parts = mesh.axis_size(*axes)
        if global_shape[dim] % parts or \
                x.shape[dim] != global_shape[dim] // parts:
            raise ValueError(
                "constrain: dim %d is %d locally, not %d / %d (spec %r)"
                % (dim, x.shape[dim], global_shape[dim], parts, spec))
    return x


def sharding_tree(params, mesh, rule):
    """A :class:`~veles_tpu_torch.parallel.mesh.Sharding` tree:
    ``rule(path, leaf) -> spec or None`` (None: replicate); paths are
    the dict keys joined by ``/``."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        spec = rule("/".join(prefix), tree)
        return Sharding(mesh, spec if spec is not None else ())
    return walk(params, ())

