"""Synchronous data parallelism over the ranks of a mesh, and the
per-leaf sharding rules.  Counterpart of :mod:`veles_tpu.parallel.dp`.

The JAX package jits the train step over a mesh and lets GSPMD insert
the gradient all-reduce.  In the port each rank runs the step on its
contiguous rows of the global minibatch, and the step itself reduces:
it comes from :func:`~veles_tpu_torch.znicz.fused_graph.lower_specs`
with ``grad_reduce_axis="data"``, which averages the gradients and the
loss report over the axis and sums ``n_err`` (equal shards make the
mean of the shards' mean gradients the global one), so every rank
applies the single-device update and the parameters stay in lockstep
without being sent.

:func:`tp_rules`, :func:`fsdp_rules`, :func:`pp_rules` and
:func:`ep_rules` give the JAX rules' specs (tuples, as ``P(...)``) for
the same shapes; :func:`shard_params` cuts each rank's slices.  Over
sharded parameters the step itself carries the layout (``lower_specs(...,
param_rules=rules, mesh=mesh)``: it gathers, reduces and runs
column-parallel inside), so :func:`data_parallel` and
:func:`data_parallel_epoch` take ``param_rules`` for the JAX signature
and only cut the rows; the params given are the rank's slices
(:func:`shard_params`).  A pod (:mod:`veles_tpu_torch.pod`) takes the
same rules.
"""

import numpy
import torch

from veles_tpu_torch.parallel.mesh import shard


def _rows(mesh, batch_axis, n):
    """This rank's contiguous ``[start, stop)`` of ``n`` rows."""
    parts = mesh.shape.get(batch_axis, 1)
    if n % parts:
        raise ValueError("batch %d does not split over the %r axis (%d "
                         "ranks)" % (n, batch_axis, parts))
    per = n // parts
    start = mesh.index(batch_axis) * per
    return start, start + per


def data_parallel(step_fn, mesh, params_example=None, donate_params=True,
                  batch_axis="data", param_rules=None):
    """``step(params, x, labels) -> (params, metrics)`` over the mesh:
    ``x``/``labels`` are the GLOBAL minibatch on every rank, each rank
    runs ``step_fn`` (a ``grad_reduce_axis=batch_axis`` lowering) on its
    contiguous rows; params are updated in place (replicated, or the
    rank's slices under the ``param_rules`` the step was lowered
    with)."""
    del params_example, donate_params, param_rules

    def step(params, x, labels):
        start, stop = _rows(mesh, batch_axis, x.shape[0])
        return step_fn(params, x[start:stop], labels[start:stop])

    return step


def shard_params(params, mesh, param_rules=None):
    """Each rank's slices of a params tree (a list of per-layer dicts,
    or a dict) under ``param_rules(leaf) -> spec or None`` (None:
    replicated, the leaf itself)."""
    def place(leaf):
        if leaf is None or param_rules is None:
            return leaf
        spec = param_rules(leaf)
        return leaf if spec is None else shard(leaf, spec, mesh)

    if isinstance(params, dict):
        return {k: place(v) for k, v in params.items()}
    return [{k: place(v) for k, v in state.items()} for state in params]


def _shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else \
        numpy.shape(leaf)


def tp_rules(mesh, axis="model", min_elements=1024):
    """Megatron-style TP: every large-enough leaf whose LAST dim divides
    over ``axis`` shards it (column parallel); smaller leaves stay
    replicated."""
    if axis not in mesh.shape:
        raise ValueError(
            "tp_rules: mesh has no %r axis (mesh_axes must include "
            "it, e.g. {'data': d, %r: m})" % (axis, axis))
    size = mesh.shape[axis]

    def rules(leaf):
        shape = _shape(leaf)
        if not shape or int(numpy.prod(shape, initial=1)) < min_elements:
            return None
        if shape[-1] % size == 0 and shape[-1] >= size:
            spec = [None] * len(shape)
            spec[-1] = axis
            return tuple(spec)
        return None

    return rules


def fsdp_rules(mesh, axis="data", min_elements=1024):
    """ZeRO-3 / FSDP storage: every large-enough leaf shards its first
    dim that divides over ``axis``."""
    size = mesh.shape[axis]

    def rules(leaf):
        shape = _shape(leaf)
        if int(numpy.prod(shape, initial=1)) < min_elements:
            return None
        for dim, extent in enumerate(shape):
            if extent % size == 0 and extent >= size:
                spec = [None] * len(shape)
                spec[dim] = axis
                return tuple(spec)
        return None

    return rules


def pp_rules(mesh, axis="pipe", min_elements=1024):
    """Pipeline stage sharding: every large-enough leaf whose LEADING
    dim divides over ``axis`` shards it."""
    if axis not in mesh.shape:
        raise ValueError(
            "pp_rules: mesh has no %r axis (mesh_axes must include "
            "it, e.g. {'data': d, %r: s})" % (axis, axis))
    size = mesh.shape[axis]

    def rules(leaf):
        shape = _shape(leaf)
        if not shape or int(numpy.prod(shape, initial=1)) < min_elements:
            return None
        if shape[0] % size == 0 and shape[0] >= size:
            spec = [None] * len(shape)
            spec[0] = axis
            return tuple(spec)
        return None

    return rules


def ep_rules(mesh, axis="expert", min_elements=1024):
    """GShard-style expert sharding: the leading (expert) dim over
    ``axis``, as :func:`pp_rules`."""
    return pp_rules(mesh, axis=axis, min_elements=min_elements)


def data_parallel_epoch(step_fn, mesh, params_example, n_samples, batch,
                        batch_axis="data", param_rules=None):
    """A whole data-parallel epoch: ``epoch_fn(params, data, labels,
    generator) -> (params, stacked metrics)`` draws the single-device
    epoch's global permutation (:func:`~veles_tpu_torch.znicz
    .fused_graph.epoch_indices` from ``generator``), and each rank runs
    its contiguous columns of every minibatch.  The dataset is resident
    whole on every rank (the JAX function shards it and gathers)."""
    del params_example, param_rules
    from veles_tpu_torch.znicz.fused_graph import epoch_indices, run_steps
    start, stop = _rows(mesh, batch_axis, batch)

    def epoch_fn(params, data, labels, generator=None):
        idx = epoch_indices(n_samples, batch, generator)[:, start:stop]
        return run_steps(step_fn, params, data, labels,
                         idx.to(data.device))

    return epoch_fn


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the threefry2x32 words of the
    counter ``(0, data)`` under ``key`` (a pair of words or a seed)."""
    from veles_tpu_torch.ops.random import _key_words, threefry2x32
    return threefry2x32(_key_words(key), 0, int(data) & 0xFFFFFFFF)


def data_parallel_epoch_local(step_fn_reduced, mesh, n_local, batch_local,
                              batch_axis="data"):
    """The bandwidth-optimal epoch: each rank keeps its own slice of the
    dataset and samples it locally, only the gradient reduction crossing
    ranks (``step_fn_reduced`` must be a ``grad_reduce_axis=batch_axis``
    lowering).  Each rank folds its index on the axis into the epoch key
    (:func:`fold_in`) and draws its permutation with the port's threefry
    (:func:`~veles_tpu_torch.ops.random.threefry_permutation`), as the
    JAX function does.  ``epoch_fn(params, data_local, labels_local,
    key)``; ``key`` is ``jax.random.key(seed)``'s seed or a word pair."""
    from veles_tpu_torch.ops.random import threefry_permutation
    from veles_tpu_torch.znicz.fused_graph import run_steps
    steps = n_local // batch_local
    if steps == 0:
        raise ValueError("dataset smaller than one minibatch")
    shard_index = mesh.index(batch_axis)

    def epoch_fn(params, data_local, labels_local, key):
        perm = threefry_permutation(fold_in(key, shard_index), n_local)
        idx = perm[:steps * batch_local].reshape(steps, batch_local)
        return run_steps(step_fn_reduced, params, data_local, labels_local,
                         idx.to(torch.int32).to(data_local.device))

    return epoch_fn
