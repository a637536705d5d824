"""Pipeline parallelism: a GPipe schedule over a ``pipe`` mesh axis.
Counterpart of :mod:`veles_tpu.parallel.pp`.

Each rank of the pipe group holds ONE stage's parameters (its shard of
the stacked params, leading dim 1).  ``n_micro + n_stages - 1`` ticks
move activations one stage on with a differentiable ring shift
(:func:`~veles_tpu_torch.parallel.comm.ring_shift_grad`: forward to rank
+ 1, the gradient back to rank − 1); stage 0 takes a fresh microbatch a
tick and the last stage banks its result.  Every rank runs the same
operations every tick (a ``torch.where`` picks stage 0's input and the
last stage's banked rows, as the JAX body does), so the ranks' backward
passes issue their shifts in the same order.  The result, which only
the last stage computed, is made the same on every rank
(:func:`~veles_tpu_torch.parallel.comm.broadcast_from`: the gradient of
that replicated value counted once), and the replicated input ``x``
takes its gradient summed over the group.

Restriction (GPipe-classic): every stage maps activations of one shape
to the same shape.
"""

import torch

from veles_tpu_torch.parallel.comm import (broadcast_from, copy_to_group,
                                           ring_shift_grad)


def _pipeline_local(stage_params, x_stack, stage_fn, group, n, s):
    """The per-rank body: ``x_stack`` [n_micro, mb, ...] (only stage 0
    reads it); returns [n_micro, mb, ...], valid on the last stage."""
    n_micro = x_stack.shape[0]
    device = x_stack.device
    is_first = torch.tensor(s == 0, device=device)
    act = torch.zeros_like(x_stack[0])
    outs = torch.zeros_like(x_stack)
    for t in range(n_micro + n - 1):
        feed = x_stack[min(t, n_micro - 1)]
        inp = torch.where(is_first, feed, act)
        y = stage_fn(stage_params, inp)
        out_idx = t - (n - 1)
        valid = (s == n - 1) and 0 <= out_idx < n_micro
        slot = min(max(out_idx, 0), n_micro - 1)
        banked = outs.index_copy(0, torch.tensor([slot], device=device),
                                 y[None])
        outs = torch.where(torch.tensor(valid, device=device), banked,
                           outs)
        if t < n_micro + n - 2:
            act = ring_shift_grad(y, group) if n > 1 else y
    return outs


def pipeline_apply(stage_fn, stacked_params, x, mesh, n_micro,
                   pipe_axis="pipe", batch_axis=None):
    """Run ``x`` through the ``n_stages`` stages pipelined over the
    mesh's ``pipe`` axis.

    ``stacked_params``: a dict of this rank's stage shards (leading dim
    1, the rank's slice of the stacked ``[n_stages, ...]`` leaves).
    ``x``: [batch, ...] on every rank (this rank's slice of the
    ``batch_axis`` when one is given), split into ``n_micro``
    microbatches.  Returns stage_{n-1}(…stage_0(x)…) with x's shape on
    every rank."""
    del batch_axis
    n_stages = mesh.shape[pipe_axis]
    for leaf in stacked_params.values():
        if leaf.shape[0] != 1:
            raise ValueError(
                "stacked params leading dim %d != %d pipeline stages"
                % (leaf.shape[0] * n_stages, n_stages))
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError("batch %d not divisible by n_micro %d"
                         % (batch, n_micro))
    group = mesh.group(pipe_axis)
    if group is not None:
        x = copy_to_group(x, group)
    x_stack = x.reshape((n_micro, batch // n_micro) + tuple(x.shape[1:]))
    stage = {k: v[0] for k, v in stacked_params.items()}
    outs = _pipeline_local(stage, x_stack, stage_fn, group, n_stages,
                           mesh.index(pipe_axis))
    if group is not None:
        outs = broadcast_from(outs, group, n_stages - 1)
    return outs.reshape(x.shape)
