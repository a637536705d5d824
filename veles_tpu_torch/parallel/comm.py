"""The port's collectives: counted wrappers over ``torch.distributed``
and the autograd functions the SPMD modules build on.

The JAX package writes its collectives inside ``shard_map`` bodies
(``psum``, ``ppermute``, ``all_to_all``) and lets XLA schedule them; the
port issues them itself, each through one wrapper here that adds one to
:data:`counts` per collective it issues, by kind:

- ``all_reduce`` (:func:`all_reduce`, the Megatron pair, the gradient
  reductions of the data-parallel steps),
- ``all_to_all`` (:func:`all_to_all`: Ulysses and the expert routing),
- ``ring_shift`` (:func:`ring_shift`: one ``batch_isend_irecv`` moving
  tensors to the next rank of a group and receiving the previous
  rank's: the ring attention's hops and the pipeline's ticks),
- ``all_gather`` (:func:`all_gather`: ``mesh.unshard``).

Each wrapper also adds the payload it moves to :data:`bytes_moved`, by
kind: the reduced tensor, the gathered result, the exchanged tensor,
the tensors a ring shift sends.

A group is a :class:`Group`: the ``ProcessGroup`` and its global ranks
in group order.  A collective on a one-rank group is still issued (the
card's one-rank NCCL group runs them), except a ring shift, which has
nothing to move.
"""

import collections

import torch
import torch.distributed as dist

#: collectives issued since the last :func:`reset_counts`, by kind
counts = collections.Counter()
#: their payload bytes since the last :func:`reset_counts`, by kind
bytes_moved = collections.Counter()
KINDS = ("all_reduce", "all_to_all", "ring_shift", "all_gather")


def reset_counts():
    counts.clear()
    bytes_moved.clear()
    for kind in KINDS:
        counts[kind] = 0
        bytes_moved[kind] = 0


def total_bytes():
    """The payload bytes of every collective since the last
    :func:`reset_counts`."""
    return sum(bytes_moved.values())


def _nbytes(tensor):
    return tensor.numel() * tensor.element_size()


reset_counts()


class Group(object):
    """A process group and its global ranks, in group order."""

    def __init__(self, pg, ranks):
        self.pg = pg
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        rank = dist.get_rank()
        self.index = self.ranks.index(rank) if rank in self.ranks else None

    def peer(self, offset):
        """The global rank ``offset`` places after this one in the
        group, cyclically."""
        return self.ranks[(self.index + offset) % self.size]

    def __repr__(self):
        return "Group(%s)" % (self.ranks,)


def all_reduce(tensor, group, op="sum"):
    """Sum (or ``op="max"``) ``tensor`` over ``group`` in place; returns
    it."""
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(tensor, op=reduce_op, group=group.pg)
    counts["all_reduce"] += 1
    bytes_moved["all_reduce"] += _nbytes(tensor)
    return tensor


def all_to_all(tensor, group):
    """``all_to_all_single`` of a tensor whose leading dim is the group
    size: slice ``i`` goes to the group's rank ``i``, and slice ``j`` of
    the result came from its rank ``j``."""
    tensor = tensor.contiguous()
    if tensor.shape[0] != group.size:
        raise ValueError("all_to_all: leading dim %d != group size %d"
                         % (tensor.shape[0], group.size))
    out = torch.empty_like(tensor)
    dist.all_to_all_single(out, tensor, group=group.pg)
    counts["all_to_all"] += 1
    bytes_moved["all_to_all"] += _nbytes(tensor)
    return out


def ring_shift(tensors, group, offset=1):
    """Send each tensor to the rank ``offset`` after this one in
    ``group`` and return the ones the rank ``offset`` before sent, in
    one ``batch_isend_irecv``.  A one-rank group returns its input."""
    if group.size == 1:
        return list(tensors)
    tensors = [t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in tensors]
    dest, source = group.peer(offset), group.peer(-offset)
    ops = []
    for sent, into in zip(tensors, received):
        ops.append(dist.P2POp(dist.isend, sent, dest, group.pg))
        ops.append(dist.P2POp(dist.irecv, into, source, group.pg))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    counts["ring_shift"] += 1
    bytes_moved["ring_shift"] += sum(_nbytes(t) for t in tensors)
    return received


def all_gather(tensor, group, dim=0):
    """The group's tensors concatenated along ``dim``, in group order."""
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(group.size)]
    dist.all_gather(parts, tensor, group=group.pg)
    counts["all_gather"] += 1
    out = torch.cat(parts, dim)
    bytes_moved["all_gather"] += _nbytes(out)
    return out


# -- autograd functions -----------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward.  Put
    before the column-parallel product, it sums the input gradient over
    the tensor-parallel group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward.  (The
    ``torch.distributed.nn`` all-reduce also reduces in its backward,
    which multiplies a replicated loss's gradient by the group size.)"""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` with its backward, the same exchange of the
    gradient slices (equal splits make the exchange its own
    transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad, ctx.group), None


class _RingShift(torch.autograd.Function):
    """:func:`ring_shift` of one tensor: forward to the next rank, its
    gradient back to the previous one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift([x], group, 1)[0]

    @staticmethod
    def backward(ctx, grad):
        return ring_shift([grad], ctx.group, -1)[0], None


class _BroadcastFrom(torch.autograd.Function):
    """A tensor that only the group's rank ``root`` (a group index)
    holds, made the same on every rank: forward a broadcast (a sum with
    the other ranks' zeros), backward the gradient kept on ``root`` and
    zero elsewhere, the gradient of a replicated value counted once."""

    @staticmethod
    def forward(ctx, x, group, root):
        ctx.keep = group.index == root
        out = x.clone() if ctx.keep else torch.zeros_like(x)
        return all_reduce(out, group)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.keep else torch.zeros_like(grad)), None, None


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)


def all_to_all_grad(x, group):
    return _AllToAll.apply(x, group)


def ring_shift_grad(x, group):
    return _RingShift.apply(x, group)


def broadcast_from(x, group, root):
    return _BroadcastFrom.apply(x, group, root)
