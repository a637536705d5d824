"""Multi-process execution: every process runs the same program, one
rank of ``torch.distributed``'s default group.  Counterpart of
:mod:`veles_tpu.parallel.multihost`.

:func:`initialize` joins this process into the group from explicit
arguments or the ``VELES_COORDINATOR`` / ``VELES_NUM_PROCS`` /
``VELES_PROC_ID`` variables (what :mod:`veles_tpu_torch.scripts
.spmd_launch` sets on every rank).  The backend follows the device:
NCCL on the card (one card a process: ``cuda:<rank % cards>``), gloo on
the CPU.  A backend that fails to start raises: the call never falls
back to the other.  A coordinator ``host:port`` is a TCP rendezvous
(rank 0 listens there); one with a scheme (``file:///path``,
``tcp://...``) is passed as ``init_method`` as it is; a one-process
group with no coordinator rendezvouses in memory.

:class:`process_double` simulates a multi-process session in one
process for the tests, as the JAX class does.
"""

import contextlib
import os

import numpy
import torch
import torch.distributed as dist

from veles_tpu_torch.backends import resolve_device

#: the active :class:`process_double`, or None
_double = None


class MultiHostShardError(ValueError):
    """A host-local shard cannot take part in one global array: the
    global batch does not divide over the processes, or the sharding's
    data axis cannot split evenly across them."""


class process_double(object):
    """Simulated multi-process session on one real process: ``with
    process_double(2) as dbl:`` makes :func:`process_count` report 2 and
    :func:`initialize` a no-op; ``with dbl.rank(i):`` runs a block as
    process ``i``.  Ranks run one after another, so
    :func:`from_host_local` banks each rank's shard and returns the
    global array assembled so far (zeros where a rank has not given
    its shard yet); the last rank's call returns all of it."""

    def __init__(self, num_processes):
        if num_processes < 1:
            raise ValueError("process_double needs >= 1 processes")
        self.num_processes = num_processes
        self.current = 0
        self._counters = [0] * num_processes
        self._banked = {}        # call seq -> {rank: local numpy}

    def __enter__(self):
        global _double
        if _double is not None:
            raise RuntimeError("process_double does not nest")
        _double = self
        return self

    def __exit__(self, *exc):
        global _double
        _double = None
        return False

    @contextlib.contextmanager
    def rank(self, index):
        """Run the with-block as simulated process ``index``."""
        if not 0 <= index < self.num_processes:
            raise ValueError("rank %d outside [0, %d)"
                             % (index, self.num_processes))
        prev, self.current = self.current, index
        try:
            yield
        finally:
            self.current = prev

    def bank_shard(self, local_batch, global_shape):
        """Bank the current rank's shard; ``(global numpy, complete)``,
        zeros where a rank has not contributed yet."""
        seq = self._counters[self.current]
        self._counters[self.current] += 1
        slot = self._banked.setdefault(seq, {})
        slot[self.current] = numpy.asarray(local_batch)
        out = numpy.zeros(global_shape,
                          dtype=numpy.asarray(local_batch).dtype)
        offset = 0
        for rank in range(self.num_processes):
            shard = slot.get(rank)
            if shard is not None:
                out[offset:offset + shard.shape[0]] = shard
                offset += shard.shape[0]
            else:
                # the SPMD even split for a missing rank (only the last
                # shard may be uneven)
                offset += global_shape[0] // self.num_processes
        return out, len(slot) == self.num_processes


def _init_method(coordinator):
    if "://" in coordinator:
        return coordinator
    return "tcp://" + coordinator


def initialize(coordinator=None, num_processes=None, process_id=None,
               device=None, timeout=None):
    """Join this process into the default process group (see the
    module); ``device`` picks the backend (the card when None, raising
    without one; ``"cpu"``: gloo).  Idempotent; a no-op under an active
    :class:`process_double`.  Returns the rank's device."""
    if _double is not None:
        return torch.device("cpu")
    device = resolve_device(device)
    coordinator = coordinator or os.environ.get("VELES_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("VELES_NUM_PROCS", 1))
    if process_id is None:
        process_id = int(os.environ.get("VELES_PROC_ID", 0))
    if device.type == "cuda":
        index = process_id % torch.cuda.device_count()
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    kwargs = {"rank": process_id, "world_size": num_processes}
    if timeout is not None:
        import datetime
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if coordinator:
        kwargs["init_method"] = _init_method(coordinator)
    elif num_processes == 1:
        kwargs["store"] = dist.HashStore()
    else:
        raise ValueError("initialize: %d processes need a coordinator "
                         "(VELES_COORDINATOR)" % num_processes)
    if device.type == "cuda":
        kwargs["device_id"] = device
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", **kwargs)
    return device


def shutdown():
    """Leave the process group (a no-op when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def configured():
    """True when a multi-process group is configured or up: an active
    :class:`process_double`, an initialized group, or the bootstrap
    variables."""
    return (_double is not None or dist.is_initialized()
            or "VELES_COORDINATOR" in os.environ
            or "VELES_NUM_PROCS" in os.environ)


def process_index():
    if _double is not None:
        return _double.current
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    if _double is not None:
        return _double.num_processes
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator():
    """True on exactly one process: gate snapshot writes and reports on
    it."""
    return process_index() == 0


def from_host_local(local_batch, sharding, global_shape=None):
    """The GLOBAL batch (a CPU tensor) from this process's rows:
    ``local_batch`` holds this process's contiguous rows, ``sharding`` a
    :class:`~veles_tpu_torch.parallel.mesh.Sharding` whose leading axis
    must split evenly over the processes, ``global_shape`` defaults to
    the local rows times the process count.  Under a
    :class:`process_double` the shards are banked (see it); one process
    is the identity; a live group gathers every process's rows."""
    local_batch = numpy.ascontiguousarray(local_batch)
    n_procs = process_count()
    if global_shape is None:
        global_shape = ((local_batch.shape[0] * n_procs,)
                        + tuple(local_batch.shape[1:]))
    _check_data_axis(sharding, n_procs)
    if _double is not None:
        out, _complete = _double.bank_shard(local_batch, global_shape)
        return torch.from_numpy(out)
    if n_procs == 1:
        return torch.from_numpy(numpy.array(
            numpy.broadcast_to(local_batch, global_shape)))
    parts = [None] * n_procs
    dist.all_gather_object(parts, local_batch)
    out = numpy.concatenate(parts)
    if out.shape != tuple(global_shape):
        raise MultiHostShardError(
            "the processes' rows make %s, not the global shape %s"
            % (out.shape, tuple(global_shape)))
    return torch.from_numpy(out)


def _check_data_axis(sharding, n_procs):
    """The sharding's leading (data) axis must split evenly across the
    processes: each feeds a whole number of shards."""
    if n_procs <= 1:
        return
    spec = getattr(sharding, "spec", None)
    mesh = getattr(sharding, "mesh", None)
    if not spec or mesh is None or spec[0] is None:
        return
    names = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
    ax = mesh.axis_size(*names)
    if ax % n_procs:
        raise MultiHostShardError(
            "sharding's data axis %r has %d shard(s) — not divisible "
            "across %d processes; each host must feed a whole number "
            "of device shards" % (names, ax, n_procs))


def host_shard_range(n_samples, allow_uneven=False):
    """``[start, stop)`` of this process's contiguous shard of
    ``n_samples``.  The samples must divide evenly over the processes,
    unless ``allow_uneven``, which gives the remainder to the last."""
    n_procs = process_count()
    if n_samples % n_procs and not allow_uneven:
        raise MultiHostShardError(
            "global batch of %d rows does not divide evenly over %d "
            "processes; pad/crop to a multiple (uneven host shards "
            "cannot assemble into one global array)" % (n_samples,
                                                        n_procs))
    per = n_samples // n_procs
    idx = process_index()
    start = per * idx
    stop = n_samples if (allow_uneven and idx == n_procs - 1) \
        else start + per
    return start, stop
