"""Pod-of-pods: one pod over the ranks of several hosts.

The port's counterpart of :mod:`veles_tpu.pod.pods`' mesh half.
:class:`MultiHostPod` composes :class:`~veles_tpu_torch.pod.runtime
.PodRuntime` with :mod:`veles_tpu_torch.parallel.multihost`:
:func:`multihost.initialize` joins the processes into one default group,
and the mesh built after it spans every host's ranks.  Each rank reads
only its :meth:`~MultiHostPod.host_range` of a dataset and
:meth:`~MultiHostPod.assemble` makes the global batch from the hosts'
rows.  A single process with no coordinator is a transparent delegate:
the same runtime, the same programs, the same bytes.

Each rank :meth:`~MultiHostPod.beat`s at every epoch boundary, and
:meth:`~MultiHostPod.poll` (every rank at the same point) gathers the
processes' beats since the last poll to the coordinator, whose
:class:`~veles_tpu_torch.pod.membership.DeviceLossDetector` turns a
host silent past the timeout into a verdict that every rank receives
and reshards on.  The beats ride the poll's own collective: the JAX
package sends them over the job protocol (ROADMAP item 7(e)), whose
channel also reaches a process that no longer polls; here a process
that stops calling :meth:`~MultiHostPod.poll` stalls the collective
instead.

:class:`MultiHostPodWorker` (the coordinator's lease session over the
job protocol, the followers' frameless epochs) is ROADMAP item 7(e).
"""

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.parallel import multihost
from veles_tpu_torch.parallel.mesh import (Sharding, distributed,
                                           mesh_from_topology)
from veles_tpu_torch.pod.membership import DeviceLossDetector
from veles_tpu_torch.pod.runtime import PodRuntime


class MultiHostPod(Logger):
    """One pod over every host's ranks.

    ``coordinator`` / ``num_processes`` / ``process_id`` (and
    ``device``) forward to :func:`multihost.initialize` (all None and
    one process: no group is made, the transparent single-host path; a
    process already in a group keeps it).
    ``mesh`` overrides the knob/``topology`` mesh, which is built after
    initialize, so it lays out the global ranks.  ``heartbeat_timeout``:
    seconds of host silence before its ranks are declared lost."""

    def __init__(self, workflow, mesh=None, topology=None,
                 param_rules=None, data_axis="data", coordinator=None,
                 num_processes=None, process_id=None,
                 heartbeat_timeout=30.0, device=None, **kwargs):
        super(MultiHostPod, self).__init__(**kwargs)
        if not distributed() and (
                coordinator or num_processes or process_id is not None
                or multihost.configured()):
            multihost.initialize(coordinator=coordinator,
                                 num_processes=num_processes,
                                 process_id=process_id, device=device)
        self.workflow = workflow
        if mesh is None:
            mesh = mesh_from_topology(topology, require=(data_axis,))
        #: the delegate: a single-process MultiHostPod IS this runtime
        self.runtime = PodRuntime(workflow, mesh=mesh,
                                  param_rules=param_rules,
                                  data_axis=data_axis)
        devices_per_host = max(1, mesh.size // self.process_count)
        self.detector = DeviceLossDetector(
            self.runtime, timeout=heartbeat_timeout,
            devices_per_host=devices_per_host)
        #: this process's beat since the last poll: None, or ``(now,)``
        self._pending = None

    # -- process topology ----------------------------------------------------
    @property
    def process_index(self):
        return multihost.process_index()

    @property
    def process_count(self):
        return multihost.process_count()

    @property
    def is_coordinator(self):
        return multihost.is_coordinator()

    # -- runtime delegation --------------------------------------------------
    def install(self):
        if not self.runtime.installed:
            self.runtime.install()
        return self

    def uninstall(self):
        self.runtime.uninstall()
        return self

    def describe(self):
        out = self.runtime.describe()
        out["processes"] = self.process_count
        out["process_index"] = self.process_index
        out["coordinator"] = self.is_coordinator
        return out

    # -- the host/device data boundary --------------------------------------
    def host_range(self, n_samples, allow_uneven=False):
        """``[start, stop)`` of THIS host's rows of an ``n_samples``-row
        dataset (:func:`multihost.host_shard_range`)."""
        return multihost.host_shard_range(n_samples,
                                          allow_uneven=allow_uneven)

    def assemble(self, local_batch, global_shape=None):
        """This host's rows -> the global batch, batch-sharded over the
        pod's data axis (:func:`multihost.from_host_local`; the identity
        on one process)."""
        ndim = getattr(local_batch, "ndim", 1)
        sharding = Sharding(self.runtime.mesh,
                            (self.runtime.data_axis,) + (None,) * (ndim - 1))
        return multihost.from_host_local(local_batch, sharding,
                                         global_shape=global_shape)

    # -- liveness ------------------------------------------------------------
    def beat(self, host=None, now=None):
        """Record a liveness beat.  With no ``host`` it is this
        process's, and reaches the coordinator's detector at the next
        :meth:`poll` (stamped ``now``, else the poll's time); an
        explicit ``host`` beats this process's detector alone."""
        if host is None:
            self._pending = (now,)
        else:
            self.detector.beat(host, now=now)

    def poll(self, now=None):
        """Every rank calls this at the same point: the processes'
        beats since the last poll are gathered to the coordinator, which
        declares the silent hosts lost (a ``jobs:heartbeat_stall``
        instant each), its verdict is broadcast to the other ranks, and
        every rank reshards once for all of them (a reshard is
        collective).  Returns the lost hosts."""
        many = self.process_count > 1 and distributed()
        mine, self._pending = self._pending, None
        beats = {self.process_index: mine}
        if many:
            import torch.distributed as dist
            gathered = [None] * self.process_count
            dist.all_gather_object(gathered, mine)
            beats = dict(enumerate(gathered))
        if self.is_coordinator:
            for host, stamp in sorted(beats.items()):
                if stamp is not None:
                    self.detector.beat(host, now=stamp[0]
                                       if stamp[0] is not None else now)
        lost = self.detector.lost_hosts(now) if self.is_coordinator \
            else []
        if many:
            verdict = [lost]
            dist.broadcast_object_list(verdict, src=0)
            lost = verdict[0]
        if lost:
            self.runtime.reshard(
                lost=self.detector.devices_per_host * len(lost))
        return lost


class MultiHostPodWorker(object):
    """The multi-host lease worker over the job protocol: ROADMAP item
    7(e)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MultiHostPodWorker (the coordinator's lease session over the "
            "master/slave job protocol, parallel/jobs.py) is not ported "
            "yet (ROADMAP item 7(e))")
