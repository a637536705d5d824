"""Pod membership, its in-process half.

The port's counterpart of the first part of
:mod:`veles_tpu.pod.membership`: the helpers a pod worker and the
parity references share (:func:`capture_params`, :func:`install_params`,
:func:`eval_metrics`, :func:`train_epochs`) and the device-loss
detection that feeds :meth:`veles_tpu_torch.pod.runtime.PodRuntime
.reshard` (:func:`is_device_loss`, :class:`DeviceLossDetector`).

The control plane over the master/slave job protocol (:class:`PodMaster`,
which grants pod leases, and :class:`PodWorker`, which syncs once an
epoch and ships one final update) is built on ``parallel/jobs.py``,
ROADMAP item 7(e): both raise ``NotImplementedError`` naming it.
"""

import time

import numpy

from veles_tpu_torch import trace
from veles_tpu_torch.logger import Logger


def capture_params(workflow):
    """Host copies of the trained forward parameters, one dict per
    forward unit (the final-update payload)."""
    out = []
    for unit in workflow.forwards:
        entry = {}
        if getattr(unit, "weights", None) and unit.weights:
            unit.weights.map_read()
            entry["weights"] = numpy.array(unit.weights.mem)
        if getattr(unit, "bias", None) and unit.bias:
            unit.bias.map_read()
            entry["bias"] = numpy.array(unit.bias.mem)
        out.append(entry)
    return out


def install_params(workflow, payload):
    """Install a :func:`capture_params` payload into a workflow's
    forward units (whole-buffer resets)."""
    for unit, entry in zip(workflow.forwards, payload):
        if "weights" in entry:
            unit.weights.reset(entry["weights"])
        if "bias" in entry and getattr(unit, "bias", None) is not None:
            unit.bias.reset(entry["bias"])


def eval_metrics(workflow):
    """The Decision's eval summary (JSON-able): the parity gates'
    comparison record."""
    decision = workflow.decision
    out = {"epochs": int(workflow.loader.epoch_number),
           "complete": bool(decision.complete)}
    for attr in ("best_n_err_pt", "best_epoch", "best_mse",
                 "min_validation_n_err"):
        value = getattr(decision, attr, None)
        if value is not None:
            out[attr] = float(value)
    return out


def train_epochs(workflow, epochs, already=0):
    """Drive a standalone workflow epoch by epoch (a generator yielding
    the completed epoch number after each): the one stepper the pod and
    the parity references use, so "epoch boundary" means the same on
    every side of a comparison.  ``already`` skips epochs run before.
    It ends early on a rank that a reshard left outside the pod."""
    decision = workflow.decision
    for epoch in range(int(already), int(epochs)):
        pod = getattr(workflow, "pod_runtime_", None)
        if pod is not None and pod.left:
            return
        if int(workflow.loader.epoch_number) >= epoch + 1:
            yield epoch + 1
            continue
        decision.complete <<= False
        decision.max_epochs = epoch + 1
        workflow.run()
        if pod is not None and pod.left:
            return
        yield epoch + 1


#: message fragments of the runtime errors that mean a participating
#: device or peer is gone (as against a program error, which must
#: propagate): the spellings of NCCL / gloo peer loss and the explicit
#: device-loss wordings
DEVICE_LOSS_MARKERS = ("unavailable", "device lost", "data loss",
                       "deadline exceeded", "failed to connect",
                       "connection reset", "socket closed",
                       "halted", "slice health", "connection closed by peer",
                       "nccl communicator was aborted")


def is_device_loss(exc):
    """True when ``exc`` (from a sharded dispatch) is a runtime error
    whose message names a lost device or peer (a
    :data:`DEVICE_LOSS_MARKERS` fragment); False for anything that looks
    like a program error, which must propagate rather than trigger a
    reshard that would hide it."""
    if not isinstance(exc, Exception):
        return False
    name = type(exc).__name__
    if not (isinstance(exc, RuntimeError) or "DistBackendError" in name
            or "DistNetworkError" in name):
        return False
    text = ("%s: %s" % (name, exc)).lower()
    return any(marker in text for marker in DEVICE_LOSS_MARKERS)


class DeviceLossDetector(Logger):
    """Device-loss detection feeding :meth:`PodRuntime.reshard`, from
    two signals:

    * heartbeats: hosts :meth:`beat` the detector (each rank at every
      epoch boundary); :meth:`poll` declares a host silent for
      ``timeout`` seconds lost, writes the ``jobs:heartbeat_stall``
      trace instant and reshards once for all of them, dropping
      ``devices_per_host`` ranks each;
    * dispatch failures: :meth:`dispatch_failure` classifies an
      exception through :func:`is_device_loss`: a device loss reshards
      and returns True (retry the step), anything else returns False
      (re-raise).

    Every rank of the pod must reach the same verdict at the same point
    (a reshard is collective): give every rank the same beats and the
    same ``clock``.  ``clock`` is injectable (default
    ``time.monotonic``)."""

    def __init__(self, runtime, timeout=5.0, devices_per_host=1,
                 clock=None, **kwargs):
        super(DeviceLossDetector, self).__init__(**kwargs)
        self.runtime = runtime
        self.timeout = float(timeout)
        self.devices_per_host = max(1, int(devices_per_host))
        self._clock = clock if clock is not None else time.monotonic
        self._beats = {}
        self.stalls = 0
        self.dispatch_losses = 0

    def beat(self, host, now=None):
        """Record a liveness beat from ``host`` (any hashable id)."""
        self._beats[host] = self._clock() if now is None else now

    def hosts(self):
        return sorted(self._beats)

    def poll(self, now=None):
        """Declare hosts silent for more than ``timeout`` lost and
        reshard once for all of them; the lost hosts, sorted."""
        lost = self.lost_hosts(now)
        if lost:
            self.runtime.reshard(lost=self.devices_per_host * len(lost))
        return lost

    def lost_hosts(self, now=None):
        """:meth:`poll`'s verdict without the reshard: the hosts silent
        for more than ``timeout``, dropped from the table, each with its
        ``jobs:heartbeat_stall`` instant."""
        now = self._clock() if now is None else now
        lost = sorted(host for host, beat in self._beats.items()
                      if now - beat > self.timeout)
        for host in lost:
            gap = now - self._beats.pop(host)
            self.stalls += 1
            trace.instant("jobs", "heartbeat_stall",
                          {"slave": host, "gap_ms": round(gap * 1e3, 1)},
                          role="pod")
            self.warning("pod host %r silent for %.1fs (timeout %.1fs): "
                         "declaring its %d rank(s) lost", host, gap,
                         self.timeout, self.devices_per_host)
        return lost

    def dispatch_failure(self, exc):
        """True: ``exc`` was a device loss and the pod resharded (retry
        the dispatch); False: not ours, re-raise."""
        if not is_device_loss(exc):
            return False
        self.dispatch_losses += 1
        self.warning("sharded dispatch failed with a device-loss error "
                     "(%s): resharding", exc)
        self.runtime.reshard(lost=self.devices_per_host)
        return True


def _job_protocol(name):
    raise NotImplementedError(
        "%s (pod leases over the master/slave job protocol, "
        "parallel/jobs.py) is not ported yet (ROADMAP item 7(e))" % name)


class PodMaster(object):
    """The master side of pod leases: ROADMAP item 7(e)."""

    def __init__(self, *args, **kwargs):
        _job_protocol("PodMaster")


class PodWorker(object):
    """The worker side of pod leases: ROADMAP item 7(e)."""

    def __init__(self, *args, **kwargs):
        _job_protocol("PodWorker")
