"""veles_tpu_torch.watch: training-health telemetry and the live bus.

The port's counterpart of :mod:`veles_tpu.watch`:

1. **Health statistics in the graphs**
   (:mod:`~veles_tpu_torch.watch.health`):
   ``root.common.engine.health = off|on|strict`` folds per-param-group
   grad, weight and update norms, the update ratio and per-leaf
   non-finite counts into the stitched segments' and the epoch-scan
   windows' CUDA graphs, riding the Decision's metrics fetch: no extra
   dispatch, ``off`` leaves every graph as it is, and ``strict`` raises
   :class:`~veles_tpu_torch.watch.health.HealthError` naming the first
   non-finite leaf at the window boundary.
2. **A live telemetry bus** (:mod:`~veles_tpu_torch.watch.bus`): a
   drop-tolerant ZMQ PUB socket onto which the workflow's run begin and
   end, the Decision's class closes (``epoch``, ``health``), the perf
   digest and the generative scheduler's ``serve`` snapshots are
   published; ``python -m veles_tpu_torch.watch <endpoint>`` renders a
   live terminal dashboard, ``--record``/``--replay`` persist a
   session.

pyzmq is imported only when a bus or reader is made: this package, the
health statistics and the ledger import and run without it, and
:func:`start` then raises an ``ImportError``.  With no bus configured
:func:`publish` is one attribute check.  The JAX package's bench
watchdog (``scripts/bench_diff.py``, over its banked records) is not
ported: it waits for the port's own benchmark.
"""

from veles_tpu_torch.watch import bus as _bus_mod, health  # noqa: F401
from veles_tpu_torch.watch.bus import (  # noqa: F401
    TelemetryBus, TelemetryReader, load_events, record_events)
from veles_tpu_torch.watch.health import (  # noqa: F401
    HealthError, HealthMonitor, health_mode, monitor)
from veles_tpu_torch.config import root

#: the process-wide bus (None = disabled; publish() is then a no-op)
_bus = None


def enabled():
    """True when a telemetry bus is live in this process."""
    return _bus is not None


def bus():
    """The live :class:`TelemetryBus`, or ``None``."""
    return _bus


def start(endpoint=None, **kwargs):
    """Start (or return) the process bus.  ``endpoint`` default: the
    ``root.common.watch.endpoint`` knob, else a random local port."""
    global _bus
    if _bus is not None:
        return _bus
    node = root.common.get("watch")
    if endpoint is None:
        endpoint = (node.get("endpoint") if node else None) \
            or "tcp://127.0.0.1:0"
    if node is not None:
        kwargs.setdefault("hwm", int(node.get("hwm", 64) or 64))
        kwargs.setdefault("history",
                          int(node.get("history", 256) or 256))
        kwargs.setdefault("conflate",
                          bool(node.get("conflate", False)))
    _bus = TelemetryBus(endpoint, **kwargs)
    return _bus


def shutdown():
    """Close and forget the process bus (test hygiene)."""
    global _bus
    if _bus is not None:
        _bus.close()
        _bus = None


def configure():
    """Apply the ``root.common.watch.endpoint`` knob (called from
    ``Workflow.initialize`` at the same boundary trace/obs re-read
    theirs): a non-empty endpoint starts the bus once per process;
    empty/unset leaves publishing a no-op."""
    node = root.common.get("watch")
    endpoint = node.get("endpoint") if node else None
    if endpoint and _bus is None:
        start(str(endpoint))
    return _bus


def publish(kind, payload=None, **kwargs):
    """Publish one event onto the process bus; a single attribute
    check when no bus is configured.  Keyword args merge into (and
    override) ``payload``."""
    live = _bus
    if live is None:
        return None
    data = dict(payload or {})
    data.update(kwargs)
    return live.publish(kind, data)


def latest(kind=None):
    """Newest event per kind (host-side conflation), or one kind's —
    copied under the bus lock."""
    live = _bus
    if live is None:
        return None if kind else {}
    return live.latest_events(kind)


def recent_events(limit=64):
    """The newest ``limit`` published events (the blackbox tail),
    copied under the bus lock; ``[]`` with no bus."""
    live = _bus
    if live is None:
        return []
    return live.recent(limit)


def metrics_text():
    """Prometheus exposition for the per-role scrape endpoints
    (:func:`veles_tpu_torch.obs.scrape.default_sources`): the latest cached
    health snapshot as ``veles_health_*`` gauges plus the bus's
    publish/drop counters.  Empty string when neither the health knob
    nor the bus is armed (the source contributes nothing to a scrape
    then — families stay contiguous by construction)."""
    lines = []
    snap = monitor.last_snapshot
    if snap:
        lines.append("# HELP veles_health_stat latest in-program "
                     "training-health stats by param group")
        lines.append("# TYPE veles_health_stat gauge")
        for group in sorted(snap.get("groups", {})):
            entry = snap["groups"][group]
            for stat in sorted(entry):
                if stat == "leaves":
                    continue
                lines.append(
                    'veles_health_stat{group="%s",stat="%s"} %g'
                    % (group, stat, entry[stat]))
        lines.append("# HELP veles_health_nonfinite non-finite "
                     "elements per donated param leaf (latest)")
        lines.append("# TYPE veles_health_nonfinite gauge")
        for group in sorted(snap.get("groups", {})):
            for leaf in sorted(snap["groups"][group]["leaves"]):
                lines.append(
                    'veles_health_nonfinite{group="%s",leaf="%s"} %d'
                    % (group, leaf,
                       snap["groups"][group]["leaves"][leaf]))
        lines.append("# TYPE veles_health_step gauge")
        lines.append("veles_health_step %d" % snap.get("step", 0))
    live = _bus
    if live is not None:
        info = live.describe()
        lines.append("# TYPE veles_watch_published_total counter")
        lines.append("veles_watch_published_total %d"
                     % info["published"])
        lines.append("# TYPE veles_watch_dropped_total counter")
        lines.append("veles_watch_dropped_total %d" % info["dropped"])
    return "\n".join(lines) + "\n" if lines else ""


def last_health():
    """The latest host-side health snapshot (cached by
    ``HealthMonitor.snapshot`` whenever the health knob is armed, bus
    or no bus), or ``None``."""
    return monitor.last_snapshot
