"""Training-health statistics inside the stitched segments and windows.

The port's counterpart of :mod:`veles_tpu.watch.health`.  With
``root.common.engine.health`` ``on`` or ``strict``,
:func:`instrument_stages` wraps every stitched stage that donates float
parameters (each GD unit is one param group) so that, after its update,
it also computes

* a non-finite element count per donated leaf (``w``, ``vw``, ``b``,
  ``vb``) and their total;
* ``grad_norm`` (declared by the stage: the GD family recovers the
  effective gradient from the momentum recurrence), ``weight_norm``,
  ``update_norm`` and ``update_ratio`` = ‖update‖ / ‖weights‖.

They are plain torch reductions in the stage function, so on the card
they are captured into the segment's (and the epoch-scan window's) CUDA
graph as a few more kernels: every step on the per-step route, the last
step of a window (whose statistics a window reports, as the JAX
package's scan does); no extra dispatch, no host sync.  They are
published through the stage's ``metrics``, the same protocol the
Decision's device metrics ride, and land on the unit as device scalars
after each dispatch.

``off`` (the default) instruments nothing: every graph stays as it is,
node for node.  ``strict`` also fetches the per-leaf counts at each
window boundary (every epoch-scan window; every ``metrics_every``, or
:data:`STRICT_CHECK_EVERY`, steps on the per-step route; every class
close) and raises :class:`HealthError` naming the first non-finite
leaf, ``<unit>.<slot>`` in stage then slot order.  NaNs persist through
the momentum updates, so the latest values suffice.

The process-wide :data:`monitor` holds the groups and serves
:meth:`HealthMonitor.snapshot` to the telemetry bus, the flight
recorder and the scrape endpoint.
"""

import numpy
import torch

from veles_tpu_torch.config import root
from veles_tpu_torch.logger import Logger

#: strict-mode check cadence on the per-step route when
#: ``root.common.engine.metrics_every`` is unset
STRICT_CHECK_EVERY = 32

#: the stat names a stage's ``health`` callable may return
#: (``update_ratio`` is derived here, never declared)
DECLARED_STATS = ("grad_norm", "weight_norm", "update_norm")


def health_mode():
    """The ``root.common.engine.health`` knob: ``off`` | ``on`` |
    ``strict``, read when segments are built."""
    value = root.common.engine.get("health", "off")
    if value is None:
        return "off"
    value = str(value).strip().lower()
    if value in ("off", "0", "false", "no", ""):
        return "off"
    if value in ("on", "1", "true", "yes"):
        return "on"
    if value == "strict":
        return "strict"
    raise ValueError(
        "root.common.engine.health must be off|on|strict, got %r" % value)


class HealthError(RuntimeError):
    """Strict mode's verdict: a parameter leaf went non-finite.  ``leaf``
    names the first bad leaf (``<unit>.<slot>``), ``count`` its
    non-finite elements, ``step`` the observed train step at the
    failing boundary."""

    def __init__(self, leaf, count, step):
        self.leaf = leaf
        self.count = int(count)
        self.step = int(step)
        super(HealthError, self).__init__(
            "non-finite parameter leaf %r (%d element(s)) at train step "
            "%d - the first bad param group; inspect "
            "watch.health.monitor.snapshot() / lower the learning rate "
            "(root.common.engine.health=strict)"
            % (leaf, self.count, self.step))


class HealthGroup(object):
    """One instrumented param group (one donating stage): its unit and
    the metric attributes its stats land in."""

    __slots__ = ("unit", "name", "stats", "leaves")

    def __init__(self, unit, stats, leaves):
        self.unit = unit
        self.name = unit.name
        #: aggregate stats: {stat_name: metric_attr}
        self.stats = dict(stats)
        #: per-leaf non-finite counts: [(leaf_label, metric_attr)]
        self.leaves = list(leaves)


def _float_leaves(stage):
    """The donated slots health instruments: float Vectors (parameters
    and momenta), sorted by slot name; integer donations (a confusion
    matrix) are no param group."""
    out = []
    for name in sorted(stage.donated):
        vec = stage.donated[name]
        dtype = getattr(vec, "dtype", None)
        if dtype is not None and numpy.dtype(dtype).kind == "f":
            out.append(name)
    return out


def _sq(t):
    return torch.sum(torch.square(t.float()))


def _wrap_stage_fn(fn, declared, leaves):
    """The instrumented stage body: run ``fn``, then fold the stats over
    its donated outputs.  The stage updates its leaves in place, so the
    values the stats need from before the update (the declared
    callable's ``reads_before``; every leaf for the generic norms) are
    copied first, into buffers the graph owns."""
    before_names = getattr(declared, "reads_before", None) \
        if declared is not None else leaves

    numels = {}

    def instrumented(t):
        before = {name: t[name].clone() for name in before_names
                  if name in t}
        out = fn(t)
        # each leaf's finite elements (two kernels), then its size less
        # them in one; the sizes are a device vector made at the first
        # call, which runs eagerly before any capture
        finite = torch.stack([torch.isfinite(out[leaf]).sum(
            dtype=torch.int32) for leaf in leaves])
        device = finite.device
        if device not in numels:
            numels[device] = torch.tensor(
                [out[leaf].numel() for leaf in leaves], dtype=torch.int32,
                device=device)
        counts = numels[device] - finite
        stats = {"health_nf_" + leaf: counts[i]
                 for i, leaf in enumerate(leaves)}
        stats["health_nonfinite"] = counts.sum(dtype=torch.int32)
        if declared is not None:
            extra = declared(dict(t, **before), out)
        else:
            wsq = sum(_sq(out[leaf]) for leaf in leaves)
            usq = sum(_sq(out[leaf] - before[leaf]) for leaf in leaves)
            extra = {"weight_norm": torch.sqrt(wsq),
                     "update_norm": torch.sqrt(usq)}
        for key in DECLARED_STATS:
            if key in extra:
                stats["health_" + key] = extra[key].float()
        if "health_update_norm" in stats \
                and "health_weight_norm" in stats:
            stats["health_update_ratio"] = \
                stats["health_update_norm"] \
                / (stats["health_weight_norm"] + 1e-12)
        out = dict(out)
        out.update(stats)
        return out
    #: the stage without its statistics (run_stages(health=False))
    instrumented.plain = fn
    return instrumented


def instrument_stages(stages):
    """Fold the health stats into every donating stage of one stitched
    chain (called by :func:`veles_tpu_torch.stitch.build_segments`
    before the segment is built, so its plan and its windows' plans
    carry the stats).  Returns the :class:`HealthGroup` list; each
    instrumented stage has its ``fn`` wrapped, ``metrics`` extended and
    ``health_spec`` set."""
    groups = []
    for stage in stages:
        if stage.health_spec is not None:
            groups.append(stage.health_spec)
            continue
        leaves = _float_leaves(stage)
        if not leaves:
            continue
        declared = stage.health
        stage.fn = _wrap_stage_fn(stage.fn, declared, leaves)
        names = ["health_nf_" + leaf for leaf in leaves]
        names.append("health_nonfinite")
        stat_names = list(DECLARED_STATS) if declared is not None \
            else ["weight_norm", "update_norm"]
        names.extend("health_" + s for s in stat_names)
        names.append("health_update_ratio")
        stage.metrics = tuple(stage.metrics) + tuple(names)
        group = HealthGroup(
            stage.unit,
            stats=dict([(s, "health_" + s) for s in stat_names]
                       + [("update_ratio", "health_update_ratio"),
                          ("nonfinite", "health_nonfinite")]),
            leaves=[(leaf, "health_nf_" + leaf) for leaf in leaves])
        stage.health_spec = group
        groups.append(group)
    return groups


def _fetch(values):
    """Host numbers of device scalars (or numbers) in ONE copy."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    if not tensors:
        return [float(v) for v in values]
    host = iter(torch.stack([t.detach().reshape(()).double()
                             for t in tensors]).cpu().tolist())
    return [next(host) if isinstance(v, torch.Tensor) else float(v)
            for v in values]


class HealthMonitor(Logger):
    """The process-wide collector: the armed groups, the strict cadence
    and the host snapshot the bus, the flight recorder and the scrape
    endpoint read.  (Re)armed by ``build_segments`` through
    :meth:`install`."""

    def __init__(self, **kwargs):
        super(HealthMonitor, self).__init__(**kwargs)
        self.reset()

    def reset(self):
        self.groups = []
        self.mode = "off"
        #: observed train steps (instrumented dispatches × their K)
        self.steps = 0
        #: strict-mode fetches made
        self.checks = 0
        self._since_check = 0
        #: the last host snapshot (what the flight recorder embeds)
        self.last_snapshot = None

    @property
    def armed(self):
        return bool(self.groups) and self.mode != "off"

    def install(self, groups, mode):
        """Arm for one freshly stitched workflow; a rebuild is a new
        run, so the counters start again."""
        self.reset()
        self.groups = list(groups)
        self.mode = mode

    def describe(self):
        return {"mode": self.mode,
                "groups": [g.name for g in self.groups],
                "steps": self.steps, "checks": self.checks}

    def _check_every(self):
        every = int(root.common.engine.get("metrics_every", 0) or 0)
        return every if every > 0 else STRICT_CHECK_EVERY

    def observe(self, steps=1, window=False):
        """One instrumented dispatch landed ``steps`` train steps' stats
        (K for a window).  Free unless strict mode is due for a check
        (every window; every ``_check_every()`` steps otherwise)."""
        self.steps += int(steps)
        self._since_check += int(steps)
        if self.mode != "strict":
            return
        if window or self._since_check >= self._check_every():
            self.check()

    def check(self):
        """The strict boundary: ONE fetch of every group's per-leaf
        counts; raises :class:`HealthError` naming the first bad
        leaf."""
        from veles_tpu_torch import trace
        self._since_check = 0
        self.checks += 1
        trace.instant("watch", "health_check", {"step": self.steps})
        slots = [(group, leaf, attr) for group in self.groups
                 for leaf, attr in group.leaves]
        values = _fetch([getattr(group.unit, attr, 0)
                         for group, _leaf, attr in slots])
        for (group, leaf, _attr), value in zip(slots, values):
            if int(value) > 0:
                raise HealthError("%s.%s" % (group.name, leaf),
                                  int(value), self.steps)

    def maybe_snapshot(self):
        """:meth:`snapshot` when armed, else None (two attribute
        checks with ``health=off``)."""
        if not self.armed:
            return None
        return self.snapshot()

    def snapshot(self):
        """Every group's stats in ONE fetch, returned (and cached) as a
        JSON-able dict.  Strict mode applies its verdict here too, so a
        class close never passes over a bad leaf."""
        from veles_tpu_torch import trace
        trace.instant("watch", "health_snapshot", {"step": self.steps})
        slots = []
        for group in self.groups:
            for stat, attr in sorted(group.stats.items()):
                slots.append((group, "stat", stat, attr))
            for leaf, attr in group.leaves:
                slots.append((group, "leaf", leaf, attr))
        values = _fetch([getattr(group.unit, attr, 0)
                         for group, _kind, _name, attr in slots])
        groups, first_bad = {}, None
        for (group, kind, name, _attr), value in zip(slots, values):
            entry = groups.setdefault(group.name, {"leaves": {}})
            if kind == "stat":
                entry[name] = int(value) if name == "nonfinite" \
                    else float(value)
            else:
                count = int(value)
                entry["leaves"][name] = count
                if count > 0 and first_bad is None:
                    first_bad = ("%s.%s" % (group.name, name), count)
        snap = {"mode": self.mode, "step": self.steps, "groups": groups}
        self.last_snapshot = snap
        if self.mode == "strict" and first_bad is not None:
            raise HealthError(first_bad[0], first_bad[1], self.steps)
        return snap


#: the process-wide monitor every instrumented dispatch reports to
monitor = HealthMonitor()
