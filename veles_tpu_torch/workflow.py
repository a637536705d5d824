"""Workflow: the container unit executing a graph of units.

The port's counterpart of :mod:`veles_tpu.workflow`: the unit container
with ``start_point``/``end_point``, self-registration of units
(``add_ref``), initialization in dependency order with partial-init
requeue, the run loop (an iterative FIFO work queue drained on the
calling thread, deterministic), run-time statistics and result
gathering.

Segment stitching (:mod:`veles_tpu_torch.stitch`): ``initialize()``
ends with ``rebuild_stitching()``, and ``run()`` rebuilds when the
``engine.stitch`` knob was flipped since the last build.  The
epoch-scan runner (:mod:`veles_tpu_torch.epoch_scan`) is built beside
the segments and dropped with them; ``epoch_scan_report()`` describes
it.  ``perf_report()`` renders the performance ledger
(:mod:`veles_tpu_torch.prof`).  ``initialize()`` applies the telemetry
bus's knob (``root.common.watch.endpoint``), and ``run()`` publishes its
begin, its end and the perf digest on the bus when one is live.

A workflow pickles whole (:mod:`veles_tpu_torch.snapshotter`): its
queue, segments, epoch runner and their CUDA graphs are transient, and
``initialize()`` of the loaded workflow rebuilds them (on the card, the
graphs are captured again over the new tensors).
``capture_train_state()`` / ``restore_train_state()`` split the units'
``checkpoint_state()`` into arrays and small values for
:class:`veles_tpu_torch.checkpoint.TrainCheckpointer`, under the JAX
package's keys, so a JAX pair installs unchanged.  Not ported (ROADMAP
item 7): the master/slave job protocol, ``checksum`` and
``package_export``.
"""

import collections
import inspect
import time

import numpy

from veles_tpu_torch import trace
from veles_tpu_torch.plumbing import EndPoint, StartPoint
from veles_tpu_torch.units import MissingDemandedAttributes, Unit


class Workflow(Unit):
    """Container unit holding and executing a unit graph."""

    hide_from_registry = True

    def __init__(self, workflow=None, **kwargs):
        self._units = []
        super(Workflow, self).__init__(workflow, **kwargs)
        self._launcher = None
        if kwargs.get("launcher") is not None:
            self.launcher = kwargs["launcher"]
        self.stopped = False
        self.start_point = StartPoint(self)
        self.end_point = EndPoint(self)

    def init_unpickled(self):
        super(Workflow, self).init_unpickled()
        self._queue_ = collections.deque()
        self._stitch_segments_ = []
        self._epoch_runner_ = None
        self._stitch_active_ = False
        #: was the switch on when the segments were last (re)built?
        self._stitch_built_enabled_ = False

    def __setstate__(self, state):
        super(Workflow, self).__setstate__(state)
        # the units' back-references are transient: link them again
        for unit in self._units:
            unit.workflow = self

    # -- membership ---------------------------------------------------------
    def add_ref(self, unit):
        """Units register themselves on construction."""
        if unit is self:
            raise ValueError("a workflow cannot contain itself")
        if unit not in self._units:
            self._units.append(unit)
        unit.workflow = self

    def __iter__(self):
        return iter(self._units)

    @property
    def launcher(self):
        return self._launcher

    @launcher.setter
    def launcher(self, value):
        old = self._launcher
        if old is not None and old is not value:
            old.del_ref(self)
        self._launcher = value
        if value is not None:
            value.add_ref(self)

    # -- initialization ----------------------------------------------------
    def units_in_dependency_order(self):
        """BFS from ``start_point`` over control edges; units it does not
        reach are appended afterwards in insertion order."""
        seen = []
        seen_set = set()
        frontier = collections.deque([self.start_point])
        while frontier:
            unit = frontier.popleft()
            if id(unit) in seen_set:
                continue
            seen_set.add(id(unit))
            seen.append(unit)
            for dst in unit.links_to:
                if id(dst) not in seen_set:
                    frontier.append(dst)
        unreachable = [u for u in self._units if id(u) not in seen_set]
        flagged = [u.name for u in unreachable if u is not self.end_point]
        if flagged:
            self.warning("%d unit(s) unreachable from start_point, appended "
                         "in insertion order: %s", len(flagged),
                         ", ".join(flagged))
        return seen + unreachable

    def initialize(self, device=None, **kwargs):
        """Initialize every unit in dependency order; a unit whose
        demanded attributes are not yet produced is retried after its
        producers (only :class:`MissingDemandedAttributes` requeues, at
        most once per unit in the queue).  The trace knob, the flight
        recorder's (``root.common.obs.blackbox_dir``) and the telemetry
        bus's (``root.common.watch.endpoint``) are applied here, where a
        run starts, as in the JAX package."""
        from veles_tpu_torch import obs, watch
        trace.configure()
        obs.configure()
        watch.configure()
        self.device = device
        pending = collections.deque(self.units_in_dependency_order())
        retries = {}
        limit = len(pending)
        while pending:
            unit = pending.popleft()
            try:
                if device is not None and _accepts_kwarg(unit.initialize,
                                                         "device"):
                    unit.initialize(device=device, **kwargs)
                else:
                    unit.initialize(**kwargs)
            except MissingDemandedAttributes:
                retries[id(unit)] = retries.get(id(unit), 0) + 1
                if retries[id(unit)] > limit:
                    raise
                pending.append(unit)
        self._is_initialized = True
        self.stopped = False
        self.rebuild_stitching()
        return self

    # -- segment stitching ----------------------------------------------------
    def rebuild_stitching(self):
        """(Re)walk the unit chain into segments
        (:func:`veles_tpu_torch.stitch.build_segments`) and build the
        epoch-scan runner over them, so its window graphs never outlive
        the segments they fold."""
        from veles_tpu_torch import epoch_scan, stitch
        for segment in self._stitch_segments_:
            segment.detach()
        self._stitch_segments_ = stitch.build_segments(self)
        self._stitch_built_enabled_ = stitch.enabled()
        self._epoch_runner_ = epoch_scan.build_runner(self) \
            if self._stitch_segments_ else None
        return self._stitch_segments_

    @property
    def stitch_active(self):
        """True while run() executes with stitched segments live."""
        return self._stitch_active_

    @property
    def stitch_segments(self):
        return list(self._stitch_segments_)

    def stitch_report(self):
        """Each segment's units, dispatches, graph captures,
        recaptures, replays and launches per replay."""
        return [segment.report() for segment in self._stitch_segments_]

    @property
    def epoch_runner(self):
        """The :class:`veles_tpu_torch.epoch_scan.EpochScanRunner`, or
        None when nothing is stitched."""
        return self._epoch_runner_

    def epoch_scan_report(self):
        """The runner's ``describe()`` (eligibility and its reason,
        windows, steps, each window graph's report), or None."""
        runner = self._epoch_runner_
        return runner.describe() if runner is not None else None

    def perf_report(self):
        """Text summary of the performance ledger
        (:mod:`veles_tpu_torch.prof`): per segment, window, serve
        bucket and generative program, the flops and bytes their
        kernels tallied, the dispatches' time (on the device on the
        card), achieved FLOP/s and, on a card of the peak table, MFU
        against each row's own type; the compile and recompile totals
        and the HBM ledger."""
        from veles_tpu_torch import prof
        return prof.report_text()

    # -- execution ----------------------------------------------------------
    def schedule(self, unit, src):
        """Enqueue a gate check of ``unit`` triggered by ``src``."""
        self._queue_.append((unit, src))

    def run(self):
        """Run the graph until the end point fires (or a unit fails)."""
        if not self._is_initialized:
            raise RuntimeError("initialize() the workflow before run()")
        from veles_tpu_torch import stitch
        if stitch.enabled() != self._stitch_built_enabled_:
            self.rebuild_stitching()
        self._stitch_active_ = bool(self._stitch_segments_)
        for segment in self._stitch_segments_:
            # an interrupted run may have left members unconsumed
            segment.reset_pass()
        if self._epoch_runner_ is not None:
            # and the Decision's absorb mark of a window it never saw
            self._epoch_runner_.reset_pass()
        self.stopped = False
        from veles_tpu_torch import watch
        if watch.enabled():
            watch.publish("run", phase="begin",
                          workflow=type(self).__name__)
        tic = time.time()
        self.schedule(self.start_point, None)
        self._drain()
        if watch.enabled():
            watch.publish("run", phase="end", workflow=type(self).__name__,
                          run_time=round(time.time() - tic, 3),
                          results=self.gather_results())
            watch.publish("perf", self._perf_event())

    def _perf_event(self):
        """The compact perf digest a run's end publishes on the bus: the
        ledger's totals, the HBM peak and bytes by category, the
        segments' dispatches and the windows run."""
        from veles_tpu_torch import prof
        from veles_tpu_torch.memory import Watcher
        totals = prof.ledger.summary()["totals"]
        hbm = Watcher.hbm_ledger()
        event = {key: totals.get(key) for key in
                 ("compiles", "recompiles", "flops_dispatched",
                  "achieved_flops", "mfu")}
        event["hbm_peak_bytes"] = hbm.get("peak_bytes", 0)
        event["hbm_bytes"] = {
            cat: info["bytes"] for cat, info in
            hbm.get("by_category", {}).items() if info}
        event["dispatches"] = sum(r["dispatches"]
                                  for r in self.stitch_report())
        scan = self.epoch_scan_report() or {}
        event["scan_windows"] = scan.get("windows", 0)
        event["scan_steps"] = scan.get("steps", 0)
        return event

    def _drain(self):
        """Pop and run until the queue is empty or the workflow stops."""
        queue = self._queue_
        while queue and not self.stopped:
            unit, src = queue.popleft()
            unit._check_gate_and_run(src)
        queue.clear()

    def stop(self):
        """Stop the run and every unit (a snapshotter joins its write
        in flight)."""
        self.stopped = True
        for unit in self._units:
            unit.stop()

    def on_workflow_finished(self):
        self.stopped = True
        if self._launcher is not None:
            self._launcher.on_workflow_finished()

    def on_unit_failed(self, unit):
        self.warning("unit %r failed; stopping workflow", unit)
        self.stopped = True

    # -- the train-state checkpoint ------------------------------------------
    def _checkpoint_key(self, index, unit):
        """A unit's key: its dependency-order index and its name made
        safe (``u%03d_<name>``), as the JAX package keys it."""
        safe = "".join(c if c.isalnum() else "_" for c in unit.name)
        return "u%03d_%s" % (index, safe)

    def capture_train_state(self):
        """``(train, meta)`` for a
        :class:`veles_tpu_torch.checkpoint.TrainCheckpointer`: each unit
        with a ``checkpoint_state()`` gives a dict, whose numpy arrays
        go into ``train`` and everything else into the JSON ``meta``,
        under the unit's key."""
        train, meta = {}, {}
        for i, unit in enumerate(self.units_in_dependency_order()):
            if unit is self:
                continue
            hook = getattr(unit, "checkpoint_state", None)
            if hook is None:
                continue
            try:
                state = hook()
            except Exception:
                self.exception("checkpoint_state failed on %r", unit)
                continue
            if not state:
                continue
            key = self._checkpoint_key(i, unit)
            arrays = {k: v for k, v in state.items()
                      if isinstance(v, numpy.ndarray)}
            small = {k: v for k, v in state.items()
                     if not isinstance(v, numpy.ndarray)}
            if arrays:
                train[key] = arrays
            if small:
                meta[key] = small
        return train, meta

    def restore_train_state(self, train, meta):
        """Install a :meth:`capture_train_state` pair into this built
        and initialized workflow: each unit's
        ``restore_checkpoint_state`` gets its dict back whole.  Returns
        the number of units restored."""
        train = train or {}
        meta = meta or {}
        restored = 0
        for i, unit in enumerate(self.units_in_dependency_order()):
            if unit is self:
                continue
            hook = getattr(unit, "restore_checkpoint_state", None)
            if hook is None:
                continue
            key = self._checkpoint_key(i, unit)
            state = {}
            state.update(meta.get(key) or {})
            state.update(train.get(key) or {})
            if not state:
                continue
            try:
                hook(state)
                restored += 1
            except Exception:
                self.exception("restore_checkpoint_state failed on %r",
                               unit)
        self.info("restored checkpoint state into %d unit(s)", restored)
        return restored

    # -- results / stats ----------------------------------------------------
    def gather_results(self):
        """Merge ``get_metric_values()`` of every unit that has one."""
        results = {}
        for unit in self._units:
            get = getattr(unit, "get_metric_values", None)
            if callable(get):
                results.update(get())
        return results

    def get_unit_run_time_stats(self):
        """(unit, seconds) sorted by descending run time."""
        stats = [(unit, unit.run_time) for unit in self._units]
        stats.sort(key=lambda pair: -pair[1])
        return stats

    def print_stats(self, top=10):
        total = sum(t for _, t in self.get_unit_run_time_stats()) or 1e-12
        self.info("unit run-time stats (top %d):", top)
        for unit, seconds in self.get_unit_run_time_stats()[:top]:
            self.info("  %6.2f%%  %8.3f s  %s",
                      100.0 * seconds / total, seconds, unit.name)


def _accepts_kwarg(fn, name):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    if name in sig.parameters:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values())
