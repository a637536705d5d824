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
package's keys, so a JAX pair installs unchanged.

Background units: a unit with ``wants_thread`` runs on the host thread
pool (:mod:`veles_tpu_torch.thread_pool`) instead of the draining
thread, and its downstream units are scheduled from the worker after its
``run()``, so the control graph's order holds; ``run()`` returns only
once no background unit is in flight.

The master/slave job contract (:mod:`veles_tpu_torch.parallel.jobs`): a
master never runs the graph; it serves ``generate_data_for_slave()``
(each unit's payload, in dependency order) and merges
``apply_data_from_slave()``.  A slave's ``do_job()`` installs a payload
(``apply_data_from_master``), runs the graph once and hands
``generate_data_for_master()`` to the job's callback when the end point
fires.  ``checksum()`` content-addresses the graph and the files of the
modules that define its units (by module name, not path), so a master
and a slave running different code refuse each other at the handshake:
the port's units live in the port's files, so a JAX master and a port
slave never agree.  Not ported: ``package_export`` (ROADMAP item 7(e)).
"""

import collections
import hashlib
import inspect
import os
import threading
import time

import numpy

from veles_tpu_torch import trace
from veles_tpu_torch.plumbing import EndPoint, StartPoint
from veles_tpu_torch.units import MissingDemandedAttributes, Unit


class ChecksumError(Exception):
    """A unit's defining code cannot be content-addressed: the
    master/slave code-mismatch check would be unsound, so ``checksum()``
    fails closed."""


class NoMoreJobs(Exception):
    """The master has no further jobs for slaves."""


class NoJobYet(Exception):
    """The master has nothing to hand out right now, but more jobs may
    appear; the slave should retry shortly instead of quitting."""


class Workflow(Unit):
    """Container unit holding and executing a unit graph."""

    hide_from_registry = True

    #: seconds ``run()`` waits for background units in flight after the
    #: queue drained before it raises (warnings every 60 s until then)
    QUIESCENCE_TIMEOUT = 600.0

    def __init__(self, workflow=None, **kwargs):
        self._units = []
        #: where ``write_results()`` writes ``gather_results()`` (and a
        #: master's or a standalone run's end writes it)
        self.result_file = kwargs.get("result_file")
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
        self._queue_cond_ = threading.Condition(threading.Lock())
        #: background units running on the thread pool
        self._inflight_ = 0
        #: a slave's job callback, called once at the end point
        self._job_callback_ = None
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

    @property
    def is_master(self):
        return getattr(self._launcher, "is_master", False)

    @property
    def is_slave(self):
        return getattr(self._launcher, "is_slave", False)

    @property
    def is_standalone(self):
        return getattr(self._launcher, "is_standalone", True)

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
        # once: the job contract walks the order at every job
        if flagged and not getattr(self, "_warned_unreachable_", False):
            self._warned_unreachable_ = True
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
        with self._queue_cond_:
            self._queue_.append((unit, src))
            self._queue_cond_.notify_all()

    def run(self):
        """Run the graph until the end point fires (or a unit fails).  A
        master never runs the graph: its slaves' jobs drive it."""
        if not self._is_initialized:
            raise RuntimeError("initialize() the workflow before run()")
        if self.is_master:
            return
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
        """Pop and run until the queue is empty and no background unit
        is in flight (or the workflow stops).  A ``wants_thread`` unit
        runs on the thread pool and schedules its downstream units from
        there; units not downstream of it keep draining meanwhile."""
        queue = self._queue_
        cond = self._queue_cond_
        while True:
            with cond:
                while not queue and self._inflight_ and not self.stopped:
                    cond.wait(0.05)
                if self.stopped or (not queue and not self._inflight_):
                    break
                unit, src = queue.popleft()
            if unit.wants_thread:
                self._spawn(unit, src)
            else:
                unit._check_gate_and_run(src)
        # returning means the graph is quiescent: a background unit
        # still running would race a snapshot or the teardown
        with cond:
            start = time.time()
            next_warn = 60.0
            while self._inflight_:
                cond.wait(0.5)
                elapsed = time.time() - start
                if self._inflight_ and elapsed >= self.QUIESCENCE_TIMEOUT:
                    raise RuntimeError(
                        "workflow not quiescent: %d background unit(s) "
                        "still running %.0f s after the drain"
                        % (self._inflight_, elapsed))
                if self._inflight_ and elapsed >= next_warn:
                    self.warning("%d background unit(s) still running "
                                 "%.0f s after the drain", self._inflight_,
                                 elapsed)
                    next_warn += 60.0
            queue.clear()

    def _spawn(self, unit, src):
        from veles_tpu_torch import thread_pool
        with self._queue_cond_:
            self._inflight_ += 1
        thread_pool.submit(self._run_background, unit, src)

    def _run_background(self, unit, src):
        try:
            unit._check_gate_and_run(src)
        except Exception:
            self.exception("background unit %r failed", unit)
        finally:
            with self._queue_cond_:
                self._inflight_ -= 1
                self._queue_cond_.notify_all()

    def stop(self):
        """Stop the run and every unit (a snapshotter joins its write
        in flight)."""
        self.stopped = True
        with self._queue_cond_:
            self._queue_cond_.notify_all()
        for unit in self._units:
            unit.stop()

    def on_workflow_finished(self):
        self.stopped = True
        callback, self._job_callback_ = self._job_callback_, None
        if callback is not None:
            callback(self.generate_data_for_master())
        if getattr(self, "result_file", None) and not self.is_slave:
            self.write_results()
        if self._launcher is not None:
            self._launcher.on_workflow_finished()

    def on_unit_failed(self, unit):
        self.warning("unit %r failed; stopping workflow", unit)
        self.stopped = True

    # -- the master/slave job contract ----------------------------------------
    def _job_units(self):
        return [u for u in self.units_in_dependency_order() if u is not self]

    def generate_data_for_slave(self, slave=None):
        """Master: each unit's job payload, in dependency order (None for
        a unit with nothing to send)."""
        return [unit.generate_data_for_slave(slave)
                for unit in self._job_units()]

    def apply_data_from_master(self, data):
        """Slave: install a job's payloads into the units."""
        units = self._job_units()
        if len(data) != len(units):
            raise ValueError(
                "job payload has %d entries for %d units: master/slave "
                "workflow checksum mismatch?" % (len(data), len(units)))
        for unit, payload in zip(units, data):
            if payload is not None:
                unit.apply_data_from_master(payload)

    def prefetch_job(self, data):
        """Slave lookahead: offer the next job's payloads to the units
        with a ``prefetch_job_data`` (the loader starts its minibatch
        I/O) while the current job computes.  The serving state is left
        alone: ``apply_data_from_master`` installs the job when it
        runs."""
        units = self._job_units()
        if len(data) != len(units):
            return
        for unit, payload in zip(units, data):
            hook = getattr(unit, "prefetch_job_data", None)
            if hook is not None and payload is not None:
                try:
                    hook(payload)
                except Exception:
                    self.exception("prefetch_job_data failed on %r", unit)

    def generate_data_for_master(self):
        """Slave: each unit's update for the master, in dependency
        order."""
        return [unit.generate_data_for_master()
                for unit in self._job_units()]

    def apply_data_from_slave(self, data, slave=None):
        """Master: merge a slave's update into the units."""
        units = self._job_units()
        if len(data) != len(units):
            raise ValueError(
                "update payload has %d entries for %d units: master/slave "
                "workflow checksum mismatch?" % (len(data), len(units)))
        for unit, payload in zip(units, data):
            if payload is not None:
                unit.apply_data_from_slave(payload, slave)

    def drop_slave(self, slave=None):
        """Master: a slave is gone; every unit requeues its work."""
        for unit in self._units:
            unit.drop_slave(slave)

    def do_job(self, data, callback):
        """Slave: install a job, run the graph once, and hand the update
        to ``callback`` when the end point fires."""
        self.apply_data_from_master(data)
        self._job_callback_ = callback
        self.run()

    def checksum(self):
        """Content-address the workflow: the graph (class and unit names
        in dependency order) and the bytes of every module file that
        defines a unit class, keyed by module name (a master and a slave
        may hold the same code at different paths).  A unit whose code
        cannot be located raises :class:`ChecksumError`."""
        sha = hashlib.sha256()
        files = {}
        for unit in self.units_in_dependency_order():
            sha.update(type(unit).__name__.encode())
            sha.update(unit.name.encode())
            mod = inspect.getmodule(type(unit))
            fname = getattr(mod, "__file__", None)
            if fname and os.path.isfile(fname):
                files[mod.__name__] = fname
                continue
            try:
                sha.update(inspect.getsource(type(unit)).encode())
            except (OSError, TypeError):
                raise ChecksumError(
                    "cannot content-address %r (class %s: no module file "
                    "and no retrievable source): the master/slave "
                    "checksum would be unsound" % (unit,
                                                   type(unit).__name__))
        for modname in sorted(files):
            sha.update(modname.encode())
            with open(files[modname], "rb") as fin:
                sha.update(fin.read())
        return sha.hexdigest()

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

    def write_results(self, path=None):
        """``gather_results()`` as JSON at ``path`` (default
        ``result_file``)."""
        import json
        path = path or self.result_file
        if not path:
            return

        def _default(obj):
            try:
                return float(obj)
            except (TypeError, ValueError):
                return repr(obj)
        with open(path, "w") as fout:
            json.dump(self.gather_results(), fout, indent=2,
                      default=_default)

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
