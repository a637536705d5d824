"""Segment stitching: each maximal chain of stitchable units runs as one
segment, which is one CUDA graph on the card.

The port's counterpart of :mod:`veles_tpu.stitch`.  At
``Workflow.initialize()`` the control graph is walked and every maximal
linear run of units that return a :class:`StitchStage` from
``stitch_stage()`` becomes a :class:`StitchSegment`.  Host units (the
Decision, the Repeater) stay barriers, and the gate protocol is
untouched: a member still opens its gate and propagates control, its
``run()`` becomes a no-op because the segment's head computed it.  For
the MNIST MLP that gives ``[loader head, All2AllTanh, All2AllSoftmax,
EvaluatorSoftmax]`` and ``[GDSoftmax, GDTanh]``.

A stage declares by Vector identity what it consumes, produces, reads
as parameters and DONATES (updates in place), the host scalars of each
dispatch and the device metrics it publishes; a loader head also has a
``prelude``, the host serving bookkeeping that runs before the
scalars are read.  The scalars of one segment are written into one
device block per type (int32, float32) before each dispatch, and the
stage functions read 0-d views of it, so the values change while the
graph does not: the loader's ``(offset, size)`` and the GD units'
learning rates reach the kernels at replay time.

Execution on the card: the first dispatch runs the stages eagerly (a
real step, which also warms up the lazy builds and loads); the second
captures them into a ``torch.cuda.CUDAGraph`` (on the capture side
stream) and replays it once; every later dispatch writes the scalar
blocks and replays.  The Vectors the segment produces are bound once
to the graph's static outputs, and every Vector it reads is set to
``keep_address``, so uploads and publishes go into the captured
buffers.  Before each replay the segment's :class:`CapturedGraph`
checks the address of every tensor it reads against the captured one;
a moved tensor makes it recapture (counted in ``recaptures`` and
logged), never read a stale address.  On the CPU a segment runs its
stage functions in order, eagerly, over CPU tensors, with the same
scalar blocks.

Launch counters count executed launches: a capture records how many
launches of each kernel went into the graph and restores the counters,
and each replay adds them.

The stage-running loop (:func:`run_stages`) is shared with the K-step
epoch-scan windows (:mod:`veles_tpu_torch.epoch_scan`): the head of the
loader-headed segment asks its ``epoch_runner`` for a window before a
per-step dispatch, and a window marks the segments' pass absorbed
(:meth:`StitchSegment.absorb_pass`).

Each segment has a ``segment`` entry in the performance ledger
(:mod:`veles_tpu_torch.prof`): the capture is its compile, with the
cost its kernel wrappers tallied while it was captured
(:mod:`veles_tpu_torch.ops.cost`), and each dispatch adds its time on
the device (``prof.DispatchTimer``: CUDA events around the replay, the
capture left out).  On the CPU the first dispatch is the compile and
each dispatch's tally is its cost.  A recapture is a steady-state
recompile: it replaces the cost and is flagged by the recompile
sentinel.  With ``engine.health`` ``on`` or ``strict``,
:func:`build_segments` folds the training-health statistics
(:mod:`veles_tpu_torch.watch.health`) into the stages before the
segments are built; ``off`` leaves every stage, and so every graph, as
it is.

A pod (:class:`veles_tpu_torch.pod.runtime.PodRuntime`) binds itself to
each segment (``segment.pod``): the segment then calls
``pod.pre_dispatch(self)`` before it gathers its arguments, its ledger
entry carries the pod's ``shards`` and each dispatch the payload
bytes of its collectives (``collective_bytes``), and under a live trace one
``pod``/``shard_dispatch`` lane a shard mirrors the dispatch.  The pod
rewrites the stages' functions for its rank (:meth:`StitchSegment
.invalidate` drops the graph: the next dispatch runs eagerly, which
also sets up a new group's communicator before a capture).

Not ported: the AOT ``EnforcedProgram`` (a CUDA graph
replays what it captured; the address check above stands in for its
signature check), and the JAX package's fallbacks to per-unit dispatch
when a ``stitch_stage()`` or a segment build raises: here the exception
propagates.
"""

import contextlib
import gc
import threading
import time

import numpy
import torch

from veles_tpu_torch import prof, trace
from veles_tpu_torch.config import root
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.memory import Vector, Watcher
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.ops import cost
from veles_tpu_torch.watch import health as watch_health

#: the operand type of every stitched stage's kernels (the GEMM, GD and
#: gather kernels compute f32 on the FMA units): the ledger's MFU
#: denominator for segments and windows
PEAK_DTYPE = "float32"


def enabled():
    """The ``engine.stitch`` switch, read at call time."""
    value = root.common.engine.get("stitch", "on")
    if isinstance(value, str):
        return value.lower() not in ("off", "0", "false", "no")
    return bool(value)


class StitchStage(object):
    """One unit's part of a segment.

    ``fn(tensors)`` receives a dict with every declared name (consumes
    + params + donated + scalars, the scalars as 0-d tensors) and
    returns a dict with every ``produces`` name, every ``donated`` name
    (the same buffer, updated in place) and every ``metrics`` name
    (device scalars set on the unit after each dispatch).  ``health``
    (optional) declares the stage's training-health statistics:
    ``health(t, out)`` returns ``{"grad_norm", "weight_norm",
    "update_norm"}`` as 0-d tensors, ``t`` holding the donated values
    from before the update for the names in ``health.reads_before``.
    ``shard`` (optional, a loader head's) is ``shard(first, rows)``: the
    stage function serving only rows ``[first, first + rows)`` of each
    minibatch, a pod rank's."""

    __slots__ = ("unit", "fn", "consumes", "produces", "params",
                 "donated", "scalars", "metrics", "prelude", "health",
                 "health_spec", "shard")

    def __init__(self, unit, fn, consumes=None, produces=None,
                 params=None, donated=None, scalars=None, metrics=(),
                 prelude=None, health=None, shard=None):
        self.unit = unit
        self.fn = fn
        self.consumes = dict(consumes or {})
        self.produces = dict(produces or {})
        self.params = dict(params or {})
        self.donated = dict(donated or {})
        #: callable -> {name: int or float}, read at every dispatch
        self.scalars = scalars
        self.metrics = tuple(metrics)
        #: host callable run before every dispatch, before the scalars
        self.prelude = prelude
        self.health = health
        #: the HealthGroup once watch.health instrumented the stage
        self.health_spec = None
        self.shard = shard

    def vectors(self):
        for group in (self.consumes, self.produces, self.params,
                      self.donated):
            for vec in group.values():
                yield vec


def _launch_counters():
    """Every kernel wrapper module's ``launches`` dict, the gather's
    ``tables_served`` and ``entry_launches`` and the GEMM wrappers'
    ``bias_in_dw``, ``split_launches`` and ``bf16_bodies``."""
    from veles_tpu_torch.ops import attention, gather, gemm, qgemm
    return (attention.launches, gather.launches, gather.tables_served,
            gather.entry_launches, gemm.launches, gemm.bias_in_dw,
            gemm.split_launches, gemm.bf16_bodies, qgemm.launches)


def scalar_slots(stages):
    """Each stage's ``[(kind, index, name)]`` in the scalar blocks, and
    ``{kind: count}``: ints stay int32 (exact offsets), the rest
    float32."""
    slots, kinds = [], {}
    for stage in stages:
        slots.append([])
        if stage.scalars is None:
            continue
        for name, value in sorted(stage.scalars().items()):
            kind = "int" if isinstance(value, (int, numpy.integer)) \
                and not isinstance(value, bool) else "float"
            index = kinds.get(kind, 0)
            kinds[kind] = index + 1
            slots[-1].append((kind, index, name))
    return slots, kinds


def scalar_values(stages, slots, kinds):
    """``{kind: [value, ...]}``: the stages' scalars read now, in block
    order."""
    values = {kind: [None] * count for kind, count in kinds.items()}
    for stage, stage_slots in zip(stages, slots):
        if stage_slots:
            current = stage.scalars()
            for kind, index, name in stage_slots:
                values[kind][index] = current[name]
    return values


def run_stages(stages, slots, tensors, scalar, health=True):
    """Run ``stages`` in order, once.  ``tensors`` maps ``id(Vector)``
    to the tensor a stage reads for it: every Vector no earlier stage
    produced must be there, and each stage's produced and donated
    results are written back into it, so a later stage (or the next
    step of a window) reads them.  ``scalar(kind, index)`` gives the
    0-d tensor of a scalar slot.  Returns the stages' metrics, in
    order.  ``health=False`` runs the instrumented stages without their
    health statistics (a window's steps before its last, whose
    statistics it reports): their places among the metrics hold
    None."""
    metrics = []
    for stage, stage_slots in zip(stages, slots):
        t = {name: tensors[id(vec)]
             for group in (stage.consumes, stage.params, stage.donated)
             for name, vec in group.items()}
        for kind, index, name in stage_slots:
            t[name] = scalar(kind, index)
        skip = not health and stage.health_spec is not None
        out = stage.fn.plain(t) if skip else stage.fn(t)
        for group in (stage.produces, stage.donated):
            for name, vec in group.items():
                tensors[id(vec)] = out[name]
        if skip:
            metrics.extend(out.get(name) for name in stage.metrics)
        else:
            metrics.extend(out[name] for name in stage.metrics)
    return metrics


#: captures in flight in any thread, and whether the collector was on
#: when the first of them began
_collection_hold = {"captures": 0, "was_enabled": True}
_collection_lock = threading.Lock()


@contextlib.contextmanager
def _no_collection():
    """The garbage collector off while any thread captures a graph."""
    with _collection_lock:
        if _collection_hold["captures"] == 0:
            _collection_hold["was_enabled"] = gc.isenabled()
            gc.disable()
        _collection_hold["captures"] += 1
    try:
        yield
    finally:
        with _collection_lock:
            _collection_hold["captures"] -= 1
            if _collection_hold["captures"] == 0 \
                    and _collection_hold["was_enabled"]:
                gc.enable()


class CapturedGraph(Logger):
    """One CUDA graph and its discipline, shared by a segment and an
    epoch-scan window: captured at its first replay, replayed after,
    and captured again (counted in ``recaptures`` and logged) when a
    tensor it reads or writes has moved, never read at a stale
    address.  A capture records how many launches of each kernel went
    into the graph and restores the launch counters; each replay adds
    them.

    A capture runs with the garbage collector off: a collection during
    the capture could free an unreachable workflow's graphs (a loaded
    snapshot's predecessor, an earlier run's segments), and destroying
    a graph while a stream captures invalidates the capture.  The
    garbage waits for the next collection after the capture."""

    def __init__(self, name, device, capture_error_mode=None):
        super(CapturedGraph, self).__init__()
        self.name = name
        self.device = device
        #: ``torch.cuda.graph``'s capture_error_mode (None: its default,
        #: "global"); "thread_local" lets other threads keep launching
        #: while this one captures
        self.capture_error_mode = capture_error_mode
        self.captures = 0
        self.recaptures = 0
        self.replays = 0
        #: host seconds spent capturing (``torch.cuda.graph``'s
        #: synchronize on entry included)
        self.capture_seconds = 0.0
        #: the bytes of the graph's private memory pool after the last
        #: capture: its segments, and what stays allocated in them
        self.pool_reserved_bytes = 0
        self.pool_allocated_bytes = 0
        self._graph = None
        self._launched = []
        self._ptrs = None
        self._static = None

    @property
    def launches(self):
        """``{kernel: launches}`` of one replay."""
        return {name: count for _c, name, count in self._launched}

    def drop(self):
        """Forget the graph: the next replay captures anew (a capture,
        not a recapture: the program changed, not an address)."""
        self._graph = None
        self._ptrs = None
        self._static = None

    def replay(self, body, tensors, labels, on_capture=None, timer=None):
        """Replay the graph of ``body()``, whose inputs and outputs are
        ``tensors`` (``labels`` name them in the log), capturing it
        first when there is none or one of them moved;
        ``on_capture(results)`` sees a new capture's results before the
        replay, and ``timer`` (a ledger ``DispatchTimer``) is started
        right before it.  Returns ``body()``'s results as the graph
        holds them."""
        ptrs = [t.data_ptr() for t in tensors]
        if self._graph is not None and ptrs != self._ptrs:
            moved = [label for label, a, b in zip(labels, ptrs, self._ptrs)
                     if a != b]
            self.warning("%s: %d tensor(s) it reads or writes moved (%s); "
                         "recapturing", self.name, len(moved), moved)
            self.recaptures += 1
            self._graph = None
        if self._graph is None:
            self._capture(body, on_capture)
            self._ptrs = ptrs
        if timer is not None:
            timer.restart()
        self._graph.replay()
        self.replays += 1
        for counters, name, count in self._launched:
            counters[name] += count
        return self._static

    def _capture(self, body, on_capture):
        tic = time.perf_counter()
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        options = {} if self.capture_error_mode is None else {
            "capture_error_mode": self.capture_error_mode}
        try:
            with _no_collection(), torch.cuda.graph(graph, **options):
                static = body()
        finally:
            launched = [(c, name, c[name] - b[name])
                        for c, b in zip(counters, before) for name in c
                        if c[name] != b[name]]
            for c, b in zip(counters, before):
                c.update(b)
        if on_capture is not None:
            on_capture(static)
        self._graph, self._launched, self._static = graph, launched, static
        pool = tuple(graph.pool())
        segments = [seg for seg in torch.cuda.memory_snapshot()
                    if tuple(seg.get("segment_pool_id", ())) == pool]
        self.pool_reserved_bytes = sum(seg["total_size"]
                                       for seg in segments)
        self.pool_allocated_bytes = sum(seg["allocated_size"]
                                        for seg in segments)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - tic

    def report(self):
        return {"captures": self.captures, "recaptures": self.recaptures,
                "replays": self.replays, "capture_s": self.capture_seconds,
                "graph_launches": self.launches,
                "pool_reserved_bytes": self.pool_reserved_bytes,
                "pool_allocated_bytes": self.pool_allocated_bytes}


class ScalarBlock(object):
    """The scalars of one type of a segment's dispatch (``shape`` a
    count), or of every step of a window (``(steps, count)``), in one
    device buffer that the stage functions read through 0-d views.  On
    the card each write goes through a small ring of pinned host
    buffers, so the host never overwrites one whose copy is still
    queued."""

    RING = 4

    def __init__(self, shape, dtype, device):
        self.dtype = dtype
        self.tensor = torch.zeros(shape, dtype=dtype, device=device)
        self.nbytes = self.tensor.numel() * self.tensor.element_size()
        self._ring = []
        if self.tensor.device.type == "cuda":
            self._ring = [(torch.empty(shape, dtype=dtype, pin_memory=True),
                           torch.cuda.Event()) for _ in range(self.RING)]
            self._used = [False] * self.RING
            self._next = 0

    def view(self, index):
        return self.tensor[index]

    def write(self, values):
        if not self._ring:
            self.tensor.copy_(torch.tensor(values, dtype=self.dtype))
        else:
            slot = self._next
            self._next = (slot + 1) % self.RING
            host, done = self._ring[slot]
            if self._used[slot]:
                done.synchronize()
            host.numpy()[:] = values
            self.tensor.copy_(host, non_blocking=True)
            done.record()
            self._used[slot] = True
        Watcher.track_h2d(self.nbytes)


class StitchSegment(Logger):
    """A maximal run of stitchable units, dispatched as one step."""

    def __init__(self, units, stages, device):
        super(StitchSegment, self).__init__()
        self.units = list(units)
        self.stages = list(stages)
        self.head = self.units[0]
        self.device = torch.device(device)
        self.dispatches = 0
        self._computed = set()
        self._member_ids = frozenset(id(u) for u in self.units[1:])
        #: the epoch-scan runner a loader-headed segment's head asks
        #: for a window (set by veles_tpu_torch.epoch_scan)
        self.epoch_runner = None
        #: a window ran this segment's pass, head included
        self._head_absorbed_ = False
        #: the health groups riding this segment's metrics (empty with
        #: engine.health=off)
        self._health_groups = [stage.health_spec for stage in stages
                               if stage.health_spec is not None]
        self._build_plan()
        self._trace_args = {"segment": "+".join(self.names)}
        #: the segment's graph on the card
        self.graph = CapturedGraph(repr(self), self.device)
        #: the performance-ledger entry (the capture's cost, the
        #: dispatch clocks), registered at the first dispatch: a
        #: segment a window always absorbs registers none
        self.prof_entry = None
        #: the pod runtime bound to this segment (None: one device)
        self.pod = None
        #: the next dispatch runs eagerly, and the capture after it is a
        #: new program's, not a steady-state recompile (set by invalidate)
        self._eager_next_ = False
        self._new_program_ = False

    @property
    def names(self):
        return [u.name for u in self.units]

    def __repr__(self):
        return "<StitchSegment %s>" % "+".join(self.names)

    # -- plan ---------------------------------------------------------------
    def _build_plan(self):
        produced = set()
        input_vecs, input_ids = [], set()
        ro_vecs, don_vecs = [], []
        metric_spec = []
        for stage in self.stages:
            for vec in stage.consumes.values():
                if id(vec) not in produced and id(vec) not in input_ids:
                    input_ids.add(id(vec))
                    input_vecs.append(vec)
            for _name, vec in sorted(stage.params.items()):
                ro_vecs.append(vec)
            for _name, vec in sorted(stage.donated.items()):
                don_vecs.append(vec)
            for vec in stage.produces.values():
                produced.add(id(vec))
            for name in stage.metrics:
                metric_spec.append((stage.unit, name))
        # a donated buffer belongs to ONE stage and doubles as nothing
        # else in the segment: a later stage would read it half updated
        don_ids = [id(vec) for vec in don_vecs]
        aliased = (len(don_ids) != len(set(don_ids))
                   or any(i in input_ids for i in don_ids)
                   or any(i in produced for i in don_ids)
                   or any(id(vec) in don_ids for vec in ro_vecs))
        if aliased:
            raise ValueError(
                "segment %s aliases a donated Vector with another "
                "read/write slot - not stitchable" % "+".join(self.names))
        output_vecs, seen = [], set()
        for stage in self.stages:
            for vec in stage.produces.values():
                if id(vec) not in seen:
                    seen.add(id(vec))
                    output_vecs.append(vec)
        self._read_vecs = input_vecs + ro_vecs + don_vecs
        for vec in self._read_vecs:
            vec.keep_address = True
        self._n_inputs, self._n_ro = len(input_vecs), len(ro_vecs)
        self._don_vecs = don_vecs
        self._scalar_slots, self._kinds = scalar_slots(self.stages)
        self._output_vecs = output_vecs
        self._metric_spec = metric_spec
        self._blocks = {
            kind: ScalarBlock(count, torch.int32 if kind == "int"
                              else torch.float32, self.device)
            for kind, count in self._kinds.items()}

    # -- the stages ----------------------------------------------------------
    def _write_scalars(self):
        values = scalar_values(self.stages, self._scalar_slots, self._kinds)
        for kind, block in self._blocks.items():
            block.write(values[kind])

    def _run_stages(self, tensors):
        """The stage functions in order over ``tensors`` (inputs, then
        read-only params, then donated buffers, as ``_read_vecs``):
        ``(outputs, donated, metrics)``."""
        env = {id(vec): t for vec, t in zip(self._read_vecs, tensors)}
        blocks = self._blocks
        metrics = run_stages(self.stages, self._scalar_slots, env,
                             lambda kind, index: blocks[kind].view(index))
        return ([env[id(vec)] for vec in self._output_vecs],
                [env[id(vec)] for vec in self._don_vecs], metrics)

    def _publish(self, outputs, donated, metrics):
        for vec, value in zip(self._output_vecs, outputs):
            vec.devmem = value
        for vec, value in zip(self._don_vecs, donated):
            vec.devmem = value
        for (unit, name), value in zip(self._metric_spec, metrics):
            setattr(unit, name, value)

    # -- the graph -----------------------------------------------------------
    def _replay(self, tensors, timer=None):
        def captured(static):
            """A new capture: donated buffers stay put, and the produced
            Vectors are bound to the graph's outputs."""
            outputs, donated, _metrics = static
            moved = [vec for vec, new, old in zip(
                self._don_vecs, donated,
                tensors[self._n_inputs + self._n_ro:])
                if new.data_ptr() != old.data_ptr()]
            if moved:
                raise RuntimeError(
                    "%s: a stage returned a new buffer for a donated "
                    "Vector (%s); donated buffers are updated in place"
                    % (self, moved))
            for vec, value in zip(self._output_vecs, outputs):
                vec.bind(value)
        self._publish(*self.graph.replay(
            lambda: self._run_stages(tensors), tensors, self._read_vecs,
            on_capture=captured, timer=timer))

    # -- execution ----------------------------------------------------------
    def execute(self):
        """Run the preludes, write the scalars and dispatch the
        segment: eagerly on the CPU and at the first dispatch on the
        card, as a graph replay after that.  The dispatch lands in the
        ledger and, with health armed, its stats in the monitor."""
        pod = self.pod
        if pod is not None:
            # the pod's pre-dispatch site: a reshard here rewrites this
            # segment's stages before the arguments are gathered
            pod.pre_dispatch(self)
        with trace.span("segment", "dispatch", self._trace_args):
            tic = time.perf_counter_ns()
            for stage in self.stages:
                if stage.prelude is not None:
                    stage.prelude()
            self._write_scalars()
            tensors = [vec.devmem for vec in self._read_vecs]
            eager = (self.device.type != "cuda" or self.dispatches == 0
                     or self._eager_next_)
            if self.prof_entry is None:
                self.prof_entry = prof.ledger.entry(
                    "segment", "+".join(self.names), self.device.type)
                self.prof_entry.peak_dtype = PEAK_DTYPE
                if pod is not None:
                    self.prof_entry.shards = pod.shards
            captures = self.graph.captures
            timer = prof.DispatchTimer(self.device)
            with cost.Tally() as tally, timer:
                if eager:
                    self._publish(*self._run_stages(tensors))
                else:
                    self._replay(tensors, timer)
            if self.graph.captures != captures:
                # the wrappers ran once, inside the capture
                record_compile(self.prof_entry, tally.cost(),
                               self._trace_args,
                               steady=captures > 0 and not self._new_program_,
                               logger=self)
                self._new_program_ = False
            elif self.device.type != "cuda" and self.dispatches == 0:
                record_compile(self.prof_entry, tally.cost(),
                               self._trace_args)
            prof.ledger.record_dispatch(
                self.prof_entry, timer,
                cost=tally.cost() if eager else None,
                collective_bytes=pod.segment_collective_bytes(self)
                if pod else 0)
            if pod is not None and trace.enabled():
                # one lane a shard under the pod role, on host clocks
                toc = time.perf_counter_ns()
                for shard in range(pod.shards):
                    trace.complete("pod", "shard_dispatch", tic, toc - tic,
                                   self._trace_args, role="pod", tid=shard)
            self._eager_next_ = False
            self.dispatches += 1
            if self._health_groups:
                # one instrumented dispatch = one train step's stats (a
                # strict check at its cadence raises out of here)
                watch_health.monitor.observe(steps=1)
            self._computed = set(self._member_ids)

    def member_run(self, unit):
        """The per-unit hook: the head dispatches the segment (or a
        window, when its epoch runner takes one), members are no-ops
        for the pass the head computed.  A member firing without a
        preceding head dispatch runs its own ``run()``."""
        if unit is self.head:
            if self._head_absorbed_:
                # a window already ran this segment's steps
                self._head_absorbed_ = False
                return
            runner = self.epoch_runner
            if runner is not None and runner.try_window(self):
                return
            self.execute()
            return
        if id(unit) in self._computed:
            self._computed.discard(id(unit))
            return
        unit.run()

    def absorb_pass(self, include_head=False):
        """Mark one pass of this segment as computed by a window:
        members no-op, and with ``include_head`` the head's next firing
        too (the GD segment, whose steps the window ran)."""
        self._computed = set(self._member_ids)
        if include_head:
            self._head_absorbed_ = True

    def reset_pass(self):
        """Forget a half-consumed pass (``Workflow.run`` calls this
        before each drain)."""
        self._computed = set()
        self._head_absorbed_ = False

    def detach(self):
        for unit in self.units:
            unit.attach_stitch_segment(None)

    def invalidate(self):
        """The stages' functions changed (a pod installed, resharded or
        left): drop the graph, so the next dispatch runs eagerly and the
        one after captures the new program once."""
        self.graph.drop()
        self._eager_next_ = True
        self._new_program_ = True

    def report(self):
        graph = self.graph
        return {"names": self.names, "dispatches": self.dispatches,
                "flops": self.prof_entry.flops if self.prof_entry else 0.0,
                "captures": graph.captures, "recaptures": graph.recaptures,
                "replays": graph.replays,
                "capture_s": graph.capture_seconds,
                "graph_launches": graph.launches,
                "loader_headed": any(s.prelude is not None
                                     for s in self.stages)}


def record_compile(entry, cost_dict, trace_args, steady=False,
                   logger=None):
    """A segment's or a window's compile point: the ledger entry gets
    ``cost_dict`` (replacing the last), a ``segment/compile`` instant
    carries it (:func:`veles_tpu_torch.prof.entries_from_events` reads
    it back), and a ``steady`` one (a recapture) is flagged by the
    recompile sentinel."""
    cost_dict, span_args = prof.span_cost_args(cost_dict, trace_args,
                                               peak_dtype=entry.peak_dtype)
    prof.ledger.record_compile(entry, cost=cost_dict, steady=steady)
    if steady:
        span_args["recompile"] = True
        prof.flag_recompile(
            "stitch:%s" % entry.name, None, None, logger=logger,
            detail="%s recaptured: a tensor its graph reads moved"
            % entry.name)
    trace.instant("segment", "compile", span_args)


# -- building segments ------------------------------------------------------

def _constant_false(cell):
    """A plain Bool(False) with no expression: the gate can never flip
    under the segment."""
    return (type(cell) is Bool and cell._expr is None
            and cell._value is False)


def _gate_compatible(head, unit):
    if unit.ignores_gate or unit.wants_thread \
            or not _constant_false(unit.gate_block):
        return False
    return (_constant_false(unit.gate_skip)
            or unit.gate_skip is head.gate_skip)


def _stage_of(unit, cache):
    if id(unit) not in cache:
        maker = getattr(unit, "stitch_stage", None)
        cache[id(unit)] = maker() if callable(maker) else None
    return cache[id(unit)]


def _vectors_ready(stage):
    return all(isinstance(vec, Vector) and vec for vec in stage.vectors())


def build_segments(workflow):
    """Walk the control graph and return its :class:`StitchSegment`\\ s
    (empty when stitching is off, no device is attached, or no chain
    qualifies).  Members get their segment through
    ``Unit.attach_stitch_segment``.  Every build owns the process-wide
    health monitor: it is disarmed first, and armed again when
    ``engine.health`` instruments this build's stages."""
    # disarm FIRST: a knob flip to off or a stitch-off rebuild must not
    # leave the previous build's groups armed
    watch_health.monitor.reset()
    if not enabled():
        return []
    device = getattr(workflow, "device", None)
    torch_device = getattr(device, "torch_device", None)
    if torch_device is None:
        return []
    health_mode = watch_health.health_mode()
    health_groups = []
    cache = {}
    assigned = set()
    segments = []
    for unit in workflow.units_in_dependency_order():
        if id(unit) in assigned or unit is workflow:
            continue
        head_stage = _stage_of(unit, cache)
        if head_stage is None or unit.wants_thread:
            continue
        chain, stages, cur = [unit], [head_stage], unit
        while True:
            targets = list(cur.links_to)
            if len(targets) != 1:
                break
            nxt = targets[0]
            if id(nxt) in assigned or len(nxt.links_from) != 1 \
                    or not _gate_compatible(unit, nxt):
                break
            stage = _stage_of(nxt, cache)
            if stage is None:
                break
            chain.append(nxt)
            stages.append(stage)
            cur = nxt
        if len(chain) < 2:
            continue
        blocked = [s.unit.name for s in stages if not _vectors_ready(s)]
        if blocked:
            workflow.info(
                "not stitching %s: %s exposes an empty Vector; the chain "
                "stays on per-unit dispatch",
                "+".join(u.name for u in chain), ", ".join(blocked))
            continue
        if health_mode != "off":
            # the stats become part of the stages before the segment
            # plans its metrics; off leaves the stages untouched
            health_groups.extend(watch_health.instrument_stages(stages))
        segment = StitchSegment(chain, stages, torch_device)
        for member in chain:
            member.attach_stitch_segment(segment)
            assigned.add(id(member))
        segments.append(segment)
    if health_groups:
        watch_health.monitor.install(health_groups, health_mode)
        workflow.info("health telemetry %s: %d param group(s): %s",
                      health_mode, len(health_groups),
                      ", ".join(g.name for g in health_groups))
    if segments:
        workflow.info("stitched %d segment(s): %s", len(segments),
                      "; ".join("+".join(s.names) for s in segments))
    return segments
