"""One-dispatch epoch windows: K training steps as one CUDA graph.

The port's counterpart of :mod:`veles_tpu.epoch_scan`.  The stitched
route (:mod:`veles_tpu_torch.stitch`) dispatches each minibatch as one
or two segment graphs; a window folds K consecutive steps of the
repeater cycle (the loader-headed forward/evaluator segment, the
Decision's per-step accumulation and, on TRAIN minibatches, the GD
segment) into one dispatch:

1. the host serves the K steps in a tight loop
   (:meth:`veles_tpu_torch.loader.base.Loader.scan_window_step`, the
   segment prelude once a step), collecting each step's row of scalars
   (the loader's offset and size, the evaluator's batch, the GD
   hyperparameters);
2. the rows go up in one stacked block per type (``(K, n)`` int32 and
   float32, through the pinned ring of
   :class:`~veles_tpu_torch.stitch.ScalarBlock`), and step ``i``'s
   stages read 0-d views of row ``i``: the served gather reads its
   offset and size by address, the GD kernels their learning rates;
3. one :class:`WindowGraph` runs the K steps over the donated weights,
   momenta and confusion matrix (updated in place) and computes the
   Decision's accumulator ``prior + Σ step metrics`` in float32;
4. the last step's outputs are copied into the buffers the per-step
   segment graphs captured (their addresses never move, so a knob flip
   or a per-step dispatch after a window replays those graphs without
   a recapture), the metric lasts are set on their units and
   ``decision.scan_commit`` installs the accumulator.

A window never crosses a class close (the step that raises
``last_minibatch`` ends it), nor a ``metrics_every`` flush
(:meth:`~veles_tpu_torch.znicz.decision.DecisionBase.scan_flush_budget`),
and is at most K long, so every host-visible event happens at the step
the per-step route has it.  On a class-closing validated window the
Decision's device predicate runs in the graph and its verdict lands in
``decision.scan_verdict``; the host close stays authoritative.

On the card each window key ``(train, K, verdict)`` has its graph: the
first window of a key runs its steps eagerly (which warms the lazy
kernel builds), the second captures them into one
``torch.cuda.CUDAGraph`` and replays it, later ones write the blocks
and replay.  Launch counters count replays.  A tensor the graph reads
or writes that moved makes it recapture (counted and logged).  On the
CPU a window runs its steps eagerly over CPU tensors.  An exception in
a window propagates; a workflow whose structure a window cannot fold
keeps the per-step route, with the reason in ``describe()["reason"]``.

Knob: ``root.common.engine.epoch_scan = off | auto | <K>``: ``off``
(the default) is the per-step stitched route, ``auto`` takes K =
``metrics_every`` when set, else :data:`AUTO_WINDOW`; an integer pins
K.

Each window kind (with and without the GD segment) has one ``segment``
entry in the performance ledger, named ``scan:`` + the units, as in the
JAX package: a key's capture is its compile, with one step's cost (the
capture's tally over K), and each window dispatches K steps
(``record_dispatch(steps=K)``), timed on the device around its steps.
On the CPU a key's first window is its compile and each window's tally
its cost.  With ``engine.health`` armed the stages carry the
statistics (:mod:`veles_tpu_torch.watch.health`); a window computes
them at its last step only and lands them (NaNs persist through the
updates, so the last step's counts see any earlier one), and the
monitor observes K steps at the window boundary, where ``strict``
checks.

Over a pod (:class:`veles_tpu_torch.pod.runtime.PodRuntime`) a window
replays, on every rank, the stages the pod rewrote for it, with their
collectives inside the graph; the pod's ``pre_dispatch`` is asked once
a window, the window's ledger entry carries the pod's ``shards`` and
each window the per-step ``collective_bytes`` times its K, and a reshard drops
every window graph (:meth:`EpochScanRunner.invalidate_programs`), so
the next window of each key runs eagerly on the new mesh and captures
once.

Not ported: the chaos ``pod_chip`` site the pod's ``pre_dispatch``
stands for and ``run_smoke``'s analyzer check ``scan_epoch_scan_hazards``
(item 7(e)).
"""

import torch

from veles_tpu_torch import prof, trace
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.base import TRAIN, Loader
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.ops import cost
from veles_tpu_torch.stitch import (PEAK_DTYPE, CapturedGraph, ScalarBlock,
                                    _constant_false, record_compile,
                                    run_stages, scalar_slots, scalar_values)
from veles_tpu_torch.watch import health as watch_health

#: the ``auto`` bound when ``metrics_every`` is unset: a class pass of
#: any workload the repo runs is one window
AUTO_WINDOW = 1024


def mode():
    """The ``root.common.engine.epoch_scan`` knob, read at call time:
    0 = off, else the window bound K."""
    value = root.common.engine.get("epoch_scan", "off")
    if isinstance(value, str):
        value = value.strip().lower()
        if value in ("off", "0", "false", "no", ""):
            return 0
        if value in ("auto", "on", "true", "yes"):
            every = int(root.common.engine.get("metrics_every", 0) or 0)
            return every if every > 0 else AUTO_WINDOW
        try:
            return max(0, int(value))
        except ValueError:
            raise ValueError(
                "root.common.engine.epoch_scan must be off|auto|<K>, "
                "got %r" % value)
    if value is True:
        return AUTO_WINDOW
    return max(0, int(value or 0))


class ScanPlan(object):
    """A window step's stages and their slots.  Unlike a segment's
    plan, a Vector one stage donates may be read by another (the
    forward reads the weights the GD stage updates): every read of it
    is the buffer the donor updates in place, so step ``i``'s forward
    sees the weights step ``i - 1``'s GD wrote, as K per-step
    dispatches do."""

    def __init__(self, stages):
        self.stages = list(stages)
        donors = {}
        for stage in self.stages:
            for vec in stage.donated.values():
                if id(vec) in donors:
                    raise ValueError(
                        "stage %s re-donates a Vector another stage "
                        "already donates - not scannable"
                        % stage.unit.name)
                donors[id(vec)] = stage
        produced, read_ids = set(), set()
        self.ext_vecs, self.don_vecs, self.out_vecs = [], [], []
        self.metric_spec = []
        for stage in self.stages:
            for group in (stage.consumes, stage.params, stage.donated):
                for vec in group.values():
                    if id(vec) in produced or id(vec) in read_ids:
                        continue
                    read_ids.add(id(vec))
                    (self.don_vecs if id(vec) in donors
                     else self.ext_vecs).append(vec)
            for vec in stage.produces.values():
                if id(vec) in donors:
                    raise ValueError(
                        "stage %s produces a Vector another stage "
                        "donates - not scannable" % stage.unit.name)
                if id(vec) in read_ids:
                    # an earlier stage read it before it is produced: a
                    # dependency across steps the per-step route meets
                    # through the Vector; a window would freeze it
                    raise ValueError(
                        "stage %s produces a Vector an earlier stage "
                        "consumed (cross-iteration dependency) - not "
                        "scannable" % stage.unit.name)
                if id(vec) not in produced:
                    produced.add(id(vec))
                    self.out_vecs.append(vec)
            self.metric_spec.extend((stage.unit, name)
                                    for name in stage.metrics)
        self.read_vecs = self.ext_vecs + self.don_vecs
        self.slots, self.kinds = scalar_slots(self.stages)

    def fetch_scalars(self):
        """This step's scalars, ``{kind: [value, ...]}`` (called after
        the step is served)."""
        return scalar_values(self.stages, self.slots, self.kinds)


class WindowGraph(object):
    """The window of one ``(train, K, verdict)`` key: its stacked
    scalar blocks, its prior slot and, on the card, its graph."""

    def __init__(self, plan, k, device, accum_index, predicate=None,
                 pred_names=(), name="window", entry=None):
        self.plan = plan
        self.k = int(k)
        self.device = torch.device(device)
        self.accum_index = accum_index
        self.predicate = predicate
        self.pred_names = tuple(pred_names)
        self.name = name
        self.blocks = {
            kind: ScalarBlock((self.k, count), torch.int32 if kind == "int"
                              else torch.float32, self.device)
            for kind, count in plan.kinds.items()}
        self.preds = ScalarBlock(len(self.pred_names), torch.float32,
                                 self.device) if predicate else None
        #: the accumulator's starting value, copied in before each run
        self.prior = torch.zeros((), dtype=torch.float32,
                                 device=self.device)
        self.runs = 0
        #: the window's graph on the card
        self.graph = CapturedGraph(name, self.device)
        #: the ledger entry of its kind (shared by the kind's keys)
        self.entry = entry
        self.trace_args = {"segment": entry.name if entry else name,
                           "steps": self.k, "scan": True}

    def _body(self, tensors):
        """The K steps over ``tensors`` (the plan's read Vectors' tensors,
        then the buffers its outputs are copied into): ``(accum, lasts,
        verdict)``."""
        plan, n = self.plan, len(self.plan.read_vecs)
        env = {id(vec): t for vec, t in zip(plan.read_vecs, tensors[:n])}
        blocks, step_metrics = self.blocks, []
        for i in range(self.k):
            # a window reports its last step's health statistics, so only
            # that step computes them
            metrics = run_stages(
                plan.stages, plan.slots, env,
                lambda kind, index: blocks[kind].tensor[i, index],
                health=i == self.k - 1)
            step_metrics.append(metrics[self.accum_index])
        accum = self.prior + torch.stack(step_metrics).to(
            torch.float32).sum()
        for dest, vec in zip(tensors[n:], plan.out_vecs):
            dest.copy_(env[id(vec)])
        moved = [vec for vec, t in zip(plan.don_vecs, tensors[n - len(
            plan.don_vecs):n]) if env[id(vec)].data_ptr() != t.data_ptr()]
        if moved:
            raise RuntimeError("%s: a stage returned a new buffer for a "
                               "donated Vector (%s); donated buffers are "
                               "updated in place" % (self.name, moved))
        verdict = None
        if self.predicate is not None:
            scal = {name: self.preds.tensor[j]
                    for j, name in enumerate(self.pred_names)}
            verdict = self.predicate(accum, scal)
        return accum, metrics, verdict

    def execute(self, rows, prior, preds=None, timer=None):
        """Write the blocks (``rows``: a ``{kind: [value, ...]}`` a
        step), copy ``prior`` (a device scalar, or None for 0) into the
        prior slot and run the window: eagerly on the CPU and at a
        key's first window on the card, as a graph replay after that.
        ``timer`` (a ledger ``DispatchTimer``) brackets the steps, started
        again right before a replay.  Returns ``(accum, lasts,
        verdict)``."""
        for kind, block in self.blocks.items():
            block.write([row[kind] for row in rows])
        if self.preds is not None:
            self.preds.write([float(preds[name]) for name in self.pred_names])
        if prior is None:
            self.prior.zero_()
        else:
            self.prior.copy_(prior)
        vecs = self.plan.read_vecs + self.plan.out_vecs
        tensors = [vec.devmem for vec in vecs]
        if timer is not None:
            timer.restart()
        if self.device.type != "cuda" or self.runs == 0:
            result = self._body(tensors)
        else:
            result = self.graph.replay(lambda: self._body(tensors),
                                       tensors, vecs, timer=timer)
        self.runs += 1
        return result

    def report(self):
        return dict(self.graph.report(), steps=self.k, runs=self.runs)


class EpochScanRunner(Logger):
    """Binds to a stitched workflow's repeater cycle and, while the
    knob allows, runs K-step windows.  Built by
    ``Workflow.rebuild_stitching()``; the loader-headed segment's head
    asks :meth:`try_window` before every per-step dispatch, so the knob
    is read per window in both directions."""

    def __init__(self, workflow):
        super(EpochScanRunner, self).__init__()
        self.workflow = workflow
        self._programs = {}
        self._plans = {}
        self.windows = 0
        self.steps = 0
        self.reason = None
        #: the ledger entries by window kind (train or not)
        self._entries = {}
        self._structure = self._analyze()
        if self._structure is not None:
            self._structure["seg1"].epoch_runner = self

    # -- eligibility --------------------------------------------------------
    def _analyze(self):
        """The structural check: the repeater cycle must be exactly
        ``repeater → [loader + forwards + evaluator] → decision →
        [gds] → repeater`` with a scan-compatible Decision; anything
        else keeps the per-step route, and ``reason`` says why."""
        wf = self.workflow
        why = None
        seg1 = seg2 = decision = repeater = None
        segments = list(getattr(wf, "_stitch_segments_", ()))
        for segment in segments:
            if isinstance(segment.head, Loader) and any(
                    s.prelude is not None for s in segment.stages):
                seg1 = segment
                break
        if seg1 is None:
            why = ("no loader-headed stitched segment (needs "
                   "engine.loader=auto|device and a resident FullBatch "
                   "dataset)")
        if why is None:
            tail = seg1.units[-1]
            targets = list(tail.links_to)
            if len(targets) != 1:
                why = "segment tail %s fans out" % tail.name
            else:
                decision = targets[0]
                if not getattr(decision, "scan_compatible", False):
                    why = ("%s is not scan-compatible (its run() is not "
                           "the window protocol's)" % decision.name)
                elif getattr(decision, "evaluator", None) is not tail:
                    why = "decision does not read the segment tail"
        if why is None:
            targets = list(decision.links_to)
            if len(targets) != 1:
                why = ("units hang off %s in the training loop: %s"
                       % (decision.name,
                          ", ".join(u.name for u in targets)))
            else:
                head2 = targets[0]
                seg2 = next((s for s in segments if s.head is head2),
                            None)
                if seg2 is None:
                    why = ("%s after the decision is not a stitched "
                           "segment head" % head2.name)
        if why is None:
            if not _constant_false(seg2.head.gate_block):
                why = "GD head %s has a dynamic gate_block" \
                    % seg2.head.name
            else:
                tail2 = seg2.units[-1]
                extras = [u for u in tail2.links_to
                          if u is not wf.end_point]
                repeater = extras[0] if len(extras) == 1 else None
                if repeater is None or not getattr(
                        repeater, "ignores_gate", False) \
                        or list(repeater.links_to) != [seg1.head]:
                    why = ("GD tail does not close the loop on a "
                           "repeater feeding the loader")
        if why is None:
            loader = seg1.head
            metric = decision.SCAN_METRIC
            if not any(stage.unit is decision.evaluator
                       and metric in stage.metrics
                       for stage in seg1.stages):
                why = ("decision metric %r is not a stage metric of the "
                       "decision's evaluator" % (metric,))
            elif not getattr(loader, "device_fast_path_active", False):
                why = "loader device fast path inactive"
            elif any(stage.prelude is not None and stage.unit is not loader
                     for segment in (seg1, seg2)
                     for stage in segment.stages):
                # a window serves only the loader's prelude, K times
                why = "a non-loader stage carries a prelude"
        if why is None:
            try:
                self._plans[False] = ScanPlan(seg1.stages)
                self._plans[True] = ScanPlan(seg1.stages + seg2.stages)
            except ValueError as exc:
                why = "stages not scannable: %s" % exc
        if why is not None:
            self.reason = why
            self.debug("epoch scan ineligible: %s", why)
            return None
        return {"seg1": seg1, "seg2": seg2, "decision": decision,
                "repeater": repeater, "loader": seg1.head}

    @property
    def eligible(self):
        return self._structure is not None

    def describe(self):
        """Eligibility (with the reason when not), windows and steps
        run, and each window graph's report by key."""
        return {"eligible": self.eligible, "reason": self.reason,
                "windows": self.windows, "steps": self.steps,
                "programs": len(self._programs),
                "graphs": {key: program.report() for key, program
                           in sorted(self._programs.items())}}

    def invalidate_programs(self):
        """Drop every window graph: the next window of each key runs
        eagerly and captures again."""
        self._programs = {}

    def reset_pass(self):
        """Forget a half-consumed window pass (the Decision's absorb
        mark): ``Workflow.run()`` calls it before each drain, with the
        segments' ``reset_pass``."""
        if self._structure is not None:
            self._structure["decision"].scan_reset()

    # -- windows -------------------------------------------------------------
    def _program_for(self, train, k, verdict):
        key = (train, k, verdict)
        program = self._programs.get(key)
        if program is None:
            s = self._structure
            plan = self._plans[train]
            decision = s["decision"]
            accum_index = next(
                i for i, (unit, name) in enumerate(plan.metric_spec)
                if unit is decision.evaluator
                and name == decision.SCAN_METRIC)
            predicate, pred_names = None, ()
            if verdict:
                predicate = decision.device_predicate()
                pred_names = tuple(sorted(decision.predicate_scalars(
                    0, 0, 0)))
            names = s["seg1"].names + (s["seg2"].names if train else [])
            program = WindowGraph(
                plan, k, s["seg1"].device, accum_index,
                predicate=predicate, pred_names=pred_names,
                name="scan:%s[K=%d%s]" % ("+".join(names), k,
                                          ",verdict" if verdict else ""),
                entry=self._entry(train, names))
            self._programs[key] = program
        return program

    def _entry(self, train, names):
        entry = self._entries.get(train)
        if entry is None:
            entry = self._entries[train] = prof.ledger.entry(
                "segment", "scan:" + "+".join(names),
                self._structure["seg1"].device.type)
            entry.peak_dtype = PEAK_DTYPE
        return entry

    def try_window(self, segment):
        """Called by the loader-headed segment's head in place of a
        per-step dispatch: False when the knob is off or the workflow
        is ineligible or the loader retries failed minibatches (served
        one a step), True after running one window.  (The JAX package
        also declines while the loader serves a master or slave; the
        port's loader has no job mode.)"""
        k_max = mode()
        if k_max < 1 or not self.eligible:
            return False
        every = int(root.common.engine.get("metrics_every", 0) or 0)
        if every > 0:
            k_max = min(k_max, every)
        if self._structure["loader"].failed_minibatches:
            return False
        self._execute_window(k_max)
        return True

    def _execute_window(self, k_max):
        s = self._structure
        seg1, seg2 = s["seg1"], s["seg2"]
        decision, loader = s["decision"], s["loader"]
        if seg1.pod is not None:
            # the pod's pre-dispatch site, once a window
            seg1.pod.pre_dispatch(seg1)
        with trace.span("segment", "window_serve"):
            loader.scan_window_step()
            cls = int(loader.minibatch_class)
            # end at the next metrics_every flush, where the per-step
            # route flushes
            budget = decision.scan_flush_budget(cls)
            if budget is not None:
                k_max = min(k_max, budget)
            train = cls == TRAIN and not bool(seg2.head.gate_skip)
            plan = self._plans[train]
            rows = [plan.fetch_scalars()]
            samples = int(loader.minibatch_size)
            closed = bool(loader.last_minibatch)
            while not closed and len(rows) < k_max \
                    and not loader.failed_minibatches:
                loader.scan_window_step()
                rows.append(plan.fetch_scalars())
                samples += int(loader.minibatch_size)
                closed = bool(loader.last_minibatch)
        k = len(rows)
        verdict = (closed and decision._validated(cls)
                   and decision.device_predicate() is not None
                   and decision.scan_verdict_ready(cls))
        program = self._program_for(train, k, verdict)
        entry, graph = program.entry, program.graph
        pod = seg1.pod
        entry.shards = pod.shards if pod is not None else 1
        with trace.span("segment", "dispatch", program.trace_args):
            preds = decision.predicate_scalars(cls, k, samples) \
                if verdict else None
            eager = program.device.type != "cuda" or program.runs == 0
            captures = graph.captures
            timer = prof.DispatchTimer(program.device)
            with cost.Tally() as tally, timer:
                accum, lasts, verd = program.execute(
                    rows, decision.scan_prior(cls), preds, timer)
            # one step's cost: the tally of the K steps over K
            step_cost = tally.cost(scale=k)
            moved = 0
            if pod is not None:
                # the stages counted their collectives as they ran
                for segment in (seg1, seg2) if train else (seg1,):
                    moved += k * pod.segment_collective_bytes(segment)
            if graph.captures != captures:
                record_compile(entry, step_cost, program.trace_args,
                               steady=captures > 0, logger=self)
            elif program.device.type != "cuda" and program.runs == 1:
                record_compile(entry, step_cost, program.trace_args)
            prof.ledger.record_dispatch(entry, timer, steps=k,
                                        cost=step_cost if eager else None,
                                        collective_bytes=moved)
            for vec in plan.out_vecs + plan.don_vecs:
                vec.devmem = vec.devmem     # the device copy is fresh
            for (unit, name), value in zip(plan.metric_spec, lasts):
                setattr(unit, name, value)
            decision.scan_commit(cls, accum, k, samples)
            if verd is not None:
                decision.scan_verdict = dict(
                    verd, cls=cls, epoch=int(loader.epoch_number), steps=k)
        seg1.absorb_pass(include_head=False)
        if train:
            seg2.absorb_pass(include_head=True)
        self.windows += 1
        self.steps += k
        if any(stage.health_spec is not None for stage in plan.stages):
            # the window landed its last step's stats: the window
            # boundary is strict mode's checkpoint
            watch_health.monitor.observe(steps=k, window=True)


def build_runner(workflow):
    """``Workflow.rebuild_stitching()``'s hook: a runner for the freshly
    stitched workflow (its ``eligible`` says whether windows can run,
    ``reason`` why not)."""
    return EpochScanRunner(workflow)


# -- the smoke ----------------------------------------------------------------

def run_smoke(module_name="veles_tpu_torch.samples.mnist", device=None):
    """A stitched sample under ``epoch_scan=auto`` must run windows and
    take at most one host dispatch (``segment/dispatch`` span) per
    class pass and window bound, with no recapture.  Returns an exit
    code (0: ok)."""
    import importlib
    import math
    import sys

    knobs = (("trace", "off"), ("stitch", "on"), ("epoch_scan", "off"))
    saved = {k: root.common.engine.get(k, d) for k, d in knobs}
    root.common.engine.trace = "on"
    root.common.engine.stitch = "on"
    root.common.engine.epoch_scan = "auto"
    try:
        sample = importlib.import_module(module_name)
        wf = sample.create_workflow(device=device, max_epochs=2,
                                    minibatch_size=500)
        before = sum(1 for e in trace.recorder.events()
                     if e[1:3] == ("segment", "dispatch"))
        wf.run()
        dispatches = sum(1 for e in trace.recorder.events()
                         if e[1:3] == ("segment", "dispatch")) - before
        runner = wf.epoch_runner
        if runner is None or not runner.eligible or not runner.windows:
            print("epoch smoke: FAIL - no window ran (%r)"
                  % (runner and runner.describe()), file=sys.stderr)
            return 1
        k = mode()
        loader = wf.loader
        epochs = int(loader.epoch_number) + 1
        budget = epochs * sum(
            math.ceil(math.ceil(n / loader.max_minibatch_size) / k)
            for n in loader.class_lengths if n)
        if dispatches > budget:
            print("epoch smoke: FAIL - %d host dispatches for %d "
                  "epoch(s) under K=%d (budget %d)"
                  % (dispatches, epochs, k, budget), file=sys.stderr)
            return 1
        report = runner.describe()
        recaptures = sum(g["recaptures"] for g in report["graphs"].values())
        if recaptures:
            print("epoch smoke: FAIL - %d window recapture(s)"
                  % recaptures, file=sys.stderr)
            return 1
        print("epoch smoke: OK - %d window(s) covering %d step(s), %d "
              "host dispatch(es) (budget %d), 0 recaptures"
              % (runner.windows, runner.steps, dispatches, budget))
        return 0
    finally:
        for key, value in saved.items():
            setattr(root.common.engine, key, value)
        trace.configure()


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.epoch_scan",
        description="The epoch-scan smoke: a stitched sample under "
        "engine.epoch_scan=auto.")
    parser.add_argument("--smoke", metavar="MODULE", nargs="?",
                        const="veles_tpu_torch.samples.mnist", default=None)
    parser.add_argument("--device", default=None,
                        help="cpu, or a cuda device (default: the card)")
    args = parser.parse_args(argv)
    if args.smoke:
        return run_smoke(args.smoke, device=args.device)
    parser.print_help()
    return 0


if __name__ == "__main__":  # pragma: no cover - thin CLI
    import sys
    sys.exit(main())
