"""Decision: epoch accounting, stop criteria and improvement tracking —
the port's counterpart of :mod:`veles_tpu.znicz.decision`
(``DecisionGD`` and ``DecisionMSE``).

A Decision accumulates its evaluator's per-minibatch metric per class
over an epoch (``DecisionGD``: ``n_err``; ``DecisionMSE``: ``mse``),
closes a class at its last minibatch (``improved`` when the validation
metric beats the best so far), and raises ``complete`` at
``max_epochs`` or after ``fail_iterations`` epochs without
improvement.  On the device path the metric is a device scalar: the
Decision keeps ONE running device sum per class (``_pending_``; the
JAX package keeps a list) and fetches it once, at the class end (one
device→host copy), or every ``engine.metrics_every`` steps when that
cadence is set.  The sum is the Decision's own buffer, added to by
value: on the stitched route the evaluator's metric is a graph's
static output, overwritten by the next replay.

The epoch-scan window protocol (:mod:`veles_tpu_torch.epoch_scan`):
a window of K steps computes ``accum = prior + Σ step metrics`` on the
device, where :meth:`DecisionBase.scan_prior` is the running sum (or
None); :meth:`DecisionBase.scan_commit` makes that accumulator the
running sum and counts the window's steps and samples, and the next
``run()`` (the window's last step) skips its own accumulation.  On a
class-closing validated window the Decision's
:meth:`~DecisionBase.device_predicate` (plain torch ops on 0-d
tensors) computes ``improved`` and ``stop`` in the window's graph,
from :meth:`~DecisionBase.predicate_scalars`; the host close stays
authoritative.

Every class close runs :meth:`DecisionBase._publish_close`: with
``engine.health`` armed, one fetch of the health snapshot (the close is
already a host sync point; strict mode's verdict applies there), and
with a telemetry bus an ``epoch`` event and the ``health`` event.

An improving validated close sets ``snapshot_suffix`` (the snapshot's
name, :mod:`veles_tpu_torch.snapshotter`).  ``checkpoint_state()``
carries ``CHECKPOINT_ATTRS`` with ``complete`` and ``improved`` for
``Workflow.capture_train_state``.  The pending device sums and the last
window's device verdict are transient.

The job contract (:mod:`veles_tpu_torch.parallel.jobs`): a slave's
``DecisionGD`` sends the job's class, error count and size
(``generate_data_for_master``); the master's adds them up and closes
a class when its sample budget (``effective_class_length``) is served,
whatever order the updates arrive in, and a validated close ends the
master's epoch.
"""

import numpy
import torch

from veles_tpu_torch.config import root
from veles_tpu_torch.loader.base import CLASS_NAME, TEST, TRAIN, VALID
from veles_tpu_torch.memory import Watcher
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit


def _is_host_number(value):
    return not isinstance(value, torch.Tensor)


def metrics_every():
    """The ``engine.metrics_every`` cadence (0: one fetch a class end)."""
    return int(root.common.engine.get("metrics_every", 0) or 0)


class DecisionBase(Unit):
    hide_from_registry = True

    #: the evaluator metric a window sums into its accumulator (None: a
    #: Decision without the window protocol keeps per-step dispatch)
    SCAN_METRIC = None

    def __init__(self, workflow, **kwargs):
        super(DecisionBase, self).__init__(workflow, **kwargs)
        self.max_epochs = kwargs.get("max_epochs", None)
        self.fail_iterations = kwargs.get("fail_iterations", 100)
        self.complete = Bool(False)
        self.improved = Bool(False)
        self.snapshot_suffix = ""
        self._epochs_without_improvement = 0
        # linked from the loader:
        self.minibatch_class = None
        self.minibatch_size = None
        self.last_minibatch = None
        self.epoch_ended = None
        self.epoch_number = None
        self.class_lengths = None
        self.demand("minibatch_class", "minibatch_size", "last_minibatch",
                    "epoch_ended", "epoch_number", "class_lengths")

    def init_unpickled(self):
        super(DecisionBase, self).init_unpickled()
        #: per class, the running device sum of the metric since the
        #: last fetch (None: nothing pending)
        self._pending_ = [None, None, None]
        #: per class, the steps that sum stands for (the metrics_every
        #: cadence counts steps; a window commits K at once)
        self._pending_steps_ = [0, 0, 0]
        #: per class, the window accumulator last committed: it is a
        #: graph's output, so a per-step add never writes into it
        self._scan_accums_ = [None, None, None]
        self._scan_absorbed_ = False
        #: the last class-closing validated window's device verdict:
        #: {"improved", "stop"} 0-d device booleans, "cls", "epoch",
        #: "steps"; the host close stays authoritative
        self.scan_verdict_ = None

    @property
    def scan_verdict(self):
        return self.scan_verdict_

    @scan_verdict.setter
    def scan_verdict(self, value):
        self.scan_verdict_ = value

    # -- deferred metric accounting -----------------------------------------
    def _accumulate_metric(self, sums, cls, value):
        """Add a minibatch's metric: a host number at once, a device
        scalar into the class's running device sum, fetched when the
        ``metrics_every`` cadence comes due."""
        if _is_host_number(value):
            sums[cls] += float(value)
            return
        pending = self._pending_[cls]
        if pending is None:
            self._pending_[cls] = value.clone()
        elif pending is self._scan_accums_[cls]:
            self._pending_[cls] = pending + value
        else:
            pending.add_(value)
        self._pending_steps_[cls] += 1
        every = metrics_every()
        if every > 0 and self._pending_steps_[cls] >= every:
            self._flush_metrics(sums, cls)

    def _flush_metrics(self, sums, cls):
        """Fetch the class's running device sum (one copy) into
        ``sums``."""
        pending, self._pending_[cls] = self._pending_[cls], None
        self._pending_steps_[cls] = 0
        if pending is None:
            return
        sums[cls] += float(pending.item())
        Watcher.track_d2h(pending.element_size())

    # -- the epoch-scan window protocol (veles_tpu_torch.epoch_scan) --------
    @property
    def scan_compatible(self):
        """True when a window may absorb this Decision's per-step work:
        a ``SCAN_METRIC`` and a ``run()`` marked ``scan_protocol`` (a
        subclass that overrides ``run()`` loses the mark)."""
        return self.SCAN_METRIC is not None and getattr(
            type(self).run, "scan_protocol", False)

    def scan_prior(self, cls):
        """The running device sum a window starts from, or None (the
        window starts from 0)."""
        return self._pending_[cls]

    def scan_commit(self, cls, accum, steps, samples):
        """Install a window's accounting: ``accum`` (which folds the
        prior in) becomes the running sum, the counters advance by the
        whole window, and the ``metrics_every`` cadence sees all
        ``steps`` at once.  Marks the pass absorbed, so the next
        ``run()`` does not count the window's last step again."""
        self._pending_[cls] = accum
        self._scan_accums_[cls] = accum
        self._pending_steps_[cls] += int(steps)
        self._scan_bump(cls, int(steps), int(samples))
        self._scan_absorbed_ = True
        every = metrics_every()
        if every > 0 and self._pending_steps_[cls] >= every:
            self._flush_metrics(self._scan_sums(), cls)

    def _consume_scan_window_(self):
        absorbed, self._scan_absorbed_ = self._scan_absorbed_, False
        return absorbed

    def scan_flush_budget(self, cls):
        """Steps until the next ``metrics_every`` flush of ``cls``
        (None: no cadence).  A window ends there, so the flush lands on
        the step the per-step route flushes at."""
        every = metrics_every()
        if every <= 0:
            return None
        return max(1, every - self._pending_steps_[cls] % every)

    def scan_reset(self):
        """Forget a half-consumed window pass (an interrupted run left
        the absorb mark): ``Workflow.run()`` calls it before each drain,
        through the runner's ``reset_pass``."""
        self._scan_absorbed_ = False

    def _scan_bump(self, cls, steps, samples):
        """Advance the per-class counters for an absorbed window."""
        raise NotImplementedError

    def _scan_sums(self):
        """The per-class host sums :meth:`scan_commit` flushes into."""
        raise NotImplementedError

    def device_predicate(self):
        """``fn(accum, scalars) -> {"improved", "stop"}`` over 0-d
        tensors, run in a class-closing validated window's graph, or
        None (no verdict).  ``accum`` is the window's accumulator (the
        running sum since the last flush); ``scalars`` hold
        :meth:`predicate_scalars`, with the already flushed host partial
        sum as ``flushed``."""
        return None

    def predicate_scalars(self, cls, steps, samples):
        """Host numbers the device predicate reads, taken fresh for
        each class-closing window."""
        return {}

    def _stop_predicate(self, improved, s):
        """The device twin of the epoch-end stop rule, shared by the
        Decision families: stop when not improved with the failure
        streak exhausted, or at ``max_epochs``."""
        return torch.logical_or(
            torch.logical_and(torch.logical_not(improved),
                              s["ewi"] + 1.0 >= s["fail"]),
            s["epoch"] + 1.0 >= s["max_epochs"])

    def _stop_predicate_scalars(self):
        return {
            "ewi": float(self._epochs_without_improvement),
            "fail": float(self.fail_iterations),
            "epoch": float(self.epoch_number or 0),
            "max_epochs": float(self.max_epochs)
            if self.max_epochs is not None else float("inf"),
        }

    def scan_verdict_ready(self, cls):
        """True when the window's accumulator with ``flushed`` covers
        the whole epoch of ``cls``.  The JAX package keeps per-step
        entries beside its accumulator, which a window cannot fold; the
        port's window starts from the whole running sum, so the verdict
        is always complete."""
        return True

    def _publish_close(self, cls, metrics):
        """The telemetry hook of every class close: the health snapshot
        when the monitor is armed (strict raises on a bad leaf here),
        then the ``health`` and ``epoch`` events when a bus is live.
        Disarmed and without a bus: two attribute checks."""
        from veles_tpu_torch import watch
        snap = watch.monitor.maybe_snapshot()
        if not watch.enabled():
            return
        if snap is not None:
            watch.publish("health", snap)
        watch.publish("epoch", dict(
            metrics, cls=CLASS_NAME[cls], epoch=int(self.epoch_number),
            improved=bool(self.improved), complete=bool(self.complete)))

    def link_from_loader(self, loader):
        self.link_attrs(
            loader, "minibatch_class", "minibatch_size", "last_minibatch",
            "epoch_ended", "epoch_number", "class_lengths",
            "effective_class_end_offsets")
        return self

    def effective_class_length(self, cls):
        """The samples of ``cls`` served an epoch (less than
        ``class_lengths`` under a ``train_ratio``)."""
        offsets = getattr(self, "effective_class_end_offsets", None)
        if offsets is None:
            return self.class_lengths[cls]
        start = offsets[cls - 1] if cls > 0 else 0
        return offsets[cls] - start

    def _validated(self, cls):
        return cls == VALID or (cls == TRAIN and
                                self.class_lengths[VALID] == 0)

    # -- the train-state checkpoint ------------------------------------------
    #: plain attributes saved and restored as they are; subclasses extend
    CHECKPOINT_ATTRS = ("snapshot_suffix", "_epochs_without_improvement")

    def checkpoint_state(self):
        """The stop criteria's accounting: without it a resumed run
        would forget its best epoch and its streak without improvement
        and stop at another epoch."""
        state = {name: getattr(self, name)
                 for name in self.CHECKPOINT_ATTRS if hasattr(self, name)}
        state["complete"] = bool(self.complete)
        state["improved"] = bool(self.improved)
        return state

    def restore_checkpoint_state(self, state):
        for name in self.CHECKPOINT_ATTRS:
            if name not in state:
                continue
            value = state[name]
            current = getattr(self, name, None)
            if isinstance(current, list) and \
                    isinstance(value, (list, tuple)):
                value = list(value)
            setattr(self, name, value)
        if "complete" in state:
            self.complete <<= bool(state["complete"])
        if "improved" in state:
            self.improved <<= bool(state["improved"])


class DecisionGD(DecisionBase):
    """Classification decision driven by ``EvaluatorSoftmax.n_err``."""

    SCAN_METRIC = "n_err"

    CHECKPOINT_ATTRS = DecisionBase.CHECKPOINT_ATTRS + (
        "epoch_n_err", "epoch_samples", "epoch_n_err_pt",
        "best_n_err_pt", "best_epoch")

    def __init__(self, workflow, **kwargs):
        super(DecisionGD, self).__init__(workflow, **kwargs)
        self.evaluator = None            # linked: reads n_err per batch
        self.epoch_n_err = [0, 0, 0]     # per class, current epoch
        self.epoch_samples = [0, 0, 0]
        self.epoch_n_err_pt = [100.0, 100.0, 100.0]   # percent, last full
        self.best_n_err_pt = 100.0
        self.best_epoch = -1
        #: one entry per class close: {"epoch", "cls", "n_err",
        #: "samples", "n_err_pt"}
        self.history = []
        self.demand("evaluator")

    def run(self):
        cls = int(self.minibatch_class)
        if not self._consume_scan_window_():
            # an absorbed pass: the window's commit counted every step
            self._accumulate_metric(self.epoch_n_err, cls,
                                    self.evaluator.n_err)
            self.epoch_samples[cls] += int(self.minibatch_size)
        if not bool(self.last_minibatch):
            return
        self._flush_metrics(self.epoch_n_err, cls)
        self._close_class(cls, check_epoch_end=bool(self.epoch_ended))

    # -- the window protocol ----------------------------------------------
    def _scan_bump(self, cls, steps, samples):
        self.epoch_samples[cls] += samples

    def _scan_sums(self):
        return self.epoch_n_err

    def device_predicate(self):
        """The device twin of a validated close: the epoch's error
        (the accumulator plus the flushed host partial sum) against the
        best so far, and the shared stop rule."""
        stop = self._stop_predicate

        def fn(accum, s):
            err_pt = 100.0 * (accum + s["flushed"]) \
                / torch.clamp(s["samples"], min=1.0)
            improved = err_pt < s["best"]
            return {"improved": improved, "stop": stop(improved, s)}
        return fn

    def predicate_scalars(self, cls, steps, samples):
        return dict(
            self._stop_predicate_scalars(),
            samples=float(self.epoch_samples[cls] + samples),
            flushed=float(self.epoch_n_err[cls]),
            best=float(self.best_n_err_pt))

    def _close_class(self, cls, check_epoch_end):
        if self.epoch_samples[cls]:
            self.epoch_n_err_pt[cls] = \
                100.0 * self.epoch_n_err[cls] / self.epoch_samples[cls]
        self.info("epoch %d %s error: %.2f%% (%d/%d)",
                  int(self.epoch_number), CLASS_NAME[cls],
                  self.epoch_n_err_pt[cls], int(self.epoch_n_err[cls]),
                  self.epoch_samples[cls])
        self.history.append({
            "epoch": int(self.epoch_number), "cls": CLASS_NAME[cls],
            "n_err": int(self.epoch_n_err[cls]),
            "samples": int(self.epoch_samples[cls]),
            "n_err_pt": float(self.epoch_n_err_pt[cls])})
        if self._validated(cls):
            err_pt = self.epoch_n_err_pt[cls]
            if err_pt < self.best_n_err_pt:
                self.best_n_err_pt = err_pt
                self.best_epoch = int(self.epoch_number)
                self.improved <<= True
                self.snapshot_suffix = "%.2fpt" % err_pt
                self._epochs_without_improvement = 0
            else:
                self.improved <<= False
                self._epochs_without_improvement += 1
        # a master closes classes from its slaves' updates: its epoch
        # ends at the validated close
        if check_epoch_end or (self._validated(cls) and self.is_master):
            self._on_epoch_ended()
        self._publish_close(cls, {
            "n_err_pt": float(self.epoch_n_err_pt[cls]),
            "n_err": float(self.epoch_n_err[cls]),
            "samples": int(self.epoch_samples[cls]),
            "best_n_err_pt": float(self.best_n_err_pt),
            "best_epoch": int(self.best_epoch)})
        self.epoch_n_err[cls] = 0
        self.epoch_samples[cls] = 0

    def _on_epoch_ended(self):
        if self.max_epochs is not None and \
                int(self.epoch_number) + 1 >= self.max_epochs:
            self.info("max epochs (%d) reached", self.max_epochs)
            self.complete <<= True
        if self._epochs_without_improvement >= self.fail_iterations:
            self.info("no improvement in %d epochs — stopping",
                      self._epochs_without_improvement)
            self.complete <<= True

    def get_metric_values(self):
        return {
            "best_validation_error_pt": self.best_n_err_pt,
            "best_epoch": self.best_epoch,
            "errors_pt": {CLASS_NAME[i]: self.epoch_n_err_pt[i]
                          for i in (TEST, VALID, TRAIN)},
        }

    # -- the job contract -----------------------------------------------------
    def generate_data_for_master(self):
        """Slave: the job's class, error count and size."""
        n_err = self.evaluator.n_err
        if not _is_host_number(n_err):
            Watcher.track_d2h(n_err.element_size())
            n_err = n_err.item()
        return {"cls": int(self.minibatch_class), "n_err": float(n_err),
                "size": int(self.minibatch_size)}

    def apply_data_from_slave(self, data, slave=None):
        """Master: add a job's counts; a class closes when its sample
        budget is reached, whatever order the updates come in."""
        if not data:
            return
        cls = data["cls"]
        self.epoch_n_err[cls] += data["n_err"]
        self.epoch_samples[cls] += data["size"]
        length = self.effective_class_length(cls)
        if length and self.epoch_samples[cls] >= length:
            self._close_class(cls, check_epoch_end=False)


class DecisionMSE(DecisionBase):
    """Regression decision driven by ``EvaluatorMSE.mse``: a class's
    epoch metric is the mean of its minibatches' metric (the rmse with
    the evaluator's default ``root``)."""

    SCAN_METRIC = "mse"

    CHECKPOINT_ATTRS = DecisionBase.CHECKPOINT_ATTRS + (
        "epoch_sum_mse", "epoch_batches", "epoch_mse", "best_mse",
        "best_epoch")

    def __init__(self, workflow, **kwargs):
        super(DecisionMSE, self).__init__(workflow, **kwargs)
        self.evaluator = None
        self.epoch_sum_mse = [0.0, 0.0, 0.0]
        self.epoch_batches = [0, 0, 0]
        self.epoch_mse = [numpy.inf, numpy.inf, numpy.inf]
        self.best_mse = numpy.inf
        self.best_epoch = -1
        #: one entry per class close: {"epoch", "cls", "mse", "batches"}
        self.history = []
        self.demand("evaluator")

    def run(self):
        cls = int(self.minibatch_class)
        if not self._consume_scan_window_():
            self._accumulate_metric(self.epoch_sum_mse, cls,
                                    self.evaluator.mse)
            self.epoch_batches[cls] += 1
        if not bool(self.last_minibatch):
            return
        self._flush_metrics(self.epoch_sum_mse, cls)
        self._close_class(cls, check_epoch_end=bool(self.epoch_ended))

    def _close_class(self, cls, check_epoch_end):
        if self.epoch_batches[cls]:
            self.epoch_mse[cls] = \
                self.epoch_sum_mse[cls] / self.epoch_batches[cls]
        self.info("epoch %d %s rmse: %.4f", int(self.epoch_number),
                  CLASS_NAME[cls], self.epoch_mse[cls])
        self.history.append({
            "epoch": int(self.epoch_number), "cls": CLASS_NAME[cls],
            "mse": float(self.epoch_mse[cls]),
            "batches": int(self.epoch_batches[cls])})
        if self._validated(cls):
            if self.epoch_mse[cls] < self.best_mse:
                self.best_mse = self.epoch_mse[cls]
                self.best_epoch = int(self.epoch_number)
                self.improved <<= True
                self.snapshot_suffix = "%.4frmse" % self.best_mse
                self._epochs_without_improvement = 0
            else:
                self.improved <<= False
                self._epochs_without_improvement += 1
        if check_epoch_end:
            if self.max_epochs is not None and \
                    int(self.epoch_number) + 1 >= self.max_epochs:
                self.complete <<= True
            if self._epochs_without_improvement >= self.fail_iterations:
                self.complete <<= True
        self._publish_close(cls, {
            "mse": float(self.epoch_mse[cls]),
            "batches": int(self.epoch_batches[cls]),
            "best_mse": float(self.best_mse),
            "best_epoch": int(self.best_epoch)})
        self.epoch_sum_mse[cls] = 0.0
        self.epoch_batches[cls] = 0

    # -- the window protocol ----------------------------------------------
    def _scan_bump(self, cls, steps, samples):
        self.epoch_batches[cls] += steps

    def _scan_sums(self):
        return self.epoch_sum_mse

    def device_predicate(self):
        stop = self._stop_predicate

        def fn(accum, s):
            mse = (accum + s["flushed"]) / torch.clamp(s["batches"],
                                                       min=1.0)
            improved = mse < s["best"]
            return {"improved": improved, "stop": stop(improved, s)}
        return fn

    def predicate_scalars(self, cls, steps, samples):
        return dict(
            self._stop_predicate_scalars(),
            batches=float(self.epoch_batches[cls] + steps),
            flushed=float(self.epoch_sum_mse[cls]),
            best=float(self.best_mse))

    def get_metric_values(self):
        return {"best_rmse": float(self.best_mse),
                "best_epoch": self.best_epoch}


#: the window protocol's marks: these run() bodies are the per-step
#: semantics scan_commit mirrors; a subclass that overrides run() loses
#: the mark until it opts in again
DecisionGD.run.scan_protocol = True
DecisionMSE.run.scan_protocol = True
