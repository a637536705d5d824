"""Decision: epoch accounting, stop criteria and improvement tracking —
the port's counterpart of :mod:`veles_tpu.znicz.decision`, ported for
``DecisionGD`` (``DecisionMSE`` waits for ROADMAP item 1c).

``DecisionGD`` accumulates the evaluator's per-minibatch ``n_err`` per
class over an epoch, closes a class at its last minibatch (``n_err_pt``,
``improved`` when the validation error beats the best so far), and
raises ``complete`` at ``max_epochs`` or after ``fail_iterations``
epochs without improvement.  On the device path ``n_err`` is a device
scalar: the Decision keeps a running device sum per class and fetches
it ONCE, at the class end (one 8-byte device→host copy), instead of
every minibatch.  The sum is the Decision's own buffer, added to by
value: on the stitched route the evaluator's ``n_err`` is a graph's
static output, overwritten by the next replay.  The epoch-scan window
protocol and the ``engine.metrics_every`` mid-epoch flush cadence wait
for item 1c: ``initialize`` refuses a cadence above 0.
"""

import torch

from veles_tpu_torch.config import root
from veles_tpu_torch.loader.base import CLASS_NAME, TEST, TRAIN, VALID
from veles_tpu_torch.memory import Watcher
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit


def _is_host_number(value):
    return not isinstance(value, torch.Tensor)


class DecisionBase(Unit):
    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(DecisionBase, self).__init__(workflow, **kwargs)
        self.max_epochs = kwargs.get("max_epochs", None)
        self.fail_iterations = kwargs.get("fail_iterations", 100)
        self.complete = Bool(False)
        self.improved = Bool(False)
        # linked from the loader:
        self.minibatch_class = None
        self.minibatch_size = None
        self.last_minibatch = None
        self.epoch_ended = None
        self.epoch_number = None
        self.class_lengths = None
        self.demand("minibatch_class", "minibatch_size", "last_minibatch",
                    "epoch_ended", "epoch_number", "class_lengths")

    def initialize(self, **kwargs):
        every = int(root.common.engine.get("metrics_every", 0) or 0)
        if every > 0:
            raise NotImplementedError(
                "engine.metrics_every=%d (a metric flush every %d "
                "minibatches) is not ported yet (ROADMAP item 1c)"
                % (every, every))
        super(DecisionBase, self).initialize(**kwargs)

    def init_unpickled(self):
        super(DecisionBase, self).init_unpickled()
        #: per class, the running device sum of the metric since the
        #: last fetch (None: nothing pending)
        self._pending_ = [None, None, None]

    def _accumulate_metric(self, sums, cls, value):
        """Add a minibatch's metric: a host number at once, a device
        scalar into the class's running device sum."""
        if _is_host_number(value):
            sums[cls] += float(value)
            return
        pending = self._pending_[cls]
        if pending is None:
            self._pending_[cls] = value.clone()
        else:
            pending.add_(value)

    def _flush_metrics(self, sums, cls):
        """Fetch the class's running device sum (one copy) into
        ``sums``."""
        pending, self._pending_[cls] = self._pending_[cls], None
        if pending is None:
            return
        sums[cls] += float(pending.item())
        Watcher.track_d2h(pending.element_size())

    def link_from_loader(self, loader):
        self.link_attrs(
            loader, "minibatch_class", "minibatch_size", "last_minibatch",
            "epoch_ended", "epoch_number", "class_lengths")
        return self


class DecisionGD(DecisionBase):
    """Classification decision driven by ``EvaluatorSoftmax.n_err``."""

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
        self._epochs_without_improvement = 0
        self.demand("evaluator")

    def run(self):
        cls = int(self.minibatch_class)
        self._accumulate_metric(self.epoch_n_err, cls, self.evaluator.n_err)
        self.epoch_samples[cls] += int(self.minibatch_size)
        if not bool(self.last_minibatch):
            return
        self._flush_metrics(self.epoch_n_err, cls)
        self._close_class(cls, check_epoch_end=bool(self.epoch_ended))

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
        validated = cls == VALID or (cls == TRAIN and
                                     self.class_lengths[VALID] == 0)
        if validated:
            err_pt = self.epoch_n_err_pt[cls]
            if err_pt < self.best_n_err_pt:
                self.best_n_err_pt = err_pt
                self.best_epoch = int(self.epoch_number)
                self.improved <<= True
                self._epochs_without_improvement = 0
            else:
                self.improved <<= False
                self._epochs_without_improvement += 1
        if check_epoch_end:
            self._on_epoch_ended()
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
