"""Rollback: return to the best state when training plateaus.  The
port's counterpart of :mod:`veles_tpu.znicz.rollback`.

At every epoch close the unit reads the Decision: an improved
validation captures a host copy of the model state; a plateau of
``fail_iterations`` epochs restores it and multiplies every learning
rate by ``lr_factor``, in both execution modes:

- eager: the forwards' weight and bias Vectors are copied and restored,
  and the GD units' ``learning_rate`` (and bias rate) rescaled, with
  the LRAdjuster's base rates, so a schedule keeps working;
- fused: the :class:`~veles_tpu_torch.znicz.fused_unit.FusedTrainer`'s
  whole solver state (weights, momenta, Adam moments, rprop steps,
  schedule ticks) is captured by ``capture_state`` and restored by
  ``rollback_to``, which rescales the learning rates and rebuilds the
  step (one counted capture a rollback on the card).
"""

import numpy

from veles_tpu_torch.units import Unit


class Rollback(Unit):
    """Best-state keeper and plateau restorer (see the module)."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self.fail_iterations = int(kwargs.pop("fail_iterations", 5))
        self.lr_factor = float(kwargs.pop("lr_factor", 0.5))
        super(Rollback, self).__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.decision = None
        self.forwards = []
        self.gds = []
        self.trainer = None           # fused mode
        self.lr_adjuster = None
        self.rollbacks = 0            # times triggered
        self._best = None
        self._fails = 0
        self._captured_epoch = -1
        self.demand("decision")

    def run(self):
        d = self.decision
        best = int(getattr(d, "best_epoch", -1))
        if best == int(d.epoch_number) and best != self._captured_epoch:
            # the validation close just declared a new best: capture now,
            # while the weights are the ones it evaluated (a later train
            # pass would change them)
            self._best = self._capture()
            self._captured_epoch = best
            self._fails = 0
            return
        if not bool(d.epoch_ended):
            return
        if best == int(d.epoch_number):
            self._fails = 0
            return
        self._fails += 1
        if self._best is not None and self._fails >= self.fail_iterations:
            self.warning(
                "plateau of %d epochs: rolling back to the epoch-%d "
                "best and scaling learning rates by %g",
                self._fails, best, self.lr_factor)
            self._restore()
            self.rollbacks += 1
            self._fails = 0

    # -- capture / restore --------------------------------------------------
    def _capture(self):
        if self.trainer is not None:
            snap = self.trainer.capture_state()
            if snap is not None:
                return ("fused", snap)
        snap = []
        for fwd in self.forwards:
            entry = {}
            if fwd.weights:
                fwd.weights.map_read()
                entry["weights"] = numpy.array(fwd.weights.mem)
            if fwd.bias:
                fwd.bias.map_read()
                entry["bias"] = numpy.array(fwd.bias.mem)
            snap.append(entry)
        return ("eager", snap)

    def _restore(self):
        kind, snap = self._best
        if kind == "fused":
            self.trainer.rollback_to(snap, lr_factor=self.lr_factor)
            return
        for fwd, entry in zip(self.forwards, snap):
            if "weights" in entry and fwd.weights:
                fwd.weights.map_write()
                fwd.weights.mem[...] = entry["weights"]
            if "bias" in entry and fwd.bias:
                fwd.bias.map_write()
                fwd.bias.mem[...] = entry["bias"]
        for gd in self.gds:
            gd.learning_rate = float(gd.learning_rate) * self.lr_factor
            gd.learning_rate_bias = \
                float(gd.learning_rate_bias) * self.lr_factor
        adj = self.lr_adjuster
        if adj is not None and adj._base is not None:
            adj._base = [(lr * self.lr_factor, lr_b * self.lr_factor)
                         for lr, lr_b in adj._base]
