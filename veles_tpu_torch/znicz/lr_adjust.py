"""Learning-rate schedules: the port's counterpart of
:mod:`veles_tpu.znicz.lr_adjust`.

The five policies (``exp``, ``fixed``, ``step_exp``, ``inv``,
``arbitrary_step``) are each a ``factor(t)``, the multiplier of the
configured base learning rate after ``t`` train steps.  A policy takes
``t`` as a host int (the eager :class:`LearningRateAdjust` unit, which
rescales its gradient units' ``learning_rate`` and
``learning_rate_bias`` every TRAIN minibatch) or as an int32 tensor
(the fused step, :func:`veles_tpu_torch.znicz.fused_graph.lower_specs`,
which carries the tick in each layer's state and evaluates the schedule
on the device, so a CUDA graph of the step keeps it without a
recapture).  On an int it computes in numpy, as the JAX module does;
on a tensor in torch.

The port's GD stages read ``learning_rate`` at every dispatch, so an
eager schedule reaches the stitched graphs without a recapture.  The
epoch-scan windows refuse a workflow with the unit in its loop (the
unit hangs off the Decision).
"""

import numpy
import torch

from veles_tpu_torch.units import Unit


def _power(base, exponent):
    if isinstance(base, torch.Tensor) or isinstance(exponent, torch.Tensor):
        return torch.pow(base, exponent)
    return numpy.power(base, exponent)


class _Policy(object):
    def __call__(self, t):
        raise NotImplementedError


class FixedAdjustPolicy(_Policy):
    """factor = 1."""

    def __call__(self, t):
        return 1.0 + 0.0 * t


class ExpPolicy(_Policy):
    """factor = gamma^t."""

    def __init__(self, gamma=0.9999):
        self.gamma = float(gamma)

    def __call__(self, t):
        return _power(self.gamma, t)


class StepExpPolicy(_Policy):
    """factor = gamma^(t // step): staircase exponential decay."""

    def __init__(self, gamma=0.1, step=1000):
        self.gamma = float(gamma)
        self.step = int(step)

    def __call__(self, t):
        return _power(self.gamma, t // self.step)


class InvAdjustPolicy(_Policy):
    """factor = (1 + gamma·t)^(-power)."""

    def __init__(self, gamma=0.0001, power=0.75):
        self.gamma = float(gamma)
        self.power = float(power)

    def __call__(self, t):
        return _power(1.0 + self.gamma * t, -self.power)


class ArbitraryStepPolicy(_Policy):
    """Piecewise-constant multipliers: ``lrs_with_lengths`` = [(factor,
    n_steps), ...]; the last factor holds forever."""

    def __init__(self, lrs_with_lengths=((1.0, 1),)):
        pairs = [(float(f), int(n)) for f, n in lrs_with_lengths]
        if not pairs:
            raise ValueError("lrs_with_lengths must be non-empty")
        self.factors = numpy.array([f for f, _n in pairs], numpy.float32)
        self.bounds = numpy.cumsum([n for _f, n in pairs]).astype(
            numpy.int64)

    def __call__(self, t):
        last = len(self.factors) - 1
        if isinstance(t, torch.Tensor):
            bounds = torch.as_tensor(self.bounds, device=t.device)
            factors = torch.as_tensor(self.factors, device=t.device)
            idx = torch.searchsorted(bounds, t.to(torch.int64).reshape(1),
                                     right=True)
            return factors[torch.clamp(idx, max=last)].reshape(())
        idx = min(int(numpy.searchsorted(self.bounds, t, side="right")),
                  last)
        return self.factors[idx]


POLICIES = {
    "fixed": FixedAdjustPolicy,
    "exp": ExpPolicy,
    "step_exp": StepExpPolicy,
    "inv": InvAdjustPolicy,
    "arbitrary_step": ArbitraryStepPolicy,
}


def make_policy(name, params=None):
    """A policy by its documented name."""
    try:
        klass = POLICIES[name]
    except KeyError:
        raise ValueError("unknown lr policy %r (want one of %s)" % (
            name, ", ".join(sorted(POLICIES))))
    return klass(**dict(params or {}))


class LearningRateAdjust(Unit):
    """The eager LRAdjuster: linked before the gradient chain, it sets
    every GD unit's ``learning_rate`` and ``learning_rate_bias`` from
    their base values (captured at the first run) and the policies at
    each TRAIN minibatch.  The bias policy defaults to the weights'."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        name = kwargs.pop("lr_policy_name", "fixed")
        params = kwargs.pop("lr_parameters", None)
        self.lr_policy = make_policy(name, params)
        self.bias_lr_policy = make_policy(
            kwargs.pop("bias_lr_policy_name", name),
            kwargs.pop("bias_lr_parameters", params))
        super(LearningRateAdjust, self).__init__(workflow, **kwargs)
        self.gds = []
        self.t = 0
        self._base = None

    def run(self):
        if not self.gds:
            return
        if self._base is None:
            self._base = [(float(gd.learning_rate),
                           float(gd.learning_rate_bias))
                          for gd in self.gds]
        fw = float(self.lr_policy(self.t))
        fb = float(self.bias_lr_policy(self.t))
        for gd, (lr, lr_b) in zip(self.gds, self._base):
            gd.learning_rate = lr * fw
            gd.learning_rate_bias = lr_b * fb
        self.t += 1
