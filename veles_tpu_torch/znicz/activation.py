"""Standalone activation units: the port's counterpart of
:mod:`veles_tpu.znicz.activation`.

Znicz's ``activation.Forward/Backward{Tanh, Sigmoid, RELU, StrictRELU,
Log, TanhLog, SinCos, Mul}``: one elementwise ``pure_fn`` each, in the
JAX unit's formula, and the VJP backward
(:class:`~veles_tpu_torch.znicz.gd_base.GDViaVJP`).
"""

import numpy
import torch

from veles_tpu_torch.znicz.gd_base import GDViaVJP
from veles_tpu_torch.znicz.nn_units import PureForward


def _tanh(x):
    return 1.7159 * torch.tanh(0.6666 * x)


def _tanhlog(x):
    t = _tanh(x)
    return torch.where(torch.abs(t) <= 1.7159 * 0.6666, t,
                       torch.sign(x) * torch.log(
                           torch.abs(x * 0.6666 * 1.7159) + 1.0))


def _sincos(x):
    odd = (torch.arange(x.shape[-1], device=x.device) % 2) == 1
    return torch.where(odd[None, :], torch.sin(x), torch.cos(x))


_FUNCS = {
    "tanh": lambda x, k: _tanh(x),
    "sigmoid": lambda x, k: torch.sigmoid(x),
    "relu": lambda x, k: torch.log1p(torch.exp(torch.clamp(x, max=30.0))),
    "strict_relu": lambda x, k: torch.clamp(x, min=0.0),
    "log": lambda x, k: torch.log(x + torch.sqrt(x * x + 1.0)),
    "tanhlog": lambda x, k: _tanhlog(x),
    "sincos": lambda x, k: _sincos(x),
    "mul": lambda x, k: x * k,
}


class ActivationForward(PureForward):
    hide_from_registry = True
    FUNC = None

    def __init__(self, workflow, **kwargs):
        super(ActivationForward, self).__init__(workflow, **kwargs)
        self.include_bias = False
        self.k = kwargs.get("k", 1.0)

    def pure_config(self):
        return {"func": self.FUNC, "k": self.k}

    @staticmethod
    def pure_fn(params, x, func=None, k=1.0):
        del params
        return _FUNCS[func](x, k).to(x.dtype)

    def initialize(self, device=None, **kwargs):
        super(ActivationForward, self).initialize(device=device, **kwargs)
        self.output.reset(numpy.zeros(self.input.shape, numpy.float32))
        self.init_vectors(self.output)


class ForwardTanh(ActivationForward):
    MAPPING = "activation_tanh"
    FUNC = "tanh"


class ForwardSigmoid(ActivationForward):
    MAPPING = "activation_sigmoid"
    FUNC = "sigmoid"


class ForwardRELU(ActivationForward):
    MAPPING = "activation_relu"
    FUNC = "relu"


class ForwardStrictRELU(ActivationForward):
    MAPPING = "activation_strict_relu"
    MAPPING_ALIASES = ("activation_str",)
    FUNC = "strict_relu"


class ForwardLog(ActivationForward):
    MAPPING = "activation_log"
    FUNC = "log"


class ForwardTanhLog(ActivationForward):
    MAPPING = "activation_tanhlog"
    FUNC = "tanhlog"


class ForwardSinCos(ActivationForward):
    MAPPING = "activation_sincos"
    FUNC = "sincos"


class ForwardMul(ActivationForward):
    MAPPING = "activation_mul"
    FUNC = "mul"


class BackwardActivation(GDViaVJP):
    MAPPING = "gd_activation"
