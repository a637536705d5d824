"""Gradient-descent backward units for fully-connected layers: the
port's counterpart of :mod:`veles_tpu.znicz.gd`.

For ``y = act(x·W + b)`` and the incoming ``err_output = ∂L/∂y``::

    δ = err_output ⊙ act'(y)          (act' from the OUTPUT, Znicz style)
    ∂L/∂W = xᵀ·δ / B ;  ∂L/∂b = Σδ / B ;  err_input = δ·Wᵀ

``cuda_run`` is one call of :func:`veles_tpu_torch.ops.gemm.gd_fused`:
on the card the dx, dw and db kernels, in that order, updating the
weights, the bias and their momenta in place (the JAX package donates
them); on CPU tensors the plain version.  The stitched stage and the health statistics wait for ROADMAP
item 1b.
"""

import numpy

from veles_tpu_torch.ops.gemm import gd_fused
from veles_tpu_torch.znicz.nn_units import GradientDescentBase

class GradientDescent(GradientDescentBase):
    """Backward for plain All2All (identity activation)."""

    MAPPING = "gd"
    ACTIVATION = None

    def initialize(self, device=None, **kwargs):
        super(GradientDescent, self).initialize(device=device, **kwargs)
        if self.need_err_input and not self.err_input:
            self.err_input.reset(numpy.zeros(self.input.shape,
                                             dtype=numpy.float32))
            self.err_input.initialize(self.device)

    def cuda_run(self):
        has_bias = bool(self.include_bias and self.bias)
        w, vw = self.weights.devmem, self.gradient_weights.devmem
        b = self.bias.devmem if has_bias else None
        vb = self.gradient_bias.devmem if has_bias else None
        _w, _b, _vw, _vb, err_input = gd_fused(
            self.input.devmem, self.output.devmem, self.err_output.devmem,
            w, b, vw, vb,
            self.learning_rate, self.learning_rate_bias,
            self.weights_decay, self.weights_decay_bias,
            self.gradient_moment, self.gradient_moment_bias,
            activation=self.ACTIVATION,
            need_err_input=self.need_err_input, has_bias=has_bias,
            transposed=self.weights_transposed)
        # updated in place: publish, so the host copies read as stale
        self.weights.devmem = w
        self.gradient_weights.devmem = vw
        if has_bias:
            self.bias.devmem = b
            self.gradient_bias.devmem = vb
        if self.need_err_input:
            self.err_input.devmem = err_input.reshape(self.input.shape)


class GDTanh(GradientDescent):
    MAPPING = "gd_tanh"
    ACTIVATION = "tanh"


class GDSigmoid(GradientDescent):
    MAPPING = "gd_sigmoid"
    ACTIVATION = "sigmoid"


class GDRELU(GradientDescent):
    MAPPING = "gd_relu"
    ACTIVATION = "relu"


class GDStrictRELU(GradientDescent):
    MAPPING = "gd_strict_relu"
    ACTIVATION = "strict_relu"


class GDSoftmax(GradientDescent):
    """Softmax + cross-entropy: the evaluator already emits δ = (softmax
    − target), so the activation derivative is the identity."""

    MAPPING = "gd_softmax"
    ACTIVATION = None
