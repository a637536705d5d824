"""Fully-connected forward layers: the port's counterpart of
:mod:`veles_tpu.znicz.all2all`.

``output = activation(input·W + b)`` with Znicz's activations (scaled
tanh ``1.7159·tanh(0.6666x)``, smooth relu ``log(1+eˣ)``).  ``pure`` is
one call of :func:`veles_tpu_torch.ops.gemm.matmul`: the bias and the
activation ride the GEMM kernel's epilogue, and the input stays on the
device between layers; ``cuda_run`` and the stitched stage both call
it.  ``All2AllSoftmax`` runs the GEMM without an activation and leaves
the softmax and ``max_idx`` to plain torch, as the JAX package leaves
them to XLA: the eager unit takes ``max_idx`` from the logits, the
stitched stage from the softmax output, as the JAX package's do.  An
int8 weight (a :mod:`veles_tpu_torch.quant` ``{"q", "scale"}`` pair, in
(fan-in, neurons) storage whatever ``weights_transposed`` says, since
the deploy walk canonicalizes it) runs through
:func:`veles_tpu_torch.ops.qgemm.qmatmul` instead, with the unit's
activation in its epilogue and an f32 result.

The fused lowering (:func:`veles_tpu_torch.znicz.fused_graph.lower_specs`)
takes the JAX package's static form instead: :meth:`All2All.pure_config`
(``activation``, ``is_softmax``, ``transposed``) and
:meth:`All2All.pure_fn`, one call of the differentiable
:func:`~veles_tpu_torch.ops.gemm.matmul` a layer.  A product whose
operands differ in type (the softmax layer widens its input to f32
while a bf16 step hands it bf16 weights; an eval step over bf16-cast
integer data meets the f32 master weights) is computed in f32 over all
of them widened, as the JAX package promotes it, so autograd rounds that
layer's weight gradient back to the weights' type.
"""

import numpy
import torch

from veles_tpu_torch.ops import gemm, qgemm
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.znicz.nn_units import ForwardBase


class All2All(ForwardBase):
    """Linear fully-connected layer (activation = identity)."""

    MAPPING = "all2all"
    ACTIVATION = None

    def __init__(self, workflow, **kwargs):
        super(All2All, self).__init__(workflow, **kwargs)
        shape = kwargs.get("output_sample_shape", ())
        if isinstance(shape, int):
            shape = (shape,)
        self.output_sample_shape = tuple(shape)

    @property
    def neurons_number(self):
        return int(numpy.prod(self.output_sample_shape))

    def initialize(self, device=None, **kwargs):
        super(All2All, self).initialize(device=device, **kwargs)
        n_input = int(numpy.prod(self.input.shape[1:]))
        n_neurons = self.neurons_number
        if not self.weights:
            shape = (n_neurons, n_input) if self.weights_transposed \
                else (n_input, n_neurons)
            w = numpy.zeros(shape, dtype=numpy.float32)
            # the default scale is 1/sqrt of the TRUE fan-in, which is
            # shape[1] in transposed storage
            self.fill_array(w, self.weights_filling,
                            self.weights_stddev
                            or 1.0 / numpy.sqrt(max(n_input, 1)))
            self.weights.reset(w)
        if self.include_bias and not self.bias:
            b = numpy.zeros((n_neurons,), dtype=numpy.float32)
            self.fill_array(b, self.bias_filling, self.bias_stddev)
            self.bias.reset(b)
        batch = self.input.shape[0]
        self.output.reset(numpy.zeros(
            (batch,) + self.output_sample_shape, dtype=numpy.float32))
        self.init_vectors(self.weights, self.bias, self.output)

    def pure_config(self):
        """The static config of :meth:`pure_fn` for this layer."""
        return {"activation": self.ACTIVATION,
                "is_softmax": isinstance(self, All2AllSoftmax),
                "transposed": bool(self.weights_transposed)}

    @staticmethod
    def pure_fn(params, x, activation=None, is_softmax=False,
                transposed=False):
        """The fused lowering's form of the layer: ``{"w", "b"}`` and
        the input to the output, differentiable through the GEMM
        kernel; the softmax layer widens its input to f32 first (a bf16
        round trip of the logits would flip near-tie argmaxes) and
        returns the probabilities in the input's type."""
        h = x.reshape(x.shape[0], -1)
        w = params["w"]
        b = params.get("b")
        if transposed:
            w = w.t()
        if is_softmax:
            h = h.float()
        if h.dtype != w.dtype or (b is not None and b.dtype != h.dtype):
            h, w = h.float(), w.float()
            b = None if b is None else b.float()
        if is_softmax:
            return _softmax(gemm.matmul(h, w, b, None)).to(x.dtype)
        return gemm.matmul(h, w, b, activation).to(x.dtype)

    def _gemm(self, params, x, activation):
        """One GEMM kernel call (a transposed storage is read through
        its strides, not copied), or one qmatmul call for an int8
        weight."""
        h = x.reshape(x.shape[0], -1)
        w = params["w"]
        if isinstance(w, dict):
            return qgemm.qmatmul(h, w["q"], w["scale"].reshape(-1),
                                 params.get("b"), activation,
                                 out_dtype=torch.float32).to(x.dtype)
        if self.weights_transposed:
            w = w.t()
        return gemm.matmul(h, w, params.get("b"), activation)

    def pure(self, params, x):
        return self._gemm(params, x, self.ACTIVATION)

    def cuda_run(self):
        out = self.pure(self.pure_params(), self.input.devmem)
        self.output.devmem = out.reshape(
            (out.shape[0],) + self.output_sample_shape)


class All2AllTanh(All2All):
    """Scaled tanh: 1.7159·tanh(0.6666·x)."""

    MAPPING = "all2all_tanh"
    ACTIVATION = "tanh"
    A = 1.7159
    B = 0.6666


class All2AllSigmoid(All2All):
    MAPPING = "all2all_sigmoid"
    ACTIVATION = "sigmoid"


class All2AllRELU(All2All):
    """Znicz smooth relu: log(1 + eˣ)."""

    MAPPING = "all2all_relu"
    ACTIVATION = "relu"


class All2AllStrictRELU(All2All):
    MAPPING = "all2all_strict_relu"
    MAPPING_ALIASES = ("all2all_str",)
    ACTIVATION = "strict_relu"


class All2AllSoftmax(All2All):
    """Linear layer + softmax; also exports ``max_idx`` (the argmax per
    sample) for the evaluator."""

    MAPPING = "softmax"
    ACTIVATION = None

    def __init__(self, workflow, **kwargs):
        super(All2AllSoftmax, self).__init__(workflow, **kwargs)
        self.max_idx = Vector()

    def initialize(self, device=None, **kwargs):
        super(All2AllSoftmax, self).initialize(device=device, **kwargs)
        self.max_idx.reset(numpy.zeros(self.output.shape[0],
                                       dtype=numpy.int32))
        self.init_vectors(self.max_idx)

    def pure(self, params, x):
        return _softmax(self._gemm(params, x, None))

    def cuda_run(self):
        logits = self._gemm(self.pure_params(), self.input.devmem, None)
        self.output.devmem = _softmax(logits)
        self.max_idx.devmem = logits.argmax(dim=1).to(torch.int32)

    def stitch_stage(self):
        """The generic stage, also producing ``max_idx`` as the argmax
        of the softmax output (the same as the logits' but for ties)."""
        base = super(All2AllSoftmax, self).stitch_stage()
        if base is None or not self.max_idx:
            return base
        inner = base.fn

        def fn(t):
            out = inner(t)
            out["max_idx"] = out["output"].argmax(dim=1).to(torch.int32)
            return out

        base.fn = fn
        base.produces["max_idx"] = self.max_idx
        return base


def _softmax(logits):
    m = logits.max(dim=1, keepdim=True).values
    e = torch.exp(logits - m)
    return e / e.sum(dim=1, keepdim=True)
