"""Gradient-descent backward units for fully-connected layers: the
port's counterpart of :mod:`veles_tpu.znicz.gd`.

For ``y = act(x·W + b)`` and the incoming ``err_output = ∂L/∂y``::

    δ = err_output ⊙ act'(y)          (act' from the OUTPUT, Znicz style)
    ∂L/∂W = xᵀ·δ / B ;  ∂L/∂b = Σδ / B ;  err_input = δ·Wᵀ

``cuda_run`` is one call of :func:`veles_tpu_torch.ops.gemm.gd_fused`:
on the card the dx, dw and db kernels, in that order, updating the
weights, the bias and their momenta in place (the JAX package donates
them); on CPU tensors the plain version.  The stitched stage
(:meth:`GradientDescent.stitch_stage`) makes the same call with the
six hyperparameters as 0-d tensors of the segment's scalar block, so
the dw and db kernels read them when a replay runs: a learning rate
changed between dispatches takes effect at the next one.  The stage
declares its training-health statistics (``health``, read when
``engine.health`` is armed; :mod:`veles_tpu_torch.watch.health`): the
effective gradient's norm recovered from the momentum recurrence, and
the weight and update norms.  The kernels update the momenta in place,
so with health armed the stage copies vW and vb before the GD launches;
with health off it copies nothing.  Not ported: the
``engine.kernels=xla`` route to the dense reference, which
:meth:`GradientDescent.initialize` refuses (ROADMAP item 7).
"""

import numpy
import torch

from veles_tpu_torch.backends import check_kernels
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.ops.gemm import gd_fused
from veles_tpu_torch.znicz.nn_units import GradientDescentBase

#: backward options the GD kernels do not take (the layer zoo's
#: GDViaVJP units take them)
_GD_NOT_PORTED = ("l1_vs_l2", "l1_vs_l2_bias", "factor_ortho")


class GradientDescent(GradientDescentBase):
    """Backward for plain All2All (identity activation)."""

    MAPPING = "gd"
    ACTIVATION = None

    def __init__(self, workflow, **kwargs):
        for key in _GD_NOT_PORTED:
            if kwargs.get(key):
                raise NotImplementedError(
                    "GD option %r is not ported to the all2all GD kernels "
                    "yet (ROADMAP item 7)" % key)
        super(GradientDescent, self).__init__(workflow, **kwargs)

    def initialize(self, device=None, **kwargs):
        check_kernels("the GD units' dense route")
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

    def stitch_stage(self):
        """The backward stage: ``gd_fused`` with W, vW, b and vb DONATED
        (updated in place) and the hyperparameters read at every
        dispatch."""
        from veles_tpu_torch.stitch import StitchStage
        if not isinstance(self.input, Vector):
            return None
        has_bias = bool(self.include_bias and self.bias)
        activation = self.ACTIVATION
        need_err_input = self.need_err_input
        transposed = self.weights_transposed
        input_shape = tuple(self.input.shape)

        def fn(t):
            w, b, vw, vb, err_input = gd_fused(
                t["input"], t["output"], t["err_output"], t["w"],
                t.get("b"), t["vw"], t.get("vb"), t["lr"], t["lr_b"],
                t["decay"], t["decay_b"], t["moment"], t["moment_b"],
                activation=activation, need_err_input=need_err_input,
                has_bias=has_bias, transposed=transposed)
            out = {"w": w, "vw": vw}
            if has_bias:
                out["b"], out["vb"] = b, vb
            if need_err_input:
                out["err_input"] = err_input.reshape(input_shape)
            return out

        donated = {"w": self.weights, "vw": self.gradient_weights}
        if has_bias:
            donated["b"] = self.bias
            donated["vb"] = self.gradient_bias

        def health(t, out):
            # the effective gradient (weight decay included) from the
            # momentum recurrence v' = moment·v - lr·(grad + decay·w): its
            # norm is ‖moment·v - v'‖ / |lr|, so a changing learning rate
            # needs no second backward; t holds v from before the update
            # (reads_before), and lr = 0 keeps a frozen group's norm at
            # zero, not inf.  One norm kernel a tensor, then a few on the
            # small vector of norms: a handful of graph nodes a step
            pairs = [("w", "vw", "lr", "moment")]
            if has_bias:
                pairs.append(("b", "vb", "lr_b", "moment_b"))
            norm = torch.linalg.vector_norm
            tensors = [out[w] for w, _v, _l, _m in pairs] \
                + [out[v] for _w, v, _l, _m in pairs] \
                + [torch.addcmul(out[v], t[v], t[m], value=-1)
                   for _w, v, _l, m in pairs]
            n = torch.stack([norm(x) for x in tensors])
            k = len(pairs)
            lrs = torch.stack([t[lr] for _w, _v, lr, _m in pairs])
            grads = torch.where(lrs != 0, n[2 * k:] / lrs.abs(), 0.0)
            return {"grad_norm": norm(grads),
                    "weight_norm": norm(n[:k]),
                    "update_norm": norm(n[k:2 * k])}

        health.reads_before = ("vw", "vb") if has_bias else ("vw",)
        unit = self
        return StitchStage(
            self, fn,
            consumes={"input": self.input, "output": self.output,
                      "err_output": self.err_output},
            produces={"err_input": self.err_input}
            if need_err_input else None,
            donated=donated,
            scalars=lambda: {
                "lr": float(unit.learning_rate),
                "lr_b": float(unit.learning_rate_bias),
                "decay": float(unit.weights_decay),
                "decay_b": float(unit.weights_decay_bias),
                "moment": float(unit.gradient_moment),
                "moment_b": float(unit.gradient_moment_bias),
            },
            health=health)


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
