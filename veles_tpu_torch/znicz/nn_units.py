"""Shared bases for forward and gradient-descent units: the port's
counterpart of :mod:`veles_tpu.znicz.nn_units`.

``ForwardBase`` consumes ``input``, produces ``output`` and owns the
``weights``/``bias`` Vectors, filled at initialize from the
``forward_init`` stream (:mod:`veles_tpu_torch.prng`, so a seed gives
the JAX package's initial weights).  A forward class defines
``pure(params, x)``, its output from ``{"w", "b"}`` tensors and the
input; its ``cuda_run`` and its generic stitched stage
(:meth:`ForwardBase.stitch_stage`) both call it.  ``GradientDescentBase`` holds the
backward hyperparameters and the momenta ``gradient_weights`` /
``gradient_bias``, with the update rule (docs ``:547-556``)::

    v ← μ·v − α·(g + λ·w);  w ← w + v

A forward's ``checkpoint_state()`` is its weights and bias, for
``Workflow.capture_train_state``.
"""

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Vector

#: backward options of the JAX package this slice does not port
_GD_NOT_PORTED = ("l1_vs_l2", "l1_vs_l2_bias", "factor_ortho")


class ForwardBase(AcceleratedUnit):
    """Forward layer base."""

    hide_from_registry = True

    MAPPING = None

    def __init__(self, workflow, **kwargs):
        super(ForwardBase, self).__init__(workflow, **kwargs)
        self.input = None
        self.output = Vector()
        self.weights = Vector(category="params")
        self.bias = Vector(category="params")
        self.include_bias = kwargs.get("include_bias", True)
        self.weights_filling = kwargs.get("weights_filling", "uniform")
        self.weights_stddev = kwargs.get("weights_stddev", None)
        self.bias_filling = kwargs.get("bias_filling", "uniform")
        self.bias_stddev = kwargs.get("bias_stddev", None)
        #: storage layout: (neurons, fan-in) when True
        self.weights_transposed = kwargs.get("weights_transposed", False)
        self.demand("input")

    def pure(self, params, x):
        """The layer's output from ``params`` (``{"w": ..., "b": ...}``,
        ``b`` absent without a bias) and the input tensor ``x``."""
        raise NotImplementedError

    def pure_params(self):
        """``{"w", "b"}`` device tensors of the layer's parameters."""
        params = {"w": self.weights.devmem}
        if self.include_bias and self.bias:
            params["b"] = self.bias.devmem
        return params

    def stitch_stage(self):
        """The generic forward stage: :meth:`pure` over the w/b Vectors,
        consuming ``input`` and producing ``output``; None for a class
        without ``pure``."""
        from veles_tpu_torch.stitch import StitchStage
        if type(self).pure is ForwardBase.pure \
                or not isinstance(self.input, Vector) \
                or not self.input or not self.output:
            return None
        out_shape = tuple(self.output.shape)
        params = {"w": self.weights}
        if self.include_bias and self.bias:
            params["b"] = self.bias
        keys = tuple(sorted(params))
        unit = self

        def fn(t):
            out = unit.pure({k: t[k] for k in keys}, t["input"])
            return {"output": out.reshape(out_shape)}

        return StitchStage(self, fn, consumes={"input": self.input},
                           produces={"output": self.output},
                           params=params)

    @property
    def forward_prng(self):
        return prng.get("forward_init")

    def fill_array(self, array, filling, stddev):
        """Initial fill: ``gaussian``, ``uniform`` or ``constant``."""
        if stddev is None:
            fan_in = array.shape[0] if array.ndim > 1 else array.size
            stddev = 1.0 / numpy.sqrt(max(fan_in, 1))
        if filling == "gaussian":
            self.forward_prng.fill_normal(array, stddev=stddev)
        elif filling == "uniform":
            self.forward_prng.fill_uniform(array, low=-stddev, high=stddev)
        elif filling == "constant":
            array[...] = stddev
        else:
            raise ValueError("unknown filling %r" % filling)


    # -- the train-state checkpoint ------------------------------------------
    def checkpoint_state(self):
        """The trainable parameters, host copies (the GD momenta are not
        in it, as in the JAX package)."""
        if not self.weights:
            return None
        state = {"weights": numpy.array(self.weights.mem)}
        if self.include_bias and self.bias:
            state["bias"] = numpy.array(self.bias.mem)
        return state

    def restore_checkpoint_state(self, state):
        # copies: training updates the parameters in place
        if "weights" in state:
            self.weights.reset(numpy.array(state["weights"]))
        if "bias" in state and self.bias:
            self.bias.reset(numpy.array(state["bias"]))


class GradientDescentBase(AcceleratedUnit):
    """Backward layer base: consumes ``err_output`` and the forward's
    ``input``/``output``, produces ``err_input`` and updates the
    forward's parameters in place."""

    hide_from_registry = True

    MAPPING = None

    def __init__(self, workflow, **kwargs):
        for key in _GD_NOT_PORTED:
            if kwargs.get(key):
                raise NotImplementedError(
                    "GD option %r is not ported yet (ROADMAP item 7)" % key)
        super(GradientDescentBase, self).__init__(workflow, **kwargs)
        self.input = None
        self.output = None
        self.err_output = None
        self.err_input = Vector()
        self.weights = None
        self.bias = None
        self.learning_rate = kwargs.get("learning_rate", 0.01)
        self.learning_rate_bias = kwargs.get(
            "learning_rate_bias", kwargs.get("learning_rate", 0.01))
        self.weights_decay = kwargs.get("weights_decay", 0.0)
        self.weights_decay_bias = kwargs.get("weights_decay_bias", 0.0)
        self.gradient_moment = kwargs.get("gradient_moment", 0.0)
        self.gradient_moment_bias = kwargs.get(
            "gradient_moment_bias", kwargs.get("gradient_moment", 0.0))
        self.include_bias = kwargs.get("include_bias", True)
        #: compute err_input (False for the first layer: saves a GEMM)
        self.need_err_input = kwargs.get("need_err_input", True)
        self.forward = None
        self.gradient_weights = Vector(category="params")
        self.gradient_bias = Vector(category="params")
        self.demand("input", "err_output", "weights")

    def setup_from_forward(self, forward):
        """Wire the data links from the paired forward unit."""
        self.forward = forward
        self.link_attrs(forward, "input", "output", "weights")
        if self.include_bias:
            self.link_attrs(forward, "bias")
        return self

    @property
    def weights_transposed(self):
        return bool(getattr(self.forward, "weights_transposed", False))

    def initialize(self, device=None, **kwargs):
        super(GradientDescentBase, self).initialize(device=device, **kwargs)
        if self.weights and not self.gradient_weights:
            self.gradient_weights.reset(numpy.zeros_like(self.weights.mem))
            self.gradient_weights.initialize(self.device)
        if self.include_bias and self.bias and not self.gradient_bias:
            self.gradient_bias.reset(numpy.zeros_like(self.bias.mem))
            self.gradient_bias.initialize(self.device)
