"""Shared bases for forward and gradient-descent units: the port's
counterpart of :mod:`veles_tpu.znicz.nn_units`.

``ForwardBase`` consumes ``input``, produces ``output`` and owns the
``weights``/``bias`` Vectors, filled at initialize from the
``forward_init`` stream (:mod:`veles_tpu_torch.prng`, so a seed gives
the JAX package's initial weights).  A forward class defines
``pure(params, x)``, its output from ``{"w", "b"}`` tensors and the
input; its ``cuda_run`` and its generic stitched stage
(:meth:`ForwardBase.stitch_stage`) both call it.  The layer zoo's
forwards (:class:`PureForward`) have the JAX units' static form: a
``pure_fn(params, x, **config)`` and the unit's ``pure_config()``, which
their backward (:class:`~veles_tpu_torch.znicz.gd_base.GDViaVJP`) and
the fused lowering differentiate; ``pure_params`` may carry more than
the parameters (dropout's and stochastic pooling's ``seed``,
depooling's ``offsets``), and such a unit is a stitching barrier, as in
the JAX package.  ``GradientDescentBase`` holds the
backward hyperparameters and the momenta ``gradient_weights`` /
``gradient_bias``, with the update rule (docs ``:547-556``)::

    v ← μ·v − α·(g + λ·w);  w ← w + v

A forward's ``checkpoint_state()`` is its weights and bias, for
``Workflow.capture_train_state``.

The job contract (:mod:`veles_tpu_torch.parallel.jobs`): a forward's
weights and bias go to the slave with each job, and the slave sends back
their deltas over the job, which the master adds to its own (the
asynchronous data parallelism of the JAX package).  The slave installs a
job's weights through ``Vector.reset``: a stitched segment's Vectors
keep their device address, so the upload copies into the captured
tensors and the graphs replay on.  A GD unit sends nothing.
"""

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Vector

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

    def pure_params(self, host=False):
        """``{"w", "b"}`` of the layer's parameters (those it has): device
        tensors, or host numpy arrays with ``host``."""
        params = {}
        if self.weights:
            params["w"] = self.weights.mem if host else self.weights.devmem
        if self.include_bias and self.bias:
            params["b"] = self.bias.mem if host else self.bias.devmem
        return params

    def stitch_stage(self):
        """The generic forward stage: :meth:`pure` over the w/b Vectors,
        consuming ``input`` and producing ``output``; None for a class
        without ``pure`` and for a unit whose ``pure_params`` carries
        more than w and b (a seed drawn at every run, which a replay
        would freeze, or another unit's offsets)."""
        from veles_tpu_torch.stitch import StitchStage
        if type(self).pure is ForwardBase.pure \
                or not isinstance(self.input, Vector) \
                or not self.input or not self.output:
            return None
        if any(key not in ("w", "b")
               for key in self.pure_params(host=True)):
            return None
        out_shape = tuple(self.output.shape)
        params = {}
        if self.weights:
            params["w"] = self.weights
        if self.include_bias and self.bias:
            params["b"] = self.bias
        keys = tuple(sorted(params))
        unit = self

        def fn(t):
            out = unit.pure({k: t[k] for k in keys}, t["input"])
            # the rows as given: a pod rank runs its own rows
            return {"output": out.reshape((out.shape[0],) + out_shape[1:])}

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

    # -- the job contract ----------------------------------------------------
    def generate_data_for_slave(self, slave=None):
        """Master: the weights (and bias) ride with each job."""
        if not self.weights:
            return None
        payload = {"weights": numpy.array(self.weights.mem)}
        if self.include_bias and self.bias:
            payload["bias"] = numpy.array(self.bias.mem)
        return payload

    def apply_data_from_master(self, data):
        """Slave: install the job's weights (a reset: the whole buffer is
        replaced, so the device copy is not read back first) and keep
        them as the job's starting point, from which the update's deltas
        are taken."""
        if data is None:
            return
        self.weights.reset(numpy.array(data["weights"]))
        self._job_start_ = {"weights": numpy.array(data["weights"])}
        if "bias" in data and self.bias:
            self.bias.reset(numpy.array(data["bias"]))
            self._job_start_["bias"] = numpy.array(data["bias"])

    def generate_data_for_master(self):
        """Slave: the job's weight (and bias) deltas."""
        start = getattr(self, "_job_start_", None)
        if start is None or not self.weights:
            return None
        payload = {"delta_weights": self.weights.mem - start["weights"]}
        if "bias" in start and self.bias:
            payload["delta_bias"] = self.bias.mem - start["bias"]
        return payload

    def apply_data_from_slave(self, data, slave=None):
        """Master: add a slave's deltas to the weights."""
        if data is None:
            return
        self.weights.map_write()
        self.weights.mem += data["delta_weights"]
        if "delta_bias" in data and self.bias:
            self.bias.map_write()
            self.bias.mem += data["delta_bias"]


class PureForward(ForwardBase):
    """A layer-zoo forward: ``pure_fn(params, x, **pure_config())``, a
    static function as in the JAX units, with the unit's configuration
    read at each call; ``cuda_run`` publishes its output."""

    hide_from_registry = True

    def pure_config(self):
        return {}

    @staticmethod
    def pure_fn(params, x):
        raise NotImplementedError

    def pure(self, params, x):
        return type(self).pure_fn(params, x, **self.pure_config())

    def cuda_run(self):
        self.output.devmem = self.pure(self.pure_params(),
                                       self.input.devmem)


class GradientDescentBase(AcceleratedUnit):
    """Backward layer base: consumes ``err_output`` and the forward's
    ``input``/``output``, produces ``err_input`` and updates the
    forward's parameters in place."""

    hide_from_registry = True

    MAPPING = None

    def __init__(self, workflow, **kwargs):
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
        #: the regularization mix: 1.0 = pure L1 (λ·sign(w)), 0.0 =
        #: pure L2 (λ·w)
        self.l1_vs_l2 = float(kwargs.get("l1_vs_l2", 0.0))
        self.l1_vs_l2_bias = float(kwargs.get(
            "l1_vs_l2_bias", kwargs.get("l1_vs_l2", 0.0)))
        #: the soft-orthogonality weight: the gradient gains
        #: factor_ortho · W·(WᵀW − I) over the weights flattened to 2-D
        self.factor_ortho = float(kwargs.get("factor_ortho", 0.0))
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
