"""GDViaVJP: backward units derived from the forward's pure function,
the port's counterpart of :mod:`veles_tpu.znicz.gd_base`.

The backward of a layer-zoo forward (:class:`~veles_tpu_torch.znicz
.nn_units.PureForward`: conv, pooling, LRN, dropout, the activations,
deconv, the cutter, the channel splitter, ``rprop_all2all``) is the VJP
of its ``pure_fn`` at the pre-update parameters: ``torch.autograd.grad``
of the recomputed forward, with the incoming ``err_output`` as the
cotangent, for the parameters and the input at once.  The update is the
JAX ``compute``'s: the momentum rule with ``l1_vs_l2`` and
``factor_ortho`` (:func:`reg_term`, :func:`ortho_grad`), the gradient
averaged over the batch; :class:`GDRProp` takes iRprop− instead
(:func:`rprop_update`).  The parameters and their momenta are updated IN
PLACE, so a stitched segment's graph keeps reading the same tensors.
``rprop_all2all``'s VJP runs through ``All2All.pure_fn``, the GEMM
kernel's autograd, so on the card its three products are GEMM launches.

:meth:`GDViaVJP.stitch_stage` is the stitched stage of the same
compute, the parameters and momenta donated and the six hyperparameters
read from the segment's scalar block; a forward whose ``pure_params``
carries a seed (dropout, stochastic pooling) or another unit's offsets
(depooling) keeps its backward a barrier, as in the JAX package.
"""

import numpy
import torch

from veles_tpu_torch.memory import Vector
from veles_tpu_torch.znicz.nn_units import GradientDescentBase


def reg_term(param, decay, l1_vs_l2):
    """The regularization gradient λ·((1−l)·w + l·sign(w)): the
    ``l1_vs_l2`` mix (0 = pure L2, 1 = pure L1)."""
    if l1_vs_l2 == 0.0:
        return decay * param
    return decay * ((1.0 - l1_vs_l2) * param
                    + l1_vs_l2 * torch.sign(param))


def ortho_grad(w, factor):
    """The soft-orthogonality gradient (``factor_ortho``): the penalty
    (factor/4)·‖WᵀW − I‖²_F over the weight flattened to 2-D has the
    gradient factor · W·(WᵀW − I)."""
    m = w.reshape(-1, w.shape[-1])
    eye = torch.eye(m.shape[1], dtype=m.dtype, device=m.device)
    g = m @ (m.t() @ m - eye)
    return factor * g.reshape(w.shape)


def rprop_update(param, state, grad, eta_plus, eta_minus, delta_min,
                 delta_max):
    """One iRprop− update.  ``grad`` already holds the regularization
    term; ``state`` is the stacked ``(2,) + param.shape`` of [per-weight
    step sizes, previous gradient signs].  Returns ``(new_param,
    new_state)``: a sign flip shrinks the step and skips the move (the
    skipped sign is stored as 0, so the next step moves)."""
    delta, prev_sign = state[0], state[1]
    sign = torch.sign(grad)
    same = sign * prev_sign
    delta = torch.where(same > 0,
                        torch.clamp(delta * eta_plus, max=delta_max),
                        torch.where(same < 0,
                                    torch.clamp(delta * eta_minus,
                                                min=delta_min),
                                    delta))
    eff = torch.where(same < 0, torch.zeros_like(sign), sign)
    return param - eff * delta, torch.stack([delta, eff])


_HYPER = ("lr", "lr_b", "decay", "decay_b", "moment", "moment_b")


def vjp(pure_fn, config, params, x, cotangent, need_dx=True):
    """``({key: ∂/∂params[key]}, ∂/∂x or None)`` of ``pure_fn(params, x,
    **config)`` against ``cotangent``: the floating-point entries of
    ``params`` are differentiated, the rest (a seed, offsets) ride
    along."""
    keys = [k for k, v in params.items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()]
    with torch.enable_grad():
        leaves = dict(params)
        for k in keys:
            leaves[k] = params[k].detach().requires_grad_(True)
        xin = x.detach().requires_grad_(need_dx)
        out = pure_fn(leaves, xin, **config)
        wrt = [leaves[k] for k in keys] + ([xin] if need_dx else [])
        grads = torch.autograd.grad(
            out, wrt, cotangent.reshape(out.shape).to(out.dtype)) \
            if wrt else ()
    return dict(zip(keys, grads)), (grads[-1] if need_dx else None)


class GDViaVJP(GradientDescentBase):
    """Backward for any forward with ``pure_fn`` / ``pure_config``.
    Under a pod (:mod:`veles_tpu_torch.pod`) each rank runs the VJP on
    its own rows and ``grad_group_`` (the data group, set by the pod)
    sums the gradients over it before the in-place update."""

    hide_from_registry = True
    #: the data group a pod sums this unit's gradients over (transient)
    grad_group_ = None

    def __init__(self, workflow, **kwargs):
        super(GDViaVJP, self).__init__(workflow, **kwargs)
        self.forward = None
        self.demand("forward")

    @property
    def has_params(self):
        return bool(self.forward.weights)

    def _collect_params(self):
        return self.forward.pure_params()

    def _collect_vstate(self):
        """The momenta (device tensors), allocated at the first call: the
        forward's parameters may not have existed when initialize()
        ran."""
        if not self.has_params:
            return {}
        if not self.gradient_weights:
            self.gradient_weights.reset(numpy.zeros_like(self.weights.mem))
            self.gradient_weights.initialize(self.device)
        if self.include_bias and self.forward.bias \
                and not self.gradient_bias:
            self.gradient_bias.reset(numpy.zeros_like(
                self.forward.bias.mem))
            self.gradient_bias.initialize(self.device)
        vstate = {"w": self.gradient_weights.devmem}
        if self.include_bias and self.forward.bias:
            vstate["b"] = self.gradient_bias.devmem
        return vstate

    def _hyper(self):
        return {"lr": self.learning_rate, "lr_b": self.learning_rate_bias,
                "decay": self.weights_decay,
                "decay_b": self.weights_decay_bias,
                "moment": self.gradient_moment,
                "moment_b": self.gradient_moment_bias}

    def _update(self, param, state, grad, hyper, key):
        """The momentum step of one parameter, in place."""
        lr, decay, moment = ((hyper["lr"], hyper["decay"], hyper["moment"])
                             if key == "w" else
                             (hyper["lr_b"], hyper["decay_b"],
                              hyper["moment_b"]))
        l1 = self.l1_vs_l2 if key == "w" else self.l1_vs_l2_bias
        v = moment * state - lr * (grad + reg_term(param, decay, l1))
        param.add_(v)
        state.copy_(v)

    def _step_fn(self):
        """``compute(params, vstate, x, err_output, hyper) -> dx``: the
        VJP, then the update of ``params`` and ``vstate`` in place."""
        forward = self.forward
        pure_fn = type(forward).pure_fn
        config = forward.pure_config()
        need_err_input = self.need_err_input
        ortho = self.factor_ortho
        unit = self

        def compute(params, vstate, x, err_output, hyper):
            dparams, dx = vjp(pure_fn, config, params, x, err_output,
                              need_err_input)
            batch = x.shape[0]
            group = unit.grad_group_
            if group is not None:
                # a pod rank's rows: the summed gradients over the data
                # group, over the global batch
                from veles_tpu_torch.parallel.comm import all_reduce
                batch *= group.size
                for key in sorted(dparams):
                    if key in vstate:
                        all_reduce(dparams[key], group)
            with torch.no_grad():
                for key in ("w", "b"):
                    if key not in vstate:
                        continue
                    grad = dparams[key] / batch
                    if key == "w" and ortho:
                        grad = grad + ortho_grad(params["w"], ortho)
                    unit._update(params[key], vstate[key], grad, hyper, key)
            return dx

        return compute

    def initialize(self, device=None, **kwargs):
        super(GDViaVJP, self).initialize(device=device, **kwargs)
        if self.need_err_input and not self.err_input:
            self.err_input.reset(numpy.zeros(self.input.shape,
                                             dtype=numpy.float32))
            self.err_input.initialize(self.device)

    def cuda_run(self):
        params = self._collect_params()
        vstate = self._collect_vstate()
        dx = self._step_fn()(params, vstate, self.input.devmem,
                             self.err_output.devmem, self._hyper())
        if vstate:
            # updated in place: publish, so the host copies read as stale
            self.weights.devmem = params["w"]
            self.gradient_weights.devmem = vstate["w"]
            if "b" in vstate:
                self.forward.bias.devmem = params["b"]
                self.gradient_bias.devmem = vstate["b"]
        if self.need_err_input:
            self.err_input.devmem = dx.reshape(self.input.shape)

    def stitch_stage(self):
        """The stitched backward: the VJP and the update with the w, vw,
        b and vb Vectors donated (updated in place) and the six
        hyperparameters read at every dispatch; None for a forward whose
        ``pure_params`` carries more than w and b."""
        from veles_tpu_torch.stitch import StitchStage
        if not isinstance(self.input, Vector) or not self.input:
            return None
        fparams = self.forward.pure_params(host=True)
        if any(key not in ("w", "b") for key in fparams):
            return None
        self._collect_vstate()          # the momenta exist to be declared
        compute = self._step_fn()
        keys = tuple(sorted(fparams))
        need_err_input = self.need_err_input
        input_shape = tuple(self.input.shape)
        unit = self

        def fn(t):
            params = {k: t[k] for k in keys}
            vstate = {k: t["v" + k] for k in keys}
            hyper = {k: t["h_" + k] for k in _HYPER}
            dx = compute(params, vstate, t["input"], t["err_output"],
                         hyper)
            out = {}
            for k in keys:
                out[k], out["v" + k] = params[k], vstate[k]
            if need_err_input:
                out["err_input"] = dx.reshape((dx.shape[0],)
                                              + input_shape[1:])
            return out

        donated = {}
        if "w" in keys:
            donated["w"] = self.weights
            donated["vw"] = self.gradient_weights
        if "b" in keys:
            donated["b"] = self.forward.bias
            donated["vb"] = self.gradient_bias
        return StitchStage(
            self, fn,
            consumes={"input": self.input, "err_output": self.err_output},
            produces={"err_input": self.err_input}
            if need_err_input else None,
            donated=donated,
            scalars=lambda: {"h_" + k: float(v)
                             for k, v in unit._hyper().items()})


class GDRProp(GDViaVJP):
    """Resilient propagation (iRprop−) backward for
    :class:`~veles_tpu_torch.znicz.misc_units.RPropAll2All`: per-weight
    step sizes in place of the learning rate, grown by ``eta_plus`` while
    the gradient's sign holds and shrunk by ``eta_minus`` at a flip (that
    step skipped).  The momentum Vectors hold the stacked ``(2,) +
    shape`` state [step sizes, previous signs].  Knobs:
    ``rprop_delta_init`` (0.1), ``rprop_eta_plus`` (1.2),
    ``rprop_eta_minus`` (0.5), ``rprop_delta_min`` (1e-6),
    ``rprop_delta_max`` (50.0); ``weights_decay`` and ``l1_vs_l2`` fold
    into the gradient."""

    MAPPING = "gd_rprop"

    def __init__(self, workflow, **kwargs):
        super(GDRProp, self).__init__(workflow, **kwargs)
        self.delta_init = float(kwargs.get("rprop_delta_init", 0.1))
        self.eta_plus = float(kwargs.get("rprop_eta_plus", 1.2))
        self.eta_minus = float(kwargs.get("rprop_eta_minus", 0.5))
        self.delta_min = float(kwargs.get("rprop_delta_min", 1e-6))
        self.delta_max = float(kwargs.get("rprop_delta_max", 50.0))

    def _restack(self, vec, param_shape):
        """(Re)allocate ``vec`` as the stacked state: the base class's
        momentum-shaped zeros are not it."""
        if vec and tuple(vec.shape) == (2,) + tuple(param_shape):
            return
        state = numpy.zeros((2,) + tuple(param_shape), dtype=numpy.float32)
        state[0] = self.delta_init
        vec.reset(state)
        vec.initialize(self.device)

    def _collect_vstate(self):
        if self.has_params:
            self._restack(self.gradient_weights, self.weights.shape)
            if self.include_bias and self.forward.bias:
                self._restack(self.gradient_bias, self.forward.bias.shape)
        return super(GDRProp, self)._collect_vstate()

    def _update(self, param, state, grad, hyper, key):
        decay = hyper["decay"] if key == "w" else hyper["decay_b"]
        l1 = self.l1_vs_l2 if key == "w" else self.l1_vs_l2_bias
        new_param, new_state = rprop_update(
            param, state, grad + reg_term(param, decay, l1), self.eta_plus,
            self.eta_minus, self.delta_min, self.delta_max)
        param.copy_(new_param)
        state.copy_(new_state)


class GDGeneric(GDViaVJP):
    """The backward of the forward-only layer types (depooling, the
    channel splitter): the VJP of their ``pure_fn``."""

    MAPPING = "gd_generic"
