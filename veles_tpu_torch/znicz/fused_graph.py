"""The general fused lowering: a StandardWorkflow layer stack as one
train step, the port's counterpart of :mod:`veles_tpu.znicz.fused_graph`.

:func:`lower_specs` instantiates the real forward units once
(:func:`probe_units`) to reuse their shape inference and weight
initialization, then keeps ``(pure_fn, static config, hyperparameters)``
a layer and the parameters as torch tensors.  Its ``step_fn`` runs the
forward, the loss, ``torch.autograd.grad`` through the GEMM kernel's
autograd (:class:`veles_tpu_torch.ops.gemm.MatMul`) and the solver
update as one function of ``(params, x, labels)``: the body that
:class:`~veles_tpu_torch.znicz.fused_unit.FusedTrainer` captures into
one CUDA graph a step shape on the card.

Where the JAX step returns new parameters (it donates the old), the
port's updates the parameters, momenta and solver slots IN PLACE, so
their addresses stay fixed across the graph's replays; it returns the
same list.  It carries what the JAX lowering carries: the five solvers
(momentum, adam with its ``t``, adagrad, adadelta, iRprop−) with
``l1_vs_l2`` and ``factor_ortho``; ``grad_accum`` (microbatches summed
in order, one update, each microbatch's seeds offset by the JAX stride);
``remat`` (``torch.utils.checkpoint`` around a
layer, per layer or for all); the LR-adjuster tick in each layer's
state; ``input_norm`` and ``compute_dtype`` (bf16 operands with f32
master weights and solver state); and the padded-batch loss
denominators.

Every registered layer type lowers, as in the JAX package: the all2all
family through the GEMM kernel's autograd, the layer zoo (conv, pooling,
LRN, dropout, deconv, …) through its ``pure_fn``'s autograd (cuDNN for
the convolutions on the card).  A stage whose ``pure_params`` holds a
``seed`` (dropout, stochastic pooling) gets one in its state, drawn from
the ``dropout`` stream at lowering as the JAX lowering draws it: a 0-d
int32 tensor that the step advances in place as ``(seed + 1) &
0x3fffffff``, so a CUDA graph of the step draws new masks at every
replay with no host generator.  ``apply_fn`` and ``eval_fn`` leave out
the ``SKIP_AT_EVAL`` stages (dropout).  The recurrent types (``lstm``,
``rnn``) lower through their loop's autograd.  ``grad_reduce_axis``
is the explicit-collective data parallelism
(:mod:`veles_tpu_torch.parallel.dp`): the step averages the gradients
and the loss report over that mesh axis and sums ``n_err`` (averages an
MSE's), one all-reduce of one flat buffer a step, so every rank applies
the same update.

``param_rules`` (a ``leaf -> spec or None`` rule over ``mesh``:
``dp.fsdp_rules``, ``dp.tp_rules`` or their merge) lays the step out
over sharded parameters, each rank holding its slice of every leaf a
rule shards (:class:`Layout`; the caller shards the returned host
params with :func:`veles_tpu_torch.parallel.dp.shard_params`):

- a leaf sharded over the data axis (FSDP / ZeRO-3 storage) is
  all-gathered before use inside the step; its gradient, averaged over
  the data axis with the others, is cut back to the rank's slice (the
  reduce-scatter), and the solver updates the slice in place;
- a fully-connected layer whose weight's last dim (its neurons) is
  sharded over the ``model`` axis runs column-parallel through
  :mod:`veles_tpu_torch.parallel.tp`: its input through
  ``copy_to_group`` (the input gradient all-reduced over the axis), the
  GEMM kernel's autograd product on the rank's neurons with the
  matching columns of a replicated bias (whose gradient is summed over
  the axis), and the output all-gathered over the axis
  (``gather_columns``; a softmax layer gathers its logits first).  A
  model-sharded leaf of any other layer is gathered as an FSDP one is.
"""

import numpy
import torch
import torch.utils.checkpoint

from veles_tpu_torch.dtypes import dtype_by_name
from veles_tpu_torch.znicz.gd_base import ortho_grad, reg_term, rprop_update

SOLVERS = ("momentum", "adam", "rprop", "adagrad", "adadelta")


def default_lr(solver):
    """The learning rate a spec gets when it names none: 1.0 for
    adadelta (whose update scales itself), 0.01 otherwise."""
    return 1.0 if str(solver) == "adadelta" else 0.01


#: the grad_accum microbatch stride of the stage seeds (the JAX step's)
SEED_STRIDE = 0x3504f325
SEED_MASK = 0x3fffffff


def probe_units(layer_specs, sample_shape):
    """One host-initialized probe unit a layer spec, of any registered
    type: the weights filled from the ``forward_init`` stream, then the
    spec's ``init`` weights put in, each unit's ``output`` feeding the
    next one's ``input``."""
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.memory import Vector
    from veles_tpu_torch.units import UnitRegistry
    from veles_tpu_torch.znicz import (  # noqa: F401 - the registry
        activation, all2all, conv, misc_units, normalization_units,
        pooling, rnn)

    wf = DummyWorkflow()
    probe = Vector(numpy.zeros((2,) + tuple(sample_shape), numpy.float32))
    units = []
    for spec in layer_specs:
        klass = UnitRegistry.mapped[spec["type"]]
        unit = klass(wf, **dict(spec.get("->", {})))
        unit.input = probe
        unit.initialize(device=None)
        init = spec.get("init")
        if init:
            unit.weights.reset(numpy.array(init["weights"]))
            if "bias" in init and unit.bias:
                unit.bias.reset(numpy.array(init["bias"]))
        probe = unit.output
        units.append(unit)
    return units


def _hyper(bw, solver):
    lr = float(bw.get("learning_rate", default_lr(solver)))
    return {
        "solver": solver,
        "lr": lr, "lr_b": float(bw.get("learning_rate_bias", lr)),
        "decay": float(bw.get("weights_decay", 0.0)),
        "decay_b": float(bw.get("weights_decay_bias", 0.0)),
        "moment": float(bw.get("gradient_moment", 0.0)),
        "moment_b": float(bw.get("gradient_moment_bias",
                                 bw.get("gradient_moment", 0.0))),
        "l1": float(bw.get("l1_vs_l2", 0.0)),
        "l1_b": float(bw.get("l1_vs_l2_bias", bw.get("l1_vs_l2", 0.0))),
        "factor_ortho": float(bw.get("factor_ortho", 0.0)),
        "beta1": float(bw.get("adam_beta1", 0.9)),
        "beta2": float(bw.get("adam_beta2", 0.999)),
        "eps": float(bw.get("adam_epsilon", 1e-8)),
        "adagrad_eps": float(bw.get("adagrad_epsilon", 1e-6)),
        "adadelta_rho": float(bw.get("adadelta_momentum", 0.9)),
        "adadelta_eps": float(bw.get("adadelta_epsilon", 1e-6)),
        "delta_init": float(bw.get("rprop_delta_init", 0.1)),
        "eta_plus": float(bw.get("rprop_eta_plus", 1.2)),
        "eta_minus": float(bw.get("rprop_eta_minus", 0.5)),
        "delta_min": float(bw.get("rprop_delta_min", 1e-6)),
        "delta_max": float(bw.get("rprop_delta_max", 50.0)),
    }


def _remat_stage(pure, config):
    """``pure`` with its static config bound, its activations recomputed
    in the backward (``torch.utils.checkpoint``)."""
    def wrapped(params, x, **_config):
        keys = sorted(params)

        def body(h, *values):
            return pure(dict(zip(keys, values)), h, **config)
        return torch.utils.checkpoint.checkpoint(
            body, x, *(params[k] for k in keys), use_reentrant=False)
    return wrapped


def _state_of(layer_params, solver, hyper, scheduled):
    """A layer's solver state beside its w and b (host numpy)."""
    state = dict(layer_params)

    def slot(key):
        if state.get(key) is None:
            return None
        if solver == "rprop":
            # stacked [per-weight step sizes, previous signs]
            s = numpy.zeros((2,) + state[key].shape, numpy.float32)
            s[0] = hyper["delta_init"]
            return s
        return numpy.zeros_like(state[key])

    # vw/vb: the momentum, adam's first moment, adadelta's E[Δ²], rprop's
    # stacked state; adagrad has no first slot
    state["vw"], state["vb"] = ((None, None) if solver == "adagrad"
                                else (slot("w"), slot("b")))
    if solver in ("adam", "adagrad", "adadelta"):
        state["sw"], state["sb"] = slot("w"), slot("b")
    if solver == "adam":
        state["t"] = numpy.int32(0)
    if scheduled and (state.get("w") is not None
                      or state.get("b") is not None):
        state["tick"] = numpy.int32(0)
    return state


def to_tensors(params, device=None):
    """A params list of host arrays as torch tensors on ``device`` (0-d
    int32 counters stay 0-d int32)."""
    return [{k: None if v is None else torch.as_tensor(
        numpy.array(v)).to(device or "cpu") for k, v in state.items()}
        for state in params]


def to_numpy(params):
    """Host numpy copies of a params list (what a snapshot pickles: a
    torch tensor in a pickle brings its storage with it)."""
    return [{k: None if v is None else v.detach().cpu().numpy().copy()
             for k, v in state.items()} for state in params]


def _solver_update(state, grads, hyper, policies):
    """One layer's update, in place (``grads``: ``{"w", "b"}``)."""
    if hyper["solver"] == "adam" and (state.get("w") is not None
                                      or state.get("b") is not None):
        state["t"].add_(1)
    for key, vkey, skey, lr_k, dec_k, mom_k in (
            ("w", "vw", "sw", "lr", "decay", "moment"),
            ("b", "vb", "sb", "lr_b", "decay_b", "moment_b")):
        if key not in grads or state.get(key) is None:
            continue
        param = state[key]
        grad = grads[key]
        lr_eff = hyper[lr_k]
        if "tick" in state:
            policy = policies[0] if key == "w" else policies[1]
            lr_eff = lr_eff * policy(state["tick"])
        l1 = hyper["l1"] if key == "w" else hyper["l1_b"]
        if key == "w" and hyper["factor_ortho"]:
            grad = grad + ortho_grad(param, hyper["factor_ortho"])
        solver = hyper["solver"]
        if solver == "momentum":
            v = hyper[mom_k] * state[vkey] - lr_eff * (
                grad + reg_term(param, hyper[dec_k], l1))
            param.copy_(param + v)
            state[vkey].copy_(v)
        elif solver == "adagrad":
            g = grad + reg_term(param, hyper[dec_k], l1)
            s2 = state[skey] + g * g
            param.copy_(param - lr_eff * g / (torch.sqrt(s2)
                                              + hyper["adagrad_eps"]))
            state[skey].copy_(s2)
        elif solver == "adadelta":
            rho, eps = hyper["adadelta_rho"], hyper["adadelta_eps"]
            g = grad + reg_term(param, hyper[dec_k], l1)
            s2 = rho * state[skey] + (1.0 - rho) * g * g
            upd = -torch.sqrt(state[vkey] + eps) / torch.sqrt(s2 + eps) * g
            param.copy_(param + lr_eff * upd)
            state[vkey].copy_(rho * state[vkey] + (1.0 - rho) * upd * upd)
            state[skey].copy_(s2)
        elif solver == "adam":
            t = state["t"].to(torch.float32)
            m = hyper["beta1"] * state[vkey] + (1.0 - hyper["beta1"]) * grad
            s2 = hyper["beta2"] * state[skey] \
                + (1.0 - hyper["beta2"]) * grad * grad
            m_hat = m / (1.0 - hyper["beta1"] ** t)
            s_hat = s2 / (1.0 - hyper["beta2"] ** t)
            step = m_hat / (torch.sqrt(s_hat) + hyper["eps"])
            param.copy_(param - lr_eff * (
                step + reg_term(param, hyper[dec_k], l1)))
            state[vkey].copy_(m)
            state[skey].copy_(s2)
        else:                            # iRprop−
            g = grad + reg_term(param, hyper[dec_k], l1)
            new_param, new_state = rprop_update(
                param, state[vkey], g, hyper["eta_plus"],
                hyper["eta_minus"], hyper["delta_min"], hyper["delta_max"])
            param.copy_(new_param)
            state[vkey].copy_(new_state)
    if "tick" in state:
        state["tick"].add_(1)


def _leaf_spec(rules, leaf):
    if rules is None or leaf is None or numpy.ndim(leaf) == 0:
        return ()
    spec = rules(leaf)
    return tuple(spec) if spec is not None else ()


class Layout(object):
    """Where each leaf of a params list lives under ``rules`` over
    ``mesh`` and how the step uses it (see the module)."""

    def __init__(self, params, configs, rules, mesh, data_axis="data",
                 model_axis="model"):
        from veles_tpu_torch.parallel.mesh import shard, unshard
        self._shard, self._unshard = shard, unshard
        self.mesh = mesh
        self.specs = [{k: _leaf_spec(rules, v) for k, v in state.items()}
                      for state in params]
        #: None without a model axis, or on a mesh without a group
        self.model_group = mesh.group(model_axis) \
            if model_axis in mesh.shape else None
        self.tp = []
        self.gather = []
        for state, specs, config in zip(params, self.specs, configs):
            w_spec = specs.get("w", ())
            column = (self.model_group is not None and len(w_spec) == 2
                      and w_spec[-1] == model_axis
                      and w_spec[0] in (None, data_axis)
                      and "is_softmax" in config
                      and not config.get("transposed"))
            self.tp.append(column)
            gather = {}
            for key, spec in specs.items():
                if column and key in ("w", "vw", "sw", "b", "vb", "sb") \
                        and spec and spec[-1] == model_axis:
                    # the model part stays local: gather the data part
                    spec = tuple(None if e == model_axis else e
                                 for e in spec)
                gather[key] = spec
            self.gather.append(gather)
            w = state.get("w")
            for key in ("vw", "sw"):
                slot = state.get(key)
                if slot is not None and w is not None and numpy.shape(
                        slot) == numpy.shape(w) and specs.get(key, ()) != \
                        specs.get("w", ()):
                    raise NotImplementedError(
                        "param_rules shard %s unlike its weight (%s vs "
                        "%s): a solver slot laid out apart from its "
                        "parameter is not ported yet (ROADMAP item "
                        "7(d))" % (key, specs[key], specs["w"]))

    def sharded(self):
        return any(any(spec) for specs in self.specs
                   for spec in specs.values())

    def full(self, i, key, tensor):
        """The tensor the step uses for layer ``i``'s ``key`` (the whole
        leaf, but a column-parallel layer's model slice)."""
        spec = self.gather[i].get(key, ())
        if tensor is None or not any(spec):
            return tensor
        return self._unshard(tensor, spec, self.mesh)

    def local(self, i, key, grad):
        """The rank's slice of a gradient of :meth:`full`'s tensor."""
        spec = self.gather[i].get(key, ())
        if not any(spec):
            return grad
        return self._shard(grad, spec, self.mesh).contiguous()

    def model_summed(self, i, key):
        """A replicated bias a column-parallel layer slices: its
        gradient is summed over the model axis."""
        return self.tp[i] and key == "b" and not any(
            self.specs[i].get("b", ()))

    def apply(self, i, pure, config, p, h):
        """Stage ``i`` over ``h``: column-parallel when it is one."""
        if not self.tp[i]:
            return pure(p, h, **config)
        from veles_tpu_torch.parallel.tp import (copy_to_group,
                                                 gather_columns)
        group = self.model_group
        p = dict(p)
        width = p["w"].shape[-1]
        if "b" in p and p["b"] is not None and p["b"].shape[-1] != width:
            first = group.index * width
            p["b"] = p["b"][first:first + width]
        h_in = copy_to_group(h, group)
        if config.get("is_softmax"):
            from veles_tpu_torch.znicz.all2all import _softmax
            logits = pure(p, h_in.float(), **dict(config, is_softmax=False))
            return _softmax(gather_columns(logits, group)).to(h.dtype)
        return gather_columns(pure(p, h_in, **config), group)


def lower_specs(layer_specs, sample_shape, loss="softmax",
                compute_dtype=None, remat=False, grad_accum=1,
                lr_adjuster=None, input_norm=None, grad_reduce_axis=None,
                mesh=None, param_rules=None):
    """``(params, step_fn, eval_fn, apply_fn)`` from layer specs.

    ``sample_shape``: one sample's shape (no batch axis).  ``params``
    is a list of per-layer dicts of host numpy arrays (``w``, ``b``, the
    solver slots, ``t``, ``tick``), as the JAX function returns them;
    :func:`to_tensors` puts them on a device.  ``step_fn(params, x,
    labels) -> (params, {"loss", "n_err"})`` updates the tensors of
    ``params`` in place; ``eval_fn(params, x, labels)`` gives ``{"n_err",
    "n"}`` (softmax) or ``{"rmse"}``; ``apply_fn(params, x)`` the output.
    ``input_norm=(scale, shift)``: the affine normalizer applied in the
    step, so ``x`` may arrive in its storage type (u8 pixels).
    ``compute_dtype`` (a torch dtype or its name): the products' operand
    type, the master weights and solver state staying f32.
    ``grad_reduce_axis``: a ``mesh`` axis (by default a mesh of every
    rank on that axis) over which each step reduces its gradients and
    metrics (see the module); each rank gives the step its own rows.
    ``param_rules``: the sharded layout over ``mesh`` (see the module);
    ``params`` come back whole.
    """
    reduce_group = _reduce_group(grad_reduce_axis, mesh)
    grad_accum = max(int(grad_accum), 1)
    if compute_dtype is not None:
        compute_dtype = dtype_by_name(compute_dtype)
    policies = None
    if lr_adjuster:
        from veles_tpu_torch.znicz.lr_adjust import make_policy
        name = lr_adjuster.get("lr_policy_name", "fixed")
        parameters = lr_adjuster.get("lr_parameters")
        policies = (make_policy(name, parameters), make_policy(
            lr_adjuster.get("bias_lr_policy_name", name),
            lr_adjuster.get("bias_lr_parameters", parameters)))
    units = probe_units(layer_specs, sample_shape)
    stages = []      # (pure_fn, config, hyper, skip_at_eval)
    params = []
    for spec, unit in zip(layer_specs, units):
        layer_params = {k: numpy.array(v) for k, v in
                        unit.pure_params(host=True).items()}
        bw = spec.get("<-", {})
        solver = str(bw.get("solver", "momentum"))
        if solver not in SOLVERS:
            raise ValueError("unknown solver %r (want momentum / adam "
                             "/ rprop / adagrad / adadelta)" % solver)
        if policies is not None and solver == "rprop":
            raise ValueError(
                "lr_adjuster has no effect on the rprop solver (its "
                "per-weight deltas are self-adaptive): remove the "
                "schedule or pick another solver for this layer")
        hyper = _hyper(bw, solver)
        pure = type(unit).pure_fn
        if spec.get("remat", remat):
            pure = _remat_stage(pure, unit.pure_config())
        stages.append((pure, unit.pure_config(), hyper,
                       bool(getattr(type(unit), "SKIP_AT_EVAL", False))))
        state = _state_of(layer_params, solver, hyper, policies is not None)
        if "seed" in state:
            # a fresh stream a stage, advanced by every step
            from veles_tpu_torch import prng
            state["seed"] = numpy.int32(
                prng.get("dropout").randint(0, 2 ** 30))
        params.append(state)

    layout = None
    if param_rules is not None:
        if mesh is None:
            raise ValueError("param_rules needs the mesh they shard over")
        layout = Layout(params, [config for _p, config, _h, _s in stages],
                        param_rules, mesh)
        for state, specs, (_p, _c, hyper, _s) in zip(params, layout.specs,
                                                      stages):
            if hyper["factor_ortho"] and any(specs.get("w", ())):
                raise NotImplementedError(
                    "factor_ortho over a sharded weight (W^T W needs the "
                    "whole weight in the solver) is not ported yet "
                    "(ROADMAP item 7(d))")
        if not layout.sharded():
            layout = None

    def _apply_stage(i, pure, config, p, h):
        if layout is None:
            return pure(p, h, **config)
        return layout.apply(i, pure, config, p, h)

    def _full(i, key, tensor):
        return tensor if layout is None else layout.full(i, key, tensor)

    norm_cache = {}

    def _norm(dtype, device):
        # made at a step's first call and reused, so a CUDA graph of a
        # later step copies nothing from the host
        key = (dtype, str(device))
        if key not in norm_cache:
            scale, shift = input_norm
            norm_cache[key] = tuple(
                torch.as_tensor(numpy.asarray(v, numpy.float32)).to(
                    device=device, dtype=dtype) for v in (scale, shift))
        return norm_cache[key]

    def _ingest(x):
        h = x
        if not h.is_floating_point():
            h = h.to(compute_dtype or torch.float32)
        if input_norm is not None:
            scale, shift = _norm(h.dtype, h.device)
            h = h * scale + shift
        return h

    def apply_fn(params_list, x, train=False):
        h = _ingest(x)
        for i, ((pure, config, _hyper, skip_at_eval), state) in enumerate(
                zip(stages, params_list)):
            if skip_at_eval and not train:
                continue
            p = {k: _full(i, k, v) for k, v in state.items()
                 if k in ("w", "b", "seed") and v is not None}
            h = _apply_stage(i, pure, config, p, h)
        return h

    def loss_fn(wb_list, aux_list, x, labels):
        h = _ingest(x)
        if compute_dtype is not None:
            h = h.to(compute_dtype)
        for i, ((pure, config, _hyper, _skip), wb, aux) in enumerate(
                zip(stages, wb_list, aux_list)):
            p = ({k: v.to(compute_dtype) for k, v in wb.items()}
                 if compute_dtype is not None else dict(wb))
            p.update(aux)
            h = _apply_stage(i, pure, config, p, h)
        out = h.float()
        if loss == "softmax":
            valid = labels >= 0
        else:
            valid = torch.ones(x.shape[0], dtype=torch.bool,
                               device=x.device)
        grad_denom = x.shape[0]
        if loss == "softmax":
            logp = torch.log(torch.clamp(out, min=1e-30))
            picked = torch.gather(
                logp, 1, torch.clamp(labels, min=0).long()[:, None])[:, 0]
            total = -(picked * valid).sum()
            n_err = ((out.argmax(dim=1) != labels) & valid).sum()
        else:
            flat = out.reshape(out.shape[0], -1)
            target = labels.reshape(flat.shape)
            total = ((flat - target) ** 2).mean(dim=1).sum() / 2
            n_err = torch.sqrt(((flat - target) ** 2).mean())
        return (total / grad_denom, n_err,
                total / torch.clamp(valid.sum(), min=1))

    def _grads(params_list, x, labels):
        keys = [[k for k in ("w", "b") if state.get(k) is not None]
                for state in params_list]
        aux_list = [{"seed": state["seed"]} if "seed" in state else {}
                    for state in params_list]
        with torch.enable_grad():
            leaves = [{k: _full(i, k, state[k]).detach().requires_grad_(True)
                       for k in layer_keys}
                      for i, (state, layer_keys) in enumerate(
                          zip(params_list, keys))]
            flat = [leaf[k] for leaf, layer_keys in zip(leaves, keys)
                    for k in layer_keys]
            if grad_accum == 1:
                value, n_err, report = loss_fn(leaves, aux_list, x,
                                               labels)
                grads = list(torch.autograd.grad(value, flat))
            else:
                batch = x.shape[0]
                if batch % grad_accum:
                    raise ValueError(
                        "batch %d not divisible by grad_accum %d"
                        % (batch, grad_accum))
                size = batch // grad_accum
                grads = [torch.zeros_like(leaf) for leaf in flat]
                n_err = torch.zeros((), dtype=torch.float32,
                                    device=x.device)
                loss_sum = torch.zeros_like(n_err)
                # the microbatches in order: activations exist for one
                # at a time, the gradients are summed, ONE update
                for i in range(grad_accum):
                    chunk = slice(i * size, (i + 1) * size)
                    # each microbatch draws its own masks: the chunk
                    # index folded into every stage seed
                    aux_i = [{k: (v.to(torch.int64) + i * SEED_STRIDE)
                              .bitwise_and(SEED_MASK).to(torch.int32)
                              for k, v in aux.items()} for aux in aux_list]
                    value, err_c, report_c = loss_fn(
                        leaves, aux_i, x[chunk], labels[chunk])
                    for g, gi in zip(grads, torch.autograd.grad(value,
                                                                flat)):
                        g.add_(gi)
                    n_err = n_err + err_c.to(torch.float32)
                    loss_sum = loss_sum + report_c.to(torch.float32)
                grads = [g / grad_accum for g in grads]
                report = loss_sum / grad_accum
                if loss == "mse":
                    # each chunk's "n_err" is an RMSE: averaged, not summed
                    n_err = n_err / grad_accum
        it = iter(grads)
        per_layer = [{k: next(it) for k in layer_keys} for layer_keys in keys]
        return per_layer, n_err, report

    def step_fn(params_list, x, labels):
        grads, n_err, report = _grads(params_list, x, labels)
        if layout is not None and layout.model_group is not None:
            from veles_tpu_torch.parallel.comm import all_reduce
            for i, layer in enumerate(grads):
                for key in sorted(layer):
                    if layout.model_summed(i, key):
                        all_reduce(layer[key], layout.model_group)
        if reduce_group is not None:
            grads, n_err, report = _reduce(grads, n_err, report,
                                           reduce_group, loss)
        if layout is not None:
            grads = [{k: layout.local(i, k, g) for k, g in layer.items()}
                     for i, layer in enumerate(grads)]
        with torch.no_grad():
            for state, layer_grads, (_p, _c, hyper, _s) in zip(
                    params_list, grads, stages):
                _solver_update(state, layer_grads, hyper, policies)
                if "seed" in state:
                    # the stage's mask stream advances a step, in place
                    seed = state["seed"]
                    seed.copy_((seed + 1).bitwise_and(SEED_MASK))
        return params_list, {"loss": report.detach(),
                             "n_err": n_err.detach()}

    def eval_fn(params_list, x, labels):
        with torch.no_grad():
            out = apply_fn(params_list, x, train=False)
            if loss == "softmax":
                valid = labels >= 0
                n_err = ((out.argmax(dim=1) != labels) & valid).sum()
                return {"n_err": n_err, "n": valid.sum()}
            flat = out.float().reshape(out.shape[0], -1)
            return {"rmse": torch.sqrt(
                ((flat - labels.reshape(flat.shape)) ** 2).mean())}

    return params, step_fn, eval_fn, apply_fn


def _reduce_group(axis, mesh):
    """The group a ``grad_reduce_axis`` step reduces over: None without
    an axis, or on a one-process mesh without a process group (a world
    of one has nothing to reduce)."""
    if axis is None:
        return None
    from veles_tpu_torch.parallel.mesh import make_mesh
    if mesh is None:
        mesh = make_mesh({axis: -1})
    if axis not in mesh.shape:
        raise ValueError("grad_reduce_axis %r is not an axis of %r"
                         % (axis, mesh))
    group = mesh.group(axis)
    if group is None and mesh.shape[axis] > 1:
        raise ValueError(
            "grad_reduce_axis %r spans %d ranks, but no process group is "
            "initialized (parallel.multihost.initialize)"
            % (axis, mesh.shape[axis]))
    return group


def _reduce(grads, n_err, report, group, loss):
    """``pmean`` of the gradients and the loss report over ``group`` and
    ``psum`` (softmax) or ``pmean`` (MSE) of ``n_err``: one all-reduce
    of one flat f32 buffer, then the shares divided by the group
    size."""
    from veles_tpu_torch.parallel.comm import all_reduce
    leaves = [g for layer in grads for g in layer.values()]
    flat = torch.cat([g.reshape(-1) for g in leaves]
                     + [report.reshape(1).float(), n_err.reshape(1).float()])
    all_reduce(flat, group)
    size = group.size
    out, offset = [], 0
    for layer in grads:
        mean = {}
        for key, g in layer.items():
            mean[key] = flat[offset:offset + g.numel()].view_as(g) / size
            offset += g.numel()
        out.append(mean)
    report = (flat[offset] / size).to(report.dtype)
    total = flat[offset + 1]
    n_err = (total if loss == "softmax" else total / size).to(n_err.dtype)
    return out, n_err, report


def epoch_indices(n_samples, batch, generator=None, shuffle=True):
    """The ``(steps, batch)`` minibatch indices of one epoch: a
    ``torch.randperm`` of the samples drawn from ``generator`` (a CPU
    ``torch.Generator``), or the samples in order when ``shuffle`` is
    False; the short tail is dropped.  (JAX's threefry permutation
    cannot be reproduced, so a test holds the unshuffled epochs.)"""
    steps = n_samples // batch
    if steps == 0:
        raise ValueError("dataset smaller than one minibatch")
    perm = (torch.randperm(n_samples, generator=generator) if shuffle
            else torch.arange(n_samples))
    return perm[:steps * batch].reshape(steps, batch).to(torch.int32)


def epoch_runner(step_fn, n_samples, batch, shuffle=True):
    """A whole epoch of ``step_fn`` over a resident dataset:
    ``epoch_fn(params, data, labels, generator) -> (params, metrics)``
    gathers each minibatch's rows and labels on the device in one launch
    (:func:`veles_tpu_torch.ops.gather.take_rows_group`: the gather
    kernel on the card) and runs a step on them; ``metrics`` stacks each
    step's (``{"loss": (steps,), "n_err": (steps,)}``, f32).  The short
    tail (< ``batch`` samples) is dropped."""
    steps = n_samples // batch
    if steps == 0:
        raise ValueError("dataset smaller than one minibatch")

    def epoch_fn(params, data, labels, generator=None):
        idx = epoch_indices(n_samples, batch, generator, shuffle).to(
            data.device)
        return run_steps(step_fn, params, data, labels, idx)

    return epoch_fn


def run_steps(step_fn, params, data, labels, idx):
    """``step_fn`` over the minibatches whose rows ``idx`` (``(steps,
    batch)`` int32) names, each gathered with its labels in one launch;
    the stacked f32 metrics."""
    from veles_tpu_torch.ops.gather import take_rows_group

    stacked = {"loss": [], "n_err": []}
    for i in range(idx.shape[0]):
        x, y = take_rows_group([(data, 0), (labels, -1)], idx[i])
        params, metrics = step_fn(params, x, y)
        for key in stacked:
            stacked[key].append(metrics[key].to(torch.float32))
    return params, {k: torch.stack(v) for k, v in stacked.items()}
