"""The MLP-specific fused train step: the port's counterpart of
:mod:`veles_tpu.znicz.fused`.

The same layer-spec dicts StandardWorkflow takes, lowered into one
function of ``(params, x, labels)``: the forward, the loss, the backward
and the momentum updates (``v ← μv − α(g + λw); w ← w + v``, gradients
averaged over the padded batch, as the eager GD units scale them).
``lower_workflow(wf)`` reads a live workflow's parameters (and its GD
units' momenta, zero for a fused workflow) and ``update_workflow``
writes a step's parameters back.  The products here are plain
``torch.matmul``, as the JAX module leaves its ``jnp.dot`` outside any
kernel; the workflow's fused route is
:mod:`veles_tpu_torch.znicz.fused_graph`.  Params are dicts of torch
tensors (``init_mlp_params`` fills numpy from the ``forward_init``
stream, as the forward units do, and returns tensors on the CPU).
"""

import numpy
import torch

from veles_tpu_torch import prng


def _activate(v, activation):
    if activation in (None, "linear"):
        return v
    if activation == "tanh":
        return 1.7159 * torch.tanh(0.6666 * v)
    if activation == "sigmoid":
        return torch.sigmoid(v)
    if activation == "relu":
        return torch.log1p(torch.exp(torch.clamp(v, max=30.0)))
    if activation == "strict_relu":
        return torch.clamp(v, min=0.0)
    raise ValueError("unknown activation %r" % (activation,))


def init_mlp_params(input_dim, layer_specs, dtype=numpy.float32):
    """A params list ``[{w, b, vw, vb}, ...]`` with the named-stream
    fills the forward units use."""
    stream = prng.get("forward_init")
    params = []
    fan_in = input_dim
    for spec in layer_specs:
        n = int(numpy.prod(spec.get("->", {}).get("output_sample_shape")))
        stddev = spec.get("->", {}).get("weights_stddev") or \
            1.0 / numpy.sqrt(max(fan_in, 1))
        w = numpy.zeros((fan_in, n), dtype=dtype)
        b = numpy.zeros((n,), dtype=dtype)
        if spec.get("->", {}).get("weights_filling",
                                  "uniform") == "gaussian":
            stream.fill_normal(w, stddev=stddev)
            stream.fill_normal(b, stddev=stddev)
        else:
            stream.fill_uniform(w, low=-stddev, high=stddev)
            stream.fill_uniform(b, low=-stddev, high=stddev)
        params.append({k: torch.from_numpy(v) for k, v in (
            ("w", w), ("b", b), ("vw", numpy.zeros_like(w)),
            ("vb", numpy.zeros_like(b)))})
        fan_in = n
    return params


def _specs_static(layer_specs):
    """``((activation, is_softmax, lr, lr_b, decay, decay_b, moment,
    moment_b), ...)`` of the layer dicts."""
    from veles_tpu_torch.units import UnitRegistry
    from veles_tpu_torch.znicz import all2all  # noqa: F401 - registry
    out = []
    for spec in layer_specs:
        mapping = spec["type"]
        klass = UnitRegistry.mapped.get(mapping)
        bw = spec.get("<-", {})
        lr = float(bw.get("learning_rate", 0.01))
        out.append((
            getattr(klass, "ACTIVATION", None) if klass is not None
            else None, mapping == "softmax", lr,
            float(bw.get("learning_rate_bias", lr)),
            float(bw.get("weights_decay", 0.0)),
            float(bw.get("weights_decay_bias", 0.0)),
            float(bw.get("gradient_moment", 0.0)),
            float(bw.get("gradient_moment_bias",
                         bw.get("gradient_moment", 0.0)))))
    return tuple(out)


def mlp_apply(params, x, static_specs, compute_dtype=None,
              input_norm=None):
    """The forward; the last softmax layer returns probabilities.
    ``input_norm=(scale, shift)`` normalizes in the step, so ``x`` may
    keep its storage type (u8 pixels)."""
    h = x.reshape(x.shape[0], -1)
    if not h.is_floating_point():
        h = h.to(compute_dtype or torch.float32)
    if input_norm is not None:
        scale, shift = input_norm
        h = h * torch.as_tensor(scale, dtype=h.dtype, device=h.device) \
            + torch.as_tensor(shift, dtype=h.dtype, device=h.device)
    if compute_dtype is not None:
        h = h.to(compute_dtype)
    for layer, (activation, is_softmax, *_rest) in zip(params,
                                                       static_specs):
        w, b = layer["w"], layer["b"]
        if compute_dtype is not None:
            w, b = w.to(compute_dtype), b.to(compute_dtype)
        # an f32 product of the (rounded) operands, the sum in f32
        z = torch.matmul(h.float(), w.float()) + b.float()
        h = torch.softmax(z, dim=-1) if is_softmax \
            else _activate(z, activation)
    return h


def make_train_step(layer_specs, loss="softmax", compute_dtype=None,
                    input_norm=None):
    """``step(params, x, labels) -> (params, metrics)``: ``metrics`` =
    ``{"loss": mean loss, "n_err": errors}``; new param dicts."""
    static_specs = _specs_static(layer_specs)

    def loss_fn(wb, x, labels):
        params = [{"w": w, "b": b} for (w, b) in wb]
        out = mlp_apply(params, x, static_specs,
                        compute_dtype=compute_dtype,
                        input_norm=input_norm).float()
        valid = labels >= 0
        # the PADDED batch scales the gradients, as the eager GD units
        grad_denom = x.shape[0]
        report_denom = torch.clamp(valid.sum(), min=1)
        if loss == "softmax":
            logp = torch.log(torch.clamp(out, min=1e-30))
            picked = torch.gather(
                logp, 1, torch.clamp(labels, min=0).long()[:, None])[:, 0]
            total = -(picked * valid).sum()
            n_err = ((out.argmax(dim=1) != labels) & valid).sum()
        else:
            err = (out - labels.reshape(out.shape)) ** 2
            total = (err.mean(dim=1) * valid).sum()
            n_err = None
        report = total / report_denom
        return total / grad_denom, (report if n_err is None else n_err,
                                    report)

    def step(params, x, labels):
        wb = [(layer["w"].detach().requires_grad_(True),
               layer["b"].detach().requires_grad_(True))
              for layer in params]
        with torch.enable_grad():
            value, (n_err, report) = loss_fn(wb, x, labels)
            grads = torch.autograd.grad(value, [t for pair in wb
                                                for t in pair])
        new_params = []
        with torch.no_grad():
            for i, (layer, spec) in enumerate(zip(params, static_specs)):
                (_act, _sm, lr, lr_b, decay, decay_b, moment,
                 moment_b) = spec
                gw, gb = grads[2 * i], grads[2 * i + 1]
                w, b = layer["w"], layer["b"]
                vw = moment * layer["vw"] - lr * (gw + decay * w)
                vb = moment_b * layer["vb"] - lr_b * (gb + decay_b * b)
                new_params.append({"w": w + vw, "b": b + vb,
                                   "vw": vw, "vb": vb})
        return new_params, {"loss": report.detach(),
                            "n_err": n_err.detach()}

    return step


def make_eval_step(layer_specs, loss="softmax", compute_dtype=None,
                   input_norm=None):
    static_specs = _specs_static(layer_specs)

    def evaluate(params, x, labels):
        with torch.no_grad():
            out = mlp_apply(params, x, static_specs,
                            compute_dtype=compute_dtype,
                            input_norm=input_norm)
        valid = labels >= 0
        n_err = ((out.argmax(dim=1) != labels) & valid).sum()
        return {"n_err": n_err, "n": valid.sum()}

    return evaluate


# -- lowering a live StandardWorkflow ---------------------------------------

def lower_workflow(wf):
    """``(params, step_fn)`` from a live workflow: the forwards'
    weights and the GD units' momenta (zero for a fused workflow, which
    has no GD units).  Write back with :func:`update_workflow`."""
    if not wf.forwards:
        raise ValueError("workflow has no forward units to lower")
    gds = list(reversed(wf.gds)) if wf.gds else [None] * len(wf.forwards)
    params = []
    for fwd, gdu in zip(wf.forwards, gds):
        w = numpy.array(fwd.weights.mem)
        b = numpy.array(fwd.bias.mem)
        vw = numpy.array(gdu.gradient_weights.mem) \
            if gdu is not None and gdu.gradient_weights \
            else numpy.zeros_like(w)
        vb = numpy.array(gdu.gradient_bias.mem) \
            if gdu is not None and gdu.gradient_bias \
            else numpy.zeros_like(b)
        params.append({k: torch.from_numpy(v) for k, v in (
            ("w", w), ("b", b), ("vw", vw), ("vb", vb))})
    step = make_train_step(
        wf.layers, input_norm=getattr(wf.loader, "input_norm", None))
    return params, step


def update_workflow(wf, params):
    """Write a step's parameters back into the unit graph (the forwards'
    weights, the GD units' momenta)."""
    for fwd, gdu, layer in zip(wf.forwards, reversed(wf.gds), params):
        for vec, key in ((fwd.weights, "w"), (fwd.bias, "b"),
                         (gdu.gradient_weights, "vw"),
                         (gdu.gradient_bias, "vb")):
            vec.map_write()
            vec.mem[...] = layer[key].detach().cpu().numpy()
