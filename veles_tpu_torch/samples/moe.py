"""Switch-MoE token classifier, the expert-parallel sample: embed →
switch-MoE FFN (top-1 routed, all-to-all over the ``expert`` mesh axis)
→ tied readout.  Counterpart of :mod:`veles_tpu.samples.moe`.

``init_params`` draws from ``numpy.random.default_rng(seed)`` in the
JAX table's order, so one seed gives both packages the same weights.
Over a mesh whose expert axis is sharded each rank holds its experts'
FFN (:func:`param_specs`, the leading-E convention) and its block of
the global tokens (batch rows over ``batch_axis``, positions over the
expert axis), and the FFN routes through
:func:`~veles_tpu_torch.parallel.moe.moe_mlp`; otherwise the dense
:func:`~veles_tpu_torch.parallel.moe.moe_reference` runs, the same math
at ``capacity_factor >= n_experts`` (no expert can overflow, the
default).  The train step's loss is the mean over all ``B·(T-1)``
next-token targets; each leaf's gradient is summed over the axes it is
replicated on (the router and the embedding over data and expert, the
expert stacks over data: their all-to-all backward already gathered the
expert group's tokens).  Not ported: ``param_shapes`` (a probe of the
JAX planner, ROADMAP item 7).
"""

import math

import numpy
import torch

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.parallel.moe import moe_mlp, moe_reference

CONFIG = {
    "vocab": 32000, "dim": 512, "ffn": 2048, "experts": 8,
    "seq_len": 256,
}
TINY = {
    "vocab": 64, "dim": 16, "ffn": 32, "experts": 4,
    "seq_len": 8,
}
#: SGD momentum of the training step, as in the JAX package
MOMENTUM = 0.9
_EXPERT_LED = ("w1", "b1", "w2", "b2")


def _shape_table(cfg):
    """``name -> (shape, init)``; entry order is the RNG draw order and
    the expert stacks lead with E."""
    d, f, e = cfg["dim"], cfg["ffn"], cfg["experts"]
    sq = math.sqrt
    return {
        "embed": ((cfg["vocab"], d), ("randn", 0.02)),
        "router": ((d, e), ("randn", 1 / sq(d))),
        "w1": ((e, d, f), ("randn", 1 / sq(d))),
        "b1": ((e, f), ("zeros",)),
        "w2": ((e, f, d), ("randn", 1 / sq(f))),
        "b2": ((e, d), ("zeros",)),
    }


def init_params(cfg, seed=0, dtype=numpy.float32):
    rng = numpy.random.default_rng(seed)
    out = {}
    for name, (shape, init) in _shape_table(cfg).items():
        if init[0] == "randn":
            out[name] = (rng.standard_normal(shape)
                         * init[1]).astype(dtype)
        else:
            fn = numpy.ones if init[0] == "ones" else numpy.zeros
            out[name] = fn(shape, dtype)
    return out


def moe_params(params):
    """The :func:`moe_mlp` param sub-dict (everything but the
    embedding)."""
    return {k: params[k] for k in ("router",) + _EXPERT_LED}


def param_specs(params, expert_axis="expert"):
    """Expert-stacked leaves shard their leading E over
    ``expert_axis``; the router and the embedding replicate."""
    return {name: ((expert_axis,) + (None,) * (numpy.ndim(leaf) - 1)
                   if name in _EXPERT_LED else ())
            for name, leaf in params.items()}


def _routed(mesh, expert_axis):
    return mesh is not None and mesh.shape.get(expert_axis, 1) > 1


def apply_fn(params, tokens, cfg, mesh=None, expert_axis="expert",
             capacity_factor=None):
    """tokens [B, T] (this rank's block under a mesh) → logits
    [B, T, V]."""
    if capacity_factor is None:
        capacity_factor = float(cfg["experts"])
    h = params["embed"][tokens]
    mp = moe_params(params)
    if _routed(mesh, expert_axis):
        y = moe_mlp(h, mp, mesh, expert_axis=expert_axis,
                    capacity_factor=capacity_factor)
    else:
        y = moe_reference(h, mp)
    return (h + y) @ params["embed"].t()


def make_train_step(cfg, mesh=None, expert_axis="expert", lr=1e-2,
                    capacity_factor=None):
    """``step(params, velocity, tokens) -> (params, velocity, {"loss"})``:
    next-token CE and SGD with momentum, the trees updated in place
    (this rank's shards under ``mesh``; ``tokens`` the global [B, T] on
    every rank)."""
    layout = None
    if mesh is not None:
        from veles_tpu_torch.samples.transformer import _Layout
        layout = _Layout(mesh, expert_axis)
        groups = {"shared": mesh.group("data", expert_axis),
                  "expert": mesh.group("data")}

    def loss_fn(params, tokens):
        if layout is None:
            logits = apply_fn(params, tokens, cfg,
                              capacity_factor=capacity_factor)
            logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
            return -logp.gather(-1, tokens[:, 1:, None]).mean()
        local, targets, valid, _offset = layout.rows(tokens)
        logits = apply_fn(params, local, cfg, mesh=mesh,
                          expert_axis=expert_axis,
                          capacity_factor=capacity_factor)
        if layout.n_seq == 1:
            # whole rows: the one-device loss of the rank's rows, weighed
            # by their share of the batch (the one-device step at world 1)
            logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
            share = local.shape[0] / tokens.shape[0]
            return -logp.gather(-1, local[:, 1:, None]).mean() * share
        logp = torch.log_softmax(logits.float(), dim=-1)
        picked = logp.gather(-1, targets[..., None])[..., 0]
        return -(picked * valid).sum() / (tokens.shape[0]
                                          * (tokens.shape[1] - 1))

    def step(params, velocity, tokens):
        names = list(params)
        for name in names:
            params[name].requires_grad_(True)
        device = params["embed"].device
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(numpy.asarray(tokens))
        tokens = tokens.to(device=device, dtype=torch.long)
        loss = loss_fn(params, tokens)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names])))
        loss = loss.detach()
        if layout is not None and groups["shared"] is not None:
            from veles_tpu_torch.samples.transformer import _reduce_shares
            shared = [n for n in names if n not in _EXPERT_LED]
            reduced, loss = _reduce_shares([grads[n] for n in shared],
                                           loss, groups["shared"])
            grads.update(zip(shared, reduced))
            experts = [n for n in names if n in _EXPERT_LED]
            reduced, _none = _reduce_shares(
                [grads[n] for n in experts], None, groups["expert"])
            grads.update(zip(experts, reduced))
        with torch.no_grad():
            for name in names:
                velocity[name].mul_(MOMENTUM).sub_(lr * grads[name])
                params[name].add_(velocity[name])
        return params, velocity, {"loss": loss}

    return step


def build_train(cfg=None, mesh=None, expert_axis="expert",
                batch_axis="data", lr=1e-2, seed=0, capacity_factor=None,
                device=None):
    """``(params, velocity, step)`` on ``device`` (the card when None);
    with ``mesh`` each rank holds its experts (:func:`param_specs`).
    ``batch_axis`` must be ``"data"``, the axis the step's rows follow."""
    if batch_axis != "data":
        raise ValueError("the MoE step shards its batch over 'data', "
                         "not %r" % (batch_axis,))
    cfg = cfg or CONFIG
    device = resolve_device(device)
    host = init_params(cfg, seed=seed)
    if mesh is not None:
        from veles_tpu_torch.parallel.mesh import shard
        specs = param_specs(host, expert_axis)
        host = {k: shard(v, specs[k], mesh) for k, v in host.items()}
    params = {k: torch.tensor(v, device=device) for k, v in host.items()}
    velocity = {k: torch.zeros_like(v) for k, v in params.items()}
    step = make_train_step(cfg, mesh=mesh, expert_axis=expert_axis, lr=lr,
                           capacity_factor=capacity_factor)
    return params, velocity, step


def train_step_flops(cfg, batch):
    """Analytic FLOPs of one MoE train step (forward + backward ≈ 3× the
    forward products); top-1 routing visits one expert a token."""
    d, f, e, s, v = (cfg["dim"], cfg["ffn"], cfg["experts"],
                     cfg["seq_len"], cfg["vocab"])
    per_token = (2.0 * d * e          # router
                 + 4.0 * d * f        # one expert's up + down
                 + 2.0 * d * v)       # tied readout
    return 3.0 * batch * s * per_token


def synthetic_tokens(cfg, batch, seed=0):
    rng = numpy.random.default_rng(seed)
    return rng.integers(0, cfg["vocab"],
                        (batch, cfg["seq_len"])).astype(numpy.int32)
