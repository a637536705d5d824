"""Expert parallelism: a mixture-of-experts MLP over an ``expert`` mesh
axis.  Counterpart of :mod:`veles_tpu.parallel.moe`.

Top-1 (switch) routing: a router scores each token and the token's FFN
runs on the rank that holds its expert.  Tokens travel by
``all_to_all_single`` both ways (:func:`~veles_tpu_torch.parallel.comm
.all_to_all_grad`, its own transpose in the backward), with a static
capacity per expert: the JAX rule ``max(1, int(capacity_factor *
tokens / n_experts))`` over this rank's tokens, slots given in token
order, and a token past its expert's capacity dropped (it contributes
zero and passes through the caller's residual).

The expert products are batched einsums, as they are outside any Pallas
kernel in the JAX package.
"""

import torch
import torch.nn.functional as F


def _one_hot_capacity(expert_idx, n_experts, capacity):
    """Each token's slot in its expert's buffer (its rank among the
    tokens routed there, in order), or ``capacity`` when it overflows:
    ``(slot, keep)``."""
    onehot = F.one_hot(expert_idx, n_experts)
    ranks = torch.cumsum(onehot, dim=0) - 1
    slot = ranks.gather(1, expert_idx[:, None])[:, 0]
    keep = slot < capacity
    return torch.where(keep, slot, capacity), keep


def _route(x, router_w):
    probs = torch.softmax((x @ router_w).float(), dim=-1)
    expert_idx = probs.argmax(dim=-1)
    gate = probs.gather(1, expert_idx[:, None])[:, 0]
    return expert_idx, gate


def _experts(tokens, w1, b1, w2, b2, dtype):
    """The batched expert FFN: tokens [E, C, D] → [E, C, D]."""
    h = F.gelu(torch.einsum("ecd,edf->ecf", tokens, w1).float()
               + b1[:, None], approximate="tanh")
    return (torch.einsum("ecf,efd->ecd", h.to(dtype), w2).float()
            .to(dtype) + b2[:, None])


def _moe_local(x, router_w, w1, b1, w2, b2, group, n_dev,
               capacity_factor):
    """This rank's body: x [T_local, D]; the rank holds ``w1.shape[0]``
    experts."""
    from veles_tpu_torch.parallel.comm import all_to_all_grad
    exp_per_dev = w1.shape[0]
    n_exp = n_dev * exp_per_dev
    tokens, d = x.shape
    capacity = max(1, int(capacity_factor * tokens / n_exp))

    expert_idx, gate = _route(x, router_w)
    slot, keep = _one_hot_capacity(expert_idx, n_exp, capacity)
    # the send buffer [n_exp, capacity (+ the overflow row), D]
    buf = torch.zeros((n_exp, capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    buf = buf.index_put((expert_idx, slot),
                        torch.where(keep[:, None], x, 0.0))
    buf = buf[:, :capacity].reshape(n_dev, exp_per_dev, capacity, d)
    recv = all_to_all_grad(buf, group) if group is not None else buf
    # [n_dev (source), exp_per_dev, cap, D] → the experts' batches
    recv = recv.transpose(0, 1).reshape(exp_per_dev, n_dev * capacity, d)
    out = _experts(recv, w1, b1, w2, b2, x.dtype)
    out = out.reshape(exp_per_dev, n_dev, capacity, d).transpose(0, 1)
    back = all_to_all_grad(out, group) if group is not None else out
    back = back.reshape(n_exp, capacity, d)
    y = back[expert_idx, torch.clamp(slot, max=capacity - 1)]
    return torch.where(keep[:, None], y * gate[:, None].to(x.dtype), 0.0)


def moe_mlp(x, params, mesh, expert_axis="model", batch_axis="data",
            capacity_factor=2.0):
    """Expert-parallel switch MLP on this rank's shards: ``x`` [B, T, D]
    (B over ``batch_axis``, T over ``expert_axis``); ``params``:
    ``router`` [D, E] (replicated), ``w1`` [E, D, F], ``b1`` [E, F],
    ``w2`` [E, F, D], ``b2`` [E, D] (this rank's experts: E over the
    expert axis).  Returns [B, T, D] without the residual."""
    del batch_axis
    n_dev = mesh.shape.get(expert_axis, 1)
    b, t, d = x.shape
    y = _moe_local(x.reshape(-1, d), params["router"], params["w1"],
                   params["b1"], params["w2"], params["b2"],
                   mesh.group(expert_axis), n_dev, capacity_factor)
    return y.reshape(b, t, d)


def moe_reference(x, params):
    """Dense single-device reference: every token through its argmax
    expert with no capacity limit."""
    b, t, d = x.shape
    flat = x.reshape(-1, d)
    idx, gate = _route(flat, params["router"])
    h = F.gelu(torch.einsum("td,edf->tef", flat, params["w1"])
               + params["b1"], approximate="tanh")
    y_all = torch.einsum("tef,efd->ted", h, params["w2"]) + params["b2"]
    y = y_all.gather(1, idx[:, None, None].expand(-1, 1, d))[:, 0]
    return (y * gate[:, None]).reshape(b, t, d).to(x.dtype)
