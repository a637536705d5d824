"""The regularization and iRprop− helpers of the fused lowering: the
port's counterpart of :mod:`veles_tpu.znicz.gd_base` (``reg_term``,
``ortho_grad`` and ``rprop_update``, ``:255-298``), over torch tensors.

The unit classes of the JAX module (``GDViaVJP``, ``GDRProp``,
``GDGeneric``: the backward units of conv, pooling, ``rprop_all2all``
and the forward-only layers) come with the layer zoo (ROADMAP item
7(c)).
"""

import torch


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
