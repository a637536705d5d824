"""The pricing core's HBM half: the budget rule and the bytes of a
params tree, over the card that is present.

The port's counterpart of :mod:`veles_tpu.analyze.pricing`, trimmed to
the four functions rule V-S01 prices a generative deploy with
(:func:`veles_tpu_torch.analyze.shapes.check_generative`).  The pod
residency and the planner's helpers wait for ROADMAP item 7(e), with
the JAX collective byte formulas, which price the gradient all-reduce
GSPMD derives: the port's pod issues other collectives and counts what
they move where it issues them (:mod:`veles_tpu_torch.parallel.comm`).
Pure host arithmetic: no kernel, no copy.
"""

import torch

#: The one headroom rule: plans may spend 90 % of device memory; the
#: rest is runtime scratch (the caching allocator's blocks, workspaces)
HEADROOM = 0.9


def resolve_device_hbm(hbm_bytes=None, device=None):
    """``hbm_bytes`` override, else the live card's memory
    (``torch.cuda.get_device_properties(device).total_memory``, the
    current card when ``device`` is None); ``None`` without a card or
    for a CPU device, which degrades every consumer to plan sanity, as
    the JAX package does on an unknown device."""
    if hbm_bytes is not None:
        return hbm_bytes
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(
        torch.cuda.current_device() if device is None
        else torch.device(device)).total_memory)


def hbm_budget(hbm_bytes):
    """The shared budget rule: ``HEADROOM × hbm_bytes``, or ``None``
    when the device's memory is unknown (plan-sanity-only mode)."""
    if not hbm_bytes:
        return None
    return HEADROOM * float(hbm_bytes)


def leaf_nbytes(leaf):
    """Actual bytes of one leaf, a tensor or a numpy array (0 for
    anything else)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    try:
        return int(leaf.size) * int(leaf.dtype.itemsize)
    except AttributeError:
        return 0


def params_nbytes(tree):
    """Total actual bytes of a params tree, the V-S01 params term:
    quantized leaves count at their real width, and each tensor storage
    once (:func:`veles_tpu_torch.quant.tree_nbytes`): at a bf16 compute
    dtype the served tree's readout copy of the embedding is its own
    storage, at float32 it aliases the embedding (``embed_cd``)."""
    from veles_tpu_torch.quant import tree_nbytes
    return tree_nbytes(tree)
