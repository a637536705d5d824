"""Per-sample concatenation of N buffers: the port's counterpart of
:mod:`veles_tpu.ops.join`.  Each (B, ...) input is flattened to (B, -1),
then all are concatenated along the features (one ``torch.cat``)."""

import torch


def join(arrays, axis=1):
    """Concatenate per sample: each input flattened to (B, -1)."""
    flat = [a.reshape(a.shape[0], -1) for a in arrays]
    return torch.cat(flat, dim=axis)
