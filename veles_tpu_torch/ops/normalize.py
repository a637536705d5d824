"""Mean-dispersion normalization, ``(x - mean) * disp`` broadcast over
the batch: the port's counterpart of :mod:`veles_tpu.ops.normalize`.

The JAX package leaves it to XLA to fuse into its consumer; here it is
the same three elementwise torch ops, on the tensors' device.
"""

import torch


def mean_disp_normalize(x, mean, disp, dtype=None):
    """``x``: (B, ...features); ``mean`` / ``disp``: (...features).
    Computed in float32, returned in ``dtype`` (default ``x``'s)."""
    out = (x.to(torch.float32) - mean.to(torch.float32)) \
        * disp.to(torch.float32)
    return out.to(dtype or x.dtype)
