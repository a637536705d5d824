"""HOG (histogram of oriented gradients) features: the port's
counterpart of :mod:`veles_tpu.ops.hog`.

:func:`hog_batch` computes the descriptor of a whole batch at once in
torch (the JAX package ``vmap``s its one-image function), on the
batch's device; :func:`hog` is one image.  The arithmetic is the JAX
function's: centred gradients (zero at the border), ``1e-12`` inside
the magnitude's square root and the angle 0 on flat pixels (``gx = gy =
0``), the unsigned orientation in ``[0, π)`` (a floored remainder, as
``jnp.mod``), each pixel's magnitude soft-assigned to its two nearest
bins, cells of ``cell`` pixels (the image truncated to whole cells),
blocks of ``block`` cells sliding by one cell and L2-normalized, and an
image smaller than one block taken as one block.  RGB is averaged to
gray first.
"""

import math

import torch
import torch.nn.functional as F


def _floor_mod(x, y):
    """``jnp.mod``'s floored remainder (the sign of ``y``)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def hog_batch(images, orientations=9, cell=8, block=2, eps=1e-6):
    """HOG descriptors of (B, H, W) grayscale images, or (B, H, W, C)
    (the channels averaged first): (B, features) float32."""
    images = torch.as_tensor(images).to(torch.float32)
    if images.dim() == 4:
        images = images.mean(dim=-1)
    batch, h, w = images.shape
    gx = torch.zeros_like(images)
    gx[:, :, 1:-1] = images[:, :, 2:] - images[:, :, :-2]
    gy = torch.zeros_like(images)
    gy[:, 1:-1, :] = images[:, 2:, :] - images[:, :-2, :]
    sq = gx * gx + gy * gy
    magnitude = torch.sqrt(sq + 1e-12)
    flat_px = sq == 0.0
    gx_safe = torch.where(flat_px, torch.ones_like(gx), gx)
    pi = torch.tensor(math.pi, dtype=torch.float32, device=images.device)
    angle = _floor_mod(torch.where(flat_px, torch.zeros_like(gx),
                                   torch.atan2(gy, gx_safe)), pi)

    n_cy, n_cx = h // cell, w // cell
    hy, wx = n_cy * cell, n_cx * cell
    magnitude = magnitude[:, :hy, :wx]
    angle = angle[:, :hy, :wx]

    bin_width = pi / orientations
    pos = angle / bin_width - 0.5
    lo = torch.floor(pos)
    frac = pos - lo
    n_o = torch.tensor(float(orientations), device=images.device)
    lo_bin = _floor_mod(lo, n_o).to(torch.int64)
    hi_bin = _floor_mod(lo + 1, n_o).to(torch.int64)
    votes = F.one_hot(lo_bin, orientations).to(torch.float32) \
        * (magnitude * (1.0 - frac))[..., None] \
        + F.one_hot(hi_bin, orientations).to(torch.float32) \
        * (magnitude * frac)[..., None]            # (B, hy, wx, o)
    cells = votes.reshape(batch, n_cy, cell, n_cx, cell,
                          orientations).sum(dim=(2, 4))

    if n_cy < block or n_cx < block:   # an image smaller than one block
        blocks = cells[:, None, None]
    else:
        n_by, n_bx = n_cy - block + 1, n_cx - block + 1
        dev = images.device
        rows = torch.arange(n_by, device=dev)[:, None] \
            + torch.arange(block, device=dev)[None, :]
        cols = torch.arange(n_bx, device=dev)[:, None] \
            + torch.arange(block, device=dev)[None, :]
        blocks = cells[:, rows[:, None, :, None], cols[None, :, None, :]]
        # (B, n_by, n_bx, block, block, o)
    flat = blocks.reshape(batch, blocks.shape[1], blocks.shape[2], -1)
    norm = torch.sqrt((flat * flat).sum(-1, keepdim=True) + eps * eps)
    return (flat / norm).reshape(batch, -1)


def hog(image, orientations=9, cell=8, block=2, eps=1e-6):
    """The HOG descriptor of one grayscale image (H, W): flat
    features."""
    return hog_batch(torch.as_tensor(image)[None], orientations=orientations,
                     cell=cell, block=block, eps=eps)[0]
