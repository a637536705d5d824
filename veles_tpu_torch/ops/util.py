"""Shared helpers for the kernel wrappers."""

import torch


def on_gpu(*tensors):
    """True when every tensor lies on a CUDA device, False when every
    one lies on the CPU; raises on a mix (a wrapper must never move
    data between the two behind the caller's back)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError("kernel inputs on mixed devices: %s"
                     % sorted(kinds))


def check_status(name, status):
    """Raise when a kernel's C entry reported a CUDA error (its return
    value is ``cudaGetLastError()`` right after the launch)."""
    if status:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, status))


def stream_handle(device):
    """PyTorch's current CUDA stream on ``device``, as an int for
    ``ctypes``: every kernel launches on it and does not synchronise."""
    return torch.cuda.current_stream(device).cuda_stream
