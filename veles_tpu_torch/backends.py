"""Device resolution and the card's published rates.

Every entry point of the port runs on the CUDA card unless the caller
asks for ``device="cpu"``; without a card and without that request it
raises instead of carrying on on the CPU.  The H100 numbers below are
data for the roofline bound (the least time the card could take for a
function's bytes and operations), from NVIDIA's H100 SXM data sheet:
dense rates, no sparsity, at the full 700 W power limit.
"""

import torch

#: H100 SXM device memory and its rate
H100_HBM_BYTES = 80 * 10 ** 9
H100_HBM_BYTES_PER_S = 3.35e12
#: dense peak operation rates by operand type (operations per second)
H100_PEAK_OPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,       # CUDA cores, outside the tensor cores
    "fp8": 1979e12,
    "int8": 1979e12,
}


def resolve_device(device=None):
    """``None`` → ``cuda`` (raises without a card); ``"cpu"`` or any
    explicit device string/``torch.device`` is taken as asked."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "veles_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return device


def set_precision():
    """Pin full-float32 matrix products (no TF32) for parity with the
    float32 reference: TF32 keeps about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def bound_seconds(nbytes, ops, dtype="bfloat16"):
    """The roofline bound of one call: the larger of its bytes over the
    memory rate and its operations over the peak rate for ``dtype``.
    Returns ``(seconds, "bytes" | "operations")``."""
    t_bytes = float(nbytes) / H100_HBM_BYTES_PER_S
    t_ops = float(ops) / H100_PEAK_OPS[dtype]
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"
