"""Device resolution, the workflow devices and the card's published rates.

Every entry point of the port runs on the CUDA card unless the caller
asks for ``device="cpu"``; without a card and without that request it
raises instead of carrying on on the CPU.  The H100 numbers below are
data for the roofline bound (the least time the card could take for a
function's bytes and operations), from NVIDIA's H100 SXM data sheet:
dense rates, no sparsity, at the full 700 W power limit.

The workflow devices are the counterpart of :mod:`veles_tpu.backends`:
``CUDADevice`` (the card; the JAX package's ``TPUDevice``) and
``CPUDevice`` (the same unit code over CPU tensors, where every kernel
wrapper takes its plain version).  The JAX package's ``NumpyDevice``
(a second host path of per-unit numpy code) is deliberately not ported:
``CPUDevice`` is the port's one host route.  The autotune DB, meshes
and the compilation cache are not ported: the port's kernels take no
measured tiles.
"""

import numpy
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
    float32 reference: TF32 keeps about three decimal digits.

    The JAX package maps ``root.common.engine.precision_level`` to XLA
    matmul precision (level 0: bf16 passes on a TPU).  The port's GEMM
    and GD kernels compute full f32 at every level, and the plain
    versions run with TF32 off, so the level selects nothing yet."""
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


class Device(object):
    """A workflow device: where the units' ``Vector`` buffers live and
    how they move there and back."""

    @property
    def torch_device(self):
        return None

    def put(self, array):
        """A copy of the host array on this device (never a view: an
        in-place update must not write through to the host buffer)."""
        return torch.from_numpy(numpy.array(array)).to(self.torch_device)

    def put_into(self, tensor, array):
        """Copy the host array into ``tensor`` on this device, keeping
        its address."""
        tensor.copy_(torch.from_numpy(
            numpy.require(array, requirements="CW")))

    def get(self, tensor):
        """A host numpy copy of a tensor on this device."""
        return tensor.detach().to("cpu").numpy().copy()

    def sync(self):
        """Wait until the work queued on this device has finished."""

    def __repr__(self):
        return "<%s %s>" % (type(self).__name__, self.torch_device)


class CUDADevice(Device):
    """The CUDA card (raises without one)."""

    def __init__(self, device="cuda"):
        self._device = resolve_device(device)
        if self._device.type != "cuda":
            raise ValueError("CUDADevice needs a cuda device, got %s"
                             % self._device)

    @property
    def torch_device(self):
        return self._device

    def sync(self):
        torch.cuda.synchronize(self._device)


class CPUDevice(Device):
    """CPU tensors: the units run the same code as on the card, and
    every kernel wrapper takes its plain PyTorch version."""

    @property
    def torch_device(self):
        return torch.device("cpu")


def make_device(device=None):
    """A workflow device from what an entry point was given: ``None`` →
    the card (raises without one); ``"cpu"``, ``"cuda"``, a
    ``torch.device`` or a :class:`Device` as asked."""
    if isinstance(device, Device):
        return device
    if device is None:
        return CUDADevice()
    resolved = resolve_device(device)
    if resolved.type == "cpu":
        return CPUDevice()
    return CUDADevice(resolved)
