"""Device resolution, the workflow devices and the card's published rates.

Every entry point of the port runs on the CUDA card unless the caller
asks for ``device="cpu"``; without a card and without that request it
raises instead of carrying on on the CPU.  The H100 numbers below are
data for the roofline bound (the least time the card could take for a
function's bytes and operations) and the performance ledger's MFU
denominators (:func:`peak_ops`), from NVIDIA's H100 SXM data sheet:
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

#: the MFU denominators by card (a substring of
#: ``torch.cuda.get_device_name``, lower case) and operand type: the
#: counterpart of the JAX package's per-generation ``PEAK_BF16_FLOPS``
#: and ``PEAK_INT8_OPS``, keyed by type because the MNIST kernels
#: compute f32 on the FMA units and the serving kernels bf16 on the
#: tensor cores
PEAK_FLOPS = (("h100", H100_PEAK_OPS),)

#: the ledger's ``peak_dtype`` names -> the table's operand type.  None
#: is the session's bf16 rate, as in the JAX package.  The quantized
#: programs' ``"int8"`` maps to the bf16 rate, not the int8 one: the
#: W8A16 qmatmul widens its int8 weights and runs bf16 products on the
#: tensor cores (``csrc/qgemm.cu``), so bf16 is the rate it could reach.
PEAK_DTYPES = {None: "bfloat16", "bfloat16": "bfloat16", "tf32": "tf32",
               "float32": "float32", "int8": "bfloat16"}


def peak_ops(device_kind, dtype=None):
    """The card's dense peak rate for ``dtype`` (a ``PEAK_DTYPES`` name),
    or None for a CPU or a card the table lacks."""
    kind = (device_kind or "").lower()
    for tag, rates in PEAK_FLOPS:
        if tag in kind:
            return rates[PEAK_DTYPES[dtype]]
    return None


def peak_bf16_flops(device_kind):
    """Peak dense bf16 FLOP/s of a card, or None."""
    return peak_ops(device_kind, "bfloat16")


def peak_int8_ops(device_kind):
    """The quantized programs' denominator: the bf16 rate their
    tensor-core products run at (see :data:`PEAK_DTYPES`), or None."""
    return peak_ops(device_kind, "int8")


def card_label():
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (every MFU stands beside it), or None where it does not run."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else None


def resolve_device(device=None):
    """``None`` → ``cuda`` (raises without a card); ``"cpu"`` or any
    explicit device string/``torch.device`` is taken as asked.  Every
    entry point of the port (the generative model and engine, the
    workflow devices, the ops that allocate) resolves its device here,
    so a card's matmul precision follows ``precision_level`` through
    :func:`set_precision` on each of them."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "veles_tpu_torch runs on a CUDA card by default and none "
                "is available; pass device='cpu' to run the plain "
                "PyTorch path")
        set_precision()
    return device


def set_precision():
    """Map ``root.common.engine.precision_level`` onto the float32
    matmul switches of cuBLAS and cuDNN and cuDNN's choice of
    algorithms, and return the level.

    The JAX package maps the level to XLA's matmul precision
    (``veles_tpu/ops/gemm.py`` ``_precision``): 0 → one bf16 pass on a
    TPU, 1 → three bf16 passes (bf16_3x), 2 → full f32.  Here level 0
    allows TF32 in cuBLAS and cuDNN, the card's counterpart of one bf16
    pass (about three decimal digits); levels 1 and 2 turn TF32 off and
    give full f32, since cuBLAS has no counterpart of bf16_3x.  The
    switches are process-wide and touch only the library and plain
    paths: the hand-written GEMM, GD and qmatmul kernels compute f32 at
    every level.  Levels 1 and 2 also pin cuDNN to deterministic
    algorithms (``cudnn.deterministic``, no ``benchmark`` search): with
    them two card runs of the conv workflow give the same bits, where
    cuDNN's own picks left them 7.2e-5 apart after 2 epochs of
    ``mnist_conv``, for 1.8 % of AlexNet f32's images/s
    (``scripts/conv_drift_probe.py`` on an H100); level 0 leaves cuDNN
    free.  On the CPU the level changes nothing, as XLA on the CPU
    computes f32 at level 0 too.  :func:`resolve_device` calls this
    for every card it resolves; the JAX package reads the level on every
    matmul, so a level set later takes effect at the next entry point
    (or a direct call here)."""
    from veles_tpu_torch.config import root
    level = int(root.common.engine.get("precision_level", 0))
    if level not in (0, 1, 2):
        raise ValueError("precision_level must be 0, 1 or 2, got %d"
                         % level)
    tf32 = level == 0
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = not tf32
    if not tf32:
        torch.backends.cudnn.benchmark = False
    return level


def check_kernels(route):
    """Refuse ``root.common.engine.kernels = "xla"`` for ``route``.  The
    JAX package reads the knob where it picks the transformer's
    attention and the GD units' backend: "xla" takes its dense jnp
    references there, a route the port has not ported (the bench
    ladder's baseline arm).  "auto" and "pallas" both take the port's
    kernels."""
    from veles_tpu_torch.config import root
    mode = str(root.common.engine.get("kernels", "auto") or "auto")
    if mode.lower() == "xla":
        raise NotImplementedError(
            "engine.kernels='xla' (%s) is not ported to veles_tpu_torch "
            "yet (ROADMAP.md, 'Slices still to port', item 7)" % route)


def check_pallas_knob(knob, route, is_off):
    """Refuse ``root.common.engine.<knob>`` (``pallas_gemm`` or
    ``pallas_gather``) when it is set and ``is_off(value)``: the caller
    says which values pick the JAX package's XLA route for ``route``,
    as ``veles_tpu/ops/gemm.py``, ``qgemm.py`` and ``gather.py`` read
    them.  That route is not ported, as :func:`check_kernels` refuses
    ``kernels="xla"``.  Unset, or set to a value that keeps the kernel,
    the port launches its kernel."""
    from veles_tpu_torch.config import root
    value = root.common.engine.get(knob, None)
    if value is not None and is_off(value):
        raise NotImplementedError(
            "engine.%s=%r (%s) is not ported to veles_tpu_torch yet "
            "(ROADMAP.md, 'Slices still to port', item 7)"
            % (knob, value, route))


def bound_seconds(nbytes, ops, dtype="bfloat16"):
    """The roofline bound of one call: the larger of its bytes over the
    memory rate and its operations over the peak rate for ``dtype``.
    Returns ``(seconds, "bytes" | "operations")``."""
    t_bytes = float(nbytes) / H100_HBM_BYTES_PER_S
    t_ops = float(ops) / H100_PEAK_OPS[dtype]
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def _detached_device():
    """What a pickled :class:`Device` loads as: None."""
    return None


class Device(object):
    """A workflow device: where the units' ``Vector`` buffers live and
    how they move there and back.

    A device is a handle of the process that made it: it pickles as
    None, so a snapshot names no torch object and loads without a card,
    and ``initialize(device=...)`` of the loaded workflow attaches it
    (to the card when no device is given)."""

    def __reduce__(self):
        return (_detached_device, ())

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

    # -- dtype policy -------------------------------------------------------
    @property
    def compute_dtype(self):
        """The torch dtype of the fused trainer's products:
        ``root.common.engine.precision_type`` ("float32" by default,
        "bfloat16" for the tensor cores); ``precision_level`` is the
        separate f32 robustness knob."""
        from veles_tpu_torch.config import root
        from veles_tpu_torch.dtypes import dtype_by_name
        return dtype_by_name(
            root.common.engine.get("precision_type", "float32"))

    @property
    def storage_dtype(self):
        """The dtype of persistent parameters (the master copy), as the
        JAX package names it: ``precision_type`` too.  The fused trainer
        keeps its master weights and momenta in float32 whatever it
        says."""
        return self.compute_dtype

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


#: ``root.common.engine.backend`` values, as the JAX package names them
BACKENDS = ("auto", "cpu", "numpy", "tpu")


def make_device(device=None):
    """A workflow device from what an entry point was given: ``"cpu"``,
    ``"cuda"``, a ``torch.device`` or a :class:`Device` as asked.
    ``None`` reads ``root.common.engine.backend``, as the JAX package's
    ``make_device`` does: ``"auto"`` (the default) and ``"tpu"`` (the
    JAX package's accelerator backend) are the card, raising without
    one; ``"cpu"`` is :class:`CPUDevice`, asked for by the config and
    not a fallback; ``"numpy"`` raises ``NotImplementedError``, since
    ``NumpyDevice`` is not ported by decision; any other value raises
    the JAX package's ``ValueError``."""
    if isinstance(device, Device):
        return device
    if device is None:
        from veles_tpu_torch.config import root
        backend = str(root.common.engine.get("backend", "auto")
                      or "auto").lower()
        if backend not in BACKENDS:
            raise ValueError("unknown backend %r (have: %s)"
                             % (backend, ", ".join(BACKENDS)))
        if backend == "numpy":
            raise NotImplementedError(
                "root.common.engine.backend='numpy': NumpyDevice is not "
                "ported by decision (ROADMAP.md, 'Slices still to port', "
                "item 1); use 'cpu'")
        if backend == "cpu":
            return CPUDevice()
        return CUDADevice()
    resolved = resolve_device(device)
    if resolved.type == "cpu":
        return CPUDevice()
    return CUDADevice(resolved)
