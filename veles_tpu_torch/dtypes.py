"""Dtype naming and policy: the port's counterpart of
:mod:`veles_tpu.dtypes`, over torch dtypes.

The axis that matters on the card is float32 against bfloat16 (the
tensor cores' operand type) with float32 accumulation.  float64 exists
for CPU debugging only: the kernel wrappers raise ``TypeError`` on a
CUDA tensor of it.  The JAX module's ``min_tile`` and ``tile_for`` are
the TPU's tiling rules ((8, 128) sublanes by lanes); the hand-written
kernels mask their own ragged edges, so the port leaves them out.
"""

import torch

#: name → torch dtype (the JAX module's table)
dtype_map = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def dtype_by_name(name):
    """The torch dtype of ``name`` (a key of :data:`dtype_map`, or a
    torch dtype as it is); raises ``TypeError`` on an unknown name."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return dtype_map[str(name)]
    except KeyError:
        raise TypeError("unknown dtype name %r (have: %s)"
                        % (name, ", ".join(sorted(dtype_map))))


def accumulation_dtype(compute):
    """The accumulator of reductions and products over ``compute``
    operands: the 16-bit floats accumulate in float32 (as the tensor
    cores do), every other type in itself."""
    compute = dtype_by_name(compute)
    if compute in (torch.float16, torch.bfloat16):
        return torch.float32
    return compute
