"""Kernels written by hand for Hopper, each beside its plain PyTorch
version.

- ``veles_tpu/ops/attention.py`` ``_attn_kernel`` (flash forward) →
  :func:`veles_tpu_torch.ops.attention.flash_attention`, CUDA C++ in
  ``csrc/flash_fwd.cu``;
- ``veles_tpu/ops/attention.py`` ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel`` (flash backward) → the backward of
  :func:`veles_tpu_torch.ops.attention.flash_attention` under autograd,
  CUDA C++ in ``csrc/flash_bwd.cu``;
- ``veles_tpu/ops/attention.py`` ``_decode_kernel`` (decode / verify) →
  :func:`veles_tpu_torch.ops.attention.decode_attention`, CUDA C++ in
  ``csrc/decode_attn.cu``;
- ``veles_tpu/ops/attention.py`` ``_paged_decode_kernel`` (decode /
  verify through block tables) →
  :func:`veles_tpu_torch.ops.attention.paged_decode_attention` and
  :func:`~veles_tpu_torch.ops.attention.paged_verify_attention`, the
  second entry of ``csrc/decode_attn.cu``;
- ``veles_tpu/ops/gemm.py`` ``_matmul_kernel`` →
  :func:`veles_tpu_torch.ops.gemm.matmul`, and ``_gd_dx_kernel``,
  ``_gd_dw_kernel``, ``_gd_db_kernel`` (the bias step, in dw's launch)
  → :func:`veles_tpu_torch.ops.gemm.gd_fused`, CUDA C++ in
  ``csrc/gemm.cu``;
- ``veles_tpu/ops/gather.py`` ``_gather_kernel`` and
  ``_gather_norm_kernel`` → :func:`veles_tpu_torch.ops.gather.take_rows`,
  :func:`~veles_tpu_torch.ops.gather.take_rows_norm` and
  :func:`~veles_tpu_torch.ops.gather.take_rows_group` (a minibatch's
  tables in one launch) and
  :func:`~veles_tpu_torch.ops.gather.take_rows_served` (the stitched
  loader head's: the served index computed in the same launch), CUDA
  C++ in ``csrc/gather.cu``;
- ``veles_tpu/ops/qgemm.py`` ``_qmatmul_kernel`` (the int8 W8A16 GEMM)
  → :func:`veles_tpu_torch.ops.qgemm.qmatmul`, CUDA C++ in
  ``csrc/qgemm.cu``;
- ``veles_tpu/ops/reduce.py`` ``_reduce_kernel`` →
  :func:`veles_tpu_torch.ops.reduce.matrix_reduce` (under
  ``root.common.engine.pallas_reduce`` or ``use_pallas=True``), CUDA C++
  in ``csrc/reduce.cu``;
- ``veles_tpu/ops/random.py`` ``_uniform_kernel`` →
  :func:`veles_tpu_torch.ops.random.uniform_pallas`, CUDA C++ in
  ``csrc/random.cu``.

The CUDA sources are compiled by :mod:`veles_tpu_torch.ops.build` at
first use on the card; nothing here builds or imports a compiler when
the package is imported.  A wrapper runs its plain version only for
CPU tensors; for CUDA tensors it launches its kernel or raises.
"""

from veles_tpu_torch.ops.random import normal, uniform  # noqa: F401
from veles_tpu_torch.ops.reduce import matrix_reduce  # noqa: F401
from veles_tpu_torch.ops.util import on_gpu  # noqa: F401
