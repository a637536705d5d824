"""The bf16 GEMM's plan and the plain model of its split sums, on the CPU.

``veles_matmul_bf16`` (``veles_tpu_torch/csrc/gemm_bf16.cu``) has two
bodies, picked before each launch by ``ops.gemm.plan_bf16`` from the
shape, the strides and the base addresses: body W (TMA + ``wgmma``)
where TMA can describe both operands, body S (``cp.async`` +
``ldmatrix`` + ``mma.sync``) elsewhere, each with K split over a thread
block cluster and the partial tiles summed in rank order.  The kernels
run only on the card (``chip_smoke.py``'s ``kernels`` phase holds them);
here:

- the plan maps every product of the main path's shape table (the fused
  MNIST step's bf16 products, AlexNet's fc6 / fc7 products at batch 128
  with their transposed views, 4096^3) to its body, tile and split; TMA
  is refused for a 200-byte row pitch, an unaligned base and a non-unit
  inner stride; a split grid stays one wave and every rank keeps a K
  tile;
- ``_matmul_bf16_split_ref`` (each rank's f32 partial over its
  ``k_range``, summed in rank order, the epilogue, one rounding) agrees
  with the JAX package's ``_matmul_jnp`` in bf16 and with
  ``_matmul_kernel`` run by ``_matmul_pallas`` in interpret mode within
  BF16_GEMM_TOL, at every split the plan gives the table, for every
  activation with and without the bias.
"""

import functools

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.ops.gemm import _matmul_jnp, _matmul_pallas
from veles_tpu_torch.ops import gemm

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

#: one bf16 ulp (2^-7 relative) and 2^-8 absolute: two f32 summation
#: orders may round an output near a bf16 boundary to either side
BF16_GEMM_TOL = (2.0 ** -8, 2.0 ** -7)
ACTIVATIONS = (None, "tanh", "sigmoid", "relu", "strict_relu")
S, W = gemm.BF16_BODY_S, gemm.BF16_BODY_W

#: the main path's products: name, (M, K, N), the strides (a.stride(0),
#: a.stride(1), w.stride(0), w.stride(1)) of the layouts it passes, and
#: the (body, tile, split) the plan must give.  MNIST's w (784, 100) and
#: delta (100, 100) have a 200-byte row pitch (body S); AlexNet's weight
#: gradients read x^T (M-major), its input gradients W^T (K-major)
TABLE = (
    ("mnist_fwd", (100, 784, 100), (784, 1, 100, 1), (S, 64, 8)),
    ("mnist_dw", (784, 100, 100), (1, 784, 100, 1), (S, 64, 2)),
    ("fc6_fwd", (128, 9216, 4096), (9216, 1, 4096, 1), (W, 128, 2)),
    ("fc6_dx", (128, 4096, 9216), (4096, 1, 1, 4096), (W, 128, 1)),
    ("fc6_dw", (9216, 128, 4096), (1, 9216, 4096, 1), (W, 256, 1)),
    ("fc7_fwd", (128, 4096, 4096), (4096, 1, 4096, 1), (W, 128, 2)),
    ("fc7_dx", (128, 4096, 4096), (4096, 1, 1, 4096), (W, 128, 2)),
    ("fc7_dw", (4096, 128, 4096), (1, 4096, 4096, 1), (W, 256, 1)),
    ("big", (4096, 4096, 4096), (4096, 1, 4096, 1), (W, 256, 1)),
)
#: a 16-byte aligned base address
ALIGNED = 1 << 20


def _plan(shape, strides, ptrs=(ALIGNED, ALIGNED)):
    m, k, n = shape
    return gemm.plan_bf16(m, n, k, strides, ptrs)


@pytest.mark.parametrize("name,shape,strides,want", TABLE,
                         ids=[row[0] for row in TABLE])
def test_plan_maps_the_shape_table(name, shape, strides, want):
    """Each product's body, tile and split; every rank of a split keeps a
    K tile; body W's split grid stays within the blocks the split rule
    allows (fewer than one wave) and is the largest such split; body S's
    split stops once the grid covers the SMs."""
    m, k, n = shape
    body, tile, split = _plan(shape, strides)
    assert (body, tile, split) == want
    k_tiles = -(-k // gemm.BF16_BLOCK_K)
    ranges = [gemm.k_range(r, split, k, block_k=gemm.BF16_BLOCK_K)
              for r in range(split)]
    assert all(end > begin for begin, end in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    tiles = -(-m // gemm.BF16_BLOCK_M[body]) * -(-n // tile)
    more = split < 8 and k_tiles >= 2 * split
    if body == W:
        assert tiles * split <= gemm._BF16_SPLIT_BLOCKS < gemm._SMS \
            or split == 1
        assert not more or tiles * 2 * split > gemm._BF16_SPLIT_BLOCKS \
            or tile == 256
    else:
        assert not more or tiles * split >= gemm._SMS


def _refused_operands():
    pitch = torch.zeros((784, 100), dtype=torch.bfloat16)
    base = torch.zeros((64, 808), dtype=torch.bfloat16)[:, 1:]
    inner = torch.zeros((64, 256), dtype=torch.bfloat16)[:, ::2]
    return {"200_byte_pitch": pitch, "unaligned_base": base,
            "non_unit_inner_stride": inner}


@pytest.mark.parametrize("case", ["200_byte_pitch", "unaligned_base",
                                  "non_unit_inner_stride"])
def test_tma_refuses_what_it_cannot_describe(case):
    """TMA needs a 16-byte aligned base, one unit stride and the other a
    multiple of 16 bytes; a product with such an operand takes body S."""
    x = _refused_operands()[case]
    assert gemm.tma_major(x.stride(0), x.stride(1), x.data_ptr()) is None
    ok = torch.zeros((x.shape[1], 64), dtype=torch.bfloat16)
    body, tile, split = gemm.plan_bf16(
        x.shape[0], 64, x.shape[1],
        (x.stride(0), x.stride(1), ok.stride(0), ok.stride(1)),
        (x.data_ptr(), ok.data_ptr()))
    assert (body, tile) == (S, 64)
    # and the same operand as w
    a = torch.zeros((64, x.shape[0]), dtype=torch.bfloat16)
    body, _tile, _split = gemm.plan_bf16(
        64, x.shape[1], x.shape[0],
        (a.stride(0), a.stride(1), x.stride(0), x.stride(1)),
        (a.data_ptr(), x.data_ptr()))
    assert body == S


@pytest.mark.parametrize("view,major", [(None, 1), ("t", 0)])
def test_tma_takes_both_majors(view, major):
    """A row-major operand is read along its rows, a transposed view of
    one along its columns: no copy either way."""
    x = torch.zeros((64, 96), dtype=torch.bfloat16)
    if view:
        x = x.t()
    assert gemm.tma_major(x.stride(0), x.stride(1), x.data_ptr()) == major


#: every split the kernels take (a power-of-two cluster up to 8), which
#: holds every split the plan gives the shape table
SPLITS = (1, 2, 4, 8)
#: two small products: K of 5 and of 9 K tiles, ragged M and N
SMALL = ((37, 300, 50), (64, 520, 72))


@functools.lru_cache(maxsize=None)
def _jax_outputs(m, k, n):
    """The operands (numpy f32, rounded to bf16 by each package) and
    ``{(activation, with_bias): (_matmul_jnp, _matmul_pallas in
    interpret mode)}`` in f32, every case in one jitted program (a JAX
    compile a case would cost a second each)."""
    rng = numpy.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(numpy.float32)
    w = (rng.standard_normal((k, n)) / numpy.sqrt(k)).astype(numpy.float32)
    b = rng.standard_normal(n).astype(numpy.float32)
    keys = [(act, with_bias) for act in ACTIVATIONS
            for with_bias in (True, False)]

    def program(ja, jw, jb):
        outs = []
        for act, with_bias in keys:
            bias = jb if with_bias else None
            outs.append((_matmul_jnp(ja, jw, bias, act).astype(jnp.float32),
                         _matmul_pallas(ja, jw, bias, act,
                                        tiles=(16, 128, 128),
                                        interpret=True).astype(jnp.float32)))
        return outs
    outs = jax.jit(program)(*(jnp.asarray(x).astype(jnp.bfloat16)
                              for x in (a, w, b)))
    return (a, w, b), {key: tuple(numpy.array(o) for o in pair)
                       for key, pair in zip(keys, outs)}


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("m,k,n", SMALL)
def test_split_model_matches_the_jax_matmul(m, k, n, activation, with_bias):
    """The plain model of the bodies' sums at every split (those the plan
    gives the table among them) against ``_matmul_jnp`` in bf16 and the
    Pallas ``_matmul_kernel`` in interpret mode, on the same bf16
    operands."""
    assert {want[2] for _n, _s, _st, want in TABLE} <= set(SPLITS)
    (a, w, b), outputs = _jax_outputs(m, k, n)
    ta, tw = (torch.from_numpy(x).bfloat16() for x in (a, w))
    tb = torch.from_numpy(b).bfloat16() if with_bias else None
    for split in SPLITS:
        got = gemm._matmul_bf16_split_ref(ta, tw, tb, activation, split)
        assert got.dtype == torch.bfloat16
        for want in outputs[activation, with_bias]:
            torch.testing.assert_close(
                got.float(), torch.from_numpy(want),
                atol=BF16_GEMM_TOL[0], rtol=BF16_GEMM_TOL[1])
