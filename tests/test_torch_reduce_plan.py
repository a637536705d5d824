"""The reduce kernel's plan and its plain model, on the CPU.

- ``ops.reduce.plan`` (the vector width and split of a launch) and
  ``row_range`` (a cluster rank's rows) cover every element of the
  matrix exactly once and write every output once, at every split:
  checked by walking the kernel's index arithmetic (``csrc/reduce.cu``:
  blocks, warps, lanes and their loads) in numpy.
- ``_reduce_plan_ref``, the plain model of the kernel's order (the
  lanes' folds, the butterfly, the warps' and the cluster ranks'
  merges), matches the JAX package's ``_reduce_jnp``: sums within
  1e-6 · Σ|a| (another order of the same f32 additions), max and min
  exactly, NaN and ±inf included (fmax / fmin with NaN flags).

The kernel itself runs only on the card, where it is held against the
model bit for bit and against ``_reduce_ref``
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops.reduce import _reduce_jnp
from veles_tpu_torch.ops import reduce

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

SPLITS = (1, 2, 4, 8)
#: one strip of many rows, rows that are not 16-byte aligned, one row,
#: one column; the coverage adds a ragged strip and split and tiny ones
SHAPES = [(4096, 64), (37, 53), (1, 5000), (5000, 1)]
COVER_SHAPES = SHAPES + [(1000, 1030), (3, 7), (24, 256), (9, 300)]
SUM_RTOL = 1e-6


def _visits(launch, m, n):
    """(reads, writes): how often the kernel's threads load each element
    and store each output under ``launch``."""
    reads = numpy.zeros((m, n), dtype=numpy.int64)
    vec, split, warps = launch.vec, launch.split, launch.warps
    if launch.axis == 0:
        writes = numpy.zeros(n, dtype=numpy.int64)
        strips = -(-n // launch.strip)
        cap = launch.strip // split
        for block in range(strips * split):
            strip, rank = divmod(block, split)
            r0, r1 = reduce.row_range(rank, split, m)
            for warp in range(warps):
                for lane in range(32):
                    col = strip * launch.strip + lane * vec
                    if col < n:
                        reads[r0 + warp:r1:warps, col:col + vec] += 1
            for t in range(cap):
                col = strip * launch.strip + rank * cap + t
                if col < n:
                    writes[col] += 1
        return reads, writes
    writes = numpy.zeros(m, dtype=numpy.int64)
    lanes, vectors = 32 * split, -(-n // vec)
    for block in range(-(-m // launch.strip)):
        for warp in range(warps):
            row = block * launch.strip + warp // split
            if row >= m:
                continue
            # lane g's vectors g, g + 32·split, ...; its vec values each
            g = (warp % split) * 32 + numpy.arange(32)
            v = (g[:, None] + lanes * numpy.arange(-(-vectors // lanes)))
            v = v[v < vectors]
            cols = (v[:, None] * vec + numpy.arange(vec)).ravel()
            numpy.add.at(reads[row], cols[cols < n], 1)
            if warp % split == 0:
                writes[row] += 1
    return reads, writes


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", COVER_SHAPES)
@pytest.mark.parametrize("dtype,aligned", [(torch.float32, True),
                                           (torch.bfloat16, True),
                                           (torch.float32, False)])
def test_plan_covers_every_element_once_at_every_split(axis, shape, dtype,
                                                       aligned):
    m, n = shape
    for split in (None,) + SPLITS:
        launch = reduce.plan(m, n, axis, dtype, aligned, split)
        assert launch.vec == (reduce.vector_width(dtype) if aligned else 1)
        assert launch.warps == reduce.WARPS
        reads, writes = _visits(launch, m, n)
        assert (reads == 1).all(), (launch, int(reads.min()),
                                    int(reads.max()))
        assert (writes == 1).all(), launch


@pytest.mark.parametrize("m,split", [(4096, 8), (5, 8), (7, 2), (1, 4),
                                     (4097, 8), (64, 1)])
def test_row_ranges_are_the_ranks_contiguous_chunks(m, split):
    ranges = [reduce.row_range(r, split, m) for r in range(split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    chunk = -(-m // split)
    assert all(r1 - r0 <= chunk for r0, r1 in ranges)


@pytest.mark.parametrize("axis,shape,want", [
    (0, (4096, 4096), (4, 8, 128)),        # 32 strips x 8 = 256 blocks
    (1, (4096, 4096), (4, 1, 8)),          # 512 blocks of 8 rows
    (0, (4096, 64), (4, 8, 128)),          # one strip: the rows split 8
    (0, (24, 256), (4, 1, 128)),           # too few rows to split
    (1, (1, 5000), (4, 4, 2)),             # one long row over 4 warps
    (1, (37, 53), (4, 1, 8))])
def test_plan_splits_until_the_grid_covers_the_sms(axis, shape, want):
    launch = reduce.plan(*shape, axis)
    assert (launch.vec, launch.split, launch.strip) == want
    with pytest.raises(ValueError, match="split"):
        reduce.plan(*shape, axis, split=3)


def _matrix(shape, seed, specials=False):
    a = numpy.random.default_rng(seed).standard_normal(shape).astype(
        numpy.float32)
    if specials and min(shape) > 1:
        m, n = shape
        a[0, n - 1], a[m - 1, 0], a[m // 2, n // 2] = \
            numpy.inf, -numpy.inf, numpy.nan
        a[m // 3, :] = numpy.inf
        a[:, n // 3] = -numpy.inf
    return a


def _launch(a, axis, split):
    return reduce.launch_plan(torch.from_numpy(a), axis, split)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("axis", [0, 1])
def test_sum_order_model_matches_the_jax_sum(axis, shape, split):
    a = _matrix(shape, 7)
    launch = _launch(a, axis, split)
    got = reduce._reduce_plan_ref(torch.from_numpy(a), axis, "sum",
                                  launch).numpy()
    want = numpy.asarray(_reduce_jnp(jnp.asarray(a), axis, "sum"))
    tol = SUM_RTOL * numpy.abs(a).sum(axis)
    assert got.shape == want.shape
    assert (numpy.abs(got - want) <= tol).all(), (
        float(numpy.abs(got - want).max()), float(tol.min()))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("axis", [0, 1])
def test_fmax_nan_flag_model_matches_the_jax_max_and_min(axis, shape, split):
    a = _matrix(shape, 8, specials=True)
    launch = _launch(a, axis, split)
    for op in ("max", "min"):
        got = reduce._reduce_plan_ref(torch.from_numpy(a), axis, op,
                                      launch).numpy()
        want = numpy.asarray(_reduce_jnp(jnp.asarray(a), axis, op))
        numpy.testing.assert_array_equal(got, want)
    # the sum keeps NaN and ±inf where the JAX sum has them
    got = reduce._reduce_plan_ref(torch.from_numpy(a), axis, "sum",
                                  launch).numpy()
    want = numpy.asarray(_reduce_jnp(jnp.asarray(a), axis, "sum"))
    finite = numpy.isfinite(want)
    numpy.testing.assert_array_equal(got[~finite], want[~finite])


@pytest.mark.parametrize("axis", [0, 1])
def test_bf16_model_matches_the_jax_reduction(axis):
    """bf16 in, f32 inside, bf16 out: max and min exact, the sum within
    the tolerance plus one bf16 ulp (each side rounds once)."""
    a = _matrix((300, 1032), 9, specials=True)
    t = torch.from_numpy(a).to(torch.bfloat16)
    j = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    launch = reduce.launch_plan(t, axis)
    assert launch.vec == 8
    for op in ("sum", "max", "min"):
        got = reduce._reduce_plan_ref(t, axis, op, launch).float().numpy()
        want = numpy.asarray(_reduce_jnp(j, axis, op).astype(jnp.float32))
        if op != "sum":
            numpy.testing.assert_array_equal(got, want)
            continue
        finite = numpy.isfinite(want)
        numpy.testing.assert_array_equal(got[~finite], want[~finite])
        x = numpy.nan_to_num(t.float().numpy(), nan=0.0, posinf=0.0,
                             neginf=0.0)
        tol = SUM_RTOL * numpy.abs(x).sum(axis) + 2.0 ** -8 * numpy.abs(want)
        assert (numpy.abs(got[finite] - want[finite]) <= tol[finite]).all()
