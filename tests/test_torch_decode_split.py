"""The decode step's split plans and the arithmetic of their merges,
against the JAX package, on the CPU.

- ``ops.attention.decode_split`` (the decode kernels' cluster size, from
  batch x heads alone) and ``ops.qgemm.decode_plan`` (qmatmul's decode
  body: column tile and K split): a power of two up to 8, split only
  while the grid leaves SMs without a block; CONFIG's serving shapes
  map to the stated plans.
- ``key_range`` (a rank's keys of a row) and ``qgemm.k_range`` (a rank's
  K rows): contiguous, in rank order, covering ``[0, kend)`` and ``[0,
  K)`` exactly; a rank's range is empty only where the row has fewer
  chunks (K fewer stages) than the ranks before it take.
- A plain model of the decode kernels' merge (each rank's ``(m, l,
  acc)`` over its keys, merged in rank order in f32; an empty rank's
  ``(-1e30, 0, 0)`` weighs nothing) against ``_decode_jnp``,
  ``_verify_jnp`` and ``_paged_decode_jnp``: atol 1e-5 + rtol 1e-5, f32
  sums of the same products in another order.
- A plain model of qmatmul's split K sum (each rank's K rows summed on
  their own, added in rank order, then the scale once, the bias and the
  activation) against ``_qmatmul_jnp`` for every activation, the
  activations rounded to bf16 as the decode body takes them: within 1e-5
  relative, as ``tests/test_torch_quant.py`` holds ``_qmatmul_ref``
  (f32 products of the same values summed in another order).

The kernels themselves run only on the card (``tests/test_torch_kernels
.py``, ``cuda`` marker; ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops import qgemm as jax_qgemm
from veles_tpu.ops.attention import (_decode_jnp, _paged_decode_jnp,
                                     _verify_jnp)
from veles_tpu_torch import quant
from veles_tpu_torch.ops import attention, qgemm

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

MERGE_ATOL = MERGE_RTOL = 1e-5
QMM_RTOL = 1e-5
ACTIVATIONS = [None, "tanh", "sigmoid", "relu", "strict_relu", "gelu"]
SMS = 132
#: lengths around the 32-key chunks and the ranks' edges of a 2048 cache
EDGE_LENGTHS = [1, 31, 32, 33, 255, 256, 257, 2047, 2048]


# -- the plans ---------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 2, 3, 16, 32, 33, 64, 65, 66, 100, 132,
                                  133, 263, 264, 1000])
def test_decode_split_covers_the_sms_twice_at_most_8(rows):
    split = attention.decode_split(rows)
    assert split in (1, 2, 4, 8)
    if split > 1:                      # the half split left SMs idle
        assert rows * (split // 2) < 2 * SMS
    if split < 8:                      # and this one covers them
        assert rows * split >= 2 * SMS


def test_decode_split_of_the_serving_shapes():
    assert attention.decode_split(4 * 16) == 8       # serve: 4 slots
    assert attention.decode_split(8 * 16) == 4
    assert attention.decode_split(2 * 3) == 8


@pytest.mark.parametrize("n,k,want", [
    (3072, 1024, (128, 8)),    # wqkv: 24 tiles x 8
    (1024, 1024, (64, 8)),     # wo: 8 wide tiles x 8 leave SMs idle
    (4096, 1024, (128, 8)),    # w1
    (1024, 4096, (64, 8)),     # w2
    (130, 200, (64, 4)),       # 4 stages of K, one a rank
    (1, 64, (64, 1)),          # one stage of K
    (65536, 1024, (128, 1)),   # 512 wide tiles: covered unsplit
])
def test_decode_plan_maps_shapes_to_their_plans(n, k, want):
    assert qgemm.decode_plan(n, k) == want
    assert qgemm.split_k(4, n, k, torch.bfloat16) == want[1]


@pytest.mark.parametrize("n", [1, 100, 1024, 3072, 8192, 20000])
@pytest.mark.parametrize("k", [1, 64, 100, 1024, 4096])
def test_decode_plan_splits_only_an_uncovered_grid(n, k):
    block_n, split = qgemm.decode_plan(n, k)
    tiles = -(-n // block_n)
    stages = -(-k // qgemm.DECODE_TILE[2])
    assert block_n in qgemm.DECODE_BLOCK_N and split in (1, 2, 4, 8)
    if split > 1:                      # the half split left SMs idle
        assert tiles * (split // 2) < SMS and stages >= split
    if block_n != qgemm.DECODE_BLOCK_N[0]:
        # the wide tiles fell short of the SMs at their own largest split
        wide_tiles, wide_split = -(-n // qgemm.DECODE_BLOCK_N[0]), 1
        while (wide_split < 8 and wide_tiles * wide_split < SMS
               and stages >= 2 * wide_split):
            wide_split *= 2
        assert wide_tiles * wide_split < SMS
    ranges = [qgemm.k_range(r, split, k, qgemm.DECODE_TILE[2])
              for r in range(split)]
    assert all(end > begin for begin, end in ranges)   # no idle rank


# -- the partitions ------------------------------------------------------------

@pytest.mark.parametrize("kend", EDGE_LENGTHS + [1000, 5])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_key_range_covers_the_row_in_rank_order(kend, split):
    ranges = [attention.key_range(r, split, kend) for r in range(split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == kend
    for (_, end), (begin, _) in zip(ranges, ranges[1:]):
        assert end == begin                        # contiguous
    chunks = -(-kend // attention.DECODE_CHUNK)
    for r, (begin, end) in enumerate(ranges):
        assert begin % attention.DECODE_CHUNK == 0
        # empty only where the rank's share of the chunks rounds to none
        assert (end == begin) == (r * chunks // split
                                  == (r + 1) * chunks // split)
    if chunks >= split:
        assert all(end > begin for begin, end in ranges)


@pytest.mark.parametrize("k", [1, 63, 64, 65, 100, 1024, 4096, 4097])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_k_range_covers_k_in_rank_order(k, split):
    block_k = qgemm.DECODE_TILE[2]
    ranges = [qgemm.k_range(r, split, k, block_k) for r in range(split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (_, end), (begin, _) in zip(ranges, ranges[1:]):
        assert end == begin
    stages = -(-k // block_k)
    for r, (begin, end) in enumerate(ranges):
        assert begin % block_k == 0 or begin == k
        # empty only past the last stage: ceil(T / split) stages a rank
        assert (end == begin) == (r * -(-stages // split) >= stages)


# -- the decode merge ----------------------------------------------------------

def _merge_model(q, k, v, limits, split):
    """The kernels' merge: q (b, nq, h, d), k/v (b, S, h, d), limits (b,
    nq) keys each query row may read; each rank's (m, l, acc) over its
    keys of [0, kend) by ``key_range``, merged in rank order in f32."""
    b, nq, h, d = q.shape
    q = q / d ** 0.5
    out = torch.zeros((b, nq, h, d))
    for i in range(b):
        kend = int(limits[i].max())
        parts = []
        for rank in range(split):
            begin, end = attention.key_range(rank, split, kend)
            s = torch.einsum("qhd,khd->hqk", q[i], k[i, begin:end])
            keys = torch.arange(begin, end)
            valid = keys[None, None, :] < limits[i][None, :, None]
            s = torch.where(valid, s, torch.tensor(attention.NEG_INF))
            m = s.amax(-1) if end > begin else torch.full(
                (h, nq), attention.NEG_INF)
            m = torch.maximum(m, torch.tensor(attention.NEG_INF))
            p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
            parts.append((m, p.sum(-1), torch.einsum(
                "hqk,khd->hqd", p, v[i, begin:end])))
        mx = torch.stack([m for m, _l, _a in parts]).amax(0)
        l_sum = torch.zeros_like(mx)
        acc = torch.zeros((h, nq, d))
        for m, l_r, a_r in parts:          # rank order
            f = torch.exp(m - mx)
            l_sum = l_sum + l_r * f
            acc = acc + a_r * f[..., None]
        out[i] = (acc / torch.clamp(l_sum, min=1e-30)[..., None]).permute(
            1, 0, 2)
    return out


def _decode_arrays(seed, nq, row_step, b=len(EDGE_LENGTHS), seq=2048, h=2,
                   d=16):
    rng = numpy.random.default_rng(seed)
    q = rng.standard_normal((b, nq, h, d)).astype(numpy.float32)
    k = rng.standard_normal((b, seq, h, d)).astype(numpy.float32)
    v = rng.uniform(-1, 1, (b, seq, h, d)).astype(numpy.float32)
    lens = numpy.array([min(n, seq - row_step * (nq - 1))
                        for n in EDGE_LENGTHS[:b]], numpy.int32)
    return q, k, v, lens


def _close(got, want):
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  atol=MERGE_ATOL, rtol=MERGE_RTOL)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_decode_merge_matches_jax(split):
    q, k, v, lens = _decode_arrays(seed=split, nq=1, row_step=0)
    limits = torch.from_numpy(lens).long()[:, None]
    got = _merge_model(*map(torch.from_numpy, (q, k, v)), limits, split)
    _close(got, _decode_jnp(*map(jnp.asarray, (q, k, v, lens))))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("nq", [2, 5, 8])
def test_verify_merge_matches_jax(split, nq):
    q, k, v, lens = _decode_arrays(seed=10 + nq, nq=nq, row_step=1)
    limits = (torch.from_numpy(lens).long()[:, None]
              + torch.arange(nq)[None, :])
    got = _merge_model(*map(torch.from_numpy, (q, k, v)), limits, split)
    _close(got, _verify_jnp(*map(jnp.asarray, (q, k, v, lens))))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("bs", [4, 16])
def test_paged_merge_matches_jax(split, bs):
    """The paged entry keeps the contiguous partition (it depends on the
    row's key limit only): the model over the pool gathered through the
    tables against ``_paged_decode_jnp``."""
    b, seq, h, d = 4, 256, 2, 16
    q, k, v, lens = _decode_arrays(seed=20 + bs, nq=1, row_step=0, b=b,
                                   seq=seq)
    lens = numpy.minimum(lens, seq).astype(numpy.int32)
    rng = numpy.random.default_rng(bs)
    mb = seq // bs
    tables = rng.permutation(numpy.arange(1, b * mb + 1)).reshape(
        b, mb).astype(numpy.int32)
    pools = []
    for x in (k, v):
        pool = rng.standard_normal((b * mb + 1, bs, h, d)).astype(
            numpy.float32)
        pool[tables] = x.reshape(b, mb, bs, h, d)
        pools.append(pool)
    gathered = [torch.from_numpy(pool[tables].reshape(b, seq, h, d))
                for pool in pools]
    limits = torch.from_numpy(lens).long()[:, None]
    got = _merge_model(torch.from_numpy(q), *gathered, limits, split)
    _close(got, _paged_decode_jnp(*map(jnp.asarray, (q, *pools, tables,
                                                     lens))))


def test_an_empty_rank_weighs_nothing():
    """A row of one key at split 8: ranks 0-6 hold (-1e30, 0, 0) and the
    merge gives that key's value row exactly."""
    q, k, v, _lens = _decode_arrays(seed=3, nq=1, row_step=0, b=1)
    limits = torch.ones((1, 1), dtype=torch.long)
    got = _merge_model(*map(torch.from_numpy, (q, k, v)), limits, 8)
    assert torch.equal(got[0, 0], torch.from_numpy(v[0, 0]))


# -- qmatmul's split K sum -----------------------------------------------------

def _split_qmm(a, q, scale, bias, activation, split):
    """The decode body's sum: each rank's K rows (``k_range``) summed on
    their own in f32, the partials added in rank order, then the scale
    once, the bias and the activation."""
    total = torch.zeros((a.shape[0], q.shape[1]))
    for rank in range(split):
        begin, end = qgemm.k_range(rank, split, a.shape[1],
                                   qgemm.DECODE_TILE[2])
        total = total + a[:, begin:end].float() @ q[begin:end].float()
    out = total * scale
    if bias is not None:
        out = out + bias.float()
    return qgemm._qactivate(out, activation)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("m,k,n,split", [(4, 1024, 96, 8), (16, 200, 130, 4),
                                         (1, 100, 1, 2)])
def test_split_qmm_sum_matches_jax(activation, m, k, n, split):
    rng = numpy.random.default_rng(m + split)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(
        numpy.float32)).to(torch.bfloat16)
    qw = quant.quantize_array(rng.standard_normal((k, n)).astype(
        numpy.float32), axes=(0,))
    q, scale = qw["q"], qw["scale"].reshape(-1)
    bias = rng.standard_normal(n).astype(numpy.float32)
    got = _split_qmm(a, torch.from_numpy(q), torch.from_numpy(scale),
                     torch.from_numpy(bias), activation, split)
    want = numpy.asarray(jax_qgemm._qmatmul_jnp(
        jnp.asarray(a.float().numpy(), jnp.bfloat16), jnp.asarray(q),
        jnp.asarray(scale), jnp.asarray(bias), activation=activation,
        out_dtype=jnp.float32), numpy.float32)
    numpy.testing.assert_allclose(got.numpy(), want, rtol=QMM_RTOL,
                                  atol=QMM_RTOL * float(numpy.abs(want).max()))
