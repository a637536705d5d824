"""The port's GEMM and fused-GD plain versions (``veles_tpu_torch.ops
.gemm``) against the JAX package, on the CPU.

- ``_matmul_ref`` against ``_matmul_jnp`` and against ``_matmul_pallas``
  in interpret mode (tiles (8, 128, 128)), on ragged shapes, for every
  activation with and without a bias: atol 1e-5 (one f32 product summed
  in another order).
- ``_gd_ref`` against ``znicz.gd._gd_math`` and against
  ``gd_fused_pallas(..., tiles=(32, 32, 8), interpret=True)`` on the
  unaligned 24×70×50 of ``tests/test_kernels.py``, for every activation
  × both storage layouts × ``need_err_input`` × ``has_bias``: atol 5e-5,
  the JAX package's own interpret tolerance (``_gd_math`` divides by B,
  the Pallas kernels multiply by 1/B, and they sum in tiles).
- The ``gd_fused`` wrapper updates W, vW, b and vb in place on the CPU
  as on the card, launches nothing, and — on the kernel route — must
  read W for err_input before dw (which carries the bias step) updates
  it: a test runs that route with the two kernel wrappers replaced by
  in-place plain pieces, and the same pieces in the wrong order must
  fail it.

- ``plan`` (the GEMM body's tile and K split) and ``k_range`` (a rank's
  K chunk): the split never passes 8, stops once the grid covers the
  SMs, leaves no rank without a K tile, and the chunks cover K once, in
  rank order; the MNIST shapes and 4096³ map to the stated configs.
- The split's arithmetic emulated in plain PyTorch (each rank's chunk
  summed on its own, the partial tiles added in rank order) against
  ``_matmul_jnp`` and ``_gd_math``, and the bias sums in the dw kernel's
  order (``_bias_sum_plan_ref``: rows one by one within a rank's K
  chunk, ranks in order) at splits 1 to 8, both storage layouts: atol
  1e-5 + rtol 1e-5, the card's GEMM tolerance.

The kernels themselves run only on the card (``tests/test_torch_kernels
.py``, ``cuda`` marker; ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops.gemm import _matmul_jnp, _matmul_pallas, gd_fused_pallas
from veles_tpu.znicz.gd import _gd_math
from veles_tpu_torch.ops import gemm

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

ACTIVATIONS = [None, "tanh", "sigmoid", "relu", "strict_relu"]
MATMUL_ATOL = 1e-5
GD_ATOL = 5e-5
_HP = (0.05, 0.05, 0.0005, 0.0, 0.9, 0.9)   # lr, lr_b, decay ×2, moment ×2


def _gd_inputs(transposed, seed=7, batch=24, f=70, n=50):
    rng = numpy.random.default_rng(seed)
    x = rng.standard_normal((batch, f)).astype(numpy.float32)
    eo = rng.standard_normal((batch, n)).astype(numpy.float32)
    y = rng.standard_normal((batch, n)).astype(numpy.float32)
    w = (rng.standard_normal((n, f) if transposed else (f, n))
         * 0.1).astype(numpy.float32)
    b = rng.standard_normal((n,)).astype(numpy.float32)
    vw = (rng.standard_normal(w.shape) * 0.01).astype(numpy.float32)
    vb = (rng.standard_normal(b.shape) * 0.01).astype(numpy.float32)
    return x, y, eo, w, b, vw, vb


def _t(*arrays):
    return [torch.from_numpy(numpy.array(a)) for a in arrays]


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("m,k,n", [(37, 70, 50), (5, 130, 9)])
def test_matmul_ref_matches_jax(activation, with_bias, m, k, n):
    rng = numpy.random.default_rng(11)
    a = rng.standard_normal((m, k)).astype(numpy.float32)
    w = (rng.standard_normal((k, n)) / numpy.sqrt(k)).astype(numpy.float32)
    bias = rng.standard_normal((n,)).astype(numpy.float32) \
        if with_bias else None
    got = gemm._matmul_ref(torch.from_numpy(a), torch.from_numpy(w),
                           None if bias is None else torch.from_numpy(bias),
                           activation).numpy()
    jb = None if bias is None else jnp.asarray(bias)
    dense = _matmul_jnp(jnp.asarray(a), jnp.asarray(w), jb, activation)
    numpy.testing.assert_allclose(got, numpy.asarray(dense),
                                  atol=MATMUL_ATOL, rtol=0)
    if (m, k, n) == (37, 70, 50):
        kernel = _matmul_pallas(jnp.asarray(a), jnp.asarray(w), jb,
                                activation=activation, tiles=(8, 128, 128),
                                interpret=True)
        numpy.testing.assert_allclose(got, numpy.asarray(kernel),
                                      atol=MATMUL_ATOL, rtol=0)


def test_matmul_wrapper_reads_a_transposed_storage_on_cpu():
    """``matmul`` on CPU tensors is the plain version, also through a
    transposed view of (N, K) weights (All2All's weights_transposed)."""
    rng = numpy.random.default_rng(3)
    a, w_nk = _t(rng.standard_normal((9, 20)).astype(numpy.float32),
                 rng.standard_normal((6, 20)).astype(numpy.float32))
    gemm.reset_launches()
    got = gemm.matmul(a, w_nk.t(), None, "tanh")
    torch.testing.assert_close(got, gemm._matmul_ref(
        a, w_nk.t().contiguous(), None, "tanh"), atol=0, rtol=0)
    assert not any(gemm.launches.values())


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("batch,f,n", [(24, 70, 50), (100, 100, 10)])
def test_gd_ref_gives_the_same_bits_from_either_storage(activation, batch,
                                                        f, n):
    """``_gd_ref`` on W stored (F, N) and on the same W stored (N, F)
    (``transposed``) gives the same bits: err_input, and the new W and
    vW up to the storage's transpose (CPU BLAS takes another kernel for
    a transposed operand, so δ·Wᵀ must read one layout)."""
    arrays = _gd_inputs(False, seed=12, batch=batch, f=f, n=n)
    x, y, eo, w, b, vw, vb = _t(*arrays)
    plain = gemm._gd_ref(x, y, eo, w, b, vw, vb, *_HP,
                         activation=activation)
    turned = gemm._gd_ref(x, y, eo, w.t().contiguous(), b,
                          vw.t().contiguous(), vb, *_HP,
                          activation=activation, transposed=True)
    assert torch.equal(plain[4], turned[4])
    assert torch.equal(plain[0], turned[0].t())
    assert torch.equal(plain[2], turned[2].t())
    assert torch.equal(plain[1], turned[1]) and torch.equal(plain[3],
                                                            turned[3])


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("need_err_input", [True, False])
@pytest.mark.parametrize("has_bias", [True, False])
def test_gd_ref_matches_jax(activation, transposed, need_err_input,
                            has_bias):
    arrays = _gd_inputs(transposed)
    flags = dict(activation=activation, need_err_input=need_err_input,
                 has_bias=has_bias, transposed=transposed)
    got = gemm._gd_ref(*_t(*arrays), *_HP, **flags)
    jarrays = [jnp.asarray(a) for a in arrays]
    dense = _gd_math(*jarrays, *_HP, **flags)
    kernel = gd_fused_pallas(*jarrays, *_HP, tiles=(32, 32, 8),
                             interpret=True, **flags)
    for name, g, d, k in zip(("w", "b", "vw", "vb", "err_input"), got,
                             dense, kernel):
        if g is None:
            assert d is None and k is None and name == "err_input"
            continue
        g = g.numpy()
        msg = "%s (%s)" % (name, flags)
        numpy.testing.assert_allclose(g, numpy.asarray(d), atol=GD_ATOL,
                                      rtol=0, err_msg=msg)
        numpy.testing.assert_allclose(g, numpy.asarray(k), atol=GD_ATOL,
                                      rtol=0, err_msg=msg)


@pytest.mark.parametrize("transposed", [False, True])
def test_gd_fused_updates_in_place_on_cpu(transposed):
    """The CPU route gives ``_gd_ref``'s values and, as on the card,
    writes them into the given W, vW, b and vb; no kernel launches."""
    arrays = _gd_inputs(transposed, seed=8)
    want = gemm._gd_ref(*_t(*arrays), *_HP, activation="tanh",
                        transposed=transposed)
    x, y, eo, w, b, vw, vb = _t(*arrays)
    gemm.reset_launches()
    out = gemm.gd_fused(x, y, eo, w, b, vw, vb, *_HP, activation="tanh",
                        transposed=transposed)
    assert out[0] is w and out[1] is b and out[2] is vw and out[3] is vb
    for got, ref in zip(out, want):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    assert not any(gemm.launches.values())


def _plain_pieces(order):
    """The two kernel wrappers as in-place plain pieces, dw taking the
    bias step when given it, as its launch does; ``order`` records the
    calls."""

    def dx(eo, y, w, activation, transposed):
        order.append("dx")
        delta = eo * gemm._derivative(y, activation)
        return delta @ (w if transposed else w.t())

    def dw(x, eo, y, w, vw, inv_batch, lr, decay, moment, activation,
           transposed, bias=None):
        order.append("dw" if bias is None else "dw+db")
        delta = eo * gemm._derivative(y, activation)
        grad = x.t() @ delta * inv_batch
        if transposed:
            grad = grad.t()
        vw.copy_(moment * vw - lr * (grad + decay * w))
        w.add_(vw)
        if bias is not None:
            b, vb, lr_b, decay_b, moment_b = bias
            grad_b = delta.sum(0) * inv_batch
            vb.copy_(moment_b * vb - lr_b * (grad_b + decay_b * b))
            b.add_(vb)
    return dx, dw


@pytest.mark.parametrize("swapped", [False, True])
def test_kernel_route_reads_w_before_the_update(monkeypatch, swapped):
    """On CUDA tensors ``gd_fused`` launches dx, then dw (which updates W
    in place, and takes the bias step in the same launch).  With the
    wrappers replaced by plain in-place pieces, that order gives
    ``_gd_ref``'s err_input; dx run after dw (``swapped``) reads the
    updated W and must not."""
    order, late = [], []
    dx, dw = _plain_pieces(order)
    if swapped:
        def dw_then_dx(x, eo, y, w, vw, inv_batch, lr, decay, moment,
                       activation, transposed, bias=None):
            dw(x, eo, y, w, vw, inv_batch, lr, decay, moment, activation,
               transposed, bias)
            late.append(dx(eo, y, w, activation, transposed))
        monkeypatch.setattr(gemm, "_gd_dx_cuda", lambda *args: None)
        monkeypatch.setattr(gemm, "_gd_dw_cuda", dw_then_dx)
    else:
        monkeypatch.setattr(gemm, "_gd_dx_cuda", dx)
        monkeypatch.setattr(gemm, "_gd_dw_cuda", dw)
    monkeypatch.setattr(gemm, "on_gpu", lambda *t: True)
    arrays = _gd_inputs(False, seed=9)
    want = gemm._gd_ref(*_t(*arrays), *_HP, activation="sigmoid")
    out = gemm.gd_fused(*_t(*arrays), *_HP, activation="sigmoid")
    err_input = late[0] if swapped else out[4]
    for got, ref in zip(out[:4], want[:4]):
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    if swapped:
        assert order == ["dw+db", "dx"]
        assert not torch.allclose(err_input, want[4], atol=GD_ATOL)
    else:
        assert order == ["dx", "dw+db"]
        torch.testing.assert_close(err_input, want[4], atol=1e-6, rtol=0)


@pytest.mark.parametrize("bad,error,message", [
    (dict(dtype=torch.float64), TypeError, "float32"),
    (dict(a_shape=(4, 3, 2)), ValueError, "2-D"),
    (dict(k=5), ValueError, "matmul: a is"),
    (dict(bias_shape=(3,)), ValueError, "bias"),
])
def test_matmul_contract_is_checked_before_launch(bad, error, message):
    a = torch.zeros(bad.get("a_shape", (4, 6)),
                    dtype=bad.get("dtype", torch.float32))
    w = torch.zeros((bad.get("k", 6), 7))
    bias = torch.zeros(bad.get("bias_shape", (7,)))
    gemm.reset_launches()
    with pytest.raises(error, match=message):
        gemm._matmul_cuda(a, w, bias, None)
    assert not any(gemm.launches.values())


def test_gd_contract_is_checked_before_launch():
    eo = torch.zeros((4, 5))
    with pytest.raises(ValueError, match="do not match"):
        gemm._gd_dx_cuda(eo, eo, torch.zeros((6, 4)), None, False)
    with pytest.raises(ValueError, match="differ"):
        gemm._gd_dx_cuda(eo, torch.zeros((4, 6)), torch.zeros((6, 5)),
                         None, False)
    with pytest.raises(ValueError, match="contiguous"):
        gemm._gd_dw_cuda(torch.zeros((4, 6)), eo, eo,
                         torch.zeros((5, 6)).t(), torch.zeros((6, 5)),
                         0.25, 0.1, 0.0, 0.9, None, False)
    with pytest.raises(ValueError, match="x is"):
        gemm._gd_dw_cuda(torch.zeros((4, 7)), eo, eo, torch.zeros((6, 5)),
                         torch.zeros((6, 5)), 0.25, 0.1, 0.0, 0.9, None,
                         False)
    x, w = torch.zeros((4, 6)), torch.zeros((6, 5))
    with pytest.raises(TypeError, match="float32"):
        gemm._gd_dw_cuda(x, eo, eo, w, w.clone(), 0.25, 0.1, 0.0, 0.9, None,
                         False, bias=(torch.zeros(5, dtype=torch.float64),
                                      torch.zeros(5), 0.1, 0.0, 0.9))
    with pytest.raises(ValueError, match="want \\(5,\\) each"):
        gemm._gd_dw_cuda(x, eo, eo, w, w.clone(), 0.25, 0.1, 0.0, 0.9, None,
                         False, bias=(torch.zeros(4), torch.zeros(4), 0.1,
                                      0.0, 0.9))
    with pytest.raises(ValueError, match="hyperparameters"):
        gemm._gd_dw_cuda(x, eo, eo, w, w.clone(), 0.25, 0.1, 0.0, 0.9, None,
                         False, bias=(torch.zeros(5), torch.zeros(5),
                                      torch.tensor(0.1), 0.0, 0.9))
    with pytest.raises(ValueError, match="unknown activation"):
        gemm.gd_fused(eo, eo, eo, torch.zeros((5, 5)), None,
                      torch.zeros((5, 5)), None, *_HP, activation="gelu")


# -- the tile and split rule (ops.gemm.plan, k_range) ------------------------

SPLIT_ATOL = SPLIT_RTOL = 1e-5


@pytest.mark.parametrize("m,n,k,want", [
    ((100, 100, 784, (gemm.SPLIT_TILE, 8))),   # layer 1's forward: 16 tiles
    ((100, 10, 100, (gemm.SPLIT_TILE, 4))),    # layer 2's forward; its dw
    ((100, 100, 10, (gemm.SPLIT_TILE, 1))),    # layer 2's dx: one K tile
    ((784, 100, 100, (gemm.SPLIT_TILE, 4))),   # layer 1's dw: 100 tiles
    ((100, 784, 100, (gemm.SPLIT_TILE, 4))),   # the same, transposed
    ((1000, 1000, 1000, (gemm.SPLIT_TILE, 1))),  # 992 tiles: covered
    ((4096, 4096, 4096, (gemm.BIG_TILE, 1))),  # 1024 big tiles
    ((1536, 1536, 64, (gemm.BIG_TILE, 1))),    # 144 big tiles: covered
    ((37, 50, 70, (gemm.SPLIT_TILE, 4))),      # 5 K tiles: 1, 1, 1, 2
])
def test_plan_maps_the_main_shapes_to_their_configs(m, n, k, want):
    assert gemm.plan(m, n, k) == want


@pytest.mark.parametrize("m", [1, 37, 100, 784, 4096])
@pytest.mark.parametrize("n", [1, 10, 100, 1000])
@pytest.mark.parametrize("k", [1, 16, 20, 100, 784, 5000])
def test_plan_splits_only_an_uncovered_grid_and_feeds_every_rank(m, n, k):
    tile, split = gemm.plan(m, n, k)
    block_k = gemm.TILES[tile][2]
    cover = gemm._SMS * 256        # a 256-thread block on every SM
    assert split in (1, 2, 4, 8)
    if tile == gemm.BIG_TILE:
        assert split == 1 and gemm.grid_threads(m, n, tile) >= cover
    else:
        assert gemm.grid_threads(m, n, gemm.BIG_TILE) < cover
    if split > 1:     # the half split did not cover the SMs
        assert gemm.grid_threads(m, n, tile, split // 2) < cover
    ranges = [gemm.k_range(r, split, k, tile) for r in range(split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (_, end), (begin, _) in zip(ranges, ranges[1:]):
        assert end == begin                    # contiguous, in rank order
    for begin, end in ranges:
        assert end > begin                     # every rank has a K tile
        assert begin % block_k == 0
    sizes = [-(-(end - begin) // block_k) for begin, end in ranges]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("split,k,want", [
    (8, 784, [(0, 96), (96, 192), (192, 288), (288, 384), (384, 480),
              (480, 576), (576, 672), (672, 784)]),
    (4, 100, [(0, 16), (16, 48), (48, 80), (80, 100)]),
    (2, 20, [(0, 16), (16, 20)]),              # K shorter than split x BK
    (8, 100, [(0, 0), (0, 16), (16, 32), (32, 48), (48, 64), (64, 80),
              (80, 96), (96, 100)]),           # forced: 7 K tiles, rank 0
])                                             # empty
def test_k_range_is_the_kernels_chunk_arithmetic(split, k, want):
    assert [gemm.k_range(r, split, k) for r in range(split)] == want


def _split_mm(a, b, split):
    """a @ b as a split launch sums it: each rank's K chunk on its own,
    then the partial tiles added in rank order."""
    total = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for rank in range(split):
        begin, end = gemm.k_range(rank, split, a.shape[1])
        total = total + a[:, begin:end] @ b[begin:end]
    return total


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("m,k,n,split", [(100, 784, 100, 8),
                                         (100, 100, 10, 2),
                                         (100, 100, 10, 4)])
def test_split_sum_matches_jax_matmul(activation, m, k, n, split):
    rng = numpy.random.default_rng(12)
    a = rng.standard_normal((m, k)).astype(numpy.float32)
    w = (rng.standard_normal((k, n)) / numpy.sqrt(k)).astype(numpy.float32)
    bias = rng.standard_normal((n,)).astype(numpy.float32)
    got = gemm._activate(_split_mm(torch.from_numpy(a), torch.from_numpy(w),
                                   split) + torch.from_numpy(bias),
                         activation).numpy()
    want = _matmul_jnp(jnp.asarray(a), jnp.asarray(w), jnp.asarray(bias),
                       activation)
    numpy.testing.assert_allclose(got, numpy.asarray(want), atol=SPLIT_ATOL,
                                  rtol=SPLIT_RTOL)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("batch,f,n,split", [
    (100, 784, 100, 2), (100, 100, 10, 4), (100, 784, 100, 8),
    (100, 784, 100, 1), (100, 784, 100, 4), (100, 100, 10, 1),
    (100, 100, 10, 2), (100, 100, 10, 8), (37, 70, 50, 1), (37, 70, 50, 2),
    (37, 70, 50, 4), (37, 70, 50, 8)])
def test_split_sum_matches_jax_gd(activation, batch, f, n, split):
    """dW as the split kernel sums it (K = the batch), times 1/B, then
    the momentum step; err_input with K = n split the same way; and the
    bias step from the sums in the dw kernel's order
    (``_bias_sum_plan_ref``), in both storage layouts."""
    lr, lr_b, decay, decay_b, moment, moment_b = _HP
    for transposed in (False, True):
        arrays = _gd_inputs(transposed, seed=13, batch=batch, f=f, n=n)
        x, y, eo, w, b, vw, vb = _t(*arrays)
        w_fn = w.t() if transposed else w            # (f, n)
        delta = eo * gemm._derivative(y, activation)
        grad = _split_mm(x.t().contiguous(), delta, split) * (1.0 / batch)
        if transposed:
            grad = grad.t()
        v_new = moment * vw - lr * (grad + decay * w)
        err_input = _split_mm(delta, w_fn.t().contiguous(), split)
        grad_b = gemm._bias_sum_plan_ref(delta, split) * (1.0 / batch)
        vb_new = moment_b * vb - lr_b * (grad_b + decay_b * b)
        want = _gd_math(*[jnp.asarray(a) for a in arrays], *_HP,
                        activation=activation, transposed=transposed)
        for name, got, ref in (("w", w + v_new, want[0]),
                               ("vw", v_new, want[2]),
                               ("err_input", err_input, want[4]),
                               ("b", b + vb_new, want[1]),
                               ("vb", vb_new, want[3])):
            numpy.testing.assert_allclose(
                got.numpy(), numpy.asarray(ref), atol=SPLIT_ATOL,
                rtol=SPLIT_RTOL,
                err_msg="%s (transposed=%s)" % (name, transposed))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("batch", [1, 16, 37, 100])
def test_bias_sum_plan_adds_rows_in_rank_order(split, batch):
    """The model's order, written out: rank r adds its ``k_range`` rows
    one by one into zero, then the ranks' sums are added into zero in
    rank order (a split-1 launch keeps its sum)."""
    rng = numpy.random.default_rng(14)
    delta = torch.from_numpy(rng.standard_normal((batch, 9)).astype(
        numpy.float32))
    sums = []
    for rank in range(split):
        s = numpy.zeros(9, numpy.float32)
        begin, end = gemm.k_range(rank, split, batch)
        for row in delta.numpy()[begin:end]:
            s = (s + row).astype(numpy.float32)
        sums.append(s)
    want = sums[0] if split == 1 else numpy.zeros(9, numpy.float32)
    for s in sums if split > 1 else ():
        want = (want + s).astype(numpy.float32)
    got = gemm._bias_sum_plan_ref(delta, split).numpy()
    numpy.testing.assert_array_equal(got, want)
