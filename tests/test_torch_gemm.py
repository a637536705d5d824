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
  read W for err_input before dw updates it: a test runs that route
  with the three kernel wrappers replaced by in-place plain pieces, and
  the same pieces in the wrong order must fail it.

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
    """The three kernel wrappers as in-place plain pieces; ``order``
    records the calls."""

    def dx(eo, y, w, activation, transposed):
        order.append("dx")
        delta = eo * gemm._derivative(y, activation)
        return delta @ (w if transposed else w.t())

    def dw(x, eo, y, w, vw, inv_batch, lr, decay, moment, activation,
           transposed):
        order.append("dw")
        grad = x.t() @ (eo * gemm._derivative(y, activation)) * inv_batch
        if transposed:
            grad = grad.t()
        vw.copy_(moment * vw - lr * (grad + decay * w))
        w.add_(vw)

    def db(eo, y, b, vb, inv_batch, lr, decay, moment, activation):
        order.append("db")
        grad = (eo * gemm._derivative(y, activation)).sum(0) * inv_batch
        vb.copy_(moment * vb - lr * (grad + decay * b))
        b.add_(vb)
    return dx, dw, db


@pytest.mark.parametrize("swapped", [False, True])
def test_kernel_route_reads_w_before_the_update(monkeypatch, swapped):
    """On CUDA tensors ``gd_fused`` launches dx, then dw (which updates W
    in place), then db.  With the wrappers replaced by plain in-place
    pieces, that order gives ``_gd_ref``'s err_input; dx run after dw
    (``swapped``) reads the updated W and must not."""
    order, late = [], []
    dx, dw, db = _plain_pieces(order)
    if swapped:
        def dw_then_dx(x, eo, y, w, vw, inv_batch, lr, decay, moment,
                       activation, transposed):
            dw(x, eo, y, w, vw, inv_batch, lr, decay, moment, activation,
               transposed)
            late.append(dx(eo, y, w, activation, transposed))
        monkeypatch.setattr(gemm, "_gd_dx_cuda", lambda *args: None)
        monkeypatch.setattr(gemm, "_gd_dw_cuda", dw_then_dx)
    else:
        monkeypatch.setattr(gemm, "_gd_dx_cuda", dx)
        monkeypatch.setattr(gemm, "_gd_dw_cuda", dw)
    monkeypatch.setattr(gemm, "_gd_db_cuda", db)
    monkeypatch.setattr(gemm, "on_gpu", lambda *t: True)
    arrays = _gd_inputs(False, seed=9)
    want = gemm._gd_ref(*_t(*arrays), *_HP, activation="sigmoid")
    out = gemm.gd_fused(*_t(*arrays), *_HP, activation="sigmoid")
    err_input = late[0] if swapped else out[4]
    for got, ref in zip(out[:4], want[:4]):
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    if swapped:
        assert order == ["dw", "dx", "db"]
        assert not torch.allclose(err_input, want[4], atol=GD_ATOL)
    else:
        assert order == ["dx", "dw", "db"]
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
    with pytest.raises(TypeError, match="float32"):
        gemm._gd_db_cuda(eo.double(), eo, torch.zeros(5), torch.zeros(5),
                         0.25, 0.1, 0.0, 0.9, None)
    with pytest.raises(ValueError, match="unknown activation"):
        gemm.gd_fused(eo, eo, eo, torch.zeros((5, 5)), None,
                      torch.zeros((5, 5)), None, *_HP, activation="gelu")
