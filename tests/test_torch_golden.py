"""Cross-framework golden tests: the layer zoo vs torch.

The reference validated its OpenCL/CUDA kernels against known-good
implementations (SURVEY §4's golden-model discipline; the repo's own
``package.py`` golden model plays that role for the native engine).
Here torch (CPU) is the independent oracle: forwards AND backwards of
the core layers must agree numerically with ``torch.nn.functional``.

Layout notes: veles_tpu is NHWC with HWIO kernels and ``sliding``
given as (x, y) like the reference; torch is NCHW/OIHW.  Znicz
activation quirks under test: scaled tanh ``1.7159·tanh(0.6666x)``
and "relu" = softplus (``ops/gemm.py``).  LRN is the Krizhevsky
``α·Σ`` form — torch's ``local_response_norm`` divides alpha by n, so
the golden passes ``alpha·n`` to torch.
"""

import numpy
import pytest
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _t(x_nhwc):
    return torch.tensor(numpy.asarray(x_nhwc)).permute(0, 3, 1, 2)


def _from_t(x_nchw):
    return x_nchw.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("sliding,padding", [
    ((1, 1), (0, 0, 0, 0)),
    ((2, 2), (1, 1, 1, 1)),
    ((4, 4), (0, 0, 0, 0)),       # AlexNet conv1 stride (s2d regime)
])
def test_conv_forward_and_wgrad_match_torch(sliding, padding):
    from veles_tpu.znicz.conv import Conv

    rng = numpy.random.default_rng(7)
    x = rng.standard_normal((2, 13, 13, 3)).astype(numpy.float32)
    w = (rng.standard_normal((5, 5, 3, 8)) * 0.2).astype(numpy.float32)

    ours = Conv.pure({"w": w}, jnp.asarray(x), padding=padding,
                     sliding=sliding)
    # and the exact s2d rewrite must agree with the plain conv
    if sliding[0] == sliding[1] and sliding[0] > 1:
        s2d = Conv.pure({"w": w}, jnp.asarray(x), padding=padding,
                        sliding=sliding, s2d=True)
        numpy.testing.assert_allclose(numpy.asarray(s2d),
                                      numpy.asarray(ours),
                                      rtol=1e-5, atol=1e-5)

    tx = _t(x).requires_grad_(True)
    tw = torch.tensor(w).permute(3, 2, 0, 1).requires_grad_(True)
    left, right, top, bottom = padding
    assert left == right and top == bottom  # torch's symmetric padding
    theirs = torch.nn.functional.conv2d(
        tx, tw, stride=(sliding[1], sliding[0]), padding=(top, left))
    numpy.testing.assert_allclose(numpy.asarray(ours),
                                  _from_t(theirs), rtol=1e-4,
                                  atol=1e-4)

    # backward: dL/dw and dL/dx for L = sum(out²)/2
    def loss(w_, x_):
        o = Conv.pure({"w": w_}, x_, padding=padding, sliding=sliding)
        return 0.5 * jnp.sum(o.astype(jnp.float32) ** 2)

    dw, dx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w),
                                            jnp.asarray(x))
    (0.5 * (theirs ** 2).sum()).backward()
    numpy.testing.assert_allclose(
        numpy.asarray(dw),
        tw.grad.permute(2, 3, 1, 0).detach().numpy(),
        rtol=1e-3, atol=1e-3)
    numpy.testing.assert_allclose(numpy.asarray(dx),
                                  _from_t(tx.grad), rtol=1e-3,
                                  atol=1e-3)


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pooling_matches_torch(kind):
    from veles_tpu.znicz.pooling import PoolingBase

    rng = numpy.random.default_rng(3)
    x = rng.standard_normal((2, 9, 9, 4)).astype(numpy.float32)
    ours = PoolingBase.pure({}, jnp.asarray(x), kx=3, ky=3,
                            sliding=(2, 2), kind=kind)
    fn = (torch.nn.functional.max_pool2d if kind == "max"
          else torch.nn.functional.avg_pool2d)
    theirs = fn(_t(x), kernel_size=3, stride=2)
    numpy.testing.assert_allclose(numpy.asarray(ours),
                                  _from_t(theirs), rtol=1e-6,
                                  atol=1e-6)


def test_lrn_matches_torch():
    from veles_tpu.znicz.normalization_units import LRNormalizerForward

    rng = numpy.random.default_rng(5)
    x = rng.standard_normal((2, 7, 7, 16)).astype(numpy.float32)
    alpha, beta, k, n = 1e-4, 0.75, 2.0, 5
    ours = LRNormalizerForward.pure(None, jnp.asarray(x), alpha=alpha,
                                    beta=beta, k=k, n=n)
    # torch divides alpha by the window size; ours (like the paper and
    # the reference) multiplies the raw sum
    theirs = torch.nn.functional.local_response_norm(
        _t(x), size=n, alpha=alpha * n, beta=beta, k=k)
    numpy.testing.assert_allclose(numpy.asarray(ours),
                                  _from_t(theirs), rtol=1e-5,
                                  atol=1e-6)


def test_lstm_matches_torch():
    """Fused-gate scan vs torch.nn.LSTM: same i,f,g,o stacking; ours
    concatenates [x, h] against one (D+H, 4H) matrix = torch's
    w_ih/w_hh pair; single bias = bias_ih with bias_hh zeroed."""
    from veles_tpu.znicz.rnn import LSTM

    B, T, D, H = 4, 11, 6, 9
    rng = numpy.random.default_rng(11)
    x = rng.standard_normal((B, T, D)).astype(numpy.float32)
    w = (rng.standard_normal((D + H, 4 * H)) * 0.3).astype(
        numpy.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(numpy.float32)

    ours = LSTM.pure({"w": w, "b": b}, jnp.asarray(x),
                     hidden_units=H, last_only=False)

    lstm = torch.nn.LSTM(D, H, batch_first=True)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.tensor(w[:D].T))
        lstm.weight_hh_l0.copy_(torch.tensor(w[D:].T))
        lstm.bias_ih_l0.copy_(torch.tensor(b))
        lstm.bias_hh_l0.zero_()
    theirs, (h_n, _c_n) = lstm(torch.tensor(x))
    numpy.testing.assert_allclose(numpy.asarray(ours),
                                  theirs.detach().numpy(), rtol=1e-4,
                                  atol=1e-5)
    last = LSTM.pure({"w": w, "b": b}, jnp.asarray(x),
                     hidden_units=H, last_only=True)
    numpy.testing.assert_allclose(numpy.asarray(last),
                                  h_n[0].detach().numpy(), rtol=1e-4,
                                  atol=1e-5)


def test_simple_rnn_matches_torch():
    from veles_tpu.znicz.rnn import SimpleRNN

    B, T, D, H = 3, 8, 5, 7
    rng = numpy.random.default_rng(13)
    x = rng.standard_normal((B, T, D)).astype(numpy.float32)
    w = (rng.standard_normal((D + H, H)) * 0.4).astype(numpy.float32)
    b = (rng.standard_normal(H) * 0.1).astype(numpy.float32)
    ours = SimpleRNN.pure({"w": w, "b": b}, jnp.asarray(x),
                          hidden_units=H, last_only=False)
    rnn = torch.nn.RNN(D, H, nonlinearity="tanh", batch_first=True)
    with torch.no_grad():
        rnn.weight_ih_l0.copy_(torch.tensor(w[:D].T))
        rnn.weight_hh_l0.copy_(torch.tensor(w[D:].T))
        rnn.bias_ih_l0.copy_(torch.tensor(b))
        rnn.bias_hh_l0.zero_()
    theirs, _h = rnn(torch.tensor(x))
    numpy.testing.assert_allclose(numpy.asarray(ours),
                                  theirs.detach().numpy(), rtol=1e-4,
                                  atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_torch_sdpa(causal):
    """flash_attention (XLA path on CPU) vs torch's
    scaled_dot_product_attention, forward and q-gradient."""
    from veles_tpu.ops.attention import flash_attention

    b, s, h, d = 2, 33, 4, 16
    rng = numpy.random.default_rng(17)
    q = rng.standard_normal((b, s, h, d)).astype(numpy.float32)
    k = rng.standard_normal((b, s, h, d)).astype(numpy.float32)
    v = rng.standard_normal((b, s, h, d)).astype(numpy.float32)

    ours = flash_attention(jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v), causal=causal,
                           use_pallas=False)
    tq = torch.tensor(q).permute(0, 2, 1, 3).requires_grad_(True)
    tk = torch.tensor(k).permute(0, 2, 1, 3)
    tv = torch.tensor(v).permute(0, 2, 1, 3)
    theirs = torch.nn.functional.scaled_dot_product_attention(
        tq, tk, tv, is_causal=causal)
    numpy.testing.assert_allclose(
        numpy.asarray(ours),
        theirs.permute(0, 2, 1, 3).detach().numpy(), rtol=1e-4,
        atol=1e-5)

    dq = jax.grad(lambda q_: jnp.sum(flash_attention(
        q_, jnp.asarray(k), jnp.asarray(v), causal=causal,
        use_pallas=False) ** 2) * 0.5)(jnp.asarray(q))
    (0.5 * (theirs ** 2).sum()).backward()
    numpy.testing.assert_allclose(
        numpy.asarray(dq),
        tq.grad.permute(0, 2, 1, 3).detach().numpy(), rtol=1e-3,
        atol=1e-4)


def test_znicz_activations_match_torch():
    """matmul's fused epilogues: scaled tanh (1.7159·tanh(0.6666x)),
    Znicz 'relu' = softplus, sigmoid — vs torch composition."""
    from veles_tpu.ops.gemm import matmul

    rng = numpy.random.default_rng(19)
    a = rng.standard_normal((32, 24)).astype(numpy.float32)
    w = (rng.standard_normal((24, 12)) * 0.3).astype(numpy.float32)
    bias = rng.standard_normal(12).astype(numpy.float32)
    ta = torch.tensor(a)
    tw = torch.tensor(w)
    tb = torch.tensor(bias)
    lin = ta @ tw + tb
    for act, torch_fn in [
            ("tanh", lambda z: 1.7159 * torch.tanh(z * 0.6666)),
            ("relu", torch.nn.functional.softplus),
            ("strict_relu", torch.relu),
            ("sigmoid", torch.sigmoid)]:
        ours = matmul(jnp.asarray(a), jnp.asarray(w),
                      jnp.asarray(bias), act, None, False)
        numpy.testing.assert_allclose(
            numpy.asarray(ours), torch_fn(lin).numpy(), rtol=1e-5,
            atol=1e-5)


def test_grouped_conv_matches_torch():
    """The documented `grouping` knob (AlexNet's grouped convolution):
    weights (kh, kw, C/g, K) against torch's groups=g."""
    from veles_tpu.znicz.conv import Conv

    g = 2
    rng = numpy.random.default_rng(23)
    x = rng.standard_normal((2, 9, 9, 8)).astype(numpy.float32)
    w = (rng.standard_normal((3, 3, 8 // g, 6)) * 0.3).astype(
        numpy.float32)
    ours = Conv.pure({"w": w}, jnp.asarray(x), padding=(1, 1, 1, 1),
                     grouping=g)
    tw = torch.tensor(w).permute(3, 2, 0, 1)
    theirs = torch.nn.functional.conv2d(_t(x), tw, padding=1, groups=g)
    numpy.testing.assert_allclose(numpy.asarray(ours),
                                  _from_t(theirs), rtol=1e-4,
                                  atol=1e-5)


def test_deconv_matches_torch_and_adjoint_relation():
    """Deconv vs torch.nn.functional.conv_transpose2d: our transposed
    conv applies the stored (ky, kx, C, K) kernel WITHOUT the spatial
    flip of torch's gradient convention, so the torch twin takes the
    flipped kernel.  Equivalently, Deconv(·; w) is the exact adjoint
    of Conv(·; flip(w)) — an equivalent parameterization (the filter
    is learned; a flip re-parameterizes, it does not change the
    function class), pinned here so the convention can never drift
    silently between XLA, the package golden model, and the native
    engine."""
    from veles_tpu.znicz.conv import Conv
    from veles_tpu.znicz.misc_units import Deconv

    rng = numpy.random.default_rng(29)
    B, H, W, K, C, k, s, p = 2, 5, 5, 4, 3, 3, 2, 1
    x = rng.standard_normal((B, H, W, K)).astype(numpy.float32)
    w = (rng.standard_normal((k, k, C, K)) * 0.3).astype(numpy.float32)
    w_flip = numpy.ascontiguousarray(w[::-1, ::-1])

    ours = numpy.asarray(Deconv.pure({"w": w}, jnp.asarray(x),
                                     padding=(p, p, p, p),
                                     sliding=(s, s)))
    tw = torch.tensor(w_flip).permute(3, 2, 0, 1)
    theirs = torch.nn.functional.conv_transpose2d(
        _t(x), tw, stride=s, padding=p)
    numpy.testing.assert_allclose(ours, _from_t(theirs), rtol=1e-4,
                                  atol=1e-5)

    # adjoint identity: <Conv(y; flip(w)), x> == <y, Deconv(x; w)>
    y = rng.standard_normal(
        (B,) + ours.shape[1:3] + (C,)).astype(numpy.float32)
    conv_y = numpy.asarray(Conv.pure({"w": w_flip}, jnp.asarray(y),
                                     padding=(p, p, p, p),
                                     sliding=(s, s)))
    lhs = float((conv_y * x).sum())
    rhs = float((y * ours).sum())
    assert lhs == pytest.approx(rhs, rel=1e-4)
