"""The port's attention (``veles_tpu_torch.ops.attention``) against the
JAX package's: the plain PyTorch versions against the dense jnp
references and the Pallas kernels in interpret mode, on the same numpy
inputs, in float32 (atol 1e-5, rtol 1e-5).  On the CPU the wrappers
take the plain versions and launch nothing; the kernels themselves are
held against the plain versions on the card (``test_torch_kernels.py``
and ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops.attention import (_decode_jnp, _decode_pallas,
                                     _flash_fwd, _mha_jnp, _verify_jnp)
from veles_tpu_torch.ops import attention as port

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def _arrays(shapes, seed):
    rng = numpy.random.default_rng(seed)
    return [rng.standard_normal(s).astype(numpy.float32) for s in shapes]


def _close(got, want):
    numpy.testing.assert_allclose(numpy.asarray(got), numpy.asarray(want),
                                  atol=ATOL, rtol=RTOL)


@pytest.fixture
def launches():
    port.reset_launches()
    yield port.launches
    port.reset_launches()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,q_off,k_off", [
    (24, 24, 0, 0),          # square, block multiple
    (13, 29, 0, 0),          # ragged, rectangular
    (7, 19, 12, 0),          # a query chunk late in the sequence
    (16, 16, 3, 5),          # both offsets nonzero
])
def test_mha_ref_matches_jax(causal, sq, sk, q_off, k_off):
    q, k, v = _arrays([(2, sq, 3, 8), (2, sk, 3, 8), (2, sk, 3, 8)],
                      seed=sq + sk)
    out, lse = port._mha_ref(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal, q_off, k_off)
    ref_o, ref_lse = _mha_jnp(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, q_offset=q_off,
                              k_offset=k_off)
    assert out.shape == (2, sq, 3, 8) and lse.shape == (2, 3, sq)
    _close(out, ref_o)
    _close(lse, ref_lse)
    if not causal or q_off >= k_off:
        # every row sees a key: the Pallas kernel agrees row for row
        pal_o, pal_lse = _flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=8, block_k=8, interpret=True, q_offset=q_off,
            k_offset=k_off)
        _close(out, pal_o)
        _close(lse, pal_lse)


def test_flash_attention_on_cpu_takes_the_plain_version(launches):
    q, k, v = (torch.from_numpy(a) for a in
               _arrays([(1, 9, 2, 8)] * 3, seed=3))
    out = port.flash_attention(q, k, v, causal=True)
    o, lse = port._flash_fwd(q, k, v, causal=True)
    assert torch.equal(out, o)
    assert torch.equal(o, port._mha_ref(q, k, v, True)[0])
    assert lse.dtype == torch.float32
    assert not any(launches.values())


@pytest.mark.parametrize("seq,lengths", [
    (24, [1, 5, 24]),
    (19, [19, 3, 11]),       # ragged cache length
])
def test_decode_ref_matches_jax(seq, lengths):
    q, k, v = _arrays([(3, 1, 2, 8), (3, seq, 2, 8), (3, seq, 2, 8)],
                      seed=seq)
    lens = numpy.asarray(lengths, numpy.int32)
    got = port._decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lens))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(got, _decode_jnp(jq, jk, jv, jnp.asarray(lens)))
    _close(got, _decode_pallas(jq, jk, jv, jnp.asarray(lens), block_k=8,
                               interpret=True))


def test_verify_ref_matches_jax():
    q, k, v = _arrays([(2, 5, 2, 8), (2, 32, 2, 8), (2, 32, 2, 8)],
                      seed=11)
    lens = numpy.asarray([1, 20], numpy.int32)
    got = port._verify_ref(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lens))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(got, _verify_jnp(jq, jk, jv, jnp.asarray(lens)))
    _close(got, _decode_pallas(jq, jk, jv, jnp.asarray(lens), block_k=8,
                               interpret=True, row_step=1))
    # row 0 of the verify mask is exactly the plain decode query
    _close(got[:, :1], port._decode_ref(
        torch.from_numpy(q[:, :1]), torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(lens)))


def test_decode_attention_wrapper_on_cpu(launches):
    q, k, v = (torch.from_numpy(a) for a in
               _arrays([(2, 1, 2, 8), (2, 16, 2, 8), (2, 16, 2, 8)],
                       seed=7))
    lens = torch.tensor([3, 16], dtype=torch.int32)
    out = port.decode_attention(q, k, v, lens)
    assert torch.equal(out, port._decode_ref(q, k, v, lens))
    # the (b, h, d) form squeezes the query axis away and back
    squeezed = port.decode_attention(q[:, 0], k, v, lens)
    assert torch.equal(squeezed, out[:, 0])
    verify = port.decode_attention(q, k, v, lens, row_step=1)
    assert torch.equal(verify, port._verify_ref(q, k, v, lens))
    with pytest.raises(ValueError):
        port.decode_attention(q, k, v, lens, row_step=2)
    assert not any(launches.values())
