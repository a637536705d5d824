"""The port's flash-attention backward (``veles_tpu_torch.ops.attention``)
against the JAX package's, on the CPU.

The plain version ``_bwd_ref`` is held against JAX ``_bwd_blockwise``
(the non-TPU backward) and against the Pallas backward pair
``_flash_bwd`` in interpret mode with 8-row blocks, so that ragged
lengths pad inside the kernels; the port's autograd gradients of
``flash_attention`` are held against ``jax.vjp`` of JAX
``flash_attention``.  Inputs are numpy arrays from a seed; tolerance
atol 1e-5, rtol 1e-5 in float32.  The Pallas pair is also run in
bfloat16 (head dims 8, 64, 72 and 128), where ``_bwd_ref`` is the
oracle the card's tensor-core kernels are held against: both sides
round p and ds to bfloat16 before their products and round each
gradient once on output, so they agree within atol 2e-3, rtol 2^-7
(one bfloat16 ulp), the card's bfloat16 tolerance.  On the CPU the
wrappers take the plain versions and launch nothing; the kernels are
held against the plain versions on the card
(``test_torch_kernels.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops.attention import _bwd_blockwise
from veles_tpu.ops.attention import _flash_bwd as jax_flash_bwd
from veles_tpu.ops.attention import _mha_jnp
from veles_tpu.ops.attention import flash_attention as jax_flash_attention
from veles_tpu_torch.ops import attention as port

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

ATOL = RTOL = 1e-5
#: (atol, rtol) by dtype: the card's bfloat16 backward tolerance
TOLS = {"float32": (ATOL, RTOL), "bfloat16": (2e-3, 2 ** -7)}
CASES = [
    (24, 24, 0, 0, 8),       # square, block multiple
    (13, 29, 0, 0, 8),       # ragged, rectangular
    (7, 19, 12, 0, 8),       # a query chunk late in the sequence
    (16, 16, 3, 5, 8),       # both offsets nonzero
    (13, 29, 0, 0, 64),      # ragged at the training head dim
    (13, 29, 0, 0, 72),      # a head dim the kernels pad to 128
    (13, 29, 0, 0, 128),
    (77, 77, 0, 0, 64),      # several blocks, a ragged last one
    (45, 77, 32, 0, 64),     # a query chunk at q_offset 32
]


def _arrays(shapes, seed):
    rng = numpy.random.default_rng(seed)
    return [rng.standard_normal(s).astype(numpy.float32) for s in shapes]


def _close(got, want):
    numpy.testing.assert_allclose(numpy.asarray(got), numpy.asarray(want),
                                  atol=ATOL, rtol=RTOL)


def _saved(sq, sk, causal, q_off, k_off, seed, d=8, dtype="float32"):
    """(q, k, v, o, lse, do) as float32 numpy holding ``dtype`` values,
    o and lse from the JAX forward in ``dtype``."""
    arrays = _arrays([(2, sq, 3, d), (2, sk, 3, d), (2, sk, 3, d),
                      (2, sq, 3, d)], seed)
    q, k, v, do = (numpy.array(jnp.asarray(a, dtype).astype(jnp.float32))
                   for a in arrays)
    o, lse = _mha_jnp(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                      jnp.asarray(v, dtype), causal, q_offset=q_off,
                      k_offset=k_off)
    return q, k, v, numpy.array(o.astype(jnp.float32)), numpy.array(lse), do


@pytest.fixture
def launches():
    port.reset_launches()
    yield port.launches
    port.reset_launches()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,q_off,k_off,d", CASES)
def test_bwd_ref_matches_pallas_interpret(causal, sq, sk, q_off, k_off, d,
                                          dtype):
    arrays = _saved(sq, sk, causal, q_off, k_off, seed=sq + 3 * sk,
                    d=d, dtype=dtype)
    mm = getattr(torch, dtype)
    got = port._bwd_ref(*(torch.from_numpy(a).to(mm) for a in arrays[:4]),
                        torch.from_numpy(arrays[4]),
                        torch.from_numpy(arrays[5]).to(mm), causal, q_off,
                        k_off)
    want = jax_flash_bwd(*(jnp.asarray(a, dtype) for a in arrays[:4]),
                         jnp.asarray(arrays[4]), jnp.asarray(arrays[5], dtype),
                         causal=causal, block_q=8, block_k=8, interpret=True,
                         q_offset=q_off, k_offset=k_off)
    atol, rtol = TOLS[dtype]
    for g, w, x in zip(got, want, arrays[:3]):
        assert g.shape == x.shape and g.dtype == mm
        numpy.testing.assert_allclose(
            g.float().numpy(), numpy.asarray(w.astype(jnp.float32)),
            atol=atol, rtol=rtol)


#: JAX's _bwd_blockwise and flash_attention take no offsets: their causal
#: cases are square
ALIGNED = [(False, 24, 24), (False, 13, 29), (True, 24, 24), (True, 13, 13)]


@pytest.mark.parametrize("causal,sq,sk", ALIGNED)
@pytest.mark.parametrize("block_k", [8, 128])
def test_bwd_ref_matches_bwd_blockwise(causal, sq, sk, block_k):
    """Its block size changes only the order of the dq sum."""
    arrays = _saved(sq, sk, causal, 0, 0, seed=sq * sk)
    q, k, v, o, lse, do = arrays
    got = port._bwd_ref(*(torch.from_numpy(a) for a in arrays), causal,
                        block_k=block_k)
    want = _bwd_blockwise(tuple(jnp.asarray(a) for a in (q, k, v, o, lse)),
                          jnp.asarray(do), causal, block_k)
    for g, w in zip(got, want):
        _close(g, w)


def test_bwd_ref_takes_a_precomputed_delta():
    arrays = _saved(13, 29, True, 0, 0, seed=5)
    t = [torch.from_numpy(a) for a in arrays]
    delta = port._delta(t[3], t[5])
    assert delta.shape == (2, 3, 13) and delta.dtype == torch.float32
    plain = port._bwd_ref(*t, True)
    given = port._bwd_ref(*t, True, delta=delta)
    for a, b in zip(plain, given):
        assert torch.equal(a, b)


def test_flash_bwd_on_cpu_takes_the_plain_version(launches):
    t = [torch.from_numpy(a) for a in _saved(16, 16, True, 3, 5, seed=6)]
    got = port._flash_bwd(*t, True, 3, 5)
    want = port._bwd_ref(*t, True, 3, 5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not any(launches.values())


@pytest.mark.parametrize("causal,sq,sk", ALIGNED)
def test_autograd_matches_jax_vjp(causal, sq, sk, launches):
    q, k, v, do = _arrays([(2, sq, 3, 8), (2, sk, 3, 8), (2, sk, 3, 8),
                           (2, sq, 3, 8)], seed=sq + sk + causal)
    out, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = port.flash_attention(tq, tk, tv, causal)
    _close(o.detach(), out)
    o.backward(torch.from_numpy(do))
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(g, w)
    assert not any(launches.values())


def test_autograd_through_strided_views_of_one_projection():
    """Training hands q, k and v over as views of one (b, s, 3, h, d)
    projection; autograd sums their grads into the projection's."""
    x, do = _arrays([(2, 11, 3, 3, 8), (2, 11, 3, 8)], seed=9)
    qkv = torch.from_numpy(x).requires_grad_()
    port.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                         True).backward(torch.from_numpy(do))
    parts = [torch.from_numpy(x[:, :, i].copy()).requires_grad_()
             for i in range(3)]
    port.flash_attention(*parts, True).backward(torch.from_numpy(do))
    want = torch.stack([p.grad for p in parts], dim=2)
    torch.testing.assert_close(qkv.grad, want, atol=0, rtol=0)


def test_flash_attention_without_grad_is_the_forward_alone():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in
               _arrays([(1, 9, 2, 8)] * 3, seed=4))
    with torch.no_grad():
        out = port.flash_attention(q, k, v, True)
    assert out.grad_fn is None
    with torch.inference_mode():
        assert port.flash_attention(q, k, v, True).grad_fn is None
    assert port.flash_attention(q, k, v, True).grad_fn is not None
