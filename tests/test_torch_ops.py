"""The port's reduce and random ops against the JAX package's, on the
CPU, and its ``precision_level`` switch.

``matrix_reduce`` (the plain version on CPU tensors, whatever the knob)
is held against ``_reduce_jnp`` and ``_reduce_pallas`` in interpret mode
on the same numpy inputs, for every op and axis, f32 and bf16, ragged
shapes, and ±inf and NaN entries.  max and min must be equal (NaN where
the reference has NaN); a sum is a sum in another order, so each output
must lie within 1e-6·Σ|a| of the reference's, plus one bf16 ulp of it
for a bf16 output (each side rounds its f32 sum once).

``uniform_pallas`` off the card is ``_uniform_ref``, Philox4x32-10 in
torch int64: it is checked against the published known-answer vector,
for determinism, range (f32 and bf16), moments and seed sensitivity.
The JAX package's off-TPU route is threefry, so bits are not compared
with it.  ``normal`` and ``dropout_mask`` are held to their moments.
"""

import math

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops import reduce as jax_reduce
from veles_tpu_torch import ops
from veles_tpu_torch.backends import make_device, set_precision
from veles_tpu_torch.config import root
from veles_tpu_torch.gen import TransformerGenModel
from veles_tpu_torch.ops import random as port_random
from veles_tpu_torch.ops import reduce as port_reduce
from veles_tpu_torch.samples.transformer import TINY

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

SUM_RTOL = 1e-6
BF16_ULP = 2.0 ** -8          # half the spacing at 1: one rounding of bf16


def _matrix(shape, seed, specials):
    a = numpy.random.default_rng(seed).standard_normal(shape).astype(
        numpy.float32)
    if specials:
        m, n = shape
        a[0, n // 2] = numpy.inf
        a[m // 2, 0] = -numpy.inf
        a[m - 1, n - 1] = numpy.nan
    return a


def _check(got, want, a, op, axis, dtype):
    got = got.float().numpy()
    want = numpy.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    nan = numpy.isnan(want)
    assert numpy.array_equal(numpy.isnan(got), nan)
    got, want = got[~nan], want[~nan]
    if op != "sum":
        assert numpy.array_equal(got, want)
        return
    inf = numpy.isinf(want)
    assert numpy.array_equal(got[inf], want[inf])
    scale = numpy.nansum(numpy.abs(numpy.where(numpy.isinf(a), 0.0, a)),
                         axis=axis)[~nan][~inf]
    tol = SUM_RTOL * scale
    if dtype == torch.bfloat16:
        tol = tol + BF16_ULP * numpy.abs(want[~inf])
    assert (numpy.abs(got[~inf] - want[~inf]) <= tol).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,specials", [
    ((37, 53), False), ((24, 256), False), ((37, 53), True),
    ((1, 700), False), ((700, 1), False), ((9, 1030), True)])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_matrix_reduce_matches_jnp_and_interpret_pallas(op, axis, shape,
                                                        specials, dtype):
    a = _matrix(shape, 11, specials)
    t = torch.from_numpy(a).to(dtype)
    port_reduce.reset_launches()
    got = ops.matrix_reduce(t, axis=axis, op=op, use_pallas=True)
    assert got.dtype == dtype and not port_reduce.launches["reduce"]
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ja = jnp.asarray(a, jdtype)
    exact = t.float().numpy()              # what both sides reduce
    _check(got, jax_reduce._reduce_jnp(ja, axis, op), exact, op, axis,
           dtype)
    _check(got, jax_reduce._reduce_pallas(ja, axis=axis, op=op,
                                          interpret=True),
           exact, op, axis, dtype)


def test_matrix_reduce_follows_the_knob_and_checks_its_arguments():
    t = torch.from_numpy(_matrix((5, 7), 2, False))
    saved = root.common.engine.get("pallas_reduce")
    assert saved is False
    for knob in (False, True):
        root.common.engine.pallas_reduce = knob
        try:
            out = ops.matrix_reduce(t, axis=1, op="max")
        finally:
            root.common.engine.pallas_reduce = saved
        assert torch.equal(out, t.amax(dim=1))
    with pytest.raises(ValueError, match="axis"):
        ops.matrix_reduce(t, axis=2)
    with pytest.raises(ValueError, match="op"):
        ops.matrix_reduce(t, op="mean")
    with pytest.raises(ValueError, match="2-D"):
        ops.matrix_reduce(t[0])


# -- the counter-based uniform fill -------------------------------------------

def test_philox_known_answer():
    """Philox4x32-10 of counter 0 under key 0 (Random123's known-answer
    vector)."""
    words = port_random.philox_words(0, 4)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                       0x9B00DBD8]


def test_philox_mulhilo_matches_python_integers():
    rng = numpy.random.default_rng(5)
    b = torch.from_numpy(rng.integers(0, 2 ** 32, 1000, dtype=numpy.int64))
    b[:3] = torch.tensor([0, 1, 2 ** 32 - 1])
    for a in (0xD2511F53, 0xCD9E8D57, 2 ** 32 - 1):
        hi, lo = port_random._mulhilo(a, b)
        for x, h, l_ in zip(b.tolist(), hi.tolist(), lo.tolist()):
            assert (h << 32) + l_ == a * x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("low,high", [(0.0, 1.0), (-2.0, 3.0), (0.1, 0.3)])
def test_uniform_ref_range_moments_and_determinism(dtype, low, high):
    shape = (64, 1000)
    a = port_random._uniform_ref(3, shape, dtype, low, high)
    b = ops.random.uniform_pallas(3, shape, dtype, low, high, device="cpu")
    assert a.shape == shape and a.dtype == dtype
    assert torch.equal(a, b)
    assert float(a.min()) >= low and float(a.max()) < high
    x = a.double()
    n = x.numel()
    mean, var = (low + high) / 2, (high - low) ** 2 / 12
    # within 5 sigma of U(low, high): the mean's sigma is sqrt(var / n),
    # the variance's sqrt((mu4 - var^2) / n) with mu4 = (high-low)^4 / 80;
    # bf16 adds its rounding, at most half an ulp of |high|
    slack = 0.0 if dtype == torch.float32 else 2.0 ** -8 * max(abs(low),
                                                                 abs(high))
    assert abs(float(x.mean()) - mean) <= 5 * math.sqrt(var / n) + slack
    mu4 = (high - low) ** 4 / 80
    assert abs(float(x.var()) - var) <= 5 * math.sqrt((mu4 - var ** 2) / n) \
        + 2 * slack * (high - low)
    other = port_random._uniform_ref(4, shape, dtype, low, high)
    assert not torch.equal(a, other)


def test_uniform_ref_keeps_a_rounded_up_value_below_high():
    """Where u·(high − low) + low rounds up to ``high`` in the output
    dtype, the value becomes the dtype's largest below ``high``."""
    cap = port_random._affine(torch.bfloat16, 0.0, 1.0)[2]
    assert cap == 1.0 - 2.0 ** -8
    x = port_random._uniform_ref(9, (1 << 16,), torch.bfloat16)
    assert float(x.max()) == cap
    assert port_random._affine(torch.float32, -1.0, 1.0)[2] == \
        float(numpy.nextafter(numpy.float32(1.0), numpy.float32(0.0)))
    with pytest.raises(ValueError, match="low < high"):
        port_random._affine(torch.float32, 1.0, 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        port_random._affine(torch.float16, 0.0, 1.0)


def test_uniform_pallas_shapes_and_flat_counter():
    """The counter is the flat index / 4, so a shape is a view of the
    flat stream; a 1-D fill of any length is a prefix of a longer one."""
    flat = port_random._uniform_ref(7, (1003,))
    assert torch.equal(port_random._uniform_ref(7, (17, 59)).reshape(-1),
                       flat)
    assert torch.equal(port_random._uniform_ref(7, (5,)), flat[:5])
    assert port_random._uniform_ref(7, (0, 3)).shape == (0, 3)
    port_random.reset_launches()
    port_random.uniform_pallas(7, (3,), device="cpu")
    assert not port_random.launches["uniform"]


# -- torch's generators -----------------------------------------------------

def test_uniform_and_normal_moments():
    gen = torch.Generator().manual_seed(42)
    a = ops.uniform(gen, (1000,), low=-2.0, high=3.0)
    b = ops.uniform(torch.Generator().manual_seed(42), (1000,), low=-2.0,
                    high=3.0)
    assert torch.equal(a, b)
    assert float(a.min()) >= -2.0 and float(a.max()) < 3.0
    x = ops.normal(torch.Generator().manual_seed(7), (20000,), mean=1.0,
                   stddev=2.0)
    assert abs(float(x.mean()) - 1.0) < 0.1
    assert abs(float(x.std()) - 2.0) < 0.1


def test_dropout_mask_keep_share_and_scale():
    mask = port_random.dropout_mask(torch.Generator().manual_seed(3),
                                    (200, 100), 0.8)
    values = set(torch.unique(mask).tolist())
    assert values == {0.0, float(torch.tensor(1.0) / torch.tensor(0.8))}
    keep = float((mask > 0).double().mean())
    assert abs(keep - 0.8) <= 5 * math.sqrt(0.8 * 0.2 / mask.numel())
    assert abs(float(mask.double().mean()) - 1.0) < 0.02


# -- precision_level ---------------------------------------------------------

@pytest.fixture
def tf32_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             root.common.engine.get("precision_level"),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    root.common.engine.precision_level = saved[2]
    torch.backends.cudnn.deterministic = saved[3]
    torch.backends.cudnn.benchmark = saved[4]


@pytest.mark.parametrize("level,tf32", [(0, True), (1, False), (2, False)])
def test_precision_level_maps_to_the_tf32_switches(tf32_flags, level, tf32):
    assert root.common.engine.precision_level == 0    # the JAX default
    root.common.engine.precision_level = level
    torch.backends.cudnn.benchmark = True
    assert set_precision() == level
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
    assert torch.backends.cudnn.allow_tf32 is tf32
    # the full-f32 levels also pin cuDNN's algorithms: two runs, one sum
    assert torch.backends.cudnn.deterministic is not tf32
    assert torch.backends.cudnn.benchmark is tf32
    root.common.engine.precision_level = 3
    with pytest.raises(ValueError, match="precision_level"):
        set_precision()


@pytest.mark.parametrize("entry", ["gen_model", "workflow_device"])
@pytest.mark.parametrize("level,tf32", [(0, True), (1, False)])
def test_entry_points_apply_the_precision_level_on_a_card(
        tf32_flags, monkeypatch, entry, level, tf32):
    """Every entry point resolving a card maps the configured level; no
    call to set_precision() by the caller is needed (the device is only
    resolved here, nothing is allocated on it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    root.common.engine.precision_level = level
    torch.backends.cuda.matmul.allow_tf32 = not tf32
    torch.backends.cudnn.allow_tf32 = not tf32
    if entry == "gen_model":
        assert TransformerGenModel(TINY).device.type == "cuda"
    else:
        assert make_device(None).torch_device.type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
    assert torch.backends.cudnn.allow_tf32 is tf32
