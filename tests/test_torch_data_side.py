"""The data side against the JAX package, on the CPU: the normalizers
(``normalization.py``), ``mean_disp_normalizer.py`` with
``ops/normalize.py``, ``input_joiner.py`` with ``ops/join.py``,
``avatar.py`` and ``ops/hog.py``, over inputs drawn from a seed with
numpy.

- Every normalizer type: ``analyze`` over two batches, ``normalize``,
  ``denormalize`` (where the JAX one inverts), ``as_affine`` and
  ``state`` equal the JAX normalizer's to ``NORM_TOL`` = 1e-6 (they are
  numpy in both packages); a normalizer used before ``analyze`` raises
  as the JAX one does.
- ``MeanDispNormalizer``, ``InputJoiner`` and ``Avatar`` run as units on
  a ``CPUDevice`` and give the JAX units' outputs (exactly: the same
  float32 arithmetic; the joiner is a copy).
- ``hog`` / ``hog_batch`` over orientations, cell and block sizes, flat
  regions, an image smaller than a block and RGB, within ``HOG_TOL`` =
  1e-5 of the JAX function.
"""

import numpy
import pytest
import torch

from veles_tpu import normalization as jax_norm
from veles_tpu.avatar import Avatar as JaxAvatar
from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
from veles_tpu.input_joiner import InputJoiner as JaxJoiner
from veles_tpu.mean_disp_normalizer import MeanDispNormalizer as JaxMeanDisp
from veles_tpu.memory import Vector as JaxVector
from veles_tpu.ops import hog as jax_hog
from veles_tpu_torch import normalization
from veles_tpu_torch.avatar import Avatar
from veles_tpu_torch.backends import CPUDevice
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.input_joiner import InputJoiner
from veles_tpu_torch.mean_disp_normalizer import MeanDispNormalizer
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.ops import gather, hog, join, normalize

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

NORM_TOL = 1e-6
HOG_TOL = 1e-5

_KWARGS = {"external_mean": {"mean_source": numpy.linspace(
    -1, 1, 12, dtype=numpy.float32), "scale": 0.5},
    "scale": {"scale": 0.25}, "linear": {"interval": (0, 2)},
    "range_linear": {"interval": (-2, 3)}}
_INVERTIBLE = ("none", "scale", "range_linear", "mean_disp", "pointwise",
               "external_mean", "internal_mean")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread: these small ops, thousands a
    minibatch, otherwise wait for a descheduled pool thread whenever the
    box's cores are busy (~8 ms an op beside the parallel suite)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches():
    rng = numpy.random.default_rng(3)
    a = rng.standard_normal((5, 3, 4)).astype(numpy.float32) * 3 + 1
    b = rng.standard_normal((4, 3, 4)).astype(numpy.float32)
    # a constant feature: zero span and dispersion
    a[:, 0, 0] = b[:, 0, 0] = 2.0
    return a, b


def _close(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    if want is None:
        assert got is None
        return
    assert numpy.abs(numpy.asarray(got, numpy.float64)
                     - numpy.asarray(want, numpy.float64)).max() <= NORM_TOL


def test_every_jax_normalizer_is_ported():
    assert sorted(normalization.NormalizerRegistry.normalizers) == \
        sorted(jax_norm.NormalizerRegistry.normalizers)


@pytest.mark.parametrize("name", sorted(
    jax_norm.NormalizerRegistry.normalizers))
def test_normalizer_matches_jax(name):
    kwargs = _KWARGS.get(name, {})
    port = normalization.normalizer_factory(name, **kwargs)
    ref = jax_norm.normalizer_factory(name, **kwargs)
    a, b = _batches()
    for norm in (port, ref):
        norm.analyze(a.copy())
        norm.analyze(b.copy())
    assert port.is_initialized == ref.is_initialized
    state, want_state = port.state, ref.state
    assert sorted(state) == sorted(want_state)
    for key, value in want_state.items():
        if isinstance(value, (numpy.ndarray, float, int)) \
                and not isinstance(value, bool):
            _close(state[key], value)
        else:
            assert state[key] == value, key
    got, want = a.copy(), a.copy()
    port.normalize(got)
    ref.normalize(want)
    _close(got, want)
    _close(port.as_affine(), ref.as_affine())
    if name in _INVERTIBLE:
        port.denormalize(got)
        ref.denormalize(want)
        _close(got, want)
    else:
        with pytest.raises(NotImplementedError):
            port.denormalize(got)
    # the state carries across: a fresh normalizer fed it normalizes alike
    fresh = normalization.normalizer_factory(name, **kwargs)
    fresh.state = port.state
    again = b.copy()
    fresh.normalize(again)
    want = b.copy()
    ref.normalize(want)
    _close(again, want)


@pytest.mark.parametrize("name", ["range_linear", "pointwise",
                                  "mean_disp"])
def test_a_fitting_normalizer_refuses_before_analyze(name):
    port = normalization.normalizer_factory(name)
    with pytest.raises(RuntimeError, match="before analyze"):
        port.as_affine()
    with pytest.raises(ValueError, match="unknown normalization"):
        normalization.normalizer_factory("nope")


@pytest.mark.parametrize("name", _INVERTIBLE)
def test_the_served_affine_is_one_kernel_table(name):
    """Each affine normalizer's pair as the stitched head hands it to the
    served gather (``affine_tensors``) holds one count for both, a
    number beside one per feature repeated to the feature count, so the
    kernel's table check takes it; the plain gather of a u8 table gives
    the JAX normalizer's rows (within NORM_TOL of the largest) and zero
    rows at a negative index."""
    rng = numpy.random.default_rng(5)
    data = rng.integers(0, 256, (20, 12)).astype(numpy.uint8)
    kwargs = _KWARGS.get(name, {})
    port = normalization.normalizer_factory(name, **kwargs)
    ref = jax_norm.normalizer_factory(name, **kwargs)
    port.analyze(data)
    ref.analyze(data)
    scale, shift = gather.affine_tensors(port.as_affine(), "cpu")
    table = torch.as_tensor(data)
    assert scale.numel() == shift.numel()
    assert gather._norm_table(table, scale, shift) == 12
    rows = [3, 0, 19]
    got = gather.take_rows_norm(
        table, torch.tensor(rows + [-1], dtype=torch.int32),
        (scale, shift)).numpy()
    want = data[rows].astype(numpy.float32)
    ref.normalize(want)
    assert numpy.abs(got[:3] - want).max() <= NORM_TOL * max(
        1.0, float(numpy.abs(want).max()))
    assert not got[3].any()


def _run_units(port_unit, jax_unit):
    port_unit.initialize(device=CPUDevice())
    jax_unit.initialize(device=None)
    port_unit.run()
    jax_unit.run()
    port_unit.output.map_read()
    jax_unit.output.map_read()
    return port_unit.output.mem, numpy.asarray(jax_unit.output.mem)


def test_mean_disp_unit_matches_jax():
    rng = numpy.random.default_rng(4)
    x = rng.integers(0, 255, (6, 4, 5)).astype(numpy.uint8)
    mean = rng.random((4, 5)).astype(numpy.float32) * 100
    rdisp = rng.random((4, 5)).astype(numpy.float32) / 50
    port = MeanDispNormalizer(DummyWorkflow())
    ref = JaxMeanDisp(JaxDummyWorkflow())
    port.input, ref.input = Vector(x.copy()), JaxVector(x.copy())
    port.mean.reset(mean.copy())
    port.rdisp.reset(rdisp.copy())
    ref.mean.reset(mean.copy())
    ref.rdisp.reset(rdisp.copy())
    got, want = _run_units(port, ref)
    assert got.dtype == numpy.float32 and numpy.array_equal(got, want)
    out = normalize.mean_disp_normalize(
        torch.from_numpy(x), torch.from_numpy(mean),
        torch.from_numpy(rdisp), dtype=torch.float32)
    assert numpy.array_equal(out.numpy(), want)


def test_input_joiner_matches_jax():
    rng = numpy.random.default_rng(5)
    parts = [rng.standard_normal((3, 2, 2)).astype(numpy.float32),
             rng.standard_normal((3, 5)).astype(numpy.float32),
             rng.standard_normal((3, 1, 3)).astype(numpy.float32)]
    port = InputJoiner(DummyWorkflow(), inputs=[Vector(p.copy())
                                                for p in parts])
    ref = JaxJoiner(JaxDummyWorkflow(), inputs=[JaxVector(p.copy())
                                               for p in parts])
    got, want = _run_units(port, ref)
    assert got.shape == (3, 12) and numpy.array_equal(got, want)
    assert numpy.array_equal(
        join.join([torch.from_numpy(p) for p in parts]).numpy(), want)
    with pytest.raises(ValueError, match="batch dims differ"):
        InputJoiner(DummyWorkflow(), inputs=[
            Vector(parts[0]), Vector(parts[1][:2])]).initialize(
                device=CPUDevice())


class _Source(object):
    """A loader's served state, as an Avatar sees it."""

    def __init__(self, vector_cls, device=None):
        rng = numpy.random.default_rng(6)
        self.minibatch_class, self.minibatch_size = 2, 3
        self.minibatch_offset, self.epoch_number = 9, 1
        self.minibatch_data = vector_cls(
            rng.standard_normal((4, 3)).astype(numpy.float32))
        self.minibatch_labels = vector_cls(numpy.arange(4, dtype=numpy.int32))
        self.minibatch_indices = vector_cls(numpy.array([5, 2, 7, -1],
                                                        numpy.int32))
        if device is not None:
            for vec in (self.minibatch_data, self.minibatch_labels,
                        self.minibatch_indices):
                vec.initialize(device)


@pytest.mark.parametrize("on_device", [False, True])
def test_avatar_clones_as_the_jax_avatar(on_device):
    src = _Source(Vector, CPUDevice() if on_device else None)
    jsrc = _Source(JaxVector)
    port = Avatar(DummyWorkflow(), source=src)
    ref = JaxAvatar(JaxDummyWorkflow(), source=jsrc)
    port.initialize()
    ref.initialize()
    port.run()
    ref.run()
    for attr in ("minibatch_class", "minibatch_size", "minibatch_offset",
                 "epoch_number"):
        assert getattr(port, attr) == getattr(ref, attr)
    for attr in ("minibatch_data", "minibatch_labels", "minibatch_indices"):
        assert numpy.array_equal(getattr(port, attr).mem,
                                 getattr(ref, attr).mem)
    assert not port.minibatch_targets
    # the avatar holds a copy: the source's next minibatch leaves it be
    kept = numpy.array(port.minibatch_data.mem)
    if on_device:
        src.minibatch_data.devmem.add_(1.0)
    else:
        src.minibatch_data.map_write()
        src.minibatch_data.mem[...] += 1.0
    assert numpy.array_equal(port.minibatch_data.mem, kept)


_HOG_CASES = {
    "default": ((2, 32, 32), {}),
    "orient6_cell4_block3": ((3, 20, 27), {"orientations": 6, "cell": 4,
                                            "block": 3}),
    "smaller_than_a_block": ((2, 8, 8), {"cell": 8, "block": 2}),
    "rgb": ((2, 16, 16, 3), {"cell": 4}),
    "block1": ((1, 24, 24), {"block": 1, "cell": 6}),
}


@pytest.mark.parametrize("case", sorted(_HOG_CASES))
def test_hog_matches_jax(case):
    shape, kwargs = _HOG_CASES[case]
    rng = numpy.random.default_rng(7)
    x = rng.random(shape).astype(numpy.float32)
    x[0, :6, :6] = 0.25            # a flat patch: sq == 0 there
    want = numpy.asarray(jax_hog.hog_batch(x, **kwargs))
    got = hog.hog_batch(torch.from_numpy(x), **kwargs).numpy()
    assert got.shape == want.shape
    assert numpy.abs(got - want).max() <= HOG_TOL
    if len(shape) == 3:
        one = hog.hog(torch.from_numpy(x[0]), **kwargs).numpy()
        assert numpy.abs(one - numpy.asarray(
            jax_hog.hog(x[0], **kwargs))).max() <= HOG_TOL
