"""The port's batch serving engine (``veles_tpu_torch.serve.engine``)
against the JAX package's (``veles_tpu.serve.engine``), on the CPU.

The model is ``tests/test_serve.py``'s tiny MLP (8 → 8 tanh → 4
softmax), trained once through the JAX package's workflow; its trained
forward weights are carried into the port two ways: as the JAX
engine's host params (a list of ``{"w", "b"}`` numpy dicts) given to
the port's ``InferenceEngine`` as they are, and into a port
``StandardWorkflow`` built from the same layer specs
(``params_from_numpy``).  The same numpy rows go through both engines:
outputs within 1e-6 (float) and 1e-5 (int8), the int8 trees bit for
bit.  On the CPU a port bucket is the eager forward over the padded
batch, counted once per bucket, so the compile counts equal the JAX
engine's AOT compiles, and every bucket's rows equal the port's own
``reference_forward`` byte for byte."""

import numpy
import pytest

from veles_tpu.backends import NumpyDevice
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
from veles_tpu.loader.fullbatch import FullBatchLoader as JaxFullBatch
from veles_tpu.quant import QuantizationError as JaxQuantizationError
from veles_tpu.serve.engine import InferenceEngine as JaxEngine
from veles_tpu.znicz.all2all import All2All as JaxAll2All
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
from veles_tpu_torch import quant
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.serve.engine import InferenceEngine
from veles_tpu_torch.znicz.all2all import All2All, All2AllTanh
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

TOL = 1e-6
INT8_TOL = 1e-5
LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.1}},
]
MAX_BATCH = 16


def _tiny_data():
    rng = numpy.random.default_rng(3)
    n = 80
    labels = (numpy.arange(n) % 4).astype(int)
    centers = rng.standard_normal((4, 8)) * 3
    data = (centers[labels]
            + rng.standard_normal((n, 8)) * 0.5).astype(numpy.float32)
    return data, [int(v) for v in labels]


class JaxTinyLoader(JaxFullBatch):
    def load_data(self):
        self.original_data.mem, self.original_labels = _tiny_data()
        self.class_lengths[:] = [0, 20, 60]


class TinyLoader(FullBatchLoader):
    def load_data(self):
        self.original_data.mem, self.original_labels = _tiny_data()
        self.class_lengths[:] = [0, 20, 60]


@pytest.fixture(scope="module")
def jax_wf():
    """The JAX package's tiny MLP, trained two epochs on its numpy
    device (``tests/test_serve.py``'s fixture)."""
    wf = JaxStandardWorkflow(
        None, loader_factory=lambda w: JaxTinyLoader(w, minibatch_size=20),
        layers=LAYERS, decision_config={"max_epochs": 2})
    wf.launcher = JaxDummyLauncher()
    wf.initialize(device=NumpyDevice())
    wf.run()
    return wf


def _jax_host_params(wf):
    params = []
    for unit in wf.forwards:
        unit.weights.map_read()
        unit.bias.map_read()
        params.append({"w": numpy.array(unit.weights.mem),
                       "b": numpy.array(unit.bias.mem)})
    return params


@pytest.fixture(scope="module")
def port_wf(jax_wf):
    """A port workflow of the same specs on the CPU, carrying the JAX
    workflow's trained forward weights."""
    wf = StandardWorkflow(
        None, loader_factory=lambda w: TinyLoader(w, minibatch_size=20),
        layers=LAYERS, decision_config={"max_epochs": 2})
    wf.launcher = DummyLauncher()
    wf.initialize(device="cpu")
    arrays = {}
    for i, state in enumerate(_jax_host_params(jax_wf)):
        arrays["%d.weights" % i] = state["w"]
        arrays["%d.bias" % i] = state["b"]
    wf.params_from_numpy(arrays)
    return wf


@pytest.fixture(scope="module")
def engines(jax_wf, port_wf):
    """Warmed float engines: the JAX package's lowered route, the
    port's, and the port's constructor given the JAX host params."""
    jax_engine = JaxEngine.from_workflow(jax_wf, max_batch_size=MAX_BATCH)
    port_engine = InferenceEngine.from_workflow(
        port_wf, max_batch_size=MAX_BATCH, device="cpu")
    carried = InferenceEngine(_jax_host_params(jax_wf), port_engine._apply,
                              (8,), max_batch_size=MAX_BATCH, device="cpu")
    for engine in (jax_engine, port_engine, carried):
        engine.warmup()
    yield jax_engine, port_engine, carried
    for engine in (jax_engine, port_engine, carried):
        engine.close()


def _rows(n, seed=7):
    return numpy.random.default_rng(seed + n).standard_normal(
        (n, 8)).astype(numpy.float32)


@pytest.mark.parametrize("n", list(range(1, 18)) + [37])
def test_engine_matches_jax_on_carried_weights(engines, n):
    jax_engine, port_engine, carried = engines
    x = _rows(n)
    want = jax_engine.infer(x)
    for engine in (port_engine, carried):
        got = engine.infer(x)
        assert got.shape == want.shape == (n, 4)
        assert got.dtype == numpy.float32
        numpy.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        # a padded bucket's rows == the forward at the exact shape
        assert got.tobytes() == engine.reference_forward(x).tobytes()


def test_compile_count_capacity_and_the_empty_batch(engines):
    jax_engine, port_engine, carried = engines
    assert port_engine.buckets == jax_engine.buckets == (1, 2, 4, 8, 16)
    for engine in (jax_engine, port_engine, carried):
        assert engine.compile_count == len(engine.buckets)
    for n in (1, 3, 9, 16, 37):
        port_engine.infer(_rows(n))
    # no bucket is counted again after warmup
    assert port_engine.compile_count == len(port_engine.buckets)
    for n in (37, 3, 16, 17, 1):
        assert port_engine.padded_capacity(n) == \
            jax_engine.padded_capacity(n)
    assert port_engine.padded_capacity(37) == 40
    calls = port_engine.infer_calls
    empty = port_engine.infer(numpy.empty((0, 8), numpy.float32))
    want = jax_engine.infer(numpy.empty((0, 8), numpy.float32))
    assert empty.shape == want.shape == (0, 4)
    assert empty.dtype == want.dtype
    assert port_engine.infer_calls == calls
    with pytest.raises(ValueError, match="sample shape"):
        port_engine.infer(numpy.ones((2, 5), numpy.float32))


def test_infer_calls_count_chunks_like_the_jax_engine(jax_wf, port_wf):
    jax_engine = JaxEngine.from_workflow(jax_wf, max_batch_size=8)
    port_engine = InferenceEngine.from_workflow(port_wf, max_batch_size=8,
                                                device="cpu")
    for n in (1, 8, 9, 20):
        jax_engine.infer(_rows(n))
        port_engine.infer(_rows(n))
    assert port_engine.infer_calls == jax_engine.infer_calls == 7
    # lazily, each bucket is counted at its first use
    assert port_engine.compile_count == jax_engine.compile_count


def test_from_workflow_matches_jax_lowered_route(jax_wf, port_wf):
    jax_engine = JaxEngine.from_workflow(jax_wf, max_batch_size=8)
    port_engine = InferenceEngine.from_workflow(port_wf, max_batch_size=8,
                                                device="cpu")
    chained = InferenceEngine.from_forwards(port_wf.forwards,
                                            max_batch_size=8, device="cpu")
    assert port_engine.sample_shape == jax_engine.sample_shape == (8,)
    x = numpy.array(jax_wf.loader.original_data.mem[:5])
    numpy.testing.assert_allclose(port_engine.infer(x), jax_engine.infer(x),
                                  rtol=0, atol=TOL)
    assert port_engine.infer(x).tobytes() == chained.infer(x).tobytes()
    # the lowered route's ingest: integer rows are cast to float32
    ints = numpy.arange(16, dtype=numpy.int32).reshape(2, 8) % 5
    numpy.testing.assert_allclose(
        port_engine.reference_forward(ints),
        numpy.asarray(jax_engine._jit(jax_engine._params, ints)),
        rtol=0, atol=TOL)


def test_live_engine_tracks_updates(jax_wf, port_wf):
    live = InferenceEngine.from_forwards(port_wf.forwards, live=True,
                                         max_batch_size=4, device="cpu")
    live.warmup()
    x = _rows(3)
    before = live.infer(x)
    saved = port_wf.params_to_numpy()
    try:
        scaled = {name: value * 0.5 for name, value in saved.items()
                  if name.endswith(("weights", "bias"))
                  and "gradient" not in name}
        port_wf.params_from_numpy(scaled)
        after = live.infer(x)
        assert not numpy.array_equal(before, after)
        jax_engine = JaxEngine.from_forwards(jax_wf.forwards,
                                             max_batch_size=4)
        jax_engine.update_params([
            {"w": state["w"] * 0.5, "b": state["b"] * 0.5}
            for state in _jax_host_params(jax_wf)])
        numpy.testing.assert_allclose(after, jax_engine.infer(x), rtol=0,
                                      atol=TOL)
        # the copies went into the captured tensors: no new bucket
        assert live.compile_count == len(live.buckets)
    finally:
        port_wf.params_from_numpy(saved)
    numpy.testing.assert_array_equal(live.infer(x), before)


def test_update_params_refuses_another_tree(engines):
    _, port_engine, _ = engines
    with pytest.raises(ValueError, match="structure"):
        port_engine.update_params([{"w": numpy.zeros((8, 8))}])


def _host_tree(tree):
    return [{key: ({k: numpy.asarray(v) for k, v in leaf.items()}
                   if isinstance(leaf, dict) else numpy.asarray(leaf))
             for key, leaf in state.items()} for state in tree]


def test_quantize_int8_gives_the_jax_tree_bit_for_bit(jax_wf, port_wf):
    calibration = numpy.array(jax_wf.loader.original_data.mem[:20])
    jax_engine = JaxEngine.from_workflow(jax_wf, max_batch_size=8)
    port_engine = InferenceEngine.from_workflow(port_wf, max_batch_size=8,
                                                device="cpu")
    float_bytes = port_engine.params_nbytes
    assert float_bytes == jax_engine.params_nbytes
    jax_engine.quantize_int8(calibration=calibration)
    port_engine.quantize_int8(calibration=calibration)
    assert port_engine.quantized == jax_engine.quantized == "int8"
    want = _host_tree(jax_engine._params)
    got = _host_tree(quant.core._host(port_engine._params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in ("q", "scale"):
            assert g["w"][key].dtype == w["w"][key].dtype
            numpy.testing.assert_array_equal(g["w"][key], w["w"][key])
        numpy.testing.assert_array_equal(g["b"], w["b"])
    assert port_engine.params_nbytes == jax_engine.params_nbytes
    assert port_engine.describe()["quantize"] == "int8"
    port_engine.warmup()
    jax_engine.warmup()
    for n in (1, 5, 8, 13):
        x = _rows(n)
        got_rows = port_engine.infer(x)
        numpy.testing.assert_allclose(got_rows, jax_engine.infer(x),
                                      rtol=0, atol=INT8_TOL)
        assert got_rows.tobytes() == \
            port_engine.reference_forward(x).tobytes()
    with pytest.raises(RuntimeError, match="before warmup"):
        port_engine.quantize_int8()


def test_quantize_int8_refuses_live_engines(port_wf):
    live = InferenceEngine.from_forwards(port_wf.forwards, live=True,
                                         max_batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="live"):
        live.quantize_int8()


def test_quantization_error_names_the_stage_jax_names():
    """``tests/test_quant.py``'s planted bad stage: big in-channel
    weights that cancel on the calibration rows; both packages must
    blame stage 1."""
    rng = numpy.random.default_rng(6)
    w0 = numpy.eye(8, dtype=numpy.float32)
    w1 = rng.standard_normal((8, 4)).astype(numpy.float32)
    w1[0, :] = 1e5
    w1[1, :] = -1e5
    calibration = rng.standard_normal((4, 8)).astype(numpy.float32)
    calibration[:, 1] = calibration[:, 0]

    def jax_apply(params, x):
        h = JaxAll2All.pure(params[0], x, activation="tanh")
        return JaxAll2All.pure(params[1], h)

    wf = DummyWorkflow()
    tanh, linear = All2AllTanh(wf), All2All(wf)

    def apply_fn(params, x):
        return linear.pure(params[1], tanh.pure(params[0], x))

    jax_engine = JaxEngine([{"w": w0}, {"w": w1}], jax_apply,
                           sample_shape=(8,), max_batch_size=4)
    port_engine = InferenceEngine([{"w": w0}, {"w": w1}], apply_fn, (8,),
                                  max_batch_size=4, device="cpu")
    with pytest.raises(JaxQuantizationError) as want:
        jax_engine.quantize_int8(calibration=calibration)
    with pytest.raises(quant.QuantizationError) as got:
        port_engine.quantize_int8(calibration=calibration)
    assert got.value.layer == want.value.layer == "stage[1].w"
    assert got.value.drift > 0.5
    numpy.testing.assert_allclose(got.value.drift, want.value.drift,
                                  rtol=1e-4)
    assert port_engine.quantized is None
    for engine in (jax_engine, port_engine):
        engine.close()


MNIST_WIDTHS = (784, 100, 10)


@pytest.fixture(scope="module")
def mnist_engines():
    """A 784 → 100 tanh → 10 engine of each package over the same
    seeded numpy weights (the MNIST MLP's widths), warmed; buckets up to
    64 rows."""
    rng = numpy.random.default_rng(11)
    params = [{"w": (rng.standard_normal((a, b)) / numpy.sqrt(a)).astype(
        numpy.float32), "b": rng.standard_normal(b).astype(numpy.float32)}
        for a, b in zip(MNIST_WIDTHS, MNIST_WIDTHS[1:])]

    def jax_apply(p, x):
        return JaxAll2All.pure(p[1], JaxAll2All.pure(p[0], x,
                                                     activation="tanh"))

    wf = DummyWorkflow()
    tanh, linear = All2AllTanh(wf), All2All(wf)

    def apply_fn(p, x):
        return linear.pure(p[1], tanh.pure(p[0], x))

    jax_engine = JaxEngine(params, jax_apply, sample_shape=(784,),
                           max_batch_size=64)
    port_engine = InferenceEngine(params, apply_fn, (784,),
                                  max_batch_size=64, device="cpu")
    for engine in (jax_engine, port_engine):
        engine.warmup()
    yield jax_engine, port_engine
    for engine in (jax_engine, port_engine):
        engine.close()


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 13, 31, 33, 64])
def test_mnist_width_bucket_rows_equal_the_unbatched_forward(mnist_engines,
                                                             n):
    """The JAX package's promise (``tests/test_serve.py``): a padded
    bucket's rows equal the forward at the exact shape byte for byte.
    On the CPU the plain GEMM takes each row as its own product, so it
    holds at fan-in 784 too (MKL's M-sized kernels broke it); the rows
    also agree with the JAX engine within 1e-5."""
    jax_engine, port_engine = mnist_engines
    x = numpy.random.default_rng(100 + n).random((n, 784)).astype(
        numpy.float32)
    got = port_engine.infer(x)
    assert got.shape == (n, 10) and got.dtype == numpy.float32
    assert got.tobytes() == port_engine.reference_forward(x).tobytes()
    # each row alone, as a 1-row request would be served
    for i in (0, n - 1):
        assert got[i:i + 1].tobytes() == port_engine.reference_forward(
            x[i:i + 1]).tobytes()
    numpy.testing.assert_allclose(got, jax_engine.infer(x), rtol=0,
                                  atol=1e-5)
