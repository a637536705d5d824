"""The port's MSE family against the JAX package, on the CPU.

- ``EvaluatorMSE``'s math (the per-row max-abs rescale, ``root`` and
  ``mean``) against the JAX unit's ``_device_math`` on the same numpy
  inputs: δ exactly, the metric within relative 1e-5 (the two sum the
  rows in another order);
- ``FullBatchLoaderMSE``'s served rows (data and targets, two raw f32
  tables padded with 0) against the JAX stitched head's stage function,
  and its eager fill against the JAX loader's, exactly;
- the MLP autoencoder (``samples/mnist_ae.py``) at hidden width 16
  against the JAX sample from the same seed, its JAX initial weights
  loaded through ``params_from_numpy``, stitched and eager: the same
  closes, each rmse within relative 1e-5, every parameter and momentum
  within 1e-4 absolute and of its leaf's largest value;
- a small MSE workflow (``tests/test_loader_device.py``'s) with the
  port's loader heading the stitched segment and with the loader a
  per-unit barrier (``engine.loader=host``): bit for bit the same, and
  within those tolerances of the JAX package's ``loader=host`` arm;
- the options the sample does not port raise naming ROADMAP item 7.
"""

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.config import root as jax_root
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
from veles_tpu.loader.fullbatch import \
    FullBatchLoaderMSE as JaxFullBatchMSE
from veles_tpu.memory import Vector as JaxVector
from veles_tpu.samples import mnist_ae as jax_mnist_ae
from veles_tpu.znicz.evaluator import EvaluatorMSE as JaxEvaluatorMSE
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.loader.fullbatch import FullBatchLoaderMSE
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.samples import mnist_ae
from veles_tpu_torch.znicz.evaluator import EvaluatorMSE
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

SEED = 7
RMSE_RTOL = 1e-5
PARAM_TOL = 1e-4
HIDDEN = 16


def _evaluators(rows, cols, root_, mean):
    shape = (rows, cols)
    jev = JaxEvaluatorMSE(JaxDummyWorkflow(), root=root_, mean=mean)
    tev = EvaluatorMSE(DummyWorkflow(), root=root_, mean=mean)
    jev.err_output = JaxVector(numpy.zeros(shape, numpy.float32))
    tev.err_output = Vector(numpy.zeros(shape, numpy.float32))
    return jev, tev


@pytest.mark.parametrize("root_", [True, False])
@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("batch", [9, 4, 0])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_mse_math_matches_jax(root_, mean, batch, as_tensor):
    """Rows past ``batch`` masked out; one row far larger than the rest
    (the rescale keeps its square finite in f32); ``batch`` as a number
    (the eager unit) or a 0-d f32 tensor (the stitched stage)."""
    rng = numpy.random.default_rng(batch)
    out = rng.standard_normal((9, 31)).astype(numpy.float32)
    target = rng.standard_normal((9, 31)).astype(numpy.float32)
    out[1] *= 1e18
    jev, tev = _evaluators(9, 31, root_, mean)
    want_err, want_mse = jev._device_math(jnp.asarray(out),
                                          jnp.asarray(target),
                                          jnp.float32(batch))
    tb = torch.tensor(float(batch)) if as_tensor else float(batch)
    err, mse = tev._device_math(torch.from_numpy(out),
                                torch.from_numpy(target), tb)
    numpy.testing.assert_array_equal(err.numpy(), numpy.asarray(want_err))
    assert err.dtype == torch.float32 and mse.dtype == torch.float32
    assert numpy.isfinite(float(mse))
    assert float(mse) == pytest.approx(float(want_mse), rel=RMSE_RTOL,
                                       abs=0 if batch else 1e-30)


@pytest.fixture
def engines():
    """Both packages' knobs, restored afterwards; the JAX package on its
    XLA kernels."""
    jeng, teng = jax_root.common.engine, root.common.engine
    keys = (("kernels", "auto"), ("stitch", "on"), ("epoch_scan", "off"),
            ("loader", "auto"))
    saved = [(eng, {k: eng.get(k, d) for k, d in keys})
             for eng in (jeng, teng)]
    jeng.kernels = "xla"
    yield jeng, teng
    for eng, values in saved:
        for key, value in values.items():
            setattr(eng, key, value)


def _host(vec):
    vec.map_read()
    return numpy.array(vec.mem)


def _workflows(engines, stitch, max_epochs=2, run=True):
    """(JAX, port) autoencoders from SEED at hidden width 16; the port
    takes the JAX initial weights through ``params_from_numpy``."""
    jeng, teng = engines
    jeng.stitch = teng.stitch = stitch
    jax_prng.seed_all(SEED)
    jwf = jax_mnist_ae.create_workflow(device=JaxCPUDevice(),
                                       max_epochs=max_epochs, hidden=HIDDEN)
    if stitch == "off":
        _synchronous(jwf)
    prng.seed_all(SEED)
    twf = mnist_ae.create_workflow(device="cpu", max_epochs=max_epochs,
                                   hidden=HIDDEN)
    twf.params_from_numpy(_jax_params(jwf))
    if run:
        jwf.run()
        twf.run()
    return jwf, twf


def _assert_params_close(got, want):
    """Every leaf within PARAM_TOL absolute and of its largest value."""
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        err = float(numpy.abs(got[name] - ref).max())
        assert err <= PARAM_TOL, (name, err)
        assert err <= PARAM_TOL * float(numpy.abs(ref).max()), (name, err)


def _synchronous(wf):
    """Make the JAX eager chain wait for each unit's device results (its
    loader rewrites host buffers a dispatched step may still read; see
    ``tests/test_torch_mnist.py``)."""
    import jax
    for unit in wf.units:
        def run(unit=unit, inner=unit.run):
            inner()
            for value in list(unit.__dict__.values()):
                if isinstance(value, JaxVector):
                    value = value._devmem_
                if isinstance(value, jax.Array):
                    value.block_until_ready()
        unit.run = run
    return wf


def _jax_params(wf):
    gds = list(reversed(wf.gds))
    out = {}
    for i, fwd in enumerate(wf.forwards):
        for name, vec in (("weights", fwd.weights), ("bias", fwd.bias),
                          ("gradient_weights", gds[i].gradient_weights),
                          ("gradient_bias", gds[i].gradient_bias)):
            out["%d.%s" % (i, name)] = _host(vec)
    return out


@pytest.mark.parametrize("offset,size", [(0, 100), (940, 60), (3, 1),
                                         (6999, 1), (500, 0)])
def test_served_targets_match_the_jax_head(engines, offset, size):
    """The stitched head of the autoencoder's loader: the data and the
    targets rows, two raw f32 tables, against the JAX head's."""
    jwf, twf = _workflows(engines, "on", run=False)
    jstage, tstage = jwf.loader.stitch_stage(), twf.loader.stitch_stage()

    def inputs(stage, asarray):
        t = {name: vec.devmem for name, vec in stage.params.items()}
        t["offset"], t["size"] = asarray(offset), asarray(size)
        return t
    want = jstage.fn(inputs(jstage, lambda v: jnp.asarray(v, jnp.int32)))
    got = tstage.fn(inputs(tstage,
                           lambda v: torch.tensor(v, dtype=torch.int32)))
    assert sorted(got) == sorted(want) == ["minibatch_data",
                                           "minibatch_targets"]
    for name in got:
        g, w = got[name].numpy(), numpy.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        numpy.testing.assert_array_equal(g, w, err_msg=name)
    assert not got["minibatch_targets"][size:].any()


def test_eager_fill_serves_the_jax_targets(engines):
    """The eager route: minibatch after minibatch, into the train pass,
    the data and targets of one group call equal the JAX loader's."""
    jwf, twf = _workflows(engines, "off", run=False)
    for _ in range(14):
        jwf.loader.run()
        twf.loader.run()
        assert twf.loader.minibatch_class == jwf.loader.minibatch_class
        for name in ("minibatch_data", "minibatch_targets"):
            numpy.testing.assert_array_equal(
                _host(getattr(twf.loader, name)),
                _host(getattr(jwf.loader, name)), err_msg=name)


@pytest.mark.parametrize("stitch", ["on", "off"])
def test_mnist_ae_matches_jax(engines, stitch):
    jwf, twf = _workflows(engines, stitch)
    closes = [(h["epoch"], h["cls"], h["batches"])
              for h in twf.decision.history]
    assert closes == [(0, "validation", 10), (0, "train", 60),
                      (1, "validation", 10)]
    assert twf.decision.best_epoch == jwf.decision.best_epoch
    assert twf.decision.best_mse == pytest.approx(
        float(jwf.decision.best_mse), rel=RMSE_RTOL)
    for cls in (1, 2):
        assert twf.decision.epoch_mse[cls] == pytest.approx(
            float(jwf.decision.epoch_mse[cls]), rel=RMSE_RTOL)
    _assert_params_close(twf.params_to_numpy(), _jax_params(jwf))
    assert twf.gather_results()["best_epoch"] == jwf.decision.best_epoch


def test_mnist_ae_params_round_trip(engines):
    """``params_to_numpy`` / ``params_from_numpy`` carry the
    autoencoder's weights, biases and momenta, as copies."""
    _jwf, twf = _workflows(engines, "on", max_epochs=1, run=False)
    params = twf.params_to_numpy()
    assert sorted(params) == ["0.bias", "0.gradient_bias",
                              "0.gradient_weights", "0.weights", "1.bias",
                              "1.gradient_bias", "1.gradient_weights",
                              "1.weights"]
    assert params["0.weights"].shape == (784, HIDDEN)
    assert params["1.weights"].shape == (HIDDEN, 784)
    moved = {name: value + 1.0 for name, value in params.items()}
    twf.params_from_numpy(moved)
    for name, value in moved.items():
        value += 1.0            # the workflow holds its own copy
    for name, value in twf.params_to_numpy().items():
        numpy.testing.assert_array_equal(value, params[name] + 1.0)


def _synth_mse(loader):
    rng = numpy.random.default_rng(3)
    data = rng.standard_normal((120, 12)).astype(numpy.float32)
    loader.original_data.mem = data
    loader.original_targets.mem = (data[:, :4] * 0.5).astype(numpy.float32)
    loader.class_lengths[:] = [0, 40, 80]


class SynthMSE(FullBatchLoaderMSE):
    load_data = _synth_mse


class JaxSynthMSE(JaxFullBatchMSE):
    load_data = _synth_mse


def _synth_workflow(package, loader_mode):
    """``tests/test_loader_device.py``'s MSE workflow in ``package``
    (``"port"`` or ``"jax"``) under ``engine.loader=loader_mode``."""
    port = package == "port"
    eng = (root if port else jax_root).common.engine
    eng.loader = loader_mode
    (prng if port else jax_prng).seed_all(SEED)
    wf = (StandardWorkflow if port else JaxStandardWorkflow)(
        None,
        loader_factory=lambda w: (SynthMSE if port else JaxSynthMSE)(
            w, minibatch_size=32),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
                 "<-": {"learning_rate": 0.05}},
                {"type": "all2all", "->": {"output_sample_shape": 4},
                 "<-": {"learning_rate": 0.05}}],
        loss_function="mse",
        decision_config={"max_epochs": 3, "fail_iterations": 10 ** 6})
    wf.launcher = DummyLauncher() if port else JaxDummyLauncher()
    wf.initialize(device="cpu" if port else JaxCPUDevice())
    if not port:
        _synchronous(wf)
    wf.run()
    return wf


def test_mse_loader_arms_match_the_jax_host_arm(engines):
    """The port's loader-headed route and its ``loader=host`` route give
    the same weights and rmse bit for bit; both are held against the
    JAX package's ``loader=host`` arm."""
    head = _synth_workflow("port", "auto")
    host = _synth_workflow("port", "host")
    assert head.stitch_report()[0]["loader_headed"]
    assert not host.stitch_report()[0]["loader_headed"]
    assert head.decision.history == host.decision.history
    for name, value in host.params_to_numpy().items():
        numpy.testing.assert_array_equal(head.params_to_numpy()[name],
                                         value, name)
    jwf = _synth_workflow("jax", "host")
    assert head.decision.best_epoch == jwf.decision.best_epoch
    for cls in (1, 2):
        assert head.decision.epoch_mse[cls] == pytest.approx(
            float(jwf.decision.epoch_mse[cls]), rel=RMSE_RTOL)
    _assert_params_close(head.params_to_numpy(), _jax_params(jwf))


@pytest.mark.parametrize("option", ["conv", "rbm_pretrain"])
def test_mnist_ae_options_not_ported_raise_naming_item_7(option):
    """Both options are ported: ``conv`` (the conv autoencoder, with the
    layer zoo) builds its three layers, ``rbm_pretrain`` (with the rest
    of 7(c)) starts the MLP autoencoder from the RBM's weights.  The
    name dates from when both options were refused; the test now checks
    that they build."""
    if option == "conv":
        wf = mnist_ae.create_workflow(device="cpu", max_epochs=1,
                                      conv=True)
        assert [type(f).__name__ for f in wf.forwards] == [
            "ConvTanh", "StochasticPoolingDepooling", "Deconv"]
        assert wf.forwards[-1].output.shape[1:] == (28, 28, 1)
        return
    wf = mnist_ae.create_workflow(device="cpu", max_epochs=1, hidden=8,
                                  **{option: True})
    assert [type(f).__name__ for f in wf.forwards] == [
        "All2AllSigmoid", "All2AllSigmoid"]
    assert wf.forwards[0].weights.shape == (784, 8)
    assert float(abs(wf.forwards[0].weights.mem).max()) > 0


def test_mnist_ae_cli_on_cpu(engines, capsys):
    assert mnist_ae.main(["--device", "cpu", "--max-epochs", "2",
                          "--epoch-scan", "auto"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"best_rmse"' in line and '"epochs_per_s"' in line
