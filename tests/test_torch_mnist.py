"""The port's unit/workflow core and MNIST slice against the JAX package,
on the CPU.

Units are held unit by unit against their JAX twins on the same numpy
inputs (the port on ``CPUDevice``, where ``cuda_run`` takes the plain
kernel versions; the JAX units on ``CPUDevice``), at a full and at a
one-sample batch: outputs within 1e-5, GD updates within 1e-6.  The
workflow is held end to end at MNIST width: the JAX
``create_workflow(device=CPUDevice(), max_epochs=3)`` with
``stitch=off`` and ``kernels=xla`` against the port's with
``device="cpu"``, both from ``seed_all`` of the same seed (so the same
initial weights and shuffles): per-epoch per-class ``n_err`` and the
confusion matrices equal, every parameter and momentum within 1e-4
absolute and within 1e-4 of its leaf's largest value.  The stand-in is
learned within one pass, so the first train pass's ``n_err`` and the
parameters are the sensitive checks.  The ``kernels=pallas`` arm (the
fused GD trio in interpret mode) is held on ``tests/test_kernels.py``'s
small blob task within that file's 1e-3.
"""

import jax
import numpy
import pytest

from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.config import root as jax_root
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
from veles_tpu.loader.fullbatch import FullBatchLoader as JaxFullBatch
from veles_tpu.memory import Vector as JaxVector
from veles_tpu.samples import datasets as jax_datasets
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu.znicz import all2all as jax_all2all
from veles_tpu.znicz import gd as jax_gd
from veles_tpu.znicz.evaluator import EvaluatorSoftmax as JaxEvaluator
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.backends import CPUDevice
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.memory import Vector, Watcher
from veles_tpu_torch.ops import gemm
from veles_tpu_torch.samples import datasets, mnist
from veles_tpu_torch.znicz import all2all, gd
from veles_tpu_torch.znicz.evaluator import EvaluatorSoftmax
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

SEED = 7
PARAM_TOL = 1e-4
FORWARDS = ["All2All", "All2AllTanh", "All2AllSigmoid", "All2AllRELU",
            "All2AllStrictRELU", "All2AllSoftmax"]
GDS = ["GradientDescent", "GDTanh", "GDSigmoid", "GDRELU",
       "GDStrictRELU", "GDSoftmax"]
HP = {"learning_rate": 0.05, "learning_rate_bias": 0.04,
      "weights_decay": 0.0005, "weights_decay_bias": 0.0001,
      "gradient_moment": 0.9, "gradient_moment_bias": 0.8}


@pytest.fixture
def engine_config():
    """The eager per-unit route of both packages; restores the global
    knobs it sets."""
    eng = jax_root.common.engine
    saved = {k: eng.get(k, d) for k, d in (
        ("kernels", "auto"), ("stitch", "on"), ("epoch_scan", "off"))}
    port_saved = root.common.engine.get("stitch", "on")
    eng.stitch = "off"
    eng.kernels = "xla"
    root.common.engine.stitch = "off"
    yield eng
    for key, value in saved.items():
        setattr(eng, key, value)
    root.common.engine.stitch = port_saved


def _synchronous(wf):
    """Make a JAX workflow wait for each unit's device results before
    the next unit runs.

    With asynchronous dispatch the JAX eager chain on the CPU is not
    deterministic: its loader rewrites the host label buffer of the next
    minibatch while a dispatched step may still read the previous one
    (the first train pass's n_err took 1287, 1625 and 1798 of 6000 in
    three runs of one seed).  Waiting after every unit gives 1287 in
    every run."""
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


def _seed(seed=SEED):
    """Both packages' streams (each package reseeds only its own: a
    workflow built before a reseed keeps its stream positions)."""
    jax_prng.seed_all(seed)
    prng.seed_all(seed)


def _host(vec):
    vec.map_read()
    return numpy.array(vec.mem)


# -- units, one by one --------------------------------------------------------

def _forward_pair(name, transposed, x):
    _seed()
    jwf, twf = JaxDummyWorkflow(), DummyWorkflow()
    kwargs = {"output_sample_shape": 7, "weights_transposed": transposed}
    jfwd = getattr(jax_all2all, name)(jwf, **kwargs)
    tfwd = getattr(all2all, name)(twf, **kwargs)
    jfwd.input, tfwd.input = JaxVector(x), Vector(x)
    jfwd.initialize(device=JaxCPUDevice())
    tfwd.initialize(device=CPUDevice())
    return jfwd, tfwd


@pytest.mark.parametrize("name", FORWARDS)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("batch", [13, 1])
def test_forward_units_match_jax(name, transposed, batch):
    x = numpy.random.default_rng(1).standard_normal(
        (batch, 4, 5)).astype(numpy.float32)
    jfwd, tfwd = _forward_pair(name, transposed, x)
    # seed_all gives the JAX package's initial weights bit for bit
    numpy.testing.assert_array_equal(_host(tfwd.weights),
                                     _host(jfwd.weights))
    numpy.testing.assert_array_equal(_host(tfwd.bias), _host(jfwd.bias))
    gemm.reset_launches()
    jfwd.run()
    tfwd.run()
    assert not any(gemm.launches.values())
    numpy.testing.assert_allclose(_host(tfwd.output), _host(jfwd.output),
                                  atol=1e-5, rtol=0)
    if name == "All2AllSoftmax":
        numpy.testing.assert_array_equal(_host(tfwd.max_idx),
                                         _host(jfwd.max_idx))


@pytest.mark.parametrize("name", GDS)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("batch", [13, 1])
def test_gd_units_match_jax(name, transposed, batch):
    rng = numpy.random.default_rng(2)
    x = rng.standard_normal((batch, 20)).astype(numpy.float32)
    eo = rng.standard_normal((batch, 7)).astype(numpy.float32)
    forward = FORWARDS[GDS.index(name)]
    jfwd, tfwd = _forward_pair(forward, transposed, x)
    jgd = getattr(jax_gd, name)(jfwd.workflow, **HP)
    tgd = getattr(gd, name)(tfwd.workflow, **HP)
    jgd.setup_from_forward(jfwd)
    tgd.setup_from_forward(tfwd)
    jgd.err_output, tgd.err_output = JaxVector(eo), Vector(eo)
    jgd.initialize(device=JaxCPUDevice())
    tgd.initialize(device=CPUDevice())
    for _ in range(2):          # the second step sees nonzero momenta
        jfwd.run()
        tfwd.run()
        jgd.run()
        tgd.run()
    for attr in ("weights", "bias", "gradient_weights", "gradient_bias",
                 "err_input"):
        numpy.testing.assert_allclose(
            _host(getattr(tgd, attr)), _host(getattr(jgd, attr)),
            atol=1e-6, rtol=0, err_msg=attr)


@pytest.mark.parametrize("n_valid", [9, 12])
def test_evaluator_softmax_matches_jax(n_valid):
    """A short batch (its padding labelled -1) and a full one."""
    rng = numpy.random.default_rng(3)
    logits = rng.standard_normal((12, 5)).astype(numpy.float32)
    out = numpy.exp(logits) / numpy.exp(logits).sum(1, keepdims=True)
    labels = rng.integers(0, 5, 12).astype(numpy.int32)
    labels[n_valid:] = -1
    max_idx = out.argmax(1).astype(numpy.int32)
    units = []
    for wf, unit_cls, vec_cls, dev in (
            (JaxDummyWorkflow(), JaxEvaluator, JaxVector, JaxCPUDevice()),
            (DummyWorkflow(), EvaluatorSoftmax, Vector, CPUDevice())):
        ev = unit_cls(wf)
        ev.output, ev.labels = vec_cls(out), vec_cls(labels)
        ev.max_idx, ev.batch_size = vec_cls(max_idx), n_valid
        ev.initialize(device=dev)
        ev.run()
        ev.run()                        # the confusion matrix accumulates
        units.append(ev)
    jev, tev = units
    numpy.testing.assert_allclose(_host(tev.err_output),
                                  _host(jev.err_output), atol=1e-7)
    assert int(tev.n_err) == int(jev.n_err)
    assert abs(float(tev.loss) - float(jev.loss)) < 1e-6
    numpy.testing.assert_array_equal(_host(tev.confusion_matrix),
                                     _host(jev.confusion_matrix))


# -- data, initial state and the workflow -------------------------------------

def test_mnist_stand_in_equals_jax():
    got = datasets.load_mnist()
    want = jax_datasets.load_mnist()
    assert got[-1] is False and want[-1] is False
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and g.shape == w.shape
        numpy.testing.assert_array_equal(g, w)


def _record_closes(wf, out):
    """Wrap the Decision's class close: (epoch, class, n_err, samples,
    confusion matrix so far) at every close."""
    dec, ev = wf.decision, wf.evaluator
    close = dec._close_class

    def recording(cls, check_epoch_end):
        out.append((int(dec.epoch_number), cls, float(dec.epoch_n_err[cls]),
                    int(dec.epoch_samples[cls]),
                    _host(ev.confusion_matrix)))
        return close(cls, check_epoch_end)
    dec._close_class = recording


def _jax_params(wf):
    gds = list(reversed(wf.gds))
    out = {}
    for i, fwd in enumerate(wf.forwards):
        for name, vec in (("weights", fwd.weights), ("bias", fwd.bias),
                          ("gradient_weights", gds[i].gradient_weights),
                          ("gradient_bias", gds[i].gradient_bias)):
            out["%d.%s" % (i, name)] = _host(vec)
    return out


def _assert_params_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        err = float(numpy.abs(got[name] - ref).max())
        assert err <= tol, (name, err)
        assert err <= tol * float(numpy.abs(ref).max()), (name, err)


def test_initial_weights_and_shuffles_equal_jax(engine_config):
    jax_prng.seed_all(SEED)
    jwf = jax_mnist.create_workflow(device=JaxCPUDevice(), max_epochs=3)
    prng.seed_all(SEED)
    twf = mnist.create_workflow(device="cpu", max_epochs=3)
    want, got = _jax_params(jwf), twf.params_to_numpy()
    for name in want:
        numpy.testing.assert_array_equal(got[name], want[name])
    numpy.testing.assert_array_equal(_host(twf.loader.shuffled_indices),
                                     _host(jwf.loader.shuffled_indices))
    # the next epoch's shuffle too
    jwf.loader.shuffle()
    twf.loader.shuffle()
    numpy.testing.assert_array_equal(_host(twf.loader.shuffled_indices),
                                     _host(jwf.loader.shuffled_indices))


def test_mnist_workflow_matches_jax(engine_config):
    jax_prng.seed_all(SEED)
    jwf = _synchronous(jax_mnist.create_workflow(device=JaxCPUDevice(),
                                                 max_epochs=3))
    want = []
    _record_closes(jwf, want)
    jwf.run()
    prng.seed_all(SEED)
    twf = mnist.create_workflow(device="cpu", max_epochs=3)
    got = []
    _record_closes(twf, got)
    gemm.reset_launches()
    twf.run()
    assert not any(gemm.launches.values())
    # 3 validation passes and 2 train passes
    assert [(e, c) for e, c, *_ in got] == \
        [(0, 1), (0, 2), (1, 1), (1, 2), (2, 1)]
    assert [g[:4] for g in got] == [w[:4] for w in want]
    for g, w in zip(got, want):
        numpy.testing.assert_array_equal(g[4], w[4])
    assert got[1][2] > 0 and got[-1][2] < got[0][2]
    assert [h["n_err"] for h in twf.decision.history] == \
        [int(g[2]) for g in got]
    _assert_params_close(twf.params_to_numpy(), _jax_params(jwf),
                         PARAM_TOL)
    results = twf.gather_results()
    assert results["best_validation_error_pt"] == \
        jwf.gather_results()["best_validation_error_pt"]


def test_device_chain_moves_only_the_index_slice(engine_config):
    """After the first train minibatch warms the parameters up, each
    minibatch moves exactly its 100 int32 indices to the device, and the
    only device→host copies are one per class end."""
    prng.seed_all(SEED)
    wf = mnist.create_workflow(device="cpu", max_epochs=2)
    h2d, loader_run = [], wf.loader.run

    def counted():
        h2d.append(Watcher.transfers()["h2d_bytes"])
        loader_run()
    wf.loader.run = counted
    d2h0 = Watcher.transfers()["d2h_transfers"]
    wf.run()
    steps = numpy.diff(h2d)
    assert len(h2d) == 10 + 60 + 10
    # minibatch 0 uploads the parameters; minibatch 10, the first train
    # one, the momenta
    assert set(steps[1:10].tolist() + steps[11:].tolist()) == {100 * 4}
    assert Watcher.transfers()["d2h_transfers"] - d2h0 == 3


# -- carrying weights across --------------------------------------------------

def test_params_round_trip_without_aliasing():
    prng.seed_all(SEED)
    wf = mnist.create_workflow(device="cpu", max_epochs=2)
    params = wf.params_to_numpy()
    assert sorted(params) == [
        "%d.%s" % (i, n) for i in (0, 1) for n in (
            "bias", "gradient_bias", "gradient_weights", "weights")]
    assert params["0.weights"].shape == (784, 100)
    new = {k: v + 0.5 for k, v in params.items()}
    wf.params_from_numpy(new)
    back = wf.params_to_numpy()
    for name in new:
        numpy.testing.assert_array_equal(back[name], new[name])
    snapshot = {k: v.copy() for k, v in new.items()}
    new["0.weights"][...] = 0.0           # the caller's array: not ours
    back["1.bias"][...] = 0.0             # our copy out: not ours either
    wf.run()                              # in-place updates
    for name in ("0.weights", "1.bias"):
        assert not numpy.array_equal(wf.params_to_numpy()[name],
                                     snapshot[name])
    numpy.testing.assert_array_equal(new["0.weights"], 0.0)
    with pytest.raises(KeyError):
        wf.params_from_numpy({"2.weights": params["0.weights"]})
    with pytest.raises(ValueError):
        wf.params_from_numpy({"0.weights": params["1.weights"]})


def test_a_collected_vector_releases_its_bytes_without_the_lock():
    """The garbage collector can run ``Vector.__del__`` inside the
    Watcher's locked section of the same thread (an allocation in
    ``track`` triggers a collection; the lock is not reentrant): the
    release must not take the lock, and the ledger applies it at its
    next locked call."""
    import threading
    vec = Vector(numpy.zeros(256, numpy.float32), category="collected")
    vec.initialize(CPUDevice())
    assert vec.devmem.numel() == 256
    held = Watcher.hbm_ledger()["by_category"]["collected"]["bytes"]
    assert held >= 1024

    def collect_inside_the_lock(box):
        with Watcher.lock:
            box.pop()                 # the last reference: __del__ runs

    worker = threading.Thread(target=collect_inside_the_lock,
                              args=([vec],), daemon=True)
    del vec
    worker.start()
    worker.join(10)
    assert not worker.is_alive()
    assert Watcher.hbm_ledger()["by_category"]["collected"]["bytes"] \
        == held - 1024


def test_jax_state_loads_into_the_port(engine_config):
    """``params_from_numpy`` takes a JAX workflow's state as it is: from
    other seeds, the port then computes the JAX forward on the first
    minibatch (the validation span is not shuffled)."""
    jax_prng.seed_all(11)
    jwf = jax_mnist.create_workflow(device=JaxCPUDevice(), max_epochs=2)
    prng.seed_all(12)
    twf = mnist.create_workflow(device="cpu", max_epochs=2)
    twf.params_from_numpy(_jax_params(jwf))
    for wf in (jwf, twf):
        wf.loader.run()
        wf.forwards[0].run()
    numpy.testing.assert_allclose(_host(twf.forwards[0].output),
                                  _host(jwf.forwards[0].output), atol=1e-5)


# -- the kernels=pallas arm ---------------------------------------------------

def _blobs():
    rng = numpy.random.default_rng(42)
    n_train, n_valid, dim = 96, 32, 16
    total = n_train + n_valid
    labels = numpy.tile(numpy.arange(4), total // 4)[:total]
    centers = rng.standard_normal((4, dim)) * 3.0
    data = (centers[labels]
            + rng.standard_normal((total, dim)) * 0.5).astype(numpy.float32)
    return data, [int(v) for v in labels], [0, n_valid, n_train]


class _JaxBlobs(JaxFullBatch):
    hide_from_registry = True

    def load_data(self):
        data, self.original_labels, self.class_lengths[:] = _blobs()
        self.original_data.mem = data


class _PortBlobs(FullBatchLoader):
    hide_from_registry = True

    def load_data(self):
        data, self.original_labels, self.class_lengths[:] = _blobs()
        self.original_data.mem = data


_BLOB_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 12},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}]


def test_pallas_arm_on_blobs_matches_port(engine_config):
    engine_config.kernels = "pallas"
    jax_prng.seed_all(5)
    jwf = JaxStandardWorkflow(
        None, loader_factory=lambda w: _JaxBlobs(w, minibatch_size=16),
        layers=[dict(s) for s in _BLOB_LAYERS],
        decision_config={"max_epochs": 3})
    jwf.launcher = JaxDummyLauncher()
    jwf.initialize(device=JaxCPUDevice())
    _synchronous(jwf).run()
    prng.seed_all(5)
    twf = StandardWorkflow(
        None, loader_factory=lambda w: _PortBlobs(w, minibatch_size=16),
        layers=[dict(s) for s in _BLOB_LAYERS],
        decision_config={"max_epochs": 3})
    twf.launcher = DummyLauncher()
    twf.initialize(device="cpu")
    twf.run()
    got, want = twf.params_to_numpy(), _jax_params(jwf)
    for name in want:
        numpy.testing.assert_allclose(got[name], want[name], atol=1e-3,
                                      rtol=1e-3, err_msg=name)


def test_workflow_options_not_ported_raise(engine_config):
    # fused=True is ported (item 7(b)); the plotters still raise
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        mnist.create_workflow(device="cpu", plotters_config={})
    # the u8 dataset needs the stitched head, which stitch=off turns off
    with pytest.raises(ValueError, match="stitched"):
        mnist.create_workflow(device="cpu", native=True)
    # the recurrent types are ported with the rest of 7(c): an LSTM over
    # the flat images (one sample a sequence of no steps) is a shape
    # error, not a refusal
    with pytest.raises(ValueError):
        mnist.create_workflow(device="cpu", layers=[
            {"type": "lstm", "->": {"hidden_units": 4}},
            {"type": "softmax", "->": {}}])


def test_mnist_cli_on_cpu(capsys):
    assert mnist.main(["--device", "cpu", "--max-epochs", "2"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"best_validation_error_pt": 0.0' in line
    assert "epochs_per_s" in line
