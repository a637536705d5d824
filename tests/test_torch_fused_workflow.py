"""``StandardWorkflow(fused=True)`` and the options of ROADMAP item 7(b)
against the JAX package, on the CPU.

- The MNIST sample on its synthetic stand-in (784→100 tanh→10 softmax,
  minibatch 100, u8-resident, scaled in the step), two epochs from one
  seed in both packages: every class close's ``n_err`` equal, the
  validation confusion matrices of the trained weights equal, and every
  weight and bias within 1e-5 max abs (what we measure is ~1e-7: the
  products' sums in another order).
- The bf16 mode (``engine.precision_type="bfloat16"`` in the port,
  ``compute_dtype=bfloat16`` in the JAX trainer) on a small task (a
  12→8→3 stack, 8 train steps): each train minibatch's loss and every
  weight within 1e-5 of JAX's, with each train step's 5 products, 2 of
  them (layer 1's forward and weight gradient) in bf16, and each eval
  step's 2 in f32, as the JAX trainer's.  Measured on the CPU over the
  seeds 5, 6 and 7: the port's bf16 run is 1.2e-7 from JAX's in the
  losses and 6.0e-8 in the weights (both compute the products of the
  same bf16 operands exactly in f32), while an f32 run of the port is
  5.4e-4 to 1.1e-3 from JAX's bf16 run in the losses and 4.3e-4 to
  8.2e-4 in the weights; 1e-5 lies between the two.
- Snapshot resume with the solver state, against the JAX package's
  resume under the same protocol (``tests/test_fused_parallel.py``:
  run, pickle, raise ``max_epochs``, ``initialize``, run).
- Epoch mode against the port's own per-minibatch step fed the same
  order; ``Rollback`` (eager and fused) and ``LearningRateAdjust``
  (eager and fused) against the JAX package under the protocols of
  ``tests/test_rollback.py`` and ``tests/test_lr_adjust.py``; mcdnnic
  parsing; the image saver's PNGs; serving a fused workflow.
- The refusals: none left of 7(c) (a conv topology and a recurrent
  layer build now) or of 7(d) (``mesh_axes``, ``fsdp`` and ``tp``
  build and train: over one process the one-device run bit for bit),
  the plotters (7(e),
  refused when given at all: ``plotters_config={}`` built silently
  before) and ``rollback_config={}``, which links a Rollback with the
  JAX defaults (it linked none before).
"""

import io
import os
import pickle

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.config import root as jax_root
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
from veles_tpu.loader.fullbatch import FullBatchLoader as JaxFullBatch
from veles_tpu.memory import Vector as JaxVector
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu.znicz import image_saver as jax_image_saver
from veles_tpu.znicz import mcdnnic as jax_mcdnnic
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.backends import CPUDevice
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.samples import mnist
from veles_tpu_torch.znicz import fused_graph, image_saver, mcdnnic
from veles_tpu_torch.znicz.rollback import Rollback
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

PARAM_TOL = 1e-5
BF16_TOL = 1e-5
N_VALID, N_TRAIN, DIM, CLASSES, BATCH = 40, 160, 12, 3, 20

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
    {"type": "softmax", "->": {"output_sample_shape": CLASSES},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
]


def _dataset():
    rng = numpy.random.default_rng(4)
    n = N_VALID + N_TRAIN
    labels = rng.integers(0, CLASSES, n)
    centers = rng.random((CLASSES, DIM)) * 160 + 40
    x = numpy.clip(centers[labels] + rng.standard_normal((n, DIM)) * 40,
                   0, 255).astype(numpy.uint8)
    return x, [int(v) for v in labels]


def _load(self):
    x, labels = _dataset()
    self.original_data.mem = x if self.native_device_dtype \
        else x.astype(numpy.float32) / 255.0
    self.original_labels = labels
    self.class_lengths[:] = [0, N_VALID, N_TRAIN]


class Tiny(FullBatchLoader):
    load_data = _load


class JaxTiny(JaxFullBatch):
    load_data = _load


def _build(jax_side, max_epochs=2, native=True, layers=LAYERS, **kwargs):
    """The tiny workflow of one package, initialized on the CPU."""
    loader = JaxTiny if jax_side else Tiny
    klass = JaxStandardWorkflow if jax_side else StandardWorkflow
    wf = klass(
        None, loader_factory=lambda w: loader(
            w, minibatch_size=BATCH, native_device_dtype=native,
            normalization_type="scale" if native else "none"),
        layers=[dict(s) for s in layers],
        decision_config={"max_epochs": max_epochs, "fail_iterations": 50},
        **kwargs)
    wf.launcher = JaxDummyLauncher() if jax_side else DummyLauncher()
    wf.initialize(device=JaxCPUDevice() if jax_side else CPUDevice())
    return wf


def _seed(seed):
    jax_prng.seed_all(seed)
    prng.seed_all(seed)


def _record(wf):
    """Record ``(epoch, class, n_err)`` at each of the Decision's class
    closes (both packages close through ``_close_class``)."""
    dec = wf.decision
    dec.closes_seen = []
    close = dec._close_class

    def recording(cls, check_epoch_end):
        dec.closes_seen.append((int(dec.epoch_number), int(cls),
                                float(dec.epoch_n_err[cls])))
        return close(cls, check_epoch_end)
    dec._close_class = recording
    return wf


def _synchronous(wf):
    """The JAX eager chain waiting for each unit's results: on the CPU
    its loader rewrites a host buffer that a dispatched step may still
    read, which under load changes the JAX run's errors."""
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


def _closes(wf):
    return wf.decision.closes_seen


def _weights(wf):
    out = []
    for fwd in wf.forwards:
        fwd.weights.map_read()
        fwd.bias.map_read()
        out.append((numpy.array(fwd.weights.mem, numpy.float32),
                    numpy.array(fwd.bias.mem, numpy.float32)))
    return out


def _assert_close(jwf, twf, tol):
    for (jw, jb), (tw, tb) in zip(_weights(jwf), _weights(twf)):
        assert numpy.abs(jw - tw).max() <= tol
        assert numpy.abs(jb - tb).max() <= tol


def _confusion(weights, x, labels, classes):
    """The confusion matrix of the tanh → softmax MLP ``weights`` over
    ``x`` (already normalized)."""
    (w1, b1), (w2, b2) = weights
    h = numpy.tanh((x @ w1 + b1) * 0.6666) * 1.7159
    pred = (h @ w2 + b2).argmax(axis=1)
    out = numpy.zeros((classes, classes), numpy.int64)
    numpy.add.at(out, (pred, labels), 1)
    return out


# -- the MNIST sample -----------------------------------------------------------

def test_fused_mnist_matches_jax():
    _seed(3)
    jwf = _record(jax_mnist.create_workflow(
        device=JaxCPUDevice(), max_epochs=2, native=True, fused=True))
    jwf.run()
    twf = _record(mnist.create_workflow(device="cpu", max_epochs=2,
                                        native=True, fused=True))
    twf.run()
    assert _closes(twf) == _closes(jwf)
    _assert_close(jwf, twf, PARAM_TOL)
    data = numpy.array(twf.loader.original_data.mem[:1000],
                       numpy.float32) / 255.0
    labels = numpy.array(twf.loader.original_labels[:1000])
    assert numpy.array_equal(_confusion(_weights(twf), data, labels, 10),
                             _confusion(_weights(jwf), data, labels, 10))


def test_fused_bf16_matches_jax(monkeypatch):
    from veles_tpu_torch.ops import gemm
    products = {"train": [], "eval": []}
    inner = gemm._matmul_call
    saved = root.common.engine.get("precision_type", "float32")
    root.common.engine.precision_type = "bfloat16"
    try:
        _seed(5)
        jwf = _build(True, fused=True,
                     fused_config={"compute_dtype": jnp.bfloat16})
        twf = _build(False, fused=True)

        def counted(a, w, bias, activation):
            train = int(twf.loader.minibatch_class) == 2
            products["train" if train else "eval"].append(a.dtype)
            return inner(a, w, bias, activation)
        losses, steps = [], {"train": 0, "eval": 0}
        for wf in (jwf, twf):
            seen = []
            trainer, run_step = wf.fused_trainer, wf.fused_trainer.run

            def run(trainer=trainer, run_step=run_step, seen=seen,
                    port=wf is twf):
                train = int(trainer.loader.minibatch_class) == 2
                if port:
                    steps["train" if train else "eval"] += 1
                run_step()
                if train:
                    seen.append(float(trainer.loss_value))
            trainer.run = run
            if wf is twf:
                monkeypatch.setattr(gemm, "_matmul_call", counted)
            wf.run()
            losses.append(seen)
    finally:
        root.common.engine.precision_type = saved
    assert twf.fused_trainer._params_[0]["w"].dtype == torch.float32
    assert len(losses[0]) == len(losses[1]) == steps["train"] == \
        N_TRAIN // BATCH
    # layer 1's forward and weight gradient in bf16, layer 2's forward,
    # input and weight gradients widened to f32; eval in f32, as in JAX
    assert len(products["train"]) == 5 * steps["train"]
    assert products["train"].count(torch.bfloat16) == 2 * steps["train"]
    assert products["eval"] == [torch.float32] * (2 * steps["eval"])
    assert steps["eval"] > 0
    assert numpy.abs(numpy.array(losses[0])
                     - numpy.array(losses[1])).max() <= BF16_TOL
    _assert_close(jwf, twf, BF16_TOL)


# -- resume, restore, epoch mode ------------------------------------------------

def _pickled_modules(blob):
    names = []

    class Recording(pickle.Unpickler):
        def find_class(self, module, name):
            names.append(module)
            return super().find_class(module, name)

    Recording(io.BytesIO(blob)).load()
    return names


def test_fused_snapshot_resume_matches_jax():
    _seed(8)
    resumed = []
    for jax_side in (True, False):
        wf = _build(jax_side, fused=True)
        wf.run()
        blob = pickle.dumps(wf)
        if not jax_side:
            # the trainer's tensors pickle as host numpy: no torch global
            assert not [m for m in _pickled_modules(blob)
                        if m.split(".")[0] == "torch"]
        loaded = pickle.loads(blob)
        assert loaded.fused_trainer._step_ is None
        assert loaded.fused_trainer.solver_state is not None
        loaded.launcher = JaxDummyLauncher() if jax_side \
            else DummyLauncher()
        loaded.decision.complete <<= False
        loaded.decision.max_epochs = 3
        loaded.initialize(device=JaxCPUDevice() if jax_side
                          else CPUDevice())
        _record(loaded).run()
        resumed.append(loaded)
    jwf, twf = resumed
    # the momenta came back: a restart from zero would differ
    assert isinstance(twf.fused_trainer.solver_state[0]["vw"],
                      numpy.ndarray)
    assert _closes(twf) == _closes(jwf)
    _assert_close(jwf, twf, PARAM_TOL)
    for j, t in zip(jwf.fused_trainer._params_, twf.fused_trainer._params_):
        assert numpy.abs(numpy.asarray(j["vw"]) - t["vw"].numpy()).max() \
            <= PARAM_TOL


def test_restore_train_state_refreshes_the_fused_trainer():
    prng.seed_all(2)
    wf = _build(False, fused=True)
    wf.run()
    train, meta = wf.capture_train_state()
    other = _build(False, fused=True, max_epochs=1)
    other.run()                       # builds its trainer
    velocity = other.fused_trainer._params_[0]["vw"].clone()
    other.restore_train_state(train, meta)
    for (w, b), state in zip(_weights(wf), other.fused_trainer._params_):
        assert numpy.array_equal(state["w"].numpy(), w)
        assert numpy.array_equal(state["b"].numpy(), b)
    # the solver state stays the trainer's own
    assert torch.equal(other.fused_trainer._params_[0]["vw"], velocity)


@pytest.mark.parametrize("native", [True, False])
def test_the_loader_serves_indices_and_the_step_gathers_them(monkeypatch,
                                                            native):
    """Fused, the loader serves each minibatch's indices only (its eager
    fill never runs) and the step gathers exactly those rows."""
    from veles_tpu_torch.znicz import fused_unit
    gathered = []
    gather = fused_unit.take_rows_group

    def recording(tables, indices):
        gathered.append(indices.clone())
        return gather(tables, indices)
    monkeypatch.setattr(fused_unit, "take_rows_group", recording)
    monkeypatch.setattr(FullBatchLoader, "fill_minibatch",
                        lambda self: pytest.fail("the eager fill ran"))
    prng.seed_all(2)
    wf = _build(False, fused=True, max_epochs=1, native=native)
    loader, serve = wf.loader, wf.loader.run
    served = []

    def run():
        serve()
        served.append(numpy.array(
            loader.minibatch_indices.mem[:int(loader.minibatch_size)]))
    loader.run = run
    wf.run()
    assert loader.rows_by_consumer
    assert len(gathered) == len(served) > 0
    for got, want in zip(gathered, served):
        assert numpy.array_equal(got.numpy(), want)
    assert not numpy.asarray(loader.minibatch_data.mem).any()


def test_epoch_mode_equals_the_per_minibatch_step_fed_its_order():
    prng.seed_all(6)
    wf = _record(_build(False, max_epochs=3, fused=True,
                        fused_config={"epoch_mode": True}))
    init = [dict(zip(("weights", "bias"), wb)) for wb in _weights(wf)]
    wf.run()
    trainer = wf.fused_trainer
    assert trainer.epoch_key_counter == 2
    assert trainer.graph_report()["window_0_8"]["eager"] == 2
    specs = [dict(s, init=i) for s, i in zip(LAYERS, init)]
    params, step, _e, _a = fused_graph.lower_specs(
        specs, (DIM,), input_norm=wf.loader.input_norm)
    params = fused_graph.to_tensors(params)
    start = int(wf.loader.class_end_offsets[1])
    data = wf.loader.original_data.devmem[start:]
    labels = wf.loader.resident_labels.devmem[start:]
    n_err = []
    for counter in range(2):
        idx = trainer.epoch_order(counter)
        for row in idx.long():
            params, metrics = step(params, data[row], labels[row])
            n_err.append(int(metrics["n_err"]))
    for state, got in zip(params, trainer._params_):
        for key in ("w", "b", "vw", "vb"):
            assert torch.equal(state[key], got[key]), key
    train_closes = [n for _e, cls, n in _closes(wf) if cls == 2]
    assert train_closes == [sum(n_err[:8]), sum(n_err[8:])]


# -- rollback and the LR adjuster -------------------------------------------------

def _epoch_close(wf, epoch, improved):
    wf.loader.epoch_ended <<= True
    wf.loader.epoch_number = epoch
    wf.decision.best_epoch = epoch if improved else epoch - 1


def _rollback_protocol(wf, fused):
    """``tests/test_rollback.py``'s drive: a best captured when it is
    declared, two bad epochs, the rollback; returns (rollbacks, lr,
    restored weights)."""
    rb = wf.rollback
    if fused:
        trainer = wf.fused_trainer
        trainer._build()
        _epoch_close(wf, 0, improved=True)
        rb.run()
        trainer.refresh_from_forwards()
        for fwd in wf.forwards:       # drift the trained state
            fwd.weights.map_write()
            fwd.weights.mem[...] += 1.0
        if hasattr(trainer._params_[0]["w"], "add_"):
            for state in trainer._params_:
                state["w"].add_(1.0)
        else:
            import jax
            trainer._params_ = jax.tree_util.tree_map(
                lambda a: a + 1.0, trainer._params_)
        _epoch_close(wf, 1, improved=False)
        rb.run()
        trainer._build()
        return (rb.rollbacks, trainer.layers[0]["<-"]["learning_rate"],
                numpy.asarray(trainer._params_[0]["w"]),
                numpy.asarray(trainer._params_[0]["vw"]))
    wf.loader.epoch_ended <<= False
    wf.loader.epoch_number = 0
    wf.decision.best_epoch = 0
    rb.run()
    fwd = wf.forwards[0]
    fwd.weights.map_write()
    fwd.weights.mem[...] += 5.0
    _epoch_close(wf, 0, improved=True)
    rb.run()
    fwd.weights.map_write()
    fwd.weights.mem[...] += 123.0
    _epoch_close(wf, 1, improved=False)
    rb.run()
    first = rb.rollbacks
    _epoch_close(wf, 2, improved=False)
    rb.run()
    fwd.weights.map_read()
    return (first, rb.rollbacks, float(wf.gds[0].learning_rate),
            numpy.array(fwd.weights.mem))


@pytest.mark.parametrize("fused", [False, True])
def test_rollback_matches_jax(fused):
    config = {"fail_iterations": 1 if fused else 2, "lr_factor": 0.5}
    outcomes = []
    for jax_side in (True, False):
        _seed(7)
        wf = _build(jax_side, max_epochs=1, fused=fused,
                    rollback_config=dict(config))
        assert (wf.rollback.trainer is not None) == fused
        outcomes.append(_rollback_protocol(wf, fused))
    (jax_out, port_out) = outcomes
    # fused: one rollback, lr halved; eager: none after one bad epoch,
    # one after two, lr halved
    counts = (1,) if fused else (0, 1)
    assert port_out[:len(counts)] == jax_out[:len(counts)] == counts
    assert port_out[len(counts)] == pytest.approx(jax_out[len(counts)])
    assert port_out[len(counts)] == pytest.approx(0.025)
    for j, t in zip(jax_out[len(counts) + 1:], port_out[len(counts) + 1:]):
        assert numpy.array_equal(numpy.asarray(j, numpy.float32), t)


LR_CONFIG = {"lr_policy_name": "step_exp",
             "lr_parameters": {"gamma": 0.5, "step": 3}}


@pytest.mark.parametrize("fused", [False, True])
def test_lr_adjuster_matches_jax(fused):
    saved = jax_root.common.engine.get("stitch", "on")
    jax_root.common.engine.stitch = "off"
    try:
        runs = []
        for jax_side in (True, False):
            _seed(4)
            wf = _record(_build(jax_side, native=fused, fused=fused,
                                lr_adjuster_config=dict(LR_CONFIG)))
            if jax_side and not fused:
                _synchronous(wf)
            wf.run()
            runs.append(wf)
    finally:
        jax_root.common.engine.stitch = saved
    jwf, twf = runs
    if fused:
        assert twf.lr_adjuster is None
        assert int(twf.fused_trainer._params_[0]["tick"]) == \
            int(jwf.fused_trainer._params_[0]["tick"]) == N_TRAIN // BATCH
    else:
        assert twf.lr_adjuster in twf.gds[0].links_from
        assert twf.decision in twf.lr_adjuster.links_from
        assert twf.lr_adjuster.t == jwf.lr_adjuster.t == N_TRAIN // BATCH
        assert [gd.learning_rate for gd in twf.gds] == pytest.approx(
            [gd.learning_rate for gd in jwf.gds])
    assert _closes(twf) == _closes(jwf)
    _assert_close(jwf, twf, 1e-4)


def test_an_eager_schedule_reaches_the_stitched_route():
    """The GD stages read their learning rate at every dispatch: the
    stitched run equals the per-unit one; the windows refuse the
    adjuster for the JAX package's reason."""
    saved = {k: root.common.engine.get(k) for k in ("stitch",
                                                     "epoch_scan")}
    jax_saved = jax_root.common.engine.get("epoch_scan", "off")
    params = {}
    try:
        for stitch in ("off", "on"):
            root.common.engine.stitch = stitch
            root.common.engine.epoch_scan = "auto"
            prng.seed_all(4)
            wf = _build(False, native=False,
                        lr_adjuster_config=dict(LR_CONFIG))
            wf.run()
            params[stitch] = _weights(wf)
        assert [r["recaptures"] for r in wf.stitch_report()] == [0, 0]
        reason = wf.epoch_scan_report()["reason"]
        jax_root.common.engine.epoch_scan = "auto"
        jwf = jax_mnist.create_workflow(
            device=JaxCPUDevice(), max_epochs=1, minibatch_size=1000,
            lr_adjuster_config=dict(LR_CONFIG))
        assert reason == jwf._epoch_runner_.reason
        assert "LearningRateAdjust" in reason
    finally:
        for key, value in saved.items():
            setattr(root.common.engine, key, value)
        jax_root.common.engine.epoch_scan = jax_saved
    for (wa, ba), (wb, bb) in zip(params["off"], params["on"]):
        assert numpy.array_equal(wa, wb) and numpy.array_equal(ba, bb)


# -- mcdnnic, the image saver, serving -------------------------------------------

TOPOLOGIES = ["12x256x256-32C4-MP2-64C4-MP3-32N-4N", "8N-3N", "1x1x12-3N",
              "100N", "5C3-MP2-7N-2N"]


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_mcdnnic_parses_as_jax(topology):
    parameters = {"->": {"weights_filling": "gaussian",
                         "n_kernels": 99},
                  "<-": {"learning_rate": 0.02}}
    assert mcdnnic.parse_topology(topology, parameters) == \
        jax_mcdnnic.parse_topology(topology, parameters)


@pytest.mark.parametrize("topology", ["", "8N-MP2", "12x3-4N", "3Q-4N"])
def test_mcdnnic_rejects_what_jax_rejects(topology):
    with pytest.raises(ValueError):
        jax_mcdnnic.parse_topology(topology)
    with pytest.raises(ValueError):
        mcdnnic.parse_topology(topology)


def test_mcdnnic_topology_trains_as_its_layers():
    """A topology string is another way to give the layers: the fused
    run equals the one from the layer dicts it parses to."""
    parameters = {"->": {"weights_filling": "gaussian"},
                  "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}
    runs = []
    for kwargs in ({"layers": [], "mcdnnic_topology": "1x1x12-8N-3N",
                    "mcdnnic_parameters": parameters},
                   {"layers": mcdnnic.parse_topology("8N-3N",
                                                     parameters)[1]}):
        prng.seed_all(1)
        wf = _record(_build(False, fused=True, **kwargs))
        wf.run()
        runs.append(wf)
    assert [s["type"] for s in runs[0].layers] == ["all2all_tanh",
                                                   "softmax"]
    assert _closes(runs[0]) == _closes(runs[1])
    _assert_close(runs[0], runs[1], 0.0)


def test_a_conv_topology_is_refused_naming_7c():
    """The layer zoo is ported: an mcdnnic conv topology builds its conv
    layer, and a recurrent layer, once refused naming 7(c), builds the
    fused trainer too.  The name dates from when both were refused."""
    class TinyImages(Tiny):
        def load_data(self):
            _load(self)
            self.original_data.mem = self.original_data.mem.reshape(
                -1, 4, 3, 1)

    wf = StandardWorkflow(
        None, loader_factory=lambda w: TinyImages(w, minibatch_size=BATCH),
        mcdnnic_topology="1x4x3-2C2-3N", fused=True,
        decision_config={"max_epochs": 1})
    wf.launcher = DummyLauncher()
    wf.initialize(device=CPUDevice())
    wf.run()
    assert [s["type"] for s in wf.layers] == ["conv_tanh", "softmax"]
    assert wf.forwards[0].weights.shape == (2, 2, 1, 2)
    class TinyRows(Tiny):
        def load_data(self):
            _load(self)
            self.original_data.mem = self.original_data.mem.reshape(
                -1, 4, 3)

    wf = StandardWorkflow(
        None, loader_factory=lambda w: TinyRows(w, minibatch_size=BATCH),
        layers=[{"type": "rnn", "->": {"hidden_units": 3,
                                       "last_only": True}},
                {"type": "softmax", "->": {"output_sample_shape": 3}}],
        fused=True, decision_config={"max_epochs": 1})
    wf.launcher = DummyLauncher()
    wf.initialize(device=CPUDevice())
    wf.run()
    assert [type(f).__name__ for f in wf.forwards] == [
        "SimpleRNN", "All2AllSoftmax"]
    assert wf.decision.history


def _saver(package, tmp, data, labels, preds, workflow):
    saver = package.ImageSaver(workflow, out_dirs=["", str(tmp), ""],
                               limit=3)
    saver.input, saver.labels, saver.max_idx = data, labels, preds
    saver.minibatch_class, saver.minibatch_size = 1, len(labels)
    saver.epoch_number = 2
    saver.run()
    return sorted(os.listdir(str(tmp)))


def test_image_saver_writes_what_jax_writes(tmp_path):
    pil = pytest.importorskip("PIL.Image")
    rng = numpy.random.default_rng(0)
    data = rng.random((6, 16)).astype(numpy.float32)
    labels = numpy.array([0, 1, 2, 1, 0, 2])
    preds = numpy.array([0, 2, 2, 0, 1, 1])
    names = {}
    for tag, package, wf in (("jax", jax_image_saver, JaxDummyWorkflow()),
                             ("port", image_saver, DummyWorkflow())):
        names[tag] = _saver(package, tmp_path / tag, data, labels, preds,
                            wf)
    # the first three mistakes (the limit), named epoch_truth_pred_count
    assert names["port"] == names["jax"] == sorted(
        ["2_1_2_00000.png", "2_1_0_00001.png", "2_0_1_00002.png"])
    for name in names["jax"]:
        with pil.open(str(tmp_path / "jax" / name)) as a, \
                pil.open(str(tmp_path / "port" / name)) as b:
            assert a.mode == b.mode == "L" and a.size == b.size == (4, 4)
            assert numpy.array_equal(numpy.asarray(a), numpy.asarray(b))


def test_write_png_round_trips_rgb(tmp_path):
    pil = pytest.importorskip("PIL.Image")
    image = numpy.random.default_rng(1).integers(
        0, 256, (5, 7, 3)).astype(numpy.uint8)
    image_saver.write_png(str(tmp_path / "x.png"), image)
    with pil.open(str(tmp_path / "x.png")) as decoded:
        assert decoded.mode == "RGB"
        assert numpy.array_equal(numpy.asarray(decoded), image)


def test_the_image_saver_runs_in_the_eager_workflow(tmp_path):
    prng.seed_all(2)
    wf = _build(False, native=False, max_epochs=1,
                image_saver_config={"out_dirs": ["", str(tmp_path), ""],
                                    "limit": 5})
    wf.run()
    saved = os.listdir(str(tmp_path))
    assert 0 < len(saved) <= 5
    assert all(name.startswith("0_") for name in saved)


def test_from_workflow_serves_the_fused_weights():
    from veles_tpu_torch.serve.engine import InferenceEngine
    prng.seed_all(9)
    wf = _build(False, fused=True, native=False)
    wf.run()
    trainer = wf.fused_trainer
    for state in trainer._params_:    # trained on after the epoch's sync
        state["w"].mul_(1.5)
    engine = InferenceEngine.from_workflow(wf, device="cpu",
                                           max_batch_size=8)
    x = numpy.array(wf.loader.original_data.mem[:8], numpy.float32)
    got = engine.infer(x)
    (w1, b1), (w2, b2) = [(s["w"].numpy(), s["b"].numpy())
                          for s in trainer._params_]
    h = numpy.tanh((x @ w1 + b1) * 0.6666) * 1.7159
    z = h @ w2 + b2
    want = numpy.exp(z - z.max(1, keepdims=True))
    want /= want.sum(1, keepdims=True)
    assert numpy.abs(got - want).max() <= 1e-5


# -- refusals and the options' fault ------------------------------------------------

def test_plotters_config_given_at_all_is_refused_naming_7e():
    for value in ({}, {"error": True}):
        with pytest.raises(NotImplementedError, match=r"item 7\(e\)"):
            _build(False, plotters_config=value)


def test_rollback_config_empty_links_a_rollback_with_the_jax_defaults():
    wf = _build(False, rollback_config={})
    jwf = _build(True, rollback_config={})
    assert isinstance(wf.rollback, Rollback)
    assert wf.decision in wf.rollback.links_from
    assert (wf.rollback.fail_iterations, wf.rollback.lr_factor) == \
        (jwf.rollback.fail_iterations, jwf.rollback.lr_factor) == (5, 0.5)


@pytest.mark.parametrize("option", [
    {"mesh_axes": {"data": -1}},
    {"mesh_axes": {"data": -1}, "fsdp": True},
    {"mesh_axes": {"data": -1, "model": 1}, "tp": True}])
def test_a_mesh_is_refused_naming_7d(option):
    """``mesh_axes``, ``fsdp`` and ``tp`` (``fsdp`` and ``tp`` once
    refused naming 7(d)) are ported: over one process each is the
    one-device run bit for bit (the ranks' runs are
    ``tests/test_torch_spmd.py``'s and ``tests/test_torch_fused_shard
    .py``'s)."""
    runs = []
    for config in ({}, option):
        _seed(6)
        wf = _record(_build(False, fused=True, fused_config=config))
        wf.run()
        runs.append((_closes(wf), _weights(wf)))
    assert runs[0][0] == runs[1][0]
    for (w0, b0), (w1, b1) in zip(runs[0][1], runs[1][1]):
        numpy.testing.assert_array_equal(w0, w1)
        numpy.testing.assert_array_equal(b0, b1)


def test_epoch_mode_on_a_slave_raises():
    wf = _build(False, fused=True, fused_config={"epoch_mode": True})
    wf.launcher.is_slave = True
    with pytest.raises(NotImplementedError, match="slaves"):
        wf.fused_trainer.initialize(device=CPUDevice())


def test_the_image_saver_is_eager_only():
    with pytest.raises(NotImplementedError, match="fused=False"):
        _build(False, fused=True, image_saver_config={"out_dirs": []})
