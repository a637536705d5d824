"""Whole-workflow snapshots of the port against the JAX package, on the
CPU.

- Pickling: a unit pickles without its transient (``_``-suffixed)
  state; a ``Bool`` expression survives a pickle and stays live; data
  links forward after an unpickle in a process whose class lost its
  descriptor; a trained MNIST workflow, eager, stitched or in windows
  with the health statistics on, pickles to opcodes that name no
  ``torch`` global (a device tensor would bring its storage along).
- The snapshotter: one export per improving validation with
  ``Decision.improved`` cleared after it, as many as the JAX package
  makes on the same task (its eager chain waiting for each unit's
  results, ``_jax_synchronous``); each codec round-trips with the ``_current``
  symlink; ``SnapshotterToDB`` by id, by ``latest`` and with a ``#`` in
  its path, a missing row or database raising ``KeyError``;
  ``load_snapshot`` from a local ``http.server`` URL; ``diagnose_pickle``
  naming the attribute at fault; ``compare_snapshots`` reporting equal /
  close / DIFFERENT / only-in-A / only-in-B.
- Resume, held against the JAX package run the same way: the protocol of
  ``tests/test_znicz_mlp.py::test_snapshot_mid_training_resumes`` (run,
  pickle, raise ``max_epochs``, clear ``complete``, ``initialize``,
  ``run``) on the eager and the stitched route, and a JAX
  ``capture_train_state()`` pair installed through the port's
  ``restore_train_state`` and run on in both.  The per-class closes and
  the confusion matrices are equal and every parameter and momentum is
  within ``PARAM_TOL`` = 1e-4 (``tests/test_torch_mnist.py``'s bound)
  absolute and of its leaf's largest value.  The JAX resume is the
  oracle, not the uninterrupted run: ``Loader.initialize`` shuffles the
  restored index space again (ROADMAP §3, reference faults).
- A graph capture holds the garbage collector off, also while another
  thread captures, so a collection cannot destroy an unreachable
  workflow's CUDA graphs mid-capture.
"""

import copy
import functools
import http.server
import io
import os
import pickle
import threading
import time

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
from veles_tpu.mutable import Bool as JaxBool
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu.snapshotter import SnapshotterToFile as JaxSnapshotter
from veles_tpu.snapshotter import diagnose_pickle as jax_diagnose_pickle
from veles_tpu.units import Unit as JaxUnit
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.samples import mnist
from veles_tpu_torch.scripts import compare_snapshots
from veles_tpu_torch.snapshotter import (SnapshotterToDB,
                                         SnapshotterToFile,
                                         diagnose_pickle, load_snapshot,
                                         save_snapshot)
from veles_tpu_torch.units import Unit
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

SEED = 5
PARAM_TOL = 1e-4


class _PortUnit(Unit):
    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(_PortUnit, self).__init__(workflow, **kwargs)
        self.weights = Vector()


class _JaxUnit(JaxUnit):
    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(_JaxUnit, self).__init__(workflow, **kwargs)
        self.weights = JaxVector()


PACKAGES = {"port": (DummyWorkflow, _PortUnit, Bool),
            "jax": (JaxDummyWorkflow, _JaxUnit, JaxBool)}


@pytest.fixture
def engines():
    """Both packages' engine knobs, restored afterwards; the JAX package
    on its XLA kernels."""
    jeng, teng = jax_root.common.engine, root.common.engine
    keys = (("kernels", "auto"), ("stitch", "on"), ("epoch_scan", "off"),
            ("health", "off"))
    jsaved = {k: jeng.get(k, d) for k, d in keys}
    tsaved = {k: teng.get(k, d) for k, d in keys[1:]}
    jeng.kernels = "xla"
    yield jeng, teng
    for key, value in jsaved.items():
        setattr(jeng, key, value)
    for key, value in tsaved.items():
        setattr(teng, key, value)


def _set_route(engines, route):
    for eng in engines:
        eng.stitch = "off" if route == "eager" else "on"


# -- pickling -----------------------------------------------------------------

def _pickled_state_keys(package):
    workflow_cls, unit_cls, _ = PACKAGES[package]
    wf = workflow_cls()
    unit = unit_cls(wf, name="keepme")
    unit.payload = [1, 2, 3]
    state = unit.__getstate__()
    restored = pickle.loads(pickle.dumps(unit))
    assert restored.name == "keepme" and restored.payload == [1, 2, 3]
    # the transients are made again by init_unpickled
    assert restored._gate_lock_ is not unit._gate_lock_
    assert restored._stitch_segment_ is None
    assert restored.workflow is None
    return state


def test_unit_pickles_without_its_transients():
    port, jax_state = (_pickled_state_keys(p) for p in ("port", "jax"))
    assert not any(key.endswith("_") for key in port)
    assert not any(key.endswith("_") for key in jax_state)
    for key in ("name", "payload", "links_from", "links_to",
                "gate_block", "gate_skip", "weights"):
        assert key in port and key in jax_state


def _truth_table(bool_cls):
    a, b = bool_cls(False), bool_cls(True)
    exprs = [a & b, a | ~b, (a ^ b) & ~a, ~(a | b)]
    a2, b2, exprs2 = pickle.loads(pickle.dumps((a, b, exprs)))
    rows = []
    for va in (False, True):
        for vb in (False, True):
            a2 <<= va
            b2 <<= vb
            rows.append([bool(e) for e in exprs2])
    return rows


def test_a_bool_expression_survives_a_pickle():
    assert _truth_table(Bool) == _truth_table(JaxBool)
    gate = Bool(False)
    shared = (~gate, ~gate)
    back_gate, back_shared = pickle.loads(pickle.dumps((gate, shared)))
    back_gate <<= True
    assert [bool(g) for g in back_shared] == [False, False]


def test_links_forward_after_an_unpickle_in_a_fresh_process():
    wf = DummyWorkflow()
    a = _PortUnit(wf, name="a")
    b = _PortUnit(wf, name="b")
    a.output2 = 5
    b.link_attrs(a, ("input2", "output2"))
    blob = pickle.dumps(wf)
    delattr(_PortUnit, "input2")       # the class of a fresh process
    restored = pickle.loads(blob)
    ra, rb = [u for u in restored if u.name in ("a", "b")]
    ra.output2 = 42
    assert rb.input2 == 42
    assert ra.workflow is restored and rb.workflow is restored


class _Globals(pickle.Unpickler):
    """Records every global a pickle names."""

    def __init__(self, blob):
        super(_Globals, self).__init__(io.BytesIO(blob))
        self.names = set()

    def find_class(self, module, name):
        self.names.add((module, name))
        return super(_Globals, self).find_class(module, name)


@pytest.mark.parametrize("route", ["eager", "stitched", "native",
                                   "windows"])
def test_a_pickled_workflow_names_no_torch_global(engines, route):
    _jeng, teng = engines
    _set_route(engines, route)
    if route == "windows":
        teng.epoch_scan = "auto"
        teng.health = "on"
    prng.seed_all(SEED)
    wf = mnist.create_workflow(device="cpu", max_epochs=2,
                               native=route in ("native", "windows"))
    wf.run()
    if route == "windows":
        assert wf.epoch_scan_report()["windows"] > 0
    params = wf.params_to_numpy()
    blob = pickle.dumps(wf, protocol=pickle.HIGHEST_PROTOCOL)
    loader = _Globals(blob)
    restored = loader.load()
    torch_names = sorted(n for n in loader.names
                         if n[0] == "torch" or n[0].startswith("torch."))
    assert torch_names == []
    back = restored.params_to_numpy()
    for name, value in params.items():
        numpy.testing.assert_array_equal(back[name], value)
    # the metric outputs of the segments' graphs come back as host values
    assert numpy.asarray(restored.evaluator.n_err).shape == ()


# -- the snapshotter ----------------------------------------------------------

def _blobs():
    rng = numpy.random.default_rng(3)
    n = 80
    labels = (numpy.arange(n) % 4).astype(int)
    centers = rng.standard_normal((4, 8)) * 3
    data = (centers[labels]
            + rng.standard_normal((n, 8)) * 0.5).astype(numpy.float32)
    return data, [int(v) for v in labels], [0, 20, 60]


class _PortTiny(FullBatchLoader):
    hide_from_registry = True

    def load_data(self):
        data, self.original_labels, self.class_lengths[:] = _blobs()
        self.original_data.mem = data


class _JaxTiny(JaxFullBatch):
    hide_from_registry = True

    def load_data(self):
        data, self.original_labels, self.class_lengths[:] = _blobs()
        self.original_data.mem = data


_TINY_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.1}},
]


def _tiny(package, max_epochs=3, **kwargs):
    if package == "port":
        prng.seed_all(SEED)
        wf = StandardWorkflow(
            None, loader_factory=lambda w: _PortTiny(w, minibatch_size=20),
            layers=[dict(s) for s in _TINY_LAYERS],
            decision_config={"max_epochs": max_epochs}, **kwargs)
        wf.launcher = DummyLauncher()
        wf.initialize(device="cpu")
        return wf
    jax_prng.seed_all(SEED)
    wf = JaxStandardWorkflow(
        None, loader_factory=lambda w: _JaxTiny(w, minibatch_size=20),
        layers=[dict(s) for s in _TINY_LAYERS],
        decision_config={"max_epochs": max_epochs}, **kwargs)
    wf.launcher = JaxDummyLauncher()
    wf.initialize(device=JaxCPUDevice())
    return wf


def _jax_synchronous(wf):
    """Make the JAX eager chain wait for each unit's results, on the
    units' classes (the snapshots pickle the instances); returns the
    undo.  On the CPU the JAX loader rewrites a host buffer that a
    dispatched step may still read: under load that changes the JAX
    run's errors, and with them its count of improvements (4 of 64 runs
    beside the heavy port files made a third)."""
    saved = []
    for klass in {type(unit) for unit in wf.units}:
        inner = klass.run

        def run(self, inner=inner):
            inner(self)
            for value in list(self.__dict__.values()):
                if isinstance(value, JaxVector):
                    value = value._devmem_
                if isinstance(value, jax.Array):
                    value.block_until_ready()
        saved.append((klass, klass.__dict__.get("run")))
        klass.run = run

    def undo():
        for klass, own in reversed(saved):
            if own is None:
                del klass.run
            else:
                klass.run = own
    return undo


def _count_exports(package, tmp_path, snapshotter_cls):
    wf = _tiny(package, max_epochs=6, snapshotter_config={
        "directory": str(tmp_path / package), "time_interval": 0.0})
    exports, improvements = [], []
    original = snapshotter_cls.export
    decision_cls = type(wf.decision)
    close = decision_cls._close_class
    undo = _jax_synchronous(wf) if package == "jax" else (lambda: None)

    def recording_close(self, cls, check_epoch_end):
        result = close(self, cls, check_epoch_end)
        if cls == 1:
            improvements.append(bool(self.improved))
        return result
    # patched on the classes: the snapshots pickle the instances
    decision_cls._close_class = recording_close
    snapshotter_cls.export = \
        lambda self: (exports.append(1), original(self))
    try:
        wf.run()
    finally:
        snapshotter_cls.export = original
        decision_cls._close_class = close
        undo()
    assert not bool(wf.decision.improved)
    return len(exports), sum(improvements), wf.snapshotter.destination


def test_one_export_per_improvement(engines, tmp_path):
    _set_route(engines, "eager")
    got, improved, path = _count_exports("port", tmp_path,
                                         SnapshotterToFile)
    want, _, _ = _count_exports("jax", tmp_path, JaxSnapshotter)
    assert got == improved == want >= 1
    assert os.path.basename(path).startswith("veles_tpu_torch_")
    assert path.endswith("pt.pickle.gz")
    restored = load_snapshot(path)
    assert restored.snapshotter.suffix == \
        "%.2fpt" % restored.decision.best_n_err_pt


def test_a_backward_wall_clock_step_loses_no_export(engines, tmp_path,
                                                    monkeypatch):
    """The wall clock steps back a second at every export (a clock
    correction): at ``time_interval`` 0 each improvement is still
    exported once, as the gate reads a monotonic clock.  Reading the
    wall clock, the gate skipped every export after the first until the
    next close lowered ``improved``."""
    _set_route(engines, "eager")
    wall, back = time.time, [0.0]
    monkeypatch.setattr(time, "time", lambda: wall() - back[0])
    export = SnapshotterToFile.export

    def stepping_export(self):
        back[0] += 1.0
        return export(self)

    monkeypatch.setattr(SnapshotterToFile, "export", stepping_export)
    got, improved, _ = _count_exports("port", tmp_path, SnapshotterToFile)
    assert got == improved >= 2
    assert back[0] == got


@pytest.mark.parametrize("compression", ["", "gz", "bz2", "xz"])
def test_each_codec_round_trips_with_the_current_link(tmp_path,
                                                      compression):
    wf = DummyWorkflow()
    unit = _PortUnit(wf, name="W")
    unit.weights.reset(numpy.arange(6, dtype=numpy.float32))
    snap = SnapshotterToFile(wf, directory=str(tmp_path),
                             compression=compression, time_interval=0.0,
                             prefix="p")
    wf.initialize()
    snap.suffix = "one"
    snap.export()
    ext = ".%s" % compression if compression else ""
    assert snap.destination == str(tmp_path / ("p_one.pickle" + ext))
    current = tmp_path / ("p_current.pickle" + ext)
    assert os.path.islink(current)
    assert os.readlink(current) == "p_one.pickle" + ext
    for path in (snap.destination, str(current)):
        restored = load_snapshot(path)
        assert type(restored).__name__ == "DummyWorkflow"
        numpy.testing.assert_array_equal(
            [u for u in restored if u.name == "W"][0].weights.mem,
            numpy.arange(6, dtype=numpy.float32))
    with pytest.raises(ValueError, match="unknown compression"):
        SnapshotterToFile(wf, directory=str(tmp_path), compression="lz4")


def _trained_tiny(engines, max_epochs=1):
    _set_route(engines, "eager")
    wf = _tiny("port", max_epochs=max_epochs)
    wf.run()
    return wf


def test_snapshot_db_by_id_and_latest(engines, tmp_path):
    wf = _trained_tiny(engines)
    db = str(tmp_path / "snaps.sqlite")
    snap = SnapshotterToDB(wf, database=db, time_interval=0.0)
    snap.export()
    first = snap.destination
    assert first == "db://%s#1" % db
    wf.decision.best_n_err_pt = -1.0
    snap.suffix = "better"
    snap.export()
    assert snap.destination == "db://%s#2" % db
    assert load_snapshot(first).decision.best_n_err_pt != -1.0
    assert load_snapshot("db://%s#latest" % db).decision.best_n_err_pt \
        == -1.0
    assert load_snapshot("db://%s" % db).decision.best_n_err_pt == -1.0
    with pytest.raises(KeyError):
        load_snapshot("db://%s#99" % db)
    # a '#' in the database path is kept
    weird = tmp_path / "run#3"
    weird.mkdir()
    db2 = str(weird / "s.sqlite")
    snap2 = SnapshotterToDB(wf, database=db2, time_interval=0.0)
    snap2.export()
    assert load_snapshot(snap2.destination).decision.best_n_err_pt == -1.0
    assert load_snapshot("db://%s" % db2) is not None
    # a missing database raises and is not made
    with pytest.raises(KeyError):
        load_snapshot("db://%s.typo#latest" % db2)
    assert not os.path.exists(db2 + ".typo")


def test_load_snapshot_from_an_http_url(engines, tmp_path):
    wf = _trained_tiny(engines)
    save_snapshot(wf, str(tmp_path / "wf_url.pickle.gz"))
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=str(tmp_path))
    httpd = http.server.HTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://127.0.0.1:%d/wf_url.pickle.gz" % httpd.server_port
        restored = load_snapshot(url)
    finally:
        httpd.shutdown()
        httpd.server_close()
    rows, worst = compare_snapshots.compare(wf, restored)
    assert worst == 0.0 and rows


def test_diagnose_pickle_names_the_attribute(tmp_path):
    wf = DummyWorkflow()
    unit = _PortUnit(wf, name="evil")
    unit.evil_callback = lambda: None
    lines = diagnose_pickle(wf, path="workflow")
    assert "workflow._units[2].evil_callback" in \
        [line.split(":")[0] for line in lines], lines
    jwf = JaxDummyWorkflow()
    _JaxUnit(jwf, name="evil").evil_callback = lambda: None
    jax_lines = jax_diagnose_pickle(jwf, path="workflow")
    assert [line.split(":")[0] for line in lines] == \
        [line.split(":")[0] for line in jax_lines]


def _weights_wf(scale, extra=None):
    wf = DummyWorkflow()
    unit = _PortUnit(wf, name="W")
    unit.weights.reset(numpy.full((3, 3), scale, numpy.float32))
    if extra is not None:
        unit.extra = Vector(numpy.zeros(2, numpy.float32))
    return wf


def test_compare_snapshots_reports_each_status(tmp_path):
    rows, worst = compare_snapshots.compare(_weights_wf(1.0),
                                            _weights_wf(1.0))
    assert rows == [("W.weights", "equal", 0.0)] and worst == 0.0
    rows, worst = compare_snapshots.compare(_weights_wf(1.0),
                                            _weights_wf(1.0 + 1e-7))
    assert rows[0][1] == "close" and 0 < worst < 1e-6
    rows, worst = compare_snapshots.compare(_weights_wf(1.0),
                                            _weights_wf(2.0))
    assert rows == [("W.weights", "DIFFERENT", 1.0)] and worst == 1.0
    rows, _ = compare_snapshots.compare(_weights_wf(1.0, extra=True),
                                        _weights_wf(1.0))
    assert ("W.extra", "only-in-A", None) in rows
    rows, _ = compare_snapshots.compare(_weights_wf(1.0),
                                        _weights_wf(1.0, extra=True))
    assert ("W.extra", "only-in-B", None) in rows
    paths = []
    for name, scale in (("a", 1.0), ("b", 1.0), ("c", 3.0)):
        paths.append(save_snapshot(_weights_wf(scale),
                                   str(tmp_path / ("%s.pickle.gz" % name))))
    assert compare_snapshots.main(paths[:2]) == 0
    assert compare_snapshots.main([paths[0], paths[2]]) == 1
    assert compare_snapshots.main([]) == 2


# -- resume, against the JAX package ------------------------------------------

def _record_closes(wf, out):
    dec, ev = wf.decision, wf.evaluator
    close = dec._close_class

    def recording(cls, check_epoch_end):
        ev.confusion_matrix.map_read()
        out.append((int(dec.epoch_number), cls,
                    float(dec.epoch_n_err[cls]),
                    int(dec.epoch_samples[cls]),
                    numpy.array(ev.confusion_matrix.mem)))
        return close(cls, check_epoch_end)
    dec._close_class = recording


def _jax_params(wf):
    gds = list(reversed(wf.gds))
    out = {}
    for i, fwd in enumerate(wf.forwards):
        for name, vec in (("weights", fwd.weights), ("bias", fwd.bias),
                          ("gradient_weights", gds[i].gradient_weights),
                          ("gradient_bias", gds[i].gradient_bias)):
            vec.map_read()
            out["%d.%s" % (i, name)] = numpy.array(vec.mem)
    return out


def _synchronous(wf):
    """Wait for each JAX unit's device results (the eager JAX chain is
    not deterministic under asynchronous dispatch,
    ``tests/test_torch_mnist.py``); ``_plain`` takes the wrappers off
    before a pickle."""
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


def _plain(wf):
    for unit in wf.units:
        unit.__dict__.pop("run", None)
    return wf


def _assert_same_run(got_closes, want_closes, got_params, want_params):
    assert [c[:4] for c in got_closes] == [c[:4] for c in want_closes]
    for got, want in zip(got_closes, want_closes):
        numpy.testing.assert_array_equal(got[4], want[4])
    assert sorted(got_params) == sorted(want_params)
    for name, ref in want_params.items():
        err = float(numpy.abs(got_params[name] - ref).max())
        assert err <= PARAM_TOL, (name, err)
        assert err <= PARAM_TOL * float(numpy.abs(ref).max()), (name, err)


def _jax_resume(route, first, then):
    jax_prng.seed_all(SEED)
    wf = jax_mnist.create_workflow(device=JaxCPUDevice(), max_epochs=first)
    if route == "eager":
        _synchronous(wf)
    wf.run()
    restored = pickle.loads(pickle.dumps(_plain(wf) if route == "eager"
                                         else wf))
    restored.launcher = JaxDummyLauncher()
    restored.decision.max_epochs = then
    restored.decision.complete <<= False
    restored.initialize(device=JaxCPUDevice())
    if route == "eager":
        _synchronous(restored)
    closes = []
    _record_closes(restored, closes)
    restored.run()
    return closes, _jax_params(restored)


def _port_resume(first, then):
    prng.seed_all(SEED)
    wf = mnist.create_workflow(device="cpu", max_epochs=first)
    wf.run()
    restored = pickle.loads(pickle.dumps(wf))
    restored.launcher = DummyLauncher()
    restored.decision.max_epochs = then
    restored.decision.complete <<= False
    restored.initialize(device="cpu")
    closes = []
    _record_closes(restored, closes)
    restored.run()
    return closes, restored.params_to_numpy(), restored


@pytest.mark.parametrize("route,first,then", [
    ("eager", 2, 4), ("stitched", 1, 3)])
def test_resume_protocol_matches_jax(engines, route, first, then):
    _set_route(engines, route)
    want_closes, want = _jax_resume(route, first, then)
    got_closes, got, restored = _port_resume(first, then)
    # the resumed run starts with the train pass of the last epoch
    assert [(e, c) for e, c, *_ in got_closes][:1] == [(first - 1, 2)]
    assert restored.loader.epoch_number == then - 1
    _assert_same_run(got_closes, want_closes, got, want)
    if route == "stitched":
        report = restored.stitch_report()
        assert [r["dispatches"] > 0 for r in report] == [True, True]


def test_a_jax_train_state_installs_into_the_port(engines):
    """A JAX ``capture_train_state()`` pair, restored into a fresh
    workflow of each package (the loader's pending minibatch served
    again first), runs on to the same result."""
    _set_route(engines, "stitched")
    jax_prng.seed_all(SEED)
    jwf = jax_mnist.create_workflow(device=JaxCPUDevice(), max_epochs=1)
    jwf.run()
    train, meta = jwf.capture_train_state()
    assert sorted(train) == ["u002_MnistLoader", "u003_All2AllTanh",
                             "u004_All2AllSoftmax"]
    assert meta["u002_MnistLoader"]["pending"]

    jax_prng.seed_all(SEED)
    jfresh = jax_mnist.create_workflow(device=JaxCPUDevice(), max_epochs=3)
    prng.seed_all(SEED)
    tfresh = mnist.create_workflow(device="cpu", max_epochs=3)
    results = []
    for wf in (jfresh, tfresh):
        # each its own copy: the JAX units alias the arrays they restore
        # (ROADMAP §3, reference faults)
        assert wf.restore_train_state(copy.deepcopy(train),
                                      copy.deepcopy(meta)) == 4
        wf.decision.max_epochs = 3
        wf.decision.complete <<= False
        closes = []
        _record_closes(wf, closes)
        wf.run()
        results.append(closes)
    _assert_same_run(results[1], results[0], tfresh.params_to_numpy(),
                     _jax_params(jfresh))
    # the port captures what the JAX package captures
    ttrain, tmeta = tfresh.capture_train_state()
    jtrain, jmeta = jfresh.capture_train_state()
    assert sorted(ttrain) == sorted(jtrain)
    assert {k: sorted(v) for k, v in tmeta.items()} == \
        {k: sorted(v) for k, v in jmeta.items()}
    assert tmeta["u002_MnistLoader"] == jmeta["u002_MnistLoader"]


def test_captures_hold_the_collector_off():
    """A graph capture runs with the collector off, so a collection
    cannot free a loaded snapshot's predecessor's CUDA graphs while a
    stream captures (the capture would be invalidated); overlapping
    captures in two threads turn it back on only when both are done."""
    import gc
    from veles_tpu_torch import stitch
    assert gc.isenabled()
    entered, release = threading.Event(), threading.Event()

    def other_capture():
        with stitch._no_collection():
            entered.set()
            release.wait(10)
    worker = threading.Thread(target=other_capture)
    worker.start()
    assert entered.wait(10)
    with stitch._no_collection():
        assert not gc.isenabled()
    assert not gc.isenabled()          # the other capture is still open
    release.set()
    worker.join(10)
    assert not worker.is_alive()
    assert gc.isenabled()
