"""The port's K-step epoch windows (``veles_tpu_torch.epoch_scan``)
against its own per-step stitched route and against the JAX package's
window route (``veles_tpu.epoch_scan``), on the CPU.

Every scenario of ``tests/test_epoch_scan.py`` but the pod and chaos
ones, on the same separable blobs (one ``load_data`` shared by a
``BlobLoader`` of each package, 400 train and 100 validation samples of
64 features at minibatch 48, so both classes end in a short batch):

- the window route against the port's per-step route from the same
  seed: weights, momenta, confusion matrix and every close bit for bit;
- the port's window route against the JAX package's (``kernels=xla``):
  closes exact, every parameter and momentum within 1e-4 absolute and
  within 1e-4 of its leaf's largest value;
- the host dispatches (``segment/dispatch`` spans) at least 5× fewer,
  windows inside class spans, ``metrics_every`` bounding windows (a K
  that misdivides it included), an explicit K and a flip mid-run, the
  interrupted pass's reset, the verdict against the host close, a side
  unit in the loop falling back with its reason, the MSE family, and
  ``run_smoke``.

On the CPU a window runs its steps eagerly; its CUDA graph is held on
the card (``tests/test_torch_kernels.py -m cuda`` and ``chip_smoke.py``).
"""

import numpy
import pytest

from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.config import root as jax_root
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
from veles_tpu.loader.fullbatch import FullBatchLoader as JaxFullBatch
from veles_tpu.loader.fullbatch import \
    FullBatchLoaderMSE as JaxFullBatchMSE
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
from veles_tpu_torch import epoch_scan, prng, trace
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.fullbatch import FullBatchLoader, \
    FullBatchLoaderMSE
from veles_tpu_torch.units import Unit
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

PARAM_TOL = 1e-4
MSE_RTOL = 1e-5


def _blob_data(loader, n_train=400, n_valid=100, dim=64):
    """Separable 10-class gaussian blobs (tests/test_epoch_scan.py's)."""
    rng = numpy.random.default_rng(42)
    total = n_train + n_valid
    labels = numpy.tile(numpy.arange(10), total // 10 + 1)[:total]
    centers = rng.standard_normal((10, dim)) * 3.0
    data = centers[labels] + rng.standard_normal((total, dim)) * 0.7
    loader.original_data.mem = data.astype(numpy.float32)
    loader.original_labels = list(int(x) for x in labels)
    loader.class_lengths[:] = [0, n_valid, n_train]


def _mse_data(loader):
    rng = numpy.random.default_rng(3)
    data = rng.standard_normal((300, 16)).astype(numpy.float32)
    loader.original_data.mem = data
    loader.original_targets.mem = numpy.tanh(data[:, :4] * 0.5).astype(
        numpy.float32)
    loader.class_lengths[:] = [0, 60, 240]


class BlobLoader(FullBatchLoader):
    load_data = _blob_data


class JaxBlobLoader(JaxFullBatch):
    load_data = _blob_data


class BlobMSELoader(FullBatchLoaderMSE):
    load_data = _mse_data


class JaxBlobMSELoader(JaxFullBatchMSE):
    load_data = _mse_data


def _layers(hidden=32, lr=0.05):
    return [
        {"type": "all2all_tanh", "->": {"output_sample_shape": hidden},
         "<-": {"learning_rate": lr, "gradient_moment": 0.9}},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": lr, "gradient_moment": 0.9}},
    ]


MSE_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "all2all", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.05}}]


def build(max_epochs=3, minibatch_size=48, seed=5, fail_iterations=10 ** 6,
          side_unit=False, mse=False, like=None):
    """The port's blob workflow on the CPU from ``seed``, its closes
    recorded as ``wf.closes``; ``like``, a JAX workflow, gives it its
    initial weights through ``params_from_numpy``."""
    prng.seed_all(seed)
    loader = BlobMSELoader if mse else BlobLoader
    wf = StandardWorkflow(
        None,
        loader_factory=lambda w: loader(w, minibatch_size=minibatch_size),
        layers=MSE_LAYERS if mse else _layers(),
        loss_function="mse" if mse else None,
        decision_config={"max_epochs": max_epochs,
                         "fail_iterations": fail_iterations})
    if side_unit:
        Unit(wf, name="SideUnit").link_from(wf.decision)
    wf.launcher = DummyLauncher()
    wf.initialize(device="cpu")
    if like is not None:
        wf.params_from_numpy(_jax_params(like))
    return _recording(wf)


def build_jax(max_epochs=3, minibatch_size=48, seed=5, mse=False):
    jax_prng.seed_all(seed)
    loader = JaxBlobMSELoader if mse else JaxBlobLoader
    wf = JaxStandardWorkflow(
        None,
        loader_factory=lambda w: loader(w, minibatch_size=minibatch_size),
        layers=MSE_LAYERS if mse else _layers(),
        loss_function="mse" if mse else None,
        decision_config={"max_epochs": max_epochs,
                         "fail_iterations": 10 ** 6})
    wf.launcher = JaxDummyLauncher()
    wf.initialize(device=JaxCPUDevice())
    return _recording(wf)


def _recording(wf):
    """``wf.closes``: (epoch, class, metric sum, samples or batches) at
    every close (the confusion matrix too, for a classifier)."""
    dec = wf.decision
    wf.closes = []
    if hasattr(dec, "epoch_n_err"):
        close = dec._close_class

        def recording(cls, check_epoch_end):
            cm = wf.evaluator.confusion_matrix
            cm.map_read()
            wf.closes.append((int(dec.epoch_number), cls,
                              float(dec.epoch_n_err[cls]),
                              int(dec.epoch_samples[cls]),
                              numpy.array(cm.mem)))
            return close(cls, check_epoch_end)
        dec._close_class = recording
    return wf


@pytest.fixture
def scan_config():
    """Both packages' engine knobs, restored afterwards; the JAX package
    on its XLA kernels."""
    keys = (("epoch_scan", "off"), ("stitch", "on"), ("metrics_every", 0),
            ("loader", "auto"), ("kernels", "auto"), ("trace", "off"))
    saved = [(eng, {k: eng.get(k, d) for k, d in keys})
             for eng in (root.common.engine, jax_root.common.engine)]
    jax_root.common.engine.kernels = "xla"
    yield root.common.engine
    for eng, values in saved:
        for key, value in values.items():
            setattr(eng, key, value)
    trace.configure()


def both(scan_config, mode, every=0):
    """Set ``epoch_scan`` and ``metrics_every`` in both packages."""
    for eng in (scan_config, jax_root.common.engine):
        eng.epoch_scan, eng.metrics_every = mode, every


def _params(wf):
    return {name: numpy.array(value)
            for name, value in wf.params_to_numpy().items()}


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


def _assert_bit_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        numpy.testing.assert_array_equal(a[name], b[name], name)


def _assert_close(got, want):
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        err = float(numpy.abs(got[name] - ref).max())
        assert err <= PARAM_TOL, (name, err)
        assert err <= PARAM_TOL * float(numpy.abs(ref).max()), (name, err)


def _same_closes(a, b):
    assert [c[:4] for c in a.closes] == [c[:4] for c in b.closes]
    for x, y in zip(a.closes, b.closes):
        numpy.testing.assert_array_equal(x[4], y[4])


def _dispatches():
    return sum(1 for e in trace.recorder.events()
               if e[1:3] == ("segment", "dispatch"))


# -- parity and the dispatch count -------------------------------------------

def test_scan_matches_per_step_bitwise_with_5x_fewer_dispatches(
        scan_config):
    scan_config.trace = "on"
    both(scan_config, "off")
    trace.recorder.clear()
    wf_off = build()
    wf_off.run()
    off_dispatches = _dispatches()
    both(scan_config, "auto")
    trace.recorder.clear()
    wf_on = build()
    wf_on.run()
    on_dispatches = _dispatches()
    report = wf_on.epoch_scan_report()
    assert report["eligible"], report
    assert report["windows"] == on_dispatches > 0
    assert report["steps"] * 2 > off_dispatches
    assert on_dispatches * 5 <= off_dispatches, (on_dispatches,
                                                off_dispatches)
    _assert_bit_equal(_params(wf_on), _params(wf_off))
    _same_closes(wf_on, wf_off)
    assert wf_on.decision.best_n_err_pt == wf_off.decision.best_n_err_pt
    assert wf_on.decision.best_epoch == wf_off.decision.best_epoch
    # the per-step segments never dispatched under the windows
    assert [r["dispatches"] for r in wf_on.stitch_report()] == [0, 0]


@pytest.mark.parametrize("mode", ["auto", "4"])
def test_scan_matches_the_jax_window_route(scan_config, mode):
    both(scan_config, mode)
    jwf = build_jax()
    twf = build(like=jwf)
    jwf.run()
    twf.run()
    assert jwf.stitch_report()["epoch_scan"]["windows"] \
        == twf.epoch_scan_report()["windows"] > 0
    _same_closes(twf, jwf)
    _assert_close(_params(twf), _jax_params(jwf))


def test_scan_windows_respect_class_spans(scan_config):
    """400 train / 100 valid at batch 48: one window per class pass (9
    train steps, 3 validation steps) under the auto bound."""
    both(scan_config, "auto")
    wf = build(max_epochs=2)
    wf.run()
    report = wf.epoch_scan_report()
    assert report["windows"] * 3 <= report["steps"]
    assert sorted(report["graphs"]) == [(False, 3, True), (True, 9, False)]
    assert report["programs"] == 2


def test_knob_off_is_byte_identical_per_step_path(scan_config):
    both(scan_config, "off")
    wf = build(max_epochs=2)
    wf.run()
    report = wf.epoch_scan_report()
    assert report["windows"] == 0 and report["eligible"]
    assert sum(r["dispatches"] for r in wf.stitch_report()) > 0


def test_early_stop_fires_at_same_global_step(scan_config):
    results = {}
    for mode in ("off", "auto"):
        both(scan_config, mode)
        wf = build(max_epochs=50, fail_iterations=1, seed=7)
        wf.run()
        results[mode] = (int(wf.loader.epoch_number),
                         int(wf.loader.samples_served),
                         bool(wf.decision.complete),
                         wf.decision.best_epoch)
    assert results["off"] == results["auto"]


def test_metrics_every_bounds_windows_and_matches_boundary_flush(
        scan_config):
    both(scan_config, "auto", every=2)
    assert epoch_scan.mode() == 2
    wf_k2 = build(max_epochs=3)
    wf_k2.run()
    report = wf_k2.epoch_scan_report()
    assert report["windows"] > 0
    assert report["steps"] <= report["windows"] * 2
    verdict = wf_k2.decision.scan_verdict
    assert verdict is not None
    assert bool(verdict["improved"]) == bool(wf_k2.decision.improved)
    assert bool(verdict["stop"]) == bool(wf_k2.decision.complete)
    both(scan_config, "auto")
    wf_k0 = build(max_epochs=3)
    wf_k0.run()
    assert wf_k2.decision.best_n_err_pt == wf_k0.decision.best_n_err_pt
    _assert_bit_equal(_params(wf_k2), _params(wf_k0))
    _same_closes(wf_k2, wf_k0)


def test_windows_align_to_flush_boundaries_when_k_misdivides(scan_config):
    """epoch_scan=4, metrics_every=6: the 9-step train span's windows
    shrink (4 + 2) to land the flush on step 6, as the per-step route
    flushes; the JAX route takes the same window lengths."""
    both(scan_config, "4", every=6)
    wf = build(max_epochs=2)
    wf.run()
    ks = {k for (_train, k, _verdict) in wf.epoch_scan_report()["graphs"]}
    assert 4 in ks and 2 in ks, ks
    jwf = build_jax(max_epochs=2)
    jwf.run()
    assert ks == {k for (_t, k, _v) in jwf._epoch_runner_._programs}
    _same_closes(wf, jwf)
    both(scan_config, "off", every=6)
    wf_ref = build(max_epochs=2)
    wf_ref.run()
    _same_closes(wf, wf_ref)
    _assert_bit_equal(_params(wf), _params(wf_ref))


def test_explicit_k_knob_and_flip_mid_run(scan_config):
    """An integer pins K; flipping the knob off between runs gives the
    per-step route with nothing rebuilt, and the weights of a run that
    was per-step throughout."""
    both(scan_config, "4")
    wf = build(max_epochs=2)
    wf.run()
    report = wf.epoch_scan_report()
    assert report["windows"] > 0
    assert report["steps"] <= report["windows"] * 4
    windows = report["windows"]
    both(scan_config, "off")
    wf.decision.complete <<= False
    wf.decision.max_epochs = 4
    wf.run()
    assert wf.epoch_scan_report()["windows"] == windows
    assert sum(r["dispatches"] for r in wf.stitch_report()) > 0
    ref = build(max_epochs=4)
    ref.run()
    _assert_bit_equal(_params(wf), _params(ref))


def test_interrupted_window_pass_resets_decision_absorb(scan_config):
    def trained(arm_stale_flag):
        both(scan_config, "auto")
        wf = build(max_epochs=2, seed=11)
        wf.run()
        if arm_stale_flag:
            # a window committed, then the drain stopped before the
            # Decision fired
            wf.decision._scan_absorbed_ = True
        both(scan_config, "off")
        wf.decision.complete <<= False
        wf.decision.max_epochs = 4
        wf.run()
        return (wf.decision.epoch_n_err_pt, wf.decision.best_n_err_pt,
                _params(wf))

    clean, stale = trained(False), trained(True)
    assert stale[:2] == clean[:2]
    _assert_bit_equal(stale[2], clean[2])


def test_device_predicate_verdict_agrees_with_host_close(scan_config):
    both(scan_config, "auto")
    wf = build(max_epochs=3)
    dec = wf.decision
    close, seen = dec._close_class, []

    def checked(cls, check_epoch_end):
        close(cls, check_epoch_end)
        if dec._validated(cls):
            v = dec.scan_verdict
            seen.append((v["epoch"], v["cls"], bool(v["improved"]),
                         bool(v["stop"]), int(dec.epoch_number), cls,
                         bool(dec.improved), bool(dec.complete)))
    dec._close_class = checked
    wf.run()
    assert len(seen) == 3
    for v_epoch, v_cls, improved, stop, epoch, cls, h_imp, h_done in seen:
        assert (v_epoch, v_cls, improved, stop) == (epoch, cls, h_imp,
                                                    h_done)
    verdict = dec.scan_verdict
    assert verdict["cls"] == 1
    assert verdict["epoch"] == int(wf.loader.epoch_number)
    assert hasattr(verdict["stop"], "dtype")


def test_side_units_in_loop_fall_back_to_per_step(scan_config):
    """Eligibility is structural: a unit hanging off the Decision keeps
    the per-step route, with the reason named, and training
    completes."""
    both(scan_config, "auto")
    wf = build(max_epochs=2, side_unit=True)
    report = wf.epoch_scan_report()
    assert not report["eligible"]
    assert "hang off" in report["reason"]
    wf.run()
    assert wf.stopped and wf.decision.complete
    assert wf.epoch_scan_report()["windows"] == 0
    assert sum(r["dispatches"] for r in wf.stitch_report()) > 0


def test_scan_report_counts_steps_per_dispatch(scan_config):
    """The counterpart of the JAX ledger test: each window graph reports
    its steps and runs, one dispatch standing for K steps, and a flip
    back to per-step dispatch runs the segments."""
    both(scan_config, "auto")
    wf = build(max_epochs=2)
    wf.run()
    report = wf.epoch_scan_report()
    assert report["steps"] > report["windows"]
    assert sum(g["runs"] for g in report["graphs"].values()) \
        == report["windows"]
    assert all(g["steps"] > 1 for g in report["graphs"].values())
    both(scan_config, "off")
    wf.decision.complete <<= False
    wf.decision.max_epochs = 4
    wf.run()
    assert wf.epoch_scan_report()["windows"] == report["windows"]
    assert all(r["recaptures"] == 0 for r in wf.stitch_report())


def test_mse_family_windows_and_parity(scan_config):
    """FullBatchLoaderMSE's targets ride the head's served launch,
    EvaluatorMSE's ``batch`` becomes a float column of the window's
    block and DecisionMSE absorbs windows: the weights bit for bit with
    the per-step route, the rmse within 1e-5; the JAX window route
    within 1e-4 and 1e-5."""
    both(scan_config, "off")
    wf_off = build(mse=True)
    wf_off.run()
    both(scan_config, "auto")
    wf_on = build(mse=True)
    wf_on.run()
    report = wf_on.epoch_scan_report()
    assert report["eligible"], report
    assert report["windows"] > 0
    _assert_bit_equal(_params(wf_on), _params(wf_off))
    assert wf_on.decision.best_mse == pytest.approx(
        wf_off.decision.best_mse, rel=MSE_RTOL)
    assert wf_on.decision.best_epoch == wf_off.decision.best_epoch
    verdict = wf_on.decision.scan_verdict
    assert verdict is not None
    assert bool(verdict["improved"]) == bool(wf_on.decision.improved)
    jwf = build_jax(mse=True)
    # the JAX initial weights are the port's: the seeds give both
    _assert_bit_equal(_params(build(mse=True, like=jwf)),
                      _params(build(mse=True)))
    jwf.run()
    assert [(h["epoch"], h["cls"]) for h in wf_on.decision.history] \
        == [(0, "validation"), (0, "train"), (1, "validation"),
            (1, "train"), (2, "validation")]
    assert wf_on.decision.best_mse == pytest.approx(
        float(jwf.decision.best_mse), rel=MSE_RTOL)
    assert wf_on.decision.best_epoch == jwf.decision.best_epoch
    _assert_close(_params(wf_on), _jax_params(jwf))


def test_run_smoke_on_cpu(scan_config, capsys):
    assert epoch_scan.run_smoke(device="cpu") == 0
    assert "epoch smoke: OK" in capsys.readouterr().out


def test_mode_reads_the_knob(scan_config):
    for value, want in (("off", 0), ("auto", epoch_scan.AUTO_WINDOW),
                        ("7", 7), (True, epoch_scan.AUTO_WINDOW), (0, 0)):
        scan_config.epoch_scan = value
        assert epoch_scan.mode() == want
    scan_config.epoch_scan, scan_config.metrics_every = "auto", 5
    assert epoch_scan.mode() == 5
    scan_config.epoch_scan = "sometimes"
    with pytest.raises(ValueError, match="off.auto.<K>"):
        epoch_scan.mode()
