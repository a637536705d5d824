"""The port's training-health statistics and telemetry bus
(``veles_tpu_torch.watch``) against the JAX package's (``veles_tpu.watch``),
on the CPU.

On the same separable blobs as ``tests/test_torch_epoch_scan.py`` (400
train and 100 validation samples of 64 features, minibatch 48), the
port's workflow starting from the JAX workflow's initial weights
(``params_from_numpy``), the JAX package on its XLA kernels:

- ``engine.health=off`` builds nothing: no stage is instrumented, the
  stages' metrics are the uninstrumented ones, and the monitor stays
  disarmed;
- ``on`` leaves every weight, momentum and close bit-equal to ``off``,
  and ``grad_norm``, ``weight_norm``, ``update_norm`` and
  ``update_ratio`` are within 1e-5 relative of the JAX package's, with
  the non-finite counts exact, on the per-step route and in windows;
- ``strict`` names the same first bad leaf at the same step as the JAX
  package on a planted NaN, on both routes;
- the bus tests of ``tests/test_watch.py``: roundtrip, drop tolerance
  with a dead and a slow subscriber, strict JSON under inf, endpoint
  shorthands, a training session publishing run, epoch, health and
  perf, the scrape and flight-recorder watch blocks, record and replay,
  the dashboard and the CLI, the scheduler's ``serve`` snapshot.
"""

import io
import json
import time

import numpy
import pytest

from veles_tpu import prng as jax_prng
from veles_tpu import watch as jax_watch
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.config import root as jax_root
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
from veles_tpu.loader.fullbatch import FullBatchLoader as JaxFullBatch
from veles_tpu.watch.health import HealthError as JaxHealthError
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
from veles_tpu_torch import prng, trace, watch
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.watch import HealthError, TelemetryReader
from veles_tpu_torch.watch import health as port_health
from veles_tpu_torch.watch.bus import load_events, record_events
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

#: relative tolerance of the norms against the JAX package's
STAT_RTOL = 1e-5
STATS = ("grad_norm", "weight_norm", "update_norm", "update_ratio")


def _blob_data(loader, n_train=400, n_valid=100, dim=64):
    rng = numpy.random.default_rng(42)
    total = n_train + n_valid
    labels = numpy.tile(numpy.arange(10), total // 10 + 1)[:total]
    centers = rng.standard_normal((10, dim)) * 3.0
    data = centers[labels] + rng.standard_normal((total, dim)) * 0.7
    loader.original_data.mem = data.astype(numpy.float32)
    loader.original_labels = list(int(x) for x in labels)
    loader.class_lengths[:] = [0, n_valid, n_train]


class BlobLoader(FullBatchLoader):
    load_data = _blob_data


class JaxBlobLoader(JaxFullBatch):
    load_data = _blob_data


LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 32},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.05}},
]


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


def build(max_epochs=2, seed=5, like=None):
    """The port's blob workflow on the CPU; ``like`` (a JAX workflow)
    gives it its initial weights."""
    prng.seed_all(seed)
    wf = StandardWorkflow(
        None, loader_factory=lambda w: BlobLoader(w, minibatch_size=48),
        layers=[dict(spec) for spec in LAYERS],
        decision_config={"max_epochs": max_epochs,
                         "fail_iterations": 10 ** 6})
    wf.launcher = DummyLauncher()
    wf.initialize(device="cpu")
    if like is not None:
        wf.params_from_numpy(_jax_params(like))
    return wf


def build_jax(max_epochs=2, seed=5):
    jax_prng.seed_all(seed)
    wf = JaxStandardWorkflow(
        None, loader_factory=lambda w: JaxBlobLoader(w, minibatch_size=48),
        layers=[dict(spec) for spec in LAYERS],
        decision_config={"max_epochs": max_epochs,
                         "fail_iterations": 10 ** 6})
    wf.launcher = JaxDummyLauncher()
    wf.initialize(device=JaxCPUDevice())
    return wf


def _params(wf):
    return {name: numpy.array(value)
            for name, value in wf.params_to_numpy().items()}


@pytest.fixture
def watch_env():
    """Both packages' knobs, restored; both buses shut and both monitors
    disarmed afterwards; the JAX package on its XLA kernels."""
    keys = (("health", "off"), ("stitch", "on"), ("epoch_scan", "off"),
            ("metrics_every", 0), ("trace", "off"), ("kernels", "auto"))
    saved = [(eng, {k: eng.get(k, d) for k, d in keys})
             for eng in (root.common.engine, jax_root.common.engine)]
    jax_root.common.engine.kernels = "xla"
    yield root.common.engine
    for eng, values in saved:
        for key, value in values.items():
            setattr(eng, key, value)
    for pkg in (watch, jax_watch):
        pkg.shutdown()
        pkg.monitor.reset()
    trace.configure()


def both(**knobs):
    for eng in (root.common.engine, jax_root.common.engine):
        for key, value in knobs.items():
            setattr(eng, key, value)


# -- the knob and health off --------------------------------------------------

@pytest.mark.parametrize("value,expect", [
    ("off", "off"), ("", "off"), (0, "off"), (None, "off"), ("on", "on"),
    (True, "on"), (1, "on"), ("ON", "on"), ("strict", "strict")])
def test_health_knob_parses_as_the_jax_package(watch_env, value, expect):
    from veles_tpu.watch.health import health_mode as jax_mode
    both(health=value)
    assert port_health.health_mode() == jax_mode() == expect


def test_health_off_instruments_nothing(watch_env, monkeypatch):
    """off: instrument_stages never runs, the stages keep their own
    metrics and functions, the monitor stays disarmed, and a run takes
    no snapshot."""
    def refuse(stages):
        raise AssertionError("instrumented with health=off")
    monkeypatch.setattr(port_health, "instrument_stages", refuse)
    watch_env.health = "off"
    wf = build()
    for segment in wf.stitch_segments:
        for stage in segment.stages:
            assert stage.health_spec is None
            assert not any(m.startswith("health_") for m in stage.metrics)
            fresh = stage.unit.stitch_stage()
            assert stage.metrics == fresh.metrics
            assert stage.fn.__qualname__ == fresh.fn.__qualname__
    assert not watch.monitor.armed
    wf.run()
    assert watch.monitor.last_snapshot is None
    assert all(not hasattr(gd, "health_nonfinite") for gd in wf.gds)


def test_health_off_rebuild_disarms_a_stale_monitor(watch_env):
    watch_env.health = "strict"
    wf_a = build()
    wf_a.run()
    assert watch.monitor.armed
    wf_a.forwards[0].weights.map_write()
    wf_a.forwards[0].weights.mem[:] = numpy.nan
    watch_env.health = "off"
    wf_b = build(seed=9)
    assert not watch.monitor.armed and watch.monitor.groups == []
    wf_b.run()
    assert bool(wf_b.decision.complete)
    assert watch.monitor.last_snapshot is None


# -- health on against the JAX package ---------------------------------------

@pytest.mark.parametrize("epoch_scan", ["off", "auto"])
def test_health_on_matches_jax_and_leaves_training_alone(watch_env,
                                                         epoch_scan):
    both(epoch_scan=epoch_scan, health="off")
    off = build()
    off.run()
    want = _params(off)
    both(health="on")
    jwf = build_jax()
    twf = build(like=jwf)
    groups = watch.monitor.groups
    assert [g.name for g in groups] == ["GDSoftmax", "GDTanh"]
    jwf.run()
    twf.run()
    got = _params(twf)
    assert sorted(got) == sorted(want)
    for name in want:
        numpy.testing.assert_array_equal(got[name], want[name], name)
    assert twf.decision.epoch_n_err == off.decision.epoch_n_err
    jsnap, tsnap = jax_watch.monitor.snapshot(), watch.monitor.snapshot()
    assert tsnap["mode"] == jsnap["mode"] == "on"
    assert tsnap["step"] == jsnap["step"] == watch.monitor.steps > 0
    assert set(tsnap["groups"]) == set(jsnap["groups"])
    for name, want_group in jsnap["groups"].items():
        got_group = tsnap["groups"][name]
        for stat in STATS:
            assert got_group[stat] > 0, (name, stat)
            numpy.testing.assert_allclose(got_group[stat], want_group[stat],
                                          rtol=STAT_RTOL,
                                          err_msg="%s.%s" % (name, stat))
        assert got_group["nonfinite"] == want_group["nonfinite"] == 0
        assert got_group["leaves"] == want_group["leaves"]
    if epoch_scan == "auto":
        report = twf.epoch_scan_report()
        assert report["windows"] > 0 and report["steps"] > report["windows"]
    assert watch.last_health() is watch.monitor.last_snapshot


def test_softmax_grad_norm_is_update_norm_over_lr(watch_env):
    """The softmax layer has no momentum: its update is -lr·grad, so the
    recovered gradient norm is the update norm over lr."""
    watch_env.health = "on"
    wf = build()
    wf.run()
    group = watch.monitor.snapshot()["groups"]["GDSoftmax"]
    lr = next(gd.learning_rate for gd in wf.gds if gd.name == "GDSoftmax")
    assert group["grad_norm"] == pytest.approx(group["update_norm"] / lr,
                                               rel=1e-4)
    assert group["update_ratio"] == pytest.approx(
        group["update_norm"] / group["weight_norm"], rel=1e-5)


def test_health_on_adds_no_dispatch(watch_env):
    watch_env.trace = "on"
    counts = []
    for mode in ("off", "on"):
        watch_env.health = mode
        before = trace.recorder.count("segment", "dispatch")
        build().run()
        counts.append(trace.recorder.count("segment", "dispatch") - before)
    assert counts[0] == counts[1] > 0


# -- strict -------------------------------------------------------------------

@pytest.mark.parametrize("epoch_scan", ["off", "auto"])
@pytest.mark.parametrize("poison", [numpy.nan, numpy.inf])
def test_strict_names_the_same_leaf_at_the_same_step_as_jax(
        watch_env, epoch_scan, poison):
    both(epoch_scan=epoch_scan, health="strict")
    jwf = build_jax(max_epochs=3)
    twf = build(max_epochs=3, like=jwf)
    for wf in (jwf, twf):
        wf.forwards[0].weights.map_write()
        wf.forwards[0].weights.mem[0, 0] = poison
    with pytest.raises(JaxHealthError) as want:
        jwf.run()
    with pytest.raises(HealthError) as got:
        twf.run()
    assert got.value.leaf == want.value.leaf
    assert got.value.step == want.value.step
    assert got.value.count == want.value.count > 0
    assert got.value.leaf.split(".")[0] in ("GDSoftmax", "GDTanh")
    assert "health=strict" in str(got.value)
    assert not bool(twf.decision.complete)


def test_strict_clean_run_checks_but_never_raises(watch_env):
    watch_env.health = "strict"
    watch_env.metrics_every = 2
    wf = build()
    wf.run()
    assert bool(wf.decision.complete)
    assert watch.monitor.checks >= 2
    snap = watch.monitor.snapshot()
    assert all(g["nonfinite"] == 0 for g in snap["groups"].values())


# -- the bus ------------------------------------------------------------------

def _drain_kinds(reader, count, seconds=5):
    events, deadline = [], time.monotonic() + seconds
    while len([e for e in events if not e["kind"].startswith("_")]) \
            < count and time.monotonic() < deadline:
        events.extend(reader.drain(timeout_ms=100))
    return [e for e in events if not e["kind"].startswith("_")]


def test_bus_publish_roundtrip_latest_history(watch_env):
    bus = watch.start("tcp://127.0.0.1:0")
    reader = TelemetryReader(bus.endpoint)
    try:
        assert reader.sync(bus)
        watch.publish("alpha", value=1)
        watch.publish("beta", {"value": 2}, extra="x")
        got = {e["kind"]: e for e in _drain_kinds(reader, 2)}
        assert got["alpha"]["value"] == 1
        assert got["beta"]["value"] == 2 and got["beta"]["extra"] == "x"
        for event in (got["alpha"], got["beta"]):
            assert event["seq"] > 0 and "ts" in event and "role" in event
        assert watch.latest("alpha")["value"] == 1
        assert [e["kind"] for e in watch.recent_events()] == ["alpha",
                                                             "beta"]
        assert bus.describe()["published"] == 2
    finally:
        reader.close()


def test_bus_drop_tolerance_dead_and_slow_subscriber(watch_env):
    bus = watch.start("tcp://127.0.0.1:0", hwm=8)
    payload = {"filler": "x" * 512}
    tic = time.monotonic()
    for _ in range(2000):
        watch.publish("flood", payload)
    assert time.monotonic() - tic < 5.0, "blocked with no subscriber"
    slow = TelemetryReader(bus.endpoint, hwm=2)
    try:
        slow.sync(bus)
        tic = time.monotonic()
        for _ in range(2000):
            watch.publish("flood", payload)
        seconds = time.monotonic() - tic
        assert seconds < 5.0, "a slow subscriber backpressured publish"
        assert seconds / 2000 < 2e-3
    finally:
        slow.close()
    assert bus.describe()["published"] + bus.dropped >= 4000


def test_publish_without_bus_is_noop(watch_env):
    assert not watch.enabled()
    assert watch.publish("anything", x=1) is None
    assert watch.latest() == {} and watch.latest("x") is None
    assert watch.recent_events() == []
    assert watch.metrics_text() == ""


def test_reader_sync_never_swallows_real_traffic(watch_env):
    bus = watch.start("tcp://127.0.0.1:0")
    reader = TelemetryReader(bus.endpoint)
    try:
        assert reader.sync(bus)
        reader.drain(timeout_ms=100)
        watch.publish("data", n=7)
        time.sleep(0.2)
        assert reader.sync(bus)
        events = reader.drain(timeout_ms=200)
        assert any(e["kind"] == "data" and e["n"] == 7 for e in events)
        assert "_sync" not in bus.latest
        assert all(not e["kind"].startswith("_") for e in bus.history)
        assert bus.control > 0 and bus.describe()["published"] == 1
    finally:
        reader.close()


def test_bus_wire_stays_strict_json_under_inf(watch_env):
    bus = watch.start("tcp://127.0.0.1:0")
    reader = TelemetryReader(bus.endpoint)
    try:
        assert reader.sync(bus)
        watch.publish("epoch", best_mse=float("inf"), mse=float("nan"),
                      ok=1.5)
        event = next(e for e in _drain_kinds(reader, 1)
                     if e["kind"] == "epoch")
        assert event["best_mse"] == "inf" and event["mse"] == "nan"
        assert event["ok"] == 1.5
        json.loads(json.dumps(watch.latest("epoch")),
                   parse_constant=lambda c: pytest.fail(
                       "non-RFC constant %s on the wire" % c))
    finally:
        reader.close()


@pytest.mark.parametrize("endpoint", [":0", "0"])
def test_bus_endpoint_shorthand_forms(watch_env, endpoint):
    bus = watch.start(endpoint)
    assert bus.endpoint.startswith("tcp://127.0.0.1:")
    assert not bus.endpoint.endswith(":0")
    reader = TelemetryReader(bus.endpoint)
    try:
        assert reader.sync(bus)
    finally:
        reader.close()


def test_bus_host_state_stays_serializable(watch_env):
    watch.start("tcp://127.0.0.1:0")
    event = watch.publish("epoch", value=numpy.float64(0.5),
                          arr_stat=numpy.int32(3), obj=object())
    stored = watch.latest("epoch")
    assert stored == event
    json.dumps(stored)
    assert watch.recent_events()[-1] is stored


# -- the publishers -----------------------------------------------------------

@pytest.mark.parametrize("epoch_scan", ["off", "auto"])
def test_training_session_publishes_run_epoch_health_perf(watch_env,
                                                          epoch_scan):
    both(health="on", epoch_scan=epoch_scan)
    bus = watch.start("tcp://127.0.0.1:0")
    reader = TelemetryReader(bus.endpoint)
    try:
        assert reader.sync(bus)
        wf = build()
        wf.run()
        events = [e for e in reader.drain(timeout_ms=200)
                  if not e["kind"].startswith("_")]
        kinds = {e["kind"] for e in events}
        assert {"run", "epoch", "health", "perf"} <= kinds
        runs = [e for e in events if e["kind"] == "run"]
        assert runs[0]["phase"] == "begin" and runs[-1]["phase"] == "end"
        assert "results" in runs[-1]
        epochs = [e for e in events if e["kind"] == "epoch"]
        assert all("n_err_pt" in e and "epoch" in e for e in epochs)
        assert len(epochs) == len(wf.decision.history)
        health = [e for e in events if e["kind"] == "health"][-1]
        assert health["groups"]["GDTanh"]["nonfinite"] == 0
        perf = [e for e in events if e["kind"] == "perf"][-1]
        assert perf["compiles"] > 0 and perf["flops_dispatched"] > 0
        assert perf["mfu"] is None           # no card, no peak
        if epoch_scan == "auto":
            assert perf["scan_windows"] > 0
        else:
            assert perf["dispatches"] > 0
    finally:
        reader.close()


def test_workflow_initialize_starts_the_configured_bus(watch_env):
    node = root.common.watch
    saved = node.get("endpoint")
    node.endpoint = ":0"
    try:
        build()
        assert watch.enabled()
        assert watch.bus().endpoint.startswith("tcp://127.0.0.1:")
    finally:
        node.endpoint = saved


def test_scheduler_publishes_serve_snapshots(watch_env):
    from veles_tpu_torch.gen import GenerativeEngine, GenerativeScheduler
    from veles_tpu_torch.gen.model import TransformerGenModel
    from veles_tpu_torch.samples.transformer import TINY
    engine = GenerativeEngine(
        TransformerGenModel(dict(TINY, seq_len=64), device="cpu"),
        max_slots=2, max_seq=48, device="cpu")
    scheduler = GenerativeScheduler(engine, name="lm")
    scheduler.WATCH_EVERY = 4
    watch.start("tcp://127.0.0.1:0")
    scheduler.submit([1, 2, 3], max_new_tokens=9)
    scheduler.run_until_idle()
    event = watch.latest("serve")
    assert event is not None and event["model"] == "lm"
    assert set(event) >= {"queue_depth", "active", "batch_fill",
                          "tokens_total", "ttft_p99_ms"}
    assert len([e for e in watch.recent_events()
                if e["kind"] == "serve"]) == scheduler.decode_steps // 4
    engine.close()


def test_scrape_endpoint_serves_health_gauges(watch_env):
    from veles_tpu_torch.obs.scrape import ScrapeServer, default_sources
    server = ScrapeServer(default_sources(), role="test")
    assert "veles_health_stat" not in server.render()
    watch_env.health = "on"
    build().run()
    watch.start("tcp://127.0.0.1:0")
    watch.publish("epoch", epoch=1)
    page = server.render()
    assert 'veles_health_stat{group="GDTanh",stat="grad_norm"}' in page
    assert 'veles_health_nonfinite{group="GDSoftmax",leaf="w"} 0' in page
    assert "veles_watch_published_total 1" in page
    types = [line.split()[3] for line in page.splitlines()
             if line.startswith("# TYPE veles_health")]
    assert types and all(t == "gauge" for t in types)


def test_blackbox_dump_embeds_health_and_bus_tail(watch_env, tmp_path):
    from veles_tpu_torch.obs import blackbox
    saved = root.common.obs.get("blackbox_dir")
    root.common.obs.blackbox_dir = str(tmp_path / "bb")
    try:
        assert "watch" not in blackbox.load(blackbox.dump("before"))
        watch_env.health = "on"
        watch.start("tcp://127.0.0.1:0")
        build().run()
        payload = blackbox.load(blackbox.dump("unit test"))
    finally:
        root.common.obs.blackbox_dir = saved
        blackbox.uninstall()
    assert payload["watch"]["health"]["groups"]["GDTanh"]["nonfinite"] == 0
    kinds = {e["kind"] for e in payload["watch"]["events"]}
    assert {"epoch", "health", "run", "perf"} <= kinds


# -- the dashboard and the CLI -----------------------------------------------

def test_record_replay_roundtrip(watch_env, tmp_path, capsys):
    from veles_tpu_torch.watch.__main__ import replay
    bus = watch.start("tcp://127.0.0.1:0")
    reader = TelemetryReader(bus.endpoint)
    path = str(tmp_path / "session.ndjson")
    try:
        assert reader.sync(bus)
        watch.publish("health", step=4, groups={
            "GDTanh": {"grad_norm": 1.5, "weight_norm": 2.0,
                       "update_ratio": 0.1, "nonfinite": 0}})
        watch.publish("epoch", epoch=1, n_err_pt=3.25)
        events = _drain_kinds(reader, 2)
        record_events(events, path)
        assert load_events(path) == events
        assert replay(path) == events
        out = capsys.readouterr().out
        assert "GDTanh" in out
        assert "health×1" in out and "epoch×1" in out
    finally:
        reader.close()


def test_dashboard_render_and_cli_replay(watch_env, tmp_path):
    from veles_tpu_torch.watch.__main__ import main, render
    event = {"kind": "health", "ts": time.time(), "seq": 1,
             "role": "trainer", "step": 8,
             "groups": {"GDTanh": {"grad_norm": 1.0, "weight_norm": 3.0,
                                   "update_ratio": 0.01, "nonfinite": 0}}}
    frame = render({"health": event}, received=1)
    assert "KIND" in frame and "nf=0" in frame
    path = str(tmp_path / "r.ndjson")
    record_events([event], path)
    assert main(["--replay", path]) == 0
    assert main([]) == 2


def test_cli_consume_records_live_events(watch_env, tmp_path):
    from veles_tpu_torch.watch.__main__ import consume
    bus = watch.start("tcp://127.0.0.1:0")
    reader = TelemetryReader(bus.endpoint)
    path = str(tmp_path / "live.ndjson")
    try:
        assert reader.sync(bus)
        watch.publish("epoch", epoch=0, n_err_pt=9.0)
        watch.publish("perf", compiles=3)
        latest, received = consume(reader, duration=1.0, record=path,
                                   once=True, out=io.StringIO())
        assert received >= 2
        assert {"epoch", "perf"} <= {e["kind"] for e in load_events(path)}
    finally:
        reader.close()


def test_watch_smoke_passes_on_the_cpu(watch_env, capsys):
    from veles_tpu_torch.watch.__main__ import run_smoke
    assert run_smoke(device="cpu") == 0
    assert "watch smoke: OK" in capsys.readouterr().out
    assert not watch.enabled()
