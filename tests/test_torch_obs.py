"""The port's trace export, flight recorder and scrape endpoint
(``veles_tpu_torch.trace.export``, ``veles_tpu_torch.obs.blackbox``,
``veles_tpu_torch.obs.scrape``) against the JAX package's, on the CPU.

- One event list (recorded into both rings with fixed stamps, or built
  by hand) gives the JAX package's ``chrome_events``, ``summary`` and
  ``report_text`` (the report's first line names the port's package);
  a file either package saves loads to the same events in both, and
  the offline CLI prints the same report.
- ``blackbox.dump`` → ``load`` gives the JAX payload's keys;
  ``Workflow.initialize`` with ``root.common.obs.blackbox_dir`` arms
  the recorder and ``uninstall`` restores the hooks.
- ``ScrapeServer`` serves ``default_sources`` over HTTP, guarding a
  failing source as the JAX package's does.
- One traced ``POST /generate`` leaves the waterfall the JAX package's
  observability smoke asks for (``veles_tpu/obs/__main__.py``, phase 2):
  ``serve:http``, ``gen:queue_wait``, ``gen:prefill`` and ``gen:decode``
  all carry the request's trace id, which the reply echoes.
"""

import io
import json
import sys
import threading
import urllib.request
from contextlib import redirect_stdout

import pytest

from veles_tpu.obs import blackbox as jax_blackbox
from veles_tpu.obs import scrape as jax_scrape
from veles_tpu.trace import __main__ as jax_trace_main
from veles_tpu.trace import core as jax_core
from veles_tpu.trace import export as jax_export
from veles_tpu_torch import obs, trace
from veles_tpu_torch.config import root
from veles_tpu_torch.obs import blackbox, scrape
from veles_tpu_torch.trace import __main__ as trace_main
from veles_tpu_torch.trace import core, export
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

HTTP_TIMEOUT = 30
TRACE_A = "ab" * 16
TRACE_B = "cd" * 16


@pytest.fixture
def rings():
    """Both recorders cleared and on, restored (and emptied) after."""
    saved = [(rec, rec.enabled, rec.role)
             for rec in (jax_core.recorder, core.recorder)]
    for rec in (jax_core.recorder, core.recorder):
        rec.clear()
        rec.enabled = True
    yield
    for rec, enabled, role in saved:
        rec.clear()
        rec.enabled, rec.role = enabled, role
    core.recorder.path = None


def _record(module):
    """The same events into one package's ring, fixed stamps and
    thread ids: nested and overlapping spans, two roles, two trace ids,
    instants, counters and the stitched segment's dispatches."""
    m = module
    m.complete("serve", "request", 1000, 9000, {"trace": TRACE_A},
               role="server", tid=1)
    m.complete("serve", "batch_infer", 2000, 3000, None, role="server",
               tid=1)
    m.complete("gen", "prefill", 2500, 1500,
               {"trace": TRACE_A, "bucket": 8}, role="server", tid=2)
    m.complete("gen", "decode", 4500, 700,
               {"traces": [TRACE_A, TRACE_B]}, role="server", tid=2)
    m.complete("gen", "prefill", 5200, 900, {"trace": TRACE_B},
               role="server", tid=2)
    for i in range(4):
        m.complete("segment", "dispatch", 20000 + 5000 * i, 3000,
                   {"steps": 1 + (i == 3) * 9}, role="trainer", tid=3)
    m.complete("unit", "All2AllTanh", 21000, 500, None, tid=3)
    m.complete("loader", "serve_minibatch", 20500, 2000, None, tid=4)
    m.recorder.record("i", "gen", "admit", 2400, 0, {"trace": TRACE_A},
                      "server", 2)
    m.recorder.record("C", "h2d", "h2d_bytes", 3000, 0, {"value": 400},
                      "trainer", 3)
    m.recorder.record("C", "h2d", "h2d_bytes", 9000, 0, {"value": 800},
                      "trainer", 3)


def _both():
    _record(jax_core)
    _record(core)
    return export.normalize(), jax_export.normalize()


def test_normalize_equals_jax(rings):
    got, want = _both()
    assert got == want and len(got) == 14
    assert trace.normalize() == got


def test_chrome_events_equal_jax(rings):
    got, want = _both()
    assert export.chrome_events(got) == jax_export.chrome_events(want)
    flows = [ev for ev in export.chrome_events(got) if ev["ph"] in "st"]
    assert {ev["id"] for ev in flows} == {TRACE_A, TRACE_B}


@pytest.mark.parametrize("top", [1, 3, 10])
def test_summary_equals_jax(rings, top):
    got, want = _both()
    assert export.summary(got, top=top) == jax_export.summary(want,
                                                              top=top)


def _report_body(text):
    """A report without its first line, which names its package."""
    head, _, body = text.partition("\n")
    return head.split(" — ")[1], body


def test_report_text_equals_jax(rings):
    got, want = _both()
    port, jax = export.report_text(got), jax_export.report_text(want)
    assert port.startswith("veles_tpu_torch.trace report — 14 event(s)")
    assert _report_body(port) == _report_body(jax)
    assert "segment dispatch vs host gap:" in port
    # the live ring's report is the list's
    assert _report_body(export.report_text()) == _report_body(port)


def test_saved_files_load_alike_in_both_packages(rings, tmp_path):
    _both()
    port_file = str(tmp_path / "port.json")
    jax_file = str(tmp_path / "jax.json")
    assert export.save(port_file) == port_file
    jax_export.save(jax_file)
    for path in (port_file, jax_file):
        assert export.load(path) == jax_export.load(path)
    assert export.load(port_file) == jax_export.load(jax_file)
    payload = json.load(open(port_file))
    assert payload["metadata"] == {"producer": "veles_tpu_torch.trace",
                                   "recorded": 14, "dropped": 0}
    assert payload["displayTimeUnit"] == "ms"


def test_save_needs_a_path_or_the_knob(rings, tmp_path):
    _record(core)
    with pytest.raises(ValueError, match="no trace path"):
        export.save()
    path = str(tmp_path / "knob.json")
    assert core.configure(path) and core.recorder.path == path
    assert export.save() == path
    assert len(export.load(path)) == 14
    export.save_at_exit()
    assert not core.configure("off") and core.recorder.path is None


@pytest.mark.parametrize("argv", [[], ["--json"], ["--top", "2"]])
def test_trace_cli_prints_the_jax_report(rings, tmp_path, argv):
    _record(core)
    path = str(tmp_path / "cli.json")
    export.save(path)
    outputs = []
    for main in (trace_main.main, jax_trace_main.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main([path] + argv) == 0
        outputs.append(buf.getvalue())
    if argv == ["--json"]:
        assert json.loads(outputs[0]) == json.loads(outputs[1])
    else:
        assert _report_body(outputs[0]) == _report_body(outputs[1])


def test_trace_cli_refuses_a_missing_file(tmp_path, capsys):
    assert trace_main.main([str(tmp_path / "nope.json")]) == 2
    assert "cannot read" in capsys.readouterr().err


def test_metrics_text_equals_jax(rings):
    _both()
    assert export.metrics_text() == jax_export.metrics_text()
    assert trace.metrics_text() == export.metrics_text()


# -- the flight recorder ----------------------------------------------------

@pytest.fixture
def blackbox_knob():
    node = root.common.obs
    saved = node.__dict__.get("blackbox_dir", KeyError)
    yield node
    blackbox.uninstall()
    if saved is KeyError:
        node.__dict__.pop("blackbox_dir", None)
    else:
        node.blackbox_dir = saved


def test_blackbox_round_trip_gives_the_jax_payload_keys(rings, tmp_path):
    _both()
    got = blackbox.load(blackbox.dump("test crash", str(tmp_path / "p"),
                                      extra={"step": 3}))
    want = jax_blackbox.load(jax_blackbox.dump(
        "test crash", str(tmp_path / "j"), extra={"step": 3}))
    assert sorted(got) == sorted(want)
    assert got["kind"] == want["kind"] == "veles_tpu.obs.blackbox"
    assert got["reason"] == "test crash" and got["extra"] == {"step": 3}
    assert got["events"] == json.loads(json.dumps(export.normalize()))
    assert got["event_counts"] == want["event_counts"]
    assert got["trace_enabled"] is True
    # each package reads the other's post-mortem
    assert jax_blackbox.load(blackbox.dump("x", str(tmp_path / "q")))
    with pytest.raises(ValueError, match="post-mortem"):
        path = tmp_path / "other.json"
        path.write_text(json.dumps({"kind": "something else"}))
        blackbox.load(str(path))


def test_blackbox_is_a_no_op_without_the_knob(blackbox_knob):
    blackbox_knob.__dict__.pop("blackbox_dir", None)
    assert blackbox.dump("nothing") is None
    assert obs.configure() is False
    assert not blackbox._installed[0]


def test_workflow_initialize_arms_the_recorder(blackbox_knob, tmp_path):
    from veles_tpu_torch.samples import mnist
    blackbox_knob.blackbox_dir = str(tmp_path)
    prev_hook, prev_thread_hook = sys.excepthook, threading.excepthook
    wf = mnist.create_workflow(device="cpu", max_epochs=1)
    assert wf._is_initialized
    assert blackbox._installed[0]
    assert sys.excepthook is blackbox._excepthook
    assert threading.excepthook is blackbox._thread_excepthook
    assert blackbox.install() is True          # idempotent
    path = blackbox.dump("asked")
    assert path.startswith(str(tmp_path))
    assert blackbox.load(path)["reason"] == "asked"
    blackbox.uninstall()
    assert sys.excepthook is prev_hook
    assert threading.excepthook is prev_thread_hook
    assert not blackbox._installed[0]


# -- the scrape endpoint ----------------------------------------------------

def _get(port, path):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=HTTP_TIMEOUT) as reply:
            return reply.status, reply.read().decode()
    except urllib.error.HTTPError as error:
        return error.code, error.read().decode()


def test_scrape_server_serves_the_default_sources(rings):
    def failing():
        raise RuntimeError("half-closed engine")

    server = scrape.ScrapeServer(scrape.default_sources(extra=(failing,)),
                                 role="trainer").start()
    try:
        status, page = _get(server.port, "/metrics")
        assert status == 200
        for family in ("veles_prof_compiles_total",
                       "veles_prof_recompiles_total",
                       "veles_trace_recorded_total",
                       "# scrape source failing failed: half-closed "
                       "engine"):
            assert family in page
        status, body = _get(server.port, "/healthz")
        assert (status, json.loads(body)) == (200, {"status": "ok",
                                                    "role": "trainer"})
        assert _get(server.port, "/nope")[0] == 404
    finally:
        server.stop()
    core.recorder.enabled = False
    assert "veles_trace" not in server.render()


def test_scrape_render_guards_sources_as_jax_does():
    def failing():
        raise ValueError("boom")

    sources = [lambda: "a_total 1", failing, lambda: "", lambda: "b 2\n"]
    assert scrape.ScrapeServer(sources).render() == \
        jax_scrape.ScrapeServer(sources).render()


def test_default_sources_sample_a_declared_slo():
    from veles_tpu_torch.obs import slo
    from veles_tpu_torch.serve import ServingMetrics
    engine = slo.standard_engine(ServingMetrics())
    text = scrape.ScrapeServer(scrape.default_sources(slo=engine)).render()
    assert engine.metrics_text().splitlines()[0] in text


# -- one traced request, end to end -----------------------------------------

def test_traced_generate_request_has_the_jax_smokes_waterfall(rings):
    from veles_tpu_torch.gen import GenerativeEngine, TransformerGenModel
    from veles_tpu_torch.samples.transformer import TINY
    from veles_tpu_torch.serve import ModelRegistry, ServingServer
    engine = GenerativeEngine(
        TransformerGenModel(dict(TINY, seq_len=64), device="cpu"),
        max_slots=2, max_seq=48, prefill_buckets=(8,), seed=0,
        device="cpu").warmup()
    registry = ModelRegistry()
    registry.deploy_generative("default", engine, warmup=False)
    server = ServingServer(registry=registry).start()
    inbound = obs.mint()
    try:
        request = urllib.request.Request(
            "http://%s:%d/generate" % (server.host, server.port),
            data=json.dumps({"tokens": [1, 2, 3],
                             "max_new_tokens": 4}).encode(),
            headers={"Content-Type": "application/json",
                     "traceparent": inbound.traceparent()})
        with urllib.request.urlopen(request, timeout=HTTP_TIMEOUT) as reply:
            body = json.loads(reply.read())
            echoed = reply.headers.get("traceparent")
    finally:
        server.stop()
    assert len(body["tokens"]) == 4
    assert echoed and inbound.trace_id in echoed
    spans = obs.spans_of(trace.normalize(), inbound.trace_id)
    names = {(ev["cat"], ev["name"]) for ev in spans}
    for want in (("serve", "http"), ("gen", "queue_wait"),
                 ("gen", "prefill"), ("gen", "decode"),
                 ("gen", "prefill_phase"), ("gen", "decode_phase"),
                 ("gen", "request")):
        assert want in names, sorted(names)
    # three decode steps after the prefill's token, each naming the trace
    decodes = [ev for ev in spans if ev["name"] == "decode"]
    assert len(decodes) == 3
    assert obs.role_lanes(trace.normalize(), inbound.trace_id).keys() \
        == {"server"}
