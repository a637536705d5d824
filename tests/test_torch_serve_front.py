"""The port's serving front end (``veles_tpu_torch.serve`` wire, batcher,
registry, server and metrics; ``veles_tpu_torch.obs``) against the JAX
package's, on the CPU.

Wire decoding, ``ServingMetrics.render_text``, the SLO burn-rate math
and trace-context parsing are held equal to the JAX package's on the
same inputs and recorded events; the HTTP server's status codes and
headers equal the JAX ``ServingServer``'s on the same requests.  The
batcher and the registry are driven through the behaviour
``tests/test_serve.py`` asks of the JAX package: coalescing, shedding,
shape rejection, chunking, the infer deadline, a hot swap with no torn
outputs, the reshape refusal and the replica and canary splits.  HTTP
goes over ``127.0.0.1:0`` with explicit timeouts."""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest

from veles_tpu.obs import context as jax_context
from veles_tpu.obs import slo as jax_slo
from veles_tpu.serve import InferenceEngine as JaxEngine
from veles_tpu.serve import ServingMetrics as JaxMetrics
from veles_tpu.serve import ServingServer as JaxServer
from veles_tpu.serve import decode_gen_request as jax_decode_gen
from veles_tpu.serve import decode_input as jax_decode_input
from veles_tpu.serve.batcher import QueueFull as JaxQueueFull
from veles_tpu_torch import trace
from veles_tpu_torch.config import root
from veles_tpu_torch.obs import context, slo
from veles_tpu_torch.serve import (DynamicBatcher, InferDeadlineExceeded,
                                   InferenceEngine, ModelRegistry,
                                   QueueFull, ReplicaSet, ServingMetrics,
                                   ServingServer, decode_gen_request,
                                   decode_input)
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

HTTP_TIMEOUT = 15


def _identity_engine(scale, dim=4, max_batch_size=8):
    """A real port engine computing ``x @ (scale·I)``: outputs name
    their version."""
    w = numpy.eye(dim, dtype=numpy.float32) * numpy.float32(scale)
    return InferenceEngine([{"w": w}], lambda p, x: x @ p[0]["w"], (dim,),
                           max_batch_size=max_batch_size, device="cpu")


def _jax_identity_engine(scale, dim=4, max_batch_size=8):
    w = numpy.eye(dim, dtype=numpy.float32) * numpy.float32(scale)
    return JaxEngine([{"w": w}], lambda p, x: x @ p[0]["w"],
                     sample_shape=(dim,), max_batch_size=max_batch_size)


class _StubEngine(object):
    """Engine-shaped double: records batch sizes, may block."""

    def __init__(self, max_batch_size=16, block=False):
        self.max_batch_size = max_batch_size
        self.buckets = (max_batch_size,)
        self.compile_count = 0
        self.sample_shape = (4,)
        self.calls = []
        self.release = threading.Event()
        if not block:
            self.release.set()

    def warmup(self):
        return self

    def infer(self, batch):
        self.calls.append(len(batch))
        self.release.wait(30)
        return numpy.asarray(batch, numpy.float32) * 2.0


# -- wire -------------------------------------------------------------------

_X = numpy.random.default_rng(0).standard_normal((3, 5)).astype(
    numpy.float32)
_U8 = numpy.arange(6, dtype=numpy.uint8).reshape(2, 3)

WIRE_CASES = [
    {"input": [[1, 2], [3, 4]]},
    {"input": [1.0, 2.0]},
    {"input": 3.0},
    {"input_b64": base64.b64encode(_X.tobytes()).decode(),
     "shape": [3, 5], "dtype": "float32"},
    {"input_b64": base64.b64encode(_U8.tobytes()).decode(),
     "shape": [2, 3], "dtype": "uint8"},
    {"input_b64": base64.b64encode(_X.tobytes()).decode(),
     "shape": [15]},
    [],
    {},
    {"input": [[1]], "input_b64": "AA=="},
    {"input": [["not", "numeric"]]},
    {"input": [[1, 2], [3]]},
    {"input_b64": "!!!", "shape": [1, 4]},
    {"input_b64": "AAAA", "shape": [1]},
    {"input_b64": "AAAA", "shape": [0]},
    {"input_b64": "AAAA", "shape": "3"},
    {"input_b64": "AAAA", "shape": [1], "dtype": "complex128"},
]


def _outcome(fn, payload):
    try:
        return "ok", fn(payload)
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("payload", WIRE_CASES)
def test_decode_input_equals_jax(payload):
    got, want = (_outcome(f, payload)
                 for f in (decode_input, jax_decode_input))
    assert got[0] == want[0]
    if got[0] == "ok":
        assert got[1].dtype == want[1].dtype == numpy.float32
        assert got[1].tobytes() == want[1].tobytes()
        assert got[1].shape == want[1].shape
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("payload", [
    {"tokens": [1, 2, 3]},
    {"tokens": [1, 2], "max_new_tokens": 4, "stream": True},
    {"tokens": []}, {"tokens": [1, -1]}, {"tokens": [True]},
    {"tokens": [1], "max_new_tokens": 0}, {"tokens": [1], "stream": 1},
    "tokens",
])
def test_decode_gen_request_equals_jax(payload):
    got, want = (_outcome(f, payload)
                 for f in (decode_gen_request, jax_decode_gen))
    assert got[0] == want[0]
    if got[0] == "ok":
        assert got[1][0].tolist() == want[1][0].tolist()
        assert got[1][1:] == want[1][1:]
    else:
        assert got[1] == want[1]


# -- batcher ----------------------------------------------------------------

def _coalesced_calls(batcher_cls, metrics):
    engine = _StubEngine(max_batch_size=16)
    batcher = batcher_cls(engine, max_wait_ms=500, metrics=metrics)
    try:
        n = 16
        barrier = threading.Barrier(n)
        futures = [None] * n

        def client(i):
            barrier.wait()
            futures[i] = batcher.submit(
                numpy.full((1, 4), float(i), numpy.float32))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(HTTP_TIMEOUT)
        for i, fut in enumerate(futures):
            assert (fut.result(10) == 2.0 * i).all()   # fan-out order
        return engine.calls
    finally:
        batcher.stop()


def test_batcher_coalesces_like_the_jax_batcher():
    from veles_tpu.serve import DynamicBatcher as JaxBatcher
    metrics = ServingMetrics()
    assert _coalesced_calls(DynamicBatcher, metrics) == \
        _coalesced_calls(JaxBatcher, JaxMetrics()) == [16]
    assert metrics.requests_total == 16
    assert metrics.batches_total == 1
    assert metrics.batch_fill_ratio() == 1.0


def test_full_queue_sheds_instead_of_stalling():
    engine = _StubEngine(max_batch_size=4, block=True)
    metrics = ServingMetrics()
    batcher = DynamicBatcher(engine, max_wait_ms=1, max_queue_rows=4,
                             metrics=metrics)
    try:
        first = batcher.submit(numpy.ones((1, 4), numpy.float32))
        deadline = time.time() + 5
        while not engine.calls and time.time() < deadline:
            time.sleep(0.005)
        assert engine.calls == [1]
        queued = [batcher.submit(numpy.ones((1, 4), numpy.float32))
                  for _ in range(4)]
        with pytest.raises(QueueFull):
            batcher.submit(numpy.ones((1, 4), numpy.float32))
        assert metrics.shed_total == 1
        assert QueueFull.retry_after == JaxQueueFull.retry_after
        engine.release.set()
        assert first.result(10).shape == (1, 4)
        for fut in queued:
            assert (fut.result(10) == 2.0).all()
    finally:
        engine.release.set()
        batcher.stop()


def test_misshaped_and_oversized_requests():
    engine = _identity_engine(1.0, dim=4, max_batch_size=8)
    batcher = DynamicBatcher(engine, max_wait_ms=1, max_queue_rows=64)
    try:
        with pytest.raises(ValueError, match="sample shape"):
            batcher.submit(numpy.ones((1, 5), numpy.float32))
        x = numpy.random.default_rng(1).standard_normal(
            (20, 4)).astype(numpy.float32)
        # taken alone and chunked by the engine: 8 + 8 + 4 rows
        assert batcher.infer(x, timeout=10).tobytes() == x.tobytes()
        assert engine.infer_calls == 3
        with pytest.raises(ValueError, match="queue bound"):
            batcher.submit(numpy.zeros((65, 4), numpy.float32))
    finally:
        batcher.stop()


@pytest.fixture
def serve_knobs():
    saved = dict(root.common.serve.to_dict())
    yield root.common.serve
    for key in list(root.common.serve.to_dict()):
        if key not in saved:
            delattr(root.common.serve, key)
    root.common.serve.update(saved)


def test_infer_deadline_fails_futures_typed(serve_knobs):
    engine = _StubEngine(max_batch_size=4, block=True)
    metrics = ServingMetrics()
    serve_knobs.infer_deadline_ms = 150
    batcher = DynamicBatcher(engine, max_wait_ms=1, metrics=metrics)
    try:
        tic = time.perf_counter()
        with pytest.raises(InferDeadlineExceeded):
            batcher.submit(numpy.ones((2, 4), numpy.float32)).result(10)
        assert time.perf_counter() - tic < 5
        assert metrics.deadline_expired_total == 1
        assert metrics.errors_total == 1
        assert "deadline_expired_total 1" in metrics.render_text()
        # a second wedged call, then the bound: fail fast
        with pytest.raises(InferDeadlineExceeded):
            batcher.submit(numpy.ones((1, 4), numpy.float32)).result(10)
        tic = time.perf_counter()
        with pytest.raises(InferDeadlineExceeded, match="still wedged"):
            batcher.submit(numpy.ones((1, 4), numpy.float32)).result(10)
        assert time.perf_counter() - tic < 0.15
        engine.release.set()
        time.sleep(0.05)
        out = batcher.infer(numpy.ones((1, 4), numpy.float32), timeout=10)
        assert out.shape == (1, 4)
    finally:
        engine.release.set()
        batcher.stop(drain=False)


# -- registry ---------------------------------------------------------------

def test_hot_swap_under_load_no_torn_outputs():
    registry = ModelRegistry(metrics=ServingMetrics(),
                             batcher_config={"max_wait_ms": 0.5})
    registry.deploy("m", _identity_engine(1.0))
    stop = threading.Event()
    bad, seen = [], set()

    def client():
        x = numpy.ones((2, 4), numpy.float32)
        while not stop.is_set():
            out = registry.infer("m", x, timeout=30)
            values = set(numpy.unique(out).tolist())
            if len(values) != 1:
                bad.append(out.copy())
            else:
                seen.add(values.pop())

    threads = [threading.Thread(target=client) for _ in range(8)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.15)
        registry.deploy("m", _identity_engine(2.0))
        assert registry.get("m").swaps == 1
        time.sleep(0.15)
    finally:
        stop.set()
        for t in threads:
            t.join(HTTP_TIMEOUT)
        registry.stop()
    assert not bad
    assert seen == {1.0, 2.0}


def test_update_params_under_load_no_torn_outputs():
    """The engine-level swap: update_params copies into the tensors a
    bucket reads while calls run; every output is all-old or all-new."""
    engine = _identity_engine(1.0, dim=64, max_batch_size=4).warmup()
    stop = threading.Event()
    bad, seen = [], set()

    def client():
        x = numpy.ones((3, 64), numpy.float32)
        while not stop.is_set():
            values = set(numpy.unique(engine.infer(x)).tolist())
            (bad.append(values) if len(values) != 1
             else seen.add(values.pop()))

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for i in range(40):
            engine.update_params([{"w": numpy.eye(64, dtype=numpy.float32)
                                   * float(i % 2 + 1)}])
            time.sleep(0.002)
    finally:
        stop.set()
        for t in threads:
            t.join(HTTP_TIMEOUT)
    assert not bad
    assert seen == {1.0, 2.0}
    assert engine.compile_count == len(engine.buckets)


def test_reshaping_swap_refused_without_opt_in():
    registry = ModelRegistry()
    registry.deploy("m", _identity_engine(1.0, dim=4))
    try:
        with pytest.raises(ValueError, match="allow_reshape"):
            registry.deploy("m", _identity_engine(1.0, dim=6))
        assert registry.get("m").swaps == 0
        registry.deploy("m", _identity_engine(1.0, dim=6),
                        allow_reshape=True)
        assert registry.get("m").swaps == 1
        assert (registry.infer("m", numpy.ones((1, 6), numpy.float32))
                == 1.0).all()
    finally:
        registry.stop()


def test_replica_set_splits_three_to_one():
    class _E(object):
        def __init__(self, tag):
            self.tag = tag

    router = ReplicaSet([(_E("a"), 3.0, 1), (_E("b"), 1.0, 2)])
    picks = [router.pick().tag for _ in range(40)]
    assert picks.count("a") == 30 and picks.count("b") == 10
    router.set_weights([1.0, 1.0])
    rest = [router.pick().tag for _ in range(20)]
    assert rest.count("a") == rest.count("b") == 10
    with pytest.raises(ValueError):
        ReplicaSet([(_E("a"), 0.0, 1)])


def test_canary_split_and_promotion():
    registry = ModelRegistry(batcher_config={"max_wait_ms": 0.1})
    registry.deploy("m", _identity_engine(1.0), version="v1")
    try:
        registry.deploy_canary("m", _identity_engine(2.0), weight=0.25)
        values = [float(registry.infer("m", numpy.ones((1, 4),
                                                       numpy.float32))[0, 0])
                  for _ in range(40)]
        assert values.count(1.0) == 30 and values.count(2.0) == 10
        info = registry.describe()["m"]
        assert [(r["version"], r["served"]) for r in info["replicas"]] \
            == [("v1", 30), ("canary", 10)]
        with pytest.raises(ValueError, match="replica set"):
            registry.deploy_canary("m", _identity_engine(3.0))
        registry.deploy("m", _identity_engine(2.0), version="v2")
        assert registry.describe()["m"]["version"] == "v2"
        assert (registry.infer("m", numpy.ones((1, 4), numpy.float32))
                == 2.0).all()
    finally:
        registry.stop()


def test_registry_describe_and_undeploy():
    metrics = ServingMetrics()
    registry = ModelRegistry(metrics=metrics)
    with pytest.raises(KeyError):
        registry.get("nope")
    registry.deploy("a", _identity_engine(1.0), version="v7",
                    source="unit-test")
    info = registry.describe()["a"]
    assert info["version"] == "v7" and info["source"] == "unit-test"
    assert info["compile_count"] == len(info["buckets"])
    assert info["quantize"] is None and info["sample_shape"] == [4]
    assert 'queue_depth{model="a"}' in metrics.render_text()
    registry.undeploy("a")
    assert registry.names() == []
    assert 'queue_depth{model="a"}' not in metrics.render_text()
    registry.stop()


# -- the HTTP server ----------------------------------------------------------

def _request(port, method, path, body=None, headers=None):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path), data=body, method=method,
        headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


_ROWS = numpy.arange(8, dtype=numpy.float32).reshape(2, 4)
SERVER_REQUESTS = [
    ("POST", "/service", json.dumps({"input": _ROWS.tolist()}).encode()),
    ("POST", "/service/default",
     json.dumps({"input": _ROWS.tolist()}).encode()),
    ("POST", "/service", json.dumps({
        "input_b64": base64.b64encode(_ROWS.tobytes()).decode(),
        "shape": [2, 4]}).encode()),
    ("POST", "/service/ghost", json.dumps({"input": [[1.0] * 4]}).encode()),
    ("POST", "/elsewhere", json.dumps({"input": [[1.0] * 4]}).encode()),
    ("POST", "/service", b"not json"),
    ("POST", "/service", json.dumps({"input": [[1.0] * 5]}).encode()),
    ("POST", "/service", json.dumps({}).encode()),
    ("GET", "/healthz", None),
    ("GET", "/metrics", None),
    ("GET", "/nothing", None),
]


def test_server_answers_like_the_jax_server():
    port_server = ServingServer(engine=_identity_engine(2.0), port=0,
                                batcher_config={"max_wait_ms": 1}).start()
    jax_server = JaxServer(engine=_jax_identity_engine(2.0), port=0,
                           batcher_config={"max_wait_ms": 1}).start()
    try:
        for method, path, body in SERVER_REQUESTS:
            got = _request(port_server.port, method, path, body)
            want = _request(jax_server.port, method, path, body)
            assert got[0] == want[0], (method, path)
            assert got[1]["Content-Type"] == want[1]["Content-Type"]
            assert ("Retry-After" in got[1]) == ("Retry-After" in want[1])
            if got[1]["Content-Type"] == "application/json":
                g, w = json.loads(got[2]), json.loads(want[2])
                assert sorted(g) == sorted(w)
                if got[0] == 200 and "result" in g:
                    assert g == w
        status, _, body = _request(port_server.port, "GET", "/healthz")
        health = json.loads(body)
        assert health["models"]["default"]["compile_count"] == 4
        text = _request(port_server.port, "GET", "/metrics")[2].decode()
        for line in ("veles_serve_requests_total 3",
                     "veles_prof_compiles_total", "veles_slo_queue_depth",
                     'queue_depth{model="default"}'):
            assert line in text
    finally:
        port_server.stop()
        jax_server.stop()


def test_backpressure_maps_to_503_with_the_jax_retry_after():
    stub = _StubEngine(max_batch_size=4, block=True)
    server = ServingServer(port=0, batcher_config={"max_wait_ms": 1,
                                                   "max_queue_rows": 2})
    server.registry.deploy("default", stub)
    server.start()
    results = []
    body = json.dumps({"input": [[1.0] * 4]}).encode()

    def client():
        results.append(_request(server.port, "POST", "/service", body))

    threads = [threading.Thread(target=client) for _ in range(6)]
    try:
        for t in threads:
            t.start()
            time.sleep(0.05)
        deadline = time.time() + 5
        while len(results) < 3 and time.time() < deadline:
            time.sleep(0.01)
        shed = [r for r in results if r[0] == 503]
        assert shed
        assert all(r[1]["Retry-After"] == str(JaxQueueFull.retry_after)
                   for r in shed)
    finally:
        stub.release.set()
        for t in threads:
            t.join(HTTP_TIMEOUT)
        server.stop()
    served = [r for r in results if r[0] == 200]
    assert served and all(json.loads(r[2])["result"] == [[2.0] * 4]
                          for r in served)
    assert len(served) + len([r for r in results if r[0] == 503]) == 6


@pytest.fixture
def tracing():
    saved = trace.recorder.enabled
    trace.configure("on")
    trace.recorder.clear()
    yield trace.recorder
    trace.recorder.enabled = saved
    trace.recorder.clear()


def test_traceparent_is_continued_and_echoed(tracing):
    server = ServingServer(engine=_identity_engine(1.0), port=0,
                           batcher_config={"max_wait_ms": 1}).start()
    incoming = "00-%s-%s-01" % ("ab" * 16, "cd" * 8)
    try:
        status, headers, _ = _request(
            server.port, "POST", "/service",
            json.dumps({"input": [[1.0] * 4]}).encode(),
            {"traceparent": incoming})
        assert status == 200
        echoed = context.parse(headers["traceparent"])
        assert echoed.trace_id == "ab" * 16
        events = trace.normalize()
        lanes = context.role_lanes(events, "ab" * 16)
        assert "http" in lanes["server"] and "request" in lanes["server"]
        assert "veles_trace_events_total" in server.metrics_page()
        # untraced follow-up on a fresh request mints a new trace
        status, headers, _ = _request(
            server.port, "POST", "/service",
            json.dumps({"input": [[1.0] * 4]}).encode())
        assert context.parse(headers["traceparent"]).trace_id != "ab" * 16
    finally:
        server.stop()


def test_restful_adapter_serves_the_workflow(tmp_path):
    from veles_tpu_torch.restful_api import RESTfulAPI
    from veles_tpu_torch.samples import mnist
    wf = mnist.create_workflow(device="cpu", max_epochs=1)
    api = RESTfulAPI(wf, port=0, max_batch_size=8)
    api.forwards = wf.forwards
    api.initialize(device=wf.device)
    try:
        x = numpy.random.default_rng(2).random((2, 784)).astype(
            numpy.float32)
        status, _, body = _request(api.port, "POST", "/service", json.dumps(
            {"input_b64": base64.b64encode(x.tobytes()).decode(),
             "shape": [2, 784]}).encode())
        assert status == 200
        got = numpy.asarray(json.loads(body)["result"], numpy.float32)
        numpy.testing.assert_allclose(got, api.infer(x), rtol=0, atol=1e-6)
        assert api.engine.device.type == "cpu"
        # lazily captured: only the buckets traffic hit
        assert 0 < api.engine.compile_count <= len(api.engine.buckets)
        assert api.metrics.requests_total >= 2
    finally:
        api.stop()


# -- metrics, SLOs, trace contexts ------------------------------------------

def _record(metrics):
    rng = numpy.random.default_rng(5)
    for i in range(50):
        metrics.observe_request(float(rng.uniform(1e-4, 0.5)), rows=i % 3 + 1,
                                error=i % 17 == 0)
    for i in range(12):
        metrics.record_batch(i % 8 + 1, 8, float(rng.uniform(1e-4, 0.05)))
    metrics.record_shed()
    metrics.record_deadline()
    metrics.register_gauge('queue_depth{model="m"}', lambda: 3)


def _stable(text):
    return [line for line in text.splitlines()
            if not line.startswith("veles_serve_uptime_seconds")]


def test_serving_metrics_render_equal_to_jax():
    got, want = ServingMetrics(), JaxMetrics()
    for metrics in (got, want):
        _record(metrics)
    assert _stable(got.render_text()) == _stable(want.render_text())
    g, w = got.snapshot(), want.snapshot()
    for snap in (g, w):
        snap.pop("uptime_sec")
    assert g == w


def _slo_pair(module, metrics):
    engine = module.standard_engine(metrics, configure=False)
    engine.add_objective(module.Objective(
        "queue_depth", 4, window_s=60, fast_window_s=5, target=0.9))
    engine.add_objective(module.Objective(
        "batch_fill", 0.5, op=">", window_s=30, fast_window_s=10,
        target=0.95, burn_threshold=1.0))
    return engine


def test_slo_burn_rates_equal_to_jax():
    depth = {"v": 0.0}
    got_metrics, want_metrics = ServingMetrics(), JaxMetrics()
    for metrics in (got_metrics, want_metrics):
        metrics.register_gauge('queue_depth{model="m"}',
                               lambda: depth["v"])
        metrics.record_batch(3, 8, 0.01)
    got = _slo_pair(slo, got_metrics)
    want = _slo_pair(jax_slo, want_metrics)
    now = 1000.0
    for step in range(40):
        depth["v"] = float((step * 7) % 11)
        for engine in (got, want):
            engine.sample(now=now + step)
    at = now + 39
    assert got.evaluate(now=at) == want.evaluate(now=at)
    assert got.autoscaling_signals(now=at) == \
        want.autoscaling_signals(now=at)
    assert got.metrics_text(now=at) == want.metrics_text(now=at)
    assert got.alerts_total == want.alerts_total
    for objective in got.objectives:
        assert got.burn_rate(objective, now=at) == pytest.approx(
            want.burn_rate(want.objectives[got.objectives.index(objective)],
                           now=at))


@pytest.mark.parametrize("header", [
    "00-%s-%s-01" % ("0af7651916cd43dd8448eb211c80319c",
                     "b7ad6b7169203331"),
    " 00-%s-%s-01 " % ("A" * 32, "B" * 16),
    "00-%s-%s-01" % ("0" * 32, "b7ad6b7169203331"),
    "00-%s-%s-01" % ("1" * 32, "0" * 16),
    "00-%s-%s" % ("1" * 32, "2" * 16),
    "zz-%s-%s-01" % ("1" * 32, "2" * 16),
    "00-%s-%s-01" % ("1" * 31, "2" * 16),
    "", None, 17,
])
def test_trace_context_parse_equals_jax(header):
    got, want = context.parse(header), jax_context.parse(header)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.parent_id) == \
            (want.trace_id, want.parent_id)
        assert len(got.span_id) == 16 and got.span_id != want.parent_id


def test_trace_context_mint_round_trips():
    ctx = context.mint()
    assert len(ctx.trace_id) == 32 and ctx.parent_id is None
    back = context.parse(ctx.traceparent())
    assert back.trace_id == ctx.trace_id and back.parent_id == ctx.span_id
    assert jax_context.parse(ctx.traceparent()).trace_id == ctx.trace_id
    child = ctx.child()
    assert child.trace_id == ctx.trace_id and child.parent_id == ctx.span_id
    args = child.span_args({"rows": 2})
    assert args == {"rows": 2, "trace": ctx.trace_id,
                    "span": child.span_id, "parent": ctx.span_id}
    msg = context.wire_inject({}, ctx)
    assert context.parse(msg[context.WIRE_KEY]).trace_id == ctx.trace_id


def test_disabled_tracing_allocates_nothing():
    assert not trace.recorder.enabled
    assert context.ingress("00-%s-%s-01" % ("1" * 32, "2" * 16)) is None
    assert context.activate(None) is context.NULL_CONTEXT
    args = {"k": 1}
    assert context.tag(args) is args
    assert context.current() is None
