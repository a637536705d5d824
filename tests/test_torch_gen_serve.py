"""Generative serving through the port's registry and HTTP front end
(``veles_tpu_torch.serve`` with ``veles_tpu_torch.analyze``) against the
JAX package's, on the CPU at TINY width.

- Rule V-S01 (``check_generative``): the port's findings over
  ``tests/pricing_cases.GenPlanStub``'s ``gen`` matrix (and a few more
  plans) and over live TINY engines of both packages (contiguous, paged
  with the prefix cache, speculative, int8) equal the JAX package's
  ``(severity, rule, message, fix)`` lists, apart from the rewordings of
  ``REWORDINGS``.
- The preflight modes, the registry (deploy, generate, describe,
  undeploy, the kind mix-up refusals, int8, the drain swap) and the
  server (``handle_generate``'s statuses and payloads,
  ``stream_generate``'s framing, a real HTTP round trip, whole and
  chunked) give the JAX package's tokens, codes and payloads for the
  same bodies.  Both engines take one numpy params tree (the JAX
  package's ``init_params``; the port carries it with
  ``gen.model.params_from_numpy``); tokens are compared exactly.
- The scheduler's ``/metrics`` gauges carry the JAX scheduler's names
  and labels for each kind of engine.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy
import pytest

from pricing_cases import GEN_CASES, GenPlanStub
from veles_tpu.analyze import PreflightError as JaxPreflightError
from veles_tpu.analyze.shapes import check_generative as jax_check
from veles_tpu.config import root as jax_root
from veles_tpu.gen import GenerativeEngine as JaxEngine
from veles_tpu.gen import TransformerGenModel as JaxModel
from veles_tpu.memory import Watcher as JaxWatcher
from veles_tpu.samples import transformer as jax_transformer
from veles_tpu.serve import InferenceEngine as JaxInferenceEngine
from veles_tpu.serve import ModelRegistry as JaxRegistry
from veles_tpu.serve import ServingMetrics as JaxMetrics
from veles_tpu.serve import ServingServer as JaxServer
from veles_tpu_torch.analyze import PreflightError, rule_catalog
from veles_tpu_torch.analyze.shapes import check_generative
from veles_tpu_torch.config import root
from veles_tpu_torch.gen import GenerativeEngine, TransformerGenModel
from veles_tpu_torch.memory import Watcher
from veles_tpu_torch.samples.transformer import TINY
from veles_tpu_torch.serve import (InferenceEngine, ModelRegistry, QueueFull,
                                   ServingMetrics, ServingServer)
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

CFG = dict(TINY, seq_len=64)
CPU = "cpu"
HTTP_TIMEOUT = 30

#: the JAX messages' TPU phrases and the port's wording for the card,
#: applied to a JAX message before it is compared with the port's
REWORDINGS = (
    ("every one is a warmed XLA program; a handful of powers of two",
     "every one is a prefill shape warmup() runs; a handful of powers "
     "of two"),
    ("breaks the paged decode kernel's 8-sublane padding — K/V pages "
     "must tile the (8, 128) register layout",
     "is not a multiple of 8 — the paged gate's page alignment (the "
     "card's paged decode kernel takes any page size; the JAX package's, "
     "the parity reference, tiles pages in 8 rows)"),
)

#: plans beyond the pricing matrix: name -> (stub kwargs, check kwargs)
EXTRA_CASES = {
    "many_buckets": ({"prefill_buckets": tuple(range(1, 11)),
                      "max_seq": 48}, {"hbm_bytes": 1 << 30}),
    "bucket_past_max_seq": ({"prefill_buckets": (64,)},
                            {"hbm_bytes": 1 << 30}),
    "past_positional_table": ({"max_seq": 128}, {"hbm_bytes": 1 << 30}),
    "no_buckets": ({"prefill_buckets": ()}, {"hbm_bytes": 1 << 30}),
    "paged_block_not_dividing": ({"kv_mode": "paged", "block_size": 32},
                                 {"hbm_bytes": 1 << 30}),
    "chunk_not_dividing": ({"kv_mode": "paged", "prefill_chunk": 32},
                           {"hbm_bytes": 1 << 30}),
}


def _reword(message):
    for jax_text, port_text in REWORDINGS:
        message = message.replace(jax_text, port_text)
    return message


def _findings(report, reword=False):
    return [(f.severity, f.rule, _reword(f.message) if reword else f.message,
             f.fix) for f in report]


def _stub(**kwargs):
    """The pricing matrix's plan stub, made twice (the JAX check may
    read attributes the port's does not, and neither may keep state)."""
    return GenPlanStub(**dict(kwargs))


# -- V-S01 ------------------------------------------------------------------

def test_vs01_is_in_the_catalog_as_the_jax_package_has_it():
    from veles_tpu.analyze.findings import rule_catalog as jax_catalog
    assert rule_catalog() == {"V-S01": jax_catalog()["V-S01"]}


@pytest.mark.parametrize("name", sorted(GEN_CASES) + sorted(EXTRA_CASES))
def test_vs01_plan_findings_equal_jax(name):
    stub_kw, check_kw = dict(GEN_CASES, **EXTRA_CASES)[name]
    want = jax_check(_stub(**stub_kw), **check_kw)
    got = check_generative(_stub(**stub_kw), **check_kw)
    assert _findings(got) == _findings(want, reword=True)
    assert got.has_errors == want.has_errors
    assert got.passes == want.passes == ["generative"]


def test_vs01_rewordings_are_the_listed_ones():
    """Each listed rewording is met by some plan, and no other message
    differs (checked above)."""
    met = set()
    for stub_kw, check_kw in list(GEN_CASES.values()) \
            + list(EXTRA_CASES.values()):
        for finding in jax_check(_stub(**stub_kw), **check_kw):
            for jax_text, _port in REWORDINGS:
                if jax_text in finding.message:
                    met.add(jax_text)
    assert met == {jax_text for jax_text, _port in REWORDINGS}


def _host(seed=0):
    return jax_transformer.init_params(CFG, seed=seed)


ENGINE_KINDS = {
    "contiguous": {},
    "paged_prefix": {"kv": "paged", "block_size": 8, "prefill_chunk": 8,
                     "prefix_cache": "on"},
    "speculative": {"speculative": "ngram"},
    "int8": {},
}


def _engine_pair(kind, seed=0, max_slots=3, max_seq=48, buckets=(8, 16)):
    """One numpy params tree in a JAX and a port engine of ``kind``."""
    host = _host(seed)
    kw = dict(max_slots=max_slots, max_seq=max_seq, prefill_buckets=buckets,
              **ENGINE_KINDS[kind])
    jax_engine = JaxEngine(JaxModel(CFG), params=host, **kw)
    port_engine = GenerativeEngine(TransformerGenModel(CFG, device=CPU),
                                   params=host, device=CPU, **kw)
    if kind == "int8":
        jax_engine.quantize_int8()
        port_engine.quantize_int8()
    return jax_engine, port_engine


def test_pricing_bytes_and_budget_equal_jax():
    import torch
    from veles_tpu.analyze import pricing as jax_pricing
    from veles_tpu_torch.analyze import pricing
    array = numpy.zeros((3, 5), numpy.int8)
    assert pricing.leaf_nbytes(array) == jax_pricing.leaf_nbytes(array) == 15
    assert pricing.leaf_nbytes(torch.zeros(3, 5)) == 60
    assert pricing.leaf_nbytes("not an array") == 0
    for hbm in (None, 0, 1000, 80 * 10 ** 9):
        assert pricing.hbm_budget(hbm) == jax_pricing.hbm_budget(hbm)
    assert pricing.resolve_device_hbm(123) == 123
    assert pricing.resolve_device_hbm(None, "cpu") is None
    # a storage shared by two leaves counts once (the readout's alias)
    embed = torch.zeros(4, 8)
    assert pricing.params_nbytes({"embed": embed, "embed_cd": embed,
                                  "q": numpy.zeros(6, numpy.int8)}) == 134


@pytest.mark.parametrize("kind", sorted(ENGINE_KINDS))
def test_vs01_live_engine_findings_equal_jax(kind):
    jax_engine, port_engine = _engine_pair(kind)
    try:
        assert port_engine.kv_cache_bytes == jax_engine.kv_cache_bytes
        footprint = port_engine.kv_cache_bytes + port_engine.params_nbytes
        # clean, the half-memory warning, the over-budget error
        for hbm in (1 << 40, int(footprint * 1.5), footprint):
            want = jax_check(jax_engine, hbm_bytes=hbm)
            got = check_generative(port_engine, hbm_bytes=hbm)
            assert _findings(got) == _findings(want, reword=True), hbm
        assert check_generative(port_engine, hbm_bytes=footprint).has_errors
        # a CPU engine has no card memory: plan sanity only
        assert not check_generative(port_engine).has_errors
    finally:
        jax_engine.close()
        port_engine.close()


# -- the preflight modes ----------------------------------------------------

@pytest.fixture
def preflight():
    """Both packages' ``root.common.serve.preflight``, restored."""
    saved = {}
    for name, cfg in (("port", root), ("jax", jax_root)):
        saved[name] = cfg.common.serve.__dict__.get("preflight", KeyError)
    yield
    for name, cfg in (("port", root), ("jax", jax_root)):
        if saved[name] is KeyError:
            cfg.common.serve.__dict__.pop("preflight", None)
        else:
            cfg.common.serve.preflight = saved[name]


def _set_preflight(mode):
    root.common.serve.preflight = mode
    jax_root.common.serve.preflight = mode


def test_preflight_modes_mirror_jax(preflight):
    registry, jax_registry = ModelRegistry(), JaxRegistry()
    try:
        _set_preflight("fail")
        with pytest.raises(JaxPreflightError) as want:
            jax_registry.preflight_generative(_stub(causal=False))
        with pytest.raises(PreflightError) as got:
            registry.preflight_generative(_stub(causal=False))
        assert _findings(got.value.report) == _findings(want.value.report)
        assert str(got.value) == str(want.value)
        assert registry.preflight_generative(_stub()) is not None
        _set_preflight("warn")
        report = registry.preflight_generative(_stub(causal=False))
        assert report.has_errors          # logged, not raised
        _set_preflight("off")
        assert registry.preflight_generative(_stub(causal=False)) is None
        assert jax_registry.preflight_generative(
            _stub(causal=False)) is None
        _set_preflight("sometimes")
        with pytest.raises(ValueError) as got:
            registry.preflight_generative(_stub())
        with pytest.raises(ValueError) as want:
            jax_registry.preflight_generative(_stub())
        assert str(got.value) == str(want.value)
    finally:
        registry.stop()
        jax_registry.stop()


def _port_engine(seed=0, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_seq", 48)
    kw.setdefault("prefill_buckets", (8, 16))
    return GenerativeEngine(TransformerGenModel(CFG, device=CPU),
                            params=_host(seed), device=CPU, **kw)


def _jax_engine(seed=0, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_seq", 48)
    kw.setdefault("prefill_buckets", (8, 16))
    return JaxEngine(JaxModel(CFG), params=_host(seed), **kw)


def test_fail_preflight_refuses_before_any_warmup(preflight):
    _set_preflight("fail")
    registry = ModelRegistry()
    engine = _port_engine()
    engine.model.causal = False
    try:
        with pytest.raises(PreflightError):
            registry.deploy_generative("lm", engine)
        assert not engine._warmed and engine.prefill_calls == 0
        assert "lm" not in registry
    finally:
        registry.stop()
        engine.close()


def test_warn_preflight_at_the_default_logs_and_deploys(preflight):
    root.common.serve.__dict__.pop("preflight", None)
    registry = ModelRegistry()
    engine = _port_engine(max_seq=64,
                          prefill_buckets=tuple(range(1, 11)))
    try:
        registry.deploy_generative("lm", engine)   # a V-S01 warning
        assert engine._warmed
        assert len(registry.generate("lm", [1, 2, 3], 3)) == 3
    finally:
        registry.stop()


# -- the registry -----------------------------------------------------------

PROMPTS = [([1, 2, 3], 4), ([7] * 12, 6), ([5, 9], 3), ([3] * 16, 5)]


def _both_generate(kind_kw, prompts=PROMPTS, quantize=None):
    jax_registry, registry = JaxRegistry(), ModelRegistry()
    try:
        jax_registry.deploy_generative("lm", _jax_engine(**kind_kw),
                                       version=7, quantize=quantize)
        registry.deploy_generative("lm", _port_engine(**kind_kw),
                                   version=7, quantize=quantize)
        want = [jax_registry.generate("lm", t, m) for t, m in prompts]
        got = [registry.generate("lm", t, m) for t, m in prompts]
        return got, want, registry.describe()["lm"], \
            jax_registry.describe()["lm"]
    finally:
        registry.stop()
        jax_registry.stop()


DESCRIBED = ("generative", "version", "max_slots", "max_seq",
             "prefill_buckets", "kv_cache_bytes", "kv", "quantize",
             "prefill_chunk", "admitted_total", "finished_total",
             "tokens_total", "shed_total", "queue_depth", "active_requests",
             "prefix_cache", "speculative")


@pytest.mark.parametrize("kind", ["contiguous", "paged_prefix", "int8"])
def test_registry_generate_gives_the_jax_tokens(kind):
    kind_kw = {} if kind == "int8" else dict(ENGINE_KINDS[kind])
    got, want, info, jax_info = _both_generate(
        kind_kw, quantize="int8" if kind == "int8" else None)
    assert got == want
    assert [len(t) for t in got] == [m for _t, m in PROMPTS]
    for key in DESCRIBED:
        assert info[key] == jax_info[key], key
    if kind == "paged_prefix":
        assert info["blocks_total"] == jax_info["blocks_total"]
    if kind == "int8":
        assert info["quantize"] == "int8"
        assert info["params_bytes"] == jax_info["params_bytes"]


def test_registry_describe_undeploy_and_the_request_response_refusal():
    metrics = ServingMetrics()
    registry = ModelRegistry(metrics=metrics)
    engine = _port_engine()
    model = registry.deploy_generative("lm", engine, version=7,
                                       warmup=False)
    try:
        assert model.engine is engine and model.is_generative
        info = registry.describe()["lm"]
        assert (info["generative"], info["version"]) == (True, 7)
        assert info["kv_cache_bytes"] == engine.kv_cache_bytes
        with pytest.raises(ValueError, match="generative"):
            registry.submit("lm", numpy.ones((1, 4), numpy.float32))
        with pytest.raises(ValueError, match="canary"):
            registry.deploy_canary("lm", engine)
        assert 'gen_tokens_total{model="lm"}' in metrics.snapshot()
        registry.undeploy("lm")
        assert "lm" not in registry
        assert not engine._kv_tracked
        assert 'gen_tokens_total{model="lm"}' not in metrics.snapshot()
        with pytest.raises(KeyError):
            registry.generate("lm", [1], 2)
    finally:
        registry.stop()


def _dense(package_engine, **kw):
    return package_engine({"w": numpy.eye(4, dtype=numpy.float32)},
                          lambda p, x: x @ p["w"], (4,), max_batch_size=4,
                          **kw)


def _port_dense():
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.znicz.all2all import All2All
    unit = All2All(DummyWorkflow())
    return InferenceEngine([{"w": numpy.eye(4, dtype=numpy.float32)}],
                           lambda p, x: unit.pure(p[0], x), (4,),
                           max_batch_size=4, device=CPU)


def test_kind_mixups_raise_the_jax_messages():
    registry, jax_registry = ModelRegistry(), JaxRegistry()
    errors = {}
    try:
        for label, reg, dense, gen in (
                ("port", registry, _port_dense, _port_engine),
                ("jax", jax_registry, lambda: _dense(JaxInferenceEngine),
                 _jax_engine)):
            reg.deploy("m", dense())
            with pytest.raises(ValueError) as gen_over_dense:
                reg.deploy_generative("m", gen(), warmup=False)
            reg.deploy_generative("lm", gen(), warmup=False)
            with pytest.raises(ValueError) as dense_over_gen:
                reg.deploy("lm", dense())
            with pytest.raises(ValueError) as not_generative:
                reg.generate("m", [1], 2)
            errors[label] = [str(e.value) for e in (
                gen_over_dense, dense_over_gen, not_generative)]
    finally:
        registry.stop()
        jax_registry.stop()
    assert errors["port"] == errors["jax"]


def test_drain_swap_releases_v1_kv_once_and_serves_v2():
    """Mirror of ``tests/test_serve.py``'s drain swap: v1's in-flight
    streams finish on v1 with their whole budget, new requests land on
    v2, and v1's KV ledger hold leaves exactly once (close() is
    idempotent)."""
    metrics = ServingMetrics()
    registry = ModelRegistry(metrics=metrics)
    v1 = _port_engine(seed=1, max_seq=32, prefill_buckets=(8,))
    registry.deploy_generative("lm", v1, version=1)
    v1_scheduler = registry.get("lm").scheduler
    kv_before = Watcher.bytes_by_category.get("kv", 0)
    futures = [v1_scheduler.submit([1 + i, 2], 12) for i in range(4)]
    v2 = _port_engine(seed=2, max_seq=32, prefill_buckets=(8,))
    try:
        registry.deploy_generative("lm", v2, version=2)
        assert all(len(f.result(timeout=30)) == 12 for f in futures)
        assert registry.get("lm").version == 2
        assert registry.get("lm").scheduler is not v1_scheduler
        kv_after = Watcher.bytes_by_category.get("kv", 0)
        assert kv_after == kv_before + v2.kv_cache_bytes - v1.kv_cache_bytes
        v1.close()
        assert Watcher.bytes_by_category.get("kv", 0) == kv_after
        assert len(registry.generate("lm", [3, 4], max_new_tokens=3)) == 3
        # the successor's gauges survive the old scheduler's stop
        assert metrics.snapshot()['gen_admitted_total{model="lm"}'] == 1
        registry.undeploy("lm")
        assert Watcher.bytes_by_category.get("kv", 0) == \
            kv_after - v2.kv_cache_bytes
    finally:
        registry.stop()


def test_drain_swap_streams_equal_the_v1_engine_alone():
    """A drain swap under load: the v1 streams are the tokens v1 gives
    alone (the same prompts through a fresh registry)."""
    prompts = [([1 + i, 2, 3], 10) for i in range(3)]
    registry = ModelRegistry()
    registry.deploy_generative("lm", _port_engine(seed=1))
    try:
        alone = [registry.generate("lm", t, m) for t, m in prompts]
    finally:
        registry.stop()
    registry = ModelRegistry()
    registry.deploy_generative("lm", _port_engine(seed=1))
    scheduler = registry.get("lm").scheduler
    futures = [scheduler.submit(t, m) for t, m in prompts]
    try:
        registry.deploy_generative("lm", _port_engine(seed=2))
        assert [f.result(timeout=30) for f in futures] == alone
        assert registry.get("lm").version == 2
    finally:
        registry.stop()


def test_draining_stop_waits_for_a_request_between_queue_and_slot():
    """A request the worker has popped from the queue but not yet placed
    in a slot is still in flight: a draining stop() lets it finish (the
    JAX scheduler's idle check misses it and fails it "mid-stream", a
    race the drain swap runs into)."""
    from veles_tpu_torch.gen import GenerativeScheduler
    engine = _port_engine()
    scheduler = GenerativeScheduler(engine).start()
    entered, release = threading.Event(), threading.Event()
    admit = engine.admit

    def slow_admit(tokens):
        entered.set()
        release.wait(HTTP_TIMEOUT)
        return admit(tokens)

    engine.admit = slow_admit
    future = scheduler.submit([1, 2], 3)
    assert entered.wait(HTTP_TIMEOUT)
    stopper = threading.Thread(target=scheduler.stop)
    stopper.start()
    stopper.join(0.2)
    release.set()
    stopper.join(HTTP_TIMEOUT)
    assert not stopper.is_alive()
    assert len(future.result(0)) == 3
    engine.close()


def test_a_stopped_scheduler_leaves_its_successors_gauges():
    """The successor under the same name registers its gauges and TTFT
    histogram before the old scheduler stops: the old one's stop drops
    only what is still bound to it, so ``/metrics`` never loses the
    ``gen_*`` lines in between, and the successor's stop drops them."""
    from veles_tpu_torch.gen import GenerativeScheduler
    metrics = ServingMetrics()
    engines = [_port_engine(seed=1), _port_engine(seed=2)]
    old, new = (GenerativeScheduler(e, metrics=metrics, name="lm").start()
                for e in engines)
    label = '{model="lm"}'
    hist_key = ("gen_ttft_seconds", (("model", "lm"),))
    try:
        old.stop()
        gauges = dict(metrics._gauge_items())
        assert set(new._gauges) <= set(gauges)
        assert all(gauges[key] is fn for key, fn in new._gauges.items())
        assert dict(metrics._histogram_items())[hist_key][0] is new.ttft
        assert "gen_queue_depth" + label in metrics.snapshot()
    finally:
        new.stop()
        for engine in engines:
            engine.close()
    assert not any(key.startswith("gen_") for key, _ in
                   metrics._gauge_items())
    assert hist_key not in dict(metrics._histogram_items())


def test_jax_drain_swap_drops_the_successors_gauges():
    """A fault of the reference, recorded: the old scheduler's stop()
    unregisters the gauge names the successor registered, so the JAX
    package's ``/metrics`` loses every ``gen_*`` line after a swap.  The
    port keeps them (above)."""
    metrics = JaxMetrics()
    registry = JaxRegistry(metrics=metrics)
    try:
        registry.deploy_generative("lm", _jax_engine(seed=1, max_seq=32,
                                                     prefill_buckets=(8,)))
        assert any("gen_" in key for key in metrics.snapshot())
        registry.deploy_generative("lm", _jax_engine(seed=2, max_seq=32,
                                                     prefill_buckets=(8,)))
        assert not any("gen_" in key for key in metrics.snapshot())
    finally:
        registry.stop()
    assert JaxWatcher.bytes_by_category.get("kv", 0) >= 0


# -- the server -------------------------------------------------------------

def _servers(port_kw=None, jax_kw=None, scheduler_config=None,
             request_timeout=30.0):
    """A port and a JAX ServingServer, each serving the same params
    under "lm" (version 1)."""
    out = []
    for reg_cls, srv_cls, make in ((ModelRegistry, ServingServer,
                                    _port_engine),
                                   (JaxRegistry, JaxServer, _jax_engine)):
        registry = reg_cls()
        registry.deploy_generative("lm", make(**(port_kw or {})), version=1,
                                   scheduler_config=scheduler_config)
        out.append(srv_cls(registry=registry,
                           request_timeout=request_timeout))
    return out


BODIES = {
    "ok": {"tokens": [1, 2], "max_new_tokens": 3},
    "ok_default_budget": {"tokens": [4, 4, 4]},
    "empty_prompt": {"tokens": []},
    "typed_budget": {"tokens": [1], "max_new_tokens": "9"},
    "negative_token": {"tokens": [1, -2]},
    "bool_token": {"tokens": [1, True]},
    "stream_typed": {"tokens": [1], "stream": "yes"},
    "over_max_seq": {"tokens": [1] * 40, "max_new_tokens": 16},
    "over_buckets": {"tokens": [1] * 17, "max_new_tokens": 2},
    "not_a_dict": [1, 2],
}


@pytest.fixture(scope="module")
def server_pair():
    port, jax = _servers()
    yield port, jax
    port.stop()
    jax.stop()


@pytest.mark.parametrize("path", ["/generate/lm", "/generate/nope",
                                  "/generate", "/generator/lm"])
@pytest.mark.parametrize("body", sorted(BODIES))
def test_handle_generate_equals_jax(server_pair, path, body):
    port, jax = server_pair
    raw = json.dumps(BODIES[body]).encode()
    assert port.handle_generate(path, raw) == jax.handle_generate(path, raw)


@pytest.mark.parametrize("raw", [b"not json", b"", b"{}", b"null"])
def test_handle_generate_bad_bodies_equal_jax(server_pair, raw):
    port, jax = server_pair
    assert port.handle_generate("/generate/lm", raw) == \
        jax.handle_generate("/generate/lm", raw)


def test_request_response_names_refuse_the_generate_route():
    registry, jax_registry = ModelRegistry(), JaxRegistry()
    registry.deploy("default", _port_dense())
    registry.deploy_generative("lm", _port_engine(), warmup=False)
    jax_registry.deploy("default", _dense(JaxInferenceEngine))
    jax_registry.deploy_generative("lm", _jax_engine(), warmup=False)
    port, jax = ServingServer(registry=registry), \
        JaxServer(registry=jax_registry)
    try:
        body = json.dumps({"input": [[0.0] * 4]}).encode()
        assert port.handle_generate("/generate", b"{}") == \
            jax.handle_generate("/generate", b"{}")
        assert port.handle_predict("/service/lm", body) == \
            jax.handle_predict("/service/lm", body)
    finally:
        port.stop()
        jax.stop()


def test_queue_full_is_503_with_the_jax_retry_after():
    port, jax = _servers(scheduler_config={"max_queue": 0})
    try:
        raw = json.dumps(BODIES["ok"]).encode()
        got, want = port.handle_generate("/generate/lm", raw), \
            jax.handle_generate("/generate/lm", raw)
        assert got == want
        assert got[0] == 503 and got[1]["retry_after"] == \
            QueueFull.retry_after
        assert list(port.stream_generate("/generate/lm", raw)) == \
            list(jax.stream_generate("/generate/lm", raw))
    finally:
        port.stop()
        jax.stop()


def test_timeout_is_504_as_in_jax():
    port, jax = _servers(request_timeout=0.0)
    try:
        raw = json.dumps({"tokens": [1, 2], "max_new_tokens": 20}).encode()
        got, want = port.handle_generate("/generate/lm", raw), \
            jax.handle_generate("/generate/lm", raw)
        assert got == want == (504, {"error": "generation timed out after "
                                              "0.0s"})
    finally:
        port.stop()
        jax.stop()


@pytest.mark.parametrize("body", [
    {"tokens": [5], "max_new_tokens": 2, "stream": True},
    {"tokens": [1, 2, 3, 4], "max_new_tokens": 7, "stream": True},
    {"tokens": [], "stream": True},
    {"tokens": [1] * 17, "max_new_tokens": 2, "stream": True}])
def test_stream_generate_framing_equals_jax(server_pair, body):
    port, jax = server_pair
    raw = json.dumps(body).encode()
    got = list(port.stream_generate("/generate/lm", raw))
    want = list(jax.stream_generate("/generate/lm", raw))
    assert got == want
    if got[0][0] == 200:
        events = [json.loads(line) for _s, line in got]
        assert [e["index"] for e in events[:-1]] == \
            list(range(len(events) - 1))
        assert [e["token"] for e in events[:-1]] == events[-1]["tokens"]
        assert events[-1]["done"] is True


def _post(port, path, body, headers=None):
    request = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path), data=body,
        headers=dict({"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(request, timeout=HTTP_TIMEOUT) as reply:
            return reply.status, dict(reply.headers), reply.read()
    except urllib.error.HTTPError as error:
        return error.code, dict(error.headers), error.read()


def test_http_round_trip_whole_and_streamed():
    registry = ModelRegistry(metrics=ServingMetrics())
    registry.deploy_generative("lm", _port_engine(), version=3)
    server = ServingServer(registry=registry, port=0).start()
    want = registry.generate("lm", [1, 2, 3], 5)
    results = {}

    def client(stream):
        body = json.dumps({"tokens": [1, 2, 3], "max_new_tokens": 5,
                           "stream": stream}).encode()
        results[stream] = _post(server.port, "/generate/lm", body)

    try:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in (False, True)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(HTTP_TIMEOUT)
        status, headers, body = results[False]
        assert status == 200 and headers["Content-Type"] == \
            "application/json"
        assert json.loads(body) == {"tokens": want, "model": "lm",
                                    "version": 3}
        status, headers, body = results[True]
        assert status == 200
        assert headers["Content-Type"] == "application/x-ndjson"
        assert headers["Transfer-Encoding"] == "chunked"
        events = [json.loads(line) for line in body.decode().splitlines()]
        assert [e["token"] for e in events[:-1]] == want
        assert events[-1] == {"tokens": want, "model": "lm", "version": 3,
                              "done": True}
        # an early rejection still maps to its status code when streamed
        status, _h, body = _post(server.port, "/generate/lm", json.dumps(
            {"tokens": [], "stream": True}).encode())
        assert status == 400 and "empty" in json.loads(body)["error"]
        status, _h, _b = _post(server.port, "/generate/nope", b"{}")
        assert status == 404
        with urllib.request.urlopen("http://127.0.0.1:%d/metrics"
                                    % server.port,
                                    timeout=HTTP_TIMEOUT) as reply:
            page = reply.read().decode()
        assert 'veles_serve_gen_tokens_total{model="lm"} 15' in page
        assert 'veles_serve_gen_ttft_seconds_count{model="lm"} 3' in page
    finally:
        server.stop()


def test_streamed_503_carries_retry_after_over_http():
    registry = ModelRegistry()
    registry.deploy_generative("lm", _port_engine(), warmup=False,
                               scheduler_config={"max_queue": 0})
    server = ServingServer(registry=registry, port=0).start()
    try:
        status, headers, body = _post(server.port, "/generate/lm", json.dumps(
            {"tokens": [1, 2], "max_new_tokens": 4, "stream": True}).encode())
        assert status == 503
        assert headers["Retry-After"] == str(QueueFull.retry_after)
        assert json.loads(body)["retry_after"] == QueueFull.retry_after
    finally:
        server.stop()


# -- /metrics ---------------------------------------------------------------

def _gen_lines(metrics):
    """``{family: sorted label sets}`` of the ``gen_*`` gauges and the
    TTFT histogram in a metrics sink."""
    names = {}
    for key in metrics.snapshot():
        if key.startswith("gen_"):
            family, _, labels = key.partition("{")
            names.setdefault(family, set()).add(labels)
    text = metrics.render_text()
    names["ttft_histogram"] = {
        line.split("{")[1].split("}")[0] for line in text.splitlines()
        if line.startswith("veles_serve_gen_ttft_seconds_count")}
    return names


@pytest.mark.parametrize("kind", ["contiguous", "paged_prefix",
                                  "speculative"])
def test_scheduler_gauges_carry_the_jax_names_and_labels(kind):
    kind_kw = dict(ENGINE_KINDS[kind])
    sinks = {}
    for label, metrics, reg_cls, make in (
            ("port", ServingMetrics(), ModelRegistry, _port_engine),
            ("jax", JaxMetrics(), JaxRegistry, _jax_engine)):
        registry = reg_cls(metrics=metrics)
        registry.deploy_generative("lm", make(**kind_kw))
        try:
            tokens = registry.generate("lm", [1, 2, 3, 1, 2], 4)
            snap = metrics.snapshot()
            sinks[label] = (_gen_lines(metrics), tokens,
                            snap['gen_tokens_total{model="lm"}'],
                            snap['gen_admitted_total{model="lm"}'],
                            snap['gen_slot_occupancy{model="lm"}'])
        finally:
            registry.stop()
        # stop() drops every gauge it registered
        assert not any(k.startswith("gen_") for k in metrics.snapshot())
    assert sinks["port"] == sinks["jax"]
    assert sinks["port"][0]["gen_tokens_total"] == {'model="lm"}'}
