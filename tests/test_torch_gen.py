"""The port's generative serving path (``veles_tpu_torch.gen``) against the
JAX package's, on the CPU at TINY width.

The same numpy weights (one seed, both packages' ``init_params``) go
through both models: prefill and decode must give equal greedy tokens
and K/V caches within 1e-4, ``calibration_logits`` within 1e-4, and a
seeded continuous-batching session through engine and scheduler must
give the JAX session's token streams, each request exactly its budget.
On the CPU the attention wrappers take their plain versions, so no
kernel is launched here; the kernels are held against those plain
versions on the card (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.gen import GenerativeEngine as JaxEngine
from veles_tpu.gen import GenerativeScheduler as JaxScheduler
from veles_tpu.gen import TransformerGenModel as JaxModel
from veles_tpu.samples import transformer as jax_transformer
from veles_tpu_torch.gen import (GenerativeEngine, GenerativeScheduler,
                                 QueueFull, TransformerGenModel,
                                 params_from_numpy, static_generate)
from veles_tpu_torch.gen import __main__ as gen_main
from veles_tpu_torch.ops import attention
from veles_tpu_torch.samples import transformer as port_transformer
from veles_tpu_torch.samples.transformer import TINY

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

CFG = dict(TINY, seq_len=64)
TOL = 1e-4
CPU = "cpu"


def _leaves(tree, prefix=""):
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf, prefix + key + ".")
        else:
            yield prefix + key, leaf


def _close(got, want, tol=TOL):
    numpy.testing.assert_allclose(numpy.asarray(got), numpy.asarray(want),
                                  atol=tol, rtol=tol)


def mixed_workload(n=10, seed=0, max_prompt=16, max_new_hi=10):
    rng = numpy.random.default_rng(seed)
    return [(rng.integers(0, CFG["vocab"],
                          int(rng.integers(1, max_prompt))).tolist(),
             int(rng.integers(1, max_new_hi)))
            for _ in range(n)]


def port_engine(seed=0, max_slots=3, max_seq=48, buckets=(8, 16), **kw):
    return GenerativeEngine(
        TransformerGenModel(CFG, device=CPU), max_slots=max_slots,
        max_seq=max_seq, prefill_buckets=buckets, seed=seed, device=CPU,
        **kw)


def run_continuous(engine, workload, scheduler_cls):
    scheduler = scheduler_cls(engine)
    futures = [scheduler.submit(toks, max_new) for toks, max_new in workload]
    scheduler.run_until_idle()
    return [f.result(0) for f in futures], scheduler


# -- (c) parameters ---------------------------------------------------------

@pytest.mark.parametrize("cfg", [TINY, CFG], ids=["tiny", "tiny-seq64"])
@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_equal_jax_bitwise(cfg, seed):
    port = dict(_leaves(port_transformer.init_params(cfg, seed=seed)))
    ref = dict(_leaves(jax_transformer.init_params(cfg, seed=seed)))
    assert list(port) == list(ref)      # same tree, same draw order
    for name, leaf in ref.items():
        assert port[name].dtype == leaf.dtype, name
        assert numpy.array_equal(port[name], leaf), name


def test_params_from_numpy_round_trips():
    host = jax_transformer.init_params(CFG, seed=3)
    params = params_from_numpy(host, CPU)
    got = dict(_leaves(params))
    for name, leaf in _leaves(host):
        assert got[name].dtype == torch.float32
        assert got[name].device.type == "cpu"
        assert numpy.array_equal(got[name].numpy(), leaf), name
    half = params_from_numpy(host, CPU, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for _n, t in _leaves(half))


# -- (d) the model against the JAX model on the same weights ---------------

def _models(seed=0):
    host = jax_transformer.init_params(CFG, seed=seed)
    jm, pm = JaxModel(CFG), TransformerGenModel(CFG, device=CPU)
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else jnp.asarray(v))
          for k, v in host.items()}
    return jm, jp, pm, params_from_numpy(host, CPU)


def _padded(prompt, bucket):
    out = numpy.zeros((1, bucket), numpy.int32)
    out[0, :len(prompt)] = prompt
    return out


def test_prefill_matches_jax():
    jm, jp, pm, pp = _models()
    rng = numpy.random.default_rng(1)
    jcache, pcache = jm.init_cache(3, 32), pm.init_cache(3, 32)
    for slot, n in ((1, 11), (0, 16), (2, 3)):
        prompt = rng.integers(0, CFG["vocab"], n)
        padded = _padded(prompt, 16)
        jcache, jtok = jm.prefill(jp, jcache, jnp.asarray(padded), slot, n)
        pcache2, ptok = pm.prefill(pp, pcache, torch.from_numpy(
            padded.astype(numpy.int64)), slot, n)
        assert pcache2 is pcache        # updated in place
        assert int(ptok) == int(jtok)
    for key in ("k", "v"):
        _close(pcache[key], jcache[key])


def test_decode_matches_jax():
    jm, jp, pm, pp = _models(seed=2)
    rng = numpy.random.default_rng(2)
    jcache, pcache = jm.init_cache(3, 32), pm.init_cache(3, 32)
    lens = [5, 9]
    toks = []
    for slot, n in enumerate(lens):
        padded = _padded(rng.integers(0, CFG["vocab"], n), 16)
        jcache, jtok = jm.prefill(jp, jcache, jnp.asarray(padded), slot, n)
        pm.prefill(pp, pcache, torch.from_numpy(padded.astype(numpy.int64)),
                   slot, n)
        toks.append(int(jtok))
    # slot 2 is idle: it rides along at position 0 and writes nothing
    tokens = numpy.asarray(toks + [0], numpy.int32)
    positions = numpy.asarray(lens + [0], numpy.int32)
    active = numpy.asarray([True, True, False])
    for _step in range(4):
        jcache, jout = jm.decode(jp, jcache, jnp.asarray(tokens),
                                 jnp.asarray(positions), jnp.asarray(active))
        _c, pout = pm.decode(pp, pcache, torch.from_numpy(tokens).long(),
                             torch.from_numpy(positions).long(),
                             torch.from_numpy(active))
        assert pout.tolist()[:2] == numpy.asarray(jout).tolist()[:2]
        tokens = numpy.where(active, numpy.asarray(jout), 0).astype(
            numpy.int32)
        positions = positions + active
    for key in ("k", "v"):
        _close(pcache[key], jcache[key])
    assert not pcache["k"][:, 2].any()


@pytest.mark.parametrize("n", [1, 13, 40])
def test_calibration_logits_match_jax(n):
    jm, jp, pm, pp = _models(seed=4)
    prompt = numpy.random.default_rng(n).integers(0, CFG["vocab"], n)
    want = jm.calibration_logits(jp, prompt)
    got = pm.calibration_logits(pp, prompt.tolist())
    assert got.dtype == torch.float32 and got.shape == (CFG["vocab"],)
    _close(got, want)
    assert int(torch.argmax(got)) == int(jnp.argmax(want))


# -- (e), (f) the serving session ------------------------------------------

def test_continuous_session_matches_jax():
    workload = mixed_workload(10)
    engine = port_engine().warmup()
    got, sched = run_continuous(engine, workload, GenerativeScheduler)
    engine.close()
    assert sched.batch_fill() > 0.5      # the lengths really overlapped
    jengine = JaxEngine(JaxModel(CFG), max_slots=3, max_seq=48,
                        prefill_buckets=(8, 16), seed=0)
    want, _ = run_continuous(jengine.warmup(), workload, JaxScheduler)
    jengine.close()
    assert got == want
    assert [len(s) for s in got] == [m for _t, m in workload]


def test_continuous_matches_static_generate():
    workload = mixed_workload(9, seed=5)
    engine = port_engine()
    continuous, _ = run_continuous(engine, workload, GenerativeScheduler)
    engine.close()
    engine = port_engine()
    static, steps = static_generate(engine, workload)
    engine.close()
    assert continuous == static
    assert steps > 0
    assert [len(s) for s in static] == [m for _t, m in workload]


def test_worker_mode_streams_every_token():
    workload = mixed_workload(6, seed=9)
    engine = port_engine()
    scheduler = GenerativeScheduler(engine, name="t").start()
    streamed = [[] for _ in workload]
    try:
        futures = [scheduler.submit(toks, max_new, on_token=streamed[i].append)
                   for i, (toks, max_new) in enumerate(workload)]
        results = [f.result(timeout=60) for f in futures]
        assert scheduler.generate(workload[0][0], workload[0][1]) \
            == results[0]
    finally:
        scheduler.stop()
    engine.close()
    assert streamed == results
    assert [len(r) for r in results] == [m for _t, m in workload]
    info = scheduler.describe()
    assert info["finished_total"] == len(workload) + 1
    assert info["queue_depth"] == info["active_requests"] == 0


def test_scheduler_door_checks():
    engine = port_engine(max_slots=1)
    scheduler = GenerativeScheduler(engine, max_queue=2)
    with pytest.raises(ValueError):
        scheduler.submit([], 4)
    with pytest.raises(ValueError):
        scheduler.submit([1] * 40, 16)       # past the 48-token KV slot
    with pytest.raises(ValueError):
        scheduler.submit([1] * 17, 2)        # past the largest bucket
    scheduler.submit([1, 2], 2)
    scheduler.submit([3], 2)
    with pytest.raises(QueueFull):
        scheduler.submit([4], 2)
    assert scheduler.describe()["shed_total"] == 1
    assert scheduler.run_until_idle() > 0
    engine.close()


# -- the engine --------------------------------------------------------------

def test_engine_bookkeeping_and_launch_free_cpu_path():
    attention.reset_launches()
    engine = port_engine(buckets=None)
    assert engine.prefill_buckets == (8, 16, 32, 48)
    slot, tok = engine.prefill([5, 6, 7])
    assert slot == 0 and 0 <= tok < CFG["vocab"]
    assert engine.active_slots() == 1 and engine.free_slots == 2
    out, active = engine.decode_step()
    assert active.tolist() == [True, False, False]
    assert engine.slot_len[0] == 4 and engine.slot_token[0] == out[0]
    info = engine.describe()
    assert info["kv"] == "contiguous" and info["device"] == "cpu"
    assert info["prefill_calls"] == 1 and info["decode_calls"] == 1
    assert info["kv_cache_bytes"] == 2 * 2 * 3 * 48 * 32 * 4
    engine.release_slot(slot)
    assert engine.decode_step() is None
    with pytest.raises(ValueError):
        engine.release_slot(slot)
    engine.close()
    engine.close()                           # idempotent
    assert not any(attention.launches.values())


def test_engine_holds_kv_and_params_in_the_hbm_ledger():
    from veles_tpu_torch.memory import Watcher

    def held(category):
        entry = Watcher.hbm_ledger()["by_category"].get(category, {})
        return entry.get("bytes", 0)

    kv0, params0 = held("kv"), held("params")
    engine = port_engine()
    assert held("kv") - kv0 == engine.kv_cache_bytes > 0
    assert held("params") - params0 == engine.params_nbytes > 0
    engine.close()
    assert (held("kv"), held("params")) == (kv0, params0)
    # a hold taken before reset() is released as a no-op
    engine = port_engine()
    Watcher.reset()
    engine.close()
    assert Watcher.hbm_ledger()["bytes_in_use"] == 0


def _int8_params():
    params = port_transformer.init_params(CFG, seed=0)
    wqkv = params["blocks"]["wqkv"]
    params["blocks"]["wqkv"] = {"q": wqkv.astype(numpy.int8),
                                "scale": numpy.ones(wqkv.shape[-1])}
    return params


def _layout_mesh(axes):
    from veles_tpu_torch.parallel.mesh import Mesh
    return Mesh(axes, world_size=2)


@pytest.mark.parametrize("option", [
    # int8 params are served (tests/test_torch_quant.py), but not over a
    # tensor-parallel mesh: a ValueError, as in the JAX package
    lambda: port_engine(params=_int8_params(),
                        mesh=_layout_mesh({"model": 2})),
    lambda: GenerativeScheduler(port_engine()).drain(),
    lambda: port_engine(kv="paged", block_size=8).warm_handoff(),
    lambda: port_engine(kv="paged", block_size=8).export_slot(0),
    # the mesh is ported (tests/test_torch_tp_serve.py): one without a
    # model axis is the single-device path
    lambda: port_engine(mesh=_layout_mesh({"data": 2}))],
    ids=["int8", "drain", "warm_handoff", "export_slot", "mesh"])
def test_unported_engine_options_raise(option, request):
    """The fleet options (the drain, the page handoff) raise naming
    their ROADMAP item, 7(e); the two mesh cases were refusals of item
    7(d) and now take the JAX engine's paths."""
    case = request.node.callspec.id
    if case == "int8":
        with pytest.raises(ValueError, match="int8"):
            option()
    elif case == "mesh":
        engine = option()
        assert engine.mesh is None
        assert engine.describe()["sharded"] is False
    else:
        with pytest.raises(NotImplementedError, match=r"ROADMAP.*7\(e\)"):
            option()


def test_gen_smoke_entry_point_on_cpu(capsys):
    assert gen_main.main(["--smoke", "--device", "cpu", "--requests",
                          "6"]) == 0
    out = capsys.readouterr().out
    assert "gen smoke[cpu]: 6 requests" in out
    paged = [ln for ln in out.splitlines()
             if ln.startswith("gen smoke[cpu, paged]: 6 requests")]
    assert len(paged) == 1 and "contiguous == paged" in paged[0]
    assert " 0 preemption" not in paged[0]
    # phases 3 and 4 of the JAX smoke: int8 against its float twin (params
    # at most 0.35x), prefix + speculation against plain paged
    int8 = [ln for ln in out.splitlines()
            if ln.startswith("gen smoke[cpu, int8]: 6 requests")]
    assert len(int8) == 1
    assert float(int8[0].split("params ")[1].split("x float")[0]) <= 0.35
    spec = [ln for ln in out.splitlines()
            if ln.startswith("gen smoke[cpu, prefix+spec]:")]
    assert len(spec) == 1 and "plain == prefix+spec" in spec[0]
    assert "FAIL" not in out
