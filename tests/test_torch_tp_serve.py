"""The tensor-parallel generative engine against the JAX package's, on
the CPU: a world of 2 gloo ranks (``tests/torch_ranks.py``) serves the
TINY model (seq 64) over ``make_mesh({"model": 2})``, each rank a model
shard (its heads of ``wqkv``, ``wo`` and the KV cache or block pool,
its half of ``w1`` / ``b1`` / ``w2``; the ``wo`` and ``w2`` partials
all-reduced).

- ``test_gen.py:86``: a seeded mixed workload (6 requests, seed 3) at 2
  slots, continuous and sequential, contiguous and paged: every stream
  equal to the JAX engine's over ``make_mesh({"model": 2})`` and to the
  JAX single-device engine's, on both ranks;
- the sharded layout: ``describe()["sharded"]``, the heads of the cache
  on a rank, the all-reduces (two a layer a step);
- a 2-layer f32 prefill's logits within 1e-5 relative of the JAX
  single-device model's (the partials reorder the row-parallel sums);
- ``test_gen.py:105``: a mesh without a model axis (and one whose model
  axis is 1) is the single-device path; an axis that does not divide
  the heads and int8 params over a mesh raise ``ValueError``.
"""

import numpy
import pytest
import torch

import torch_ranks
from veles_tpu.gen import GenerativeEngine as JaxEngine
from veles_tpu.gen import GenerativeScheduler as JaxScheduler
from veles_tpu.gen import TransformerGenModel as JaxModel
from veles_tpu.parallel.mesh import make_mesh as jax_make_mesh
from veles_tpu_torch.gen import GenerativeEngine, TransformerGenModel
from veles_tpu_torch.parallel.mesh import Mesh
from veles_tpu_torch.samples.transformer import TINY

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

CFG = dict(TINY, seq_len=64)
WORLD = 2
#: the logits' relative tolerance (f32, the row-parallel sums reordered)
LOGIT_RTOL = 1e-5


def _workload(n=6, seed=3, max_prompt=16, max_new_hi=7):
    rng = numpy.random.default_rng(seed)
    return [(rng.integers(0, CFG["vocab"],
                          int(rng.integers(1, max_prompt))).tolist(),
             int(rng.integers(1, max_new_hi))) for _ in range(n)]


WORKLOAD = _workload()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_ranks.run_world(
        WORLD, ("gen_tp",), {"gen_cfg": CFG, "gen_workload": WORKLOAD},
        tmp_path_factory.mktemp("gen_tp"))


def _jax_streams(mesh=None, sequential=False, **options):
    engine = JaxEngine(JaxModel(CFG), max_slots=2, max_seq=48,
                       prefill_buckets=(8, 16), seed=0, mesh=mesh,
                       **options).warmup()
    scheduler = JaxScheduler(engine)
    out = []
    if sequential:
        for toks, max_new in WORKLOAD:
            future = scheduler.submit(toks, max_new)
            scheduler.run_until_idle()
            out.append(future.result(0))
    else:
        futures = [scheduler.submit(t, m) for t, m in WORKLOAD]
        scheduler.run_until_idle()
        out = [f.result(0) for f in futures]
    sharded = engine.describe().get("sharded")
    engine.close()
    return out, sharded


@pytest.fixture(scope="module")
def jax_streams():
    out = {}
    for kv in ("contiguous", "paged"):
        options = {"kv": kv, "block_size": 8} if kv == "paged" else {}
        for mode in ("continuous", "sequential"):
            single, _ = _jax_streams(sequential=mode == "sequential",
                                     **options)
            tp, sharded = _jax_streams(mesh=jax_make_mesh({"model": 2}),
                                       sequential=mode == "sequential",
                                       **options)
            assert sharded
            out[kv, mode] = {"single": single, "tp": tp}
    return out


@pytest.mark.parametrize("mode", ["continuous", "sequential"])
@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_tp_streams_equal_jax(world, jax_streams, kv, mode):
    want = jax_streams[kv, mode]
    assert want["tp"] == want["single"]
    for rank in world:
        got = rank["gen_tp"][kv][mode]
        assert got == want["tp"]
        assert [len(s) for s in got] == [m for _, m in WORKLOAD]


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_tp_layout(world, kv):
    for rank in world:
        got = rank["gen_tp"][kv]
        assert got["describe"]["sharded"] is True
        assert got["describe"]["mesh"] == {"model": WORLD}
        assert got["describe"]["local_heads"] == CFG["heads"] // WORLD
        assert got["cache_heads"] == CFG["heads"] // WORLD
        # two all-reduces a layer for every step the engine ran
        assert got["continuous_all_reduce"] > 0
        assert got["continuous_all_reduce"] % (2 * CFG["layers"]) == 0


def test_tp_logits_match_single_device(world):
    from veles_tpu.samples import transformer as jax_transformer
    small = dict(CFG, layers=2)
    model = JaxModel(small)
    params = jax_transformer.init_params(small, seed=1)
    tokens = numpy.asarray([WORKLOAD[0][0]], numpy.int32)
    want = numpy.asarray(model.calibration_logits(params, tokens[0]))
    for rank in world:
        got = rank["gen_tp"]["logits"]
        assert rank["gen_tp"]["local_heads"] == CFG["heads"] // WORLD
        numpy.testing.assert_allclose(got, want, rtol=LOGIT_RTOL,
                                      atol=LOGIT_RTOL * float(
                                          numpy.abs(want).max()))


@pytest.mark.parametrize("axes", [{"data": 2}, {"model": 1, "data": 2}])
def test_mesh_without_a_model_axis_is_single_device(axes):
    engine = GenerativeEngine(TransformerGenModel(CFG, device="cpu"),
                              max_slots=2, max_seq=48, seed=0, device="cpu",
                              mesh=Mesh(axes, world_size=2))
    assert engine.mesh is None
    assert not engine.describe()["sharded"]
    engine.close()


def test_heads_not_divisible_raise():
    with pytest.raises(ValueError, match="does not divide"):
        GenerativeEngine(TransformerGenModel(CFG, device="cpu"),
                         max_slots=2, max_seq=48, device="cpu",
                         mesh=Mesh({"model": 3}, world_size=3))


def test_int8_with_a_mesh_raises():
    from veles_tpu_torch.samples import transformer as port_transformer
    params = port_transformer.init_params(CFG, seed=0)
    wqkv = params["blocks"]["wqkv"]
    params["blocks"]["wqkv"] = {"q": wqkv.astype(numpy.int8),
                                "scale": numpy.ones(wqkv.shape[-1])}
    with pytest.raises(ValueError, match="int8"):
        GenerativeEngine(TransformerGenModel(CFG, device="cpu"),
                         params=params, max_slots=2, max_seq=48,
                         device="cpu", mesh=Mesh({"model": 2},
                                                 world_size=2))


def test_specs_are_the_jax_models():
    """``param_specs`` / ``cache_spec`` / ``paged_cache_spec`` name the
    dims the JAX model's do (``gen/model.py:126-170``), and
    ``shard_params`` cuts the slices those specs describe."""
    jax_model = JaxModel(CFG)
    model = TransformerGenModel(CFG, device="cpu")

    def tuples(tree):
        return {k: tuples(v) if isinstance(v, dict)
                else tuple(v) for k, v in tree.items()}

    def trim(spec):
        # P(None, "model") and P(None, "model", None) shard the same dim
        spec = list(spec)
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    def trimmed(tree):
        return {k: trimmed(v) if isinstance(v, dict) else trim(v)
                for k, v in tree.items()}
    assert trimmed(model.param_specs()) == trimmed(tuples(
        jax_model.param_specs()))
    for name in ("cache_spec", "paged_cache_spec"):
        assert trimmed(getattr(model, name)()) == trimmed(tuples(
            getattr(jax_model, name)()))
    full = model.init_params(seed=0)
    part = model.shard(1, 2, None)
    sliced = part.shard_params(full)["blocks"]
    specs = model.param_specs()["blocks"]
    for key, leaf in full["blocks"].items():
        spec = specs[key]
        if not any(spec):
            assert sliced[key] is leaf
            continue
        dim = spec.index("model")
        half = leaf.shape[dim] // 2
        want = numpy.take(leaf, range(half, 2 * half), axis=dim)
        numpy.testing.assert_array_equal(sliced[key], want)
    assert part.heads == CFG["heads"] // 2
    assert part.cache_shape(2, 48)[3] == CFG["heads"] // 2
