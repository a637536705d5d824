"""The port's SPMD library (``veles_tpu_torch.parallel``) against the
JAX package's on the CPU.

Each multi-rank case runs once a module in a world of 8 gloo ranks
(``tests/torch_ranks.py``: a process a rank, none importing JAX) on the
same numpy inputs the JAX functions get here on the suite's virtual
8-device mesh, with the same mesh shapes: ring attention (flash and
the dense oracle) and Ulysses on data 2 x seq 4, causal and not, the
output and the gradients of q, k and v; ``pipeline_apply`` on pipe 4 x
data 2, the output and the gradients of the stacked params and of x;
``moe_mlp`` on data 2 x model 4 at capacity factor 1 (tokens dropped)
against JAX ``moe_mlp``, and at the drop-free factor 8 against
``moe_reference``, output and every gradient; two ``data_parallel``
steps on data 8 and one ``data_parallel_epoch_local`` epoch against the
JAX functions (the epoch's permutation reproduced with the port's
threefry).  Every comparison holds within 1e-5.  In one process:
``mesh_from_topology`` and its errors, the four rule functions' specs,
and the errors of Ulysses and the pipeline.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks
from veles_tpu.parallel import dp as jax_dp
from veles_tpu.parallel import mesh as jax_mesh
from veles_tpu.parallel import moe as jax_moe
from veles_tpu.parallel import pp as jax_pp
from veles_tpu.parallel import ring as jax_ring
from veles_tpu_torch.parallel import dp, mesh, pp, ring

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

TOL = 1e-5
WORLD = 8
CASES = ("ring_flash", "ring_oracle", "ulysses", "pipeline", "moe",
         "data_parallel", "data_parallel_epoch_local")


def _inputs():
    rng = numpy.random.default_rng(7)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(numpy.float32)
    x = normal(16, 12)
    labels = (numpy.arange(16) % 3).astype(numpy.int32)
    specs = [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9},
         "init": {"weights": normal(12, 8, scale=0.3),
                  "bias": normal(8, scale=0.1)}},
        {"type": "softmax", "->": {"output_sample_shape": 3},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9},
         "init": {"weights": normal(8, 3, scale=0.3),
                  "bias": normal(3, scale=0.1)}}]
    return {
        "q": normal(4, 32, 8, 16), "k": normal(4, 32, 8, 16),
        "v": normal(4, 32, 8, 16), "cot": normal(4, 32, 8, 16),
        "stages": {"w": normal(4, 16, 16, scale=0.3),
                   "b": normal(4, 16, scale=0.1)},
        "x": normal(8, 16), "cot_x": normal(8, 16),
        "moe": {"router": normal(8, 8), "w1": normal(8, 8, 16, scale=0.3),
                "b1": normal(8, 16, scale=0.1),
                "w2": normal(8, 16, 8, scale=0.3),
                "b2": normal(8, 8, scale=0.1)},
        "moe_x": normal(4, 16, 8), "moe_cot": normal(4, 16, 8),
        "dp_specs": specs, "dp_x": x, "dp_y": labels,
        "epoch_x": normal(64, 12),
        "epoch_y": (numpy.arange(64) % 3).astype(numpy.int32),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's results from the 8 ranks, and the inputs."""
    inputs = _inputs()
    results = torch_ranks.run_world(WORLD, CASES, inputs,
                                    tmp_path_factory.mktemp("world"))
    return inputs, results


def _close(got, want, tol=TOL):
    numpy.testing.assert_allclose(numpy.asarray(got), numpy.asarray(want),
                                  atol=tol, rtol=0)


# -- in one process ------------------------------------------------------------

_TOPOLOGIES = [None, "auto", 4, "8", "2x4", "4x-1", "data=2,pipeline=4",
               "pp=2,ep=2,tp=2", {"data": 2, "seq": -1}, {"tp": 8},
               "data=2", "data=4,model=1"]


@pytest.mark.parametrize("topology", _TOPOLOGIES, ids=str)
def test_mesh_from_topology_lays_out_the_jax_mesh(topology):
    want = jax_mesh.mesh_from_topology(topology, require=("data",))
    got = mesh.mesh_from_topology(topology, world_size=8,
                                  require=("data",))
    assert got.shape == dict(want.shape)
    assert list(got.shape) == list(want.axis_names)
    one = mesh.mesh_from_topology(topology, world_size=1)
    assert set(one.shape.values()) == {1}


@pytest.mark.parametrize("topology", [
    "data=3", "2x5", {"data": -1, "model": -1}, "data=0", "data=x",
    "1x2x4", "nonsense", {"data": 3, "seq": -1}])
def test_mesh_topology_errors_are_the_jax_errors(topology):
    with pytest.raises(jax_mesh.MeshTopologyError) as want:
        jax_mesh.mesh_from_topology(topology)
    with pytest.raises(mesh.MeshTopologyError) as got:
        mesh.mesh_from_topology(topology, world_size=8)
    assert str(got.value) == str(want.value)
    assert issubclass(mesh.MeshTopologyError, ValueError)


_SHAPES = [(8,), (4096,), (64, 32), (32, 64), (2, 512), (3, 1024),
           (8, 16, 32), (6, 2, 2)]


@pytest.mark.parametrize("rule", ["tp", "fsdp", "pp", "ep"])
def test_rule_specs_are_the_jax_specs(rule):
    axes = {"tp": {"data": 2, "model": 4}, "fsdp": {"data": 8},
            "pp": {"pipe": 2, "data": 4}, "ep": {"expert": 4, "data": 2}}
    jax_rules = getattr(jax_dp, rule + "_rules")(
        jax_mesh.make_mesh(axes[rule]), min_elements=64)
    port_rules = getattr(dp, rule + "_rules")(
        mesh.make_mesh(axes[rule], world_size=8), min_elements=64)
    for shape in _SHAPES:
        leaf = numpy.zeros(shape, numpy.float32)
        want = jax_rules(leaf)
        got = port_rules(leaf)
        assert got == (None if want is None else tuple(want)), shape
        if got is not None:
            sub = mesh.shard(leaf, got, mesh.make_mesh(axes[rule],
                                                       world_size=8))
            assert sub.shape[got.index(next(a for a in got if a))] * \
                axes[rule][next(a for a in got if a)] == \
                shape[got.index(next(a for a in got if a))]


def test_sharding_helpers_give_the_jax_specs():
    """``shard_batch``, ``shard_model``, ``replicated``, the TP specs and
    ``sharding_tree`` give the JAX package's specs; ``constrain`` checks
    a local shape against its spec (the port's stand-in for the GSPMD
    hint) and ``shard`` / the layout agree with it."""
    from veles_tpu.parallel import tp as jax_tp
    from veles_tpu_torch.parallel import tp
    jm = jax_mesh.make_mesh({"data": 2, "model": 4})
    pm = mesh.make_mesh({"data": 2, "model": 4}, world_size=8)
    assert mesh.shard_batch(pm, ndim=3).spec == tuple(
        jax_mesh.shard_batch(jm, ndim=3).spec)
    assert mesh.shard_model(pm, 1, ndim=3).spec == tuple(
        jax_mesh.shard_model(jm, 1, ndim=3).spec)
    assert mesh.replicated(pm).spec == tuple(jax_mesh.replicated(jm).spec)
    for ndim in (2, 3, 5):
        assert tp.column_parallel(ndim) == tuple(jax_tp.column_parallel(ndim))
        assert tp.row_parallel(ndim) == tuple(jax_tp.row_parallel(ndim))
        assert tp.shard_dim(ndim, 1) == tuple(jax_tp.shard_dim(ndim, 1))
    params = {"a": numpy.zeros((8, 4)), "b": {"c": numpy.zeros(8)}}

    def rule(path, leaf):
        return P(None, "model") if path == "a" else None
    want = jax_tp.sharding_tree(params, jm, rule)
    got = tp.sharding_tree(params, pm, lambda path, leaf: (
        None if rule(path, leaf) is None else tuple(rule(path, leaf))))
    assert got["a"].spec == tuple(want["a"].spec)
    assert got["b"]["c"].spec == tuple(want["b"]["c"].spec) == ()
    local = mesh.shard(numpy.zeros((8, 16)), ("data", "model"), pm)
    assert local.shape == (4, 4)
    x = torch.zeros(local.shape)
    assert tp.constrain(x, pm, "data", "model", global_shape=(8, 16)) is x
    with pytest.raises(ValueError, match="locally"):
        tp.constrain(x, pm, "data", None, global_shape=(8, 16))
    with pytest.raises(ValueError, match="no axis"):
        tp.constrain(x, pm, "seq")
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard(numpy.zeros((6, 4)), ("model", None), pm)


def test_ulysses_and_pipeline_errors_are_the_jax_errors():
    q = torch.zeros((1, 4, 6, 2))
    seq4 = mesh.Mesh({"seq": 4}, world_size=4)
    with pytest.raises(ValueError, match="divisible by seq axis"):
        ring.ulysses_attention(q, q, q, seq4)
    pipe4 = mesh.Mesh({"pipe": 4}, world_size=4)
    params = {"w": torch.zeros((1, 16, 16))}
    with pytest.raises(ValueError, match="not divisible by n_micro"):
        pp.pipeline_apply(lambda p, h: h, params, torch.zeros((7, 16)),
                          pipe4, n_micro=4)
    with pytest.raises(ValueError, match="pipeline stages"):
        pp.pipeline_apply(lambda p, h: h, {"w": torch.zeros((2, 16))},
                          torch.zeros((8, 16)), pipe4, n_micro=4)
    jax_pipe = jax_mesh.make_mesh({"pipe": 4})
    with pytest.raises(ValueError, match="not divisible by n_micro"):
        jax_pp.pipeline_apply(lambda p, h: h, {"w": numpy.zeros((4, 16))},
                              numpy.zeros((7, 16), "float32"), jax_pipe,
                              n_micro=4)


# -- the 8-rank world ----------------------------------------------------------

def _jax_attention(fn, inputs, causal, **kwargs):
    m = jax_mesh.make_mesh({"data": 2, "seq": 4})
    q, k, v, cot = (jnp.asarray(inputs[n]) for n in ("q", "k", "v", "cot"))

    def loss(q, k, v):
        out = fn(q, k, v, m, causal=causal, **kwargs)
        return (out * cot).sum(), out
    (_l, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [out] + list(grads)


@pytest.mark.parametrize("case,kwargs", [
    ("ring_flash", {}), ("ring_oracle", {"use_flash": False}),
    ("ulysses", None)])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_jax(world, case, kwargs,
                                                 causal):
    inputs, results = world
    fn = jax_ring.ulysses_attention if kwargs is None \
        else jax_ring.ring_attention
    want = _jax_attention(fn, inputs, causal, **(kwargs or {}))
    for rank in range(WORLD):
        got = results[rank][case][causal]
        for g, w in zip(got, want):
            _close(g, w)
    dense = jax_ring.mha_reference(inputs["q"], inputs["k"], inputs["v"],
                                   causal=causal)
    _close(results[0][case][causal][0], dense)


def test_pipeline_matches_jax(world):
    inputs, results = world
    m = jax_mesh.make_mesh({"pipe": 4, "data": 2})
    stages = {k: jnp.asarray(v) for k, v in inputs["stages"].items()}

    def loss(params, x):
        out = jax_pp.pipeline_apply(
            lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), params, x, m,
            n_micro=2, batch_axis="data")
        return (out * inputs["cot_x"]).sum(), out
    (_l, out), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stages,
                                             jnp.asarray(inputs["x"]))
    got = results[3]["pipeline"]
    _close(got["out"], out)
    _close(got["w"], g_params["w"])
    _close(got["b"], g_params["b"])
    _close(got["x"], g_x)


@pytest.mark.parametrize("factor", [1.0, 8.0])
def test_moe_matches_jax(world, factor):
    inputs, results = world
    m = jax_mesh.make_mesh({"data": 2, "model": 4})
    params = {k: jnp.asarray(v) for k, v in inputs["moe"].items()}
    x, cot = jnp.asarray(inputs["moe_x"]), inputs["moe_cot"]

    def loss(params, x):
        if factor == 1.0:
            y = jax_moe.moe_mlp(x, params, m, capacity_factor=factor)
        else:
            y = jax_moe.moe_reference(x, params)
        return (y * cot).sum(), y
    (_l, y), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    got = results[5]["moe"][factor]
    _close(got["y"], y)
    _close(got["x"], g_x)
    for name, g in g_params.items():
        _close(got[name], g)
    if factor == 1.0:
        # capacity 1 a device's expert: tokens were dropped
        assert (numpy.abs(got["y"]).sum(-1) == 0).any()


def _jax_lowering(inputs, reduce_axis=None):
    from veles_tpu.znicz.fused_graph import lower_specs
    specs = [dict(s) for s in inputs["dp_specs"]]
    params, step_fn, _e, _a = lower_specs(
        specs, (inputs["dp_x"].shape[1],), grad_reduce_axis=reduce_axis)
    return params, step_fn


def _close_states(got, want):
    for g_layer, w_layer in zip(got, want):
        for key, value in w_layer.items():
            if value is None or key == "tick":
                continue
            _close(g_layer[key], value)


def test_data_parallel_matches_jax(world):
    inputs, results = world
    params, step_fn = _jax_lowering(inputs)
    step = jax_dp.data_parallel(step_fn, jax_mesh.make_mesh({"data": 8}),
                                params, donate_params=False)
    metrics = []
    for _ in range(2):
        params, m = step(params, inputs["dp_x"], inputs["dp_y"])
        metrics.append({k: float(v) for k, v in m.items()})
    for rank in (0, WORLD - 1):
        got = results[rank]["data_parallel"]
        _close_states(got["state"], params)
        for g, w in zip(got["metrics"], metrics):
            assert g["n_err"] == w["n_err"]
            assert abs(g["loss"] - w["loss"]) <= TOL


def test_data_parallel_epoch_local_matches_jax(world):
    inputs, results = world
    params, step_fn = _jax_lowering(inputs, reduce_axis="data")
    epoch = jax_dp.data_parallel_epoch_local(
        step_fn, jax_mesh.make_mesh({"data": 8}), 8, 4)
    params, stacked = epoch(params, inputs["epoch_x"], inputs["epoch_y"],
                            jax.random.key(5))
    for rank in (0, WORLD - 1):
        got = results[rank]["data_parallel_epoch_local"]
        _close_states(got["state"], params)
        numpy.testing.assert_array_equal(got["metrics"]["n_err"],
                                         numpy.asarray(stacked["n_err"]))
        _close(got["metrics"]["loss"], stacked["loss"])
