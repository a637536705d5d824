"""The port's SPMD trainers against the JAX package's, on the CPU, and
``spmd_launch``.

- A world of 8 gloo ranks (``tests/torch_ranks.py``, no JAX in a rank)
  runs, once a module: one TINY transformer step (f32, no remat) on data
  2 x seq 2 x model 2, the JAX test's mesh (ring-flash attention over
  seq, Megatron pairs over model): its loss within 1e-5 of the JAX mesh
  step's and every param within 1e-6, and both within the same bounds
  of the port's no-mesh step; a ce-chunked step on data 4 x model 2
  against the JAX mesh step; the MoE sample on expert 2 x data 2 (four
  of the ranks), three steps against JAX's within 1e-5.
- ``spmd_launch`` boots two local ranks through ``sh -c``, which train
  the fused MNIST sample with ``mesh_axes={"data": 2}``: every class
  close equal to the JAX trainer's over the same mesh and every weight
  within 1e-5; the same in epoch mode against the port's one-process
  epoch mode; and one fused DP step equal (within 1e-6) to the
  one-process step on the whole batch.
- ``process_double``, ``host_shard_range`` and ``from_host_local`` as
  ``tests/test_multihost.py`` holds the JAX ones.
- A rank imports no JAX and no ``veles_tpu`` module.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import torch_ranks
from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.parallel.mesh import make_mesh as jax_make_mesh
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu.samples import moe as jax_moe
from veles_tpu.samples import transformer as jax_transformer
from veles_tpu_torch import prng
from veles_tpu_torch.parallel import mesh, multihost
from veles_tpu_torch.parallel.multihost import MultiHostShardError

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

LOSS_TOL = 1e-5
PARAM_TOL = 1e-6
MOE_TOL = 1e-5
FUSED_TOL = 1e-5
WORLD = 8
FLEET_CASES = ("fused_mnist_dp", "fused_mnist_dp_epoch", "fused_dp_step",
               "imports")


def _dp_inputs():
    rng = numpy.random.default_rng(11)
    specs = [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9},
         "init": {"weights": (rng.standard_normal((12, 8)) * 0.3).astype(
             numpy.float32), "bias": numpy.zeros(8, numpy.float32)}},
        {"type": "softmax", "->": {"output_sample_shape": 3},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}]
    return {"dp_specs": specs,
            "dp_x": rng.standard_normal((16, 12)).astype(numpy.float32),
            "dp_y": (numpy.arange(16) % 3).astype(numpy.int32)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = jax_transformer.TINY
    inputs = {"tokens": jax_transformer.synthetic_tokens(cfg, 4, seed=1),
              "moe_tokens": jax_moe.synthetic_tokens(jax_moe.TINY, 4,
                                                     seed=2)}
    results = torch_ranks.run_world(
        WORLD, ("transformer", "transformer_chunked", "moe_sample",
                "imports"), inputs, tmp_path_factory.mktemp("world"))
    return inputs, results


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The two ranks ``spmd_launch`` boots through ``sh -c``."""
    tmp = tmp_path_factory.mktemp("fleet")
    inputs = _dp_inputs()
    import pickle
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=torch_ranks.REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.scripts.spmd_launch",
         "-n", "localhost:22x2", "--coordinator",
         "file://%s" % (tmp / "store"), "--launch-transform", "sh -c",
         "--", sys.executable, os.path.join(torch_ranks.REPO, "tests",
                                            "torch_ranks.py"),
         "--fleet", str(tmp), ",".join(FLEET_CASES)],
        cwd=torch_ranks.REPO, env=env, capture_output=True, text=True,
        timeout=torch_ranks.WORLD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return inputs, torch_ranks.load_results(str(tmp), 2), proc.stderr


def _flat(tree, prefix=""):
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _flat(leaf, prefix + key + "/")
        else:
            yield prefix + key, numpy.asarray(leaf)


def _assert_trees(got, want, tol):
    want = dict(_flat(want))
    got = dict(_flat(got))
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        err = float(numpy.abs(got[name] - value).max())
        assert err <= tol, (name, err)


def _jax_mesh_step(topology, **kwargs):
    cfg = dict(jax_transformer.TINY)
    params, vel, step = jax_transformer.build_train(
        cfg, mesh=jax_make_mesh(topology), compute_dtype=jnp.float32,
        remat=False, **kwargs)
    tokens = jax_transformer.synthetic_tokens(cfg, 4, seed=1)
    params, vel, metrics = step(params, vel, tokens)
    return float(metrics["loss"]), jax.tree.map(numpy.asarray, params)


@pytest.mark.parametrize("case,topology,kwargs", [
    ("transformer", {"data": 2, "seq": 2, "model": 2}, {}),
    ("transformer_chunked", {"data": 4, "seq": 1, "model": 2},
     {"ce_chunk": 4})],
    ids=["dp_sp_tp", "ce_chunked"])
def test_transformer_mesh_step_matches_jax(world, case, topology, kwargs):
    _inputs, results = world
    loss, params = _jax_mesh_step(topology, **kwargs)
    for rank in range(WORLD):
        got = results[rank][case]
        assert abs(got["loss"] - loss) <= LOSS_TOL
        _assert_trees(got["params"], params, PARAM_TOL)
    single = results[0][case]
    assert abs(single["single_loss"] - single["loss"]) <= LOSS_TOL
    _assert_trees(single["params"], single["single_params"], PARAM_TOL)


def test_moe_sample_on_expert_x_data_matches_jax(world):
    inputs, results = world
    params, vel, step = jax_moe.build_train(
        jax_moe.TINY, mesh=jax_make_mesh({"expert": 2, "data": 2}))
    losses = []
    for _ in range(3):
        params, vel, metrics = step(params, vel, inputs["moe_tokens"])
        losses.append(float(metrics["loss"]))
    for rank in range(4):
        got = results[rank]["moe_sample"]
        assert numpy.abs(numpy.array(got["losses"])
                         - losses).max() <= MOE_TOL
        _assert_trees(got["params"], jax.tree.map(numpy.asarray, params),
                      MOE_TOL)
    assert all(results[rank]["moe_sample"] is None
               for rank in range(4, WORLD))


def test_ranks_import_no_jax(world, fleet):
    for results in (world[1], fleet[1]):
        for rank in results:
            assert rank["imports"] == []


# -- spmd_launch: the fused trainer over a data mesh ---------------------------

def _jax_fused_run():
    jax_prng.seed_all(3)
    wf = jax_mnist.create_workflow(
        device=JaxCPUDevice(), max_epochs=2, native=True, fused=True,
        fused_config={"mesh_axes": {"data": 2}})
    dec, closes = wf.decision, []
    close = dec._close_class

    def recording(cls, check_epoch_end):
        closes.append((int(dec.epoch_number), int(cls),
                       float(dec.epoch_n_err[cls])))
        return close(cls, check_epoch_end)
    dec._close_class = recording
    wf.run()
    weights = []
    for fwd in wf.forwards:
        fwd.weights.map_read()
        fwd.bias.map_read()
        weights.append((numpy.array(fwd.weights.mem, numpy.float32),
                        numpy.array(fwd.bias.mem, numpy.float32)))
    return {"closes": closes, "weights": weights}


def _assert_runs(got, want, tol):
    assert got["closes"] == want["closes"]
    for (gw, gb), (ww, wb) in zip(got["weights"], want["weights"]):
        assert numpy.abs(gw - ww).max() <= tol
        assert numpy.abs(gb - wb).max() <= tol


def test_fused_mnist_data_mesh_matches_jax(fleet):
    want = _jax_fused_run()
    _inputs, results, _log = fleet
    assert len(want["closes"]) > 0
    for rank in results:
        _assert_runs(rank["fused_mnist_dp"], want, FUSED_TOL)


def _port_epoch_run():
    """The port's one-process epoch mode on the MNIST sample."""
    from veles_tpu_torch.samples import mnist
    prng.seed_all(3)
    wf = mnist.create_workflow(device="cpu", max_epochs=2, native=True,
                               fused=True, fused_config={"epoch_mode": True})
    closes = []
    dec, close = wf.decision, wf.decision._close_class

    def recording(cls, check_epoch_end):
        closes.append((int(dec.epoch_number), int(cls),
                       float(dec.epoch_n_err[cls])))
        return close(cls, check_epoch_end)
    dec._close_class = recording
    wf.run()
    return {"closes": closes, "weights": [
        (numpy.array(f.weights.mem, numpy.float32),
         numpy.array(f.bias.mem, numpy.float32)) for f in wf.forwards]}


def test_fused_mnist_data_mesh_epoch_mode_matches_one_process(fleet):
    """Epoch mode over the data mesh against the port's one-process
    epoch mode (the same permutation, each rank its columns)."""
    want = _port_epoch_run()
    for rank in fleet[1]:
        _assert_runs(rank["fused_mnist_dp_epoch"], want, FUSED_TOL)


def test_spmd_launch_two_ranks_step_equals_one_process(fleet):
    from veles_tpu_torch.znicz.fused_graph import (lower_specs, to_numpy,
                                                   to_tensors)
    inputs, results, log = fleet
    params, step_fn, _e, _a = lower_specs(
        [dict(s) for s in inputs["dp_specs"]], (12,))
    params, metrics = step_fn(to_tensors(params, "cpu"),
                              torch.tensor(inputs["dp_x"]),
                              torch.tensor(inputs["dp_y"]))
    want = to_numpy(params)
    for rank in results:
        got = rank["fused_dp_step"]
        for g_layer, w_layer in zip(got["state"], want):
            for key, value in w_layer.items():
                if value is not None:
                    assert numpy.abs(g_layer[key] - value).max() <= \
                        PARAM_TOL, key
        assert got["metrics"]["n_err"] == float(metrics["n_err"])
        assert abs(got["metrics"]["loss"] - float(metrics["loss"])) <= \
            PARAM_TOL
    assert "rank 0 on localhost" in log and "rank 1 on localhost" in log


# -- in one process: the process double ----------------------------------------

def test_host_shard_range_even_and_uneven():
    with multihost.process_double(3) as dbl:
        with pytest.raises(MultiHostShardError):
            multihost.host_shard_range(10)
        spans = []
        for rank in range(3):
            with dbl.rank(rank):
                spans.append(multihost.host_shard_range(
                    10, allow_uneven=True))
        assert spans == [(0, 3), (3, 6), (6, 10)]


def test_from_host_local_single_process_identity():
    assert not multihost.configured()
    m = mesh.make_mesh({"data": -1})
    local = numpy.arange(32, dtype=numpy.float32).reshape(16, 2)
    out = multihost.from_host_local(local, mesh.shard_batch(m))
    assert isinstance(out, torch.Tensor) and out.shape == (16, 2)
    numpy.testing.assert_array_equal(out.numpy(), local)


def test_from_host_local_typed_error_on_indivisible_axis():
    m = mesh.make_mesh({"data": -1}, world_size=8)
    local = numpy.zeros((4, 2), numpy.float32)
    with multihost.process_double(3):
        with pytest.raises(MultiHostShardError) as err:
            multihost.from_host_local(local, mesh.shard_batch(m),
                                      global_shape=(12, 2))
        assert issubclass(err.type, ValueError)


def test_process_double_banks_shards_incrementally():
    m = mesh.make_mesh({"data": -1}, world_size=8)
    full = numpy.arange(64, dtype=numpy.float32).reshape(16, 4)
    with multihost.process_double(2) as dbl:
        assert multihost.configured()
        assert multihost.process_count() == 2
        with dbl.rank(0):
            assert multihost.is_coordinator()
            got = multihost.from_host_local(
                full[:8], mesh.shard_batch(m), global_shape=(16, 4)).numpy()
            numpy.testing.assert_array_equal(got[:8], full[:8])
            assert not got[8:].any()
        with dbl.rank(1):
            assert not multihost.is_coordinator()
            out = multihost.from_host_local(
                full[8:], mesh.shard_batch(m), global_shape=(16, 4))
            numpy.testing.assert_array_equal(out.numpy(), full)
    assert not multihost.configured()


def test_process_double_does_not_nest_and_checks_rank():
    with multihost.process_double(2) as dbl:
        with pytest.raises(RuntimeError):
            with multihost.process_double(2):
                pass
        with pytest.raises(ValueError):
            with dbl.rank(2):
                pass
    with pytest.raises(ValueError):
        multihost.process_double(0)
