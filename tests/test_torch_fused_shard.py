"""The fused trainer's ``fsdp`` and ``tp`` against the JAX trainer's, on
the CPU, in a world of 4 gloo ranks (``tests/torch_ranks.py``).

- The MNIST sample (native, seed 3, two epochs, minibatch 100) through
  ``fused_config`` ``{"mesh_axes": {"data": -1}, "fsdp": True}`` (data
  4: the first layer's 784x100 weight and its momentum stored 196 rows a
  rank), ``{"mesh_axes": {"data": 2, "model": 2}, "tp": True}`` (the
  first layer's neurons 50 a rank, column-parallel) and both merged
  (``("data", "model")``): every class close equal to the JAX trainer's
  over the same mesh and options (``test_fused_parallel.py:678``), every
  weight and bias within 1e-5 (the fused trainer's contract), on every rank;
  the specs those of the JAX test.
- Epoch mode with ``fsdp`` over data 4 (``test_fused_parallel.py:1004``,
  whose JAX permutation the port cannot draw): equal to the port's
  one-process epoch mode within 1e-5, closes equal.
- The lowered step itself (``test_fused_parallel.py:137`` and
  ``:175``): three steps with ``fsdp_rules`` at 64 elements over data 4,
  and with the 2-d weights' last dim over model 2 on data 2 x model 2,
  each within 1e-5 of the port's one-process step on the whole batch,
  ``n_err`` equal.
- A topology change (``test_fused_parallel.py:201``): params placed over
  data 4, gathered, and placed over data 2 are the same bytes.
"""

import numpy
import pytest
import torch

import torch_ranks
from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu_torch import prng

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

WORLD = 4
#: the fused trainer's contract: leaf for leaf within 1e-5
FUSED_TOL = 1e-5
CONFIGS = {
    "fused_fsdp": {"mesh_axes": {"data": 4}, "fsdp": True},
    "fused_tp": {"mesh_axes": {"data": 2, "model": 2}, "tp": True},
    "fused_tp_fsdp": {"mesh_axes": {"data": 2, "model": 2}, "tp": True,
                      "fsdp": True},
}
SPECS = {"fused_fsdp": ["data", None], "fused_tp": [None, "model"],
         "fused_tp_fsdp": ["data", "model"]}


def _rules_inputs():
    rng = numpy.random.default_rng(5)
    specs = [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 32},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9},
         "init": {"weights": (rng.standard_normal((16, 32)) * 0.25)
                  .astype(numpy.float32),
                  "bias": numpy.zeros(32, numpy.float32)}},
        {"type": "softmax", "->": {"output_sample_shape": 4},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9},
         "init": {"weights": (rng.standard_normal((32, 4)) * 0.25)
                  .astype(numpy.float32),
                  "bias": numpy.zeros(4, numpy.float32)}}]
    labels = (numpy.arange(64) % 4).astype(numpy.int32)
    centers = rng.standard_normal((4, 16)) * 3
    x = (centers[labels] + rng.standard_normal((64, 16))).astype(
        numpy.float32)
    return {"rules_specs": specs, "rules_x": x, "rules_y": labels}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = _rules_inputs()
    return inputs, torch_ranks.run_world(
        WORLD, tuple(CONFIGS) + ("fused_fsdp_epoch", "fused_step_rules",
                                 "fused_topology_change"),
        inputs, tmp_path_factory.mktemp("fused_shard"))


def _recorded(wf):
    dec, closes = wf.decision, []
    close = dec._close_class

    def recording(cls, check_epoch_end):
        closes.append((int(dec.epoch_number), int(cls),
                       float(dec.epoch_n_err[cls])))
        return close(cls, check_epoch_end)
    dec._close_class = recording
    return closes


def _jax_run(config):
    jax_prng.seed_all(3)
    wf = jax_mnist.create_workflow(
        device=JaxCPUDevice(), max_epochs=2, native=True, fused=True,
        fused_config=dict(config))
    closes = _recorded(wf)
    wf.run()
    weights = []
    for fwd in wf.forwards:
        fwd.weights.map_read()
        fwd.bias.map_read()
        weights.append((numpy.array(fwd.weights.mem, numpy.float32),
                        numpy.array(fwd.bias.mem, numpy.float32)))
    spec = wf.fused_trainer._params_[0]["w"].sharding.spec
    return {"closes": closes, "weights": weights,
            "spec": [None if e is None else e for e in tuple(spec)]}


def _assert_runs(got, want, tol=FUSED_TOL):
    assert got["closes"] == want["closes"]
    for (gw, gb), (ww, wb) in zip(got["weights"], want["weights"]):
        assert numpy.abs(gw - ww).max() <= tol
        assert numpy.abs(gb - wb).max() <= tol


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_fused_sharded_mnist_matches_jax(world, case):
    want = _jax_run(CONFIGS[case])
    assert len(want["closes"]) > 0
    assert want["spec"] == SPECS[case]
    for rank in world[1]:
        got = rank[case]
        _assert_runs(got, want)
        assert got["specs"][0]["w"] == SPECS[case]
        # the momentum shards with its weight
        assert got["specs"][0]["vw"] == SPECS[case]


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_fused_sharded_local_leaves(world, case):
    """Each rank stores its slice: 784/4 rows under fsdp over data 4,
    100/2 neurons under tp over model 2, both under the merge."""
    want = {"fused_fsdp": [196, 100], "fused_tp": [784, 50],
            "fused_tp_fsdp": [392, 50]}[case]
    for rank in world[1]:
        got = rank[case]
        assert got["local"][0]["w"] == want
        assert got["local"][0]["vw"] == want
        assert got["collectives"]["all_gather"] > 0


def test_fused_tp_collectives(world):
    """TP adds the model axis's all-reduces (the column input's gradient
    and the sliced bias's) and all-gathers (the columns) to the data
    axis's one all-reduce a step."""
    for rank in world[1]:
        tp = rank["fused_tp"]["collectives"]
        fsdp = rank["fused_fsdp"]["collectives"]
        assert tp["all_reduce"] > fsdp["all_reduce"]
        assert rank["fused_tp_fsdp"]["collectives"]["all_gather"] > \
            tp["all_gather"]


def test_fused_fsdp_epoch_mode_matches_one_process(world):
    from veles_tpu_torch.samples import mnist
    prng.seed_all(3)
    wf = mnist.create_workflow(device="cpu", max_epochs=2, native=True,
                               fused=True, fused_config={"epoch_mode": True})
    closes = _recorded(wf)
    wf.run()
    want = {"closes": closes, "weights": [
        (numpy.array(f.weights.mem, numpy.float32),
         numpy.array(f.bias.mem, numpy.float32)) for f in wf.forwards]}
    for rank in world[1]:
        _assert_runs(rank["fused_fsdp_epoch"], want)
        assert rank["fused_fsdp_epoch"]["specs"][0]["w"] == ["data", None]


@pytest.mark.parametrize("layout", ["fsdp", "tp"])
def test_sharded_step_matches_one_process(world, layout):
    """``test_fused_parallel.py:137`` / ``:175``: the sharded step equals
    the step on the whole batch with whole parameters."""
    from veles_tpu_torch.znicz.fused_graph import (lower_specs, to_numpy,
                                                   to_tensors)
    inputs, results = world
    prng.seed_all(0)
    params, step_fn, _e, _a = lower_specs(
        [dict(s) for s in inputs["rules_specs"]],
        (inputs["rules_x"].shape[1],))
    params = to_tensors(params, "cpu")
    x = torch.tensor(inputs["rules_x"])
    y = torch.tensor(inputs["rules_y"])
    metrics = []
    for _ in range(3):
        params, m = step_fn(params, x, y)
        metrics.append(float(m["n_err"]))
    want = to_numpy(params)
    for rank in results:
        got = rank["fused_step_rules"][layout]
        assert [m["n_err"] for m in got["metrics"]] == metrics
        assert any(any(s) for s in got["specs"][0].values())
        for g_layer, w_layer in zip(got["state"], want):
            for key, value in w_layer.items():
                if value is None:
                    continue
                numpy.testing.assert_allclose(
                    g_layer[key], value, rtol=0, atol=FUSED_TOL)


def test_shard_params_topology_change(world):
    """Placed over data 4 and gathered, the tree is the lowered one bit
    for bit; placed again over data 2 each of the first two ranks holds
    its half of every sharded leaf."""
    from veles_tpu_torch.znicz.fused_graph import lower_specs
    inputs, results = world
    params, _s, _e, _a = lower_specs(
        [dict(s) for s in inputs["rules_specs"]],
        (inputs["rules_x"].shape[1],))
    for rank, got in enumerate(results):
        got = got["fused_topology_change"]
        for whole, want in zip(got["data4"]["whole"], params):
            for key, value in want.items():
                if value is not None:
                    numpy.testing.assert_array_equal(whole[key], value)
        # the 16x32 weight (512 elements) shards its rows
        assert got["data4"]["local"][0]["w"].shape == (4, 32)
        if rank < 2:
            local = got["data2"]["local"][0]["w"]
            numpy.testing.assert_array_equal(
                local, params[0]["w"][8 * rank:8 * rank + 8])
            for whole, want in zip(got["data2"]["whole"], params):
                for key, value in want.items():
                    if value is not None:
                        numpy.testing.assert_array_equal(whole[key], value)
