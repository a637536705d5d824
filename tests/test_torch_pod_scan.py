"""The port's epoch-scan windows and health over a pod, on the CPU.

A world of 4 gloo ranks (``tests/torch_ranks.py``) trains the pod's
seeded 5-cluster task (``make_workflow``, minibatch 64, 3 epochs) under
``PodRuntime`` over the 4-wide data axis with ``engine.health=on``:

- under ``epoch_scan=auto`` a class pass is one dispatch (the JAX test
  ``test_epoch_scan.py:448`` counts at most 2 an epoch) with the
  stages' collectives inside every window step, no recompile flagged,
  and the windows' weights and momenta bit for bit the per-step pod
  route's (the same stage functions in the same order) and within 5e-5
  of the JAX single-device scan run (``test_epoch_scan.py:448``'s
  tolerance), its metrics equal;
- the health statistics of every rank equal the JAX single-device
  run's within 1e-3 relative (``test_watch.py:342``'s tolerance): the
  GD stages run on the gathered minibatch, so their statistics are the
  single-device values on every rank;
- a reshard under windows (the reshard half of
  ``test_epoch_scan.py:493``; the chaos ``pod_chip`` site is 7(e), so
  the device-loss detector triggers it): the window graphs are dropped,
  the next windows run on 2 shards, whose ledger entries carry 2 and
  the payload of their collectives, K steps' worth, no recompile is
  flagged and the run completes.
"""

import numpy
import pytest
import torch

import torch_ranks
from veles_tpu import watch as jax_watch
from veles_tpu.config import root as jax_root
from veles_tpu.pod import eval_metrics as jax_eval_metrics
from veles_tpu.pod import train_epochs as jax_train_epochs
from veles_tpu.pod.__main__ import make_workflow as jax_make_workflow

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

EPOCHS = 3
#: one step's collective payload (test_torch_pod.py): the GD
#: all-gathers of the 64-row minibatch, the evaluator's all-reduces
GD_GATHERED = 4 * 64 * (12 + 5 + 5 + 16 + 12 + 12)
EVAL_REDUCED = 3 * 4 + 5 * 5 * 8
WORLD = 4
#: test_epoch_scan.py:448's tolerance on the weights
WEIGHT_TOL = 5e-5
#: test_watch.py:342's tolerance on the health statistics
HEALTH_RTOL = 1e-3
STATS = ("grad_norm", "weight_norm", "update_norm", "update_ratio")


@pytest.fixture(scope="module")
def jax_scan():
    """The JAX single-device scan run with health on."""
    eng = jax_root.common.engine
    saved = {k: eng.get(k, d) for k, d in (("epoch_scan", "off"),
                                           ("health", "off"))}
    eng.epoch_scan, eng.health = "auto", "on"
    try:
        wf = jax_make_workflow(max_epochs=EPOCHS)
        for _ in jax_train_epochs(wf, EPOCHS):
            pass
        weights = []
        for fwd in wf.forwards:
            for vec in (fwd.weights, fwd.bias):
                vec.map_read()
                weights.append(numpy.array(vec.mem))
        for gd in wf.gds:
            for vec in (gd.gradient_weights, gd.gradient_bias):
                vec.map_read()
                weights.append(numpy.array(vec.mem))
        return {"metrics": jax_eval_metrics(wf), "weights": weights,
                "health": jax_watch.monitor.snapshot()}
    finally:
        for key, value in saved.items():
            setattr(eng, key, value)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_ranks.run_world(
        WORLD, ("pod_windows", "pod_reshard_windows"),
        {"pod_epochs": EPOCHS}, tmp_path_factory.mktemp("pod_scan"))


@pytest.mark.parametrize("rank", range(WORLD))
def test_pod_windows_one_dispatch_a_class_pass(world, rank):
    got = world[rank]["pod_windows"]["windows"]
    scan = got["scan"]
    assert scan["eligible"] and scan["windows"] > 0
    assert got["dispatches"] == scan["windows"]
    assert got["dispatches"] <= (got["metrics"]["epochs"] + 1) * 2
    assert got["recompiles"] == 0
    steps = world[rank]["pod_windows"]["steps"]
    # the same collectives, issued inside the window steps
    assert got["collectives"] == steps["collectives"]


@pytest.mark.parametrize("rank", range(WORLD))
def test_pod_windows_equal_the_per_step_pod_route(world, rank):
    got = world[rank]["pod_windows"]
    assert got["windows"]["metrics"] == got["steps"]["metrics"]
    for a, b in zip(got["windows"]["weights"], got["steps"]["weights"]):
        numpy.testing.assert_array_equal(a, b)


def test_pod_windows_match_the_jax_scan_run(world, jax_scan):
    for rank in range(WORLD):
        got = world[rank]["pod_windows"]["windows"]
        for key in ("complete", "epochs", "best_n_err_pt"):
            assert got["metrics"][key] == jax_scan["metrics"][key]
        for g, w in zip(got["weights"], jax_scan["weights"]):
            numpy.testing.assert_allclose(g, w, rtol=0, atol=WEIGHT_TOL)


@pytest.mark.parametrize("route", ["windows", "steps"])
def test_pod_health_agrees_with_single_device(world, jax_scan, route):
    want = jax_scan["health"]
    for rank in range(WORLD):
        snap = world[rank]["pod_windows"][route]["health"]
        assert set(snap["groups"]) == set(want["groups"])
        for name, group in snap["groups"].items():
            for stat in STATS:
                assert group[stat] == pytest.approx(
                    want["groups"][name][stat], rel=HEALTH_RTOL), \
                    (rank, route, name, stat)
            assert group["nonfinite"] == 0


def test_pod_health_identical_on_every_rank(world):
    first = world[0]["pod_windows"]["windows"]["health"]["groups"]
    for rank in range(1, WORLD):
        assert world[rank]["pod_windows"]["windows"]["health"][
            "groups"] == first


def test_pod_reshard_under_windows(world, jax_scan):
    for rank in range(WORLD):
        got = world[rank]["pod_reshard_windows"]
        assert got["pod"]["reshards"] == 1
        assert got["pod"]["shards"] == 2
        assert got["pod"]["generation"] == 2
        assert got["recompiles"] == 0
        if rank >= 2:
            assert got["pod"]["left"]
            continue
        assert got["metrics"]["complete"]
        assert got["scan"]["windows"] > 0
        assert abs(got["metrics"]["best_n_err_pt"]
                   - jax_scan["metrics"]["best_n_err_pt"]) <= 2.0
        scans = [row for row in got["ledger"]
                 if row["name"].startswith("scan:")]
        assert scans and all(row["shards"] == 2 for row in scans)
        # a window's collectives, K steps of the per-step route's: the
        # evaluator's all-reduces, with the GD all-gathers when it trains
        per_step = {row["bytes"] / row["steps"] for row in scans}
        assert per_step == {EVAL_REDUCED, GD_GATHERED + EVAL_REDUCED}
