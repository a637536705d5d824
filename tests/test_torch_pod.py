"""The port's pod (``veles_tpu_torch.pod``) against the JAX package's,
on the CPU.

- A world of 4 gloo ranks (``tests/torch_ranks.py``, no JAX in a rank)
  trains the pod's seeded 5-cluster task (``pod/__main__.py``'s
  ``make_workflow``, minibatch 64, 3 epochs) under ``PodRuntime`` over
  the 4-wide data axis, each rank serving 16 rows of every minibatch:
  ``complete``, ``epochs`` and ``best_n_err_pt`` equal to the JAX
  single-device stitched run's and to the JAX ``PodRuntime``'s over a
  4-wide data axis, every weight and momentum within 5e-5 of both (the
  JAX test's tolerance: the all-gathered GD and the all-reduced metrics
  reorder no float sum here, but the JAX pod's psum does), the same on
  every rank; the collectives a step by kind; the ledger's shards and
  the payload its stages' collectives moved; one
  ``pod``/``shard_dispatch`` lane a shard.
- The same world with every leaf of 16 elements or more sharded over
  the data axis (``fsdp_rules``): the same metrics, weights within
  5e-5.
- A world of 1: the pod over a one-rank group bit for bit the port's
  single-device stitched run, its collectives issued.
- Device loss, 4 -> 2: a host falls silent after the second epoch, the
  ``DeviceLossDetector`` reshards once (``reshards == 1``, ``shards ==
  2``, ``generation == 2``, one ``pod:reshard`` and one
  ``jobs:heartbeat_stall`` instant), ranks 2 and 3 leave and ranks 0
  and 1 finish with ``best_n_err_pt`` within 2.0 of the fault-free run
  (the JAX test's bound).
- ``InferenceEngine(mesh=, param_specs=)`` over the world
  (``test_pod.py:422``): the task trained one epoch answers over the
  replicated mesh byte-identically to the plain engine, over the mesh
  with the hidden layer's weight column-sharded within 1e-5 (its
  all-gathers issued), and a one-rank mesh is the plain path; the plain
  answers within 1e-5 of the JAX engine's on the JAX-trained task.
- The install refusals (``test_pod.py:127-139``), ``param_rules``
  modes, the preflight's refusal naming 7(e), ``Vector.set_sharding``
  over a world of 4, the pp / ep rules (``test_pod.py:561``),
  ``MultiHostPod``'s transparent delegation (``test_pod.py:467``), the
  typed device-loss classification and the refusals of the lease half
  naming 7(e).
"""

import numpy
import pytest
import torch

import torch_ranks
from veles_tpu.parallel.mesh import mesh_from_topology as jax_mesh
from veles_tpu.pod import PodRuntime as JaxPodRuntime
from veles_tpu.pod import eval_metrics as jax_eval_metrics
from veles_tpu.pod import train_epochs as jax_train_epochs
from veles_tpu.pod.__main__ import make_workflow as jax_make_workflow

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

EPOCHS = 3
WORLD = 4
#: the JAX parity gate's tolerance on the weights (test_pod.py:186)
WEIGHT_TOL = 5e-5
#: a minibatch whose passes end in short tails (torch_ranks.TAIL_BATCH)
TAIL_BATCH = torch_ranks.TAIL_BATCH
#: the JAX elastic gate's bound on best_n_err_pt after a reshard
RESHARD_ERR_PT = 2.0
METRIC_KEYS = ("complete", "epochs", "best_n_err_pt")


def _jax_weights(wf):
    out = []
    for fwd in wf.forwards:
        for vec in (fwd.weights, fwd.bias):
            vec.map_read()
            out.append(numpy.array(vec.mem))
    for gd in wf.gds:
        for vec in (gd.gradient_weights, gd.gradient_bias):
            vec.map_read()
            out.append(numpy.array(vec.mem))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX single-device stitched run and the JAX pod over a 4-wide
    data axis of the virtual CPU devices."""
    out = {}
    for name, shards, batch in (
            ("reference", None, 64), ("pod", WORLD, 64),
            ("tail_reference", None, TAIL_BATCH),
            ("tail_pod", WORLD, TAIL_BATCH)):
        wf = jax_make_workflow(max_epochs=EPOCHS, batch=batch)
        if shards:
            JaxPodRuntime(wf, mesh=jax_mesh(
                {"data": shards}, require=("data",))).install()
        for _ in jax_train_epochs(wf, EPOCHS):
            pass
        out[name] = {"metrics": jax_eval_metrics(wf),
                     "weights": _jax_weights(wf)}
    return out


SERVE_BATCH = numpy.random.default_rng(3).standard_normal(
    (8, 16)).astype(numpy.float32)
#: test_pod.py:422's tolerance for the column-sharded engine
SERVE_TP_TOL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_ranks.run_world(
        WORLD, ("pod", "pod_fsdp", "vector_sharding", "pod_serve",
                "pod_vjp", "pod_reshard_fsdp", "pod_reshard", "pod_tail",
                "pod_mse_tail"),
        {"pod_epochs": EPOCHS, "serve_batch": SERVE_BATCH},
        tmp_path_factory.mktemp("pod"))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return torch_ranks.run_world(
        1, ("pod_reference",), {"pod_epochs": EPOCHS},
        tmp_path_factory.mktemp("pod1"))[0]["pod_reference"]


def _close(got, want, tol=WEIGHT_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        numpy.testing.assert_allclose(g, w, rtol=0, atol=tol)


# -- the parity gate, world 4 ------------------------------------------------

@pytest.mark.parametrize("against", ["reference", "pod"])
@pytest.mark.parametrize("case", ["pod", "pod_fsdp"])
def test_pod_world4_matches_jax(world, jax_runs, case, against):
    want = jax_runs[against]
    assert want["metrics"]["complete"]
    for rank in range(WORLD):
        got = world[rank][case]
        assert got["pod"]["shards"] == WORLD
        assert got["pod"]["rows_per_shard"] == 64 // WORLD
        for key in METRIC_KEYS:
            assert got["metrics"][key] == want["metrics"][key], \
                (rank, key, got["metrics"], want["metrics"])
        _close(got["weights"], want["weights"])


@pytest.mark.parametrize("against", ["tail_reference", "tail_pod"])
def test_pod_tail_minibatch_matches_jax(world, jax_runs, against):
    """Minibatch 40 over 4 ranks: both classes end in a short minibatch
    (train 24 rows, validation 8), so ranks serve fewer rows than 10 or
    padding only, the GD layers gather pad rows and the evaluator counts
    none of them.  Every rank issues the same collectives and ends with
    the JAX runs' metrics, its weights within 5e-5."""
    want = jax_runs[against]
    assert want["metrics"]["complete"]
    for rank in range(WORLD):
        got = world[rank]["pod_tail"]
        assert got["pod"]["rows_per_shard"] == TAIL_BATCH // WORLD
        for key in METRIC_KEYS:
            assert got["metrics"][key] == want["metrics"][key], \
                (rank, key, got["metrics"], want["metrics"])
        _close(got["weights"], want["weights"])
        assert got["collectives"] == world[0]["pod_tail"]["collectives"]


#: the sum of squared errors over the rows is reordered by the pod's
#: all-reduce of the ranks' partial sums (test_torch_epoch_scan.py's
#: MSE tolerance)
MSE_RTOL = 1e-5


def test_pod_mse_tail_matches_stitched_run(world):
    """The MSE evaluator over the pod with short tails (a rank whose
    first row lies past the minibatch counts no row): the best MSE
    within 1e-5 relative of the single-device stitched run's, the
    weights within 5e-5, the same on every rank."""
    for rank in range(WORLD):
        got = world[rank]["pod_mse_tail"]
        ref, pod = got["reference"], got["pod"]
        assert ref["metrics"]["complete"] and pod["metrics"]["complete"]
        assert pod["metrics"]["epochs"] == ref["metrics"]["epochs"]
        assert pod["metrics"]["best_mse"] == pytest.approx(
            ref["metrics"]["best_mse"], rel=MSE_RTOL)
        _close(pod["weights"], ref["weights"])
        assert pod["collectives"]["all_gather"] > 0


@pytest.mark.parametrize("case", ["pod", "pod_fsdp"])
def test_pod_ranks_agree_bit_for_bit(world, case):
    """The parameters stay replicated: every rank ends with the same
    bytes."""
    first = world[0][case]["weights"]
    for rank in range(1, WORLD):
        for a, b in zip(world[rank][case]["weights"], first):
            numpy.testing.assert_array_equal(a, b)


def test_pod_collectives_a_step(world):
    """Per train step: the evaluator's two all-reduces and the two GD
    layers' three all-gathers each; per validation step the two
    all-reduces.  Every rank issues the same."""
    got = world[0]["pod"]
    dispatches = got["dispatches"]
    train_steps = got["collectives"]["all_gather"] // 6
    eval_steps = got["collectives"]["all_reduce"] // 2
    assert got["collectives"]["all_gather"] == 6 * train_steps
    assert dispatches == eval_steps + train_steps
    assert got["collectives"]["all_to_all"] == 0
    for rank in range(1, WORLD):
        assert world[rank]["pod"]["collectives"] == got["collectives"]


def test_pod_fsdp_gathers_its_leaves(world):
    """fsdp_rules at 16 elements shards the leaves of at least 16
    elements (the weights and their momenta): each stage gathers them
    before use, so the run issues more all-gathers."""
    plain = world[0]["pod"]["collectives"]["all_gather"]
    sharded = world[0]["pod_fsdp"]["collectives"]["all_gather"]
    assert sharded > plain


#: the payload of one GD dispatch's all-gathers: each GD layer gathers
#: its x, y and err_output (float32, the 64-row minibatch), GDSoftmax
#: 12 + 5 + 5 columns, GDTanh 16 + 12 + 12
GD_GATHERED = 4 * 64 * (12 + 5 + 5 + 16 + 12 + 12)
#: one evaluator dispatch's all-reduces: the float32 loss sum, valid
#: rows and n_err, then the 5x5 int64 confusion counts
EVAL_REDUCED = 3 * 4 + 5 * 5 * 8


def test_pod_ledger_and_lanes(world):
    """The ledger's ``collective_bytes`` is what the stages' collectives
    moved: the GD segment's all-gathers and the evaluator's
    all-reduces, every dispatch."""
    got = world[0]["pod"]
    rows = {row["name"]: row for row in got["ledger"]}
    assert all(row["shards"] == WORLD for row in rows.values())
    per = {}
    for name, row in rows.items():
        kind = "gd" if name.startswith("GD") else "forward"
        per[kind] = row["bytes"] / row["dispatches"]
    assert per == {"gd": GD_GATHERED, "forward": EVAL_REDUCED}
    assert got["pod"]["collective_bytes_per_step"] == \
        GD_GATHERED + EVAL_REDUCED
    assert got["lanes"] == list(range(WORLD))
    assert got["recompiles"] == 0


def test_pod_vjp_family_sums_its_gradients(world):
    """``GDViaVJP`` (here ``GDRProp``, behind ``rprop_all2all``) runs on
    the rank's rows and all-reduces its summed gradients: the pod's run
    within 5e-5 of the single-device run, its metrics equal, the same
    on every rank."""
    for rank in range(WORLD):
        got = world[rank]["pod_vjp"]
        ref, pod = got["reference"], got["pod"]
        for key in METRIC_KEYS:
            assert pod["metrics"][key] == ref["metrics"][key]
        _close(pod["weights"], ref["weights"])
        assert pod["collectives"]["all_reduce"] > \
            ref["collectives"]["all_reduce"]
    for a, b in zip(world[0]["pod_vjp"]["pod"]["weights"],
                    world[WORLD - 1]["pod_vjp"]["pod"]["weights"]):
        numpy.testing.assert_array_equal(a, b)


# -- the pod at one rank -----------------------------------------------------

def test_pod_world1_is_the_stitched_run_bit_for_bit(world1):
    ref, pod = world1["reference"], world1["pod"]
    assert pod["metrics"] == ref["metrics"]
    assert pod["dispatches"] == ref["dispatches"]
    for a, b in zip(pod["weights"], ref["weights"]):
        numpy.testing.assert_array_equal(a, b)
    # the collectives still ran, on the one-rank group
    assert pod["collectives"]["all_gather"] > 0
    assert pod["collectives"]["all_reduce"] > 0
    assert ref["collectives"]["all_gather"] == 0
    assert pod["pod"]["shards"] == 1


# -- device loss, 4 -> 2 -----------------------------------------------------

def test_device_loss_reshards_4_to_2(world, jax_runs):
    fault_free = jax_runs["reference"]["metrics"]
    for rank in range(WORLD):
        got = world[rank]["pod_reshard"]
        assert got["lost"] == ["host-3"] and got["after"] == []
        assert got["stalls"] == 1 and got["stall_instants"] == 1
        assert got["reshard_instants"] == 1
        assert got["pod"]["reshards"] == 1
        assert got["pod"]["shards"] == 2
        assert got["pod"]["generation"] == 2
        assert got["pod"]["left"] == (rank >= 2)
        if rank >= 2:
            # left after the reshard: its train_epochs ended
            assert got["epochs_run"] == [1, 2]
            continue
        assert got["epochs_run"] == [1, 2, 3]
        assert got["pod"]["rows_per_shard"] == 32
        assert got["metrics"]["complete"]
        assert abs(got["metrics"]["best_n_err_pt"]
                   - fault_free["best_n_err_pt"]) <= RESHARD_ERR_PT
        assert got["recompiles"] == 0
    for a, b in zip(world[0]["pod_reshard"]["weights"],
                    world[1]["pod_reshard"]["weights"]):
        numpy.testing.assert_array_equal(a, b)


# -- the mesh InferenceEngine (test_pod.py:422) --------------------------------

def test_inference_engine_mesh_parity_and_fallback(world):
    from veles_tpu.serve.engine import InferenceEngine as JaxEngine
    jwf = jax_make_workflow(max_epochs=1)
    for _ in jax_train_epochs(jwf, 1):
        pass
    want = JaxEngine.from_workflow(jwf, max_batch_size=8).infer(SERVE_BATCH)
    for rank in range(WORLD):
        got = world[rank]["pod_serve"]
        plain = got["plain"]["y"]
        numpy.testing.assert_allclose(plain, want, rtol=0, atol=SERVE_TP_TOL)
        assert got["plain"]["mesh"] is None
        assert got["sharded"]["mesh"] == {"data": WORLD}
        assert got["sharded"]["sharded"] is True
        numpy.testing.assert_array_equal(got["sharded"]["y"], plain)
        assert got["sharded"]["gathers"] == 0
        numpy.testing.assert_allclose(got["tp"]["y"], plain, rtol=0,
                                      atol=SERVE_TP_TOL)
        assert got["tp"]["gathers"] > 0
        assert got["fallback"]["mesh"] is None
        assert got["fallback"]["sharded"] is False
        numpy.testing.assert_array_equal(got["fallback"]["y"], plain)


def test_device_loss_reshard_keeps_fsdp_leaves(world):
    """The same reshard with the leaves FSDP-sharded: the trained slices
    are gathered over the old mesh and re-cut for the new one, so the
    survivors end where the replicated reshard ends (within 5e-5)."""
    for rank in range(2):
        got = world[rank]["pod_reshard_fsdp"]
        want = world[rank]["pod_reshard"]
        assert got["pod"]["shards"] == 2 and got["pod"]["generation"] == 2
        assert got["metrics"] == want["metrics"]
        _close(got["weights"], want["weights"])
    for rank in range(2, WORLD):
        assert world[rank]["pod_reshard_fsdp"]["pod"]["left"]


# -- Vector shardings (test_pod.py:102) ---------------------------------------

def test_vector_set_sharding_preserves_and_places(world):
    for rank in range(WORLD):
        got = world[rank]["vector_sharding"]
        assert got["local"] == list(range(16 * rank, 16 * rank + 16))
        assert got["shape"] == [64]
        assert got["gathered"] == list(range(64))
        assert got["replicated"] == list(range(64))
        assert got["cleared"] == list(range(64))
        assert got["sharding_after"] is None


# -- install preconditions (test_pod.py:127-139) ------------------------------

def _port_workflow(**kwargs):
    from veles_tpu_torch.pod.__main__ import make_workflow
    return make_workflow(device="cpu", max_epochs=1, **kwargs)


@pytest.fixture
def stitch_knob():
    from veles_tpu_torch.config import root
    saved = root.common.engine.get("stitch", "on")
    yield root.common.engine
    root.common.engine.stitch = saved


def test_pod_requires_stitched_workflow(stitch_knob):
    from veles_tpu_torch.pod import PodError, PodRuntime
    stitch_knob.stitch = "off"
    wf = _port_workflow()
    with pytest.raises(PodError, match="no stitched segments"):
        PodRuntime(wf).install()


def test_pod_requires_divisible_batch():
    from veles_tpu_torch.parallel.mesh import Mesh
    from veles_tpu_torch.pod import PodError, PodRuntime
    wf = _port_workflow(batch=60)
    with pytest.raises(PodError, match="does not divide"):
        PodRuntime(wf, mesh=Mesh({"data": 8}, world_size=8)).install()


def test_pod_mesh_needs_a_data_axis():
    from veles_tpu_torch.parallel.mesh import Mesh, MeshTopologyError
    from veles_tpu_torch.pod import PodRuntime
    with pytest.raises(MeshTopologyError):
        PodRuntime(_port_workflow(), mesh=Mesh({"model": 1}))


@pytest.mark.parametrize("mode,error,match", [
    ("auto", NotImplementedError, r"item 7\(e\)"),
    ("banana", Exception, "unknown param_rules mode")])
def test_pod_param_rules_modes(mode, error, match):
    from veles_tpu_torch.pod import PodRuntime
    with pytest.raises(error, match=match):
        PodRuntime(_port_workflow(), param_rules=mode).install()


@pytest.mark.parametrize("preflight", ["warn", "fail"])
def test_pod_preflight_names_7e(preflight):
    from veles_tpu_torch.pod import PodRuntime
    with pytest.raises(NotImplementedError, match=r"item 7\(e\)"):
        PodRuntime(_port_workflow(), preflight=preflight).install()


def test_pod_preflight_off_installs_and_uninstalls():
    from veles_tpu_torch.pod import PodRuntime, train_epochs
    wf = _port_workflow()
    pod = PodRuntime(wf, preflight="off").install()
    assert pod.installed and wf.pod_runtime_ is pod
    assert all(s.pod is pod for s in wf.stitch_segments)
    pod.uninstall()
    assert not pod.installed and wf.pod_runtime_ is None
    assert all(s.pod is None for s in wf.stitch_segments)
    for _ in train_epochs(wf, 1):
        pass
    assert wf.decision.complete


# -- the rules (test_pod.py:561) ----------------------------------------------

def test_pp_ep_rules_shard_leading_dim():
    from veles_tpu_torch.parallel.dp import ep_rules, pp_rules
    from veles_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh({"data": 2, "pipe": 4}, world_size=8)
    rules = pp_rules(mesh, min_elements=64)
    assert rules(numpy.zeros((4, 32, 32))) == ("pipe", None, None)
    assert rules(numpy.zeros((8, 64))) == ("pipe", None)
    assert rules(numpy.zeros((3, 64, 64))) is None
    assert rules(numpy.zeros((4, 2))) is None
    assert rules(numpy.float32(0.5)) is None
    with pytest.raises(ValueError):
        pp_rules(Mesh({"data": 8}, world_size=8))
    emesh = Mesh({"data": 2, "expert": 4}, world_size=8)
    erules = ep_rules(emesh, min_elements=64)
    assert erules(numpy.zeros((4, 16, 32))) == ("expert", None, None)
    assert erules(numpy.zeros((4, 8))) is None


def test_spec_for_vector_rule():
    from veles_tpu_torch.memory import Vector
    from veles_tpu_torch.pod import spec_for_vector
    batch = Vector(numpy.zeros((64, 16), numpy.float32), category="staging")
    data = Vector(numpy.zeros((512, 16), numpy.float32), category="dataset")
    w = Vector(numpy.zeros((16, 12), numpy.float32), category="params")
    assert spec_for_vector(batch, 64, 4) == ("data", None)
    assert spec_for_vector(batch, 64, 3) == ()
    assert spec_for_vector(data, 64, 4) == ()      # whole on every rank
    assert spec_for_vector(w, 64, 4) == ()
    assert spec_for_vector(w, 64, 4, param_rules=lambda leaf: (
        "data", None)) == ("data", None)


# -- MultiHostPod (test_pod.py:467) ------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return torch_ranks.run_world(2, ("multihost_poll",
                                     "multihost_self_beats"), {},
                                 tmp_path_factory.mktemp("pod2"))


def test_multihost_pod_poll_reaches_every_rank(world2):
    """The coordinator's verdict is broadcast: both ranks reshard on it
    (2 -> 1 shard, generation 2), and the rank outside the new mesh
    leaves."""
    for rank, got in enumerate(world2):
        got = got["multihost_poll"]
        assert got["processes"] == 2 and got["before"] == 2
        assert got["lost"] == ["b"]
        assert got["shards"] == 1 and got["generation"] == 2
        assert got["left"] == (rank == 1)


def test_multihost_pod_self_beats_reach_the_coordinator(world2):
    """Each process beats only itself (``beat()`` with no host): the
    follower's beats reach the coordinator's detector through the poll,
    and when the follower falls silent the coordinator declares it lost
    and both ranks reshard on the verdict."""
    for rank, got in enumerate(world2):
        got = got["multihost_self_beats"]
        assert got["first"] == []
        assert got["lost"] == [1]
        assert got["shards"] == 1 and got["generation"] == 2
        assert got["left"] == (rank == 1)
    coordinator = world2[0]["multihost_self_beats"]
    assert coordinator["stalls"] == 1 and coordinator["hosts"] == [0]
    follower = world2[1]["multihost_self_beats"]
    assert follower["stalls"] == 0 and follower["hosts"] == []


def test_multihost_pod_transparent_delegation():
    from veles_tpu_torch.pod import MultiHostPod
    wf = _port_workflow()
    pod = MultiHostPod(wf)
    assert pod.process_count == 1
    assert pod.process_index == 0
    assert pod.is_coordinator
    assert pod.host_range(64) == (0, 64)
    pod.install()
    try:
        assert pod.runtime.installed
        desc = pod.describe()
        assert desc["processes"] == 1
        assert desc["process_index"] == 0
        assert desc["coordinator"] is True
        assert desc["shards"] == pod.runtime.shards
        local = numpy.zeros((16, 4), numpy.float32)
        out = pod.assemble(local)
        assert tuple(out.shape) == (16, 4)
    finally:
        pod.uninstall()
    assert not pod.runtime.installed


# -- device loss, typed (test_pod.py:523) --------------------------------------

def test_device_loss_detector_dispatch_failure():
    from veles_tpu_torch.pod import (DeviceLossDetector, PodRuntime,
                                     is_device_loss)
    assert is_device_loss(RuntimeError("UNAVAILABLE: socket closed"))
    assert is_device_loss(RuntimeError(
        "device lost: slice health check failed"))
    assert is_device_loss(RuntimeError("DEADLINE EXCEEDED waiting"))
    assert not is_device_loss(RuntimeError("Invalid argument: dim 3"))
    assert not is_device_loss(ValueError("unavailable"))
    assert not is_device_loss(None)
    wf = _port_workflow()
    runtime = PodRuntime(wf).install()
    try:
        det = DeviceLossDetector(runtime, devices_per_host=4)
        gen = runtime.generation
        assert not det.dispatch_failure(ValueError("shape mismatch"))
        assert runtime.generation == gen
        assert det.dispatch_failure(
            RuntimeError("UNAVAILABLE: connection reset by peer"))
        assert det.dispatch_losses == 1
        assert runtime.generation == gen + 1
        assert runtime.shards == 1 and not runtime.left
    finally:
        runtime.uninstall()


@pytest.mark.parametrize("name", ["PodMaster", "PodWorker",
                                  "MultiHostPodWorker"])
def test_lease_half_names_7e(name):
    import veles_tpu_torch.pod as pod
    with pytest.raises(NotImplementedError, match=r"item 7\(e\)"):
        getattr(pod, name)(None, "tcp://127.0.0.1:1")


def test_pod_smoke_cli(capsys):
    """``python -m veles_tpu_torch.pod --smoke`` on a one-rank gloo
    group of this process (left again afterwards)."""
    from veles_tpu_torch.parallel import multihost
    from veles_tpu_torch.pod.__main__ import main
    try:
        assert main(["--smoke", "--device", "cpu"]) == 0
    finally:
        multihost.shutdown()
    assert "pod smoke: OK" in capsys.readouterr().out
