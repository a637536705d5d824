"""The port's ``TrainCheckpointer`` (``veles_tpu_torch.checkpoint``), on
the CPU: the cases of ``tests/test_checkpoint.py`` that need no mesh and
no fused trainer, in the port's own format (a ``numpy.savez`` archive
and a JSON meta a step, committed by ``os.replace``; Orbax is not on the
card's machine).

- a save and restore round trip with the loader state, and a workflow's
  ``capture_train_state`` pair through it: the restored run equals the
  run restored straight from the pair;
- the random streams resume where they were saved;
- ``latest_step`` and ``max_to_keep``; an empty directory raises
  ``FileNotFoundError``;
- ``_jsonify`` round-trips typed dict keys and writes the JSON the JAX
  package's ``_jsonify`` writes for the same input;
- ``restore`` places each leaf as its abstract leaf says (a torch
  tensor's dtype and device, a numpy array's dtype, an ``ArraySpec``),
  and refuses a leaf of another shape;
- a step that a crash left half-written is never taken for the latest;
- restoring onto another rank count (once refused naming item 7(d)):
  a step saved by 2 gloo ranks (``tests/torch_ranks.py``: the JAX
  test's 8x8 ``w`` / ``vw`` held as row slices, and the train state of
  the pod's seeded task after one epoch of an fsdp pod, its sharded
  Vectors gathered by ``capture_train_state``) restores on 4 ranks (``w``
  by rows and ``vw`` by columns of the new data axis, the train state
  into a fresh fsdp pod whose Vectors re-shard by its rules) and on 1
  (this process), every value equal to the JAX ``TrainCheckpointer``'s
  restore of the same state saved over 8 devices and restored over 2
  (``test_checkpoint.py:39``), exactly for the 8x8 state and within
  5e-5 (the pod parity gate's tolerance) for the trained one, which the
  JAX package trains on one device;
- the restore copies what it installs, where the JAX units alias it.
"""

import json
import os

import numpy
import pytest
import torch

from veles_tpu.checkpoint import _jsonify as jax_jsonify
from veles_tpu_torch import checkpoint, prng
from veles_tpu_torch.checkpoint import (ArraySpec, TrainCheckpointer,
                                        _dejsonify, _jsonify)
from veles_tpu_torch.samples import mnist

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)


def _state():
    return {"w": numpy.arange(64, dtype=numpy.float32).reshape(8, 8),
            "vw": numpy.zeros((8, 8), numpy.float32),
            "step_scale": numpy.float32(0.5),
            "layers": [{"b": numpy.ones(3, numpy.float64)},
                       {"b": numpy.full(2, 7, numpy.int32)}]}


def test_save_restore_round_trip_with_the_loader_state(tmp_path):
    state = _state()
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(3, state, loader_state={"epoch": 2, "offset": 40,
                                      "failed": [(100, 20)]})
    step, restored, loader = ckpt.restore(state)
    assert step == 3
    assert loader == {"epoch": 2, "offset": 40, "failed": [(100, 20)]}
    for name in ("w", "vw"):
        numpy.testing.assert_array_equal(restored[name], state[name])
    assert restored["step_scale"].shape == () \
        and float(restored["step_scale"]) == 0.5
    assert isinstance(restored["layers"], list)
    numpy.testing.assert_array_equal(restored["layers"][1]["b"],
                                     [7, 7])
    assert restored["layers"][0]["b"].dtype == numpy.float64
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3"]
    assert sorted(os.listdir(tmp_path / "ckpt" / "3")) == \
        ["meta.json", "train.npz"]
    with numpy.load(tmp_path / "ckpt" / "3" / "train.npz",
                    allow_pickle=False) as archive:
        assert sorted(archive.files) == [
            "layers/0/b", "layers/1/b", "step_scale", "vw", "w"]
    ckpt.close()


def test_a_workflow_train_state_round_trips(tmp_path):
    """``capture_train_state`` → save → a fresh workflow → restore →
    ``restore_train_state`` gives the run that the pair installed
    straight gives."""
    prng.seed_all(5)
    wf = mnist.create_workflow(device="cpu", max_epochs=1)
    wf.run()
    train, meta = wf.capture_train_state()
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(1, train, meta)
    runs = []
    for through_disk in (False, True):
        prng.seed_all(5)
        fresh = mnist.create_workflow(device="cpu", max_epochs=2)
        if through_disk:
            abstract, _ = fresh.capture_train_state()
            _step, got_train, got_meta = ckpt.restore(abstract)
            assert got_meta == meta
            assert fresh.restore_train_state(got_train, got_meta) == 4
        else:
            assert fresh.restore_train_state(train, meta) == 4
        fresh.decision.complete <<= False
        fresh.run()
        runs.append((fresh.params_to_numpy(),
                     [h["n_err"] for h in fresh.decision.history]))
    assert runs[0][1] == runs[1][1]
    for name, value in runs[0][0].items():
        numpy.testing.assert_array_equal(runs[1][0][name], value)


def test_prng_streams_resume(tmp_path):
    prng.seed_all(777)
    prng.get("dropout").permutation(10)
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(0, {"x": numpy.zeros(2, numpy.float32)})
    future = [prng.get("dropout").permutation(50).tolist()
              for _ in range(3)]
    prng.seed_all(123)
    ckpt.restore({"x": numpy.zeros(2, numpy.float32)})
    replay = [prng.get("dropout").permutation(50).tolist()
              for _ in range(3)]
    assert replay == future
    ckpt.close()


def test_latest_step_and_retention(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    state = {"x": numpy.ones(4, numpy.float32)}
    for step in (1, 2, 3):
        ckpt.save(step, state)
    assert ckpt.latest_step() == 3
    assert ckpt.all_steps() == [2, 3]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state, step=1)
    with pytest.raises(FileExistsError):
        ckpt.save(3, state)
    assert TrainCheckpointer(str(tmp_path / "ckpt")).latest_step() == 3
    ckpt.close()


def test_empty_directory_raises(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "empty"))
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore({"x": numpy.zeros(1, numpy.float32)})
    ckpt.close()


def test_jsonify_round_trips_typed_dict_keys_as_jax_writes_them():
    state = {2: [1, 2, 3], 0: (4, 5), "name": {"nested": {7: "x"}},
             (1, 2): "tuple-key",
             "array": numpy.arange(3, dtype=numpy.uint64),
             "scalars": [numpy.int64(4), numpy.float32(0.25)],
             "raw": b"\x00\xff"}
    wire = json.dumps(_jsonify(state), sort_keys=True)
    assert wire == json.dumps(jax_jsonify(state), sort_keys=True)
    back = _dejsonify(json.loads(wire))
    assert back[2] == [1, 2, 3]
    assert back[0] == (4, 5)
    assert back["name"]["nested"][7] == "x"
    assert back[(1, 2)] == "tuple-key"
    assert back["array"].dtype == numpy.uint64
    assert back["scalars"] == [4, 0.25] and back["raw"] == b"\x00\xff"


def test_restore_follows_each_abstract_leaf(tmp_path):
    state = {"a": numpy.linspace(0, 1, 6, dtype=numpy.float32),
             "b": numpy.arange(4, dtype=numpy.int32),
             "c": numpy.ones((2, 2), numpy.float32),
             "d": numpy.full(3, 2.5, numpy.float32)}
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(0, state)
    abstract = {"a": torch.zeros(6, dtype=torch.float64),
                "b": numpy.zeros(4, numpy.int64),
                "c": ArraySpec((2, 2), torch.float16, "cpu"),
                "d": ArraySpec((3,), numpy.float64, None)}
    _step, got, _loader = ckpt.restore(abstract)
    assert isinstance(got["a"], torch.Tensor)
    assert got["a"].dtype == torch.float64 and got["a"].device.type == "cpu"
    numpy.testing.assert_array_equal(got["a"].numpy(),
                                     state["a"].astype(numpy.float64))
    assert isinstance(got["b"], numpy.ndarray) \
        and got["b"].dtype == numpy.int64
    assert isinstance(got["c"], torch.Tensor) \
        and got["c"].dtype == torch.float16
    assert isinstance(got["d"], numpy.ndarray) \
        and got["d"].dtype == numpy.float64
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({"a": numpy.zeros(5, numpy.float32),
                      "b": state["b"], "c": state["c"], "d": state["d"]})
    with pytest.raises(KeyError):
        ckpt.restore({"e": numpy.zeros(1)})
    with pytest.raises(TypeError, match="Python objects"):
        ckpt.save(1, {"o": numpy.array([object()])})


def test_a_half_written_step_is_never_the_latest(tmp_path, monkeypatch):
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    state = {"x": numpy.ones(4, numpy.float32)}
    ckpt.save(1, state)
    # a writer that died before its commit: the temporary directory
    # and a step directory without its meta
    stale = tmp_path / "ckpt" / ".tmp-5-99999"
    stale.mkdir()
    numpy.savez(str(stale / "train.npz"), x=numpy.zeros(4))
    (tmp_path / "ckpt" / "7").mkdir()
    assert ckpt.latest_step() == 1
    # a save that fails between the archive and the meta commits nothing

    def fail(*args, **kwargs):
        raise OSError("disk full")
    monkeypatch.setattr(checkpoint.json, "dump", fail)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(2, state)
    monkeypatch.undo()
    assert ckpt.latest_step() == 1
    assert not os.path.exists(tmp_path / "ckpt" / "2")
    assert not any(name.startswith(".tmp-2-")
                   for name in os.listdir(tmp_path / "ckpt"))
    _step, got, _loader = ckpt.restore(state)
    numpy.testing.assert_array_equal(got["x"], state["x"])


def test_restoring_onto_another_rank_count_names_7d(tmp_path,
                                                     monkeypatch):
    """Once refused naming item 7(d): a step recorded as saved by 2
    ranks restores in this one-rank process, onto a sharded abstract
    leaf too (a one-rank mesh: the whole array)."""
    from veles_tpu_torch.parallel.mesh import Sharding, make_mesh
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    state = {"x": numpy.arange(4, dtype=numpy.float32)}
    monkeypatch.setattr(checkpoint, "_world_size", lambda: 2)
    ckpt.save(1, state)
    monkeypatch.undo()
    with open(tmp_path / "ckpt" / "1" / "meta.json") as fin:
        assert json.load(fin)["world_size"] == 2
    _step, got, _loader = ckpt.restore(state)
    numpy.testing.assert_array_equal(got["x"], state["x"])
    mesh = make_mesh({"data": -1})
    _step, got, _loader = ckpt.restore({"x": ArraySpec(
        (4,), numpy.float32, "cpu", Sharding(mesh, ("data",)))})
    numpy.testing.assert_array_equal(got["x"].numpy(), state["x"])


# -- across rank counts --------------------------------------------------------

#: the pod parity gate's tolerance (test_pod.py:186)
TRAINED_TOL = 5e-5


@pytest.fixture(scope="module")
def across(tmp_path_factory):
    """Saved by 2 ranks, restored by 4 (ranks) and by 1 (this process)."""
    import torch_ranks
    from veles_tpu_torch.checkpoint import ArraySpec as Spec
    from veles_tpu_torch.parallel.mesh import Sharding, make_mesh
    from veles_tpu_torch.pod.__main__ import make_workflow
    base = tmp_path_factory.mktemp("across")
    inputs = {"ckpt_dir": str(base / "ckpt")}
    (base / "save").mkdir()
    (base / "restore").mkdir()
    saved = torch_ranks.run_world(2, ("ckpt_save",), inputs,
                                  base / "save")
    restored4 = torch_ranks.run_world(4, ("ckpt_restore",), inputs,
                                      base / "restore")
    mesh = make_mesh({"data": -1})
    abstract = {n: Spec((8, 8), numpy.float32, "cpu",
                        Sharding(mesh, ("data", None)))
                for n in ("w", "vw")}
    abstract["step_scale"] = Spec((), numpy.float32, None)
    ckpt = TrainCheckpointer(inputs["ckpt_dir"])
    _s, one, loader = ckpt.restore(abstract, step=1)
    wf = make_workflow(max_epochs=1, device="cpu")
    abstract_train, _m = wf.capture_train_state()
    _s, train, meta = ckpt.restore(abstract_train, step=2)
    wf.restore_train_state(train, meta)
    one_train, _m = wf.capture_train_state()
    return {"saved": [r["ckpt_save"] for r in saved],
            "four": [r["ckpt_restore"] for r in restored4],
            "one": {"w": one["w"].numpy(), "vw": one["vw"].numpy(),
                    "loader": loader, "train": one_train}}


@pytest.fixture(scope="module")
def jax_restored(tmp_path_factory):
    """The JAX TrainCheckpointer's restore of the 8x8 state saved over 8
    devices and restored over 2, and of the seeded task's train state
    after one single-device epoch."""
    import jax
    from veles_tpu.checkpoint import TrainCheckpointer as JaxCheckpointer
    from veles_tpu.parallel import make_mesh as jax_make_mesh
    from veles_tpu.pod import train_epochs
    from veles_tpu.pod.__main__ import make_workflow
    P = jax.sharding.PartitionSpec
    named = jax.sharding.NamedSharding
    base = tmp_path_factory.mktemp("jax_across")
    mesh8 = jax_make_mesh({"data": 8})
    sharding = named(mesh8, P("data", None))
    state = {"w": jax.device_put(numpy.arange(64, dtype=numpy.float32)
                                 .reshape(8, 8), sharding),
             "vw": jax.device_put(numpy.zeros((8, 8), numpy.float32),
                                  sharding),
             "step_scale": numpy.float32(0.5)}
    ckpt = JaxCheckpointer(str(base / "ckpt"))
    ckpt.save(1, state)
    wf = make_workflow(max_epochs=1)
    for _ in train_epochs(wf, 1):
        pass
    train, _meta = wf.capture_train_state()
    ckpt.save(2, train)
    ckpt.close()
    mesh2 = jax_make_mesh({"data": 2}, devices=jax.devices()[:2])
    abstract = {
        "w": jax.ShapeDtypeStruct((8, 8), numpy.float32,
                                  sharding=named(mesh2, P("data", None))),
        "vw": jax.ShapeDtypeStruct((8, 8), numpy.float32,
                                   sharding=named(mesh2, P(None, "data"))),
        "step_scale": jax.ShapeDtypeStruct((), numpy.float32)}
    ckpt = JaxCheckpointer(str(base / "ckpt"))
    _s, got, _l = ckpt.restore(abstract, step=1)
    _s, got_train, _l = ckpt.restore(train, step=2)
    ckpt.close()
    return {"w": numpy.asarray(got["w"]), "vw": numpy.asarray(got["vw"]),
            "train": {k: {n: numpy.asarray(v) for n, v in d.items()}
                      for k, d in got_train.items()}}


def test_saved_by_2_restored_by_4_equals_jax(across, jax_restored):
    for rank, got in enumerate(across["four"]):
        assert got["step"] == 1
        assert got["loader"] == {"epoch": 2, "offset": 40}
        assert got["step_scale"] == 0.5
        for name in ("w", "vw"):
            numpy.testing.assert_array_equal(got["whole"][name],
                                             jax_restored[name])
        # the new placement: rows of w, columns of vw
        numpy.testing.assert_array_equal(
            got["local"]["w"], jax_restored["w"][2 * rank:2 * rank + 2])
        numpy.testing.assert_array_equal(
            got["local"]["vw"], jax_restored["vw"][:, 2 * rank:2 * rank + 2])


def test_saved_by_2_restored_by_1_equals_jax(across, jax_restored):
    assert across["one"]["loader"] == {"epoch": 2, "offset": 40}
    for name in ("w", "vw"):
        numpy.testing.assert_array_equal(across["one"][name],
                                         jax_restored[name])


@pytest.mark.parametrize("ranks", ["four", "one"])
def test_fsdp_train_state_restores_on_another_rank_count(across,
                                                        jax_restored, ranks):
    saved = across["saved"][0]["train"]
    want = jax_restored["train"]
    restored = [r["train"] for r in across["four"]] \
        if ranks == "four" else [across["one"]["train"]]
    assert sorted(saved) == sorted(want)
    for train in restored:
        assert sorted(train) == sorted(saved)
        for key, arrays in saved.items():
            for name, value in arrays.items():
                # restored as saved, bit for bit, on any rank count
                numpy.testing.assert_array_equal(train[key][name], value)
                numpy.testing.assert_allclose(
                    train[key][name], want[key][name], rtol=0,
                    atol=TRAINED_TOL)
    if ranks == "four":
        for got in across["four"]:
            assert got["shards"] == 4 and got["sharded_leaves"] > 0


def test_the_restore_copies_what_it_installs():
    prng.seed_all(5)
    wf = mnist.create_workflow(device="cpu", max_epochs=1)
    wf.run()
    train, meta = wf.capture_train_state()
    kept = {k: {kk: v.copy() for kk, v in d.items()}
            for k, d in train.items()}
    prng.seed_all(5)
    fresh = mnist.create_workflow(device="cpu", max_epochs=3)
    fresh.restore_train_state(train, meta)
    fresh.decision.complete <<= False
    fresh.run()                  # trains and reshuffles in place
    for key, arrays in kept.items():
        for name, value in arrays.items():
            numpy.testing.assert_array_equal(train[key][name], value)
