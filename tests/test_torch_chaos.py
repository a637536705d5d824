"""The port's fault injection (``veles_tpu_torch.chaos``) and the
robustness of its job layer, on the CPU: the counterparts of
``tests/test_chaos.py``'s tests, in the same words.

- The fault model: schedules validate and round-trip through JSON, the
  same seed gives the same decisions, ``nth`` fires once, a partition
  window swallows a site's frames and heals, corrupted bytes break a
  pickle the same way every time.
- Exactly-once updates: a replayed update frame changes the weights
  once; an older generation's update is rejected and logged; a session
  whose only faults are duplicated update frames ends bit-equal to the
  clean one; a dropped job frame is requeued; a partition degrades the
  session and the slave rejoins.
- Master crash recovery: the train state round-trips through a
  ``TrainCheckpointer`` into a fresh workflow, and the gate (a slave
  kill, a dropped job frame, a duplicated update and a master kill with a
  resume from the checkpoint) completes with every applied job applied
  once, within one checkpoint interval of the kill, converging as the
  clean run does, with the chaos and recovery events in the session
  bundle.  ``python -m veles_tpu_torch.chaos --smoke`` passes.
"""

import logging
import pickle
import threading
import time

import numpy
import pytest
import torch

from veles_tpu_torch import chaos, prng
from veles_tpu_torch.backends import CPUDevice
from veles_tpu_torch.chaos.core import ChaosSchedule, Fault
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.parallel.jobs import (JobClient, JobServer,
                                           SlaveDescription)
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _disarm_after():
    """Every test leaves the process-wide controller disarmed."""
    yield
    chaos.controller.disarm()


@pytest.fixture
def live_trace():
    """The trace knob on: the workflows built in the test enable the
    recorder at initialize()."""
    from veles_tpu_torch import trace
    saved = root.common.engine.get("trace", "off")
    root.common.engine.trace = "on"
    trace.recorder.clear()
    trace.configure()
    yield trace
    root.common.engine.trace = saved
    trace.configure()
    trace.recorder.clear()


class ChaosDistLoader(FullBatchLoader):
    def load_data(self):
        rng = numpy.random.default_rng(5)
        n = 200
        labels = (numpy.arange(n) % 5).astype(int)
        centers = rng.standard_normal((5, 16)) * 3
        self.original_data.mem = (
            centers[labels] + rng.standard_normal((n, 16)) * 0.5
        ).astype(numpy.float32)
        self.original_labels = [int(v) for v in labels]
        self.class_lengths[:] = [0, 50, 150]


CHAOS_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 12},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 5},
     "<-": {"learning_rate": 0.05}},
]


def make_wf(is_master=False, is_slave=False, max_epochs=3):
    prng.seed_all(21)
    wf = StandardWorkflow(
        None,
        loader_factory=lambda w: ChaosDistLoader(w, minibatch_size=25),
        layers=[{**s} for s in CHAOS_LAYERS],
        decision_config={"max_epochs": max_epochs})
    wf.launcher = DummyLauncher(is_master=is_master, is_slave=is_slave)
    wf.initialize(device=CPUDevice())
    return wf


def final_metrics(wf):
    return {"best_n_err_pt": float(wf.decision.best_n_err_pt),
            "best_epoch": int(wf.decision.best_epoch),
            "epochs": int(wf.loader.epoch_number),
            "complete": bool(wf.decision.complete)}


def master_weights(wf):
    return numpy.array(wf.forwards[0].weights.mem)


# -- the fault model ------------------------------------------------------------

def test_fault_validation_and_schedule_roundtrip():
    with pytest.raises(ValueError):
        Fault("master_send", "explode", nth=1)
    with pytest.raises(ValueError):        # two selectors
        Fault("master_send", "drop", nth=1, prob=0.5)
    with pytest.raises(ValueError):        # no selector
        Fault("master_send", "drop")
    with pytest.raises(ValueError):        # no receive-side dup
        Fault("slave_recv", "dup", nth=1)
    sched = ChaosSchedule([
        {"site": "master_send", "action": "drop", "op": "job", "nth": 2},
        {"site": "slave_send", "action": "dup", "op": "update",
         "every": 3, "count": 2},
        {"site": "slave_job", "action": "slave_kill", "prob": 0.25},
    ])
    clone = ChaosSchedule.from_json(sched.to_json())
    assert [f.to_dict() for f in clone] == [f.to_dict() for f in sched]
    assert clone.faults[1].count == 2


def test_deterministic_wire_decisions_given_seed():
    """The same (seed, schedule) gives the same decisions over the same
    calls; the JAX package's controller makes them too."""
    from veles_tpu import chaos as jax_chaos

    def decisions(ctl):
        out = []
        for i in range(200):
            plan = ctl.wire("master_send", "job" if i % 3 else "update")
            out.append((plan.deliveries, plan.corrupt,
                        round(plan.delay_s, 6)))
        return out

    schedule = [{"site": "master_send", "action": "drop", "op": "job",
                 "prob": 0.2},
                {"site": "master_send", "action": "dup", "op": "update",
                 "prob": 0.3}]
    a = chaos.ChaosController()
    a.arm(list(schedule), seed=99)
    b = chaos.ChaosController()
    b.arm(list(schedule), seed=99)
    da, db = decisions(a), decisions(b)
    assert da == db
    assert any(p[0] == 0 for p in da), "seeded drops must have fired"
    assert any(p[0] > 1 for p in da), "seeded dups must have fired"
    j = jax_chaos.ChaosController()
    j.arm(list(schedule), seed=99)
    assert decisions(j) == da
    c = chaos.ChaosController()
    c.arm(list(schedule), seed=100)
    assert decisions(c) != da, "a different seed is a different run"


def test_nth_fires_exactly_once_and_partition_window():
    ctl = chaos.ChaosController()
    ctl.arm([{"site": "slave_send", "action": "drop", "op": "update",
              "nth": 3}])
    plans = [ctl.wire("slave_send", "update") for _ in range(6)]
    assert [p.deliveries for p in plans] == [1, 1, 0, 1, 1, 1]
    assert ctl.injected.get("drop") == 1

    ctl.arm([{"site": "master_recv", "action": "partition", "nth": 1,
              "duration_s": 0.2}])
    assert ctl.wire("master_recv", "update").deliveries == 0
    assert ctl.wire("master_recv", "ping").deliveries == 0, \
        "an op-less partition swallows EVERY frame at the site"
    assert ctl.wire("slave_send", "update").deliveries == 1, \
        "other sites are unaffected"
    time.sleep(0.25)
    assert ctl.wire("master_recv", "update").deliveries == 1, \
        "the window heals"


def test_corrupt_bytes_breaks_pickle_deterministically():
    from veles_tpu import chaos as jax_chaos
    blob = pickle.dumps({"op": "update", "data": [1, 2, 3]})
    mangled = chaos.ChaosController.corrupt_bytes(blob)
    assert mangled == chaos.ChaosController.corrupt_bytes(blob)
    assert mangled == jax_chaos.ChaosController.corrupt_bytes(blob)
    assert mangled != blob


# -- exactly-once updates ------------------------------------------------------

def _train_job(server, master_wf, slave_wf, slave):
    """Past the two validation minibatches (their deltas are zero), one
    TRAIN job outstanding: (seq, its update)."""
    for _ in range(2):
        updates = []
        slave_wf.do_job(master_wf.generate_data_for_slave(slave),
                        updates.append)
        master_wf.apply_data_from_slave(updates[0], slave)
    with server._lock:
        server._seq += 1
        seq = server._seq
        data = master_wf.generate_data_for_slave(slave)
        slave.outstanding[seq] = time.time()
    updates = []
    slave_wf.do_job(data, updates.append)
    return seq, updates[0]


def test_update_replay_applies_exactly_once():
    """Replaying a captured update frame twice changes the weights
    EXACTLY once."""
    master_wf = make_wf(is_master=True)
    slave_wf = make_wf(is_slave=True)
    server = JobServer(master_wf)        # not started: direct dispatch
    try:
        slave = SlaveDescription("s1")
        server.slaves["s1"] = slave
        seq, update = _train_job(server, master_wf, slave_wf, slave)
        msg = {"op": "update", "id": "s1", "data": update,
               "job": {"gen": server.generation, "epoch": 0, "seq": seq},
               "req": 1}
        w0 = master_weights(master_wf)
        server._on_update(b"s1", slave, dict(msg))
        w1 = master_weights(master_wf)
        assert not numpy.array_equal(w0, w1), "first copy must apply"
        server._on_update(b"s1", slave, dict(msg))   # captured replay
        numpy.testing.assert_array_equal(w1, master_weights(master_wf))
        server._on_update(b"s1", slave, dict(msg))   # and again
        numpy.testing.assert_array_equal(w1, master_weights(master_wf))
        assert server.dedup_dropped == 2
        assert server._updates_applied == 1
    finally:
        server.stop()


def test_stale_generation_update_rejected_and_logged(caplog):
    """A pre-restart slave's update (an older generation) is rejected,
    logged and counted, never applied."""
    master_wf = make_wf(is_master=True)
    slave_wf = make_wf(is_slave=True)
    server = JobServer(master_wf)
    try:
        slave = SlaveDescription("s1")
        server.slaves["s1"] = slave
        seq, update = _train_job(server, master_wf, slave_wf, slave)
        server.generation = 2            # "the master restarted"
        w0 = master_weights(master_wf)
        with caplog.at_level(logging.WARNING):
            server._on_update(b"s1", slave, {
                "op": "update", "id": "s1", "data": update,
                "job": {"gen": 1, "epoch": 0, "seq": seq}, "req": 1})
        numpy.testing.assert_array_equal(w0, master_weights(master_wf))
        assert server.stale_rejected == 1
        assert server._updates_applied == 0
        assert any("stale" in r.getMessage() for r in caplog.records)
        acks = [pickle.loads(blob) for _ident, blob in server._outbox]
        assert acks and acks[-1]["ok"] == 0 and acks[-1]["stale"] == 1
    finally:
        server.stop()


def _clean_and_dup_sessions():
    def run_session(schedule=None):
        if schedule is not None:
            chaos.controller.arm(schedule, seed=11)
        master_wf = make_wf(is_master=True)
        slave_wf = make_wf(is_slave=True)
        server = JobServer(master_wf).start()
        try:
            client = JobClient(slave_wf, server.endpoint,
                               rpc_timeout_ms=2000)
            client.handshake()
            assert client.run() is True
            client.close()
        finally:
            server.stop()
            chaos.controller.disarm()
        return master_wf, server

    clean = run_session()
    dup = run_session([
        {"site": "slave_send", "action": "dup", "op": "update", "nth": 2},
        {"site": "slave_send", "action": "dup", "op": "update", "nth": 9,
         "count": 2},
    ])
    return clean, dup


def test_duplicated_update_frames_exact_parity():
    """A run whose only faults are duplicated update frames ends with
    weights BITWISE equal to the clean run's."""
    (clean_wf, _clean_srv), (dup_wf, dup_srv) = _clean_and_dup_sessions()
    assert dup_srv.dedup_dropped == 3, \
        "1 + 2 extra copies must all be deduplicated"
    for got, want in zip(dup_wf.params_to_numpy().items(),
                         clean_wf.params_to_numpy().items()):
        assert got[0] == want[0]
        numpy.testing.assert_array_equal(got[1], want[1])
    assert final_metrics(clean_wf) == final_metrics(dup_wf)
    assert dup_wf.decision.history == clean_wf.decision.history


def test_dropped_job_frame_requeued_session_completes():
    """A job frame lost on the wire is one requeued job: the client
    times out, rejoins, the master requeues the lost seq from the
    ``have`` list, and every job still applies exactly once."""
    from veles_tpu_torch.chaos.__main__ import SmokeMaster, SmokeSlave
    chaos.controller.arm([
        {"site": "master_send", "action": "drop", "op": "job", "nth": 2},
    ], seed=3)
    master = SmokeMaster(6)
    server = JobServer(master, slave_timeout=6.0,
                       heartbeat_interval=0.3).start()
    try:
        client = JobClient(SmokeSlave(), server.endpoint,
                           rpc_timeout_ms=700, reconnect_max_wait=10.0)
        client.handshake()
        assert client.run() is True
        client.close()
    finally:
        server.stop()
    assert sorted(master.applied) == [1, 2, 3, 4, 5, 6]
    assert server.lost_requeued >= 1
    assert master.requeues >= 1


def test_partition_heal_degrades_then_rejoins():
    """A partitioned slave is reaped (its work requeued); when the window
    heals its next contact is refused as unknown and it handshakes back
    in; every job still applies exactly once."""
    from veles_tpu_torch.chaos.__main__ import SmokeMaster, SmokeSlave
    chaos.controller.arm([
        # frame 5 is job 2's update (handshake, request, update,
        # request, update): the slave holds an unacked job when the
        # master goes deaf for 2.5 s
        {"site": "master_recv", "action": "partition", "nth": 5,
         "duration_s": 2.5},
    ], seed=5)
    master = SmokeMaster(8)
    server = JobServer(master, slave_timeout=1.0,
                       heartbeat_interval=0.3).start()
    try:
        client = JobClient(SmokeSlave(), server.endpoint,
                           rpc_timeout_ms=600, reconnect_max_wait=20.0)
        client.handshake()
        assert client.run() is True
        client.close()
    finally:
        server.stop()
    assert sorted(master.applied) == list(range(1, 9)), master.applied
    assert master.requeues >= 1, \
        "the reaped slave's in-flight work must have been requeued"
    assert chaos.controller.injected.get("partition") == 1


# -- master crash recovery -------------------------------------------------------

def test_capture_restore_train_state_roundtrip(tmp_path):
    """Weights, the loader's cursor and the Decision's accounting survive
    a TrainCheckpointer round trip into a FRESH workflow."""
    from veles_tpu_torch.checkpoint import TrainCheckpointer
    wf = make_wf(is_master=True)
    slave_wf = make_wf(is_slave=True)
    slave = SlaveDescription("s1")
    for _ in range(5):
        updates = []
        slave_wf.do_job(wf.generate_data_for_slave(slave), updates.append)
        wf.apply_data_from_slave(updates[0], slave)
    # one job handed out, never answered: in flight at the capture
    wf.generate_data_for_slave(slave)
    wf.decision.best_n_err_pt = 12.5
    wf.decision.best_epoch = 1
    train, meta = wf.capture_train_state()
    assert any("weights" in v for v in train.values())
    ckpt = TrainCheckpointer(str(tmp_path / "ck"))
    ckpt.save(5, train, meta)

    fresh = make_wf(is_master=True)
    assert not numpy.array_equal(master_weights(fresh), master_weights(wf))
    abstract, _ = fresh.capture_train_state()
    step, train2, meta2 = ckpt.restore(abstract)
    ckpt.close()
    assert step == 5
    fresh.restore_train_state(train2, meta2)
    numpy.testing.assert_array_equal(master_weights(fresh),
                                     master_weights(wf))
    assert fresh.loader.epoch_number == wf.loader.epoch_number
    assert fresh.loader.global_offset == wf.loader.global_offset
    assert fresh.decision.best_n_err_pt == 12.5
    assert fresh.decision.best_epoch == 1
    assert fresh.loader.failed_minibatches, \
        "pending/failed minibatches must survive the checkpoint"
    numpy.testing.assert_array_equal(
        numpy.array(fresh.loader.shuffled_indices.mem),
        numpy.array(wf.loader.shuffled_indices.mem))


#: the gate's seeded schedule: a slave killed holding its 2nd job, the
#: 5th job frame dropped, the 4th update frame duplicated
GATE_SCHEDULE = [
    {"site": "slave_job", "action": "slave_kill", "nth": 2},
    {"site": "master_send", "action": "drop", "op": "job", "nth": 5},
    {"site": "slave_send", "action": "dup", "op": "update", "nth": 4},
]
GATE_CHECKPOINT_EVERY = 3
#: the job of the surviving slave that waits for the master's kill
GATE_HOLD_AT = 8


def test_chaos_parity_gate(live_trace, tmp_path):
    """THE gate: the seeded schedule plus one master kill and resume
    mid-run.  The session completes; every applied job seq is applied
    once; the resume restarts within one checkpoint interval of the kill
    (one more for a trigger skipped while a write was in flight, and the
    updates that landed before the socket closed); the result converges
    as the clean run does; the chaos instants, the checkpoint spans and
    the resume marker are in the session bundle."""
    from veles_tpu_torch import prof, trace

    # ---- the clean reference run
    ref_master = make_wf(is_master=True)
    ref_slave = make_wf(is_slave=True)
    server = JobServer(ref_master).start()
    try:
        client = JobClient(ref_slave, server.endpoint, rpc_timeout_ms=2000)
        client.handshake()
        assert client.run() is True
        client.close()
    finally:
        server.stop()
    reference = final_metrics(ref_master)
    assert reference["complete"]

    # ---- the chaos run
    chaos.controller.arm(list(GATE_SCHEDULE), seed=7)
    m1 = make_wf(is_master=True)
    ckdir = str(tmp_path / "ck")
    server1 = JobServer(m1, checkpoint_dir=ckdir,
                        checkpoint_every=GATE_CHECKPOINT_EVERY,
                        slave_timeout=5.0, heartbeat_interval=0.3).start()
    port = server1.port
    # slave A: scheduled to die holding its 2nd job
    cA = JobClient(make_wf(is_slave=True), server1.endpoint,
                   rpc_timeout_ms=1200, reconnect_max_wait=10.0)
    cA.handshake()
    assert cA.run() is False, "the scheduled slave kill must fire"
    cA.close()
    # slave B: survives the master kill through its reconnect backoff;
    # its HOLD_AT-th job waits for the kill, so the kill lands mid-run
    # after the lost frame's requeue and a checkpoint
    sB = make_wf(is_slave=True)
    killed = threading.Event()
    jobs_seen = []
    do_job = sB.do_job

    def held_do_job(data, callback):
        jobs_seen.append(1)
        if len(jobs_seen) == GATE_HOLD_AT:
            killed.wait(60)
        do_job(data, callback)
    sB.do_job = held_do_job
    cB = JobClient(sB, server1.endpoint, rpc_timeout_ms=1200,
                   reconnect_max_wait=25.0)
    cB.handshake()
    done = []
    runner = threading.Thread(target=lambda: done.append(cB.run()))
    runner.start()
    deadline = time.time() + 60
    while time.time() < deadline and not (
            len(jobs_seen) >= GATE_HOLD_AT and server1.lost_requeued
            and server1._ckpt is not None
            and not server1._ckpt_busy.is_set()
            and server1._checkpointer().latest_step() is not None):
        time.sleep(0.02)
    ckpt_step = server1._checkpointer().latest_step()
    assert ckpt_step is not None, "no checkpoint completed before kill"
    killed_at = server1._updates_applied
    server1.kill()
    killed.set()

    # the restarted process: a fresh master resumes the latest
    # checkpoint on the same port
    m2 = make_wf(is_master=True)
    server2 = JobServer(m2, port=port, checkpoint_dir=ckdir,
                        checkpoint_every=GATE_CHECKPOINT_EVERY,
                        slave_timeout=5.0, heartbeat_interval=0.3)
    resumed_step = server2.resume_from_checkpoint()
    assert server2.generation == 2
    assert killed_at - resumed_step <= 2 * GATE_CHECKPOINT_EVERY + 1, \
        (killed_at, resumed_step)
    server2.start()
    try:
        runner.join(120)
        assert not runner.is_alive(), "chaos session hung"
        assert done == [True], "the surviving slave must finish the run"
        cB.close()
    finally:
        server2.stop()
        chaos.controller.disarm()

    # exactly once: within each generation every seq applied once
    for srv in (server1, server2):
        seqs = list(srv._applied_order)
        assert len(seqs) == len(set(seqs)) == srv._updates_applied - (
            resumed_step if srv is server2 else 0), seqs
    result = final_metrics(m2)
    assert result["complete"], "the resumed session must end at the " \
        "same stop criterion"
    assert result["epochs"] >= reference["epochs"]
    assert abs(result["best_n_err_pt"] - reference["best_n_err_pt"]) \
        <= 2.0, (result, reference)
    injected = chaos.controller.snapshot()["injected"]
    assert injected.get("slave_kill") == 1
    assert injected.get("dup", 0) >= 1
    assert injected.get("drop", 0) >= 1
    assert server1.dedup_dropped + server2.dedup_dropped \
        >= injected.get("dup", 0)
    assert server1.lost_requeued >= 1

    # ---- the chaos and recovery events in the merged timeline
    assert trace.recorder.count("jobs", "checkpoint") >= 1
    assert trace.recorder.count("jobs", "resume") == 1
    assert trace.recorder.category_counts().get("chaos", 0) >= 3
    bundle_path = str(tmp_path / "chaos_session.json")
    server2.save_session_profile(bundle_path, roles=("master",))
    bundle = prof.merge.load(bundle_path)
    merged = prof.merge.merged_events(bundle)
    names = {(ev.get("cat"), ev.get("name")) for ev in merged}
    assert "chaos" in {ev.get("cat") for ev in merged}
    assert ("jobs", "resume") in names
    assert ("jobs", "checkpoint") in names


def test_the_smoke_gate_passes(capsys):
    """``python -m veles_tpu_torch.chaos --smoke``'s session: a slave
    death, a dropped job frame and a duplicated update, every job
    applied once."""
    from veles_tpu_torch.chaos.__main__ import run_smoke
    assert run_smoke() == 0
    out = capsys.readouterr().out
    assert "12/12 jobs applied exactly once" in out
