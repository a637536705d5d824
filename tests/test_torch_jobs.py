"""The port's master–slave job layer (``veles_tpu_torch.parallel.jobs``
over the standard library's TCP wire), on the CPU.

The counterparts of ``tests/test_jobs.py``'s tests, in the same words:
scripted workflows first (the handshake and the job/update cycle, the
checksum refusal, two slaves sharing the jobs, a dead slave's work
requeued, the stop on a complete Decision, the prefetching loop, the
stale-reply skips against a fake master on a bare
:class:`~veles_tpu_torch.parallel.wire.Router`, blacklisting, the
advertised power and the latency percentiles), then distributed
training of a small StandardWorkflow, stitched and fused.

Then the port against the JAX package: a one-slave synchronous session
(``client.run()``) of the same small task from one seed (the masters'
initial weights and shuffled indices equal), f32 at precision level 2,
stitched and fused, for 2 epochs, in both packages: the master's weights
within ``PARAM_RTOL`` (1e-5 of their largest magnitude), the Decision's
per-class error counts at every close equal, and the job seqs served and
applied equal.  The JAX side runs its eager chain synchronously
(``engine.kernels=xla``, ``stitch=off``; its fused trainer jitted).  A
JAX master refuses a port slave at the handshake and a port master a
JAX slave: their workflows' checksums cover different files.  The slave's
job surgery (one pass a job: the back edge gone, the end point open, the
segments stitched again) and its uploads (one in-place upload a weight
and a bias and one for the indices a job) are checked here too, and so
is the wire itself (routing by connection, whole frames, a broken
length, a reconnect to a restarted master).
"""

import pickle
import threading
import time

import jax
import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.config import root as jax_root
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
from veles_tpu.loader.fullbatch import FullBatchLoader as JaxFullBatch
from veles_tpu.memory import Vector as JaxVector
from veles_tpu.parallel import jobs as jax_jobs
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.backends import CPUDevice
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.memory import Watcher
from veles_tpu_torch.parallel import wire
from veles_tpu_torch.parallel.jobs import JobClient, JobServer
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

PARAM_RTOL = 1e-5


class ScriptedMaster(object):
    """N jobs; records the updates and the dropped slaves."""

    def __init__(self, n_jobs=5):
        self.n_jobs = n_jobs
        self.served = 0
        self.updates = []
        self.dropped = []

    def checksum(self):
        return "scripted-v1"

    def generate_data_for_slave(self, slave):
        if self.served >= self.n_jobs:
            return None
        self.served += 1
        return {"job_number": self.served}

    def apply_data_from_slave(self, data, slave):
        self.updates.append((slave.id, data))

    def drop_slave(self, slave):
        self.dropped.append(slave.id)


class ScriptedSlave(object):
    def __init__(self, checksum="scripted-v1"):
        self._checksum = checksum
        self.jobs = []

    def checksum(self):
        return self._checksum

    def do_job(self, data, callback):
        self.jobs.append(data)
        callback({"result": data["job_number"] * 10})


def test_handshake_job_update_cycle():
    master = ScriptedMaster(n_jobs=3)
    server = JobServer(master).start()
    try:
        client = JobClient(ScriptedSlave(), server.endpoint)
        client.handshake()
        assert client.run()
        client.close()
        assert master.served == 3
        assert len(master.updates) == 3
        assert master.updates[0][1] == {"result": 10}
    finally:
        server.stop()


def test_checksum_mismatch_rejected():
    master = ScriptedMaster()
    server = JobServer(master).start()
    try:
        client = JobClient(ScriptedSlave(checksum="other"),
                           server.endpoint)
        with pytest.raises(ConnectionError):
            client.handshake()
        client.close()
    finally:
        server.stop()


def test_two_slaves_share_jobs():
    master = ScriptedMaster(n_jobs=10)
    server = JobServer(master).start()
    try:
        clients = [JobClient(ScriptedSlave(), server.endpoint)
                   for _ in range(2)]
        threads = []
        for client in clients:
            client.handshake()
            t = threading.Thread(target=client.run)
            threads.append(t)
            t.start()
        for t in threads:
            t.join(20)
            assert not t.is_alive()
        assert len(master.updates) == 10
        assert sorted(u["result"] for _, u in master.updates) == \
            [i * 10 for i in range(1, 11)]
        for client in clients:
            client.close()
    finally:
        server.stop()


def test_dead_slave_requeued():
    """A slave dies mid-job → the reaper times it out → drop_slave."""
    master = ScriptedMaster(n_jobs=3)
    server = JobServer(master, slave_timeout=1.0,
                       heartbeat_interval=0.3).start()
    try:
        dead = JobClient(ScriptedSlave(), server.endpoint,
                         death_probability=1.0)
        dead.handshake()
        assert dead.run() is False      # died mid-job
        deadline = time.time() + 5
        while not master.dropped and time.time() < deadline:
            time.sleep(0.1)
        assert master.dropped
        dead.close()
    finally:
        server.stop()


# -- distributed training of a small task ----------------------------------

def _load(self):
    rng = numpy.random.default_rng(5)
    n = 200
    labels = (numpy.arange(n) % 5).astype(int)
    centers = rng.standard_normal((5, 16)) * 3
    self.original_data.mem = (
        centers[labels] + rng.standard_normal((n, 16)) * 0.5
    ).astype(numpy.float32)
    self.original_labels = [int(v) for v in labels]
    self.class_lengths[:] = [0, 50, 150]


class DistLoader(FullBatchLoader):
    load_data = _load


class JaxDistLoader(JaxFullBatch):
    load_data = _load


DIST_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 12},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 5},
     "<-": {"learning_rate": 0.05}},
]


def make_dist_wf(is_master=False, is_slave=False, fused=False,
                 fused_config=None, max_epochs=3):
    prng.seed_all(21)
    wf = StandardWorkflow(
        None,
        loader_factory=lambda w: DistLoader(w, minibatch_size=25),
        layers=[{**s} for s in DIST_LAYERS],
        fused=fused, fused_config=fused_config or {},
        decision_config={"max_epochs": max_epochs})
    wf.launcher = DummyLauncher(is_master=is_master, is_slave=is_slave)
    wf.initialize(device=CPUDevice())
    return wf


def test_distributed_training_end_to_end():
    master_wf = make_dist_wf(is_master=True)
    slave_wf = make_dist_wf(is_slave=True)
    assert master_wf.checksum() == slave_wf.checksum()
    w_before = numpy.array(master_wf.forwards[0].weights.mem)

    server = JobServer(master_wf).start()
    try:
        client = JobClient(slave_wf, server.endpoint)
        client.handshake()
        client.run(max_jobs=24)        # 3 epochs × 8 minibatches
        client.close()
        assert client.jobs_done > 0
        w_after = numpy.array(master_wf.forwards[0].weights.mem)
        assert not numpy.allclose(w_before, w_after), \
            "slave deltas must reach master weights"
        # the master's Decision accounted the distributed counts
        assert master_wf.decision.history
        assert master_wf.decision.best_n_err_pt < 100.0
    finally:
        server.stop()


def test_distributed_training_fused_end_to_end():
    master_wf = make_dist_wf(is_master=True, fused=True)
    slave_wf = make_dist_wf(is_slave=True, fused=True)
    assert master_wf.checksum() == slave_wf.checksum()
    w_before = numpy.array(master_wf.forwards[0].weights.mem)

    server = JobServer(master_wf).start()
    try:
        client = JobClient(slave_wf, server.endpoint)
        client.handshake()
        client.run(max_jobs=24)
        client.close()
        assert client.jobs_done > 0
        # the slave built and trained its fused step
        assert slave_wf.fused_trainer.capture_state() is not None
        w_after = numpy.array(master_wf.forwards[0].weights.mem)
        assert not numpy.allclose(w_before, w_after), \
            "fused slave deltas must reach master weights"
    finally:
        server.stop()


def _one_epoch_of_jobs(master_wf, slave_wf):
    """One epoch (2 validation + 6 train minibatches) socket-free, each
    update merged as the master does."""
    for _ in range(8):
        updates = []
        slave_wf.do_job(master_wf.generate_data_for_slave(None),
                        updates.append)
        assert updates and updates[0] is not None
        master_wf.apply_data_from_slave(updates[0], None)


def test_fused_job_protocol_reseeds_and_syncs():
    master_wf = make_dist_wf(is_master=True, fused=True)
    slave_wf = make_dist_wf(is_slave=True, fused=True)
    w0 = numpy.array(master_wf.forwards[0].weights.mem)
    _one_epoch_of_jobs(master_wf, slave_wf)
    w1 = numpy.array(master_wf.forwards[0].weights.mem)
    assert not numpy.allclose(w0, w1)
    # the master's merged weights are the slave's trained ones (deltas
    # from one starting point; a float add round trip)
    numpy.testing.assert_allclose(
        w1, numpy.array(slave_wf.forwards[0].weights.mem),
        rtol=1e-5, atol=1e-6)
    # the next job's weights reach the ALREADY-BUILT fused parameters
    master_wf.forwards[0].weights.map_write()
    master_wf.forwards[0].weights.mem[...] = 0.123
    slave_wf.apply_data_from_master(
        master_wf.generate_data_for_slave(None))
    state = slave_wf.fused_trainer.capture_state()
    numpy.testing.assert_allclose(
        numpy.asarray(state[0]["w"], numpy.float32), 0.123, atol=1e-6)


def test_fused_pod_slice_slave_on_mesh():
    """A slave whose fused step runs over a ``data`` mesh (one process
    here) against a plain master: the checksum covers code and graph,
    not the mesh, and the job payloads enter its parameters."""
    master_wf = make_dist_wf(is_master=True, fused=True)
    slave_wf = make_dist_wf(is_slave=True, fused=True,
                            fused_config={"mesh_axes": {"data": -1}})
    assert master_wf.checksum() == slave_wf.checksum()
    w0 = numpy.array(master_wf.forwards[0].weights.mem)
    _one_epoch_of_jobs(master_wf, slave_wf)
    w1 = numpy.array(master_wf.forwards[0].weights.mem)
    assert not numpy.allclose(w0, w1)
    numpy.testing.assert_allclose(
        w1, numpy.array(slave_wf.forwards[0].weights.mem),
        rtol=1e-5, atol=1e-6)
    master_wf.forwards[0].weights.map_write()
    master_wf.forwards[0].weights.mem[...] = 0.25
    slave_wf.apply_data_from_master(
        master_wf.generate_data_for_slave(None))
    state = slave_wf.fused_trainer.capture_state()
    numpy.testing.assert_allclose(
        numpy.asarray(state[0]["w"], numpy.float32), 0.25, atol=1e-6)


def test_fused_refresh_preserves_solver_state():
    """refresh_from_forwards overwrites only w and b: the momenta stay
    the slave's."""
    master_wf = make_dist_wf(is_master=True, fused=True)
    slave_wf = make_dist_wf(is_slave=True, fused=True)
    for _ in range(8):
        slave_wf.do_job(master_wf.generate_data_for_slave(None),
                        lambda update: None)
    before = slave_wf.fused_trainer.capture_state()
    assert numpy.abs(before[0]["vw"]).max() > 0, \
        "momentum must have accumulated"
    master_wf.forwards[0].weights.map_write()
    master_wf.forwards[0].weights.mem[...] = 0.5
    slave_wf.apply_data_from_master(
        master_wf.generate_data_for_slave(None))
    after = slave_wf.fused_trainer.capture_state()
    numpy.testing.assert_array_equal(after[0]["vw"], before[0]["vw"])
    numpy.testing.assert_allclose(
        numpy.asarray(after[0]["w"], numpy.float32), 0.5, atol=1e-6)


def test_fused_epoch_mode_rejected_on_slave():
    prng.seed_all(21)
    wf = StandardWorkflow(
        None,
        loader_factory=lambda w: DistLoader(w, minibatch_size=25),
        layers=[{**s} for s in DIST_LAYERS],
        fused=True, fused_config={"epoch_mode": True},
        decision_config={"max_epochs": 3})
    wf.launcher = DummyLauncher(is_slave=True)
    with pytest.raises(NotImplementedError):
        wf.initialize(device=CPUDevice())


def test_distributed_stop_on_complete():
    master_wf = make_dist_wf(is_master=True)
    slave_wf = make_dist_wf(is_slave=True)
    master_wf.decision.complete <<= True    # already done
    server = JobServer(master_wf).start()
    try:
        client = JobClient(slave_wf, server.endpoint)
        client.handshake()
        assert client.run() is True
        assert client.jobs_done == 0        # no_more_jobs at once
        client.close()
    finally:
        server.stop()


def test_prefetch_double_buffering():
    """run_prefetch asks for the next job while the current one
    computes: the master sees a job_request while the slave WORKS."""
    class RecordingMaster(ScriptedMaster):
        def __init__(self, n_jobs):
            super().__init__(n_jobs)
            self.states_at_request = []

        def generate_data_for_slave(self, slave):
            self.states_at_request.append(slave.state)
            return super().generate_data_for_slave(slave)

    class SlowSlave(ScriptedSlave):
        def do_job(self, job, callback):
            time.sleep(0.05)
            self.jobs.append(job)
            callback({"result": job["job_number"]})

    master = RecordingMaster(6)
    server = JobServer(master).start()
    try:
        client = JobClient(SlowSlave(), server.endpoint)
        client.handshake()
        assert client.run_prefetch()
        client.close()
        assert master.served == 6
        assert sorted(u[1]["result"] for u in master.updates) == \
            [1, 2, 3, 4, 5, 6]
        assert "WORKING" in master.states_at_request
    finally:
        server.stop()


def test_stale_pong_skipped_before_later_rpc():
    """A timed-out heartbeat's late pong arriving before a later rpc's
    reply is skipped; the later rpc gets ITS reply."""
    router = wire.Router()
    client = JobClient(ScriptedSlave(),
                       "tcp://127.0.0.1:%d" % router.port)
    try:
        with pytest.raises(TimeoutError):
            client._rpc({"op": "ping", "id": client.sid}, timeout_ms=200)
        identity, blob = router.recv(3000)
        ping = pickle.loads(blob)
        assert ping["op"] == "ping"
        # the master wakes up and answers the OLD ping
        router.send_multipart([identity, pickle.dumps(
            {"op": "pong", "req": ping.get("req")})])

        def master_side():
            ident2, blob2 = router.recv(3000)
            request = pickle.loads(blob2)
            assert request["op"] == "job_request"
            router.send_multipart([ident2, pickle.dumps(
                {"op": "job", "data": {"job_number": 1},
                 "req": request.get("req")})])

        t = threading.Thread(target=master_side)
        t.start()
        reply = client._rpc({"op": "job_request", "id": client.sid},
                            timeout_ms=3000)
        t.join(5)
        assert not t.is_alive()
        assert reply["op"] == "job"
        assert reply["data"] == {"job_number": 1}
    finally:
        client.close()
        router.close()


def test_orphan_reply_of_timed_out_rpc_skipped():
    """A late non-pong reply to a timed-out rpc is skipped too: a retry
    never consumes its predecessor's answer."""
    router = wire.Router()
    client = JobClient(ScriptedSlave(),
                       "tcp://127.0.0.1:%d" % router.port)
    try:
        with pytest.raises(TimeoutError):
            client._rpc({"op": "job_request", "id": client.sid},
                        timeout_ms=200)
        identity, blob = router.recv(3000)
        first = pickle.loads(blob)
        router.send_multipart([identity, pickle.dumps(
            {"op": "job", "data": {"job_number": 1},
             "req": first.get("req")})])

        def master_side():
            ident2, blob2 = router.recv(3000)
            request = pickle.loads(blob2)
            router.send_multipart([ident2, pickle.dumps(
                {"op": "job", "data": {"job_number": 2},
                 "req": request.get("req")})])

        t = threading.Thread(target=master_side)
        t.start()
        reply = client._rpc({"op": "job_request", "id": client.sid},
                            timeout_ms=3000)
        t.join(5)
        assert not t.is_alive()
        assert reply["data"] == {"job_number": 2}, \
            "the retry must get ITS reply, not the orphan"
    finally:
        client.close()
        router.close()


def test_zero_progress_slave_blacklisted_on_timeout():
    """A slave that joins, completes nothing and goes silent is
    blacklisted by the reaper; a slave with jobs done is only
    dropped."""
    master = ScriptedMaster(n_jobs=3)
    server = JobServer(master, slave_timeout=0.6,
                       heartbeat_interval=0.2).start()
    productive = JobClient(ScriptedSlave(), server.endpoint)
    hung = JobClient(ScriptedSlave(), server.endpoint)
    try:
        productive.handshake()
        assert productive.run() is True
        hung.handshake()
        deadline = time.time() + 5
        while time.time() < deadline and \
                (hung.sid not in server.blacklist
                 or productive.sid in server.slaves):
            time.sleep(0.05)
        assert hung.sid in server.blacklist
        assert hung.sid in master.dropped
        assert productive.sid not in server.blacklist
        assert productive.sid in master.dropped
    finally:
        productive.close()
        hung.close()
        server.stop()


def test_blacklisted_sid_rehandshake_rejected():
    """A blacklisted sid's handshake is refused, even with a matching
    checksum; a fresh sid still joins."""
    master = ScriptedMaster(n_jobs=3)
    server = JobServer(master, slave_timeout=0.5,
                       heartbeat_interval=0.2).start()
    try:
        hung = JobClient(ScriptedSlave(), server.endpoint)
        hung.handshake()
        deadline = time.time() + 5
        while time.time() < deadline and \
                hung.sid not in server.blacklist:
            time.sleep(0.05)
        assert hung.sid in server.blacklist
        hung.close()
        retry = JobClient(ScriptedSlave(), server.endpoint, sid=hung.sid)
        with pytest.raises(ConnectionError, match="blacklisted"):
            retry.handshake()
        retry.close()
        fresh = JobClient(ScriptedSlave(), server.endpoint)
        fresh.handshake()
        assert fresh.run() is True
        fresh.close()
    finally:
        server.stop()


def test_client_default_power_from_db():
    """The ratings database is not ported yet: a slave advertises 1.0
    unless given ``power=``, which the master's record carries."""
    from veles_tpu_torch.parallel import jobs
    assert jobs._default_power() == 1.0
    master = ScriptedMaster(n_jobs=1)
    server = JobServer(master).start()
    try:
        default = JobClient(ScriptedSlave(), server.endpoint)
        rated = JobClient(ScriptedSlave(), server.endpoint,
                          power=123456.0)
        default.handshake()
        rated.handshake()
        assert server.slaves[default.sid].power == 1.0
        assert server.slaves[rated.sid].power == 123456.0
        default.close()
        rated.close()
    finally:
        server.stop()


def test_print_stats_reports_job_latency_percentiles(caplog):
    """The job round trip lands in the shared LatencyHistogram and
    print_stats renders the percentiles."""
    import logging

    from veles_tpu_torch import metrics as shared_metrics

    master = ScriptedMaster(n_jobs=4)
    server = JobServer(master).start()
    try:
        client = JobClient(ScriptedSlave(), server.endpoint)
        client.handshake()
        assert client.run()
        slave = server.slaves[client.sid]
        assert isinstance(slave.latency, shared_metrics.LatencyHistogram)
        assert slave.latency.count == 4
        assert slave.latency.mean > 0
        assert slave.latency.percentile(99) >= \
            slave.latency.percentile(50) > 0
        with caplog.at_level(logging.INFO):
            server.print_stats()
        lines = [r.getMessage() for r in caplog.records]
        assert any("job latency" in line and "p95" in line
                   for line in lines), lines
        assert 'veles_jobs_done_total{slave="%s"} 4' % client.sid \
            in server.metrics_text()
        client.close()
    finally:
        server.stop()


# -- the slave's surgery and its uploads --------------------------------------

def test_slave_runs_one_pass_a_job_through_new_segments():
    """A slave's graph is one pass (the repeater's back edge is gone and
    the end point open), stitched again into the standalone segments;
    from its second job on (the first binds the tensors) each job moves
    its weights and biases and its index span into the segments'
    tensors in place: 5 in-place uploads a job."""
    slave_wf = make_dist_wf(is_slave=True)
    master_wf = make_dist_wf(is_master=True)
    assert slave_wf._loop_tail not in slave_wf.repeater.links_from
    assert [s.names for s in slave_wf.stitch_segments] == [
        ["DistLoader", "All2AllTanh", "All2AllSoftmax",
         "EvaluatorSoftmax"], ["GDSoftmax", "GDTanh"]]
    dispatches = []
    for job in range(8):
        before = Watcher.transfers()["h2d_inplace_transfers"]
        slave_wf.do_job(master_wf.generate_data_for_slave(None),
                        lambda update: None)
        dispatches.append([r["dispatches"]
                           for r in slave_wf.stitch_report()])
        inplace = Watcher.transfers()["h2d_inplace_transfers"] - before
        assert inplace == (0 if job == 0 else 5), (job, inplace)
    # one forward pass a job, a GD pass on the 6 train jobs
    assert dispatches[-1] == [8, 6]
    assert bool(master_wf.decision.complete) is False


# -- the port against the JAX package ------------------------------------------

def _jax_synchronous(wf):
    """The JAX eager chain waiting for each unit's results (its loader
    rewrites host buffers a dispatched step may still read)."""
    for unit in wf.units:
        def run(unit=unit, inner=unit.run):
            inner()
            for value in list(unit.__dict__.values()):
                if isinstance(value, JaxVector):
                    value = value._devmem_
                if isinstance(value, jax.Array):
                    value.block_until_ready()
        unit.run = run
    return wf


def _record_closes(wf):
    dec = wf.decision
    dec.closes_seen = []
    close = dec._close_class

    def recording(cls, check_epoch_end):
        dec.closes_seen.append((int(dec.epoch_number), int(cls),
                                float(dec.epoch_n_err[cls])))
        return close(cls, check_epoch_end)
    dec._close_class = recording
    return wf


def _build(jax_side, is_master, fused):
    (jax_prng if jax_side else prng).seed_all(21)
    klass = JaxStandardWorkflow if jax_side else StandardWorkflow
    loader = JaxDistLoader if jax_side else DistLoader
    wf = klass(None, loader_factory=lambda w: loader(w, minibatch_size=25),
               layers=[{**s} for s in DIST_LAYERS], fused=fused,
               decision_config={"max_epochs": 2})
    launcher = JaxDummyLauncher if jax_side else DummyLauncher
    wf.launcher = launcher(is_master=is_master, is_slave=not is_master)
    wf.initialize(device=JaxCPUDevice() if jax_side else CPUDevice())
    if jax_side and not is_master and not fused:
        _jax_synchronous(wf)
    return _record_closes(wf) if is_master else wf


def _session(jax_side, fused):
    """One master, one synchronous slave, to the Decision's end, at
    precision level 2: (master workflow, served seqs, applied seqs,
    server, the master's initial weights and shuffled indices)."""
    server_class = jax_jobs.JobServer if jax_side else JobServer
    client_class = jax_jobs.JobClient if jax_side else JobClient
    eng = (jax_root if jax_side else root).common.engine
    knobs = {"precision_level": 2}
    if jax_side:
        knobs.update(kernels="xla", stitch="off")
    saved = {k: eng.get(k) for k in knobs}
    for key, value in knobs.items():
        setattr(eng, key, value)
    try:
        master = _build(jax_side, True, fused)
        slave = _build(jax_side, False, fused)
    finally:
        for key, value in saved.items():
            setattr(eng, key, value)
    master.loader.shuffled_indices.map_read()
    initial = _weights(master) + [
        numpy.array(master.loader.shuffled_indices.mem)]
    server = server_class(master)
    served = []
    send = server._send

    def recording_send(identity, msg):
        if msg.get("op") == "job":
            served.append(msg["job"]["seq"])
        return send(identity, msg)
    server._send = recording_send
    server.start()
    try:
        client = client_class(slave, server.endpoint, rpc_timeout_ms=5000)
        client.handshake()
        assert client.run() is True
        client.close()
    finally:
        server.stop()
    return master, served, list(server._applied_order), server, initial


def _weights(wf):
    out = []
    for fwd in wf.forwards:
        for vec in (fwd.weights, fwd.bias):
            vec.map_read()
            out.append(numpy.array(vec.mem))
    return out


@pytest.fixture(scope="module")
def jax_sessions():
    return {fused: _session(True, fused) for fused in (False, True)}


@pytest.mark.parametrize("fused", [False, True], ids=["stitched", "fused"])
def test_one_slave_session_matches_the_jax_session(jax_sessions, fused):
    jmaster, jserved, japplied, _srv, jinitial = jax_sessions[fused]
    master, served, applied, _srv, initial = _session(False, fused)
    # one seed gives both packages the same initial weights and shuffle
    for got, want in zip(initial, jinitial):
        numpy.testing.assert_array_equal(got, want)
    assert bool(master.decision.complete)
    assert master.decision.closes_seen == jmaster.decision.closes_seen
    assert len(master.decision.closes_seen) == 3   # 2 epochs
    assert served == jserved and applied == japplied
    assert served == applied == list(range(1, len(served) + 1))
    for got, want in zip(_weights(master), _weights(jmaster)):
        err = float(numpy.abs(got - want).max())
        assert err <= PARAM_RTOL * float(numpy.abs(want).max()), err


def test_jax_master_refuses_a_port_slave_at_the_handshake():
    jax_root.common.engine.stitch = "off"
    try:
        jmaster = _build(True, True, False)
    finally:
        jax_root.common.engine.stitch = "on"
    slave = make_dist_wf(is_slave=True)
    server = jax_jobs.JobServer(jmaster)    # not started: dispatch
    try:
        server._on_handshake(b"s1", {"op": "handshake", "id": "s1",
                                     "req": 1, "checksum": slave.checksum()})
        reply = pickle.loads(server._outbox[-1][1])
        assert reply["op"] == "reject"
        assert reply["reason"] == "checksum mismatch"
        assert "s1" not in server.slaves
    finally:
        server.stop()


def test_port_master_refuses_a_jax_slave_at_the_handshake():
    jax_root.common.engine.stitch = "off"
    try:
        jslave = _build(True, False, False)
    finally:
        jax_root.common.engine.stitch = "on"
    master = make_dist_wf(is_master=True)
    server = JobServer(master)              # not started: dispatch
    try:
        server._on_handshake(b"s1", {"op": "handshake", "id": "s1",
                                     "req": 1,
                                     "checksum": jslave.checksum()})
        reply = pickle.loads(server._outbox[-1][1])
        assert reply["op"] == "reject"
        assert reply["reason"] == "checksum mismatch"
        assert "s1" not in server.slaves
    finally:
        server.stop()


# -- the control plane, the scrape endpoints and the heartbeats ---------------

def test_pod_epoch_hook_of_a_scripted_master():
    """``pod_epoch`` frames reach the hosted workflow's ``on_pod_epoch``
    (the lease half of the pod rides them); a master without the hook
    acks ``stop: 0``."""
    class PodScripted(ScriptedMaster):
        def __init__(self):
            super().__init__(n_jobs=0)
            self.epochs = []

        def on_pod_epoch(self, msg, slave):
            self.epochs.append((slave.id, msg["epoch"]))
            return {"stop": int(msg["epoch"] >= 2)}

    for master, want in ((PodScripted(), [0, 0, 1]),
                         (ScriptedMaster(), [0, 0, 0])):
        server = JobServer(master).start()
        try:
            client = JobClient(ScriptedSlave(), server.endpoint)
            client.handshake()
            replies = [client.control({"op": "pod_epoch", "epoch": e})
                       for e in range(3)]
            assert [r["op"] for r in replies] == ["pod_epoch_ack"] * 3
            assert [r["stop"] for r in replies] == want
            if isinstance(master, PodScripted):
                assert master.epochs == [(client.sid, e) for e in range(3)]
            client.close()
        finally:
            server.stop()


def test_master_and_slave_scrape_endpoints():
    """Each role mounts its ``/metrics`` over ``obs.scrape``: the
    master's exactly-once accounting and per-slave counters, the
    slave's jobs done."""
    import urllib.request
    master = ScriptedMaster(n_jobs=3)
    server = JobServer(master).start()
    try:
        client = JobClient(ScriptedSlave(), server.endpoint)
        client.handshake()
        assert client.run()
        scrapes = [server.start_scrape(), client.start_scrape()]
        texts = [urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics" % s.port, timeout=10).read()
            .decode() for s in scrapes]
        assert "veles_jobs_slaves 1" in texts[0]
        assert 'veles_jobs_done_total{slave="%s"} 3' % client.sid \
            in texts[0]
        assert "veles_jobs_dedup_dropped_total 0" in texts[0]
        assert "veles_slave_jobs_done_total 3" in texts[1]
        client.close()
    finally:
        server.stop()


def test_heartbeats_keep_a_long_job_alive_and_measure_the_clock():
    """A job longer than the master's slave timeout survives on the
    heartbeat thread's pings, which also give the master its clock
    offset estimate of the slave."""
    class LongSlave(ScriptedSlave):
        def do_job(self, data, callback):
            time.sleep(2.5)
            callback({"result": data["job_number"]})

    master = ScriptedMaster(n_jobs=1)
    server = JobServer(master, slave_timeout=1.0,
                       heartbeat_interval=0.1).start()
    try:
        client = JobClient(LongSlave(), server.endpoint,
                           heartbeat_interval=0.1)
        client.handshake()
        assert client.run() is True
        assert len(master.updates) == 1 and not master.dropped
        assert server.slaves[client.sid].clock_offset_ns is not None
        client.close()
    finally:
        server.stop()


def test_the_wire_routes_by_connection_and_reconnects():
    """The port-only wire: frames of any size arrive whole and in order,
    a reply goes back on the connection its request came on, a reply
    to a closed connection is dropped, a broken length closes the
    stream, and a slave reaches a master restarted on the same port
    after ``reconnect()``."""
    import socket

    router = wire.Router()
    endpoint = "tcp://127.0.0.1:%d" % router.port
    a, b = wire.Dealer(endpoint), wire.Dealer(endpoint)
    try:
        big = bytes(range(256)) * 8192           # 2 MiB
        assert a.send(b"one") and a.send(big) and b.send(b"two")
        got = [router.recv(3000) for _ in range(3)]
        by_peer = {}
        for identity, blob in got:
            by_peer.setdefault(identity, []).append(blob)
        assert sorted(map(len, by_peer.values())) == [1, 2]
        a_id = next(i for i, blobs in by_peer.items() if len(blobs) == 2)
        b_id = next(i for i in by_peer if i != a_id)
        assert by_peer[a_id] == [b"one", big]
        assert router.send_multipart([b_id, b"to b"])
        assert router.send_multipart([a_id, big])
        assert b.poll(3000) and b.recv() == b"to b"
        assert a.poll(3000) and a.recv() == big
        b.close()
        deadline = time.time() + 5
        while router.send_multipart([b_id, b"gone"]) \
                and time.time() < deadline:
            router.poll(50)
        assert not router.send_multipart([b_id, b"gone"])
        raw = socket.create_connection(("127.0.0.1", router.port))
        raw.sendall(b"\xff" * 8)                 # a length past MAX_FRAME
        for _ in range(5):                       # accept, then read
            router.poll(50)
        raw.settimeout(5)
        assert raw.recv(1) == b""                # the router closed it
        raw.close()
        port = router.port
        router.close()
        assert not a.poll(200)
        router = wire.Router(port=port)          # the restarted master
        assert a.reconnect() and a.send(b"again")
        assert router.recv(3000)[1] == b"again"
    finally:
        a.close()
        b.close()
        router.close()
