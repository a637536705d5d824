"""The master–slave job layer: elastic task distribution, the port's
counterpart of :mod:`veles_tpu.parallel.jobs`.

A per-slave state record, a checksum handshake, power-based balancing,
hung-slave blacklisting, the requeue of a dead slave's work
(``drop_slave``), slaves joining and leaving mid-run, and pickled job
payloads.  On the MNIST path a job is one minibatch pass of the slave's
graph: the master's weights go out, the slave's deltas and error counts
come back.  Payloads are numpy arrays and plain Python, never torch
tensors (a CUDA tensor would carry its device into the other process).

The wire (:mod:`veles_tpu_torch.parallel.wire`) is the Python standard
library's ``socket`` and ``selectors``, not ZeroMQ: the machine with the
card has no pyzmq.  The master's :class:`~.wire.Router` routes replies by
connection, and each slave's :class:`~.wire.Dealer` is one ordered
stream; a slave that lost its master opens a new stream before it
handshakes again (:meth:`JobClient._reconnect`).  Heartbeats detect
failure.

Wire protocol (pickled dicts):
  slave → master: {op: handshake|job_request|update|ping|pod_epoch|prof
                   |bye, id}
  master → slave: {op: welcome|reject|job|update_ack|no_more_jobs|wait
                   |job_error|pong|pod_epoch_ack|prof_ack}

Robustness semantics, as in the JAX package:

* every request carries a client-monotonic ``req`` echoed in its reply,
  so a retried rpc can skip any orphan reply a timed-out predecessor
  left in the stream;
* every job carries a monotonic id ``{gen, epoch, seq}`` echoed in its
  update: the master applies each seq EXACTLY once (duplicated frames
  and retried drop-after-apply updates are deduplicated), rejects
  updates from an older generation (a pre-restart slave), and requeues
  jobs whose frames were lost on the wire (the ``have`` list in each
  job_request names what the slave holds);
* the master optionally checkpoints the workflow's train state
  (:class:`veles_tpu_torch.checkpoint.TrainCheckpointer`) every K
  applied updates and at epoch boundaries, off the server thread, and
  a restarted master ``resume_from_checkpoint()``s with a bumped
  generation; live slaves rejoin and reconcile to the master's position;
* fault injection (:mod:`veles_tpu_torch.chaos`) wraps the wire and the
  process boundary at the sites marked below.

``_default_power`` returns 1.0 (every slave equal) unless a slave is
given ``power=``: the device ratings database it reads in the JAX
package is not ported yet (ROADMAP item 7(e)).
"""

import collections
import pickle
import random
import threading
import time
import uuid

from veles_tpu_torch import chaos, trace
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.metrics import LatencyHistogram
from veles_tpu_torch.obs import blackbox
from veles_tpu_torch.obs import context as obs_context
from veles_tpu_torch.parallel import wire

HEARTBEAT_INTERVAL = 2.0
SLAVE_TIMEOUT = 10.0
#: how many applied-update seqs the dedup set remembers (a replay can
#: only arrive within a few round-trips of the original; this is ~3
#: orders of magnitude above that)
APPLIED_SEQ_WINDOW = 8192


class SlaveDescription(object):
    """Master-side per-slave record (ref fysom FSM states collapse to
    this state field: INIT→WORKING→DROPPED)."""

    def __init__(self, sid, power=1.0):
        self.id = sid
        self.power = power
        self.state = "INIT"
        self.last_seen = time.time()
        self.jobs_done = 0
        #: jobs handed out but not yet updated, keyed by job seq →
        #: hand-out time — with prefetching slaves two can be in
        #: flight; `finished`, drop-requeue AND lost-frame detection
        #: (the job_request ``have`` list) key off this map, not the
        #: single state field (ADVICE r1)
        self.outstanding = collections.OrderedDict()
        #: job round-trip latency (send → update), the histogram the
        #: serving layer uses (veles_tpu_torch.metrics), so the two
        #: percentile columns compare; a slave's jobs are answered in
        #: order on its stream, so FIFO send-stamp matching is exact
        #: even with two in flight
        self.latency = LatencyHistogram()
        self._sent_at = collections.deque()
        #: master_clock − slave_clock in ns, estimated from heartbeat
        #: pings carrying the slave's perf_counter stamp; the MINIMUM
        #: observed sample is kept (one-way latency only ever inflates
        #: the measurement) — the cluster trace merge shifts this
        #: slave's timestamps by it
        self.clock_offset_ns = None
        #: heartbeat-watchdog state: warned-once latch per excursion
        self.hb_warned = False

    @property
    def in_flight(self):
        return len(self.outstanding)

    def observe_clock(self, sent_ns, recv_ns):
        measured = int(recv_ns) - int(sent_ns)
        if self.clock_offset_ns is None \
                or measured < self.clock_offset_ns:
            self.clock_offset_ns = measured

    def job_sent(self):
        self._sent_at.append(time.time())

    def job_updated(self):
        if self._sent_at:
            self.latency.record(time.time() - self._sent_at.popleft())

    def __repr__(self):
        return "<Slave %s %s power=%.1f jobs=%d inflight=%d>" % (
            self.id, self.state, self.power, self.jobs_done,
            self.in_flight)


class JobServer(Logger):
    """Master: serves jobs from a workflow (or any object implementing
    generate_data_for_slave / apply_data_from_slave / drop_slave /
    checksum)."""

    def __init__(self, workflow, port=0, host="127.0.0.1",
                 slave_timeout=SLAVE_TIMEOUT,
                 heartbeat_interval=HEARTBEAT_INTERVAL,
                 checkpoint_dir=None, checkpoint_every=None):
        super(JobServer, self).__init__()
        self.workflow = workflow
        self.slave_timeout = slave_timeout
        self.heartbeat_interval = heartbeat_interval
        self.slaves = {}
        self.blacklist = set()
        #: run generation: bumped by resume_from_checkpoint so updates
        #: computed against a pre-restart master are recognizably stale
        self.generation = 1
        #: global monotonic job counter — the ``seq`` in every job id
        self._seq = 0
        #: seq → apply outcome (the ``ok`` acked) for every consumed
        #: update — the exactly-once record, with its arrival-order
        #: twin for O(1) window eviction.  Storing the outcome lets a
        #: replay's ack echo the ORIGINAL result: a failed apply whose
        #: ok:0 ack was lost must not morph into ok:1 on retry
        self._applied = {}
        self._applied_order = collections.deque()
        #: exactly-once accounting (print_stats + the chaos smoke's
        #: consistency check read these)
        self.dedup_dropped = 0
        self.stale_rejected = 0
        self.lost_requeued = 0
        self._updates_applied = 0
        #: sid -> heartbeat-watchdog excursions (the WARNING +
        #: jobs:heartbeat_stall instant, promoted to a real counter on
        #: the master scrape endpoint); survives drop_slave so a
        #: flapping slave's history outlives its record
        self.heartbeat_stalls = collections.Counter()
        #: the per-role Prometheus listener (obs.scrape), mounted by
        #: start_scrape()
        self._scrape = None
        #: crash-recovery: async TrainCheckpointer checkpoints every
        #: ``checkpoint_every`` applied updates and at epoch
        #: boundaries; None args fall back to the
        #: ``root.common.engine.checkpoint`` knobs
        from veles_tpu_torch.config import root
        node = root.common.engine.get("checkpoint")
        cfg = node.to_dict() if node else {}
        if checkpoint_dir is None:
            checkpoint_dir = cfg.get("dir") or None
        if checkpoint_every is None:
            checkpoint_every = int(cfg.get("every_jobs", 0) or 0)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every or 0)
        self._ckpt = None
        self._ckpt_busy = threading.Event()
        self._last_ckpt_epoch = None
        #: the applied-update count of the last write started
        self._last_ckpt_step = 0
        self.killed = False
        #: sid -> {"events", "ledger", "offset_ns"} shipped by slaves
        #: at end-of-run over the job wire (op "prof"); survives
        #: drop_slave so save_session_profile sees finished slaves
        self.slave_profiles = {}
        self._no_more_jobs = False
        self.on_finished = None
        #: hand out no job before this many slaves joined, until
        #: ``quorum_deadline`` (time.time()): a bootstrap's slaves start
        #: together, and on a fast task the first one up would take
        #: every job (the others are told to wait)
        self.quorum = 0
        self.quorum_deadline = 0.0
        # replies route by connection: a slave restarted with its old
        # sid handshakes on its new connection and is answered there
        self._socket = wire.Router(host, port)
        self.port = self._socket.port
        self.endpoint = "tcp://%s:%d" % (host, self.port)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        #: outbound messages produced by worker threads; only the loop
        #: thread touches the router (a worker finishing a job's
        #: generation wakes the loop, so its reply does not wait out the
        #: poll timeout)
        self._outbox = collections.deque()
        self.info("job server on %s", self.endpoint)

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="job-server")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._socket.wake()
        if self._thread is not None:
            self._thread.join(5)
        if self._scrape is not None:
            self._scrape.stop()
            self._scrape = None
        self._socket.close()

    @property
    def finished(self):
        return self._no_more_jobs and not any(
            s.in_flight for s in self.slaves.values())

    # -- main loop ----------------------------------------------------------
    def _loop(self):
        last_reap = time.time()
        while not self._stop.is_set():
            if chaos.controller.armed and not self._chaos_tick():
                return           # chaos master_kill: crash, no cleanup
            self._drain_outbox()
            if self._socket.poll(50 if self._outbox else 200):
                # drain EVERYTHING queued before reaping: a slow
                # generate_data_for_slave stalls this loop, and pings
                # that piled up meanwhile must refresh last_seen before
                # the reaper judges those slaves dead
                while True:
                    try:
                        identity, blob = self._socket.recv_multipart()
                    except wire.Again:
                        break
                    try:
                        msg = pickle.loads(blob)
                    except Exception:
                        self.exception("undecodable message")
                        continue
                    deliveries = 1
                    if chaos.controller.armed:
                        # chaos site master_recv: drop/dup/delay an
                        # arriving frame (delay stalls the loop — the
                        # same observable as a wedged master)
                        plan = chaos.controller.wire(
                            "master_recv", msg.get("op"),
                            peer=msg.get("id"), role="master")
                        if plan.delay_s:
                            time.sleep(plan.delay_s)
                        deliveries = 0 if plan.corrupt \
                            else plan.deliveries
                    for _ in range(deliveries):
                        try:
                            self._dispatch(identity, msg)
                        except Exception:
                            self.exception("failed handling %r",
                                           msg.get("op"))
            self._drain_outbox()
            if time.time() - last_reap >= self.heartbeat_interval:
                last_reap = time.time()
                self._reap_dead_slaves()

    def _chaos_tick(self):
        """Process-boundary faults on the server loop.  Returns False
        when the master was chaos-killed (the loop must vanish the way
        a SIGKILL'd process would: socket closed, nothing drained)."""
        fault = chaos.controller.process("master_tick", role="master")
        if fault is None:
            return True
        if fault.action == "master_stall":
            self.warning("chaos: master stalled for %.1f s",
                         fault.duration_s)
            time.sleep(fault.duration_s)
            return True
        if fault.action == "master_kill":
            self.warning("chaos: master killed")
            # flight recorder: a simulated SIGKILL must leave the same
            # post-mortem a real one's handler would (no-op when
            # root.common.obs.blackbox_dir is unset)
            blackbox.dump("chaos master_kill")
            self.killed = True
            self._stop.set()
            self._socket.close()
            return False
        return True

    def _drain_outbox(self):
        while self._outbox:
            identity, blob = self._outbox.popleft()
            try:
                self._socket.send_multipart([identity, blob])
            except Exception:
                self.exception("failed sending queued reply")

    def _send(self, identity, msg):
        """Replies from the loop thread go straight out; worker threads
        (job generation) enqueue: only the loop thread sends.
        Chaos site ``master_send``: a reply may be dropped, duplicated,
        delayed or corrupted here."""
        blob = pickle.dumps(msg, pickle.HIGHEST_PROTOCOL)
        if chaos.controller.armed:
            chaos.controller.send_wire(
                "master_send", msg.get("op"), blob,
                lambda b: self._send_blob(identity, b), role="master")
            return
        self._send_blob(identity, blob)

    def _send_blob(self, identity, blob):
        if threading.current_thread() is self._thread:
            self._socket.send_multipart([identity, blob])
        else:
            self._outbox.append((identity, blob))
            self._socket.wake()

    def _dispatch(self, identity, msg):
        op = msg.get("op")
        sid = msg.get("id")
        req = msg.get("req")
        slave = self.slaves.get(sid)
        if slave is not None:
            now = time.time()
            if op == "ping":
                if trace.enabled():
                    # heartbeat gap: how stale last_seen got before
                    # this ping — creeping gaps flag a slave wedged in
                    # compute (or a master loop stalled in generation)
                    trace.instant(
                        "jobs", "heartbeat",
                        {"slave": sid,
                         "gap_ms": round((now - slave.last_seen) * 1e3,
                                         1)},
                        role="master")
                if "t_ns" in msg:
                    # the ping carries the slave's perf_counter stamp:
                    # the clock-offset estimate the cluster trace
                    # merge aligns this slave's timeline with
                    slave.observe_clock(msg["t_ns"],
                                        time.perf_counter_ns())
            slave.last_seen = now
            # ANY contact ends a heartbeat-stall excursion (a slave
            # resuming with a pending update/job_request must re-arm
            # the once-per-excursion watchdog, not just a ping)
            slave.hb_warned = False
        if op == "handshake":
            self._on_handshake(identity, msg)
        elif op == "bye":
            # fire-and-forget farewell, NEVER answered: a req-less
            # reject would reach a stream that may already carry a
            # successor's rpc
            if slave is not None:
                self.drop_slave(sid)
        elif slave is None or sid in self.blacklist:
            self._send(identity, {"op": "reject",
                                  "reason": "unknown id", "req": req})
        elif op == "ping":
            self._send(identity, {"op": "pong", "req": req})
        elif op == "job_request":
            self._on_job_request(identity, slave, msg)
        elif op == "update":
            self._on_update(identity, slave, msg)
        elif op == "pod_epoch":
            self._on_pod_epoch(identity, slave, msg)
        elif op == "prof":
            self._on_prof(identity, slave, msg)

    def _master_epoch(self):
        """The master workflow's current epoch (0 for scripted masters
        with no loader) — stamped into job ids and the welcome reply so
        a rejoining slave reconciles instead of starting over."""
        try:
            return int(getattr(getattr(self.workflow, "loader", None),
                               "epoch_number", 0) or 0)
        except Exception:
            return 0

    def _on_handshake(self, identity, msg):
        """Checksum handshake (ref ``server.py:478-530``): reject slaves
        running different workflow code or previously blacklisted ids.
        A re-handshake from a LIVE sid is a rejoin (partition healed,
        master restarted): its outstanding jobs are requeued and the
        welcome carries the master's {gen, epoch, seq} so the slave
        reconciles to the current training position."""
        req = msg.get("req")
        if msg.get("id") in self.blacklist:
            self._send(identity, {"op": "reject",
                                  "reason": "blacklisted", "req": req})
            return
        their_checksum = msg.get("checksum")
        try:
            ours = self.workflow.checksum()
        except Exception as e:    # ChecksumError: fail closed, loudly
            self._send(identity, {
                "op": "reject", "req": req,
                "reason": "master cannot checksum its workflow: %s" % e})
            self.error("cannot checksum own workflow — rejecting every "
                       "slave: %s", e)
            return
        if their_checksum != ours:
            self._send(identity, {
                "op": "reject", "reason": "checksum mismatch",
                "req": req})
            self.warning("rejected slave with checksum %s (ours %s)",
                         str(their_checksum)[:12], ours[:12])
            return
        sid = msg.get("id") or uuid.uuid4().hex[:8]
        slave = SlaveDescription(sid, power=float(msg.get("power", 1.0)))
        slave.state = "WAIT"
        with self._lock:
            previous = self.slaves.get(sid)
            if previous is not None and previous.outstanding:
                # rejoin with jobs in flight: the slave abandoned them
                # (it re-handshakes only after losing the stream) —
                # requeue so no minibatch is silently lost
                try:
                    self.workflow.drop_slave(previous)
                except Exception:
                    self.exception("requeue on rejoin of %s failed", sid)
                self.lost_requeued += len(previous.outstanding)
                self.info("slave %s re-joined with %d job(s) in "
                          "flight — requeued", sid,
                          len(previous.outstanding))
            self.slaves[sid] = slave
        self._send(identity, {"op": "welcome", "id": sid, "req": req,
                              "gen": self.generation,
                              "epoch": self._master_epoch(),
                              "seq": self._seq})
        if trace.enabled():
            trace.instant("jobs", "handshake",
                          {"slave": sid, "gen": self.generation,
                           "rejoin": previous is not None},
                          role="master")
        self.info("slave %s joined (power %.1f, generation %d)",
                  sid, slave.power, self.generation)

    def _on_job_request(self, identity, slave, msg):
        """Job generation is offloaded to the host thread pool (ref
        ``server.py:404-407`` deferToThreadPool): a slow
        generate_data_for_slave (GA child evaluation, big index
        partitions) must not stall heartbeat processing and job service
        for every other slave on the server thread.

        The request's ``have`` list names the seqs the slave actually
        holds: any outstanding job NOT in it was lost on the wire (a
        dropped ``job`` frame, a slave that timed out waiting) — so a
        lost frame degrades to retried minibatches instead of a hung
        epoch.  On ANY loss the slave's WHOLE outstanding set is
        requeued, not just the lost seqs: the loader's per-slave
        pending list is positional (no per-seq identity), so a partial
        requeue would desynchronize it from our seq accounting — the
        still-held jobs' updates are instead stale-rejected and their
        minibatches re-served (wasted compute, never a double-apply)."""
        req = msg.get("req")
        have = msg.get("have")
        if have is not None:
            have_set = set(have)
            with self._lock:
                # under the lock: a duplicated request frame dispatches
                # this while a pool worker's _generate_and_send inserts
                # into outstanding
                lost = [seq for seq in slave.outstanding
                        if seq not in have_set]
            if lost:
                self._requeue_lost(slave, lost)
        if self._no_more_jobs:
            self._send(identity, {"op": "no_more_jobs", "req": req})
            return
        if len(self.slaves) < self.quorum \
                and time.time() < self.quorum_deadline:
            self._send(identity, {"op": "wait", "req": req})
            return
        from veles_tpu_torch import thread_pool
        thread_pool.submit(self._generate_and_send, identity, slave,
                           req)

    def _requeue_lost(self, slave, lost):
        with self._lock:
            # clear EVERYTHING outstanding, not just the lost seqs:
            # workflow.drop_slave requeues the loader's whole pending
            # list for this sid (it has no per-seq identity), so the
            # seq set must empty with it or the two go out of sync —
            # still-held jobs become stale (their updates rejected,
            # their minibatches re-served)
            cleared = list(slave.outstanding)
            slave.outstanding.clear()
            try:
                # unit-level requeue (the loader returns the pending
                # minibatches to its retry queue) WITHOUT dropping the
                # slave itself — it is alive and asking for work
                self.workflow.drop_slave(slave)
            except Exception:
                self.exception("requeue of lost jobs for %s failed",
                               slave.id)
        self.lost_requeued += len(cleared)
        trace.instant("jobs", "requeue_lost",
                      {"slave": slave.id, "lost": list(lost),
                       "requeued": cleared},
                      role="master")
        self.warning("slave %s lost %d job frame(s) on the wire "
                     "(seq %s) — requeued all %d outstanding",
                     slave.id, len(lost),
                     ",".join(str(s) for s in lost), len(cleared))

    def _generate_and_send(self, identity, slave, req=None):
        from veles_tpu_torch.workflow import NoJobYet, NoMoreJobs
        try:
            with self._lock:
                if self.slaves.get(slave.id) is not slave:
                    # reaped while this request waited for a worker; a
                    # job generated now would never be requeued on drop
                    self._send(identity,
                               {"op": "reject", "reason": "dropped",
                                "req": req})
                    return
                if self._no_more_jobs:
                    self._send(identity, {"op": "no_more_jobs",
                                          "req": req})
                    return
                try:
                    with trace.span("jobs", "generate",
                                    obs_context.tag(
                                        {"slave": slave.id}),
                                    role="master"):
                        data = self.workflow.generate_data_for_slave(
                            slave)
                except NoJobYet:
                    # more jobs will appear (e.g. GA generation
                    # boundary): the slave should retry, not quit
                    self._send(identity, {"op": "wait", "req": req})
                    return
                except (StopIteration, NoMoreJobs):
                    data = None
                if data is not None:
                    self._seq += 1
                    seq = self._seq
                    slave.outstanding[seq] = time.time()
                    slave.state = "WORKING"
                    job_id = {"gen": self.generation,
                              "epoch": self._master_epoch(),
                              "seq": seq}
            if data is None:
                self._no_more_jobs = True
                self._send(identity, {"op": "no_more_jobs",
                                      "req": req})
                self._maybe_finish()
                return
            slave.job_sent()
            # distributed tracing rides the job frame: the master's
            # current/process context (a traced session's identity)
            # parents everything the slave does with this job
            self._send(identity, obs_context.wire_inject(
                {"op": "job", "data": data, "job": job_id,
                 "req": req}))
        except Exception as exc:
            self.exception("job generation for %s failed", slave.id)
            # answer the request: a silent swallow here would leave
            # the slave timing out, re-handshaking (the master is
            # alive, so that succeeds) and re-requesting forever — a
            # livelock.  job_error fails the slave loudly instead
            self._send(identity, {"op": "job_error", "req": req,
                                  "error": "%s: %s"
                                  % (type(exc).__name__, exc)})

    def _on_update(self, identity, slave, msg):
        """Apply a slave's update EXACTLY ONCE.

        Every update echoes its job id ``{gen, epoch, seq}``:

        * an older ``gen`` is a pre-restart slave's update — rejected
          (the restored train state already diverged from the state
          that delta was computed against);
        * a ``seq`` already in the applied set is a replay (duplicated
          wire frame, or a drop-after-apply retry whose first copy DID
          land) — acked ok but NOT re-applied, so replaying a captured
          update frame N times changes the weights exactly once;
        * a ``seq`` the master no longer has outstanding was requeued
          (lost-frame detection) — the work happened against a
          minibatch someone else will redo; rejected as stale.
        """
        req = msg.get("req")
        job = msg.get("job")
        with self._lock:
            seq = None
            if job is not None:
                gen = int(job.get("gen", 0))
                seq = int(job.get("seq", 0))
                if gen != self.generation:
                    self.stale_rejected += 1
                    trace.instant(
                        "jobs", "stale_update",
                        {"slave": slave.id, "gen": gen, "seq": seq,
                         "current_gen": self.generation},
                        role="master")
                    self.warning(
                        "rejected stale update from %s: generation %d "
                        "(job epoch %s, seq %d) vs current generation "
                        "%d — pre-restart work is discarded", slave.id,
                        gen, job.get("epoch"), seq, self.generation)
                    self._send(identity, {"op": "update_ack", "ok": 0,
                                          "stale": 1, "req": req})
                    return
                if seq in self._applied:
                    self.dedup_dropped += 1
                    trace.instant("jobs", "dedup_update",
                                  {"slave": slave.id, "seq": seq},
                                  role="master")
                    self.info("deduplicated replayed update seq %d "
                              "from %s (already consumed, ok=%d)",
                              seq, slave.id, self._applied[seq])
                    self._send(identity,
                               {"op": "update_ack",
                                "ok": self._applied[seq], "dup": 1,
                                "req": req})
                    return
                if seq not in slave.outstanding:
                    self.stale_rejected += 1
                    self.warning(
                        "rejected update for unknown/requeued job seq "
                        "%d from %s", seq, slave.id)
                    self._send(identity, {"op": "update_ack", "ok": 0,
                                          "stale": 1, "req": req})
                    return
            update_ctx = obs_context.wire_extract(msg)
            apply_args = {"slave": slave.id}
            if update_ctx is not None:
                apply_args = update_ctx.span_args(apply_args)
            try:
                with trace.span("jobs", "apply_update", apply_args,
                                role="master"):
                    self.workflow.apply_data_from_slave(msg["data"],
                                                        slave)
                ok = 1
            except Exception:
                self.exception("bad update from %s", slave.id)
                ok = 0
            if seq is not None:
                slave.outstanding.pop(seq, None)
                # consumed either way: a failed apply must not be
                # replayable into a half-applied double
                self._applied[seq] = ok
                self._applied_order.append(seq)
                # evict the oldest entries — an evicted seq's replay
                # still lands in the `not in slave.outstanding` stale
                # branch above, so forgetting it can never double-apply
                while len(self._applied_order) > APPLIED_SEQ_WINDOW:
                    self._applied.pop(self._applied_order.popleft(),
                                      None)
            elif slave.outstanding:
                # legacy id-less update: retire the oldest outstanding
                slave.outstanding.popitem(last=False)
            slave.state = "WORKING" if slave.outstanding else "WAIT"
            self._updates_applied += 1
        slave.jobs_done += 1
        slave.job_updated()
        self._send(identity, {"op": "update_ack", "ok": ok,
                              "req": req})
        self._maybe_checkpoint()
        self._maybe_finish()

    def _on_pod_epoch(self, identity, slave, msg):
        """Pod control plane (the lease half of the pod rides it, ROADMAP
        item 7(e)): one
        frame per EPOCH, not per minibatch — a pod worker reports its
        lease progress (epoch counter, eval metrics, its runtime's
        generation after any elastic reshard) and the master answers
        whether to stop (Decision sync).  Also a checkpoint trigger:
        the master's epoch view advanced, so the ``checkpoint_every``
        / epoch-boundary cadence gets its chance off the hot path.

        Masters that are not pod-aware (no ``on_pod_epoch``) ack with
        ``stop: 0`` so a mixed deployment degrades to worker-side
        stopping instead of a protocol error."""
        reply = {"op": "pod_epoch_ack", "req": msg.get("req"),
                 "stop": 0}
        hook = getattr(self.workflow, "on_pod_epoch", None)
        if hook is not None:
            try:
                with self._lock:
                    out = hook(msg, slave)
                if out:
                    reply.update(out)
            except Exception:
                self.exception("on_pod_epoch failed for %s", slave.id)
        if trace.enabled():
            args = {"slave": slave.id, "epoch": msg.get("epoch"),
                    "lease": msg.get("lease"),
                    "pod_generation": msg.get("generation"),
                    "stop": reply.get("stop", 0)}
            epoch_ctx = obs_context.wire_extract(msg)
            if epoch_ctx is not None:
                args = epoch_ctx.span_args(args)
            trace.instant("jobs", "pod_epoch", args, role="master")
        self._send(identity, reply)
        self._maybe_checkpoint()

    def _on_prof(self, identity, slave, msg):
        """A slave shipped its trace-ring export + ledger summary at
        end-of-run (piggybacked on the job wire).  Stored with the
        heartbeat-estimated clock offset so
        :meth:`save_session_profile` writes a merge-ready bundle."""
        self.slave_profiles[slave.id] = {
            "events": msg.get("events") or [],
            "ledger": msg.get("ledger") or {},
            "offset_ns": slave.clock_offset_ns or 0,
        }
        self.info("slave %s shipped its performance profile "
                  "(%d trace event(s))", slave.id,
                  len(self.slave_profiles[slave.id]["events"]))
        self._send(identity, {"op": "prof_ack", "req": msg.get("req")})

    def save_session_profile(self, path, roles=None):
        """Write the session-profile bundle (master trace + ledger,
        every shipped slave profile + clock offset) for ``python -m
        veles_tpu_torch.prof merge``.  ``roles`` restricts the master's own
        events to the given trace roles — in-process test sessions
        share one ring with their slaves, so the master keeps only
        its ``master`` lanes there; real multi-process masters keep
        everything (default).  Call AFTER the slaves ``close()`` —
        ``finished`` fires on the last update, one round-trip before
        each slave ships its profile."""
        import json

        from veles_tpu_torch import prof
        events = trace.normalize()
        if roles is not None:
            events = [ev for ev in events if ev.get("role") in roles]
        bundle = {
            "kind": prof.merge.BUNDLE_KIND,
            "master": {"events": events,
                       "ledger": prof.ledger.summary()},
            "slaves": dict(self.slave_profiles),
        }
        with open(path, "w") as fout:
            json.dump(bundle, fout)
        return path

    # -- the master scrape endpoint ------------------------------------------
    def metrics_text(self):
        """The master's Prometheus exposition: exactly-once
        accounting, per-slave progress, heartbeat-watchdog excursions
        (`veles_jobs_heartbeat_stalls_total{slave=...}`) and the
        per-slave send→update round-trip histograms — previously
        ``print_stats``-only — as REAL histogram families through the
        shared renderer (:func:`veles_tpu_torch.metrics.emit_histogram`),
        same buckets as the serving layer so the two percentile
        columns compare on one dashboard.  A hosted workflow with its
        own ``metrics_text`` is appended."""
        from veles_tpu_torch.metrics import emit_histogram
        with self._lock:
            slaves = sorted(self.slaves.values(),
                            key=lambda s: s.id)
            stalls = dict(self.heartbeat_stalls)
        lines = [
            "# HELP veles_jobs_slaves connected slaves",
            "# TYPE veles_jobs_slaves gauge",
            "veles_jobs_slaves %d" % len(slaves),
            "# TYPE veles_jobs_generation gauge",
            "veles_jobs_generation %d" % self.generation,
            "# TYPE veles_jobs_updates_applied_total counter",
            "veles_jobs_updates_applied_total %d"
            % self._updates_applied,
            "# HELP veles_jobs_dedup_dropped_total duplicated update "
            "frames deduplicated (exactly-once accounting)",
            "# TYPE veles_jobs_dedup_dropped_total counter",
            "veles_jobs_dedup_dropped_total %d" % self.dedup_dropped,
            "# TYPE veles_jobs_stale_rejected_total counter",
            "veles_jobs_stale_rejected_total %d" % self.stale_rejected,
            "# TYPE veles_jobs_lost_requeued_total counter",
            "veles_jobs_lost_requeued_total %d" % self.lost_requeued,
            "# HELP veles_jobs_heartbeat_stalls_total heartbeat-"
            "watchdog excursions per slave "
            "(root.common.engine.heartbeat_warn_ms)",
            "# TYPE veles_jobs_heartbeat_stalls_total counter",
        ]
        for sid in sorted(stalls):
            lines.append(
                'veles_jobs_heartbeat_stalls_total{slave="%s"} %d'
                % (sid, stalls[sid]))
        lines.append("# TYPE veles_jobs_done_total counter")
        for slave in slaves:
            lines.append('veles_jobs_done_total{slave="%s"} %d'
                         % (slave.id, slave.jobs_done))
        lines.append("# TYPE veles_jobs_in_flight gauge")
        for slave in slaves:
            lines.append('veles_jobs_in_flight{slave="%s"} %d'
                         % (slave.id, slave.in_flight))
        # ONE family header with every slave's label variant grouped
        # under it (a second TYPE line for the same name kills the
        # whole scrape)
        lines.append("# HELP veles_jobs_job_latency_seconds job "
                     "send->update round-trip per slave (generation "
                     "handoff + wire + slave compute + master apply)")
        lines.append("# TYPE veles_jobs_job_latency_seconds histogram")
        for slave in slaves:
            if slave.latency.count:
                emit_histogram(lines, "veles_jobs_job_latency_seconds",
                               slave.latency, None,
                               labels={"slave": slave.id})
        text = "\n".join(lines) + "\n"
        workflow_text = getattr(self.workflow, "metrics_text", None)
        if workflow_text is not None:
            try:
                text += workflow_text()
            except Exception:  # noqa: BLE001 - exposition edge
                self.exception("hosted workflow metrics_text failed")
        return text

    def start_scrape(self, host="127.0.0.1", port=0):
        """Mount the master's ``/metrics`` endpoint
        (:class:`veles_tpu_torch.obs.scrape.ScrapeServer`): this exposition
        plus the process-wide base (perf-ledger gauges, trace
        counters when tracing is on).  Idempotent; stopped with the
        server."""
        if self._scrape is None:
            from veles_tpu_torch.obs import scrape
            self._scrape = scrape.ScrapeServer(
                scrape.default_sources(extra=(self.metrics_text,)),
                host=host, port=port, role="master").start()
        return self._scrape

    # -- crash recovery -----------------------------------------------------
    def _checkpointer(self):
        if self._ckpt is None:
            from veles_tpu_torch.checkpoint import TrainCheckpointer
            self._ckpt = TrainCheckpointer(self.checkpoint_dir)
        return self._ckpt

    def _maybe_checkpoint(self):
        """Checkpoint trigger: ``checkpoint_every`` applied updates after
        the last write, plus every epoch boundary (detected as the
        master epoch advancing between updates)."""
        if not self.checkpoint_dir:
            return
        # due from the last write STARTED, not at multiples of K: a
        # trigger skipped while a write was in flight retries at the
        # next update instead of waiting K more
        due = bool(self.checkpoint_every
                   and self._updates_applied - self._last_ckpt_step
                   >= self.checkpoint_every)
        epoch = self._master_epoch()
        if self._last_ckpt_epoch is None:
            self._last_ckpt_epoch = epoch
        elif epoch != self._last_ckpt_epoch:
            due = True
        if due and self.checkpoint_async():
            # the epoch trigger stays armed across a busy skip or a
            # failed capture: _last_ckpt_epoch advances only once a
            # write is actually in flight, so the next applied update
            # retries — otherwise the epoch-only cadence
            # (checkpoint_every=0) silently doubles its recovery
            # window whenever a boundary lands mid-write
            self._last_ckpt_epoch = epoch

    def checkpoint_async(self):
        """Non-blocking checkpoint: the train state is CAPTURED
        synchronously under the server lock (numpy copies — consistent
        by construction), then WRITTEN on the host thread pool so the
        server loop never waits on the write.  At most one write is in
        flight; a trigger landing mid-write is skipped (the next one
        covers it)."""
        capture = getattr(self.workflow, "capture_train_state", None)
        if capture is None or self._ckpt_busy.is_set():
            return False
        self._ckpt_busy.set()
        try:
            with self._lock:
                train, meta = capture()
                meta = dict(meta or {})
                meta["__server__"] = {
                    "generation": self.generation,
                    "seq": self._seq,
                    "updates_applied": self._updates_applied,
                    "epoch": self._master_epoch(),
                }
                step = self._updates_applied
        except Exception:
            self._ckpt_busy.clear()
            self.exception("train-state capture for checkpoint failed")
            return False
        self._last_ckpt_step = step
        from veles_tpu_torch import thread_pool
        thread_pool.submit(self._write_checkpoint, step, train, meta)
        return True

    def _write_checkpoint(self, step, train, meta):
        try:
            with trace.span("jobs", "checkpoint",
                            {"step": step,
                             "epoch": meta["__server__"]["epoch"]},
                            role="master"):
                self._checkpointer().save(step, train, meta)
        except Exception:
            self.exception("checkpoint write for step %d failed", step)
        finally:
            self._ckpt_busy.clear()

    def resume_from_checkpoint(self, step=None):
        """Master crash-recovery: restore the latest (or given)
        checkpoint into the workflow, adopt its seq counter, and bump
        the generation so any update computed against the pre-crash
        master is recognizably stale.  Call BEFORE :meth:`start`."""
        if not self.checkpoint_dir:
            raise RuntimeError("no checkpoint_dir configured to "
                               "resume from")
        capture = getattr(self.workflow, "capture_train_state", None)
        if capture is None:
            raise RuntimeError(
                "workflow %r does not implement the checkpoint "
                "protocol (capture_train_state/restore_train_state)"
                % type(self.workflow).__name__)
        abstract, _meta_now = capture()
        step, train, meta = self._checkpointer().restore(abstract,
                                                         step=step)
        meta = dict(meta or {})
        srv = meta.pop("__server__", {})
        self.workflow.restore_train_state(train, meta)
        self.generation = int(srv.get("generation", self.generation)) \
            + 1
        self._seq = int(srv.get("seq", 0))
        self._updates_applied = int(srv.get("updates_applied",
                                            step or 0))
        self._last_ckpt_step = self._updates_applied
        self._last_ckpt_epoch = self._master_epoch()
        trace.instant("jobs", "resume",
                      {"step": step, "generation": self.generation,
                       "epoch": self._last_ckpt_epoch,
                       "seq": self._seq},
                      role="master")
        self.info(
            "resumed from checkpoint step %d (generation %d, epoch "
            "%d, seq %d) — pre-restart updates will be rejected as "
            "stale; live slaves rejoin via re-handshake", step,
            self.generation, self._last_ckpt_epoch, self._seq)
        return step

    def kill(self):
        """Abrupt-crash simulation (the chaos ``master_kill`` fault,
        callable from tests): tear the server down with no graceful
        drain, stats, or checkpoint — what a SIGKILL leaves behind.
        Slaves see a silent endpoint and enter their reconnect
        backoff."""
        self.killed = True
        self.stop()

    def _reap_dead_slaves(self):
        """Timeout-based failure detection (replaces Twisted
        connectionLost, ref ``server.py:315-339``); zero-progress slaves
        are blacklisted like the reference's hung-slave sweep
        (``:377-394``).  Before the hard timeout, the heartbeat
        watchdog (``root.common.engine.heartbeat_warn_ms``, default
        off) flags creeping gaps: WARNING + ``jobs:heartbeat_stall``
        trace instant, once per excursion."""
        from veles_tpu_torch.config import root
        warn_ms = root.common.engine.get("heartbeat_warn_ms", 0) or 0
        now = time.time()
        for sid, slave in list(self.slaves.items()):
            gap = now - slave.last_seen
            if gap > self.slave_timeout:
                self.warning("slave %s timed out", sid)
                if slave.jobs_done == 0:
                    self.blacklist.add(sid)
                self.drop_slave(sid)
                continue
            if warn_ms and gap * 1e3 > float(warn_ms) \
                    and not slave.hb_warned:
                slave.hb_warned = True
                # once per excursion, same latch as the WARNING — the
                # veles_jobs_heartbeat_stalls_total{slave=...} counter
                # on the master scrape endpoint
                self.heartbeat_stalls[sid] += 1
                trace.instant("jobs", "heartbeat_stall",
                              {"slave": sid,
                               "gap_ms": round(gap * 1e3, 1)},
                              role="master")
                self.warning(
                    "slave %s heartbeat stalled: %.0f ms since last "
                    "contact (heartbeat_warn_ms=%s; hard timeout at "
                    "%.0f ms)", sid, gap * 1e3, warn_ms,
                    self.slave_timeout * 1e3)

    def drop_slave(self, sid):
        with self._lock:
            slave = self.slaves.pop(sid, None)
            if slave is None:
                return
            self.workflow.drop_slave(slave)
        self.info("dropped slave %s (%d jobs done)", sid,
                  slave.jobs_done)
        self._maybe_finish()

    def _maybe_finish(self):
        if self.finished and self.on_finished is not None:
            cb, self.on_finished = self.on_finished, None
            cb()

    def print_stats(self):
        """Per-slave job table, now with round-trip latency
        percentiles (send→update, the whole pipeline: generation
        handoff + wire + slave compute + master apply) from the shared
        :class:`veles_tpu_torch.metrics.LatencyHistogram` — the same buckets
        the serving layer reports, so the two columns compare."""
        if self.dedup_dropped or self.stale_rejected \
                or self.lost_requeued:
            self.info(
                "exactly-once accounting: %d duplicate update(s) "
                "deduplicated, %d stale update(s) rejected, %d lost "
                "job frame(s) requeued", self.dedup_dropped,
                self.stale_rejected, self.lost_requeued)
        for slave in self.slaves.values():
            self.info("  %r", slave)
            hist = slave.latency
            if hist.count:
                self.info(
                    "    job latency: n=%d mean=%.1f ms p50=%.1f ms "
                    "p95=%.1f ms p99=%.1f ms",
                    hist.count, hist.mean * 1e3,
                    hist.percentile(50) * 1e3,
                    hist.percentile(95) * 1e3,
                    hist.percentile(99) * 1e3)


def _default_power():
    """The power a slave advertises for the master's balancing when none
    is given: 1.0, every slave equal.  The JAX package reads the device
    ratings database here, which is not ported yet (ROADMAP item 7(e));
    a handshake never measures inline."""
    return 1.0


class JobClient(Logger):
    """Slave: pulls jobs, runs them through ``workflow.do_job``, pushes
    updates.  Reconnects with backoff; a mid-run join is just a late
    handshake (elastic membership)."""

    def __init__(self, workflow, endpoint, sid=None, power=None,
                 death_probability=0.0,
                 heartbeat_interval=HEARTBEAT_INTERVAL,
                 reconnect_max_wait=30.0, rpc_timeout_ms=5000):
        super(JobClient, self).__init__()
        self.workflow = workflow
        self.endpoint = endpoint
        self.sid = sid or uuid.uuid4().hex[:8]
        self.power = power if power is not None else _default_power()
        #: fault injection (ref --slave-death-probability client.py:303)
        #: — seeded from the chaos controller so even this legacy
        #: knob's kills replay from the seed, and counted via
        #: record_external so faults_injected never reads 0 while
        #: deaths fire
        self.death_probability = death_probability
        self._death_rng = random.Random(chaos.controller.seed)
        self.heartbeat_interval = heartbeat_interval
        #: how long a silent/rejecting master is retried with backoff
        #: before the slave gives up (master restarts take seconds;
        #: the default rides out a kill + resume comfortably)
        self.reconnect_max_wait = float(reconnect_max_wait)
        #: default per-rpc reply timeout (tests/chaos sessions lower it
        #: so fault recovery paths run in milliseconds, not seconds)
        self.rpc_timeout_ms = int(rpc_timeout_ms)
        self._socket = wire.Dealer(endpoint)
        #: the heartbeat thread and the job loop share the stream under
        #: this lock
        self._socket_lock = threading.Lock()
        self.jobs_done = 0
        #: the master's run generation from the last welcome — job ids
        #: from an older generation are discarded after a rejoin
        self.generation = None
        #: job seqs received but not yet acked — the ``have`` list in
        #: every job_request (the master requeues what we DON'T have)
        self._in_hand = set()
        #: client-monotonic request counter echoed in replies: lets a
        #: retried rpc skip orphan replies of timed-out predecessors
        self._req = 0
        #: the per-role Prometheus listener (obs.scrape), mounted by
        #: start_scrape()
        self._scrape = None

    @property
    def trace_role(self):
        """The per-slave pid label in exported traces."""
        return "slave-%s" % self.sid

    def _next_req(self):
        self._req += 1
        return self._req

    def _chaos_send(self, msg):
        """Socket send with the ``slave_send`` chaos site applied:
        the frame may be dropped (the rpc then times out — exercising
        the retry paths), duplicated, delayed or corrupted."""
        blob = pickle.dumps(msg, pickle.HIGHEST_PROTOCOL)
        if chaos.controller.armed:
            chaos.controller.send_wire(
                "slave_send", msg.get("op"), blob, self._socket.send,
                role=self.trace_role)
            return
        self._socket.send(blob)

    def _chaos_recv_dropped(self, reply):
        """``slave_recv`` chaos site: True when this arriving reply
        must be treated as lost (the caller keeps polling and times
        out, exactly as if the network ate it)."""
        if not chaos.controller.armed:
            return False
        plan = chaos.controller.wire("slave_recv", reply.get("op"),
                                     role=self.trace_role)
        if plan.delay_s:
            time.sleep(plan.delay_s)
        # a reply corrupted on the receive side is a lost reply: the
        # already-decoded dict cannot be bit-flipped, so corrupt
        # degrades to drop and the injection count stays honest (dup
        # is rejected for this site at schedule validation)
        return plan.deliveries == 0 or plan.corrupt

    def _recv_our_reply(self, req, sent_op, accept_reqless_reject=False):
        """Drain ONE frame (caller polled first) and return it iff it
        answers OUR request ``req``, else None.  The single reply
        filter both receive loops share — skipping, in order:

        * an undecodable frame (corrupted on the wire — a LOST frame,
          not a slave crash; the master side logs and skips the same
          way);
        * a reply the ``slave_recv`` chaos site eats;
        * a stale pong from a timed-out heartbeat (a pong is only an
          answer when we actually sent a ping);
        * any reply not echoing our req — an orphan answer to an rpc
          that already timed out (master was stalled, not dead) or a
          req-less stray routed at our identity.  Skipping those is
          what keeps the stream in sync across retries.

        ``accept_reqless_reject`` carves the one exception: a req-less
        ``reject`` answers a bare keepalive ping — the master forgot
        us after this request's reply was lost; the ping-waiting
        caller consumes it to rejoin instead of waiting out its
        deadline."""
        try:
            reply = pickle.loads(self._socket.recv())
        except Exception:
            self.warning("undecodable reply from master — treating "
                         "as lost")
            return None
        if self._chaos_recv_dropped(reply):
            return None
        if reply.get("op") == "pong" and sent_op != "ping":
            return None
        if reply.get("req") != req and not (
                accept_reqless_reject
                and reply.get("op") == "reject"
                and reply.get("req") is None):
            return None
        return reply

    def _rpc(self, msg, timeout_ms=None):
        if timeout_ms is None:
            timeout_ms = self.rpc_timeout_ms
        msg = dict(msg)
        with self._socket_lock:
            # req allocated under the lock: the heartbeat thread rpcs
            # concurrently with the job thread, and a duplicated req
            # would let one rpc consume the other's reply
            req = msg["req"] = self._next_req()
            self._chaos_send(msg)
            while True:
                if not self._socket.poll(timeout_ms):
                    raise TimeoutError("no reply from master for %r" %
                                       msg.get("op"))
                reply = self._recv_our_reply(req, msg.get("op"))
                if reply is not None:
                    return reply

    def _request_with_pings(self, msg, max_wait=600.0):
        """Send one request and wait for its reply, emitting pings
        while waiting.  Replies stay ordered on the stream, so
        the first non-pong, req-matching reply IS the answer;
        abandoning early would desync the stream — hence one generous
        overall cap that treats the master as gone."""
        msg = dict(msg)
        deadline = time.time() + max_wait
        with self._socket_lock:
            req = msg["req"] = self._next_req()
            self._chaos_send(msg)
            while True:
                if self._socket.poll(
                        int(self.heartbeat_interval * 1000)):
                    reply = self._recv_our_reply(
                        req, msg.get("op"), accept_reqless_reject=True)
                    if reply is None:
                        continue
                    return reply
                if time.time() > deadline:
                    raise TimeoutError(
                        "master silent for %.0fs during %r"
                        % (max_wait, msg.get("op")))
                self._chaos_send(
                    {"op": "ping", "id": self.sid,
                     "t_ns": time.perf_counter_ns()})

    def control(self, msg, timeout_ms=None):
        """Public control-plane rpc: send one op dict (the ``id`` is
        filled in) and return its reply — what the pod membership
        layer's per-epoch sync rides instead of reaching into
        :meth:`_rpc`.  Raises ``TimeoutError`` when the master stays
        silent; callers decide between :meth:`_reconnect` and giving
        up (the pod worker reconnects — its training state lives in
        its own memory, not the master's)."""
        msg = dict(msg)
        msg.setdefault("id", self.sid)
        return self._rpc(msg, timeout_ms=timeout_ms)

    def _heartbeat_loop(self, stop_event):
        """Keeps the master's last_seen fresh while a long job runs
        (replaces the reference's Twisted connection liveness)."""
        while not stop_event.wait(self.heartbeat_interval):
            try:
                # t_ns: our perf_counter stamp — the master's clock-
                # offset estimate for the cluster trace merge
                self._rpc({"op": "ping", "id": self.sid,
                           "t_ns": time.perf_counter_ns()},
                          timeout_ms=2000)
            except TimeoutError:
                pass

    def handshake(self):
        try:
            checksum = self.workflow.checksum()
        except Exception as e:
            raise ConnectionError(
                "cannot checksum our workflow for the handshake (%s) — "
                "slave workflows must be importable module code" % e) \
                from e
        reply = self._rpc({"op": "handshake", "id": self.sid,
                           "power": self.power, "checksum": checksum})
        if reply["op"] != "welcome":
            raise ConnectionError(
                "master rejected us: %s" % reply.get("reason"))
        self.sid = reply["id"]
        previous_gen, self.generation = self.generation, \
            reply.get("gen")
        if previous_gen is not None \
                and self.generation != previous_gen:
            # the master restarted and resumed: reconcile to ITS
            # position instead of starting over — anything we still
            # hold belongs to the dead generation
            self.warning(
                "master restarted (generation %s → %s): reconciled at "
                "epoch %s, seq %s; discarding %d in-hand job(s)",
                previous_gen, self.generation, reply.get("epoch"),
                reply.get("seq"), len(self._in_hand))
        self._in_hand.clear()
        if reply.get("gen") is not None:
            self.info("joined generation %s at epoch %s (master seq "
                      "%s)", reply.get("gen"), reply.get("epoch"),
                      reply.get("seq"))
        # what the per-job run() dispatches: the segments (the slave's
        # surgery re-stitched inside StandardWorkflow.initialize, so
        # this is the post-surgery chain)
        segments = getattr(self.workflow, "stitch_segments", None)
        if segments:
            self.info("stitched slave: %d segment(s) a job (%s)",
                      len(segments), "; ".join(
                          "+".join(seg.names) for seg in segments))
        return self

    def run(self, max_jobs=None):
        """Job loop: request → do_job → update, until no_more_jobs."""
        return self._run_loop(max_jobs, prefetch=False)

    def run_prefetch(self, max_jobs=None):
        """Async double-buffered loop (ref ``_balance=2``,
        ``server.py:262-281`` + ``client.py:293-296``): the NEXT job is
        requested while the current one computes, overlapping the
        master's job generation with slave compute.

        Only for masters that tolerate two in-flight jobs per slave
        (DP-style index partitioning); per-slave single-slot
        bookkeepers (GeneticsOptimizer, EnsembleModelManager) need the
        plain :meth:`run`.
        """
        return self._run_loop(max_jobs, prefetch=True)

    def _reconnect(self, why=""):
        """Backoff re-handshake loop — the slave half of master
        crash-recovery AND partition healing.  Retries until the
        master answers (welcome → reconciled, True), permanently
        rejects us (blacklisted → False), or ``reconnect_max_wait``
        runs out (False)."""
        deadline = time.time() + self.reconnect_max_wait
        backoff = 0.2
        self.warning("lost the master (%s) — re-handshaking with "
                     "backoff for up to %.0f s", why or "silent",
                     self.reconnect_max_wait)
        while time.time() < deadline:
            # a new stream: TCP does not reconnect by itself, and what
            # the old one still held answers nothing asked again
            with self._socket_lock:
                self._socket.reconnect()
            try:
                self.handshake()
            except ConnectionError as e:
                if "blacklisted" in str(e):
                    self.error("master blacklisted us — giving up: %s",
                               e)
                    return False
                if "checksum" in str(e):
                    # deterministic reject: a restarted master running
                    # different workflow code will refuse this same
                    # handshake every time — spinning out the backoff
                    # window would only misreport it as 'unreachable'
                    self.error("workflow checksum mismatch with the "
                               "(restarted?) master — giving up: %s", e)
                    return False
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
                continue
            except (TimeoutError, OSError):
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
                continue
            trace.instant("jobs", "rejoin",
                          {"gen": self.generation, "why": why},
                          role=self.trace_role)
            return True
        self.error("master unreachable for %.0f s — giving up",
                   self.reconnect_max_wait)
        return False

    def _send_update_with_retry(self, data, job_id, ctx=None):
        """Push one update with drop-after-apply safety: a lost ack is
        retried with the SAME job id (master-side dedup makes the
        replay provably harmless); a master that stays silent is
        re-handshaked, and the update is discarded only when the
        rejoin lands in a NEWER generation (the delta is stale by
        construction then).  Returns the ack, or None when the master
        is gone for good.  ``ctx`` (the job frame's trace context)
        rides the update frame back so the master's apply span joins
        the same request waterfall."""
        msg = {"op": "update", "id": self.sid, "data": data}
        if job_id:
            msg["job"] = job_id
        if ctx is not None:
            obs_context.wire_inject(msg, ctx)
        for attempt in range(3):
            try:
                with trace.span("jobs", "update",
                                ctx.span_args() if ctx is not None
                                else None,
                                role=self.trace_role):
                    ack = self._rpc(dict(msg))
            except TimeoutError:
                self.warning(
                    "update ack lost (attempt %d/3) — re-sending the "
                    "same job id (dedup makes the replay harmless)",
                    attempt + 1)
                continue
            if ack.get("op") == "reject":
                # master forgot us (restart without resume, partition
                # heal after a reap): rejoin, then decide below
                break
            if not ack.get("ok"):
                if ack.get("stale"):
                    self.warning("master rejected our update as stale "
                                 "(job %r)", job_id)
                else:
                    self.warning("master refused our update")
            return ack
        if not self._reconnect("no ack for our update"):
            return None
        if job_id and self.generation == job_id.get("gen"):
            # same generation: the master was stalled, not replaced.
            # The rejoin handshake requeued everything we had
            # outstanding, so this resend can no longer be APPLIED —
            # its one job is to distinguish applied-then-ack-lost
            # (master dedups it → ok+dup, our work counted) from
            # never-applied (stale reject; the requeued minibatch is
            # recomputed, never double-applied)
            try:
                return self._rpc(dict(msg))
            except TimeoutError:
                return {"ok": 0}
        self.warning("discarding update for job %r after rejoining "
                     "generation %s", job_id, self.generation)
        return {"ok": 0, "stale": 1}

    def _run_loop(self, max_jobs, prefetch):
        next_reply = None   # prefetched reply not yet processed
        while max_jobs is None or self.jobs_done < max_jobs:
            if next_reply is not None:
                reply = next_reply
            else:
                try:
                    with trace.span("jobs", "job_request",
                                    role=self.trace_role):
                        reply = self._rpc(
                            {"op": "job_request", "id": self.sid,
                             "have": sorted(self._in_hand)})
                except TimeoutError:
                    if not self._reconnect("silent on job_request"):
                        return False
                    continue
            next_reply = None
            if reply["op"] == "no_more_jobs":
                break
            if reply["op"] == "wait":
                time.sleep(self.heartbeat_interval / 10.0)
                continue
            if reply["op"] == "reject":
                reason = reply.get("reason")
                if reason == "blacklisted":
                    self.error("master blacklisted us — giving up")
                    return False
                # "unknown id"/"dropped": the master forgot us (reaped
                # during a partition that then healed, or restarted) —
                # rejoin instead of dying, so a healed partition
                # degrades to requeued work, not a lost slave
                self.warning("master rejected us (%s) — re-handshaking",
                             reason)
                if not self._reconnect("rejected: %s" % reason):
                    return False
                continue
            if reply["op"] == "job_error":
                # the master is alive but cannot generate our job (a
                # real exception, not NoJobYet): die loudly — a
                # rejoin-and-retry here would livelock against a
                # persistent master-side bug
                raise ConnectionError(
                    "master failed generating our job: %s"
                    % reply.get("error"))
            if reply["op"] != "job":
                raise ConnectionError("unexpected reply %r" % reply["op"])
            job_id = reply.get("job") or {}
            # the job frame's distributed-trace context: this job's
            # spans (and the update's) join the master's waterfall
            job_ctx = obs_context.wire_extract(reply)
            if job_id.get("seq") is not None:
                self._in_hand.add(job_id["seq"])
            if chaos.controller.armed:
                # chaos process boundary: the slave holds a job now, so
                # a kill/hang here exercises the master's reaper AND
                # the requeue of in-flight work
                fault = chaos.controller.process(
                    "slave_job", role=self.trace_role)
                if fault is not None:
                    if fault.action == "slave_kill":
                        self.warning("fault injection: dying mid-job "
                                     "(chaos slave_kill)")
                        blackbox.dump("chaos slave_kill",
                                      extra={"slave": self.sid})
                        return False
                    if fault.action == "slave_hang":
                        # a hang is WORSE than a death for the master:
                        # no connection-loss event, just silence — the
                        # reaper must time us out
                        self.warning("fault injection: hanging %.1f s",
                                     fault.duration_s)
                        time.sleep(fault.duration_s)
            if self.death_probability and \
                    self._death_rng.random() < self.death_probability:
                chaos.controller.record_external(
                    "slave_kill", "slave_job", role=self.trace_role)
                self.warning("fault injection: dying mid-job")
                blackbox.dump("slave_death_probability kill",
                              extra={"slave": self.sid})
                return False
            result = [None]
            stop_hb = threading.Event()
            hb = threading.Thread(target=self._heartbeat_loop,
                                  args=(stop_hb,), daemon=True)
            hb.start()
            try:
                # don't prefetch past max_jobs — a job handed out on the
                # final iteration would be silently dropped (the master
                # counts it served but never gets an update)
                want_prefetch = prefetch and (
                    max_jobs is None or self.jobs_done + 1 < max_jobs)
                if want_prefetch:
                    # compute in a worker while the master generates the
                    # next job — the double-buffer overlap
                    error = []

                    def compute():
                        try:
                            with obs_context.activate(job_ctx), \
                                    trace.span(
                                        "jobs", "do_job",
                                        job_ctx.span_args()
                                        if job_ctx is not None
                                        else None,
                                        role=self.trace_role):
                                self.workflow.do_job(
                                    reply["data"],
                                    lambda out: result.__setitem__(
                                        0, out))
                        except BaseException as e:
                            error.append(e)

                    worker = threading.Thread(target=compute)
                    worker.start()
                    # generation is EXPECTED to be slow here (the
                    # overlap is the point); the wait pings from inside
                    # the socket lock so the master keeps seeing us
                    # alive while the external heartbeat thread is
                    # locked out
                    try:
                        next_reply = self._request_with_pings(
                            {"op": "job_request", "id": self.sid,
                             "have": sorted(self._in_hand)})
                    except TimeoutError:
                        # master gone mid-prefetch: finish the current
                        # job; the update path below reconnects
                        next_reply = None
                    if next_reply is not None \
                            and next_reply.get("op") == "job":
                        nxt_id = next_reply.get("job") or {}
                        if nxt_id.get("seq") is not None:
                            self._in_hand.add(nxt_id["seq"])
                        # overlap the NEXT minibatch's IO with the rest
                        # of the current compute (loader-side
                        # double-buffering, ref client.py:293-296;
                        # device-resident loaders stage the next job's
                        # index-span upload here instead of a fill)
                        prefetch_hook = getattr(
                            self.workflow, "prefetch_job", None)
                        if prefetch_hook is not None:
                            prefetch_hook(next_reply["data"])
                    worker.join()
                    if error:
                        raise error[0]
                else:
                    with obs_context.activate(job_ctx), \
                            trace.span("jobs", "do_job",
                                       job_ctx.span_args()
                                       if job_ctx is not None
                                       else None,
                                       role=self.trace_role):
                        self.workflow.do_job(
                            reply["data"],
                            lambda out: result.__setitem__(0, out))
            finally:
                stop_hb.set()
                hb.join(self.heartbeat_interval + 3)
            ack = self._send_update_with_retry(result[0], job_id,
                                               job_ctx)
            if ack is None:
                return False            # master is gone for good
            if job_id.get("seq") is not None:
                self._in_hand.discard(job_id["seq"])
            self.jobs_done += 1
        self._ship_profile()
        return True

    def _ship_profile(self):
        """End-of-run: ship our trace-ring export + performance-
        ledger summary to the master over the job wire (op ``prof``)
        so the cluster merge sees this slave's timeline without a
        side channel.  Only when tracing is on; best-effort in two
        documented ways: a master torn down the moment its last
        update landed (launcher-driven ``on_finished`` → ``stop()``)
        may miss the shipment — keep the server up until slaves
        ``close()`` when you want the bundle — and a process hosting
        SEVERAL slaves shares one ring/ledger, so default-role
        (trainer) lanes and the ledger summary cannot be split
        between them (real deployments run one slave per process;
        the filter below is exact there)."""
        if not trace.enabled():
            return
        from veles_tpu_torch import prof
        own_role = self.trace_role
        # in-process sessions share ONE ring with the master (tests,
        # single-host mixed roles): ship only our own lanes — the
        # default-role (trainer) spans our workflow recorded plus our
        # explicit slave-<sid> job spans; a real separate-process
        # slave owns everything it recorded anyway
        events = [ev for ev in trace.normalize()
                  if ev.get("role") != "master"
                  and (not str(ev.get("role") or "").startswith(
                      "slave-") or ev.get("role") == own_role)]
        try:
            reply = self._rpc({"op": "prof", "id": self.sid,
                               "events": events,
                               "ledger": prof.ledger.summary()})
            if reply.get("op") != "prof_ack":
                self.warning("master did not ack our profile: %r",
                             reply.get("op"))
        except (TimeoutError, ConnectionError) as exc:
            self.warning("could not ship profile to master: %s", exc)

    # -- the slave scrape endpoint -------------------------------------------
    def metrics_text(self):
        """The slave's Prometheus exposition: job progress and
        membership state next to the process-wide base (perf ledger,
        trace counters) the scrape server appends."""
        lines = [
            "# HELP veles_slave_jobs_done_total jobs completed by "
            "this slave",
            "# TYPE veles_slave_jobs_done_total counter",
            "veles_slave_jobs_done_total %d" % self.jobs_done,
            "# TYPE veles_slave_jobs_in_hand gauge",
            "veles_slave_jobs_in_hand %d" % len(self._in_hand),
            "# TYPE veles_slave_generation gauge",
            "veles_slave_generation %d" % (self.generation or 0),
        ]
        return "\n".join(lines) + "\n"

    def start_scrape(self, host="127.0.0.1", port=0,
                     extra_sources=(), role=None):
        """Mount this slave's ``/metrics`` endpoint — every role is
        Prometheus-scrapeable, not just the serving server.
        ``extra_sources``/``role`` let wrappers add their own
        exposition slices to the same mount.
        Idempotent — but a second call with DIFFERENT extras gets the
        existing endpoint unchanged, loudly.  Stopped by
        :meth:`close`."""
        if self._scrape is None:
            from veles_tpu_torch.obs import scrape
            self._scrape = scrape.ScrapeServer(
                scrape.default_sources(
                    extra=(self.metrics_text,) + tuple(extra_sources)),
                host=host, port=port,
                role=role or self.trace_role).start()
        elif extra_sources:
            self.warning(
                "scrape endpoint already mounted on port %d — the "
                "extra sources of this call are NOT added; mount "
                "once with every source", self._scrape.port)
        return self._scrape

    def close(self):
        if self._scrape is not None:
            self._scrape.stop()
            self._scrape = None
        with self._socket_lock:
            self._socket.send(pickle.dumps({"op": "bye", "id": self.sid}))
            self._socket.close()
