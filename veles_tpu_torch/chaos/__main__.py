"""``python -m veles_tpu_torch.chaos``: the fault-injection CLI, the
port's counterpart of :mod:`veles_tpu.chaos.__main__`.

``--smoke`` runs a fixed-seed, in-process master–slave session over the
port's job wire (:mod:`veles_tpu_torch.parallel.wire`, real TCP sockets)
with a schedule that kills a slave mid-job, drops a job frame and
duplicates an update frame.  It must complete — no hang, every job
applied EXACTLY once, the dedup and requeue counters consistent with
the injections — or exit non-zero.  ``--schedule file.json`` replays a
saved schedule instead (then only the universal gates apply: the session
completes and every job applies exactly once); ``--json`` prints the
machine-readable summary.
"""

import argparse
import collections
import json
import sys

from veles_tpu_torch.chaos.core import ChaosSchedule, controller

#: the smoke's built-in schedule: one slave death holding a job, one
#: lost job frame (master→slave), one duplicated update frame
#: (slave→master): the three headline faults of the robustness model
SMOKE_SCHEDULE = [
    {"site": "slave_job", "action": "slave_kill", "nth": 5},
    {"site": "master_send", "action": "drop", "op": "job", "nth": 2},
    {"site": "slave_send", "action": "dup", "op": "update", "nth": 3},
]
SMOKE_JOBS = 12
SMOKE_SEED = 20260804


class SmokeMaster(object):
    """Requeueing scripted master: jobs are numbered 1..n, a dropped
    slave's (or lost frame's) numbers go back on the queue — the same
    no-work-lost contract the real loader keeps via
    ``failed_minibatches``."""

    def __init__(self, n_jobs):
        self.queue = collections.deque(range(1, n_jobs + 1))
        self.pending = {}
        self.applied = []
        #: job numbers returned to the queue (reaper drop OR lost-frame
        #: rejoin — both recovery paths land here)
        self.requeues = 0

    def checksum(self):
        return "chaos-smoke-v1"

    def generate_data_for_slave(self, slave):
        from veles_tpu_torch.workflow import NoJobYet
        if not self.queue:
            if any(self.pending.values()):
                # outstanding work may still be requeued — a None here
                # would latch no_more_jobs and lose it forever
                raise NoJobYet
            return None
        number = self.queue.popleft()
        self.pending.setdefault(slave.id, []).append(number)
        return {"job_number": number}

    def apply_data_from_slave(self, data, slave):
        number = data["result"]
        mine = self.pending.get(slave.id, [])
        if number in mine:
            mine.remove(number)
        self.applied.append(number)

    def drop_slave(self, slave):
        numbers = self.pending.pop(slave.id, [])
        self.requeues += len(numbers)
        self.queue.extend(numbers)


class SmokeSlave(object):
    def checksum(self):
        return "chaos-smoke-v1"

    def do_job(self, data, callback):
        callback({"result": data["job_number"]})


def run_smoke(schedule=None, seed=SMOKE_SEED, n_jobs=SMOKE_JOBS,
              as_json=False):
    from veles_tpu_torch.parallel.jobs import JobClient, JobServer

    controller.arm(schedule if schedule is not None
                   else list(SMOKE_SCHEDULE), seed=seed)
    master = SmokeMaster(n_jobs)
    # slave_timeout ABOVE the client's 5 s rpc timeout: a dropped job
    # frame is then recovered by the client's reconnect/rejoin (the
    # lost-frame requeue path) rather than racing the reaper; the dead
    # slave's requeue still exercises the reaper path
    server = JobServer(master, slave_timeout=8.0,
                       heartbeat_interval=0.4).start()
    survivors = []
    try:
        # slave 1 is scheduled to die holding a job; slave 2 joins
        # afterwards (elastic membership) and finishes the queue
        for _ in range(3):
            client = JobClient(SmokeSlave(), server.endpoint,
                               heartbeat_interval=0.4,
                               reconnect_max_wait=10.0)
            client.handshake()
            survived = client.run()
            client.close()
            survivors.append(survived)
            if survived:
                break
    finally:
        server.stop()
        snap = controller.snapshot()
        controller.disarm()

    expected = list(range(1, n_jobs + 1))
    problems = []
    if sorted(master.applied) != expected:
        problems.append(
            "jobs not applied exactly once: %r" % (
                sorted(master.applied),))
    if not master.applied:
        problems.append("zero jobs done")
    if not survivors or not survivors[-1]:
        problems.append("no slave survived to session end")
    injected = snap["injected"]
    if schedule is None:
        # consistency checks tied to the BUILT-IN schedule's exact
        # faults (one slave_send update dup, one master_send job drop,
        # one slave kill) — a user-replayed --schedule keeps only the
        # universal gates above: its faults may dup acks (no master
        # dedup), drop nothing, or kill nobody, and each would trip
        # these spuriously
        if not any(s is False for s in survivors):
            problems.append("the scheduled slave death never fired")
        if server.dedup_dropped < injected.get("dup", 0):
            # >= not ==: a slow master can make the slave retry an
            # already-applied update, adding dedups beyond the
            # injected dup; FEWER dedups than dups means a duplicate
            # slipped past (exactly-once above would catch the double
            # apply — this names the broken counter)
            problems.append(
                "dedup counter inconsistent: %d deduplicated vs %d "
                "dup frame(s) injected" % (server.dedup_dropped,
                                           injected.get("dup", 0)))
        if injected.get("drop", 0) and not server.lost_requeued:
            problems.append(
                "a job frame was dropped but the lost-frame requeue "
                "path never fired")
        if injected.get("slave_kill", 0) and master.requeues < 2:
            problems.append(
                "expected requeues from both the dead slave (reaper) "
                "and the dropped frame (rejoin), saw %d"
                % master.requeues)
    summary = {
        "ok": not problems,
        "jobs_applied": len(master.applied),
        "requeues": master.requeues,
        "slaves_run": len(survivors),
        "dedup_dropped": server.dedup_dropped,
        "stale_rejected": server.stale_rejected,
        "lost_requeued": server.lost_requeued,
        "chaos": snap,
        "problems": problems,
    }
    if as_json:
        print(json.dumps(summary, indent=2))
    else:
        print("chaos smoke: %d/%d jobs applied exactly once, "
              "%d slave run(s), dedup=%d stale=%d requeued=%d, "
              "faults_injected=%d"
              % (len(master.applied), n_jobs, len(survivors),
                 server.dedup_dropped, server.stale_rejected,
                 server.lost_requeued, snap["faults_injected"]))
        for problem in problems:
            print("PROBLEM: %s" % problem)
    return 0 if not problems else 1


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.chaos",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--smoke", action="store_true",
                        help="run the fault-injection gate")
    parser.add_argument("--schedule", default=None, metavar="JSON",
                        help="replay this schedule file instead of "
                             "the built-in smoke schedule")
    parser.add_argument("--seed", type=int, default=SMOKE_SEED)
    parser.add_argument("--jobs", type=int, default=SMOKE_JOBS)
    parser.add_argument("--json", action="store_true",
                        help="machine-readable summary")
    args = parser.parse_args(argv)
    schedule = None
    if args.schedule:
        schedule = ChaosSchedule.load(args.schedule)
    if args.smoke or schedule is not None:
        # an in-code watchdog on top of the caller's `timeout` wrapper:
        # a hang IS the failure mode under test, never a silent stall
        import signal

        def _hang(signum, frame):
            print("PROBLEM: chaos smoke hung (watchdog)",
                  file=sys.stderr)
            import os
            os._exit(3)
        signal.signal(signal.SIGALRM, _hang)
        signal.alarm(100)
        try:
            return run_smoke(schedule, seed=args.seed,
                             n_jobs=args.jobs, as_json=args.json)
        finally:
            signal.alarm(0)
    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
