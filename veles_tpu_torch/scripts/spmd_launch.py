"""Boot a multi-process SPMD fleet: run the SAME command on every node
with ``VELES_COORDINATOR`` / ``VELES_NUM_PROCS`` / ``VELES_PROC_ID`` set,
so :func:`veles_tpu_torch.parallel.multihost.initialize` joins the
processes into one ``torch.distributed`` group.  Counterpart of
:mod:`veles_tpu.scripts.spmd_launch`.

    python -m veles_tpu_torch.scripts.spmd_launch \\
        -n hostA hostB:2222x2 --coordinator hostA:47010 -- \\
        python train.py --my-args

``--launch-transform`` swaps ssh for anything that takes the command as
one argument: ``--launch-transform "sh -c"`` boots a local fleet.  The
coordinator is ``host:port`` (a TCP rendezvous on rank 0) or an
``init_method`` URL such as ``file:///shared/path``.  The first rank
that exits non-zero tears the fleet down.
"""

import argparse
import shlex
import signal
import subprocess
import sys
import time

from veles_tpu_torch.launcher import parse_nodes


def build_plan(nodes):
    """[(host, ssh_port, process_id)] in rank order; process 0 lands on
    the first node (where the coordinator usually runs)."""
    plan = []
    for host, port, count in parse_nodes(nodes):
        for _ in range(count):
            plan.append((host, port, len(plan)))
    if not plan:
        raise ValueError("no nodes given")
    return plan


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.scripts.spmd_launch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-n", "--nodes", nargs="+", required=True,
                        help="host[:ssh_port][xN] specs; xN = N "
                             "processes on that host")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of the rendezvous, or an "
                             "init_method URL (default: first node, "
                             "port 47010)")
    parser.add_argument("--launch-transform",
                        default="ssh -o BatchMode=yes -p %(port)d "
                                "%(host)s",
                        help="prefix template; the command rides as "
                             "ONE trailing argument")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="-- command to run on every node")
    args = parser.parse_args(argv)
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("no command given (put it after --)")

    plan = build_plan(args.nodes)
    coordinator = args.coordinator or "%s:47010" % plan[0][0]
    procs = []

    def reap(*_a):
        for p in procs:
            if p.poll() is None:
                p.terminate()

    signal.signal(signal.SIGTERM, reap)
    try:
        for host, port, pid in plan:
            prefix = shlex.split(args.launch_transform
                                 % {"host": host, "port": port})
            remote = "env %s %s" % (
                " ".join("%s=%s" % (k, shlex.quote(str(v))) for k, v in (
                    ("VELES_COORDINATOR", coordinator),
                    ("VELES_NUM_PROCS", len(plan)),
                    ("VELES_PROC_ID", pid))),
                shlex.join(command))
            print("spmd_launch: rank %d on %s: %s"
                  % (pid, host, remote), file=sys.stderr)
            procs.append(subprocess.Popen(prefix + [remote]))
        # one dead rank leaves the others blocked in their next
        # collective: tear the fleet down at the first non-zero exit
        while True:
            codes = [p.poll() for p in procs]
            bad = next((c for c in codes if c not in (None, 0)), None)
            if bad is not None:
                print("spmd_launch: rank %d exited rc=%d; reaping the "
                      "fleet" % (codes.index(bad), bad), file=sys.stderr)
                return bad
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.2)
    finally:
        reap()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


if __name__ == "__main__":
    sys.exit(main())
