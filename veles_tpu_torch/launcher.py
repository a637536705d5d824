"""Launcher: mode selection and the workflow's lifecycle, the port's
counterpart of :mod:`veles_tpu.launcher`.

Three modes, picked from the ``-l`` / ``-m`` flags:

- **standalone** (the default): initialize the device and the workflow,
  run to completion in this process;
- **master** (``listen`` given): serves jobs to slaves through a
  :class:`~veles_tpu_torch.parallel.jobs.JobServer` and never runs the
  graph; with ``nodes`` it starts its own slaves first (the bootstrap:
  this process's command line with ``-m <master>`` in place of ``-l`` and
  ``-n``, ``-m veles_tpu_torch`` rebuilt, run through
  ``slave_launch_transform``, by default ``ssh``), hands out no job
  before they all joined (for ``JOIN_TIMEOUT_S`` at most) and reaps
  them at the end;
- **slave** (``master_address`` given): a
  :class:`~veles_tpu_torch.parallel.jobs.JobClient` runs jobs until the
  master has no more.

Every mode initializes the workflow on ``device`` (``-d``; the card when
None, raising without one; ``"cpu"`` when asked).  A master waits, after
its last update, for its slaves to say goodbye (so they ship their
profiles and exit on their own) before it stops serving; with
``session_profile`` it then writes the session bundle
(:meth:`~veles_tpu_torch.parallel.jobs.JobServer.save_session_profile`).
:func:`parse_nodes` reads node specifications (also for
:mod:`veles_tpu_torch.scripts.spmd_launch`), and
:func:`discover_nodes_from_yarn` asks a YARN ResourceManager for its
running nodes.
"""

import json
import os
import re
import shlex
import socket
import subprocess
import sys
import threading
import time

from veles_tpu_torch.cmdline import CommandLineArgumentsRegistry
from veles_tpu_torch.logger import Logger

#: seconds a master's bootstrapped slaves have to join before the jobs
#: go to those that did (a process imports torch and starts CUDA first)
JOIN_TIMEOUT_S = 120.0


def parse_nodes(specs):
    """``host[:ssh_port][xN]`` specs → [(host, ssh_port, count)].

    The count may be glued to the port (``host:22x3``) or follow the
    host as ``host *3`` / ``host x3``, but never glued to a bare host
    name, where it would be ambiguous (``linux01`` is a host, not
    ``linu`` × 1)."""
    out = []
    for spec in specs:
        s = str(spec).strip()
        count = 1
        m = re.search(r"(?:\*|\s+x)\s*(\d+)$", s)
        if m:
            count = int(m.group(1))
            s = s[:m.start()].rstrip()
        host, sep, port_part = s.partition(":")
        ssh_port = 22
        if sep:
            pm = re.match(r"^(\d+)(?:x(\d+))?$", port_part)
            if not pm:
                raise ValueError("bad node spec %r "
                                 "(want host[:port][xN])" % (spec,))
            ssh_port = int(pm.group(1))
            if pm.group(2):
                count = int(pm.group(2))
        if not re.match(r"^[\w.\-]+$", host):
            raise ValueError("bad node spec %r "
                             "(want host[:port][xN])" % (spec,))
        out.append((host, ssh_port, count))
    return out


def discover_nodes_from_yarn(rm_url):
    """The RUNNING nodes' host names from a YARN ResourceManager's REST
    endpoint (``GET <rm>/ws/v1/cluster/nodes``)."""
    import urllib.request
    url = rm_url.rstrip("/") + "/ws/v1/cluster/nodes"
    with urllib.request.urlopen(url, timeout=30) as resp:
        data = json.loads(resp.read())
    nodes = (data.get("nodes") or {}).get("node") or []
    return [n["nodeHostName"] for n in nodes
            if n.get("state", "RUNNING") == "RUNNING"]


def _split_endpoint(spec):
    """'host:port' | ':port' | 'port' → (host, int(port))."""
    host, sep, port = str(spec).rpartition(":")
    if not sep:
        host = ""
    return host or "127.0.0.1", int(port)


class Launcher(Logger, metaclass=CommandLineArgumentsRegistry):
    """Conducts one workflow run in one of the three modes."""

    def __init__(self, workflow=None, **kwargs):
        super(Launcher, self).__init__()
        self.listen = kwargs.get("listen", "")
        self.master_address = kwargs.get("master_address", "")
        if self.listen and self.master_address:
            raise ValueError("cannot be both master (listen) and slave "
                             "(master_address)")
        #: the workflow's device: None is the card (raising without
        #: one), "cpu" the CPU
        self.device_spec = kwargs.get("device")
        self.testing = kwargs.get("testing", False)
        #: the bootstrap: node specs the master starts slaves on, and
        #: the nodes a YARN ResourceManager reports
        self.nodes = list(kwargs.get("nodes") or [])
        if kwargs.get("yarn"):
            self.nodes.extend(discover_nodes_from_yarn(kwargs["yarn"]))
        #: the prefix a slave's command runs behind, ``%(host)s`` and
        #: ``%(port)d`` filled per node; the command rides as ONE
        #: argument (ssh's semantics), so ``sh -c`` runs it locally
        self.slave_launch_transform = kwargs.get(
            "slave_launch_transform",
            "ssh -o BatchMode=yes -p %(port)d %(host)s")
        #: an explicit slave command with a ``%(master)s`` placeholder
        #: (default: this process's command line as a slave)
        self.slave_command = kwargs.get("slave_command")
        #: the host name slaves dial (default: the bound address, or this
        #: host's fqdn when it binds every interface)
        self.advertise_host = kwargs.get("advertise_host")
        self.checkpoint_dir = kwargs.get("checkpoint_dir")
        self.checkpoint_every = kwargs.get("checkpoint_every")
        self.resume = kwargs.get("resume", False)
        #: master: where the session profile bundle is written at the end
        self.session_profile = kwargs.get("session_profile")
        self.stopped = False
        self.device = None
        self.workflow = None
        self._server = None
        self._client = None
        self._spawned_ = []
        self._start_time = None
        if workflow is not None:
            workflow.launcher = self

    @staticmethod
    def init_parser(parser):
        group = parser.add_argument_group("launcher")
        group.add_argument(
            "-l", "--listen", default="", metavar="HOST:PORT",
            help="run as MASTER, listening for slaves here")
        group.add_argument(
            "-m", "--master-address", default="", metavar="HOST:PORT",
            help="run as SLAVE of this master")
        group.add_argument(
            "-d", "--device", default=None,
            help="cpu, or a cuda device (default: the card; raises "
                 "without one)")
        group.add_argument(
            "-n", "--nodes", nargs="*", default=[],
            metavar="HOST[:PORT][xN]",
            help="start N slaves per host from the master")
        group.add_argument(
            "--yarn", default=None, metavar="RM_URL",
            help="discover slave nodes from a YARN ResourceManager")
        group.add_argument(
            "--slave-launch-transform",
            default="ssh -o BatchMode=yes -p %(port)d %(host)s",
            help="the prefix a bootstrapped slave's command runs behind")
        group.add_argument(
            "--checkpoint-dir", default=None, metavar="DIR",
            help="master mode: checkpoint the train state here (every "
                 "--checkpoint-every jobs and at epoch boundaries)")
        group.add_argument(
            "--checkpoint-every", type=int, default=None,
            metavar="K", help="checkpoint every K applied updates")
        group.add_argument(
            "--resume", action="store_true",
            help="master mode: restore the latest checkpoint from "
                 "--checkpoint-dir before serving jobs")
        group.add_argument(
            "--analyze", action="store_true",
            help="the static pre-flight (not ported yet: ROADMAP item "
                 "7(e))")
        group.add_argument(
            "-p", "--graphics", action="store_true",
            help="the plotting client (not ported yet: ROADMAP item "
                 "7(e))")
        group.add_argument(
            "--web-status", action="store_true",
            help="the web status server (not ported yet: ROADMAP item "
                 "7(e))")

    # -- mode flags (the workflow and its units read them) -------------------
    @property
    def is_master(self):
        return bool(self.listen)

    @property
    def is_slave(self):
        return bool(self.master_address)

    @property
    def is_standalone(self):
        return not (self.is_master or self.is_slave)

    @property
    def mode(self):
        return ("master" if self.is_master else
                "slave" if self.is_slave else "standalone")

    # -- workflow registration (the Workflow.launcher setter) -----------------
    def add_ref(self, workflow):
        self.workflow = workflow

    def del_ref(self, workflow):
        if self.workflow is workflow:
            self.workflow = None

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, **kwargs):
        """Arm the fault injection and the flight recorder from the
        config, pick the device, and initialize the workflow."""
        if self.workflow is None:
            raise RuntimeError("no workflow attached to this launcher")
        from veles_tpu_torch import chaos, obs
        from veles_tpu_torch.backends import make_device
        chaos.configure()
        obs.configure()
        self.device = kwargs.pop("device", None) \
            or make_device(self.device_spec)
        self.info("%s mode; device=%s", self.mode, self.device)
        self.workflow.initialize(device=self.device, **kwargs)
        return self

    def run(self):
        """Run to completion in the selected mode; returns the
        workflow."""
        self._start_time = time.time()
        try:
            if self.is_master:
                self._run_master()
            elif self.is_slave:
                self._run_slave()
            else:
                self.workflow.run()
        finally:
            self.stopped = True
            self._teardown()
        return self.workflow

    def _run_master(self):
        from veles_tpu_torch.parallel.jobs import JobServer
        host, port = _split_endpoint(self.listen)
        self._server = JobServer(self.workflow, port=port, host=host,
                                 checkpoint_dir=self.checkpoint_dir,
                                 checkpoint_every=self.checkpoint_every)
        if self.resume:
            self._server.resume_from_checkpoint()
        finished = threading.Event()
        self._server.on_finished = finished.set
        self._server.start()
        self.info("master serving jobs on %s", self._server.endpoint)
        try:
            if self.nodes:
                self._spawn_remote_slaves()
            while not finished.is_set() and not self.stopped:
                finished.wait(0.2)
                if finished.is_set() or self.stopped:
                    break
                if (self._spawned_
                        and all(p.poll() is not None
                                for p in self._spawned_)
                        and not self._server.slaves):
                    # every bootstrapped slave died and none is
                    # connected: nobody is coming
                    raise RuntimeError(
                        "all %d bootstrapped slaves exited (rc=%r) "
                        "with none connected; run cannot finish" % (
                            len(self._spawned_),
                            [p.returncode for p in self._spawned_]))
            self._await_goodbyes()
            if self.session_profile:
                self._server.save_session_profile(self.session_profile)
                self.info("session profile written to %s",
                          self.session_profile)
        finally:
            self._server.print_stats()
            self._server.stop()
            self._reap_spawned()

    def _await_goodbyes(self):
        """After the last update: keep answering ``no_more_jobs`` until
        every slave has said goodbye (shipping its profile first) or
        timed out."""
        deadline = time.time() + self._server.slave_timeout
        while self._server.slaves and time.time() < deadline \
                and not self.stopped:
            time.sleep(0.05)

    # -- the bootstrap --------------------------------------------------------
    def _master_endpoint(self):
        """The endpoint the slaves dial: the bound port on the advertised
        host."""
        bhost, bport = _split_endpoint(self._server.endpoint[len("tcp://"):]
                                       if self._server else self.listen)
        host = self.advertise_host
        if not host:
            host = bhost if bhost not in ("0.0.0.0", "::", "") \
                else socket.getfqdn()
        return "%s:%d" % (host, bport)

    def _build_slave_command(self):
        if self.slave_command:
            return self.slave_command % {"master": self._master_endpoint()}
        # this process's command line as a slave; `python -m
        # veles_tpu_torch` shows argv[0] as .../__main__.py, and running
        # that path would put the package directory on sys.path instead
        # of the checkout: rebuild the -m form
        argv0 = list(sys.argv[:1])
        if argv0 and os.path.basename(argv0[0]) == "__main__.py" and \
                os.path.basename(os.path.dirname(
                    os.path.abspath(argv0[0]))) == "veles_tpu_torch":
            argv0 = ["-m", "veles_tpu_torch"]
        argv = [sys.executable] + argv0 + list(sys.argv[1:])
        out, skip_one, skip_multi = [], False, False
        for arg in argv:
            if skip_one:
                skip_one = False
                continue
            if skip_multi:
                # --nodes takes values up to the next option
                if not arg.startswith("-"):
                    continue
                skip_multi = False
            if arg in ("-l", "--listen", "--yarn"):
                skip_one = True
                continue
            if arg in ("-n", "--nodes"):
                skip_multi = True
                continue
            if arg.startswith(("--listen=", "--nodes=", "--yarn=")):
                continue
            out.append(arg)
        out += ["-m", self._master_endpoint()]
        return shlex.join(out)

    def _spawn_remote_slaves(self):
        cmd = self._build_slave_command()
        nodes = parse_nodes(self.nodes)
        self._server.quorum = sum(count for _h, _p, count in nodes)
        self._server.quorum_deadline = time.time() + JOIN_TIMEOUT_S
        for nhost, nport, count in nodes:
            prefix = shlex.split(self.slave_launch_transform
                                 % {"host": nhost, "port": nport})
            for i in range(count):
                self.info("spawning slave %d/%d on %s: %s",
                          i + 1, count, nhost, cmd)
                # the command rides as ONE argument, as ssh passes it to
                # the remote shell
                self._spawned_.append(subprocess.Popen(prefix + [cmd]))

    def _reap_spawned(self, timeout=10.0):
        deadline = time.time() + timeout
        for proc in self._spawned_:
            try:
                proc.wait(max(0.1, deadline - time.time()))
                continue
            except subprocess.TimeoutExpired:
                self.warning("spawned slave pid %d did not exit; "
                             "terminating", proc.pid)
                proc.terminate()
            try:
                proc.wait(2.0)
            except subprocess.TimeoutExpired:
                self.warning("spawned slave pid %d ignored SIGTERM; "
                             "killing", proc.pid)
                proc.kill()
                proc.wait(2.0)
        self._spawned_ = []

    def _run_slave(self):
        from veles_tpu_torch.parallel.jobs import JobClient
        host, port = _split_endpoint(self.master_address)
        self._client = JobClient(self.workflow,
                                 "tcp://%s:%d" % (host, port))
        try:
            self._client.handshake()
            if not self._client.run():
                raise RuntimeError("the slave lost its master for good")
        finally:
            self._client.close()

    def stop(self):
        self.stopped = True
        if self.workflow is not None:
            self.workflow.stop()
        if self._server is not None:
            self._server.stop()

    def on_workflow_finished(self):
        self.stopped = True

    def _teardown(self):
        if self.workflow is not None and self._start_time is not None:
            self.info("workflow finished in %.1f s (%s mode)",
                      time.time() - self._start_time, self.mode)
            if self.workflow.get_unit_run_time_stats():
                self.workflow.print_stats()

    # -- the status payload ---------------------------------------------------
    def status(self):
        wf = self.workflow
        return {
            "mode": self.mode,
            "stopped": self.stopped,
            "device": str(self.device),
            "workflow": type(wf).__name__ if wf is not None else None,
            "slaves": ([{k: v for k, v in s.__dict__.items()
                         if not k.startswith("_")}
                        for s in self._server.slaves.values()]
                       if self._server is not None else []),
            "uptime": (time.time() - self._start_time
                       if self._start_time else 0.0),
            "pid": os.getpid(),
        }

    def status_json(self):
        return json.dumps(self.status(), default=str)
