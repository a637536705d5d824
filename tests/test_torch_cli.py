"""The port's entry point (``python -m veles_tpu_torch``: ``cmdline``,
the ``Launcher`` and ``__main__``) and the slave bootstrap, on the CPU.

The counterparts of ``tests/test_cli.py``'s and
``tests/test_launcher_bootstrap.py``'s tests, in the same words: the
parser and its contributor registry, the launcher's modes, ``Main``
over the MNIST sample (``launcher=`` leaves ``initialize`` to the
launcher), a workflow file, seeds, config overrides, a master and a
slave in one process, the version / dump flags, pickle diagnostics, the
peak memory line and the HTML reference; node specs, YARN discovery
against a local HTTP server, and a master that bootstraps two slaves
through ``sh -c``.  The flags of modules not ported yet raise naming
7(e).  Then the forms a user runs, as processes: ``-l`` and ``-m`` in
two processes, and ``-l`` with ``-n 'localhost x2' --slave-launch-
transform 'sh -c'``, each training the MNIST MLP at full width on the
synthetic stand-in to the Decision's end (``root.mnist.max_epochs=2``),
every process reaped.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy
import pytest
import torch

from veles_tpu_torch.cmdline import make_parser, register_arguments
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.launcher import (
    Launcher, _split_endpoint, discover_nodes_from_yarn, parse_nodes)
from veles_tpu_torch.units import Unit

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
#: each CLI process run here gets one torch thread and the checkout
CHILD_ENV = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def test_parser_core_flags():
    parser = make_parser()
    args, _ = parser.parse_known_args(
        ["veles_tpu_torch.samples.mnist", "-d", "cpu", "--test",
         "root.common.engine.stitch=off"])
    assert args.workflow == "veles_tpu_torch.samples.mnist"
    assert args.device == "cpu"
    assert args.test


def test_parser_contributor_registry():
    saw = []

    def contribute(parser):
        saw.append(True)
        parser.add_argument("--test-contrib-flag", default="x")

    register_arguments(contribute)
    parser = make_parser()
    args, _ = parser.parse_known_args(["w"])
    assert saw and args.test_contrib_flag == "x"


def test_split_endpoint():
    assert _split_endpoint("1.2.3.4:5000") == ("1.2.3.4", 5000)
    assert _split_endpoint(":5000") == ("127.0.0.1", 5000)
    assert _split_endpoint("5000") == ("127.0.0.1", 5000)


class _CountingUnit(Unit):
    def __init__(self, workflow, **kwargs):
        super(_CountingUnit, self).__init__(workflow, **kwargs)
        self.runs = 0

    def run(self):
        self.runs += 1


def _tiny_workflow():
    wf = DummyWorkflow()
    unit = _CountingUnit(wf)
    unit.link_from(wf.start_point)
    wf.end_point.link_from(unit)
    return wf, unit


def test_launcher_standalone_runs_workflow():
    wf, unit = _tiny_workflow()
    launcher = Launcher(wf, device="cpu")
    assert launcher.is_standalone and wf.launcher is launcher
    assert launcher.workflow is wf
    launcher.initialize()
    launcher.run()
    assert unit.runs == 1
    status = launcher.status()
    assert status["mode"] == "standalone" and status["stopped"]
    json.loads(launcher.status_json())


def test_launcher_master_slave_exclusive():
    with pytest.raises(ValueError):
        Launcher(listen=":5000", master_address="h:6000")


def test_launcher_modes():
    assert Launcher(listen=":0").is_master
    assert Launcher(master_address="h:1").is_slave


def _main(argv):
    from veles_tpu_torch.__main__ import Main
    main = Main(argv)
    main._parse()
    main._setup_logging()
    main._seed_random()
    main._apply_config()
    main.module = main._load_module(main.args.workflow)
    return main


def test_main_runs_sample_module(tmp_path):
    """The MNIST sample under ``Main``: given a launcher, create_workflow
    leaves ``initialize`` to it, which then picks the CPU."""
    main = _main(["veles_tpu_torch.samples.mnist", "-d", "cpu",
                  "--result-file", str(tmp_path / "result.json")])
    assert main.args.workflow == "veles_tpu_torch.samples.mnist"
    wf = main.module.create_workflow(
        launcher=Launcher(device="cpu"), max_epochs=1, minibatch_size=50)
    assert not wf._is_initialized
    wf.launcher.initialize()
    assert wf._is_initialized
    assert wf.loader.device.torch_device.type == "cpu"


@pytest.mark.parametrize("sample", [
    "mnist", "mnist_conv", "mnist_rnn", "mnist_ae", "kohonen", "cifar10",
    "stl10", "vgg"])
def test_every_sample_leaves_initialize_to_a_launcher(sample):
    """Every sample the entry point constructs: built, not initialized,
    with the Launcher attached."""
    main = _main(["veles_tpu_torch.samples." + sample, "-d", "cpu"])
    main._construct()
    assert main.workflow.launcher is main.launcher
    assert not main.workflow._is_initialized


def test_main_fused_flag():
    """--fused reaches create_workflow and builds the FusedTrainer graph
    (no eager GD chain)."""
    main = _main(["veles_tpu_torch.samples.mnist", "-d", "cpu", "--fused"])
    assert main.args.fused
    wf = main.module.create_workflow(
        launcher=Launcher(device="cpu"), max_epochs=1, minibatch_size=50,
        fused=True)
    assert wf.fused and wf.fused_trainer is not None
    assert wf.gds == []


def test_main_dry_run_init():
    from veles_tpu_torch.__main__ import Main
    main = Main(["veles_tpu_torch.samples.mnist", "-d", "cpu", "--no-logo",
                 "--dry-run", "init"])
    assert main.run() == 0
    assert main.workflow._is_initialized
    assert main.workflow.loader.samples_served == 0


def test_main_loads_workflow_from_file(tmp_path):
    """A workflow .py file of the create_workflow convention."""
    from veles_tpu_torch.__main__ import Main
    wf_file = tmp_path / "torch_wf_probe.py"
    wf_file.write_text(textwrap.dedent("""
        from veles_tpu_torch.dummy import DummyWorkflow
        from veles_tpu_torch.units import Unit

        class Probe(Unit):
            ran = False
            def run(self):
                Probe.ran = True

        def create_workflow(launcher=None, **kwargs):
            wf = DummyWorkflow()
            if launcher is not None:
                wf.launcher = launcher
            probe = Probe(wf)
            probe.link_from(wf.start_point)
            wf.end_point.link_from(probe)
            return wf
    """))
    try:
        assert Main([str(wf_file), "-d", "cpu", "--no-logo"]).run() == 0
        assert sys.modules["torch_wf_probe"].Probe.ran
    finally:
        sys.modules.pop("torch_wf_probe", None)


def test_main_seed_from_file(tmp_path):
    from veles_tpu_torch import prng
    from veles_tpu_torch.__main__ import Main
    seed_file = tmp_path / "seed.bin"
    seed_file.write_bytes(bytes(range(64)))
    main = Main(["w", "-r", "%s:uint32:16" % seed_file])
    main._parse()
    main._seed_random()
    a = prng.get("master").randint(0, 1 << 30)
    main._seed_random()
    assert prng.get("master").randint(0, 1 << 30) == a


def test_main_config_overrides(tmp_path):
    from veles_tpu_torch.__main__ import Main
    cfg = tmp_path / "cfg.py"
    cfg.write_text("root.common.test_marker = 41\n")
    main = Main(["w", str(cfg), "root.common.test_marker2=42"])
    main._parse()
    main._apply_config()
    assert root.common.test_marker == 41
    assert root.common.test_marker2 == 42


def test_master_slave_end_to_end():
    """A master and a slave in one process over the job wire."""
    from veles_tpu_torch.parallel.jobs import JobClient, JobServer
    from veles_tpu_torch.workflow import NoMoreJobs

    class JobWorkflow(object):
        def __init__(self):
            self.jobs = list(range(5))
            self.updates = []

        @staticmethod
        def checksum():
            return "tiny"

        def generate_data_for_slave(self, slave=None):
            if not self.jobs:
                raise NoMoreJobs()
            return self.jobs.pop()

        def apply_data_from_slave(self, data, slave=None):
            self.updates.append(data)

        def drop_slave(self, slave=None):
            pass

    class SlaveWorkflow(object):
        @staticmethod
        def checksum():
            return "tiny"

        def do_job(self, data, callback):
            callback(data * 10)

    master_wf = JobWorkflow()
    server = JobServer(master_wf).start()
    try:
        client = JobClient(SlaveWorkflow(), server.endpoint)
        client.handshake()
        client.run()
        client.close()
        deadline = time.time() + 5
        while not server.finished and time.time() < deadline:
            time.sleep(0.05)
        assert server.finished
        assert sorted(master_wf.updates) == [0, 10, 20, 30, 40]
    finally:
        server.stop()


def test_version_logo_dump_flags(capsys):
    """--version prints and exits; --no-logo drops the banner;
    --dump-config prints the root tree; --dry-run load stops before
    construction; --dump-unit-attributes pretty elides arrays."""
    from veles_tpu_torch.__main__ import Main

    assert Main(["--version"]).run() == 0
    out = capsys.readouterr().out
    assert "veles_tpu_torch" in out and "torch" in out

    rc = Main(["veles_tpu_torch.samples.mnist", "--no-logo", "--dry-run",
               "load", "--dump-config", "-d", "cpu"]).run()
    assert rc == 0
    captured = capsys.readouterr()
    assert "common" in captured.out
    assert "veles_tpu_torch 0" not in captured.err

    rc = Main(["veles_tpu_torch.samples.mnist", "--no-logo", "--dry-run",
               "init", "--dump-unit-attributes", "pretty",
               "-d", "cpu"]).run()
    assert rc == 0
    out = capsys.readouterr().out
    assert "MnistLoader" in out


@pytest.mark.parametrize("flags", [
    ["--optimize", "4:2"], ["--ensemble-train", "3:0.8"],
    ["--ensemble-test", "in.json"], ["--visualize"], ["-p"],
    ["--graphics"], ["--web-status"], ["--analyze"],
    ["--workflow-graph", "g.dot"], ["--manhole"], ["--frontend", "f.html"],
    ["--log-db", "log.db"], ["--debug-nans"]],
    ids=lambda flags: flags[0])
def test_visualize_initializes_without_running(flags):
    """--visualize (and every flag whose module is not ported yet) is
    refused naming 7(e), before anything is built."""
    from veles_tpu_torch.__main__ import Main
    main = Main(["veles_tpu_torch.samples.mnist", "--no-logo", "-d",
                 "cpu"] + flags)
    with pytest.raises(NotImplementedError, match=r"item 7\(e\)"):
        main.run()
    assert main.workflow is None


def test_debug_pickle_names_unit_attribute():
    """The pickle diagnosis walks a workflow down to the unit attribute
    that cannot pickle."""
    from veles_tpu_torch.snapshotter import diagnose_pickle
    wf, unit = _tiny_workflow()
    unit.evil_callback = lambda: None
    lines = diagnose_pickle(wf, path="workflow")
    assert any("evil_callback" in line for line in lines), lines


def test_peak_memory_printer(capsys):
    from veles_tpu_torch.__main__ import Main
    Main.print_peak_memory()
    err = capsys.readouterr().err
    assert "Peak resident memory" in err and "MiB" in err


def test_html_help_writes_reference(capsys):
    from veles_tpu_torch.__main__ import Main
    assert Main(["--html-help"]).run() == 0
    out = capsys.readouterr().out
    path = out.strip().rsplit(" ", 1)[-1]
    try:
        html = open(path).read()
        assert "--listen" in html and "--optimize" in html and "<" in html
    finally:
        os.unlink(path)


# -- the bootstrap (tests/test_launcher_bootstrap.py) ------------------------

#: one module defines the workflow for both sides, so the checksums agree
BOOT_MODULE = textwrap.dedent("""
    import numpy
    import sys

    import torch

    from veles_tpu_torch import prng
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

    torch.set_num_threads(1)


    class BootLoader(FullBatchLoader):
        def load_data(self):
            rng = numpy.random.default_rng(5)
            n = 120
            labels = (numpy.arange(n) % 4).astype(int)
            centers = rng.standard_normal((4, 8)) * 3
            self.original_data.mem = (
                centers[labels] + rng.standard_normal((n, 8)) * 0.5
            ).astype(numpy.float32)
            self.original_labels = [int(v) for v in labels]
            self.class_lengths[:] = [0, 40, 80]


    LAYERS = [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 6},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
        {"type": "softmax", "->": {"output_sample_shape": 4},
         "<-": {"learning_rate": 0.05}},
    ]


    def make(launcher):
        prng.seed_all(21)
        wf = StandardWorkflow(
            None,
            loader_factory=lambda w: BootLoader(w, minibatch_size=20),
            layers=[{**s} for s in LAYERS],
            decision_config={"max_epochs": 2})
        wf.launcher = launcher
        return wf


    if __name__ == "__main__":
        # import again under the module name the master knows, so the
        # unit classes hash alike on both sides
        import importlib.util
        import os
        spec = importlib.util.spec_from_file_location(
            "torch_boot_wf", os.path.abspath(__file__))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["torch_boot_wf"] = mod
        spec.loader.exec_module(mod)
        from veles_tpu_torch.launcher import Launcher
        launcher = Launcher(master_address=sys.argv[1], device="cpu")
        wf = mod.make(launcher)
        launcher.initialize()
        launcher.run()
""")


def test_parse_nodes():
    assert parse_nodes(["hostA", "b:2222", "c x3", "d:22x2",
                        "e.example.com", "linux01", "f*4"]) == [
        ("hostA", 22, 1), ("b", 2222, 1), ("c", 22, 3), ("d", 22, 2),
        ("e.example.com", 22, 1), ("linux01", 22, 1), ("f", 22, 4)]
    with pytest.raises(ValueError):
        parse_nodes(["bad spec::"])
    with pytest.raises(ValueError):
        parse_nodes(["host:abc"])


def test_yarn_discovery():
    import http.server

    payload = {"nodes": {"node": [
        {"nodeHostName": "w1", "state": "RUNNING"},
        {"nodeHostName": "w2", "state": "LOST"},
        {"nodeHostName": "w3", "state": "RUNNING"},
    ]}}
    paths = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            paths.append(self.path)
            body = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        nodes = discover_nodes_from_yarn(
            "http://127.0.0.1:%d" % httpd.server_port)
        assert nodes == ["w1", "w3"]
        assert paths == ["/ws/v1/cluster/nodes"]
        launcher = Launcher(listen=":0", nodes=["a"],
                            yarn="http://127.0.0.1:%d/"
                            % httpd.server_port)
        assert launcher.nodes == ["a", "w1", "w3"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(5)


def test_master_bootstraps_slaves_locally(tmp_path):
    """The master spawns 2 slaves through the launch transform and hands
    out no job before both joined; they do the jobs, the master's
    weights move, and the spawned processes are reaped."""
    import importlib.util
    script = tmp_path / "torch_boot_wf.py"
    script.write_text(BOOT_MODULE)
    spec = importlib.util.spec_from_file_location("torch_boot_wf",
                                                  str(script))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["torch_boot_wf"] = mod
    try:
        spec.loader.exec_module(mod)
        launcher = Launcher(
            listen="127.0.0.1:0", device="cpu", nodes=["localhost x2"],
            slave_launch_transform="sh -c",
            slave_command="env PYTHONPATH=%s OMP_NUM_THREADS=1 %s %s "
                          "%%(master)s" % (REPO, sys.executable, script))
        wf = mod.make(launcher)
        launcher.initialize()
        w_before = numpy.array(wf.forwards[0].weights.mem)
        workers = []
        apply = wf.apply_data_from_slave

        def recording_apply(data, slave=None):
            workers.append(slave.id)
            return apply(data, slave)
        wf.apply_data_from_slave = recording_apply
        launcher.run()
        assert launcher._server.endpoint
        assert not launcher._spawned_          # reaped
        assert workers, "no spawned slave completed a job"
        done = {sid: s.jobs_done
                for sid, s in launcher._server.slaves.items()}
        assert not done, "every slave said goodbye: %s" % done
        assert bool(wf.decision.complete)
        assert not numpy.allclose(w_before,
                                  numpy.array(wf.forwards[0].weights.mem))
    finally:
        sys.modules.pop("torch_boot_wf", None)


# -- the forms a user runs, as processes ---------------------------------------

MNIST = ["-m", "veles_tpu_torch", "veles_tpu_torch.samples.mnist", "-d",
         "cpu", "--no-logo", "root.mnist.max_epochs=2"]


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_cli_master_and_slave_processes_train_mnist(tmp_path):
    """``-l 127.0.0.1:0`` and ``-m`` as two processes: the slave trains
    the master's MNIST MLP to the Decision's end."""
    result = tmp_path / "result.json"
    master = subprocess.Popen(
        [sys.executable] + MNIST + ["-l", "127.0.0.1:0", "--result-file",
                                    str(result)],
        cwd=REPO, env=CHILD_ENV, stderr=subprocess.PIPE, text=True)
    slave = None
    try:
        endpoint = None
        deadline = time.time() + 60
        while endpoint is None and time.time() < deadline:
            line = master.stderr.readline()
            if not line:
                break
            if "job server on tcp://" in line:
                endpoint = line.rsplit("tcp://", 1)[1].strip()
        assert endpoint, "the master never served"
        drain = threading.Thread(target=master.stderr.read, daemon=True)
        drain.start()
        slave = subprocess.Popen(
            [sys.executable] + MNIST + ["-m", endpoint], cwd=REPO,
            env=CHILD_ENV, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        assert master.wait(120) == 0
        assert slave.wait(60) == 0
    finally:
        for proc in (master, slave):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(10)
    results = json.loads(result.read_text())
    assert results["Total epochs"] == 1       # the last of 2 epochs
    assert results["best_validation_error_pt"] < 100.0


def test_cli_bootstrap_trains_mnist(tmp_path):
    """``-l`` with ``-n 'localhost x2' --slave-launch-transform 'sh -c'``:
    both spawned slaves do jobs (the session bundle shows them by role),
    the result file holds the Decision's final metrics, and every
    spawned process is gone when the master exits."""
    result = tmp_path / "result.json"
    profile = tmp_path / "profile"
    proc = subprocess.run(
        [sys.executable] + MNIST + [
            "-l", "127.0.0.1:0", "-n", "localhost x2",
            "--slave-launch-transform", "sh -c", "--result-file",
            str(result), "--profile", str(profile), "-v", "warning"],
        cwd=REPO, env=CHILD_ENV, capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = json.loads(result.read_text())
    assert set(results) >= {"best_validation_error_pt", "best_epoch",
                            "errors_pt"}
    assert results["Total epochs"] == 1
    bundle = json.loads((profile / "session_profile.json").read_text())
    assert len(bundle["slaves"]) == 2
    for sid, shipped in bundle["slaves"].items():
        roles = {ev.get("role") for ev in shipped["events"]}
        assert "slave-%s" % sid in roles
        assert any(ev.get("cat") == "jobs" and ev.get("name") == "do_job"
                   for ev in shipped["events"]), sid
    slave_pids = [int(p.stem.rsplit("_", 1)[1])
                  for p in profile.glob("trace_slave_*.json")]
    assert len(slave_pids) == 2
    assert not any(_alive(pid) for pid in slave_pids)


def test_main_run_convention_and_snapshot_resume(tmp_path):
    """The ``run(load, main)`` convention builds the class with the
    Launcher as its parent and the Launcher's mode; ``-w`` resumes a
    snapshot through ``load_snapshot``; ``--debug-pickle`` arms the
    snapshotter's diagnosis."""
    from veles_tpu_torch import snapshotter
    from veles_tpu_torch.__main__ import Main
    wf_file = tmp_path / "torch_run_probe.py"
    wf_file.write_text(textwrap.dedent("""
        from veles_tpu_torch.units import Unit
        from veles_tpu_torch.workflow import Workflow

        class Probe(Unit):
            runs = 0
            def run(self):
                Probe.runs += 1

        class ProbeWorkflow(Workflow):
            def __init__(self, workflow, **kwargs):
                super(ProbeWorkflow, self).__init__(workflow, **kwargs)
                probe = Probe(self)
                probe.link_from(self.start_point)
                self.end_point.link_from(probe)

        def run(load, main):
            wf, _ = load(ProbeWorkflow)
            assert wf.launcher.workflow is wf and wf.is_standalone
            main()
    """))
    try:
        assert Main([str(wf_file), "-d", "cpu", "--no-logo"]).run() == 0
        assert sys.modules["torch_run_probe"].Probe.runs == 1
    finally:
        sys.modules.pop("torch_run_probe", None)

    from veles_tpu_torch.samples import mnist
    wf = mnist.create_workflow(device="cpu", max_epochs=1,
                               minibatch_size=500,
                               snapshot_dir=str(tmp_path / "snap"))
    wf.run()
    wf.stop()
    path = wf.snapshotter.destination
    main = Main(["-w", path, "-d", "cpu", "--no-logo", "--dry-run", "init",
                 "--debug-pickle"])
    try:
        assert main.run() == 0
        assert snapshotter.DEBUG_PICKLE
    finally:
        snapshotter.DEBUG_PICKLE = False
    assert main.workflow is not wf and main.workflow._is_initialized
    assert main.workflow.launcher is main.launcher
    numpy.testing.assert_array_equal(
        main.workflow.forwards[0].weights.mem,
        wf.forwards[0].weights.mem)
