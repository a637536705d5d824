"""The rules the port (``veles_tpu_torch``) keeps, checked on the CPU.

- It imports neither ``jax`` nor any module of ``veles_tpu``: it keeps
  its own copies.  Note that ``veles_tpu_torch`` itself starts with the
  letters ``veles_tpu``, so the checks look for the exact name or the
  ``veles_tpu.`` prefix.
- Its entry points run on the CUDA card unless the caller passes
  ``device="cpu"``, and raise without a card instead of carrying on.
- The CPU path launches no kernel and never loads the kernel builder.
- A ``root.common.engine`` knob that the JAX package reads in a ported
  module is either ported or refused with ``NotImplementedError``
  naming its ROADMAP item: ``kernels="xla"`` and ``pallas_gemm`` /
  ``pallas_gather`` set false (item 7), ``health`` other than ``off``
  (item 6), ``backend="numpy"`` (the decision of item 1);
  ``metrics_every`` is ported (the Decision's closes equal the JAX
  package's at any cadence) and so are ``trace_capacity``
  (``tests/test_torch_trace.py``) and ``backend`` = ``auto`` / ``tpu``
  (the card) or ``cpu``.  So are the other knobs the JAX package reads
  there: ``root.common.ensemble.train_ratio`` (7(c)) serves the JAX
  loader's sequence, ``root.common.watch.endpoint`` (item 6(c)) starts
  the bus, and ``root.common.obs.blackbox_dir`` is ported
  (``tests/test_torch_obs.py``).
- ``chip_smoke.py`` fails, and prints no result, without a card or
  without the package beside it.
- Each part of the serving path it leaves out raises
  ``NotImplementedError`` naming its ROADMAP item: a mesh (7(d)), the
  workflow analyzer preflight and the strict recompile sentinel (7(e)),
  the fleet (7(d)) and ``notify_status`` (7(e)).  Serving a snapshot
  (item 7(a)) is ported: ``InferenceEngine.from_snapshot`` and
  ``ModelRegistry.load_snapshot`` serve what ``from_workflow`` serves.
  Generative serving through the registry and the server is ported
  (``tests/test_torch_gen_serve.py``).
- ``snapshotter_config`` and ``snapshot_dir`` (item 7(a)) are ported,
  and so are the options of item 7(b) (``fused``, ``fused_config``,
  ``mcdnnic_topology`` / ``mcdnnic_parameters``, ``lr_adjuster_config``,
  ``rollback_config``, ``image_saver_config``) and the
  ``engine.precision_type`` knob; ``plotters_config`` is refused naming
  7(e) whenever it is given, and ``fused_config``'s ``fsdp`` and ``tp``
  naming 7(d) (``mesh_axes``, 7(d)'s first part, trains data-parallel).
- The layer zoo (7(c), its conv half): its modules and samples import
  no JAX, its entry points raise without a card, its CPU path never
  loads the kernel builder, ``engine.s2d_conv`` forces the space-to-depth
  choice of an eligible conv (True / False) or leaves it to the
  heuristic (``"auto"``) and ``mesh=`` trains data-parallel (7(d)).
- The SPMD library (7(d), part 1): ``veles_tpu_torch.parallel``, the
  MoE sample and ``spmd_launch`` import no JAX, in this process and in a
  spawned gloo rank.
- The rest of 7(c) (the recurrent layers, the RBM, the Kohonen map, the
  data side and the loader modules): its modules import no JAX and none
  of PIL, h5py, pyzmq and lmdb, its entry points raise without a card,
  and no refusal in the port names 7(c) any more.
- The job layer and the entry point (7(e), first part): importing
  ``parallel.jobs``, ``__main__``, ``chaos.__main__`` and ``launcher``
  loads no JAX, no ``veles_tpu`` and no pyzmq (the wire is the standard
  library's TCP, :mod:`veles_tpu_torch.parallel.wire`, named among the
  port-only modules with ``ops/build.py``, ``ops/cost.py`` and
  ``parallel/comm.py``); each flag of a module not ported yet raises
  naming 7(e); the entry point raises without a card; background units
  (``wants_thread``) run on the thread pool.
"""

import ast
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy
import pytest
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "veles_tpu_torch"


def _forbidden(name):
    return (name == "jax" or name.startswith("jax.")
            or name == "veles_tpu" or name.startswith("veles_tpu."))


def _run(code, cwd=REPO, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


# -- no jax, no veles_tpu -----------------------------------------------------

def test_importing_the_port_loads_no_jax_and_no_veles_tpu():
    proc = _run(
        "import json, sys\n"
        "import veles_tpu_torch, veles_tpu_torch.gen\n"
        "import veles_tpu_torch.ops.attention\n"
        "import veles_tpu_torch.gen.__main__\n"
        "import veles_tpu_torch.samples.mnist\n"
        "import veles_tpu_torch.dtypes\n"
        "from veles_tpu_torch.znicz import (fused, fused_graph, fused_unit,"
        " gd_base, image_saver, lr_adjust, mcdnnic, rollback)\n"
        "import veles_tpu_torch.parallel, veles_tpu_torch.samples.moe\n"
        "import veles_tpu_torch.scripts.spmd_launch\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "veles_tpu_torch.gen.engine" in loaded
    for module in ("comm", "mesh", "multihost", "tp", "dp", "ring", "pp",
                   "moe"):
        assert "veles_tpu_torch.parallel." + module in loaded
    assert "veles_tpu_torch.launcher" in loaded
    assert "veles_tpu_torch.ops.gemm" in loaded
    for module in ("dtypes", "znicz.fused_unit", "znicz.fused_graph",
                   "znicz.fused", "znicz.gd_base", "znicz.lr_adjust",
                   "znicz.rollback", "znicz.mcdnnic", "znicz.image_saver"):
        assert "veles_tpu_torch." + module in loaded
    for module in ("quant.core", "ops.qgemm", "ops.reduce", "ops.random"):
        assert "veles_tpu_torch." + module in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_importing_the_pod_loads_no_jax_and_no_veles_tpu():
    """The pod package (7(d), part 2: the runtime, the in-process
    membership, ``MultiHostPod``, the smoke's task) and the modules it
    rewrites import no JAX and no ``veles_tpu``."""
    proc = _run(
        "import json, sys\n"
        "import veles_tpu_torch.pod, veles_tpu_torch.pod.__main__\n"
        "from veles_tpu_torch.pod import membership, pods, runtime\n"
        "import veles_tpu_torch.checkpoint, veles_tpu_torch.epoch_scan\n"
        "import veles_tpu_torch.analyze.pricing\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    for module in ("pod", "pod.runtime", "pod.membership", "pod.pods",
                   "pod.__main__", "parallel.comm", "parallel.mesh",
                   "stitch", "analyze.pricing"):
        assert "veles_tpu_torch." + module in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("call", [
    lambda pod: pod.PodMaster(None),
    lambda pod: pod.PodWorker(None, "tcp://127.0.0.1:1"),
    lambda pod: pod.MultiHostPodWorker(None, "tcp://127.0.0.1:1")],
    ids=["PodMaster", "PodWorker", "MultiHostPodWorker"])
def test_the_pod_lease_half_names_7e(call):
    """What is left of ``pod/`` rides the job protocol, item 7(e)."""
    import veles_tpu_torch.pod as pod
    with pytest.raises(NotImplementedError, match=r"item 7\(e\)"):
        call(pod)


def test_the_pod_refusals_name_their_items():
    """The runtime's refusals: the planner (``param_rules="auto"``) and
    the V-P02 preflight (``warn`` / ``fail``) are the analyzer's, item
    7(e); every ``NotImplementedError`` the pod package raises names an
    item of ROADMAP 7."""
    import re
    for path in (PACKAGE / "pod").glob("*.py"):
        text = path.read_text()
        for match in re.finditer(r"raise NotImplementedError\(", text):
            window = text[match.end():match.end() + 400]
            assert re.search(r"7\(e\)|ROADMAP item %s", window), \
                "%s: a refusal without its item" % path.name


def test_a_spawned_rank_loads_no_jax_and_no_veles_tpu(tmp_path):
    """A rank of a gloo world (``tests/torch_ranks.py``, joined through
    ``parallel.multihost.initialize``) imports the SPMD library, the MoE
    sample and ``spmd_launch`` without JAX or ``veles_tpu``."""
    import torch_ranks
    results = torch_ranks.run_world(1, ("imports",), {}, tmp_path)
    assert results == [{"imports": []}]


def test_importing_the_serving_path_loads_no_jax_and_no_veles_tpu():
    proc = _run(
        "import json, sys\n"
        "import veles_tpu_torch.serve, veles_tpu_torch.obs\n"
        "import veles_tpu_torch.prof, veles_tpu_torch.restful_api\n"
        "import veles_tpu_torch.analyze, veles_tpu_torch.trace.__main__\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    for module in ("serve.engine", "serve.batcher", "serve.registry",
                   "serve.server", "serve.wire", "serve.metrics",
                   "obs.context", "obs.slo", "obs.blackbox", "obs.scrape",
                   "analyze.findings", "analyze.pricing", "analyze.shapes",
                   "trace.export", "trace.__main__", "prof.ledger",
                   "prof.sentinel", "restful_api", "metrics"):
        assert "veles_tpu_torch." + module in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    assert "veles_tpu_torch.ops.build" not in loaded


def test_importing_the_tooling_loads_no_jax_and_no_veles_tpu():
    proc = _run(
        "import json, sys\n"
        "import veles_tpu_torch.prof.__main__, veles_tpu_torch.prof.merge\n"
        "import veles_tpu_torch.watch.__main__, veles_tpu_torch.ops.cost\n"
        "import veles_tpu_torch.trace\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    for module in ("prof.ledger", "prof.merge", "prof.__main__", "watch",
                   "watch.bus", "watch.health", "watch.__main__",
                   "ops.cost", "trace.core"):
        assert "veles_tpu_torch." + module in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    # pyzmq loads only when a bus or a reader is made
    assert "zmq" not in loaded


def test_watch_and_health_work_without_pyzmq():
    """Without pyzmq (the card's machine lists none) the watch package
    imports, a health=on run on the CPU works, and starting a bus
    raises an ImportError that names what needs pyzmq."""
    proc = _run(
        "import sys\n"
        "sys.modules['zmq'] = None\n"
        "import veles_tpu_torch.watch as watch\n"
        "from veles_tpu_torch.config import root\n"
        "from veles_tpu_torch.samples import mnist\n"
        "root.common.engine.health = 'on'\n"
        "wf = mnist.create_workflow(device='cpu', max_epochs=2)\n"
        "wf.run()\n"
        "snap = watch.last_health()\n"
        "assert snap['groups']['GDTanh']['nonfinite'] == 0, snap\n"
        "assert snap['step'] == 60, snap\n"
        "try:\n"
        "    watch.start()\n"
        "except ImportError as exc:\n"
        "    print('IMPORTERROR', exc)\n"
        "else:\n"
        "    print('STARTED')\n")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.strip().splitlines()[-1]
    assert out.startswith("IMPORTERROR") and "pyzmq" in out, out


def test_no_source_of_the_port_imports_jax_or_veles_tpu():
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 15
    for path in sources:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, "%s imports %s" % (path.relative_to(REPO), bad)


def test_cpu_session_never_loads_the_kernel_builder():
    proc = _run(
        "import sys\n"
        "from veles_tpu_torch.gen import __main__ as m\n"
        "from veles_tpu_torch.ops import attention\n"
        "assert m.main(['--smoke', '--device', 'cpu', '--requests', '6'])"
        " == 0\n"
        "assert not any(attention.launches.values())\n"
        "assert 'veles_tpu_torch.ops.build' not in sys.modules\n"
        "assert 'triton' not in sys.modules\n")
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_cpu_mnist_never_loads_the_kernel_builder():
    proc = _run(
        "import sys\n"
        "from veles_tpu_torch.ops import gemm\n"
        "from veles_tpu_torch.samples import mnist\n"
        "assert mnist.main(['--device', 'cpu', '--max-epochs', '2']) == 0\n"
        "assert not any(gemm.launches.values())\n"
        "assert 'veles_tpu_torch.ops.build' not in sys.modules\n")
    assert proc.returncode == 0, proc.stderr + proc.stdout


# -- cuda by default, raising without a card --------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_cuda):
    from veles_tpu_torch.backends import resolve_device
    from veles_tpu_torch.gen import GenerativeEngine, TransformerGenModel
    from veles_tpu_torch.samples.transformer import TINY
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerGenModel(TINY)
    model = TransformerGenModel(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerativeEngine(model, max_slots=1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_mnist_workflow_raises_without_a_card(no_cuda):
    from veles_tpu_torch.samples import mnist
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mnist.create_workflow()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mnist.main(["--max-epochs", "1"])


def test_gen_cli_raises_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.cuda.is_available = lambda: False\n"
         "from veles_tpu_torch.gen.__main__ import main\n"
         "main(['--smoke'])"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr


def test_wrappers_on_cpu_tensors_launch_nothing(no_cuda):
    from veles_tpu_torch.ops import attention
    attention.reset_launches()
    x = torch.randn(2, 5, 2, 8, generator=torch.Generator().manual_seed(0))
    attention.flash_attention(x, x, x, causal=True)
    attention.decode_attention(x[:, :1], x, x,
                               torch.tensor([2, 5], dtype=torch.int32))
    assert not any(attention.launches.values())


def test_gemm_wrappers_on_cpu_tensors_launch_nothing(no_cuda):
    from veles_tpu_torch.ops import gemm
    gemm.reset_launches()
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(6, 5, generator=gen), torch.randn(5, 4, generator=gen)
    gemm.matmul(x, w, torch.zeros(4), "tanh")
    y = torch.randn(6, 4, generator=gen)
    gemm.gd_fused(x, y, y, w.clone(), torch.zeros(4), torch.zeros(5, 4),
                  torch.zeros(4), 0.1, 0.1, 0.0, 0.0, 0.9, 0.9, "tanh")
    assert not any(gemm.launches.values())


def test_gather_wrappers_on_cpu_tensors_launch_nothing(no_cuda):
    from veles_tpu_torch.ops import gather
    gather.reset_launches()
    data = torch.arange(60, dtype=torch.uint8).reshape(6, 10)
    idx = torch.tensor([4, -1, 0], dtype=torch.int32)
    assert gather.take_rows(data, idx)[1].tolist() == [0] * 10
    assert gather.take_rows_norm(data, idx, (0.5, 1.0))[0, 0] == 21.0
    assert not any(gather.launches.values())


def test_qmatmul_reduce_and_uniform_on_cpu_tensors_launch_nothing(no_cuda):
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import qgemm, random, reduce
    for module in (qgemm, random, reduce):
        module.reset_launches()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, generator=gen)
    q = torch.ones(5, 4, dtype=torch.int8)
    assert qgemm.qmatmul(x, q, torch.ones(4), torch.zeros(4),
                         "gelu").shape == (6, 4)
    saved = root.common.engine.get("pallas_reduce")
    root.common.engine.pallas_reduce = True
    try:
        assert reduce.matrix_reduce(x, axis=1, op="min").shape == (6,)
    finally:
        root.common.engine.pallas_reduce = saved
    assert reduce.matrix_reduce(x, use_pallas=True).shape == (5,)
    assert random.uniform_pallas(1, (3, 4), device="cpu").shape == (3, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random.uniform_pallas(1, (3, 4))
    assert not any(qgemm.launches.values())
    assert not any(reduce.launches.values())
    assert not any(random.launches.values())


# -- the engine knobs the JAX package reads -----------------------------------

KNOBS = ("kernels", "health", "metrics_every", "trace_capacity", "stitch",
         "precision_type")


@pytest.fixture
def knobs():
    """The port's engine knobs, restored after the test."""
    from veles_tpu_torch.config import root
    eng = root.common.engine
    saved = {key: eng.get(key) for key in KNOBS}
    yield eng
    for key, value in saved.items():
        setattr(eng, key, value)


def _tiny_step(steps=1):
    """A TINY train step on the CPU (batch 2): the losses."""
    from veles_tpu_torch.samples import transformer
    params, velocity, step = transformer.build_train(
        transformer.TINY, device="cpu", compute_dtype=torch.float32)
    tokens = transformer.synthetic_tokens(transformer.TINY, 2)
    return [float(step(params, velocity, tokens)[2]["loss"])
            for _ in range(steps)]


@pytest.mark.parametrize("stitch", ["on", "off"])
def test_kernels_xla_is_refused_naming_item_7(knobs, stitch):
    """``xla`` took the JAX package's dense references (attention,
    GD); the port refuses it where the JAX package reads it, before a
    kernel is launched, instead of running its kernels silently."""
    from veles_tpu_torch.ops import attention
    from veles_tpu_torch.samples import mnist, transformer
    knobs.stitch = stitch
    params, velocity, step = transformer.build_train(
        transformer.TINY, device="cpu", compute_dtype=torch.float32)
    knobs.kernels = "XLA"
    attention.reset_launches()
    with pytest.raises(NotImplementedError, match="item 7"):
        transformer.build_train(transformer.TINY, device="cpu")
    # a step built before the knob changed is refused at its attention
    with pytest.raises(NotImplementedError, match="item 7"):
        step(params, velocity,
             transformer.synthetic_tokens(transformer.TINY, 2))
    with pytest.raises(NotImplementedError, match="item 7"):
        mnist.create_workflow(device="cpu", max_epochs=1)
    assert not any(attention.launches.values())


@pytest.mark.parametrize("value", ["on", "strict", "ON"])
def test_health_instrumentation_is_refused_naming_item_6(knobs, value):
    """Item 6(c) ported the instrumentation: ``on`` and ``strict`` now
    instrument the GD stages when segments are built, and, as in the
    JAX package, nothing without segments."""
    from veles_tpu_torch import watch
    from veles_tpu_torch.samples import mnist
    knobs.health = value
    try:
        wf = mnist.create_workflow(device="cpu", max_epochs=1)
        assert [g.name for g in watch.monitor.groups] == ["GDSoftmax",
                                                          "GDTanh"]
        assert watch.monitor.mode == value.lower()
        # the JAX package reads it only when it builds segments
        knobs.stitch = "off"
        wf = mnist.create_workflow(device="cpu", max_epochs=1)
        assert wf.stitch_segments == []
        assert not watch.monitor.armed
    finally:
        watch.monitor.reset()


def test_health_rejects_what_the_jax_package_rejects(knobs):
    from veles_tpu_torch.samples import mnist
    knobs.health = "loud"
    with pytest.raises(ValueError, match="off.on.strict"):
        mnist.create_workflow(device="cpu", max_epochs=1)


def _blob_workflow(package, seed=5):
    """A blob classifier (400 train, 100 validation samples of 16
    features; minibatch 48, so both classes end in a short batch) in the
    port (``package="port"``) or the JAX package, from ``seed``, with
    its closes recorded as ``wf.closes``."""
    import numpy
    if package == "port":
        from veles_tpu_torch import prng
        from veles_tpu_torch.dummy import DummyLauncher
        from veles_tpu_torch.loader.fullbatch import FullBatchLoader
        from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
        device = "cpu"
    else:
        from veles_tpu import prng
        from veles_tpu.backends import CPUDevice
        from veles_tpu.dummy import DummyLauncher
        from veles_tpu.loader.fullbatch import FullBatchLoader
        from veles_tpu.znicz.standard_workflow import StandardWorkflow
        device = CPUDevice()

    class Blobs(FullBatchLoader):
        def load_data(self):
            rng = numpy.random.default_rng(42)
            labels = numpy.tile(numpy.arange(10), 50)
            centers = rng.standard_normal((10, 16)) * 3.0
            data = centers[labels] + rng.standard_normal((500, 16)) * 0.7
            self.original_data.mem = data.astype(numpy.float32)
            self.original_labels = [int(x) for x in labels]
            self.class_lengths[:] = [0, 100, 400]

    prng.seed_all(seed)
    wf = StandardWorkflow(
        None, loader_factory=lambda w: Blobs(w, minibatch_size=48),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 12},
                 "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
                {"type": "softmax", "->": {"output_sample_shape": 10},
                 "<-": {"learning_rate": 0.05}}],
        decision_config={"max_epochs": 3, "fail_iterations": 10 ** 6})
    wf.launcher = DummyLauncher()
    wf.initialize(device=device)
    dec, wf.closes = wf.decision, []
    close = dec._close_class

    def recording(cls, check_epoch_end):
        wf.closes.append((int(dec.epoch_number), cls,
                          float(dec.epoch_n_err[cls]),
                          int(dec.epoch_samples[cls])))
        return close(cls, check_epoch_end)
    dec._close_class = recording
    return wf


@pytest.mark.parametrize("stitch", ["on", "off"])
@pytest.mark.parametrize("every", [1, 50])
def test_metrics_every_gives_the_jax_packages_closes(knobs, every, stitch):
    """``metrics_every`` is ported: the Decision fetches its running sum
    every ``every`` steps (one device→host copy each, and one at each
    class close) and closes each class with the JAX package's error
    counts, stitched or eager."""
    import jax
    from veles_tpu.config import root as jax_root
    from veles_tpu.memory import Vector as JaxVector
    from veles_tpu_torch.memory import Watcher
    jeng = jax_root.common.engine
    saved = {k: jeng.get(k, d) for k, d in (
        ("metrics_every", 0), ("stitch", "on"), ("kernels", "auto"))}
    try:
        jeng.metrics_every, jeng.stitch, jeng.kernels = every, stitch, "xla"
        jwf = _blob_workflow("jax")
        for unit in jwf.units:
            # the JAX eager chain is deterministic only when each unit's
            # results are waited for (tests/test_torch_mnist.py)
            def run(unit=unit, inner=unit.run):
                inner()
                for value in list(unit.__dict__.values()):
                    if isinstance(value, JaxVector):
                        value = value._devmem_
                    if isinstance(value, jax.Array):
                        value.block_until_ready()
            unit.run = run
        jwf.run()
    finally:
        for key, value in saved.items():
            setattr(jeng, key, value)
    knobs.metrics_every, knobs.stitch = every, stitch
    twf = _blob_workflow("port")
    before = Watcher.transfers()["d2h_transfers"]
    twf.run()
    fetches = Watcher.transfers()["d2h_transfers"] - before
    assert twf.closes == jwf.closes
    assert [c[:2] for c in twf.closes] == [(0, 1), (0, 2), (1, 1), (1, 2),
                                           (2, 1)]
    # 3 validation passes of 3 steps, 2 train passes of 9
    steps = 3 * 3 + 2 * 9
    assert fetches == (steps if every == 1 else len(twf.closes))


@pytest.mark.parametrize("kernels", ["auto", "pallas"])
def test_engine_knobs_at_their_defaults_still_run(knobs, kernels):
    """Each knob at a value the port takes: the train step, the
    stitched MNIST workflow and the trace ring run as before."""
    from veles_tpu_torch import trace
    from veles_tpu_torch.samples import mnist
    knobs.kernels, knobs.health, knobs.metrics_every = kernels, "off", 0
    knobs.stitch = "on"
    knobs.trace_capacity = trace.DEFAULT_CAPACITY
    losses = _tiny_step(2)
    assert all(math.isfinite(x) for x in losses) and losses[1] < losses[0]
    wf = mnist.create_workflow(device="cpu", max_epochs=1)
    wf.run()
    assert len(wf.stitch_segments) == 2
    assert wf.decision.history and wf.decision.complete
    trace.configure("off")
    assert trace.recorder.capacity == trace.DEFAULT_CAPACITY


# -- more knobs the JAX package reads in ported modules ---------------------

#: (node path, knob) pairs the tests below set, restored after each
CONFIG_KNOBS = (("ensemble", "train_ratio"), ("watch", "endpoint"),
                ("engine", "backend"), ("engine", "pallas_gemm"),
                ("engine", "pallas_gather"), ("obs", "blackbox_dir"))


@pytest.fixture
def config_knobs():
    """``root.common.<node>`` for each knob of CONFIG_KNOBS, each
    restored (or unset again) after the test."""
    from veles_tpu_torch.config import root
    saved = {}
    for node, key in CONFIG_KNOBS:
        saved[(node, key)] = getattr(root.common, node).__dict__.get(
            key, KeyError)
    yield root.common
    for (node, key), value in saved.items():
        if value is KeyError:
            getattr(root.common, node).__dict__.pop(key, None)
        else:
            setattr(getattr(root.common, node), key, value)


_SERVE_CODE = """
import json, sys
from veles_tpu_torch.backends import CPUDevice
PORT = sys.argv[1] == "port"
if PORT:
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.samples.mnist import MnistLoader
else:
    from veles_tpu import prng
    from veles_tpu.config import root
    from veles_tpu.dummy import DummyWorkflow
    from veles_tpu.samples.mnist import MnistLoader
out = {}
for ratio in (0.5, 0.9, 2.0):
    root.common.ensemble.train_ratio = ratio
    prng.seed_all(3)
    loader = MnistLoader(DummyWorkflow(), minibatch_size=500)
    loader.initialize(device=CPUDevice() if PORT else None)
    served = []
    try:
        for _ in range(40):
            loader.run()
            size = int(loader.minibatch_size)
            served.append([int(loader.minibatch_class), size,
                           loader.minibatch_indices.mem[:size].tolist()])
        error = None
    except Exception as exc:
        error = type(exc).__name__
    out[str(ratio)] = {"served": served, "error": error,
                       "ratio": loader.train_ratio}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def train_ratio_serves():
    """The served sequences of the MNIST loader at each ratio, the port's
    and the JAX package's, each package in a process of its own (JAX
    stays out of this one)."""
    out = {}
    for package in ("port", "jax"):
        proc = subprocess.run(
            [sys.executable, "-c", _SERVE_CODE, package], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu"),
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        out[package] = json.loads(proc.stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("ratio", [0.5, 0.9, 2.0])
def test_ensemble_train_ratio_is_refused_naming_item_7(train_ratio_serves,
                                                       ratio):
    """``root.common.ensemble.train_ratio`` is ported now (ROADMAP item
    7(c)): read when no keyword is passed, a ratio below 1 serves that
    share of the TRAIN span an epoch.  The port serves the JAX loader's
    classes, sizes and index sequence over 40 minibatches of 500; a
    ratio above 1 runs past the dataset and fails in the same serve
    with the same error in both packages.  The name dates from when the
    ratio was refused; the test now checks that it is served."""
    got = train_ratio_serves["port"][str(ratio)]
    want = train_ratio_serves["jax"][str(ratio)]
    assert got == want
    assert got["ratio"] == ratio
    if ratio < 1:
        assert got["error"] is None
        train = [size for cls, size, _idx in got["served"] if cls == 2]
        # the first epoch's TRAIN serves cover the ratio's share, cut as
        # the JAX loader cuts it (0.9 serves 5401: int(0.1 * 6000) is 599)
        share = 6000 - int((1.0 - ratio) * 6000)
        assert sum(train[:int(math.ceil(share / 500))]) == share
    else:
        assert got["error"] is not None and got["served"]


def test_watch_endpoint_is_refused_at_initialize_naming_6c(config_knobs):
    """Item 6(c) ported the bus: ``Workflow.initialize`` now starts it
    on the configured endpoint."""
    from veles_tpu_torch import watch
    from veles_tpu_torch.samples import mnist
    config_knobs.watch.endpoint = "tcp://127.0.0.1:0"
    try:
        mnist.create_workflow(device="cpu", max_epochs=1)
        assert watch.enabled()
        assert watch.bus().endpoint.startswith("tcp://127.0.0.1:")
    finally:
        watch.shutdown()


@pytest.mark.parametrize("knob,value,call", [
    ("pallas_gemm", False, "matmul"), ("pallas_gemm", 0, "matmul"),
    ("pallas_gemm", False, "qmatmul"),
    ("pallas_gather", False, "take_rows"),
    ("pallas_gather", False, "take_rows_served")])
def test_pallas_knobs_set_false_are_refused_naming_item_7(
        config_knobs, knob, value, call):
    """False picks the JAX package's XLA route, which the port has not
    ported: the wrapper refuses before it runs either route."""
    from veles_tpu_torch.ops import gather, gemm, qgemm
    x = torch.ones(3, 4)
    idx = torch.tensor([0, 1], dtype=torch.int32)
    calls = {
        "matmul": lambda: gemm.matmul(x, torch.ones(4, 2)),
        "qmatmul": lambda: qgemm.qmatmul(
            x, torch.ones(4, 2, dtype=torch.int8), torch.ones(2)),
        "take_rows": lambda: gather.take_rows(x, idx),
        "take_rows_served": lambda: gather.take_rows_served(
            [(x, 0)], idx, torch.tensor(0, dtype=torch.int32),
            torch.tensor(2, dtype=torch.int32), 2)}
    setattr(config_knobs.engine, knob, value)
    with pytest.raises(NotImplementedError, match="item 7"):
        calls[call]()


@pytest.mark.parametrize("backend,error", [
    ("numpy", NotImplementedError), ("NumPy", NotImplementedError),
    ("cuda", ValueError), ("tpuu", ValueError)])
def test_engine_backend_refusals(config_knobs, backend, error):
    """``numpy`` names NumpyDevice, which the port does not port by
    decision (item 1); a value the JAX package does not know raises its
    ValueError."""
    from veles_tpu_torch.backends import make_device
    config_knobs.engine.backend = backend
    with pytest.raises(error, match="item 1" if error is
                       NotImplementedError else "unknown backend"):
        make_device()


@pytest.mark.parametrize("backend", ["auto", "tpu", "AUTO", None])
def test_engine_backend_auto_and_tpu_name_the_card(config_knobs, no_cuda,
                                                   backend):
    from veles_tpu_torch.backends import CPUDevice, make_device
    if backend is None:
        config_knobs.engine.__dict__.pop("backend", None)
    else:
        config_knobs.engine.backend = backend
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_device()
    # an explicit device wins over the knob
    assert isinstance(make_device("cpu"), CPUDevice)


def test_engine_backend_cpu_runs_the_workflow_on_the_cpu(config_knobs,
                                                        no_cuda):
    """``cpu`` is the config's request for CPUDevice, not a fallback:
    the workflow built without a device runs there."""
    from veles_tpu_torch.backends import CPUDevice, make_device
    from veles_tpu_torch.samples import mnist
    config_knobs.engine.backend = "cpu"
    assert isinstance(make_device(), CPUDevice)
    wf = mnist.create_workflow(max_epochs=1)
    wf.run()
    assert wf.decision.history


def test_closed_knobs_at_their_defaults_still_run(config_knobs):
    """train_ratio 1, an empty watch endpoint, pallas_gemm and
    pallas_gather True: the stitched MNIST workflow runs and the
    wrappers take their plain versions on CPU tensors."""
    from veles_tpu_torch.ops import gather, gemm
    from veles_tpu_torch.samples import mnist
    config_knobs.ensemble.train_ratio = 1.0
    config_knobs.watch.endpoint = ""
    config_knobs.engine.pallas_gemm = True
    config_knobs.engine.pallas_gather = True
    wf = mnist.create_workflow(device="cpu", max_epochs=1)
    wf.run()
    assert wf.decision.history and wf.decision.complete
    x = torch.ones(3, 4)
    assert gemm.matmul(x, torch.ones(4, 2)).tolist() == [[4.0, 4.0]] * 3
    assert gather.take_rows(x, torch.tensor([2], dtype=torch.int32)
                            ).tolist() == [[1.0] * 4]


# -- the kernel sources and their builder -----------------------------------

@pytest.mark.parametrize("name,replaces", [
    ("flash_fwd", "_attn_kernel"), ("flash_bwd", "_bwd_dq_kernel"),
    ("flash_bwd", "_bwd_dkv_kernel"), ("decode_attn", "_decode_kernel"),
    ("decode_attn", "_paged_decode_kernel"),
    ("gemm", "_matmul_kernel"), ("gemm", "_gd_dx_kernel"),
    ("gemm", "_gd_dw_kernel"), ("gemm", "_gd_db_kernel"),
    ("gather", "_gather_kernel"), ("gather", "_gather_norm_kernel"),
    ("qgemm", "_qmatmul_kernel"), ("reduce", "_reduce_kernel"),
    ("random", "_uniform_kernel")])
def test_kernel_source_names_the_tpu_kernel_it_replaces(name, replaces):
    from veles_tpu_torch.ops import build
    assert name in build.SOURCES
    head = (build.CSRC_DIR / (name + ".cu")).read_text().split("#include")[0]
    tpu_module = name if name in ("gemm", "gather", "qgemm", "reduce",
                                  "random") else "attention"
    assert "veles_tpu/ops/%s.py" % tpu_module in head and replaces in head
    assert "What bounds it on the H100" in head


def test_gather_entries_share_one_row_body():
    """Both entries of csrc/gather.cu move their rows through the one
    device function ``move_rows``: the table switch is written once, and
    the group kernel and the served kernel each call it; the served
    kernel's planted build (row ``size`` served as valid) is one of
    chip_smoke.py's planted builds."""
    import runpy
    source = (REPO / "veles_tpu_torch" / "csrc" / "gather.cu").read_text()
    assert source.count("switch (t.move)") == 1
    for kernel in ("veles_gather_group_kernel", "veles_gather_served_kernel"):
        body = source.split(kernel + "(", 1)[1].split("\n}\n", 1)[0]
        assert "move_rows(g, i, " in body, kernel
    assert 'extern "C" int veles_gather_served(' in source
    assert "VELES_PLANTED_FAULT == 3" in source
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"))
    assert smoke["PLANTED_BUILDS"][("gather", 3)] == \
        "served_row_one_past_the_tail"


def test_library_name_follows_the_source_hash(tmp_path, monkeypatch):
    from veles_tpu_torch.ops import build
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = build.library_path("k")
    assert first.parent == build.BUILD_DIR
    assert build.library_path("k") == first
    (tmp_path / "k.cu").write_text("// two\n")
    assert build.library_path("k") != first
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


def test_editing_a_header_changes_every_library_path(tmp_path, monkeypatch):
    """A source may include any header of csrc/ (mma.cuh, the tensor-core
    building blocks), so an edited header must not load a library built
    from the old one: every library's name follows every header."""
    from veles_tpu_torch.ops import build
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    for name in ("a", "b"):
        (tmp_path / (name + ".cu")).write_text('#include "mma.cuh"\n')
    (tmp_path / "mma.cuh").write_text("// one\n")
    first = {name: build.library_path(name) for name in ("a", "b")}
    assert first["a"] != first["b"]
    (tmp_path / "mma.cuh").write_text("// two\n")
    assert all(build.library_path(name) != path
               for name, path in first.items())
    (tmp_path / "mma.cuh").write_text("// one\n")
    assert {name: build.library_path(name) for name in ("a", "b")} == first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert all(build.library_path(name) != path
               for name, path in first.items())


def test_tensor_core_sources_share_one_header():
    """The three tensor-core sources include csrc/mma.cuh, and none keeps
    its own copy of a helper the header defines."""
    import re
    from veles_tpu_torch.ops import build
    helpers = ("smem_addr", "swz", "cp_async16", "cp_async4",
               "cp_async_commit", "cp_async_wait", "ldsm_x4",
               "ldsm_x4_trans", "mma_bf16", "pack_bf16", "load_tile_tc")

    def defined(text):
        return set(re.findall(r"__forceinline__\s+\w+\s+(\w+)\s*\(", text))

    assert set(helpers) <= defined((build.CSRC_DIR / "mma.cuh").read_text())
    for name in ("flash_fwd", "flash_bwd", "qgemm"):
        source = (build.CSRC_DIR / (name + ".cu")).read_text()
        assert '#include "mma.cuh"' in source, name
        assert not defined(source) & set(helpers), name


def test_builder_raises_without_nvcc(monkeypatch, tmp_path):
    from veles_tpu_torch.ops import build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()


# -- chip_smoke.py ----------------------------------------------------------

def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: True\n"
         "sys.argv = ['chip_smoke.py']\n"
         "import runpy; runpy.run_path('chip_smoke.py', "
         "run_name='__main__')"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "veles_tpu_torch" in proc.stderr


@pytest.mark.parametrize("windows,tries,names", [
    # the first window saw the kernel
    ([{"k<1>": 1}], 1, {"k<1>": 1}),
    # two windows saw nothing, the third the kernel
    ([{}, {}, {"k<1>": 2}], 3, {"k<1>": 2}),
    # a kernel never seen: the check is left to fail after 3 windows
    ([{}, {}, {}, {"k<1>": 1}], 3, {}),
])
def test_chip_smoke_takes_a_name_window_again_only_while_it_saw_none(
        windows, tries, names):
    import runpy
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"))
    left = list(windows)
    taken = []

    def window(fn, names_of=()):
        taken.append(names_of)
        return {"kernel_names": left.pop(0)}
    profiled = smoke["profiled_names"]
    profiled.__globals__["profile_window"] = window
    assert smoke["PROFILE_TRIES"] == 3
    assert profiled(lambda: None, ("k",), bool) == (names, tries)
    assert taken == [("k",)] * tries


def test_chip_smoke_primes_a_profiler_window_before_the_work():
    """``profile_window`` launches PROFILE_PRIMER small kernels inside
    the profiler's window, waits for them, and marks where the work
    starts before it runs the work (late in a process the profiler loses
    the first device records of a window); host ops of the primer are
    not the work's."""
    import runpy
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"))
    window = smoke["profile_window"]
    order = []
    window.__globals__["gpu_sync"] = lambda: order.append("sync")
    window.__globals__["_PRIMER_DEVICE"] = "cpu"

    def work():
        order.append("work")
        return torch.ones(64) + 1
    summary = window(work)
    assert smoke["PROFILE_PRIMER"] >= 64
    assert order == ["sync", "sync", "work", "sync"]
    assert summary["primer_kernels_run"] == smoke["PROFILE_PRIMER"]
    assert summary["primer_kernels_seen"] == 0      # no device here
    assert summary["device_kernels"] == 0


@pytest.mark.parametrize("starts,primer,work", [
    # every primer kernel and every work kernel seen
    ([1, 2, 3, 10, 11], 3, 2),
    # the first records lost: the primer took the loss
    ([3, 10, 11], 1, 2),
    # no marker (a profile taken without the primer): all are the work's
    (None, 0, 3),
])
def test_chip_smoke_counts_only_the_kernels_after_the_work_marker(
        starts, primer, work):
    import runpy
    from torch.autograd import DeviceType
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"))

    class Range(object):
        def __init__(self, start):
            self.start, self.end = start, start + 0.5

    class Event(object):
        def __init__(self, name, start, device_type=DeviceType.CUDA):
            self.name, self.device_type = name, device_type
            self.time_range = Range(start)
            self.device_time_total = 0.5

    if starts is None:
        events = [Event("k", t) for t in (1, 10, 11)]
    else:
        events = [Event("k", t) for t in starts] + [
            Event(smoke["WORK_MARKER"], 5, DeviceType.CPU),
            Event("aten::add_", 0.5, DeviceType.CPU)]

    class Prof(object):
        def events(self):
            return events
    summary = smoke["_profile_summary"](Prof(), 100.0)
    assert summary["primer_kernels_seen"] == primer
    assert summary["device_kernels"] == work
    assert summary["kernels_by_group"] == {"other": work}


_GATHER = "void veles_gather_group_kernel<4>(GroupArgs)"
_SERVED = ("void (anonymous namespace)::veles_gather_served_kernel(int "
           "const*, long long, int const*, int const*, Group)")
_FORWARD = "void veles_gemm_kernel<0, 0>(GemmArgs)"


@pytest.mark.parametrize("names,ok", [
    # 80 minibatches, each one group gather and two forward GEMMs
    ({_GATHER: 80, _FORWARD: 160}, True),
    # the stitched head: one served gather a minibatch
    ({_SERVED: 80, _FORWARD: 160}, True),
    # one served gather missing
    ({_SERVED: 79, _FORWARD: 160}, False),
    # the served gather and the head's earlier index kernels' group gather
    ({_SERVED: 80, _GATHER: 80, _FORWARD: 160}, False),
    # one whole minibatch not seen
    ({_GATHER: 79, _FORWARD: 158}, False),
    # every forward seen, one gather missing
    ({_GATHER: 79, _FORWARD: 160}, False),
    # a second gather kernel of another name
    ({_GATHER: 80, _FORWARD: 160, "void veles_gather_rows(float*)": 1},
     False),
    # a kernel named after the db step
    ({_GATHER: 80, _FORWARD: 160, "void veles_gd_db_kernel(float*)": 1},
     False),
])
def test_chip_smoke_mnist_profile_must_see_every_minibatch(names, ok):
    import runpy
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"))
    breakdown = {"kernel_names": dict(names)}
    assert smoke["_mnist_kernels_ok"](breakdown, 80) is ok
    assert breakdown["minibatches_run"] == 80
    assert breakdown["minibatches_seen"] == names[_FORWARD] / 2


@pytest.mark.parametrize("counts,windows", [
    # every step's library kernels seen: one window
    ([{"matmul": 784}], 1),
    # 5 of 784 dropped, then whole steps: taken again
    ([{"matmul": 779}, {"matmul": 784, "qmatmul": 768}], 2),
    # qmatmul kernels of part of a step, twice: the third window is kept
    ([{"qmatmul": 767}, {"qmatmul": 700}, {"qmatmul": 768}], 3),
    # never whole: the sixth window is kept
    ([{"matmul": 783}] * 6, 6),
])
def test_chip_smoke_takes_a_decode_window_again_while_it_missed_kernels(
        counts, windows):
    """A profiled decode window whose library or qmatmul kernel count is
    not a multiple of its steps missed some (every step launches the
    same kernels); ``profile_breakdown`` profiles the steps again, at
    most ``DECODE_WINDOW_TRIES`` windows, and keeps the last one."""
    import runpy
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"))
    left = [{"kernels_by_group": c} for c in [{}] + counts]

    def window(fn, names_of=()):
        fn()
        return left.pop(0)

    class Engine(object):
        max_slots = 1
        steps = 0

        def prefill(self, prompt):
            return 0, None

        def bucket_for(self, n):
            return 16

        def decode_step(self):
            Engine.steps += 1

        def release_slot(self, slot):
            pass
    breakdown = smoke["profile_breakdown"]
    breakdown.__globals__["profile_window"] = window
    decode = breakdown(Engine(), [[1, 2, 3]])["decode_window"]
    assert decode["windows"] == windows and decode["steps"] == 16
    assert decode["kernels_by_group"] == counts[windows - 1]
    assert Engine.steps == 16 * windows and not left


# -- the batch serving path's refusals ---------------------------------------

def _serving_engine(**kwargs):
    import numpy
    from veles_tpu_torch.serve import InferenceEngine
    w = numpy.eye(4, dtype=numpy.float32)
    return InferenceEngine([{"w": w}], lambda p, x: x @ p[0]["w"], (4,),
                           max_batch_size=4, device="cpu", **kwargs)


def test_serving_engine_raises_without_a_card(no_cuda):
    import numpy
    from veles_tpu_torch.serve import InferenceEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine([{"w": numpy.eye(2, dtype=numpy.float32)}],
                        lambda p, x: x, (2,))
    assert _serving_engine().device == torch.device("cpu")


@pytest.mark.parametrize("kwargs", [
    {"mesh": "one rank"}, {"param_specs": lambda leaf: None}])
def test_serving_engine_mesh_is_refused_naming_7d(kwargs):
    """Once refused naming 7(d): a mesh of one rank, and param_specs
    without a mesh, are the single-device path (the ranks' runs are
    ``tests/test_torch_pod.py``'s)."""
    from veles_tpu_torch.parallel.mesh import Mesh
    if kwargs.get("mesh") == "one rank":
        kwargs = {"mesh": Mesh({"data": 1}, world_size=1)}
    engine = _serving_engine(**kwargs)
    assert engine.mesh is None
    assert engine.describe()["sharded"] is False
    rows = numpy.arange(8, dtype=numpy.float32).reshape(2, 4)
    numpy.testing.assert_array_equal(engine.infer(rows),
                                     _serving_engine().infer(rows))


def _mnist_after_a_run():
    """The MNIST workflow after one validation pass, on the CPU."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import mnist
    prng.seed_all(3)
    wf = mnist.create_workflow(device="cpu", max_epochs=1)
    wf.run()
    return wf


def test_serving_engine_from_snapshot_is_refused_naming_7a(tmp_path):
    """Item 7(a)'s route: ``from_snapshot`` of a saved workflow serves
    what ``from_workflow`` of the workflow serves, bit for bit."""
    import numpy
    from veles_tpu_torch.serve import InferenceEngine
    from veles_tpu_torch.snapshotter import save_snapshot
    wf = _mnist_after_a_run()
    path = save_snapshot(wf, str(tmp_path / "wf.pickle.gz"))
    x = numpy.array(wf.loader.original_data.mem[:5])
    engine = InferenceEngine.from_snapshot(path, max_batch_size=8,
                                           device="cpu")
    direct = InferenceEngine.from_workflow(wf, max_batch_size=8,
                                           device="cpu")
    numpy.testing.assert_array_equal(engine.infer(x), direct.infer(x))
    assert engine.device == torch.device("cpu")


@pytest.fixture
def serve_preflight():
    from veles_tpu_torch.config import root
    saved = root.common.serve.get("preflight")
    yield root.common.serve
    if saved is None:
        root.common.serve.__dict__.pop("preflight", None)
    else:
        root.common.serve.preflight = saved


@pytest.mark.parametrize("mode", [None, "warn", "fail", "WARN"])
def test_registry_preflight_is_refused_naming_7e(serve_preflight, mode):
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch.serve import ModelRegistry
    if mode is not None:
        serve_preflight.preflight = mode
    wf = mnist.create_workflow(device="cpu", max_epochs=1)
    registry = ModelRegistry()
    with pytest.raises(NotImplementedError, match=r"item 7\(e\)"):
        registry.preflight(wf)
    with pytest.raises(NotImplementedError, match=r"item 7\(e\)"):
        registry.load_workflow("mnist", wf,
                               engine_config={"device": "cpu"})
    assert registry.names() == []


def test_registry_preflight_keeps_the_jax_value_check(serve_preflight):
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch.serve import ModelRegistry
    wf = mnist.create_workflow(device="cpu", max_epochs=1)
    registry = ModelRegistry()
    serve_preflight.preflight = "sometimes"
    with pytest.raises(ValueError, match="want off"):
        registry.preflight(wf)
    serve_preflight.preflight = "off"
    assert registry.preflight(wf) is None
    try:
        model = registry.load_workflow(
            "mnist", wf, engine_config={"device": "cpu",
                                        "max_batch_size": 4})
        assert model.source == "StandardWorkflow"
        assert model.engine.compile_count == 3
    finally:
        registry.stop()


def test_recompile_sentinel_strict_is_refused_naming_7e(knobs):
    import numpy
    from veles_tpu_torch import prof
    from veles_tpu_torch.prof import sentinel
    saved = knobs.get("recompile_sentinel")
    engine = _serving_engine()
    try:
        # warn: a capture after warmup is flagged, not raised
        knobs.recompile_sentinel = "warn"
        sentinel.reset()
        engine._warmed = True
        engine.infer(numpy.ones((1, 4), numpy.float32))
        assert [e["site"] for e in prof.flagged] == [
            "serve:%s:bucket[1]" % engine.prof_name]
        knobs.recompile_sentinel = "strict"
        with pytest.raises(NotImplementedError, match=r"item 7\(e\)"):
            engine.infer(numpy.ones((3, 4), numpy.float32))
        assert len(prof.flagged) == 2
    finally:
        knobs.recompile_sentinel = saved
        sentinel.reset()


def test_registry_load_snapshot_roundtrip(serve_preflight, tmp_path):
    """The port's ``tests/test_serve.py::test_load_snapshot_roundtrip``:
    a saved workflow deployed by ``load_snapshot`` answers within 1e-6
    of ``from_workflow``'s engine (the preflight off, as
    ``load_workflow`` needs until item 7(e))."""
    import numpy
    from veles_tpu_torch.serve import InferenceEngine, ModelRegistry
    from veles_tpu_torch.snapshotter import save_snapshot
    wf = _mnist_after_a_run()
    path = save_snapshot(wf, str(tmp_path / "wf.pickle"))
    serve_preflight.preflight = "off"
    registry = ModelRegistry()
    try:
        model = registry.load_snapshot(
            "tiny", path, engine_config={"device": "cpu",
                                         "max_batch_size": 4})
        assert model.source == path
        x = numpy.array(wf.loader.original_data.mem[:3])
        out = registry.infer("tiny", x)
        ref = InferenceEngine.from_workflow(
            wf, device="cpu", max_batch_size=4).infer(x)
        assert numpy.allclose(out, ref, atol=1e-6)
    finally:
        registry.stop()


def test_registry_load_snapshot_keeps_the_preflight(serve_preflight,
                                                    tmp_path):
    from veles_tpu_torch.serve import ModelRegistry
    from veles_tpu_torch.snapshotter import save_snapshot
    path = save_snapshot(_mnist_after_a_run(),
                         str(tmp_path / "wf.pickle"))
    registry = ModelRegistry()
    with pytest.raises(NotImplementedError, match=r"item 7\(e\)"):
        registry.load_snapshot("tiny", path,
                               engine_config={"device": "cpu"})
    assert registry.names() == []


@pytest.mark.parametrize("call,item", [
    (lambda r: r.deploy_fleet("fleet", None), "7(e)"),
])
def test_registry_refusals_name_their_items(call, item):
    from veles_tpu_torch.serve import ModelRegistry
    with pytest.raises(NotImplementedError,
                       match=r"item %s" % item.replace("(", r"\(")
                       .replace(")", r"\)")):
        call(ModelRegistry())


@pytest.mark.parametrize("call,item", [
    (lambda s: s.notify_status("http://127.0.0.1:9/update"), "7(e)"),
])
def test_server_refusals_name_their_items(call, item):
    from veles_tpu_torch.serve import ServingServer
    server = ServingServer()
    try:
        with pytest.raises(NotImplementedError,
                           match=r"item %s" % item.replace("(", r"\(")
                           .replace(")", r"\)")):
            call(server)
    finally:
        server.stop()


# -- the workflow options of item 7 ------------------------------------------

#: the StandardWorkflow options of item 7: each builds (7(b) ported the
#: first seven), the plotters are refused naming 7(e)
_ITEM_7_OPTIONS = {
    "fused": {"fused": True},
    "fused_config": {"fused": True, "fused_config": {"remat": True}},
    "mcdnnic_topology": {"layers": [],
                         "mcdnnic_topology": "784x1x1-100N-10N"},
    "mcdnnic_parameters": {"layers": [], "mcdnnic_topology": "100N-10N",
                           "mcdnnic_parameters": {"<-": {
                               "learning_rate": 0.03}}},
    "plotters_config": {"plotters_config": {}},
    "lr_adjuster_config": {"lr_adjuster_config": {
        "lr_policy_name": "exp"}},
    "rollback_config": {"rollback_config": {}},
    "image_saver_config": {"image_saver_config": {"out_dirs": []}},
}
_STILL_REFUSED = ["plotters_config"]


def test_not_ported_options_are_the_rest_of_item_7():
    from veles_tpu_torch.znicz import standard_workflow
    assert sorted(standard_workflow._NOT_PORTED) == sorted(_STILL_REFUSED)
    assert standard_workflow._NOT_PORTED["plotters_config"] == "7(e)"


@pytest.mark.parametrize("option", sorted(_ITEM_7_OPTIONS))
def test_standard_workflow_options_still_refused(option):
    """Each option of item 7, given (even as an empty dict): the
    plotters raise naming 7(e); the others build their units."""
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    kwargs = dict(_ITEM_7_OPTIONS[option])
    kwargs.setdefault("layers", [dict(spec) for spec in mnist.LAYERS])

    def build():
        return StandardWorkflow(
            None, loader_factory=lambda w: mnist.MnistLoader(w), **kwargs)

    if option in _STILL_REFUSED:
        with pytest.raises(NotImplementedError, match=r"item 7\(e\)"):
            build()
        return
    wf = build()
    linked = {"fused": wf.fused_trainer, "fused_config": wf.fused_trainer,
              "lr_adjuster_config": wf.lr_adjuster,
              "rollback_config": wf.rollback,
              "image_saver_config": wf.image_saver}.get(option)
    if option.startswith("mcdnnic"):
        linked = [s["type"] for s in wf.layers] == ["all2all_tanh",
                                                    "softmax"]
    assert linked


@pytest.mark.parametrize("knob", ["mesh_axes", "fsdp", "tp"])
def test_fused_config_meshes_are_refused_naming_7d(knob):
    """``mesh_axes`` is ported (7(d), part 1), and ``fsdp`` and ``tp``
    (once refused naming 7(d), part 2) with it: over one process each
    builds a trainer whose world is this process alone."""
    from veles_tpu_torch.samples import mnist
    axes = {"data": -1, "model": 1} if knob == "tp" else {"data": -1}
    config = {"mesh_axes": axes}
    if knob != "mesh_axes":
        config[knob] = True
    wf = mnist.create_workflow(device="cpu", fused=True, max_epochs=2,
                               fused_config=config)
    wf.run()
    trainer = wf.fused_trainer
    assert trainer.mesh_axes == axes
    assert trainer._mesh_.shape == {a: 1 for a in axes}
    assert trainer.graph_report()["train_100"]["eager"] > 0
    if knob != "mesh_axes":
        spec = trainer._specs_[0]["w"]
        assert spec == (("data", None) if knob == "fsdp"
                        else (None, "model"))


@pytest.mark.parametrize("value,dtype", [("float32", torch.float32),
                                         ("bfloat16", torch.bfloat16)])
def test_precision_type_is_the_devices_compute_dtype(knobs, value, dtype):
    """``engine.precision_type`` is ported: the devices' compute and
    storage dtype, which the fused trainer's products take (its master
    weights stay f32); an unknown name raises."""
    from veles_tpu_torch.backends import CPUDevice
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import mnist
    assert root.common.engine.precision_type == "float32"
    root.common.engine.precision_type = value
    device = CPUDevice()
    assert device.compute_dtype == device.storage_dtype == dtype
    wf = mnist.create_workflow(device="cpu", max_epochs=1, fused=True,
                               layers=[{"type": "softmax", "->": {
                                   "output_sample_shape": 10}}])
    assert wf.fused_trainer._compute_dtype() == (
        None if dtype == torch.float32 else dtype)
    root.common.engine.precision_type = "float8"
    with pytest.raises(TypeError, match="unknown dtype"):
        CPUDevice().compute_dtype


def test_snapshotter_options_are_ported(tmp_path):
    """``snapshotter_config`` and the sample's ``snapshot_dir`` build
    the snapshotter off the Decision, and neither raises."""
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    wf = mnist.create_workflow(device="cpu", max_epochs=1,
                               snapshot_dir=str(tmp_path))
    assert isinstance(wf.snapshotter, SnapshotterToFile)
    assert wf.snapshotter.directory == str(tmp_path)
    assert wf.snapshotter.prefix == "mnist"
    wf = StandardWorkflow(
        None, loader_factory=lambda w: mnist.MnistLoader(w),
        layers=[dict(spec) for spec in mnist.LAYERS],
        snapshotter_config={"directory": str(tmp_path), "prefix": "p",
                            "compression": "xz"})
    assert wf.snapshotter.compression == "xz"
    assert wf.decision in wf.snapshotter.links_from
    assert wf.snapshotter in wf.decision.links_to


# -- the layer zoo (7(c)) ----------------------------------------------------

_ZOO_MODULES = ("znicz.activation", "znicz.conv", "znicz.pooling",
                "znicz.normalization_units", "znicz.misc_units",
                "znicz.gd_base", "samples.mnist_conv", "samples.cifar10",
                "samples.stl10", "samples.alexnet", "samples.vgg",
                "samples.mnist_ae", "samples.datasets")


def test_importing_the_zoo_loads_no_jax_and_no_veles_tpu():
    proc = _run(
        "import importlib, json, sys\n"
        "for m in %r:\n"
        "    importlib.import_module('veles_tpu_torch.' + m)\n"
        "print(json.dumps(sorted(sys.modules)))\n" % (_ZOO_MODULES,))
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if _forbidden(m)] == []
    assert "veles_tpu_torch.ops.build" not in loaded


@pytest.mark.parametrize("entry", [
    "mnist_conv", "cifar10", "stl10", "mnist_ae_conv", "alexnet", "vgg",
    "vgg_workflow"])
def test_zoo_entry_points_raise_without_a_card(no_cuda, entry):
    from veles_tpu_torch.samples import (alexnet, cifar10, mnist_ae,
                                         mnist_conv, stl10, vgg)
    call = {"mnist_conv": mnist_conv.create_workflow,
            "cifar10": cifar10.create_workflow,
            "stl10": stl10.create_workflow,
            "mnist_ae_conv": lambda: mnist_ae.create_workflow(conv=True),
            "alexnet": alexnet.build_fused, "vgg": vgg.build_fused,
            "vgg_workflow": vgg.create_workflow}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_cpu_conv_workflow_never_loads_the_kernel_builder():
    proc = _run(
        "import sys\n"
        "from veles_tpu_torch.ops import gemm\n"
        "from veles_tpu_torch.samples import mnist_conv\n"
        "layers = [dict(s) for s in mnist_conv.LAYERS]\n"
        "layers[4] = {'type': 'all2all_tanh', '->': "
        "{'output_sample_shape': 16}}\n"
        "wf = mnist_conv.create_workflow(device='cpu', max_epochs=1, "
        "layers=layers, minibatch_size=500)\n"
        "wf.run()\n"
        "assert not any(gemm.launches.values())\n"
        "assert 'veles_tpu_torch.ops.build' not in sys.modules\n")
    assert proc.returncode == 0, proc.stderr + proc.stdout


@pytest.mark.parametrize("knob,stride,want", [
    ("auto", 2, True), (True, 2, True), (False, 2, False),
    # an ineligible conv (stride 1) is never rewritten, forced or not
    ("auto", 1, False), (True, 1, False)])
def test_s2d_conv_knob_forces_the_choice(knob, stride, want):
    from veles_tpu_torch.backends import CPUDevice
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.memory import Vector
    from veles_tpu_torch.znicz.conv import Conv
    from veles_tpu_torch.config import root
    saved = root.common.engine.get("s2d_conv", "auto")
    root.common.engine.s2d_conv = knob
    unit = Conv(DummyWorkflow(), n_kernels=2, kx=3, ky=3,
                sliding=(stride, stride))
    unit.input = Vector(numpy.zeros((2, 9, 9, 3), numpy.float32))
    unit.initialize(device=CPUDevice())
    try:
        assert unit.pure_config()["s2d"] is want
        unit.run()
    finally:
        root.common.engine.s2d_conv = saved
    assert unit.output.shape == unit.output_shape_for((2, 9, 9, 3))


@pytest.mark.parametrize("call", ["workflow", "lowering", "mesh"])
def test_zoo_refusals_name_their_items(call):
    """``mesh=``, once refused naming 7(d), now trains data-parallel
    (here over a one-process mesh, the step the one-device step); the
    recurrent layer types, once refused naming 7(c), now build in the
    workflow and lower in the fused step."""
    from veles_tpu_torch.samples import alexnet, mnist_rnn
    from veles_tpu_torch.znicz import fused_graph
    if call == "mesh":
        from veles_tpu_torch.parallel.mesh import make_mesh
        layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 4}},
                  {"type": "softmax", "->": {"output_sample_shape": 3}}]
        x = torch.ones((4, 6))
        y = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
        states = []
        for mesh in (None, make_mesh({"data": -1})):
            from veles_tpu_torch import prng
            prng.seed_all(5)
            params, step, _e, _a = alexnet.build_fused(
                mesh=mesh, layers=layers, input_shape=(6,), device="cpu")
            step(params, x, y)
            states.append(fused_graph.to_numpy(params))
        for a, b in zip(*states):
            for key in ("w", "b", "vw", "vb"):
                numpy.testing.assert_array_equal(a[key], b[key])
        return
    if call == "workflow":
        wf = mnist_rnn.create_workflow(device="cpu", max_epochs=1, layers=[
            {"type": "rnn", "->": {"hidden_units": 4, "last_only": True}},
            {"type": "softmax", "->": {"output_sample_shape": 10}}])
        assert [type(f).__name__ for f in wf.forwards] == [
            "SimpleRNN", "All2AllSoftmax"]
        assert type(wf.gds[-1]).__name__ == "GDGeneric"
    else:
        params, _step, _eval, _apply = fused_graph.lower_specs(
            [{"type": "lstm", "->": {"hidden_units": 3}}], (4, 3))
        assert params[0]["w"].shape == (6, 12)


# -- the rest of the layer zoo and the data side (7(c)) -----------------------

_REST_MODULES = ("znicz.rnn", "znicz.rbm", "znicz.kohonen",
                 "samples.mnist_rnn", "samples.kohonen", "ops.normalize",
                 "ops.join", "ops.hog", "mean_disp_normalizer",
                 "input_joiner", "avatar", "normalization", "loader.image",
                 "loader.formats", "loader.streaming", "loader.saver")


def test_importing_the_rest_of_7c_loads_no_jax_and_no_optional_package():
    """The new modules import no JAX, and PIL, h5py, pyzmq and lmdb only
    where a loader of theirs loads (the card's machine has none)."""
    proc = _run(
        "import importlib, json, sys\n"
        "for m in %r:\n"
        "    importlib.import_module('veles_tpu_torch.' + m)\n"
        "print(json.dumps(sorted(sys.modules)))\n" % (_REST_MODULES,))
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if _forbidden(m)] == []
    assert not {"PIL", "h5py", "zmq", "lmdb"} & set(loaded)
    assert "veles_tpu_torch.ops.build" not in loaded


@pytest.mark.parametrize("entry", ["mnist_rnn", "mnist_rnn_cli", "kohonen",
                                   "mnist_ae_rbm", "rbm_pretrain"])
def test_rest_of_7c_entry_points_raise_without_a_card(no_cuda, entry):
    from veles_tpu_torch.samples import kohonen, mnist_ae, mnist_rnn
    call = {"mnist_rnn": mnist_rnn.create_workflow,
            "mnist_rnn_cli": lambda: mnist_rnn.main(["--max-epochs", "1"]),
            "kohonen": kohonen.create_workflow,
            "mnist_ae_rbm": lambda: mnist_ae.create_workflow(
                rbm_pretrain=True),
            "rbm_pretrain": lambda: mnist_ae.pretrain_rbm(
                numpy.zeros((4, 784), numpy.float32), batch=2)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_no_refusal_names_7c_any_more():
    """After the rest of 7(c) the port's sources name 7(c) in no
    refusal: what is still left out names 7(d) or 7(e)."""
    hits = []
    for path in PACKAGE.rglob("*.py"):
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            if "7(c)" in line:
                hits.append("%s:%d" % (path.relative_to(REPO), lineno))
    assert hits == []


# -- the job layer and the entry point (7(e), first part) ---------------------

#: the port's modules with no counterpart in the JAX package: the kernel
#: build (nvcc and ctypes), the cost tally, the counted collectives and
#: the job wire (the standard library's TCP in place of ZeroMQ)
PORT_ONLY = ["ops/build.py", "ops/cost.py", "parallel/comm.py",
             "parallel/wire.py"]


def test_the_port_only_modules_are_named():
    def modules(package):
        return {str(p.relative_to(package)) for p in package.rglob("*.py")}
    extra = sorted(modules(PACKAGE) - modules(REPO / "veles_tpu"))
    assert extra == PORT_ONLY


def test_importing_the_job_layer_loads_no_jax_no_veles_tpu_and_no_zmq():
    proc = _run(
        "import json, sys\n"
        "import veles_tpu_torch.parallel.jobs\n"
        "import veles_tpu_torch.__main__\n"
        "import veles_tpu_torch.chaos.__main__\n"
        "import veles_tpu_torch.launcher\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    for module in ("parallel.jobs", "parallel.wire", "chaos.core",
                   "cmdline", "launcher", "__main__"):
        assert "veles_tpu_torch." + module in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    assert "zmq" not in loaded
    assert "veles_tpu_torch.ops.build" not in loaded


def test_each_refused_entry_point_flag_names_7e():
    """Every flag of a module not ported yet: its help and its refusal
    name ROADMAP item 7(e)."""
    from veles_tpu_torch.__main__ import NOT_PORTED, Main
    from veles_tpu_torch.cmdline import make_parser
    helps = {a.dest: a.help for a in make_parser()._actions}
    for dest, flag in NOT_PORTED:
        assert "7(e)" in helps[dest], dest
        value = [] if dest in ("visualize", "graphics", "web_status",
                               "analyze", "manhole", "debug_nans") \
            else ["x"]
        with pytest.raises(NotImplementedError,
                           match=r"%s .*item 7\(e\)" % flag):
            Main(["w", flag.split("/")[-1]] + value).run()


def test_the_entry_point_raises_without_a_card(no_cuda):
    from veles_tpu_torch.__main__ import Main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Main(["veles_tpu_torch.samples.mnist", "--no-logo",
              "--dry-run", "init"]).run()


def test_background_units_run_on_the_thread_pool():
    """``wants_thread`` (refused until 7(e)) runs a unit on the pool: the
    drain goes on, its downstream unit runs after it, run() returns
    only when it is done, and it stays out of a segment."""
    import threading
    import time

    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.units import Unit

    seen = []

    class Background(Unit):
        wants_thread = True

        def run(self):
            time.sleep(0.05)
            seen.append(("background", threading.get_ident()))

    class After(Unit):
        def run(self):
            seen.append(("after", threading.get_ident()))

    wf = DummyWorkflow()
    bg = Background(wf)
    after = After(wf)
    bg.link_from(wf.start_point)
    after.link_from(bg)
    wf.end_point.link_from(after)
    wf.initialize()
    wf.run()
    assert [name for name, _t in seen] == ["background", "after"]
    assert seen[0][1] != threading.get_ident()
    from veles_tpu_torch import stitch
    assert not stitch._gate_compatible(wf.start_point, bg)
