"""The port's performance ledger (``veles_tpu_torch.prof``) and its cost
model (``veles_tpu_torch.ops.cost``), on the CPU.

- The cost model: a stitched MNIST segment's and a window's ledger flops
  are exactly the per-launch formulas summed over the calls one step
  makes (``2·M·N·K`` a product, its epilogue, δ rebuilt, the momentum
  step); at the full MNIST width (784→100→10, minibatch 100) they are
  within 2 % of the JAX ledger's ``cost_analysis`` flops for the same
  segment (measured: the loader-headed forward 1.05 % under, the GD
  segment 0.02 % under, the windows 0.5–1.1 % under: the softmax,
  evaluator and loader elementwise work is XLA's and no kernel
  launch's).  A generative decode and prefill step tally the model's
  analytic count plus their epilogues; a serve bucket its two products.
- MFU is None without a card; with a peak it is achieved over peak, and
  ``peak_dtype`` picks the card's rate for the type.
- The offline report rebuilt from an exported trace has the live
  ledger's rows; the CLI and ``merge`` work on a bundle of a master's
  and a slave's traces from the port's own recorder.
- ``run_smoke`` passes over ``veles_tpu_torch.samples.mnist``.
"""

import json

import numpy
import pytest

from veles_tpu import prng as jax_prng
from veles_tpu import prof as jax_prof
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.config import root as jax_root
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu_torch import backends, prng, prof, trace
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import cost
from veles_tpu_torch.samples import mnist
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"
#: relative tolerance of the port's flops against XLA's cost analysis
JAX_FLOPS_RTOL = 0.02


@pytest.fixture
def knobs():
    keys = (("stitch", "on"), ("epoch_scan", "off"), ("trace", "off"),
            ("kernels", "auto"), ("health", "off"))
    saved = [(eng, {k: eng.get(k, d) for k, d in keys})
             for eng in (root.common.engine, jax_root.common.engine)]
    jax_root.common.engine.kernels = "xla"
    yield root.common.engine
    for eng, values in saved:
        for key, value in values.items():
            setattr(eng, key, value)
    trace.configure()


def _product(m, n, k, bias=True, act=None):
    per = {None: 0, "tanh": 3, "gelu": 8}[act]
    return 2.0 * m * n * k + (m * n if bias else 0) + per * m * n


def _gd(batch, f, n, act, need_err_input):
    """One GD step's flops: dw (2·B·F·N, δ, 7 a weight), the bias step
    (Σδ, 7 a bias), and dx (2·B·N·F, δ) when it is needed."""
    delta = {None: 0, "tanh": 4}[act] * batch * n
    flops = 2.0 * batch * f * n + delta + 7 * f * n + batch * n + 7 * n
    if need_err_input:
        flops += 2.0 * batch * n * f + delta
    return flops


def _mnist_step_flops(wf, batch=100):
    fwd = sum(_product(batch, f.weights.shape[1], f.weights.shape[0],
                       True, f.ACTIVATION if f.ACTIVATION == "tanh"
                       else None) for f in wf.forwards)
    if wf.loader.native_device_dtype:
        fwd += 2.0 * batch * 784           # the head's scale and shift
    gd = sum(_gd(batch, g.weights.shape[0], g.weights.shape[1],
                 g.ACTIVATION, g.need_err_input) for g in wf.gds)
    return fwd, gd


# -- the cost model -----------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_segment_flops_are_the_launch_formulas(knobs, native):
    prof.ledger.reset()
    wf = mnist.create_workflow(device="cpu", max_epochs=2, native=native)
    wf.run()
    fwd, gd = _mnist_step_flops(wf)
    seg1, seg2 = wf.stitch_segments
    assert seg1.prof_entry.flops == fwd
    assert seg2.prof_entry.flops == gd
    for segment in (seg1, seg2):
        entry = segment.prof_entry
        assert entry.peak_dtype == "float32"
        assert entry.compiles == 1 and entry.recompiles == 0
        assert entry.dispatches == segment.dispatches
        assert entry.flops_dispatched == entry.flops * entry.dispatches
        assert entry.bytes_accessed > 0 and entry.dispatch_ns > 0
    assert prof.ledger.flops_dispatched == \
        seg1.prof_entry.flops_dispatched + seg2.prof_entry.flops_dispatched
    assert [r["flops"] for r in wf.stitch_report()] == [fwd, gd]


def test_window_flops_are_one_steps_formulas(knobs):
    prof.ledger.reset()
    knobs.epoch_scan = "auto"
    wf = mnist.create_workflow(device="cpu", max_epochs=2)
    wf.run()
    fwd, gd = _mnist_step_flops(wf)
    entries = {e.name: e for e in prof.ledger.entries("segment")}
    names = [s.names for s in wf.stitch_segments]
    evals = entries["scan:" + "+".join(names[0])]
    train = entries["scan:" + "+".join(names[0] + names[1])]
    assert evals.flops == fwd and train.flops == fwd + gd
    runner = wf.epoch_runner
    assert evals.steps + train.steps == runner.steps
    assert evals.dispatches + train.dispatches == runner.windows
    for entry in (evals, train):
        assert entry.flops_dispatched == entry.flops * entry.steps
        assert entry.compiles == 1 and entry.recompiles == 0
    # a window absorbs every per-step dispatch: those register nothing
    assert all(s.prof_entry is None for s in wf.stitch_segments)


@pytest.mark.parametrize("epoch_scan", ["off", "auto"])
def test_flops_within_the_stated_tolerance_of_jax(knobs, epoch_scan):
    for eng in (knobs, jax_root.common.engine):
        eng.epoch_scan = epoch_scan
    prof.ledger.reset()
    jax_prof.ledger.reset()
    jax_prng.seed_all(7)
    jwf = jax_mnist.create_workflow(device=JaxCPUDevice(), max_epochs=2)
    jwf.run()
    prng.seed_all(7)
    twf = mnist.create_workflow(device="cpu", max_epochs=2)
    twf.run()
    want = {e.name: e.flops for e in jax_prof.ledger.entries("segment")
            if e.compiles}
    got = {e.name: e.flops for e in prof.ledger.entries("segment")
           if e.compiles}
    assert sorted(got) == sorted(want) and len(got) == 2
    for name, flops in want.items():
        assert got[name] <= flops
        numpy.testing.assert_allclose(got[name], flops,
                                      rtol=JAX_FLOPS_RTOL, err_msg=name)


def test_the_tally_is_per_thread_and_adds_on_both_routes():
    import threading

    import torch
    from veles_tpu_torch.ops import gemm
    a, w = torch.ones(4, 5), torch.ones(5, 3)
    seen = []

    def other():
        with cost.Tally() as tally:
            gemm.matmul(a, w)
        seen.append(tally.flops)
    with cost.Tally() as outer:
        thread = threading.Thread(target=other)
        thread.start()
        thread.join()
    assert outer.flops == 0 and seen == [2.0 * 4 * 5 * 3]
    with cost.Tally() as tally:
        gemm.matmul(a, w, torch.ones(3), "tanh")
    assert tally.flops == _product(4, 3, 5, True, "tanh")
    assert tally.bytes == 4 * (20 + 15 + 3 + 12)
    assert tally.cost(scale=2)["flops"] == tally.flops / 2


def test_gen_steps_tally_the_analytic_count_and_their_epilogues():
    from veles_tpu_torch.gen import GenerativeEngine, GenerativeScheduler
    from veles_tpu_torch.gen.model import TransformerGenModel
    from veles_tpu_torch.samples.transformer import TINY
    model = TransformerGenModel(dict(TINY, seq_len=64), device="cpu")
    engine = GenerativeEngine(model, max_slots=2, max_seq=48,
                              device="cpu").warmup()
    scheduler = GenerativeScheduler(engine, name="lm")
    for prompt in ([1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12]):
        scheduler.submit(prompt, max_new_tokens=5)
    scheduler.run_until_idle()
    d, layers = model.dim, model.layers
    f = TINY["mlp_ratio"] * d
    epilogue = layers * (9 * f + d)          # b1, the gelu, b2 a token
    rows = {e.name.split("[")[1][:-1]: e for e in prof.ledger.entries()
            if e.name.startswith(engine.prof_name + "[")}
    decode = rows["decode"]
    assert decode.kind == "decode" and decode.peak_dtype == "float32"
    assert decode.flops == pytest.approx(
        model.decode_flops(2, 48) + 2 * epilogue, rel=1e-12)
    assert decode.items == 8                 # 4 steps of 2 tokens
    assert decode.compiles == 1 and decode.recompiles == 0
    for bucket in (8, 16):
        entry = rows["p%d" % bucket]
        assert entry.kind == "prefill" and entry.items > 0
        assert entry.flops == pytest.approx(
            model.prefill_flops(bucket) + layers * 2 * d * bucket
            + bucket * epilogue, rel=1e-12)
    assert rows["p8"].items + rows["p16"].items == 3 + 9
    engine.close()


def test_serve_buckets_carry_their_products(knobs):
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.serve import InferenceEngine
    from veles_tpu_torch.znicz.all2all import All2All, All2AllTanh
    rng = numpy.random.default_rng(0)
    w0 = rng.standard_normal((8, 6)).astype(numpy.float32)
    w1 = rng.standard_normal((6, 4)).astype(numpy.float32)
    wf = DummyWorkflow()
    tanh, linear = All2AllTanh(wf), All2All(wf)
    engine = InferenceEngine(
        [{"w": w0}, {"w": w1}],
        lambda p, x: linear.pure(p[1], tanh.pure(p[0], x)), (8,),
        max_batch_size=4, device="cpu").warmup()
    engine.infer(rng.standard_normal((3, 8)).astype(numpy.float32))
    entry = prof.ledger.entry("bucket", "%s[b4]" % engine.prof_name, "cpu")
    assert entry.flops == _product(4, 6, 8, False, "tanh") \
        + _product(4, 4, 6, False)
    assert entry.dispatches == 1 and entry.peak_dtype == "float32"
    engine.close()


def test_record_compile_replaces_and_dispatch_adds():
    ledger = prof.PerfLedger()
    entry = ledger.entry("segment", "s")
    ledger.record_compile(entry, cost={"flops": 10.0,
                                       "bytes_accessed": 1.0})
    ledger.record_dispatch(entry, 1000)
    ledger.record_dispatch(entry, 1000, steps=4)
    assert entry.flops_dispatched == 10.0 + 40.0
    # a recapture replaces the cost; it does not add to it
    assert ledger.record_compile(entry, cost={"flops": 20.0,
                                              "bytes_accessed": 1.0},
                                 steady=True)
    ledger.record_dispatch(entry, 1000)
    assert entry.flops == 20.0 and entry.flops_dispatched == 70.0
    assert (entry.compiles, entry.recompiles, ledger.recompiles) == \
        (2, 1, 1)
    # an eager step brings its own cost
    ledger.record_dispatch(entry, 1000, cost={"flops": 5.0,
                                              "bytes_accessed": 0.0})
    assert entry.flops == 5.0 and ledger.flops_dispatched == 75.0
    assert entry.row(None)["steps"] == 4


# -- MFU ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rate", [
    (None, 989e12), ("bfloat16", 989e12), ("float32", 67e12),
    ("tf32", 495e12), ("int8", 989e12)])
def test_peak_table_by_type(dtype, rate):
    assert backends.peak_ops(H100, dtype) == rate
    assert prof.peak_flops(H100, dtype) == rate
    assert backends.peak_ops("NVIDIA A100-SXM4-80GB", dtype) is None
    assert backends.peak_int8_ops(H100) == backends.peak_bf16_flops(H100)


def test_mfu_is_none_without_a_card(knobs):
    assert prof.device_kind() is None and prof.peak_flops() is None
    wf = mnist.create_workflow(device="cpu", max_epochs=2)
    wf.run()
    summary = prof.summary()
    assert summary["peak_flops"] is None and summary["card"] is None
    assert summary["totals"]["mfu"] is None
    assert summary["totals"]["flops_dispatched"] > 0
    assert all(r["mfu"] is None for r in summary["entries"])
    assert "no peak table entry" in wf.perf_report()


@pytest.mark.parametrize("peak_dtype,rate", [
    (None, 989e12), ("float32", 67e12), ("int8", 989e12)])
def test_mfu_follows_the_formula_and_the_type(peak_dtype, rate):
    entry = prof.LedgerEntry("segment", "fake")
    entry.cost = {"flops": 1e9, "bytes_accessed": 1.0}
    entry.dispatches = 10
    entry.add_time(int(1e8))
    entry.flops_dispatched = 1e10
    entry.peak_dtype = peak_dtype
    assert entry.achieved_flops() == pytest.approx(1e11)
    assert entry.mfu(989e12, kind=H100) == pytest.approx(1e11 / rate)
    # a card outside the table: the peak passed in
    assert entry.mfu(1e12, kind="some card") == pytest.approx(0.1)
    # a program on the CPU has none, card or no card
    entry.device = "cpu"
    assert entry.mfu(989e12, kind=H100) is None
    entry.device = "cuda"
    # the session peak passed in stands for an entry without a type
    assert entry.row(1e12, kind=H100)["mfu"] == pytest.approx(
        1e11 / (rate if peak_dtype else 1e12), abs=1e-6)
    assert entry.mfu(None) is None


# -- the offline report, the CLI and merge ----------------------------------

def _traced_run(knobs, tmp_path):
    knobs.trace = "on"
    prof.ledger.reset()
    trace.recorder.clear()
    wf = mnist.create_workflow(device="cpu", max_epochs=2, native=True)
    wf.run()
    path = str(tmp_path / "run.json")
    trace.export.save(path)
    return wf, path


def test_offline_report_has_the_live_rows(knobs, tmp_path):
    wf, path = _traced_run(knobs, tmp_path)
    rows, peak = prof.entries_from_events(trace.export.load(path))
    assert peak is None
    live = {r["name"]: r for r in prof.summary()["entries"]}
    assert sorted(r["name"] for r in rows) == sorted(live)
    for row in rows:
        want = live[row["name"]]
        assert row["flops"] == want["flops"] and row["bytes"] == want["bytes"]
        assert row["compiles"] == want["compiles"] == 1
        assert row["recompiles"] == 0
        assert row["peak_dtype"] == "float32"
        # the dispatch holding the compile is the warm-up, left out
        assert row["dispatches"] == want["dispatches"] - 1
        assert row["flops_dispatched"] == row["flops"] * row["dispatches"]
    text = prof.report_from_events(trace.export.load(path))
    assert "stitched segments" in text and "0 steady-state" in text


def test_cli_offline_report_and_merge(knobs, tmp_path, capsys):
    from veles_tpu_torch.prof.__main__ import main
    _wf, path = _traced_run(knobs, tmp_path)
    assert main([path]) == 0
    out = capsys.readouterr().out
    assert "performance ledger" in out and "e+" in out
    assert main([path, "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)["entries"]
    assert len(rows) == 2 and all(r["flops"] > 0 for r in rows)
    # a master's and a slave's lanes from the port's own recorder
    master = trace.normalize()
    trace.recorder.clear()
    import time
    for dur_ms in (3, 5):
        trace.complete("jobs", "do_job", time.perf_counter_ns(),
                       int(dur_ms * 1e6))
    slave = trace.normalize()
    bundle = prof.merge.make_bundle(
        (master, prof.summary()),
        {"s0": (slave, prof.summary(), 1500),
         "s1": (slave[:1], prof.summary(), 0)})
    bundle_path = str(tmp_path / "bundle.json")
    with open(bundle_path, "w") as fout:
        json.dump(bundle, fout)
    merged = prof.merge.merged_events(prof.merge.load(bundle_path))
    assert [e["ts_us"] for e in merged] == sorted(e["ts_us"] for e in merged)
    shifted = [e for e in merged if e["role"] == "slave-s0"]
    assert shifted[0]["ts_us"] == pytest.approx(slave[0]["ts_us"] + 1.5)
    assert main([bundle_path]) == 0
    report = capsys.readouterr().out
    assert "slave-s0" in report and "straggler spread" in report
    out_path = str(tmp_path / "merged.json")
    assert main(["merge", bundle_path, "-o", out_path]) == 0
    assert "merged timeline" in capsys.readouterr().out
    with open(out_path) as fin:
        payload = json.load(fin)
    roles = {ev["args"]["name"] for ev in payload["traceEvents"]
             if ev.get("ph") == "M"}
    assert {"trainer", "slave-s0", "slave-s1"} <= roles
    assert main([str(tmp_path / "nope.json")]) == 2


def test_metrics_text_shows_flops_dispatched(knobs):
    prof.ledger.reset()
    mnist.create_workflow(device="cpu", max_epochs=2).run()
    text = prof.metrics_text()
    line = next(line for line in text.splitlines()
                if line.startswith("veles_prof_flops_dispatched_total "))
    assert int(line.split()[1]) == int(prof.ledger.flops_dispatched) > 0
    assert "veles_prof_compiles_total 2" in text


def test_prof_smoke_passes_on_the_cpu(knobs, capsys):
    from veles_tpu_torch.prof.__main__ import run_smoke
    assert run_smoke("veles_tpu_torch.samples.mnist", device="cpu") == 0
    assert "prof smoke: OK" in capsys.readouterr().out
