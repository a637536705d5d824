"""The port's stitched MNIST fast path against the JAX package, on the CPU.

On the CPU a segment runs its stage functions in order, eagerly, over
CPU tensors, and every kernel wrapper takes its plain version; CUDA
graphs exist only on the card (``tests/test_torch_kernels.py -m cuda``
and ``chip_smoke.py``).  Held here, on the same numpy inputs:

- the gather functions: the port's ``take_rows`` / ``take_rows_norm``
  against ``_gather_jnp`` / ``_gather_norm_jnp`` and the Pallas
  kernels in interpret mode (u8, f32 and int32 tables; rows of 1, 784
  and (3, 9, 9) elements; negative indices; scalar and per-feature
  affines): gathers exact; gather + normalize within 1e-6 of
  |x·scale| + |shift| per element (XLA may fuse the multiply-add into
  one rounding, which near a cancellation is far from 1e-6 of the
  result itself);
- ``load_mnist(raw=True)``, bit for bit;
- the segments ``build_segments`` makes, by unit names;
- the stitched native workflow from seed 7 against JAX's with
  ``kernels=xla`` and ``stitch=on``: per-class closes and confusion
  matrices equal, parameters and momenta within 1e-4 (minibatch 100,
  and 96, where every class ends in a short batch);
- stitch on against off, a learning-rate change between dispatches,
  the transfers of the stitched route, the options, a JAX state loaded
  through ``params_from_numpy``, the Decision's by-value sums, and a
  planted stale offset scalar that the parity check must catch.
"""

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.config import root as jax_root
from veles_tpu.ops import gather as jax_gather
from veles_tpu.samples import datasets as jax_datasets
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu_torch import prng, stitch
from veles_tpu_torch.config import root
from veles_tpu_torch.memory import Watcher
from veles_tpu_torch.ops import gather, gemm
from veles_tpu_torch.samples import datasets, mnist

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

SEED = 7
PARAM_TOL = 1e-4
NORM_RTOL = 1e-6
#: the JAX stitched native route's class closes at seed 7, minibatch 100
JAX_CLOSES = [(0, 1, 896), (0, 2, 1284), (1, 1, 0), (1, 2, 0), (2, 1, 0)]


@pytest.fixture
def engines():
    """Both packages' engine knobs, restored afterwards; the JAX
    package on its XLA kernels with stitching on."""
    jeng, teng = jax_root.common.engine, root.common.engine
    keys = (("kernels", "auto"), ("stitch", "on"), ("epoch_scan", "off"),
            ("loader", "auto"))
    jsaved = {k: jeng.get(k, d) for k, d in keys}
    tsaved = {k: teng.get(k, d) for k, d in keys[1:]}
    jeng.kernels, jeng.stitch = "xla", "on"
    teng.stitch = "on"
    yield teng
    for key, value in jsaved.items():
        setattr(jeng, key, value)
    for key, value in tsaved.items():
        setattr(teng, key, value)


# -- the gather functions -----------------------------------------------------

ROWS = [(1,), (784,), (3, 9, 9)]
DTYPES = ["uint8", "float32", "int32"]


def _table(dtype, row, n=23, seed=0):
    rng = numpy.random.default_rng(seed)
    if dtype == "uint8":
        data = rng.integers(0, 256, (n,) + row)
    elif dtype == "int32":
        data = rng.integers(-2 ** 20, 2 ** 20, (n,) + row)
    else:
        data = rng.standard_normal((n,) + row)
    idx = rng.integers(0, n, 11).astype(numpy.int32)
    idx[[2, 7, 10]] = -1            # empty slots, one at the end
    return data.astype(dtype), idx


def _port(*arrays):
    return [torch.from_numpy(numpy.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row", ROWS)
def test_take_rows_matches_jax(dtype, row):
    data, idx = _table(dtype, row)
    got = gather.take_rows(*_port(data, idx)).numpy()
    want = numpy.asarray(jax_gather._gather_jnp(data, idx))
    assert got.dtype == want.dtype and got.shape == want.shape
    numpy.testing.assert_array_equal(got, want)
    flat = data.reshape(len(data), -1)
    pallas = numpy.asarray(jax_gather._gather_pallas(flat, idx,
                                                     interpret=True))
    numpy.testing.assert_array_equal(got.reshape(len(idx), -1), pallas)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_take_rows_pads_labels_with_minus_one(dtype):
    """The stitched head's label row: ``where(valid, rows, -1)``."""
    data, idx = _table(dtype, ())
    got = gather.take_rows(*_port(data, idx), pad=-1).numpy()
    want = numpy.where(idx >= 0, data[numpy.maximum(idx, 0)], -1)
    numpy.testing.assert_array_equal(got, want.astype(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("per_feature", [False, True])
def test_take_rows_norm_matches_jax(dtype, row, per_feature):
    data, idx = _table(dtype, row)
    f = int(numpy.prod(row))
    if per_feature:
        rng = numpy.random.default_rng(1)
        scale = rng.uniform(0.5, 2.0, f).astype(numpy.float32)
        shift = rng.standard_normal(f).astype(numpy.float32)
    else:
        scale, shift = 1.0 / 255.0, 0.25
    got = gather.take_rows_norm(*_port(data, idx), (scale, shift)).numpy()
    want = numpy.asarray(jax_gather._gather_norm_jnp(
        data, idx, jnp.asarray(scale, jnp.float32),
        jnp.asarray(shift, jnp.float32)))
    assert got.dtype == numpy.float32 and got.shape == want.shape
    # the size of the terms, per element: |x·scale| + |shift|
    rows = data[numpy.maximum(idx, 0)].reshape(len(idx), -1)
    terms = (numpy.abs(rows * numpy.float32(scale)) + numpy.abs(
        numpy.broadcast_to(numpy.float32(shift), rows.shape))).astype(
        numpy.float64)
    got = got.reshape(len(idx), -1)
    for ref in (want.reshape(len(idx), -1), numpy.asarray(
            jax_gather._gather_norm_pallas(
                data.reshape(len(data), -1), idx,
                jax_gather._norm_row(scale, f),
                jax_gather._norm_row(shift, f), interpret=True))):
        err = numpy.abs(got.astype(numpy.float64) - ref)
        assert (err <= NORM_RTOL * terms).all(), float(err.max())
    # a negative index gives a zero row, not `shift`
    assert not got[idx < 0].any()


# -- data and segments --------------------------------------------------------

def test_load_mnist_raw_equals_jax():
    got = datasets.load_mnist(raw=True)
    want = jax_datasets.load_mnist(raw=True)
    assert got[-1] is False and want[-1] is False
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and g.shape == w.shape
        numpy.testing.assert_array_equal(g, w)
    assert got[0].dtype == numpy.uint8


def _workflows(engines, native=True, max_epochs=3, minibatch_size=100,
               seed=SEED, run=True):
    """(JAX workflow, port workflow) from ``seed``, each with its class
    closes recorded as ``wf.closes``."""
    out = []
    for seed_all, create, dev in (
            (jax_prng.seed_all, jax_mnist.create_workflow, JaxCPUDevice()),
            (prng.seed_all, mnist.create_workflow, "cpu")):
        seed_all(seed)
        wf = create(device=dev, max_epochs=max_epochs,
                    minibatch_size=minibatch_size, native=native)
        _record_closes(wf)
        if run:
            wf.run()
        out.append(wf)
    return out


def _record_closes(wf):
    """``wf.closes``: (epoch, class, n_err, confusion) at every close."""
    dec, ev = wf.decision, wf.evaluator
    close = dec._close_class
    wf.closes = []

    def recording(cls, check_epoch_end):
        wf.closes.append((int(dec.epoch_number), cls,
                          int(dec.epoch_n_err[cls]),
                          _host(ev.confusion_matrix)))
        return close(cls, check_epoch_end)
    dec._close_class = recording


def _host(vec):
    vec.map_read()
    return numpy.array(vec.mem)


def _jax_params(wf):
    gds = list(reversed(wf.gds))
    out = {}
    for i, fwd in enumerate(wf.forwards):
        for name, vec in (("weights", fwd.weights), ("bias", fwd.bias),
                          ("gradient_weights", gds[i].gradient_weights),
                          ("gradient_bias", gds[i].gradient_bias)):
            out["%d.%s" % (i, name)] = _host(vec)
    return out


def _assert_params_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        err = float(numpy.abs(got[name] - ref).max())
        assert err <= tol, (name, err)
        assert err <= tol * float(numpy.abs(ref).max()), (name, err)


def _assert_same_closes(got, want):
    assert [c[:3] for c in got.closes] == [c[:3] for c in want.closes]
    for g, w in zip(got.closes, want.closes):
        numpy.testing.assert_array_equal(g[3], w[3])


def test_segments_equal_jax(engines):
    jwf, twf = _workflows(engines, run=False)
    want = [s.names for s in jwf._stitch_segments_]
    assert want == [["MnistLoader", "All2AllTanh", "All2AllSoftmax",
                     "EvaluatorSoftmax"], ["GDSoftmax", "GDTanh"]]
    assert [s.names for s in twf.stitch_segments] == want
    assert [r["loader_headed"] for r in twf.stitch_report()] == [True,
                                                                 False]


# -- the stitched native workflow --------------------------------------------

@pytest.mark.parametrize("minibatch_size", [100, 96])
def test_stitched_native_workflow_matches_jax(engines, minibatch_size):
    """At minibatch 96 every class ends in a short batch, so the head's
    ``size`` scalar masks a tail."""
    gemm.reset_launches()
    gather.reset_launches()
    jwf, twf = _workflows(engines, minibatch_size=minibatch_size)
    assert [(e, c) for e, c, *_ in twf.closes] == \
        [(0, 1), (0, 2), (1, 1), (1, 2), (2, 1)]
    _assert_same_closes(twf, jwf)
    if minibatch_size == 100:
        assert [c[:3] for c in twf.closes] == JAX_CLOSES
    _assert_params_close(twf.params_to_numpy(), _jax_params(jwf),
                         PARAM_TOL)
    report = twf.stitch_report()
    batches = (-(-1000 // minibatch_size), -(-6000 // minibatch_size))
    assert [r["dispatches"] for r in report] == [
        3 * batches[0] + 2 * batches[1], 2 * batches[1]]
    # no graphs on the CPU: the stages ran eagerly
    assert all(r["captures"] == 0 for r in report)
    assert not any(gemm.launches.values())
    assert not any(gather.launches.values())
    assert twf.gather_results()["best_validation_error_pt"] == \
        jwf.gather_results()["best_validation_error_pt"]


def _port_run(native, stitch_mode, max_epochs=3, hook=None, seed=SEED):
    root.common.engine.stitch = stitch_mode
    prng.seed_all(seed)
    wf = mnist.create_workflow(device="cpu", max_epochs=max_epochs,
                               native=native)
    _record_closes(wf)
    if hook is not None:
        hook(wf)
    wf.run()
    return wf


@pytest.mark.parametrize("loader_mode", ["auto", "host"])
def test_stitch_on_and_off_agree(engines, loader_mode):
    """``loader=host`` keeps the loader a per-unit barrier: the first
    segment starts at the first forward and reads the eager fill."""
    engines.loader = loader_mode
    on = _port_run(False, "on")
    heads = [s.names[0] for s in on.stitch_segments]
    assert heads == ["MnistLoader" if loader_mode == "auto"
                     else "All2AllTanh", "GDSoftmax"]
    assert on.stitch_segments[0].dispatches == 150
    off = _port_run(False, "off")
    assert not off.stitch_segments
    _assert_same_closes(on, off)
    got, want = on.params_to_numpy(), off.params_to_numpy()
    for name in want:
        numpy.testing.assert_array_equal(got[name], want[name], name)


def _halve_lr_after_epoch_0(wf):
    """Halve every GD learning rate at the first class close of epoch
    1: a frozen hyperparameter would keep the old rate."""
    dec = wf.decision
    close = dec._close_class

    def closing(cls, check_epoch_end):
        if int(dec.epoch_number) == 1 and cls == 1:
            for unit in wf.gds:
                unit.learning_rate *= 0.5
                unit.learning_rate_bias *= 0.5
        return close(cls, check_epoch_end)
    dec._close_class = closing


def test_learning_rate_change_reaches_the_stitched_step(engines):
    on = _port_run(False, "on", hook=_halve_lr_after_epoch_0)
    off = _port_run(False, "off", hook=_halve_lr_after_epoch_0)
    unchanged = _port_run(False, "on")
    _assert_same_closes(on, off)
    got, want = on.params_to_numpy(), off.params_to_numpy()
    for name in want:
        numpy.testing.assert_array_equal(got[name], want[name], name)
    assert not numpy.array_equal(got["0.weights"],
                                 unchanged.params_to_numpy()["0.weights"])


def test_stale_offset_scalar_fails_the_check(engines, monkeypatch):
    """The planted fault ``chip_smoke.py`` also plants: the loader's
    (offset, size) written once and never again, so every minibatch
    reads the first one's rows."""
    good = _port_run(True, "on")
    write = stitch.ScalarBlock.write
    written = set()

    def stale(self, values):
        if self.dtype == torch.int32 and id(self) in written:
            return
        written.add(id(self))
        write(self, values)
    monkeypatch.setattr(stitch.ScalarBlock, "write", stale)
    bad = _port_run(True, "on")
    assert [c[:3] for c in bad.closes] != [c[:3] for c in good.closes] \
        or any(not numpy.array_equal(b[3], g[3])
               for b, g in zip(bad.closes, good.closes))


def test_stitched_route_moves_only_the_scalar_blocks(engines):
    """After the first dispatches upload the parameters, the indices and
    the momenta, a minibatch moves only its scalar blocks: the loader's
    offset and size (8 B), and on train minibatches the GD segment's
    six hyperparameters of each of the two layers (48 B of float32).
    The shuffled indices move once per shuffle, in place."""
    root.common.engine.stitch = "on"
    prng.seed_all(SEED)
    wf = mnist.create_workflow(device="cpu", max_epochs=3, native=True)
    loader = wf.loader
    head = wf.stitch_segments[0].stages[0]
    moved, prelude = [], head.prelude

    def counted():
        moved.append(Watcher.transfers())
        prelude()
    head.prelude = counted
    before = Watcher.transfers()
    wf.run()
    after = Watcher.transfers()
    moved.append(after)
    steps = [b["h2d_bytes"] - a["h2d_bytes"]
             for a, b in zip(moved, moved[1:])]
    assert len(steps) == 150
    assert numpy.median(steps) <= 64
    # validation minibatches 8 B, train minibatches 8 + 2 * 6 * 4 B
    assert set(steps[1:10] + steps[11:70] + steps[71:80]) == {8, 56}
    shuffles = after["h2d_inplace_transfers"] - \
        before["h2d_inplace_transfers"]
    assert shuffles == 2                  # the shuffles of epochs 1 and 2
    assert after["h2d_inplace_bytes"] - before["h2d_inplace_bytes"] == \
        2 * 7000 * 4
    address = loader.shuffled_indices.devmem.data_ptr()
    assert steps[70] == 8 + 28000 and steps[140] == 8 + 28000
    assert loader.shuffled_indices.devmem.data_ptr() == address
    assert after["d2h_transfers"] - before["d2h_transfers"] == 5


# -- options ------------------------------------------------------------------

def test_options_raise(engines):
    root.common.engine.stitch = "off"
    with pytest.raises(ValueError, match="stitched device fast path"):
        mnist.create_workflow(device="cpu", native=True)
    root.common.engine.stitch = "on"
    root.common.engine.loader = "host"
    with pytest.raises(ValueError, match="stitched device fast path"):
        mnist.create_workflow(device="cpu", native=True)
    root.common.engine.loader = "auto"


def test_native_cli_runs_the_stitched_route(engines, capsys):
    assert mnist.main(["--device", "cpu", "--native", "--max-epochs",
                       "2"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"best_validation_error_pt": 0.0' in line


# -- weights across, and the Decision's sums ---------------------------------

def test_jax_stitched_state_loads_into_the_port(engines):
    """A JAX stitched run's state after one train pass, loaded into a
    fresh JAX workflow and into the port through ``params_from_numpy``
    (both seeded alike, so they shuffle alike): the next epoch gives
    the same closes and parameters."""
    jax_prng.seed_all(SEED)
    first = jax_mnist.create_workflow(device=JaxCPUDevice(), max_epochs=2,
                                      native=True)
    first.run()
    state = _jax_params(first)
    jwf, twf = _workflows(engines, max_epochs=2, seed=SEED + 1, run=False)
    gds = list(reversed(jwf.gds))
    for i, fwd in enumerate(jwf.forwards):
        for name, vec in (("weights", fwd.weights), ("bias", fwd.bias),
                          ("gradient_weights", gds[i].gradient_weights),
                          ("gradient_bias", gds[i].gradient_bias)):
            vec.reset(state["%d.%s" % (i, name)].copy())
    twf.params_from_numpy(state)
    jwf.run()
    twf.run()
    # the loaded state has learned the stand-in: no errors from the start
    assert [c[:3] for c in twf.closes] == [(0, 1, 0), (0, 2, 0), (1, 1, 0)]
    _assert_same_closes(twf, jwf)
    _assert_params_close(twf.params_to_numpy(), _jax_params(jwf),
                         PARAM_TOL)


def test_decision_sums_device_scalars_by_value(engines):
    """The evaluator's n_err overwritten in place after every minibatch,
    as a graph replay overwrites its static output: the class sums must
    not change."""
    def overwrite(wf):
        dec, ev = wf.decision, wf.evaluator
        run = dec.run

        def run_then_overwrite():
            run()
            ev.n_err.fill_(12345)
        dec.run = run_then_overwrite

    want = _port_run(True, "on")
    got = _port_run(True, "on", hook=overwrite)
    assert [c[:3] for c in got.closes] == [c[:3] for c in want.closes]
    assert [c[:3] for c in want.closes] == JAX_CLOSES


# -- segment rules ------------------------------------------------------------

def test_a_donated_vector_read_elsewhere_is_not_stitchable():
    """The donation-aliasing check: a buffer one stage updates in place
    must not also be another slot of the segment."""
    from types import SimpleNamespace

    from veles_tpu_torch.memory import Vector
    units = [SimpleNamespace(name="a"), SimpleNamespace(name="b")]
    shared, other = Vector(numpy.zeros(3, numpy.float32)), \
        Vector(numpy.zeros(3, numpy.float32))
    readers = stitch.StitchStage(None, None, consumes={"x": shared},
                                 produces={"y": other})
    writer = stitch.StitchStage(None, None, donated={"w": shared})
    with pytest.raises(ValueError, match="aliases a donated Vector"):
        stitch.StitchSegment(units, [readers, writer], "cpu")
    assert stitch.StitchSegment(units, [
        stitch.StitchStage(None, None, produces={"y": other}), writer],
        "cpu").report()["dispatches"] == 0


def test_a_failing_stitch_stage_propagates(engines, monkeypatch):
    """No per-unit fallback: an exception in ``stitch_stage()`` reaches
    the caller of ``initialize()``."""
    from veles_tpu_torch.znicz import gd

    def broken(self):
        raise RuntimeError("broken stage")
    monkeypatch.setattr(gd.GradientDescent, "stitch_stage", broken)
    with pytest.raises(RuntimeError, match="broken stage"):
        mnist.create_workflow(device="cpu", max_epochs=1)
