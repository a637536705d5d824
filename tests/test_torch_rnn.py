"""The recurrent layers (``znicz/rnn.py``) and ``samples/mnist_rnn.py``
against the JAX package, on the CPU, over inputs drawn from a seed with
numpy.

- ``LSTM`` / ``SimpleRNN`` ``pure_fn`` against the JAX ``pure`` (its
  ``lax.scan``), with a bias and without, ``last_only`` both ways,
  within ``FWD_TOL`` = 1e-6 max abs.
- The initial weights from one ``forward_init`` seed equal the JAX
  unit's, and the bias is zero but the forget slice ``[H:2H]`` at 1.
- One ``GDGeneric`` step (the VJP through the loop, the momentum update)
  against the JAX unit's ``compute``: the parameters, momenta and
  ``err_input`` within ``GD_TOL`` = 1e-6, two steps.
- ``lower_specs`` over an LSTM and a SimpleRNN stack step for step: the
  parameters and solver state within ``PARAM_TOL`` = 1e-5 (f32) and the
  losses within 1e-5 (measured 3e-8); the bf16 lowering within
  ``BF16_TOL`` = 2e-4 (measured 5.7e-5: bf16 products rounded in
  another order).
- ``mnist_rnn`` at hidden 16, minibatch 50, two epochs on the stand-in,
  eager and stitched, against the JAX eager chain: every class close's
  ``n_err`` and the confusion matrix equal, every weight, bias and
  momentum within ``PARAM_TOL``.
- The ledger's tally of an LSTM forward is the JAX formula
  ``lstm_fwd_flops``, and three times it with a gradient recorded.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.config import root as jax_root
from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
from veles_tpu.memory import Vector as JaxVector
from veles_tpu.samples import mnist_rnn as jax_mnist_rnn
from veles_tpu.units import UnitRegistry as JaxRegistry
from veles_tpu.znicz import fused_graph as jax_fused_graph
from veles_tpu.znicz import gd_base as jax_gd_base  # noqa: F401
from veles_tpu.znicz import rnn as jax_rnn
from veles_tpu_torch import prng
from veles_tpu_torch.backends import CPUDevice
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.ops import cost
from veles_tpu_torch.samples import mnist_rnn
from veles_tpu_torch.units import UnitRegistry
from veles_tpu_torch.znicz import fused_graph, gd_base, rnn

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

FWD_TOL = 1e-6
GD_TOL = 1e-6
PARAM_TOL = 1e-5
LOSS_TOL = 1e-5
BF16_TOL = 2e-4
_PAIRS = {"lstm": (rnn.LSTM, jax_rnn.LSTM),
          "rnn": (rnn.SimpleRNN, jax_rnn.SimpleRNN)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread: these small ops, thousands a
    minibatch, otherwise wait for a descheduled pool thread whenever the
    box's cores are busy (~8 ms an op beside the parallel suite)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return numpy.random.default_rng(seed)


@pytest.mark.parametrize("last_only", [False, True])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("kind", sorted(_PAIRS))
def test_pure_matches_jax(kind, bias, last_only):
    port, ref = _PAIRS[kind]
    h, d = 5, 3
    gates = port.GATES
    rng = _rng(1)
    x = rng.standard_normal((4, 6, d)).astype(numpy.float32)
    params = {"w": rng.standard_normal((d + h, gates * h)).astype(
        numpy.float32) * 0.5}
    if bias:
        params["b"] = rng.standard_normal(gates * h).astype(numpy.float32)
    want = numpy.asarray(ref.pure(params, x, hidden_units=h,
                                  last_only=last_only))
    got = port.pure_fn({k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(x), hidden_units=h,
                       last_only=last_only).numpy()
    assert got.shape == want.shape == ((4, h) if last_only else (4, 6, h))
    assert numpy.abs(got - want).max() <= FWD_TOL


@pytest.mark.parametrize("kind", sorted(_PAIRS))
def test_initial_weights_and_forget_bias_match_jax(kind):
    x = numpy.zeros((2, 4, 3), numpy.float32)
    kwargs = {"hidden_units": 6, "weights_filling": "uniform"}
    jax_prng.seed_all(11)
    junit = JaxRegistry.mapped[kind](JaxDummyWorkflow(), **kwargs)
    junit.input = JaxVector(x)
    junit.initialize(device=None)
    prng.seed_all(11)
    unit = UnitRegistry.mapped[kind](DummyWorkflow(), **kwargs)
    unit.input = Vector(x)
    unit.initialize(device=CPUDevice())
    assert unit.weights.shape == (9, unit.GATES * 6)
    assert numpy.array_equal(unit.weights.mem, junit.weights.mem)
    assert numpy.array_equal(unit.bias.mem, junit.bias.mem)
    want = numpy.zeros(unit.GATES * 6, numpy.float32)
    if kind == "lstm":
        want[6:12] = 1.0
    assert numpy.array_equal(unit.bias.mem, want)
    assert unit.output.shape == (2, 4, 6)


_BW = {"learning_rate": 0.05, "learning_rate_bias": 0.03,
       "gradient_moment": 0.9, "gradient_moment_bias": 0.8,
       "weights_decay": 0.01, "weights_decay_bias": 0.002}


@pytest.mark.parametrize("last_only", [True, False])
@pytest.mark.parametrize("kind", sorted(_PAIRS))
def test_gd_generic_step_matches_jax(kind, last_only):
    rng = _rng(8)
    x = rng.standard_normal((3, 5, 4)).astype(numpy.float32)
    fkw = {"hidden_units": 6, "last_only": last_only,
           "bias_filling": "uniform", "bias_stddev": 0.3}
    jwf = JaxDummyWorkflow()
    jfwd = JaxRegistry.mapped[kind](jwf, **fkw)
    jfwd.input = JaxVector(x.copy())
    jfwd.initialize(device=None)
    wf = DummyWorkflow()
    tfwd = UnitRegistry.mapped[kind](wf, **fkw)
    tfwd.input = Vector(x.copy())
    tfwd.weights.reset(numpy.array(jfwd.weights.mem))
    tfwd.bias.reset(numpy.array(jfwd.bias.mem))
    tfwd.initialize(device=CPUDevice())
    tgd = UnitRegistry.mapped["gd_generic"](wf, **_BW)
    tgd.setup_from_forward(tfwd)
    tgd.err_output = Vector(numpy.zeros(jfwd.output.shape, numpy.float32))
    tgd.initialize(device=CPUDevice())
    jgd = JaxRegistry.mapped["gd_generic"](jwf, **_BW)
    jgd.setup_from_forward(jfwd)
    compute = jax.jit(jgd._step_fn())
    params = {k: numpy.array(v) for k, v in
              jfwd.pure_params(host=True).items()}
    vstate = {k: numpy.zeros_like(v) for k, v in params.items()}
    for step in range(2):
        err = rng.standard_normal(jfwd.output.shape).astype(numpy.float32)
        tgd.err_output.reset(err.copy())
        new_p, new_v, dx = compute(params, vstate, jnp.asarray(x),
                                   jnp.asarray(err), jgd._hyper())
        params = {k: numpy.asarray(v) for k, v in new_p.items()}
        vstate = {k: numpy.asarray(v) for k, v in new_v.items()}
        tgd.run()
        assert numpy.abs(tgd.err_input.mem - numpy.asarray(dx)).max() \
            <= GD_TOL, step
        for key, vec, mom in (("w", tfwd.weights, tgd.gradient_weights),
                              ("b", tfwd.bias, tgd.gradient_bias)):
            assert numpy.abs(vec.mem - params[key]).max() <= GD_TOL, key
            assert numpy.abs(mom.mem - vstate[key]).max() <= GD_TOL, key


# -- the fused lowering -------------------------------------------------------

_STACKS = {
    "lstm": [{"type": "lstm", "->": {"hidden_units": 8, "last_only": True},
              "<-": dict(_BW)},
             {"type": "softmax", "->": {"output_sample_shape": 4},
              "<-": dict(_BW)}],
    "rnn_seq": [{"type": "rnn", "->": {"hidden_units": 6},
                 "<-": {"learning_rate": 0.05, "solver": "adam"}},
                {"type": "lstm", "->": {"hidden_units": 5,
                                        "last_only": True},
                 "<-": dict(_BW)},
                {"type": "softmax", "->": {"output_sample_shape": 4},
                 "<-": dict(_BW)}],
}
_SHAPE, _BATCH, _STEPS = (7, 3), 8, 3


def _batches():
    rng = _rng(0)
    return [(rng.standard_normal((_BATCH,) + _SHAPE).astype(numpy.float32),
             rng.integers(0, 4, _BATCH).astype(numpy.int32))
            for _ in range(_STEPS)]


def _lower_jax(stack, bf16):
    jax_prng.seed_all(3)
    kwargs = {"compute_dtype": jnp.bfloat16} if bf16 else {}
    params, step, _eval, apply_fn = jax_fused_graph.lower_specs(
        [dict(s) for s in _STACKS[stack]], _SHAPE, **kwargs)
    step = jax.jit(step)
    losses = []
    for x, y in _batches():
        params, m = step(params, x, y)
        losses.append(float(m["loss"]))
    return jax.tree.map(lambda v: None if v is None else numpy.asarray(v),
                        params), losses


@pytest.fixture(scope="module")
def jax_lowered():
    return {(s, b): _lower_jax(s, b) for s in _STACKS for b in (False,
                                                                 True)
            if not (b and s == "rnn_seq")}


def _gap(got, want):
    gap = 0.0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if w[key] is None:
                assert g[key] is None
            elif key == "t":
                assert numpy.array_equal(g[key], w[key])
            else:
                gap = max(gap, float(numpy.abs(g[key] - w[key]).max()))
    return gap


@pytest.mark.parametrize("stack,bf16", [("lstm", False), ("rnn_seq", False),
                                        ("lstm", True)])
def test_lowered_recurrent_step_matches_jax(jax_lowered, stack, bf16):
    want, want_losses = jax_lowered[(stack, bf16)]
    prng.seed_all(3)
    params, step, _eval, _apply = fused_graph.lower_specs(
        [dict(s) for s in _STACKS[stack]], _SHAPE,
        compute_dtype="bfloat16" if bf16 else None)
    params = fused_graph.to_tensors(params, "cpu")
    losses = []
    for x, y in _batches():
        params, m = step(params, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(m["loss"]))
    got = fused_graph.to_numpy(params)
    if bf16:
        assert _gap(got, want) <= BF16_TOL
        assert losses == pytest.approx(want_losses, abs=BF16_TOL)
    else:
        assert _gap(got, want) <= PARAM_TOL
        assert losses == pytest.approx(want_losses, abs=LOSS_TOL)


# -- the sample ---------------------------------------------------------------

_SMALL = [dict(s) for s in mnist_rnn.LAYERS]
_SMALL[0] = {"type": "lstm",
             "->": {"hidden_units": 16, "last_only": True,
                    "weights_filling": "uniform"},
             "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}}
_MINIBATCH = 50


def _closes(wf):
    dec = wf.decision
    dec.closes_seen = []
    close = dec._close_class

    def recording(cls, check_epoch_end):
        dec.closes_seen.append((int(dec.epoch_number), int(cls),
                                float(dec.epoch_n_err[cls])))
        return close(cls, check_epoch_end)
    dec._close_class = recording
    return wf


def _params(wf):
    gds = list(reversed(wf.gds))
    out = {}
    for i, fwd in enumerate(wf.forwards):
        for name, vec in (("w", fwd.weights), ("b", fwd.bias),
                          ("vw", gds[i].gradient_weights),
                          ("vb", gds[i].gradient_bias)):
            if vec:
                vec.map_read()
                out["%d.%s" % (i, name)] = numpy.array(vec.mem)
    return out


def _synchronous(wf):
    for unit in wf.units:
        def run(unit=unit, inner=unit.run):
            inner()
            for value in list(unit.__dict__.values()):
                if isinstance(value, JaxVector):
                    value = value._devmem_
                if isinstance(value, jax.Array):
                    value.block_until_ready()
        unit.run = run


@pytest.fixture(scope="module")
def jax_mnist_rnn_run():
    eng = jax_root.common.engine
    saved = {k: eng.get(k, d) for k, d in (("kernels", "auto"),
                                           ("stitch", "on"))}
    eng.kernels, eng.stitch = "xla", "off"
    try:
        jax_prng.seed_all(7)
        wf = jax_mnist_rnn.create_workflow(
            device=JaxCPUDevice(), max_epochs=2, minibatch_size=_MINIBATCH,
            layers=_SMALL)
        _synchronous(wf)
        _closes(wf).run()
    finally:
        for key, value in saved.items():
            setattr(eng, key, value)
    wf.evaluator.confusion_matrix.map_read()
    return {"closes": wf.decision.closes_seen, "params": _params(wf),
            "confusion": numpy.array(wf.evaluator.confusion_matrix.mem)}


@pytest.mark.parametrize("stitch", ["off", "on"])
def test_mnist_rnn_trains_as_the_jax_workflow(jax_mnist_rnn_run, stitch):
    saved = root.common.engine.get("stitch", "on")
    root.common.engine.stitch = stitch
    try:
        prng.seed_all(7)
        wf = mnist_rnn.create_workflow(device="cpu", max_epochs=2,
                                       minibatch_size=_MINIBATCH,
                                       layers=_SMALL)
        _closes(wf).run()
    finally:
        root.common.engine.stitch = saved
    want = jax_mnist_rnn_run
    assert wf.decision.closes_seen == want["closes"]
    assert len(want["closes"]) == 3
    assert numpy.array_equal(wf.evaluator.confusion_matrix.mem,
                             want["confusion"])
    got = _params(wf)
    assert sorted(got) == sorted(want["params"])
    for name, ref in want["params"].items():
        assert numpy.abs(got[name] - ref).max() <= PARAM_TOL, name
    segments = [seg.names for seg in wf.stitch_segments]
    if stitch == "on":
        assert segments == [
            ["MnistRowsLoader", "LSTM", "All2AllSoftmax",
             "EvaluatorSoftmax"], ["GDSoftmax", "GDGeneric"]]
    else:
        assert segments == []


def test_lstm_tallies_the_jax_formula():
    rng = _rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 5, 4)).astype(
        numpy.float32))
    params = {"w": torch.from_numpy(rng.standard_normal((10, 24)).astype(
        numpy.float32)), "b": torch.zeros(24)}
    config = {"hidden_units": 6, "last_only": True}
    with cost.Tally() as fwd:
        out = rnn.LSTM.pure_fn(params, x, **config)
    assert fwd.flops == rnn.lstm_fwd_flops(3, 5, 4, 6)
    assert fwd.bytes == 4 * (x.numel() + 240 + 24 + out.numel())
    with cost.Tally() as step:
        gd_base.vjp(rnn.LSTM.pure_fn, config, params, x,
                    torch.ones(out.shape))
    assert step.flops == rnn.lstm_train_flops(3, 5, 4, 6)
    assert rnn.lstm_train_flops(1, 2, 3, 4, gates=1) == \
        jax_rnn.lstm_train_flops(1, 2, 3, 4, gates=1)
