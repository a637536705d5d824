"""The fused lowering over the layer zoo (``lower_specs``) against the JAX
package's, on the CPU.

- AlexNet's topology at small widths (a strided conv, LRN, max pooling,
  a grouped padded conv, dropout before two strict-relu layers, the
  softmax; 19×19×3 images, batch 8): three train steps from one seed,
  the port's step updating its tensors in place, the JAX step jitted.
  Each step's loss within ``LOSS_TOL`` and ``n_err`` equal; after the
  steps every leaf of every layer's state (weights, biases, momenta,
  the stage seeds) within ``PARAM_TOL`` = 1e-5 max abs, the seeds equal
  (measured: 3e-8 on the parameters, 2.4e-7 on the losses).  The eval
  step's ``n_err`` equal and ``apply_fn``'s output (dropout left out)
  within ``PARAM_TOL``.
- The same stack under ``grad_accum=2`` (each microbatch's dropout
  masks from its own seed, the JAX stride), under the same bounds.
- An mcdnnic ``C``/``MP`` topology (``1x8x8-3C3-MP2-5N``) lowered from
  its parsed specs, under the same bounds.
- bf16 (``compute_dtype``): the gap between the port's bf16 step and
  the JAX package's is measured, not assumed.  Both cast the operands to
  bf16 and sum in f32, but XLA's CPU conv and torch's CPU conv sum in
  different orders and round their bf16 outputs at different points:
  after three steps the parameters differ by at most ``BF16_TOL`` = 8e-5
  max abs (measured over seeds 3, 4 and 5: 1.7e-5 to 4.9e-5, while an
  f32 run of the port is 1.05e-4 to 1.8e-4 from the JAX bf16 run, so
  the bound tells the two apart) and the losses by ``BF16_LOSS_TOL`` =
  2e-3 (measured: 7.6e-4 at most).
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.znicz import fused_graph as jax_fused_graph
from veles_tpu_torch import prng
from veles_tpu_torch.znicz import fused_graph, mcdnnic

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

PARAM_TOL = 1e-5
LOSS_TOL = 1e-5
BF16_TOL = 8e-5
BF16_LOSS_TOL = 2e-3
STEPS = 3
BATCH = 8

_BW = {"learning_rate": 0.05, "gradient_moment": 0.9,
       "weights_decay": 0.0005}

ALEXNET_SMALL = [
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 4, "kx": 5, "ky": 5, "sliding": (2, 2),
            "weights_filling": "gaussian", "weights_stddev": 0.1},
     "<-": dict(_BW)},
    {"type": "lrn", "->": {"alpha": 1e-2, "beta": 0.75, "n": 3, "k": 2.0}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 4, "kx": 3, "ky": 3, "padding": 1, "grouping": 2,
            "weights_filling": "gaussian", "weights_stddev": 0.1},
     "<-": dict(_BW)},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "all2all_strict_relu", "->": {"output_sample_shape": 8},
     "<-": dict(_BW)},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "all2all_strict_relu", "->": {"output_sample_shape": 8},
     "<-": dict(_BW)},
    {"type": "softmax", "->": {"output_sample_shape": 5}, "<-": dict(_BW)},
]
ALEXNET_SHAPE = (19, 19, 3)
MCDNNIC = "1x8x8-3C3-MP2-5N"


def _batches(shape, classes, seed=0):
    rng = numpy.random.default_rng(seed)
    return [(rng.standard_normal((BATCH,) + shape).astype(numpy.float32),
             rng.integers(0, classes, BATCH).astype(numpy.int32))
            for _ in range(STEPS)]


def _cases():
    _shape, mc_layers = mcdnnic.parse_topology(
        MCDNNIC, {"<-": dict(_BW)})
    return {
        "alexnet": (ALEXNET_SMALL, ALEXNET_SHAPE, 5, {}),
        "alexnet_grad_accum": (ALEXNET_SMALL, ALEXNET_SHAPE, 5,
                               {"grad_accum": 2}),
        "mcdnnic": (mc_layers, (8, 8, 1), 5, {}),
        "alexnet_bf16": (ALEXNET_SMALL, ALEXNET_SHAPE, 5,
                         {"compute_dtype": "bfloat16"}),
    }


def _run_jax(layers, shape, classes, kwargs, seed=3):
    jax_prng.seed_all(seed)
    kwargs = dict(kwargs)
    if kwargs.get("compute_dtype") == "bfloat16":
        kwargs["compute_dtype"] = jnp.bfloat16
    params, step, eval_fn, apply_fn = jax_fused_graph.lower_specs(
        [dict(s) for s in layers], shape, **kwargs)
    step = jax.jit(step)
    metrics = []
    batches = _batches(shape, classes)
    for x, y in batches:
        params, m = step(params, x, y)
        metrics.append((float(m["loss"]), int(m["n_err"])))
    x, y = batches[0]
    return {"params": jax.tree.map(lambda v: None if v is None
                                   else numpy.asarray(v), params),
            "metrics": metrics,
            "eval": int(jax.jit(eval_fn)(params, x, y)["n_err"]),
            "apply": numpy.asarray(jax.jit(apply_fn)(params, x))}


def _run_port(layers, shape, classes, kwargs, seed=3):
    prng.seed_all(seed)
    params, step, eval_fn, apply_fn = fused_graph.lower_specs(
        [dict(s) for s in layers], shape, **kwargs)
    params = fused_graph.to_tensors(params, "cpu")
    metrics = []
    batches = _batches(shape, classes)
    for x, y in batches:
        params, m = step(params, torch.from_numpy(x), torch.from_numpy(y))
        metrics.append((float(m["loss"]), int(m["n_err"])))
    x, y = (torch.from_numpy(v) for v in batches[0])
    return {"params": fused_graph.to_numpy(params), "metrics": metrics,
            "eval": int(eval_fn(params, x, y)["n_err"]),
            "apply": apply_fn(params, x).detach().float().numpy()}


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _run_jax(*case) for name, case in _cases().items()}


def _max_gap(got, want):
    assert len(got) == len(want)
    gap = 0.0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if w[key] is None:
                assert g[key] is None, key
                continue
            if key in ("seed", "t", "tick"):
                assert numpy.array_equal(g[key], w[key]), key
                continue
            assert g[key].shape == w[key].shape, key
            gap = max(gap, float(numpy.abs(g[key] - w[key]).max()))
    return gap


@pytest.mark.parametrize("case", ["alexnet", "alexnet_grad_accum",
                                  "mcdnnic"])
def test_lowered_zoo_step_matches_jax(jax_runs, case):
    want = jax_runs[case]
    got = _run_port(*_cases()[case])
    for (gl, ge), (wl, we) in zip(got["metrics"], want["metrics"]):
        assert ge == we
        assert gl == pytest.approx(wl, abs=LOSS_TOL)
    assert _max_gap(got["params"], want["params"]) <= PARAM_TOL
    assert got["eval"] == want["eval"]
    assert numpy.abs(got["apply"] - want["apply"]).max() <= PARAM_TOL
    if case.startswith("alexnet"):
        # one seed a dropout stage, advanced once a step
        seeds = [s["seed"] for s in got["params"] if "seed" in s]
        assert len(seeds) == 2


def test_lowered_zoo_bf16_step_gap_to_jax(jax_runs):
    want = jax_runs["alexnet_bf16"]
    got = _run_port(*_cases()["alexnet_bf16"])
    assert _max_gap(got["params"], want["params"]) <= BF16_TOL
    for (gl, _ge), (wl, _we) in zip(got["metrics"], want["metrics"]):
        assert gl == pytest.approx(wl, abs=BF16_LOSS_TOL)


def test_alexnet_build_fused_steps_in_place_through_its_graph_step():
    """``alexnet.build_fused`` over the small stack on the CPU: its step
    (a ``GraphStep``; eager on the CPU) updates the parameter tensors in
    place, refuses another params list, and ``benchmark`` gives a
    rate; ``vgg.create_workflow`` trains a small stack."""
    from veles_tpu_torch.samples import alexnet, vgg
    prng.seed_all(3)
    params, step, eval_fn, _apply = alexnet.build_fused(
        layers=ALEXNET_SMALL, input_shape=ALEXNET_SHAPE, device="cpu")
    w0 = params[0]["w"]
    before = w0.clone()
    x, y = (torch.from_numpy(v) for v in _batches(ALEXNET_SHAPE, 5)[0])
    for _ in range(2):
        out, metrics = step(params, x, y)
        assert out is params and torch.isfinite(metrics["loss"])
    assert params[0]["w"] is w0 and not torch.equal(w0, before)
    assert step.report()["step_%d" % BATCH]["eager"] == 2
    assert int(eval_fn(params, x, y)["n"]) == BATCH
    with pytest.raises(ValueError, match="params"):
        step(fused_graph.to_tensors(fused_graph.to_numpy(params)), x, y)
    # the stand-in batches' labels are ImageNet's 1000 classes
    wide = ALEXNET_SMALL[:-1] + [
        {"type": "softmax", "->": {"output_sample_shape": 1000}}]
    assert alexnet.benchmark(batch=2, steps=1, layers=wide,
                             input_shape=ALEXNET_SHAPE, device="cpu") > 0
    # mesh= is ported: a one-process data mesh builds the same step
    from veles_tpu_torch.parallel.mesh import make_mesh
    assert len(vgg.build_fused(mesh=make_mesh({"data": -1}), layers=wide,
                               input_shape=ALEXNET_SHAPE,
                               device="cpu")[0]) == len(wide)
    wf = vgg.create_workflow(
        device="cpu", layers=[vgg._conv(4), vgg._pool(),
                              {"type": "dropout", "->": {}},
                              {"type": "softmax",
                               "->": {"output_sample_shape": 1000}}],
        n_samples=16, input_shape=(8, 8, 3), minibatch_size=4,
        max_epochs=2)
    wf.run()
    assert [type(f).__name__ for f in wf.forwards] == [
        "ConvStrictRELU", "MaxPooling", "DropoutForward", "All2AllSoftmax"]
