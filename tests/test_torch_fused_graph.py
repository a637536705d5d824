"""The fused lowering (``veles_tpu_torch.znicz.fused_graph`` and
``fused``) against the JAX package's, on the CPU.

Each case lowers the same specs in both packages from the same seed
(so the same initial weights), runs three steps on the same numpy
minibatch and compares every leaf of the state (weights, momenta,
solver slots, counters) within 1e-5 absolute (values O(1): a few f32
ulps of the sums' order, compounded over three steps) and the metrics
(``n_err`` equal, the loss within 1e-5).  The cases are the oracles of
the JAX package's own tests (``tests/test_fused_parallel.py``): each
solver (two a lowering, a layer each), the l1/ortho regularizers,
``grad_accum`` 1 and 4, ``remat``, an ``lr_adjuster`` of each policy
(for the weights or the bias), a u8 input with ``input_norm`` and a
padded short tail, and the MSE loss.  The
bf16 case (``compute_dtype``) holds its state within 2e-5 and its loss
within 1e-5: both packages compute the products of the same bf16
operands exactly in f32.  Measured on the CPU: the bf16 lowering is
2.9e-6 from JAX's in the state and 1.2e-7 in the loss, and fused.py's
bf16 step 1.5e-8 in the state, while the port's f32 lowering is 1.3e-4
(state) and 5.9e-4 (loss) from JAX's bf16 one, and fused.py's f32 step
2.2e-4; the bounds lie between the two.  The epoch runner is held
against JAX's ``epoch_runner(..., shuffle=False)`` (the threefry
permutation cannot be reproduced), and the MLP-specific step of
``fused.py`` against its JAX twin.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.znicz import fused as jax_fused
from veles_tpu.znicz import fused_graph as jax_graph
from veles_tpu_torch import prng
from veles_tpu_torch.znicz import fused, fused_graph

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

TOL = 1e-5
BF16_STATE_TOL = 2e-5
BF16_LOSS_TOL = 1e-5
STEPS = 3


def _layers(**bw):
    base = {"learning_rate": 0.05, "gradient_moment": 0.9,
            "weights_decay": 0.001}
    base.update(bw)
    return [{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
             "<-": dict(base)},
            {"type": "softmax", "->": {"output_sample_shape": 3},
             "<-": dict(base)}]


def _data(n=20, dim=12, classes=3, seed=0, u8=False, tail=0):
    rng = numpy.random.default_rng(seed)
    labels = (numpy.arange(n) % classes).astype(numpy.int32)
    if u8:
        x = rng.integers(0, 256, (n, dim)).astype(numpy.uint8)
    else:
        centers = rng.standard_normal((classes, dim)) * 2
        x = (centers[labels] + rng.standard_normal((n, dim))).astype(
            numpy.float32)
    if tail:
        x[-tail:] = 0
        labels[-tail:] = -1
    return x, labels


def _pair(first, second):
    """Two layers with their own backward groups (two solvers, two
    schedules, ... in one lowering: one JAX compile for both)."""
    one, two = _layers()
    one["<-"].update(first)
    two["<-"].update(second)
    return [one, two]


def _policy(name, **parameters):
    return {"lr_policy_name": name, "lr_parameters": parameters}


def _schedule(weights, bias):
    return dict(weights, bias_lr_policy_name=bias["lr_policy_name"],
                bias_lr_parameters=bias["lr_parameters"])


#: case -> (layers, lower_specs kwargs, data kwargs): the solvers two a
#: lowering (each layer its own), the regularizers on momentum, the
#: schedules as a weights policy and a bias policy
CASES = {
    "momentum_l1_ortho": (_pair({"l1_vs_l2": 0.7, "factor_ortho": 0.05},
                                {}), {}, {}),
    "adam_adagrad": (_pair({"solver": "adam", "learning_rate": 0.003},
                           {"solver": "adagrad"}), {}, {}),
    "adadelta_rprop": (_pair({"solver": "adadelta", "learning_rate": 1.0},
                             {"solver": "rprop",
                              "rprop_delta_init": 0.001}), {}, {}),
    "grad_accum_4": (_layers(), {"grad_accum": 4}, {}),
    "remat": (_layers(), {"remat": True}, {}),
    "u8_input_norm_short_tail": (
        _layers(), {"input_norm": (1.0 / 255.0, -0.5)},
        {"u8": True, "tail": 5}),
    "mse": ([{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
              "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
             {"type": "all2all", "->": {"output_sample_shape": 4},
              "<-": {"learning_rate": 0.05}}], {"loss": "mse"}, {}),
    "bf16": (_layers(), {"compute_dtype": "bfloat16",
                         "input_norm": (1.0 / 255.0, 0.0)}, {"u8": True}),
    "lr_fixed_exp": (_layers(), {"lr_adjuster": _schedule(
        _policy("fixed"), _policy("exp", gamma=0.9))}, {}),
    "lr_step_exp_inv": (_layers(), {"lr_adjuster": _schedule(
        _policy("step_exp", gamma=0.5, step=2),
        _policy("inv", gamma=0.3, power=0.75))}, {}),
    "lr_arbitrary_step": (_layers(), {"lr_adjuster": _policy(
        "arbitrary_step", lrs_with_lengths=[(1.0, 1), (0.5, 1),
                                            (0.1, 9)])}, {}),
}


def _targets(labels, n_out=4):
    rng = numpy.random.default_rng(1)
    return rng.standard_normal((len(labels), n_out)).astype(numpy.float32)


def _jax_kwargs(kwargs):
    out = dict(kwargs)
    if out.get("compute_dtype") == "bfloat16":
        out["compute_dtype"] = jnp.bfloat16
    return out


def _run_case(name):
    layers, kwargs, data_kwargs = CASES[name]
    x, labels = _data(**data_kwargs)
    if kwargs.get("loss") == "mse":
        labels = _targets(labels)
    jax_prng.seed_all(11)
    jparams, jstep, _je, _ja = jax_graph.lower_specs(
        layers, (12,), **_jax_kwargs(kwargs))
    jstep = jax.jit(jstep)
    prng.seed_all(11)
    tparams, tstep, _te, _ta = fused_graph.lower_specs(layers, (12,),
                                                       **kwargs)
    tparams = fused_graph.to_tensors(tparams)
    jm = tm = None
    for _ in range(STEPS):
        jparams, jm = jstep(jparams, x, labels)
        tparams, tm = tstep(tparams, torch.tensor(x), torch.tensor(labels))
    return jparams, jm, tparams, tm


@pytest.fixture(scope="module")
def results():
    """Every case run once in both packages (JAX's side once a module)."""
    return {name: _run_case(name) for name in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lower_specs_step_matches_jax(results, case):
    jparams, jm, tparams, tm = results[case]
    bf16 = case == "bf16"
    state_tol = BF16_STATE_TOL if bf16 else TOL
    loss_tol = BF16_LOSS_TOL if bf16 else TOL
    assert len(jparams) == len(tparams)
    for jstate, tstate in zip(jparams, tparams):
        assert sorted(k for k, v in jstate.items() if v is not None) == \
            sorted(k for k, v in tstate.items() if v is not None)
        for key, value in jstate.items():
            if value is None:
                continue
            got = tstate[key].float().numpy()
            want = numpy.asarray(value, numpy.float32)
            assert got.shape == want.shape, key
            assert numpy.abs(got - want).max() <= state_tol, (key, numpy.abs(
                got - want).max())
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= loss_tol
    if CASES[case][1].get("loss") == "mse":
        assert abs(float(tm["n_err"]) - float(jm["n_err"])) <= TOL
    else:
        assert int(tm["n_err"]) == int(jm["n_err"])


def test_the_tick_and_adam_counter_advance_once_a_step(results):
    _jp, _jm, tparams, _tm = results["lr_fixed_exp"]
    assert [int(s["tick"]) for s in tparams] == [STEPS, STEPS]
    _jp, _jm, tparams, _tm = results["adam_adagrad"]
    assert int(tparams[0]["t"]) == STEPS and "t" not in tparams[1]


@pytest.mark.parametrize("call", [
    lambda reduce: fused_graph.lower_specs(_layers(), (12,),
                                           grad_reduce_axis=reduce),
    # the recurrent types lower since the rest of 7(c), and their
    # explicit-collective reduction since 7(d)
    lambda reduce: fused_graph.lower_specs(
        [{"type": "lstm", "->": {"hidden_units": 4, "last_only": True}},
         {"type": "softmax", "->": {"output_sample_shape": 3}}], (6, 3),
        grad_reduce_axis=reduce),
])
def test_what_the_lowering_leaves_out_names_its_item(call):
    """``grad_reduce_axis``, once refused naming 7(d), is ported: in one
    process (no process group) the axis holds this process alone and
    the reduced step is the plain step bit for bit; the ranks' reduction
    is ``tests/test_torch_parallel.py``'s.  A 2-rank axis without a
    process group raises."""
    states = []
    for reduce in (None, "data"):
        prng.seed_all(4)
        params, step, _e, _a = call(reduce)
        shape = (12,) if params[0]["w"].shape[0] == 12 else (6, 3)
        rng = numpy.random.default_rng(1)
        x = torch.tensor(rng.standard_normal((6,) + shape), dtype=torch.float32)
        y = torch.tensor(numpy.arange(6) % 3, dtype=torch.int32)
        params = fused_graph.to_tensors(params)
        for _ in range(2):
            params, metrics = step(params, x, y)
        states.append((fused_graph.to_numpy(params), float(metrics["loss"])))
    assert states[0][1] == states[1][1]
    for a, b in zip(states[0][0], states[1][0]):
        for key in a:
            if a[key] is not None:
                numpy.testing.assert_array_equal(a[key], b[key])
    from veles_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match="initialize"):
        fused_graph.lower_specs(_layers(), (12,), grad_reduce_axis="data",
                                mesh=Mesh({"data": 2}, world_size=2))


def test_rprop_refuses_a_schedule_and_solvers_are_checked():
    with pytest.raises(ValueError, match="rprop"):
        fused_graph.lower_specs(_layers(solver="rprop"), (12,),
                                lr_adjuster=_policy("exp"))
    with pytest.raises(ValueError, match="unknown solver"):
        fused_graph.lower_specs(_layers(solver="sgdfast"), (12,))


@pytest.mark.parametrize("u8", [False, True])
def test_epoch_runner_matches_jax_unshuffled(u8):
    layers = _layers()
    norm = (1.0 / 255.0, 0.0) if u8 else None
    x, labels = _data(n=70, u8=u8)
    jax_prng.seed_all(2)
    jparams, jstep, _e, _a = jax_graph.lower_specs(layers, (12,),
                                                   input_norm=norm)
    prng.seed_all(2)
    tparams, tstep, _e2, _a2 = fused_graph.lower_specs(layers, (12,),
                                                       input_norm=norm)
    jepoch = jax_graph.epoch_runner(jstep, 70, 20, shuffle=False)
    jparams, jstacked = jepoch(jparams, jnp.asarray(x), jnp.asarray(labels),
                               jax.random.key(0))
    tepoch = fused_graph.epoch_runner(tstep, 70, 20, shuffle=False)
    tparams, tstacked = tepoch(fused_graph.to_tensors(tparams),
                               torch.tensor(x), torch.tensor(labels))
    # 70 // 20: three steps, the short tail dropped
    assert tstacked["n_err"].shape == (3,)
    numpy.testing.assert_array_equal(tstacked["n_err"].numpy(),
                                     numpy.asarray(jstacked["n_err"]))
    numpy.testing.assert_allclose(tstacked["loss"].numpy(),
                                  numpy.asarray(jstacked["loss"]),
                                  atol=TOL)
    for jstate, tstate in zip(jparams, tparams):
        for key in ("w", "b", "vw", "vb"):
            assert numpy.abs(tstate[key].numpy()
                             - numpy.asarray(jstate[key])).max() <= TOL


def test_epoch_indices_follow_the_generator():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = fused_graph.epoch_indices(70, 20, g1)
    b = fused_graph.epoch_indices(70, 20, g2)
    assert a.dtype == torch.int32 and tuple(a.shape) == (3, 20)
    assert torch.equal(a, b)
    assert len(set(a.flatten().tolist())) == 60


MLP_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 3},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
]


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_mlp_step_of_fused_py_matches_jax(compute_dtype):
    jax_prng.seed_all(9)
    jparams = jax_fused.init_mlp_params(12, MLP_LAYERS)
    prng.seed_all(9)
    tparams = fused.init_mlp_params(12, MLP_LAYERS)
    for j, t in zip(jparams, tparams):
        numpy.testing.assert_array_equal(j["w"], t["w"].numpy())
    x, labels = _data(n=15, tail=3)
    jdt = None if compute_dtype is None else jnp.bfloat16
    tdt = None if compute_dtype is None else torch.bfloat16
    jstep = jax.jit(jax_fused.make_train_step(MLP_LAYERS, compute_dtype=jdt))
    tstep = fused.make_train_step(MLP_LAYERS, compute_dtype=tdt)
    for _ in range(STEPS):
        jparams, jm = jstep(jparams, x, labels)
        tparams, tm = tstep(tparams, torch.tensor(x), torch.tensor(labels))
    tol = TOL if compute_dtype is None else BF16_STATE_TOL
    for j, t in zip(jparams, tparams):
        for key in ("w", "b", "vw", "vb"):
            assert numpy.abs(t[key].numpy() - numpy.asarray(
                j[key], numpy.float32)).max() <= tol
    assert int(tm["n_err"]) == int(jm["n_err"])
    jev = jax_fused.make_eval_step(MLP_LAYERS, compute_dtype=jdt)(
        jparams, x, labels)
    tev = fused.make_eval_step(MLP_LAYERS, compute_dtype=tdt)(
        tparams, torch.tensor(x), torch.tensor(labels))
    assert int(tev["n_err"]) == int(jev["n_err"])
    assert int(tev["n"]) == int(jev["n"]) == 12
