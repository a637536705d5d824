"""The layer zoo's units (conv, pooling, LRN, dropout, the activations
and the misc units) and their VJP backward units against the JAX
package, on the CPU, over inputs drawn from a seed with numpy.

- Forwards: each port ``pure_fn`` against the JAX ``pure`` with the same
  config, at ``FWD_TOL`` max abs (measured: at most 1.3e-6 for the s2d
  conv at stride 3, the rest 1e-6 or below: sums in another order; the
  max, maxabs and stochastic poolings, the dropout mask, the cutter and
  the splitter are bit-equal, asserted with 0).
- Pooling with planted ties (whole zero windows, as after a strict relu,
  and repeated maxima): the outputs, the choices (``store_offsets``,
  then depooled) and the VJPs equal, the gradient going to the first
  maximal element of a window in both.
- Threefry: :func:`veles_tpu_torch.ops.random.threefry_bits` /
  ``threefry_uniform`` / ``threefry_bernoulli`` equal ``jax.random``'s
  bits, uniforms and Bernoulli draws of ``jax.random.key(s)`` for
  several seeds and odd shapes, exactly.
- Backward units: each GD unit's step run by the port unit (``run()`` on
  a ``CPUDevice``, twice where there are momenta) against the JAX unit's
  ``compute`` fed the same parameters, momenta, input and error: the
  parameters, the momenta and ``err_input`` within ``GD_TOL`` (measured
  at most 6e-8 on the parameters, 4e-7 on err_input), with weight decay,
  ``l1_vs_l2`` and ``factor_ortho``; ``GDRProp`` over ``rprop_all2all``
  likewise.
- The ledger's cost of a conv: a ``Tally`` around one conv forward gives
  ``2·B·OH·OW·K·ky·kx·C/g`` (plus the bias and the activation an output),
  and around one VJP the forward's plus its two transposed products.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
from veles_tpu.memory import Vector as JaxVector
from veles_tpu.units import UnitRegistry as JaxRegistry
from veles_tpu.znicz import (  # noqa: F401 - the JAX registry
    activation as jax_activation, conv as jax_conv, gd_base as jax_gd_base,
    misc_units as jax_misc, normalization_units as jax_norm,
    pooling as jax_pooling)
from veles_tpu_torch.backends import CPUDevice
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.ops import cost
from veles_tpu_torch.ops.random import (threefry_bernoulli, threefry_bits,
                                        threefry_uniform)
from veles_tpu_torch.units import UnitRegistry
from veles_tpu_torch.znicz import (  # noqa: F401 - the port registry
    activation, conv, gd_base, misc_units, normalization_units, pooling)

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

FWD_TOL = 2e-6
GD_TOL = 1e-6


def _rng(seed=0):
    return numpy.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(numpy.array(a))


def _port_pure(klass, params, x, config):
    return klass.pure_fn({k: _t(v) for k, v in params.items()}, _t(x),
                         **config).numpy()


def _jax_pure(klass, params, x, config):
    return numpy.asarray(klass.pure(params, x, **config))


# -- forwards -------------------------------------------------------------------

_X = _rng(1).standard_normal((2, 9, 11, 4)).astype(numpy.float32)

#: name -> (padding, sliding, grouping, s2d, activation)
_CONV_CASES = {
    "plain": ((0, 0, 0, 0), (1, 1), 1, False, None),
    "asym_pad_stride": ((1, 2, 0, 1), (2, 1), 1, False, "strict_relu"),
    "grouped": ((1, 1, 1, 1), (2, 2), 2, False, "tanh"),
    "s2d_stride2": ((2, 1, 1, 2), (2, 2), 1, True, "sigmoid"),
    "s2d_stride3": ((0, 0, 0, 0), (3, 3), 1, True, "relu"),
    "no_s2d_stride2": ((2, 1, 1, 2), (2, 2), 1, False, "sigmoid"),
}


@pytest.mark.parametrize("case", sorted(_CONV_CASES))
def test_conv_forward_matches_jax(case):
    padding, sliding, groups, s2d, activation = _CONV_CASES[case]
    rng = _rng(2)
    params = {"w": rng.standard_normal((3, 3, 4 // groups, 6)).astype(
        numpy.float32), "b": rng.standard_normal(6).astype(numpy.float32)}
    config = dict(padding=padding, sliding=sliding, activation=activation,
                  s2d=s2d, grouping=groups)
    want = _jax_pure(jax_conv.Conv, params, _X, config)
    got = _port_pure(conv.Conv, params, _X, config)
    assert got.shape == want.shape
    assert numpy.abs(got - want).max() <= FWD_TOL


_WINDOWS = [(2, 2, (2, 2)), (3, 2, (2, 3)), (3, 3, (2, 2))]
_SEEDS = (0, 11, 12345, 2 ** 31 - 1)
_KEEPS = (0.5, 0.7)


@pytest.fixture(scope="module")
def jax_random_refs():
    """Every JAX reference that draws from ``jax.random`` (stochastic
    pooling, pool-depool, the dropout masks) in ONE jitted program, run
    for each seed: a random draw takes about half a second to compile on
    the CPU."""
    def draws(seed, x, tied):
        p = {"seed": seed}
        out = {}
        for kind in ("stochastic", "stochasticabs"):
            # the overlapping 3×3 windows (the other geometries are the
            # pool-depool's and the offsets')
            out["pool", kind] = jax_pooling.PoolingBase.pure(
                p, x, kx=3, ky=3, sliding=(2, 2), kind=kind)
            out["offsets", kind] = jax_pooling.PoolingBase.pure_with_offsets(
                p, tied, kx=2, ky=2, sliding=(2, 2), kind=kind)
            out["depool", kind] = jax_pooling._PoolDepoolBase.pure(
                p, x, kx=2, ky=2, sliding=(2, 2), kind=kind)
        for keep in _KEEPS:
            out["dropout", keep] = jax_norm.DropoutForward.pure(p, x,
                                                                keep=keep)
        return out

    program = jax.jit(draws)        # compiled once, the seed traced
    tied = _tied(5)
    refs = {}
    for seed in _SEEDS:
        for key, value in program(jnp.int32(seed), _X, tied).items():
            refs[key + (seed,)] = jax.tree.map(numpy.asarray, value)
    return refs


@pytest.mark.parametrize("kind", ["stochastic", "stochasticabs"])
@pytest.mark.parametrize("seed", _SEEDS)
def test_stochastic_pooling_matches_jax(kind, seed, jax_random_refs):
    config = dict(kx=3, ky=3, sliding=(2, 2), kind=kind)
    got = _port_pure(pooling.PoolingBase, {"seed": numpy.int32(seed)}, _X,
                     config)
    assert numpy.array_equal(got, jax_random_refs["pool", kind, seed])


@pytest.mark.parametrize("kind", ["max", "maxabs", "avg"])
@pytest.mark.parametrize("window", range(len(_WINDOWS)))
def test_pooling_forward_matches_jax(kind, window):
    kx, ky, sliding = _WINDOWS[window]
    config = dict(kx=kx, ky=ky, sliding=sliding, kind=kind)
    want = _jax_pure(jax_pooling.PoolingBase, {}, _X, config)
    got = _port_pure(pooling.PoolingBase, {}, _X, config)
    assert got.shape == want.shape
    tol = FWD_TOL if kind == "avg" else 0.0
    assert numpy.abs(got - want).max() <= tol


def _tied(seed=3):
    """Strict-relu-like activations: whole zero windows and windows whose
    maximum (or |x| maximum) repeats."""
    rng = _rng(seed)
    x = numpy.maximum(rng.standard_normal((2, 8, 8, 3)), 0.0).astype(
        numpy.float32)
    x[:, 0:2, 0:2, :] = 0.0                      # a whole zero window
    x[:, 2:4, 2:4, 0] = 1.5                      # a repeated maximum
    x[:, 4, 4, 1], x[:, 5, 5, 1] = 2.0, -2.0     # tied by magnitude
    x[:, 4, 5, 1] = x[:, 5, 4, 1] = 0.5
    return x


@pytest.mark.parametrize("kind", ["max", "maxabs"])
@pytest.mark.parametrize("sliding", [(2, 2), (1, 1)])
def test_pooling_ties_give_the_first_element_its_gradient(kind, sliding):
    x = _tied()
    config = dict(kx=2, ky=2, sliding=sliding, kind=kind)
    out_j, vjp = jax.vjp(
        lambda v: jax_pooling.PoolingBase.pure({}, v, **config), x)
    cot = _rng(4).standard_normal(out_j.shape).astype(numpy.float32)
    dx_j = numpy.asarray(vjp(jnp.asarray(cot))[0])
    xt = _t(x).requires_grad_(True)
    out_t = pooling.PoolingBase.pure_fn({}, xt, **config)
    out_t.backward(_t(cot))
    assert numpy.array_equal(out_t.detach().numpy(), numpy.asarray(out_j))
    assert numpy.abs(xt.grad.numpy() - dx_j).max() <= FWD_TOL
    # the all-zero window sends its whole gradient to its first element
    if sliding == (2, 2) and kind == "max":
        assert numpy.all(xt.grad.numpy()[:, 0, 0, :] == cot[:, 0, 0, :])
        assert numpy.all(xt.grad.numpy()[:, 0:2, 0:2, :].sum(axis=(1, 2))
                         == cot[:, 0, 0, :])


@pytest.mark.parametrize("kind", ["max", "maxabs", "stochastic",
                                  "stochasticabs"])
def test_store_offsets_through_depooling_matches_jax(kind, jax_random_refs):
    x = _tied(5)
    config = dict(kx=2, ky=2, sliding=(2, 2), kind=kind)
    seed = _SEEDS[1]
    if kind.startswith("stochastic"):
        out_j, offs_j = jax_random_refs["offsets", kind, seed]
    else:
        out_j, offs_j = jax_pooling.PoolingBase.pure_with_offsets(
            {}, x, **config)
    out_t, offs_t = pooling.PoolingBase.pure_with_offsets(
        {"seed": torch.tensor(seed, dtype=torch.int32)}, _t(x), **config)
    assert numpy.array_equal(offs_t.numpy(), numpy.asarray(offs_j))
    assert numpy.array_equal(out_t.numpy(), numpy.asarray(out_j))
    dep = dict(kx=2, ky=2)
    want = _jax_pure(jax_pooling.Depooling, {"offsets": offs_j}, out_j, dep)
    got = _port_pure(pooling.Depooling, {"offsets": offs_t.numpy()},
                     out_t.numpy(), dep)
    assert numpy.array_equal(got, want)


@pytest.mark.parametrize("kind", ["stochastic", "stochasticabs"])
@pytest.mark.parametrize("seed", _SEEDS)
def test_pool_depool_matches_jax(kind, seed, jax_random_refs):
    config = dict(kx=2, ky=2, sliding=(2, 2), kind=kind)
    got = _port_pure(pooling._PoolDepoolBase, {"seed": numpy.int32(seed)},
                     _X, config)
    assert numpy.array_equal(got, jax_random_refs["depool", kind, seed])


@pytest.mark.parametrize("beta", [0.75, 0.6])
@pytest.mark.parametrize("n", [5, 4])
def test_lrn_forward_matches_jax(beta, n):
    # a large alpha so that the window term matters
    config = dict(alpha=0.05, beta=beta, k=2.0, n=n)
    want = _jax_pure(jax_norm.LRNormalizerForward, {}, _X, config)
    got = _port_pure(normalization_units.LRNormalizerForward, {}, _X,
                     config)
    assert numpy.abs(got - want).max() <= FWD_TOL


@pytest.mark.parametrize("keep", _KEEPS)
@pytest.mark.parametrize("seed", _SEEDS)
def test_dropout_mask_matches_jax(keep, seed, jax_random_refs):
    got = _port_pure(normalization_units.DropoutForward,
                     {"seed": numpy.int32(seed)}, _X, {"keep": keep})
    assert numpy.array_equal(got, jax_random_refs["dropout", keep, seed])


@pytest.mark.parametrize("func", ["tanh", "sigmoid", "relu", "strict_relu",
                                  "log", "tanhlog", "sincos", "mul"])
def test_activations_match_jax(func):
    config = {"func": func, "k": 1.5}
    want = _jax_pure(jax_activation.ActivationForward, {}, _X, config)
    got = _port_pure(activation.ActivationForward, {}, _X, config)
    assert numpy.abs(got - want).max() <= FWD_TOL


@pytest.mark.parametrize("padding,sliding", [
    ((1, 1, 1, 1), (1, 1)), ((0, 0, 0, 0), (2, 2)), ((1, 0, 2, 1), (2, 1))])
def test_deconv_matches_jax(padding, sliding):
    params = {"w": _rng(6).standard_normal((3, 3, 2, 4)).astype(
        numpy.float32)}
    config = dict(padding=padding, sliding=sliding, activation="sigmoid")
    want = _jax_pure(jax_misc.Deconv, params, _X, config)
    got = _port_pure(misc_units.Deconv, params, _X, config)
    assert got.shape == want.shape
    assert numpy.abs(got - want).max() <= FWD_TOL


def test_cutter_and_splitter_match_jax():
    for klass_j, klass_t, config in (
            (jax_misc.Cutter, misc_units.Cutter, {"window": (1, 2, 5, 4)}),
            (jax_misc.ChannelSplitter, misc_units.ChannelSplitter,
             {"start": 1, "count": 2}),
            (jax_misc.ChannelSplitter, misc_units.ChannelSplitter,
             {"start": 3, "count": None})):
        assert numpy.array_equal(_port_pure(klass_t, {}, _X, config),
                                 _jax_pure(klass_j, {}, _X, config))


def _units(package):
    """(workflow, registry, device, Vector) of one package."""
    if package == "jax":
        return JaxDummyWorkflow(), JaxRegistry.mapped, None, JaxVector
    return DummyWorkflow(), UnitRegistry.mapped, CPUDevice(), Vector


def test_merger_zero_filler_and_resizable_all2all_match_jax():
    got = {}
    for package in ("jax", "port"):
        wf, reg, device, vec = _units(package)
        a = reg["channel_splitter"](wf, start=0, count=1)
        b = reg["channel_splitter"](wf, start=2)
        for unit in (a, b):
            unit.input = vec(_X.copy())
            unit.initialize(device=device)
            unit.run()
        merger = reg["channel_merger"](wf).link_inputs(a, "output", b,
                                                       "output")
        merger.initialize(device=device)
        merger.run()
        merger.output.map_read()
        fc = reg["resizable_all2all"](wf, output_sample_shape=5)
        fc.input = vec(_X.reshape(2, -1).copy())
        fc.weights.reset(_rng(7).standard_normal((396, 5)).astype(
            numpy.float32))
        fc.initialize(device=device)
        fc.resize(3)
        filler = reg["zero_filter"](wf, mask=numpy.array(
            [1.0, 0.0, 1.0], numpy.float32))
        filler.target_unit = fc
        filler.run()
        fc.weights.map_read()
        got[package] = (numpy.array(merger.output.mem),
                        numpy.array(fc.weights.mem))
    for a, b in zip(got["jax"], got["port"]):
        assert numpy.array_equal(a, b)
    assert got["port"][0].shape == (2, 9, 11, 3)
    assert numpy.all(got["port"][1][:, 1] == 0)


# -- threefry -------------------------------------------------------------------

_TF_SEEDS = (0, 5, 123456789, 2 ** 31 - 1)
_TF_SHAPES = ((3,), (5, 7), (2, 3, 4, 1, 5), (1,))


@pytest.fixture(scope="module")
def jax_threefry_refs():
    """``jax.random`` bits, uniforms and Bernoulli draws of every seed
    and shape, one jitted program run for each seed."""
    def draws(seed):
        # the bits of every shape; the uniform and the Bernoulli mappings
        # (which draw the same bits) of one odd shape
        key = jax.random.key(seed)
        odd = _TF_SHAPES[2]
        return ({shape: jax.random.bits(key, shape)
                 for shape in _TF_SHAPES},
                (jax.random.uniform(key, odd),
                 jax.random.bernoulli(key, 0.5, odd),
                 jax.random.bernoulli(key, 0.7, odd)))

    program = jax.jit(draws)        # compiled once, the seed traced
    refs = {}
    for seed in _TF_SEEDS:
        bits, rest = jax.tree.map(numpy.asarray,
                                  program(jnp.uint32(seed)))
        refs[seed] = (bits,) + tuple(rest)
    return refs


@pytest.mark.parametrize("seed", _TF_SEEDS)
@pytest.mark.parametrize("shape", _TF_SHAPES)
def test_threefry_equals_jax_random(seed, shape, jax_threefry_refs):
    bits, uniform, half, seven = jax_threefry_refs[seed]
    assert numpy.array_equal(threefry_bits(seed, shape).numpy(),
                             bits[shape].astype(numpy.int64))
    if shape != _TF_SHAPES[2]:
        return
    assert numpy.array_equal(threefry_uniform(seed, shape).numpy(), uniform)
    for p, want in ((0.5, half), (0.7, seven)):
        assert numpy.array_equal(
            threefry_bernoulli(torch.tensor(seed, dtype=torch.int32), p,
                               shape).numpy(), want)


# -- backward units -------------------------------------------------------------

_BW = {"learning_rate": 0.05, "learning_rate_bias": 0.03,
       "gradient_moment": 0.9, "gradient_moment_bias": 0.8,
       "weights_decay": 0.01, "weights_decay_bias": 0.002}

#: name -> (forward type, forward kwargs, GD type, GD kwargs, input shape,
#: extra params)
_GD_CASES = {
    "conv_l1_ortho": ("conv_strict_relu", {"n_kernels": 4, "kx": 3, "ky": 3,
                                           "padding": (1, 0, 1, 2),
                                           "sliding": (2, 1)},
                      "gd_conv_strict_relu",
                      dict(_BW, l1_vs_l2=0.3, factor_ortho=0.01),
                      (3, 8, 7, 2), None),
    "conv_grouped_tanh": ("conv_tanh", {"n_kernels": 4, "kx": 3, "ky": 3,
                                        "grouping": 2, "padding": 1},
                          "gd_conv_tanh", dict(_BW), (3, 6, 6, 4), None),
    "conv_s2d": ("conv_sigmoid", {"n_kernels": 3, "kx": 4, "ky": 4,
                                  "sliding": (2, 2)}, "gd_conv_sigmoid",
                 dict(_BW), (2, 10, 10, 2), None),
    "max_pool_ties": ("max_pooling", {"kx": 2, "ky": 2}, "gd_max_pooling",
                      {}, None, None),
    "avg_pool": ("avg_pooling", {"kx": 3, "ky": 3, "sliding": (2, 2)},
                 "gd_avg_pooling", {}, (2, 9, 9, 3), None),
    "stochastic_pool": ("stochastic_pooling", {"kx": 2, "ky": 2},
                        "gd_stochastic_pooling", {}, (2, 6, 6, 3),
                        {"seed": 4242}),
    "pool_depool": ("stochastic_abs_pool_depool", {"kx": 2, "ky": 2},
                    "gd_stochastic_pooling", {}, (2, 6, 6, 3),
                    {"seed": 77}),
    "lrn": ("lrn", {"alpha": 0.05, "n": 3}, "gd_lrn", {}, (2, 4, 4, 6),
            None),
    "dropout": ("dropout", {"dropout_ratio": 0.4}, "gd_dropout", {},
                (4, 10), {"seed": 31337}),
    "deconv": ("deconv", {"n_kernels": 3, "kx": 3, "ky": 3, "padding": 1,
                          "sliding": (2, 2), "output_channels": 2},
               "gd_deconv", dict(_BW, l1_vs_l2=1.0), (2, 4, 4, 3), None),
    "activation_sincos": ("activation_sincos", {}, "gd_activation", {},
                          (3, 6), None),
    "cutter": ("cutter", {"window": (1, 1, 3, 2)}, "gd_cutter", {},
               (2, 5, 5, 2), None),
    "splitter": ("channel_splitter", {"start": 1, "count": 2},
                 "gd_generic", {}, (2, 3, 3, 4), None),
    "rprop": ("rprop_all2all", {"output_sample_shape": 5}, "gd_rprop",
              {"weights_decay": 0.01, "l1_vs_l2": 0.5,
               "rprop_delta_init": 0.05}, (6, 7), None),
}


@pytest.mark.parametrize("case", sorted(_GD_CASES))
def test_gd_unit_step_matches_jax(case):
    ftype, fkw, gtype, gkw, shape, extra = _GD_CASES[case]
    rng = _rng(8)
    x = _tied(9) if shape is None else rng.standard_normal(shape).astype(
        numpy.float32)
    # the JAX forward, initialized on the host: its weights are the ones
    # both packages start from
    jwf = JaxDummyWorkflow()
    jfwd = JaxRegistry.mapped[ftype](jwf, **fkw)
    jfwd.input = JaxVector(x.copy())
    jfwd.initialize(device=None)
    if extra:
        jfwd._last_seed = extra["seed"]
    wf = DummyWorkflow()
    tfwd = UnitRegistry.mapped[ftype](wf, **fkw)
    tfwd.input = Vector(x.copy())
    if jfwd.weights:
        tfwd.weights.reset(numpy.array(jfwd.weights.mem))
        if jfwd.include_bias and jfwd.bias:
            tfwd.bias.reset(numpy.array(jfwd.bias.mem))
    tfwd.initialize(device=CPUDevice())
    if extra:
        tfwd._last_seed = extra["seed"]
    tgd = UnitRegistry.mapped[gtype](wf, **gkw)
    tgd.setup_from_forward(tfwd)
    tgd.err_output = Vector(numpy.zeros(jfwd.output.shape, numpy.float32))
    tgd.initialize(device=CPUDevice())
    jgd = JaxRegistry.mapped[gtype](jwf, **gkw)
    jgd.setup_from_forward(jfwd)
    compute = jax.jit(jgd._step_fn())
    params = {k: numpy.array(v) for k, v in
              jfwd.pure_params(host=True).items()}
    vstate = {}
    if gtype == "gd_rprop":
        for key in ("w", "b"):
            vstate[key] = numpy.zeros((2,) + params[key].shape,
                                      numpy.float32)
            vstate[key][0] = gkw["rprop_delta_init"]
    else:
        vstate = {k: numpy.zeros_like(v) for k, v in params.items()
                  if k in ("w", "b")}
    # two steps where there are momenta to carry, else one
    for step in range(2 if vstate else 1):
        err = rng.standard_normal(jfwd.output.shape).astype(numpy.float32)
        tgd.err_output.reset(err.copy())
        new_p, new_v, dx = compute(params, vstate, jnp.asarray(x),
                                   jnp.asarray(err), jgd._hyper())
        params = dict(params, **{k: numpy.asarray(v)
                                 for k, v in new_p.items()})
        vstate = {k: numpy.asarray(v) for k, v in new_v.items()}
        dx = numpy.asarray(dx)
        tgd.run()
        tgd.err_input.map_read()
        assert numpy.abs(tgd.err_input.mem - dx).max() <= GD_TOL, step
        for key, vec, mom in (("w", tfwd.weights, tgd.gradient_weights),
                              ("b", tfwd.bias, tgd.gradient_bias)):
            if key not in vstate:
                continue
            vec.map_read()
            mom.map_read()
            assert numpy.abs(vec.mem - params[key]).max() <= GD_TOL, key
            assert numpy.abs(mom.mem - vstate[key]).max() <= GD_TOL, key


def test_a_conv_step_tallies_the_formula():
    x = _t(_X)
    w = _t(_rng(10).standard_normal((3, 3, 2, 6)).astype(numpy.float32))
    b = torch.zeros(6)
    config = dict(padding=(1, 1, 0, 0), sliding=(2, 1), grouping=2,
                  activation="tanh", s2d=False)
    with cost.Tally() as fwd:
        out = conv.Conv.pure_fn({"w": w, "b": b}, x, **config)
    batch, oh, ow, k = out.shape
    macs = batch * oh * ow * k * 3 * 3 * 2
    assert fwd.flops == 2 * macs + batch * oh * ow * k * (
        1 + cost.EPILOGUE_FLOPS["tanh"])
    assert fwd.bytes == 4 * (x.numel() + w.numel() + b.numel() + out.numel())
    # the VJP's two transposed products on top of the recomputed forward
    with cost.Tally() as step:
        gd_base.vjp(conv.Conv.pure_fn, config, {"w": w, "b": b}, x,
                    torch.ones(out.shape))
    assert step.flops == fwd.flops + 2 * (2 * macs)
