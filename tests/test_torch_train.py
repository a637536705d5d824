"""The port's transformer training step (``veles_tpu_torch.samples
.transformer``) against the JAX package's, on the CPU at TINY width.

Both packages start from the same ``init_params(seed)`` (bit-identical
numpy trees) and take three float32 steps on the same
``synthetic_tokens``: the losses of every step, the params and the
velocity after three steps must agree within atol 1e-5, rtol 1e-5.  The
velocity is compared divided by ``lr`` (it is ``-lr`` times a running
gradient sum, about 1e-4 in size, so an absolute 1e-5 on it would say
nothing).  On the CPU ``flash_attention`` takes its plain versions, so
no kernel is launched; the card runs the same step through the kernels
in ``chip_smoke.py`` (``train``, ``train_parity``).
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.samples import transformer as jax_transformer
from veles_tpu_torch.gen.model import params_to_numpy
from veles_tpu_torch.ops import attention
from veles_tpu_torch.samples import transformer as port
from veles_tpu_torch.samples.transformer import TINY

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

ATOL = RTOL = 1e-5
LR = 3e-4
STEPS = 3


def _leaves(tree, prefix=""):
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf, prefix + key + ".")
        else:
            yield prefix + key, numpy.asarray(leaf)


def _close_trees(got, want, scale=1.0):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert got[name].shape == leaf.shape, name
        numpy.testing.assert_allclose(got[name] / scale, leaf / scale,
                                      atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("ce_chunk", [0, 4])     # 4 does not divide S-1 = 15
def test_train_steps_match_jax(remat, ce_chunk):
    tokens = port.synthetic_tokens(TINY, 4, seed=1)
    step = jax.jit(jax_transformer.make_train_step(
        TINY, lr=LR, compute_dtype=jnp.float32, remat=remat,
        ce_chunk=ce_chunk))
    params = jax_transformer.init_params(TINY, seed=3)
    velocity = jax.tree.map(numpy.zeros_like, params)

    attention.reset_launches()
    p, v, port_step = port.build_train(
        TINY, lr=LR, compute_dtype=torch.float32, remat=remat, seed=3,
        ce_chunk=ce_chunk, device="cpu")
    for _ in range(STEPS):
        params, velocity, metrics = step(params, velocity, tokens)
        p2, v2, port_metrics = port_step(p, v, tokens)
        assert p2 is p and v2 is v          # updated in place
        assert port_metrics["loss"].dtype == torch.float32
        assert float(port_metrics["loss"]) == pytest.approx(
            float(metrics["loss"]), rel=RTOL, abs=ATOL)
    _close_trees(params_to_numpy(p), params)
    _close_trees(params_to_numpy(v), velocity, scale=LR)
    assert not any(attention.launches.values())


def test_zeroed_dq_fails_the_velocity_check(monkeypatch):
    """The comparison reads the gradients: an attention backward whose dq
    is zeroed gives a velocity outside the tolerance after one step."""
    flash_bwd = attention._flash_bwd

    def zero_dq(*args, **kwargs):
        dq, dk, dv = flash_bwd(*args, **kwargs)
        return torch.zeros_like(dq), dk, dv

    monkeypatch.setattr(attention, "_flash_bwd", zero_dq)
    tokens = port.synthetic_tokens(TINY, 4, seed=1)
    step = jax.jit(jax_transformer.make_train_step(
        TINY, lr=LR, compute_dtype=jnp.float32, remat=False, ce_chunk=0))
    params = jax_transformer.init_params(TINY, seed=3)
    _p, velocity, _m = step(params, jax.tree.map(numpy.zeros_like, params),
                            tokens)
    p, v, port_step = port.build_train(
        TINY, lr=LR, compute_dtype=torch.float32, remat=False, seed=3,
        ce_chunk=0, device="cpu")
    port_step(p, v, tokens)
    with pytest.raises(AssertionError):
        _close_trees(params_to_numpy(v), velocity, scale=LR)


def test_chunked_ce_matches_full_logits_in_the_port():
    """The two loss paths are one function of the params: the same loss
    and the same update, with a chunk that pads (15 = 3·4 + 3)."""
    tokens = port.synthetic_tokens(TINY, 2, seed=4)
    out = []
    for ce_chunk in (0, 4):
        p, v, step = port.build_train(TINY, compute_dtype=torch.float32,
                                      seed=5, ce_chunk=ce_chunk,
                                      device="cpu")
        out.append((float(step(p, v, tokens)[2]["loss"]),
                    params_to_numpy(p)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    _close_trees(out[1][1], out[0][1])


def test_bf16_train_step_runs_on_the_cpu():
    """The default compute dtype (bf16 matmuls, f32 residual stream and
    master weights) gives a finite loss near ln(vocab) and f32 params."""
    p, v, step = port.build_train(TINY, device="cpu")
    loss = float(step(p, v, port.synthetic_tokens(TINY, 2))[2]["loss"])
    assert numpy.isfinite(loss)
    assert abs(loss - numpy.log(TINY["vocab"])) < 0.5
    assert all(leaf.dtype == numpy.float32
               for _n, leaf in _leaves(params_to_numpy(p)))


@pytest.mark.parametrize("cfg", [TINY, port.CONFIG], ids=["tiny", "config"])
@pytest.mark.parametrize("batch", [1, 8])
def test_train_step_flops_and_tokens_match_jax(cfg, batch):
    assert port.train_step_flops(cfg, batch) == \
        jax_transformer.train_step_flops(cfg, batch)
    small = dict(cfg, seq_len=32)
    numpy.testing.assert_array_equal(
        port.synthetic_tokens(small, batch, seed=7),
        jax_transformer.synthetic_tokens(small, batch, seed=7))


def test_build_train_on_the_cpu():
    p, v, _step = port.build_train(TINY, seed=2, device="cpu")
    want = jax_transformer.init_params(TINY, seed=2)
    _close_trees(params_to_numpy(p), want)
    for name, leaf in _leaves(params_to_numpy(v)):
        assert not leaf.any(), name
    assert p["embed"].device == torch.device("cpu")


def test_build_train_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.build_train(TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.main([])


def test_mesh_and_param_specs_are_not_ported():
    """Once refused naming item 7, the mesh is ported (7(d)): the
    Megatron specs are the JAX package's, and the step over a
    one-process mesh (every axis of size 1, no process group) is the
    no-mesh step bit for bit; the ranks' meshes are
    ``tests/test_torch_spmd.py``'s."""
    from jax.sharding import PartitionSpec

    from veles_tpu_torch.parallel.mesh import mesh_from_topology
    host = port.init_params(TINY)
    want = jax_transformer.param_specs(host)

    def flat(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                yield from ((key + "/" + k, v) for k, v in flat(leaf))
            else:
                yield key, tuple(leaf)
    assert dict(flat(port.param_specs(host))) == dict(flat(want))
    assert all(isinstance(spec, PartitionSpec) for _k, spec in (
        (k, v) for k, v in want["blocks"].items()))
    tokens = port.synthetic_tokens(TINY, 4, seed=3)
    runs = []
    for mesh in (None, mesh_from_topology("data=1,seq=1,model=1")):
        p, v, step = port.build_train(TINY, mesh=mesh, device="cpu",
                                      compute_dtype=torch.float32)
        losses = [float(step(p, v, tokens)[2]["loss"]) for _ in range(2)]
        runs.append((losses, params_to_numpy(p)))
    assert runs[0][0] == runs[1][0]
    for (name, a), (_n, b) in zip(_leaves(runs[0][1]), _leaves(runs[1][1])):
        numpy.testing.assert_array_equal(a, b, err_msg=name)


def test_cli_prints_tokens_per_second_on_the_cpu(capsys):
    assert port.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "tiny" in out and "tokens/sec" in out
