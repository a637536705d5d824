"""The RBM (``znicz/rbm.py``, ``mnist_ae(rbm_pretrain=True)``), the
Kohonen map (``znicz/kohonen.py``, ``samples/kohonen.py``) and the key
splits of ``ops/random.py`` against the JAX package, on the CPU.

- ``threefry_split``, ``threefry_bits`` and ``threefry_bernoulli`` over
  split keys (nested splits, several seeds, a tensor ``p``) equal
  ``jax.random.split`` / ``bits`` / ``bernoulli`` bit for bit.
- ``_cd_step`` with ``cd_k`` 1 and 2: the hidden samples equal the JAX
  draws over the JAX step's own probabilities (the flipped draws are
  counted: 0 on these inputs), and the parameters and the
  reconstruction error are within ``RBM_TOL`` = 1e-6.
- ``mnist_ae.create_workflow(rbm_pretrain=True)`` at hidden 16: the
  pretrained encoder and decoder start within ``RBM_TOL`` of the JAX
  sample's, and the fine-tune trains.
- ``_som_step`` and ``KohonenWorkflow``: the codebook within
  ``SOM_TOL`` = 1e-6, the winners equal, the quantization error within
  1e-6.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.samples import kohonen as jax_kohonen
from veles_tpu.samples import mnist_ae as jax_mnist_ae
from veles_tpu.znicz import kohonen as jax_som
from veles_tpu.znicz import rbm as jax_rbm
from veles_tpu_torch import prng
from veles_tpu_torch.ops.random import (threefry_bernoulli, threefry_bits,
                                        threefry_split)
from veles_tpu_torch.samples import kohonen, mnist_ae
from veles_tpu_torch.znicz import kohonen as som
from veles_tpu_torch.znicz import rbm

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

RBM_TOL = 1e-6
SOM_TOL = 1e-6
_SEEDS = (0, 7, 12345, 2 ** 31 - 1)
_P = numpy.random.default_rng(5).random((6, 9)).astype(numpy.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread: these small ops, thousands a
    minibatch, otherwise wait for a descheduled pool thread whenever the
    box's cores are busy (~8 ms an op beside the parallel suite)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_keys():
    """For each seed, one jitted program: the split, a nested three-way
    split of the second key, bits of the first key, Bernoulli draws over
    a tensor p from the last nested key."""
    @jax.jit
    def program(seed, p):
        key = jax.random.key(seed)
        first, second = jax.random.split(key)
        nested = jax.random.split(second, 3)
        return (jax.random.key_data(jnp.stack([first, second])),
                jax.random.key_data(nested),
                jax.random.bits(first, (5, 7)),
                jax.random.bernoulli(nested[2], p))
    return {s: jax.tree.map(numpy.asarray, program(numpy.uint32(s), _P))
            for s in _SEEDS}


def _words(keys):
    return [[int(w) for w in k] for k in keys]


@pytest.mark.parametrize("seed", _SEEDS)
def test_split_bits_and_bernoulli_equal_jax_random(jax_keys, seed):
    pair, nested, bits, draws = jax_keys[seed]
    keys = threefry_split(seed)
    assert _words(keys) == pair.tolist()
    inner = threefry_split(keys[1], 3)
    assert _words(inner) == nested.tolist()
    assert numpy.array_equal(threefry_bits(keys[0], (5, 7)).numpy(),
                             bits.astype(numpy.int64))
    got = threefry_bernoulli(inner[2], torch.from_numpy(_P))
    assert numpy.array_equal(got.numpy(), draws)
    # the key's words as 0-d tensors: the same draws on their device
    tensor_key = tuple(torch.tensor(w) for w in inner[2])
    assert numpy.array_equal(
        threefry_bernoulli(tensor_key, torch.from_numpy(_P)).numpy(), draws)


def _rbm_inputs(seed, v=20, h=7, b=10):
    rng = numpy.random.default_rng(seed)
    return ((rng.standard_normal((v, h)) * 0.3).astype(numpy.float32),
            (rng.standard_normal(v) * 0.1).astype(numpy.float32),
            (rng.standard_normal(h) * 0.1).astype(numpy.float32),
            rng.random((b, v)).astype(numpy.float32))


def _jax_hidden_draws(w, vb, hb, v0, seed, cd_k):
    """The JAX step's hidden samples, drawn over its own probabilities."""
    key = jax.random.key(jnp.uint32(seed))
    hprob = lambda v: jax.nn.sigmoid(v @ w + hb)  # noqa: E731
    vprob = lambda h: jax.nn.sigmoid(h @ w.T + vb)  # noqa: E731
    key, k0 = jax.random.split(key)
    h = jax.random.bernoulli(k0, hprob(v0)).astype(jnp.float32)
    draws = [h]
    for _ in range(cd_k):
        hp = hprob(vprob(h))
        key, ki = jax.random.split(key)
        h = jax.random.bernoulli(ki, hp).astype(jnp.float32)
        draws.append(h)
    return [numpy.asarray(d) for d in draws]


@pytest.mark.parametrize("seed", [1, 99, 123456])
@pytest.mark.parametrize("cd_k", [1, 2])
def test_cd_step_matches_jax(cd_k, seed):
    w, vb, hb, v0 = _rbm_inputs(seed)
    want = jax_rbm._cd_step(w, vb, hb, v0, jnp.int32(seed),
                            jnp.float32(0.1), cd_k=cd_k)
    samples = []
    got = rbm._cd_step(*(torch.from_numpy(a) for a in (w, vb, hb, v0)),
                       seed, 0.1, cd_k=cd_k, samples=samples)
    draws = _jax_hidden_draws(w, vb, hb, v0, seed, cd_k)
    assert len(samples) == len(draws) == cd_k + 1
    flipped = sum(int((s.numpy() != d).sum())
                  for s, d in zip(samples, draws))
    assert flipped == 0
    for g, j in zip(got, want):
        assert numpy.abs(g.numpy() - numpy.asarray(j)).max() <= RBM_TOL


def test_mnist_ae_rbm_pretrain_matches_jax():
    jax_prng.seed_all(4)
    jwf = jax_mnist_ae.create_workflow(device=JaxCPUDevice(), max_epochs=1,
                                       hidden=16, rbm_pretrain=True)
    prng.seed_all(4)
    wf = mnist_ae.create_workflow(device="cpu", max_epochs=2, hidden=16,
                                  rbm_pretrain=True)
    for fwd, jfwd in zip(wf.forwards, jwf.forwards):
        for vec, jvec in ((fwd.weights, jfwd.weights),
                          (fwd.bias, jfwd.bias)):
            jvec.map_read()
            assert numpy.abs(vec.mem - jvec.mem).max() <= RBM_TOL
    assert wf.forwards[0].weights.shape == (784, 16)
    wf.run()
    rmse = wf.decision.best_mse
    assert numpy.isfinite(rmse) and rmse < 0.5


def test_som_step_matches_jax():
    rng = numpy.random.default_rng(2)
    shape = (4, 5)
    w = rng.uniform(-0.5, 0.5, (20, 3)).astype(numpy.float32)
    ys, xs = numpy.meshgrid(numpy.arange(4), numpy.arange(5),
                            indexing="ij")
    grid = numpy.stack([ys.ravel(), xs.ravel()], 1).astype(numpy.float32)
    x = rng.standard_normal((16, 3)).astype(numpy.float32)
    jw, jwin = jax_som._som_step(w, grid, x, jnp.float32(1.7),
                                 jnp.float32(0.4), shape)
    tw, twin = som._som_step(torch.from_numpy(w), torch.from_numpy(grid),
                             torch.from_numpy(x), 1.7, 0.4)
    assert numpy.array_equal(twin.numpy(), numpy.asarray(jwin))
    assert numpy.abs(tw.numpy() - numpy.asarray(jw)).max() <= SOM_TOL


def test_kohonen_workflow_matches_jax():
    jax_prng.seed_all(5)
    jwf = jax_kohonen.create_workflow(device=JaxCPUDevice(), max_epochs=3)
    jwf.run()
    prng.seed_all(5)
    wf = kohonen.create_workflow(device="cpu", max_epochs=3)
    # the trainer and the forward are barriers, as in the JAX package:
    # no stitched segment, the loader fills eagerly
    assert wf.stitch_segments == []
    wf.run()
    jwf.trainer.weights.map_read()
    jwf.trainer.winners.map_read()
    # three epochs of 10 minibatches, and the first of the fourth, at
    # which the counter stops the loop
    assert wf.trainer._step == jwf.trainer._step == 31
    assert numpy.abs(wf.trainer.weights.mem
                     - jwf.trainer.weights.mem).max() <= SOM_TOL
    assert numpy.array_equal(wf.trainer.winners.mem,
                             jwf.trainer.winners.mem)
    jwf.forward.output.map_read()
    assert numpy.array_equal(wf.forward.output.mem, jwf.forward.output.mem)
    assert wf.get_metric_values()["quantization_error"] == pytest.approx(
        jwf.get_metric_values()["quantization_error"], abs=1e-6)
