"""Restricted Boltzmann machine units (CD-k pretraining): the port's
counterpart of :mod:`veles_tpu.znicz.rbm`.

:func:`_cd_step` is one contrastive-divergence step: the two products a
Gibbs half-step (cuBLAS on the card, as the JAX package leaves them to
XLA), Bernoulli samples drawn as ``jax.random.bernoulli`` draws them,
over keys split from ``jax.random.key(seed)``
(:func:`veles_tpu_torch.ops.random.threefry_split` and
``threefry_bernoulli``), so the same probabilities give the JAX
package's samples bit for bit.  A sample flips wherever a uniform lies
within the last ulps of its probability and the two packages' (or the
card's and the CPU's) sigmoids differ there; ``samples=`` collects the
hidden samples so a parity check can count those flips.

:class:`RBMTrainer` runs a step a ``run`` over the device tensors of its
input, its seed drawn from the ``rbm`` stream as the JAX unit draws it;
its parameters are published as new tensors.  Stacked RBMs pretrain an
autoencoder, whose All2All layer specs :meth:`RBMTrainer
.to_autoencoder_specs` gives.  The trainer has no stitched stage (nor
has the JAX unit): on the stitched route it is a barrier.
"""

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.ops.random import threefry_bernoulli, threefry_split


def _cd_step(w, vbias, hbias, v0, seed, lr, cd_k=1, samples=None):
    """One CD-k update.  ``v0``: (B, V) in [0, 1]; ``seed``: the int32
    seed (an int), taken as uint32 into the key ``(0, seed)``; ``lr``:
    the learning rate, rounded to float32.  Returns the new ``(w, vbias,
    hbias)`` and the reconstruction RMSE (a 0-d tensor); ``samples``, a
    list, receives each hidden sample."""
    key = (0, int(seed) & 0xFFFFFFFF)
    lr = float(numpy.float32(lr))

    def sample(p, k):
        h = threefry_bernoulli(k, p).to(torch.float32)
        if samples is not None:
            samples.append(h)
        return h

    def hprob(v):
        return torch.sigmoid(v @ w + hbias)

    def vprob(h):
        return torch.sigmoid(h @ w.t() + vbias)

    h0 = hprob(v0)
    key, k0 = threefry_split(key)
    h = sample(h0, k0)
    v = v0
    hp = h0
    for _ in range(cd_k):
        v = vprob(h)
        hp = hprob(v)
        key, ki = threefry_split(key)
        h = sample(hp, ki)
    batch = v0.shape[0]
    dw = (v0.t() @ h0 - v.t() @ hp) / batch
    dvb = torch.mean(v0 - v, dim=0)
    dhb = torch.mean(h0 - hp, dim=0)
    recon = torch.sqrt(torch.mean((v0 - v) ** 2))
    return w + lr * dw, vbias + lr * dvb, hbias + lr * dhb, recon


class RBMTrainer(AcceleratedUnit):
    """Single-layer Bernoulli RBM trained by CD-k."""

    def __init__(self, workflow, **kwargs):
        super(RBMTrainer, self).__init__(workflow, **kwargs)
        self.input = None
        self.n_hidden = kwargs.get("n_hidden", 128)
        self.cd_k = kwargs.get("cd_k", 1)
        self.learning_rate = kwargs.get("learning_rate", 0.1)
        self.weights = Vector()
        self.vbias = Vector()
        self.hbias = Vector()
        self.recon_error = numpy.inf
        self.demand("input")

    def initialize(self, device=None, **kwargs):
        super(RBMTrainer, self).initialize(device=device, **kwargs)
        dim = int(numpy.prod(self.input.shape[1:]))
        if not self.weights:
            w = numpy.zeros((dim, self.n_hidden), dtype=numpy.float32)
            prng.get("rbm").fill_normal(w, stddev=0.01)
            self.weights.reset(w)
            self.vbias.reset(numpy.zeros(dim, numpy.float32))
            self.hbias.reset(numpy.zeros(self.n_hidden, numpy.float32))
        self.init_vectors(self.weights, self.vbias, self.hbias)

    def cuda_run(self):
        x = self.input.devmem.reshape(self.input.shape[0], -1)
        seed = int(numpy.int32(prng.get("rbm").randint(0, 2 ** 31)))
        w, vb, hb, recon = _cd_step(
            self.weights.devmem, self.vbias.devmem, self.hbias.devmem,
            x.to(torch.float32), seed, self.learning_rate, cd_k=self.cd_k)
        self.weights.devmem = w
        self.vbias.devmem = vb
        self.hbias.devmem = hb
        self.recon_error = float(recon)

    def transform(self, x):
        """Hidden-unit probabilities for ``x`` (the feature extractor),
        on the host."""
        flat = numpy.asarray(x).reshape(len(x), -1)
        act = flat @ self.weights.mem + self.hbias.mem
        return 1.0 / (1.0 + numpy.exp(-act))

    def to_autoencoder_specs(self, learning_rate=0.01):
        """Encoder and decoder All2All layer specs initialized from the
        RBM (the pretraining → fine-tuning seam)."""
        return [
            {"type": "all2all_sigmoid",
             "->": {"output_sample_shape": self.n_hidden},
             "<-": {"learning_rate": learning_rate},
             "init": {"weights": numpy.array(self.weights.mem),
                      "bias": numpy.array(self.hbias.mem)}},
            {"type": "all2all_sigmoid",
             "->": {"output_sample_shape":
                    int(numpy.prod(self.input.shape[1:]))},
             "<-": {"learning_rate": learning_rate},
             "init": {"weights": numpy.array(self.weights.mem.T),
                      "bias": numpy.array(self.vbias.mem)}},
        ]
