"""Kohonen self-organizing map units: the port's counterpart of
:mod:`veles_tpu.znicz.kohonen`.

:func:`_som_step` is one batch update: the distances to every
neuron expanded as ``‖x‖² − 2·x·wᵀ + ‖w‖²`` (the cross term one
product, cuBLAS on the card, as the JAX package leaves it to XLA), the
winner an ``argmin`` (the first index on ties), the Gaussian
neighbourhood over the 2-D grid and the neighbourhood-weighted batch
update, one more product.  The radius and the learning rate are host floats (``decay **
step``) rounded to float32 as ``jnp.float32`` rounds them.  A near tie
of two distances may pick another winner on the card than on the CPU.

:class:`KohonenTrainer` owns the ``(sy·sx, D)`` codebook and runs a step
a ``run`` over the device tensors; :class:`KohonenForward` (the
best-matching unit of each sample) and
:meth:`KohonenTrainer.quantization_error` run on the host in numpy, as
in the JAX package.  Neither unit has a stitched stage: on the stitched
route each is a barrier.
"""

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Vector


def _som_step(weights, grid, x, radius, learning_rate):
    """One batch SOM update.  ``weights``: (N, D); ``grid``: (N, 2) the
    neurons' coordinates; ``x``: (B, D); ``radius``, ``learning_rate``:
    floats.  Returns ``(new_weights, winners)`` (winners int64)."""
    f32 = dict(dtype=torch.float32, device=weights.device)
    radius = torch.tensor(numpy.float32(radius), **f32)
    learning_rate = torch.tensor(numpy.float32(learning_rate), **f32)
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    w2 = torch.sum(weights * weights, dim=1)[None, :]
    cross = x @ weights.t()
    dist = x2 - 2.0 * cross + w2                       # (B, N)
    winners = torch.argmin(dist, dim=1)                # (B,)
    wcoords = grid[winners]                            # (B, 2)
    d2 = torch.sum((grid[None, :, :] - wcoords[:, None, :]) ** 2, dim=2)
    h = torch.exp(-d2 / (2.0 * radius * radius))       # (B, N)
    # w += lr · Σ_b h_bn (x_b − w_n) / Σ_b h_bn
    num = h.t() @ x
    den = torch.sum(h, dim=0)[:, None]
    delta = num / torch.clamp(den, min=1e-8) - weights
    new_weights = weights + learning_rate * delta * (den > 1e-8)
    return new_weights, winners


def _distances(x, w):
    """The host distance matrix of the JAX units (numpy)."""
    return (x * x).sum(1)[:, None] - 2 * x @ w.T + (w * w).sum(1)[None, :]


class KohonenForward(AcceleratedUnit):
    """Maps samples to their best-matching unit's index (on the host)."""

    def __init__(self, workflow, **kwargs):
        super(KohonenForward, self).__init__(workflow, **kwargs)
        self.input = None
        self.weights = None     # linked from the trainer
        self.output = Vector()
        self.demand("input", "weights")

    def initialize(self, device=None, **kwargs):
        super(KohonenForward, self).initialize(device=device, **kwargs)
        self.output.reset(numpy.zeros(self.input.shape[0],
                                      dtype=numpy.int32))
        self.init_vectors(self.output)

    def cuda_run(self):
        x = self.input.mem.reshape(len(self.input.mem), -1)
        dist = _distances(x, self.weights.mem)
        self.output.mem = dist.argmin(axis=1).astype(numpy.int32)


class KohonenTrainer(AcceleratedUnit):
    """SOM trainer: owns the (sy·sx, D) codebook and the decay
    schedules."""

    def __init__(self, workflow, **kwargs):
        super(KohonenTrainer, self).__init__(workflow, **kwargs)
        self.input = None
        self.shape = tuple(kwargs.get("shape", (8, 8)))    # (sy, sx)
        self.weights = Vector()
        self.winners = Vector()
        self.learning_rate = kwargs.get("learning_rate", 0.5)
        self.sigma = kwargs.get("sigma", max(self.shape) / 2.0)
        self.decay = kwargs.get("decay", 0.995)
        self._step = 0
        self.demand("input")

    @property
    def n_neurons(self):
        return self.shape[0] * self.shape[1]

    def initialize(self, device=None, **kwargs):
        super(KohonenTrainer, self).initialize(device=device, **kwargs)
        dim = int(numpy.prod(self.input.shape[1:]))
        if not self.weights:
            w = numpy.zeros((self.n_neurons, dim), dtype=numpy.float32)
            prng.get("kohonen").fill_uniform(w, -0.5, 0.5)
            self.weights.reset(w)
        ys, xs = numpy.meshgrid(numpy.arange(self.shape[0]),
                                numpy.arange(self.shape[1]),
                                indexing="ij")
        self._grid = numpy.stack(
            [ys.ravel(), xs.ravel()], axis=1).astype(numpy.float32)
        self.grid_ = None
        self.winners.reset(numpy.zeros(self.input.shape[0],
                                       dtype=numpy.int32))
        self.init_vectors(self.weights, self.winners)

    @property
    def current_radius(self):
        return max(self.sigma * (self.decay ** self._step), 0.5)

    @property
    def current_learning_rate(self):
        return max(self.learning_rate * (self.decay ** self._step), 0.01)

    def cuda_run(self):
        x = self.input.devmem
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        w = self.weights.devmem
        if getattr(self, "grid_", None) is None \
                or self.grid_.device != w.device:
            self.grid_ = torch.as_tensor(self._grid).to(w.device)
        new_w, winners = _som_step(w, self.grid_, x, self.current_radius,
                                   self.current_learning_rate)
        self.weights.devmem = new_w
        self.winners.devmem = winners.to(torch.int32)
        self._step += 1

    def quantization_error(self, x):
        """Mean distance of the samples to their best-matching unit (the
        SOM's quality metric), on the host."""
        x = numpy.asarray(x).reshape(len(x), -1)
        dist = _distances(x, self.weights.mem)
        return float(numpy.sqrt(numpy.maximum(
            dist.min(axis=1), 0)).mean())
