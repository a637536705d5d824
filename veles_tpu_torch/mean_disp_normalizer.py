"""MeanDispNormalizer: the device-side ``(x - mean) * disp`` unit, the
port's counterpart of :mod:`veles_tpu.mean_disp_normalizer`.

It normalizes a batch against precomputed per-feature mean and
reciprocal-dispersion tensors on the device
(:func:`veles_tpu_torch.ops.normalize.mean_disp_normalize`), on the card
or over CPU tensors.
"""

import numpy
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.ops.normalize import mean_disp_normalize


class MeanDispNormalizer(AcceleratedUnit):
    """``input`` (B, ...), ``mean`` and ``rdisp`` (...) → ``output``
    (B, ...) in float32."""

    def __init__(self, workflow, **kwargs):
        super(MeanDispNormalizer, self).__init__(workflow, **kwargs)
        self.input = None    # linked Vector
        self.mean = Vector()
        self.rdisp = Vector()
        self.output = Vector()
        self.demand("input", "mean", "rdisp")

    def initialize(self, device=None, **kwargs):
        super(MeanDispNormalizer, self).initialize(device=device, **kwargs)
        if not self.mean or not self.rdisp:
            raise ValueError("mean and rdisp must be set before init")
        if self.mean.shape != self.rdisp.shape:
            raise ValueError("mean/rdisp shape mismatch")
        self.output.reset(numpy.zeros(
            self.input.shape, dtype=numpy.float32))
        self.init_vectors(self.output, self.mean, self.rdisp)

    def cuda_run(self):
        self.output.devmem = mean_disp_normalize(
            self.input.devmem, self.mean.devmem, self.rdisp.devmem,
            dtype=torch.float32)
