"""InputJoiner: per-sample concatenation of several units' outputs, the
port's counterpart of :mod:`veles_tpu.input_joiner`.

It consumes N ``Vector`` inputs of one batch size and emits one
(B, Σ features) float32 buffer: one
:func:`veles_tpu_torch.ops.join.join` over the device tensors.
"""

import numpy
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.ops.join import join


class InputJoiner(AcceleratedUnit):
    """``link_inputs(unit_a, "output", unit_b, "output", ...)``, then read
    ``output``."""

    def __init__(self, workflow, **kwargs):
        super(InputJoiner, self).__init__(workflow, **kwargs)
        self.inputs = list(kwargs.get("inputs", ()))
        self.output = Vector()

    def link_inputs(self, *pairs):
        """``pairs`` = unit1, attr1, unit2, attr2, ...: the named Vectors
        are collected at initialize (they may not exist before their
        units initialize)."""
        if len(pairs) % 2:
            raise ValueError("link_inputs takes (unit, attr) pairs")
        self._input_links = list(zip(pairs[::2], pairs[1::2]))
        return self

    def _resolve_inputs(self):
        for unit, attr in getattr(self, "_input_links", ()):
            vec = getattr(unit, attr)
            if vec not in self.inputs:
                self.inputs.append(vec)

    def initialize(self, device=None, **kwargs):
        super(InputJoiner, self).initialize(device=device, **kwargs)
        self._resolve_inputs()
        if not self.inputs:
            raise ValueError("InputJoiner has no inputs")
        batch = self.inputs[0].shape[0]
        width = 0
        for vec in self.inputs:
            if vec.shape[0] != batch:
                raise ValueError("input batch dims differ: %s vs %s"
                                 % (vec.shape, self.inputs[0].shape))
            width += int(numpy.prod(vec.shape[1:]))
        self.output.reset(numpy.zeros((batch, width), numpy.float32))
        self.init_vectors(self.output, *self.inputs)

    def cuda_run(self):
        self.output.devmem = join(
            [v.devmem.to(torch.float32) for v in self.inputs])
