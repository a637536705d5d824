"""Avatar: an in-workflow copy of a loader's served minibatch, the
port's counterpart of :mod:`veles_tpu.avatar`.

``Avatar.clone`` copies the producer's minibatch attributes into its own
Vectors, so a consumer graph is decoupled from the producer: the
producer may already serve the next minibatch while consumers read the
previous one.  On a device the JAX avatar references the producer's
immutable array; a torch tensor is written in place (a stitched
loader head gathers into the same buffer every minibatch), so the port
copies it into the avatar's own device tensor instead.
"""

import numpy

from veles_tpu_torch.memory import Vector
from veles_tpu_torch.units import Unit

#: attributes cloned by value
SCALAR_ATTRS = ("minibatch_class", "minibatch_size", "minibatch_offset",
                "epoch_number")
#: Vector attributes cloned into own buffers
VECTOR_ATTRS = ("minibatch_data", "minibatch_labels",
                "minibatch_indices", "minibatch_targets")


class Avatar(Unit):
    """Link after a loader; consumers link to the avatar instead."""

    def __init__(self, workflow, **kwargs):
        super(Avatar, self).__init__(workflow, **kwargs)
        self.source = kwargs.get("source")   # the loader
        self.minibatch_class = 0
        self.minibatch_size = 0
        self.minibatch_offset = 0
        self.epoch_number = 0
        for attr in VECTOR_ATTRS:
            setattr(self, attr, Vector())
        self.demand("source")

    def initialize(self, **kwargs):
        super(Avatar, self).initialize(**kwargs)
        for attr in VECTOR_ATTRS:
            src = getattr(self.source, attr, None)
            if src is not None and src:
                getattr(self, attr).reset(numpy.array(src.mem))

    def clone(self):
        """Copy the source's current minibatch state."""
        for attr in SCALAR_ATTRS:
            if hasattr(self.source, attr):
                setattr(self, attr, getattr(self.source, attr))
        for attr in VECTOR_ATTRS:
            src = getattr(self.source, attr, None)
            mine = getattr(self, attr)
            if src is None or not src:
                continue
            device = getattr(src, "_device", None)
            if device is not None:
                # a copy on the device (the source's tensor is uploaded
                # first when its host copy is the fresher one)
                mine.initialize(device)
                mine.devmem = src.devmem.clone()
            else:
                mine.reset(numpy.array(src.mem))

    def run(self):
        self.clone()
