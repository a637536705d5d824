"""AcceleratedUnit: units that run over their Vectors' device tensors.

The port's counterpart of :mod:`veles_tpu.accelerated_units`.
``AcceleratedUnit.run`` is ``cuda_run``, the counterpart of the JAX
package's ``tpu_run``: torch over ``Vector.devmem``.  On a
``CPUDevice`` the same ``cuda_run`` runs over CPU tensors, and every
kernel wrapper it calls takes its plain version.  The JAX package's
``numpy_run`` host path is not ported: ``CPUDevice`` is the one host
route.  ``AcceleratedWorkflow`` owns the device.  The JAX package's jit
cache has no counterpart: PyTorch runs eagerly.
"""

from veles_tpu_torch.backends import make_device
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import Workflow


class AcceleratedUnit(Unit):
    """Unit whose ``run`` is its device path, ``cuda_run``."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(AcceleratedUnit, self).__init__(workflow, **kwargs)
        self.device = None

    def initialize(self, device=None, **kwargs):
        """Attach the device (the argument, else the workflow's) and
        attach every Vector attribute to it."""
        if device is not None:
            self.device = device
        elif self.device is None:
            self.device = getattr(self.workflow, "device", None)
        super(AcceleratedUnit, self).initialize(**kwargs)
        for vec in self._vectors():
            vec.initialize(self.device)

    def _vectors(self):
        for value in self.__dict__.values():
            if isinstance(value, Vector):
                yield value

    def init_vectors(self, *vectors):
        for vec in vectors:
            vec.initialize(self.device)

    def run(self):
        return self.cuda_run()

    def cuda_run(self):
        raise NotImplementedError(
            "%s defines no cuda_run" % type(self).__name__)


class AcceleratedWorkflow(Workflow):
    """Workflow owning a device: ``initialize()`` without one takes the
    card (and raises without a card)."""

    hide_from_registry = True

    def __init__(self, workflow=None, **kwargs):
        super(AcceleratedWorkflow, self).__init__(workflow, **kwargs)
        self.device = kwargs.get("device")

    def initialize(self, device=None, **kwargs):
        device = make_device(device if device is not None else self.device)
        return super(AcceleratedWorkflow, self).initialize(
            device=device, **kwargs)
