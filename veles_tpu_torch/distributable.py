"""The base every unit stands on.

The port's counterpart of :mod:`veles_tpu.distributable`, trimmed to
what :class:`veles_tpu_torch.units.Unit` needs: ``init_unpickled()``
creates the transient state, whose attribute names end with ``_``
(locks, loggers).  Pickling a workflow, and with it the master/slave
job payloads of ``Distributable``, waits for the checkpoint slice
(ROADMAP item 7).
"""

import logging

from veles_tpu_torch.logger import Logger


class Pickleable(Logger):
    """Base with the ``_``-suffix convention for transient state."""

    def __init__(self, **kwargs):
        super(Pickleable, self).__init__(**kwargs)
        self.init_unpickled()

    def init_unpickled(self):
        """Create all transient ``_``-suffixed state; subclasses
        override and call ``super().init_unpickled()``."""
        self._logger_ = logging.getLogger(self.__class__.__name__)
