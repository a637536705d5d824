"""The pickling protocol and the master/slave data-exchange interface.

The port's counterpart of :mod:`veles_tpu.distributable`:

* ``Pickleable``: attributes whose names end with ``_`` are left out of
  pickles, and ``init_unpickled()`` recreates them after construction
  and after unpickling.  Whole-workflow snapshots
  (:mod:`veles_tpu_torch.snapshotter`) rest on this one convention:
  locks, loggers, device tensors, CUDA graphs and streams all live in
  ``_``-suffixed slots.  A torch tensor held in a plain attribute (an
  evaluator's metric, a health statistic: 0-d outputs of a segment's
  graph) pickles as a host numpy copy, since a tensor in a pickle
  brings its device storage along.
* ``Distributable``: ``data_lock()`` around the master/slave data
  methods, with a deadlock warning after ``DEADLOCK_TIME`` seconds,
  and the trivial ``generate_/apply_`` defaults of the job contract,
  which the job layer (:mod:`veles_tpu_torch.parallel.jobs`) calls.
"""

import contextlib
import logging
import threading

import torch

from veles_tpu_torch.logger import Logger


def _host_value(value):
    """A torch tensor as a host numpy copy (after the card's work is
    done), anything else as it is."""
    if not isinstance(value, torch.Tensor):
        return value
    if value.is_cuda:
        torch.cuda.synchronize(value.device)
    return value.detach().cpu().numpy()


class Pickleable(Logger):
    """Base with the ``_``-suffix pickling convention."""

    def __init__(self, **kwargs):
        super(Pickleable, self).__init__(**kwargs)
        self.init_unpickled()

    def init_unpickled(self):
        """Create (or recreate) every transient ``_``-suffixed
        attribute; subclasses override and call
        ``super().init_unpickled()``."""
        sup = super(Pickleable, self)
        if hasattr(sup, "init_unpickled"):
            sup.init_unpickled()
        self._logger_ = logging.getLogger(self.__class__.__name__)
        self._pickle_lock_ = threading.Lock()

    def __getstate__(self):
        with getattr(self, "_pickle_lock_", threading.Lock()):
            return {key: _host_value(value)
                    for key, value in self.__dict__.items()
                    if not key.endswith("_")}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.init_unpickled()


class Distributable(Pickleable):
    """Thread-safe data exchange with a deadlock warning."""

    DEADLOCK_TIME = 4.0

    negotiates_on_connect = False

    def init_unpickled(self):
        super(Distributable, self).init_unpickled()
        self._data_lock_ = threading.RLock()

    @contextlib.contextmanager
    def data_lock(self):
        """Serialize the master/slave data exchange on this unit; warn
        when the lock is not had within ``DEADLOCK_TIME`` seconds, then
        wait on."""
        if not self._data_lock_.acquire(timeout=self.DEADLOCK_TIME):
            self.warning(
                "possible deadlock in %s (> %.0f s waiting on data lock)",
                type(self).__name__, self.DEADLOCK_TIME)
            self._data_lock_.acquire()
        try:
            yield
        finally:
            self._data_lock_.release()

    # -- the job contract's trivial defaults ---------------------------------
    def generate_data_for_master(self):
        """The payload a slave sends to the master after a job."""
        return None

    def generate_data_for_slave(self, slave=None):
        """Master side: a job payload for ``slave``."""
        return None

    def apply_data_from_master(self, data):
        """Slave side: install a job payload before running."""

    def apply_data_from_slave(self, data, slave=None):
        """Master side: merge a slave's update."""

    def drop_slave(self, slave=None):
        """Master side: a slave died; requeue its outstanding work."""


class TriviallyDistributable(Distributable):
    """A marker for units with no distributed state."""
