"""The port's loader prefetch ring against the JAX package's, on the CPU:
the loader prefetch tests of ``tests/test_thread_pool.py`` with the same
stub loader (``SlowIOLoader``: a synthetic per-sample "IO" sleep and
the pure ``fill_minibatch_into``), one copy subclassing each package's
``Loader``.

- Prefetch hides the IO behind a slow consumer (wall time under 0.8 of
  the run without it), fills off the scheduler's thread, and serves the
  same minibatches as the run without it, across epoch wraps (a
  reshuffle), after a worker's exception, and after a re-initialize.
- The staging ring allocates its slots once and a hit publishes the
  host and the device copy together.
- The sequence of served minibatches equals the JAX package's, with
  prefetch on and off (both seeded alike, so they shuffle alike).
- The slave half (``prefetch_job_data``, the full-batch loader's
  ``apply_data_from_master``), once refused naming ROADMAP item 7,
  serves a job's minibatch and fills the next one in the background.
"""

import threading
import time

import numpy
import pytest

from veles_tpu import prng as jax_prng
from veles_tpu.dummy import DummyUnit as JaxDummyUnit
from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
from veles_tpu.loader.base import Loader as JaxLoader
from veles_tpu.mutable import Bool as JaxBool
from veles_tpu.plumbing import Repeater as JaxRepeater
from veles_tpu_torch import prng
from veles_tpu_torch.backends import CPUDevice
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.loader.base import Loader
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.units import Unit
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)


def _slow_io_loader(base):
    class SlowIOLoader(base):
        """Synthetic loader whose per-batch 'IO' sleeps, with the pure
        prefetch fill."""

        supports_prefetch = True

        def __init__(self, workflow, io_delay=0.05, **kwargs):
            super(SlowIOLoader, self).__init__(workflow, **kwargs)
            self.io_delay = io_delay
            self.fill_threads = []

        def load_data(self):
            self._has_labels = True
            self.class_lengths[:] = [0, 0, 64]

        def create_minibatch_data(self):
            self.minibatch_data.reset(numpy.zeros(
                (self.max_minibatch_size, 4), dtype=numpy.float32))

        def _fill(self, indices, data_out, raw_labels_out):
            time.sleep(self.io_delay)
            for i, idx in enumerate(indices):
                data_out[i] = float(idx)
                raw_labels_out[i] = int(idx) % 8

        def fill_minibatch(self):
            self.fill_threads.append(threading.get_ident())
            n = self.minibatch_size
            self.minibatch_data.map_write()
            self._fill(self.minibatch_indices.mem[:n],
                       self.minibatch_data.mem[:n],
                       self.raw_minibatch_labels)

        def fill_minibatch_into(self, indices, data_out, raw_labels_out):
            self.fill_threads.append(threading.get_ident())
            self._fill(indices, data_out, raw_labels_out)
    return SlowIOLoader


SlowIOLoader = _slow_io_loader(Loader)
JaxSlowIOLoader = _slow_io_loader(JaxLoader)

PORT = (prng, DummyWorkflow, Repeater, Bool, Unit, SlowIOLoader)
JAX = (jax_prng, JaxDummyWorkflow, JaxRepeater, JaxBool, JaxDummyUnit,
       JaxSlowIOLoader)


def _run_loader_loop(prefetch, io_delay=0.04, train_delay=0.04, epochs=2,
                     package=PORT, loader_cls=None):
    """The repeater loop of a loader and a 'trainer' that sleeps and
    records each served minibatch (data and labels)."""
    seed_prng, workflow, repeater, flag, unit, slow = package
    seed_prng.seed_all(4321)
    wf = workflow()
    loader = (loader_cls or slow)(wf, io_delay=io_delay, minibatch_size=16,
                                  prefetch=prefetch)
    rep = repeater(wf)
    stop = flag(False)
    seen = []

    class Trainer(unit):
        def run(self):
            nonlocal stop
            time.sleep(train_delay)
            seen.append((numpy.array(loader.minibatch_data.mem),
                         numpy.array(loader.minibatch_labels.mem)))
            if loader.epoch_ended and loader.epoch_number >= epochs:
                stop <<= True

    trainer = Trainer(wf, name="trainer")
    rep.link_from(wf.start_point)
    loader.link_from(rep)
    trainer.link_from(loader)
    rep.link_from(trainer)
    rep.gate_block = stop
    wf.end_point.link_from(trainer)
    wf.end_point.gate_block = ~stop
    wf.initialize()
    tic = time.monotonic()
    wf.run()
    return time.monotonic() - tic, seen, loader


def _assert_same(seen_a, seen_b):
    assert len(seen_a) == len(seen_b)
    for (da, la), (db, lb) in zip(seen_a, seen_b):
        numpy.testing.assert_array_equal(da, db)
        numpy.testing.assert_array_equal(la, lb)


def test_loader_prefetch_overlaps_io():
    t_off, seen_off, _ = _run_loader_loop(prefetch=False)
    t_on, seen_on, loader = _run_loader_loop(prefetch=True)
    _assert_same(seen_on, seen_off)
    assert any(t != threading.get_ident() for t in loader.fill_threads)
    assert t_on < t_off * 0.8, \
        "prefetch gave no overlap (on=%.3fs off=%.3fs)" % (t_on, t_off)


def test_loader_prefetch_epoch_wrap_correctness():
    """Across epoch wraps the prediction goes stale (a reshuffle): the
    served minibatches equal the run without prefetch."""
    _t, seen_off, _ = _run_loader_loop(prefetch=False, io_delay=0.0,
                                       train_delay=0.0, epochs=3)
    _t, seen_on, _ = _run_loader_loop(prefetch=True, io_delay=0.0,
                                      train_delay=0.0, epochs=3)
    _assert_same(seen_on, seen_off)


@pytest.mark.parametrize("prefetch", [False, True])
def test_served_minibatches_equal_the_jax_package(prefetch):
    """The port and the JAX package, seeded alike, serve the same
    minibatches, data and mapped labels, over three epochs."""
    _t, port_seen, _ = _run_loader_loop(prefetch=prefetch, io_delay=0.0,
                                        train_delay=0.0, epochs=3)
    _t, jax_seen, _ = _run_loader_loop(prefetch=prefetch, io_delay=0.0,
                                       train_delay=0.0, epochs=3,
                                       package=JAX)
    assert len(port_seen) == 16
    _assert_same(port_seen, jax_seen)


def test_prefetch_exception_propagates_and_recovers():
    """A worker's exception surfaces at the serve that consumes it
    (logged) and the serve fills synchronously: the served stream
    equals the run without prefetch."""
    fail_on = {3}

    class FlakyLoader(SlowIOLoader):
        def __init__(self, workflow, **kwargs):
            super(FlakyLoader, self).__init__(workflow, **kwargs)
            self.bg_calls = 0
            self.failures = 0

        def fill_minibatch_into(self, indices, data_out, raw_labels_out):
            self.bg_calls += 1
            if self.bg_calls in fail_on:
                self.failures += 1
                raise RuntimeError("synthetic IO failure")
            super(FlakyLoader, self).fill_minibatch_into(
                indices, data_out, raw_labels_out)

    _t, seen_ref, _ = _run_loader_loop(prefetch=False, io_delay=0.0,
                                       train_delay=0.01)
    _t, seen_flaky, loader = _run_loader_loop(
        prefetch=True, io_delay=0.0, train_delay=0.01,
        loader_cls=FlakyLoader)
    assert loader.failures >= 1, "the failure injection never fired"
    _assert_same(seen_flaky, seen_ref)


def test_no_stale_prefetch_after_reinitialize():
    """``initialize()`` reshuffles: a fill buffered before it is not
    served after it, even under a matching (offset, size)."""
    def serve_after_reinit(prefetch):
        prng.seed_all(777)
        wf = DummyWorkflow()
        loader = SlowIOLoader(wf, io_delay=0.0, minibatch_size=16,
                              prefetch=prefetch)
        loader.link_from(wf.start_point)
        wf.end_point.link_from(loader)
        wf.initialize()
        for _ in range(3):
            loader.run()        # leaves minibatch 4 in flight
        assert not prefetch or loader._prefetch_futures_
        loader.initialize()
        assert not loader._prefetch_futures_
        loader.run()
        return numpy.array(loader.minibatch_data.mem)

    numpy.testing.assert_array_equal(serve_after_reinit(True),
                                     serve_after_reinit(False))


def test_prefetch_ring_reuses_buffers_and_publishes_device():
    """The ring allocates its slots once, and with a device attached a
    hit publishes the worker's upload as the device copy: both copies
    of ``minibatch_data`` fresh, nothing left to transfer."""
    prng.seed_all(4321)
    wf = DummyWorkflow()
    loader = SlowIOLoader(wf, io_delay=0.0, minibatch_size=16,
                          prefetch=True)
    loader.link_from(wf.start_point)
    wf.end_point.link_from(loader)
    wf.initialize(device=CPUDevice())
    data_ring, _labels_ring = loader._staging()
    slot_ids = set()
    acquire = data_ring.acquire

    def spy_acquire():
        slot = acquire()
        slot_ids.add(id(slot))
        return slot
    data_ring.acquire = spy_acquire
    hits = 0
    for _ in range(8):
        loader.run()
        time.sleep(0.02)        # let the background fill land
        vec = loader.minibatch_data
        if vec._dev_fresh and vec._host_fresh:
            hits += 1
            numpy.testing.assert_array_equal(vec._devmem.numpy(), vec.mem)
    assert hits >= 3, "prefetch hits never published device copies"
    assert len(slot_ids) <= data_ring.depth


def test_the_slave_half_raises_naming_item_7():
    """The slave half, once refused naming ROADMAP item 7, now works (the
    test keeps its name): a master serves jobs without filling; a slave
    installs a job's indices and serves exactly that minibatch, and
    ``prefetch_job_data`` fills the next job's on a worker thread, which
    its serve then publishes; the master retires the slave's pending
    minibatches as the updates come.  A full-batch slave takes the job's
    span into its shuffled indices, and on its device path stages the
    next job's copy of the buffer."""
    prng.seed_all(4321)
    master_wf = DummyWorkflow(is_master=True)
    master = SlowIOLoader(master_wf, io_delay=0.0, minibatch_size=16)
    master_wf.initialize(device=CPUDevice())
    slave_wf = DummyWorkflow(is_slave=True)
    slave = SlowIOLoader(slave_wf, io_delay=0.05, minibatch_size=16,
                         prefetch=True)
    slave_wf.initialize(device=CPUDevice())
    master.fill_threads.clear()
    slave.fill_threads.clear()
    jobs = [master.generate_data_for_slave("s1") for _ in range(2)]
    assert master.fill_threads == [], "a master fills nothing"
    assert len(master.pending_minibatches_["s1"]) == 2
    main = threading.get_ident()
    for job in jobs:
        slave.apply_data_from_master(job)
        slave.run()
        numpy.testing.assert_array_equal(
            slave.minibatch_data.mem[:16, 0],
            numpy.asarray(job["indices"], numpy.float32))
        numpy.testing.assert_array_equal(
            slave.minibatch_labels.mem[:16],
            numpy.asarray(job["indices"]) % 8)
        if job is jobs[0]:
            slave.prefetch_job_data(jobs[1])
            time.sleep(0.1)       # let the background fill land
    assert slave.fill_threads[0] == main and len(slave.fill_threads) == 2
    assert slave.fill_threads[1] != main, \
        "the next job's minibatch was filled on a worker"
    for _ in jobs:
        master.apply_data_from_slave(True, "s1")
    assert not master.pending_minibatches_["s1"]
    assert master.samples_served == 32

    class Rows(FullBatchLoader):
        def load_data(self):
            self.original_data.mem = numpy.arange(
                64 * 3, dtype=numpy.float32).reshape(64, 3)
            self.original_labels = [i % 4 for i in range(64)]
            self.class_lengths[:] = [0, 16, 48]

    full_master_wf = DummyWorkflow(is_master=True)
    full_master = Rows(full_master_wf, minibatch_size=16)
    full_master_wf.initialize(device=CPUDevice())
    full_wf = DummyWorkflow(is_slave=True)
    full = Rows(full_wf, minibatch_size=16, prefetch=True)
    full_wf.initialize(device=CPUDevice())
    job1, job2 = (full_master.generate_data_for_slave("s1")
                  for _ in range(2))
    full.apply_data_from_master(job1)
    full.run()
    numpy.testing.assert_array_equal(
        full.minibatch_data.mem[:16, 0],
        numpy.asarray(job1["indices"], numpy.float32) * 3)
    full.prefetch_job_data(job2)
    assert list(full._staged_indices_) == [(job2["minibatch_offset"], 16)]
    full.apply_data_from_master(job2)
    assert not full._staged_indices_
    span = slice(job2["minibatch_offset"] - 16, job2["minibatch_offset"])
    numpy.testing.assert_array_equal(full.shuffled_indices.mem[span],
                                     job2["indices"])
    numpy.testing.assert_array_equal(
        full.shuffled_indices.devmem.numpy()[span], job2["indices"])
