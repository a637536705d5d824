"""The port's trace ring (``veles_tpu_torch.trace``) against the JAX
package's (``veles_tpu.trace``): ``root.common.engine.trace_capacity``
sizes both rings at ``configure()``, and the same spans recorded into
both leave the same newest events.  The port's ``resize`` keeps the
newest events that fit; the JAX package's drops them all, so the parity
cases resize before recording."""

import pytest

from veles_tpu.config import root as jax_root
from veles_tpu.trace import core as jax_core
from veles_tpu_torch.config import root
from veles_tpu_torch.trace import core
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)


@pytest.fixture
def rings():
    """Both recorders and both knobs, restored after the test."""
    saved = [(rec, rec.enabled, rec.capacity)
             for rec in (jax_core.recorder, core.recorder)]
    knobs = [(eng, eng.get("trace_capacity"), eng.get("trace"))
             for eng in (jax_root.common.engine, root.common.engine)]
    yield
    for eng, capacity, mode in knobs:
        eng.trace_capacity, eng.trace = capacity, mode
    for rec, enabled, capacity in saved:
        rec.resize(capacity)
        rec.clear()
        rec.enabled = enabled


def _record(module, spans):
    """``spans`` complete events with fixed stamps, in one thread."""
    for i in range(spans):
        module.complete("cat%d" % (i % 3), "span", 1000 * i, 10 + i,
                        {"i": i})


@pytest.mark.parametrize("capacity,spans", [
    (1, 5), (7, 3), (7, 7), (7, 30), (64, 200), (65536, 10)])
def test_trace_capacity_keeps_the_jax_recorders_newest_events(
        rings, capacity, spans):
    for eng in (jax_root.common.engine, root.common.engine):
        eng.trace_capacity = capacity
    assert jax_core.configure("on") and core.configure("on")
    for module in (jax_core, core):
        module.recorder.clear()
        _record(module, spans)
    assert core.recorder.capacity == jax_core.recorder.capacity == capacity
    got, want = core.recorder.events(), jax_core.recorder.events()
    assert got == want
    assert len(got) == min(capacity, spans)
    assert [e[6]["i"] for e in got] == list(
        range(spans - len(got), spans))


def test_resize_keeps_the_newest_events_that_fit(rings):
    rec = core.recorder
    root.common.engine.trace_capacity = 8
    core.configure("on")
    rec.clear()
    _record(core, 10)
    rec.resize(3)
    assert [e[6]["i"] for e in rec.events()] == [7, 8, 9]
    rec.resize(5)
    assert [e[6]["i"] for e in rec.events()] == [7, 8, 9]
    _record(core, 4)
    assert [e[6]["i"] for e in rec.events()] == [9, 0, 1, 2, 3]
    with pytest.raises(ValueError, match=">= 1"):
        rec.resize(0)


def test_configure_leaves_the_ring_alone_at_its_own_capacity(rings):
    root.common.engine.trace_capacity = 16
    core.configure("on")
    core.recorder.clear()
    _record(core, 5)
    assert core.configure("on") and len(core.recorder.events()) == 5
    root.common.engine.trace_capacity = None
    assert not core.configure("off")
    assert core.recorder.capacity == 16
