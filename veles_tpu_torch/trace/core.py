"""The span recorder: a process-wide, lock-light ring of trace events.

The port's own copy of the span API of :mod:`veles_tpu.trace.core`
that the generative engine and scheduler call.  The disabled path is a
single attribute check that returns a shared no-op singleton; enabled,
each span costs one ``perf_counter_ns`` pair and one slot store in a
preallocated ring.  Events are ``(phase, cat, name, ts_ns, dur_ns,
tid, args, role)`` tuples in the Chrome trace-event vocabulary (``X``
complete spans, ``i`` instants, ``C`` counter samples).  Running counts
by ``(cat, name)`` survive the ring's wraparound, as the JAX package's
do, and feed :func:`veles_tpu_torch.trace.export.metrics_text`, the
trace lines of the serving ``/metrics`` page.
``root.common.engine.trace_capacity`` sizes the ring
(:func:`configure`).  The Chrome export is
:mod:`veles_tpu_torch.trace.export`; :func:`device_trace` bridges to
``torch.profiler`` for the card's own kernel timeline.
"""

import threading
import time

from veles_tpu_torch.config import root

#: default ring capacity (events); override via
#: ``root.common.engine.trace_capacity``
DEFAULT_CAPACITY = 65536

DEFAULT_ROLE = "trainer"


class _NullSpan(object):
    """The shared disabled-path context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


#: the one instance every disabled ``span()`` call returns
NULL_SPAN = _NullSpan()


class _Span(object):
    """A live span: records one ``X`` event on exit."""

    __slots__ = ("_rec", "cat", "name", "args", "role", "_begin")

    def __init__(self, rec, cat, name, args, role):
        self._rec = rec
        self.cat = cat
        self.name = name
        self.args = args
        self.role = role

    def __enter__(self):
        self._begin = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._rec.record("X", self.cat, self.name, self._begin,
                         end - self._begin, self.args, self.role)
        return False


class TraceRecorder(object):
    """Process-wide ring of trace events; keeps the newest
    ``capacity`` events."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        #: THE hot-path switch every hook reads
        self.enabled = False
        self.role = DEFAULT_ROLE
        #: where the Chrome trace is written at exit (``trace=<path>``)
        self.path = None
        self.capacity = int(capacity)
        self._ring = [None] * self.capacity
        self._pos = 0
        self._lock = threading.Lock()
        #: events recorded since clear(), and their counts by
        #: ``(cat, name)``: both survive wraparound and resize
        self._recorded = 0
        self._counts = {}

    def record(self, phase, cat, name, ts_ns, dur_ns, args=None,
               role=None, tid=None):
        """``tid`` defaults to the recording thread's ident."""
        event = (phase, cat, name, ts_ns, dur_ns,
                 threading.get_ident() if tid is None else int(tid),
                 args, role or self.role)
        key = (cat, name)
        with self._lock:
            self._ring[self._pos % self.capacity] = event
            self._pos += 1
            self._recorded += 1
            self._counts[key] = self._counts.get(key, 0) + 1

    def events(self):
        """Snapshot of the ring, oldest recorded → newest."""
        with self._lock:
            pos = self._pos
            ring = list(self._ring)
        n = min(pos, len(ring))
        return [ring[i % len(ring)] for i in range(pos - n, pos)]

    @property
    def recorded(self):
        """Events recorded since the last clear()."""
        return self._recorded

    @property
    def dropped(self):
        """Recorded events no longer in the ring."""
        with self._lock:
            return self._recorded - min(self._pos, self.capacity)

    def count(self, cat, name):
        """Events of ``(cat, name)`` recorded since clear() (survives
        wraparound)."""
        with self._lock:
            return self._counts.get((cat, name), 0)

    def category_counts(self):
        """``{category: events recorded since clear()}``."""
        with self._lock:
            items = list(self._counts.items())
        out = {}
        for (c, _n), k in items:
            out[c] = out.get(c, 0) + k
        return out

    def clear(self):
        """Drop every recorded event (keeps enabled/role)."""
        with self._lock:
            self._ring = [None] * self.capacity
            self._pos = 0
            self._recorded = 0
            self._counts = {}

    def resize(self, capacity):
        """Install a new ring capacity, keeping the newest events that
        fit (the JAX package's resize drops them all)."""
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError("trace capacity must be >= 1")
        with self._lock:
            ring, pos = self._ring, self._pos
            n = min(pos, len(ring), capacity)
            kept = [ring[i % len(ring)] for i in range(pos - n, pos)]
            self.capacity = capacity
            self._ring = kept + [None] * (capacity - n)
            self._pos = n


#: THE process-wide recorder every hook shares
recorder = TraceRecorder()


def span(cat, name, args=None, role=None):
    """Context manager timing a span (host clock).  Disabled: one
    attribute check, the shared no-op singleton."""
    rec = recorder
    if not rec.enabled:
        return NULL_SPAN
    return _Span(rec, cat, name, args, role)


def instant(cat, name, args=None, role=None):
    """Record a point event (Chrome phase ``i``)."""
    rec = recorder
    if not rec.enabled:
        return
    rec.record("i", cat, name, time.perf_counter_ns(), 0, args, role)


def counter(cat, name, value, role=None):
    """Record a counter sample (Chrome phase ``C``)."""
    rec = recorder
    if not rec.enabled:
        return
    rec.record("C", cat, name, time.perf_counter_ns(), 0,
               {"value": value}, role)


def complete(cat, name, begin_ns, dur_ns, args=None, role=None,
             tid=None):
    """Record a span retroactively from caller-held timestamps; ``tid``
    labels a synthetic lane."""
    rec = recorder
    if not rec.enabled:
        return
    rec.record("X", cat, name, int(begin_ns), int(dur_ns), args, role,
               tid=tid)


def enabled():
    """The hot-path switch, for call sites that skip building args."""
    return recorder.enabled


def set_role(role):
    """Re-label the events this process records from here on."""
    recorder.role = str(role)


def normalize(events=None):
    """Recorder tuples (the ring's, when None) → event dicts with
    timestamps in µs, as :func:`veles_tpu.trace.export.normalize` gives
    them."""
    if events is None:
        events = recorder.events()
    return [{"ph": phase, "cat": cat, "name": name, "ts_us": ts_ns / 1e3,
             "dur_us": dur_ns / 1e3, "tid": tid, "role": role,
             "args": args}
            for phase, cat, name, ts_ns, dur_ns, tid, args, role in events]


#: whether the exit-time save is registered (once a process)
_atexit_armed = [False]


def configure(value=None):
    """Apply the ``root.common.engine.trace`` knob (read fresh when
    ``value`` is None): ``off`` disables recording, ``on`` records to
    the ring, any other string is a path: record AND write a
    Perfetto-loadable Chrome trace-event JSON there at process exit (or
    through :func:`veles_tpu_torch.trace.export.save`).  Returns the
    enabled state.  ``root.common.engine.trace_capacity`` resizes the
    ring when it differs from the ring's capacity."""
    if value is None:
        value = root.common.engine.get("trace", "off")
    path = None
    if isinstance(value, str):
        low = value.strip().lower()
        if low in ("", "off", "0", "false", "no", "none"):
            on = False
        elif low in ("on", "1", "true", "yes"):
            on = True
        else:
            on = True
            path = value
    else:
        on = bool(value)
    capacity = root.common.engine.get("trace_capacity", None)
    if capacity and int(capacity) != recorder.capacity:
        recorder.resize(int(capacity))
    recorder.enabled = on
    recorder.path = path
    if path is not None and not _atexit_armed[0]:
        import atexit

        from veles_tpu_torch.trace import export
        _atexit_armed[0] = True
        atexit.register(export.save_at_exit)
    return on


# -- the guarded device-profiler bridge -------------------------------------

class _DeviceTrace(object):
    """Context manager running ``torch.profiler`` with CUDA activity
    around its block when a card is present, and writing the Chrome
    trace under ``logdir`` at exit; a no-op on the CPU, as the JAX
    package's bridge is on a CPU device.  ``bool(ctx)`` tells whether
    the profiler ran, ``ctx.path`` where its trace went and
    ``ctx.kernels()`` the names of the device kernels it saw."""

    def __init__(self, logdir=None):
        self._logdir = logdir
        self._profiler = None
        self.path = None

    def __bool__(self):
        return self._profiler is not None

    def __enter__(self):
        import torch
        if not torch.cuda.is_available():
            return self
        from torch.profiler import ProfilerActivity, profile
        self._profiler = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
        self._profiler.__enter__()
        return self

    def __exit__(self, *exc):
        if self._profiler is None:
            return False
        import os
        import torch
        torch.cuda.synchronize()
        self._profiler.__exit__(*exc)
        logdir = self._logdir
        if logdir is None:
            logdir = os.path.join(root.common.dirs.get("cache") or ".",
                                  "torch_trace")
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "device-%d-%d.json"
                                 % (os.getpid(), time.time_ns()))
        self._profiler.export_chrome_trace(self.path)
        return False

    def kernels(self):
        """Names of the device kernels the profiler recorded (empty
        when it did not run)."""
        if self._profiler is None:
            return []
        return sorted({event.name for event in self._profiler.events()
                       if getattr(event, "device_type", None) is not None
                       and "CUDA" in str(event.device_type)})


def device_trace(logdir=None):
    """Guarded bridge to the device profiler: ``torch.profiler`` with
    CUDA activity around a few warm steps gives the card's kernel
    timeline next to this module's host spans, written as a Chrome
    trace under ``logdir`` (``<root.common.dirs.cache>/torch_trace`` by
    default).  A no-op without a card."""
    return _DeviceTrace(logdir)
