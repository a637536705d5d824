"""Flight recorder: a loadable post-mortem from any traced role.

The port's counterpart of :mod:`veles_tpu.obs.blackbox`, with the same
payload keys.

A crashed process takes its trace ring and perf ledger with it — the
two artifacts that would have said what it was doing.  This module is
the aviation fix: when ``root.common.obs.blackbox_dir`` is set, every
fatal exit path dumps a compact JSON post-mortem there —

* the live trace ring (normalized events, newest ``capacity`` of
  them) and its wraparound-proof per-category counts,
* the perf-ledger summary (compiles, recompiles, per-program rows,
  device memory by category),
* the ``"watch"`` block when there is something to put in it: the last
  training-health snapshot and the newest telemetry-bus events,
* the role, pid, reason and wall-clock time of death —

via three hooks: ``sys.excepthook`` and ``threading.excepthook``
(unhandled exceptions, the serving workers included), a direct
:func:`dump` call with a recorded reason, and a ``SIGTERM`` handler
(installed only when the knob is set AND the process owns its signal
disposition — never under pytest).

Writes are atomic (tmp + rename): a crash mid-dump leaves the
previous post-mortem intact, never a torn file.  :func:`load`
validates the kind tag so tooling can trust what it parses.
"""

import json
import os
import sys
import time

from veles_tpu_torch.config import root

#: the post-mortem file's kind tag (load() validates it); the JAX
#: package's, so its tooling reads the port's post-mortems
KIND = "veles_tpu.obs.blackbox"

#: how many newest trace events a post-mortem keeps (bounds the file;
#: the interesting events are the last ones by construction)
MAX_EVENTS = 8192

#: how many newest telemetry-bus events ride along in the "watch"
#: block (bounded by the bus's own history ring anyway)
MAX_BUS_EVENTS = 64

_installed = [False]
_prev_excepthook = [None]
_prev_thread_hook = [None]


def blackbox_dir():
    """The knob: a non-empty ``root.common.obs.blackbox_dir`` arms
    every dump site; empty/unset keeps them all no-ops."""
    node = root.common.get("obs")
    if node is None:
        return None
    value = node.get("blackbox_dir") if hasattr(node, "get") else None
    return str(value) if value else None


def dump(reason, directory=None, extra=None):
    """Write one post-mortem; returns its path, or ``None`` when no
    directory is configured (the disarmed no-op every crash site may
    call unconditionally).  Never raises — a flight recorder that
    crashes the crash handler recorded nothing."""
    directory = directory or blackbox_dir()
    if not directory:
        return None
    try:
        from veles_tpu_torch import prof, trace
        events = trace.normalize()
        if len(events) > MAX_EVENTS:
            events = events[-MAX_EVENTS:]
        payload = {
            "kind": KIND,
            "reason": str(reason),
            "role": trace.recorder.role,
            "pid": os.getpid(),
            "time": time.time(),
            "trace_enabled": trace.enabled(),
            "events": events,
            "event_counts": trace.recorder.category_counts(),
            "ledger": prof.summary(),
        }
        from veles_tpu_torch import watch
        health = watch.last_health()
        bus_events = watch.recent_events(MAX_BUS_EVENTS)
        if health is not None or bus_events:
            payload["watch"] = {"health": health, "events": bus_events}
        if extra:
            payload["extra"] = dict(extra)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory, "blackbox-%s-%d-%d.json"
            % (trace.recorder.role.replace("/", "_"), os.getpid(),
               int(time.time() * 1e3)))
        tmp = path + ".tmp"
        with open(tmp, "w") as fout:
            # default=repr: a single odd value anywhere in the
            # payload (a provider-returned numpy scalar riding a bus
            # event, an exotic ledger field) must degrade to its repr
            # — never cost the whole flight record
            json.dump(payload, fout, default=repr)
        os.replace(tmp, path)
        return path
    except Exception:  # pragma: no cover - the recorder must not crash
        return None


def load(path):
    """Read a post-mortem back; raises ``ValueError`` on anything
    that is not one (tooling must not misread arbitrary JSON as
    evidence)."""
    with open(path, "r") as fin:
        payload = json.load(fin)
    if not isinstance(payload, dict) or payload.get("kind") != KIND:
        raise ValueError("%s is not a %s post-mortem" % (path, KIND))
    return payload


def _excepthook(tp, value, tb):
    dump("unhandled exception: %s: %s" % (tp.__name__, value))
    prev = _prev_excepthook[0] or sys.__excepthook__
    prev(tp, value, tb)


def _thread_excepthook(hook_args):
    # every role here RUNS on a thread (the job server loop, client
    # compute/heartbeat, batcher/scheduler workers) — sys.excepthook
    # never sees those, threading.excepthook does
    dump("unhandled exception in thread %s: %s: %s"
         % (getattr(hook_args.thread, "name", "?"),
            hook_args.exc_type.__name__, hook_args.exc_value))
    prev = _prev_thread_hook[0]
    if prev is not None:
        prev(hook_args)


def install(directory=None, signals=True):
    """Arm the excepthooks (process AND thread — the job/serving
    roles all run on threads) plus ``SIGTERM`` when safe, once per
    process.  Idempotent; a no-op when no directory is configured."""
    import threading
    if not (directory or blackbox_dir()):
        return False
    if _installed[0]:
        return True
    _installed[0] = True
    _prev_excepthook[0] = sys.excepthook
    sys.excepthook = _excepthook
    _prev_thread_hook[0] = threading.excepthook
    threading.excepthook = _thread_excepthook
    if signals:
        try:
            import signal
            import threading
            if threading.current_thread() \
                    is threading.main_thread() \
                    and signal.getsignal(signal.SIGTERM) \
                    is signal.SIG_DFL:
                def _on_term(signum, frame):
                    dump("fatal signal SIGTERM")
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

                signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError):  # non-main thread / odd platform
            pass
    return True


def uninstall():
    """Test hygiene: restore the previous excepthooks."""
    import threading
    if not _installed[0]:
        return
    _installed[0] = False
    if sys.excepthook is _excepthook:
        sys.excepthook = _prev_excepthook[0] or sys.__excepthook__
    _prev_excepthook[0] = None
    if threading.excepthook is _thread_excepthook:
        threading.excepthook = _prev_thread_hook[0] \
            or threading.__excepthook__
    _prev_thread_hook[0] = None


def configure():
    """Apply the knob (called from ``obs.configure()`` at the same
    boundaries trace/chaos re-read theirs): arm when the directory is
    set, leave everything untouched otherwise."""
    return install()
