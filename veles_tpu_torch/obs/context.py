"""Distributed request tracing: the identity that crosses threads and
processes.  The port's own copy of :mod:`veles_tpu.obs.context`.

A compact **trace context** (a 128-bit trace id plus the 64-bit span
id of the emitting hop) is minted at ingress (the serving HTTP front
door accepts and echoes the W3C ``traceparent`` header), carried on
request objects across thread handoffs (the batcher's worker) and
stamped into the span args of :mod:`veles_tpu_torch.trace`:
``{"trace": <32 hex>, "span": <16 hex>, "parent": <16 hex>}``.

Propagation: a thread-local current context (``activate()``), a
process default behind it (:func:`set_process`), and explicit wire
fields (:func:`wire_inject` / :func:`wire_extract`) for frames that
cross a process.

The disabled path: every entry point reads ``trace.recorder.enabled``
once and returns a shared no-op (``ingress``/``current``/``tag``
return ``None``/their argument, ``activate(None)`` returns the one
:data:`NULL_CONTEXT` singleton): no allocation, no id generation.
"""

import random
import threading

from veles_tpu_torch.trace.core import recorder

#: W3C trace-context version prefix this module emits
_VERSION = "00"
#: sampled flag — everything we mint is recorded (the knob IS the
#: sampler: tracing off mints nothing at all)
_FLAGS = "01"


class TraceContext(object):
    """One hop of a distributed trace: ``trace_id`` names the request,
    ``span_id`` names THIS hop, ``parent_id`` the hop that caused it."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id, span_id=None, parent_id=None):
        self.trace_id = trace_id
        self.span_id = span_id or _new_span_id()
        self.parent_id = parent_id

    def child(self):
        """A new hop of the same trace (fresh span id, this hop as
        parent) — what crosses each thread/process boundary."""
        return TraceContext(self.trace_id, _new_span_id(),
                            self.span_id)

    def traceparent(self):
        """The W3C header / wire encoding of this hop."""
        return "%s-%s-%s-%s" % (_VERSION, self.trace_id, self.span_id,
                                _FLAGS)

    def span_args(self, args=None):
        """``args`` (or a fresh dict) with the identity keys merged in
        — what tagged spans carry into the ring."""
        out = dict(args) if args else {}
        out["trace"] = self.trace_id
        out["span"] = self.span_id
        if self.parent_id:
            out["parent"] = self.parent_id
        return out

    def __repr__(self):
        return "<TraceContext %s span=%s parent=%s>" % (
            self.trace_id, self.span_id, self.parent_id)

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.parent_id == other.parent_id)


def _new_trace_id():
    # uniqueness, not cryptography (the W3C format asks no more);
    # getrandbits avoids a syscall on every traced request
    return "%032x" % random.getrandbits(128)


def _new_span_id():
    value = random.getrandbits(64)
    return "%016x" % (value or 1)   # all-zero span ids are invalid


def mint():
    """A brand-new root context (no parent)."""
    return TraceContext(_new_trace_id())


def parse(header):
    """``traceparent`` header → :class:`TraceContext`, or ``None`` on
    anything malformed (a bad header must degrade to a fresh mint,
    never to a 500)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(version, 16)
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    # the incoming span is the PARENT of everything we do with it
    return TraceContext(trace_id, _new_span_id(), span_id)


def ingress(header=None):
    """The front-door mint: continue the caller's trace when a valid
    ``traceparent`` came in, start a new one otherwise.  Returns
    ``None`` when tracing is off — ONE attribute check, nothing
    allocated (the disabled-path contract)."""
    if not recorder.enabled:
        return None
    return parse(header) or mint()


# -- propagation ------------------------------------------------------------

_local = threading.local()
#: the process-default context behind the thread-local (one slot, set
#: by set_process) — session-scoped identity for roles with no
#: per-request thread (the job master's pool workers)
_process = [None]


class _Activation(object):
    """Context manager installing a context as the thread-local
    current one (restoring the previous on exit)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        self._prev = getattr(_local, "ctx", None)
        _local.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _local.ctx = self._prev
        return False


class _NullActivation(object):
    """The shared no-op ``activate(None)`` returns — entering and
    exiting allocate nothing and touch no thread-local."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


#: the one disabled-path activation singleton
NULL_CONTEXT = _NullActivation()


def activate(ctx):
    """``with activate(ctx):`` makes ``ctx`` the current context on
    this thread.  ``activate(None)`` is the shared no-op singleton."""
    if ctx is None:
        return NULL_CONTEXT
    return _Activation(ctx)


def set_process(ctx):
    """Install (or clear, with ``None``) the process-default context —
    the fallback :func:`current` uses when the calling thread has no
    activation.  Returns the previous default."""
    previous = _process[0]
    _process[0] = ctx
    return previous


def current():
    """The context in effect: this thread's activation, else the
    process default, else ``None``.  One attribute check when tracing
    is off."""
    if not recorder.enabled:
        return None
    ctx = getattr(_local, "ctx", None)
    return ctx if ctx is not None else _process[0]


def current_trace_id():
    """``current().trace_id`` or ``None`` — for call sites that stash
    just the id (the gen engine's per-slot tags)."""
    ctx = current()
    return ctx.trace_id if ctx is not None else None


def tag(args=None):
    """Merge the current context's identity into span ``args``.
    Disabled (or no context): returns ``args`` UNCHANGED — same
    object, no copy.  Resolution is :func:`current`'s, by
    construction (one source for the thread-local/process-default
    chain); the early enabled check keeps the disabled path at one
    attribute read."""
    if not recorder.enabled:
        return args
    ctx = current()
    return args if ctx is None else ctx.span_args(args)


# -- the ZMQ wire -----------------------------------------------------------

#: the frame key job/update/lease/pod_epoch messages carry
WIRE_KEY = "tp"


def wire_inject(msg, ctx=None):
    """Stamp the current (or given) context's ``traceparent`` into a
    wire frame dict as a CHILD hop (the receiver's spans parent to the
    sender's).  No-op — same dict back, untouched — when tracing is
    off or no context is in effect."""
    if ctx is None:
        ctx = current()
    if ctx is not None:
        msg[WIRE_KEY] = ctx.child().traceparent()
    return msg


def wire_extract(msg):
    """The receiving half: a frame's ``tp`` field → a context to
    activate around the work it causes.  ``None`` when tracing is off
    here or the frame carries nothing parseable."""
    if not recorder.enabled:
        return None
    return parse(msg.get(WIRE_KEY))


# -- waterfall introspection ------------------------------------------------

def spans_of(events, trace_id):
    """Every normalized span/instant of one trace id, sorted by
    timestamp — the per-request waterfall over a live ring snapshot or
    a merged session bundle (``prof merge``).  Matches both the
    singular ``trace`` tag and membership in a shared dispatch's
    ``traces`` list (the batcher's coalesced call, the gen engine's
    decode step serving several co-residents at once)."""
    out = []
    for ev in events:
        args = ev.get("args") or {}
        if args.get("trace") == trace_id \
                or trace_id in (args.get("traces") or ()):
            out.append(ev)
    out.sort(key=lambda ev: ev.get("ts_us", 0.0))
    return out


def role_lanes(events, trace_id):
    """{role: [event names]} for one trace id — the acceptance probe:
    a traced ``/generate`` request must light the server, scheduler/
    engine and at least one ZMQ-remote lane in one timeline."""
    lanes = {}
    for ev in spans_of(events, trace_id):
        lanes.setdefault(ev.get("role") or "trainer", []).append(
            ev.get("name"))
    return lanes


def waterfall_text(events, trace_id):
    """Human rendering of one request's cross-process waterfall:
    every tagged span in time order with role, duration and phase
    name — queue wait / batch fill / prefill chunks / decode separate
    per request by construction (each phase is its own tagged span)."""
    spans = spans_of(events, trace_id)
    if not spans:
        return "no spans for trace %s\n" % trace_id
    t0 = spans[0].get("ts_us", 0.0)
    lines = ["trace %s — %d event(s) across %d role(s)"
             % (trace_id, len(spans),
                len({ev.get("role") for ev in spans}))]
    for ev in spans:
        lines.append(
            "  +%9.3f ms %8s %-10s %s:%s%s"
            % ((ev.get("ts_us", 0.0) - t0) / 1e3,
               ("%.3f ms" % (ev.get("dur_us", 0.0) / 1e3))
               if ev.get("ph") == "X" else "-",
               ev.get("role") or "trainer", ev.get("cat"),
               ev.get("name"),
               " [span %s]" % (ev.get("args") or {}).get("span", "")))
    return "\n".join(lines) + "\n"
