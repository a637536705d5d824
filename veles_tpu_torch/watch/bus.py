"""The live telemetry bus: a drop-tolerant ZMQ PUB fan-out.

The port's own copy of :mod:`veles_tpu.watch.bus`.  Training publishes,
any number of viewers attach and detach at will, and a dead viewer
never slows the run: JSON snapshot events (health stats, epoch metrics,
perf ledger digests, serving gauges).

pyzmq is imported when a bus or a reader is made, never when this
module is imported: the health statistics, the ledger and the rest of
:mod:`veles_tpu_torch.watch` work on an installation without it, and
:class:`TelemetryBus` then raises an ``ImportError`` that says so.

* **PUB semantics** — ZeroMQ PUB never blocks on send: with no
  subscriber the frame is dropped at the socket, and a slow
  subscriber's queue is bounded by ``SNDHWM`` (overflow drops the
  newest frames for that peer).  Publishing is additionally
  ``NOBLOCK`` so even a pathological transport state cannot stall a
  train step or a decode step — the publisher-side guarantee the
  drop-tolerance tests assert with a wall-clock bound.
* **Host-side conflation** — the bus keeps the newest event per kind
  (``latest``) plus a bounded ``history`` ring, so a late-joining
  dashboard, a scrape or an ``obs.blackbox`` post-mortem
  can read the current state without having subscribed in time.  The
  optional ``conflate=True`` additionally sets ``ZMQ_CONFLATE`` on
  the socket (keep-only-last wire semantics — collapses *across*
  kinds, so it is off by default).
* **Wire format** — one single-frame UTF-8 JSON object per event:
  ``{"kind", "ts", "seq", "role", ...payload}``.  Single-frame so
  conflating subscribers stay legal; ``seq`` lets a reader count its
  own gaps.

Readers (:class:`TelemetryReader`) are plain SUB sockets;
``python -m veles_tpu_torch.watch <endpoint>`` wraps one in a live
terminal dashboard with ``--record file.ndjson`` persistence.
"""

import collections
import json
import math
import threading
import time

from veles_tpu_torch.logger import Logger


def _import_zmq():
    """pyzmq, or an ``ImportError`` naming what needs it."""
    try:
        import zmq
    except ImportError as exc:
        raise ImportError(
            "the telemetry bus (veles_tpu_torch.watch.start, "
            "root.common.watch.endpoint) needs pyzmq, which this "
            "installation lacks; the health statistics and the ledger "
            "work without it") from exc
    return zmq


def _json_safe(value):
    """Recursively replace non-finite floats with their repr strings
    ("inf"/"-inf"/"nan"): the wire contract is strict RFC-8259 JSON,
    and a bare ``Infinity`` token (python's ``allow_nan`` extension)
    would break every non-python subscriber and ``jq`` over a
    recorded session."""
    if isinstance(value, float) and not math.isfinite(value):
        return repr(value)
    if isinstance(value, dict):
        return {key: _json_safe(val) for key, val in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(val) for val in value]
    return value


class TelemetryBus(Logger):
    """One PUB endpoint; create via :func:`veles_tpu_torch.watch.start`
    (or the ``root.common.watch.endpoint`` knob at
    ``Workflow.initialize``)."""

    def __init__(self, endpoint="tcp://127.0.0.1:0", hwm=64,
                 history=256, conflate=False, **kwargs):
        super(TelemetryBus, self).__init__(**kwargs)
        zmq = _import_zmq()
        self._zmq = zmq
        self._context = zmq.Context.instance()
        self._socket = self._context.socket(zmq.PUB)
        # bounded send queue per subscriber + zero linger: a dead or
        # slow peer costs at most `hwm` buffered frames and teardown
        # never waits on undelivered telemetry
        self._socket.setsockopt(zmq.SNDHWM, int(hwm))
        self._socket.setsockopt(zmq.LINGER, 0)
        if conflate:
            self._socket.setsockopt(zmq.CONFLATE, 1)
        # the config knob documents shorthand forms (":0" for a
        # random local port, a bare port number) — normalize them to
        # a full tcp endpoint instead of handing libzmq an empty host
        if "://" not in endpoint:
            endpoint = "tcp://127.0.0.1" + (
                endpoint if endpoint.startswith(":")
                else ":" + endpoint)
        if endpoint.endswith(":0"):
            port = self._socket.bind_to_random_port(
                endpoint.rsplit(":", 1)[0])
            self.endpoint = "%s:%d" % (endpoint.rsplit(":", 1)[0],
                                       port)
        else:
            self._socket.bind(endpoint)
            self.endpoint = endpoint
        self.hwm = int(hwm)
        self.published = 0
        #: NOBLOCK sends the transport refused (EAGAIN) — the frame
        #: was dropped instead of stalling the caller.  Socket-level
        #: HWM drops are invisible by PUB design and not counted here.
        self.dropped = 0
        #: "_"-prefixed control frames sent (reader join probes) —
        #: on the wire but never in latest/history/published, so
        #: blackbox tails and /metrics counters carry telemetry only
        self.control = 0
        self._seq = 0
        #: newest event per kind (host-side conflation)
        self.latest = {}
        #: newest `history` events across kinds (the blackbox tail)
        self.history = collections.deque(maxlen=int(history))
        self._lock = threading.Lock()
        self._closed = False
        self.info("telemetry bus on %s", self.endpoint)

    def publish(self, kind, payload=None):
        """Publish one event; NEVER blocks.  Returns the stamped
        event dict — the JSON-round-tripped copy, so the host-side
        ``latest``/``history`` state is byte-equal to what a
        subscriber received (and an ``obs.blackbox`` post-mortem can
        always re-serialize it).  A payload that cannot serialize at
        all is neither sent nor recorded."""
        from veles_tpu_torch import trace
        event = {"kind": str(kind), "ts": time.time(),
                 "role": trace.recorder.role}
        if payload:
            for key, value in payload.items():
                if key not in event:
                    event[key] = value
        with self._lock:
            if self._closed:
                return event
            self._seq += 1
            event["seq"] = self._seq
            # serialize BEFORE recording: latest/history must only
            # ever hold wire-equal, re-serializable events — and
            # strictly valid JSON (a diverged run's inf/nan stats
            # degrade to repr strings, never to bare Infinity tokens)
            try:
                try:
                    blob = json.dumps(event, default=repr,
                                      allow_nan=False).encode()
                except ValueError:
                    blob = json.dumps(_json_safe(event), default=repr,
                                      allow_nan=False).encode()
            except (TypeError, ValueError):
                self.warning("unserializable %r event dropped", kind)
                return event
            event = json.loads(blob.decode("utf-8"))
            control = event["kind"].startswith("_")
            if not control:
                self.latest[event["kind"]] = event
                self.history.append(event)
            try:
                self._socket.send(blob, self._zmq.NOBLOCK)
                if control:
                    self.control += 1
                else:
                    self.published += 1
            except self._zmq.Again:
                self.dropped += 1
        return event

    def recent(self, limit=64):
        """The newest ``limit`` events, copied under the lock — the
        blackbox tail must never race a mid-publish append (a deque
        mutated during iteration would cost the whole post-mortem)."""
        with self._lock:
            events = list(self.history)
        return events[-int(limit):]

    def latest_events(self, kind=None):
        """Newest event per kind (one kind's, or a copy of all),
        under the lock."""
        with self._lock:
            if kind is not None:
                return self.latest.get(kind)
            return dict(self.latest)

    def describe(self):
        with self._lock:
            return {"endpoint": self.endpoint, "hwm": self.hwm,
                    "published": self.published,
                    "dropped": self.dropped,
                    "kinds": sorted(self.latest)}

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._socket.close(linger=0)


class TelemetryReader(Logger):
    """A SUB-socket consumer (dashboard / tests / recorders)."""

    def __init__(self, endpoint, hwm=1024, conflate=False, **kwargs):
        super(TelemetryReader, self).__init__(**kwargs)
        zmq = _import_zmq()
        self._zmq = zmq
        self._context = zmq.Context.instance()
        self._socket = self._context.socket(zmq.SUB)
        self._socket.setsockopt(zmq.RCVHWM, int(hwm))
        self._socket.setsockopt(zmq.LINGER, 0)
        if conflate:
            self._socket.setsockopt(zmq.CONFLATE, 1)
        self._socket.setsockopt(zmq.SUBSCRIBE, b"")
        self._socket.connect(endpoint)
        self.endpoint = endpoint
        self.received = 0
        self.decode_errors = 0
        #: events consumed by sync() while probing for the join —
        #: handed back by the next poll() so joining a bus mid-session
        #: never swallows real traffic
        self._pending = collections.deque()

    def poll(self, timeout_ms=100):
        """One event (dict) or ``None`` after ``timeout_ms``."""
        if self._pending:
            return self._pending.popleft()
        if not self._socket.poll(timeout_ms):
            return None
        blob = self._socket.recv()
        try:
            event = json.loads(blob.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            self.decode_errors += 1
            return None
        self.received += 1
        return event

    def drain(self, timeout_ms=0):
        """Every event currently queued (each popped with at most
        ``timeout_ms`` of extra waiting)."""
        events = []
        while True:
            event = self.poll(timeout_ms)
            if event is None:
                return events
            events.append(event)

    def sync(self, bus, timeout_s=5.0):
        """Defeat the PUB/SUB slow-joiner race: publish ``_sync``
        markers on ``bus`` until one arrives here (True) or the
        deadline passes (False).  Events published before sync
        returns True may not have been delivered — test/smoke
        publishers call this FIRST."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            bus.publish("_sync", {})
            event = self.poll(100)
            if event is not None:
                if event.get("kind") != "_sync":
                    # real traffic: already joined — hand the probed
                    # event back to the next poll(), never drop it
                    self._pending.append(event)
                return True
        return False

    def close(self):
        self._socket.close(linger=0)


def record_events(events, path):
    """Append events to an ndjson file (the ``--record`` format: one
    JSON object per line)."""
    with open(path, "a") as fout:
        for event in events:
            fout.write(json.dumps(event, default=repr) + "\n")
    return len(events)


def load_events(path):
    """Read a recorded ndjson session back (blank lines skipped)."""
    events = []
    with open(path, "r") as fin:
        for line in fin:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events
