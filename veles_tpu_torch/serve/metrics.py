"""Serving metrics: QPS, queue depth, batch-fill ratio, latency
percentiles.  The port's copy of :mod:`veles_tpu.serve.metrics`.

One :class:`ServingMetrics` instance is shared by the batcher (batch
stats, per-request latency) and the HTTP front end (shed counts); it
renders a Prometheus-style text page (``GET /metrics``) and a JSON
snapshot.  The latency histograms are
:class:`veles_tpu_torch.metrics.LatencyHistogram`.
"""

import collections
import threading
import time

from veles_tpu_torch.metrics import LatencyHistogram, emit_histogram


class ServingMetrics(object):
    """Aggregate serving counters + histograms (shared, thread-safe)."""

    #: sliding QPS window (seconds)
    QPS_WINDOW = 10.0

    def __init__(self):
        self.started = time.time()
        self._lock = threading.Lock()
        self.requests_total = 0
        self.rows_total = 0
        self.errors_total = 0
        self.shed_total = 0          # 503s (QueueFull)
        self.deadline_expired_total = 0   # 500s (InferDeadlineExceeded)
        self.batches_total = 0
        self.batch_rows_total = 0
        self.batch_capacity_total = 0
        self.request_latency = LatencyHistogram()
        self.batch_latency = LatencyHistogram()
        self._recent = collections.deque(maxlen=65536)  # completion ts
        #: gauge callables registered by owners (queue depth, model
        #: count, compile count, ...) — read at snapshot time
        self._gauges = {}
        #: extra LatencyHistograms registered by owners (the gen
        #: schedulers' TTFT), keyed (base_name, labels tuple) —
        #: rendered as full Prometheus histogram families
        self._histograms = {}

    # -- recording --------------------------------------------------------
    def observe_request(self, latency_s, rows=1, error=False):
        with self._lock:
            self.requests_total += 1
            self.rows_total += rows
            if error:
                self.errors_total += 1
            self._recent.append(time.time())
        self.request_latency.record(latency_s)

    def record_batch(self, rows, capacity, latency_s):
        with self._lock:
            self.batches_total += 1
            self.batch_rows_total += rows
            self.batch_capacity_total += capacity
        self.batch_latency.record(latency_s)

    def record_shed(self):
        with self._lock:
            self.shed_total += 1

    def record_deadline(self):
        """A batched infer blew root.common.serve.infer_deadline_ms —
        its requests failed with 500 instead of hanging."""
        with self._lock:
            self.deadline_expired_total += 1

    def register_gauge(self, name, fn):
        """Register a 0-arg callable polled at snapshot/render time."""
        with self._lock:
            self._gauges[name] = fn

    def unregister_gauge(self, name, fn=None):
        """Drop a gauge (stopped registries/batchers must not leave
        stale callables keeping dead engines alive).  Given ``fn``, only
        while ``name`` is still bound to it."""
        with self._lock:
            if fn is None or self._gauges.get(name) is fn:
                self._gauges.pop(name, None)

    @staticmethod
    def _hist_key(name, labels):
        return (name, tuple(sorted((labels or {}).items())))

    def register_histogram(self, name, hist, help_="", labels=None):
        """Register a :class:`~veles_tpu_torch.metrics.LatencyHistogram`
        for full Prometheus exposition on ``/metrics``.  ``labels``
        (e.g. ``{"model": "default"}``) land INSIDE each sample
        line's brace set next to ``le`` — the exposition-legal way to
        give every generative model its own TTFT family without
        mangling the metric name."""
        with self._lock:
            self._histograms[self._hist_key(name, labels)] = \
                (hist, help_, dict(labels or {}))

    def unregister_histogram(self, name, labels=None, hist=None):
        """Drop a histogram; given ``hist``, only while it is the one
        registered under ``name`` and ``labels``."""
        key = self._hist_key(name, labels)
        with self._lock:
            held = self._histograms.get(key)
            if hist is None or (held is not None and held[0] is hist):
                self._histograms.pop(key, None)

    def _histogram_items(self):
        with self._lock:
            return list(self._histograms.items())

    def _gauge_items(self):
        with self._lock:   # a deploy may register mid-scrape
            return list(self._gauges.items())

    # -- reading ----------------------------------------------------------
    def qps(self, window=None):
        window = window or self.QPS_WINDOW
        cutoff = time.time() - window
        with self._lock:
            n = sum(1 for t in self._recent if t >= cutoff)
        return n / window

    def batch_fill_ratio(self):
        with self._lock:
            if not self.batch_capacity_total:
                return 0.0
            return self.batch_rows_total / self.batch_capacity_total

    def snapshot(self):
        """JSON-ready dict — also the web_status payload shape."""
        data = {
            "uptime_sec": round(time.time() - self.started, 3),
            "qps": round(self.qps(), 3),
            "requests_total": self.requests_total,
            "rows_total": self.rows_total,
            "errors_total": self.errors_total,
            "shed_total": self.shed_total,
            "deadline_expired_total": self.deadline_expired_total,
            "batches_total": self.batches_total,
            "batch_fill_ratio": round(self.batch_fill_ratio(), 4),
            "latency_ms": {
                "mean": round(self.request_latency.mean * 1e3, 3),
                "p50": round(self.request_latency.percentile(50) * 1e3,
                             3),
                "p95": round(self.request_latency.percentile(95) * 1e3,
                             3),
                "p99": round(self.request_latency.percentile(99) * 1e3,
                             3),
            },
            "batch_latency_ms": {
                "mean": round(self.batch_latency.mean * 1e3, 3),
                "p50": round(self.batch_latency.percentile(50) * 1e3, 3),
                "p95": round(self.batch_latency.percentile(95) * 1e3, 3),
            },
        }
        for name, fn in self._gauge_items():
            try:
                data[name] = fn()
            except Exception:
                pass
        return data

    def render_text(self):
        """Prometheus-style exposition (the ``/metrics`` page)."""
        snap = self.snapshot()
        lines = []

        def emit(name, value, help_=None):
            if help_:
                lines.append("# HELP veles_serve_%s %s" % (name, help_))
            lines.append("veles_serve_%s %s" % (name, value))

        emit("uptime_seconds", snap["uptime_sec"])
        emit("qps", snap["qps"],
             "completed requests/sec over the last %ds window"
             % int(self.QPS_WINDOW))
        emit("requests_total", snap["requests_total"])
        emit("rows_total", snap["rows_total"])
        emit("errors_total", snap["errors_total"])
        emit("shed_total", snap["shed_total"],
             "requests rejected with 503 (queue full)")
        emit("deadline_expired_total", snap["deadline_expired_total"],
             "batches failed with 500 (infer deadline exceeded)")
        emit("batches_total", snap["batches_total"])
        emit("batch_fill_ratio", snap["batch_fill_ratio"],
             "served rows / summed bucket capacity")
        # the percentile text lines stay: the web status page (and
        # humans) read them; Prometheus scrapers get the real
        # histogram families below
        for key, value in snap["latency_ms"].items():
            emit("request_latency_ms{quantile=\"%s\"}" % key, value)
        for key, value in snap["batch_latency_ms"].items():
            emit("batch_latency_ms{quantile=\"%s\"}" % key, value)
        for name, _fn in self._gauge_items():
            if name in snap:
                emit(name, snap[name])
        self._emit_histogram(lines, "request_latency_seconds",
                             self.request_latency,
                             "request enqueue->reply latency")
        self._emit_histogram(lines, "batch_latency_seconds",
                             self.batch_latency,
                             "coalesced device-call latency")
        # one HELP/TYPE per family with every label variant grouped
        # under it — a second TYPE line for the same metric name is a
        # Prometheus text-format parse error that kills the whole
        # scrape, so per-model histograms must share one header
        families = {}
        for (name, _lbl), (hist, help_, labels) in sorted(
                self._histogram_items()):
            families.setdefault(name, []).append((hist, help_,
                                                  labels))
        for name, members in families.items():
            lines.append("# HELP veles_serve_%s %s"
                         % (name, members[0][1]))
            lines.append("# TYPE veles_serve_%s histogram" % name)
            for hist, _help, labels in members:
                self._emit_histogram(lines, name, hist, None,
                                     labels=labels)
        return "\n".join(lines) + "\n"

    @staticmethod
    def _emit_histogram(lines, name, hist, help_, labels=None):
        """Prometheus histogram exposition for a
        :class:`~veles_tpu_torch.metrics.LatencyHistogram` under the
        ``veles_serve_`` prefix, through the one shared renderer
        (:func:`veles_tpu_torch.metrics.emit_histogram`)."""
        emit_histogram(lines, "veles_serve_%s" % name, hist, help_,
                       labels=labels)
