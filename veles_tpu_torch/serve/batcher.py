"""DynamicBatcher: coalesce concurrent requests into one bucket call.
The port's copy of :mod:`veles_tpu.serve.batcher`.

N concurrent requests become one padded bucket call of the engine (one
CUDA graph replay on the card) instead of N serialized forwards.

Policy: ``max_batch_size`` (never more rows than this in one call, the
engine's largest bucket) and ``max_wait_ms`` (a request never waits
longer than this for co-travellers; the first request into an empty
queue starts the timer).

Backpressure: the queue is bounded (``max_queue_rows``); a full queue
raises :class:`QueueFull` at ``submit`` (the HTTP layer's ``503
Retry-After``) instead of letting latency grow without bound.

Hot swap: the worker reads ``self.engine`` once per batch, so a
registry swap (plain attribute assignment) takes effect at the next
batch boundary while the in-flight call finishes on the old engine.

``root.common.serve.infer_deadline_ms`` (re-read per batch) bounds one
bucket call: a blown deadline fails the batch's requests with
:class:`InferDeadlineExceeded`, and at most ``MAX_WEDGED_INFERS`` such
calls may still be running before new batches fail fast.
"""

import collections
import threading
import time
from concurrent.futures import Future

import numpy

from veles_tpu_torch import trace
from veles_tpu_torch.logger import Logger


class QueueFull(RuntimeError):
    """Request rejected: the batch queue is at capacity."""

    #: wire hint for the HTTP layer's Retry-After header
    retry_after = 1


class InferDeadlineExceeded(RuntimeError):
    """A batched device call blew the ``root.common.serve
    .infer_deadline_ms`` deadline: the batch's futures fail with THIS
    typed error (the HTTP layer maps any future exception to 500), so
    a hung device degrades to failed requests instead of a queue of
    clients blocked forever behind a wedged worker."""


class _Pending(object):
    __slots__ = ("rows", "future", "enqueued", "ctx")

    def __init__(self, rows, ctx=None):
        self.rows = rows
        self.future = Future()
        self.enqueued = time.perf_counter()
        #: the submitting thread's distributed-trace context (None
        #: when tracing is off) — the worker thread stamps it onto
        #: this request's spans; request identity survives the
        #: thread handoff this way
        self.ctx = ctx


class DynamicBatcher(Logger):
    """Micro-batching queue in front of an :class:`InferenceEngine`."""

    #: deadline-blown infer calls still wedged on the device before new
    #: batches fail fast instead of spawning yet another worker — bounds
    #: both thread/batch-memory pileup under sustained blowouts and the
    #: number of concurrent engine.infer calls racing a wedged one
    MAX_WEDGED_INFERS = 2

    def __init__(self, engine, max_batch_size=None, max_wait_ms=2.0,
                 max_queue_rows=1024, metrics=None, gauge_name=None,
                 **kwargs):
        super(DynamicBatcher, self).__init__(**kwargs)
        #: swappable current engine (see module docstring: read once
        #: per batch, assignment is the whole hot-swap protocol)
        self.engine = engine
        self.max_batch_size = int(max_batch_size
                                  or engine.max_batch_size)
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_queue_rows = int(max_queue_rows)
        self.metrics = metrics
        self._queue = collections.deque()
        self._queued_rows = 0
        self._cond = threading.Condition()
        self._stopped = False
        #: finished-flags of abandoned deadline workers (worker-thread
        #: private; pruned once their wedged infer finally returns)
        self._wedged = []
        if metrics is not None:
            # gauge_name lets a multi-model registry give each
            # batcher its own gauge instead of the last deploy
            # shadowing every other model's queue
            metrics.register_gauge(gauge_name or "queue_depth",
                                   self.queue_depth)
        self._thread = threading.Thread(target=self._worker,
                                        daemon=True,
                                        name="serve-batcher")
        self._thread.start()

    def queue_depth(self):
        return self._queued_rows

    # -- client side ------------------------------------------------------
    def submit(self, rows):
        """Enqueue a request's rows; returns a Future resolving to the
        corresponding output rows.  Raises :class:`QueueFull` when the
        bounded queue cannot take the rows (shed, don't stall) and
        ``ValueError`` on a sample-shape mismatch (reject at the door:
        a mis-shaped request coalesced into a batch would otherwise
        fail the whole batch's concatenate)."""
        rows = numpy.ascontiguousarray(rows, dtype=numpy.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        expected = getattr(self.engine, "sample_shape", None)
        if expected is not None and rows.shape[1:] != tuple(expected):
            raise ValueError(
                "sample shape %s does not match the served model's %s"
                % (rows.shape[1:], tuple(expected)))
        if len(rows) > self.max_queue_rows:
            # non-retryable by construction (it could never fit): a
            # deterministic ValueError → 400, not a 503 the client
            # would retry forever under sustained traffic
            raise ValueError(
                "request of %d rows exceeds the queue bound %d — "
                "split the request or raise max_queue_rows"
                % (len(rows), self.max_queue_rows))
        ctx = None
        if trace.enabled():
            from veles_tpu_torch.obs import context as obs_context
            ctx = obs_context.current()
            args = {"rows": len(rows)}
            if ctx is not None:
                args = ctx.span_args(args)
            trace.instant("serve", "enqueue", args, role="server")
        pending = _Pending(rows, ctx)
        with self._cond:
            if self._stopped:
                raise RuntimeError("batcher is stopped")
            if self._queued_rows + len(rows) > self.max_queue_rows:
                if self.metrics is not None:
                    self.metrics.record_shed()
                raise QueueFull(
                    "serving queue full (%d rows queued, limit %d)"
                    % (self._queued_rows, self.max_queue_rows))
            self._queue.append(pending)
            self._queued_rows += len(rows)
            self._cond.notify()
        return pending.future

    def infer(self, rows, timeout=30.0):
        """Blocking convenience: ``submit`` + ``result``."""
        return self.submit(rows).result(timeout)

    # -- worker side ------------------------------------------------------
    def _take_batch(self):
        """Wait for work, give co-travellers ``max_wait`` to arrive,
        then pop whole requests up to ``max_batch_size`` rows (an
        oversized request is taken alone; the engine chunks it)."""
        with self._cond:
            while not self._queue:
                if self._stopped:
                    return None
                self._cond.wait()
            deadline = self._queue[0].enqueued + self.max_wait
            while (self._queued_rows < self.max_batch_size
                   and not self._stopped):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            taken, rows = [], 0
            while self._queue:
                nxt = self._queue[0]
                # a sample-shape boundary ends the batch: across an
                # allow_reshape hot swap the queue may hold mixed
                # widths, and one request's shape must never poison
                # its co-travellers' concatenate
                if taken and (rows + len(nxt.rows) > self.max_batch_size
                              or nxt.rows.shape[1:]
                              != taken[0].rows.shape[1:]):
                    break
                pending = self._queue.popleft()
                taken.append(pending)
                rows += len(pending.rows)
            self._queued_rows -= rows
            return taken

    def _infer_bounded(self, engine, batch):
        """One device call, optionally under the
        ``root.common.serve.infer_deadline_ms`` deadline (re-read per
        batch, so it can be armed on a live service).  0/off keeps the
        direct zero-overhead call.  Armed, the call runs on a
        per-batch DAEMON thread — not the shared host pool (which also
        serves job generation and checkpoint writes and must never be
        starved by a wedged device), and not a ThreadPoolExecutor
        (whose non-daemon worker would be joined by the
        concurrent.futures atexit hook, so one wedged call would hang
        process shutdown forever).  A blown deadline raises
        :class:`InferDeadlineExceeded` and ABANDONS the thread (the
        wedged call cannot be cancelled — no device API aborts a
        dispatched program); being a daemon it can never block exit,
        and the next batch gets a fresh thread.  Abandoned calls are
        BOUNDED: once :data:`MAX_WEDGED_INFERS` of them are still
        wedged, further batches fail fast with the same typed error
        instead of stacking more threads (and more captured batch
        arrays, and more concurrent engine.infer calls) behind a
        device that clearly isn't coming back."""
        from veles_tpu_torch.config import root
        deadline_ms = float(
            root.common.serve.get("infer_deadline_ms", 0) or 0)
        if deadline_ms <= 0:
            return engine.infer(batch)
        self._wedged = [ev for ev in self._wedged if not ev.is_set()]
        if len(self._wedged) >= self.MAX_WEDGED_INFERS:
            raise InferDeadlineExceeded(
                "%d earlier deadline-blown infer call(s) are still "
                "wedged on the device — failing this batch of %d rows "
                "fast instead of stacking another"
                % (len(self._wedged), len(batch)))
        outcome = {}
        finished = threading.Event()

        def _call():
            try:
                outcome["out"] = engine.infer(batch)
            except BaseException as e:  # noqa: BLE001 - relayed below
                outcome["exc"] = e
            finally:
                finished.set()

        worker = threading.Thread(target=_call, daemon=True,
                                  name="serve-infer-deadline")
        worker.start()
        if not finished.wait(deadline_ms / 1e3):
            self._wedged.append(finished)
            raise InferDeadlineExceeded(
                "batched infer of %d rows exceeded the %.0f ms "
                "deadline (root.common.serve.infer_deadline_ms)"
                % (len(batch), deadline_ms)) from None
        if "exc" in outcome:
            raise outcome["exc"]
        return outcome["out"]

    def _worker(self):
        while True:
            taken = self._take_batch()
            if taken is None:
                return
            # a client that gave up (request timeout → Future.cancel)
            # must not cost a device call: claim each future, drop the
            # cancelled ones here
            taken = [p for p in taken
                     if p.future.set_running_or_notify_cancel()]
            if not taken:
                continue
            engine = self.engine      # pin for this batch (hot swap)
            tic = time.perf_counter()
            try:
                # batch formation INSIDE the try: a heterogeneous
                # batch (possible when the engine declares no
                # sample_shape for submit() to check) must fail these
                # requests, never kill the worker thread
                if len(taken) == 1:
                    batch = taken[0].rows
                else:
                    batch = numpy.concatenate([p.rows for p in taken])
                infer_args = None
                if trace.enabled():
                    # which requests this device call served — the
                    # batch-fill-wait half of each one's waterfall
                    traces = sorted({p.ctx.trace_id for p in taken
                                     if p.ctx is not None})
                    if traces:
                        infer_args = {"traces": traces}
                with trace.span("serve", "batch_infer", infer_args,
                                role="server"):
                    out = self._infer_bounded(engine, batch)
            except Exception as exc:  # noqa: BLE001 - fan the error out
                self.warning("batched inference failed: %s", exc)
                if self.metrics is not None and \
                        isinstance(exc, InferDeadlineExceeded):
                    self.metrics.record_deadline()
                if trace.enabled() and \
                        isinstance(exc, InferDeadlineExceeded):
                    trace.instant("serve", "infer_deadline",
                                  {"rows": len(batch)}, role="server")
                for pending in taken:
                    pending.future.set_exception(exc)
                if self.metrics is not None:
                    done = time.perf_counter()
                    for pending in taken:
                        self.metrics.observe_request(
                            done - pending.enqueued,
                            rows=len(pending.rows), error=True)
                continue
            done = time.perf_counter()
            if self.metrics is not None:
                # honest fill denominator: the bucket rows the engine
                # ACTUALLY occupied, chunk splits included
                capacity = engine.padded_capacity(len(batch)) \
                    if hasattr(engine, "padded_capacity") \
                    else self.max_batch_size
                self.metrics.record_batch(len(batch), capacity,
                                          done - tic)
            traced = trace.enabled()
            offset = 0
            for pending in taken:
                n = len(pending.rows)
                pending.future.set_result(out[offset:offset + n])
                offset += n
                if self.metrics is not None:
                    self.metrics.observe_request(done - pending.enqueued,
                                                 rows=n)
                if traced:
                    # retroactive enqueue→reply span (same clock:
                    # _Pending stamps time.perf_counter at submit)
                    args = {"rows": n}
                    if pending.ctx is not None:
                        args = pending.ctx.span_args(args)
                    trace.complete(
                        "serve", "request",
                        int(pending.enqueued * 1e9),
                        int((done - pending.enqueued) * 1e9),
                        args, role="server")

    def stop(self, drain=True):
        """Stop the worker.  ``drain=True`` serves what is queued
        first; otherwise queued futures fail."""
        with self._cond:
            self._stopped = True
            if not drain:
                leftovers = list(self._queue)
                self._queue.clear()
                self._queued_rows = 0
            else:
                leftovers = []
            self._cond.notify_all()
        for pending in leftovers:
            if pending.future.set_running_or_notify_cancel():
                pending.future.set_exception(
                    RuntimeError("batcher stopped"))
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            # a hung device call: don't pretend the drain finished —
            # fail whatever is still queued so no client blocks on an
            # abandoned future
            self.warning("batcher worker still busy after 10s; "
                         "failing queued requests")
            with self._cond:
                stuck = list(self._queue)
                self._queue.clear()
                self._queued_rows = 0
            for pending in stuck:
                if pending.future.set_running_or_notify_cancel():
                    pending.future.set_exception(
                        RuntimeError("batcher stopped with the worker "
                                     "wedged in a device call"))
