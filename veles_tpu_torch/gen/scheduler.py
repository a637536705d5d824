"""Continuous-batching scheduler: iteration-level admission over the
engine's slots.

Counterpart of :mod:`veles_tpu.gen.scheduler`.  Requests are admitted
into open KV-cache slots at EVERY decode iteration and evicted the
moment they finish, so the decode step's fixed ``max_slots`` rows stay
as full as the arrival process allows.  One scheduler thread owns the
engine; ``submit`` only touches the bounded queue (:class:`QueueFull`
on overflow).  Tokens stream per request through ``on_token``
callbacks; the request future resolves with the full greedy token list
at eviction.

Against a paged engine the loop gains three moves: admission is priced
by the pool's actual headroom (``engine.can_admit``, FIFO, no
overtaking the head); a chunked prefill feeds exactly one chunk per
step, so co-resident decodes keep their cadence; and pool exhaustion
preempts the YOUNGEST sequence, whose pages are freed and which is
requeued at the front with its tokens so far (greedy decode of the
prefix replays the stream, so the result is byte-identical to an
uncontended run).  With a speculative engine each decode is one
draft-then-verify round, its accepted span emitted token by token
through the same finish predicate.

Given a ``metrics`` sink (:class:`veles_tpu_torch.serve.metrics
.ServingMetrics`), the scheduler registers the JAX package's ``gen_*``
gauges and its ``gen_ttft_seconds`` histogram under ``model="<name>"``
and drops them at :meth:`GenerativeScheduler.stop`; every gauge reads
host counters only, so a scrape on an HTTP thread never waits on the
card or on a step.  With tracing on, a request carries the trace
context it was submitted under: its enqueue, admit and evict instants,
its ``queue_wait``, ``prefill_phase`` and ``decode_phase`` spans and
the engine's dispatch spans carry its trace id.

Not ported, each raising ``NotImplementedError`` naming its ROADMAP
item: the fleet page handoff and drain (``submit_handoff``, ``drain``;
item 7(d)).  Every :data:`GenerativeScheduler.WATCH_EVERY` decode steps
a ``serve`` snapshot (:meth:`GenerativeScheduler.watch_snapshot`) goes
onto the telemetry bus when one is live (:mod:`veles_tpu_torch.watch`).
"""

import collections
import threading
import time
from concurrent.futures import Future

import numpy

from veles_tpu_torch import trace, watch
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.metrics import LatencyHistogram
from veles_tpu_torch.obs import context as obs_context
from veles_tpu_torch.samples.transformer import _not_ported
from veles_tpu_torch.serve.batcher import QueueFull  # noqa: F401


class GenRequest(object):
    __slots__ = ("tokens", "max_new_tokens", "future", "on_token",
                 "submitted", "first_token_at", "generated", "slot",
                 "finish_reason", "admit_seq", "preemptions", "ctx",
                 "queued_at", "admitted_at")

    def __init__(self, tokens, max_new_tokens, on_token=None, ctx=None):
        self.tokens = tokens
        self.max_new_tokens = int(max_new_tokens)
        self.future = Future()
        self.on_token = on_token
        self.submitted = time.perf_counter()
        self.first_token_at = None
        self.generated = []
        self.slot = None
        self.finish_reason = None
        #: admission stamp: preemption evicts the YOUNGEST (largest)
        self.admit_seq = -1
        self.preemptions = 0
        #: the trace context captured at submit (None untraced): every
        #: span of this request's waterfall carries its ids across the
        #: thread handoff
        self.ctx = ctx
        #: start of the current queue residence (submit, then each
        #: preemption requeue): the queue_wait span's begin
        self.queued_at = self.submitted
        self.admitted_at = None

    def span_args(self, args=None):
        """``args`` tagged with this request's trace identity (the dict
        unchanged when untraced)."""
        if self.ctx is None:
            return args
        return self.ctx.span_args(args)

    def prefix(self):
        """The tokens a (re-)admission must prefill: the prompt plus
        everything generated before a preemption (greedy decode of the
        prefix reproduces the stream, so requeueing is lossless)."""
        if not self.generated:
            return self.tokens
        return numpy.concatenate([
            numpy.asarray(self.tokens, numpy.int32),
            numpy.asarray(self.generated, numpy.int32)])


def finish_reason(engine, n_generated, max_new_tokens, token, slot,
                  slot_len=None):
    """The ONE finish predicate continuous and static batching share:
    ``"eos"`` when the engine's eos token was produced, ``"length"`` at
    the request's token budget or a full KV slot, else ``None``.
    ``slot_len`` overrides the engine's counter: a speculative verify
    advances the slot by the whole accepted span before its tokens are
    emitted one by one, so each emit passes the length as of its
    token."""
    if engine.eos_id is not None and token == engine.eos_id:
        return "eos"
    if n_generated >= max_new_tokens:
        return "length"
    if slot_len is None:
        slot_len = engine.slot_len[slot]
    if slot_len >= engine.max_seq:
        return "length"
    return None


class GenerativeScheduler(Logger):
    """Continuous batcher over ONE
    :class:`~veles_tpu_torch.gen.engine.GenerativeEngine`.

    Drive it manually (``step()`` / ``run_until_idle()``, the
    deterministic test mode) or with the background worker
    (``start()``, the serving mode; ``generate()`` then blocks on the
    future).  Both modes run the identical admission/decode/evict
    sequence.
    """

    def __init__(self, engine, metrics=None, name="default",
                 max_queue=256, **kwargs):
        super(GenerativeScheduler, self).__init__(**kwargs)
        self.engine = engine
        self.name = name
        self.max_queue = int(max_queue)
        self.metrics = metrics
        self._queue = collections.deque()
        self._active = {}            # slot -> decoding GenRequest
        self._prefilling = {}        # slot -> chunk-admitting request
        #: the request between its queue pop and its slot: a draining
        #: stop() waits for it too (the JAX scheduler's drain does not,
        #: and fails such a request "mid-stream")
        self._admitting = None
        self._cond = threading.Condition()
        self._stopped = False
        self._thread = None
        self.admitted_total = 0
        self.finished_total = 0
        self.tokens_total = 0
        self.shed_total = 0
        self.decode_steps = 0
        self.decode_slot_steps = 0   # active rows summed over steps
        self._admit_counter = 0
        #: submit → first streamed token (queue wait + prefill)
        self.ttft = LatencyHistogram()
        self._gauges = {}
        if metrics is not None:
            self._register_gauges(metrics)

    # -- metrics -----------------------------------------------------------
    def _gauge_names(self):
        """The gauges this engine shows, as the JAX scheduler registers
        them: the block-pool pair only where a pool exists, the prefix
        hit rate with the prefix cache, the speculation pair with a
        proposer."""
        names = ["gen_queue_depth", "gen_slot_occupancy",
                 "gen_admitted_total", "gen_tokens_total", "gen_batch_fill",
                 "gen_ttft_p99_ms", "gen_preemptions_total",
                 "gen_hbm_per_request_bytes"]
        engine = self.engine
        if getattr(engine, "kv_mode", "contiguous") == "paged":
            names += ["gen_blocks_total", "gen_blocks_free"]
        if getattr(engine, "prefix_cache", False):
            names += ["gen_prefix_hit_rate"]
        if getattr(engine, "speculative", None):
            names += ["gen_spec_accept_rate", "gen_spec_tokens_per_dispatch"]
        return names

    def _register_gauges(self, metrics):
        engine = self.engine
        sources = {
            "gen_queue_depth": lambda: len(self._queue),
            "gen_slot_occupancy": engine.occupancy,
            "gen_admitted_total": lambda: self.admitted_total,
            "gen_tokens_total": lambda: self.tokens_total,
            "gen_batch_fill": self.batch_fill,
            "gen_ttft_p99_ms":
                lambda: round(self.ttft.percentile(99) * 1e3, 3),
            "gen_preemptions_total": lambda: engine.preemptions_total,
            "gen_hbm_per_request_bytes": engine.hbm_per_request_bytes,
            "gen_blocks_total": lambda: engine.blocks_total,
            "gen_blocks_free": lambda: engine.blocks_free,
            "gen_prefix_hit_rate":
                lambda: round(engine.prefix_hit_rate(), 4),
            "gen_spec_accept_rate":
                lambda: round(engine.spec_accept_rate(), 4),
            "gen_spec_tokens_per_dispatch":
                lambda: round(engine.spec_tokens_per_dispatch(), 4),
        }
        label = '{model="%s"}' % self.name
        self._gauges = {name + label: sources[name]
                        for name in self._gauge_names()}
        for key, fn in self._gauges.items():
            metrics.register_gauge(key, fn)
        metrics.register_histogram("gen_ttft_seconds", self.ttft,
                                   "submit -> first generated token",
                                   labels={"model": self.name})

    def _unregister_gauges(self, metrics):
        """Drop this scheduler's gauges and histogram, and only those: a
        successor deployed under the same name (a drain swap) has
        registered its own under the same keys before this one stops,
        and they stay."""
        for key, fn in self._gauges.items():
            metrics.unregister_gauge(key, fn)
        metrics.unregister_histogram("gen_ttft_seconds",
                                     labels={"model": self.name},
                                     hist=self.ttft)

    def attach_metrics(self, metrics):
        """Record into ``metrics`` from now on and show the gauges there
        (a registry handed its sink after this scheduler started)."""
        self.metrics = metrics
        self._register_gauges(metrics)

    #: decode-step cadence of the telemetry-bus "serve" snapshots
    WATCH_EVERY = 32

    def watch_snapshot(self):
        """The compact serving digest published onto the telemetry bus
        every :data:`WATCH_EVERY` decode steps (and readable any time):
        queue and slot pressure, throughput counters, TTFT."""
        return {
            "model": self.name,
            "queue_depth": len(self._queue),
            "active": len(self._active),
            "prefilling": len(self._prefilling),
            "batch_fill": round(self.batch_fill(), 4),
            "admitted_total": self.admitted_total,
            "finished_total": self.finished_total,
            "tokens_total": self.tokens_total,
            "preemptions_total": self.engine.preemptions_total,
            "ttft_p99_ms": round(self.ttft.percentile(99) * 1e3, 3),
        }

    def batch_fill(self):
        """Mean decode-row utilisation: active slots served per decode
        step over the engine's slot capacity."""
        if not self.decode_steps:
            return 0.0
        return self.decode_slot_steps / float(
            self.decode_steps * self.engine.max_slots)

    def queue_depth(self):
        return len(self._queue)

    def active_requests(self):
        return len(self._active) + len(self._prefilling)

    # -- client side -------------------------------------------------------
    def submit(self, tokens, max_new_tokens=16, on_token=None):
        """Enqueue one prompt; returns a Future resolving to the full
        greedy token list.  Sheds with :class:`QueueFull` at capacity
        and rejects unservable prompts with ``ValueError`` at the door
        (a queued request must never fail at admission time)."""
        tokens = numpy.ascontiguousarray(tokens, numpy.int32).ravel()
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(tokens) < 1:
            raise ValueError("empty prompt")
        return self.submit_request(GenRequest(
            tokens, max_new_tokens, on_token, ctx=obs_context.current()))

    def submit_request(self, request):
        """Enqueue a pre-built :class:`GenRequest` (what :meth:`submit`
        rides).  The door check is written against the request's prefix
        and REMAINING budget, which for a fresh request is the prompt +
        ``max_new_tokens`` check."""
        prefix_len = len(request.prefix())
        remaining = request.max_new_tokens - len(request.generated)
        if remaining < 1:
            raise ValueError(
                "request has no remaining token budget (%d generated of "
                "%d)" % (len(request.generated), request.max_new_tokens))
        self.engine.check_prompt(prefix_len)  # raises when oversized
        if prefix_len + remaining - 1 >= self.engine.max_seq:
            raise ValueError(
                "prompt %d + max_new_tokens %d exceeds the engine's "
                "max_seq %d KV slot" % (prefix_len, remaining,
                                        self.engine.max_seq))
        with self._cond:
            if self._stopped:
                raise RuntimeError("scheduler is stopped")
            if len(self._queue) >= self.max_queue:
                self.shed_total += 1
                if self.metrics is not None:
                    self.metrics.record_shed()
                raise QueueFull(
                    "generation queue full (%d requests, limit %d)"
                    % (len(self._queue), self.max_queue))
            self._queue.append(request)
            self._cond.notify()
        if trace.enabled():
            trace.instant("gen", "enqueue",
                          request.span_args(
                              {"prompt": len(request.tokens),
                               "max_new": request.max_new_tokens,
                               "resumed": bool(request.generated)}),
                          role="server")
        return request.future

    def submit_handoff(self, payload, request):
        _not_ported("the fleet page handoff (submit_handoff)", "7(e)")

    def drain(self, timeout=30.0):
        _not_ported("the fleet drain", "7(e)")

    def generate(self, tokens, max_new_tokens=16, timeout=120.0,
                 on_token=None):
        """Blocking convenience: ``submit`` + result.  Without the
        worker thread the caller's own thread pumps the loop."""
        future = self.submit(tokens, max_new_tokens, on_token)
        if self._thread is not None:
            return future.result(timeout)
        deadline = time.perf_counter() + timeout
        while not future.done():
            if self.step() == 0 and not future.done():
                raise RuntimeError("scheduler idle with an unresolved "
                                   "request — engine wedged?")
            if time.perf_counter() > deadline:
                raise TimeoutError("generation exceeded %.1fs" % timeout)
        return future.result(0)

    # -- the scheduling iteration ------------------------------------------
    def _emit(self, request, token, slot_len=None):
        request.generated.append(int(token))
        if request.first_token_at is None:
            request.first_token_at = time.perf_counter()
            self.ttft.record(request.first_token_at - request.submitted)
            if trace.enabled() and request.admitted_at is not None:
                # the prefill phase of the request's waterfall: admission
                # to first token (one bucket call or the chunk cadence)
                trace.complete(
                    "gen", "prefill_phase", int(request.admitted_at * 1e9),
                    int((request.first_token_at - request.admitted_at)
                        * 1e9),
                    request.span_args({"slot": request.slot,
                                       "prompt": len(request.tokens)}),
                    role="server")
        self.tokens_total += 1
        if request.on_token is not None:
            try:
                request.on_token(int(token))
            except Exception:
                self.exception("on_token callback failed; detaching "
                               "the stream (the future still resolves)")
                request.on_token = None
        reason = finish_reason(self.engine, len(request.generated),
                               request.max_new_tokens, int(token),
                               request.slot, slot_len=slot_len)
        if reason is not None:
            self._finish(request, reason)

    def _finish(self, request, reason):
        request.finish_reason = reason
        self.engine.release_slot(request.slot)
        self._active.pop(request.slot, None)
        self.finished_total += 1
        if trace.enabled():
            now = time.perf_counter()
            trace.instant("gen", "evict",
                          request.span_args(
                              {"slot": request.slot, "reason": reason,
                               "tokens": len(request.generated)}),
                          role="server")
            if request.first_token_at is not None \
                    and now > request.first_token_at:
                # the decode phase: first token to eviction
                trace.complete(
                    "gen", "decode_phase", int(request.first_token_at * 1e9),
                    int((now - request.first_token_at) * 1e9),
                    request.span_args({"slot": request.slot,
                                       "tokens": len(request.generated)}),
                    role="server")
            # the whole request: submit to resolution (it encloses the
            # queue_wait, prefill_phase and decode_phase spans)
            trace.complete("gen", "request", int(request.submitted * 1e9),
                           int((now - request.submitted) * 1e9),
                           request.span_args(
                               {"reason": reason,
                                "tokens": len(request.generated),
                                "preemptions": request.preemptions}),
                           role="server")
        request.future.set_result(list(request.generated))

    def _preempt(self, request):
        """Pool-exhaustion eviction of the YOUNGEST sequence: free its
        slot and pages and requeue it at the queue FRONT with its tokens
        so far (greedy decode of the prefix reproduces the stream)."""
        slot = request.slot
        self.engine.preempt(slot)
        self._active.pop(slot, None)
        self._prefilling.pop(slot, None)
        request.slot = None
        request.preemptions += 1
        request.queued_at = time.perf_counter()
        if trace.enabled():
            trace.instant("gen", "preempt",
                          request.span_args(
                              {"slot": slot,
                               "generated": len(request.generated)}),
                          role="server")
        with self._cond:
            self._queue.appendleft(request)

    def _spec_decode(self):
        """One draft-then-verify round over the active set: proposals per
        slot, the engine's one verify call, then each slot's accepted
        span emitted ONE token at a time through the shared finish
        predicate, so the stream (and where it stops) is plain decode's.
        Returns the number of tokens emitted."""
        proposals = {}
        for slot, request in self._active.items():
            if self.engine.slot_len[slot] < self.engine.max_seq:
                proposals[slot] = self.engine.propose(request.prefix())
        result = self.engine.spec_decode_step(proposals)
        if result is None:
            return 0
        emitted = 0
        self.decode_steps += 1
        self.decode_slot_steps += len(result)
        for slot, tokens in sorted(result.items()):
            request = self._active.get(slot)
            if request is None:
                continue
            final_len = int(self.engine.slot_len[slot])
            for j, token in enumerate(tokens):
                # the slot length as of this token: the engine already
                # advanced by the whole accepted span
                self._emit(request, token,
                           slot_len=final_len - (len(tokens) - 1 - j))
                emitted += 1
                if request.finish_reason is not None:
                    # eos or length mid-span: plain decode stops here too
                    break
        return emitted

    def _admit_queued(self):
        """Admit from the queue head while the engine has real headroom
        (slots, and pool pages when paged), one at a time so every
        admission updates the free list and the pool before the next is
        priced.  Returns the tokens emitted."""
        emitted = 0
        while True:
            with self._cond:
                if not self._queue:
                    break
                head = self._queue[0]
                # the tokens let prefix-cache hits (and evictable
                # cache-only pages) count toward the pricing
                if not self.engine.can_admit(len(head.prefix()),
                                             head.prefix()):
                    break          # FIFO: no overtaking the head
                request = self._admitting = self._queue.popleft()
            try:
                # the request's trace context, so the engine's dispatch
                # spans (prefill, prefill_chunk) carry its identity
                with obs_context.activate(request.ctx):
                    slot, token = self.engine.admit(request.prefix())
            except Exception as exc:  # noqa: BLE001 - per-request
                # it already left the queue, so fail THIS request's
                # future; the next queued request still gets its attempt
                self.exception("admission failed; failing the request")
                self._admitting = None
                if not request.future.done():
                    request.future.set_exception(exc)
                continue
            request.slot = slot
            request.admitted_at = time.perf_counter()
            self._admit_counter += 1
            request.admit_seq = self._admit_counter
            self.admitted_total += 1
            if trace.enabled():
                trace.instant("gen", "admit",
                              request.span_args(
                                  {"slot": slot, "prompt": len(request.tokens),
                                   "resumed": bool(request.generated)}),
                              role="server")
                # the queue-wait phase: (re-)enqueue to admission
                trace.complete(
                    "gen", "queue_wait", int(request.queued_at * 1e9),
                    int((request.admitted_at - request.queued_at) * 1e9),
                    request.span_args({"slot": slot,
                                       "resumed": bool(request.generated)}),
                    role="server")
            if token is None:
                self._prefilling[slot] = request
            else:
                self._active[slot] = request
            self._admitting = None
            if token is not None:
                self._emit(request, token)   # may evict immediately
                emitted += 1
        return emitted

    def _feed_chunks(self):
        """The chunked-prefill cadence: ONE chunk per pending prompt per
        step.  Returns the chunks fed."""
        fed = 0
        for slot in sorted(self._prefilling):
            request = self._prefilling[slot]
            try:
                with obs_context.activate(request.ctx):
                    token = self.engine.prefill_step(slot)
            except Exception as exc:  # noqa: BLE001 - per-request
                self.exception("prefill chunk failed; failing the request")
                del self._prefilling[slot]
                try:
                    self.engine.release_slot(slot)
                except Exception:
                    pass
                if not request.future.done():
                    request.future.set_exception(exc)
                continue
            fed += 1
            if token is not None:
                del self._prefilling[slot]
                self._active[slot] = request
                self._emit(request, token)
        return fed

    def step(self):
        """One iteration: admit while the engine has headroom, feed at
        most one chunk per pending chunked prefill, finish saturated
        slots, preempt the youngest sequence until the next decode
        step's pages fit, then one decode (or draft-then-verify) over
        the active set.  Returns the work done, tokens emitted plus
        chunks fed plus preemptions (0 = idle)."""
        emitted = self._admit_queued()
        emitted += self._feed_chunks()
        # a saturated slot decodes nothing: route it through the shared
        # finish predicate instead of stalling the batch
        for slot, request in list(self._active.items()):
            if self.engine.slot_len[slot] >= self.engine.max_seq:
                last = request.generated[-1] if request.generated \
                    else int(self.engine.slot_token[slot])
                reason = finish_reason(
                    self.engine, len(request.generated),
                    request.max_new_tokens, last, slot) or "length"
                self._finish(request, reason)
        while self.engine.decode_block_deficit() > 0:
            if not self._active:
                raise RuntimeError(
                    "block pool deficit with no preemptible sequence: "
                    "the pool is smaller than one step's working set")
            self._preempt(max(self._active.values(),
                              key=lambda r: r.admit_seq))
            emitted += 1
        decode_steps_before = self.decode_steps
        if self._active:
            if self.engine.proposer is not None:
                emitted += self._spec_decode()
            else:
                result = self.engine.decode_step()
                if result is not None:
                    out, active = result
                    self.decode_steps += 1
                    self.decode_slot_steps += int(active.sum())
                    for slot, request in list(self._active.items()):
                        if active[slot]:
                            self._emit(request, out[slot])
                            emitted += 1
        if watch.enabled() and self.decode_steps != decode_steps_before \
                and self.decode_steps % self.WATCH_EVERY == 0:
            # only when a decode step reached the cadence (a prefill-only
            # pump must not republish); the publish never blocks
            watch.publish("serve", self.watch_snapshot())
        return emitted

    def run_until_idle(self, max_steps=100000):
        """Pump until queue and slots drain (manual mode)."""
        steps = 0
        while self._queue or self._active or self._prefilling:
            if self.step() == 0:
                break
            steps += 1
            if steps > max_steps:
                raise RuntimeError("run_until_idle exceeded %d steps"
                                   % max_steps)
        return steps

    # -- worker mode -------------------------------------------------------
    def start(self):
        """Run the scheduling loop on a background thread (serving
        mode).  Returns self."""
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._worker, daemon=True,
            name="gen-scheduler-%s" % self.name)
        self._thread.start()
        return self

    def _worker(self):
        while True:
            with self._cond:
                if self._stopped:
                    return
                if not (self._queue or self._active or self._prefilling):
                    self._cond.wait(0.05)
                    if self._stopped:
                        return
            try:
                self.step()
            except Exception:
                # fail the inhabitants rather than silently wedging
                self.exception("scheduler step failed; failing active "
                               "requests")
                occupants = (list(self._active.items())
                             + list(self._prefilling.items()))
                self._active.clear()
                self._prefilling.clear()
                for slot, request in occupants:
                    try:
                        self.engine.release_slot(slot)
                    except ValueError:
                        pass
                    if not request.future.done():
                        request.future.set_exception(
                            RuntimeError("generation failed mid-stream"))

    def stop(self, drain=True):
        """Stop the worker; ``drain=True`` finishes queued and active
        work first (bounded by the workload, not time)."""
        if self._thread is not None and drain:
            while True:
                with self._cond:
                    idle = not (self._queue or self._active
                                or self._prefilling
                                or self._admitting is not None)
                if idle:
                    break
                time.sleep(0.005)
        with self._cond:
            self._stopped = True
            leftovers = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        for request in leftovers:
            if not request.future.done():
                request.future.set_exception(
                    RuntimeError("scheduler stopped"))
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # whatever still occupies a slot fails LOUDLY now: a pending
        # future against a stopped scheduler would block its client
        for slot, request in (list(self._active.items())
                              + list(self._prefilling.items())):
            self._active.pop(slot, None)
            self._prefilling.pop(slot, None)
            try:
                self.engine.release_slot(slot)
            except ValueError:
                pass
            if not request.future.done():
                request.future.set_exception(
                    RuntimeError("scheduler stopped mid-stream"))
        if self.metrics is not None:
            self._unregister_gauges(self.metrics)

    def describe(self):
        return {
            "queue_depth": len(self._queue),
            "active_requests": self.active_requests(),
            "admitted_total": self.admitted_total,
            "finished_total": self.finished_total,
            "tokens_total": self.tokens_total,
            "shed_total": self.shed_total,
            "batch_fill": round(self.batch_fill(), 4),
            "ttft_p99_ms": round(self.ttft.percentile(99) * 1e3, 3),
        }


def static_generate(engine, requests):
    """The pad-to-slowest baseline the continuous scheduler is measured
    against: admit ``engine.max_slots`` requests, decode until EVERY
    member finishes, only then admit the next group.  Same engine, same
    finish predicate.  Returns ``(token_lists, decode_steps)``."""
    results = [None] * len(requests)
    steps = 0
    i = 0
    while i < len(requests):
        group = []
        while i < len(requests) and len(group) < engine.max_slots:
            tokens, max_new = requests[i]
            slot, tok = engine.prefill(tokens)
            generated = [int(tok)]
            entry = {"slot": slot, "index": i, "generated": generated,
                     "max_new": int(max_new)}
            reason = finish_reason(engine, 1, int(max_new), int(tok),
                                   slot)
            if reason is not None:
                engine.release_slot(slot)
                results[i] = generated
            else:
                group.append(entry)
            i += 1
        while group:
            out, active = engine.decode_step()
            steps += 1
            still = []
            for entry in group:
                slot = entry["slot"]
                if not active[slot]:
                    still.append(entry)
                    continue
                tok = int(out[slot])
                entry["generated"].append(tok)
                reason = finish_reason(engine, len(entry["generated"]),
                                       entry["max_new"], tok, slot)
                if reason is not None:
                    engine.release_slot(slot)
                    results[entry["index"]] = entry["generated"]
                else:
                    still.append(entry)
            group = still
    return results, steps
