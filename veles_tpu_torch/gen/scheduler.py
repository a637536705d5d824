"""Continuous-batching scheduler: iteration-level admission over the
engine's slots.

Counterpart of :mod:`veles_tpu.gen.scheduler` for the contiguous
engine.  Requests are admitted into open KV-cache slots at EVERY decode
iteration and evicted the moment they finish, so the decode step's
fixed ``max_slots`` rows stay as full as the arrival process allows.
One scheduler thread owns the engine; ``submit`` only touches the
bounded queue (:class:`QueueFull` on overflow).  Tokens stream per
request through ``on_token`` callbacks; the request future resolves
with the full greedy token list at eviction.

Not ported in this slice: the ``/metrics`` gauges (``metrics`` must be
None), the fleet page handoff and drain, speculative decode, and the
telemetry-bus snapshots.
"""

import collections
import threading
import time
from concurrent.futures import Future

import numpy

from veles_tpu_torch import trace
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.metrics import LatencyHistogram


class QueueFull(RuntimeError):
    """Request rejected: the queue is at capacity."""


class GenRequest(object):
    __slots__ = ("tokens", "max_new_tokens", "future", "on_token",
                 "submitted", "first_token_at", "generated", "slot",
                 "finish_reason")

    def __init__(self, tokens, max_new_tokens, on_token=None):
        self.tokens = tokens
        self.max_new_tokens = int(max_new_tokens)
        self.future = Future()
        self.on_token = on_token
        self.submitted = time.perf_counter()
        self.first_token_at = None
        self.generated = []
        self.slot = None
        self.finish_reason = None

    def prefix(self):
        """The tokens an admission must prefill: the prompt plus
        everything generated before (greedy decode of the prefix
        reproduces the stream)."""
        if not self.generated:
            return self.tokens
        return numpy.concatenate([
            numpy.asarray(self.tokens, numpy.int32),
            numpy.asarray(self.generated, numpy.int32)])


def finish_reason(engine, n_generated, max_new_tokens, token, slot):
    """The ONE finish predicate continuous and static batching share:
    ``"eos"`` when the engine's eos token was produced, ``"length"`` at
    the request's token budget or a full KV slot, else ``None``."""
    if engine.eos_id is not None and token == engine.eos_id:
        return "eos"
    if n_generated >= max_new_tokens:
        return "length"
    if engine.slot_len[slot] >= engine.max_seq:
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
        if metrics is not None:
            raise NotImplementedError(
                "the /metrics gauges are not ported to veles_tpu_torch "
                "yet (ROADMAP.md, 'Slices still to port', item 6)")
        self.engine = engine
        self.name = name
        self.max_queue = int(max_queue)
        self._queue = collections.deque()
        self._active = {}            # slot -> decoding GenRequest
        self._cond = threading.Condition()
        self._stopped = False
        self._thread = None
        self.admitted_total = 0
        self.finished_total = 0
        self.tokens_total = 0
        self.shed_total = 0
        self.decode_steps = 0
        self.decode_slot_steps = 0   # active rows summed over steps
        #: submit → first streamed token (queue wait + prefill)
        self.ttft = LatencyHistogram()

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
        return len(self._active)

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
        self.engine.check_prompt(len(tokens))
        if len(tokens) + max_new_tokens - 1 >= self.engine.max_seq:
            raise ValueError(
                "prompt %d + max_new_tokens %d exceeds the engine's "
                "max_seq %d KV slot" % (len(tokens), max_new_tokens,
                                        self.engine.max_seq))
        request = GenRequest(tokens, max_new_tokens, on_token)
        with self._cond:
            if self._stopped:
                raise RuntimeError("scheduler is stopped")
            if len(self._queue) >= self.max_queue:
                self.shed_total += 1
                raise QueueFull(
                    "generation queue full (%d requests, limit %d)"
                    % (len(self._queue), self.max_queue))
            self._queue.append(request)
            self._cond.notify()
        trace.instant("gen", "enqueue",
                      {"prompt": len(tokens), "max_new": max_new_tokens},
                      role="server")
        return request.future

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
    def _emit(self, request, token):
        request.generated.append(int(token))
        if request.first_token_at is None:
            request.first_token_at = time.perf_counter()
            self.ttft.record(request.first_token_at - request.submitted)
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
                               request.slot)
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
                          {"slot": request.slot, "reason": reason,
                           "tokens": len(request.generated)},
                          role="server")
            trace.complete("gen", "request", int(request.submitted * 1e9),
                           int((now - request.submitted) * 1e9),
                           {"reason": reason,
                            "tokens": len(request.generated)},
                           role="server")
        request.future.set_result(list(request.generated))

    def step(self):
        """One iteration: admit while a slot is free (FIFO), then one
        decode step over the active set.  Returns the number of tokens
        emitted (0 = idle)."""
        emitted = 0
        while True:
            with self._cond:
                if not self._queue:
                    break
                head = self._queue[0]
                if not self.engine.can_admit(len(head.prefix())):
                    break          # FIFO: no overtaking the head
                request = self._queue.popleft()
            try:
                slot, token = self.engine.admit(request.prefix())
            except Exception as exc:  # noqa: BLE001 - per-request
                # it already left the queue, so fail THIS request's
                # future; the next queued request still gets its attempt
                self.exception("admission failed; failing the request")
                if not request.future.done():
                    request.future.set_exception(exc)
                continue
            request.slot = slot
            self.admitted_total += 1
            trace.instant("gen", "admit",
                          {"slot": slot, "prompt": len(request.tokens)},
                          role="server")
            self._active[slot] = request
            self._emit(request, token)   # may evict immediately
            emitted += 1
        # a saturated slot decodes nothing: route it through the shared
        # finish predicate instead of stalling the batch
        for slot, request in list(self._active.items()):
            if self.engine.slot_len[slot] >= self.engine.max_seq:
                reason = finish_reason(
                    self.engine, len(request.generated),
                    request.max_new_tokens, request.generated[-1],
                    slot) or "length"
                self._finish(request, reason)
        if self._active:
            result = self.engine.decode_step()
            if result is not None:
                out, active = result
                self.decode_steps += 1
                self.decode_slot_steps += int(active.sum())
                for slot, request in list(self._active.items()):
                    if active[slot]:
                        self._emit(request, out[slot])
                        emitted += 1
        return emitted

    def run_until_idle(self, max_steps=100000):
        """Pump until queue and slots drain (manual mode)."""
        steps = 0
        while self._queue or self._active:
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
                if not self._queue and not self._active:
                    self._cond.wait(0.05)
                    if self._stopped:
                        return
            try:
                self.step()
            except Exception:
                # fail the inhabitants rather than silently wedging
                self.exception("scheduler step failed; failing active "
                               "requests")
                occupants = list(self._active.items())
                self._active.clear()
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
                    idle = not self._queue and not self._active
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
        for slot, request in list(self._active.items()):
            self._active.pop(slot, None)
            try:
                self.engine.release_slot(slot)
            except ValueError:
                pass
            if not request.future.done():
                request.future.set_exception(
                    RuntimeError("scheduler stopped mid-stream"))

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
