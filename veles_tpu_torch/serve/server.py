"""ServingServer: threaded HTTP front end over the serving registry.
The port's counterpart of :mod:`veles_tpu.serve.server`.

Wire contract::

    POST /service            {"input": [[...]]}  →  {"result": [[...]]}
    POST /service/<model>    same, for a named registry entry
    POST /generate[/<model>] {"tokens": [...], "max_new_tokens": n,
                              "stream": false}  →  {"tokens": [...]}
    GET /healthz   → {"status": "ok", "models": {...}}   (200/503)
    GET /metrics   → text/plain Prometheus-style counters

Requests may carry base64 numpy input (``{"input_b64": ..., "shape":
[...], "dtype": "float32"}``, :mod:`veles_tpu_torch.serve.wire`).
Errors: malformed request → 400 ``{"error": ...}``; unknown model or
route → 404; full batch queue → 503 with ``Retry-After``; a timed-out
request → 504; a failed inference → 500.  With tracing on, every POST
mints (or continues, from an incoming W3C ``traceparent``) a trace
context (:mod:`veles_tpu_torch.obs.context`), activates it for the
handler thread and echoes the ``traceparent`` header.  ``/metrics``
carries the serving counters, :func:`veles_tpu_torch.prof.metrics_text`,
the trace counters while tracing is on, and the SLO engine's lines
(:mod:`veles_tpu_torch.obs.slo`, sampled per scrape); a generative
model's scheduler adds its ``gen_*`` gauges to the same sink.

``POST /generate`` runs on the named generative model's scheduler
(:meth:`~veles_tpu_torch.serve.registry.ModelRegistry
.deploy_generative`).  With ``"stream": true`` the reply is an ndjson
token stream in chunked transfer encoding: one ``{"token", "index"}``
line a token as the scheduler emits it, then the final ``{"done":
true, "tokens": [...]}`` document; an error before the first token
still maps to its status code, one after it rides in-band as the final
document.

The handler thread only parses and serializes; the device work runs on
each model's batcher or scheduler worker, so concurrent HTTP threads
coalesce into bucket calls and decode steps.

Not ported: ``notify_status`` (the ``web_status`` page, item 7(e)),
raising ``NotImplementedError`` naming its ROADMAP item.
"""

import json
import queue as queue_module
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout

from veles_tpu_torch import trace
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.obs import context as obs_context
from veles_tpu_torch.obs import slo as obs_slo
from veles_tpu_torch.samples.transformer import _not_ported
from veles_tpu_torch.serve.batcher import QueueFull
from veles_tpu_torch.serve.metrics import ServingMetrics
from veles_tpu_torch.serve.registry import ModelRegistry
from veles_tpu_torch.serve.wire import decode_gen_request, decode_input

DEFAULT_MODEL = "default"
GENERATE_PATH = "/generate"

#: the streaming queue's end-of-stream sentinel
_STREAM_DONE = object()


class ServingServer(Logger):
    """HTTP front-end; owns (or shares) a registry + metrics."""

    def __init__(self, registry=None, engine=None, host="127.0.0.1",
                 port=0, path="/service", metrics=None,
                 request_timeout=30.0, batcher_config=None,
                 warmup=True, **kwargs):
        super(ServingServer, self).__init__(**kwargs)
        self.metrics = metrics or (registry.metrics if registry is not
                                   None and registry.metrics is not None
                                   else ServingMetrics())
        if registry is None:
            registry = ModelRegistry(metrics=self.metrics,
                                     batcher_config=batcher_config)
        else:
            if registry.metrics is not self.metrics:
                # a handed-in registry without (or with a different)
                # sink: wire its batchers into THIS server's metrics
                # so the /metrics page reflects actual traffic
                registry.attach_metrics(self.metrics)
            if batcher_config:
                # applies to FUTURE deploys only — say so instead of
                # silently dropping the knobs
                registry.batcher_config = dict(batcher_config)
                if registry.names():
                    self.warning(
                        "batcher_config applies to future deploys; "
                        "already-deployed models (%s) keep their "
                        "existing queue/batch knobs",
                        ", ".join(registry.names()))
        self.registry = registry
        #: the serving SLO engine: rings over THIS server's metrics
        #: gauges, objectives from root.common.obs.slo.*, sampled on
        #: every /metrics scrape
        self.slo = obs_slo.standard_engine(self.metrics)
        if engine is not None:
            self.registry.deploy(DEFAULT_MODEL, engine, warmup=warmup)
        self.host = host
        self.port = port
        self.path = path.rstrip("/") or "/service"
        self.request_timeout = float(request_timeout)
        self._httpd = None
        self._thread = None

    # -- request handling --------------------------------------------------
    def _model_for(self, url_path):
        """``/service`` → default model; ``/service/<name>`` → name."""
        if url_path == self.path:
            return self.registry.get(DEFAULT_MODEL)
        prefix = self.path + "/"
        if url_path.startswith(prefix):
            return self.registry.get(url_path[len(prefix):])
        raise LookupError("no route %r" % url_path)

    def handle_predict(self, url_path, body):
        """(status, payload dict) for one POST — transport-free core,
        shared with tests and reusable behind other front-ends."""
        try:
            model = self._model_for(url_path)
        except KeyError as e:         # registry miss (before its
            return 404, {"error": e.args[0]}   # LookupError parent)
        except LookupError as e:      # no such route
            return 404, {"error": str(e)}
        if model.is_generative:
            return 400, {"error": "%r is a generative model — POST "
                                  "%s/%s instead" % (model.name,
                                                     GENERATE_PATH,
                                                     model.name)}
        # captured BEFORE the device call: a concurrent hot swap must
        # not relabel this result with the successor's version
        version = model.version
        try:
            batch = decode_input(json.loads(body))
        except ValueError as e:
            return 400, {"error": str(e)}
        except Exception as e:  # malformed JSON etc.
            return 400, {"error": "bad request: %s" % e}
        try:
            future = model.batcher.submit(batch)
        except QueueFull as e:
            return 503, {"error": str(e),
                         "retry_after": QueueFull.retry_after}
        except ValueError as e:       # sample-shape mismatch
            return 400, {"error": str(e)}
        try:
            result = future.result(self.request_timeout)
        except FuturesTimeout:
            # give the batcher the chance to skip the abandoned
            # request entirely (no device call for a client that is
            # no longer listening); a started batch still finishes
            future.cancel()
            return 504, {"error": "inference timed out after %.1fs"
                         % self.request_timeout}
        except Exception as e:  # noqa: BLE001 - wire boundary
            return 500, {"error": "inference failed: %s" % e}
        return 200, {"result": result.tolist(),
                     "model": model.name, "version": version}

    def _gen_model_for(self, url_path):
        """``/generate`` → default model; ``/generate/<name>`` → name.
        Raises KeyError/LookupError for the 404 mapping and ValueError
        when the name is not generative."""
        if url_path == GENERATE_PATH:
            name = DEFAULT_MODEL
        elif url_path.startswith(GENERATE_PATH + "/"):
            name = url_path[len(GENERATE_PATH) + 1:]
        else:
            raise LookupError("no route %r" % url_path)
        model = self.registry.get(name)
        if not model.is_generative:
            raise ValueError(
                "%r is a request/response model — POST %s%s instead"
                % (name, self.path,
                   "" if name == DEFAULT_MODEL else "/" + name))
        return model

    def handle_generate(self, url_path, body, on_token=None):
        """(status, payload dict) for one ``POST /generate``: the
        transport-free core (the streaming handler adds its ndjson
        framing on top through ``on_token``, which runs on the
        scheduler's worker)."""
        try:
            model = self._gen_model_for(url_path)
        except KeyError as e:
            return 404, {"error": e.args[0]}
        except LookupError as e:
            return 404, {"error": str(e)}
        except ValueError as e:
            return 400, {"error": str(e)}
        version = model.version
        try:
            tokens, max_new, _stream = decode_gen_request(
                json.loads(body))
        except ValueError as e:
            return 400, {"error": str(e)}
        except Exception as e:  # malformed JSON etc.
            return 400, {"error": "bad request: %s" % e}
        try:
            out = model.scheduler.generate(
                tokens, max_new, timeout=self.request_timeout,
                on_token=on_token)
        except QueueFull as e:
            return 503, {"error": str(e),
                         "retry_after": QueueFull.retry_after}
        except ValueError as e:       # unservable prompt/budget
            return 400, {"error": str(e)}
        except (FuturesTimeout, TimeoutError):
            return 504, {"error": "generation timed out after %.1fs"
                         % self.request_timeout}
        except Exception as e:  # noqa: BLE001 - wire boundary
            return 500, {"error": "generation failed: %s" % e}
        return 200, {"tokens": [int(t) for t in out],
                     "model": model.name, "version": version}

    def stream_generate(self, url_path, body):
        """Streaming variant: yields ``(status, line)`` pairs of
        ndjson-encoded bytes, one ``{"token": t, "index": i}`` event per
        generated token as the scheduler emits it, then a final
        ``{"done": true, "tokens": [...]}`` document (or ``{"error":
        ...}``).  The first yield's status is the reply's, so the HTTP
        handler can still map an early rejection to its code; later
        statuses are None.  The scheduler's callback only enqueues the
        event: the JSON encoding runs on the caller's thread."""
        events = queue_module.Queue()

        def on_token(token):
            events.put(token)

        outcome = {}

        def run():
            outcome["reply"] = self.handle_generate(url_path, body,
                                                    on_token=on_token)
            events.put(_STREAM_DONE)

        worker = threading.Thread(target=run, daemon=True,
                                  name="serve-gen-stream")
        worker.start()
        first = events.get()
        if first is _STREAM_DONE:
            # finished (or failed) before the first token
            status, payload = outcome["reply"]
            if status == 200:
                payload = dict(payload, done=True)
            yield status, (json.dumps(payload) + "\n").encode()
            return
        index = 0
        yield 200, (json.dumps({"token": int(first), "index": index})
                    + "\n").encode()
        while True:
            event = events.get()
            if event is _STREAM_DONE:
                break
            index += 1
            yield None, (json.dumps({"token": int(event), "index": index})
                         + "\n").encode()
        status, payload = outcome["reply"]
        if status == 200:
            payload = dict(payload, done=True)
        else:
            # the stream already committed a 200: the error rides
            # in-band as the final document
            payload = {"error": payload.get("error", "failed"),
                       "done": True}
        yield None, (json.dumps(payload) + "\n").encode()

    def healthz(self):
        ok = bool(self.registry.names())
        return (200 if ok else 503), {
            "status": "ok" if ok else "no models deployed",
            "uptime_sec": round(time.time() - self.metrics.started, 3),
            "models": self.registry.describe(),
            "slo": self.slo.describe(),
        }

    def metrics_page(self):
        """The full ``/metrics`` exposition body — serving counters,
        performance-ledger gauges (always on — the ledger has no
        knob), trace category counters when tracing is on, and the
        SLO engine's autoscaling signals + burn rates (sampled per
        scrape — the Prometheus pull IS the sampling cadence)."""
        from veles_tpu_torch import prof
        body = self.metrics.render_text()
        body += prof.metrics_text()
        if trace.enabled():
            body += trace.metrics_text()
        self.slo.sample()
        body += self.slo.metrics_text()
        body += self.registry.extra_metrics_text()
        return body

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._httpd is not None:
            return self
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            #: the request's trace context (set per POST when tracing
            #: is on) — echoed as the traceparent response header
            _trace_ctx = None
            #: the reply's last bytes, held back until the request's
            #: ``http`` span has closed, so a client that has read its
            #: whole reply also finds the span in the trace ring
            _tail = None

            def _send_tail(self):
                tail, self._tail = self._tail, None
                if tail:
                    self.wfile.write(tail)

            def _reply(self, status, body, content_type):
                self.send_response(status)
                if status == 503 and b"retry_after" in body:
                    self.send_header("Retry-After",
                                     str(QueueFull.retry_after))
                if self._trace_ctx is not None:
                    self.send_header("traceparent",
                                     self._trace_ctx.traceparent())
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self._tail = body

            def _reply_json(self, status, payload):
                self._reply(status, json.dumps(payload).encode(),
                            "application/json")

            def _stream_reply(self, body):
                """Chunked ndjson token stream (``"stream": true``).
                Handles its own errors: before the first chunk a
                failure still maps to a clean JSON status; once the
                headers are on the wire (a mid-stream disconnect, a
                serialization failure) the only safe move is dropping
                the connection, since a second send_response inside a
                half-written chunked body would corrupt the stream."""
                try:
                    stream = server.stream_generate(self.path, body)
                    status, first = next(stream)
                except StopIteration:
                    self._reply_json(500, {"error": "empty stream"})
                    return
                except Exception as e:  # noqa: BLE001 - pre-headers
                    self._reply_json(500, {"error": str(e)})
                    return
                self.send_response(status)
                if status == 503 and b"retry_after" in first:
                    # the generative queue-full shed carries the predict
                    # path's back-off contract: clients key reconnects
                    # off the header, not the body
                    self.send_header("Retry-After",
                                     str(QueueFull.retry_after))
                if self._trace_ctx is not None:
                    self.send_header("traceparent",
                                     self._trace_ctx.traceparent())
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                try:
                    self.end_headers()

                    def chunk(data):
                        self.wfile.write(
                            ("%x\r\n" % len(data)).encode()
                            + data + b"\r\n")

                    chunk(first)
                    for _status, line in stream:
                        chunk(line)
                    self._tail = b"0\r\n\r\n"
                except Exception as e:  # noqa: BLE001 - mid-stream
                    server.debug("generation stream aborted: %s", e)
                    self.close_connection = True

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                # request-tracing ingress: continue an incoming W3C
                # traceparent or mint a fresh context; None (tracing
                # off) keeps the whole block a single attribute check.
                # Reset per request — a keep-alive connection reuses
                # this handler instance, and an untraced follow-up
                # must not echo the previous request's header
                self._trace_ctx = None
                ctx = obs_context.ingress(
                    self.headers.get("traceparent"))
                if ctx is None:
                    self._handle_post(body)
                    self._send_tail()
                    return
                self._trace_ctx = ctx
                with obs_context.activate(ctx):
                    with trace.span("serve", "http",
                                    ctx.span_args({"path": self.path}),
                                    role="server"):
                        self._handle_post(body)
                self._send_tail()

            def _handle_post(self, body):
                if self.path == GENERATE_PATH or \
                        self.path.startswith(GENERATE_PATH + "/"):
                    try:
                        wants_stream = bool(
                            json.loads(body).get("stream"))
                    except Exception:
                        wants_stream = False   # 400s via the core
                    if wants_stream:
                        self._stream_reply(body)   # self-contained
                        return
                    try:
                        status, payload = server.handle_generate(
                            self.path, body)
                    except Exception as e:  # noqa: BLE001 - wire edge
                        status, payload = 500, {"error": str(e)}
                    self._reply_json(status, payload)
                    return
                try:
                    status, payload = server.handle_predict(
                        self.path, body)
                except Exception as e:  # noqa: BLE001 - wire boundary
                    status, payload = 500, {"error": str(e)}
                self._reply_json(status, payload)

            def do_GET(self):
                self._trace_ctx = None   # keep-alive reuse (see POST)
                if self.path == "/healthz":
                    self._reply_json(*server.healthz())
                elif self.path == "/metrics":
                    self._reply(200, server.metrics_page().encode(),
                                "text/plain; version=0.0.4")
                else:
                    self._reply_json(404, {"error": "no route %r"
                                           % self.path})
                self._send_tail()

            def log_message(self, fmt, *args):
                server.debug("http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="serve-http")
        self._thread.start()
        self.info("serving on http://%s:%d%s (models: %s)", self.host,
                  self.port, self.path,
                  ", ".join(self.registry.names()) or "<none>")
        return self

    def stop(self, drain=True, stop_registry=True):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if stop_registry:
            self.registry.stop(drain=drain)

    def notify_status(self, url, run_id="serving"):
        """POST the metrics snapshot to a ``web_status`` page."""
        _not_ported("ServingServer.notify_status (web_status)", "7(e)")
