"""ServingServer: threaded HTTP front end over the serving registry.
The port's counterpart of :mod:`veles_tpu.serve.server`.

Wire contract::

    POST /service            {"input": [[...]]}  →  {"result": [[...]]}
    POST /service/<model>    same, for a named registry entry
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
(:mod:`veles_tpu_torch.obs.slo`, sampled per scrape).

The handler thread only parses and serializes; the device work runs on
each model's batcher worker, so concurrent HTTP threads coalesce into
bucket calls.

Not ported, each raising ``NotImplementedError`` naming its ROADMAP
item: ``POST /generate[/<name>]`` (answered 501), ``handle_generate``
and ``stream_generate`` (item 6(b)), and ``notify_status`` (the
``web_status`` page, item 7(e)).
"""

import json
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
from veles_tpu_torch.serve.wire import decode_input

DEFAULT_MODEL = "default"
GENERATE_PATH = "/generate"


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

    # -- not ported -------------------------------------------------------
    def handle_generate(self, url_path, body, on_token=None):
        """``POST /generate[/<name>]``: the generative route through the
        registry (the HTTP handler answers 501 with this message)."""
        _not_ported("ServingServer.handle_generate (POST %s)"
                    % GENERATE_PATH, "6(b)")

    def stream_generate(self, url_path, body):
        """The ndjson token stream of ``POST /generate``."""
        _not_ported("ServingServer.stream_generate (the ndjson token "
                    "stream)", "6(b)")

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
                self.wfile.write(body)

            def _reply_json(self, status, payload):
                self._reply(status, json.dumps(payload).encode(),
                            "application/json")

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
                    return
                self._trace_ctx = ctx
                with obs_context.activate(ctx):
                    with trace.span("serve", "http",
                                    ctx.span_args({"path": self.path}),
                                    role="server"):
                        self._handle_post(body)

            def _handle_post(self, body):
                if self.path == GENERATE_PATH or \
                        self.path.startswith(GENERATE_PATH + "/"):
                    try:
                        status, payload = server.handle_generate(
                            self.path, body)
                    except NotImplementedError as e:
                        status, payload = 501, {"error": str(e)}
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
