"""Per-role scrape endpoints: a process's ``/metrics`` beyond the
serving server.

The port's counterpart of :mod:`veles_tpu.obs.scrape`.
:class:`ScrapeServer` is a threaded HTTP listener serving ``GET
/metrics`` (the concatenation of a list of text-producing sources, each
guarded: one failing source must not blank the page for the rest) and
``GET /healthz``.  :func:`default_sources` is the process-wide base:
the perf-ledger gauges always, the trace category counters when tracing
is on, a declared :class:`~veles_tpu_torch.obs.slo.SLOEngine` when
given, and the training-health source (:func:`veles_tpu_torch.watch
.metrics_text`: the health gauges and the bus counters, empty when
neither is armed).  The job master and its slaves mount their own
(``JobServer.start_scrape``, ``JobClient.start_scrape``,
:mod:`veles_tpu_torch.parallel.jobs`).

The exposition text comes from the same renderers the serving
``/metrics`` page uses, so one Prometheus config scrapes every role
with identical families.
"""

import json
import threading

from veles_tpu_torch.logger import Logger


def default_sources(slo=None, extra=()):
    """The process-wide base every role shares: perf-ledger gauges
    (always on — the ledger has no knob), trace counters when tracing
    is enabled, the training-health gauges and bus counters, an
    optional SLO engine (sampled per scrape), plus any role-specific
    callables."""
    from veles_tpu_torch import prof, trace

    sources = [prof.metrics_text]

    def trace_source():
        return trace.metrics_text() if trace.enabled() else ""

    sources.append(trace_source)

    def watch_source():
        from veles_tpu_torch import watch
        return watch.metrics_text()

    sources.append(watch_source)
    if slo is not None:
        def slo_source():
            slo.sample()
            return slo.metrics_text()

        sources.append(slo_source)
    sources.extend(extra)
    return sources


class ScrapeServer(Logger):
    """Threaded ``/metrics`` + ``/healthz`` listener over a list of
    text sources.  ``port=0`` binds an ephemeral port (read it back
    from ``self.port`` after :meth:`start`)."""

    def __init__(self, sources, host="127.0.0.1", port=0,
                 role="process", **kwargs):
        super(ScrapeServer, self).__init__(**kwargs)
        self.sources = list(sources)
        self.host = host
        self.port = int(port)
        self.role = str(role)
        self._httpd = None
        self._thread = None

    def render(self):
        """Concatenate every source, each guarded: a raising source
        contributes a comment line naming itself instead of killing
        the scrape (a half-closed engine mid-undeploy must degrade,
        not 500)."""
        parts = []
        for source in self.sources:
            try:
                text = source()
            except Exception as e:  # noqa: BLE001 - exposition edge
                text = "# scrape source %s failed: %s\n" % (
                    getattr(source, "__name__", source), e)
            if text:
                parts.append(text if text.endswith("\n")
                             else text + "\n")
        return "".join(parts)

    def start(self):
        if self._httpd is not None:
            return self
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _reply(self, status, body, content_type):
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    self._reply(200, server.render().encode(),
                                "text/plain; version=0.0.4")
                elif self.path == "/healthz":
                    self._reply(200, json.dumps(
                        {"status": "ok",
                         "role": server.role}).encode(),
                        "application/json")
                else:
                    self._reply(404, json.dumps(
                        {"error": "no route %r" % self.path}).encode(),
                        "application/json")

            def log_message(self, fmt, *args):
                server.debug("scrape: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="obs-scrape-%s" % self.role)
        self._thread.start()
        self.info("%s scrape endpoint on http://%s:%d/metrics",
                  self.role, self.host, self.port)
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
