"""SLO engine: windowed objectives, burn rates, autoscaling signals.
The port's own copy of :mod:`veles_tpu.obs.slo`.

Three layers:

* :class:`SeriesRing`: a fixed-capacity ``(t, value)`` ring per
  signal, O(1) appends; windows are computed from a snapshot.
* :class:`Objective`: a declarative bound over one signal
  (``ttft_p99_ms < 200 over 60 s``), read from the
  ``root.common.obs.slo.<signal>`` config namespace.  Compliance over
  a window is the fraction of samples inside the bound; the **burn
  rate** is ``(1 - compliance) / (1 - target)``: 1.0 drains the error
  budget at the sustainable pace, N drains it N times too fast.
* :class:`SLOEngine`: samples registered signal callables into rings,
  evaluates every objective over its fast and slow windows (an alert
  needs both above the threshold), and renders the result as
  ``/metrics`` gauges and a ``describe()`` dict.

The three autoscaling signals (:data:`AUTOSCALING_SIGNALS`: queue
depth, batch fill, TTFT p99 burn rate) are always exported, with or
without declared objectives.
"""

import threading
import time

from veles_tpu_torch.config import root

#: the ROADMAP autoscaling triple every serving deployment exports
AUTOSCALING_SIGNALS = ("queue_depth", "batch_fill",
                      "ttft_p99_burn_rate")

#: default multi-window pair (seconds) and burn threshold — the SRE
#: fast/slow-window shape scaled to serving horizons: the fast window
#: catches a cliff within seconds, the slow window confirms it is not
#: one bad scrape
DEFAULT_WINDOW_S = 60.0
DEFAULT_FAST_WINDOW_S = 5.0
DEFAULT_TARGET = 0.99
DEFAULT_BURN_THRESHOLD = 2.0


class SeriesRing(object):
    """Fixed-capacity time series: the newest ``capacity`` samples."""

    def __init__(self, capacity=1024):
        self.capacity = int(capacity)
        self._t = [0.0] * self.capacity
        self._v = [0.0] * self.capacity
        self._pos = 0
        self._lock = threading.Lock()

    def append(self, value, t=None):
        if t is None:
            t = time.time()
        with self._lock:
            idx = self._pos % self.capacity
            self._t[idx] = float(t)
            self._v[idx] = float(value)
            self._pos += 1

    def __len__(self):
        return min(self._pos, self.capacity)

    def last(self):
        """The newest ``(t, value)`` or ``None``."""
        with self._lock:
            if not self._pos:
                return None
            idx = (self._pos - 1) % self.capacity
            return (self._t[idx], self._v[idx])

    def window(self, seconds, now=None):
        """Samples with ``t >= now - seconds``, oldest→newest."""
        if now is None:
            now = time.time()
        cutoff = now - float(seconds)
        with self._lock:
            n = min(self._pos, self.capacity)
            start = self._pos - n
            items = [( self._t[i % self.capacity],
                       self._v[i % self.capacity])
                     for i in range(start, self._pos)]
        return [(t, v) for t, v in items if t >= cutoff]


class Objective(object):
    """One declared bound: ``signal`` ``op`` ``bound`` over
    ``window_s``, with a ``target`` compliance goal and a fast/slow
    burn-rate alert pair."""

    __slots__ = ("name", "signal", "op", "bound", "window_s",
                 "fast_window_s", "target", "burn_threshold")

    def __init__(self, signal, bound, op="<", window_s=DEFAULT_WINDOW_S,
                 fast_window_s=DEFAULT_FAST_WINDOW_S,
                 target=DEFAULT_TARGET,
                 burn_threshold=DEFAULT_BURN_THRESHOLD, name=None):
        if op not in ("<", ">"):
            raise ValueError("objective op must be '<' or '>', got %r"
                             % op)
        self.signal = str(signal)
        self.op = op
        self.bound = float(bound)
        self.window_s = float(window_s)
        self.fast_window_s = float(fast_window_s)
        self.target = float(target)
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1), got %r"
                             % target)
        self.burn_threshold = float(burn_threshold)
        self.name = name or "%s %s %g over %gs" % (
            self.signal, self.op, self.bound, self.window_s)

    def good(self, value):
        return value < self.bound if self.op == "<" \
            else value > self.bound

    def describe(self):
        return {"name": self.name, "signal": self.signal,
                "op": self.op, "bound": self.bound,
                "window_s": self.window_s,
                "fast_window_s": self.fast_window_s,
                "target": self.target,
                "burn_threshold": self.burn_threshold}


class SLOEngine(object):
    """Signals + objectives + evaluation, one instance per serving
    role (the :class:`~veles_tpu_torch.serve.server.ServingServer` owns
    one wired to its :class:`~veles_tpu_torch.serve.metrics.ServingMetrics`).

    Thread model: ``sample()`` is called by whoever scrapes (each
    ``/metrics`` GET) and by tests with explicit timestamps;
    ``evaluate()``/``metrics_text()``/``describe()`` read snapshots.
    """

    def __init__(self, ring_capacity=1024):
        self._signals = {}           # name -> (fn, SeriesRing)
        self._objectives = []
        self._ring_capacity = int(ring_capacity)
        #: objective name -> alert state (for alerts_total edges)
        self._alerting = {}
        self.alerts_total = 0
        #: extra exposition callable (the fleet autoscaler's gauges
        #: ride the same scrape) — see :meth:`attach_exposition`
        self._extra_text = None
        self._lock = threading.Lock()

    # -- declaration -------------------------------------------------------
    def add_signal(self, name, fn):
        """Register a 0-arg sampler; replaces any previous ``name``
        (rings survive replacement so a redeploy keeps history)."""
        with self._lock:
            old = self._signals.get(name)
            ring = old[1] if old else SeriesRing(self._ring_capacity)
            self._signals[name] = (fn, ring)
        return ring

    def ring(self, name):
        entry = self._signals.get(name)
        return entry[1] if entry else None

    def attach_exposition(self, fn):
        """Append an extra exposition source to this engine's
        ``/metrics`` text — the closed loop made visible: the fleet
        autoscaler CONSUMES :meth:`autoscaling_signals` and publishes
        its decisions (``veles_fleet_*`` gauges) back through the same
        scrape, so one endpoint shows signal and action side by side.
        ``fn`` returns exposition lines (or ``""``); a raising source
        is skipped, never poisoning the scrape."""
        self._extra_text = fn

    def add_objective(self, objective):
        if objective.signal not in self._signals:
            raise ValueError(
                "objective %r names unknown signal %r (registered: %s)"
                % (objective.name, objective.signal,
                   ", ".join(sorted(self._signals)) or "<none>"))
        self._objectives.append(objective)
        return objective

    @property
    def objectives(self):
        return list(self._objectives)

    def configure(self, node=None):
        """Read objectives from ``root.common.obs.slo.*`` (or a given
        config node / plain dict): each child is
        ``<signal>: {"max"|"min": bound, "window_s": ..., "target":
        ..., "fast_window_s": ..., "burn_threshold": ...}``.  Unknown
        signals are skipped with the declaration kept out (an SLO on
        a signal this role does not export cannot be evaluated
        honestly).  Returns the number of objectives installed."""
        if node is None:
            node = root.common.obs.get("slo")
        if node is None:
            return 0
        if hasattr(node, "to_dict"):
            node = node.to_dict()
        installed = 0
        for signal, spec in sorted((node or {}).items()):
            if not isinstance(spec, dict):
                continue
            if "max" in spec:
                op, bound = "<", spec["max"]
            elif "min" in spec:
                op, bound = ">", spec["min"]
            else:
                continue
            if signal not in self._signals:
                continue
            self.add_objective(Objective(
                signal, bound, op=op,
                window_s=spec.get("window_s", DEFAULT_WINDOW_S),
                fast_window_s=spec.get("fast_window_s",
                                       DEFAULT_FAST_WINDOW_S),
                target=spec.get("target", DEFAULT_TARGET),
                burn_threshold=spec.get("burn_threshold",
                                        DEFAULT_BURN_THRESHOLD)))
            installed += 1
        return installed

    # -- sampling / evaluation ----------------------------------------------
    def sample(self, now=None):
        """Poll every signal callable into its ring.  A sampler that
        raises contributes nothing this round (a half-closed scheduler
        mid-undeploy must not poison the scrape)."""
        with self._lock:
            items = list(self._signals.items())
        for _name, (fn, ring) in items:
            try:
                value = fn()
            except Exception:
                continue
            if value is None:
                continue
            ring.append(value, t=now)

    def compliance(self, signal, objective, window_s, now=None):
        """Fraction of the window's samples inside the bound, or
        ``None`` with no samples (no data is not the same as
        breaching)."""
        ring = self.ring(signal)
        if ring is None:
            return None
        samples = ring.window(window_s, now=now)
        if not samples:
            return None
        good = sum(1 for _t, v in samples if objective.good(v))
        return good / float(len(samples))

    def burn_rate(self, objective, window_s=None, now=None):
        """``(1 - compliance) / (1 - target)`` over the window; 0.0
        with no data (an idle service burns nothing)."""
        c = self.compliance(objective.signal, objective,
                            window_s or objective.window_s, now=now)
        if c is None:
            return 0.0
        return (1.0 - c) / (1.0 - objective.target)

    def evaluate(self, now=None):
        """Every objective → ``{objective, fast_burn, slow_burn,
        alerting}``.  ``alerting`` requires BOTH windows above the
        objective's burn threshold (the multi-window method);
        :attr:`alerts_total` counts raised edges only."""
        out = []
        for objective in self._objectives:
            fast = self.burn_rate(objective, objective.fast_window_s,
                                  now=now)
            slow = self.burn_rate(objective, objective.window_s,
                                  now=now)
            alerting = (fast >= objective.burn_threshold
                        and slow >= objective.burn_threshold)
            with self._lock:
                # edge detection under the lock: concurrent scrapes
                # (/metrics and /healthz both evaluate) must count ONE
                # raised edge per breach, not one per scraper
                was = self._alerting.get(objective.name, False)
                if alerting and not was:
                    self.alerts_total += 1
                self._alerting[objective.name] = alerting
            out.append({"objective": objective.name,
                        "signal": objective.signal,
                        "fast_burn": round(fast, 4),
                        "slow_burn": round(slow, 4),
                        "alerting": alerting})
        return out

    # -- the autoscaling triple ---------------------------------------------
    def autoscaling_signals(self, now=None):
        """The ROADMAP triple as current values: last queue depth,
        last batch fill, and the TTFT objective's fast-window burn
        rate (0.0 when no TTFT objective is declared or no data —
        an autoscaler reading zeros holds steady, which is the safe
        default)."""
        def last(name):
            ring = self.ring(name)
            sample = ring.last() if ring is not None else None
            return sample[1] if sample else 0.0

        ttft_burn = 0.0
        for objective in self._objectives:
            if objective.signal == "ttft_p99_ms":
                ttft_burn = self.burn_rate(
                    objective, objective.fast_window_s, now=now)
                break
        return {"queue_depth": last("queue_depth"),
                "batch_fill": last("batch_fill"),
                "ttft_p99_burn_rate": round(ttft_burn, 4)}

    # -- exposition ----------------------------------------------------------
    def metrics_text(self, now=None):
        """Prometheus gauges: the autoscaling triple (always), every
        signal's last sample, and per-objective burn rates + alert
        flags.  Families stay contiguous — one HELP/TYPE per name
        with label variants grouped (the exposition contract)."""
        signals = self.autoscaling_signals(now=now)
        lines = [
            "# HELP veles_slo_queue_depth autoscaling signal: queued "
            "rows + generation requests (last sample)",
            "# TYPE veles_slo_queue_depth gauge",
            "veles_slo_queue_depth %g" % signals["queue_depth"],
            "# HELP veles_slo_batch_fill autoscaling signal: decode/"
            "bucket row utilisation (last sample)",
            "# TYPE veles_slo_batch_fill gauge",
            "veles_slo_batch_fill %g" % signals["batch_fill"],
            "# HELP veles_slo_ttft_p99_burn_rate autoscaling signal: "
            "TTFT p99 objective fast-window burn rate (1.0 = budget "
            "drains at the sustainable pace)",
            "# TYPE veles_slo_ttft_p99_burn_rate gauge",
            "veles_slo_ttft_p99_burn_rate %g"
            % signals["ttft_p99_burn_rate"],
        ]
        with self._lock:
            names = sorted(self._signals)
        if names:
            lines.append("# HELP veles_slo_signal last sampled value "
                         "per registered SLO signal")
            lines.append("# TYPE veles_slo_signal gauge")
            for name in names:
                sample = self.ring(name).last()
                if sample is not None:
                    lines.append('veles_slo_signal{signal="%s"} %g'
                                 % (name, sample[1]))
        results = self.evaluate(now=now)
        if results:
            lines.append("# HELP veles_slo_burn_rate error-budget "
                         "burn rate per objective and window")
            lines.append("# TYPE veles_slo_burn_rate gauge")
            for res in results:
                for window in ("fast", "slow"):
                    lines.append(
                        'veles_slo_burn_rate{objective="%s",'
                        'window="%s"} %g'
                        % (res["objective"], window,
                           res["%s_burn" % window]))
            lines.append("# HELP veles_slo_alerting 1 when both burn "
                         "windows exceed the objective's threshold")
            lines.append("# TYPE veles_slo_alerting gauge")
            for res in results:
                lines.append('veles_slo_alerting{objective="%s"} %d'
                             % (res["objective"],
                                1 if res["alerting"] else 0))
        lines.append("# TYPE veles_slo_alerts_total counter")
        lines.append("veles_slo_alerts_total %d" % self.alerts_total)
        if self._extra_text is not None:
            try:
                extra = self._extra_text()
            except Exception:
                extra = ""
            if extra:
                lines.append(extra.rstrip("\n"))
        return "\n".join(lines) + "\n"

    def describe(self):
        """JSON-able digest for ``describe()``/``/healthz`` surfaces:
        the autoscaling triple, per-signal last samples, objective
        declarations and their current evaluation."""
        with self._lock:
            names = sorted(self._signals)
        signals = {}
        for name in names:
            sample = self.ring(name).last()
            if sample is not None:
                signals[name] = round(sample[1], 4)
        return {
            "autoscaling": self.autoscaling_signals(),
            "signals": signals,
            "objectives": [o.describe() for o in self._objectives],
            "evaluation": self.evaluate(),
            "alerts_total": self.alerts_total,
        }


def standard_engine(metrics, configure=True):
    """The serving wiring: an :class:`SLOEngine` whose signals read a
    :class:`~veles_tpu_torch.serve.metrics.ServingMetrics` instance —

    * ``queue_depth``: the sum of every registered queue-depth gauge
      (request/response batchers AND generative schedulers);
    * ``batch_fill``: the generative schedulers' mean decode fill when
      any are deployed, else the batcher fill ratio;
    * ``ttft_p99_ms``: the worst per-model generative TTFT p99.

    Gauges register and unregister with deploys, so the samplers walk
    the CURRENT gauge table on every sample — a redeploy changes what
    is measured without rewiring the engine."""

    def gauge_values(prefix):
        out = []
        for name, fn in metrics._gauge_items():
            if name == prefix or name.startswith(prefix + "{"):
                try:
                    out.append(float(fn()))
                except Exception:
                    continue
        return out

    def queue_depth():
        depth = sum(gauge_values("queue_depth"))
        depth += sum(gauge_values("gen_queue_depth"))
        return depth

    def batch_fill():
        fills = gauge_values("gen_batch_fill")
        if fills:
            return sum(fills) / len(fills)
        return metrics.batch_fill_ratio()

    def ttft_p99_ms():
        values = gauge_values("gen_ttft_p99_ms")
        return max(values) if values else 0.0

    engine = SLOEngine()
    engine.add_signal("queue_depth", queue_depth)
    engine.add_signal("batch_fill", batch_fill)
    engine.add_signal("ttft_p99_ms", ttft_p99_ms)
    if configure:
        engine.configure()
    return engine
