"""ModelRegistry: named models, atomic hot swap, replica sets with a
weighted traffic split.  The port's counterpart of
:mod:`veles_tpu.serve.registry`, its request/response half.

Each name owns ONE :class:`~veles_tpu_torch.serve.batcher.DynamicBatcher`
(so queued requests survive a version change) and a current
:class:`~veles_tpu_torch.serve.engine.InferenceEngine`.  Deploying a new
version is one attribute assignment on the batcher: requests already
inside a bucket call finish on the old engine; every batch formed after
the swap runs on the new one.  A :class:`ReplicaSet` is engine-shaped
and routes each batch to one member by smooth weighted round-robin
(deterministic, proportional at every prefix); ``deploy_canary`` is the
two-member case.

Generative engines (:mod:`veles_tpu_torch.gen`) deploy through
:meth:`ModelRegistry.deploy_generative`, which gives the name a
continuous-batching scheduler instead of a batcher and preflights the
KV-cache plan (rule V-S01, :mod:`veles_tpu_torch.analyze.shapes`)
under ``root.common.serve.preflight``; a redeploy is a drain swap.

``load_snapshot`` deploys a :mod:`veles_tpu_torch.snapshotter`
artifact as ``load_workflow`` deploys a workflow.

Not ported, each raising ``NotImplementedError`` naming its ROADMAP
item: ``deploy_fleet`` (7(d)) and the analyzer preflight that
``load_workflow`` and ``load_snapshot`` run under
``root.common.serve.preflight`` = ``warn`` (the default) or ``fail``
(7(e)): set it to ``off`` to load a workflow or a snapshot.  ``deploy``
never preflights.
"""

import threading
import time

from veles_tpu_torch.config import root
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.samples.transformer import _not_ported
from veles_tpu_torch.serve.batcher import DynamicBatcher
from veles_tpu_torch.serve.engine import InferenceEngine


class ReplicaSet(object):
    """Engine-shaped weighted router over same-shape engines.

    Members: ``[(engine, weight, version), ...]`` with positive
    weights.  Selection is smooth weighted round-robin (the nginx
    algorithm): each pick adds every member's weight to its running
    credit, serves the max-credit member, and subtracts the weight
    total — so a 3:1 split serves exactly 30/10 over any 40 calls and
    interleaves rather than bursting.  The batcher worker is the only
    caller of :meth:`infer`, so selection needs no lock; a lock still
    guards it because ``ServingServer`` exposes describe() scrapes
    concurrently.
    """

    def __init__(self, replicas):
        members = []
        for item in replicas:
            engine, weight, version = item
            weight = float(weight)
            if weight <= 0:
                raise ValueError("replica weight must be > 0, got %r"
                                 % weight)
            members.append({"engine": engine, "weight": weight,
                            "version": version, "credit": 0.0,
                            "served": 0})
        if not members:
            raise ValueError("empty replica set")
        shapes = {tuple(m["engine"].sample_shape) for m in members
                  if hasattr(m["engine"], "sample_shape")}
        if len(shapes) > 1:
            raise ValueError(
                "replica engines disagree on sample shape: %s"
                % sorted(shapes))
        self._members = members
        self._total_weight = sum(m["weight"] for m in members)
        self._lock = threading.Lock()

    # -- engine protocol (what DynamicBatcher/_Model touch) ---------------
    @property
    def sample_shape(self):
        return self._members[0]["engine"].sample_shape

    @property
    def max_batch_size(self):
        return min(m["engine"].max_batch_size for m in self._members)

    @property
    def buckets(self):
        return self._members[0]["engine"].buckets

    @property
    def compile_count(self):
        return sum(m["engine"].compile_count for m in self._members)

    def warmup(self):
        for member in self._members:
            member["engine"].warmup()
        return self

    def padded_capacity(self, n):
        return self._members[0]["engine"].padded_capacity(n)

    def _next(self):
        with self._lock:
            for member in self._members:
                member["credit"] += member["weight"]
            best = max(self._members, key=lambda m: m["credit"])
            best["credit"] -= self._total_weight
            best["served"] += 1
            return best

    def infer(self, batch):
        return self._next()["engine"].infer(batch)

    def pick(self):
        """One smooth-WRR selection, returned as the member engine —
        the routing surface for callers that dispatch themselves (the
        fleet's decode router) instead of riding :meth:`infer`."""
        return self._next()["engine"]

    def engines(self):
        """Snapshot of every member engine, construction order — lets
        the fleet iterate its decode schedulers (drain, describe,
        signal sampling) without reaching into the member dicts."""
        with self._lock:
            return [m["engine"] for m in self._members]

    # -- reconfiguration (the autoscaler's surface) ------------------------
    def set_weights(self, weights):
        """Re-weight every member in place (positional, construction /
        ``describe()`` order) and RESET the smooth-WRR credits: the
        credits are denominated in the OLD weight total, so carrying
        them across a re-weight skews the first rotation toward
        whoever was owed traffic under the old split — a 3:1 → 1:1
        shift must serve exactly 1:1 from the very next rotation."""
        weights = [float(w) for w in weights]
        if len(weights) != len(self._members):
            raise ValueError(
                "got %d weight(s) for %d member(s)"
                % (len(weights), len(self._members)))
        if any(w <= 0 for w in weights):
            raise ValueError("replica weights must be > 0, got %r"
                             % (weights,))
        with self._lock:
            for member, weight in zip(self._members, weights):
                member["weight"] = weight
                member["credit"] = 0.0
            self._total_weight = sum(weights)

    def add_replica(self, engine, weight=1.0, version=None):
        """Grow the set by one member (scale-up).  Credits reset —
        the new split starts clean, same reasoning as
        :meth:`set_weights`."""
        weight = float(weight)
        if weight <= 0:
            raise ValueError("replica weight must be > 0, got %r"
                             % weight)
        with self._lock:
            if hasattr(engine, "sample_shape"):
                shapes = {tuple(m["engine"].sample_shape)
                          for m in self._members
                          if hasattr(m["engine"], "sample_shape")}
                if shapes and {tuple(engine.sample_shape)} != shapes:
                    raise ValueError(
                        "new replica's sample shape %s disagrees with "
                        "the set's %s" % (tuple(engine.sample_shape),
                                          sorted(shapes)))
            if version is None:
                version = len(self._members)
            self._members.append({"engine": engine, "weight": weight,
                                  "version": version, "credit": 0.0,
                                  "served": 0})
            for member in self._members:
                member["credit"] = 0.0
            self._total_weight = sum(m["weight"]
                                     for m in self._members)
        return version

    def remove_replica(self, version):
        """Shrink the set by the member deployed as ``version``
        (scale-down) and return its engine — the caller drains it.
        Refuses to empty the set."""
        with self._lock:
            if len(self._members) == 1:
                raise ValueError(
                    "cannot remove the last replica — undeploy the "
                    "set instead")
            for index, member in enumerate(self._members):
                if member["version"] == version:
                    break
            else:
                raise KeyError("no replica with version %r (have %s)"
                               % (version,
                                  [m["version"]
                                   for m in self._members]))
            removed = self._members.pop(index)
            for member in self._members:
                member["credit"] = 0.0
            self._total_weight = sum(m["weight"]
                                     for m in self._members)
        return removed["engine"]

    def __len__(self):
        return len(self._members)

    # -- introspection -----------------------------------------------------
    def describe(self):
        with self._lock:
            return [{"version": m["version"],
                     "weight": m["weight"],
                     "served": m["served"],
                     "engine": getattr(m["engine"], "prof_name", None)}
                    for m in self._members]


class _Model(object):
    """One served name: stable batcher + swappable engine + metadata."""

    __slots__ = ("name", "batcher", "version", "deployed_at", "swaps",
                 "source")

    is_generative = False

    def __init__(self, name, batcher):
        self.name = name
        self.batcher = batcher
        self.version = None
        self.deployed_at = None
        self.swaps = 0
        self.source = None

    @property
    def engine(self):
        return self.batcher.engine

    def describe(self):
        info = {
            "name": self.name,
            "version": self.version,
            "deployed_at": self.deployed_at,
            "swaps": self.swaps,
            "source": self.source,
            "buckets": list(self.engine.buckets),
            "compile_count": self.engine.compile_count,
            "queue_depth": self.batcher.queue_depth(),
        }
        if not isinstance(self.engine, ReplicaSet) \
                and hasattr(self.engine, "describe"):
            # engine-level surface (quant mode, actual params bytes,
            # sharding) — dashboards read the int8 win from here; a
            # ReplicaSet's describe() is its per-member LIST and is
            # reported under "replicas" below instead
            info.update(self.engine.describe())
        if isinstance(self.engine, ReplicaSet):
            # per-replica weights/versions/served counts — rollout
            # dashboards and tests assert canary splits from here
            # instead of reaching into privates
            info["replicas"] = self.engine.describe()
        return info


class _GenModel(object):
    """One served GENERATIVE name: engine + continuous scheduler."""

    __slots__ = ("name", "scheduler", "version", "deployed_at",
                 "source")

    is_generative = True

    def __init__(self, name, scheduler):
        self.name = name
        self.scheduler = scheduler
        self.version = None
        self.deployed_at = None
        self.source = None

    @property
    def engine(self):
        return self.scheduler.engine

    def describe(self):
        info = {
            "name": self.name,
            "version": self.version,
            "deployed_at": self.deployed_at,
            "source": self.source,
            "generative": True,
        }
        info.update(self.engine.describe())
        info.update(self.scheduler.describe())
        return info


class ModelRegistry(Logger):
    """Name → model map with atomic deploy/swap (thread-safe)."""

    def __init__(self, metrics=None, batcher_config=None, **kwargs):
        super(ModelRegistry, self).__init__(**kwargs)
        self.metrics = metrics
        self.batcher_config = dict(batcher_config or {})
        self._models = {}
        self._lock = threading.Lock()
        if metrics is not None:
            metrics.register_gauge("models", lambda: len(self._models))

    def attach_metrics(self, metrics):
        """Adopt a metrics sink after construction (the ServingServer
        path when it is handed a metrics-less registry): existing AND
        future batchers record into it, so /metrics never silently
        reports zeros under real traffic."""
        self.metrics = metrics
        metrics.register_gauge("models", lambda: len(self._models))
        with self._lock:
            for name, model in self._models.items():
                if model.is_generative:
                    model.scheduler.attach_metrics(metrics)
                    continue
                model.batcher.metrics = metrics
                metrics.register_gauge(
                    'queue_depth{model="%s"}' % name,
                    model.batcher.queue_depth)

    def _resolve_quantize(self, quantize):
        """The deploy-time quant mode: the explicit argument, else the
        ``root.common.serve.quantize`` knob (default off).  Returns
        ``"int8"`` or ``None``; a typo'd mode raises instead of
        silently deploying float."""
        if quantize is None:
            quantize = root.common.serve.get("quantize", "off")
        mode = str(quantize).strip().lower()
        if mode in ("off", "no", "false", "0", "none", ""):
            return None
        if mode != "int8":
            raise ValueError(
                "quantize mode %r — want off | int8 (the knob is "
                "root.common.serve.quantize)" % (quantize,))
        return "int8"

    def deploy(self, name, engine, version=None, source=None,
               warmup=True, allow_reshape=False, quantize=None,
               calibration=None):
        """Install ``engine`` as the current version of ``name``.

        First deploy for a name creates its batcher; later deploys
        hot-swap the engine atomically — in-flight batches finish on
        the previous version, the queue is preserved.  ``warmup=True``
        AOT-compiles the new engine's buckets BEFORE the swap, so the
        first post-swap batch pays zero compile latency.

        ``quantize="int8"`` (or the ``root.common.serve.quantize``
        knob) quantizes the engine's params in place BEFORE warmup
        (``InferenceEngine.quantize_int8`` — per-output-channel
        symmetric int8, biases float), with ``calibration`` as the
        optional drift-gate batch; replica sets must quantize their
        member engines individually (the set itself is refused).

        A swap that CHANGES the model's sample shape is refused unless
        ``allow_reshape=True`` (queued old-shape requests cannot be
        honored by the new engine — deploy a different topology under
        a new name, or opt in and let those requests fail with a shape
        error while new-shape traffic proceeds).
        """
        mode = self._resolve_quantize(quantize)
        if mode and getattr(engine, "quantized", None) != mode:
            if not hasattr(engine, "quantize_int8"):
                if quantize is not None:
                    raise ValueError(
                        "%s cannot be quantized at deploy — quantize "
                        "the member engines individually"
                        % type(engine).__name__)
                self.warning(
                    "serve.quantize knob is on but %s has no "
                    "quantize_int8 — deploying as-is",
                    type(engine).__name__)
            else:
                engine.quantize_int8(calibration=calibration)
        if warmup:
            engine.warmup()
        with self._lock:
            model = self._models.get(name)
            if model is not None and model.is_generative:
                raise ValueError(
                    "%r serves a generative model — undeploy it (or "
                    "deploy_generative a successor) instead of hot-"
                    "swapping a request/response engine over token "
                    "streams" % name)
            if model is None:
                batcher = DynamicBatcher(
                    engine, metrics=self.metrics,
                    gauge_name='queue_depth{model="%s"}' % name,
                    **self.batcher_config)
                model = _Model(name, batcher)
                self._models[name] = model
            else:
                old_shape = getattr(model.engine, "sample_shape", None)
                new_shape = getattr(engine, "sample_shape", None)
                if (not allow_reshape
                        and old_shape is not None
                        and new_shape is not None
                        and tuple(old_shape) != tuple(new_shape)):
                    raise ValueError(
                        "hot swap of %r changes sample shape %s -> %s;"
                        " deploy under a new name or pass "
                        "allow_reshape=True" % (name, tuple(old_shape),
                                                tuple(new_shape)))
                retired = model.batcher.engine
                model.batcher.engine = engine   # THE hot swap
                model.swaps += 1
                self._retire_engine(retired, engine)
            model.version = version if version is not None \
                else (model.swaps + 1)
            model.deployed_at = time.time()
            model.source = source
        self.info("deployed %s version %s%s", name, model.version,
                  " (hot swap #%d)" % model.swaps if model.swaps
                  else "")
        return model

    @staticmethod
    def _retire_engine(retired, successor):
        """Drop a swapped-out engine's HBM-ledger hold (close() only
        releases accounting; in-flight batches finish unharmed) —
        UNLESS the successor still serves it (the canary path wraps
        the stable engine inside the incoming ReplicaSet)."""
        if retired is None or retired is successor:
            return
        members = []
        if isinstance(successor, ReplicaSet):
            members = [m["engine"] for m in successor._members]
        if retired in members:
            return
        if isinstance(retired, ReplicaSet):
            # promotion: the winning member survives inside successor
            # deploys only if it IS the successor (checked above)
            for member in retired._members:
                if member["engine"] is not successor:
                    ModelRegistry._retire_engine(member["engine"],
                                                 successor)
            return
        close = getattr(retired, "close", None)
        if close is not None:
            close()

    def deploy_replica_set(self, name, replicas, version=None,
                           source=None, warmup=True,
                           allow_reshape=False, quantize=None,
                           calibration=None):
        """Deploy a weighted :class:`ReplicaSet` under ``name``.

        ``replicas``: ``[(engine, weight), ...]`` or ``[(engine,
        weight, version), ...]`` — weights are relative (3 and 1 split
        75/25).  Same atomic swap as :meth:`deploy`: the set IS the
        batcher's engine, so the split applies from the next batch
        boundary and in-flight batches finish where they started.
        """
        normalized = []
        for index, item in enumerate(replicas):
            if len(item) == 2:
                engine, weight = item
                rep_version = index
            else:
                engine, weight, rep_version = item
            normalized.append((engine, weight, rep_version))
        replica_set = ReplicaSet(normalized)
        return self.deploy(name, replica_set, version=version,
                           source=source or "replica_set",
                           warmup=warmup, allow_reshape=allow_reshape,
                           quantize=quantize, calibration=calibration)

    def deploy_canary(self, name, engine, weight=0.1, version=None,
                      warmup=True):
        """Split ``name``'s traffic: the CURRENT engine keeps
        ``1 - weight``, the candidate gets ``weight``.  Promote by
        deploying the candidate plainly (or widen the split with
        another ``deploy_canary``).  The current engine may itself be
        a ReplicaSet — the canary then rides on top of the set as one
        member, which is almost never what a rollout means, so that
        case is refused; finish one experiment before starting the
        next."""
        weight = float(weight)
        if not 0.0 < weight < 1.0:
            raise ValueError("canary weight must be in (0, 1), got %r"
                             % weight)
        model = self.get(name)
        if model.is_generative:
            raise ValueError("canary rollout of generative models is "
                             "not supported yet")
        stable = model.engine
        if isinstance(stable, ReplicaSet):
            raise ValueError(
                "%r already serves a replica set — promote or undeploy "
                "the running experiment before starting a new canary"
                % name)
        return self.deploy_replica_set(
            name,
            [(stable, 1.0 - weight, model.version),
             (engine, weight, version
              if version is not None else "canary")],
            version=model.version, source="canary", warmup=warmup)

    # -- generative deploys ------------------------------------------------
    @staticmethod
    def _preflight_mode():
        """``root.common.serve.preflight``, checked: a typo'd fail-mode
        config must not silently downgrade to warn-and-deploy."""
        mode = str(root.common.serve.get("preflight",
                                         "warn")).strip().lower()
        if mode not in ("off", "no", "false", "0", "warn", "fail"):
            raise ValueError(
                "root.common.serve.preflight is %r — want off | warn "
                "| fail" % mode)
        return None if mode in ("off", "no", "false", "0") else mode

    def preflight_generative(self, engine, name=None):
        """Analyzer rule V-S01 at deploy time, honouring
        ``root.common.serve.preflight``: ``off`` returns None, ``warn``
        (the default) logs every finding and returns the report,
        ``fail`` raises :class:`veles_tpu_torch.analyze.PreflightError`
        when it holds errors.  KV-cache footprint against the card's
        memory, slot and bucket plan sanity, and non-causal models:
        refused at the registry, not at the first streamed token."""
        mode = self._preflight_mode()
        if mode is None:
            return None
        from veles_tpu_torch.analyze import PreflightError
        from veles_tpu_torch.analyze.shapes import check_generative
        report = check_generative(engine)
        label = name or getattr(engine, "prof_name", "generative")
        for finding in report:
            log = {"error": self.error,
                   "warning": self.warning}.get(finding.severity,
                                                self.info)
            log("preflight[%s]: %s", label, finding.render())
        if report.has_errors and mode == "fail":
            raise PreflightError(report)
        return report

    def deploy_generative(self, name, engine, version=None,
                          source=None, warmup=True,
                          scheduler_config=None, quantize=None,
                          calibration=None):
        """Install a :class:`veles_tpu_torch.gen.engine.GenerativeEngine`
        under ``name`` with its own continuous-batching scheduler
        (started on a worker thread).  Redeploying a generative name is
        a DRAIN swap: the old scheduler finishes its streams, its engine
        releases the KV cache, then the successor takes over (token
        streams cannot migrate between engines mid-request).

        ``quantize="int8"`` (or the ``root.common.serve.quantize`` knob)
        quantizes the engine's params BEFORE the V-S01 preflight and
        warmup (``GenerativeEngine.quantize_int8``), so the preflight
        prices the deploy from the actual int8 bytes; ``calibration``
        is the optional drift-gate token prompt."""
        mode = self._resolve_quantize(quantize)
        if mode and getattr(engine, "quantized", None) != mode:
            engine.quantize_int8(calibration_tokens=calibration)
        self.preflight_generative(engine, name)
        if warmup:
            engine.warmup()
        from veles_tpu_torch.gen.scheduler import GenerativeScheduler
        scheduler = GenerativeScheduler(
            engine, metrics=self.metrics, name=name,
            **dict(scheduler_config or {})).start()
        with self._lock:
            old = self._models.get(name)
            if old is not None and not old.is_generative:
                scheduler.stop(drain=False)
                raise ValueError(
                    "%r serves a request/response model — undeploy it "
                    "before deploying a generative engine" % name)
            model = _GenModel(name, scheduler)
            model.version = version if version is not None else (
                (old.version + 1)
                if old is not None and
                isinstance(old.version, int) else 1)
            model.deployed_at = time.time()
            model.source = source
            self._models[name] = model
        if old is not None:
            old.scheduler.stop(drain=True)
            old.engine.close()
        self.info("deployed generative %s version %s (%d slots, "
                  "buckets %s)", name, model.version,
                  engine.max_slots, list(engine.prefill_buckets))
        return model

    def deploy_fleet(self, name, fleet, version=None, source=None):
        """A disaggregated fleet under ``name``."""
        _not_ported("ModelRegistry.deploy_fleet (the disaggregated "
                    "fleet, behind the job protocol)", "7(e)")

    def generate(self, name, tokens, max_new_tokens=16, timeout=120.0,
                 on_token=None):
        """Stream a generation on ``name``'s scheduler (blocking
        convenience; returns the full token list)."""
        model = self.get(name)
        if not model.is_generative:
            raise ValueError("%r is not a generative model" % name)
        return model.scheduler.generate(tokens, max_new_tokens,
                                        timeout=timeout,
                                        on_token=on_token)

    def preflight(self, workflow, name=None):
        """The analyzer's preflight of a workflow about to be served,
        per ``root.common.serve.preflight``: ``"off"`` skips it (returns
        None); ``"warn"`` (the default) and ``"fail"`` run the analyzer,
        which is not ported, and raise ``NotImplementedError`` naming
        item 7(e); any other value is a ``ValueError``, as in the JAX
        package.  The generative deploys' V-S01 preflight
        (:meth:`preflight_generative`) is ported and does not come
        through here."""
        mode = self._preflight_mode()
        if mode is None:
            return None
        _not_ported("ModelRegistry.preflight with root.common.serve"
                    ".preflight=%r (analyze/; set it to 'off' to serve "
                    "without the analyzer)" % mode, "7(e)")

    def load_snapshot(self, name, path, version=None, engine_config=None,
                      warmup=True):
        """Load a snapshot artifact (:func:`veles_tpu_torch.snapshotter
        .load_snapshot`), preflight it (see :meth:`preflight`), build
        the engine with :meth:`InferenceEngine.from_workflow` (on the
        card unless ``engine_config`` says ``device="cpu"``) and deploy
        it."""
        from veles_tpu_torch.snapshotter import load_snapshot
        workflow = load_snapshot(path)
        self.preflight(workflow, name)
        engine = InferenceEngine.from_workflow(
            workflow, **dict(engine_config or {}))
        return self.deploy(name, engine, version=version, source=path,
                           warmup=warmup)

    def load_workflow(self, name, workflow, version=None,
                      engine_config=None, warmup=True):
        """Preflight (see :meth:`preflight`), build the engine with
        :meth:`InferenceEngine.from_workflow` and deploy it."""
        self.preflight(workflow, name)
        engine = InferenceEngine.from_workflow(
            workflow, **dict(engine_config or {}))
        return self.deploy(name, engine, version=version,
                           source=type(workflow).__name__,
                           warmup=warmup)

    def get(self, name):
        model = self._models.get(name)
        if model is None:
            raise KeyError("no model %r (serving: %s)"
                           % (name, ", ".join(sorted(self._models))
                              or "<none>"))
        return model

    def __contains__(self, name):
        return name in self._models

    def undeploy(self, name, drain=True):
        """Remove ONE served name: stop its batcher, drop its gauge,
        free the entry — the single-model counterpart of :meth:`stop`."""
        with self._lock:
            model = self._models.pop(name, None)
        if model is None:
            raise KeyError("no model %r" % name)
        if model.is_generative:
            # the scheduler's stop() drops its own gauges
            model.scheduler.stop(drain=drain)
            model.engine.close()
        else:
            if self.metrics is not None:
                self.metrics.unregister_gauge(
                    'queue_depth{model="%s"}' % name)
            model.batcher.stop(drain=drain)
            self._retire_engine(model.engine, None)
        self.info("undeployed %s", name)
        return model

    def names(self):
        with self._lock:   # a first deploy may be inserting a key
            return sorted(self._models)

    def describe(self):
        with self._lock:
            models = dict(self._models)
        return {name: model.describe()
                for name, model in sorted(models.items())}

    def extra_metrics_text(self):
        """Exposition lines contributed by deployed models themselves
        (a model with a ``metrics_text()``: the JAX package's fleets,
        item 7(d); a generative model's gauges ride on the metrics sink
        instead).  A raising source is skipped, never poisoning the
        scrape."""
        with self._lock:
            models = list(self._models.values())
        parts = []
        for model in models:
            fn = getattr(model, "metrics_text", None)
            if fn is None:
                continue
            try:
                parts.append(fn())
            except Exception:
                self.exception("metrics_text source failed")
        return "".join(parts)

    def submit(self, name, rows):
        """Queue rows on ``name``'s batcher; returns the Future."""
        model = self.get(name)
        if model.is_generative:
            raise ValueError(
                "%r is generative — use generate()/the /generate "
                "route, not the request/response path" % name)
        return model.batcher.submit(rows)

    def infer(self, name, rows, timeout=30.0):
        return self.submit(name, rows).result(timeout)

    def stop(self, drain=True):
        with self._lock:
            models, self._models = dict(self._models), {}
        if self.metrics is not None:
            # a shared sink outlives this registry: stale gauges would
            # keep reporting dead models (and pin their engines' device
            # params against GC)
            self.metrics.unregister_gauge("models")
            for name in models:
                self.metrics.unregister_gauge(
                    'queue_depth{model="%s"}' % name)
        for model in models.values():
            if model.is_generative:
                model.scheduler.stop(drain=drain)
                model.engine.close()
            else:
                model.batcher.stop(drain=drain)
                self._retire_engine(model.engine, None)
