"""InferenceEngine: a trained model's forward, one CUDA graph per batch
bucket.  The port's counterpart of :mod:`veles_tpu.serve.engine`.

The JAX engine AOT-compiles one XLA program per power-of-two batch
bucket; here each bucket is one :class:`veles_tpu_torch.stitch
.CapturedGraph` over a static ``(bucket,) + sample_shape`` float32
input on the card.  :meth:`InferenceEngine.warmup` runs each bucket's
forward once eagerly (the kernels load) and captures it;
``compile_count`` counts captures as the JAX count counts compiles, and
a capture or recapture after ``warmup()`` goes through
:func:`veles_tpu_torch.prof.flag_recompile`.  On the CPU a bucket is
the eager forward over the padded batch, counted once per bucket.

- **Params on the device once.**  The constructor places the host
  params (a list of ``{"w", "b"}`` numpy dicts, the JAX engine's
  layout) on the device.  A graph reads fixed addresses, so
  :meth:`update_params` copies new values into those tensors instead of
  rebinding them.
- **One engine lock, one stream.**  A bucket call (the padded batch's
  host-to-device copy, the replay and the copy of its rows back to the
  host), a params copy, a capture and :meth:`reference_forward` each
  hold the engine's lock and run on the engine's own CUDA stream, so a
  call sees the old or the new params whole, never a mix, and the
  batcher's worker threads replay graphs captured on another thread.
- **Buckets are row-independent.**  The served forwards (dense layers,
  activations, softmax) act on each row alone, so the padded rows
  cannot reach the real ones, and a bucket's rows equal
  :meth:`InferenceEngine.reference_forward` at the exact shape when the
  kernels' per-row order does not depend on M (on the card: the GEMM's
  ``plan`` at the served shapes; ``tests/test_torch_serve.py`` on the
  CPU).

:meth:`InferenceEngine.from_snapshot` serves a
:mod:`veles_tpu_torch.snapshotter` artifact: the snapshot holds host
arrays only, so it loads anywhere, and the engine places its params on
its own device (the card unless ``device="cpu"``).

``mesh`` / ``param_specs``: the mesh-sharded forward.  Every rank of a
:class:`~veles_tpu_torch.parallel.mesh.Mesh` (over ``torch.distributed``'s
default group) serves the same request batches in lockstep, as the JAX
engine replicates them; ``param_specs`` (a spec tree matching the params
tree, or a callable ``leaf -> spec or None`` such as
:func:`veles_tpu_torch.parallel.dp.tp_rules`; None replicates) stores
each leaf it shards as this rank's slice, which the forward all-gathers
before use, inside the bucket's graph.  A None mesh, or one of a single
rank, is the transparent fallback: the single-device path, with no
wrapper at all.
"""

import contextlib
import itertools
import threading
import time

import numpy
import torch

from veles_tpu_torch import prof, quant, trace
from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.memory import Watcher
from veles_tpu_torch.ops import cost

#: per-process engine sequence for performance-ledger entry names
_ENGINE_SEQ = itertools.count()


def infer_sample_shape(workflow, forwards):
    """One sample's shape from the first forward's ``input`` or the
    loader's minibatch buffer; ``None`` when neither is declared."""
    first = forwards[0] if forwards else None
    inp = getattr(first, "input", None)
    shape = getattr(inp, "shape", None)
    if shape and len(shape) > 1:
        return tuple(shape[1:])
    loader = getattr(workflow, "loader", None)
    data = getattr(loader, "minibatch_data", None)
    shape = getattr(data, "shape", None)
    if shape and len(shape) > 1:
        return tuple(shape[1:])
    return None


def forward_stages(forwards):
    """Validate the pure-function protocol over a forward chain and
    return its stages: ``[(pure_fn, config, skip_at_eval)]``.  A port
    forward's ``pure(params, x)`` is a method whose unit holds its
    static configuration (activation, storage layout), so ``config`` is
    empty.  Raises ``ValueError`` naming the units without it."""
    from veles_tpu_torch.znicz.nn_units import ForwardBase
    forwards = list(forwards)
    if not forwards:
        raise ValueError("empty forward chain")

    def servable(u):
        pure = getattr(type(u), "pure", None)
        return (callable(pure) and pure is not ForwardBase.pure
                and callable(getattr(u, "pure_params", None)))

    unservable = [u for u in forwards if not servable(u)]
    if unservable:
        raise ValueError(
            "forward unit(s) %s lack the pure-function protocol "
            "(`pure(params, x)` plus `pure_params()`) and cannot be "
            "served by the batching engine — keep such workflows "
            "on a custom serving path" %
            ", ".join(type(u).__name__ for u in unservable))
    return tuple((u.pure, {}, bool(getattr(type(u), "SKIP_AT_EVAL", False)))
                 for u in forwards)


def _power_of_two_buckets(max_batch_size):
    buckets = []
    b = 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return tuple(buckets)


def _chain(stages, cast_integers=False):
    """``apply_fn(params, x)`` running each stage's ``pure`` over its
    params in order, skipping the ``SKIP_AT_EVAL`` ones; with
    ``cast_integers`` an integer input is cast to float32 first (the
    lowered route's ingest)."""
    def apply_fn(params_list, x):
        h = x.float() if cast_integers and not x.is_floating_point() \
            else x
        for (pure, config, skip_at_eval), p in zip(stages, params_list):
            if not skip_at_eval:
                h = pure(p, h, **config)
        return h

    return apply_fn


def _host_params(unit):
    """A forward's ``{"w", "b"}`` as host numpy copies (the JAX
    ``pure_params(host=True)``), read after ``map_read``."""
    params = {}
    if unit.weights:
        unit.weights.map_read()
        params["w"] = numpy.array(unit.weights.mem)
    if getattr(unit, "include_bias", True) and unit.bias:
        unit.bias.map_read()
        params["b"] = numpy.array(unit.bias.mem)
    return params


def _device_tree(node, device):
    """A params tree (numpy or tensor leaves) as tensors on ``device``:
    float leaves as float32, integer leaves (int8 weights, seeds) as
    they are."""
    if isinstance(node, dict):
        return {key: _device_tree(child, device)
                for key, child in node.items()}
    if isinstance(node, (list, tuple)):
        return [_device_tree(child, device) for child in node]
    if isinstance(node, torch.Tensor):
        tensor = node.detach()
    else:
        tensor = torch.from_numpy(numpy.array(node))
    if tensor.is_floating_point():
        tensor = tensor.float()
    return tensor.to(device).contiguous()


def _leaves(node, prefix=""):
    """``[(path, tensor)]`` of a tree, in a fixed order."""
    if isinstance(node, dict):
        return [item for key in sorted(node)
                for item in _leaves(node[key], "%s.%s" % (prefix, key))]
    if isinstance(node, (list, tuple)):
        return [item for i, child in enumerate(node)
                for item in _leaves(child, "%s[%d]" % (prefix, i))]
    return [(prefix, node)]


class InferenceEngine(Logger):
    """Forward + device-resident params + one captured graph per batch
    bucket (the eager forward per bucket on the CPU).

    ``apply_fn(params, x)`` takes the params tree of tensors and a
    float32 ``(batch,) + sample_shape`` tensor on the engine's device
    and must be row-independent.  ``params_source``: an optional 0-arg
    callable returning fresh host params, installed before every call
    (serve while training; shapes stay fixed).  ``device``: ``cuda``
    unless ``"cpu"`` is asked for (raises without a card)."""

    def __init__(self, params, apply_fn, sample_shape,
                 max_batch_size=64, buckets=None, params_source=None,
                 mesh=None, param_specs=None, quant_axes=None,
                 device=None, **kwargs):
        super(InferenceEngine, self).__init__(**kwargs)
        self.device = resolve_device(device)
        # a mesh of one rank IS the single-device path
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        #: each leaf's spec over the mesh, in _leaves order (None: the
        #: single-device path)
        self._specs = self._leaf_specs(params, param_specs)
        self._on_card = self.device.type == "cuda"
        #: per-stage quantization axes ({"w": (axis,)}), from each
        #: unit's ``weights_transposed``
        self._quant_axes = quant_axes
        self.sample_shape = tuple(int(d) for d in sample_shape)
        self.max_batch_size = int(max_batch_size)
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.buckets = tuple(sorted(set(
            int(b) for b in (buckets
                             or _power_of_two_buckets(
                                 self.max_batch_size)))))
        if self.buckets[-1] != self.max_batch_size:
            raise ValueError(
                "largest bucket %d must equal max_batch_size %d"
                % (self.buckets[-1], self.max_batch_size))
        self.params_source = params_source
        self._apply = apply_fn if self._specs is None \
            else self._sharded_apply(apply_fn)
        #: the engine's lock and (on the card) its one stream
        self._lock = threading.RLock()
        self._stream = torch.cuda.Stream(self.device) if self._on_card \
            else None
        with self._on_stream():
            self._params = _device_tree(self._placed(params), self.device)
        #: "int8" after quantize_int8() (or for constructor-injected
        #: quantized params); None = float
        self.quantized = "int8" if quant.tree_is_quantized(params) \
            else None
        #: device bytes of the served params, held in the HBM ledger's
        #: params category until close()
        self.params_nbytes = quant.tree_nbytes(self._params)
        Watcher.track(self.params_nbytes, "params")
        self._params_tracked = True
        self._ledger_gen = Watcher.generation
        self._buckets = {}           # batch size -> _Bucket
        self.compile_count = 0
        self.infer_calls = 0         # bucket calls (monitoring)
        #: performance-ledger identity + per-bucket entries
        self.prof_name = "engine%d" % next(_ENGINE_SEQ)
        self._prof_entries = {}      # batch size -> LedgerEntry
        #: set by warmup(); a capture after it is a steady-state one
        self._warmed = False
        self._out_struct_ = None

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_workflow(cls, workflow, sample_shape=None, **kwargs):
        """Engine from a trained workflow.

        With layer specs (a ``StandardWorkflow``), the route of the JAX
        package's ``fused_graph.lower_specs`` at inference: its
        ``apply_fn(params, x, train=False)`` casts an integer input to
        float32, then runs each stage's ``pure``, skipping the
        ``SKIP_AT_EVAL`` ones, over the stage's ``{"w", "b", "seed"}``
        with the trained weights.  That function is served here over
        the workflow's forward units (whose params are ``{"w", "b"}``:
        no port forward carries a seed).  Workflows built without specs
        take :meth:`from_forwards`, which does not cast.  A fused
        workflow's trainer writes its parameters into the forwards
        first."""
        fused_trainer = getattr(workflow, "fused_trainer", None)
        if fused_trainer is not None:
            # the trained parameters live in the trainer's tensors: into
            # the forwards' Vectors before they are read
            fused_trainer.sync_weights()
        specs = getattr(workflow, "layers", None)
        forwards = getattr(workflow, "forwards", None)
        if not forwards:
            raise ValueError("workflow has no forward units to serve")
        if sample_shape is None:
            sample_shape = cls._infer_sample_shape(workflow, forwards)
        if not specs or len(specs) != len(forwards):
            return cls.from_forwards(forwards, sample_shape=sample_shape,
                                     **kwargs)
        params = [_host_params(unit) for unit in forwards]
        kwargs.setdefault("quant_axes", cls._quant_axes_of(forwards))
        return cls(params, _chain(forward_stages(forwards),
                                  cast_integers=True),
                   sample_shape, **kwargs)

    @classmethod
    def from_forwards(cls, forwards, sample_shape=None, live=False,
                      **kwargs):
        """Engine straight from live forward units: each unit's ``pure``
        over its params, read from the units' Vectors.  ``live=True``
        reads the units' weights again before every call (serve while
        training, see ``params_source``)."""
        forwards = list(forwards)
        stages = forward_stages(forwards)

        def read_params():
            # serialize the read against a training thread that holds
            # the units' data lock, as the JAX engine does
            lock = getattr(forwards[0], "data_lock", None)
            with lock() if lock is not None \
                    else contextlib.nullcontext():
                return [_host_params(u) for u in forwards]

        if sample_shape is None:
            sample_shape = cls._infer_sample_shape(None, forwards)
        kwargs.setdefault("quant_axes", cls._quant_axes_of(forwards))
        return cls(read_params(), _chain(stages), sample_shape,
                   params_source=read_params if live else None,
                   **kwargs)

    @staticmethod
    def _quant_axes_of(forwards):
        """Per-stage quantization axes from the units' storage layout:
        transposed weights are (neurons, fan-in), so the abs-max runs
        over axis 1 there, axis 0 otherwise."""
        return [
            {"w": ((1,) if getattr(u, "weights_transposed", False)
                   else (0,))}
            for u in forwards]

    @classmethod
    def from_snapshot(cls, path, **kwargs):
        """Engine from a :mod:`veles_tpu_torch.snapshotter` artifact (a
        local path, an ``http(s)://`` URL or a ``db://`` row), as
        :meth:`from_workflow` builds it."""
        from veles_tpu_torch.snapshotter import load_snapshot
        return cls.from_workflow(load_snapshot(path), **kwargs)

    @staticmethod
    def _infer_sample_shape(workflow, forwards):
        shape = infer_sample_shape(workflow, forwards)
        if shape is None:
            raise ValueError(
                "cannot infer sample_shape from the forward chain — "
                "pass sample_shape=(...) explicitly")
        return shape

    # -- sharding -----------------------------------------------------------
    def _leaf_specs(self, params, param_specs):
        """``[spec]`` of each leaf (``_leaves`` order) over the mesh, or
        None on the single-device path."""
        if self.mesh is None:
            return None
        leaves = _leaves(params)
        if param_specs is None:
            return [()] * len(leaves)
        if callable(param_specs):
            specs = []
            for _path, leaf in leaves:
                spec = param_specs(leaf) if numpy.ndim(leaf) else None
                specs.append(tuple(spec) if spec is not None else ())
            return specs
        specs = [tuple(spec or ()) for _p, spec in _leaves(param_specs)]
        if len(specs) != len(leaves):
            raise ValueError("param_specs has %d leaves, the params %d"
                             % (len(specs), len(leaves)))
        return specs

    def _placed(self, params):
        """``params`` with each sharded leaf cut to this rank's slice."""
        if self._specs is None or not any(any(s) for s in self._specs):
            return params
        from veles_tpu_torch.parallel.mesh import shard
        specs = iter(self._specs)

        def walk(node):
            if isinstance(node, dict):
                return {key: walk(node[key]) for key in sorted(node)}
            if isinstance(node, (list, tuple)):
                return [walk(child) for child in node]
            spec = next(specs)
            if not any(spec):
                return node
            if isinstance(node, torch.Tensor):
                node = node.detach().cpu().numpy()
            return numpy.ascontiguousarray(shard(numpy.asarray(node), spec,
                                                 self.mesh))
        return walk(params)

    def _sharded_apply(self, apply_fn):
        """``apply_fn`` over the whole params: each sharded leaf
        all-gathered over its spec's axes first."""
        from veles_tpu_torch.parallel.mesh import unshard
        engine = self

        def apply(params, x):
            specs = iter(engine._specs)

            def walk(node):
                if isinstance(node, dict):
                    return {key: walk(node[key]) for key in sorted(node)}
                if isinstance(node, (list, tuple)):
                    return [walk(child) for child in node]
                spec = next(specs)
                return unshard(node, spec, engine.mesh) if any(spec) \
                    else node
            return apply_fn(walk(params), x)
        return apply

    # -- the device ---------------------------------------------------------
    def _on_stream(self):
        """The engine's stream as the current one (a no-op on the
        CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _forward(self, params, batch):
        """The eager forward of a host batch over a params tree on the
        device; host float32 rows back."""
        with self._lock, self._on_stream():
            x = torch.from_numpy(numpy.ascontiguousarray(
                batch, numpy.float32)).to(self.device)
            return self._apply(params, x).to("cpu").numpy().copy()

    # -- buckets ------------------------------------------------------------
    def _bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _bucket(self, batch_size):
        """The bucket of ``batch_size``, captured (on the card) or
        counted (on the CPU) at its first use."""
        bucket = self._buckets.get(batch_size)
        if bucket is not None:
            return bucket
        with self._lock:
            bucket = self._buckets.get(batch_size)
            if bucket is None:
                bucket = _Bucket(self, batch_size)
                if self._on_card:
                    bucket.call(numpy.zeros(
                        (batch_size,) + self.sample_shape, numpy.float32),
                        batch_size)
                else:
                    self._compiled(batch_size)
                self._buckets[batch_size] = bucket
        return bucket

    def _compiled(self, batch_size, recapture=False, program_cost=None):
        """Account one capture of bucket ``batch_size`` (its eager
        function on the CPU): compile_count, the ledger entry with the
        capture's ``program_cost`` (on the CPU each call's tally is its
        cost),
        the trace span, and the sentinel after warmup.  Every bucket is
        judged against the f32 rate: its products are the f32 GEMM, or
        the qmatmul's f32 FMA body when quantized."""
        span_args = {"bucket": batch_size, "engine": self.prof_name}
        program_cost, span_args = prof.span_cost_args(
            program_cost, span_args, peak_dtype="float32")
        if self._warmed:
            span_args["recompile"] = True
        trace.instant("serve", "compile_bucket", span_args, role="server")
        self.compile_count += 1
        entry = self._prof_entries.get(batch_size)
        if entry is None:
            entry = self._prof_entries[batch_size] = prof.ledger.entry(
                "bucket", "%s[b%d]" % (self.prof_name, batch_size),
                "cuda" if self._on_card else "cpu")
        entry.peak_dtype = "float32"
        prof.ledger.record_compile(entry, cost=program_cost,
                                   steady=self._warmed)
        self.debug("compiled bucket %d (compile #%d)", batch_size,
                   self.compile_count)
        if self._warmed:
            prof.flag_recompile(
                "serve:%s:bucket[%d]" % (self.prof_name, batch_size),
                None, None, logger=self,
                detail=("bucket %d recaptured after warmup() — a tensor "
                        "its graph reads moved" if recapture else
                        "bucket %d compiled after warmup() — the batch "
                        "reached a shape no warmed bucket covers")
                % batch_size)

    def warmup(self):
        """Capture every bucket (count it, on the CPU); returns self.
        After this no batch size triggers a capture, and the recompile
        sentinel flags any later one."""
        for b in self.buckets:
            self._bucket(b)
        self._warmed = True
        return self

    def padded_capacity(self, n):
        """Bucket rows a batch of ``n`` occupies (splitting beyond
        ``max_batch_size`` included): the batch-fill denominator."""
        capacity = 0
        while n > 0:
            chunk = min(n, self.max_batch_size)
            capacity += self._bucket_for(chunk)
            n -= chunk
        return capacity

    def _out_struct(self):
        """(shape, dtype) of one output row: a captured bucket's static
        output, else one eager row of zeros, cached."""
        if self._out_struct_ is None:
            for bucket in self._buckets.values():
                if bucket.output is not None:
                    out = bucket.output
                    self._out_struct_ = (tuple(out.shape[1:]),
                                         numpy.dtype(numpy.float32))
                    break
            else:
                out = self._forward(self._params, numpy.zeros(
                    (1,) + self.sample_shape, numpy.float32))
                self._out_struct_ = (tuple(out.shape[1:]), out.dtype)
        return self._out_struct_

    # -- int8 ---------------------------------------------------------------
    def quantize_int8(self, calibration=None, tol=None):
        """Quantize the served params (per-output-channel symmetric
        int8 over each stage's 2-D ``"w"``; biases stay float), the
        ``ModelRegistry.deploy(..., quantize="int8")`` hook.  Must run
        before :meth:`warmup` and any capture.  ``calibration``: a host
        batch whose float forward is held against the quantized one; a
        relative drift beyond ``tol`` (default
        :data:`veles_tpu_torch.quant.DRIFT_TOL`) raises
        :class:`~veles_tpu_torch.quant.QuantizationError` naming the
        stage that does not fit 8 bits.  Live engines are refused.
        Returns self."""
        if self._warmed or self.compile_count:
            raise RuntimeError(
                "quantize_int8 must run before warmup()/any compile — "
                "a post-warmup dtype flip would recompile every "
                "bucket in steady state")
        if self.params_source is not None:
            raise ValueError(
                "cannot quantize a live (params_source) engine — the "
                "per-call float refresh would clash with the "
                "quantized tree; deploy a frozen snapshot instead")
        if self.mesh is not None:
            raise ValueError(
                "int8-quantized params cannot shard over a mesh yet - "
                "serve the int8 deploy single-device (mesh=None)")
        if self.quantized:
            return self
        tol = quant.DRIFT_TOL if tol is None else tol
        host = quant.core._host(self._params)
        qparams = quant.quantize_stage_params(host, self._quant_axes)
        if calibration is not None:
            calibration = numpy.ascontiguousarray(calibration,
                                                  numpy.float32)
            ref = self.reference_forward(calibration)

            def drift_of(tree):
                with self._on_stream():
                    tree = _device_tree(tree, self.device)
                return quant.relative_drift(
                    ref, self._forward(tree, calibration))

            def blame():
                per_stage = {
                    index: drift_of(quant.quantize_stage_params(
                        host, self._quant_axes, only=index))
                    for index in range(len(host))
                    if quant.is_quantized_leaf(qparams[index].get("w"))}
                worst = max(per_stage, key=per_stage.get)
                return "stage[%d].w" % worst, per_stage[worst]

            quant.check_drift("params", drift_of(qparams), tol, blame)
        with self._lock, self._on_stream():
            self._params = _device_tree(qparams, self.device)
        self.quantized = "int8"
        self._out_struct_ = None
        if self._params_tracked and self._ledger_gen == Watcher.generation:
            Watcher.untrack(self.params_nbytes, "params")
        self.params_nbytes = quant.tree_nbytes(self._params)
        Watcher.track(self.params_nbytes, "params")
        self._params_tracked = True
        self._ledger_gen = Watcher.generation
        self.info("quantized params to int8 (%d bytes resident)",
                  self.params_nbytes)
        return self

    def describe(self):
        """Deploy surface (merged into ``_Model.describe()``)."""
        return {
            "sample_shape": list(self.sample_shape),
            "quantize": self.quantized,
            "params_bytes": self.params_nbytes,
            "sharded": self.mesh is not None,
        }

    def close(self):
        """Release the params' HBM-ledger hold (idempotent; the tensors
        are freed once the last in-flight call drops them)."""
        if self._params_tracked:
            if self._ledger_gen == Watcher.generation:
                Watcher.untrack(self.params_nbytes, "params")
            self._params_tracked = False

    # -- serving ----------------------------------------------------------
    def update_params(self, params):
        """Install new host params (the same tree and shapes): copied
        into the tensors the graphs read, under the engine's lock, so a
        concurrent call sees the old or the new params whole."""
        new = _leaves(self._placed(params))
        with self._lock, self._on_stream():
            old = _leaves(self._params)
            if [path for path, _ in new] != [path for path, _ in old]:
                raise ValueError(
                    "update_params needs the served tree's structure: "
                    "%s, got %s" % ([p for p, _ in old],
                                    [p for p, _ in new]))
            for (path, dst), (_, src) in zip(old, new):
                src = torch.as_tensor(numpy.asarray(src)) \
                    if not isinstance(src, torch.Tensor) else src
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError("update_params: %s is %s, want %s"
                                     % (path, tuple(src.shape),
                                        tuple(dst.shape)))
                dst.copy_(src.to(dst.dtype))

    def infer(self, batch):
        """Host batch → host float32 outputs, same leading length.
        Pads up to the nearest bucket; batches beyond
        ``max_batch_size`` are served in max-bucket chunks."""
        batch = numpy.ascontiguousarray(batch, dtype=numpy.float32)
        if batch.ndim == 1:
            batch = batch[None, :]
        if batch.shape[1:] != self.sample_shape:
            raise ValueError("sample shape %s does not match engine %s"
                             % (batch.shape[1:], self.sample_shape))
        n = len(batch)
        if n == 0:
            shape, dtype = self._out_struct()
            return numpy.zeros((0,) + shape, dtype)
        if self.params_source is not None:
            self.update_params(self.params_source())
        pieces = []
        for start in range(0, n, self.max_batch_size):
            pieces.append(self._infer_chunk(
                batch[start:start + self.max_batch_size]))
        return pieces[0] if len(pieces) == 1 else \
            numpy.concatenate(pieces)

    def reference_forward(self, batch):
        """The eager forward at the batch's exact shape: the oracle the
        bucket padding is measured against (not a serving path)."""
        return self._forward(self._params, batch)

    def _infer_chunk(self, chunk):
        n = len(chunk)
        size = self._bucket_for(n)
        bucket = self._bucket(size)
        self.infer_calls += 1
        with trace.span("serve", "infer_chunk",
                        {"bucket": size, "engine": self.prof_name},
                        role="server"):
            tic = time.perf_counter_ns()
            out = bucket.call(chunk, n)
            entry = self._prof_entries.get(size)
            if entry is not None:
                prof.ledger.record_dispatch(
                    entry, time.perf_counter_ns() - tic,
                    cost=bucket.eager_cost)
        return out


class _Bucket(object):
    """One batch bucket: on the card a captured graph over a static
    input, with pinned host buffers for its rows in and out; on the CPU
    the eager forward over the padded batch."""

    def __init__(self, engine, size):
        self.engine = engine
        self.size = size
        self.output = None
        self.graph = None
        #: the last eager call's cost (the CPU route; None on the card,
        #: where the capture's cost is the entry's)
        self.eager_cost = None
        if engine._on_card:
            from veles_tpu_torch.stitch import CapturedGraph
            shape = (size,) + engine.sample_shape
            with engine._on_stream():
                self.input = torch.zeros(shape, dtype=torch.float32,
                                         device=engine.device)
            self.host_in = torch.zeros(shape, dtype=torch.float32,
                                       pin_memory=True)
            self.host_out = None
            # thread-local capture: a hot swap captures its successor's
            # buckets while the batcher's worker replays this engine's
            self.graph = CapturedGraph(
                "%s[b%d]" % (engine.prof_name, size), engine.device,
                capture_error_mode="thread_local")

    def _body(self):
        return self.engine._apply(self.engine._params, self.input)

    def call(self, chunk, n):
        """The bucket's rows for the first ``n`` rows of ``chunk``
        (host float32, at most ``size`` rows): host float32 copies."""
        engine = self.engine
        if not engine._on_card:
            padded = numpy.zeros((self.size,) + engine.sample_shape,
                                 numpy.float32)
            padded[:n] = chunk[:n]
            with engine._lock, cost.Tally() as tally:
                out = engine._apply(engine._params,
                                    torch.from_numpy(padded))
                self.output = out
            self.eager_cost = tally.cost()
            return out[:n].numpy().copy()
        with engine._lock, engine._on_stream():
            host = self.host_in.numpy()
            host[:n] = chunk[:n]
            host[n:] = 0.0
            self.input.copy_(self.host_in, non_blocking=True)
            if self.graph.captures == 0:
                # the first forward runs eagerly: the kernels load
                # before the capture records their launches
                self._body()
            leaves = _leaves(engine._params)
            before = self.graph.captures
            with cost.Tally() as tally:
                out = self.graph.replay(
                    self._body, [self.input] + [t for _, t in leaves],
                    ["input"] + [p for p, _ in leaves])
            if self.graph.captures != before:
                # the wrappers ran once, inside the capture
                engine._compiled(self.size, recapture=before > 0,
                                 program_cost=tally.cost())
            if self.host_out is None:
                self.host_out = torch.empty(tuple(out.shape),
                                            dtype=out.dtype,
                                            pin_memory=True)
            self.output = out
            self.host_out[:n].copy_(out[:n], non_blocking=True)
            engine._stream.synchronize()
            return self.host_out[:n].numpy().copy()
