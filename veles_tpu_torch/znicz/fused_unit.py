"""FusedTrainer: the whole layer stack as one unit of the graph.  The
port's counterpart of :mod:`veles_tpu.znicz.fused_unit`.

``StandardWorkflow(fused=True)`` replaces the eager per-unit train chain
(forwards → evaluator → GDs) with this unit, which runs
:func:`~veles_tpu_torch.znicz.fused_graph.lower_specs`' step: forward,
loss, backward through the GEMM kernel's autograd and the solver update
as one function a minibatch, while the graph services (the loader, the
Decision's accounting, the snapshotter, rollback) work unchanged.  The
forward units still hold the weights: the trainer seeds its parameters
from them at its first run, and writes them back at every epoch's end
and before a snapshot or a serving engine reads them.

On the card each step shape (train or eval, full batch or short tail)
is ONE CUDA graph (:class:`veles_tpu_torch.stitch.CapturedGraph`) of
the minibatch's gather and the step: the loader serves only the
minibatch's indices (``rows_by_consumer``), uploaded in place into
``minibatch_indices``, and the graph gathers the data rows and labels
from the resident tables in one launch
(:func:`~veles_tpu_torch.ops.gather.take_rows_group`).  The shape's
first call runs eagerly as a real step, on a side stream (the warm-up
autograd needs before a capture), the second captures the step and
replays it, and every later call is a replay.  The JAX step donates its
parameters; here the parameters, momenta and solver slots are updated
in place, so their addresses stay fixed across replays.  ``rollback_to``
rebuilds the step, as the JAX trainer recompiles: one more capture a
shape.  On the CPU every step runs eagerly.  The Decision reads
``n_err`` (or ``mse``) a minibatch, a device scalar on the per-step
route (the graph's output, summed by the Decision before the next
replay).

``epoch_mode`` trains a whole TRAIN epoch at its first train minibatch:
the epoch's permutation comes from a CPU ``torch.Generator`` seeded by
``epoch_key_counter`` (``torch.randperm``; JAX's threefry permutation
cannot be reproduced), and the card copies it into the graph's index
buffer once an epoch, so the card and the CPU train on the same order.
On the card each window of up to :data:`EPOCH_WINDOW` steps (the whole
epoch where it fits) is one CUDA graph of the gather and the step; the
first epoch runs eagerly.  The stacked metrics come back in one copy an
epoch and are replayed one minibatch at a time to the Decision.

``solver_state`` (the whole per-layer state, host numpy) is pickled with
the unit, so a snapshot resumes with the same optimizer dynamics; a
torch tensor in a pickle would bring its CUDA storage with it.

``mesh_axes`` (e.g. ``{"data": -1}``) trains data-parallel over the
ranks of the default process group (:mod:`veles_tpu_torch.parallel`):
every rank runs the same workflow, serves the same minibatches and
trains on its contiguous rows of each (the ``data`` axis), through a
step lowered with ``grad_reduce_axis="data"`` whose one all-reduce a
step rides inside the step's CUDA graph; the short tail rounds down to
a multiple of the axis size, evaluation runs whole on every rank, and
epoch mode gives each rank its columns of the global permutation.
``fsdp=True`` stores every leaf of :func:`~veles_tpu_torch.parallel.dp
.fsdp_rules` (1024 elements and up) as the rank's slice over ``data``
and ``tp=True`` shards every wide layer's neurons over a ``model`` axis
(``mesh_axes={"data": d, "model": m}``, :func:`~veles_tpu_torch.parallel
.dp.tp_rules`); both merge as the JAX trainer merges them (TP takes a
contested dim, FSDP any other), and the step gathers, reduces and runs
column-parallel as :func:`~veles_tpu_torch.znicz.fused_graph.lower_specs`
says.  The weights written back to the forwards, a snapshot's solver
state and ``capture_state`` are gathered whole.  Not ported: the job
protocol's refresh on a slave (item 7(e); ``epoch_mode`` on a slave
raises, as in the JAX package).
"""

import numpy
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.ops.gather import take_rows_group

#: the most steps one epoch-mode window graph holds
EPOCH_WINDOW = 1024


def _add_report(into, report):
    """Sum a program report's counters into ``into`` (other fields are
    taken as they are)."""
    for name, value in report.items():
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            into[name] = into.get(name, 0) + value
        else:
            into[name] = value
    return into


class _Program(object):
    """One step shape's program (see the module): eager on the CPU; on
    the card eager once on a side stream, then one captured graph."""

    def __init__(self, name, fn, device):
        self.name = name
        #: the program's body: reads its tensors where they are bound
        self.fn = fn
        self.device = device
        self.eager_calls = 0
        self.graph = None
        if device.type == "cuda":
            from veles_tpu_torch.stitch import CapturedGraph
            self.graph = CapturedGraph(name, device)

    def __call__(self, tensors):
        """``fn()``; ``tensors`` are the ones it reads and writes, whose
        addresses the graph's move check compares with the capture's."""
        if self.graph is None:
            self.eager_calls += 1
            return self.fn()
        if self.eager_calls == 0:
            self.eager_calls += 1
            side = torch.cuda.Stream(device=self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                out = self.fn()
            side.synchronize()
            return out
        return self.graph.replay(self.fn, tensors,
                                 ["t%d" % i for i in range(len(tensors))])

    def report(self):
        out = {"eager": self.eager_calls}
        if self.graph is not None:
            out.update(self.graph.report())
        return out


class GraphStep(object):
    """A lowered ``step_fn(params, x, labels)`` run as the trainer runs
    it: a step shape's first call eager (on a side stream on the card),
    the second captured into one CUDA graph and replayed, every later
    call a replay; eager on the CPU.  ``x`` and ``labels`` are copied
    into the shape's own buffers, which the graph reads, and ``params``
    (updated in place) must be the list of every call.  Returns
    ``(params, metrics)``, the metrics as the graph holds them (read
    them before the next call).  :meth:`report` gives each shape's
    eager calls, captures, recaptures and replays."""

    def __init__(self, step_fn, name="step"):
        self.step_fn = step_fn
        self.name = name
        self._programs = {}

    def __call__(self, params, x, labels):
        key = (tuple(x.shape), x.dtype, tuple(labels.shape))
        entry = self._programs.get(key)
        if entry is None:
            sx, sy = torch.empty_like(x), torch.empty_like(labels)

            def fn():
                return self.step_fn(entry[3], sx, sy)[1]
            entry = [_Program("%s_%d" % (self.name, x.shape[0]), fn,
                              x.device), sx, sy, params]
            self._programs[key] = entry
        program, sx, sy, bound = entry
        if bound is not params:
            raise ValueError("GraphStep: params must be the list the step "
                             "was first called with (updated in place)")
        sx.copy_(x)
        sy.copy_(labels)
        tensors = [sx, sy] + [t for state in params for t in state.values()
                              if t is not None]
        return params, program(tensors)

    def report(self):
        return {"%s_%d" % (self.name, key[0][0]): entry[0].report()
                for key, entry in self._programs.items()}


def warm_up_group(group, device):
    """One all-reduce on ``group`` before a step that reduces over it is
    captured: NCCL sets up its communicator at a group's first
    collective, which must not happen inside a CUDA graph capture."""
    if group is not None:
        from veles_tpu_torch.parallel.comm import all_reduce
        all_reduce(torch.zeros(1, device=device), group)


class FusedTrainer(AcceleratedUnit):
    """Runs lower_specs' step and eval for the workflow's layer stack,
    exposing ``n_err`` (softmax) or ``mse`` (MSE) after every run, so a
    Decision reads it in place of the evaluator's."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(FusedTrainer, self).__init__(workflow, **kwargs)
        self.view_group = "TRAINER"
        # each spec AND its nested "->"/"<-" dicts copied: rollback_to
        # rescales learning rates in place
        self.layers = [
            {**s, **{k: dict(s[k]) for k in ("->", "<-") if k in s}}
            for s in kwargs["layers"]]
        self.loss = kwargs.get("loss", "softmax")
        self.compute_dtype = kwargs.get("compute_dtype")
        self.grad_accum = int(kwargs.get("grad_accum", 1))
        self.remat = bool(kwargs.get("remat", False))
        self.lr_adjuster = kwargs.get("lr_adjuster")
        self.epoch_mode = bool(kwargs.get("epoch_mode", False))
        #: {axis: size} of the data-parallel mesh, or None
        self.mesh_axes = dict(kwargs.get("mesh_axes") or {}) or None
        #: ZeRO-3 storage over "data" and Megatron columns over "model"
        #: (both need mesh_axes: without a mesh they change nothing, as
        #: in the JAX trainer)
        self.fsdp = bool(kwargs.get("fsdp", False))
        self.tp = bool(kwargs.get("tp", False))
        #: seeds each epoch's permutation; pickled, so a resume draws on
        self.epoch_key_counter = 0
        self.loader = None
        self.forwards = None
        self.n_err = 0.0
        self.mse = 0.0
        self.loss_value = 0.0
        #: host numpy copy of the whole per-layer solver state, taken at
        #: pickle time (and by rollback_to) and restored at the next build
        self.solver_state = None
        self.demand("loader", "forwards")

    def init_unpickled(self):
        super(FusedTrainer, self).init_unpickled()
        self._params_ = None          # device state, rebuilt on resume
        self._step_ = None
        self._eval_ = None
        self._train_divisor_ = 1
        self._mesh_ = None            # the data-parallel mesh, if any
        self._rules_ = None           # fsdp / tp param rules, if any
        self._specs_ = None           # each leaf's spec under them
        self._programs_ = {}          # (train, rows) -> _Program
        self._retired_ = {}           # reports of programs rebuilt away
        self._epoch_ = None           # epoch mode: its data and buffers
        self._epoch_queue_ = None     # the metrics being replayed
        self._epoch_ptr_ = 0

    def __getstate__(self):
        state = super(FusedTrainer, self).__getstate__()
        if self._params_ is not None:
            state["solver_state"] = self._whole_params()
        for key in ("n_err", "mse", "loss_value"):
            if isinstance(state.get(key), torch.Tensor):
                state[key] = float(state[key])
        return state

    # -- building -------------------------------------------------------------
    def _compute_dtype(self):
        """``compute_dtype`` as given, else the device's
        ``precision_type`` where it is not float32 (None: f32)."""
        from veles_tpu_torch.dtypes import dtype_by_name
        dtype = self.compute_dtype
        if dtype is None and self.device is not None:
            dtype = self.device.compute_dtype
        if dtype is None:
            return None
        dtype = dtype_by_name(dtype)
        return None if dtype == torch.float32 else dtype

    def _torch_device(self):
        device = getattr(self.device, "torch_device", None)
        return torch.device("cpu") if device is None else device

    def _build(self):
        from veles_tpu_torch.znicz.fused_graph import lower_specs, to_tensors
        specs = []
        for spec, fwd in zip(self.layers, self.forwards):
            spec = dict(spec)
            if fwd.weights:
                init = {"weights": numpy.array(fwd.weights.mem)}
                if fwd.bias:
                    init["bias"] = numpy.array(fwd.bias.mem)
                spec["init"] = init
            specs.append(spec)
        sample_shape = tuple(self.loader.minibatch_data.shape[1:])
        mesh = None
        if self.mesh_axes:
            from veles_tpu_torch.parallel.mesh import make_mesh
            mesh = make_mesh(self.mesh_axes)
            if "data" not in mesh.shape:
                raise ValueError("mesh_axes %r has no 'data' axis"
                                 % (self.mesh_axes,))
        self._mesh_ = mesh
        rules = self._make_rules(mesh) if mesh is not None else None
        self._rules_ = rules
        params, step_fn, eval_fn, _apply = lower_specs(
            specs, sample_shape, loss=self.loss,
            compute_dtype=self._compute_dtype(), remat=self.remat,
            grad_accum=self.grad_accum, lr_adjuster=self.lr_adjuster,
            input_norm=getattr(self.loader, "input_norm", None),
            grad_reduce_axis="data" if mesh else None, mesh=mesh,
            param_rules=rules)
        params = self._restore_solver_state(params)
        self._specs_ = None
        if rules is not None:
            from veles_tpu_torch.parallel.dp import shard_params
            from veles_tpu_torch.znicz.fused_graph import _leaf_spec
            self._specs_ = [{k: _leaf_spec(rules, v) for k, v in
                             state.items()} for state in params]
            params = shard_params(params, mesh, param_rules=rules)
        self._params_ = to_tensors(params, self._torch_device())
        # the indices upload in place, where the step graphs read them
        self.loader.minibatch_indices.keep_address = True
        self._step_, self._eval_ = step_fn, eval_fn
        self._train_divisor_ = max(self.grad_accum, 1)
        if mesh is not None:
            self._train_divisor_ *= mesh.shape["data"]
            warm_up_group(mesh.group("data"), self._torch_device())
            if "model" in mesh.shape:
                warm_up_group(mesh.group("model"), self._torch_device())
        for key, program in self._programs_.items():
            _add_report(self._retired_.setdefault(key, {}), program.report())
        self._programs_ = {}
        self._epoch_queue_ = None
        self._epoch_ = self._build_epoch() if self.epoch_mode else None

    def _build_epoch(self):
        from veles_tpu_torch.loader.fullbatch import FullBatchLoader
        loader = self.loader
        if not isinstance(loader, FullBatchLoader):
            raise NotImplementedError(
                "epoch_mode needs a resident FullBatchLoader dataset (got "
                "%s)" % type(loader).__name__)
        if float(getattr(loader, "train_ratio", 1.0)) != 1.0:
            raise NotImplementedError(
                "epoch_mode trains the full TRAIN slice; train_ratio=%s "
                "is not honored: use the per-minibatch path"
                % loader.train_ratio)
        n_train = int(loader.class_lengths[TRAIN])
        batch = int(loader.max_minibatch_size)
        if n_train < batch:
            raise ValueError(
                "epoch_mode needs at least one full minibatch of train "
                "samples (%d < %d)" % (n_train, batch))
        if batch % self._train_divisor_:
            raise ValueError("epoch_mode minibatch %d must divide by "
                             "grad_accum%s (%d)" % (
                                 batch, " x data-axis" if self._mesh_
                                 else "", self._train_divisor_))
        start = int(loader.class_end_offsets[TRAIN - 1])
        data, labels, _pad = self._tables()
        data = data[start:start + n_train]
        labels = labels[start:start + n_train]
        steps = n_train // batch
        window = min(steps, EPOCH_WINDOW)
        start, stop = self._rows(batch)
        return {"data": data, "labels": labels, "n_train": n_train,
                "batch": batch, "steps": steps, "window": window,
                "columns": slice(start, stop),
                "idx": torch.zeros((steps, stop - start), dtype=torch.int32,
                                   device=data.device)}

    def _make_rules(self, mesh):
        """The param rules of ``fsdp`` / ``tp`` over ``mesh`` (None for
        neither): TP's last dim over "model", FSDP's first divisible dim
        over "data", merged TP-first as the JAX trainer merges them."""
        if not (self.tp or self.fsdp):
            return None
        from veles_tpu_torch.parallel.dp import fsdp_rules, tp_rules
        r_tp = tp_rules(mesh) if self.tp else None
        r_fsdp = fsdp_rules(mesh) if self.fsdp else None

        def rules(leaf):
            spec_t = r_tp(leaf) if r_tp else None
            spec_f = r_fsdp(leaf) if r_fsdp else None
            if spec_t is None:
                return spec_f
            if spec_f is None:
                return spec_t
            merged = list(spec_t)
            for dim, axis in enumerate(spec_f):
                if axis is not None and merged[dim] is None:
                    merged[dim] = axis
            return tuple(merged)

        return rules

    def _whole_params(self):
        """Host numpy copies of the whole parameter tree: the sharded
        leaves gathered over the mesh (every rank calls this in the
        same order)."""
        from veles_tpu_torch.znicz.fused_graph import to_numpy
        if self._specs_ is None:
            return to_numpy(self._params_)
        from veles_tpu_torch.parallel.mesh import unshard
        return to_numpy([
            {k: v if v is None or not any(specs.get(k, ())) else unshard(
                v, specs[k], self._mesh_) for k, v in state.items()}
            for state, specs in zip(self._params_, self._specs_)])

    def _rows(self, n):
        """This rank's contiguous ``[start, stop)`` of ``n`` train rows
        (all of them without a mesh)."""
        if self._mesh_ is None:
            return 0, n
        from veles_tpu_torch.parallel.dp import _rows
        return _rows(self._mesh_, "data", n)

    def _restore_solver_state(self, params):
        """The pickled solver state in place of a fresh one, when it
        matches the rebuilt stack leaf for leaf."""
        saved = self.solver_state
        if saved is None:
            return params
        same = len(saved) == len(params) and all(
            sorted(a) == sorted(b) and all(
                (a[k] is None) == (b[k] is None)
                and numpy.shape(a[k]) == numpy.shape(b[k]) for k in a)
            for a, b in zip(params, saved))
        if not same:
            self.warning("pickled solver state does not match the rebuilt "
                         "layer stack: the optimizer dynamics restart")
            return params
        return [{k: None if v is None else numpy.array(v)
                 for k, v in state.items()} for state in saved]

    def initialize(self, device=None, **kwargs):
        super(FusedTrainer, self).initialize(device=device, **kwargs)
        if self.epoch_mode and getattr(self.workflow, "is_slave", False):
            raise NotImplementedError(
                "epoch_mode trains a whole epoch in ONE program; the job "
                "layer distributes per-minibatch jobs: use "
                "epoch_mode=False on slaves")
        # the build waits for the first run: the unchained forwards
        # initialize after this unit, and seeding reads their weights

    # -- running --------------------------------------------------------------
    def _tables(self):
        """The resident data table, the labels' (the targets' for MSE)
        and the labels' pad row value."""
        loader = self.loader
        if self.loss == "mse":
            return (loader.original_data.devmem,
                    loader.original_targets.devmem, 0)
        return (loader.original_data.devmem,
                loader.resident_labels.devmem, -1)

    def _program_tensors(self):
        """The resident tables and the state: what every program reads
        or writes besides its indices."""
        return list(self._tables()[:2]) + [
            t for state in self._params_ for t in state.values()
            if t is not None]

    def _program(self, train, rows):
        key = (bool(train), int(rows))
        program = self._programs_.get(key)
        if program is None:
            start, stop = self._rows(rows) if train else (0, rows)

            def fn():
                data, labels, pad = self._tables()
                x, y = take_rows_group(
                    [(data, 0), (labels, pad)],
                    self.loader.minibatch_indices.devmem[start:stop])
                if train:
                    return self._step_(self._params_, x, y)[1]
                return self._eval_(self._params_, x, y)
            program = _Program(
                "fused_%s_%d" % ("train" if train else "eval", rows), fn,
                self._torch_device())
            self._programs_[key] = program
        return program

    def _set_metric(self, err):
        if self.loss == "mse":
            self.mse = err
        else:
            self.n_err = err

    def run(self):
        if self._step_ is None:       # first run / snapshot resume
            self._build()
        n = int(self.loader.minibatch_size)
        train = int(self.loader.minibatch_class) == TRAIN
        if train and self._epoch_ is not None:
            self._run_epoch_minibatch()
            if bool(self.loader.last_minibatch):
                self.sync_weights()
            return
        div = self._train_divisor_
        if train and div > 1 and n % div:
            # a short tail must split into microbatches: round down; a
            # tail shorter than one microbatch skips the step (metrics
            # zeroed, as the Decision adds them a minibatch)
            n -= n % div
            if n == 0:
                self._set_metric(0.0)
                self.loss_value = 0.0
                if bool(self.loader.last_minibatch):
                    self.sync_weights()
                return
        # uploads this minibatch's indices into the graph's buffer
        tensors = [self.loader.minibatch_indices.devmem]
        metrics = self._program(train, n)(tensors + self._program_tensors())
        if train:
            self.loss_value = metrics["loss"]
            err = metrics["n_err"]
        else:
            err = metrics["n_err" if self.loss != "mse" else "rmse"]
        self._set_metric(err)
        if bool(self.loader.last_minibatch):
            # the epoch's end: the unit graph sees the trained weights
            self.sync_weights()

    def _run_epoch(self, idx):
        """One epoch over the ``(steps, batch)`` order ``idx`` (CPU
        int32): eager on the CPU; on the card the index buffer filled
        once, then each window's program."""
        from veles_tpu_torch.znicz.fused_graph import run_steps
        ep = self._epoch_
        buffer = ep["idx"]
        buffer.copy_(idx[:, ep["columns"]])
        pieces = []
        for w0 in range(0, ep["steps"], ep["window"]):
            k = min(ep["window"], ep["steps"] - w0)
            key = ("window", w0, k)
            program = self._programs_.get(key)
            if program is None:
                def fn(w0=w0, k=k):
                    return run_steps(self._step_, self._params_,
                                     ep["data"], ep["labels"],
                                     buffer[w0:w0 + k])[1]
                program = _Program("fused_window_%d_%d" % (w0, k), fn,
                                   self._torch_device())
                self._programs_[key] = program
            out = program([buffer] + self._program_tensors())
            pieces.append({name: v.to("cpu").numpy().copy()
                           for name, v in out.items()})
        return {name: numpy.concatenate([p[name] for p in pieces])
                for name in pieces[0]}

    def epoch_order(self, counter):
        """The ``(steps, batch)`` int32 minibatch order of the epoch that
        ``epoch_key_counter`` = ``counter`` draws (on the CPU)."""
        from veles_tpu_torch.znicz.fused_graph import epoch_indices
        ep = self._epoch_
        generator = torch.Generator().manual_seed(int(counter))
        return epoch_indices(ep["n_train"], ep["batch"], generator)

    def _run_epoch_minibatch(self):
        """The first train minibatch of an epoch runs the whole epoch;
        every train call (this one too) replays one minibatch's metrics,
        so the Decision's accounting is unchanged.  Minibatches past the
        full ones (the short tail the epoch drops) report zeros."""
        if self._epoch_queue_ is None:
            idx = self.epoch_order(self.epoch_key_counter)
            self.epoch_key_counter += 1
            self._epoch_queue_ = self._run_epoch(idx)
            self._epoch_ptr_ = 0
        if self._epoch_ptr_ < self._epoch_["steps"]:
            i = self._epoch_ptr_
            self._epoch_ptr_ += 1
            err = float(self._epoch_queue_["n_err"][i])
            self.loss_value = float(self._epoch_queue_["loss"][i])
        else:
            err = 0.0
            self.loss_value = 0.0
        self._set_metric(err)
        if bool(self.loader.last_minibatch):
            self._epoch_queue_ = None

    def graph_report(self):
        """Per program (``"train_<rows>"``, ``"eval_<rows>"``,
        ``"window_<first>_<steps>"``): its eager calls and, on the card,
        its graph's captures, recaptures and replays, summed over every
        build (a rollback rebuilds)."""
        def name(key):
            if key[0] == "window":
                return "window_%d_%d" % key[1:]
            return "%s_%d" % ("train" if key[0] else "eval", key[1])
        out = {name(key): dict(report)
               for key, report in self._retired_.items()}
        for key, program in self._programs_.items():
            _add_report(out.setdefault(name(key), {}), program.report())
        return out

    # -- state ----------------------------------------------------------------
    def capture_state(self):
        """Host copy of the whole solver-state tree (weights, momenta,
        Adam moments and t, rprop steps, schedule ticks): what
        :class:`~veles_tpu_torch.znicz.rollback.Rollback` keeps at every
        improved epoch.  None before the first build."""
        if self._params_ is None:
            return None
        return self._whole_params()

    def rollback_to(self, snap, lr_factor=1.0):
        """Restore a :meth:`capture_state` tree and scale every layer's
        learning rate; the step rebuilds at the next run."""
        if lr_factor != 1.0:
            from veles_tpu_torch.znicz.fused_graph import default_lr
            for spec in self.layers:
                bw = spec.setdefault("<-", {})
                default = default_lr(bw.get("solver", "momentum"))
                bw["learning_rate"] = float(
                    bw.get("learning_rate", default)) * lr_factor
                if "learning_rate_bias" in bw:
                    bw["learning_rate_bias"] = float(
                        bw["learning_rate_bias"]) * lr_factor
        self.solver_state = snap
        self._step_ = None            # _build() restores the tree

    def refresh_from_forwards(self):
        """Overwrite the built parameters' weights and biases with the
        forwards' Vectors, in place, keeping the solver state; a no-op
        before the first build."""
        if self._params_ is None:
            return
        for i, (fwd, state) in enumerate(zip(self.forwards, self._params_)):
            for key, vec in (("w", fwd.weights), ("b", fwd.bias)):
                old = state.get(key)
                if old is None or not vec:
                    continue
                host = numpy.ascontiguousarray(vec.mem)
                if self._specs_ is not None and any(
                        self._specs_[i].get(key, ())):
                    from veles_tpu_torch.parallel.mesh import shard
                    host = numpy.ascontiguousarray(shard(
                        host, self._specs_[i][key], self._mesh_))
                old.copy_(torch.from_numpy(host).to(old.dtype))

    def sync_weights(self):
        """Write the trained parameters into the forward units."""
        if self._params_ is None:
            return
        whole = self._whole_params() if self._specs_ is not None \
            else self._params_
        for fwd, state in zip(self.forwards, whole):
            for key, vec in (("w", fwd.weights), ("b", fwd.bias)):
                value = state.get(key)
                if value is None or not vec:
                    continue
                if isinstance(value, torch.Tensor):
                    value = value.detach().to("cpu").numpy()
                vec.map_write()
                vec.mem[...] = value.astype(vec.mem.dtype, copy=False)
