"""PodRuntime: one pod, one program a rank.

The port's counterpart of :mod:`veles_tpu.pod.runtime`.  It turns an
initialized, *stitched* workflow (:mod:`veles_tpu_torch.stitch`) into a
data-parallel pod over a :class:`~veles_tpu_torch.parallel.mesh.Mesh`
whose ``data`` axis runs over the ranks of ``torch.distributed``'s
default group (gloo on the CPU, NCCL on the card).  The JAX runtime
hands GSPMD one program over the whole mesh; torch has no partitioner,
so every rank runs its own segment programs (one CUDA graph a segment on
the card, one a window) and the runtime writes into each stage's
function what GSPMD derives:

* the global minibatch is the single-device run's: the same shuffled
  buffer and offsets.  Rank ``r`` of ``s`` serves rows ``[r·b/s,
  (r+1)·b/s)`` of it through the loader head's served-gather launch
  (the stage's ``shard`` hook: its offset moves by ``r·b/s``, its size
  is clamped to the rank's rows, so a short tail pads past it).  The
  resident dataset stays whole on every rank: row-sharding it, as the
  JAX runtime does, would need an exchange every minibatch;
* the forward stages run on the rank's rows;
* the evaluators run on the rank's rows and sum their counts over the
  data group (``pod_stage_fn``: ``n_err``, the loss's sum and valid
  rows in one all-reduce, the confusion counts in another), so the
  Decision's host accounting sees the global numbers;
* a stage that updates parameters in place (the fused GD kernels,
  whose single launch computes dW and db and applies the momentum
  update, so no all-reduce can sit between gradient and update)
  all-gathers its batch-led inputs (``x``, ``y``, ``err_output``) over
  the data group, runs on the whole minibatch on every rank, as XLA
  runs a custom call it cannot partition, and keeps the rank's rows of
  what it produces (``err_input``).  The parameters stay replicated and
  identical on every rank;
* the VJP family (:class:`~veles_tpu_torch.znicz.gd_base.GDViaVJP`)
  runs on the rank's rows and all-reduces its summed gradients before
  its in-place update (``grad_group_``);
* ``param_rules`` (``dp.tp_rules``, ``fsdp_rules``, ``pp_rules``,
  ``ep_rules`` or any callable ``leaf -> spec or None``) stores each
  parameter leaf a rule shards as this rank's slice: a stage gathers it
  before use and writes its slice of the update back in place.

Every collective goes through :mod:`veles_tpu_torch.parallel.comm`'s
counted wrappers, and every rank issues them in the same order, the
tail minibatch included.  On the card a captured segment or window
replays its collectives inside the graph: the first dispatch after an
install or a reshard runs eagerly, which sets up the group's
communicator before the capture.

The ledger's ``collective_bytes`` column carries what the runtime
issues: each rewritten stage counts the payload of its collectives
(:data:`comm.bytes_moved <veles_tpu_torch.parallel.comm.bytes_moved>`:
the gathered tensors, the reduced sums) at every call that runs its
Python (an eager dispatch, a capture), and a segment's dispatch is the
sum over its stages; a replayed graph moves what its capture counted.
The JAX runtime's analytic ring formulas price GSPMD's gradient
all-reduce, which the port does not run.

Elastic membership: :meth:`PodRuntime.reshard` shrinks the data axis
(the largest size the global batch divides over the survivors, the
leading ranks), re-places every sharded buffer from the last consistent
step, bumps the generation, rewrites and recaptures every program once
and writes a ``pod:reshard`` trace instant.  A rank outside the new mesh
leaves the pod: its stages run single-device again and its workflow
stops.  :meth:`PodRuntime.pre_dispatch` is the JAX runtime's chaos
``pod_chip`` site; the chaos controller is ROADMAP item 7(e), so until
then it consults nothing, and reshards come from the device-loss
detector (:mod:`veles_tpu_torch.pod.membership`) or an explicit call.
"""

import numpy

from veles_tpu_torch import trace
from veles_tpu_torch.config import root
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.parallel import comm
from veles_tpu_torch.parallel.mesh import (Mesh, MeshTopologyError, Sharding,
                                           mesh_from_topology, shard,
                                           unshard)


class PodError(RuntimeError):
    """The workflow cannot run as a pod (not stitched, no divisible
    batch, a mesh the survivors cannot carry), raised with the remedy in
    the message."""


def _not_ported(what, item):
    raise NotImplementedError(
        "%s is not ported yet (ROADMAP item %s)" % (what, item))


def spec_for_vector(vec, batch, shards, data_axis="data",
                    param_rules=None, donated=False):
    """THE per-Vector pod placement rule (a spec tuple; ``()``
    replicates):

    * parameters (the ``params`` category, or any donated slot)
      replicate, unless ``param_rules`` returns a spec for the leaf;
    * the resident dataset replicates: it stays whole on every rank
      (the JAX rule shards it over the data axis);
    * minibatch-led tensors shard their leading dim over ``data_axis``
      when the batch divides over the shards;
    * everything else replicates."""
    shape = vec.shape or ()
    category = getattr(vec, "category", None)
    if donated or category == "params":
        if param_rules is not None and shape:
            spec = param_rules(numpy.empty(shape, dtype=numpy.int8))
            if spec is not None:
                return tuple(spec)
        return ()
    if category == "dataset":
        return ()
    leading = shape[0] if shape else 0
    if leading and leading == batch and leading % max(1, shards) == 0:
        return (data_axis,) + (None,) * (len(shape) - 1)
    return ()


def _wrapped(inner, make):
    """``make(inner)``, keeping a health-instrumented stage's ``plain``
    twin (:mod:`veles_tpu_torch.watch.health`) wrapped alike."""
    fn = make(inner)
    plain = getattr(inner, "plain", None)
    if plain is not None:
        fn.plain = make(plain)
    return fn


class PodRuntime(Logger):
    """Runs a stitched workflow's segments as a data-parallel pod (see
    the module).

    ``mesh``: a :class:`~veles_tpu_torch.parallel.mesh.Mesh` with a
    ``data`` axis; default :func:`mesh_from_topology` (the
    ``root.common.engine.pod.topology`` knob) over the default group.
    ``param_rules``: None (replicated), a callable ``leaf -> spec or
    None``, or ``"auto"`` (the static planner, ROADMAP item 7(e), which
    raises).
    ``preflight``: ``off`` (the port's default until the analyzer comes)
    runs; ``warn`` and ``fail`` need the analyzer's V-P02 check and
    raise naming item 7(e), as the serving registry's preflight does.
    """

    def __init__(self, workflow, mesh=None, param_rules=None,
                 data_axis="data", preflight=None, **kwargs):
        super(PodRuntime, self).__init__(**kwargs)
        self.workflow = workflow
        self.data_axis = data_axis
        node = root.common.engine.get("pod")
        self.param_rules = param_rules
        self.mesh = mesh if mesh is not None else mesh_from_topology(
            require=(data_axis,))
        if data_axis not in self.mesh.shape:
            raise MeshTopologyError(
                "pod mesh %r has no %r axis" % (self.mesh.shape, data_axis))
        if preflight is None:
            preflight = (node.get("preflight") if node else None) or "off"
        self.preflight = str(preflight).lower()
        if self.preflight not in ("off", "warn", "fail"):
            raise ValueError("pod preflight must be off|warn|fail, not %r"
                             % (preflight,))
        self.generation = 1
        self.installed = False
        #: reshards so far
        self.reshards = 0
        #: True once a reshard left this rank outside the mesh
        self.left = False
        #: id(stage) -> the collective payload bytes of its last call
        self._stage_bytes = {}
        self._segments = []
        self._sharded_vecs = []
        #: id(Vector) -> its spec under the current plan
        self._specs = {}
        #: ids of the minibatch-led Vectors (each rank holds its rows)
        self._row_ids = set()
        #: id(stage) -> (stage, its function before the pod)
        self._plain_fns = {}
        self._grad_units = []
        #: called as on_reshard(runtime) after a reshard
        self.on_reshard = None

    # -- properties ---------------------------------------------------------
    @property
    def shards(self):
        """Lockstep shards on the data axis."""
        return int(self.mesh.shape[self.data_axis])

    @property
    def group(self):
        """The data axis's :class:`~veles_tpu_torch.parallel.comm.Group`
        (None on a mesh without a process group: one process)."""
        if self.left:
            return None
        return self.mesh.group(self.data_axis)

    @property
    def batch(self):
        return int(self.workflow.loader.max_minibatch_size)

    @property
    def rows(self):
        """Rows of each minibatch a rank serves."""
        return self.batch // self.shards

    @property
    def row_start(self):
        """This rank's first row of each minibatch."""
        return self.mesh.index(self.data_axis) * self.rows

    def describe(self):
        return {
            "shards": self.shards,
            "axes": dict(self.mesh.shape),
            "generation": self.generation,
            "reshards": self.reshards,
            "left": self.left,
            "rows_per_shard": self.rows if self.installed else None,
            "dataset": "whole on every rank",
            "segments": ["+".join(s.names) for s in self._segments],
            "collective_bytes_per_step": sum(
                self.segment_collective_bytes(s) for s in self._segments),
        }

    # -- install ------------------------------------------------------------
    def install(self):
        """Rewrite every stitched segment's stages for this rank and pin
        the sharded Vectors.  Idempotent; re-run after
        ``rebuild_stitching()``."""
        wf = self.workflow
        segments = list(getattr(wf, "_stitch_segments_", ()))
        if not segments:
            raise PodError(
                "workflow has no stitched segments - pod training rides "
                "the stitched fast path (initialize with "
                "root.common.engine.stitch=on on a device)")
        batch = self.batch
        if batch % self.shards:
            raise PodError(
                "global batch %d does not divide over %d data shards - "
                "pick a batch a multiple of the data axis (or a smaller "
                "topology)" % (batch, self.shards))
        self._resolve_param_rules()
        self._run_preflight()
        if self.installed:
            self._restore()
        self._segments = segments
        self._apply()
        self.installed = True
        wf.pod_runtime_ = self
        self.info("pod installed: %d segment(s) over %d shard(s) %r, "
                  "%d row(s) a shard", len(segments), self.shards,
                  self.mesh.shape, self.rows)
        return self

    def uninstall(self):
        """Back to single-device segments: the stages' own functions,
        every Vector whole again (a sharded parameter gathered first,
        which every rank does in the same order)."""
        self._restore()
        for vec in self._sharded_vecs:
            vec.set_sharding(None, keep=self._keep(vec))
        for segment in self._segments:
            segment.pod = None
            segment.invalidate()
            if segment.prof_entry is not None:
                segment.prof_entry.shards = 1
        self._sharded_vecs = []
        self._segments = []
        self._stage_bytes = {}
        self.installed = False
        if getattr(self.workflow, "pod_runtime_", None) is self:
            self.workflow.pod_runtime_ = None
        self._invalidate_scan()
        return self

    def _invalidate_scan(self):
        runner = getattr(self.workflow, "_epoch_runner_", None)
        if runner is not None:
            runner.invalidate_programs()

    def _resolve_param_rules(self):
        if not isinstance(self.param_rules, str):
            return
        if self.param_rules.strip().lower() != "auto":
            raise PodError("unknown param_rules mode %r (None | callable "
                           "| 'auto')" % (self.param_rules,))
        _not_ported("PodRuntime(param_rules='auto') (the static planner, "
                    "analyze/plan.py)", "7(e)")

    def _run_preflight(self):
        if self.preflight == "off":
            return
        _not_ported("PodRuntime preflight=%r (the analyzer's V-P02 "
                    "check_pod; pass preflight='off' or set "
                    "root.common.engine.pod.preflight=off)"
                    % self.preflight, "7(e)")

    # -- the plan -----------------------------------------------------------
    def _spec_for(self, vec, donated=False):
        return spec_for_vector(vec, self.batch, self.shards,
                               data_axis=self.data_axis,
                               param_rules=self.param_rules,
                               donated=donated)

    def _is_row(self, spec):
        return bool(spec) and spec[0] == self.data_axis \
            and not any(spec[1:])

    def _keep(self, vec):
        """Whether a placement change must keep ``vec``'s contents (all
        but the minibatch-led staging, which the next step rewrites)."""
        return id(vec) not in self._row_ids

    def _apply(self):
        """Pin the sharded Vectors, rewrite every stage for this rank,
        bind the segments and drop every compiled program."""
        self._stage_bytes = {}
        specs, rows = {}, set()
        for segment in self._segments:
            don_ids = set(id(v) for v in segment._don_vecs)
            for vec in (segment._read_vecs + segment._output_vecs):
                if isinstance(vec, Vector) and id(vec) not in specs:
                    donated = id(vec) in don_ids
                    spec = self._spec_for(vec, donated=donated)
                    specs[id(vec)] = (vec, spec)
                    # a parameter sharded over the data axis (FSDP) is
                    # no minibatch row
                    if self._is_row(spec) and not donated \
                            and vec.category != "params":
                        rows.add(id(vec))
        self._row_ids = rows
        sharded = []
        for vec, spec in specs.values():
            if any(spec):
                vec.set_sharding(Sharding(self.mesh, spec),
                                 keep=id(vec) not in rows)
                sharded.append(vec)
            elif vec.sharding is not None:
                vec.set_sharding(None)
        self._sharded_vecs = sharded
        self._specs = {key: spec for key, (_v, spec) in specs.items()}
        for segment in self._segments:
            for stage in segment.stages:
                self._rewrite(stage)
            segment.pod = self
            segment.invalidate()
            if segment.prof_entry is not None:
                segment.prof_entry.shards = self.shards
        self._invalidate_scan()

    def _restore(self):
        """Every rewritten stage gets its own function back."""
        for stage, fn in self._plain_fns.values():
            stage.fn = fn
        self._plain_fns = {}
        for unit in self._grad_units:
            unit.grad_group_ = None
        self._grad_units = []

    def _mode(self, stage):
        from veles_tpu_torch.znicz.gd_base import GDViaVJP
        if stage.shard is not None:
            return "head"
        if callable(getattr(stage.unit, "pod_stage_fn", None)):
            return "hook"
        if isinstance(stage.unit, GDViaVJP):
            return "grads"
        if stage.donated or stage.metrics:
            # contracts over the batch (or reports on it): the whole
            # minibatch on every rank
            return "gather"
        return "local"

    def _rewrite(self, stage):
        """Replace ``stage.fn`` with this rank's function (see the
        module)."""
        self._plain_fns[id(stage)] = (stage, stage.fn)
        mode = self._mode(stage)
        if mode == "head":
            stage.fn = stage.shard(self.row_start, self.rows)
            return
        group, mesh = self.group, self.mesh
        batch, rows, start = self.batch, self.rows, self.row_start
        split = self.shards > 1
        row_in = [name for name, vec in stage.consumes.items()
                  if id(vec) in self._row_ids]
        row_out = [name for name, vec in stage.produces.items()
                   if id(vec) in self._row_ids]
        placed = {}
        for group_of in (stage.params, stage.donated):
            for name, vec in group_of.items():
                spec = self._specs.get(id(vec), ())
                if any(spec):
                    placed[name] = spec
        written = [name for name in stage.donated if name in placed]
        if mode == "hook":
            inner_fn = stage.unit.pod_stage_fn(stage, self)
        else:
            inner_fn = stage.fn
        if mode == "grads":
            stage.unit.grad_group_ = group
            self._grad_units.append(stage.unit)
        gather = mode == "gather"
        moved = self._stage_bytes
        key = id(stage)

        def make(inner):
            def fn(t):
                before = comm.total_bytes()
                t = dict(t)
                for name in row_in:
                    x = t[name]
                    if gather:
                        if group is not None and (x.shape[0] == rows
                                                  or not split):
                            t[name] = comm.all_gather(x, group, 0)
                    elif split and x.shape[0] == batch:
                        # a whole minibatch published by a host unit
                        t[name] = x[start:start + rows]
                shards = {name: t[name] for name in written}
                for name, spec in placed.items():
                    t[name] = unshard(t[name], spec, mesh)
                out = inner(t)
                if gather and split:
                    for name in row_out:
                        out[name] = out[name][start:start + rows]
                for name in written:
                    # the rank's slice of the update, in place
                    shards[name].copy_(shard(out[name], placed[name], mesh))
                    out[name] = shards[name]
                moved[key] = comm.total_bytes() - before
                return out
            return fn

        stage.fn = _wrapped(inner_fn, make)

    # -- the ledger hooks ---------------------------------------------------
    def segment_collective_bytes(self, segment):
        """The collective payload bytes one dispatch of ``segment``
        issues on this rank, as its stages last counted them (a window
        multiplies by its K)."""
        return sum(self._stage_bytes.get(id(stage), 0)
                   for stage in segment.stages)

    # -- elastic membership -------------------------------------------------
    def pre_dispatch(self, segment):
        """The JAX runtime's chaos ``pod_chip`` site, called before every
        pod dispatch (a window's once).  The chaos controller is ROADMAP
        item 7(e): until it comes this consults nothing."""
        del segment

    def reshard(self, lost=1):
        """Shrink the mesh after losing ``lost`` ranks (the last ones)
        and resume from the last consistent step.  Every rank of the old
        mesh calls this in the same order: the sharded parameters are
        gathered over the old groups, every rank takes part in making
        the new groups (``torch.distributed.new_group`` is collective),
        then the ranks outside the new mesh leave the pod (their stages
        single-device again, their workflow stopped) and the survivors
        re-place every sharded buffer and run each program eagerly once,
        then capture it again.  The data axis becomes the largest size
        the global batch divides over the survivors; the other axes
        keep their extent."""
        survivors = max(1, self.mesh.size - int(lost))
        other = 1
        for name, size in self.mesh.shape.items():
            if name != self.data_axis:
                other *= int(size)
        if survivors < other:
            raise PodError(
                "cannot reshard: %d surviving rank(s) cannot carry the "
                "mesh's non-data axes (product %d) - a TP/PP-sharded pod "
                "cannot shrink below its model extent" % (survivors, other))
        new_n = max(1, survivors // other)
        while new_n > 1 and self.batch % new_n:
            new_n -= 1
        old_shards = self.shards
        # the last consistent step's parameters, gathered while the old
        # groups stand
        for vec in self._sharded_vecs:
            if self._keep(vec):
                vec.map_read()
        self._restore()
        axes = {name: (new_n if name == self.data_axis else int(size))
                for name, size in self.mesh.shape.items()}
        world = self.mesh.world_size if not self.mesh.live else None
        self.mesh = Mesh(axes, world_size=world)
        self.generation += 1
        self.reshards += 1
        if self.mesh.coords is None:
            self._leave()
        else:
            self._apply()
        trace.instant("pod", "reshard",
                      {"generation": self.generation,
                       "shards": self.shards, "was": old_shards},
                      role="pod")
        from veles_tpu_torch import watch
        if watch.enabled():
            watch.publish("reshard", generation=self.generation,
                          shards=self.shards, was=old_shards,
                          reshards=self.reshards, left=self.left)
        self.warning(
            "pod resharded %d -> %d shard(s) (generation %d)%s", old_shards,
            self.shards, self.generation,
            ": this rank left the pod" if self.left else
            ": params re-placed, %d segment program(s) recapturing"
            % len(self._segments))
        hook = self.on_reshard
        if hook is not None:
            try:
                hook(self)
            except Exception:
                self.exception("on_reshard hook failed")
        return self

    def _leave(self):
        """This rank is outside the new mesh: back to single-device
        stages over whole Vectors, and the workflow stops."""
        self.left = True
        for vec in self._sharded_vecs:
            vec.set_sharding(None, keep=self._keep(vec))
        for segment in self._segments:
            segment.pod = None
            segment.invalidate()
        self._sharded_vecs = []
        self._stage_bytes = {}
        self.installed = False
        self._invalidate_scan()
        self.workflow.stopped = True

