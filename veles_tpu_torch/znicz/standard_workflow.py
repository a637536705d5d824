"""StandardWorkflow: the canonical training-graph builder, the port's
counterpart of :mod:`veles_tpu.znicz.standard_workflow`::

    repeater → loader → forwards… → evaluator → decision → gds… ─┐
        ▲                                                        │
        └────────────────────── back edge ───────────────────────┘
    decision --complete--> end_point ; gds gated to TRAIN minibatches

Layer specs are a list of dicts with ``type`` (a unit ``MAPPING``) and
the forward ``->`` and backward ``<-`` parameter groups, or an
``mcdnnic_topology`` string (:mod:`veles_tpu_torch.znicz.mcdnnic`) with
``mcdnnic_parameters`` for every generated layer.  With
``engine.stitch=on`` (the default) ``initialize()`` stitches the eager
chain into two segments, ``[loader head, forwards…, evaluator]`` and
``[gds…]`` (:mod:`veles_tpu_torch.stitch`).

``fused=True`` replaces the chain after the loader with one
:class:`~veles_tpu_torch.znicz.fused_unit.FusedTrainer` (``repeater →
loader → trainer → decision``): the forwards are built unchained, for
their shapes and weights, and the Decision reads the trainer's metric;
``fused_config`` passes the lowering's knobs (``compute_dtype``,
``remat``, ``grad_accum``, ``epoch_mode``).  The loader then serves
only the minibatch's indices, and the step gathers the rows from the
resident dataset (a native u8 one normalized in the step).

Off the Decision hang, when configured: the snapshotter
(``snapshotter_config``, gated on ``~decision.improved``, which the
export clears: one snapshot an improving validation), the image saver
(``image_saver_config``, eager only), the LR adjuster
(``lr_adjuster_config``: before the GDs, or evaluated in the fused
step) and :class:`~veles_tpu_torch.znicz.rollback.Rollback`
(``rollback_config``: linked whenever it is given, ``{}`` taking the
defaults).  A unit hanging off the Decision keeps the eager run on the
per-step stitched route (the epoch-scan windows refuse it, with the JAX
package's reason).  ``restore_train_state`` refreshes a fused trainer's
parameters from the restored forwards.  Not ported: the plotters
(ROADMAP item 7(e)); an option the port does not take is refused when
it is given at all, not only when it is truthy.

Master and slave (:mod:`veles_tpu_torch.parallel.jobs`): a job is one
pass of the slave's graph.  On a slave ``initialize()`` unlinks the
repeater from the loop's tail, opens the end point and stitches again,
so each ``run()`` is one minibatch through the segments (no graph of
the standalone chain is reused).  The master raises ``StopIteration``
from ``generate_data_for_slave`` once the Decision is complete.  A fused
slave installs each job's weights into the built parameters in place
(``refresh_from_forwards``: its step graphs keep their addresses) and
writes the trained ones back into the forwards before the update is
taken (``sync_weights``).

The layer types are those of the JAX package's ``GD_PAIRS``: the
all2all family on the GEMM and GD kernels, and the layer zoo (conv,
pooling, LRN, dropout, the activations, deconv, the cutter, the channel
splitter, depooling, ``rprop_all2all``, ``resizable_all2all``, the
recurrent ``lstm`` and ``rnn``), whose backward units are VJPs of their
forwards (:mod:`veles_tpu_torch.znicz.gd_base`).
A dropout layer's ``forward_mode`` is a ``ClassSkipGate``: the identity
off TRAIN minibatches.  ``zero_filter`` and ``channel_merger`` are
service units, refused in ``layers`` with the JAX package's text.

``loss_function="mse"`` (the default when the last layer is not a
softmax) takes ``EvaluatorMSE`` against the loader's
``minibatch_targets`` (a :class:`~veles_tpu_torch.loader.fullbatch.
FullBatchLoaderMSE`) and ``DecisionMSE``; the GD chain reads the
evaluator's ``err_output`` as for the softmax loss.
"""

import numpy

from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.units import UnitRegistry
from veles_tpu_torch.znicz import (  # noqa: F401 - populate the registry
    activation, all2all, conv, gd, misc_units, normalization_units,
    pooling, rnn)
from veles_tpu_torch.znicz.decision import DecisionGD, DecisionMSE
from veles_tpu_torch.znicz.evaluator import EvaluatorMSE, EvaluatorSoftmax

#: forward MAPPING → paired gradient MAPPING: the JAX package's table
GD_PAIRS = {
    "all2all": "gd",
    "all2all_tanh": "gd_tanh",
    "all2all_sigmoid": "gd_sigmoid",
    "all2all_relu": "gd_relu",
    "all2all_strict_relu": "gd_strict_relu",
    "resizable_all2all": "gd",
    # sign-based per-weight step sizes (iRprop−)
    "rprop_all2all": "gd_rprop",
    "softmax": "gd_softmax",
    "conv": "gd_conv",
    "conv_tanh": "gd_conv_tanh",
    "conv_sigmoid": "gd_conv_sigmoid",
    "conv_relu": "gd_conv_relu",
    "conv_strict_relu": "gd_conv_strict_relu",
    "max_pooling": "gd_max_pooling",
    "maxabs_pooling": "gd_max_pooling",
    "avg_pooling": "gd_avg_pooling",
    "stochastic_pooling": "gd_stochastic_pooling",
    "stochasticabs_pooling": "gd_stochastic_pooling",
    "stochastic_pool_depool": "gd_stochastic_pooling",
    "stochastic_abs_pool_depool": "gd_stochastic_pooling",
    # forward-only layer types: the backward is the VJP of the forward
    "depooling": "gd_generic",
    "channel_splitter": "gd_generic",
    # recurrent: the VJP through the sequence loop
    "lstm": "gd_generic",
    "rnn": "gd_generic",
    "lrn": "gd_lrn",
    "dropout": "gd_dropout",
    # the alias spellings pair with their canonical names' backwards
    "all2all_str": "gd_strict_relu",
    "conv_str": "gd_conv_strict_relu",
    "activation_str": "gd_activation",
    "norm": "gd_lrn",
    "stochastic_abs_pooling": "gd_stochastic_pooling",
    "deconv": "gd_deconv",
    "cutter": "gd_cutter",
    "activation_tanh": "gd_activation",
    "activation_sigmoid": "gd_activation",
    "activation_relu": "gd_activation",
    "activation_strict_relu": "gd_activation",
    "activation_log": "gd_activation",
    "activation_tanhlog": "gd_activation",
    "activation_sincos": "gd_activation",
    "activation_mul": "gd_activation",
}

#: StandardWorkflow options of the JAX package not ported yet, with the
#: ROADMAP item that will port each; refused when given (not None)
_NOT_PORTED = {"plotters_config": "7(e)"}


class ClassSkipGate(Bool):
    """True while the loader is NOT serving ``cls`` minibatches: the
    ``gate_skip`` that runs the gradient units on TRAIN batches only."""

    __slots__ = ("loader", "cls")

    def __init__(self, loader, cls=TRAIN):
        super(ClassSkipGate, self).__init__(False)
        self.loader = loader
        self.cls = cls

    def __bool__(self):
        return int(self.loader.minibatch_class) != self.cls

    def __getstate__(self):
        return (self.loader, self.cls)

    def __setstate__(self, state):
        self.loader, self.cls = state
        self._value = False
        self._expr = None


class StandardWorkflow(AcceleratedWorkflow):
    """Builds the training graph from the ``layers`` config.

    kwargs:
      loader_factory: callable(workflow) → Loader (required)
      layers: list of {"type": MAPPING, "->": {...}, "<-": {...}}
      loss_function: "softmax" (the default from a last softmax layer)
        or "mse" (the default otherwise)
      decision_config: dict for the Decision unit
      snapshotter_config: kwargs of the SnapshotterToFile (None: none)
    """

    def __init__(self, workflow=None, **kwargs):
        for key, item in _NOT_PORTED.items():
            if kwargs.pop(key, None) is not None:
                raise NotImplementedError(
                    "StandardWorkflow option %r is not ported yet "
                    "(ROADMAP item %s)" % (key, item))
        self.layers = kwargs.pop("layers", [])
        topology = kwargs.pop("mcdnnic_topology", None)
        mcdnnic_parameters = kwargs.pop("mcdnnic_parameters", None)
        if topology is not None:
            if self.layers:
                raise ValueError(
                    "give either layers or mcdnnic_topology, not both")
            from veles_tpu_torch.znicz.mcdnnic import parse_topology
            _shape, self.layers = parse_topology(topology,
                                                 mcdnnic_parameters)
        self.loss_function = kwargs.pop("loss_function", None)
        self.decision_config = dict(kwargs.pop("decision_config", {}))
        self.snapshotter_config = kwargs.pop("snapshotter_config", None)
        #: fused=True: one FusedTrainer step a minibatch instead of the
        #: eager chain; fused_config passes the lowering's knobs
        self.fused = bool(kwargs.pop("fused", False))
        self.fused_config = dict(kwargs.pop("fused_config", None) or {})
        self.fused_trainer = None
        #: the LR adjuster's policy names and parameters
        self.lr_adjuster_config = kwargs.pop("lr_adjuster_config", None)
        self.lr_adjuster = None
        #: Rollback's {"fail_iterations": N, "lr_factor": f}
        self.rollback_config = kwargs.pop("rollback_config", None)
        self.rollback = None
        #: ImageSaver's {"out_dirs": [test, validation, train], "limit"}
        self.image_saver_config = kwargs.pop("image_saver_config", None)
        self.image_saver = None
        if self.lr_adjuster_config and self.fused:
            # the fused step evaluates the schedule itself
            self.fused_config.setdefault(
                "lr_adjuster", dict(self.lr_adjuster_config))
        loader_factory = kwargs.pop("loader_factory")
        super(StandardWorkflow, self).__init__(workflow, **kwargs)
        self.repeater = Repeater(self)
        self.loader = loader_factory(self)
        self.forwards = []
        self.gds = []
        self.evaluator = None
        self.snapshotter = None
        self.create_workflow()

    # -- the link_* contract ------------------------------------------------
    def create_workflow(self):
        self.link_loader()
        if self.fused:
            if self.image_saver_config is not None:
                raise NotImplementedError(
                    "image_saver needs the eager evaluator's per-sample "
                    "max_idx; use fused=False")
            self.link_forwards(chain=False)
            self.link_fused_trainer()
            self.link_decision()
            if self.snapshotter_config is not None:
                self.link_snapshotter()
            if self.rollback_config is not None:
                self.link_rollback()
            self.link_loop_and_end()
            return
        if getattr(self.loader, "native_device_dtype", False):
            # the eager forward units consume minibatch_data as it is:
            # raw integers must never train silently.  The stitched
            # head's gather + normalize hands the first forward
            # normalized float32, so native is legal when it engages.
            eng = root.common.engine
            stitched_norm = (
                str(eng.get("stitch", "on")).lower()
                not in ("off", "0", "false", "no")
                and str(eng.get("loader", "auto")).lower() != "host")
            if not stitched_norm:
                raise ValueError(
                    "native_device_dtype loaders require fused=True or "
                    "the stitched device fast path (engine.stitch=on, "
                    "engine.loader!=host): the affine normalizer is "
                    "applied inside the fused step or the stitched "
                    "gather+normalize head")
        self.link_forwards()
        self.link_evaluator()
        self.link_decision()
        if self.snapshotter_config is not None:
            self.link_snapshotter()
        if self.image_saver_config is not None:
            self.link_image_saver()
        if self.lr_adjuster_config:
            self.link_lr_adjuster()
        self.link_gds()
        if self.rollback_config is not None:
            self.link_rollback()
        self.link_loop_and_end()

    def link_image_saver(self):
        """Misclassified samples of each minibatch to disk
        (:class:`~veles_tpu_torch.znicz.image_saver.ImageSaver`)."""
        if self._loss_kind() != "softmax":
            raise ValueError("image_saver needs classification "
                             "(max_idx); loss is %r" % self._loss_kind())
        from veles_tpu_torch.znicz.image_saver import ImageSaver
        self.image_saver = ImageSaver(
            self, **dict(self.image_saver_config or {}))
        s = self.image_saver
        s.link_attrs(self.loader, ("input", "minibatch_data"),
                     ("labels", "minibatch_labels"),
                     "minibatch_class", "minibatch_size", "epoch_number")
        s.link_attrs(self.evaluator, "max_idx")
        s.link_from(self.decision)

    def link_rollback(self):
        """The best-state keeper, after the Decision so that it sees
        every epoch close."""
        from veles_tpu_torch.znicz.rollback import Rollback
        self.rollback = Rollback(self, **dict(self.rollback_config or {}))
        self.rollback.decision = self.decision
        self.rollback.forwards = self.forwards
        self.rollback.gds = self.gds
        self.rollback.trainer = self.fused_trainer
        self.rollback.lr_adjuster = self.lr_adjuster
        self.rollback.link_from(self.decision)

    def link_lr_adjuster(self):
        """The LR adjuster BEFORE the gradient chain, so TRAIN minibatch
        t trains with factor f(t), as the fused step's schedule does; it
        rescales the GD units that :meth:`link_gds` makes."""
        from veles_tpu_torch.znicz.lr_adjust import LearningRateAdjust
        self.lr_adjuster = LearningRateAdjust(
            self, **dict(self.lr_adjuster_config or {}))
        self.lr_adjuster.gds = self.gds   # shared list, filled by link_gds
        self.lr_adjuster.link_from(self.decision)
        # the schedule advances once a TRAIN minibatch
        self.lr_adjuster.gate_skip = ClassSkipGate(self.loader, TRAIN)

    def link_loader(self):
        self.repeater.link_from(self.start_point)
        self.loader.link_from(self.repeater)

    def _make_unit(self, mapping, params):
        try:
            klass = UnitRegistry.mapped[mapping]
        except KeyError:
            raise ValueError(
                "unknown layer type %r (ported: %s)" %
                (mapping, ", ".join(sorted(UnitRegistry.mapped))))
        return klass(self, **params)

    #: registered unit types that are NOT chainable layers: they have no
    #: single input → output seam for link_forwards / link_gds
    NON_LAYER_TYPES = frozenset({"zero_filter", "channel_merger"})

    def link_forwards(self, chain=True):
        """The forward units; with ``chain=False`` (fused mode) they are
        attribute-linked for shape inference and weight storage but stay
        out of the control graph: the FusedTrainer computes."""
        from veles_tpu_torch.znicz.normalization_units import DropoutForward
        prev = self.loader
        prev_attr = "minibatch_data"
        for spec in self.layers:
            if spec["type"] in self.NON_LAYER_TYPES:
                raise ValueError(
                    "%r is a service unit, not a chainable layer — "
                    "construct it directly (e.g. ZeroFiller(wf, "
                    "mask=...).target_unit = fwd; ChannelMerger(wf)"
                    ".link_inputs(...)) instead of listing it in "
                    "layers" % spec["type"])
            unit = self._make_unit(spec["type"], dict(spec.get("->", {})))
            if chain:
                unit.link_from(prev)
            unit.link_attrs(prev, ("input", prev_attr))
            if isinstance(unit, DropoutForward):
                # dropout is the identity off TRAIN minibatches
                unit.forward_mode = ClassSkipGate(self.loader, TRAIN)
            init = spec.get("init")
            if init:
                # pre-seeded parameters: initialize() keeps them
                unit.weights.reset(init["weights"])
                if "bias" in init:
                    unit.bias.reset(init["bias"])
            self.forwards.append(unit)
            prev = unit
            prev_attr = "output"

    def link_fused_trainer(self):
        from veles_tpu_torch.loader.fullbatch import FullBatchLoader
        from veles_tpu_torch.znicz.fused_unit import FusedTrainer
        if not isinstance(self.loader, FullBatchLoader):
            raise NotImplementedError(
                "fused=True gathers each minibatch inside its step from a "
                "resident FullBatchLoader dataset (got %s)"
                % type(self.loader).__name__)
        self.fused_trainer = FusedTrainer(
            self, layers=[{**s} for s in self.layers],
            loss=self._loss_kind(), **self.fused_config)
        self.fused_trainer.loader = self.loader
        self.fused_trainer.forwards = self.forwards
        self.fused_trainer.link_from(self.loader)
        # the step gathers (and normalizes) the rows itself: the loader
        # serves the indices only
        self.loader.rows_by_consumer = True

    def _loss_kind(self):
        return self.loss_function or (
            "softmax" if self.layers[-1]["type"] == "softmax" else "mse")

    def link_evaluator(self):
        loss = self._loss_kind()
        if loss not in ("softmax", "mse"):
            raise ValueError("unknown loss function %r" % loss)
        last = self.forwards[-1]
        if loss == "softmax":
            self.evaluator = EvaluatorSoftmax(self)
            self.evaluator.link_attrs(last, "output", "max_idx")
            self.evaluator.link_attrs(self.loader,
                                      ("labels", "minibatch_labels"))
        else:
            self.evaluator = EvaluatorMSE(self)
            self.evaluator.link_attrs(last, "output")
            self.evaluator.link_attrs(self.loader,
                                      ("target", "minibatch_targets"))
        self.evaluator.link_attrs(self.loader,
                                  ("batch_size", "minibatch_size"))
        self.evaluator.link_from(last)

    def link_decision(self):
        decision = DecisionMSE if self._loss_kind() == "mse" else DecisionGD
        self.decision = decision(self, **self.decision_config)
        self.decision.link_from_loader(self.loader)
        # in fused mode the trainer exposes the evaluator's metric
        err_src = self.fused_trainer if self.fused else self.evaluator
        self.decision.evaluator = err_src
        self.decision.link_from(err_src)

    def link_snapshotter(self):
        """Snapshot at every improving validation: gated on
        ``~decision.improved``, which the export clears (it stays up
        until the next validated close), named by the Decision's
        ``snapshot_suffix``."""
        from veles_tpu_torch.snapshotter import SnapshotterToFile
        self.snapshotter = SnapshotterToFile(
            self, **dict(self.snapshotter_config or {}))
        self.snapshotter.link_from(self.decision)
        self.snapshotter.link_attrs(
            self.decision, ("suffix", "snapshot_suffix"))
        self.snapshotter.gate_skip = ~self.decision.improved
        self.snapshotter.reset_flag = self.decision.improved

    def link_gds(self):
        """The backward chain in reverse layer order, gated to TRAIN
        batches, after the LR adjuster when there is one; the first
        layer's GD computes no err_input."""
        prev = self.lr_adjuster if self.lr_adjuster is not None \
            else self.decision
        err_src, err_attr = self.evaluator, "err_output"
        skip_gate = ClassSkipGate(self.loader, TRAIN)
        for forward, spec in zip(reversed(self.forwards),
                                 reversed(self.layers)):
            params = dict(spec.get("<-", {}))
            if forward is self.forwards[0]:
                params.setdefault("need_err_input", False)
            unit = self._make_unit(GD_PAIRS[spec["type"]], params)
            unit.setup_from_forward(forward)
            unit.link_attrs(err_src, ("err_output", err_attr))
            unit.gate_skip = skip_gate
            unit.link_from(prev)
            self.gds.append(unit)
            prev = unit
            err_src, err_attr = unit, "err_input"

    def link_loop_and_end(self):
        last_gd = self.gds[-1] if self.gds else self.decision
        self._loop_tail = last_gd
        self.repeater.link_from(last_gd)
        self.end_point.link_from(last_gd)
        self.end_point.gate_block = ~self.decision.complete
        self.repeater.gate_block = self.decision.complete

    def initialize(self, device=None, **kwargs):
        result = super(StandardWorkflow, self).initialize(
            device=device, **kwargs)
        if self.is_slave:
            # a job is ONE pass of the graph: no back edge, and the end
            # point open; the chain changed, so stitch it again before
            # any segment dispatched
            self.repeater.unlink_from(self._loop_tail)
            self.end_point.gate_block = Bool(False)
            self.rebuild_stitching()
        return result

    # -- the job contract -----------------------------------------------------
    def generate_data_for_slave(self, slave=None):
        """Master: no more jobs once the Decision is complete."""
        if bool(self.decision.complete):
            raise StopIteration
        return super(StandardWorkflow, self).generate_data_for_slave(slave)

    def apply_data_from_master(self, data):
        super(StandardWorkflow, self).apply_data_from_master(data)
        if self.fused and self.fused_trainer is not None:
            # the job's weights are in the forwards' Vectors now: into
            # the built parameters with them (the solver state stays
            # the slave's, as the eager route's momenta do)
            self.fused_trainer.refresh_from_forwards()

    def generate_data_for_master(self):
        if self.fused and self.fused_trainer is not None:
            # the forwards take the deltas from their Vectors: the
            # trained parameters go there first
            self.fused_trainer.sync_weights()
        return super(StandardWorkflow, self).generate_data_for_master()

    def restore_train_state(self, train, meta):
        restored = super(StandardWorkflow, self).restore_train_state(
            train, meta)
        if self.fused and self.fused_trainer is not None:
            # the forwards' weights were just replaced: into the built
            # parameters with them
            self.fused_trainer.refresh_from_forwards()
        return restored

    # -- carrying weights across --------------------------------------------
    def _param_vectors(self):
        """(name, Vector) of every trainable parameter and momentum, in
        layer order: ``{i}.weights``, ``{i}.bias``,
        ``{i}.gradient_weights``, ``{i}.gradient_bias``."""
        gds = list(reversed(self.gds))
        for i, forward in enumerate(self.forwards):
            yield "%d.weights" % i, forward.weights
            if forward.include_bias:
                yield "%d.bias" % i, forward.bias
            if i < len(gds):
                yield "%d.gradient_weights" % i, gds[i].gradient_weights
                if gds[i].include_bias:
                    yield "%d.gradient_bias" % i, gds[i].gradient_bias

    def params_to_numpy(self):
        """Copies of the forwards' weights and biases and the GDs'
        momenta as numpy arrays in the JAX package's storage layout
        (``(fan-in, neurons)``, or ``(neurons, fan-in)`` when
        ``weights_transposed``), keyed as :meth:`_param_vectors` names
        them."""
        return {name: numpy.array(vec.mem)
                for name, vec in self._param_vectors() if vec}

    def params_from_numpy(self, arrays):
        """Install copies of ``arrays`` (keys and layouts as
        :meth:`params_to_numpy` gives them) into the parameter and
        momentum Vectors; their device copies are rebuilt at the next
        use.  Call it after ``initialize()``."""
        vectors = dict(self._param_vectors())
        unknown = sorted(set(arrays) - set(vectors))
        if unknown:
            raise KeyError("no such parameters: %s" % unknown)
        for name, value in arrays.items():
            vec = vectors[name]
            value = numpy.array(value, dtype=numpy.float32)
            if vec and tuple(vec.shape) != value.shape:
                raise ValueError("%s: shape %s, want %s"
                                 % (name, value.shape, vec.shape))
            vec.reset(value)
