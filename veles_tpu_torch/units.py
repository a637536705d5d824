"""Unit: the dataflow + controlflow node of a workflow graph.

The port's counterpart of :mod:`veles_tpu.units`:

* the ``initialize()/run()/stop()`` contract;
* control edges via ``link_from`` with the gate semantics
  ``open_gate`` / ``gate_block`` / ``gate_skip``: a unit runs when ALL
  of its incoming control links have fired; ``gate_block`` suppresses
  the run and its propagation, ``gate_skip`` suppresses the run but
  propagates;
* data edges via ``link_attrs`` over
  :class:`veles_tpu_torch.mutable.LinkableAttribute`;
* ``demand()`` declared-dependency checking;
* per-unit wall-time accounting, each run under a ``unit`` span of
  :mod:`veles_tpu_torch.trace`;
* class auto-registration (``UnitRegistry``, with the ``MAPPING`` names
  that ``StandardWorkflow`` builds layers from).

The scheduler is the workflow's iterative FIFO work queue, as in the
JAX package.  Segment stitching: a unit opts in by returning a
:class:`veles_tpu_torch.stitch.StitchStage` from ``stitch_stage()``;
while the workflow runs with ``stitch_active``, ``run_wrapped`` goes
through the unit's segment (the head dispatches it, members no-op).
A unit with ``wants_thread`` runs on the workflow's background executor
(and is a stitching barrier); a trigger that arrives while its previous
run is still going is discarded with its propagation, as in the JAX
package.  ``is_master`` / ``is_slave`` read the workflow's launcher.

A unit pickles without its transient state (``_``-suffixed: the gate
lock, the segment membership, the workflow back-reference, which
``Workflow.__setstate__`` sets again); an unpickled unit installs its
data links' forwarding descriptors again, so they work in a fresh
process.
"""

import threading
import time

from veles_tpu_torch import trace
from veles_tpu_torch.distributable import Distributable
from veles_tpu_torch.mutable import Bool, LinkableAttribute


class MissingDemandedAttributes(AttributeError):
    """A demanded attribute is not yet available: ``Workflow.initialize``
    requeues the unit after its producers on this error only."""


class UnitRegistry(type):
    """Metaclass registering every Unit subclass by class name, and by
    ``MAPPING`` (and ``MAPPING_ALIASES``) in ``mapped``."""

    units = {}
    mapped = {}

    def __init__(cls, name, bases, namespace):
        super(UnitRegistry, cls).__init__(name, bases, namespace)
        if name != "Unit" and not namespace.get("hide_from_registry", False):
            UnitRegistry.units[name] = cls
            mapping = namespace.get("MAPPING")
            if mapping:
                UnitRegistry.mapped[mapping] = cls
            for alias in namespace.get("MAPPING_ALIASES", ()):
                UnitRegistry.mapped[alias] = cls


class Unit(Distributable, metaclass=UnitRegistry):
    """Dataflow + controlflow graph node."""

    hide_from_registry = True

    #: run on the workflow's background executor (host-blocking work)
    wants_thread = False

    def __init__(self, workflow, **kwargs):
        self.name = kwargs.get("name", self.__class__.__name__)
        #: incoming control edges: {unit: fired?}
        self.links_from = {}
        #: outgoing control edges: {unit: True}
        self.links_to = {}
        self.gate_block = Bool(False)
        self.gate_skip = Bool(False)
        self._is_initialized = False
        self._demanded = set()
        self.ignores_gate = False
        #: accumulated run() wall time, seconds
        self.total_run_time = 0.0
        super(Unit, self).__init__(**kwargs)
        self._workflow_ref_ = None
        if workflow is not None:
            workflow.add_ref(self)

    def init_unpickled(self):
        super(Unit, self).init_unpickled()
        self._gate_lock_ = threading.Lock()
        self._run_lock_ = threading.Lock()
        # the segments hold CUDA graphs: Workflow.initialize rebuilds
        # the membership after an unpickle
        self._stitch_segment_ = None
        if not hasattr(self, "_workflow_ref_"):
            # a unit unpickled on its own; Workflow.__setstate__ links
            # its members again
            self._workflow_ref_ = None
        # the data links' descriptors live on the class, in this process
        LinkableAttribute.reinstall(self)

    def __repr__(self):
        return '<%s "%s">' % (self.__class__.__name__, self.name)

    # -- workflow membership ----------------------------------------------
    @property
    def workflow(self):
        return self._workflow_ref_

    @workflow.setter
    def workflow(self, value):
        self._workflow_ref_ = value

    @property
    def is_master(self):
        wf = self.workflow
        return wf.is_master if wf is not None else False

    @property
    def is_slave(self):
        wf = self.workflow
        return wf.is_slave if wf is not None else False

    # -- graph construction -------------------------------------------------
    def link_from(self, *src_units):
        """Add control edges ``src → self``."""
        for src in src_units:
            self.links_from[src] = False
            src.links_to[self] = True
        self._is_initialized = False
        return self

    def unlink_from(self, *src_units):
        """Remove control edges ``src → self``."""
        for src in src_units:
            self.links_from.pop(src, None)
            src.links_to.pop(self, None)
        self._is_initialized = False
        return self

    def link_attrs(self, other, *names, two_way=False):
        """Add data edges: alias ``self.<dst>`` to ``other.<src>``; each
        name is a string (same on both sides) or a ``(dst, src)`` pair."""
        for name in names:
            if isinstance(name, tuple):
                dst_name, src_name = name
            else:
                dst_name = src_name = name
            LinkableAttribute.link(self, dst_name, other, src_name,
                                   two_way=two_way)
        return self

    def demand(self, *names):
        """Declare attributes that must be linked or set before
        ``initialize``."""
        self._demanded.update(names)

    def verify_interface(self):
        missing = [n for n in self._demanded
                   if getattr(self, n, None) is None]
        if missing:
            raise MissingDemandedAttributes(
                "%r is missing demanded attributes: %s — link_attrs() them "
                "from a producer unit" % (self, ", ".join(sorted(missing))))

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, **kwargs):
        self.verify_interface()
        self._is_initialized = True

    def run(self):
        pass

    def stop(self):
        pass

    # -- segment stitching (veles_tpu_torch.stitch) ---------------------------
    def stitch_stage(self):
        """This unit's :class:`veles_tpu_torch.stitch.StitchStage`, or
        None (the default: the unit is a barrier)."""
        return None

    def attach_stitch_segment(self, segment):
        self._stitch_segment_ = segment

    @property
    def stitch_segment(self):
        return self._stitch_segment_

    # -- gate semantics -----------------------------------------------------
    def open_gate(self, src):
        """Mark the edge from ``src`` as fired; True when ALL incoming
        edges have fired (and then re-arm them)."""
        with self._gate_lock_:
            if src is not None and src in self.links_from:
                self.links_from[src] = True
            if not all(self.links_from.values()):
                return False
            for key in self.links_from:
                self.links_from[key] = False
            return True

    def reset_gate(self):
        """Re-arm this unit's gate: mark every incoming edge unfired."""
        with self._gate_lock_:
            for key in self.links_from:
                self.links_from[key] = False

    def _check_gate_and_run(self, src):
        """The scheduler loop's body for one queued trigger."""
        if not self.open_gate(src) and not self.ignores_gate:
            return
        if bool(self.gate_block):
            return
        # a trigger arriving while the previous run still goes (only
        # background units can make one) is discarded with its
        # propagation
        if not self._run_lock_.acquire(blocking=False):
            return
        try:
            if not bool(self.gate_skip):
                self.run_wrapped()
        finally:
            self._run_lock_.release()
        self.run_dependent()

    def run_wrapped(self):
        """``run()`` under a ``unit`` span, with wall-time accounting
        and the workflow's stop check; through the unit's segment while
        the workflow runs stitched (the segment's own span covers it)."""
        wf = self.workflow
        if wf is not None and wf.stopped:
            return
        segment = self._stitch_segment_
        tic = time.perf_counter()
        try:
            if segment is not None and wf is not None \
                    and getattr(wf, "stitch_active", False):
                segment.member_run(self)
            else:
                with trace.span("unit", self.name):
                    self.run()
        except Exception:
            self.error("failed to run %r", self)
            if wf is not None:
                wf.on_unit_failed(self)
            raise
        finally:
            self.total_run_time += time.perf_counter() - tic

    def run_dependent(self):
        """Enqueue every downstream unit on the workflow's scheduler."""
        wf = self.workflow
        if wf is None or wf.stopped:
            return
        for dst in self.links_to:
            wf.schedule(dst, self)

    @property
    def run_time(self):
        return self.total_run_time
