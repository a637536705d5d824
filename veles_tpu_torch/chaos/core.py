"""Deterministic, seeded fault injection for the distributed stack: the
port's copy of :mod:`veles_tpu.chaos.core`.

The reference platform proves its elasticity with a single knob —
``--slave-death-probability`` (``client.py:303``) — that kills slaves
mid-job so the master's reaper/requeue/blacklist machinery is exercised
for real.  This module generalizes that idea into a *fault model* the
whole job layer is gated against:

* **wire faults** on the job wire (:mod:`veles_tpu_torch.parallel.wire`)
  — ``drop``, ``dup``, ``delay``,
  ``corrupt`` a frame, or ``partition`` (drop every matching frame for
  a duration window);
* **process faults** at the process boundary — ``slave_kill``,
  ``slave_hang``, ``master_stall``, ``master_kill``.

Every injection decision is **deterministic**: probabilistic faults
draw from ONE seeded :class:`random.Random`, and scheduled faults fire
on the *nth matching occurrence* of a (site, op) pair — so a failure
run is replayable from ``(seed, schedule)`` alone, and the schedule is
a plain JSON-serializable list (:meth:`ChaosSchedule.to_json`).

Injection sites (consulted by :mod:`veles_tpu_torch.parallel.jobs`):

==============  ========================================================
site            meaning
==============  ========================================================
``master_recv``  a frame arriving at the :class:`JobServer` ROUTER
``master_send``  a reply leaving the master
``slave_send``   a request leaving a :class:`JobClient`
``slave_recv``   a reply arriving at a :class:`JobClient`
``slave_job``    process-boundary check before each job's compute
``master_tick``  process-boundary check each server-loop iteration
``pod_chip``     pod-runtime check before each sharded dispatch
                 (``chip_kill``; the port's pod runtime does not
                 consult it yet, ROADMAP item 7(e))
==============  ========================================================

Knobs (``root.common.chaos.*``, read at :func:`configure` time —
called by ``Launcher.initialize`` so launcher-driven runs arm from the
config tree; code that builds ``JobServer``/``JobClient`` directly
must call :func:`configure` (or :meth:`ChaosController.arm`) itself,
as the tests and the smoke do):

* ``enabled`` — master switch (default off: every hook is one
  attribute check);
* ``seed`` — the RNG seed (default 1234);
* ``schedule`` — a list of fault dicts (or a path to a JSON file of
  them), see :class:`Fault`;
* ``drop_probability`` / ``dup_probability`` / ``delay_probability``
  + ``delay_ms`` / ``corrupt_probability`` — background probabilistic
  wire faults applied to every data-plane frame (pings excluded so the
  liveness channel itself stays testable via explicit schedule
  entries);
* ``slave_death_probability`` — the reference's knob, applied at
  ``slave_job`` (kept here so ONE switch arms the whole model).

Every injected fault emits a ``chaos`` trace instant (when tracing is
on), so injections land in the merged Perfetto timeline next to the
checkpoint spans and resume markers they provoke.
"""

import json
import random
import threading
import time

from veles_tpu_torch import trace

#: wire actions a schedule entry (or probability knob) may request
WIRE_ACTIONS = ("drop", "dup", "delay", "corrupt", "partition")
#: process-boundary actions (``chip_kill`` fires at the pod runtime's
#: ``pod_chip`` site: one simulated chip drops out of the mesh, the
#: pod reshards onto the survivors and bumps its generation —
#: the JAX package's ``PodRuntime.pre_dispatch``;
#: ``replica_drain`` fires at the fleet's ``fleet_decode`` site: one
#: decode replica is drained mid-stream and its live requests replay
#: onto the survivors — the JAX package's ``Fleet.tick``)
PROCESS_ACTIONS = ("slave_kill", "slave_hang", "master_stall",
                   "master_kill", "chip_kill", "replica_drain")


class Fault(object):
    """One serializable schedule entry.

    ``site``: an injection site (see module table).  ``action``: one of
    :data:`WIRE_ACTIONS` / :data:`PROCESS_ACTIONS`.  ``op``: restrict
    to frames with this wire op (``None`` = any).  ``nth``: fire on the
    nth *matching* occurrence (1-based); ``every``: fire on every kth
    match instead; ``prob``: fire with this probability per match
    (seeded RNG).  Exactly one of ``nth``/``every``/``prob`` selects.
    ``delay_ms`` (delay), ``duration_s`` (partition/hang/stall) and
    ``count`` (extra dup copies) parameterize the action."""

    FIELDS = ("site", "action", "op", "nth", "every", "prob",
              "delay_ms", "duration_s", "count")

    def __init__(self, site, action, op=None, nth=None, every=None,
                 prob=None, delay_ms=50.0, duration_s=1.0, count=1):
        if action not in WIRE_ACTIONS + PROCESS_ACTIONS:
            raise ValueError("unknown chaos action %r" % (action,))
        if action == "dup" and site == "slave_recv":
            # the slave consumes exactly one decoded reply per rpc —
            # a receive-side dup has no observable effect there, and
            # silently counting it would break injected==observed
            raise ValueError("dup cannot fire at slave_recv "
                             "(dup the reply at master_send instead)")
        selectors = [s for s in (nth, every, prob) if s is not None]
        if len(selectors) != 1:
            raise ValueError(
                "fault %s@%s needs exactly one of nth/every/prob"
                % (action, site))
        self.site = site
        self.action = action
        self.op = op
        self.nth = nth
        self.every = every
        self.prob = prob
        self.delay_ms = float(delay_ms)
        self.duration_s = float(duration_s)
        self.count = int(count)
        #: matches seen so far (the deterministic occurrence counter)
        self.seen = 0
        self.fired = 0

    def matches(self, op):
        return self.op is None or self.op == op

    def should_fire(self, rng):
        """Advance the occurrence counter and decide.  Called once per
        matching frame — the counter IS the determinism."""
        self.seen += 1
        if self.nth is not None:
            return self.seen == self.nth
        if self.every is not None:
            return self.seen % self.every == 0
        return rng.random() < self.prob

    def to_dict(self):
        return {k: getattr(self, k) for k in self.FIELDS
                if getattr(self, k) is not None}

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: v for k, v in dict(d).items()
                      if k in cls.FIELDS})

    def __repr__(self):
        sel = ("nth=%d" % self.nth if self.nth is not None else
               "every=%d" % self.every if self.every is not None else
               "prob=%g" % self.prob)
        return "<Fault %s@%s op=%s %s fired=%d>" % (
            self.action, self.site, self.op, sel, self.fired)


class ChaosSchedule(object):
    """An ordered, JSON-serializable list of :class:`Fault` entries —
    the replayable record of *which* failures a run injects."""

    def __init__(self, faults=()):
        self.faults = [f if isinstance(f, Fault) else Fault.from_dict(f)
                       for f in faults]

    def to_json(self):
        return json.dumps([f.to_dict() for f in self.faults], indent=2)

    @classmethod
    def from_json(cls, text):
        return cls(json.loads(text))

    @classmethod
    def load(cls, path):
        with open(path, "r") as fin:
            return cls.from_json(fin.read())

    def __iter__(self):
        return iter(self.faults)

    def __len__(self):
        return len(self.faults)


class WirePlan(object):
    """The injection decision for ONE frame: ``deliveries`` copies
    (0 = dropped, 2+ = duplicated), an optional pre-delivery ``delay``
    in seconds, and ``corrupt`` (mangle the frame bytes)."""

    __slots__ = ("deliveries", "delay_s", "corrupt")

    def __init__(self, deliveries=1, delay_s=0.0, corrupt=False):
        self.deliveries = deliveries
        self.delay_s = delay_s
        self.corrupt = corrupt


#: shared no-fault plan — the common case allocates nothing
_CLEAN = WirePlan()


class ChaosController(object):
    """Process-wide injection switchboard (``veles_tpu_torch.chaos.controller``).

    Disabled (the default) every hook is a single attribute check on
    :attr:`armed`.  Armed, each hook consults the schedule + the
    probability knobs under one lock (the job wire is low-rate control
    traffic; contention is irrelevant next to a network frame)."""

    def __init__(self):
        self.armed = False
        self._lock = threading.Lock()
        self._rng = random.Random(1234)
        self.schedule = ChaosSchedule()
        self._prob = {}
        #: active partition windows: (site, op-or-None) -> end time
        self._partitions = {}
        #: per-action injected counts (the smoke's consistency record)
        self.injected = {}
        #: (site, op) -> frames OBSERVED while armed, injected or not —
        #: the wire-traffic probe the pod wire gate reads: arm an empty
        #: schedule and these counters prove steady-state pod training
        #: moves ZERO per-step gradient/update frames (control traffic
        #: is O(heartbeats + epochs), not O(minibatches))
        self.wire_frames = {}
        self.seed = 1234

    # -- configuration ------------------------------------------------------
    def configure(self, value=None):
        """(Re)read ``root.common.chaos.*``.  ``value`` overrides the
        ``enabled`` knob (used by tests/CLI).  Counters reset — a
        configure() is the start of a new replayable run."""
        from veles_tpu_torch.config import root
        node = root.common.get("chaos")
        cfg = node.to_dict() if node is not None and node else {}
        with self._lock:
            self.armed = bool(cfg.get("enabled", False)
                              if value is None else value)
            self.seed = int(cfg.get("seed", 1234))
            self._rng = random.Random(self.seed)
            sched = cfg.get("schedule") or []
            if isinstance(sched, str):
                self.schedule = ChaosSchedule.load(sched)
            else:
                self.schedule = ChaosSchedule(sched)
            self._prob = {
                "drop": float(cfg.get("drop_probability", 0.0)),
                "dup": float(cfg.get("dup_probability", 0.0)),
                "delay": float(cfg.get("delay_probability", 0.0)),
                "corrupt": float(cfg.get("corrupt_probability", 0.0)),
                "slave_kill": float(
                    cfg.get("slave_death_probability", 0.0)),
            }
            self._delay_ms = float(cfg.get("delay_ms", 50.0))
            self._partitions = {}
            self.injected = {}
            self.wire_frames = {}
        return self

    def arm(self, schedule=None, seed=None):
        """Programmatic arming (tests, the smoke): install ``schedule``
        (a :class:`ChaosSchedule`, list of dicts, or JSON text) and
        reset counters without touching the config tree."""
        with self._lock:
            self.armed = True
            if seed is not None:
                self.seed = int(seed)
            self._rng = random.Random(self.seed)
            if schedule is not None:
                if isinstance(schedule, str):
                    schedule = ChaosSchedule.from_json(schedule)
                elif not isinstance(schedule, ChaosSchedule):
                    schedule = ChaosSchedule(schedule)
                self.schedule = schedule
            self._prob = {}
            self._partitions = {}
            self.injected = {}
            self.wire_frames = {}
        return self

    def disarm(self):
        with self._lock:
            self.armed = False
            self.schedule = ChaosSchedule()
            self._prob = {}
            self._partitions = {}

    # -- accounting ---------------------------------------------------------
    def _record(self, action, site, op, role=None, **extra):
        self.injected[action] = self.injected.get(action, 0) + 1
        if trace.enabled():
            args = {"site": site}
            if op:
                args["op"] = op
            args.update(extra)
            trace.instant("chaos", action, args, role=role)
        from veles_tpu_torch import watch
        if watch.enabled():
            # "role" on a bus event is the PUBLISHING process's role
            # (stamped by the bus); the fault's target rides as
            # target_role so a master-injected slave_kill is not
            # misattributed to the master
            watch.publish("chaos", dict(extra, action=action,
                                        site=site, op=op,
                                        target_role=role))

    @property
    def faults_injected(self):
        """Total injections so far (the bench column's source)."""
        return sum(self.injected.values())

    def record_external(self, action, site, role=None):
        """Count a fault injected by machinery outside the controller's
        own hooks (the legacy ``JobClient(death_probability=)`` ctor
        knob) so :attr:`faults_injected` stays the ONE complete ledger
        — a bench line must never read 0 while kills fired inside its
        timed region."""
        with self._lock:
            self._record(action, site, None, role=role)

    def frames(self, site=None, op=None):
        """Frames observed at the wire hooks while armed, filtered by
        site and/or op — the traffic probe (counts traffic, injected
        or clean; 0 when never armed)."""
        with self._lock:
            items = list(self.wire_frames.items())
        total = 0
        for (s, o), n in items:
            if site is not None and s != site:
                continue
            if op is not None and o != op:
                continue
            total += n
        return total

    def snapshot(self):
        with self._lock:
            return {"seed": self.seed,
                    "injected": dict(self.injected),
                    "faults_injected": self.faults_injected,
                    "wire_frames": {"%s:%s" % k: n
                                    for k, n in
                                    self.wire_frames.items()},
                    "schedule": [f.to_dict() for f in self.schedule]}

    # -- wire hook ----------------------------------------------------------
    def wire(self, site, op, peer=None, role=None):
        """Decide the fate of one frame at ``site``.  Returns a
        :class:`WirePlan`; the shared clean plan when nothing fires."""
        if not self.armed:
            return _CLEAN
        with self._lock:
            key = (site, op)
            self.wire_frames[key] = self.wire_frames.get(key, 0) + 1
            now = time.monotonic()
            # live partition window: every matching frame drops
            for (psite, pop), end in list(self._partitions.items()):
                if now >= end:
                    del self._partitions[(psite, pop)]
                    continue
                if psite == site and (pop is None or pop == op):
                    self._record("partition_drop", site, op, role=role)
                    return WirePlan(deliveries=0)
            plan = None
            for fault in self.schedule:
                if fault.site != site or not fault.matches(op) \
                        or fault.action not in WIRE_ACTIONS:
                    continue
                if not fault.should_fire(self._rng):
                    continue
                fault.fired += 1
                if fault.action == "partition":
                    self._partitions[(site, fault.op)] = \
                        now + fault.duration_s
                    self._record("partition", site, op, role=role,
                                 duration_s=fault.duration_s)
                    return WirePlan(deliveries=0)
                plan = plan or WirePlan()
                self._apply_wire_action(plan, fault.action,
                                        fault.delay_ms, fault.count,
                                        site, op, role)
            # background probabilistic faults (never on pings: the
            # liveness channel is faulted via explicit schedule only)
            if self._prob and op != "ping":
                for action in ("drop", "dup", "delay", "corrupt"):
                    if action == "dup" and site == "slave_recv":
                        continue    # no receive-side observable
                    p = self._prob.get(action, 0.0)
                    if p and self._rng.random() < p:
                        plan = plan or WirePlan()
                        self._apply_wire_action(
                            plan, action, self._delay_ms, 1,
                            site, op, role)
            return plan or _CLEAN

    def _apply_wire_action(self, plan, action, delay_ms, count,
                           site, op, role):
        if action == "drop":
            plan.deliveries = 0
        elif action == "dup":
            plan.deliveries += count
        elif action == "delay":
            plan.delay_s += delay_ms / 1e3
        elif action == "corrupt":
            plan.corrupt = True
        self._record(action, site, op, role=role)

    def send_wire(self, site, op, blob, send, role=None):
        """Decide and APPLY one outgoing frame's fate: delay, corrupt
        the bytes, then deliver 0..N copies via ``send(blob)``.  The
        one implementation of the send-side fault sequence — master
        (``master_send``) and slave (``slave_send``) both delegate
        here so a new :class:`WirePlan` field cannot make their fault
        semantics silently diverge.  Callers check :attr:`armed`
        first (the disabled path must stay one attribute test)."""
        plan = self.wire(site, op, role=role)
        if plan.delay_s:
            time.sleep(plan.delay_s)
        if plan.corrupt:
            blob = self.corrupt_bytes(blob)
        for _ in range(plan.deliveries):
            send(blob)

    # -- process hook -------------------------------------------------------
    def process(self, point, role=None):
        """Process-boundary check: returns the fired :class:`Fault`
        (action in :data:`PROCESS_ACTIONS`) or ``None``."""
        if not self.armed:
            return None
        with self._lock:
            for fault in self.schedule:
                if fault.site != point \
                        or fault.action not in PROCESS_ACTIONS:
                    continue
                if not fault.should_fire(self._rng):
                    continue
                fault.fired += 1
                self._record(fault.action, point, None, role=role,
                             duration_s=fault.duration_s)
                return fault
            p = self._prob.get("slave_kill", 0.0)
            if p and point == "slave_job" and self._rng.random() < p:
                fault = Fault(point, "slave_kill", prob=p)
                fault.fired = 1
                self._record("slave_kill", point, None, role=role)
                return fault
        return None

    @staticmethod
    def corrupt_bytes(blob):
        """Deterministically mangle a frame: flip the low bit of every
        16th byte — enough to break the pickle, stable for replay."""
        mangled = bytearray(blob)
        for i in range(0, len(mangled), 16):
            mangled[i] ^= 1
        return bytes(mangled)


#: the process-wide controller every hook consults
controller = ChaosController()


def configure(value=None):
    return controller.configure(value)


def armed():
    return controller.armed
