"""The performance ledger's live part: per-program cost entries and
dispatch clocks.  The port's counterpart of :mod:`veles_tpu.prof.ledger`.

One process-wide :class:`PerfLedger` keeps a :class:`LedgerEntry` per
program the port dispatches as a unit (a serve bucket: one CUDA graph
on the card, the eager forward on the CPU).  Each capture registers a
compile on its entry and each dispatch adds one host wall-clock
turnaround (two ``perf_counter_ns`` reads, always on).

There is no XLA executable to ask for a static cost profile, so
:func:`cost_of` returns the all-zero dict the JAX package documents for
backends that return no cost model: the entries report dispatch clocks
only, ``flops_dispatched`` stays 0 and no MFU is computed
(:func:`peak_flops` returns None).  The offline report
(``entries_from_events``, ``report_text``), ``merge`` and ``python -m
veles_tpu.prof`` are not ported yet (ROADMAP.md, 'Slices still to
port', item 6(c)).
"""

import threading

#: HBM-ledger category a tensor carries when nobody tagged it
DEFAULT_CATEGORY = "other"

#: the attribution buckets the HBM ledger reports, in render order
CATEGORIES = ("params", "dataset", "staging", "kv", DEFAULT_CATEGORY)


def cost_of(compiled=None):
    """Static cost profile of a compiled program: ``{"flops",
    "bytes_accessed", "arg_bytes", "out_bytes", "temp_bytes"}``, every
    key present and zero: a CUDA graph carries no cost model."""
    return {"flops": 0.0, "bytes_accessed": 0.0,
            "arg_bytes": 0, "out_bytes": 0, "temp_bytes": 0}


def span_cost_args(compiled, base, peak_dtype=None):
    """The cost-bearing trace args of a compile point: ``base`` plus
    flops / ``bytes`` / arg/out/temp bytes (and ``peak_flops`` when
    there is a peak).  Returns ``(cost_dict, span_args)``."""
    cost = cost_of(compiled)
    args = dict(base)
    args.update(cost)
    args["bytes"] = args.pop("bytes_accessed")
    peak = peak_flops(dtype=peak_dtype)
    if peak:
        args["peak_flops"] = peak
    return cost, args


def device_kind():
    """The card's name, or ``None`` without one."""
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
    except Exception:
        pass
    return None


def peak_flops(kind=None, dtype=None):
    """The MFU denominator: ``None``.  The JAX package's peak table is
    a TPU's, and the port computes no MFU while its entries carry no
    flops."""
    return None


class LedgerEntry(object):
    """One dispatched program's running account."""

    __slots__ = ("kind", "name", "cost", "compiles", "recompiles",
                 "dispatches", "dispatch_ns", "peak_dtype")

    def __init__(self, kind, name):
        self.kind = kind            # "bucket" | ...
        self.name = name
        self.cost = None            # cost_of() dict after first compile
        self.compiles = 0
        self.recompiles = 0         # compiles of a warmed program
        self.dispatches = 0
        self.dispatch_ns = 0
        #: MFU-denominator dtype ("int8" for quantized programs)
        self.peak_dtype = None

    @property
    def flops(self):
        return self.cost["flops"] if self.cost else 0.0

    @property
    def bytes_accessed(self):
        return self.cost["bytes_accessed"] if self.cost else 0.0

    def achieved_flops(self):
        """Achieved FLOP/s over the recorded dispatches (0 without
        flops or a timed dispatch)."""
        if not self.dispatch_ns or not self.flops:
            return 0.0
        return self.flops * self.dispatches / (self.dispatch_ns / 1e9)

    def mfu(self, peak):
        if self.peak_dtype is not None and peak:
            peak = peak_flops(dtype=self.peak_dtype) or peak
        if not peak:
            return None
        achieved = self.achieved_flops()
        return achieved / peak if achieved else None

    def row(self, peak):
        """JSON-able summary row."""
        mfu = self.mfu(peak)
        row = {
            "kind": self.kind, "name": self.name,
            "flops": self.flops, "bytes": self.bytes_accessed,
            "temp_bytes": (self.cost or {}).get("temp_bytes", 0),
            "compiles": self.compiles, "recompiles": self.recompiles,
            "dispatches": self.dispatches,
            "wall_ms": round(self.dispatch_ns / 1e6, 3),
            "achieved_flops": round(self.achieved_flops(), 1),
            "mfu": round(mfu, 6) if mfu is not None else None,
        }
        if self.peak_dtype:
            row["peak_dtype"] = self.peak_dtype
        return row


class PerfLedger(object):
    """Process-wide registry of :class:`LedgerEntry` objects and the
    running totals (``compile_events``, ``recompiles``,
    ``flops_dispatched``) a reader takes deltas of."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}
        self.compile_events = 0
        self.recompiles = 0
        self.flops_dispatched = 0.0

    def entry(self, kind, name):
        key = (kind, name)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = LedgerEntry(kind, name)
        return entry

    def entries(self, kind=None):
        with self._lock:
            items = list(self._entries.values())
        if kind is not None:
            items = [e for e in items if e.kind == kind]
        return items

    def record_compile(self, entry, compiled=None, cost=None,
                       steady=False):
        """Register a compile (a capture) on ``entry``; ``steady`` marks
        one of a warmed program, a steady-state recompile."""
        if cost is None and compiled is not None:
            cost = cost_of(compiled)
        with self._lock:
            entry.cost = cost or entry.cost
            entry.compiles += 1
            self.compile_events += 1
            if steady:
                entry.recompiles += 1
                self.recompiles += 1
        return steady

    def record_dispatch(self, entry, dur_ns):
        """One turnaround on ``entry``: integer adds, no lock."""
        entry.dispatches += 1
        entry.dispatch_ns += int(dur_ns)
        self.flops_dispatched += entry.flops

    def summary(self):
        """The JSON-able digest: entries, totals and the HBM ledger."""
        from veles_tpu_torch.memory import Watcher
        kind = device_kind()
        peak = peak_flops(kind)
        rows = [entry.row(peak) for entry in self.entries()]
        rows.sort(key=lambda r: (r["kind"], -r["wall_ms"], r["name"]))
        dispatch_ns = sum(e.dispatch_ns for e in self.entries())
        achieved = (self.flops_dispatched / (dispatch_ns / 1e9)
                    if dispatch_ns else 0.0)
        return {
            "device_kind": kind,
            "peak_flops": peak,
            "entries": rows,
            "totals": {
                "compiles": self.compile_events,
                "recompiles": self.recompiles,
                "flops_dispatched": self.flops_dispatched,
                "dispatch_ms": round(dispatch_ns / 1e6, 3),
                "achieved_flops": round(achieved, 1),
                "mfu": (round(achieved / peak, 6)
                        if peak and achieved else None),
            },
            "hbm": Watcher.hbm_ledger(),
        }

    def reset(self):
        with self._lock:
            self._entries = {}
            self.compile_events = 0
            self.recompiles = 0
            self.flops_dispatched = 0.0


#: THE process-wide ledger every compile point and reporter shares
ledger = PerfLedger()
