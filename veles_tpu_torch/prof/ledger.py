"""The performance ledger: per-program cost entries and dispatch clocks.
The port's counterpart of :mod:`veles_tpu.prof.ledger`.

One process-wide :class:`PerfLedger` keeps a :class:`LedgerEntry` per
program the port dispatches as a unit: a stitched segment and an
epoch-scan window (one CUDA graph each on the card), a serve bucket,
and the generative engine's prefill, chunk, decode and verify steps.
Each compile point (a capture; on the CPU, and for the eager generative
steps, the first run) registers the program's cost and each dispatch
adds its time (always on), so the ledger states achieved FLOP/s per
program and, on a card of the peak table
(:data:`veles_tpu_torch.backends.PEAK_FLOPS`), MFU.  On the CPU there is no peak: entries report flops, bytes and
wall time, and MFU is None.

The cost model is the port's own (there is no XLA cost analysis): every
kernel wrapper adds its call's flops and bytes to the tally of
:mod:`veles_tpu_torch.ops.cost`, and a program's cost is the tally of
its body.  A CUDA graph's Python runs once, at capture, so the capture
records the cost and each replay dispatches it again; a recapture
replaces the cost, it does not add to it.  An eager step's tally is its
cost (``record_dispatch(..., cost=)``).  An entry covering K steps a
dispatch (an epoch-scan window) holds one step's cost and dispatches K
(``steps``), as the JAX package's window entries do.

A dispatch's time is the device's on the card: a graph replay returns
before its kernels ran, so :class:`DispatchTimer` brackets the work
with two CUDA events on the current stream (the start recorded again
right before a replay, so a capture's host seconds stay out), and the
entry reads their elapsed time when it is read (``summary``, ``row``).
On the CPU, and where the caller synchronizes anyway (a serve bucket),
it is the host clock.

Each entry is judged against the rate of the type it computes
(``peak_dtype``): the MNIST kernels compute f32 on the FMA units
(67 TFLOP/s), the serving kernels bf16 on the tensor cores (989); a
quantized generative program's ``"int8"`` maps to the bf16 rate (see
:data:`veles_tpu_torch.backends.PEAK_DTYPES`).  Every MFU the port
prints stands beside the card's name and power limit
(:func:`card_label`).

The offline half (:func:`entries_from_events`, :func:`report_text`,
:func:`report_from_events`) rebuilds the rows from an exported trace:
compile instants carry the cost in their args, dispatch spans the wall
time.
"""

import functools
import threading
import time

from veles_tpu_torch import backends

#: HBM-ledger category a tensor carries when nobody tagged it
DEFAULT_CATEGORY = "other"

#: the attribution buckets the HBM ledger reports, in render order
CATEGORIES = ("params", "dataset", "staging", "kv", DEFAULT_CATEGORY)


def cost_of(tally=None):
    """A program's cost dict: ``{"flops", "bytes_accessed",
    "arg_bytes", "out_bytes", "temp_bytes"}``, every key present, from
    an :class:`veles_tpu_torch.ops.cost.Tally` of its body (all zero
    without one)."""
    if tally is not None:
        return tally.cost()
    return {"flops": 0.0, "bytes_accessed": 0.0,
            "arg_bytes": 0, "out_bytes": 0, "temp_bytes": 0}


def span_cost_args(cost, base, peak_dtype=None):
    """The ONE schema of cost-bearing trace args at a compile point
    (segment ``compile`` instants, serve ``compile_bucket`` instants):
    ``base`` plus flops / ``bytes`` / arg, out and temp bytes, the
    entry's ``peak_dtype`` and ``peak_flops`` when there is a peak.
    :func:`entries_from_events` parses these keys.  ``cost`` is a cost
    dict (None: zeros).  Returns ``(cost_dict, span_args)``."""
    cost = dict(cost or cost_of())
    args = dict(base)
    args.update(cost)
    args["bytes"] = args.pop("bytes_accessed")
    if peak_dtype:
        args["peak_dtype"] = peak_dtype
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


@functools.lru_cache(maxsize=1)
def card_label():
    """``"<name>, <power limit>"`` from ``nvidia-smi`` (read once a
    process), or None without a card."""
    if device_kind() is None:
        return None
    return backends.card_label()


def peak_flops(kind=None, dtype=None):
    """The MFU denominator: the card's dense peak for ``dtype`` (a
    ``peak_dtype`` name; None is bf16), from
    :func:`veles_tpu_torch.backends.peak_ops`.  A CPU or a card outside
    the table returns ``None``, and entries then report flops and bytes
    without an MFU."""
    if kind is None:
        kind = device_kind()
    if not kind:
        return None
    return backends.peak_ops(kind, dtype)


class DispatchTimer(object):
    """The time of one dispatch on ``device``: a pair of CUDA events on
    the current stream on the card (read when the entry is read), the
    host clock on the CPU.  ``with timer:`` brackets the work;
    :meth:`restart` records the start again (right before a replay, so
    a capture inside the bracket is not timed)."""

    __slots__ = ("_events", "_tic", "ns")

    def __init__(self, device):
        import torch
        self._events = None
        if torch.device(device).type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        self._tic = 0
        #: the host nanoseconds (CPU), or None until the events are read
        self.ns = None

    def restart(self):
        if self._events is not None:
            self._events[0].record()
        else:
            self._tic = time.perf_counter_ns()

    def __enter__(self):
        self.restart()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        else:
            self.ns = time.perf_counter_ns() - self._tic
        return False

    def done(self):
        return self._events is None or self._events[1].query()

    def read(self):
        """The dispatch's nanoseconds (waits for the card's events)."""
        if self.ns is None:
            start, end = self._events
            end.synchronize()
            self.ns = int(start.elapsed_time(end) * 1e6)
        return self.ns


class LedgerEntry(object):
    """One program's running cost account."""

    __slots__ = ("kind", "name", "device", "cost", "compiles",
                 "recompiles", "dispatches", "_dispatch_ns",
                 "flops_dispatched", "items", "steps", "peak_dtype",
                 "shards", "collective_bytes", "_pending", "_lock")

    def __init__(self, kind, name, device=None):
        self.kind = kind            # "segment" | "bucket" | "prefill"
        self.name = name            # | "decode"
        #: where the program runs ("cuda", "cpu"; None: not said): a
        #: program on the CPU has no MFU, even in a process with a card
        self.device = device
        self.cost = None            # one dispatch's (one step's) cost
        self.compiles = 0
        self.recompiles = 0         # compiles of a warmed program
        self.dispatches = 0
        self._dispatch_ns = 0
        #: timers of dispatches whose device time is not read yet (the
        #: dispatching thread appends, a reader folds them in)
        self._pending = []
        self._lock = threading.Lock()
        #: the flops the recorded dispatches ran: each dispatch's cost
        #: (an eager step's own tally) times the steps it covered
        self.flops_dispatched = 0.0
        #: useful work units served (generative entries: tokens)
        self.items = 0
        #: steps folded into the recorded dispatches (an epoch-scan
        #: window covers K); 0 = each dispatch is one step
        self.steps = 0
        #: MFU-denominator type (None: the session's bf16 rate)
        self.peak_dtype = None
        #: ranks running this program in lockstep (1: one device; a pod
        #: sets it at install and at a reshard)
        self.shards = 1
        #: the collective payload bytes of the recorded dispatches (a
        #: pod segment's, as its stages counted them)
        self.collective_bytes = 0

    @property
    def dispatch_ns(self):
        """Nanoseconds of the recorded dispatches (their device time on
        the card, read here)."""
        if self._pending:
            with self._lock:
                pending, self._pending = self._pending, []
            ns = sum(timer.read() for timer in pending)
            with self._lock:
                self._dispatch_ns += ns
        return self._dispatch_ns

    def add_time(self, timer):
        """One dispatch's time: nanoseconds, or a :class:`DispatchTimer`
        (kept until read; the ones done are folded in as they pile
        up)."""
        with self._lock:
            if not isinstance(timer, DispatchTimer):
                self._dispatch_ns += int(timer)
            elif timer.ns is not None:
                self._dispatch_ns += timer.ns
            else:
                self._pending.append(timer)
                if len(self._pending) >= 64:
                    done = [t for t in self._pending if t.done()]
                    self._pending = [t for t in self._pending
                                     if t not in done]
                    self._dispatch_ns += sum(t.read() for t in done)

    @property
    def flops(self):
        return self.cost["flops"] if self.cost else 0.0

    @property
    def bytes_accessed(self):
        return self.cost["bytes_accessed"] if self.cost else 0.0

    def achieved_flops(self):
        """Achieved FLOP/s over the recorded dispatches (0 without
        flops or a timed dispatch)."""
        if not self.dispatch_ns or not self.flops_dispatched:
            return 0.0
        return self.flops_dispatched / (self.dispatch_ns / 1e9)

    def peak_for(self, peak, kind=None):
        """The rate this entry is judged against: its type's on
        ``kind`` (the attached card by default), else ``peak``; None for
        a program on the CPU."""
        if self.device == "cpu":
            return None
        if self.peak_dtype is not None and peak:
            return peak_flops(kind, dtype=self.peak_dtype) or peak
        return peak

    def mfu(self, peak, kind=None):
        peak = self.peak_for(peak, kind)
        if not peak:
            return None
        achieved = self.achieved_flops()
        return achieved / peak if achieved else None

    def items_per_s(self):
        """Items (tokens) per second of dispatch wall."""
        if not self.dispatch_ns or not self.items:
            return 0.0
        return self.items / (self.dispatch_ns / 1e9)

    def flops_per_item(self):
        """Dispatched flops per accounted item: a decode step pays for
        every slot, so this falls as the batch fills."""
        if not self.items:
            return 0.0
        return self.flops_dispatched / self.items

    def row(self, peak, kind=None):
        """JSON-able summary row (the ``perf_report()`` line)."""
        mfu = self.mfu(peak, kind)
        row = {
            "kind": self.kind, "name": self.name,
            "flops": self.flops, "bytes": self.bytes_accessed,
            "temp_bytes": (self.cost or {}).get("temp_bytes", 0),
            "compiles": self.compiles, "recompiles": self.recompiles,
            "dispatches": self.dispatches,
            "wall_ms": round(self.dispatch_ns / 1e6, 3),
            "flops_dispatched": self.flops_dispatched,
            "achieved_flops": round(self.achieved_flops(), 1),
            "mfu": round(mfu, 6) if mfu is not None else None,
        }
        if self.peak_dtype:
            row["peak_dtype"] = self.peak_dtype
        if self.device:
            row["device"] = self.device
        if self.items:
            row["items"] = self.items
            row["items_per_s"] = round(self.items_per_s(), 1)
            row["flops_per_item"] = round(self.flops_per_item(), 1)
        if self.steps:
            row["steps"] = self.steps
            row["steps_per_dispatch"] = round(
                self.steps / self.dispatches, 2) if self.dispatches else 0
        if self.shards > 1 or self.collective_bytes:
            row["shards"] = self.shards
            row["collective_bytes"] = self.collective_bytes
            row["collective_bytes_per_dispatch"] = round(
                self.collective_bytes / self.dispatches, 1) \
                if self.dispatches else 0
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

    def entry(self, kind, name, device=None):
        """The entry of program ``name`` of ``kind`` on ``device`` (a
        program of one name on the card and on the CPU keeps two)."""
        key = (kind, name, device)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = LedgerEntry(kind, name,
                                                         device)
        return entry

    def entries(self, kind=None):
        with self._lock:
            items = list(self._entries.values())
        if kind is not None:
            items = [e for e in items if e.kind == kind]
        return items

    # -- recording ----------------------------------------------------------
    def record_compile(self, entry, cost=None, steady=False):
        """Register a compile (a capture, or an eager program's first
        run) on ``entry`` with its ``cost``, which replaces the last
        one; ``steady`` marks a compile of a warmed program, a
        steady-state recompile."""
        with self._lock:
            entry.cost = cost or entry.cost
            entry.compiles += 1
            self.compile_events += 1
            if steady:
                entry.recompiles += 1
                self.recompiles += 1
        return steady

    def record_dispatch(self, entry, dur, items=0, steps=0, cost=None,
                        collective_bytes=0):
        """One dispatch on ``entry``: integer adds (one dispatching
        thread an entry; its time goes in under the entry's lock).  ``dur``: nanoseconds or a
        :class:`DispatchTimer`; ``items``: work units this dispatch
        served (tokens); ``steps``: steps this one dispatch covered (a
        window's K; the entry's per-step flops scale by it); ``cost``:
        this dispatch's own cost (an eager step's tally), which becomes
        the entry's; ``collective_bytes``: the payload bytes of the
        dispatch's collectives (a pod segment's)."""
        if cost is not None:
            entry.cost = cost
        if collective_bytes:
            entry.collective_bytes += int(collective_bytes)
        entry.dispatches += 1
        entry.add_time(dur)
        if items:
            entry.items += int(items)
        if steps:
            entry.steps += int(steps)
        flops = entry.flops * (steps if steps else 1)
        if flops:
            entry.flops_dispatched += flops
            self.flops_dispatched += flops

    # -- reading ------------------------------------------------------------
    def summary(self):
        """The JSON-able digest ``perf_report()`` renders.  The total
        MFU is the time the card would need at each card entry's own
        peak for the flops dispatched, over those entries' dispatch time
        (with one peak for every entry, the JAX package's
        aggregate)."""
        from veles_tpu_torch.memory import Watcher
        kind = device_kind()
        peak = peak_flops(kind)
        entries = self.entries()
        rows = [entry.row(peak, kind) for entry in entries]
        rows.sort(key=lambda r: (r["kind"], -r["wall_ms"], r["name"]))
        dispatch_ns = sum(e.dispatch_ns for e in entries)
        seconds = dispatch_ns / 1e9
        achieved = self.flops_dispatched / seconds if seconds else 0.0
        judged = [e for e in entries if e.peak_for(peak, kind)]
        card_seconds = sum(e.dispatch_ns for e in judged) / 1e9
        peak_seconds = sum(e.flops_dispatched / e.peak_for(peak, kind)
                           for e in judged)
        mfu = peak_seconds / card_seconds if card_seconds else None
        return {
            "device_kind": kind,
            "card": card_label(),
            "peak_flops": peak,
            "entries": rows,
            "totals": {
                "compiles": self.compile_events,
                "recompiles": self.recompiles,
                "flops_dispatched": self.flops_dispatched,
                "dispatch_ms": round(dispatch_ns / 1e6, 3),
                "achieved_flops": round(achieved, 1),
                "mfu": round(mfu, 6) if mfu else None,
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


# -- offline reconstruction -------------------------------------------------

def entries_from_events(events):
    """Rebuild ledger-like rows from exported (normalized) trace events:
    compile instants carry the cost in their args (``flops``,
    ``bytes``, ``peak_flops``), dispatch spans carry the wall time and
    a window's ``steps``, so ``python -m veles_tpu_torch.prof
    trace.json`` reports per-program MFU with no live process.  Each
    row is judged against the peak its compile instant carried.
    Returns ``(rows, peak_flops)``, the peak the last compile named."""
    costs = {}          # (kind, name) -> compile args
    clocks = {}         # (kind, name) -> (dispatches, dur_us, steps)
    compiles = {}
    recompiles = {}     # steadiness is in-band (the "recompile" arg)
    compile_ts = {}     # (kind, name) -> [instant timestamps]

    def _segment_key(args):
        return ("segment", args.get("segment", "?"))

    def _bucket_key(args):
        return ("bucket", "%s[b%s]" % (args.get("engine", "bucket"),
                                       args["bucket"]))

    # pass 1: the compile events (a separate pass: the clock pass
    # excludes a dispatch span that contains a compile, and a
    # time-sorted input can put a span before the instant it contains)
    peak = None
    for ev in events:
        args = ev.get("args") or {}
        if ev["cat"] == "segment" and ev["name"] == "compile":
            key = _segment_key(args)
            compile_ts.setdefault(key, []).append(ev["ts_us"])
        elif ev["cat"] == "serve" and ev["name"] == "compile_bucket" \
                and "bucket" in args:
            key = _bucket_key(args)
        else:
            continue
        compiles[key] = compiles.get(key, 0) + 1
        if args.get("recompile"):
            recompiles[key] = recompiles.get(key, 0) + 1
        if "flops" in args:
            costs[key] = args
        if args.get("peak_flops"):
            peak = args["peak_flops"]
    # pass 2: the dispatch clocks
    for ev in events:
        if ev["ph"] != "X":
            continue
        args = ev.get("args") or {}
        if ev["cat"] == "segment" and ev["name"] == "dispatch":
            key = _segment_key(args)
            # a dispatch containing its compile is the warmup turnaround
            lo, hi = ev["ts_us"], ev["ts_us"] + ev["dur_us"]
            if any(lo <= ts <= hi for ts in compile_ts.get(key, ())):
                continue
        elif ev["cat"] == "serve" and ev["name"] == "infer_chunk" \
                and "bucket" in args:
            key = _bucket_key(args)
        else:
            continue
        n, dur, steps = clocks.get(key, (0, 0.0, 0))
        clocks[key] = (n + 1, dur + ev["dur_us"],
                       steps + int(args.get("steps", 0) or 0))
    rows = []
    for key in sorted(set(costs) | set(clocks) | set(compiles)):
        kind, name = key
        args = costs.get(key, {})
        n, dur_us, steps = clocks.get(key, (0, 0.0, 0))
        flops = float(args.get("flops", 0.0) or 0.0)
        # a window's compile cost is one step's: scale by the steps
        dispatched = flops * (steps if steps else n)
        achieved = dispatched / (dur_us / 1e6) if dur_us and flops else 0.0
        row_peak = args.get("peak_flops") or peak
        row = {
            "kind": kind, "name": name, "flops": flops,
            "bytes": float(args.get("bytes", 0.0) or 0.0),
            "temp_bytes": int(args.get("temp_bytes", 0) or 0),
            "compiles": compiles.get(key, 0),
            "recompiles": recompiles.get(key, 0),
            "dispatches": n, "wall_ms": round(dur_us / 1e3, 3),
            "flops_dispatched": dispatched,
            "achieved_flops": round(achieved, 1),
            "mfu": (round(achieved / row_peak, 6)
                    if row_peak and achieved else None),
        }
        if args.get("peak_dtype"):
            row["peak_dtype"] = args["peak_dtype"]
        if steps:
            row["steps"] = steps
            row["steps_per_dispatch"] = round(steps / n, 2) if n else 0
        rows.append(row)
    return rows, peak


# -- rendering --------------------------------------------------------------

def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return ("%.1f %s" if unit != "B" else "%d %s") % (n, unit)
        n /= 1024.0


def _fmt_mfu(mfu):
    return "%8.4f%%" % (100.0 * mfu) if mfu is not None else "        -"


def render_rows(rows, peak, kind=None):
    lines = []
    for row in rows:
        if kind is not None and row["kind"] != kind:
            continue
        lines.append(
            "  %-36s %10.3e fl %9.3e B  %4dx %9.3f ms %10.1f MFLOP/s"
            " %s%s%s%s"
            % (row["name"][:36], row["flops"], row["bytes"],
               row["dispatches"], row["wall_ms"],
               row["achieved_flops"] / 1e6, _fmt_mfu(row["mfu"]),
               " (%s)" % "; ".join(
                   str(row[k]) for k in ("peak_dtype", "device")
                   if row.get(k)) if row.get("peak_dtype")
               or row.get("device") else "",
               ("  [%s steps/dispatch]" % row["steps_per_dispatch"])
               if row.get("steps") else "",
               ("  [%d recompile(s)]" % row["recompiles"])
               if row["recompiles"] else ""))
    return lines


def report_text(summary_dict=None):
    """The human ``perf_report()``: per-segment, per-window, per-bucket
    and per-generative-program cost rows, compile and recompile totals,
    and the HBM ledger."""
    digest = summary_dict if summary_dict is not None \
        else ledger.summary()
    peak = digest.get("peak_flops")
    kind = digest.get("device_kind")
    head = "veles_tpu_torch.prof performance ledger — device %s" % (
        digest.get("card") or kind or "<none>")
    head += (" (peak %.1f TFLOP/s bf16; each row against its type's rate)"
             % (peak / 1e12) if peak
             else " (no peak table entry: flops/bytes only, no MFU)")
    lines = [head]
    rows = digest.get("entries", [])
    segments = [r for r in rows if r["kind"] == "segment"]
    buckets = [r for r in rows if r["kind"] == "bucket"]
    if segments:
        lines.append("")
        lines.append("stitched segments and windows (per step):")
        lines.extend(render_rows(segments, peak))
        pod_rows = [r for r in segments if r.get("shards", 1) > 1
                    or r.get("collective_bytes")]
        if pod_rows:
            # the pod line: the programs running over N ranks, with
            # the payload of their collectives beside the clocks
            shards = max(r.get("shards", 1) for r in pod_rows)
            moved = sum(r.get("collective_bytes", 0) for r in pod_rows)
            dispatches = sum(r["dispatches"] for r in pod_rows) or 1
            lines.append(
                "  pod: %d shard(s) in lockstep, %s of collectives "
                "(%s/dispatch)" % (shards, _fmt_bytes(moved),
                                   _fmt_bytes(moved / dispatches)))
    if buckets:
        lines.append("")
        lines.append("serve buckets (per call):")
        lines.extend(render_rows(buckets, peak))
    gen_rows = [r for r in rows if r["kind"] in ("prefill", "decode")]
    if gen_rows:
        lines.append("")
        lines.append("generative programs (per step):")
        lines.extend(render_rows(gen_rows, peak))
        for row in gen_rows:
            if row.get("items"):
                lines.append(
                    "    %-34s %8d tok %10.1f tok/s %12.3e FLOPs/tok"
                    % (row["name"][:34], row["items"],
                       row["items_per_s"], row["flops_per_item"]))
    if not rows:
        lines.append("")
        lines.append("  (no programs registered — run a stitched "
                     "workflow or warm a serve engine first)")
    totals = digest.get("totals", {})
    lines.append("")
    lines.append(
        "compiles: %d total, %d steady-state recompile(s)%s" % (
            totals.get("compiles", 0), totals.get("recompiles", 0),
            "" if not totals.get("recompiles")
            else "  <-- investigate: steady state must not recapture"))
    if totals.get("flops_dispatched"):
        lines.append("aggregate: %.3e FLOPs dispatched over %.3f ms%s"
                     % (totals["flops_dispatched"],
                        totals.get("dispatch_ms", 0.0),
                        " -> MFU %.4f%%" % (100.0 * totals["mfu"])
                        if totals.get("mfu") is not None else ""))
    hbm = digest.get("hbm")
    if hbm:
        lines.append("")
        lines.append("HBM ledger: %s in use, %s peak" % (
            _fmt_bytes(hbm["bytes_in_use"]),
            _fmt_bytes(hbm["peak_bytes"])))
        for cat in CATEGORIES:
            info = hbm["by_category"].get(cat)
            if info and (info["bytes"] or info["peak"]):
                lines.append("  %-8s %12s in use  %12s peak"
                             % (cat, _fmt_bytes(info["bytes"]),
                                _fmt_bytes(info["peak"])))
        for vec in hbm.get("top_vectors", ()):
            lines.append("    %-10s %-22s %s"
                         % (vec["category"],
                            "%s %s" % (vec["shape"], vec["dtype"]),
                            _fmt_bytes(vec["nbytes"])))
    return "\n".join(lines) + "\n"


def report_from_events(events):
    """Offline ``report_text`` over exported trace events (the
    ``python -m veles_tpu_torch.prof trace.json`` path)."""
    rows, peak = entries_from_events(events)
    return report_text({
        "device_kind": None if peak is None else "(from trace)",
        "peak_flops": peak,
        "entries": rows,
        "totals": {"compiles": sum(r["compiles"] for r in rows),
                   "recompiles": sum(r["recompiles"] for r in rows),
                   "flops_dispatched": sum(r["flops_dispatched"]
                                           for r in rows),
                   "dispatch_ms": round(sum(r["wall_ms"] for r in rows),
                                        3)},
        "hbm": None,
    })
