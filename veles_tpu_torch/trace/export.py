"""Exporters and summarizers for the trace ring.

The port's counterpart of :mod:`veles_tpu.trace.export`.  Three
consumers, one normalized event shape:

* **Chrome trace-event JSON** (:func:`save` / :func:`chrome_events`) —
  loadable by Perfetto (https://ui.perfetto.dev) and
  ``chrome://tracing``.  One *pid per role* (trainer / server / master
  / slave-<sid>) with ``process_name`` metadata, tids are the real
  Python thread idents, so a mixed-role process (a test running master
  and slave in one interpreter) still separates into lanes.
* **Text report** (:func:`report_text`, surfaced as ``python -m
  veles_tpu_torch.trace``) —
  per-category totals, top-K spans by total time, and the segment
  dispatch vs host-gap split (how much of the wall clock between the
  first and last stitched dispatch the host spent NOT dispatching).
* **Compact summary dict** (:func:`summary`) — the digest a tool reads,
  and the counter lines appended to the serve ``/metrics`` page
  (:func:`metrics_text`).

Normalized event: ``{"ph", "cat", "name", "ts_us", "dur_us", "tid",
"role", "args"}`` — built either from the live recorder's tuples
(:func:`normalize`, :func:`veles_tpu_torch.trace.core.normalize`) or
re-read from an exported file, so a report computed from the ring and
one computed from the JSON it wrote agree by construction.
"""

import json

from veles_tpu_torch.trace.core import normalize, recorder

#: pid assignment order: well-known roles first, then discovery order
#: (slave-<sid> pids are stable within one export)
_ROLE_PRIORITY = ("trainer", "server", "master")


def _role_pids(events):
    roles = []
    for ev in events:
        role = ev.get("role") or "trainer"
        if role not in roles:
            roles.append(role)
    roles.sort(key=lambda r: (_ROLE_PRIORITY.index(r)
                              if r in _ROLE_PRIORITY
                              else len(_ROLE_PRIORITY), r))
    return {role: pid for pid, role in enumerate(roles, start=1)}


def chrome_events(events=None):
    """Normalized events → the Chrome ``traceEvents`` list (metadata
    ``process_name`` records included).  Spans tagged with a
    distributed-trace identity (an ``args["trace"]`` id from
    :mod:`veles_tpu_torch.obs.context`) additionally emit **flow events**
    (``ph: s/t``, one flow per trace id) so Perfetto draws the
    request's waterfall arrows ACROSS role lanes — the cross-process
    stitch a ``prof merge`` timeline renders per request."""
    events = normalize() if events is None else events
    pids = _role_pids(events)
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": role}} for role, pid in pids.items()]
    for ev in events:
        pid = pids.get(ev.get("role") or "trainer", 1)
        rec = {"ph": ev["ph"], "cat": ev["cat"], "name": ev["name"],
               "ts": ev["ts_us"], "pid": pid, "tid": ev["tid"]}
        if ev["ph"] == "X":
            rec["dur"] = ev["dur_us"]
        elif ev["ph"] == "i":
            rec["s"] = "t"
        if ev.get("args"):
            rec["args"] = dict(ev["args"])
        out.append(rec)
    # flow derivation runs over a TIMESTAMP-sorted view: the ring
    # holds spans in completion order (a request's enclosing span
    # lands last with the earliest begin), and flow steps must walk
    # forward in time or the waterfall arrows render backwards
    flows = {}   # trace id -> steps emitted so far
    tagged = sorted(
        (ev for ev in events
         if ev["ph"] == "X" and (ev.get("args") or {}).get("trace")),
        key=lambda ev: ev["ts_us"])
    for ev in tagged:
        trace_id = ev["args"]["trace"]
        seen = flows.setdefault(trace_id, [0])
        # flow start on the trace's earliest tagged span, steps on
        # every later one; binding is by enclosing slice, so each
        # flow event lands just inside its span's interval
        out.append({
            "ph": "s" if seen[0] == 0 else "t",
            "cat": "obs", "name": "request", "id": trace_id,
            "pid": pids.get(ev.get("role") or "trainer", 1),
            "tid": ev["tid"], "ts": ev["ts_us"],
        })
        seen[0] += 1
    return out


def save(path=None, events=None):
    """Write the Chrome trace-event JSON; returns the path written.

    ``path`` defaults to the one armed by ``root.common.engine.trace=
    <path.json>``; raises ``ValueError`` when neither is set."""
    path = path or recorder.path
    if not path:
        raise ValueError(
            "no trace path: pass one or set root.common.engine.trace "
            "to a .json path")
    payload = {
        "displayTimeUnit": "ms",
        "traceEvents": chrome_events(events),
        "metadata": {
            "producer": "veles_tpu_torch.trace",
            "recorded": recorder.recorded,
            "dropped": recorder.dropped,
        },
    }
    with open(path, "w") as fout:
        json.dump(payload, fout)
    return path


def save_at_exit():
    """The atexit hook armed by ``trace=<path.json>`` — best-effort,
    never raises during interpreter shutdown."""
    try:
        if recorder.path and recorder.recorded:
            save(recorder.path)
    except Exception:  # pragma: no cover - shutdown path
        pass


def load(path):
    """Read an exported file back into normalized events (metadata
    records become role names again, so a report over the file matches
    the report over the ring that wrote it)."""
    with open(path, "r") as fin:
        payload = json.load(fin)
    # both standard shapes: the object form this module writes and the
    # bare-array variant other Chrome-trace producers emit
    raw = payload if isinstance(payload, list) \
        else payload.get("traceEvents", [])
    role_of = {}
    for ev in raw:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            role_of[ev.get("pid")] = ev.get("args", {}).get("name")
    out = []
    for ev in raw:
        if ev.get("ph") in ("M", "s", "t", "f"):
            # metadata and flow events are derived decoration:
            # chrome_events regenerates flows from the spans' trace
            # args on every export, so a load→report→save roundtrip
            # stays equal to the ring that wrote it
            continue
        out.append({
            "ph": ev.get("ph"), "cat": ev.get("cat", ""),
            "name": ev.get("name", ""), "ts_us": float(ev.get("ts", 0)),
            "dur_us": float(ev.get("dur", 0)),
            "tid": ev.get("tid", 0),
            "role": role_of.get(ev.get("pid"), "trainer"),
            "args": ev.get("args"),
        })
    return out


# -- summarization ----------------------------------------------------------

def _union_busy_us(events):
    """Per-category busy time as the per-thread UNION of span
    intervals: nested or overlapping same-category spans on one
    thread (a serve ``request`` enclosing its ``batch_infer``, a
    loader ``serve_minibatch`` enclosing ``sync_fill``) count once —
    a category can never report more busy time than wall time per
    thread.  Distinct threads still sum (real parallelism is real
    busy time)."""
    per = {}
    for ev in events:
        if ev["ph"] == "X":
            per.setdefault((ev["cat"], ev["tid"]), []).append(
                (ev["ts_us"], ev["ts_us"] + ev["dur_us"]))
    out = {}
    for (cat, _tid), intervals in per.items():
        intervals.sort()
        total = 0.0
        cur_lo = cur_hi = None
        for lo, hi in intervals:
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    total += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            elif hi > cur_hi:
                cur_hi = hi
        if cur_hi is not None:
            total += cur_hi - cur_lo
        out[cat] = out.get(cat, 0.0) + total
    return out


def summary(events=None, top=10):
    """Compact JSON-able digest: per-category totals (``busy_ms`` is
    the per-thread interval union — nested spans count once), top
    spans by total time, last counter values, and the segment
    dispatch vs host-gap split."""
    events = normalize() if events is None else events
    categories = {}
    spans = {}
    counters = {}
    for ev in events:
        cat = categories.setdefault(
            ev["cat"], {"events": 0, "spans": 0, "busy_ms": 0.0})
        cat["events"] += 1
        if ev["ph"] == "X":
            cat["spans"] += 1
            key = (ev["cat"], ev["name"])
            agg = spans.setdefault(key, [0, 0.0])
            agg[0] += 1
            agg[1] += ev["dur_us"] / 1e3
        elif ev["ph"] == "C" and ev.get("args"):
            counters[ev["name"]] = ev["args"].get("value")
    busy = _union_busy_us(events)
    for name, cat in categories.items():
        cat["busy_ms"] = round(busy.get(name, 0.0) / 1e3, 3)
    top_spans = sorted(
        ({"cat": c, "name": n, "count": k, "total_ms": round(ms, 3)}
         for (c, n), (k, ms) in spans.items()),
        key=lambda item: -item["total_ms"])[:top]
    return {
        "events": len(events),
        "categories": categories,
        "top_spans": top_spans,
        "counters": counters,
        "segment": _dispatch_gap(events),
    }


def _dispatch_gap(events):
    """Dispatch vs host-gap time over the stitched-segment lane: per
    dispatching thread, wall = last span end − first span begin and
    busy = Σ durations; the gap is the host time BETWEEN segment
    turnarounds (scheduling, barrier units, deferred-metric flushes) —
    the number later perf PRs drive toward zero.  Host work INSIDE a
    turnaround (loader preludes, per-call scalar fetches) is not gap:
    it rides the dispatch span and is broken out as the nested
    ``segment:host_prep`` spans in the leaderboard."""
    per_tid = {}
    for ev in events:
        if ev["ph"] != "X" or ev["cat"] != "segment" \
                or ev["name"] != "dispatch":
            continue
        lo, hi, busy, n, steps = per_tid.get(
            ev["tid"], (float("inf"), 0.0, 0.0, 0, 0))
        # an epoch-scan window is ONE dispatch covering K steps (the
        # span's `steps` arg); per-step dispatches count as one each
        k = int((ev.get("args") or {}).get("steps", 1) or 1)
        per_tid[ev["tid"]] = (min(lo, ev["ts_us"]),
                              max(hi, ev["ts_us"] + ev["dur_us"]),
                              busy + ev["dur_us"], n + 1, steps + k)
    dispatches = sum(n for *_rest, n, _s in per_tid.values())
    steps = sum(s for *_rest, s in per_tid.values())
    busy_ms = sum(busy for _lo, _hi, busy, _n, _s
                  in per_tid.values()) / 1e3
    wall_ms = sum(hi - lo for lo, hi, _busy, _n, _s
                  in per_tid.values()) / 1e3
    return {
        "dispatches": dispatches,
        "steps": steps,
        "dispatch_ms": round(busy_ms, 3),
        "wall_ms": round(wall_ms, 3),
        "host_gap_ms": round(max(0.0, wall_ms - busy_ms), 3),
    }


def report_text(events=None, top=10):
    """The human summary (the CLI's)."""
    live = events is None
    events = normalize() if events is None else events
    digest = summary(events, top=top)
    lines = ["veles_tpu_torch.trace report — %d event(s)"
             % digest["events"]]
    if live and recorder.dropped:
        # live-recorder reports disclose wraparound; file reports
        # carry the producer's counts in their metadata instead
        lines[0] += " (ring dropped %d older)" % recorder.dropped
    lines.append("")
    lines.append("per-category totals:")
    for cat in sorted(digest["categories"]):
        info = digest["categories"][cat]
        lines.append("  %-8s %6d event(s)  %5d span(s)  %10.3f ms busy"
                     % (cat, info["events"], info["spans"],
                        info["busy_ms"]))
    if digest["top_spans"]:
        lines.append("")
        lines.append("top spans by total time:")
        for item in digest["top_spans"]:
            lines.append("  %10.3f ms  %5dx  %s:%s"
                         % (item["total_ms"], item["count"],
                            item["cat"], item["name"]))
    seg = digest["segment"]
    if seg["dispatches"]:
        lines.append("")
        lines.append("segment dispatch vs host gap:")
        pct = (100.0 * seg["host_gap_ms"] / seg["wall_ms"]
               if seg["wall_ms"] else 0.0)
        folded = ""
        if seg.get("steps", 0) > seg["dispatches"]:
            # epoch-scan windows fold K steps into one dispatch: the
            # split names BOTH so a before/after comparison reads
            # directly as "same steps, N× fewer host dispatches"
            folded = " covering %d step(s) (%.1f steps/dispatch)" % (
                seg["steps"], seg["steps"] / seg["dispatches"])
        lines.append("  %d dispatch(es)%s, %.3f ms dispatching, "
                     "%.3f ms host gap (%.1f%% of the dispatch wall)"
                     % (seg["dispatches"], folded, seg["dispatch_ms"],
                        seg["host_gap_ms"], pct))
    if digest["counters"]:
        lines.append("")
        lines.append("counters (last sample):")
        for name in sorted(digest["counters"]):
            lines.append("  %-20s %s" % (name,
                                         digest["counters"][name]))
    return "\n".join(lines) + "\n"


def metrics_text():
    """Prometheus-style lines appended to the serve ``/metrics`` page
    when tracing is on — wraparound-proof running counts, not a walk
    of the ring.  All samples of one metric family stay contiguous
    (the exposition-format contract strict parsers enforce)."""
    lines = [
        "# HELP veles_trace_recorded_total trace events recorded "
        "(veles_tpu.trace; grand total — its own family, so "
        "sum(veles_trace_events_total) stays honest)",
        "# TYPE veles_trace_recorded_total counter",
        "veles_trace_recorded_total %d" % recorder.recorded,
        "# HELP veles_trace_events_total trace events per category",
        "# TYPE veles_trace_events_total counter",
    ]
    for cat, count in sorted(recorder.category_counts().items()):
        lines.append('veles_trace_events_total{cat="%s"} %d'
                     % (cat, count))
    lines.append("# TYPE veles_trace_dropped_total counter")
    lines.append("veles_trace_dropped_total %d" % recorder.dropped)
    return "\n".join(lines) + "\n"
