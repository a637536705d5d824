"""Cluster merge: one Perfetto timeline and one perf report for a whole
master-slave session.  The port's counterpart of
:mod:`veles_tpu.prof.merge`.

A **session profile bundle** holds each participant's trace export and
ledger summary::

    {"kind": "veles_tpu.prof.session",
     "master": {"events": [...], "ledger": {...}},
     "slaves": {sid: {"events": [...], "ledger": {...},
                      "offset_ns": <master_clock - slave_clock>}}}

``offset_ns`` is the master's clock minus the slave's, and the merge
shifts each slave's timestamps by it.  The job layer produces bundles
(:meth:`veles_tpu_torch.parallel.jobs.JobServer.save_session_profile`):
the slaves ship their halves over the job wire at the end of their run
(op ``prof``), and the master measures each offset on the heartbeat
wire (the minimum of ``recv_ns - sent_ns`` over the slave's pings).
:func:`make_bundle` builds one from trace exports and ledger summaries
in hand.

``python -m veles_tpu_torch.prof merge session.json -o merged.json``
writes the single Perfetto-loadable timeline (master + ``slave-<sid>``
pids); :func:`cluster_report` prints per-slave MFU, the straggler
spread and aggregate HBM from the shipped ledgers.
"""

import json

#: the bundle's kind: the JAX package's, so either package reads the
#: other's bundles
BUNDLE_KIND = "veles_tpu.prof.session"


def is_bundle(payload):
    return isinstance(payload, dict) \
        and payload.get("kind") == BUNDLE_KIND


def load(path):
    with open(path, "r") as fin:
        payload = json.load(fin)
    if not is_bundle(payload):
        raise ValueError(
            "%s is not a prof session bundle (JobServer.save_session_profile "
            "or make_bundle writes one)"
            % path)
    return payload


def make_bundle(master, slaves):
    """A session bundle from ``master`` = ``(events, ledger_summary)``
    and ``slaves`` = ``{sid: (events, ledger_summary, offset_ns)}``
    (normalized trace events, :func:`veles_tpu_torch.prof.summary`
    digests)."""
    return {"kind": BUNDLE_KIND,
            "master": {"events": list(master[0]), "ledger": master[1]},
            "slaves": {str(sid): {"events": list(events),
                                  "ledger": summary,
                                  "offset_ns": int(offset_ns)}
                       for sid, (events, summary, offset_ns)
                       in slaves.items()}}


def _relabel(role, sid):
    """A slave's lanes all belong to its pid: its default-role
    (trainer) spans become ``slave-<sid>``; already-slave roles stay;
    anything else (a slave also serving) keeps its flavor as a
    suffix so the lane is still attributable."""
    slave_role = "slave-%s" % sid
    if role in (None, "", "trainer") or role == slave_role:
        return slave_role
    if str(role).startswith("slave-"):
        return role
    return "%s:%s" % (slave_role, role)


def merged_events(bundle):
    """One clock-aligned normalized event list: master events verbatim
    plus every slave's events shifted by its heartbeat clock offset
    and relabeled onto its own pid."""
    out = list(bundle.get("master", {}).get("events", ()))
    for sid, prof in sorted(bundle.get("slaves", {}).items()):
        shift_us = float(prof.get("offset_ns", 0) or 0) / 1e3
        for ev in prof.get("events", ()):
            ev = dict(ev)
            ev["ts_us"] = float(ev.get("ts_us", 0.0)) + shift_us
            ev["role"] = _relabel(ev.get("role"), sid)
            out.append(ev)
    out.sort(key=lambda ev: ev.get("ts_us", 0.0))
    return out


def save_merged(bundle, path):
    """Write the merged Chrome trace-event JSON; returns ``path``."""
    from veles_tpu_torch.trace.export import chrome_events
    payload = {
        "displayTimeUnit": "ms",
        "traceEvents": chrome_events(merged_events(bundle)),
        "metadata": {"producer": "veles_tpu_torch.prof.merge",
                     "slaves": sorted(bundle.get("slaves", {}))},
    }
    with open(path, "w") as fout:
        json.dump(payload, fout)
    return path


def _mean_job_ms(events):
    """Mean ``jobs:do_job`` span duration (ms) and count from one
    participant's events — the straggler metric."""
    total_us, n = 0.0, 0
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "jobs" \
                and ev.get("name") == "do_job":
            total_us += float(ev.get("dur_us", 0.0))
            n += 1
    return (total_us / 1e3 / n if n else 0.0), n


def cluster_report(bundle):
    """The cluster ``perf_report()``: per-slave MFU + job pacing, the
    straggler spread, and aggregate HBM across every participant."""
    lines = ["veles_tpu_torch.prof cluster report — %d slave(s)"
             % len(bundle.get("slaves", {}))]
    paces = {}
    hbm_total = 0
    master_ledger = bundle.get("master", {}).get("ledger") or {}
    hbm = master_ledger.get("hbm") or {}
    if hbm:
        hbm_total += int(hbm.get("peak_bytes", 0))
    for sid, prof in sorted(bundle.get("slaves", {}).items()):
        ledger = prof.get("ledger") or {}
        totals = ledger.get("totals") or {}
        mfu = totals.get("mfu")
        mean_ms, jobs = _mean_job_ms(prof.get("events", ()))
        if jobs:
            paces[sid] = mean_ms
        peak = int((ledger.get("hbm") or {}).get("peak_bytes", 0))
        hbm_total += peak
        lines.append(
            "  slave-%s: %d job(s), mean job %.1f ms, mfu %s, "
            "recompiles %d, peak HBM %.1f MiB"
            % (sid, jobs, mean_ms,
               ("%.2f%%" % (100.0 * mfu)) if mfu is not None
               else "n/a (no peak entry)",
               totals.get("recompiles", 0), peak / 2 ** 20))
    if len(paces) >= 2:
        slow_sid = max(paces, key=paces.get)
        fast_sid = min(paces, key=paces.get)
        fast = paces[fast_sid] or 1e-9
        lines.append(
            "straggler spread: %.2fx (slowest slave-%s %.1f ms vs "
            "fastest slave-%s %.1f ms mean job)"
            % (paces[slow_sid] / fast, slow_sid, paces[slow_sid],
               fast_sid, paces[fast_sid]))
    elif paces:
        lines.append("straggler spread: n/a (single slave)")
    lines.append("aggregate peak HBM across participants: %.1f MiB"
                 % (hbm_total / 2 ** 20))
    return "\n".join(lines) + "\n"
