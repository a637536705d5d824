"""``python -m veles_tpu_torch.watch``: the live terminal dashboard, the
port's counterpart of ``python -m veles_tpu.watch``.

Usage::

    python -m veles_tpu_torch.watch tcp://127.0.0.1:9461          # live
    python -m veles_tpu_torch.watch tcp://... --record run.ndjson  # + persist
    python -m veles_tpu_torch.watch --replay run.ndjson            # offline
    python -m veles_tpu_torch.watch --smoke [--device cpu]         # the gate

Live mode subscribes to a telemetry bus
(:mod:`veles_tpu_torch.watch.bus`)
and renders a newest-event-per-kind table, with the health block
expanded per param group.  ``--record`` appends every received event
to an ndjson file (one JSON object per line) that ``--replay`` renders
back — the record/replay roundtrip the tests gate on.  ``--once``
prints raw events instead of redrawing (pipe-friendly).

The ``--smoke`` gate: one traced stitched training session under
``engine.health=on`` and ``engine.epoch_scan=auto`` must publish at
least 4 distinct event kinds consumed by a LIVE subscriber; an injected
NaN under ``health=strict`` must raise
:class:`~veles_tpu_torch.watch.health.HealthError` naming the poisoned
layer's param group; and a record/replay roundtrip must reproduce the
session exactly.  It needs pyzmq.
"""

import argparse
import json
import sys
import time


def _fmt_age(age_s):
    if age_s < 10:
        return "%4.1fs" % age_s
    if age_s < 600:
        return "%4.0fs" % age_s
    return "%3.0fm" % (age_s / 60.0)


def _fmt_event(event):
    """One-line digest of an event's interesting fields."""
    kind = event.get("kind")
    skip = {"kind", "ts", "seq", "role"}
    if kind == "health":
        parts = []
        for name, group in sorted((event.get("groups") or {}).items()):
            parts.append(
                "%s g=%.3g w=%.3g r=%.3g nf=%d" % (
                    name, group.get("grad_norm", float("nan")),
                    group.get("weight_norm", float("nan")),
                    group.get("update_ratio", float("nan")),
                    int(group.get("nonfinite", 0))))
        return "step %s | %s" % (event.get("step"),
                                 " | ".join(parts) or "no groups")
    pairs = []
    for key in sorted(event):
        if key in skip:
            continue
        value = event[key]
        if isinstance(value, float):
            value = "%.4g" % value
        elif isinstance(value, (dict, list)):
            value = json.dumps(value, default=repr)
            if len(value) > 40:
                value = value[:37] + "..."
        pairs.append("%s=%s" % (key, value))
    return " ".join(pairs)


def render(latest, received=0, dropped=None, now=None):
    """The dashboard frame: newest event per kind, padded table."""
    now = now if now is not None else time.time()
    lines = ["veles_tpu_torch.watch — %d event(s) received%s" % (
        received,
        "" if dropped is None else ", %d dropped" % dropped)]
    lines.append("%-10s %-6s %-6s %s" % ("KIND", "AGE", "ROLE",
                                         "LATEST"))
    for kind in sorted(latest):
        if kind.startswith("_"):
            continue
        event = latest[kind]
        lines.append("%-10s %-6s %-6s %s" % (
            kind, _fmt_age(max(0.0, now - float(event.get("ts", now)))),
            str(event.get("role", "?"))[:6], _fmt_event(event)))
    return "\n".join(lines)


def consume(reader, duration=None, record=None, once=False,
            interval=0.5, out=None):
    """The live loop: poll → accumulate latest-per-kind → redraw (or
    print raw with ``once``) → optionally append to the record file.
    Returns ``(latest, received)``.  Ctrl-C exits cleanly."""
    out = out or sys.stdout
    latest = {}
    received = 0
    deadline = (time.monotonic() + duration) if duration else None
    last_draw = 0.0
    # one append handle for the whole session (not one open/close per
    # event); flushed per event so a killed dashboard loses nothing
    fout = open(record, "a") if record else None
    try:
        while deadline is None or time.monotonic() < deadline:
            event = reader.poll(200)
            if event is not None:
                received += 1
                latest[event.get("kind", "?")] = event
                if fout is not None:
                    fout.write(json.dumps(event, default=repr) + "\n")
                    fout.flush()
                if once:
                    print(json.dumps(event, default=repr), file=out)
            if not once and time.monotonic() - last_draw >= interval:
                last_draw = time.monotonic()
                # ANSI home+clear keeps the table in place on a tty;
                # harmless noise when redirected
                if out.isatty():
                    out.write("\x1b[H\x1b[2J")
                out.write(render(latest, received) + "\n")
                out.flush()
    except KeyboardInterrupt:
        pass
    finally:
        if fout is not None:
            fout.close()
    return latest, received


def replay(path, out=None):
    """Render a recorded ndjson session offline: final dashboard
    frame + per-kind counts."""
    from veles_tpu_torch.watch.bus import load_events
    out = out or sys.stdout
    events = load_events(path)
    latest = {}
    counts = {}
    for event in events:
        kind = event.get("kind", "?")
        latest[kind] = event
        counts[kind] = counts.get(kind, 0) + 1
    now = max((float(e.get("ts", 0)) for e in events), default=None)
    print(render(latest, received=len(events), now=now), file=out)
    print("kinds: %s" % ", ".join(
        "%s×%d" % (k, counts[k]) for k in sorted(counts)), file=out)
    return events


# -- the smoke --------------------------------------------------------------

def run_smoke(module_name="veles_tpu_torch.samples.mnist", device=None):
    """The watch gate (see the module docstring) over ``module_name``'s
    ``create_workflow(device=...)``; returns an exit code."""
    import importlib
    import os
    import tempfile

    import numpy

    from veles_tpu_torch import watch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.watch.bus import TelemetryReader, load_events, \
        record_events
    from veles_tpu_torch.watch.health import HealthError

    saved = {k: root.common.engine.get(k, d) for k, d in (
        ("trace", "off"), ("stitch", "on"), ("epoch_scan", "off"),
        ("health", "off"))}
    root.common.engine.trace = "on"
    root.common.engine.stitch = "on"
    root.common.engine.epoch_scan = "auto"
    root.common.engine.health = "on"
    reader = None
    try:
        bus = watch.start("tcp://127.0.0.1:0")
        reader = TelemetryReader(bus.endpoint)
        if not reader.sync(bus):
            print("watch smoke: FAIL — subscriber never joined the "
                  "bus", file=sys.stderr)
            return 1
        # -- gate 1: one traced training session, >=4 event kinds
        # consumed by the LIVE subscriber ---------------------------
        sample = importlib.import_module(module_name)
        wf = sample.create_workflow(device=device, max_epochs=2,
                                     minibatch_size=500)
        wf.run()
        events = reader.drain(timeout_ms=200)
        kinds = {e["kind"] for e in events if not
                 e["kind"].startswith("_")}
        if len(kinds) < 4:
            print("watch smoke: FAIL — %d event kind(s) on the live "
                  "bus (%s), need >= 4" % (len(kinds), sorted(kinds)),
                  file=sys.stderr)
            return 1
        health_events = [e for e in events if e["kind"] == "health"]
        if not health_events or not health_events[-1].get("groups"):
            print("watch smoke: FAIL — no health snapshot with param "
                  "groups on the bus", file=sys.stderr)
            return 1
        for name, group in health_events[-1]["groups"].items():
            if not numpy.isfinite(group.get("weight_norm", 0.0)) \
                    or group.get("nonfinite", 1) != 0:
                print("watch smoke: FAIL — unhealthy stats for %s: %r"
                      % (name, group), file=sys.stderr)
                return 1
        # -- gate 2: injected NaN caught by strict mode -------------
        root.common.engine.health = "strict"
        wf2 = sample.create_workflow(device=device, max_epochs=2,
                                     minibatch_size=500)
        weights = wf2.forwards[0].weights
        weights.map_write()
        weights.mem[0, 0] = numpy.nan
        try:
            wf2.run()
        except HealthError as exc:
            if not exc.leaf or exc.count < 1:
                print("watch smoke: FAIL — HealthError without a "
                      "named leaf: %s" % exc, file=sys.stderr)
                return 1
        else:
            print("watch smoke: FAIL — injected NaN not caught by "
                  "health=strict", file=sys.stderr)
            return 1
        # -- gate 3: record/replay roundtrip ------------------------
        fd, path = tempfile.mkstemp(suffix=".ndjson")
        os.close(fd)
        try:
            record_events(events, path)
            back = load_events(path)
            if back != events:
                print("watch smoke: FAIL — record/replay roundtrip "
                      "drifted (%d vs %d events)"
                      % (len(back), len(events)), file=sys.stderr)
                return 1
        finally:
            os.unlink(path)
        print("watch smoke: OK — %d event(s), kinds %s; strict NaN "
              "caught; record/replay roundtrip exact; bus %r"
              % (len(events), sorted(kinds), bus.describe()))
        return 0
    finally:
        if reader is not None:
            reader.close()
        watch.shutdown()
        for key, value in saved.items():
            setattr(root.common.engine, key, value)
        from veles_tpu_torch import trace
        trace.configure()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.watch",
        description="live telemetry dashboard over the watch bus")
    parser.add_argument("endpoint", nargs="?",
                        help="bus endpoint, e.g. tcp://127.0.0.1:9461")
    parser.add_argument("--record", metavar="FILE",
                        help="append received events to an ndjson file")
    parser.add_argument("--replay", metavar="FILE",
                        help="render a recorded ndjson session")
    parser.add_argument("--once", action="store_true",
                        help="print raw events (no dashboard redraw)")
    parser.add_argument("--duration", type=float, default=None,
                        help="exit after N seconds (default: run "
                             "until Ctrl-C)")
    parser.add_argument("--interval", type=float, default=0.5,
                        help="dashboard redraw interval (seconds)")
    parser.add_argument("--smoke", metavar="MODULE", nargs="?",
                        const="veles_tpu_torch.samples.mnist", default=None,
                        help="run the watch gate over a sample module")
    parser.add_argument("--device", default=None,
                        help="cpu, or a cuda device (default: the card)")
    ns = parser.parse_args(argv)
    if ns.smoke:
        return run_smoke(ns.smoke, device=ns.device)
    if ns.replay:
        replay(ns.replay)
        return 0
    if not ns.endpoint:
        parser.print_help()
        return 2
    from veles_tpu_torch.watch.bus import TelemetryReader
    reader = TelemetryReader(ns.endpoint)
    try:
        latest, received = consume(
            reader, duration=ns.duration, record=ns.record,
            once=ns.once, interval=ns.interval)
    finally:
        reader.close()
    if not ns.once:
        print(render(latest, received))
    return 0


if __name__ == "__main__":  # pragma: no cover - thin CLI
    sys.exit(main())
