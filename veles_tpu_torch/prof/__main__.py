"""``python -m veles_tpu_torch.prof``: the performance-ledger CLI, the
port's counterpart of ``python -m veles_tpu.prof``.

Three modes::

    # offline perf report over an exported trace (compile instants
    # carry the cost, dispatch spans the wall time)
    python -m veles_tpu_torch.prof run.json

    # cluster report over a session bundle (prof.merge.make_bundle)
    python -m veles_tpu_torch.prof session_profile.json

    # merge a bundle into ONE clock-aligned Perfetto timeline
    python -m veles_tpu_torch.prof merge session_profile.json \
        -o merged.json

and the ledger's smoke over a sample (the card unless ``--device
cpu``)::

    python -m veles_tpu_torch.prof --smoke veles_tpu_torch.samples.mnist
"""

import argparse
import json
import sys


def make_parser():
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.prof",
        description="Performance-ledger reports: per-program "
                    "flops/MFU from a trace export, cluster "
                    "merge/report from a session bundle.")
    parser.add_argument(
        "target", nargs="?", default=None,
        help="trace-event JSON (offline perf report) or session "
             "bundle (cluster report); 'merge' selects merge mode")
    parser.add_argument("--json", action="store_true",
                        help="emit the digest as JSON instead of text")
    parser.add_argument(
        "--smoke", metavar="MODULE", default=None,
        help="run the profiler smoke over a sample module "
             "(asserts non-zero per-segment flops, a parseable "
             "perf_report() and zero steady-state recompiles)")
    parser.add_argument("--device", default=None,
                        help="cpu, or a cuda device (default: the card)")
    return parser


def make_merge_parser():
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.prof merge",
        description="Merge a session-profile bundle into one "
                    "clock-aligned Perfetto timeline.")
    parser.add_argument("bundle", help="session bundle JSON "
                                       "(prof.merge.make_bundle)")
    parser.add_argument("-o", "--out", required=True,
                        help="merged Chrome trace-event JSON to write")
    return parser


def _report_file(path, as_json):
    from veles_tpu_torch.prof import (entries_from_events, merge,
                                      report_from_events)
    try:
        with open(path, "r") as fin:
            payload = json.load(fin)
    except (OSError, ValueError) as exc:
        print("cannot read %s: %s" % (path, exc), file=sys.stderr)
        return 2
    if merge.is_bundle(payload):
        if as_json:
            rows = {sid: (prof.get("ledger") or {})
                    for sid, prof in payload.get("slaves",
                                                 {}).items()}
            print(json.dumps(rows, indent=2))
        else:
            print(merge.cluster_report(payload), end="")
        return 0
    from veles_tpu_torch.trace import export
    # a plain trace export: load through the trace reader so pids map
    # back to roles, then reconstruct ledger rows from the cost args
    try:
        events = export.load(path)
    except (ValueError, KeyError, TypeError) as exc:
        print("%s is neither a session bundle nor a trace-event "
              "file: %s" % (path, exc), file=sys.stderr)
        return 2
    if as_json:
        rows, peak = entries_from_events(events)
        print(json.dumps({"peak_flops": peak, "entries": rows},
                         indent=2))
    else:
        print(report_from_events(events), end="")
    return 0


def run_smoke(module_name, device=None):
    """The profiler smoke: a short stitched run of the named sample on
    ``device`` must leave (a) non-zero flops on every registered
    segment, (b) a parseable ``perf_report()`` with one row per
    segment, and (c) a ledger whose recompile count is zero with every
    compile traced (trace compile events == ledger compile events)."""
    import importlib

    from veles_tpu_torch import prof, trace
    from veles_tpu_torch.config import root
    saved_trace = root.common.engine.get("trace", "off")
    saved_stitch = root.common.engine.get("stitch", "on")
    root.common.engine.trace = "on"
    root.common.engine.stitch = "on"
    try:
        sample = importlib.import_module(module_name)
        # the ledger and the trace counts are process-wide: the smoke
        # reads what this run adds to them
        before = {id(e): e.compiles for e in prof.ledger.entries()}
        traced0 = trace.recorder.count("segment", "compile")
        recompiles0 = prof.ledger.recompiles
        flagged0 = len(prof.flagged)
        flops0 = prof.ledger.flops_dispatched
        wf = sample.create_workflow(device=device, max_epochs=2,
                                    minibatch_size=500)
        wf.run()
        segments = [e for e in prof.ledger.entries("segment")
                    if e.compiles != before.get(id(e), 0)
                    or id(e) not in before]
        if not segments:
            print("prof smoke: FAIL - no stitched segments registered "
                  "over %s" % module_name, file=sys.stderr)
            return 1
        zero = [e.name for e in segments if not e.flops]
        if zero:
            print("prof smoke: FAIL - segment(s) with zero flops: %s"
                  % ", ".join(zero), file=sys.stderr)
            return 1
        report = wf.perf_report()
        missing = [e.name for e in segments
                   if e.name[:36] not in report]
        if "performance ledger" not in report or missing:
            print("prof smoke: FAIL - perf_report() missing rows for "
                  "%s:\n%s" % (missing, report), file=sys.stderr)
            return 1
        compiles = sum(e.compiles - before.get(id(e), 0)
                       for e in segments)
        traced = trace.recorder.count("segment", "compile") - traced0
        if traced != compiles:
            print("prof smoke: FAIL - %d traced compile event(s) vs "
                  "%d ledger compile(s): a compile escaped the "
                  "sentinel" % (traced, compiles), file=sys.stderr)
            return 1
        recompiles = prof.ledger.recompiles - recompiles0
        if recompiles or len(prof.flagged) != flagged0:
            print("prof smoke: FAIL - %d steady-state recompile(s) "
                  "on a shape-stable sample run: %r"
                  % (recompiles, prof.flagged[flagged0:]),
                  file=sys.stderr)
            return 1
        print("prof smoke: OK - %d segment(s), %d compile(s), "
              "0 recompiles, %.3e FLOPs dispatched"
              % (len(segments), compiles,
                 prof.ledger.flops_dispatched - flops0))
        return 0
    finally:
        root.common.engine.trace = saved_trace
        root.common.engine.stitch = saved_stitch
        trace.configure()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "merge":
        from veles_tpu_torch.prof import merge
        args = make_merge_parser().parse_args(argv[1:])
        try:
            bundle = merge.load(args.bundle)
        except (OSError, ValueError) as exc:
            print(str(exc), file=sys.stderr)
            return 2
        out = merge.save_merged(bundle, args.out)
        print("merged timeline -> %s" % out)
        print(merge.cluster_report(bundle), end="")
        return 0
    args = make_parser().parse_args(argv)
    if args.smoke:
        return run_smoke(args.smoke, device=args.device)
    if args.target is None:
        make_parser().print_usage(sys.stderr)
        return 2
    return _report_file(args.target, args.json)


if __name__ == "__main__":
    sys.exit(main())
