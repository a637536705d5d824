"""``python -m veles_tpu_torch.trace <trace.json>`` — offline summarizer.

The port's counterpart of ``python -m veles_tpu.trace``.  Reads a
Chrome trace-event file written by ``root.common.engine
.trace=<path.json>`` (or :func:`veles_tpu_torch.trace.save`) and prints
the report :func:`veles_tpu_torch.trace.export.report_text` renders:
per-category totals, top spans by total time, the segment dispatch vs
host-gap split, and last counter samples.  ``--json`` emits the
summary dict instead (tooling), ``--top`` widens the span leaderboard.
"""

import argparse
import sys


def make_parser():
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.trace",
        description="Summarize a veles_tpu_torch Chrome trace-event JSON "
                    "(per-category totals, top spans, dispatch vs "
                    "host-gap time).")
    parser.add_argument("trace", help="trace JSON file to summarize")
    parser.add_argument("--top", type=int, default=10,
                        help="span leaderboard size (default 10)")
    parser.add_argument("--json", action="store_true",
                        help="emit the summary as JSON instead of text")
    return parser


def main(argv=None):
    from veles_tpu_torch.trace import export
    args = make_parser().parse_args(argv)
    try:
        events = export.load(args.trace)
    except (OSError, ValueError) as exc:
        print("cannot read %s: %s" % (args.trace, exc),
              file=sys.stderr)
        return 2
    if args.json:
        import json
        print(json.dumps(export.summary(events, top=args.top),
                         indent=2))
    else:
        print(export.report_text(events, top=args.top), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
