"""The composite argument parser of ``python -m veles_tpu_torch``: the
port's counterpart of :mod:`veles_tpu.cmdline`.

A class with the :class:`CommandLineArgumentsRegistry` metaclass and a
static ``init_parser(parser)`` (the Launcher's), or any callable given to
:func:`register_arguments`, contributes its arguments; :func:`make_parser`
folds every contribution into one parser.  The flags of modules the port
does not have yet are parsed, and ``Main`` refuses them naming ROADMAP
item 7(e).  :func:`html_reference` renders the parser as an HTML page
(``--html-help``).
"""

import argparse

#: Registered contributor callables ``f(parser) -> None``.
_CONTRIBUTORS = []
_SEEN = set()


def register_arguments(contributor):
    """Register an ``init_parser``-style contributor (idempotent)."""
    key = (getattr(contributor, "__module__", ""),
           getattr(contributor, "__qualname__", None) or id(contributor))
    if key in _SEEN:
        return contributor
    _SEEN.add(key)
    _CONTRIBUTORS.append(contributor)
    return contributor


class CommandLineArgumentsRegistry(type):
    """The registry metaclass: classes defining
    ``init_parser(parser)`` auto-contribute it at class-creation time."""

    def __init__(cls, name, bases, namespace):
        super(CommandLineArgumentsRegistry, cls).__init__(
            name, bases, namespace)
        init_parser = namespace.get("init_parser")
        if init_parser is not None:
            fn = init_parser.__func__ if isinstance(
                init_parser, staticmethod) else init_parser
            register_arguments(fn)


def make_parser(prog="veles_tpu_torch", description=None):
    """Build the composite parser: core args + every registered
    contributor."""
    parser = argparse.ArgumentParser(
        prog=prog,
        description=description or
        "VELES on PyTorch and CUDA: run a workflow standalone, as master, "
        "or as slave.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument(
        "workflow", nargs="?", default=None,
        help="workflow python file or dotted module "
             "(e.g. veles_tpu_torch.samples.mnist)")
    parser.add_argument(
        "config", nargs="?", default=None,
        help="optional config python file exec'd against root.*")
    parser.add_argument(
        "overrides", nargs="*", default=[], metavar="key=value",
        help="dotted root.* config overrides, JSON-parsed values")
    parser.add_argument(
        "-v", "--verbosity", default="info",
        choices=["debug", "info", "warning", "error"],
        help="log level")
    parser.add_argument(
        "--debug", default="", metavar="CLASS,...",
        help="comma-separated class names forced to DEBUG")
    parser.add_argument(
        "--log-db", default="", metavar="PATH",
        help="duplicate every log record into an SQLite DB"
             " (not ported yet: ROADMAP item 7(e))")
    parser.add_argument(
        "--version", action="store_true",
        help="print version and backend info, then exit")
    parser.add_argument(
        "--no-logo", action="store_true",
        help="do not print the version banner at startup")
    parser.add_argument(
        "--dump-config", action="store_true",
        help="print the configuration after the config file and "
             "the overrides")
    parser.add_argument(
        "--dump-unit-attributes", default="no",
        choices=["no", "pretty", "all"],
        help="print the units' attributes after initialization; "
             "\"pretty\" elides large arrays")
    parser.add_argument(
        "--visualize", action="store_true",
        help="initialize, write the graph and plot"
             " (not ported yet: ROADMAP item 7(e))")
    parser.add_argument(
        "-b", "--background", action="store_true",
        help="detach and run as a daemon")
    parser.add_argument(
        "--debug-pickle", action="store_true",
        help="on a failed snapshot pickle, name the offending "
             "attribute")
    parser.add_argument(
        "--html-help", action="store_true",
        help="write the argument reference as an HTML page and "
             "print its path")
    parser.add_argument(
        "-r", "--random-seed", default=None,
        help="seed for the named PRNG streams (int, or "
             "path[:dtype:count] of a seed file)")
    parser.add_argument(
        "-w", "--snapshot", default="",
        help="resume from a snapshot file")
    parser.add_argument(
        "--test", action="store_true",
        help="run in evaluation mode instead of training")
    parser.add_argument(
        "--fused", action="store_true",
        help="train through the fused lowering: one FusedTrainer "
             "step a minibatch (StandardWorkflow(fused=True))")
    parser.add_argument(
        "--result-file", default="",
        help="write the gathered results (JSON) here")
    parser.add_argument(
        "--dry-run", default="", choices=["", "load", "init"],
        help="load: parse and apply the config, then stop; init: "
             "construct and initialize the workflow, then exit")
    parser.add_argument(
        "--workflow-graph", default="",
        help="write the unit graph in DOT format"
             " (not ported yet: ROADMAP item 7(e))")
    parser.add_argument(
        "--optimize", default="", metavar="SIZE[:GENERATIONS]",
        help="genetic hyperparameter optimization"
             " (not ported yet: ROADMAP item 7(e))")
    parser.add_argument(
        "--ensemble-train", default="", metavar="N:RATIO",
        help="train an ensemble of N models"
             " (not ported yet: ROADMAP item 7(e))")
    parser.add_argument(
        "--ensemble-test", default="", metavar="INPUT_JSON",
        help="evaluate a trained ensemble"
             " (not ported yet: ROADMAP item 7(e))")
    parser.add_argument(
        "--manhole", action="store_true",
        help="arm the debug backdoor"
             " (not ported yet: ROADMAP item 7(e))")
    parser.add_argument(
        "--debug-nans", action="store_true",
        help="raise at the first NaN"
             " (not ported yet: ROADMAP item 7(e))")
    parser.add_argument(
        "--profile", default="", metavar="TRACE_DIR",
        help="record the run's trace into TRACE_DIR: the span "
             "recorder's Chrome trace, and on a master the session "
             "profile bundle of its slaves (python -m "
             "veles_tpu_torch.prof merge)")
    parser.add_argument(
        "--frontend", default="", metavar="OUT_HTML",
        help="generate the HTML command composer"
             " (not ported yet: ROADMAP item 7(e))")
    for contribute in list(_CONTRIBUTORS):
        contribute(parser)
    return parser


def html_reference(parser=None):
    """The parser's arguments as an HTML page: one row a flag, with its
    default and its help."""
    import html
    parser = parser or make_parser()
    rows = []
    for action in parser._actions:
        flags = ", ".join(action.option_strings) or action.dest
        default = "" if action.default in (None, argparse.SUPPRESS) \
            else repr(action.default)
        rows.append("<tr><td><code>%s</code></td><td>%s</td><td>%s</td>"
                    "</tr>" % (html.escape(flags), html.escape(default),
                               html.escape(action.help or "")))
    return ("<!DOCTYPE html>\n<html><head><meta charset=\"utf-8\">"
            "<title>%s arguments</title></head><body>\n<h1>python -m %s"
            "</h1>\n<table>\n<tr><th>argument</th><th>default</th>"
            "<th>help</th></tr>\n%s\n</table></body></html>\n"
            % (parser.prog, parser.prog, "\n".join(rows)))
