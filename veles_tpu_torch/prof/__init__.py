"""veles_tpu_torch.prof: the performance ledger, the port's counterpart
of :mod:`veles_tpu.prof`.

- :mod:`~veles_tpu_torch.prof.ledger`: per-program entries (stitched
  segments, epoch-scan windows, serve buckets, generative programs)
  with the cost their kernels tallied (:mod:`veles_tpu_torch.ops.cost`),
  compile and dispatch clocks, achieved FLOP/s and, on a card of the
  peak table, MFU; the offline report over an exported trace;
- :mod:`~veles_tpu_torch.prof.sentinel`: the steady-state recompile
  sentinel;
- :mod:`~veles_tpu_torch.prof.merge`: one clock-aligned timeline and a
  cluster report from a session bundle;
- :func:`summary` and :func:`metrics_text` over the ledger and
  :meth:`veles_tpu_torch.memory.Watcher.hbm_ledger`, the ``/metrics``
  page's ``veles_prof_*`` lines.

``python -m veles_tpu_torch.prof <trace.json>`` prints the offline
report, ``merge <bundle> -o <out>`` merges a bundle, ``--smoke`` runs
the ledger's gate over a sample.
"""

from veles_tpu_torch.prof.ledger import (  # noqa: F401
    CATEGORIES, DEFAULT_CATEGORY, DispatchTimer, LedgerEntry, PerfLedger,
    card_label,
    cost_of, device_kind, entries_from_events, ledger, peak_flops,
    render_rows, report_from_events, report_text, span_cost_args)
from veles_tpu_torch.prof.sentinel import (  # noqa: F401
    flag_recompile, flagged)
from veles_tpu_torch.prof import merge  # noqa: F401


def summary():
    """The live ledger digest (see :meth:`PerfLedger.summary`)."""
    return ledger.summary()


def metrics_text():
    """Prometheus gauge lines for the serving ``/metrics`` page:
    compile and recompile counters, dispatched flops and the HBM ledger
    by category."""
    from veles_tpu_torch.memory import Watcher
    hbm = Watcher.hbm_ledger()
    lines = [
        "# HELP veles_prof_compiles_total programs compiled: CUDA "
        "graph captures of the segments, windows and serve buckets "
        "(veles_tpu_torch.prof ledger)",
        "# TYPE veles_prof_compiles_total counter",
        "veles_prof_compiles_total %d" % ledger.compile_events,
        "# HELP veles_prof_recompiles_total steady-state recompiles "
        "flagged by the sentinel",
        "# TYPE veles_prof_recompiles_total counter",
        "veles_prof_recompiles_total %d" % ledger.recompiles,
        "# HELP veles_prof_flops_dispatched_total flops the dispatched "
        "programs ran, from their kernels' cost tally",
        "# TYPE veles_prof_flops_dispatched_total counter",
        "veles_prof_flops_dispatched_total %d"
        % int(ledger.flops_dispatched),
        "# HELP veles_prof_hbm_bytes device-resident bytes by ledger "
        "category",
        "# TYPE veles_prof_hbm_bytes gauge",
    ]
    for cat in CATEGORIES:
        info = hbm["by_category"].get(cat)
        if info:
            lines.append('veles_prof_hbm_bytes{category="%s"} %d'
                         % (cat, info["bytes"]))
    lines.append("# TYPE veles_prof_hbm_peak_bytes gauge")
    lines.append("veles_prof_hbm_peak_bytes %d" % hbm["peak_bytes"])
    return "\n".join(lines) + "\n"
