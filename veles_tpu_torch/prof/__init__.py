"""veles_tpu_torch.prof: the performance ledger's live part, the port's
counterpart of :mod:`veles_tpu.prof`.

- :mod:`~veles_tpu_torch.prof.ledger`: per-program entries (the batch
  engine's buckets) with compile and dispatch clocks;
- :mod:`~veles_tpu_torch.prof.sentinel`: the steady-state recompile
  sentinel;
- :func:`summary` and :func:`metrics_text` over the ledger and
  :meth:`veles_tpu_torch.memory.Watcher.hbm_ledger`, the serving
  ``/metrics`` page's ``veles_prof_*`` lines.

The offline report, ``merge`` and ``python -m veles_tpu.prof`` are not
ported yet (ROADMAP.md, 'Slices still to port', item 6(c)).
"""

from veles_tpu_torch.prof.ledger import (  # noqa: F401
    CATEGORIES, DEFAULT_CATEGORY, LedgerEntry, PerfLedger, cost_of,
    device_kind, ledger, peak_flops, span_cost_args)
from veles_tpu_torch.prof.sentinel import (  # noqa: F401
    flag_recompile, flagged)


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
        "graph captures of the serve buckets (veles_tpu_torch.prof "
        "ledger)",
        "# TYPE veles_prof_compiles_total counter",
        "veles_prof_compiles_total %d" % ledger.compile_events,
        "# HELP veles_prof_recompiles_total steady-state recompiles "
        "flagged by the sentinel",
        "# TYPE veles_prof_recompiles_total counter",
        "veles_prof_recompiles_total %d" % ledger.recompiles,
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
