"""veles_tpu_torch.obs: request tracing and the SLO engine, the port's
counterpart of :mod:`veles_tpu.obs`, trimmed to the two modules the
batch serving path imports.

- :mod:`~veles_tpu_torch.obs.context`: the W3C-compatible trace
  context minted at the serving front door and carried across the
  batcher's thread handoff;
- :mod:`~veles_tpu_torch.obs.slo`: time-series rings, windowed
  objectives from ``root.common.obs.slo.*``, burn rates and the three
  autoscaling signals on ``/metrics``.

The per-role scrape endpoints (``scrape``), the flight recorder
(``blackbox``) and ``python -m veles_tpu.obs`` are not ported yet
(ROADMAP.md, 'Slices still to port', item 6(b)).
"""

from veles_tpu_torch.obs import context, slo  # noqa: F401
from veles_tpu_torch.obs.context import (  # noqa: F401
    NULL_CONTEXT, TraceContext, activate, current, current_trace_id,
    ingress, mint, parse, role_lanes, set_process, spans_of, tag,
    waterfall_text, wire_extract, wire_inject)
from veles_tpu_torch.obs.slo import (  # noqa: F401
    AUTOSCALING_SIGNALS, Objective, SeriesRing, SLOEngine,
    standard_engine)
