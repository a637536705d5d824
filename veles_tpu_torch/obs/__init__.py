"""veles_tpu_torch.obs: request tracing, the SLO engine, the per-role
scrape endpoint and the flight recorder, the port's counterpart of
:mod:`veles_tpu.obs`.

- :mod:`~veles_tpu_torch.obs.context`: the W3C-compatible trace
  context minted at the serving front door and carried across the
  batcher's and the generative scheduler's thread handoffs;
- :mod:`~veles_tpu_torch.obs.slo`: time-series rings, windowed
  objectives from ``root.common.obs.slo.*``, burn rates and the three
  autoscaling signals on ``/metrics``;
- :mod:`~veles_tpu_torch.obs.scrape`: :class:`ScrapeServer`, a
  ``/metrics`` + ``/healthz`` listener over :func:`default_sources`;
- :mod:`~veles_tpu_torch.obs.blackbox`: the flight recorder, armed by
  ``root.common.obs.blackbox_dir`` (:func:`configure`, called at
  ``Workflow.initialize``).

``python -m veles_tpu.obs`` is not ported yet (ROADMAP.md, 'Slices
still to port', item 7(e)): its cross-process phase drives the job wire
(:mod:`veles_tpu_torch.parallel.jobs`).
"""

from veles_tpu_torch.obs import blackbox, context, scrape, slo  # noqa: F401
from veles_tpu_torch.obs.context import (  # noqa: F401
    NULL_CONTEXT, TraceContext, activate, current, current_trace_id,
    ingress, mint, parse, role_lanes, set_process, spans_of, tag,
    waterfall_text, wire_extract, wire_inject)
from veles_tpu_torch.obs.scrape import (  # noqa: F401
    ScrapeServer, default_sources)
from veles_tpu_torch.obs.slo import (  # noqa: F401
    AUTOSCALING_SIGNALS, Objective, SeriesRing, SLOEngine,
    standard_engine)


def configure():
    """Apply the ``root.common.obs.*`` knobs (re-read at
    ``Workflow.initialize``, where the trace knob is): arms the flight
    recorder when ``blackbox_dir`` is set.  Tracing itself stays under
    ``root.common.engine.trace``."""
    return blackbox.configure()
