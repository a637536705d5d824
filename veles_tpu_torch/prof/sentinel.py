"""The recompile sentinel: a steady-state recapture is flagged, never
silent.  The port's counterpart of :mod:`veles_tpu.prof.sentinel`.

The compile point the port has is the batch serving engine's bucket
(:mod:`veles_tpu_torch.serve.engine`): :meth:`InferenceEngine.warmup`
marks the engine warmed, and any bucket capture after that (a new
bucket, or a recapture because a tensor the graph reads moved) is a
steady-state recompile and goes through :func:`flag_recompile`.

The knob: ``root.common.engine.recompile_sentinel = off | warn
(default) | strict``.  ``warn`` logs and emits a ``prof:recompile``
trace instant; ``strict`` raises the analyzer's ``PreflightError`` in
the JAX package, and ``analyze/`` is not ported, so here it raises
``NotImplementedError`` naming ROADMAP item 7(e) (after the event is
recorded and logged).
"""

import logging

from veles_tpu_torch import trace
from veles_tpu_torch.config import root

#: the sentinel's rule id in flagged findings
RULE = "V-P01"


def mode():
    """``off`` | ``warn`` | ``strict`` (default ``warn``)."""
    value = str(root.common.engine.get("recompile_sentinel",
                                       "warn")).lower()
    return value if value in ("off", "warn", "strict") else "warn"


#: flagged steady-state recompiles this process, newest last:
#: ``{"site", "detail"}`` dicts
flagged = []

_logger = logging.getLogger("veles_tpu_torch.prof")


def flag_recompile(site, old_fp, new_fp, logger=None, detail=None):
    """A steady-state recompile happened at ``site`` (``detail`` says
    how; the port's compile points take no signature fingerprints, so
    ``old_fp`` and ``new_fp`` are unused).  Always recorded; ``warn``
    and ``strict`` emit the trace instant and a WARNING; ``strict`` then
    raises (see the module docstring)."""
    event = {"site": site, "detail": detail}
    flagged.append(event)
    if mode() == "off":
        return
    trace.instant("prof", "recompile", dict(event))
    (logger or _logger).warning(
        "%s: steady-state recompile at %s: %s — a warmed program "
        "retraced; root.common.engine.recompile_sentinel=strict "
        "turns this into an error", RULE, site, detail)
    if mode() == "strict":
        raise NotImplementedError(
            "recompile_sentinel='strict' raises the analyzer's "
            "PreflightError, and analyze/ is not ported to "
            "veles_tpu_torch yet (ROADMAP.md, 'Slices still to port', "
            "item 7(e)); the recompile at %s: %s" % (site, detail))


def reset():
    """Drop flagged events (test isolation)."""
    del flagged[:]
