"""veles_tpu_torch.analyze: the analyzer's findings and the generative
serving preflight.  The port's counterpart of :mod:`veles_tpu.analyze`,
trimmed to what a generative deploy runs:

- :mod:`~veles_tpu_torch.analyze.findings`: :class:`Finding`,
  :class:`Report` and :func:`rule_catalog`, copied;
- :mod:`~veles_tpu_torch.analyze.pricing`: the HBM budget rule and the
  params bytes, over the card that is present;
- :mod:`~veles_tpu_torch.analyze.shapes`: rule V-S01,
  :func:`check_generative`, which
  :meth:`veles_tpu_torch.serve.registry.ModelRegistry.preflight_generative`
  runs at every generative deploy;
- :class:`PreflightError`, raised by a ``fail`` preflight.

Not ported yet (ROADMAP.md, 'Slices still to port', item 7(e)):
``analyze_workflow`` and its passes (the graph doctor, the rest of the
shape pass, the planner, the knob and lint packs) and ``python -m
veles_tpu.analyze``, so the workflow preflight of
:meth:`~veles_tpu_torch.serve.registry.ModelRegistry.preflight` still
refuses ``warn`` and ``fail``.
"""

from veles_tpu_torch.analyze.findings import (  # noqa: F401
    Finding, Report, rule_catalog)
from veles_tpu_torch.analyze.shapes import check_generative  # noqa: F401


class PreflightError(Exception):
    """A pre-flight analysis found errors and the configured policy is
    ``fail``: the rendered report rides in ``args[0]``, the
    :class:`Report` in :attr:`report`."""

    def __init__(self, report):
        super(PreflightError, self).__init__(report.render_text())
        self.report = report
