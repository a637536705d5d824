"""veles_tpu_torch.trace — the span recorder and its exports.

Categories recorded by the port: ``gen`` (prefill and decode dispatch
spans of :mod:`veles_tpu_torch.gen.engine`; enqueue, admit and evict
instants and the per-request and per-phase spans of
:mod:`veles_tpu_torch.gen.scheduler`), ``unit`` (each unit's ``run()``
in a workflow, named after the unit) and ``loader`` (minibatch
serving), ``serve`` (the batch engine's bucket captures and infer
chunks, the batcher's enqueue instants, batch spans and per-request
spans, the HTTP front door's spans) and ``prof`` (recompile instants).
The knob is ``root.common.engine.trace = off | on | <path.json>``: a
path also writes the Perfetto-loadable Chrome trace there at exit
(:mod:`veles_tpu_torch.trace.export`, summarized offline by ``python -m
veles_tpu_torch.trace <trace.json>``).  :func:`device_trace` wraps a
block in ``torch.profiler`` with CUDA activity on the card (a no-op on
the CPU) and writes its Chrome trace.  Categories added by the tooling:
``segment`` (stitched and window ``dispatch`` spans, ``compile``
instants carrying the ledger's cost) and ``watch`` (health checks and
snapshots).
"""

from veles_tpu_torch.trace.core import (  # noqa: F401
    DEFAULT_CAPACITY, NULL_SPAN, TraceRecorder, complete, configure,
    counter, device_trace, enabled, instant, normalize, recorder, set_role,
    span)
from veles_tpu_torch.trace.export import (  # noqa: F401
    chrome_events, load, metrics_text, report_text, save, summary)
