"""veles_tpu_torch.trace — the span recorder the serving path calls.

Categories recorded by the port: ``gen`` (prefill and decode dispatch
spans of :mod:`veles_tpu_torch.gen.engine`; enqueue, admit and evict
instants and the per-request spans of
:mod:`veles_tpu_torch.gen.scheduler`), ``unit`` (each unit's ``run()``
in a workflow, named after the unit) and ``loader`` (minibatch
serving), ``serve`` (the batch engine's bucket captures and infer
chunks, the batcher's enqueue instants, batch spans and per-request
spans, the HTTP front door's spans) and ``prof`` (recompile instants).  The knob is
``root.common.engine.trace = off | on``.
"""

from veles_tpu_torch.trace.core import (  # noqa: F401
    DEFAULT_CAPACITY, NULL_SPAN, TraceRecorder, complete, configure,
    counter, enabled, instant, metrics_text, normalize, recorder,
    set_role, span)
