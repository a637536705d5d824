"""veles_tpu_torch.gen — continuously-batched generative serving.

Counterpart of :mod:`veles_tpu.gen` in its default configuration
(contiguous KV cache, whole-prompt prefill buckets, float weights, one
device):

- :mod:`model` — the generative model protocol and
  :class:`~veles_tpu_torch.gen.model.TransformerGenModel`, with
  :func:`~veles_tpu_torch.gen.model.params_from_numpy` to carry the JAX
  package's parameters over;
- :mod:`engine` — :class:`~veles_tpu_torch.gen.engine.GenerativeEngine`:
  prefill buckets and one decode step over a device-resident KV cache;
- :mod:`scheduler` — continuous batching
  (:class:`~veles_tpu_torch.gen.scheduler.GenerativeScheduler`) and the
  pad-to-slowest :func:`~veles_tpu_torch.gen.scheduler.static_generate`.

``python -m veles_tpu_torch.gen --smoke`` runs a seeded session and
checks that every request gets exactly its token budget.
"""

from veles_tpu_torch.gen.engine import GenerativeEngine  # noqa: F401
from veles_tpu_torch.gen.model import (  # noqa: F401
    TransformerGenModel, params_from_numpy, params_to_numpy)
from veles_tpu_torch.gen.scheduler import (  # noqa: F401
    GenerativeScheduler, QueueFull, static_generate)

__all__ = [
    "GenerativeEngine", "GenerativeScheduler", "QueueFull",
    "TransformerGenModel", "params_from_numpy", "params_to_numpy",
    "static_generate",
]
