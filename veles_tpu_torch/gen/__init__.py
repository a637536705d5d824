"""veles_tpu_torch.gen — continuously-batched generative serving.

Counterpart of :mod:`veles_tpu.gen` on one device with float or int8
(W8A16, :meth:`~veles_tpu_torch.gen.engine.GenerativeEngine
.quantize_int8`) weights, in both KV layouts (a contiguous cache or the
paged block pool), with whole-prompt or chunked prefill, the radix
prefix cache and speculative decode:

- :mod:`model` — the generative model protocol and
  :class:`~veles_tpu_torch.gen.model.TransformerGenModel`, with
  :func:`~veles_tpu_torch.gen.model.params_from_numpy` to carry the JAX
  package's parameters over;
- :mod:`engine` — :class:`~veles_tpu_torch.gen.engine.GenerativeEngine`:
  prefill buckets (or chunks) and one decode step over a device-resident
  KV cache; the speculative proposers (:class:`~veles_tpu_torch.gen
  .engine.NGramProposer`, registered draft models);
- :mod:`paged` — :class:`~veles_tpu_torch.gen.paged.BlockPool`, the
  page accounting of the paged cache, and :class:`~veles_tpu_torch.gen
  .paged.PoolExhausted`;
- :mod:`prefix` — :class:`~veles_tpu_torch.gen.prefix.PrefixCache`, the
  radix tree of shared prompt pages;
- :mod:`scheduler` — continuous batching
  (:class:`~veles_tpu_torch.gen.scheduler.GenerativeScheduler`) and the
  pad-to-slowest :func:`~veles_tpu_torch.gen.scheduler.static_generate`.

``python -m veles_tpu_torch.gen --smoke`` runs a seeded session (every
request exactly its token budget), the same workload through a paged
engine whose pool is too small, chunked, which must preempt and still
give the contiguous session's streams, an int8 engine against its float
twin, and a prefix-cached, speculative paged engine against a plain
one.
"""

from veles_tpu_torch.gen.engine import (  # noqa: F401
    DRAFT_MODELS, GenerativeEngine, NGramProposer, register_draft_model)
from veles_tpu_torch.gen.model import (  # noqa: F401
    TransformerGenModel, params_from_numpy, params_to_numpy)
from veles_tpu_torch.gen.paged import BlockPool, PoolExhausted  # noqa: F401
from veles_tpu_torch.gen.prefix import PrefixCache  # noqa: F401
from veles_tpu_torch.gen.scheduler import (  # noqa: F401
    GenerativeScheduler, QueueFull, static_generate)

__all__ = [
    "BlockPool", "DRAFT_MODELS", "GenerativeEngine", "GenerativeScheduler",
    "NGramProposer", "PoolExhausted", "PrefixCache", "QueueFull",
    "TransformerGenModel", "params_from_numpy", "params_to_numpy",
    "register_draft_model", "static_generate",
]
