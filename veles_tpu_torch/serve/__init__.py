"""veles_tpu_torch.serve: dynamic-batching model serving over captured
bucket graphs, and generative serving behind the same registry and
front end.  The port's counterpart of :mod:`veles_tpu.serve`:

- :mod:`engine`: :class:`InferenceEngine`, the trained workflow's
  forward (the lowered route at inference, or the forward-unit chain)
  with its params on the device and one CUDA graph per power-of-two
  batch bucket, so steady-state serving never captures;
- :mod:`batcher`: :class:`DynamicBatcher`, which coalesces concurrent
  requests into one padded bucket call and sheds load
  (:class:`QueueFull` → HTTP 503);
- :mod:`registry`: :class:`ModelRegistry`, named models hot-swapped
  atomically, replica sets and canaries, and generative models
  (``deploy_generative``: the V-S01 preflight, a continuous-batching
  scheduler a name, drain swaps);
- :mod:`server`: :class:`ServingServer`, the threaded HTTP front end
  (``POST /service[/<name>]``, ``POST /generate[/<name>]`` whole or as
  an ndjson stream, ``/healthz``, ``/metrics``);
- :mod:`metrics`: :class:`ServingMetrics`;
- :mod:`wire`: request decoding (JSON lists or base64 numpy).

``veles_tpu_torch.restful_api.RESTfulAPI`` is the in-workflow adapter
over these parts; the generative engine and scheduler are
:mod:`veles_tpu_torch.gen`.  A snapshot
(:mod:`veles_tpu_torch.snapshotter`) is served through
``InferenceEngine.from_snapshot`` or ``ModelRegistry.load_snapshot``.
Not ported yet (ROADMAP.md, 'Slices still to port'): fleets and meshes
(7(d)), the workflow preflight's analyzer and ``notify_status`` (7(e)).
"""

from veles_tpu_torch.serve.batcher import (DynamicBatcher,
                                           InferDeadlineExceeded,
                                           QueueFull)
from veles_tpu_torch.serve.engine import InferenceEngine
from veles_tpu_torch.serve.metrics import ServingMetrics
from veles_tpu_torch.serve.registry import ModelRegistry, ReplicaSet
from veles_tpu_torch.serve.server import ServingServer
from veles_tpu_torch.serve.wire import decode_gen_request, decode_input

__all__ = [
    "DynamicBatcher", "InferDeadlineExceeded", "InferenceEngine",
    "ModelRegistry", "QueueFull", "ReplicaSet", "ServingMetrics",
    "ServingServer", "decode_gen_request", "decode_input",
]
