"""veles_tpu_torch.pod: a stitched workflow trained as a data-parallel
pod over ``torch.distributed`` ranks.  The port's counterpart of
:mod:`veles_tpu.pod`'s mesh half: :class:`PodRuntime` (the rank's
segment programs, the reshard), the in-process membership helpers and
the device-loss detector, and :class:`MultiHostPod`.  The lease half
(:class:`PodMaster`, :class:`PodWorker`, :class:`MultiHostPodWorker`,
``python -m veles_tpu.pod``'s lease phases) rides the job protocol,
ROADMAP item 7(e), and raises naming it.
"""

from veles_tpu_torch.pod.membership import (  # noqa: F401
    DeviceLossDetector, PodMaster, PodWorker, capture_params,
    eval_metrics, install_params, is_device_loss, train_epochs)
from veles_tpu_torch.pod.pods import (  # noqa: F401
    MultiHostPod, MultiHostPodWorker)
from veles_tpu_torch.pod.runtime import (  # noqa: F401
    PodError, PodRuntime, spec_for_vector)
