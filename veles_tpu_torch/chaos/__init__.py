"""veles_tpu_torch.chaos — deterministic fault injection for the job
layer: the port's counterpart of :mod:`veles_tpu.chaos`.

See :mod:`veles_tpu_torch.chaos.core` for the fault model and knobs.
``python -m veles_tpu_torch.chaos --smoke`` runs the gate: a seeded
master–slave session over the port's job wire with an injected slave
death and frame faults, which must complete with consistent dedup
accounting.
"""

from veles_tpu_torch.chaos.core import (     # noqa: F401 - public API
    PROCESS_ACTIONS, WIRE_ACTIONS, ChaosController, ChaosSchedule,
    Fault, WirePlan, armed, configure, controller)
