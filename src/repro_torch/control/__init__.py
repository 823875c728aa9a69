"""repro_torch.control — the WANify control plane's closed loop
(snapshot -> prediction -> global optimization -> AIMD -> plan) and the
plan -> wire lowering (`schedule.py`: the per-offset schedule and the
quantizing wire codec)."""
from repro_torch.control.controller import (BudgetEnvelope,
                                            ControllerConfig,
                                            WanifyController)
from repro_torch.control.schedule import (offset_schedule, wire_decode,
                                          wire_encode)

__all__ = [
    "BudgetEnvelope",
    "ControllerConfig",
    "WanifyController",
    "offset_schedule",
    "wire_decode",
    "wire_encode",
]
