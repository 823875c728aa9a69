"""repro_torch.control — the WANify control plane's closed loop
(snapshot -> prediction -> global optimization -> AIMD -> plan) and the
plan -> per-offset schedule lowering (`schedule.py`; its wire codec is
not yet ported)."""
from repro_torch.control.controller import (BudgetEnvelope,
                                            ControllerConfig,
                                            WanifyController)
from repro_torch.control.schedule import offset_schedule

__all__ = [
    "BudgetEnvelope",
    "ControllerConfig",
    "WanifyController",
    "offset_schedule",
]
