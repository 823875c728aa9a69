"""repro_torch.control — the WANify control plane's closed loop
(snapshot -> prediction -> global optimization -> AIMD -> plan). The
plan -> wire lowering (`schedule.py`) is not yet ported."""
from repro_torch.control.controller import (BudgetEnvelope,
                                            ControllerConfig,
                                            WanifyController)

__all__ = [
    "BudgetEnvelope",
    "ControllerConfig",
    "WanifyController",
]
