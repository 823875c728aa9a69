"""Online predictor lifecycle: drift detection over free residuals,
cost-aware probe scheduling, and deterministic incremental RF refresh.

Gated by ``$REPRO_LIFECYCLE`` / explicit ``lifecycle=`` arguments
(default off — zero lifecycle code on the historical replay path; the
trace goldens pin this byte-identically). Port of `repro/lifecycle`.
See
:class:`repro_torch.lifecycle.manager.LifecycleManager` for the loop.
"""
from repro_torch.lifecycle.drift import (DriftConfig, DriftSignal,
                                   EwmaDriftDetector, ResidualStats)
from repro_torch.lifecycle.harness import (harvest_scenario_rows,
                                     pretrain_predictor,
                                     run_lifecycle_comparison)
from repro_torch.lifecycle.manager import (LIFECYCLE_MODES, LifecycleConfig,
                                     LifecycleManager, LifecycleRecord,
                                     lifecycle_mode)
from repro_torch.lifecycle.probes import (ProbeConfig, ProbeScheduler,
                                    baseline_probe_spend)
from repro_torch.lifecycle.refresh import (RefreshConfig, decay_seed_data,
                                     refresh_forest)
from repro_torch.lifecycle.window import (SlidingWindow,
                                    WindowedPercentileEstimator)

__all__ = [
    "DriftConfig", "DriftSignal", "EwmaDriftDetector", "ResidualStats",
    "LIFECYCLE_MODES", "LifecycleConfig", "LifecycleManager",
    "LifecycleRecord", "lifecycle_mode",
    "ProbeConfig", "ProbeScheduler", "baseline_probe_spend",
    "RefreshConfig", "decay_seed_data", "refresh_forest",
    "SlidingWindow", "WindowedPercentileEstimator",
    "harvest_scenario_rows", "pretrain_predictor",
    "run_lifecycle_comparison",
]
