"""repro_torch.fleet — multi-job WAN sharing with batched RF prediction.

N concurrent WANify jobs share ONE simulated WAN: an arbiter splits
the per-host connection budget and contended-link capacity by
priority-weighted fair share BEFORE each job plans, every job's RF
inference batches into a single CUDA kernel launch per fleet tick,
and achieved BW is credited per tenant from one fleet-wide water-fill.
`scenario.py` drives the fleet through scripted timelines with
replayable traces (`trace.py`); `fused.py` runs the whole tick as
tensor programs on the device (`FleetController.run_fused`).
"""
from repro_torch.fleet.arbiter import (arbitrate, connection_budgets,
                                       link_shares)
from repro_torch.fleet.controller import FleetController, FleetJob, JobSpec
from repro_torch.fleet.fused import FusedFleet, make_schedule
from repro_torch.fleet.predictor import (BatchedRfPredictor,
                                         default_fleet_forest)
from repro_torch.fleet.scenario import (FLEET_SCENARIOS, FleetEngine,
                                        FleetScenarioSpec,
                                        fleet_scenario_names,
                                        get_fleet_scenario,
                                        run_fleet_scenario)
from repro_torch.fleet.tenant import TenantView
from repro_torch.fleet.trace import (FleetResult, FleetStepTrace,
                                     FleetTrace, tick_to_step)

__all__ = [
    "FleetController", "FleetJob", "JobSpec",
    "FusedFleet", "make_schedule",
    "TenantView",
    "BatchedRfPredictor", "default_fleet_forest",
    "arbitrate", "connection_budgets", "link_shares",
    "FleetEngine", "FleetScenarioSpec", "run_fleet_scenario",
    "FLEET_SCENARIOS", "get_fleet_scenario", "fleet_scenario_names",
    "FleetResult", "FleetStepTrace", "FleetTrace", "tick_to_step",
]
