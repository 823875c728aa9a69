"""repro_torch.fleet — multi-job WAN sharing with batched RF prediction.

N concurrent WANify jobs share ONE simulated WAN: an arbiter splits
the per-host connection budget and contended-link capacity by
priority-weighted fair share BEFORE each job plans, every job's RF
inference batches into a single CUDA kernel launch per fleet tick,
and achieved BW is credited per tenant from one fleet-wide water-fill.
Scenarios, traces and the fused tick are not yet ported.
"""
from repro_torch.fleet.arbiter import (arbitrate, connection_budgets,
                                       link_shares)
from repro_torch.fleet.controller import FleetController, FleetJob, JobSpec
from repro_torch.fleet.predictor import (BatchedRfPredictor,
                                         default_fleet_forest)
from repro_torch.fleet.tenant import TenantView

__all__ = [
    "FleetController", "FleetJob", "JobSpec",
    "TenantView",
    "BatchedRfPredictor", "default_fleet_forest",
    "arbitrate", "connection_budgets", "link_shares",
]
