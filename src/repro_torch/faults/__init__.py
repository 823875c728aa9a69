"""Fault plane: the gate and the timeline events (the plane itself is
not yet ported).

``REPRO_FAULTS=off`` (default): no fault code runs, every trace golden
replays byte-identical. The graceful plane (``on``) and the ungraceful
plane a timeline with fault events gets are not yet ported; the
engines raise `NotImplementedError` for either.
"""
from repro_torch.faults.events import (FLEET_FAULT_EVENTS, DcBlackout,
                                       DcRestore, FaultEvent,
                                       MonitorOutage, NetworkPartition,
                                       PartitionHeal, PredictorFault,
                                       ProbeLoss, ProbeTimeout,
                                       SolverFault, chaos_schedule)
from repro_torch.faults.plane import FAULT_MODES, faults_mode

__all__ = ["FAULT_MODES", "faults_mode", "FaultEvent",
           "DcBlackout", "DcRestore", "NetworkPartition",
           "PartitionHeal", "ProbeTimeout", "ProbeLoss",
           "MonitorOutage", "PredictorFault", "SolverFault",
           "FLEET_FAULT_EVENTS", "chaos_schedule"]
