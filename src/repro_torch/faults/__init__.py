"""Fault plane: chaos injection + graceful degradation (gated; port of
`repro.faults`).

``REPRO_FAULTS=off`` (default): no fault code runs, every trace golden
replays byte-identical. ``on``: engines construct a graceful
:class:`FaultPlane` and the control loop degrades through the ladder
(retry → bounded staleness → SnapshotPredictor rung → quarantine →
plan rollback) instead of crashing. Timelines that script fault events
under the off gate get an ungraceful plane — the naive-crash ablation
the chaos harness (:mod:`repro_torch.faults.harness`) compares
against.
"""
from repro_torch.faults.events import (FLEET_FAULT_EVENTS, DcBlackout,
                                       DcRestore, FaultEvent,
                                       MonitorOutage, NetworkPartition,
                                       PartitionHeal, PredictorFault,
                                       ProbeLoss, ProbeTimeout,
                                       SolverFault, chaos_schedule)
from repro_torch.faults.plane import (FAULT_MODES, FaultConfig, FaultPlane,
                                      ProbeTimeoutError, faults_mode)

__all__ = ["FAULT_MODES", "FaultConfig", "FaultPlane",
           "ProbeTimeoutError", "faults_mode", "FaultEvent",
           "DcBlackout", "DcRestore", "NetworkPartition",
           "PartitionHeal", "ProbeTimeout", "ProbeLoss",
           "MonitorOutage", "PredictorFault", "SolverFault",
           "FLEET_FAULT_EVENTS", "chaos_schedule"]
