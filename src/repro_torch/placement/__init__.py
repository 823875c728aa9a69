"""repro_torch.placement — the GDA query layer that consumes WANify BW.

The paper's value proposition is that accurate runtime WAN bandwidth
lets geo-distributed analytics place tasks and data better (§2, §5);
this package is that consumer: a stage-DAG query model with named
workloads (`query.py`), a latency + egress-cost estimator priced
against predicted-BW x heterogeneous connections — with a batched
evaluator that prices thousands of candidates per launch
(`cost.py::estimate_cost_batch`, numpy bit-exact / torch backends) —
a deterministic batched placement search with an exhaustive reference
and a lock-step multi-job driver (`optimizer.py`), a
:class:`PlacementPlanner` that re-places on every controller replan
trigger (`planner.py`), and scripted placement runs with
byte-replayable traces plus the static-BW ablation comparison
(`scenario.py`). See DESIGN.md ("The placement planner", "Batched
placement search").

Port of `repro/placement/`: host numpy as in the JAX package (the
default ``numpy`` backend the pins run on), with the batched
evaluator's device backend in PyTorch (``torch``) in place of the
reference's jit ``jax`` one.
"""
from repro_torch.placement.cost import (INSTANCE_USD_PER_HOUR,
                                  PLACEMENT_BACKENDS, PlacementCost,
                                  PlacementCostBatch, StageCost,
                                  achievable_bw, bottleneck_time_s,
                                  estimate_cost, estimate_cost_batch,
                                  placement_backend, shuffle_matrix)
from repro_torch.placement.optimizer import (PlacementDecision, SearchTask,
                                       better, exhaustive_place,
                                       greedy_place, initial_placement,
                                       search_many)
from repro_torch.placement.planner import (BACKENDS, PlacementPlanner,
                                     PlacementRecord)
from repro_torch.placement.query import (WORKLOADS, QuerySpec, Stage,
                                   get_workload, iterative, scan_agg,
                                   skewed_partitions, two_stage_join,
                                   workload_names)
from repro_torch.placement.scenario import (PlacementScenarioResult,
                                      PlacementStepTrace, PlacementTrace,
                                      compare_backends,
                                      run_placement_scenario)

__all__ = [
    "QuerySpec", "Stage", "skewed_partitions",
    "WORKLOADS", "get_workload", "workload_names",
    "scan_agg", "two_stage_join", "iterative",
    "PlacementCost", "StageCost", "estimate_cost", "achievable_bw",
    "shuffle_matrix", "bottleneck_time_s", "INSTANCE_USD_PER_HOUR",
    "PlacementCostBatch", "estimate_cost_batch", "placement_backend",
    "PLACEMENT_BACKENDS",
    "PlacementDecision", "greedy_place", "exhaustive_place",
    "initial_placement", "better", "SearchTask", "search_many",
    "PlacementPlanner", "PlacementRecord", "BACKENDS",
    "PlacementTrace", "PlacementStepTrace", "PlacementScenarioResult",
    "run_placement_scenario", "compare_backends",
]
