"""GDA query model (paper §2) — the analytics workload whose placement
WANify's runtime-BW gauging improves.

A geo-distributed query is a chain of stages over per-DC input
partitions: stage 0 (the map) processes each partition where it sits;
every later stage is placed — a per-DC task-fraction vector decides
where its tasks (and therefore the shuffle's destination bytes) go.
Between consecutive stages the intermediate data is shuffled all-to-all
(DC i ships `held_i * frac_j` to DC j), which is exactly the transfer
matrix the paper's Fig. 2d bottleneck formula prices against per-pair
runtime BW.

The model deliberately carries the paper's three heterogeneity knobs:

  * skewed partitions (§3.3.1) — `skewed_partitions` builds per-DC
    input sizes with a deterministic skew factor;
  * heterogeneous compute (§5.4) — `QuerySpec.compute_speed` scales
    each DC's task throughput;
  * varying DC count (§3.3.2 / §5.5) — every workload builder takes
    `n` so the same query shape spans 3..8 DCs.

`WORKLOADS` names the library: a TPC-style scan→aggregate, a two-stage
join (two shuffles), and an iterative multi-wave job whose shuffle
repeats (PageRank-style) so network time dominates.

Volumes are in Gb (gigabits), matching the benchmark query model; the
cost layer (`repro_torch.placement.cost`) converts to GB for egress
pricing.

Port of `repro/placement/query.py` (numpy, unchanged).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Stage:
    """One query stage.

    `out_ratio` is output Gb per input Gb (selectivity), `compute_s_per_gb`
    the task time per input Gb at unit compute speed, and `waves` repeats
    the stage's shuffle+compute (iterative jobs re-shuffle the same
    volume every wave).
    """

    name: str
    out_ratio: float
    compute_s_per_gb: float
    waves: int = 1


@dataclass(frozen=True)
class QuerySpec:
    """A named stage chain over per-DC input partitions.

    `input_gb` are the per-DC partition sizes (Gb); stage 0 runs in
    place on them, and each of the remaining `n_shuffles()` stages is
    placed by a task-fraction vector. `compute_speed` (default all
    ones) is the per-DC relative task throughput — the §5.4
    heterogeneous-compute knob.
    """

    name: str
    input_gb: Tuple[float, ...]
    stages: Tuple[Stage, ...]
    compute_speed: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        """Validate shapes and positivity once, at construction."""
        if len(self.stages) < 1:
            raise ValueError("a query needs at least one stage")
        if len(self.input_gb) < 2:
            raise ValueError("a GDA query spans >= 2 DCs")
        if any(v < 0 for v in self.input_gb):
            raise ValueError("input partition sizes must be >= 0")
        if self.compute_speed is not None and \
                len(self.compute_speed) != len(self.input_gb):
            raise ValueError(
                f"compute_speed has {len(self.compute_speed)} entries "
                f"for {len(self.input_gb)} DCs")

    @property
    def n(self) -> int:
        """Number of DCs the query spans."""
        return len(self.input_gb)

    def n_shuffles(self) -> int:
        """Number of placed stages (= shuffle boundaries)."""
        return len(self.stages) - 1

    def inputs(self) -> np.ndarray:
        """Per-DC input partition sizes as an array (Gb)."""
        return np.asarray(self.input_gb, np.float64)

    def speeds(self) -> np.ndarray:
        """Per-DC compute speeds (default all ones)."""
        if self.compute_speed is None:
            return np.ones(self.n)
        return np.asarray(self.compute_speed, np.float64)


def skewed_partitions(n: int, total_gb: float,
                      skew: float = 1.0) -> Tuple[float, ...]:
    """Deterministic per-DC partition sizes summing to `total_gb`:
    DC 0 carries `skew`x the weight of DC n-1, linear in between
    (the §3.3.1 data-skew knob, reproducible without an RNG)."""
    if n < 2:
        raise ValueError("need >= 2 DCs")
    w = np.array([1.0 + (skew - 1.0) * (n - 1 - i) / (n - 1)
                  for i in range(n)])
    w = np.maximum(w, 1e-6)
    return tuple(float(v) for v in w / w.sum() * total_gb)


# ----------------------------------------------------------------------
# The workload library — named, deterministic query shapes
# ----------------------------------------------------------------------
def scan_agg(n: int, total_gb: float = 60.0, skew: float = 2.0,
             speed: Optional[Tuple[float, ...]] = None) -> QuerySpec:
    """TPC-style scan -> aggregate: one selective map, one shuffle into
    a cheap reduction (the paper's light query class, e.g. q82/q95)."""
    return QuerySpec(
        name="scan_agg",
        input_gb=skewed_partitions(n, total_gb, skew),
        stages=(Stage("scan", out_ratio=0.4, compute_s_per_gb=2.0),
                Stage("agg", out_ratio=0.05, compute_s_per_gb=1.0)),
        compute_speed=speed)


def two_stage_join(n: int, total_gb: float = 90.0, skew: float = 3.0,
                   speed: Optional[Tuple[float, ...]] = None) -> QuerySpec:
    """Two-shuffle join: scan -> join (output grows) -> aggregate (the
    paper's heavy class, e.g. q78 — two placed stages couple through
    the first stage's destination distribution)."""
    return QuerySpec(
        name="two_stage_join",
        input_gb=skewed_partitions(n, total_gb, skew),
        stages=(Stage("scan", out_ratio=0.6, compute_s_per_gb=1.5),
                Stage("join", out_ratio=1.2, compute_s_per_gb=3.0),
                Stage("agg", out_ratio=0.1, compute_s_per_gb=1.0)),
        compute_speed=speed)


def iterative(n: int, total_gb: float = 40.0, skew: float = 1.5,
              waves: int = 5,
              speed: Optional[Tuple[float, ...]] = None) -> QuerySpec:
    """Iterative multi-wave job (PageRank-style): one placed stage whose
    shuffle+compute repeats `waves` times, so the network term — and
    therefore BW-aware placement — dominates the makespan."""
    return QuerySpec(
        name="iterative",
        input_gb=skewed_partitions(n, total_gb, skew),
        stages=(Stage("prepare", out_ratio=1.0, compute_s_per_gb=1.0),
                Stage("iterate", out_ratio=1.0, compute_s_per_gb=2.0,
                      waves=waves)),
        compute_speed=speed)


WORKLOADS: Dict[str, Callable[..., QuerySpec]] = {
    "scan_agg": scan_agg,
    "two_stage_join": two_stage_join,
    "iterative": iterative,
}


def get_workload(name: str, n: int, **kwargs) -> QuerySpec:
    """Build a named workload over `n` DCs (KeyError lists the names)."""
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; "
                       f"have {sorted(WORKLOADS)}")
    return WORKLOADS[name](n, **kwargs)


def workload_names() -> List[str]:
    """All named workloads, library order."""
    return list(WORKLOADS)
