"""Fleet trace: per-tick, per-job records with canonical serialization.

Same determinism contract as the single-job scenario trace
(repro_torch.scenarios.trace): two runs of the same fleet scenario with the
same seed must produce byte-identical ``to_json()`` output — per-job
plan signatures, budgets, envelope caps, credited BW, and the
cumulative RF-kernel-launch counter included. Every random draw comes
from the shared simulator's named streams, and the fleet visits jobs
in arrival order, so the draw sequence is replay-stable.

Port of `repro/fleet/trace.py`: the same rows and JSON, so the port's
fleet traces hash to the `fleet/*` pins of
`tests/data/trace_golden.json`.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Tuple

from repro_torch.scenarios.trace import sig_hash


@dataclass
class FleetStepTrace:
    """One fleet tick: fleet-wide counters plus one row per job."""
    tick: int
    events: Tuple[str, ...]          # describe() of events applied now
    n_jobs: int
    kernel_calls: int                # cumulative RF launches (== ticks)
    jobs: Tuple[Dict[str, Any], ...]
    # job row keys: name, priority, budget, cap_min, plan_sig,
    # achieved_min, achieved_mean, conns_total


@dataclass
class FleetTrace:
    """The whole run; `to_json()` is the byte-comparable replay form."""
    scenario: str
    seed: int
    steps: List[FleetStepTrace] = field(default_factory=list)

    def to_json(self) -> str:
        """Canonical bytes for replay comparison (sorted keys, no
        whitespace drift; infinities serialize as `Infinity`, which is
        byte-stable even though it is a JSON extension)."""
        payload = {"scenario": self.scenario, "seed": self.seed,
                   "steps": [asdict(s) for s in self.steps]}
        return json.dumps(payload, sort_keys=True,
                          separators=(",", ":"))

    # ---- convenience views ------------------------------------------
    def job_names(self) -> List[str]:
        """Every job name that ever appears in the trace."""
        seen: List[str] = []
        for s in self.steps:
            for row in s.jobs:
                if row["name"] not in seen:
                    seen.append(row["name"])
        return seen

    def job_series(self, name: str, key: str) -> List[Any]:
        """One job's per-tick values of `key` (ticks it was absent are
        skipped)."""
        return [row[key] for s in self.steps for row in s.jobs
                if row["name"] == name]


def tick_to_step(record: Dict[str, Any],
                 events: Tuple[str, ...] = ()) -> FleetStepTrace:
    """Fold a `FleetController.tick()` record into a trace row (plan
    signatures are hashed here so the trace stays compact)."""
    jobs = tuple(dict(row, plan_sig=sig_hash(row["plan_sig"]))
                 for row in record["jobs"])
    return FleetStepTrace(tick=record["tick"], events=tuple(events),
                          n_jobs=record["n_jobs"],
                          kernel_calls=record["kernel_calls"], jobs=jobs)


@dataclass
class FleetResult:
    """A completed fleet run plus summary helpers."""
    trace: FleetTrace

    def summary(self) -> Dict[str, Any]:
        """Fleet-level rollup: job count range, launches, fairness."""
        steps = self.trace.steps
        last = steps[-1]
        per_job = {}
        for name in self.trace.job_names():
            mins = self.trace.job_series(name, "achieved_min")
            per_job[name] = {
                "ticks": len(mins),
                "achieved_min_mbps": min(mins),
                "achieved_min_mean_mbps": sum(mins) / len(mins),
            }
        return {
            "scenario": self.trace.scenario,
            "seed": self.trace.seed,
            "ticks": len(steps),
            "kernel_calls": last.kernel_calls,
            "n_jobs_final": last.n_jobs,
            "jobs": per_job,
        }
