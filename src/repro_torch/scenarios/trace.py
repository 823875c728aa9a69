"""Structured per-step scenario trace + canonical serialization.

The trace is the determinism contract: two runs of the same scenario
with the same seed must produce byte-identical ``to_json()`` output —
same replan steps, same reasons, same plan signatures, same BW floats.
That holds because every random draw comes from the simulator's named
streams (see wan/simulator.py) and the engine performs the same calls
in the same order each run; nothing reads the wall clock.

Port of `repro/scenarios/trace.py`: the same fields, the same
`sig_hash` and the same canonical JSON, so the port's traces hash to
the pins in `tests/data/trace_golden.json`.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Tuple


def sig_hash(signature: Any) -> str:
    """Short stable hash of a WanPlan.signature() tuple."""
    return hashlib.md5(repr(signature).encode()).hexdigest()[:12]


@dataclass
class StepTrace:
    """One engine step: what happened, what a per-step monitor sample
    shows (the engine's own iftop analogue, taken every step — the
    controller itself only measures on replans), what the controller
    believed at its last replan (predicted), and what the network
    actually delivered (achieved ground truth)."""
    step: int
    events: Tuple[str, ...]          # describe() of events applied now
    dt: float                        # synthetic step wall time (s)
    achieved_min: float              # over pod off-diagonal pairs, Mbps
    achieved_mean: float
    monitored_min: float
    monitored_mean: float
    predicted_min: float             # from the last replan's prediction
    predicted_mean: float
    plan_sig: str                    # sig_hash of the plan now in force
    n_pods: int
    conns_total: int                 # sum of the plan's off-diag conns
    replans: Tuple[Dict[str, Any], ...]   # {reason, step, signature} now
    cache_builds: int                # cumulative lowerings
    cache_hits: int                  # cumulative compile-cache reuses


@dataclass
class ScenarioTrace:
    """The whole run; `to_json()` is the byte-comparable replay form."""

    scenario: str
    seed: int
    steps: List[StepTrace] = field(default_factory=list)

    def to_json(self) -> str:
        """Canonical bytes for replay comparison (sorted keys, no
        whitespace drift)."""
        payload = {"scenario": self.scenario, "seed": self.seed,
                   "steps": [asdict(s) for s in self.steps]}
        return json.dumps(payload, sort_keys=True,
                          separators=(",", ":"))

    # ---- convenience views ------------------------------------------
    def replan_steps(self, reason: str | None = None) -> List[int]:
        """Steps that replanned (optionally only for one reason)."""
        return [s.step for s in self.steps for r in s.replans
                if reason is None or r["reason"] == reason]

    def replan_reasons(self) -> List[str]:
        """Every replan reason, in trace order."""
        return [r["reason"] for s in self.steps for r in s.replans]

    def signatures(self) -> List[str]:
        """The in-force plan signature hash per step."""
        return [s.plan_sig for s in self.steps]


@dataclass
class ScenarioResult:
    """A completed run plus summary helpers."""

    trace: ScenarioTrace
    payload_mb: float                # per-step ring payload

    def summary(self) -> Dict[str, Any]:
        """Roll the trace up into the benchmark-row dict."""
        steps = self.trace.steps
        reasons: Dict[str, int] = {}
        for r in self.trace.replan_reasons():
            reasons[r] = reasons.get(r, 0) + 1
        total_dt = sum(s.dt for s in steps)
        return {
            "scenario": self.trace.scenario,
            "seed": self.trace.seed,
            "steps": len(steps),
            "replans": reasons,
            "throughput_mbps": (len(steps) * self.payload_mb * 8.0
                                / max(total_dt, 1e-9)),
            "achieved_min_mbps": min(s.achieved_min for s in steps),
            "achieved_mean_mbps": (sum(s.achieved_mean for s in steps)
                                   / len(steps)),
            "distinct_plans": len(set(self.trace.signatures())),
            "cache_builds": steps[-1].cache_builds,
            "cache_hits": steps[-1].cache_hits,
        }
