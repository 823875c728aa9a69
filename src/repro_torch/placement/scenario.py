"""Event-driven placement runs — the paper's §5 latency/cost story
under scripted WAN dynamics, with byte-replayable traces.

`run_placement_scenario` rides a named scenario (repro.scenarios) with
a :class:`PlacementPlanner` attached to the engine's controller: every
step, after the closed loop has reacted to the timeline's events, the
query's current placement is *executed* against the simulator's
ground-truth water-fill (at the plan's heterogeneous connections for
the ``wanify`` backend, at single connections for the ``static``
ablation) and one :class:`PlacementStepTrace` row is appended. Same
spec + seed + backend replays to byte-identical
:meth:`PlacementTrace.to_json` output — the planner is deterministic
(no RNG in the search) and the simulator's named streams make the WAN
evolution identical across runs, so the two backends of
:func:`compare_backends` see the *same* network weather.

Port of `repro/placement/scenario.py`, riding the port's
`ScenarioEngine` through its per-step tap (`step_hook`). With the
overlay on, the ground truth is the routed water-fill
(`WanSimulator.waterfill_routed`).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.placement.planner import PlacementPlanner
from repro_torch.placement.query import QuerySpec, scan_agg
from repro_torch.scenarios.engine import ScenarioEngine, ScenarioSpec
from repro_torch.scenarios.events import Rescale
from repro_torch.scenarios.library import get_scenario


@dataclass
class PlacementStepTrace:
    """One step of a placement run: what the placement in force costs
    under that step's ground-truth achieved BW."""

    step: int
    events: Tuple[str, ...]          # events applied this step
    replaced: bool                   # did the planner re-place now?
    plan_sig: str                    # controller plan in force (hash)
    makespan_s: float                # simulated query makespan
    net_s: float
    egress_usd: float
    achieved_min: float              # min pod-pair BW the query saw
    placement: Tuple[Tuple[float, ...], ...]


@dataclass
class PlacementTrace:
    """A whole placement run; `to_json()` is the byte-comparable form."""

    scenario: str
    query: str
    backend: str
    seed: int
    steps: List[PlacementStepTrace] = field(default_factory=list)

    def to_json(self) -> str:
        """Canonical bytes for replay comparison (sorted keys, no
        whitespace drift)."""
        payload = {"scenario": self.scenario, "query": self.query,
                   "backend": self.backend, "seed": self.seed,
                   "steps": [asdict(s) for s in self.steps]}
        return json.dumps(payload, sort_keys=True,
                          separators=(",", ":"))

    def replaced_steps(self) -> List[int]:
        """Steps at which the planner re-placed the query."""
        return [s.step for s in self.steps if s.replaced]


@dataclass
class PlacementScenarioResult:
    """A completed placement run plus summary helpers."""

    trace: PlacementTrace
    records: Tuple[Any, ...]         # the planner's PlacementRecords

    def summary(self) -> Dict[str, Any]:
        """Roll the run up into one benchmark row."""
        steps = self.trace.steps
        return {
            "scenario": self.trace.scenario,
            "query": self.trace.query,
            "backend": self.trace.backend,
            "seed": self.trace.seed,
            "steps": len(steps),
            "makespan_total_s": sum(s.makespan_s for s in steps),
            "makespan_mean_s": sum(s.makespan_s for s in steps)
            / max(len(steps), 1),
            "makespan_final_s": steps[-1].makespan_s if steps else 0.0,
            "egress_usd_total": sum(s.egress_usd for s in steps),
            "replacements": sum(1 for s in steps if s.replaced),
        }


def _round_placement(p: np.ndarray) -> Tuple[Tuple[float, ...], ...]:
    """Trace form of a placement (6-decimal, deterministic)."""
    return tuple(tuple(round(float(v), 6) for v in row) for row in p)


def run_placement_scenario(spec: Union[str, ScenarioSpec],
                           query: Optional[QuerySpec] = None,
                           seed: int = 0, backend: str = "wanify",
                           predictor: Any = None,
                           overlay: Optional[str] = None
                           ) -> PlacementScenarioResult:
    """Drive one scenario with a placement planner riding the loop.

    `spec` is a named scenario or a full :class:`ScenarioSpec`
    (timelines containing `Rescale` are rejected — a placed query's DC
    span is fixed); `query` defaults to the `scan_agg` workload over
    the spec's pod count. `overlay` gates Terra-style relay routing
    (None defers to $REPRO_OVERLAY): when on, the ``wanify`` backend
    prices AND executes against the routed surface — relayed pairs
    carry their store-and-forward credit in the ground-truth fill.
    """
    if isinstance(spec, str):
        spec = get_scenario(spec)
    if any(isinstance(t.event, Rescale) for t in spec.events):
        raise ValueError(
            f"scenario {spec.name!r} rescales the pod count mid-run; a "
            f"placed query spans a fixed DC set — use a non-elastic "
            f"timeline for placement runs")
    if query is None:
        query = scan_agg(spec.n_pods)
    eng = ScenarioEngine(spec, seed=seed, predictor=predictor,
                         overlay=overlay)
    planner = PlacementPlanner(eng.controller, query, backend=backend)
    trace = PlacementTrace(scenario=spec.name, query=query.name,
                           backend=backend, seed=seed)
    seen = [len(planner.records)]

    def hook(engine: ScenarioEngine, row) -> None:
        P = engine.controller.n_pods
        routing = None
        if backend == "wanify":
            conns = engine.controller.current_conns()
            routing = engine.controller.current_routing()
        else:
            conns = np.ones((engine.sim.N, engine.sim.N))
        if routing is None:
            true_bw = engine.sim.waterfill(conns)[:P, :P]
        else:
            true_bw = engine.sim.waterfill_routed(*routing)[:P, :P]
        cost = planner.evaluate(true_bw)
        off = ~np.eye(P, dtype=bool)
        trace.steps.append(PlacementStepTrace(
            step=row.step, events=row.events,
            replaced=len(planner.records) > seen[0],
            plan_sig=row.plan_sig,
            makespan_s=float(cost.makespan_s),
            net_s=float(cost.net_s),
            egress_usd=float(cost.egress_usd),
            achieved_min=float(true_bw[off].min()),
            placement=_round_placement(planner.placement)))
        seen[0] = len(planner.records)

    eng.step_hook = hook
    eng.run()
    return PlacementScenarioResult(trace=trace,
                                   records=tuple(planner.records))


def compare_backends(spec: Union[str, ScenarioSpec],
                     query: Optional[QuerySpec] = None,
                     seed: int = 0) -> Dict[str, Any]:
    """The paper's comparison on one scenario: WANify-predicted-BW
    placement vs the static single-connection ablation, same seed, same
    WAN weather. Positive deltas mean WANify is better (lower)."""
    wan = run_placement_scenario(spec, query=query, seed=seed,
                                 backend="wanify").summary()
    static = run_placement_scenario(spec, query=query, seed=seed,
                                    backend="static").summary()
    return {
        "scenario": wan["scenario"],
        "query": wan["query"],
        "seed": seed,
        "wanify": wan,
        "static": static,
        "latency_delta_pct": (1.0 - wan["makespan_total_s"]
                              / max(static["makespan_total_s"], 1e-9))
        * 100.0,
        "egress_delta_pct": (1.0 - wan["egress_usd_total"]
                             / max(static["egress_usd_total"], 1e-9))
        * 100.0,
    }
