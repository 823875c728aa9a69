"""Fleet scenarios: scripted multi-job timelines with replayable traces.

The single-job scenario engine (repro_torch.scenarios) stresses ONE closed
loop; the fleet engine drives a whole :class:`FleetController` through
the same `at(step, event)` DSL — WAN events (`LinkDegrade`,
`CrossTraffic`, `DiurnalCycle`, ...) mutate the shared simulator, and
the fleet events (`JobArrive`/`JobDepart`/`PriorityShift`) churn the
job set. Each tick appends a :class:`FleetStepTrace` row; same spec +
same seed replays to byte-identical `FleetTrace.to_json()` output.

`notify=True` WAN events are a single-job-engine concept (fleet ticks
replan every job each epoch); use the silent variants here.

Port of `repro/fleet/scenario.py`. The engine takes one argument the
reference's does not: `device`, where the shared forest's
`BatchedRfPredictor` runs (None = CUDA, which raises without a card;
``"cpu"`` = the plain version), so a fleet scenario on the card makes
one `rf_predict` launch per tick. The fault plane is not yet ported:
``faults`` resolving to ``on``, a plane object, or a fault event in
the timeline raises `NotImplementedError` at construction.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.faults.events import FLEET_FAULT_EVENTS, FaultEvent
from repro_torch.faults.plane import faults_mode
from repro_torch.fleet.controller import FleetController, JobSpec
from repro_torch.fleet.predictor import (BatchedRfPredictor,
                                         default_fleet_forest)
from repro_torch.fleet.trace import FleetResult, FleetTrace, tick_to_step
from repro_torch.scenarios.events import (CrossTraffic, DiurnalCycle,
                                          JobArrive, JobDepart, LinkDegrade,
                                          LinkRestore, PriorityShift, Timed,
                                          at)
from repro_torch.wan.simulator import WanSimulator

QUIET = dict(fluct_sigma=0.0, snapshot_sigma=0.0, runtime_sigma=0.0)

# Events a fleet timeline may carry. Single-job workload events
# (Rescale, SkewRamp, Straggler, ProviderShift) target the single-job
# engine's synthetic workload / controller and would silently no-op or
# crash here, so they are rejected at spec validation instead. Of the
# fault events, only the reachability ones are job-agnostic WAN state;
# the control-plane faults (ProbeTimeout, MonitorOutage, ...) target
# the single-job capture path and stay rejected.
FLEET_EVENTS = (LinkDegrade, LinkRestore, CrossTraffic, DiurnalCycle,
                JobArrive, JobDepart, PriorityShift) + FLEET_FAULT_EVENTS


@dataclass
class FleetScenarioSpec:
    """A named, replayable multi-job timeline."""
    name: str
    steps: int
    jobs: Tuple[JobSpec, ...]                # admitted before tick 1
    events: Tuple[Timed, ...] = ()
    description: str = ""
    m_total: int = 8
    regions: Optional[List[str]] = None      # default: the 8-DC testbed
    sim_kwargs: Dict[str, Any] = field(default_factory=dict)


class FleetEngine:
    """One deterministic run of a :class:`FleetScenarioSpec`."""

    def __init__(self, spec: FleetScenarioSpec, seed: int = 0,
                 forest: Any = None, obs: Optional[str] = None,
                 faults: Any = None,
                 device: Optional[Union[str, torch.device]] = None):
        """`forest`: a fitted RandomForest shared by every job's RF
        inference (defaults to the memoized small demo forest); `obs`
        gates span tracing (None defers to $REPRO_OBS, default off);
        `faults` gates the fault plane, which is not yet ported (a
        plane object, "on" via the argument or $REPRO_FAULTS, or a
        timeline scripting fault events raises); `device` is where the
        forest runs (None = CUDA, raising without a card)."""
        self.spec = spec
        self.seed = int(seed)
        sim_kw = dict(spec.sim_kwargs)
        if spec.regions is not None:
            sim_kw.setdefault("regions", list(spec.regions))
        self.sim = WanSimulator(seed=self.seed, **sim_kw)
        if (faults is not None and not isinstance(faults, str)) \
                or faults_mode(faults) == "on" \
                or any(isinstance(t.event, FaultEvent)
                       for t in spec.events):
            raise NotImplementedError("the fault plane is not yet ported")
        self.fleet = FleetController(
            self.sim, BatchedRfPredictor(forest or default_fleet_forest(),
                                         device=device),
            m_total=spec.m_total, jobs=spec.jobs, obs=obs)
        self.faults = None
        self.tracer = self.fleet.tracer
        # a per-tick tap for harnesses: called as
        # step_hook(engine, fleet_step_trace_row) after each row is
        # appended; it must not mutate fleet/simulator state
        self.step_hook: Optional[Callable] = None
        self.step = 0
        self.diurnal: Optional[Tuple[float, int, int]] = None
        self._timeline: Dict[int, List[Timed]] = {}
        for t in spec.events:
            if not isinstance(t.event, FLEET_EVENTS):
                raise ValueError(
                    f"{type(t.event).__name__} is a single-job-engine "
                    f"event; fleet timelines accept "
                    f"{[e.__name__ for e in FLEET_EVENTS]}")
            if getattr(t.event, "notify", False):
                raise ValueError(
                    "notify=True is a single-job-engine concept; fleet "
                    "ticks replan every job each epoch")
            self._timeline.setdefault(t.step, []).append(t)

    # ------------------------------------------------------------------
    # event targets (shared-DSL surface; see scenarios/events.py)
    # ------------------------------------------------------------------
    def link(self, pair) -> Tuple[int, int]:
        """Resolve a (region, region) pair to shared-mesh indices."""
        a, b = pair
        return self.sim.regions.index(a), self.sim.regions.index(b)

    def dc(self, region: str) -> int:
        """Resolve one region name to its shared-mesh index (fault
        events target single DCs)."""
        return self.sim.regions.index(region)

    def add_job(self, spec: JobSpec) -> None:
        """`JobArrive` target."""
        self.fleet.add_job(spec)

    def remove_job(self, name: str) -> None:
        """`JobDepart` target."""
        self.fleet.remove_job(name)

    def set_priority(self, name: str, priority: float) -> None:
        """`PriorityShift` target."""
        self.fleet.set_priority(name, priority)

    # ------------------------------------------------------------------
    def _advance_scripted(self) -> None:
        if self.diurnal is not None:
            amp, period, start = self.diurnal
            phase = 2.0 * math.pi * (self.step - start) / max(period, 1)
            self.sim.modulation = 1.0 + amp * math.sin(phase)

    def run(self) -> FleetResult:
        """Drive the timeline to completion and return the trace."""
        trace = FleetTrace(self.spec.name, self.seed)
        for k in range(self.spec.steps):
            self.step = k
            due = self._timeline.get(k, ())
            applied = tuple(t.event.describe() for t in due)
            for t in due:
                t.event.apply(self)
            self._advance_scripted()
            record = self.fleet.tick()
            trace.steps.append(tick_to_step(record, events=applied))
            if self.step_hook is not None:
                self.step_hook(self, trace.steps[-1])
        return FleetResult(trace=trace)


def run_fleet_scenario(spec: FleetScenarioSpec, seed: int = 0,
                       forest: Any = None,
                       obs: Optional[str] = None,
                       faults: Any = None,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> FleetResult:
    """Build a fresh engine and run the fleet scenario to completion
    (`obs` gates span tracing, `faults` the fault plane; None defers
    to $REPRO_OBS / $REPRO_FAULTS; `device` places the forest, None =
    CUDA)."""
    return FleetEngine(spec, seed=seed, forest=forest, obs=obs,
                       faults=faults, device=device).run()


# ----------------------------------------------------------------------
# Named fleet scenarios — contention regimes the paper never runs
# ----------------------------------------------------------------------
# Slices deliberately overlap: DCs 0-3 carry two jobs, so their per-host
# budget and the shared links are genuinely contended.

def fleet_steady() -> FleetScenarioSpec:
    """Three fixed jobs, priorities 4:2:1, overlapping slices."""
    return FleetScenarioSpec(
        name="fleet_steady", steps=12,
        description="3 concurrent jobs share the mesh; no churn",
        jobs=(JobSpec("serving", dcs=(0, 1, 2, 3), priority=4.0),
              JobSpec("training", dcs=(0, 1, 4, 5), priority=2.0),
              JobSpec("batch", dcs=(2, 3, 6, 7), priority=1.0)),
        sim_kwargs=dict(QUIET))


def fleet_churn() -> FleetScenarioSpec:
    """Jobs arrive and depart; survivors re-share the freed capacity."""
    return FleetScenarioSpec(
        name="fleet_churn", steps=14,
        description="start with 2 jobs; a third arrives at tick 4 and "
                    "the batch job departs at tick 9",
        jobs=(JobSpec("serving", dcs=(0, 1, 2, 3), priority=3.0),
              JobSpec("batch", dcs=(0, 1, 4, 5), priority=1.0)),
        events=(at(4, JobArrive(JobSpec("etl", dcs=(2, 3, 6, 7),
                                        priority=2.0))),
                at(9, JobDepart("batch"))),
        sim_kwargs=dict(QUIET))


def fleet_priority_shift() -> FleetScenarioSpec:
    """A batch job is promoted mid-run (SLO escalation)."""
    return FleetScenarioSpec(
        name="fleet_priority_shift", steps=12,
        description="batch promoted 1 -> 6 at tick 6 on a fully "
                    "shared 4-DC slice",
        jobs=(JobSpec("serving", dcs=(0, 1, 2, 3), priority=4.0),
              JobSpec("batch", dcs=(0, 1, 2, 3), priority=1.0)),
        events=(at(6, PriorityShift("batch", 6.0)),),
        sim_kwargs=dict(QUIET))


def fleet_congestion() -> FleetScenarioSpec:
    """Uncredited cross-traffic bursts onto links two jobs share."""
    return FleetScenarioSpec(
        name="fleet_congestion", steps=12,
        description="background burst on us-east<->us-west, ticks 4-8, "
                    "under two contending jobs",
        jobs=(JobSpec("serving", dcs=(0, 1, 2, 3), priority=3.0),
              JobSpec("training", dcs=(0, 1, 4, 5), priority=1.0)),
        events=(at(4, CrossTraffic(("us-east", "us-west"), conns=48)),
                at(8, CrossTraffic(("us-east", "us-west"), conns=0))),
        sim_kwargs=dict(QUIET))


FLEET_SCENARIOS: Dict[str, Callable[[], FleetScenarioSpec]] = {
    "fleet_steady": fleet_steady,
    "fleet_churn": fleet_churn,
    "fleet_priority_shift": fleet_priority_shift,
    "fleet_congestion": fleet_congestion,
}


def get_fleet_scenario(name: str) -> FleetScenarioSpec:
    """Fresh spec by name (KeyError lists the known names)."""
    if name not in FLEET_SCENARIOS:
        raise KeyError(f"unknown fleet scenario {name!r}; "
                       f"have {sorted(FLEET_SCENARIOS)}")
    return FLEET_SCENARIOS[name]()


def fleet_scenario_names() -> List[str]:
    """All named fleet scenarios, library order."""
    return list(FLEET_SCENARIOS)
