"""Chaos scenario library — scripted fault timelines with metadata.

A separate registry from :mod:`repro_torch.scenarios.library` on
purpose: the named scenarios there feed the golden-trace collection,
and chaos timelines are *meant* to be run twice — graceful
(``faults="on"``) vs the naive-crash ablation (``faults="off"``; the
scripted fault events still build a plane, just an ungraceful one).

Each entry carries the metadata the harness needs to score recovery:

  * ``fault_steps`` — the injection steps MTTR is measured from;
  * ``eval_from``   — first step of the degraded-floor evaluation
    window (after warmup, so init-transient floors don't count);
  * ``dead_steps``  — steps where progress was *impossible* (a
    blacked-out ring hop carries zero BW for every controller),
    excluded from the degraded-floor minimum;
  * ``fleet``       — the spec is a FleetScenarioSpec (fleet harness
    path) rather than a single-job ScenarioSpec.

All chaos scenarios run the QUIET simulator (no fluctuation /
observation noise): every floor excursion in the trace is the fault —
or the recovery — and nothing else.

Port of `repro/faults/scenarios.py`: the same 8 timelines, so a run
here and the JAX package's run of the same name and seed are the same
experiment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

from repro_torch.faults.events import (DcBlackout, DcRestore,
                                       MonitorOutage, NetworkPartition,
                                       PartitionHeal, PredictorFault,
                                       ProbeTimeout, SolverFault,
                                       chaos_schedule)
from repro_torch.fleet.controller import JobSpec
from repro_torch.fleet.scenario import FleetScenarioSpec
from repro_torch.scenarios.engine import ScenarioSpec
from repro_torch.scenarios.events import LinkDegrade, LinkRestore, at

QUIET = dict(fluct_sigma=0.0, snapshot_sigma=0.0, runtime_sigma=0.0)


@dataclass
class ChaosSpec:
    """One chaos scenario + the recovery-scoring metadata."""

    spec: Any                               # ScenarioSpec | FleetScenarioSpec
    fault_steps: Tuple[int, ...]            # injections MTTR keys on
    eval_from: int = 0                      # degraded-floor window start
    dead_steps: Tuple[int, ...] = ()        # progress-impossible steps
    fleet: bool = False
    naive_crashes: bool = False             # the off/naive run MUST die


def probe_blackhole() -> ChaosSpec:
    """Probes time out exactly while a ring hop silently degrades: the
    naive loop dies at the first in-window replan; the ladder replans
    from the discounted last-good capture and recovers when probes
    return."""
    spec = ScenarioSpec(
        name="probe_blackhole", steps=30,
        description="probe timeouts (steps 8-18) across a silent "
                    "us-east<->us-west degrade at step 10",
        events=(at(8, ProbeTimeout(10)),
                at(10, LinkDegrade(("us-east", "us-west"), 0.3)),
                at(20, LinkRestore(("us-east", "us-west"))),),
        sim_kwargs=dict(QUIET), cfg_kwargs=dict(replan_every=5))
    return ChaosSpec(spec, fault_steps=(8, 10), eval_from=4,
                     naive_crashes=True)


def monitor_freeze() -> ChaosSpec:
    """The monitoring pipeline freezes, then the WAN shifts under the
    frozen readings: the ladder plans on discounted stale data (and
    past max_stale_steps, on the snapshot rung) until the monitor
    thaws."""
    spec = ScenarioSpec(
        name="monitor_freeze", steps=34,
        description="monitor dark steps 8-20; a silent degrade at 12 "
                    "happens entirely inside the outage",
        events=(at(8, MonitorOutage(12)),
                at(12, LinkDegrade(("us-east", "ap-south"), 0.4)),
                at(22, LinkRestore(("us-east", "ap-south"))),),
        sim_kwargs=dict(QUIET), cfg_kwargs=dict(replan_every=5))
    return ChaosSpec(spec, fault_steps=(8, 12), eval_from=4)


def dc_blackout() -> ChaosSpec:
    """A ring DC blacks out AND probes time out (the realistic pair:
    the dead DC is why the probes hang). Progress over the dead hop is
    impossible for everyone — those steps are excluded from the floor;
    the score is how fast each mode recovers after restore."""
    spec = ScenarioSpec(
        name="dc_blackout", steps=30,
        description="ap-se blacks out steps 10-18 with probe timeouts; "
                    "restore at 18",
        events=(at(10, DcBlackout("ap-se")),
                at(10, ProbeTimeout(6)),
                at(18, DcRestore("ap-se")),),
        sim_kwargs=dict(QUIET), cfg_kwargs=dict(replan_every=5))
    return ChaosSpec(spec, fault_steps=(10,), eval_from=4,
                     dead_steps=tuple(range(10, 18)),
                     naive_crashes=True)


def predictor_poison() -> ChaosSpec:
    """The RF emits NaN rows for six steps: naive planning feeds NaN
    into the optimizer (collapsed/garbage plans); the ladder
    quarantines the poisoned rows and keeps the floor."""
    spec = ScenarioSpec(
        name="predictor_poison", steps=30,
        description="NaN predictor rows, steps 10-16",
        events=(at(10, PredictorFault(6, kind="nan", rows=2)),),
        sim_kwargs=dict(QUIET), cfg_kwargs=dict(replan_every=5))
    return ChaosSpec(spec, fault_steps=(10,), eval_from=4)


def partition() -> ChaosSpec:
    """The mesh partitions across the ring (us links | ap links): both
    cross-group ring hops die. Floor scoring excludes the partitioned
    window; recovery speed after heal is the score."""
    spec = ScenarioSpec(
        name="partition", steps=30,
        description="(us-east,us-west) | (ap-south,ap-se) partition, "
                    "steps 10-18",
        events=(at(10, NetworkPartition((("us-east", "us-west"),
                                         ("ap-south", "ap-se")))),
                at(18, PartitionHeal()),),
        sim_kwargs=dict(QUIET), cfg_kwargs=dict(replan_every=5))
    return ChaosSpec(spec, fault_steps=(10,), eval_from=4,
                     dead_steps=tuple(range(10, 18)))


def solver_flake() -> ChaosSpec:
    """The water-fill diverges for two steps: naive crashes at step
    12; graceful rolls back to the last-known-good plan (a plan-cache
    hit) and rides it out."""
    spec = ScenarioSpec(
        name="solver_flake", steps=26,
        description="injected water-fill divergence, steps 12-13",
        events=(at(12, SolverFault(2)),),
        sim_kwargs=dict(QUIET), cfg_kwargs=dict(replan_every=5))
    return ChaosSpec(spec, fault_steps=(12,), eval_from=4,
                     naive_crashes=True)


def chaos_storm() -> ChaosSpec:
    """A seeded storm from :func:`chaos_schedule` — whatever it draws,
    the graceful loop must survive with zero uncaught exceptions."""
    events = tuple(chaos_schedule(seed=7, steps=40,
                                  regions=["ap-se2", "ap-ne"]))
    spec = ScenarioSpec(
        name="chaos_storm", steps=40,
        description="seeded multi-fault storm (chaos_schedule seed 7)",
        events=events,
        sim_kwargs=dict(QUIET), cfg_kwargs=dict(replan_every=5))
    return ChaosSpec(spec, fault_steps=tuple(sorted({t.step
                                                     for t in events})),
                     eval_from=4)


def fleet_blackout() -> ChaosSpec:
    """Fleet quarantine: two disjoint jobs share the mesh; ap-se (in
    the serving job's slice only) blacks out for four ticks. The
    arbiter quarantines the dead DC — the touched job's envelope
    shrinks while the untouched batch job keeps its plan series."""
    spec = FleetScenarioSpec(
        name="fleet_blackout", steps=12,
        description="ap-se blacks out ticks 4-8 under a 2-job fleet "
                    "with disjoint slices",
        jobs=(JobSpec("serving", dcs=(0, 1, 2, 3), priority=2.0),
              JobSpec("batch", dcs=(4, 5, 6, 7), priority=1.0)),
        events=(at(4, DcBlackout("ap-se")),
                at(8, DcRestore("ap-se")),),
        sim_kwargs=dict(QUIET))
    return ChaosSpec(spec, fault_steps=(4,), eval_from=1,
                     dead_steps=tuple(range(4, 8)), fleet=True)


CHAOS_SCENARIOS: Dict[str, Callable[[], ChaosSpec]] = {
    "probe_blackhole": probe_blackhole,
    "monitor_freeze": monitor_freeze,
    "dc_blackout": dc_blackout,
    "predictor_poison": predictor_poison,
    "partition": partition,
    "solver_flake": solver_flake,
    "chaos_storm": chaos_storm,
    "fleet_blackout": fleet_blackout,
}


def get_chaos_scenario(name: str) -> ChaosSpec:
    """Fresh ChaosSpec by name (KeyError lists the known names)."""
    if name not in CHAOS_SCENARIOS:
        raise KeyError(f"unknown chaos scenario {name!r}; "
                       f"have {sorted(CHAOS_SCENARIOS)}")
    return CHAOS_SCENARIOS[name]()


def chaos_scenario_names() -> List[str]:
    """All named chaos scenarios, library order."""
    return list(CHAOS_SCENARIOS)
