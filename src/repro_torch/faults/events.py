"""Fault events for scenario timelines (port of `repro/faults/events.py`).

These extend the scenarios DSL (:mod:`repro_torch.scenarios.events`)
with control-plane failures. Unlike `LinkDegrade` — which models a
SLOW link — these model BROKEN components: a blacked-out DC carries
zero bandwidth on every touching link, a partition makes whole groups
mutually unreachable, a probe fault makes the measurement pipeline
itself fail.

Every fault event routes through an engine's fault plane
(`eng.faults`). The plane is not yet ported: both engines refuse a
timeline that scripts a fault event, with `NotImplementedError`, at
construction (the reference builds an ungraceful plane for it). The
classes, `FLEET_FAULT_EVENTS` and :func:`chaos_schedule` are here so
the engines can test timelines against them, and so a storm composes
to the reference's timeline from the same seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.scenarios.events import Event, Timed, at

__all__ = ["FaultEvent", "DcBlackout", "DcRestore", "NetworkPartition",
           "PartitionHeal", "ProbeTimeout", "ProbeLoss", "MonitorOutage",
           "PredictorFault", "SolverFault", "FLEET_FAULT_EVENTS",
           "chaos_schedule"]


@dataclass(frozen=True)
class FaultEvent(Event):
    """Base of all fault events: resolves the engine's fault plane."""

    def _plane(self, eng):
        if getattr(eng, "faults", None) is None:
            raise RuntimeError(
                f"{type(self).__name__} scripted but the engine has no "
                f"fault plane — construct it with faults='on'/'off' or "
                f"let the engine auto-detect fault events")
        return eng.faults


# ----------------------------------------------------------------------
# Reachability faults (also valid on fleet timelines)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class DcBlackout(FaultEvent):
    """Full-node loss: every link touching `region` goes unreachable
    (zero BW, not merely low) until :class:`DcRestore`."""
    region: str

    def apply(self, eng) -> None:
        """Execute against the engine."""
        plane = self._plane(eng)
        plane.blackout(eng.dc(self.region))
        plane.apply_reachability(eng.sim)


@dataclass(frozen=True)
class DcRestore(FaultEvent):
    """Bring a blacked-out DC back online."""
    region: str

    def apply(self, eng) -> None:
        """Execute against the engine."""
        plane = self._plane(eng)
        plane.restore(eng.dc(self.region))
        plane.apply_reachability(eng.sim)


@dataclass(frozen=True)
class NetworkPartition(FaultEvent):
    """Partition the WAN: regions in different `groups` cannot reach
    each other (a reachability mask, not just low BW); regions named
    in no group keep full connectivity."""
    groups: Tuple[Tuple[str, ...], ...]

    def apply(self, eng) -> None:
        """Execute against the engine."""
        plane = self._plane(eng)
        plane.set_partition([[eng.dc(r) for r in g]
                             for g in self.groups])
        plane.apply_reachability(eng.sim)


@dataclass(frozen=True)
class PartitionHeal(FaultEvent):
    """Heal the partition (blackouts, if any, stay in force)."""

    def apply(self, eng) -> None:
        """Execute against the engine."""
        plane = self._plane(eng)
        plane.heal_partition()
        plane.apply_reachability(eng.sim)


# ----------------------------------------------------------------------
# Control-plane faults (single-job engine)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ProbeTimeout(FaultEvent):
    """Replan-time snapshot captures time out for `duration` steps.
    Naive mode dies with a probe-timeout error at the next replan;
    graceful mode climbs the retry/staleness ladder."""
    duration: int

    def apply(self, eng) -> None:
        """Execute against the engine."""
        self._plane(eng).probe_fault("timeout", self.duration)


@dataclass(frozen=True)
class ProbeLoss(FaultEvent):
    """Each capture attempt loses a `frac` subset of pairs for
    `duration` steps (naive: NaN holes flow into the predictor)."""
    duration: int
    frac: float = 0.5

    def apply(self, eng) -> None:
        """Execute against the engine."""
        self._plane(eng).probe_fault("loss", self.duration, self.frac)


@dataclass(frozen=True)
class MonitorOutage(FaultEvent):
    """The monitoring pipeline freezes for `duration` steps: every
    measurement repeats the last pre-outage value with a rising age."""
    duration: int

    def apply(self, eng) -> None:
        """Execute against the engine."""
        self._plane(eng).monitor_outage(self.duration)


@dataclass(frozen=True)
class PredictorFault(FaultEvent):
    """The RF emits poisoned rows (`kind`: ``"nan"`` or ``"garbage"``)
    for `duration` steps, `rows` rows per replan."""
    duration: int
    kind: str = "nan"
    rows: int = 2

    def apply(self, eng) -> None:
        """Execute against the engine."""
        self._plane(eng).predictor_fault(self.duration, self.kind,
                                         self.rows)


@dataclass(frozen=True)
class SolverFault(FaultEvent):
    """The engine's water-fill diverges for `duration` steps (raises
    :class:`~repro_torch.wan.simulator.WaterfillDivergence`); graceful mode
    rolls back to the last-known-good plan instead of crashing."""
    duration: int = 1

    def apply(self, eng) -> None:
        """Execute against the engine."""
        self._plane(eng).solver_fault(self.duration)


# reachability faults are job-agnostic WAN state, so fleet timelines
# accept them (repro_torch.fleet.scenario extends FLEET_EVENTS with
# these)
FLEET_FAULT_EVENTS = (DcBlackout, DcRestore, NetworkPartition,
                      PartitionHeal)

_CHAOS_STREAM = 0xC4A05


def chaos_schedule(seed: int, steps: int,
                   regions: Optional[Sequence[str]] = None,
                   n_faults: int = 4,
                   kinds: Optional[Sequence[str]] = None) -> List[Timed]:
    """Compose a deterministic fault storm from a seed.

    Draws `n_faults` (kind, step, duration) triples from a dedicated
    stream — same seed, same storm, independent of the simulator's
    named streams. Fault starts land in ``[steps//8, 3*steps//4)`` so
    the loop has a warm baseline before the first hit and room to
    recover after the last; reachability faults get a paired restore.
    `regions` supplies DcBlackout targets (omit it to skip blackout
    faults)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([_CHAOS_STREAM, int(seed)]))
    pool = list(kinds) if kinds is not None else \
        ["probe_timeout", "probe_loss", "monitor_outage",
         "predictor_fault", "solver"] + (["blackout"] if regions else [])
    lo, hi = max(steps // 8, 1), max(3 * steps // 4, 2)
    timeline: List[Timed] = []
    for _ in range(int(n_faults)):
        kind = pool[int(rng.integers(len(pool)))]
        start = int(rng.integers(lo, hi))
        dur = int(rng.integers(2, max(steps // 6, 3)))
        if kind == "blackout":
            region = regions[int(rng.integers(len(regions)))]
            timeline.append(at(start, DcBlackout(region)))
            timeline.append(at(min(start + dur, steps - 1),
                               DcRestore(region)))
        elif kind == "probe_timeout":
            timeline.append(at(start, ProbeTimeout(dur)))
        elif kind == "probe_loss":
            timeline.append(at(start, ProbeLoss(dur)))
        elif kind == "monitor_outage":
            timeline.append(at(start, MonitorOutage(dur)))
        elif kind == "predictor_fault":
            timeline.append(at(start, PredictorFault(dur)))
        elif kind == "solver":
            timeline.append(at(start, SolverFault(min(dur, 2))))
        else:                                    # pragma: no cover
            raise ValueError(f"unknown chaos kind {kind!r}")
    timeline.sort(key=lambda t: t.step)
    return timeline
