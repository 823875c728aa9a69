"""Scenario event DSL.

A scenario timeline is a list of ``at(step, event)`` entries; each
event mutates the simulated WAN, the controller, or the engine's
synthetic workload when its step comes up:

  * :class:`LinkDegrade` / :class:`LinkRestore` — scripted symmetric
    degradation of one named link (a congested submarine cable, a
    peering change); ``notify=True`` additionally tells the controller
    the topology changed (visible maintenance vs silent congestion).
  * :func:`flap` — degrade-then-restore convenience pair.
  * :class:`CrossTraffic` — background flows on a named link that
    contend in the water-filling but are never credited to the
    workload (Table 1's runtime-vs-static gap, on demand).
  * :class:`DiurnalCycle` — sinusoidal global BW modulation (the
    business-hours cycle of [38]).
  * :class:`Rescale` — elastic DC join/leave (§3.3.2).
  * :class:`ProviderShift` — per-DC provider factors change under the
    workload (§3.3.3); always a visible topology change.
  * :class:`SkewRamp` — data-skew weights ramp linearly over a window
    (§3.3.1).
  * :class:`Straggler` — multiply the synthetic step time for a window
    of steps (a slow host, not a slow network).

Fleet timelines (repro_torch.fleet.scenario.FleetEngine) add cross-job
events:

  * :class:`JobArrive` / :class:`JobDepart` — a workload joins or
    leaves the shared WAN; the fleet re-arbitrates every survivor's
    budget/capacity envelope.
  * :class:`PriorityShift` — a job's fair-share weight changes (an SLO
    promotion, a batch job yielding to serving traffic).

The fleet events target the fleet engine only (they call
``eng.add_job`` / ``eng.remove_job`` / ``eng.set_priority``). Of the
events above, only the WAN-state ones (`LinkDegrade` / `LinkRestore`
with ``notify=False``, `CrossTraffic`, `DiurnalCycle`) work on both
engines; the workload events (`Rescale`, `SkewRamp`, `Straggler`,
`ProviderShift`, and ``notify=True``) drive the single-job engine's
synthetic workload/controller and are REJECTED by fleet timeline
validation (`repro_torch.fleet.scenario.FLEET_EVENTS`).

Events name links by region pair; the engine resolves indices. All
events are frozen dataclasses so timelines are hashable and their
``describe()`` strings are stable across runs (part of the trace).

Port of `repro/scenarios/events.py`: the same classes and field names,
so ``describe()`` gives the reference's bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

__all__ = ["at", "flap", "Timed", "Event", "LinkDegrade", "LinkRestore",
           "CrossTraffic", "DiurnalCycle", "Rescale", "ProviderShift",
           "SkewRamp", "Straggler", "JobArrive", "JobDepart",
           "PriorityShift"]


@dataclass(frozen=True)
class Event:
    """Base event: `apply(engine)` mutates sim/controller/engine."""

    def apply(self, eng) -> None:               # pragma: no cover - abstract
        """Execute the event against the engine."""
        raise NotImplementedError

    def describe(self) -> str:
        """Stable one-line form (part of the trace bytes)."""
        args = ", ".join(f"{k}={v}" for k, v in vars(self).items())
        return f"{type(self).__name__}({args})"


@dataclass(frozen=True)
class Timed:
    """An event pinned to a timeline step (build with :func:`at`)."""

    step: int
    event: Event


def at(step: int, event: Event) -> Timed:
    """``at(step=K, event=...)`` — schedule an event on the timeline."""
    return Timed(int(step), event)


# ----------------------------------------------------------------------
# Link events
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class LinkDegrade(Event):
    """Scripted symmetric collapse of one link to `factor` x nominal."""
    pair: Tuple[str, str]
    factor: float
    notify: bool = False          # visible maintenance vs silent congestion

    def apply(self, eng) -> None:
        """Execute against the engine."""
        i, j = eng.link(self.pair)
        eng.sim.set_link_factor(i, j, self.factor)
        if self.notify:
            eng.controller.topology_changed()


@dataclass(frozen=True)
class LinkRestore(Event):
    """Restore a degraded link to nominal."""

    pair: Tuple[str, str]
    notify: bool = False

    def apply(self, eng) -> None:
        """Execute against the engine."""
        i, j = eng.link(self.pair)
        eng.sim.set_link_factor(i, j, 1.0)
        if self.notify:
            eng.controller.topology_changed()


def flap(step: int, pair: Tuple[str, str], factor: float,
         down_steps: int, notify: bool = True) -> List[Timed]:
    """A link flap: degrade at `step`, restore `down_steps` later."""
    return [at(step, LinkDegrade(pair, factor, notify)),
            at(step + down_steps, LinkRestore(pair, notify))]


@dataclass(frozen=True)
class CrossTraffic(Event):
    """`conns` background flows on the link (0 clears the burst)."""
    pair: Tuple[str, str]
    conns: float

    def apply(self, eng) -> None:
        """Execute against the engine."""
        i, j = eng.link(self.pair)
        eng.sim.set_background(i, j, self.conns)
        eng.sim.set_background(j, i, self.conns)


# ----------------------------------------------------------------------
# Cluster-wide events
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class DiurnalCycle(Event):
    """From this step on, all links swing by +-`amplitude` over
    `period` steps (peak at +period/4)."""
    amplitude: float
    period: int

    def apply(self, eng) -> None:
        """Execute against the engine."""
        eng.diurnal = (self.amplitude, self.period, eng.step)


@dataclass(frozen=True)
class Rescale(Event):
    """Elastic DC join/leave: re-plan for `n_pods` pods (§3.3.2)."""
    n_pods: int

    def apply(self, eng) -> None:
        """Execute against the engine."""
        eng.controller.rescale(
            self.n_pods, skew_w=eng.skew_for_pods(self.n_pods))


@dataclass(frozen=True)
class ProviderShift(Event):
    """Per-DC provider factors change (§3.3.3) — a visible migration,
    so the controller replans from scratch."""
    factors: Tuple[float, ...]

    def apply(self, eng) -> None:
        """Execute against the engine."""
        eng.sim.set_provider_factor(list(self.factors))
        eng.controller.topology_changed()


@dataclass(frozen=True)
class SkewRamp(Event):
    """Ramp the per-DC data-skew weights linearly to `weights` over
    `over` steps, starting now (§3.3.1)."""
    weights: Tuple[float, ...]
    over: int

    def apply(self, eng) -> None:
        """Execute against the engine."""
        eng.start_skew_ramp(self.weights, self.over)


# ----------------------------------------------------------------------
# Fleet events (repro_torch.fleet.scenario.FleetEngine timelines)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class JobArrive(Event):
    """A new job joins the fleet (`job` is a repro_torch.fleet
    JobSpec; typed loosely here to keep the DSL import-free of the fleet
    package)."""
    job: Any

    def apply(self, eng) -> None:
        """Execute against the engine."""
        eng.add_job(self.job)


@dataclass(frozen=True)
class JobDepart(Event):
    """A job leaves; its flows are withdrawn and survivors re-share."""
    name: str

    def apply(self, eng) -> None:
        """Execute against the engine."""
        eng.remove_job(self.name)


@dataclass(frozen=True)
class PriorityShift(Event):
    """A job's fair-share weight changes at runtime."""
    name: str
    priority: float

    def apply(self, eng) -> None:
        """Execute against the engine."""
        eng.set_priority(self.name, self.priority)


@dataclass(frozen=True)
class Straggler(Event):
    """Multiply the synthetic step time by `slowdown` for `duration`
    steps (a slow host; the network itself is untouched)."""
    slowdown: float
    duration: int = 1

    def apply(self, eng) -> None:
        """Execute against the engine."""
        eng.straggler_mult = self.slowdown
        eng.straggler_until = eng.step + self.duration
