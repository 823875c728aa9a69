"""Mist-style SLE (service-level-expectation) health rollups.

The Mist WAN-performance exemplar (PAPERS.md; see also "Wide Area
Network Intelligence with Application to Multimedia Service") grades a
WAN control loop on a handful of normalized health expectations rather
than raw throughput numbers. This module computes those rollups from
the repo's OWN deterministic traces (`repro_torch.scenarios.trace` /
`repro_torch.fleet.trace`) — pure functions of recorded values, no clock, no
RNG — so every scenario's health is one comparable block in the bench
JSON:

  * **accuracy** — prediction-accuracy SLE: the fraction of trace
    samples (the per-step achieved-vs-predicted min AND mean series)
    whose relative residual |achieved/predicted - 1| lies within
    `band`;
  * **capacity** — capacity-attainment SLE: mean per-step achieved
    min-BW as a fraction of the run's own 95th-percentile floor (the
    cloudgenix percentile-capacity convention) — 1.0 means the floor
    never sags below what the run showed it can sustain;
  * **fairness** — Jain's index: across tenants' priority-normalized
    min BW for fleet traces, across the per-step floor series
    (temporal evenness) for single-job scenario traces;
  * **responsiveness** — replan responsiveness: mean steps from a
    scripted event to the floor recovering to `frac` x its pre-event
    median (censored at run end when it never recovers);
  * **monitoring_usd** — the paper's §1/Eq. 1 cost axis as a tracked
    metric: every trace-visible measurement (the engine's per-step
    snapshot sample plus one snapshot capture per replan; per-job
    captures plus the capacity probe per fleet tick) priced through
    :func:`repro_torch.wan.monitor.probe_cost_usd`.

Fleet traces carry no predicted-BW columns (their serialization is
golden-pinned), so :func:`fleet_sle` reports ``accuracy: None`` —
honestly absent rather than fabricated.

Port of `repro/obs/sle.py`: pure host functions of the traces, equal
to the JAX package's on the same trace.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

SLE_BAND = 0.25          # default relative-residual accuracy band
CAPACITY_Q = 95.0        # percentile defining the run's own capacity
RECOVERY_FRAC = 0.9      # floor counts as recovered at this fraction
BASELINE_WINDOW = 5      # pre-event steps defining the baseline median


def jain_index(xs: Sequence[float]) -> float:
    """Jain's fairness index (sum x)^2 / (n * sum x^2), in (0, 1];
    1.0 for an empty or all-zero vector (nothing to be unfair about)."""
    v = np.asarray(xs, np.float64)
    if v.size == 0 or not np.any(v):
        return 1.0
    return float(v.sum() ** 2 / (v.size * (v ** 2).sum()))


def accuracy_sle(trace, band: float = SLE_BAND) -> float:
    """Fraction of per-step (min, mean) achieved-vs-predicted samples
    with |achieved/predicted - 1| <= band."""
    ok = n = 0
    for s in trace.steps:
        for a, p in ((s.achieved_min, s.predicted_min),
                     (s.achieved_mean, s.predicted_mean)):
            n += 1
            if abs(a / max(p, 1e-9) - 1.0) <= band:
                ok += 1
    return ok / n if n else 1.0


def capacity_sle(floor: Sequence[float], q: float = CAPACITY_Q) -> float:
    """Mean per-step floor as a fraction of the series' own q-th
    percentile (capped at 1.0 per step)."""
    v = np.asarray(floor, np.float64)
    if v.size == 0:
        return 1.0
    ref = float(np.percentile(v, q))
    if ref <= 0:
        return 1.0
    return float(np.minimum(v / ref, 1.0).mean())


def responsiveness_steps(event_steps: Sequence[int],
                         floor: Sequence[float],
                         frac: float = RECOVERY_FRAC,
                         window: int = BASELINE_WINDOW
                         ) -> Optional[float]:
    """Mean steps from each event to the floor recovering to `frac` x
    the pre-event median; None when the run scripted no events. An
    event the run never recovers from is censored at run end (it
    contributes the remaining step count — a lower bound, not a
    fabricated recovery)."""
    v = list(floor)
    lags: List[float] = []
    for e in event_steps:
        base = float(np.median(v[max(0, e - window):e])) if e > 0 \
            else float(v[e])
        target = frac * base
        lag = len(v) - e                       # censored default
        for t in range(e, len(v)):
            if v[t] >= target:
                lag = t - e
                break
        lags.append(float(lag))
    return float(np.mean(lags)) if lags else None


def fault_sle(floor: Sequence[float], fault_steps: Sequence[int],
              dead_steps: Sequence[int] = (),
              frac: float = RECOVERY_FRAC) -> Dict[str, Any]:
    """The fault-plane recovery block (repro_torch.faults.harness): MTTR via
    the responsiveness SLE (mean steps from each fault injection to
    the floor recovering to `frac` x its pre-fault median, censored at
    run end) plus the degraded-mode min-BW floor — the worst per-step
    floor over the steps where progress was POSSIBLE (`dead_steps`,
    e.g. a blacked-out ring hop, are excluded: no controller can move
    bytes over a link that does not exist)."""
    v = np.asarray(list(floor), np.float64)
    dead = set(int(d) for d in dead_steps)
    alive = [float(v[t]) for t in range(len(v)) if t not in dead]
    return {
        "mttr_steps": responsiveness_steps(fault_steps, v, frac=frac),
        "degraded_min_bw": round(min(alive), 6) if alive else 0.0,
    }


# ----------------------------------------------------------------------
# Eq. 1 monitoring-cost meter
# ----------------------------------------------------------------------
def scenario_monitoring_usd(trace, n_dcs: int) -> float:
    """Eq. 1 dollars for a scenario run's trace-visible measurements:
    one 1-second snapshot per engine step (the per-step monitor sample)
    plus one snapshot capture per replan."""
    # local import: repro_torch.wan.monitor pulls in the simulator, which
    # itself imports repro_torch.obs — importing it lazily keeps the obs
    # package importable from anywhere without a cycle
    from repro_torch.wan.monitor import SNAPSHOT_SECONDS, probe_cost_usd
    snap = probe_cost_usd(SNAPSHOT_SECONDS, n_dcs)
    n_replans = len(trace.replan_reasons())
    return (len(trace.steps) + n_replans) * snap


def fleet_monitoring_usd(trace, n_dcs: int) -> float:
    """Eq. 1 dollars for a fleet run: per tick, one snapshot capture
    per job plus the arbiter's 1-second capacity probe."""
    from repro_torch.wan.monitor import SNAPSHOT_SECONDS, probe_cost_usd
    snap = probe_cost_usd(SNAPSHOT_SECONDS, n_dcs)
    return sum((s.n_jobs + 1) * snap for s in trace.steps)


# ----------------------------------------------------------------------
# Rollup blocks (the "sle" block in BENCH_scenarios / BENCH_fleet)
# ----------------------------------------------------------------------
def scenario_sle(trace, n_dcs: int = 8, band: float = SLE_BAND
                 ) -> Dict[str, Any]:
    """The SLE health block for one single-job scenario trace."""
    floor = [s.achieved_min for s in trace.steps]
    events = [s.step for s in trace.steps if s.events]
    return {
        "band": band,
        "accuracy": round(accuracy_sle(trace, band), 4),
        "capacity": round(capacity_sle(floor), 4),
        "fairness": round(jain_index(floor), 4),
        "responsiveness_steps": responsiveness_steps(events, floor),
        "monitoring_usd": round(scenario_monitoring_usd(trace, n_dcs), 6),
    }


def fleet_sle(trace, n_dcs: int = 8) -> Dict[str, Any]:
    """The SLE health block for one fleet trace. Fairness is Jain over
    per-job mean floor normalized by priority (1.0 = weighted-fair);
    capacity/responsiveness use the fleet-wide per-tick min floor."""
    floor = [min((row["achieved_min"] for row in s.jobs),
                 default=0.0) for s in trace.steps]
    events = [s.tick - trace.steps[0].tick for s in trace.steps
              if s.events]
    norm = []
    for name in trace.job_names():
        mins = trace.job_series(name, "achieved_min")
        prios = trace.job_series(name, "priority")
        norm.append(float(np.mean(mins)) / max(float(prios[-1]), 1e-9))
    return {
        "accuracy": None,      # fleet traces carry no predicted columns
        "capacity": round(capacity_sle(floor), 4),
        "fairness": round(jain_index(norm), 4),
        "responsiveness_steps": responsiveness_steps(events, floor),
        "monitoring_usd": round(fleet_monitoring_usd(trace, n_dcs), 6),
    }
