"""Cost-aware probe scheduling — spend Eq. 1 dollars only on suspicion.

The paper's Table 2 prices the two measurement modes: a full >=20 s
runtime probe (`MONITOR_SECONDS`) costs ~20x the 1-second snapshot,
and Tetrium-style periodic full probing at `MONITOR_EVERY_MIN` cadence
is the expensive baseline prediction replaces. The scheduler turns
that static cadence into an adaptive one:

  * observing the workload's own achieved BW (iftop-style) is free;
  * every controller replan already pays for one snapshot capture;
  * a FULL probe fires only while the drift detector is suspicious,
    rate-limited by a cooldown — when the predictor is healthy the
    full-probe spend is zero.

`spend_usd` accumulates the run's monitoring dollars through
:func:`repro_torch.wan.monitor.probe_cost_usd`, so a bench can put the
lifecycle run and the frozen + periodic-full-probe baseline on the
same axis: accuracy AND dollars.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.wan.monitor import (MONITOR_EVERY_MIN, MONITOR_SECONDS,
                               SNAPSHOT_SECONDS, probe_cost_usd)


@dataclass
class ProbeConfig:
    """Knobs of the adaptive probe cadence."""

    step_minutes: float = 10.0    # simulated minutes per engine step
    cooldown_ticks: int = 3       # min ticks between two full probes
    probe_seconds: float = MONITOR_SECONDS
    snapshot_seconds: float = SNAPSHOT_SECONDS


def baseline_probe_spend(steps: int, n_dcs: int,
                         cfg: Optional[ProbeConfig] = None,
                         cadence_min: float = MONITOR_EVERY_MIN) -> float:
    """$ a frozen-predictor deployment pays for periodic full probes
    over `steps` engine steps at the Tetrium `cadence_min` cadence
    (the Table-2 runtime-monitoring row, scaled to the run length)."""
    cfg = cfg or ProbeConfig()
    n_probes = int(steps * cfg.step_minutes // cadence_min)
    return n_probes * probe_cost_usd(cfg.probe_seconds, n_dcs)


class ProbeScheduler:
    """Adaptive monitor cadence with dollar accounting."""

    def __init__(self, n_dcs: int, cfg: Optional[ProbeConfig] = None):
        self.n_dcs = int(n_dcs)
        self.cfg = cfg or ProbeConfig()
        # probe tallies + Eq. 1 dollars live on the obs registry;
        # `full_probes` / `snapshots` / `spend_usd` remain as properties
        self.metrics = MetricsRegistry("probes")
        self._m_full = self.metrics.counter(
            "full_probes", help="full >=20 s runtime probes fired")
        self._m_snaps = self.metrics.counter(
            "snapshots", help="1-second snapshot captures charged")
        self._m_usd = self.metrics.counter(
            "spend_usd", help="cumulative Eq. 1 monitoring dollars")
        self._last_full: Optional[int] = None

    def want_full(self, step: int, suspicious: bool) -> bool:
        """True when a full probe should fire THIS tick: the detector
        is suspicious and the cooldown since the last full probe has
        elapsed. Quiet ticks never probe."""
        if not suspicious:
            return False
        if self._last_full is not None and \
                step - self._last_full < self.cfg.cooldown_ticks:
            return False
        return True

    def charge_full(self, step: int) -> float:
        """Account one full probe fired at `step`; returns its $."""
        cost = probe_cost_usd(self.cfg.probe_seconds, self.n_dcs)
        self._m_full.inc()
        self._m_usd.inc(cost)
        self._last_full = int(step)
        return cost

    def charge_snapshot(self, count: int = 1) -> float:
        """Account `count` snapshot captures (one per controller
        replan); returns the $ added."""
        cost = count * probe_cost_usd(self.cfg.snapshot_seconds,
                                      self.n_dcs)
        self._m_snaps.inc(count)
        self._m_usd.inc(cost)
        return cost

    # -- back-compat aliases onto the obs registry ---------------------
    @property
    def full_probes(self) -> int:
        """Full probes fired (registry-backed)."""
        return int(self._m_full.value)

    @property
    def snapshots(self) -> int:
        """Snapshot captures charged (registry-backed)."""
        return int(self._m_snaps.value)

    @property
    def spend_usd(self) -> float:
        """Cumulative Eq. 1 dollars (registry-backed)."""
        return float(self._m_usd.value)
