"""LifecycleManager — the online predictor lifecycle as one subsystem.

Orchestrates the four lifecycle pieces per engine tick, off the hot
path (the controller calls back only for the prediction clamp):

  1. **observe** (free): the per-pair relative residual between the BW
     the workload actually achieved and what the predictor implies for
     the current snapshot — iftop-style observation of served traffic,
     no probe traffic;
  2. **detect**: feed the residual matrix to the EWMA drift detector
     (:mod:`repro_torch.lifecycle.drift`) and the un-gated accuracy EWMA;
  3. **probe** (priced): while drift is suspected, spend a full
     >=20-second runtime probe (Eq. 1 dollars, cooldown-limited) to put
     clean labels in the harvest window;
  4. **refresh**: a :class:`DriftSignal` opens a collection phase — the
     window is cleared (pre-signal harvest describes the regime that
     died) and once enough fresh rows accumulate the forest is refit on
     decayed-seed ∪ window (:mod:`repro_torch.lifecycle.refresh`), swapped
     into the predictor with one reference assignment, the detector
     re-baselined, and an immediate ``reason="lifecycle"`` replan
     issued.

Gating mirrors the overlay layer: ``lifecycle_mode()`` resolves an
explicit argument, then ``$REPRO_LIFECYCLE``, then ``off`` — and off
means NO manager exists and no lifecycle code runs, keeping every
historical trace golden byte-identical. ``active=False`` builds a
*shadow* manager: it observes, detects and accounts snapshot spend
(the frozen-predictor baseline the bench compares against) but never
clamps, probes, or refreshes — the workload replays exactly as with no
manager at all.

Port of `repro/lifecycle/manager.py`: the loop is host numpy float64,
as in the JAX package. The one device step is the observation's
``predictor.predict_matrix``: with a `BwPredictor` on the card it is
one `rf_predict` launch a tick, and after a refresh swap the next
launch reads the refit forest (`BwPredictor.forest_on` repacks the
nodes whenever the forest's arrays change).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from repro_torch.core.predictor import assemble_features
from repro_torch.lifecycle.drift import (DriftConfig, DriftSignal,
                                   EwmaDriftDetector, ResidualStats)
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.lifecycle.probes import ProbeConfig, ProbeScheduler
from repro_torch.lifecycle.refresh import RefreshConfig, refresh_forest
from repro_torch.lifecycle.window import (SlidingWindow,
                                    WindowedPercentileEstimator)

LIFECYCLE_MODES = ("off", "on")


def lifecycle_mode(mode: Optional[str] = None) -> str:
    """Resolve the lifecycle gate: an explicit argument wins, then the
    ``REPRO_LIFECYCLE`` environment variable, then ``off`` (the
    byte-identical historical path)."""
    m = mode or os.environ.get("REPRO_LIFECYCLE", "off")
    if m not in LIFECYCLE_MODES:
        raise ValueError(f"unknown lifecycle mode {m!r}; "
                         f"expected one of {LIFECYCLE_MODES}")
    return m


@dataclass
class LifecycleConfig:
    """Knobs of the full lifecycle loop (sub-configs per piece)."""

    drift: DriftConfig = field(default_factory=DriftConfig)
    refresh: RefreshConfig = field(default_factory=RefreshConfig)
    probes: ProbeConfig = field(default_factory=ProbeConfig)
    window_rows: int = 1024      # harvest-window capacity (rows)
    percentile_window: int = 16  # capacity-estimator sample window
    percentile_q: float = 95.0   # cloudgenix-style capacity percentile
    clamp_headroom: float = 1.5  # RF may promise <= headroom x capacity
    resid_alpha: float = 0.4     # accuracy-EWMA smoothing


@dataclass(frozen=True)
class LifecycleRecord:
    """One tick of lifecycle telemetry (the bench/test series)."""

    step: int
    resid_ewma: float            # un-gated EWMA of mean |residual|
    z_max: float                 # worst standardized residual this tick
    consec_max: int              # longest live suspicious streak
    suspicious: bool             # any pair's streak live this tick
    full_probe: bool             # a full 20 s probe fired this tick
    refreshed: bool              # the forest was refit+swapped this tick
    spend_usd: float             # cumulative Eq. 1 monitoring dollars
    skipped: bool = False        # tick skipped (fault-plane outage: the
    #                              measurement was a frozen fossil)


class LifecycleManager:
    """One per controller. `predictor` is the SAME object the
    controller predicts with (the refresh swap must be visible to it);
    `seed_X`/`seed_y` are the rows its current forest was trained on
    (decayed into every refit). ``active=False`` = shadow mode."""

    def __init__(self, predictor: Any, n_dcs: int,
                 seed_X: Optional[np.ndarray] = None,
                 seed_y: Optional[np.ndarray] = None,
                 cfg: Optional[LifecycleConfig] = None,
                 active: bool = True):
        self.predictor = predictor
        self.n_dcs = int(n_dcs)
        self.cfg = cfg or LifecycleConfig()
        self.active = bool(active)
        self.seed_X = None if seed_X is None \
            else np.asarray(seed_X, np.float32)
        self.seed_y = None if seed_y is None \
            else np.asarray(seed_y, np.float32).reshape(-1)
        shape = (self.n_dcs, self.n_dcs)
        self.detector = EwmaDriftDetector(shape, self.cfg.drift)
        self.stats = ResidualStats(alpha=self.cfg.resid_alpha)
        self.window = SlidingWindow(self.cfg.window_rows)
        self.estimator = WindowedPercentileEstimator(
            shape, window=self.cfg.percentile_window,
            q=self.cfg.percentile_q)
        self.scheduler = ProbeScheduler(self.n_dcs, self.cfg.probes)
        self.records: List[LifecycleRecord] = []
        self.signals: List[DriftSignal] = []
        # lifecycle tallies on the obs registry (`refreshes` stays
        # readable as a back-compat property)
        self.metrics = MetricsRegistry("lifecycle")
        self._m_refreshes = self.metrics.counter(
            "refreshes", help="forest refits swapped in")
        self._m_signals = self.metrics.counter(
            "drift_signals", help="drift signals raised")
        self._m_ticks = self.metrics.counter(
            "ticks", help="lifecycle iterations run")
        self._last_refresh: Optional[int] = None
        self._drift_pending: Optional[int] = None   # step of open signal
        self._seen_records = 0

    # ------------------------------------------------------------------
    @property
    def refreshes(self) -> int:
        """Forest refits swapped in (registry-backed alias)."""
        return int(self._m_refreshes.value)

    def can_refresh(self) -> bool:
        """True when the predictor carries a fitted, swappable forest
        (the SnapshotPredictor ablation has none — the manager then
        detects and probes but never refits)."""
        rf = getattr(self.predictor, "forest", None)
        return rf is not None and getattr(rf, "feat", None) is not None

    def adjust_prediction(self, pred: np.ndarray) -> np.ndarray:
        """The controller's replan hook: sanity-clamp the predicted-BW
        matrix against the windowed percentile capacity (pass-through
        in shadow mode or before any sample has been observed)."""
        if not self.active:
            return np.asarray(pred, np.float64)
        return self.estimator.clamp_matrix(
            pred, headroom=self.cfg.clamp_headroom)

    # ------------------------------------------------------------------
    def tick(self, step: int, ctl: Any, sim: Any, conns: np.ndarray,
             achieved: np.ndarray,
             monitored: np.ndarray,
             measurement_ok: bool = True) -> LifecycleRecord:
        """One lifecycle iteration, called by the scenario engine after
        the step's achieved/monitored BW is known (and before the trace
        row is cut, so a lifecycle replan lands in that step's row).

        ``measurement_ok=False`` (the fault plane flags a monitor
        outage: `monitored` is a frozen fossil) skips the tick entirely
        — learning a residual against stale data would teach the drift
        detector that the PREDICTOR moved when only the monitor died."""
        N = self.n_dcs
        off = ~np.eye(N, dtype=bool)
        if not measurement_ok:
            self.metrics.counter(
                "ticks_skipped",
                help="ticks skipped on fault-plane outages").inc()
            rec = LifecycleRecord(
                step=int(step),
                resid_ewma=float(self.stats.value or 0.0),
                z_max=0.0,
                consec_max=int(self.detector.consec.max()) if N else 0,
                suspicious=self.detector.suspicious(),
                full_probe=False, refreshed=False,
                spend_usd=float(self.scheduler.spend_usd),
                skipped=True)
            self.records.append(rec)
            return rec
        achieved = np.asarray(achieved, np.float64)

        # 1. observe (free): what does the predictor say RIGHT NOW for
        # the snapshot the engine already measured, vs the BW the
        # served traffic actually achieved? Evaluating at the current
        # tick (not the last replan's stale matrix) keeps plan/AIMD
        # drift between replans out of the residual — only genuine
        # model error moves it.
        mem, cpu, retr = sim.host_metrics(conns, bw=monitored)
        pred = np.asarray(self.predictor.predict_matrix(
            N, monitored, mem, cpu, retr, sim.dist), np.float64)
        resid = np.zeros((N, N))
        resid[off] = achieved[off] / np.maximum(pred[off], 1e-9) - 1.0
        ewma = self.stats.update(resid[off])

        # 2. detect
        self._m_ticks.inc()
        sig = self.detector.update(resid, step=step)
        if sig is not None:
            self.signals.append(sig)
            self._m_signals.inc()
        suspicious = self.detector.suspicious()
        z_max = float(self.detector.last_z.max()) if N else 0.0
        consec_max = int(self.detector.consec.max()) if N else 0
        in_cooldown = (self._last_refresh is not None and
                       step - self._last_refresh
                       < self.cfg.refresh.cooldown_ticks)
        if (self.active and sig is not None and not in_cooldown
                and self._drift_pending is None and self.can_refresh()):
            # open a collection phase: everything harvested BEFORE the
            # signal describes the regime that just died — drop it and
            # refit only once enough fresh post-drift rows accumulate
            self._drift_pending = int(step)
            self.window.clear()

        # harvest: snapshot features at the in-force matrix, labeled
        # with the BW the workload actually achieved there
        X = assemble_features(N, monitored, mem, cpu, retr, sim.dist)
        self.window.push(X, achieved[off])
        self.estimator.push(achieved)

        # 3. probe: full 20 s measurement only while drift is suspected
        # (a live streak, or an open collection phase labeling the
        # refit window with clean stable-runtime rows)
        full_probe = False
        want = suspicious or self._drift_pending is not None
        if self.active and self.scheduler.want_full(step, want):
            probed = np.asarray(ctl.monitor.probe(conns), np.float64)
            self.scheduler.charge_full(step)
            self.window.push(X, probed[off])
            full_probe = True

        # 4. refresh: refit + atomic swap + re-baseline + replan
        refreshed = False
        if (self.active and self._drift_pending is not None
                and self.window.n_rows >= self.cfg.refresh.min_rows):
            wX, wy = self.window.rows()
            new_rf = refresh_forest(self.predictor.forest, wX, wy,
                                    self.seed_X, self.seed_y,
                                    self.cfg.refresh)
            self.predictor.forest = new_rf       # the atomic swap
            self._m_refreshes.inc()
            self._last_refresh = step
            self._drift_pending = None
            self.detector.reset()
            refreshed = True
            ctl.replan(reason="lifecycle", step=step)

        # snapshot accounting: every controller replan since the last
        # tick captured one 1-second snapshot (incl. a refresh replan)
        new_caps = len(ctl.record) - self._seen_records
        if new_caps > 0:
            self.scheduler.charge_snapshot(new_caps)
        self._seen_records = len(ctl.record)

        rec = LifecycleRecord(
            step=int(step), resid_ewma=float(ewma), z_max=z_max,
            consec_max=consec_max, suspicious=bool(suspicious),
            full_probe=full_probe, refreshed=refreshed,
            spend_usd=float(self.scheduler.spend_usd))
        self.records.append(rec)
        return rec
