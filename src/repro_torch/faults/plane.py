"""FaultPlane — chaos injection state + the graceful-degradation ladder.

One plane per engine run. It is the single boundary through which
control-plane faults enter the closed loop, and (when graceful) the
single place the loop degrades instead of crashing:

**Injection** (applies in BOTH modes — a fault is a fault):

  * reachability — blacked-out DCs and network partitions compose into
    one bool mask installed on the simulator
    (:meth:`WanSimulator.set_reachable`): a dead pair carries ZERO
    bandwidth, not merely low BW;
  * probe faults — a replan-time snapshot capture times out
    (:class:`ProbeTimeoutError`) or loses a deterministic subset of
    pairs (NaN holes);
  * monitor outage — the per-step monitor and replan captures return
    the last pre-outage measurement, frozen, with an age counter;
  * predictor faults — NaN or garbage-scaled rows poison the predicted
    matrix;
  * solver faults — the engine's water-fill raises
    :class:`~repro_torch.wan.simulator.WaterfillDivergence` on schedule.

**The ladder** (graceful mode only; ``REPRO_FAULTS=on``):

  1. probe retry with capped exponential backoff, every attempt priced
     through Eq. 1 (:func:`repro_torch.wan.monitor.probe_cost_usd`);
  2. bounded staleness — fall back to the last-good capture with a
     per-step staleness discount (``stale_discount ** age``);
  3. the :class:`~repro_torch.core.predictor.SnapshotPredictor` rung —
     past ``max_stale_steps`` the RF is bypassed entirely and the plan
     is built on the discounted last-good snapshot itself;
  4. NaN/outlier quarantine of poisoned predictor rows (backfilled
     from the last finite prediction);
  5. last-known-good plan rollback on water-fill divergence
     (:meth:`WanifyController.rollback_plan` — a plan-cache hit, not a
     re-lower).

With ``REPRO_FAULTS=off`` and no fault events scripted, NO plane is
constructed and no fault code runs — every historical trace golden
replays byte-identical. A timeline that scripts fault events under the
off gate gets an UNGRACEFUL plane (raw injection, no ladder): the
naive-crash ablation the chaos harness
(:mod:`repro_torch.faults.harness`) compares against.

Determinism: the plane draws from its own named stream (spawned from
the engine seed, disjoint from the simulator's fluctuation /
observation / host streams), so fault runs replay deterministically
without perturbing the non-fault streams.

Port of `repro/faults/plane.py`: host numpy, as in the JAX package, so
on the same engine seed the plane draws, injects and degrades exactly
as the reference's does; only the fills and the fleet's forest that
run around it may be on the card.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.obs.registry import MetricsRegistry

FAULT_MODES = ("off", "on")

# the plane's own RNG stream tag (disjoint from the simulator's
# SeedSequence.spawn(3) children by construction)
_FAULT_STREAM = 0xFA17


def faults_mode(mode: Optional[str] = None) -> str:
    """Resolve the fault gate: an explicit argument wins, then the
    ``REPRO_FAULTS`` environment variable, then ``off`` (the
    byte-identical historical path)."""
    m = mode or os.environ.get("REPRO_FAULTS", "off")
    if m not in FAULT_MODES:
        raise ValueError(f"unknown faults mode {m!r}; "
                         f"expected one of {FAULT_MODES}")
    return m


class ProbeTimeoutError(RuntimeError):
    """A replan-time snapshot capture timed out (injected). The naive
    ablation lets this propagate — the run dies exactly like a
    deployment with no retry/staleness ladder would."""


@dataclass
class FaultConfig:
    """Knobs of the degradation ladder."""

    probe_retries: int = 3        # capture retry budget per replan
    backoff_base: float = 2.0     # retry k costs base**k snapshots...
    backoff_cap: float = 4.0      # ...capped at this multiple (Eq. 1)
    stale_discount: float = 0.9   # last-good BW haircut per stale step
    max_stale_steps: int = 6      # beyond: the SnapshotPredictor rung
    outlier_factor: float = 4.0   # pred > factor x last-good = poisoned
    loss_frac: float = 0.5        # pair-drop probability under ProbeLoss


class FaultPlane:
    """Injection state + graceful-degradation ladder for one run."""

    def __init__(self, n_dcs: int, graceful: bool = True, seed: int = 0,
                 cfg: Optional[FaultConfig] = None):
        self.N = int(n_dcs)
        self.graceful = bool(graceful)
        self.cfg = cfg or FaultConfig()
        self.step = 0                      # synced by the owning engine
        self.rng = np.random.default_rng(
            np.random.SeedSequence([_FAULT_STREAM, int(seed)]))
        self.log: List[str] = []
        # -- injection state ------------------------------------------
        self.down: Set[int] = set()            # blacked-out DC indices
        self.partition: Optional[Tuple[Tuple[int, ...], ...]] = None
        self._probe_kind: Optional[str] = None     # "timeout" | "loss"
        self._probe_until = -1
        self._probe_frac = self.cfg.loss_frac
        self._outage_start = -1
        self._outage_until = -1
        self._pred_kind = "nan"
        self._pred_until = -1
        self._pred_rows = 2
        self._solver_until = -1
        # -- ladder state ---------------------------------------------
        self.last_good: Optional[Dict[str, np.ndarray]] = None
        self.last_good_step = -1
        self.last_measure: Optional[np.ndarray] = None
        self.last_pred: Optional[np.ndarray] = None
        # -- counters (obs plane; watched by the engine tracer) -------
        self.metrics = MetricsRegistry("faults")
        self._m_retries = self.metrics.counter(
            "probe_retries", help="capture retries under probe faults")
        self._m_retry_usd = self.metrics.counter(
            "retry_usd", help="Eq. 1 dollars spent on capture retries")
        self._m_stale = self.metrics.counter(
            "stale_fallbacks", help="replans served the last-good "
            "capture with a staleness discount")
        self._m_snapfall = self.metrics.counter(
            "snapshot_fallbacks", help="replans past max_stale_steps — "
            "RF bypassed for the SnapshotPredictor rung")
        self._m_backfill = self.metrics.counter(
            "pairs_backfilled", help="lost probe pairs filled from the "
            "last-good capture")
        self._m_rows = self.metrics.counter(
            "rows_quarantined", help="poisoned predictor rows replaced")
        self._m_rollbacks = self.metrics.counter(
            "rollbacks", help="last-known-good plan rollbacks after "
            "water-fill divergence")
        self._m_outage = self.metrics.counter(
            "outage_ticks", help="steps served a frozen measurement")

    # ------------------------------------------------------------------
    # injection setters (fault-event targets)
    # ------------------------------------------------------------------
    def _note(self, kind: str, msg: str) -> None:
        self.metrics.counter("injected", labels={"kind": kind}).inc()
        self.log.append(f"step {self.step}: {msg}")

    def blackout(self, dc: int) -> None:
        """Full-node loss: every link touching `dc` goes unreachable."""
        self.down.add(int(dc))
        self._note("dc_blackout", f"DC {dc} blacked out")

    def restore(self, dc: int) -> None:
        """Bring a blacked-out DC back."""
        self.down.discard(int(dc))
        self._note("dc_restore", f"DC {dc} restored")

    def set_partition(self, groups: Sequence[Sequence[int]]) -> None:
        """Network partition: DCs in DIFFERENT groups cannot reach each
        other; DCs in no group keep full reachability."""
        self.partition = tuple(tuple(int(d) for d in g) for g in groups)
        self._note("partition", f"partition {self.partition}")

    def heal_partition(self) -> None:
        """Heal the partition (blackouts, if any, stay in force)."""
        self.partition = None
        self._note("partition_heal", "partition healed")

    def probe_fault(self, kind: str, duration: int,
                    frac: Optional[float] = None) -> None:
        """Probes fail for `duration` steps from now: ``"timeout"``
        (the whole capture hangs) or ``"loss"`` (a `frac` subset of
        pairs returns nothing per attempt)."""
        if kind not in ("timeout", "loss"):
            raise ValueError(f"unknown probe fault kind {kind!r}")
        self._probe_kind = kind
        self._probe_until = self.step + int(duration)
        if frac is not None:
            self._probe_frac = float(frac)
        self._note(f"probe_{kind}", f"probes {kind} for {duration} steps")

    def monitor_outage(self, duration: int) -> None:
        """The monitoring pipeline freezes: every measurement for
        `duration` steps repeats the last pre-outage value."""
        self._outage_start = self.step
        self._outage_until = self.step + int(duration)
        self._note("monitor_outage", f"monitor dark for {duration} steps")

    def predictor_fault(self, duration: int, kind: str = "nan",
                        rows: int = 2) -> None:
        """Poison `rows` predicted-BW rows per replan for `duration`
        steps: ``"nan"`` rows or ``"garbage"`` (lognormal-scaled)."""
        if kind not in ("nan", "garbage"):
            raise ValueError(f"unknown predictor fault kind {kind!r}")
        self._pred_kind = kind
        self._pred_until = self.step + int(duration)
        self._pred_rows = int(rows)
        self._note("predictor_fault",
                   f"predictor emits {kind} rows for {duration} steps")

    def solver_fault(self, duration: int = 1) -> None:
        """The engine's water-fill diverges for `duration` steps."""
        self._solver_until = self.step + int(duration)
        self._note("solver_fault", f"water-fill diverges for "
                   f"{duration} steps")

    # ------------------------------------------------------------------
    # injection queries
    # ------------------------------------------------------------------
    def probe_failing(self, step: int) -> Optional[str]:
        """The active probe-fault kind at `step`, or None."""
        return self._probe_kind if step < self._probe_until else None

    def monitor_dark(self, step: int) -> bool:
        """True while the monitoring pipeline is frozen."""
        return step < self._outage_until

    def predictor_failing(self, step: int) -> bool:
        """True while predictor rows are being poisoned."""
        return step < self._pred_until

    def solver_failing(self, step: int) -> bool:
        """True while the water-fill is scripted to diverge."""
        return step < self._solver_until

    def reachable_mask(self) -> Optional[np.ndarray]:
        """Compose blackouts + partition into one bool [N,N] mask
        (None = fully reachable, the no-mask historical path)."""
        if not self.down and self.partition is None:
            return None
        m = np.ones((self.N, self.N), bool)
        for d in self.down:
            m[d, :] = False
            m[:, d] = False
        if self.partition is not None:
            group = {}
            for gi, g in enumerate(self.partition):
                for d in g:
                    group[d] = gi
            for i, gi in group.items():
                for j, gj in group.items():
                    if gi != gj:
                        m[i, j] = False
        np.fill_diagonal(m, True)
        return m

    def apply_reachability(self, sim: Any) -> None:
        """Install the composed mask on the simulator (fault-event
        epilogue; None clears any previous mask)."""
        sim.set_reachable(self.reachable_mask())

    # ------------------------------------------------------------------
    # the degradation ladder (controller/engine call-ins)
    # ------------------------------------------------------------------
    def _charge_retry(self, attempt: int, n_dcs: int) -> None:
        from repro_torch.wan.monitor import SNAPSHOT_SECONDS, probe_cost_usd
        mult = min(self.cfg.backoff_base ** attempt, self.cfg.backoff_cap)
        self._m_retries.inc()
        self._m_retry_usd.inc(probe_cost_usd(SNAPSHOT_SECONDS, n_dcs)
                              * mult)

    def _remember(self, raw: Dict[str, np.ndarray]) -> None:
        self.last_good = {k: (np.array(v, copy=True)
                              if isinstance(v, np.ndarray) else v)
                          for k, v in raw.items()}
        self.last_good_step = self.step

    def _stale_capture(self) -> Tuple[Dict[str, np.ndarray],
                                      Optional[np.ndarray]]:
        """Rungs 2-3: the last-good capture with a staleness discount on
        its BW; past ``max_stale_steps`` also return a prediction
        override (the SnapshotPredictor rung — planning on a heavily
        discounted snapshot instead of feeding the RF fossil data)."""
        age = max(self.step - self.last_good_step, 1)
        disc = self.cfg.stale_discount ** age
        raw = {k: (np.array(v, copy=True)
                   if isinstance(v, np.ndarray) else v)
               for k, v in self.last_good.items()}
        raw["snapshot_bw"] = raw["snapshot_bw"] * disc
        if age > self.cfg.max_stale_steps:
            self._m_snapfall.inc()
            from repro_torch.wan.topology import INTRA_DC_BW
            pred = np.maximum(raw["snapshot_bw"], 1.0)
            np.fill_diagonal(pred, INTRA_DC_BW)
            return raw, pred
        self._m_stale.inc()
        return raw, None

    def captured(self, monitor: Any, conns: np.ndarray
                 ) -> Tuple[Dict[str, np.ndarray], Optional[np.ndarray]]:
        """The controller's replan-time capture through the fault
        boundary. Returns ``(raw, pred_override)`` — `pred_override`
        is non-None only when the ladder bottomed out at the
        SnapshotPredictor rung. Naive mode applies the raw injection
        (timeout raises, loss leaves NaN holes, outage silently serves
        frozen data) with no ladder at all."""
        step = self.step
        n = monitor.sim.N
        if self.monitor_dark(step) and self.last_good is not None:
            if not self.graceful:
                # naive: silently stale — planning on a fossil capture
                return ({k: (np.array(v, copy=True)
                             if isinstance(v, np.ndarray) else v)
                         for k, v in self.last_good.items()}, None)
            return self._stale_capture()
        kind = self.probe_failing(step)
        if kind == "timeout":
            if not self.graceful:
                raise ProbeTimeoutError(
                    f"snapshot capture timed out at step {step}")
            # rung 1: retry with capped exponential backoff, each
            # attempt Eq. 1-priced; the fault window covers the whole
            # step, so every retry fails and we fall through to rungs
            # 2-3 (unless there is no last-good capture yet, in which
            # case a real capture is the only option left)
            for a in range(self.cfg.probe_retries):
                self._charge_retry(a, n)
            if self.last_good is not None:
                return self._stale_capture()
        if kind == "loss":
            return self._lossy_capture(monitor, conns)
        _, raw = monitor.capture(conns)
        self._remember(raw)
        return raw, None

    def _lossy_capture(self, monitor: Any, conns: np.ndarray
                       ) -> Tuple[Dict[str, np.ndarray],
                                  Optional[np.ndarray]]:
        """ProbeLoss: each attempt loses a deterministic subset of
        pairs. Naive keeps the holes (NaN snapshot entries flow into
        the predictor). Graceful retries per-pair (each attempt Eq. 1
        priced) and backfills any still-missing pair from the
        discounted last-good capture."""
        n = monitor.sim.N
        off = ~np.eye(self.N, dtype=bool)
        _, raw = monitor.capture(conns)
        snap = np.array(raw["snapshot_bw"], copy=True)
        lost = (self.rng.random((self.N, self.N)) < self._probe_frac) & off
        snap[lost] = np.nan
        if not self.graceful:
            raw = dict(raw)
            raw["snapshot_bw"] = snap
            return raw, None
        for a in range(self.cfg.probe_retries):
            if not np.isnan(snap).any():
                break
            self._charge_retry(a, n)
            _, again = monitor.capture(conns)
            redrop = (self.rng.random((self.N, self.N))
                      < self._probe_frac) & off
            fresh = np.array(again["snapshot_bw"], copy=True)
            fresh[redrop] = np.nan
            hole = np.isnan(snap) & ~np.isnan(fresh)
            snap[hole] = fresh[hole]
        hole = np.isnan(snap)
        if hole.any():
            self._m_backfill.inc(int(hole.sum()))
            if self.last_good is not None:
                age = max(self.step - self.last_good_step, 1)
                disc = self.cfg.stale_discount ** age
                snap[hole] = (self.last_good["snapshot_bw"] * disc)[hole]
            else:
                snap[hole] = 1.0           # the monitor's floor value
        raw = dict(raw)
        raw["snapshot_bw"] = snap
        self._remember(raw)
        return raw, None

    def measured(self, monitor: Any, conns: np.ndarray
                 ) -> Tuple[np.ndarray, bool]:
        """The engine's per-step monitor sample through the fault
        boundary. Returns ``(monitored, ok)`` — ``ok=False`` flags a
        frozen (outage) sample so the lifecycle drift detector skips
        the tick instead of learning from a fossil measurement."""
        if self.monitor_dark(self.step) and self.last_measure is not None:
            self._m_outage.inc()
            return np.array(self.last_measure, copy=True), False
        m = monitor.measure(conns)
        self.last_measure = np.array(m, copy=True)
        return m, True

    def predicted(self, pred: np.ndarray,
                  snapshot: np.ndarray) -> np.ndarray:
        """The controller's post-prediction hook: inject any scripted
        predictor fault (both modes), then — graceful only — rung 4:
        quarantine non-finite / negative / outlier entries, backfilled
        from the last finite prediction (or the snapshot floor)."""
        pred = np.array(pred, np.float64, copy=True)
        if self.predictor_failing(self.step):
            k = min(self._pred_rows, self.N)
            rows = self.rng.choice(self.N, size=k, replace=False)
            if self._pred_kind == "nan":
                pred[rows, :] = np.nan
            else:
                pred[rows, :] *= self.rng.lognormal(4.0, 1.0,
                                                    (k, 1))
        if self.graceful:
            pred = self.sanitize_matrix(pred, snapshot,
                                        reference=self.last_pred)
            self.last_pred = np.array(pred, copy=True)
        return pred

    def sanitize_matrix(self, pred: np.ndarray, snapshot: np.ndarray,
                        reference: Optional[np.ndarray] = None
                        ) -> np.ndarray:
        """Rung 4, stateless form (the fleet uses this per job):
        replace non-finite, negative, or outlier entries (beyond
        ``outlier_factor`` x the reference) with the reference value —
        the last finite prediction, else the snapshot clamped to the
        monitor's 1 Mbps floor."""
        pred = np.array(pred, np.float64, copy=True)
        ref = reference if reference is not None \
            else np.maximum(np.asarray(snapshot, np.float64), 1.0)
        bad = (~np.isfinite(pred)) | (pred < 0.0) \
            | (pred > self.cfg.outlier_factor * np.maximum(ref, 1.0))
        if bad.any():
            self._m_rows.inc(len(np.unique(np.argwhere(bad)[:, 0])))
            pred[bad] = ref[bad]
        return pred

    def note_rollback(self) -> None:
        """Count a last-known-good plan rollback (rung 5)."""
        self._m_rollbacks.inc()

    # ------------------------------------------------------------------
    @property
    def rollbacks(self) -> int:
        """Plan rollbacks performed (registry-backed alias)."""
        return int(self._m_rollbacks.value)

    @property
    def retry_usd(self) -> float:
        """Eq. 1 dollars spent on capture retries (registry-backed)."""
        return float(self._m_retry_usd.value)
