"""EWMA drift detection over predicted-vs-achieved residuals.

The predictor exists to *replace* expensive runtime monitoring (paper
§1, Table 2) — so the cheapest possible health check is the traffic it
already serves: per pair, the relative residual between the achieved
runtime BW and the BW the predictor implies for the current snapshot.
The detector keeps
wanctl-style EWMA baselines (SNIPPETS.md §2: a slow `alpha_baseline`
mean with an EWMA variance next to it) and standardizes each new
residual against them:

    z_ij = |r_ij - mean_ij| / sqrt(max(var_ij, var_floor))

A pair is *suspicious* while z exceeds ``threshold``; the baseline is
frozen for suspicious pairs (updating it under suspicion would absorb
the very drift being measured) and a structured :class:`DriftSignal`
is raised once a pair stays suspicious for ``k_consecutive`` ticks.

Contract (pinned by the hypothesis properties in
``tests/test_lifecycle.py`` and, port against reference,
``tests/test_torch_lifecycle.py``):

  * a zero-residual stream never trips (z is identically 0);
  * any sustained residual step of standardized magnitude > threshold
    is signalled within ``k_consecutive`` ticks of its onset;
  * detection is invariant to the residual sign convention — feeding
    ``-r`` trips at exactly the same ticks as ``r``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass
class DriftConfig:
    """Knobs of the EWMA residual detector."""

    threshold: float = 4.0       # standardized-residual trip level
    k_consecutive: int = 3       # K suspicious ticks => DriftSignal
    alpha: float = 0.2           # EWMA smoothing of the mean/var baseline
    warmup: int = 10             # ticks of unconditional baseline learning
    #                              (the variance EWMA needs ~10 samples
    #                              before z-scores mean anything)
    var_floor: float = 1e-3      # variance floor (quiet streams must not
    #                              divide by ~0 and trip on roundoff:
    #                              std >= ~0.032, so a residual must move
    #                              >= threshold*0.032 from baseline)


@dataclass(frozen=True)
class DriftSignal:
    """Structured drift alarm: which pairs tripped, how hard, when."""

    step: int                               # tick index of the alarm
    pairs: Tuple[Tuple[int, int], ...]      # (i, j) with consec >= K
    z_max: float                            # worst standardized residual
    consec_max: int                         # longest suspicious streak


class EwmaDriftDetector:
    """Vectorized per-pair detector over residual matrices (pass
    ``shape=()`` for a scalar stream). ``update`` consumes one residual
    sample per tick and returns a :class:`DriftSignal` on alarm ticks,
    else None; `suspicious()` exposes the cheaper any-pair-over-
    threshold view the probe scheduler keys full probes on."""

    def __init__(self, shape: Tuple[int, ...] = (),
                 cfg: Optional[DriftConfig] = None):
        self.shape = tuple(shape)
        self.cfg = cfg or DriftConfig()
        self.reset()
        # cumulative across resets: poisoned entries seen and skipped
        # (a NaN/inf residual must never touch the EWMA baselines — one
        # NaN would otherwise corrupt mean/var permanently)
        self.nan_skipped = 0

    def reset(self) -> None:
        """Forget all baselines and streaks (post-refresh re-baseline:
        the refreshed predictor's residual regime is new)."""
        self.mean = np.zeros(self.shape)
        self.var = np.zeros(self.shape)
        self.consec = np.zeros(self.shape, np.int64)
        self.ticks = 0
        self.last_z = np.zeros(self.shape)

    def suspicious(self) -> bool:
        """True while any pair's streak is live (z over threshold on
        the latest tick) — the probe scheduler's trigger."""
        return bool((self.consec > 0).any())

    def _baseline_update(self, r: np.ndarray, where: np.ndarray) -> None:
        a = self.cfg.alpha
        d = r - self.mean
        self.mean = np.where(where, self.mean + a * d, self.mean)
        # EWMA variance around the *updated* mean (West-style):
        self.var = np.where(where, (1 - a) * (self.var + a * d * d),
                            self.var)

    def update(self, resid: np.ndarray,
               step: Optional[int] = None) -> Optional[DriftSignal]:
        """Feed one tick's residual(s); returns the DriftSignal on
        alarm ticks (every tick a streak is >= K until reset), else
        None."""
        r = np.asarray(resid, np.float64).reshape(self.shape)
        # quarantine poisoned entries: a single NaN/inf residual (a
        # lost probe, a dead link's 0/0) would otherwise corrupt the
        # EWMA mean/var PERMANENTLY. Skip-and-count: poisoned entries
        # never touch the baselines and standardize to z = 0 for the
        # tick (a poisoned tick is not evidence of drift).
        finite = np.isfinite(r)
        if not finite.all():
            self.nan_skipped += int((~finite).sum())
            fill = self.mean if self.ticks else np.zeros(self.shape)
            r = np.where(finite, r, fill)
        if self.ticks == 0:
            # seed the baseline at the first sample so constant streams
            # standardize to exactly z = 0 forever
            self.mean = r.astype(np.float64).copy()
            self.var = np.zeros(self.shape)
            self.ticks = 1
            self.last_z = np.zeros(self.shape)
            return None
        if self.ticks < self.cfg.warmup:
            self._baseline_update(r, finite)
            self.ticks += 1
            self.last_z = np.zeros(self.shape)
            return None
        z = np.abs(r - self.mean) / np.sqrt(
            np.maximum(self.var, self.cfg.var_floor))
        over = z > self.cfg.threshold
        self.consec = np.where(over, self.consec + 1, 0)
        # learn only from calm pairs: a suspicious pair's baseline is
        # frozen so sustained drift cannot talk its way into the mean
        # (and poisoned entries stay out of it entirely)
        self._baseline_update(r, ~over & finite)
        self.ticks += 1
        self.last_z = z
        tripped = self.consec >= self.cfg.k_consecutive
        if not tripped.any():
            return None
        idx = np.argwhere(tripped)
        pairs = tuple(tuple(int(v) for v in row) for row in idx)
        return DriftSignal(step=self.ticks - 1 if step is None else int(step),
                           pairs=pairs, z_max=float(z.max()),
                           consec_max=int(self.consec.max()))


@dataclass
class ResidualStats:
    """A plain (un-gated) EWMA of the mean |relative residual| — the
    accuracy series the recovery pin and the bench compare across
    frozen vs lifecycle runs, independent of detector state/resets."""

    alpha: float = 0.4
    value: Optional[float] = None
    history: list = field(default_factory=list)

    def update(self, resid: np.ndarray) -> float:
        """Feed one tick's residual matrix/vector; returns the EWMA of
        its mean absolute value. Non-finite entries (poisoned probes)
        are excluded from the mean — an all-poisoned tick repeats the
        previous value."""
        r = np.abs(np.asarray(resid, np.float64))
        finite = np.isfinite(r)
        if finite.any():
            m = float(r[finite].mean())
            self.value = m if self.value is None else \
                (1 - self.alpha) * self.value + self.alpha * m
        self.history.append(0.0 if self.value is None else self.value)
        return self.history[-1]
