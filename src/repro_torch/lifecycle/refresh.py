"""Deterministic incremental RF refresh (paper §3.3.4, taken online).

The frozen predictor's failure mode is a regime change it never
trained on (a `provider_shift` halves every link; its trees keep
predicting pre-shift runtime BW for post-shift snapshots). The refresh
path refits the forest on

    decayed seed data  ∪  the live harvest window

where the seed set — the rows the current forest was originally
trained on — is DETERMINISTICALLY subsampled down to a `seed_decay`
fraction (same seed, same subsample), so old-regime knowledge fades
instead of vanishing, and the fresh window anchors the new regime.

Everything is seeded: the same (seed data, window, seed) always yields
bit-identical packed ``(feat, thr, leaf)`` tensors, which is what
makes the atomic swap safe to reason about — the swapped-in model is a
pure function of its inputs, and the controller's plan-cache
signatures change only because the *predictions* change, never because
retraining itself is noisy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.forest import RandomForest


@dataclass
class RefreshConfig:
    """Knobs of the incremental refit."""

    min_rows: int = 224          # fresh post-drift rows before a refit
    #                              (4 ticks of an 8-DC mesh: refitting
    #                              on a sliver of the new regime swaps
    #                              in a worse forest than waiting)
    seed_decay: float = 0.25     # fraction of seed rows kept per refit
    #                              (retention, not domination: the new
    #                              regime's rows must outweigh the old)
    cooldown_ticks: int = 5      # min ticks between two refits
    seed: int = 0                # rng seed for subsample AND tree fits


def decay_seed_data(X: np.ndarray, y: np.ndarray, decay: float,
                    seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic subsample keeping ``floor(decay * n)`` seed rows
    (sorted indices, so row order — and therefore the downstream fit —
    is reproducible; decay<=0 or an empty seed set yields 0 rows)."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32).reshape(-1)
    n = len(y)
    keep = int(np.floor(max(0.0, min(1.0, decay)) * n))
    if keep <= 0:
        return X[:0], y[:0]
    idx = np.sort(np.random.default_rng(seed).choice(n, size=keep,
                                                     replace=False))
    return X[idx], y[idx]


def refresh_forest(template: RandomForest,
                   window_X: np.ndarray, window_y: np.ndarray,
                   seed_X: Optional[np.ndarray] = None,
                   seed_y: Optional[np.ndarray] = None,
                   cfg: Optional[RefreshConfig] = None) -> RandomForest:
    """Fit a NEW forest (``template.spawn``'s hyperparameters) on the
    harvest window plus the decayed seed set, and return it — the
    caller swaps it in with one reference assignment. Raises on an
    empty training set; never mutates `template`."""
    cfg = cfg or RefreshConfig()
    parts_X = [np.asarray(window_X, np.float32)]
    parts_y = [np.asarray(window_y, np.float32).reshape(-1)]
    if seed_X is not None and seed_y is not None and len(seed_y):
        dx, dy = decay_seed_data(seed_X, seed_y, cfg.seed_decay, cfg.seed)
        if len(dy):
            parts_X.insert(0, dx)
            parts_y.insert(0, dy)
    X = np.concatenate(parts_X)
    y = np.concatenate(parts_y)
    if len(y) == 0:
        raise ValueError("refresh_forest: empty training set "
                         "(no window rows and no seed data)")
    return template.spawn(seed=cfg.seed).fit(X, y)
