"""Bandwidth-Analyzer dataset generation (paper §4.1.1 / §5.1).

Samples (snapshot features -> stable runtime BW) across varying cluster
sizes [2, N_max], DC subsets, connection mixes and fluctuation states —
the 600-sample methodology of §5.1 scaled as requested.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.forest import RandomForest
from repro_torch.core.predictor import assemble_features
from repro_torch.wan import topology as topo
from repro_torch.wan.simulator import WanSimulator


def generate_dataset(n_samples: int = 600, n_max: int = 8, seed: int = 7,
                     max_conns: int = 8,
                     regions: Optional[List[str]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X [rows, 6], y [rows]) where each sample contributes one
    row per ordered DC pair."""
    rng = np.random.default_rng(seed)
    all_regions = regions or list(topo.DEFAULT_8DC)
    Xs, ys = [], []
    for s in range(n_samples):
        n = int(rng.integers(2, n_max + 1))
        sub = list(rng.choice(all_regions, size=n, replace=False))
        sim = WanSimulator(regions=sub, seed=int(rng.integers(1 << 30)))
        sim.advance(int(rng.integers(1, 40)))       # random network state
        # connection mix active during the workload
        conns = rng.integers(1, max_conns + 1, (n, n)).astype(float)
        np.fill_diagonal(conns, 0)
        snap = sim.measure_snapshot(conns)
        mem, cpu, retr = sim.host_metrics(conns, bw=snap)
        stable = sim.measure_runtime(conns)
        X = assemble_features(n, snap, mem, cpu, retr, sim.dist)
        off = ~np.eye(n, dtype=bool)
        Xs.append(X)
        ys.append(stable[off])
    return np.concatenate(Xs), np.concatenate(ys)


def train_default_forest(n_samples: int = 600, seed: int = 7,
                         **forest_kw) -> Tuple[RandomForest, float, float]:
    """Train the WAN Prediction Model; returns (forest, train_acc, r2)."""
    X, y = generate_dataset(n_samples=n_samples, seed=seed)
    n = len(y)
    cut = int(n * 0.85)
    rf = RandomForest(**forest_kw).fit(X[:cut], y[:cut])
    acc = rf.training_accuracy(X[:cut], y[:cut])
    r2 = rf.score(X[cut:], y[cut:])
    return rf, acc, r2
