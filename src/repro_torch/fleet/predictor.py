"""Batched RF inference: one CUDA kernel launch per fleet tick.

Per-job prediction would launch one kernel per job per tick (J
launches, each on a handful of rows). The fleet instead stacks every
job's Table-3 feature rows into a single [R, 6] batch and launches
ONCE, so R rows from 16 jobs cost one launch, and the packed forest
stays on the device (and in its L2) across ticks.

`kernel_calls` counts batched predictions; the fleet invariant is
exactly one per tick regardless of job count. On a CUDA device each
is one launch of the kernel (counted by `ops.rf_predict.launches`).

Port of `repro/fleet/predictor.py`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.forest import RandomForest
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs.registry import MetricsRegistry


class BatchedRfPredictor:
    """One shared forest, one kernel launch per fleet tick."""

    def __init__(self, forest: RandomForest,
                 device: Optional[Union[str, torch.device]] = None):
        """`forest` must be fitted; its packed complete-binary-tree
        arrays move to `device` (None = CUDA, which raises without a
        card) once, here, not per call."""
        if forest.feat is None:
            raise ValueError("forest must be fitted before batching")
        self.forest = forest
        self.device = resolve_device(device)
        self._packed = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in forest.packed())
        # launch accounting on the obs registry, read through
        # `kernel_calls`
        self.metrics = MetricsRegistry("predictor")
        self._m_calls = self.metrics.counter(
            "kernel_calls", help="batched RF kernel launches")
        self._m_rows = self.metrics.counter(
            "rows_total", help="feature rows predicted")

    def predict_rows(self, X: np.ndarray) -> np.ndarray:
        """Predict runtime BW for stacked feature rows [R, 6] -> [R].

        One launch regardless of how many jobs contributed rows: `X`
        goes to the device as f32, [R] comes back, and predictions are
        floored at 1 Mbps in float64 (BW is positive).
        """
        self._m_calls.inc()
        self._m_rows.inc(int(np.asarray(X).shape[0]))
        Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32))
        vals = ops.rf_predict(*self._packed, Xt.to(self.device),
                              depth=self.forest.depth)
        return np.maximum(vals.cpu().numpy().astype(np.float64), 1.0)

    @property
    def kernel_calls(self) -> int:
        """Total batched launches (registry-backed)."""
        return int(self._m_calls.value)

    def split_rows(self, vals: np.ndarray,
                   row_counts: Sequence[int]) -> list:
        """Un-stack a batched prediction back into per-job vectors."""
        out, ofs = [], 0
        for k in row_counts:
            out.append(vals[ofs:ofs + k])
            ofs += k
        if ofs != len(vals):
            raise ValueError(
                f"row counts {list(row_counts)} != batch size {len(vals)}")
        return out


def default_fleet_forest(n_samples: int = 60, n_trees: int = 8,
                         depth: int = 5, seed: int = 7,
                         cache: Optional[dict] = {}) -> RandomForest:
    """A small, deterministic forest for demos/benchmarks (module-level
    memo keyed by the arguments; pass ``cache=None`` to bypass it).
    Real deployments train via
    `repro_torch.wan.dataset.train_default_forest`.
    """
    key = (n_samples, n_trees, depth, seed)
    if cache is not None and key in cache:
        return cache[key]
    from repro_torch.wan.dataset import generate_dataset
    X, y = generate_dataset(n_samples=n_samples, seed=seed)
    rf = RandomForest(n_trees=n_trees, depth=depth, seed=seed).fit(X, y)
    if cache is not None:
        cache[key] = rf
    return rf
