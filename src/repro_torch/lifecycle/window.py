"""Sliding-window state for the online predictor lifecycle.

Two consumers share the window idea:

  * :class:`SlidingWindow` — the refresh layer's training buffer: live
    ``(features, achieved_bw)`` rows harvested from the traffic the
    controller already serves (iftop-style observation of the
    workload's own transfers is free — no probe traffic, the paper's
    §1 cost axis), bounded to the newest ``capacity`` rows.
  * :class:`WindowedPercentileEstimator` — the cloudgenix
    95th-percentile-over-PCM approach (SNIPPETS.md §1): per-pair
    capacity as a percentile of the last W achieved-BW samples. No ML,
    a few hundred floats of state — the fallback estimator when no
    forest is available, and a sanity clamp on RF outputs (a refreshed
    forest mid-drift must not promise BW the link has never shown).
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np


class SlidingWindow:
    """FIFO row buffer of (X [n,F], y [n]) harvest chunks, trimmed to
    the newest `capacity` rows (oldest rows fall off chunk by chunk,
    partially when a chunk straddles the boundary)."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._chunks: deque = deque()
        self.n_rows = 0

    def push(self, X: np.ndarray, y: np.ndarray) -> None:
        """Append one harvest chunk (rows are kept newest-first at the
        tail; the head is trimmed down to `capacity` total rows)."""
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32).reshape(-1)
        if X.shape[0] != y.shape[0]:
            raise ValueError(f"X rows {X.shape[0]} != y rows {y.shape[0]}")
        self._chunks.append((X, y))
        self.n_rows += len(y)
        while self.n_rows > self.capacity:
            cx, cy = self._chunks.popleft()
            excess = self.n_rows - self.capacity
            if len(cy) <= excess:
                self.n_rows -= len(cy)
            else:
                self._chunks.appendleft((cx[excess:], cy[excess:]))
                self.n_rows -= excess
        assert self.n_rows <= self.capacity

    def clear(self) -> None:
        """Drop every buffered row (drift invalidates the harvest: rows
        observed before the signal describe the regime that died)."""
        self._chunks.clear()
        self.n_rows = 0

    def rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """The buffered (X, y), oldest row first (empty arrays when no
        harvest has landed yet)."""
        if not self._chunks:
            return np.zeros((0, 6), np.float32), np.zeros(0, np.float32)
        return (np.concatenate([c[0] for c in self._chunks]),
                np.concatenate([c[1] for c in self._chunks]))


class WindowedPercentileEstimator:
    """Per-pair q-th-percentile capacity over the last `window`
    achieved-BW samples (linear-interpolation percentile, so the
    output always lies within the window's per-pair data range and is
    monotone in q — both pinned by hypothesis properties)."""

    def __init__(self, shape: Tuple[int, ...], window: int = 16,
                 q: float = 95.0):
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100], got {q}")
        self.shape = tuple(shape)
        self.window = int(window)
        self.q = float(q)
        self._buf: deque = deque(maxlen=self.window)

    @property
    def n_samples(self) -> int:
        """Samples currently in the window (<= `window`)."""
        return len(self._buf)

    def push(self, sample: np.ndarray) -> None:
        """Add one achieved-BW sample (oldest rolls off at capacity)."""
        s = np.asarray(sample, np.float64).reshape(self.shape)
        self._buf.append(s.copy())

    def capacity(self, q: Optional[float] = None) -> Optional[np.ndarray]:
        """The per-pair percentile over the window (None before any
        sample has been pushed)."""
        if not self._buf:
            return None
        stack = np.stack(list(self._buf))
        return np.percentile(stack, self.q if q is None else float(q),
                             axis=0)

    def clamp_matrix(self, pred: np.ndarray, headroom: float = 1.5,
                     floor: float = 1.0) -> np.ndarray:
        """Sanity-clamp an RF prediction matrix: no off-diagonal pair
        may promise more than ``headroom`` x its windowed percentile
        capacity (the diagonal — intra-DC BW — is never touched, and
        with an empty window the prediction passes through unchanged).
        """
        cap = self.capacity()
        out = np.asarray(pred, np.float64).copy()
        if cap is None:
            return out
        limit = np.maximum(headroom * cap, floor)
        off = ~np.eye(out.shape[0], dtype=bool)
        out[off] = np.minimum(out[off], limit[off])
        return out
