"""Algorithm 1 — INFER_DC_RELATIONS (paper-exact).

Given a runtime BW matrix `bw` (NxN, diagonal = intra-DC) and a minimum
significant difference `D`, derive the closeness index per DC pair:
index 1 = closest (highest BW class), larger = farther.

Paper worked example: bw = {1000,400,120; 380,1000,130; 110,120,1000},
D = 30  =>  unique {110,120,130,380,400,1000} -> filtered {110,380,1000};
closeness: 1000->1, {400,380}->2, {130,120,110}->3.
"""
from __future__ import annotations


import numpy as np


def infer_dc_relations(bw: np.ndarray, D: float) -> np.ndarray:
    """Returns DC_rel (NxN int array of closeness indices, diagonal 1)."""
    bw = np.asarray(bw, dtype=np.float64)
    N = bw.shape[0]
    assert bw.shape == (N, N), "bw must be square"

    # lines 3-8: unique sorted BWs; reverse traversal removing entries
    # within D of their smaller neighbour
    bw_u = sorted(set(bw.reshape(-1).tolist()))
    i = len(bw_u) - 1
    while i >= 1:
        if bw_u[i] - bw_u[i - 1] < D:
            del bw_u[i]
        i -= 1
    bw_u = np.asarray(bw_u)
    n_u = len(bw_u)

    # lines 9-22: closeness index per pair via binary search into bw_u
    rel = np.ones((N, N), dtype=np.int64)
    for r in range(N):
        for c in range(N):
            if r == c:
                rel[r, c] = 1
                continue
            val = bw[r, c]
            k = int(np.searchsorted(bw_u, val))
            if k < n_u and bw_u[k] == val:           # match found
                rel[r, c] = n_u - (k + 1) + 1        # 1-based
            else:                                    # interval: nearest rep
                lo, hi = max(k - 1, 0), min(k, n_u - 1)
                pick = lo if (abs(val - bw_u[lo]) <= abs(bw_u[hi] - val)) else hi
                rel[r, c] = n_u - (pick + 1) + 1
    return rel
