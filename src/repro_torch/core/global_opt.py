"""Static global optimization (paper §3.2.1, Eq. 2-3).

Converts predicted runtime BWs into an optimal RANGE of heterogeneous
connection counts per DC pair — weak/distant links get more parallel
connections from each DC's limited per-host budget M; achievable BW is
modelled as (predicted single-connection BW x connections), which the
paper validates empirically ("runtime BW grows linearly with the
connections").

Paper worked example (tested in tests/test_global_opt.py):
  DC_rel={1,2,3;2,1,3;3,3,1}, M=8 -> minCons all ones,
  maxCons (formula, before diagonal override) = {3,6,8;6,3,8;8,8,3}.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.relations import infer_dc_relations


@dataclass
class GlobalPlan:
    """Eq. 2-3 output: per-pair connection RANGES plus the achievable
    BW at each end of the range and the §3.2.2 throttle caps."""

    pred_bw: np.ndarray        # [N,N] predicted runtime BW (Mbps)
    dc_rel: np.ndarray         # [N,N] closeness indices
    min_cons: np.ndarray       # [N,N] int
    max_cons: np.ndarray       # [N,N] int
    min_bw: np.ndarray         # [N,N] achievable @ min_cons
    max_bw: np.ndarray         # [N,N] achievable @ max_cons
    throttle: np.ndarray       # [N,N] per-link BW cap (inf = uncapped)

    @property
    def n(self) -> int:
        """Number of DCs the plan covers."""
        return self.pred_bw.shape[0]


def _pair_weights(N: int, w_s: Optional[np.ndarray]) -> np.ndarray:
    """Skew weights (§3.3.1): per-DC data-volume weights -> pair weights,
    normalized to mean 1 so the total connection budget is preserved."""
    if w_s is None:
        return np.ones((N, N))
    w = np.asarray(w_s, np.float64)
    pair = np.maximum(w[:, None], w[None, :])
    off = ~np.eye(N, dtype=bool)
    pair = pair / pair[off].mean()
    return pair


def _refactor(N: int, r_vec: Optional[np.ndarray]) -> np.ndarray:
    """Provider/VM heterogeneity (§3.3.3): per-DC factors -> pairwise
    geometric-mean matrix (default all ones)."""
    if r_vec is None:
        return np.ones((N, N))
    r = np.asarray(r_vec, np.float64)
    if r.ndim == 2:
        return r
    return np.sqrt(r[:, None] * r[None, :])


def split_budget(M: int, weights: np.ndarray) -> np.ndarray:
    """Weighted fair-share of a per-host connection budget M across
    tenants (fleet arbitration): largest-remainder apportionment of
    ``M * w_j / sum(w)`` with a floor of one connection per tenant.

    Invariants (tested): every share >= 1; ``sum(shares) <= M``
    whenever ``M >= len(weights)`` (a host's connection table is never
    oversubscribed); shares are monotone in weight.
    """
    w = np.asarray(weights, np.float64)
    J = len(w)
    if J == 0:
        return np.zeros(0, np.int64)
    w = np.maximum(w, 1e-9)
    if M <= J:
        return np.ones(J, np.int64)        # floor dominates; may equal M=J
    quota = M * w / w.sum()
    share = np.floor(quota).astype(np.int64)
    frac = quota - share
    # stable largest-remainder: ties break toward the earlier tenant
    order = np.argsort(-frac, kind="stable")
    share[order[:M - int(share.sum())]] += 1
    share = np.maximum(share, 1)
    while share.sum() > M:                 # repay the floor bumps
        rich = int(np.argmax(share))
        if share[rich] <= 1:
            break
        share[rich] -= 1
    return share


def relay_candidates(dc_rel: np.ndarray, i: int, j: int,
                     max_candidates: int = 4) -> List[int]:
    """Closeness-pruned one-hop relay candidates for the pair (i, j)
    (the overlay router's bounded search, `repro.overlay.routing`).

    A DC k qualifies when BOTH hops i->k and k->j sit in a closeness
    class at least as near as the direct pair's (Algorithm 1 indices:
    smaller = closer) — a relay whose hops are farther than the link it
    bypasses can't beat it under the distance-monotone BW model, so it
    is never scored. Candidates are ordered nearest classes first
    (ties toward the lower DC index) and truncated to `max_candidates`.
    """
    rel = np.asarray(dc_rel)
    P = rel.shape[0]
    out = [k for k in range(P)
           if k != i and k != j
           and rel[i, k] <= rel[i, j] and rel[k, j] <= rel[i, j]]
    out.sort(key=lambda k: (int(rel[i, k]) + int(rel[k, j]), k))
    return out[:max_candidates]


def global_optimize(pred_bw: np.ndarray, *, M: int = 8, D: float = 100.0,
                    w_s: Optional[np.ndarray] = None,
                    r_vec: Optional[np.ndarray] = None,
                    throttle_enabled: bool = True,
                    dc_rel: Optional[np.ndarray] = None,
                    link_cap: Optional[np.ndarray] = None) -> GlobalPlan:
    """pred_bw: [N,N] predicted runtime BW; M: per-host max parallel
    connections; D: min significant BW difference (Algorithm 1 input).

    `link_cap` is an externally arbitrated per-link BW ceiling [N,N]
    (np.inf = uncapped) — a fleet controller's fair-share envelope. It
    clamps `max_cons` (budget spent past the cap buys nothing) and
    joins the §3.2.2 throttle, so a capped plan never targets more
    than its credited share.
    """
    bw = np.asarray(pred_bw, np.float64)
    N = bw.shape[0]
    rel = infer_dc_relations(bw, D) if dc_rel is None else np.asarray(dc_rel)
    ws = _pair_weights(N, w_s)
    rv = _refactor(N, r_vec)

    # Eq. 2
    sum_all = float(rel.sum() - N)                 # skip closeness-1 diagonal
    max_r = rel.max(axis=1).astype(np.float64)     # row-wise maxima

    # Eq. 3
    min_candidate = np.floor(rel / sum_all * (M - 1))
    min_cons = np.maximum(min_candidate, 1.0) * ws
    max_cons = np.ceil(M * rel / max_r[:, None]) * ws
    np.fill_diagonal(min_cons, 1.0)
    np.fill_diagonal(max_cons, 1.0)                # single conn within a DC
    min_cons = np.clip(np.rint(min_cons), 1, 2 * M).astype(np.int64)
    max_cons = np.clip(np.rint(max_cons), 1, 2 * M).astype(np.int64)
    max_cons = np.maximum(max_cons, min_cons)

    if link_cap is not None:
        lc = np.asarray(link_cap, np.float64)
        capped = np.isfinite(lc) & ~np.eye(N, dtype=bool)
        # connections past ceil(cap / unit_bw) cannot raise credited BW
        cap_cons = np.ceil(lc / np.maximum(bw * rv, 1e-9))
        cap_cons = np.maximum(np.where(capped, cap_cons, max_cons), 1)
        cap_cons = np.minimum(cap_cons, 2 * M)     # int-safe ceiling
        max_cons = np.minimum(max_cons, cap_cons.astype(np.int64))
        max_cons = np.maximum(max_cons, 1)
        min_cons = np.minimum(min_cons, max_cons)

    min_bw = bw * min_cons * rv
    max_bw = bw * max_cons * rv

    # Throttling (§3.2.2): cap BW-rich destinations at the row mean of
    # achievable BW so distant pairs can use the shared NIC capacity.
    # Vectorized over rows; max_bw[off].reshape(N, N-1) keeps each
    # row's off-diagonal entries contiguous in the historical order,
    # so the row means are bit-identical to the per-row loop.
    throttle = np.full((N, N), np.inf)
    if throttle_enabled and N > 1:
        off = ~np.eye(N, dtype=bool)
        T = max_bw[off].reshape(N, N - 1).mean(axis=1)
        rich = off & (max_bw > T[:, None])
        throttle[rich] = np.broadcast_to(T[:, None], (N, N))[rich]
    if link_cap is not None:
        off = ~np.eye(N, dtype=bool)
        throttle[off] = np.minimum(throttle, np.asarray(link_cap,
                                                        np.float64))[off]
    return GlobalPlan(bw, rel, min_cons, max_cons, min_bw, max_bw, throttle)
