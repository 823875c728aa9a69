"""Fleet arbitration: split the shared WAN across jobs BEFORE they plan.

Two resources are arbitrated every fleet tick, both by priority-weighted
fair share (Terra-style cross-job scheduling; see PAPERS.md):

* **Per-host connection budget M.** Each DC host can sustain at most
  ``m_total`` parallel WAN connections. For every DC, the jobs whose
  topology slice includes it split the budget by
  :func:`repro_torch.core.global_opt.split_budget` (largest remainder, floor
  of 1); a job's scalar budget is the MINIMUM over its DCs, so the sum
  of budgets at any host never exceeds ``m_total``.
* **Per-link capacity.** For every DC pair shared by more than one
  job, the link's estimated saturation capacity (single-connection
  snapshot BW x the parallelism knee) is split in proportion to
  priority weight. The resulting cap enters each job's
  `global_optimize` via :class:`repro_torch.control.BudgetEnvelope` — it
  clamps ``max_cons`` and joins the §3.2.2 throttle. Links used by a
  single job stay uncapped (there is no cross-job contention to
  arbitrate; WANify's own throttle still applies).

Everything here is vectorized over jobs (presence masks, one einsum per
resource), which together with the batched RF launch and the single
fleet-wide water-fill keeps the per-tick cost sublinear in job count.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.control import BudgetEnvelope
from repro_torch.core.global_opt import split_budget


def connection_budgets(presence: np.ndarray, weights: np.ndarray,
                       m_total: int) -> np.ndarray:
    """Per-job scalar connection budgets.

    presence: [J,N] bool (job j uses DC d); weights: [J] priorities.
    Returns [J] ints: job j's budget = min over its DCs of its
    largest-remainder share of ``m_total`` at that DC.
    """
    J, N = presence.shape
    budgets = np.full(J, m_total, np.int64)
    for d in range(N):
        here = np.flatnonzero(presence[:, d])
        if len(here) == 0:
            continue
        share = split_budget(m_total, weights[here])
        budgets[here] = np.minimum(budgets[here], share)
    return np.maximum(budgets, 1)


def link_shares(presence: np.ndarray, weights: np.ndarray,
                cap_est: np.ndarray) -> np.ndarray:
    """Per-job per-link capacity caps [J,N,N] (np.inf = uncapped).

    ``cap_est`` [N,N] estimates each link's saturation capacity. A pair
    contended by >1 job is split by priority weight; sole-tenant and
    unused pairs stay uncapped.
    """
    pres = presence.astype(np.float64)                       # [J,N]
    wpres = weights[:, None] * pres                          # [J,N]
    weight_sum = np.einsum("ja,jb->ab", wpres, pres)         # [N,N]
    count = np.einsum("ja,jb->ab", pres, pres)               # [N,N]
    shared = count > 1
    caps = np.full(presence.shape[:1] + cap_est.shape, np.inf)
    for j in range(len(weights)):
        on_pair = np.outer(pres[j], pres[j]) > 0
        mask = shared & on_pair
        caps[j][mask] = (cap_est * weights[j]
                         / np.maximum(weight_sum, 1e-12))[mask]
    return caps


def arbitrate(jobs: Sequence[Tuple[str, Sequence[int], float]],
              n_dcs: int, m_total: int, cap_est: np.ndarray,
              reachable: Optional[np.ndarray] = None
              ) -> Dict[str, BudgetEnvelope]:
    """Compute one :class:`BudgetEnvelope` per job.

    jobs: (name, dc_indices, priority) triples; ``cap_est`` [N,N] is
    the fleet's per-link capacity estimate at mesh scale. Each
    envelope's ``link_cap`` is returned at MESH scale — the fleet
    slices it to the job's pod scale before handing it over.

    ``reachable`` (fault plane, optional) is a bool [N,N] mask of live
    links: a DC that can reach no other DC is QUARANTINED — it stops
    counting toward budget splits (jobs that avoided the dead DC grow
    into the freed share) and every unreachable pair's cap is zeroed
    for the jobs spanning it (their envelopes shrink; the §3.2.2
    throttle then steers their connections onto surviving links).
    """
    J = len(jobs)
    if J == 0:
        return {}
    presence = np.zeros((J, n_dcs), bool)
    weights = np.ones(J)
    for j, (_, dcs, prio) in enumerate(jobs):
        presence[j, list(dcs)] = True
        weights[j] = max(float(prio), 1e-9)
    effective = presence
    if reachable is not None:
        off = ~np.eye(n_dcs, dtype=bool)
        live_dc = (np.asarray(reachable, bool) & off).any(axis=1)
        effective = presence & live_dc[None, :]
    budgets = connection_budgets(effective, weights, m_total)
    caps = link_shares(effective, weights, cap_est)
    if reachable is not None:
        dead_pair = ~np.asarray(reachable, bool)
        for j in range(J):
            # zero the cap on every dead pair the job spans — including
            # sole-tenant pairs, which link_shares leaves uncapped
            on_pair = np.outer(presence[j], presence[j])
            caps[j][on_pair & dead_pair] = 0.0
    return {name: BudgetEnvelope(max_conns=int(budgets[j]),
                                 link_cap=caps[j])
            for j, (name, _, _) in enumerate(jobs)}
