"""PlacementPlanner — the consumer that closes the paper's loop: from
predicted runtime WAN BW to the data/task placement decisions it is
supposed to improve (§2's motivating example, §5's latency/cost
tables).

The planner rides a :class:`WanifyController`: it registers on the
controller's replan trace stream (`add_trace_hook`), so every trigger
the paper replans on — periodic, straggler, topology change, BW shift,
a fleet tick — also re-places the query under the fresh plan. Pricing
is `achievable_bw(plan)` (predicted BW x heterogeneous connections),
clamped by the controller's arbitrated :class:`BudgetEnvelope` when the
job runs in a fleet — a low-priority tenant prices its placement
against its fair share, not the raw link.

Two backends reproduce the paper's comparison:

  * ``wanify`` — re-places on every replan, priced at the plan's
    predicted BW x conns; the workload executes at the plan's
    heterogeneous connection matrix.
  * ``static`` — the existing-GDA-systems ablation: one expensive
    static single-connection measurement up front (`measure_static_
    independent`), one placement, never revisited; the workload
    executes single-connection.

`records` is the per-query placement trace (step, trigger reason,
estimated makespan/egress, the fraction vectors) a harness can line up
against ground truth.

Port of `repro/placement/planner.py`. The overlay is not yet ported
(the controller raises for ``overlay="on"``), so pricing is always the
direct surface.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch.control import WanifyController
from repro_torch.placement.cost import (PlacementCost, achievable_bw,
                                        estimate_cost)
from repro_torch.placement.optimizer import (PlacementDecision, SearchTask,
                                             greedy_place)
from repro_torch.placement.query import QuerySpec
from repro_torch.wan.monitor import egress_price_vector
from repro_torch.wan.topology import KNEE_CONNS

BACKENDS = ("wanify", "static")


@dataclass(frozen=True)
class PlacementRecord:
    """One (re-)placement: when, why, and what the planner believed."""

    step: Optional[int]
    reason: str
    backend: str
    makespan_est_s: float
    egress_est_usd: float
    placement: Tuple[Tuple[float, ...], ...]


class PlacementPlanner:
    """BW-aware placement for one query riding one controller."""

    def __init__(self, controller: WanifyController, query: QuerySpec, *,
                 backend: str = "wanify",
                 static_bw: Optional[np.ndarray] = None,
                 egress_usd_per_gb: Any = None,
                 coarse: float = 0.1, fine: float = 0.02,
                 rel_tol: float = 0.01):
        """`static_bw` overrides the ``static`` backend's one-shot
        estimate (required when the controller's sim has no
        `measure_static_independent`, e.g. a fleet `TenantView`)."""
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        if query.n != controller.n_pods:
            raise ValueError(
                f"query spans {query.n} DCs but the controller plans "
                f"{controller.n_pods} pods; build the workload with "
                f"n={controller.n_pods}")
        self.controller = controller
        self.query = query
        self.backend = backend
        self._opt = dict(coarse=coarse, fine=fine, rel_tol=rel_tol)
        if egress_usd_per_gb is None:
            regions = getattr(controller.sim, "regions", None)
            if regions is not None:
                egress_usd_per_gb = egress_price_vector(
                    regions[:controller.n_pods])
        self.egress_usd_per_gb = egress_usd_per_gb
        self._static_bw: Optional[np.ndarray] = None
        if backend == "static":
            if static_bw is None:
                measure = getattr(controller.sim,
                                  "measure_static_independent", None)
                if measure is None:
                    raise ValueError(
                        "static backend needs static_bw= when the sim "
                        "has no measure_static_independent (fleet "
                        "TenantView slices don't)")
                P = controller.n_pods
                static_bw = measure()[:P, :P]
            self._static_bw = np.asarray(static_bw, np.float64)
            if self._static_bw.shape != (query.n, query.n):
                raise ValueError(
                    f"static_bw shape {self._static_bw.shape} != "
                    f"({query.n}, {query.n})")
        self.records: List[PlacementRecord] = []
        self.placement: np.ndarray = np.zeros(0)
        self._detached = False
        self._deferred = False
        self._pending: Optional[Tuple[str, Optional[int]]] = None
        self._replace(reason="init", step=None)
        if backend == "wanify":
            controller.add_trace_hook(self._on_replan)

    def detach(self) -> None:
        """Stop re-placing on controller replans (the hook itself stays
        chained but becomes a no-op). Call this before building a
        replacement planner on the same controller — e.g. a second
        `FleetController.job_planner` for the same job — so the
        abandoned planner stops burning search work every tick."""
        self._detached = True

    # ------------------------------------------------------------------
    # pricing
    # ------------------------------------------------------------------
    def priced_bw(self) -> np.ndarray:
        """The [P,P] achievable-BW matrix the next placement prices
        against: the plan's predicted BW x conns under the arbitrated
        envelope cap (``wanify``), or the frozen one-shot static
        single-connection estimate (``static``)."""
        if self.backend == "static":
            return self._static_bw.copy()
        ctl = self.controller
        env = ctl.envelope
        cap = env.link_cap if env is not None else None
        P = ctl.n_pods
        capture = getattr(ctl, "last_capture_conns", None)
        if capture is not None:
            capture = np.asarray(capture, np.float64)[:P, :P]
        knee = getattr(ctl.sim, "knee", None)
        if knee is None:                 # a fleet TenantView: the mesh's
            knee = getattr(getattr(ctl.sim, "shared", None), "knee",
                           KNEE_CONNS)
        # the overlay (routed pricing) is not yet ported: the direct
        # surface, as the reference prices with the overlay off
        return achievable_bw(ctl.plan, link_cap=cap,
                             capture_conns=capture, knee=knee)

    def exec_conns(self) -> np.ndarray:
        """The [P,P] connection matrix the workload's shuffles would
        actually run at (plan conns for ``wanify``, single connection
        for the ``static`` ablation)."""
        P = self.controller.n_pods
        if self.backend == "static":
            return np.ones((P, P))
        return np.asarray(self.controller.plan.conns, np.float64)

    # ------------------------------------------------------------------
    # (re-)placement
    # ------------------------------------------------------------------
    def _on_replan(self, rec) -> None:
        """Controller trace hook: re-place under the fresh plan — or,
        in deferred mode (a fleet tick), just record the trigger so the
        fleet can fuse every job's search into shared launches."""
        if self._detached:
            return
        if self._deferred:
            self._pending = (rec.get("reason", "replan"),
                             rec.get("step"))
            return
        self._replace(reason=rec.get("reason", "replan"),
                      step=rec.get("step"))

    def _replace(self, reason: str, step: Optional[int]) -> None:
        decision = greedy_place(self.query, self.priced_bw(),
                                egress_usd_per_gb=self.egress_usd_per_gb,
                                **self._opt)
        self._apply(decision, reason, step)

    def _apply(self, decision: PlacementDecision, reason: str,
               step: Optional[int]) -> None:
        """Install a search result and append its trace record."""
        self.placement = decision.frac()
        self.records.append(PlacementRecord(
            step=step, reason=reason, backend=self.backend,
            makespan_est_s=decision.cost.makespan_s,
            egress_est_usd=decision.cost.egress_usd,
            placement=decision.placement))

    # ------------------------------------------------------------------
    # deferred (fleet-fused) re-placement
    # ------------------------------------------------------------------
    def defer_replans(self) -> None:
        """Switch to deferred mode: replan triggers set a pending
        marker instead of searching, and the owner (the fleet tick)
        collects :meth:`pending_task` from every planner, drives them
        through one `optimizer.search_many` lock-step pass, and
        commits each result. Pricing is unchanged —
        `priced_bw()` reads the job's own plan/envelope, which other
        jobs' replans never touch — so a deferred search returns the
        same decision an immediate one would."""
        self._deferred = True

    def pending_task(self) -> Optional[SearchTask]:
        """The deferred search to run, as a `SearchTask` priced at the
        current plan — or None when no replan fired since the last
        commit (or the planner is detached)."""
        if self._pending is None or self._detached:
            return None
        return SearchTask(query=self.query, bw=self.priced_bw(),
                          egress_usd_per_gb=self.egress_usd_per_gb,
                          **self._opt)

    def commit(self, decision: PlacementDecision) -> None:
        """Install the result of the pending deferred search."""
        if self._pending is None:
            raise ValueError(
                "no deferred re-placement is pending (commit pairs "
                "with a pending_task() taken after a replan trigger)")
        reason, step = self._pending
        self._pending = None
        self._apply(decision, reason, step)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def estimated(self) -> PlacementCost:
        """The current placement priced at the planner's own estimate."""
        return estimate_cost(self.query, self.placement, self.priced_bw(),
                             egress_usd_per_gb=self.egress_usd_per_gb)

    def evaluate(self, true_bw: np.ndarray) -> PlacementCost:
        """Execute the current placement under ground-truth achieved BW
        [P,P] (e.g. the simulator's water-fill at `exec_conns()`)."""
        return estimate_cost(self.query, self.placement, true_bw,
                             egress_usd_per_gb=self.egress_usd_per_gb)
