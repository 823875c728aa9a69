"""One fused fleet tick — the whole arbitrated closed loop as tensor
programs on the fleet's device, run for T ticks (and B scenario
variants) without the host stepping in.

The sequential :meth:`FleetController.tick` is host numpy around one
forest launch: per-job captures (16 water-fills at 16 jobs), Algorithm-1
relations, Eq. 2-3 ranges, the arbitration and AIMD run as Python
between the launches. This module writes the ENTIRE tick over stacked
job tensors:

  stacked snapshot capture (one batched water-fill credits every
  tenant) -> Table-3 feature rows -> stacked RF predict
  (`ops.rf_predict`) -> Algorithm-1 relations -> Eq. 2-3 ranges +
  §3.2.2 throttle -> link shares under the run's budgets -> AIMD clamp
  -> register -> ONE fleet water-fill with per-tenant crediting

Every stage is a plain function over leading batch dimensions
(``[..., J, P, P]``), so one code path runs one variant (`FusedFleet.
run`) and B variants at once (`FusedFleet.sweep`). Per tick, on the
fleet predictor's device: one `ops.fill_rates` launch of 2B fills (the
capacity probe and the capture of each variant), one `ops.rf_predict`
launch over all B·J·P·(P−1) rows, one `ops.fill_rates` launch of B
fills (the fleet fill). The T-tick loop reads nothing back: the per-tick
convergence flags stay on the device and are checked once after it.

Determinism contract: the fused program reproduces the sequential tick
on a DETERMINISTIC simulator — ``fluct_sigma`` may be nonzero (the
AR(1) draws are consumed while precomputing the schedule, exactly as
``sim.advance`` would), but ``snapshot_sigma`` and ``host_sigma`` must
be 0 so captures draw no observation/host noise. Under that contract
the fused records equal the sequential tick's: integer budgets and
connection totals exactly, achieved BW to roundoff.

Port of `repro/fleet/fused.py`: the reference's ``*_jnp`` stages are
the ``*_torch`` functions here, its ``jax.vmap`` a batch dimension and
its ``lax.scan`` a Python loop over T. The reference predicts with a
`jnp.mean` over trees; the port's `rf_predict` is bit-equal to the
reference's forest kernel and to the port's sequential tick.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.global_opt import _pair_weights
from repro_torch.core.local_opt import SIGNIFICANT_MBPS
from repro_torch.kernels import ops
from repro_torch.scenarios.events import (CrossTraffic, DiurnalCycle,
                                          LinkDegrade, LinkRestore, Timed)
from repro_torch.wan.topology import INTRA_DC_BW

D_DEFAULT = 100.0          # Algorithm-1 minimum significant BW difference

# WAN-state events a fused schedule can replay (job churn / priority
# shifts change the stacked tensor shapes and are rejected)
SCHEDULE_EVENTS = (LinkDegrade, LinkRestore, CrossTraffic, DiurnalCycle)

F64 = torch.float64


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


# ----------------------------------------------------------------------
# the per-tick stages as tensor programs (float64), over leading batch
# dimensions
# ----------------------------------------------------------------------
def relations_torch(bw: torch.Tensor, D: float) -> torch.Tensor:
    """Algorithm 1 (INFER_DC_RELATIONS) as fixed-shape tensor ops:
    bw [..., n, n] -> closeness [..., n, n] int32.

    The reverse-traversal unique filter keeps value v[k] iff it is the
    smallest unique value or sits >= D above its ORIGINAL sorted-unique
    neighbour (deleting an entry never changes later comparisons), so
    the data-dependent Python loop collapses to one mask; closeness
    lookup is a left-side searchsorted into the kept values padded with
    +inf. Matches `repro_torch.core.relations.infer_dc_relations`
    exactly."""
    n = bw.shape[-1]
    batch = bw.shape[:-2]
    val = bw.reshape(*batch, n * n)
    v = torch.sort(val, dim=-1).values
    k_tot = n * n
    first = torch.arange(k_tot, device=bw.device) == 0
    prev = torch.cat([v[..., :1], v[..., :-1]], dim=-1)
    uniq = first | (v != prev)
    keep = uniq & (first | (v - prev >= D))
    kv = torch.sort(torch.where(keep, v, math.inf), dim=-1).values
    n_u = keep.sum(-1, keepdim=True)                      # [..., 1]
    k = torch.searchsorted(kv, val.contiguous())          # left side
    found = (k < n_u) & (kv.gather(-1, k.clamp(0, k_tot - 1)) == val)
    lo = (k - 1).clamp(min=0)
    hi = torch.minimum(k, n_u - 1)
    kv_lo, kv_hi = kv.gather(-1, lo), kv.gather(-1, hi)
    pick = torch.where((val - kv_lo).abs() <= (kv_hi - val).abs(), lo, hi)
    rel = torch.where(found, n_u - k, n_u - pick).reshape(bw.shape)
    return torch.where(_eye(n, bw.device), 1, rel).to(torch.int32)


def global_ranges_torch(bw: torch.Tensor, M: torch.Tensor,
                        ws_pair: torch.Tensor, link_cap: torch.Tensor,
                        D: float = D_DEFAULT) -> Dict[str, torch.Tensor]:
    """Eq. 2-3 connection ranges + §3.2.2 throttle (the
    `global_optimize` fleet path: no provider refactor, skew pair
    weights precomputed, the arbitrated `link_cap` joins the throttle):
    bw / ws_pair / link_cap [..., n, n], M [...] (one budget a matrix)."""
    n = bw.shape[-1]
    eye = _eye(n, bw.device)
    off = ~eye
    rel = relations_torch(bw, D).to(bw.dtype)
    M = M.to(bw.dtype)[..., None, None]

    sum_all = rel.sum((-2, -1), keepdim=True) - n  # skip closeness-1 diag
    max_r = rel.amax(-1, keepdim=True)
    min_cons = torch.clamp(torch.floor(rel / sum_all * (M - 1)),
                           min=1.0) * ws_pair
    max_cons = torch.ceil(M * rel / max_r) * ws_pair
    min_cons = torch.where(eye, 1.0, min_cons)
    max_cons = torch.where(eye, 1.0, max_cons)
    min_cons = torch.minimum(torch.clamp(torch.round(min_cons), min=1.0),
                             2 * M)
    max_cons = torch.minimum(torch.clamp(torch.round(max_cons), min=1.0),
                             2 * M)
    max_cons = torch.maximum(max_cons, min_cons)

    capped = torch.isfinite(link_cap) & off
    cap_cons = torch.ceil(link_cap / torch.clamp(bw, min=1e-9))
    cap_cons = torch.clamp(torch.where(capped, cap_cons, max_cons), min=1.0)
    cap_cons = torch.minimum(cap_cons, 2 * M)
    max_cons = torch.clamp(torch.minimum(max_cons, cap_cons), min=1.0)
    min_cons = torch.minimum(min_cons, max_cons)

    min_bw = bw * min_cons
    max_bw = bw * max_cons
    T = torch.where(off, max_bw, 0.0).sum(-1, keepdim=True) / (n - 1)
    throttle = torch.where(off & (max_bw > T), T, math.inf)
    throttle = torch.where(off, torch.minimum(throttle, link_cap), throttle)
    return {"min_cons": min_cons.to(torch.int32),
            "max_cons": max_cons.to(torch.int32),
            "min_bw": min_bw, "max_bw": max_bw,
            "unit_bw": bw, "throttle": throttle}


def split_budget_torch(m_total: int, w: torch.Tensor,
                       present: torch.Tensor) -> torch.Tensor:
    """Masked port of `core.global_opt.split_budget`: largest-remainder
    shares of `m_total` over the PRESENT jobs (floor 1, repayment of
    floor bumps); absent jobs return `m_total` so a min-reduction over
    DCs ignores them. w [J], present [..., J] bool -> [..., J] f64.

    The repayment loop's length depends on the data, so each pass asks
    the host whether any row still owes: a fused run calls this once,
    before its tick loop (the budgets depend only on presence, weights
    and `m_total`)."""
    w = w.to(F64)
    n_present = present.sum(-1, keepdim=True)
    wp = torch.where(present, torch.clamp(w, min=1e-9), 0.0)
    quota = torch.where(
        present,
        m_total * wp / torch.clamp(wp.sum(-1, keepdim=True), min=1e-300),
        0.0)
    share = torch.floor(quota)
    # absent jobs rank last (frac -1) so floor bumps stay with the
    # present; stable argsort ties break toward the earlier tenant
    frac = torch.where(present, quota - share, -1.0)
    order = torch.argsort(-frac, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1)
    leftover = m_total - share.sum(-1, keepdim=True)
    share = share + (rank < leftover).to(F64)
    share = torch.where(present, torch.clamp(share, min=1.0), 0.0)
    while True:
        held = torch.where(present, share, 0.0)
        owes = (held.sum(-1, keepdim=True) > m_total) & \
            (held.amax(-1, keepdim=True) > 1)
        if not bool(owes.any()):
            break
        rich = torch.argmax(torch.where(present, share, -1.0), dim=-1,
                            keepdim=True)
        dec = torch.zeros_like(share).scatter(-1, rich, 1.0)
        share = share - torch.where(owes, dec, 0.0)
    share = torch.where(m_total <= n_present, 1.0, share)
    return torch.where(present, share, float(m_total))


def connection_budgets_torch(presence: torch.Tensor, weights: torch.Tensor,
                             m_total: int) -> torch.Tensor:
    """Per-job scalar budgets [J]: min over the job's DCs of its
    largest-remainder share at that DC (`fleet.arbiter` port);
    presence [J, N] bool, weights [J]."""
    shares = split_budget_torch(m_total, weights, presence.T)   # [N, J]
    budgets = torch.clamp(shares.amin(0), max=float(m_total))
    return torch.clamp(budgets, min=1.0)


def link_shares_torch(presence: torch.Tensor, weights: torch.Tensor,
                      cap_est: torch.Tensor) -> torch.Tensor:
    """Per-job per-link caps [..., J, N, N] (`fleet.arbiter.link_shares`
    port): pairs contended by >1 job split `cap_est` [..., N, N] by
    priority weight; sole-tenant and unused pairs stay uncapped."""
    pres = presence.to(cap_est.dtype)                          # [J, N]
    w = weights.to(cap_est.dtype)
    wpres = w[:, None] * pres
    weight_sum = torch.einsum("ja,jb->ab", wpres, pres)
    count = torch.einsum("ja,jb->ab", pres, pres)
    on_pair = pres[:, :, None] * pres[:, None, :] > 0          # [J, N, N]
    mask = (count > 1)[None] & on_pair
    split = cap_est[..., None, :, :] * w[:, None, None] \
        / torch.clamp(weight_sum, min=1e-12)
    return torch.where(mask, split, math.inf)


def aimd_step_torch(cons: torch.Tensor, target: torch.Tensor,
                    ranges: Dict[str, torch.Tensor],
                    monitored: torch.Tensor,
                    delta: float = SIGNIFICANT_MBPS
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`AimdAgent.step` for every source row at once ([..., P, P]
    elementwise; the diagonal — each agent's own DC — is untouched).
    `cons` is int32 and halves by floor division."""
    eye = _eye(cons.shape[-1], cons.device)
    cap = torch.minimum(ranges["max_bw"], ranges["throttle"])
    dec = monitored < target - delta
    inc = (monitored - target).abs() <= delta
    new_cons = torch.where(
        dec, torch.maximum(ranges["min_cons"],
                           torch.div(cons, 2, rounding_mode="floor")),
        torch.where(inc, torch.minimum(ranges["max_cons"], cons + 1), cons))
    new_t = torch.where(
        dec, torch.maximum(ranges["min_bw"], target / 2),
        torch.where(inc, torch.minimum(cap, target + ranges["unit_bw"]),
                    target))
    new_t = torch.minimum(torch.maximum(new_t, ranges["min_bw"]), cap)
    return (torch.where(eye, cons, new_cons),
            torch.where(eye, target, new_t))


# ----------------------------------------------------------------------
# WAN schedule precomputation (the numpy side of the contract)
# ----------------------------------------------------------------------
class _ScheduleShim:
    """The tiny engine surface WAN events mutate while a schedule is
    precomputed (`event.apply(eng)` wants `.sim`, `.link`, `.diurnal`,
    `.step`)."""

    def __init__(self, sim):
        self.sim = sim
        self.diurnal: Optional[Tuple[float, int, int]] = None
        self.step = 0

    def link(self, pair: Sequence[str]) -> Tuple[int, int]:
        """Resolve a (region, region) pair to simulator indices."""
        a, b = pair
        return self.sim.regions.index(a), self.sim.regions.index(b)


def make_schedule(sim, steps: int, events: Tuple[Timed, ...] = ()
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Precompute the WAN inputs of `steps` fused ticks:
    ``(single[T,N,N], background[T,N,N])``.

    MUTATES `sim` exactly as `steps` sequential fleet ticks would
    (events applied at their step, diurnal modulation, one
    ``advance()`` per tick), so a `FusedFleet.run` leaves the shared
    simulator where the sequential engine would have left it and
    sequential ticks can continue afterwards. Only WAN-state events
    (`SCHEDULE_EVENTS`) are accepted — job churn changes tensor shapes.
    """
    shim = _ScheduleShim(sim)
    timeline: Dict[int, List[Timed]] = {}
    for t in events:
        if not isinstance(t.event, SCHEDULE_EVENTS):
            raise ValueError(
                f"{type(t.event).__name__} is not replayable in a fused "
                f"schedule; accepted: "
                f"{[e.__name__ for e in SCHEDULE_EVENTS]}")
        if getattr(t.event, "notify", False):
            raise ValueError("notify=True is a single-job-engine concept")
        timeline.setdefault(t.step, []).append(t)
    n = sim.N
    single = np.empty((steps, n, n))
    bg = np.zeros((steps, n, n))
    for k in range(steps):
        shim.step = k
        for t in timeline.get(k, ()):
            t.event.apply(shim)
        if shim.diurnal is not None:
            amp, period, start = shim.diurnal
            phase = 2.0 * math.pi * (k - start) / max(period, 1)
            sim.modulation = 1.0 + amp * math.sin(phase)
        sim.advance()
        single[k] = sim.link_bw_now()
        if sim.background_conns is not None:
            b = np.asarray(sim.background_conns, np.float64).copy()
            np.fill_diagonal(b, 0.0)
            bg[k] = np.maximum(b, 0.0)
    return single, bg


# ----------------------------------------------------------------------
# The fused engine
# ----------------------------------------------------------------------
@dataclass
class FusedState:
    """The persistent cross-tick state: each job's in-force connection
    matrix and AIMD target BW at slice scale."""
    cons: np.ndarray          # [J,P,P] int32
    target: np.ndarray        # [J,P,P] float64


# per-tick outputs of a run / sweep, [T, B, ...] on the device
STAT_KEYS = ("achieved_min", "achieved_mean", "conns_total", "cap_min",
             "fill_iters", "converged")


class FusedFleet:
    """A :class:`FleetController`'s job set as one tick program on the
    fleet predictor's device (see module docstring for the determinism
    contract)."""

    def __init__(self, fleet):
        """Snapshot the fleet's static spec and live AIMD state.
        Requires a deterministic capture path (``snapshot_sigma == 0``,
        ``host_sigma == 0``), a fixed job set with equal slice sizes,
        and no attached deferred planners (their `search_many` flush is
        host-side Python)."""
        sim = fleet.sim
        if sim.snapshot_sigma != 0 or sim.host_sigma != 0:
            raise ValueError(
                "fused ticks need a deterministic capture path: build "
                "the simulator with snapshot_sigma=0 and host_sigma=0")
        if fleet._planners:
            raise ValueError("fused ticks do not flush deferred "
                             "placement planners; detach them first")
        jobs = list(fleet.jobs.values())
        if not jobs:
            raise ValueError("fused fleet needs at least one job")
        sizes = {len(j.spec.dcs) for j in jobs}
        if len(sizes) != 1:
            raise ValueError(f"fused fleet needs equal slice sizes, "
                             f"got {sorted(sizes)}")
        self.fleet = fleet
        self.sim = sim
        self.jobs = jobs
        self.J = len(jobs)
        self.N = sim.N
        self.P = sizes.pop()
        self.m_total = int(fleet.m_total)
        self.ix = np.stack([np.asarray(j.spec.dcs, np.int64)
                            for j in jobs])                # [J,P]
        self.presence = np.zeros((self.J, self.N), bool)
        for j, row in enumerate(self.ix):
            self.presence[j, row] = True
        self.priorities = np.array([max(j.priority, 1e-9) for j in jobs])
        # §3.3.1 pair weights, precomputed numpy-side for exact parity
        self.ws_pair = np.stack([
            _pair_weights(self.P, j.skew()) for j in jobs])  # [J,P,P]
        self.dists = np.stack([sim.dist[np.ix_(r, r)] for r in self.ix])
        # the predictor's device, forest and 8-byte kernel nodes
        pred = fleet.predictor
        self.device = pred.device
        self._forest = pred._packed
        self._nodes = pred._nodes
        self._depth = pred.forest.depth
        self._const = self._constants()

    # ------------------------------------------------------------------
    def _constants(self) -> Dict[str, Any]:
        """The run-invariant tensors on the device, built once: masks,
        the gather / scatter indices of the job slices, the fill's NIC
        caps and RTT weights, and the budgets. The budgets depend only
        on presence, priorities and `m_total`, so they are computed
        here once rather than every tick: the values are the ones every
        tick would compute, and `split_budget_torch`'s data-dependent
        loop stays out of the tick loop."""
        dev, J, P, N = self.device, self.J, self.P, self.N
        t = lambda a, dt=F64: torch.as_tensor(  # noqa: E731
            np.array(a), dtype=dt).to(dev)
        idx_i, idx_j = np.nonzero(~np.eye(P, dtype=bool))
        # flat [J*P*P] offsets of each job's slice in [N*N] and [J*N*N]
        cell = self.ix[:, :, None] * N + self.ix[:, None, :]   # [J,P,P]
        slice_nn = cell.reshape(-1)
        slice_jnn = (np.arange(J)[:, None, None] * N * N + cell).reshape(-1)
        vms = self.sim.vms_per_dc if self.sim.vms_per_dc is not None \
            else np.ones(N)
        egress = self.sim.nic_cap * np.asarray(vms, float)
        presence = t(self.presence, torch.bool)
        weights = t(self.priorities)
        n_pairs = len(idx_i)
        return {
            "off_p": ~_eye(P, dev), "eye_n": _eye(N, dev),
            "ones_off": t(1.0 - np.eye(N)),
            "pair": t(idx_i * P + idx_j, torch.int64),          # [n_pairs]
            "src": t(idx_i, torch.int64), "dst": t(idx_j, torch.int64),
            "slice_nn": t(slice_nn, torch.int64),
            "slice_jnn": t(slice_jnn, torch.int64),
            "presence": presence, "weights": weights,
            "ws_pair": t(self.ws_pair),
            # the Table-3 columns that do not change: n_dcs, distance
            "n_dcs": t(np.full((J, n_pairs), float(P))),
            "dist_pairs": t(self.dists[:, idx_i, idx_j]),
            "egress": t(egress), "w_rtt": t(self.sim.rtt_weight()),
            "budgets": connection_budgets_torch(presence, weights,
                                                self.m_total),
        }

    def state(self) -> FusedState:
        """Read the live controllers' AIMD state into stacked tensors."""
        cons = np.zeros((self.J, self.P, self.P), np.int32)
        target = np.zeros((self.J, self.P, self.P))
        for j, job in enumerate(self.jobs):
            cons[j] = job.controller.current_conns().astype(np.int32)
            for i, ag in enumerate(job.controller._agents):
                target[j, i] = ag.target_bw
        return FusedState(cons=cons, target=target)

    # ------------------------------------------------------------------
    def _embed(self, mats: torch.Tensor) -> torch.Tensor:
        """[B,J,P,P] -> [B,J,N,N] (zero elsewhere, diagonal zeroed)."""
        c = self._const
        B = mats.shape[0]
        m = torch.where(c["off_p"], mats, 0.0).reshape(B, -1)
        out = torch.zeros((B, self.J * self.N * self.N), dtype=mats.dtype,
                          device=mats.device)
        out.scatter_(1, c["slice_jnn"].expand(B, -1), m)
        return out.view(B, self.J, self.N, self.N)

    def _extract(self, full: torch.Tensor) -> torch.Tensor:
        """[B,N,N] or [B,J,N,N] -> [B,J,P,P] per-job slices."""
        c = self._const
        B = full.shape[0]
        idx = c["slice_nn"] if full.dim() == 3 else c["slice_jnn"]
        out = full.reshape(B, -1).gather(1, idx.expand(B, -1))
        return out.view(B, self.J, self.P, self.P)

    def _off_pairs(self, mats: torch.Tensor) -> torch.Tensor:
        """[B,J,P,P] -> [B,J,P·(P−1)] in row-major pair order."""
        B = mats.shape[0]
        flat = mats.reshape(B, self.J, self.P * self.P)
        return flat.gather(2, self._const["pair"].expand(B, self.J, -1))

    def _fill(self, aggregates: torch.Tensor, single: torch.Tensor):
        """One `ops.fill_rates` call: aggregates [K,N,N] at the link
        states single [K,N,N] -> (rate, iters, converged)."""
        c = self._const
        K = aggregates.shape[0]
        egress = c["egress"].expand(K, -1).contiguous()
        return ops.fill_rates(aggregates.contiguous(), single.contiguous(),
                              egress, egress, c["w_rtt"],
                              (single * self.sim.knee).contiguous())

    def _tick(self, cons: torch.Tensor, target: torch.Tensor,
              single: torch.Tensor, bg: torch.Tensor):
        """One arbitrated tick of B variants: cons [B,J,P,P] int32,
        target [B,J,P,P], single / bg [B,N,N]. Returns the new state,
        this tick's stats and its ranges and caps. Nothing in it reads
        a value back to the host."""
        c = self._const
        B, J, P, N = single.shape[0], self.J, self.P, self.N
        off_p, eye_n = c["off_p"], c["eye_n"]
        reg = self._embed(cons.to(F64))                       # [B,J,N,N]
        total = reg.sum(1) + bg                               # [B,N,N]

        # probe (capacity estimate) + capture fills share a launch:
        # fill 2b is variant b's probe, 2b+1 its capture
        ones_off = c["ones_off"]
        aggs = torch.stack([ones_off + total, total], 1).view(2 * B, N, N)
        rate2, it2, ok2 = self._fill(
            aggs, single[:, None].expand(B, 2, N, N).reshape(2 * B, N, N))
        rate2 = rate2.view(B, 2, N, N)
        probe_bw = torch.where(eye_n, INTRA_DC_BW, rate2[:, 0] * ones_off)
        cap_est = probe_bw * self.sim.knee

        # arbitration: the run's budgets + per-link caps at slice scale
        budgets = c["budgets"]
        env_cap = self._extract(
            link_shares_torch(c["presence"], c["weights"], cap_est))

        # capture: per-tenant credited snapshot at in-force conns
        snap = self._extract(
            torch.where(eye_n, INTRA_DC_BW, rate2[:, 1, None] * reg))

        # deterministic Table-3 host metrics (host_sigma == 0)
        c_off = torch.where(off_p, cons.to(F64), 0.0)
        mem = torch.clamp(0.15 + 0.02 * c_off.sum(-2), 0.05, 0.98)
        cpu = torch.clamp(0.10 + 0.015 * c_off.sum(-1), 0.02, 0.98)
        solo = self._extract(single)
        squeeze = torch.clamp(
            1.0 - snap / torch.clamp(solo * c_off, min=1e-9), min=0.0)
        retr = torch.where(off_p, torch.round(squeeze * 40.0), 0.0)

        # stacked RF predict: one forest launch for every job and variant
        n_pairs = P * (P - 1)
        pair = c["pair"]
        X = torch.stack([
            c["n_dcs"].expand(B, J, n_pairs), self._off_pairs(snap),
            mem[:, :, c["dst"]], cpu[:, :, c["src"]], self._off_pairs(retr),
            c["dist_pairs"].expand(B, J, n_pairs),
        ], dim=-1).reshape(B * J * n_pairs, 6).to(torch.float32)
        vals = ops.rf_predict(*self._forest, X, depth=self._depth,
                              nodes=self._nodes)
        vals = torch.clamp(vals.to(F64), min=1.0).view(B, J, n_pairs)
        pred = torch.full((B, J, P * P), INTRA_DC_BW, dtype=F64,
                          device=single.device)
        pred = pred.scatter(2, pair.expand(B, J, -1), vals).view(B, J, P, P)

        # Eq. 2-3 ranges inside each job's envelope, then AIMD
        ranges = global_ranges_torch(pred, budgets.expand(B, J),
                                     c["ws_pair"], env_cap)
        new_cons, new_target = aimd_step_torch(cons, target, ranges, snap)

        # register + ONE fleet fill, credited and envelope-clamped
        reg_new = self._embed(new_cons.to(F64))
        rate1, it1, ok1 = self._fill(reg_new.sum(1) + bg, single)
        ach = self._extract(
            torch.where(eye_n, INTRA_DC_BW, rate1[:, None] * reg_new))
        ach = torch.where(off_p, torch.minimum(ach, env_cap), ach)

        ach_off = self._off_pairs(ach)
        stats = {
            "achieved_min": ach_off.amin(-1),
            "achieved_mean": ach_off.mean(-1),
            "conns_total": self._off_pairs(new_cons).sum(-1),
            "cap_min": self._off_pairs(env_cap).amin(-1),
            "fill_iters": torch.cat([it2.view(B, 2), it1.view(B, 1)], 1),
            "converged": ok2.view(B, 2).all(1) & ok1,
        }
        return new_cons, new_target, stats, ranges, env_cap

    def _scan(self, cons: torch.Tensor, target: torch.Tensor,
              singles: torch.Tensor, bgs: torch.Tensor):
        """T ticks of B variants on the device: cons / target
        [B,J,P,P], singles / bgs [T,B,N,N]. Returns the final state,
        the stats stacked [T,B,...] and the last tick's ranges and caps
        (the state a run writes back), all still on the device."""
        per_tick: Dict[str, List[torch.Tensor]] = {k: [] for k in STAT_KEYS}
        ranges = env_cap = None
        for t in range(singles.shape[0]):
            cons, target, stats, ranges, env_cap = self._tick(
                cons, target, singles[t], bgs[t])
            for k in STAT_KEYS:
                per_tick[k].append(stats[k])
        outs = {k: torch.stack(v) for k, v in per_tick.items()}
        return cons, target, outs, ranges, env_cap

    def _upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        return [torch.from_numpy(np.array(a)).to(self.device)
                for a in arrays]

    # ------------------------------------------------------------------
    def run(self, steps: int, events: Tuple[Timed, ...] = ()
            ) -> List[Dict[str, Any]]:
        """Run `steps` arbitration epochs on the device, sync the
        resulting AIMD state back into the live controllers (so
        sequential ticks can continue), and return per-tick records
        (the fleet-trace row body minus plan signatures, which are a
        host-side concept)."""
        single, bg = make_schedule(self.sim, steps, events)
        st = self.state()
        cons, target, singles, bgs = self._upload(
            st.cons[None], st.target[None], single[:, None], bg[:, None])
        cons, target, outs, ranges, env_cap = self._scan(
            cons, target, singles, bgs)
        outs = {k: v[:, 0].cpu().numpy() for k, v in outs.items()}
        conv = outs["converged"]
        if not conv.all():
            from repro_torch.wan.simulator import WaterfillDivergence
            bad = int(np.argmax(~conv))
            raise WaterfillDivergence(
                f"a fused-tick water-fill hit its iteration bound at "
                f"tick {bad + 1} of {len(conv)}")
        last = {k: v[0].cpu().numpy() for k, v in ranges.items()}
        last["env_cap"] = env_cap[0].cpu().numpy()
        self._sync_back(cons[0].cpu().numpy(), target[0].cpu().numpy(),
                        last, steps)
        return self._records(steps, outs)

    def sweep(self, singles: np.ndarray, bgs: np.ndarray
              ) -> Dict[str, np.ndarray]:
        """Sweep B scenario variants x T steps from the CURRENT fleet
        state, the B variants batched into each tick's launches (state
        is not written back — a sweep is analysis, not execution).
        `singles`/`bgs`: [B,T,N,N] schedules from :func:`make_schedule`
        over variant simulators. Returns stacked per-tick stats
        [B,T,...], with `budget` [B,T,J] as in the reference."""
        st = self.state()
        B = singles.shape[0]
        cons, target, s, g = self._upload(
            np.broadcast_to(st.cons, (B,) + st.cons.shape),
            np.broadcast_to(st.target, (B,) + st.target.shape),
            np.swapaxes(singles, 0, 1), np.swapaxes(bgs, 0, 1))
        _, _, outs, _, _ = self._scan(cons, target, s, g)
        res = {k: np.swapaxes(v.cpu().numpy(), 0, 1) for k, v in outs.items()}
        budget = self._const["budgets"].cpu().numpy()
        res["budget"] = np.broadcast_to(budget, res["conns_total"].shape
                                        ).copy()
        return res

    # ------------------------------------------------------------------
    def _sync_back(self, cons: np.ndarray, target: np.ndarray,
                   last: Dict[str, np.ndarray], steps: int) -> None:
        """Install the post-run state into the live fleet: agent conns
        and targets, the final tick's Eq. 2-3 bounds, registered flows,
        and each job's last arbitrated envelope."""
        from repro_torch.control import BudgetEnvelope
        budget = self._const["budgets"].cpu().numpy()
        for j, job in enumerate(self.jobs):
            ctl = job.controller
            for i, ag in enumerate(ctl._agents):
                ag.cons = cons[j, i].astype(np.int64)
                ag.target_bw = target[j, i].astype(np.float64)
                ag.min_cons = last["min_cons"][j, i].astype(np.int64)
                ag.max_cons = last["max_cons"][j, i].astype(np.int64)
                ag.min_bw = last["min_bw"][j, i]
                ag.max_bw = last["max_bw"][j, i]
                ag.unit_bw = last["unit_bw"][j, i]
                ag.throttle = last["throttle"][j, i]
            ctl.set_envelope(BudgetEnvelope(
                max_conns=int(budget[j]),
                link_cap=np.asarray(last["env_cap"][j], np.float64)))
            job.view.register(ctl.current_conns())
        self.fleet.tick_count += steps

    def _records(self, steps: int, outs: Dict[str, np.ndarray]
                 ) -> List[Dict[str, Any]]:
        """Per-tick record dicts compatible with the sequential tick's
        row body (minus `plan_sig`/`kernel_calls`)."""
        base = self.fleet.tick_count - steps
        budget = self._const["budgets"].cpu().numpy()
        recs = []
        for t in range(steps):
            rows = [{
                "name": job.name,
                "priority": float(self.priorities[j]),
                "budget": int(budget[j]),
                "cap_min": float(outs["cap_min"][t, j]),
                "achieved_min": float(outs["achieved_min"][t, j]),
                "achieved_mean": float(outs["achieved_mean"][t, j]),
                "conns_total": int(outs["conns_total"][t, j]),
            } for j, job in enumerate(self.jobs)]
            recs.append({"tick": base + t + 1, "n_jobs": self.J,
                         "fill_iters": outs["fill_iters"][t].tolist(),
                         "jobs": rows})
        return recs
