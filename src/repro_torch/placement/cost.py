"""Placement cost model — latency + egress cost of one candidate
placement, priced against per-pair achievable WAN bandwidth.

Latency follows the paper's bottleneck formula (Fig. 2d): a shuffle
moving `V[i,j]` Gb finishes in `max_ij V_ij / BW_ij`; stage compute is
the slowest DC's assigned volume over its compute speed; a stage with
`waves > 1` repeats both. Cost is AWS-style: instance time (every DC
runs for the makespan) plus per-GB egress priced at each *source*
region's rate (`repro_torch.wan.monitor.egress_price_vector`).

Achievable BW comes from the control plane: `achievable_bw(plan)` is
the plan's predicted single-connection BW x its heterogeneous
connection counts (the Eq. 2-3 linearity the paper validates
empirically), optionally clamped by an arbitrated fleet envelope's
`link_cap`. Tests validate this pricing against the `WanSimulator`
water-fill ground truth (`tests/test_placement.py`).

Port of `repro/placement/cost.py`. The numpy paths are the
reference's, bit for bit. The batched evaluator's device backend is
``torch`` (`_eval_packed_torch`, vectorised PyTorch in f64, on the card
unless the caller passes ``device="cpu"``), in place of the reference's
jit ``jax`` backend (`repro/kernels/placement_cost.py::_eval_core`).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.plan import WanPlan
from repro_torch.device import resolve_device
from repro_torch.placement.query import QuerySpec
from repro_torch.wan.monitor import NET_COST_PER_GB
from repro_torch.wan.topology import INTRA_DC_BW, KNEE_CONNS

# t2.medium + vCPU burst, the paper's worker class (same basis as the
# benchmark query model)
INSTANCE_USD_PER_HOUR = 0.0464 + 2 * 0.05


def achievable_bw(plan: WanPlan,
                  link_cap: Optional[np.ndarray] = None,
                  capture_conns: Optional[np.ndarray] = None,
                  knee: Optional[float] = KNEE_CONNS,
                  intra_dc_bw: float = INTRA_DC_BW,
                  routing: Optional[Any] = None) -> np.ndarray:
    """Per-pair achievable BW [P,P] in Mbps a placement prices against:
    predicted BW x connection count — the paper's "runtime BW grows
    linearly with the connections" — scaled from the operating point
    the prediction was measured at and saturated at the §2.2
    parallelism knee.

    `capture_conns` is the operating point
    (`WanifyController.last_capture_conns`, pod-sliced): when the
    snapshot was taken at the in-force matrix, the predicted BW is
    already the aggregate there and only the *ratio* to the plan's
    conns applies; the default (ones, a from-scratch capture) reduces
    to plain predicted-BW x conns. `knee` caps the effective
    connection count on both sides of the ratio (parallelism gains
    saturate ~8-9 streams; `None` = pure linearity). An arbitrated
    fleet envelope's `link_cap` clamps the result. Diagonal = intra-DC
    BW.

    `routing` (a `RoutedPlan` of the overlay, which the port gates off
    until it is ported; any object with `n_pods`, `direct` and
    `relays`) prices the ROUTED surface instead: the
    direct term uses the routing's residual direct connections, and
    each relay (i, k, j, conns) adds its store-and-forward credit —
    the knee-capped connection count times the weaker hop's per-
    connection predicted BW — onto the end-to-end pair (i, j). With
    `routing=None` (the default, overlay off) the arithmetic is
    unchanged."""
    pred = np.asarray(plan.pred_bw, np.float64)
    if routing is None:
        conns = np.asarray(plan.conns, np.float64)
    else:
        if routing.n_pods != plan.n_pods:
            raise ValueError(
                f"routing spans {routing.n_pods} pods != plan scale "
                f"{plan.n_pods}")
        conns = np.asarray(routing.direct, np.float64)
    if capture_conns is None:
        base = np.ones_like(conns)
    else:
        base = np.maximum(np.asarray(capture_conns, np.float64), 1.0)
        if base.shape != conns.shape:
            raise ValueError(
                f"capture_conns shape {base.shape} != plan scale "
                f"{conns.shape}")
    if knee is not None:
        conns = np.minimum(conns, knee)
        base = np.minimum(base, knee)
    bw = pred * conns / base
    if routing is not None:
        # per-connection prediction on each hop, at the hop's own
        # capture operating point; a relay connection sustains the
        # weaker hop's per-connection rate (store-and-forward)
        unit = pred / base
        for i, k, j, cr in routing.relays:
            eff = min(float(cr), knee) if knee is not None else float(cr)
            bw[i, j] += eff * min(float(unit[i, k]), float(unit[k, j]))
    if link_cap is not None:
        cap = np.asarray(link_cap, np.float64)
        if cap.shape != bw.shape:
            raise ValueError(
                f"link_cap shape {cap.shape} != plan scale {bw.shape}")
        off = ~np.eye(plan.n_pods, dtype=bool)
        bw[off] = np.minimum(bw, cap)[off]
    np.fill_diagonal(bw, intra_dc_bw)
    return bw


def shuffle_matrix(held_gb: np.ndarray, frac: np.ndarray) -> np.ndarray:
    """All-to-all shuffle volumes [N,N] (Gb): DC i ships
    `held_i * frac_j` to DC j; the diagonal (data that stays) is 0."""
    v = np.outer(np.asarray(held_gb, np.float64),
                 np.asarray(frac, np.float64))
    np.fill_diagonal(v, 0.0)
    return v


def bottleneck_time_s(volume_gb: np.ndarray, bw_mbps: np.ndarray) -> float:
    """Slowest-link shuffle time in seconds (paper Fig. 2d):
    `max_ij V_ij / BW_ij` over off-diagonal pairs."""
    off = ~np.eye(volume_gb.shape[0], dtype=bool)
    gb = volume_gb[off]
    bw = np.maximum(bw_mbps[off], 1e-6)
    t = gb * 1000.0 / bw                       # Gb -> Mb over Mbps
    return float(t.max()) if len(t) else 0.0


@dataclass(frozen=True)
class StageCost:
    """One placed stage's contribution (already multiplied by waves)."""

    name: str
    net_s: float
    compute_s: float
    egress_gb: float          # GB shipped off-DC (all waves)


@dataclass(frozen=True)
class PlacementCost:
    """Estimated execution of one placement: latency plus dollars."""

    makespan_s: float
    net_s: float
    compute_s: float
    egress_gb: float          # GB
    egress_usd: float
    instance_usd: float
    stages: Tuple[StageCost, ...]

    @property
    def total_usd(self) -> float:
        """Instance time + egress, the paper's §5 cost metric."""
        return self.instance_usd + self.egress_usd


def estimate_cost(query: QuerySpec, placement: np.ndarray,
                  bw_mbps: np.ndarray, *,
                  egress_usd_per_gb: Union[float, np.ndarray, None] = None,
                  instance_usd_per_hour: float = INSTANCE_USD_PER_HOUR
                  ) -> PlacementCost:
    """Price `placement` ([n_shuffles, N] task fractions, rows sum to 1)
    against per-pair `bw_mbps` [N,N].

    `egress_usd_per_gb` is a scalar or per-source-DC vector (default:
    the Table-2 average rate). Returns the full latency/cost breakdown;
    the optimizer minimizes `makespan_s` with `egress_usd` as the
    near-tie preference.
    """
    n = query.n
    bw = np.asarray(bw_mbps, np.float64)
    if bw.shape != (n, n):
        raise ValueError(f"bw shape {bw.shape} != ({n}, {n})")
    placement = np.atleast_2d(np.asarray(placement, np.float64))
    if placement.shape != (query.n_shuffles(), n):
        raise ValueError(
            f"placement shape {placement.shape} != "
            f"({query.n_shuffles()}, {n})")
    if (placement < -1e-9).any() or \
            not np.allclose(placement.sum(axis=1), 1.0, atol=1e-6):
        raise ValueError("each stage's fractions must be >= 0, sum to 1")
    price = np.full(n, NET_COST_PER_GB) if egress_usd_per_gb is None \
        else np.broadcast_to(
            np.asarray(egress_usd_per_gb, np.float64), (n,))
    speed = query.speeds()

    held = query.inputs()
    s0 = query.stages[0]
    compute_s = s0.waves * float(
        (held * s0.compute_s_per_gb / speed).max())
    net_s = 0.0
    egress_gb = 0.0
    egress_usd = 0.0
    rows = [StageCost(s0.name, 0.0, compute_s, 0.0)]
    held = held * s0.out_ratio
    for k, stage in enumerate(query.stages[1:]):
        frac = placement[k]
        vol = shuffle_matrix(held, frac)
        st_net = stage.waves * bottleneck_time_s(vol, bw)
        new_held = held.sum() * frac
        st_comp = stage.waves * float(
            (new_held * stage.compute_s_per_gb / speed).max())
        st_gb = stage.waves * float(vol.sum()) / 8.0        # Gb -> GB
        st_usd = stage.waves * float(
            (vol.sum(axis=1) / 8.0 * price).sum())
        rows.append(StageCost(stage.name, st_net, st_comp, st_gb))
        net_s += st_net
        compute_s += st_comp
        egress_gb += st_gb
        egress_usd += st_usd
        held = new_held * stage.out_ratio
    makespan = net_s + compute_s
    instance_usd = makespan / 3600.0 * n * instance_usd_per_hour
    return PlacementCost(makespan_s=makespan, net_s=net_s,
                         compute_s=compute_s, egress_gb=egress_gb,
                         egress_usd=egress_usd, instance_usd=instance_usd,
                         stages=tuple(rows))


# ----------------------------------------------------------------------
# Batched evaluation — price M candidate placements in one pass
# ----------------------------------------------------------------------
PLACEMENT_BACKENDS = ("numpy", "torch", "scalar")


def placement_backend(backend: Optional[str] = None) -> str:
    """Resolve the batched-evaluator backend: an explicit argument wins,
    then the ``REPRO_PLACEMENT_BACKEND`` environment variable, then
    ``numpy``. ``scalar`` routes every candidate through the readable
    per-placement :func:`estimate_cost` reference (tests/benchmarks);
    ``torch`` runs the packed evaluator as tensor ops on a device. The
    JAX package's ``jax`` backend is not one of the port's: it raises,
    naming ``torch``."""
    if backend is None:
        backend = os.environ.get("REPRO_PLACEMENT_BACKEND", "numpy")
    if backend == "jax":
        raise ValueError("backend 'jax' is the JAX package's; the port's "
                         "device backend is 'torch'")
    if backend not in PLACEMENT_BACKENDS:
        raise ValueError(f"backend {backend!r} not in {PLACEMENT_BACKENDS}")
    return backend


@dataclass(frozen=True)
class PlacementCostBatch:
    """Per-candidate cost vectors for a batch of M placements — the
    same numbers :class:`PlacementCost` carries, without the per-stage
    breakdown (built lazily, winner-only, via :func:`estimate_cost`)."""

    makespan_s: np.ndarray            # [M]
    net_s: np.ndarray                 # [M]
    compute_s: np.ndarray             # [M]
    egress_gb: np.ndarray             # [M]
    egress_usd: np.ndarray            # [M]
    instance_usd: np.ndarray          # [M]

    def __len__(self) -> int:
        return len(self.makespan_s)

    @property
    def total_usd(self) -> np.ndarray:
        """Instance time + egress per candidate (the §5 cost metric)."""
        return self.instance_usd + self.egress_usd


def _price_vector(egress_usd_per_gb, n: int) -> np.ndarray:
    """The per-source-DC egress rate vector the scalar path uses."""
    if egress_usd_per_gb is None:
        return np.full(n, NET_COST_PER_GB)
    return np.broadcast_to(
        np.asarray(egress_usd_per_gb, np.float64), (n,))


def pack_query(query: QuerySpec, egress_usd_per_gb=None
               ) -> Dict[str, np.ndarray]:
    """The query's stage chain as flat arrays for the packed evaluator:
    ``inputs``/``speed``/``price`` [N] and ``out_ratio``/``comp_s``/
    ``waves`` [S+1] (stage 0 first)."""
    return {
        "inputs": query.inputs(),
        "speed": query.speeds(),
        "price": _price_vector(egress_usd_per_gb, query.n),
        "out_ratio": np.array([s.out_ratio for s in query.stages],
                              np.float64),
        "comp_s": np.array([s.compute_s_per_gb for s in query.stages],
                           np.float64),
        "waves": np.array([float(s.waves) for s in query.stages],
                          np.float64),
    }


def _eval_packed_numpy(placements: np.ndarray, bw: np.ndarray,
                       inputs: np.ndarray, speed: np.ndarray,
                       price: np.ndarray, out_ratio: np.ndarray,
                       comp_s: np.ndarray, waves: np.ndarray,
                       instance_usd_per_hour) -> PlacementCostBatch:
    """The vectorized core: one pass over all M candidates.

    `placements` is [M, S, N]; every other input is either shared
    ([N], [N,N], [S+1]) or per-candidate ([M,N], [M,N,N], [M,S+1]) —
    per-candidate forms let the fleet driver fuse different jobs'
    searches into one launch. Reduction order matches the scalar
    :func:`estimate_cost` exactly (row-wise sums over the same
    contiguous axes, order-independent maxes), so the per-candidate
    outputs are bit-identical to the scalar reference — the property
    `tests/test_placement_batch.py` pins.
    """
    M, S, N = placements.shape
    bw3 = bw if bw.ndim == 3 else bw[None]
    bwc = np.maximum(bw3, 1e-6)
    inputs2 = inputs if inputs.ndim == 2 else inputs[None]
    speed2 = speed if speed.ndim == 2 else speed[None]
    price2 = price if price.ndim == 2 else price[None]
    out2 = out_ratio if out_ratio.ndim == 2 else out_ratio[None]
    comp2 = comp_s if comp_s.ndim == 2 else comp_s[None]
    waves2 = waves if waves.ndim == 2 else waves[None]
    off = ~np.eye(N, dtype=bool)
    diag = np.arange(N)

    compute_s = waves2[:, 0] * (inputs2 * comp2[:, 0:1] / speed2).max(axis=1)
    held = inputs2 * out2[:, 0:1]
    net_s = np.zeros(1)
    egress_gb = np.zeros(1)
    egress_usd = np.zeros(1)
    for k in range(1, S + 1):
        frac = placements[:, k - 1, :]
        vol = held[:, :, None] * frac[:, None, :]          # [M,N,N]
        vol[:, diag, diag] = 0.0
        t = vol * 1000.0 / bwc
        st_net = waves2[:, k] * t[:, off].max(axis=1)
        new_held = held.sum(axis=1)[:, None] * frac
        st_comp = waves2[:, k] * (new_held * comp2[:, k:k + 1]
                                  / speed2).max(axis=1)
        st_gb = waves2[:, k] * vol.reshape(M, -1).sum(axis=1) / 8.0
        st_usd = waves2[:, k] * ((vol.sum(axis=2) / 8.0
                                  * price2).sum(axis=1))
        net_s = net_s + st_net
        compute_s = compute_s + st_comp
        egress_gb = egress_gb + st_gb
        egress_usd = egress_usd + st_usd
        held = new_held * out2[:, k:k + 1]
    makespan = np.broadcast_to(net_s + compute_s, (M,))
    instance = makespan / 3600.0 * N * instance_usd_per_hour

    def bc(a: np.ndarray) -> np.ndarray:
        """Materialize a possibly-broadcast vector at full batch size."""
        return np.ascontiguousarray(np.broadcast_to(a, (M,)))

    return PlacementCostBatch(
        makespan_s=bc(makespan), net_s=bc(net_s), compute_s=bc(compute_s),
        egress_gb=bc(egress_gb), egress_usd=bc(egress_usd),
        instance_usd=bc(instance))


def _eval_packed_torch(placements: np.ndarray, bw: np.ndarray,
                       inputs: np.ndarray, speed: np.ndarray,
                       price: np.ndarray, out_ratio: np.ndarray,
                       comp_s: np.ndarray, waves: np.ndarray,
                       instance_usd_per_hour, device=None
                       ) -> PlacementCostBatch:
    """The packed evaluator as vectorised torch in f64 on `device`
    (None = CUDA): the reference's jit `_eval_core`
    (`repro/kernels/placement_cost.py:48`), one pass over all M
    candidates with the same shared-or-per-candidate inputs as
    :func:`_eval_packed_numpy`. Plain PyTorch by design, since the
    reference is no Pallas kernel. The reference pads M up to a
    power-of-two bucket only to reuse jit compiles; eager torch
    compiles nothing, so M is used as it is. The inputs cross in one
    host-to-device copy of one buffer and the six vectors come back in
    one copy. Reductions may differ from numpy in the last ulp, so the
    cross-backend tests pin decisions, not bytes."""
    dev = resolve_device(device)
    M, S, N = placements.shape
    parts = [(placements, 3), (bw, 3), (inputs, 2), (speed, 2),
             (price, 2), (out_ratio, 2), (comp_s, 2), (waves, 2)]
    parts = [(np.asarray(a, np.float64), k) for a, k in parts]
    flat = torch.from_numpy(np.concatenate(
        [a.reshape(-1) for a, _ in parts])).to(dev)
    views, ofs = [], 0
    for a, per_cand_ndim in parts:
        v = flat[ofs:ofs + a.size].view(a.shape)
        ofs += a.size
        # shared inputs ride along at broadcast size 1
        views.append(v if a.ndim == per_cand_ndim else v[None])
    P, bw_t, inputs, speed, price, out_ratio, comp_s, waves = views
    bwc = torch.clamp(bw_t, min=1e-6)
    off = ~torch.eye(N, dtype=torch.bool, device=dev)
    compute_s = waves[:, 0] * (inputs * comp_s[:, 0:1] / speed).amax(1)
    held = inputs * out_ratio[:, 0:1]
    net_s = torch.zeros(1, dtype=torch.float64, device=dev)
    egress_gb = torch.zeros_like(net_s)
    egress_usd = torch.zeros_like(net_s)
    for k in range(1, S + 1):
        frac = P[:, k - 1, :]
        vol = torch.where(off, held[:, :, None] * frac[:, None, :], 0.0)
        t = torch.where(off, vol * 1000.0 / bwc, -math.inf)
        st_net = waves[:, k] * t.amax((1, 2))
        new_held = held.sum(1)[:, None] * frac
        st_comp = waves[:, k] * (new_held * comp_s[:, k:k + 1]
                                 / speed).amax(1)
        st_gb = waves[:, k] * vol.reshape(M, -1).sum(1) / 8.0
        st_usd = waves[:, k] * ((vol.sum(2) / 8.0 * price).sum(1))
        net_s = net_s + st_net
        compute_s = compute_s + st_comp
        egress_gb = egress_gb + st_gb
        egress_usd = egress_usd + st_usd
        held = new_held * out_ratio[:, k:k + 1]
    makespan = net_s + compute_s
    instance = makespan / 3600.0 * N * instance_usd_per_hour
    out = torch.stack([torch.broadcast_to(a, (M,)) for a in (
        makespan, net_s, compute_s, egress_gb, egress_usd, instance)])
    return PlacementCostBatch(*out.cpu().numpy())


def _eval_packed(placements, bw, packed, instance_usd_per_hour,
                 backend: str, device=None) -> PlacementCostBatch:
    """Dispatch one packed batch to the resolved backend (`device` is
    the ``torch`` backend's; None = CUDA)."""
    if backend == "torch":
        return _eval_packed_torch(
            placements, bw, packed["inputs"], packed["speed"],
            packed["price"], packed["out_ratio"], packed["comp_s"],
            packed["waves"], instance_usd_per_hour, device)
    return _eval_packed_numpy(
        placements, bw, packed["inputs"], packed["speed"],
        packed["price"], packed["out_ratio"], packed["comp_s"],
        packed["waves"], instance_usd_per_hour)


def _validate_batch(query: QuerySpec, placements: np.ndarray,
                    bw: np.ndarray) -> None:
    """The scalar path's shape/positivity/sum checks, batched."""
    n = query.n
    if bw.shape[-2:] != (n, n):
        raise ValueError(f"bw shape {bw.shape} != (..., {n}, {n})")
    if placements.ndim != 3 or \
            placements.shape[1:] != (query.n_shuffles(), n):
        raise ValueError(
            f"placements shape {placements.shape} != "
            f"(M, {query.n_shuffles()}, {n})")
    if (placements < -1e-9).any() or \
            not np.allclose(placements.sum(axis=2), 1.0, atol=1e-6):
        raise ValueError("each stage's fractions must be >= 0, sum to 1")


def estimate_cost_batch(query: QuerySpec, placements: np.ndarray,
                        bw_mbps: np.ndarray, *,
                        egress_usd_per_gb: Union[float, np.ndarray,
                                                 None] = None,
                        instance_usd_per_hour: float =
                        INSTANCE_USD_PER_HOUR,
                        backend: Optional[str] = None,
                        device=None) -> PlacementCostBatch:
    """Price M candidate placements ([M, n_shuffles, N]) against one
    per-pair `bw_mbps` [N,N] in a single vectorized pass.

    The ``numpy`` backend is bit-identical to mapping
    :func:`estimate_cost` over the batch (the scalar function stays the
    readable reference; the search builds the winner's full
    :class:`StageCost` breakdown from it lazily). ``torch`` runs the
    same program as tensor ops on `device` (None = CUDA, raising
    without a card; ``"cpu"`` on the host); ``scalar`` actually maps
    the reference, for tests and the benchmark baseline.
    """
    backend = placement_backend(backend)
    placements = np.ascontiguousarray(np.asarray(placements, np.float64))
    bw = np.asarray(bw_mbps, np.float64)
    _validate_batch(query, placements, bw)
    if len(placements) == 0:       # empty batch: empty vectors, any backend
        empty = np.zeros(0)
        return PlacementCostBatch(*([empty] * 6))
    if backend == "scalar":
        rows = [estimate_cost(query, p, bw,
                              egress_usd_per_gb=egress_usd_per_gb,
                              instance_usd_per_hour=instance_usd_per_hour)
                for p in placements]
        return PlacementCostBatch(
            makespan_s=np.array([r.makespan_s for r in rows]),
            net_s=np.array([r.net_s for r in rows]),
            compute_s=np.array([r.compute_s for r in rows]),
            egress_gb=np.array([r.egress_gb for r in rows]),
            egress_usd=np.array([r.egress_usd for r in rows]),
            instance_usd=np.array([r.instance_usd for r in rows]))
    packed = pack_query(query, egress_usd_per_gb)
    return _eval_packed(placements, bw, packed, instance_usd_per_hour,
                        backend, device)
