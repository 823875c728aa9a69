"""Terra-style overlay routing: relay a weak transfer through an
intermediate DC.

WANify's premise is that the achievable-BW surface between distant DCs
is richer than one direct connection (paper §2.2, §3.2); inter-DC
throughput also violates the triangle inequality — a one-hop detour
i -> k -> j can sustain more than the direct link i -> j (Terra,
arxiv 1904.08480; "Bandwidth in the Cloud", arxiv 1512.01129). The
overlay layer splits a pair's planned parallel connections between the
direct path and at most one relay path per pair:

  * :func:`plan_routes` is a bounded search over candidate relays,
    pruned by Algorithm-1 closeness (`relay_candidates`) and scored by
    predicted per-connection store-and-forward BW
    ``min(pred[i,k], pred[k,j])``; a relay is only taken when it beats
    the direct prediction by ``gain_min``.
  * :class:`RoutedPlan` is the frozen result: the residual direct
    connection matrix plus ``(src, via, dst, conns)`` relay specs, with
    a `signature()` for plan-cache identity.
  * Lowering is honest about contention: a relay's connections are
    folded onto BOTH hop links (`expanded_conns`), and
    `WanSimulator.waterfill_routed` charges them on both hops in the
    water-fill, crediting the store-and-forward minimum of the two hop
    rates — a relay through a NIC-saturated DC buys nothing.

Gating: ``REPRO_OVERLAY=off|on`` (off is the default), resolved by
:func:`overlay_mode`; with the overlay off no routed code path runs,
so every existing trace/golden replays byte-identical.

Port of `repro/overlay/routing.py`: host numpy float64, as in the JAX
package, so a routed plan and its record are the reference's to the
bit. The routed fill (`WanSimulator.waterfill_routed`) goes through
the simulator's fill backends, on the card as one `waterfill` launch.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.global_opt import relay_candidates
from repro_torch.core.relations import infer_dc_relations

OVERLAY_MODES = ("off", "on")

# a relay must beat the direct prediction by this factor before any
# connections are moved off the direct path (relaying is not free: the
# flows contend on two links and occupy the via-DC's NIC both ways, so
# a marginal predicted edge — snapshot contention skews far pairs by
# ~1.5x — must not trigger a detour; a real cut clears 2x by decades)
DEFAULT_GAIN_MIN = 2.0


def overlay_mode(mode: Optional[str] = None) -> str:
    """Resolve the overlay gate: an explicit argument wins, then the
    ``REPRO_OVERLAY`` environment variable, then ``off`` (the byte-
    identical historical path)."""
    m = mode or os.environ.get("REPRO_OVERLAY", "off")
    if m not in OVERLAY_MODES:
        raise ValueError(f"unknown overlay mode {m!r}; "
                         f"expected one of {OVERLAY_MODES}")
    return m


@dataclass(frozen=True)
class RoutedPlan:
    """A transfer plan with per-pair path sets: the residual direct
    connection matrix plus one-hop relay paths, each with its own
    connection count. `signature()` is the routed compile-cache
    identity (the base `WanPlan.signature()` does not see routing)."""

    n_pods: int
    direct: Tuple[Tuple[int, ...], ...]   # [P,P] conns left on the
    #                                       direct path per pair
    relays: Tuple[Tuple[int, int, int, int], ...]  # (src, via, dst,
    #                                       conns), sorted, deduped
    pred_bw: Tuple[Tuple[float, ...], ...]  # [P,P] per-conn predicted
    #                                       BW the routes were scored on

    def signature(self) -> Tuple:
        """Hashable identity of the routed lowering (direct conns plus
        the chosen relay paths)."""
        return (self.n_pods, self.direct, self.relays)

    def expanded_conns(self) -> np.ndarray:
        """The [P,P] connection matrix the WAN actually sees: direct
        connections plus each relay's connections folded onto BOTH of
        its hop links (the contention truth of store-and-forward)."""
        c = np.asarray(self.direct, np.float64).copy()
        for i, k, j, cr in self.relays:
            c[i, k] += cr
            c[k, j] += cr
        return c

    def routed_pred_bw(self) -> np.ndarray:
        """Predicted end-to-end surface [P,P]: direct conns x per-conn
        prediction, plus each relay's conns x the store-and-forward
        bottleneck ``min`` of its hop predictions. (The placement
        layer's `achievable_bw(routing=...)` is the knee/capture-aware
        version of this.)"""
        pred = np.asarray(self.pred_bw, np.float64)
        bw = pred * np.asarray(self.direct, np.float64)
        for i, k, j, cr in self.relays:
            bw[i, j] += cr * min(pred[i, k], pred[k, j])
        return bw


def plan_routes(pred_bw: np.ndarray, conns: np.ndarray, *,
                dc_rel: Optional[np.ndarray] = None, D: float = 100.0,
                gain_min: float = DEFAULT_GAIN_MIN,
                max_candidates: int = 4, min_direct: int = 1,
                max_relay_conns: int = 4,
                capture_conns: Optional[np.ndarray] = None) -> RoutedPlan:
    """Bounded one-hop route search over the predicted BW surface.

    `pred_bw` is the predicted pair BW at the operating point it was
    measured at; `capture_conns` is that operating point (the conns
    matrix the snapshot ran at — `WanifyController.last_capture_conns`).
    Scoring normalizes to per-connection units ``pred / capture_conns``
    so pairs planned at different connection counts compare fairly;
    without `capture_conns` the prediction is taken as already
    per-connection.

    For every pair (i, j) the candidate relays are pruned by
    Algorithm-1 closeness (:func:`repro_torch.core.global_opt.
    relay_candidates`: both hops must sit in a closeness class no
    farther than the direct pair's, closest classes first, at most
    `max_candidates` scored); the best candidate by per-connection
    store-and-forward BW ``min(unit[i,k], unit[k,j])`` wins, and only
    if it beats the direct per-connection rate by `gain_min`. The
    pair's planned connections are then split proportionally to the
    two paths' per-connection rates, keeping at least `min_direct` on
    the direct link (so the monitor keeps observing it) and at most
    `max_relay_conns` on the detour — a relay borrows the via-DC's NIC
    and the healthy hops' capacity both ways, so its transit footprint
    is bounded no matter how many connections AIMD grants the pair.
    Deterministic: ties break toward the lower DC index.
    """
    pred = np.asarray(pred_bw, np.float64)
    P = pred.shape[0]
    c = np.rint(np.asarray(conns, np.float64)).astype(np.int64)
    unit = pred
    if capture_conns is not None:
        cap = np.asarray(capture_conns, np.float64)[:P, :P]
        unit = pred / np.maximum(cap, 1.0)
    rel = infer_dc_relations(pred, D) if dc_rel is None \
        else np.asarray(dc_rel)
    direct = c.copy()
    relays = []
    for i in range(P):
        for j in range(P):
            if i == j or c[i, j] <= min_direct:
                continue
            best_k, best_bw = -1, 0.0
            for k in relay_candidates(rel, i, j, max_candidates):
                path_bw = min(float(unit[i, k]), float(unit[k, j]))
                if path_bw > best_bw:
                    best_k, best_bw = k, path_bw
            if best_k < 0 or best_bw < gain_min * float(unit[i, j]):
                continue
            total = int(c[i, j])
            share = best_bw / max(best_bw + float(unit[i, j]), 1e-12)
            cr = int(round(total * share))
            cr = min(max(cr, 1), total - min_direct, int(max_relay_conns))
            direct[i, j] -= cr
            relays.append((i, best_k, j, cr))
    return RoutedPlan(
        n_pods=P,
        direct=tuple(tuple(int(v) for v in row) for row in direct),
        relays=tuple(sorted(relays)),
        pred_bw=tuple(tuple(float(v) for v in row) for row in unit))
