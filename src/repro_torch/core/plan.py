"""WanPlan — the bridge from the paper's connection matrices to the
cross-pod collective schedule, plus the Eq. 1 monitoring cost model.

The plan carries, per pod-pair (the "DC pair"), the heterogeneous stream
multiplicity (the "parallel connections") and the compression bits
chosen from predicted link bandwidth (SAGQ-style, §5.6). wansync.py
consumes `ring_chunks` to build the chunked ppermute schedule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


from repro_torch.core.global_opt import GlobalPlan


@dataclass(frozen=True)
class WanPlan:
    """The frozen transfer plan consumers lower to the wire: per-pair
    stream multiplicities, predicted BW, and per-hop wire bits.
    `signature()` is the compile-cache identity."""

    n_pods: int
    conns: Tuple[Tuple[int, ...], ...]      # [P,P] stream multiplicity
    pred_bw: Tuple[Tuple[float, ...], ...]  # [P,P] Mbps (predicted runtime)
    compress_bits: Tuple[int, ...]          # per ring-hop quantization bits
    # ring hop i sends pod i -> pod (i+1) % P
    # the frozen (threshold, bits) policy the per-hop bits were picked
    # with: `offset_bits()` must use the SAME policy, or a custom-
    # policy plan's signature would mix per-hop bits from one policy
    # with per-offset bits from the default
    bits_policy: Tuple[Tuple[float, int], ...] = None  # type: ignore

    def __post_init__(self):
        if self.bits_policy is None:
            object.__setattr__(self, "bits_policy",
                               freeze_bits_policy(None))

    @classmethod
    def from_global(cls, plan: GlobalPlan, *, use_max: bool = True,
                    bits_policy: Optional[dict] = None) -> "WanPlan":
        """Freeze a GlobalPlan at one end of its range (max by
        default — the paper starts AIMD from maximum throughput) and
        pick per-hop compression bits from predicted BW. The policy is
        stored on the plan so `offset_bits()` quantizes with the same
        thresholds."""
        cons = plan.max_cons if use_max else plan.min_cons
        P = plan.n
        bits = []
        for i in range(P):
            j = (i + 1) % P
            bits.append(pick_bits(plan.pred_bw[i][j], bits_policy))
        return cls(
            n_pods=P,
            conns=tuple(tuple(int(v) for v in row) for row in cons),
            pred_bw=tuple(tuple(float(v) for v in row) for row in plan.pred_bw),
            compress_bits=tuple(bits),
            bits_policy=freeze_bits_policy(bits_policy),
        )

    @classmethod
    def uniform(cls, n_pods: int, conns: int = 1, bits: int = 32) -> "WanPlan":
        """Paper baseline: single connection (or uniform-k), no compression."""
        c = tuple(tuple(conns if i != j else 1 for j in range(n_pods))
                  for i in range(n_pods))
        bw = tuple(tuple(1000.0 for _ in range(n_pods)) for _ in range(n_pods))
        return cls(n_pods, c, bw, tuple(bits for _ in range(n_pods)))

    # ------------------------------------------------------------------
    def ring_chunks(self) -> List[int]:
        """Stream multiplicity per ring hop (pod i -> i+1). This is the
        WANify heterogeneous-connections knob: more chunks on weak hops
        => more in-flight pipelined transfers on that link."""
        P = self.n_pods
        return [max(1, self.conns[i][(i + 1) % P]) for i in range(P)]

    def max_ring_chunks(self) -> int:
        """Largest hop multiplicity (sizes shared pipeline buffers)."""
        return max(self.ring_chunks()) if self.n_pods > 1 else 1

    def offset_bits(self) -> Tuple[int, ...]:
        """Wire bits per offset class (offset o exchanges pod
        i <-> (i+o) % P): quantization chosen from the weakest predicted
        link in the class, under the SAME frozen policy the per-hop
        `compress_bits` were picked with (a custom `from_global(bits_
        policy=...)` used to fall back to the default here, yielding a
        signature whose two bit sets disagreed). The schedule lowering
        consumes this, so it must be part of the compile-cache
        identity."""
        P = self.n_pods
        pol = dict(self.bits_policy)
        return tuple(
            pick_bits(min(self.pred_bw[i][(i + o) % P] for i in range(P)),
                      pol)
            for o in range(1, P))

    def signature(self) -> Tuple:
        """Hashable identity for plan-cache keying when the controller
        re-plans. Covers everything the lowered collective depends on:
        connection counts (chunk multiplicities) and wire bits are
        compile-time constants."""
        return (self.n_pods, self.conns, self.compress_bits,
                self.offset_bits())


DEFAULT_BITS_POLICY: dict = {200.0: 8, 600.0: 16, float("inf"): 32}


def freeze_bits_policy(policy: Optional[dict]) -> Tuple[Tuple[float, int],
                                                        ...]:
    """A policy dict as the hashable sorted (threshold, bits) tuple a
    frozen :class:`WanPlan` stores (None = the default policy)."""
    pol = DEFAULT_BITS_POLICY if policy is None else policy
    return tuple(sorted((float(t), int(b)) for t, b in pol.items()))


def pick_bits(link_bw_mbps: float, policy: Optional[dict] = None) -> int:
    """BW-aware gradient-compression bits (SAGQ analogue): weaker link =>
    fewer bits. Thresholds in Mbps; a BW above every threshold (a
    policy without the ``inf`` sentinel) falls back to full 32-bit."""
    pol = policy or DEFAULT_BITS_POLICY
    for thr in sorted(pol):
        if link_bw_mbps <= thr:
            return pol[thr]
    return 32


# ----------------------------------------------------------------------
# Eq. 1 — annual monitoring cost:  O x N x (x*y + z)
# ----------------------------------------------------------------------
def monitoring_cost(O: float, N: int, x: float, y: float, z: float) -> float:
    """O: occurrences/year, N: nodes, x: $/instance-second,
    y: seconds/measurement, z: $/instance network cost per measurement."""
    return O * N * (x * y + z)


def prediction_cost(O: float, N: int, x: float, z_snapshot: float,
                    train_cost: float = 0.0) -> float:
    """Snapshot-based prediction: y shrinks to ~1 s and z to the snapshot
    traffic; training is a one-off amortized cost."""
    return O * N * (x * 1.0 + z_snapshot) + train_cost
