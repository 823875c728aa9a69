"""Dynamic local optimization (paper §3.2.2): per-VM AIMD agent.

Each worker starts at the MAXIMUM of the global optimizer's range and
adapts between [min, max] using Additive-Increase / Multiplicative-
Decrease driven by lightweight monitoring (iftop analogue):

  * monitored BW significantly below target (Delta > 100 Mbps) =>
    congestion: halve connections & target BW (not below the minimum)
  * monitored ~ target => additive: +1 connection, +1 linear BW unit
  * transfers < 1 MB skip the toggle entirely (negligible utilization)

Throttling caps BW-rich destinations at the row-mean threshold T.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.global_opt import GlobalPlan

SIGNIFICANT_MBPS = 100.0          # [13, 24] in the paper
MIN_TRANSFER_BYTES = 1 << 20      # 1 MB


@dataclass
class AimdAgent:
    """Local agent for one source DC (one VM)."""
    src: int
    min_cons: np.ndarray          # [N]
    max_cons: np.ndarray          # [N]
    min_bw: np.ndarray            # [N]
    max_bw: np.ndarray            # [N]
    unit_bw: np.ndarray           # [N] predicted per-connection BW
    throttle: np.ndarray          # [N] cap (inf = none)
    cons: np.ndarray = field(init=False)
    target_bw: np.ndarray = field(init=False)
    epochs: int = field(default=0, init=False)

    def __post_init__(self):
        # start from maximum throughput (reduces RTT bias — paper's
        # motivation for AIMD from the top)
        self.cons = self.max_cons.astype(np.int64).copy()
        self.target_bw = np.minimum(self.max_bw, self.throttle).copy()

    @classmethod
    def from_plan(cls, plan: GlobalPlan, src: int) -> "AimdAgent":
        """Build the agent for source DC `src` from a global plan's
        ranges (copies, so later replans don't mutate a live agent)."""
        return cls(
            src=src,
            min_cons=plan.min_cons[src].copy(),
            max_cons=plan.max_cons[src].copy(),
            min_bw=plan.min_bw[src].copy(),
            max_bw=plan.max_bw[src].copy(),
            unit_bw=plan.pred_bw[src].copy(),
            throttle=plan.throttle[src].copy(),
        )

    # ------------------------------------------------------------------
    def step(self, monitored_bw: np.ndarray,
             transfer_bytes: Optional[np.ndarray] = None,
             delta: float = SIGNIFICANT_MBPS) -> None:
        """One local-optimizer epoch (the paper uses 5-second epochs)."""
        self.epochs += 1
        N = len(self.cons)
        for j in range(N):
            if j == self.src:
                continue
            if transfer_bytes is not None and \
                    transfer_bytes[j] < MIN_TRANSFER_BYTES:
                continue                          # skip toggle (<1MB)
            cap = min(self.max_bw[j], self.throttle[j])
            if monitored_bw[j] < self.target_bw[j] - delta:
                # multiplicative decrease: half or minimum, whichever higher
                self.cons[j] = max(int(self.min_cons[j]), self.cons[j] // 2)
                self.target_bw[j] = max(self.min_bw[j], self.target_bw[j] / 2)
            elif abs(monitored_bw[j] - self.target_bw[j]) <= delta:
                # additive increase up to the global max / throttle cap
                self.cons[j] = min(int(self.max_cons[j]), self.cons[j] + 1)
                self.target_bw[j] = min(cap, self.target_bw[j] + self.unit_bw[j])
            # else: monitored far ABOVE target — leave state (stale target
            # will catch up via additive mode next epoch)
            self.target_bw[j] = float(np.clip(self.target_bw[j],
                                              self.min_bw[j], cap))


def run_agents(plan: GlobalPlan, monitor_fn, steps: int,
               transfer_bytes: Optional[np.ndarray] = None):
    """Drive one agent per DC for `steps` epochs.

    monitor_fn(conns [N,N]) -> monitored BW matrix [N,N]; returns the
    final connection matrix and the per-epoch target-BW history (the
    Fig. 9 trace).
    """
    N = plan.n
    agents = [AimdAgent.from_plan(plan, i) for i in range(N)]
    history = []
    conns = plan.max_cons.copy()
    for _ in range(steps):
        mon = monitor_fn(conns)
        for i, ag in enumerate(agents):
            tb = transfer_bytes[i] if transfer_bytes is not None else None
            ag.step(mon[i], tb)
            conns[i] = ag.cons
        history.append(np.stack([ag.target_bw.copy() for ag in agents]))
    return conns, np.asarray(history)
