"""TenantView — one job's sliced, tenant-credited view of the shared WAN.

A fleet job plans over its own topology slice (a subset of the
monitored DCs) and must see every OTHER job's transfers as real
contention while never double-counting its own. `TenantView` gives a
`WanifyController` exactly that without the controller knowing the
fleet exists: it quacks like a `WanSimulator` restricted to the job's
DCs (``N``, ``regions``, ``dist``, ``measure_snapshot``,
``host_metrics``, ``waterfill``, ``advance``), embedding slice-scale
connection matrices into the shared mesh, measuring with
``tenant=<job>`` (so the job's registered flows are excluded and every
rival tenant's flows contend — and are credited on *their* side), and
slicing results back down.

Noise accounting is unchanged: each measurement draws from the shared
simulator's named observation stream exactly once, so fleet replays
stay byte-identical as long as jobs are visited in a fixed order.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.wan.simulator import WanSimulator


class TenantView:
    """Restrict a shared :class:`WanSimulator` to one tenant's DC slice.

    Drop-in for the `sim` argument of `WanifyController` /
    `SnapshotMonitor`; only the surface those two consume (plus
    `waterfill` for harnesses) is implemented.
    """

    def __init__(self, shared: WanSimulator, tenant: str,
                 dcs: Sequence[int]):
        """`dcs`: global DC indices of this tenant's topology slice
        (order defines the slice's pod numbering)."""
        ix = np.asarray(list(dcs), np.int64)
        if len(ix) < 1 or len(set(ix.tolist())) != len(ix):
            raise ValueError(f"invalid DC slice {list(dcs)}")
        if ix.min() < 0 or ix.max() >= shared.N:
            raise ValueError(
                f"DC slice {list(dcs)} outside monitored mesh "
                f"(N={shared.N})")
        self.shared = shared
        self.tenant = str(tenant)
        self.ix = ix
        self.N = len(ix)
        self.regions = [shared.regions[i] for i in ix]
        self.dist = shared.dist[np.ix_(ix, ix)]

    # ------------------------------------------------------------------
    # slice <-> mesh
    # ------------------------------------------------------------------
    def embed(self, mat: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """Lift a slice-scale [P,P] matrix to mesh scale [N,N]."""
        full = np.full((self.shared.N, self.shared.N), float(fill))
        full[np.ix_(self.ix, self.ix)] = np.asarray(mat, np.float64)
        return full

    def extract(self, full: np.ndarray) -> np.ndarray:
        """Project a mesh-scale [N,N] matrix down to the slice [P,P]."""
        return np.asarray(full, np.float64)[np.ix_(self.ix, self.ix)]

    # ------------------------------------------------------------------
    # the WanSimulator surface the control plane consumes
    # ------------------------------------------------------------------
    def advance(self, steps: int = 1) -> None:
        """Advance the SHARED fluctuation process (all tenants see it).

        Under a fleet controller the fleet owns simulated time and jobs
        run with ``advance_sim=False``, so this is only exercised by a
        standalone consumer of the view.
        """
        self.shared.advance(steps)

    def waterfill(self, conns: np.ndarray,
                  active: Optional[np.ndarray] = None,
                  cap: Optional[np.ndarray] = None) -> np.ndarray:
        """Tenant-credited achieved BW on the slice at slice conns."""
        full = self.embed(conns if active is None else conns * active)
        full_cap = None if cap is None else self.embed(cap, fill=np.inf)
        return self.extract(self.shared.waterfill(
            full, cap=full_cap, tenant=self.tenant))

    def measure_snapshot(self, conns: Optional[np.ndarray] = None
                         ) -> np.ndarray:
        """1-second snapshot of the slice, rivals contending."""
        c = np.ones((self.N, self.N)) if conns is None else conns
        return self.extract(self.shared.measure_snapshot(
            self.embed(c), tenant=self.tenant))

    def measure_runtime(self, conns: Optional[np.ndarray] = None
                        ) -> np.ndarray:
        """Stable >=20 s measurement of the slice, rivals contending."""
        c = np.ones((self.N, self.N)) if conns is None else conns
        return self.extract(self.shared.measure_runtime(
            self.embed(c), tenant=self.tenant))

    def host_metrics(self, conns: np.ndarray,
                     bw: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Slice-scale Table-3 host metrics (mem/cpu/retrans)."""
        full_c = self.embed(conns)
        full_bw = None if bw is None else self.embed(bw)
        mem, cpu, retr = self.shared.host_metrics(full_c, bw=full_bw,
                                                  tenant=self.tenant)
        return mem[self.ix], cpu[self.ix], retr[np.ix_(self.ix, self.ix)]

    def register(self, conns: np.ndarray) -> None:
        """Publish this tenant's slice-scale in-force connections as
        its registered flows on the shared mesh."""
        self.shared.set_tenant_conns(self.tenant, self.embed(conns))

    def unregister(self) -> None:
        """Withdraw this tenant's flows (job departure)."""
        self.shared.clear_tenant(self.tenant)
