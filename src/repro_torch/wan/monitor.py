"""Monitoring: snapshot-feature capture (Table 3) and the Eq. 1 / Table 2
cost model (AWS t3.nano monitoring VM, 30-minute cadence per Tetrium).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.predictor import assemble_features
from repro_torch.core.plan import monitoring_cost, prediction_cost
from repro_torch.wan.simulator import WanSimulator

# ---- Table 2 cost constants ------------------------------------------
T3_NANO_PER_SEC = 0.0052 / 3600.0       # $/instance-second
NET_COST_PER_GB = 0.09                  # $/GB egress (inter-region avg)

# AWS list-price egress ($/GB) per source region of the 8-DC testbed —
# the placement cost layer (in the JAX package so far) prices each DC's
# shuffle egress at its own source rate instead of the Table-2 average.
EGRESS_USD_PER_GB = {
    "us-east": 0.09, "us-west": 0.09, "eu-west": 0.09,
    "ap-south": 0.1093, "ap-se": 0.12, "ap-se2": 0.114,
    "ap-ne": 0.114, "sa-east": 0.15,
}


def egress_price_vector(regions) -> np.ndarray:
    """Per-DC egress $/GB for named regions (unknown regions fall back
    to the Table-2 average `NET_COST_PER_GB`)."""
    return np.array([EGRESS_USD_PER_GB.get(r, NET_COST_PER_GB)
                     for r in regions], np.float64)
MONITOR_SECONDS = 20.0                  # stable runtime needs >=20 s
SNAPSHOT_SECONDS = 1.0
MONITOR_EVERY_MIN = 30.0                # Tetrium's suggestion
AVG_BW_MBPS = 200.0                     # Table 2's network-cost basis


def measurement_net_cost(seconds: float, n_peers: int,
                         avg_bw_mbps: float = AVG_BW_MBPS) -> float:
    """$ for the data a node exchanges during one measurement."""
    gb = avg_bw_mbps / 8.0 * seconds * n_peers / 1024.0
    return gb * NET_COST_PER_GB


def probe_cost_usd(seconds: float, n_dcs: int) -> float:
    """$ for ONE Eq. 1 measurement occurrence across the cluster:
    every node pays `seconds` of monitoring-VM time plus the egress of
    the measurement traffic it exchanges with its N-1 peers. A full
    20-second probe (`MONITOR_SECONDS`) is ~20x the 1-second snapshot
    (`SNAPSHOT_SECONDS`) — the cost axis the lifecycle probe scheduler
    (in the JAX package so far) optimizes."""
    z = measurement_net_cost(seconds, n_dcs - 1)
    return n_dcs * (T3_NANO_PER_SEC * seconds + z)


def annual_costs(n_dcs: int) -> Dict[str, float]:
    """Reproduces one row of Table 2."""
    O = 365 * 24 * 60 / MONITOR_EVERY_MIN
    z_full = measurement_net_cost(MONITOR_SECONDS, n_dcs - 1)
    z_snap = measurement_net_cost(SNAPSHOT_SECONDS, n_dcs - 1)
    full = monitoring_cost(O, n_dcs, T3_NANO_PER_SEC, MONITOR_SECONDS, z_full)
    pred = prediction_cost(O, n_dcs, T3_NANO_PER_SEC, z_snap)
    return {"runtime_monitoring": full, "prediction": pred,
            "savings_frac": 1.0 - pred / full}


@dataclass
class SnapshotMonitor:
    """Captures one cheap snapshot of the cluster (1-second features).
    The last raw capture is kept on `last_raw` so a trace harness can
    line up what the controller saw against ground truth."""
    sim: WanSimulator
    last_raw: Optional[Dict[str, np.ndarray]] = None

    def capture(self, conns: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Returns (X features [N*(N-1), 6], raw feature dict)."""
        N = self.sim.N
        c = np.ones((N, N)) if conns is None else conns
        snap = self.sim.measure_snapshot(c)
        mem, cpu, retr = self.sim.host_metrics(c, bw=snap)
        X = assemble_features(N, snap, mem, cpu, retr, self.sim.dist)
        self.last_raw = {"snapshot_bw": snap, "mem_util": mem,
                         "cpu_load": cpu, "retrans": retr,
                         "dist": self.sim.dist}
        return X, self.last_raw

    def measure(self, conns: Optional[np.ndarray] = None) -> np.ndarray:
        """Lightweight monitored BW at the given connection matrix — the
        iftop analogue the AIMD agents consume (§3.2.2). Pass the
        connection matrix actually in force; an idle default-of-ones
        measurement describes a traffic regime the workload is not in."""
        return self.sim.measure_snapshot(conns)

    def probe(self, conns: Optional[np.ndarray] = None) -> np.ndarray:
        """FULL runtime probe: the stable >=20-second all-pairs
        measurement of §2.2 (small residual noise, `MONITOR_SECONDS` of
        measurement traffic). ~20x the snapshot's Eq. 1 cost
        (`probe_cost_usd`), so callers should spend it deliberately —
        the lifecycle layer fires one only when drift is suspected."""
        return self.sim.measure_runtime(conns)
