"""Plan -> wire lowering: the per-offset schedule.

Port of `offset_schedule` in `repro/control/schedule.py`: per offset
class (pod ``i <-> (i+o) % P``, the paper's closeness classes on a
geo-ring), the chunk multiplicity (heterogeneous parallel connections)
and the wire bits (from the weakest predicted link in the class). The
quantizing wire codec (`wire_encode` / `wire_decode`) comes with
`kv_migrate`, which is not yet ported.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.plan import WanPlan

__all__ = ["offset_schedule", "MAX_CHUNKS"]

MAX_CHUNKS = 16


def offset_schedule(plan: WanPlan) -> List[Dict[str, int]]:
    """For each offset o in [1, P-1]: chunk multiplicity (max conns over
    the pairs in that class — the WANify heterogeneous connections) and
    wire bits (from the weakest predicted link in the class)."""
    P = plan.n_pods
    bits = plan.offset_bits()      # part of plan.signature(): replans
    sched = []                     # with equal signatures lower equally
    for o in range(1, P):
        conns = max(plan.conns[i][(i + o) % P] for i in range(P))
        # round to a power of two so chunk splits always divide segments
        chunks = 1 << max(0, int(np.ceil(np.log2(max(1, int(conns))))))
        sched.append({"offset": o, "chunks": min(chunks, MAX_CHUNKS),
                      "bits": bits[o - 1]})
    return sched
