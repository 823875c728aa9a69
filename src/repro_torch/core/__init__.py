"""The paper's algorithms: plans, Eq. 2-3 global optimization (+ fleet
budget splitting), §3.2.2 AIMD agents, Algorithm-1 closeness, the
§3.1 Random Forest and feature assembly (port of `repro.core`; the
cross-pod all-reduce is not yet ported)."""
