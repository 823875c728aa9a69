"""The paper's algorithms: plans, Eq. 2-3 global optimization (+ fleet
budget splitting), §3.2.2 AIMD agents, Algorithm-1 closeness, the
§3.1 Random Forest and feature assembly, and the WAN-scheduled
cross-pod all-reduce (`wansync.py`); port of `repro.core`."""
