"""Fault-plane gate (port of `repro/faults/plane.py`).

Only the gate's resolver is ported so far. The plane itself
(`FaultPlane`, its injection and degradation ladder) is not yet
ported: the fleet and both scenario engines raise
`NotImplementedError` when the gate resolves to ``on``, a plane is
passed in, or a timeline scripts a fault event.
"""
from __future__ import annotations

import os
from typing import Optional

FAULT_MODES = ("off", "on")


def faults_mode(mode: Optional[str] = None) -> str:
    """Resolve the fault gate: an explicit argument wins, then the
    ``REPRO_FAULTS`` environment variable, then ``off`` (the
    byte-identical historical path)."""
    m = mode or os.environ.get("REPRO_FAULTS", "off")
    if m not in FAULT_MODES:
        raise ValueError(f"unknown faults mode {m!r}; "
                         f"expected one of {FAULT_MODES}")
    return m
