"""Predictor-lifecycle gate (port of `repro/lifecycle/manager.py`).

Only the gate's resolver is ported so far. The manager itself (drift
detection, probe scheduling, forest refresh) is not yet ported: the
scenario engine raises `NotImplementedError` when the gate resolves to
``on`` or a manager object is passed in, and so does the controller
when it is handed one.
"""
from __future__ import annotations

import os
from typing import Optional

LIFECYCLE_MODES = ("off", "on")


def lifecycle_mode(mode: Optional[str] = None) -> str:
    """Resolve the lifecycle gate: an explicit argument wins, then the
    ``REPRO_LIFECYCLE`` environment variable, then ``off`` (the
    byte-identical historical path)."""
    m = mode or os.environ.get("REPRO_LIFECYCLE", "off")
    if m not in LIFECYCLE_MODES:
        raise ValueError(f"unknown lifecycle mode {m!r}; "
                         f"expected one of {LIFECYCLE_MODES}")
    return m
