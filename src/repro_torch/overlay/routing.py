"""Overlay routing gate (port of `repro/overlay/routing.py`).

Only the gate's resolver is ported so far. Relay routing itself
(`plan_routes`, `RoutedPlan`) is not yet ported: the controller raises
`NotImplementedError` when the gate resolves to ``on``.
"""
from __future__ import annotations

import os
from typing import Optional

OVERLAY_MODES = ("off", "on")


def overlay_mode(mode: Optional[str] = None) -> str:
    """Resolve the overlay gate: an explicit argument wins, then the
    ``REPRO_OVERLAY`` environment variable, then ``off`` (the byte-
    identical historical path)."""
    m = mode or os.environ.get("REPRO_OVERLAY", "off")
    if m not in OVERLAY_MODES:
        raise ValueError(f"unknown overlay mode {m!r}; "
                         f"expected one of {OVERLAY_MODES}")
    return m
