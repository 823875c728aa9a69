"""Overlay routing through intermediate DCs (Terra-style cross-layer);
port of `repro/overlay`.

Public surface: :func:`plan_routes` (the bounded relay search),
:class:`RoutedPlan` (the frozen per-pair path sets), and
:func:`overlay_mode` (the ``REPRO_OVERLAY`` gate). The consumer stack
— `WanifyController(overlay=...)`, the scenario engine's routed
execution, and `placement.cost.achievable_bw(routing=...)` — rides
these; `WanSimulator.waterfill_routed` is the ground truth that
charges relay flows on both hops.
"""
from repro_torch.overlay.routing import (DEFAULT_GAIN_MIN, OVERLAY_MODES,
                                   RoutedPlan, overlay_mode, plan_routes)

__all__ = [
    "DEFAULT_GAIN_MIN",
    "OVERLAY_MODES",
    "RoutedPlan",
    "overlay_mode",
    "plan_routes",
]
