"""Nested span tracing around one tick of the closed loop.

"Where does a tick go?" — snapshot -> predict -> optimize/route ->
lower -> water-fill -> AIMD — was unanswerable before this module:
wall time existed only as whole-bench aggregates. A :class:`SpanTracer`
records a nested span per stage with

  * wall time (``time.perf_counter`` deltas — the ONLY place the obs
    plane touches a clock, and it flows solely into span records /
    exports, never into trace values or control decisions);
  * optional counter deltas from watched registries (fill iterations,
    kernel launches, cache hits) on spans opened with ``delta=True``.

Gating (`REPRO_OBS=off|on`, off default, resolved by :func:`obs_mode`)
follows the overlay/lifecycle pattern: off installs the shared
:data:`NULL_TRACER`, whose `span()` returns a reused no-op context
manager — the hot path pays one attribute lookup and an empty
``with``. On is *passive* by construction: spans observe the stages
the caller already runs, in the order it already runs them, so every
historical trace golden replays byte-identical with obs on (pinned in
tests/test_obs.py).
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.registry import MetricsRegistry

OBS_MODES = ("off", "on")


def obs_mode(mode: Optional[str] = None) -> str:
    """Resolve the observability gate: an explicit argument wins, then
    the ``REPRO_OBS`` environment variable, then ``off``."""
    m = mode or os.environ.get("REPRO_OBS", "off")
    if m not in OBS_MODES:
        raise ValueError(f"unknown obs mode {m!r}; "
                         f"expected one of {OBS_MODES}")
    return m


class _NullSpan:
    """Reusable no-op context manager (the off path's entire cost)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The off-gate tracer: every span is the shared no-op."""

    enabled = False
    spans: List[Dict[str, Any]] = []

    def span(self, name: str, delta: bool = False, **attrs) -> _NullSpan:
        """Return the shared no-op span."""
        return _NULL_SPAN

    def watch(self, registry: MetricsRegistry) -> None:
        """No-op (nothing is ever recorded)."""


NULL_TRACER = NullTracer()


class _SpanCtx:
    """One live span: context manager that records itself on exit."""

    __slots__ = ("tracer", "name", "attrs", "delta", "sid", "parent",
                 "depth", "t0", "before")

    def __init__(self, tracer: "SpanTracer", name: str, delta: bool,
                 attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.delta = delta
        self.before: Optional[Dict[str, float]] = None

    def __enter__(self):
        tr = self.tracer
        self.sid = tr._seq
        tr._seq += 1
        self.parent = tr._stack[-1] if tr._stack else -1
        self.depth = len(tr._stack)
        tr._stack.append(self.sid)
        if self.delta and tr._watched:
            self.before = {f"{reg.namespace}.{k}": v
                           for reg in tr._watched
                           for k, v in reg.counters().items()}
        self.t0 = tr._clock()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        dur = tr._clock() - self.t0
        tr._stack.pop()
        row: Dict[str, Any] = {
            "sid": self.sid, "parent": self.parent, "depth": self.depth,
            "name": self.name, "t": self.t0 - tr._t0, "dur_s": dur,
        }
        if self.attrs:
            row["attrs"] = self.attrs
        if self.before is not None:
            after = {f"{reg.namespace}.{k}": v
                     for reg in tr._watched
                     for k, v in reg.counters().items()}
            # metrics created DURING the span delta from 0
            d = {k: v - self.before.get(k, 0) for k, v in after.items()
                 if v != self.before.get(k, 0)}
            if d:
                row["delta"] = d
        tr._record(row)
        return False


class SpanTracer:
    """Collects nested spans; one per engine/fleet when obs is on.

    ``watch(registry)`` registers a :class:`MetricsRegistry` whose
    counter/gauge movement is captured as a per-span delta on spans
    opened with ``delta=True`` (delta keys are namespaced
    ``<registry.namespace>.<metric>``). Spans past `max_spans` are
    dropped (counted on `dropped`) so long runs stay bounded.
    """

    enabled = True

    def __init__(self, max_spans: int = 200_000, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.max_spans = int(max_spans)
        self.spans: List[Dict[str, Any]] = []
        self.dropped = 0
        self._stack: List[int] = []
        self._seq = 0
        self._watched: List[MetricsRegistry] = []

    def watch(self, registry: MetricsRegistry) -> None:
        """Delta this registry's counters on ``delta=True`` spans."""
        if registry not in self._watched:
            self._watched.append(registry)

    def span(self, name: str, delta: bool = False, **attrs) -> _SpanCtx:
        """Open a span; use as ``with tracer.span("waterfill"): ...``."""
        return _SpanCtx(self, name, delta, attrs)

    def _record(self, row: Dict[str, Any]) -> None:
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return
        self.spans.append(row)

    def reset(self) -> None:
        """Drop all recorded spans (watched registries are kept)."""
        self.spans.clear()
        self._stack.clear()
        self.dropped = 0
        self._seq = 0
        self._t0 = self._clock()

    # -- rollups ------------------------------------------------------
    def by_stage(self) -> Dict[str, Dict[str, Any]]:
        """Aggregate spans by name: count, total/mean wall seconds, and
        the summed counter deltas — the "where does a tick go" table."""
        out: Dict[str, Dict[str, Any]] = {}
        for row in self.spans:
            agg = out.setdefault(row["name"],
                                 {"count": 0, "total_s": 0.0, "delta": {}})
            agg["count"] += 1
            agg["total_s"] += row["dur_s"]
            for k, v in row.get("delta", {}).items():
                agg["delta"][k] = agg["delta"].get(k, 0) + v
        for agg in out.values():
            agg["mean_s"] = agg["total_s"] / agg["count"]
            if not agg["delta"]:
                del agg["delta"]
        return out
