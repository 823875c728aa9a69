"""MetricsRegistry — deterministic process-local metrics primitives.

The paper dedicates an axis to WAN monitoring *cost* (§1, Eq. 1), yet
until this plane existed the repo's own runtime was observed only
through scattered ad-hoc counters (`WanSimulator.fill_calls`,
`BatchedRfPredictor.kernel_calls`, ...).
The registry gives every subsystem the same four primitives:

  * :class:`Counter`   — monotone accumulator (ints or Eq. 1 dollars);
  * :class:`Gauge`     — last-write-wins scalar (e.g. the most recent
    fill's iteration count);
  * :class:`Histogram` — fixed-bucket distribution (bucket uppers are
    chosen at creation, never adapted, so two runs bucket identically);
  * :class:`Series`    — bounded labeled append log (label, value)
    for per-reason / per-stage breakdowns.

Determinism contract (the reason obs can stay ON under the trace
goldens): the registry draws NO randomness, reads NO wall clock, and
recording or reading a metric never feeds back into any control
decision. Recorded *values* are exactly what callers pass. Reads are
pure: `snapshot()` / `counters()` build fresh dicts and never mutate
metric state (pinned by a hypothesis property in tests/test_obs.py).

Metric names within one registry are unique per kind; `labels=` folds
a label mapping into the name canonically (sorted keys), so
``counter("replans", labels={"reason": "periodic"})`` is the metric
``replans{reason=periodic}`` every run.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple


def _label_name(name: str, labels: Optional[Mapping[str, str]]) -> str:
    """Canonical metric key: ``name{k1=v1,k2=v2}`` with sorted keys."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone accumulator; `inc` only on the hot path (`reset` zeroes
    it between a harness's phases)."""

    __slots__ = ("name", "help", "_value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value: float = 0

    def inc(self, n: float = 1) -> None:
        """Add `n` (must be >= 0 — counters never go backwards)."""
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc({n}))")
        self._value += n

    def reset(self, value: float = 0) -> None:
        """Set the tally outright (a harness zeroing it between phases)."""
        self._value = value

    @property
    def value(self) -> float:
        """Current cumulative value (int-valued unless floats added)."""
        return self._value

    def to_dict(self) -> Dict[str, Any]:
        """Export form: {"kind", "value"}."""
        return {"kind": self.kind, "value": self._value}


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "help", "_value")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value: float = 0

    def set(self, value: float) -> None:
        """Record the current level."""
        self._value = value

    @property
    def value(self) -> float:
        """Most recently set value."""
        return self._value

    def to_dict(self) -> Dict[str, Any]:
        """Export form: {"kind", "value"}."""
        return {"kind": self.kind, "value": self._value}


class Histogram:
    """Fixed-bucket distribution: bucket uppers are pinned at creation
    (no adaptive resizing — two runs bucket identically), with a +inf
    overflow bucket appended implicitly."""

    __slots__ = ("name", "help", "buckets", "counts", "_sum", "_count")
    kind = "histogram"

    def __init__(self, name: str, buckets: Sequence[float], help: str = ""):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"histogram {name!r} buckets must be a "
                             f"non-empty strictly increasing sequence")
        self.name = name
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self.counts: List[int] = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        """Record one sample into its bucket (last bucket = overflow)."""
        self.counts[bisect_left(self.buckets, value)] += 1
        self._sum += value
        self._count += 1

    @property
    def count(self) -> int:
        """Total samples observed."""
        return self._count

    @property
    def sum(self) -> float:
        """Sum of all observed samples."""
        return self._sum

    @property
    def mean(self) -> float:
        """Mean observed sample (0.0 before any observation)."""
        return self._sum / self._count if self._count else 0.0

    def to_dict(self) -> Dict[str, Any]:
        """Export form: {"kind", "buckets", "counts", "sum", "count"}."""
        return {"kind": self.kind, "buckets": list(self.buckets),
                "counts": list(self.counts), "sum": self._sum,
                "count": self._count}


class Series:
    """Bounded labeled append log: `record(value, label=...)` keeps the
    LAST `cap` points as (label, value) pairs — per-reason replan logs,
    per-stage tallies — without unbounded growth on long runs."""

    __slots__ = ("name", "help", "cap", "points", "dropped")
    kind = "series"

    def __init__(self, name: str, cap: int = 4096, help: str = ""):
        self.name = name
        self.help = help
        self.cap = int(cap)
        self.points: List[Tuple[str, float]] = []
        self.dropped = 0

    def record(self, value: float, label: str = "") -> None:
        """Append one labeled point (oldest points drop past `cap`)."""
        self.points.append((label, value))
        if len(self.points) > self.cap:
            del self.points[0]
            self.dropped += 1

    def __len__(self) -> int:
        return len(self.points)

    def by_label(self) -> Dict[str, int]:
        """Count of retained points per label (deterministic order)."""
        out: Dict[str, int] = {}
        for label, _ in self.points:
            out[label] = out.get(label, 0) + 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        """Export form: {"kind", "n", "dropped", "by_label"}."""
        return {"kind": self.kind, "n": len(self.points),
                "dropped": self.dropped, "by_label": self.by_label()}


class MetricsRegistry:
    """One namespace of metrics, owned by one subsystem object.

    Get-or-create accessors (`counter` / `gauge` / `histogram` /
    `series`) are idempotent per (name, kind); asking for an existing
    name as a different kind raises — a name means one thing.
    """

    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self._metrics: Dict[str, Any] = {}

    # -- get-or-create accessors --------------------------------------
    def _get(self, cls, name: str, labels: Optional[Mapping[str, str]],
             **kwargs):
        key = _label_name(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = cls(key, **kwargs)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {key!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str,
                labels: Optional[Mapping[str, str]] = None,
                help: str = "") -> Counter:
        """Get-or-create a :class:`Counter`."""
        return self._get(Counter, name, labels, help=help)

    def gauge(self, name: str,
              labels: Optional[Mapping[str, str]] = None,
              help: str = "") -> Gauge:
        """Get-or-create a :class:`Gauge`."""
        return self._get(Gauge, name, labels, help=help)

    def histogram(self, name: str, buckets: Sequence[float],
                  labels: Optional[Mapping[str, str]] = None,
                  help: str = "") -> Histogram:
        """Get-or-create a :class:`Histogram` (buckets fixed at first
        creation; later calls ignore the argument)."""
        return self._get(Histogram, name, labels, buckets=buckets,
                         help=help)

    def series(self, name: str, cap: int = 4096,
               labels: Optional[Mapping[str, str]] = None,
               help: str = "") -> Series:
        """Get-or-create a :class:`Series`."""
        return self._get(Series, name, labels, cap=cap, help=help)

    # -- pure reads ---------------------------------------------------
    def names(self) -> List[str]:
        """Registered metric keys, insertion-ordered."""
        return list(self._metrics)

    def get(self, name: str) -> Any:
        """The metric object under `name` (KeyError if absent)."""
        return self._metrics[name]

    def counters(self) -> Dict[str, float]:
        """{name: value} over counters AND gauges only — the cheap
        snapshot the span tracer deltas against."""
        return {k: m.value for k, m in self._metrics.items()
                if isinstance(m, (Counter, Gauge))}

    def snapshot(self) -> Dict[str, Any]:
        """Full export: {name: to_dict()} for every metric, sorted by
        name so two identical runs serialize identically."""
        return {k: self._metrics[k].to_dict()
                for k in sorted(self._metrics)}
