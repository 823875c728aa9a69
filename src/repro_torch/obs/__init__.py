"""Observability: the metrics registry and gated span tracing (port of
`repro.obs`; SLE rollups and export are not yet ported)."""
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, Series)
from repro_torch.obs.spans import (NULL_TRACER, OBS_MODES, NullTracer,
                                   SpanTracer, obs_mode)

__all__ = [
    "OBS_MODES", "NULL_TRACER",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Series",
    "NullTracer", "SpanTracer", "obs_mode",
]
