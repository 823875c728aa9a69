"""Unified observability plane: metrics, spans, SLE rollups, export
(port of `repro.obs`).

The registry is always on (it is where the counters live); span
tracing is gated `REPRO_OBS=off|on` (off default) and is passive either
way — every trace golden replays byte-identical with obs on. The run
documents (`export_run`, `export_scenario`) are the JAX package's
schema; `python -m repro_torch.obs.cli` runs, summarizes, diffs and
checks them.
"""
from repro_torch.obs.export import (OBS_SCHEMA, check_run, diff_runs,
                                    export_run, export_scenario, flatten,
                                    load, render_dryrun_summary,
                                    render_dryrun_table, summarize, to_json,
                                    write_json, write_spans_jsonl)
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, Series)
from repro_torch.obs.sle import (SLE_BAND, accuracy_sle, capacity_sle,
                                 fault_sle, fleet_monitoring_usd, fleet_sle,
                                 jain_index, responsiveness_steps,
                                 scenario_monitoring_usd, scenario_sle)
from repro_torch.obs.spans import (NULL_TRACER, OBS_MODES, NullTracer,
                                   SpanTracer, obs_mode)

__all__ = [
    "OBS_SCHEMA", "OBS_MODES", "SLE_BAND", "NULL_TRACER",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Series",
    "NullTracer", "SpanTracer", "obs_mode",
    "accuracy_sle", "capacity_sle", "fault_sle", "jain_index",
    "responsiveness_steps", "scenario_monitoring_usd",
    "fleet_monitoring_usd", "scenario_sle", "fleet_sle",
    "export_run", "export_scenario", "to_json", "write_json",
    "write_spans_jsonl", "load", "flatten", "diff_runs", "check_run",
    "summarize", "render_dryrun_table", "render_dryrun_summary",
]
