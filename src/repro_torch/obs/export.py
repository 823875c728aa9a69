"""Canonical export, diff, check, and human-readable reporting.

One run's observability — metric registries, span rollups, SLE health
— exports as ONE canonical JSON document (`obs_schema` versioned,
sorted keys), which `python -m repro_torch.obs.cli` summarizes,
diffs against another run, and gates. The renderers here are the
single human-readable report path: :func:`summarize` also understands
the repo's `BENCH_<name>.json` trajectory documents and dry-run cell
lists (through :func:`render_dryrun_table`), so there is one report
implementation, not two drifting ones.

Port of `repro/obs/export.py`: `OBS_SCHEMA` and `SLE_KEYS` are the JAX
package's, so a run document of either package reads in the other's
tools, and the port's documents equal the reference's but for the
spans' wall times.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.spans import SpanTracer

OBS_SCHEMA = 1

SLE_KEYS = ("accuracy", "capacity", "fairness", "responsiveness_steps",
            "monitoring_usd")
# SLE ratios live in [0, 1]; the rest only need to be non-negative
_RATIO_KEYS = ("accuracy", "capacity", "fairness")


# ----------------------------------------------------------------------
# Building and writing the canonical document
# ----------------------------------------------------------------------
def export_run(name: str, *, seed: Optional[int] = None,
               registries: Iterable[MetricsRegistry] = (),
               tracer: Optional[SpanTracer] = None,
               sle: Optional[Dict[str, Any]] = None,
               summary: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble the canonical run document from the live objects."""
    metrics: Dict[str, Any] = {}
    for i, reg in enumerate(registries):
        key = reg.namespace or f"reg{i}"
        while key in metrics:                      # two sims, two jobs...
            key += "'"
        metrics[key] = reg.snapshot()
    doc: Dict[str, Any] = {
        "obs_schema": OBS_SCHEMA, "kind": "run", "name": name,
        "seed": seed, "metrics": metrics,
    }
    if tracer is not None and getattr(tracer, "enabled", False):
        doc["spans"] = {"count": len(tracer.spans),
                        "dropped": tracer.dropped,
                        "stages": tracer.by_stage()}
    if sle is not None:
        doc["sle"] = sle
    if summary is not None:
        doc["summary"] = summary
    return doc


def export_scenario(result, engine, name: Optional[str] = None
                    ) -> Dict[str, Any]:
    """Convenience: the run document for one completed
    :class:`repro_torch.scenarios.ScenarioEngine` run — gathers the engine's
    registries (simulator, controller, lifecycle if attached), its
    tracer, the trace summary, and the scenario SLE block."""
    from repro_torch.obs.sle import scenario_sle
    regs = [engine.sim.metrics, engine.controller.metrics]
    if engine.lifecycle is not None:
        regs += [engine.lifecycle.metrics,
                 engine.lifecycle.scheduler.metrics]
    return export_run(
        name or result.trace.scenario, seed=result.trace.seed,
        registries=regs, tracer=getattr(engine, "tracer", None),
        sle=scenario_sle(result.trace, n_dcs=engine.sim.N),
        summary=result.summary())


def to_json(doc: Mapping[str, Any]) -> str:
    """Canonical serialization: sorted keys, stable separators."""
    return json.dumps(doc, sort_keys=True, indent=2) + "\n"


def write_json(doc: Mapping[str, Any], path: str) -> str:
    """Write the canonical document; returns `path`."""
    with open(path, "w") as f:
        f.write(to_json(doc))
    return path


def write_spans_jsonl(tracer: SpanTracer, path: str) -> str:
    """One span per line (completion order), for external tooling."""
    with open(path, "w") as f:
        for row in tracer.spans:
            f.write(json.dumps(row, sort_keys=True,
                               separators=(",", ":")) + "\n")
    return path


def load(path: str) -> Any:
    """Read back any JSON document this plane (or a bench) wrote."""
    with open(path) as f:
        return json.load(f)


# ----------------------------------------------------------------------
# Diff and check (the obsctl gates)
# ----------------------------------------------------------------------
def flatten(doc: Any, prefix: str = "") -> Dict[str, float]:
    """All numeric leaves of a nested document as {dotted.path: value}
    (bools excluded; list elements are indexed)."""
    out: Dict[str, float] = {}
    if isinstance(doc, bool) or doc is None:
        return out
    if isinstance(doc, (int, float)):
        out[prefix or "value"] = float(doc)
    elif isinstance(doc, Mapping):
        for k in doc:
            out.update(flatten(doc[k], f"{prefix}.{k}" if prefix else k))
    elif isinstance(doc, (list, tuple)):
        for i, v in enumerate(doc):
            out.update(flatten(v, f"{prefix}[{i}]"))
    return out


def diff_runs(a: Any, b: Any) -> Dict[str, Dict[str, Any]]:
    """Numeric-leaf diff of two documents: {path: {a, b, rel}} for
    every changed leaf plus entries present on only one side."""
    fa, fb = flatten(a), flatten(b)
    out: Dict[str, Dict[str, Any]] = {}
    for k in sorted(set(fa) | set(fb)):
        va, vb = fa.get(k), fb.get(k)
        if va == vb:
            continue
        row: Dict[str, Any] = {"a": va, "b": vb}
        if va is not None and vb is not None and va != 0:
            row["rel"] = (vb - va) / abs(va)
        out[k] = row
    return out


def check_run(doc: Any, min_accuracy: Optional[float] = None,
              min_capacity: Optional[float] = None,
              min_fairness: Optional[float] = None,
              max_usd: Optional[float] = None) -> List[str]:
    """Validate a run document's schema and SLE floors; returns the
    list of problems (empty = pass)."""
    problems: List[str] = []
    if not isinstance(doc, Mapping):
        return [f"not a JSON object: {type(doc).__name__}"]
    if doc.get("obs_schema") != OBS_SCHEMA:
        problems.append(f"obs_schema != {OBS_SCHEMA}: "
                        f"{doc.get('obs_schema')!r}")
    if doc.get("kind") != "run":
        problems.append(f"kind != 'run': {doc.get('kind')!r}")
    if not doc.get("name"):
        problems.append("missing run name")
    if not isinstance(doc.get("metrics"), Mapping):
        problems.append("missing metrics block")
    sle = doc.get("sle")
    if not isinstance(sle, Mapping):
        problems.append("missing sle block")
        return problems
    for key in SLE_KEYS:
        if key not in sle:
            problems.append(f"sle missing {key!r}")
    for key in _RATIO_KEYS:
        v = sle.get(key)
        if v is not None and not (isinstance(v, (int, float))
                                  and 0.0 <= v <= 1.0):
            problems.append(f"sle.{key} not in [0, 1]: {v!r}")
    usd = sle.get("monitoring_usd")
    if not (isinstance(usd, (int, float)) and usd >= 0.0):
        problems.append(f"sle.monitoring_usd not >= 0: {usd!r}")
    floors = (("accuracy", min_accuracy, True),
              ("capacity", min_capacity, True),
              ("fairness", min_fairness, True),
              ("monitoring_usd", max_usd, False))
    for key, bound, is_floor in floors:
        if bound is None:
            continue
        v = sle.get(key)
        if v is None:
            problems.append(f"sle.{key} is null but a bound was set")
        elif is_floor and v < bound:
            problems.append(f"sle.{key} {v} < floor {bound}")
        elif not is_floor and v > bound:
            problems.append(f"sle.{key} {v} > ceiling {bound}")
    return problems


# ----------------------------------------------------------------------
# The one human-readable report
# ----------------------------------------------------------------------
def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _summarize_run(doc: Mapping[str, Any]) -> str:
    out = [f"run: {doc.get('name')} (seed {doc.get('seed')})"]
    sle = doc.get("sle")
    if sle:
        cells = "  ".join(f"{k}={_fmt(sle[k])}" for k in SLE_KEYS
                          if k in sle)
        out.append(f"  sle: {cells}")
    summary = doc.get("summary")
    if summary:
        cells = "  ".join(f"{k}={_fmt(v)}" for k, v in sorted(
            summary.items()) if isinstance(v, (int, float)))
        out.append(f"  summary: {cells}")
    for ns in sorted(doc.get("metrics", {})):
        snap = doc["metrics"][ns]
        cells = []
        for name in sorted(snap):
            m = snap[name]
            if m.get("kind") in ("counter", "gauge"):
                cells.append(f"{name}={_fmt(m['value'])}")
            elif m.get("kind") == "histogram" and m.get("count"):
                cells.append(f"{name}: n={m['count']} "
                             f"mean={_fmt(m['sum'] / m['count'])}")
        if cells:
            out.append(f"  {ns}: " + "  ".join(cells))
    spans = doc.get("spans")
    if spans:
        out.append(f"  spans: {spans['count']} recorded "
                   f"({spans['dropped']} dropped)")
        stages = spans.get("stages", {})
        for name in sorted(stages, key=lambda n: -stages[n]["total_s"]):
            st = stages[name]
            line = (f"    {name:<12} x{st['count']:<5} "
                    f"total {st['total_s'] * 1e3:8.2f} ms  "
                    f"mean {st['mean_s'] * 1e6:8.1f} us")
            if st.get("delta"):
                line += "  " + " ".join(f"{k}+{_fmt(v)}" for k, v in
                                        sorted(st["delta"].items()))
            out.append(line)
    return "\n".join(out)


def _summarize_bench(doc: Mapping[str, Any]) -> str:
    out = [f"bench: {doc['bench']} (schema {doc.get('schema')}, "
           f"{len(doc['rows'])} rows)"]
    for row in doc["rows"]:
        cells = "  ".join(f"{k}={_fmt(v)}" for k, v in sorted(row.items())
                          if isinstance(v, (int, float))
                          and not isinstance(v, bool))
        out.append(f"  - {cells}")
        sle = row.get("sle")
        if isinstance(sle, Mapping):
            cells = "  ".join(f"{k}={_fmt(sle[k])}" for k in SLE_KEYS
                              if sle.get(k) is not None)
            out.append(f"      sle: {cells}")
    return "\n".join(out)


def summarize(doc: Any) -> str:
    """Render ANY of the repo's JSON observability documents — an obs
    run export, a `BENCH_<name>.json` trajectory document, or a dryrun
    cell list — through the one canonical report path."""
    if isinstance(doc, Mapping) and doc.get("kind") == "run":
        return _summarize_run(doc)
    if isinstance(doc, Mapping) and "bench" in doc and "rows" in doc:
        return _summarize_bench(doc)
    if isinstance(doc, list) and doc and isinstance(doc[0], Mapping) \
            and "status" in doc[0]:
        return render_dryrun_table(doc, "dryrun")
    return json.dumps(doc, indent=2, sort_keys=True)


# -- the EXPERIMENTS dry-run tables ------------------------------------
def _fmt_bytes(b: float) -> str:
    return f"{b / 2 ** 30:.2f}"


def render_dryrun_table(cells: List[Mapping[str, Any]], mesh: str) -> str:
    """The per-mesh dry-run/roofline markdown table."""
    out = [f"\n### {mesh}-pod mesh "
           f"({'2x16x16 (pod,data,model)' if mesh == 'multi' else '16x16 (data,model)'})\n",
           "| arch | shape | HBM/dev GiB | t_comp s | t_mem s | t_coll s"
           " | dominant | useful-FLOPs | roofline-frac | notes |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["status"] == "skipped":
            out.append(f"| {c['arch']} | {c['shape']} | — | — | — | — | — |"
                       f" — | — | SKIP: {c['reason'][:60]} |")
            continue
        if c["status"] == "error":
            out.append(f"| {c['arch']} | {c['shape']} | — | — | — | — | — |"
                       f" — | — | ERROR {c['error'][:60]} |")
            continue
        r = c["roofline"]
        note = "over 16GB HBM" if c["hbm_per_device"] > 16e9 else ""
        dci = f" dci={r['dci_bytes'] / 2 ** 30:.2f}GiB" \
            if r["dci_bytes"] else ""
        out.append(
            f"| {c['arch']} | {c['shape']} | {_fmt_bytes(c['hbm_per_device'])}"
            f" | {r['t_compute']:.2e} | {r['t_memory']:.2e}"
            f" | {r['t_collective']:.2e} | {r['dominant']}"
            f" | {r['useful_flops_ratio']:.2f}"
            f" | {r['roofline_fraction']:.3f} | {note}{dci} |")
    return "\n".join(out)


def render_dryrun_summary(cells_by_mesh: Mapping[str, List[Mapping[str, Any]]]
                          ) -> str:
    """The cross-mesh dry-run summary bullets."""
    rows = []
    for mesh, cells in cells_by_mesh.items():
        ok = [c for c in cells if c["status"] == "ok"]
        if not ok:
            continue
        doms: Dict[str, int] = {}
        for c in ok:
            doms[c["roofline"]["dominant"]] = \
                doms.get(c["roofline"]["dominant"], 0) + 1
        worst = min(ok, key=lambda c: c["roofline"]["roofline_fraction"])
        coll = max(ok, key=lambda c: c["roofline"]["t_collective"] /
                   max(c["roofline"]["t_compute"] +
                       c["roofline"]["t_memory"], 1e-12))
        rows.append(f"- **{mesh}**: {len(ok)} ok / "
                    f"{sum(c['status'] == 'skipped' for c in cells)} skipped; "
                    f"dominant terms: {doms}; worst roofline fraction "
                    f"{worst['roofline']['roofline_fraction']:.3f} "
                    f"({worst['arch']}x{worst['shape']}); most "
                    f"collective-bound: {coll['arch']}x{coll['shape']}")
    return "\n".join(rows)
