"""Chaos harness — graceful ladder vs naive-crash ablation, scored.

For each chaos scenario the harness runs the SAME timeline twice:

  * ``mode="ladder"`` — ``faults="on"``: the graceful degradation
    ladder (retry, bounded staleness, quarantine, plan rollback, DC
    quarantine in the fleet arbiter);
  * ``mode="naive"``  — ``faults="off"``: the scripted fault events
    still build a plane, but an UNGRACEFUL one — injections apply raw
    and the first unhandled failure kills the run, exactly like a
    deployment with no fault handling.

Every run is scored on the same three axes (the JAX package's
``BENCH_faults.json`` rows):

  * **crashed / error** — did the run die, and with what? The ladder
    must never crash; several naive scenarios must.
  * **MTTR** — mean steps from each fault injection to the floor
    recovering to 90% of its pre-fault median (the obs
    responsiveness SLE, :func:`repro_torch.obs.sle.fault_sle`). A crashed
    run's floor is padded with zeros to the scenario length, so its
    MTTR is censored at run end — a crash never "recovers".
  * **degraded-mode min-BW floor** — the worst per-step floor over
    the evaluation window, excluding steps where progress was
    impossible for any controller (a blacked-out ring hop). A crashed
    run's padded zeros land here as a 0.0 floor.

The floor series is collected through the engines' ``step_hook`` so
it survives a mid-run crash: every step that completed before the
death still counts.

Port of `repro/faults/harness.py`, with one argument more: `device`.
None (the default) means the card — every fill of every run is one
`waterfill` launch (``waterfill_backend="cuda"`` in the spec's
simulator), and the fleet's forest is one `rf_predict` launch a tick;
the device is resolved before any run, so without a card the harness
raises instead of recording a crash. ``device="cpu"`` runs the numpy
fill and the forest's plain version: the JAX package's run, equal to
it row for row.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.faults.scenarios import CHAOS_SCENARIOS, get_chaos_scenario
from repro_torch.fleet.scenario import FleetEngine
from repro_torch.obs.sle import fault_sle
from repro_torch.scenarios.engine import ScenarioEngine


def run_chaos(name: str, seed: int = 3, graceful: bool = True,
              device: Optional[Union[str, torch.device]] = None
              ) -> Dict[str, Any]:
    """Run one chaos scenario end to end and score it (`device`: None =
    the card's fill and forest, ``"cpu"`` = numpy fill, plain forest).

    Returns ``{scenario, mode, crashed, error, steps_completed,
    mttr_steps, degraded_min_bw, injected, rollbacks, retry_usd}``.
    """
    dev = resolve_device(device)
    chaos = get_chaos_scenario(name)
    chaos.spec.sim_kwargs["waterfill_backend"] = \
        "cuda" if dev.type == "cuda" else "numpy"
    mode = "on" if graceful else "off"
    floor: List[float] = []
    if chaos.fleet:
        eng: Any = FleetEngine(chaos.spec, seed=seed, faults=mode,
                               device=dev)

        def hook(_eng, row):
            floor.append(min((r["achieved_min"] for r in row.jobs),
                             default=0.0))
    else:
        eng = ScenarioEngine(chaos.spec, seed=seed, faults=mode)

        def hook(_eng, row):
            floor.append(float(row.achieved_min))
    eng.step_hook = hook
    crashed, error = False, None
    try:
        eng.run()
    except Exception as exc:                # noqa: BLE001 — the naive
        # ablation dies by DESIGN; the harness's job is to record how
        crashed, error = True, f"{type(exc).__name__}: {exc}"
    completed = len(floor)
    # a crashed run made zero progress from its death onward: pad the
    # floor with zeros so MTTR/degraded-floor score the crash honestly
    padded = floor + [0.0] * (chaos.spec.steps - completed)
    sle = fault_sle(padded, chaos.fault_steps,
                    dead_steps=chaos.dead_steps)
    plane = eng.faults
    injected = 0
    if plane is not None:
        injected = int(sum(v for k, v in plane.metrics.counters().items()
                           if k.startswith("injected")))
    return {
        "scenario": name,
        "mode": "ladder" if graceful else "naive",
        "crashed": crashed,
        "error": error,
        "steps_completed": completed,
        "steps_total": int(chaos.spec.steps),
        "mttr_steps": sle["mttr_steps"],
        "degraded_min_bw": sle["degraded_min_bw"],
        "injected": injected,
        "rollbacks": plane.rollbacks if plane is not None else 0,
        "retry_usd": round(plane.retry_usd, 6) if plane is not None
        else 0.0,
    }


def chaos_report(names: Optional[Sequence[str]] = None, seed: int = 3,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Dict[str, Any]:
    """Run the whole chaos library in both modes and roll up.

    The summary block carries the headline comparisons the CI guard
    pins: the ladder's crash count (must be 0), the naive crash count
    (must be > 0 — the ablation is only meaningful if naive actually
    dies), and mean MTTR / worst degraded floor per mode."""
    names = list(names) if names is not None else list(CHAOS_SCENARIOS)
    rows = []
    for n in names:
        rows.append(run_chaos(n, seed=seed, graceful=True, device=device))
        rows.append(run_chaos(n, seed=seed, graceful=False, device=device))
    ladder = [r for r in rows if r["mode"] == "ladder"]
    naive = [r for r in rows if r["mode"] == "naive"]

    def _mean_mttr(rs):
        vals = [r["mttr_steps"] for r in rs if r["mttr_steps"] is not None]
        return round(sum(vals) / len(vals), 3) if vals else None

    summary = {
        "scenarios": len(names),
        "ladder_crashes": sum(r["crashed"] for r in ladder),
        "naive_crashes": sum(r["crashed"] for r in naive),
        "ladder_mean_mttr": _mean_mttr(ladder),
        "naive_mean_mttr": _mean_mttr(naive),
        "ladder_min_floor": round(min(r["degraded_min_bw"]
                                      for r in ladder), 6),
        "naive_min_floor": round(min(r["degraded_min_bw"]
                                     for r in naive), 6),
    }
    return {"seed": seed, "runs": rows, "summary": summary}
