"""Lifecycle evaluation harness: pretrain-from-live-traffic plus the
frozen-vs-lifecycle comparison the bench and the pin test share.

The deployment story being reproduced: a predictor is fit on harvest
from the workload's own pre-shift operation (accurate, by
construction, for the regime it watched), the provider then migrates
half the DCs to half the WAN capacity, and the question is what the
operator pays — a frozen predictor plus Tetrium's periodic full
probing, or the lifecycle layer that detects the drift from free
residuals, spends a few targeted probes, and refits.

Imports of :mod:`repro_torch.scenarios` stay inside the functions — the
scenario engine imports this package's manager module, and the lazy
import keeps the package graph acyclic.

Port of `repro/lifecycle/harness.py`. The pretrained predictor is a
`BwPredictor` on `device` (None = CUDA, which raises without a card),
so every lifecycle observation and replan is one `rf_predict` launch
there; ``device="cpu"`` takes the kernel's plain version on the host.
Fits and their packed arrays are host numpy in both packages, so they
are the reference's to the bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.forest import RandomForest
from repro_torch.core.predictor import BwPredictor
from repro_torch.lifecycle.manager import LifecycleConfig, LifecycleManager
from repro_torch.lifecycle.probes import baseline_probe_spend


def harvest_scenario_rows(spec: Any, seed: int = 0,
                          steps: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Run `spec` for its first `steps` steps (default: all) with the
    snapshot-ablation predictor and lifecycle off, harvesting one
    (Table-3 features, achieved BW) row set per tick via a shadow
    manager — the live-traffic training set a deployed predictor
    starts from. Returns (X [rows, 6], y [rows])."""
    from repro_torch.scenarios.engine import ScenarioEngine
    run_spec = spec if steps is None \
        else dataclasses.replace(spec, steps=int(steps))
    eng = ScenarioEngine(run_spec, seed=seed)
    n = eng.sim.N
    cap = max(1, run_spec.steps) * n * (n - 1)
    mgr = LifecycleManager(eng.controller.predictor, n, active=False,
                           cfg=LifecycleConfig(window_rows=cap))
    eng.lifecycle = mgr
    eng.run()
    return mgr.window.rows()


def pretrain_predictor(spec: Any, seed: int = 0, pre_steps: int = 15,
                       n_trees: int = 12, depth: int = 8,
                       min_leaf: int = 4, forest_seed: int = 0,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Tuple[BwPredictor, np.ndarray, np.ndarray]:
    """A :class:`BwPredictor` fit on the scenario's own pre-event
    operation (steps [0, pre_steps)) — deterministic: the same (spec,
    seed, hyperparameters) always yields bit-identical packed tensors.
    `min_leaf` > 1 matters under noisy snapshots: leaves average
    several observations instead of memorizing one noise draw.
    Returns (predictor, seed_X, seed_y); the rows double as the
    refresh layer's decaying seed set. The predictor runs on
    `device`."""
    X, y = harvest_scenario_rows(spec, seed=seed, steps=pre_steps)
    rf = RandomForest(n_trees=n_trees, depth=depth, min_leaf=min_leaf,
                      seed=forest_seed).fit(X, y)
    return BwPredictor(forest=rf, device=device), X, y


def run_lifecycle_comparison(scenario: str = "provider_shift_drift",
                             seed: int = 3, pre_steps: int = 15,
                             cfg: Optional[LifecycleConfig] = None,
                             device: Optional[Union[str, torch.device]]
                             = None) -> Dict[str, Any]:
    """Run `scenario` twice from the same pretrained predictor — once
    frozen (shadow manager: observe + account only), once with the
    full lifecycle — and return the comparison the headline pin
    asserts on:

      * per-step ``resid`` accuracy series (un-gated EWMA of mean
        |relative residual|) for both modes;
      * ``monitor_usd`` per mode, the frozen side priced as snapshots
        plus Tetrium's 30-simulated-minute full-probe cadence, the
        lifecycle side as snapshots plus its drift-gated probes;
      * the lifecycle run's refresh/probe/signal telemetry.

    Each mode's pretrained predictor runs on `device` (see
    :func:`pretrain_predictor`).
    """
    from repro_torch.scenarios.engine import ScenarioEngine
    from repro_torch.scenarios.library import get_scenario

    out: Dict[str, Any] = {"scenario": scenario, "seed": int(seed),
                           "pre_steps": int(pre_steps)}
    modes: Dict[str, Dict[str, Any]] = {}
    for mode in ("frozen", "lifecycle"):
        spec = get_scenario(scenario)
        # an independently pretrained (bit-identical) predictor per
        # run: the lifecycle run's refresh must not leak into frozen
        predictor, sX, sy = pretrain_predictor(
            spec, seed=seed, pre_steps=pre_steps, device=device)
        mgr = LifecycleManager(predictor, len(spec.regions)
                               if spec.regions else 8,
                               seed_X=sX, seed_y=sy, cfg=cfg,
                               active=(mode == "lifecycle"))
        eng = ScenarioEngine(spec, seed=seed, predictor=predictor,
                             lifecycle=mgr)
        result = eng.run()
        usd = mgr.scheduler.spend_usd
        if mode == "frozen":
            usd += baseline_probe_spend(spec.steps, eng.sim.N,
                                        mgr.cfg.probes)
        modes[mode] = {
            "resid": [r.resid_ewma for r in mgr.records],
            "monitor_usd": float(usd),
            "full_probes": mgr.scheduler.full_probes,
            "snapshots": mgr.scheduler.snapshots,
            "refreshes": mgr.refreshes,
            "refresh_steps": [r.step for r in mgr.records if r.refreshed],
            "signal_steps": sorted({s.step for s in mgr.signals}),
            "steps": spec.steps,
            "trace_sha": hashlib.sha256(
                result.trace.to_json().encode()).hexdigest(),
        }
    out["modes"] = modes
    return out
