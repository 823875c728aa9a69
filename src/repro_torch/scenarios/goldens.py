"""The trace pins the port replays: sha256 of each named run's
canonical ``to_json()``, under the keys of `tests/data/trace_golden.json`.

The port's counterpart of `tools/gen_trace_goldens.py`'s `_runners` /
`collect`, for all 19 keys: the 12 ``scenario/<name>/seed3``, the 4
``fleet/<name>/seed3`` and the 3 ``placement/...`` pins. It only
hashes: the pin file is the JAX package's, read here and never
written. The CPU tests and `chip_smoke.py` share it, the latter with
the fleet's forest on the card.

    from repro_torch.scenarios import goldens
    assert goldens.collect(device="cpu") == goldens.pinned()

The gated planes' runs are pinned in `PLANE_PINS` below, beside the
port (the JAX package's pin file covers gates off only): each sha256
equals the reference's live run of the same key
(`tests/test_torch_overlay.py`, `tests/test_torch_lifecycle.py`).
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.fleet.scenario import (fleet_scenario_names,
                                        get_fleet_scenario,
                                        run_fleet_scenario)
from repro_torch.placement import (run_placement_scenario, scan_agg,
                                   two_stage_join)
from repro_torch.scenarios.engine import run_scenario
from repro_torch.scenarios.library import get_scenario, scenario_names

PIN_FILE = (Path(__file__).resolve().parents[3] / "tests" / "data"
            / "trace_golden.json")
PREFIXES = ("scenario/", "fleet/", "placement/")
SEED = 3

# sha256 of the gate-on runs' to_json(): `cable_cut_reroute` with the
# overlay on, and its placement run (`scan_agg(4)`, `wanify`) with the
# overlay off and on; each mode's trace of `run_lifecycle_comparison(
# "provider_shift_drift", seed=3, pre_steps=15)` under the host
# forest's numpy inference ("numpy") and under f32 tree-order inference
# ("f32": `rf_predict`'s plain version, its CUDA kernel and the
# reference's Pallas kernel agree to the bit)
PLANE_PINS: Dict[str, str] = {
    "overlay/cable_cut_reroute/on/seed3":
        "9fa4c63bfd895d0567dd584b06c1b8300d9c0d2089828aa119f6848557efde09",
    "placement/cable_cut_reroute/overlay_off/seed3":
        "b8e09cd3636ef1856f8ee4506d943ed76e07b57fb4cf67e2396ee1be660402a5",
    "placement/cable_cut_reroute/overlay_on/seed3":
        "265c61c32ebd088ee1478cde3d0cd81bb0005f8149459e799a358109d71c6e53",
    "lifecycle/provider_shift_drift/frozen/numpy/seed3":
        "a528657e8ccadcb0e68d996ded4d1746db03fa3036cf11060c51a2d6b1f8f983",
    "lifecycle/provider_shift_drift/lifecycle/numpy/seed3":
        "61fd4de6a22676bc5d74217a2ba8b40f4f5358f71fe5eb01ef3a36727a66d263",
    "lifecycle/provider_shift_drift/frozen/f32/seed3":
        "931200d3cfb6795c68fcdd4ccc4ceaa810dc62b3ca37af20702e5a1251272305",
    "lifecycle/provider_shift_drift/lifecycle/f32/seed3":
        "33388cba861bd02cb040e87be275bc8f10a8eea74166aa166404c67b597424dc",
}


def sha(text: str) -> str:
    """The pin of one trace: sha256 of its canonical JSON."""
    return hashlib.sha256(text.encode()).hexdigest()


def pinned() -> Dict[str, str]:
    """The pins of the port's keys, from the JAX package's pin file."""
    with open(PIN_FILE) as f:
        hashes = json.load(f)["hashes"]
    return {k: v for k, v in hashes.items() if k.startswith(PREFIXES)}


def runners(device: Optional[Union[str, torch.device]] = None
            ) -> Dict[str, Callable[[], str]]:
    """{pin key: zero-arg runner returning the trace json}, in the
    reference's key order (lazy: nothing runs until a runner is
    called). `device` places the fleet runs' forest (None = CUDA); span
    tracing follows $REPRO_OBS, as in the reference's runs."""
    out: Dict[str, Callable[[], str]] = {}
    for name in scenario_names():
        out[f"scenario/{name}/seed{SEED}"] = (
            lambda n=name: run_scenario(get_scenario(n),
                                        seed=SEED).trace.to_json())
    for name in fleet_scenario_names():
        out[f"fleet/{name}/seed{SEED}"] = (
            lambda n=name: run_fleet_scenario(
                get_fleet_scenario(n), seed=SEED,
                device=device).trace.to_json())
    for backend in ("wanify", "static"):
        out[f"placement/skew_ramp/{backend}/seed{SEED}"] = (
            lambda b=backend: run_placement_scenario(
                "skew_ramp", query=two_stage_join(4), seed=SEED,
                backend=b).trace.to_json())
    out["placement/runtime_fluctuation/wanify/seed5"] = (
        lambda: run_placement_scenario(
            "runtime_fluctuation", query=scan_agg(4),
            seed=5).trace.to_json())
    return out


def overlay_runners() -> Dict[str, Callable[[], str]]:
    """{key: runner} of `PLANE_PINS`' overlay and placement keys
    (lazy)."""
    out: Dict[str, Callable[[], str]] = {
        f"overlay/cable_cut_reroute/on/seed{SEED}": lambda: run_scenario(
            get_scenario("cable_cut_reroute"), seed=SEED,
            overlay="on").trace.to_json()}
    for mode in ("off", "on"):
        out[f"placement/cable_cut_reroute/overlay_{mode}/seed{SEED}"] = (
            lambda m=mode: run_placement_scenario(
                "cable_cut_reroute", seed=SEED, overlay=m).trace.to_json())
    return out


def lifecycle_key(mode: str, inference: str) -> str:
    """The `PLANE_PINS` key of one mode ("frozen" / "lifecycle") of
    the lifecycle comparison under `inference` ("numpy" / "f32")."""
    return f"lifecycle/provider_shift_drift/{mode}/{inference}/seed{SEED}"


def collect(device: Optional[Union[str, torch.device]] = None
            ) -> Dict[str, str]:
    """Run every pinned trace and return {key: sha256 of its json}."""
    return {k: sha(run()) for k, run in runners(device).items()}
