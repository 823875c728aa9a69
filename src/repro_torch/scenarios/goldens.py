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


def collect(device: Optional[Union[str, torch.device]] = None
            ) -> Dict[str, str]:
    """Run every pinned trace and return {key: sha256 of its json}."""
    return {k: sha(run()) for k, run in runners(device).items()}
