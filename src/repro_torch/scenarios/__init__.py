"""repro_torch.scenarios — scripted WAN dynamics + deterministic replay.

A scenario is a timeline of WAN events (`events.py` DSL) driven
through the full closed loop by `engine.py`; `library.py` names the
12 timelines reproducing the paper's §5 settings, and `trace.py`
defines the per-step trace whose canonical JSON is byte-identical
across same-seed replays (and to the JAX package's: `goldens.py`
hashes the port's runs under the pin keys of
`tests/data/trace_golden.json`). Port of `repro/scenarios`.
"""
from repro_torch.scenarios.engine import (ScenarioEngine, ScenarioSpec,
                                          run_scenario)
from repro_torch.scenarios.events import (CrossTraffic, DiurnalCycle,
                                          JobArrive, JobDepart, LinkDegrade,
                                          LinkRestore, PriorityShift,
                                          ProviderShift, Rescale, SkewRamp,
                                          Straggler, at, flap)
from repro_torch.scenarios.library import (SCENARIOS, get_scenario,
                                           scenario_names)
from repro_torch.scenarios.trace import (ScenarioResult, ScenarioTrace,
                                         StepTrace, sig_hash)

__all__ = [
    "ScenarioEngine", "ScenarioSpec", "run_scenario",
    "ScenarioResult", "ScenarioTrace", "StepTrace", "sig_hash",
    "SCENARIOS", "get_scenario", "scenario_names",
    "at", "flap", "LinkDegrade", "LinkRestore", "CrossTraffic",
    "DiurnalCycle", "Rescale", "ProviderShift", "SkewRamp", "Straggler",
    "JobArrive", "JobDepart", "PriorityShift",
]
