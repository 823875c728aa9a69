"""The port's SLE rollups, run export and obs CLI against the JAX
reference.

* The SLE functions (`jain_index`, `capacity_sle`,
  `responsiveness_steps`, `accuracy_sle`, `fault_sle`, the Eq. 1
  monitoring meters, `scenario_sle` / `fleet_sle`) on seeded vectors
  and on the traces of the 12 library scenarios and the 4 fleet
  scenarios at seed 3, each package on its own run (the traces are
  byte-equal: the 16 pins) and the port's functions also on the
  reference's trace.
* `export_scenario` documents equal to the reference's less the spans'
  wall times (`total_s`, `mean_s`), obs on and off, with the lifecycle
  and the fault plane attached.
* `check_run`, `flatten` / `diff_runs`, `summarize` and the dry-run
  renderers on the same inputs in both packages.
* `python -m repro_torch.obs.cli` end to end with ``--device cpu``,
  against `tools/obsctl.py`: the same documents, output and exit codes.

The reference fleet imports `jax.experimental.enable_x64`, which jax
0.9 dropped; the `ref` fixture installs a stand-in only when it is
missing (as `tests/test_torch_fleet.py` does).
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.faults.scenarios import get_chaos_scenario
from repro_torch.fleet import (fleet_scenario_names, get_fleet_scenario,
                               run_fleet_scenario)
from repro_torch.obs import cli
from repro_torch.scenarios import ScenarioEngine, get_scenario, scenario_names

ROOT = Path(__file__).resolve().parents[1]
SCENARIOS = scenario_names()
FLEETS = fleet_scenario_names()


@pytest.fixture(scope="module")
def ref():
    """The reference packages, as a namespace."""
    import jax
    import jax.experimental
    shim = not hasattr(jax.experimental, "enable_x64")
    before = set(sys.modules)
    if shim:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    import repro.faults.scenarios
    import repro.fleet.scenario
    import repro.obs
    import repro.scenarios
    yield repro
    if shim:
        del jax.experimental.enable_x64
        for name in set(sys.modules) - before:
            if name == "repro" or name.startswith("repro."):
                del sys.modules[name]


def without_span_times(doc):
    """A document less the spans' wall times."""
    doc = json.loads(json.dumps(doc))
    for st in doc.get("spans", {}).get("stages", {}).values():
        st.pop("total_s", None)
        st.pop("mean_s", None)
    return doc


# ----------------------------------------------------------------------
# the SLE functions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_sle_primitives_equal_reference(ref, seed):
    """Jain, capacity and responsiveness on seeded floors with sags,
    zeros and events, including the empty and censored cases."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 40))
    floor = rng.uniform(0.0, 200.0, n)
    floor[rng.random(n) < 0.2] = 0.0
    events = sorted(set(rng.integers(0, max(n, 1), int(rng.integers(0, 4)))
                        .tolist())) if n else []
    R = ref.obs
    assert obs.jain_index(floor) == R.jain_index(floor)
    assert obs.capacity_sle(floor) == R.capacity_sle(floor)
    assert obs.capacity_sle(floor, q=50.0) == R.capacity_sle(floor, q=50.0)
    assert obs.responsiveness_steps(events, floor) == \
        R.responsiveness_steps(events, floor)
    assert obs.responsiveness_steps(events, floor, frac=0.5, window=2) == \
        R.responsiveness_steps(events, floor, frac=0.5, window=2)


@pytest.mark.parametrize("seed", range(6))
def test_fault_sle_equal_reference(ref, seed):
    """The chaos scoring block: MTTR and the degraded floor over the
    live steps, with dead steps excluded (all of them, once)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 40))
    floor = rng.uniform(0.0, 200.0, n).tolist()
    faults = sorted(set(rng.integers(1, n, 3).tolist()))
    dead = range(n) if seed == 5 else \
        tuple(range(faults[0], min(n, faults[0] + int(rng.integers(0, 6)))))
    got = obs.fault_sle(floor, faults, dead_steps=dead)
    assert got == ref.obs.fault_sle(floor, faults, dead_steps=dead)
    assert (got["degraded_min_bw"] == 0.0) == (seed == 5) or min(floor) == 0


@pytest.fixture(scope="module")
def traces(ref):
    """Each library scenario's and fleet scenario's trace at seed 3,
    run by each package ((port, reference) pairs)."""
    out = {}
    for name in SCENARIOS:
        out[name] = (ScenarioEngine(get_scenario(name), seed=3).run().trace,
                     ref.scenarios.ScenarioEngine(
                         ref.scenarios.get_scenario(name),
                         seed=3).run().trace)
    for name in FLEETS:
        out[name] = (run_fleet_scenario(get_fleet_scenario(name), seed=3,
                                        device="cpu").trace,
                     ref.fleet.scenario.run_fleet_scenario(
                         ref.fleet.scenario.get_fleet_scenario(name),
                         seed=3).trace)
    return out


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_sle_equal_reference(ref, traces, name):
    """`scenario_sle` and its parts on the scenario's trace, and
    `fault_sle` on its floor keyed on its event steps."""
    got, want = traces[name]
    assert got.to_json() == want.to_json()
    R = ref.obs
    assert obs.scenario_sle(got) == R.scenario_sle(want)
    assert obs.scenario_sle(want, n_dcs=4, band=0.1) == \
        R.scenario_sle(want, n_dcs=4, band=0.1)
    assert obs.accuracy_sle(got, band=0.05) == R.accuracy_sle(want, 0.05)
    assert obs.scenario_monitoring_usd(got, 8) == \
        R.scenario_monitoring_usd(want, 8)
    floor = [s.achieved_min for s in got.steps]
    events = [s.step for s in got.steps if s.events] or [1]
    assert obs.fault_sle(floor, events, dead_steps=events[:1]) == \
        R.fault_sle(floor, events, dead_steps=events[:1])


@pytest.mark.parametrize("name", FLEETS)
def test_fleet_sle_equal_reference(ref, traces, name):
    """`fleet_sle` and the fleet's monitoring meter on the fleet
    scenario's trace."""
    got, want = traces[name]
    assert got.to_json() == want.to_json()
    sle = obs.fleet_sle(got)
    assert sle == ref.obs.fleet_sle(want) and sle["accuracy"] is None
    assert obs.fleet_sle(want, n_dcs=6) == ref.obs.fleet_sle(want, n_dcs=6)
    assert obs.fleet_monitoring_usd(got, 8) == \
        ref.obs.fleet_monitoring_usd(want, 8)


# ----------------------------------------------------------------------
# export
# ----------------------------------------------------------------------
EXPORTS = [("steady", {"obs": "on"}), ("steady", {"obs": "off"}),
           ("congestion", {"obs": "on"}),
           ("link_flap", {"obs": "on", "lifecycle": "on"}),
           ("cable_cut_reroute", {"obs": "on", "overlay": "on"}),
           ("chaos:monitor_freeze", {"obs": "on", "faults": "on"}),
           ("chaos:solver_flake", {"obs": "on", "faults": "on"})]


def _spec(pkg, name):
    if name.startswith("chaos:"):
        get = get_chaos_scenario if pkg is None else \
            pkg.faults.scenarios.get_chaos_scenario
        return get(name[6:]).spec
    return (get_scenario if pkg is None else pkg.scenarios.get_scenario)(name)


@pytest.mark.parametrize("name,kw", EXPORTS,
                         ids=[f"{n}-{'-'.join(f'{k}_{v}' for k, v in kw.items())}"
                              for n, kw in EXPORTS])
def test_export_scenario_equal_reference(ref, name, kw):
    """The canonical run document of one run, obs on or off, with the
    lifecycle's registries, the overlay, or the fault plane's counters
    in the span deltas: equal to the reference's less the spans' wall
    times, and clean under `check_run`."""
    eng = ScenarioEngine(_spec(None, name), seed=3, **kw)
    reng = ref.scenarios.ScenarioEngine(_spec(ref, name), seed=3, **kw)
    doc = obs.export_scenario(eng.run(), eng)
    rdoc = ref.obs.export_scenario(reng.run(), reng)
    assert obs.to_json(without_span_times(doc)) == \
        ref.obs.to_json(without_span_times(rdoc))
    assert ("spans" in doc) == (kw["obs"] == "on")
    assert obs.check_run(doc) == [] == ref.obs.check_run(rdoc)
    assert json.loads(obs.to_json(doc)) == doc
    if kw["obs"] == "on":
        assert doc["spans"]["count"] == len(eng.tracer.spans)
        assert set(doc["spans"]["stages"]) == set(rdoc["spans"]["stages"])


def test_export_run_namespace_collisions_equal_reference(ref):
    regs = []
    for pkg in (obs, ref.obs):
        a, b = pkg.MetricsRegistry("dup"), pkg.MetricsRegistry("dup")
        a.counter("x").inc()
        b.counter("x").inc(2)
        regs.append(pkg.export_run("r", seed=1, registries=[a, b],
                                   summary={"k": 1.5}))
    assert regs[0] == regs[1]
    assert sorted(m["x"]["value"] for m in regs[0]["metrics"].values()) \
        == [1, 2]


# ----------------------------------------------------------------------
# check, diff, summarize
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def run_doc():
    eng = ScenarioEngine(get_scenario("cable_cut"), seed=3, obs="on")
    return obs.export_scenario(eng.run(), eng)


def _bad_docs(doc):
    no_sle = {k: v for k, v in doc.items() if k != "sle"}
    ratio = json.loads(json.dumps(doc))
    ratio["sle"]["accuracy"] = 1.5
    usd = json.loads(json.dumps(doc))
    usd["sle"]["monitoring_usd"] = -1.0
    missing = json.loads(json.dumps(doc))
    del missing["sle"]["fairness"]
    return {"not_an_object": [1, 2], "wrong_kind": {"kind": "nope"},
            "no_sle": no_sle, "ratio": ratio, "usd": usd,
            "missing_key": missing,
            "no_name": {**doc, "name": ""}, "no_metrics": {**doc,
                                                           "metrics": 3}}


BAD = ["not_an_object", "wrong_kind", "no_sle", "ratio", "usd",
       "missing_key", "no_name", "no_metrics"]
BOUNDS = [{}, {"min_accuracy": 1.01}, {"max_usd": 0.0},
          {"min_accuracy": 0.0, "min_capacity": 0.1, "min_fairness": 0.1},
          {"min_fairness": 2.0, "max_usd": 1e9}]


@pytest.mark.parametrize("case", BAD)
def test_check_run_rejects_bad_documents_as_reference(ref, run_doc, case):
    doc = _bad_docs(run_doc)[case]
    got = obs.check_run(doc)
    assert got and got == ref.obs.check_run(doc)


@pytest.mark.parametrize("i", range(len(BOUNDS)))
def test_check_run_bounds_equal_reference(ref, run_doc, i):
    got = obs.check_run(run_doc, **BOUNDS[i])
    assert got == ref.obs.check_run(run_doc, **BOUNDS[i])
    assert (got == []) == (i in (0, 3))
    sle = {**run_doc["sle"], "accuracy": None}
    nulled = {**run_doc, "sle": sle}
    assert obs.check_run(nulled, **BOUNDS[i]) == \
        ref.obs.check_run(nulled, **BOUNDS[i])


def test_flatten_and_diff_runs_equal_reference(ref, run_doc):
    a = {"x": {"y": 1, "z": [1, 2]}, "s": "str", "b": True, "n": None}
    assert obs.flatten(a) == ref.obs.flatten(a) == \
        {"x.y": 1.0, "x.z[0]": 1.0, "x.z[1]": 2.0}
    other = json.loads(json.dumps(run_doc))
    other["sle"]["capacity"] *= 0.5
    other["metrics"]["sim"].pop("fill_calls")
    other["extra"] = {"v": 0}
    for x, y in ((run_doc, other), (other, run_doc), ({"v": 0}, {"v": 2}),
                 (run_doc, run_doc)):
        assert obs.diff_runs(x, y) == ref.obs.diff_runs(x, y)
    d = obs.diff_runs(run_doc, other)
    assert d["sle.capacity"]["rel"] == pytest.approx(-0.5)
    assert d["metrics.sim.fill_calls.value"]["b"] is None


def _dryrun_cells():
    roof = {"t_compute": 1.5e-3, "t_memory": 2.5e-3, "t_collective": 4e-4,
            "dominant": "memory", "useful_flops_ratio": 0.81,
            "roofline_fraction": 0.37, "dci_bytes": 2 ** 31}
    return [{"status": "ok", "arch": "mamba2-2.7b", "shape": "train",
             "hbm_per_device": 17e9, "roofline": roof},
            {"status": "ok", "arch": "llama3-8b", "shape": "serve",
             "hbm_per_device": 9e9,
             "roofline": {**roof, "dominant": "compute", "dci_bytes": 0,
                          "roofline_fraction": 0.12}},
            {"status": "skipped", "arch": "whisper-medium", "shape": "train",
             "reason": "encdec not on this mesh"},
            {"status": "error", "arch": "deepseek-v2", "shape": "serve",
             "error": "OOM while lowering"}]


def test_summarize_equal_reference(ref, run_doc):
    """Every kind of document: a run export, the repo's committed
    `BENCH_*.json`, a dry-run cell list, an unknown document."""
    docs = [run_doc, {**run_doc, "spans": None, "summary": None},
            _dryrun_cells(), {"weird": 1}, [1, 2]]
    for path in sorted(ROOT.glob("BENCH_*.json")):
        docs.append(json.loads(path.read_text()))
    for doc in docs:
        assert obs.summarize(doc) == ref.obs.summarize(doc)
    text = obs.summarize(run_doc)
    assert "cable_cut" in text and "sle:" in text and "waterfill" in text


def test_dryrun_renderers_equal_reference(ref):
    cells = _dryrun_cells()
    for mesh in ("single", "multi"):
        assert obs.render_dryrun_table(cells, mesh) == \
            ref.obs.render_dryrun_table(cells, mesh)
    by_mesh = {"single": cells, "multi": cells[1:], "none": cells[2:]}
    got = obs.render_dryrun_summary(by_mesh)
    assert got == ref.obs.render_dryrun_summary(by_mesh)
    assert "worst roofline fraction 0.120" in got


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def obsctl():
    """The JAX package's `tools/obsctl.py` (it imports no jax)."""
    spec = importlib.util.spec_from_file_location(
        "obsctl", ROOT / "tools" / "obsctl.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.obs.cli",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def test_obs_cli_end_to_end_on_the_host(tmp_path, obsctl, capsys):
    """`python -m repro_torch.obs.cli` with ``--device cpu``: `run`
    writes a document equal to `tools/obsctl.py run`'s less span wall
    times, and `summarize`, `check` and `diff` print and exit as
    obsctl does on the same files."""
    out, spans = tmp_path / "run.json", tmp_path / "spans.jsonl"
    r = _cli("run", "steady", "--seed", "3", "--device", "cpu", "-o",
             str(out), "--spans", str(spans))
    assert r.returncode == 0, r.stderr
    assert f"wrote {out}" in r.stderr
    rows = [json.loads(line) for line in spans.read_text().splitlines()]
    assert rows and {"sid", "name", "dur_s"} <= set(rows[0])
    ref_out = tmp_path / "ref.json"
    assert obsctl.main(["run", "steady", "--seed", "3", "-o",
                        str(ref_out)]) == 0
    doc, rdoc = obs.load(str(out)), obs.load(str(ref_out))
    assert without_span_times(doc) == without_span_times(rdoc)
    out2 = tmp_path / "run2.json"
    assert cli.main(["run", "steady", "--seed", "4", "--device", "cpu",
                     "-o", str(out2)]) == 0
    capsys.readouterr()
    for argv in (["summarize", str(out), str(ROOT / "BENCH_faults.json")],
                 ["check", str(out), "--min-capacity", "0.1"],
                 ["check", str(out), "--min-accuracy", "1.01"],
                 ["diff", str(out), str(out)],
                 ["diff", str(out), str(out2)],
                 ["diff", str(out), str(out2), "--fail-on-diff"]):
        rc = cli.main(argv)
        got = capsys.readouterr().out
        assert rc == obsctl.main(argv), argv
        assert got == capsys.readouterr().out, argv
        assert rc == (1 if argv[-1] in ("1.01", "--fail-on-diff") else 0)


def test_obs_cli_prints_to_stdout_and_needs_a_card(monkeypatch, capsys):
    """`run` without `-o` prints the canonical document; without
    ``--device`` it asks for the card, and raises where there is none."""
    assert cli.main(["run", "steady", "--seed", "3", "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["name"] == "steady" and doc["seed"] == 3
    assert obs.check_run(doc) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["run", "steady"])
