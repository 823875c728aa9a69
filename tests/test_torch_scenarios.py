"""The port's scenario engines against the JAX reference.

* All 19 sha256 pins of `tests/data/trace_golden.json` (12
  ``scenario/*/seed3``, 4 ``fleet/*/seed3`` and 3 ``placement/...``),
  from the port's own runs (the fleet's forest on the host's plain
  version), with span tracing off and on.
* Live byte-equality of ``to_json()`` with the reference where the pins
  do not reach: a single-job timeline with every single-job event kind,
  and a fleet timeline with churn and a priority shift, at seeds other
  than 3.
* The behavioural tests of `tests/test_scenarios.py` that hold with
  the overlay off, on the port's engine, and the gates that are not yet
  ported.

The reference fleet imports `jax.experimental.enable_x64`, which jax
0.9 dropped; the `ref_fleet` fixture installs a stand-in only when it
is missing (as `tests/test_torch_fleet.py` does).
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import repro_torch.fleet as fleet
import repro_torch.scenarios as sc
from repro_torch.faults import (FLEET_FAULT_EVENTS, DcBlackout, DcRestore,
                                ProbeTimeout, SolverFault, chaos_schedule)
from repro_torch.fleet import (FleetEngine, FleetScenarioSpec, JobSpec,
                               get_fleet_scenario, run_fleet_scenario)
from repro_torch.scenarios import (ScenarioEngine, at, flap, get_scenario,
                                   goldens, run_scenario, scenario_names)
from repro_torch.scenarios.events import LinkDegrade, LinkRestore, Straggler
from repro_torch.wan.simulator import WanSimulator

QUIET = dict(fluct_sigma=0.0, snapshot_sigma=0.0, runtime_sigma=0.0)
KEYS = list(goldens.runners())


@pytest.fixture(scope="module")
def pins():
    return goldens.pinned()


@pytest.fixture(scope="module")
def ref_scenarios():
    """The reference `repro.scenarios` (no jax on its import path)."""
    import repro.scenarios
    return repro.scenarios


@pytest.fixture(scope="module")
def ref_fleet():
    """The reference `repro.fleet` and `repro.scenarios`."""
    import jax
    import jax.experimental
    shim = not hasattr(jax.experimental, "enable_x64")
    before = set(sys.modules)
    if shim:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    import repro.fleet
    import repro.scenarios
    yield repro.fleet, repro.scenarios
    if shim:
        del jax.experimental.enable_x64
        for name in set(sys.modules) - before:
            if name == "repro" or name.startswith("repro."):
                del sys.modules[name]


@pytest.fixture(scope="module")
def results():
    """One deterministic run per (scenario, seed), shared module-wide."""
    cache = {}

    def get(name, seed=0):
        if (name, seed) not in cache:
            cache[(name, seed)] = run_scenario(get_scenario(name), seed=seed)
        return cache[(name, seed)]
    return get


# ----------------------------------------------------------------------
# the golden pins
# ----------------------------------------------------------------------
def test_pin_keys_are_the_reference_scenario_and_fleet_keys(pins):
    """Every key of the pin file: 12 scenario, 4 fleet and 3 placement
    runs."""
    assert sorted(KEYS) == sorted(pins) and len(KEYS) == 19
    assert sum(k.startswith("scenario/") for k in KEYS) == 12
    assert sum(k.startswith("placement/") for k in KEYS) == 3


@pytest.mark.parametrize("key", KEYS)
def test_golden_pin(pins, key, monkeypatch):
    """The port's run hashes to the reference's pin (obs off)."""
    monkeypatch.setenv("REPRO_OBS", "off")
    assert goldens.sha(goldens.runners(device="cpu")[key]()) == pins[key]


@pytest.mark.parametrize("key", KEYS)
def test_golden_pin_obs_on(pins, key, monkeypatch):
    """Spans are passive: the same pins with span tracing on."""
    monkeypatch.setenv("REPRO_OBS", "on")
    assert goldens.sha(goldens.runners(device="cpu")[key]()) == pins[key]


# ----------------------------------------------------------------------
# live byte-equality with the reference past the pins
# ----------------------------------------------------------------------
def _every_event_spec(S):
    """A single-job timeline with every single-job event kind, built
    from either package's DSL `S`."""
    return S.ScenarioSpec(
        name="every_event", steps=36,
        events=(S.at(2, S.DiurnalCycle(amplitude=0.3, period=12)),
                S.at(4, S.SkewRamp(weights=(3.0, 1.0, 1.0, 2.0), over=4)),
                S.at(6, S.CrossTraffic(("us-east", "ap-south"), conns=16)),
                S.at(9, S.CrossTraffic(("us-east", "ap-south"), conns=0)),
                *S.flap(11, ("us-west", "ap-se"), factor=0.1, down_steps=4),
                S.at(13, S.Straggler(slowdown=5.0, duration=2)),
                S.at(17, S.Rescale(n_pods=6)),
                S.at(22, S.ProviderShift(factors=(1.0, 0.6, 1.0, 0.6,
                                                  1.0, 1.0, 0.8, 1.0))),
                S.at(27, S.Rescale(n_pods=3))),
        sim_kwargs=dict(fluct_sigma=0.06, snapshot_sigma=0.04,
                        runtime_sigma=0.01),
        cfg_kwargs=dict(replan_every=4, straggler_factor=2.0,
                        straggler_cooldown=6))


@pytest.mark.parametrize("seed", [5, 11])
def test_every_event_kind_equals_reference(ref_scenarios, seed):
    want = ref_scenarios.run_scenario(_every_event_spec(ref_scenarios),
                                      seed=seed).trace.to_json()
    got = run_scenario(_every_event_spec(sc), seed=seed).trace.to_json()
    assert got == want
    kinds = {e.split("(")[0] for s in run_scenario(
        _every_event_spec(sc), seed=seed).trace.steps for e in s.events}
    assert kinds == {"DiurnalCycle", "SkewRamp", "CrossTraffic",
                     "LinkDegrade", "LinkRestore", "Straggler", "Rescale",
                     "ProviderShift"}


def _churn_spec(F, S):
    """A fleet timeline with arrivals, a departure, a priority shift and
    WAN events, from either package's fleet `F` and DSL `S`."""
    return F.FleetScenarioSpec(
        name="churn_and_shift", steps=10,
        jobs=(F.JobSpec("serving", dcs=(0, 1, 2, 3), priority=3.0),
              F.JobSpec("batch", dcs=(0, 1, 4, 5), priority=1.0,
                        skew_w=(2.0, 1.0, 1.0, 1.0))),
        events=(S.at(2, S.JobArrive(F.JobSpec("etl", dcs=(2, 3, 6, 7),
                                              priority=2.0))),
                S.at(3, S.LinkDegrade(("us-east", "us-west"), 0.2)),
                S.at(4, S.PriorityShift("batch", 5.0)),
                S.at(5, S.DiurnalCycle(amplitude=0.2, period=6)),
                S.at(6, S.JobDepart("serving")),
                S.at(7, S.LinkRestore(("us-east", "us-west"))),
                S.at(8, S.JobArrive(F.JobSpec("late", dcs=(1, 5, 7))))),
        sim_kwargs=dict(fluct_sigma=0.05, snapshot_sigma=0.03,
                        runtime_sigma=0.0))


@pytest.mark.parametrize("seed", [0, 7])
def test_fleet_churn_and_shift_equals_reference(ref_fleet, seed):
    rfleet, rsc = ref_fleet
    want = rfleet.run_fleet_scenario(_churn_spec(rfleet, rsc),
                                     seed=seed).trace.to_json()
    got = run_fleet_scenario(_churn_spec(fleet, sc), seed=seed,
                             device="cpu").trace.to_json()
    assert got == want


def test_chaos_schedule_equals_reference(ref_scenarios):
    """The same seed composes the same storm (describe() strings)."""
    from repro.faults.events import chaos_schedule as ref_chaos
    regions = WanSimulator().regions
    for seed in (0, 3, 9):
        want = [(t.step, t.event.describe())
                for t in ref_chaos(seed, 40, regions=regions, n_faults=6)]
        got = [(t.step, t.event.describe())
               for t in chaos_schedule(seed, 40, regions=regions,
                                       n_faults=6)]
        assert got == want


# ----------------------------------------------------------------------
# determinism contract (ported from tests/test_scenarios.py)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["congestion", "runtime_fluctuation"])
def test_replay_byte_identical(name):
    a = run_scenario(get_scenario(name), seed=3).trace.to_json()
    b = run_scenario(get_scenario(name), seed=3).trace.to_json()
    assert a.encode() == b.encode()


def test_different_seeds_diverge(results):
    a = results("runtime_fluctuation", seed=0).trace
    b = results("runtime_fluctuation", seed=1).trace
    assert a.to_json() != b.to_json()


def test_step_hook_sees_every_step():
    eng = ScenarioEngine(get_scenario("steady"), seed=0)
    seen = []
    eng.step_hook = lambda engine, row: seen.append(
        (row.step, engine.controller.n_pods))
    res = eng.run()
    assert [s for s, _ in seen] == [r.step for r in res.trace.steps]


def test_measurement_interleaving_does_not_change_replay():
    c = np.ones((8, 8))
    s1 = WanSimulator(seed=5)
    s2 = WanSimulator(seed=5)
    s2.host_metrics(c)                   # extra draw on the host stream
    np.testing.assert_array_equal(s1.measure_snapshot(c),
                                  s2.measure_snapshot(c))


# ----------------------------------------------------------------------
# named scenarios: controller behaviour under dynamics
# ----------------------------------------------------------------------
def test_steady_replans_are_periodic_only(results):
    t = results("steady").trace
    assert set(t.replan_reasons()) <= {"periodic"}
    assert len(t.replan_steps()) >= 2
    assert all(abs(s.monitored_mean - s.achieved_mean) < 1e-9
               for s in t.steps)


def test_congestion_exactly_one_straggler_replan(results):
    t = results("congestion").trace
    reasons = t.replan_reasons()
    assert reasons.count("straggler") == 1
    assert set(reasons) == {"straggler"}
    trigger = t.replan_steps("straggler")[0]
    assert 10 <= trigger < 15
    before = t.steps[9].achieved_min
    during = min(s.achieved_min for s in t.steps[10:15])
    assert during < 0.5 * before


def test_congestion_aimd_backoff(results):
    t = results("congestion").trace
    k = t.replan_steps("straggler")[0]
    assert t.steps[k].conns_total < t.steps[k - 1].conns_total


def test_flap_recovery_hits_plan_cache(results):
    """The recovery's plan is the pre-flap one: a plan-cache hit, not a
    third build."""
    t = results("link_flap").trace
    pre, down, post = t.steps[9], t.steps[15], t.steps[25]
    assert down.plan_sig != pre.plan_sig
    assert post.plan_sig == pre.plan_sig
    assert t.replan_reasons().count("topology") == 2
    assert t.steps[-1].cache_builds == 2
    assert t.steps[-1].cache_hits > t.steps[19].cache_hits


def test_straggler_injection_forces_aimd_decrease(results):
    t = results("straggler_host").trace
    assert t.replan_reasons().count("straggler") >= 1
    assert t.replan_steps("straggler")[0] == 15
    assert t.steps[15].conns_total < t.steps[14].conns_total


def test_elastic_rescale_join_and_leave(results):
    t = results("elastic").trace
    reasons = t.replan_reasons()
    assert "rescale:6" in reasons and "rescale:4" in reasons
    assert t.steps[11].n_pods == 4
    assert t.steps[12].n_pods == 6
    assert t.steps[28].n_pods == 4
    assert all(s.conns_total >= s.n_pods * (s.n_pods - 1) for s in t.steps)


def test_provider_shift_triggers_topology_replan(results):
    t = results("provider_shift").trace
    assert t.replan_steps("topology") == [15]
    assert t.steps[16].predicted_mean < 0.9 * t.steps[14].predicted_mean


def test_skew_ramp_shifts_connection_budget():
    eng = ScenarioEngine(get_scenario("skew_ramp"), seed=0)
    eng.run()
    agents = eng.controller._agents
    assert int(agents[0].max_cons.sum()) > int(agents[1].max_cons.sum())
    first = eng.controller.record[0]["signature"][1]
    assert len({sum(row) for row in first}) == 1


def test_skew_ramp_composes_with_rescale():
    spec = sc.ScenarioSpec(
        name="skew_then_rescale", steps=24,
        events=(at(5, sc.SkewRamp(weights=(4.0, 1.0, 1.0, 1.0), over=3)),
                at(12, sc.Rescale(n_pods=6)),
                at(14, sc.SkewRamp(weights=(1.0, 1.0, 2.0, 2.0, 1.0, 1.0),
                                   over=2)),
                at(18, sc.Rescale(n_pods=3))),
        sim_kwargs=dict(QUIET), cfg_kwargs=dict(replan_every=4))
    t = run_scenario(spec, seed=0).trace
    assert t.steps[12].n_pods == 6 and t.steps[18].n_pods == 3
    assert "rescale:6" in t.replan_reasons()


def test_cable_cut_discovered_by_periodic_trigger(results):
    t = results("cable_cut").trace
    assert t.steps[20].predicted_min < 0.5 * t.steps[10].predicted_min
    assert t.steps[25].plan_sig != t.steps[10].plan_sig


def test_diurnal_achieved_bw_tracks_cycle(results):
    t = results("diurnal").trace
    peak = np.mean([s.achieved_mean for s in t.steps[5:10]])
    trough = np.mean([s.achieved_mean for s in t.steps[20:25]])
    assert trough < 0.8 * peak


# ----------------------------------------------------------------------
# DSL, trace schema, summaries
# ----------------------------------------------------------------------
def test_event_dsl_construction():
    e = at(7, LinkDegrade(("us-east", "ap-se"), 0.1))
    assert e.step == 7 and e.event.factor == 0.1
    pair = flap(10, ("us-east", "us-west"), 0.05, down_steps=5)
    assert [t.step for t in pair] == [10, 15]
    assert isinstance(pair[0].event, LinkDegrade)
    assert isinstance(pair[1].event, LinkRestore)
    assert Straggler(4.0, 2).describe() == \
        "Straggler(slowdown=4.0, duration=2)"


def test_fleet_events_target_engine_surface():
    class StubEngine:
        calls = []

        def add_job(self, spec):
            self.calls.append(("add", spec))

        def remove_job(self, name):
            self.calls.append(("remove", name))

        def set_priority(self, name, priority):
            self.calls.append(("prio", name, priority))

    eng = StubEngine()
    sc.JobArrive(job="spec-sentinel").apply(eng)
    sc.JobDepart(name="batch").apply(eng)
    sc.PriorityShift(name="serving", priority=6.0).apply(eng)
    assert eng.calls == [("add", "spec-sentinel"), ("remove", "batch"),
                         ("prio", "serving", 6.0)]
    assert sc.JobDepart(name="batch").describe() == "JobDepart(name=batch)"


def test_unknown_scenario_rejected():
    with pytest.raises(KeyError):
        get_scenario("no-such-scenario")
    with pytest.raises(KeyError):
        get_fleet_scenario("no-such-fleet")


def test_trace_schema_and_summary(results):
    res = results("steady")
    row = dataclasses.asdict(res.trace.steps[0])
    assert set(row) == {
        "step", "events", "dt", "achieved_min", "achieved_mean",
        "monitored_min", "monitored_mean", "predicted_min",
        "predicted_mean", "plan_sig", "n_pods", "conns_total", "replans",
        "cache_builds", "cache_hits"}
    s = res.summary()
    assert s["steps"] == len(res.trace.steps)
    assert s["throughput_mbps"] > 0
    assert s["cache_builds"] + s["cache_hits"] > 0


def test_all_library_scenarios_build():
    assert scenario_names() == [
        "steady", "diurnal", "runtime_fluctuation", "congestion",
        "link_flap", "cable_cut", "cable_cut_reroute", "straggler_host",
        "elastic", "provider_shift", "provider_shift_drift", "skew_ramp"]
    for name in scenario_names():
        spec = get_scenario(name)
        assert spec.steps > 0 and spec.name == name


def test_fleet_summary_and_job_series():
    res = run_fleet_scenario(get_fleet_scenario("fleet_churn"), seed=0,
                             device="cpu")
    s = res.summary()
    assert s["ticks"] == 14 and s["kernel_calls"] == 14
    assert res.trace.job_names() == ["serving", "batch", "etl"]
    assert len(res.trace.job_series("etl", "budget")) == 10
    assert s["jobs"]["batch"]["ticks"] == 9


def test_controller_plan_cache_and_trace_hooks():
    """The plan cache keys on the plan's signature; hooks compose."""
    eng = ScenarioEngine(get_scenario("steady"), seed=0)
    ctl = eng.controller
    assert ctl.current_routing() is None
    built = ctl.compiled(("x",), lambda p: p.signature())
    assert ctl.compiled(("x",), lambda p: 1 / 0) is built
    assert (ctl.cache_builds, ctl.cache_hits) == (1, 1)
    ctl.cache_builds = ctl.cache_hits = 0
    assert (ctl.cache_builds, ctl.cache_hits) == (0, 0)
    seen = []
    ctl.add_trace_hook(lambda r: seen.append(("a", r["reason"])))
    ctl.add_trace_hook(lambda r: seen.append(("b", r["reason"])))
    ctl.replan(reason="explicit")
    assert seen == [("a", "explicit"), ("b", "explicit")]


# ----------------------------------------------------------------------
# fleet timelines and the gates not yet ported
# ----------------------------------------------------------------------
def _two_jobs():
    return (JobSpec("a", (0, 1, 2)), JobSpec("b", (0, 1, 3)))


def test_fleet_timeline_rejects_single_job_events():
    bad = FleetScenarioSpec(
        name="bad", steps=4, jobs=_two_jobs(),
        events=(at(1, Straggler(slowdown=4.0)),), sim_kwargs=dict(QUIET))
    with pytest.raises(ValueError, match="single-job-engine"):
        FleetEngine(bad, seed=0, device="cpu")
    noisy = FleetScenarioSpec(
        name="bad2", steps=4, jobs=_two_jobs(),
        events=(at(1, LinkDegrade(("us-east", "us-west"), 0.1,
                                  notify=True)),),
        sim_kwargs=dict(QUIET))
    with pytest.raises(ValueError, match="notify"):
        FleetEngine(noisy, seed=0, device="cpu")
    assert set(FLEET_FAULT_EVENTS) <= set(fleet.scenario.FLEET_EVENTS)


def test_scenario_gates_not_yet_ported(monkeypatch):
    spec = get_scenario("steady")
    for kw in (dict(overlay="on"), dict(lifecycle="on"),
               dict(lifecycle=object()), dict(faults="on"),
               dict(faults=object())):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ScenarioEngine(spec, seed=0, **kw)
    for events in ((at(3, SolverFault(1)),), (at(2, ProbeTimeout(3)),)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ScenarioEngine(dataclasses.replace(spec, events=events))
    for var in ("REPRO_LIFECYCLE", "REPRO_FAULTS", "REPRO_OVERLAY"):
        with monkeypatch.context() as m:
            m.setenv(var, "on")
            with pytest.raises(NotImplementedError, match="not yet ported"):
                run_scenario(spec)
    with pytest.raises(ValueError, match="unknown lifecycle"):
        ScenarioEngine(spec, lifecycle="sideways")
    eng = ScenarioEngine(spec, lifecycle="off", faults="off", overlay="off")
    assert eng.faults is None and eng.lifecycle is None


def test_fleet_gates_not_yet_ported(monkeypatch):
    spec = get_fleet_scenario("fleet_steady")
    for faults in ("on", object()):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            FleetEngine(spec, faults=faults, device="cpu")
    cut = dataclasses.replace(spec, events=(at(2, DcBlackout("ap-se")),
                                            at(4, DcRestore("ap-se"))))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        FleetEngine(cut, device="cpu")
    monkeypatch.setenv("REPRO_FAULTS", "on")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        run_fleet_scenario(spec, device="cpu")


def test_fleet_scenario_defaults_to_cuda_and_raises_without_it(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fleet_scenario(get_fleet_scenario("fleet_steady"))
    assert FleetEngine(get_fleet_scenario("fleet_steady"),
                       device="cpu").fleet.predictor.device.type == "cpu"
