"""The port's fault plane against the JAX reference.

Each behaviour of `repro_torch.faults.FaultPlane` is held against the
reference's plane on the same inputs (the same monitor seeds, the same
scripted injections, the same plane seed): reachability composition,
capture timeouts with their Eq. 1-priced retries, the staleness
discount and the snapshot rung, loss holes and their backfill, the
outage freeze, predictor injection and `sanitize_matrix`, and plan
rollback. Then the engines: the plane-construction matrix on both, the
8 chaos scenarios in both modes (`run_chaos` field for field, error
strings included, and the live traces step for step), `chaos_report`,
`monitor_freeze` under the lifecycle, and the 19 pins with the fault
gate explicitly off. The dead-pair fills the chaos runs make go through
the water-fill's plain version here, and through its kernel on the card
(`cuda`).

The reference fleet imports `jax.experimental.enable_x64`, which jax
0.9 dropped; the `ref` fixture installs a stand-in only when it is
missing (as `tests/test_torch_fleet.py` does). It is imported by a
fixture, so the card-only test runs where jax is not installed.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from repro_torch.control import ControllerConfig, WanifyController
from repro_torch.core.predictor import SnapshotPredictor
from repro_torch.faults import (FaultConfig, FaultPlane, ProbeTimeoutError,
                                faults_mode)
from repro_torch.faults.harness import chaos_report, run_chaos
from repro_torch.faults.scenarios import (CHAOS_SCENARIOS,
                                          chaos_scenario_names,
                                          get_chaos_scenario)
from repro_torch.fleet import FleetEngine
from repro_torch.kernels import ops
from repro_torch.kernels import waterfill as wfk
from repro_torch.kernels.ref import fill_rates_ref
from repro_torch.lifecycle.manager import LifecycleManager
from repro_torch.scenarios import ScenarioEngine, goldens
from repro_torch.wan.monitor import SnapshotMonitor
from repro_torch.wan.simulator import WanSimulator, fill_rates_host

CHAOS = list(CHAOS_SCENARIOS)
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def ref():
    """The reference packages, as a namespace."""
    import jax
    import jax.experimental
    shim = not hasattr(jax.experimental, "enable_x64")
    before = set(sys.modules)
    if shim:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    import repro.control
    import repro.core.predictor
    import repro.faults
    import repro.faults.harness
    import repro.faults.scenarios
    import repro.fleet.scenario
    import repro.kernels.waterfill
    import repro.lifecycle.manager
    import repro.scenarios
    import repro.wan.monitor
    import repro.wan.simulator
    yield repro
    if shim:
        del jax.experimental.enable_x64
        for name in set(sys.modules) - before:
            if name == "repro" or name.startswith("repro."):
                del sys.modules[name]


def _monitors(ref, seed=0):
    """A quiet simulator and its monitor in each package."""
    kw = dict(seed=seed, fluct_sigma=0.0, snapshot_sigma=0.0,
              runtime_sigma=0.0)
    sim, rsim = WanSimulator(**kw), ref.wan.simulator.WanSimulator(**kw)
    return (sim, SnapshotMonitor(sim),
            rsim, ref.wan.monitor.SnapshotMonitor(rsim))


def _planes(ref, n=8, graceful=True, seed=0, **cfg):
    """(port plane, reference plane) built alike."""
    return (FaultPlane(n, graceful=graceful, seed=seed,
                       cfg=FaultConfig(**cfg)),
            ref.faults.FaultPlane(n, graceful=graceful, seed=seed,
                                  cfg=ref.faults.FaultConfig(**cfg)))


def _same_raw(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _same_state(p, r):
    """Counters, log, rollbacks and retry dollars equal."""
    assert p.metrics.counters() == r.metrics.counters()
    assert p.metrics.snapshot() == r.metrics.snapshot()
    assert p.log == r.log
    assert p.rollbacks == r.rollbacks and p.retry_usd == r.retry_usd


# ----------------------------------------------------------------------
# the plane, behaviour by behaviour, against the reference's plane
# ----------------------------------------------------------------------
def test_faults_mode_resolution_equal_reference(monkeypatch, ref):
    monkeypatch.delenv("REPRO_FAULTS", raising=False)
    for mode in (None, "on", "off"):
        assert faults_mode(mode) == ref.faults.faults_mode(mode)
    monkeypatch.setenv("REPRO_FAULTS", "on")
    assert faults_mode() == ref.faults.faults_mode() == "on"
    for bad in ("chaos", object()):
        with pytest.raises(ValueError, match="unknown faults mode"):
            faults_mode(bad)
        with pytest.raises(ValueError, match="unknown faults mode"):
            ref.faults.faults_mode(bad)


@pytest.mark.parametrize("seed", range(6))
def test_reachability_composition_equal_reference(ref, seed):
    """A seeded sequence of blackouts, restores, partitions and heals:
    the composed mask (None when clean) and the log equal after every
    operation, and installing it zeroes the same links."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 9))
    p, r = _planes(ref, n=n)
    sim, _, rsim, _ = _monitors(ref, seed)
    for _ in range(12):
        op = int(rng.integers(4))
        if op == 0:
            d = int(rng.integers(n))
            p.blackout(d), r.blackout(d)
        elif op == 1:
            d = int(rng.integers(n))
            p.restore(d), r.restore(d)
        elif op == 2:
            perm = rng.permutation(n)
            cut = int(rng.integers(1, n))
            groups = [perm[:cut].tolist(), perm[cut:].tolist()]
            p.set_partition(groups), r.set_partition(groups)
        else:
            p.heal_partition(), r.heal_partition()
        pm, rm = p.reachable_mask(), r.reachable_mask()
        assert (pm is None) == (rm is None)
        if pm is not None:
            np.testing.assert_array_equal(pm, rm)
        if n == 8:
            p.apply_reachability(sim), r.apply_reachability(rsim)
            np.testing.assert_array_equal(sim.link_bw_now(),
                                          rsim.link_bw_now())
    _same_state(p, r)


@pytest.mark.parametrize("graceful", [True, False],
                         ids=["graceful", "naive"])
@pytest.mark.parametrize("first_step", [0, 3, 9])
def test_probe_timeout_equal_reference(ref, graceful, first_step):
    """A clean capture, then a timeout window: naive raises the same
    error; graceful retries (Eq. 1-priced backoff) and serves the
    discounted last-good capture, or past `max_stale_steps` the
    snapshot rung — the same raw, override and dollars."""
    sim, mon, rsim, rmon = _monitors(ref)
    conns = np.ones((8, 8))
    p, r = _planes(ref, graceful=graceful)
    _same_raw(p.captured(mon, conns)[0], r.captured(rmon, conns)[0])
    p.step = r.step = first_step
    p.probe_fault("timeout", 4), r.probe_fault("timeout", 4)
    for k in range(first_step, first_step + 5):
        p.step = r.step = k
        sim.advance(), rsim.advance()
        if not graceful and k < first_step + 4:
            with pytest.raises(ProbeTimeoutError) as pe:
                p.captured(mon, conns)
            with pytest.raises(ref.faults.ProbeTimeoutError) as re_:
                r.captured(rmon, conns)
            assert str(pe.value) == str(re_.value)
            continue
        (raw, ov), (rraw, rov) = p.captured(mon, conns), \
            r.captured(rmon, conns)
        _same_raw(raw, rraw)
        assert (ov is None) == (rov is None)
        if ov is not None:
            np.testing.assert_array_equal(ov, rov)
    _same_state(p, r)
    assert (p.retry_usd > 0.0) == graceful


def test_staleness_snapshot_rung_equal_reference(ref):
    """An outage past `max_stale_steps`: both planes bypass the RF for
    the snapshot rung with the same override and counters."""
    sim, mon, rsim, rmon = _monitors(ref)
    conns = np.full((8, 8), 2.0)
    p, r = _planes(ref, max_stale_steps=2)
    p.captured(mon, conns), r.captured(rmon, conns)
    for k in range(1, 7):
        p.step = r.step = k
        if k == 1:
            p.monitor_outage(10), r.monitor_outage(10)
        (raw, ov), (rraw, rov) = p.captured(mon, conns), \
            r.captured(rmon, conns)
        _same_raw(raw, rraw)
        assert (ov is None) == (rov is None) == (k <= 2)
        if ov is not None:
            np.testing.assert_array_equal(ov, rov)
    _same_state(p, r)
    assert p.metrics.counters()["snapshot_fallbacks"] == 4


@pytest.mark.parametrize("graceful", [True, False],
                         ids=["graceful", "naive"])
@pytest.mark.parametrize("frac", [0.3, 0.9])
@pytest.mark.parametrize("seed", [0, 7])
def test_probe_loss_holes_and_backfill_equal_reference(ref, graceful,
                                                       frac, seed):
    """ProbeLoss: the same pairs lost from the plane's own stream, the
    same holes (naive) or retries and backfill (graceful), with and
    without a last-good capture to backfill from."""
    sim, mon, rsim, rmon = _monitors(ref, seed)
    conns = np.ones((8, 8))
    p, r = _planes(ref, graceful=graceful, seed=seed)
    p.probe_fault("loss", 3, frac=frac), r.probe_fault("loss", 3, frac=frac)
    for k in range(5):
        p.step = r.step = k
        sim.advance(), rsim.advance()
        (raw, _), (rraw, _) = p.captured(mon, conns), r.captured(rmon, conns)
        _same_raw(raw, rraw)
        assert np.isnan(raw["snapshot_bw"]).any() == \
            (not graceful and k < 3)
    _same_state(p, r)


def test_outage_freezes_measurement_equal_reference(ref):
    """`measured`: the frozen sample with ok=False during the outage,
    live again after it."""
    sim, mon, rsim, rmon = _monitors(ref)
    conns = np.full((8, 8), 3.0)
    p, r = _planes(ref)
    oks = []
    for k in range(8):
        p.step = r.step = k
        if k == 2:
            p.monitor_outage(3), r.monitor_outage(3)
        sim.advance(), rsim.advance()
        (m, ok), (rm, rok) = p.measured(mon, conns), r.measured(rmon, conns)
        np.testing.assert_array_equal(m, rm)
        assert ok == rok
        oks.append(ok)
    assert oks == [True, True, False, False, False, True, True, True]
    _same_state(p, r)


@pytest.mark.parametrize("graceful", [True, False],
                         ids=["graceful", "naive"])
@pytest.mark.parametrize("kind", ["nan", "garbage"])
def test_predictor_injection_equal_reference(ref, graceful, kind):
    """`predicted`: the same rows poisoned from the plane's stream in
    both modes; graceful quarantines them against the last finite
    prediction (or the snapshot floor) the same way."""
    rng = np.random.default_rng(5)
    p, r = _planes(ref, graceful=graceful, seed=11)
    p.predictor_fault(4, kind=kind, rows=3)
    r.predictor_fault(4, kind=kind, rows=3)
    for k in range(6):
        p.step = r.step = k
        snap = rng.uniform(20.0, 900.0, (8, 8))
        pred = snap * rng.uniform(0.8, 1.2, (8, 8))
        out, rout = p.predicted(pred, snap), r.predicted(pred, snap)
        np.testing.assert_array_equal(out, rout)
        assert np.isfinite(out).all() == (graceful or k >= 4
                                          or kind == "garbage")
    _same_state(p, r)


@pytest.mark.parametrize("seed", range(4))
def test_sanitize_matrix_equal_reference(ref, seed):
    """Rung 4's stateless form: NaN, negative and outlier entries
    replaced from the reference matrix or the snapshot floor."""
    rng = np.random.default_rng(seed)
    p, r = _planes(ref, outlier_factor=float(rng.uniform(2.0, 6.0)))
    snap = rng.uniform(0.0, 500.0, (8, 8))
    pred = snap * rng.uniform(0.5, 8.0, (8, 8))
    pred[rng.random((8, 8)) < 0.1] = np.nan
    pred[rng.random((8, 8)) < 0.1] *= -1.0
    refm = rng.uniform(10.0, 400.0, (8, 8)) if seed % 2 else None
    out = p.sanitize_matrix(pred, snap, reference=refm)
    rout = r.sanitize_matrix(pred, snap, reference=refm)
    np.testing.assert_array_equal(out, rout)
    assert np.isfinite(out).all()
    _same_state(p, r)


def test_rollback_counts_equal_reference(ref):
    """Rung 5 through the controllers: the same rolled-back plan and
    record, one rollback counted on each plane."""
    kw = dict(seed=3, fluct_sigma=0.1)
    sim, rsim = WanSimulator(**kw), ref.wan.simulator.WanSimulator(**kw)
    ctl = WanifyController(sim, SnapshotPredictor(), n_pods=4,
                           cfg=ControllerConfig(advance_sim=False))
    rctl = ref.control.WanifyController(
        rsim, ref.core.predictor.SnapshotPredictor(), n_pods=4,
        cfg=ref.control.ControllerConfig(advance_sim=False))
    p, r = _planes(ref)
    ctl.faults, rctl.faults = p, r
    for _ in range(6):
        sim.advance(), rsim.advance()
        ctl.replan(reason="explicit"), rctl.replan(reason="explicit")
    p.note_rollback(), r.note_rollback()
    a, b = ctl.rollback_plan(step=9), rctl.rollback_plan(step=9)
    assert a.signature() == b.signature()
    np.testing.assert_array_equal(ctl.current_conns(), rctl.current_conns())
    assert ctl.record[-1] == rctl.record[-1]
    _same_state(p, r)
    assert p.rollbacks == 1


# ----------------------------------------------------------------------
# the engines' plane construction
# ----------------------------------------------------------------------
def _build(pkg, engine, how):
    """An engine of `pkg` ("port" or the reference namespace) built the
    way `how` names: a plane object, "on", "off" with fault events,
    plain "off"."""
    port = pkg == "port"
    if engine == "scenario":
        spec = get_chaos_scenario("solver_flake").spec if port else \
            pkg.faults.scenarios.get_chaos_scenario("solver_flake").spec
        clean = dataclasses.replace(spec, events=())
        cls = ScenarioEngine if port else pkg.scenarios.ScenarioEngine
        kw = {}
    else:
        spec = get_chaos_scenario("fleet_blackout").spec if port else \
            pkg.faults.scenarios.get_chaos_scenario("fleet_blackout").spec
        clean = dataclasses.replace(spec, events=())
        cls = FleetEngine if port else pkg.fleet.scenario.FleetEngine
        kw = {"device": "cpu"} if port else {}
    plane_cls = FaultPlane if port else pkg.faults.FaultPlane
    if how == "object":
        plane = plane_cls(8, graceful=False, seed=5)
        eng = cls(clean, seed=3, faults=plane, **kw)
        assert eng.faults is plane
    elif how == "on":
        eng = cls(clean, seed=3, faults="on", **kw)
    elif how == "off_events":
        eng = cls(spec, seed=3, faults="off", **kw)
    else:
        eng = cls(clean, seed=3, faults="off", **kw)
    return eng


@pytest.mark.parametrize("how", ["object", "on", "off_events", "off"])
@pytest.mark.parametrize("engine", ["scenario", "fleet"])
def test_plane_construction_equal_reference(ref, engine, how):
    """Object / on / off with fault events / off on both engines: the
    same plane (none, graceful or naive), attached where the reference
    attaches it, and the run's rows and crash equal (the naive
    `solver_flake` dies at step 12 in both)."""
    eng, reng = _build("port", engine, how), _build(ref, engine, how)
    assert (eng.faults is None) == (reng.faults is None) == (how == "off")
    if eng.faults is not None:
        assert eng.faults.graceful == reng.faults.graceful == (how == "on")
        assert eng.faults.rng.random() == reng.faults.rng.random()
        inner = eng.controller.faults if engine == "scenario" \
            else eng.fleet.faults
        assert inner is eng.faults
    (rows, err), (rrows, rerr) = _live(eng), _live(reng)
    assert rows == rrows and err == rerr
    assert (err is not None) == (engine == "scenario" and how == "off_events")


def test_fleet_rejects_control_plane_fault_events():
    from repro_torch.faults import ProbeTimeout
    from repro_torch.scenarios.events import at
    chaos = get_chaos_scenario("fleet_blackout")
    bad = dataclasses.replace(
        chaos.spec, events=chaos.spec.events + (at(2, ProbeTimeout(3)),))
    with pytest.raises(ValueError, match="single-job-engine"):
        FleetEngine(bad, seed=0, device="cpu")


# ----------------------------------------------------------------------
# the chaos library, live against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("graceful", [True, False],
                         ids=["ladder", "naive"])
@pytest.mark.parametrize("name", CHAOS)
def test_run_chaos_equal_reference(ref, name, graceful):
    """`run_chaos` on the host (numpy fill, plain forest) equals the
    reference's live `run_chaos` field for field, `error` included."""
    got = run_chaos(name, seed=3, graceful=graceful, device="cpu")
    want = ref.faults.harness.run_chaos(name, seed=3, graceful=graceful)
    assert got == want
    if graceful:
        assert not got["crashed"] and got["degraded_min_bw"] > 0.0
    elif get_chaos_scenario(name).naive_crashes:
        assert got["crashed"] and got["degraded_min_bw"] == 0.0


def _live(eng):
    """Run an engine to its end or its crash -> (rows, error)."""
    rows = []
    eng.step_hook = lambda _eng, row: rows.append(dataclasses.asdict(row))
    try:
        eng.run()
    except Exception as exc:                      # noqa: BLE001
        return rows, f"{type(exc).__name__}: {exc}"
    return rows, None


@pytest.mark.parametrize("graceful", [True, False],
                         ids=["ladder", "naive"])
@pytest.mark.parametrize("name", CHAOS)
def test_chaos_trace_equal_reference(ref, name, graceful):
    """Every step row of the chaos run (up to a crash), the error, the
    plane's registry and log, and the controllers' replan records equal
    the reference's live run."""
    chaos = get_chaos_scenario(name)
    rchaos = ref.faults.scenarios.get_chaos_scenario(name)
    mode = "on" if graceful else "off"
    if chaos.fleet:
        eng = FleetEngine(chaos.spec, seed=3, faults=mode, device="cpu")
        reng = ref.fleet.scenario.FleetEngine(rchaos.spec, seed=3,
                                              faults=mode)
    else:
        eng = ScenarioEngine(chaos.spec, seed=3, faults=mode)
        reng = ref.scenarios.ScenarioEngine(rchaos.spec, seed=3,
                                            faults=mode)
    (rows, err), (rrows, rerr) = _live(eng), _live(reng)
    assert json.dumps(rows, sort_keys=True) == json.dumps(rrows,
                                                          sort_keys=True)
    assert err == rerr
    _same_state(eng.faults, reng.faults)
    if not chaos.fleet:
        # NaN predictions (naive `predictor_poison`) compare as JSON
        assert json.dumps(eng.controller.record) == \
            json.dumps(reng.controller.record)
        assert eng.sim.fill_calls == reng.sim.fill_calls


@pytest.fixture(scope="module")
def reports(ref):
    return (chaos_report(seed=3, device="cpu"),
            ref.faults.harness.chaos_report(seed=3))


def test_chaos_report_equal_reference(reports):
    got, want = reports
    assert got == want
    assert [r["scenario"] for r in got["runs"]][::2] == chaos_scenario_names()


def test_chaos_report_headline(reports):
    """The reference's `BENCH_faults.json` headline: the ladder never
    crashes, the naive ablation does 4 times, and the ladder recovers
    faster with a floor above zero."""
    s = reports[0]["summary"]
    assert s["scenarios"] == 8
    assert s["ladder_crashes"] == 0 and s["naive_crashes"] == 4
    assert s["ladder_mean_mttr"] < s["naive_mean_mttr"]
    assert s["ladder_min_floor"] > 0.0 == s["naive_min_floor"]


def test_harness_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """`device=None` is the card: without one the harness raises before
    any run (no crash is recorded in its place)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_chaos("solver_flake")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos_report(names=["partition"])


def test_monitor_freeze_lifecycle_equal_reference(ref):
    """`monitor_freeze` with a lifecycle manager and the graceful plane:
    the outage's `measurement_ok=False` skips the lifecycle's ticks in
    both packages, and the traces and lifecycle records are equal."""
    spec = get_chaos_scenario("monitor_freeze").spec
    rspec = ref.faults.scenarios.get_chaos_scenario("monitor_freeze").spec
    pred, rpred = SnapshotPredictor(), ref.core.predictor.SnapshotPredictor()
    mgr = LifecycleManager(pred, 8, active=False)
    rmgr = ref.lifecycle.manager.LifecycleManager(rpred, 8, active=False)
    res = ScenarioEngine(spec, seed=3, predictor=pred, lifecycle=mgr,
                         faults="on").run()
    rres = ref.scenarios.ScenarioEngine(rspec, seed=3, predictor=rpred,
                                        lifecycle=rmgr, faults="on").run()
    assert res.trace.to_json() == rres.trace.to_json()
    skipped = [r.step for r in mgr.records if r.skipped]
    assert skipped == [r.step for r in rmgr.records if r.skipped]
    assert skipped and all(8 <= s < 20 for s in skipped)
    assert [dataclasses.asdict(r) for r in mgr.records] == \
        [dataclasses.asdict(r) for r in rmgr.records]
    live = [r for r in mgr.records if not r.skipped]
    assert mgr.detector.ticks == rmgr.detector.ticks == len(live)


def test_lifecycle_on_gate_with_faults_equal_reference(ref):
    """`lifecycle="on"` (the manager the engine builds) and the graceful
    plane on `monitor_freeze`: the live trace equals the reference's."""
    spec = get_chaos_scenario("monitor_freeze").spec
    rspec = ref.faults.scenarios.get_chaos_scenario("monitor_freeze").spec
    eng = ScenarioEngine(spec, seed=3, lifecycle="on", faults="on")
    reng = ref.scenarios.ScenarioEngine(rspec, seed=3, lifecycle="on",
                                        faults="on")
    assert eng.run().trace.to_json() == reng.run().trace.to_json()
    assert any(r.skipped for r in eng.lifecycle.records)
    assert [r.skipped for r in eng.lifecycle.records] == \
        [r.skipped for r in reng.lifecycle.records]


# ----------------------------------------------------------------------
# the pins with the fault gate explicitly off
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def pins_faults_off():
    """Every pin's run once with REPRO_FAULTS=off set, the fleet's
    forest on the host."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_FAULTS", "off")
    try:
        runs = dict(goldens.runners(device="cpu"))
        runs.update(goldens.overlay_runners())
        return {k: goldens.sha(run()) for k, run in runs.items()}
    finally:
        mp.undo()


PIN_KEYS = sorted(goldens.pinned()) + sorted(goldens.overlay_runners())


@pytest.mark.parametrize("key", PIN_KEYS)
def test_pins_hold_with_faults_off(pins_faults_off, key):
    want = {**goldens.pinned(), **goldens.PLANE_PINS}[key]
    assert pins_faults_off[key] == want


# ----------------------------------------------------------------------
# dead-pair fills: the plain version here, the kernel on the card
# ----------------------------------------------------------------------
def _dead_case(kind, seed):
    """One fill with dead pairs carrying flows: a blacked-out DC or a
    partition installed through the plane on a fluctuated simulator."""
    rng = np.random.default_rng(seed)
    sim = WanSimulator(seed=seed)
    sim.advance(int(rng.integers(0, 4)))
    plane = FaultPlane(sim.N)
    if kind == "blackout":
        plane.blackout(int(rng.integers(sim.N)))
    else:
        perm = rng.permutation(sim.N)
        plane.set_partition([perm[:4].tolist(), perm[4:].tolist()])
    plane.apply_reachability(sim)
    c = rng.integers(1, 7, (sim.N, sim.N)).astype(float)
    np.fill_diagonal(c, 0.0)
    cap = rng.uniform(50.0, 2000.0, (sim.N, sim.N)) if seed % 2 else None
    case = (sim._contending_conns(c),) + sim.fill_inputs(cap)
    off = ~np.eye(sim.N, dtype=bool)
    assert ((case[0] > 0) & off & (case[1] == 0)).any()
    return case


@pytest.mark.parametrize("kind", ["blackout", "partition"])
@pytest.mark.parametrize("seed", range(3))
def test_dead_pair_fill_plain_equal_reference(ref, kind, seed):
    """The plain version on a dead-pair fill: the host loop's and the
    reference's device fill's rates within 1e-9, equal iterations, and
    zero rate on every dead pair."""
    case = _dead_case(kind, seed)
    n = case[0].shape[-1]
    rate, iters, ok = (v[0] for v in fill_rates_ref(
        *[torch.from_numpy(np.array(a)[None]) for a in case]))
    want, w_iters, w_ok = fill_rates_host(*case, wfk.max_fill_iters(n))
    rrate, riters, rok = ref.kernels.waterfill.fill_rates(
        *(np.asarray(a)[None] for a in case))
    assert bool(ok) and w_ok and bool(np.asarray(rok).all())
    assert int(iters) == w_iters == int(np.asarray(riters)[0])
    np.testing.assert_allclose(rate.numpy(), want, **TOL)
    np.testing.assert_allclose(rate.numpy(), np.asarray(rrate)[0], **TOL)
    assert (rate.numpy()[case[1] == 0] == 0.0).all()


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["blackout", "partition"])
def test_dead_pair_fill_kernel_on_card(card, kind):
    """The water-fill kernel on dead-pair fills: one launch, rates within
    1e-9 of the plain version and equal iterations."""
    cases = [_dead_case(kind, seed) for seed in range(4)]
    batch = tuple(np.stack(a) for a in zip(*cases))
    t = [torch.from_numpy(a).to(card) for a in batch]
    before = ops.fill_rates.launches
    rate, iters, ok = ops.fill_rates(*t)
    torch.cuda.synchronize()
    assert ops.fill_rates.launches == before + 1
    p_rate, p_iters, p_ok = fill_rates_ref(*[a.cpu() for a in t])
    assert ok.cpu().all() and p_ok.all()
    assert iters.cpu().tolist() == p_iters.tolist()
    np.testing.assert_allclose(rate.cpu().numpy(), p_rate.numpy(), **TOL)
