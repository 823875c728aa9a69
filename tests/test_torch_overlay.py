"""The port's overlay routing plane against the JAX reference.

One counterpart to each test of `tests/test_overlay.py`, compared port
against reference wherever the reference runs: `plan_routes` and
`RoutedPlan` (units, randomized prediction surfaces, hypothesis
properties), the routed water-fill on the ``numpy`` and ``torch`` fill
backends, the controller's record and routing, placement's routed
pricing, and the pinned `cable_cut_reroute` acceptance (seed 3,
overlay off and on: ``to_json()`` byte-equal to the reference's live
runs, the strict win, the detours via DCs 0 and 3, pre-cut equality),
plus the plane pins of `repro_torch.scenarios.goldens.PLANE_PINS`.

The loop is host float64 in both packages, so plans, records and
traces are compared for equality; the ``torch`` fill backend (the
water-fill kernel's plain version) sums in another order and is held
within 1e-9 with equal iterations, as the water-fill's own tests hold
it. The reference is imported by fixtures, so the card-only tests
(marked `cuda`) run where jax is not installed.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.control import ControllerConfig, WanifyController
from repro_torch.core.global_opt import global_optimize, relay_candidates
from repro_torch.core.plan import WanPlan
from repro_torch.core.predictor import SnapshotPredictor
from repro_torch.kernels import ops
from repro_torch.kernels import waterfill as wfk
from repro_torch.overlay import (DEFAULT_GAIN_MIN, OVERLAY_MODES, RoutedPlan,
                                 overlay_mode, plan_routes)
from repro_torch.placement.cost import achievable_bw
from repro_torch.placement.scenario import run_placement_scenario
from repro_torch.scenarios import get_scenario, goldens, run_scenario
from repro_torch.scenarios.engine import ScenarioEngine
from repro_torch.wan.simulator import WanSimulator, fill_rates_host

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                # pragma: no cover
    HAVE_HYPOTHESIS = False

QUIET = dict(fluct_sigma=0.0, snapshot_sigma=0.0, runtime_sigma=0.0)
SETTLED = 14          # the first step the post-cut routing is in force
CUT = 12              # the staged cut's step
FILL_TOL = 1e-9       # tests/test_waterfill_kernel.py's tolerance
SURFACE_SEEDS = list(range(12))
OVERLAY_KEYS = [k for k in goldens.PLANE_PINS
                if not k.startswith("lifecycle/")]


def quiet_sim(seed=3, **kw):
    return WanSimulator(seed=seed, **QUIET, **kw)


@pytest.fixture(scope="module")
def ref():
    """The reference's overlay, controller, simulator, placement and
    scenario modules (none needs jax's `enable_x64`)."""
    import repro.control as control
    import repro.core.global_opt as global_opt
    import repro.core.plan as plan
    import repro.core.predictor as predictor
    import repro.overlay as overlay
    import repro.placement.cost as cost
    import repro.placement.scenario as pscen
    import repro.scenarios as scenarios
    import repro.wan.simulator as simulator
    return types.SimpleNamespace(
        control=control, global_opt=global_opt, plan=plan,
        predictor=predictor, overlay=overlay, cost=cost, pscen=pscen,
        scenarios=scenarios, simulator=simulator)


def ref_quiet_sim(ref, seed=3, **kw):
    return ref.simulator.WanSimulator(seed=seed, **QUIET, **kw)


def _routed_fields(rp):
    return (rp.n_pods, rp.direct, rp.relays, rp.pred_bw)


# ----------------------------------------------------------------------
# gate resolution
# ----------------------------------------------------------------------
def test_overlay_mode_resolution(monkeypatch, ref):
    monkeypatch.delenv("REPRO_OVERLAY", raising=False)
    assert overlay_mode() == "off" == ref.overlay.overlay_mode()
    monkeypatch.setenv("REPRO_OVERLAY", "on")
    assert overlay_mode() == "on" == ref.overlay.overlay_mode()
    assert overlay_mode("off") == "off"      # explicit argument wins
    with pytest.raises(ValueError):
        overlay_mode("sideways")
    monkeypatch.setenv("REPRO_OVERLAY", "bogus")
    with pytest.raises(ValueError):
        overlay_mode()
    assert OVERLAY_MODES == ("off", "on") == ref.overlay.OVERLAY_MODES
    assert DEFAULT_GAIN_MIN == ref.overlay.DEFAULT_GAIN_MIN


def test_env_gate_reaches_controller(monkeypatch, ref):
    monkeypatch.setenv("REPRO_OVERLAY", "on")
    ctl = WanifyController(sim=quiet_sim(), predictor=SnapshotPredictor(),
                           n_pods=4, cfg=ControllerConfig(advance_sim=False))
    want = ref.control.WanifyController(
        sim=ref_quiet_sim(ref), predictor=ref.predictor.SnapshotPredictor(),
        n_pods=4, cfg=ref.control.ControllerConfig(advance_sim=False))
    assert ctl.overlay == "on"
    assert ctl.record[-1].get("overlay") == "on"
    assert ctl.record == want.record
    monkeypatch.delenv("REPRO_OVERLAY")
    ctl = WanifyController(sim=quiet_sim(), predictor=SnapshotPredictor(),
                           n_pods=4, cfg=ControllerConfig(advance_sim=False))
    assert ctl.overlay == "off"


def test_fleet_jobs_pin_overlay_off(monkeypatch):
    """A global $REPRO_OVERLAY=on must not leak into fleet jobs: the
    arbiter's envelopes model direct per-pair flows only."""
    from repro_torch.fleet import (BatchedRfPredictor, FleetController,
                                   JobSpec, default_fleet_forest)
    monkeypatch.setenv("REPRO_OVERLAY", "on")
    forest = default_fleet_forest(n_samples=20, n_trees=4, depth=3, seed=7)
    fleet = FleetController(quiet_sim(),
                            BatchedRfPredictor(forest, device="cpu"),
                            m_total=8)
    job = fleet.add_job(JobSpec(name="j0", dcs=(0, 1, 2, 3)))
    assert job.controller.overlay == "off"
    assert job.controller.routed is None
    assert job.controller.current_routing() is None


# ----------------------------------------------------------------------
# RoutedPlan / plan_routes units
# ----------------------------------------------------------------------
def _toy_routed(mod):
    direct = ((1, 2, 1), (2, 1, 3), (1, 3, 1))
    relays = ((0, 1, 2, 3),)
    pred = tuple(tuple(100.0 for _ in range(3)) for _ in range(3))
    return mod.RoutedPlan(n_pods=3, direct=direct, relays=relays,
                          pred_bw=pred)


def test_expanded_conns_folds_relay_onto_both_hops(ref):
    rp = _toy_routed(types.SimpleNamespace(RoutedPlan=RoutedPlan))
    exp = rp.expanded_conns()
    base = np.asarray(rp.direct, float)
    assert exp[0, 1] == base[0, 1] + 3       # hop i -> k
    assert exp[1, 2] == base[1, 2] + 3       # hop k -> j
    assert exp[0, 2] == base[0, 2]           # end-to-end pair untouched
    want = _toy_routed(ref.overlay)
    np.testing.assert_array_equal(exp, want.expanded_conns())
    np.testing.assert_array_equal(rp.routed_pred_bw(),
                                  want.routed_pred_bw())


def test_routed_plan_signature_covers_routing(ref):
    rp = _toy_routed(types.SimpleNamespace(RoutedPlan=RoutedPlan))
    sig = rp.signature()
    assert sig == (3, rp.direct, rp.relays)
    assert sig == _toy_routed(ref.overlay).signature()
    other = RoutedPlan(n_pods=3, direct=rp.direct, relays=(),
                       pred_bw=rp.pred_bw)
    assert other.signature() != sig          # relays are plan identity
    assert hash(sig) is not None             # cache-keyable


def test_plan_routes_no_relay_without_decisive_gain(ref):
    """Healthy geometry: no candidate clears gain_min, every
    connection stays on its direct link."""
    pred = np.array([[1e4, 900.0, 150.0],
                     [900.0, 1e4, 160.0],
                     [150.0, 160.0, 1e4]])
    conns = np.full((3, 3), 4)
    rp = plan_routes(pred, conns)
    assert rp.relays == ()
    assert np.array_equal(np.asarray(rp.direct), conns)
    assert _routed_fields(rp) == _routed_fields(
        ref.overlay.plan_routes(pred, conns))


def test_plan_routes_picks_best_relay_and_bounds_split(ref):
    """A collapsed far link with one strong detour: the relay fires,
    picks the best min-hop candidate, keeps min_direct on the direct
    link, and never exceeds max_relay_conns."""
    pred = np.array([[1e4, 800.0, 700.0],
                     [800.0, 1e4, 5.0],     # (1,2) cut
                     [700.0, 5.0, 1e4]])
    conns = np.full((3, 3), 8)
    np.fill_diagonal(conns, 1)
    rp = plan_routes(pred, conns, gain_min=2.0, max_relay_conns=4)
    assert (1, 0, 2, 4) in rp.relays and (2, 0, 1, 4) in rp.relays
    d = np.asarray(rp.direct)
    assert d[1, 2] == 4 and d[2, 1] == 4     # total conserved
    assert d[1, 2] >= 1                      # monitor keeps observing
    rp2 = plan_routes(pred, conns, gain_min=2.0, max_relay_conns=99)
    cr2 = dict(((i, j), c) for i, k, j, c in rp2.relays)[(1, 2)]
    assert cr2 == 7                          # total - min_direct
    for got, kw in ((rp, dict(max_relay_conns=4)),
                    (rp2, dict(max_relay_conns=99))):
        assert _routed_fields(got) == _routed_fields(
            ref.overlay.plan_routes(pred, conns, gain_min=2.0, **kw))


def test_plan_routes_normalizes_by_capture_conns(ref):
    """pred measured at heterogeneous conns: pair totals alone would
    fake a gain; per-connection units must kill it."""
    pred = np.array([[1e4, 800.0, 100.0],
                     [800.0, 1e4, 800.0],
                     [100.0, 800.0, 1e4]])
    cap = np.ones((3, 3))
    for a, b in ((0, 1), (1, 2)):
        cap[a, b] = cap[b, a] = 8.0
    conns = np.full((3, 3), 6)
    got = plan_routes(pred, conns, capture_conns=cap)
    assert got.relays == ()
    phantom = plan_routes(pred, conns)
    assert phantom.relays != ()
    assert _routed_fields(got) == _routed_fields(
        ref.overlay.plan_routes(pred, conns, capture_conns=cap))
    assert _routed_fields(phantom) == _routed_fields(
        ref.overlay.plan_routes(pred, conns))


def test_relay_candidates_closeness_pruning(ref):
    rel = np.array([[1, 2, 3, 3],
                    [2, 1, 3, 3],
                    [3, 3, 1, 2],
                    [3, 3, 2, 1]])
    assert relay_candidates(rel, 1, 2) == [0, 3]
    assert relay_candidates(rel, 0, 1) == []
    assert relay_candidates(rel, 1, 2, max_candidates=1) == [0]
    for i in range(4):
        for j in range(4):
            for m in (1, 2, 4):
                assert relay_candidates(rel, i, j, m) == \
                    ref.global_opt.relay_candidates(rel, i, j, m)


def _surface(seed, n):
    """A predicted surface with a few collapsed pairs, the operating
    point it was captured at and a plan's connection matrix."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(50.0, 2000.0, (n, n))
    cut = rng.random((n, n)) < 0.2
    pred = np.where(cut, pred * rng.uniform(0.005, 0.1, (n, n)), pred)
    np.fill_diagonal(pred, 1e4)
    capture = rng.integers(1, 9, (n, n)).astype(np.float64)
    conns = rng.integers(1, 10, (n, n))
    np.fill_diagonal(conns, 1)
    return pred, capture, conns


@pytest.mark.parametrize("seed", SURFACE_SEEDS)
def test_plan_routes_random_surfaces_equal_reference(ref, seed):
    """Randomized prediction surfaces (3–8 DCs, some pairs collapsed)
    route to an equal `RoutedPlan` in both packages, with and without
    the capture normalization and under the controller's own closeness
    classes."""
    n = 3 + seed % 6
    pred, capture, conns = _surface(seed, n)
    gp = global_optimize(pred, M=8)
    for kw in (dict(), dict(capture_conns=capture),
               dict(dc_rel=gp.dc_rel, capture_conns=capture,
                    gain_min=1.5, max_relay_conns=2),
               dict(max_candidates=1, min_direct=2)):
        got = plan_routes(pred, conns, **kw)
        want = ref.overlay.plan_routes(pred, conns, **kw)
        assert _routed_fields(got) == _routed_fields(want)
        assert got.signature() == want.signature()
        np.testing.assert_array_equal(got.expanded_conns(),
                                      want.expanded_conns())
        np.testing.assert_array_equal(got.routed_pred_bw(),
                                      want.routed_pred_bw())
        # conservation: the direct residue plus each relay's conns is
        # the plan's connection count of that pair
        d = np.asarray(got.direct)
        for i, _, j, cr in got.relays:
            assert d[i, j] + cr == conns[i, j]


if HAVE_HYPOTHESIS:
    @given(st.integers(0, 2 ** 31 - 1), st.integers(2, 8),
           st.floats(1.0, 4.0), st.integers(1, 6))
    @settings(max_examples=40, deadline=None)
    def test_property_plan_routes_equal_reference(seed, n, gain, max_relay):
        """Any surface, gain and relay bound: the port's plan equals the
        reference's, conserves each pair's connections and keeps at
        least one on the direct link."""
        import repro.overlay as ref_overlay
        pred, capture, conns = _surface(seed, n)
        kw = dict(gain_min=gain, max_relay_conns=max_relay,
                  capture_conns=capture)
        got = plan_routes(pred, conns, **kw)
        assert _routed_fields(got) == _routed_fields(
            ref_overlay.plan_routes(pred, conns, **kw))
        d = np.asarray(got.direct)
        for i, k, j, cr in got.relays:
            assert k not in (i, j) and 1 <= cr <= max_relay
            assert d[i, j] >= 1 and d[i, j] + cr == conns[i, j]


# ----------------------------------------------------------------------
# waterfill_routed physics
# ----------------------------------------------------------------------
def test_relay_flows_charged_on_both_hops(ref):
    """Relay connections contend on BOTH hop links: every pair sharing
    either hop loses credited BW when the relay shows up; the relayed
    pair's credit is the store-and-forward bottleneck."""
    sim = quiet_sim()
    direct = np.ones((sim.N, sim.N))
    base = sim.waterfill(direct)
    relays = [(1, 0, 2, 4)]
    routed = sim.waterfill_routed(direct, relays)
    assert routed[1, 0] < base[1, 0]         # hop i -> k contended
    assert routed[0, 2] < base[0, 2]         # hop k -> j contended
    expanded = direct.copy()
    expanded[1, 0] += 4
    expanded[0, 2] += 4
    rate = sim._fill_rates(sim._contending_conns(expanded, None), None)
    want = direct[1, 2] * rate[1, 2] + 4 * min(rate[1, 0], rate[0, 2])
    assert routed[1, 2] == pytest.approx(float(want))
    np.testing.assert_array_equal(
        routed, ref_quiet_sim(ref).waterfill_routed(direct, relays))


def test_relay_through_saturated_nic_buys_nothing(ref):
    """A detour through a DC whose NIC is already saturated cannot beat
    the direct path — the min-of-hop-rates credit collapses."""
    out = []
    for s in (quiet_sim(), ref_quiet_sim(ref)):
        for m in range(1, s.N):
            s.set_background(0, m, 10_000)
            s.set_background(m, 0, 10_000)
        direct = np.ones((s.N, s.N)) * 2
        plain = s.waterfill(direct)
        shifted = direct.copy()
        shifted[1, 2] = shifted[2, 1] = 1
        routed = s.waterfill_routed(shifted, [(1, 0, 2, 1), (2, 0, 1, 1)])
        assert routed[1, 2] <= plain[1, 2] * (1 + 1e-9)
        assert routed[2, 1] <= plain[2, 1] * (1 + 1e-9)
        out.append(routed)
    np.testing.assert_array_equal(out[0], out[1])


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_waterfill_routed_no_relays_equals_waterfill(backend):
    sim = quiet_sim(waterfill_backend=backend)
    conns = np.ones((sim.N, sim.N)) * 3
    assert np.array_equal(sim.waterfill_routed(conns, []),
                          sim.waterfill(conns))


def _random_routing(seed, n):
    rng = np.random.default_rng(seed)
    direct = rng.integers(1, 9, (n, n)).astype(np.float64)
    relays = []
    for _ in range(rng.integers(1, 5)):
        i, k, j = rng.choice(n, 3, replace=False)
        relays.append((int(i), int(k), int(j), int(rng.integers(1, 5))))
    # the skipped forms: a relay onto its own source and an empty one
    relays += [(0, 1, 0, 2), (1, 2, 3, 0)]
    return direct, relays


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_waterfill_routed_backends_equal_reference(ref, backend, seed):
    """Random routings on the 8-DC mesh (noisy weather advanced a few
    steps, cross-traffic on one link): the ``numpy`` backend equals the
    reference bit for bit, the ``torch`` backend (the kernel's plain
    version) within 1e-9 with the host loop's iteration count."""
    sims = [WanSimulator(seed=seed, waterfill_backend=backend),
            ref.simulator.WanSimulator(seed=seed)]
    for s in sims:
        for _ in range(seed + 1):
            s.advance()
        s.set_background(2, 5, 6.0)
    direct, relays = _random_routing(seed, sims[0].N)
    got = sims[0].waterfill_routed(direct, relays)
    want = sims[1].waterfill_routed(direct, relays)
    if backend == "numpy":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=FILL_TOL, atol=0)
        assert sims[0].last_fill_iters == sims[1].last_fill_iters


# ----------------------------------------------------------------------
# controller wiring and plan identity
# ----------------------------------------------------------------------
def _on_controller(mod_control, mod_pred, sim):
    return mod_control.WanifyController(
        sim=sim, predictor=mod_pred.SnapshotPredictor(), n_pods=4,
        cfg=mod_control.ControllerConfig(advance_sim=False), overlay="on")


def _port_on():
    import repro_torch.control as control
    import repro_torch.core.predictor as predictor
    sim = quiet_sim()
    return sim, _on_controller(control, predictor, sim)


def test_record_gains_relay_fields_only_when_on(ref):
    sim, ctl = _port_on()
    rec = ctl.record[-1]
    assert rec["overlay"] == "on"
    assert rec["relays"] == ctl.routed.relays
    assert rec["routed_signature"] == ctl.routed.signature()
    want = _on_controller(ref.control, ref.predictor, ref_quiet_sim(ref))
    assert ctl.record == want.record
    off = WanifyController(sim=quiet_sim(), predictor=SnapshotPredictor(),
                           n_pods=4, cfg=ControllerConfig(advance_sim=False))
    assert off.routed is None
    assert "overlay" not in off.record[-1]   # off-path records unchanged
    assert "relays" not in off.record[-1]


def test_cut_link_gets_relayed_on_replan(ref):
    sim, ctl = _port_on()
    rsim = ref_quiet_sim(ref)
    want = _on_controller(ref.control, ref.predictor, rsim)
    assert ctl.routed.relays == ()           # healthy: nothing to route
    assert ctl.current_routing() is None     # ... so direct execution
    i, j = sim.regions.index("us-west"), sim.regions.index("ap-south")
    for s, c in ((sim, ctl), (rsim, want)):
        s.set_link_factor(i, j, 0.02)
        c.replan(reason="cut")
    vias = {(s, d): k for s, k, d, _ in ctl.routed.relays}
    assert (i, j) in vias and (j, i) in vias
    assert vias[(i, j)] not in (i, j)
    direct, relays = ctl.current_routing()
    assert relays == ctl.routed.relays
    P = ctl.n_pods
    assert np.array_equal(direct[:P, :P], np.asarray(ctl.routed.direct))
    plan_c = np.asarray(ctl.plan.conns)
    for (s, d), k in vias.items():
        cr = dict(((a, b), c) for a, _, b, c in ctl.routed.relays)[(s, d)]
        assert ctl.routed.direct[s][d] + cr == plan_c[s, d]
    assert _routed_fields(ctl.routed) == _routed_fields(want.routed)
    w_direct, w_relays = want.current_routing()
    np.testing.assert_array_equal(direct, w_direct)
    assert relays == w_relays
    assert ctl.record == want.record


# ----------------------------------------------------------------------
# placement pricing on the routed surface
# ----------------------------------------------------------------------
def test_achievable_bw_prices_relay_credit(ref):
    pred = ((1e4, 500.0, 10.0), (500.0, 1e4, 10.0), (10.0, 10.0, 1e4))
    kw = dict(n_pods=3, conns=((1, 4, 6), (4, 1, 6), (6, 6, 1)),
              pred_bw=pred, compress_bits=(32, 32, 32))
    rkw = dict(n_pods=3, direct=((1, 4, 2), (4, 1, 6), (6, 6, 1)),
               relays=((0, 1, 2, 4),), pred_bw=pred)
    plan, routing = WanPlan(**kw), RoutedPlan(**rkw)
    base = achievable_bw(plan, knee=None)
    routed = achievable_bw(plan, knee=None, routing=routing)
    assert routed[0, 2] == pytest.approx(10.0 * 2 + 4 * min(500.0, 10.0))
    assert base[0, 2] == pytest.approx(10.0 * 6)
    kneed = achievable_bw(plan, knee=3.0, routing=routing)
    assert kneed[0, 2] == pytest.approx(10.0 * 2 + 3.0 * 10.0)
    with pytest.raises(ValueError):
        achievable_bw(plan, routing=RoutedPlan(
            n_pods=2, direct=((1, 1), (1, 1)), relays=(),
            pred_bw=((1.0, 1.0), (1.0, 1.0))))
    rplan = ref.plan.WanPlan(**kw)
    rrouting = ref.overlay.RoutedPlan(**rkw)
    for knee in (None, 3.0):
        np.testing.assert_array_equal(
            achievable_bw(plan, knee=knee, routing=routing),
            ref.cost.achievable_bw(rplan, knee=knee, routing=rrouting))


# ----------------------------------------------------------------------
# the pinned acceptance scenario
# ----------------------------------------------------------------------
def _reroute(engine_cls, spec, mode):
    eng = engine_cls(spec, seed=3, overlay=mode)
    relays_by_step = {}

    def hook(engine, row, relays_by_step=relays_by_step,
             ctl=eng.controller):
        relays_by_step[row.step] = (ctl.routed.relays
                                    if ctl.routed else ())
    eng.step_hook = hook
    return eng.run(), relays_by_step


@pytest.fixture(scope="module")
def reroute_runs(ref):
    """cable_cut_reroute at seed 3, direct-only vs routed, in both
    packages; relays captured per step via the engine hook."""
    return {(pkg, mode): _reroute(eng, get(
                "cable_cut_reroute"), mode)
            for pkg, eng, get in (
                ("port", ScenarioEngine, get_scenario),
                ("ref", ref.scenarios.ScenarioEngine,
                 ref.scenarios.get_scenario))
            for mode in ("off", "on")}


@pytest.mark.parametrize("mode", ["off", "on"])
def test_reroute_trace_equal_reference(reroute_runs, mode):
    """The whole ``to_json()`` of each run (the routed records' relays
    and signatures included) is the reference's, byte for byte, and so
    are the relays in force at every step."""
    got, got_relays = reroute_runs[("port", mode)]
    want, want_relays = reroute_runs[("ref", mode)]
    assert got.trace.to_json().encode() == want.trace.to_json().encode()
    assert got_relays == want_relays


def test_reroute_strictly_beats_direct_min_bw(reroute_runs):
    """From the first settled post-cut step the routed run's min
    achievable BW is strictly higher EVERY step, and the detours go
    through the healthy DCs."""
    (off, _), (on, relays) = reroute_runs[("port", "off")], \
        reroute_runs[("port", "on")]
    off_steps = {s.step: s for s in off.trace.steps}
    on_steps = {s.step: s for s in on.trace.steps}
    assert all(on_steps[k].achieved_min > off_steps[k].achieved_min
               for k in range(SETTLED, len(on_steps)))
    for k in range(SETTLED, len(on_steps)):
        assert relays[k] != ()
        assert all(via in (0, 3) for _, via, _, _ in relays[k])
    assert all(on_steps[k].achieved_min == off_steps[k].achieved_min
               for k in range(0, CUT))


def test_reroute_off_matches_default(reroute_runs):
    """overlay=None (the default gate) is byte-identical to an explicit
    off run — the gate introduces no routed code path."""
    (off, relays) = reroute_runs[("port", "off")]
    assert all(r == () for r in relays.values())
    default = run_scenario(get_scenario("cable_cut_reroute"), seed=3)
    assert default.trace.to_json().encode() == \
        off.trace.to_json().encode()


def test_reroute_obs_on_is_passive_and_spans_route(reroute_runs):
    """Span tracing on: the routed run's bytes are unchanged, and the
    relay search of every replan after construction (the tracer is
    installed once the controller's first plan exists) is a `route`
    span."""
    eng = ScenarioEngine(get_scenario("cable_cut_reroute"), seed=3,
                         overlay="on", obs="on")
    res = eng.run()
    on, _ = reroute_runs[("port", "on")]
    assert res.trace.to_json() == on.trace.to_json()
    stages = eng.tracer.by_stage()
    assert stages["route"]["count"] == len(eng.controller.record) - 1


@pytest.fixture(scope="module")
def placement_runs(ref):
    return {(pkg, mode): run(("cable_cut_reroute"), seed=3, overlay=mode)
            for pkg, run in (("port", run_placement_scenario),
                             ("ref", ref.pscen.run_placement_scenario))
            for mode in ("off", "on")}


@pytest.mark.parametrize("mode", ["off", "on"])
def test_reroute_placement_equal_reference(placement_runs, mode):
    """The routed placement run's trace (makespans, achieved BW,
    placements), its decisions and its summary are the reference's."""
    got, want = placement_runs[("port", mode)], placement_runs[("ref", mode)]
    assert got.trace.to_json() == want.trace.to_json()
    assert [vars(r) for r in got.records] == [vars(r) for r in want.records]
    assert got.summary() == want.summary()


def test_reroute_strictly_lowers_placement_makespan(placement_runs):
    off, on = placement_runs[("port", "off")], placement_runs[("port", "on")]
    off_total = sum(s.makespan_s for s in off.trace.steps)
    on_total = sum(s.makespan_s for s in on.trace.steps)
    assert on_total < off_total
    off_min = min(s.achieved_min for s in off.trace.steps
                  if s.step >= SETTLED)
    on_min = min(s.achieved_min for s in on.trace.steps
                 if s.step >= SETTLED)
    assert on_min > off_min


@pytest.mark.parametrize("key", OVERLAY_KEYS)
def test_plane_pin_equal_reference(ref, key):
    """The port's plane pins hold, and each is the reference's live run
    of the same key."""
    got = goldens.sha(goldens.overlay_runners()[key]())
    assert got == goldens.PLANE_PINS[key]
    if key.startswith("overlay/"):
        want = ref.scenarios.run_scenario(
            ref.scenarios.get_scenario("cable_cut_reroute"), seed=3,
            overlay="on").trace.to_json()
    else:
        want = ref.pscen.run_placement_scenario(
            "cable_cut_reroute", seed=3,
            overlay=key.split("overlay_")[1].split("/")[0]).trace.to_json()
    assert got == goldens.sha(want)


# ----------------------------------------------------------------------
# the routed fill on the water-fill kernel's path
# ----------------------------------------------------------------------
def _checked_fills(monkeypatch, dev):
    """Route the simulator's device fills through `fill_rates` on `dev`
    and re-run each on the host loop; returns the list the (iterations,
    host iterations, max |diff|) of every fill lands in."""
    seen = []
    real = wfk.fill_rates

    def fill(c, single, egress, ingress, w, path_cap, device=None):
        rate, iters, ok = real(c, single, egress, ingress, w, path_cap,
                               device=dev)
        want, w_iters, w_ok = fill_rates_host(
            c, single, egress, ingress, w, path_cap,
            wfk.max_fill_iters(c.shape[-1]))
        assert bool(ok) and w_ok
        seen.append((int(iters), int(w_iters),
                     float(np.abs(np.asarray(rate) - want).max())))
        return rate, iters, ok
    monkeypatch.setattr(wfk, "fill_rates", fill)
    return seen


def _fill_run(backend, mode):
    spec = get_scenario("cable_cut_reroute")
    spec = dataclasses.replace(
        spec, sim_kwargs=dict(spec.sim_kwargs, waterfill_backend=backend))
    eng = ScenarioEngine(spec, seed=3, overlay=mode)
    return eng, eng.run()


def test_routed_fills_within_kernel_limits_on_plain_version(monkeypatch):
    """With the overlay on and the ``torch`` fill backend, every fill
    of `cable_cut_reroute` (routed ones included: relays add up to
    `max_relay_conns` onto each hop) converges on the kernel's plain
    version with the host loop's iterations, well inside the kernel's
    `8·N²` cap, within 1e-9; every integer of the trace equals the
    numpy run's and the floats agree within rtol 1e-9."""
    seen = _checked_fills(monkeypatch, "cpu")
    eng, got = _fill_run("torch", "on")
    N = eng.sim.N
    assert N <= 32 and len(seen) == eng.sim.fill_calls
    assert all(it == w_it for it, w_it, _ in seen)
    assert max(it for it, _, _ in seen) < wfk.max_fill_iters(N)
    assert max(err for _, _, err in seen) <= FILL_TOL
    monkeypatch.undo()
    _, want = _fill_run("numpy", "on")
    for g, w in zip(got.trace.steps, want.trace.steps):
        assert (g.step, g.plan_sig, g.conns_total, g.replans) == \
            (w.step, w.plan_sig, w.conns_total, w.replans)
        np.testing.assert_allclose(g.achieved_min, w.achieved_min,
                                   rtol=FILL_TOL)
        np.testing.assert_allclose(g.achieved_mean, w.achieved_mean,
                                   rtol=FILL_TOL)


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["off", "on"])
def test_routed_fill_one_launch_per_fill_on_card(card, monkeypatch, mode):
    """`cable_cut_reroute` on ``waterfill_backend="cuda"``: one
    `waterfill` launch per fill, each within 1e-9 of the host loop with
    equal iterations; the relays and plan signatures equal the numpy
    run's."""
    seen = _checked_fills(monkeypatch, card)
    ops.fill_rates.launches = 0
    eng, got = _fill_run("cuda", mode)
    assert ops.fill_rates.launches == eng.sim.fill_calls == len(seen)
    assert all(it == w_it for it, w_it, _ in seen)
    assert max(err for _, _, err in seen) <= FILL_TOL
    monkeypatch.undo()
    _, want = _fill_run("numpy", mode)
    for g, w in zip(got.trace.steps, want.trace.steps):
        assert (g.plan_sig, g.conns_total, g.replans) == \
            (w.plan_sig, w.conns_total, w.replans)
        np.testing.assert_allclose(g.achieved_min, w.achieved_min,
                                   rtol=FILL_TOL)
