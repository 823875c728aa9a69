"""The port's placement (`repro_torch.placement`) against the JAX
reference's, module by module, on the same seeded inputs.

* `query`: the workload library and its validation, equal.
* `cost`: `estimate_cost`, `achievable_bw` and the batched numpy
  evaluator bit-equal to the reference's; the batch bit-equal to the
  scalar path; backend resolution (``jax`` raises naming ``torch``).
* The ``torch`` backend (the reference's jit `_eval_core` as tensor
  ops) on the host: costs within 1e-12 of numpy and every search
  decision equal; on a card (`cuda` marker), the same.
* `optimizer`: greedy and exhaustive decisions equal the reference's
  and `tests/data/placement_golden.json`; `search_many` equals the
  independent searches.
* `planner`: the records of every trigger, both backends, detaching,
  envelope pricing, equal to the reference's.
* The fleet's `job_planner`: deferred replans flushed through
  `search_many` in the tick's ``planners`` stage, records and planner
  records equal to the reference fleet's.
* `scenario`: `to_json()` byte-equal to the reference past the three
  pins (the pins themselves are `tests/test_torch_scenarios.py`'s).

The reference fleet imports `jax.experimental.enable_x64`, which jax
0.9 dropped; the module fixture installs a stand-in only when it is
missing (as `tests/test_torch_fleet.py` does). jax is imported only
there, never at module level, so the card test runs without it.
"""
import dataclasses
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import repro_torch.placement as pl
from repro_torch.control import (BudgetEnvelope, ControllerConfig,
                                 WanifyController)
from repro_torch.core.predictor import SnapshotPredictor
from repro_torch.placement.query import QuerySpec, Stage
from repro_torch.scenarios import ScenarioSpec, at
from repro_torch.scenarios.events import Rescale
from repro_torch.wan.monitor import egress_price_vector
from repro_torch.wan.simulator import WanSimulator

QUIET = dict(fluct_sigma=0.0, snapshot_sigma=0.0, runtime_sigma=0.0)
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "placement_golden.json")
FIELDS = ("makespan_s", "net_s", "compute_s", "egress_gb", "egress_usd",
          "instance_usd")
TORCH_RTOL = 1e-12        # the torch backend sums in other orders


@pytest.fixture(scope="module")
def ref():
    """The reference `repro.placement` and the modules around it."""
    import jax
    import jax.experimental
    shim = not hasattr(jax.experimental, "enable_x64")
    before = set(sys.modules)
    if shim:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    # by module name: a failed earlier import of `repro.fleet` in this
    # process leaves its submodules loaded but unbound on the package
    yield {key: importlib.import_module(name) for key, name in (
        ("pl", "repro.placement"), ("control", "repro.control"),
        ("pred", "repro.core.predictor"), ("fleet", "repro.fleet"),
        ("sim", "repro.wan.simulator"))}
    if shim:
        del jax.experimental.enable_x64
        for name in set(sys.modules) - before:
            if name == "repro" or name.startswith("repro."):
                del sys.modules[name]


def quiet_controller(n_pods=4, seed=0, **cfg):
    sim = WanSimulator(seed=seed, **QUIET)
    return WanifyController(sim, SnapshotPredictor(), n_pods=n_pods,
                            cfg=ControllerConfig(**cfg) if cfg else None)


def ref_controller(ref, n_pods=4, seed=0, **cfg):
    C = ref["control"]
    sim = ref["sim"].WanSimulator(seed=seed, **QUIET)
    return C.WanifyController(sim, ref["pred"].SnapshotPredictor(),
                              n_pods=n_pods,
                              cfg=C.ControllerConfig(**cfg) if cfg else None)


def plan_bw(n, seed=0):
    """Achievable BW + per-region egress prices at a quiet steady state."""
    ctl = quiet_controller(n, seed)
    return pl.achievable_bw(ctl.plan), egress_price_vector(
        ctl.sim.regions[:n])


def decision_key(d):
    return {"placement": [[repr(v) for v in row] for row in d.placement],
            "makespan_s": repr(d.cost.makespan_s),
            "egress_usd": repr(d.cost.egress_usd),
            "evals": d.evals}


def cost_key(c):
    """A cost's fields (either package's dataclass) as a plain tuple."""
    return dataclasses.astuple(c)


def records(planner):
    return [(r.step, r.reason, r.backend, r.makespan_est_s,
             r.egress_est_usd, r.placement) for r in planner.records]


# ----------------------------------------------------------------------
# query
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [3, 4, 8])
def test_workloads_equal_reference(ref, n):
    assert pl.workload_names() == ref["pl"].workload_names()
    for name in pl.workload_names():
        a, b = pl.get_workload(name, n), ref["pl"].get_workload(name, n)
        assert (a.name, a.input_gb, a.compute_speed) == \
            (b.name, b.input_gb, b.compute_speed)
        assert [vars(s) for s in a.stages] == [vars(s) for s in b.stages]
    for skew in (1.0, 2.0, 3.5):
        assert pl.skewed_partitions(n, 60.0, skew) == \
            ref["pl"].skewed_partitions(n, 60.0, skew)


def test_query_validation():
    with pytest.raises(ValueError):
        QuerySpec("bad", (10.0,), (Stage("s", 1.0, 1.0),))
    with pytest.raises(ValueError):
        QuerySpec("bad", (10.0, 10.0), ())
    with pytest.raises(ValueError):
        QuerySpec("bad", (10.0, 10.0), (Stage("s", 1.0, 1.0),),
                  compute_speed=(1.0,))
    with pytest.raises(ValueError):
        QuerySpec("bad", (10.0, -1.0), (Stage("s", 1.0, 1.0),))
    with pytest.raises(KeyError):
        pl.get_workload("nope", 4)


# ----------------------------------------------------------------------
# cost
# ----------------------------------------------------------------------
def test_estimate_cost_hand_example():
    q = QuerySpec("hand", input_gb=(16.0, 0.0),
                  stages=(Stage("map", out_ratio=0.5, compute_s_per_gb=1.0),
                          Stage("red", out_ratio=1.0,
                                compute_s_per_gb=2.0)))
    bw = np.array([[10000.0, 100.0], [100.0, 10000.0]])
    c = pl.estimate_cost(q, np.array([[0.0, 1.0]]), bw,
                         egress_usd_per_gb=0.1)
    assert (c.compute_s, c.net_s, c.makespan_s) == (32.0, 80.0, 112.0)
    assert c.egress_gb == pytest.approx(1.0)
    assert c.egress_usd == pytest.approx(0.1)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_estimate_cost_and_batch_equal_reference(ref, n):
    """The scalar cost, the numpy batch, and the scalar backend are
    bit-equal to the reference's on random placements."""
    rng = np.random.default_rng(n)
    bw, price = plan_bw(n)
    for name in pl.workload_names():
        q, rq = pl.get_workload(name, n), ref["pl"].get_workload(name, n)
        P = rng.dirichlet(np.ones(n), size=(16, q.n_shuffles()))
        for backend in ("numpy", "scalar"):
            a = pl.estimate_cost_batch(q, P, bw, egress_usd_per_gb=price,
                                       backend=backend)
            b = ref["pl"].estimate_cost_batch(rq, P, bw,
                                              egress_usd_per_gb=price,
                                              backend=backend)
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for p in P[:4]:
            assert cost_key(pl.estimate_cost(
                q, p, bw, egress_usd_per_gb=price)) == cost_key(
                ref["pl"].estimate_cost(rq, p, bw, egress_usd_per_gb=price))


def test_batch_matches_scalar_named_workloads():
    rng = np.random.default_rng(0)
    for name in pl.workload_names():
        for n in (3, 4, 8):
            bw, price = plan_bw(n)
            q = pl.get_workload(name, n)
            P = rng.dirichlet(np.ones(n), size=(32, q.n_shuffles()))
            batch = pl.estimate_cost_batch(q, P, bw, egress_usd_per_gb=price)
            for m, p in enumerate(P):
                want = pl.estimate_cost(q, p, bw, egress_usd_per_gb=price)
                for f in FIELDS:
                    assert getattr(batch, f)[m] == getattr(want, f), (f, m)


def test_achievable_bw_equal_reference(ref):
    """Capture-point scaling, the knee, an envelope cap and a routing
    surface (duck-typed: the overlay is not yet ported) equal the
    reference's bit for bit."""
    ctl, rctl = quiet_controller(), ref_controller(ref)
    rng = np.random.default_rng(1)
    cap = np.where(rng.random((4, 4)) < 0.5,
                   rng.uniform(20, 400, (4, 4)), np.inf)
    capture = rng.integers(1, 9, (4, 4)).astype(float)

    class Routing:
        n_pods = 4
        direct = np.maximum(np.asarray(ctl.plan.conns, float) - 1, 0)
        relays = ((0, 2, 1, 3), (3, 1, 0, 12))
    for kw in (dict(), dict(knee=None), dict(link_cap=cap),
               dict(capture_conns=capture), dict(routing=Routing()),
               dict(capture_conns=capture, link_cap=cap, knee=4.0,
                    routing=Routing())):
        np.testing.assert_array_equal(
            pl.achievable_bw(ctl.plan, **kw),
            ref["pl"].achievable_bw(rctl.plan, **kw))
    with pytest.raises(ValueError):
        pl.achievable_bw(ctl.plan, link_cap=np.ones((3, 3)))


def test_backend_resolution(monkeypatch):
    q = pl.get_workload("scan_agg", 4)
    bw = np.full((4, 4), 300.0)
    with pytest.raises(ValueError):
        pl.estimate_cost_batch(q, np.ones((2, 1, 3)) / 3, bw)
    with pytest.raises(ValueError):          # fractions must sum to 1
        pl.estimate_cost_batch(q, np.full((2, 1, 4), 0.3), bw)
    assert pl.PLACEMENT_BACKENDS == ("numpy", "torch", "scalar")
    with pytest.raises(ValueError, match="'torch'"):
        pl.placement_backend("jax")
    with pytest.raises(ValueError, match="'torch'"):
        pl.estimate_cost_batch(q, np.full((1, 1, 4), 0.25), bw,
                               backend="jax")
    with pytest.raises(ValueError):
        pl.placement_backend("cuda")
    assert pl.placement_backend() == "numpy"
    monkeypatch.setenv("REPRO_PLACEMENT_BACKEND", "scalar")
    assert pl.placement_backend() == "scalar"
    monkeypatch.setenv("REPRO_PLACEMENT_BACKEND", "torch")
    assert pl.placement_backend() == "torch"
    empty = pl.estimate_cost_batch(q, np.zeros((0, 1, 4)), bw)
    assert len(empty) == 0


def test_torch_backend_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = pl.get_workload("scan_agg", 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pl.estimate_cost_batch(q, np.full((1, 1, 4), 0.25),
                               np.full((4, 4), 300.0), backend="torch")


@pytest.mark.parametrize("n", [3, 4, 8])
def test_torch_backend_costs_near_numpy(n):
    """The torch backend on the host: every metric within 1e-12 of
    numpy, shared and per-candidate inputs alike."""
    rng = np.random.default_rng(10 + n)
    bw, price = plan_bw(n)
    for name in pl.workload_names():
        q = pl.get_workload(name, n)
        P = rng.dirichlet(np.ones(n), size=(40, q.n_shuffles()))
        a = pl.estimate_cost_batch(q, P, bw, egress_usd_per_gb=price)
        b = pl.estimate_cost_batch(q, P, bw, egress_usd_per_gb=price,
                                   backend="torch", device="cpu")
        for f in FIELDS:
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=TORCH_RTOL, atol=0)


# ----------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_search_decisions_match_goldens(backend):
    """Greedy and exhaustive decisions (placement, cost, eval count)
    byte-equal to the reference's pinned scalar search
    (tests/data/placement_golden.json) on every named workload at N in
    {3, 4, 8}, on both array backends."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    for name in pl.workload_names():
        for n in (3, 4, 8):
            bw, price = plan_bw(n)
            q = pl.get_workload(name, n)
            g = pl.greedy_place(q, bw, egress_usd_per_gb=price,
                                backend=backend, device="cpu")
            assert decision_key(g) == golden[f"greedy/{name}/{n}"], \
                (backend, name, n)
            if n <= 4:
                e = pl.exhaustive_place(q, bw, egress_usd_per_gb=price,
                                        levels=4, backend=backend,
                                        device="cpu")
                assert decision_key(e) == \
                    golden[f"exhaustive/{name}/{n}"], (backend, name, n)


def test_greedy_equals_reference_under_knobs(ref):
    ctl = quiet_controller()
    bw = pl.achievable_bw(ctl.plan)
    for name in pl.workload_names():
        q, rq = pl.get_workload(name, 4), ref["pl"].get_workload(name, 4)
        for kw in (dict(), dict(coarse=0, fine=0), dict(coarse=0.1, fine=0),
                   dict(coarse=0, fine=0.05), dict(rel_tol=0.05)):
            a = pl.greedy_place(q, bw, **kw)
            b = ref["pl"].greedy_place(rq, bw, **kw)
            assert decision_key(a) == decision_key(b), (name, kw)
    e = pl.exhaustive_place(pl.scan_agg(3), np.full((3, 3), 400.0), levels=6)
    re_ = ref["pl"].exhaustive_place(ref["pl"].scan_agg(3),
                                     np.full((3, 3), 400.0), levels=6)
    assert decision_key(e) == decision_key(re_)
    with pytest.raises(ValueError):
        pl.exhaustive_place(pl.scan_agg(5), np.full((5, 5), 400.0))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_search_many_matches_independent_searches(backend):
    rng = np.random.default_rng(2)
    tasks, solo = [], []
    for i, name in enumerate(("scan_agg", "scan_agg", "two_stage_join",
                              "iterative")):
        n = 4 if i < 3 else 3           # mixed shapes force 2 groups
        kw = dict(query=pl.get_workload(name, n),
                  bw=rng.uniform(40.0, 900.0, (n, n)),
                  egress_usd_per_gb=rng.uniform(0.02, 0.1, n))
        tasks.append(pl.SearchTask(**kw))
        solo.append(pl.greedy_place(kw["query"], kw["bw"],
                                    egress_usd_per_gb=kw["egress_usd_per_gb"]))
    fused = pl.search_many(tasks, backend=backend, device="cpu")
    for d, s in zip(fused, solo):
        assert d.placement == s.placement and d.evals == s.evals
        assert d.cost == s.cost
    with pytest.raises(ValueError, match="already ran"):
        pl.search_many(tasks[:1])


# ----------------------------------------------------------------------
# planner
# ----------------------------------------------------------------------
def test_planner_triggers_equal_reference(ref):
    """init, explicit, topology and periodic triggers re-place with the
    reference's records; the static backend places once."""
    out = []
    for ctl, P in ((quiet_controller(), pl),
                   (ref_controller(ref), ref["pl"])):
        wan = P.PlacementPlanner(ctl, P.two_stage_join(4))
        static = P.PlacementPlanner(ctl, P.two_stage_join(4),
                                    backend="static")
        ctl.replan(reason="explicit")
        ctl.topology_changed()
        ctl.replan(reason="periodic", step=7)
        out.append((records(wan), records(static),
                    wan.exec_conns().tolist(), static.exec_conns().tolist(),
                    cost_key(wan.estimated()), wan.priced_bw().tolist()))
    assert out[0] == out[1]
    assert [r[1] for r in out[0][0]] == ["init", "explicit", "topology",
                                         "periodic"]
    assert len(out[0][1]) == 1


def test_planner_detach_and_validation():
    ctl = quiet_controller()
    planner = pl.PlacementPlanner(ctl, pl.scan_agg(4))
    planner.detach()
    ctl.replan(reason="explicit")
    assert [r.reason for r in planner.records] == ["init"]
    fresh = pl.PlacementPlanner(ctl, pl.scan_agg(4))
    ctl.replan(reason="explicit")
    assert len(fresh.records) == 2
    with pytest.raises(ValueError):
        pl.PlacementPlanner(ctl, pl.scan_agg(3))
    with pytest.raises(ValueError):
        pl.PlacementPlanner(ctl, pl.scan_agg(4), backend="nope")
    with pytest.raises(ValueError, match="no deferred"):
        fresh.commit(None)


def test_envelope_prices_fair_share_equal_reference(ref):
    out = []
    for ctl, P, Env in ((quiet_controller(), pl, BudgetEnvelope),
                        (ref_controller(ref), ref["pl"],
                         ref["control"].BudgetEnvelope)):
        free = P.PlacementPlanner(ctl, P.scan_agg(4))
        est_free = free.estimated()
        ctl.set_envelope(Env(max_conns=4, link_cap=np.full((4, 4), 40.0)))
        ctl.replan(reason="envelope")
        capped = P.PlacementPlanner(ctl, P.scan_agg(4))
        out.append((cost_key(est_free), cost_key(capped.estimated()),
                    capped.priced_bw().tolist(), records(free)))
    assert out[0] == out[1]
    off = ~np.eye(4, dtype=bool)
    assert (np.asarray(out[0][2])[off] <= 40.0 + 1e-9).all()
    assert out[0][1][0] > out[0][0][0]              # makespan


def test_priced_bw_tracks_waterfill_ground_truth():
    sim = WanSimulator(seed=1, **QUIET)
    ctl = WanifyController(sim, SnapshotPredictor(), n_pods=4)
    for _ in range(3):
        ctl.replan(reason="periodic")
    planner = pl.PlacementPlanner(ctl, pl.scan_agg(4))
    full = np.ones((sim.N, sim.N))
    full[:4, :4] = planner.exec_conns()
    achieved = sim.waterfill(full)[:4, :4]
    off = ~np.eye(4, dtype=bool)
    ratio = planner.priced_bw()[off] / achieved[off]
    assert (ratio > 0.7).all() and (ratio < 1.5).all()


# ----------------------------------------------------------------------
# the fleet's deferred planners
# ----------------------------------------------------------------------
FLEET_JOBS = (("hi", (0, 1, 2, 3), 4.0), ("lo", (0, 1, 2, 3), 1.0),
              ("mid", (2, 3, 4, 5), 2.0))


def _fleet(F, sim_mod, device=None, obs=None):
    jobs = tuple(F.JobSpec(n, dcs=d, priority=p) for n, d, p in FLEET_JOBS)
    pred = F.BatchedRfPredictor(F.default_fleet_forest()) if device is None \
        else F.BatchedRfPredictor(F.default_fleet_forest(), device=device)
    return F.FleetController(sim_mod.WanSimulator(seed=0, **QUIET), pred,
                             m_total=8, jobs=jobs, obs=obs)


def test_fleet_planners_flush_equal_reference(ref, monkeypatch):
    """Three jobs' planners, deferred: every tick's replans flush through
    ONE `search_many` call; tick records and planner records equal the
    reference fleet's, a detached planner is pruned, and a departed
    job's planner goes with it."""
    import repro_torch.fleet as F
    import repro_torch.placement.optimizer as opt
    import repro_torch.wan.simulator as S
    port = _fleet(F, S, device="cpu")
    want = _fleet(ref["fleet"], ref["sim"])
    planners = []
    for fleet, P in ((port, pl), (want, ref["pl"])):
        fleet.tick()
        planners.append({n: fleet.job_planner(n, P.get_workload(w, 4))
                         for n, w in (("hi", "scan_agg"),
                                      ("lo", "scan_agg"),
                                      ("mid", "two_stage_join"))})
    calls = []
    real = opt.search_many

    def counted(tasks, *a, **kw):
        calls.append(len(tasks))
        return real(tasks, *a, **kw)
    monkeypatch.setattr(opt, "search_many", counted)
    for _ in range(3):
        a, b = port.tick(), want.tick()
        assert a == b
    assert calls == [3, 3, 3]
    for name in planners[0]:
        assert records(planners[0][name]) == records(planners[1][name])
        assert len(planners[0][name].records) == 4
    planners[0]["lo"].detach()
    port.tick()
    assert calls[-1] == 2 and [n for n, _ in port._planners] == ["hi", "mid"]
    port.remove_job("mid")
    assert [n for n, _ in port._planners] == ["hi"]


def test_fleet_low_priority_prices_less():
    import repro_torch.fleet as F
    import repro_torch.wan.simulator as S
    fleet = _fleet(F, S, device="cpu")
    fleet.tick()
    hi = fleet.job_planner("hi", pl.scan_agg(4))
    lo = fleet.job_planner("lo", pl.scan_agg(4))
    off = ~np.eye(4, dtype=bool)
    assert lo.priced_bw()[off].min() < hi.priced_bw()[off].min()
    assert lo.estimated().makespan_s > hi.estimated().makespan_s


def test_fleet_planners_span():
    """With span tracing on, each tick has one ``planners`` stage."""
    import repro_torch.fleet as F
    import repro_torch.wan.simulator as S
    fleet = _fleet(F, S, device="cpu", obs="on")
    fleet.job_planner("hi", pl.scan_agg(4))
    for _ in range(2):
        fleet.tick()
    assert fleet.tracer.by_stage()["planners"]["count"] == 2


# ----------------------------------------------------------------------
# scenario runs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("scen,query,seed,backend", [
    ("link_flap", "two_stage_join", 0, "wanify"),
    ("link_flap", "two_stage_join", 0, "static"),
    ("cable_cut", "iterative", 1, "wanify"),
    ("congestion", "scan_agg", 2, "wanify")])
def test_placement_scenario_equal_reference(ref, scen, query, seed, backend):
    """`to_json()` byte-equal to the reference's past the pinned runs,
    and the same planner records."""
    got = pl.run_placement_scenario(scen, query=pl.get_workload(query, 4),
                                    seed=seed, backend=backend)
    want = ref["pl"].run_placement_scenario(
        scen, query=ref["pl"].get_workload(query, 4), seed=seed,
        backend=backend)
    assert got.trace.to_json() == want.trace.to_json()
    assert [vars(r) for r in got.records] == [vars(r) for r in want.records]
    assert got.summary() == want.summary()


def test_compare_backends_equal_reference(ref):
    got = pl.compare_backends("skew_ramp", query=pl.two_stage_join(4), seed=0)
    want = ref["pl"].compare_backends(
        "skew_ramp", query=ref["pl"].two_stage_join(4), seed=0)
    assert got == want
    assert got["wanify"]["makespan_total_s"] < \
        got["static"]["makespan_total_s"]


def test_rescale_and_overlay_rejected(ref):
    """A rescaling timeline is rejected; the overlay is ported: a
    placement run with it on prices and executes the routed surface
    (here `steady`, which routes nothing) as the reference does."""
    spec = ScenarioSpec(name="bad", steps=5,
                        events=(at(2, Rescale(n_pods=6)),),
                        sim_kwargs=dict(QUIET))
    with pytest.raises(ValueError):
        pl.run_placement_scenario(spec, query=pl.scan_agg(4))
    got = pl.run_placement_scenario("steady", overlay="on")
    want = ref["pl"].run_placement_scenario("steady", overlay="on")
    assert got.trace.to_json() == want.trace.to_json()
    assert got.trace.to_json() == \
        pl.run_placement_scenario("steady", overlay="off").trace.to_json()


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_torch_backend_on_card_decides_as_numpy(card):
    """The torch backend on the card: the greedy and exhaustive
    decisions equal numpy's on every named workload; costs within
    1e-12."""
    for name in pl.workload_names():
        for n in (3, 4, 8):
            bw, price = plan_bw(n)
            q = pl.get_workload(name, n)
            a = pl.greedy_place(q, bw, egress_usd_per_gb=price)
            b = pl.greedy_place(q, bw, egress_usd_per_gb=price,
                                backend="torch", device=card)
            assert decision_key(a) == decision_key(b), (name, n)
            P = np.random.default_rng(n).dirichlet(
                np.ones(n), size=(64, q.n_shuffles()))
            x = pl.estimate_cost_batch(q, P, bw, egress_usd_per_gb=price)
            y = pl.estimate_cost_batch(q, P, bw, egress_usd_per_gb=price,
                                       backend="torch", device=card)
            for f in FIELDS:
                np.testing.assert_allclose(getattr(y, f), getattr(x, f),
                                           rtol=TORCH_RTOL, atol=0)
