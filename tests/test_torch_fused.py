"""The port's fused fleet tick (`repro_torch.fleet.fused`) against the
JAX reference's live fused program and against the port's own
sequential tick.

* Each stage function against its ``*_jnp`` twin on the same seeded
  numpy inputs, with the reference's own tolerances
  (`tests/test_fused_tick.py`): relations, integer ranges, budgets and
  AIMD conns exact; floats within 1e-12, the throttle within 1e-9. The
  stages take leading batch dimensions; a batched call equals its
  matrices one by one.
* `run_fused` against the reference's `run_fused` and against the
  port's sequential ticks with `_rows_match`'s rules (ints exact,
  floats 1e-6): plain, under the four WAN events, and with skew plus
  fluctuation; the state written back continues sequentially.
* `sweep` against single runs, the contract's refusals, memoization,
  and a forced divergence naming the tick.
* On a card (`cuda` marker): the fused run through the kernels against
  the same run on the host's plain versions.

The reference fleet imports `jax.experimental.enable_x64`, which jax
0.9 dropped; the module fixture installs a stand-in only when it is
missing (as `tests/test_torch_fleet.py` does). jax is imported only
there, never at module level, so the card tests run without it.
"""
import importlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.global_opt import _pair_weights
from repro_torch.fleet import (BatchedRfPredictor, FleetController,
                               FusedFleet, JobSpec, default_fleet_forest,
                               make_schedule)
from repro_torch.fleet.fused import (aimd_step_torch,
                                     connection_budgets_torch,
                                     global_ranges_torch, link_shares_torch,
                                     relations_torch, split_budget_torch)
from repro_torch.kernels import ops
from repro_torch.scenarios.events import (CrossTraffic, DiurnalCycle,
                                          JobArrive, LinkDegrade,
                                          LinkRestore, at)
from repro_torch.wan.simulator import WanSimulator, WaterfillDivergence

QUIET = dict(fluct_sigma=0.0, snapshot_sigma=0.0, runtime_sigma=0.0,
             host_sigma=0.0)
JOBS = (("serving", (0, 1, 2, 3), 4.0), ("training", (0, 1, 4, 5), 2.0),
        ("batch", (2, 3, 6, 7), 1.0))
SKEW_JOBS = (("a", (0, 1, 2, 3), 2.0, (2.0, 1.0, 1.0, 0.5)),
             ("b", (2, 3, 4, 5), 1.0, None))


def _specs(js, jobs=JOBS):
    return tuple(js(j[0], dcs=j[1], priority=j[2],
                    skew_w=j[3] if len(j) > 3 else None) for j in jobs)


def _events(S):
    """The reference test's four WAN events, in either package's DSL."""
    return (S.at(1, S.LinkDegrade(("us-east", "us-west"), 0.3)),
            S.at(2, S.CrossTraffic(("us-east", "eu-west"), conns=32)),
            S.at(3, S.DiurnalCycle(amplitude=0.2, period=6)),
            S.at(4, S.LinkRestore(("us-east", "us-west"))))


@pytest.fixture(scope="module")
def ref():
    """The reference modules (`repro.fleet`, its fused stages, the
    numpy stages they port, the event DSL) and jax's x64 context."""
    import jax
    import jax.experimental
    shim = not hasattr(jax.experimental, "enable_x64")
    before = set(sys.modules)
    if shim:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    import jax.numpy as jnp
    # by module name: a failed earlier import of `repro.fleet` in this
    # process leaves its submodules loaded but unbound on the package
    mods = {key: importlib.import_module(name) for key, name in (
        ("fleet", "repro.fleet"), ("fused", "repro.fleet.fused"),
        ("arbiter", "repro.fleet.arbiter"),
        ("events", "repro.scenarios.events"),
        ("sim", "repro.wan.simulator"))}
    yield dict(mods, jnp=jnp, x64=jax.experimental.enable_x64)
    if shim:
        del jax.experimental.enable_x64
        for name in set(sys.modules) - before:
            if name == "repro" or name.startswith("repro."):
                del sys.modules[name]


def build_fleet(seed=3, jobs=JOBS, m_total=8, device="cpu", **sim_kw):
    kw = dict(QUIET)
    kw.update(sim_kw)
    return FleetController(
        WanSimulator(seed=seed, **kw),
        BatchedRfPredictor(default_fleet_forest(), device=device),
        m_total=m_total, jobs=_specs(JobSpec, jobs))


def build_ref_fleet(ref, seed=3, jobs=JOBS, m_total=8, **sim_kw):
    kw = dict(QUIET)
    kw.update(sim_kw)
    F = ref["fleet"]
    return F.FleetController(
        ref["sim"].WanSimulator(seed=seed, **kw),
        F.BatchedRfPredictor(F.default_fleet_forest()),
        m_total=m_total, jobs=_specs(F.JobSpec, jobs))


def random_bw(rng, n):
    bw = rng.uniform(60.0, 2200.0, (n, n))
    bw = (bw + bw.T) / 2
    np.fill_diagonal(bw, 10000.0)
    return bw


def t64(a):
    return torch.from_numpy(np.asarray(a, np.float64))


# ----------------------------------------------------------------------
# stage-by-stage parity with the *_jnp twins
# ----------------------------------------------------------------------
def test_relations_exact(ref):
    rng = np.random.default_rng(0)
    jnp, fz = ref["jnp"], ref["fused"]
    with ref["x64"]():
        for trial in range(40):
            n = int(rng.integers(2, 9))
            bw = random_bw(rng, n)
            if trial % 3 == 0:                  # force near-duplicates
                bw[0, 1] = bw[1, 0] = bw[1 % n, 0] + rng.uniform(0, 150)
            D = float(rng.uniform(10, 300))
            want = np.asarray(fz.relations_jnp(jnp.asarray(bw), D))
            got = relations_torch(t64(bw), D)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_relations_ties_and_batch(ref):
    """Exact ties (searchsorted's left side) and values past the kept
    set (the +inf padding), batched: a [B, n, n] call equals its
    matrices one by one and the reference on each."""
    jnp, fz = ref["jnp"], ref["fused"]
    rng = np.random.default_rng(9)
    mats = []
    for _ in range(6):
        bw = np.round(random_bw(rng, 5) / 250.0) * 250.0   # many ties
        np.fill_diagonal(bw, 10000.0)
        mats.append(bw)
    batch = np.stack(mats)
    got = relations_torch(t64(batch), 100.0).numpy()
    with ref["x64"]():
        for b, bw in enumerate(mats):
            want = np.asarray(fz.relations_jnp(jnp.asarray(bw), 100.0))
            np.testing.assert_array_equal(got[b], want)
            np.testing.assert_array_equal(
                relations_torch(t64(bw), 100.0).numpy(), want)


def test_global_ranges_exact(ref):
    """Eq. 2-3 + throttle + link-cap clamp: integer ranges exact,
    continuous outputs to the reference's tolerances."""
    rng = np.random.default_rng(1)
    jnp, fz = ref["jnp"], ref["fused"]
    with ref["x64"]():
        for trial in range(25):
            n = int(rng.integers(2, 7))
            bw = random_bw(rng, n)
            M = int(rng.integers(2, 16))
            skew = rng.uniform(0.5, 3.0, n) if trial % 2 else None
            ws = _pair_weights(n, skew)
            link_cap = np.where(rng.random((n, n)) < 0.4,
                                rng.uniform(100, 3000, (n, n)), np.inf)
            want = fz.global_ranges_jnp(jnp.asarray(bw),
                                        jnp.asarray(float(M)),
                                        jnp.asarray(ws),
                                        jnp.asarray(link_cap))
            got = global_ranges_torch(t64(bw), torch.tensor(float(M)),
                                      t64(ws), t64(link_cap))
            for k in ("min_cons", "max_cons"):
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
            for k in ("min_bw", "max_bw", "unit_bw"):
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), rtol=1e-12)
            np.testing.assert_allclose(got["throttle"].numpy(),
                                       np.asarray(want["throttle"]),
                                       rtol=1e-9)


def test_global_ranges_batched_equals_single():
    rng = np.random.default_rng(5)
    J, n = 4, 4
    bw = np.stack([random_bw(rng, n) for _ in range(2 * J)]).reshape(
        2, J, n, n)
    M = np.array([[2.0, 3.0, 5.0, 8.0], [8.0, 1.0, 4.0, 2.0]])
    ws = np.stack([_pair_weights(n, rng.uniform(0.5, 3.0, n))
                   for _ in range(J)])
    cap = np.where(rng.random((2, J, n, n)) < 0.4,
                   rng.uniform(100, 3000, (2, J, n, n)), np.inf)
    got = global_ranges_torch(t64(bw), t64(M), t64(ws), t64(cap))
    for b in range(2):
        for j in range(J):
            one = global_ranges_torch(t64(bw[b, j]), t64(M[b, j]),
                                      t64(ws[j]), t64(cap[b, j]))
            for k in one:
                np.testing.assert_array_equal(got[k][b, j].numpy(),
                                              one[k].numpy())


def test_split_budget_exact(ref):
    rng = np.random.default_rng(2)
    jnp, fz = ref["jnp"], ref["fused"]
    with ref["x64"]():
        for _ in range(40):
            J = int(rng.integers(1, 9))
            m = int(rng.integers(1, 33))
            w = rng.choice([1.0, 2.0, 4.0, 8.0], J)
            present = rng.random(J) < 0.7
            want = np.asarray(fz.split_budget_jnp(m, jnp.asarray(w),
                                                  jnp.asarray(present)))
            got = split_budget_torch(m, t64(w), torch.from_numpy(present))
            np.testing.assert_array_equal(got.numpy(), want)


def test_split_budget_batched_rows_repay_independently():
    """Rows of a batch whose repayment loops run for different counts
    each stop at their own end."""
    rng = np.random.default_rng(6)
    w = rng.choice([1.0, 2.0, 4.0, 8.0], 7)
    present = rng.random((12, 7)) < 0.8
    for m in (3, 5, 8):
        got = split_budget_torch(m, t64(w), torch.from_numpy(present))
        for r in range(len(present)):
            one = split_budget_torch(m, t64(w), torch.from_numpy(present[r]))
            np.testing.assert_array_equal(got[r].numpy(), one.numpy())


def test_arbiter_ports_exact(ref):
    rng = np.random.default_rng(3)
    jnp, fz = ref["jnp"], ref["fused"]
    with ref["x64"]():
        for _ in range(15):
            J, n = int(rng.integers(1, 7)), 8
            presence = rng.random((J, n)) < 0.5
            presence[:, 0] = True                # nobody floats free
            w = rng.choice([1.0, 2.0, 4.0], J)
            cap = rng.uniform(100, 5000, (n, n))
            want_b = np.asarray(fz.connection_budgets_jnp(
                jnp.asarray(presence), jnp.asarray(w), 8))
            got_b = connection_budgets_torch(torch.from_numpy(presence),
                                             t64(w), 8)
            np.testing.assert_array_equal(got_b.numpy(), want_b)
            np.testing.assert_array_equal(
                got_b.numpy(),
                ref["arbiter"].connection_budgets(presence, w, 8))
            want_c = np.asarray(fz.link_shares_jnp(
                jnp.asarray(presence), jnp.asarray(w), jnp.asarray(cap)))
            got_c = link_shares_torch(torch.from_numpy(presence), t64(w),
                                      t64(cap))
            np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-12)
            # batched caps: [B, N, N] -> [B, J, N, N]
            two = link_shares_torch(torch.from_numpy(presence), t64(w),
                                    t64(np.stack([cap, 2 * cap])))
            np.testing.assert_array_equal(two[0].numpy(), got_c.numpy())


def test_aimd_exact(ref):
    """Every source row stepped at once == the reference twin, over
    four epochs of random monitored BW."""
    rng = np.random.default_rng(4)
    jnp, fz = ref["jnp"], ref["fused"]
    from repro_torch.core.global_opt import global_optimize
    with ref["x64"]():
        for _ in range(10):
            n = int(rng.integers(2, 7))
            plan = global_optimize(random_bw(rng, n), M=8)
            cons = np.asarray(plan.max_cons, np.int32)
            target = np.minimum(plan.max_bw, plan.throttle)
            np.fill_diagonal(cons, 1)
            arrays = {"min_cons": plan.min_cons, "max_cons": plan.max_cons,
                      "min_bw": plan.min_bw, "max_bw": plan.max_bw,
                      "unit_bw": plan.pred_bw, "throttle": plan.throttle}
            r_j = {k: jnp.asarray(v, jnp.int32 if "cons" in k else None)
                   for k, v in arrays.items()}
            r_t = {k: torch.from_numpy(np.asarray(
                v, np.int32 if "cons" in k else np.float64))
                for k, v in arrays.items()}
            c_j, t_j = jnp.asarray(cons), jnp.asarray(target)
            c_t, t_t = torch.from_numpy(cons), t64(target)
            for _step in range(4):
                mon = rng.uniform(0, 3000, (n, n))
                c_j, t_j = fz.aimd_step_jnp(c_j, t_j, r_j, jnp.asarray(mon))
                c_t, t_t = aimd_step_torch(c_t, t_t, r_t, t64(mon))
                assert c_t.dtype == torch.int32
                np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
                np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j),
                                           rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------------
# whole-loop equivalence
# ----------------------------------------------------------------------
def _rows_match(seq_row, fus_row, tol=1e-6):
    assert seq_row["name"] == fus_row["name"]
    assert seq_row["budget"] == fus_row["budget"]
    assert seq_row["conns_total"] == fus_row["conns_total"]
    for k in ("cap_min", "achieved_min", "achieved_mean"):
        a, b = seq_row[k], fus_row[k]
        assert a == b or np.isclose(a, b, rtol=tol, atol=tol), (k, a, b)


def _records_match(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a["tick"] == b["tick"] and a["n_jobs"] == b["n_jobs"]
        for ra, rb in zip(a["jobs"], b["jobs"]):
            _rows_match(ra, rb)


def _state_match(a, b):
    """Two fleets' live controllers: conns equal, targets within 1e-6."""
    for name in a.jobs:
        ca, cb = a.jobs[name].controller, b.jobs[name].controller
        np.testing.assert_array_equal(ca.current_conns(), cb.current_conns())
        np.testing.assert_allclose(
            np.stack([ag.target_bw for ag in ca._agents]),
            np.stack([ag.target_bw for ag in cb._agents]),
            rtol=1e-6, atol=1e-6)


CASES = {"plain": dict(steps=4, jobs=JOBS, sim={}, events=False),
         "events": dict(steps=6, jobs=JOBS, sim={}, events=True),
         "skew_fluct": dict(steps=3, jobs=SKEW_JOBS,
                            sim=dict(fluct_sigma=0.1), events=False)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_matches_reference_fused(ref, case):
    """The port's fused run against the reference's live fused program:
    the same records (ints exact, floats 1e-6), the same iterations in
    every fill, and the same state written back."""
    c = CASES[case]
    events_port = _events(sys.modules["repro_torch.scenarios.events"]) \
        if c["events"] else ()
    events_ref = _events(ref["events"]) if c["events"] else ()
    want_fleet = build_ref_fleet(ref, jobs=c["jobs"], **c["sim"])
    want = want_fleet.run_fused(c["steps"], events=events_ref)
    got_fleet = build_fleet(jobs=c["jobs"], **c["sim"])
    got = got_fleet.run_fused(c["steps"], events=events_port)
    _records_match(want, got)
    for a, b in zip(want, got):
        assert a["fill_iters"] == b["fill_iters"], (a["tick"],
                                                    a["fill_iters"],
                                                    b["fill_iters"])
        for ra, rb in zip(a["jobs"], b["jobs"]):
            assert ra["priority"] == rb["priority"]
    assert got_fleet.tick_count == want_fleet.tick_count == c["steps"]
    _state_match(want_fleet, got_fleet)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_matches_sequential_ticks(case):
    """`run_fused(T)` reproduces T sequential ticks of the port:
    identical integer budgets / connection totals, achieved BW to
    roundoff, the same final controller state, and a further
    sequential tick from the synced state matches too."""
    c = CASES[case]
    events = _events(sys.modules["repro_torch.scenarios.events"]) \
        if c["events"] else ()
    seq = build_fleet(jobs=c["jobs"], **c["sim"])
    if events:
        from repro_torch.fleet import FleetEngine, FleetScenarioSpec
        spec = FleetScenarioSpec(
            name="x", steps=c["steps"], jobs=_specs(JobSpec, c["jobs"]),
            events=events, sim_kwargs=dict(QUIET))
        res = FleetEngine(spec, seed=3, forest=default_fleet_forest(),
                          device="cpu").run()
        want = [{"tick": s.tick, "n_jobs": s.n_jobs, "jobs": s.jobs}
                for s in res.trace.steps]
    else:
        want = [seq.tick() for _ in range(c["steps"])]
    fus = build_fleet(jobs=c["jobs"], **c["sim"])
    got = fus.run_fused(c["steps"], events=events)
    _records_match(want, got)
    assert fus.tick_count == c["steps"]
    if not events:
        _state_match(seq, fus)
        a, b = seq.tick(), fus.tick()
        for ra, rb in zip(a["jobs"], b["jobs"]):
            _rows_match(ra, rb)


def test_forest_outputs_on_the_fused_rows(ref):
    """The reference's fused program predicts with `forest_predict_jnp`
    (a mean over trees), the port with `rf_predict` (tree-order sum
    times f32(1/T)). On the fused rows of a run the two agree to within
    a few f32 ulps; the distance is printed (`-s`) and bounded here."""
    rows = []
    real = ops.rf_predict

    def tap(feat, thr, leaf, X, depth, nodes=None):
        rows.append(X.clone())
        return real(feat, thr, leaf, X, depth, nodes=nodes)
    fleet = build_fleet()
    ops.rf_predict = tap
    try:
        fleet.run_fused(4)
    finally:
        ops.rf_predict = real
    X = torch.cat(rows)
    feat, thr, leaf = fleet.predictor._packed
    got = real(feat, thr, leaf, X, fleet.predictor.forest.depth).numpy()
    with ref["x64"]():
        from repro.core.predictor import forest_predict_jnp
        jnp = ref["jnp"]
        want = np.asarray(forest_predict_jnp(
            jnp.asarray(feat.numpy()), jnp.asarray(thr.numpy()),
            jnp.asarray(leaf.numpy()), jnp.asarray(X.numpy()),
            fleet.predictor.forest.depth), np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    print(f"fused rows {len(X)}: rf_predict vs forest_predict_jnp "
          f"bit-equal on {int((ulps == 0).sum())}, max {int(ulps.max())} "
          f"ulps apart")
    assert int(ulps.max()) <= 4


def test_sweep_matches_individual_runs():
    """One batched [B, T] sweep == B independent fused runs."""
    T, variants = 4, (0.25, 0.6)
    singles, bgs = [], []
    for f in variants:
        sim = WanSimulator(seed=3, **QUIET)
        s, g = make_schedule(sim, T,
                             (at(1, LinkDegrade(("us-east", "us-west"),
                                                f)),))
        singles.append(s)
        bgs.append(g)
    ff = build_fleet().fused()
    before = (ops.rf_predict.launches, ops.fill_rates.launches)
    outs = ff.sweep(np.stack(singles), np.stack(bgs))
    # on the host the wrappers run the plain versions: no launch
    assert (ops.rf_predict.launches, ops.fill_rates.launches) == before
    assert outs["achieved_min"].shape == (2, T, len(JOBS))
    assert outs["fill_iters"].shape == (2, T, 3)
    assert outs["budget"].shape == (2, T, len(JOBS))
    assert bool(outs["converged"].all())
    for b, f in enumerate(variants):
        fleet = build_fleet()
        rows = fleet.run_fused(
            T, (at(1, LinkDegrade(("us-east", "us-west"), f)),))
        for t, row in enumerate(rows):
            assert row["fill_iters"] == outs["fill_iters"][b, t].tolist()
            for j, jr in enumerate(row["jobs"]):
                assert jr["achieved_min"] == outs["achieved_min"][b, t, j]
                assert jr["conns_total"] == int(outs["conns_total"][b, t, j])
                assert jr["budget"] == int(outs["budget"][b, t, j])


def test_sweep_leaves_state_and_schedule_replays_sim():
    """A sweep writes nothing back; `make_schedule` advances the
    simulator as the sequential ticks would."""
    fleet = build_fleet(fluct_sigma=0.1)
    ff = fleet.fused()
    st = ff.state()
    sim = WanSimulator(seed=3, **dict(QUIET, fluct_sigma=0.1))
    s, g = make_schedule(sim, 3)
    ff.sweep(s[None], g[None])
    np.testing.assert_array_equal(ff.state().cons, st.cons)
    assert fleet.tick_count == 0
    twin = WanSimulator(seed=3, **dict(QUIET, fluct_sigma=0.1))
    for k in range(3):
        twin.advance()
        np.testing.assert_array_equal(s[k], twin.link_bw_now())
    np.testing.assert_array_equal(sim.link_bw_now(), twin.link_bw_now())


def test_fused_contract_validation():
    """Noisy sims, mixed slice sizes, attached planners, and job-churn
    events are rejected loudly (the contract, not silent divergence)."""
    with pytest.raises(ValueError, match="snapshot_sigma"):
        build_fleet(snapshot_sigma=0.05).fused()
    with pytest.raises(ValueError, match="host_sigma|snapshot_sigma"):
        build_fleet(host_sigma=0.02).fused()
    with pytest.raises(ValueError, match="slice sizes"):
        build_fleet(jobs=(("a", (0, 1, 2), 1.0),
                          ("b", (3, 4, 5, 6), 1.0))).fused()
    fleet = build_fleet()
    with pytest.raises(ValueError, match="replayable"):
        fleet.run_fused(2, (at(0, JobArrive(JobSpec("x", dcs=(0, 1)))),))
    with pytest.raises(ValueError, match="notify"):
        fleet.run_fused(2, (at(0, LinkDegrade(("us-east", "us-west"), 0.5,
                                              notify=True)),))
    from repro_torch.placement import scan_agg
    fleet.job_planner("serving", scan_agg(4))
    with pytest.raises(ValueError, match="planners"):
        fleet.fused()


def test_fused_memoized_on_controller():
    """`FleetController.fused()` reuses the built program until the
    job set / priorities change."""
    fleet = build_fleet()
    f1 = fleet.fused()
    assert fleet.fused() is f1
    fleet.set_priority("batch", 6.0)
    f2 = fleet.fused()
    assert f2 is not f1
    assert isinstance(f2, FusedFleet)
    assert fleet.fused() is f2


def test_forced_divergence_names_the_tick(monkeypatch):
    """A fill that hits its iteration bound raises after the loop, with
    the tick named, and writes no state back."""
    import repro_torch.kernels.ref as ref_kernels
    fleet = build_fleet()
    cons = {n: j.controller.current_conns().copy()
            for n, j in fleet.jobs.items()}
    monkeypatch.setattr(ref_kernels, "max_fill_iters", lambda n: 2)
    with pytest.raises(WaterfillDivergence,
                       match=r"iteration bound at tick 1 of 3"):
        fleet.run_fused(3)
    assert fleet.tick_count == 0
    for n, j in fleet.jobs.items():
        np.testing.assert_array_equal(j.controller.current_conns(), cons[n])


def test_fused_events_are_the_port_dsl():
    """The schedule replays the port's own event classes."""
    sim = WanSimulator(seed=0, **QUIET)
    single, bg = make_schedule(sim, 5, (
        at(1, CrossTraffic(("us-east", "eu-west"), conns=8)),
        at(2, DiurnalCycle(amplitude=0.2, period=4)),
        at(3, LinkRestore(("us-east", "us-west")))))
    i, j = sim.regions.index("us-east"), sim.regions.index("eu-west")
    assert bg[0].sum() == 0 and bg[1, i, j] == bg[1, j, i] == 8
    assert single.shape == bg.shape == (5, sim.N, sim.N)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fused_on_card_matches_host(card):
    """The fused run through the kernels (1 rf_predict and 2 fill_rates
    launches a tick) against the same run on the plain versions."""
    host = build_fleet(fluct_sigma=0.1)
    want = host.run_fused(6)
    fleet = build_fleet(device=card, fluct_sigma=0.1)
    before = (ops.rf_predict.launches, ops.fill_rates.launches)
    got = fleet.run_fused(6)
    assert (ops.rf_predict.launches - before[0],
            ops.fill_rates.launches - before[1]) == (6, 12)
    _records_match(want, got)
    for a, b in zip(want, got):
        assert a["fill_iters"] == b["fill_iters"]
    _state_match(host, fleet)
