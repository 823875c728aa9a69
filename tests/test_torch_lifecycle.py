"""The port's predictor-lifecycle plane against the JAX reference.

One counterpart to each test of `tests/test_lifecycle.py`, compared
port against reference wherever the reference runs:

  * gating — lifecycle off builds no manager and every pin of
    `tests/data/trace_golden.json` holds (parametrized per pin);
  * the drift detector, the percentile estimator, the sliding window,
    the probe scheduler and the refresh: units and hypothesis
    properties, each fed the same inputs in both packages;
  * fitted state carried across: `pretrain_predictor` and
    `refresh_forest` give packed arrays bit-equal to the reference's;
  * the headline comparison (`provider_shift_drift`, seed 3,
    pre_steps 15) on its two inference routes, each held to its own
    twin: (a) numpy inference (a `BwPredictor` subclass pinning
    ``backend="numpy"``, swapped into the harness by the test) equals
    the reference's default live run field for field; (b) f32
    tree-order inference (the kernel's plain version on the host)
    equals the reference run on its Pallas kernel in interpret mode
    field for field, and every prediction of the run is bit-equal to
    that kernel's on the same inputs.

The reference is imported by fixtures, so the card-only tests (marked
`cuda`) run where jax is not installed.
"""
import contextlib
import dataclasses
import hashlib
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.core.forest import RandomForest
from repro_torch.core.predictor import (BwPredictor, SnapshotPredictor,
                                        assemble_features)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rf_predict_ref
from repro_torch.kernels.rf_predict import pack_nodes
from repro_torch.lifecycle import harness as port_harness
from repro_torch.lifecycle import (DriftConfig, EwmaDriftDetector,
                                   LifecycleConfig, LifecycleManager,
                                   ProbeConfig, ProbeScheduler, RefreshConfig,
                                   ResidualStats, SlidingWindow,
                                   WindowedPercentileEstimator,
                                   baseline_probe_spend, decay_seed_data,
                                   harvest_scenario_rows, lifecycle_mode,
                                   pretrain_predictor, refresh_forest,
                                   run_lifecycle_comparison)
from repro_torch.scenarios import ScenarioEngine, get_scenario, goldens
from repro_torch.wan.monitor import probe_cost_usd

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                # pragma: no cover
    HAVE_HYPOTHESIS = False

SCENARIO, SEED, PRE = "provider_shift_drift", 3, 15
KEYS = list(goldens.runners())


class NumpyPredictor(BwPredictor):
    """The host forest's numpy inference (the reference's default
    route): `predict_matrix` pins ``backend="numpy"``."""

    def predict_matrix(self, *args, backend=None, **kw):
        return super().predict_matrix(*args, backend="numpy", **kw)


@contextlib.contextmanager
def harness_predictor(harness, cls):
    """Make a lifecycle harness module (the port's or the reference's)
    build its pretrained predictors as `cls`: the inference route is
    chosen here, in the test, not in the package."""
    real = harness.BwPredictor
    harness.BwPredictor = cls
    try:
        yield
    finally:
        harness.BwPredictor = real


@pytest.fixture(scope="module")
def ref():
    """The reference's lifecycle, predictor, forest and scenarios."""
    import repro.core.forest as forest
    import repro.core.predictor as predictor
    import repro.lifecycle as lifecycle
    import repro.lifecycle.harness as harness
    import repro.scenarios as scenarios
    return types.SimpleNamespace(lc=lifecycle, harness=harness,
                                 predictor=predictor, forest=forest,
                                 scenarios=scenarios)


# ----------------------------------------------------------------------
# gating: off = no manager, on = manager wired through the stack
# ----------------------------------------------------------------------
def test_lifecycle_mode_resolution(monkeypatch, ref):
    monkeypatch.delenv("REPRO_LIFECYCLE", raising=False)
    assert lifecycle_mode() == "off" == ref.lc.lifecycle_mode()
    assert lifecycle_mode("on") == "on"
    monkeypatch.setenv("REPRO_LIFECYCLE", "on")
    assert lifecycle_mode() == "on" == ref.lc.lifecycle_mode()
    assert lifecycle_mode("off") == "off"     # explicit arg beats env
    with pytest.raises(ValueError):
        lifecycle_mode("sometimes")
    monkeypatch.setenv("REPRO_LIFECYCLE", "adaptive")
    with pytest.raises(ValueError):
        lifecycle_mode()


def test_engine_default_builds_no_manager(monkeypatch):
    monkeypatch.delenv("REPRO_LIFECYCLE", raising=False)
    spec = dataclasses.replace(get_scenario("provider_shift"), steps=2)
    eng = ScenarioEngine(spec, seed=0)
    assert eng.lifecycle is None
    assert eng.controller.lifecycle is None


def _records(mgr):
    return [dataclasses.astuple(r) for r in mgr.records]


def test_engine_env_on_builds_manager(monkeypatch, ref):
    monkeypatch.setenv("REPRO_LIFECYCLE", "on")
    spec = dataclasses.replace(get_scenario("provider_shift"), steps=3)
    eng = ScenarioEngine(spec, seed=0)
    assert isinstance(eng.lifecycle, LifecycleManager)
    assert eng.controller.lifecycle is eng.lifecycle
    got = eng.run()
    assert [r.step for r in eng.lifecycle.records] == [0, 1, 2]
    want_eng = ref.scenarios.ScenarioEngine(dataclasses.replace(
        ref.scenarios.get_scenario("provider_shift"), steps=3), seed=0)
    want = want_eng.run()
    assert _records(eng.lifecycle) == _records(want_eng.lifecycle)
    assert got.trace.to_json() == want.trace.to_json()


def test_engine_accepts_prebuilt_manager():
    spec = dataclasses.replace(get_scenario("provider_shift"), steps=2)
    pred = SnapshotPredictor()
    mgr = LifecycleManager(pred, 8, active=False)
    eng = ScenarioEngine(spec, seed=0, predictor=pred, lifecycle=mgr)
    assert eng.lifecycle is mgr and eng.controller.lifecycle is mgr
    eng.run()
    assert len(mgr.records) == 2


def test_engine_obs_on_watches_the_managers_registries():
    """Span tracing on: the manager's and its scheduler's registries
    are watched, a `lifecycle` span runs a step, and the trace is the
    one obs off gives."""
    spec = dataclasses.replace(get_scenario("skew_ramp"), steps=6)
    eng = ScenarioEngine(spec, seed=3, lifecycle="on", obs="on")
    res = eng.run()
    stages = eng.tracer.by_stage()
    assert stages["lifecycle"]["count"] == 6
    delta = stages["lifecycle"]["delta"]
    assert delta["lifecycle.ticks"] == 6
    assert delta["probes.snapshots"] == eng.lifecycle.scheduler.snapshots
    off = ScenarioEngine(spec, seed=3, lifecycle="on", obs="off").run()
    assert res.trace.to_json() == off.trace.to_json()


@pytest.fixture(scope="module")
def gates_off_hashes():
    """Every pinned run once with both gates explicitly off (the fleet
    runs' forest on the host's plain version)."""
    old = {k: os.environ.get(k) for k in ("REPRO_LIFECYCLE",
                                          "REPRO_OVERLAY")}
    os.environ["REPRO_LIFECYCLE"] = "off"
    os.environ["REPRO_OVERLAY"] = "off"
    try:
        return goldens.collect(device="cpu")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:                                   # pragma: no cover
                os.environ[k] = v


@pytest.mark.parametrize("key", KEYS)
def test_golden_pin_lifecycle_off(key, gates_off_hashes):
    """With the lifecycle (and the overlay) off, trace `key` hashes to
    the pin of `tests/data/trace_golden.json`."""
    assert gates_off_hashes[key] == goldens.pinned()[key]


def test_golden_set_spans_all_suites():
    keys = goldens.pinned().keys()
    for prefix, minimum in (("scenario/", 9), ("fleet/", 4),
                            ("placement/", 3)):
        assert sum(k.startswith(prefix) for k in keys) >= minimum


# ----------------------------------------------------------------------
# drift detector
# ----------------------------------------------------------------------
def _feed(det, seq):
    """Tick indices of `seq` on which a DriftSignal fired."""
    alarms = []
    for i, r in enumerate(seq):
        if det.update(np.asarray(r)) is not None:
            alarms.append(i)
    return alarms


def _both(ref, shape=(), **cfg):
    return (EwmaDriftDetector(shape, DriftConfig(**cfg)),
            ref.lc.EwmaDriftDetector(shape, ref.lc.DriftConfig(**cfg)))


def _same_state(a, b):
    for f in ("mean", "var", "consec", "last_z"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.ticks, a.nan_skipped) == (b.ticks, b.nan_skipped)


def test_detector_zero_stream_never_trips(ref):
    det, want = _both(ref)
    assert _feed(det, [0.0] * 200) == [] == _feed(want, [0.0] * 200)
    assert not det.suspicious()
    _same_state(det, want)


def test_detector_signals_within_k_of_step(ref):
    det, want = _both(ref, threshold=4.0, k_consecutive=3, warmup=10)
    seq = [0.0] * 30 + [1.0] * 10
    alarms = _feed(det, seq)
    assert alarms[0] == 30 + 3 - 1
    assert det.suspicious()
    assert alarms == _feed(want, seq)
    _same_state(det, want)


def test_detector_signal_structure_and_pairs(ref):
    det, want = _both(ref, (3, 3), k_consecutive=2, warmup=5)
    r = np.zeros((3, 3))
    for _ in range(20):
        assert det.update(r) is None and want.update(r) is None
    r2 = r.copy()
    r2[0, 2] = 2.0
    r2[1, 0] = -2.0
    assert det.update(r2) is None and want.update(r2) is None
    sig, wsig = det.update(r2), want.update(r2)
    assert sig is not None
    assert set(sig.pairs) == {(0, 2), (1, 0)}
    assert sig.z_max > det.cfg.threshold
    assert sig.consec_max == 2
    assert dataclasses.astuple(sig) == dataclasses.astuple(wsig)


def test_detector_baseline_frozen_under_suspicion(ref):
    det, want = _both(ref, warmup=5)
    for d in (det, want):
        for _ in range(20):
            d.update(np.asarray(0.0))
    mean_before = float(det.mean)
    for d in (det, want):
        for _ in range(6):
            d.update(np.asarray(3.0))
    assert float(det.mean) == pytest.approx(mean_before)
    assert det.suspicious()
    _same_state(det, want)


def test_detector_streak_resets_on_calm_tick(ref):
    det, want = _both(ref, k_consecutive=3, warmup=5)
    for d in (det, want):
        for v in [0.0] * 20 + [2.0, 2.0]:
            d.update(np.asarray(v))
    assert int(det.consec) == 2
    for d in (det, want):
        d.update(np.asarray(0.0))
    assert int(det.consec) == 0 and not det.suspicious()
    _same_state(det, want)


def test_detector_reset_forgets_everything(ref):
    det, want = _both(ref, warmup=5)
    for d in (det, want):
        _feed(d, [0.0] * 15 + [5.0] * 5)
    assert det.suspicious()
    det.reset()
    want.reset()
    assert not det.suspicious() and det.ticks == 0
    assert _feed(det, [0.0] * 50) == [] == _feed(want, [0.0] * 50)
    _same_state(det, want)


def test_detector_nan_residual_skipped_and_counted(ref):
    """A poisoned residual never touches the EWMA baselines:
    skip-and-count, no alarm, no corruption."""
    det, want = _both(ref, warmup=5)
    for d in (det, want):
        for _ in range(20):
            d.update(np.asarray(0.1))
    mean_before, var_before = float(det.mean), float(det.var)
    for d in (det, want):
        assert d.update(np.asarray(np.nan)) is None
        assert d.update(np.asarray(np.inf)) is None
    assert det.nan_skipped == 2
    assert float(det.mean) == mean_before and float(det.var) == var_before
    assert not det.suspicious()
    alarms = _feed(det, [3.0] * 10)
    assert alarms and alarms[0] == det.cfg.k_consecutive - 1
    assert alarms == _feed(want, [3.0] * 10)
    _same_state(det, want)


def test_detector_nan_during_warmup_and_matrix_partial(ref):
    det, want = _both(ref, (2, 2), warmup=3)
    r0 = np.array([[0.0, np.nan], [0.2, 0.0]])
    for d in (det, want):
        d.update(r0)
    assert np.isfinite(det.mean).all() and det.nan_skipped == 1
    for _ in range(30):
        r = np.array([[0.0, 0.1], [0.2, np.inf]])
        assert det.update(r) is None and want.update(r) is None
    assert det.nan_skipped == 31
    _same_state(det, want)


def test_residual_stats_excludes_nonfinite(ref):
    stats = ResidualStats(alpha=0.5)
    want = ref.lc.ResidualStats(alpha=0.5)
    for r in (np.array([0.2, 0.4]), np.array([np.nan, 0.1]),
              np.array([np.nan, np.inf])):
        assert stats.update(r) == want.update(r)
    assert stats.history[1] == pytest.approx(0.5 * 0.3 + 0.5 * 0.1)
    assert stats.history == want.history and len(stats.history) == 3


@pytest.mark.parametrize("seed", range(6))
def test_detector_random_streams_equal_reference(ref, seed):
    """Seeded residual streams on a 4x4 mesh — calm, a step, poisoned
    entries — give the reference's alarms, signals and state."""
    rng = np.random.default_rng(seed)
    det, want = _both(ref, (4, 4), k_consecutive=1 + seed % 3)
    for t in range(60):
        r = rng.normal(0.0, 0.05, (4, 4)) + (0.8 if t > 30 else 0.0)
        if t % 11 == 5:
            r[rng.integers(4), rng.integers(4)] = np.nan
        sig, wsig = det.update(r, step=t), want.update(r, step=t)
        assert (sig is None) == (wsig is None)
        if sig is not None:
            assert dataclasses.astuple(sig) == dataclasses.astuple(wsig)
    _same_state(det, want)


if HAVE_HYPOTHESIS:
    @given(st.floats(-10.0, 10.0, allow_nan=False), st.integers(20, 120))
    @settings(max_examples=30, deadline=None)
    def test_property_constant_stream_no_false_positive(value, n):
        """Any constant residual stream never trips."""
        det = EwmaDriftDetector((), DriftConfig())
        assert _feed(det, [value] * n) == []

    @given(st.floats(0.2, 8.0), st.integers(10, 40))
    @settings(max_examples=30, deadline=None)
    def test_property_sustained_step_detected_within_k(delta, onset):
        """A sustained step clearing the threshold is signalled within
        k_consecutive ticks of onset, as in the reference."""
        import repro.lifecycle as ref_lc
        cfg = DriftConfig()
        seq = [0.0] * max(onset, cfg.warmup) + [delta] * (
            cfg.k_consecutive + 2)
        alarms = _feed(EwmaDriftDetector((), cfg), seq)
        assert alarms, "sustained step never signalled"
        assert alarms[0] - max(onset, cfg.warmup) <= cfg.k_consecutive - 1
        assert alarms == _feed(ref_lc.EwmaDriftDetector(()), seq)

    @given(st.lists(st.floats(-5.0, 5.0, allow_nan=False),
                    min_size=20, max_size=80))
    @settings(max_examples=30, deadline=None)
    def test_property_sign_convention_invariance(seq):
        """Feeding -r trips at exactly the ticks r does, and at the
        reference's ticks."""
        import repro.lifecycle as ref_lc
        a = _feed(EwmaDriftDetector((), DriftConfig()), seq)
        assert a == _feed(EwmaDriftDetector((), DriftConfig()),
                          [-x for x in seq])
        assert a == _feed(ref_lc.EwmaDriftDetector(()), seq)


# ----------------------------------------------------------------------
# windowed percentile estimator and sliding window
# ----------------------------------------------------------------------
def test_estimator_validates_args():
    with pytest.raises(ValueError):
        WindowedPercentileEstimator((2, 2), window=0)
    with pytest.raises(ValueError):
        WindowedPercentileEstimator((2, 2), q=120.0)


def test_estimator_empty_passthrough_and_none_capacity():
    est = WindowedPercentileEstimator((3, 3))
    assert est.capacity() is None
    pred = np.full((3, 3), 777.0)
    out = est.clamp_matrix(pred)
    assert np.array_equal(out, pred) and out is not pred


def test_estimator_clamp_off_diagonal_only(ref):
    out = []
    for cls in (WindowedPercentileEstimator,
                ref.lc.WindowedPercentileEstimator):
        est = cls((3, 3), window=4, q=95.0)
        est.push(np.full((3, 3), 100.0))
        pred = np.full((3, 3), 500.0)
        np.fill_diagonal(pred, 9999.0)
        out.append(est.clamp_matrix(pred, headroom=1.5))
    off = ~np.eye(3, dtype=bool)
    assert np.allclose(out[0][off], 150.0)
    assert np.allclose(np.diag(out[0]), 9999.0)
    np.testing.assert_array_equal(out[0], out[1])


if HAVE_HYPOTHESIS:
    @given(st.integers(0, 2 ** 31 - 1), st.integers(1, 10),
           st.floats(0.0, 100.0))
    @settings(max_examples=30, deadline=None)
    def test_property_capacity_within_data_range(seed, n_push, q):
        import repro.lifecycle as ref_lc
        rng = np.random.default_rng(seed)
        est = WindowedPercentileEstimator((4, 4), window=6, q=q)
        want = ref_lc.WindowedPercentileEstimator((4, 4), window=6, q=q)
        samples = rng.uniform(1.0, 1000.0, (n_push, 4, 4))
        for s in samples:
            est.push(s)
            want.push(s)
        tail = samples[-min(n_push, 6):]
        cap = est.capacity()
        assert np.all(cap >= tail.min(axis=0) - 1e-9)
        assert np.all(cap <= tail.max(axis=0) + 1e-9)
        np.testing.assert_array_equal(cap, want.capacity())

    @given(st.integers(0, 2 ** 31 - 1), st.floats(0.0, 100.0),
           st.floats(0.0, 100.0))
    @settings(max_examples=30, deadline=None)
    def test_property_capacity_monotone_in_quantile(seed, q1, q2):
        rng = np.random.default_rng(seed)
        est = WindowedPercentileEstimator((3, 3), window=8)
        for _ in range(5):
            est.push(rng.uniform(1.0, 1000.0, (3, 3)))
        lo, hi = sorted((q1, q2))
        assert np.all(est.capacity(lo) <= est.capacity(hi) + 1e-9)

    @given(st.integers(0, 2 ** 31 - 1), st.integers(1, 8))
    @settings(max_examples=20, deadline=None)
    def test_property_window_roll_stability(seed, extra):
        """Pushing window+extra samples equals a fresh estimator fed the
        last `window` of them."""
        rng = np.random.default_rng(seed)
        window = 5
        samples = rng.uniform(1.0, 1000.0, (window + extra, 2, 2))
        rolled = WindowedPercentileEstimator((2, 2), window=window)
        for s in samples:
            rolled.push(s)
        fresh = WindowedPercentileEstimator((2, 2), window=window)
        for s in samples[-window:]:
            fresh.push(s)
        assert rolled.n_samples == fresh.n_samples == window
        assert np.array_equal(rolled.capacity(), fresh.capacity())


def test_sliding_window_trims_with_partial_chunk_split(ref):
    X1 = np.arange(18, dtype=np.float32).reshape(3, 6)
    y1 = np.array([10.0, 11.0, 12.0], np.float32)
    got = []
    for cls in (SlidingWindow, ref.lc.SlidingWindow):
        w = cls(capacity=5)
        w.push(X1, y1)
        w.push(X1 + 100, y1 + 100)
        assert w.n_rows == 5
        got.append(w.rows())
    X, y = got[0]
    assert np.array_equal(y, np.array([11, 12, 110, 111, 112], np.float32))
    assert np.array_equal(X[0], X1[1])
    for a, b in zip(got[0], got[1]):
        np.testing.assert_array_equal(a, b)


def test_sliding_window_clear_and_empty_rows():
    w = SlidingWindow(capacity=8)
    X, y = w.rows()
    assert X.shape == (0, 6) and y.shape == (0,)
    w.push(np.zeros((4, 6), np.float32), np.ones(4, np.float32))
    assert w.n_rows == 4
    w.clear()
    assert w.n_rows == 0 and w.rows()[1].shape == (0,)


def test_sliding_window_validates():
    with pytest.raises(ValueError):
        SlidingWindow(0)
    with pytest.raises(ValueError):
        SlidingWindow(4).push(np.zeros((3, 6)), np.zeros(2))


# ----------------------------------------------------------------------
# refresh: determinism, bit-equality with the reference, inference
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def refresh_inputs():
    rng = np.random.default_rng(42)
    seed_X = rng.uniform(0, 500, (300, 6)).astype(np.float32)
    seed_y = rng.uniform(1, 400, 300).astype(np.float32)
    win_X = rng.uniform(0, 500, (250, 6)).astype(np.float32)
    win_y = rng.uniform(1, 200, 250).astype(np.float32)
    template = RandomForest(n_trees=12, depth=6, min_leaf=4,
                            seed=0).fit(seed_X, seed_y)
    return template, seed_X, seed_y, win_X, win_y


def _ref_template(ref, template):
    return ref.forest.RandomForest(
        n_trees=template.n_trees, depth=template.depth,
        min_leaf=template.min_leaf, seed=template.seed)


def _ref_forest(ref, rf):
    """The reference's forest holding `rf`'s fitted arrays."""
    out = _ref_template(ref, rf)
    out.feat, out.thr, out.leaf = rf.packed()
    return out


def test_refresh_is_bit_deterministic(refresh_inputs, ref):
    """Same inputs => bit-identical packed tensors, twice over, and
    the reference's."""
    template, sX, sy, wX, wy = refresh_inputs
    cfg = RefreshConfig(seed=7)
    a = refresh_forest(template, wX, wy, sX, sy, cfg)
    b = refresh_forest(template, wX, wy, sX, sy, cfg)
    want = ref.lc.refresh_forest(_ref_template(ref, template), wX, wy, sX,
                                 sy, ref.lc.RefreshConfig(seed=7))
    for ta, tb, tw in zip(a.packed(), b.packed(), want.packed()):
        assert np.array_equal(ta, tb)
        np.testing.assert_array_equal(ta, tw)


def test_refresh_never_mutates_template(refresh_inputs):
    template, sX, sy, wX, wy = refresh_inputs
    before = [t.copy() for t in template.packed()]
    out = refresh_forest(template, wX, wy, sX, sy, RefreshConfig())
    assert out is not template
    for t0, t1 in zip(before, template.packed()):
        assert np.array_equal(t0, t1)


def test_refresh_requires_training_rows(refresh_inputs):
    template = refresh_inputs[0]
    with pytest.raises(ValueError):
        refresh_forest(template, np.zeros((0, 6), np.float32),
                       np.zeros(0, np.float32), None, None)
    wX, wy = refresh_inputs[3], refresh_inputs[4]
    assert refresh_forest(template, wX, wy).packed()[0].shape[0] == 12


@pytest.mark.parametrize("decay", [0.0, 0.25, 0.6, 1.0])
def test_decay_seed_data_deterministic_subset(ref, decay):
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 1, (100, 6)).astype(np.float32)
    y = np.arange(100, dtype=np.float32)
    Xa, ya = decay_seed_data(X, y, decay, seed=3)
    Xb, yb = decay_seed_data(X, y, decay, seed=3)
    assert len(ya) == int(decay * 100)
    assert np.array_equal(ya, yb) and np.array_equal(Xa, Xb)
    assert set(ya.tolist()) <= set(y.tolist())
    assert np.all(np.diff(ya) > 0)
    Xw, yw = ref.lc.decay_seed_data(X, y, decay, seed=3)
    np.testing.assert_array_equal(Xa, Xw)
    np.testing.assert_array_equal(ya, yw)


def _inputs(n, seed=5):
    rng = np.random.default_rng(seed)
    return (n, rng.uniform(10, 400, (n, n)), rng.uniform(0, 1, n),
            rng.uniform(0, 1, n), np.rint(rng.uniform(0, 20, (n, n))),
            rng.uniform(100, 9000, (n, n)))


def test_refreshed_predictor_backend_parity(refresh_inputs, ref):
    """A refreshed forest: numpy inference equals the reference's numpy
    bit for bit; the kernel's plain version (the torch backend) equals
    the reference's Pallas kernel bit for bit; the two routes agree
    within the reference's parity tolerance."""
    template, sX, sy, wX, wy = refresh_inputs
    rf = refresh_forest(template, wX, wy, sX, sy, RefreshConfig())
    port = BwPredictor(rf, device="cpu")
    want = ref.predictor.BwPredictor(_ref_forest(ref, rf))
    args = _inputs(6)
    base = port.predict_matrix(*args, backend="numpy")
    np.testing.assert_array_equal(base, want.predict_matrix(
        *args, backend="numpy"))
    f32 = port.predict_matrix(*args, backend="torch")
    np.testing.assert_array_equal(f32, want.predict_matrix(
        *args, backend="pallas"))
    np.testing.assert_allclose(f32, base, rtol=1e-4, atol=0.05)


def test_pretrain_predictor_packed_bit_equal_reference(ref):
    """The forest carried into the lifecycle: the port's pretrained
    forest and its seed rows are the reference's to the bit."""
    spec = get_scenario(SCENARIO)
    pred, X, y = pretrain_predictor(spec, seed=SEED, pre_steps=PRE,
                                    device="cpu")
    wpred, wX, wy = ref.lc.pretrain_predictor(
        ref.scenarios.get_scenario(SCENARIO), seed=SEED, pre_steps=PRE)
    np.testing.assert_array_equal(X, wX)
    np.testing.assert_array_equal(y, wy)
    for a, b in zip(pred.forest.packed(), wpred.forest.packed()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert isinstance(pred, BwPredictor) and pred.device == "cpu"


def test_harvest_shadow_manager_attached_after_construction(
        monkeypatch, ref):
    """`harvest_scenario_rows` attaches its shadow manager after the
    engine is built: the engine ticks it (read at tick time), the
    controller holds none, so no prediction is ever clamped; the rows
    are the reference's."""
    calls = []
    real = LifecycleManager.adjust_prediction
    monkeypatch.setattr(LifecycleManager, "adjust_prediction",
                        lambda self, p: calls.append(1) or real(self, p))
    spec = get_scenario(SCENARIO)
    X, y = harvest_scenario_rows(spec, seed=SEED, steps=4)
    wX, wy = ref.lc.harvest_scenario_rows(
        ref.scenarios.get_scenario(SCENARIO), seed=SEED, steps=4)
    assert calls == [] and X.shape == (4 * 56, 6)
    np.testing.assert_array_equal(X, wX)
    np.testing.assert_array_equal(y, wy)


def test_refit_forest_next_launch_reads_new_trees(refresh_inputs):
    """The predictor's packed nodes follow the forest in force: a
    refresh swapped in, a warm fit, and arrays rewritten in place are
    each read by the very next prediction (a stale node cache would
    look exactly like a refit that does not help)."""
    template, sX, sy, wX, wy = refresh_inputs
    rf = RandomForest.from_packed(*template.packed(), template.depth,
                                  seed=template.seed)
    pred = BwPredictor(rf, device="cpu")
    args = _inputs(6)
    dev = torch.device("cpu")

    def plain(forest):
        return BwPredictor(forest, device="cpu").predict_matrix(*args)

    first = pred.predict_matrix(*args)
    np.testing.assert_array_equal(first, plain(rf))
    # the lifecycle's swap: a new forest object
    pred.forest = refresh_forest(rf, wX, wy, sX, sy, RefreshConfig())
    got = pred.predict_matrix(*args)
    np.testing.assert_array_equal(got, plain(pred.forest))
    assert not np.array_equal(got, first)
    # a warm fit: more trees, new arrays
    pred.forest.fit(wX, wy, warm=True)
    got = pred.predict_matrix(*args)
    np.testing.assert_array_equal(got, plain(pred.forest))
    # arrays rewritten in place: same objects, new values
    before = got
    pred.forest.leaf *= np.float32(2)
    got = pred.predict_matrix(*args)
    np.testing.assert_array_equal(got, plain(pred.forest))
    assert not np.array_equal(got, before)
    (feat, thr, _), nodes = pred.forest_on(dev)
    np.testing.assert_array_equal(
        nodes.numpy(), pack_nodes(torch.from_numpy(pred.forest.feat),
                                  torch.from_numpy(pred.forest.thr)).numpy())


# ----------------------------------------------------------------------
# cost-aware probe scheduling
# ----------------------------------------------------------------------
def test_scheduler_quiet_ticks_never_probe():
    s = ProbeScheduler(8)
    assert not any(s.want_full(k, suspicious=False) for k in range(50))
    assert s.spend_usd == 0.0 and s.full_probes == 0


def test_scheduler_cooldown_gates_full_probes(ref):
    got, want = ProbeScheduler(8, ProbeConfig(cooldown_ticks=3)), \
        ref.lc.ProbeScheduler(8, ref.lc.ProbeConfig(cooldown_ticks=3))
    seen = []
    for s in (got, want):
        out = [s.want_full(10, True)]
        s.charge_full(10)
        out += [s.want_full(k, True) for k in (11, 12, 13)]
        seen.append(out)
    assert seen[0] == [True, False, False, True] == seen[1]


def test_scheduler_spend_arithmetic(ref):
    cfg = ProbeConfig()
    out = []
    for s in (ProbeScheduler(8, cfg), ref.lc.ProbeScheduler(8)):
        s.charge_full(0)
        s.charge_full(5)
        s.charge_snapshot(7)
        out.append((s.spend_usd, s.full_probes, s.snapshots))
    want = (2 * probe_cost_usd(cfg.probe_seconds, 8)
            + 7 * probe_cost_usd(cfg.snapshot_seconds, 8))
    assert out[0][0] == pytest.approx(want)
    assert out[0][1:] == (2, 7)
    assert out[0] == out[1]


@pytest.mark.parametrize("steps", [0, 3, 40, 97])
def test_baseline_probe_spend_matches_cadence(ref, steps):
    """Periodic full probing every 30 simulated minutes at 10 minutes a
    step: 40 steps are 13 probes."""
    cfg = ProbeConfig()
    want = (steps * 10 // 30) * probe_cost_usd(cfg.probe_seconds, 8)
    assert baseline_probe_spend(steps, 8) == pytest.approx(want)
    assert baseline_probe_spend(steps, 8) == \
        ref.lc.baseline_probe_spend(steps, 8)


# ----------------------------------------------------------------------
# manager behaviour outside the headline scenario
# ----------------------------------------------------------------------
def test_shadow_manager_never_clamps():
    mgr = LifecycleManager(SnapshotPredictor(), 3, active=False)
    mgr.estimator.push(np.full((3, 3), 10.0))
    pred = np.full((3, 3), 1e6)
    assert np.array_equal(mgr.adjust_prediction(pred), pred)


def test_active_manager_clamps_against_capacity():
    mgr = LifecycleManager(SnapshotPredictor(), 3)
    mgr.estimator.push(np.full((3, 3), 10.0))
    out = mgr.adjust_prediction(np.full((3, 3), 1e6))
    off = ~np.eye(3, dtype=bool)
    assert np.allclose(out[off], 15.0)


def test_snapshot_predictor_cannot_refresh(refresh_inputs):
    assert not LifecycleManager(SnapshotPredictor(), 8).can_refresh()
    assert LifecycleManager(BwPredictor(refresh_inputs[0], device="cpu"),
                            8).can_refresh()


def test_measurement_not_ok_skips_the_tick():
    """A skipped tick (the fault plane's monitor outage; without the
    plane the engine always passes True) records and counts itself and
    learns nothing."""
    eng = ScenarioEngine(dataclasses.replace(
        get_scenario("skew_ramp"), steps=1), seed=3, lifecycle="on")
    eng.run()
    mgr = eng.lifecycle
    det_ticks = mgr.detector.ticks
    N = mgr.n_dcs
    rec = mgr.tick(1, eng.controller, eng.sim, np.ones((N, N)),
                   np.ones((N, N)), np.ones((N, N)), measurement_ok=False)
    assert rec.skipped and not rec.full_probe and not rec.refreshed
    assert mgr.detector.ticks == det_ticks
    assert mgr.metrics.counter("ticks_skipped").value == 1


def test_quiet_scenario_on_mode_stays_silent(ref):
    """With the snapshot-ablation predictor in a quiet-ish scenario,
    lifecycle=on spends no full-probe dollars and never signals or
    refits — and its records are the reference's."""
    spec = dataclasses.replace(get_scenario("skew_ramp"), steps=12)
    eng = ScenarioEngine(spec, seed=3, lifecycle="on")
    got = eng.run()
    mgr = eng.lifecycle
    assert mgr.signals == [] and mgr.refreshes == 0
    assert mgr.scheduler.full_probes == 0 and len(mgr.records) == 12
    weng = ref.scenarios.ScenarioEngine(dataclasses.replace(
        ref.scenarios.get_scenario("skew_ramp"), steps=12), seed=3,
        lifecycle="on")
    want = weng.run()
    assert _records(mgr) == _records(weng.lifecycle)
    assert got.trace.to_json() == want.trace.to_json()


# ----------------------------------------------------------------------
# the headline recovery pin (provider_shift_drift, seed 3), two routes
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def comparison():
    """Route (a): numpy inference in the port."""
    with harness_predictor(port_harness, NumpyPredictor):
        return run_lifecycle_comparison(SCENARIO, seed=SEED,
                                        pre_steps=PRE, device="cpu")


@pytest.fixture(scope="module")
def ref_comparison(ref):
    """The reference's own live run (its default numpy inference)."""
    return ref.lc.run_lifecycle_comparison(SCENARIO, seed=SEED,
                                           pre_steps=PRE)


def test_comparison_numpy_equals_reference(comparison, ref_comparison):
    """Route (a): every field of the comparison — resid series,
    signal and refresh steps, probes, dollars and both trace shas — is
    the reference's, and the shas are the port's plane pins."""
    assert comparison == ref_comparison
    for mode in ("frozen", "lifecycle"):
        assert comparison["modes"][mode]["trace_sha"] == \
            goldens.PLANE_PINS[goldens.lifecycle_key(mode, "numpy")]


def test_recovery_preshift_series_identical(comparison):
    fr = comparison["modes"]["frozen"]["resid"]
    lc = comparison["modes"]["lifecycle"]["resid"]
    assert fr[:15] == lc[:15]


def test_recovery_drift_detected_promptly(comparison):
    lc = comparison["modes"]["lifecycle"]
    assert lc["signal_steps"], "no drift signal after the shift"
    assert 15 <= lc["signal_steps"][0] <= 20
    assert lc["refresh_steps"], "drift never produced a refit"
    assert 15 <= lc["refresh_steps"][0] <= 22
    assert lc["refreshes"] >= 1


def test_recovery_refreshed_beats_frozen_accuracy(comparison):
    fr = comparison["modes"]["frozen"]["resid"]
    lc = comparison["modes"]["lifecycle"]["resid"]
    fr_post, lc_post = float(np.mean(fr[25:])), float(np.mean(lc[25:]))
    assert lc_post < 0.3 < fr_post
    assert lc_post < fr_post


def test_recovery_costs_less_than_periodic_probing(comparison):
    fr = comparison["modes"]["frozen"]
    lc = comparison["modes"]["lifecycle"]
    assert fr["full_probes"] == 0
    assert lc["full_probes"] >= 1
    assert lc["monitor_usd"] < 0.75 * fr["monitor_usd"]


def test_recovery_frozen_mode_is_pure_shadow(comparison):
    """The frozen run's trace is byte-identical to a plain engine run
    with the same pretrained predictor and no manager at all."""
    spec = get_scenario(SCENARIO)
    with harness_predictor(port_harness, NumpyPredictor):
        predictor, _, _ = pretrain_predictor(spec, seed=SEED,
                                             pre_steps=PRE, device="cpu")
    res = ScenarioEngine(spec, seed=SEED, predictor=predictor).run()
    sha = hashlib.sha256(res.trace.to_json().encode()).hexdigest()
    assert comparison["modes"]["frozen"]["trace_sha"] == sha


def test_recovery_lifecycle_config_defaults(ref):
    cfg, want = LifecycleConfig(), ref.lc.LifecycleConfig()
    assert cfg.drift.k_consecutive == 3
    assert cfg.drift.threshold == 4.0
    assert cfg.refresh.min_rows == 224
    assert cfg.probes.cooldown_ticks == 3
    assert cfg.clamp_headroom == 1.5
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


@pytest.fixture(scope="module")
def f32_runs(ref):
    """Route (b): the port on the kernel's plain version (f32, tree
    order, x f32(1/T)) with every prediction also made by the
    reference's Pallas kernel in interpret mode on the same inputs, and
    the reference's comparison with its predictor on that kernel."""
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops

    calls = []

    class Checked(BwPredictor):
        def predict_matrix(self, n_dcs, snap_bw, mem, cpu, retr, dist,
                           **kw):
            out = super().predict_matrix(n_dcs, snap_bw, mem, cpu, retr,
                                         dist, **kw)
            X = assemble_features(n_dcs, snap_bw, mem, cpu, retr, dist)
            want = np.asarray(ref_ops.rf_predict(
                *(jnp.asarray(a) for a in (*self.forest.packed(), X)),
                depth=self.forest.depth))
            # the tensors this run's predictions were made from
            packed, _ = self.forest_on(torch.device("cpu"))
            got = rf_predict_ref(*packed, torch.from_numpy(X),
                                 self.forest.depth).numpy()
            calls.append((X.shape, bool(np.array_equal(got, want))))
            return out

    class RefPallas(ref.predictor.BwPredictor):
        def predict_matrix(self, *args, backend=None, **kw):
            return super().predict_matrix(*args, backend="pallas", **kw)

    with harness_predictor(port_harness, Checked):
        port = run_lifecycle_comparison(SCENARIO, seed=SEED,
                                        pre_steps=PRE, device="cpu")
    with harness_predictor(ref.harness, RefPallas):
        want = ref.lc.run_lifecycle_comparison(SCENARIO, seed=SEED,
                                               pre_steps=PRE)
    return port, want, calls


def test_comparison_f32_equals_reference_pallas(f32_runs):
    """Route (b): the port's f32 run equals the reference's run on its
    Pallas kernel field for field; both shas are the plane pins."""
    port, want, _ = f32_runs
    assert port == want
    for mode in ("frozen", "lifecycle"):
        assert port["modes"][mode]["trace_sha"] == \
            goldens.PLANE_PINS[goldens.lifecycle_key(mode, "f32")]


def test_f32_predictions_bit_equal_pallas_per_call(f32_runs):
    """Every prediction of route (b)'s run — each replan and each
    lifecycle tick, on the pretrained and the refreshed forests, at the
    run's 56 rows — is bit-equal to the reference's Pallas kernel."""
    port, _, calls = f32_runs
    modes = port["modes"]
    assert len(calls) == sum(m["snapshots"] + m["steps"]
                             for m in modes.values())
    assert {shape for shape, _ in calls} == {(56, 6)}
    assert all(ok for _, ok in calls)


def test_f32_route_headline_holds(f32_runs):
    """The headline's assertions, as written, on the f32 route too."""
    port = f32_runs[0]
    fr, lc = port["modes"]["frozen"], port["modes"]["lifecycle"]
    assert 15 <= lc["signal_steps"][0] <= 20
    assert 15 <= lc["refresh_steps"][0] <= 22
    assert float(np.mean(lc["resid"][25:])) < 0.3 < \
        float(np.mean(fr["resid"][25:]))
    assert lc["monitor_usd"] < 0.75 * fr["monitor_usd"]
    assert fr["resid"][:15] == lc["resid"][:15]


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
def test_lifecycle_on_card_equals_host(card):
    """The comparison with the pretrained forest on the card: one
    `rf_predict` launch per replan and per lifecycle tick, and the
    whole result equal to the host's plain-version run."""
    ops.rf_predict.launches = 0
    got = run_lifecycle_comparison(SCENARIO, seed=SEED, pre_steps=PRE,
                                   device=card)
    launches = ops.rf_predict.launches
    want = run_lifecycle_comparison(SCENARIO, seed=SEED, pre_steps=PRE,
                                    device="cpu")
    assert got == want
    assert launches == sum(m["snapshots"] + m["steps"]
                           for m in got["modes"].values())
    for mode in ("frozen", "lifecycle"):
        assert got["modes"][mode]["trace_sha"] == \
            goldens.PLANE_PINS[goldens.lifecycle_key(mode, "f32")]
