"""The port's WAN model against the JAX reference: same seeds, same
calls, bit-equal results. Both are host numpy float64 with the same
named `SeedSequence` streams, so every draw and fill must match
exactly (`assert_array_equal`)."""
import numpy as np
import pytest

from repro.core.forest import RandomForest as RefForest
from repro.wan import dataset as ref_dataset
from repro.wan import monitor as ref_monitor
from repro.wan import simulator as ref_sim
from repro.wan import topology as ref_topo
from repro_torch.core.forest import RandomForest
from repro_torch.wan import dataset, monitor, simulator, topology


def _pair(seed, **kw):
    return (ref_sim.WanSimulator(seed=seed, **kw),
            simulator.WanSimulator(seed=seed, **kw))


def _eq(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_topology_equal():
    regions = list(ref_topo.DEFAULT_8DC)
    assert topology.DEFAULT_8DC == regions
    _eq(ref_topo.distance_matrix(regions), topology.distance_matrix(regions))
    _eq(ref_topo.bw_single_matrix(regions),
        topology.bw_single_matrix(regions))


@pytest.mark.parametrize("seed", [0, 5])
def test_simulator_sequence_bit_equal(seed):
    ref, port = _pair(seed)
    rng = np.random.default_rng(seed)
    for step in range(4):
        conns = rng.integers(0, 9, (8, 8)).astype(float)
        for sim in (ref, port):
            sim.advance(1 + step % 2)
        _eq(ref.link_bw_now(), port.link_bw_now())
        _eq(ref.measure_snapshot(conns), port.measure_snapshot(conns))
        _eq(ref.measure_runtime(conns), port.measure_runtime(conns))
        snap = ref.measure_snapshot(conns)
        _eq(snap, port.measure_snapshot(conns))
        _eq(ref.host_metrics(conns, bw=snap), port.host_metrics(conns, bw=snap))
        _eq(ref.host_metrics(conns), port.host_metrics(conns))
    assert ref.fill_calls == port.fill_calls
    assert ref.last_fill_iters == port.last_fill_iters
    assert ref.metrics.snapshot() == port.metrics.snapshot()


@pytest.mark.parametrize("seed", [1, 2])
def test_waterfill_tenants_bit_equal(seed):
    ref, port = _pair(seed)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 7, (8, 8)).astype(float)
    b = rng.uniform(0, 5, (8, 8))
    rival = rng.integers(0, 3, (8, 8)).astype(float)
    cap = np.where(rng.random((8, 8)) < 0.3, 400.0, np.inf)
    for sim in (ref, port):
        sim.advance(3)
        sim.set_tenant_conns("a", a)
        sim.set_tenant_conns("rival", rival)
        sim.set_background(0, 3, 2.0)
    _eq(ref.waterfill_tenants({"a": a, "b": b}),
        port.waterfill_tenants({"a": a, "b": b}))
    _eq(ref.waterfill_tenants({"a": a, "b": b}, cap=cap),
        port.waterfill_tenants({"a": a, "b": b}, cap=cap))
    _eq(ref.waterfill(b, tenant="a"), port.waterfill(b, tenant="a"))
    _eq(ref.measure_static_independent(2, tenant="a"),
        port.measure_static_independent(2, tenant="a"))


def test_static_independent_and_scripted_dynamics_equal():
    ref, port = _pair(4)
    for sim in (ref, port):
        sim.advance(5)
        sim.set_link_factor(1, 3, 0.25)
        sim.modulation = 0.8
        sim.set_provider_factor(np.linspace(0.7, 1.3, 8))
    _eq(ref.measure_static_independent(3), port.measure_static_independent(3))
    mask = np.ones((8, 8), bool)
    mask[2, :] = mask[:, 2] = False
    ref.set_reachable(mask)
    port.set_reachable(mask)
    _eq(ref.measure_simultaneous(noise=0.05), port.measure_simultaneous(
        noise=0.05))


def test_monitor_capture_and_costs_equal():
    ref, port = _pair(3)
    conns = np.full((8, 8), 3.0)
    _eq(ref_monitor.SnapshotMonitor(ref).capture(conns),
        monitor.SnapshotMonitor(port).capture(conns))
    for n in (4, 8):
        assert monitor.annual_costs(n) == ref_monitor.annual_costs(n)
        assert monitor.probe_cost_usd(20.0, n) == \
            ref_monitor.probe_cost_usd(20.0, n)


def test_generate_dataset_equal():
    _eq(ref_dataset.generate_dataset(n_samples=20),
        dataset.generate_dataset(n_samples=20))


@pytest.mark.parametrize("T,depth", [(4, 4), (6, 7)])
def test_forest_fit_packed_equal(T, depth):
    X, y = dataset.generate_dataset(n_samples=10, seed=11)
    ref = RefForest(n_trees=T, depth=depth, seed=3).fit(X, y)
    port = RandomForest(n_trees=T, depth=depth, seed=3).fit(X, y)
    _eq(ref.packed(), port.packed())
    ref.fit(X[:50], y[:50], warm=True, n_new=2)
    port.fit(X[:50], y[:50], warm=True, n_new=2)
    _eq(ref.packed(), port.packed())
    _eq(ref.predict(X), port.predict(X))
    assert port.score(X, y) == ref.score(X, y)
