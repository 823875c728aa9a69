"""The port's fleet tick (the first slice as a whole) against the JAX
reference: same seeds, same jobs, six ticks, and every tick record
equal with ``==`` — the host control plane is the same numpy float64,
and the forest output is bit-equal, so no field needs a tolerance.

The reference fleet imports `jax.experimental.enable_x64`, which jax
0.9 dropped; the module fixture installs a stand-in only when it is
missing, and takes it (and the reference modules it let in) out again
afterwards, so no other test file sees a different jax.
"""
import importlib
import sys

import numpy as np
import pytest

from repro_torch.fleet import (BatchedRfPredictor, FleetController, JobSpec,
                               arbiter, default_fleet_forest)
from repro_torch.wan.simulator import WanSimulator

QUIET = dict(fluct_sigma=0.0, snapshot_sigma=0.0, runtime_sigma=0.0,
             host_sigma=0.0)
PRIORITIES = (1.0, 2.0, 4.0)
TICKS = 6


@pytest.fixture(scope="module")
def ref():
    """The reference packages `repro.fleet` and `repro.wan.simulator`."""
    import jax
    import jax.experimental
    shim = not hasattr(jax.experimental, "enable_x64")
    before = set(sys.modules)
    if shim:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    import repro.fleet
    import repro.wan.simulator
    yield repro.fleet, repro.wan.simulator
    if shim:
        del jax.experimental.enable_x64
        for name in set(sys.modules) - before:
            if name == "repro" or name.startswith("repro."):
                del sys.modules[name]


def _readme_jobs(js):
    """The README's two-job fleet."""
    return (js("serving", dcs=(0, 1, 2, 3), priority=4.0),
            js("batch", dcs=(0, 1, 4, 5), priority=1.0))


def _tick_smoke_jobs(js, n_jobs=6):
    """`benchmarks/tick_bench.py`'s layout: 4-DC jobs tiling the mesh."""
    return tuple(js(name=f"job{j}", dcs=tuple((j + k) % 8 for k in range(4)),
                    priority=PRIORITIES[j % len(PRIORITIES)])
                 for j in range(n_jobs))


LAYOUTS = {"readme_noisy": (_readme_jobs, {}),
           "tick_smoke_quiet": (_tick_smoke_jobs, QUIET)}


def _run(fleet, ticks=TICKS):
    return [fleet.tick() for _ in range(ticks)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fleet_records_equal_reference(ref, layout):
    rfleet, rsim = ref
    jobs, sim_kw = LAYOUTS[layout]
    ref_fleet = rfleet.FleetController(
        rsim.WanSimulator(seed=0, **sim_kw),
        rfleet.BatchedRfPredictor(rfleet.default_fleet_forest()),
        m_total=8, jobs=jobs(rfleet.JobSpec))
    port_fleet = FleetController(
        WanSimulator(seed=0, **sim_kw),
        BatchedRfPredictor(default_fleet_forest(), device="cpu"),
        m_total=8, jobs=jobs(JobSpec))
    want, got = _run(ref_fleet), _run(port_fleet)
    for w, g in zip(want, got):
        assert g == w, (layout, w["tick"])
    assert got[-1]["kernel_calls"] == TICKS
    for job in port_fleet.jobs.values():
        ref_job = ref_fleet.jobs[job.name]
        np.testing.assert_array_equal(job.controller.last_pred,
                                      ref_job.controller.last_pred)
        np.testing.assert_array_equal(job.controller.current_conns(),
                                      ref_job.controller.current_conns())


def test_fleet_churn_equal_reference(ref):
    """Priority change and a departure re-arbitrate identically."""
    rfleet, rsim = ref
    ref_fleet = rfleet.FleetController(
        rsim.WanSimulator(seed=2, **QUIET),
        rfleet.BatchedRfPredictor(rfleet.default_fleet_forest()),
        m_total=8, jobs=_tick_smoke_jobs(rfleet.JobSpec, 3))
    port_fleet = FleetController(
        WanSimulator(seed=2, **QUIET),
        BatchedRfPredictor(default_fleet_forest(), device="cpu"),
        m_total=8, jobs=_tick_smoke_jobs(JobSpec, 3))
    for fleet in (ref_fleet, port_fleet):
        fleet.tick()
        fleet.set_priority("job2", 6.0)
        fleet.tick()
        fleet.remove_job("job1")
    assert port_fleet.tick() == ref_fleet.tick()
    assert port_fleet.events == ref_fleet.events


def test_fleet_obs_on_spans(ref):
    """obs='on' is passive: same records, and one predict span per
    tick whose counter delta is one launch."""
    port_fleet = FleetController(
        WanSimulator(seed=0, **QUIET),
        BatchedRfPredictor(default_fleet_forest(), device="cpu"),
        m_total=8, jobs=_tick_smoke_jobs(JobSpec, 3), obs="on")
    plain = FleetController(
        WanSimulator(seed=0, **QUIET),
        BatchedRfPredictor(default_fleet_forest(), device="cpu"),
        m_total=8, jobs=_tick_smoke_jobs(JobSpec, 3))
    assert _run(port_fleet, 3) == _run(plain, 3)
    stages = port_fleet.tracer.by_stage()
    assert stages["tick"]["count"] == 3
    assert stages["predict"]["delta"]["predictor.kernel_calls"] == 3


@pytest.mark.parametrize("seed", [0, 1])
def test_arbiter_equal_reference(ref, seed):
    # by module name: a failed earlier import of `repro.fleet` in this
    # process leaves the submodule loaded but unbound on the package
    ref_arbiter = importlib.import_module("repro.fleet.arbiter")
    rng = np.random.default_rng(seed)
    jobs = [(f"j{k}", tuple(sorted(rng.choice(8, size=4, replace=False))),
             float(rng.choice(PRIORITIES))) for k in range(5)]
    cap = rng.uniform(100, 5000, (8, 8))
    reach = rng.random((8, 8)) > 0.2
    for kw in ({}, {"reachable": reach}):
        want = ref_arbiter.arbitrate(jobs, 8, 8, cap, **kw)
        got = arbiter.arbitrate(jobs, 8, 8, cap, **kw)
        for name, _, _ in jobs:
            assert got[name].max_conns == want[name].max_conns
            np.testing.assert_array_equal(got[name].link_cap,
                                          want[name].link_cap)
