"""The port's water-fill against the JAX reference's device fill and the
host numpy loop.

The reference `repro.kernels.waterfill.fill_rates` is the batched
`lax.while_loop` in f64; the port's `ops.fill_rates` takes its plain
version for CPU tensors and the hand-written kernel (csrc/waterfill.cu)
for CUDA ones. All of them, and the simulator's numpy loop, must agree
to the reference's own contract: rates within rtol/atol 1e-9 and the
same iteration count (tests/test_waterfill_kernel.py). The cases are
built as the reference's tests build them: fluctuation, uncredited
cross-traffic, rival tenants and §3.2.2 caps.

The reference imports `jax.experimental.enable_x64`, which jax 0.9
dropped; its fixture installs a stand-in only when it is missing. It is
imported by a fixture, so the card-only cases (marked `cuda`) run where
jax is not installed:
``python -m pytest -q -m cuda tests/test_torch_waterfill.py``.

That the kernels give an earlier build's bits (rates, iterations,
flags) is checked on the card, not here: ``scripts/fill_costs.py
--other <waterfill.cu>`` builds the other source and compares the two
on every shape of chip_smoke.py's water-fill phase.
"""
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import waterfill as wfk
from repro_torch.kernels.ref import fill_rates_ref
from repro_torch.scenarios import get_scenario, run_scenario
from repro_torch.wan.simulator import (FILL_BACKENDS, WanSimulator,
                                       WaterfillDivergence, fill_rates_host)

QUIET = dict(fluct_sigma=0.0, snapshot_sigma=0.0, runtime_sigma=0.0)
R8 = WanSimulator().regions
TOL = dict(rtol=1e-9, atol=1e-9)
CASES = 12
# (B, N) of chip_smoke.py's water-fill phase: the fused tick's and the
# sweep's batches, a batch that is not a whole number of the warp path's
# fills a block, and the block path's smallest mesh
CARD_SHAPES = [(1, 8), (16, 8), (1, 16), (64, 16), (1, 32), (2, 8), (5, 8),
               (32, 8), (3, 9)]
INT_FIELDS = ("step", "events", "n_pods", "plan_sig", "conns_total",
              "replans", "cache_builds", "cache_hits")


@pytest.fixture(scope="module")
def ref():
    """The reference `repro.kernels.waterfill`."""
    import jax
    import jax.experimental
    shim = not hasattr(jax.experimental, "enable_x64")
    before = set(sys.modules)
    if shim:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    import repro.kernels.waterfill
    yield repro.kernels.waterfill
    if shim:
        del jax.experimental.enable_x64
        for name in set(sys.modules) - before:
            if name == "repro" or name.startswith("repro."):
                del sys.modules[name]


def random_sim(rng, n, seed):
    """A fluctuated simulator over an n-DC mesh (n=16 doubles the 8-DC
    testbed: duplicate regions give zero-distance pairs, the most
    heterogeneous RTT weights the fill can see)."""
    sim = WanSimulator(regions=(R8 * (n // 8 + 1))[:n], seed=seed)
    sim.advance(int(rng.integers(0, 4)))
    if rng.random() < 0.5:                       # uncredited cross-traffic
        bg = rng.integers(0, 4, (n, n)).astype(float)
        for i in range(n):
            for j in range(n):
                if bg[i, j]:
                    sim.set_background(i, j, bg[i, j])
    if rng.random() < 0.5:                       # rival registered tenants
        for t in range(int(rng.integers(1, 3))):
            tc = rng.integers(0, 3, (n, n)).astype(float)
            sim.set_tenant_conns(f"rival{t}", tc)
    return sim


def random_case(rng, n, seed):
    """(c, single, egress, ingress, w, path_cap) of one fill: the
    aggregate conns the simulator would hand its loop (rivals and
    cross-traffic included) and its loop invariants."""
    sim = random_sim(rng, n, seed)
    c = rng.integers(0, 7, (n, n)).astype(float)
    np.fill_diagonal(c, 0.0)
    cap = rng.uniform(50.0, 2000.0, (n, n)) if rng.random() < 0.4 else None
    return (sim._contending_conns(c, None),) + sim.fill_inputs(cap)


def random_batch(n, B, seed):
    """B cases of one n-DC mesh, stacked: [B,N,N] and [B,N] inputs with
    a per-fill w."""
    rng = np.random.default_rng(seed)
    cases = [random_case(rng, n, seed=seed * 1000 + b) for b in range(B)]
    return tuple(np.stack(a) for a in zip(*cases))


# ----------------------------------------------------------------------
# the plain version against the reference and the host loop
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [3, 8, 16, 9])
def test_plain_matches_reference_and_host_loop(ref, n):
    """Same rates to 1e-9 and the same iteration count as the
    reference's device fill and the port's numpy loop, on 12 cases."""
    rng = np.random.default_rng(100 + n)
    for trial in range(CASES):
        case = random_case(rng, n, seed=1000 * n + trial)
        want, want_iters, ok = fill_rates_host(*case, wfk.max_fill_iters(n))
        assert ok
        r_rate, r_iters, r_ok = ref.fill_rates(*case)
        rate, iters, conv = wfk.fill_rates(*case, device="cpu")
        assert bool(r_ok) and bool(conv)
        assert int(iters) == int(r_iters) == want_iters
        np.testing.assert_allclose(rate, want, **TOL)
        np.testing.assert_allclose(rate, r_rate, **TOL)


def one_dc_batch(B, seed):
    """B fills of a 1-DC mesh (N = 1: the one pair carries flows, so the
    fill runs), synthetic: the simulator needs two DCs for its RTTs."""
    rng = np.random.default_rng(seed)
    c = rng.integers(1, 7, (B, 1, 1)).astype(float)
    single = rng.uniform(50.0, 500.0, (B, 1, 1))
    return (c, single, rng.uniform(100.0, 3000.0, (B, 1)),
            rng.uniform(100.0, 3000.0, (B, 1)), rng.uniform(0.2, 1.0,
                                                            (B, 1, 1)),
            np.minimum(single * 4.0, rng.uniform(50.0, 2000.0, (B, 1, 1))))


def dead_pair_batch(B, seed):
    """B 8-DC fills with DC b % 8 dark: its links keep their flows at
    single = path_cap = 0 (the fault plane's blackout)."""
    c, single, egress, ingress, w, path_cap = random_batch(8, B, seed)
    for b in range(B):
        d = b % 8
        for m in (single[b], path_cap[b]):
            m[d, :] = 0.0
            m[:, d] = 0.0
    return c, single, egress, ingress, w, path_cap


def dead_pairs(c, single, path_cap) -> int:
    off = ~np.eye(c.shape[-1], dtype=bool)
    return int(((c > 0) & off & ((single <= 0) | (path_cap <= 0))).sum())


EDGE_BATCHES = {"B5N8": lambda: random_batch(8, 5, seed=58),
                "N1": lambda: one_dc_batch(4, seed=1),
                "N9": lambda: random_batch(9, 3, seed=9),
                "dead_pairs": lambda: dead_pair_batch(3, seed=66),
                "N16": lambda: random_batch(16, 2, seed=16),
                "N32": lambda: random_batch(32, 1, seed=32)}


@pytest.mark.parametrize("name", list(EDGE_BATCHES))
def test_plain_matches_reference_and_host_loop_on_edge_batches(ref, name):
    """The plain version (one batched call) against the reference's
    batched fill and the host loop fill by fill: rates to 1e-9, equal
    iterations, converged."""
    case = EDGE_BATCHES[name]()
    if name == "dead_pairs":
        assert dead_pairs(case[0], case[1], case[5]) > 0
    rate, iters, ok = wfk.fill_rates(*case, device="cpu")
    r_rate, r_iters, r_ok = ref.fill_rates(*case)
    n = case[0].shape[-1]
    assert ok.all() and r_ok.all() and iters.min() > 0
    assert iters.tolist() == r_iters.tolist()
    np.testing.assert_allclose(rate, r_rate, **TOL)
    for b in range(case[0].shape[0]):
        want, want_iters, want_ok = fill_rates_host(
            *(a[b] for a in case), wfk.max_fill_iters(n))
        assert want_ok and int(iters[b]) == want_iters
        np.testing.assert_allclose(rate[b], want, **TOL)


def test_batched_fill_equals_per_matrix_fills():
    """One [B,N,N] call equals B single fills, with a shared [N,N] w and
    with one w a fill."""
    c, single, egress, ingress, w, path_cap = random_batch(8, 5, seed=7)
    for shared in (True, False):
        ww = w[0] if shared else w
        rate, iters, ok = wfk.fill_rates(c, single, egress, ingress, ww,
                                         path_cap, device="cpu")
        assert rate.shape == (5, 8, 8) and iters.shape == ok.shape == (5,)
        assert ok.all()
        for b in range(5):
            one = wfk.fill_rates(c[b], single[b], egress[b], ingress[b],
                                 ww if shared else w[b], path_cap[b],
                                 device="cpu")
            np.testing.assert_allclose(rate[b], one[0], **TOL)
            assert int(iters[b]) == int(one[1])


def test_iteration_bound_reports_unconverged(monkeypatch):
    """At the iteration bound with pairs left, the flag says so and the
    iteration count is the bound (the caller raises)."""
    c, single, egress, ingress, w, path_cap = random_batch(8, 2, seed=3)
    t = [torch.from_numpy(a) for a in (c, single, egress, ingress, w,
                                       path_cap)]
    full = fill_rates_ref(*t)
    assert bool(full[2].all()) and int(full[1].max()) > 1
    assert wfk.max_fill_iters(8) == 512
    import repro_torch.kernels.ref as ref_mod
    monkeypatch.setattr(ref_mod, "max_fill_iters", lambda n: 1)
    capped = fill_rates_ref(*t)
    assert not bool(capped[2].any()) and capped[1].tolist() == [1, 1]


# ----------------------------------------------------------------------
# the simulator's backend dispatch
# ----------------------------------------------------------------------
def test_backend_dispatch(monkeypatch):
    """The instance wins, then $REPRO_WATERFILL_BACKEND, then numpy;
    "jax" and unknown names raise naming the three backends."""
    monkeypatch.delenv("REPRO_WATERFILL_BACKEND", raising=False)
    assert FILL_BACKENDS == ("numpy", "torch", "cuda")
    sim = WanSimulator(seed=5, **QUIET)
    assert sim._fill_backend() == "numpy"
    monkeypatch.setenv("REPRO_WATERFILL_BACKEND", "torch")
    assert sim._fill_backend() == "torch"
    sim.waterfill_backend = "numpy"
    assert sim._fill_backend() == "numpy"
    for bad in ("jax", "tpu"):
        sim.waterfill_backend = bad
        with pytest.raises(ValueError, match="'numpy', 'torch', 'cuda'"):
            sim._fill_backend()
    sim.waterfill_backend = None
    monkeypatch.setenv("REPRO_WATERFILL_BACKEND", "quantum")
    with pytest.raises(ValueError, match="quantum"):
        WanSimulator(seed=0).waterfill(np.ones((8, 8)))


def test_torch_backend_agrees_with_numpy():
    """One fill through the "torch" backend: rates to 1e-9, the same
    iterations, counted as a fill."""
    conns = np.full((8, 8), 3.0)
    np.fill_diagonal(conns, 0.0)
    host = WanSimulator(seed=5, **QUIET)
    plain = WanSimulator(seed=5, waterfill_backend="torch", **QUIET)
    np.testing.assert_allclose(plain.waterfill(conns), host.waterfill(conns),
                               **TOL)
    assert plain.fill_calls == 1
    assert plain.last_fill_iters == host.last_fill_iters > 0


def test_cuda_backend_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = WanSimulator(seed=0, waterfill_backend="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.waterfill(np.ones((8, 8)))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_unconverged_fill_raises_divergence(monkeypatch, backend):
    """The dispatch honours the fill's converged flag."""
    def fake_fill(c, *a, device=None):
        return np.zeros_like(c), np.asarray(999), np.asarray(False)
    monkeypatch.setattr(wfk, "fill_rates", fake_fill)
    sim = WanSimulator(seed=0, waterfill_backend=backend, **QUIET)
    with pytest.raises(WaterfillDivergence, match="iteration bound"):
        sim.waterfill(np.full((8, 8), 2.0))
    assert sim.last_fill_iters == 999


@pytest.mark.parametrize("name", ["congestion", "elastic", "skew_ramp"])
def test_scenario_on_torch_backend_matches_numpy(name):
    """A scenario's integer trace fields on the "torch" backend equal
    the numpy run's in every step; its floats agree to rtol 1e-9."""
    want = run_scenario(get_scenario(name), seed=3).trace
    spec = get_scenario(name)
    spec.sim_kwargs["waterfill_backend"] = "torch"
    got = run_scenario(spec, seed=3).trace
    assert len(got.steps) == len(want.steps)
    for g, w in zip(got.steps, want.steps):
        for key in INT_FIELDS:
            assert getattr(g, key) == getattr(w, key), (name, g.step, key)
        for key in ("dt", "achieved_min", "achieved_mean", "monitored_min",
                    "monitored_mean", "predicted_min", "predicted_mean"):
            np.testing.assert_allclose(getattr(g, key), getattr(w, key),
                                       rtol=1e-9)


# ----------------------------------------------------------------------
# the wrapper's checks
# ----------------------------------------------------------------------
def _tensors(n=4, B=2):
    c, single, egress, ingress, w, path_cap = random_batch(n, B, seed=1)
    return [torch.from_numpy(a) for a in (c, single, egress, ingress, w[0],
                                          path_cap)]


@pytest.mark.parametrize("case", ["dtype", "type", "device", "contig",
                                  "square", "wide", "single", "egress",
                                  "w", "out_on_cpu"])
def test_wrapper_rejects_bad_inputs(case):
    args = _tensors()
    kw = {}
    if case == "dtype":
        args[1] = args[1].float()
    elif case == "type":
        args[0] = args[0].numpy()
    elif case == "device":
        args[2] = args[2].to("meta")
    elif case == "contig":
        args[5] = args[5].transpose(1, 2)
    elif case == "square":
        args[0] = args[0][:, :, :-1].contiguous()
    elif case == "wide":
        args = _tensors(n=33, B=1)
    elif case == "single":
        args[1] = args[1][:1].contiguous()
    elif case == "egress":
        args[3] = args[3][:, :-1].contiguous()
    elif case == "w":
        args[4] = args[4][:-1].contiguous()
    elif case == "out_on_cpu":
        kw["out"] = tuple(torch.empty(0) for _ in range(3))
    with pytest.raises((TypeError, ValueError)):
        ops.fill_rates(*args, **kw)


def test_wrapper_counts_no_launch_on_cpu():
    before = ops.fill_rates.launches
    rate, iters, ok = ops.fill_rates(*_tensors())
    assert rate.shape == (2, 4, 4) and rate.dtype == torch.float64
    assert iters.dtype == torch.int32 and ok.dtype == torch.bool
    assert ops.fill_rates.launches == before


# ----------------------------------------------------------------------
# the kernel on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=lambda s: f"B{s[0]}N{s[1]}")
def test_kernel_matches_plain_and_host_loop_on_card(card, shape):
    """The kernel against the plain version on the same inputs and
    against the host loop per fill: rates to 1e-9, equal iterations;
    one launch a call."""
    B, n = shape
    case = random_batch(n, B, seed=B * 100 + n)
    t = [torch.from_numpy(a).to(card) for a in case]
    before = ops.fill_rates.launches
    rate, iters, ok = ops.fill_rates(*t)
    torch.cuda.synchronize()
    assert ops.fill_rates.launches == before + 1
    p_rate, p_iters, p_ok = fill_rates_ref(*[a.cpu() for a in t])
    assert ok.cpu().all() and p_ok.all()
    assert iters.cpu().tolist() == p_iters.tolist()
    np.testing.assert_allclose(rate.cpu().numpy(), p_rate.numpy(), **TOL)
    for b in range(B):
        want, want_iters, _ = fill_rates_host(
            *(a[b] for a in case), wfk.max_fill_iters(n))
        assert int(iters[b]) == want_iters
        np.testing.assert_allclose(rate[b].cpu().numpy(), want, **TOL)


@pytest.mark.cuda
def test_numpy_wrapper_one_launch_on_card(card):
    """The numpy call: one launch, the plain version's answer."""
    case = random_batch(8, 3, seed=11)
    before = ops.fill_rates.launches
    rate, iters, ok = wfk.fill_rates(*case)
    assert ops.fill_rates.launches == before + 1
    p_rate, p_iters, p_ok = wfk.fill_rates(*case, device="cpu")
    assert ok.all() and (iters == p_iters).all()
    np.testing.assert_allclose(rate, p_rate, **TOL)
    one = wfk.fill_rates(*(a[0] for a in case))
    assert one[0].shape == (8, 8) and int(one[1]) == int(p_iters[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8), (5, 8), (3, 9)],
                         ids=lambda s: f"B{s[0]}N{s[1]}")
def test_numpy_call_equals_tensor_call_on_card(card, shape):
    """The numpy call (one C call: staging, copies, launch, synchronise)
    gives the tensor call's bits on the same inputs, with a shared w and
    one w a fill, and counts one launch a call."""
    B, n = shape
    case = random_batch(n, B, seed=B * 10 + n)
    for w in (case[4][0], case[4]):
        args = case[:4] + (w,) + case[5:]
        before = ops.fill_rates.launches
        rate, iters, ok = wfk.fill_rates(*args)
        assert ops.fill_rates.launches == before + 1
        t = ops.fill_rates(*[torch.from_numpy(np.ascontiguousarray(a))
                             .to(card) for a in args])
        torch.cuda.synchronize()
        np.testing.assert_array_equal(rate, t[0].cpu().numpy())
        np.testing.assert_array_equal(iters, t[1].cpu().numpy())
        np.testing.assert_array_equal(ok, t[2].cpu().numpy())


BAD_SHAPES = ["wide", "square", "single", "egress", "w", "rank"]


def _bad_shape_args(case):
    c, single, egress, ingress, w, path_cap = random_batch(4, 2, seed=1)
    if case == "wide":
        c, single, egress, ingress, w, path_cap = random_batch(33, 1, seed=1)
    elif case == "square":
        c = c[:, :, :-1]
    elif case == "single":
        single = single[:1]
    elif case == "egress":
        egress = egress[:, :-1]
    elif case == "w":
        w = w[:, :-1]
    elif case == "rank":
        c = c[None]
    return c, single, egress, ingress, w, path_cap


@pytest.mark.parametrize("case", BAD_SHAPES)
def test_numpy_call_rejects_bad_shapes(case):
    with pytest.raises(ValueError):
        wfk.fill_rates(*_bad_shape_args(case), device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("case", BAD_SHAPES)
def test_numpy_call_rejects_bad_shapes_before_a_launch(card, case):
    before = ops.fill_rates.launches
    with pytest.raises(ValueError):
        wfk.fill_rates(*_bad_shape_args(case))
    assert ops.fill_rates.launches == before


@pytest.mark.cuda
def test_kernel_rejects_bad_outputs_on_card(card):
    t = [a.to(card) for a in _tensors()]
    good = (torch.empty((2, 4, 4), dtype=torch.float64, device=card),
            torch.empty(2, dtype=torch.int32, device=card),
            torch.empty(2, dtype=torch.bool, device=card))
    for k, bad in ((0, good[0].float()), (1, good[1][:1]),
                   (2, good[2].cpu())):
        out = list(good)
        out[k] = bad
        with pytest.raises(ValueError, match="out must be"):
            ops.fill_rates(*t, out=tuple(out))
    with pytest.raises(ValueError, match="N <= 32"):
        ops.fill_rates(*[a.to(card) for a in _tensors(n=33, B=1)])
