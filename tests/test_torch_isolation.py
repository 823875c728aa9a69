"""The port stands alone: it imports neither jax nor the reference
package, its entry points do not fall back to the CPU, its kernel
wrappers refuse what their kernels do not take, and every gate that is
not yet ported raises `NotImplementedError` (now only the model side:
the overlay, the predictor lifecycle and the fault plane are ported,
and their gates construct and run)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, PORTED, get_config
from repro_torch.configs.base import reduced
from repro_torch.control import BudgetEnvelope, WanifyController
from repro_torch.core.forest import RandomForest
from repro_torch.core.predictor import BwPredictor, SnapshotPredictor
from repro_torch.faults import FaultPlane, ProbeTimeoutError
from repro_torch.fleet import (BatchedRfPredictor, FleetController, JobSpec,
                               default_fleet_forest)
from repro_torch.kernels import ops
from repro_torch.lifecycle import LifecycleManager
from repro_torch.models import registry
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.wan.simulator import WanSimulator

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 35
    assert {"repro_torch.configs.mamba2_2_7b", "repro_torch.kernels.ssd_scan",
            "repro_torch.models.ssm", "repro_torch.models.transformer",
            "repro_torch.models.registry", "repro_torch.control.schedule",
            "repro_torch.serve.engine", "repro_torch.launch.serve",
            "repro_torch.compat", "repro_torch.core.wansync",
            "repro_torch.kernels.quantize", "repro_torch.scenarios.engine",
            "repro_torch.scenarios.library", "repro_torch.scenarios.goldens",
            "repro_torch.scenarios.trace", "repro_torch.scenarios.events",
            "repro_torch.faults.events", "repro_torch.lifecycle.manager",
            "repro_torch.fleet.scenario", "repro_torch.fleet.trace",
            "repro_torch.kernels.waterfill", "repro_torch.fleet.fused",
            "repro_torch.placement.query", "repro_torch.placement.cost",
            "repro_torch.placement.optimizer",
            "repro_torch.placement.planner",
            "repro_torch.placement.scenario", "repro_torch.overlay.routing",
            "repro_torch.lifecycle.drift", "repro_torch.lifecycle.harness",
            "repro_torch.lifecycle.probes", "repro_torch.lifecycle.refresh",
            "repro_torch.lifecycle.window", "repro_torch.faults.plane",
            "repro_torch.faults.scenarios", "repro_torch.faults.harness",
            "repro_torch.obs.sle", "repro_torch.obs.export",
            "repro_torch.obs.cli"} <= mods


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_names_jax_or_reference():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 40
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_batched_predictor_defaults_to_cuda_and_raises_without_it(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedRfPredictor(default_fleet_forest())
    assert BatchedRfPredictor(default_fleet_forest(),
                              device="cpu").device.type == "cpu"


def test_bw_predictor_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    args = (4, rng.uniform(50, 3000, (4, 4)), rng.uniform(0.1, 0.9, 4),
            rng.uniform(0.1, 0.9, 4), np.zeros((4, 4)),
            rng.uniform(0, 9000, (4, 4)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BwPredictor(default_fleet_forest()).predict_matrix(*args)
    out = BwPredictor(default_fleet_forest(), device="cpu").predict_matrix(
        *args)
    assert out.shape == (4, 4) and np.isfinite(out).all()


def test_batched_predictor_one_call_per_predict():
    p = BatchedRfPredictor(default_fleet_forest(), device="cpu")
    X = np.random.default_rng(0).uniform(1, 3000, (30, 6))
    vals = p.predict_rows(X)
    assert vals.dtype == np.float64 and vals.shape == (30,)
    assert (vals >= 1.0).all() and p.kernel_calls == 1
    assert [len(v) for v in p.split_rows(vals, [12, 18])] == [12, 18]
    with pytest.raises(ValueError):
        p.split_rows(vals, [12, 12])
    with pytest.raises(ValueError, match="fitted"):
        BatchedRfPredictor(RandomForest(), device="cpu")


def _forest_tensors():
    rf = default_fleet_forest()
    return [torch.from_numpy(a) for a in rf.packed()], rf.depth


@pytest.mark.parametrize("case", ["dtype", "shape", "leaf", "contig", "depth",
                                  "xdim", "type"])
def test_wrapper_rejects_bad_inputs(case):
    (f, t, l), d = _forest_tensors()
    X = torch.ones((5, 6))
    if case == "dtype":
        f = f.to(torch.int64)
    elif case == "shape":
        t = t[:, :-1].contiguous()
    elif case == "leaf":
        l = l[:, :-1].contiguous()
    elif case == "contig":
        X = torch.ones((6, 5)).t()
    elif case == "depth":
        d = d + 1
    elif case == "xdim":
        X = torch.ones(6)
    elif case == "type":
        X = np.ones((5, 6), np.float32)
    with pytest.raises((TypeError, ValueError)):
        ops.rf_predict(f, t, l, X, d)


def test_wrapper_counts_no_launch_on_cpu():
    (f, t, l), d = _forest_tensors()
    before = ops.rf_predict.launches
    out = ops.rf_predict(f, t, l, torch.ones((7, 6)), d)
    assert out.shape == (7,) and ops.rf_predict.launches == before


def _controller(**kw):
    return WanifyController(WanSimulator(seed=0), SnapshotPredictor(),
                            n_pods=4, **kw)


def test_controller_gates_not_yet_ported(monkeypatch):
    """The overlay, a lifecycle manager and a fault plane are ported:
    they construct, route, clamp and degrade; the model side's gates
    still raise."""
    ctl = _controller(overlay="on")
    assert ctl.routed is not None and ctl.record[-1]["overlay"] == "on"
    assert ctl.record[-1]["relays"] == ctl.routed.relays
    mgr = LifecycleManager(SnapshotPredictor(), 8)
    mgr.estimator.push(np.full((8, 8), 10.0))
    ctl = _controller(lifecycle=mgr)
    assert ctl.lifecycle is mgr
    assert ctl.last_pred[0, 1] <= 15.0          # clamped: 1.5 x capacity
    ctl = _controller(envelope=BudgetEnvelope(max_conns=4))
    assert ctl.faults is None and ctl.routed is None
    naive = FaultPlane(8, graceful=False)
    ctl.faults = naive
    assert ctl.faults is naive
    naive.probe_fault("timeout", 2)
    with pytest.raises(ProbeTimeoutError, match="timed out at step 0"):
        ctl.replan(reason="explicit")
    graceful = FaultPlane(8, graceful=True)
    ctl.faults = graceful
    ctl.replan(reason="explicit")             # clean: remembered
    graceful.step = 1
    graceful.probe_fault("timeout", 2)
    graceful.predictor_fault(2, kind="nan", rows=2)
    ctl.replan(reason="explicit")             # stale capture, quarantined
    assert np.isfinite(ctl.last_pred).all() and graceful.retry_usd > 0.0
    assert graceful.metrics.counters()["rows_quarantined"] >= 1
    ctl.faults = None
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_config("llama3-8b")
    monkeypatch.setenv("REPRO_OVERLAY", "on")
    assert _controller().overlay == "on"
    with pytest.raises(ValueError, match="unknown overlay"):
        _controller(overlay="sideways")


def _fleet(**kw):
    return FleetController(
        WanSimulator(seed=0),
        BatchedRfPredictor(default_fleet_forest(), device="cpu"),
        jobs=(JobSpec("a", dcs=(0, 1, 2)),), **kw)


def test_fleet_gates_not_yet_ported(monkeypatch):
    """The fault plane, placement planners and the fused tick are ported
    (`tests/test_torch_faults.py`, `tests/test_torch_placement.py`,
    `tests/test_torch_fused.py`): a plane constructs, graceful or naive,
    and ticks; the model side's gates still raise."""
    fleet = _fleet(faults="on")
    assert fleet.faults is not None and fleet.faults.graceful
    assert fleet.tick()["n_jobs"] == 1
    naive = FaultPlane(8, graceful=False)
    assert _fleet(faults=naive).faults is naive
    with pytest.raises(ValueError, match="unknown faults mode"):
        _fleet(faults=object())
    fleet = _fleet(faults="off")
    assert fleet.faults is None
    with pytest.raises(ValueError, match="snapshot_sigma"):
        fleet.fused()                 # ported: the noisy sim is refused
    monkeypatch.setenv("REPRO_FAULTS", "on")
    assert _fleet().faults.graceful
    dense = _tiny_cfg().replace(family="dense")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        registry.build_model(dense, torch.Generator(), device="cpu")


def test_waterfill_backends_dispatch_without_jax(monkeypatch):
    """The device fill is the port's own: "jax" is no backend of the
    port, "cuda" needs a card (no quiet fall back to the host), "torch"
    runs the plain version on the host."""
    sim = WanSimulator(seed=0, waterfill_backend="jax")
    with pytest.raises(ValueError, match="'numpy', 'torch', 'cuda'"):
        sim.waterfill(np.ones((8, 8)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("REPRO_WATERFILL_BACKEND", "cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WanSimulator(seed=0).waterfill(np.ones((8, 8)))
    monkeypatch.setenv("REPRO_WATERFILL_BACKEND", "torch")
    sim = WanSimulator(seed=0)
    assert sim.waterfill(np.ones((8, 8))).shape == (8, 8)
    assert sim.fill_calls == 1


def _tiny_cfg():
    return reduced(get_config("mamba2-2.7b")).replace(n_layers=1)


def test_model_and_engine_default_to_cuda_and_raise_without_it(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.build_model(cfg, torch.Generator())
    model = registry.build_model(cfg, torch.Generator(), device="cpu")
    assert model.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, model, ServeConfig(batch=1))
    assert Engine(cfg, model, ServeConfig(batch=1),
                  device="cpu").device.type == "cpu"


def _ssd_inputs(dtype=torch.float32, B=1, nC=2, Q=16, H=4, P=8, N=16):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((B, nC, Q, H, P), generator=g).to(dtype),
            torch.randn((B, nC, Q, N), generator=g).to(dtype),
            torch.randn((B, nC, Q, N), generator=g).to(dtype),
            -torch.rand((B, nC, H, Q), generator=g))


@pytest.mark.parametrize("case", ["mixed", "da_dtype", "int", "xshape",
                                  "bshape", "cshape", "dashape", "contig",
                                  "wide_p", "wide_n", "empty", "type",
                                  "device"])
def test_ssd_wrapper_rejects_bad_inputs(case):
    xq, Bq, Cq, da = _ssd_inputs()
    if case == "mixed":
        Bq = Bq.bfloat16()
    elif case == "da_dtype":
        da = da.bfloat16()
    elif case == "int":
        xq, Bq, Cq = (t.to(torch.int32) for t in (xq, Bq, Cq))
    elif case == "xshape":
        xq = xq[0]
    elif case == "bshape":
        Bq = Bq[:, :, :-1].contiguous()
    elif case == "cshape":
        Cq = Cq[..., :-1].contiguous()
    elif case == "dashape":
        da = da.transpose(2, 3).contiguous()
    elif case == "contig":
        xq = xq.transpose(3, 4).contiguous().transpose(3, 4)
    elif case == "wide_p":
        xq, Bq, Cq, da = _ssd_inputs(P=65)
    elif case == "wide_n":
        xq, Bq, Cq, da = _ssd_inputs(N=129)
    elif case == "empty":
        xq, Bq, Cq, da = _ssd_inputs(B=0)
    elif case == "type":
        xq = xq.numpy()
    elif case == "device":
        xq, Bq, Cq, da = (t.to("meta") for t in (xq, Bq, Cq, da))
    with pytest.raises((TypeError, ValueError)):
        ops.ssd_chunk(xq, Bq, Cq, da)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_wrapper_counts_no_launch_on_cpu(dtype):
    before = ops.ssd_chunk.launches
    y, st = ops.ssd_chunk(*_ssd_inputs(dtype))
    assert y.shape == (1, 2, 16, 4, 8) and st.shape == (1, 2, 4, 8, 16)
    assert y.dtype == st.dtype == torch.float32
    assert ops.ssd_chunk.launches == before


def test_model_side_gates_not_yet_ported():
    assert PORTED == ["mamba2-2.7b"] and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        if arch not in PORTED:
            with pytest.raises(NotImplementedError, match="not yet ported"):
                get_config(arch)
    with pytest.raises(KeyError):
        get_config("gpt-5")
    dense = _tiny_cfg().replace(family="dense")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        registry.build_model(dense, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        registry.prefill_fn(dense)


@pytest.mark.parametrize("module", [
    "repro_torch.compat", "repro_torch.core.wansync",
    "repro_torch.kernels.quantize", "repro_torch.control.schedule",
    "repro_torch.serve.engine"])
def test_codec_path_modules_import_no_jax_and_no_reference(module):
    """Each module of the cache-migration and gradient-sync path, on its
    own, pulls in neither jax nor the reference package."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.scenarios", "repro_torch.scenarios.goldens",
    "repro_torch.fleet.scenario", "repro_torch.faults.events",
    "repro_torch.kernels.waterfill"])
def test_scenario_path_modules_import_no_jax_and_no_reference(module):
    """Each module of the scenario engines' path, on its own, pulls in
    neither jax nor the reference package."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.overlay", "repro_torch.overlay.routing",
    "repro_torch.lifecycle", "repro_torch.lifecycle.drift",
    "repro_torch.lifecycle.harness", "repro_torch.lifecycle.manager",
    "repro_torch.lifecycle.probes", "repro_torch.lifecycle.refresh",
    "repro_torch.lifecycle.window"])
def test_plane_modules_import_no_jax_and_no_reference(module):
    """Each module of the overlay and predictor-lifecycle planes, on its
    own, pulls in neither jax nor the reference package."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.fleet.fused", "repro_torch.placement",
    "repro_torch.placement.cost", "repro_torch.placement.optimizer",
    "repro_torch.placement.planner", "repro_torch.placement.scenario"])
def test_fused_and_placement_modules_import_no_jax_and_no_reference(module):
    """Each module of the fused tick's and placement's path, on its
    own, pulls in neither jax nor the reference package."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.faults", "repro_torch.faults.plane",
    "repro_torch.faults.scenarios", "repro_torch.faults.harness",
    "repro_torch.obs", "repro_torch.obs.sle", "repro_torch.obs.export",
    "repro_torch.obs.cli"])
def test_fault_and_obs_modules_import_no_jax_and_no_reference(module):
    """Each module of the fault plane and the obs exports, on its own,
    pulls in neither jax nor the reference package."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
