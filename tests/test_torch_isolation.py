"""The port stands alone: it imports neither jax nor the reference
package, its entry points do not fall back to the CPU, its kernel
wrapper refuses what the kernel does not take, and every gate that is
not yet ported raises `NotImplementedError`."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.control import BudgetEnvelope, WanifyController
from repro_torch.core.forest import RandomForest
from repro_torch.core.predictor import BwPredictor, SnapshotPredictor
from repro_torch.fleet import (BatchedRfPredictor, FleetController, JobSpec,
                               default_fleet_forest)
from repro_torch.kernels import ops
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
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_names_jax_or_reference():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 25
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
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _controller(overlay="on")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _controller(lifecycle=object())
    ctl = _controller(envelope=BudgetEnvelope(max_conns=4))
    assert ctl.faults is None
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ctl.faults = object()
    ctl.faults = None
    monkeypatch.setenv("REPRO_OVERLAY", "on")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _controller()
    with pytest.raises(ValueError, match="unknown overlay"):
        _controller(overlay="sideways")


def _fleet(**kw):
    return FleetController(
        WanSimulator(seed=0),
        BatchedRfPredictor(default_fleet_forest(), device="cpu"),
        jobs=(JobSpec("a", dcs=(0, 1, 2)),), **kw)


def test_fleet_gates_not_yet_ported(monkeypatch):
    for faults in ("on", object()):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            _fleet(faults=faults)
    fleet = _fleet(faults="off")
    for call in (lambda: fleet.job_planner("a", None), fleet.fused,
                 lambda: fleet.run_fused(2)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            call()
    monkeypatch.setenv("REPRO_FAULTS", "on")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _fleet()


def test_device_waterfill_not_yet_ported(monkeypatch):
    sim = WanSimulator(seed=0, waterfill_backend="jax")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        sim.waterfill(np.ones((8, 8)))
    monkeypatch.setenv("REPRO_WATERFILL_BACKEND", "cuda")
    with pytest.raises(ValueError, match="unknown waterfill backend"):
        WanSimulator(seed=0).waterfill(np.ones((8, 8)))
