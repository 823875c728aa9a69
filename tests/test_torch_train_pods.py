"""The dense, ssm and hybrid families' 4-pod WANify runs against the
reference's live runs (one subprocess with 4 host devices, four runs),
and the control of their f32 bound: 4 pods, skew 0.5, `sync="wanify"`,
`compress=True`, a replan every 2 steps, the forest on the host.
Tolerances, models and fixtures are `tests/test_torch_train.py`'s (these
runs live in a file of their own so that the test workers share the
suite's longest runs).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_train import (DEADLINE, FOUR_POD_BF16_RTOL,  # noqa: F401
                              FOUR_POD_F32_RTOL, HYBRID_ARCH, SRC, SSM_ARCH,
                              _rel, built, forest, from_reference, ref)
from repro_torch.core.predictor import BwPredictor
from repro_torch.data import pipeline
from repro_torch.train import train_step
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.wan.simulator import WanSimulator


_REFERENCE_PODS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from repro import compat
    from repro.configs import get_config
    from repro.configs.base import reduced
    from repro.core.predictor import BwPredictor
    from repro.data.pipeline import DataConfig
    from repro.train.loop import LoopConfig, Trainer
    from repro.wan.dataset import train_default_forest
    from repro.wan.simulator import WanSimulator

    rf, _, _ = train_default_forest(n_samples=150, n_trees=40)
    out = {}
    for key, arch, dtype in (("float32", "h2o-danube-1.8b", "float32"),
                             ("bfloat16", "h2o-danube-1.8b", "bfloat16"),
                             ("mamba2-2.7b-float32", "mamba2-2.7b",
                              "float32"),
                             ("zamba2-2.7b-float32", "zamba2-2.7b",
                              "float32")):
        cfg = reduced(get_config(arch)).replace(dtype=dtype)
        tr = Trainer(cfg, compat.make_mesh((4,), ("pod",)),
                     DataConfig(batch=8, seq=32, vocab=cfg.vocab, n_pods=4,
                                skew=0.5),
                     LoopConfig(steps=5, sync="wanify", compress=True,
                                replan_every=2, straggler_factor=1e9),
                     sim=WanSimulator(seed=0), predictor=BwPredictor(rf))
        first = (tr.plan.conns, tr.plan.compress_bits)
        tr.run(jax.random.key(0))
        out[key] = {"history": tr.history, "events": tr.events,
                      "first": first, "conns": tr.plan.conns,
                      "bits": tr.plan.compress_bits,
                      "signature": repr(tr.plan.signature())}
    json.dump(out, open(sys.argv[1], "w"))
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def ref_pods(tmp_path_factory):
    path = tmp_path_factory.mktemp("train_ref") / "pods.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE_PODS, str(path)],
                       capture_output=True, text=True, env=env,
                       timeout=DEADLINE)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr[-3000:]
    return json.loads(path.read_text())


def _four_pod_trainer(cfg, forest):
    return Trainer(cfg, 4, pipeline.DataConfig(batch=8, seq=32,
                                               vocab=cfg.vocab, n_pods=4,
                                               skew=0.5),
                   LoopConfig(steps=5, sync="wanify", compress=True,
                              replan_every=2, straggler_factor=1e9),
                   sim=WanSimulator(seed=0),
                   predictor=BwPredictor(forest, device="cpu"),
                   device="cpu")


def _loss_gaps(history, want) -> list:
    assert len(history) == len(want["history"]) == 5
    assert [h["step"] for h in history] == [w["step"] for w in
                                            want["history"]]
    return [_rel(g["loss"], w["loss"]) for g, w in zip(history,
                                                       want["history"])]


@pytest.mark.parametrize("arch,dtype", [
    pytest.param("h2o-danube-1.8b", "float32", id="float32"),
    pytest.param("h2o-danube-1.8b", "bfloat16", id="bfloat16"),
    pytest.param(SSM_ARCH, "float32", id=f"{SSM_ARCH}-float32"),
    pytest.param(HYBRID_ARCH, "float32", id=f"{HYBRID_ARCH}-float32")])
def test_four_pod_wanify_trainer_matches_reference(request, ref, built,
                                                   ref_pods, forest,
                                                   from_reference, arch,
                                                   dtype):
    """The run quoted in the slice's motivation: 4 pods, skew 0.5,
    `sync="wanify"`, `compress=True`, a replan every 2 steps fed the
    skew weights, the forest on the host (`rf_predict`'s plain
    version). Events and plans identical to the reference's live run;
    losses within FOUR_POD_F32_RTOL relative in f32
    (FOUR_POD_BF16_RTOL in bf16). `h2o-danube-1.8b` in both dtypes,
    `mamba2-2.7b` and `zamba2-2.7b` in f32 (the reference's run keyed by
    the test's id; the hybrid's shared block synchronised as an
    unstacked subtree, its matrices split along their rows)."""
    cfg, _, rparams = built(arch, dtype)
    want = ref_pods[request.node.callspec.id]
    from_reference(rparams)
    tr = _four_pod_trainer(cfg, forest)
    assert [list(map(list, tr.plan.conns)), list(tr.plan.compress_bits)] \
        == want["first"]
    tr.run(0)
    assert tr.events == want["events"] == ["replanned at step 1",
                                           "replanned at step 3"]
    assert [list(r) for r in tr.plan.conns] == want["conns"]
    assert list(tr.plan.compress_bits) == want["bits"]
    assert repr(tr.plan.signature()) == want["signature"]
    tol = FOUR_POD_F32_RTOL if dtype == "float32" else FOUR_POD_BF16_RTOL
    gaps = _loss_gaps(tr.history, want)
    assert max(gaps) <= tol, gaps
    assert all(np.isfinite(h["grad_norm"]) for h in tr.history)


def test_four_pod_loss_bound_catches_dropped_compression(
        ref, built, ref_pods, forest, from_reference, monkeypatch):
    """A control of the f32 bound: with the sync's compression dropped
    (the port's step syncs uncompressed where the reference's
    compresses) the same run keeps its events and plans, and its losses
    part from the reference's by more than FOUR_POD_F32_RTOL."""
    cfg, _, rparams = built("h2o-danube-1.8b", "float32")
    want = ref_pods["float32"]
    from_reference(rparams)
    sync = train_step.wan_allreduce_batched
    monkeypatch.setattr(train_step, "wan_allreduce_batched",
                        lambda tree, plan, compress=False, mean=True:
                        sync(tree, plan, compress=False, mean=mean))
    tr = _four_pod_trainer(cfg, forest)
    tr.run(0)
    assert tr.events == want["events"]
    gaps = _loss_gaps(tr.history, want)
    assert max(gaps) > FOUR_POD_F32_RTOL, gaps
