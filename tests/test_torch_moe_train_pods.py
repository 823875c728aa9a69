"""The MoE family's 4-pod WANify run (`granite-moe-1b-a400m` reduced, f32)
against the reference's live run in a subprocess with 4 host devices:
events and plans identical, losses within FOUR_POD_F32_RTOL (5e-7) and
each step's pod-mean expert_load within LOAD_TOL (1e-6). The model,
the fixtures and the other tolerances are `tests/test_torch_moe_train.py`'s
(this run lives in a file of its own so that the test workers share the
suite's longest runs).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_moe_train import (LOAD_TOL, _record_loads, built,  # noqa: F401
                                  from_reference, ref)
from test_torch_train import DEADLINE, FOUR_POD_F32_RTOL, SRC, _rel
from repro_torch.core.predictor import BwPredictor
from repro_torch.data import pipeline
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.wan.dataset import train_default_forest
from repro_torch.wan.simulator import WanSimulator


_REFERENCE_PODS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from repro import compat
    from repro.configs import get_config
    from repro.configs.base import reduced
    from repro.core.predictor import BwPredictor
    from repro.data.pipeline import DataConfig
    from repro.train.loop import LoopConfig, Trainer
    from repro.wan.dataset import train_default_forest
    from repro.wan.simulator import WanSimulator

    rf, _, _ = train_default_forest(n_samples=150, n_trees=40)
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    cfg = cfg.replace(dtype="float32")
    tr = Trainer(cfg, compat.make_mesh((4,), ("pod",)),
                 DataConfig(batch=8, seq=32, vocab=cfg.vocab, n_pods=4,
                            skew=0.5),
                 LoopConfig(steps=5, sync="wanify", compress=True,
                            replan_every=2, straggler_factor=1e9),
                 sim=WanSimulator(seed=0), predictor=BwPredictor(rf))
    loads = []
    build = tr._build_step

    def wrapped(plan):
        fn = build(plan)

        def step(*a):
            p, s, out = fn(*a)
            loads.append(np.asarray(out["expert_load"]).tolist())
            return p, s, out
        return step
    tr._build_step = wrapped
    first = (tr.plan.conns, tr.plan.compress_bits)
    tr.run(jax.random.key(0))
    json.dump({"history": tr.history, "events": tr.events, "first": first,
               "conns": tr.plan.conns, "bits": tr.plan.compress_bits,
               "signature": repr(tr.plan.signature()), "loads": loads},
              open(sys.argv[1], "w"))
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def ref_pods(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_ref") / "pods.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE_PODS, str(path)],
                       capture_output=True, text=True, env=env,
                       timeout=DEADLINE)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def forest():
    return train_default_forest(n_samples=150, n_trees=40)[0]


def test_four_pod_wanify_trainer_matches_reference(built, ref_pods, forest,
                                                   from_reference):
    """4 pods, skew 0.5, `sync="wanify"`, `compress=True`, a replan every
    2 steps fed the skew weights, the forest on the host (f32): events
    and plans identical to the reference's live run, losses within
    FOUR_POD_F32_RTOL and each step's pod-mean expert_load within
    LOAD_TOL (the router's top-k of each pod's own batch)."""
    cfg, _, rparams = built("float32")
    want = ref_pods
    from_reference(rparams)
    tr = Trainer(cfg, 4, pipeline.DataConfig(batch=8, seq=32,
                                             vocab=cfg.vocab, n_pods=4,
                                             skew=0.5),
                 LoopConfig(steps=5, sync="wanify", compress=True,
                            replan_every=2, straggler_factor=1e9),
                 sim=WanSimulator(seed=0),
                 predictor=BwPredictor(forest, device="cpu"), device="cpu")
    loads = []
    _record_loads(tr, loads)
    assert [list(map(list, tr.plan.conns)), list(tr.plan.compress_bits)] \
        == want["first"]
    tr.run(0)
    assert tr.events == want["events"] == ["replanned at step 1",
                                           "replanned at step 3"]
    assert [list(r) for r in tr.plan.conns] == want["conns"]
    assert list(tr.plan.compress_bits) == want["bits"]
    assert repr(tr.plan.signature()) == want["signature"]
    assert [h["step"] for h in tr.history] == [w["step"] for w in
                                               want["history"]]
    gaps = [_rel(g["loss"], w["loss"]) for g, w in zip(tr.history,
                                                       want["history"])]
    assert max(gaps) <= FOUR_POD_F32_RTOL, gaps
    assert len(loads) == len(want["loads"]) == 5
    for got, w in zip(loads, want["loads"]):
        np.testing.assert_allclose(got, np.asarray(w, np.float32), rtol=0,
                                   atol=LOAD_TOL)
        assert abs(got.sum() - cfg.n_layers) <= LOAD_TOL
