"""MLA's (`minicpm3-4b` reduced: 2 layers, Dq 16 + 8, Dv 16) 4-pod
WANify run against the reference's live run in a subprocess with 4 host
devices, as `tests/test_torch_train_pods.py` runs the other families':
4 pods, skew 0.5, `sync="wanify"`, `compress=True`, a replan every 2
steps fed the skew weights, the forest on the host, in f32 (as the ssm,
hybrid and MoE families' runs; bf16 training is held by the 1-pod
Trainer's run in `tests/test_torch_mla_train.py`). Events and plans
identical; losses within FOUR_POD_F32_RTOL (5e-7).

The compressed sync on MLA's leaves (the q-LoRA pair and its norm
vector, wkv_a, kv_norm, wkv_b, wo, stacked [L, ...] with a leading pod
dim) is bit-equal to the reference's jitted `wan_allreduce_batched` in
each of `tests/test_torch_wansync.py`'s plans (`final_norm`, a 1-D leaf
of every family, within 3 f32 ulps: ROADMAP section 3).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_mla_train import _cut
from test_torch_train import (DEADLINE, FOUR_POD_F32_RTOL,  # noqa: F401
                              SRC, forest)
from test_torch_train_pods import _four_pod_trainer, _loss_gaps
from test_torch_wansync import CASES, PLANS, make_plan
from repro_torch.core.wansync import wan_allreduce_batched
from repro_torch.models import registry, transformer

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
    for dtype in ("float32",):
        cfg = reduced(get_config("minicpm3-4b")).replace(dtype=dtype)
        tr = Trainer(cfg, compat.make_mesh((4,), ("pod",)),
                     DataConfig(batch=8, seq=32, vocab=cfg.vocab, n_pods=4,
                                skew=0.5),
                     LoopConfig(steps=5, sync="wanify", compress=True,
                                replan_every=2, straggler_factor=1e9),
                     sim=WanSimulator(seed=0), predictor=BwPredictor(rf))
        first = (tr.plan.conns, tr.plan.compress_bits)
        tr.run(jax.random.key(0))
        out[dtype] = {"history": tr.history, "events": tr.events,
                      "first": first, "conns": tr.plan.conns,
                      "bits": tr.plan.compress_bits,
                      "signature": repr(tr.plan.signature())}
    json.dump(out, open(sys.argv[1], "w"))
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def ref_pods(tmp_path_factory):
    path = tmp_path_factory.mktemp("mla_ref") / "pods.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE_PODS, str(path)],
                       capture_output=True, text=True, env=env,
                       timeout=DEADLINE)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.fixture
def from_reference_init(monkeypatch):
    """The port's Trainers start from the reference's init of `cfg`
    (drawn here, in this process, as the subprocess draws it)."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models import registry as ref_registry

    def use(dtype):
        rparams = jax.tree.map(np.asarray, ref_registry.init_params(
            ref_reduced(ref_config("minicpm3-4b")).replace(dtype=dtype),
            jax.random.key(0)))
        build = registry.build_model

        def init(cfg, generator, device):
            model = build(cfg, generator, device)
            registry.load_reference_params(model, rparams)
            return model
        monkeypatch.setattr(registry, "init_params", init)
    return use


@pytest.mark.parametrize("dtype", ["float32"])
def test_four_pod_wanify_trainer_matches_reference(ref_pods, forest,
                                                   from_reference_init,
                                                   dtype):
    """The 4-pod compressed WANify run of the reduced MLA model against
    the reference's live run: the first plan, the events (two replans),
    the last plan and its signature identical; every step's loss within
    FOUR_POD_F32_RTOL."""
    cfg = _cut("reduced").replace(dtype=dtype)
    want = ref_pods[dtype]
    from_reference_init(dtype)
    tr = _four_pod_trainer(cfg, forest)
    assert [list(map(list, tr.plan.conns)), list(tr.plan.compress_bits)] \
        == want["first"]
    tr.run(0)
    assert tr.events == want["events"] == ["replanned at step 1",
                                           "replanned at step 3"]
    assert [list(r) for r in tr.plan.conns] == want["conns"]
    assert list(tr.plan.compress_bits) == want["bits"]
    assert repr(tr.plan.signature()) == want["signature"]
    gaps = _loss_gaps(tr.history, want)
    assert max(gaps) <= FOUR_POD_F32_RTOL, gaps
    assert all(np.isfinite(h["grad_norm"]) for h in tr.history)


@pytest.mark.parametrize("case", list(CASES))
def test_mla_leaves_sync_bit_equal_to_reference(case):
    """The batched sync (a leading pod dim, as the Trainer holds it) of
    an f32 gradient tree in the qlora config's stacked layout, each pod
    its own gradients: bit-equal to the reference's jitted
    `wan_allreduce_batched` on the same tree under each plan, every leaf
    (MLA's vectors q_norm and kv_norm [L, r] among them) but
    `final_norm`, which is within 3 f32 ulps of its max (one a phase's
    add): a pod's 1-D leaf of 128 elements or more parts from XLA's
    program in the last bits in every family (a fault of the batched
    sync, not of MLA's leaves, listed in ROADMAP section 3)."""
    import jax
    import jax.numpy as jnp

    from repro.core.plan import WanPlan as RefPlan
    from repro.core.wansync import wan_allreduce_batched as ref_wan
    plan, compress, mean = CASES[case]
    spec = PLANS[plan]
    cfg = _cut("qlora")
    model = transformer.model_class(cfg)(cfg, torch.device("meta"),
                                         torch.float32)
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = tuple(v.shape)
    walk(transformer.stack_layers(transformer.param_tree(model),
                                  torch.device("meta")))
    assert {"blocks.attn.q_norm", "blocks.attn.kv_norm",
            "blocks.attn.wq_a", "blocks.attn.wkv_b"} <= set(flat)
    rng = np.random.default_rng(7)
    grads = {p: rng.normal(size=(4,) + s).astype(np.float32)
             for p, s in flat.items()}
    pol = spec["bits_policy"]
    rplan = RefPlan(n_pods=4, conns=tuple(tuple(r) for r in spec["conns"]),
                    pred_bw=tuple(tuple(r) for r in spec["pred_bw"]),
                    compress_bits=(8,) * 4,
                    bits_policy=None if pol is None
                    else tuple((float(t), int(b)) for t, b in pol))
    want = jax.jit(lambda t: ref_wan(t, rplan, compress=compress,
                                     mean=mean))(
        {p: jnp.asarray(a) for p, a in grads.items()})
    got = wan_allreduce_batched({p: torch.from_numpy(a) for p, a in
                                 grads.items()}, make_plan(spec),
                                compress=compress, mean=mean)
    for path in grads:
        g, w = got[path].numpy(), np.asarray(want[path])
        if path == "final_norm":    # ROADMAP section 3: a phase's add each
            ulp = np.spacing(np.float32(np.abs(w).max()))
            assert np.abs(g - w).max() <= 3 * ulp
            continue
        np.testing.assert_array_equal(g, w, err_msg=path)
