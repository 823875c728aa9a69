"""The port's core algorithms against the JAX reference on seeded
predicted-BW matrices. The algorithms are host numpy in both packages,
so results must be equal exactly; the predictor's torch backend must be
bit-equal to the reference's jnp backend."""
import numpy as np
import pytest

from repro.control import ControllerConfig as RefCfg
from repro.control import WanifyController as RefCtl
from repro.core import global_opt as ref_go
from repro.core import local_opt as ref_lo
from repro.core import plan as ref_plan
from repro.core import predictor as ref_pred
from repro.core import relations as ref_rel
from repro.core.forest import RandomForest as RefForest
from repro.wan.dataset import generate_dataset
from repro.wan.simulator import WanSimulator as RefSim
from repro_torch.control import ControllerConfig, WanifyController
from repro_torch.core import global_opt, local_opt, plan, predictor, relations
from repro_torch.core.forest import RandomForest
from repro_torch.wan.simulator import WanSimulator

NS = [3, 8]


def _pred_bw(N, seed):
    rng = np.random.default_rng(seed)
    bw = rng.uniform(80, 2500, (N, N))
    np.fill_diagonal(bw, 10000.0)
    return bw


def _plans_equal(a, b):
    for field in ("pred_bw", "dc_rel", "min_cons", "max_cons", "min_bw",
                  "max_bw", "throttle"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("N", NS)
def test_relations_equal(N):
    for D in (30.0, 100.0, 400.0):
        bw = _pred_bw(N, N)
        np.testing.assert_array_equal(relations.infer_dc_relations(bw, D),
                                      ref_rel.infer_dc_relations(bw, D))


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("seed", [0, 1])
def test_global_optimize_equal(N, seed):
    bw = _pred_bw(N, seed)
    rng = np.random.default_rng(seed + 10)
    w_s = rng.uniform(0.5, 2.0, N)
    cap = np.where(rng.random((N, N)) < 0.4, rng.uniform(200, 3000, (N, N)),
                   np.inf)
    for kw in ({}, {"M": 4, "w_s": w_s}, {"link_cap": cap},
               {"r_vec": rng.uniform(0.8, 1.2, N), "throttle_enabled": False}):
        _plans_equal(ref_go.global_optimize(bw, **kw),
                     global_opt.global_optimize(bw, **kw))


@pytest.mark.parametrize("N", NS)
def test_aimd_steps_equal(N):
    gp_ref = ref_go.global_optimize(_pred_bw(N, 2))
    gp = global_opt.global_optimize(_pred_bw(N, 2))
    rng = np.random.default_rng(N)
    for src in range(N):
        a = ref_lo.AimdAgent.from_plan(gp_ref, src)
        b = local_opt.AimdAgent.from_plan(gp, src)
        for _ in range(6):
            mon = a.target_bw + rng.normal(0, 150, N)
            tb = rng.choice([1 << 10, 1 << 24], N)
            a.step(mon, tb)
            b.step(mon, tb)
            np.testing.assert_array_equal(b.cons, a.cons)
            np.testing.assert_array_equal(b.target_bw, a.target_bw)


@pytest.mark.parametrize("N", NS)
def test_wanplan_signature_equal(N):
    for seed in range(3):
        bw = _pred_bw(N, seed)
        ref = ref_plan.WanPlan.from_global(ref_go.global_optimize(bw))
        port = plan.WanPlan.from_global(global_opt.global_optimize(bw))
        assert port.signature() == ref.signature()
        assert port.ring_chunks() == ref.ring_chunks()
        assert port.pred_bw == ref.pred_bw
        pol = {300.0: 4, 900.0: 8, float("inf"): 16}
        assert plan.WanPlan.from_global(
            global_opt.global_optimize(bw), use_max=False,
            bits_policy=pol).signature() == ref_plan.WanPlan.from_global(
            ref_go.global_optimize(bw), use_max=False,
            bits_policy=pol).signature()


def test_split_budget_equal():
    rng = np.random.default_rng(0)
    for _ in range(200):
        J = int(rng.integers(0, 7))
        M = int(rng.integers(1, 17))
        w = rng.choice([1.0, 2.0, 4.0, 0.3], J)
        np.testing.assert_array_equal(global_opt.split_budget(M, w),
                                      ref_go.split_budget(M, w))


@pytest.fixture(scope="module")
def forest_pair():
    X, y = generate_dataset(n_samples=8, seed=5)
    ref = RefForest(n_trees=30, depth=8, seed=1).fit(X, y)
    port = RandomForest.from_packed(*ref.packed(), ref.depth, seed=1)
    return ref, port


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bw_predictor_backends_equal(forest_pair, seed):
    ref, port = forest_pair
    rng = np.random.default_rng(seed)
    N = 4 + seed
    args = (N, rng.uniform(50, 3000, (N, N)), rng.uniform(0.1, 0.9, N),
            rng.uniform(0.1, 0.9, N), rng.integers(0, 30, (N, N)).astype(float),
            rng.uniform(0, 9000, (N, N)))
    ref_p = ref_pred.BwPredictor(ref)
    port_p = predictor.BwPredictor(port, device="cpu")
    np.testing.assert_array_equal(
        port_p.predict_matrix(*args, backend="numpy"),
        ref_p.predict_matrix(*args, backend="numpy"))
    want = ref_p.predict_matrix(*args, backend="jnp")
    np.testing.assert_array_equal(
        port_p.predict_matrix(*args, backend="torch"), want)
    # no backend named: device "cpu" picks the torch backend
    np.testing.assert_array_equal(port_p.predict_matrix(*args), want)
    with pytest.raises(ValueError, match="CUDA"):
        port_p.predict_matrix(*args, backend="cuda")
    np.testing.assert_array_equal(
        predictor.SnapshotPredictor().predict_matrix(*args),
        ref_pred.SnapshotPredictor().predict_matrix(*args))


def test_bw_predictor_keeps_forest_on_device(forest_pair):
    """The forest's tensors and the kernel's node layout are made once
    per device, not per `predict_matrix` (every `Engine.replan` calls
    it), and made again only when the forest's arrays are replaced."""
    import torch

    ref, port = forest_pair
    port = RandomForest.from_packed(*port.packed(), port.depth, seed=1)
    p = predictor.BwPredictor(port, device="cpu")
    rng = np.random.default_rng(3)
    args = (4, rng.uniform(50, 3000, (4, 4)), rng.uniform(0.1, 0.9, 4),
            rng.uniform(0.1, 0.9, 4), rng.integers(0, 30, (4, 4)).astype(float),
            rng.uniform(0, 9000, (4, 4)))
    first = p.predict_matrix(*args)
    (feat, thr, leaf), nodes = p.forest_on(torch.device("cpu"))
    np.testing.assert_array_equal(p.predict_matrix(*args), first)
    again, again_nodes = p.forest_on(torch.device("cpu"))
    assert again[0] is feat and again_nodes is nodes
    np.testing.assert_array_equal(nodes[..., 0].numpy(), port.feat)
    np.testing.assert_array_equal(nodes[..., 1].numpy(),
                                  port.thr.view(np.int32))
    port.leaf = port.leaf * np.float32(2)            # a refit's new arrays
    (_, _, leaf2), nodes2 = p.forest_on(torch.device("cpu"))
    assert nodes2 is not nodes
    np.testing.assert_array_equal(leaf2.numpy(), port.leaf)
    assert not np.array_equal(p.predict_matrix(*args), first)


@pytest.mark.parametrize("N", NS)
def test_feature_assembly_equal(N):
    rng = np.random.default_rng(N)
    args = (N, rng.uniform(50, 3000, (N, N)), rng.uniform(0.1, 0.9, N),
            rng.uniform(0.1, 0.9, N), rng.integers(0, 30, (N, N)).astype(float),
            rng.uniform(0, 9000, (N, N)))
    X = predictor.assemble_features(*args)
    np.testing.assert_array_equal(X, ref_pred.assemble_features(*args))
    vals = rng.uniform(0, 1, N * (N - 1))
    np.testing.assert_array_equal(predictor.matrix_from_pairs(vals, N, 7.0),
                                  ref_pred.matrix_from_pairs(vals, N, 7.0))


class _JnpPredictor:
    """The reference's BwPredictor on its `jnp` backend, the one the
    port's default on ``device="cpu"`` (backend `torch`) is bit-equal
    to."""

    def __init__(self, forest):
        self.inner = ref_pred.BwPredictor(forest)

    def predict_matrix(self, *args, **kw):
        return self.inner.predict_matrix(*args, backend="jnp", **kw)


def test_controller_replans_equal(forest_pair):
    """A standalone controller: periodic, straggler, rescale and
    topology triggers replan to the same records as the reference."""
    ref_rf, port_rf = forest_pair
    ref = RefCtl(RefSim(seed=1), _JnpPredictor(ref_rf), n_pods=6,
                 cfg=RefCfg(replan_every=2))
    port = WanifyController(WanSimulator(seed=1),
                            predictor.BwPredictor(port_rf, device="cpu"),
                            n_pods=6, cfg=ControllerConfig(replan_every=2))
    for ctl in (ref, port):
        for step in range(6):
            ctl.maybe_replan(step)
            ctl.observe_step_time(1.0 if step != 4 else 9.0, step=step)
        ctl.rescale(4)
        ctl.topology_changed()
        ctl.replan(reason="explicit")
        ctl.rollback_plan(step=9)
    assert port.record == ref.record
    assert port.record[-1]["reason"] == "rollback"
    assert port.events == ref.events
    np.testing.assert_array_equal(port.current_conns(), ref.current_conns())
    np.testing.assert_array_equal(port.last_pred, ref.last_pred)
