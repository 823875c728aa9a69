"""The port's serve slice against the JAX reference, on
`reduced(get_config("mamba2-2.7b"))` (4 layers, d_model 128, 16 SSD
heads of P=N=16, chunk 16) with the reference's parameters carried
across by `load_reference_params`.

Tolerances:
- `dtype="float32"`: logits within atol/rtol 1e-4 (7.6e-6 measured);
  the two frameworks differ only in the order of their f32 sums, so
  the served ids are equal.
- the config's own bf16: logits within atol 0.0625 (two bf16 ulps at
  their magnitude). The port rounds where the reference's compiled HLO
  does
  (`layers.silu`, `ssm.gated_rms_norm`); what is left is the order of
  the f32 sums inside the products and XLA's own exp / log1p, so the
  ids are held equal wherever the reference's top-2 gap exceeds twice
  the tolerance, and the served ids are equal.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.control import WanifyController, offset_schedule
from repro_torch.core.predictor import SnapshotPredictor
from repro_torch.launch import serve as serve_cli
from repro_torch.models import registry, transformer
from repro_torch.serve.engine import Engine, Request, ServeConfig
from repro_torch.wan.simulator import WanSimulator

F32 = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 0.0625


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: its config, model, engine and control plane."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.configs.base import reduced as ref_reduced
    from repro.control import WanifyController as RefController
    from repro.control import offset_schedule as ref_offset_schedule
    from repro.core.predictor import SnapshotPredictor as RefSnapshot
    from repro.models import registry as ref_registry
    from repro.models.layers import ShardCtx
    from repro.models.transformer import lm_forward as ref_lm_forward
    from repro.serve import engine as ref_engine
    from repro.wan.simulator import WanSimulator as RefSim
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, config=ref_config, reduced=ref_reduced,
        registry=ref_registry, ctx=ShardCtx(remat="none"),
        lm_forward=ref_lm_forward, engine=ref_engine,
        Controller=RefController, offset_schedule=ref_offset_schedule,
        Snapshot=RefSnapshot, Sim=RefSim)


def _models(ref, dtype):
    """(port cfg, port model, reference cfg, reference params)."""
    cfg = reduced(get_config("mamba2-2.7b")).replace(dtype=dtype)
    rcfg = ref.reduced(ref.config("mamba2-2.7b")).replace(dtype=dtype)
    rparams = ref.registry.init_params(rcfg, ref.jax.random.key(0))
    model = registry.build_model(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    registry.load_reference_params(model, ref.jax.tree.map(np.asarray,
                                                           rparams))
    return cfg, model, rcfg, rparams


@pytest.fixture(scope="module")
def f32(ref):
    return _models(ref, "float32")


@pytest.fixture(scope="module")
def bf16(ref):
    return _models(ref, "bfloat16")


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)


def _ref_logits(ref, rcfg, rparams, toks):
    logits, _, _ = ref.lm_forward(rparams, ref.jnp.asarray(toks), rcfg,
                                  ref.ctx)
    return np.asarray(logits, np.float32)


def _port_logits(cfg, model, toks):
    return transformer.lm_forward(model, torch.from_numpy(toks).long(),
                                  cfg).float().numpy()


def test_config_and_params_carry_across(ref, f32):
    cfg, model, rcfg, rparams = f32
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(get_config("mamba2-2.7b")) == \
        dataclasses.asdict(ref.config("mamba2-2.7b"))
    full = get_config("mamba2-2.7b")
    assert (full.n_layers, full.d_model, full.vocab, full.ssm.d_state,
            full.ssm.head_dim, full.ssm.chunk) == (64, 2560, 50280, 128, 64,
                                                   256)
    n_ref = sum(np.size(a) for a in ref.jax.tree.leaves(rparams))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    np.testing.assert_array_equal(
        model.blocks[2].ssm.in_proj.numpy(),
        np.asarray(rparams["blocks"]["ssm"]["in_proj"][2]))


def test_lm_forward_matches_reference_f32(ref, f32):
    cfg, model, rcfg, rparams = f32
    toks = _tokens(cfg, 2, 53, seed=0)          # 53 = 3 chunks + a tail
    want = _ref_logits(ref, rcfg, rparams, toks)
    got = _port_logits(cfg, model, toks)
    np.testing.assert_allclose(got, want, **F32)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_lm_forward_matches_reference_bf16(ref, bf16):
    cfg, model, rcfg, rparams = bf16
    toks = _tokens(cfg, 2, 53, seed=0)
    want = _ref_logits(ref, rcfg, rparams, toks)
    got = _port_logits(cfg, model, toks)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * BF16_ATOL
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def test_prefill_and_decode_match_reference_f32(ref, f32):
    """Prefill of 21 tokens, then 4 decode steps: last logits and the
    cache each step."""
    cfg, model, rcfg, rparams = f32
    toks = _tokens(cfg, 2, 25, seed=1)
    S0 = 21
    rprefill = ref.jax.jit(ref.registry.prefill_fn(rcfg, ref.ctx, 64, tp=1))
    rdecode = ref.jax.jit(ref.registry.decode_fn(rcfg, ref.ctx))
    rlog, rcache = rprefill(rparams, {"tokens": ref.jnp.asarray(toks[:, :S0])})
    plog, pcache = registry.prefill_fn(cfg)(
        model, torch.from_numpy(toks[:, :S0]).long())
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **F32)
    spec = registry.cache_spec(cfg, 2)
    assert [{k: (tuple(v.shape), v.dtype) for k, v in c.items()}
            for c in pcache["blocks"]] == spec["blocks"]
    for t in range(S0, 25):
        rlog, rcache = rdecode(rparams, rcache,
                               ref.jnp.asarray(toks[:, t:t + 1]),
                               ref.jnp.int32(t))
        plog, pcache = registry.decode_fn(cfg)(
            model, pcache, torch.from_numpy(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **F32)
        for k in ("conv", "state"):
            got = torch.stack([c[k] for c in pcache["blocks"]]).numpy()
            np.testing.assert_allclose(got, np.asarray(rcache["blocks"][k]),
                                       **F32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.25)])
def test_decode_matches_own_full_forward(ref, f32, bf16, dtype, tol):
    """The port's prefill + 4 decode steps give its own full forward's
    last logits (as tests/test_serve.py holds the reference); in bf16
    the cache's conv inputs and the forward's differ in rounding."""
    cfg, model, _, _ = f32 if dtype == "float32" else bf16
    toks = torch.from_numpy(_tokens(cfg, 2, 20, seed=2)).long()
    logits, cache = registry.prefill_fn(cfg)(model, toks[:, :16])
    for t in range(16, 20):
        logits, cache = registry.decode_fn(cfg)(model, cache,
                                                toks[:, t:t + 1])
    full = transformer.lm_forward(model, toks, cfg)[:, -1]
    np.testing.assert_allclose(logits.float().numpy(), full.float().numpy(),
                               atol=tol, rtol=tol)


def _requests(cfg, lengths, max_new, request_cls):
    rng = np.random.default_rng(5)
    return [request_cls(rid=i,
                           prompt=rng.integers(1, cfg.vocab,
                                               n).astype(np.int32),
                           max_new=max_new)
            for i, n in enumerate(lengths)]


def test_engine_serve_ids_equal_reference_f32(ref, f32):
    """Three requests over two groups of a batch-2 engine, left-padded
    with token 0 (read as tokens by the SSM on both sides)."""
    cfg, model, rcfg, rparams = f32
    lengths, max_new = (5, 23, 40), 6
    reng = ref.engine.Engine(rcfg, rparams,
                             ref.engine.ServeConfig(batch=2, s_max=64))
    want = reng.serve(_requests(rcfg, lengths, max_new, ref.engine.Request))
    eng = Engine(cfg, model, ServeConfig(batch=2, s_max=64), device="cpu")
    reqs = _requests(cfg, lengths, max_new, Request)
    got = eng.serve(reqs)
    assert got == want
    assert all(r.done and len(r.out) == max_new for r in reqs)
    assert len(eng.timings["prefill_s"]) == 2
    assert len(eng.timings["decode_s"]) == 2 * max_new
    assert eng.last_logits.shape == (2, cfg.vocab)


def test_engine_serve_ids_equal_reference_bf16(ref, bf16):
    """The config's own bf16: the same requests as the f32 case give the
    reference's ids."""
    cfg, model, rcfg, rparams = bf16
    lengths, max_new = (5, 23, 40), 6
    reng = ref.engine.Engine(rcfg, rparams,
                             ref.engine.ServeConfig(batch=2, s_max=64))
    want = reng.serve(_requests(rcfg, lengths, max_new, ref.engine.Request))
    eng = Engine(cfg, model, ServeConfig(batch=2, s_max=64), device="cpu")
    assert eng.serve(_requests(cfg, lengths, max_new, Request)) == want


def test_serve_config_fields_match_reference(ref):
    """The port's ServeConfig has the reference's fields and defaults,
    `tp` and `greedy` included."""
    assert dataclasses.asdict(ServeConfig()) == \
        dataclasses.asdict(ref.engine.ServeConfig())
    assert [f.name for f in dataclasses.fields(ServeConfig)] == \
        [f.name for f in dataclasses.fields(ref.engine.ServeConfig)]


def test_engine_greedy_false_serves_reference_ids_f32(ref, f32):
    """The reference never reads `greedy`, so `greedy=False` serves
    greedily there; the port serves the same ids."""
    cfg, model, rcfg, rparams = f32
    lengths, max_new = (7, 12, 30), 4
    sc = dict(batch=2, s_max=64, greedy=False)
    reng = ref.engine.Engine(rcfg, rparams, ref.engine.ServeConfig(**sc))
    want = reng.serve(_requests(rcfg, lengths, max_new, ref.engine.Request))
    eng = Engine(cfg, model, ServeConfig(**sc), device="cpu")
    got = eng.serve(_requests(cfg, lengths, max_new, Request))
    assert got == want
    greedy = Engine(cfg, model, ServeConfig(batch=2, s_max=64),
                    device="cpu")
    assert greedy.serve(_requests(cfg, lengths, max_new, Request)) == got


def test_engine_tp_above_one_raises(f32):
    """The port serves on one card: `tp=1` builds, `tp=2` raises."""
    cfg, model, _, _ = f32
    assert Engine(cfg, model, ServeConfig(tp=1), device="cpu").sc.tp == 1
    with pytest.raises(ValueError, match="tp=2"):
        Engine(cfg, model, ServeConfig(tp=2), device="cpu")


def test_engine_plan_schedule_equals_reference(ref, f32):
    """The port's controller-driven plan lowers to the reference's
    per-offset schedule, before and after a replan."""
    cfg, model, rcfg, rparams = f32
    ctl = WanifyController(WanSimulator(seed=0), SnapshotPredictor(),
                           n_pods=4)
    rctl = ref.Controller(ref.Sim(seed=0), ref.Snapshot(), n_pods=4)
    eng = Engine(cfg, model, ServeConfig(batch=2), controller=ctl,
                 device="cpu")
    reng = ref.engine.Engine(rcfg, rparams, ref.engine.ServeConfig(batch=2),
                             controller=rctl)
    assert eng.migration_schedule() == reng.migration_schedule()
    for _ in range(3):
        assert eng.replan() is ctl.plan
        reng.replan()
        assert eng.migration_schedule() == reng.migration_schedule() == \
            offset_schedule(ctl.plan) == ref.offset_schedule(rctl.plan)
    eng.plan = ctl.plan
    assert eng.plan is ctl.plan


def test_serve_cli_runs_on_cpu(capsys):
    serve_cli.main(["--arch", "mamba2-2.7b", "--reduced", "--device", "cpu",
                    "--requests", "3", "--batch", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out and "on cpu" in out
