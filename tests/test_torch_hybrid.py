"""The port's hybrid family (`zamba2-2.7b`: Mamba-2 layers and one shared
attention + MLP block before every `shared_attn_every`-th layer) against
the JAX reference, on `reduced(get_config("zamba2-2.7b"))`: 4 layers,
the shared block before layers 0 and 2 (two applications, each with a
KV cache of its own), d_model 128, 4 heads over 4 KV heads of 32, SSD
d_state 16, head_dim 16, chunk 16, vocab 512. The reference's
parameters are carried across by `load_reference_params`; inputs are
made with numpy from a seed.

Tolerances:
- f32: logits and every cache leaf within atol / rtol 1e-4 (~9e-6
  measured); the served ids are equal.
- bf16 (the config's own dtype): the port rounds where the reference's
  compiled CPU program rounds. The shared block's program inside the
  reference's `lax.scan` / `lax.cond` takes ln2's variance of the f32
  sum x + attn, as the dense block's does, and the port's `DenseBlock`
  mirrors it; given the same inputs the block differs from the
  reference's in under 1% of its outputs (the products' f32 sum order).
  Prefill and decode logits and the cache leaves are held within atol
  0.0625. The full forward's logits (128 positions) are held within
  atol 0.125, four bf16 steps at their magnitude of 4 to 5: a k / v
  projection's sum order flips ~0.006% of its bf16 roundings, the
  softmax spreads them to ~0.2% of the attention's output and the four
  Mamba-2 layers after each application spread them further, so over 6
  seeds the largest difference was 0.043-0.086 (the 4-layer `ssm` and
  2-layer `dense` reduced models: under 0.047 on the same inputs).
  Greedy ids are held equal wherever the reference's top-2 gap exceeds
  twice the tolerance.
- the card against the host (`cuda` case, f32): within 1e-3.

Card-only cases (marked `cuda`) run where jax is not installed:
``python -m pytest -q -m cuda tests/test_torch_hybrid.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import test_torch_migrate as mig
from test_torch_dense import (_f32, _logging_reference, _LoggingEngine,
                              _requests, _tokens)
from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import registry, transformer
from repro_torch.serve.engine import Engine, Request, ServeConfig, kv_migrate

ARCH = "zamba2-2.7b"
DTYPES = ["float32", "bfloat16"]
F32 = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 0.0625
FORWARD_BF16_ATOL = 0.125
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FULL_PARAMS = 2_422_670_240          # jax.eval_shape of init_lm_params


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: its config, model, engine."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models import registry as ref_registry
    from repro.models import transformer as ref_transformer
    from repro.models.layers import ShardCtx
    from repro.serve import engine as ref_engine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, config=ref_config, reduced=ref_reduced,
        registry=ref_registry, transformer=ref_transformer,
        ctx=ShardCtx(remat="none"), engine=ref_engine)


@pytest.fixture(scope="module")
def built(ref):
    """dtype -> (port cfg, port model, ref cfg, ref params), built once
    per module."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cfg = reduced(get_config(ARCH)).replace(dtype=dtype)
            rcfg = ref.reduced(ref.config(ARCH)).replace(dtype=dtype)
            rparams = ref.registry.init_params(rcfg, ref.jax.random.key(0))
            model = registry.build_model(cfg, torch.Generator().manual_seed(0),
                                         device="cpu")
            registry.load_reference_params(
                model, ref.jax.tree.map(np.asarray, rparams))
            cache[dtype] = (cfg, model, rcfg, rparams)
        return cache[dtype]
    return get


def _close(got, want, dtype, bf16_atol=BF16_ATOL):
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    if dtype == "float32":
        np.testing.assert_allclose(g, w, **F32)
    else:
        np.testing.assert_allclose(g, w, atol=bf16_atol, rtol=0)


# ----------------------------------------------------------------------
# configs and parameters
# ----------------------------------------------------------------------
def test_config_equals_reference(ref):
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(ref.config(ARCH))
    assert dataclasses.asdict(reduced(get_config(ARCH))) == \
        dataclasses.asdict(ref.reduced(ref.config(ARCH)))


def test_configs_are_the_published_and_reduced_widths():
    full = get_config(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.resolved_head_dim, full.d_ff, full.vocab,
            full.shared_attn_every) == ("hybrid", 54, 2560, 32, 32, 80,
                                        10240, 32000, 6)
    assert (full.ssm.d_state, full.ssm.head_dim, full.ssm.chunk,
            full.ssm.expand) == (64, 64, 256, 2)
    small = reduced(full)
    assert (small.n_layers, small.shared_attn_every, small.d_model,
            small.n_heads, small.n_kv_heads, small.ssm.d_state,
            small.ssm.head_dim, small.ssm.chunk) == (4, 2, 128, 4, 4, 16,
                                                      16, 16)


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_param_count_matches_reference(ref, size):
    cfg, rcfg = get_config(ARCH), ref.config(ARCH)
    if size == "reduced":
        cfg, rcfg = reduced(cfg), ref.reduced(rcfg)
    n = registry.param_count(cfg)
    assert n == ref.registry.param_count(rcfg)
    if size == "full":
        assert n == FULL_PARAMS


def test_params_carry_across(built, ref):
    cfg, model, _, rparams = built("float32")
    assert isinstance(model, transformer.HybridLM)
    assert set(rparams) == {"embed", "final_norm", "lm_head", "blocks",
                            "shared_attn"}
    n_ref = sum(np.size(a) for a in ref.jax.tree.leaves(rparams))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    np.testing.assert_array_equal(
        model.shared_attn.attn.wq.numpy(),
        np.asarray(rparams["shared_attn"]["attn"]["wq"]))
    np.testing.assert_array_equal(
        model.shared_attn.mlp.w2.numpy(),
        np.asarray(rparams["shared_attn"]["mlp"]["w2"]))
    np.testing.assert_array_equal(
        model.blocks[3].ssm.in_proj.numpy(),
        np.asarray(rparams["blocks"]["ssm"]["in_proj"][3]))


def test_compute_params_keep_the_shared_vectors(built):
    """The reference's `_cast_params` casts leaves of ndim >= 2: the
    stacked layer vectors are cast, the shared block's ln1 / ln2 [d]
    (not stacked) stay in the parameter dtype, as final_norm does."""
    _, model, _, _ = built("bfloat16")
    pc = model.compute_params(torch.bfloat16)
    shared = pc["shared_attn"]
    assert set(shared) == {"ln1", "ln2", "attn", "mlp"}
    assert shared["ln1"].dtype == shared["ln2"].dtype == torch.float32
    for t in (shared["attn"]["wq"], shared["attn"]["wo"],
              shared["mlp"]["w1"], pc["blocks"][0]["ln1"],
              pc["blocks"][0]["ssm"]["A_log"]):
        assert t.dtype == torch.bfloat16
    assert pc["final_norm"].dtype == torch.float32


def test_shared_flags_are_the_references(ref):
    """The shared block runs before layer i where i % every == 0: twice
    in the reduced model, nine times at full depth (layers 0, 6, ...,
    48), twice in a 7-layer cut; never in the other families."""
    small, full = reduced(get_config(ARCH)), get_config(ARCH)
    assert transformer.shared_flags(small) == [True, False, True, False]
    assert [i for i, f in enumerate(transformer.shared_flags(full))
            if f] == list(range(0, 54, 6))
    assert sum(transformer.shared_flags(full.replace(n_layers=7))) == 2
    for cfg in (small, full):
        assert transformer.shared_flags(cfg) == list(
            ref.transformer.np_flags(cfg.n_layers, cfg.shared_attn_every))
    for arch in ("mamba2-2.7b", "llama3-8b"):
        assert not any(transformer.shared_flags(get_config(arch)))


# ----------------------------------------------------------------------
# the shared block and the model
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_shared_block_matches_reference(built, ref, dtype):
    """The shared block (`DenseBlock.run` on the shared parameters)
    against the reference's `_attn_mlp_block` inside `lax.scan` /
    `lax.cond`, as the hybrid's program runs it. f32 within 1e-5; bf16
    under 1% of the outputs apart (the products' sum order)."""
    cfg, model, rcfg, rparams = built(dtype)
    jnp, jax = ref.jnp, ref.jax
    S = 48
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(2, S, 128)).astype(
        np.float32)).to(TDT[dtype])
    jx = jnp.asarray(a.float().numpy()).astype(jnp.dtype(dtype))
    pos = jnp.arange(S)

    def scanned(p, x):
        def body(h, flag):
            h = jax.lax.cond(flag, lambda v: ref.transformer._attn_mlp_block(
                p, v, pos, rcfg, ref.ctx, 1)[0], lambda v: v, h)
            return h, None
        return jax.lax.scan(body, x, jnp.array([True, False]))[0]

    pc = ref.transformer._cast_params(rparams, jnp.dtype(dtype))
    want = _f32(jax.jit(scanned)(pc["shared_attn"], jx))
    with torch.no_grad():
        got = _f32(transformer.DenseBlock.run(
            model.compute_params(TDT[dtype])["shared_attn"], a,
            torch.arange(S), cfg))
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.mean(got != want) < 0.01


def test_lm_forward_matches_reference_f32(built, ref):
    cfg, model, rcfg, rparams = built("float32")
    toks = _tokens(cfg, 2, 64, seed=0)
    want = np.asarray(ref.transformer.lm_forward(
        rparams, ref.jnp.asarray(toks), rcfg, ref.ctx)[0], np.float32)
    got = transformer.lm_forward(model, torch.from_numpy(toks).long(),
                                 cfg).numpy()
    np.testing.assert_allclose(got, want, **F32)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_lm_forward_matches_reference_bf16(built, ref):
    cfg, model, rcfg, rparams = built("bfloat16")
    toks = _tokens(cfg, 2, 64, seed=0)
    want = np.asarray(ref.transformer.lm_forward(
        rparams, ref.jnp.asarray(toks), rcfg, ref.ctx)[0], np.float32)
    got = transformer.lm_forward(model, torch.from_numpy(toks).long(),
                                 cfg).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=FORWARD_BF16_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * FORWARD_BF16_ATOL
    assert clear.mean() > 0.3
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(built, ref, dtype):
    """Prefill of 20 tokens into a 48-slot cache, then 4 decode steps:
    the last logits and every cache leaf in the reference's layout
    (`stack_cache`: the layers' conv and state, the applications' k and
    v) after the prefill and after each step."""
    cfg, model, rcfg, rparams = built(dtype)
    toks = _tokens(cfg, 2, 24, seed=1)
    S0, S_max = 20, 48
    rprefill = ref.jax.jit(ref.registry.prefill_fn(rcfg, ref.ctx, S_max,
                                                   tp=1))
    rdecode = ref.jax.jit(ref.registry.decode_fn(rcfg, ref.ctx))
    rlog, rcache = rprefill(rparams, {"tokens": ref.jnp.asarray(toks[:, :S0])})
    plog, pcache = registry.prefill_fn(cfg, S_max)(
        model, torch.from_numpy(toks[:, :S0]).long())
    spec = registry.cache_spec(cfg, 2, S_max)
    assert {part: [{k: (tuple(v.shape), v.dtype) for k, v in c.items()}
                   for c in per] for part, per in pcache.items()} == spec
    for t in range(S0, 24 + 1):
        _close(plog, rlog, dtype)
        tree = transformer.stack_cache(pcache)
        assert {p: set(v) for p, v in tree.items()} == \
            {p: set(v) for p, v in rcache.items()} == \
            {"blocks": {"conv", "state"}, "shared_attn": {"k", "v"}}
        for part, leaves in tree.items():
            for name, leaf in leaves.items():
                _close(leaf, rcache[part][name], dtype)
        if t == 24:
            break
        rlog, rcache = rdecode(rparams, rcache,
                               ref.jnp.asarray(toks[:, t:t + 1]),
                               ref.jnp.int32(t))
        plog, pcache = registry.decode_fn(cfg)(
            model, pcache, torch.from_numpy(toks[:, t:t + 1]).long(), t)


def test_stacked_cache_is_the_reference_layout(built, ref):
    cfg, model, rcfg, _ = built("bfloat16")
    _, cache = registry.prefill_fn(cfg, 40)(
        model, torch.from_numpy(_tokens(cfg, 3, 10, seed=3)).long())
    tree = transformer.stack_cache(cache)
    want = ref.transformer.lm_cache_spec(rcfg, 3, 40, tp=1)
    assert set(tree) == set(want) == {"blocks", "shared_attn"}
    for part in tree:
        assert set(tree[part]) == set(want[part])
        for name, leaf in tree[part].items():
            assert tuple(leaf.shape) == tuple(want[part][name].shape)
            assert str(leaf.dtype).replace("torch.", "") == \
                str(want[part][name].dtype)
    assert tuple(tree["shared_attn"]["k"].shape) == (2, 3, 4, 40, 32)
    back = transformer.unstack_cache(tree)
    assert len(back["shared_attn"]) == 2 and len(back["blocks"]) == 4
    assert torch.equal(back["shared_attn"][1]["v"],
                       cache["shared_attn"][1]["v"])
    assert torch.equal(back["blocks"][3]["state"], cache["blocks"][3]["state"])


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.25)])
def test_decode_matches_own_full_forward(built, dtype, tol):
    """The port's prefill + decode steps give its own full forward's
    last logits: 24 tokens then 8 steps."""
    cfg, model, _, _ = built(dtype)
    toks = torch.from_numpy(_tokens(cfg, 2, 32, seed=2)).long()
    logits, cache = registry.prefill_fn(cfg, 64)(model, toks[:, :24])
    for t in range(24, 32):
        logits, cache = registry.decode_fn(cfg)(model, cache,
                                                toks[:, t:t + 1], t)
    full = transformer.lm_forward(model, toks, cfg)[:, -1]
    np.testing.assert_allclose(_f32(logits), _f32(full), atol=tol, rtol=tol)


def test_hybrid_entry_points_need_s_max_and_pos(built):
    cfg, model, _, _ = built("float32")
    toks = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="S_max"):
        registry.prefill_fn(cfg)(model, toks)
    with pytest.raises(ValueError, match="S_max"):
        registry.cache_spec(cfg, 1)
    _, cache = registry.prefill_fn(cfg, 8)(model, toks)
    with pytest.raises(ValueError, match="pos"):
        registry.decode_fn(cfg)(model, cache, toks[:, :1])


def test_the_hybrid_trains(built, ref):
    """The gate is gone: the hybrid's training entry points run.
    `registry.loss_fn` and `transformer.lm_loss` give the reference's
    loss on the module's tree, and its gradient reaches every parameter,
    the shared block's (`tests/test_torch_hybrid_train.py` holds the
    gradients to the reference's)."""
    cfg, model, rcfg, rparams = built("float32")
    toks = _tokens(cfg, 2, 17, seed=4)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    want, _ = ref.transformer.lm_loss(
        rparams, {k: ref.jnp.asarray(v) for k, v in batch.items()}, rcfg,
        ref.ctx)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tree = transformer.param_tree(model)
    with torch.no_grad():
        got, _ = registry.loss_fn(cfg)(tree, tb)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    leaves = compat.tree_map(
        lambda t: t.detach().clone().requires_grad_(), tree)
    loss, _ = transformer.lm_loss(leaves, tb, cfg, remat="none")
    assert float(loss.detach()) == float(got)
    loss.backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() and
               t.grad.abs().max() > 0
               for t in compat.tree_leaves(leaves["shared_attn"]))


@pytest.mark.parametrize("case", ["dense_tree_into_hybrid",
                                  "hybrid_tree_into_ssm",
                                  "hybrid_tree_into_dense"])
def test_load_reference_params_refuses_another_family(built, ref, case):
    """A tree of another family is refused: the top-level keys differ
    (the hybrid's `shared_attn`)."""
    dense_cfg = ref.reduced(ref.config("llama3-8b"))
    _, hybrid, _, hybrid_tree = built("float32")
    target, tree = {
        "dense_tree_into_hybrid": (
            hybrid, ref.registry.init_params(dense_cfg,
                                             ref.jax.random.key(1))),
        "hybrid_tree_into_ssm": (
            registry.build_model(reduced(get_config("mamba2-2.7b")),
                                 torch.Generator(), device="cpu"),
            hybrid_tree),
        "hybrid_tree_into_dense": (
            registry.build_model(reduced(get_config("llama3-8b")),
                                 torch.Generator(), device="cpu"),
            hybrid_tree)}[case]
    with pytest.raises(ValueError, match="reference tree has"):
        registry.load_reference_params(target, ref.jax.tree.map(np.asarray,
                                                                tree))


# ----------------------------------------------------------------------
# the engine and the CLI (tests/test_torch_dense.py's logging engines,
# batch 2, s_max 96)
# ----------------------------------------------------------------------
LENGTHS, MAX_NEW = (5, 23, 40), 8


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_serve_ids_equal_reference(built, ref, dtype):
    """Three requests of 8 new tokens over two groups of a batch-2
    engine, left-padded with token 0. f32: the served ids are the
    reference's. bf16: every step's logits agree within BF16_ATOL while
    a request's ids agree, and its ids agree to the end unless at some
    step the reference's own top-2 gap is no wider than twice the
    port's distance from it (a tie at bf16's resolution)."""
    cfg, model, rcfg, rparams = built(dtype)
    reng = _logging_reference(ref, rcfg, rparams)
    want = reng.serve(_requests(rcfg, LENGTHS, MAX_NEW, ref.engine.Request))
    eng = _LoggingEngine(cfg, model, ServeConfig(batch=2, s_max=96),
                         device="cpu")
    reqs = _requests(cfg, LENGTHS, MAX_NEW, Request)
    got = eng.serve(reqs)
    assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
    assert eng.pos == reng.pos == 40 + MAX_NEW
    assert len(eng.logged) == len(reng.logged) == 2 * (1 + MAX_NEW)
    if dtype == "float32":
        assert got == want
        return
    compared = 0
    for i in range(len(LENGTHS)):
        group, slot = divmod(i, 2)
        for t in range(MAX_NEW):
            step = group * (1 + MAX_NEW) + t
            lp, lr = eng.logged[step][slot], reng.logged[step][slot]
            eps = float(np.abs(lp - lr).max())
            assert eps <= BF16_ATOL, (i, t, eps)
            compared += 1
            if got[i][t] != want[i][t]:
                top2 = np.sort(lr)[-2:]
                assert top2[1] - top2[0] <= 2 * eps, (i, t, top2, eps)
                break
    assert compared >= MAX_NEW * len(LENGTHS) // 2


def test_serve_cli_runs_hybrid_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--requests", "3", "--batch", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"{ARCH} on cpu: 3 requests, 9 tokens" in out


# ----------------------------------------------------------------------
# kv_migrate of a hybrid cache on 4 pods (tests/test_torch_migrate.py's
# harness: the port on 4 gloo ranks, the reference in one subprocess
# under jit(shard_map) on 4 host devices, pod r's input x * (r + 1))
# ----------------------------------------------------------------------
def _hybrid_cache_inputs():
    """A hybrid decode cache's leaves in the reference's layout (B=2,
    S_max=24), as flat {path: f32 array} and {path: dtype}."""
    cfg = reduced(get_config(ARCH))
    spec = registry.cache_spec(cfg, 2, 24)
    rng = np.random.default_rng(7)
    flat, dtypes = {}, {}
    for part, per in spec.items():
        for name, (shape, dt) in per[0].items():
            a = rng.normal(size=(len(per),) + shape).astype(np.float32)
            path = f"{part}/{name}"
            if dt == torch.bfloat16:
                a = mig._bf16_values(a)
                dtypes[path] = "bfloat16"
            flat[path] = a
    return flat, dtypes


def _migrate_hybrid_pod(rank, n_pods, flat, dtypes):
    torch.set_num_threads(1)
    local = mig._nest(mig._local(flat, dtypes, rank))
    layered = {part: [{k: v[i].clone() for k, v in leaves.items()}
                      for i in range(len(next(iter(leaves.values()))))]
               for part, leaves in local.items()}
    moved = kv_migrate(layered, mig.make_plan(mig.PLANS["fixed"]), 0)
    assert isinstance(moved["shared_attn"], list)
    return mig._numpy(mig._flatten(transformer.stack_cache(moved)))


@pytest.fixture(scope="module")
def hybrid_migration(tmp_path_factory):
    """(port's leaves per rank, reference's leaves per rank, inputs)."""
    flat, dtypes = _hybrid_cache_inputs()
    port = compat.run_pods(_migrate_hybrid_pod, mig.N_PODS, flat, dtypes,
                           timeout=mig.DEADLINE)
    tmp = tmp_path_factory.mktemp("migrate_hybrid_ref")
    spec = {"cases": {"hybrid": ("hybrid", "fixed", 0, True)},
            "plans": mig.PLANS, "dtypes": dtypes,
            "paths": {"hybrid": list(flat)}}
    (tmp / "spec.json").write_text(json.dumps(spec))
    np.savez(tmp / "in.npz", **{f"hybrid:{p}": a for p, a in flat.items()})
    env = dict(os.environ, PYTHONPATH=mig.SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", mig._REFERENCE, str(tmp / "spec.json"),
         str(tmp / "in.npz"), str(tmp / "out.npz")], capture_output=True,
        text=True, env=env, timeout=mig.DEADLINE)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    with np.load(tmp / "out.npz") as z:
        want = {k.split(":", 1)[1]: z[k] for k in z.files}
    return port, want, flat


@pytest.mark.parametrize("rank", range(mig.N_PODS))
def test_kv_migrate_of_a_hybrid_cache_matches_reference(hybrid_migration,
                                                         rank):
    """Every leaf (the layers' conv and state, the shared block's k and
    v per application) on every pod bit-equal to the reference's; the
    source keeps its own cache, the others receive a compressed copy."""
    port, want, flat = hybrid_migration
    assert set(port[rank]) == set(flat) == {
        "blocks/conv", "blocks/state", "shared_attn/k", "shared_attn/v"}
    for path in flat:
        assert port[rank][path].shape == want[path][rank].shape, path
        np.testing.assert_array_equal(port[rank][path], want[path][rank],
                                      err_msg=path)
    if rank:
        assert not np.array_equal(port[rank]["shared_attn/k"],
                                  port[0]["shared_attn/k"])


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ssd_chunk, SiLU and flash "
                    "kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_serves_as_the_host(card):
    """The reduced hybrid in f32 on the card (the kernels) and on the
    host with the same weights: the prefill's and 8 decode steps'
    logits within 1e-3, the ids equal; per step one `silu` and one
    `silu_gate` a layer, one `silu_gate` an application (the shared
    MLP), and one `ssd_chunk` a layer and one `flash_fwd` an
    application a prefill."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(ARCH)).replace(dtype="float32")
    card_model = registry.build_model(cfg, torch.Generator(card).manual_seed(0),
                                      card)
    host_model = transformer.HybridLM(cfg, torch.device("cpu"),
                                      torch.float32)
    host_model.load_state_dict(card_model.state_dict())
    sc = ServeConfig(batch=2, s_max=64)
    engines = [Engine(cfg, card_model, sc), Engine(cfg, host_model, sc,
                                                   device="cpu")]
    names = ("ssd_chunk", "silu", "silu_gate", "flash_fwd")
    before = {n: getattr(ops, n).launches for n in names}
    outs, logits = [], []
    for eng in engines:
        reqs = _requests(cfg, LENGTHS[:2], MAX_NEW, Request)
        outs.append(eng.serve(reqs))
        logits.append(eng.last_logits.float().cpu().numpy())
    torch.cuda.synchronize()
    apps, steps = sum(transformer.shared_flags(cfg)), 1 + MAX_NEW
    assert {n: getattr(ops, n).launches - before[n] for n in names} == {
        "ssd_chunk": cfg.n_layers, "flash_fwd": apps,
        "silu": steps * cfg.n_layers,
        "silu_gate": steps * (cfg.n_layers + apps)}
    np.testing.assert_allclose(logits[0], logits[1], atol=1e-3, rtol=1e-3)
    assert outs[0] == outs[1]
