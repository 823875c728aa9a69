"""The port's dense attention family against the JAX reference, on
`reduced(get_config(arch))` for `llama3-8b` (GQA), `qwen3-4b` (GQA +
qk-norm) and `h2o-danube-1.8b` (GQA + a sliding window of 32 at reduced
size): 2 layers, d_model 128, 4 query heads of 32 over 2 KV heads, d_ff
256, vocab 512, with the reference's parameters carried across by
`load_reference_params`. Inputs are made with numpy from a seed.

Tolerances:
- f32 (`dtype="float32"`): the layers and the model within atol/rtol
  1e-5 and 1e-4 (~6e-6 measured); the frameworks differ only in the
  order of their f32 sums and in the last ulp of exp / cos / sin /
  pow, so the served ids are equal.
- bf16 (the configs' own dtype): the port rounds where the reference's
  compiled CPU program rounds (each op of the SiLU, the gate's product
  once, q scaled by the bf16-rounded scale, the probabilities rounded
  before PV), so given equal inputs the SiLU gate is bit-equal. A
  matrix product's sum order or an exp / cos ulp can still flip a bf16
  rounding here and there, so a layer is held within one bf16 step of
  its output's magnitude (rtol 2^-7) and the logits within atol 0.0625
  (one bf16 step at their magnitude, 8 to 16). Greedy ids are held
  equal wherever the reference's top-2 gap exceeds twice that, and the
  served ids are equal.
- the card against the host (`cuda` cases, f32): within 1e-3, as
  `chip_smoke.py`'s parity phase holds them.

Card-only cases (marked `cuda`) run where jax is not installed:
``python -m pytest -q -m cuda tests/test_torch_dense.py``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as att
from repro_torch.models import layers, registry, transformer
from repro_torch.serve.engine import Engine, Request, ServeConfig

ARCHS = ["llama3-8b", "qwen3-4b", "h2o-danube-1.8b"]
DTYPES = ["float32", "bfloat16"]
F32 = dict(atol=1e-5, rtol=1e-5)
MODEL_F32 = dict(atol=1e-4, rtol=1e-4)
BF16_STEP = 2.0 ** -7          # one bf16 step, relative
BF16_ATOL = 0.0625
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: its configs, models, layers and engine."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models import attention as ref_att
    from repro.models import layers as ref_layers
    from repro.models import registry as ref_registry
    from repro.models import transformer as ref_transformer
    from repro.models.layers import ShardCtx
    from repro.serve import engine as ref_engine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, config=ref_config, reduced=ref_reduced,
        att=ref_att, layers=ref_layers, registry=ref_registry,
        transformer=ref_transformer, ctx=ShardCtx(remat="none"),
        engine=ref_engine)


@pytest.fixture(scope="module")
def built(ref):
    """(arch, dtype) -> (port cfg, port model, ref cfg, ref params),
    built once per module."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            cfg = reduced(get_config(arch)).replace(dtype=dtype)
            rcfg = ref.reduced(ref.config(arch)).replace(dtype=dtype)
            rparams = ref.registry.init_params(rcfg, ref.jax.random.key(0))
            model = registry.build_model(cfg, torch.Generator().manual_seed(0),
                                         device="cpu")
            registry.load_reference_params(
                model, ref.jax.tree.map(np.asarray, rparams))
            cache[arch, dtype] = (cfg, model, rcfg, rparams)
        return cache[arch, dtype]
    return get


def _np(rng, shape, dtype, scale=1.0):
    """A seeded normal array, rounded to `dtype` (values both sides hold
    exactly), as f32 numpy."""
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(TDT[dtype]).float().numpy()


def _pair(ref, a, dtype):
    """The same values as a port tensor and a reference array."""
    return (torch.from_numpy(a).to(TDT[dtype]),
            ref.jnp.asarray(a).astype(ref.jnp.dtype(dtype)))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


def _close(got, want, dtype, f32=F32, bf16_atol=None):
    """f32: allclose; bf16: within `bf16_atol`, by default one bf16 step
    of the magnitude."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    if dtype == "float32":
        np.testing.assert_allclose(g, w, **f32)
    else:
        atol = BF16_STEP * np.abs(w).max() if bf16_atol is None \
            else bf16_atol
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def _block(ref, rparams, cfg, i=0):
    """Layer i's reference block in the compute dtype."""
    return ref.jax.tree.map(lambda a: a[i], ref.transformer._cast_params(
        rparams, ref.jnp.dtype(cfg.dtype))["blocks"])


# ----------------------------------------------------------------------
# configs and parameters
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(ref, arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(ref.config(arch))
    assert dataclasses.asdict(reduced(get_config(arch))) == \
        dataclasses.asdict(ref.reduced(ref.config(arch)))


def test_full_configs_are_the_published_widths():
    llama = get_config("llama3-8b")
    assert (llama.n_layers, llama.d_model, llama.n_heads, llama.n_kv_heads,
            llama.d_ff, llama.vocab) == (32, 4096, 32, 8, 14336, 128256)
    qwen = get_config("qwen3-4b")
    assert qwen.qk_norm and qwen.resolved_head_dim == 128
    assert get_config("h2o-danube-1.8b").sliding_window == 4096
    assert reduced(get_config("h2o-danube-1.8b")).sliding_window == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across(built, ref, arch):
    cfg, model, rcfg, rparams = built(arch, "float32")
    assert isinstance(model, transformer.DenseLM)
    n_ref = sum(np.size(a) for a in ref.jax.tree.leaves(rparams))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    np.testing.assert_array_equal(
        model.blocks[1].attn.wk.numpy(),
        np.asarray(rparams["blocks"]["attn"]["wk"][1]))
    np.testing.assert_array_equal(
        model.blocks[0].mlp.w2.numpy(),
        np.asarray(rparams["blocks"]["mlp"]["w2"][0]))
    assert hasattr(model.blocks[0].attn, "q_scale") == cfg.qk_norm


def test_compute_params_cast_stacked_vectors(built):
    """ln1 / ln2 / q_scale / k_scale are [L, ·] in the reference, so its
    `_cast_params` casts them; final_norm [d] stays in f32."""
    cfg, model, _, _ = built("qwen3-4b", "bfloat16")
    pc = model.compute_params(torch.bfloat16)
    blk = pc["blocks"][0]
    assert set(blk) == {"ln1", "ln2", "attn", "mlp"}
    assert set(blk["attn"]) == {"wq", "wk", "wv", "wo", "q_scale", "k_scale"}
    for t in (blk["ln1"], blk["ln2"], blk["attn"]["q_scale"],
              blk["mlp"]["w1"], pc["embed"], pc["lm_head"]):
        assert t.dtype == torch.bfloat16
    assert pc["final_norm"].dtype == torch.float32


def test_load_reference_params_refuses_another_family(built, ref):
    _, _, _, rparams = built("llama3-8b", "float32")
    mamba = registry.build_model(reduced(get_config("mamba2-2.7b")),
                                 torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="reference blocks hold"):
        registry.load_reference_params(mamba, ref.jax.tree.map(np.asarray,
                                                                rparams))


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope_matches_reference(ref, dtype):
    rng = np.random.default_rng(1)
    x, jx = _pair(ref, _np(rng, (2, 4, 40, 32), dtype), dtype)
    pos = np.arange(40) + 977                   # far positions too
    want = ref.jax.jit(lambda a: ref.layers.apply_rope(
        a, ref.jnp.asarray(pos)[None, None, :], 500000.0))(jx)
    got = layers.apply_rope(x, torch.from_numpy(pos), 500000.0)
    assert got.dtype == x.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_head_rms_norm_matches_reference(ref, dtype):
    rng = np.random.default_rng(2)
    x, jx = _pair(ref, _np(rng, (2, 4, 9, 32), dtype, 3.0), dtype)
    s, js = _pair(ref, _np(rng, (32,), dtype), dtype)
    want = ref.jax.jit(ref.layers.head_rms_norm)(jx, js)
    got = layers.head_rms_norm(x, s)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_silu_gate_of_swiglu_matches_reference(ref, dtype):
    """Given the same two products, the port's gate (`ops.silu_gate`'s
    value) is the reference's `jax.nn.silu(a) * b` bit for bit in bf16
    (each op rounded there); in f32 within the last ulps of XLA's and
    torch's exp (rtol 1e-6)."""
    rng = np.random.default_rng(3)
    a, ja = _pair(ref, _np(rng, (2, 17, 256), dtype, 4.0), dtype)
    b, jb = _pair(ref, _np(rng, (2, 17, 256), dtype, 2.0), dtype)
    want = ref.jax.jit(lambda a, b: ref.jax.nn.silu(a) * b)(ja, jb)
    got, _ = ops.silu_gate(b, a)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_matches_reference(ref, dtype):
    rng = np.random.default_rng(4)
    x, jx = _pair(ref, _np(rng, (2, 17, 128), dtype), dtype)
    ws = [_pair(ref, _np(rng, s, dtype, s[0] ** -0.5), dtype)
          for s in ((128, 256), (128, 256), (256, 128))]
    want = ref.jax.jit(lambda x, a, b, c: ref.layers.swiglu(
        x, a, b, c, ref.ctx))(jx, *(j for _, j in ws))
    before = ops.silu_gate.launches
    got = layers.swiglu(x, *(t for t, _ in ws))
    assert ops.silu_gate.launches == before          # the CPU's plain path
    _close(got, want, dtype)


# (B, K, G, S, window, block_k)
FLASH_CASES = {
    "causal": (2, 2, 1, 40, 0, 512),
    "windowed": (2, 2, 1, 64, 9, 16),
    "sk_not_block_multiple": (1, 2, 1, 40, 0, 16),
    "several_blocks": (2, 1, 1, 64, 0, 16),
    "g_above_one": (2, 2, 3, 24, 0, 512),
    "several_blocks_g_above_one": (1, 2, 2, 40, 0, 16),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_reference(ref, case, dtype):
    """A windowed causal row is masked through whole key blocks: NEG_INF
    (not -inf) keeps it finite there, as in the reference."""
    B, K, G, S, window, bk = FLASH_CASES[case]
    rng = np.random.default_rng(5)
    q, jq = _pair(ref, _np(rng, (B, K, G, S, 32), dtype), dtype)
    k, jk = _pair(ref, _np(rng, (B, K, S, 32), dtype), dtype)
    v, jv = _pair(ref, _np(rng, (B, K, S, 32), dtype), dtype)
    kw = dict(window=window, block_k=bk)
    want = ref.jax.jit(lambda q, k, v: ref.att.flash_attention(
        q, k, v, causal=True, **kw))(jq, jk, jv)
    got = att.flash_attention(q, k, v, **kw)
    assert got.dtype == v.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [24, 32, 96])
def test_swa_attention_matches_reference(ref, S, dtype):
    """S <= W takes the windowed flash path, S = k * W the banded one."""
    rng = np.random.default_rng(6)
    q, jq = _pair(ref, _np(rng, (2, 2, 2, S, 32), dtype), dtype)
    k, jk = _pair(ref, _np(rng, (2, 2, S, 32), dtype), dtype)
    v, jv = _pair(ref, _np(rng, (2, 2, S, 32), dtype), dtype)
    want = ref.jax.jit(lambda q, k, v: ref.att.swa_attention(
        q, k, v, window=32))(jq, jk, jv)
    got = att.swa_attention(q, k, v, window=32)
    _close(got, want, dtype)


def test_swa_attention_refuses_a_ragged_length():
    q = torch.zeros((1, 1, 1, 40, 8))
    k = torch.zeros((1, 1, 40, 8))
    with pytest.raises(ValueError, match="not divisible"):
        att.swa_attention(q, k, k, window=32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_forward_matches_reference(built, ref, arch, dtype):
    cfg, model, rcfg, rparams = built(arch, dtype)
    rng = np.random.default_rng(7)
    S = 64                          # danube: two windows, the banded path
    x, jx = _pair(ref, _np(rng, (2, S, 128), dtype), dtype)
    blk = _block(ref, rparams, rcfg)
    want = ref.jax.jit(lambda p, x: ref.att.gqa_forward(
        p, x, ref.ctx, rcfg, ref.jnp.arange(S)))(blk["attn"], jx)
    pblk = model.compute_params(TDT[dtype])["blocks"][0]
    got = att.gqa_forward(pblk["attn"], x, cfg, torch.arange(S))
    _close(got, want, dtype)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_takes_ln2_variance_of_the_unrounded_sum(built, ref, arch,
                                                       layer):
    """The bf16 block against the reference's `_attn_mlp_block` under
    one jit: XLA's program takes ln2's variance of the f32 sum x + attn
    before rounding it, and so does the port. Taken of the rounded sum,
    2-4% of the outputs differ; mirrored, under 1% (the products' sum
    order and exp's last ulp)."""
    cfg, model, rcfg, rparams = built(arch, "bfloat16")
    rng = np.random.default_rng(11 + layer)
    S = 32
    x, jx = _pair(ref, _np(rng, (2, S, 128), "bfloat16"), "bfloat16")
    blk = _block(ref, rparams, rcfg, layer)
    want = ref.jax.jit(lambda p, x: ref.transformer._attn_mlp_block(
        p, x, ref.jnp.arange(S), rcfg, ref.ctx, 1)[0])(blk, jx)
    pblk = model.compute_params(torch.bfloat16)["blocks"][layer]
    with torch.no_grad():
        got = transformer.DenseBlock.run(pblk, x, torch.arange(S), cfg)
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    assert np.mean(g != w) < 0.01


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_make_cache_matches_reference(built, ref, arch):
    cfg, model, rcfg, rparams = built(arch, "float32")
    rng = np.random.default_rng(8)
    x, jx = _pair(ref, _np(rng, (2, 21, 128), "float32"), "float32")
    blk = _block(ref, rparams, rcfg)
    pos = np.arange(21) + 5
    want = ref.att.gqa_make_cache(blk["attn"], jx, rcfg, ref.ctx,
                                  ref.jnp.asarray(pos), 48,
                                  ref.transformer.kv_eff_heads(rcfg, tp=1))
    got = att.gqa_make_cache(model.compute_params(torch.float32)["blocks"][0]
                             ["attn"], x, cfg, torch.from_numpy(pos), 48)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 2, 48, 32)
        _close(g, w, "float32")
        assert not _f32(g)[:, :, 21:].any()             # the zero pad


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_decode_matches_reference(built, ref, arch, dtype):
    """Decode steps over a 32-slot cache from position 28 to 39: danube's
    ring buffer wraps at 32 (then every slot is valid), the others'
    slot stops at S - 1, as the reference's `min(pos, S - 1)`."""
    cfg, model, rcfg, rparams = built(arch, dtype)
    rng = np.random.default_rng(9)
    blk = _block(ref, rparams, rcfg)
    pblk = model.compute_params(TDT[dtype])["blocks"][0]["attn"]
    ck, jck = _pair(ref, _np(rng, (2, 2, 32, 32), dtype), dtype)
    cv, jcv = _pair(ref, _np(rng, (2, 2, 32, 32), dtype), dtype)
    step = ref.jax.jit(lambda p, ck, cv, x, pos: ref.att.gqa_decode(
        p, ck, cv, x, pos, rcfg, ref.ctx, window=rcfg.sliding_window))
    for pos in range(28, 40):
        x, jx = _pair(ref, _np(rng, (2, 1, 128), dtype), dtype)
        want, jck, jcv = step(blk["attn"], jck, jcv, jx, ref.jnp.int32(pos))
        got, ck, cv = att.gqa_decode(pblk, ck, cv, x, pos, cfg)
        _close(got, want, dtype)
        _close(ck, jck, dtype)
        _close(cv, jcv, dtype)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_reference_f32(built, ref, arch):
    cfg, model, rcfg, rparams = built(arch, "float32")
    toks = _tokens(cfg, 2, 64, seed=0)
    want = np.asarray(ref.transformer.lm_forward(
        rparams, ref.jnp.asarray(toks), rcfg, ref.ctx)[0], np.float32)
    got = transformer.lm_forward(model, torch.from_numpy(toks).long(),
                                 cfg).numpy()
    np.testing.assert_allclose(got, want, **MODEL_F32)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_reference_bf16(built, ref, arch):
    cfg, model, rcfg, rparams = built(arch, "bfloat16")
    toks = _tokens(cfg, 2, 64, seed=0)
    want = np.asarray(ref.transformer.lm_forward(
        rparams, ref.jnp.asarray(toks), rcfg, ref.ctx)[0], np.float32)
    got = transformer.lm_forward(model, torch.from_numpy(toks).long(),
                                 cfg).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * BF16_ATOL
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def _stacked(cache, name):
    return torch.stack([c[name] for c in cache["blocks"]])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(built, ref, arch, dtype):
    """Prefill of 20 tokens into a 48-slot cache (danube's: its 32-slot
    window), then 16 decode steps (danube past the ring's wrap at 32):
    the last logits and every layer's k / v each step, within the
    model's bars (a layer's k / v in bf16 carry the rounding of the
    layers before it, like the logits)."""
    cfg, model, rcfg, rparams = built(arch, dtype)
    toks = _tokens(cfg, 2, 36, seed=1)
    S0, S_max = 20, 48
    rprefill = ref.jax.jit(ref.registry.prefill_fn(rcfg, ref.ctx, S_max,
                                                   tp=1))
    rdecode = ref.jax.jit(ref.registry.decode_fn(rcfg, ref.ctx))
    rlog, rcache = rprefill(rparams, {"tokens": ref.jnp.asarray(toks[:, :S0])})
    plog, pcache = registry.prefill_fn(cfg, S_max)(
        model, torch.from_numpy(toks[:, :S0]).long())
    spec = registry.cache_spec(cfg, 2, S_max)
    assert [{k: (tuple(v.shape), v.dtype) for k, v in c.items()}
            for c in pcache["blocks"]] == spec["blocks"]
    atol = MODEL_F32 if dtype == "float32" else dict(atol=BF16_ATOL, rtol=0)
    for t in range(S0, 36):
        np.testing.assert_allclose(_f32(plog), _f32(rlog), **atol)
        for name in ("k", "v"):
            _close(_stacked(pcache, name), rcache["blocks"][name], dtype,
                   MODEL_F32, BF16_ATOL)
        rlog, rcache = rdecode(rparams, rcache,
                               ref.jnp.asarray(toks[:, t:t + 1]),
                               ref.jnp.int32(t))
        plog, pcache = registry.decode_fn(cfg)(
            model, pcache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
    np.testing.assert_allclose(_f32(plog), _f32(rlog), **atol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swa_prefill_past_the_window_matches_reference(built, ref, dtype):
    """danube's prefill of 64 tokens, past its window of 32: the cache
    keeps the last 32 positions of the k / v the attention used (one
    projection a layer), as the reference's cache of those positions."""
    cfg, model, rcfg, rparams = built("h2o-danube-1.8b", dtype)
    toks = _tokens(cfg, 2, 64, seed=4)
    rlog, rcache = ref.jax.jit(ref.registry.prefill_fn(
        rcfg, ref.ctx, 96, tp=1))(rparams, {"tokens": ref.jnp.asarray(toks)})
    plog, pcache = registry.prefill_fn(cfg, 96)(
        model, torch.from_numpy(toks).long())
    atol = MODEL_F32 if dtype == "float32" else dict(atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(_f32(plog), _f32(rlog), **atol)
    for name in ("k", "v"):
        assert _stacked(pcache, name).shape[3] == 32
        _close(_stacked(pcache, name), rcache["blocks"][name], dtype,
               MODEL_F32, BF16_ATOL)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.25)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_full_forward(built, arch, dtype, tol):
    """The port's prefill + decode steps give its own full forward's
    last logits (as tests/test_serve.py holds the reference): 24 tokens
    then 8 steps, within danube's window of 32; in bf16 the two paths
    round the attention differently (decode keeps o in f32 through
    `@ wo`)."""
    cfg, model, _, _ = built(arch, dtype)
    toks = torch.from_numpy(_tokens(cfg, 2, 32, seed=2)).long()
    logits, cache = registry.prefill_fn(cfg, 64)(model, toks[:, :24])
    for t in range(24, 32):
        logits, cache = registry.decode_fn(cfg)(model, cache,
                                                toks[:, t:t + 1], t)
    full = transformer.lm_forward(model, toks, cfg)[:, -1]
    np.testing.assert_allclose(_f32(logits), _f32(full), atol=tol, rtol=tol)


def test_stacked_cache_is_the_reference_layout(built, ref):
    cfg, model, rcfg, _ = built("h2o-danube-1.8b", "bfloat16")
    _, cache = registry.prefill_fn(cfg, 128)(
        model, torch.from_numpy(_tokens(cfg, 3, 10, seed=3)).long())
    tree = transformer.stack_cache(cache)
    want = ref.transformer.lm_cache_spec(rcfg, 3, 128, tp=1)
    assert set(tree) == {"blocks"} and set(tree["blocks"]) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(tree["blocks"][name].shape) == \
            tuple(want["blocks"][name].shape) == (2, 3, 2, 32, 32)
        assert tree["blocks"][name].dtype == torch.bfloat16
    back = transformer.unstack_cache(tree)
    assert torch.equal(back["blocks"][1]["v"], cache["blocks"][1]["v"])


def test_dense_entry_points_need_s_max_and_pos(built):
    cfg, model, _, _ = built("llama3-8b", "float32")
    toks = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="S_max"):
        registry.prefill_fn(cfg)(model, toks)
    with pytest.raises(ValueError, match="S_max"):
        registry.cache_spec(cfg, 1)
    _, cache = registry.prefill_fn(cfg, 8)(model, toks)
    with pytest.raises(ValueError, match="pos"):
        registry.decode_fn(cfg)(model, cache, toks[:, :1])


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
def _requests(cfg, lengths, max_new, request_cls):
    rng = np.random.default_rng(5)
    return [request_cls(rid=i,
                        prompt=rng.integers(1, cfg.vocab,
                                            n).astype(np.int32),
                        max_new=max_new)
            for i, n in enumerate(lengths)]


# groups of a batch-2 engine: (5, 23) left-padded to 23, then (64,);
# danube's window (32) takes the first group's through the windowed
# flash path and past the ring's wrap at 32, the second's through the
# banded path
LENGTHS, MAX_NEW = (5, 23, 64), 12


class _LoggingEngine(Engine):
    """The port's Engine, keeping each step's logits."""

    def _ids(self, logits, t0, key):
        self.logged = getattr(self, "logged", []) + [
            logits.float().numpy().copy()]
        return super()._ids(logits, t0, key)


def _logging_reference(ref, rcfg, rparams):
    """The reference's Engine with its jitted steps wrapped to keep
    each step's logits."""
    eng = ref.engine.Engine(rcfg, rparams,
                            ref.engine.ServeConfig(batch=2, s_max=96))
    eng.logged = []

    def keep(fn):
        def step(*args):
            logits, cache = fn(*args)
            eng.logged.append(np.asarray(logits, np.float32))
            return logits, cache
        return step
    eng._prefill, eng._decode = keep(eng._prefill), keep(eng._decode)
    return eng


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serve_ids_equal_reference(built, ref, arch, dtype):
    """Three requests of 12 new tokens over two groups of a batch-2
    engine. f32: the served ids are the reference's. bf16: the logits
    of every step agree within BF16_ATOL while a request's ids agree,
    and its ids agree to the end, unless at some step the reference's
    own top-2 gap is no wider than twice the port's distance from it (a
    tie at bf16's resolution, ~1 in 10 steps at these logits' 0.0156
    spacing); from there on the two greedy continuations are of
    different prompts and are not compared."""
    cfg, model, rcfg, rparams = built(arch, dtype)
    reng = _logging_reference(ref, rcfg, rparams)
    want = reng.serve(_requests(rcfg, LENGTHS, MAX_NEW, ref.engine.Request))
    eng = _LoggingEngine(cfg, model, ServeConfig(batch=2, s_max=96),
                         device="cpu")
    reqs = _requests(cfg, LENGTHS, MAX_NEW, Request)
    got = eng.serve(reqs)
    assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
    assert eng.pos == reng.pos == 64 + MAX_NEW
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


def test_serve_cli_runs_dense_on_cpu(capsys):
    serve_cli.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                    "--requests", "3", "--batch", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "llama3-8b on cpu: 3 requests, 9 tokens" in out


def test_dense_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("qwen3-4b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.build_model(cfg, torch.Generator())
    model = registry.build_model(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, model, ServeConfig(batch=1))


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SiLU gate kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_serves_as_the_host(card, arch):
    """The reduced model in f32 on the card (the `silu_gate` kernel, one
    launch a layer a step) and on the host with the same weights: the
    prefill's and 12 decode steps' logits within 1e-3, the ids equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    card_model = registry.build_model(cfg, torch.Generator(card).manual_seed(0),
                                      card)
    host_model = transformer.DenseLM(cfg, torch.device("cpu"), torch.float32)
    host_model.load_state_dict(card_model.state_dict())
    sc = ServeConfig(batch=2, s_max=96)
    engines = [Engine(cfg, card_model, sc), Engine(cfg, host_model, sc,
                                                   device="cpu")]
    before = ops.silu_gate.launches
    outs, logits = [], []
    for eng in engines:
        reqs = _requests(cfg, LENGTHS[:2], MAX_NEW, Request)
        outs.append(eng.serve(reqs))
        logits.append(eng.last_logits.float().cpu().numpy())
    torch.cuda.synchronize()
    assert ops.silu_gate.launches - before == \
        (1 + MAX_NEW) * cfg.n_layers
    np.testing.assert_allclose(logits[0], logits[1], atol=1e-3, rtol=1e-3)
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_card_softmax_divides(card):
    """On the card `attention._softmax` is ATen's softmax, one kernel;
    it divides exp(s - max) by the sum as the host's spelled-out form
    does (not a product with the reciprocal). On rows of two scores the
    sum is one rounding in either order, so the two agree bit for bit,
    a masked score included."""
    rng = np.random.default_rng(0)
    s = torch.from_numpy(4 * rng.standard_normal((8192, 2)).astype(
        np.float32)).to(card)
    s[::7, 1] = att.NEG_INF
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    assert torch.equal(att._softmax(s), e / e.sum(dim=-1, keepdim=True))
