"""The port's MLA (multi-head latent attention, `minicpm3-4b`) against
the JAX reference, on two configs cut from it: `reduced(get_config(
"minicpm3-4b"))` (2 layers, d_model 128, 4 heads, kv_lora 32, no q-LoRA,
Dq = 16 + 8 = 24, Dv = 16) and "qlora", the same with q_lora_rank 48 and
nope 32, rope 16, v 32 (Dq 48, Dv 32: multiples of 16, as the card's
kernel takes them, and the q-LoRA branch the reduced config never
runs). The reference's parameters are carried across by
`load_reference_params`; inputs are made with numpy from a seed.

Tolerances (as tests/test_torch_dense.py's):
- f32: the functions within atol/rtol 1e-5, the model within 1e-4; the
  served ids are equal.
- bf16 (the config's own dtype): the port rounds where the reference's
  compiled CPU program rounds (its bf16 HLO: k_nope from c_kv's
  unrounded last product, the decode scores' bf16 einsum kept in f32),
  so a function is held within one bf16 step of its output's magnitude
  and the logits within 0.0625; greedy ids equal wherever the
  reference's top-2 gap exceeds twice the port's distance from it.

The flash kernel's MLA form (q and v bf16, k f32, Dq != Dv) is held on
the CPU through its plain version against the reference's
`flash_attention`, and MLA's parts (`ops.flash_fwd_mla`) through theirs,
the reference's concatenations bit for bit; the `cuda` cases hold the
parts' kernel to its plain version on the card at the served shape
(``python -m pytest -q -m cuda tests/test_torch_mla.py``; they import no
jax).
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.configs import PORTED, get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels import flash as _flash
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_fwd_mla_ref, flash_fwd_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as att
from repro_torch.models import registry, transformer
from repro_torch.serve.engine import Engine, Request, ServeConfig, kv_migrate

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_migrate as mig  # noqa: E402

ARCH = "minicpm3-4b"
FULL_PARAMS = 4_261_902_848
CFGS = ["reduced", "qlora"]
DTYPES = ["float32", "bfloat16"]
F32 = dict(atol=1e-5, rtol=1e-5)
MODEL_F32 = dict(atol=1e-4, rtol=1e-4)
BF16_STEP = 2.0 ** -7
BF16_ATOL = 0.0625
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QLORA = dict(q_lora_rank=48, qk_nope_head_dim=32, qk_rope_head_dim=16,
             v_head_dim=32)


def _cut(name):
    """The port's config `name` ("reduced" or "qlora")."""
    cfg = reduced(get_config(ARCH))
    if name == "qlora":
        cfg = cfg.replace(mla=dataclasses.replace(cfg.mla, **QLORA))
    return cfg


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: its configs, models, layers and engine."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models import attention as ref_att
    from repro.models import registry as ref_registry
    from repro.models import transformer as ref_transformer
    from repro.models.layers import ShardCtx
    from repro.serve import engine as ref_engine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, config=ref_config, reduced=ref_reduced,
        att=ref_att, registry=ref_registry, transformer=ref_transformer,
        ctx=ShardCtx(remat="none"), engine=ref_engine)


def _configs(ref, name, dtype):
    cfg = _cut(name).replace(dtype=dtype)
    rcfg = ref.reduced(ref.config(ARCH)).replace(dtype=dtype)
    if name == "qlora":
        rcfg = rcfg.replace(mla=dataclasses.replace(rcfg.mla, **QLORA))
    return cfg, rcfg


@pytest.fixture(scope="module")
def built(ref):
    """(config, dtype) -> (port cfg, port model, ref cfg, ref params),
    built once per module."""
    cache = {}

    def get(name, dtype):
        if (name, dtype) not in cache:
            cfg, rcfg = _configs(ref, name, dtype)
            rparams = ref.registry.init_params(rcfg, ref.jax.random.key(0))
            model = registry.build_model(cfg, torch.Generator().manual_seed(0),
                                         device="cpu")
            registry.load_reference_params(
                model, ref.jax.tree.map(np.asarray, rparams))
            cache[name, dtype] = (cfg, model, rcfg, rparams)
        return cache[name, dtype]
    return get


def _np(rng, shape, dtype, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(TDT[dtype]).float().numpy()


def _pair(ref, a, dtype):
    return (torch.from_numpy(a).to(TDT[dtype]),
            ref.jnp.asarray(a).astype(ref.jnp.dtype(dtype)))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


def _close(got, want, dtype, f32=F32, bf16_atol=None):
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    if dtype == "float32":
        np.testing.assert_allclose(g, w, **f32)
    else:
        atol = BF16_STEP * np.abs(w).max() if bf16_atol is None \
            else bf16_atol
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def _blocks(ref, model, rparams, cfg, i=0):
    """Layer i's attention parameters: the reference's in the compute
    dtype, and the port's compute tree."""
    rblk = ref.jax.tree.map(lambda a: a[i], ref.transformer._cast_params(
        rparams, ref.jnp.dtype(cfg.dtype))["blocks"])
    return (rblk["attn"],
            model.compute_params(TDT[cfg.dtype])["blocks"][i]["attn"])


# ----------------------------------------------------------------------
# configs and parameters
# ----------------------------------------------------------------------
def test_config_equals_reference(ref):
    assert ARCH in PORTED
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(ref.config(ARCH))
    assert dataclasses.asdict(reduced(get_config(ARCH))) == \
        dataclasses.asdict(ref.reduced(ref.config(ARCH)))


def test_full_config_and_param_count():
    cfg = get_config(ARCH)
    m = cfg.mla
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab) \
        == (62, 2560, 40, 6400, 73448)
    assert (m.kv_lora_rank, m.q_lora_rank, m.qk_nope_head_dim,
            m.qk_rope_head_dim, m.v_head_dim) == (256, 768, 64, 32, 64)
    assert registry.param_count(cfg) == FULL_PARAMS
    assert registry.active_param_count(cfg) == FULL_PARAMS


@pytest.mark.parametrize("name", CFGS)
def test_params_carry_across(built, ref, name):
    """Every MLA leaf of the reference's tree lands in its module
    parameter, through `load_reference_params`' generic name check."""
    cfg, model, _, rparams = built(name, "float32")
    assert isinstance(model, transformer.DenseLM)
    assert isinstance(model.blocks[0].attn, att.MlaAttention)
    want = {"wq", "wkv_a", "kv_norm", "wkv_b", "wo"} if name == "reduced" \
        else {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    assert set(rparams["blocks"]["attn"]) == want
    assert {n for n, _ in model.blocks[0].attn.named_parameters()} == want
    n_ref = sum(np.size(a) for a in ref.jax.tree.leaves(rparams))
    assert sum(p.numel() for p in model.parameters()) == n_ref == \
        registry.param_count(cfg)
    for i, blk in enumerate(model.blocks):
        for leaf, p in blk.attn.named_parameters():
            np.testing.assert_array_equal(
                p.numpy(), np.asarray(rparams["blocks"]["attn"][leaf][i]))


def test_compute_params_cast_the_norms(built):
    """q_norm and kv_norm are [L, ·] in the reference, so its
    `_cast_params` casts them to the compute dtype."""
    _, model, _, _ = built("qlora", "bfloat16")
    blk = model.compute_params(torch.bfloat16)["blocks"][0]["attn"]
    assert all(t.dtype == torch.bfloat16 for t in blk.values())


def test_reset_parameters_draws_every_matrix():
    cfg = _cut("qlora")
    model = registry.build_model(cfg, torch.Generator().manual_seed(1),
                                 device="cpu")
    a = model.blocks[1].attn
    assert torch.equal(a.q_norm, torch.ones_like(a.q_norm))
    assert torch.equal(a.kv_norm, torch.ones_like(a.kv_norm))
    for w in (a.wq_a, a.wq_b, a.wkv_a, a.wkv_b, a.wo):
        assert 0.5 < float(w.std() * w.shape[0] ** 0.5) < 1.5


# ----------------------------------------------------------------------
# the functions
# ----------------------------------------------------------------------
S_FN = 40


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CFGS)
def test_mla_q_and_ckv_match_reference(built, ref, name, dtype):
    cfg, model, rcfg, rparams = built(name, dtype)
    rblk, pblk = _blocks(ref, model, rparams, cfg)
    rng = np.random.default_rng(1)
    x, jx = _pair(ref, _np(rng, (2, S_FN, 128), dtype), dtype)
    pos = np.arange(S_FN) + 7
    jpos = ref.jnp.asarray(pos)
    wq = ref.jax.jit(lambda p, x: ref.att._mla_q(p, x, rcfg, jpos))(rblk, jx)
    wc = ref.jax.jit(lambda p, x: ref.att._mla_ckv(p, x, rcfg, jpos))(rblk,
                                                                      jx)
    gq = att.mla_q(pblk, x, cfg, torch.from_numpy(pos))
    gc = att.mla_ckv(pblk, x, cfg, torch.from_numpy(pos))
    for g, w in zip(gq + gc, wq + wc):
        assert g.dtype == TDT[dtype]
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CFGS)
def test_mla_forward_matches_reference(built, ref, name, dtype):
    """Through `ops.flash_fwd`'s plain version (the CPU), with f32 keys
    beside bf16 q and v in bf16 runs."""
    cfg, model, rcfg, rparams = built(name, dtype)
    rblk, pblk = _blocks(ref, model, rparams, cfg, 1)
    rng = np.random.default_rng(2)
    x, jx = _pair(ref, _np(rng, (2, S_FN, 128), dtype), dtype)
    want = ref.jax.jit(lambda p, x: ref.att.mla_forward(
        p, x, ref.ctx, rcfg, ref.jnp.arange(S_FN)))(rblk, jx)
    before = ops.flash_fwd.launches
    got = att.mla_forward(pblk, x, cfg, torch.arange(S_FN))
    assert ops.flash_fwd.launches == before
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("S", [40, 300])
def test_mla_forward_rounds_as_xla_with_trained_norms(ref, S):
    """With norm scales other than the init's ones, k_nope read from
    c_kv's rounded last product would differ from the reference in ~50%
    of the bf16 outputs; read from the unrounded one (as XLA compiles
    `einsum_f32` of `rms_norm`), under 1% differ at all, the rest within
    one bf16 step. The decode step's outputs, over the latent cache,
    likewise."""
    cfg, rcfg = _configs(ref, "qlora", "bfloat16")
    rparams = ref.registry.init_params(rcfg, ref.jax.random.key(1))
    g = np.random.default_rng(9)
    for leaf in ("kv_norm", "q_norm"):
        shape = rparams["blocks"]["attn"][leaf].shape
        rparams["blocks"]["attn"][leaf] = ref.jnp.asarray(
            g.uniform(0.5, 1.5, shape).astype(np.float32))
    model = registry.build_model(cfg, torch.Generator(), device="cpu")
    registry.load_reference_params(model, ref.jax.tree.map(np.asarray,
                                                           rparams))
    rblk, pblk = _blocks(ref, model, rparams, cfg)
    x, jx = _pair(ref, _np(np.random.default_rng(S), (2, S, 128),
                           "bfloat16"), "bfloat16")
    want = ref.jax.jit(lambda p, x: ref.att.mla_forward(
        p, x, ref.ctx, rcfg, ref.jnp.arange(S)))(rblk, jx)
    got = att.mla_forward(pblk, x, cfg, torch.arange(S))
    _close(got, want, "bfloat16")
    assert np.mean(_f32(got) != _f32(want)) < 0.01
    ck, kr = att.mla_make_cache(pblk, x, cfg, torch.arange(S), S + 1)
    jck, jkr = ref.att.mla_make_cache(rblk, jx, rcfg, ref.jnp.arange(S),
                                      S + 1)
    xd, jxd = _pair(ref, _np(np.random.default_rng(1), (2, 1, 128),
                             "bfloat16"), "bfloat16")
    want = ref.jax.jit(lambda p, ck, kr, x: ref.att.mla_decode(
        p, ck, kr, x, ref.jnp.int32(S), rcfg, ref.ctx))(rblk, jck, jkr,
                                                         jxd)[0]
    got = att.mla_decode(pblk, ck, kr, xd, S, cfg)[0]
    _close(got, want, "bfloat16")
    assert np.mean(_f32(got) != _f32(want)) < 0.01


def test_mla_forward_keys_are_f32_in_bf16(built, monkeypatch):
    """The flash call of a bf16 run gets MLA's parts as they are, with
    nothing concatenated or cast for it: q_nope a strided view of the
    projection (its rows H (nope + rope) apart) and q_rope in bf16, k_nope
    in f32 (the reference's concatenation promotes the rope key, so its
    score product reads f32 keys), the one rope key [B,1,S,rope] of every
    head in bf16, and v [B,H,S,v] in bf16; no part holds Dq = nope + rope
    columns."""
    cfg, model, _, _ = built("qlora", "bfloat16")
    m, H = cfg.mla, cfg.n_heads
    nd, rd, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    seen = []
    fn = ops.flash_fwd_mla
    monkeypatch.setattr(ops, "flash_fwd_mla", lambda *a: (
        seen.append(a), fn(*a))[1])
    monkeypatch.setattr(ops, "flash_fwd", None)       # no other flash call
    pblk = model.compute_params(torch.bfloat16)["blocks"][0]["attn"]
    att.mla_forward(pblk, torch.zeros((1, 8, 128), dtype=torch.bfloat16),
                    cfg, torch.arange(8))
    assert len(seen) == 1
    q_nope, q_rope, k_nope, k_rope, v = seen[0][:5]
    assert [(tuple(t.shape), t.dtype) for t in seen[0][:5]] == [
        ((1, H, 8, nd), torch.bfloat16), ((1, H, 8, rd), torch.bfloat16),
        ((1, H, 8, nd), torch.float32), ((1, 1, 8, rd), torch.bfloat16),
        ((1, H, 8, vd), torch.bfloat16)]
    assert q_nope._base is not None and q_nope.stride()[2] == H * (nd + rd)
    assert all(t.shape[-1] != nd + rd for t in seen[0][:5])


@pytest.mark.parametrize("name", CFGS)
def test_mla_make_cache_matches_reference(built, ref, name):
    cfg, model, rcfg, rparams = built(name, "bfloat16")
    rblk, pblk = _blocks(ref, model, rparams, cfg)
    rng = np.random.default_rng(3)
    x, jx = _pair(ref, _np(rng, (2, 21, 128), "bfloat16"), "bfloat16")
    pos = np.arange(21) + 5
    want = ref.att.mla_make_cache(rblk, jx, rcfg, ref.jnp.asarray(pos), 48)
    got = att.mla_make_cache(pblk, x, cfg, torch.from_numpy(pos), 48)
    m = cfg.mla
    for g, w, width in zip(got, want, (m.kv_lora_rank, m.qk_rope_head_dim)):
        assert tuple(g.shape) == (2, 48, width) and g.is_contiguous()
        _close(g, w, "bfloat16")
        assert not _f32(g)[:, 21:].any()                # the zero pad


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CFGS)
def test_mla_decode_matches_reference(built, ref, name, dtype):
    """Decode steps over a 32-slot latent cache from position 26 to 35:
    past the cache's end the token lands at slot S - 1 (the reference's
    `dynamic_update_slice` clamps) and every slot is valid."""
    cfg, model, rcfg, rparams = built(name, dtype)
    rblk, pblk = _blocks(ref, model, rparams, cfg)
    rng = np.random.default_rng(4)
    m = cfg.mla
    ck, jck = _pair(ref, _np(rng, (2, 32, m.kv_lora_rank), dtype), dtype)
    kr, jkr = _pair(ref, _np(rng, (2, 32, m.qk_rope_head_dim), dtype), dtype)
    step = ref.jax.jit(lambda p, ck, kr, x, pos: ref.att.mla_decode(
        p, ck, kr, x, pos, rcfg, ref.ctx))
    for pos in range(26, 36):
        x, jx = _pair(ref, _np(rng, (2, 1, 128), dtype), dtype)
        want, jck, jkr = step(rblk, jck, jkr, jx, ref.jnp.int32(pos))
        got, ck, kr = att.mla_decode(pblk, ck, kr, x, pos, cfg)
        assert got.dtype == TDT[dtype]
        _close(got, want, dtype)
        _close(ck, jck, dtype)
        _close(kr, jkr, dtype)


# (B, H, S, Dq, Dv, block_k)
FLASH_CASES = {"mla_reduced": (2, 4, 40, 24, 16, 16),
               "qlora": (2, 2, 40, 48, 32, 16),
               "served_dims": (1, 2, 33, 96, 64, 512)}


@pytest.mark.parametrize("mixed", [True, False])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_fwd_ref_takes_dv_apart_and_f32_keys(ref, case, mixed):
    """The plain version with Dq != Dv against the reference's
    `flash_attention`: mixed, q and v bf16 and k f32 (MLA's bf16 run;
    one bf16 step of the output's max), else all f32 (1e-5). The
    wrapper takes the same on the CPU, bit for bit, and counts no
    launch."""
    B, H, S, Dq, Dv, bk = FLASH_CASES[case]
    rng = np.random.default_rng(Dq + Dv)
    qdt = "bfloat16" if mixed else "float32"
    q, jq = _pair(ref, _np(rng, (B, H, 1, S, Dq), qdt), qdt)
    k, jk = _pair(ref, rng.normal(size=(B, H, S, Dq)).astype(np.float32),
                  "float32")
    v, jv = _pair(ref, _np(rng, (B, H, S, Dv), qdt), qdt)
    want = ref.jax.jit(lambda q, k, v: ref.att.flash_attention(
        q, k, v, causal=True, block_k=bk, scale=Dq ** -0.5))(jq, jk, jv)
    out, lse = flash_fwd_ref(q, k, v, 0, bk)
    assert out.dtype == v.dtype and tuple(out.shape) == (B, H, 1, S, Dv)
    _close(out, want, qdt)
    before = ops.flash_fwd.launches
    got, got_lse = ops.flash_fwd(q, k, v, 0, bk)
    assert torch.equal(got, out) and torch.equal(got_lse, lse)
    assert ops.flash_fwd.launches == before


# (Dq, Dv, parts (nd, rd) or None, takes, the refusal's words); the ids
# of the cases before MLA's parts name the f32 keys they stood for
RULE_CASES = {
    "96-64-True-True": (96, 64, (64, 32), True, None),
    "48-32-True-True": (48, 32, (32, 16), True, None),
    "112-64-True-False": (112, 64, (80, 32), False, "nd = 80"),
    "96-80-True-False": (96, 80, (64, 32), False, "Dv = 80"),
    "112-64-False-True": (112, 64, None, True, None),
    "128-128-False-True": (128, 128, None, True, None),
    "reduced-parts": (24, 16, (16, 8), True, None),
    "rope-past-32": (112, 64, (64, 48), False, "rd = 48"),
    "deepseek-v2": (192, 128, (128, 64), False, "nd = 128"),
    "nope-off-8": (92, 64, (60, 32), False, "nd = 60"),
    "dense-off-16": (88, 64, None, False, "Dq = 88"),
}


@pytest.mark.parametrize("case", list(RULE_CASES), ids=list(RULE_CASES))
def test_card_rule_for_head_dims(case):
    """The card's rule (`flash.check_dims`): each head dim a multiple of
    16 up to 128; for MLA's parts (its f32 keys) nope at most 64, rope at
    most 32 and v at most 64, each a multiple of 8 (TMA's 16 bytes), so
    `deepseek-v2`'s 128 / 64 / 128 is refused."""
    Dq, Dv, parts, takes, words = RULE_CASES[case]
    if takes:
        _flash.check_dims(Dq, Dv, parts)
    else:
        with pytest.raises(ValueError, match=words):
            _flash.check_dims(Dq, Dv, parts)


# MLA's parts (B, H, S, nd, rd, Dv, block_k): both reduced configs, the
# served dims at a small S, and ragged S at the served dims
MLA_PART_CASES = {"mla_reduced": (2, 4, 40, 16, 8, 16, 16),
                  "qlora": (2, 2, 40, 32, 16, 32, 16),
                  "served_dims": (1, 2, 33, 64, 32, 64, 512),
                  "ragged_129": (1, 2, 129, 64, 32, 64, 64),
                  "ragged_1": (2, 3, 1, 64, 32, 64, 512)}


def _mla_parts(rng, B, H, S, nd, rd, Dv, dtype):
    """MLA's flash inputs from a seed: q_nope a strided view of a
    projection [B,S,H,nd + rd] as `mla_q` makes it, q_rope, k_nope (f32
    as a strided view of [B,S,H,nd]), the one rope key [B,1,S,rd] and v,
    in `dtype` (k_nope f32)."""
    dt = TDT[dtype]

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    q = draw(B, S, H, nd + rd).to(dt).transpose(1, 2)
    return (q[..., :nd], q[..., nd:].contiguous(),
            draw(B, S, H, nd).transpose(1, 2), draw(B, 1, S, rd).to(dt),
            draw(B, H, S, Dv).to(dt))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(MLA_PART_CASES))
def test_flash_fwd_mla_ref_is_the_concatenation(ref, case, dtype):
    """The parts' plain version (`flash_fwd_mla_ref`) is bit for bit
    `flash_fwd_ref` on the reference's concatenations (q = [q_nope,
    q_rope], k = [k_nope, k_rope expanded] in f32), which the parent's
    `mla_forward` passed to flash; the wrapper on the CPU is the plain
    version (no launch), and the reference's `flash_attention` on its
    own concatenations agrees (one bf16 step of the output's max in bf16,
    1e-5 in f32)."""
    B, H, S, nd, rd, Dv, bk = MLA_PART_CASES[case]
    parts = _mla_parts(np.random.default_rng(S + nd), B, H, S, nd, rd, Dv,
                       dtype)
    q_nope, q_rope, k_nope, k_rope, v = parts
    q = torch.cat([q_nope, q_rope], dim=-1)[:, :, None]
    k = torch.cat([k_nope, k_rope.float().expand(B, H, S, rd)], dim=-1)
    want, want_lse = flash_fwd_ref(q, k, v, 0, bk)
    out, lse = flash_fwd_mla_ref(*parts, bk)
    assert out.dtype == v.dtype and tuple(out.shape) == (B, H, 1, S, Dv)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    before = ops.flash_fwd.launches
    got, got_lse = ops.flash_fwd_mla(*parts, bk)
    assert torch.equal(got, out) and torch.equal(got_lse, lse)
    assert ops.flash_fwd.launches == before
    jnp = ref.jnp
    jdt = jnp.dtype(dtype)
    jq, jqr, jv = (jnp.asarray(t.float().numpy()).astype(jdt)
                   for t in (q_nope, q_rope, v))
    jk = jnp.concatenate([jnp.asarray(k_nope.numpy()), jnp.broadcast_to(
        jnp.asarray(k_rope.float().numpy()).astype(jdt), (B, H, S, rd))],
        axis=-1)
    jwant = ref.jax.jit(lambda q, k, v: ref.att.flash_attention(
        q[:, :, None], k, v, causal=True, block_k=bk,
        scale=(nd + rd) ** -0.5))(jnp.concatenate([jq, jqr], axis=-1), jk,
                                  jv)
    _close(out, jwant, dtype)


def test_flash_fwd_mla_refuses_what_it_does_not_take():
    """The parts' checks on the CPU: shapes (k_rope one head) and dtypes
    (k_nope f32, the rest q's); parts that need a gradient train through
    MLA's custom VJP (`attention._FlashMla`), each part's gradient
    `ops.flash_bwd_mla`'s, in the part's dtype."""
    parts = list(_mla_parts(np.random.default_rng(0), 1, 2, 8, 32, 16, 32,
                            "bfloat16"))
    ops.flash_fwd_mla(*parts)
    bad = {"k_rope must be \\(1, 1, 8, 16\\)": (3, parts[3].expand(
        1, 2, 8, 16)),
        "k_nope must be torch.float32": (2, parts[2].bfloat16()),
        "v must be torch.bfloat16": (4, parts[4].float()),
        "q_rope must be \\(1, 2, 8, 16\\)": (1, parts[1][:, :, :4])}
    for msg, (i, t) in bad.items():
        with pytest.raises((ValueError, TypeError), match=msg):
            ops.flash_fwd_mla(*parts[:i], t, *parts[i + 1:])
    grad = [t.float().requires_grad_() for t in parts]
    out = att._FlashMla.apply(*grad, 512)
    g = torch.ones_like(out)
    out.backward(g)
    o, lse = ops.flash_fwd_mla(*[t.detach() for t in grad])
    want = ops.flash_bwd_mla(g, *[t.detach() for t in grad], o, lse)
    for t, w in zip(grad, want):
        assert t.grad.dtype == t.dtype and torch.equal(t.grad, w)
    with torch.no_grad():
        ops.flash_fwd_mla(*grad)


def _ref_flash_vjp(ref, q, k, v, g):
    """jax.vjp of the reference's `flash_attention` at the tensors'
    dtypes (causal, Dq ** -0.5, blocks of 512)."""
    jnp = ref.jnp

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    return ref.jax.vjp(lambda a, b, c: ref.att.flash_attention(
        a, b, c, causal=True), j(q), j(k), j(v))[1](j(g))


def test_flash_bwd_refuses_the_mla_form(ref):
    """The backward's plain version takes the concatenated MLA form on
    the CPU (the card runs it from MLA's parts, `ops.flash_bwd_mla`):
    f32 keys beside bf16 q and v, Dq != Dv, and the one-dtype Dq != Dv
    form, each giving the reference's gradients (dk in k's dtype, f32
    for f32 keys; bf16 within one bf16 step of each output's max, f32
    within 1e-4 of it)."""
    rng = np.random.default_rng(11)

    def draw(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    q = draw(1, 2, 1, 8, 48)
    k = draw(1, 2, 8, 48, dtype=torch.float32)
    v = draw(1, 2, 8, 32)
    for kk, vv in ((k, v), (k, q[:, :, 0].contiguous()),
                   (k.bfloat16(), v)):
        out, lse = ops.flash_fwd(q, kk, vv)
        g = draw(*out.shape)
        got = ops.flash_bwd(g, q, kk, vv, out, lse)
        want = _ref_flash_vjp(ref, q, kk, vv, g)
        for a, w, t in zip(got, want, (q, kk, vv)):
            w = np.asarray(w.astype(ref.jnp.float32))
            assert a.dtype == t.dtype and tuple(a.shape) == w.shape
            tol = BF16_STEP if a.dtype == torch.bfloat16 else 1e-4
            np.testing.assert_allclose(a.float().numpy(), w, rtol=0,
                                       atol=tol * np.abs(w).max())


def test_flash_attention_under_autograd_refuses_mla(ref):
    """`flash_attention` under autograd with Dq != Dv (f32) gives the
    reference's gradients (within 1e-5 of each one's max)."""
    rng = np.random.default_rng(12)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((1, 1, 1, 8, 48), (1, 1, 8, 48),
                               (1, 1, 8, 32), (1, 1, 1, 8, 32)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    att.flash_attention(*leaves).backward(g)
    want = _ref_flash_vjp(ref, q, k, v, g)
    for t, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CFGS)
def test_lm_forward_matches_reference(built, ref, name, dtype):
    cfg, model, rcfg, rparams = built(name, dtype)
    toks = _tokens(cfg, 2, 48, seed=0)
    want = np.asarray(ref.transformer.lm_forward(
        rparams, ref.jnp.asarray(toks), rcfg, ref.ctx)[0], np.float32)
    got = _f32(transformer.lm_forward(model, torch.from_numpy(toks).long(),
                                      cfg))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **MODEL_F32)
        assert (got.argmax(-1) == want.argmax(-1)).all()
        return
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * BF16_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CFGS)
def test_prefill_and_decode_match_reference(built, ref, name, dtype):
    """Prefill of 20 tokens into a 32-slot cache, then 4 decode steps:
    the logits each step (f32 within 1e-4; bf16 within 0.0625, the ids
    equal where the reference's top-2 gap is clear) and every layer's
    latent cache, in the reference's names and layout."""
    cfg, model, rcfg, rparams = built(name, dtype)
    toks = _tokens(cfg, 2, 24, seed=1)
    S0, S_max = 20, 32
    rprefill = ref.jax.jit(ref.registry.prefill_fn(rcfg, ref.ctx, S_max,
                                                   tp=1))
    rdecode = ref.jax.jit(ref.registry.decode_fn(rcfg, ref.ctx))
    rlog, rcache = rprefill(rparams, {"tokens": ref.jnp.asarray(toks[:, :S0])})
    plog, pcache = registry.prefill_fn(cfg, S_max)(
        model, torch.from_numpy(toks[:, :S0]).long())
    spec = registry.cache_spec(cfg, 2, S_max)
    assert [{k: (tuple(v.shape), v.dtype) for k, v in c.items()}
            for c in pcache["blocks"]] == spec["blocks"]
    rspec = ref.transformer.lm_cache_spec(rcfg, 2, S_max, tp=1)
    tree = transformer.stack_cache(pcache)
    assert set(tree["blocks"]) == set(rspec["blocks"]) == {"c_kv", "k_rope"}
    for leaf, t in tree["blocks"].items():
        assert tuple(t.shape) == tuple(rspec["blocks"][leaf].shape)
    tol = MODEL_F32 if dtype == "float32" else dict(atol=BF16_ATOL, rtol=0)
    for t in range(S0, 24):
        lp, lr = _f32(plog), _f32(rlog)
        np.testing.assert_allclose(lp, lr, **tol)
        top2 = np.sort(lr, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol["atol"]
        np.testing.assert_array_equal(lp.argmax(-1)[clear],
                                      lr.argmax(-1)[clear])
        stacked = transformer.stack_cache(pcache)["blocks"]
        for leaf in ("c_kv", "k_rope"):
            _close(stacked[leaf], rcache["blocks"][leaf], dtype, MODEL_F32,
                   BF16_ATOL)
        rlog, rcache = rdecode(rparams, rcache,
                               ref.jnp.asarray(toks[:, t:t + 1]),
                               ref.jnp.int32(t))
        plog, pcache = registry.decode_fn(cfg)(
            model, pcache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
    np.testing.assert_allclose(_f32(plog), _f32(rlog), **tol)


@pytest.mark.parametrize("name", CFGS)
def test_decode_matches_own_full_forward(built, name):
    """The absorbed decode is another computation than the expanded
    prefill; in f32 they agree: prefill of 16 then 6 steps against the
    full forward's last logits."""
    cfg, model, _, _ = built(name, "float32")
    toks = torch.from_numpy(_tokens(cfg, 2, 22, seed=2)).long()
    logits, cache = registry.prefill_fn(cfg, 32)(model, toks[:, :16])
    for t in range(16, 22):
        logits, cache = registry.decode_fn(cfg)(model, cache,
                                                toks[:, t:t + 1], t)
    full = transformer.lm_forward(model, toks, cfg)[:, -1]
    np.testing.assert_allclose(_f32(logits), _f32(full), atol=1e-4,
                               rtol=1e-4)


def test_training_mla_is_not_yet_ported(built, capsys):
    """MLA trains now (`tests/test_torch_mla_train.py` holds it to the
    reference): `loss_fn` and `lm_loss` give a finite loss whose
    backward reaches every leaf, and the launcher trains it on the
    host."""
    cfg, _, _, rparams = built("reduced", "float32")
    model = registry.build_model(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    registry.load_reference_params(model, compat.tree_map(np.asarray,
                                                          rparams))
    model.requires_grad_(True)
    toks = torch.ones((1, 8), dtype=torch.long)
    batch = {"tokens": toks, "targets": toks}
    tree = transformer.param_tree(model)
    loss, _ = registry.loss_fn(cfg)(tree, batch)
    again, _ = transformer.lm_loss(tree, batch, cfg)
    assert torch.isfinite(loss) and torch.equal(loss, again)
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    from repro_torch.launch import train as train_cli
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16"])
    assert "[train] step     1 loss" in capsys.readouterr().out


def test_moe_with_mla_is_still_refused():
    moe = reduced(get_config("granite-moe-1b-a400m"))
    cfg = moe.replace(mla=reduced(get_config(ARCH)).mla)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        registry.build_model(cfg, torch.Generator(), device="cpu")


# ----------------------------------------------------------------------
# the engine and the CLI
# ----------------------------------------------------------------------
def _requests(cfg, lengths, max_new, request_cls):
    rng = np.random.default_rng(5)
    return [request_cls(rid=i,
                        prompt=rng.integers(1, cfg.vocab,
                                            n).astype(np.int32),
                        max_new=max_new)
            for i, n in enumerate(lengths)]


LENGTHS, MAX_NEW = (5, 23, 40), 8


class _LoggingEngine(Engine):
    """The port's Engine, keeping each step's logits."""

    def _ids(self, logits, t0, key):
        self.logged = getattr(self, "logged", []) + [
            logits.float().numpy().copy()]
        return super()._ids(logits, t0, key)


def _logging_reference(ref, rcfg, rparams):
    eng = ref.engine.Engine(rcfg, rparams,
                            ref.engine.ServeConfig(batch=2, s_max=64))
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
@pytest.mark.parametrize("name", CFGS)
def test_engine_serve_ids_equal_reference(built, ref, name, dtype):
    """Three requests of 8 new tokens over two groups of a batch-2
    engine. f32: the served ids are the reference's. bf16: every step's
    logits within 0.0625 while a request's ids agree, and its ids agree
    to the end but at a reference top-2 tie (as the dense family's
    test)."""
    cfg, model, rcfg, rparams = built(name, dtype)
    reng = _logging_reference(ref, rcfg, rparams)
    want = reng.serve(_requests(rcfg, LENGTHS, MAX_NEW, ref.engine.Request))
    eng = _LoggingEngine(cfg, model, ServeConfig(batch=2, s_max=64),
                         device="cpu")
    reqs = _requests(cfg, LENGTHS, MAX_NEW, Request)
    got = eng.serve(reqs)
    assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
    assert len(eng.logged) == len(reng.logged) == 2 * (1 + MAX_NEW)
    if dtype == "float32":
        assert got == want
        return
    for i in range(len(LENGTHS)):
        group, slot = divmod(i, 2)
        for t in range(MAX_NEW):
            step = group * (1 + MAX_NEW) + t
            lp, lr = eng.logged[step][slot], reng.logged[step][slot]
            eps = float(np.abs(lp - lr).max())
            assert eps <= BF16_ATOL, (i, t, eps)
            if got[i][t] != want[i][t]:
                top2 = np.sort(lr)[-2:]
                assert top2[1] - top2[0] <= 2 * eps, (i, t, top2, eps)
                break


def test_serve_cli_runs_mla_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--requests", "3", "--batch", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"{ARCH} on cpu: 3 requests, 9 tokens" in out


# ----------------------------------------------------------------------
# kv_migrate of the latent cache on 4 pods (tests/test_torch_migrate.py's
# harness: the port on 4 gloo ranks, the reference in one subprocess)
# ----------------------------------------------------------------------
def _latent_cache_inputs():
    cfg = reduced(get_config(ARCH))
    spec = registry.cache_spec(cfg, 2, 24)
    rng = np.random.default_rng(8)
    flat, dtypes = {}, {}
    for name, (shape, _) in spec["blocks"][0].items():
        a = mig._bf16_values(rng.normal(
            size=(len(spec["blocks"]),) + shape).astype(np.float32))
        flat[f"blocks/{name}"] = a
        dtypes[f"blocks/{name}"] = "bfloat16"
    return flat, dtypes


def _migrate_latent_pod(rank, n_pods, flat, dtypes):
    torch.set_num_threads(1)
    local = mig._nest(mig._local(flat, dtypes, rank))
    layered = {"blocks": [{k: v[i].clone() for k, v in
                           local["blocks"].items()}
                          for i in range(len(local["blocks"]["c_kv"]))]}
    moved = kv_migrate(layered, mig.make_plan(mig.PLANS["fixed"]), 0)
    assert isinstance(moved["blocks"], list)
    return mig._numpy(mig._flatten(transformer.stack_cache(moved)))


def test_kv_migrate_of_the_latent_cache_matches_reference(tmp_path):
    """Both leaves, c_kv and k_rope, on every pod bit-equal to the
    reference's kv_migrate of the same tree."""
    flat, dtypes = _latent_cache_inputs()
    port = compat.run_pods(_migrate_latent_pod, mig.N_PODS, flat, dtypes,
                           timeout=mig.DEADLINE)
    spec = {"cases": {"mla": ("mla", "fixed", 0, True)},
            "plans": mig.PLANS, "dtypes": dtypes, "paths": {"mla": list(flat)}}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    np.savez(tmp_path / "in.npz", **{f"mla:{p}": a for p, a in flat.items()})
    env = dict(os.environ, PYTHONPATH=mig.SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", mig._REFERENCE, str(tmp_path / "spec.json"),
         str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
        capture_output=True, text=True, env=env, timeout=mig.DEADLINE)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    with np.load(tmp_path / "out.npz") as z:
        want = {k.split(":", 1)[1]: z[k] for k in z.files}
    assert set(flat) == {"blocks/c_kv", "blocks/k_rope"}
    for rank in range(mig.N_PODS):
        for path in flat:
            np.testing.assert_array_equal(port[rank][path], want[path][rank],
                                          err_msg=f"{path} pod {rank}")
    assert not np.array_equal(port[1]["blocks/c_kv"], port[0]["blocks/c_kv"])


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _chip_smoke():
    """`chip_smoke.py`, whose `flash_err` and lse bound (`flash_lse_tol`)
    are the card check's tolerance rule."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.fixture
def smoke(card):
    return _chip_smoke()


# (k_scale, keys): "f32", every column an f32 key (the split's bound on
# its own); "parts", MLA's keys, f32 nope columns beside the bf16 rope
# key, where the kernel forms q . lo over the nope columns only
SPLIT_CASES = {"1.0": (1.0, "f32"), "8.0": (8.0, "f32"),
               "64.0": (64.0, "f32"), "1.0-parts": (1.0, "parts"),
               "8.0-parts": (8.0, "parts"), "64.0-parts": (64.0, "parts")}


@pytest.mark.parametrize("case", list(SPLIT_CASES), ids=list(SPLIT_CASES))
def test_split_keys_stay_within_the_lse_bound(case):
    """The card's key split, hi = bf16(k) and lo = bf16(k - hi), drops
    under 2^-17 |k| an element; the plain version on hi + lo (exact in
    f32, as the kernel's products into one f32 accumulator are) holds
    the f32 keys' lse within `chip_smoke.flash_lse_tol` at every key
    scale, where keys rounded to bf16 miss it. For MLA's parts (f32
    nope columns, the bf16 rope key) the kernel leaves out the rope
    columns' lo product: their lo is exactly 0, so the keys it emulates
    are bit for bit those of the split over every column (the parent's
    form, which multiplied it), and so are out and lse."""
    k_scale, keys = SPLIT_CASES[case]
    smoke = _chip_smoke()
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 256, 96)).astype(
        np.float32)).bfloat16()
    k = torch.from_numpy((k_scale * rng.standard_normal((2, 4, 256, 96))
                          ).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 4, 256, 64)).astype(
        np.float32)).bfloat16()
    nd = 64
    if keys == "parts":   # the rope key: one bf16 key of every head
        k[..., nd:] = k[:, :1, :, nd:].bfloat16().float()
    hi = k.bfloat16()
    lo = (k - hi.float()).bfloat16()
    split = hi.float() + lo.float()
    if keys == "parts":
        parts = hi.float() + torch.cat(
            [lo[..., :nd].float(), torch.zeros_like(lo[..., nd:].float())],
            dim=-1)
        assert not lo[..., nd:].float().any()
        assert torch.equal(parts, split)
        assert all(torch.equal(a, b) for a, b in zip(
            flash_fwd_ref(q, parts, v, 0, 512),
            flash_fwd_ref(q, split, v, 0, 512)))
    assert bool(((k - split).abs() <= smoke.KEY_SPLIT_DROP * k.abs()).all())
    _, want = flash_fwd_ref(q, k, v, 0, 512)
    tol = smoke.flash_lse_tol(q, k, 0)
    for window in (0, 17):
        assert bool((smoke.flash_lse_tol(q, k, window) <= tol).all())
    assert smoke.lse_err(flash_fwd_ref(q, split, v, 0, 512)[1], want, q, k,
                         0)["lse_err"] <= 1.0
    with pytest.raises(AssertionError, match="of its tolerance"):
        smoke.lse_err(flash_fwd_ref(q, hi.float(), v, 0, 512)[1], want, q,
                      k, 0)


def _mla_inputs(card, B, H, S, nd, rd, Dv, seed, mixed=True, k_scale=1.0):
    """`_mla_parts` on the card (k_nope times `k_scale`), bf16 beside f32
    k_nope (`mixed`) or all f32."""
    parts = list(_mla_parts(np.random.default_rng(seed), B, H, S, nd, rd,
                            Dv, "bfloat16" if mixed else "float32"))
    parts[2] = parts[2] * k_scale
    return [t.to(card) for t in parts]


# (B, H, S, nd, rd, Dv): the served shape (group 1's prefill of
# minicpm3-4b), ragged tiles (S 1, 127, 129, 130), the qlora and reduced
# configs' dims, Dv below 64 (v's columns zero-filled by TMA), each with
# f32 k_nope by bf16 q, k_rope and v and all in f32
CARD_CASES = [(4, 40, 641, 64, 32, 64), (1, 3, 130, 64, 32, 64),
              (2, 2, 200, 32, 16, 32), (1, 2, 300, 64, 32, 16),
              (1, 1, 1, 64, 32, 64), (1, 2, 127, 64, 32, 64),
              (1, 2, 129, 64, 32, 64), (2, 4, 40, 16, 8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,mixed", [
    (case, mixed) for case in CARD_CASES for mixed in (True, False)])
def test_card_kernel_matches_plain(card, smoke, case, mixed):
    """MLA's parts (q_nope a strided view of the projection, k_nope a
    strided f32 view, the shared rope key), bf16 beside f32 k_nope (the
    in-kernel hi / lo split) or all f32: out within the flash tolerance
    of the plain version (the reference's concatenations), lse within
    each row's bound (`chip_smoke.flash_lse_tol`), one launch a call, no
    copy."""
    B, H, S, nd, rd, Dv = case
    parts = _mla_inputs(card, B, H, S, nd, rd, Dv, seed=S + nd, mixed=mixed)
    before = (ops.flash_fwd.launches, ops.flash_fwd.copies)
    out, lse = ops.flash_fwd_mla(*parts)
    torch.cuda.synchronize()
    assert (ops.flash_fwd.launches, ops.flash_fwd.copies) == \
        (before[0] + 1, before[1])
    assert tuple(out.shape) == (B, H, 1, S, Dv) and out.dtype == parts[4].dtype
    want, want_lse = flash_fwd_mla_ref(*parts, 512)
    q, k = _concatenated(parts)
    smoke.flash_err(out, want, "mla out")
    smoke.lse_err(lse, want_lse, q, k, 0)


def _concatenated(parts):
    """q [B,H,1,S,Dq] and k [B,H,S,Dq] (f32) as the reference
    concatenates MLA's parts (for the lse bound's |q| |k|)."""
    q_nope, q_rope, k_nope, k_rope, _ = parts
    B, H, S, rd = q_rope.shape
    return (torch.cat([q_nope, q_rope], dim=-1)[:, :, None],
            torch.cat([k_nope, k_rope.float().expand(B, H, S, rd)], dim=-1))


@pytest.mark.cuda
def test_card_dense_f32_takes_dq_past_96(card, smoke):
    """The dense f32 form (one dtype, ops.flash_fwd) with Dq 112 beside
    Dv 64, which MLA's parts' rule would refuse."""
    rng = np.random.default_rng(129)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).to(card)
               for s in ((1, 2, 1, 129, 112), (1, 2, 129, 112),
                         (1, 2, 129, 64)))
    out, lse = ops.flash_fwd(q, k, v)
    want, want_lse = flash_fwd_ref(q, k, v, 0, 512)
    smoke.flash_err(out, want, "f32 out")
    smoke.lse_err(lse, want_lse, q, k, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k_scale", [1.0, 8.0])
def test_card_split_keeps_what_bf16_keys_lose(card, smoke, k_scale):
    """The in-kernel hi / lo split of k_nope holds out within the flash
    tolerance of the plain version and its lse within each row's bound,
    sc * 2^-17 * max_j sum_d |q_d k_jd| beside the f32 sums' 1e-5
    (`chip_smoke.flash_lse_tol`), at unit keys and at keys eight times
    larger (the bound grows with them); the same keys rounded to bf16
    (the dense bf16 kernel on the concatenation), which move a score by
    up to 2^-9 of sum |q k|, miss it."""
    parts = _mla_inputs(card, 2, 4, 256, 64, 32, 64, seed=3,
                        k_scale=k_scale)
    want, want_lse = flash_fwd_mla_ref(*parts, 512)
    q, k = _concatenated(parts)
    out, lse = ops.flash_fwd_mla(*parts)
    _, lse16 = ops.flash_fwd(q, k.bfloat16(), parts[4])
    torch.cuda.synchronize()
    smoke.flash_err(out, want, "mla out")
    tol = smoke.flash_lse_tol(q, k, 0)
    assert float(tol.min()) > smoke.FLASH_LSE_TOL
    split = (lse.double() - want_lse.double()).abs()
    rounded = (lse16.double() - want_lse.double()).abs()
    assert bool((split <= tol).all()), float((split / tol).max())
    assert bool((rounded > tol).any()), float((rounded / tol).max())


@pytest.mark.cuda
def test_card_parts_are_read_in_place(card):
    """At the served shape: two calls give the same bits, and the
    strided views (q_nope of the projection, k_nope of its product) give
    the bits of their dense copies."""
    parts = _mla_inputs(card, 4, 40, 641, 64, 32, 64, seed=5)
    assert not parts[0].is_contiguous() and not parts[2].is_contiguous()
    first = ops.flash_fwd_mla(*parts)
    second = ops.flash_fwd_mla(*parts)
    dense = ops.flash_fwd_mla(*[t.contiguous() for t in parts])
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, dense):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_card_refuses_what_the_kernel_does_not_take(card):
    """The parts' rule (nope 64, rope 32, v 64), f32 keys beside a bf16 q
    in the dense form (the card takes MLA from its parts, forward and
    backward), flash_bwd of the MLA form; no launch."""
    before = (ops.flash_fwd.launches, ops.flash_bwd.launches)
    for dims, words in (((80, 32, 64), "nd = 80"), ((64, 32, 80), "Dv = 80"),
                        ((64, 48, 64), "rd = 48")):
        parts = _mla_inputs(card, 1, 2, 64, *dims, seed=1)
        with pytest.raises(ValueError, match=words):
            ops.flash_fwd_mla(*parts)
    parts = _mla_inputs(card, 1, 2, 64, 64, 32, 64, seed=1)
    q, k = _concatenated(parts)
    with pytest.raises(ValueError, match="from its parts"):
        ops.flash_fwd(q, k, parts[4])
    out = torch.zeros((1, 2, 1, 64, 64), dtype=torch.bfloat16, device=card)
    lse = torch.zeros((1, 2, 1, 64), device=card)
    with pytest.raises(ValueError, match="from its parts"):
        ops.flash_bwd(out, q, k, parts[4], out, lse)
    assert (ops.flash_fwd.launches, ops.flash_bwd.launches) == before


@pytest.mark.cuda
def test_card_serves_as_the_host(card):
    """The qlora config in f32 on the card (the f32 flash kernel at Dq
    48, Dv 32; one launch a layer a prefill) and on the host with the
    same weights: prefill and 4 decode steps within 1e-3, ids equal."""
    cfg = _cut("qlora").replace(dtype="float32")
    card_model = registry.build_model(
        cfg, torch.Generator(card).manual_seed(0), card)
    host_model = transformer.DenseLM(cfg, torch.device("cpu"), torch.float32)
    host_model.load_state_dict(card_model.state_dict())
    sc = ServeConfig(batch=2, s_max=64)
    before = ops.flash_fwd.launches
    outs, logits = [], []
    for eng in (Engine(cfg, card_model, sc),
                Engine(cfg, host_model, sc, device="cpu")):
        outs.append(eng.serve(_requests(cfg, LENGTHS[:2], 4, Request)))
        logits.append(eng.last_logits.float().cpu().numpy())
    torch.cuda.synchronize()
    assert ops.flash_fwd.launches - before == cfg.n_layers
    np.testing.assert_allclose(logits[0], logits[1], atol=1e-3, rtol=1e-3)
    assert outs[0] == outs[1]
