"""The port's training of MLA (multi-head latent attention,
`minicpm3-4b`) against the JAX reference, on the CPU, on the two configs
`tests/test_torch_mla.py` cuts from it: "reduced" (2 layers, d_model 128,
4 heads, kv_lora 32, no q-LoRA, Dq = 16 + 8 = 24, Dv = 16) and "qlora"
(q_lora_rank 48, nope 32, rope 16, v 32: Dq 48, Dv 32). The reference's
parameters are carried across by `load_reference_params`; inputs are
made with numpy from a seed. Its 4-pod WANify run is
`tests/test_torch_mla_train_pods.py`.

MLA trains through flash's MLA form: the forward reads MLA's parts
(`ops.flash_fwd_mla`), the backward (`ops.flash_bwd_mla`, through
`attention._FlashMla`) is the reference's custom VJP on its
concatenations q = [q_nope, q_rope] and k = [k_nope, k_rope broadcast
over the heads] (f32: the concatenation promotes the rope key), followed
by the concatenations' transposes: dq rounded once and sliced, dk_nope
in f32, dk_rope each head's rope columns converted to the key's dtype
and summed over the heads in it, as XLA's CPU program sums the
broadcast's transpose (windows of 32 heads, every add rounded:
`ref.rope_head_sum`, bit-equal).

Tolerances:
- the backward's plain version against `jax.vjp` of the reference's
  `flash_attention` on the concatenations: the heads' sum bit-equal on
  equal terms; bf16 outputs within one bf16 step (2^-7) of their max,
  f32 outputs
  within 1e-5 of their max in f32 runs and DK_BF16_RUN (1e-4) in bf16
  runs (f32 sums in another order over bf16 inputs: measured 3.1e-5).
- the model: the loss within LOSS_RTOL (1e-5) and every gradient leaf
  within GRAD_TOL (1e-4) of its max |g| in f32 (measured: loss 1.4e-7,
  leaves 2.1e-6, `blocks.attn.kv_norm`); in bf16 the other families'
  bounds, BF16_GRAD_TOL (5e-2) and BF16_LOSS_RTOL (1e-3) (measured:
  3.41e-2, the qlora config's `blocks.attn.kv_norm`; 2.05e-2 on the
  reduced config's `blocks.ln1`; the loss 8.8e-5).
- the 1-pod Trainer (8 steps, lr 1e-3): f32 losses within TRAIN_RTOL
  (1e-4) and the final parameters within PARAM_LR_TOL (0.5) lr; bf16
  losses within MLA_BF16_LOSS_RTOL (2e-3, the hybrid's and the MoE's
  bound: AdamW turns the first step's rounding gap into lr-sized
  parameter differences).
- the card against the host (`cuda` cases, f32): within CARD_TOL (1e-3)
  of each leaf's max |g|; the kernels against their plain version under
  `chip_smoke.py`'s flash rule (bf16 rows within 2^-7 of their max, f32
  1e-5), dk (f32 in a bf16 run) under the bf16 rule, two calls with the
  same bits.

k_nope is the f32 product of c_kv before its last rounding in the
training program too, as in the serve program (`attention.mla_latent`):
with trained norm scales the reference's loss is 3.7e-5 from the port's
as it is and 2.1e-4 from a port that rounds c_kv first
(`test_training_reads_the_unrounded_latent`).

Card-only cases (marked `cuda`) import no jax:
``python -m pytest -q -m cuda tests/test_torch_mla_train.py``.
"""
import dataclasses
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_checkpoint import _assert_same
from test_torch_train import (GRAD_TOL, LOSS_RTOL, TRAIN_RTOL, _batch, _flat,
                              _leaf_close, _rel, _torch_batch)
from repro_torch.compat import tree_map
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (flash_bwd_mla_ref, flash_fwd_mla_ref,
                                     rope_head_sum)
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as att
from repro_torch.models import registry, transformer
from repro_torch.train import optimizer
from repro_torch.train.loop import LoopConfig, Trainer

ARCH = "minicpm3-4b"
CFGS = ["reduced", "qlora"]
REMATS = ["none", "full", "dots"]
QLORA = dict(q_lora_rank=48, qk_nope_head_dim=32, qk_rope_head_dim=16,
             v_head_dim=32)
BF16_STEP = 2.0 ** -7
DK_BF16_RUN = 1e-4          # of the max: f32 dk_nope in a bf16 run
BF16_GRAD_TOL = 5e-2        # of each leaf's max |g|
BF16_LOSS_RTOL = 1e-3
MLA_BF16_LOSS_RTOL = 2e-3
PARAM_LR_TOL = 0.5          # of lr, the 1-pod Trainer's final parameters
CARD_TOL = 1e-3             # of each leaf's max |g|, card vs host
TRAIN_KW = dict(lr=1e-3, warmup_steps=2, total_steps=8)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MLA_LEAVES = ["blocks.attn.wkv_a", "blocks.attn.kv_norm", "blocks.attn.wkv_b",
              "blocks.attn.wo"]
QLORA_LEAVES = ["blocks.attn.wq_a", "blocks.attn.q_norm", "blocks.attn.wq_b"]


def _cut(name):
    """The port's config `name` ("reduced" or "qlora")."""
    cfg = reduced(get_config(ARCH))
    if name == "qlora":
        cfg = cfg.replace(mla=dataclasses.replace(cfg.mla, **QLORA))
    return cfg


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's model, checkpoint and train modules."""
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.checkpoint import ckpt as ref_ckpt
    from repro.configs import get_config as ref_config
    from repro.configs.base import reduced as ref_reduced
    from repro.data import pipeline as ref_pipeline
    from repro.models import attention as ref_att
    from repro.models import registry as ref_registry
    from repro.models import transformer as ref_transformer
    from repro.models.layers import ShardCtx
    from repro.train import loop as ref_loop
    from repro.train import optimizer as ref_opt
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, compat=compat, ckpt=ref_ckpt, config=ref_config,
        reduced=ref_reduced, pipeline=ref_pipeline, att=ref_att,
        registry=ref_registry, transformer=ref_transformer,
        ShardCtx=ShardCtx, loop=ref_loop, opt=ref_opt)


def _ref_cfg(ref, name, dtype):
    rcfg = ref.reduced(ref.config(ARCH)).replace(dtype=dtype)
    if name == "qlora":
        rcfg = rcfg.replace(mla=dataclasses.replace(rcfg.mla, **QLORA))
    return rcfg


@pytest.fixture(scope="module")
def built(ref):
    """(config, dtype) -> (port cfg, ref cfg, ref params as numpy), built
    once per module."""
    cache = {}

    def get(name, dtype="float32"):
        if (name, dtype) not in cache:
            rcfg = _ref_cfg(ref, name, dtype)
            rparams = ref.jax.tree.map(np.asarray, ref.registry.init_params(
                rcfg, ref.jax.random.key(0)))
            cache[name, dtype] = (_cut(name).replace(dtype=dtype), rcfg,
                                  rparams)
        return cache[name, dtype]
    return get


def _model(cfg, rparams):
    """The port's MLA model holding the reference's parameters,
    training."""
    model = registry.build_model(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    registry.load_reference_params(model, rparams)
    return model.requires_grad_(True)


@pytest.fixture
def from_reference(monkeypatch):
    """from_reference(rparams): the port's Trainers start from the
    reference's init (`registry.init_params` loads its parameters)."""
    def use(rparams):
        build = registry.build_model

        def init(cfg, generator, device):
            model = build(cfg, generator, device)
            registry.load_reference_params(model, rparams)
            return model
        monkeypatch.setattr(registry, "init_params", init)
    return use


# ----------------------------------------------------------------------
# flash's MLA backward, plain version
# ----------------------------------------------------------------------
# (B, H, S, nd, rd, Dv, block_k): both reduced configs (the last key block
# padded), 40 heads (two windows of the heads' sum), 33 (one window, the
# pad split 0 / 1 against 32) and the served dims
BWD_CASES = {"mla_reduced": (2, 4, 40, 16, 8, 16, 16),
             "qlora": (2, 2, 40, 32, 16, 32, 16),
             "heads_40": (2, 40, 33, 16, 8, 16, 512),
             "heads_33": (1, 33, 20, 16, 8, 16, 512),
             "served_dims": (1, 2, 33, 64, 32, 64, 512)}


def _mla_parts(rng, B, H, S, nd, rd, Dv, dtype):
    """MLA's flash inputs and a cotangent of out from a seed: q_nope a
    strided view of the projection, q_rope, k_nope f32 (a strided view),
    the one rope key [B,1,S,rd], v, and g [B,H,1,S,Dv] a strided view as
    the transpose of `mla_forward`'s `o` hands it back."""
    dt = TDT[dtype]

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    q = draw(B, S, H, nd + rd).to(dt).transpose(1, 2)
    parts = (q[..., :nd], q[..., nd:].contiguous(),
             draw(B, S, H, nd).transpose(1, 2), draw(B, 1, S, rd).to(dt),
             draw(B, H, S, Dv).to(dt))
    return parts, draw(B, S, H, Dv).to(dt).transpose(1, 2)[:, :, None]


def _ref_vjp(ref, parts, g, bk):
    """jax.vjp of the reference's `flash_attention` on MLA's
    concatenations (mla_forward's), at the parts' dtypes."""
    jnp = ref.jnp
    q_nope, q_rope, k_nope, k_rope, v = parts
    B, H, S, rd = q_rope.shape
    nd = q_nope.shape[3]

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)

    def f(qn, qr, kn, kr, vv):
        q = jnp.concatenate([qn, qr], axis=-1)
        k = jnp.concatenate([kn, jnp.broadcast_to(kr, (B, H, S, rd))],
                            axis=-1)
        return ref.att.flash_attention(q[:, :, None], k, vv, causal=True,
                                       block_k=bk, scale=(nd + rd) ** -0.5)
    return ref.jax.jit(lambda *a: ref.jax.vjp(f, *a[:5])[1](a[5]))(
        *(j(t) for t in parts), j(g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_bwd_mla_ref_matches_reference_vjp(ref, case, dtype):
    """`flash_bwd_mla_ref` (and the wrapper on the CPU, bit for bit, no
    launch) against jax.vjp of the reference's `flash_attention` on the
    concatenations: each part's cotangent in its dtype and shape
    (dk_nope f32 in both runs, dk_rope [B,1,S,rd]). The heads' sum is
    bit-equal on equal terms (`test_rope_head_sum_is_the_broadcasts_
    transpose`); here its terms are f32 sums in another order, so a
    term can round to the other bf16 neighbour."""
    B, H, S, nd, rd, Dv, bk = BWD_CASES[case]
    parts, g = _mla_parts(np.random.default_rng(S + H), B, H, S, nd, rd, Dv,
                          dtype)
    want = _ref_vjp(ref, parts, g, bk)
    out, lse = flash_fwd_mla_ref(*parts, bk)
    got = flash_bwd_mla_ref(g, *parts, out, lse, bk)
    before = ops.flash_bwd.launches
    again = ops.flash_bwd_mla(g, *parts, out, lse, bk)
    assert ops.flash_bwd.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    names = ("dq_nope", "dq_rope", "dk_nope", "dk_rope", "dv")
    dtypes = (TDT[dtype], TDT[dtype], torch.float32, TDT[dtype], TDT[dtype])
    for name, a, b, dt, p in zip(names, got, want, dtypes,
                                 (0, 1, 2, 3, 4)):
        w = np.asarray(b.astype(ref.jnp.float32))
        assert a.dtype == dt and tuple(a.shape) == w.shape, name
        assert tuple(a.shape) == tuple(parts[p].shape), name
        a = a.float().numpy()
        if dt == torch.bfloat16:
            tol = BF16_STEP
        else:
            tol = 1e-5 if dtype == "float32" else DK_BF16_RUN
        np.testing.assert_allclose(a, w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("H", [1, 4, 32, 33, 40, 64, 97])
def test_rope_head_sum_is_the_broadcasts_transpose(ref, H):
    """`ref.rope_head_sum` bit for bit against jax.vjp of the
    reference's promotion of the broadcast rope key (the key bf16, the
    concatenation f32): one sum in order up to 32 heads, windows of 32
    above, every add rounded to bf16; in f32 within 1e-6."""
    rng = np.random.default_rng(H)
    ct = rng.standard_normal((2, H, 12, 8)).astype(np.float32) * 3
    jnp = ref.jnp
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        kr = jnp.zeros((2, 1, 12, 8), jdt)
        _, vjp = ref.jax.vjp(lambda k: jnp.broadcast_to(
            k, (2, H, 12, 8)).astype(jnp.float32), kr)
        want = np.asarray(ref.jax.jit(vjp)(jnp.asarray(ct))[0].astype(
            jnp.float32))
        got = rope_head_sum(torch.from_numpy(ct), dt)
        assert got.dtype == dt and tuple(got.shape) == (2, 1, 12, 8)
        if dt == torch.bfloat16:
            np.testing.assert_array_equal(got.float().numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_mla_trains_through_autograd(dtype):
    """`attention._FlashMla` under autograd: the parts' gradients are
    `ops.flash_bwd_mla`'s (the forward saves out and lse), and each
    part's gradient has the part's dtype, k_nope's f32."""
    parts, g = _mla_parts(np.random.default_rng(7), 2, 3, 24, 16, 8, 16,
                          dtype)
    leaves = [t.detach().clone().requires_grad_() for t in parts]
    out = att._FlashMla.apply(*leaves, 16)
    out.backward(g)
    o, lse = flash_fwd_mla_ref(*parts, 16)
    assert torch.equal(out.detach(), o)
    want = flash_bwd_mla_ref(g, *parts, o, lse, 16)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        assert torch.equal(leaf.grad, w)


# ----------------------------------------------------------------------
# the loss and its gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("name", CFGS)
def test_lm_loss_and_grads_match_reference(ref, built, name, remat, dtype):
    """`registry.loss_fn` and torch.autograd against jax.value_and_grad
    of the reference's `lm_loss` under the same remat: the loss and every
    gradient leaf (the q-LoRA pair and its norm, wkv_a, kv_norm, wkv_b,
    wo), in the reference's stacked layout."""
    cfg, rcfg, rparams = built(name, dtype)
    b = _batch(cfg)
    (want_loss, _), g = ref.jax.value_and_grad(
        lambda p: ref.transformer.lm_loss(
            p, {k: ref.jnp.asarray(v) for k, v in b.items()}, rcfg,
            ref.ShardCtx(remat=remat)), has_aux=True)(rparams)
    want = _flat(ref.jax.tree.map(np.asarray, g))
    model = _model(cfg, rparams)
    loss, metrics = registry.loss_fn(cfg, remat)(
        transformer.param_tree(model), _torch_batch(b))
    loss.backward()
    got = _flat(transformer.stack_layers(tree_map(
        lambda p: p.grad, transformer.param_tree(model))))
    leaves = MLA_LEAVES + (QLORA_LEAVES if name == "qlora" else
                           ["blocks.attn.wq"])
    assert set(leaves) <= set(want)
    f32 = dtype == "float32"
    assert _rel(loss, want_loss) <= (LOSS_RTOL if f32 else BF16_LOSS_RTOL)
    assert float(metrics["aux"]) == 0.0
    _leaf_close(got, want, GRAD_TOL if f32 else BF16_GRAD_TOL)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_training_reads_the_unrounded_latent(ref, built, monkeypatch,
                                             remat):
    """The trap of `mla_latent`: the reference's serve program reads
    k_nope from c_kv before its last rounding; so does its training
    program. With trained norm scales (kv_norm drawn in [0.5, 1.5], so
    the last product rounds) the port's bf16 loss is within
    BF16_LOSS_RTOL of the reference's (measured 3.7e-5) and closer than
    a port whose k_nope reads the rounded c_kv (2.1e-4), whose gradients
    also part further (1.75e-2 of a leaf's max against 1.27e-2)."""
    _, rcfg, rparams = built("reduced", "bfloat16")
    cfg = _cut("reduced").replace(dtype="bfloat16")
    rparams = {**rparams, "blocks": {**rparams["blocks"], "attn": {
        **rparams["blocks"]["attn"], "kv_norm": np.random.default_rng(
            1).uniform(0.5, 1.5, rparams["blocks"]["attn"]["kv_norm"].shape
                       ).astype(np.float32)}}}
    b = _batch(cfg)
    want, _ = ref.transformer.lm_loss(
        rparams, {k: ref.jnp.asarray(v) for k, v in b.items()}, rcfg,
        ref.ShardCtx(remat=remat))
    gaps = {}
    latent = att.mla_latent
    for form in ("port", "rounded"):
        if form == "rounded":
            monkeypatch.setattr(att, "mla_latent", lambda p, x, c, pos: (
                latent(p, x, c, pos)[0].to(x.dtype).float(),
                latent(p, x, c, pos)[1]))
        loss, _ = registry.loss_fn(cfg, remat)(
            transformer.param_tree(_model(cfg, rparams)), _torch_batch(b))
        gaps[form] = _rel(loss, want)
    assert gaps["port"] <= BF16_LOSS_RTOL
    assert gaps["port"] < gaps["rounded"], gaps


def test_cast_params_dtypes_match_reference(ref, built):
    """`cast_params` on the per-layer tree casts the leaves the
    reference's `_cast_params` casts on its stacked tree: every block
    leaf (the norms' vectors q_norm and kv_norm [L, r] among them) in
    bf16, `final_norm` in f32."""
    cfg, _, rparams = built("qlora", "bfloat16")
    want = ref.jax.tree.map(lambda a: str(a.dtype), ref.transformer
                            ._cast_params(ref.jax.tree.map(
                                ref.jnp.asarray, rparams),
                                ref.jnp.bfloat16))
    cast = transformer.cast_params(transformer.param_tree(_model(
        cfg, rparams)), torch.bfloat16)

    def names(tree):
        return tree_map(lambda t: str(t.dtype).replace("torch.", ""), tree)
    layers = [names(blk) for blk in cast.pop("blocks")]
    assert all(layer == layers[0] for layer in layers)
    got = {**names(cast), "blocks": layers[0]}
    assert got == want
    assert got["blocks"]["attn"]["q_norm"] == \
        got["blocks"]["attn"]["kv_norm"] == "bfloat16"
    assert got["final_norm"] == "float32"


@pytest.mark.parametrize("name", CFGS)
def test_dots_remat_saves_the_references_products(built, name):
    """Under "dots" the port saves the products without batch dims that
    the reference's `dots_with_no_batch_dims_saveable` saves in an MLA
    layer: the q-LoRA pair (or wq), wkv_a, the f32 k_nope product, v's
    product and wo, beside the MLP's three and nothing else (flash's
    products have batch dims: recomputed)."""
    cfg, _, rparams = built(name)
    model = _model(cfg, rparams)
    pc = transformer.cast_params(transformer.param_tree(model),
                                 torch.float32)
    saved = []
    policy = transformer._dots_policy

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and out == \
                transformer.CheckpointPolicy.MUST_SAVE:
            saved.append(tuple(args[1].shape))
        return out
    transformer._dots_policy = spy
    try:
        x = pc["embed"][_torch_batch(_batch(cfg, batch=2, seq=8))["tokens"]]
        layer = transformer.maybe_remat(lambda blk, h: transformer.DenseBlock
                                        .run(blk, h, torch.arange(8), cfg),
                                        "dots")
        layer(pc["blocks"][0], x).sum().backward()
    finally:
        transformer._dots_policy = policy
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    nd, rd, vd, R = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    q = [(d, m.q_lora_rank), (m.q_lora_rank, H * (nd + rd))] \
        if m.q_lora_rank else [(d, H * (nd + rd))]
    want = q + [(d, R + rd), (R, H * nd), (R, H * vd), (H * vd, d),
                (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
    assert sorted(saved) == sorted(want)


# ----------------------------------------------------------------------
# the Trainer, checkpoints, the launcher
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_pod_trainer_matches_reference(ref, built, from_reference, dtype):
    """The reference's and the port's Trainer on one pod (psum, 8 steps,
    lr 1e-3, warm-up 2) from the reference's init, on the qlora config:
    the same steps, no events, every step's loss; in f32 also the final
    parameters."""
    cfg, rcfg, rparams = built("qlora", dtype)
    dcfg = dict(batch=4, seq=32, vocab=cfg.vocab)
    rtr = ref.loop.Trainer(rcfg, ref.compat.make_mesh((1,), ("data",)),
                           ref.pipeline.DataConfig(**dcfg),
                           ref.loop.LoopConfig(steps=8, sync="psum"),
                           opt=ref.opt.AdamWConfig(**TRAIN_KW))
    rp, _ = rtr.run(ref.jax.random.key(0))
    from_reference(rparams)
    tr = Trainer(cfg, 1, pipeline.DataConfig(**dcfg),
                 LoopConfig(steps=8, sync="psum"),
                 opt=optimizer.AdamWConfig(**TRAIN_KW), device="cpu")
    params, state = tr.run(0)
    assert [h["step"] for h in tr.history] == list(range(8))
    assert tr.events == rtr.events == []
    tol = TRAIN_RTOL if dtype == "float32" else MLA_BF16_LOSS_RTOL
    for got, want in zip(tr.history, rtr.history):
        assert _rel(got["loss"], want["loss"]) <= tol, (got, want)
    assert int(state["step"]) == 8 and "wq_b" in state["m"]["blocks"]["attn"]
    if dtype == "float32":
        got, want = _flat(params), _flat(ref.jax.tree.map(np.asarray, rp))
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=0,
                                       atol=PARAM_LR_TOL * TRAIN_KW["lr"],
                                       err_msg=path)


def _ref_trainer(ref, ckpt_dir, steps):
    rcfg = ref.reduced(ref.config(ARCH))
    return ref.loop.Trainer(
        rcfg, ref.compat.make_mesh((1,), ("data",)),
        ref.pipeline.DataConfig(batch=4, seq=32, vocab=rcfg.vocab),
        ref.loop.LoopConfig(steps=steps, ckpt_dir=str(ckpt_dir),
                            ckpt_every=3, sync="psum"))


def _port_trainer(ckpt_dir, steps):
    cfg = reduced(get_config(ARCH))
    return Trainer(cfg, 1, pipeline.DataConfig(batch=4, seq=32,
                                               vocab=cfg.vocab),
                   LoopConfig(steps=steps, ckpt_dir=str(ckpt_dir),
                              ckpt_every=3, sync="psum"), device="cpu")


def test_mla_checkpoints_restore_across_the_packages(ref, tmp_path):
    """The reference's MLA Trainer (bf16) writes step 3; the port's
    restores it bit for bit (`['p']['blocks']['attn']['wkv_b']` and the
    norms' moments among the leaves), trains on and writes step 6; the
    reference's restores that bit for bit and trains on."""
    rparams, rstate = _ref_trainer(ref, tmp_path, 3).run(
        ref.jax.random.key(0))
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    assert {"['p']['blocks']['attn']['wkv_b']",
            "['o']['m']['blocks']['attn']['kv_norm']",
            "['o']['v']['blocks']['attn']['wkv_a']"} <= \
        set(manifest["leaves"])
    params, state, start = _port_trainer(tmp_path, 6).restore_or_init(0)
    assert start == 3
    _assert_same({"p": params, "o": state}, {"p": rparams, "o": rstate})
    tr = _port_trainer(tmp_path, 6)
    params, state = tr.run(0)
    assert tr.events == ["restored step 3"]
    assert [h["step"] for h in tr.history] == [3, 4, 5]
    _assert_same(ref.ckpt.restore(str(tmp_path), {"p": rparams,
                                                  "o": rstate}, step=6),
                 {"p": params, "o": state})
    rtr = _ref_trainer(ref, tmp_path, 7)
    rtr.run(ref.jax.random.key(0))
    assert rtr.events == ["restored step 6"]
    assert [h["step"] for h in rtr.history] == [6]


def test_train_cli_trains_mla_on_host(capsys):
    """`--arch minicpm3-4b --reduced --device cpu` trains through the
    launcher on the host: one pod, and four pods with skew, the
    compressed WANify sync and the control plane's forest."""
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "[train] step     1 loss" in out and "events: []" in out
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "4", "--seq", "16",
                    "--pods", "4", "--skew", "0.5", "--compress"])
    out = capsys.readouterr().out
    assert "WanPlan conns=" in out and "[train] step     1 loss" in out


def test_mla_in_moe_and_hybrid_still_refuse_training():
    """Dense MLA trains; MoE with MLA and MLA in the hybrid family still
    raise "not yet ported" at `loss_fn`."""
    assert callable(registry.loss_fn(_cut("reduced"), remat="dots"))
    mla = _cut("reduced").mla
    for arch in ("granite-moe-1b-a400m", "zamba2-2.7b"):
        bad = reduced(get_config(arch)).replace(mla=mla)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            registry.loss_fn(bad)


# ----------------------------------------------------------------------
# card-only: the backward kernels and MLA's gradients on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _chip_smoke():
    """`chip_smoke.py`, whose `check_flash_bwd_mla` holds the kernels
    to their plain version under the card's flash rule."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


# (B, H, S, nd, rd, Dv): the train shape (minicpm3-4b at B = 4, S =
# 1,024), ragged tiles (S 1, 127, 129, 130, 1,000), the qlora and reduced
# configs' dims, Dv below 64
CARD_CASES = [(4, 40, 1024, 64, 32, 64), (4, 40, 1000, 64, 32, 64),
              (1, 3, 130, 64, 32, 64), (2, 2, 200, 32, 16, 32),
              (1, 2, 300, 64, 32, 16), (1, 1, 1, 64, 32, 64),
              (1, 2, 127, 64, 32, 64), (1, 2, 129, 64, 32, 64),
              (2, 4, 40, 16, 8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    (case, dtype) for case in CARD_CASES
    for dtype in ("bfloat16", "float32")])
def test_card_bwd_kernels_match_plain(card, case, dtype):
    """`ops.flash_bwd_mla` on the card (q_nope, k_nope and g strided
    views) against its plain version on the same inputs, through
    `chip_smoke.check_flash_bwd_mla`: every output within the flash rule
    of its run's dtype, dk_rope bit-equal to the plain head sum of the
    kernel's own dk, two calls with the same bits, one launch a call, no
    copy."""
    parts, g = _mla_parts(np.random.default_rng(sum(case)), *case, dtype)
    parts, g = [t.to(card) for t in parts], g.to(card)
    out, lse = ops.flash_fwd_mla(*parts)
    before = (ops.flash_bwd.launches, ops.flash_fwd.copies)
    report = _chip_smoke().check_flash_bwd_mla(
        (g, *parts, out, lse))
    assert (ops.flash_bwd.launches, ops.flash_fwd.copies) == \
        (before[0] + 2, before[1])
    assert report["equal_bits"]


@pytest.mark.cuda
def test_card_refuses_what_the_bwd_kernel_does_not_take(card):
    """The parts' rule (nope 64, rope 32, v 64) on the backward too, and
    the dense backward's Dq == Dv; no launch."""
    before = ops.flash_bwd.launches
    for dims, words in (((80, 32, 64), "nd = 80"), ((64, 32, 80), "Dv = 80"),
                        ((64, 48, 64), "rd = 48")):
        parts, g = _mla_parts(np.random.default_rng(1), 1, 2, 64, *dims,
                              "bfloat16")
        parts, g = [t.to(card) for t in parts], g.to(card)
        out, lse = flash_fwd_mla_ref(*[t.cpu() for t in parts], 512)
        with pytest.raises(ValueError, match=words):
            ops.flash_bwd_mla(g, *parts, out.to(card), lse.to(card))
    q = torch.zeros((1, 2, 1, 64, 96), dtype=torch.bfloat16, device=card)
    v = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16, device=card)
    out = torch.zeros((1, 2, 1, 64, 64), dtype=torch.bfloat16, device=card)
    lse = torch.zeros((1, 2, 1, 64), device=card)
    with pytest.raises(ValueError, match="Dq == Dv"):
        ops.flash_bwd(out, q, q[:, :, 0], v, out, lse)
    assert ops.flash_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("remat", REMATS)
def test_mla_grads_on_card_match_host(card, remat):
    """The qlora config in f32, cut to 2 layers: the loss's gradients
    through the kernels on the card (flash's MLA forward and backward,
    the gate and its backward) against the plain versions on the host,
    from the same weights and batch, every leaf within CARD_TOL of its
    max |g|."""
    cfg = _cut("qlora").replace(dtype="float32")
    host = registry.build_model(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    b = _batch(cfg, batch=2, seq=64)
    grads = {}
    for dev in ("cpu", card):
        tree = tree_map(lambda t: t.detach().to(dev).requires_grad_(),
                        transformer.param_tree(host))
        loss, _ = registry.loss_fn(cfg, remat)(
            tree, {k: v.to(dev) for k, v in _torch_batch(b).items()})
        loss.backward()
        grads[str(dev)] = _flat(transformer.stack_layers(tree_map(
            lambda t: t.grad.cpu(), tree)))
    assert set(MLA_LEAVES + QLORA_LEAVES) <= set(grads["cpu"])
    _leaf_close(grads[str(card)], grads["cpu"], CARD_TOL)
