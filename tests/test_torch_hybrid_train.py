"""The port's training of the hybrid family (`zamba2-2.7b`) against the
JAX reference, on the CPU: `reduced(get_config("zamba2-2.7b"))`, 4
Mamba-2 layers and the shared attention + MLP block before layers 0 and
2, the reference's parameters carried across by
`load_reference_params`, inputs made with numpy from a seed. The
reference's `lm_loss` and `Trainer` run as `tests/test_torch_train.py`
runs them; its 4-pod WANify run is a case of that file's
`test_four_pod_wanify_trainer_matches_reference`.

The shared block's one set of parameters runs at every application, so
its gradient is a sum over them. The reference closes over
`params["shared_attn"]` in its scan body, and its scan's transpose adds
each application's cotangent into a carry in the compute dtype, the
last application first. The port passes the block's cast tensors into
each layer's remat region as arguments, and autograd adds the
applications' gradients at each cast tensor in the order the backward
reaches them: the same order, in the same dtype.

Tolerances:
- f32: the loss within LOSS_RTOL (1e-5) relative and every gradient
  leaf, the shared block's included, within GRAD_TOL (1e-4) of its max
  |g| under each remat (measured: the loss 2.1e-7, the leaves 4.2e-6,
  `blocks.ssm.A_log`; the shared leaves 1.4e-6-3.5e-6).
- bf16 (the config's own dtype): every leaf within BF16_GRAD_TOL
  (5e-2) of its max |g| and the loss within BF16_LOSS_RTOL (1e-3).
  Measured on the test's inputs: 2.54e-2 (`shared_attn.mlp.w3`; the
  other leaves up to 2.31e-2, `embed`) and the loss 8.0e-5; over 3
  inits x 3 batches at most 3.44e-2 (`shared_attn.attn.wk`; the other
  leaves up to 2.78e-2) and the loss 2.2e-4. That is the bf16 floor of
  the other families (`tests/test_torch_train.py`: up to 2.3e-2 of a
  leaf's max, XLA's whole-program roundings), not the sum: where the
  applications' own cotangents are equal, the sums are bit-equal
  (`test_shared_gradient_sums_in_the_references_order`), and summed
  first application first they differ in half the elements.
- the 1-pod Trainer (8 steps, lr 1e-3): f32 losses within TRAIN_RTOL
  (1e-4; measured 1.7e-6) and the final parameters within PARAM_LR_TOL
  (0.5) lr of the reference's (measured 0.135 lr, `shared_attn.mlp.w1`:
  an element whose gradient is near 0 can take AdamW's step the other
  way); bf16 losses within HYBRID_BF16_LOSS_RTOL (2e-3; measured
  1.04e-3 at step 8, where `mamba2-2.7b` parts by 4.5e-4: the first
  step's 9.7e-5 is the rounding floor above, and AdamW turns it into
  lr-sized parameter differences).
- the card against the host (`cuda` cases, f32): within 1e-3 of each
  leaf's max |g|.

Card-only cases (marked `cuda`) import no jax:
``python -m pytest -q -m cuda tests/test_torch_hybrid_train.py``.
"""
import json
import types

import numpy as np
import pytest
import torch

from test_torch_checkpoint import _assert_same
from test_torch_train import (GRAD_TOL, LOSS_RTOL, TRAIN_RTOL, _batch, _flat,
                              _leaf_close, _rel, _torch_batch)
from repro_torch.compat import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data import pipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import registry, transformer
from repro_torch.train import optimizer
from repro_torch.train.loop import LoopConfig, Trainer

ARCH = "zamba2-2.7b"
REMATS = ["none", "full", "dots"]
BF16_GRAD_TOL = 5e-2        # of each leaf's max |g|
BF16_LOSS_RTOL = 1e-3
HYBRID_BF16_LOSS_RTOL = 2e-3
PARAM_LR_TOL = 0.5          # of lr, the 1-pod Trainer's final parameters
CARD_TOL = 1e-3             # of each leaf's max |g|, card vs host
ORDER_LAYERS = 18           # the block before 0, 2, ..., 16: 9 times
TRAIN_KW = dict(lr=1e-3, warmup_steps=2, total_steps=8)
SHARED_LEAVES = ["shared_attn.attn.wk", "shared_attn.attn.wo",
                 "shared_attn.attn.wq", "shared_attn.attn.wv",
                 "shared_attn.ln1", "shared_attn.ln2", "shared_attn.mlp.w1",
                 "shared_attn.mlp.w2", "shared_attn.mlp.w3"]


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
    from repro.models import registry as ref_registry
    from repro.models import transformer as ref_transformer
    from repro.models.layers import ShardCtx
    from repro.train import loop as ref_loop
    from repro.train import optimizer as ref_opt
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, compat=compat, ckpt=ref_ckpt, config=ref_config,
        reduced=ref_reduced, pipeline=ref_pipeline, registry=ref_registry,
        transformer=ref_transformer, ShardCtx=ShardCtx, loop=ref_loop,
        opt=ref_opt)


@pytest.fixture(scope="module")
def built(ref):
    """dtype -> (port cfg, ref cfg, ref params as numpy), once a module."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cfg = reduced(get_config(ARCH)).replace(dtype=dtype)
            rcfg = ref.reduced(ref.config(ARCH)).replace(dtype=dtype)
            rparams = ref.jax.tree.map(np.asarray, ref.registry.init_params(
                rcfg, ref.jax.random.key(0)))
            cache[dtype] = (cfg, rcfg, rparams)
        return cache[dtype]
    return get


def _model(cfg, rparams):
    """The port's hybrid holding the reference's parameters, training."""
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
# the loss and its gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", REMATS)
def test_lm_loss_and_grads_match_reference(ref, built, remat, dtype):
    """`registry.loss_fn` and torch.autograd against jax.value_and_grad
    of the reference's `lm_loss` under the same remat: the loss and
    every gradient leaf, the nine `shared_attn` leaves included, in the
    reference's stacked layout."""
    cfg, rcfg, rparams = built(dtype)
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
    assert set(SHARED_LEAVES) <= set(want)
    f32 = dtype == "float32"
    assert _rel(loss, want_loss) <= (LOSS_RTOL if f32 else BF16_LOSS_RTOL)
    assert float(metrics["aux"]) == 0.0
    _leaf_close(got, want, GRAD_TOL if f32 else BF16_GRAD_TOL)


def test_shared_gradient_sums_in_the_references_order(ref, monkeypatch):
    """The shared block's bf16 gradient is the sum of its applications'
    in the reference's order. Both packages' real `lm_backbone` (scan,
    `lax.cond` and `jax.checkpoint` there; remat regions with the block
    as an argument here), with the layers swapped for exact ones: the
    block adds `p @ wq` and `(p @ w1)[..., :d]` for a constant one-token
    probe p, a Mamba-2 layer scales by its bf16 `ln1`, the final norm is
    the identity. Then each application's cotangent is the output's
    times the scales after it, and its weight gradient a product of two
    bf16 values, both rounded once, equal in the two packages, so only
    the sum's order and dtype remain. Nine applications (18 layers):
    bit-equal to the reference under each remat, equal to the bf16 sum
    taken last application first, and the control: taken first
    application first, the sum differs in many elements."""
    cfg = reduced(get_config(ARCH)).replace(n_layers=ORDER_LAYERS)
    rcfg = ref.reduced(ref.config(ARCH)).replace(n_layers=ORDER_LAYERS)
    d, L = cfg.d_model, cfg.n_layers
    flags = transformer.shared_flags(cfg)
    assert sum(flags) == 9
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16

    def rounded(a):
        return torch.from_numpy(a.astype(np.float32)).to(bf16).float().numpy()
    p, G = (rounded(rng.standard_normal((1, 1, d))) for _ in range(2))
    ln1 = rounded(rng.uniform(0.5, 1.5, (L, d)))
    wq = (rng.standard_normal((d, d)) * 0.1).astype(np.float32)
    w1 = (rng.standard_normal((d, cfg.d_ff)) * 0.1).astype(np.float32)
    jnp = ref.jnp

    def ref_shared(blk, x, positions, cfg, ctx, dp_size=1):
        pp = jnp.asarray(p).astype(x.dtype)
        y = x + pp @ blk["attn"]["wq"] + (pp @ blk["mlp"]["w1"])[..., :d]
        return y, jnp.zeros((), jnp.float32), jnp.zeros((1,), jnp.float32)

    def port_shared(blk, x, positions, cfg):
        pp = torch.from_numpy(p).to(x.dtype)
        return x + pp @ blk["attn"]["wq"] + (pp @ blk["mlp"]["w1"])[..., :d]
    monkeypatch.setattr(ref.transformer, "_ssm_block",
                        lambda blk, x, cfg, ctx: x * blk["ln1"])
    monkeypatch.setattr(ref.transformer, "_attn_mlp_block", ref_shared)
    monkeypatch.setattr(ref.transformer, "rms_norm", lambda x, w, eps: x)
    monkeypatch.setattr(transformer.MambaBlock, "run", staticmethod(
        lambda blk, x, positions, cfg: x * blk["ln1"]))
    monkeypatch.setattr(transformer.DenseBlock, "run",
                        staticmethod(port_shared))
    monkeypatch.setattr(transformer, "rms_norm", lambda x, w, eps: x)
    for remat in REMATS:
        rp = {"final_norm": jnp.ones((d,), jnp.float32),
              "blocks": {"ln1": jnp.asarray(ln1)},
              "shared_attn": {"attn": {"wq": jnp.asarray(wq)},
                              "mlp": {"w1": jnp.asarray(w1)}}}
        _, vjp = ref.jax.vjp(lambda t: ref.transformer.lm_backbone(
            ref.transformer._cast_params(t, jnp.bfloat16),
            jnp.zeros((1, 1, d), jnp.bfloat16), jnp.arange(1), rcfg,
            ref.ShardCtx(remat=remat))[0], rp)
        want = _flat(ref.jax.tree.map(np.asarray, vjp(
            jnp.asarray(G).astype(jnp.bfloat16))[0]))
        tp = {"final_norm": torch.ones(d),
              "blocks": [{"ln1": torch.from_numpy(ln1[i])} for i in range(L)],
              "shared_attn": {"attn": {"wq": torch.from_numpy(wq)},
                              "mlp": {"w1": torch.from_numpy(w1)}}}
        tp = tree_map(lambda t: t.clone().requires_grad_(), tp)
        h, _, _ = transformer.lm_backbone(
            transformer.cast_params(tp, bf16), torch.zeros((1, 1, d),
                                                           dtype=bf16),
            torch.arange(1), cfg, remat)
        h.backward(torch.from_numpy(G).to(bf16))
        got = {"shared_attn.attn.wq": tp["shared_attn"]["attn"]["wq"].grad,
               "shared_attn.mlp.w1": tp["shared_attn"]["mlp"]["w1"].grad,
               "blocks.ln1": torch.stack([b["ln1"].grad
                                          for b in tp["blocks"]])}
        got = {k: v.numpy() for k, v in got.items()}
        for path in ("shared_attn.attn.wq", "shared_attn.mlp.w1",
                     "blocks.ln1"):
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=f"{remat} {path}")
    # each application's wq gradient: the probe times its cotangent
    per, g = {}, torch.from_numpy(G[0, 0]).to(bf16)
    for i in reversed(range(L)):
        g = g * torch.from_numpy(ln1[i]).to(bf16)
        if flags[i]:
            per[i] = torch.from_numpy(p[0, 0]).to(bf16)[:, None] * g[None]

    def bf16_sum(order):
        s = None
        for i in order:
            s = per[i] if s is None else s + per[i]
        return s.float().numpy()
    apps = [i for i in range(L) if flags[i]]
    np.testing.assert_array_equal(got["shared_attn.attn.wq"],
                                  bf16_sum(reversed(apps)))
    assert (bf16_sum(apps) != bf16_sum(reversed(apps))).mean() > 0.1


def test_cast_params_dtypes_match_reference(ref, built):
    """`cast_params` on the per-layer tree casts the leaves the
    reference's `_cast_params` casts on its stacked tree: every block
    leaf and matrix in bf16, `final_norm` and the shared block's `ln1` /
    `ln2` [d] in f32."""
    cfg, _, rparams = built("bfloat16")
    want = ref.jax.tree.map(lambda a: str(a.dtype), ref.transformer
                            ._cast_params(ref.jax.tree.map(
                                ref.jnp.asarray, rparams),
                                ref.jnp.bfloat16))
    cast = transformer.cast_params(transformer.param_tree(_model(
        cfg, rparams)), torch.bfloat16)
    def names(tree):
        return tree_map(lambda t: str(t.dtype).replace("torch.", ""), tree)
    layers = [names(b) for b in cast.pop("blocks")]
    assert all(layer == layers[0] for layer in layers)
    got = {**names(cast), "blocks": layers[0]}
    assert got == want
    assert got["shared_attn"]["ln1"] == got["shared_attn"]["ln2"] == \
        got["final_norm"] == "float32"
    assert got["shared_attn"]["mlp"]["w1"] == got["blocks"]["ln1"] == \
        "bfloat16"


def test_stack_layers_and_layer_views_carry_the_shared_block(ref, built):
    """`stack_layers(param_tree(model))` is the reference's layout (the
    same paths and shapes: blocks [L, ...], `shared_attn` unstacked, as
    the module holds it), and `layer_views` gives back the per-layer
    tree: block views of the stacked leaves, the shared subtree the
    stacked tree's own tensors."""
    cfg, _, rparams = built("float32")
    model = _model(cfg, rparams)
    tree = transformer.param_tree(model)
    assert set(tree["shared_attn"]) == {"ln1", "attn", "ln2", "mlp"}
    stacked = transformer.stack_layers(tree)
    shapes = {k: v.shape for k, v in _flat(stacked).items()}
    assert shapes == {k: v.shape for k, v in _flat(rparams).items()}
    for path, p in _flat(tree["shared_attn"], "shared_attn.").items():
        np.testing.assert_array_equal(_flat(stacked)[path], p)
    views = transformer.layer_views(stacked)
    assert views.keys() == tree.keys()
    for a, b in zip(tree_leaves(views["shared_attn"]),
                    tree_leaves(stacked["shared_attn"])):
        assert a is b and not a.requires_grad
    for i, blk in enumerate(model.blocks):
        for (name, p), v in zip(blk.named_parameters(),
                                tree_leaves(views["blocks"][i])):
            assert v._base is not None and torch.equal(v, p), name
    again = transformer.stack_layers(views)
    for a, b in zip(tree_leaves(again), tree_leaves(stacked)):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the Trainer, checkpoints, the launcher
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_pod_trainer_matches_reference(ref, built, from_reference, dtype):
    """The reference's and the port's Trainer on one pod (psum, 8 steps,
    lr 1e-3, warm-up 2) from the reference's init: the same steps, no
    events, every step's loss; in f32 also the final parameters, the
    shared block's included."""
    cfg, rcfg, rparams = built(dtype)
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
    tol = TRAIN_RTOL if dtype == "float32" else HYBRID_BF16_LOSS_RTOL
    for got, want in zip(tr.history, rtr.history):
        assert _rel(got["loss"], want["loss"]) <= tol, (got, want)
    assert int(state["step"]) == 8 and "shared_attn" in state["m"]
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


def test_hybrid_checkpoints_restore_across_the_packages(ref, tmp_path):
    """The reference's hybrid Trainer writes step 3; the port's restores
    it bit for bit (`['p']['shared_attn'][...]` and its moments among
    the leaves), trains on and writes step 6; the reference's restores
    that bit for bit and trains on."""
    rparams, rstate = _ref_trainer(ref, tmp_path, 3).run(
        ref.jax.random.key(0))
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    assert {"['p']['shared_attn']['attn']['wq']",
            "['o']['m']['shared_attn']['ln1']"} <= set(manifest["leaves"])
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


def test_train_cli_trains_the_hybrid_on_host(capsys):
    """`--arch zamba2-2.7b` trains through the launcher on the host: one
    pod, and four pods with skew, the compressed WANify sync and the
    control plane's forest."""
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "[train] step     1 loss" in out and "events: []" in out
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "4", "--seq", "16",
                    "--pods", "4", "--skew", "0.5", "--compress"])
    out = capsys.readouterr().out
    assert "WanPlan conns=" in out and "[train] step     1 loss" in out


# ----------------------------------------------------------------------
# card-only: the hybrid's gradients through the kernels
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("remat", REMATS)
def test_hybrid_grads_on_card_match_host(card, remat):
    """A reduced hybrid cut to 3 layers (the shared block before layers 0
    and 2) in f32: the loss's gradients through the kernels on the card
    (`ssd_chunk`, the SiLUs, flash and their backwards) against the
    plain versions on the host, from the same weights and batch, every
    leaf within CARD_TOL of its max |g|, the shared block's included."""
    cfg = reduced(get_config(ARCH)).replace(n_layers=3, dtype="float32")
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
    assert set(SHARED_LEAVES) <= set(grads["cpu"])
    _leaf_close(grads[str(card)], grads["cpu"], CARD_TOL)
