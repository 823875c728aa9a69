"""The port's training path against the JAX reference, on the CPU:
`reduced(get_config(arch))` of the dense family (`llama3-8b`,
`qwen3-4b`, `h2o-danube-1.8b`: 2 layers, d_model 128, vocab 512) and
of the ssm family (`mamba2-2.7b`: 4 layers, d_model 128, 16 heads of
16, d_state 16, chunks of 16), the reference's parameters carried
across by `load_reference_params`, inputs made with numpy from a seed.
The ssm family's three kernel calls train through their backwards'
plain versions (`ssd_chunk_bwd`, `silu_bwd`, `silu_gate_prod_bwd`;
`tests/test_torch_ssm_train.py` holds each on its own).

Tolerances:
- f32 (`dtype="float32"`): the losses within 1e-5 relative; every
  gradient leaf within 1e-4 of its max |g|; the flash VJP within 1e-5;
  the SwiGLU gate's backward within 1e-6 of the largest |grad| (XLA's
  exp and the host's differ in the last bit); `lr_at`, `global_norm`
  and `adamw_update` within 1e-6 relative on equal gradients; the
  Trainers' losses within 1e-4 relative step by step (measured 1.3e-6
  on the 8-step run; 7.1e-7 for `mamba2-2.7b`), the 4-pod WANify run's
  within FOUR_POD_F32_RTOL,
  5e-7 (measured 7.1e-8, one f32 ulp of the loss; with the sync's
  compression dropped the port parts by 1.7e-6, which the control
  test holds above the bound), and its events and plans identical.
- bf16 (the configs' own dtype): the gate's backward is bit-equal to
  `jax.vjp` of the reference's `silu(z) * y` (the roundings of XLA's
  compiled program, `csrc/silu.cu`'s head comment). A whole model's
  bf16 gradients part from the reference's in 60-85% of their elements,
  by up to 2.3e-2 of a leaf's max (`tests/torch_bf16_gap.py`): op by
  op only `rms_norm`'s backward differs (XLA's CPU program sums its
  bf16 reductions with a bf16 rounding after every add, torch in f32),
  but XLA's whole-model program rounds otherwise than its ops alone
  (ln2's variance of the unrounded residual sum, among others), and
  the loss already parts by 1.7e-5 at the 4-pod run's first step.
  AdamW's first steps move each parameter by about lr times its
  gradient's sign, so any such difference becomes lr-sized parameter
  differences. The bf16 Trainer runs are held to identical events and
  plans and to losses within FOUR_POD_BF16_RTOL, 4e-4 (measured
  1.9e-4), and BF16_LOSS_RTOL, 1e-3, on the 8-step run at lr 1e-3
  (measured 4.4e-4; 4.5e-4 for `mamba2-2.7b`). At that level a bf16 run cannot tell a fault
  from the rounding (an unrounded gate, an f32 rms_norm value path
  and an uncompressed sync measure 1.6e-4-2.3e-4 on the 4-pod run):
  rounding is held by the bit-equal op tests, the run by f32.

The reference's 4-pod Trainer runs in a subprocess with 4 host
devices, as `tests/test_system.py` runs its multi-pod script; those
runs are `tests/test_torch_train_pods.py`, and the 8-step psum
histories `tests/test_torch_train_history.py` (files of their own, so
that the test workers share the suite's longest runs).
"""
import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.compat import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.configs.base import MLAConfig, reduced
from repro_torch.core.predictor import BwPredictor
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as att
from repro_torch.models import layers, registry, transformer
from repro_torch.train import optimizer
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.train_step import (_grads_of, broadcast_to_pods,
                                          make_train_step, strip_pods)
from repro_torch.wan.dataset import train_default_forest
from repro_torch.wan.simulator import WanSimulator

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ["llama3-8b", "qwen3-4b", "h2o-danube-1.8b"]
SSM_ARCH = "mamba2-2.7b"
HYBRID_ARCH = "zamba2-2.7b"
TRAIN_ARCHS = ARCHS + [SSM_ARCH]
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4             # of each leaf's max |g|
OPT_RTOL = 1e-6
TRAIN_RTOL = 1e-4
FOUR_POD_F32_RTOL = 5e-7
FOUR_POD_BF16_RTOL = 4e-4
BF16_LOSS_RTOL = 1e-3
DEADLINE = 600


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's model, optimizer, data and train modules."""
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.configs import get_config as ref_config
    from repro.configs.base import reduced as ref_reduced
    from repro.data import pipeline as ref_pipeline
    from repro.models import attention as ref_att
    from repro.models import layers as ref_layers
    from repro.models import registry as ref_registry
    from repro.models import transformer as ref_transformer
    from repro.models.layers import ShardCtx
    from repro.train import loop as ref_loop
    from repro.train import optimizer as ref_opt
    from repro.train import train_step as ref_step
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, compat=compat, config=ref_config,
        reduced=ref_reduced, pipeline=ref_pipeline, att=ref_att,
        layers=ref_layers, registry=ref_registry,
        transformer=ref_transformer, ShardCtx=ShardCtx, loop=ref_loop,
        opt=ref_opt, step=ref_step)


def _configs(ref, arch, dtype):
    return (reduced(get_config(arch)).replace(dtype=dtype),
            ref.reduced(ref.config(arch)).replace(dtype=dtype))


@pytest.fixture(scope="module")
def built(ref):
    """(arch, dtype) -> (port cfg, ref cfg, ref params as numpy), built
    once per module."""
    cache = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in cache:
            cfg, rcfg = _configs(ref, arch, dtype)
            rparams = ref.jax.tree.map(np.asarray, ref.registry.init_params(
                rcfg, ref.jax.random.key(0)))
            cache[arch, dtype] = (cfg, rcfg, rparams)
        return cache[arch, dtype]
    return get


def _model(cfg, rparams):
    """The port's model holding the reference's parameters, training."""
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


def _flat(tree, prefix=""):
    """{path: f32 numpy} of a nested dict of tensors / arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().float().numpy() \
                if isinstance(v, torch.Tensor) else \
                np.asarray(v).astype(np.float32)
    return out


def _batch(cfg, batch=2, seq=32, seed=0):
    it = pipeline.batches(cfg, pipeline.DataConfig(
        batch=batch, seq=seq, vocab=cfg.vocab, seed=seed))
    return next(it)


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _rel(got, want) -> float:
    got = got.detach() if isinstance(got, torch.Tensor) else got
    return abs(float(got) - float(want)) / abs(float(want))


def _leaf_close(got: dict, want: dict, tol: float = GRAD_TOL) -> None:
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and np.isfinite(g).all(), path
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * np.abs(w).max(), err_msg=path)


# ----------------------------------------------------------------------
# cross-entropy
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["mean", "masked", "bf16"])
def test_softmax_xent_matches_reference(ref, case):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 37)) * 3).astype(np.float32)
    targets = rng.integers(0, 37, (3, 7)).astype(np.int32)
    mask = (rng.uniform(size=(3, 7)) > 0.3).astype(np.float32) \
        if case == "masked" else None
    dt = "bfloat16" if case == "bf16" else "float32"
    want = ref.layers.softmax_xent(
        ref.jnp.asarray(logits).astype(dt), ref.jnp.asarray(targets),
        None if mask is None else ref.jnp.asarray(mask))
    got = layers.softmax_xent(
        torch.from_numpy(logits).to(TDT[dt]), torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= LOSS_RTOL


@pytest.mark.parametrize("chunk", [8, 32, 7], ids=["chunked", "S<=chunk",
                                                  "S%chunk"])
def test_chunked_xent_and_grads_match_reference(ref, chunk):
    """Both branches: 4 rematerialised chunks of 8, and the fallback
    to `softmax_xent(h @ lm_head)`; the value and the gradients of h
    and lm_head."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 32, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 41)) * 0.5).astype(np.float32)
    tgt = rng.integers(0, 41, (2, 32)).astype(np.int32)
    f = ref.jax.value_and_grad(
        lambda a, b: ref.layers.chunked_xent(
            a, b, ref.jnp.asarray(tgt), ref.ShardCtx(), chunk=chunk),
        argnums=(0, 1))
    want, (dh, dw) = f(ref.jnp.asarray(h), ref.jnp.asarray(w))
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = layers.chunked_xent(ht, wt, torch.from_numpy(tgt), chunk=chunk)
    got.backward()
    assert _rel(got, want) <= LOSS_RTOL
    _leaf_close({"h": ht.grad.numpy(), "w": wt.grad.numpy()},
                {"h": np.asarray(dh), "w": np.asarray(dw)}, 1e-5)


# ----------------------------------------------------------------------
# the loss and its gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_lm_loss_matches_reference(ref, built, arch):
    cfg, rcfg, rparams = built(arch)
    b = _batch(cfg)
    want, wm = ref.transformer.lm_loss(
        rparams, {k: ref.jnp.asarray(v) for k, v in b.items()}, rcfg,
        ref.ShardCtx())
    with torch.no_grad():
        got, gm = registry.loss_fn(cfg)(
            transformer.param_tree(_model(cfg, rparams)), _torch_batch(b))
    assert _rel(got, want) <= LOSS_RTOL
    assert _rel(gm["ce"], wm["ce"]) <= LOSS_RTOL
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0
    np.testing.assert_array_equal(gm["expert_load"].numpy(),
                                  np.asarray(wm["expert_load"]))


@pytest.fixture(scope="module")
def ref_grads(ref, built):
    """arch -> (loss, {path: grad}) of the reference's jax.grad(lm_loss)
    in f32 on `_batch`, remat "full"."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, rcfg, rparams = built(arch)
            b = {k: ref.jnp.asarray(v) for k, v in _batch(cfg).items()}
            (loss, _), g = ref.jax.value_and_grad(
                lambda p: ref.transformer.lm_loss(p, b, rcfg,
                                                  ref.ShardCtx()),
                has_aux=True)(rparams)
            cache[arch] = (float(loss), _flat(ref.jax.tree.map(np.asarray,
                                                               g)))
        return cache[arch]
    return get


@pytest.mark.parametrize("remat", ["full", "none", "dots"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_lm_loss_grads_match_reference(ref, built, ref_grads, arch, remat):
    """torch.autograd through the port (flash's VJP, the gate's kernel
    backward's plain version, the KV-head expansion's sum, remat; for
    the ssm family the SSD chunk's, SiLU's and the gated norm's
    backwards' plain versions) against jax.grad of the reference: every
    leaf within 1e-4 of its max |g| (measured 6.5e-6 for `mamba2-2.7b`,
    its `dt_bias`)."""
    cfg, _, rparams = built(arch)
    want_loss, want = ref_grads(arch)
    model = _model(cfg, rparams)
    loss, _ = registry.loss_fn(cfg, remat)(transformer.param_tree(model),
                                           _torch_batch(_batch(cfg)))
    loss.backward()
    assert _rel(loss, want_loss) <= LOSS_RTOL
    got = _flat(transformer.stack_layers(tree_map(
        lambda p: p.grad, transformer.param_tree(model))))
    _leaf_close(got, want)


@pytest.mark.parametrize("window", [0, 12])
def test_flash_vjp_matches_reference(ref, window):
    """The custom VJP on its own: G = 2 query heads a KV head, 40 keys in
    blocks of 16 (the last padded and masked), with and without a
    window; the output and dq, dk, dv within 1e-5. The head dim is 16,
    the narrowest the flash wrappers take (a multiple of 16)."""
    rng = np.random.default_rng(2)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, 2, 2, 40, 16), (2, 2, 40, 16), (2, 2, 40, 16),
        (2, 2, 2, 40, 16)))
    out, vjp = ref.jax.vjp(
        lambda a, b, c: ref.att.flash_attention(
            a, b, c, causal=True, window=window, block_k=16),
        *(ref.jnp.asarray(a) for a in (q, k, v)))
    want = [out] + list(vjp(ref.jnp.asarray(g)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = att.flash_attention(*ts, window=window, block_k=16)
    got.backward(torch.from_numpy(g))
    for name, a, b in zip(("out", "dq", "dk", "dv"),
                          [got] + [t.grad for t in ts], want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_swa_banded_path_grads_match_reference(ref):
    """S > W: the banded path differentiates through its ops, as the
    reference's does (the card never reaches it at these prompts)."""
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in (
        (1, 2, 1, 64, 8), (1, 2, 64, 8), (1, 2, 64, 8), (1, 2, 1, 64, 8)))
    out, vjp = ref.jax.vjp(
        lambda a, b, c: ref.att.swa_attention(a, b, c, window=16),
        *(ref.jnp.asarray(a) for a in (q, k, v)))
    want = [out] + list(vjp(ref.jnp.asarray(g)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = att.swa_attention(*ts, window=16)
    got.backward(torch.from_numpy(g))
    for name, a, b in zip(("out", "dq", "dk", "dv"),
                          [got] + [t.grad for t in ts], want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_gate_backward_matches_reference(ref, dtype):
    """The gate's autograd (forward `silu_gate`, backward
    `silu_gate_bwd`'s plain version) against `jax.vjp` of the
    reference's `silu(z) * y` under jit: bf16 bit-equal, f32 within
    1e-6 of the largest |grad|."""
    rng = np.random.default_rng(4)
    z = (rng.standard_normal((64, 1024)) * 4).astype(np.float32)
    y, g = (rng.standard_normal((64, 1024)).astype(np.float32)
            for _ in range(2))
    jdt = ref.jnp.dtype(dtype)

    def vjp(z, y, g):
        _, f = ref.jax.vjp(lambda a, b: ref.jax.nn.silu(a) * b, z, y)
        return f(g)
    dz, dy = ref.jax.jit(vjp)(*(ref.jnp.asarray(a).astype(jdt)
                                for a in (z, y, g)))
    yt, zt = (torch.from_numpy(a).to(TDT[dtype]).requires_grad_()
              for a in (y, z))
    ops.swiglu_gate(yt, zt).backward(torch.from_numpy(g).to(TDT[dtype]))
    for got, want in ((yt.grad, dy), (zt.grad, dz)):
        assert got.dtype == TDT[dtype]
        got, want = got.float().numpy(), np.asarray(want.astype("float32"))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_grads_match_reference(ref, dtype):
    """The whole MLP, `swiglu(x, w1, w3, w2)`: the gradients of x and the
    three weights. f32 within 1e-6 of each one's max |g|; bf16 within
    one bf16 step (2^-7) of it (the products' sum order)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.125).astype(np.float32)
          for s in ((64, 96), (64, 96), (96, 64))]
    g = rng.standard_normal((2, 16, 64)).astype(np.float32)
    jdt = ref.jnp.dtype(dtype)
    _, f = ref.jax.vjp(lambda *a: ref.layers.swiglu(*a, ref.ShardCtx()),
                       *(ref.jnp.asarray(a).astype(jdt) for a in [x] + ws))
    want = f(ref.jnp.asarray(g).astype(jdt))
    ts = [torch.from_numpy(a).to(TDT[dtype]).requires_grad_()
          for a in [x] + ws]
    layers.swiglu(*ts).backward(torch.from_numpy(g).to(TDT[dtype]))
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for name, t, w in zip(("x", "w1", "w3", "w2"), ts, want):
        w = np.asarray(w.astype("float32"))
        np.testing.assert_allclose(t.grad.float().numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max(), err_msg=name)


# ----------------------------------------------------------------------
# the optimizer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 2, 50, 100, 101, 5000, 9999, 20000])
def test_lr_at_matches_reference(ref, step):
    c = optimizer.AdamWConfig()
    rc = ref.opt.AdamWConfig()
    want = ref.jax.jit(lambda s: ref.opt.lr_at(rc, s))(
        ref.jnp.int32(step))
    got = optimizer.lr_at(c, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= OPT_RTOL * abs(float(want)) \
        + 1e-12


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_on_equal_grads(ref, built, ref_grads,
                                                state_dtype):
    """Three AdamW steps of the reference's tree (its f32 gradients of
    `lm_loss`, fed to both, scaled so that step 2 clips): global norm,
    lr, the parameters and both moments within 1e-6 relative. With bf16
    moments, a moment whose f32 value lands within an f32 ulp of a bf16
    rounding tie may round the other way (2 of 65,536 in a leaf at step
    2): they are held within one bf16 step (2^-7 relative), and the
    parameters within 2^-6 lr of the reference's."""
    _, _, rparams = built("llama3-8b")
    _, flat_g = ref_grads("llama3-8b")
    rc = ref.opt.AdamWConfig(warmup_steps=2, total_steps=10,
                             state_dtype=state_dtype)
    c = optimizer.AdamWConfig(warmup_steps=2, total_steps=10,
                              state_dtype=state_dtype)

    def tree_of(flat, like, prefix=""):
        return {k: tree_of(flat, v, f"{prefix}{k}.") if isinstance(v, dict)
                else flat[prefix + k] for k, v in like.items()}

    gtree = tree_of(flat_g, rparams)
    rp = ref.jax.tree.map(ref.jnp.asarray, rparams)
    rstate = ref.opt.init_opt_state(rp)
    tp = tree_map(torch.from_numpy, ref.jax.tree.map(
        lambda a: np.array(a, np.float32), rparams))
    tstate = optimizer.init_opt_state(tp)
    upd = ref.jax.jit(lambda p, g, s: ref.opt.adamw_update(rc, p, g, s))
    for i, k in enumerate((1.0, 40.0, 0.5)):
        g = ref.jax.tree.map(lambda a: a * np.float32(k), gtree)
        rp, rstate, rom = upd(rp, ref.jax.tree.map(ref.jnp.asarray, g),
                              rstate)
        tp, tstate, tom = optimizer.adamw_update(
            c, tp, tree_map(torch.from_numpy, g), tstate)
        assert int(tstate["step"]) == int(rstate["step"]) == i + 1
        assert _rel(tom["grad_norm"], rom["grad_norm"]) <= OPT_RTOL
        assert _rel(tom["lr"], rom["lr"]) <= OPT_RTOL
        for name, got, want in (("p", tp, rp), ("m", tstate["m"],
                                                rstate["m"]),
                                ("v", tstate["v"], rstate["v"])):
            want = _flat(ref.jax.tree.map(np.asarray, want))
            got = _flat(got)
            bf16 = state_dtype == "bfloat16"
            rtol = 2.0 ** -7 if bf16 and name != "p" else OPT_RTOL
            for path, w in want.items():
                atol = OPT_RTOL * np.abs(w).max()
                if bf16 and name == "p":         # a moment one step off
                    atol = max(atol, 2.0 ** -6 * float(rom["lr"]))
                np.testing.assert_allclose(
                    got[path], w, rtol=rtol, atol=atol,
                    err_msg=f"step {i + 1} {name} {path}")


def test_global_norm_matches_reference(ref, built, ref_grads):
    _, _, rparams = built("qwen3-4b")
    _, flat_g = ref_grads("qwen3-4b")
    want = ref.opt.global_norm([ref.jnp.asarray(v) for v in flat_g.values()])
    got = optimizer.global_norm([torch.from_numpy(v)
                                 for v in flat_g.values()])
    assert _rel(got, want) <= OPT_RTOL


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_pods,skew", [(1, 0.0), (4, 0.0), (4, 0.5),
                                         (2, 0.9)])
def test_batches_bit_equal_and_skew_weights(ref, n_pods, skew):
    cfg, rcfg = _configs(ref, "h2o-danube-1.8b", "bfloat16")
    kw = dict(batch=8, seq=32, vocab=cfg.vocab, n_pods=n_pods, skew=skew,
              seed=3)
    got = pipeline.prefetch(pipeline.batches(cfg, pipeline.DataConfig(**kw)))
    want = ref.pipeline.batches(rcfg, ref.pipeline.DataConfig(**kw))
    for _ in range(4):
        g, w = next(got), next(want)
        assert set(g) == set(w) == {"tokens", "targets"}
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
        if n_pods > 1:
            np.testing.assert_allclose(
                pipeline.pod_skew_weights(g["tokens"], n_pods, cfg.vocab),
                ref.pipeline.pod_skew_weights(w["tokens"], n_pods,
                                              rcfg.vocab),
                rtol=0, atol=1e-12)


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
def test_microbatched_step_matches_reference(ref, built):
    """`make_train_step(microbatch=2)` (f32 accumulation, remat "full")
    against the reference's on one pod: the accumulated gradients within
    1e-4 of each leaf's max |g|, the out dict within 1e-5, and the
    updated parameters within 1e-6 relative wherever the gradient is
    clear of zero (elsewhere within 2 lr: a step moves an element by
    about lr times the sign of its gradient)."""
    cfg, rcfg, rparams = built("llama3-8b")
    b = _batch(cfg, batch=4)
    rb = {k: ref.jnp.asarray(v) for k, v in b.items()}
    rc, c = ref.opt.AdamWConfig(), optimizer.AdamWConfig()
    _, _, rgrads = ref.step._grads_of(rcfg, ref.ShardCtx(), 1, 2)(
        ref.jax.tree.map(ref.jnp.asarray, rparams), rb)
    rgrads = _flat(ref.jax.tree.map(np.asarray, rgrads))
    mesh = ref.compat.make_mesh((1,), ("data",))
    rstep = ref.step.make_train_step(rcfg, mesh, opt=rc, sync="psum",
                                     microbatch=2)
    rp = ref.jax.tree.map(ref.jnp.asarray, rparams)
    with ref.compat.use_mesh(mesh):
        rp2, rstate, rout = rstep(rp, ref.opt.init_opt_state(rp), rb)
    params = transformer.stack_layers(transformer.param_tree(
        _model(cfg, rparams)))
    _, _, grads = _grads_of(cfg, 2, torch.float32, "full")(
        params, _torch_batch(b))
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    _leaf_close(_flat(grads), rgrads)
    step = make_train_step(cfg, opt=c, sync="psum", microbatch=2)
    params, state, out = step(params, optimizer.init_opt_state(params), b)
    assert set(out) == set(rout) == {"loss", "grad_norm", "lr", "ce",
                                     "expert_load"}
    for k in ("loss", "grad_norm", "lr", "ce"):
        assert _rel(out[k], rout[k]) <= LOSS_RTOL, k
    assert int(state["step"]) == 1
    lr = float(rout["lr"])
    got = _flat(params)
    for path, w in _flat(ref.jax.tree.map(np.asarray, rp2)).items():
        g = rgrads[path]
        clear = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(got[path][clear], w[clear], rtol=OPT_RTOL,
                                   atol=1e-8, err_msg=path)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=2 * lr,
                                   err_msg=path)


def test_pods_step_broadcast_and_strip():
    cfg = reduced(get_config("llama3-8b")).replace(n_layers=1)
    model = registry.build_model(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    stacked = transformer.stack_layers(transformer.param_tree(model))
    pods = broadcast_to_pods(stacked, 3)
    assert pods["blocks"]["attn"]["wq"].shape == (3, 1, 128, 128)
    pods["embed"][1].add_(1.0)            # each pod owns its slice
    assert torch.equal(strip_pods(pods)["embed"], stacked["embed"])
    with pytest.raises(ValueError, match="WanPlan"):
        make_train_step(cfg, n_pods=2, sync="wanify")


def test_loss_fn_gates():
    """The four ported families train, the hybrid `zamba2-2.7b`, an MoE
    config built from a ported one and the dense family's MLA included;
    MoE with a leading dense layer raises "not yet ported", and an
    unknown remat raises for every family."""
    ssm = reduced(get_config(SSM_ARCH))
    dense = reduced(get_config("llama3-8b"))
    hybrid = reduced(get_config("zamba2-2.7b"))
    moe = dense.replace(moe=dataclasses.replace(dense.moe, n_experts=4,
                                                top_k=2, d_ff_expert=64))
    mla = dense.replace(mla=MLAConfig(kv_lora_rank=32))
    for cfg in (ssm, dense, hybrid, moe, mla):
        assert callable(registry.loss_fn(cfg, remat="dots"))
    prologue = moe.replace(moe=dataclasses.replace(moe.moe,
                                                   first_dense_layers=1))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        registry.loss_fn(prologue)
    for cfg in (ssm, dense, hybrid, moe, mla):
        with pytest.raises(ValueError, match="unknown remat"):
            registry.loss_fn(cfg, remat="some")


@pytest.mark.parametrize("arch", ARCHS + ["mamba2-2.7b", "zamba2-2.7b"])
def test_param_count_matches_reference(ref, arch):
    assert registry.param_count(get_config(arch)) == \
        ref.registry.param_count(ref.config(arch))


# ----------------------------------------------------------------------
# the Trainer, one pod: tests/test_system.py's scenarios
# ----------------------------------------------------------------------
def test_training_reduces_loss():
    cfg = reduced(get_config("llama3-8b"))
    dcfg = pipeline.DataConfig(batch=4, seq=32, vocab=cfg.vocab)
    tr = Trainer(cfg, 1, dcfg, LoopConfig(steps=8, sync="psum"),
                 opt=optimizer.AdamWConfig(lr=1e-3, warmup_steps=2,
                                           total_steps=8), device="cpu")
    tr.run(0)
    losses = [h["loss"] for h in tr.history]
    assert losses[-1] < losses[0], losses


def test_checkpoint_restart_resumes(tmp_path):
    cfg = reduced(get_config("qwen3-4b"))
    dcfg = pipeline.DataConfig(batch=4, seq=32, vocab=cfg.vocab)
    lc = LoopConfig(steps=6, ckpt_dir=str(tmp_path), ckpt_every=3,
                    sync="psum")
    Trainer(cfg, 1, dcfg, lc, device="cpu").run(0)
    tr2 = Trainer(cfg, 1, dcfg,
                  LoopConfig(steps=9, ckpt_dir=str(tmp_path), ckpt_every=3,
                             sync="psum"), device="cpu")
    tr2.run(0)
    assert any("restored step 6" in e for e in tr2.events)
    assert len(tr2.history) == 3             # only steps 6..8 re-run


def test_failure_injection_recovers(tmp_path):
    cfg = reduced(get_config("llama3-8b"))
    dcfg = pipeline.DataConfig(batch=4, seq=32, vocab=cfg.vocab)
    lc = LoopConfig(steps=7, ckpt_dir=str(tmp_path), ckpt_every=2,
                    sync="psum")
    tr = Trainer(cfg, 1, dcfg, lc, device="cpu")
    tr.run(0, fail_at=5)
    assert any("simulated failure" in e for e in tr.events)
    assert any("restored" in e for e in tr.events)
    assert tr.history[-1]["step"] == 6       # completed all steps


# ----------------------------------------------------------------------
# the Trainer, 4 pods: WANify replans with skew weights, compressed sync
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def forest():
    return train_default_forest(n_samples=150, n_trees=40)[0]


def test_four_pod_checkpoint_failure_and_rescale(tmp_path, forest):
    """The multi-pod fault path: checkpoints are pod-free (the reference's
    layout, pod 0's slice), a failure restores them into every pod, and
    `rescale` starts a Trainer of another pod count from them."""
    cfg = reduced(get_config("h2o-danube-1.8b"))
    dcfg = pipeline.DataConfig(batch=8, seq=16, vocab=cfg.vocab, n_pods=4,
                               skew=0.5)
    lc = LoopConfig(steps=6, ckpt_dir=str(tmp_path), ckpt_every=3,
                    sync="wanify", compress=True, replan_every=2)
    tr = Trainer(cfg, 4, dcfg, lc, sim=WanSimulator(seed=0),
                 predictor=BwPredictor(forest, device="cpu"), device="cpu")
    params, state = tr.run(0, fail_at=4)
    assert "simulated failure at step 4" in tr.events
    assert "restored step 3" in tr.events
    assert [h["step"] for h in tr.history] == [0, 1, 2, 3, 3, 4, 5]
    for leaf in (params["embed"], params["blocks"]["mlp"]["w1"]):
        for p in range(1, 4):
            # the pods stay in step: each adds its own gradient exactly
            # and the others' through the codec, so they part by the
            # quantization's error only
            torch.testing.assert_close(leaf[p], leaf[0], rtol=0,
                                       atol=1e-3 * float(leaf.abs().max()))
    assert state["step"].tolist() == [6] * 4
    tr2 = tr.rescale(2)
    assert tr2.n_pods == 2 and tr2.controller.n_pods == 2
    assert "rescaled to {'pod': 2}" in tr2.events
    tr2.loop = LoopConfig(steps=7, ckpt_dir=str(tmp_path), ckpt_every=3,
                          sync="wanify", compress=True, replan_every=2)
    tr2.dcfg = pipeline.DataConfig(batch=8, seq=16, vocab=cfg.vocab,
                                   n_pods=2, skew=0.5)
    p2, _ = tr2.run(0)
    assert "restored step 6" in tr2.events
    assert [h["step"] for h in tr2.history] == [6]
    assert p2["embed"].shape[0] == 2


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------
def test_train_cli_on_host(capsys):
    train_cli.main(["--arch", "h2o-danube-1.8b", "--reduced", "--device",
                    "cpu", "--steps", "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "[train] step     0 loss" in out and "events: []" in out
    with pytest.raises(ValueError, match="one"):
        train_cli.main(["--arch", "llama3-8b", "--reduced", "--device",
                        "cpu", "--data", "2"])


def test_train_cli_trains_mamba_on_host(capsys):
    """`--arch mamba2-2.7b` trains through the launcher (the ssm family's
    backwards by their plain versions on the host)."""
    train_cli.main(["--arch", SSM_ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "[train] step     1 loss" in out and "events: []" in out
