"""Where the port's bf16 training parts from the JAX reference, on the
CPU (not collected by pytest; it imports both packages, as the tests
do):

    PYTHONPATH=src python tests/torch_bf16_gap.py     # ~4 min

1. Each op of the dense block in bf16, the port's autograd against
   `jax.vjp` of the reference under jit, on the same seeded inputs: the
   share of elements that differ and max |diff| / max |ref| of the
   value and of each input's gradient.
2. One step's bf16 gradients of `reduced(h2o-danube-1.8b)` (the
   reference's parameters), leaf by leaf.
3. The 4-pod WANify run of `tests/test_torch_train.py` against the
   reference's live run: the largest loss gap over its 5 steps for the
   port as it is (f32 and bf16), for planted faults (the gate's value
   unrounded, `rms_norm`'s value path in f32, the sync uncompressed),
   and for `rms_norm` with XLA's bf16 sums (`XlaRmsNorm`: windows of 32
   along the features, a bf16 rounding after every add; the rows
   summed in order) in place of torch's f32 sums.
4. The 8-step psum run of `tests/test_torch_train.py` (lr 1e-3) against
   the reference's Trainer: the largest loss gap, f32 and bf16.
5. The forward of each dense arch: the reference's block under one jit
   against the same block jitted op by op (ln1, attention, ln2, MLP),
   the port's block against the first (it takes ln2's variance of the
   f32 sum x + attn before rounding it, as XLA's whole-block program
   does), and the loss gap.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.models import attention as ref_att  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.layers import ShardCtx  # noqa: E402
from repro import compat as ref_compat  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.train import loop as ref_loop  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from test_torch_train import _REFERENCE_PODS  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.core.predictor import BwPredictor  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import layers, registry, transformer  # noqa: E402
from repro_torch.train import optimizer, train_step  # noqa: E402
from repro_torch.train.loop import LoopConfig, Trainer  # noqa: E402
from repro_torch.wan.dataset import train_default_forest  # noqa: E402
from repro_torch.wan.simulator import WanSimulator  # noqa: E402

ARCH = "h2o-danube-1.8b"
BF = torch.bfloat16


def gap(got, want) -> str:
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    d = np.abs(got - want)
    return (f"differ {np.mean(d > 0):.4f}  max|d|/max|ref| "
            f"{d.max() / max(np.abs(want).max(), 1e-30):.3e}")


def op_gaps() -> None:
    rng = np.random.default_rng(0)

    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def case(name, jf, tf, inputs, g):
        jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in inputs]
        out, vjp = jax.vjp(jf, *jin)
        grads = jax.jit(lambda *a: jax.vjp(jf, *a[:-1])[1](a[-1]))(
            *jin, jnp.asarray(g).astype(jnp.bfloat16))
        ts = [torch.from_numpy(a).to(BF).requires_grad_() for a in inputs]
        o = tf(*ts)
        o.backward(torch.from_numpy(g).to(BF))
        print(f"  {name:20s} value   {gap(o, out)}")
        for i, (t, w) in enumerate(zip(ts, grads)):
            print(f"  {name:20s} d_in{i}   {gap(t.grad, w)}")

    d = 128
    x, pos = arr(2, 32, d), np.arange(32)
    head, tgt = arr(d, 512, scale=0.1), rng.integers(0, 512, (2, 32))
    case("matmul", lambda a, b: a @ b, lambda a, b: a @ b,
         [x, arr(d, 256, scale=0.1)], arr(2, 32, 256))
    case("rms_norm", lambda a, b: ref_layers.rms_norm(a, b, 1e-5),
         lambda a, b: layers.rms_norm(a, b, 1e-5), [x, arr(d)],
         arr(2, 32, d))
    case("rms_norm, XLA's sums", lambda a, b: ref_layers.rms_norm(
        a, b, 1e-5), lambda a, b: XlaRmsNorm.apply(a, b, 1e-5),
        [x, arr(d)], arr(2, 32, d))
    case("rope", lambda a: ref_layers.apply_rope(
        a, jnp.asarray(pos)[None, None, :], 10000.0),
        lambda a: layers.apply_rope(
            a, torch.from_numpy(pos)[None, None, :], 10000.0),
        [arr(2, 4, 32, 32)], arr(2, 4, 32, 32))
    case("swiglu", lambda a, b, c, e: ref_layers.swiglu(a, b, c, e,
                                                       ShardCtx()),
         layers.swiglu, [x, arr(d, 96, scale=0.1), arr(d, 96, scale=0.1),
                         arr(96, d, scale=0.1)], arr(2, 32, d))
    case("flash", lambda a, b, c: ref_att.flash_attention(
        a, b, c, causal=True, window=32, block_k=512),
        lambda a, b, c: att.flash_attention(a, b, c, window=32),
        [arr(2, 4, 1, 32, 32), arr(2, 4, 32, 32), arr(2, 4, 32, 32)],
        arr(2, 4, 1, 32, 32))
    case("chunked_xent", lambda a, b: ref_layers.chunked_xent(
        a, b, jnp.asarray(tgt), ShardCtx()).astype(jnp.bfloat16),
        lambda a, b: layers.chunked_xent(
            a, b, torch.from_numpy(tgt).long()).to(BF),
        [x, head], np.ones((), np.float32))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def reference_params(dtype):
    rcfg = ref_reduced(ref_config(ARCH)).replace(dtype=dtype)
    return rcfg, jax.tree.map(np.asarray, ref_registry.init_params(
        rcfg, jax.random.key(0)))


def grad_gaps() -> None:
    rcfg, rparams = reference_params("bfloat16")
    cfg = reduced(get_config(ARCH))
    b = next(pipeline.batches(cfg, pipeline.DataConfig(
        batch=2, seq=32, vocab=cfg.vocab)))
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_transformer.lm_loss(p, rb, rcfg, ShardCtx()),
        has_aux=True))(rparams)
    model = registry.build_model(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    registry.load_reference_params(model, rparams)
    params = transformer.stack_layers(transformer.param_tree(model))
    loss, _, grads = train_step._grads_of(cfg, 1, torch.float32, "full")(
        params, {k: torch.from_numpy(v).long() for k, v in b.items()})
    print(f"  loss {float(loss):.7f} vs {float(rloss):.7f}")
    got, want = flat(grads), flat(rgrads)
    for path in sorted(want):
        print(f"  {path:16s} {gap(got[path], want[path])}")


def acc_bf16(t: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis in order, a bf16 rounding after every add
    (f32 out)."""
    acc = t[..., 0].float()
    for i in range(1, t.shape[-1]):
        acc = (acc + t[..., i].float()).to(BF).float()
    return acc


class XlaRmsNorm(torch.autograd.Function):
    """`rms_norm` in bf16 with the backward of XLA's CPU program: its
    products rounded to bf16, d inv summed in windows of 32 along the
    features and d scale along the rows, each add rounded to bf16."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, scale, var, inv)
        ctx.eps = eps
        return x * inv.to(BF) * scale.to(BF)

    @staticmethod
    def backward(ctx, g):
        x, scale, var, inv = ctx.saved_tensors
        xf, gf, d = x.float(), g.float(), x.shape[-1]
        inv_b = inv.to(BF).float()
        gs = (gf * scale.to(BF).float()).to(BF).float()
        dx1 = (gs * inv_b).to(BF).float()
        t = (xf * gs).to(BF)
        if d > 32:
            t = acc_bf16(t.reshape(*t.shape[:-1], d // 32, 32)).to(BF)
        dinv = acc_bf16(t)[..., None].to(BF).float()
        # d var = d inv * (-1/2) rsqrt / (var + eps); d x = 2 x / d d var
        dvar = dinv * (inv / (var + ctx.eps) * -0.5)
        dx2 = (xf * (dvar * (2.0 / d))).to(BF)
        dx = (dx1 + dx2.float()).to(BF)
        terms = ((xf * inv_b).to(BF).float() * gf).to(BF).reshape(-1, d)
        ds = acc_bf16(terms.t()).to(BF)
        return dx, ds.to(scale.dtype), None


def xla_rms_norm(x, scale, eps=1e-5, stats=None):
    if x.dtype != BF or stats is not None:
        return PORT_RMS(x, scale, eps, stats)
    return XlaRmsNorm.apply(x, scale, eps)


def f32_rms_norm(x, scale, eps=1e-5, stats=None):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def forward_gaps(arch) -> None:
    rcfg = ref_reduced(ref_config(arch))
    cfg = reduced(get_config(arch))
    rparams = jax.tree.map(np.asarray, ref_registry.init_params(
        rcfg, jax.random.key(0)))
    b = next(pipeline.batches(cfg, pipeline.DataConfig(
        batch=2, seq=32, vocab=cfg.vocab)))
    pos = jnp.arange(32)
    rpc = ref_transformer._cast_params(jax.tree.map(jnp.asarray, rparams),
                                       jnp.bfloat16)
    model = registry.build_model(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    registry.load_reference_params(model, rparams)
    pc = transformer.cast_params(transformer.param_tree(model), BF)
    whole = jax.jit(lambda blk, h: ref_transformer._attn_mlp_block(
        blk, h, pos, rcfg, ShardCtx(), 1)[0])
    norm = jax.jit(lambda h, s: ref_layers.rms_norm(h, s, rcfg.norm_eps))
    attn = jax.jit(lambda p, h: ref_att.gqa_forward(p, h, ShardCtx(), rcfg,
                                                    pos))
    mlp = jax.jit(lambda h, p: ref_layers.swiglu(h, p["w1"], p["w3"],
                                                 p["w2"], ShardCtx()))
    x = rpc["embed"][jnp.asarray(b["tokens"])]
    for i in range(rcfg.n_layers):
        blk = jax.tree.map(lambda t: t[i], rpc["blocks"])
        want = whole(blk, x)
        x1 = x + attn(blk["attn"], norm(x, blk["ln1"]))
        ops_alone = x1 + mlp(norm(x1, blk["ln2"]), blk["mlp"])
        xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF)
        with torch.no_grad():
            port = transformer.DenseBlock.run(pc["blocks"][i], xt,
                                              torch.arange(32), cfg)
        ops_t = torch.from_numpy(np.array(ops_alone.astype(jnp.float32)))
        print(f"  {arch} block {i}: op-by-op jit {gap(ops_t, want)}; "
              f"port {gap(port, want)}")
        x = want
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    want = float(jax.jit(lambda p: ref_transformer.lm_loss(
        p, rb, rcfg, ShardCtx())[0])(jax.tree.map(jnp.asarray, rparams)))
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    tree = transformer.param_tree(model)
    with torch.no_grad():
        port = float(registry.loss_fn(cfg)(tree, tb)[0])
    print(f"  {arch} loss gap: {abs(port - want) / want:.2e}")


def unrounded_gate(y, z):
    return (torch.nn.functional.silu(z.float()) * y.float()).to(y.dtype)


PORT_RMS = layers.rms_norm
PORT_SYNC = train_step.wan_allreduce_batched
VARIANTS = {
    "as is": {},
    "XLA's bf16 sums in rms_norm": {
        (transformer, "rms_norm"): xla_rms_norm,
        (att, "head_rms_norm"): lambda x, s, eps=1e-6: xla_rms_norm(
            x, s, eps)},
    "planted: rms_norm value path f32": {
        (transformer, "rms_norm"): f32_rms_norm},
    "planted: gate value unrounded": {(ops, "swiglu_gate"): unrounded_gate},
    "planted: sync uncompressed": {
        (train_step, "wan_allreduce_batched"):
            lambda t, p, compress=False, mean=True: PORT_SYNC(
                t, p, compress=False, mean=mean)},
}


def four_pod_gap(dtype, patches, want, forest) -> float:
    _, rparams = reference_params(dtype)
    cfg = reduced(get_config(ARCH)).replace(dtype=dtype)
    tr = Trainer(cfg, 4, pipeline.DataConfig(
        batch=8, seq=32, vocab=cfg.vocab, n_pods=4, skew=0.5),
        LoopConfig(steps=5, sync="wanify", compress=True, replan_every=2,
                   straggler_factor=1e9),
        sim=WanSimulator(seed=0),
        predictor=BwPredictor(forest, device="cpu"), device="cpu")
    saved = {k: k[0].__dict__[k[1]] for k in patches}
    for (mod, name), fn in patches.items():
        setattr(mod, name, fn)
    try:
        with_reference_init(rparams, lambda: tr.run(0))
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    assert tr.events == want["events"], tr.events
    return max(abs(h["loss"] - w["loss"]) / abs(w["loss"])
               for h, w in zip(tr.history, want["history"]))


def with_reference_init(rparams, run):
    """run() with `registry.init_params` loading the reference's
    parameters (restored after)."""
    build = registry.build_model

    def init(cfg, generator, device):
        model = build(cfg, generator, device)
        registry.load_reference_params(model, rparams)
        return model

    registry.init_params = init
    try:
        return run()
    finally:
        registry.init_params = build


def psum_gap(dtype) -> float:
    rcfg = ref_reduced(ref_config("llama3-8b")).replace(dtype=dtype)
    rparams = jax.tree.map(np.asarray, ref_registry.init_params(
        rcfg, jax.random.key(0)))
    cfg = reduced(get_config("llama3-8b")).replace(dtype=dtype)
    dcfg = dict(batch=4, seq=32, vocab=cfg.vocab)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    rtr = ref_loop.Trainer(rcfg, ref_compat.make_mesh((1,), ("data",)),
                           ref_pipeline.DataConfig(**dcfg),
                           ref_loop.LoopConfig(steps=8, sync="psum"),
                           opt=ref_opt.AdamWConfig(**kw))
    rtr.run(jax.random.key(0))
    tr = Trainer(cfg, 1, pipeline.DataConfig(**dcfg),
                 LoopConfig(steps=8, sync="psum"),
                 opt=optimizer.AdamWConfig(**kw), device="cpu")
    with_reference_init(rparams, lambda: tr.run(0))
    return max(abs(h["loss"] - w["loss"]) / abs(w["loss"])
               for h, w in zip(tr.history, rtr.history))


def main() -> None:
    print("1. ops in bf16, port vs jax.vjp (jit):")
    op_gaps()
    print(f"2. one step's bf16 gradients of reduced {ARCH}:")
    grad_gaps()
    print("3. the 4-pod WANify run, largest loss gap over 5 steps:")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "pods.json"
        env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
                   JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, "-c", _REFERENCE_PODS, str(path)],
                       check=True, capture_output=True, env=env,
                       timeout=900)
        ref = json.loads(path.read_text())
    forest = train_default_forest(n_samples=150, n_trees=40)[0]
    for dtype, name in [("float32", "as is"),
                        ("float32", "planted: sync uncompressed")] + [
            ("bfloat16", name) for name in VARIANTS]:
        g = four_pod_gap(dtype, VARIANTS[name], ref[dtype], forest)
        print(f"  {dtype}, {name}: {g:.3e}")
    print("4. the 8-step psum run, largest loss gap over 8 steps:")
    for dtype in ("float32", "bfloat16"):
        print(f"  {dtype}: {psum_gap(dtype):.3e}")
    print("5. the bf16 forward, block by block, against the reference's "
          "block under one jit:")
    for arch in ("h2o-danube-1.8b", "llama3-8b", "qwen3-4b"):
        forward_gaps(arch)


if __name__ == "__main__":
    main()
