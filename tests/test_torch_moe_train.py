"""The port's training of the MoE family (`granite-moe-1b-a400m`)
against the JAX reference, on the CPU: `reduced(get_config(
"granite-moe-1b-a400m"))`, 2 layers of d_model 128 with 4 experts
top-2 (d_ff_expert 64, capacity factor 1.25), the reference's
parameters carried across by `load_reference_params`, inputs made with
numpy from a seed. The reference's `lm_loss` and `Trainer` run as
`tests/test_torch_train.py` runs them; its 4-pod WANify run in a
subprocess with 4 host devices is `tests/test_torch_moe_train_pods.py`.

The MoE layer's two data-movement ops train through their backwards'
plain versions on the host (`ops.moe_dispatch_bwd`,
`ops.moe_combine_bwd`, `ops.moe_gates_bwd`; the kernels on the card).
Each is held bit for bit to `jax.vjp` of the reference's loops, given
the same cotangent (`test_backward_plain_versions_equal_reference_vjp`):
XLA sums the dispatch's k transposed scatter-adds last choice first;
the combine's ob cotangent is each kept choice's product dy x r(g)
rounded once, scattered onto zeros; its gate cotangent is a row sum
over d in windows of 32 (d > 32; the row padded to a multiple of 32,
half the pad in front), each add rounded to the dtype, and at d <= 32
in f32 a chain of fused multiply-adds.

Tolerances:
- f32: the loss within LOSS_RTOL (1e-5) relative, aux within 1e-6
  relative, expert_load within LOAD_TOL (1e-6: a layer's shares are
  counts over T k, which XLA divides within an ulp of torch's mean),
  every gradient leaf within GRAD_TOL (1e-4) of its max |g| under each
  remat (measured: the loss equal, aux 1.0e-7, the leaves 1.2e-6,
  `blocks.moe.w3`).
- bf16 (the config's own dtype): every leaf within BF16_GRAD_TOL (5e-2,
  the dense and hybrid tests' bound) of its max |g| and the loss
  within BF16_LOSS_RTOL (1e-3); aux within BF16_AUX_RTOL (5e-5)
  relative; expert_load within LOAD_TOL. Measured: the leaves 2.34e-2
  (`blocks.ln2`), the loss 5.2e-5, aux 1.27e-5 (at most 1.27e-5 over 3
  parameter x 3 data seeds). The aux gap is the router's input, not the
  MoE layer (`test_bf16_aux_gap_is_the_layers_input`): layer 0's input
  parts from XLA's in one bf16 rounding of the attention's, layer 1's
  in ~1-5% of its elements, and the port's layer on the reference's
  own input gives each layer's aux within AUX_RTOL.
- the 1-pod Trainer (8 steps, lr 1e-3): f32 losses within TRAIN_RTOL
  (1e-4) and each step's expert_load within 1e-6; bf16 losses within
  MOE_BF16_LOSS_RTOL (2e-3, the hybrid's bound: AdamW turns the
  rounding floor above into lr-sized parameter differences).
- the 4-pod compressed WANify run (f32): events and plans identical,
  losses within FOUR_POD_F32_RTOL (5e-7) and each step's pod-mean
  expert_load within 1e-6.
- the card against the host (`cuda` cases, f32): within 1e-3 of each
  leaf's max |g|; the kernels against their plain versions bit for bit.

Card-only cases (marked `cuda`) import no jax:
``python -m pytest -q -m cuda tests/test_torch_moe_train.py``.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from test_torch_checkpoint import _assert_same
from test_torch_moe import WORKER_WARPS, _token_wpt, _unaligned
from test_torch_train import (GRAD_TOL, LOSS_RTOL, TRAIN_RTOL, _batch,
                              _flat, _leaf_close, _rel, _torch_batch)
from repro_torch.compat import tree_map
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data import pipeline
from repro_torch.kernels import moe as moe_lib
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (moe_combine_bwd_ref, moe_dispatch_bwd_ref,
                                     moe_gates_bwd_ref, moe_slots_ref)
from repro_torch.launch import train as train_cli
from repro_torch.models import registry, transformer
from repro_torch.train import optimizer
from repro_torch.train.loop import LoopConfig, Trainer

ARCH = "granite-moe-1b-a400m"
REMATS = ["none", "full", "dots"]
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_GRAD_TOL = 5e-2        # of each leaf's max |g|
BF16_LOSS_RTOL = 1e-3
AUX_RTOL = 1e-6
BF16_AUX_RTOL = 5e-5        # traced: test_bf16_aux_gap_is_the_layers_input
MOE_BF16_LOSS_RTOL = 2e-3
LOAD_TOL = 1e-6
CARD_TOL = 1e-3             # of each leaf's max |g|, card vs host
TRAIN_KW = dict(lr=1e-3, warmup_steps=2, total_steps=8)
MOE_LEAVES = ["blocks.moe.router", "blocks.moe.w1", "blocks.moe.w2",
              "blocks.moe.w3"]
# (label, T, E, k, d, capacity or None for the config's 1.25): the
# reduced model's layer, granite's k = 8 of 32 at small widths (d 64:
# two windows of the gate sum; 48: padded windows; 16: one sum, f32's
# fused multiply-adds), a capacity that drops many choices, and
# granite's d = 1,024 (the gate sum's 32 windows at the training width)
BWD_CASES = [("reduced", 64, 4, 2, 128, None), ("k8", 48, 32, 8, 64, None),
             ("k8-drops", 48, 32, 8, 64, 4), ("k8-d48", 40, 32, 8, 48, None),
             ("k8-d16", 40, 32, 8, 16, None), ("k1", 24, 4, 1, 64, 4),
             ("d1024", 16, 4, 2, 1024, None)]


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
    from repro.models import moe as ref_moe
    from repro.models import registry as ref_registry
    from repro.models import transformer as ref_transformer
    from repro.models.layers import ShardCtx
    from repro.train import loop as ref_loop
    from repro.train import optimizer as ref_opt
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, compat=compat, ckpt=ref_ckpt, config=ref_config,
        reduced=ref_reduced, pipeline=ref_pipeline, moe=ref_moe,
        registry=ref_registry, transformer=ref_transformer,
        ShardCtx=ShardCtx, loop=ref_loop, opt=ref_opt)


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
    """The port's MoE holding the reference's parameters, training."""
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


def _record_loads(trainer, loads: list) -> None:
    """Wrap `trainer`'s step builder so each step's out["expert_load"]
    is appended to `loads` (as numpy)."""
    build = trainer._build_step

    def wrapped(plan):
        fn = build(plan)

        def step(*a):
            params, state, out = fn(*a)
            loads.append(np.asarray(out["expert_load"], dtype=np.float32))
            return params, state, out
        return step
    trainer._build_step = wrapped


# ----------------------------------------------------------------------
# the loss and its gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", REMATS)
def test_lm_loss_and_grads_match_reference(ref, built, remat, dtype):
    """`registry.loss_fn` and torch.autograd against jax.value_and_grad
    of the reference's `lm_loss` under the same remat: the loss (ce +
    0.01 aux), aux, expert_load, and every gradient leaf, the router's
    and the experts' included, in the reference's stacked layout."""
    cfg, rcfg, rparams = built(dtype)
    b = _batch(cfg)
    (want_loss, wm), g = ref.jax.value_and_grad(
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
    assert set(MOE_LEAVES) <= set(want)
    f32 = dtype == "float32"
    assert _rel(loss, want_loss) <= (LOSS_RTOL if f32 else BF16_LOSS_RTOL)
    assert _rel(metrics["aux"], wm["aux"]) <= \
        (AUX_RTOL if f32 else BF16_AUX_RTOL)
    load = metrics["expert_load"].detach().numpy()
    np.testing.assert_allclose(load, np.asarray(wm["expert_load"]), rtol=0,
                               atol=LOAD_TOL)
    assert load.shape == (cfg.moe.n_experts,)
    assert abs(load.sum() - cfg.n_layers) <= LOAD_TOL
    _leaf_close(got, want, GRAD_TOL if f32 else BF16_GRAD_TOL)


def test_moe_layer_routing_and_stats_match_reference(ref, built):
    """One MoE layer in training mode on the same input (f32): the
    routing's integers (the top-k experts, their slots and kept flags)
    equal to the reference's own ops, y within 1e-6 of its max, aux
    within AUX_RTOL and the load within LOAD_TOL; the gradients of x and every
    MoE leaf through `jax.vjp` of the reference's `moe_forward` within
    GRAD_TOL of their max."""
    cfg, rcfg, rparams = built("float32")
    jnp, jax = ref.jnp, ref.jax
    p = {k: v[0] for k, v in rparams["blocks"]["moe"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    (y, aux, load), vjp = jax.vjp(
        lambda p, x: ref.moe.moe_forward(p, x, ref.ShardCtx(), rcfg),
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    gp, gx = vjp((jnp.asarray(gy), jnp.zeros(()), jnp.zeros_like(load)))
    # the reference's routing, from its own ops
    logits = jnp.asarray(x).reshape(1, -1, cfg.d_model) @ p["router"]
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.moe.top_k)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in
          p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    from repro_torch.models import moe as moe_mod
    _, _, teidx = moe_mod.route(moe_mod.router_logits(
        tx.detach().reshape(1, -1, cfg.d_model), tp["router"].detach()),
        cfg.moe.top_k)
    np.testing.assert_array_equal(teidx.numpy(), np.asarray(eidx))
    C = moe_mod.capacity(x.shape[0] * x.shape[1], cfg)
    want_pos, want_keep, _ = moe_slots_ref(teidx, cfg.moe.n_experts, C)
    oh = jax.nn.one_hot(eidx.reshape(1, -1), cfg.moe.n_experts,
                        dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, 1) - 1,
                              eidx.reshape(1, -1)[..., None], 2)[..., 0]
    np.testing.assert_array_equal(want_keep.numpy().reshape(1, -1),
                                  np.asarray(pos < C))
    ty, taux, tload = moe_mod.moe_forward(tp, tx, cfg)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(y)).max())
    assert _rel(taux, aux) <= AUX_RTOL
    np.testing.assert_allclose(tload.numpy(), np.asarray(load), rtol=0,
                               atol=LOAD_TOL)
    assert not tload.requires_grad
    ty.backward(torch.from_numpy(gy))
    got = {"x": tx.grad.numpy(), **{k: t.grad.numpy() for k, t in tp.items()}}
    want = {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in gp.items()}}
    _leaf_close(got, want, GRAD_TOL)


def test_bf16_aux_gap_is_the_layers_input(ref, built, monkeypatch):
    """The bf16 aux gap, traced layer by layer: each MoE layer's input
    and aux captured in both packages' `lm_loss` (the reference's by a
    debug callback inside its scan). Layer 0's input parts from XLA's
    in at most 0.1% of its elements (one bf16 rounding of the
    attention's on these inputs), and the port's MoE layer run on the
    reference's own input gives that layer's aux within AUX_RTOL in
    every layer: the layer is exact and the gap is the residual
    stream's."""
    cfg, rcfg, rparams = built("bfloat16")
    jax, jnp = ref.jax, ref.jnp
    seen_ref, seen_port = [], []
    ref_forward = ref.moe.moe_forward

    def ref_capture(p, x, *a, **kw):
        out = ref_forward(p, x, *a, **kw)
        jax.debug.callback(lambda h, aux: seen_ref.append(
            (np.asarray(h, np.float32), float(aux))), x, out[1],
            ordered=True)
        return out
    from repro_torch.models import moe as moe_mod
    port_forward = moe_mod.moe_forward

    def port_capture(p, x, *a, **kw):
        out = port_forward(p, x, *a, **kw)
        seen_port.append(x.detach().float().numpy().copy())
        return out
    monkeypatch.setattr(ref.moe, "moe_forward", ref_capture)
    monkeypatch.setattr(moe_mod, "moe_forward", port_capture)
    b = _batch(cfg)
    ref.transformer.lm_loss(rparams, {k: jnp.asarray(v) for k, v in
                                      b.items()}, rcfg,
                            ref.ShardCtx(remat="none"))
    jax.effects_barrier()
    with torch.no_grad():
        registry.loss_fn(cfg, "none")(transformer.param_tree(
            _model(cfg, rparams)), _torch_batch(b))
    assert len(seen_ref) == len(seen_port) == cfg.n_layers
    h0 = seen_ref[0][0].reshape(seen_port[0].shape)
    assert np.mean(h0 != seen_port[0]) <= 1e-3
    for layer, (h, want) in enumerate(seen_ref):
        p = {k: torch.from_numpy(np.array(v[layer])).to(torch.bfloat16)
             for k, v in rparams["blocks"]["moe"].items()}
        with torch.no_grad():
            _, aux, _ = port_forward(p, torch.from_numpy(h.reshape(
                seen_port[layer].shape)).to(torch.bfloat16), cfg)
        assert _rel(aux, want) <= AUX_RTOL, layer


# ----------------------------------------------------------------------
# the backwards' plain versions against the reference's transposes
# ----------------------------------------------------------------------
def _ref_loops(ref, dtype):
    """The reference's dispatch (k scatter-adds) and combine (k gathers)
    loops of `repro/models/moe.py`, for one group."""
    jax, jnp = ref.jax, ref.jnp

    def dispatch(x, eidx, pos_c, keep, E, C):
        buf = jnp.zeros((E, C, x.shape[1]), x.dtype)
        for j in range(eidx.shape[1]):
            vals = jnp.where(keep[:, j][..., None], x, 0)
            buf = buf.at[eidx[:, j], pos_c[:, j]].add(vals)
        return buf

    def combine(ob, gates, eidx, pos_c, keep):
        y = jnp.zeros((eidx.shape[0], ob.shape[2]), dtype)
        gd = gates.astype(dtype)
        for j in range(eidx.shape[1]):
            yj = ob[eidx[:, j], pos_c[:, j]]
            y = y + jnp.where(keep[:, j][..., None], yj, 0) * gd[:, j][
                ..., None]
        return y
    return dispatch, combine


def _bwd_case(T, E, k, d, cap, seed):
    """Routing from a numpy seed (the top k of random logits, slots
    counted by `moe_slots_ref`) and f32 arrays for x, ob, dy, dbuf,
    gates; some rows of dy, ob and dbuf are -0.0."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((1, T, E))
    eidx = torch.from_numpy(np.argsort(-logits, -1, kind="stable")[
        ..., :k].astype(np.int64))
    C = cap or max(4, -(-(int(T * k * 1.25 / E) + 1) // 4) * 4)
    pos_c, keep, src = moe_slots_ref(eidx, E, C)
    g = rng.random((T, k)).astype(np.float32)
    arrays = {"x": rng.standard_normal((T, d)),
              "ob": rng.standard_normal((E, C, d)),
              "dbuf": rng.standard_normal((E, C, d)),
              "dy": rng.standard_normal((T, d)),
              "gates": g / g.sum(-1, keepdims=True)}
    arrays = {n: a.astype(np.float32) for n, a in arrays.items()}
    arrays["dy"][:2] = -0.0
    arrays["ob"][:, :1] = -0.0
    arrays["dbuf"][:, :, :3] = -0.0
    return eidx[0], pos_c[0], keep[0], src[0], C, arrays


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_backward_plain_versions_equal_reference_vjp(ref, case, dtype):
    """`moe_dispatch_bwd_ref`, `moe_combine_bwd_ref` and
    `moe_gates_bwd_ref` (what the wrappers run on the host) against
    the jitted `jax.vjp` of the reference's loops given the same
    cotangent: equal bit for bit (-0.0 apart from +0.0) in both dtypes,
    with drops, -0.0 rows, k = 8 and the gate sum's window shapes; the
    wrappers on the host return the same bits and count no launch."""
    _, T, E, k, d, cap = case
    jax, jnp = ref.jax, ref.jnp
    jdt = jnp.dtype(dtype)
    eidx, pos_c, keep, src, C, a = _bwd_case(T, E, k, d, cap, seed=d + k)
    dispatch, combine = _ref_loops(ref, jdt)
    je, jp, jk = (jnp.asarray(t.numpy()) for t in (eidx, pos_c, keep))
    x, ob, dbuf, dy = (jnp.asarray(a[n]).astype(jdt)
                       for n in ("x", "ob", "dbuf", "dy"))
    gates = jnp.asarray(a["gates"])

    def dispatch_vjp(x, g):
        return jax.vjp(lambda v: dispatch(v, je, jp, jk, E, C), x)[1](g)[0]

    def combine_vjp(ob, gates, dy):
        return jax.vjp(lambda o, g: combine(o, g, je, jp, jk), ob,
                       gates)[1](dy)
    want_dx = jax.jit(dispatch_vjp)(x, dbuf)
    want_dob, want_dg = jax.jit(combine_vjp)(ob, gates, dy)

    def t(v):
        return torch.from_numpy(np.array(v.astype(jnp.float32))).to(
            TDT[dtype])
    tg = torch.from_numpy(a["gates"])
    got = {"dx": moe_dispatch_bwd_ref(t(dbuf), eidx, pos_c, keep),
           "d_ob": moe_combine_bwd_ref(t(dy), tg, eidx, pos_c, keep, E, C),
           "dgates": moe_gates_bwd_ref(t(dy), t(ob), eidx, pos_c, keep)}
    want = {"dx": want_dx, "d_ob": want_dob, "dgates": want_dg}
    assert got["dgates"].dtype == torch.float32
    for name, w in want.items():
        assert got[name].dtype == (torch.float32 if name == "dgates" else
                                   TDT[dtype])
        np.testing.assert_array_equal(
            _bits(got[name].float().numpy()),
            _bits(np.asarray(w.astype(jnp.float32))), err_msg=name)
    names = ("moe_dispatch_bwd", "moe_combine_bwd", "moe_gates_bwd")
    before = [getattr(ops, n).launches for n in names]
    wrapped = {"dx": ops.moe_dispatch_bwd(t(dbuf), eidx, pos_c, keep),
               "d_ob": ops.moe_combine_bwd(t(dy), tg, eidx, pos_c, keep, src),
               "dgates": ops.moe_gates_bwd(t(dy), t(ob), eidx, pos_c, keep)}
    for name, w in wrapped.items():
        assert torch.equal(w.float().view(torch.int32),
                           got[name].float().view(torch.int32)), name
    assert [getattr(ops, n).launches for n in names] == before
    if case[0] == "k8-drops":
        assert int((~keep).sum()) > T * k // 2


GATES_WARPS = 8        # csrc/moe.cu's kGatesWarps: gates_bwd's block


def _rehearse_gates_bwd(dy, ob, eidx, pos_c, keep, blocks, wide=True):
    """moe_gates_bwd_kernel's split in torch, as `gates_as` grids it with
    `blocks` co-resident blocks of GATES_WARPS warps: a warp a choice i =
    t * k + j, the grid cut to the T k choices where they are fewer than
    the warps; warp w takes choices w, w + stride, ..., a round at a
    time, holding the next choice's keep and slot row beside the
    current one's (the prefetch); a dropped choice writes +0.0. Over d
    <= 32 lane 0 sums the row in order (f32: fused multiply-adds, in
    f64). Over d > 32 the row is padded by `left` = half the pad in
    front to nwin windows of 32; in each step of 32 windows lane l sums
    window m0 + l from its first element in the row, in order, the
    products and every add rounded to the dtype (the 16-byte form, whole
    windows on 16-byte storage: no pad; else a lane an element, the
    pad's elements left out); the step's window sums are gathered lane
    by lane (the shuffles) and chained in order onto the windows before.
    Returns dgates [T, k] f32, -0.0 written +0.0, and asserts that every
    choice is written once."""
    E, C, d = ob.shape
    T, k = eidx.shape
    dt = ob.dtype
    W = 16 // ob.element_size() if wide and d % 32 == 0 else 1
    n = T * k
    grid = -(-min(n, blocks * GATES_WARPS) // GATES_WARPS)
    stride = grid * GATES_WARPS
    nwin = 0 if d <= 32 else -(-d // 32)
    left = (nwin * 32 - d) // 2 if nwin else 0
    assert W == 1 or left == 0
    rnd = (lambda t: t) if dt == torch.float32 else \
        (lambda t: t.to(dt).float())
    rows, dyf = ob.reshape(E * C, d).float(), dy.float()

    def route(i):
        live = i < n
        ic = i.clamp(max=n - 1)
        return live & keep.reshape(-1)[ic], \
            eidx.reshape(-1)[ic] * C + pos_c.reshape(-1)[ic]
    dg = torch.full((n,), float("nan"))
    writes = torch.zeros(n, dtype=torch.int64)
    i = torch.arange(stride)
    nxt = route(i)
    while (i < n).any():
        (kept, row), nxt = nxt, route(i + stride)
        live = i < n
        dg[i[live & ~kept]] = 0.0
        writes[i[live]] += 1
        sel = live & kept
        il, rl = i[sel], row[sel]
        a, b = dyf[il // k], rows[rl]                  # [P, d]
        if nwin == 0:
            acc = torch.zeros(len(il))
            for u in range(d):
                if dt == torch.float32:
                    acc = (acc.double() + a[:, u].double() *
                           b[:, u].double()).float()
                else:
                    p = rnd(a[:, u] * b[:, u])
                    acc = p if u == 0 else rnd(acc + p)
        else:
            e = torch.arange(nwin * 32).view(nwin, 32) - left   # [m, u]
            inside = (e >= 0) & (e < d)
            p = rnd(a[:, e.clamp(0, d - 1)] * b[:, e.clamp(0, d - 1)])
            acc = None
            for m0 in range(0, nwin, 32):
                s = torch.zeros(len(il), min(32, nwin - m0))  # a lane each
                first = torch.ones_like(s, dtype=torch.bool)
                for u in range(32):
                    pu = p[:, m0:m0 + 32, u]
                    ok = inside[m0:m0 + 32, u]
                    s = torch.where(ok & first, pu,
                                    torch.where(ok, rnd(s + pu), s))
                    first = first & ~ok
                for q in range(s.shape[1]):             # the shuffles
                    acc = s[:, q] if acc is None else rnd(acc + s[:, q])
        dg[il] = torch.where(acc == 0, torch.zeros_like(acc), acc)
        i = i + stride
    assert (writes == 1).all()
    return dg.view(T, k)


# co-resident blocks: 3 (24 warps: several rounds, a tail) and 200
# (more warps than T k = 37 k choices: the grid cut to them)
@pytest.mark.parametrize("blocks", [3, 200], ids=["tail", "cut"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("d", [16, 48, 100, 1024, 2048])
def test_gates_bwd_kernel_decomposition_rehearsed(d, k, dtype, blocks):
    """`moe_gates_bwd_kernel`'s persistent split (which warp takes which
    choice across the grid's strides, the prefetched routing, which lane
    sums which window, the pad in front, the order of the window chain)
    rehearsed in torch equals `moe_gates_bwd_ref` bit for bit, drops and
    -0.0 rows included."""
    eidx, pos_c, keep, _, _, a = _bwd_case(37, max(8, k), k, d, 4,
                                           seed=d + k)
    dy, ob = (torch.from_numpy(a[n]).to(TDT[dtype]) for n in ("dy", "ob"))
    assert (~keep).any()
    got = _rehearse_gates_bwd(dy, ob, eidx, pos_c, keep, blocks)
    want = moe_gates_bwd_ref(dy, ob, eidx, pos_c, keep)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1024, 2048])
def test_gates_bwd_element_path_rehearsed(d, dtype):
    """The element path (dy or ob not on 16-byte storage: a lane a
    window, element by element) at the train width and twice it."""
    eidx, pos_c, keep, _, _, a = _bwd_case(37, 8, 8, d, 6, seed=d)
    dy, ob = (torch.from_numpy(a[n]).to(TDT[dtype]) for n in ("dy", "ob"))
    got = _rehearse_gates_bwd(dy, ob, eidx, pos_c, keep, 3, wide=False)
    want = moe_gates_bwd_ref(dy, ob, eidx, pos_c, keep)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_gates_bwd_kernel_refuses_rows_past_its_limit():
    """The gates' backward kernel takes rows of at most MAX_GATES_D
    elements (its indices are ints); its launch raises past that before
    it reaches the card."""
    d = moe_lib.MAX_GATES_D + 1
    dy = torch.zeros((1, d), dtype=torch.bfloat16)
    ob = torch.zeros((1, 1, d), dtype=torch.bfloat16)
    route = (torch.zeros((1, 1), dtype=torch.int64),) * 2 + \
        (torch.ones((1, 1), dtype=torch.bool),)
    with pytest.raises(ValueError, match="at most"):
        moe_lib.launch_gates_bwd(dy, ob, *route,
                                 torch.empty((1, 1), dtype=torch.float32))


def _rehearse_dispatch_bwd(g, eidx, pos_c, keep, blocks, wide=True):
    """moe_dispatch_bwd_kernel's split in torch, as `dispatch_bwd_as`
    grids it with `blocks` co-resident blocks of WORKER_WARPS warps (the
    combine's grid): columns of W elements (16 bytes where `wide` and W
    divides d, else one element), `wpt` warps a token, the grid cut to
    the tokens where they are fewer than the groups; group q takes
    tokens q, q + stride, ..., a round at a time, holding the next
    token's routing beside the current one's (the prefetch: lane j < k
    the slot row of choice k-1-j, or -1 where dropped; past the last
    token -1); warp `part` of a group takes columns part * 32 + lane + m
    * wpt * 32, reading the j-th term's row from lane j (the shuffles),
    so the terms come last choice first: the first as it is, then each
    add rounded to the dtype (the bf16 ops: f32 adds rounded to bf16), a
    dropped choice's row +0.0. Returns dx and asserts that every column
    of every token is written once."""
    E, C, d = g.shape
    T, k = eidx.shape
    dt = g.dtype
    W = 16 // g.element_size()
    W = W if wide and d % W == 0 else 1
    nvec = d // W
    wpt = _token_wpt(nvec)
    groups = min(T, blocks * WORKER_WARPS // wpt)
    grid = -(-groups * wpt // WORKER_WARPS)
    stride = grid * WORKER_WARPS // wpt
    rnd = (lambda t: t) if dt == torch.float32 else \
        (lambda t: t.to(dt).float())
    rows = g.reshape(E * C, nvec, W).float()
    lanes = torch.arange(32)

    def route(t):
        live = (t[:, None] < T) & (lanes < k)
        i = t[:, None].clamp(max=T - 1) * k + (k - 1 - lanes).clamp(min=0)
        kept = live & keep.reshape(-1)[i]
        return torch.where(kept, eidx.reshape(-1)[i] * C +
                           pos_c.reshape(-1)[i], -1)
    dx = torch.full((T, nvec, W), float("nan"))
    writes = torch.zeros((T, nvec), dtype=torch.int64)
    t = torch.arange(stride)
    nxt = route(t)
    while (t < T).any():
        row, nxt = nxt, route(t + stride)
        live = t < T
        row, tl = row[live], t[live]
        for part in range(wpt):
            for c0 in range(part * 32, nvec, wpt * 32):
                c = c0 + lanes
                c = c[c < nvec]
                acc = None
                for j in range(k):
                    r = row[:, j & 31, None]
                    v = torch.where((r >= 0)[..., None],
                                    rows[r.clamp(min=0), c], 0.0)
                    acc = v if j == 0 else rnd(acc + v)
                dx[tl[:, None], c] = acc
                writes[tl[:, None], c] += 1
        t = t + stride
    assert (writes == 1).all()
    return dx.reshape(T, d).to(dt)


# co-resident blocks: 3 (12 warps: every group several tokens, a tail)
# and 200 (more groups than the 37 tokens: the grid cut to them)
@pytest.mark.parametrize("blocks", [3, 200], ids=["tail", "cut"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("d", [16, 48, 100, 1024, 2048])
def test_dispatch_bwd_kernel_decomposition_rehearsed(d, k, dtype, blocks):
    """`moe_dispatch_bwd_kernel`'s persistent split (which group takes
    which token across the grid's strides, the prefetched routing with
    lane j holding choice k-1-j, the lanes' columns, the last-first
    adds) rehearsed in torch equals `moe_dispatch_bwd_ref` bit for bit,
    drops and -0.0 rows included."""
    eidx, pos_c, keep, _, _, a = _bwd_case(37, max(8, k), k, d, 4,
                                           seed=d + k)
    g = torch.from_numpy(a["dbuf"]).to(TDT[dtype])
    assert (~keep).any()
    got = _rehearse_dispatch_bwd(g, eidx, pos_c, keep, blocks)
    want = moe_dispatch_bwd_ref(g, eidx, pos_c, keep)
    assert torch.equal(got.float().view(torch.int32),
                       want.float().view(torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1024, 2048])
def test_dispatch_bwd_element_path_rehearsed(d, dtype):
    """The element path (g or dx not on 16-byte storage: a lane an
    element) at the train width and twice it, k = 8."""
    eidx, pos_c, keep, _, _, a = _bwd_case(37, 8, 8, d, 6, seed=d)
    g = torch.from_numpy(a["dbuf"]).to(TDT[dtype])
    got = _rehearse_dispatch_bwd(g, eidx, pos_c, keep, 3, wide=False)
    want = moe_dispatch_bwd_ref(g, eidx, pos_c, keep)
    assert torch.equal(got.float().view(torch.int32),
                       want.float().view(torch.int32))


@pytest.mark.parametrize("name", ["dispatch_bwd", "combine"])
def test_token_kernels_refuse_tokens_past_their_limit(name):
    """The dispatch's backward and the combine index tokens with ints on
    their persistent grid; their launches raise at MAX_TOKENS tokens
    before they reach the card (the tensors are views of one element)."""
    T = moe_lib.MAX_TOKENS

    def big(shape, dtype):
        return torch.zeros((1,) * len(shape), dtype=dtype).expand(*shape)
    route = (big((T, 1), torch.int64),) * 2 + (big((T, 1), torch.bool),)
    rows, out = big((1, 1, 8), torch.bfloat16), big((T, 8), torch.bfloat16)
    with pytest.raises(ValueError, match="fewer than"):
        if name == "dispatch_bwd":
            moe_lib.launch_dispatch_bwd(rows, *route, out)
        else:
            moe_lib.launch_combine(rows, *route,
                                   big((T, 1), torch.float32), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ad_ops_grads_through_autograd(dtype):
    """`ops.moe_dispatch_ad` / `ops.moe_combine_ad` under autograd give
    the plain backwards' bits (x's, ob's and the gates' gradients), and
    under `torch.no_grad` / `torch.inference_mode` they return the
    forward wrappers' tensors with no graph."""
    eidx, pos_c, keep, src, C, a = _bwd_case(40, 32, 8, 64, None, seed=1)
    dt = TDT[dtype]
    x = torch.from_numpy(a["x"]).to(dt).requires_grad_()
    buf = ops.moe_dispatch_ad(x, src, eidx, pos_c, keep)
    ob = (buf * 1.5).detach().requires_grad_()
    gates = torch.from_numpy(a["gates"]).requires_grad_()
    y = ops.moe_combine_ad(ob, eidx, pos_c, keep, gates, src)
    dbuf = torch.from_numpy(a["dbuf"]).to(dt)
    dy = torch.from_numpy(a["dy"]).to(dt)
    buf.backward(dbuf)
    y.backward(dy)
    for got, want in ((x.grad, moe_dispatch_bwd_ref(dbuf, eidx, pos_c, keep)),
                      (ob.grad, moe_combine_bwd_ref(dy, gates.detach(), eidx,
                                                    pos_c, keep, 32, C)),
                      (gates.grad, moe_gates_bwd_ref(dy, ob.detach(), eidx,
                                                     pos_c, keep))):
        assert got.dtype == want.dtype
        assert torch.equal(got.float().view(torch.int32),
                           want.float().view(torch.int32))
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            b2 = ops.moe_dispatch_ad(x, src, eidx, pos_c, keep)
            y2 = ops.moe_combine_ad(ob, eidx, pos_c, keep, gates, src)
        assert b2.grad_fn is None and y2.grad_fn is None
        assert torch.equal(b2, buf.detach()) and torch.equal(y2, y.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_experts_gate_gradient_matches_reference(ref, dtype):
    """The experts' gate (`ops.swiglu_gate`, backward `silu_gate_bwd`'s
    plain version) against `jax.vjp` of the reference's
    `silu(buf @ w1) * (buf @ w3)` gate at the experts' shape [E, C, f]
    (granite's 32 experts, 40 slots, f 512), given the same products
    and cotangent: bf16 bit-equal, f32 within 1e-6 of the largest
    |grad| (XLA's exp and the host's differ in the last bit)."""
    rng = np.random.default_rng(7)
    shape = (32, 40, 512)
    h1 = (rng.standard_normal(shape) * 4).astype(np.float32)
    h3, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jdt = ref.jnp.dtype(dtype)

    def vjp(a, b, g):
        return ref.jax.vjp(lambda a, b: ref.jax.nn.silu(a) * b, a, b)[1](g)
    dh1, dh3 = ref.jax.jit(vjp)(*(ref.jnp.asarray(v).astype(jdt)
                                  for v in (h1, h3, g)))
    t1, t3 = (torch.from_numpy(v).to(TDT[dtype]).requires_grad_()
              for v in (h1, h3))
    ops.swiglu_gate(t3, t1).backward(torch.from_numpy(g).to(TDT[dtype]))
    for got, want in ((t1.grad, dh1), (t3.grad, dh3)):
        got, want = got.float().numpy(), np.asarray(want.astype("float32"))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())


# ----------------------------------------------------------------------
# the Trainer, checkpoints, the launcher
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_pod_trainer_matches_reference(ref, built, from_reference, dtype):
    """The reference's and the port's Trainer on one pod (psum, 8 steps,
    lr 1e-3, warm-up 2) from the reference's init: the same steps, no
    events, every step's loss, and each step's expert_load (a step
    metric of both; f32 within LOAD_TOL, each summing to the layers'
    count, 2)."""
    cfg, rcfg, rparams = built(dtype)
    dcfg = dict(batch=4, seq=32, vocab=cfg.vocab)
    rtr = ref.loop.Trainer(rcfg, ref.compat.make_mesh((1,), ("data",)),
                           ref.pipeline.DataConfig(**dcfg),
                           ref.loop.LoopConfig(steps=8, sync="psum"),
                           opt=ref.opt.AdamWConfig(**TRAIN_KW))
    rloads, loads = [], []
    _record_loads(rtr, rloads)
    rtr.run(ref.jax.random.key(0))
    from_reference(rparams)
    tr = Trainer(cfg, 1, pipeline.DataConfig(**dcfg),
                 LoopConfig(steps=8, sync="psum"),
                 opt=optimizer.AdamWConfig(**TRAIN_KW), device="cpu")
    _record_loads(tr, loads)
    _, state = tr.run(0)
    assert [h["step"] for h in tr.history] == list(range(8))
    assert tr.events == rtr.events == []
    tol = TRAIN_RTOL if dtype == "float32" else MOE_BF16_LOSS_RTOL
    for got, want in zip(tr.history, rtr.history):
        assert _rel(got["loss"], want["loss"]) <= tol, (got, want)
    assert int(state["step"]) == 8 and "moe" in state["m"]["blocks"]
    assert len(loads) == len(rloads) == 8
    for got, want in zip(loads, rloads):
        assert abs(got.sum() - cfg.n_layers) <= LOAD_TOL
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=LOAD_TOL)


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


def test_moe_checkpoints_restore_across_the_packages(ref, tmp_path):
    """The reference's MoE Trainer writes step 3; the port's restores it
    bit for bit (`['p']['blocks']['moe'][...]` and its moments among the
    leaves), trains on and writes step 6; the reference's restores that
    bit for bit and trains on."""
    rparams, rstate = _ref_trainer(ref, tmp_path, 3).run(
        ref.jax.random.key(0))
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    assert {"['p']['blocks']['moe']['router']",
            "['o']['m']['blocks']['moe']['w2']"} <= set(manifest["leaves"])
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


def test_train_cli_trains_the_moe_on_host(capsys):
    """`--arch granite-moe-1b-a400m` trains through the launcher on the
    host: one pod, and four pods with skew, the compressed WANify sync
    and the control plane's forest."""
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "[train] step     1 loss" in out and "events: []" in out
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "4", "--seq", "16",
                    "--pods", "4", "--skew", "0.5", "--compress"])
    out = capsys.readouterr().out
    assert "WanPlan conns=" in out and "[train] step     1 loss" in out


def test_moe_prologue_and_mla_still_refuse_training():
    """The MoE trains; MoE with leading dense layers and MLA still raise
    "not yet ported" at `loss_fn` and the model's build."""
    cfg = reduced(get_config(ARCH))
    assert callable(registry.loss_fn(cfg, remat="dots"))
    prologue = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   first_dense_layers=1))
    from repro_torch.configs.base import MLAConfig
    mla = cfg.replace(mla=MLAConfig(kv_lora_rank=32))
    for bad in (prologue, mla):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            registry.loss_fn(bad)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            registry.build_model(bad, torch.Generator(), device="cpu")


# ----------------------------------------------------------------------
# card-only: the backward kernels and the MoE's gradients on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# the training shape (T 4,096, E 32, k 8, C 1,284, d 1,024), drops, a
# ragged T, the padded window, f32's d <= 32 chain, k = 1; the persistent
# grids' edges: one token, one token past what gates_bwd's warps hold
# and one past the dispatch's backward's token groups (T None: found on
# the card), k = 32, d = 2,048, and dy, ob and the buffer's cotangent
# one element past 16-byte alignment (the element paths)
CARD_CASES = [("train", 4096, 32, 8, 1024, None), ("drops", 4096, 32, 8, 1024,
                                                   256),
              ("ragged", 4095, 32, 8, 1024, None), ("d48", 300, 32, 8, 48,
                                                    None),
              ("d16", 300, 32, 8, 16, 12), ("k1", 200, 4, 1, 64, 8),
              ("one_token", 1, 32, 8, 1024, 4),
              ("warps_plus_one", None, 32, 8, 1024, None),
              ("dispatch_groups_plus_one", None, 32, 8, 1024, None),
              ("k32", 300, 32, 32, 1024, None),
              ("d2048", 300, 32, 8, 2048, None),
              ("unaligned", 300, 32, 8, 1024, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_backward_kernels_match_plain_on_card(card, case, dtype):
    """`moe_dispatch_bwd`, `moe_combine_bwd` and `moe_gates_bwd` (the
    kernels) against their plain versions on the same card tensors: bit
    for bit, two calls equal, one launch a call."""
    label, T, E, k, d, cap = case
    dt = TDT[dtype]
    if label == "warps_plus_one":
        T = moe_lib.gates_bwd_workers(d, dt) // k + 1
    elif label == "dispatch_groups_plus_one":
        T = moe_lib.dispatch_bwd_workers(d, dt) + 1
    eidx, pos_c, keep, src, C, a = _bwd_case(T, E, k, d, cap, seed=T + d)
    on = [t.to(card) for t in (eidx, pos_c, keep, src)]
    eidx, pos_c, keep, src = on
    dbuf, dy, ob = (torch.from_numpy(a[n]).to(card, dt)
                    for n in ("dbuf", "dy", "ob"))
    if label == "unaligned":
        dbuf, dy, ob = (_unaligned(t) for t in (dbuf, dy, ob))
    gates = torch.from_numpy(a["gates"]).to(card)
    calls = {"moe_dispatch_bwd": ((dbuf, eidx, pos_c, keep),
                                  moe_dispatch_bwd_ref),
             "moe_combine_bwd": ((dy, gates, eidx, pos_c, keep, src),
                                 lambda *x: moe_combine_bwd_ref(
                                     *x[:5], E, C)),
             "moe_gates_bwd": ((dy, ob, eidx, pos_c, keep),
                               moe_gates_bwd_ref)}
    for name, (args, plain) in calls.items():
        fn = getattr(ops, name)
        before = fn.launches
        got, again = fn(*args), fn(*args)
        assert fn.launches == before + 2
        want = plain(*args)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        for other in (want, again):
            bad = (got.float().view(torch.int32) !=
                   other.float().view(torch.int32))
            assert not bad.any(), (name, int(bad.sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("remat", REMATS)
def test_moe_grads_on_card_match_host(card, remat):
    """The reduced MoE in f32: the loss's gradients through the kernels
    on the card (slots, dispatch, combine, the gate, flash and their
    backwards) against the plain versions on the host, from the same
    weights and batch, every leaf within CARD_TOL of its max |g|."""
    cfg = reduced(get_config(ARCH)).replace(dtype="float32")
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
    assert set(MOE_LEAVES) <= set(grads["cpu"])
    _leaf_close(grads[str(card)], grads["cpu"], CARD_TOL)
