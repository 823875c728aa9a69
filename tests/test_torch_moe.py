"""The port's MoE family (`granite-moe-1b-a400m`: GQA attention and a
routed MoE layer in the MLP's place) against the JAX reference, on
`reduced(get_config("granite-moe-1b-a400m"))`: 2 layers, d_model 128, 4
query heads of 32 over 2 KV heads, 4 experts, top-2, expert d_ff 64,
vocab 512. The reference's parameters are carried across by
`load_reference_params`; inputs are made with numpy from a seed.

Tolerances:
- routing: the experts `eidx`, capacity slots `pos` and `keep` equal
  the reference's exactly; gates, the aux loss and the expert load
  within 1e-6. Each case reports the smallest gap between a token's
  k-th and (k+1)-th reference probability, in f32 ulps of the k-th
  (`_boundary_ulps`), in its failure message. Measured over seeds 0-2
  of every case, the closest was 2,995 ulps (8,080 at the tests' seed
  0): none within 4.
- the MoE layer's y: f32 within 1e-5 of max |y| (measured up to 3.5e-7:
  the expert products' sums in another order, and XLA contracts the
  f32 combine into FMAs, which the port does not follow); bf16 within
  2^-8 of max |y| and at most 0.5% of its elements apart (measured over
  seeds 0-2: the routed experts' output bit-equal but for one element
  of one case, 5e-9 of max |y|; with a shared expert 0.03-0.11% of the
  elements apart, up to 0.0019 of max |y|: the shared products' sum
  order flips a bf16 rounding).
- the dispatch and combine plain versions against the reference's k
  loops (jitted, XLA's CPU program): bit for bit in bf16, -0.0 rows
  included, and the dispatch in f32; the f32 combine within k f32 ulps
  of its terms' absolute sum (the FMA contraction above: a product
  rounded where the FMA keeps it exact, which counts most where the
  terms cancel).
- the model: as the dense family's (`tests/test_torch_dense.py`): f32
  logits within 1e-4; bf16 within atol 0.0625 with greedy ids equal
  wherever the reference's top-2 gap exceeds twice that; the served ids
  equal in f32.
- the card against the host (`cuda` cases): each kernel bit-equal to
  its plain version; the reduced model in f32 within 1e-3.

Card-only cases (marked `cuda`) run where jax is not installed:
``python -m pytest -q -m cuda tests/test_torch_moe.py``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from test_torch_dense import (_f32, _logging_reference, _LoggingEngine,
                              _requests, _tokens)
from repro_torch.compat import tree_map
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels import moe as moe_lib
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (moe_combine_ref, moe_dispatch_gather_ref,
                                     moe_dispatch_ref, moe_slots_ref)
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import moe, registry, transformer
from repro_torch.serve.engine import Engine, Request, ServeConfig

ARCH = "granite-moe-1b-a400m"
DTYPES = ["float32", "bfloat16"]
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODEL_F32 = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 0.0625
ROUTE_TOL = 1e-6
Y_F32 = 1e-5                   # of max |y|
Y_BF16 = 2.0 ** -8             # of max |y|
Y_BF16_APART = 0.005           # share of elements
FULL_PARAMS = 1_384_963_072    # the reference's param_count
FULL_ACTIVE = 478_993_408      # and active_param_count


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: its config, MoE layer, model, engine."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models import layers as ref_layers
    from repro.models import moe as ref_moe
    from repro.models import registry as ref_registry
    from repro.models import transformer as ref_transformer
    from repro.models.layers import ShardCtx
    from repro.serve import engine as ref_engine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, config=ref_config, reduced=ref_reduced,
        layers=ref_layers, moe=ref_moe, registry=ref_registry,
        transformer=ref_transformer, ShardCtx=ShardCtx,
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
            full.n_kv_heads, full.resolved_head_dim, full.vocab,
            full.rope_theta, full.tie_embeddings) == (
        "moe", 24, 1024, 16, 8, 64, 49155, 10000.0, False)
    assert (full.moe.n_experts, full.moe.top_k, full.moe.d_ff_expert,
            full.moe.n_shared_experts, full.moe.capacity_factor,
            full.moe.first_dense_layers) == (32, 8, 512, 0, 1.25, 0)
    small = reduced(full)
    assert (small.n_layers, small.d_model, small.n_heads, small.n_kv_heads,
            small.moe.n_experts, small.moe.top_k,
            small.moe.d_ff_expert) == (2, 128, 4, 2, 4, 2, 64)


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_param_count_matches_reference(ref, size):
    cfg, rcfg = get_config(ARCH), ref.config(ARCH)
    if size == "reduced":
        cfg, rcfg = reduced(cfg), ref.reduced(rcfg)
    assert registry.param_count(cfg) == ref.registry.param_count(rcfg)
    assert registry.active_param_count(cfg) == \
        ref.registry.active_param_count(rcfg)
    if size == "full":
        assert registry.param_count(cfg) == FULL_PARAMS
        assert registry.active_param_count(cfg) == FULL_ACTIVE


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def test_load_reference_params_round_trips_every_leaf(built, ref):
    """Every reference leaf lands in its module parameter unchanged: the
    stacked `blocks.moe.router` [L, d, E] (f32), `w1` / `w3` [L, E, d,
    f], `w2` [L, E, f, d] in `blocks.<i>.moe.*`, and the rest."""
    cfg, model, _, rparams = built("float32")
    assert isinstance(model, transformer.MoeLM)
    params = dict(model.named_parameters())
    leaves = dict(_leaves(ref.jax.tree.map(np.asarray, rparams)))
    n = 0
    for name, leaf in leaves.items():
        if name.startswith("blocks."):
            for i in range(cfg.n_layers):
                got = params[f"blocks.{i}.{name[len('blocks.'):]}"]
                np.testing.assert_array_equal(got.numpy(), leaf[i], name)
                n += got.numel()
        else:
            np.testing.assert_array_equal(params[name].numpy(), leaf, name)
            n += params[name].numel()
    assert n == sum(p.numel() for p in params.values())
    assert {k.split(".", 2)[2] for k in params if k.startswith("blocks.0.")
            and ".moe." in k} == {"moe.router", "moe.w1", "moe.w3", "moe.w2"}
    assert params["blocks.1.moe.router"].dtype == torch.float32


def test_compute_params_cast_the_router(built):
    """The reference's `_cast_params` casts the stacked router [L, d, E]
    (ndim >= 2) to the compute dtype; `moe_forward` upcasts it."""
    _, model, _, _ = built("bfloat16")
    blk = model.compute_params(torch.bfloat16)["blocks"][0]
    assert set(blk) == {"ln1", "ln2", "attn", "moe"}
    assert {k: v.dtype for k, v in blk["moe"].items()} == dict.fromkeys(
        ("router", "w1", "w3", "w2"), torch.bfloat16)


@pytest.mark.parametrize("case", ["dense_tree_into_moe",
                                  "moe_tree_into_dense"])
def test_load_reference_params_refuses_another_family(built, ref, case):
    """A dense tree and an MoE tree hold other block leaves (`mlp`
    against `moe`): refused either way, before any parameter is written
    (their embed, final_norm and lm_head have equal shapes)."""
    _, _, _, moe_tree = built("float32")
    moe_model = registry.build_model(reduced(get_config(ARCH)),
                                     torch.Generator().manual_seed(0),
                                     device="cpu")
    before = {n: p.clone() for n, p in moe_model.named_parameters()}
    dense_cfg = ref.reduced(ref.config("llama3-8b"))
    target, tree = {
        "dense_tree_into_moe": (moe_model, ref.registry.init_params(
            dense_cfg, ref.jax.random.key(1))),
        "moe_tree_into_dense": (registry.build_model(
            reduced(get_config("llama3-8b")), torch.Generator(),
            device="cpu"), moe_tree)}[case]
    with pytest.raises(ValueError, match="reference blocks hold"):
        registry.load_reference_params(target, ref.jax.tree.map(np.asarray,
                                                                tree))
    assert all(torch.equal(p, before[n])
               for n, p in moe_model.named_parameters())


@pytest.mark.parametrize("cf", [None, 0.5, 2.0])
def test_capacity_equals_reference(ref, cf):
    cfg = get_config(ARCH)
    for small in (False, True):
        c = reduced(cfg) if small else cfg
        rc = ref.reduced(ref.config(ARCH)) if small else ref.config(ARCH)
        ctx = ref.ShardCtx(moe_capacity_factor=cf)
        for T in list(range(0, 70)) + [641, 2564, 2800, 4096]:
            assert moe.capacity(T, c, cf) == ref.moe._capacity(T, rc, ctx), \
                (small, T)
    assert moe.capacity(2564, cfg) == 804 and moe.capacity(2800, cfg) == 876
    assert moe.capacity(4, cfg) == 4


# ----------------------------------------------------------------------
# the MoE layer
# ----------------------------------------------------------------------
# name -> (B, S, dp_size, capacity factor override, shared experts,
# offset): x is a seeded normal plus `offset` in every feature, which
# skews the routing toward the experts the router's column sums favour
# (160 choices over 4 experts of 52 slots at the config's factor)
MOE_CASES = {
    "drops": (2, 40, 1, None, 0, 1.0),
    "no_drops": (2, 40, 1, 4.0, 0, 1.0),
    "decode": (4, 1, 1, None, 0, 0.0),    # T = B = 4, C = 4
    "groups": (2, 40, 2, None, 0, 1.0),   # G = 2 through dp_size
    "cf_override": (2, 24, 1, 0.5, 0, 0.0),
    "shared": (2, 40, 1, None, 1, 0.0),
}


def _moe_setup(ref, case, dtype, seed):
    """(port cfg, ref cfg, port params, ref params (cast), x, jx,
    dp_size, cf) for a case: the reference's init of one layer, cast as
    `_cast_params` casts a stacked block leaf."""
    B, S, dp, cf, shared, offset = MOE_CASES[case]
    jnp = ref.jnp
    cfg = reduced(get_config(ARCH)).replace(dtype=dtype)
    rcfg = ref.reduced(ref.config(ARCH)).replace(dtype=dtype)
    if shared:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  n_shared_experts=shared))
        rcfg = rcfg.replace(moe=dataclasses.replace(rcfg.moe,
                                                    n_shared_experts=shared))
    rp = ref.moe.init_moe_params(ref.layers.KeyGen(ref.jax.random.key(seed)),
                                 rcfg, jnp.float32)
    rp = {k: v.astype(jnp.dtype(dtype)) for k, v in rp.items()}
    pp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        TDT[dtype]) for k, v in rp.items()}
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(B, S, cfg.d_model)) +
                          offset).astype(np.float32)).to(TDT[dtype])
    jx = jnp.asarray(x.float().numpy()).astype(jnp.dtype(dtype))
    return cfg, rcfg, pp, rp, x, jx, dp, cf


def _ref_routing(ref, rp, jx, rcfg, dp, C):
    """The reference's routing, its ops (`moe.py:58-85`) jitted: (probs,
    gates, eidx, pos, keep) as numpy, [G, T_g, ...]."""
    jax, jnp = ref.jax, ref.jnp
    m = rcfg.moe
    B, S, d = jx.shape
    T = B * S
    G = dp if (T % dp == 0 and T >= dp) else 1

    def f(router, x):
        xg = x.reshape(G, T // G, d)
        probs = jax.nn.softmax(xg @ router.astype(jnp.float32), axis=-1)
        gates, eidx = jax.lax.top_k(probs, m.top_k)
        gates = gates / jnp.maximum(jnp.sum(gates, -1, keepdims=True), 1e-9)
        ef = eidx.reshape(G, -1)
        oh = jax.nn.one_hot(ef, m.n_experts, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(oh, axis=1) - 1, ef[..., None],
                                  axis=2)[..., 0]
        keep = (pos < C).reshape(eidx.shape)
        return probs, gates, eidx, pos.reshape(eidx.shape), keep
    return [np.asarray(a) for a in jax.jit(f)(rp["router"], jx)]


def _boundary_ulps(probs, k):
    """The smallest gap, over tokens, between the k-th and (k+1)-th
    largest probability, in f32 ulps of the k-th."""
    s = -np.sort(-probs, axis=-1)
    kth = s[..., k - 1]
    return float(np.min((kth - s[..., k]) / np.spacing(kth)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_reference(ref, case, dtype):
    """`moe_forward` against the reference's on the same parameters and
    x: the routing integers equal, gates / aux / load within 1e-6, y
    within the stated tolerance; the dropping case drops, the others as
    their capacity says."""
    cfg, rcfg, pp, rp, x, jx, dp, cf = _moe_setup(ref, case, dtype, seed=0)
    ctx = ref.ShardCtx(remat="none", moe_capacity_factor=cf)
    y_r, aux_r, load_r = ref.jax.jit(
        lambda p, v: ref.moe.moe_forward(p, v, ctx, rcfg, dp))(rp, jx)
    with torch.no_grad():
        y, aux, load = moe.moe_forward(pp, x, cfg, dp_size=dp,
                                       capacity_factor=cf)
    B, S, d = x.shape
    G = dp
    C = moe.capacity(B * S // G, cfg, cf)
    probs_r, gates_r, eidx_r, pos_r, keep_r = _ref_routing(ref, rp, jx, rcfg,
                                                           dp, C)
    gap = _boundary_ulps(probs_r, cfg.moe.top_k)
    xg = x.reshape(G, -1, d)
    probs, gates, eidx = moe.route(moe.router_logits(xg, pp["router"]),
                                   cfg.moe.top_k)
    pos_c, keep, src = ops.moe_slots(eidx, cfg.moe.n_experts, C)
    msg = f"{case}: the top-k boundary is {gap:.1f} f32 ulps at its closest"
    _assert_inverse(src.numpy(), eidx.numpy(), pos_c.numpy(), keep.numpy())
    np.testing.assert_array_equal(eidx.numpy(), eidx_r, msg)
    np.testing.assert_array_equal(keep.numpy(), keep_r, msg)
    np.testing.assert_array_equal(pos_c.numpy(), np.where(keep_r, pos_r, 0),
                                  msg)
    dropped = int((~keep_r).sum())
    if case in ("drops", "cf_override", "groups"):
        assert dropped > 0
    else:
        assert dropped == 0
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_r),
                               atol=ROUTE_TOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(aux_r), atol=ROUTE_TOL,
                               rtol=0)
    np.testing.assert_allclose(load.numpy(), np.asarray(load_r),
                               atol=ROUTE_TOL, rtol=0)
    g, w = _f32(y), _f32(y_r)
    assert g.shape == w.shape == (B, S, d) and np.isfinite(g).all()
    top = float(np.abs(w).max())
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=Y_F32 * top, rtol=0)
    else:
        np.testing.assert_allclose(g, w, atol=Y_BF16 * top, rtol=0)
        assert np.mean(g != w) <= Y_BF16_APART


def test_ties_follow_lax_top_k(ref):
    """Equal probabilities keep `lax.top_k`'s order, the lower expert
    first: a router with two equal columns routes as the reference's,
    and ties of three and four experts pick as it picks."""
    jax, jnp = ref.jax, ref.jnp
    probs = np.array([[[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                       [0.4, 0.1, 0.4, 0.1], [0.2, 0.3, 0.2, 0.3]]],
                     np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 2)
    top, idx = torch.sort(torch.from_numpy(probs), dim=-1, descending=True,
                          stable=True)
    np.testing.assert_array_equal(idx[..., :2].numpy(), np.asarray(want))
    cfg, rcfg, pp, rp, x, jx, dp, cf = _moe_setup(ref, "drops", "float32",
                                                  seed=1)
    router = np.array(rp["router"])
    router[:, 2] = router[:, 1]
    rp = dict(rp, router=jnp.asarray(router))
    pp = dict(pp, router=torch.from_numpy(router.copy()))
    C = moe.capacity(x.shape[0] * x.shape[1], cfg)
    _, _, eidx_r, _, _ = _ref_routing(ref, rp, jx, rcfg, 1, C)
    _, _, eidx = moe.route(torch.matmul(x.reshape(1, -1, 128).float(),
                                        pp["router"]), 2)
    np.testing.assert_array_equal(eidx.numpy(), eidx_r)
    assert ((eidx_r == 1) | (eidx_r == 2)).any(axis=-1).mean() > 0.25


# ----------------------------------------------------------------------
# the capacity slots (ops.moe_slots)
# ----------------------------------------------------------------------
def _src_of(eidx, pos_c, keep, E, C):
    """The inverse of one group's slots (numpy [T, k]): src [E, C] int32,
    each kept choice's token at its slot, -1 elsewhere; asserts that no
    two kept choices share a slot."""
    t, j = np.nonzero(keep)
    slots = eidx[t, j] * C + pos_c[t, j]
    assert len(np.unique(slots)) == len(slots)
    src = np.full(E * C, -1, np.int32)
    src[slots] = t
    return src.reshape(E, C)


def _assert_inverse(src, eidx, pos_c, keep):
    """src [G, E, C] int32 is the inverse of the slots of eidx / pos_c /
    keep [G, T_g, k], and every dropped choice's pos_c is 0."""
    G, E, C = src.shape
    assert src.dtype == np.int32
    assert (pos_c[~keep] == 0).all()
    for g in range(G):
        np.testing.assert_array_equal(
            src[g], _src_of(eidx[g], pos_c[g], keep[g], E, C))


def _np_slots(eidx, E, C):
    """The slots counted choice by choice in numpy, as the reference
    defines them: (pos_c, keep, src) of eidx [G, T_g, k]."""
    G, Tg, k = eidx.shape
    pos = np.zeros(eidx.shape, np.int64)
    keep = np.zeros(eidx.shape, bool)
    src = np.full((G, E, C), -1, np.int32)
    for g in range(G):
        count = np.zeros(E, np.int64)
        for t in range(Tg):
            for j in range(k):
                e = eidx[g, t, j]
                if count[e] < C:
                    pos[g, t, j], keep[g, t, j] = count[e], True
                    src[g, e, count[e]] = t
                count[e] += 1
    return pos, keep, src


SLOTS_WARPS = 16        # csrc/moe.cu's kSlotsWarps: segments of a chunk
SLOTS_CHUNK = 512       # and kSlotsChunk: choices a block, at least


def _rehearse_slots(eidx, E, C, blocks):
    """moe_slots_kernel's decomposition in numpy, as `moe_slots_launch`
    grids it with `blocks` co-resident blocks: each group's stream cut
    into chunks of SLOTS_CHUNK choices (or a multiple, where the blocks
    fall short), a block a chunk, each chunk into 16 warps' segments; a
    segment walked 32 choices a step, a choice ranked by the warp's
    running count of its expert plus the lanes below it with its expert
    (the ballots' peers, __popc), the count then raised by the step's
    peers; a scan over the warps' counts of each expert for their
    offsets and the block's count; after the grid barrier each block
    sums the earlier blocks' counts and all; the slot the three offsets
    plus the rank; each block's share of the slots past each expert's
    total set to -1."""
    G, Tg, k = eidx.shape
    n = Tg * k
    nb = min(-(-n // SLOTS_CHUNK), blocks // G)
    chunk = -(-(-(-n // nb)) // SLOTS_CHUNK) * SLOTS_CHUNK
    nb = -(-n // chunk)
    seg = chunk // SLOTS_WARPS
    lanes = np.arange(32)
    below = lanes[None, :] < lanes[:, None]          # [lane, other lane]
    pos = np.zeros((G, n), np.int64)
    keep = np.zeros((G, n), bool)
    src = np.empty((G, E, C), np.int32)
    for g in range(G):
        flat = eidx[g].reshape(n)
        cnt = np.zeros((nb, SLOTS_WARPS, E), np.int64)
        rank = np.zeros(n, np.int64)
        for b in range(nb):
            for w in range(SLOTS_WARPS):
                for it in range(seg // 32):
                    i = b * chunk + w * seg + it * 32 + lanes
                    e = np.where(i < n, flat[np.minimum(i, n - 1)], -1)
                    peers = e[:, None] == e[None, :]
                    r = cnt[b, w, np.maximum(e, 0)] + (peers & below).sum(1)
                    ok = e >= 0
                    rank[i[ok]] = r[ok]
                    np.add.at(cnt[b, w], e[ok], 1)
        in_block = np.cumsum(cnt, 1) - cnt              # exclusive, by warp
        per_block = cnt.sum(1)                           # [nb, E]
        before = np.cumsum(per_block, 0) - per_block    # exclusive, by block
        total = per_block.sum(0)
        b_of, w_of = np.arange(n) // chunk, np.arange(n) % chunk // seg
        p = before[b_of, flat] + in_block[b_of, w_of, flat] + rank
        keep[g] = p < C
        pos[g] = np.where(keep[g], p, 0)
        slot = np.arange(C)[None, :]
        src[g] = np.where(slot >= np.minimum(total, C)[:, None], -1, 0)
        src[g][flat[keep[g]], p[keep[g]]] = np.nonzero(keep[g])[0] // k
    return pos.reshape(eidx.shape), keep.reshape(eidx.shape), src


def _experts(rng, G, Tg, k, E, how):
    """Choices' experts [G, T_g, k] int64: `spread` k distinct at random
    a token, `skewed` the top k of a random score tilted toward the high
    experts, `one` every choice on expert 3."""
    if how == "one":
        return np.full((G, Tg, k), 3, np.int64)
    score = rng.normal(size=(G, Tg, E))
    if how == "skewed":
        score = score + np.linspace(0.0, 2.0, E)
    return np.argsort(-score, axis=-1)[..., :k].astype(np.int64)


# name -> (G, T_g, k, E, C, experts): deepseek-v2's 160 experts at k = 6;
# k = 32 (the kernel's widest); every choice on one expert (ranks far
# past C); T_g * k = 111 in each of 2 groups (no multiple of 32); a
# skewed group of 25,600 choices (50 blocks)
SLOT_EDGES = {"e160_k6": (1, 300, 6, 160, 16, "spread"),
              "k32": (1, 100, 32, 64, 40, "spread"),
              "one_expert": (1, 90, 4, 8, 100, "one"),
              "ragged": (2, 37, 3, 5, 20, "spread"),
              "long": (1, 3200, 8, 32, 804, "skewed")}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_slots_plain_version_matches_reference(ref, case, dtype):
    """`ops.moe_slots` on the host (its plain version) on the reference's
    experts: pos and keep equal the reference's jitted count integer for
    integer, and src is their exact inverse."""
    cfg, rcfg, pp, rp, x, jx, dp, cf = _moe_setup(ref, case, dtype, seed=0)
    B, S, _ = x.shape
    C = moe.capacity(B * S // dp, cfg, cf)
    _, _, eidx_r, pos_r, keep_r = _ref_routing(ref, rp, jx, rcfg, dp, C)
    eidx = eidx_r.astype(np.int64)
    pos_c, keep, src = ops.moe_slots(torch.from_numpy(eidx),
                                     cfg.moe.n_experts, C)
    assert (pos_c.dtype, keep.dtype, src.dtype) == (torch.int64, torch.bool,
                                                    torch.int32)
    assert src.shape == (eidx.shape[0], cfg.moe.n_experts, C)
    np.testing.assert_array_equal(keep.numpy(), keep_r)
    np.testing.assert_array_equal(pos_c.numpy(), np.where(keep_r, pos_r, 0))
    _assert_inverse(src.numpy(), eidx, pos_c.numpy(), keep.numpy())


@pytest.mark.parametrize("case", list(SLOT_EDGES))
def test_slots_plain_version_matches_a_count(case):
    """The plain `moe_slots` against a choice-by-choice numpy count at
    the edges the kernel must take."""
    G, Tg, k, E, C, how = SLOT_EDGES[case]
    eidx = _experts(np.random.default_rng(7), G, Tg, k, E, how)
    got = ops.moe_slots(torch.from_numpy(eidx), E, C)
    want = _np_slots(eidx, E, C)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    if case in ("one_expert", "long"):
        assert (~want[1]).any()


# co-resident blocks of the slots kernel: one or four an SM of an H100's
# 132 (four: an SM's 2,048 threads over the kernel's 512), and 4 in all
@pytest.mark.parametrize("blocks", [132, 528, 4],
                         ids=["one_per_sm", "four_per_sm", "few_blocks"])
@pytest.mark.parametrize("case", list(SLOT_EDGES) + ["decode", "prefill"])
def test_slots_kernel_decomposition_rehearsed(case, blocks):
    """`moe_slots_kernel`'s chunks, segments, peer ranks, scans and block
    offsets, rehearsed in numpy, equal the count; also at the serve's
    decode step (T = 4, C = 4: one block) and group 1's prefill (T_g =
    2,564, C = 804: 41 blocks of 512 choices), with one or four blocks
    an SM of an H100 and with only 4 in all (chunks of several steps a
    warp: the ranks parked in pos_c)."""
    G, Tg, k, E, C, how = SLOT_EDGES.get(case) or {
        "decode": (1, 4, 8, 32, 4, "spread"),
        "prefill": (1, 2564, 8, 32, 804, "skewed")}[case]
    eidx = _experts(np.random.default_rng(8), G, Tg, k, E, how)
    for a, b in zip(_rehearse_slots(eidx, E, C, blocks),
                    _np_slots(eidx, E, C)):
        np.testing.assert_array_equal(a, b)


WORKER_WARPS = 4       # csrc/moe.cu's kWorkerWarps: the combine's block


def _token_wpt(nvec):
    """csrc/moe.cu's token_wpt: warps a token for nvec columns."""
    return 4 if nvec > 64 else 2 if nvec > 32 else 1


def _rehearse_combine(ob, eidx, pos_c, keep, gates, blocks, wide=True):
    """moe_combine_kernel's split in torch, as `combine_as` grids it with
    `blocks` co-resident blocks of WORKER_WARPS warps: columns of W
    elements (16 bytes where `wide` and W divides d, else one element),
    `wpt` warps a token, the grid cut to the tokens where they are
    fewer than the groups; group g takes tokens g, g + stride, ..., a
    round at a time, holding the next token's routing beside the
    current one's (the prefetch: lane j < k its choice j's slot row or
    -1 and its gate rounded to the dtype; past the last token -1 and
    0); warp `part` of a group takes columns part * 32 + lane + m * wpt
    * 32, a lane reading choice j's row and gate from lane j (the
    shuffles) and adding its terms choice 0 first, each product and add
    rounded as the kernel rounds them. Returns y and asserts that every
    column of every token is written once."""
    E, C, d = ob.shape
    T, k = eidx.shape
    dt = ob.dtype
    W = 16 // ob.element_size()
    W = W if wide and d % W == 0 else 1
    nvec = d // W
    wpt = _token_wpt(nvec)
    groups = min(T, blocks * WORKER_WARPS // wpt)
    grid = -(-groups * wpt // WORKER_WARPS)
    stride = grid * WORKER_WARPS // wpt
    rnd = (lambda t: t) if dt == torch.float32 else \
        (lambda t: t.to(dt).float())
    rows = ob.reshape(E * C, nvec, W).float()
    lanes = torch.arange(32)

    def route(t):
        live = (t[:, None] < T) & (lanes < k)
        i = t[:, None].clamp(max=T - 1) * k + lanes.clamp(max=k - 1)
        kept = live & keep.reshape(-1)[i]
        row = torch.where(kept, eidx.reshape(-1)[i] * C +
                          pos_c.reshape(-1)[i], -1)
        return row, torch.where(live, rnd(gates.reshape(-1)[i]), 0.0)
    y = torch.full((T, nvec, W), float("nan"))
    writes = torch.zeros((T, nvec), dtype=torch.int64)
    t = torch.arange(stride)
    nxt = route(t)
    while (t < T).any():
        (row, gate), nxt = nxt, route(t + stride)
        live = t < T
        row, gate, tl = row[live], gate[live], t[live]
        for part in range(wpt):
            for c0 in range(part * 32, nvec, wpt * 32):
                c = c0 + lanes
                c = c[c < nvec]
                acc = None
                for j in range(k):
                    r = row[:, j & 31, None]
                    v = torch.where((r >= 0)[..., None],
                                    rows[r.clamp(min=0), c], 0.0)
                    term = rnd(v * gate[:, j & 31, None, None])
                    acc = term if j == 0 else rnd(acc + term)
                y[tl[:, None], c] = acc
                writes[tl[:, None], c] += 1
        t = t + stride
    assert (writes == 1).all()
    return y.reshape(T, d).to(dt)


def _combine_case(T, k, d, dtype, seed):
    """ob [E, C, d] and the routing of T tokens (k distinct experts of E
    = max(8, k + 4) each, a capacity that drops), with a row of -0.0 in
    ob and a gate of 0."""
    E = max(8, k + 4)
    C = max(2, T * k // E // 2)
    rng = np.random.default_rng(seed)
    eidx, pos_c, keep = _routing(rng, T, k, E, C)
    ob = rng.normal(size=(E, C, d)).astype(np.float32)
    ob[0, 0] = -0.0
    gates = rng.random((T, k)).astype(np.float32)
    gates[1, 0] = 0.0
    return (torch.from_numpy(ob).to(TDT[dtype]),
            *(torch.from_numpy(a) for a in (eidx, pos_c, keep, gates)))


# co-resident blocks: 3 (12 warps: every group several tokens, a tail of
# one) and 64 (more groups than the 37 tokens: the grid cut to them)
@pytest.mark.parametrize("blocks", [3, 64], ids=["tail", "cut"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("d", [16, 48, 100, 1024, 2048])
def test_combine_kernel_decomposition_rehearsed(d, k, dtype, blocks):
    """`moe_combine_kernel`'s persistent split (which group takes which
    token across the grid's strides, the prefetched routing, the lanes'
    columns; a tail where T is no multiple of the groups) rehearsed in
    torch equals `moe_combine_ref` bit for bit, drops and -0.0
    included."""
    args = _combine_case(37, k, d, dtype, seed=d + k)
    assert (~args[3]).any() or k == 1
    got = _rehearse_combine(*args, blocks=blocks)
    want = moe_combine_ref(*args)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1024, 2048])
def test_combine_element_path_rehearsed(d, dtype):
    """The element path (ob or y not on 16-byte storage: a lane an
    element) at the serve's width and twice it, k = 8."""
    args = _combine_case(37, 8, d, dtype, seed=d)
    got = _rehearse_combine(*args, blocks=3, wide=False)
    assert torch.equal(_bits(got), _bits(moe_combine_ref(*args)))


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(50, 2, 4, 20, 16), (37, 8, 32, 8, 24),
                                   (30, 6, 160, 1, 8)],
                         ids=["k2", "k8", "e160"])
def test_gather_dispatch_equals_scatter_adds(shape, dtype):
    """The dispatch's plain version, a gather by src, is bit-equal to
    the reference's k scatter-adds (`moe_dispatch_ref`) on a skewed
    routing: drops, empty slots, rows of -0.0 (written +0.0) and
    elements of -0.0."""
    T, k, E, C, d = shape
    rng = np.random.default_rng(5)
    eidx = _experts(rng, 1, T, k, E, "skewed")
    pos_c, keep, src = (a[0] for a in _np_slots(eidx, E, C))
    eidx = eidx[0]
    assert (~keep).any() and (src < 0).any()
    x = rng.normal(size=(T, d)).astype(np.float32)
    x[3] = -0.0
    x[5, :4] = -0.0
    xt = torch.from_numpy(x).to(TDT[dtype])
    got = ops.moe_dispatch(xt, torch.from_numpy(src))
    want = moe_dispatch_ref(xt, *(torch.from_numpy(a)
                                  for a in (eidx, pos_c, keep)), E, C)
    assert got.dtype == want.dtype and got.shape == want.shape == (E, C, d)
    assert np.array_equal(_f32(got).view(np.uint32),
                          _f32(want).view(np.uint32))
    assert not np.signbit(_f32(got)[_f32(got) == 0]).any()


def _ref_loops(ref, k, E, C):
    """The reference's dispatch and combine loops (`moe.py:96-118`) for
    one group, jitted."""
    jax, jnp = ref.jax, ref.jnp

    def dispatch(x, eidx, pos_c, keep):
        buf = jnp.zeros((E, C, x.shape[1]), x.dtype)
        for j in range(k):
            vals = jnp.where(keep[:, j][..., None], x, 0)
            buf = buf.at[eidx[:, j], pos_c[:, j]].add(vals)
        return buf

    def combine(ob, eidx, pos_c, keep, gates):
        y = jnp.zeros((eidx.shape[0], ob.shape[2]), ob.dtype)
        gatesd = gates.astype(ob.dtype)
        for j in range(k):
            yj = ob[eidx[:, j], pos_c[:, j]]
            y = y + jnp.where(keep[:, j][..., None], yj, 0) * \
                gatesd[:, j][..., None]
        return y
    return jax.jit(dispatch), jax.jit(combine)


def _routing(rng, T, k, E, C):
    """Random distinct experts a token, the slots by cumulative count,
    keep where below C (numpy, int64 / bool)."""
    eidx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int64)
    ef = eidx.reshape(-1)
    pos = (np.cumsum(np.eye(E, dtype=np.int64)[ef], 0) - 1)[
        np.arange(T * k), ef].reshape(T, k)
    keep = pos < C
    return eidx, np.where(keep, pos, 0), keep


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(50, 2, 4, 12, 16), (37, 8, 32, 8, 24)],
                         ids=["k2", "k8"])
def test_plain_versions_equal_the_reference_loops(ref, shape, dtype):
    """moe_dispatch_ref, the gather dispatch (`moe_dispatch_gather_ref`,
    by the slots' inverse) and moe_combine_ref against the reference's k
    loops under jit, with drops (C below the load), rows of -0.0 in x
    and ob, and a gate of 0: bit for bit in bf16; in f32 both dispatches
    bit for bit, the combine within an ulp (XLA's FMA contraction)."""
    T, k, E, C, d = shape
    rng = np.random.default_rng(4)
    eidx, pos_c, keep = _routing(rng, T, k, E, C)
    assert (~keep).sum() > 0
    x = rng.normal(size=(T, d)).astype(np.float32)
    x[3] = -0.0
    x[5, :4] = -0.0
    ob = rng.normal(size=(E, C, d)).astype(np.float32)
    ob[eidx[0, 0], pos_c[0, 0]] = -0.0
    gates = rng.random((T, k)).astype(np.float32)
    gates[1, 0] = 0.0
    xt, obt = (torch.from_numpy(a).to(TDT[dtype]) for a in (x, ob))
    jx, job = (ref.jnp.asarray(t.float().numpy()).astype(
        ref.jnp.dtype(dtype)) for t in (xt, obt))
    rt = [torch.from_numpy(a) for a in (eidx, pos_c, keep)]
    dispatch, combine = _ref_loops(ref, k, E, C)
    want = _f32(dispatch(jx, eidx, pos_c, keep))
    got = _f32(moe_dispatch_ref(xt, *rt, E, C))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.signbit(got[got == 0]).any()
    gathered = _f32(moe_dispatch_gather_ref(xt, torch.from_numpy(
        _src_of(eidx, pos_c, keep, E, C))))
    assert np.array_equal(gathered.view(np.uint32), want.view(np.uint32))
    want = _f32(combine(job, eidx, pos_c, keep, gates))
    got = _f32(moe_combine_ref(obt, *rt, torch.from_numpy(gates)))
    if dtype == "bfloat16":
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    else:
        # a product rounded before the add where XLA's FMA keeps it
        # exact: within k f32 ulps of the terms' absolute sum
        terms = sum(np.abs(np.where(keep[:, j, None], ob.reshape(E * C, d)[
            eidx[:, j] * C + pos_c[:, j]], 0) * gates[:, j, None])
            for j in range(k))
        assert (np.abs(got - want) <= k * 2.0 ** -23 * terms).all()


def test_dispatch_plain_version_writes_rows_and_zeros():
    """The dispatch's buffer holds each kept choice's row at its slot
    and zeros elsewhere; the combine of ones and one-gates sums the
    kept choices' rows."""
    rng = np.random.default_rng(2)
    T, k, E, C, d = 30, 2, 4, 10, 8
    eidx, pos_c, keep = _routing(rng, T, k, E, C)
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    rt = [torch.from_numpy(a) for a in (eidx, pos_c, keep)]
    _, _, src = ops.moe_slots(rt[0][None], E, C)
    buf = ops.moe_dispatch(x, src[0])
    filled = np.zeros((E, C), bool)
    for t in range(T):
        for j in range(k):
            if keep[t, j]:
                assert torch.equal(buf[eidx[t, j], pos_c[t, j]], x[t])
                filled[eidx[t, j], pos_c[t, j]] = True
    assert not buf[torch.from_numpy(~filled)].any()
    y = ops.moe_combine(buf, *rt, torch.ones((T, k)))
    want = x * torch.from_numpy(keep.sum(1, keepdims=True)).float()
    torch.testing.assert_close(y, want, atol=1e-6, rtol=1e-6)


def _wrapper_inputs(T=6, k=2, E=4, C=4, d=8, dtype=torch.float32):
    """(x, eidx, pos_c, keep, src) of one group, on the host."""
    rng = np.random.default_rng(0)
    eidx, pos_c, keep = _routing(rng, T, k, E, C)
    return (torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32)).to(
        dtype), torch.from_numpy(eidx), torch.from_numpy(pos_c),
        torch.from_numpy(keep), torch.from_numpy(_src_of(eidx, pos_c, keep,
                                                         E, C)))


@pytest.mark.parametrize("case", ["x_int", "x_1d", "src_int64", "src_float",
                                  "src_3d", "src_device", "src_contig",
                                  "contig", "zero_experts", "zero_capacity",
                                  "type", "device"])
def test_dispatch_wrapper_rejects_bad_inputs(case):
    x, _, _, _, src = _wrapper_inputs()
    if case == "x_int":
        x = x.to(torch.int32)
    elif case == "x_1d":
        x = x[0]
    elif case == "src_int64":
        src = src.long()
    elif case == "src_float":
        src = src.float()
    elif case == "src_3d":
        src = src[None]
    elif case == "src_device":
        src = src.to("meta")
    elif case == "src_contig":
        src = torch.cat([src, src], 1)[:, ::2]
    elif case == "contig":
        x = x.t().contiguous().t()
    elif case == "zero_experts":
        src = src[:0]
    elif case == "zero_capacity":
        src = src[:, :0]
    elif case == "type":
        x = x.numpy()
    elif case == "device":
        x, src = x.to("meta"), src.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.moe_dispatch(x, src)


@pytest.mark.parametrize("case", ["eidx_int32", "eidx_2d", "k_wide",
                                  "no_tokens", "zero_experts",
                                  "experts_wide", "zero_capacity", "contig",
                                  "type", "device"])
def test_slots_wrapper_rejects_bad_inputs(case):
    """`ops.moe_slots` refuses what its kernel does not take: int64
    [G, T_g, k] contiguous with 1 <= k <= 32, 1 <= E <= 256, C >= 1, on
    the card or the host (E = 256 and k = 32 pass)."""
    _, eidx, _, _, _ = _wrapper_inputs()
    eidx, E, C = eidx[None], 4, 4
    if case == "eidx_int32":
        eidx = eidx.int()
    elif case == "eidx_2d":
        eidx = eidx[0]
    elif case == "k_wide":
        eidx = eidx.repeat(1, 1, 17)
    elif case == "no_tokens":
        eidx = eidx[:, :0]
    elif case == "zero_experts":
        E = 0
    elif case == "experts_wide":
        E = 257
    elif case == "zero_capacity":
        C = 0
    elif case == "contig":
        eidx = eidx.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "type":
        eidx = eidx.numpy()
    elif case == "device":
        eidx = eidx.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.moe_slots(eidx, E, C)
    ops.moe_slots(torch.zeros((1, 3, 32), dtype=torch.int64), 256, 4)


# the combine's routing checks (ops._check_routing): each case breaks one
# of them and must be refused by it, with its message naming the routing
ROUTING_CASES = ("eidx_int32", "pos_int32", "keep_u8", "pos_shape",
                 "keep_shape", "eidx_rows", "k_wide", "k_zero",
                 "routing_device")


@pytest.mark.parametrize("case", ["ob_2d", "gates_bf16", "gates_shape",
                                  "no_tokens", "ob_int", *ROUTING_CASES])
def test_combine_wrapper_rejects_bad_inputs(case):
    """`ops.moe_combine` refuses what its kernel does not take: ob a
    float [E, C, d], gates f32 of eidx's shape, and the routing eidx /
    pos_c int64 and keep bool, each [T, k] with 1 <= k <= 32 and
    T >= 1, on ob's device."""
    x, eidx, pos_c, keep, _ = _wrapper_inputs()
    ob, gates = torch.ones((4, 4, 8)), torch.ones(eidx.shape)
    if case == "ob_2d":
        ob = ob[0]
    elif case == "gates_bf16":
        gates = gates.bfloat16()
    elif case == "gates_shape":
        gates = gates[:, :1].contiguous()
    elif case == "no_tokens":
        eidx, pos_c, keep, gates = (t[:0] for t in (eidx, pos_c, keep, gates))
    elif case == "ob_int":
        ob = ob.long()
    elif case == "eidx_int32":
        eidx = eidx.int()
    elif case == "pos_int32":
        pos_c = pos_c.int()
    elif case == "keep_u8":
        keep = keep.to(torch.uint8)
    elif case == "pos_shape":
        pos_c = pos_c[:, :1].contiguous()
    elif case == "keep_shape":
        keep = keep[:-1].contiguous()
    elif case == "eidx_rows":
        eidx = eidx[:-1].contiguous()
    elif case == "k_wide":
        eidx, pos_c, keep, gates = (t.repeat(1, 17)
                                    for t in (eidx, pos_c, keep, gates))
    elif case == "k_zero":
        eidx, pos_c, keep, gates = (t[:, :0].contiguous()
                                    for t in (eidx, pos_c, keep, gates))
    elif case == "routing_device":
        eidx, pos_c, keep = (t.to("meta") for t in (eidx, pos_c, keep))
    match = r"eidx|pos_c|keep|meta" if case in ROUTING_CASES else None
    with pytest.raises((TypeError, ValueError), match=match):
        ops.moe_combine(ob, eidx, pos_c, keep, gates)
    if case == "k_wide":      # k = 32, the kernel's widest, is taken
        eidx, pos_c, keep, gates = (t[:, :32].contiguous()
                                    for t in (eidx, pos_c, keep, gates))
        assert ops.moe_combine(ob, eidx, pos_c, keep, gates).shape == x.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_count_no_launch_on_cpu(dtype):
    x, eidx, _, _, _ = _wrapper_inputs(dtype=dtype)
    names = ("moe_slots", "moe_dispatch", "moe_combine")
    before = [getattr(ops, n).launches for n in names]
    pos_c, keep, src = ops.moe_slots(eidx[None], 4, 4)
    buf = ops.moe_dispatch(x, src[0])
    y = ops.moe_combine(buf, eidx, pos_c[0], keep[0], torch.rand(eidx.shape))
    assert buf.shape == (4, 4, 8) and y.shape == x.shape
    assert buf.dtype == y.dtype == dtype
    assert [getattr(ops, n).launches for n in names] == before


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def test_lm_forward_matches_reference_f32(built, ref):
    cfg, model, rcfg, rparams = built("float32")
    toks = _tokens(cfg, 2, 64, seed=0)
    want = np.asarray(ref.transformer.lm_forward(
        rparams, ref.jnp.asarray(toks), rcfg, ref.ctx)[0], np.float32)
    got = transformer.lm_forward(model, torch.from_numpy(toks).long(),
                                 cfg).numpy()
    np.testing.assert_allclose(got, want, **MODEL_F32)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_lm_forward_matches_reference_bf16(built, ref):
    cfg, model, rcfg, rparams = built("bfloat16")
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(built, ref, dtype):
    """Prefill of 20 tokens into a 48-slot cache, then 12 decode steps,
    each routing its B = 2 tokens with a capacity of 4: the last logits
    and every layer's k / v each step."""
    cfg, model, rcfg, rparams = built(dtype)
    toks = _tokens(cfg, 2, 32, seed=1)
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
    tol = MODEL_F32 if dtype == "float32" else dict(atol=BF16_ATOL, rtol=0)
    for t in range(S0, 32 + 1):
        np.testing.assert_allclose(_f32(plog), _f32(rlog), **tol)
        tree = transformer.stack_cache(pcache)
        for name in ("k", "v"):
            np.testing.assert_allclose(_f32(tree["blocks"][name]),
                                       _f32(rcache["blocks"][name]), **tol)
        if t == 32:
            break
        rlog, rcache = rdecode(rparams, rcache,
                               ref.jnp.asarray(toks[:, t:t + 1]),
                               ref.jnp.int32(t))
        plog, pcache = registry.decode_fn(cfg)(
            model, pcache, torch.from_numpy(toks[:, t:t + 1]).long(), t)


def test_moe_entry_points_need_s_max_and_pos(built):
    cfg, model, _, _ = built("float32")
    toks = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="S_max"):
        registry.prefill_fn(cfg)(model, toks)
    _, cache = registry.prefill_fn(cfg, 8)(model, toks)
    with pytest.raises(ValueError, match="pos"):
        registry.decode_fn(cfg)(model, cache, toks[:, :1])


LENGTHS, MAX_NEW = (5, 23, 40), 8


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_serve_ids_equal_reference(built, ref, dtype):
    """Three requests of 8 new tokens over two groups of a batch-2
    engine, left-padded with token 0 (the pads route and take capacity
    like any token, as in the reference). f32: the served ids are the
    reference's. bf16: every step's logits agree within BF16_ATOL while
    a request's ids agree, and its ids agree to the end unless at some
    step the reference's own top-2 gap is no wider than twice the
    port's distance from it."""
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


def test_serve_cli_runs_moe_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--requests", "3", "--batch", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"{ARCH} on cpu: 3 requests, 9 tokens" in out


def test_moe_trains_and_its_prologue_still_refuses(built):
    """The MoE family serves and trains: `registry.loss_fn`,
    `transformer.lm_loss` (a finite loss with its aux loss and expert
    load, gradients in the router and the experts) and the train CLI
    take it; MLA and MoE's leading dense layers still raise "not yet
    ported" everywhere (`tests/test_torch_moe_train.py` holds the
    training against the reference)."""
    cfg, model, _, _ = built("float32")
    batch = {"tokens": torch.ones((1, 4), dtype=torch.long),
             "targets": torch.ones((1, 4), dtype=torch.long)}
    tree = tree_map(lambda t: t.detach().clone().requires_grad_(),
                    transformer.param_tree(model))
    loss, metrics = registry.loss_fn(cfg)(tree, batch)
    loss.backward()
    assert torch.isfinite(loss) and float(metrics["aux"].detach()) > 0
    assert abs(float(metrics["expert_load"].sum()) - cfg.n_layers) < 1e-6
    assert tree["blocks"][0]["moe"]["router"].grad.abs().sum() > 0
    assert tree["blocks"][1]["moe"]["w2"].grad.abs().sum() > 0
    loss2, _ = transformer.lm_loss(transformer.param_tree(model), batch, cfg)
    assert float(loss2) == float(loss)
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "1", "--batch", "2", "--seq", "8"])
    prologue = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   first_dense_layers=1))
    for bad in (prologue, reduced(get_config("llama3-8b")).replace(
            family="moe")):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            registry.build_model(bad, torch.Generator(), device="cpu")
        with pytest.raises(NotImplementedError, match="not yet ported"):
            registry.prefill_fn(bad)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            registry.loss_fn(bad)


def test_engine_on_cpu_counts_no_launch(built):
    """On the host the wrappers take the plain versions and count no
    launch (the `cuda` case counts the card's: one slots, one dispatch
    and one combine a layer a step)."""
    cfg, model, _, _ = built("bfloat16")
    names = ("moe_slots", "moe_dispatch", "moe_combine")
    before = [getattr(ops, n).launches for n in names]
    eng = Engine(cfg, model, ServeConfig(batch=2, s_max=32), device="cpu")
    eng.serve(_requests(cfg, (3, 5), 2, Request))
    assert [getattr(ops, n).launches for n in names] == before


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the MoE dispatch and combine "
                    "kernels have no CPU mode")
    return torch.device("cuda")


# name -> (T, k, E, C, d): the serve's prefill of group 1 (4 x 641
# tokens) and decode step at full width, a dropping capacity, an odd T,
# a row of 100 bf16 (200 bytes: the element path) and a reduced layer;
# the combine's persistent grid's edges: one token, one token more than
# its groups hold (T None: found on the card), k = 32, d = 2,048, and ob
# and x on storage one element past 16-byte alignment (the element path)
CARD_SHAPES = {"prefill": (2564, 8, 32, 804, 1024),
               "decode": (4, 8, 32, 4, 1024),
               "drops": (2564, 8, 32, 400, 1024),
               "ragged": (2563, 8, 32, 804, 1024),
               "narrow": (37, 8, 32, 12, 100),
               "reduced": (80, 2, 4, 52, 128),
               "one_token": (1, 8, 32, 4, 1024),
               "groups_plus_one": (None, 8, 32, 804, 1024),
               "k32": (300, 32, 40, 200, 1024),
               "d2048": (300, 8, 32, 64, 2048),
               "unaligned": (37, 8, 32, 12, 1024)}


def _card_shape(shape, dtype=torch.bfloat16):
    """CARD_SHAPES[shape], T found on the card where it is None: one more
    than the combine's token groups at that d and dtype."""
    T, k, E, C, d = CARD_SHAPES[shape]
    if T is None:
        T = moe_lib.combine_workers(d, dtype) + 1
    return T, k, E, C, d


def _unaligned(t):
    """A copy of t on storage one element past 16-byte alignment."""
    store = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = store[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_card_kernels_equal_plain(card, shape, dtype):
    """`ops.moe_dispatch` (by the plain slots' src) and `ops.moe_combine`
    (one launch each) equal their plain versions bit for bit on the
    card, and the reference's k scatter-adds (`moe_dispatch_ref`), -0.0
    rows included; two calls equal."""
    T, k, E, C, d = _card_shape(shape, dtype)
    rng = np.random.default_rng(11)
    eidx, pos_c, keep = _routing(rng, T, k, E, C)
    if shape == "drops":
        assert (~keep).sum() > 0
    x = rng.normal(size=(T, d)).astype(np.float32)
    x[min(1, T - 1)] = -0.0
    gates = rng.random((T, k)).astype(np.float32)
    rt = [torch.from_numpy(a).to(card) for a in (eidx, pos_c, keep)]
    src = torch.from_numpy(_src_of(eidx, pos_c, keep, E, C)).to(card)
    xt = torch.from_numpy(x).to(card, dtype)
    g = torch.from_numpy(gates).to(card)
    if shape == "unaligned":
        xt = _unaligned(xt)
    before = (ops.moe_dispatch.launches, ops.moe_combine.launches)
    buf = ops.moe_dispatch(xt, src)
    ob = buf * 1.5 - 0.25
    ob[0, 0] = -0.0
    if shape == "unaligned":
        ob = _unaligned(ob)
    y = ops.moe_combine(ob, *rt, g)
    assert (ops.moe_dispatch.launches, ops.moe_combine.launches) == \
        (before[0] + 1, before[1] + 1)
    want_y = moe_combine_ref(ob, *rt, g)
    torch.cuda.synchronize()
    for got, want in ((buf, moe_dispatch_gather_ref(xt, src)),
                      (buf, moe_dispatch_ref(xt, *rt, E, C)), (y, want_y)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int32))
    assert torch.equal(ops.moe_dispatch(xt, src), buf)
    assert torch.equal(ops.moe_combine(ob, *rt, g), y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SLOT_EDGES) + list(CARD_SHAPES) +
                         ["many_groups"])
def test_card_slots_equal_plain(card, case):
    """`ops.moe_slots` (one launch) equals its plain version integer for
    integer on the card, at the edges, the serve's shapes (skewed
    experts, as the serve's left pads route) and 64 groups of 8,000
    choices (each group's share of the co-resident blocks too few for a
    step a warp); two calls equal."""
    if case == "many_groups":
        G, Tg, k, E, C, how = 64, 1000, 8, 32, 250, "skewed"
    elif case in SLOT_EDGES:
        G, Tg, k, E, C, how = SLOT_EDGES[case]
    else:
        (Tg, k, E, C, _), G, how = _card_shape(case), 1, "skewed"
    eidx = torch.from_numpy(_experts(np.random.default_rng(9), G, Tg, k, E,
                                     how)).to(card)
    before = ops.moe_slots.launches
    got = ops.moe_slots(eidx, E, C)
    assert ops.moe_slots.launches == before + 1
    want = moe_slots_ref(eidx, E, C)
    again = ops.moe_slots(eidx, E, C)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_card_serves_as_the_host(card):
    """The reduced MoE in f32 on the card (the kernels) and on the host
    with the same weights: the prefill's and 8 decode steps' logits
    within 1e-3, the ids equal; one `moe_slots`, `moe_dispatch`,
    `moe_combine` and `silu_gate` a layer a step, one `flash_fwd` a
    layer a prefill."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(ARCH)).replace(dtype="float32")
    card_model = registry.build_model(cfg, torch.Generator(card).manual_seed(0),
                                      card)
    host_model = transformer.MoeLM(cfg, torch.device("cpu"), torch.float32)
    host_model.load_state_dict(card_model.state_dict())
    sc = ServeConfig(batch=2, s_max=64)
    engines = [Engine(cfg, card_model, sc), Engine(cfg, host_model, sc,
                                                   device="cpu")]
    names = ("moe_slots", "moe_dispatch", "moe_combine", "silu_gate",
             "flash_fwd")
    before = {n: getattr(ops, n).launches for n in names}
    outs, logits = [], []
    for eng in engines:
        reqs = _requests(cfg, LENGTHS[:2], MAX_NEW, Request)
        outs.append(eng.serve(reqs))
        logits.append(eng.last_logits.float().cpu().numpy())
    torch.cuda.synchronize()
    steps = 1 + MAX_NEW
    assert {n: getattr(ops, n).launches - before[n] for n in names} == {
        "moe_slots": steps * cfg.n_layers,
        "moe_dispatch": steps * cfg.n_layers,
        "moe_combine": steps * cfg.n_layers,
        "silu_gate": steps * cfg.n_layers, "flash_fwd": cfg.n_layers}
    np.testing.assert_allclose(logits[0], logits[1], atol=1e-3, rtol=1e-3)
    assert outs[0] == outs[1]
