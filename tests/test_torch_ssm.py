"""The port's Mamba-2 SSD path against the JAX reference.

The kernel level: the same seeded numpy inputs go through the
reference's `repro.kernels.ops.ssd_chunk` (its Pallas body in interpret
mode on the CPU, as `tests/test_kernels.py` runs it) and the port's
`ops.ssd_chunk` (its plain version for CPU tensors). Both compute in
f32 from the stored dtype and differ only in the order of their sums:
atol/rtol 1e-5 (2.6e-6 measured at Q=256, N=128). The model level:
`ssd_chunked`, the causal conv and the Mamba-2 block (full sequence,
prefill cache and one decode step) in f32, within the same 1e-5.

The kernel's arithmetic: on the card, bf16 inputs go through the
tensor cores, with each f32 operand (the decayed scores, the decayed x
of the states) split into bf16 hi and lo halves. `_hilo_chunk` repeats
that arithmetic on the CPU and is held to the plain version within the
card's 1e-4 before any chip time is spent.

The reference is imported by a fixture, so the card-only cases (marked
`cuda`) run where jax is not installed:
``python -m pytest -q -m cuda tests/test_torch_ssm.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels import ops
from repro_torch.kernels.ref import chunk_cumsum, ssd_chunk_ref
from repro_torch.models import registry, ssm, transformer

TOL = dict(atol=1e-5, rtol=1e-5)
# the shapes of tests/test_kernels.py, and the full-width chunk
SHAPES = [(16, 8, 8, 16), (32, 16, 16, 24), (64, 8, 32, 32),
          (256, 8, 64, 128)]


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: jnp, its kernel wrappers and its SSM module."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.configs.base import reduced as ref_reduced
    from repro.kernels import ops as ref_ops
    from repro.models import ssm as ref_ssm
    from repro.models.layers import KeyGen, ShardCtx
    from repro.models.transformer import _ssm_prefill_cache
    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=ref_ops, ssm=ref_ssm,
                                 config=ref_config, reduced=ref_reduced,
                                 KeyGen=KeyGen, ctx=ShardCtx(remat="none"),
                                 prefill_cache=_ssm_prefill_cache)


def _chunk_inputs(B, nC, Q, H, P, N, seed, decay=0.1):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, nC, Q, H, P)) * 0.1).astype(np.float32),
            (rng.normal(size=(B, nC, Q, N)) * 0.3).astype(np.float32),
            (rng.normal(size=(B, nC, Q, N)) * 0.3).astype(np.float32),
            (-np.abs(rng.normal(size=(B, nC, H, Q))) * decay).astype(
                np.float32))


def _torch_inputs(arrays, dtype, device="cpu"):
    xq, Bq, Cq, da = (torch.from_numpy(a).to(device) for a in arrays)
    return xq.to(dtype), Bq.to(dtype), Cq.to(dtype), da


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "Q{}H{}P{}N{}".format(*s))
def test_ssd_chunk_matches_reference(ref, shape, dtype):
    Q, H, P, N = shape
    arrays = _chunk_inputs(2, 2, Q, H, P, N, seed=Q + H)
    jdt = getattr(ref.jnp, dtype)
    xq, Bq, Cq, da = (ref.jnp.asarray(a) for a in arrays)
    yr, sr = ref.ops.ssd_chunk(xq.astype(jdt), Bq.astype(jdt),
                               Cq.astype(jdt), da)
    before = ops.ssd_chunk.launches
    y, st = ops.ssd_chunk(*_torch_inputs(arrays, getattr(torch, dtype)))
    assert ops.ssd_chunk.launches == before          # plain version
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (2, 2, Q, H, P) and st.shape == (2, 2, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), **TOL)


def _scan_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, S, H, P)) * 0.1).astype(np.float32),
            (rng.normal(size=(B, S, N)) * 0.3).astype(np.float32),
            (rng.normal(size=(B, S, N)) * 0.3).astype(np.float32),
            (-np.abs(rng.normal(size=(B, S, H))) * 0.1).astype(np.float32),
            (rng.normal(size=(B, H, P, N)) * 0.2).astype(np.float32))


# (S, chunk, with init_state): whole chunks; a padded tail; one short
# chunk (Q = S); a carried-in state with a padded tail
SCANS = [(64, 16, False), (53, 16, False), (10, 16, False), (53, 16, True)]


@pytest.mark.parametrize("S,chunk,init", SCANS,
                         ids=lambda v: str(v))
def test_ssd_chunked_matches_reference(ref, S, chunk, init):
    xh, Bc, Cc, da, s0 = _scan_inputs(2, S, 4, 8, 16, seed=S)
    yr, fr = ref.ssm.ssd_chunked(
        *(ref.jnp.asarray(a) for a in (xh, Bc, Cc, da)), chunk,
        init_state=ref.jnp.asarray(s0) if init else None)
    y, final = ssm.ssd_chunked(
        *(torch.from_numpy(a) for a in (xh, Bc, Cc, da)), chunk,
        init_state=torch.from_numpy(s0) if init else None)
    assert y.shape == (2, S, 4, 8) and final.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(fr), **TOL)


def test_ssd_chunked_bf16_matches_reference(ref):
    """bf16 in, bf16 out: both compute in f32 and round y once, so a
    value may land one bf16 step (2^-8 relative) apart."""
    xh, Bc, Cc, da, _ = _scan_inputs(2, 53, 4, 8, 16, seed=7)
    bf = ref.jnp.bfloat16
    yr, fr = ref.ssm.ssd_chunked(ref.jnp.asarray(xh).astype(bf),
                                 ref.jnp.asarray(Bc).astype(bf),
                                 ref.jnp.asarray(Cc).astype(bf),
                                 ref.jnp.asarray(da), 16)
    y, final = ssm.ssd_chunked(torch.from_numpy(xh).bfloat16(),
                               torch.from_numpy(Bc).bfloat16(),
                               torch.from_numpy(Cc).bfloat16(),
                               torch.from_numpy(da), 16)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(yr, np.float32),
                               atol=1e-5, rtol=2 ** -7)
    np.testing.assert_allclose(final.numpy(), np.asarray(fr), **TOL)


@pytest.mark.parametrize("Q", [1, 31, 32, 33, 256, 300])
def test_chunk_cumsum_is_a_cumsum(Q):
    """The kernel-order scan sums what `torch.cumsum` sums: equal to the
    f64 cumulative sum within f32 rounding of the running total."""
    da = -torch.from_numpy(np.random.default_rng(Q).uniform(
        0, 5, (3, 2, Q)).astype(np.float32))
    got = chunk_cumsum(da)
    want = torch.cumsum(da.double(), dim=-1)
    assert got.shape == da.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=Q * 2e-7,
                               atol=0)


# ----------------------------------------------------------------------
# the card kernel's arithmetic, rehearsed on the CPU
# ----------------------------------------------------------------------
def _hilo(v: torch.Tensor):
    """v (f32) as bf16 hi + lo: hi = bf16(v), lo = bf16(v - hi)."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _hilo_chunk(xq, Bq, Cq, da, split=True):
    """What the bf16 card kernel computes: C B^T from bf16 inputs (exact
    products, f32 sums); the decayed scores and the decayed x of the
    states split into bf16 hi and lo, each half multiplied by the bf16
    operand with f32 sums, the two products added. With split=False,
    the hi halves alone (one bf16 rounding of each f32 operand)."""
    x, Bf, Cf = xq.float(), Bq.float(), Cq.float()
    Q = xq.shape[2]
    cum = chunk_cumsum(da.float())
    seg = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.exp(torch.where(tri, seg, -1e30))
    scores = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)[:, :, None] * L
    y = sum(torch.einsum("bchqk,bckhp->bcqhp", half, x)
            for half in _hilo(scores)[:2 if split else 1])
    dec = torch.exp(cum[..., -1:] - cum)
    xw = x.permute(0, 1, 3, 2, 4) * dec[..., None]
    st = sum(torch.einsum("bchkp,bckn->bchpn", half, Bf)
             for half in _hilo(xw)[:2 if split else 1])
    return y, st


@pytest.mark.parametrize("decay", [0.1, 3.0])
def test_hilo_split_holds_the_card_tolerance(decay):
    """At the serve widths (Q=256, P=64, N=128; 8 heads) in bf16: the
    split drops under 2^-18 of each operand, so the kernel's arithmetic
    stays within the card's atol/rtol 1e-4 of the plain version."""
    args = _torch_inputs(_chunk_inputs(1, 2, 256, 8, 64, 128, seed=11,
                                       decay=decay), torch.bfloat16)
    y, st = _hilo_chunk(*args)
    yp, sp = ssd_chunk_ref(*args)
    np.testing.assert_allclose(y.numpy(), yp.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.numpy(), sp.numpy(), atol=1e-4, rtol=1e-4)
    # one bf16 rounding of each f32 operand would not
    y1, st1 = _hilo_chunk(*args, split=False)
    assert (y1 - yp).abs().max() > 1e-4 and (st1 - sp).abs().max() > 1e-4


def _reduced_prefill_inputs(device, S=53, seed=0):
    """The reduced mamba2-2.7b's (bf16 compute) layer-0 `ssd_chunked`
    inputs of a prefill of S random tokens at batch 2, captured from
    `lm_forward` on `device`; weights from a seeded generator."""
    cfg = reduced(get_config("mamba2-2.7b"))
    model = registry.build_model(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab, (2, S))).to(device)
    seen, real = [], ssm.ssd_chunked

    def capture(*args):
        if not seen:
            seen.append(tuple(t.clone() if isinstance(t, torch.Tensor)
                              else t for t in args))
        return real(*args)

    ssm.ssd_chunked = capture
    try:
        transformer.lm_forward(model, tokens, cfg)
    finally:
        ssm.ssd_chunked = real
    return seen[0]


def _chunks_of(xh, Bc, Cc, da, chunk):
    """`ssd_chunked`'s own cut of its inputs into ssd_chunk's (its
    `ops.ssd_chunk` call's arguments, through `ops.ssd_chunk_ad` with no
    gradient to take), via a capturing `ops.ssd_chunk`."""
    seen = []

    def capture(*args):
        seen.append(args)
        return ssd_chunk_ref(*args)

    real, ops.ssd_chunk = ops.ssd_chunk, capture
    try:
        ssm.ssd_chunked(xh, Bc, Cc, da, chunk)
    finally:
        ops.ssd_chunk = real
    return seen[0]


def test_hilo_split_on_the_reduced_model():
    """The same rehearsal on the reduced model's captured bf16 prefill
    inputs (its layer 0, batch 2, 53 tokens in chunks of 16)."""
    xh, Bc, Cc, da, chunk = _reduced_prefill_inputs(torch.device("cpu"))
    assert xh.dtype == torch.bfloat16
    args = _chunks_of(xh, Bc, Cc, da, chunk)
    y, st = _hilo_chunk(*args)
    yp, sp = ssd_chunk_ref(*args)
    np.testing.assert_allclose(y.numpy(), yp.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.numpy(), sp.numpy(), atol=1e-4, rtol=1e-4)


def test_causal_conv_matches_reference(ref):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    want = ref.ssm._causal_conv(*(ref.jnp.asarray(a) for a in (x, w, b)))
    got = ssm._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def block(ref):
    """One reduced Mamba-2 block's reference parameters (f32), with
    random conv bias, D and norm so that every parameter matters."""
    cfg = reduced(get_config("mamba2-2.7b")).replace(dtype="float32")
    rcfg = ref.reduced(ref.config("mamba2-2.7b")).replace(dtype="float32")
    p = ref.ssm.init_ssm_params(ref.KeyGen(ref.jax.random.key(3)), rcfg,
                                ref.jnp.float32)
    rng = np.random.default_rng(3)
    p = {k: np.array(v) for k, v in p.items()}
    for k in ("conv_b", "D", "norm"):
        p[k] = (p[k] + rng.normal(size=p[k].shape) * 0.3).astype(np.float32)
    return cfg, rcfg, p


def test_ssm_block_matches_reference(ref, block):
    """Full sequence, the prefill cache and one decode step."""
    cfg, rcfg, p = block
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 37, cfg.d_model))).astype(np.float32)
    x1 = (rng.normal(size=(2, 1, cfg.d_model))).astype(np.float32)
    jp = {k: ref.jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}

    want = ref.ssm.ssm_forward(jp, ref.jnp.asarray(x), ref.ctx, rcfg)
    got, cache = ssm.ssm_forward(tp, torch.from_numpy(x), cfg,
                                 return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    rcache = ref.prefill_cache(jp, ref.jnp.asarray(x), rcfg, ref.ctx)
    for k in ("conv", "state"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]),
                                   **TOL)
    spec = ssm.ssm_cache_spec(cfg, 2, torch.float32)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == spec

    want_d, rnew = ref.ssm.ssm_decode(jp, rcache, ref.jnp.asarray(x1), rcfg,
                                      ref.ctx)
    got_d, new = ssm.ssm_decode(tp, cache, torch.from_numpy(x1), cfg)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)
    for k in ("conv", "state"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(rnew[k]),
                                   **TOL)


def test_short_prompt_conv_cache_is_zero_padded(block):
    """A prompt shorter than the conv's K-1 inputs: the cache holds the
    causal conv's zero padding in front (the reference's slice would be
    short and its decode would fail)."""
    cfg, _, p = block
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 2, cfg.d_model)).astype(np.float32))
    _, cache = ssm.ssm_forward(tp, x, cfg, return_cache=True)
    assert cache["conv"].shape == (1, cfg.ssm.d_conv - 1,
                                   ssm.ssm_dims(cfg)[2])
    assert torch.all(cache["conv"][:, 0] == 0)
    # the decode step after it equals the full forward over 3 tokens
    x3 = torch.cat([x, x[:, :1]], dim=1)
    full = ssm.ssm_forward(tp, x3, cfg)
    step, _ = ssm.ssm_decode(tp, cache, x3[:, 2:], cfg)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 2].numpy(),
                               **TOL)


# ----------------------------------------------------------------------
# card-only: the CUDA kernel against its plain version
# ----------------------------------------------------------------------
# the serve shape's chunk (Q=256, H=80, P=64, N=128); ragged Q over
# several q-tiles (and two windows of C B^T tiles); the reduced model's
# chunk; narrow odd widths; heads that fill no whole group of the bf16
# kernel's 8 (12, and 13 with N = 24 padded to 32); the hybrid's served
# chunk (`zamba2-2.7b`: N = 64, padded to the bf16 kernel's 128)
CARD = [(256, 80, 64, 128), (300, 4, 64, 128), (16, 16, 16, 16),
        (53, 3, 8, 24), (128, 12, 64, 128), (256, 13, 64, 24),
        (256, 80, 64, 64)]


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [0.1, 3.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nC", [(1, 1), (4, 3)])
@pytest.mark.parametrize("shape", CARD,
                         ids=lambda s: "Q{}H{}P{}N{}".format(*s))
def test_ssd_kernel_matches_plain_on_card(card, shape, B, nC, dtype, decay):
    """atol/rtol 1e-4: both take the cumulative decay in the same order
    (`chunk_cumsum`), and the kernel's products and sums run in another
    order (bf16: tensor-core sums of hi/lo halves; f32: FMAs over 64-row
    tiles) than the plain version's. A log-decay scale of 3 sums to
    ~-600 over a chunk, as the served model's do."""
    Q, H, P, N = shape
    args = _torch_inputs(_chunk_inputs(B, nC, Q, H, P, N, seed=Q,
                                       decay=decay),
                         getattr(torch, dtype), card)
    before = ops.ssd_chunk.launches
    y, st = ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ops.ssd_chunk.launches == before + 1
    yp, sp = ssd_chunk_ref(*args)
    np.testing.assert_allclose(y.cpu().numpy(), yp.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.cpu().numpy(), sp.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_positive_log_decay_on_card(card, dtype):
    """Log-decays of either sign (growth as well as decay): the causal
    mask is applied before exp, as the plain version applies it, so a
    positive exponent of a causal pair is kept; atol/rtol 1e-4."""
    rng = np.random.default_rng(5)
    arrays = list(_chunk_inputs(2, 2, 128, 12, 64, 128, seed=5))
    arrays[3] = (rng.normal(size=arrays[3].shape) * 0.05).astype(np.float32)
    args = _torch_inputs(arrays, getattr(torch, dtype), card)
    y, st = ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    yp, sp = ssd_chunk_ref(*args)
    assert (args[3] > 0).any()
    np.testing.assert_allclose(y.cpu().numpy(), yp.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.cpu().numpy(), sp.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_ssd_chunked_kernel_matches_plain_on_card(card):
    """`ssd_chunked` on the reduced model's bf16 prefill inputs (layer 0,
    captured on the card): through the kernel on the card against the
    plain path on the host. y is bf16, rounded once from f32 sums in
    another order (one bf16 step, 2^-7 relative); the final state f32
    within 1e-4."""
    xh, Bc, Cc, da, chunk = _reduced_prefill_inputs(card)
    assert xh.dtype == torch.bfloat16 and xh.device.type == "cuda"
    before = ops.ssd_chunk.launches
    y, final = ssm.ssd_chunked(xh, Bc, Cc, da, chunk)
    torch.cuda.synchronize()
    assert ops.ssd_chunk.launches == before + 1
    yp, fp = ssm.ssd_chunked(*(t.cpu() for t in (xh, Bc, Cc, da)), chunk)
    assert y.dtype == yp.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().cpu().numpy(), yp.float().numpy(),
                               atol=1e-4, rtol=2 ** -7)
    np.testing.assert_allclose(final.cpu().numpy(), fp.numpy(), atol=1e-4,
                               rtol=1e-4)
