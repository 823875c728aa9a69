"""The Mamba-2 block's backwards against the JAX reference, on the CPU,
and the backward kernels against their plain versions on the card.

The reference has no backward kernel: it differentiates its jnp
`ssd_chunked` (`src/repro/models/ssm.py:59`) and `jax.nn.silu` with
XLA, so the oracle of each new backward is `jax.vjp` of the
reference's function. Inputs are made with numpy from a seed.

Tolerances, each with its reason:
- `ssd_chunk_bwd_ref` against `torch.autograd.grad` through
  `ssd_chunk_ref`: 1e-5 of each output's max |g| (f32; the same
  function, its products summed in other orders: 6.6e-7 measured at
  Q = 256).
- The port's `ssd_chunked` gradient (x, B, C, da and the carried-in
  state; cotangents on y and the final state) against `jax.vjp` of the
  reference's: 1e-4 of each output's max |g| (f32; the reference sums
  the cumulative decay with `jnp.cumsum`, the port in the kernel's
  order).
- `silu_bwd_ref` and `silu_gate_prod_bwd_ref` against the jitted
  `jax.vjp` (of `jax.nn.silu`, and of the gate's value and f32 product):
  bf16 bit-equal, special values included but for a subnormal logistic
  (XLA's CPU program flushes it to zero; see SPECIALS); f32 within 1e-6
  of the largest |grad| (XLA's exp and the host's differ in the last
  bit in a quarter of the elements, 1.7e-7 of the largest measured).
- The gated norm `rms_norm(y * silu(z), scale)` as a whole, (dy, dz,
  dscale) against `jax.vjp` of the reference's: f32 within 1e-6 of each
  one's max |g| (3.1e-7 measured). In bf16 it cannot be bit-equal:
  XLA's program sums the norm's d inv in bf16 with a rounding after
  every add (windows of 32 features), torch in f32, and the variance
  path's cotangent of a whole row scales with it. That rounding is
  not the gate's (the gate's backward is bit-equal above); the
  elements that differ are printed and held within BF16_NORM_TOL, four
  bf16 steps (2^-5) of each one's max |g| (measured here: ~5% of dy
  and dz differ, by up to 6.0e-3 of the max; dscale 1.1e-2; 2^-6 in dz
  on another seed).

Card-only tests carry the `cuda` marker and the `card` fixture and
import no jax: ``python -m pytest -q -m cuda tests/test_torch_ssm_train.py``.
"""
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ssd_scan
from repro_torch.kernels.ref import (chunk_cumsum, reverse_cumsum,
                                     silu_bwd_ref, silu_gate_prod_bwd_ref,
                                     ssd_chunk_bwd_ref, ssd_chunk_ref)
from repro_torch.models import ssm

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# test_torch_ssm.py's SHAPES: (Q, H, P, N), the last the full-width chunk
SHAPES = [(16, 8, 8, 16), (32, 16, 16, 24), (64, 8, 32, 32),
          (256, 8, 64, 128)]
REF_TOL = 1e-5           # of max |g|: plain backward vs autograd
SCAN_TOL = 1e-4          # of max |g|: ssd_chunked vs jax.vjp
SILU_F32_TOL = 1e-6      # of max |g|: f32 SiLU backwards vs XLA
BF16_NORM_TOL = 2.0 ** -5
CARD_TOL = 1e-4          # of max |g|: kernel vs plain (sum order)
# the SiLU inputs' special values: signed zeros, saturating logistics,
# exp overflowing, infinities and NaN; and -88, whose logistic is
# subnormal (6e-39): XLA's CPU program flushes it to zero, the port (as
# torch's and CUDA's arithmetic) keeps it, in the forward `silu` as in
# its gradient, so -88 is held against the plain version on the card
# only
SPECIALS = [0.0, -0.0, 1e-3, -1e-3, 30.0, -30.0, 88.0, 100.0, -100.0,
            1e4, -1e4, float("inf"), float("-inf"), float("nan")]
SUBNORMAL_LOGISTIC = -88.0


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: jax, jnp, its SSM module and `rms_norm`."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as ref_layers
    from repro.models import ssm as ref_ssm
    return types.SimpleNamespace(jax=jax, jnp=jnp, ssm=ref_ssm,
                                 layers=ref_layers)


def _chunk_inputs(B, nC, Q, H, P, N, seed, signed=False):
    """ssd_chunk's inputs and the two cotangents, f32 numpy; `signed`
    log-decays take both signs (growth as well as decay)."""
    rng = np.random.default_rng(seed)
    da = rng.normal(size=(B, nC, H, Q))
    da = da * 0.05 if signed else -np.abs(da) * 0.1
    return [a.astype(np.float32) for a in (
        rng.normal(size=(B, nC, Q, H, P)) * 0.1,
        rng.normal(size=(B, nC, Q, N)) * 0.3,
        rng.normal(size=(B, nC, Q, N)) * 0.3, da,
        rng.normal(size=(B, nC, Q, H, P)),
        rng.normal(size=(B, nC, H, P, N)))]


def _as_torch(arrays, dtype, device="cpu"):
    """(xq, Bq, Cq in dtype; da, dy, dst f32) on device."""
    ts = [torch.from_numpy(a).to(device) for a in arrays]
    return [t.to(dtype) for t in ts[:3]] + ts[3:]


def _close(got, want, tol, what, rtol=0.0):
    got = got.detach().float().cpu().numpy()
    want = want.detach().float().cpu().numpy()
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=tol * np.abs(want).max(), err_msg=what)


# ----------------------------------------------------------------------
# the SSD chunk's backward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "Q{}H{}P{}N{}".format(*s))
def test_ssd_chunk_bwd_ref_matches_autograd(shape):
    Q, H, P, N = shape
    x, Bq, Cq, da, dy, dst = (torch.from_numpy(a) for a in _chunk_inputs(
        2, 2, Q, H, P, N, seed=Q + H))
    ins = [t.clone().requires_grad_() for t in (x, Bq, Cq, da)]
    y, st = ssd_chunk_ref(*ins)
    want = torch.autograd.grad((y * dy).sum() + (st * dst).sum(), ins)
    before = ops.ssd_chunk_bwd.launches
    got = ops.ssd_chunk_bwd(x, Bq, Cq, da, dy, dst)
    assert ops.ssd_chunk_bwd.launches == before          # plain version
    for name, g, w in zip(("dx", "dB", "dC", "dda"), got, want):
        assert g.dtype == torch.float32
        _close(g, w, REF_TOL, name)


def _pieces(v, n=2):
    """v (f32) as n bf16 pieces: hi = bf16(v), then bf16 of what is left
    (each difference exact in f32), as f32 tensors."""
    out = []
    for _ in range(n):
        out.append(v.bfloat16().float())
        v = v - out[-1]
    return out


def _hilo_bwd(xq, Bq, Cq, da, dy, dst, split=True,
              heads=ssd_scan.BWD_HEADS):
    """What the bf16 card kernels compute: every product of a bf16 and an
    f32 operand as two bf16 products (the f32 one split hi / lo), of two
    f32 operands (S^T dy) as three (hi.hi + hi.lo + lo.hi), each with f32
    sums; dG and r o (x dst) summed over each group of `heads` heads,
    then over the groups; E's row sums per 64-row k-tile, then over the
    k-tiles. With split=False, the hi pieces alone (one bf16 rounding of
    each f32 operand)."""
    n = 2 if split else 1
    x, Bf, Cf = xq.float(), Bq.float(), Cq.float()
    Q, H = xq.shape[2], xq.shape[3]
    cum = chunk_cumsum(da.float())
    seg = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.exp(torch.where(tri, seg, -1e30))              # [B,nC,H,Q,Q]
    S = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)[:, :, None] * L
    dS = torch.where(tri, sum(torch.einsum("bcqhp,bckhp->bchqk", d, x)
                              for d in _pieces(dy, n)), 0.0)
    r = torch.exp(cum[..., -1:] - cum)                       # [B,nC,H,Q]
    dsts = _pieces(dst, n)
    bdst = sum(torch.einsum("bckn,bchpn->bchkp", Bf, d) for d in dsts)
    Sp, dyp = _pieces(S, n), _pieces(dy, n)
    pairs = [(0, 0), (0, 1), (1, 0)] if split else [(0, 0)]
    dx = sum(torch.einsum("bchqk,bcqhp->bckhp", Sp[i], dyp[j])
             for i, j in pairs) + \
        (r[..., None] * bdst).permute(0, 1, 3, 2, 4)
    rxp = _pieces(r.permute(0, 1, 3, 2)[..., None] * x, n)
    xdst = sum(torch.einsum("bckhp,bchpn->bchkn", rxp[i], dsts[j])
               for i, j in pairs)                            # [B,nC,H,Q,N]
    groups = range(0, H, heads)
    dG = sum((dS * L)[:, :, g:g + heads].sum(2) for g in groups)
    xsum = sum(xdst[:, :, g:g + heads].sum(2) for g in groups)
    dGp = _pieces(dG, n)
    dB = sum(torch.einsum("bcqk,bcqn->bckn", d, Cf) for d in dGp) + xsum
    dC = sum(torch.einsum("bcqk,bckn->bcqn", d, Bf) for d in dGp)
    E = dS * S
    rowE = sum(E[..., k:k + 64].sum(-1) for k in range(0, Q, 64))
    rho = r * (x.permute(0, 1, 3, 2, 4) * bdst).sum(-1)
    dcum = rowE - E.sum(-2) - rho
    dcum[..., -1] += rho.sum(-1)
    return (dx.to(xq.dtype), dB.to(Bq.dtype), dC.to(Cq.dtype),
            reverse_cumsum(dcum))


def _tol_shares(got, want):
    """Per output, the largest share of the card's tolerance (CARD_TOL
    of its max |g|; bf16 outputs also one bf16 step)."""
    out = {}
    for name, g, w in zip(("dx", "dB", "dC", "dda"), got, want):
        g, w = g.float(), w.float()
        rtol = 2.0 ** -7 if name != "dda" else 0.0
        atol = CARD_TOL * w.abs().max()
        out[name] = float(((g - w).abs() / (atol + rtol * w.abs())).max())
    return out


@pytest.mark.parametrize("signed", [False, True], ids=["decay", "signed"])
def test_hilo_bwd_split_holds_the_card_tolerance(signed):
    """At the train widths (Q=256, P=64, N=128; 16 heads: two groups) in
    bf16, the card kernels' arithmetic (`_hilo_bwd`) stays within the
    card's tolerance of the plain version, dda (f32, no rtol: a
    difference of sums of E) within a quarter of it, so two bf16 pieces
    of dy suffice for dS; one bf16 rounding of each f32 operand would
    not hold dx or dda."""
    args = _as_torch(_chunk_inputs(1, 2, 256, 16, 64, 128, seed=5,
                                   signed=signed), torch.bfloat16)
    want = ssd_chunk_bwd_ref(*args)
    shares = _tol_shares(_hilo_bwd(*args), want)
    assert max(shares.values()) <= 1.0 and shares["dda"] <= 0.25, shares
    hi_only = _tol_shares(_hilo_bwd(*args, split=False), want)
    assert hi_only["dx"] > 1.0 and hi_only["dda"] > 1.0, hi_only


def test_bwd_kernel_names_are_the_library_kernels():
    """Every name in `ssd_scan.KERNELS` (which chip_smoke.py reports and
    profiles by) is a __global__ of csrc/ssd_chunk.cu, and each backward
    kernel's name starts with `ssd_bwd_` (a train profile's
    `ssd_chunk_bwd` kind)."""
    src = (Path(ssd_scan.__file__).resolve().parents[1] / "csrc" /
           "ssd_chunk.cu").read_text()
    found = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\("
                           r"[^)]*\)\s+)?(\w+)\s*\(", src))
    assert set(ssd_scan.KERNELS) <= found, found
    assert ssd_scan.BWD_KERNELS and all(
        n.startswith("ssd_bwd_") for n in ssd_scan.BWD_KERNELS)
    assert set(ssd_scan.BWD_TC_KERNELS) <= set(ssd_scan.BWD_KERNELS)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_bwd_scratch_at_the_train_shape(bf16):
    """The f32 scratch `launch_bwd` allocates (`ssd_scan.bwd_scratch`) at
    the train shape (B=4, nC=4, Q=256, H=80, N=128): under 100 MB for
    bf16 inputs (the heads' sums kept on chip: 55.1 MB), every head's
    dS o L and r o (x dst) for f32 inputs (507.5 MB)."""
    shapes = ssd_scan.bwd_scratch(4, 4, 256, 80, 128, bf16)
    nbytes = 4 * sum(int(np.prod(s)) for s in shapes.values())
    if bf16:
        assert list(shapes) == ["dG", "xdst", "rowE", "colE", "rho"]
        assert nbytes == 55_050_240 and nbytes < 100e6
    else:
        assert list(shapes) == ["cb", "dGh", "dB2h"]
        assert nbytes == 507_510_784
    # a ragged shape: the last tile and the last head group partial
    s = ssd_scan.bwd_scratch(1, 2, 200, 13, 128, True)
    assert s["dG"] == (2, 2, 10, 4096) and s["rowE"] == (2, 13, 4, 200)


def _scan_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.normal(size=(B, S, H, P)) * 0.1, rng.normal(size=(B, S, N)) * 0.3,
        rng.normal(size=(B, S, N)) * 0.3,
        -np.abs(rng.normal(size=(B, S, H))) * 0.1,
        rng.normal(size=(B, H, P, N)) * 0.2,
        rng.normal(size=(B, S, H, P)), rng.normal(size=(B, H, P, N)))]


# (S, chunk, with init_state): whole chunks; a padded tail; one short
# chunk (Q = S); a carried-in state with a padded tail
SCANS = [(64, 16, False), (53, 16, False), (10, 16, False), (53, 16, True)]


@pytest.mark.parametrize("S,chunk,init", SCANS, ids=lambda v: str(v))
def test_ssd_chunked_grads_match_reference(ref, S, chunk, init):
    """The gradient through `ssm.ssd_chunked` (the `_SsdChunk` Function,
    its backward the plain version, the inter-chunk loop and the
    off-diagonal product by autograd) against `jax.vjp` of the
    reference's `ssd_chunked`."""
    xh, Bc, Cc, da, s0, gy, gfin = _scan_inputs(2, S, 4, 8, 16, seed=S)
    n_in = 5 if init else 4

    def f(*a):
        return ref.ssm.ssd_chunked(*a[:4], chunk,
                                   init_state=a[4] if init else None)

    def value_and_vjp(cot, *a):
        out, vjp = ref.jax.vjp(f, *a)
        return out[0], vjp(cot)
    yr, want = ref.jax.jit(value_and_vjp)(
        (ref.jnp.asarray(gy), ref.jnp.asarray(gfin)),
        *(ref.jnp.asarray(a) for a in (xh, Bc, Cc, da, s0)[:n_in]))
    ins = [torch.from_numpy(a).requires_grad_() for a in
           (xh, Bc, Cc, da, s0)[:n_in]]
    before = (ops.ssd_chunk.launches, ops.ssd_chunk_bwd.launches)
    y, final = ssm.ssd_chunked(*ins[:4], chunk,
                               init_state=ins[4] if init else None)
    assert y.grad_fn is not None
    got = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() +
        (final * torch.from_numpy(gfin)).sum(), ins)
    assert (ops.ssd_chunk.launches, ops.ssd_chunk_bwd.launches) == before
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yr),
                               atol=1e-5, rtol=1e-5)
    for name, g, w in zip(("x", "B", "C", "da", "init_state"), got, want):
        _close(g, torch.from_numpy(np.asarray(w)), SCAN_TOL, name)


# ----------------------------------------------------------------------
# the SiLU backwards and the gated norm
# ----------------------------------------------------------------------
def _silu_inputs(seed, subnormal=False):
    """(x with SPECIALS in its first row, and SUBNORMAL_LOGISTIC where
    `subnormal`, g, y, g_prod), f32 numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 1024)) * 4).astype(np.float32)
    x[0, :len(SPECIALS)] = SPECIALS
    if subnormal:
        x[1, 0] = SUBNORMAL_LOGISTIC
    g, y = (rng.standard_normal((64, 1024)).astype(np.float32)
            for _ in range(2))
    gp = (rng.standard_normal((64, 1024)) * 0.3).astype(np.float32)
    return x, g, y, gp


def _check_silu(got, want, dtype, what):
    assert got.dtype == TDT[dtype], what
    got = got.float().numpy()
    want = np.asarray(want.astype("float32"))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        ok = np.isfinite(want)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                      err_msg=what)
        np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                                   atol=SILU_F32_TOL * np.abs(want[ok]).max(),
                                   err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_bwd_matches_reference(ref, dtype):
    """`ops.silu_ad`'s gradient (backward `silu_bwd`'s plain version)
    against the jitted `jax.vjp(jax.nn.silu)`."""
    x, g, _, _ = _silu_inputs(6)
    jdt = ref.jnp.dtype(dtype)

    def vjp(a, b):
        _, f = ref.jax.vjp(ref.jax.nn.silu, a)
        return f(b)[0]
    want = ref.jax.jit(vjp)(*(ref.jnp.asarray(a).astype(jdt) for a in (x, g)))
    xt = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    before = ops.silu_bwd.launches
    ops.silu_ad(xt).backward(torch.from_numpy(g).to(TDT[dtype]))
    assert ops.silu_bwd.launches == before               # plain version
    _check_silu(xt.grad, want, dtype, "dx")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_gate_prod_bwd_matches_reference(ref, dtype):
    """`silu_gate_prod_bwd_ref` against the jitted `jax.vjp` of the
    gate's two outputs, (p, p as f32) with p = y * silu(z), given a
    value cotangent in y's dtype and an f32 product cotangent: XLA
    rounds the f32 one to the dtype, adds and rounds the sum, as in its
    program of the whole gated norm (`csrc/silu.cu`'s head comment)."""
    z, g, y, gp = _silu_inputs(7)
    jdt = ref.jnp.dtype(dtype)

    def vjp(a, b, gv, gq):
        def f(yy, zz):
            p = yy * ref.jax.nn.silu(zz)
            return p, p.astype(ref.jnp.float32)
        _, fn = ref.jax.vjp(f, a, b)
        return fn((gv, gq))
    want = ref.jax.jit(vjp)(*(ref.jnp.asarray(a).astype(jdt)
                              for a in (y, z, g)), ref.jnp.asarray(gp))
    got = silu_gate_prod_bwd_ref(
        *(torch.from_numpy(a).to(TDT[dtype]) for a in (g,)),
        torch.from_numpy(gp),
        *(torch.from_numpy(a).to(TDT[dtype]) for a in (y, z)))
    for name, a, w in zip(("dy", "dz"), got, want):
        _check_silu(a, w, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_norm_grads_match_reference(ref, dtype):
    """`ssm.gated_rms_norm` (the `_SsmGate` Function and the port's
    `rms_norm`) against `jax.vjp` of the reference's
    `rms_norm(y * jax.nn.silu(z), scale)`: (dy, dz, dscale)."""
    rng = np.random.default_rng(8)
    z = (rng.standard_normal((64, 1024)) * 4).astype(np.float32)
    y, g = (rng.standard_normal((64, 1024)).astype(np.float32)
            for _ in range(2))
    sc = (1 + 0.3 * rng.standard_normal(1024)).astype(np.float32)
    jdt = ref.jnp.dtype(dtype)

    def vjp(a, b, c, gg):
        _, f = ref.jax.vjp(lambda yy, zz, s: ref.layers.rms_norm(
            yy * ref.jax.nn.silu(zz), s, 1e-5), a, b, c)
        return f(gg)
    want = ref.jax.jit(vjp)(*(ref.jnp.asarray(a).astype(jdt)
                              for a in (y, z, sc, g)))
    ts = [torch.from_numpy(a).to(TDT[dtype]).requires_grad_()
          for a in (y, z, sc)]
    before = ops.silu_gate_prod_bwd.launches
    ssm.gated_rms_norm(*ts, 1e-5).backward(
        torch.from_numpy(g).to(TDT[dtype]))
    assert ops.silu_gate_prod_bwd.launches == before     # plain version
    for name, t, w in zip(("dy", "dz", "dscale"), ts, want):
        got, w = t.grad.float().numpy(), np.asarray(w.astype("float32"))
        tol = SILU_F32_TOL if dtype == "float32" else BF16_NORM_TOL
        if dtype == "bfloat16":
            print(f"gated norm bf16 {name}: {np.mean(got != w):.4f} of the "
                  f"elements differ, max |diff| "
                  f"{np.abs(got - w).max() / np.abs(w).max():.3e} of max |g|")
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=tol * np.abs(w).max(), err_msg=name)


# ----------------------------------------------------------------------
# the wrappers on the host
# ----------------------------------------------------------------------
def test_backward_wrappers_check_their_inputs():
    """Each backward wrapper refuses what its kernel does not take."""
    x, Bq, Cq, da, dy, dst = (torch.from_numpy(a) for a in _chunk_inputs(
        1, 1, 16, 2, 8, 16, seed=1))
    with pytest.raises(TypeError, match="dy must be float32"):
        ops.ssd_chunk_bwd(x, Bq, Cq, da, dy.double(), dst)
    with pytest.raises(ValueError, match="dst must be"):
        ops.ssd_chunk_bwd(x, Bq, Cq, da, dy, dst[..., :8])
    with pytest.raises(ValueError, match="dy must be contiguous"):
        ops.ssd_chunk_bwd(x, Bq, Cq, da,
                          dy.transpose(3, 4).contiguous().transpose(3, 4),
                          dst)
    a = torch.ones((4, 8))
    with pytest.raises(ValueError, match="g must match x"):
        ops.silu_bwd(a.bfloat16(), a)
    with pytest.raises(ValueError, match="g_prod must be"):
        ops.silu_gate_prod_bwd(a, a.bfloat16(), a, a)
    with pytest.raises(ValueError, match="z must match y"):
        ops.silu_gate_prod_bwd(a, a, a, a[:, :4])


def test_ad_ops_are_the_plain_calls_without_grad():
    """Serving takes no gradient: the `_ad` ops (always the Functions)
    return the forward wrappers' values with no autograd node; under
    grad their backwards take the plain versions on the host."""
    x, Bq, Cq, da, _, _ = (torch.from_numpy(a) for a in _chunk_inputs(
        1, 1, 16, 2, 8, 16, seed=2))
    z = torch.randn(3, 8)
    with torch.inference_mode():
        outs = [*ops.ssd_chunk_ad(x, Bq, Cq, da), ops.silu_ad(z),
                *ops.silu_gate_ad(z, z)]
        plain = [*ops.ssd_chunk(x, Bq, Cq, da), ops.silu(z),
                 *ops.silu_gate(z, z)]
    assert all(t.grad_fn is None for t in outs)
    for got, want in zip(outs, plain):
        assert torch.equal(got, want)
    zg = z.clone().requires_grad_()
    assert type(ops.silu_ad(zg).grad_fn).__name__ == "_SiluBackward"
    v, p = ops.silu_gate_ad(zg, zg)
    assert type(v.grad_fn).__name__ == "_SsmGateBackward"
    assert v.data_ptr() != p.data_ptr()           # two outputs in f32 too
    y, st = ops.ssd_chunk_ad(x.requires_grad_(), Bq, Cq, da)
    assert type(y.grad_fn).__name__ == "_SsdChunkBackward"


# ----------------------------------------------------------------------
# card-only: the backward kernels against their plain versions
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# the train shape (B=4, nC=4 chunks of 256, 80 heads, P=64, N=128);
# SHAPES at B=2, nC=2; a ragged Q over two tiles with odd widths; full
# widths with a ragged Q over four tiles and a partial head group; and
# Q over five tiles (the bf16 kernels' C B^T no longer kept on chip);
# the hybrid's train shape (N=64: the bf16 kernels' B / C tiles padded
# to 128 columns) and a ragged one at N=64
CARD_SHAPES = [(4, 4, 256, 80, 64, 128)] + \
    [(2, 2) + s for s in SHAPES] + [(2, 3, 83, 3, 8, 24),
                                    (1, 2, 200, 13, 64, 128),
                                    (1, 1, 320, 9, 64, 128),
                                    (4, 4, 256, 80, 64, 64),
                                    (1, 3, 200, 13, 64, 64)]


def check_ssd_bwd(got, want, dtype):
    """dx, dB, dC within CARD_TOL of each one's max |g| (bf16: also one
    bf16 step, 2^-7 relative: both round f32 sums taken in other orders
    once), dda (f32) within CARD_TOL of its max."""
    for name, g, w in zip(("dx", "dB", "dC", "dda"), got, want):
        assert g.dtype == w.dtype, name
        rtol = 2.0 ** -7 if dtype == torch.bfloat16 and name != "dda" \
            else 0.0
        _close(g, w, CARD_TOL, name, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True], ids=["decay", "signed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=lambda s: "B{}C{}Q{}H{}P{}N{}".format(*s))
def test_ssd_chunk_bwd_kernel_matches_plain_on_card(card, shape, dtype,
                                                    signed):
    """The kernels against `ssd_chunk_bwd_ref` on the same card
    inputs, log-decays of one sign (decay) or both (growth too, as
    `test_ssd_kernel_positive_log_decay_on_card`); a second call gives
    the same bits."""
    args = _as_torch(_chunk_inputs(*shape, seed=sum(shape), signed=signed),
                     TDT[dtype], card)
    before = ops.ssd_chunk_bwd.launches
    got = ops.ssd_chunk_bwd(*args)
    again = ops.ssd_chunk_bwd(*args)
    torch.cuda.synchronize()
    assert ops.ssd_chunk_bwd.launches == before + 2
    check_ssd_bwd(got, ssd_chunk_bwd_ref(*args), TDT[dtype])
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def _card_silu_inputs(dtype, card):
    """x, g, y, g_prod on the card, x with SPECIALS, and z a strided
    view (a slice of a wider tensor, as the in-projection hands it)."""
    x, g, y, gp = _silu_inputs(9, subnormal=True)
    wide = torch.zeros((64, 3072), dtype=TDT[dtype], device=card)
    wide[:, 1024:2048] = torch.from_numpy(x).to(TDT[dtype])
    return (wide[:, 1024:2048],
            *(torch.from_numpy(a).to(TDT[dtype]).to(card) for a in (g, y)),
            torch.from_numpy(gp).to(card))


def _bits_equal(a, b):
    a, b = a.cpu(), b.cpu()
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_backward_kernels_bit_equal_on_card(card, dtype):
    """`silu_bwd` (x strided and dense) and `silu_gate_prod_bwd` (z
    strided) bit-equal to their plain versions, special values (NaN's
    bits included) and all."""
    z, g, y, gp = _card_silu_inputs(dtype, card)
    before = (ops.silu_bwd.launches, ops.silu_gate_prod_bwd.launches)
    for x in (z, z.contiguous()):
        assert _bits_equal(ops.silu_bwd(g, x), silu_bwd_ref(g, x))
    got = ops.silu_gate_prod_bwd(g, gp, y, z)
    want = silu_gate_prod_bwd_ref(g, gp, y, z)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    assert (ops.silu_bwd.launches, ops.silu_gate_prod_bwd.launches) == \
        (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_bwd_scratch_matches_the_library(card):
    """`ssd_scan.bwd_scratch`, by which the wrapper allocates, gives the
    sizes the library's kernels index (`ssd_chunk_bwd_scratch_floats`)."""
    lib = ssd_scan._lib()
    for B, nC, Q, H, N in ((4, 4, 256, 80, 128), (4, 4, 256, 80, 64),
                           (1, 2, 200, 13, 128),
                           (2, 3, 83, 3, 24), (1, 1, 4096, 9, 16)):
        for bf16 in (True, False):
            sizes = [int(np.prod(s)) for s in ssd_scan.bwd_scratch(
                B, nC, Q, H, N, bf16).values()]
            sizes += [0] * (5 - len(sizes))
            assert sizes == [lib.ssd_chunk_bwd_scratch_floats(
                int(bf16), B * nC, Q, H, N, i) for i in range(5)]


@pytest.mark.cuda
def test_autograd_functions_launch_once_per_backward(card):
    """Each `_ad` op's forward launches its forward kernel once and its
    backward its backward kernel once (bf16, the train dtype)."""
    x, Bq, Cq, da, _, _ = _as_torch(_chunk_inputs(1, 2, 64, 4, 16, 32, 3),
                                    torch.bfloat16, card)
    ins = [t.requires_grad_() for t in (x, Bq, Cq, da)]
    z = torch.randn((8, 256), device=card).bfloat16().requires_grad_()
    names = ("ssd_chunk", "ssd_chunk_bwd", "silu", "silu_bwd", "silu_gate",
             "silu_gate_prod_bwd")
    before = {n: getattr(ops, n).launches for n in names}
    y, st = ops.ssd_chunk_ad(*ins)
    s = ops.silu_ad(z)
    v, p = ops.silu_gate_ad(s, z)
    loss = y.sum() + st.sum() + v.float().sum() + p.sum()
    loss.backward()
    torch.cuda.synchronize()
    assert {n: getattr(ops, n).launches - before[n] for n in names} == \
        dict.fromkeys(names, 1)
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all()
               for t in ins + [z])


@pytest.mark.cuda
def test_layer_grads_on_card_match_host(card):
    """One reduced Mamba-2 layer's parameter gradients (bf16 compute,
    f32 parameters) through the kernels on the card against the plain
    versions on the host, from the same weights and input: within 2^-6
    of each leaf's max |g| (bf16 roundings of sums taken in other
    orders)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    cfg = reduced(get_config("mamba2-2.7b")).replace(n_layers=1)
    gen = torch.Generator().manual_seed(0)
    mixer = ssm.Mamba2Mixer(cfg, torch.float32, torch.device("cpu"))
    mixer.reset_parameters(gen)
    x = torch.randn((2, 40, cfg.d_model), generator=gen).bfloat16()
    grads = {}
    for dev in ("cpu", card):
        p = {k: v.detach().to(dev).requires_grad_()
             for k, v in mixer.named_parameters()}
        out = ssm.ssm_forward({k: v.bfloat16() for k, v in p.items()},
                              x.to(dev), cfg)
        out.float().square().mean().backward()
        grads[str(dev)] = {k: v.grad.cpu() for k, v in p.items()}
    for k, w in grads["cpu"].items():
        _close(grads[str(card)][k], w, 2.0 ** -6, k)
