"""The port's SiLU gates (`ops.silu`, `ops.silu_gate`, and the SwiGLU
gate's gradient `ops.silu_gate_bwd`) against the JAX reference.

The JAX package has no kernel for them: its Mamba-2 block calls
`jax.nn.silu`, and XLA on the CPU expands the logistic to
1 / (1 + exp(-x)) with each op rounded to the compute dtype. The same
seeded numpy inputs go through the jitted reference and the port's
wrappers on the CPU (their plain versions, `ref.silu_ref` and
`ref.silu_gate_ref`). In bf16, the serve model's dtype, they are
bit-equal: the silu, the gated product, and the reference's
`rms_norm(y * silu(z), scale)` against the port's `ssm.gated_rms_norm`.
In f32 XLA's exp and the host's differ in the last bits: atol/rtol
2e-6 (about 1e-7 relative measured).

The gate's gradient (`ref.silu_gate_bwd_ref` on the CPU) is held to
`jax.vjp` of the reference in `tests/test_torch_train.py`; here its
wrapper's layouts and checks.

Over the whole bf16 domain: `silu_ref` on all 65,536 bf16 inputs and
`silu_bwd_ref` on them at four cotangents against the jitted reference.
They differ exactly where XLA's CPU program flushes a subnormal (an
input, or an op's f32 value, to zero): the test computes that set
itself, as the chain of rounded ops with and without the flush, and
the bits are equal everywhere else.

The card cases (marker `cuda`) hold the CUDA kernels (csrc/silu.cu) to
the plain versions bit for bit, at the serve model's shapes and at
shapes that take the scalar path (odd widths, rows that start
unaligned), one launch a call; and `ops.silu` on all 65,536 bf16 inputs
in six layouts, `ops.silu_bwd` on them at 64 cotangents spread over the
exponents and on every (g, x) pair of bf16 values: the sweeps that
license the kernels' cheaper arithmetic (the bf16x2 ops, the
approximate reciprocal). The reference is imported by a fixture, so
they run where jax is not installed:
``python -m pytest -q -m cuda tests/test_torch_silu.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import silu as silu_kernel
from repro_torch.kernels.ref import (silu_bwd_ref, silu_gate_bwd_ref,
                                     silu_gate_ref, silu_ref)
from repro_torch.models import ssm

F32_TOL = dict(atol=2e-6, rtol=2e-6)
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from repro.models.layers import rms_norm
    return types.SimpleNamespace(jax=jax, jnp=jnp, rms_norm=rms_norm)


def _inputs(shape, seed, scale=4.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jdt(ref, dtype):
    return ref.jnp.bfloat16 if dtype == torch.bfloat16 else ref.jnp.float32


def _as_f32(a):
    return np.asarray(a.astype("float32")) if hasattr(a, "astype") else a


def _check(got: np.ndarray, want: np.ndarray, dtype) -> None:
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_silu_matches_jitted_reference(ref, dtype):
    x = _inputs((64, 5376), seed=0)
    want = ref.jax.jit(ref.jax.nn.silu)(
        ref.jnp.asarray(x).astype(_jdt(ref, dtype)))
    got = ops.silu(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype and tuple(got.shape) == x.shape
    _check(got.float().numpy(), _as_f32(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_silu_gate_matches_jitted_reference(ref, dtype):
    y, z = _inputs((64, 5120), seed=1, scale=1.0), _inputs((64, 5120), 2)
    jdt = _jdt(ref, dtype)
    want = ref.jax.jit(lambda a, b: a * ref.jax.nn.silu(b))(
        ref.jnp.asarray(y).astype(jdt), ref.jnp.asarray(z).astype(jdt))
    value, prod = ops.silu_gate(torch.from_numpy(y).to(dtype),
                                torch.from_numpy(z).to(dtype))
    assert value.dtype == dtype and prod.dtype == torch.float32
    _check(value.float().numpy(), _as_f32(want), dtype)
    np.testing.assert_array_equal(prod.to(dtype).float().numpy(),
                                  value.float().numpy())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_gated_rms_norm_matches_jitted_reference(ref, dtype):
    """The gate feeds the norm: the port's `gated_rms_norm` (one
    `silu_gate` call, the variance of the f32 product) against the
    reference's jitted `rms_norm(y * silu(z), scale)`."""
    y, z = _inputs((3, 40, 512), seed=3, scale=1.0), _inputs((3, 40, 512), 4)
    scale = (1 + 0.1 * _inputs((512,), seed=5, scale=1.0)).astype(np.float32)
    jdt = _jdt(ref, dtype)
    want = ref.jax.jit(lambda a, b, s: ref.rms_norm(
        a * ref.jax.nn.silu(b), s, 1e-5))(
        ref.jnp.asarray(y).astype(jdt), ref.jnp.asarray(z).astype(jdt),
        ref.jnp.asarray(scale))
    got = ssm.gated_rms_norm(torch.from_numpy(y).to(dtype),
                             torch.from_numpy(z).to(dtype),
                             torch.from_numpy(scale), 1e-5)
    _check(got.float().numpy(), _as_f32(want), dtype)


def _wide_view(t: torch.Tensor, extra: int, offset: int = 0):
    """t as the columns [offset, offset + d) of a wider tensor, the way z
    is a slice of the in-projection's output."""
    wide = torch.zeros((*t.shape[:-1], t.shape[-1] + extra), dtype=t.dtype,
                       device=t.device)
    view = wide[..., offset:offset + t.shape[-1]]
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_wrappers_read_row_views(dtype):
    x = torch.from_numpy(_inputs((2, 5, 24), seed=6)).to(dtype)
    y = torch.from_numpy(_inputs((2, 5, 24), seed=7, scale=1.0)).to(dtype)
    xv, zv = _wide_view(x, 8, offset=3), _wide_view(x, 40)
    assert not xv.is_contiguous() and not zv.is_contiguous()
    torch.testing.assert_close(ops.silu(xv), silu_ref(x), rtol=0, atol=0)
    for got, want in zip(ops.silu_gate(y, zv), silu_gate_ref(y, x)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert got.is_contiguous()


def test_row_view():
    t = torch.zeros((2, 3, 10))
    assert silu_kernel.row_view(t) == (6, 10, 10, 1)
    assert silu_kernel.row_view(t[..., 2:7]) == (6, 5, 10, 1)
    assert silu_kernel.row_view(t[:, :1, 2:7]) == (2, 5, 30, 1)
    assert silu_kernel.row_view(torch.zeros(7)) == (1, 7, 7, 1)
    assert silu_kernel.row_view(torch.zeros((0, 4))) == (0, 4, 4, 1)
    assert silu_kernel.row_view(torch.zeros((4, 6)).t()) == (6, 4, 1, 6)
    with pytest.raises(ValueError, match="collapse"):
        silu_kernel.row_view(t[:, :2, :])        # rows 10 apart, then 30


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_wrappers_read_strided_inputs(dtype):
    """A transposed matrix (the decode step's conv output comes out of
    einsum so) and rows that share elements: read through the strides."""
    x = torch.from_numpy(_inputs((6, 4), seed=11)).to(dtype).t()
    shared = torch.from_numpy(_inputs((8,), seed=12)).to(dtype).as_strided(
        (3, 4), (2, 1))
    for t in (x, shared):
        torch.testing.assert_close(ops.silu(t), silu_ref(t.contiguous()),
                                   rtol=0, atol=0)
        y = torch.ones(t.shape, dtype=dtype)
        for got, want in zip(ops.silu_gate(y, t),
                             silu_gate_ref(y, t.contiguous())):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_silu_gate_value_only(dtype):
    """`with_prod=False` (the SwiGLU MLP's call): the same value, no f32
    product."""
    y = torch.from_numpy(_inputs((3, 64), seed=13, scale=1.0)).to(dtype)
    z = torch.from_numpy(_inputs((3, 64), seed=14)).to(dtype)
    value, prod = ops.silu_gate(y, z, with_prod=False)
    assert prod is None
    torch.testing.assert_close(value, silu_gate_ref(y, z)[0], rtol=0,
                               atol=0)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((2, 4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.silu(x.to(torch.float16))
    with pytest.raises(TypeError, match="torch.Tensor"):
        ops.silu(np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="z must match y"):
        ops.silu_gate(x, torch.zeros((2, 5)))
    with pytest.raises(ValueError, match="z must match y"):
        ops.silu_gate(x, x.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_silu_gate_bwd_reads_row_views(dtype):
    """g, y and z may each be a strided view (a slice of a wider tensor,
    a transposed matrix); the outputs are dense, equal to the plain
    version on dense copies, and the CPU launches nothing."""
    g, y, z = (torch.from_numpy(_inputs((2, 5, 24), seed=s)).to(dtype)
               for s in (15, 16, 17))
    zv, gv = _wide_view(z, 8, offset=3), _wide_view(g, 40)
    before = ops.silu_gate_bwd.launches
    for got, want in zip(ops.silu_gate_bwd(gv, y, zv),
                         silu_gate_bwd_ref(g, y, z)):
        assert got.is_contiguous() and got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    t = torch.from_numpy(_inputs((6, 4), seed=18)).to(dtype).t()
    for got, want in zip(ops.silu_gate_bwd(t, t, t),
                         silu_gate_bwd_ref(*(t.contiguous(),) * 3)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ops.silu_gate_bwd.launches == before


def test_silu_gate_bwd_rejects_bad_inputs():
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="g must match y"):
        ops.silu_gate_bwd(torch.zeros((2, 5)), x, x)
    with pytest.raises(ValueError, match="z must match y"):
        ops.silu_gate_bwd(x, x, x.to(torch.bfloat16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.silu_gate_bwd(x.half(), x.half(), x.half())


# ----------------------------------------------------------------------
# every bf16 input
# ----------------------------------------------------------------------
def _all_bf16(device="cpu") -> torch.Tensor:
    """The 65,536 bf16 bit patterns, in bit order."""
    return torch.arange(65536, dtype=torch.int32, device=device).to(
        torch.int16).view(torch.bfloat16)


def _same(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: equal bits (the sign of zero kept), or both NaN."""
    return (a.view(torch.int16) == b.view(torch.int16)) | (
        a.isnan() & b.isnan())


def _assert_bits(got: torch.Tensor, want: torch.Tensor, inputs,
                 what: str) -> None:
    """got and want equal bit for bit (NaN as NaN); the message names
    the first inputs where they are not."""
    bad = ~_same(got, want)
    if bad.any():
        where = [t[bad][:4].float().tolist() for t in inputs]
        raise AssertionError(f"{what}: {int(bad.sum())} outputs differ, "
                             f"first at inputs {where}")


_F32_TINY = 2.0 ** -126


def _chain_silu(x: torch.Tensor, flush: bool) -> torch.Tensor:
    """silu as the rounded chain of the port (each op in f32, rounded
    to bf16); with `flush`, each f32 value (the input, each op's result)
    that is subnormal set to zero of its sign first, as XLA's CPU
    program does."""
    f = _flush if flush else (lambda v: v)
    xf = f(x.float())
    e = _rnd(f(torch.exp(-xf)))
    u = _rnd(f(1 + e))
    r = _rnd(f(1 / u))
    return f(xf * r).to(torch.bfloat16)


def _chain_silu_bwd(g: torch.Tensor, x: torch.Tensor,
                    flush: bool) -> torch.Tensor:
    """silu_bwd's rounded chain, as :func:`_chain_silu`."""
    f = _flush if flush else (lambda v: v)
    xf, gf = f(x.float()), f(g.float())
    e = _rnd(f(torch.exp(-xf)))
    s = _rnd(f(1 / _rnd(f(1 + e))))
    t1, xg = _rnd(f(gf * s)), _rnd(f(xf * gf))
    ds = _rnd(f(s * _rnd(f(1 - s))))
    return f(t1 + _rnd(f(xg * ds))).to(torch.bfloat16)


def _flush(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v.abs() < _F32_TINY, v * 0, v)


def _rnd(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def _jax_bf16(ref, t: torch.Tensor):
    import ml_dtypes
    return ref.jnp.asarray(t.view(torch.int16).numpy().view(
        ml_dtypes.bfloat16))


def _from_jax(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def _check_flush_explains(got, want, chain) -> None:
    """The port's plain version equals the unflushed chain everywhere,
    the jitted reference the flushed one, and the two differ exactly
    where the flush changes the chain's result."""
    plain, flushed = chain(False), chain(True)
    assert _same(got, plain).all()
    assert _same(want, flushed).all()
    mismatch, predicted = ~_same(got, want), ~_same(plain, flushed)
    assert torch.equal(mismatch, predicted)


def test_silu_ref_all_bf16_against_jitted_reference(ref):
    """All 65,536 bf16 inputs: `silu_ref` and the jitted `jax.nn.silu`
    differ only at the inputs whose chain meets a subnormal that XLA
    flushes (511 on jax 0.9.0: 252 subnormal inputs, 254 subnormal
    results, and x * r at +-2.34e-38 and 1/u at x = -87.5, -88, -88.5)."""
    x = _all_bf16()
    want = _from_jax(ref.jax.jit(ref.jax.nn.silu)(_jax_bf16(ref, x)))
    _check_flush_explains(silu_ref(x), want,
                          lambda flush: _chain_silu(x, flush))


@pytest.mark.parametrize("g", [1.0, -0.5, 3.0, 1e-3], ids=str)
def test_silu_bwd_ref_all_bf16_against_jitted_reference(ref, g):
    """All 65,536 bf16 x at a cotangent g: `silu_bwd_ref` and the
    jitted `jax.vjp(jax.nn.silu)` differ only where XLA's flush of a
    subnormal changes the chain's result (e.g. at g = 1e-3, x = -80.5:
    g * s ~ 1e-38)."""
    x = _all_bf16()
    gt = torch.full_like(x, g)
    vjp = ref.jax.jit(lambda a, b: ref.jax.vjp(ref.jax.nn.silu, b)[1](a)[0])
    want = _from_jax(vjp(_jax_bf16(ref, gt), _jax_bf16(ref, x)))
    _check_flush_explains(silu_bwd_ref(gt, x), want,
                          lambda flush: _chain_silu_bwd(gt, x, flush))


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (shape, columns of the wider tensor it is a slice of, offset there):
# the serve model's prefill and decode shapes (x: [B, S, conv channels]
# dense; z: [B, S, d_inner] out of the in-projection's 10,576 columns),
# a width the vector path does not take, rows that start unaligned, and
# (extra -1) the decode conv output's transposed [B, C] layout
CARD_CASES = [((4, 700, 5376), 0, 0), ((4, 5376), 0, 0),
              ((4, 700, 5120), 5456, 0), ((4, 5120), 5456, 0),
              ((3, 1001), 0, 0), ((2, 7, 5), 3, 1), ((5, 64), 8, 2),
              ((5376, 4), -1, 0)]


def _laid_out(t: torch.Tensor, extra: int, offset: int) -> torch.Tensor:
    if extra < 0:
        return t.t()
    return _wide_view(t, extra, offset) if extra else t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: f"{c[0]}+{c[1]}")
def test_silu_kernel_bit_equal_plain_on_card(card, case, dtype):
    shape, extra, offset = case
    x = _laid_out(torch.from_numpy(_inputs(shape, seed=8)).to(card, dtype),
                  extra, offset)
    want = silu_ref(x)
    before = ops.silu.launches
    got = ops.silu(x)
    torch.cuda.synchronize()
    assert ops.silu.launches == before + 1
    assert got.is_contiguous() and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: f"{c[0]}+{c[1]}")
def test_silu_gate_kernel_bit_equal_plain_on_card(card, case, dtype):
    shape, extra, offset = case
    z = _laid_out(torch.from_numpy(_inputs(shape, seed=10)).to(card, dtype),
                  extra, offset)
    y = torch.from_numpy(_inputs(tuple(z.shape), seed=9, scale=1.0)).to(
        card, dtype)
    want = silu_gate_ref(y, z)
    before = ops.silu_gate.launches
    got = ops.silu_gate(y, z)
    torch.cuda.synchronize()
    assert ops.silu_gate.launches == before + 1
    for g, w in zip(got, want):
        assert g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: f"{c[0]}+{c[1]}")
def test_silu_gate_kernel_value_only_on_card(card, case, dtype):
    """The launch with a null prod stores the same value, one launch."""
    shape, extra, offset = case
    z = _laid_out(torch.from_numpy(_inputs(shape, seed=10)).to(card, dtype),
                  extra, offset)
    y = torch.from_numpy(_inputs(tuple(z.shape), seed=9, scale=1.0)).to(
        card, dtype)
    before = ops.silu_gate.launches
    value, prod = ops.silu_gate(y, z, with_prod=False)
    torch.cuda.synchronize()
    assert ops.silu_gate.launches == before + 1 and prod is None
    assert value.is_contiguous()
    torch.testing.assert_close(value, silu_gate_ref(y, z)[0], rtol=0, atol=0)


@pytest.mark.cuda
def test_silu_kernel_special_values_on_card(card):
    """Saturation and the specials: exp(-x) overflowing to inf (silu ->
    -0), underflowing (silu -> x), +-inf and NaN, as the plain version."""
    vals = torch.tensor([-1e4, -100.0, -88.7, -20.0, -0.0, 0.0, 1e-30,
                         20.0, 100.0, 1e4, float("inf"), float("-inf"),
                         float("nan"), 3.0], device=card)
    for dtype in DTYPES:
        x = vals.to(dtype)
        torch.testing.assert_close(ops.silu(x), silu_ref(x), rtol=0,
                                   atol=0, equal_nan=True)
        for g, w in zip(ops.silu_gate(x.flip(0), x), silu_gate_ref(
                x.flip(0), x)):
            torch.testing.assert_close(g, w, rtol=0, atol=0,
                                       equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: f"{c[0]}+{c[1]}")
def test_silu_gate_bwd_kernel_bit_equal_plain_on_card(card, case, dtype):
    """The gate's gradient: dy and dz bit-equal to the plain version, one
    launch, in the forward's layouts (z a slice of a wider tensor, the
    transposed layout) and at the dense MLP's width."""
    shape, extra, offset = case
    z = _laid_out(torch.from_numpy(_inputs(shape, seed=10)).to(card, dtype),
                  extra, offset)
    y, g = (torch.from_numpy(_inputs(tuple(z.shape), seed=s, scale=1.0)).to(
        card, dtype) for s in (9, 19))
    want = silu_gate_bwd_ref(g, y, z)
    before = ops.silu_gate_bwd.launches
    got = ops.silu_gate_bwd(g, y, z)
    torch.cuda.synchronize()
    assert ops.silu_gate_bwd.launches == before + 1
    for gt, w in zip(got, want):
        assert gt.is_contiguous() and gt.dtype == dtype
        torch.testing.assert_close(gt, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_swiglu_gate_autograd_launches_kernels_on_card(card, dtype):
    """`ops.swiglu_gate` under autograd at the dense MLP's shape
    ([2, 64, 6912]): one `silu_gate` launch forward, one `silu_gate_bwd`
    launch backward, the gradients bit-equal to the plain version's."""
    y, z, g = (torch.from_numpy(_inputs((2, 64, 6912), seed=s)).to(
        card, dtype) for s in (20, 21, 22))
    yt, zt = y.clone().requires_grad_(), z.clone().requires_grad_()
    fwd, bwd = ops.silu_gate.launches, ops.silu_gate_bwd.launches
    value = ops.swiglu_gate(yt, zt)
    value.backward(g)
    torch.cuda.synchronize()
    assert ops.silu_gate.launches == fwd + 1
    assert ops.silu_gate_bwd.launches == bwd + 1
    torch.testing.assert_close(value, silu_gate_ref(y, z)[0], rtol=0, atol=0)
    dy, dz = silu_gate_bwd_ref(g, y, z)
    torch.testing.assert_close(yt.grad, dy, rtol=0, atol=0)
    torch.testing.assert_close(zt.grad, dz, rtol=0, atol=0)


@pytest.mark.cuda
def test_silu_gate_bwd_special_values_on_card(card):
    """Saturation and the specials through the gradient, as the plain
    version computes them (NaN where it does)."""
    vals = torch.tensor([-1e4, -100.0, -88.7, -20.0, -0.0, 0.0, 1e-30,
                         20.0, 100.0, 1e4, float("inf"), float("-inf"),
                         float("nan"), 3.0], device=card)
    for dtype in DTYPES:
        x = vals.to(dtype)
        for got, want in zip(ops.silu_gate_bwd(x.flip(0), x.roll(3), x),
                             silu_gate_bwd_ref(x.flip(0), x.roll(3), x)):
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       equal_nan=True)


# layouts of the 65,536 bf16 inputs for the card sweep: dense (the
# flat walk); a strided row view (rows of 128 in 136, the row walk);
# rows of 100 in 108, whose odd rows start 8 bytes past a 16-byte
# boundary and end mid-vector (a head and a tail in the row walk); the
# flat range at an 8-byte offset (4-element vectors) and at a 2-byte
# offset, and transposed (the strided kernel)
SWEEP_LAYOUTS = ("dense", "rows", "rows_8b", "flat_8b", "flat_2b",
                 "transposed")


def _sweep_layout(p: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "dense":
        return p
    if layout == "transposed":
        return p.view(256, 256).t()
    if layout.startswith("flat"):
        off = 4 if layout == "flat_8b" else 1
        buf = torch.zeros(p.numel() + 8, dtype=p.dtype, device=p.device)
        buf[off:off + p.numel()] = p
        return buf[off:off + p.numel()]
    rows, d, ld = (512, 128, 136) if layout == "rows" else (656, 100, 108)
    q = torch.cat([p, p[:rows * d - p.numel()]]).view(rows, d)
    wide = torch.zeros((rows, ld), dtype=p.dtype, device=p.device)
    wide[:, :d] = q
    return wide[:, :d]


def _g_patterns(device) -> torch.Tensor:
    """64 bf16 cotangents over the whole exponent range: +-0, three
    subnormals, +-max, +-inf, and 55 normal values of both signs with
    exponent fields spread from 1 to 254."""
    bits = [0x0000, 0x8000, 0x0001, 0x8040, 0x007F, 0x7F7F, 0xFF7F, 0x7F80,
            0xFF80]
    for i, e in enumerate(np.linspace(1, 254, 55).round().astype(int)):
        bits.append((i % 2) << 15 | int(e) << 7 | (37 * i) % 128)
    return torch.tensor(np.array(bits, np.uint16).view(np.int16),
                        device=device).view(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", SWEEP_LAYOUTS)
def test_silu_kernel_all_bf16_on_card(card, layout):
    """`ops.silu` on every bf16 input, bit-equal to the plain version
    (subnormals kept, NaN as NaN), one launch."""
    x = _sweep_layout(_all_bf16(card), layout)
    want = silu_ref(x)
    before = ops.silu.launches
    got = ops.silu(x)
    torch.cuda.synchronize()
    assert ops.silu.launches == before + 1 and got.is_contiguous()
    _assert_bits(got, want, [x], f"silu, {layout}")


@pytest.mark.cuda
def test_silu_bwd_kernel_all_bf16_on_card(card):
    """`ops.silu_bwd` on every bf16 x at 64 cotangents spread over the
    exponents (zero, subnormal, +-max and +-inf among them), bit-equal
    to the plain version, one launch."""
    gv, xv = _g_patterns(card), _all_bf16(card)
    g = gv[:, None].expand(gv.numel(), xv.numel()).contiguous()
    x = xv.expand(gv.numel(), xv.numel()).contiguous()
    before = ops.silu_bwd.launches
    got = ops.silu_bwd(g, x)
    torch.cuda.synchronize()
    assert ops.silu_bwd.launches == before + 1
    _assert_bits(got, silu_bwd_ref(g, x), [g, x], "silu_bwd")


@pytest.mark.cuda
def test_silu_bwd_kernel_every_pair_on_card(card):
    """`ops.silu_bwd` on every (g, x) pair of bf16 values (2^32, 256 g
    a call), bit-equal to the plain version: the exhaustive proof of the
    kernel's bf16x2 ops and approximate reciprocal."""
    xv = _all_bf16(card)
    x = xv.expand(256, xv.numel()).contiguous()
    for lo in range(0, xv.numel(), 256):
        g = xv[lo:lo + 256, None].expand(256, xv.numel()).contiguous()
        _assert_bits(ops.silu_bwd(g, x), silu_bwd_ref(g, x), [g, x],
                     f"silu_bwd, g bits {lo}..{lo + 255}")


@pytest.mark.cuda
def test_silu_kernels_two_calls_equal_on_card(card):
    """Two calls on the same inputs give the same bits."""
    x = _all_bf16(card)
    g = x.flip(0)
    for fn, a in ((ops.silu, (x,)), (ops.silu_bwd, (g, x))):
        first, again = fn(*a), fn(*a)
        assert torch.equal(first.view(torch.int16), again.view(torch.int16))


def _offset_rows(rows: int, d: int, ld: int, off: int, gen, device):
    """[rows, d] bf16 rows `ld` apart, starting `off` elements into a
    fresh (16-byte aligned) buffer: dense when ld == d."""
    buf = (torch.randn(rows * ld + 16, generator=gen, device=device) *
           4).to(torch.bfloat16)
    return buf[off:off + rows * ld].view(rows, ld)[:, :d]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 7, 8, 9, 5376])
def test_silu_kernels_row_edges_on_card(card, d):
    """Rows of width d starting at every 2-byte offset within 16 bytes,
    dense (one flat range) and as rows of a wider tensor, g at offsets
    of its own: the walk's heads and tails, its narrower vectors and the
    strided kernel, and the grid's last chunk; bit-equal to the plain
    versions, one launch a call."""
    gen = torch.Generator(device=card).manual_seed(d)
    for ld in (d, d + 11):
        for off in range(8):
            x = _offset_rows(3, d, ld, off, gen, card)
            before = ops.silu.launches
            got = ops.silu(x)
            assert ops.silu.launches == before + 1
            _assert_bits(got, silu_ref(x), [x], f"silu, ld {ld}, off {off}")
            for goff in (0, off, (off + 3) % 8):
                g = _offset_rows(3, d, ld, goff, gen, card)
                before = ops.silu_bwd.launches
                got = ops.silu_bwd(g, x)
                assert ops.silu_bwd.launches == before + 1
                _assert_bits(got, silu_bwd_ref(g, x), [g, x],
                             f"silu_bwd, ld {ld}, offsets {goff} / {off}")
