"""The port's quantize / dequantize and wire codec against the JAX
reference.

The tile form: the port's plain versions (`ops.quantize` /
`ops.dequantize` on CPU tensors) against `quantize_pallas` /
`dequantize_pallas` in interpret mode, on the shape, bits and dtype
sweep of `tests/test_kernels.py`. The grouped form: the port's
`wire_encode` / `wire_decode` against the reference's under `jax.jit`,
which is how its callers (`kv_migrate` inside `jit(shard_map)`, the
train step) run it; `wire_decode_add` against the reference's jitted
`acc + wire_decode(...)`, which XLA fuses into one FMA per element.
Every comparison is bit-equal: no tolerance.

Both reference forms compute the scale as `amax * f32(1/qmax)` (XLA
rewrites the divide by the constant qmax) and the payload as a true
divide; the eager reference codec divides for the scale too, and
differs in the last bit of some scales (`test_eager_reference_scale_*`).

The reference is imported by a fixture, so the card-only cases (marked
`cuda`) run where jax is not installed:
``python -m pytest -q -m cuda tests/test_torch_quantize.py``.
"""
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.control.schedule import (wire_decode, wire_decode_add,
                                          wire_encode)
from repro_torch.kernels import ops
from repro_torch.kernels.quantize import inv_qmax, qmax
from repro_torch.kernels.ref import (dequantize_groups_add_ref,
                                     dequantize_groups_ref, dequantize_ref,
                                     quantize_groups_ref, quantize_ref)

DTYPES = ["float32", "bfloat16"]
# tests/test_kernels.py's tile shapes, and a wider one
TILE_SHAPES = [(256, 256), (512, 256), (256, 512), (512, 512), (1024, 768)]
# (name, shape, axes): one segment at ragged lengths; per-slice scales
CODEC_CASES = [("seg1", (1,), None), ("seg255", (255,), None),
               ("seg65537", (65537,), None), ("seg2d", (37, 11), None),
               ("slices", (4, 333), (1,)), ("slices3d", (4, 3, 67), (1, 2)),
               ("slices1d", (5,), ())]


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: jnp, its tile kernels and its wire codec."""
    import jax
    import jax.numpy as jnp

    from repro.control import schedule as ref_schedule
    from repro.kernels import quantize as ref_quantize
    from repro.kernels import ref as ref_plain
    return types.SimpleNamespace(jax=jax, jnp=jnp, kernels=ref_quantize,
                                 schedule=ref_schedule, plain=ref_plain)


def _normal(shape, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _as_f32(a) -> np.ndarray:
    """A jax or torch array as f32 numpy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


# ----------------------------------------------------------------------
# tile form: plain version vs the Pallas kernels (interpret mode)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", TILE_SHAPES, ids=lambda s: "%dx%d" % s)
def test_tile_plain_matches_pallas(ref, shape, bits, dtype):
    x = _normal(shape, seed=shape[0] + shape[1] + bits)
    jx = ref.jnp.asarray(x).astype(getattr(ref.jnp, dtype))
    qr, sr = ref.kernels.quantize_pallas(jx, bits=bits, interpret=True)
    before = ops.quantize.launches
    q, s = ops.quantize(torch.from_numpy(x).to(getattr(torch, dtype)), bits)
    assert ops.quantize.launches == before                  # plain version
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (shape[0] // 256, shape[1] // 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    for out in DTYPES:
        want = ref.kernels.dequantize_pallas(
            qr, sr, out_dtype=getattr(ref.jnp, out), interpret=True)
        got = ops.dequantize(q, s, out_dtype=getattr(torch, out))
        assert got.dtype == getattr(torch, out)
        np.testing.assert_array_equal(_as_f32(got), _as_f32(want))


@pytest.mark.parametrize("bits", [8, 4])
def test_tile_roundtrip_within_half_a_step(bits):
    """As `tests/test_kernels.py` holds the reference: each tile's
    round-trip error is at most half its quantization step."""
    x = torch.from_numpy(_normal((512, 512), seed=1, scale=1.0))
    q, s = ops.quantize(x, bits)
    err = (ops.dequantize(q, s) - x).abs()
    tile_err = err.reshape(2, 256, 2, 256).amax(dim=(1, 3))
    assert (tile_err <= s * 0.5001 + 1e-7).all()


def test_tile_block_parameter(ref):
    """A block other than 256 (the reference takes `block` too)."""
    x = _normal((128, 192), seed=5)
    qr, sr = ref.kernels.quantize_pallas(ref.jnp.asarray(x), bits=8,
                                         block=64, interpret=True)
    q, s = ops.quantize(torch.from_numpy(x), 8, block=64)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    np.testing.assert_array_equal(
        ops.dequantize(q, s, block=64).numpy(),
        np.asarray(ref.kernels.dequantize_pallas(qr, sr, block=64,
                                                 interpret=True)))


# ----------------------------------------------------------------------
# grouped form: the wire codec vs the reference's under jax.jit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("case", CODEC_CASES, ids=lambda c: c[0])
def test_wire_codec_matches_jitted_reference(ref, case, bits, dtype):
    _, shape, axes = case
    x = _normal(shape, seed=len(shape) * 1000 + shape[-1] + bits)
    jdt, tdt = getattr(ref.jnp, dtype), getattr(torch, dtype)
    qr, sr = ref.jax.jit(lambda v: ref.schedule.wire_encode(v, bits, axes))(
        ref.jnp.asarray(x).astype(jdt))
    q, s = wire_encode(torch.from_numpy(x).to(tdt), bits, axes)
    assert tuple(q.shape) == tuple(qr.shape)
    assert str(q.dtype).split(".")[-1] == str(qr.dtype)
    np.testing.assert_array_equal(_as_f32(q), _as_f32(qr))
    if sr is None:
        assert s is None
    else:
        assert tuple(s.shape) == tuple(sr.shape) and s.dtype == torch.float32
        np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    want = ref.jax.jit(lambda a, b: ref.schedule.wire_decode(a, b, jdt, bits))(
        qr, sr)
    got = wire_decode(q, s, tdt, bits)
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_array_equal(_as_f32(got), _as_f32(want))


@pytest.mark.parametrize("bits", [8, 4])
def test_eager_reference_scale_differs_in_the_last_bit(ref, bits):
    """Run eagerly, the reference codec divides `amax / qmax`; under
    `jax.jit` XLA multiplies by f32(1/qmax). The port follows the
    jitted form: over random segments (one length, so one compile) some
    eager scales differ from it in the last bit."""
    rng = np.random.default_rng(bits)
    jit_enc = ref.jax.jit(lambda v: ref.schedule.wire_encode(v, bits))
    differ = 0
    for _ in range(40):
        x = (rng.normal(size=777) * rng.uniform(0.01, 10)).astype(
            np.float32)
        _, s_eager = ref.schedule.wire_encode(ref.jnp.asarray(x), bits)
        _, s_jit = jit_enc(ref.jnp.asarray(x))
        _, s = wire_encode(torch.from_numpy(x), bits)
        assert s.item() == float(s_jit)
        amax = np.float32(np.abs(x).max())
        assert float(s_jit) == float(amax * inv_qmax(bits))
        assert float(s_eager) == float(amax / np.float32(qmax(bits)))
        if float(s_eager) != float(s_jit):
            assert abs(float(s_eager) - float(s_jit)) <= \
                np.spacing(np.float32(s_jit))
            differ += 1
    assert differ > 0


def test_reference_plain_tile_version_divides(ref):
    """`repro.kernels.ref.quantize_ref` divides `amax / qmax` (which is
    why `tests/test_kernels.py` compares scales to rtol 1e-6); the
    Pallas kernel, and the port, multiply by f32(1/qmax)."""
    x = _normal((1024, 1024), seed=11)
    _, sr = ref.plain.quantize_ref(ref.jnp.asarray(x), 4)
    _, sp = ref.kernels.quantize_pallas(ref.jnp.asarray(x), bits=4,
                                        interpret=True)
    _, s = ops.quantize(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sp))
    assert (s.numpy() != np.asarray(sr)).sum() > 0
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=1e-6)


# (name, acc shape, axes, part): a segment (one scale); per-slice scales;
# a part along axis 1 of a larger accumulator (rows apart in memory)
ADD_CASES = [("seg", (1001,), None, None), ("slices", (4, 333), (1,), None),
             ("part", (4, 16, 9), (1, 2), (4, 8))]


def _add_inputs(shape, axes, part, bits, seed):
    """(acc f32, q, scale, the acc view the decode goes into)."""
    acc = torch.from_numpy(_normal(shape, seed=seed))
    view = acc[:, part[0]:part[1]] if part else acc
    x = torch.from_numpy(_normal(tuple(view.shape), seed=seed + 1))
    q, scale = wire_encode(x, bits, axes)
    return acc, q, scale, view


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("case", ADD_CASES, ids=lambda c: c[0])
def test_decode_add_matches_jitted_reference(ref, case, bits):
    """acc + decode under `jax.jit` (XLA fuses the 8-bit decode's
    multiply into the add) is what `wire_decode_add` leaves in acc."""
    _, shape, axes, part = case
    acc, q, scale, view = _add_inputs(shape, axes, part, bits, seed=bits)
    qq = ref.jnp.asarray(q.float().numpy()).astype(
        ref.jnp.bfloat16 if q.dtype == torch.bfloat16 else q.numpy().dtype)
    # a copy, and the result taken before acc changes in place (jax may
    # share the numpy buffer and runs asynchronously)
    fused = ref.jax.jit(lambda a, qv, sv: a + ref.schedule.wire_decode(
        qv, sv, ref.jnp.float32, bits))
    want = np.asarray(fused(view.numpy().copy(), qq,
                            None if scale is None else scale.numpy()))
    before = acc.clone()
    assert wire_decode_add(view, q, scale, bits) is view
    np.testing.assert_array_equal(view.numpy(), want)
    if part:                                 # the rest of acc is untouched
        rest = torch.ones(shape, dtype=torch.bool)
        rest[:, part[0]:part[1]] = False
        assert torch.equal(acc[rest], before[rest])


def test_decode_add_rounds_once():
    """The plain accumulating dequantize is the f64 sum rounded once; on
    these inputs it differs from rounding the product first."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.integers(-127, 128, (3, 4096)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(0.01, 1, 3).astype(np.float32))
    acc = torch.from_numpy(_normal((3, 4096), seed=5))
    want = (q.numpy().astype(np.float64) * scale.numpy()[:, None].astype(
        np.float64) + acc.numpy().astype(np.float64)).astype(np.float32)
    two = acc + q.float() * scale[:, None]
    got = dequantize_groups_add_ref(q, scale, acc.clone())
    np.testing.assert_array_equal(got.numpy(), want)
    assert not torch.equal(got, two)


def test_groups_are_rows():
    """The grouped plain version is the tile form's arithmetic on each
    row: one [G, L] call equals G one-row calls."""
    x = torch.from_numpy(_normal((4, 1000), seed=3))
    q, s = quantize_groups_ref(x, 8)
    for g in range(4):
        qg, sg = quantize_groups_ref(x[g:g + 1], 8)
        assert torch.equal(q[g:g + 1], qg) and torch.equal(s[g:g + 1], sg)
    assert torch.equal(dequantize_groups_ref(q, s),
                       torch.cat([dequantize_groups_ref(q[g:g + 1],
                                                        s[g:g + 1])
                                  for g in range(4)]))


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_fast_rounding_matches_the_divide(bits):
    """The CUDA kernel's payload rounding (csrc/quantize.cu q_bytes),
    rehearsed in numpy f32: t = x * f32(1/scale), y = t + 1.5 * 2^23,
    r = y - 1.5 * 2^23, kept where |t - r| < 0.5 - 2^-13 (y's low byte
    is the int8), else the IEEE divide. It equals clip(rint(x / scale))
    on random groups and on values built next to half-integers of the
    quotient, where the product and the divide round apart."""
    rng = np.random.default_rng(bits)
    m = np.float32(qmax(bits))
    magic = np.float32(1.5 * 2 ** 23)
    fell_back = 0
    for i in range(12):
        amax = np.float32(10.0 ** rng.uniform(-14, 30))
        x = (rng.uniform(-1, 1, 200_000) * amax).astype(np.float32)
        x[:2] = amax, -amax
        s = np.float32(max(amax, np.float32(1e-12)) * inv_qmax(bits))
        if i % 2:          # x / s next to k + 0.5, a few ulps either side
            k = rng.integers(-int(m), int(m), x.size).astype(np.float32)
            x = ((k + np.float32(0.5)) * s).astype(np.float32)
            for _ in range(int(rng.integers(0, 3))):
                x = np.nextafter(x, np.where(rng.random(x.size) < 0.5,
                                             -np.inf, np.inf)
                                 .astype(np.float32))
        t = x * (np.float32(1) / s)
        y = t + magic
        r = y - magic
        fast = np.abs(t - r) < np.float32(0.5 - 2 ** -13)
        low = (y.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
        exact = np.clip(np.rint(x / s), -m, m).astype(np.int8)
        np.testing.assert_array_equal(np.where(fast, low, exact), exact)
        fell_back += int((~fast).sum())
    assert fell_back > 0              # the fallback was exercised


def test_zero_input_has_the_floor_scale():
    q, s = ops.quantize_groups(torch.zeros((2, 7)), 8)
    assert (q == 0).all()
    assert s[0].item() == float(np.float32(1e-12) * inv_qmax(8))


# parts along axis 1 of a [4, 16, 5, 7] leaf (as the batched gradient
# sync cuts them): [start, stop) of axis 1
LEAF = (4, 16, 5, 7)
LEAF_SLICES = [(0, 8), (8, 16), (3, 5), (0, 16)]


def _leaf_slice(dtype, part, seed=21):
    leaf = torch.from_numpy(_normal(LEAF, seed=seed)).to(
        getattr(torch, dtype))
    return leaf, leaf[:, part[0]:part[1]]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("part", LEAF_SLICES, ids=lambda p: "%d-%d" % p)
def test_group_plain_on_strided_rows_matches_contiguous_and_reference(
        ref, part, bits, dtype):
    """The grouped quantize of a [4, L] view whose rows lie apart equals
    that of the same data made contiguous, and the jitted reference
    `wire_encode` of the slice with one scale per leading index."""
    _, sl = _leaf_slice(dtype, part)
    view = sl.view(4, -1)
    assert part == (0, 16) or not view.is_contiguous()
    q, s = ops.quantize_groups(view, bits)
    qc, sc = ops.quantize_groups(view.contiguous(), bits)
    assert q.is_contiguous() and torch.equal(q, qc) and torch.equal(s, sc)
    jdt = getattr(ref.jnp, dtype)
    qr, sr = ref.jax.jit(lambda v: ref.schedule.wire_encode(
        v, bits, (1, 2, 3)))(ref.jnp.asarray(sl.float().numpy()).astype(jdt))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr).reshape(4, -1))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr).reshape(4))
    got_q, got_s = wire_encode(sl, bits, axes=(1, 2, 3))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(sr))


@pytest.mark.parametrize("case", ["slice_axis1", "slice_axis0", "contiguous",
                                  "segment", "transposed"])
def test_wire_encode_reads_a_view_in_place(monkeypatch, case):
    """`wire_encode` hands the grouped quantize a view of its input (the
    same storage and row stride) wherever one exists, and a contiguous
    copy only where none does."""
    leaf, sl = _leaf_slice("float32", (8, 16))
    x, axes = {"slice_axis1": (sl, (1, 2, 3)),
               "slice_axis0": (leaf[1:3], (1, 2, 3)),
               "contiguous": (leaf, (1, 2, 3)),
               "segment": (leaf[:, 3:5], None),
               "transposed": (leaf[0, :, :, 0].t(), (1,))}[case]
    seen = []

    def spy(x2d, bits):
        seen.append((x2d.data_ptr(), x2d.stride()))
        return quantize_groups_ref(x2d, bits)

    monkeypatch.setattr(ops, "quantize_groups_ref", spy)
    q, _ = wire_encode(x, 8, axes)
    assert len(seen) == 1 and tuple(q.shape) == tuple(x.shape)
    ptr, stride = seen[0]
    if case == "segment":                    # one row: no view exists
        assert ptr != x.data_ptr() and stride[1] == 1
    elif case == "transposed":               # columns apart: a copy
        assert ptr != x.data_ptr() and stride == (x.shape[1], 1)
    else:
        assert ptr == x.data_ptr() and stride == (x.stride(0), 1)


# ----------------------------------------------------------------------
# wrappers: what they refuse, and launches counted only on the card
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    "int_x", "x_1d", "x_ragged", "x_contig", "bits_16", "bits_1", "type",
    "device", "scale_shape", "scale_dtype", "q_dtype", "out_f16",
    "groups_empty", "groups_3d", "groups_too_many", "groups_scale_shape",
    "groups_columns", "groups_rows",
    "add_acc_dtype", "add_acc_shape", "add_acc_columns", "add_acc_rows"])
def test_wrappers_reject_bad_inputs(case):
    x = torch.ones((256, 512))
    q, s = ops.quantize(x, 8)
    g = torch.ones((2, 9))
    gq, gs = ops.quantize_groups(g, 8)
    calls = {
        "int_x": lambda: ops.quantize(x.to(torch.int32), 8),
        "x_1d": lambda: ops.quantize(torch.ones(256), 8),
        "x_ragged": lambda: ops.quantize(torch.ones((256, 300)), 8),
        "x_contig": lambda: ops.quantize(torch.ones((512, 256)).t(), 8),
        "bits_16": lambda: ops.quantize(x, 16),
        "bits_1": lambda: ops.quantize_groups(g, 1),
        "type": lambda: ops.quantize(x.numpy(), 8),
        "device": lambda: ops.quantize_groups(g.to("meta"), 8),
        "scale_shape": lambda: ops.dequantize(q, s[:, :1].contiguous()),
        "scale_dtype": lambda: ops.dequantize(q, s.double()),
        "q_dtype": lambda: ops.dequantize_groups(gq.to(torch.int32), gs),
        "out_f16": lambda: ops.dequantize(q, s, out_dtype=torch.float16),
        "groups_empty": lambda: ops.quantize_groups(torch.ones((2, 0)), 8),
        "groups_3d": lambda: ops.quantize_groups(torch.ones((2, 3, 4)), 8),
        "groups_too_many": lambda: ops.quantize_groups(
            torch.ones((65536, 1)), 8),
        "groups_scale_shape": lambda: ops.dequantize_groups(gq, gs[:1]),
        "groups_columns": lambda: ops.quantize_groups(
            torch.ones((9, 2)).t(), 8),
        "groups_rows": lambda: ops.quantize_groups(
            torch.ones(9).expand(2, 9), 8),
        "add_acc_dtype": lambda: ops.dequantize_groups_add(
            gq, gs, torch.ones((2, 9), dtype=torch.bfloat16)),
        "add_acc_shape": lambda: ops.dequantize_groups_add(
            gq, gs, torch.ones((2, 10))),
        "add_acc_columns": lambda: ops.dequantize_groups_add(
            gq, gs, torch.ones((9, 2)).t()),
        "add_acc_rows": lambda: ops.dequantize_groups_add(
            gq, gs, torch.ones(9).expand(2, 9)),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[case]()


def test_codec_rejects_other_axes_and_scales():
    x = torch.ones((4, 3, 5))
    with pytest.raises(ValueError, match="axes"):
        wire_encode(x, 8, axes=(2,))
    q, s = wire_encode(x, 8, axes=(1, 2))
    with pytest.raises(ValueError, match="scale"):
        wire_decode(q, s.reshape(4, 1), torch.float32, 8)
    with pytest.raises(ValueError, match="bits"):
        wire_encode(x, 12)


def test_wrappers_count_no_launch_on_cpu():
    before = (ops.quantize.launches, ops.dequantize.launches)
    q, s = ops.quantize(torch.ones((256, 256)), 8)
    ops.dequantize(q, s)
    gq, gs = ops.quantize_groups(torch.ones((3, 5)), 4)
    ops.dequantize_groups(gq, gs, torch.bfloat16)
    ops.dequantize_groups_add(gq, gs, torch.zeros((3, 5)))
    assert (ops.quantize.launches, ops.dequantize.launches) == before


# ----------------------------------------------------------------------
# card-only: the CUDA kernels against their plain versions, bit-equal
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _assert_kernel_equals_plain(x, bits, block=256):
    before = (ops.quantize.launches, ops.dequantize.launches)
    q, s = ops.quantize(x, bits, block)
    outs = {dt: ops.dequantize(q, s, block, dt) for dt in
            (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    assert (ops.quantize.launches, ops.dequantize.launches) == \
        (before[0] + 1, before[1] + 2)
    qp, sp = quantize_ref(x, bits, block)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    for dt, out in outs.items():
        assert torch.equal(out, dequantize_ref(q, s, block, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,block", [((256, 256), 256),
                                         ((1024, 1024), 256),
                                         ((512, 768), 256),
                                         ((96, 160), 32), ((30, 42), 6),
                                         ((4096, 4096), 256),
                                         ((1024, 1024), 128)],
                         ids=lambda v: str(v))
def test_tile_kernel_matches_plain_on_card(card, shape, block, bits, dtype):
    """Block 256 takes the cluster kernel (4 blocks a tile), other
    blocks the one-block-per-tile kernel."""
    x = torch.from_numpy(_normal(shape, seed=shape[0])).to(card).to(
        getattr(torch, dtype))
    _assert_kernel_equals_plain(x, bits, block)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_kernel_unaligned_view_on_card(card, dtype):
    """A contiguous [512, 256] view one element into its storage (not
    16-byte aligned) takes the one-block-per-tile kernel."""
    flat = torch.from_numpy(_normal(512 * 256 + 1, seed=8)).to(card).to(
        getattr(torch, dtype))
    _assert_kernel_equals_plain(flat[1:].view(512, 256), 8)


def _assert_groups_equal_plain(x, bits):
    before = (ops.quantize.launches, ops.dequantize.launches)
    q, s = ops.quantize_groups(x, bits)
    outs = {dt: ops.dequantize_groups(q, s, dt) for dt in
            (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    assert (ops.quantize.launches, ops.dequantize.launches) == \
        (before[0] + 1, before[1] + 2)
    qp, sp = quantize_groups_ref(x, bits)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    for dt, out in outs.items():
        assert torch.equal(out, dequantize_groups_ref(q, s, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("L", [1, 3, 255, 256, 65537, 1 << 20])
def test_group_kernel_matches_plain_on_card(card, L, G, bits, dtype):
    x = torch.from_numpy(_normal((G, L), seed=L + G)).to(card).to(
        getattr(torch, dtype))
    _assert_groups_equal_plain(x, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_group_kernel_unaligned_view_on_card(card, dtype):
    """A [G, L] view one element into its storage (L a multiple of 4,
    the pointer not 16-byte aligned) takes the one-element path."""
    flat = torch.from_numpy(_normal(4 * 4096 + 1, seed=9)).to(card).to(
        getattr(torch, dtype))
    _assert_groups_equal_plain(flat[1:].view(4, 4096), 8)


@pytest.mark.cuda
def test_group_kernel_extremes_on_card(card):
    """All-zero groups (the 1e-12 floor), a group of one huge value,
    exact ties of round-half-even, and a NaN that reaches the scale."""
    x = torch.zeros((4, 1000), device=card)
    x[1, 7] = 3.0e38
    x[2] = torch.arange(1000, device=card, dtype=torch.float32) * 0.5
    _assert_groups_equal_plain(x, 8)
    x[3, 5] = float("nan")
    _, s = ops.quantize_groups(x, 8)
    assert torch.isnan(s[3]) and torch.isfinite(s[:3]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_group_kernel_many_groups_on_card(card, bits, dtype):
    """G = 4096 rows of 255: each block's stripe crosses many rows, and
    the rows start off 16-byte boundaries."""
    x = torch.from_numpy(_normal((4096, 255), seed=bits)).to(card).to(
        getattr(torch, dtype))
    _assert_groups_equal_plain(x, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("G,L", [(1, 1 << 25), (4, 1 << 23)],
                         ids=lambda v: str(v))
def test_group_kernel_larger_than_the_chip_holds_on_card(card, G, L):
    """A 128 MB f32 part: more than the blocks' rings (about 25 MB) and
    L2 hold, so pass 2 reads most of it from device memory again."""
    x = torch.randn((G, L), generator=torch.Generator(device=card)
                    .manual_seed(G), device=card) * 3
    _assert_groups_equal_plain(x, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("G,L,cols,off", [(4, 255, 1023, 0),
                                          (4, 4096, 8192, 4096),
                                          (4, 65537, 131075, 1),
                                          (1, 333, 999, 5),
                                          (64, 1000, 3000, 2)],
                         ids=lambda v: str(v))
def test_group_kernel_strided_rows_on_card(card, G, L, cols, off, bits,
                                           dtype):
    """x [G, L] read in place from a wider tensor: rows `cols` apart,
    starting `off` elements in."""
    wide = torch.from_numpy(_normal((G, cols), seed=L + off)).to(card).to(
        getattr(torch, dtype))
    view = wide[:, off:off + L]
    q, s = ops.quantize_groups(view, bits)
    qp, sp = quantize_groups_ref(view, bits)
    torch.cuda.synchronize()
    assert torch.equal(q, qp) and torch.equal(s, sp)
    q2, s2 = ops.quantize_groups(view.contiguous(), bits)
    assert torch.equal(q, q2) and torch.equal(s, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_group_kernel_inf_and_nan_on_card(card, dtype):
    """A row holding +inf, one holding -inf, an all-zero row and a row
    with a NaN: the scales bit-equal to the plain version's (inf, inf,
    the floor, NaN), the payloads wherever x / scale is a number."""
    x = torch.from_numpy(_normal((5, 3001), seed=3)).to(card)
    x[0, 17] = float("inf")
    x[1, 3000] = float("-inf")
    x[2] = 0.0
    x[3, 0] = float("nan")
    x = x.to(getattr(torch, dtype))
    q, s = ops.quantize_groups(x, 8)
    qp, sp = quantize_groups_ref(x, 8)
    torch.cuda.synchronize()
    assert torch.equal(s[[0, 1, 2, 4]], sp[[0, 1, 2, 4]])
    assert torch.isinf(s[:2]).all() and torch.isnan(s[3]) and \
        torch.isnan(sp[3])
    # a NaN quotient (inf / inf, or a NaN input) has no defined int8 value
    num = ~torch.isnan(x.float() / sp[:, None])
    assert torch.equal(q[num], qp[num])


def _device_kernels(fn):
    """The names of the device operations (kernels, memsets, memcpys)
    `fn` runs, in order: `chip_smoke.kernel_names`, a torch.profiler
    trace."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_names(fn)


@pytest.mark.cuda
@pytest.mark.parametrize("G,L", [(1, 20971520), (4, 65537)],
                         ids=lambda v: str(v))
def test_group_quantize_is_one_kernel_on_card(card, G, L):
    """One grouped quantize call enqueues one kernel and no memset."""
    x = torch.ones((G, L), device=card)
    ops.quantize_groups(x, 8)                     # built and warmed
    names = _device_kernels(lambda: ops.quantize_groups(x, 8))
    assert len(names) == 1 and "quantize_groups_kernel" in names[0], names


@pytest.mark.cuda
def test_group_quantize_in_a_cuda_graph_on_card(card):
    """The cooperative launch is captured in a CUDA graph (as
    `chip_smoke.py` times it) and replays to the same bits."""
    x = torch.from_numpy(_normal((4, 300001), seed=6)).to(card)
    want_q, want_s = ops.quantize_groups(x, 8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.quantize_groups(x, 8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q, s = ops.quantize_groups(x, 8)
    q.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(q, want_q) and torch.equal(s, want_s)


@pytest.mark.cuda
def test_tile_quantize_is_the_cluster_kernel_on_card(card):
    x = torch.ones((1024, 1024), device=card)
    ops.quantize(x, 8)
    names = _device_kernels(lambda: ops.quantize(x, 8))
    assert len(names) == 1 and "quantize_tile_cluster_kernel" in names[0], \
        names


@pytest.mark.cuda
def test_wrappers_refuse_mixed_devices_on_card(card):
    q, s = ops.quantize_groups(torch.ones((2, 9), device=card), 8)
    with pytest.raises(ValueError, match="on"):
        ops.dequantize_groups(q, s.cpu())
    qt, st = ops.quantize(torch.ones((256, 256), device=card), 8)
    with pytest.raises(ValueError, match="on"):
        ops.dequantize(qt.cpu(), st)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_wire_codec_on_card_equals_host(card, bits):
    """The codec on the card (kernels) and on the host (plain versions)
    give the same bits, per segment and per slice."""
    x = torch.from_numpy(_normal((4, 3, 1001), seed=bits))
    for axes in (None, (1, 2)):
        q, s = wire_encode(x.to(card), bits, axes)
        qh, sh = wire_encode(x, bits, axes)
        assert torch.equal(q.cpu(), qh)
        assert (s is None) == (sh is None)
        if s is not None:
            assert torch.equal(s.cpu(), sh)
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(wire_decode(q, s, dt, bits).cpu(),
                               wire_decode(qh, sh, dt, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("G,L,cols", [(1, 1, 1), (1, 65537, 65537),
                                      (4, 255, 255), (4, 1 << 20, 1 << 20),
                                      (4, 4096, 8192), (4, 333, 999)],
                         ids=lambda v: str(v))
def test_group_add_kernel_matches_plain_on_card(card, G, L, cols):
    """The accumulating dequantize (fmaf) against its plain version (the
    f64 sum rounded once), bit-equal, into an accumulator whose rows
    are `cols` apart (a part of a wider one where cols > L)."""
    rng = np.random.default_rng(L + G)
    q = torch.from_numpy(rng.integers(-127, 128, (G, L)).astype(
        np.int8)).to(card)
    scale = torch.from_numpy(rng.uniform(1e-3, 2, G).astype(
        np.float32)).to(card)
    wide = torch.from_numpy(_normal((G, cols), seed=L)).to(card)
    host = wide.cpu()
    before = ops.dequantize.launches
    out = ops.dequantize_groups_add(q, scale, wide[:, :L])
    torch.cuda.synchronize()
    assert ops.dequantize.launches == before + 1
    assert out.data_ptr() == wide.data_ptr()
    dequantize_groups_add_ref(q.cpu(), scale.cpu(), host[:, :L])
    assert torch.equal(wide.cpu(), host)
