"""The dense family's flash attention (`ops.flash_fwd` / `ops.flash_bwd`)
against the JAX reference's `flash_attention` and its custom VJP.

On the CPU the wrappers run the plain versions (`ref.flash_fwd_ref` /
`ref.flash_bwd_ref`, the reference's key blocks and roundings). The
same seeded numpy inputs go through `jax.vjp` of the jitted reference
and through the plain versions: head dims 8, 16, 80 (h2o-danube-1.8b)
and 128 (llama3-8b, qwen3-4b); 1 and 2 query heads a KV head; with and
without a window; 40 keys in blocks of 16, so the last block is ragged
(zero-padded and masked). Tolerances:
- f32: the frameworks differ only in the order of their f32 sums,
  within 1e-5 of the output's (gradient's) largest magnitude;
- bf16: one bf16 step of the largest magnitude (2^-7), the dense
  tests' bar: a sum order can flip a rounding here and there.

The card cases (marker `cuda`) hold the CUDA kernels (csrc/
flash_attn.cu) to the plain versions on the card through
`chip_smoke.flash_err`, the card check's own rule: bf16 outputs and
gradients each row within 2^-7 of the row's max |value| (floored at
2^-7 of the tensor's: rows of cancellation noise), f32 within 1e-5 of
the max |value|, lse within 1e-5 (at S = 1, where dq and dk are 0 up
to rounding, within the bound of that rounding); they cover the bf16
kernels' tile edges, D = 80's swizzled tail, a strided grouped q,
windows that end inside a tile, and two calls giving equal bits. They
import no jax: ``python -m pytest -q -m cuda tests/test_torch_flash.py``.
"""
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_bwd_ref, flash_fwd_ref
from repro_torch.models import attention as att

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_REL = 1e-5
BF16_STEP = 2.0 ** -7
S, BLOCK = 40, 16           # 3 key blocks, the last ragged


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from repro.models import attention as ref_att
    return types.SimpleNamespace(jax=jax, jnp=jnp, att=ref_att)


def _inputs(B, K, G, S, D, dtype, seed):
    """q, k, v, g as seeded normal f32 numpy arrays rounded to `dtype`
    (values both packages hold exactly)."""
    rng = np.random.default_rng(seed)
    shapes = ((B, K, G, S, D), (B, K, S, D), (B, K, S, D), (B, K, G, S, D))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(DTYPES[dtype]).float().numpy() for s in shapes]


def _close(got, want, dtype, what):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape and np.isfinite(g).all(), what
    mag = float(np.abs(w).max())
    tol = F32_REL if dtype == "float32" else BF16_STEP
    np.testing.assert_allclose(g, w, atol=tol * mag, rtol=0, err_msg=what)


# (D, G, window); D = 8 is below what the wrappers take, the plain
# versions take any head dim
CASES = [(d, gq, w) for d in (8, 16, 80, 128) for gq in (1, 2)
         for w in (0, 9)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D,G,window", CASES)
def test_plain_versions_match_reference_vjp(ref, D, G, window, dtype):
    q, k, v, g = _inputs(2, 2, G, S, D, dtype, seed=D + G + window)
    jdt = ref.jnp.dtype(dtype)
    out, vjp = ref.jax.vjp(ref.jax.jit(
        lambda a, b, c: ref.att.flash_attention(
            a, b, c, causal=True, window=window, block_k=BLOCK)),
        *(ref.jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    want = [out] + list(vjp(ref.jnp.asarray(g).astype(jdt)))
    want = [np.asarray(w.astype(ref.jnp.float32)) for w in want]
    tq, tk, tv, tg = (torch.from_numpy(a).to(DTYPES[dtype])
                      for a in (q, k, v, g))
    o, lse = flash_fwd_ref(tq, tk, tv, window, BLOCK)
    assert o.dtype == tv.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, 2, G, S)
    grads = flash_bwd_ref(tg, tq, tk, tv, o, lse, window, BLOCK)
    for name, got, w in zip(("out", "dq", "dk", "dv"), (o, *grads), want):
        assert got.dtype == tq.dtype, name
        _close(got, w, dtype, name)


def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


# name -> (q, k, v, window, error, message)
BAD = {
    "d_not_multiple_of_16": (lambda: (_t(1, 1, 1, 8, 24), _t(1, 1, 8, 24),
                                      _t(1, 1, 8, 24)), 0, ValueError,
                             "multiple of 16"),
    "d_above_128": (lambda: (_t(1, 1, 1, 8, 144), _t(1, 1, 8, 144),
                             _t(1, 1, 8, 144)), 0, ValueError,
                    "multiple of 16"),
    "dq_not_dv": (lambda: (_t(1, 1, 1, 8, 32), _t(1, 1, 8, 32),
                           _t(1, 1, 8, 16)), 0, ValueError, "Dq == Dv"),
    "sq_not_sk": (lambda: (_t(1, 1, 1, 8, 32), _t(1, 1, 12, 32),
                           _t(1, 1, 12, 32)), 0, ValueError, "Sq == Sk"),
    "dtype_mismatch": (lambda: (_t(1, 1, 1, 8, 32, dtype=torch.bfloat16),
                                _t(1, 1, 8, 32), _t(1, 1, 8, 32)), 0,
                       TypeError, "must be torch.bfloat16"),
    "half": (lambda: (_t(1, 1, 1, 8, 32, dtype=torch.float16),
                      _t(1, 1, 8, 32, dtype=torch.float16),
                      _t(1, 1, 8, 32, dtype=torch.float16)), 0, TypeError,
             "float32 or bfloat16"),
    "mixed_devices": (lambda: (_t(1, 1, 1, 8, 32), _t(1, 1, 8, 32),
                               _t(1, 1, 8, 32, device="meta")), 0,
                      ValueError, "is on meta"),
    "q_not_5d": (lambda: (_t(1, 1, 8, 32), _t(1, 1, 8, 32),
                          _t(1, 1, 8, 32)), 0, ValueError, "expected q"),
    "negative_window": (lambda: (_t(1, 1, 1, 8, 32), _t(1, 1, 8, 32),
                                 _t(1, 1, 8, 32)), -1, ValueError,
                        "window"),
}


# head dims the card's kernels refuse (`flash.check_dims`, which the
# wrappers call for CUDA tensors); the plain versions, and so the
# wrappers on the CPU, take any head dim (MLA's reduced config has Dq =
# 24, Dv = 16)
CARD_ONLY = {"d_not_multiple_of_16", "d_above_128"}
# Dq != Dv: the forward takes it on either device (MLA); the backward's
# plain version takes it too (MLA's concatenated form on the CPU), the
# card's kernels refuse it (MLA trains from its parts there,
# `ops.flash_bwd_mla`; tests/test_torch_mla_train.py holds the refusal)
CPU_TAKES = {"dq_not_dv"}


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("case", list(BAD))
def test_wrappers_refuse_what_the_kernels_do_not_take(case, which):
    make, window, err, msg = BAD[case]
    q, k, v = make()
    before = (ops.flash_fwd.launches, ops.flash_bwd.launches)
    lse = torch.zeros(q.shape[:4]) if q.dim() == 5 else q
    if case in CARD_ONLY:
        from repro_torch.kernels import flash
        with pytest.raises(err, match=msg):
            flash.check_dims(q.shape[-1], v.shape[-1])
        got = ops.flash_fwd(q, k, v, window) if which == "fwd" else \
            ops.flash_bwd(q, q, k, v, q, lse, window)
        want = flash_fwd_ref(q, k, v, window, 512) if which == "fwd" else \
            flash_bwd_ref(q, q, k, v, q, lse, window, 512)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    elif case in CPU_TAKES:
        out, lse = ops.flash_fwd(q, k, v, window)
        want, want_lse = flash_fwd_ref(q, k, v, window, 512)
        assert out.shape == v.shape[:2] + q.shape[2:4] + v.shape[3:]
        assert torch.equal(out, want) and torch.equal(lse, want_lse)
        if which == "bwd":
            got = ops.flash_bwd(out, q, k, v, out, lse, window)
            want = flash_bwd_ref(out, q, k, v, out, lse, window, 512)
            assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        with pytest.raises(err, match=msg):
            if which == "fwd":
                ops.flash_fwd(q, k, v, window)
            else:
                ops.flash_bwd(q, q, k, v, q, lse, window)
    assert (ops.flash_fwd.launches, ops.flash_bwd.launches) == before


def test_bwd_refuses_a_wrong_lse():
    q, k, v = _t(1, 1, 1, 8, 32), _t(1, 1, 8, 32), _t(1, 1, 8, 32)
    with pytest.raises(TypeError, match="lse must be torch.float32"):
        ops.flash_bwd(q, q, k, v, q, torch.zeros(1, 1, 1, 8,
                                                 dtype=torch.float64))
    with pytest.raises(ValueError, match="lse must be"):
        ops.flash_bwd(q, q, k, v, q, torch.zeros(1, 1, 1, 9))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wrappers_take_the_plain_versions_on_cpu(dtype):
    """On CPU tensors the wrappers return the plain versions' results
    bit for bit (strided q included) and count no launch."""
    q, k, v, g = (torch.from_numpy(a).to(DTYPES[dtype]) for a in
                  _inputs(1, 2, 2, S, 32, dtype, seed=3))
    qs = q.transpose(3, 4).contiguous().transpose(3, 4)    # strided rows
    before = (ops.flash_fwd.launches, ops.flash_bwd.launches,
              ops.flash_fwd.copies)
    out, lse = ops.flash_fwd(qs, k, v, 9, BLOCK)
    want_out, want_lse = flash_fwd_ref(qs, k, v, 9, BLOCK)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    got = ops.flash_bwd(g, qs, k, v, out, lse, 9, BLOCK)
    want = flash_bwd_ref(g, qs, k, v, out, lse, 9, BLOCK)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (ops.flash_fwd.launches, ops.flash_bwd.launches,
            ops.flash_fwd.copies) == before


def test_flash_attention_grads_go_through_the_wrappers(monkeypatch):
    """`flash_attention`'s forward calls `ops.flash_fwd`, its backward
    `ops.flash_bwd`, once each (the path the card's launches count)."""
    calls = []
    for name in ("flash_fwd", "flash_bwd"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    q, k, v, g = (torch.from_numpy(a) for a in
                  _inputs(1, 1, 1, S, 16, "float32", seed=4))
    q.requires_grad_()
    att.flash_attention(q, k, v, window=0, block_k=BLOCK).backward(g)
    assert calls == ["flash_fwd", "flash_bwd"] and q.grad is not None


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def smoke(card):
    """`chip_smoke.py`, whose `flash_err` and lse bound are the card
    check's tolerance rule, held in one place."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _card_inputs(card, B, K, G, S_, D, seed, dtype=torch.bfloat16):
    return [torch.from_numpy(a).to(dtype).to(card) for a in
            _inputs(B, K, G, S_, D, "float32", seed=seed)]


def _check_card(smoke, q, k, v, g, window):
    """Both kernels against the plain versions on the same inputs. At
    S = 1 a query's only key is itself: out = v whatever q and k, so dq
    and dk are 0 up to the rounding of ds = p (dp - delta), two f32 sums
    of the same D products in other orders; each is held, in both
    versions, within the bound of that rounding (2 D f32 ulps of
    sum |g v|, times |k| or |q| and the scale), not row by row."""
    out, lse = ops.flash_fwd(q, k, v, window)
    grads = ops.flash_bwd(g, q, k, v, out, lse, window)
    torch.cuda.synchronize()
    want_out, want_lse = flash_fwd_ref(q, k, v, window, 512)
    smoke.flash_err(out, want_out, "out")
    assert float((lse - want_lse).abs().max()) <= smoke.FLASH_LSE_TOL
    want = flash_bwd_ref(g, q, k, v, out, lse, window, 512)
    S_, D = q.shape[3], q.shape[4]
    gv = float((g.float().abs() * v.float().abs()[:, :, None]).sum(-1).max())
    for name, a, b, other in zip(("dq", "dk", "dv"), grads, want,
                                 (k, q, None)):
        assert a.dtype == q.dtype and a.is_contiguous()
        if S_ == 1 and other is not None:
            bound = (2 * D * 2.0 ** -24 * gv * float(other.float().abs().max())
                     * D ** -0.5 * q.shape[2])
            assert float(a.float().abs().max()) <= bound, name
            assert float(b.float().abs().max()) <= bound, name
        else:
            smoke.flash_err(a, b, name)


# (B, K, G, S, D, window): ragged tiles, G > 1, windows that skip tiles,
# the generic head dim and the two exact ones; the bf16 kernels' tiles
# (128 query rows, key tiles of 128 forward and of 64 in dq, query tiles
# of 64 in dk / dv) at D = 128: a single row, one tile exact, one short,
# one over, and group 1's prefill length (641 = 5 tiles and a row); D =
# 80 (the 64-column region and the 16-column tail) at S = 1,024, B * H =
# 8; windows of 200 ending inside the tiles; one head of 17,000 rows
# (133 tiles of 128: more than the persistent grid's blocks, so a block
# walks several items of one group); the hybrid's shared attention
# (`zamba2-2.7b`: 32 heads of D = 80, G = 1) at group 1's ragged 641
CARD_CASES = [(2, 2, 1, 100, 32, 0), (1, 2, 2, 130, 64, 0),
              (1, 2, 1, 200, 80, 70), (2, 1, 2, 129, 128, 0),
              (1, 1, 1, 300, 128, 65), (1, 3, 1, 64, 16, 0),
              *[(1, 2, 1, s, 128, 0) for s in (1, 64, 127, 128, 129, 641)],
              (2, 4, 1, 1024, 80, 0), (1, 2, 2, 600, 128, 200),
              (1, 2, 2, 600, 80, 200), (1, 1, 1, 17000, 16, 0),
              (1, 32, 1, 641, 80, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CARD_CASES)
def test_card_kernels_match_plain(card, smoke, case, dtype):
    B, K, G, S_, D, window = case
    q, k, v, g = _card_inputs(card, B, K, G, S_, D, S_ + D, dtype)
    before = (ops.flash_fwd.launches, ops.flash_bwd.launches)
    _check_card(smoke, q, k, v, g, window)
    assert (ops.flash_fwd.launches, ops.flash_bwd.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_card_reads_strided_operands(card):
    """q as the model hands it (a transposed projection) and a strided g
    are read in place: no copy, the same result as dense inputs."""
    B, H, S_, D = 2, 4, 96, 128
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((B, S_, H, D)).astype(
        np.float32)).to(torch.bfloat16).to(card)
    q = x.transpose(1, 2)[:, :, None]                 # [B,H,1,S,D] strided
    k, v = (torch.from_numpy(rng.standard_normal((B, H, S_, D)).astype(
        np.float32)).to(torch.bfloat16).to(card) for _ in range(2))
    copies = ops.flash_fwd.copies
    out, lse = ops.flash_fwd(q, k, v)
    dense, _ = ops.flash_fwd(q.contiguous(), k, v)
    g = torch.cat([out, out], dim=-1)[..., :D]        # rows 2D apart
    got = ops.flash_bwd(g, q, k, v, out, lse)
    want = ops.flash_bwd(g.contiguous(), q.contiguous(), k, v, out, lse)
    torch.cuda.synchronize()
    assert ops.flash_fwd.copies == copies
    assert torch.equal(out, dense)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_card_grouped_strided_q(card, smoke):
    """G = 4 query heads a kv head, q (and g) as the projection hands
    them: [B,S,K*G,D] viewed as [B,K,G,S,D], rows K*G*D apart."""
    B, K, G, S_, D = 2, 2, 4, 200, 128
    q, k, v, g = _card_inputs(card, B, K, G, S_, D, seed=44)
    qs, gs = (t.permute(0, 3, 1, 2, 4).contiguous().permute(0, 2, 3, 1, 4)
              for t in (q, g))
    assert qs.stride(3) == K * G * D and torch.equal(qs, q)
    copies = ops.flash_fwd.copies
    _check_card(smoke, qs, k, v, gs, 0)
    assert ops.flash_fwd.copies == copies


@pytest.mark.cuda
def test_card_calls_give_equal_bits(card):
    """Two calls on the same inputs give the same bits (no atomics: the
    backward's dq is its own pass)."""
    q, k, v, g = _card_inputs(card, 2, 4, 1, 1024, 80, seed=7)
    out, lse = ops.flash_fwd(q, k, v)
    out2, lse2 = ops.flash_fwd(q, k, v)
    grads = ops.flash_bwd(g, q, k, v, out, lse)
    grads2 = ops.flash_bwd(g, q, k, v, out, lse)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    for a, b in zip(grads, grads2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_operand_strides_of_a_broadcast(dtype):
    """A broadcast operand (k expanded over the kv heads, stride 0) is
    read in place by the f32 kernels; the bf16 kernels' tensor maps take
    no zero stride, so there the wrapper copies it dense."""
    from repro_torch.kernels import flash
    k = torch.zeros(1, 1, 40, 32, dtype=DTYPES[dtype]).expand(2, 4, 40, 32)
    want = None if dtype == "bfloat16" else (0, 0, 0, 32)
    assert flash.operand_strides(k) == want
    assert flash.operand_strides(k.contiguous()) == (4 * 40 * 32, 40 * 32,
                                                     0, 32)


@pytest.mark.cuda
def test_card_broadcast_operand_is_copied(card):
    """A bf16 k broadcast over the kv heads (stride 0) goes to the
    kernels as a dense copy: the same bits as a dense k, one copy
    counted."""
    q, k, v, g = _card_inputs(card, 1, 4, 1, 96, 64, seed=12)
    kb = k[:, :1].expand_as(k)
    copies = ops.flash_fwd.copies
    out, lse = ops.flash_fwd(q, kb, v)
    want, _ = ops.flash_fwd(q, kb.contiguous(), v)
    torch.cuda.synchronize()
    assert ops.flash_fwd.copies == copies + 1
    assert torch.equal(out, want)
