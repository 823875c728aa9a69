"""Plain PyTorch versions of the port's kernels (the CPU path and the
oracle the CUDA kernels are held against on the card)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize import inv_qmax, qmax
from repro_torch.kernels.rf_predict import inv_trees
from repro_torch.kernels.waterfill import (EPS_DEN, EPS_INC, EPS_SAT,
                                           max_fill_iters)


# ----------------------------------------------------------------------
# Random-forest inference (complete-binary-tree layout)
# ----------------------------------------------------------------------
def rf_predict_ref(feat: torch.Tensor, thr: torch.Tensor,
                   leaf: torch.Tensor, X: torch.Tensor,
                   depth: int) -> torch.Tensor:
    """feat [T, 2^d-1] int32, thr [T, 2^d-1] f32, leaf [T, 2^d] f32,
    X [n, F] f32 -> [n] f32, with the kernel's arithmetic in its order:
    descend with x[max(feat,0)] > thr (a feature index past the row
    reads 0), add the leaf values tree by tree in f32, then multiply
    by the f32 reciprocal of T."""
    T, n_int = feat.shape
    n, F = X.shape
    rows = torch.arange(n, device=X.device)[None, :]
    node = torch.zeros((T, n), dtype=torch.int64, device=X.device)
    for _ in range(depth):
        f = torch.gather(feat, 1, node).clamp(min=0).long()
        t = torch.gather(thr, 1, node)
        xv = X[rows, f.clamp(max=F - 1)]
        xv = torch.where(f < F, xv, torch.zeros_like(xv))
        node = 2 * node + 1 + (xv > t).long()
    vals = torch.gather(leaf, 1, node - n_int)               # [T, n]
    acc = torch.zeros(n, dtype=torch.float32, device=X.device)
    for t in range(T):                                        # tree order
        acc = acc + vals[t]
    inv = torch.tensor(float(inv_trees(T)), dtype=torch.float32,
                       device=X.device)
    return acc * inv


# ----------------------------------------------------------------------
# SSD within-chunk scan (Mamba-2): diagonal block + chunk-end states
# ----------------------------------------------------------------------
def chunk_cumsum(da: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis in the kernel's order
    (csrc/ssd_chunk.cu `chunk_cumsum`): a Hillis-Steele scan within each
    32-element segment, then each segment plus the running total of the
    ones before. The sums are the same as `torch.cumsum`'s, rounded in
    that order, so the decay factors exp(cum[q] - cum[k]) of the two
    versions agree to the bit: with log-decays summing to ~1e3 over a
    chunk (as the served model's do) another order moves them by
    ~1e-4 relative."""
    Q = da.shape[-1]
    n_seg = -(-Q // 32)
    v = F.pad(da, (0, n_seg * 32 - Q)).reshape(*da.shape[:-1], n_seg, 32)
    for o in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :o], v[..., o:] + v[..., :-o]], dim=-1)
    segs, carry = [], torch.zeros_like(v[..., 0, 0])
    for s in range(n_seg):
        seg = v[..., s, :] + carry[..., None]
        segs.append(seg)
        carry = seg[..., 31]
    return torch.cat(segs, dim=-1)[..., :Q]


def ssd_chunk_ref(xq: torch.Tensor, Bq: torch.Tensor, Cq: torch.Tensor,
                  da: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xq [B,nC,Q,H,P] (pre-multiplied by dt), Bq/Cq [B,nC,Q,N], da
    [B,nC,H,Q] -> (y_diag [B,nC,Q,H,P], states [B,nC,H,P,N]), both f32,
    computed in f32 from the stored dtype: the cumulative log-decay (in
    the kernel's order, `chunk_cumsum`), the causal decay mask (masked
    BEFORE exp: the upper triangle is positive and would overflow),
    y = (C B^T * L) x, and the chunk-end states
    sum_k exp(cum[Q-1] - cum[k]) x[k] B[k]^T."""
    x, Bf, Cf = xq.float(), Bq.float(), Cq.float()
    Q = xq.shape[2]
    cum = chunk_cumsum(da.float())                           # [B,nC,H,Q]
    seg = cum[..., :, None] - cum[..., None, :]              # [B,nC,H,Q,Q]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xq.device).tril()
    L = torch.exp(torch.where(tri, seg, -1e30))
    cb = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)             # [B,nC,Q,Q]
    scores = cb[:, :, None] * L                              # [B,nC,H,Q,Q]
    y = torch.einsum("bchqk,bckhp->bcqhp", scores, x)
    dec_r = torch.exp(cum[..., -1:] - cum)                   # [B,nC,H,Q]
    xw = x.permute(0, 1, 3, 2, 4) * dec_r[..., None]         # [B,nC,H,Q,P]
    states = torch.einsum("bchkp,bckn->bchpn", xw, Bf)
    return y, states


def reverse_cumsum(v: torch.Tensor) -> torch.Tensor:
    """sum_{j >= i} v[..., j] over the last axis, in the backward
    kernel's order: :func:`chunk_cumsum` of the reversed axis (its
    32-element segments start at the last element)."""
    return chunk_cumsum(v.flip(-1)).flip(-1)


def ssd_chunk_bwd_ref(xq: torch.Tensor, Bq: torch.Tensor, Cq: torch.Tensor,
                      da: torch.Tensor, dy: torch.Tensor, dst: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """The gradient of :func:`ssd_chunk_ref` given the cotangents dy
    [B,nC,Q,H,P] of y_diag and dst [B,nC,H,P,N] of the states (both
    f32) -> (dx, dB, dC in the inputs' dtype, each rounded once from
    f32; dda [B,nC,H,Q] f32). With cum, L (masked before exp), G = C B^T,
    S = G o L and r[k] = exp(cum[Q-1] - cum[k]) as the forward takes
    them, per head:
      dS = (dy x^T) masked causal,    dx = S^T dy + r o (B dst^T),
      dG = sum_h dS o L,              dC = dG B,
      dB = dG^T C + sum_h r o (x dst),
      E = dS o S:  dcum[q] = sum_k E[q, k] - sum_q' E[q', q]
                   - rho[q] + [q = Q-1] sum_k rho[k],
      rho[k] = r[k] sum_{p,n} x[k, p] B[k, n] dst[p, n],
    and dda = :func:`reverse_cumsum` of dcum (the kernel's order)."""
    x, Bf, Cf = xq.float(), Bq.float(), Cq.float()
    Q = xq.shape[2]
    cum = chunk_cumsum(da.float())                           # [B,nC,H,Q]
    seg = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xq.device).tril()
    L = torch.exp(torch.where(tri, seg, -1e30))              # [B,nC,H,Q,Q]
    G = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)              # [B,nC,Q,Q]
    S = G[:, :, None] * L
    dS = torch.where(tri, torch.einsum("bcqhp,bckhp->bchqk", dy, x), 0.0)
    r = torch.exp(cum[..., -1:] - cum)                       # [B,nC,H,Q]
    bdst = torch.einsum("bckn,bchpn->bchkp", Bf, dst)        # [B,nC,H,Q,P]
    dx = torch.einsum("bchqk,bcqhp->bckhp", S, dy) + \
        (r[..., None] * bdst).permute(0, 1, 3, 2, 4)
    dG = (dS * L).sum(dim=2)                                 # [B,nC,Q,Q]
    xdst = torch.einsum("bckhp,bchpn->bchkn", x, dst)        # [B,nC,H,Q,N]
    dB = torch.einsum("bcqk,bcqn->bckn", dG, Cf) + \
        (r[..., None] * xdst).sum(dim=2)
    dC = torch.einsum("bcqk,bckn->bcqn", dG, Bf)
    E = dS * S
    rho = r * torch.einsum("bckhp,bchkp->bchk", x, bdst)
    dcum = E.sum(-1) - E.sum(-2) - rho
    dcum[..., -1] += rho.sum(-1)
    return (dx.to(xq.dtype), dB.to(Bq.dtype), dC.to(Cq.dtype),
            reverse_cumsum(dcum))


# ----------------------------------------------------------------------
# SiLU gates (Mamba-2), rounded as XLA on the CPU rounds jax.nn.silu
# ----------------------------------------------------------------------
def silu_ref(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as XLA on the CPU computes the reference's
    `jax.nn.silu`: the logistic expanded to 1 / (1 + exp(-x)), each op
    rounded to x's dtype. In bf16 that rounds four times where `F.silu`
    rounds once, which moves many outputs by an ulp."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def silu_gate_ref(y: torch.Tensor, z: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The input of the reference's `rms_norm(y * silu(z), scale)` as its
    compiled program keeps it: (the product rounded to y's dtype, the
    value path; the unrounded f32 product, which XLA fuses into the
    variance, dropping that f32 -> dtype -> f32 pair)."""
    prod = y.float() * silu_ref(z).float()
    return prod.to(y.dtype), prod


def silu_gate_bwd_ref(g: torch.Tensor, y: torch.Tensor, z: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of the SwiGLU gate's value silu(z) * y given its
    cotangent g, as XLA on the CPU derives and rounds the reference's
    `jax.nn.silu(x @ w1) * (x @ w3)`: with s the logistic of
    :func:`silu_ref` (each op rounded), dy = g * silu(z) and dz =
    g*y*s + (z*(g*y)) * (s*(1 - s)), every op rounded to the dtype ->
    (dy, dz)."""
    s = torch.reciprocal(1 + torch.exp(-z))
    dy = g * (z * s)
    gy = g * y
    dz = gy * s + (z * gy) * (s * (1 - s))
    return dy, dz


def silu_bwd_ref(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`silu_ref` given its cotangent g (g, x of
    one dtype), as XLA on the CPU derives and rounds the jitted
    `jax.vjp(jax.nn.silu)`: g*s + (x*g) * (s*(1 - s)), every op rounded
    to the dtype. That is :func:`silu_gate_bwd_ref`'s dz with y = 1
    (g * 1 is g)."""
    s = torch.reciprocal(1 + torch.exp(-x))
    return g * s + (x * g) * (s * (1 - s))


def silu_gate_prod_bwd_ref(g_value: torch.Tensor, g_prod: torch.Tensor,
                           y: torch.Tensor, z: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`silu_gate_ref`'s two outputs given their
    cotangents: g_value of the rounded product (y's dtype, the norm's
    value path) and g_prod of the f32 product (f32, the norm's
    variance). XLA's compiled gradient of the reference's
    `rms_norm(y * silu(z))` rounds the variance path's cotangent to y's
    dtype before it adds the value path's, then rounds the sum; from
    that cotangent on it is :func:`silu_gate_bwd_ref` -> (dy, dz)."""
    g = g_value + g_prod.to(y.dtype)
    return silu_gate_bwd_ref(g, y, z)


# ----------------------------------------------------------------------
# Symmetric abs-max quantize / dequantize (the wire codec)
# ----------------------------------------------------------------------
def _scale_of(amax: torch.Tensor, bits: int) -> torch.Tensor:
    """max(amax, 1e-12) times the f32 reciprocal of qmax (the
    reference's `amax / qmax` as XLA computes it); NaN propagates."""
    tiny = torch.tensor(1e-12, dtype=torch.float32, device=amax.device)
    inv = torch.tensor(inv_qmax(bits), device=amax.device)
    return torch.maximum(amax, tiny) * inv


def _payload(xf: torch.Tensor, scale: torch.Tensor, bits: int
             ) -> torch.Tensor:
    """clip(round_half_even(x / scale), +-qmax) as int8; the divide is
    a true divide, as the reference's is."""
    m = qmax(bits)
    return torch.round(xf / scale).clamp(-m, m).to(torch.int8)


def quantize_groups_ref(x2d: torch.Tensor, bits: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d [G, L] (f32 or bf16) -> (q int8 [G, L], scale f32 [G]): each
    row is one group with one scale, computed in f32."""
    xf = x2d.float()
    scale = _scale_of(xf.abs().amax(dim=1), bits)
    return _payload(xf, scale[:, None], bits), scale


def dequantize_groups_ref(q: torch.Tensor, scale: torch.Tensor,
                          dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """q [G, L] int8, scale [G] f32 -> f32(q) * scale, cast to dtype."""
    return (q.float() * scale[:, None]).to(dtype)


def dequantize_groups_add_ref(q: torch.Tensor, scale: torch.Tensor,
                              acc: torch.Tensor) -> torch.Tensor:
    """acc += f32(q) * scale[:, None] in place (acc f32 [G, L], may be a
    view), with one rounding: the product and the sum in f64, rounded
    once to f32. An int8 times an f32 is exact in f64, so this is the
    kernel's `fmaf` except where rounding the f64 sum first lands on an
    f32 tie (an addend below 2^-29 of the other)."""
    acc.copy_((q.double() * scale.double()[:, None] + acc.double()).float())
    return acc


def _tiles(t: torch.Tensor, block: int) -> torch.Tensor:
    n, d = t.shape
    return t.reshape(n // block, block, d // block, block)


def quantize_ref(x: torch.Tensor, bits: int = 8, block: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [n, d] (n, d multiples of block) -> (q int8 [n, d], scale f32
    [n/block, d/block]): one scale per block x block tile."""
    xt = _tiles(x.float(), block)
    scale = _scale_of(xt.abs().amax(dim=(1, 3)), bits)
    q = _payload(xt, scale[:, None, :, None], bits)
    return q.reshape(x.shape), scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor, block: int = 256,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Invert :func:`quantize_ref`: each tile's scale broadcast back."""
    out = _tiles(q, block).float() * scale[:, None, :, None]
    return out.reshape(q.shape).to(dtype)


# ----------------------------------------------------------------------
# Progressive water-fill (batched, float64)
# ----------------------------------------------------------------------
def fill_rates_ref(c: torch.Tensor, single: torch.Tensor,
                   egress: torch.Tensor, ingress: torch.Tensor,
                   w: torch.Tensor, path_cap: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """c / single / path_cap [B, N, N], egress / ingress [B, N], w
    [N, N] or [B, N, N], all f64 -> (rate [B, N, N] f64, iters [B]
    int32, converged [B] bool): the kernel's loop (the JAX package's
    `fill_rates_loop`) with per-batch masks, at most `max_fill_iters(N)`
    iterations, the kernel's bound. It asks the host whether any fill
    is left after every iteration, so it is for the tests and the
    card's comparison, not for speed."""
    B, n, _ = c.shape
    w = torch.broadcast_to(w, c.shape)
    cw = c * w
    w_pos, cw_pos = w > 0, cw > 0
    w_den = torch.clamp(w, min=EPS_DEN)
    cw_den = torch.clamp(cw, min=EPS_DEN)
    inf = torch.tensor(float("inf"), dtype=c.dtype, device=c.device)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    rate = torch.zeros_like(c)
    frozen = c <= 0
    done = frozen.flatten(1).all(1)
    iters = torch.zeros(B, dtype=torch.int32, device=c.device)
    for _ in range(max_fill_iters(n)):
        if bool(done.all()):
            break
        act = ~frozen & ~done[:, None, None]
        cw_act = torch.where(act, cw, zero)
        we, wi = cw_act.sum(-1), cw_act.sum(-2)
        load = rate * c
        head_e = egress - load.sum(-1)
        head_i = ingress - load.sum(-2)
        inc_e = torch.where(we > 0, head_e / torch.clamp(we, min=EPS_DEN),
                            inf)
        inc_i = torch.where(wi > 0, head_i / torch.clamp(wi, min=EPS_DEN),
                            inf)
        inc_conn = torch.where(act & w_pos, (single - rate) / w_den, inf)
        inc_path = torch.where(act & cw_pos, (path_cap - load) / cw_den,
                               inf)
        inc = torch.minimum(
            torch.minimum(inc_e.amin(-1), inc_i.amin(-1)),
            torch.minimum(inc_conn, inc_path).flatten(1).amin(1))
        inc = torch.where(torch.isfinite(inc) & (inc >= EPS_INC), inc, zero)
        rate = torch.where(act, rate + inc[:, None, None] * w, rate)
        load = rate * c
        hit = act & (((single - rate) < EPS_SAT) |
                     ((path_cap - load) < EPS_SAT))
        sat_e = (egress - load.sum(-1)) < EPS_SAT
        sat_i = (ingress - load.sum(-2)) < EPS_SAT
        hit = hit | (act & (sat_e[:, :, None] | sat_i[:, None, :]))
        frozen = frozen | hit
        stalled = ~hit.flatten(1).any(1) & (inc == 0)
        iters = iters + (~done).to(torch.int32)
        done = done | frozen.flatten(1).all(1) | stalled
    return rate, iters, done


# ----------------------------------------------------------------------
# Flash attention (the dense family's; `flash_attention`'s forward and
# its custom VJP's backward)
# ----------------------------------------------------------------------
NEG_INF = -1e30     # masked scores: a wholly masked block stays finite


def _flash_mask(i: int, bk: int, Sq: int, Sk: int, window: int,
                device) -> torch.Tensor:
    """[Sq, bk] validity of key block i: inside Sk, causal, in the
    window."""
    qpos = torch.arange(Sq, device=device)
    kpos = i * bk + torch.arange(bk, device=device)
    mask = (kpos[None, :] < Sk) & (qpos[:, None] >= kpos[None, :])
    if window > 0:
        mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
    return mask


def _flash_key_blocks(k: torch.Tensor, v: torch.Tensor, block_k: int):
    """(k, v zero-padded along Sk to a multiple of the block, the
    block bk, the block count)."""
    Sk = k.shape[2]
    bk = min(block_k, Sk)
    if Sk % bk:
        pad = bk - Sk % bk
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    return k, v, bk, k.shape[2] // bk


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int, block_k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention's forward, q [B,K,G,Sq,Dq], k [B,K,Sk,Dq], v
    [B,K,Sk,Dv], causal (and windowed where window > 0), scaled by
    Dq ** -0.5 after the f32 product -> (out in v's dtype, lse
    [B,K,G,Sq] f32): the reference's online softmax over key blocks of
    `block_k` (`src/repro/models/attention.py:39`), in its order and
    with its roundings (p rounded to v's dtype before PV). Dq and Dv
    may differ, and the dtypes may be mixed as MLA's are (q and v bf16,
    k f32): q and k are upcast with `.float()`, so an f32 k enters the
    score product as it is, as the reference's `einsum_f32` takes it,
    and p is rounded to v's dtype."""
    B, K, G, Sq, Dq = q.shape
    Sk, Dv = k.shape[2], v.shape[3]
    sc = Dq ** -0.5
    k, v, bk, nb = _flash_key_blocks(k, v, block_k)
    qf = q.reshape(B, K, G * Sq, Dq).float()
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, Sq, Dv), dtype=torch.float32,
                      device=q.device)
    for i in range(nb):
        kblk = k[:, :, i * bk:(i + 1) * bk]
        vblk = v[:, :, i * bk:(i + 1) * bk]
        s = torch.matmul(qf, kblk.float().transpose(-1, -2)).view(
            B, K, G, Sq, bk) * sc
        s = torch.where(_flash_mask(i, bk, Sq, Sk, window, q.device), s,
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p.to(v.dtype).view(B, K, G * Sq, bk).float(),
                          vblk.float())
        acc = acc * corr[..., None] + pv.view(B, K, G, Sq, Dv)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    return (acc / l_safe[..., None]).to(v.dtype), m + torch.log(l_safe)


def flash_fwd_mla_ref(q_nope: torch.Tensor, q_rope: torch.Tensor,
                      k_nope: torch.Tensor, k_rope: torch.Tensor,
                      v: torch.Tensor, block_k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MLA's flash forward from its parts (q_nope, q_rope [B,H,S,*],
    k_nope [B,H,S,nd] f32, k_rope [B,1,S,rd], v [B,H,S,Dv]) as the
    reference's `mla_forward` makes it (`src/repro/models/
    attention.py:351-359`): q = [q_nope, q_rope], k = [k_nope, k_rope
    expanded over the heads] (the concatenation promotes the rope key to
    f32), then :func:`flash_fwd_ref` causal over key blocks of `block_k`
    -> (out [B,H,1,S,Dv], lse [B,H,1,S])."""
    B, H, S, rd = q_rope.shape
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope.float(),
                   k_rope.float().expand(B, H, S, rd)], dim=-1)
    return flash_fwd_ref(q[:, :, None], k, v, 0, block_k)


def flash_bwd_ref(g: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                  window: int, block_k: int):
    """(dq, dk, dv) in the operands' dtypes: the reference's custom VJP
    (`src/repro/models/attention.py:99-124`). Per key block it
    recomputes the exact probabilities p = exp(s - lse) from the saved
    lse, then dv = p^T g, dp = g v^T, ds = p (dp - delta), dq += ds k,
    dk = ds^T q, every product in f32."""
    B, K, G, Sq, Dq = q.shape
    Sk, Dv = k.shape[2], v.shape[3]
    sc = Dq ** -0.5
    kp, vp, bk, nb = _flash_key_blocks(k, v, block_k)
    qf = q.reshape(B, K, G * Sq, Dq).float()
    g32 = g.float()
    delta = torch.sum(g32 * out.float(), dim=-1)             # [B,K,G,Sq]
    g2 = g32.reshape(B, K, G * Sq, Dv)
    dq = torch.zeros((B, K, G * Sq, Dq), dtype=torch.float32,
                     device=q.device)
    dk, dv = [], []
    for i in range(nb):
        kblk = kp[:, :, i * bk:(i + 1) * bk].float()
        vblk = vp[:, :, i * bk:(i + 1) * bk].float()
        s = torch.matmul(qf, kblk.transpose(-1, -2)).view(
            B, K, G, Sq, bk) * sc
        s = torch.where(_flash_mask(i, bk, Sq, Sk, window, q.device), s,
                        NEG_INF)
        p = torch.exp(s - lse[..., None]).view(B, K, G * Sq, bk)
        dv.append(torch.matmul(p.transpose(-1, -2), g2))
        dp = torch.matmul(g2, vblk.transpose(-1, -2))
        ds = p * (dp - delta.reshape(B, K, G * Sq)[..., None])
        dq = dq + torch.matmul(ds, kblk) * sc
        dk.append(torch.matmul(ds.transpose(-1, -2), qf) * sc)
    dk = torch.cat(dk, dim=2)[:, :, :Sk]
    dv = torch.cat(dv, dim=2)[:, :, :Sk]
    return (dq.view(B, K, G, Sq, Dq).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def rope_head_sum(dk_rope: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The gradient of MLA's one rope key from each head's: dk_rope
    [B,H,S,rd] (f32) -> [B,1,S,rd] in `dtype`. The reference's
    concatenation promotes the broadcast rope key to f32, so its
    transpose converts each head's cotangent to the key's dtype and then
    sums over the heads in that dtype, which XLA's CPU program does as
    :func:`gate_window_sum` (windows of 32 heads, every add rounded in
    bf16)."""
    t = dk_rope.to(dtype).permute(0, 2, 3, 1)                # [B,S,rd,H]
    return gate_window_sum(t).to(dtype)[:, None]


def flash_bwd_mla_ref(g: torch.Tensor, q_nope: torch.Tensor,
                      q_rope: torch.Tensor, k_nope: torch.Tensor,
                      k_rope: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor, block_k: int):
    """MLA's flash backward from its parts: :func:`flash_bwd_ref` on the
    reference's concatenations (:func:`flash_fwd_mla_ref`'s), then the
    concatenations' transposes -> (dq_nope, dq_rope in q's dtype, dk_nope
    f32, dk_rope [B,1,S,rd] in k_rope's dtype, dv in v's dtype). dq is
    cast once and sliced; dk stays f32 (the reference's k is), its nope
    columns are k_nope's gradient and its rope columns summed over the
    heads (:func:`rope_head_sum`) the rope key's."""
    B, H, S, nd = q_nope.shape
    rd = q_rope.shape[3]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope.float(),
                   k_rope.float().expand(B, H, S, rd)], dim=-1)
    dq, dk, dv = flash_bwd_ref(g, q[:, :, None], k, v, out, lse, 0, block_k)
    dq = dq[:, :, 0]
    return (dq[..., :nd], dq[..., nd:], dk[..., :nd],
            rope_head_sum(dk[..., nd:], k_rope.dtype), dv)


# ----------------------------------------------------------------------
# MoE slots, dispatch and combine (the reference's one-hot cumulative
# count, k sequential scatters and k gathers, src/repro/models/moe.py)
# ----------------------------------------------------------------------
def moe_positions_ref(eidx: torch.Tensor, E: int, C: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """eidx [G, T_g, k] -> (pos_c, keep) [G, T_g, k]: each choice's slot,
    its rank among the choices of its expert over the flattened (token,
    choice) stream of its group (a cumulative sum of one-hots, as the
    reference counts), kept where below C; a dropped choice's slot is
    0. The one-hots are laid out [G, E, T_g * k], so the sum runs along
    the innermost dim: along the stream's dim of a [G, T_g * k, E]
    layout, CUDA's scan took ~4 ms a layer on an H100 at group 1's 20,512
    choices."""
    G, Tg, k = eidx.shape
    ef = eidx.reshape(G, 1, Tg * k)
    experts_ = torch.arange(E, device=eidx.device)[:, None]
    count = torch.cumsum(ef == experts_, dim=2)           # [G, E, Tg*k]
    pos = count.gather(1, ef)[:, 0] - 1
    keep = pos < C
    return torch.where(keep, pos, 0).reshape(G, Tg, k), keep.reshape(G, Tg, k)


def moe_slots_ref(eidx: torch.Tensor, E: int, C: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """eidx [G, T_g, k] int64 -> (pos_c, keep, src): the capacity slots
    of :func:`moe_positions_ref` and their inverse, src [G, E, C] int32,
    the token whose kept choice holds slot (e, c) of group g, -1 where
    none does."""
    G, Tg, k = eidx.shape
    dev = eidx.device
    pos_c, keep = moe_positions_ref(eidx, E, C)
    slot = torch.arange(G, device=dev)[:, None, None] * (E * C) + \
        eidx * C + pos_c
    tok = torch.arange(Tg, dtype=torch.int32, device=dev)[None, :, None]
    src = torch.full((G * E * C,), -1, dtype=torch.int32, device=dev)
    src[slot[keep]] = tok.expand(G, Tg, k)[keep]
    return pos_c, keep, src.view(G, E, C)


def moe_dispatch_gather_ref(x: torch.Tensor, src: torch.Tensor
                            ) -> torch.Tensor:
    """x [T,d] f32 / bf16, src [E,C] int32 -> buf [E,C,d] in x's dtype:
    each slot's row x[src] (a -0.0 written as +0.0) and zeros where src
    is -1, as a gather from x padded with one zero row followed by an
    add of +0.0 in f32, which clears the sign of zeros and nothing
    else. Equal bit for bit to :func:`moe_dispatch_ref` on the routing
    that `src` inverts."""
    T, d = x.shape
    xpad = torch.cat([x, x.new_zeros((1, d))])
    idx = torch.where(src < 0, T, src).reshape(-1).long()
    rows = torch.index_select(xpad, 0, idx)
    return (rows.float() + 0.0).to(x.dtype).view(*src.shape, d)


def moe_dispatch_ref(x: torch.Tensor, eidx: torch.Tensor,
                     pos_c: torch.Tensor, keep: torch.Tensor, E: int,
                     C: int) -> torch.Tensor:
    """x [T,d] f32 / bf16, eidx / pos_c [T,k] int64, keep [T,k] bool ->
    buf [E,C,d] in x's dtype: the reference's k scatter-adds, choice 0
    first, of where(keep, x, 0) into slot (eidx, pos_c) of a zero
    buffer, each add taken in f32 and rounded to x's dtype as XLA's
    CPU program takes it. A dropped choice adds zeros to slot 0 of its
    expert. Every kept choice owns a slot of its own, so the buffer is
    a copy of x's rows with -0.0 written as +0.0 (+0.0 + -0.0 = +0.0),
    and zeros in the slots no choice fills."""
    d = x.shape[1]
    buf = torch.zeros((E * C, d), dtype=torch.float32, device=x.device)
    xf = x.float()
    for j in range(eidx.shape[1]):
        vals = torch.where(keep[:, j, None], xf, 0.0)
        buf.index_add_(0, eidx[:, j] * C + pos_c[:, j], vals)
    return buf.to(x.dtype).view(E, C, d)


def moe_combine_ref(ob: torch.Tensor, eidx: torch.Tensor,
                    pos_c: torch.Tensor, keep: torch.Tensor,
                    gates: torch.Tensor) -> torch.Tensor:
    """ob [E,C,d] f32 / bf16, eidx / pos_c [T,k] int64, keep [T,k]
    bool, gates [T,k] f32 -> y [T,d] in ob's dtype, as XLA's CPU
    program computes the reference's k gathers: with r the rounding to
    ob's dtype, t_j = r(where(keep_j, ob[e_j, p_j], 0) * r(g_j)) (the
    product in f32), then y = t_0 and y = r(y + t_j) for j = 1..k-1
    (XLA folds the first add onto zeros, so a -0.0 in t_0 survives). In
    f32 the same order with no rounding."""
    E, C, d = ob.shape
    flat = ob.reshape(E * C, d)
    g = gates.to(ob.dtype)
    y = None
    for j in range(eidx.shape[1]):
        rows = flat[eidx[:, j] * C + pos_c[:, j]]
        t = torch.where(keep[:, j, None], rows, 0) * g[:, j, None]
        y = t if y is None else y + t
    return y


# ----------------------------------------------------------------------
# Their backwards, as XLA's CPU program computes the reference's
# transposes (jax.vjp of the k scatter-adds and of the k gathers)
# ----------------------------------------------------------------------
GATE_WINDOW = 32             # XLA's reduce-window of a row sum over d


def _plus_zero(t: torch.Tensor) -> torch.Tensor:
    """t with every -0.0 written as +0.0."""
    return torch.where(t == 0, torch.zeros_like(t), t)


def moe_dispatch_bwd_ref(g: torch.Tensor, eidx: torch.Tensor,
                         pos_c: torch.Tensor, keep: torch.Tensor
                         ) -> torch.Tensor:
    """The dispatch's gradient: the buffer's cotangent g [E,C,d] f32 /
    bf16 and the routing eidx / pos_c [T,k] int64, keep [T,k] bool ->
    dx [T,d] in g's dtype. The transpose of each scatter-add is a gather
    of g at the choice's slot, masked by keep; XLA adds the k gathered
    rows last choice first, each add in f32 rounded to g's dtype, the
    first row as it is (no add onto zeros): dx = t_{k-1}, then dx =
    r(dx + t_j) for j = k-2..0, a dropped choice's t_j +0.0."""
    E, C, d = g.shape
    flat = g.reshape(E * C, d)
    dx = None
    for j in reversed(range(eidx.shape[1])):
        t = torch.where(keep[:, j, None], flat[eidx[:, j] * C + pos_c[:, j]],
                        0)
        dx = t if dx is None else dx + t
    return dx


def moe_combine_bwd_ref(dy: torch.Tensor, gates: torch.Tensor,
                        eidx: torch.Tensor, pos_c: torch.Tensor,
                        keep: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """The combine's gradient in ob: dy [T,d] f32 / bf16, gates [T,k]
    f32 and the routing -> d_ob [E,C,d] in dy's dtype. The transpose of
    choice j's gather is an f32 scatter-add of where(keep_j, r(dy *
    r(g_j)), 0) into slot (e_j, p_j) of zeros (r the rounding to dy's
    dtype; the bf16 product of two bf16 values, taken in f32 and rounded
    once); XLA adds the k scattered buffers. Each slot holds at most
    one kept choice, and a dropped one adds +0.0 to slot (e_j, 0), so a
    slot is its choice's product with -0.0 written as +0.0, and zeros
    where no choice is kept."""
    T, d = dy.shape
    out = torch.zeros((E * C, d), dtype=torch.float32, device=dy.device)
    g = gates.to(dy.dtype)
    for j in range(eidx.shape[1]):
        v = torch.where(keep[:, j, None], dy * g[:, j, None], 0)
        out.index_add_(0, eidx[:, j] * C + pos_c[:, j], v.float())
    return out.to(dy.dtype).view(E, C, d)


def gate_window_sum(p: torch.Tensor, fma_with=None) -> torch.Tensor:
    """The sum over the last axis of p [..., d] (f32 or bf16 terms) as
    XLA's CPU program reduces a row of the combine's gate cotangent, in
    f32 with a rounding to p's dtype after every add, -> f32 values of
    p's dtype with -0.0 written as +0.0. Over d > GATE_WINDOW: a
    reduce-window of GATE_WINDOW terms, the row padded with zeros to a
    multiple of it (half the pad before the row, the odd one after),
    each window summed in order from its first term, then the windows
    summed in order. Over d <= GATE_WINDOW one sum in order; in f32
    there XLA fuses the products into the sum, fma(a_i, b_i, acc): pass
    `fma_with = (a, b)` (f32, p's shape), taken in f64 and rounded to
    f32 at each step (an exact product, one rounding of the add to f64
    and one to f32)."""
    rnd = (lambda t: t) if p.dtype == torch.float32 else \
        (lambda t: t.to(p.dtype).float())
    d = p.shape[-1]

    def in_order(t):
        acc = t[..., 0].float()
        for i in range(1, t.shape[-1]):
            acc = rnd(acc + t[..., i].float())
        return acc
    if d <= GATE_WINDOW:
        if fma_with is None:
            return _plus_zero(in_order(p))
        a, b = (t.double() for t in fma_with)
        acc = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
        for i in range(d):
            acc = (acc.double() + a[..., i] * b[..., i]).float()
        return _plus_zero(acc)
    n = -(-d // GATE_WINDOW)
    pad = n * GATE_WINDOW - d
    w = F.pad(p.float(), (pad // 2, pad - pad // 2)).to(p.dtype)
    return _plus_zero(in_order(in_order(
        w.reshape(*p.shape[:-1], n, GATE_WINDOW)).to(p.dtype)))


def moe_gates_bwd_ref(dy: torch.Tensor, ob: torch.Tensor, eidx: torch.Tensor,
                      pos_c: torch.Tensor, keep: torch.Tensor
                      ) -> torch.Tensor:
    """The combine's gradient in its gates: dy [T,d] and ob [E,C,d] of
    one dtype (f32 / bf16) and the routing -> dgates [T,k] f32. The
    transpose of `where(keep_j, row_j, 0) * r(g_j)` in g_j is the sum
    over d of r(dy * where(keep_j, row_j, 0)), reduced as
    :func:`gate_window_sum` (bf16: rounded after every add; f32 at d <=
    32: fused multiply-adds), then widened to f32; a dropped choice's
    is +0.0."""
    E, C, d = ob.shape
    flat = ob.reshape(E * C, d)
    rows = torch.stack([torch.where(keep[:, j, None],
                                    flat[eidx[:, j] * C + pos_c[:, j]], 0)
                        for j in range(eidx.shape[1])], 1)     # [T,k,d]
    dyk = dy[:, None, :].expand_as(rows)
    fma = (dyk.float(), rows.float()) if dy.dtype == torch.float32 and \
        d <= GATE_WINDOW else None
    return gate_window_sum(dyk * rows, fma)
