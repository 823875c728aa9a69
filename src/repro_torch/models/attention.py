"""Attention of the dense family: GQA with optional qk-norm and sliding
window, and MLA (multi-head latent attention); flash (online-softmax)
attention for prefill and the full forward; cached decode over a
[B,KV,S,D] cache (a ring buffer of the window's size for SWA archs), or
over MLA's latent cache.

Port of `repro/models/attention.py`. The reference runs these as jit programs; its comment
names a Pallas kernel as the TPU's production path of flash attention.
Here flash's forward and its custom VJP's backward are hand-written CUDA
kernels on the card (`ops.flash_fwd` / `ops.flash_bwd`, and MLA's from
its parts, `ops.flash_fwd_mla` / `ops.flash_bwd_mla`; `csrc/flash_attn.cu`)
and their plain versions on the host (`kernels/ref.py::flash_fwd_ref` /
`flash_bwd_ref` / `flash_fwd_mla_ref` / `flash_bwd_mla_ref`, in the
reference's block order); the
banded and decode paths are plain torch on both devices. All keep the
reference's roundings:

- score products in f32: bf16 inputs are upcast, then multiplied (the
  reference's `einsum_f32` on the CPU; keep TF32 off on the card);
- `flash_attention` scales the f32 scores after the product;
  `swa_attention` and `gqa_decode` scale q before it, by the scale
  rounded to the compute dtype (JAX's weak-typed scalar), the product
  in f32 and not rounded (XLA drops that rounding before the f32
  product), and take the softmax as exp(s - max) / sum;
- the probabilities are rounded to v's dtype before the PV product;
  flash casts its output to v's dtype, decode keeps it f32 through
  `@ wo` (an f32 product, cast after), the forward's `@ wo` is in the
  compute dtype;
- masked scores are `NEG_INF = -1e30`, not -inf: a row masked through
  a whole key block gets p = 1 there, and the next block's
  correction exp(m - m_new) = 0 wipes it;
- `flash_attention`'s gradient is the reference's custom VJP (f32
  products, probabilities recomputed per key block from the saved
  log-sum-exp); the KV-head expansion's gradient sums dk / dv over the
  group, and `swa_attention`'s banded path differentiates through its
  ops, as the reference's do;
- KV heads expand with `repeat_interleave` (`jnp.repeat`): query head h
  reads KV head h // G;
- MLA: k_nope, the rope scores and o_lat are f32 products (k_nope read
  from c_kv's unrounded last product, as XLA compiles the reference), v,
  q_abs and the W_uv product are products in the compute dtype, o_lat
  is rounded to it, decode's scores are the sum of two f32 products
  (q_abs . c_kv not rounded) times the f32 scale, and decode's `@ wo`
  is in the compute dtype (not f32, as `gqa_decode`'s).

The functions take one layer's attention parameters as a dict of
tensors in the compute dtype (`transformer.DenseLM.compute_params`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (apply_rope, dense_init, head_rms_norm,
                                      rms_norm)

FLASH_BLOCK = 512           # the reference's `ShardCtx.flash_block` default


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands upcast to f32 (`einsum_f32`)."""
    return torch.matmul(a.float(), b.float())


def _scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x * scale in f32, the scale first rounded to x's dtype (JAX
    multiplies by a weak-typed Python float) and the product not
    rounded: XLA's CPU program computes the bf16 multiply in f32 and
    drops its rounding before the f32 product reads it."""
    return x.float() * torch.tensor(scale, dtype=x.dtype).float()


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softmax` as XLA computes it: exp(s - max) divided by its
    sum. ATen's CUDA softmax divides too, in one kernel; its CPU kernel
    multiplies by the reciprocal, so the host spells the division
    out."""
    if s.is_cuda:
        return torch.softmax(s, dim=-1)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class _Flash(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: the forward
    saves (q, k, v, out, lse), the backward recomputes each key block's
    probabilities, so no per-block residual of the forward is kept."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, block_k: int):
        out, lse = ops.flash_fwd(q, k, v, window, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.block_k = window, block_k
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ops.flash_bwd(g, q, k, v, out, lse, ctx.window,
                                   ctx.block_k)
        return dq, dk, dv, None, None


class _FlashMla(torch.autograd.Function):
    """MLA's flash attention from its parts, with the reference's custom
    VJP on its concatenations: the forward saves the parts, out and lse,
    the backward (`ops.flash_bwd_mla`) gives each part its cotangent
    (dk_nope in f32, dk_rope summed over the heads)."""

    @staticmethod
    def forward(ctx, q_nope, q_rope, k_nope, k_rope, v, block_k: int):
        out, lse = ops.flash_fwd_mla(q_nope, q_rope, k_nope, k_rope, v,
                                     block_k)
        ctx.save_for_backward(q_nope, q_rope, k_nope, k_rope, v, out, lse)
        ctx.block_k = block_k
        return out

    @staticmethod
    def backward(ctx, g):
        q_nope, q_rope, k_nope, k_rope, v, out, lse = ctx.saved_tensors
        grads = ops.flash_bwd_mla(g, q_nope, q_rope, k_nope, k_rope, v, out,
                                  lse, ctx.block_k)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, block_k: int = FLASH_BLOCK
                    ) -> torch.Tensor:
    """Causal attention, q: [B,K,G,Sq,Dq]  k: [B,K,Sk,Dq]  v: [B,K,Sk,Dv]
    -> [B,K,G,Sq,Dv], scaled by Dq ** -0.5.

    K = kv heads, G = query group size (Hq = K*G), Sq == Sk. Dq and Dv
    may differ, and on the CPU k may be f32 beside a bf16 q and v (MLA's
    concatenated keys; `mla_forward` runs flash from MLA's parts through
    `ops.flash_fwd_mla` instead); on the card each head dim is a multiple
    of 16 up to 128 (`ops.flash_fwd` states the kernel's rule). Walks the
    key blocks with a running (m, l, acc) softmax state; never
    materializes the [Sq, Sk] score matrix. `block_k` is the plain
    version's key block (the kernel states its own tile). Under autograd
    its gradient is the reference's custom VJP (`_Flash`), which
    recomputes each block's probabilities from the saved log-sum-exp;
    on the CPU it takes the concatenated MLA form too (dk in f32), on
    the card the dense form (Dq == Dv, one dtype): MLA trains from its
    parts (`_FlashMla`). The reference's `causal=False` and `q_offset`
    come with the family that passes them (enc-dec)."""
    return _Flash.apply(q, k, v, window, block_k)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int) -> torch.Tensor:
    """Banded local attention, O(S * 2W): q/k/v blocked by the window
    size; block i attends to blocks {i-1, i} with an exact band mask.
    q: [B,K,G,S,D] k,v: [B,K,S,D]. S must be at most W or a multiple of
    it (the reference asserts the same)."""
    B, K, G, S, Dq = q.shape
    Dv = v.shape[-1]
    W = window
    if S <= W:
        return flash_attention(q, k, v, window=W)
    if S % W:
        raise ValueError(f"S={S} not divisible by window={W}")
    nb = S // W
    sc = Dq ** -0.5
    dev = q.device

    qb = q.reshape(B, K, G, nb, W, Dq)
    kb = k.reshape(B, K, nb, W, Dq)
    vb = v.reshape(B, K, nb, W, Dv)
    # previous block (block -1 is zeros and fully masked)
    kprev = torch.cat([torch.zeros_like(kb[:, :, :1]), kb[:, :, :-1]], dim=2)
    vprev = torch.cat([torch.zeros_like(vb[:, :, :1]), vb[:, :, :-1]], dim=2)
    k2 = torch.cat([kprev, kb], dim=3)                  # [B,K,nb,2W,Dq]
    v2 = torch.cat([vprev, vb], dim=3)
    qs = _scaled(qb, sc).permute(0, 1, 3, 2, 4, 5)      # [B,K,nb,G,W,Dq]
    s = _f32_matmul(qs.reshape(B, K, nb, G * W, Dq), k2.transpose(-1, -2))
    s = s.view(B, K, nb, G, W, 2 * W)
    qpos = torch.arange(W, device=dev)[:, None]          # within-block
    kpos = torch.arange(2 * W, device=dev)[None, :] - W  # from block start
    band = (qpos >= kpos) & ((qpos - kpos) < W)
    first = torch.arange(nb, device=dev) == 0           # block -1 invalid
    valid_prev = (~first)[:, None, None] | (kpos[None] >= 0)
    mask = band[None] & valid_prev                      # [nb,W,2W]
    s = torch.where(mask[:, None], s, NEG_INF)
    p = _softmax(s)
    out = _f32_matmul(p.to(v.dtype).view(B, K, nb, G * W, 2 * W), v2)
    out = out.view(B, K, nb, G, W, Dv).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(B, K, G, S, Dv).to(v.dtype)


# ======================================================================
# GQA (with optional qk-norm, SWA)
# ======================================================================
class GqaAttention(nn.Module):
    """One layer's GQA parameters under the reference's names and
    `[in, out]` layout: wq [d, H*D], wk / wv [d, KV*D], wo [H*D, d],
    and under qk-norm q_scale / k_scale [D]."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        D = cfg.resolved_head_dim

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.wq = param(d, H * D)
        self.wk = param(d, KV * D)
        self.wv = param(d, KV * D)
        self.wo = param(H * D, d)
        if cfg.qk_norm:
            self.q_scale = param(D)
            self.k_scale = param(D)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init (`init_gqa_params`), drawn from
        `generator`."""
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.copy_(dense_init(generator, w.shape, w.dtype))
        if hasattr(self, "q_scale"):
            self.q_scale.fill_(1.0)
            self.k_scale.fill_(1.0)


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, d).transpose(1, 2)           # [B,n,S,d]


def project_kv(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k (normed and rotated) and v, [B,KV,S,D] each."""
    KV, D = cfg.n_kv_heads, cfg.resolved_head_dim
    k = _split_heads(x @ p["wk"], KV, D)
    v = _split_heads(x @ p["wv"], KV, D)
    if cfg.qk_norm:
        k = head_rms_norm(k, p["k_scale"])
    if cfg.rope_theta > 0:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _project_q(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """q (normed and rotated), [B,H,S,D]."""
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_scale"])
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def gqa_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, positions: torch.Tensor,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Full-sequence causal GQA of prefill and the forward. x: [B,S,d],
    positions: [S]; `kv`, if given, is :func:`project_kv` of the same
    (prefill projects k / v once for the attention and the cache). KV
    heads are expanded to the query heads before attention, as the
    reference does."""
    B, S, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _project_q(p, x, cfg, positions)
    k, v = kv if kv is not None else project_kv(p, x, cfg, positions)
    G = H // KV
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=1)
        v = torch.repeat_interleave(v, G, dim=1)
    qg = q[:, :, None]                                     # [B,H,1,S,D]
    if cfg.sliding_window:
        o = swa_attention(qg, k, v, window=cfg.sliding_window)
    else:
        o = flash_attention(qg, k, v)
    o = o[:, :, 0].transpose(1, 2).reshape(B, S, H * D)
    return o @ p["wo"]


def gqa_make_cache(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig, positions: torch.Tensor, S_max: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decode cache from prefill activations x [B,S,d]: k and v
    [B,KV,max(S, S_max),D], zero-padded to S_max. On one card the KV
    heads are not replicated (the reference's `kv_eff_heads` at
    tp=1)."""
    return pad_cache(*project_kv(p, x, cfg, positions), S_max)


def pad_cache(k: torch.Tensor, v: torch.Tensor, S_max: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k, v [B,KV,S,D] zero-padded along S to S_max, as dense tensors."""
    pad = S_max - k.shape[2]
    if pad > 0:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    return k.contiguous(), v.contiguous()


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int,
                     window: int = 0) -> torch.Tensor:
    """The decode step's attention over the cache: q [B,H,1,D] (the new
    token's, rotated), cache [B,KV,S,D] holding it already, pos its
    position -> o [B,H,1,D] in f32. Slot i is valid up to pos (on a
    ring buffer: up to pos % S, or every slot once pos >= S)."""
    B, H, _, D = q.shape
    KV, S = cache_k.shape[1], cache_k.shape[2]
    qg = _scaled(q, D ** -0.5).reshape(B, KV, H // KV, D)
    s = _f32_matmul(qg, cache_k.transpose(-1, -2))           # [B,KV,G,S]
    if not (window and pos >= S):       # a wrapped ring: every slot valid
        last = pos % S if window else pos
        s = torch.where(torch.arange(S, device=q.device) <= last, s,
                        NEG_INF)
    pr = _softmax(s)
    o = _f32_matmul(pr.to(cache_v.dtype), cache_v)           # [B,KV,G,D]
    return o.reshape(B, H, 1, D)


def gqa_decode(p: Dict[str, torch.Tensor], cache_k: torch.Tensor,
               cache_v: torch.Tensor, x: torch.Tensor, pos: int,
               cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: [B,1,d]; cache: [B,KV,S,D] (a ring buffer
    of the window's size for SWA archs). Returns (out, k, v): the new
    token's k / v are written into the cache tensors in place (at slot
    min(pos, S-1), or pos % S on a ring buffer), and the returned k / v
    are those tensors."""
    B = x.shape[0]
    H, D = cfg.n_heads, cfg.resolved_head_dim
    S, window = cache_k.shape[2], cfg.sliding_window
    positions = torch.arange(pos, pos + 1, device=x.device)
    q = _project_q(p, x, cfg, positions)                      # [B,H,1,D]
    k, v = project_kv(p, x, cfg, positions)                   # [B,KV,1,D]
    slot = pos % S if window else min(pos, S - 1)
    cache_k[:, :, slot] = k[:, :, 0]
    cache_v[:, :, slot] = v[:, :, 0]
    o = decode_attention(q, cache_k, cache_v, pos, window)
    o = o.transpose(1, 2).reshape(B, 1, H * D)
    return (o @ p["wo"].float()).to(x.dtype), cache_k, cache_v


# ======================================================================
# MLA — multi-head latent attention (MiniCPM3)
# ======================================================================
class MlaAttention(nn.Module):
    """One layer's MLA parameters under the reference's names and
    `[in, out]` layout: wq_a [d, q_lora], q_norm [q_lora] and wq_b
    [q_lora, H*Dq] (or wq [d, H*Dq] when q_lora_rank is 0), wkv_a [d,
    R + rope], kv_norm [R], wkv_b [R, H*(nope + v)] and wo [H*v, d], with
    Dq = nope + rope and R = kv_lora_rank."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        if m.q_lora_rank > 0:
            self.wq_a = param(d, m.q_lora_rank)
            self.q_norm = param(m.q_lora_rank)
            self.wq_b = param(m.q_lora_rank, H * qd)
        else:
            self.wq = param(d, H * qd)
        self.wkv_a = param(d, m.kv_lora_rank + m.qk_rope_head_dim)
        self.kv_norm = param(m.kv_lora_rank)
        self.wkv_b = param(m.kv_lora_rank,
                           H * (m.qk_nope_head_dim + m.v_head_dim))
        self.wo = param(H * m.v_head_dim, d)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init (`init_mla_params`), drawn from
        `generator` in its order; the norms' scales are ones."""
        for name in ("wq_a", "wq_b", "wq", "wkv_a", "wkv_b", "wo"):
            if hasattr(self, name):
                w = getattr(self, name)
                w.copy_(dense_init(generator, w.shape, w.dtype))
        for name in ("q_norm", "kv_norm"):
            if hasattr(self, name):
                getattr(self, name).fill_(1.0)


def _mla_dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    m = cfg.mla
    return (cfg.n_heads, m.kv_lora_rank, m.qk_nope_head_dim,
            m.qk_rope_head_dim, m.v_head_dim)


def mla_q(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
          positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope [B,H,S,nope], q_rope [B,H,S,rope], rotated): the q-LoRA
    (wq_a, its rms norm, wq_b) or the full-rank wq, in the compute
    dtype."""
    H, _, nd, rd, _ = _mla_dims(cfg)
    B, S, _ = x.shape
    if "wq_a" in p:
        q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.view(B, S, H, nd + rd).transpose(1, 2)
    return q[..., :nd], apply_rope(q[..., nd:], positions, cfg.rope_theta)


def mla_latent(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_kv [B,S,R] in f32 before its last rounding, k_rope [B,1,S,rope]
    rotated, in the compute dtype). c_kv is `rms_norm(kv[..., :R])`:
    x * inv rounded to the compute dtype, then times kv_norm in f32.
    The reference rounds that last product too, but its compiled CPU
    program drops the rounding where an f32 product reads it (k_nope's
    `einsum_f32`) and keeps it everywhere else (v's product, the cache):
    `.to(dtype)` of this is the rounded c_kv, `mla_ckv`'s."""
    _, R, _, _, _ = _mla_dims(cfg)
    kv = x @ p["wkv_a"]
    c = kv[..., :R]
    var = torch.mean(torch.square(c.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + cfg.norm_eps).to(c.dtype)
    c32 = (c * inv).float() * p["kv_norm"].to(c.dtype).float()
    k_rope = apply_rope(kv[..., None, R:].transpose(1, 2), positions,
                        cfg.rope_theta)
    return c32, k_rope


def mla_ckv(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_kv [B,S,R], k_rope [B,1,S,rope]) in the compute dtype: the
    normed latent and the shared rotated rope key."""
    c32, k_rope = mla_latent(p, x, cfg, positions)
    return c32.to(x.dtype), k_rope


def mla_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, positions: torch.Tensor,
                latent: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Full-sequence MLA of prefill and the forward: k_nope and v are
    expanded from the latent and flash runs over H heads of Dq = nope +
    rope query / key columns and Dv = v value columns (KV == H). x:
    [B,S,d], positions: [S]; `latent`, if given, is :func:`mla_latent`
    of the same (prefill projects it once for the attention and the
    cache). As the reference: k_nope = c_kv @ W_uk in f32 (from the
    unrounded c_kv, see `mla_latent`), v = c_kv @ W_uv in the compute
    dtype, and flash reads k = [k_nope, k_rope] in f32 (the reference's
    concatenation promotes the rope key), so in bf16 runs the flash
    kernel reads f32 keys beside bf16 q and v. Flash takes the parts as
    they are (`ops.flash_fwd_mla`): q_nope a view of the projection,
    the one rope key [B,1,S,rope] of every head; nothing is
    concatenated or cast for it (its plain version concatenates as the
    reference does). Under autograd the gradient is the reference's
    (`_FlashMla`, `ops.flash_bwd_mla`): each part's cotangent, k_nope's
    in f32 into its f32 product of the unrounded c_kv, the rope key's
    summed over the heads."""
    H, R, nd, rd, vd = _mla_dims(cfg)
    B, S, _ = x.shape
    q_nope, q_rope = mla_q(p, x, cfg, positions)
    c32, k_rope = latent if latent is not None else \
        mla_latent(p, x, cfg, positions)
    wkv_b = p["wkv_b"].view(R, H, nd + vd)
    k_nope = (c32 @ wkv_b[..., :nd].reshape(R, H * nd).float()).view(
        B, S, H, nd).transpose(1, 2)
    v = (c32.to(x.dtype) @ wkv_b[..., nd:].reshape(R, H * vd)).view(
        B, S, H, vd).transpose(1, 2)
    o = _FlashMla.apply(q_nope, q_rope, k_nope, k_rope, v, FLASH_BLOCK)
    o = o[:, :, 0].transpose(1, 2).reshape(B, S, H * vd)
    return o @ p["wo"]


def mla_make_cache(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig, positions: torch.Tensor, S_max: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MLA's decode cache from prefill activations x [B,S,d]: the
    latent c_kv [B,max(S, S_max),R] and the shared rope key k_rope
    [B,max(S, S_max),rope], zero-padded to S_max."""
    return pad_latent(*mla_ckv(p, x, cfg, positions), S_max)


def pad_latent(c_kv: torch.Tensor, k_rope: torch.Tensor, S_max: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """c_kv [B,S,R] and k_rope [B,1,S,rope] as the cache's [B,S_max,R]
    and [B,S_max,rope], zero-padded along S, dense."""
    k_rope = k_rope[:, 0]
    pad = S_max - c_kv.shape[1]
    if pad > 0:
        c_kv = F.pad(c_kv, (0, 0, 0, pad))
        k_rope = F.pad(k_rope, (0, 0, 0, pad))
    return c_kv.contiguous(), k_rope.contiguous()


def mla_decode_attention(q_abs: torch.Tensor, q_rope: torch.Tensor,
                         c_kv: torch.Tensor, k_rope: torch.Tensor,
                         pos: int, scale: float) -> torch.Tensor:
    """The absorbed decode step's attention over the latent cache: q_abs
    [B,H,R] (q_nope with W_uk folded in), q_rope [B,H,rope], the cache
    c_kv [B,S,R] and k_rope [B,S,rope] holding the token already, pos
    its position -> o_lat [B,H,R] in f32. The scores are the two f32
    products' sum times the f32 scale (XLA keeps q_abs . c_kv in f32:
    the reference's bf16 einsum is not rounded before the add); slots up
    to pos are valid."""
    S = c_kv.shape[1]
    s = (_f32_matmul(q_abs, c_kv.transpose(1, 2)) +
         _f32_matmul(q_rope, k_rope.transpose(1, 2))) * scale
    s = torch.where(torch.arange(S, device=s.device) <= pos, s, NEG_INF)
    pr = _softmax(s)
    return _f32_matmul(pr.to(c_kv.dtype), c_kv)


def mla_decode(p: Dict[str, torch.Tensor], c_kv: torch.Tensor,
               k_rope: torch.Tensor, x: torch.Tensor, pos: int,
               cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed-matmul MLA decode of one token x [B,1,d] over the latent
    cache c_kv [B,S,R], k_rope [B,S,rope]: W_uk is folded into q (q_abs,
    rounded to the compute dtype), the step attends over the latent
    (`mla_decode_attention`), o_lat is rounded, W_uv is applied after
    (in the compute dtype) and `@ wo` is taken in the compute dtype.
    The token's latent and rope key are written into the cache tensors
    in place at slot min(pos, S-1); returns (out, c_kv, k_rope), the
    latter two those tensors."""
    H, R, nd, rd, vd = _mla_dims(cfg)
    B, S = x.shape[0], c_kv.shape[1]
    positions = torch.arange(pos, pos + 1, device=x.device)
    q_nope, q_rope = mla_q(p, x, cfg, positions)             # [B,H,1,*]
    new_c, new_kr = mla_ckv(p, x, cfg, positions)            # [B,1,R]
    slot = min(pos, S - 1)
    c_kv[:, slot] = new_c[:, 0]
    k_rope[:, slot] = new_kr[:, 0, 0]
    wkv_b = p["wkv_b"].view(R, H, nd + vd)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, :, 0], wkv_b[..., :nd])
    o_lat = mla_decode_attention(q_abs, q_rope[:, :, 0], c_kv, k_rope, pos,
                                 (nd + rd) ** -0.5).to(x.dtype)
    o = torch.einsum("bhr,rhd->bhd", o_lat, wkv_b[..., nd:])
    return (o.reshape(B, 1, H * vd) @ p["wo"]).to(x.dtype), c_kv, k_rope
