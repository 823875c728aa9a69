"""Attention of the dense family: GQA with optional qk-norm and sliding
window; flash (online-softmax) attention for prefill and the full
forward; cached decode over a [B,KV,S,D] cache (a ring buffer of the
window's size for SWA archs).

Port of the GQA half of `repro/models/attention.py` (MLA comes with its
architectures). The reference runs these as jit programs; its comment
names a Pallas kernel as the TPU's production path of flash attention.
Here flash's forward and its custom VJP's backward are hand-written CUDA
kernels on the card (`ops.flash_fwd` / `ops.flash_bwd`, `csrc/
flash_attn.cu`) and their plain versions on the host (`kernels/ref.py::
flash_fwd_ref` / `flash_bwd_ref`, in the reference's block order); the
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
  reads KV head h // G.

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
from repro_torch.models.layers import apply_rope, dense_init, head_rms_norm

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, block_k: int = FLASH_BLOCK
                    ) -> torch.Tensor:
    """Causal attention, q: [B,K,G,Sq,Dq]  k: [B,K,Sk,Dq]  v: [B,K,Sk,Dv]
    -> [B,K,G,Sq,Dv], scaled by Dq ** -0.5.

    K = kv heads, G = query group size (Hq = K*G), Sq == Sk, Dq == Dv a
    multiple of 16 up to 128. Walks the key blocks with a running (m, l,
    acc) softmax state; never materializes the [Sq, Sk] score matrix.
    `block_k` is the plain version's key block (the kernel states its
    own tile). Under autograd its gradient is the reference's custom VJP
    (`_Flash`), which recomputes each block's probabilities from the
    saved log-sum-exp. The reference's `causal=False`, `q_offset` and
    `scale` come with the families that pass them (enc-dec, MLA)."""
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
