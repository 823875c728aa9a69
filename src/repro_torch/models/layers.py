"""Shared layers of the port's models, from `repro/models/layers.py`:
the norms, the SwiGLU MLP, RoPE, the init helper and the
cross-entropy. One card needs no sharding, so there is no `ShardCtx`;
it comes with the multi-card slice."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5, stats: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """Stats in f32, VALUE path in the compute dtype (x's), as the
    reference does. `stats`, if given, is the f32 value the variance is
    taken of in place of x (see `ssm.gated_rms_norm`)."""
    src = x.float() if stats is None else stats
    var = torch.mean(torch.square(src), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm over the head_dim (last axis), qwen3-style."""
    return rms_norm(x, scale, eps)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """silu(x @ w1) * (x @ w3), then @ w2. The gate is
    :func:`repro_torch.kernels.ops.silu_gate`'s value (the CUDA kernel
    on the card, its plain version on the host): XLA's CPU program for the
    reference's `jax.nn.silu(x @ w1) * (x @ w3)` rounds each op of the
    logistic to the compute dtype and the product once, which is what
    the gate's value output holds (a bf16 product of two bf16 numbers,
    taken in f32 and rounded once, is the bf16 multiply). The gate's
    f32 product is not stored. Its gradient (training) is the
    `silu_gate_bwd` kernel (:func:`repro_torch.kernels.ops.
    swiglu_gate`)."""
    return ops.swiglu_gate(x @ w3, x @ w1) @ w2


def rope_freqs(dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """The inverse frequencies [dim/2] in f32: 1 / theta^(2i/dim), the
    exponent in f32 and the rest in f64, rounded once, as XLA folds the
    reference's constant table. An f32 `pow` and divide differ from it
    in the last bit of a third of the entries, which moves an angle of
    1,000 rad by 6e-5."""
    e = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return (1.0 / (theta ** e.double())).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, D] (D even), positions: broadcastable to [..., S].
    Rotates the two halves of the last dim in f32 and casts back to x's
    dtype."""
    inv = rope_freqs(x.shape[-1], theta, x.device)            # [D/2]
    ang = positions.float()[..., None] * inv                  # [..., S, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(generator: torch.Generator, shape: Sequence[int], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1) * scale drawn in f32 on the generator's device, then
    cast; the scale defaults to fan_in ** -0.5 (fan_in = shape[-2])."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * s).to(dtype)


# ----------------------------------------------------------------------
# Cross-entropy
# ----------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [.., V] (upcast to f32), targets [..] integer -> the mean
    negative log-likelihood, the log-sum-exp taken in f32; with `mask`,
    the masked sum over max(sum(mask), 1)."""
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - lf.gather(
        -1, targets.long()[..., None])[..., 0]
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def _chunk_nll(h: torch.Tensor, lm_head: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    lf = (h @ lm_head).float()
    return (torch.logsumexp(lf, dim=-1) -
            lf.gather(-1, targets[..., None])[..., 0]).sum()


def chunked_xent(h: torch.Tensor, lm_head: torch.Tensor,
                 targets: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Sequence-chunked CE of h [B,S,d] through lm_head [d,V]: each
    chunk's logits [B,chunk,V] are computed, reduced and recomputed in
    the backward (`torch.utils.checkpoint`, as the reference's
    `jax.checkpoint` over its scan), so the [B,S,V] f32 logits never
    exist. Where chunk does not divide S, or S <= chunk, it is
    `softmax_xent(h @ lm_head)`, as in the reference."""
    B, S, _ = h.shape
    if S % chunk or S <= chunk:
        return softmax_xent(h @ lm_head, targets)
    tgt = targets.long()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        tot = tot + checkpoint(_chunk_nll, h[:, sl], lm_head, tgt[:, sl],
                               use_reentrant=False)
    return tot / (B * S)
