"""Shared layers of the port's models: the norm and the init helper of
`repro/models/layers.py`. One card needs no sharding, so there is no
`ShardCtx`; it comes with the multi-card slice."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


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


def dense_init(generator: torch.Generator, shape: Sequence[int], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1) * scale drawn in f32 on the generator's device, then
    cast; the scale defaults to fan_in ** -0.5 (fan_in = shape[-2])."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * s).to(dtype)
