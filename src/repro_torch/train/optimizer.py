"""AdamW with global-norm clipping and a cosine schedule, as
`repro/train/optimizer.py` computes it.

The state is {"m", "v": trees of the parameters' shapes in
`state_dtype`, "step": an int32 scalar tensor}; `adamw_update` writes
the new parameters and moments into the given tensors (in place, under
no_grad) and keeps the reference's f32 moment math and op order.

The parameters are the reference's layer-stacked tree, and as the
reference does, a stacked leaf of 2^27 elements or more (ndim >= 3, 16
layers or more) is updated in chunks of L // 8 layers along the stack
axis, so that the f32 temporaries of the elementwise chain cover a few
layers, not the whole stack; the result is the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.compat import tree_leaves, tree_map
from repro_torch.models.transformer import torch_dtype


@dataclass(frozen=True)
class AdamWConfig:
    """AdamW's rates, clipping, schedule and moment dtype."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # bf16 moments halve the optimizer's memory; the moment math still
    # runs in f32 (upcast / downcast around the update)
    state_dtype: str = "float32"


def lr_at(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to `min_lr_frac`, in f32 at
    the integer tensor `step` (the reference's op order)."""
    s = step.float()
    warm = s / max(c.warmup_steps, 1)
    prog = torch.clamp((s - c.warmup_steps) /
                       max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = c.min_lr_frac + (1 - c.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return c.lr * torch.minimum(warm, cos)


def init_opt_state(params: Any, state_dtype: str = "float32"
                   ) -> Dict[str, Any]:
    """Zero moments of the parameters' shapes in `state_dtype`, and step
    0 (an int32 scalar on the parameters' device)."""
    dt = torch_dtype(state_dtype)
    dev = next(iter(tree_leaves(params))).device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(c: AdamWConfig, params: Any, grads: Any,
                 state: Dict[str, Any]
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: clip to `clip_norm` by the global norm, bias
    correction, decoupled weight decay. Writes the new parameters, m
    and v into their tensors (the moments rounded to `state_dtype`
    first, as the reference stores them) and returns (params, state,
    {grad_norm, lr}); the state's step is a new tensor."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(c.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = lr_at(c, step)
    s = step.float()
    b1c = 1 - torch.pow(c.b1, s)
    b2c = 1 - torch.pow(c.b2, s)
    sdt = torch_dtype(c.state_dtype)
    leaves: List[List[torch.Tensor]] = [
        list(tree_leaves(t)) for t in (params, grads, state["m"], state["v"])]

    def upd(p, g, m, v):
        g = g.float() * scale
        m2 = c.b1 * m.float() + (1 - c.b1) * g
        v2 = c.b2 * v.float() + (1 - c.b2) * g * g
        mh = m2 / b1c
        vh = v2 / b2c
        delta = mh / (torch.sqrt(vh) + c.eps) + c.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m2.to(sdt))
        v.copy_(v2.to(sdt))

    for p, g, m, v in zip(*leaves):
        if p.ndim >= 3 and p.shape[0] >= 16 and p.numel() >= 1 << 27:
            ch = max(1, p.shape[0] // 8)
            for lo in range(0, p.shape[0], ch):
                upd(*(t[lo:lo + ch] for t in (p, g, m, v)))
        else:
            upd(p, g, m, v)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gn, "lr": lr}
