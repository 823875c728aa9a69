"""Mixture-of-Experts: token-choice top-k routing with capacity-bounded
dispatch, shared experts (DeepSeek-style), the load-balance aux loss
and the per-expert load (a step metric).

Port of `repro/models/moe.py`. Tokens are viewed as [G, T_g, d] groups
(G the data-parallel width where it divides the tokens; the serve and
the Trainer run G = 1). The reference's one-hot cumulative count of
capacity slots, its k sequential scatters and its k sequential gathers
are one kernel each on the card (:func:`repro_torch.kernels.ops.
moe_slots`, which also gives each slot's source token, so that the
dispatch :func:`~repro_torch.kernels.ops.moe_dispatch` is a gather by
it, and :func:`~repro_torch.kernels.ops.moe_combine`; csrc/moe.cu; their
plain versions, the reference's count and loops, on the host), the
expert gate is the SwiGLU gate's kernel (`ops.swiglu_gate`), and the
three expert products are batched matrix products over the experts
(the reference leaves them to XLA, outside any kernel).

Training differentiates the layer as the reference's `jax.grad` does:
the dispatch and the combine are `ops.moe_dispatch_ad` /
`ops.moe_combine_ad`, whose backwards are kernels of their own (the
dispatch's: the slots' cotangents summed per token; the combine's: its
output's cotangent gathered into the slots by their sources, and the
gates' row products), the gate's backward is `silu_gate_bwd`, and the
router's product, the softmax, the stable sort's top k, the
renormalisation and the aux loss's mean probabilities go through
autograd; the expert load has no gradient.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import _softmax
from repro_torch.models.layers import dense_init, swiglu


class MoeMlp(nn.Module):
    """The MoE layer's parameters, the reference's names and layouts:
    `router` [d, E] f32 (the reference's f32 init; cast with the other
    block leaves for compute), the experts' `w1`, `w3` [E, d, f] and
    `w2` [E, f, d], and with shared experts `ws1`, `ws3` [d, f_s] and
    `ws2` [f_s, d] (f_s = f x n_shared_experts)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        m = cfg.moe
        d, E, f = cfg.d_model, m.n_experts, m.d_ff_expert

        def param(dt, *shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)
        self.router = param(torch.float32, d, E)
        self.w1 = param(dtype, E, d, f)
        self.w3 = param(dtype, E, d, f)
        self.w2 = param(dtype, E, f, d)
        if m.n_shared_experts > 0:
            fs = f * m.n_shared_experts
            self.ws1 = param(dtype, d, fs)
            self.ws3 = param(dtype, d, fs)
            self.ws2 = param(dtype, fs, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init order: router, w1, w3, w2, then the
        shared experts' ws1, ws3, ws2."""
        for w in self.parameters():
            w.copy_(dense_init(generator, w.shape, w.dtype))


def capacity(t_per_group: int, cfg: ModelConfig,
             capacity_factor: Optional[float] = None) -> int:
    """Slots an expert holds per group, as the reference's `_capacity`:
    int(T_g * k * cf / E) + 1, rounded up to a multiple of 4 and at
    least 4; `capacity_factor` (the reference's
    `ShardCtx.moe_capacity_factor`) overrides the config's when given
    and not 0."""
    m = cfg.moe
    cf = capacity_factor or m.capacity_factor
    c = int(t_per_group * m.top_k * cf / m.n_experts) + 1
    return max(4, -(-c // 4) * 4)


def router_logits(xg: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """The router's product in f32 (x and the router as the compute
    params hold it, each upcast): [G, T_g, d] -> [G, T_g, E]."""
    return torch.matmul(xg.float(), router.float())


def route(logits: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [.., E] f32 -> (probs, gates, eidx): the softmax, the top k
    probabilities in `lax.top_k`'s order (descending, the lower expert
    first on a tie: a stable sort; `torch.topk` fixes no tie order) and
    their experts (int64, dense), the gates renormalised by max(sum,
    1e-9)."""
    probs = _softmax(logits)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = top[..., :k], idx[..., :k].contiguous()
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, eidx


def experts(buf: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The experts' SwiGLU on their slots: buf [E, C, d] -> [E, C, d],
    the three products batched over the experts and the gate
    `silu(buf @ w1) * (buf @ w3)` as `ops.swiglu_gate` (`silu_gate`'s
    value; its gradient `silu_gate_bwd`)."""
    h1 = torch.bmm(buf, p["w1"])                               # [E,C,f]
    h3 = torch.bmm(buf, p["w3"])
    return torch.bmm(ops.swiglu_gate(h3, h1), p["w2"])


def moe_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, dp_size: int = 1,
                capacity_factor: Optional[float] = None,
                with_stats: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
    """x [B,S,d] (compute dtype) -> (y [B,S,d], aux loss, expert load
    [E]), step for step as the reference's `moe_forward`: the router
    product in f32 (:func:`router_logits`), softmax and top-k
    (:func:`route`), the Switch-style aux loss and the per-expert share
    of the choices, capacity slots and their source tokens (one
    `ops.moe_slots` for all groups), then per group the dispatch (a
    gather by the sources), the experts (:func:`experts`) and the
    combine; the shared experts added after. `p` holds a layer's
    compute parameters (`MoeMlp`'s names). Without `with_stats`
    (the serve: the reference's decode drops them and XLA never computes
    them) aux and load are None. Differentiable in x and `p` (the
    dispatch and combine through their `_ad` ops); under
    `torch.inference_mode` or `no_grad` those call the forward kernels
    directly."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    T = B * S
    G = dp_size if (T % dp_size == 0 and T >= dp_size) else 1
    Tg = T // G
    C = capacity(Tg, cfg, capacity_factor)

    xg = x.reshape(G, Tg, d)
    probs, gates, eidx = route(router_logits(xg, p["router"]), k)
    aux = load = None
    if with_stats:
        load = nn.functional.one_hot(eidx, E).sum(2).float().mean(
            (0, 1)) / k
        aux = E * torch.sum(load * probs.mean((0, 1)))
    pos_c, keep, src = ops.moe_slots(eidx, E, C)

    ys = []
    for g in range(G):
        buf = ops.moe_dispatch_ad(xg[g], src[g], eidx[g], pos_c[g], keep[g])
        ob = experts(buf, p)
        ys.append(ops.moe_combine_ad(ob, eidx[g], pos_c[g], keep[g],
                                     gates[g], src[g]))
    y = ys[0][None] if G == 1 else torch.stack(ys)
    if m.n_shared_experts > 0:
        y = y + swiglu(xg, p["ws1"], p["ws3"], p["ws2"])
    return y.reshape(B, S, d), aux, load
