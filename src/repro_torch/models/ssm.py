"""Mamba-2 (SSD — state-space duality) block: chunked quadratic-within-
chunk / linear-across-chunk scan, causal depthwise conv, gated RMSNorm.

Port of `repro/models/ssm.py`. The within-chunk part of `ssd_chunked`
(the diagonal block and the chunk-end states) goes through
:func:`repro_torch.kernels.ops.ssd_chunk`: the CUDA kernel on the card,
its plain version on the host. The inter-chunk recurrence and the
off-diagonal product stay torch, as the reference keeps them outside
its kernel.

Training differentiates the block with torch's autograd. Its three
kernel calls go through the `_ad` ops of `repro_torch.kernels.ops`
(`ssd_chunk_ad`, `silu_ad`, `silu_gate_ad`), whose backwards are
hand-written kernels (`ssd_chunk_bwd`, `silu_bwd`,
`silu_gate_prod_bwd`); the causal conv, softplus, the dt scaling, the
inter-chunk loop, the off-diagonal einsum and the D skip differentiate
as plain torch. Serving calls the same ops: with no gradient to take
they launch the same forward kernels and keep nothing for a backward.

The functions take the block's parameters as a dict of tensors in the
compute dtype (`transformer.MambaLM.compute_params`), as the reference
takes its pytree.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm


def ssm_dims(cfg: ModelConfig):
    """(d_inner, heads, conv channels, in_proj width) of the block."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + H
    return d_inner, H, conv_ch, d_in_proj


class Mamba2Mixer(nn.Module):
    """The parameters of one Mamba-2 mixer, under the reference's names
    and in its `[in, out]` matrix layout."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        s = cfg.ssm
        d_inner, H, conv_ch, d_in_proj = ssm_dims(cfg)

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.in_proj = param(cfg.d_model, d_in_proj)
        self.conv_w = param(s.d_conv, conv_ch)
        self.conv_b = param(conv_ch)
        self.A_log = param(H, dt=torch.float32)
        self.D = param(H, dt=torch.float32)
        self.dt_bias = param(H, dt=torch.float32)
        self.norm = param(d_inner)
        self.out_proj = param(d_inner, cfg.d_model)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init (`init_ssm_params`), drawn from
        `generator`."""
        H = self.A_log.shape[0]
        for name, scale in (("in_proj", None), ("conv_w", 0.5),
                            ("out_proj", None)):
            p = getattr(self, name)
            p.copy_(dense_init(generator, p.shape, p.dtype, scale=scale))
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H)))
        self.D.fill_(1.0)
        self.dt_bias.copy_(torch.log(torch.expm1(
            torch.linspace(0.001, 0.1, H))))
        self.norm.fill_(1.0)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B,S,C], w [K,C] -> [B,S,C]."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def ssd_chunked(xh: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                da: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan (n_groups=1 broadcast over heads).

    xh: [B,S,H,P] (already multiplied by dt)  Bc,Cc: [B,S,N]
    da: [B,S,H] per-step log decay (dt * a, a<0). Returns (y [B,S,H,P]
    in xh's dtype, final_state [B,H,P,N] f32).
    """
    B, S, H, P = xh.shape
    N = Bc.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:                      # pad tail: x=0 contributes nothing and
        pad = Q - S % Q            # da=0 leaves the carried state intact
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        S = xh.shape[1]
    nC = S // Q

    xq = xh.reshape(B, nC, Q, H, P).contiguous()
    Bq = Bc.reshape(B, nC, Q, N).contiguous()
    Cq = Cc.reshape(B, nC, Q, N).contiguous()
    daq = da.float().reshape(B, nC, Q, H).permute(0, 1, 3, 2).contiguous()

    # -- within-chunk part: diagonal blocks and chunk-end states --------
    y_diag, states = ops.ssd_chunk_ad(xq, Bq, Cq, daq)

    # -- inter-chunk recurrence (linear scan over nC) ------------------
    cum = torch.cumsum(daq, dim=-1)                          # [B,nC,H,Q]
    chunk_decay = torch.exp(cum[..., -1])                    # [B,nC,H]
    carry = torch.zeros((B, H, P, N), dtype=torch.float32,
                        device=xh.device) if init_state is None \
        else init_state.float()
    entered = []                                             # state ENTERING
    for c in range(nC):                                      # each chunk
        entered.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    entered = torch.stack(entered, dim=1)                    # [B,nC,H,P,N]

    # -- off-diagonal contribution -------------------------------------
    dec_in = torch.exp(cum).permute(0, 1, 3, 2)              # [B,nC,Q,H]
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cq.float(), entered) * \
        dec_in[..., None]

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y[:, :S_orig].to(xh.dtype), carry


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """The reference's `rms_norm(y * silu(z), scale)`, with the rounding
    its compiled HLO keeps: the product is rounded to y's dtype on the
    value path, but XLA fuses the unrounded f32 product into the
    variance (it drops that f32 -> bf16 -> f32 pair). Both come from
    one `ops.silu_gate` call; its gradient takes both cotangents
    (`ops.silu_gate_prod_bwd`)."""
    value, prod = ops.silu_gate_ad(y, z)
    return rms_norm(value, scale, eps, stats=prod)


def _split_xbc(xBC: torch.Tensor, d_inner: int, N: int):
    return (xBC[..., :d_inner], xBC[..., d_inner:d_inner + N],
            xBC[..., d_inner + N:])


def ssm_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence Mamba2 block. x: [B,S,d] -> [B,S,d]. With
    `return_cache`, also the decode cache {conv [B,K-1,C], state
    [B,H,P,N]}: the final state comes from the same `ssd_chunked` call
    (the reference runs the scan a second time for it, on the same
    input)."""
    s = cfg.ssm
    d_inner, H, conv_ch, _ = ssm_dims(cfg)
    N, P = s.d_state, s.head_dim
    B, S, _ = x.shape

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_inner]
    xBC_raw = zxbcdt[..., d_inner:d_inner + conv_ch]
    dt_raw = zxbcdt[..., d_inner + conv_ch:]

    xBC = ops.silu_ad(_causal_conv(xBC_raw, p["conv_w"], p["conv_b"]))
    xs, Bc, Cc = _split_xbc(xBC, d_inner, N)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])                               # [H] < 0
    da = dt * a

    xh = xs.reshape(B, S, H, P)
    xh_dt = (xh.float() * dt[..., None]).to(x.dtype)
    y, final = ssd_chunked(xh_dt, Bc, Cc, da, s.chunk)
    y = y + p["D"][None, None, :, None].float() * xh

    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = gated_rms_norm(y, z, p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if not return_cache:
        return out
    # the conv's last K-1 inputs; a shorter prompt is zero-padded in
    # front, as the causal conv pads it
    conv = F.pad(xBC_raw[:, -(s.d_conv - 1):],
                 (0, 0, max(0, s.d_conv - 1 - S), 0))
    return out, {"conv": conv.contiguous(), "state": final}


# ----------------------------------------------------------------------
# Decode (recurrent state update — O(1) per token)
# ----------------------------------------------------------------------
def ssm_cache_spec(cfg: ModelConfig, B: int, dtype: torch.dtype
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each decode-cache tensor of one block."""
    s = cfg.ssm
    d_inner, H, conv_ch, _ = ssm_dims(cfg)
    return {"conv": ((B, s.d_conv - 1, conv_ch), dtype),
            "state": ((B, H, s.head_dim, s.d_state), torch.float32)}


def ssm_decode(p: Dict[str, torch.Tensor], cache: Dict[str, torch.Tensor],
               x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B,1,d]; cache: {conv [B,K-1,C], state [B,H,P,N]}."""
    s = cfg.ssm
    d_inner, H, conv_ch, _ = ssm_dims(cfg)
    N, P = s.d_state, s.head_dim
    B = x.shape[0]

    zxbcdt = x[:, 0] @ p["in_proj"]                          # [B, dip]
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_ch]
    dt_raw = zxbcdt[..., d_inner + conv_ch:]

    hist = torch.cat([cache["conv"], xBC[:, None]], dim=1)   # [B,K,C]
    conv_out = torch.einsum("bkc,kc->bc", hist.float(),
                            p["conv_w"].float()) + p["conv_b"].float()
    xBC = ops.silu(conv_out).to(x.dtype)
    new_conv = hist[:, 1:]

    xs, Bc, Cc = _split_xbc(xBC, d_inner, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])           # [B,H]
    a = -torch.exp(p["A_log"])
    dec = torch.exp(dt * a)                                  # [B,H]

    xh = xs.reshape(B, H, P).float()
    st = cache["state"] * dec[..., None, None] + \
        (xh * dt[..., None])[..., None] * Bc.float()[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", Cc.float(), st)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B, d_inner).to(x.dtype)
    y = gated_rms_norm(y, z, p["norm"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, None], {"conv": new_conv, "state": st}
