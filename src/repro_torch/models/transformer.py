"""Decoder-only LM assembly: the `ssm` family (Mamba-2).

Port of the `ssm` path of `repro/models/transformer.py`. The reference
stacks the layers' leaves ([L, ...]) and scans them; here `MambaLM`
holds one module per layer. The dense, moe and hybrid families raise
"not yet ported".

The reference casts every parameter leaf with ndim >= 2 to the compute
dtype (`_cast_params`). Its per-layer vectors are stacked [L, ·], so
they are cast too (`ln1`, `A_log`, `D`, `dt_bias`, `conv_b`, `norm`),
while `final_norm` [d] stays in the parameter dtype;
`MambaLM.compute_params` casts the same leaves.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import dense_init, rms_norm


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string ("bfloat16", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype '{name}'")
    return dt


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"the '{cfg.family}' family ({cfg.arch_id}) is not yet ported; "
            f"the port runs the 'ssm' family")


class MambaBlock(nn.Module):
    """One layer: the pre-norm scale `ln1` and the mixer `ssm`."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model, dtype=dtype,
                                            device=device),
                                requires_grad=False)
        self.ssm = ssm_mod.Mamba2Mixer(cfg, dtype, device)


class MambaLM(nn.Module):
    """The `ssm` family's parameters: embed [V,d], one `MambaBlock` per
    layer, final_norm [d] and lm_head [d,V] (the reference's names and
    `[in, out]` layout). The functions below run it."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.embed = param(V, d)
        self.blocks = nn.ModuleList(MambaBlock(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = param(d)
        self.lm_head = param(d, V)
        self._compute: Tuple[Any, Dict] = (None, {})

    @property
    def device(self) -> torch.device:
        """Where the parameters live."""
        return self.embed.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init (`init_lm_params`), drawn from
        `generator`."""
        self.embed.copy_(dense_init(generator, self.embed.shape,
                                    self.embed.dtype, scale=0.02))
        self.final_norm.fill_(1.0)
        self.lm_head.copy_(dense_init(generator, self.lm_head.shape,
                                      self.lm_head.dtype))
        for blk in self.blocks:
            blk.ln1.fill_(1.0)
            blk.ssm.reset_parameters(generator)

    def compute_params(self, dtype: torch.dtype) -> Dict[str, Any]:
        """The parameters as the reference's forward sees them after
        `_cast_params`, as a tree of tensors: {embed, final_norm,
        lm_head, blocks: [{ln1, ssm: {...}}]}. Kept until a parameter
        changes (tracked by the tensors' storage and version counters),
        so a served model is cast once, not at every step; a leaf
        already in `dtype` is the parameter itself."""
        key = (dtype, tuple((p.data_ptr(), p._version)
                            for p in self.parameters()))
        if self._compute[0] != key:
            def cast(t):
                return t.detach().to(dtype) \
                    if t.dtype in (torch.float32, torch.bfloat16) else t
            tree = {"embed": cast(self.embed),
                    "final_norm": self.final_norm.detach(),
                    "lm_head": cast(self.lm_head),
                    "blocks": [{"ln1": cast(b.ln1),
                                "ssm": {n: cast(p) for n, p in
                                        b.ssm.named_parameters()}}
                               for b in self.blocks]}
            self._compute = (key, tree)
        return self._compute[1]


def lm_forward(params: MambaLM, tokens: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """tokens [B,S] -> logits [B,S,V] (the SSM has no aux loss or
    expert load, which the reference also returns)."""
    pc = params.compute_params(torch_dtype(cfg.dtype))
    x = pc["embed"][tokens]
    for blk in pc["blocks"]:
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        x = x + ssm_mod.ssm_forward(blk["ssm"], h, cfg)
    h = rms_norm(x, pc["final_norm"], cfg.norm_eps)
    return h @ pc["lm_head"]


def lm_cache_spec(cfg: ModelConfig, B: int, dtype: torch.dtype = None
                  ) -> Dict[str, List[Dict]]:
    """(shape, dtype) of every decode-cache tensor, per layer."""
    check_family(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    return {"blocks": [ssm_mod.ssm_cache_spec(cfg, B, dtype)
                       for _ in range(cfg.n_layers)]}


def stack_cache(cache: Dict[str, List[Dict]]) -> Dict[str, Dict]:
    """The reference's layout of a decode cache: {"blocks": {name:
    [L, ...]}}, each per-layer tensor stacked along a new leading axis,
    as the reference's `lax.scan` over the layers returns them."""
    blocks = cache["blocks"]
    return {"blocks": {k: torch.stack([b[k] for b in blocks])
                       for k in blocks[0]}}


def unstack_cache(tree: Dict[str, Dict]) -> Dict[str, List[Dict]]:
    """Inverse of :func:`stack_cache`: one dict per layer (views into
    the stacked tensors)."""
    blocks = tree["blocks"]
    n = len(next(iter(blocks.values())))
    return {"blocks": [{k: v[i] for k, v in blocks.items()}
                       for i in range(n)]}


def lm_prefill(params: MambaLM, tokens: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, List[Dict]]]:
    """Forward pass that also builds the decode cache. Returns
    (last_logits [B,V], {"blocks": [{conv, state}] per layer})."""
    pc = params.compute_params(torch_dtype(cfg.dtype))
    x = pc["embed"][tokens]
    caches = []
    for blk in pc["blocks"]:
        hn = rms_norm(x, blk["ln1"], cfg.norm_eps)
        y, c = ssm_mod.ssm_forward(blk["ssm"], hn, cfg, return_cache=True)
        x = x + y
        caches.append(c)
    h = rms_norm(x, pc["final_norm"], cfg.norm_eps)
    return h[:, -1] @ pc["lm_head"], {"blocks": caches}


def lm_decode(params: MambaLM, cache: Dict[str, List[Dict]],
              tokens: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, List[Dict]]]:
    """One-token decode step. tokens [B,1] -> (logits [B,V], new
    cache)."""
    pc = params.compute_params(torch_dtype(cfg.dtype))
    x = pc["embed"][tokens]                                  # [B,1,d]
    new = []
    for blk, c in zip(pc["blocks"], cache["blocks"]):
        hn = rms_norm(x, blk["ln1"], cfg.norm_eps)
        y, nc = ssm_mod.ssm_decode(blk["ssm"], c, hn, cfg)
        x = x + y
        new.append(nc)
    h = rms_norm(x, pc["final_norm"], cfg.norm_eps)
    return h[:, -1] @ pc["lm_head"], {"blocks": new}
