"""Decoder-only LM assembly: the `ssm` family (Mamba-2), the `dense`
family (GQA or MLA attention + SwiGLU MLP; qk-norm and sliding window as
flags), the `hybrid` family (Zamba2: Mamba-2 layers and ONE shared
attention + MLP block, run before every `shared_attn_every`-th layer
with a KV cache of its own at each application) and the `moe` family
(GQA attention + a routed MoE layer in the MLP's place).

Port of the `ssm`, `dense`, `hybrid` and `moe` paths of
`repro/models/transformer.py`. The reference stacks the layers' leaves
([L, ...]) and scans them; here `MambaLM`, `DenseLM`, `HybridLM` and
`MoeLM` hold one module per layer. MoE with MLA, MoE's leading dense
layers (DeepSeek's prologue) and MLA in the hybrid family raise "not yet
ported" (`check_family`); the dense family's MLA serves and trains.

The reference casts every parameter leaf with ndim >= 2 to the compute
dtype (`_cast_params`). Its per-layer vectors are stacked [L, ·], so
they are cast too (`ln1`, `ln2`, `q_scale`, `k_scale`, `A_log`, `D`,
`dt_bias`, `conv_b`, `norm`), while `final_norm` [d] and the hybrid's
shared block's vectors (not stacked: its `ln1`, `ln2`) stay in the
parameter dtype; `compute_params` casts the same leaves for serving
(detached and kept), `cast_params` for training (through autograd,
every step).

In the `ssm` family this puts `A_log`, `D` and `dt_bias` in the compute
dtype too, as the reference's stacked [L, H] leaves are: `-exp(A_log)`
is taken in bf16, `dt * a` (f32 times bf16) promotes to f32 as jnp
promotes it, and `D` is upcast to f32 before it scales xh, as the
reference upcasts it (`ssm.ssm_forward`).

All four families train (`lm_loss`; the dense family's MLA too) on a per-layer
parameter tree: the module's own parameters (`param_tree(model)`), or
the views of the reference's stacked layout that the train step holds
(`stack_layers` / `layer_views`, also the checkpoints' layout). The hybrid's shared block
is one unstacked subtree, `shared_attn`, in both; its one cast tensor
per leaf feeds every application, so autograd sums the applications'
gradients there, in the compute dtype, last application first, as the
reference's scan transpose sums the cotangent of the closed-over block.
The `moe` family's layers return their aux loss and expert load beside
the hidden state in training (`MoeBlock.train_run`), which `lm_backbone` sums
over the layers as the reference's scan carry does.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.compat import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (chunked_xent, dense_init, rms_norm,
                                      swiglu)

AUX_LOSS_COEF = 0.01
REMAT_MODES = ("none", "full", "dots")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string ("bfloat16", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype '{name}'")
    return dt


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run yet. It serves the `ssm`
    family, the `dense` family (MLA included) and the `hybrid` family
    without MoE, and MoE without MLA or leading dense layers (family
    `moe`, or `dense` with experts: the reference builds MoE blocks for
    either). Every family it runs also trains, the dense family's MLA
    included."""
    if cfg.family == "ssm" or (cfg.family in ("dense", "hybrid") and
                               not cfg.is_moe and
                               not (cfg.is_mla and cfg.family == "hybrid")):
        return
    if cfg.family in ("dense", "moe") and cfg.is_moe and not cfg.is_mla \
            and cfg.moe.first_dense_layers == 0:
        return
    prologue = cfg.is_moe and cfg.moe.first_dense_layers > 0
    raise NotImplementedError(
        f"the '{cfg.family}' family ({cfg.arch_id}"
        f"{', MoE' if cfg.is_moe else ''}{', MLA' if cfg.is_mla else ''}"
        f"{', leading dense layers' if prologue else ''}) is not yet "
        f"ported; the port runs the 'ssm' family, the 'dense' family "
        f"(MLA included) and the 'hybrid' family without MoE, and MoE "
        f"without MLA or leading dense layers")


def shared_flags(cfg: ModelConfig) -> List[bool]:
    """Per layer, whether the hybrid's shared block runs before it (the
    reference's `np_flags`: i % shared_attn_every == 0); all False for
    the other families."""
    every = cfg.shared_attn_every if cfg.family == "hybrid" else 0
    return [bool(every) and i % every == 0 for i in range(cfg.n_layers)]


def _param(dtype: torch.dtype, device: torch.device, *shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class MambaBlock(nn.Module):
    """One layer: the pre-norm scale `ln1` and the mixer `ssm`. Its
    static functions run one layer's compute parameters (a nested dict,
    `_LM.compute_params`) over the sequence, in prefill and in decode."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.ln1 = _param(dtype, device, cfg.d_model)
        self.ssm = ssm_mod.Mamba2Mixer(cfg, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init of the layer, drawn from `generator`."""
        self.ln1.fill_(1.0)
        self.ssm.reset_parameters(generator)

    @staticmethod
    def run(blk: Dict, x: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        return x + ssm_mod.ssm_forward(blk["ssm"], h, cfg)

    @staticmethod
    def prefill(blk: Dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, S_max: Optional[int]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        y, c = ssm_mod.ssm_forward(blk["ssm"], h, cfg, return_cache=True)
        return x + y, c

    @staticmethod
    def decode(blk: Dict, c: Dict[str, torch.Tensor], x: torch.Tensor,
               pos: Optional[int], cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        y, nc = ssm_mod.ssm_decode(blk["ssm"], c, h, cfg)
        return x + y, nc

    @staticmethod
    def cache_spec(cfg: ModelConfig, B: int, S_max: Optional[int],
                   dtype: torch.dtype) -> Dict:
        """The layer's conv and state (the cache does not grow)."""
        return ssm_mod.ssm_cache_spec(cfg, B, dtype)


class DenseMlp(nn.Module):
    """The SwiGLU MLP's parameters: w1, w3 [d, d_ff] and w2 [d_ff, d]."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w1 = _param(dtype, device, d, f)
        self.w3 = _param(dtype, device, d, f)
        self.w2 = _param(dtype, device, f, d)


def attn_cache_len(cfg: ModelConfig, S_max: int) -> int:
    """S_c: the attention cache's length, the window's for SWA."""
    return min(S_max, cfg.sliding_window) if cfg.sliding_window else S_max


def _residual_ln2(blk: Dict, x: torch.Tensor, a: torch.Tensor,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + a, ln2 of it): the residual sum (a the attention's output)
    and the MLP's input. ln2's variance is taken of the f32 sum before
    it is rounded to the compute dtype: XLA's compiled CPU programs of
    the reference's block, `lm_prefill` and `lm_decode` all drop that
    f32 -> bf16 -> f32 pair (the square reads the f32 add; the value
    path the rounded one), the hybrid's shared block inside its
    `lax.cond` too."""
    s = x.float() + a                   # the add widens a bf16 a exactly
    x = s.to(x.dtype)
    return x, rms_norm(x, blk["ln2"], cfg.norm_eps, stats=s)


def _mlp(blk: Dict, x: torch.Tensor, a: torch.Tensor, cfg: ModelConfig
         ) -> torch.Tensor:
    """The residual sum x + a, then ln2 and the MLP (`_residual_ln2`):
    the SwiGLU `mlp`, or the MoE layer where the block holds `moe` (as
    the reference's `_attn_mlp_block` picks; the serve drops its aux
    loss and load, as the reference's decode does)."""
    x, h = _residual_ln2(blk, x, a, cfg)
    if "moe" in blk:
        return x + moe_mod.moe_forward(blk["moe"], h, cfg,
                                       with_stats=False)[0]
    mlp = blk["mlp"]
    return x + swiglu(h, mlp["w1"], mlp["w3"], mlp["w2"])


class DenseBlock(nn.Module):
    """One layer: `ln1`, the attention `attn` (GQA, or MLA where the
    config has a latent: `cfg.is_mla`), `ln2` and the MLP `mlp`; static
    functions as `MambaBlock`'s."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.ln1 = _param(dtype, device, cfg.d_model)
        self.attn = (att.MlaAttention if cfg.is_mla else
                     att.GqaAttention)(cfg, dtype, device)
        self.ln2 = _param(dtype, device, cfg.d_model)
        self.mlp = DenseMlp(cfg, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init of the layer, drawn from `generator`."""
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.reset_parameters(generator)
        for w in (self.mlp.w1, self.mlp.w3, self.mlp.w2):
            w.copy_(dense_init(generator, w.shape, w.dtype))

    @staticmethod
    def run(blk: Dict, x: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        forward = att.mla_forward if cfg.is_mla else att.gqa_forward
        return _mlp(blk, x, forward(blk["attn"], h, cfg, positions), cfg)

    @staticmethod
    def prefill(blk: Dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, S_max: Optional[int]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """k / v (MLA: the latent and the rope key) are projected once,
        for the attention and for the cache (zero-padded to S_c; under
        SWA its last S_c positions only)."""
        if S_max is None:
            raise ValueError("an attention prefill needs S_max (the "
                             "cache length)")
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        if cfg.is_mla:
            latent = att.mla_latent(blk["attn"], h, cfg, positions)
            c_kv, k_rope = att.pad_latent(latent[0].to(h.dtype), latent[1],
                                          S_max)
            a = att.mla_forward(blk["attn"], h, cfg, positions, latent)
            return _mlp(blk, x, a, cfg), {"c_kv": c_kv, "k_rope": k_rope}
        k, v = att.project_kv(blk["attn"], h, cfg, positions)
        S_c = attn_cache_len(cfg, S_max)
        ck, cv = att.pad_cache(k[:, :, -S_c:], v[:, :, -S_c:], S_c)
        a = att.gqa_forward(blk["attn"], h, cfg, positions, kv=(k, v))
        return _mlp(blk, x, a, cfg), {"k": ck, "v": cv}

    @staticmethod
    def decode(blk: Dict, c: Dict[str, torch.Tensor], x: torch.Tensor,
               pos: Optional[int], cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Writes the token's k / v into the cache tensors in place."""
        if pos is None:
            raise ValueError("an attention decode needs pos (the "
                             "token's position)")
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        if cfg.is_mla:
            o, ck, kr = att.mla_decode(blk["attn"], c["c_kv"], c["k_rope"],
                                       h, pos, cfg)
            return _mlp(blk, x, o, cfg), {"c_kv": ck, "k_rope": kr}
        o, k, v = att.gqa_decode(blk["attn"], c["k"], c["v"], h, pos, cfg)
        return _mlp(blk, x, o, cfg), {"k": k, "v": v}

    @staticmethod
    def cache_spec(cfg: ModelConfig, B: int, S_max: Optional[int],
                   dtype: torch.dtype) -> Dict:
        """k and v [B,KV,S_c,D] (on one card the KV heads are not
        replicated: the reference's `kv_eff_heads` at tp=1); MLA's
        latent c_kv [B,S_max,R] and rope key k_rope [B,S_max,rope], the
        reference's names."""
        if S_max is None:
            raise ValueError("an attention cache needs S_max")
        if cfg.is_mla:
            m = cfg.mla
            return {"c_kv": ((B, S_max, m.kv_lora_rank), dtype),
                    "k_rope": ((B, S_max, m.qk_rope_head_dim), dtype)}
        shape = (B, cfg.n_kv_heads, attn_cache_len(cfg, S_max),
                 cfg.resolved_head_dim)
        return {"k": (shape, dtype), "v": (shape, dtype)}


class MoeBlock(DenseBlock):
    """One layer of the `moe` family: `ln1`, the attention `attn`, `ln2`
    and the MoE layer `moe` in the MLP's place (`_mlp` runs it without
    its stats); its run, prefill, decode and cache are `DenseBlock`'s.
    `train_run` also returns the layer's aux loss and expert load."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        nn.Module.__init__(self)
        self.ln1 = _param(dtype, device, cfg.d_model)
        self.attn = att.GqaAttention(cfg, dtype, device)
        self.ln2 = _param(dtype, device, cfg.d_model)
        self.moe = moe_mod.MoeMlp(cfg, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init of the layer, drawn from `generator`."""
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.reset_parameters(generator)
        self.moe.reset_parameters(generator)

    @staticmethod
    def train_run(blk: Dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x, aux, load [E]): the layer as the reference's
        `_attn_mlp_block` computes it, `moe_forward` with its stats."""
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        x, h = _residual_ln2(blk, x, att.gqa_forward(blk["attn"], h, cfg,
                                                     positions), cfg)
        y, aux, load = moe_mod.moe_forward(blk["moe"], h, cfg)
        return x + y, aux, load


def _nest(named) -> Dict[str, Any]:
    """{"a.b": t} -> {"a": {"b": t}}."""
    out: Dict[str, Any] = {}
    for name, t in named:
        *head, last = name.split(".")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = t
    return out


class _LM(nn.Module):
    """The parameters of a decoder-only LM: embed [V,d], one block per
    layer, final_norm [d] and lm_head [d,V] (the reference's names and
    `[in, out]` layout). The functions below run it, each layer through
    `block_cls`'s static functions."""

    block_cls: type

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        if model_class(cfg) is not type(self):
            raise ValueError(f"{type(self).__name__} does not run the "
                             f"'{cfg.family}' family ({cfg.arch_id})")
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab
        self.embed = _param(dtype, device, V, d)
        self.blocks = nn.ModuleList(self.block_cls(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param(dtype, device, d)
        self.lm_head = _param(dtype, device, d, V)
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
            blk.reset_parameters(generator)

    def unstacked(self) -> Dict[str, nn.Module]:
        """Modules the reference holds as an unstacked subtree of its
        parameters beside `blocks` (the hybrid's shared block)."""
        return {}

    def compute_params(self, dtype: torch.dtype) -> Dict[str, Any]:
        """The parameters as the reference's forward sees them after
        `_cast_params`, as a tree of tensors: {embed, final_norm,
        lm_head, blocks: [one nested dict per layer, by the modules'
        names]}, and a nested dict for each of `unstacked()` (its
        matrices cast, its vectors not: they are not stacked). Kept
        until a parameter changes (tracked by the tensors' storage and
        version counters), so a served model is cast once, not at every
        step; a leaf already in `dtype` is the parameter itself."""
        key = (dtype, tuple((p.data_ptr(), p._version)
                            for p in self.parameters()))
        if self._compute[0] != key:
            def cast(t):
                return t.detach().to(dtype) \
                    if t.dtype in (torch.float32, torch.bfloat16) else t
            tree = {"embed": cast(self.embed),
                    "final_norm": self.final_norm.detach(),
                    "lm_head": cast(self.lm_head),
                    "blocks": [_nest((n, cast(p)) for n, p in
                                     b.named_parameters())
                               for b in self.blocks]}
            for name, mod in self.unstacked().items():
                tree[name] = _nest((n, cast(p) if p.dim() >= 2 else
                                    p.detach())
                                   for n, p in mod.named_parameters())
            self._compute = (key, tree)
        return self._compute[1]


class MambaLM(_LM):
    """The `ssm` family: one `MambaBlock` per layer."""

    block_cls = MambaBlock


class DenseLM(_LM):
    """The `dense` family: one `DenseBlock` per layer."""

    block_cls = DenseBlock


class HybridLM(_LM):
    """The `hybrid` family (Zamba2): one `MambaBlock` per layer and one
    shared attention + MLP block, `shared_attn` (a `DenseBlock`: ln1,
    attn, ln2, mlp, the reference's names), whose one set of parameters
    runs before layer i wherever `shared_flags(cfg)[i]`; each
    application keeps a KV cache of its own. The reference's init draws
    it after the layers, as here."""

    block_cls = MambaBlock

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__(cfg, device, dtype)
        self.shared_attn = DenseBlock(cfg, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: the layers, then the shared block."""
        super().reset_parameters(generator)
        self.shared_attn.reset_parameters(generator)

    def unstacked(self) -> Dict[str, nn.Module]:
        """The shared block: one set of parameters, not stacked."""
        return {"shared_attn": self.shared_attn}


class MoeLM(_LM):
    """The `moe` family: one `MoeBlock` per layer."""

    block_cls = MoeBlock


def model_class(cfg: ModelConfig) -> type:
    """The module class of `cfg`'s family (raises for one not ported)."""
    check_family(cfg)
    if cfg.is_moe:
        return MoeLM
    return {"ssm": MambaLM, "dense": DenseLM,
            "hybrid": HybridLM}[cfg.family]


# ======================================================================
# Forward, prefill, decode
# ======================================================================
def lm_forward(params: _LM, tokens: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """tokens [B,S] -> logits [B,S,V] (the reference also returns the
    aux loss and expert load, which only the MoE family has; the port
    serves it without them). The hybrid's shared block runs before each
    flagged layer (`shared_flags`)."""
    pc = params.compute_params(torch_dtype(cfg.dtype))
    x = pc["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    for blk, shared in zip(pc["blocks"], shared_flags(cfg)):
        if shared:
            x = DenseBlock.run(pc["shared_attn"], x, positions, cfg)
        x = params.block_cls.run(blk, x, positions, cfg)
    h = rms_norm(x, pc["final_norm"], cfg.norm_eps)
    return h @ pc["lm_head"]


def lm_cache_spec(cfg: ModelConfig, B: int, S_max: Optional[int] = None,
                  dtype: Optional[torch.dtype] = None
                  ) -> Dict[str, List[Dict]]:
    """(shape, dtype) of every decode-cache tensor, per layer: the SSM's
    conv and state, or the attention's k and v [B,KV,S_c,D]; the
    hybrid's also under "shared_attn", the shared block's k and v per
    application."""
    spec = model_class(cfg).block_cls.cache_spec
    dtype = dtype or torch_dtype(cfg.dtype)
    out = {"blocks": [spec(cfg, B, S_max, dtype)
                      for _ in range(cfg.n_layers)]}
    n_apps = sum(shared_flags(cfg))
    if n_apps:
        out["shared_attn"] = [DenseBlock.cache_spec(cfg, B, S_max, dtype)
                              for _ in range(n_apps)]
    return out


def stack_cache(cache: Dict[str, List[Dict]]) -> Dict[str, Dict]:
    """The reference's layout of a decode cache: {"blocks": {name:
    [L, ...]}} (and the hybrid's {"shared_attn": {name: [n_apps,
    ...]}}), each per-layer (per-application) tensor stacked along a
    new leading axis, as the reference's `lax.scan` over the layers
    returns them."""
    return {part: {k: torch.stack([c[k] for c in per]) for k in per[0]}
            for part, per in cache.items()}


def unstack_cache(tree: Dict[str, Dict]) -> Dict[str, List[Dict]]:
    """Inverse of :func:`stack_cache`: one dict per layer (and per
    application; views into the stacked tensors)."""
    out = {}
    for part, leaves in tree.items():
        n = len(next(iter(leaves.values())))
        out[part] = [{k: v[i] for k, v in leaves.items()} for i in range(n)]
    return out


def lm_prefill(params: _LM, tokens: torch.Tensor, cfg: ModelConfig,
               S_max: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict[str, List[Dict]]]:
    """Forward pass that also builds the decode cache. Returns
    (last_logits [B,V], {"blocks": [one dict per layer]}: the SSM's
    {conv, state}, or the attention's {k, v} padded to S_max; the
    hybrid's also {"shared_attn": [one {k, v} per application]})."""
    pc = params.compute_params(torch_dtype(cfg.dtype))
    x = pc["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    cache: Dict[str, List[Dict]] = {"blocks": []}
    for blk, shared in zip(pc["blocks"], shared_flags(cfg)):
        if shared:
            x, c = DenseBlock.prefill(pc["shared_attn"], x, positions, cfg,
                                      S_max)
            cache.setdefault("shared_attn", []).append(c)
        x, c = params.block_cls.prefill(blk, x, positions, cfg, S_max)
        cache["blocks"].append(c)
    h = rms_norm(x, pc["final_norm"], cfg.norm_eps)
    return h[:, -1] @ pc["lm_head"], cache


def lm_decode(params: _LM, cache: Dict[str, List[Dict]],
              tokens: torch.Tensor, cfg: ModelConfig,
              pos: Optional[int] = None
              ) -> Tuple[torch.Tensor, Dict[str, List[Dict]]]:
    """One-token decode step. tokens [B,1] -> (logits [B,V], new
    cache). `pos` is the new token's position, which every attention
    reads (the dense family's layers, the hybrid's shared block); the
    SSM's cache carries its own state. Attention writes the token's k /
    v into the cache tensors in place."""
    pc = params.compute_params(torch_dtype(cfg.dtype))
    x = pc["embed"][tokens]                                  # [B,1,d]
    new: Dict[str, List[Dict]] = {"blocks": []}
    apps = iter(cache.get("shared_attn", ()))
    for blk, c, shared in zip(pc["blocks"], cache["blocks"],
                              shared_flags(cfg)):
        if shared:
            x, nc = DenseBlock.decode(pc["shared_attn"], next(apps), x, pos,
                                      cfg)
            new.setdefault("shared_attn", []).append(nc)
        x, nc = params.block_cls.decode(blk, c, x, pos, cfg)
        new["blocks"].append(nc)
    h = rms_norm(x, pc["final_norm"], cfg.norm_eps)
    return h[:, -1] @ pc["lm_head"], new


# ======================================================================
# Training: parameter trees, remat, the loss
# ======================================================================
def param_tree(model: _LM) -> Dict[str, Any]:
    """The module's parameters themselves as the tree `lm_loss` takes:
    {embed, final_norm, lm_head, blocks: [one nested dict per layer]}
    and a nested dict for each of `unstacked()` (the hybrid's
    `shared_attn`, by the reference's names): `compute_params`' layout,
    before any cast."""
    tree = {"embed": model.embed, "final_norm": model.final_norm,
            "lm_head": model.lm_head,
            "blocks": [_nest(b.named_parameters()) for b in model.blocks]}
    for name, mod in model.unstacked().items():
        tree[name] = _nest(mod.named_parameters())
    return tree


def _stack(items: List[Any], device) -> Any:
    if isinstance(items[0], dict):
        return {k: _stack([d[k] for d in items], device) for k in items[0]}
    return torch.stack([t.detach().to(device) for t in items])


def stack_layers(tree: Dict[str, Any],
                 device: Optional[torch.device] = None) -> Dict[str, Any]:
    """A per-layer tree ({.., blocks: [per-layer dicts]}) in the
    reference's layout: each block leaf stacked along a new leading
    layer axis [L, ...] (copies, on `device` if given, else each
    tensor's own); the other leaves, an unstacked subtree's
    (`shared_attn`) included, detached as they are and moved
    likewise."""
    return {k: _stack(v, device) if k == "blocks" else
            tree_map(lambda t: t.detach().to(device), v)
            for k, v in tree.items()}


def layer_views(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`stack_layers` without copies: the per-layer
    tree whose block leaves are views `leaf[i]` of the stacked ones;
    the other leaves and subtrees are the stacked tree's own."""
    blocks = tree["blocks"]
    n = len(next(tree_leaves(blocks)))
    return {k: [tree_map(lambda t, i=i: t[i], blocks) for i in range(n)]
            if k == "blocks" else v for k, v in tree.items()}


def cast_params(params: Dict[str, Any], dtype: torch.dtype
                ) -> Dict[str, Any]:
    """The reference's `_cast_params` through autograd: every float leaf
    with ndim >= 2 in `dtype`, counting a block leaf's stacked layer
    axis (so every block leaf is cast, while `final_norm` and an
    unstacked subtree's vectors, the hybrid's `shared_attn` norms, stay
    in the parameter dtype); the gradient flows back to the parameter
    dtype."""
    def cast(t: torch.Tensor, stacked: int) -> torch.Tensor:
        return t.to(dtype) if t.dtype in (torch.float32, torch.bfloat16) \
            and t.dim() + stacked >= 2 else t
    return {k: tree_map(functools.partial(cast, stacked=int(k == "blocks")),
                        v) for k, v in params.items()}


# matrix products without batch dims (activations @ weights): what the
# reference's "dots" remat saves (`dots_with_no_batch_dims_saveable`)
_SAVED_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn: Callable, remat: str) -> Callable:
    """`fn` under the reference's remat modes: "none" as is, "full"
    recomputed in the backward (`torch.utils.checkpoint`, non-reentrant),
    "dots" recomputed except the matrix products without batch dims,
    which are saved (a selective checkpoint)."""
    if remat == "none":
        return fn
    if remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    raise ValueError(f"unknown remat '{remat}'; one of {REMAT_MODES}")


def lm_backbone(pc: Dict[str, Any], x: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig,
                remat: str = "full"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Embedded input -> final hidden, each layer under `remat`. Returns
    (h, aux_loss, load[E]): the MoE layers' aux losses and expert loads
    summed in f32 in layer order from zeros, as the reference's scan
    carries them (zeros of [max(n_experts, 1)] for the other
    families; the MoE's layers run `MoeBlock.train_run`). Under "full"
    a MoE layer's routing is recomputed in the backward with the rest
    of it, as `jax.checkpoint` recomputes it;
    under "dots" the router's product (an `mm`) is saved and the
    experts' `bmm`s are recomputed. The hybrid's shared block
    (`pc["shared_attn"]`) runs before each flagged layer inside that
    layer's remat region, as the reference's scan body holds both: under
    "full" its application is recomputed in the backward, under "dots"
    its products are saved. Its parameters enter each region as an
    argument, so their gradients meet at the one cast tensor."""
    check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    load = torch.zeros((max(cfg.moe.n_experts, 1),), dtype=torch.float32,
                       device=x.device)
    if cfg.is_moe:
        layer = maybe_remat(lambda blk, h: MoeBlock.train_run(
            blk, h, positions, cfg), remat)
        for blk in pc["blocks"]:
            x, a, ld = layer(blk, x)
            aux, load = aux + a, load + ld
        return rms_norm(x, pc["final_norm"], cfg.norm_eps), aux, load
    run = model_class(cfg).block_cls.run

    def plain(blk, h):
        return run(blk, h, positions, cfg)

    def shared(blk, sa, h):
        return run(blk, DenseBlock.run(sa, h, positions, cfg), positions,
                   cfg)

    layer, with_shared = maybe_remat(plain, remat), maybe_remat(shared, remat)
    for blk, flag in zip(pc["blocks"], shared_flags(cfg)):
        x = with_shared(blk, pc["shared_attn"], x) if flag else layer(blk, x)
    return rms_norm(x, pc["final_norm"], cfg.norm_eps), aux, load


def lm_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, remat: str = "full"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Embed -> blocks -> final norm -> chunked CE, plus AUX_LOSS_COEF x
    aux. `params` is a per-layer tree (:func:`param_tree`, or
    :func:`layer_views`) in the parameter dtype; it is cast to the
    compute dtype through autograd. batch: tokens and targets [B,S]
    integer tensors. Returns (loss, {ce, aux, expert_load}); aux and
    expert_load are the MoE layers' sums (zeros for the other
    families)."""
    check_family(cfg)
    pc = cast_params(params, torch_dtype(cfg.dtype))
    x = pc["embed"][batch["tokens"]]
    positions = torch.arange(x.shape[1], device=x.device)
    h, aux, load = lm_backbone(pc, x, positions, cfg, remat)
    ce = chunked_xent(h, pc["lm_head"], batch["targets"])
    loss = ce + AUX_LOSS_COEF * aux
    return loss, {"ce": ce, "aux": aux, "expert_load": load}
