"""Family dispatch, as `repro/models/registry.py`, for the families the
port runs, each of which serves and trains: `ssm`, `dense` (MLA,
`minicpm3-4b`, included) and `hybrid` without MoE, and `moe` without MLA
or leading dense layers; the others raise "not yet ported".

  build_model(cfg, generator, device)          -> MambaLM | DenseLM |
                                                  HybridLM | MoeLM
  loss_fn(cfg, remat)(params, batch)           -> (loss, metrics)
  prefill_fn(cfg, s_max)(model, tokens)        -> (logits, cache)
  decode_fn(cfg)(model, cache, tokens, pos)    -> (logits, cache)
  cache_spec(cfg, B, s_max)                    -> (shape, dtype) per tensor
  load_reference_params(model, tree)           -> the JAX package's weights
  param_count(cfg)                             -> parameters, none allocated
  active_param_count(cfg)                      -> those a token touches

`s_max` sizes the attention caches (the dense and moe families' layers,
the hybrid's shared block) and `pos` is the decode position they read;
the `ssm` family takes neither (its cache does not grow).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import torch_dtype


def build_model(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None,
                dtype: Optional[torch.dtype] = None) -> transformer._LM:
    """The model on `device` (CUDA unless the caller asks for the CPU)
    in the parameter dtype (`cfg.param_dtype` unless given), its
    weights drawn from `generator` as the reference's init draws them
    (the numbers differ: torch's generator is not jax's)."""
    cls = transformer.model_class(cfg)
    model = cls(cfg, resolve_device(device),
                dtype or torch_dtype(cfg.param_dtype))
    model.reset_parameters(generator)
    return model


# the reference's name: the port's parameters live in the module
init_params = build_model


def loss_fn(cfg: ModelConfig, remat: str = "full") -> Callable:
    """(params, batch) -> (loss, {ce, aux, expert_load}):
    :func:`repro_torch.models.transformer.lm_loss` with `remat` ("none",
    "full" or "dots"). The `ssm`, `dense`, `hybrid` and `moe` families
    train (the hybrid's shared block's gradient summed over its
    applications; the MoE's loss carries AUX_LOSS_COEF x its aux loss;
    the dense family's MLA through its flash backward from MLA's parts);
    the others raise "not yet ported"."""
    transformer.check_family(cfg)
    if remat not in transformer.REMAT_MODES:
        raise ValueError(f"unknown remat '{remat}'; one of "
                         f"{transformer.REMAT_MODES}")
    return functools.partial(transformer.lm_loss, cfg=cfg, remat=remat)


def param_count(cfg: ModelConfig) -> int:
    """The model's parameter count, from modules on the meta device (no
    memory is allocated)."""
    model = transformer.model_class(cfg)(cfg, torch.device("meta"),
                                         torch_dtype(cfg.param_dtype))
    return sum(p.numel() for p in model.parameters())


def active_param_count(cfg: ModelConfig) -> int:
    """The parameters a token touches, as the reference counts them:
    all of them, less each MoE layer's routed experts it is not sent to
    (E - top_k of them; shared experts are always on)."""
    total = param_count(cfg)
    if not cfg.is_moe:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    n_moe_layers = cfg.n_layers - m.first_dense_layers
    return total - n_moe_layers * per_expert * (m.n_experts - m.top_k)


def prefill_fn(cfg: ModelConfig, s_max: Optional[int] = None) -> Callable:
    """(model, tokens [B,S]) -> (last logits [B,V], decode cache); the
    attention caches are padded to `s_max` (the window's length under
    SWA)."""
    transformer.check_family(cfg)
    return lambda model, tokens: transformer.lm_prefill(model, tokens, cfg,
                                                        s_max)


def decode_fn(cfg: ModelConfig) -> Callable:
    """(model, cache, tokens [B,1], pos=None) -> (logits [B,V], new
    cache); `pos`, the new token's position, is read by attention (the
    dense and hybrid families)."""
    transformer.check_family(cfg)
    return lambda model, cache, tokens, pos=None: transformer.lm_decode(
        model, cache, tokens, cfg, pos)


def cache_spec(cfg: ModelConfig, B: int, s_max: Optional[int] = None,
               dtype: Optional[torch.dtype] = None):
    """(shape, dtype) of every decode-cache tensor, per layer (and per
    application of the hybrid's shared block)."""
    return transformer.lm_cache_spec(cfg, B, s_max, dtype)


@torch.no_grad()
def load_reference_params(model: transformer._LM,
                          tree: Mapping[str, Any]) -> None:
    """Copy the JAX package's parameter pytree (`init_lm_params`, its
    leaves as numpy arrays) into `model`: the stacked [L, ...] block
    leaves are unstacked into the per-layer modules (block leaf
    `attn/wq` is module parameter `blocks.<i>.attn.wq`), an unstacked
    subtree (the hybrid's `shared_attn`) is copied into its one module,
    and every matrix keeps the reference's [in, out] layout. A tree of
    another family (other top-level keys or block leaves) or of other
    shapes is refused before any parameter is written. After it both
    packages compute the same function."""
    def leaves(t, prefix=""):
        if isinstance(t, Mapping):
            for k, v in t.items():
                yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix[:-1], t

    unstacked = model.unstacked()
    want = {"embed", "final_norm", "lm_head", "blocks"} | set(unstacked)
    if set(tree) != want:
        raise ValueError(f"reference tree has {sorted(tree)}, expected "
                         f"{sorted(want)}")
    pairs = [(getattr(model, name), tree[name], name)
             for name in ("embed", "final_norm", "lm_head")]
    for name, mod in unstacked.items():
        leaf = dict(leaves(tree[name]))
        names = {n for n, _ in mod.named_parameters()}
        if set(leaf) != names:
            raise ValueError(f"reference {name} holds {sorted(leaf)}, the "
                             f"port's {sorted(names)}")
        pairs += [(p, leaf[n], f"{name}.{n}")
                  for n, p in mod.named_parameters()]
    blocks = dict(leaves(tree["blocks"]))
    names = {n for n, _ in model.blocks[0].named_parameters()}
    if set(blocks) != names:
        raise ValueError(f"reference blocks hold {sorted(blocks)}, the "
                         f"port's {sorted(names)}")
    n_layers = {np.shape(v)[0] for v in blocks.values()}
    if n_layers != {len(model.blocks)}:
        raise ValueError(f"reference has {sorted(n_layers)} layers, the "
                         f"port {len(model.blocks)}")
    pairs += [(p, blocks[n][i], f"blocks.{i}.{n}")
              for i, blk in enumerate(model.blocks)
              for n, p in blk.named_parameters()]
    for dst, src, name in pairs:
        if tuple(np.shape(src)) != tuple(dst.shape):
            raise ValueError(f"{name}: reference shape "
                             f"{tuple(np.shape(src))}, port shape "
                             f"{tuple(dst.shape)}")
    for dst, src, _ in pairs:
        dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))
