"""Family dispatch, as `repro/models/registry.py`, for the families the
port runs (`ssm`); the others raise "not yet ported".

  build_model(cfg, generator, device)      -> MambaLM (nn.Module)
  prefill_fn(cfg)(model, tokens)           -> (logits, cache)
  decode_fn(cfg)(model, cache, tokens)     -> (logits, cache)
  cache_spec(cfg, B)                       -> (shape, dtype) per tensor
  load_reference_params(model, tree)       -> the JAX package's weights
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import MambaLM, torch_dtype


def build_model(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None,
                dtype: Optional[torch.dtype] = None) -> MambaLM:
    """The model on `device` (CUDA unless the caller asks for the CPU)
    in the parameter dtype (`cfg.param_dtype` unless given), its
    weights drawn from `generator` as the reference's init draws them
    (the numbers differ: torch's generator is not jax's)."""
    model = MambaLM(cfg, resolve_device(device),
                    dtype or torch_dtype(cfg.param_dtype))
    model.reset_parameters(generator)
    return model


# the reference's name: the port's parameters live in the module
init_params = build_model


def prefill_fn(cfg: ModelConfig) -> Callable:
    """(model, tokens [B,S]) -> (last logits [B,V], decode cache)."""
    transformer.check_family(cfg)
    return lambda model, tokens: transformer.lm_prefill(model, tokens, cfg)


def decode_fn(cfg: ModelConfig) -> Callable:
    """(model, cache, tokens [B,1]) -> (logits [B,V], new cache)."""
    transformer.check_family(cfg)
    return lambda model, cache, tokens: transformer.lm_decode(
        model, cache, tokens, cfg)


def cache_spec(cfg: ModelConfig, B: int,
               dtype: Optional[torch.dtype] = None):
    """(shape, dtype) of every decode-cache tensor, per layer."""
    return transformer.lm_cache_spec(cfg, B, dtype)


@torch.no_grad()
def load_reference_params(model: MambaLM, tree: Mapping[str, Any]) -> None:
    """Copy the JAX package's parameter pytree (`init_lm_params`, its
    leaves as numpy arrays) into `model`: the stacked [L, ...] block
    leaves are unstacked into the per-layer modules, and every matrix
    keeps the reference's [in, out] layout. After it both packages
    compute the same function."""
    def copy(dst: torch.Tensor, src, name: str) -> None:
        src = torch.from_numpy(np.array(src, dtype=np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: reference shape {tuple(src.shape)}, "
                             f"port shape {tuple(dst.shape)}")
        dst.copy_(src)

    want = {"embed", "final_norm", "lm_head", "blocks"}
    if set(tree) != want:
        raise ValueError(f"reference tree has {sorted(tree)}, expected "
                         f"{sorted(want)}")
    for name in ("embed", "final_norm", "lm_head"):
        copy(getattr(model, name), tree[name], name)
    blocks = tree["blocks"]
    names = {n for n, _ in model.blocks[0].ssm.named_parameters()}
    if set(blocks) != {"ln1", "ssm"} or set(blocks["ssm"]) != names:
        raise ValueError("reference blocks do not hold the ssm family's "
                         "parameters")
    n_layers = np.shape(blocks["ln1"])[0]
    if n_layers != len(model.blocks):
        raise ValueError(f"reference has {n_layers} layers, the port "
                         f"{len(model.blocks)}")
    for i, blk in enumerate(model.blocks):
        copy(blk.ln1, blocks["ln1"][i], f"blocks.{i}.ln1")
        for n, p in blk.ssm.named_parameters():
            copy(p, blocks["ssm"][n][i], f"blocks.{i}.ssm.{n}")
