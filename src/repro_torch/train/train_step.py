"""Train step: loss -> grads -> WANify cross-pod sync -> AdamW, as
`repro/train/train_step.py` composes it.

The parameters and the optimizer state are the reference's stacked
tree (`transformer.stack_layers`: block leaves [L, ...]), so the sync's
chunks (along the layer axis) and its quantization groups, AdamW's
chunked update and the checkpoints are the reference's. The loss runs
on per-layer views of it (`layer_views`), and each layer's gradients
are written into a stacked gradient tree (one copy).

  * one pod: `core` — the gradients of the loss (optionally accumulated
    over microbatches in `accum_dtype`), then AdamW;
  * several pods: the reference's vmap-over-pods formulation. Every
    leaf carries an explicit leading pod dim ([P, ...], block leaves
    [P, L, ...]: `broadcast_to_pods`, `strip_pods`); each pod's
    gradients come from its slice of the batch into a [P, ...] tree,
    are synchronised under the plan by
    `core/wansync.py::wan_allreduce_batched` (or the `psum` baseline),
    and AdamW runs per pod.

Every step updates its parameters and moments in place and returns
(params, opt_state, out) with out = {loss, grad_norm, lr, ce,
expert_load}.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.compat import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import WanPlan
from repro_torch.core.wansync import (psum_allreduce_batched,
                                      wan_allreduce_batched)
from repro_torch.models import registry
from repro_torch.models.transformer import layer_views
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def as_batch(batch: Dict[str, Any], device: torch.device
             ) -> Dict[str, torch.Tensor]:
    """tokens / targets (numpy or tensors) as int64 tensors on
    `device`."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device, torch.long)
        for k, v in batch.items() if k in ("tokens", "targets")}


def _grads_of(cfg: ModelConfig, microbatch: int, accum_dtype: torch.dtype,
              remat: str) -> Callable:
    """(params, batch, out=None) -> (loss, metrics, grads) of a stacked
    tree: the loss of detached per-layer views of `params` (requiring
    grad), and its gradients written into the stacked tree `out` (a new
    one when None: the parameters' dtype, or `accum_dtype` when
    microbatches are accumulated). Every tensor is detached."""
    loss_f = registry.loss_fn(cfg, remat)
    n_mb = max(microbatch, 1)

    def once(params, batch):
        leaves = tree_map(lambda t: t.detach().requires_grad_(),
                          layer_views(params))
        loss, metrics = loss_f(leaves, batch)
        grads = torch.autograd.grad(loss, list(tree_leaves(leaves)))
        return loss.detach(), tree_map(torch.Tensor.detach, metrics), grads

    def grads_of(params, batch, out=None):
        if out is None:
            out = grad_tree(params, n_mb, accum_dtype)
        dst = list(tree_leaves(layer_views(out)))
        if n_mb == 1:
            loss, metrics, grads = once(params, batch)
            for d, g in zip(dst, grads):
                d.copy_(g)
            return loss, metrics, out
        for t in tree_leaves(out):
            t.zero_()
        n = next(iter(batch.values())).shape[0] // n_mb
        loss_a = None
        for j in range(n_mb):
            mb = {k: v[j * n:(j + 1) * n] for k, v in batch.items()}
            loss, metrics, grads = once(params, mb)
            for d, g in zip(dst, grads):
                d.add_(g.to(d.dtype))
            del grads
            loss_a = loss if loss_a is None else loss_a + loss
        for t in tree_leaves(out):
            t.div_(n_mb)
        return loss_a / n_mb, metrics, out

    return grads_of


def grad_tree(params: Any, microbatch: int, accum_dtype: torch.dtype
              ) -> Any:
    """An empty gradient tree of `params`' layout: the parameters'
    dtype, or `accum_dtype` when microbatches are accumulated."""
    return tree_map(lambda t: torch.empty_like(
        t, dtype=accum_dtype if microbatch > 1 else t.dtype), params)


def make_train_step(cfg: ModelConfig, *, n_pods: int = 1,
                    plan: Optional[WanPlan] = None,
                    opt: Optional[AdamWConfig] = None,
                    sync: str = "wanify",          # wanify | psum | none
                    compress: bool = False,
                    microbatch: int = 1,
                    accum_dtype: torch.dtype = torch.float32,
                    remat: str = "full") -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    out). `params` is the stacked tree (`stack_layers`); with n_pods > 1
    every leaf has a leading pod dim and the batch is split across the
    pods along its first axis."""
    opt = opt or AdamWConfig()
    grads_fn = _grads_of(cfg, microbatch, accum_dtype, remat)

    def core(params, opt_state, batch):
        dev = next(iter(tree_leaves(params))).device
        loss, metrics, grads = grads_fn(params, as_batch(batch, dev))
        params, opt_state, om = adamw_update(opt, params, grads, opt_state)
        out = {"loss": loss, **om, "ce": metrics.get("ce", loss),
               "expert_load": metrics.get("expert_load")}
        return params, opt_state, out

    if n_pods <= 1:
        return core
    if sync == "wanify" and plan is None:
        raise ValueError("wanify sync needs a WanPlan")

    def pod(tree: Any, p: int) -> Any:
        return tree_map(lambda t: t[p], tree)

    def step(params_p, opt_state_p, batch):
        dev = next(iter(tree_leaves(params_p))).device
        batch = as_batch(batch, dev)
        per = next(iter(batch.values())).shape[0] // n_pods
        grads_p = grad_tree(params_p, microbatch, accum_dtype)
        losses, ces, loads = [], [], []
        for p in range(n_pods):
            loss, metrics, _ = grads_fn(
                pod(params_p, p), {k: v[p * per:(p + 1) * per]
                                   for k, v in batch.items()},
                pod(grads_p, p))
            losses.append(loss)
            ces.append(metrics.get("ce", loss))
            loads.append(metrics["expert_load"])
        if sync == "wanify":
            grads_p = wan_allreduce_batched(grads_p, plan, compress=compress)
        elif sync == "psum":
            grads_p = psum_allreduce_batched(grads_p, n_pods)
        steps, gns, lrs = [], [], []
        for p in range(n_pods):
            _, st, om = adamw_update(
                opt, pod(params_p, p), pod(grads_p, p),
                {"m": pod(opt_state_p["m"], p),
                 "v": pod(opt_state_p["v"], p),
                 "step": opt_state_p["step"][p]})
            steps.append(st["step"])
            gns.append(om["grad_norm"])
            lrs.append(om["lr"])
        opt_state_p = {"m": opt_state_p["m"], "v": opt_state_p["v"],
                       "step": torch.stack(steps)}
        out = {"loss": torch.stack(losses).mean(),
               "grad_norm": torch.stack(gns).mean(), "lr": lrs[0],
               "ce": torch.stack(ces).mean(),
               "expert_load": torch.stack(loads).mean(dim=0)}
        return params_p, opt_state_p, out

    return step


def broadcast_to_pods(tree: Any, n_pods: int) -> Any:
    """Add the explicit leading pod dim, every pod a copy of its own
    (the pods' parameters are updated in place, one slice each)."""
    return tree_map(
        lambda x: x[None].expand(n_pods, *x.shape).clone(), tree)


def strip_pods(tree: Any) -> Any:
    """Drop the pod dim (slices are value-identical after sync): views
    of pod 0's slice."""
    return tree_map(lambda x: x[0], tree)
