"""Host-side training orchestration: the WANify Trainer, as
`repro/train/loop.py` runs it.

Per step: data -> train step. Around it:

  * WANify control plane — the Trainer consumes plans from the shared
    `repro_torch.control.WanifyController` (snapshot -> RF prediction
    -> global optimization -> AIMD -> WanPlan). Periodic and straggler
    triggers swap in new plans; the periodic one is fed the §3.3.1 skew
    weights of the step's batch (`pod_skew_weights`). Steps are cached
    on the plan's signature, so oscillating plans reuse their step.
  * fault tolerance — checkpoints every `ckpt_every` (async writes of
    host copies, in the reference's layout); `restore_or_init` resumes
    from the newest complete manifest; a simulated failure restarts
    from it.
  * straggler mitigation — per-step wall-time EWMA in the controller; a
    step slower than `straggler_factor` x EWMA triggers an AIMD
    multiplicative decrease and an immediate re-plan.
  * elastic rescale — `rescale(n_pods)` rebuilds the Trainer for a new
    pod count; checkpoints are pod-free.

The reference takes a mesh; the port takes a pod count and a device
(the pods' state lives on the one device, `train_step.py`). The
parameters and the optimizer state are the reference's stacked tree,
the checkpoint's layout, with a leading pod dim on several pods.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.compat import tree_leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.control import ControllerConfig, WanifyController
from repro_torch.core.plan import WanPlan
from repro_torch.data.pipeline import (DataConfig, batches, pod_skew_weights,
                                       prefetch)
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.transformer import param_tree, stack_layers
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import (as_batch, broadcast_to_pods,
                                          make_train_step, strip_pods)
from repro_torch.wan.simulator import WanSimulator


@dataclass
class LoopConfig:
    """The run: steps, checkpoints, the sync and its compression, the
    replan cadence, the straggler trigger, the connection budget."""

    steps: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25
    log_every: int = 10
    sync: str = "wanify"             # wanify | psum
    compress: bool = False
    replan_every: int = 20
    straggler_factor: float = 2.5
    max_conns: int = 8
    use_skew_weights: bool = True
    seed: int = 0


def _copy_into(dst: Any, src: Any) -> None:
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)


class Trainer:
    """The WANify training loop over `n_pods` pods on `device` (CUDA
    unless the caller asks for the CPU). The initial model comes from
    `registry.init_params` (random weights from a generator seeded by
    `run`'s seed); the newest checkpoint, when there is one, overwrites
    it."""

    def __init__(self, cfg: ModelConfig, n_pods: int, dcfg: DataConfig,
                 loop: LoopConfig = LoopConfig(),
                 opt: Optional[AdamWConfig] = None,
                 sim: Optional[WanSimulator] = None,
                 predictor: Optional[Any] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg, self.dcfg, self.loop = cfg, dcfg, loop
        self.opt = opt or AdamWConfig()
        self.n_pods = int(n_pods)
        self.multi_pod = self.n_pods > 1
        self.device = resolve_device(device)
        self.sim = sim
        self.predictor = predictor
        self._step_cache: Dict[Any, Any] = {}
        self.history: List[Dict[str, float]] = []
        self.events: List[str] = []
        # the closed loop (snapshot -> prediction -> global optimization
        # -> AIMD -> plan) lives in the shared controller; the Trainer
        # only consumes plans and steps
        self.controller: Optional[WanifyController] = None
        if self.multi_pod and self.loop.sync == "wanify" and \
                sim is not None and predictor is not None:
            self.controller = WanifyController(
                sim=sim, predictor=predictor, n_pods=self.n_pods,
                cfg=ControllerConfig(
                    max_conns=self.loop.max_conns,
                    replan_every=self.loop.replan_every,
                    straggler_factor=self.loop.straggler_factor),
                events=self.events)
            self._plan: Optional[WanPlan] = None
        elif self.multi_pod:
            self._plan = WanPlan.uniform(self.n_pods)
        else:
            self._plan = None

    @property
    def plan(self) -> Optional[WanPlan]:
        """The plan in force: the controller's latest when a control
        plane is attached (never a stale copy)."""
        if self.controller is not None:
            return self.controller.plan
        return self._plan

    # ------------------------------------------------------------------
    def _build_step(self, plan: Optional[WanPlan]):
        return make_train_step(self.cfg, n_pods=self.n_pods, plan=plan,
                               opt=self.opt, sync=self.loop.sync,
                               compress=self.loop.compress)

    def _get_step(self):
        if self.controller is not None:
            # keyed on plan.signature(): oscillating plans reuse a step
            return self.controller.compiled(
                (self.loop.sync, self.loop.compress), self._build_step)
        key = (self.plan.signature() if self.plan else ("single",),
               self.loop.sync, self.loop.compress)
        if key not in self._step_cache:
            self._step_cache[key] = self._build_step(self.plan)
        return self._step_cache[key]

    # ------------------------------------------------------------------
    def restore_or_init(self, seed: int = 0):
        """(params, opt_state, start step): the initial model's stacked
        tree (`stack_layers`), overwritten by the newest checkpoint if
        there is one; several pods add a leading pod dim."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = stack_layers(param_tree(
            registry.init_params(self.cfg, gen, self.device)))
        opt_state = init_opt_state(params)
        start = 0
        if self.loop.ckpt_dir:
            latest = ckpt_lib.latest_step(self.loop.ckpt_dir)
            if latest is not None:
                tree = {"p": params, "o": opt_state}
                with torch.no_grad():
                    _copy_into(tree, ckpt_lib.restore(self.loop.ckpt_dir,
                                                      tree))
                start = latest
                self.events.append(f"restored step {latest}")
        if self.multi_pod:
            # the vmap-over-pods formulation: an explicit pod dim
            # (checkpoints stay pod-free, so elastic across pod counts)
            params = broadcast_to_pods(params, self.n_pods)
            opt_state = broadcast_to_pods(opt_state, self.n_pods)
        return params, opt_state, start

    # ------------------------------------------------------------------
    def run(self, seed: int = 0, fail_at: Optional[int] = None):
        """fail_at: inject a simulated node failure at that step (the
        fault-tolerance path): the step restarts from the newest
        checkpoint."""
        params, opt_state, start = self.restore_or_init(seed)
        data = prefetch(batches(self.cfg, self.dcfg))
        step_fn = self._get_step()
        writer = None
        step = start
        while step < self.loop.steps:
            batch = next(data)
            dev_batch = as_batch(batch, self.device)
            t0 = time.perf_counter()
            if fail_at is not None and step == fail_at:
                fail_at = None
                self.events.append(f"simulated failure at step {step}")
                # crash/restart: reload the newest complete checkpoint;
                # the write in flight lands first (in one process the
                # "crash" would otherwise race its own writer)
                if writer is not None:
                    writer.join()
                    writer = None
                params = opt_state = None
                params, opt_state, step = self.restore_or_init(seed)
                step_fn = self._get_step()
                continue
            params, opt_state, out = step_fn(params, opt_state, dev_batch)
            loss, grad_norm = float(out["loss"]), float(out["grad_norm"])
            dt = time.perf_counter() - t0
            # ---- straggler trigger (controller-owned EWMA + AIMD MD) ----
            if self.controller is not None:
                if self.controller.observe_step_time(dt, step=step) \
                        is not None:
                    step_fn = self._get_step()
            self.history.append({"step": step, "loss": loss,
                                 "grad_norm": grad_norm, "time": dt})
            # ---- WANify periodic re-plan --------------------------------
            if self.controller is not None and \
                    self.controller.replan_due(step):
                skw = pod_skew_weights(np.asarray(batch["tokens"]),
                                       self.n_pods, self.cfg.vocab) \
                    if self.loop.use_skew_weights else None
                if self.controller.maybe_replan(step, skew_w=skw) \
                        is not None:
                    step_fn = self._get_step()
            # ---- checkpoint ----------------------------------------------
            if self.loop.ckpt_dir and (step + 1) % self.loop.ckpt_every == 0:
                if writer is not None:
                    writer.join()
                # save copies the leaves to the host before it returns
                tree = {"p": params, "o": opt_state}
                writer = ckpt_lib.save(
                    self.loop.ckpt_dir, step + 1,
                    strip_pods(tree) if self.multi_pod else tree,
                    async_=True)
            step += 1
        if writer is not None:
            writer.join()
        return params, opt_state

    # ------------------------------------------------------------------
    def rescale(self, n_pods: int) -> "Trainer":
        """Elastic scale: a new pod count; the controller re-plans for
        the new cluster size (§3.3.2) and checkpoints are pod-free."""
        t = Trainer(self.cfg, n_pods, self.dcfg, self.loop, self.opt,
                    self.sim, self.predictor, device=self.device)
        # prepend in place: t.events is shared with t.controller's log
        t.events[:0] = self.events + [f"rescaled to {{'pod': {n_pods}}}"]
        return t
