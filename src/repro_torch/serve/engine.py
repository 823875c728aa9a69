"""Serving engine: batched prefill + greedy decode with the model's
decode cache, and the WANify plan for cross-pod cache migration.

Port of `repro/serve/engine.py`. Plans come from the port's WANify
control plane: hand the engine a `repro_torch.control.WanifyController`
and call :meth:`Engine.replan` whenever the WAN shifts.
:func:`kv_migrate` moves a cache from one pod to the others under the
plan's per-offset schedule; the pods are the processes of a
`torch.distributed` group (`repro_torch/compat.py`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.configs.base import ModelConfig
from repro_torch.control import (WanifyController, offset_schedule,
                                 wire_decode, wire_encode)
from repro_torch.core.plan import WanPlan
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.transformer import stack_cache, unstack_cache
from repro_torch.obs.spans import NULL_TRACER


@dataclass
class Request:
    """One generation request (prompt in, generated ids out)."""

    rid: int
    prompt: np.ndarray                  # [S_prompt] int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class ServeConfig:
    """Engine shape: slot count, max sequence, tensor-parallel width.
    `s_max` sizes the attention caches (the dense family's layers, the
    hybrid's shared block; the window's length bounds them under SWA);
    the SSM layers' cache does not grow. The port runs on one
    card, so `tp` must be 1. `greedy` is the reference's field, which it
    never reads: both engines decode greedily whatever it says."""

    batch: int = 8
    s_max: int = 256
    tp: int = 1
    greedy: bool = True


class Engine:
    """Static-batch engine: each group of up to `batch` requests is
    left-padded with token 0 into one prefill, then decoded greedily
    for its longest `max_new`."""

    def __init__(self, cfg: ModelConfig, params: Any, sc: ServeConfig,
                 controller: Optional[WanifyController] = None,
                 plan: Optional[WanPlan] = None,
                 device: Optional[Union[str, torch.device]] = None):
        dev = resolve_device(device)
        if params.device.type != dev.type:
            raise ValueError(f"the model is on {params.device}, the engine "
                             f"on {dev}")
        if sc.tp != 1:
            raise ValueError(f"tp={sc.tp}: the port serves on one card, "
                             "so tensor parallelism takes tp=1")
        self.cfg, self.params, self.sc = cfg, params, sc
        self.device = params.device
        self._prefill = registry.prefill_fn(cfg, sc.s_max)
        self._decode = registry.decode_fn(cfg)
        self.cache = None
        # the next decode token's position: the prefill's length, then
        # one more a step (attention reads it: the dense family's layers,
        # the hybrid's shared block)
        self.pos = 0
        self.last_logits: Optional[torch.Tensor] = None
        # host seconds of each prefill / decode call (each ends when its
        # ids reach the host, so the device work is inside)
        self.timings: Dict[str, List[float]] = {"prefill_s": [],
                                                "decode_s": []}
        # WANify control plane for cache-migration plans
        self.controller = controller
        self._static_plan = plan

    @property
    def plan(self) -> Optional[WanPlan]:
        """The migration plan in force — always the shared controller's
        latest (never a stale snapshot), unless an explicit static plan
        was handed in."""
        if self._static_plan is not None:
            return self._static_plan
        return self.controller.plan if self.controller is not None else None

    @plan.setter
    def plan(self, value: Optional[WanPlan]) -> None:
        """Pin a static plan (overrides the live controller)."""
        self._static_plan = value

    # ------------------------------------------------------------------
    # WANify control plane hooks
    # ------------------------------------------------------------------
    def replan(self, skew_w: Optional[np.ndarray] = None) -> WanPlan:
        """Run one control-loop iteration (snapshot -> prediction ->
        optimization -> AIMD) and adopt the resulting migration plan
        (dropping any static override in favor of the live controller)."""
        if self.controller is None:
            raise RuntimeError("Engine.replan() needs a WanifyController")
        self._static_plan = None
        self.controller.replan(skew_w=skew_w, reason="serve")
        return self.plan

    def migration_schedule(self) -> List[Dict[str, int]]:
        """Per-offset chunk/bits schedule a cache migration would use
        under the current plan."""
        if self.plan is None:
            raise RuntimeError("no migration plan (pass controller/plan)")
        return offset_schedule(self.plan)

    # ------------------------------------------------------------------
    def _ids(self, logits: torch.Tensor, t0: float, key: str) -> np.ndarray:
        self.last_logits = logits
        ids = logits.argmax(dim=-1).cpu().numpy()
        self.timings[key].append(time.perf_counter() - t0)
        return ids

    @torch.inference_mode()
    def prefill(self, batch_tokens: np.ndarray) -> np.ndarray:
        """Run prefill over a token batch [B,S]; returns next-token
        argmax [B]."""
        t0 = time.perf_counter()
        toks = torch.from_numpy(np.asarray(batch_tokens, np.int64)).to(
            self.device)
        logits, self.cache = self._prefill(self.params, toks)
        self.pos = toks.shape[1]
        return self._ids(logits, t0, "prefill_s")

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray) -> np.ndarray:
        """Advance every slot one step; returns next-token argmax [B]."""
        t0 = time.perf_counter()
        toks = torch.from_numpy(np.asarray(tokens, np.int64)[:, None]).to(
            self.device)
        logits, self.cache = self._decode(self.params, self.cache, toks,
                                          self.pos)
        self.pos += 1
        return self._ids(logits, t0, "decode_s")

    def batch_tokens(self, group: List[Request]) -> np.ndarray:
        """The group's prompts left-padded with token 0 into [batch, S]
        (S the longest prompt; every family reads the pads as tokens, as
        the reference's engine does: the attention attends to them like
        any token at its position)."""
        S = max(len(r.prompt) for r in group)
        toks = np.zeros((self.sc.batch, S), np.int32)
        for gi, r in enumerate(group):
            toks[gi, S - len(r.prompt):] = r.prompt
        return toks

    def serve(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Batched generation over a request list (pads to the engine
        batch; greedy decoding)."""
        out: Dict[int, List[int]] = {}
        B = self.sc.batch
        for i in range(0, len(requests), B):
            group = requests[i:i + B]
            cur = self.prefill(self.batch_tokens(group))
            maxn = max(r.max_new for r in group)
            gen = [[] for _ in range(B)]
            for _ in range(maxn):
                for gi in range(len(group)):
                    gen[gi].append(int(cur[gi]))
                cur = self.decode(cur)
            for gi, r in enumerate(group):
                r.out = gen[gi][:r.max_new]
                r.done = True
                out[r.rid] = r.out
        return out


# ----------------------------------------------------------------------
# Disaggregated serving: migrate a prefill pod's cache to decode pods
# over the WANify-scheduled inter-pod links.
# ----------------------------------------------------------------------
def kv_migrate(cache: Any, plan: WanPlan, src_pod: int, *,
               group: Optional[torch.distributed.ProcessGroup] = None,
               compress: bool = True, tracer: Any = NULL_TRACER) -> Any:
    """Broadcast `cache` (valid on `src_pod`) to every pod of `group`
    (the world by default) with the plan's per-offset chunking and wire
    bits: the port of `repro/serve/engine.py::kv_migrate`, which runs
    inside `shard_map` over the pod axis. Every pod calls it with a cache
    of the same structure and shapes.

    Per leaf and per offset phase o (as the reference): flatten, zero-pad
    to a multiple of the phase's chunks, split, `wire_encode` each part
    (bits from the plan; 32 without `compress`), `compat.ppermute` the
    payload and scale by o, `wire_decode`, concatenate; a pod keeps the
    copy it received iff (rank - o) % P == src_pod. Every pod sends in
    every phase.

    The leaves are the reference's: a model cache in the port's layout
    ({"blocks": [one dict per layer]}, the hybrid's also "shared_attn":
    [one dict per application]) is stacked into the reference's
    {"blocks": {name: [L, ...]}} (and {"shared_attn": {name: [n_apps,
    ...]}}) first (a segment's scale depends on which elements it holds)
    and unstacked after. Any other tree of
    tensors migrates leaf by leaf as it is.

    `tracer` (an `obs.SpanTracer`) records one span "migrate_phase"
    per leaf and offset phase, with the phase's offset, chunks and bits
    as attributes: host wall time, the device not synchronised."""
    P = plan.n_pods
    if P <= 1:
        return cache
    if compat.pod_count(group) != P:
        raise ValueError(f"the plan has {P} pods, the group "
                         f"{compat.pod_count(group)}")
    if not 0 <= src_pod < P:
        raise ValueError(f"src_pod {src_pod} not in [0, {P})")
    sched = offset_schedule(plan)
    rank = compat.pod_index(group)
    layered = isinstance(cache, dict) and \
        isinstance(cache.get("blocks"), list)
    tree = stack_cache(cache) if layered else cache
    bits_of = [ph["bits"] if compress else 32 for ph in sched]

    def leaf(x: torch.Tensor) -> torch.Tensor:
        """Migrate one leaf through the offset phases."""
        out = x
        for ph, bits in zip(sched, bits_of):
            o, chunks = ph["offset"], ph["chunks"]
            with tracer.span("migrate_phase", offset=o, chunks=chunks,
                             bits=bits):
                flat = out.reshape(-1)
                pad = (-flat.numel()) % max(chunks, 1)
                if pad:
                    flat = F.pad(flat, (0, pad))
                parts = flat.chunk(chunks) if chunks > 1 else [flat]
                rec = []
                for part in parts:
                    enc, scale = wire_encode(part, bits)
                    enc_r = compat.ppermute(enc, o, group)
                    s_r = compat.ppermute(scale, o, group) \
                        if scale is not None else None
                    rec.append(wire_decode(enc_r, s_r, x.dtype, bits))
                recv = torch.cat(rec) if chunks > 1 else rec[0]
                recv = recv[:out.numel()].reshape(out.shape)
                if (rank - o) % P == src_pod:
                    out = recv
        return out

    moved = compat.tree_map(leaf, tree)
    return unstack_cache(moved) if layered else moved
