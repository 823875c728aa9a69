"""WANify cross-pod gradient synchronisation.

Port of `repro/core/wansync.py`. The paper's all-to-all shuffle maps
onto a DIRECT (flat) all-reduce over the pods: reduce-scatter +
all-gather built from offset-phase exchanges, so every pod-pair link
carries traffic at once. The heterogeneous "parallel connections" are
per-offset-class chunk multiplicities, and each phase's payload goes
through the wire codec at the bits the predicted link BW affords (SAGQ
analogue). Phase `o` exchanges pod i <-> pod (i+o) % P; on a geo-ring
of pods, offset follows distance (Algorithm 1's closeness classes).

Two formulations, as in the reference:
  * :func:`wan_allreduce` — one process per pod (`compat.run_pods`),
    the exchanges are `compat.ppermute` over a gloo group (the
    reference's `lax.ppermute` inside `shard_map`);
  * :func:`wan_allreduce_batched` — one process holds every pod's
    gradients with an explicit leading pod dim, and `torch.roll` along
    it is the permute (the reference's vmap-over-pods form).
:func:`psum_allreduce` and :func:`psum_allreduce_batched` are the
baselines (one logical all-reduce).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.control.schedule import (offset_schedule, wire_decode,
                                          wire_decode_add, wire_encode)
from repro_torch.core.plan import WanPlan

__all__ = ["wan_allreduce", "psum_allreduce", "wan_allreduce_batched",
           "psum_allreduce_batched"]


# ----------------------------------------------------------------------
# Direct (flat) all-reduce with the WANify schedule — per leaf, one
# process per pod
# ----------------------------------------------------------------------
def _pad_to(x: torch.Tensor, mult: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad axis 0 to a multiple of `mult`."""
    pad = (-x.shape[0]) % mult
    if pad:
        x = F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))
    return x, pad


def _exchange(x: torch.Tensor, offset: int, chunks: int, bits: int,
              dtype: torch.dtype, group,
              acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Send x to pod rank+offset in `chunks` parts along axis 0, each
    through the wire codec, and return what pod rank-offset sent,
    decoded to `dtype`. Given `acc` (x's shape), add it into acc in
    place instead, part by part (`wire_decode_add`: into an f32 acc the
    decode's multiply is fused into the add), and return acc."""
    parts = x.chunk(chunks) if chunks > 1 else [x]
    recvd, start = [], 0
    for part in parts:                            # parallel "connections"
        enc, scale = wire_encode(part, bits)
        enc_r = compat.ppermute(enc, offset, group)
        scale_r = compat.ppermute(scale, offset, group) \
            if scale is not None else None
        if acc is None:
            recvd.append(wire_decode(enc_r, scale_r, dtype, bits))
        else:
            wire_decode_add(acc[start:start + part.shape[0]], enc_r,
                            scale_r, bits)
        start += part.shape[0]
    if acc is not None:
        return acc
    return torch.cat(recvd) if chunks > 1 else recvd[0]


def _leaf_wan_allreduce(g: torch.Tensor, sched: List[Dict[str, int]], P: int,
                        group, rank: int, compress: bool) -> torch.Tensor:
    """Direct all-reduce of one gradient leaf over the pods, segmented
    along axis 0 (the reference's layer-stacked dim). The reduce-scatter
    accumulates in the leaf's dtype, as the reference does under
    `jax.jit`: into an f32 leaf each 8-bit decode's multiply is fused
    into its add; a bf16 leaf's decode and sum are rounded to bf16 at
    each phase.

    One exception, also the reference's: XLA on the CPU computes a bf16
    sum in f32 and drops the rounding of a result that is widened to
    f32 right away (an f32 -> bf16 -> f32 pair with nothing between).
    The all-gather's int8 encode of the whole segment (one chunk) widens
    the last reduce-scatter sum so, and reads it unrounded; a phase of
    several chunks slices the rounded sum first. The port keeps that
    sum in f32 (`wide`) and encodes such phases from it."""
    orig_shape, orig_dtype = g.shape, g.dtype
    if g.dim() == 0:
        g = g[None]
    cmax = max(ph["chunks"] for ph in sched) if sched else 1
    g, pad = _pad_to(g, P * cmax)
    seg = g.shape[0] // P

    def segment(idx: int) -> torch.Tensor:
        return g[idx * seg:(idx + 1) * seg]

    def whole_int8(ph) -> bool:
        return compress and ph["bits"] <= 8 and ph["chunks"] == 1

    keep_wide = g.dtype == torch.bfloat16 and any(map(whole_int8, sched))
    # reduce-scatter: pod r reduces segment r; phase o sends segment
    # (rank + o) % P to pod rank + o
    acc, wide = segment(rank).clone(), None
    for i, ph in enumerate(sched):
        bits = ph["bits"] if compress else 32
        send = segment((rank + ph["offset"]) % P)
        if keep_wide and i == len(sched) - 1:
            got = _exchange(send, ph["offset"], ph["chunks"], bits, g.dtype,
                            group)
            wide = acc.float() + got.float()
            acc = wide.to(g.dtype)
        else:
            _exchange(send, ph["offset"], ph["chunks"], bits, g.dtype, group,
                      acc=acc)
    # all-gather: phase o delivers pod (rank - o)'s reduced segment
    gathered = {0: acc}
    for ph in sched:
        bits = ph["bits"] if compress else 32
        src = wide if keep_wide and whole_int8(ph) else acc
        gathered[ph["offset"]] = _exchange(src, ph["offset"], ph["chunks"],
                                           bits, g.dtype, group)
    # [gathered[0], gathered[P-1], ..., gathered[1]] lays the segments
    # out as [rank, rank+1, ..., rank+P-1]; a roll by rank*seg rotates
    # them into absolute order
    ordered = [gathered[0]] + [gathered[o] for o in range(P - 1, 0, -1)]
    out = torch.roll(torch.cat(ordered), shifts=rank * seg, dims=0)
    if pad:
        out = out[:orig_shape[0] if len(orig_shape) else 1]
    return out.reshape(orig_shape).to(orig_dtype)


def wan_allreduce(tree: Any, plan: WanPlan, *,
                  group: Optional[dist.ProcessGroup] = None,
                  compress: bool = False, mean: bool = True) -> Any:
    """WANify-scheduled all-reduce of a tree of tensors over the pods of
    `group` (the world by default); every pod calls it with a tree of
    the same shapes."""
    P = plan.n_pods
    if P <= 1:
        return tree
    if compat.pod_count(group) != P:
        raise ValueError(f"the plan has {P} pods, the group "
                         f"{compat.pod_count(group)}")
    sched = offset_schedule(plan)
    rank = compat.pod_index(group)

    def per_leaf(g: torch.Tensor) -> torch.Tensor:
        out = _leaf_wan_allreduce(g, sched, P, group, rank, compress)
        return out * (1.0 / P) if mean else out

    return compat.tree_map(per_leaf, tree)


def psum_allreduce(tree: Any, *, group: Optional[dist.ProcessGroup] = None,
                   mean: bool = True) -> Any:
    """Baseline: one all-reduce per leaf (the paper's 'vanilla'
    transfer). The pods' leaves are gathered through host memory (the
    transport of `compat.ppermute`) and summed on the leaf's device in
    pod order, so every pod holds the same bits. That is the order of
    the reference's all-reduce on XLA's CPU runtime, which also adds a
    leaf narrower than f32 (bf16) in f32 and rounds the sum once, at
    the end; the port does the same."""
    n = compat.pod_count(group)

    def per_leaf(g: torch.Tensor) -> torch.Tensor:
        send = g.detach().to("cpu").contiguous()
        got = [torch.empty_like(send) for _ in range(n)]
        dist.all_gather(got, send, group=group)
        wide = torch.promote_types(g.dtype, torch.float32) \
            if g.is_floating_point() else g.dtype
        s = got[0].to(g.device, wide)
        for part in got[1:]:
            s = s + part.to(g.device, wide)
        s = s.to(g.dtype)
        # the reference's `s / n`, as XLA computes a divide by a constant
        return s * (1.0 / n) if mean else s

    return compat.tree_map(per_leaf, tree)


# ----------------------------------------------------------------------
# Batched formulation: a leading pod dim, torch.roll as the permute
# ----------------------------------------------------------------------
def wan_allreduce_batched(tree: Any, plan: WanPlan, *,
                          compress: bool = False, mean: bool = True) -> Any:
    """tree leaves: [P, ...] per-pod values. Returns the synchronised
    tree, every pod slice holding the sum (or mean).

    Phase o rolls pod p's contribution to pod p+o; a leaf whose axis 1
    the phase's chunks divide is split into that many parts along it,
    each encoded in place (a [P, L] view, no copy) with one scale per
    pod slice. The
    sums run in f32 only when a phase is lossy (compress with bits <
    32), as the reference's do, and each decode's multiply is fused into
    its add (`wire_decode_add`), as XLA fuses the reference's. Unlike
    the reference, the port adds each received part into one accumulator
    in place (the same additions in the same order), so a leaf costs one
    extra copy and a part's worth of codec buffers instead of all of a
    phase's at once."""
    P = plan.n_pods
    if P <= 1:
        return tree
    sched = offset_schedule(plan)
    out_scale = 1.0 / P if mean else 1.0
    any_lossy = compress and any(ph["bits"] < 32 for ph in sched)

    def per_leaf(g: torch.Tensor) -> torch.Tensor:
        acc = g.to(torch.float32 if any_lossy else g.dtype, copy=True)
        for ph in sched:
            o, chunks = ph["offset"], ph["chunks"]
            bits = ph["bits"] if compress else 32
            split = g.dim() > 1 and chunks > 1 and g.shape[1] % chunks == 0
            width = g.shape[1] // chunks if split else None
            for j in range(chunks if split else 1):
                # read in place: a slice along axis 1 views as [P, L]
                part = g[:, j * width:(j + 1) * width] if split else g
                # per-pod-slice scales, rolled along with the payload
                enc, scl = wire_encode(part, bits,
                                       axes=tuple(range(1, part.dim())))
                enc_r = torch.roll(enc, o, 0)
                scl_r = torch.roll(scl, o, 0) if scl is not None else None
                wire_decode_add(acc[:, j * width:(j + 1) * width] if split
                                else acc, enc_r, scl_r, bits)
        return acc.mul_(out_scale).to(g.dtype)

    return compat.tree_map(per_leaf, tree)


def psum_allreduce_batched(tree: Any, n_pods: int, *, mean: bool = True
                           ) -> Any:
    """Baseline in the batched formulation: the sum (or mean) over the
    pod dim, broadcast back (a view, as `torch.broadcast_to` gives)."""
    def per_leaf(g: torch.Tensor) -> torch.Tensor:
        s = g.sum(dim=0, keepdim=True)
        if mean:
            s = s * (1.0 / n_pods)   # the reference's `s / n_pods` under XLA
        return torch.broadcast_to(s, g.shape).to(g.dtype)

    return compat.tree_map(per_leaf, tree)
