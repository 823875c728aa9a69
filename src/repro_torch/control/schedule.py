"""Plan -> wire lowering: the per-offset schedule and the wire codec.

Port of `repro/control/schedule.py`. Every path that moves bytes
between pods (`serve/engine.py::kv_migrate`, `core/wansync.py`) lowers
a `WanPlan` to the same two primitives:

  * :func:`offset_schedule` — per offset class (pod ``i <-> (i+o) % P``,
    the paper's closeness classes on a geo-ring), the chunk
    multiplicity (heterogeneous parallel connections) and the wire bits
    (from the weakest predicted link in the class).
  * :func:`wire_encode` / :func:`wire_decode` — the quantizing wire
    codec. At 8 bits and below it runs on the quantize / dequantize
    kernels' grouped form (`kernels/ops.py::quantize_groups`), bit-equal
    to the reference's codec under `jax.jit`. :func:`wire_decode_add`
    decodes straight into an f32 accumulator, the multiply fused into
    the add, as XLA fuses the reference's `acc + decode(...)`.

``pick_bits`` (the BW -> bits policy) is re-exported from
``core/plan.py`` so consumers need only this module.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.plan import WanPlan, pick_bits
from repro_torch.kernels import ops

__all__ = ["offset_schedule", "wire_encode", "wire_decode",
           "wire_decode_add", "pick_bits", "MAX_CHUNKS"]

MAX_CHUNKS = 16


def offset_schedule(plan: WanPlan) -> List[Dict[str, int]]:
    """For each offset o in [1, P-1]: chunk multiplicity (max conns over
    the pairs in that class — the WANify heterogeneous connections) and
    wire bits (from the weakest predicted link in the class)."""
    P = plan.n_pods
    bits = plan.offset_bits()      # part of plan.signature(): replans
    sched = []                     # with equal signatures lower equally
    for o in range(1, P):
        conns = max(plan.conns[i][(i + o) % P] for i in range(P))
        # round to a power of two so chunk splits always divide segments
        chunks = 1 << max(0, int(np.ceil(np.log2(max(1, int(conns))))))
        sched.append({"offset": o, "chunks": min(chunks, MAX_CHUNKS),
                      "bits": bits[o - 1]})
    return sched


# ----------------------------------------------------------------------
# Wire codec (segment-scalar or per-slice scale)
# ----------------------------------------------------------------------
def _groups(x: torch.Tensor, axes: Optional[Tuple[int, ...]]) -> int:
    """The number of scales: 1 for axes=None, the leading dim for
    axes = (1, ..., ndim-1)."""
    if axes is None:
        return 1
    if tuple(axes) != tuple(range(1, x.dim())):
        raise ValueError(f"axes must be None or {tuple(range(1, x.dim()))} "
                         f"(one scale per leading index), got {axes}")
    return x.shape[0] if x.dim() else 1


def _rows(x: torch.Tensor, G: int) -> torch.Tensor:
    """x as [G, L] rows with unit column stride: a view of x where one
    exists (a contiguous tensor, a slice of one along axis 0 or 1), so
    the kernel reads x in place; else a contiguous copy."""
    try:
        x2 = x.view(G, -1)
    except RuntimeError:
        return x.contiguous().view(G, -1)
    L = x2.shape[1]
    if (L > 1 and x2.stride(1) != 1) or (G > 1 and x2.stride(0) < L):
        return x.contiguous().view(G, -1)
    return x2


def wire_encode(x: torch.Tensor, bits: int,
                axes: Optional[Tuple[int, ...]] = None):
    """Quantize `x` for the wire. Returns (payload, scale-or-None).

    bits >= 32 is the identity and bits 16 a cast to bf16, both without
    a scale. At 8 bits and below (int8 payload):
    axes=None            -> one 0-d f32 scale over the whole segment;
    axes=(1, ..., ndim-1) -> one scale per leading index, keepdims
                            ([G, 1, ...]: per pod slice).
    `x` is read in place where it views as [G, L] (`_rows`); the
    payload is contiguous.
    """
    if bits >= 32:
        return x, None
    if bits == 16:
        return x.to(torch.bfloat16), None
    q, scale = ops.quantize_groups(_rows(x, _groups(x, axes)), bits)
    keep = () if axes is None else x.shape[:1] + (1,) * (x.dim() - 1)
    return q.reshape(x.shape), scale.reshape(keep)


def _payload_groups(q: torch.Tensor, scale: torch.Tensor):
    """q as [G, L] and scale as [G], G scales (scalar and per-slice
    scales share one decode path)."""
    G = scale.numel()
    if scale.dim() and tuple(scale.shape) != \
            q.shape[:1] + (1,) * (q.dim() - 1):
        raise ValueError(f"scale {tuple(scale.shape)} is neither 0-d nor "
                         f"one per leading index of q {tuple(q.shape)}")
    return q.contiguous().reshape(G, -1), scale.reshape(G).contiguous()


def wire_decode(q: torch.Tensor, scale: Optional[torch.Tensor],
                dtype: torch.dtype, bits: int) -> torch.Tensor:
    """Inverse of :func:`wire_encode`: f32(q) * scale, cast to
    `dtype`."""
    if bits >= 32:
        return q
    if bits == 16:
        return q.to(dtype)
    return ops.dequantize_groups(*_payload_groups(q, scale),
                                 dtype).reshape(q.shape)


def wire_decode_add(acc: torch.Tensor, q: torch.Tensor,
                    scale: Optional[torch.Tensor], bits: int
                    ) -> torch.Tensor:
    """acc += wire_decode(q, scale, acc.dtype, bits), in place, for an
    `acc` of q's shape. Into an f32 acc at 8 bits and below, the
    decode's multiply is fused into the add with one rounding
    (`ops.dequantize_groups_add`; acc must `view` as [scales, -1]: a
    contiguous tensor, or a slice of one along axis 0 or 1). Otherwise
    the decode is rounded to acc's dtype, then the add. Returns acc."""
    if bits > 8 or acc.dtype != torch.float32:
        return acc.add_(wire_decode(q, scale, acc.dtype, bits))
    q2, scale1 = _payload_groups(q, scale)
    # a view (never a copy): the kernel adds into acc's own storage
    ops.dequantize_groups_add(q2, scale1, acc.view(q2.shape))
    return acc
