"""Public wrappers of the port's kernels.

Each wrapper checks device, type, shape and layout (contiguity, or the
strides of a [G, L] row view), and raises on anything its kernel does
not take. It runs the plain version
(`ref.py`) only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises — there is no fallback. Each keeps a plain
integer count of kernel launches (`<wrapper>.launches`), which a run
reads to show that its main path went through the kernel. The quantize
kernel's two forms (per tile, per group) share `quantize.launches`, and
the dequantize kernel's share `dequantize.launches`; `silu`,
`silu_gate` and `silu_gate_bwd` count their own, and so does
`fill_rates`, `flash_fwd` (MLA's form, `flash_fwd_mla`, counts there
too) and `flash_bwd` (one count a call, though the backward runs two
kernels in bf16, dq with delta and dk / dv, and three in f32), and
`ssd_chunk_bwd` (four kernels, one count), `silu_bwd`,
`silu_gate_prod_bwd`, `moe_slots`, `moe_dispatch`, `moe_combine` and
the MoE backwards `moe_dispatch_bwd`, `moe_combine_bwd` and
`moe_gates_bwd`.

Six ops have a gradient (each a `torch.autograd.Function` whose
forward is the forward kernel and whose backward is a backward kernel):
:func:`swiglu_gate`, the SwiGLU gate (:func:`silu_gate`'s value;
backward :func:`silu_gate_bwd`); the Mamba-2 block's three, named
`<op>_ad` (autodiff): :func:`ssd_chunk_ad` (backward
:func:`ssd_chunk_bwd`), :func:`silu_ad` (:func:`silu_bwd`) and
:func:`silu_gate_ad` (:func:`silu_gate_prod_bwd`); and the MoE layer's
two: :func:`moe_dispatch_ad` (:func:`moe_dispatch_bwd`) and
:func:`moe_combine_ad` (:func:`moe_combine_bwd` and
:func:`moe_gates_bwd`). Where no input needs a gradient (serving,
under `torch.inference_mode`) the `_ad` ops call the forward wrapper
directly: the serve path launches what it launched before, and its
decode step, bound by the host's issue, pays no Function's per-call
cost (3 calls a layer).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash as _flash
from repro_torch.kernels import moe as _moe
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import rf_predict as _rf
from repro_torch.kernels import silu as _silu
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import waterfill as _wf
from repro_torch.kernels.ref import (dequantize_groups_add_ref,
                                     dequantize_groups_ref, dequantize_ref,
                                     fill_rates_ref, flash_bwd_mla_ref,
                                     flash_bwd_ref, flash_fwd_mla_ref,
                                     flash_fwd_ref,
                                     moe_combine_bwd_ref,
                                     moe_combine_ref, moe_dispatch_bwd_ref,
                                     moe_dispatch_gather_ref,
                                     moe_gates_bwd_ref, moe_slots_ref,
                                     quantize_groups_ref,
                                     quantize_ref, rf_predict_ref,
                                     silu_bwd_ref, silu_gate_bwd_ref,
                                     silu_gate_prod_bwd_ref, silu_gate_ref,
                                     silu_ref, ssd_chunk_bwd_ref,
                                     ssd_chunk_ref)


def _check_rf(feat, thr, leaf, X, depth) -> None:
    tensors = {"feat": feat, "thr": thr, "leaf": leaf, "X": X}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != X.device:
            raise ValueError(f"{name} on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    want = {"feat": torch.int32, "thr": torch.float32,
            "leaf": torch.float32, "X": torch.float32}
    for name, dt in want.items():
        if tensors[name].dtype != dt:
            raise TypeError(f"{name} must be {dt}, got "
                            f"{tensors[name].dtype}")
    if not 1 <= int(depth) <= 24:
        raise ValueError(f"depth must be in [1, 24], got {depth}")
    n_int = 2 ** int(depth) - 1
    if feat.dim() != 2 or feat.shape[0] < 1 or feat.shape[1] != n_int:
        raise ValueError(f"feat must be [T, {n_int}], got "
                         f"{tuple(feat.shape)}")
    T = feat.shape[0]
    if tuple(thr.shape) != (T, n_int):
        raise ValueError(f"thr must be [{T}, {n_int}], got "
                         f"{tuple(thr.shape)}")
    if tuple(leaf.shape) != (T, n_int + 1):
        raise ValueError(f"leaf must be [{T}, {n_int + 1}], got "
                         f"{tuple(leaf.shape)}")
    if X.dim() != 2 or X.shape[1] < 1:
        raise ValueError(f"X must be [n, F], got {tuple(X.shape)}")


def _check_nodes(nodes, feat) -> None:
    if not isinstance(nodes, torch.Tensor):
        raise TypeError("nodes must be a torch.Tensor")
    if nodes.device != feat.device:
        raise ValueError(f"nodes on {nodes.device}, feat on {feat.device}")
    if nodes.dtype != torch.int32 or \
            tuple(nodes.shape) != (*feat.shape, 2):
        raise ValueError(f"nodes must be int32 [{feat.shape[0]}, "
                         f"{feat.shape[1]}, 2] (rf_predict.pack_nodes), got "
                         f"{nodes.dtype} {tuple(nodes.shape)}")
    if not nodes.is_contiguous() or nodes.data_ptr() % 8:
        raise ValueError("nodes must be contiguous and 8-byte aligned")


def rf_predict(feat: torch.Tensor, thr: torch.Tensor, leaf: torch.Tensor,
               X: torch.Tensor, depth: int,
               nodes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forest inference over packed trees: X [n, F] -> [n] f32.

    CUDA tensors go to the hand-written kernel (csrc/rf_predict.cu),
    one launch a call; CPU tensors to
    :func:`repro_torch.kernels.ref.rf_predict_ref`. Both sum the trees
    in tree order in f32 and multiply by the f32 reciprocal of T,
    bit-equal to the JAX package's `rf_predict`. The kernel reads the
    nodes as `rf_predict.pack_nodes(feat, thr)` lays them out: pass
    that as `nodes` to keep the packing out of the call (the
    predictors hold it beside the forest); without it the call packs
    first. `nodes` must be `pack_nodes` of these same `feat` and `thr`:
    the card reads only `nodes` and the CPU only `feat` / `thr`, and a
    `nodes` left from another forest of the same shape is not
    detected (only its dtype, shape, device and alignment are checked).
    Whoever refits the forest packs it again, as
    `BwPredictor.forest_on` does."""
    _check_rf(feat, thr, leaf, X, depth)
    if nodes is not None:
        _check_nodes(nodes, feat)
    if X.device.type == "cpu":
        return rf_predict_ref(feat, thr, leaf, X, int(depth))
    if X.device.type != "cuda":
        raise ValueError(f"rf_predict runs on cuda or cpu, not {X.device}")
    out = torch.empty(X.shape[0], dtype=torch.float32, device=X.device)
    if X.shape[0] == 0:
        return out
    if nodes is None:
        nodes = _rf.pack_nodes(feat, thr)
    _rf.launch(nodes, leaf, X, out, int(depth))
    rf_predict.launches += 1
    return out


rf_predict.launches = 0


def _check_ssd(xq, Bq, Cq, da) -> None:
    tensors = {"xq": xq, "Bq": Bq, "Cq": Cq, "da": da}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != xq.device:
            raise ValueError(f"{name} on {t.device}, xq on {xq.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xq.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"xq must be bfloat16 or float32, got {xq.dtype}")
    for name in ("Bq", "Cq"):
        if tensors[name].dtype != xq.dtype:
            raise TypeError(f"{name} must be {xq.dtype} like xq, got "
                            f"{tensors[name].dtype}")
    if da.dtype != torch.float32:
        raise TypeError(f"da must be float32, got {da.dtype}")
    if xq.dim() != 5 or min(xq.shape) < 1:
        raise ValueError(f"xq must be [B,nC,Q,H,P] with no empty dim, got "
                         f"{tuple(xq.shape)}")
    B, nC, Q, H, P = xq.shape
    if Bq.dim() != 4 or tuple(Bq.shape[:3]) != (B, nC, Q) or \
            Bq.shape[3] < 1:
        raise ValueError(f"Bq must be [{B},{nC},{Q},N], got "
                         f"{tuple(Bq.shape)}")
    if tuple(Cq.shape) != tuple(Bq.shape):
        raise ValueError(f"Cq must be {tuple(Bq.shape)} like Bq, got "
                         f"{tuple(Cq.shape)}")
    if tuple(da.shape) != (B, nC, H, Q):
        raise ValueError(f"da must be [{B},{nC},{H},{Q}], got "
                         f"{tuple(da.shape)}")
    N = Bq.shape[3]
    if P > _ssd.MAX_P or N > _ssd.MAX_N or Q > _ssd.MAX_Q or \
            H > _ssd.MAX_HEADS or B * nC >= 2 ** 31:
        raise ValueError(f"ssd_chunk takes P <= {_ssd.MAX_P}, N <= "
                         f"{_ssd.MAX_N}, Q <= {_ssd.MAX_Q}, H <= "
                         f"{_ssd.MAX_HEADS}; got P={P}, N={N}, Q={Q}, "
                         f"H={H}")


def ssd_chunk(xq: torch.Tensor, Bq: torch.Tensor, Cq: torch.Tensor,
              da: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD within each chunk: xq [B,nC,Q,H,P] (pre-multiplied by
    dt), Bq/Cq [B,nC,Q,N] (all bf16 or all f32), da [B,nC,H,Q] f32 ->
    (y_diag [B,nC,Q,H,P] f32, states [B,nC,H,P,N] f32).

    CUDA tensors go to the hand-written kernel (csrc/ssd_chunk.cu);
    CPU tensors to :func:`repro_torch.kernels.ref.ssd_chunk_ref`. Both
    compute in f32 from the stored dtype, as the JAX package's
    `ssd_chunk` does; they sum in different orders."""
    _check_ssd(xq, Bq, Cq, da)
    if xq.device.type == "cpu":
        return ssd_chunk_ref(xq, Bq, Cq, da)
    if xq.device.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cuda or cpu, not {xq.device}")
    B, nC, Q, H, P = xq.shape
    y = torch.empty(xq.shape, dtype=torch.float32, device=xq.device)
    st = torch.empty((B, nC, H, P, Bq.shape[3]), dtype=torch.float32,
                     device=xq.device)
    _ssd.launch(xq, Bq, Cq, da, y, st)
    ssd_chunk.launches += 1
    return y, st


ssd_chunk.launches = 0


def ssd_chunk_bwd(xq: torch.Tensor, Bq: torch.Tensor, Cq: torch.Tensor,
                  da: torch.Tensor, dy: torch.Tensor, dst: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The gradient of :func:`ssd_chunk` given the cotangents dy
    [B,nC,Q,H,P] of y_diag and dst [B,nC,H,P,N] of the states (both f32,
    contiguous) -> (dx, dB, dC in the inputs' dtype, dda
    [B,nC,H,Q] f32), the decay mask and C B^T recomputed.

    CUDA tensors go to the hand-written kernels (csrc/ssd_chunk.cu; bf16:
    wgmma items that keep the heads' sums on chip, the fixed-order sums
    over head groups and dda, dB / dC; f32: four CUDA-core kernels; one
    count a call); CPU tensors to
    :func:`repro_torch.kernels.ref.ssd_chunk_bwd_ref`. Both take the
    cumulative decay and the reverse cumulative sum of dda in the same
    order (`chunk_cumsum`); the products add in other orders. Two calls
    on the same inputs give the same bits (no atomics)."""
    _check_ssd(xq, Bq, Cq, da)
    B, nC, Q, H, P = xq.shape
    want = {"dy": (dy, (B, nC, Q, H, P)),
            "dst": (dst, (B, nC, H, P, Bq.shape[3]))}
    for name, (t, shape) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != xq.device:
            raise ValueError(f"{name} on {t.device}, xq on {xq.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xq.device.type == "cpu":
        return ssd_chunk_bwd_ref(xq, Bq, Cq, da, dy, dst)
    if xq.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd runs on cuda or cpu, not "
                         f"{xq.device}")
    dx = torch.empty(xq.shape, dtype=xq.dtype, device=xq.device)
    dB = torch.empty(Bq.shape, dtype=Bq.dtype, device=xq.device)
    dC = torch.empty(Cq.shape, dtype=Cq.dtype, device=xq.device)
    dda = torch.empty(da.shape, dtype=torch.float32, device=xq.device)
    _ssd.launch_bwd(xq, Bq, Cq, da, dy, dst, dx, dB, dC, dda)
    ssd_chunk_bwd.launches += 1
    return dx, dB, dC, dda


ssd_chunk_bwd.launches = 0


class _SsdChunk(torch.autograd.Function):
    """:func:`ssd_chunk` with a gradient: backward :func:`ssd_chunk_bwd`
    on the saved inputs (the decay mask and C B^T recomputed)."""

    @staticmethod
    def forward(ctx, xq, Bq, Cq, da):
        y, st = ssd_chunk(xq, Bq, Cq, da)
        ctx.save_for_backward(xq, Bq, Cq, da)
        return y, st

    @staticmethod
    def backward(ctx, dy, dst):
        return ssd_chunk_bwd(*ctx.saved_tensors, dy.contiguous(),
                             dst.contiguous())


def ssd_chunk_ad(xq: torch.Tensor, Bq: torch.Tensor, Cq: torch.Tensor,
                 da: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_chunk` as a differentiable op: its gradient is
    :func:`ssd_chunk_bwd`, the kernel on the card."""
    return _SsdChunk.apply(xq, Bq, Cq, da)


# ----------------------------------------------------------------------
# SiLU gates
# ----------------------------------------------------------------------
def _check_gate_input(name: str, t):
    """t a float32 / bfloat16 tensor on cuda or cpu whose leading dims
    collapse into rows; returns its row view."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype not in _silu.DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not (t.is_cuda or t.is_cpu):
        raise ValueError(f"silu runs on cuda or cpu, not {t.device}")
    return _silu.row_view(t)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), each op of 1 / (1 + exp(-x)) rounded to x's dtype
    (f32 or bf16), as XLA on the CPU computes the JAX package's
    `jax.nn.silu` -> a dense tensor of x's shape and dtype. x may be a
    strided view (:func:`repro_torch.kernels.silu.row_view`).

    CUDA tensors go to the hand-written kernel (csrc/silu.cu, one
    launch); CPU tensors to :func:`repro_torch.kernels.ref.silu_ref`,
    which it equals bit for bit."""
    view = _check_gate_input("x", x)
    if x.is_cpu:
        return silu_ref(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel():
        _silu.launch(x, out, view)
        silu.launches += 1
    return out


silu.launches = 0


def silu_bwd(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`silu` given its cotangent g: g and x of
    one shape and dtype (f32 or bf16), either may be a strided view ->
    dx, dense, in x's dtype, each op rounded where XLA's CPU program for
    the jitted `jax.vjp(jax.nn.silu)` rounds it (:func:`silu_gate_bwd`'s
    dz with y = 1).

    CUDA tensors go to the hand-written kernel (csrc/silu.cu, one
    launch of `silu_bwd_kernel`); CPU tensors to
    :func:`repro_torch.kernels.ref.silu_bwd_ref`, which it equals bit
    for bit."""
    views = (_check_gate_input("g", g), _check_gate_input("x", x))
    if g.dtype != x.dtype or g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must match x: got {g.dtype} {tuple(g.shape)} "
                         f"on {g.device}, x {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    if x.is_cpu:
        return silu_bwd_ref(g, x)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if dx.numel():
        _silu.launch_bwd(g, x, dx, views)
        silu_bwd.launches += 1
    return dx


silu_bwd.launches = 0


class _Silu(torch.autograd.Function):
    """:func:`silu` with a gradient: backward :func:`silu_bwd` on the
    saved x."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return silu(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return silu_bwd(g.contiguous(), x)


def silu_ad(x: torch.Tensor) -> torch.Tensor:
    """:func:`silu` as a differentiable op: its gradient is
    :func:`silu_bwd`, the kernel on the card."""
    return _Silu.apply(x)


def silu_gate(y: torch.Tensor, z: torch.Tensor, with_prod: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The input of Mamba-2's gated norm `rms_norm(y * silu(z))`: y and z
    of one shape and dtype (f32 or bf16), either a strided view -> (y *
    silu(z) rounded to y's dtype, the same product in f32), both dense;
    silu as :func:`silu` rounds it, the product taken in f32. With
    `with_prod=False` the f32 product is neither stored nor returned
    (None): the SwiGLU MLP reads the value only.

    CUDA tensors go to the hand-written kernel (csrc/silu.cu, one
    launch); CPU tensors to
    :func:`repro_torch.kernels.ref.silu_gate_ref`, which it equals bit
    for bit."""
    views = (_check_gate_input("y", y), _check_gate_input("z", z))
    if z.dtype != y.dtype or z.shape != y.shape or z.device != y.device:
        raise ValueError(f"z must match y: got {z.dtype} {tuple(z.shape)} "
                         f"on {z.device}, y {y.dtype} {tuple(y.shape)} on "
                         f"{y.device}")
    if y.is_cpu:
        value, prod = silu_gate_ref(y, z)
        return value, prod if with_prod else None
    value = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    prod = torch.empty(y.shape, dtype=torch.float32,
                       device=y.device) if with_prod else None
    if value.numel():
        _silu.launch_gate(y, z, value, prod, views)
        silu_gate.launches += 1
    return value, prod


silu_gate.launches = 0


def silu_gate_bwd(g: torch.Tensor, y: torch.Tensor, z: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of the SwiGLU gate's value silu(z) * y (the value
    :func:`silu_gate` returns) given its cotangent g: g, y, z of one
    shape and dtype (f32 or bf16), each may be a strided view -> (dy,
    dz), dense, in y's dtype, each op rounded where XLA's CPU program
    for the reference's gradient rounds it.

    CUDA tensors go to the hand-written kernel (csrc/silu.cu, one
    launch); CPU tensors to :func:`repro_torch.kernels.ref.
    silu_gate_bwd_ref`, which it equals bit for bit."""
    views = tuple(_check_gate_input(n, t) for n, t in
                  (("g", g), ("y", y), ("z", z)))
    for name, t in (("g", g), ("z", z)):
        if t.dtype != y.dtype or t.shape != y.shape or t.device != y.device:
            raise ValueError(f"{name} must match y: got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, y {y.dtype} "
                             f"{tuple(y.shape)} on {y.device}")
    if y.is_cpu:
        return silu_gate_bwd_ref(g, y, z)
    dy = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    dz = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    if dy.numel():
        _silu.launch_gate_bwd(g, y, z, dy, dz, views)
        silu_gate_bwd.launches += 1
    return dy, dz


silu_gate_bwd.launches = 0


def silu_gate_prod_bwd(g_value: torch.Tensor, g_prod: torch.Tensor,
                       y: torch.Tensor, z: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`silu_gate`'s two outputs (Mamba-2's gated
    norm) given their cotangents: g_value of the value (y's dtype),
    g_prod of the f32 product (f32), y and z of one shape and dtype
    (f32 or bf16), each may be a strided view -> (dy, dz), dense, in y's
    dtype. The product's cotangent is g_value + g_prod, g_prod rounded
    to y's dtype first and the sum rounded, as XLA's compiled gradient
    of the reference's `rms_norm(y * silu(z))` adds the variance path's
    to the value path's; from there on as :func:`silu_gate_bwd`.

    CUDA tensors go to the hand-written kernel (csrc/silu.cu, one
    launch of the gate's backward kernel with the f32 cotangent); CPU
    tensors to :func:`repro_torch.kernels.ref.silu_gate_prod_bwd_ref`,
    which it equals bit for bit."""
    views = tuple(_check_gate_input(n, t) for n, t in
                  (("g_value", g_value), ("y", y), ("z", z)))
    for name, t in (("g_value", g_value), ("z", z)):
        if t.dtype != y.dtype or t.shape != y.shape or t.device != y.device:
            raise ValueError(f"{name} must match y: got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, y {y.dtype} "
                             f"{tuple(y.shape)} on {y.device}")
    if not isinstance(g_prod, torch.Tensor) or \
            g_prod.dtype != torch.float32 or g_prod.shape != y.shape or \
            g_prod.device != y.device or not g_prod.is_contiguous():
        raise ValueError(f"g_prod must be a contiguous float32 tensor of "
                         f"y's shape {tuple(y.shape)} on {y.device}")
    if y.is_cpu:
        return silu_gate_prod_bwd_ref(g_value, g_prod, y, z)
    dy = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    dz = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    if dy.numel():
        _silu.launch_gate_bwd(g_value, y, z, dy, dz, views, g_prod=g_prod)
        silu_gate_prod_bwd.launches += 1
    return dy, dz


silu_gate_prod_bwd.launches = 0


class _SwigluGate(torch.autograd.Function):
    """silu(z) * y with a gradient: forward :func:`silu_gate` (value
    only), backward :func:`silu_gate_bwd` on the saved y and z."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        value, _ = silu_gate(y, z, with_prod=False)
        ctx.save_for_backward(y, z)
        return value

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        y, z = ctx.saved_tensors
        return silu_gate_bwd(g.contiguous(), y, z)


def swiglu_gate(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The SwiGLU gate's value silu(z) * y (:func:`silu_gate` with
    `with_prod=False`) as a differentiable op: its gradient is
    :func:`silu_gate_bwd`, the kernel on the card. Where neither input
    needs a gradient it is the forward wrapper's call itself."""
    if not _needs_grad(y, z):
        return silu_gate(y, z, with_prod=False)[0]
    return _SwigluGate.apply(y, z)


class _SsmGate(torch.autograd.Function):
    """:func:`silu_gate` (value and f32 product) with a gradient:
    backward :func:`silu_gate_prod_bwd` on the saved y and z, given
    both outputs' cotangents."""

    @staticmethod
    def forward(ctx, y, z):
        value, prod = silu_gate(y, z)
        ctx.save_for_backward(y, z)
        # in f32 the plain version's value is its product itself
        return (value.clone() if value is prod else value), prod

    @staticmethod
    def backward(ctx, g_value, g_prod):
        y, z = ctx.saved_tensors
        return silu_gate_prod_bwd(g_value.contiguous(), g_prod.contiguous(),
                                  y, z)


def silu_gate_ad(y: torch.Tensor, z: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`silu_gate` (with its f32 product) as a differentiable op:
    its gradient is :func:`silu_gate_prod_bwd`, the kernel on the
    card."""
    return _SsmGate.apply(y, z)


# ----------------------------------------------------------------------
# quantize / dequantize
# ----------------------------------------------------------------------
_FLOATS = (torch.float32, torch.bfloat16)


def _check_tensors(dtypes, contiguous: bool = True, **tensors
                   ) -> torch.device:
    """Each a torch.Tensor of its dtype(s), contiguous unless told
    otherwise, all on one device, on cuda or cpu. Returns the device."""
    dev = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        dev = t.device if dev is None else dev
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, not {dev} like the "
                             f"first input")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype not in dtypes[name]:
            raise TypeError(f"{name} must be one of {dtypes[name]}, got "
                            f"{t.dtype}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the quantize kernels run on cuda or cpu, not "
                         f"{dev}")
    return dev


def _check_bits(bits: int) -> int:
    if int(bits) not in _q.BITS:
        raise ValueError(f"bits must be in [{_q.BITS.start}, "
                         f"{_q.BITS.stop - 1}] (an int8 payload), got {bits}")
    return int(bits)


def _check_out_dtype(dtype) -> None:
    if dtype not in _FLOATS:
        raise TypeError(f"out_dtype must be one of {_FLOATS}, got {dtype}")


def _check_tiles(x: torch.Tensor, block: int) -> Tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"expected [n, d], got {tuple(x.shape)}")
    n, d = x.shape
    if block < 1 or n < 1 or d < 1 or n % block or d % block:
        raise ValueError(f"n and d must be positive multiples of block="
                         f"{block}, got {tuple(x.shape)}")
    if n // block > _q.MAX_GROUPS:
        raise ValueError(f"at most {_q.MAX_GROUPS} tile rows, got "
                         f"{n // block}")
    return n // block, d // block


def quantize(x: torch.Tensor, bits: int = 8, block: int = _q.BLOCK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-symmetric quantize x [n, d] (f32 or bf16; n, d multiples of
    block) -> (q int8 [n, d], scale f32 [n/block, d/block]).

    CUDA tensors go to the hand-written kernel (csrc/quantize.cu); CPU
    tensors to :func:`repro_torch.kernels.ref.quantize_ref`. Both are
    bit-equal to the JAX package's `quantize_pallas`."""
    dev = _check_tensors({"x": _FLOATS}, x=x)
    bits = _check_bits(bits)
    grid = _check_tiles(x, int(block))
    if dev.type == "cpu":
        return quantize_ref(x, bits, int(block))
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    scale = torch.empty(grid, dtype=torch.float32, device=dev)
    _q.launch_tile(x, q, scale, bits, int(block))
    quantize.launches += 1
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, block: int = _q.BLOCK,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Invert :func:`quantize`: q [n, d] int8 and scale f32
    [n/block, d/block] -> q * (its tile's scale) in `out_dtype` (f32 or
    bf16). Kernel for CUDA tensors, `dequantize_ref` for CPU ones."""
    dev = _check_tensors({"q": (torch.int8,), "scale": (torch.float32,)},
                         q=q, scale=scale)
    _check_out_dtype(out_dtype)
    grid = _check_tiles(q, int(block))
    if tuple(scale.shape) != grid:
        raise ValueError(f"scale must be {grid}, got {tuple(scale.shape)}")
    if dev.type == "cpu":
        return dequantize_ref(q, scale, int(block), out_dtype)
    out = torch.empty(q.shape, dtype=out_dtype, device=dev)
    _q.launch_dequant_tile(q, scale, out, int(block))
    dequantize.launches += 1
    return out


def _check_groups(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] < 1 or \
            not 1 <= x.shape[0] <= _q.MAX_GROUPS:
        raise ValueError(f"expected [G, L] with 1 <= G <= {_q.MAX_GROUPS} "
                         f"and L >= 1, got {tuple(x.shape)}")


def _check_rows(name: str, t: torch.Tensor) -> None:
    """t [G, L] a view with unit column stride and rows that do not
    overlap (stride(0) >= L), as a part along axis 1 of a larger
    tensor is."""
    G, L = t.shape
    if (L > 1 and t.stride(1) != 1) or (G > 1 and t.stride(0) < L):
        raise ValueError(f"{name} must be a [{G}, {L}] view with unit "
                         f"column stride and non-overlapping rows, got "
                         f"strides {t.stride()}")


def quantize_groups(x: torch.Tensor, bits: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantize of each row of x [G, L] (f32 or bf16) with its
    own abs-max scale -> (q int8 [G, L], scale f32 [G]): the wire
    codec's form (G = 1 for one segment, G = P for per-pod slices). x
    may be a view whose rows lie apart (unit column stride, stride(0)
    >= L); it is read in place. q is contiguous.

    CUDA tensors go to the hand-written kernel (csrc/quantize.cu, one
    launch); CPU tensors to
    :func:`repro_torch.kernels.ref.quantize_groups_ref`. Both are
    bit-equal to the JAX package's `wire_encode` under `jax.jit`. Counts
    in `quantize.launches`."""
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a torch.Tensor")
    _check_groups(x)
    _check_rows("x", x)
    dev = _check_tensors({"x": _FLOATS}, x=x, contiguous=False)
    bits = _check_bits(bits)
    if dev.type == "cpu":
        return quantize_groups_ref(x, bits)
    G = x.shape[0]
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    scale = torch.empty(G, dtype=torch.float32, device=dev)
    scratch = torch.empty(_q.group_scratch_words(x), dtype=torch.int32,
                          device=dev)
    _q.launch_groups(x, q, scale, scratch, bits)
    quantize.launches += 1
    return q, scale


def dequantize_groups(q: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Invert :func:`quantize_groups`: q [G, L] int8 and scale f32 [G]
    -> q[g] * scale[g] in `out_dtype` (f32 or bf16). Kernel for CUDA
    tensors, `dequantize_groups_ref` for CPU ones. Counts in
    `dequantize.launches`."""
    dev = _check_tensors({"q": (torch.int8,), "scale": (torch.float32,)},
                         q=q, scale=scale)
    _check_out_dtype(out_dtype)
    _check_groups(q)
    if tuple(scale.shape) != (q.shape[0],):
        raise ValueError(f"scale must be [{q.shape[0]}], got "
                         f"{tuple(scale.shape)}")
    if dev.type == "cpu":
        return dequantize_groups_ref(q, scale, out_dtype)
    out = torch.empty(q.shape, dtype=out_dtype, device=dev)
    _q.launch_dequant_groups(q, scale, out)
    dequantize.launches += 1
    return out


def dequantize_groups_add(q: torch.Tensor, scale: torch.Tensor,
                          acc: torch.Tensor) -> torch.Tensor:
    """acc += q[g] * scale[g] in place, the multiply fused into the add
    with one rounding: q [G, L] int8, scale f32 [G], acc an f32 [G, L]
    view with unit column stride (its rows may lie apart, as a part
    along axis 1 of a larger tensor does). Returns acc. Kernel for CUDA
    tensors, `dequantize_groups_add_ref` for CPU ones. Counts in
    `dequantize.launches`."""
    dev = _check_tensors({"q": (torch.int8,), "scale": (torch.float32,)},
                         q=q, scale=scale)
    _check_groups(q)
    if tuple(scale.shape) != (q.shape[0],):
        raise ValueError(f"scale must be [{q.shape[0]}], got "
                         f"{tuple(scale.shape)}")
    if not isinstance(acc, torch.Tensor) or acc.dtype != torch.float32:
        raise TypeError("acc must be a float32 torch.Tensor")
    if acc.device != dev:
        raise ValueError(f"acc on {acc.device}, q on {dev}")
    G, L = q.shape
    if tuple(acc.shape) != (G, L):
        raise ValueError(f"acc must be [{G}, {L}], got {tuple(acc.shape)}")
    _check_rows("acc", acc)
    if dev.type == "cpu":
        return dequantize_groups_add_ref(q, scale, acc)
    _q.launch_dequant_groups_add(q, scale, acc)
    dequantize.launches += 1
    return acc


quantize.launches = 0
dequantize.launches = 0


# ----------------------------------------------------------------------
# water-fill
# ----------------------------------------------------------------------
def _check_fill(tensors) -> Tuple[int, int]:
    c = tensors["c"]
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != c.device:
            raise ValueError(f"{name} on {t.device}, c on {c.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if c.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fill_rates runs on cuda or cpu, not {c.device}")
    if c.dim() != 3 or c.shape[1] != c.shape[2]:
        raise ValueError(f"c must be [B, N, N], got {tuple(c.shape)}")
    B, n = c.shape[0], c.shape[1]
    if not 1 <= n <= _wf.MAX_N:
        raise ValueError(f"fill_rates takes 1 <= N <= {_wf.MAX_N} (one "
                         f"thread per pair), got N={n}")
    want = {"single": (B, n, n), "path_cap": (B, n, n), "egress": (B, n),
            "ingress": (B, n)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(tensors[name].shape)}")
    if tuple(tensors["w"].shape) not in ((n, n), (B, n, n)):
        raise ValueError(f"w must be [{n}, {n}] or [{B}, {n}, {n}], got "
                         f"{tuple(tensors['w'].shape)}")
    return B, n


def fill_rates(c: torch.Tensor, single: torch.Tensor, egress: torch.Tensor,
               ingress: torch.Tensor, w: torch.Tensor, path_cap: torch.Tensor,
               out: Optional[Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B progressive water-fills in f64: c / single / path_cap [B, N, N]
    (aggregate flows, single-connection BW, knee path caps), egress /
    ingress [B, N] NIC caps, w [N, N] or [B, N, N] RTT weights, N <= 32
    -> (rate [B, N, N] f64, iters [B] int32, converged [B] bool).

    CUDA tensors go to the hand-written kernel (csrc/waterfill.cu, one
    launch: a warp a fill for N <= 8, else a block a fill); `out` may
    name the three outputs there
    (contiguous, on the device). CPU tensors go to
    :func:`repro_torch.kernels.ref.fill_rates_ref`. Both run the JAX
    package's `fill_rates_loop` and agree with the host numpy loop to
    1e-9 with the same iteration counts; they sum in other orders."""
    B, n = _check_fill({"c": c, "single": single, "egress": egress,
                        "ingress": ingress, "w": w, "path_cap": path_cap})
    if c.device.type == "cpu":
        if out is not None:
            raise ValueError("out is for CUDA tensors")
        return fill_rates_ref(c, single, egress, ingress, w, path_cap)
    if out is None:
        out = (torch.empty((B, n, n), dtype=torch.float64, device=c.device),
               torch.empty(B, dtype=torch.int32, device=c.device),
               torch.empty(B, dtype=torch.bool, device=c.device))
    for t, dt, shape in zip(out, (torch.float64, torch.int32, torch.bool),
                            ((B, n, n), (B,), (B,))):
        if not isinstance(t, torch.Tensor) or t.dtype != dt or \
                tuple(t.shape) != shape or t.device != c.device or \
                not t.is_contiguous():
            raise ValueError(f"out must be contiguous f64 [{B}, {n}, {n}], "
                             f"int32 [{B}] and bool [{B}] on {c.device}")
    if B:
        _wf.launch(c, single, egress, ingress, w, path_cap, *out)
        fill_rates.launches += 1
    return out


fill_rates.launches = 0


# ----------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------
def _check_flash(q, k, v, window: int, backward: bool = False,
                 **more) -> None:
    """q [B,K,G,S,Dq], k [B,K,S,Dq] and v [B,K,S,Dv] of one dtype (f32
    or bf16), or on the CPU the MLA form: q and v bf16, k f32 (the card
    takes MLA through :func:`flash_fwd_mla` and :func:`flash_bwd_mla`,
    from its parts); one device (cuda or cpu); Sq == Sk, window >= 0; on
    the card each head dim a multiple of 16 up to 128
    (`flash.check_dims`; the plain versions take any), and the backward
    (`backward`) Dq == Dv there: its bf16 kernels lay every operand out
    alike. `more` (g, out: q's shape with Dv columns, q's dtype; lse:
    f32 [B,K,G,S]) alike."""
    tensors = dict(q=q, k=k, v=v, **more)
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if q.dtype not in _flash.DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    dev = q.device
    if not (q.is_cuda or q.is_cpu):
        raise ValueError(f"flash attention runs on cuda or cpu, not {dev}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        want = torch.float32 if name == "lse" else q.dtype
        mla_keys = name == "k" and q.dtype == torch.bfloat16 and \
            t.dtype == torch.float32
        if t.dtype != want and not mla_keys:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q [B,K,G,S,Dq], k [B,K,S,Dq] and v "
                         f"[B,K,S,Dv]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, K, G, S, D = q.shape
    Dv = v.shape[3]
    if tuple(k.shape) != (B, K, S, D) or tuple(v.shape[:3]) != (B, K, S):
        raise ValueError(f"k must be {(B, K, S, D)} and v {(B, K, S)} + "
                         f"(Dv,) (Sq == Sk, k's head dim q's); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.is_cuda:
        if k.dtype != q.dtype:
            raise ValueError(
                "f32 keys beside a bf16 q: the card runs MLA's form from "
                "its parts, through flash_fwd_mla and flash_bwd_mla "
                "(q_nope, q_rope, k_nope, k_rope, v)")
        _flash.check_dims(D, Dv)
        if backward and D != Dv:
            raise ValueError(
                f"flash_bwd on the card takes Dq == Dv (here {D}, {Dv}); "
                f"MLA's backward runs from its parts, through "
                f"flash_bwd_mla")
        if B * K * G > _flash.MAX_HEADS:
            raise ValueError(f"B*K*G = {B * K * G} query heads: the "
                             f"kernels' grid takes at most "
                             f"{_flash.MAX_HEADS}")
    for name, t in more.items():
        shape = (B, K, G, S) if name == "lse" else (B, K, G, S, Dv)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")


def _flash_views(*tensors, tma=()):
    """Each tensor's :func:`repro_torch.kernels.flash.operand_strides`
    (`tma` for those at the positions it names: f32 read by TMA), or a
    dense copy of it where the kernels cannot read it in place (counted
    in `flash_fwd.copies`); returns (tensors, views)."""
    out, views = [], []
    for i, t in enumerate(tensors):
        view = _flash.operand_strides(t, i in tma)
        if view is None:
            t = t.contiguous()
            view = _flash.operand_strides(t, i in tma)
            flash_fwd.copies += 1
        out.append(t)
        views.append(view)
    return out, views


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int = 0, block_k: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal flash attention's forward (windowed where window > 0):
    q [B,K,G,S,Dq], k [B,K,S,Dq] and v [B,K,S,Dv] -> (out [B,K,G,S,Dv]
    in v's dtype, lse [B,K,G,S] f32), the reference's `flash_attention`
    (`src/repro/models/attention.py:39`), scaled by Dq ** -0.5. The
    inputs may be strided views with unit stride along the head dim.
    Dq and Dv may differ. On the CPU k may be f32 beside a bf16 q and v
    (MLA's concatenated form, the reference's: its k is f32 in bf16 runs
    and its score product reads it as it is); the card takes that form
    from its parts through :func:`flash_fwd_mla`. On the card each head
    dim is a multiple of 16 up to 128.

    CUDA tensors go to the hand-written kernels (csrc/flash_attn.cu, one
    launch counted; the kernels state their tiles); CPU tensors to
    :func:`repro_torch.kernels.ref.flash_fwd_ref`, which walks key blocks
    of `block_k` as the reference does."""
    _check_flash(q, k, v, window)
    if q.is_cpu:
        return flash_fwd_ref(q, k, v, window, block_k)
    (q, k, v), views = _flash_views(q, k, v)
    out = torch.empty(q.shape[:4] + v.shape[3:], dtype=v.dtype,
                      device=q.device)
    lse = torch.empty(q.shape[:4], dtype=torch.float32, device=q.device)
    if out.numel():
        _flash.launch_fwd(q, k, v, out, lse, window, views)
        flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0
flash_fwd.copies = 0       # operands copied dense before a launch (all)


def _check_mla(q_nope, q_rope, k_nope, k_rope, v, **more) -> None:
    """q_nope [B,H,S,nd], q_rope [B,H,S,rd], k_nope [B,H,S,nd] f32,
    k_rope [B,1,S,rd] and v [B,H,S,Dv], all but k_nope of one dtype (bf16
    or f32); one device (cuda or cpu); on the card `flash.check_dims`'
    rule for the parts (nd <= 64, rd <= 32, Dv <= 64, multiples of 8).
    `more` (the backward's g and out [B,H,1,S,Dv] in q's dtype, lse
    [B,H,1,S] f32) alike."""
    parts = dict(q_nope=q_nope, q_rope=q_rope, k_nope=k_nope,
                 k_rope=k_rope, v=v, **more)
    for name, t in parts.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        ndim = 5 if name in ("g", "out") else 4
        if t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-d, got "
                             f"{tuple(t.shape)}")
    dt, dev = q_nope.dtype, q_nope.device
    if dt not in _flash.DTYPES:
        raise TypeError(f"q_nope must be float32 or bfloat16, got {dt}")
    if not (q_nope.is_cuda or q_nope.is_cpu):
        raise ValueError(f"flash attention runs on cuda or cpu, not {dev}")
    for name, t in parts.items():
        want = torch.float32 if name in ("k_nope", "lse") else dt
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q_nope on {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    B, H, S, nd = q_nope.shape
    rd, Dv = q_rope.shape[3], v.shape[3]
    want = dict(q_rope=(B, H, S, rd), k_nope=(B, H, S, nd),
                k_rope=(B, 1, S, rd), v=(B, H, S, Dv),
                g=(B, H, 1, S, Dv), out=(B, H, 1, S, Dv), lse=(B, H, 1, S))
    for name in parts:
        if name != "q_nope" and tuple(parts[name].shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} (q_nope "
                             f"{tuple(q_nope.shape)}), got "
                             f"{tuple(parts[name].shape)}")
    if q_nope.is_cuda:
        _flash.check_dims(nd + rd, Dv, (nd, rd))
        if B * H > _flash.MAX_HEADS:
            raise ValueError(f"B*H = {B * H} heads: the kernels' grid "
                             f"takes at most {_flash.MAX_HEADS}")


def flash_fwd_mla(q_nope: torch.Tensor, q_rope: torch.Tensor,
                  k_nope: torch.Tensor, k_rope: torch.Tensor,
                  v: torch.Tensor, block_k: int = 512
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MLA's causal flash attention from its parts (the reference's
    `mla_forward`, `src/repro/models/attention.py:339`, which
    concatenates q = [q_nope, q_rope] and k = [k_nope, k_rope expanded
    over the heads], the latter promoted to f32, then calls
    `flash_attention` scaled by (nd + rd) ** -0.5): q_nope [B,H,S,nd],
    q_rope [B,H,S,rd], k_nope [B,H,S,nd] f32, k_rope [B,1,S,rd] (one
    rope key for every head) and v [B,H,S,Dv] -> (out [B,H,1,S,Dv] in
    v's dtype, lse [B,H,1,S] f32). In bf16 runs q's parts, k_rope and v
    are bf16; in f32 runs all are f32. The parts may be strided views
    with unit stride along the head dim (q_nope is one of the
    projection). On the card nd <= 64, rd <= 32 and Dv <= 64, each a
    multiple of 8.

    CUDA tensors go to one hand-written kernel (csrc/flash_attn.cu),
    with no concatenation: bf16 runs take the `wgmma` kernel, which
    splits k_nope into bf16 hi = bf16(k) and lo = bf16(k - hi) in shared
    memory and forms s = q . hi + q_nope . lo in f32; f32 runs the FFMA
    kernel. Its launch counts in `flash_fwd.launches` (flash_fwd's MLA
    form), its copies in `flash_fwd.copies`. CPU tensors go to
    :func:`repro_torch.kernels.ref.flash_fwd_mla_ref`: the reference's
    concatenations, then :func:`flash_fwd_ref` over key blocks of
    `block_k`. Its gradient is :func:`flash_bwd_mla`'s
    (`attention._FlashMla`)."""
    _check_mla(q_nope, q_rope, k_nope, k_rope, v)
    if q_nope.is_cpu:
        return flash_fwd_mla_ref(q_nope, q_rope, k_nope, k_rope, v, block_k)
    parts, views = _flash_views(
        q_nope, q_rope, k_nope, k_rope, v,
        tma=(2,) if q_nope.dtype == torch.bfloat16 else ())
    B, H, S, _ = q_nope.shape
    out = torch.empty((B, H, 1, S, v.shape[3]), dtype=v.dtype,
                      device=v.device)
    lse = torch.empty((B, H, 1, S), dtype=torch.float32, device=v.device)
    if out.numel():
        _flash.launch_fwd_mla(*parts, out, lse, views)
        flash_fwd.launches += 1
    return out, lse


def flash_bwd(g: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
              window: int = 0, block_k: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_fwd` (the reference's custom VJP,
    `src/repro/models/attention.py:99`) given the cotangent g of out:
    (dq, dk, dv) in the operands' dtype, dense, with the probabilities
    recomputed from the saved lse and kept in f32.

    CUDA tensors go to the hand-written kernels (csrc/flash_attn.cu: dq
    with delta, and dk / dv, counted as one launch), which take Dq == Dv
    and one dtype (MLA's backward runs from its parts, through
    :func:`flash_bwd_mla`); CPU tensors to
    :func:`repro_torch.kernels.ref.flash_bwd_ref`, which also takes the
    concatenated MLA form (Dq != Dv, k f32 beside a bf16 q and v: dk in
    f32, as the reference's)."""
    _check_flash(q, k, v, window, backward=True, g=g, out=out, lse=lse)
    if q.is_cpu:
        return flash_bwd_ref(g, q, k, v, out, lse, window, block_k)
    lse = lse.contiguous()
    (q, k, v, g, out), views = _flash_views(q, k, v, g, out)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    delta = torch.empty(q.shape[:4], dtype=torch.float32, device=q.device)
    if dq.numel():
        _flash.launch_bwd(g, q, k, v, out, lse, delta, dq, dk, dv, window,
                          views)
        flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


def flash_bwd_mla(g: torch.Tensor, q_nope: torch.Tensor,
                  q_rope: torch.Tensor, k_nope: torch.Tensor,
                  k_rope: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  lse: torch.Tensor, block_k: int = 512):
    """The backward of :func:`flash_fwd_mla` (the reference's custom VJP
    on its concatenations, then the concatenations' transposes) given
    the cotangent g [B,H,1,S,Dv] of out and the forward's out and lse:
    (dq_nope [B,H,S,nd], dq_rope [B,H,S,rd] in q's dtype, dk_nope
    [B,H,S,nd] in f32, dk_rope [B,1,S,rd] in k_rope's dtype, dv
    [B,H,S,Dv] in v's dtype). dq is rounded once and sliced; dk stays f32
    (the reference's keys are f32); dk_rope is dk's rope columns summed
    over the heads as the reference's broadcast's transpose sums them
    (`ref.rope_head_sum`: in the key's dtype, windows of 32 heads). The
    dq and dk parts are views of one dense [.., nd + rd] tensor each.

    CUDA tensors go to the hand-written kernels (csrc/flash_attn.cu: in
    bf16 dq with delta, then dk and dv, each splitting the f32 k_nope
    tiles into bf16 hi and lo in shared memory, then the heads' sum; in
    f32 the FFMA kernels), counted as one launch in `flash_bwd.launches`,
    copies in `flash_fwd.copies`; CPU tensors to
    :func:`repro_torch.kernels.ref.flash_bwd_mla_ref`."""
    _check_mla(q_nope, q_rope, k_nope, k_rope, v, g=g, out=out, lse=lse)
    if q_nope.is_cpu:
        return flash_bwd_mla_ref(g, q_nope, q_rope, k_nope, k_rope, v, out,
                                 lse, block_k)
    B, H, S, nd = q_nope.shape
    rd, Dv = q_rope.shape[3], v.shape[3]
    lse = lse.contiguous()
    parts, views = _flash_views(
        q_nope, q_rope, k_nope, k_rope, v, g, out,
        tma=(2,) if q_nope.dtype == torch.bfloat16 else ())
    dev = q_nope.device
    dq = torch.empty((B, H, S, nd + rd), dtype=q_nope.dtype, device=dev)
    dk = torch.empty((B, H, S, nd + rd), dtype=torch.float32, device=dev)
    dv = torch.empty((B, H, S, Dv), dtype=v.dtype, device=dev)
    dk_rope = torch.empty((B, 1, S, rd), dtype=k_rope.dtype, device=dev)
    delta = torch.empty((B, H, 1, S), dtype=torch.float32, device=dev)
    if dq.numel():
        q_nope, q_rope, k_nope, k_rope, v, g, out = parts
        _flash.launch_bwd_mla(g, q_nope, q_rope, k_nope, k_rope, v, out, lse,
                              delta, dq, dk, dv, dk_rope, views)
        flash_bwd.launches += 1
    return dq[..., :nd], dq[..., nd:], dk[..., :nd], dk_rope, dv


# ----------------------------------------------------------------------
# MoE slots, dispatch and combine
# ----------------------------------------------------------------------
def _check_routing(T: int, eidx, pos_c, keep, dev) -> int:
    """eidx, pos_c int64 and keep bool, each a contiguous [T, k] tensor
    on `dev` with 1 <= k <= 32; returns k."""
    _check_tensors({"eidx": (torch.int64,), "pos_c": (torch.int64,),
                    "keep": (torch.bool,)}, eidx=eidx, pos_c=pos_c,
                   keep=keep)
    if eidx.device != dev:
        raise ValueError(f"the routing lies on {eidx.device}, the rows on "
                         f"{dev}")
    if eidx.dim() != 2 or eidx.shape[0] != T or \
            not 1 <= eidx.shape[1] <= _moe.MAX_K:
        raise ValueError(f"eidx must be [T={T}, k] with 1 <= k <= "
                         f"{_moe.MAX_K}, got {tuple(eidx.shape)}")
    if pos_c.shape != eidx.shape or keep.shape != eidx.shape:
        raise ValueError(f"eidx, pos_c and keep must share a shape, got "
                         f"{tuple(eidx.shape)}, {tuple(pos_c.shape)}, "
                         f"{tuple(keep.shape)}")
    return eidx.shape[1]


def moe_slots(eidx: torch.Tensor, E: int, C: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The MoE layer's capacity slots: the choices' experts eidx [G, T_g,
    k] int64 (contiguous, 1 <= k <= 32) -> (pos_c [G, T_g, k] int64,
    keep [G, T_g, k] bool, src [G, E, C] int32), dense. A choice's slot
    is its rank among the choices of its expert over its group's
    flattened (token, choice) stream, kept where below C (a dropped
    choice's pos_c is 0); src names the token whose kept choice holds
    slot (e, c), or -1. An expert outside [0, E) is dropped by the
    kernel (the plain version raises).

    CUDA tensors go to the hand-written kernel (csrc/moe.cu, one
    cooperative launch for all G groups, 1 <= E <= 256, G at most the
    kernel's co-resident blocks, `moe_slots_blocks()` in the source: the
    launch fails above it); CPU tensors to
    :func:`repro_torch.kernels.ref.moe_slots_ref` (the reference's
    one-hot cumulative count and its inverse), which it equals integer
    for integer."""
    dev = _check_tensors({"eidx": (torch.int64,)}, eidx=eidx)
    if eidx.dim() != 3 or min(eidx.shape) < 1 or \
            eidx.shape[2] > _moe.MAX_K:
        raise ValueError(f"eidx must be a non-empty [G, T_g, k] with k <= "
                         f"{_moe.MAX_K}, got {tuple(eidx.shape)}")
    E, C = int(E), int(C)
    if not (1 <= E <= _moe.MAX_EXPERTS and C >= 1):
        raise ValueError(f"need 1 <= E <= {_moe.MAX_EXPERTS} and C >= 1, "
                         f"got E={E}, C={C}")
    G, Tg, k = eidx.shape
    if Tg * k >= 2 ** 31 or E * C >= 2 ** 31:
        raise ValueError(f"a group's choices and slots must number under "
                         f"2^31, got {Tg * k} and {E * C}")
    if eidx.is_cpu:
        return moe_slots_ref(eidx, E, C)
    pos_c = torch.empty(eidx.shape, dtype=torch.int64, device=dev)
    keep = torch.empty(eidx.shape, dtype=torch.bool, device=dev)
    src = torch.empty((G, E, C), dtype=torch.int32, device=dev)
    _moe.launch_slots(eidx, pos_c, keep, src)
    moe_slots.launches += 1
    return pos_c, keep, src


moe_slots.launches = 0


def moe_dispatch(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The MoE dispatch of one group: x [T,d] (f32 or bf16, contiguous)
    and each slot's source token src [E,C] int32 (contiguous, -1 for an
    empty slot; `moe_slots`' src of the group) -> buf [E,C,d] in x's
    dtype, dense: buf[e, c] = x[src[e, c]] with a -0.0 written as +0.0,
    as the reference's f32 scatter-adds onto zeros write it, and zeros
    in every empty slot. A source outside [0, T) reads as empty in the
    kernel (the plain version raises above T).

    CUDA tensors go to the hand-written kernel (csrc/moe.cu, one
    launch); CPU tensors to :func:`repro_torch.kernels.ref.
    moe_dispatch_gather_ref` (a gather and an add of +0.0), which it
    equals bit for bit, as both equal the reference's k scatter-adds
    (`ref.moe_dispatch_ref`)."""
    dev = _check_tensors({"x": _FLOATS, "src": (torch.int32,)}, x=x,
                         src=src)
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"x must be a non-empty [T, d], got "
                         f"{tuple(x.shape)}")
    if src.dim() != 2 or min(src.shape) < 1:
        raise ValueError(f"src must be a non-empty [E, C], got "
                         f"{tuple(src.shape)}")
    if x.is_cpu:
        return moe_dispatch_gather_ref(x, src)
    buf = torch.empty((*src.shape, x.shape[1]), dtype=x.dtype,
                      device=dev)
    _moe.launch_dispatch(x, src, buf)
    moe_dispatch.launches += 1
    return buf


moe_dispatch.launches = 0


def moe_combine(ob: torch.Tensor, eidx: torch.Tensor, pos_c: torch.Tensor,
                keep: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """The MoE combine of one group: the experts' outputs ob [E,C,d]
    (f32 or bf16, contiguous), each token's choices eidx / pos_c [T,k]
    int64, keep [T,k] bool and gates [T,k] f32 -> y [T,d] in ob's dtype,
    dense: y_t = sum over j of keep_j ? ob[eidx_j, pos_c_j] * g_j : 0,
    choice 0 first, rounded as XLA's CPU program rounds the reference's
    loop (:func:`repro_torch.kernels.ref.moe_combine_ref`).

    CUDA tensors go to the hand-written kernel (csrc/moe.cu, one
    launch); CPU tensors to the plain version, which it equals bit for
    bit."""
    dev = _check_tensors({"ob": _FLOATS}, ob=ob)
    if ob.dim() != 3 or min(ob.shape) < 1:
        raise ValueError(f"ob must be a non-empty [E, C, d], got "
                         f"{tuple(ob.shape)}")
    T = eidx.shape[0] if isinstance(eidx, torch.Tensor) and eidx.dim() else 0
    _check_routing(T, eidx, pos_c, keep, dev)
    _check_tensors({"gates": (torch.float32,)}, gates=gates)
    if gates.shape != eidx.shape or gates.device != dev:
        raise ValueError(f"gates must be [T, k] f32 on {dev}, got "
                         f"{tuple(gates.shape)} on {gates.device}")
    if T < 1:
        raise ValueError("moe_combine needs at least one token")
    if ob.is_cpu:
        return moe_combine_ref(ob, eidx, pos_c, keep, gates)
    y = torch.empty((T, ob.shape[2]), dtype=ob.dtype, device=ob.device)
    _moe.launch_combine(ob, eidx, pos_c, keep, gates, y)
    moe_combine.launches += 1
    return y


moe_combine.launches = 0


# ----------------------------------------------------------------------
# Their backwards, and the two ops with a gradient
# ----------------------------------------------------------------------
def moe_dispatch_bwd(g: torch.Tensor, eidx: torch.Tensor, pos_c: torch.Tensor,
                     keep: torch.Tensor) -> torch.Tensor:
    """The gradient of one group's :func:`moe_dispatch` in x: the
    buffer's cotangent g [E,C,d] (f32 or bf16, contiguous) and the
    group's routing eidx / pos_c [T,k] int64, keep [T,k] bool -> dx
    [T,d] in g's dtype, dense: each token's kept choices' rows of g,
    summed last choice first, each add rounded to g's dtype, as XLA's
    CPU program sums the reference's transposed scatter-adds
    (:func:`repro_torch.kernels.ref.moe_dispatch_bwd_ref`).

    CUDA tensors go to the hand-written kernel (csrc/moe.cu, one
    launch); CPU tensors to the plain version, which it equals bit for
    bit."""
    dev = _check_tensors({"g": _FLOATS}, g=g)
    if g.dim() != 3 or min(g.shape) < 1:
        raise ValueError(f"g must be a non-empty [E, C, d], got "
                         f"{tuple(g.shape)}")
    T = eidx.shape[0] if isinstance(eidx, torch.Tensor) and eidx.dim() else 0
    _check_routing(T, eidx, pos_c, keep, dev)
    if T < 1:
        raise ValueError("moe_dispatch_bwd needs at least one token")
    if g.is_cpu:
        return moe_dispatch_bwd_ref(g, eidx, pos_c, keep)
    dx = torch.empty((T, g.shape[2]), dtype=g.dtype, device=dev)
    _moe.launch_dispatch_bwd(g, eidx, pos_c, keep, dx)
    moe_dispatch_bwd.launches += 1
    return dx


moe_dispatch_bwd.launches = 0


def _check_gated(dy, eidx, pos_c, keep, gates) -> torch.device:
    """dy [T,d] f32 / bf16 and its routing and f32 gates [T,k], all on
    dy's device and contiguous; returns the device."""
    dev = _check_tensors({"dy": _FLOATS}, dy=dy)
    if dy.dim() != 2 or min(dy.shape) < 1:
        raise ValueError(f"dy must be a non-empty [T, d], got "
                         f"{tuple(dy.shape)}")
    _check_routing(dy.shape[0], eidx, pos_c, keep, dev)
    if gates is not None:
        _check_tensors({"gates": (torch.float32,)}, gates=gates)
        if gates.shape != eidx.shape or gates.device != dev:
            raise ValueError(f"gates must be [T, k] f32 on {dev}, got "
                             f"{tuple(gates.shape)} on {gates.device}")
    return dev


def moe_combine_bwd(dy: torch.Tensor, gates: torch.Tensor,
                    eidx: torch.Tensor, pos_c: torch.Tensor,
                    keep: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The gradient of one group's :func:`moe_combine` in ob: the
    output's cotangent dy [T,d] (f32 or bf16, contiguous), the gates
    [T,k] f32, the routing and each slot's source token src [E,C] int32
    (`moe_slots`' src of the group) -> d_ob [E,C,d] in dy's dtype,
    dense: slot (e, c) = dy[src] times the gate of that token's choice
    of (e, c) rounded to dy's dtype, the product rounded once, -0.0
    written as +0.0; zeros in every empty slot. That is XLA's sum of the
    reference's k transposed gathers, each an f32 scatter-add onto zeros
    (:func:`repro_torch.kernels.ref.moe_combine_bwd_ref`).

    CUDA tensors go to the hand-written kernel (csrc/moe.cu, one
    launch: a gather by src, every slot written once); CPU tensors to
    the plain version, which it equals bit for bit."""
    dev = _check_gated(dy, eidx, pos_c, keep, gates)
    _check_tensors({"src": (torch.int32,)}, src=src)
    if src.dim() != 2 or min(src.shape) < 1 or src.device != dev:
        raise ValueError(f"src must be a non-empty [E, C] on {dev}, got "
                         f"{tuple(src.shape)} on {src.device}")
    E, C = src.shape
    if dy.is_cpu:
        return moe_combine_bwd_ref(dy, gates, eidx, pos_c, keep, E, C)
    d_ob = torch.empty((E, C, dy.shape[1]), dtype=dy.dtype, device=dev)
    _moe.launch_combine_bwd(dy, gates, eidx, pos_c, keep, src, d_ob)
    moe_combine_bwd.launches += 1
    return d_ob


moe_combine_bwd.launches = 0


def moe_gates_bwd(dy: torch.Tensor, ob: torch.Tensor, eidx: torch.Tensor,
                  pos_c: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The gradient of one group's :func:`moe_combine` in its gates: the
    output's cotangent dy [T,d] and the experts' outputs ob [E,C,d] (one
    dtype, f32 or bf16, contiguous) and the routing -> dgates [T,k] f32:
    for each kept choice the row product dy[t] . ob[e, p] as XLA's CPU
    program reduces it (products rounded to the dtype, the row summed in
    windows of 32 in order, then the windows in order, each add rounded
    to the dtype; :func:`repro_torch.kernels.ref.gate_window_sum`), +0.0
    for a dropped choice.

    CUDA tensors go to the hand-written kernel (csrc/moe.cu, one
    launch: a persistent grid of warps, a choice each, rows of up to
    `kernels.moe.MAX_GATES_D` elements); CPU tensors to
    :func:`repro_torch.kernels.ref.moe_gates_bwd_ref`, which it equals
    bit for bit."""
    dev = _check_gated(dy, eidx, pos_c, keep, None)
    _check_tensors({"ob": _FLOATS}, ob=ob)
    if ob.dim() != 3 or min(ob.shape) < 1 or ob.dtype != dy.dtype or \
            ob.shape[2] != dy.shape[1] or ob.device != dev:
        raise ValueError(f"ob must be a non-empty [E, C, d={dy.shape[1]}] "
                         f"{dy.dtype} on {dev}, got {ob.dtype} "
                         f"{tuple(ob.shape)} on {ob.device}")
    if dy.is_cpu:
        return moe_gates_bwd_ref(dy, ob, eidx, pos_c, keep)
    dg = torch.empty(eidx.shape, dtype=torch.float32, device=dev)
    _moe.launch_gates_bwd(dy, ob, eidx, pos_c, keep, dg)
    moe_gates_bwd.launches += 1
    return dg


moe_gates_bwd.launches = 0


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _MoeDispatch(torch.autograd.Function):
    """:func:`moe_dispatch` with a gradient in x: backward
    :func:`moe_dispatch_bwd` on the saved routing."""

    @staticmethod
    def forward(ctx, x, src, eidx, pos_c, keep):
        ctx.save_for_backward(eidx, pos_c, keep)
        return moe_dispatch(x, src)

    @staticmethod
    def backward(ctx, g):
        return (moe_dispatch_bwd(g.contiguous(), *ctx.saved_tensors), None,
                None, None, None)


def moe_dispatch_ad(x: torch.Tensor, src: torch.Tensor, eidx: torch.Tensor,
                    pos_c: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """:func:`moe_dispatch` as a differentiable op in x (the routing
    eidx / pos_c / keep [T,k] is what its gradient,
    :func:`moe_dispatch_bwd`, sums by). Where x needs no gradient it is
    the forward wrapper's call itself."""
    if not _needs_grad(x):
        return moe_dispatch(x, src)
    return _MoeDispatch.apply(x, src, eidx, pos_c, keep)


class _MoeCombine(torch.autograd.Function):
    """:func:`moe_combine` with a gradient in ob and the gates: backward
    :func:`moe_combine_bwd` and :func:`moe_gates_bwd` on the saved ob,
    gates and routing."""

    @staticmethod
    def forward(ctx, ob, eidx, pos_c, keep, gates, src):
        ctx.save_for_backward(ob, eidx, pos_c, keep, gates, src)
        return moe_combine(ob, eidx, pos_c, keep, gates)

    @staticmethod
    def backward(ctx, dy):
        ob, eidx, pos_c, keep, gates, src = ctx.saved_tensors
        dy = dy.contiguous()
        d_ob = moe_combine_bwd(dy, gates, eidx, pos_c, keep, src) \
            if ctx.needs_input_grad[0] else None
        dg = moe_gates_bwd(dy, ob, eidx, pos_c, keep) \
            if ctx.needs_input_grad[4] else None
        return d_ob, None, None, None, dg, None


def moe_combine_ad(ob: torch.Tensor, eidx: torch.Tensor, pos_c: torch.Tensor,
                   keep: torch.Tensor, gates: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """:func:`moe_combine` as a differentiable op in ob and the gates
    (src, `moe_slots`' of the group, is what the ob gradient
    :func:`moe_combine_bwd` gathers by; the gates' is
    :func:`moe_gates_bwd`). Where neither needs a gradient it is the
    forward wrapper's call itself."""
    if not _needs_grad(ob, gates):
        return moe_combine(ob, eidx, pos_c, keep, gates)
    return _MoeCombine.apply(ob, eidx, pos_c, keep, gates, src)
