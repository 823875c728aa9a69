"""The SiLU gates (Mamba-2's two, the SwiGLU MLP's) and their
gradients: the hand-written CUDA kernels' binding.

The kernel source is `repro_torch/csrc/silu.cu`; its head comment says
which ops of the JAX package's compiled program it mirrors and why the
rounding matters. This module reads a tensor as rows (`row_view`),
binds the library (built at first use by
:mod:`repro_torch.kernels.build`) and launches it. Call it through
:func:`repro_torch.kernels.ops.silu` and
:func:`repro_torch.kernels.ops.silu_gate`,
:func:`repro_torch.kernels.ops.silu_gate_bwd`,
:func:`repro_torch.kernels.ops.silu_bwd` and
:func:`repro_torch.kernels.ops.silu_gate_prod_bwd`, which check the
inputs, take the plain versions for CPU tensors and count launches.
SiLU's gradient has a kernel of its own (`silu_bwd_kernel`); the two
gates' gradients are one (`silu_gate_bwd_kernel`): the SSM gate's adds
the f32 cotangent of the product.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("silu")
    if not getattr(lib, "_typed", False):
        lib.silu_launch.argtypes = [_P, _L, _L, _P, _L, _L, _I, _P]
        lib.silu_launch.restype = _I
        lib.silu_bwd_launch.argtypes = [_P, _L, _L, _P, _L, _L, _P, _L, _L,
                                        _I, _P]
        lib.silu_bwd_launch.restype = _I
        lib.silu_gate_launch.argtypes = [_P, _L, _L, _P, _L, _L, _P, _P,
                                         _L, _L, _I, _P]
        lib.silu_gate_launch.restype = _I
        lib.silu_gate_bwd_launch.argtypes = [_P, _L, _L, _P, _P, _L, _L,
                                             _P, _L, _L, _P, _P, _L, _L, _I,
                                             _P]
        lib.silu_gate_bwd_launch.restype = _I
        lib.silu_error_string.argtypes = [_I]
        lib.silu_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


# the raw current stream of a device, as an int (torch's own kernels'
# launch path); the public `current_stream(...).cuda_stream` builds a
# Stream object per call, which the model's 128 calls a decode step
# would pay on the host
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda idx: torch.cuda.current_stream(idx).cuda_stream)


def _on_device(dev: torch.device, fn, *args) -> int:
    """fn(*args, stream) with `dev` the current device and its current
    stream; returns fn's error code."""
    cur = torch.cuda.current_device()
    idx = cur if dev.index is None else dev.index
    if idx == cur:
        return fn(*args, _raw_stream(idx))
    with torch.cuda.device(idx):
        return fn(*args, _raw_stream(idx))


def row_view(t: torch.Tensor) -> Tuple[int, int, int, int]:
    """(rows, d, ld, inc): t read as rows of its last dim d, elements
    `inc` apart within a row and row starts `ld` apart (the leading dims
    collapse into one). A slice of the last dim of a larger tensor, or a
    transposed matrix, is such a view; raises ValueError where the
    leading dims do not collapse. The kernels only read through these
    strides, so rows may interleave."""
    shape = t.shape
    if not shape:
        raise ValueError("expected at least one dim")
    d = shape[-1]
    rows = t.numel() // d if d else 0
    if t.is_contiguous():
        return rows, d, d, 1
    strides = t.stride()
    inc = strides[-1] if d > 1 else 1
    ld = d * inc
    step = None
    for n, st in zip(reversed(shape[:-1]), reversed(strides[:-1])):
        if n == 1:
            continue
        if step is None:
            ld = step = st
        elif st != step:
            raise ValueError(f"the leading dims must collapse into rows, got "
                             f"shape {tuple(shape)} strides {strides}")
        step *= n
    return rows, d, ld, inc


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().silu_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def launch(x: torch.Tensor, out: torch.Tensor,
           view: Optional[Tuple[int, int, int, int]] = None) -> None:
    """out (dense, x's shape and dtype) = silu(x), one launch on the
    current stream of x's device; inputs are checked by the caller
    (`view`, if given, is x's :func:`row_view`)."""
    rows, d, ld, inc = view or row_view(x)
    _check(_on_device(x.device, _lib().silu_launch, x.data_ptr(), ld, inc,
                      out.data_ptr(), rows, d, DTYPES[x.dtype]), "silu")


def launch_gate(y: torch.Tensor, z: torch.Tensor, value: torch.Tensor,
                prod: Optional[torch.Tensor],
                views: Optional[Tuple[Tuple[int, int, int, int], ...]] = None
                ) -> None:
    """value (dense, y's dtype) and prod (dense, f32; not stored where
    None) = y * silu(z), one launch on the current stream of y's device;
    inputs are checked by the caller (`views`, if given, are y's and z's
    :func:`row_view`)."""
    (rows, d, ldy, incy), (_, _, ldz, incz) = views or (row_view(y),
                                                        row_view(z))
    _check(_on_device(y.device, _lib().silu_gate_launch, y.data_ptr(), ldy,
                      incy, z.data_ptr(), ldz, incz, value.data_ptr(),
                      None if prod is None else prod.data_ptr(), rows, d,
                      DTYPES[y.dtype]),
           "silu_gate")


def launch_gate_bwd(g: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                    dy: torch.Tensor, dz: torch.Tensor,
                    views: Optional[Tuple[Tuple[int, int, int, int], ...]]
                    = None, g_prod: Optional[torch.Tensor] = None) -> None:
    """dy, dz (dense, y's dtype) = the gradient of silu(z) * y given its
    cotangent g (plus g_prod, the f32 product's, dense, where given),
    one launch on the current stream of y's device; inputs are checked
    by the caller (`views`, if given, are g's, y's and z's
    :func:`row_view`)."""
    (rows, d, ldg, incg), (_, _, ldy, incy), (_, _, ldz, incz) = \
        views or (row_view(g), row_view(y), row_view(z))
    _check(_on_device(y.device, _lib().silu_gate_bwd_launch, g.data_ptr(),
                      ldg, incg,
                      None if g_prod is None else g_prod.data_ptr(),
                      y.data_ptr(), ldy, incy, z.data_ptr(), ldz, incz,
                      dy.data_ptr(), dz.data_ptr(), rows, d,
                      DTYPES[y.dtype]),
           "silu_gate_bwd" if g_prod is None else "silu_gate_prod_bwd")


def launch_bwd(g: torch.Tensor, x: torch.Tensor, dx: torch.Tensor,
               views: Optional[Tuple[Tuple[int, int, int, int], ...]]
               = None) -> None:
    """dx (dense, x's dtype) = the gradient of silu(x) given its
    cotangent g, one launch on the current stream of x's device; inputs
    are checked by the caller (`views`, if given, are g's and x's
    :func:`row_view`)."""
    (rows, d, ldg, incg), (_, _, ldx, incx) = views or (row_view(g),
                                                        row_view(x))
    _check(_on_device(x.device, _lib().silu_bwd_launch, g.data_ptr(), ldg,
                      incg, x.data_ptr(), ldx, incx, dx.data_ptr(), rows, d,
                      DTYPES[x.dtype]),
           "silu_bwd")
