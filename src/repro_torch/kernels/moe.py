"""The MoE layer's dispatch and combine: the hand-written CUDA kernels'
binding.

The kernel source is `repro_torch/csrc/moe.cu`; its head comment says
which ops of the JAX package's program they replace and how they round.
This module binds the library (built at first use by
:mod:`repro_torch.kernels.build`) and launches it. Call it through
:func:`repro_torch.kernels.ops.moe_dispatch` and
:func:`repro_torch.kernels.ops.moe_combine`, which check the inputs,
take the plain versions for CPU tensors and count launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.silu import _on_device

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 32                  # choices a token (a lane each, csrc/moe.cu)
MAX_EXPERTS = 65535         # the dispatch grid's second dim

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("moe")
    if not getattr(lib, "_typed", False):
        lib.moe_dispatch_launch.argtypes = [_P, _P, _P, _P, _P, _L, _L, _L,
                                            _L, _L, _I, _P]
        lib.moe_dispatch_launch.restype = _I
        lib.moe_combine_launch.argtypes = [_P, _P, _P, _P, _P, _P, _L, _L,
                                           _L, _L, _I, _P]
        lib.moe_combine_launch.restype = _I
        lib.moe_error_string.argtypes = [_I]
        lib.moe_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().moe_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def launch_dispatch(x: torch.Tensor, eidx: torch.Tensor, pos_c: torch.Tensor,
                    keep: torch.Tensor, buf: torch.Tensor) -> None:
    """buf [E,C,d] (dense, x's dtype) = x's rows at their kept choices'
    slots, zeros elsewhere; one launch on the current stream of x's
    device. Inputs are checked by the caller."""
    T, d = x.shape
    E, C, _ = buf.shape
    _check(_on_device(x.device, _lib().moe_dispatch_launch, x.data_ptr(),
                      eidx.data_ptr(), pos_c.data_ptr(), keep.data_ptr(),
                      buf.data_ptr(), T, eidx.shape[1], d, E, C,
                      DTYPES[x.dtype]), "moe_dispatch")


def launch_combine(ob: torch.Tensor, eidx: torch.Tensor, pos_c: torch.Tensor,
                   keep: torch.Tensor, gates: torch.Tensor,
                   y: torch.Tensor) -> None:
    """y [T,d] (dense, ob's dtype) = the gated sum of each token's k rows
    of ob; one launch on the current stream of ob's device. Inputs are
    checked by the caller."""
    T, k = eidx.shape
    _, C, d = ob.shape
    _check(_on_device(ob.device, _lib().moe_combine_launch, ob.data_ptr(),
                      eidx.data_ptr(), pos_c.data_ptr(), keep.data_ptr(),
                      gates.data_ptr(), y.data_ptr(), T, k, d, C,
                      DTYPES[ob.dtype]), "moe_combine")
