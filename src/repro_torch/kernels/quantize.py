"""Symmetric abs-max quantize / dequantize: the hand-written CUDA kernels.

Port of `repro/kernels/quantize.py::quantize_pallas` and
`dequantize_pallas`. The kernel source is `repro_torch/csrc/quantize.cu`;
its head comment says what bounds it on an H100 and how the design
answers that. One source computes two groupings: the TPU kernels' tile
form (one scale per block x block tile) and the wire codec's grouped
form (one scale per row of a [G, L] view: the whole segment, or one pod
slice), which `control/schedule.py::wire_encode` runs on.

This module binds the library (built at first use by
:mod:`repro_torch.kernels.build`) and launches it. Call it through
:func:`repro_torch.kernels.ops.quantize` / `dequantize` (tile form) or
`quantize_groups` / `dequantize_groups`, which check the inputs, take
the plain version for CPU tensors and count launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

BLOCK = 256
MAX_GROUPS = 65535      # grid rows (csrc/quantize.cu quantize_max_groups)
BITS = range(2, 9)      # payloads that fit int8

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def qmax(bits: int) -> float:
    """The largest payload magnitude at `bits`: 2^(bits-1) - 1."""
    return float((1 << (int(bits) - 1)) - 1)


def inv_qmax(bits: int) -> np.float32:
    """The f32 reciprocal of qmax that both versions multiply the
    abs-max by (XLA rewrites the reference's `amax / qmax` into this
    multiply, in the TPU kernel and in the jitted wire codec)."""
    return np.float32(1.0) / np.float32(qmax(bits))


def _lib() -> ctypes.CDLL:
    lib = build.load("quantize")
    if not getattr(lib, "_typed", False):
        lib.quantize_tile_launch.argtypes = [_P, _P, _P, _I, _L, _L, _I, _F,
                                             _F, _P]
        lib.dequantize_tile_launch.argtypes = [_P, _P, _P, _I, _L, _L, _I,
                                               _P]
        lib.quantize_groups_launch.argtypes = [_P, _L, _P, _P, _P, _L, _I,
                                               _L, _L, _F, _F, _P]
        lib.quantize_groups_blocks.argtypes = [_I]
        lib.dequantize_groups_launch.argtypes = [_P, _P, _P, _I, _L, _L, _P]
        lib.dequantize_groups_add_launch.argtypes = [_P, _P, _P, _L, _L, _L,
                                                     _P]
        for fn in ("quantize_tile_launch", "dequantize_tile_launch",
                   "quantize_groups_launch", "quantize_groups_blocks",
                   "dequantize_groups_launch",
                   "dequantize_groups_add_launch", "quantize_max_groups"):
            getattr(lib, fn).restype = _I
        lib.quantize_error_string.argtypes = [_I]
        lib.quantize_error_string.restype = ctypes.c_char_p
        lib.quantize_max_groups.argtypes = []
        if lib.quantize_max_groups() != MAX_GROUPS:
            raise RuntimeError(f"quantize library takes "
                               f"{lib.quantize_max_groups()} groups, not "
                               f"{MAX_GROUPS}")
        lib._typed = True
    return lib


def _run(t: torch.Tensor, launch) -> None:
    lib = _lib()
    with torch.cuda.device(t.device):
        err = launch(lib, torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        msg = lib.quantize_error_string(err).decode()
        raise RuntimeError(f"quantize launch failed: {msg} ({err})")


def launch_tile(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bits: int, block: int) -> None:
    """Quantize x [n, d] per tile into q and scale [n/block, d/block] on
    the current stream of x's device; inputs are checked by the caller.
    Raises if a launch was refused."""
    n, d = x.shape
    _run(x, lambda lib, st: lib.quantize_tile_launch(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        int(x.dtype == torch.bfloat16), n, d, block, qmax(bits),
        float(inv_qmax(bits)), st))


def launch_dequant_tile(q: torch.Tensor, scale: torch.Tensor,
                        out: torch.Tensor, block: int) -> None:
    """out = q * (its tile's scale), in out's dtype."""
    n, d = q.shape
    _run(q, lambda lib, st: lib.dequantize_tile_launch(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.bfloat16), n, d, block, st))


_GROUP_BLOCKS = {}


def group_scratch_words(x: torch.Tensor) -> int:
    """32-bit words of scratch the grouped quantize of x [G, L] needs on
    x's device: G, plus 2 per block of its grid (at most the kernel's
    co-resident blocks, found once per device and dtype)."""
    key = (x.device.index, x.dtype)
    if key not in _GROUP_BLOCKS:
        lib = _lib()
        with torch.cuda.device(x.device):
            n = lib.quantize_groups_blocks(int(x.dtype == torch.bfloat16))
        if n <= 0:
            msg = lib.quantize_error_string(-n).decode()
            raise RuntimeError(f"quantize_groups occupancy: {msg} ({-n})")
        _GROUP_BLOCKS[key] = n
    return x.shape[0] + 2 * _GROUP_BLOCKS[key]


def launch_groups(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                  scratch: torch.Tensor, bits: int) -> None:
    """Quantize each row of x [G, L] (unit column stride, rows
    x.stride(0) apart) with its own scale into q (contiguous [G, L]) and
    scale [G], in one cooperative launch; `scratch` holds at least
    `group_scratch_words(x)` 32-bit words and needs no zeroing."""
    G, L = x.shape
    ldx = x.stride(0) if G > 1 else L
    _run(x, lambda lib, st: lib.quantize_groups_launch(
        x.data_ptr(), ldx, q.data_ptr(), scale.data_ptr(),
        scratch.data_ptr(), scratch.numel(),
        int(x.dtype == torch.bfloat16), G, L, qmax(bits),
        float(inv_qmax(bits)), st))


def launch_dequant_groups(q: torch.Tensor, scale: torch.Tensor,
                          out: torch.Tensor) -> None:
    """out[g] = q[g] * scale[g], in out's dtype."""
    G, L = q.shape
    _run(q, lambda lib, st: lib.dequantize_groups_launch(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.bfloat16), G, L, st))


def launch_dequant_groups_add(q: torch.Tensor, scale: torch.Tensor,
                              acc: torch.Tensor) -> None:
    """acc[g] = fmaf(q[g], scale[g], acc[g]) in place; acc f32 [G, L]
    with unit column stride and rows acc.stride(0) apart."""
    G, L = q.shape
    _run(q, lambda lib, st: lib.dequantize_groups_add_launch(
        q.data_ptr(), scale.data_ptr(), acc.data_ptr(), G, L,
        acc.stride(0), st))
