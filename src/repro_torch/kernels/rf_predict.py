"""Random-forest ensemble inference: the hand-written CUDA kernel.

Port of `repro/kernels/rf_predict.py::rf_predict_pallas`. The kernel
source is `repro_torch/csrc/rf_predict.cu`; its head comment says what
bounds it on an H100 and how the design answers that: 8-byte nodes,
and for a batch a warp walking one tree for 32 samples (several trees
side by side) in a persistent grid; for a few rows one thread per
(sample, tree). The TPU kernel's one-hot contractions, a workaround
for the TPU's lack of a dynamic gather, are not carried over.

This module packs a forest's nodes (:func:`pack_nodes`, once per
forest and device), picks the kernel (:func:`launch_shape`),
binds the library (built at first use by
:mod:`repro_torch.kernels.build`) and launches it. Call it through
:func:`repro_torch.kernels.ops.rf_predict`, which checks the inputs,
takes the plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build

SMEM_LIMIT = 232448      # opt-in dynamic shared memory of one block
PAIR_SMEM_LIMIT = 48 * 1024
TILE = 32                # samples a tile: one per lane
ILP = 4                  # trees a warp walks side by side (kIlp)
MAX_WARPS = 32
BATCH_WARPS = 8          # warps a tile-kernel block once tiles fill the card
PAIR_ROWS = 1024         # at most this many rows: the pair kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load("rf_predict")
    if not getattr(lib, "_typed", False):
        lib.rf_predict_tile_launch.argtypes = [_P] * 4 + [_I] * 5 + [_F, _P]
        lib.rf_predict_tile_launch.restype = _I
        lib.rf_predict_pair_launch.argtypes = [_P] * 4 + [_I] * 5 + [_F, _P]
        lib.rf_predict_pair_launch.restype = _I
        lib.rf_predict_pair_threads.argtypes = []
        lib.rf_predict_pair_threads.restype = _I
        lib.rf_predict_empty_launch.argtypes = [_P]
        lib.rf_predict_empty_launch.restype = _I
        lib.rf_predict_error_string.argtypes = [_I]
        lib.rf_predict_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def inv_trees(n_trees: int) -> np.float32:
    """The f32 reciprocal of T that both versions multiply the sum by
    (the reference's XLA rewrites `acc / T` into this multiply)."""
    return np.float32(1.0) / np.float32(n_trees)


def pack_nodes(feat: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """The kernel's node layout: feat [T, 2^d-1] int32 and thr [T, 2^d-1]
    f32 -> [T, 2^d-1, 2] int32, node k of tree t being {feat, the bits
    of thr}, 8 bytes, so one load reads both. Built on the tensors'
    device; hold it beside the forest rather than packing per call."""
    if feat.dtype != torch.int32 or thr.dtype != torch.float32 or \
            feat.shape != thr.shape or feat.device != thr.device:
        raise ValueError("pack_nodes takes feat int32 and thr float32 of "
                         "one shape on one device")
    return torch.stack([feat, thr.view(torch.int32)], dim=-1).contiguous()


def tile_smem_bytes(n_trees: int, n_feat: int) -> int:
    """Shared memory of a tile-kernel block, as csrc/rf_predict.cu lays
    it out: leaf values [2][T][32] f32 and rows [2][32][stride] f32
    (one tile walked, the one before summed), the stride F+1 rounded up
    to odd."""
    return 2 * (n_trees + ((n_feat + 1) | 1)) * TILE * 4


def samples_per_block(n_trees: int, n_feat: int, threads: int = 256) -> int:
    """Samples a pair-kernel block takes: enough that its (sample, tree)
    pairs fill the block's threads, within 48 KB of shared memory."""
    spb = max(1, threads // n_trees)
    if spb * (n_feat + n_trees) * 4 > PAIR_SMEM_LIMIT:
        raise ValueError(f"{n_trees} trees x {n_feat} features exceed a "
                         f"pair-kernel block's {PAIR_SMEM_LIMIT} bytes")
    return spb


@dataclass(frozen=True)
class LaunchShape:
    """Which kernel a call runs: "pair" (one thread per (sample, tree))
    or "tile" (a warp per tree and 32 samples) with `warps` a block."""
    kernel: str
    warps: int = 0


def launch_shape(n: int, n_trees: int, n_feat: int, sms: int) -> LaunchShape:
    """The pair kernel for at most PAIR_ROWS rows; else the tile kernel,
    with warps enough to walk a tile's trees, ILP a warp, in one round
    while the tiles fit the SMs once and in two while they fit twice
    (latency is the time there), and BATCH_WARPS beyond (the gathers'
    traffic is). Thresholds measured on an H100 (PERF.md, rf_predict)."""
    if n <= PAIR_ROWS:
        samples_per_block(n_trees, n_feat)
        return LaunchShape("pair")
    if tile_smem_bytes(n_trees, n_feat) > SMEM_LIMIT:
        raise ValueError(f"{n_trees} trees x {n_feat} features exceed one "
                         f"block's {SMEM_LIMIT} bytes of shared memory")
    tiles = -(-n // TILE)
    if tiles <= 2 * sms:
        rounds = 1 if tiles <= sms else 2
        warps = min(MAX_WARPS, -(-n_trees // (ILP * rounds)))
    else:
        warps = min(BATCH_WARPS, -(-n_trees // ILP))
    return LaunchShape("tile", max(1, warps))


def launch(nodes: torch.Tensor, leaf: torch.Tensor, X: torch.Tensor,
           out: torch.Tensor, depth: int,
           shape: Optional[LaunchShape] = None) -> LaunchShape:
    """Launch one kernel on the current stream of X's device; inputs are
    checked by the caller. `shape` None picks :func:`launch_shape`.
    Returns the shape launched; raises if the launch was refused."""
    lib = _lib()
    n, F = X.shape
    T = nodes.shape[0]
    if shape is None:
        sms = torch.cuda.get_device_properties(
            X.device).multi_processor_count
        shape = launch_shape(n, T, F, sms)
    args = (nodes.data_ptr(), leaf.data_ptr(), X.data_ptr(),
            out.data_ptr(), n, F, T, depth)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        if shape.kernel == "pair":
            err = lib.rf_predict_pair_launch(
                *args, samples_per_block(T, F, lib.rf_predict_pair_threads()),
                float(inv_trees(T)), stream)
        elif shape.kernel == "tile" and 1 <= shape.warps <= MAX_WARPS:
            err = lib.rf_predict_tile_launch(
                *args, shape.warps, float(inv_trees(T)), stream)
        else:
            raise ValueError(f"bad launch shape {shape}")
    if err != 0:
        msg = lib.rf_predict_error_string(err).decode()
        raise RuntimeError(f"rf_predict launch failed: {msg} ({err}) at "
                           f"{shape}")
    return shape
