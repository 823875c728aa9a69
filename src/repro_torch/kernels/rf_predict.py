"""Random-forest ensemble inference: the hand-written CUDA kernel.

Port of `repro/kernels/rf_predict.py::rf_predict_pallas`. The kernel
source is `repro_torch/csrc/rf_predict.cu`; its head comment says what
bounds it on an H100 and how the design answers that. It runs one
thread per (sample, tree) pair with direct indexed loads; the TPU
kernel's one-hot contractions, a workaround for the TPU's lack of a
dynamic gather, are not carried over.

This module binds the library (built at first use by
:mod:`repro_torch.kernels.build`) and launches it. Call it through
:func:`repro_torch.kernels.ops.rf_predict`, which checks the inputs,
takes the plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

SMEM_LIMIT = 48 * 1024      # default dynamic shared memory of one block

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("rf_predict")
    if not getattr(lib, "_typed", False):
        lib.rf_predict_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                          _I, _I, ctypes.c_float, _P]
        lib.rf_predict_launch.restype = _I
        lib.rf_predict_error_string.argtypes = [_I]
        lib.rf_predict_error_string.restype = ctypes.c_char_p
        lib.rf_predict_threads.argtypes = []
        lib.rf_predict_threads.restype = _I
        lib._typed = True
    return lib


def inv_trees(n_trees: int) -> np.float32:
    """The f32 reciprocal of T that both versions multiply the sum by
    (the reference's XLA rewrites `acc / T` into this multiply)."""
    return np.float32(1.0) / np.float32(n_trees)


def samples_per_block(n_trees: int, n_feat: int, threads: int) -> int:
    """Samples one block takes: enough that its (sample, tree) pairs
    fill the block's threads, within the shared-memory limit."""
    spb = max(1, threads // n_trees)
    if spb * (n_feat + n_trees) * 4 > SMEM_LIMIT:
        raise ValueError(f"{n_trees} trees x {n_feat} features exceed one "
                         f"block's {SMEM_LIMIT} bytes of shared memory")
    return spb


def launch(feat: torch.Tensor, thr: torch.Tensor, leaf: torch.Tensor,
           X: torch.Tensor, out: torch.Tensor, depth: int) -> None:
    """Launch the kernel on the current stream of X's device; inputs
    are checked by the caller. Raises if the launch was refused."""
    lib = _lib()
    n, F = X.shape
    T = feat.shape[0]
    spb = samples_per_block(T, F, lib.rf_predict_threads())
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.rf_predict_launch(
            feat.data_ptr(), thr.data_ptr(), leaf.data_ptr(), X.data_ptr(),
            out.data_ptr(), n, F, T, depth, spb, float(inv_trees(T)),
            stream)
    if err != 0:
        msg = lib.rf_predict_error_string(err).decode()
        raise RuntimeError(f"rf_predict launch failed: {msg} ({err})")
