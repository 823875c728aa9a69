"""Public wrappers of the port's kernels.

Each wrapper checks device, type, shape and contiguity, and raises on
anything its kernel does not take. It runs the plain version
(`ref.py`) only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises — there is no fallback. Each keeps a plain
integer count of kernel launches (`<wrapper>.launches`), which a run
reads to show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import rf_predict as _rf
from repro_torch.kernels.ref import rf_predict_ref


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


def rf_predict(feat: torch.Tensor, thr: torch.Tensor, leaf: torch.Tensor,
               X: torch.Tensor, depth: int) -> torch.Tensor:
    """Forest inference over packed trees: X [n, F] -> [n] f32.

    CUDA tensors go to the hand-written kernel (csrc/rf_predict.cu);
    CPU tensors to :func:`repro_torch.kernels.ref.rf_predict_ref`. Both
    sum the trees in tree order in f32 and multiply by the f32
    reciprocal of T, bit-equal to the JAX package's `rf_predict`."""
    _check_rf(feat, thr, leaf, X, depth)
    if X.device.type == "cpu":
        return rf_predict_ref(feat, thr, leaf, X, int(depth))
    if X.device.type != "cuda":
        raise ValueError(f"rf_predict runs on cuda or cpu, not {X.device}")
    out = torch.empty(X.shape[0], dtype=torch.float32, device=X.device)
    if X.shape[0] == 0:
        return out
    _rf.launch(feat, thr, leaf, X, out, int(depth))
    rf_predict.launches += 1
    return out


rf_predict.launches = 0
