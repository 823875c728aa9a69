"""Public wrappers of the port's kernels.

Each wrapper checks device, type, shape and contiguity, and raises on
anything its kernel does not take. It runs the plain version
(`ref.py`) only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises — there is no fallback. Each keeps a plain
integer count of kernel launches (`<wrapper>.launches`), which a run
reads to show that its main path went through the kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import rf_predict as _rf
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import rf_predict_ref, ssd_chunk_ref


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
