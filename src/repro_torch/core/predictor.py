"""Runtime-BW prediction (paper §3.1): Table-3 feature assembly + forest
inference. Inference has three interchangeable backends:
  numpy  — RandomForest.predict (training-side; divides the sum by T,
           so it is not bit-equal to the other two)
  torch  — kernels.ref.rf_predict_ref (the plain PyTorch version, any
           device)
  cuda   — kernels.ops.rf_predict on a CUDA device (the hand-written
           kernel; bit-equal to the torch backend)
Unless the caller names one, the backend follows the predictor's
device: `cuda` on the card (the default device), `torch` for
``device="cpu"``.

Port of `repro/core/predictor.py`, whose `jnp` and `pallas` backends
these replace (the reference's `forest_predict_jnp` is
`rf_predict_ref` here).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.forest import RandomForest
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rf_predict_ref
from repro_torch.kernels.rf_predict import pack_nodes

FEATURE_NAMES = ("n_dcs", "snapshot_bw", "mem_util", "cpu_load",
                 "retransmissions", "distance_miles")


def assemble_features(n_dcs: int, snap_bw: np.ndarray, mem_util: np.ndarray,
                      cpu_load: np.ndarray, retrans: np.ndarray,
                      dist: np.ndarray) -> np.ndarray:
    """Vectorize Table 3 into per-pair rows.

    snap_bw/retrans/dist: [N,N]; mem_util (receiver)/cpu_load (sender): [N].
    Returns X [N*(N-1), 6] for all ordered off-diagonal pairs, in
    row-major (i, j) order skipping the diagonal (built as one [N,N,6]
    block with the diagonal masked out)."""
    snap_bw = np.asarray(snap_bw)
    N = snap_bw.shape[0]
    block = np.empty((N, N, 6), np.float64)
    block[:, :, 0] = float(n_dcs)
    block[:, :, 1] = snap_bw
    block[:, :, 2] = np.asarray(mem_util)[None, :]       # receiver j
    block[:, :, 3] = np.asarray(cpu_load)[:, None]       # sender i
    block[:, :, 4] = np.asarray(retrans)
    block[:, :, 5] = np.asarray(dist)
    off = ~np.eye(N, dtype=bool)
    return block[off].astype(np.float32)


def matrix_from_pairs(vals: np.ndarray, N: int,
                      diag: float = 0.0) -> np.ndarray:
    """Inverse of `assemble_features`'s row order: fold N*(N-1)
    per-pair values back into an [N,N] matrix with `diag` filled in
    (one boolean-mask scatter in row-major order)."""
    out = np.full((N, N), diag, np.float64)
    out[~np.eye(N, dtype=bool)] = np.asarray(vals, np.float64)
    return out


@dataclass
class BwPredictor:
    """End-to-end: snapshot features -> predicted runtime BW matrix.
    `device` serves the torch and cuda backends and picks the default
    one (None = CUDA, which raises without a card)."""
    forest: RandomForest
    device: Optional[Union[str, torch.device]] = None
    # per device: (a copy of the forest's arrays as packed, their
    # tensors, the kernel's nodes)
    _on_device: Dict[torch.device, tuple] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    def forest_on(self, dev: torch.device):
        """The forest's (feat, thr, leaf) tensors and the kernel's node
        layout on `dev`: moved and packed once per device, again
        whenever the forest's arrays differ from the copy packed last —
        a refit swapped in (`predictor.forest = new`, the lifecycle's
        refresh), a warm fit, or arrays rewritten in place — so the
        next launch always reads the forest in force."""
        arrays = self.forest.packed()
        hit = self._on_device.get(dev)
        if hit is None or any(a.dtype != b.dtype or a.shape != b.shape
                              or a.tobytes() != b.tobytes()
                              for a, b in zip(hit[0], arrays)):
            host = tuple(np.array(a, order="C") for a in arrays)
            tensors = [torch.from_numpy(a).to(dev) for a in host]
            hit = (host, tensors, pack_nodes(tensors[0], tensors[1]))
            self._on_device[dev] = hit
        return hit[1], hit[2]

    def predict_matrix(self, n_dcs: int, snap_bw: np.ndarray,
                       mem_util: np.ndarray, cpu_load: np.ndarray,
                       retrans: np.ndarray, dist: np.ndarray,
                       intra_dc_bw: float = 10000.0,
                       backend: Optional[str] = None) -> np.ndarray:
        """Snapshot features -> predicted runtime BW matrix [N,N]
        (floored at 1 Mbps, `intra_dc_bw` on the diagonal); `backend`
        picks numpy / torch / cuda inference (None: by the device)."""
        X = assemble_features(n_dcs, snap_bw, mem_util, cpu_load,
                              retrans, dist)
        if backend == "numpy":
            vals = self.forest.predict(X)
        elif backend in (None, "torch", "cuda"):
            dev = resolve_device(self.device)
            if backend is None:
                backend = "cuda" if dev.type == "cuda" else "torch"
            if backend == "cuda" and dev.type != "cuda":
                raise ValueError("backend 'cuda' needs a CUDA device, "
                                 f"got {dev}")
            packed, nodes = self.forest_on(dev)
            Xt = torch.from_numpy(X).to(dev)
            if backend == "torch":
                out = rf_predict_ref(*packed, Xt, self.forest.depth)
            else:
                out = ops.rf_predict(*packed, Xt, depth=self.forest.depth,
                                     nodes=nodes)
            vals = out.cpu().numpy()
        else:
            raise ValueError(backend)
        vals = np.maximum(vals, 1.0)             # BW is positive
        return matrix_from_pairs(vals, snap_bw.shape[0], diag=intra_dc_bw)


@dataclass
class SnapshotPredictor:
    """No-RF ablation backend: trust the 1-second snapshot as-is (the
    paper's no-prediction baseline). Drop-in for :class:`BwPredictor`
    wherever training a forest is overkill — controller tests,
    lightweight serve-side control planes."""

    def predict_matrix(self, n_dcs: int, snap_bw: np.ndarray,
                       mem_util: np.ndarray, cpu_load: np.ndarray,
                       retrans: np.ndarray, dist: np.ndarray,
                       intra_dc_bw: float = 10000.0,
                       backend: Optional[str] = None) -> np.ndarray:
        """Return the snapshot itself as the 'prediction' (`backend`
        is accepted for interface parity and ignored)."""
        out = np.maximum(np.asarray(snap_bw, np.float64).copy(), 1.0)
        np.fill_diagonal(out, intra_dc_bw)
        return out
