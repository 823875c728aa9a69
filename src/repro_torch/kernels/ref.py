"""Plain PyTorch versions of the port's kernels (the CPU path and the
oracle the CUDA kernels are held against on the card)."""
from __future__ import annotations

import torch

from repro_torch.kernels.rf_predict import inv_trees


# ----------------------------------------------------------------------
# Random-forest inference (complete-binary-tree layout)
# ----------------------------------------------------------------------
def rf_predict_ref(feat: torch.Tensor, thr: torch.Tensor,
                   leaf: torch.Tensor, X: torch.Tensor,
                   depth: int) -> torch.Tensor:
    """feat [T, 2^d-1] int32, thr [T, 2^d-1] f32, leaf [T, 2^d] f32,
    X [n, F] f32 -> [n] f32, with the kernel's arithmetic in its order:
    descend with x[max(feat,0)] > thr (a feature index past the row
    reads 0), add the leaf values tree by tree in f32, then multiply
    by the f32 reciprocal of T."""
    T, n_int = feat.shape
    n, F = X.shape
    rows = torch.arange(n, device=X.device)[None, :]
    node = torch.zeros((T, n), dtype=torch.int64, device=X.device)
    for _ in range(depth):
        f = torch.gather(feat, 1, node).clamp(min=0).long()
        t = torch.gather(thr, 1, node)
        xv = X[rows, f.clamp(max=F - 1)]
        xv = torch.where(f < F, xv, torch.zeros_like(xv))
        node = 2 * node + 1 + (xv > t).long()
    vals = torch.gather(leaf, 1, node - n_int)               # [T, n]
    acc = torch.zeros(n, dtype=torch.float32, device=X.device)
    for t in range(T):                                        # tree order
        acc = acc + vals[t]
    inv = torch.tensor(float(inv_trees(T)), dtype=torch.float32,
                       device=X.device)
    return acc * inv
