"""From-scratch CART Random-Forest regressor (paper §3.1).

Training is pure numpy (no sklearn available offline). Trees are stored
in a COMPLETE-BINARY-TREE array layout of fixed depth — node k's children
are 2k+1 / 2k+2 — so inference is branch-free index arithmetic rather
than pointer chasing. The CUDA kernel (kernels/rf_predict.py) walks
that layout with `depth` dependent indexed loads per (sample, tree).

Port of `repro/core/forest.py`: training is the same host numpy code,
so a fit with the same data and seed packs to the same arrays, and
:meth:`RandomForest.from_packed` adopts a forest fitted elsewhere.

Supports warm-start retraining (§3.3.4): ``fit(..., warm=True)`` keeps
existing trees and appends new ones trained on the fresh data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


# ----------------------------------------------------------------------
# Single-tree CART (MSE split criterion)
# ----------------------------------------------------------------------
def _best_split(X: np.ndarray, y: np.ndarray, feat_idx: np.ndarray,
                min_leaf: int) -> Optional[Tuple[int, float]]:
    """Best (feature, threshold) by SSE reduction over candidate features."""
    n = len(y)
    if n < 2 * min_leaf:
        return None
    best_gain, best = 0.0, None
    sse_parent = float(np.sum((y - y.mean()) ** 2))
    for f in feat_idx:
        order = np.argsort(X[:, f], kind="stable")
        xs, ys = X[order, f], y[order]
        csum = np.cumsum(ys)
        csq = np.cumsum(ys ** 2)
        tot, tot2 = csum[-1], csq[-1]
        ks = np.arange(min_leaf, n - min_leaf + 1)
        if len(ks) == 0:
            continue
        valid = xs[ks - 1] < xs[np.minimum(ks, n - 1)]   # distinct boundary
        if not valid.any():
            continue
        ks = ks[valid]
        sl, sl2 = csum[ks - 1], csq[ks - 1]
        nl = ks.astype(np.float64)
        nr = n - nl
        sse = (sl2 - sl ** 2 / nl) + ((tot2 - sl2) - (tot - sl) ** 2 / nr)
        i = int(np.argmin(sse))
        gain = sse_parent - float(sse[i])
        if gain > best_gain + 1e-12:
            k = int(ks[i])
            thr = 0.5 * (xs[k - 1] + xs[k])
            best_gain, best = gain, (int(f), float(thr))
    return best


def _fit_tree(X: np.ndarray, y: np.ndarray, depth: int, min_leaf: int,
              n_feats: int, rng: np.random.Generator
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (feat[2^d-1] int32, thr[2^d-1] f32, leaf[2^d] f32)."""
    n_int = 2 ** depth - 1
    feat = np.full(n_int, -1, np.int32)
    # pass-through sentinel: feature -1 with a LARGE FINITE threshold
    # (x > 1e30 is always False => go left). Finite, not inf, so the
    # one-hot contraction of the JAX package's TPU kernel never
    # multiplies 0 * inf = NaN (the layout is shared with it).
    thr = np.full(n_int, 1e30, np.float32)
    leaf = np.zeros(2 ** depth, np.float32)

    def recurse(node: int, idx: np.ndarray, lvl: int):
        """Grow the subtree at `node` over samples `idx`."""
        ys = y[idx]
        if lvl == depth:
            leaf[node - n_int] = float(ys.mean()) if len(ys) else 0.0
            return
        split = None
        if len(idx) >= 2 * min_leaf and ys.std() > 1e-9:
            fs = rng.choice(X.shape[1], size=min(n_feats, X.shape[1]),
                            replace=False)
            split = _best_split(X[idx], ys, fs, min_leaf)
        if split is None:
            # fill entire subtree with the node mean (pass-through)
            val = float(ys.mean()) if len(ys) else 0.0
            stack = [(node, lvl)]
            while stack:
                nd, lv = stack.pop()
                if lv == depth:
                    leaf[nd - n_int] = val
                else:
                    stack.append((2 * nd + 1, lv + 1))
                    stack.append((2 * nd + 2, lv + 1))
            return
        f, t = split
        feat[node], thr[node] = f, t
        mask = X[idx, f] <= t
        recurse(2 * node + 1, idx[mask], lvl + 1)
        recurse(2 * node + 2, idx[~mask], lvl + 1)

    recurse(0, np.arange(len(y)), 0)
    return feat, thr, leaf


# ----------------------------------------------------------------------
# Forest
# ----------------------------------------------------------------------
@dataclass
class RandomForest:
    """Bootstrap-aggregated CART regressor in the complete-binary-tree
    array layout (`feat`/`thr`/`leaf` stacked per tree) — the form the
    torch and CUDA inference backends consume directly."""

    n_trees: int = 100
    depth: int = 10
    min_leaf: int = 1
    feature_frac: float = 0.6
    seed: int = 0
    # flattened model (set by fit)
    feat: Optional[np.ndarray] = None     # [T, 2^d - 1] int32
    thr: Optional[np.ndarray] = None      # [T, 2^d - 1] f32
    leaf: Optional[np.ndarray] = None     # [T, 2^d] f32

    def fit(self, X: np.ndarray, y: np.ndarray, warm: bool = False,
            n_new: Optional[int] = None) -> "RandomForest":
        """Fit on bootstrap resamples; ``warm=True`` keeps existing
        trees and appends `n_new` (default n_trees/4) trained on the
        fresh data (§3.3.4 retraining)."""
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        rng = np.random.default_rng(self.seed if not warm else self.seed + 1)
        n_feats = max(1, int(round(self.feature_frac * X.shape[1])))
        add = self.n_trees if not warm else (n_new or max(self.n_trees // 4, 1))
        feats, thrs, leaves = [], [], []
        for _ in range(add):
            idx = rng.integers(0, len(y), size=len(y))      # bootstrap
            f, t, l = _fit_tree(X[idx], y[idx], self.depth, self.min_leaf,
                                n_feats, rng)
            feats.append(f)
            thrs.append(t)
            leaves.append(l)
        newf = np.stack(feats)
        newt = np.stack(thrs)
        newl = np.stack(leaves)
        if warm and self.feat is not None:
            self.feat = np.concatenate([self.feat, newf])
            self.thr = np.concatenate([self.thr, newt])
            self.leaf = np.concatenate([self.leaf, newl])
        else:
            self.feat, self.thr, self.leaf = newf, newt, newl
        return self

    def spawn(self, seed: Optional[int] = None) -> "RandomForest":
        """An UNFITTED forest with this forest's hyperparameters (and
        `seed`, default: same seed). The online-refresh path
        (the predictor lifecycle) fits the spawn on fresh data and swaps it in
        as one reference assignment, so a consumer never observes a
        half-retrained model: the packed (feat, thr, leaf) tensors
        always come from exactly one completed fit."""
        return RandomForest(n_trees=self.n_trees, depth=self.depth,
                            min_leaf=self.min_leaf,
                            feature_frac=self.feature_frac,
                            seed=self.seed if seed is None else int(seed))

    # ------------------------------------------------------------------
    def predict(self, X: np.ndarray) -> np.ndarray:
        """Reference numpy inference over the complete-tree layout."""
        assert self.feat is not None, "fit first"
        X = np.asarray(X, np.float32)
        n, T = X.shape[0], self.feat.shape[0]
        node = np.zeros((T, n), np.int64)
        for _ in range(self.depth):
            f = self.feat[np.arange(T)[:, None], node]       # [T,n]
            t = self.thr[np.arange(T)[:, None], node]
            fx = np.where(f < 0, 0, f)
            go_right = X[np.arange(n)[None, :], fx] > t
            node = 2 * node + 1 + go_right.astype(np.int64)
        leaf_idx = node - (2 ** self.depth - 1)
        vals = self.leaf[np.arange(T)[:, None], leaf_idx]
        return vals.mean(axis=0)

    def score(self, X: np.ndarray, y: np.ndarray) -> float:
        """R^2."""
        p = self.predict(X)
        y = np.asarray(y, np.float64)
        ss = np.sum((y - p) ** 2)
        st = np.sum((y - y.mean()) ** 2)
        return float(1.0 - ss / max(st, 1e-12))

    def training_accuracy(self, X, y, tol_frac: float = 0.1) -> float:
        """Fraction of predictions within tol_frac of truth (the paper
        reports 98.51% 'training accuracy')."""
        p = self.predict(X)
        y = np.asarray(y, np.float64)
        return float(np.mean(np.abs(p - y) <= tol_frac * np.maximum(y, 1.0)))

    def packed(self):
        """The (feat, thr, leaf) arrays the torch/CUDA kernels take."""
        return self.feat, self.thr, self.leaf

    @classmethod
    def from_packed(cls, feat: np.ndarray, thr: np.ndarray,
                    leaf: np.ndarray, depth: int,
                    **hyper) -> "RandomForest":
        """A fitted forest from packed arrays (e.g. the JAX package's
        ``RandomForest.packed()``) and its hyperparameters
        (`n_trees`, `min_leaf`, `feature_frac`, `seed`). Checks the
        complete-tree shapes: feat/thr [T, 2^depth-1], leaf
        [T, 2^depth]."""
        feat = np.ascontiguousarray(feat, np.int32)
        thr = np.ascontiguousarray(thr, np.float32)
        leaf = np.ascontiguousarray(leaf, np.float32)
        T = feat.shape[0]
        n_int = 2 ** int(depth) - 1
        if feat.shape != (T, n_int) or thr.shape != (T, n_int) \
                or leaf.shape != (T, n_int + 1):
            raise ValueError(
                f"packed shapes {feat.shape}/{thr.shape}/{leaf.shape} do "
                f"not form complete trees of depth {depth}")
        hyper.setdefault("n_trees", T)
        rf = cls(depth=int(depth), **hyper)
        rf.feat, rf.thr, rf.leaf = feat, thr, leaf
        return rf
