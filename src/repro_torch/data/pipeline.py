"""Deterministic synthetic data pipeline with per-pod skew.

A copy of `repro/data/pipeline.py` (numpy only): the same seed gives
the same tokens bit for bit, which the Trainer's replans read through
the skew weights. Skew mode draws token-ids from pod-dependent
distributions, creating the per-pod load imbalance that feeds WANify's
w_s (§3.3.1). Host-side double-buffered prefetch hides generation
latency.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class DataConfig:
    """A global batch's shape, the pods it spans, their skew, the seed."""

    batch: int
    seq: int
    vocab: int
    n_pods: int = 1
    skew: float = 0.0          # 0 = iid across pods; 1 = fully disjoint
    seed: int = 0


def _pod_batch(rng: np.random.Generator, c: DataConfig, pod: int,
               per_pod: int) -> np.ndarray:
    """Zipf-ish tokens with a pod-dependent offset when skewed."""
    base = rng.zipf(1.3, size=(per_pod, c.seq + 1)).astype(np.int64)
    tok = (base - 1) % c.vocab
    if c.skew > 0:
        width = max(1, int(c.vocab * (1 - c.skew) / c.n_pods))
        lo = (pod * c.vocab) // c.n_pods
        tok = lo + tok % max(width, 1)
    return tok % c.vocab


def batches(cfg: ModelConfig, c: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Global batches {tokens, targets} [batch, seq] int32, pod by pod
    along the batch axis (the modality stubs of the enc-dec and VLM
    families as in the reference)."""
    rng = np.random.default_rng(c.seed)
    per_pod = c.batch // max(c.n_pods, 1)
    while True:
        toks = np.concatenate(
            [_pod_batch(rng, c, p, per_pod) for p in range(max(c.n_pods, 1))])
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "targets": toks[:, 1:].astype(np.int32)}
        if cfg.is_encdec:
            out["enc_frames"] = rng.normal(
                0, 1, (c.batch, cfg.encoder.source_len, cfg.encoder.d_model)
            ).astype(np.float32)
        if cfg.is_vlm:
            out["patch_embeds"] = rng.normal(
                0, 0.02, (c.batch, cfg.encoder.source_len, cfg.d_model)
            ).astype(np.float32)
        yield out


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """`it` produced by a daemon thread, `depth` items ahead."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item


def pod_skew_weights(batch_tokens: np.ndarray, n_pods: int,
                     vocab: int) -> np.ndarray:
    """Data-volume proxy per pod (w_s input): entropy-weighted token mass.
    Skewed pods concentrate tokens -> heavier shuffle volume."""
    per = np.split(batch_tokens, n_pods, axis=0)
    weights = []
    for chunk in per:
        _, counts = np.unique(chunk, return_counts=True)
        p = counts / counts.sum()
        ent = -(p * np.log(p + 1e-12)).sum()
        weights.append(1.0 + 1.0 / max(ent, 0.3))
    w = np.asarray(weights)
    return w / w.mean()
