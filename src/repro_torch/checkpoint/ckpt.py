"""Checkpoints with a manifest, in the JAX package's on-disk layout.

Layout:  <dir>/step_<N>/
           manifest.json        {step, shards, leaf names, dtypes, done}
           shard_<i>.npz        the leaves (a new shard every 512 MiB)

The leaf names are `jax.tree_util.keystr` of the reference's tree
(`['p']['blocks']['attn']['wq']`, dict keys in sorted order), so a
checkpoint of the reference's tree written by either package restores
in the other, weights and optimizer state alike. Writes are atomic (a
temporary directory, then a rename), so a crash mid-write never
corrupts the restore point; `latest_step` only returns manifests marked
done. Leaves are stored gathered, so a restart may use any pod count.

bfloat16 leaves are stored as their raw unsigned integers with the
dtype's name in the manifest, as the reference stores them (and its
float8 ones); they are read back through a torch view, so nothing here
needs `ml_dtypes`.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SHARD_BYTES = 512 << 20


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) in `jax.tree_util` order: dict keys sorted,
    sequences by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of the tensor that npz can store, and its dtype's
    name (bfloat16 as uint16)."""
    t = t.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    name = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _decode(arr: np.ndarray, name: str) -> torch.Tensor:
    """A tensor over a freshly loaded array (no copy), its dtype
    restored from the manifest's name."""
    t = torch.from_numpy(np.asarray(arr, order="C"))
    if name == "bfloat16":
        return t.view(torch.int16).view(torch.bfloat16)
    if name.startswith("float8"):
        return t.view(getattr(torch, name))
    return t


def save(ckpt_dir: str, step: int, tree: Any, *, async_: bool = False
         ) -> Optional[threading.Thread]:
    """Atomic checkpoint write of a tree of tensors. The leaves are
    copied to the host before it returns, so the caller
    may update its tensors in place at once; async_=True writes the
    files on a thread and returns it (the next train steps overlap the
    write)."""
    items = [(name, *_encode(leaf)) for name, leaf in _flatten(tree)]

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
        try:
            shards, cur, cur_bytes = [], {}, 0
            dtypes = {}
            for name, arr, dt in items:
                dtypes[name] = dt
                cur[name] = arr
                cur_bytes += arr.nbytes
                if cur_bytes >= _SHARD_BYTES:
                    shards.append(cur)
                    cur, cur_bytes = {}, 0
            if cur:
                shards.append(cur)
            names = []
            for i, sh in enumerate(shards):
                np.savez(os.path.join(tmp, f"shard_{i}.npz"), **sh)
                names.append(f"shard_{i}.npz")
            manifest = {
                "step": step,
                "shards": names,
                "leaves": [n for n, _, _ in items],
                "dtypes": dtypes,
                "done": True,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    os.makedirs(ckpt_dir, exist_ok=True)
    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step whose manifest is complete, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_"):
            mf = os.path.join(ckpt_dir, d, "manifest.json")
            if os.path.exists(mf):
                try:
                    with open(mf) as f:
                        m = json.load(f)
                    if m.get("done"):
                        steps.append(m["step"])
                except (json.JSONDecodeError, KeyError):
                    continue
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None
            ) -> Any:
    """The checkpoint (the newest complete one unless `step` is given)
    in the structure of `tree_like`, as host tensors: each leaf looked
    up by its keystr and cast to the like leaf's dtype (a torch
    tensor's, on any device, `meta` included)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data: Dict[str, torch.Tensor] = {}
    dtypes = manifest.get("dtypes", {})
    for sh in manifest["shards"]:
        with np.load(os.path.join(d, sh)) as z:
            for k in z.files:
                arr = z[k]
                data[k] = _decode(arr, dtypes.get(k, arr.dtype.name))

    def build(like: Any, path: str) -> Any:
        if isinstance(like, dict):
            return {k: build(v, f"{path}[{k!r}]") for k, v in like.items()}
        if isinstance(like, (list, tuple)):
            return type(like)(build(v, f"{path}[{i}]")
                              for i, v in enumerate(like))
        arr = data[path]
        if isinstance(like, torch.Tensor) and arr.dtype != like.dtype:
            arr = arr.to(like.dtype)
        return arr

    return build(tree_like, "")
