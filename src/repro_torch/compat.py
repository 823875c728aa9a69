"""Pods over `torch.distributed`: the port's counterpart of the JAX
package's `shard_map` over a `pod` mesh axis (`repro/compat.py`) and of
`lax.axis_index` / `lax.ppermute` inside it.

A pod is one process of a process group. `run_pods` starts one process
per pod and runs a function in each; inside it, `pod_index` and
`pod_count` name the pod, and `ppermute` moves a tensor from every pod
to the pod `offset` places on.

Transport. The ranks use gloo. NCCL refuses two ranks on one card,
which is how one H100 holds four pods, and gloo's send and receive
take host tensors. So `ppermute` stages what it moves through host
memory: the caller hands it what goes on the wire (the codec's int8
payload and scale, see `control/schedule.py`), which is what a WAN hop
carries. It is transport, not a fallback: the codec and every other
computation stay on the card. NCCL across four cards is later work.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

__all__ = ["pod_index", "pod_count", "ppermute", "run_pods", "tree_map",
           "tree_leaves"]

_GRACE_S = 5.0      # how long other pods' reports are awaited after a failure


def pod_index(group: Optional[dist.ProcessGroup] = None) -> int:
    """This pod's index in `group` (the world by default): the
    counterpart of `lax.axis_index("pod")`."""
    return dist.get_rank(group)


def pod_count(group: Optional[dist.ProcessGroup] = None) -> int:
    """The number of pods in `group`: `lax.axis_size("pod")`."""
    return dist.get_world_size(group)


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def ppermute(x: torch.Tensor, offset: int,
             group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Send `x` to pod (rank + offset) % P and return what pod
    (rank - offset) % P sent, on `x`'s device: `lax.ppermute` with the
    permutation [(i, (i + offset) % P)]. Every pod calls it with a
    tensor of the same shape and dtype. The bytes pass through host
    memory (see the module's docstring)."""
    P, rank = pod_count(group), pod_index(group)
    if offset % P == 0:
        return x.clone()
    send = x.detach().to("cpu").contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, _global_rank(group, (rank + offset) % P),
                   group),
        dist.P2POp(dist.irecv, recv, _global_rank(group, (rank - offset) % P),
                   group)])
    for req in reqs:
        req.wait()
    return recv.to(x.device)


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """`jax.tree.map` over nested dicts, lists and tuples of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any):
    """The leaves of nested dicts, lists and tuples, in `tree_map`'s
    order (dicts in their insertion order)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def _pod_main(fn, rank: int, n_pods: int, store_path: str, timeout_s: float,
              results, args) -> None:
    """One pod's process: join the group, run `fn`, report to the
    parent (the value, or the traceback)."""
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, n_pods), rank=rank,
            world_size=n_pods, timeout=timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(rank, n_pods, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)


def run_pods(fn: Callable[..., Any], n_pods: int, *args: Any,
             timeout: float = 300.0) -> List[Any]:
    """Run ``fn(rank, n_pods, *args)`` in `n_pods` new processes that
    form one gloo process group, and return their values in rank order.

    The processes are spawned (CUDA does not survive a fork), so `fn`
    and `args` must pickle: a module-level function, and values rather
    than open handles. The group meets through a `FileStore` in a new
    temporary directory, so concurrent calls do not collide. The group
    and the call share the deadline `timeout` (seconds). When a pod
    fails, the others' reports are awaited for a few seconds (a pod
    whose peer died fails too; the root cause is among them), then every
    pod is killed and this raises with each failed pod's traceback; it
    raises too when the deadline passes."""
    ctx = mp.get_context("spawn")
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="pods-") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_pod_main,
                             args=(fn, r, n_pods, os.path.join(tmp, "store"),
                                   timeout, results, args), daemon=True)
                 for r in range(n_pods)]
        for p in procs:
            p.start()
        values: Dict[int, Any] = {}
        errors: Dict[int, str] = {}
        try:
            while len(values) + len(errors) < n_pods:
                left = deadline - time.monotonic()
                if errors:
                    left = min(left, grace - time.monotonic())
                if left <= 0:
                    break
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = {r: f"exited ({p.exitcode}) without a report"
                            for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and
                            r not in values and r not in errors}
                    if dead and not errors:
                        grace = time.monotonic() + _GRACE_S
                    errors.update(dead)
                    continue
                if ok:
                    values[rank] = value
                else:
                    if not errors:
                        grace = time.monotonic() + _GRACE_S
                    errors[rank] = value
            for p in procs:
                p.join(timeout=1.0 if errors else
                       max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
        if errors:
            raise RuntimeError("\n".join(f"pod {r} failed:\n{errors[r]}"
                                         for r in sorted(errors)))
        if len(values) < n_pods:
            raise RuntimeError(f"pods timed out after {timeout} s (no "
                               f"result from pods "
                               f"{sorted(set(range(n_pods)) - set(values))})")
        alive = [r for r, p in enumerate(procs) if p.exitcode is None]
        if alive:
            raise RuntimeError(f"pods {alive} did not exit")
    return [values[r] for r in range(n_pods)]
