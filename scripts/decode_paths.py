#!/usr/bin/env python3
"""Decode-step time of a served model under several op paths,
interleaved in one process on one card.

    python3 scripts/decode_paths.py [--arch mamba2-2.7b] [--reps 12] [--steps 8]

The model at full width and depth (bf16 compute, f32 params, weights
from a `torch.Generator` seeded 0) behind
`Engine(..., ServeConfig(batch=4, s_max=1024))` prefills 4 random
prompts (600 tokens for the SSM family, 300 for the dense one, whose
cache must hold every step), then decodes. Each rep runs `--steps`
timed decode steps (after 2 untimed) under each path in turn.

`mamba2-2.7b` (the SSM family): the model's `ops` swapped for
- `kernels`: `ops.silu` / `ops.silu_gate`, the CUDA kernels (one launch
  each per layer and step);
- `plain`: their plain versions (`ref.silu_ref`, `ref.silu_gate_ref`),
  each op of the logistic an eager kernel, rounded as XLA rounds it;
- `fsilu`: `F.silu`, rounding once, with the gate's product and its f32
  copy as two more eager ops: the model's ops before it mirrored XLA's
  rounding (other ids, the same work).

`llama3-8b`, `qwen3-4b`, `h2o-danube-1.8b` (the dense family): the
block's numerics around the attention swapped in
`models/attention.py` and `models/transformer.py`:
- `port`: the modules as they are (ln2's variance of the f32 residual
  sum, q's scaled product in f32, ATen's softmax on the card);
- `spelled`: the same, the softmax spelled out as exp(s - max) / sum,
  four more eager kernels a layer;
- `rounded`: the roundings before ln2's repair (the residual sum in
  bf16 read by ln2, q scaled in bf16, ATen's softmax).

Runs in one process see the same host, so the host's load between
processes does not enter the comparison. Prints the median and
quartiles of the step's wall time per path, as one JSON line, and
writes every step's time to `chiprun_out/decode_paths.json`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import silu_gate_ref, silu_ref  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import registry, ssm  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.models.layers import rms_norm, swiglu  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402


def _fsilu_gate(y: torch.Tensor, z: torch.Tensor):
    prod = y * F.silu(z)
    return prod, prod.float()


def _spelled_softmax(s: torch.Tensor) -> torch.Tensor:
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _rounded_scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    return x * torch.tensor(scale, dtype=x.dtype)


def _rounded_mlp(blk, x, a, cfg):
    x = x + a
    h = rms_norm(x, blk["ln2"], cfg.norm_eps)
    mlp = blk["mlp"]
    return x + swiglu(h, mlp["w1"], mlp["w3"], mlp["w2"])


# each path: (module, attribute) -> value set while the path runs
SSM_PATHS = {
    "kernels": {(ssm, "ops"): ops},
    "plain": {(ssm, "ops"): types.SimpleNamespace(
        ssd_chunk=ops.ssd_chunk, silu=silu_ref, silu_gate=silu_gate_ref)},
    "fsilu": {(ssm, "ops"): types.SimpleNamespace(
        ssd_chunk=ops.ssd_chunk, silu=F.silu, silu_gate=_fsilu_gate)},
}
DENSE_PATHS = {
    "port": {},
    "spelled": {(att, "_softmax"): _spelled_softmax},
    "rounded": {(att, "_softmax"): lambda s: torch.softmax(s, dim=-1),
                (att, "_scaled"): _rounded_scaled, (lm, "_mlp"): _rounded_mlp},
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    paths, prompt = (SSM_PATHS, 600) if cfg.family == "ssm" else \
        (DENSE_PATHS, 300)
    s_max = 1024
    if cfg.family != "ssm" and \
            prompt + args.reps * len(paths) * (args.steps + 2) > s_max:
        raise SystemExit(f"{args.reps} reps of {args.steps} + 2 steps do "
                         f"not fit the {s_max}-slot cache")
    model = registry.build_model(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = Engine(cfg, model, ServeConfig(batch=4, s_max=s_max))
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (4, prompt))
    nxt = eng.prefill(toks.astype(np.int32))
    saved = {key: getattr(*key) for path in paths.values() for key in path}
    steps = {name: [] for name in paths}
    try:
        for _ in range(args.reps):
            for name, path in paths.items():
                for key, value in saved.items():
                    setattr(*key, path.get(key, value))
                for _ in range(2):
                    nxt = eng.decode(nxt)
                for _ in range(args.steps):
                    t0 = time.perf_counter()
                    nxt = eng.decode(nxt)
                    steps[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        for key, value in saved.items():
            setattr(*key, value)
    summary = {name: {"median": float(np.median(v)),
                      "q1": float(np.percentile(v, 25)),
                      "q3": float(np.percentile(v, 75)), "steps": len(v)}
               for name, v in steps.items()}
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "decode_paths.json").write_text(json.dumps(
        {"arch": args.arch, "summary": summary, "steps_ms": steps},
        indent=1))
    print(json.dumps({"arch": args.arch, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
