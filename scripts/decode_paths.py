#!/usr/bin/env python3
"""Decode-step time of the serve model under three SiLU paths, interleaved
in one process on one card.

    python3 scripts/decode_paths.py [--reps 12] [--steps 8]

`mamba2-2.7b` at full width and depth (bf16 compute, f32 params,
weights from a `torch.Generator` seeded 0) behind
`Engine(..., ServeConfig(batch=4, s_max=1024))` prefills 4 random
prompts of 600 tokens, then decodes. Each rep runs `--steps` timed decode
steps (after 2 untimed) under each path in turn, the model's `ops`
swapped for:

- `kernels`: `ops.silu` / `ops.silu_gate`, the CUDA kernels (one launch
  each per layer and step);
- `plain`: their plain versions (`ref.silu_ref`, `ref.silu_gate_ref`),
  each op of the logistic an eager kernel, rounded as XLA rounds it;
- `fsilu`: `F.silu`, rounding once, with the gate's product and its f32
  copy as two more eager ops: the model's ops before it mirrored XLA's
  rounding (other ids, the same work).

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
from repro_torch.models import registry, ssm  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402


def _fsilu_gate(y: torch.Tensor, z: torch.Tensor):
    prod = y * F.silu(z)
    return prod, prod.float()


PATHS = {
    "kernels": ops,
    "plain": types.SimpleNamespace(ssd_chunk=ops.ssd_chunk, silu=silu_ref,
                                   silu_gate=silu_gate_ref),
    "fsilu": types.SimpleNamespace(ssd_chunk=ops.ssd_chunk, silu=F.silu,
                                   silu_gate=_fsilu_gate),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("mamba2-2.7b")
    model = registry.build_model(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = Engine(cfg, model, ServeConfig(batch=4, s_max=1024))
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (4, 600))
    nxt = eng.prefill(toks.astype(np.int32))
    steps = {name: [] for name in PATHS}
    try:
        for _ in range(args.reps):
            for name, path in PATHS.items():
                ssm.ops = path
                for _ in range(2):
                    nxt = eng.decode(nxt)
                for _ in range(args.steps):
                    t0 = time.perf_counter()
                    nxt = eng.decode(nxt)
                    steps[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        ssm.ops = ops
    summary = {name: {"median": float(np.median(v)),
                      "q1": float(np.percentile(v, 25)),
                      "q3": float(np.percentile(v, 75)), "steps": len(v)}
               for name, v in steps.items()}
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "decode_paths.json").write_text(json.dumps(
        {"summary": summary, "steps_ms": steps}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
