"""Serving launcher: batched request serving with the port's engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --requests 8 --max-new 16                       # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --reduced --device cpu                          # small, on the host
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --reduced --device cpu                          # the hybrid family
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-1b-a400m --reduced --device cpu   # the MoE family
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b \
      --reduced --device cpu                          # MLA

`--arch` takes every ported id (`repro_torch.configs.PORTED`). f32
products stay in full f32 on the card (TF32 is never turned on: the
MoE router's f32 product decides the routing).
"""
import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import PORTED, get_config
from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serve.engine import Engine, Request, ServeConfig


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Parse the arguments, build the model and serve random prompts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=PORTED, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = registry.init_params(cfg, gen, dev)
    eng = Engine(cfg, params, ServeConfig(batch=args.batch,
                                          s_max=args.s_max), device=dev)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab,
                                        rng.integers(4, 17)).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    print(f"[serve] {args.arch} on {dev}: {len(reqs)} requests, {total} "
          f"tokens in {dt:.2f}s ({total / dt:.1f} tok/s)")
    for rid in sorted(out)[:4]:
        print(f"[serve] req {rid}: {out[rid]}")


if __name__ == "__main__":
    main()
