#!/usr/bin/env python3
"""Serve time of two checkouts of the port, interleaved on one card.

    python3 scripts/serve_ab.py ROOT_A ROOT_B [--rounds 1]

Each round runs ROOT_A, ROOT_B, ROOT_B, ROOT_A, one process a run with
that checkout's `src` first on the path (so each builds and loads its
own kernels). A run serves `mamba2-2.7b` at full width and depth (bf16
compute, f32 params, weights from a `torch.Generator` seeded 0) behind
`Engine(..., ServeConfig(batch=4, s_max=1024))` the 8 requests of
`chip_smoke.py`'s serve phase (300-700 prompt tokens from
`default_rng(0)`, 16 new tokens each): one warm-up serve, one timed
serve (prefill ms per group, decode ms per step, from the engine's own
timings), then group 1's prefill and 4 decode steps under
`torch.profiler` (kernels run and their device ms). It prints one JSON
line per run and, last, the medians per checkout; everything also goes
to `chiprun_out/serve_ab.json` under the current directory.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ARCH, BATCH, S_MAX, N_REQUESTS, MAX_NEW = "mamba2-2.7b", 4, 1024, 8, 16
PROMPT_LEN = (300, 700)
PROFILED_DECODES = 4


def _requests(Request, vocab: int):
    import numpy as np
    rng = np.random.default_rng(0)
    lengths = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, N_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(1, vocab, n).astype(np.int32),
                    max_new=MAX_NEW) for i, n in enumerate(lengths)]


def _profile(fn):
    """(kernels run, their device ms) of `fn` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, us = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += e.count
            us += e.self_device_time_total
    return n, us / 1e3


def run_one(root: Path) -> dict:
    """One run on the checkout at `root`; returns its numbers."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    if Path(repro_torch.__file__).resolve().parents[1] != \
            (root / "src").resolve():
        raise RuntimeError(f"imported {repro_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    model = registry.build_model(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = Engine(cfg, model, ServeConfig(batch=BATCH, s_max=S_MAX))
    eng.serve(_requests(Request, cfg.vocab))           # warm-up
    eng.timings = {"prefill_s": [], "decode_s": []}
    torch.cuda.synchronize()
    reqs = _requests(Request, cfg.vocab)
    out = eng.serve(reqs)
    prefill_ms = [v * 1e3 for v in eng.timings["prefill_s"]]
    decode_ms = [v * 1e3 for v in eng.timings["decode_s"]]
    toks = eng.batch_tokens(reqs[:BATCH])
    pk, pms = _profile(lambda: eng.prefill(toks))
    nxt = eng.prefill(toks)
    dk, dms = _profile(lambda: [eng.decode(nxt)
                                for _ in range(PROFILED_DECODES)])
    return {"root": str(root), "prefill_ms": prefill_ms,
            "decode_ms": decode_ms,
            "decode_ms_median": float(np.median(decode_ms)),
            "prefill_kernels": pk, "prefill_device_ms": pms,
            "decode_kernels_per_step": dk / PROFILED_DECODES,
            "decode_device_ms_per_step": dms / PROFILED_DECODES,
            "first_ids": {str(r.rid): out[r.rid][:4] for r in reqs[:2]}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(run_one(args.one.resolve())), flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkouts: ROOT_A ROOT_B")
    a, b = (r.resolve() for r in args.roots)
    runs = []
    for _ in range(args.rounds):
        for root in (a, b, b, a):
            env = dict(os.environ, PYTHONPATH=str(root / "src"))
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--one",
                 str(root)], env=env, capture_output=True, text=True,
                timeout=900)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                raise RuntimeError(f"run on {root} exited "
                                   f"{proc.returncode}")
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(run), flush=True)
            runs.append(run)
    summary = {}
    for root in (a, b):
        mine = [r for r in runs if r["root"] == str(root)]
        summary[str(root)] = {k: statistics.median(r[k] for r in mine)
                              for k in ("decode_ms_median",
                                        "prefill_device_ms",
                                        "prefill_kernels",
                                        "decode_kernels_per_step",
                                        "decode_device_ms_per_step")}
        summary[str(root)]["prefill_ms_group1"] = statistics.median(
            r["prefill_ms"][0] for r in mine)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "serve_ab.json").write_text(json.dumps(
        {"runs": runs, "summary": summary}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
