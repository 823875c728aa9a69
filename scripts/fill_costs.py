#!/usr/bin/env python3
"""What one water-fill costs the control loop on the card, piece by piece,
and what batching the fleet tick's fills into one launch would save.

    python3 scripts/fill_costs.py [--reps 201]

On the 16-job fleet tick of `chip_smoke.py`'s main phase, a tick makes
18 fills of the 8-DC mesh (`WanSimulator._fill_rates`). Each fill on
the ``"cuda"`` backend is one call of
`repro_torch.kernels.waterfill.fill_rates`: pack the numpy inputs, one
host-to-device copy, views, the wrapper's checks, one launch, one
device-to-host copy that synchronises, and numpy views of the result.
This times, on seeded 8-DC fills built as `chip_smoke.wf_case` builds
them (host microseconds, median of `--reps` calls, each ending
synchronised where it says so):

- `wrapper`: the whole numpy call, one fill (B=1) and the tick's 18
  fills as one batch (B=18), beside 18 calls of one fill;
- `h2d`: the pageable copy of the packed inputs;
- `views`: the six input views of the copied buffer;
- `ops_issue`: `ops.fill_rates` with its outputs given, not synchronised
  (the checks, the ctypes call, the launch);
- `launch_sync`: that plus a synchronise (the kernel's time on top);
- `d2h`: the copy of the output buffer back, the device idle;
- `host_loop`: the numpy loop on the same fill(s).

Prints one JSON line and writes it to `chiprun_out/fill_costs.json`.
Needs one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import waterfill as wfk  # noqa: E402

TICK_FILLS = 18          # fills a tick of the 16-job fleet


def host_us(fn, reps: int) -> float:
    """Median host microseconds of one call, after warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def pieces(case, dev, reps: int) -> dict:
    """The wrapper's call and its parts for one batch of fills."""
    B, n = case[0].shape[0], case[0].shape[-1]
    buf = np.concatenate([a.reshape(-1) for a in case])
    flat = torch.from_numpy(buf).to(dev)
    views, ofs = [], 0
    for a in case:
        views.append(flat[ofs:ofs + a.size].view(a.shape))
        ofs += a.size
    nr = B * n * n * 8
    out = torch.empty(nr + 5 * B, dtype=torch.uint8, device=dev)
    outs = (out[:nr].view(torch.float64).view(B, n, n),
            out[nr:nr + 4 * B].view(torch.int32),
            out[nr + 4 * B:].view(torch.bool))

    def issue():
        ops.fill_rates(*views, out=outs)

    def launch_sync():
        issue()
        torch.cuda.synchronize()

    return {
        "B": B, "N": n,
        "wrapper": host_us(lambda: wfk.fill_rates(*case), reps),
        "h2d": host_us(lambda: torch.from_numpy(buf).to(dev), reps),
        "views": host_us(lambda: [flat[0:a.size].view(a.shape)
                                  for a in case], reps),
        "ops_issue": host_us(issue, reps),
        "launch_sync": host_us(launch_sync, reps),
        "d2h": host_us(lambda: out.cpu(), reps),
        "host_loop": host_us(lambda: chip_smoke.host_fills(case),
                             max(5, reps // 20)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=201)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fill_costs: needs one CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tick = chip_smoke.wf_case(TICK_FILLS, 8, seed=TICK_FILLS * 100 + 8)
    one = tuple(a[:1] for a in tick)
    rows = [pieces(one, dev, args.reps), pieces(tick, dev, args.reps)]
    singles = [tuple(a[b:b + 1] for a in tick) for b in range(TICK_FILLS)]
    rows.append({"B": TICK_FILLS, "N": 8, "calls": TICK_FILLS,
                 "wrapper": host_us(lambda: [wfk.fill_rates(*c)
                                             for c in singles],
                                    max(5, args.reps // 10))})
    doc = {"device": smi, "unit": "host us, median", "rows": rows}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fill_costs.json").write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
