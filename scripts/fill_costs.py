#!/usr/bin/env python3
"""What one water-fill costs the control loop on the card, piece by piece;
against another build of the kernel, whether the two give the same bits
and how long each takes; and what a fill costs inside the fleet tick.

    python3 scripts/fill_costs.py [--reps 201] [--other PATH/waterfill.cu]
    python3 scripts/fill_costs.py --tick [--root TREE]

By default, on seeded 8-DC fills built as `chip_smoke.wf_case` builds
them (host microseconds, median of `--reps` calls):

- `wrapper`: the whole numpy call (`kernels/waterfill.py::fill_rates`),
  one fill (B=1) and the 16-job tick's 18 fills as one batch (B=18),
  and beside them 18 calls of one fill;
- `inputs`: its shape checks and views (`host_inputs`);
- `host_fill`: `kernels/waterfill.py::host_fill`, the C entry
  `waterfill_fill_host` (staging, one copy in, the launch, one copy
  out, the synchronise) with its glue, and that glue alone:
  `device_ctx` (entering and leaving `torch.cuda.device`), `stream`
  (the current stream's handle), `pointers` (the nine arrays'
  addresses), `outputs` (the three output arrays);
- `launch_sync`: `ops.fill_rates` on device tensors, its outputs given,
  then a synchronise (the launch and the kernel);
- `host_loop`: the numpy loop on the same fill(s).

`--other` builds a second source of the same `waterfill_launch`
interface (e.g. a parent's `csrc/waterfill.cu`, unpacked with `git
archive`) with the same nvcc flags, asserts on every
`chip_smoke.WF_SHAPES` case that the two builds give equal bits (rates,
iterations, flags), then times both kernels A B B A in each of ROUNDS
rounds (device ms, CUDA graphs of 20 launches).

`--tick` runs the main phase's fleet (16 jobs, 24 ticks) with the numpy
and the cuda fill, A B B A (`chip_smoke.fleet_fill_ab`), and reports
its fills' host microseconds; `--root` runs another tree's
`chip_smoke.py` and `src/` (e.g. a parent's) for that.

Prints the card's name and power limit and one JSON line, which it also
writes to `chiprun_out/fill_costs.json`. Needs one card.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
TICK_FILLS = 18          # fills a tick of the 16-job fleet
ROUNDS = 3


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
    """The numpy call and its parts for one batch of fills."""
    import chip_smoke
    from repro_torch.kernels import ops
    from repro_torch.kernels import waterfill as wfk

    B, n = case[0].shape[0], case[0].shape[-1]
    args = wfk.host_inputs(*case)
    t = [torch.from_numpy(a).to(dev) for a in args]
    outs = (torch.empty((B, n, n), dtype=torch.float64, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.bool, device=dev))
    rate, iters, ok = (np.empty((B, n, n)), np.empty(B, np.int32),
                       np.empty(B, np.bool_))

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    def launch_sync():
        ops.fill_rates(*t, out=outs)
        torch.cuda.synchronize()

    return {
        "B": B, "N": n,
        "wrapper": host_us(lambda: wfk.fill_rates(*case), reps),
        "inputs": host_us(lambda: wfk.host_inputs(*case), reps),
        "host_fill": host_us(lambda: wfk.host_fill(*args, dev), reps),
        "device_ctx": host_us(device_ctx, reps),
        "stream": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream,
                          reps),
        "pointers": host_us(lambda: [a.ctypes.data for a in
                                     args + (rate, iters, ok)], reps),
        "outputs": host_us(lambda: (np.empty((B, n, n)),
                                    np.empty(B, np.int32),
                                    np.empty(B, np.bool_)), reps),
        "launch_sync": host_us(launch_sync, reps),
        "host_loop": host_us(lambda: chip_smoke.host_fills(case),
                             max(5, reps // 20)),
    }


def kernel_ab(other: Path, dev) -> list:
    """Equal bits on every WF_SHAPES case, then both kernels' device ms
    A B B A."""
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import waterfill as wfk

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        mine = wfk._lib()
        libs = {"this": mine, "other": build.load_other(
            other, Path(tmp) / "other.so", mine,
            ("waterfill_launch", "waterfill_error_string"))}
        for B, n in chip_smoke.WF_SHAPES:
            case = chip_smoke.wf_case(B, n, seed=B * 100 + n)
            t = [torch.from_numpy(a).to(dev) for a in case]
            outs = {lab: (torch.full((B, n, n), float("nan"),
                                     dtype=torch.float64, device=dev),
                          torch.full((B,), -1, dtype=torch.int32,
                                     device=dev),
                          torch.zeros(B, dtype=torch.bool, device=dev))
                    for lab in libs}
            calls = {lab: (lambda lib=libs[lab], o=outs[lab]:
                           wfk.launch(*t, *o, lib=lib)) for lab in libs}
            for call in calls.values():
                call()
            torch.cuda.synchronize()
            a, b = outs["this"], outs["other"]
            equal = (torch.equal(a[0].view(torch.int64),
                                 b[0].view(torch.int64))
                     and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]))
            if not equal:
                raise AssertionError(f"B={B} N={n}: the two builds differ "
                                     f"(iters {a[1].tolist()} vs "
                                     f"{b[1].tolist()})")
            ms = {lab: [] for lab in libs}
            for _ in range(ROUNDS):
                for lab in ("this", "other", "other", "this"):
                    ms[lab].append(chip_smoke.graph_ms(calls[lab]))
            iters = a[1].cpu().numpy()
            rows.append({"B": B, "N": n, "bit_equal": True,
                         "iters_max": int(iters.max()),
                         "iters_sum": int(iters.sum()),
                         **{f"{lab}_ms": float(np.median(v))
                            for lab, v in ms.items()},
                         **{f"{lab}_runs_ms": v for lab, v in ms.items()}})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=201)
    ap.add_argument("--other", type=Path,
                    help="another waterfill.cu to hold bit-equal and time")
    ap.add_argument("--tick", action="store_true",
                    help="time the fleet tick's fills instead")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the tree whose chip_smoke.py and src/ --tick runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fill_costs: needs one CUDA card", file=sys.stderr)
        return 1
    root = (args.root if args.tick else ROOT).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke

    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi()
    print(smi)
    doc = {"device": smi, "root": str(root)}
    if args.tick:
        from repro_torch.fleet import default_fleet_forest
        ab = chip_smoke.fleet_fill_ab(default_fleet_forest(), dev)
        doc["tick"] = {k: ab[k] for k in ("order",)}
        for backend in ("numpy", "cuda"):
            doc["tick"][backend] = {k: v for k, v in ab[backend].items()
                                    if k != "tick_ms"}
    else:
        tick = chip_smoke.wf_case(TICK_FILLS, 8, seed=TICK_FILLS * 100 + 8)
        one = tuple(a[:1] for a in tick)
        rows = [pieces(one, dev, args.reps), pieces(tick, dev, args.reps)]
        singles = [tuple(a[b:b + 1] for a in tick)
                   for b in range(TICK_FILLS)]
        from repro_torch.kernels import waterfill as wfk
        rows.append({"B": TICK_FILLS, "N": 8, "calls": TICK_FILLS,
                     "wrapper": host_us(lambda: [wfk.fill_rates(*c)
                                                 for c in singles],
                                        max(5, args.reps // 10))})
        doc["unit"] = "host us, median"
        doc["rows"] = rows
        if args.other is not None:
            doc["kernels"] = kernel_ab(args.other.resolve(), dev)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fill_costs.json").write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
