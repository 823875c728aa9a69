#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`src/repro_torch`) on one
NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

Every phase is fatal: a failure exits non-zero before the result line.

1. device  — `nvidia-smi` name and power limit, torch and CUDA versions
   (exits non-zero when `torch.cuda.is_available()` is false);
2. build   — compiles the kernel source `src/repro_torch/csrc/rf_predict.cu`
   with `nvcc` and prints ptxas's report;
3. kernel  — the rf_predict CUDA kernel against its plain PyTorch
   version on the card, bit-equal, on the paper's forest (100 trees,
   depth 10, trained by `train_default_forest(600)`) over all dataset
   rows, on ragged n, and on the fleet demo forest (8 x 5); times at one
   tick's rows (n=192) and at the whole dataset, beside the bound;
4. main    — `FleetController.tick()` of 16 four-DC jobs on the 8-DC mesh
   (noisy simulator, seed 0) for 24 ticks through the kernel: one launch
   per tick, per-DC budgets within `m_total`, finite positive achieved
   BW, and records equal to the same fleet run on the host's plain
   version; tick latency median / p90 from this run, with span tracing
   off. A run of the same fleet with `obs="on"` just before it must give
   the same records and supplies the per-stage breakdown (predict share);
5. backend — the README's two-job fleet for 5 ticks, each job's capture
   through `BwPredictor` backends `cuda`, `torch` and the default (no
   backend named) on the card, bit-equal to each other and to the
   tick's own prediction.

Then it prints the `kernels` JSON line, the `nvidia-smi` line, and as
the last line `{"ok": true, "device": {...}}`. All numbers also go to
`chiprun_out/chip_smoke.json`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.predictor import BwPredictor  # noqa: E402
from repro_torch.fleet import (BatchedRfPredictor, FleetController,  # noqa: E402
                               JobSpec, default_fleet_forest)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.ref import rf_predict_ref  # noqa: E402
from repro_torch.wan.dataset import (generate_dataset,  # noqa: E402
                                     train_default_forest)
from repro_torch.wan.simulator import WanSimulator  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM rate and non-tensor f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

N_JOBS, TICKS, M_TOTAL = 16, 24, 8          # benchmarks/tick_bench.py
PRIORITIES = (1.0, 2.0, 4.0)
TICK_ROWS = N_JOBS * 4 * 3                  # 12 ordered pairs per job
BACKEND_TICKS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def fleet_jobs(n_jobs: int = N_JOBS):
    """4-DC jobs whose slices tile and overlap the 8-DC mesh."""
    return tuple(JobSpec(name=f"job{j}",
                         dcs=tuple((j + k) % 8 for k in range(4)),
                         priority=PRIORITIES[j % len(PRIORITIES)])
                 for j in range(n_jobs))


def packed_on(forest, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in forest.packed()]


# ----------------------------------------------------------------------
# kernel phase
# ----------------------------------------------------------------------
def check_kernel(forest, X: np.ndarray, device) -> float:
    """Kernel (or, on the CPU, the wrapper's plain path) vs the plain
    version on the same inputs; bit-equal. Returns max |diff|."""
    packed = packed_on(forest, device)
    Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)
    got = ops.rf_predict(*packed, Xt, depth=forest.depth)
    want = rf_predict_ref(*packed, Xt, forest.depth)
    if device.type == "cuda":
        torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if got.shape != (len(X),) or not np.isfinite(got).all():
        raise AssertionError(f"kernel output shape {got.shape} or "
                             f"non-finite values at n={len(X)}")
    np.testing.assert_array_equal(got, want)
    return float(np.max(np.abs(got - want))) if len(X) else 0.0


def work_of(forest, X: np.ndarray):
    """Bytes this call must move (each forest node the inputs visit,
    read once; X read once; out written once) and its f32 operations
    (a compare per level per (sample, tree), a tree-order add per
    (sample, tree), one multiply per sample)."""
    feat, thr, _ = forest.packed()
    n, T, d = len(X), feat.shape[0], forest.depth
    node = np.zeros((T, n), np.int64)
    t_idx = np.arange(T)[:, None]
    visited = 0
    for _ in range(d):
        visited += len(np.unique(t_idx * (2 ** (d + 1)) + node))
        f = np.maximum(feat[t_idx, node], 0)
        node = 2 * node + 1 + (X[np.arange(n)[None, :], f] >
                               thr[t_idx, node])
    leaves = len(np.unique(t_idx * (2 ** (d + 1)) + node))
    nbytes = visited * 8 + leaves * 4 + X.size * 4 + n * 4
    nops = n * T * (d + 1) + n
    return nbytes, nops


def bound(forest, X):
    nbytes, nops = work_of(forest, X)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, nops


def kernel_device_ms(forest, X, launches: int = 50, reps: int = 21):
    """Median device time of one kernel launch: `launches` back-to-back
    launches captured in a CUDA graph, replayed `reps` times between
    CUDA events (the graph keeps the host's per-call cost out)."""
    dev = torch.device("cuda")
    packed = packed_on(forest, dev)
    Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            ops.rf_predict(*packed, Xt, depth=forest.depth)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            ops.rf_predict(*packed, Xt, depth=forest.depth)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def call_ms(fn, reps: int = 21) -> float:
    """Median time of one call from the host's view: CUDA events around
    each call, synchronised, after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_kernel(forest, X):
    dev = torch.device("cuda")
    packed = packed_on(forest, dev)
    Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
    bound_ms, by, nbytes, nops = bound(forest, X)
    return {
        "n": len(X), "trees": int(forest.feat.shape[0]),
        "depth": forest.depth,
        "ms": kernel_device_ms(forest, X),
        "wrapper_ms": call_ms(
            lambda: ops.rf_predict(*packed, Xt, depth=forest.depth)),
        "plain_ms": call_ms(
            lambda: rf_predict_ref(*packed, Xt, forest.depth)),
        "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes, "ops": nops,
    }


# ----------------------------------------------------------------------
# main path
# ----------------------------------------------------------------------
def check_records(records, jobs, m_total: int) -> None:
    """One launch per tick; per-DC budgets sum within m_total; every
    job's achieved BW finite and positive."""
    dcs = {j.name: j.dcs for j in jobs}
    for k, rec in enumerate(records, 1):
        if rec["tick"] != k or rec["n_jobs"] != len(jobs) \
                or rec["kernel_calls"] != k:
            raise AssertionError(f"tick record {k}: {rec['tick']} "
                                 f"{rec['n_jobs']} {rec['kernel_calls']}")
        for d in range(8):
            used = sum(r["budget"] for r in rec["jobs"] if d in dcs[r["name"]])
            if used > m_total:
                raise AssertionError(f"tick {k}: DC {d} budgets {used} > "
                                     f"m_total {m_total}")
        for r in rec["jobs"]:
            for key in ("achieved_min", "achieved_mean"):
                if not (np.isfinite(r[key]) and r[key] > 0):
                    raise AssertionError(f"tick {k} {r['name']} {key}="
                                         f"{r[key]}")


def run_fleet(forest, device, ticks: int = TICKS, n_jobs: int = N_JOBS,
              obs: str = "off", counted: bool = False):
    """Drive the fleet; with `counted`, zero every launch count just
    before the ticks and return the counts read just after."""
    jobs = fleet_jobs(n_jobs)
    fleet = FleetController(WanSimulator(seed=0),
                            BatchedRfPredictor(forest, device=device),
                            m_total=M_TOTAL, jobs=jobs, obs=obs)
    if counted:
        ops.rf_predict.launches = 0
        fleet.predictor.metrics.counter("kernel_calls").reset()
    records, secs = [], []
    for _ in range(ticks):
        t0 = time.perf_counter()
        records.append(fleet.tick())
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = {"rf_predict": ops.rf_predict.launches} if counted else {}
    check_records(records, jobs, M_TOTAL)
    return fleet, records, secs, counts


def check_backends(forest, device, ticks: int = BACKEND_TICKS) -> int:
    """README fleet; each job's capture through BwPredictor backends."""
    fleet = FleetController(
        WanSimulator(seed=0), BatchedRfPredictor(forest, device=device),
        m_total=M_TOTAL,
        jobs=(JobSpec("serving", dcs=(0, 1, 2, 3), priority=4.0),
              JobSpec("batch", dcs=(0, 1, 4, 5), priority=1.0)))
    bp = BwPredictor(forest, device=device)
    kernel_backend = "cuda" if device.type == "cuda" else "torch"
    checked = 0
    for _ in range(ticks):
        fleet.tick()
        for job in fleet.jobs.values():
            raw = job.controller.monitor.last_raw
            args = (job.view.N, raw["snapshot_bw"], raw["mem_util"],
                    raw["cpu_load"], raw["retrans"], raw["dist"])
            a = bp.predict_matrix(*args, backend=kernel_backend)
            b = bp.predict_matrix(*args, backend="torch")
            np.testing.assert_array_equal(a, b)
            # no backend named: the device picks it (the kernel on the card)
            np.testing.assert_array_equal(bp.predict_matrix(*args), a)
            np.testing.assert_array_equal(a, job.controller.last_pred)
            checked += 1
    return checked


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    results = {}

    # 1. device
    smi = nvidia_smi()
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")
    results["device"] = {"nvidia_smi": smi, "torch": torch.__version__,
                         "cuda": torch.version.cuda}

    # 2. build
    t0 = time.perf_counter()
    text = build.compile_source("rf_predict")
    results["build_s"] = time.perf_counter() - t0
    log(f"[build] rf_predict in {results['build_s']:.1f} s")
    for line in text.strip().splitlines():
        log(f"[build] rf_predict: {line}")

    # 3. kernel
    t0 = time.perf_counter()
    X, _ = generate_dataset(600)
    paper, acc, r2 = train_default_forest(600)
    results["paper_forest"] = {"rows": len(X), "train_acc": acc, "r2": r2,
                               "fit_s": time.perf_counter() - t0}
    log(f"[kernel] paper forest {paper.feat.shape[0]}x{paper.depth} on "
        f"{len(X)} rows: train acc {acc:.4f}, held-out r2 {r2:.4f} "
        f"({results['paper_forest']['fit_s']:.1f} s)")
    demo = default_fleet_forest()
    max_err = 0.0
    for name, forest, ns in (("paper", paper, (len(X), 1, 191, len(X) - 1)),
                             ("demo", demo, (len(X), TICK_ROWS, 1))):
        for n in ns:
            err = check_kernel(forest, X[:n], dev)
            max_err = max(max_err, err)
            log(f"[kernel] {name} n={n}: bit-equal to plain "
                f"(max |diff| {err})")
    timing = {f"n{n}": time_kernel(paper, X[:n]) for n in (TICK_ROWS, len(X))}
    for key, t in timing.items():
        log(f"[kernel] rf_predict {key}: kernel {t['ms']:.5f} ms (device, "
            f"graph) | wrapper call {t['wrapper_ms']:.5f} ms | plain "
            f"{t['plain_ms']:.5f} ms | bound {t['bound_ms']:.6f} ms by "
            f"{t['bound_by']} ({t['bytes']} B, {t['ops']} ops) | library "
            f"call: none (no single PyTorch call computes a forest)")
    results["rf_predict"] = timing

    # 4. the same fleet with span tracing on, first: it supplies only the
    # stage breakdown (its ticks carry the tracer's cost) and takes the
    # host path's first-tick warm-up out of the timed run below
    traced, traced_records, traced_secs, _ = run_fleet(paper, dev, obs="on")
    # main path: 16 jobs x 24 ticks through the kernel, tracing off
    fleet, records, secs, counts = run_fleet(paper, dev, counted=True)
    if counts["rf_predict"] != TICKS or fleet.predictor.kernel_calls != TICKS:
        raise AssertionError(f"launches {counts} / kernel_calls "
                             f"{fleet.predictor.kernel_calls} != {TICKS}")
    rows = fleet.predictor.metrics.counter("rows_total").value / TICKS
    if rows != TICK_ROWS:
        raise AssertionError(f"{rows} rows per tick, expected {TICK_ROWS}")
    _, host_records, _, _ = run_fleet(paper, torch.device("cpu"))
    if host_records != records:
        raise AssertionError("tick records on the card differ from the "
                             "host's plain version")
    if traced_records != records:           # tracing is passive
        raise AssertionError("obs='on' changed the tick records")
    stages = traced.tracer.by_stage()
    ms = np.asarray(secs) * 1e3
    traced_ms = np.asarray(traced_secs) * 1e3
    tick_ms, p90 = float(np.median(ms)), float(np.percentile(ms, 90))
    predict_share = stages["predict"]["total_s"] / stages["tick"]["total_s"]
    kernel_share = timing[f"n{TICK_ROWS}"]["ms"] / tick_ms
    results["main"] = {
        "jobs": N_JOBS, "ticks": TICKS, "rows_per_tick": TICK_ROWS,
        "launches": counts["rf_predict"], "tick_ms": ms.tolist(),
        "tick_ms_median": tick_ms, "tick_ms_p90": p90,
        "kernel_share": kernel_share,
        "traced_tick_ms": traced_ms.tolist(),
        "traced_tick_ms_median": float(np.median(traced_ms)),
        "traced_predict_share": predict_share,
        "traced_stages_s": {k: v["total_s"] for k, v in stages.items()}}
    log(f"[main] {N_JOBS} jobs x {TICKS} ticks, obs off: "
        f"{counts['rf_predict']} launches, {TICK_ROWS} rows/tick, tick "
        f"{tick_ms:.3f} ms median / {p90:.3f} ms p90, kernel "
        f"{kernel_share:.3%} of the median tick; records equal to the "
        f"host run")
    log(f"[main] obs on (breakdown run): tick "
        f"{float(np.median(traced_ms)):.3f} ms median, predict span "
        f"{predict_share:.2%} of the tick span; stages (s over all "
        f"ticks): " + ", ".join(f"{k} {v['total_s']:.4f}"
                                for k, v in stages.items()))

    # 5. BwPredictor backends on the README fleet
    checked = check_backends(demo, dev)
    log(f"[backend] README fleet x{BACKEND_TICKS} ticks: {checked} job "
        f"predictions, backend cuda == torch == tick prediction")

    t = timing[f"n{TICK_ROWS}"]
    kernels = {"kernels": [{
        "name": "rf_predict", "route": "cuda",
        "source": "src/repro_torch/csrc/rf_predict.cu",
        "replaces": "src/repro/kernels/rf_predict.py:74",
        "launches": counts["rf_predict"], "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}]}
    results["kernels"] = kernels["kernels"]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
