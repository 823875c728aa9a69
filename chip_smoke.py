#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`src/repro_torch`) on one
NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

Every phase is fatal: a failure exits non-zero before the result line.

1. device  — `nvidia-smi` name and power limit, torch and CUDA versions
   (exits non-zero when `torch.cuda.is_available()` is false);
2. build   — compiles the kernel sources `src/repro_torch/csrc/rf_predict.cu`
   and `ssd_chunk.cu` with `nvcc`, one process each, started together,
   and prints ptxas's reports (registers, static shared memory, spills)
   and the dynamic shared memory of a ssd_chunk block at the serve shape;
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
6. ssd     — the ssd_chunk CUDA kernel against its plain PyTorch version
   on the card, atol/rtol 1e-4 (both take the cumulative decay in one
   order; the products may add in another): on the
   bf16 inputs captured from layer 0 of a prefill of the serve model
   below, on f32 random inputs at (Q,H,P,N) = (256,80,64,128) and at
   (16,16,16,16), each with nC in {1, 3} and B in {1, 4}; times at the
   serve shape beside the bound;
7. serve   — the slice's main path: `mamba2-2.7b` at its full width and
   depth (64 layers, bf16 compute, f32 params, weights from a
   `torch.Generator` seeded 0) behind `Engine(..., ServeConfig(batch=4,
   s_max=1024))` with a `WanifyController` on the paper forest:
   `replan()` and its migration schedule, then 8 requests of 300-700
   prompt tokens (`default_rng(0)`), 16 new tokens each: two prefills
   and 32 decode steps. Exactly 2 x 64 ssd_chunk launches (one per
   layer per prefill) and 1 rf_predict launch; every id in [0, vocab),
   every logit finite; prefill ms per group, decode ms per step,
   tokens/s, peak device memory, the kernel's share of each prefill.
   After the counted run, group 1's prefill and 4 decode steps run
   again under `torch.profiler` for the device time by kind (ssd_chunk,
   matrix products, the rest) and the device's busy share;
8. parity  — the same engine at full width but 2 layers in f32, on the
   card (kernels) and on the host (plain versions) with the same
   weights: prefill and 4 decode steps' logits (both fed the card's
   ids) within atol/rtol 1e-3, and equal greedy ids wherever the top-2
   gap exceeds that.

Then it prints the `kernels` JSON line, the `nvidia-smi` line, and as
the last line `{"ok": true, "device": {...}}`. All numbers also go to
`chiprun_out/chip_smoke.json`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.control import WanifyController  # noqa: E402
from repro_torch.core.predictor import BwPredictor  # noqa: E402
from repro_torch.fleet import (BatchedRfPredictor, FleetController,  # noqa: E402
                               JobSpec, default_fleet_forest)
from repro_torch.kernels import build, ops, ssd_scan  # noqa: E402
from repro_torch.kernels.ref import rf_predict_ref, ssd_chunk_ref  # noqa: E402
from repro_torch.models import registry, ssm  # noqa: E402
from repro_torch.models.transformer import MambaLM  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
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

ARCH = "mamba2-2.7b"
SERVE_BATCH, S_MAX, N_REQUESTS, MAX_NEW = 4, 1024, 8, 16
PROMPT_LEN = (300, 700)
SSD_TOL = 1e-4            # kernel vs plain: the same f32 sums, reordered
PARITY_LAYERS, PARITY_STEPS, PARITY_TOL = 2, 4, 1e-3


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
        ops.ssd_chunk.launches = 0
        fleet.predictor.metrics.counter("kernel_calls").reset()
    records, secs = [], []
    for _ in range(ticks):
        t0 = time.perf_counter()
        records.append(fleet.tick())
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = {"rf_predict": ops.rf_predict.launches,
              "ssd_chunk": ops.ssd_chunk.launches} if counted else {}
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


# ----------------------------------------------------------------------
# ssd_chunk phase
# ----------------------------------------------------------------------
def ssd_random_inputs(B, nC, Q, H, P, N, seed, device):
    """f32 inputs at the reference tests' scales (x 0.1, B/C 0.3, da a
    negative half-normal x 0.1)."""
    rng = np.random.default_rng(seed)
    arrays = ((rng.normal(size=(B, nC, Q, H, P)) * 0.1),
              (rng.normal(size=(B, nC, Q, N)) * 0.3),
              (rng.normal(size=(B, nC, Q, N)) * 0.3),
              (-np.abs(rng.normal(size=(B, nC, H, Q))) * 0.1))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in arrays)


def check_ssd(args) -> float:
    """Kernel (on the CPU: the wrapper's plain path) vs the plain
    version on the same inputs, atol/rtol SSD_TOL. Returns max |diff|."""
    y, st = ops.ssd_chunk(*args)
    yp, sp = ssd_chunk_ref(*args)
    if args[0].device.type == "cuda":
        torch.cuda.synchronize()
    err = 0.0
    for got, want in ((y, yp), (st, sp)):
        got, want = got.cpu().numpy(), want.cpu().numpy()
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"ssd_chunk output {got.shape} (plain "
                                 f"{want.shape}) or non-finite values")
        np.testing.assert_allclose(got, want, atol=SSD_TOL, rtol=SSD_TOL)
        err = max(err, float(np.max(np.abs(got - want))))
    return err


def ssd_subsets(args, Bs=(1, 4), nCs=(1, 3)):
    """The inputs cut to each (B, nC) that they hold, made contiguous."""
    B, nC = args[0].shape[:2]
    for b in sorted({min(v, B) for v in Bs}):
        for c in sorted({min(v, nC) for v in nCs}):
            yield b, c, tuple(t[:b, :c].contiguous() for t in args)


def ssd_work(xq, Bq):
    """Bytes the call must move (each input read once, each output
    written once) and the f32 operations these inputs need: C.B for the
    causal (q, k) pairs once per chunk (shared by the heads); per head
    and causal pair the decay (subtract, exp, multiply) and the
    multiply-add into y over P; per head and row the state's decay
    (subtract, exp), x times it, and the multiply-add into [P, N]; the
    cumulative sum."""
    B, nC, Q, H, P = xq.shape
    N = Bq.shape[-1]
    chunks, pairs = B * nC, Q * (Q + 1) // 2
    nops = chunks * (2 * N * pairs + H * pairs * (3 + 2 * P)
                     + H * Q * (2 + P + 2 * P * N) + H * Q)
    nbytes = (xq.numel() + 2 * Bq.numel()) * xq.element_size() + \
        chunks * H * Q * 4 + xq.numel() * 4 + chunks * H * P * N * 4
    return nbytes, nops


def ssd_bound(xq, Bq):
    nbytes, nops = ssd_work(xq, Bq)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, nops


def ssd_device_ms(args, launches: int = 20, reps: int = 5) -> float:
    """Median device time of one launch: `launches` back-to-back wrapper
    calls between CUDA events, `reps` times, after warm-up (at
    milliseconds a launch, the host's per-call cost is hidden)."""
    for _ in range(3):
        ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            ops.ssd_chunk(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def time_ssd(args):
    bound_ms, by, nbytes, nops = ssd_bound(args[0], args[1])
    return {"shape": list(args[0].shape) + [args[1].shape[-1]],
            "dtype": str(args[0].dtype).replace("torch.", ""),
            "ms": ssd_device_ms(args),
            "wrapper_ms": call_ms(lambda: ops.ssd_chunk(*args), reps=11),
            "plain_ms": call_ms(lambda: ssd_chunk_ref(*args), reps=11),
            "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
            "ops": nops}


def capture_layer0(eng: Engine, tokens: np.ndarray):
    """Prefill `tokens` and return the inputs of its first ssd_chunk
    call (layer 0), cloned; `ssm` sees a capturing `ops` meanwhile."""
    seen = []

    def capture(*args):
        if not seen:
            seen.append(tuple(t.clone() for t in args))
        return ops.ssd_chunk(*args)

    ssm.ops = types.SimpleNamespace(ssd_chunk=capture)
    try:
        eng.prefill(tokens)
    finally:
        ssm.ops = ops
    return seen[0]


# ----------------------------------------------------------------------
# serve phases
# ----------------------------------------------------------------------
class CheckedEngine(Engine):
    """The port's Engine; it also checks that every logit it turns into
    ids is finite (after the step's time is taken)."""

    def _ids(self, logits, t0, key):
        ids = super()._ids(logits, t0, key)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"non-finite logits in a {key[:-2]} step")
        return ids


def serve_requests(vocab: int):
    """N_REQUESTS prompts of PROMPT_LEN tokens from default_rng(0)."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, N_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(1, vocab, n).astype(np.int32),
                    max_new=MAX_NEW) for i, n in enumerate(lengths)]


def groups_of(reqs, batch: int = SERVE_BATCH):
    return [reqs[i:i + batch] for i in range(0, len(reqs), batch)]


def check_served(out, reqs, vocab: int) -> None:
    for r in reqs:
        ids = out[r.rid]
        if len(ids) != r.max_new or not r.done:
            raise AssertionError(f"request {r.rid}: {len(ids)} ids")
        if not all(0 <= i < vocab for i in ids):
            raise AssertionError(f"request {r.rid}: id outside [0, {vocab})")


def device_kernels(fn):
    """Run `fn` under `torch.profiler` (CUDA activity only) and return
    the device time of its kernels (ms) in total and by kind: the
    ssd_chunk kernels, matrix products (cuBLAS's nvjet / gemm / gemv
    and CUTLASS names), and the rest; the number of kernels run; and
    the five longest kernels by total time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {"ssd_chunk": 0.0, "matmul": 0.0, "other": 0.0}
    rows, n_kernels = [], 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        kind = "ssd_chunk" if "ssd_" in name else "matmul" if any(
            k in name for k in ("nvjet", "gemm", "gemv", "cutlass", "xmma",
                                "cublas")) else "other"
        kinds[kind] += ms
        n_kernels += e.count
        rows.append((ms, e.count, e.key[:60]))
    rows.sort(reverse=True)
    return {"device_ms": sum(kinds.values()), "by_kind": kinds,
            "kernels": n_kernels,
            "top": [{"ms": ms, "count": n, "name": k}
                    for ms, n, k in rows[:5]]}


def check_parity(card: Engine, host: Engine, tokens: np.ndarray,
                 steps: int = PARITY_STEPS):
    """Prefill `tokens` on both engines and decode `steps` steps, both
    fed the card's ids; logits within PARITY_TOL and equal ids wherever
    the host's top-2 gap exceeds it. Returns (max |diff|, max |logit|,
    ids compared, ids equal)."""
    err, mag, compared, equal = 0.0, 0.0, 0, 0
    cur = None
    for step in range(steps + 1):
        if step == 0:
            ids_c, ids_h = card.prefill(tokens), host.prefill(tokens)
        else:
            ids_c, ids_h = card.decode(cur), host.decode(cur)
        lc = card.last_logits.float().cpu().numpy()
        lh = host.last_logits.float().numpy()
        err = max(err, float(np.max(np.abs(lc - lh))))
        mag = max(mag, float(np.max(np.abs(lh))))
        np.testing.assert_allclose(lc, lh, atol=PARITY_TOL, rtol=PARITY_TOL)
        top2 = np.sort(lh, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * PARITY_TOL * \
            (1 + np.abs(top2[:, 1]))
        if (ids_c[clear] != ids_h[clear]).any():
            raise AssertionError(f"step {step}: greedy ids differ where the "
                                 f"top-2 gap exceeds the tolerance")
        compared += int(clear.sum())
        equal += int((ids_c == ids_h).sum())
        cur = ids_c
    return err, mag, compared, equal


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    # f32 products in full f32 on the card (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}

    # 1. device
    smi = nvidia_smi()
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")
    results["device"] = {"nvidia_smi": smi, "torch": torch.__version__,
                         "cuda": torch.version.cuda}

    # 2. build: one nvcc per kernel source, started together
    t0 = time.perf_counter()
    texts = build.compile_sources(["rf_predict", "ssd_chunk"])
    results["build_s"] = time.perf_counter() - t0
    log(f"[build] rf_predict + ssd_chunk in {results['build_s']:.1f} s")
    for name, text in texts.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line}")
    results["build_log"] = texts
    dims = get_config(ARCH).ssm
    smem = ssd_scan.smem_bytes(dims.chunk, dims.head_dim, dims.d_state)
    results["build_smem"] = smem
    log(f"[build] ssd_chunk: dynamic shared memory per block at "
        f"Q={dims.chunk}, P={dims.head_dim}, N={dims.d_state}: " +
        ", ".join(f"{k} {v} B" for k, v in smem.items()))

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
    if counts != {"rf_predict": TICKS, "ssd_chunk": 0} or \
            fleet.predictor.kernel_calls != TICKS:
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

    # 6. ssd_chunk: kernel vs plain; the serve model's layer-0 inputs
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    model = registry.build_model(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    results["model_init_s"] = time.perf_counter() - t0
    ctl = WanifyController(WanSimulator(seed=0),
                           BwPredictor(paper, device=dev), n_pods=2)
    eng = CheckedEngine(cfg, model, ServeConfig(batch=SERVE_BATCH,
                                                s_max=S_MAX),
                        controller=ctl)
    reqs = serve_requests(cfg.vocab)
    # warm-up prefills of both groups (cuBLAS set-up, the cast to bf16)
    # that also capture layer 0's kernel inputs, and a warm-up decode
    captured = [capture_layer0(eng, eng.batch_tokens(g))
                for g in groups_of(reqs)]
    eng.decode(np.zeros(SERVE_BATCH, np.int32))
    log(f"[ssd] {ARCH}: {sum(p.numel() for p in model.parameters())} "
        f"params on the card in {results['model_init_s']:.1f} s; layer-0 "
        f"inputs per group: " + ", ".join(
            f"{tuple(c[0].shape)} {c[0].dtype}" for c in captured))
    ssd_err, ssd_cases = 0.0, []
    cases = [("serve-bf16", captured[0]),
             ("f32-256x80x64x128", ssd_random_inputs(4, 3, 256, 80, 64, 128,
                                                     1, dev)),
             ("f32-16x16x16x16", ssd_random_inputs(4, 3, 16, 16, 16, 16, 2,
                                                   dev))]
    for name, args in cases:
        for b, c, sub in ssd_subsets(args):
            err = check_ssd(sub)
            ssd_err = max(ssd_err, err)
            ssd_cases.append({"case": name, "B": b, "nC": c, "err": err})
            log(f"[ssd] {name} B={b} nC={c}: within {SSD_TOL} of plain "
                f"(max |diff| {err:.3e})")
    ssd_timing = [time_ssd(c) for c in captured]
    for t in ssd_timing:
        log(f"[ssd] ssd_chunk {t['shape']} {t['dtype']}: kernel "
            f"{t['ms']:.4f} ms (device, events over 20 launches) | wrapper "
            f"call {t['wrapper_ms']:.4f} ms | plain {t['plain_ms']:.4f} ms "
            f"| bound {t['bound_ms']:.5f} ms by {t['bound_by']} "
            f"({t['bytes']} B, {t['ops']} ops) | library call: none (no "
            f"single PyTorch call computes the SSD chunk)")
    results["ssd_chunk"] = {"cases": ssd_cases, "timing": ssd_timing}

    # 7. serve: the slice's main path, counts zeroed just before it
    eng.timings = {"prefill_s": [], "decode_s": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.ssd_chunk.launches = 0
    ops.rf_predict.launches = 0
    t0 = time.perf_counter()
    eng.replan()
    schedule = eng.migration_schedule()
    t1 = time.perf_counter()
    out = eng.serve(reqs)
    serve_s = time.perf_counter() - t1
    replan_s = t1 - t0
    serve_counts = {"ssd_chunk": ops.ssd_chunk.launches,
                    "rf_predict": ops.rf_predict.launches}
    peak = torch.cuda.max_memory_allocated()
    n_groups = len(groups_of(reqs))
    if serve_counts != {"ssd_chunk": n_groups * cfg.n_layers,
                        "rf_predict": 1}:
        raise AssertionError(f"serve launches {serve_counts}, expected "
                             f"{n_groups * cfg.n_layers} ssd_chunk (one "
                             f"per layer per prefill) and 1 rf_predict")
    check_served(out, reqs, cfg.vocab)
    prefill_ms = [v * 1e3 for v in eng.timings["prefill_s"]]
    decode_ms = [v * 1e3 for v in eng.timings["decode_s"]]
    tokens = sum(len(v) for v in out.values())
    shares = [cfg.n_layers * t["ms"] / p
              for t, p in zip(ssd_timing, prefill_ms)]
    results["serve"] = {
        "arch": ARCH, "layers": cfg.n_layers, "batch": SERVE_BATCH,
        "requests": N_REQUESTS, "max_new": MAX_NEW,
        "prompt_lens": [len(r.prompt) for r in reqs],
        "launches": serve_counts, "replan_s": replan_s,
        "schedule": schedule, "prefill_ms": prefill_ms,
        "decode_ms": decode_ms,
        "decode_ms_median": float(np.median(decode_ms)),
        "serve_s": serve_s, "tokens": tokens, "tokens_per_s": tokens / serve_s,
        "peak_bytes": peak, "ssd_share_of_prefill": shares,
        "out": {str(k): v for k, v in out.items()}}
    log(f"[serve] {ARCH} {cfg.n_layers} layers, {N_REQUESTS} requests "
        f"(prompts {results['serve']['prompt_lens']}), {tokens} tokens in "
        f"{serve_s:.3f} s = {tokens / serve_s:.1f} tokens/s; launches "
        f"{serve_counts}")
    log(f"[serve] replan {replan_s * 1e3:.1f} ms, migration schedule "
        f"{schedule}")
    log("[serve] prefill ms per group: " + ", ".join(
        f"{p:.2f} (ssd_chunk {s:.1%})" for p, s in zip(prefill_ms, shares))
        + f"; decode ms per step (one token per slot): median "
        f"{np.median(decode_ms):.3f}, p90 {np.percentile(decode_ms, 90):.3f}"
        f"; peak device memory {peak / 2**30:.3f} GiB")
    log(f"[serve] ids: " + "; ".join(f"{k}: {v[:6]}" for k, v in
                                      sorted(out.items())[:3]))
    # where the device time goes, after the counted run: group 1's
    # prefill and 4 decode steps again under the profiler; busy share
    # against the untraced run's wall times above
    toks = eng.batch_tokens(groups_of(reqs)[0])
    prof = {"prefill": device_kernels(lambda: eng.prefill(toks))}
    nxt = eng.prefill(toks)
    prof["decode"] = device_kernels(lambda: [eng.decode(nxt)
                                             for _ in range(4)])
    prof["prefill"]["busy_share"] = prof["prefill"]["device_ms"] / \
        prefill_ms[0]
    prof["decode"]["busy_share"] = prof["decode"]["device_ms"] / 4 / \
        float(np.median(decode_ms))
    results["serve"]["profile"] = prof
    for phase, pr in prof.items():
        log(f"[serve] profile {phase}: {pr['kernels']} device kernels, "
            f"{pr['device_ms']:.2f} ms ({pr['busy_share']:.1%} of the "
            f"untraced wall time) by "
            "kind " + ", ".join(f"{k} {v:.2f}" for k, v in
                               pr["by_kind"].items()) + "; top: " +
            ", ".join(f"{t['name']} x{t['count']} {t['ms']:.2f}"
                      for t in pr["top"]))

    # 8. parity: 2 layers at full width in f32, card vs host
    pcfg = cfg.replace(n_layers=PARITY_LAYERS, dtype="float32")
    card_model = registry.build_model(
        pcfg, torch.Generator(device=dev).manual_seed(0), dev)
    host_model = MambaLM(pcfg, torch.device("cpu"), torch.float32)
    host_model.load_state_dict(card_model.state_dict())
    sc = ServeConfig(batch=SERVE_BATCH, s_max=S_MAX)
    t0 = time.perf_counter()
    err, mag, compared, equal = check_parity(
        CheckedEngine(pcfg, card_model, sc),
        CheckedEngine(pcfg, host_model, sc, device="cpu"),
        eng.batch_tokens(groups_of(reqs)[0]))
    results["parity"] = {"layers": PARITY_LAYERS, "steps": PARITY_STEPS,
                         "tol": PARITY_TOL, "max_abs_err": err,
                         "max_abs_logit": mag, "ids_compared": compared,
                         "ids_equal": equal,
                         "s": time.perf_counter() - t0}
    log(f"[parity] {PARITY_LAYERS} layers f32, prefill + {PARITY_STEPS} "
        f"decode steps: logits within {PARITY_TOL} of the host (max |diff| "
        f"{err:.3e}, max |logit| {mag:.3f}); ids equal on {compared} "
        f"clear top-2 gaps ({equal} of {(PARITY_STEPS + 1) * SERVE_BATCH} "
        f"equal in all)")

    t = timing[f"n{TICK_ROWS}"]
    s0 = ssd_timing[0]
    kernels = {"kernels": [{
        "name": "rf_predict", "route": "cuda",
        "source": "src/repro_torch/csrc/rf_predict.cu",
        "replaces": "src/repro/kernels/rf_predict.py:74",
        "launches": counts["rf_predict"], "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}, {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:59",
        "launches": serve_counts["ssd_chunk"], "max_abs_err": ssd_err,
        "ms": s0["ms"], "plain_ms": s0["plain_ms"],
        "bound_ms": s0["bound_ms"], "bound_by": s0["bound_by"],
        "library_ms": None}]}
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
