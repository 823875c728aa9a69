#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`src/repro_torch`) on one
NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

Every phase is fatal: a failure exits non-zero before the result line.

1. device  — `nvidia-smi` name and power limit, torch and CUDA versions
   (exits non-zero when `torch.cuda.is_available()` is false);
2. build   — compiles the kernel sources `src/repro_torch/csrc/rf_predict.cu`,
   `ssd_chunk.cu`, `quantize.cu`, `silu.cu` and `waterfill.cu` with
   `nvcc`, one process each, started together,
   and prints ptxas's reports (registers, static shared memory, spills),
   per ssd_chunk kernel its registers, spills and the dynamic shared
   memory of a block at the serve shape, and the counts of tensor-core
   (HGMMA) and asynchronous-copy (LDGSTS, UTMALDG, UBLKCP) instructions
   in ssd_chunk's SASS (`cuobjdump -sass`); the same for quantize's
   grouped (persistent) and tile (cluster) kernels; fails if there is no
   HGMMA in ssd_chunk's SASS, no bulk copy (UBLKCP) in quantize's, or a
   spill in a quantize kernel; and rf_predict's two kernels', silu's
   two kernels' and waterfill's kernel's registers and spills, failing
   on a spill;
3. kernel  — the rf_predict CUDA kernel against its plain PyTorch
   version on the card, bit-equal (both of its kernels: the one the
   wrapper picks and the other), on the paper's forest (100 trees,
   depth 10, trained by `train_default_forest(600)`) over all dataset
   rows, at one tick's rows, at the 16-variant sweep's 3,072 and on
   ragged n, and on the fleet demo forest (8 x 5); times (each call on
   the forest's packed nodes, one launch; and each kernel forced) at
   one tick's rows (n=192), at 3,072 dataset rows (as many as a
   16-variant sweep predicts) and at the whole dataset, beside the
   bound and the launch floor (an empty kernel replayed in a graph);
   and each kernel forced over a sweep of n, from which the wrapper's
   choice of kernel and warps is read;
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
5b. scenarios — the scenario engines (`repro_torch.scenarios`,
   `repro_torch.fleet.scenario`), each part with its launch counts set
   to 0 just before it and read just after:
   (1) the 12 `scenario/*/seed3`, 4 `fleet/*/seed3` and 3
   `placement/*` runs through `repro_torch.scenarios.goldens`, the
   fleet's forest on the card: every sha256 equal to its pin in
   `tests/data/trace_golden.json`, one `rf_predict` launch a fleet tick
   (50);
   (2) `congestion` and `provider_shift` at seed 3 with
   `BwPredictor(paper forest)` on the card and on the host: `to_json()`
   byte-equal, one `rf_predict` launch a replan;
   (3) the water-fill kernel against its plain version on the card and
   the host numpy loop, on seeded cases built as the reference's
   water-fill tests build them, at (B, N) = (1, 8), (16, 8), (1, 16),
   (64, 16), (1, 32): rates within 1e-9, equal iterations; times of the
   kernel (device, a graph of 20 calls), of the numpy wrapper's call
   with its copies and synchronise (host), of the host loop (host) and
   of the plain version, beside the bound (bytes; f64 operations at
   the CUDA cores' rate) and the launch floor;
   (4) the 12 scenarios with `waterfill_backend="cuda"`, every fill also
   run by the host loop on the same inputs (equal iterations, rates
   within 1e-9), every integer field of every step equal to the numpy
   run's and floats within rtol 1e-9; one launch a fill;
   (5) the main phase's fleet under `waterfill_backend` numpy and cuda,
   A B B A in one process: budgets, conns and plan signatures equal,
   BW within rtol 1e-9; fills a tick and tick median / p90 per backend;
5c. fused — `FleetController.run_fused(24)` (`repro_torch.fleet.fused`)
   on the main phase's fleet under the fused contract (quiet captures:
   snapshot_sigma = host_sigma = 0; seed 0; the paper forest): against
   24 sequential ticks of an identical fleet with waterfill_backend
   numpy and cuda, budgets and conns equal, cap and achieved BW within
   1e-6, final conns equal and AIMD targets within 1e-6, and one more
   sequential tick after the run matching; a 16-variant `sweep` of 24
   steps (the us-east/us-west link degraded at step 1 to 0.20..0.95)
   equal to 16 single `run_fused` calls; every tick loop under
   `torch.cuda.set_sync_debug_mode("error")`; launches, counts zeroed
   just before and read just after: 1 `rf_predict` and 2 `fill_rates`
   a tick in both `run` and `sweep`. Prints ms a tick of the sequential
   and the fused tick, A B B A in one process (fused: the whole call and
   the loop to the device's end; warm), the host µs a tick of the
   loop's issue outside the three custom launches, the sweep's epochs/s,
   and from `torch.profiler` over one run's loop the kernels a tick and
   the device's busy share;
5d. placement — the 3 `placement/*` pins with
   `REPRO_PLACEMENT_BACKEND=torch` on the card; the greedy and
   exhaustive searches of the named workloads at N in {3, 4, 8} with
   `backend="torch"` on the card deciding as numpy, and every candidate
   batch of the numpy searches priced by both backends within rtol
   1e-12; host µs a batch per backend (median).
5e. planes — the overlay and predictor-lifecycle planes, each part with
   its launch counts set to 0 just before it and read just after:
   (1) overlay: `cable_cut_reroute` at seed 3, overlay off and on, with
   `waterfill_backend` numpy and cuda: the numpy runs hash to their
   pins (`tests/data/trace_golden.json` off, `scenarios/goldens.py`'s
   `PLANE_PINS` on); on cuda one `waterfill` launch per fill
   (`sim.fill_calls`), each fill re-run by the host loop (equal
   iterations, rates within 1e-9), relays, conns and plan signatures
   equal to the numpy run's and floats within rtol 1e-9; the routed
   run's `achieved_min` above the direct run's at every step from 14
   to 39. Prints fills a run and one routed fill's kernel time (device,
   a graph of 20 calls) beside the host loop, the bound and the launch
   floor;
   (2) placement under the overlay: `run_placement_scenario(
   "cable_cut_reroute", seed=3, overlay=off/on)` on the `torch`
   evaluator on the card: decisions equal to the numpy evaluator's,
   traces hashing to their pins, the total makespan with the overlay
   on below the one with it off;
   (3) lifecycle: `run_lifecycle_comparison("provider_shift_drift",
   seed=3)` with the pretrained forest on the card (`BwPredictor`, the
   `rf_predict` kernel): every prediction equal to the plain version's
   on the host on the forest in force, the first launch after each
   refit swap reading the new forest (it differs from the old one's
   answer), `rf_predict` launches of each mode equal to its replans
   plus its steps, the result equal to a host run's field for field
   and its traces to their f32 pins; under numpy inference the traces
   equal their numpy pins; the headline assertions of
   `tests/test_lifecycle.py` as written. Prints signal and refresh
   steps and monitoring dollars per mode, and the kernel's time at
   n=56 (the 8-DC mesh's rows) on the refit forest beside its bound,
   the plain version and the launch floor.
5f. faults — the fault plane and the obs exports on the card, each part
   with its launch counts set to 0 just before it and read just after:
   (1) `chaos_report(seed=3)` (`repro_torch.faults.harness`: the 8 chaos
   scenarios, ladder and naive) with its fills on the `cuda` backend and
   the fleet's forest on the card, every row equal to the same report
   on the host (`device="cpu"`: numpy fill, plain forest): `crashed`,
   `error`, `steps_completed`, `injected`, `rollbacks` equal, the floats
   within 1e-9 relative; every fill re-run by the host loop (equal
   iterations, rates within 1e-9), the fills with dead pairs (flows
   over a link of zero capacity) counted apart, none with a non-finite
   input; one `waterfill` launch a fill and one `rf_predict` launch a
   fleet tick; the headline: the ladder crashes 0 times, naive 4. One
   dead-pair fill timed beside the launch floor and the bound;
   (2) the main phase's 16 jobs (paper forest, `m_total=8`) as a
   24-tick `FleetScenarioSpec` on the quiet mesh, ap-se blacked out at
   tick 4 and restored at 8, `faults="on"`, on the card: 24
   `rf_predict` launches, one `waterfill` launch a fill (each checked);
   records equal to the host run's (integers exact, BW within 1e-6);
   every job spanning ap-se capped at 0 on its dead pairs at ticks 4-7
   and above 0 elsewhere; the jobs that do not span it keep the budget
   and conns series of the same fleet with faults off and no events;
   (3) `python -m repro_torch.obs.cli run steady --seed 3` on the card
   (in this process): `check_run` clean, one `waterfill` launch a fill,
   the document less the spans' wall times equal to the host run's
   (floats within 1e-9 relative). Every part prints its wall time and
   the `nvidia-smi` line.
6. ssd     — the ssd_chunk CUDA kernels against their plain PyTorch
   version on the card, atol/rtol 1e-4 (both take the cumulative decay
   in one order; the products add in another, bf16 inputs on the tensor
   cores with f32 operands split into bf16 hi and lo): on the bf16
   inputs captured from layer 0 of each group's prefill of the serve
   model below, on f32 random inputs at (Q,H,P,N) = (256,80,64,128) and
   at (16,16,16,16), each with nC in {1, 3} and B in {1, 4}; times at
   both groups' serve shapes beside the bound (bytes; the contractions
   at the bf16 tensor-core rate, the elementwise work at the f32 rate);
   then the silu and silu_gate CUDA kernels against their plain versions,
   bit-equal, on layer 0's inputs of both prefills and of a decode step
   in the layouts the model hands them (z a slice of the in-projection's
   output), timed at group 1's prefill and the decode step beside the
   bound (bytes);
7. serve   — the slice's main path: `mamba2-2.7b` at its full width and
   depth (64 layers, bf16 compute, f32 params, weights from a
   `torch.Generator` seeded 0) behind `Engine(..., ServeConfig(batch=4,
   s_max=1024))` with a `WanifyController` on the paper forest:
   `replan()` and its migration schedule, then 8 requests of 300-700
   prompt tokens (`default_rng(0)`), 16 new tokens each: two prefills
   and 32 decode steps. Exactly 2 x 64 ssd_chunk launches (one per
   layer per prefill), one silu and one silu_gate launch per layer per
   step, and 1 rf_predict launch; every id in [0, vocab),
   every logit finite; prefill ms per group, decode ms per step,
   tokens/s, peak device memory, the kernel's share of each prefill.
   After the counted run, group 1's prefill and 4 decode steps run
   again under `torch.profiler` for the device time by kind (ssd_chunk,
   silu, matrix products, the rest) and the device's busy share;
8. parity  — the same engine at full width but 2 layers in f32, on the
   card (kernels) and on the host (plain versions) with the same
   weights: prefill and 4 decode steps' logits (both fed the card's
   ids) within atol/rtol 1e-3, and equal greedy ids wherever the top-2
   gap exceeds that.
9. quantize — the quantize and dequantize CUDA kernels against their
   plain versions on the card, bit-equal (payload, scales, f32 and bf16
   outputs): the tile form on f32 and bf16 at 256^2, 1024^2 and 4096^2,
   8 and 4 bits; the grouped form with G = 1 and 4 at ragged lengths and
   at the migrate phase's parts (21 M f32 state elements, 516 K bf16
   conv elements), with its accumulating dequantize (an FMA into an f32
   accumulator, as the gradient sync decodes); times at 4096^2, at
   each migrate part and at the wansync phase's largest part ([4,
   108,298,240] f32, quantize and the accumulating dequantize), beside
   the bound;
10. migrate — the slice's main path: the serve engine's cache after
   group 1's prefill (64 layers, B=4: state [64,4,80,64,128] f32, conv
   [64,4,3,5376] bf16) moved by `kv_migrate` from pod 0 to 4 ranks
   (processes on the one card, gloo) under (a) the plan of
   `Engine.replan()` with a 4-pod controller and (b) `fixed_plan()`, with
   and without compression. Each rank zeroes the launch counts just
   before each run and reads them after; they must equal the schedule's
   (48 quantize + 48 dequantize per rank under (b)). Every receiving
   rank's cache is bit-equal to the plain codec's round trip of pod 0's
   leaves on the host, and to pod 0's own without compression. Pod 1's
   cache goes back to the engine, which continues group 1's decode for
   16 steps: the ids equal its own continuation without compression;
   with 8 bits the agreement is printed. Per offset phase: wall ms, wire
   bytes and encode / decode device ms;
11. wansync — the engine freed, a gradient tree with the shapes of
   `mamba2-2.7b`'s stacked parameters at full width and 32 of its 64
   layers (inputs, outputs and psum of all 64 do not fit 80 GB), pod r's
   values base * (r + 1), 4 pods: `psum_allreduce_batched`, then
   `wan_allreduce_batched` under plan (b) uncompressed (within rtol 1e-5
   of psum) and compressed (within the quantization bound), each timed
   twice; launches equal to the schedule's; peak device memory. Then
   the largest leaf's compressed call under `torch.profiler`: the parts
   are read in place, so no copy kernel runs right before a quantize.

Then it prints the `kernels` JSON line, the `nvidia-smi` line, and as
the last line `{"ok": true, "device": {...}}`. All numbers also go to
`chiprun_out/chip_smoke.json`.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import compat  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.control import WanifyController  # noqa: E402
from repro_torch.control.schedule import (offset_schedule,  # noqa: E402
                                          wire_decode, wire_encode)
from repro_torch.core.plan import WanPlan  # noqa: E402
from repro_torch.core.predictor import (BwPredictor,  # noqa: E402
                                        SnapshotPredictor,
                                        assemble_features)
from repro_torch.core.wansync import (psum_allreduce_batched,  # noqa: E402
                                      wan_allreduce_batched)
from repro_torch.fleet import fused as fused_mod  # noqa: E402
from repro_torch.faults import DcBlackout, DcRestore  # noqa: E402
from repro_torch.faults.harness import chaos_report  # noqa: E402
from repro_torch.faults.scenarios import (QUIET,  # noqa: E402
                                          chaos_scenario_names,
                                          get_chaos_scenario)
from repro_torch.fleet import (BatchedRfPredictor, FleetController,  # noqa: E402
                               FleetEngine, FleetScenarioSpec, FusedFleet,
                               JobSpec, default_fleet_forest,
                               fleet_scenario_names, get_fleet_scenario,
                               make_schedule)
from repro_torch.kernels import build, ops, ssd_scan  # noqa: E402
from repro_torch.kernels import rf_predict as rf_kernel  # noqa: E402
from repro_torch.kernels import waterfill as wfk  # noqa: E402
from repro_torch.kernels.quantize import qmax  # noqa: E402
from repro_torch.lifecycle import harness as lc_harness  # noqa: E402
from repro_torch.lifecycle import run_lifecycle_comparison  # noqa: E402
from repro_torch.kernels.ref import (dequantize_groups_add_ref,  # noqa: E402
                                     dequantize_groups_ref,
                                     dequantize_ref, fill_rates_ref,
                                     quantize_groups_ref,
                                     quantize_ref, rf_predict_ref,
                                     silu_gate_ref, silu_ref, ssd_chunk_ref)
from repro_torch.models import registry, ssm  # noqa: E402
from repro_torch.models.transformer import (MambaLM, stack_cache,  # noqa: E402
                                            unstack_cache)
from repro_torch.obs import check_run  # noqa: E402
from repro_torch.obs import cli as obs_cli  # noqa: E402
from repro_torch.obs import load as obs_load  # noqa: E402
from repro_torch.obs.spans import SpanTracer  # noqa: E402
from repro_torch import placement as pl  # noqa: E402
from repro_torch.placement import cost as pl_cost  # noqa: E402
from repro_torch.scenarios import (ScenarioEngine, at,  # noqa: E402
                                   get_scenario, goldens, run_scenario,
                                   scenario_names)
from repro_torch.scenarios.events import LinkDegrade  # noqa: E402
from repro_torch.serve.engine import (Engine, Request,  # noqa: E402
                                      ServeConfig, kv_migrate)
from repro_torch.wan.dataset import (generate_dataset,  # noqa: E402
                                     train_default_forest)
from repro_torch.wan.monitor import egress_price_vector  # noqa: E402
from repro_torch.wan.simulator import (WanSimulator,  # noqa: E402
                                       fill_rates_host)

# H100 SXM peaks (NVIDIA data sheet): HBM rate, non-tensor f32 rate,
# the dense bf16 tensor-core rate and f64 on the CUDA cores (the
# water-fill's arithmetic; 67 TFLOP/s is f64 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
F64_OPS_PER_S = 34e12

N_JOBS, TICKS, M_TOTAL = 16, 24, 8          # benchmarks/tick_bench.py
PRIORITIES = (1.0, 2.0, 4.0)
TICK_ROWS = N_JOBS * 4 * 3                  # 12 ordered pairs per job
BACKEND_TICKS = 5

ARCH = "mamba2-2.7b"
SERVE_BATCH, S_MAX, N_REQUESTS, MAX_NEW = 4, 1024, 8, 16
PROMPT_LEN = (300, 700)
SSD_TOL = 1e-4            # kernel vs plain: the same f32 sums, reordered
PARITY_LAYERS, PARITY_STEPS, PARITY_TOL = 2, 4, 1e-3

QUANT_TILES = ((256, 256), (1024, 1024), (4096, 4096))
QUANT_LENGTHS = (1, 255, 65537)         # ragged group lengths
N_PODS, POD_DEADLINE = 4, 600           # seconds for the 4 ranks' run
# pod 1 continues group 1's decode from its migrated cache; the serve
# phase's 16 steps
MIGRATE_STEPS = MAX_NEW
WANSYNC_LAYERS = 32     # of 64: inputs, outputs and psum do not fit 80 GB

PIN_SEED = 3                                # the pinned runs' seed
BW_SCENARIOS = ("congestion", "provider_shift")
# (B, N) of the water-fill checks: one 8-DC fill (the engines' and the
# tick's), a 16-fill batch, the 16-DC mesh the reference's tests reach,
# a 64-fill batch of it, and the widest mesh the kernel takes
WF_SHAPES = ((1, 8), (16, 8), (1, 16), (64, 16), (1, 32))
WF_TOL = 1e-9             # the reference's own (tests/test_waterfill_kernel.py)
WF_OPS_PER_PAIR = 20      # f64 operations per pair per iteration
TRACE_INT_FIELDS = ("step", "events", "n_pods", "plan_sig", "conns_total",
                    "replans", "cache_builds", "cache_hits")
TRACE_FLOAT_FIELDS = ("dt", "achieved_min", "achieved_mean",
                      "monitored_min", "monitored_mean", "predicted_min",
                      "predicted_mean")


def fixed_plan() -> WanPlan:
    """`tests/test_system.py`'s 4-pod plan: 6 connections and 150 Mbps
    between pods two or more apart on the ring, 2 and 900 Mbps between
    neighbours; its schedule is 8 chunks at 8 bits on every offset."""
    far = [[abs(i - j) % 4 > 1 for j in range(4)] for i in range(4)]
    return WanPlan(n_pods=4,
                   conns=tuple(tuple(6 if f else 2 for f in r) for r in far),
                   pred_bw=tuple(tuple(150.0 if f else 900.0 for f in r)
                                 for r in far),
                   compress_bits=(8, 8, 8, 8))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuobjdump_path() -> str:
    """`cuobjdump`: on PATH, under $CUDA_HOME, else the copy that the
    triton package carries."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(home, "bin", "cuobjdump")):
        if cand and os.path.isfile(cand):
            return cand
    try:
        import triton
        cand = Path(triton.__file__).parent / "backends" / "nvidia" / \
            "bin" / "cuobjdump"
        if cand.is_file():
            return str(cand)
    except ImportError:
        pass
    raise RuntimeError("cuobjdump not found (PATH, $CUDA_HOME/bin, triton)")


SASS_OPS = ("HGMMA", "LDGSTS", "UTMALDG", "UBLKCP")
# quantize.cu's kernels of this design: the grouped form's persistent
# kernel and the tile form's cluster kernel
QUANT_KERNELS = ("quantize_groups_kernel", "quantize_tile_cluster_kernel")
RF_KERNELS = ("rf_tile_kernel", "rf_pair_kernel")
SILU_KERNELS = ("silu_kernel", "silu_gate_kernel")
WF_KERNELS = ("waterfill_kernel",)
SWEEP_ROWS = 16 * TICK_ROWS    # a 16-variant sweep (benchmarks/tick_bench.py)


def sass_counts(lib: Path) -> dict:
    """How many tensor-core (HGMMA) and asynchronous-copy (LDGSTS:
    cp.async; UTMALDG: TMA; UBLKCP: bulk copy) instructions the
    library's SASS holds."""
    sass = subprocess.run([cuobjdump_path(), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}


def ptxas_report(text: str, kernels) -> dict:
    """{kernel: registers, spill bytes and static shared memory} from
    nvcc's -Xptxas -v output, for each of `kernels` (matched inside the
    mangled names); where a kernel has several instantiations (f32 and
    bf16), the largest of each number and their count."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = next((k for k in kernels if k in m.group(1)), None)
            if cur is not None:
                rep = out.setdefault(cur, {})
                rep["instances"] = rep.get("instances", 0) + 1
            continue
        if cur is None:
            continue
        rep = out[cur]
        found = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found["spill_stores"], found["spill_loads"] = map(int,
                                                              m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            found["static_smem"] = int(smem.group(1)) if smem else 0
        for k, v in found.items():
            rep[k] = max(rep.get(k, 0), v)
    return out


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
    version on the same inputs; bit-equal. On the card both kernels are
    held: the one the wrapper picks, through `ops.rf_predict` on the
    forest's packed nodes as the predictors call it, and the other one
    launched directly. Returns max |diff|."""
    packed = packed_on(forest, device)
    nodes = rf_kernel.pack_nodes(packed[0], packed[1])
    Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)
    got = ops.rf_predict(*packed, Xt, depth=forest.depth, nodes=nodes)
    want = rf_predict_ref(*packed, Xt, forest.depth)
    outs = [got]
    if device.type == "cuda" and len(X):
        picked = rf_kernel.launch_shape(
            len(X), packed[0].shape[0], X.shape[1],
            torch.cuda.get_device_properties(device).multi_processor_count)
        other = rf_kernel.LaunchShape("pair") if picked.kernel == "tile" \
            else rf_kernel.LaunchShape("tile", rf_kernel.BATCH_WARPS)
        outs.append(torch.full_like(want, float("nan")))
        rf_kernel.launch(nodes, packed[2], Xt, outs[-1], forest.depth,
                         shape=other)
        torch.cuda.synchronize()
    err = 0.0
    for out in outs:
        got, ref = out.cpu().numpy(), want.cpu().numpy()
        if got.shape != (len(X),) or not np.isfinite(got).all():
            raise AssertionError(f"kernel output shape {got.shape} or "
                                 f"non-finite values at n={len(X)}")
        np.testing.assert_array_equal(got, ref)
        if len(X):
            err = max(err, float(np.max(np.abs(got - ref))))
    return err


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


def roofline(nbytes: int, nops: int):
    """The least time the card could take for this work, in ms, and what
    bounds it: the bytes over the HBM rate or the f32 operations over
    the f32 rate, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def bound(forest, X):
    nbytes, nops = work_of(forest, X)
    return roofline(nbytes, nops) + (nbytes, nops)


def graph_ms(fn, launches: int = 20, reps: int = 11) -> float:
    """Median device time of one call: `launches` back-to-back calls
    captured in a CUDA graph, replayed `reps` times between CUDA events
    (the graph keeps the host's per-call cost out)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
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


def device_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Median device time of one call: `launches` back-to-back calls
    between CUDA events, `reps` times, after warm-up (at milliseconds a
    call, the host's per-call cost is hidden)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
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


def launch_floor_ms() -> float:
    """Device time of one launch of an empty kernel, replayed in a graph
    like the timed calls: the floor a call at a handful of tiles is read
    against."""
    lib = rf_kernel._lib()
    return graph_ms(lambda: lib.rf_predict_empty_launch(
        torch.cuda.current_stream().cuda_stream), launches=50, reps=21)


def time_kernel(forest, X):
    """The wrapper's call on the forest's packed nodes (one launch), and
    each kernel forced (the pair kernel, the tile kernel at the warps
    the wrapper would give it), beside the plain version and the bound."""
    dev = torch.device("cuda")
    packed = packed_on(forest, dev)
    nodes = rf_kernel.pack_nodes(packed[0], packed[1])
    Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
    out = torch.empty(len(X), dtype=torch.float32, device=dev)
    bound_ms, by, nbytes, nops = bound(forest, X)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    T = packed[0].shape[0]
    shape = rf_kernel.launch_shape(len(X), T, X.shape[1], sms)
    tile = rf_kernel.launch_shape(max(len(X), rf_kernel.PAIR_ROWS + 1), T,
                                  X.shape[1], sms)

    def call():
        return ops.rf_predict(*packed, Xt, depth=forest.depth, nodes=nodes)

    def forced(cut):
        return lambda: rf_kernel.launch(nodes, packed[2], Xt, out,
                                        forest.depth, shape=cut)
    return {
        "n": len(X), "trees": T, "depth": forest.depth,
        "shape": vars(shape),
        "ms": graph_ms(call, launches=50, reps=21),
        "pair_ms": graph_ms(forced(rf_kernel.LaunchShape("pair")),
                            launches=50, reps=21),
        "tile_ms": graph_ms(forced(tile), launches=50, reps=21),
        "tile_warps": tile.warps,
        "wrapper_ms": call_ms(call),
        "plain_ms": call_ms(
            lambda: rf_predict_ref(*packed, Xt, forest.depth)),
        "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes, "ops": nops,
    }


SWEEP_NS = (192, 512, 1024, 1536, 3072, 4224, 6144, 8192)
SWEEP_WARPS = (8, 13, 25)


def sweep_kernels(forest, X) -> dict:
    """Device ms of each kernel forced (the pair kernel; the tile kernel
    at SWEEP_WARPS warps) and of the wrapper's pick, at SWEEP_NS rows and
    all of X: the measurements `rf_predict.launch_shape`'s thresholds
    (PAIR_ROWS, the warps by tiles per SM) are read from."""
    dev = torch.device("cuda")
    packed = packed_on(forest, dev)
    nodes = rf_kernel.pack_nodes(packed[0], packed[1])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for n in SWEEP_NS + (len(X),):
        Xt = torch.from_numpy(np.ascontiguousarray(X[:n], np.float32)).to(dev)
        out = torch.empty(n, dtype=torch.float32, device=dev)
        cuts = [rf_kernel.LaunchShape("pair")] + [
            rf_kernel.LaunchShape("tile", w) for w in SWEEP_WARPS]
        row = {f"{c.kernel}{c.warps or ''}": graph_ms(
            lambda c=c: rf_kernel.launch(nodes, packed[2], Xt, out,
                                         forest.depth, shape=c),
            launches=50, reps=11) for c in cuts}
        row["picked"] = vars(rf_kernel.launch_shape(
            n, packed[0].shape[0], X.shape[1], sms))
        rows[n] = row
    return rows


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
              obs: str = "off", counted: bool = False,
              waterfill_backend: str = "numpy"):
    """Drive the fleet; with `counted`, zero every launch count just
    before the ticks and return the counts read just after."""
    jobs = fleet_jobs(n_jobs)
    fleet = FleetController(WanSimulator(seed=0,
                                         waterfill_backend=waterfill_backend),
                            BatchedRfPredictor(forest, device=device),
                            m_total=M_TOTAL, jobs=jobs, obs=obs)
    if counted:
        ops.rf_predict.launches = 0
        ops.ssd_chunk.launches = 0
        ops.fill_rates.launches = 0
        fleet.predictor.metrics.counter("kernel_calls").reset()
    fills = fleet.sim.fill_calls
    records, secs = [], []
    for _ in range(ticks):
        t0 = time.perf_counter()
        records.append(fleet.tick())
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = {"rf_predict": ops.rf_predict.launches,
              "ssd_chunk": ops.ssd_chunk.launches,
              "fill_rates": ops.fill_rates.launches,
              "fills": fleet.sim.fill_calls - fills} if counted else {}
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
# scenarios phase: the engines' pins, the RF and water-fill kernels
# ----------------------------------------------------------------------
def wf_case(B: int, n: int, seed: int):
    """B seeded fills of an n-DC mesh, built as the reference's water-fill
    tests build them (tests/test_waterfill_kernel.py): a fluctuated
    simulator, uncredited cross-traffic and rival tenants half the time,
    a §3.2.2 cap 40% of the time -> (c, single, egress, ingress, w,
    path_cap) stacked, [B,N,N] / [B,N], w one a fill."""
    rng = np.random.default_rng(seed)
    regions = (WanSimulator().regions * (n // 8 + 1))[:n]
    cases = []
    for b in range(B):
        sim = WanSimulator(regions=regions, seed=seed * 1000 + b)
        sim.advance(int(rng.integers(0, 4)))
        if rng.random() < 0.5:
            bg = rng.integers(0, 4, (n, n)).astype(float)
            for i, j in zip(*np.nonzero(bg)):
                sim.set_background(i, j, bg[i, j])
        if rng.random() < 0.5:
            for t in range(int(rng.integers(1, 3))):
                sim.set_tenant_conns(f"rival{t}", rng.integers(
                    0, 3, (n, n)).astype(float))
        c = rng.integers(0, 7, (n, n)).astype(float)
        np.fill_diagonal(c, 0.0)
        cap = rng.uniform(50.0, 2000.0, (n, n)) \
            if rng.random() < 0.4 else None
        cases.append((sim._contending_conns(c),) + sim.fill_inputs(cap))
    return tuple(np.stack(a) for a in zip(*cases))


def host_fills(case):
    """The port's numpy loop on each fill of a batch: (rates, iters)."""
    n = case[0].shape[-1]
    out = [fill_rates_host(*(a[b] for a in case), wfk.max_fill_iters(n))
           for b in range(case[0].shape[0])]
    if not all(ok for _, _, ok in out):
        raise AssertionError("the host loop did not converge")
    return np.stack([r for r, _, _ in out]), np.array([i for _, i, _ in out])


def check_fill(got, want, what: str) -> float:
    """(rate, iters) against (rate, iters): equal iterations, rates
    within WF_TOL (rtol and atol); returns max |diff|."""
    rate, iters = (np.asarray(v) for v in got)
    w_rate, w_iters = (np.asarray(v) for v in want)
    if not np.array_equal(iters.astype(np.int64), w_iters.astype(np.int64)):
        raise AssertionError(f"{what}: iterations {iters.tolist()} != "
                             f"{w_iters.tolist()}")
    np.testing.assert_allclose(rate, w_rate, rtol=WF_TOL, atol=WF_TOL,
                               err_msg=what)
    return float(np.abs(rate - w_rate).max())


def check_waterfill(case, device) -> dict:
    """The kernel against its plain version on the same tensors on the
    card, and against the host loop fill by fill."""
    t = [torch.from_numpy(a).to(device) for a in case]
    rate, iters, ok = ops.fill_rates(*t)
    p_rate, p_iters, p_ok = fill_rates_ref(*t)
    sync(device)
    if not (bool(ok.all()) and bool(p_ok.all())):
        raise AssertionError("a fill did not converge")
    got = (rate.cpu().numpy(), iters.cpu().numpy())
    err_plain = check_fill(got, (p_rate.cpu().numpy(),
                                 p_iters.cpu().numpy()), "kernel vs plain")
    err_host = check_fill(got, host_fills(case), "kernel vs host loop")
    return {"err_plain": err_plain, "err_host": err_host,
            "iters": got[1].tolist()}


def waterfill_bound(case, iters):
    """Bytes (each input read once, each output written once) and f64
    operations (WF_OPS_PER_PAIR per pair per iteration these fills ran)
    -> (bound ms, by, bytes, ops)."""
    B, n = case[0].shape[0], case[0].shape[-1]
    nbytes = sum(a.nbytes for a in case) + B * (8 * n * n + 4 + 1)
    nops = WF_OPS_PER_PAIR * n * n * int(np.sum(iters))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, nops)


def host_call_us(fn, reps: int = 51) -> float:
    """Median host microseconds of one call that ends synchronised."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def time_waterfill(case, iters) -> dict:
    """The kernel alone (device, a graph of 20 calls), the numpy
    wrapper's call with its copies and synchronise (host), the host
    loop's fills (host) and the plain version on the card."""
    dev = torch.device("cuda")
    t = [torch.from_numpy(a).to(dev) for a in case]
    B, n = case[0].shape[0], case[0].shape[-1]
    outs = (torch.empty((B, n, n), dtype=torch.float64, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.bool, device=dev))
    bound_ms, by, nbytes, nops = waterfill_bound(case, iters)
    return {"B": B, "N": n, "iters": iters,
            "ms": graph_ms(lambda: ops.fill_rates(*t, out=outs)),
            "wrapper_us": host_call_us(lambda: wfk.fill_rates(*case)),
            "host_loop_us": host_call_us(lambda: host_fills(case), reps=11),
            "plain_ms": call_ms(lambda: fill_rates_ref(*t), reps=5),
            "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
            "ops": nops}


def checked_fill(stats: dict):
    """The simulator's device fill with every fill also run by the host
    loop on the same inputs: equal iterations, rates within WF_TOL."""
    kernel_fill = wfk.fill_rates

    def fill(c, single, egress, ingress, w, path_cap, device=None):
        rate, iters, ok = kernel_fill(c, single, egress, ingress, w,
                                      path_cap, device=device)
        want, w_iters, w_ok = fill_rates_host(
            c, single, egress, ingress, w, path_cap,
            wfk.max_fill_iters(c.shape[-1]))
        if bool(ok) != w_ok:
            raise AssertionError("device and host fills disagree on "
                                 "convergence")
        err = check_fill((rate, iters), (want, w_iters), "a scenario fill")
        stats["fills"] += 1
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        return rate, iters, ok
    return fill


def check_traces(got, want, name: str) -> None:
    """Every integer field of every step equal, floats within rtol
    WF_TOL (the device fill sums in another order)."""
    if len(got.steps) != len(want.steps):
        raise AssertionError(f"{name}: {len(got.steps)} steps, "
                             f"{len(want.steps)}")
    for g, w in zip(got.steps, want.steps):
        for key in TRACE_INT_FIELDS:
            if getattr(g, key) != getattr(w, key):
                raise AssertionError(f"{name} step {g.step}: {key} "
                                     f"{getattr(g, key)} != "
                                     f"{getattr(w, key)}")
        for key in TRACE_FLOAT_FIELDS:
            np.testing.assert_allclose(getattr(g, key), getattr(w, key),
                                       rtol=WF_TOL,
                                       err_msg=f"{name} {g.step} {key}")


def run_device_fill_scenarios() -> dict:
    """The 12 scenarios at seed 3 with waterfill_backend="cuda", each
    fill checked against the host loop, each trace against the numpy
    run's; counts zeroed just before and read just after."""
    stats = {"fills": 0, "max_abs_err": 0.0}
    want = {n: run_scenario(get_scenario(n), seed=PIN_SEED).trace
            for n in scenario_names()}
    ops.fill_rates.launches = 0
    ops.rf_predict.launches = 0
    sim_fill = wfk.fill_rates
    wfk.fill_rates = checked_fill(stats)
    try:
        got = {}
        for n in scenario_names():
            spec = get_scenario(n)
            spec.sim_kwargs["waterfill_backend"] = "cuda"
            got[n] = run_scenario(spec, seed=PIN_SEED).trace
    finally:
        wfk.fill_rates = sim_fill
    stats["launches"] = ops.fill_rates.launches
    stats["rf_predict_launches"] = ops.rf_predict.launches
    for n in scenario_names():
        check_traces(got[n], want[n], n)
    stats["steps"] = sum(len(t.steps) for t in got.values())
    if stats["launches"] != stats["fills"] or stats["rf_predict_launches"]:
        raise AssertionError(f"device-fill scenarios: {stats}")
    return stats


def fleet_fill_ab(forest, dev) -> dict:
    """The main phase's fleet under waterfill_backend numpy (A) and cuda
    (B), A B B A, separate runs in one process: records equal (budgets,
    conns, plan signatures exact; floats within WF_TOL), fills a tick,
    tick median / p90 per backend over its two runs, and the host time
    of the ticks' fills (each `_fill_rates` call timed) beside the rest
    of the tick."""
    calls = []                     # (host seconds, iterations) a fill
    fill_rates = WanSimulator._fill_rates

    def timed(sim, c, cap=None):
        t0 = time.perf_counter()
        rate = fill_rates(sim, c, cap)
        calls.append((time.perf_counter() - t0, sim.last_fill_iters))
        return rate

    runs = []
    WanSimulator._fill_rates = timed
    try:
        for backend in ("numpy", "cuda", "cuda", "numpy"):
            _, records, secs, counts = run_fleet(
                forest, dev, counted=True, waterfill_backend=backend)
            fills = counts["fills"]
            want = {"rf_predict": TICKS, "ssd_chunk": 0, "fills": fills,
                    "fill_rates": fills if backend == "cuda" else 0}
            if counts != want:
                raise AssertionError(f"{backend} fleet launches {counts}, "
                                     f"expected {want}")
            runs.append((backend, records, secs, fills, calls[-fills:]))
    finally:
        WanSimulator._fill_rates = fill_rates
    base = runs[0][1]
    for backend, records, _, _, _ in runs[1:]:
        for a, b in zip(records, base):
            for ra, rb in zip(a["jobs"], b["jobs"]):
                for key in ("name", "budget", "conns_total", "plan_sig",
                            "priority"):
                    if ra[key] != rb[key]:
                        raise AssertionError(f"{backend} tick {a['tick']} "
                                             f"{ra['name']} {key}")
                for key in ("cap_min", "achieved_min", "achieved_mean"):
                    np.testing.assert_allclose(ra[key], rb[key], rtol=WF_TOL)
    out = {"order": [r[0] for r in runs]}
    for backend in ("numpy", "cuda"):
        ms = np.concatenate([np.asarray(r[2]) * 1e3 for r in runs
                             if r[0] == backend])
        fills = [r[3] for r in runs if r[0] == backend]
        timed_fills = [f for r in runs if r[0] == backend for f in r[4]]
        fill_us = np.asarray([f[0] for f in timed_fills]) * 1e6
        fill_ms_tick = fill_us.sum() / 1e3 / (2 * TICKS)
        out[backend] = {
            "tick_ms": ms.tolist(), "tick_ms_median": float(np.median(ms)),
            "tick_ms_p90": float(np.percentile(ms, 90)),
            "fills_per_tick": fills[0] / TICKS,
            "run_medians_ms": [float(np.median(np.asarray(r[2]) * 1e3))
                               for r in runs if r[0] == backend],
            "fill_us_median": float(np.median(fill_us)),
            "fill_ms_per_tick": float(fill_ms_tick),
            "rest_ms_per_tick": float(ms.mean() - fill_ms_tick),
            "iters_per_fill": float(np.mean([f[1] for f in timed_fills]))}
    return out


# ----------------------------------------------------------------------
# fused phase: the whole fleet tick as tensor programs on the card
# ----------------------------------------------------------------------
FUSED_SIM = dict(snapshot_sigma=0.0, host_sigma=0.0)   # the fused contract
FUSED_TOL = 1e-6          # the reference's own (tests/test_fused_tick.py)
SWEEP_VARIANTS = 16
SWEEP_FACTORS = tuple(np.linspace(0.2, 0.95, SWEEP_VARIANTS))


def fused_fleet(forest, dev, backend: str = "numpy"):
    """The main phase's fleet (16 four-DC jobs, priorities (1, 2, 4),
    m_total 8, seed 0) under the fused contract: quiet captures
    (snapshot_sigma = host_sigma = 0), fluctuation on."""
    return FleetController(
        WanSimulator(seed=0, waterfill_backend=backend, **FUSED_SIM),
        BatchedRfPredictor(forest, device=dev), m_total=M_TOTAL,
        jobs=fleet_jobs())


def fused_rows_match(want, got, what: str) -> float:
    """Budgets and conns equal; cap_min and achieved BW within
    FUSED_TOL (rtol and atol). Returns the largest |diff| of those."""
    if len(want) != len(got):
        raise AssertionError(f"{what}: {len(got)} ticks, {len(want)}")
    err = 0.0
    for a, b in zip(want, got):
        for ra, rb in zip(a["jobs"], b["jobs"]):
            for key in ("name", "budget", "conns_total"):
                if ra[key] != rb[key]:
                    raise AssertionError(f"{what} tick {a['tick']} "
                                         f"{ra['name']}: {key} {rb[key]} != "
                                         f"{ra[key]}")
            for key in ("cap_min", "achieved_min", "achieved_mean"):
                np.testing.assert_allclose(
                    rb[key], ra[key], rtol=FUSED_TOL, atol=FUSED_TOL,
                    err_msg=f"{what} tick {a['tick']} {ra['name']} {key}")
                err = max(err, abs(rb[key] - ra[key]))
    return err


def fused_state_match(want, got, what: str) -> None:
    """Final conns equal and AIMD targets within FUSED_TOL."""
    for name in want.jobs:
        a, b = want.jobs[name].controller, got.jobs[name].controller
        if not np.array_equal(a.current_conns(), b.current_conns()):
            raise AssertionError(f"{what}: {name}'s final conns differ")
        np.testing.assert_allclose(
            np.stack([ag.target_bw for ag in b._agents]),
            np.stack([ag.target_bw for ag in a._agents]),
            rtol=FUSED_TOL, atol=FUSED_TOL, err_msg=f"{what} {name} targets")


# the fused tick's stages, timed by ScanProbe: (owner, attribute); the
# Eq. 2-3 ranges include Algorithm 1's relations
FUSED_STAGES = (("fill", "FusedFleet", "_fill"),
                ("embed", "FusedFleet", "_embed"),
                ("extract", "FusedFleet", "_extract"),
                ("off_pairs", "FusedFleet", "_off_pairs"),
                ("link_shares", "fused", "link_shares_torch"),
                ("ranges", "fused", "global_ranges_torch"),
                ("relations", "fused", "relations_torch"),
                ("aimd", "fused", "aimd_step_torch"))


class ScanProbe:
    """Wraps `FusedFleet._scan`, the T-tick loop, while installed. With
    `check_sync` (on the card) the loop runs under
    `torch.cuda.set_sync_debug_mode("error")`: any synchronising call in
    it raises. Each run records the loop's host seconds (the issue of
    every tick), its seconds to the device's end (a synchronise after
    it), the host seconds spent inside the three custom launches
    (`rf_predict.launch`, `waterfill.launch`) and inside each of
    FUSED_STAGES. With `profile`, the loop runs under `torch.profiler`
    (CPU and CUDA activity) and each stage under a `record_function`
    range named ``stage:<name>``."""

    def __init__(self, dev):
        self.dev, self.runs, self.prof = dev, [], None
        self.profile, self.check_sync = False, True
        self._scan = FusedFleet._scan
        owners = {"FusedFleet": FusedFleet, "fused": fused_mod}
        self._orig = [(owners[o], a, getattr(owners[o], a))
                      for _, o, a in FUSED_STAGES] + \
            [(rf_kernel, "launch", rf_kernel.launch),
             (wfk, "launch", wfk.launch)]

    def __enter__(self):
        probe = self

        def timed(real, name):
            def call(*a, **kw):
                t0 = time.perf_counter()
                try:
                    if probe.profile:
                        with torch.profiler.record_function(f"stage:{name}"):
                            return real(*a, **kw)
                    return real(*a, **kw)
                finally:
                    probe._host[name] = probe._host.get(name, 0.0) + \
                        time.perf_counter() - t0
            return call

        def scan(ff, cons, target, singles, bgs):
            from torch.profiler import ProfilerActivity, profile
            probe._host = {}
            check = probe.check_sync and probe.dev.type == "cuda"
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) \
                if probe.profile else None
            if prof is not None:
                prof.__enter__()
            t0 = time.perf_counter()
            if check:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = probe._scan(ff, cons, target, singles, bgs)
            finally:
                if check:
                    torch.cuda.set_sync_debug_mode("default")
            t1 = time.perf_counter()
            sync(probe.dev)
            t2 = time.perf_counter()
            if prof is not None:
                prof.__exit__(None, None, None)
                probe.prof = prof
            probe.runs.append({"ticks": singles.shape[0],
                               "variants": singles.shape[1],
                               "issue_s": t1 - t0, "loop_s": t2 - t0,
                               "launch_s": probe._host.get("rf_launch", 0.0)
                               + probe._host.get("fill_launch", 0.0),
                               "stage_s": dict(probe._host),
                               "sync_checked": check})
            return out
        FusedFleet._scan = scan
        names = [n for n, _, _ in FUSED_STAGES] + ["rf_launch", "fill_launch"]
        for name, (owner, attr, real) in zip(names, self._orig):
            setattr(owner, attr, timed(real, name))
        return self

    def __exit__(self, *exc):
        FusedFleet._scan = self._scan
        for owner, attr, real in self._orig:
            setattr(owner, attr, real)


def stage_kernels(prof) -> dict:
    """Kernels and their device ms under each ``stage:<name>`` range of
    a profiled loop (the kernels the range's CPU ops launched)."""
    def under(ev):
        k = list(ev.kernels)
        for c in ev.cpu_children:
            k += under(c)
        return k
    out = {}
    for ev in prof.events():
        if ev.name.startswith("stage:"):
            row = out.setdefault(ev.name[6:], {"kernels": 0, "device_ms": 0.0})
            ks = under(ev)
            row["kernels"] += len(ks)
            row["device_ms"] += sum(k.duration for k in ks) / 1e3
    return out


def zero_counts() -> None:
    ops.rf_predict.launches = 0
    ops.fill_rates.launches = 0


def read_counts() -> dict:
    return {"rf_predict": ops.rf_predict.launches,
            "fill_rates": ops.fill_rates.launches}


def sweep_schedules():
    """SWEEP_VARIANTS schedules of TICKS steps: the us-east/us-west
    link degraded at step 1 to each of SWEEP_FACTORS."""
    singles, bgs, events = [], [], []
    for f in SWEEP_FACTORS:
        ev = (at(1, LinkDegrade(("us-east", "us-west"), float(f))),)
        s, g = make_schedule(WanSimulator(seed=0, **FUSED_SIM), TICKS, ev)
        singles.append(s)
        bgs.append(g)
        events.append(ev)
    return np.stack(singles), np.stack(bgs), events


def fused_profile(prof) -> dict:
    """Kernels and their device ms in the profiled loop, by name."""
    n, dev_ms, names = 0, 0.0, {}
    for e in prof.key_averages():
        # the stage ranges (ScanProbe's record_function) show on the
        # device's timeline too, spanning kernels: not kernels
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.key.startswith(("Memcpy", "Memset", "stage:")):
            continue
        n += e.count
        dev_ms += e.self_device_time_total / 1e3
        names[e.key[:60]] = names.get(e.key[:60], 0) + e.count
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return {"kernels": n, "device_ms": dev_ms, "top": top}


def fused_phase(forest, dev) -> dict:
    """The fused phase (see the head comment); every check fatal."""
    out = {}
    with ScanProbe(dev) as probe:
        # (1) run_fused(24) against 24 sequential ticks, numpy and cuda
        # fill backends; then one more sequential tick on each side
        fleet = fused_fleet(forest, dev)
        zero_counts()
        got = fleet.run_fused(TICKS)
        counts = read_counts()
        out["run_launches"] = counts
        seqs = {}
        for backend in ("numpy", "cuda"):
            seq = seqs[backend] = fused_fleet(forest, dev, backend)
            want = [seq.tick() for _ in range(TICKS)]
            err = fused_rows_match(want, got, f"fused vs {backend} ticks")
            fused_state_match(seq, fleet, f"fused vs {backend} ticks")
            out[f"vs_{backend}_max_abs_err"] = err
        err = fused_rows_match([seqs["numpy"].tick()], [fleet.tick()],
                               "the tick after the fused run")
        out["next_tick_max_abs_err"] = err
        if counts != {"rf_predict": TICKS, "fill_rates": 2 * TICKS}:
            raise AssertionError(f"run_fused({TICKS}) launches {counts}: "
                                 f"expected 1 rf_predict and 2 fill_rates a "
                                 f"tick")
        log(f"[fused] run_fused({TICKS}), {N_JOBS} jobs: budgets and conns "
            f"equal to {TICKS} sequential ticks with the numpy and the cuda "
            f"fill (cap and achieved BW within {FUSED_TOL}: max |diff| "
            f"{out['vs_numpy_max_abs_err']:.3g} / "
            f"{out['vs_cuda_max_abs_err']:.3g}); final conns equal, targets "
            f"within {FUSED_TOL}; the next sequential tick matches (max "
            f"|diff| {out['next_tick_max_abs_err']:.3g}); launches {counts}; "
            f"fill iterations of tick 1 {got[0]['fill_iters']}")

        # (2) a 16-variant sweep against 16 single runs
        singles, bgs, events = sweep_schedules()
        ff = fused_fleet(forest, dev).fused()
        zero_counts()
        sw = ff.sweep(singles, bgs)
        counts = read_counts()
        out["sweep_launches"] = counts
        err = 0.0
        for b, ev in enumerate(events):
            rows = fused_fleet(forest, dev).run_fused(TICKS, ev)
            for t, row in enumerate(rows):
                if row["fill_iters"] != sw["fill_iters"][b, t].tolist():
                    raise AssertionError(f"sweep variant {b} tick {t}: fill "
                                         f"iterations differ")
                for j, jr in enumerate(row["jobs"]):
                    for key in ("conns_total", "budget"):
                        if jr[key] != int(sw[key][b, t, j]):
                            raise AssertionError(
                                f"sweep variant {b} tick {t} job {j} {key}")
                    for key in ("cap_min", "achieved_min", "achieved_mean"):
                        np.testing.assert_allclose(
                            sw[key][b, t, j], jr[key], rtol=FUSED_TOL,
                            atol=FUSED_TOL)
                        err = max(err, abs(sw[key][b, t, j] - jr[key]))
        out["sweep_max_abs_err"] = err
        if counts != {"rf_predict": TICKS, "fill_rates": 2 * TICKS}:
            raise AssertionError(f"sweep launches {counts}: expected 1 "
                                 f"rf_predict and 2 fill_rates a tick")
        log(f"[fused] sweep of {SWEEP_VARIANTS} variants x {TICKS} ticks "
            f"(us-east/us-west degraded at step 1 to "
            f"{SWEEP_FACTORS[0]:.2f}..{SWEEP_FACTORS[-1]:.2f}): equal to "
            f"{SWEEP_VARIANTS} single run_fused calls (ints and iterations "
            f"exact, floats max |diff| {err:.3g}); launches {counts}")

        # (3) A B B A: sequential ticks (numpy fill, the main path) and
        # fused ticks, a fresh fleet a run, the fused runs warm; the
        # loops above ran under the sync check, these time it without
        probe.check_sync = False
        probe.runs.clear()
        runs = []
        for kind in ("sequential", "fused", "fused", "sequential"):
            fleet = fused_fleet(forest, dev)
            if kind == "sequential":
                secs = []
                for _ in range(TICKS):
                    t0 = time.perf_counter()
                    fleet.tick()
                    sync(dev)
                    secs.append(time.perf_counter() - t0)
                runs.append((kind, secs))
            else:
                fleet.fused()
                t0 = time.perf_counter()
                fleet.run_fused(TICKS)
                runs.append((kind, time.perf_counter() - t0))
        loops = probe.runs[-2:]
        seq_ms = np.concatenate([np.asarray(s) for k, s in runs
                                 if k == "sequential"]) * 1e3
        run_ms = [s * 1e3 / TICKS for k, s in runs if k == "fused"]
        loop_ms = [r["loop_s"] * 1e3 / TICKS for r in loops]
        issue_us = [r["issue_s"] * 1e6 / TICKS for r in loops]
        outside_us = [(r["issue_s"] - r["launch_s"]) * 1e6 / TICKS
                      for r in loops]
        out["ab"] = {
            "order": [k for k, _ in runs],
            "sequential_tick_ms": seq_ms.tolist(),
            "sequential_ms_median": float(np.median(seq_ms)),
            "sequential_ms_mean": float(seq_ms.mean()),
            "sequential_run_medians_ms": [float(np.median(s) * 1e3)
                                          for k, s in runs
                                          if k == "sequential"],
            "fused_run_ms_per_tick": run_ms, "fused_loop_ms_per_tick": loop_ms,
            "fused_issue_us_per_tick": issue_us,
            "fused_host_us_outside_launches": outside_us}
        stage_us = {k: float(np.mean([r["stage_s"].get(k, 0.0)
                                      for r in loops])) * 1e6 / TICKS
                    for k in [n for n, _, _ in FUSED_STAGES]
                    + ["rf_launch", "fill_launch"]}
        stage_us["ranges"] -= stage_us["relations"]     # exclusive
        stage_us["rest"] = float(np.mean(issue_us)) - sum(
            v for k, v in stage_us.items() if k != "fill_launch")
        out["ab"]["stage_host_us_per_tick"] = stage_us
        ab = out["ab"]
        log(f"[fused] A B B A ({ab['order']}), {N_JOBS} jobs x {TICKS} "
            f"ticks: sequential tick {ab['sequential_ms_median']:.3f} ms "
            f"median, {ab['sequential_ms_mean']:.3f} mean (run medians "
            f"{[round(v, 3) for v in ab['sequential_run_medians_ms']]}); "
            f"fused {[round(v, 4) for v in run_ms]} ms a tick for the whole "
            f"run_fused call, {[round(v, 4) for v in loop_ms]} ms a tick in "
            f"the loop (to the device's end); host issue "
            f"{[round(v, 1) for v in issue_us]} us a tick, of which "
            f"{[round(v, 1) for v in outside_us]} us outside the three "
            f"custom launches")
        log("[fused] host us a tick by stage (mean of both fused runs; "
            "fill includes its launch, ranges excludes relations, rest is "
            "the tick's own ops: features, predict's wrapper, stats): " +
            ", ".join(f"{k} {v:.1f}" for k, v in stage_us.items()))

        # (4) sweep rate, warm
        ff = fused_fleet(forest, dev).fused()
        ff.sweep(singles, bgs)
        t0 = time.perf_counter()
        ff.sweep(singles, bgs)
        sweep_s = time.perf_counter() - t0
        out["sweep_s"] = sweep_s
        out["sweep_epochs_per_s"] = SWEEP_VARIANTS * TICKS / sweep_s
        log(f"[fused] sweep {SWEEP_VARIANTS} x {TICKS} (warm): "
            f"{sweep_s * 1e3:.2f} ms, {out['sweep_epochs_per_s']:.1f} "
            f"epochs/s ({probe.runs[-1]['loop_s'] * 1e3 / TICKS:.4f} ms a "
            f"tick of {SWEEP_VARIANTS} variants in the loop)")

        # (5) kernels a tick and the device's busy share, from the
        # profiler over one warm run's loop
        if dev.type == "cuda":
            probe.profile = True
            fused_fleet(forest, dev).run_fused(TICKS)
            probe.profile = False
            prof = fused_profile(probe.prof)
            prof["stages"] = {k: {"kernels_per_tick": v["kernels"] / TICKS,
                                  "device_ms_per_tick": v["device_ms"] / TICKS}
                              for k, v in stage_kernels(probe.prof).items()}
            prof["kernels_per_tick"] = prof["kernels"] / TICKS
            prof["device_ms_per_tick"] = prof["device_ms"] / TICKS
            prof["busy_share"] = prof["device_ms_per_tick"] / \
                float(np.median(loop_ms))
            out["profile"] = prof
            log(f"[fused] profile of one run's loop: "
                f"{prof['kernels_per_tick']:.1f} kernels a tick, "
                f"{prof['device_ms_per_tick']:.4f} device ms a tick, busy "
                f"{prof['busy_share']:.1%} of the untraced loop's "
                f"{np.median(loop_ms):.4f} ms a tick; most launched: " +
                ", ".join(f"{k} x{v}" for k, v in prof["top"]))
            log("[fused] kernels and device ms a tick by stage (ranges "
                "includes relations): " + ", ".join(
                    f"{k} {v['kernels_per_tick']:.1f} / "
                    f"{v['device_ms_per_tick']:.4f}"
                    for k, v in prof["stages"].items()))
    return out


# ----------------------------------------------------------------------
# placement phase: the 3 pins and the torch backend on the card
# ----------------------------------------------------------------------
PLACEMENT_NS = (3, 4, 8)
PLACEMENT_RTOL = 1e-12    # tests/test_torch_placement.py's TORCH_RTOL


def placement_bw(n: int):
    """`tests/test_placement_batch.py`'s inputs: achievable BW at a
    quiet steady state and the regions' egress prices."""
    sim = WanSimulator(seed=0, fluct_sigma=0.0, snapshot_sigma=0.0,
                       runtime_sigma=0.0)
    ctl = WanifyController(sim, SnapshotPredictor(), n_pods=n)
    return pl.achievable_bw(ctl.plan), egress_price_vector(sim.regions[:n])


def decision_key(d):
    return (d.placement, d.cost.makespan_s, d.cost.egress_usd, d.evals)


def placement_phase(dev) -> dict:
    """The placement phase (see the head comment); every check fatal."""
    out = {}
    pins = {k: v for k, v in goldens.pinned().items()
            if k.startswith("placement/")}
    runners = goldens.runners()
    old = os.environ.get("REPRO_PLACEMENT_BACKEND")
    os.environ["REPRO_PLACEMENT_BACKEND"] = "torch"
    try:
        got = {k: goldens.sha(runners[k]()) for k in pins}
    finally:
        if old is None:
            del os.environ["REPRO_PLACEMENT_BACKEND"]
        else:
            os.environ["REPRO_PLACEMENT_BACKEND"] = old
    bad = sorted(k for k in pins if got[k] != pins[k])
    if bad or len(pins) != 3:
        raise AssertionError(f"placement pins with the torch backend: {bad}")
    log(f"[placement] the {len(pins)} placement pins hold with "
        f"REPRO_PLACEMENT_BACKEND=torch on the card: {sorted(pins)}")

    # every candidate batch of full searches on numpy, then the same
    # batches on the card; the searches on the card decide alike
    batches = []
    real = pl_cost._eval_packed

    def tap(placements, bw, packed, rate, backend, device=None):
        batches.append((placements, bw, packed, rate))
        return real(placements, bw, packed, rate, backend, device)
    searches = 0
    for name in pl.workload_names():
        for n in PLACEMENT_NS:
            bw, price = placement_bw(n)
            q = pl.get_workload(name, n)
            runs = [("greedy", lambda **kw: pl.greedy_place(
                q, bw, egress_usd_per_gb=price, **kw))]
            if n <= 4:
                runs.append(("exhaustive", lambda **kw: pl.exhaustive_place(
                    q, bw, egress_usd_per_gb=price, levels=4, **kw)))
            for kind, search in runs:
                pl_cost._eval_packed = tap
                try:
                    want = search(backend="numpy")
                finally:
                    pl_cost._eval_packed = real
                got = search(backend="torch", device=dev)
                if decision_key(got) != decision_key(want):
                    raise AssertionError(f"{kind} {name} N={n}: the torch "
                                         f"backend decided otherwise")
                searches += 1
    err, rel, sizes, t_np, t_t = 0.0, 0.0, [], [], []
    for placements, bw, packed, rate in batches:
        t0 = time.perf_counter()
        a = real(placements, bw, packed, rate, "numpy")
        t1 = time.perf_counter()
        b = real(placements, bw, packed, rate, "torch", dev)
        t2 = time.perf_counter()
        t_np.append(t1 - t0)
        t_t.append(t2 - t1)
        sizes.append(len(placements))
        for f in ("makespan_s", "net_s", "compute_s", "egress_gb",
                  "egress_usd", "instance_usd"):
            x, y = getattr(a, f), getattr(b, f)
            np.testing.assert_allclose(y, x, rtol=PLACEMENT_RTOL, atol=0,
                                       err_msg=f)
            err = max(err, float(np.abs(y - x).max()))
            rel = max(rel, float((np.abs(y - x) / np.maximum(
                np.abs(x), 1e-300)).max()))
    out.update({"searches": searches, "batches": len(batches),
                "candidates": int(sum(sizes)),
                "batch_sizes": [int(min(sizes)), int(np.median(sizes)),
                                int(max(sizes))],
                "max_abs_err": err, "max_rel_err": rel,
                "numpy_us_median": float(np.median(t_np)) * 1e6,
                "torch_us_median": float(np.median(t_t)) * 1e6,
                "numpy_s": float(sum(t_np)), "torch_s": float(sum(t_t))})
    log(f"[placement] {searches} searches (greedy and exhaustive of "
        f"{pl.workload_names()} at N in {PLACEMENT_NS}): the torch backend "
        f"on the card decides as numpy; their {len(batches)} candidate "
        f"batches ({out['candidates']} candidates, sizes "
        f"{out['batch_sizes']} min/median/max) within rtol "
        f"{PLACEMENT_RTOL} (max rel diff {rel:.3g}); per batch (host, "
        f"median): numpy {out['numpy_us_median']:.1f} us, torch on the card "
        f"{out['torch_us_median']:.1f} us (its copy in, tensor ops and the "
        f"copy back)")
    return out


# ----------------------------------------------------------------------
# planes phase: the overlay and the predictor lifecycle
# ----------------------------------------------------------------------
REROUTE, LIFECYCLE_SCENARIO = "cable_cut_reroute", "provider_shift_drift"
REROUTE_SETTLED = 14      # the first step the post-cut relays are in force


class RoutedTap:
    """Counts `WanSimulator.waterfill_routed` calls and marks the fills
    made inside one, so a fill wrapper can keep the routed fills'
    inputs."""

    def __init__(self):
        self.calls, self.inside = 0, False
        self.real = WanSimulator.waterfill_routed

    def __enter__(self):
        tap = self

        def routed(sim, *args, **kw):
            tap.calls += 1
            tap.inside = True
            try:
                return tap.real(sim, *args, **kw)
            finally:
                tap.inside = False
        WanSimulator.waterfill_routed = routed
        return self

    def __exit__(self, *exc):
        WanSimulator.waterfill_routed = self.real


def reroute_run(backend: str, mode: str):
    """`cable_cut_reroute` at seed 3 on fill `backend` with the overlay
    `mode` -> (result, relays per step, controller records, fills)."""
    spec = get_scenario(REROUTE)
    spec.sim_kwargs["waterfill_backend"] = backend
    eng = ScenarioEngine(spec, seed=PIN_SEED, overlay=mode)
    relays = {}

    def hook(engine, row):
        ctl = engine.controller
        relays[row.step] = ctl.routed.relays if ctl.routed else ()
    eng.step_hook = hook
    res = eng.run()
    return res, relays, eng.controller.record, eng.sim.fill_calls


def check_records_equal(got, want, what: str) -> None:
    """Replan records: every key equal (reasons, steps, plan and routed
    signatures, relays) but the predicted BW's min / mean, within rtol
    WF_TOL."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} replans, {len(want)}")
    for g, w in zip(got, want):
        if set(g) != set(w):
            raise AssertionError(f"{what}: record keys {sorted(g)}")
        for key in g:
            if key in ("pred_min", "pred_mean"):
                np.testing.assert_allclose(g[key], w[key], rtol=WF_TOL,
                                           err_msg=f"{what} {key}")
            elif g[key] != w[key]:
                raise AssertionError(f"{what} step {g['step']}: {key} "
                                     f"{g[key]} != {w[key]}")


def overlay_part(floor_ms: float) -> dict:
    """Part (1) of the planes phase (see the head comment)."""
    pins = {"off": goldens.pinned()[f"scenario/{REROUTE}/seed{PIN_SEED}"],
            "on": goldens.PLANE_PINS[f"overlay/{REROUTE}/on/seed{PIN_SEED}"]}
    want = {}
    for mode in ("off", "on"):
        want[mode] = reroute_run("numpy", mode)
        sha = goldens.sha(want[mode][0].trace.to_json())
        if sha != pins[mode]:
            raise AssertionError(f"{REROUTE} overlay {mode} (numpy fill): "
                                 f"sha {sha} is not its pin")
    out = {}
    kept = []
    for mode in ("off", "on"):
        stats = {"fills": 0, "max_abs_err": 0.0}
        base = checked_fill(stats)

        def fill(c, single, egress, ingress, w, path_cap, device=None,
                 stats=stats, base=base):
            rate, iters, ok = base(c, single, egress, ingress, w,
                                   path_cap, device=device)
            if tap.inside:
                stats["routed_fills"] = stats.get("routed_fills", 0) + 1
                kept.append(((c, single, egress, ingress, w, path_cap),
                             int(iters)))
            return rate, iters, ok
        ops.fill_rates.launches = 0
        ops.rf_predict.launches = 0
        sim_fill = wfk.fill_rates
        wfk.fill_rates = fill
        try:
            with RoutedTap() as tap:
                t0 = time.perf_counter()
                res, relays, records, fills = reroute_run("cuda", mode)
                secs = time.perf_counter() - t0
        finally:
            wfk.fill_rates = sim_fill
        launches = ops.fill_rates.launches
        if not (launches == fills == stats["fills"]) or \
                ops.rf_predict.launches:
            raise AssertionError(f"overlay {mode} on cuda: {launches} "
                                 f"waterfill launches, {fills} fills, "
                                 f"{stats['fills']} checked, "
                                 f"{ops.rf_predict.launches} rf_predict")
        w_res, w_relays, w_records, w_fills = want[mode]
        if fills != w_fills or relays != w_relays:
            raise AssertionError(f"overlay {mode}: fills {fills} vs "
                                 f"{w_fills} or relays differ from numpy's")
        if (mode == "on") != (tap.calls > 0):
            raise AssertionError(f"overlay {mode}: {tap.calls} routed fills")
        check_records_equal(records, w_records, f"overlay {mode}")
        check_traces(res.trace, w_res.trace, f"{REROUTE} overlay {mode}")
        out[mode] = {"fills": fills, "launches": launches,
                     "routed_fills": tap.calls,
                     "replans": len(records),
                     "relay_steps": sum(r != () for r in relays.values()),
                     "max_abs_err": stats["max_abs_err"], "s": secs,
                     "traces": res.trace}
    off = {s.step: s.achieved_min for s in out["off"]["traces"].steps}
    on = {s.step: s.achieved_min for s in out["on"]["traces"].steps}
    lost = [k for k in range(REROUTE_SETTLED, len(on)) if on[k] <= off[k]]
    if lost or any(on[k] != off[k] for k in range(12)):
        raise AssertionError(f"overlay: no strict win at steps {lost}, or "
                             f"the pre-cut steps differ")
    for mode in ("off", "on"):
        del out[mode]["traces"]
    out["min_gain"] = float(min(on[k] / off[k] for k in range(
        REROUTE_SETTLED, len(on))))
    # one routed fill after the cut (the last kept), timed as the
    # scenarios phase times a fill
    args, iters = kept[-1]
    case = tuple(np.array(a)[None] for a in args)
    out["routed_fill_timing"] = time_waterfill(case, [iters])
    out["max_abs_err"] = max(out[m]["max_abs_err"] for m in ("off", "on"))
    return out


def placement_overlay_part() -> dict:
    """Part (2) of the planes phase (see the head comment)."""
    runs = {}
    old = os.environ.get("REPRO_PLACEMENT_BACKEND")
    for backend in ("numpy", "torch"):
        os.environ["REPRO_PLACEMENT_BACKEND"] = backend
        try:
            for mode in ("off", "on"):
                runs[(backend, mode)] = pl.run_placement_scenario(
                    REROUTE, seed=PIN_SEED, overlay=mode)
        finally:
            if old is None:
                del os.environ["REPRO_PLACEMENT_BACKEND"]
            else:
                os.environ["REPRO_PLACEMENT_BACKEND"] = old
    out = {}
    for mode in ("off", "on"):
        got, want = runs[("torch", mode)], runs[("numpy", mode)]
        if [(r.step, r.reason, r.placement) for r in got.records] != \
                [(r.step, r.reason, r.placement) for r in want.records]:
            raise AssertionError(f"placement overlay {mode}: the torch "
                                 f"evaluator decided otherwise")
        for g, w in zip(got.records, want.records):
            np.testing.assert_allclose(
                [g.makespan_est_s, g.egress_est_usd],
                [w.makespan_est_s, w.egress_est_usd], rtol=PLACEMENT_RTOL)
        key = f"placement/{REROUTE}/overlay_{mode}/seed{PIN_SEED}"
        for r in (got, want):
            if goldens.sha(r.trace.to_json()) != goldens.PLANE_PINS[key]:
                raise AssertionError(f"{key}: not its pin")
        out[mode] = {"makespan_total_s": float(sum(
            s.makespan_s for s in got.trace.steps)),
            "replacements": len(got.records)}
    if not out["on"]["makespan_total_s"] < out["off"]["makespan_total_s"]:
        raise AssertionError(f"placement: overlay on {out['on']} not below "
                             f"off {out['off']}")
    return out


class NumpyPredictor(BwPredictor):
    """The host forest's numpy inference (the reference's default
    route)."""

    def predict_matrix(self, *args, backend=None, **kw):
        return super().predict_matrix(*args, backend="numpy", **kw)


class CardPredictor(BwPredictor):
    """`BwPredictor` on the card whose every prediction is also made by
    the plain version on the host from the forest in force (a fresh
    predictor, so no node cache is shared) and must be equal; counts its
    own `rf_predict` launches and checks that the first launch after a
    forest swap no longer gives the old forest's answer."""
    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        CardPredictor.made.append(self)
        self.launches, self.swaps, self.last_args = 0, [], None
        self._forest = self.forest

    def predict_matrix(self, *args, **kw):
        before = ops.rf_predict.launches
        out = super().predict_matrix(*args, **kw)
        self.launches += ops.rf_predict.launches - before
        host = BwPredictor(self.forest, device="cpu").predict_matrix(
            *args, **kw)
        np.testing.assert_array_equal(out, host)
        if self._forest is not self.forest:
            old = BwPredictor(self._forest, device="cpu").predict_matrix(
                *args, **kw)
            self.swaps.append(bool(not np.array_equal(out, old)))
            self._forest = self.forest
        self.last_args = args
        return out


@contextlib.contextmanager
def harness_predictor(cls):
    """Make the lifecycle harness build its pretrained predictors as
    `cls` for the duration."""
    real = lc_harness.BwPredictor
    lc_harness.BwPredictor = cls
    try:
        yield
    finally:
        lc_harness.BwPredictor = real


def check_headline(cmp: dict, what: str) -> None:
    """`tests/test_lifecycle.py`'s recovery assertions, as written."""
    fr, lc = cmp["modes"]["frozen"], cmp["modes"]["lifecycle"]
    ok = (fr["resid"][:15] == lc["resid"][:15]
          and lc["signal_steps"] and 15 <= lc["signal_steps"][0] <= 20
          and lc["refresh_steps"] and 15 <= lc["refresh_steps"][0] <= 22
          and lc["refreshes"] >= 1
          and float(np.mean(lc["resid"][25:])) < 0.3
          < float(np.mean(fr["resid"][25:]))
          and fr["full_probes"] == 0 and lc["full_probes"] >= 1
          and lc["monitor_usd"] < 0.75 * fr["monitor_usd"])
    if not ok:
        raise AssertionError(f"{what}: the headline does not hold: "
                             f"{without_resid(cmp)}")


def without_resid(cmp: dict) -> dict:
    """Each mode's telemetry of a lifecycle comparison, less the
    per-step residual series."""
    return {m: {k: v for k, v in r.items() if k != "resid"}
            for m, r in cmp["modes"].items()}


def lifecycle_part(dev, floor_ms: float) -> dict:
    """Part (3) of the planes phase (see the head comment)."""
    def sha_check(cmp, inference):
        for mode in ("frozen", "lifecycle"):
            key = goldens.lifecycle_key(mode, inference)
            if cmp["modes"][mode]["trace_sha"] != goldens.PLANE_PINS[key]:
                raise AssertionError(f"{key}: not its pin")
    with harness_predictor(NumpyPredictor):
        numpy_cmp = run_lifecycle_comparison(
            LIFECYCLE_SCENARIO, seed=PIN_SEED, device="cpu")
    sha_check(numpy_cmp, "numpy")
    check_headline(numpy_cmp, "numpy inference")
    host_cmp = run_lifecycle_comparison(LIFECYCLE_SCENARIO, seed=PIN_SEED,
                                        device="cpu")
    CardPredictor.made = []
    ops.rf_predict.launches = 0
    ops.fill_rates.launches = 0
    t0 = time.perf_counter()
    with harness_predictor(CardPredictor):
        card_cmp = run_lifecycle_comparison(
            LIFECYCLE_SCENARIO, seed=PIN_SEED, device=dev)
    secs = time.perf_counter() - t0
    launches = ops.rf_predict.launches
    if card_cmp != host_cmp:
        raise AssertionError("lifecycle: the card's comparison differs from "
                             "the host's")
    sha_check(card_cmp, "f32")
    check_headline(card_cmp, "the card")
    frozen, active = CardPredictor.made
    per_mode = {}
    for mode, p in (("frozen", frozen), ("lifecycle", active)):
        m = card_cmp["modes"][mode]
        want = m["snapshots"] + m["steps"]
        if p.launches != want:
            raise AssertionError(f"lifecycle {mode}: {p.launches} rf_predict "
                                 f"launches, replans + steps = {want}")
        per_mode[mode] = {"launches": p.launches, "replans": m["snapshots"],
                          "steps": m["steps"], "swaps": p.swaps}
    refreshes = card_cmp["modes"]["lifecycle"]["refreshes"]
    if launches != frozen.launches + active.launches or ops.fill_rates.launches \
            or len(active.swaps) != refreshes or not all(active.swaps) \
            or frozen.swaps:
        raise AssertionError(f"lifecycle launches {launches}, fills "
                             f"{ops.fill_rates.launches}, swaps "
                             f"{active.swaps} for {refreshes} refreshes")
    # the kernel at the run's shape, on the refit forest
    timing = time_kernel(active.forest, assemble_features(*active.last_args))
    return {"numpy": without_resid(numpy_cmp),
            "card": without_resid(card_cmp),
            "post25_resid": {m: float(np.mean(r["resid"][25:]))
                             for m, r in card_cmp["modes"].items()},
            "per_mode": per_mode, "launches": launches, "s": secs,
            "timing": timing}


def planes_phase(dev, floor_ms: float) -> dict:
    """The planes phase (see the head comment); every check fatal."""
    out = {}
    t0 = time.perf_counter()
    ov = overlay_part(floor_ms)
    ov["s_all"] = time.perf_counter() - t0
    out["overlay"] = ov
    t = ov["routed_fill_timing"]
    for mode in ("off", "on"):
        r = ov[mode]
        log(f"[planes] {REROUTE} seed {PIN_SEED} overlay {mode}, "
            f"waterfill_backend='cuda': {r['fills']} fills, {r['launches']} "
            f"waterfill launches ({r['routed_fills']} routed), "
            f"{r['replans']} replans, relays in force at {r['relay_steps']} "
            f"steps; each fill equal to the host loop's iterations and "
            f"within {WF_TOL} (max |diff| {r['max_abs_err']:.3g}); relays, "
            f"records and trace equal to the numpy run's ({r['s']:.2f} s)")
    log(f"[planes] overlay: numpy runs hash to their pins; routed "
        f"achieved_min above direct at every step {REROUTE_SETTLED}-39 "
        f"(least ratio {ov['min_gain']:.3f})")
    log(f"[planes] one routed fill ({t['iters'][0]} iterations): kernel "
        f"{t['ms']:.5f} ms (device, graph of 20 calls) | launch floor "
        f"{floor_ms:.5f} ms | numpy wrapper call {t['wrapper_us']:.1f} us "
        f"(host) | host loop {t['host_loop_us']:.1f} us (host) | plain "
        f"{t['plain_ms']:.4f} ms | bound {t['bound_ms']:.7f} ms by "
        f"{t['bound_by']}")
    t0 = time.perf_counter()
    pa = placement_overlay_part()
    pa["s"] = time.perf_counter() - t0
    out["placement"] = pa
    log(f"[planes] placement {REROUTE} seed {PIN_SEED}, torch evaluator on "
        f"the card: decisions equal to numpy's, traces at their pins; "
        f"total makespan overlay on {pa['on']['makespan_total_s']:.3f} s < "
        f"off {pa['off']['makespan_total_s']:.3f} s ({pa['s']:.1f} s)")
    lc = lifecycle_part(dev, floor_ms)
    out["lifecycle"] = lc
    for mode in ("frozen", "lifecycle"):
        c, pm = lc["card"][mode], lc["per_mode"][mode]
        log(f"[planes] {LIFECYCLE_SCENARIO} seed {PIN_SEED} {mode}, forest on "
            f"the card: signal steps {c['signal_steps']}, refresh steps "
            f"{c['refresh_steps']}, {c['full_probes']} full probes, "
            f"monitor ${c['monitor_usd']:.4f}, post-step-25 residual "
            f"{lc['post25_resid'][mode]:.4f}; {pm['launches']} rf_predict "
            f"launches = {pm['replans']} replans + {pm['steps']} steps; "
            f"first launch after each swap reads the new forest: "
            f"{pm['swaps']}")
    log(f"[planes] lifecycle: the card's comparison equals the host's field "
        f"for field, traces at their f32 pins; under numpy inference at "
        f"their numpy pins; headline holds on both ({lc['s']:.2f} s on the "
        f"card)")
    t = lc["timing"]
    log(f"[planes] rf_predict n={t['n']} (refit forest {t['trees']}x"
        f"{t['depth']}): kernel {t['ms']:.5f} ms (device, graph) | launch "
        f"floor {floor_ms:.5f} ms | wrapper call {t['wrapper_ms']:.5f} ms | "
        f"plain {t['plain_ms']:.5f} ms | bound {t['bound_ms']:.7f} ms by "
        f"{t['bound_by']} ({t['bytes']} B, {t['ops']} ops)")
    return out


# ----------------------------------------------------------------------
# faults phase: the chaos library, a 16-job blackout fleet, one obs run
# ----------------------------------------------------------------------
CHAOS_EXACT = ("scenario", "mode", "crashed", "error", "steps_completed",
               "steps_total", "injected", "rollbacks")
CHAOS_FLOATS = ("mttr_steps", "degraded_min_bw", "retry_usd")
CHAOS_RTOL = 1e-9
BLACKOUT_DC, BLACKOUT_TICKS = "ap-se", 24
BLACKOUT_STEPS = range(4, 8)              # DcBlackout at 4, DcRestore at 8
FLEET_TOL = 1e-6          # the fleet's BW tolerance (ROADMAP's contract)
OBS_SCENARIO = "steady"
OBS_TOL = 1e-9


def dead_pairs(c, single, path_cap) -> int:
    """Off-diagonal pairs that carry flows over a link of no capacity (a
    blacked-out DC or a partition)."""
    off = ~np.eye(c.shape[-1], dtype=bool)
    return int(((c > 0) & off & ((single <= 0) | (path_cap <= 0))).sum())


class FillCheck:
    """Wraps the simulator's device fill for the duration: every fill
    also run by the host loop on the same inputs (equal iterations,
    rates within WF_TOL), counted with its dead pairs, and the first
    dead-pair fill's inputs kept; `WanSimulator._fill_rates` calls are
    counted apart, so launches, checked fills and fills can be held
    equal."""

    def __init__(self):
        self.stats = {"fills": 0, "max_abs_err": 0.0, "dead_fills": 0,
                      "dead_pairs": 0, "nonfinite_fills": 0,
                      "sim_fills": 0}
        self.kept = None

    def __enter__(self):
        base = checked_fill(self.stats)
        real_sim = self.real_sim = WanSimulator._fill_rates
        self.real = wfk.fill_rates
        check = self

        def fill(c, single, egress, ingress, w, path_cap, device=None):
            args = (c, single, egress, ingress, w, path_cap)
            if not all(np.isfinite(a).all() for a in args):
                check.stats["nonfinite_fills"] += 1
            rate, iters, ok = base(*args, device=device)
            dead = dead_pairs(c, single, path_cap)
            if dead:
                check.stats["dead_fills"] += 1
                check.stats["dead_pairs"] += dead
                if check.kept is None:
                    check.kept = (args, int(iters), dead)
            return rate, iters, ok

        def sim_fill(sim, c, cap=None):
            check.stats["sim_fills"] += 1
            return real_sim(sim, c, cap)
        wfk.fill_rates = fill
        WanSimulator._fill_rates = sim_fill
        return self

    def __exit__(self, *exc):
        wfk.fill_rates = self.real
        WanSimulator._fill_rates = self.real_sim


@contextlib.contextmanager
def counting_ticks():
    """Counts `FleetController.tick` calls and the rows each tick's one
    forest call predicts."""
    real_tick = FleetController.tick
    real_rows = BatchedRfPredictor.predict_rows
    seen = {"ticks": 0, "rows": []}

    def tick(fleet, *a, **kw):
        seen["ticks"] += 1
        return real_tick(fleet, *a, **kw)

    def rows(pred, X, *a, **kw):
        seen["rows"].append(int(len(X)))
        return real_rows(pred, X, *a, **kw)
    FleetController.tick = tick
    BatchedRfPredictor.predict_rows = rows
    try:
        yield seen
    finally:
        FleetController.tick = real_tick
        BatchedRfPredictor.predict_rows = real_rows


def chaos_rows_match(card: dict, host: dict) -> float:
    """Every row: the integers and strings equal, the floats within
    CHAOS_RTOL relative; returns the largest relative float gap."""
    if len(card["runs"]) != len(host["runs"]) or card["seed"] != host["seed"]:
        raise AssertionError("chaos: the card's report has other rows")
    worst = 0.0
    for g, w in zip(card["runs"], host["runs"]):
        what = f"chaos {w['scenario']} {w['mode']}"
        if set(g) != set(w):
            raise AssertionError(f"{what}: keys {sorted(g)}")
        for key in CHAOS_EXACT:
            if g[key] != w[key]:
                raise AssertionError(f"{what}: {key} {g[key]!r} != "
                                     f"{w[key]!r}")
        for key in CHAOS_FLOATS:
            a, b = g[key], w[key]
            if (a is None) != (b is None):
                raise AssertionError(f"{what}: {key} {a!r} != {b!r}")
            if a is not None:
                gap = abs(a - b) / max(abs(b), 1e-300) if a != b else 0.0
                if gap > CHAOS_RTOL:
                    raise AssertionError(f"{what}: {key} {a!r} != {b!r}")
                worst = max(worst, gap)
    return worst


def chaos_part() -> dict:
    """Part (1) of the faults phase (see the head comment)."""
    t0 = time.perf_counter()
    host = chaos_report(seed=PIN_SEED, device="cpu")
    host_s = time.perf_counter() - t0
    fleet_runs = sum(get_chaos_scenario(n).fleet
                     for n in chaos_scenario_names())
    ops.fill_rates.launches = 0
    ops.rf_predict.launches = 0
    with FillCheck() as check, counting_ticks() as seen:
        t0 = time.perf_counter()
        card = chaos_report(seed=PIN_SEED)
        secs = time.perf_counter() - t0
    launches = {"waterfill": ops.fill_rates.launches,
                "rf_predict": ops.rf_predict.launches}
    st = check.stats
    if not (launches["waterfill"] == st["fills"] == st["sim_fills"] > 0):
        raise AssertionError(f"chaos on the card: {launches} launches, "
                             f"{st['fills']} checked fills, "
                             f"{st['sim_fills']} fills")
    if launches["rf_predict"] != seen["ticks"] or not seen["ticks"]:
        raise AssertionError(f"chaos on the card: {launches['rf_predict']} "
                             f"rf_predict launches for {seen['ticks']} "
                             f"fleet ticks")
    if not st["dead_fills"] or st["nonfinite_fills"]:
        raise AssertionError(f"chaos on the card: {st['dead_fills']} "
                             f"dead-pair fills, {st['nonfinite_fills']} "
                             f"with a non-finite input")
    worst = chaos_rows_match(card, host)
    s = card["summary"]
    if s["ladder_crashes"] != 0 or s["naive_crashes"] != 4 \
            or s != host["summary"]:
        raise AssertionError(f"chaos headline: {s}; host {host['summary']}")
    args, iters, dead = check.kept
    case = tuple(np.array(a)[None] for a in args)
    return {"rows": card["runs"], "summary": s, "launches": launches,
            "fleet_ticks": seen["ticks"], "fleet_runs": 2 * fleet_runs,
            "rows_per_tick": sorted(set(seen["rows"])), "s": secs,
            "host_s": host_s, "max_rel_gap": worst, **st,
            "dead_fill_pairs": dead,
            "dead_fill_timing": time_waterfill(case, [iters])}


def blackout_spec(events: bool = True):
    """The main phase's 16 jobs as a 24-tick fleet scenario on the quiet
    mesh, ap-se blacked out at tick 4 and restored at tick 8."""
    return FleetScenarioSpec(
        name="fleet_blackout_16", steps=BLACKOUT_TICKS, jobs=fleet_jobs(),
        m_total=M_TOTAL, sim_kwargs=dict(QUIET),
        events=(at(BLACKOUT_STEPS.start, DcBlackout(BLACKOUT_DC)),
                at(BLACKOUT_STEPS.stop, DcRestore(BLACKOUT_DC)))
        if events else ())


def blackout_run(forest, device, backend: str, faults: str = "on",
                 events: bool = True):
    """One run of the blackout fleet -> (result, per-tick dead caps)."""
    spec = blackout_spec(events)
    spec.sim_kwargs["waterfill_backend"] = backend
    eng = FleetEngine(spec, seed=0, forest=forest, faults=faults,
                      device=device)
    dead = eng.sim.regions.index(BLACKOUT_DC)
    caps = []

    def hook(engine, row):
        # the largest cap on a pair touching the dead DC, over the jobs
        # that span it (0.0 while it is quarantined)
        top = 0.0
        for job in engine.fleet.jobs.values():
            if dead in job.spec.dcs:
                k = list(job.spec.dcs).index(dead)
                cap = np.asarray(job.controller.envelope.link_cap)
                off = ~np.eye(len(cap), dtype=bool)
                top = max(top, float(cap[k][off[k]].max()),
                          float(cap[:, k][off[:, k]].max()))
        caps.append(top)
    eng.step_hook = hook
    return eng.run(), caps


def fleet_rows_match(got, want, what: str) -> float:
    """Fleet trace steps: every integer and string field equal, the BW
    fields within FLEET_TOL; returns the largest |diff|."""
    worst = 0.0
    if len(got.trace.steps) != len(want.trace.steps):
        raise AssertionError(f"{what}: step counts differ")
    for g, w in zip(got.trace.steps, want.trace.steps):
        if (g.tick, g.events, g.n_jobs) != (w.tick, w.events, w.n_jobs):
            raise AssertionError(f"{what} tick {w.tick}: header differs")
        for a, b in zip(g.jobs, w.jobs):
            for key in ("name", "priority", "budget", "conns_total",
                        "plan_sig"):
                if a[key] != b[key]:
                    raise AssertionError(f"{what} tick {w.tick} "
                                         f"{b['name']}: {key}")
            for key in ("cap_min", "achieved_min", "achieved_mean"):
                np.testing.assert_allclose(a[key], b[key], rtol=FLEET_TOL,
                                           atol=FLEET_TOL,
                                           err_msg=f"{what} {key}")
                worst = max(worst, abs(a[key] - b[key]))
    return worst


def blackout_part(forest, dev) -> dict:
    """Part (2) of the faults phase (see the head comment)."""
    host, host_caps = blackout_run(forest, "cpu", "numpy")
    clean, _ = blackout_run(forest, "cpu", "numpy", faults="off",
                            events=False)
    ops.fill_rates.launches = 0
    ops.rf_predict.launches = 0
    with FillCheck() as check, counting_ticks() as seen:
        t0 = time.perf_counter()
        card, caps = blackout_run(forest, dev, "cuda")
        secs = time.perf_counter() - t0
    launches = {"waterfill": ops.fill_rates.launches,
                "rf_predict": ops.rf_predict.launches}
    st = check.stats
    if launches["rf_predict"] != BLACKOUT_TICKS \
            or seen["ticks"] != BLACKOUT_TICKS \
            or not (launches["waterfill"] == st["fills"]
                    == st["sim_fills"] > 0) or st["nonfinite_fills"]:
        raise AssertionError(f"blackout fleet: launches {launches}, "
                             f"{seen['ticks']} ticks, fills {st}")
    worst = fleet_rows_match(card, host, "blackout fleet card vs host")
    np.testing.assert_allclose(caps, host_caps, rtol=FLEET_TOL,
                               atol=FLEET_TOL,
                               err_msg="blackout fleet: dead-pair caps")
    live = [k for k in range(BLACKOUT_TICKS) if k not in BLACKOUT_STEPS]
    if any(caps[k] != 0.0 for k in BLACKOUT_STEPS) or \
            any(caps[k] <= 0.0 for k in live):
        raise AssertionError(f"blackout fleet: caps on pairs touching "
                             f"{BLACKOUT_DC} per tick {caps}")
    dead = WanSimulator().regions.index(BLACKOUT_DC)
    untouched = [j.name for j in fleet_jobs() if dead not in j.dcs]
    cap_moved = 0.0
    for name in untouched:
        for key in ("budget", "conns_total"):
            if card.trace.job_series(name, key) != \
                    clean.trace.job_series(name, key):
                raise AssertionError(f"blackout fleet: {name}'s {key} "
                                     f"series differs from the run with "
                                     f"faults off")
        a = np.asarray(card.trace.job_series(name, "cap_min"))
        b = np.asarray(clean.trace.job_series(name, "cap_min"))
        cap_moved = max(cap_moved, float(np.max(np.abs(a / b - 1.0))))
    return {"launches": launches, "ticks": seen["ticks"],
            "rows_per_tick": sorted(set(seen["rows"])), "s": secs,
            "max_abs_err_bw": worst, "untouched_jobs": untouched,
            "untouched_cap_max_rel_change": cap_moved,
            "touched_dead_caps": caps, **st}


def obs_doc(device: str, path: Path) -> dict:
    """`python -m repro_torch.obs.cli run` of the obs scenario, in this
    process, on `device` ("card" = the default)."""
    argv = ["run", OBS_SCENARIO, "--seed", str(PIN_SEED), "-o", str(path)]
    if device == "cpu":
        argv += ["--device", "cpu"]
    if obs_cli.main(argv) != 0:
        raise AssertionError(f"obs run on {device} exited non-zero")
    return obs_load(str(path))


def without_span_times(doc):
    """The document less the spans' wall times (`total_s`, `mean_s`)."""
    doc = json.loads(json.dumps(doc))
    for st in doc.get("spans", {}).get("stages", {}).values():
        st.pop("total_s", None)
        st.pop("mean_s", None)
    return doc


def obs_part() -> dict:
    """Part (3) of the faults phase (see the head comment)."""
    with tempfile.TemporaryDirectory() as tmp:
        host = obs_doc("cpu", Path(tmp) / "host.json")
        ops.fill_rates.launches = 0
        with FillCheck() as check:
            t0 = time.perf_counter()
            card = obs_doc("card", Path(tmp) / "card.json")
            secs = time.perf_counter() - t0
    problems = check_run(card)
    launches = ops.fill_rates.launches
    st = check.stats
    if problems or not (launches == st["fills"] == st["sim_fills"] > 0):
        raise AssertionError(f"obs run: problems {problems}, {launches} "
                             f"launches, fills {st}")
    if "spans" not in card:
        raise AssertionError("obs run: the card's document has no spans")
    worst = docs_match(without_span_times(card), without_span_times(host),
                       "obs")
    return {"launches": launches, "s": secs, "max_rel_gap": worst,
            "sle": card["sle"], "spans": card["spans"]["count"], **st}


def docs_match(got, want, path: str) -> float:
    """Two JSON documents: the same keys and lengths, every leaf equal
    but floats, which agree within OBS_TOL relative; returns the
    largest relative gap."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{path}: keys differ")
        return max([docs_match(got[k], want[k], f"{path}.{k}")
                    for k in want], default=0.0)
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{path}: lengths differ")
        return max([docs_match(g, w, f"{path}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))], default=0.0)
    if isinstance(want, float) and isinstance(got, float):
        gap = abs(got - want) / max(abs(want), 1e-300) if got != want \
            else 0.0
        if gap > OBS_TOL:
            raise AssertionError(f"{path}: {got!r} != {want!r}")
        return gap
    if got != want or type(got) is not type(want):
        raise AssertionError(f"{path}: {got!r} != {want!r}")
    return 0.0


def faults_phase(paper, dev, floor_ms: float, smi: str) -> dict:
    """The faults phase (see the head comment); every check fatal."""
    out = {}
    ch = chaos_part()
    out["chaos"] = ch
    for r in ch["rows"]:
        log(f"[faults] chaos {r['scenario']} {r['mode']}: crashed "
            f"{r['crashed']}, steps {r['steps_completed']}/"
            f"{r['steps_total']}, mttr {r['mttr_steps']}, floor "
            f"{r['degraded_min_bw']}, injected {r['injected']}, rollbacks "
            f"{r['rollbacks']}, retry ${r['retry_usd']}"
            + (f", error {r['error']!r}" if r["error"] else ""))
    s = ch["summary"]
    log(f"[faults] chaos_report(seed={PIN_SEED}) on the card ({ch['s']:.3f} "
        f"s; host {ch['host_s']:.3f} s): every row equal to the host's "
        f"(floats within {CHAOS_RTOL} relative, largest gap "
        f"{ch['max_rel_gap']:.3g}); ladder crashes {s['ladder_crashes']}, "
        f"naive {s['naive_crashes']}; mean MTTR {s['ladder_mean_mttr']} vs "
        f"{s['naive_mean_mttr']} steps, floor {s['ladder_min_floor']} vs "
        f"{s['naive_min_floor']} | {smi}")
    log(f"[faults] chaos fills: {ch['fills']} ({ch['dead_fills']} with dead "
        f"pairs, {ch['dead_pairs']} dead pairs in all; "
        f"{ch['nonfinite_fills']} with a non-finite input), "
        f"{ch['launches']['waterfill']} waterfill launches, each fill equal "
        f"to the host loop's iterations and within {WF_TOL} (max |diff| "
        f"{ch['max_abs_err']:.3g}); {ch['launches']['rf_predict']} rf_predict"
        f" launches for {ch['fleet_ticks']} fleet ticks ({ch['fleet_runs']} "
        f"fleet runs, rows a tick {ch['rows_per_tick']})")
    t = ch["dead_fill_timing"]
    log(f"[faults] one dead-pair fill ({ch['dead_fill_pairs']} dead pairs, "
        f"{t['iters'][0]} iterations): kernel {t['ms']:.5f} ms (device, "
        f"graph of 20 calls) | launch floor {floor_ms:.5f} ms | numpy "
        f"wrapper call {t['wrapper_us']:.1f} us (host) | host loop "
        f"{t['host_loop_us']:.1f} us (host) | plain {t['plain_ms']:.4f} ms "
        f"| bound {t['bound_ms']:.7f} ms by {t['bound_by']} | {smi}")
    t0 = time.perf_counter()
    bo = blackout_part(paper, dev)
    bo["s_all"] = time.perf_counter() - t0
    out["blackout"] = bo
    log(f"[faults] blackout fleet {N_JOBS} jobs x {BLACKOUT_TICKS} ticks "
        f"(paper forest, m_total={M_TOTAL}, {BLACKOUT_DC} dark ticks "
        f"{BLACKOUT_STEPS.start}-{BLACKOUT_STEPS.stop - 1}, faults on) on "
        f"the card: {bo['launches']['rf_predict']} rf_predict launches "
        f"({bo['rows_per_tick']} rows a tick), {bo['fills']} fills "
        f"({bo['dead_fills']} with dead pairs), "
        f"{bo['launches']['waterfill']} waterfill launches, each fill within"
        f" {WF_TOL} of the host loop (max |diff| {bo['max_abs_err']:.3g}); "
        f"records equal to the host run's (integers exact, BW within "
        f"{FLEET_TOL}, max |diff| {bo['max_abs_err_bw']:.3g}); {bo['s']:.3f} "
        f"s | {smi}")
    log(f"[faults] blackout fleet: every job spanning {BLACKOUT_DC} capped at"
        f" 0 on its dead pairs at ticks {BLACKOUT_STEPS.start}-"
        f"{BLACKOUT_STEPS.stop - 1} and above 0 elsewhere; the "
        f"{len(bo['untouched_jobs'])} jobs that do not span it keep the "
        f"budget and conns series of the run with faults off (their "
        f"cap_min moves by up to {bo['untouched_cap_max_rel_change']:.2%} "
        f"with the capacity probe)")
    ob = obs_part()
    out["obs"] = ob
    log(f"[faults] obs.cli run {OBS_SCENARIO} --seed {PIN_SEED} on the card: "
        f"check_run clean, {ob['spans']} spans, {ob['launches']} waterfill "
        f"launches = {ob['fills']} fills ({ob['dead_fills']} with dead "
        f"pairs); document equal to the host run's less span wall times "
        f"(largest relative gap {ob['max_rel_gap']:.3g}); sle {ob['sle']}; "
        f"{ob['s']:.3f} s | {smi}")
    return out


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


def check_ssd(args):
    """Kernel (on the CPU: the wrapper's plain path) vs the plain
    version on the same inputs, atol/rtol SSD_TOL. Returns (max |diff|,
    max |diff| / (atol + rtol |plain|): the share of the tolerance)."""
    y, st = ops.ssd_chunk(*args)
    yp, sp = ssd_chunk_ref(*args)
    if args[0].device.type == "cuda":
        torch.cuda.synchronize()
    err, share = 0.0, 0.0
    for got, want in ((y, yp), (st, sp)):
        got, want = got.cpu().numpy(), want.cpu().numpy()
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"ssd_chunk output {got.shape} (plain "
                                 f"{want.shape}) or non-finite values")
        np.testing.assert_allclose(got, want, atol=SSD_TOL, rtol=SSD_TOL)
        diff = np.abs(got - want)
        err = max(err, float(diff.max()))
        share = max(share, float((diff / (SSD_TOL + SSD_TOL *
                                          np.abs(want))).max()))
    return err, share


def ssd_subsets(args, Bs=(1, 4), nCs=(1, 3)):
    """The inputs cut to each (B, nC) that they hold, made contiguous."""
    B, nC = args[0].shape[:2]
    for b in sorted({min(v, B) for v in Bs}):
        for c in sorted({min(v, nC) for v in nCs}):
            yield b, c, tuple(t[:b, :c].contiguous() for t in args)


def ssd_work(xq, Bq):
    """Bytes the call must move (each input read once, each output
    written once) and the operations these inputs need, by unit: the
    contractions (a multiply-add is 2: C.B for the causal (q, k) pairs
    once per chunk, shared by the heads; per head the causal y product
    over P and the states' [P, N] product) and the elementwise work (per
    head and causal pair the decay: subtract, exp, multiply; per head and
    row the state's decay, subtract and exp, and x times it; the
    cumulative sum)."""
    B, nC, Q, H, P = xq.shape
    N = Bq.shape[-1]
    chunks, pairs = B * nC, Q * (Q + 1) // 2
    mm_ops = chunks * (2 * N * pairs + H * pairs * 2 * P + H * Q * 2 * P * N)
    ew_ops = chunks * (H * pairs * 3 + H * Q * (2 + P) + H * Q)
    nbytes = (xq.numel() + 2 * Bq.numel()) * xq.element_size() + \
        chunks * H * Q * 4 + xq.numel() * 4 + chunks * H * P * N * 4
    return nbytes, mm_ops, ew_ops


def ssd_bound(xq, Bq):
    """(ms, bound_by, bytes, ops): the longest of the bytes at the HBM
    rate, the contractions at the bf16 tensor-core rate (bf16 inputs:
    bf16 products are exact, the sums f32) or the f32 rate (f32 inputs),
    and the elementwise work at the f32 rate."""
    nbytes, mm_ops, ew_ops = ssd_work(xq, Bq)
    mm_rate = BF16_TC_OPS_PER_S if xq.dtype == torch.bfloat16 \
        else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(mm_ops / mm_rate, ew_ops / F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes,
            mm_ops + ew_ops)


def time_ssd(args):
    bound_ms, by, nbytes, nops = ssd_bound(args[0], args[1])
    return {"shape": list(args[0].shape) + [args[1].shape[-1]],
            "dtype": str(args[0].dtype).replace("torch.", ""),
            "ms": device_ms(lambda: ops.ssd_chunk(*args), launches=20,
                            reps=5),
            "wrapper_ms": call_ms(lambda: ops.ssd_chunk(*args), reps=11),
            "plain_ms": call_ms(lambda: ssd_chunk_ref(*args), reps=11),
            "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
            "ops": nops}


def _copy_laid_out(t: torch.Tensor) -> torch.Tensor:
    """A copy of t with t's strides (a slice stays a slice)."""
    c = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                            device=t.device)
    return c.copy_(t)


GATED_OPS = ("ssd_chunk", "silu", "silu_gate")


def capture_layer0(step):
    """Run `step` (an engine's prefill or decode step) and return the
    inputs of its first call of each of GATED_OPS (layer 0's) that it
    makes, copied in their layouts; `ssm` sees a capturing `ops`
    meanwhile."""
    seen = {}

    def capturing(name):
        fn = getattr(ops, name)

        def call(*args):
            if name not in seen:
                seen[name] = tuple(_copy_laid_out(t) for t in args)
            return fn(*args)
        return call

    ssm.ops = types.SimpleNamespace(**{n: capturing(n) for n in GATED_OPS})
    try:
        step()
    finally:
        ssm.ops = ops
    return seen


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
    ssd_chunk kernels, the silu kernels, matrix products (cuBLAS's
    nvjet / gemm / gemv
    and CUTLASS names), and the rest; the number of kernels run; and
    the five longest kernels by total time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {"ssd_chunk": 0.0, "silu": 0.0, "matmul": 0.0, "other": 0.0}
    rows, n_kernels = [], 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        kind = "ssd_chunk" if "ssd_" in name else "silu" if \
            "silu_" in name else "matmul" if any(
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


# ----------------------------------------------------------------------
# silu phase
# ----------------------------------------------------------------------
SILU_PLAIN = {"silu": silu_ref, "silu_gate": silu_gate_ref}


def check_silu(name: str, args) -> float:
    """The silu kernel `name` (on the CPU: the wrapper's plain path) vs
    its plain version on the same inputs: every output bit-equal,
    finite, of the input's shape. Returns max |diff| (0)."""
    got = getattr(ops, name)(*args)
    want = SILU_PLAIN[name](*args)
    sync(args[0].device)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        if g.shape != tuple(args[0].shape) or not np.isfinite(g).all():
            raise AssertionError(f"{name} output {g.shape} or non-finite "
                                 f"values")
        np.testing.assert_array_equal(g, w)
        err = max(err, float(np.max(np.abs(g - w))))
    return err


def silu_bound(name: str, args):
    """(ms, bound_by, bytes, ops): each input read once and each output
    written once (silu: x in, x's dtype out; silu_gate: y and z in, y's
    dtype and f32 out), against the f32 operations (exp, add, divide,
    multiply a silu, the gate's product one more)."""
    n, e = args[0].numel(), args[0].element_size()
    if name == "silu":
        nbytes, nops = 2 * n * e, 4 * n
    else:
        nbytes, nops = n * (3 * e + 4), 5 * n
    return roofline(nbytes, nops) + (nbytes, nops)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of `fn` takes to issue, `calls` calls back
    to back with no synchronize between them (what a decode step pays
    per call while the device keeps up), after warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def time_silu(name: str, args) -> dict:
    """Device ms of the wrapper's call (one launch) beside the plain
    version and the bound, and the host's issue time of each."""
    bound_ms, by, nbytes, nops = silu_bound(name, args)
    fn, plain = getattr(ops, name), SILU_PLAIN[name]
    return {"shape": list(args[0].shape), "strides": [
                list(t.stride()) for t in args],
            "dtype": str(args[0].dtype).replace("torch.", ""),
            "ms": graph_ms(lambda: fn(*args), launches=20, reps=11),
            "wrapper_ms": call_ms(lambda: fn(*args)),
            "plain_ms": call_ms(lambda: plain(*args)),
            "host_us": host_us(lambda: fn(*args)),
            "plain_host_us": host_us(lambda: plain(*args)),
            "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
            "ops": nops}


# ----------------------------------------------------------------------
# quantize phase
# ----------------------------------------------------------------------
def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def check_quant_tile(x: torch.Tensor, bits: int) -> float:
    """The tile kernels (on the CPU: the wrappers' plain paths) against
    the plain versions on the same inputs: payload, scales and both
    dequantized outputs bit-equal. Returns max |diff| (0)."""
    q, s = ops.quantize(x, bits)
    outs = [ops.dequantize(q, s, out_dtype=dt)
            for dt in (torch.float32, torch.bfloat16)]
    qp, sp = quantize_ref(x, bits)
    sync(x.device)
    pairs = [(q, qp), (s, sp)] + [
        (o, dequantize_ref(q, s, dtype=o.dtype)) for o in outs]
    for got, want in pairs:
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"quantize tile {tuple(x.shape)} "
                                 f"{x.dtype} {bits} bits: kernel != plain")
    return 0.0


def check_quant_groups(x2d: torch.Tensor, bits: int) -> float:
    """The grouped kernels against the plain versions, bit-equal: the
    payload, the scales, both dequantized outputs, and the accumulating
    dequantize into an f32 accumulator (x2d's values, as the gradient
    sync adds a pod's decoded part into its own)."""
    q, s = ops.quantize_groups(x2d, bits)
    outs = [ops.dequantize_groups(q, s, dt)
            for dt in (torch.float32, torch.bfloat16)]
    acc = x2d.to(torch.float32, copy=True)
    acc_plain = acc.clone()
    ops.dequantize_groups_add(q, s, acc)
    qp, sp = quantize_groups_ref(x2d, bits)
    sync(x2d.device)
    pairs = [(q, qp), (s, sp)] + [
        (o, dequantize_groups_ref(q, s, o.dtype)) for o in outs] + [
        (acc, dequantize_groups_add_ref(q, s, acc_plain))]
    for got, want in pairs:
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"quantize groups {tuple(x2d.shape)} "
                                 f"{x2d.dtype} {bits} bits: kernel != "
                                 f"plain")
    return 0.0


def quant_bound(n: int, n_scales: int, wide_bytes: int, dequant: bool):
    """Bytes the call must move (the wide side: 4 B f32 or 2 B bf16 per
    element; the payload 1 B; the scales 4 B each) and its f32
    operations (quantize: |x|, max, divide, round, two clamps per
    element; dequantize: one multiply), as (ms, bound_by, bytes, ops)."""
    nbytes = n * (wide_bytes + 1) + 4 * n_scales
    nops = n * (1 if dequant else 6) + n_scales
    return roofline(nbytes, nops) + (nbytes, nops)


def time_quant(x: torch.Tensor, grouped: bool, bits: int = 8) -> dict:
    """Kernel (a CUDA graph of 20 wrapper calls) and plain version
    (events over back-to-back calls) times of quantize and of dequantize
    (to x's dtype) at x, beside their bounds."""
    if grouped:
        q, s = ops.quantize_groups(x, bits)
        enc = (lambda: ops.quantize_groups(x, bits),
               lambda: quantize_groups_ref(x, bits))
        dec = (lambda: ops.dequantize_groups(q, s, x.dtype),
               lambda: dequantize_groups_ref(q, s, x.dtype))
    else:
        q, s = ops.quantize(x, bits)
        enc = (lambda: ops.quantize(x, bits), lambda: quantize_ref(x, bits))
        dec = (lambda: ops.dequantize(q, s, out_dtype=x.dtype),
               lambda: dequantize_ref(q, s, dtype=x.dtype))
    out = {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
           "form": "groups" if grouped else "tiles", "bits": bits}
    for name, (kernel, plain) in (("quantize", enc), ("dequantize", dec)):
        b_ms, by, nbytes, nops = quant_bound(
            x.numel(), s.numel(), x.element_size(), name == "dequantize")
        out[name] = {"ms": graph_ms(kernel), "plain_ms": device_ms(
            plain, launches=3, reps=3), "bound_ms": b_ms, "bound_by": by,
            "bytes": nbytes, "ops": nops}
    return out


def time_decode_add(x: torch.Tensor, bits: int = 8) -> dict:
    """The accumulating dequantize (`dequantize_groups_add`, an FMA into
    an f32 accumulator, as the compressed sync decodes) at x [G, L] f32,
    kernel and plain version, beside its bound: the payload read (1 B),
    the accumulator read and written (4 + 4 B) per element, and the
    scales; one FMA per element."""
    q, s = ops.quantize_groups(x, bits)
    acc = x.clone()
    nbytes = x.numel() * (1 + 4 + 4) + 4 * s.numel()
    b_ms, by = roofline(nbytes, x.numel())
    return {"shape": list(x.shape), "dtype": "float32", "bits": bits,
            "ms": graph_ms(lambda: ops.dequantize_groups_add(q, s, acc)),
            "plain_ms": device_ms(lambda: dequantize_groups_add_ref(
                q, s, acc), launches=3, reps=3),
            "bound_ms": b_ms, "bound_by": by, "bytes": nbytes,
            "ops": x.numel()}


def migrate_parts(cfg, batch: int, chunks: int = 8):
    """[(name, elements, dtype)] of one chunk of each leaf of the
    model's stacked cache (the reference's layout) at `batch`."""
    spec = ssm.ssm_cache_spec(cfg, batch,
                              getattr(torch, cfg.dtype))
    return [(k, -(-cfg.n_layers * int(np.prod(shape)) // chunks), dt)
            for k, (shape, dt) in spec.items()]


def sync_parts(shape, chunks: int) -> int:
    """How many parts `wan_allreduce_batched` cuts a leaf of this shape
    (the pod dim left out) into in a phase of `chunks`: the chunks where
    they divide its first axis, else one (the whole leaf)."""
    return chunks if len(shape) and chunks > 1 and \
        shape[0] % chunks == 0 else 1


def wansync_lengths(shapes: dict, plan: WanPlan) -> list:
    """The distinct group lengths L of the [P, L] parts that
    `wan_allreduce_batched` encodes for leaves of `shapes` in the plan's
    quantized phases."""
    return sorted({int(np.prod(shape)) // sync_parts(shape, ph["chunks"])
                   for shape in shapes.values()
                   for ph in offset_schedule(plan) if ph["bits"] <= 8})


def check_quantize(cfg, batch: int, device, tiles=QUANT_TILES,
                   lengths=QUANT_LENGTHS, sync_lengths=()):
    """The quantize phase's comparisons; returns (cases, max |diff|).
    `sync_lengths` are the wansync phase's part lengths: [P, L] with pod
    r's row scaled by r + 1, as that phase's gradients are."""
    gen = torch.Generator(device=device).manual_seed(0)
    cases, err = [], 0.0
    for shape in tiles:
        base = torch.randn(shape, generator=gen, device=device) * 3
        for dtype in (torch.float32, torch.bfloat16):
            for bits in (8, 4):
                err = max(err, check_quant_tile(base.to(dtype), bits))
                cases.append({"form": "tiles", "shape": list(shape),
                              "dtype": str(dtype), "bits": bits})
    groups = [(G, L, torch.float32, 3.0) for G in (1, 4) for L in lengths]
    for name, n, dt in migrate_parts(cfg, batch):
        groups += [(1, n, dt, 3.0), (4, n // 4, dt, 3.0)]
    pods = torch.arange(1, N_PODS + 1, dtype=torch.float32, device=device)
    groups += [(N_PODS, L, torch.float32, pods[:, None]) for L in sync_lengths]
    for G, L, dt, mul in groups:
        base = torch.randn((G, L), generator=gen, device=device) * mul
        for bits in (8, 4):
            err = max(err, check_quant_groups(base.to(dt), bits))
            cases.append({"form": "groups", "shape": [G, L],
                          "dtype": str(dt), "bits": bits})
        del base
    return cases, err


# ----------------------------------------------------------------------
# migrate phase: kv_migrate across 4 ranks (processes) on one card
# ----------------------------------------------------------------------
def roundtrip_host(x: torch.Tensor, chunks: int, bits: int) -> torch.Tensor:
    """What a receiving pod should hold: the leaf flattened, zero-padded
    and split into `chunks` parts, each through the plain codec on the
    host (wire_encode / wire_decode on CPU tensors), joined."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % chunks
    flat = torch.nn.functional.pad(flat, (0, pad)) if pad else flat
    parts = [wire_decode(*wire_encode(p, bits), x.dtype, bits)
             for p in flat.chunk(chunks)]
    return torch.cat(parts)[:x.numel()].reshape(x.shape)


def wire_bytes(leaves, plan: WanPlan, compress: bool) -> list:
    """Bytes one pod puts on the wire in each offset phase of
    `kv_migrate`, from the schedule and the leaves alone: per leaf the
    payload, zero-padded to a multiple of the phase's chunks, at the
    phase's bits (1 B an element below 16 bits, 2 B at 16, the leaf's
    own width at 32), and one 4-byte scale per part below 16 bits."""
    out = []
    for ph in offset_schedule(plan):
        bits, chunks = ph["bits"] if compress else 32, ph["chunks"]
        n = 0
        for x in leaves:
            width = 1 if bits <= 8 else 2 if bits == 16 else x.element_size()
            n += -(-x.numel() // chunks) * chunks * width
            n += 4 * chunks if bits <= 8 else 0
        out.append(n)
    return out


def expected_launches(plan: WanPlan, n_leaves: int, compress: bool) -> int:
    """Quantize (and dequantize) launches of one pod's kv_migrate: one
    per part of every leaf in every phase with an int8 payload."""
    return 0 if not compress else n_leaves * sum(
        ph["chunks"] for ph in offset_schedule(plan) if ph["bits"] <= 8)


def phase_codec_ms(cfg, batch: int, sched, compress: bool,
                   q_timing: dict) -> list:
    """Per offset phase, the device ms of one pod's quantize and
    dequantize launches in `kv_migrate`: the phase's parts times the
    quantize phase's time at that part (0 where the phase launches no
    kernel)."""
    out = []
    for ph in sched:
        c, lossy = ph["chunks"], compress and ph["bits"] <= 8
        out.append({k: sum(c * q_timing[f"part_{name}_c{c}"][k]["ms"]
                           for name, _, _ in migrate_parts(cfg, batch, c))
                    if lossy else 0.0 for k in ("quantize", "dequantize")})
    return out


def _migrate_pod(rank: int, n_pods: int, cache_path: str, runs, out_dir: str,
                 device: str):
    """One pod of the migrate phase. Pod 0 loads the engine's cache;
    pod r > 0 starts from it times (r + 1). Each run zeroes the launch
    counts, migrates from pod 0 and reads the counts; then every pod
    checks what it holds: pod 0 its own cache; a receiving pod, the
    plain codec's round trip of pod 0's leaves on the host under its
    phase (offset r). Pod 1 saves what it received for the engine."""
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(2)
    host = torch.load(cache_path)                        # pod 0's cache
    mine = {"blocks": [{k: (v if rank == 0 else
                            (v.float() * (rank + 1)).to(v.dtype)).to(dev)
                        for k, v in layer.items()}
                       for layer in host["blocks"]]}
    ref_leaves = stack_cache(host)["blocks"]
    out = {}
    for name, plan, compress in runs:
        sync(dev)
        torch.distributed.barrier()     # the pods start each run together
        ops.quantize.launches = 0
        ops.dequantize.launches = 0
        tracer = SpanTracer()
        t0 = time.perf_counter()
        moved = kv_migrate(mine, plan, 0, compress=compress, tracer=tracer)
        sync(dev)
        wall_s = time.perf_counter() - t0
        phase_ms = {}
        for row in tracer.spans:
            o = row["attrs"]["offset"]
            phase_ms[o] = phase_ms.get(o, 0.0) + row["dur_s"] * 1e3
        counts = {"quantize": ops.quantize.launches,
                  "dequantize": ops.dequantize.launches}
        # (the plain versions on the CPU launch nothing)
        want_n = expected_launches(plan, len(ref_leaves), compress) \
            if dev.type == "cuda" else 0
        if counts != {"quantize": want_n, "dequantize": want_n}:
            raise AssertionError(f"pod {rank} run {name}: launches "
                                 f"{counts}, expected {want_n} each")
        got = {k: v.cpu() for k, v in stack_cache(moved)["blocks"].items()}
        t1 = time.perf_counter()
        if rank == 0 or not compress:
            want = ref_leaves
        else:
            ph = offset_schedule(plan)[rank - 1]
            want = {k: roundtrip_host(v, ph["chunks"], ph["bits"])
                    for k, v in ref_leaves.items()}
        for k, v in want.items():
            if not torch.equal(got[k], v):
                raise AssertionError(f"pod {rank} run {name}: leaf {k} is "
                                     f"not bit-equal to the expected cache")
        check_s = time.perf_counter() - t1
        if rank == 1 and name in ("b", "b_raw"):
            torch.save(unstack_cache({"blocks": got}),
                       os.path.join(out_dir, f"pod1_{name}.pt"))
        out[name] = {"counts": counts, "expected": want_n,
                     "phase_wall_ms": [phase_ms[ph["offset"]] for ph in
                                       offset_schedule(plan)],
                     "wall_s": wall_s, "host_check_s": check_s}
    return out


def decode_from(eng: Engine, cache, first_ids: np.ndarray, steps: int):
    """Greedy decode `steps` steps from `cache`, fed `first_ids` first;
    returns (ids [steps, B], logits [steps, B, V] f32 on the host)."""
    eng.cache = cache
    cur, ids, logits = first_ids, [], []
    for _ in range(steps):
        cur = eng.decode(cur)
        ids.append(cur)
        logits.append(eng.last_logits.float().cpu())
    return np.stack(ids), torch.stack(logits)


def run_migrate(eng: Engine, tokens: np.ndarray, plans, device,
                steps: int = MIGRATE_STEPS) -> dict:
    """Prefill `tokens`, then move the engine's cache from pod 0 to 4
    ranks under each (name, plan, compress) of `plans`, and continue
    the decode on the engine from what pod 1 received under plan (b)."""
    first = eng.prefill(tokens)
    cache0 = eng.cache
    leaves = list(stack_cache(cache0)["blocks"].values())
    wire = {name: wire_bytes(leaves, plan, compress)
            for name, plan, compress in plans}
    del leaves
    own_ids, own_logits = decode_from(eng, cache0, first, steps)
    with tempfile.TemporaryDirectory(prefix="migrate-") as tmp:
        path = os.path.join(tmp, "pod0.pt")
        torch.save({"blocks": [{k: v.cpu() for k, v in layer.items()}
                               for layer in cache0["blocks"]]}, path)
        t0 = time.perf_counter()
        per_pod = compat.run_pods(_migrate_pod, N_PODS, path, plans, tmp,
                                  device.type, timeout=POD_DEADLINE)
        pods_s = time.perf_counter() - t0
        cont = {}
        for name in ("b", "b_raw"):
            back = torch.load(os.path.join(tmp, f"pod1_{name}.pt"))
            cache = {"blocks": [{k: v.to(device) for k, v in layer.items()}
                                for layer in back["blocks"]]}
            ids, logits = decode_from(eng, cache, first, steps)
            cont[name] = {"ids_equal": int((ids == own_ids).sum()),
                          "ids": int(ids.size),
                          "max_abs_logit_diff": float(
                              (logits - own_logits).abs().max()),
                          "max_abs_logit": float(own_logits.abs().max())}
    if cont["b_raw"]["ids_equal"] != cont["b_raw"]["ids"]:
        raise AssertionError(f"decode from pod 1's uncompressed cache: "
                             f"{cont['b_raw']} ids differ from the "
                             f"engine's own continuation")
    return {"per_pod": per_pod, "pods_s": pods_s, "continue": cont,
            "wire_bytes": wire,
            "cache_bytes": sum(v.numel() * v.element_size()
                               for layer in cache0["blocks"]
                               for v in layer.values())}


# ----------------------------------------------------------------------
# wansync phase: the batched all-reduce over a gradient tree with the
# shapes of the model's (stacked) parameters
# ----------------------------------------------------------------------
def grad_shapes(cfg) -> dict:
    """{path: shape} of the reference's parameter tree (the layers
    stacked along a leading axis), from the port's modules on `meta`."""
    model = MambaLM(cfg, torch.device("meta"), torch.float32)
    shapes = {"embed": tuple(model.embed.shape),
              "final_norm": tuple(model.final_norm.shape),
              "lm_head": tuple(model.lm_head.shape)}
    blk = model.blocks[0]
    shapes["blocks/ln1"] = (cfg.n_layers,) + tuple(blk.ln1.shape)
    for n, p in blk.ssm.named_parameters():
        shapes[f"blocks/ssm/{n}"] = (cfg.n_layers,) + tuple(p.shape)
    return shapes


def make_grads(shapes: dict, device, pods: int = N_PODS) -> dict:
    """Pod r's gradient = base * (r + 1), base from a seeded generator
    (`tests/test_system.py`'s contract): [P, ...] f32 per leaf."""
    gen = torch.Generator(device=device).manual_seed(0)
    scale = torch.arange(1, pods + 1, dtype=torch.float32, device=device)
    out = {}
    for path, shape in shapes.items():
        base = torch.randn(shape, generator=gen, device=device)
        out[path] = base[None] * scale.view((pods,) + (1,) * len(shape))
        del base
    return out


def _blocks(t: torch.Tensor, n: int = 1 << 26):
    flat = t.reshape(-1)
    for i in range(0, flat.numel(), n):
        yield flat[i:i + n]


def sync_error(got: dict, want: dict, bound_of) -> float:
    """Max over leaves and pods of max |got - want| / bound_of(path,
    pod, want) (<= 1 passes), pod slice by pod slice in blocks of 64 M
    elements (no leaf-sized temporaries; `want` may be a broadcast
    view)."""
    worst = 0.0
    for path in got:
        for r in range(got[path].shape[0]):
            for g, w in zip(_blocks(got[path][r]), _blocks(want[path][r])):
                worst = max(worst, ((g - w).abs() /
                                    bound_of(path, r, w)).max().item())
    return worst


def kernel_names(fn) -> list:
    """The names of the device operations (kernels, memcpys, memsets)
    that `fn` runs, in the order they started, from a torch.profiler
    trace (CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.name for e in sorted(evs, key=lambda e: e.time_range.start)]


def copies_before_quantize(names: list) -> dict:
    """From one leaf's kernel list: the quantize launches, the copy
    kernels (PyTorch's `direct_copy_kernel`, which `.contiguous()` of a
    strided part runs) in all and right before a quantize, and the
    memcpys."""
    quant = [i for i, n in enumerate(names) if "quantize_groups_kernel" in n]
    copy = [i for i, n in enumerate(names) if "copy" in n.lower()
            and "memcpy" not in n.lower()]
    return {"operations": len(names), "quantize": len(quant),
            "copy_kernels": len(copy),
            "copies_before_quantize": sum(i - 1 in copy for i in quant),
            "memcpy": sum("memcpy" in n.lower() for n in names)}


def run_wansync(grads: dict, plan: WanPlan, device) -> dict:
    """psum, then the WANify schedule uncompressed and compressed; each
    timed on the host clock around a synchronised call, twice. Checks:
    uncompressed within rtol 1e-5 (atol 1e-8) of psum, the reference's
    own contract; compressed within the quantization bound: on pod r,
    per leaf, the sum over the lossy phases o of half a step of the
    slice it received there (pod r - o's amax / qmax / 2, plus the
    payload division's rounding at |x / scale| = qmax), over P pods,
    plus rtol 1e-5 for the f32 sums."""
    res, P = {}, plan.n_pods
    sched = offset_schedule(plan)

    def timed(fn):
        ms, out = [], None
        for _ in range(2):
            out = None                  # free the first call's output
            sync(device)
            t0 = time.perf_counter()
            out = fn()
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    psum, res["psum_ms"] = timed(lambda: psum_allreduce_batched(grads, P))
    raw, res["raw_ms"] = timed(lambda: wan_allreduce_batched(grads, plan))
    res["raw_err"] = sync_error(
        raw, psum, lambda p, r, w: 1e-8 + 1e-5 * w.abs())
    del raw
    ops.quantize.launches = 0
    ops.dequantize.launches = 0
    comp, res["compressed_ms"] = timed(
        lambda: wan_allreduce_batched(grads, plan, compress=True))
    res["launches"] = {"quantize": ops.quantize.launches,
                       "dequantize": ops.dequantize.launches}
    # per call: a launch per part (chunks along axis 1 where they
    # divide it, else the whole leaf) of each leaf in each int8 phase;
    # two timed calls
    want_n = 2 * sum(sync_parts(g.shape[1:], ph["chunks"])
                     for g in grads.values() for ph in sched
                     if ph["bits"] <= 8) if device.type == "cuda" else 0
    amax = {p: [max(b.abs().max().item() for b in _blocks(g[r]))
                for r in range(P)] for p, g in grads.items()}
    # half a step at each lossy phase, of the slice pod r received there;
    # 2**-22 for the scale's own rounding
    half = {p: [sum((0.5 + qmax(ph["bits"]) * 2 ** -23) / qmax(ph["bits"])
                    * a[(r - ph["offset"]) % P] for ph in sched
                    if ph["bits"] <= 8) * (1 + 2 ** -22) for r in range(P)]
            for p, a in amax.items()}
    res["compressed_err"] = sync_error(
        comp, psum, lambda p, r, w: half[p][r] / P + 1e-5 * w.abs())
    res["expected_launches"] = {"quantize": want_n, "dequantize": want_n}
    if device.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        # one leaf of the compressed call under the profiler: the
        # largest leaf whose parts are slices along axis 1
        path = max((p for p, g in grads.items() if any(
            sync_parts(g.shape[1:], ph["chunks"]) > 1 for ph in sched)),
            key=lambda p: grads[p].numel())
        del comp
        names = kernel_names(lambda: wan_allreduce_batched(
            {path: grads[path]}, plan, compress=True))
        res["profiled_leaf"] = {"path": path,
                                "shape": list(grads[path].shape),
                                **copies_before_quantize(names)}
        if res["profiled_leaf"]["copies_before_quantize"] or \
                not res["profiled_leaf"]["quantize"]:
            raise AssertionError(f"wansync leaf {path}: "
                                 f"{res['profiled_leaf']}; operations "
                                 f"{names}")
    if res["raw_err"] > 1 or res["compressed_err"] > 1:
        raise AssertionError(f"wansync off its bound: uncompressed "
                             f"{res['raw_err']:.3g}, compressed "
                             f"{res['compressed_err']:.3g} (<= 1 passes)")
    if res["launches"] != res["expected_launches"]:
        raise AssertionError(f"wansync launches {res['launches']}, "
                             f"expected {res['expected_launches']}")
    return res


def scenarios_phase(paper, dev, floor_ms: float) -> dict:
    """The scenarios phase (see the head comment); every check fatal."""
    out = {}
    # the 16 pins on the card: the fleet runs' forest is the kernel's
    pins = goldens.pinned()
    fleet_ticks = sum(get_fleet_scenario(n).steps
                      for n in fleet_scenario_names())
    ops.rf_predict.launches = 0
    ops.fill_rates.launches = 0
    t0 = time.perf_counter()
    got = goldens.collect()
    secs = time.perf_counter() - t0
    launches = {"rf_predict": ops.rf_predict.launches,
                "fill_rates": ops.fill_rates.launches}
    bad = sorted(k for k in pins if got.get(k) != pins[k])
    if bad or set(got) != set(pins):
        raise AssertionError(f"pins that do not hold on the card: {bad}")
    if launches != {"rf_predict": fleet_ticks, "fill_rates": 0}:
        raise AssertionError(f"pin runs' launches {launches}: expected one "
                             f"rf_predict a fleet tick ({fleet_ticks})")
    out["pins"] = {"held": len(got), "fleet_ticks": fleet_ticks,
                   "launches": launches, "s": secs}
    log(f"[scenarios] {len(got)} pins of tests/data/trace_golden.json held "
        f"on the card ({sum(k.startswith('scenario/') for k in got)} "
        f"scenario, {sum(k.startswith('fleet/') for k in got)} fleet, "
        f"{sum(k.startswith('placement/') for k in got)} placement; "
        f"{secs:.1f} s); rf_predict launches {launches['rf_predict']} for "
        f"{fleet_ticks} fleet ticks")

    # the single-job loop through the RF kernel, card against host
    out["bw_predictor"] = {}
    for name in BW_SCENARIOS:
        host = ScenarioEngine(
            get_scenario(name), seed=PIN_SEED,
            predictor=BwPredictor(paper, device="cpu")).run().trace.to_json()
        ops.rf_predict.launches = 0
        eng = ScenarioEngine(get_scenario(name), seed=PIN_SEED,
                             predictor=BwPredictor(paper, device=dev))
        card = eng.run().trace.to_json()
        n = ops.rf_predict.launches
        if card != host:
            raise AssertionError(f"{name} with BwPredictor: the card's "
                                 f"trace differs from the host's")
        if n != len(eng.controller.record):
            raise AssertionError(f"{name}: {n} rf_predict launches for "
                                 f"{len(eng.controller.record)} replans")
        out["bw_predictor"][name] = {"launches": n, "replans": n}
        log(f"[scenarios] {name} seed {PIN_SEED}, BwPredictor(paper "
            f"forest): to_json byte-equal card vs host, {n} rf_predict "
            f"launches (one a replan)")

    # the water-fill kernel against its plain version and the host loop
    checks, timing, max_err = [], [], 0.0
    for B, n in WF_SHAPES:
        case = wf_case(B, n, seed=B * 100 + n)
        c = check_waterfill(case, dev)
        max_err = max(max_err, c["err_plain"], c["err_host"])
        checks.append({"B": B, "N": n, **c})
        timing.append(time_waterfill(case, c["iters"]))
        log(f"[scenarios] waterfill B={B} N={n}: iterations "
            f"{min(c['iters'])}-{max(c['iters'])}, equal to the plain "
            f"version's and the host loop's; max |diff| {c['err_plain']:.3g}"
            f" (plain), {c['err_host']:.3g} (host loop), tolerance {WF_TOL}")
    for t in timing:
        log(f"[scenarios] waterfill B={t['B']} N={t['N']} "
            f"({sum(t['iters'])} iterations in all): kernel {t['ms']:.5f} "
            f"ms (device, graph of 20 calls) | launch floor {floor_ms:.5f} "
            f"ms | numpy wrapper call {t['wrapper_us']:.1f} us (host, "
            f"copies and sync) | host loop {t['host_loop_us']:.1f} us "
            f"(host, {t['B']} fill(s)) | plain {t['plain_ms']:.4f} ms | "
            f"bound {t['bound_ms']:.7f} ms by {t['bound_by']} "
            f"({t['bytes']} B, {t['ops']} f64 ops) | library call: none "
            f"(no PyTorch call computes a progressive fill)")
    out["waterfill"] = {"checks": checks, "timing": timing,
                        "max_abs_err": max_err}

    # the 12 scenarios with the device fill, every fill checked
    t0 = time.perf_counter()
    dfill = run_device_fill_scenarios()
    dfill["s"] = time.perf_counter() - t0
    out["device_fill"] = dfill
    log(f"[scenarios] {len(scenario_names())} scenarios seed {PIN_SEED} "
        f"with waterfill_backend='cuda' ({dfill['steps']} steps, "
        f"{dfill['s']:.1f} s): {dfill['fills']} fills, {dfill['launches']} "
        f"waterfill launches, each fill equal to the host loop's "
        f"iterations and within {WF_TOL} (max |diff| "
        f"{dfill['max_abs_err']:.3g}); every integer field of every step "
        f"equal to the numpy run's, floats within rtol {WF_TOL}")

    # the fleet tick with the device fill, A B B A
    ab = fleet_fill_ab(paper, dev)
    out["fleet_fill_ab"] = ab
    for backend in ("numpy", "cuda"):
        r = ab[backend]
        log(f"[scenarios] fleet {N_JOBS} jobs x {TICKS} ticks, "
            f"waterfill_backend={backend!r} ({ab['order']}): "
            f"{r['fills_per_tick']:.1f} fills a tick, tick "
            f"{r['tick_ms_median']:.3f} ms median / {r['tick_ms_p90']:.3f} "
            f"ms p90 over both runs (run medians {r['run_medians_ms']}); "
            f"its fills {r['fill_us_median']:.1f} us median (host), "
            f"{r['iters_per_fill']:.2f} iterations a fill on average, "
            f"{r['fill_ms_per_tick']:.3f} ms a tick in fills, "
            f"{r['rest_ms_per_tick']:.3f} ms in the rest (means)")
    log("[scenarios] fleet records equal across backends (budgets, conns, "
        f"plan signatures; cap and achieved BW within rtol {WF_TOL})")
    return out


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
    texts = build.compile_sources(["rf_predict", "ssd_chunk", "quantize",
                                   "silu", "waterfill"])
    results["build_s"] = time.perf_counter() - t0
    log(f"[build] rf_predict + ssd_chunk + quantize + silu + waterfill in "
        f"{results['build_s']:.1f} s")
    for name, text in texts.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line}")
    results["build_log"] = texts
    dims = get_config(ARCH).ssm
    smem = ssd_scan.smem_bytes(dims.chunk, dims.head_dim, dims.d_state)
    report = ptxas_report(texts["ssd_chunk"], ssd_scan.KERNELS)
    for name in ssd_scan.KERNELS:
        report.setdefault(name, {})["dynamic_smem"] = smem[name]
        log(f"[build] ssd_chunk: {name}: " + ", ".join(
            f"{k} {v}" for k, v in report[name].items()) + f" (dynamic "
            f"shared memory per block at Q={dims.chunk}, P={dims.head_dim}, "
            f"N={dims.d_state})")
    counts = sass_counts(build.library_path("ssd_chunk"))
    results["build_ssd"] = {"kernels": report, "sass": counts}
    log(f"[build] ssd_chunk SASS: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()))
    if counts["HGMMA"] == 0:
        raise AssertionError("no HGMMA instruction in ssd_chunk's SASS: "
                             "the tensor-core kernel is not in the binary")
    q_report = ptxas_report(texts["quantize"], QUANT_KERNELS)
    for name in QUANT_KERNELS:
        log(f"[build] quantize: {name}: " + ", ".join(
            f"{k} {v}" for k, v in q_report.get(name, {}).items()))
    q_counts = sass_counts(build.library_path("quantize"))
    results["build_quantize"] = {"kernels": q_report, "sass": q_counts}
    log(f"[build] quantize SASS: " + ", ".join(
        f"{k} {v}" for k, v in q_counts.items()))
    if q_counts["UBLKCP"] == 0:
        raise AssertionError("no UBLKCP (bulk copy) instruction in "
                             "quantize's SASS")
    spills = {n: r for n, r in q_report.items()
              if r.get("spill_stores") or r.get("spill_loads")}
    if set(q_report) != set(QUANT_KERNELS) or spills:
        raise AssertionError(f"quantize's ptxas report: kernels "
                             f"{sorted(q_report)}, spills {spills}")

    rf_report = ptxas_report(texts["rf_predict"], RF_KERNELS)
    results["build_rf_predict"] = {"kernels": rf_report}
    for name in RF_KERNELS:
        log(f"[build] rf_predict: {name}: " + ", ".join(
            f"{k} {v}" for k, v in rf_report.get(name, {}).items()))
    rf_spills = {n: r for n, r in rf_report.items()
                 if r.get("spill_stores") or r.get("spill_loads")}
    if set(rf_report) != set(RF_KERNELS) or rf_spills:
        raise AssertionError(f"rf_predict's ptxas report: kernels "
                             f"{sorted(rf_report)}, spills {rf_spills}")
    silu_report = ptxas_report(texts["silu"], SILU_KERNELS)
    results["build_silu"] = {"kernels": silu_report}
    for name in SILU_KERNELS:
        log(f"[build] silu: {name}: " + ", ".join(
            f"{k} {v}" for k, v in silu_report.get(name, {}).items()))
    silu_spills = {n: r for n, r in silu_report.items()
                   if r.get("spill_stores") or r.get("spill_loads")}
    if set(silu_report) != set(SILU_KERNELS) or silu_spills:
        raise AssertionError(f"silu's ptxas report: kernels "
                             f"{sorted(silu_report)}, spills {silu_spills}")
    wf_report = ptxas_report(texts["waterfill"], WF_KERNELS)
    results["build_waterfill"] = {"kernels": wf_report}
    for name in WF_KERNELS:
        log(f"[build] waterfill: {name}: " + ", ".join(
            f"{k} {v}" for k, v in wf_report.get(name, {}).items()))
    wf_spills = {n: r for n, r in wf_report.items()
                 if r.get("spill_stores") or r.get("spill_loads")}
    if set(wf_report) != set(WF_KERNELS) or wf_spills:
        raise AssertionError(f"waterfill's ptxas report: kernels "
                             f"{sorted(wf_report)}, spills {wf_spills}")

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
    for name, forest, ns in (("paper", paper, (len(X), 1, 191, TICK_ROWS,
                                               SWEEP_ROWS, len(X) - 1)),
                             ("demo", demo, (len(X), TICK_ROWS, 1))):
        for n in ns:
            err = check_kernel(forest, X[:n], dev)
            max_err = max(max_err, err)
            log(f"[kernel] {name} n={n}: bit-equal to plain "
                f"(max |diff| {err})")
    timing = {f"n{n}": time_kernel(paper, X[:n])
              for n in (TICK_ROWS, SWEEP_ROWS, len(X))}
    floor_ms = launch_floor_ms()
    for key, t in timing.items():
        log(f"[kernel] rf_predict {key} ({t['shape']}): kernel "
            f"{t['ms']:.5f} ms (device, graph; pair kernel "
            f"{t['pair_ms']:.5f}, tile kernel at {t['tile_warps']} warps "
            f"{t['tile_ms']:.5f}) | launch floor "
            f"{floor_ms:.5f} ms | wrapper call {t['wrapper_ms']:.5f} ms | "
            f"plain {t['plain_ms']:.5f} ms | bound {t['bound_ms']:.6f} ms "
            f"by {t['bound_by']} ({t['bytes']} B, {t['ops']} ops) | library "
            f"call: none (no single PyTorch call computes a forest)")
    results["rf_predict"] = timing
    results["launch_floor_ms"] = floor_ms
    sweep = sweep_kernels(paper, X)
    for n, row in sweep.items():
        log(f"[kernel] rf_predict sweep n={n}: " + ", ".join(
            f"{k} {v:.5f} ms" for k, v in row.items() if k != "picked")
            + f"; the wrapper picks {row['picked']}")
    results["rf_predict_sweep"] = sweep

    # 4. the same fleet with span tracing on, first: it supplies only the
    # stage breakdown (its ticks carry the tracer's cost) and takes the
    # host path's first-tick warm-up out of the timed run below
    traced, traced_records, traced_secs, _ = run_fleet(paper, dev, obs="on")
    # main path: 16 jobs x 24 ticks through the kernel, tracing off
    fleet, records, secs, counts = run_fleet(paper, dev, counted=True)
    if {k: counts[k] for k in ("rf_predict", "ssd_chunk", "fill_rates")} \
            != {"rf_predict": TICKS, "ssd_chunk": 0, "fill_rates": 0} or \
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

    # 5b. scenarios: the engines' 16 pins on the card, the single-job
    # loop through the RF kernel, the water-fill kernel and the device
    # fill in the scenarios and the fleet tick
    scen = scenarios_phase(paper, dev, floor_ms)
    results["scenarios"] = scen

    # 5c. fused: the whole tick on the card against the sequential
    # tick, the 16-variant sweep, A B B A timing, the profile
    t0 = time.perf_counter()
    results["fused"] = fused_phase(paper, dev)
    results["fused"]["s"] = time.perf_counter() - t0

    # 5d. placement: the 3 pins and the torch backend on the card
    t0 = time.perf_counter()
    results["placement"] = placement_phase(dev)
    results["placement"]["s"] = time.perf_counter() - t0

    # 5e. planes: the overlay's routed fills through the water-fill
    # kernel, placement under the overlay, the lifecycle's refits
    # through rf_predict
    t0 = time.perf_counter()
    results["planes"] = planes_phase(dev, floor_ms)
    results["planes"]["s"] = time.perf_counter() - t0

    # 5f. faults: the chaos library's fills through the water-fill
    # kernel, the 16-job blackout fleet's forest through rf_predict, one
    # obs run on the card
    t0 = time.perf_counter()
    results["faults"] = faults_phase(paper, dev, floor_ms, smi)
    results["faults"]["s"] = time.perf_counter() - t0
    log(f"[faults] phase {results['faults']['s']:.2f} s")

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
    caps = [capture_layer0(lambda g=g: eng.prefill(eng.batch_tokens(g)))
            for g in groups_of(reqs)]
    captured = [c["ssd_chunk"] for c in caps]
    decode_cap = capture_layer0(
        lambda: eng.decode(np.zeros(SERVE_BATCH, np.int32)))
    log(f"[ssd] {ARCH}: {sum(p.numel() for p in model.parameters())} "
        f"params on the card in {results['model_init_s']:.1f} s; layer-0 "
        f"inputs per group: " + ", ".join(
            f"{tuple(c[0].shape)} {c[0].dtype}" for c in captured))
    ssd_err, ssd_cases = 0.0, []
    cases = [("serve-bf16-group1", captured[0]),
             ("serve-bf16-group2", captured[1]),
             ("f32-256x80x64x128", ssd_random_inputs(4, 3, 256, 80, 64, 128,
                                                     1, dev)),
             ("f32-16x16x16x16", ssd_random_inputs(4, 3, 16, 16, 16, 16, 2,
                                                   dev))]
    for name, args in cases:
        for b, c, sub in ssd_subsets(args):
            err, share = check_ssd(sub)
            ssd_err = max(ssd_err, err)
            ssd_cases.append({"case": name, "B": b, "nC": c, "err": err,
                              "tol_share": share})
            log(f"[ssd] {name} B={b} nC={c}: within {SSD_TOL} of plain "
                f"(max |diff| {err:.3e}, {share:.3f} of the tolerance)")
    ssd_timing = [time_ssd(c) for c in captured]
    for t in ssd_timing:
        log(f"[ssd] ssd_chunk {t['shape']} {t['dtype']}: kernel "
            f"{t['ms']:.4f} ms (device, events over 20 launches) | wrapper "
            f"call {t['wrapper_ms']:.4f} ms | plain {t['plain_ms']:.4f} ms "
            f"| bound {t['bound_ms']:.5f} ms by {t['bound_by']} "
            f"({t['bytes']} B, {t['ops']} ops) | library call: none (no "
            f"single PyTorch call computes the SSD chunk)")
    results["ssd_chunk"] = {"cases": ssd_cases, "timing": ssd_timing}

    # 6b. silu: both kernels against their plain versions on layer 0's
    # inputs of both prefills and of a decode step, in their layouts
    silu_err, silu_cases, silu_timing = 0.0, [], {}
    for step, cap in (("prefill1", caps[0]), ("prefill2", caps[1]),
                      ("decode", decode_cap)):
        for name in ("silu", "silu_gate"):
            err = check_silu(name, cap[name])
            silu_err = max(silu_err, err)
            silu_cases.append({"step": step, "kernel": name, "err": err,
                               "shape": list(cap[name][0].shape)})
            log(f"[silu] {name} {step} {tuple(cap[name][0].shape)} "
                f"{cap[name][0].dtype} (strides "
                f"{[t.stride() for t in cap[name]]}): bit-equal to plain")
            if step != "prefill2":
                silu_timing[f"{name}_{step}"] = time_silu(name, cap[name])
    for key, t in silu_timing.items():
        log(f"[silu] {key} {t['shape']} {t['dtype']}: kernel {t['ms']:.5f} "
            f"ms (device, graph of 20 calls) | wrapper call "
            f"{t['wrapper_ms']:.5f} ms | plain {t['plain_ms']:.5f} ms | "
            f"host issue {t['host_us']:.2f} us a call (plain "
            f"{t['plain_host_us']:.2f}) | "
            f"bound {t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes']} "
            f"B) | library call: none (F.silu rounds once; this rounds "
            f"each op as the reference's compiled program does)")
    results["silu"] = {"cases": silu_cases, "timing": silu_timing}

    # 7. serve: the slice's main path, counts zeroed just before it
    eng.timings = {"prefill_s": [], "decode_s": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.ssd_chunk.launches = 0
    ops.rf_predict.launches = 0
    ops.silu.launches = 0
    ops.silu_gate.launches = 0
    t0 = time.perf_counter()
    eng.replan()
    schedule = eng.migration_schedule()
    t1 = time.perf_counter()
    out = eng.serve(reqs)
    serve_s = time.perf_counter() - t1
    replan_s = t1 - t0
    serve_counts = {"ssd_chunk": ops.ssd_chunk.launches,
                    "rf_predict": ops.rf_predict.launches,
                    "silu": ops.silu.launches,
                    "silu_gate": ops.silu_gate.launches}
    peak = torch.cuda.max_memory_allocated()
    n_groups = len(groups_of(reqs))
    n_steps = len(eng.timings["prefill_s"]) + len(eng.timings["decode_s"])
    want_counts = {"ssd_chunk": n_groups * cfg.n_layers, "rf_predict": 1,
                   "silu": n_steps * cfg.n_layers,
                   "silu_gate": n_steps * cfg.n_layers}
    if serve_counts != want_counts:
        raise AssertionError(f"serve launches {serve_counts}, expected "
                             f"{want_counts}: one ssd_chunk per layer per "
                             f"prefill, one silu and one silu_gate per "
                             f"layer per step ({n_steps} steps), 1 "
                             f"rf_predict")
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

    # the migrate phase's plans, made here since the quantize phase
    # times the parts they cut: (a) from Engine.replan() with a 4-pod
    # controller, (b) fixed
    eng.controller = WanifyController(
        WanSimulator(seed=0), BwPredictor(paper, device=dev), n_pods=N_PODS)
    runs = [("a", eng.replan(), True), ("b", fixed_plan(), True),
            ("b_raw", fixed_plan(), False)]
    scheds = {name: offset_schedule(plan) for name, plan, _ in runs}
    wcfg = cfg.replace(n_layers=WANSYNC_LAYERS)
    sync_lengths = wansync_lengths(grad_shapes(wcfg), runs[1][1])

    # 9. quantize: both kernels against their plain versions, bit-equal
    t0 = time.perf_counter()
    q_cases, q_err = check_quantize(cfg, SERVE_BATCH, dev,
                                    sync_lengths=sync_lengths)
    log(f"[quantize] {len(q_cases)} cases bit-equal to plain (payload, "
        f"scales, f32 and bf16 dequantized; grouped: also the accumulating "
        f"dequantize): tiles "
        f"{[list(t) for t in QUANT_TILES]} f32/bf16 x 8/4 bits; groups "
        f"G=1,4 at L={list(QUANT_LENGTHS)}, at the migrate parts "
        f"{[(n, k, str(d)) for n, k, d in migrate_parts(cfg, SERVE_BATCH)]}"
        f" and at the wansync parts G={N_PODS}, L={sync_lengths} "
        f"({time.perf_counter() - t0:.1f} s)")
    gen = torch.Generator(device=dev).manual_seed(1)
    q_timing = {"tiles_4096": time_quant(
        torch.randn((4096, 4096), generator=gen, device=dev), False)}
    for c in sorted({ph["chunks"] for sched in scheds.values()
                     for ph in sched if ph["bits"] <= 8}):
        for name, n, dt in migrate_parts(cfg, SERVE_BATCH, c):
            q_timing[f"part_{name}_c{c}"] = time_quant(
                torch.randn((1, n), generator=gen, device=dev).to(dt), True)
    # the wansync phase's largest part: [P, L] f32, pod r's row scaled
    # by r + 1
    part = torch.randn((N_PODS, max(sync_lengths)), generator=gen,
                       device=dev) * torch.arange(
        1, N_PODS + 1, dtype=torch.float32, device=dev)[:, None]
    q_timing["sync_part"] = time_quant(part, True)
    q_timing["sync_part"]["dequantize_add"] = time_decode_add(part)
    del part
    for key, t in q_timing.items():
        for kname in ("quantize", "dequantize", "dequantize_add"):
            if kname not in t:
                continue
            k = t[kname]
            log(f"[quantize] {key}: {kname} {t['form']} {t['shape']} "
                f"{t['dtype']} "
                f"{t['bits']} bits: kernel {k['ms']:.5f} ms (device, graph "
                f"of 20 calls) | plain {k['plain_ms']:.5f} ms | bound "
                f"{k['bound_ms']:.5f} ms by {k['bound_by']} ({k['bytes']} B)"
                f" | library call: none (no PyTorch call computes a "
                f"symmetric abs-max quantization with these semantics)")
    results["quantize"] = {"cases": q_cases, "max_abs_err": q_err,
                           "timing": q_timing}

    # 10. migrate: the engine's cache from pod 0 to 4 ranks on the card
    log(f"[migrate] plan (a), Engine.replan() with a 4-pod controller: "
        f"{scheds['a']}; plan (b), fixed: {scheds['b']}")
    t0 = time.perf_counter()
    mig = run_migrate(eng, eng.batch_tokens(groups_of(reqs)[0]), runs, dev)
    mig["s"] = time.perf_counter() - t0
    mig["schedules"] = scheds
    mig["codec_ms"] = {name: phase_codec_ms(cfg, SERVE_BATCH, scheds[name],
                                            compress, q_timing)
                       for name, _, compress in runs}
    mig_launches = {k: sum(p["b"]["counts"][k] for p in mig["per_pod"])
                    for k in ("quantize", "dequantize")}
    log(f"[migrate] cache {mig['cache_bytes']} B ({cfg.n_layers} layers, "
        f"B={SERVE_BATCH}) from pod 0 to {N_PODS} ranks on one card over "
        f"gloo; every receiving pod bit-equal to the plain codec's round "
        f"trip on the host, launches equal to the schedule's; pods "
        f"{mig['pods_s']:.1f} s in all")
    for name, _, compress in runs:
        log(f"[migrate] run {name}, per phase: bytes on the wire per pod "
            f"(from the schedule and the leaves) and device ms of the "
            f"codec's launches (parts x the quantize phase's time at the "
            f"part): " + "; ".join(
                f"o={ph['offset']} {ph['chunks']}x"
                f"{ph['bits'] if compress else 32}b {wire} B, encode "
                f"{cm['quantize']:.3f} ms, decode {cm['dequantize']:.3f} ms"
                for ph, wire, cm in zip(scheds[name], mig["wire_bytes"][name],
                                        mig["codec_ms"][name])))
        for r, pod in enumerate(mig["per_pod"]):
            run = pod[name]
            log(f"[migrate] run {name} pod {r}: {run['wall_s'] * 1e3:.1f} "
                f"ms, launches {run['counts']} (schedule: "
                f"{run['expected']}), host check "
                f"{run['host_check_s']:.1f} s; wall ms per phase (host): " +
                ", ".join(f"o={ph['offset']} {ms:.1f}" for ph, ms in
                          zip(scheds[name], run["phase_wall_ms"])))
    for name, c in mig["continue"].items():
        log(f"[migrate] decode {MIGRATE_STEPS} steps from pod 1's cache "
            f"({name}): {c['ids_equal']} of {c['ids']} ids equal to the "
            f"engine's own continuation, max |logit diff| "
            f"{c['max_abs_logit_diff']:.4g} (max |logit| "
            f"{c['max_abs_logit']:.4g})")
    results["migrate"] = mig

    # 11. wansync: the engine freed, a gradient tree of the model's
    # parameter shapes (layers stacked), 4 pods on the card
    del eng, model, card_model, captured, caps, decode_cap
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    grads = make_grads(grad_shapes(wcfg), dev)
    sync(dev)
    n_values = sum(g[0].numel() for g in grads.values())
    ws = run_wansync(grads, runs[1][1], dev)
    del grads
    ws.update({"layers": WANSYNC_LAYERS, "values_per_pod": n_values,
               "s": time.perf_counter() - t0})
    log(f"[wansync] {wcfg.n_layers} of {cfg.n_layers} layers, {n_values} "
        f"values per pod x {N_PODS} pods f32, plan (b): psum "
        f"{ws['psum_ms']} ms, uncompressed {ws['raw_ms']} ms (error "
        f"{ws['raw_err']:.3g} of rtol 1e-5), compressed "
        f"{ws['compressed_ms']} ms (error {ws['compressed_err']:.3g} of "
        f"the quantization bound), launches {ws['launches']}; peak device "
        f"memory {ws['peak_bytes'] / 2**30:.3f} GiB")
    log(f"[wansync] profiled leaf {ws['profiled_leaf']['path']} "
        f"{ws['profiled_leaf']['shape']}, compressed: " + ", ".join(
            f"{k} {v}" for k, v in ws["profiled_leaf"].items()
            if k not in ("path", "shape")) + " (the parts read in place)")
    results["wansync"] = ws

    t = timing[f"n{TICK_ROWS}"]
    s0 = ssd_timing[0]
    wf = scen["waterfill"]["timing"][0]          # one 8-DC fill
    qs = q_timing["part_state_c8"]
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
        "library_ms": None}] + [{
        "name": kname, "route": "cuda",
        "source": "src/repro_torch/csrc/quantize.cu",
        "replaces": f"src/repro/kernels/quantize.py:{line}",
        "launches": mig_launches[kname], "max_abs_err": q_err,
        "ms": qs[kname]["ms"], "plain_ms": qs[kname]["plain_ms"],
        "bound_ms": qs[kname]["bound_ms"],
        "bound_by": qs[kname]["bound_by"], "library_ms": None}
        for kname, line in (("quantize", 37), ("dequantize", 61))] + [{
        "name": kname, "route": "cuda",
        "source": "src/repro_torch/csrc/silu.cu",
        "replaces": f"src/repro/models/ssm.py:{line}",
        "launches": serve_counts[kname], "max_abs_err": silu_err,
        "ms": silu_timing[f"{kname}_prefill1"]["ms"],
        "plain_ms": silu_timing[f"{kname}_prefill1"]["plain_ms"],
        "bound_ms": silu_timing[f"{kname}_prefill1"]["bound_ms"],
        "bound_by": silu_timing[f"{kname}_prefill1"]["bound_by"],
        "library_ms": None}
        for kname, line in (("silu", 137), ("silu_gate", 152))] + [{
        "name": "waterfill", "route": "cuda",
        "source": "src/repro_torch/csrc/waterfill.cu",
        "replaces": "src/repro/kernels/waterfill.py:56",
        "launches": scen["device_fill"]["launches"],
        "max_abs_err": max(scen["waterfill"]["max_abs_err"],
                           scen["device_fill"]["max_abs_err"]),
        "ms": wf["ms"], "plain_ms": wf["plain_ms"],
        "bound_ms": wf["bound_ms"], "bound_by": wf["bound_by"],
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
