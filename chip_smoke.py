#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`src/repro_torch`) on one
NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

Every phase is fatal: a failure exits non-zero before the result line.

1. device  — `nvidia-smi` name and power limit, torch and CUDA versions
   (exits non-zero when `torch.cuda.is_available()` is false);
2. build   — compiles the kernel sources `src/repro_torch/csrc/rf_predict.cu`,
   `ssd_chunk.cu`, `quantize.cu`, `silu.cu`, `waterfill.cu` and `moe.cu` with
   `nvcc`, one process each, started together,
   and prints ptxas's reports (registers, static shared memory, spills),
   per ssd_chunk kernel (the forward's three, the f32 backward's four
   and the bf16 backward's three) its registers, spills and the dynamic
   shared memory of a block at the serve shape, failing if a backward
   kernel spills, and the counts of tensor-core
   (HGMMA) and asynchronous-copy (LDGSTS, UTMALDG, UBLKCP) instructions
   in ssd_chunk's SASS (`cuobjdump -sass`) and in each bf16 backward
   wgmma kernel's own; the same for quantize's
   grouped (persistent) and tile (cluster) kernels; fails if there is no
   HGMMA in ssd_chunk's SASS or in a bf16 backward wgmma kernel's, no
   bulk copy (UBLKCP) in quantize's, or a
   spill in a quantize kernel; and rf_predict's two kernels', silu's
   four kernels' (silu, SiLU's gradient, the gate, and the gate's
   gradient, which is also the SSM gate's; for the first two also the
   SASS instructions an element of the bf16 16-byte walk) and
   waterfill's two kernels' (the warp kernel, a warp
   a fill for N <= 8, and the block kernel) registers and spills,
   failing on a spill, and the block barriers (BAR) in each waterfill
   kernel's SASS, failing if the warp kernel has any or the block
   kernel none; `flash_attn.cu` builds beside them, and its seven
   kernels' registers, spills and SASS counts (and those of the
   forward's MLA instance, which splits MLA's f32 keys as it loads
   them) are printed, failing if a bf16
   kernel (forward, dq, dk / dv) holds no wgmma (HGMMA) or no TMA load
   (UTMALDG), or if any bf16 instance spills; and moe's six kernels'
   (slots, dispatch, combine and the three backwards) registers and
   spills, failing on a spill;
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
   (64, 16), (1, 32), (2, 8), (32, 8), (5, 8), (3, 9): rates within
   1e-9, equal iterations; times of the kernel (device, a graph of 20
   calls) and its microseconds an iteration (of the longest fill, above
   the launch floor), of the numpy call (one C call: staging, copies,
   launch, synchronise; host), of the host loop (host) and of the plain
   version, beside the bound (bytes; f64 operations at the CUDA cores'
   rate) and the launch floor;
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
12. dense  — the dense attention family, after the mamba engine and the
   gradient tree are freed:
   (1) the slice's main path: `llama3-8b` at its full width and depth
   (32 layers, d 4096, 32 query / 8 KV heads, d_ff 14336, vocab
   128,256; bf16 compute, f32 params, weights from a `torch.Generator`
   seeded 0) behind `Engine(..., ServeConfig(batch=4, s_max=1024))`
   with a `WanifyController` on the paper forest: `replan()` and its
   schedule, then the serve phase's 8 requests (two prefills, 32
   decode steps). Counts zeroed just before and read just after:
   exactly 2 x 32 + 32 x 32 = 1,088 `silu_gate` launches (the SwiGLU
   gate, one a layer a step), 2 x 32 = 64 `flash_fwd` (one a layer a
   prefill, none in decode), 0 `flash_bwd`, 1 `rf_predict`, 0
   `ssd_chunk`, 0 `silu`;
   every id in [0, vocab), every logit finite; prefill ms per group,
   decode ms per step, tokens/s, peak memory; group 1's prefill and 4
   decode steps again under `torch.profiler` (CPU and CUDA activity,
   the attention core in a `record_function` range) for the device
   time by kind (matrix products, of which inside the attention core;
   the attention core's plain ops; `silu_gate`; the rest), kernels a
   decode step and the busy share; the silu_gate kernel (value only:
   the MLP reads no f32 product) against its plain version on layer
   0's MLP inputs of both prefills and a decode step, bit-equal, timed
   beside its bound (6 bytes an element in bf16); the `flash_fwd`
   kernel against `flash_fwd_ref` on layer 0's inputs of both prefills
   (bf16 rows within 2^-7 of their max |out|, lse within 1e-5; the share
   of elements more than one bf16 ulp apart printed), timed at group 1's
   beside its plain version, SDPA and the bound (k and v at the 8 KV
   heads);
   (2) parity: `llama3-8b`, `qwen3-4b` and `h2o-danube-1.8b` at full
   width, 2 layers, f32, on the card and on the host with the same
   weights: prefill (group 1's prompts, drawn from each arch's
   vocabulary) and 4 decode steps within atol/rtol 1e-3, equal ids
   wherever the top-2 gap exceeds that; the card's first `flash_fwd`
   call (f32) against its plain version within 1e-5 of max |out|;
   (3) the port's attention core at group 1's prefill shape
   (`flash_attention`, B=4, 32 heads expanded from 8, S = the longest
   prompt, D=128, bf16) and at a decode step's (`decode_attention` over
   the 1,024-slot cache) beside `F.scaled_dot_product_attention` on the
   same inputs (causal / the validity mask, heads expanded): device ms
   of each, the largest difference (each output row within 2^-5 of
   its max |out|), the bound (bytes, k and v at their 8 KV heads; the
   products at the bf16 tensor-core rate).
12b. hybrid — the hybrid family, after the dense phase's models are
   freed: (1) the slice's main path: `zamba2-2.7b` at its full width
   and depth (54 Mamba-2 layers, d 2560, 80 SSM heads of P = N = 64,
   chunk 256; one shared attention + MLP block, 32 heads over 32 KV
   heads of D = 80, d_ff 10,240, run before layers 0, 6, ..., 48; vocab
   32,000; bf16 compute, f32 params, weights from a `torch.Generator`
   seeded 0) behind `Engine(..., ServeConfig(batch=4, s_max=1024))`
   with a `WanifyController` on the paper forest, after a warm-up that
   captures the kernels' first inputs: `replan()` and its schedule,
   then the serve phase's 8 requests (two prefills, 32 decode steps).
   Counts zeroed just before and read just after: exactly 2 x 54 = 108
   `ssd_chunk`, 2 x 9 = 18 `flash_fwd`, 34 x 54 = 1,836 `silu`, 34 x
   (54 + 9) = 2,142 `silu_gate` (the gated norm a layer, the shared
   MLP's gate an application), 1 `rf_predict`, no backward kernel;
   every id in [0, vocab), every logit finite; prefill ms per group,
   decode ms median and p90, tokens/s, peak memory; group 1's prefill
   and one decode step under `torch.profiler` for the device ms by kind
   (`ssd_chunk`, the flash kernels, `silu_gate`, `silu`, the products,
   the rest), the kernels and the busy share;
   (2) the kernels on the captured inputs: `ssd_chunk` at layer 0 of
   both prefills (N = 64, which the bf16 kernel pads to 128) within
   1e-4 of its plain version, timed beside its bound and the serve
   phase's N = 128 time; `flash_fwd` at the first shared application of
   both prefills ([4, 32, 1, S, 80] bf16) within 2^-7 of each row's
   max, timed beside its plain version, SDPA and the bound; each called
   twice, equal bit for bit; `silu`, the gated norm's `silu_gate` and
   the shared MLP's value-only `silu_gate` bit-equal to their plain
   versions at both prefills and a decode step, timed at group 1's;
   (3) parity: `zamba2-2.7b` at full width cut to 7 layers (the shared
   block before layers 0 and 6), f32, on the card and on the host with
   the same weights: prefill (group 1's prompts) and 4 decode steps
   within atol / rtol 1e-3, equal ids wherever the top-2 gap exceeds
   that; the card's first `flash_fwd` call (f32) against its plain
   version within 1e-5 of max |out|. Prints the phase's seconds.
12c. moe — the MoE family, after the hybrid phase's models are freed:
   (1) the slice's main path: `granite-moe-1b-a400m` at its full width
   and depth (24 layers, d 1024, 16 heads over 8 KV heads of D = 64; 32
   experts, top-8, expert d_ff 512, capacity factor 1.25; vocab 49,155;
   1,384,963,072 parameters; bf16 compute, f32 params, weights from a
   `torch.Generator` seeded 0; TF32 off, asserted) served as 12b serves
   the hybrid. Counts zeroed just before and read just after: exactly
   34 x 24 = 816 `moe_slots`, `moe_dispatch`, `moe_combine` and
   `silu_gate` (the experts' gate), 2 x 24 = 48 `flash_fwd`, 1
   `rf_predict`, no other kernel (no backward: the `_ad` ops call the
   forward wrappers under `inference_mode`); ids and logits checked as
   12b's;
   prefill ms per group, decode ms median and p90, tokens/s, peak
   memory; group 1's prefill and one decode step under
   `torch.profiler`, the MoE layer's steps in ranges, for the device ms
   by kind (router product, softmax and top-k, slots, dispatch, the
   three expert products, the gate, the combine, flash and the
   attention core's plain ops, the other products, the rest) and the
   busy share, failing if a cumulative-sum kernel runs (the eager
   positions' count has left the path) or no `moe_slots_kernel`; the
   kernels of one decode step beside those of the same step with the three kernels'
   plain versions in their place;
   (2) `moe_slots` integer-equal, `moe_dispatch` and `moe_combine`
   bit-equal to their plain versions (and two calls equal) on layer
   0's inputs of both prefills and a decode step, the last two in bf16
   and in f32, at half group 1's capacity (choices dropped; C = 402),
   at T = 2,563 (odd: 20,504 choices, no multiple of 32) and with a row
   of -0.0 (the slots kernel's edges are the card tests'); the combine
   also at its persistent grid's edges (`combine_edges`: one token, one
   more than its groups hold, k = 32, d = 2,048, ob one element past
   16-byte alignment); the
   dispatch's plain gather against the reference's k scatter-adds at
   group 1; each timed at group 1's
   prefill and a decode step (a CUDA graph of 20 calls) beside its
   plain version, the bound (bytes), the launch floor and, for the
   dispatch, an `index_select` by the same src that computes the same
   buffer, for the combine an `embedding_bag` (sum, the gates as
   per-sample weights) that computes it up to rounding, each in turns
   with the kernel; the experts' `silu_gate` bit-equal
   at both prefills and a decode step, timed; `flash_fwd` at head dim
   64 ([4, 16, 1, S, 64] bf16) at both prefills within 2^-7 of each
   row's max, twice equal, timed beside SDPA and the bound;
   (3) parity: the model at full width cut to 2 layers, f32, on the
   card and on the host with the same weights, as 12b's (3); the card's
   first `flash_fwd` (f32) within its tolerance and first `moe_slots`,
   `moe_dispatch` / `moe_combine` calls (f32) equal to their plain
   versions. Prints the phase's seconds.
12d. mla — the MLA family, after the moe phase's models are freed:
   (1) the slice's main path: `minicpm3-4b` at its full width and depth
   (62 layers, d 2560, 40 heads; MLA with kv_lora 256, q_lora 768, q / k
   head dim 64 + 32 = 96, v head dim 64; d_ff 6400; vocab 73,448;
   4,261,902,848 parameters; bf16 compute, f32 params, weights from a
   `torch.Generator` seeded 0) served as 12b serves the hybrid. Counts
   zeroed just before and read just after: exactly 2 x 62 = 124
   `flash_fwd` (one a layer a prefill; the absorbed decode step is plain
   torch over the latent cache), 34 x 62 = 2,108 `silu_gate`, 1
   `rf_predict`, no backward, `ssd_chunk` or `silu`; ids and logits
   checked as 12b's; prefill ms per group, decode ms median and p90,
   tokens/s, peak memory; group 1's prefill and 4 decode steps under
   `torch.profiler` (the decode's attention core,
   `mla_decode_attention`, in ranges) for the device ms by kind (the
   flash kernels, matrix products, the decode attention's plain ops,
   `silu_gate`, the rest) and the busy share; group 1's prefill again
   with `mla_forward` in ranges: its own body launches no concatenation
   (`aten::cat`) and no cast beyond its two (c_kv to bf16 for v, W_uk
   to f32 for k_nope), one flash kernel a layer, no split kernel; the
   prefill's concatenation kernels counted;
   (2) `flash_fwd_mla` (MLA's parts: q_nope [4, 40, S, 64] a strided
   view of the projection and q_rope [4, 40, S, 32] bf16, k_nope f32,
   the rope key [4, 1, S, 32] bf16, v [4, 40, S, 64] bf16) on layer 0's
   parts of both prefills within 2^-7 of each row's max of
   `flash_fwd_mla_ref` (the reference's concatenations), and lse within
   each row's bound (`flash_lse_tol`: 1e-5 plus what the key split can
   drop, sc * 2^-17 * max_j sum_d |q_d k_jd|), twice equal; timed at
   group 1's beside its plain version, the bound (bytes: the parts,
   k_nope at 4 bytes, the one rope key, v, out, lse; the products QK^T
   at Dq and PV at Dv, the split's second QK^T over the nope columns
   printed apart as the kernel's own) and SDPA on the concatenated q,
   bf16(k) and v, made outside the timing, in turns (its backend named
   by its kernel); the MLA
   instance's registers and spills (fatal on a spill); the SwiGLU gate
   bit-equal at both prefills and a decode step;
   (3) parity: the model at full width cut to 2 layers, f32 (the f32
   kernel at Dq 96, Dv 64), on the card and on the host with the same
   weights, as 12's (2). Prints the phase's seconds.
13. train  — the dense family's training, after the dense phase's models
   are freed, then the ssm family's (part (5)), the hybrid's (part (6))
   and the MoE's (part (7)):
   (1) the slice's main path: `h2o-danube-1.8b` at its full width and
   depth (24 layers, d 2560, 32 query / 8 KV heads, d_ff 6912, vocab
   32,000; bf16 compute, f32 parameters and AdamW state, weights from a
   `torch.Generator` seeded 0) trained by `Trainer` on one pod,
   `DataConfig(batch=4, seq=1024)`, `sync="psum"`, remat "full", 6
   steps (the reference training CLI's AdamW: lr 3e-4). Counts
   zeroed just before the run and read just after: exactly 2 x 24 x 6
   `silu_gate` and `flash_fwd` launches (forward and recompute) and
   24 x 6 `silu_gate_bwd` and `flash_bwd`, no other kernel; every loss
   finite and the last below the first; step wall ms (median and p90 after the first),
   tokens/s, peak memory; one more step under `torch.profiler` for the
   device ms by kind (the attention core's forward and backward,
   cross-entropy, the optimizer, `silu_gate`, `silu_gate_bwd`, the
   other products, the rest) and the busy share;
   (2) the `silu_gate` kernel (value only) and the `silu_gate_bwd`
   kernel against their plain versions on the inputs of layer 0's
   forward and backward in one more step ([4, 1024, 6912] bf16),
   bit-equal; the backward timed beside the bound (bytes: g, y, z in,
   dy, dz out, 10 B an element in bf16); `flash_fwd` and `flash_bwd`
   against their plain versions on layer 0's inputs of that step
   ([4,32,1,1024,80] bf16, window 4,096; rows within 2^-7), timed beside
   the plain versions, SDPA (its forward; `torch.autograd.grad` through
   it) and the bounds (the backward's five products; q, k, v, out, g,
   lse in, dq, dk, dv out; k, v, dk, dv at the 8 KV heads); each of the
   two called twice on those inputs, every output equal bit for bit;
   (3) card against host: `llama3-8b`, `qwen3-4b` and `h2o-danube-1.8b`
   at full width, 2 layers, f32 (TF32 off), one `make_train_step` step
   on the card and on the host from the same weights and batch (B=1;
   S=1,024 for `h2o-danube-1.8b`, 2 key blocks of flash forward and
   VJP; 64 for the others): the loss within 1e-5 relative, every
   gradient leaf within
   1e-3 of its max |g|, the parameters after AdamW within 1e-6 relative
   plus 1e-3 of the step's lr wherever |g| is above 1e-2 of the leaf's
   max; the card's first `flash_fwd` / `flash_bwd` calls (f32) against
   their plain versions within 1e-5 of max |value|;
   (4) the 4-pod WANify Trainer: `h2o-danube-1.8b` at full width cut to
   4 of 24 layers (4 pods' f32 state at 16 B a parameter), 4 pods on
   the card, `DataConfig(batch=8, seq=1024, n_pods=4, skew=0.5)`,
   `sync="wanify"`, `compress=True`, a replan every 2 steps fed the
   skew weights, checkpoints every 3 steps (a temporary directory), a
   simulated failure at step 4, 8 steps, the reference training CLI's
   forest (`train_default_forest(n_samples=150, n_trees=40)`,
   `WanSimulator(seed=0)`) on the card. Counts zeroed before the
   Trainer is built and read after: `rf_predict` launches equal to the
   controller's predictions (its first plan and every replan),
   `quantize` / `dequantize` launches to the schedule's parts of every
   step's sync under the plan in force, the gates' and flash's to 4
   pods x the steps run; at least one replan; the failure restored from step 3.
   The grouped quantize and the accumulating dequantize bit-equal to
   their plain versions at the first call of each part layout of the
   sync; the first step's compressed sync redone on the host (the plain
   codec) bit-equal on every leaf of at most 32 Mi elements a pod;
   `rf_predict` bit-equal to its plain version on every feature matrix
   the controller predicted from. Prints the sync's ms a step (median
   over the calls with no codec check) and its wire bytes a pod per
   phase;
   (5) after part (4)'s models are freed, the ssm family's main path:
   `mamba2-2.7b` at its full width and depth (64 layers, d 2560, 80
   SSM heads, d_state 128, vocab 50,280; bf16 compute, f32 parameters
   and AdamW state, weights from a `torch.Generator` seeded 0) trained
   as (1) trains danube (`DataConfig(batch=4, seq=1024)`, psum, remat
   "full", 6 steps, lr 3e-4). Counts zeroed just before the run and
   read just after: exactly 2 x 64 x 6 = 768 `ssd_chunk`, `silu` and
   `silu_gate` launches (forward and recompute) and 64 x 6 = 384
   `ssd_chunk_bwd`, `silu_bwd` and `silu_gate_prod_bwd`, no other
   kernel; every loss finite and the last below the first; step wall
   ms (median, p90), tokens/s, peak memory; one more step under
   `torch.profiler` for the device ms by kind (`ssd_chunk` and
   `ssd_chunk_bwd`, the gates and their backwards, cross-entropy, the
   optimizer, the other products, the rest) and the busy share. Then
   the three backward kernels on layer 0's inputs of one more step
   (its forwards' first calls, its backwards' last): `ssd_chunk_bwd`
   within 1e-4 of each output's max |g| of its plain version (bf16
   outputs also one bf16 step), the SiLU backwards bit-equal, each
   called twice and equal bit for bit, timed beside its bound and its
   plain version (`ssd_chunk_bwd` also by kernel in the profiled step,
   with the scratch bytes it allocates); and one `make_train_step`
   step of `mamba2-2.7b` at full width, 2 layers, f32, B=1, S=512 (2
   chunks) on the card and on the host within part (3)'s bounds, the
   card's first `ssd_chunk_bwd` call (f32) held to its plain version;
   (6) after part (5)'s models are freed, the hybrid's main path:
   `zamba2-2.7b` at its full width and depth (12b's model; f32
   parameters and AdamW state) trained as (5) trains mamba. Counts
   zeroed just before the run and read just after: exactly 2 x 54 x 6
   = 648 `ssd_chunk` and `silu`, 6 x 2 x (54 + 9) = 756 `silu_gate` (the
   gated norm a layer, the shared MLP's gate an application), 2 x 9 x 6
   = 108 `flash_fwd`, 54 x 6 = 324 `ssd_chunk_bwd`, `silu_bwd` and
   `silu_gate_prod_bwd`, 9 x 6 = 54 `silu_gate_bwd` and `flash_bwd`:
   under remat "full" each layer's region holds its shared application,
   recomputed with it; every loss finite and the last below the first;
   step wall ms, tokens/s, peak memory; one more step under
   `torch.profiler`, by kind as (5) with the shared block's attention
   and MLP as kinds of their own (their ops in ranges, forward and
   recompute, and the backward nodes of those ops, less the flash and
   gate kernels, which keep their kinds). Then on one more step's
   inputs: `ssd_chunk_bwd` at layer 0 ([4,4,256,80,64], N = 64) within
   1e-4 of its plain version, timed beside its bound and (5)'s N = 128
   time; `silu_bwd`, `silu_gate_prod_bwd` and the shared MLP's
   `silu_gate_bwd` (first application, [4,1024,10240]) bit-equal;
   `flash_fwd` / `flash_bwd` at the first application ([4,32,1,1024,80])
   within their tolerances; each called twice, equal bit for bit, timed
   beside its bound and plain version; one `make_train_step` step of
   `zamba2-2.7b` cut to 7 layers (the block twice), f32, B=1, S=512, on
   the card and on the host within (3)'s bounds over every leaf, the
   shared block's included, the card's first `flash_fwd`, `flash_bwd`
   and `ssd_chunk_bwd` calls (f32) held to their plain versions; and
   (4)'s 4-pod WANify run on `zamba2-2.7b` cut to 7 layers, its checks
   as (4)'s, the host's redo of the first sync covering every shared
   leaf;
   (7) after part (6)'s models are freed, the MoE's main path:
   `granite-moe-1b-a400m` at its full width and depth (12c's model; f32
   parameters and AdamW state) trained as (5) trains mamba. Counts
   zeroed just before the run and read just after: exactly 2 x 24 x 6 =
   288 `moe_slots`, `moe_dispatch`, `moe_combine`, `silu_gate` and
   `flash_fwd` (forward and recompute) and 24 x 6 = 144
   `moe_dispatch_bwd`, `moe_combine_bwd`, `moe_gates_bwd`,
   `silu_gate_bwd` and `flash_bwd`; every loss finite and the last below
   the first; every step's expert_load, summed over the layers, within
   1e-6 of the layers' count; one more step under `torch.profiler`, by
   kind as (5) with the routing's ops and the expert products as kinds
   of their own and the MoE kernels forward and backward by name. Then
   on one more step's layer 0 inputs (T = 4,096, k = 8, E = 32, C =
   1,284, d = 1,024): the three forward kernels equal to their plain
   versions and timed (`moe_combine` beside `embedding_bag`); the three
   backward kernels bit-equal to their plain versions as captured
   (bf16), in f32, at half the capacity (drops), at T = 4,095, with
   rows of -0.0 and at the persistent grids' edges (one token, one
   token past what gates_bwd's warps hold, k = 32, d = 2,048, storage
   one element past alignment), two calls equal, each timed beside its
   bound, its
   plain version and `embedding_bag` where it computes the same
   function (not for the gates' backward); one `make_train_step` step
   cut to 2 layers, f32, B=1, S=512, on the card and on the host within
   (3)'s bounds, the card's first `flash_fwd`, `flash_bwd` and three
   MoE backward calls (f32) held to their plain versions; and (4)'s
   4-pod WANify run cut to 8 of 24 layers (four pods' f32 state at 16 B
   a parameter: ~34 GB), its checks as (4)'s;
   (8) after part (7)'s models are freed, MLA's (`minicpm3-4b`, full
   width: 40 heads, Dq 64 + 32, Dv 64, f32 keys) through `train_single`
   at MLA_TRAIN_LAYERS (56 of 62, what the card holds after parts
   (1)-(7), PERF.md section 4): B=4, S=1,024, bf16 compute, f32 parameters and AdamW, 6 steps,
   its exact counts (flash's MLA forward twice a layer a step, its
   backward `flash_bwd_mla` once, the gate's as (1)'s), no operand of
   flash copied; step ms, tokens/s, peak memory and device ms by kind
   (each flash kernel by name); on layer 0's inputs of one more step
   `flash_bwd_mla` against its plain version (`check_flash_bwd_mla`:
   dq, dv under the flash rule, the whole f32 dk within 1e-5 (f32) or
   1e-4 (bf16 runs) of its max, dk_rope the heads' sum of the kernels'
   own dk bit for bit, two calls equal) as captured, at S = 1,000 and
   both in f32, timed beside its bound, its plain version and
   `torch.autograd.grad` through SDPA on the concatenated q and bf16(k);
   one `make_train_step` step cut to 2 layers, f32, on the card and on
   the host within (3)'s bounds, the card's first `flash_fwd_mla` /
   `flash_bwd_mla` calls held to their plain versions; and (4)'s 4-pod
   WANify run cut to 2 of 62 layers, its checks as (4)'s.

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
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import compat  # noqa: E402
from repro_torch.compat import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.control import WanifyController  # noqa: E402
from repro_torch.control.schedule import (offset_schedule,  # noqa: E402
                                          wire_decode, wire_encode)
from repro_torch.core.plan import WanPlan  # noqa: E402
from repro_torch.core.predictor import (BwPredictor,  # noqa: E402
                                        SnapshotPredictor,
                                        assemble_features)
from repro_torch.data.pipeline import DataConfig, batches  # noqa: E402
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
from repro_torch.kernels import moe as moe_kernels  # noqa: E402
from repro_torch.kernels import rf_predict as rf_kernel  # noqa: E402
from repro_torch.kernels import waterfill as wfk  # noqa: E402
from repro_torch.kernels.quantize import qmax  # noqa: E402
from repro_torch.lifecycle import harness as lc_harness  # noqa: E402
from repro_torch.lifecycle import run_lifecycle_comparison  # noqa: E402
from repro_torch.kernels.ref import (dequantize_groups_add_ref,  # noqa: E402
                                     dequantize_groups_ref,
                                     dequantize_ref, fill_rates_ref,
                                     flash_bwd_mla_ref, flash_bwd_ref,
                                     flash_fwd_mla_ref, flash_fwd_ref,
                                     moe_combine_bwd_ref,
                                     moe_combine_ref,
                                     moe_dispatch_bwd_ref,
                                     moe_dispatch_gather_ref,
                                     moe_dispatch_ref, moe_gates_bwd_ref,
                                     moe_slots_ref,
                                     quantize_groups_ref,
                                     quantize_ref, rf_predict_ref,
                                     rope_head_sum, silu_bwd_ref, silu_gate_bwd_ref,
                                     silu_gate_prod_bwd_ref, silu_gate_ref,
                                     silu_ref, ssd_chunk_bwd_ref,
                                     ssd_chunk_ref)
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import registry, ssm  # noqa: E402
from repro_torch.models import transformer as lm_mod  # noqa: E402
from repro_torch.models.transformer import (DenseLM, HybridLM,  # noqa: E402
                                            MambaLM, MoeLM, param_tree,
                                            stack_cache, stack_layers,
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
from repro_torch.train import train_step as train_step_mod  # noqa: E402
from repro_torch.train.loop import LoopConfig, Trainer  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.train_step import (as_batch,  # noqa: E402
                                          make_train_step)
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
# a 64-fill batch of it, the widest mesh the kernel takes, the fused
# tick's and the sweep's batches, a batch that is not a whole number of
# the warp kernel's fills a block, and the block kernel's smallest mesh
WF_SHAPES = ((1, 8), (16, 8), (1, 16), (64, 16), (1, 32), (2, 8), (32, 8),
             (5, 8), (3, 9))
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


SASS_OPS = ("HGMMA", "HMMA", "LDGSTS", "UTMALDG", "UBLKCP")
# quantize.cu's kernels of this design: the grouped form's persistent
# kernel and the tile form's cluster kernel
QUANT_KERNELS = ("quantize_groups_kernel", "quantize_tile_cluster_kernel")
RF_KERNELS = ("rf_tile_kernel", "rf_pair_kernel")
SILU_KERNELS = ("silu_kernel", "silu_bwd_kernel", "silu_gate_kernel",
                "silu_gate_bwd_kernel")
# the bf16 walk of silu.cu's two streaming kernels: each lane takes
# SILU_SLOTS 16-byte slots of 8 elements a chunk (`kSlots`)
SILU_STREAM_KERNELS = ("silu_kernel", "silu_bwd_kernel")
SILU_SLOTS = 2
WF_KERNELS = ("waterfill_warp_kernel", "waterfill_block_kernel")
# bf16: wgmma (HGMMA) fed by TMA (UTMALDG) in SASS, no spill (the last
# two: MLA's backward from its parts)
FLASH_TC_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                    "flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_mla_kernel",
                    "flash_bwd_dkdv_mla_kernel")
FLASH_KERNELS = FLASH_TC_KERNELS + (
    "flash_delta_kernel", "flash_fwd_f32_kernel", "flash_bwd_dq_f32_kernel",
    "flash_bwd_dkdv_f32_kernel", "flash_rope_sum_kernel")
# the forward's MLA instance (flash_fwd_wgmma_kernel<1, 32, 1, 0, true>),
# by its mangled template arguments
FLASH_MLA_INSTANCE = "flash_fwd_wgmma_kernelILi1ELi32ELi1ELi0ELb1E"
SWEEP_ROWS = 16 * TICK_ROWS    # a 16-variant sweep (benchmarks/tick_bench.py)


def sass_counts(lib: Path) -> dict:
    """How many tensor-core (HGMMA) and asynchronous-copy (LDGSTS:
    cp.async; UTMALDG: TMA; UBLKCP: bulk copy) instructions the
    library's SASS holds."""
    sass = subprocess.run([cuobjdump_path(), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}


def sass_counts_by_kernel(lib: Path, kernels, sass_ops=SASS_OPS) -> dict:
    """{kernel: {op: count}} of `sass_ops` in each function of the
    library whose mangled name holds one of `kernels` (instances summed:
    every template instance of a kernel)."""
    sass = subprocess.run([cuobjdump_path(), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    out = {k: dict.fromkeys(sass_ops, 0) for k in kernels}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = next((k for k in kernels if k in m.group(1)), None)
            continue
        if cur is not None:
            for op in sass_ops:
                out[cur][op] += len(re.findall(rf"\b{op}\b", line))
    return out


def sass_per_element(lib: Path, kernels, slots: int) -> dict:
    """{kernel: SASS instructions an element} of each kernel's bf16
    16-byte instance (`<__nv_bfloat16, 8, ...>`): the instructions from
    its first 16-byte load to its `slots`-th 16-byte store after it
    (the straight-line body of a chunk inside a row: a lane's loads, its
    arithmetic and its stores of `slots` 8-element slots), over the
    8 x `slots` elements of that body; and the function's whole count."""
    sass = subprocess.run([cuobjdump_path(), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    out, cur, body = {}, None, []
    for line in sass.splitlines() + ["Function : end"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if cur is not None:
                ld = [i for i, op in enumerate(body)
                      if op.startswith("LDG") and ".128" in op]
                st = [i for i, op in enumerate(body) if ld and i > ld[0]
                      and op.startswith("STG") and ".128" in op]
                if len(st) >= slots:
                    out[cur] = {"per_element": (st[slots - 1] - ld[0] + 1) /
                                (8 * slots), "function": len(body)}
            name = m.group(1)
            # the bf16, 8-wide instance: mangled <__nv_bfloat16, 8, ...>
            cur = next((k for k in kernels if k in name and
                        "bfloat16Li8E" in name), None)
            body = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]"
                     r"[A-Z0-9_.]*)", line)
        if cur is not None and m:
            body.append(m.group(1))
    return out


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
    """The kernel alone (device, a graph of 20 calls; and over the
    longest fill's iterations), the numpy call with its copies and
    synchronise (host), the host loop's fills (host) and the plain
    version on the card."""
    dev = torch.device("cuda")
    t = [torch.from_numpy(a).to(dev) for a in case]
    B, n = case[0].shape[0], case[0].shape[-1]
    outs = (torch.empty((B, n, n), dtype=torch.float64, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.bool, device=dev))
    bound_ms, by, nbytes, nops = waterfill_bound(case, iters)
    ms = graph_ms(lambda: ops.fill_rates(*t, out=outs))
    return {"B": B, "N": n, "iters": iters, "ms": ms,
            "us_per_iter": ms * 1e3 / max(max(iters), 1),
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


# the kernel wrappers of each family's training: its forwards (run twice
# a layer a step under per-layer remat: forward, recompute) and its
# backwards (once)
SSM_FWD = ("ssd_chunk", "silu", "silu_gate")
SSM_BWD = ("ssd_chunk_bwd", "silu_bwd", "silu_gate_prod_bwd")
DENSE_FWD = ("silu_gate", "flash_fwd")
DENSE_BWD = ("silu_gate_bwd", "flash_bwd")


@contextlib.contextmanager
def patched(module, wrap, names):
    """module.<name> replaced by wrap(name, fn) for each name, restored
    after (callers inside the module look the names up at call time)."""
    saved = {n: getattr(module, n) for n in names}
    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def first_calls(seen: dict, keep: str = "first"):
    """A `patched` wrapper keeping the first call's (args, kwargs) of
    each name in `seen` (tensors copied in their layouts); with
    `keep="last"` the last call's (a backward's last call is layer
    0's). A wrapper in place of a kernel wrapper in `ops` takes the
    launches that wrapper counts under its own name while patched
    (`call.launches`, not read)."""
    def wrap(name, fn):
        def call(*args, **kw):
            if keep == "last" or name not in seen:
                seen[name] = (tuple(_copy_laid_out(a) if isinstance(
                    a, torch.Tensor) else a for a in args), dict(kw))
            return fn(*args, **kw)
        call.launches = 0
        return call
    return wrap


def capture_layer0(step):
    """Run `step` (the SSM engine's prefill or decode step) and return
    the positional inputs of its first call of each of SSM_FWD (layer
    0's) that it makes, copied in their layouts. The model's `_ad` ops
    call these wrappers by name (through their autograd Functions)."""
    seen = {}
    with patched(ops, first_calls(seen), SSM_FWD):
        step()
    return {n: args for n, (args, _) in seen.items()}


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
    ssd_chunk kernels, the flash kernels, the silu_gate kernels, the
    other silu kernels, matrix products (cuBLAS's nvjet / gemm / gemv
    and CUTLASS names), and the rest; the number of kernels run; and
    the five longest kernels by total time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = dict.fromkeys(("ssd_chunk", "flash_fwd", "silu_gate", "silu",
                           "matmul", "other"), 0.0)
    rows, n_kernels = [], 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        kind = "ssd_chunk" if "ssd_" in name else "flash_fwd" if \
            is_flash(name) else "silu_gate" if "silu_gate" in name else \
            "silu" if "silu_" in name else "matmul" if any(
                k in name for k in MATMUL_KEYS) else "other"
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
# one PyTorch call computing the same function, timed beside the kernel
# as a yardstick and used nowhere in the port (rounding once where the
# kernel rounds each op as the reference's compiled program does); the
# gates and the gate's backwards have none
SILU_LIBRARY = {"silu": torch.nn.functional.silu,
                "silu_bwd": torch.ops.aten.silu_backward}


def value_only(name: str, kw: dict) -> bool:
    """Whether the call stores `silu_gate`'s value only (the dense
    MLP's `with_prod=False`)."""
    return name == "silu_gate" and not kw.get("with_prod", True)


def check_silu(name: str, args, kw=None) -> float:
    """The silu kernel `name` (on the CPU: the wrapper's plain path) vs
    its plain version on the same inputs: every output bit-equal,
    finite, of the input's shape (`kw`: the wrapper's keywords; a
    value-only call is held to the plain value). Returns max |diff|
    (0)."""
    kw = kw or {}
    got = getattr(ops, name)(*args, **kw)
    want = SILU_PLAIN[name](*args)
    sync(args[0].device)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if value_only(name, kw):
        if got[1] is not None:
            raise AssertionError(f"{name} with {kw} returned a product")
        got, want = got[:1], want[:1]
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        if g.shape != tuple(args[0].shape) or not np.isfinite(g).all():
            raise AssertionError(f"{name} output {g.shape} or non-finite "
                                 f"values")
        np.testing.assert_array_equal(g, w)
        err = max(err, float(np.max(np.abs(g - w))))
    return err


def silu_bound(name: str, args, kw=None):
    """(ms, bound_by, bytes, ops): each input read once and each output
    written once (silu: x in, x's dtype out; silu_gate: y and z in, y's
    dtype and f32 out, or y's dtype only for a value-only call), against
    the f32 operations (exp, add, divide, multiply a silu, the gate's
    product one more)."""
    n, e = args[0].numel(), args[0].element_size()
    if name == "silu":
        nbytes, nops = 2 * n * e, 4 * n
    elif value_only(name, kw or {}):
        nbytes, nops = 3 * n * e, 5 * n
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


def lib_text(t: dict) -> str:
    """The library call's column of a SiLU kernel's log line, and
    whether the kernel is at or under it."""
    if t["library_ms"] is None:
        return "none (no single PyTorch call)"
    return (f"{t['library_ms']:.5f} ms (rounding once; this rounds each "
            f"op as the reference's compiled program does); the kernel "
            f"{'at or under' if t['ms'] <= t['library_ms'] else 'over'} "
            f"the library call")


def time_silu(name: str, args, kw=None) -> dict:
    """Device ms of the wrapper's call (one launch; `kw` its keywords)
    beside the plain version and the bound, and the host's issue time of
    each."""
    kw = kw or {}
    bound_ms, by, nbytes, nops = silu_bound(name, args, kw)
    fn, plain = getattr(ops, name), SILU_PLAIN[name]
    lib = SILU_LIBRARY.get(name)
    ms, lib_ms = kernel_and_library_ms(lambda: fn(*args, **kw),
                                       lib and (lambda: lib(*args)))
    return {"shape": list(args[0].shape), "strides": [
                list(t.stride()) for t in args],
            "dtype": str(args[0].dtype).replace("torch.", ""),
            "value_only": value_only(name, kw),
            "ms": ms,
            "wrapper_ms": call_ms(lambda: fn(*args, **kw)),
            "plain_ms": call_ms(lambda: plain(*args)),
            "host_us": host_us(lambda: fn(*args, **kw)),
            "plain_host_us": host_us(lambda: plain(*args)),
            "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
            "ops": nops}


def kernel_and_library_ms(fn, lib, timer=None):
    """(ms, library ms): device ms of the kernel's call `fn` (`timer`,
    by default a graph of 20 calls, median of 11 replays) and of the
    library's call `lib` on the same inputs (both called without
    arguments), timed the same way (None where lib is None). Where there
    is a library call the two are read in turns,
    kernel, library, library, kernel, each the mean of its two readings:
    the card's pace drifts within a phase (after the mamba train step a
    first reading can come slower than later ones, for the kernel and
    the library alike), so a kernel read first and a library call read
    last would not compare like with like."""
    timer = timer or (lambda f: graph_ms(f, launches=20, reps=11))
    if lib is None:
        return timer(fn), None
    times = {fn: [], lib: []}
    for f in (fn, lib, lib, fn):
        times[f].append(timer(f))
    return float(np.mean(times[fn])), float(np.mean(times[lib]))


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


def dequant_library(q: torch.Tensor, s: torch.Tensor, out: torch.Tensor):
    """(call, max |diff| against `out`, reason): the one PyTorch call
    that computes the grouped f32 dequantize, f32(q) * scale with a
    scale a row: `Tensor.dequantize()` of q [G, L] as a per-channel
    qint8 tensor (axis 0, the scales as f64, zero points 0), built here,
    outside the timed call; (None, None, the error's first line) where
    the card's torch refuses it. The call cannot be captured in a CUDA
    graph (it synchronises with the host), so it is timed with events
    over back-to-back calls. The tile form (a scale a 256 x 256 tile),
    the bf16 output and the accumulating form have no such call."""
    try:
        qt = torch._make_per_channel_quantized_tensor(
            q, s.double(), torch.zeros(q.shape[0], dtype=torch.int64,
                                       device=q.device), 0)
        got = qt.dequantize()
    except (RuntimeError, NotImplementedError) as e:
        return None, None, f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return qt.dequantize, float((got - out).abs().max()), None


def time_quant(x: torch.Tensor, grouped: bool, bits: int = 8) -> dict:
    """Kernel (a CUDA graph of 20 wrapper calls) and plain version
    (events over back-to-back calls) times of quantize and of dequantize
    (to x's dtype) at x, beside their bounds; for the grouped f32
    dequantize also `dequant_library`'s call and the kernel's, both
    timed with events over 20 back-to-back calls (median of 11), in
    turns (`kernel_and_library_ms`)."""
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
            "bytes": nbytes, "ops": nops, "library_ms": None}
        if name == "dequantize" and grouped and x.dtype == torch.float32:
            lib, diff, why = dequant_library(q, s, kernel())
            ev_ms, lib_ms = kernel_and_library_ms(
                kernel, lib, lambda f: device_ms(f, launches=20, reps=11))
            out[name].update(library_ms=lib_ms, library_max_abs_diff=diff,
                             library_refused=why, events_ms=ev_ms)
    return out


def quant_lib_text(kname: str, t: dict, k: dict) -> str:
    """The library call's column of a quantize phase's log line."""
    if k.get("library_ms") is not None:
        return (f"Tensor.dequantize() of a per-channel qint8 tensor "
                f"{k['library_ms']:.5f} ms against the kernel's "
                f"{k['events_ms']:.5f}, both events over 20 calls in turns "
                f"(no CUDA graph: the call synchronises; max |diff| "
                f"{k['library_max_abs_diff']:.3g})")
    if k.get("library_refused"):
        return f"Tensor.dequantize() refused: {k['library_refused']}"
    if kname == "quantize":
        return ("none (no PyTorch call computes a symmetric abs-max "
                "quantization with these semantics)")
    return (f"none (no single call dequantizes the "
            f"{'accumulating' if kname == 'dequantize_add' else t['form']}"
            f" form to {'f32' if kname == 'dequantize_add' else t['dtype']})")


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


# ----------------------------------------------------------------------
# dense phase
# ----------------------------------------------------------------------
DENSE_ARCH = "llama3-8b"
DENSE_ARCHS = ("llama3-8b", "qwen3-4b", "h2o-danube-1.8b")
DENSE_COUNTED = ("silu_gate", "flash_fwd", "flash_bwd", "rf_predict",
                 "ssd_chunk", "silu")
ATTN_CORE = ("flash_attention", "swa_attention", "decode_attention")
ATTN_LABEL = "attention_core"
MATMUL_KEYS = ("nvjet", "gemm", "gemv", "cutlass", "xmma", "cublas")
# the port against SDPA: both bf16 attention, p rounded to bf16 at other
# points and the sums in another order; each output row (over D) within
# 2^-5 of the row's max |out| (4 bf16 ulps at the least; a key masked
# wrongly or a scale 5% off moves some row by more)
SDPA_TOL = 2.0 ** -5


def dense_capture(step) -> dict:
    """Run `step` (a dense engine's prefill or decode) and return the
    first call's inputs of `silu_gate` (layer 0's MLP gate: its
    `swiglu_gate(y, z)` is `silu_gate(y, z, with_prod=False)`'s value)
    and of the attention core (`flash_attention` /
    `decode_attention`, and the prefill's `ops.flash_fwd`)."""
    seen = {}
    record = first_calls(seen)
    with patched(att, record, ATTN_CORE), \
            patched(ops, record, ("flash_fwd", "silu_gate")):
        step()
    return seen


def is_flash(name: str) -> bool:
    """A kernel of csrc/flash_attn.cu, by name."""
    return "flash_" in name and "_kernel" in name


def dense_profile(fn, core=ATTN_CORE) -> dict:
    """Run `fn` under `torch.profiler` (CPU and CUDA activity), the
    attention core (`core`: the functions of `att` named, by default
    `ATTN_CORE`) inside a `record_function` range, and
    return the device ms by kind: `silu_gate`, the flash kernels (by
    name), matrix products (cuBLAS / CUTLASS names; of which inside the
    attention core), the attention core's other kernels (decode's masks,
    exp, max, sums: the plain ops), and the rest; the kernels run; the
    five longest by total time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def annotate(name, f):
        def call(*a, **k):
            with record_function(ATTN_LABEL):
                return f(*a, **k)
        return call

    with patched(att, annotate, core), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()

    def is_matmul(name):
        return any(k in name.lower() for k in MATMUL_KEYS)

    total = silu = matmul = flash = 0.0
    n_kernels, by_name = 0, {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False) or \
                e.name == ATTN_LABEL:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        total += ms
        n_kernels += 1
        silu += ms if "silu_gate" in e.name else 0.0
        flash += ms if is_flash(e.name) else 0.0
        matmul += ms if is_matmul(e.name) else 0.0
        ms0, n0 = by_name.get(e.name[:60], (0.0, 0))
        by_name[e.name[:60]] = (ms0 + ms, n0 + 1)
    # kernels launched inside the attention core: those of every CPU op
    # under an annotation (each op once)
    attn_mm = attn_plain = 0.0
    seen, stack = set(), [e for e in events if e.name == ATTN_LABEL and
                          e.device_type == torch.autograd.DeviceType.CPU]
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        for k in e.kernels:
            if is_flash(k.name):
                continue
            if is_matmul(k.name):
                attn_mm += k.duration / 1e3
            else:
                attn_plain += k.duration / 1e3
        stack.extend(e.cpu_children)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"device_ms": total, "kernels": n_kernels, "by_kind": {
        "matmul": matmul, "matmul_in_attention": attn_mm,
        "attention_plain": attn_plain, "flash_kernels": flash,
        "silu_gate": silu,
        "rest": total - matmul - attn_plain - flash - silu},
        "attention_ranges": sum(1 for e in events if e.name == ATTN_LABEL and
                                e.device_type ==
                                torch.autograd.DeviceType.CPU),
        "top": [{"ms": ms, "count": n, "name": k} for k, (ms, n) in top]}


def attention_bound(B: int, H: int, Sq: int, Sk_used: int, D: int,
                    nbytes: int, Dv: int = None):
    """(ms, bound_by, bytes, ops) of attention over Sk_used keys a query
    (the causal half where the mask asks for it): QK^T over D (Dq)
    columns and PV over Dv (D where not given), at 2 ops a multiply-add
    each, at the bf16 tensor-core rate; `nbytes` the inputs read once (k
    and v at their KV heads) and the output written once."""
    nops = 2 * B * H * Sq * Sk_used * (D + (Dv or D))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_TC_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, nops)


def sdpa_diff(port: torch.Tensor, lib: torch.Tensor, what: str):
    """(max |port - lib|, max |lib|, the largest row error over the
    row's max |lib|, a row being the last dim); raises where that row
    error is above SDPA_TOL or not finite."""
    diff = (port.float() - lib.float()).abs()
    row_mag = lib.float().abs().amax(-1)
    rel = float((diff.amax(-1) / row_mag.clamp_min(1e-30)).max())
    err, mag = float(diff.max()), float(row_mag.max())
    if not (np.isfinite(rel) and rel <= SDPA_TOL):
        raise AssertionError(f"{what} attention: port vs SDPA, a row off "
                             f"by {rel:.4g} of its max |out| (max |diff| "
                             f"{err:.4g}, max |out| {mag:.4g})")
    return err, mag, rel


def time_attention(cap: dict, kv_heads: int) -> dict:
    """The port's attention core at the captured shapes (group 1's
    prefill: `flash_attention` on the heads expanded from `kv_heads`; a
    decode step: `decode_attention` over the cache) against
    `F.scaled_dot_product_attention` on the same inputs (causal, or the
    decode step's validity mask; heads expanded): device ms of each, the
    differences, the bound."""
    out = {}
    (q, k, v), kw = cap["flash_attention"]
    B, H, _, S, D = q.shape
    port = att.flash_attention(q, k, v, **kw)[:, :, 0]
    lib = torch.nn.functional.scaled_dot_product_attention(
        q[:, :, 0], k, v, is_causal=True)
    err, mag, rel = sdpa_diff(port, lib, "prefill")
    nbytes = 2 * (B * H + B * kv_heads) * S * D * q.element_size()
    bms, by, nb, nops = attention_bound(B, H, S, (S + 1) / 2, D, nbytes)
    out["prefill"] = {
        "shape": [B, H, S, D], "kv_heads": kv_heads,
        "kv_heads_expanded": H, "dtype": str(q.dtype),
        "ms": device_ms(lambda: att.flash_attention(q, k, v, **kw),
                        launches=10),
        "library_ms": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, 0], k, v, is_causal=True), launches=10),
        "max_abs_diff": err, "max_abs_out": mag, "max_row_rel_diff": rel,
        "bound_ms": bms, "bound_by": by, "bytes": nb, "ops": nops}
    (qd, ck, cv, pos, window), _ = cap["decode_attention"]
    B, H, _, D = qd.shape
    KV, Sc = ck.shape[1], ck.shape[2]
    valid = (torch.arange(Sc, device=qd.device) <= pos)[None, None, None]
    kx = torch.repeat_interleave(ck, H // KV, dim=1)
    vx = torch.repeat_interleave(cv, H // KV, dim=1)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qd, kx, vx, attn_mask=valid)
    err, mag, rel = sdpa_diff(
        att.decode_attention(qd, ck, cv, pos, window), sdpa(), "decode")
    used = pos + 1
    nbytes = 2 * B * KV * used * D * ck.element_size() + \
        B * H * D * (qd.element_size() + 4)
    bms, by, nb, nops = attention_bound(B, H, 1, used, D, nbytes)
    out["decode"] = {
        "shape": [B, H, KV, Sc, D], "pos": pos, "dtype": str(qd.dtype),
        "ms": graph_ms(lambda: att.decode_attention(qd, ck, cv, pos, window)),
        "library_ms": graph_ms(sdpa), "max_abs_diff": err,
        "max_abs_out": mag, "max_row_rel_diff": rel, "bound_ms": bms,
        "bound_by": by, "bytes": nb, "ops": nops}
    return out


# the flash kernels against their plain versions: the same f32 sums in
# another order (the kernels' tiles, not blocks of 512), and in bf16 p
# rounded against another running max, so bf16 outputs and gradients are
# held row by row (over D) within 2^-7 of the row's max |value| (one bf16
# step; a key masked wrongly or a lost tile moves a row by far more), a
# row's max floored at 2^-7 of the tensor's (a query whose only key is
# itself has ds = p (dp - delta) = 0 up to the sums' order: its dq row is
# rounding noise); f32 within 1e-5 of the max |value|; lse within 1e-5
# (beside f32 keys split into bf16 parts, more: `flash_lse_tol`)
FLASH_BF16_ROW = 2.0 ** -7
FLASH_F32_TOL = 1e-5
# MLA's dk in bf16 runs is f32 (the reference's keys are): the f32 sums of
# products of bf16 inputs in another order, p by ex2, the keys split into
# hi and lo (under 2^-17 |k| dropped): within 1e-4 of dk's max (7.5e-6 at
# minicpm3-4b's train shape), where keys rounded to bf16 move it by 2.0e-3
# (the split's 8.3e-6; random parts at that shape, PERF.md section 6)
FLASH_DK_BF16_RUN = 1e-4
FLASH_LSE_TOL = 1e-5
# MLA's f32 keys enter the bf16 kernel split into hi = bf16(k) and lo =
# bf16(k - hi); what that drops is under 2^-17 |k| an element (k - hi is
# under 2^-8 |k| and exact in f32; its rounding to bf16 is then under
# 2^-17 |k|), so a score moves by under sc * 2^-17 * sum_d |q_d k_d|, and
# lse, 1-Lipschitz in the scores, by under the largest such move over
# the keys its row reads. A fixed bound cannot hold for that: it grows
# with |q| |k|
KEY_SPLIT_DROP = 2.0 ** -17


def first_card_calls(seen: dict):
    """`first_calls` for calls whose first tensor lies on the card (the
    host's engine calls the same wrappers on the CPU)."""
    record = first_calls(seen)

    def wrap(name, fn):
        rec = record(name, fn)

        def call(*args, **kw):
            return (rec if args[0].is_cuda else fn)(*args, **kw)
        call.launches = 0
        return call
    return wrap


def flash_err(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """The worst error of `got` against `want` in the units of the
    tolerance above (at most 1 to pass) and, for bf16, the share of
    elements more than one bf16 ulp apart; raises past the tolerance or
    on a shape, dtype or non-finite value."""
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.isfinite(got).all():
        raise AssertionError(f"flash {what}: {got.dtype} "
                             f"{tuple(got.shape)} against {want.dtype} "
                             f"{tuple(want.shape)}, or non-finite values")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    top = float(w.abs().max())
    if got.dtype == torch.bfloat16:
        row = w.abs().amax(-1, keepdim=True).clamp_min(FLASH_BF16_ROW * top)
        worst = float((diff / row.clamp_min(1e-30)).max()) / FLASH_BF16_ROW
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
                         - 7)
        apart = float((diff > ulp).float().mean())
    else:
        worst = float(diff.max()) / max(top, 1e-30) / FLASH_F32_TOL
        apart = None
    if not worst <= 1.0:
        raise AssertionError(f"flash {what}: off by {worst:.4g} of the "
                             f"tolerance")
    return {"err": worst, "max_abs_diff": float(diff.max()),
            "max_abs": top, "ulp_apart_share": apart}


def flash_lse_tol(q: torch.Tensor, k: torch.Tensor,
                  window: int) -> torch.Tensor:
    """Each row's lse tolerance [B,K,G,S] (f64): FLASH_LSE_TOL for the
    f32 sums' rounding, and beside it, for f32 keys by a bf16 q (the
    kernel's hi / lo split), sc * KEY_SPLIT_DROP * max_j sum_d |q_d k_jd|
    over the keys j the row reads (causal, in the window)."""
    B, K, G, S, Dq = q.shape
    tol = torch.full((B, K, G, S), FLASH_LSE_TOL, dtype=torch.float64,
                     device=q.device)
    if k.dtype == q.dtype:
        return tol
    mags = torch.matmul(q.float().abs().reshape(B, K, G * S, Dq),
                        k.abs().transpose(-1, -2)).view(B, K, G, S, -1)
    gap = torch.arange(S, device=q.device)[:, None] - \
        torch.arange(k.shape[2], device=q.device)[None, :]
    reads = (gap >= 0) & ((gap < window) if window > 0 else True)
    worst = mags.masked_fill(~reads, 0.0).amax(-1)
    return tol + Dq ** -0.5 * KEY_SPLIT_DROP * worst.double()


def lse_err(lse: torch.Tensor, want: torch.Tensor, q: torch.Tensor,
            k: torch.Tensor, window: int) -> dict:
    """lse against the plain version's, row by row, in the units of
    :func:`flash_lse_tol` (at most 1 to pass); raises past it or on a
    non-finite value."""
    diff = (lse.double() - want.double()).abs()
    tol = flash_lse_tol(q, k, window)
    worst = float((diff / tol).max())
    if not worst <= 1.0:
        raise AssertionError(f"flash lse off by {worst:.4g} of its "
                             f"tolerance (max |diff| {float(diff.max())})")
    return {"lse_max_abs_diff": float(diff.max()), "lse_err": worst,
            "lse_max_tol": float(tol.max())}


def check_flash_fwd(args) -> dict:
    """`ops.flash_fwd` (the kernel on the card) against `flash_fwd_ref`
    on the captured inputs (q, k, v, window, block_k): out, and lse
    within :func:`flash_lse_tol`."""
    out, lse = ops.flash_fwd(*args)
    want_out, want_lse = flash_fwd_ref(*args)
    sync(out.device)
    return {"shape": list(args[0].shape), "window": args[3],
            "dtype": str(args[0].dtype).replace("torch.", ""),
            "out": flash_err(out, want_out, "fwd out"),
            **lse_err(lse, want_lse, args[0], args[1], args[3])}


def mla_concatenated(args):
    """q [B,H,1,S,Dq] and k [B,H,S,Dq] (f32) as the reference
    concatenates MLA's parts (args: `ops.flash_fwd_mla`'s q_nope, q_rope,
    k_nope, k_rope, v, ...)."""
    q_nope, q_rope, k_nope, k_rope = args[:4]
    B, H, S, rd = q_rope.shape
    return (torch.cat([q_nope, q_rope], dim=-1)[:, :, None],
            torch.cat([k_nope.float(), k_rope.float().expand(B, H, S, rd)],
                      dim=-1))


def check_flash_mla(args) -> dict:
    """`ops.flash_fwd_mla` (the kernel on the card) against
    `flash_fwd_mla_ref` on the captured parts (q_nope, q_rope, k_nope,
    k_rope, v, block_k): out, and lse within :func:`flash_lse_tol` of the
    concatenated q and k."""
    out, lse = ops.flash_fwd_mla(*args)
    want_out, want_lse = flash_fwd_mla_ref(*args)
    sync(out.device)
    q, k = mla_concatenated(args)
    return {"shape": list(q.shape), "window": 0,
            "dtype": str(q.dtype).replace("torch.", ""),
            "out": flash_err(out, want_out, "fwd out"),
            **lse_err(lse, want_lse, q, k, 0)}


def check_flash_bwd(args) -> dict:
    """`ops.flash_bwd` against `flash_bwd_ref` on the captured inputs
    (g, q, k, v, out, lse, window, block_k): dq, dk, dv."""
    got = ops.flash_bwd(*args)
    want = flash_bwd_ref(*args)
    sync(got[0].device)
    res = {"shape": list(args[1].shape), "window": args[6],
           "dtype": str(args[1].dtype).replace("torch.", "")}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        res[name] = flash_err(a, b, f"bwd {name}")
    return res


def check_flash_bwd_mla(args) -> dict:
    """`ops.flash_bwd_mla` against `flash_bwd_mla_ref` on the inputs (g,
    q_nope, q_rope, k_nope, k_rope, v, out, lse[, block_k]), called
    twice (every output equal bit for bit): dq_nope, dq_rope and dv
    under `flash_err`'s rule of their dtype; dk, the kernels' whole f32
    dk [B,H,S,nd + rd] (k_nope's gradient and each head's rope columns
    before their sum), against the plain version's on the reference's
    concatenations within FLASH_F32_TOL of its max in f32 runs and
    FLASH_DK_BF16_RUN in bf16 runs; dk_rope bit-equal to the plain sum
    over the heads (`rope_head_sum`) of the kernels' own rope columns
    (its distance from the plain version's dk_rope, whose terms round
    to bf16 from other f32 sums, is reported, not held)."""
    got = ops.flash_bwd_mla(*args)
    again = ops.flash_bwd_mla(*args)
    sync(got[0].device)
    names = ("dq_nope", "dq_rope", "dk_nope", "dk_rope", "dv")
    apart = [n for n, a, b in zip(names, got, again) if not torch.equal(a, b)]
    if apart:
        raise AssertionError(f"flash_bwd (mla): two calls differ in {apart}")
    g, q_nope, q_rope, k_nope, k_rope, v, out, lse = args[:8]
    want = flash_bwd_mla_ref(*args[:8], 512)
    q, k = mla_concatenated(args[1:])
    dk_want = flash_bwd_ref(g, q, k, v, out, lse, 0, 512)[1]
    nd = q_nope.shape[3]
    dk = got[2]._base
    if dk is None or dk.shape != dk_want.shape or dk.dtype != torch.float32:
        raise AssertionError(f"flash_bwd (mla): dk_nope is not a view of "
                             f"an f32 dk {tuple(dk_want.shape)}")
    bf16_run = q_nope.dtype == torch.bfloat16
    res = {"shape": [*q_nope.shape[:3], f"{nd}+{q_rope.shape[3]}"],
           "Dv": v.shape[3], "dtype": str(q_nope.dtype).replace("torch.", ""),
           "equal_bits": True}
    for i in (0, 1, 4):
        res[names[i]] = flash_err(got[i], want[i], f"bwd (mla) {names[i]}")
    diff = float((dk - dk_want).abs().max())
    top = float(dk_want.abs().max())
    tol = FLASH_DK_BF16_RUN if bf16_run else FLASH_F32_TOL
    res["dk"] = {"err": diff / max(top, 1e-30) / tol, "max_abs_diff": diff,
                 "max_abs": top, "ulp_apart_share": None}
    if not res["dk"]["err"] <= 1.0:
        raise AssertionError(f"flash_bwd (mla) dk: off by "
                             f"{res['dk']['err']:.4g} of the tolerance")
    own = rope_head_sum(dk[..., nd:], k_rope.dtype)
    if not torch.equal(got[3], own):
        raise AssertionError("flash_bwd (mla): dk_rope is not the heads' "
                             "sum of the kernels' own rope columns")
    res["dk_rope"] = {"equal_to_own_sum": True, "max_abs_diff": float(
        (got[3].float() - want[3].float()).abs().max()),
        "max_abs": float(want[3].float().abs().max())}
    res["max_abs_diff"] = max(res[n]["max_abs_diff"] for n in (
        "dq_nope", "dq_rope", "dk", "dv"))
    return res


def flash_bits(fargs, bargs) -> dict:
    """`ops.flash_fwd` and `ops.flash_bwd` called twice each on the same
    inputs: every output equal bit for bit (the kernels sum in a fixed
    order, with no atomics); raises otherwise."""
    first = ops.flash_fwd(*fargs) + ops.flash_bwd(*bargs)
    second = ops.flash_fwd(*fargs) + ops.flash_bwd(*bargs)
    sync(first[0].device)
    apart = [n for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), first,
                                  second) if not torch.equal(a, b)]
    if apart:
        raise AssertionError(f"flash: two calls differ in {apart}")
    return {"shape": list(fargs[0].shape),
            "dtype": str(fargs[0].dtype).replace("torch.", ""),
            "equal": ["out", "lse", "dq", "dk", "dv"]}


def keys_used(S: int, window: int) -> float:
    """Keys a query attends to, on average, causal within the window."""
    i = np.arange(S)
    return float(np.mean(np.minimum(i + 1, window) if window else i + 1))


def flash_sdpa(q, k, v, window):
    """SDPA on the same inputs (one query head a KV head: G = 1; a
    window that binds needs a mask, so None then)."""
    S = q.shape[3]
    if q.shape[2] != 1 or (window and window < S):
        return None
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, 0], k, v, is_causal=True)


def time_flash_fwd(args, kv_heads: int) -> dict:
    """Device ms of `ops.flash_fwd` (one launch), its plain version and
    SDPA on the same inputs, beside the bound of the attention it
    computes: q, and k and v at their `kv_heads` (the call gets them
    expanded), read once, out and lse written once; QK^T and PV over
    the keys each query uses, at the bf16 tensor-core rate."""
    q, k, v, window = args[:4]
    B, K, G, S, D = q.shape
    e = q.element_size()
    nbytes = (2 * q.numel() + 2 * B * kv_heads * S * D) * e + \
        B * K * G * S * 4
    bms, by, nb, nops = attention_bound(B, K * G, S, keys_used(S, window),
                                        D, nbytes)
    lib = flash_sdpa(q, k, v, window)
    return {"ms": device_ms(lambda: ops.flash_fwd(*args), launches=10),
            "plain_ms": device_ms(lambda: flash_fwd_ref(*args), launches=2,
                                  reps=3),
            "library_ms": device_ms(lib, launches=10) if lib else None,
            "bound_ms": bms, "bound_by": by, "bytes": nb, "ops": nops}


def time_flash_bwd(args, kv_heads: int) -> dict:
    """Device ms of `ops.flash_bwd` (delta, dq, dk / dv), its plain
    version and `torch.autograd.grad` through SDPA (`is_causal`) on the
    same inputs, beside the bound: q, k and v (at their `kv_heads`),
    out, g and lse read once, dq, dk, dv (dk, dv at the KV heads)
    written once; five products (QK^T, g V^T, P^T g, dS K, dS^T Q) over
    the keys each query uses, at the bf16 tensor-core rate."""
    g, q, k, v, out, lse, window = args[:7]
    B, K, G, S, D = q.shape
    e = q.element_size()
    nbytes = (2 * q.numel() + 4 * B * kv_heads * S * D + out.numel() +
              g.numel()) * e + lse.numel() * 4
    used = keys_used(S, window)
    _, _, nb, _ = attention_bound(B, K * G, S, used, D, nbytes)
    nops = 10 * B * K * G * D * S * used
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_TC_OPS_PER_S
    res = {"ms": device_ms(lambda: ops.flash_bwd(*args), launches=10),
           "plain_ms": device_ms(lambda: flash_bwd_ref(*args), launches=2,
                                 reps=3),
           "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nb, "ops": nops}
    if flash_sdpa(q, k, v, window) is not None:
        qr, kr, vr = (t.detach().requires_grad_() for t in
                      (q[:, :, 0], k, v))
        o = torch.nn.functional.scaled_dot_product_attention(
            qr, kr, vr, is_causal=True)
        go = g[:, :, 0]
        res["library_ms"] = device_ms(lambda: torch.autograd.grad(
            o, (qr, kr, vr), go, retain_graph=True), launches=10)
        del o
    return res


def log_flash(tag: str, which: str, chk: dict, t: dict, smi: str) -> None:
    errs = {k: v for k, v in chk.items() if isinstance(v, dict)}
    log(f"[{tag}] flash_{which} {chk['shape']} {chk['dtype']} window "
        f"{chk['window']}: within tolerance (" + ", ".join(
            f"{k} {v['err']:.3g}" + (f", {v['ulp_apart_share']:.4%} > 1 ulp"
                                     if v["ulp_apart_share"] is not None
                                     else "") for k, v in errs.items())
        + (f"; lse {chk['lse_max_abs_diff']:.3g}, {chk['lse_err']:.3g} of "
           f"its tolerance" if "lse_max_abs_diff" in chk else "")
        + f") | kernel {t['ms']:.5f} ms | plain "
        f"{t['plain_ms']:.4f} ms | bound {t['bound_ms']:.5f} ms by "
        f"{t['bound_by']} ({t['bytes']} B, {t['ops']:.4g} ops) | library "
        + (f"{t['library_ms']:.5f} ms" if t["library_ms"] is not None
           else "none") + f" | {smi}")


def serve_counted(cfg, paper, dev, capture, counted, want_of) -> tuple:
    """`cfg` (at full size: weights from a `torch.Generator` seeded 0)
    served by the Engine with a controller on the paper forest, after a
    warm-up (cuBLAS set-up, the bf16 cast) that captures the kernels'
    first inputs (`capture(step)`) of both prefills and a decode step;
    the launches of `counted` zeroed just before `replan()` and the
    serve and read just after, held to `want_of(n_prefill, n_steps)`
    (the expected counts and why). Returns (numbers, captures, engine,
    groups)."""
    t0 = time.perf_counter()
    model = registry.build_model(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    ctl = WanifyController(WanSimulator(seed=0),
                           BwPredictor(paper, device=dev), n_pods=2)
    eng = CheckedEngine(cfg, model, ServeConfig(batch=SERVE_BATCH,
                                                s_max=S_MAX),
                        controller=ctl, device=dev)
    reqs = serve_requests(cfg.vocab)
    groups = groups_of(reqs)
    caps = [capture(lambda g=g: eng.prefill(eng.batch_tokens(g)))
            for g in groups]
    caps.append(capture(lambda: eng.decode(np.zeros(SERVE_BATCH,
                                                     np.int32))))
    # the main path, counts zeroed just before it and read just after
    eng.timings = {"prefill_s": [], "decode_s": []}
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for name in counted:
        getattr(ops, name).launches = 0
    t0 = time.perf_counter()
    eng.replan()
    schedule = eng.migration_schedule()
    t1 = time.perf_counter()
    out = eng.serve(reqs)
    serve_s = time.perf_counter() - t1
    got = {name: getattr(ops, name).launches for name in counted}
    n_prefill = len(eng.timings["prefill_s"])
    want, why = want_of(n_prefill,
                        n_prefill + len(eng.timings["decode_s"]))
    if got != want:
        raise AssertionError(f"{cfg.arch_id} serve launches {got}, "
                             f"expected {want}: {why}")
    check_served(out, reqs, cfg.vocab)
    prefill_ms = [v * 1e3 for v in eng.timings["prefill_s"]]
    decode_ms = [v * 1e3 for v in eng.timings["decode_s"]]
    tokens = sum(len(v) for v in out.values())
    res = {"arch": cfg.arch_id, "layers": cfg.n_layers,
           "params": sum(p.numel() for p in model.parameters()),
           "init_s": init_s, "batch": SERVE_BATCH, "s_max": S_MAX,
           "requests": len(reqs), "max_new": MAX_NEW,
           "prompt_lens": [len(r.prompt) for r in reqs],
           "group_lens": [max(len(r.prompt) for r in g) for g in groups],
           "launches": got, "replan_s": t1 - t0, "schedule": schedule,
           "prefill_ms": prefill_ms, "decode_ms": decode_ms,
           "decode_ms_median": float(np.median(decode_ms)),
           "decode_ms_p90": float(np.percentile(decode_ms, 90)),
           "serve_s": serve_s, "tokens": tokens,
           "tokens_per_s": tokens / serve_s,
           "peak_bytes": torch.cuda.max_memory_allocated()
           if dev.type == "cuda" else None,
           "out": {str(k): v for k, v in out.items()}}
    return res, caps, eng, groups


def dense_serve(cfg, paper, dev) -> tuple:
    """The dense phase's part (1): `serve_counted` with the dense
    captures; one silu_gate a layer a step, one flash_fwd a layer a
    prefill."""
    def want_of(n_prefill, n_steps):
        return ({"silu_gate": n_steps * cfg.n_layers,
                 "flash_fwd": n_prefill * cfg.n_layers, "flash_bwd": 0,
                 "rf_predict": 1, "ssd_chunk": 0, "silu": 0},
                f"one silu_gate per layer per step ({n_steps} steps), one "
                f"flash_fwd per layer per prefill ({n_prefill}) and none "
                f"in decode, 1 rf_predict, no ssd_chunk or silu")
    return serve_counted(cfg, paper, dev, dense_capture, DENSE_COUNTED,
                         want_of)


def dense_parity(dev, cfgs=None) -> dict:
    """The dense phase's part (2): each of `cfgs` (DENSE_ARCHS' configs
    at full width by default) at 2 layers in f32, on the card and on the
    host with the same weights, on group 1's prompts (drawn from the
    arch's vocabulary; S = 641, two key blocks, the second padded)."""
    res = {}
    for cfg in cfgs or [get_config(a) for a in DENSE_ARCHS]:
        t0 = time.perf_counter()
        arch = cfg.arch_id
        pcfg = cfg.replace(n_layers=PARITY_LAYERS, dtype="float32")
        card_model = registry.build_model(
            pcfg, torch.Generator(device=dev).manual_seed(0), dev)
        host_model = DenseLM(pcfg, torch.device("cpu"), torch.float32)
        host_model.load_state_dict(card_model.state_dict())
        sc = ServeConfig(batch=SERVE_BATCH, s_max=S_MAX)
        card = CheckedEngine(pcfg, card_model, sc, device=dev)
        tokens = card.batch_tokens(groups_of(serve_requests(pcfg.vocab))[0])
        seen = {}
        fwd = "flash_fwd_mla" if cfg.is_mla else "flash_fwd"
        with patched(ops, first_card_calls(seen), (fwd,)):
            err, mag, compared, equal = check_parity(
                card, CheckedEngine(pcfg, host_model, sc, device="cpu"),
                tokens)
        check = check_flash_mla if cfg.is_mla else check_flash_fwd
        res[arch] = {"layers": PARITY_LAYERS, "steps": PARITY_STEPS,
                     "prompt": int(tokens.shape[1]), "tol": PARITY_TOL,
                     "max_abs_err": err, "max_abs_logit": mag,
                     "ids_compared": compared, "ids_equal": equal,
                     "flash_fwd": check(seen[fwd][0]),
                     "s": time.perf_counter() - t0}
        del seen
        del card, card_model, host_model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res


def dense_phase(paper, dev, smi: str) -> dict:
    """The dense phase (see the head comment); every check fatal."""
    t_phase = time.perf_counter()
    cfg = get_config(DENSE_ARCH)
    serve, caps, eng, groups = dense_serve(cfg, paper, dev)
    log(f"[dense] {DENSE_ARCH} {cfg.n_layers} layers, {serve['params']} "
        f"params on the card in {serve['init_s']:.1f} s; "
        f"{serve['requests']} requests (prompts {serve['prompt_lens']}), "
        f"{serve['tokens']} tokens in {serve['serve_s']:.3f} s = "
        f"{serve['tokens_per_s']:.1f} tokens/s; launches "
        f"{serve['launches']}; replan {serve['replan_s'] * 1e3:.1f} ms, "
        f"schedule {serve['schedule']} | {smi}")
    log("[dense] prefill ms per group: " + ", ".join(
        f"{p:.2f} (S={s})" for p, s in zip(serve["prefill_ms"],
                                           serve["group_lens"]))
        + f"; decode ms per step: median {serve['decode_ms_median']:.3f}, "
        f"p90 {serve['decode_ms_p90']:.3f}; peak device "
        f"memory {serve['peak_bytes'] / 2**30:.3f} GiB")
    log("[dense] ids: " + "; ".join(f"{k}: {v[:6]}" for k, v in
                                    sorted(serve["out"].items())[:3]))
    # where the device time goes, after the counted run: group 1's
    # prefill and 4 decode steps again under the profiler
    toks = eng.batch_tokens(groups[0])
    prof = {"prefill": dense_profile(lambda: eng.prefill(toks))}
    nxt = eng.prefill(toks)
    prof["decode"] = dense_profile(lambda: [eng.decode(nxt)
                                            for _ in range(PARITY_STEPS)])
    prof["prefill"]["busy_share"] = prof["prefill"]["device_ms"] / \
        serve["prefill_ms"][0]
    prof["decode"]["busy_share"] = prof["decode"]["device_ms"] / \
        PARITY_STEPS / serve["decode_ms_median"]
    prof["decode"]["kernels_per_step"] = prof["decode"]["kernels"] / \
        PARITY_STEPS
    serve["profile"] = prof
    for phase, pr in prof.items():
        log(f"[dense] profile {phase}: {pr['kernels']} device kernels, "
            f"{pr['device_ms']:.2f} ms ({pr['busy_share']:.1%} of the "
            f"untraced wall time), {pr['attention_ranges']} attention "
            f"calls; by kind " + ", ".join(
                f"{k} {v:.2f}" for k, v in pr["by_kind"].items()) +
            "; top: " + ", ".join(f"{t['name']} x{t['count']} "
                                  f"{t['ms']:.2f}" for t in pr["top"]))
    # the silu_gate kernel against its plain version on the MLP's inputs
    # (layer 0 of both prefills and of a decode step), bit-equal
    gate_err, gate_cases = 0.0, []
    for step, cap in zip(("prefill1", "prefill2", "decode"), caps):
        err = check_silu("silu_gate", *cap["silu_gate"])
        gate_err = max(gate_err, err)
        gate_cases.append({"step": step, "err": err,
                           "shape": list(cap["silu_gate"][0][0].shape)})
    gate_timing = {step: time_silu("silu_gate", *cap["silu_gate"])
                   for step, cap in (("prefill1", caps[0]),
                                     ("decode", caps[2]))}
    for key, t in gate_timing.items():
        log(f"[dense] silu_gate {key} {t['shape']} {t['dtype']} (value "
            f"only: {t['value_only']}): bit-equal "
            f"to plain; kernel {t['ms']:.5f} ms (device, graph of 20 "
            f"calls) | plain {t['plain_ms']:.5f} ms | bound "
            f"{t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes']} B) | "
            f"library call: {lib_text(t)} | {smi}")
    serve["silu_gate"] = {"cases": gate_cases, "max_abs_err": gate_err,
                          "timing": gate_timing}
    # the flash_fwd kernel against its plain version on layer 0's inputs
    # of both prefills, timed at group 1's beside its plain version, SDPA
    # and the bound
    flash = {"checks": [check_flash_fwd(cap["flash_fwd"][0])
                        for cap in caps[:2]]}
    flash["timing"] = time_flash_fwd(caps[0]["flash_fwd"][0],
                                      cfg.n_kv_heads)
    log_flash("dense", "fwd", flash["checks"][0], flash["timing"], smi)
    for chk in flash["checks"][1:]:
        log(f"[dense] flash_fwd {chk['shape']} (group 2's prefill): out "
            f"within {chk['out']['err']:.3g} of the tolerance "
            f"({chk['out']['ulp_apart_share']:.4%} > 1 ulp), lse "
            f"{chk['lse_max_abs_diff']:.3g}")
    flash["max_err"] = max(c["out"]["err"] for c in flash["checks"])
    serve["flash_fwd"] = flash
    # (3) the attention core against SDPA at group 1's prefill shape and
    # the decode step's
    attn = time_attention({"flash_attention": caps[0]["flash_attention"],
                           "decode_attention": caps[2]["decode_attention"]},
                          cfg.n_kv_heads)
    for key, t in attn.items():
        log(f"[dense] attention {key} {t['shape']} {t['dtype']}: port "
            f"{t['ms']:.4f} ms | SDPA {t['library_ms']:.4f} ms | max |diff| "
            f"{t['max_abs_diff']:.4g} (max |out| {t['max_abs_out']:.4g}; "
            f"largest row error {t['max_row_rel_diff']:.4g} of the row's "
            f"max |out|, limit {SDPA_TOL:.4g}) | "
            f"bound {t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes']} "
            f"B, {t['ops']:.4g} ops at the bf16 tensor-core rate) | {smi}")
    del eng, caps
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # (2) parity: each arch at full width, 2 layers, f32, card vs host
    parity = dense_parity(dev)
    for arch, p in parity.items():
        log(f"[dense] parity {arch} {PARITY_LAYERS} layers f32, prompt "
            f"{p['prompt']} x{SERVE_BATCH}, prefill + {PARITY_STEPS} decode "
            f"steps: logits within {PARITY_TOL} of the host (max |diff| "
            f"{p['max_abs_err']:.3e}, max |logit| {p['max_abs_logit']:.3f}); "
            f"ids equal on {p['ids_compared']} clear top-2 gaps "
            f"({p['ids_equal']} of {(PARITY_STEPS + 1) * SERVE_BATCH} equal "
            f"in all); flash_fwd {p['flash_fwd']['shape']} f32 within "
            f"{p['flash_fwd']['out']['err']:.3g} of its tolerance, lse "
            f"{p['flash_fwd']['lse_max_abs_diff']:.3g}; {p['s']:.1f} s")
    out = {"serve": serve, "attention": attn, "parity": parity,
           "s": time.perf_counter() - t_phase}
    log(f"[dense] phase {out['s']:.2f} s")
    return out


# ----------------------------------------------------------------------
# hybrid phase
# ----------------------------------------------------------------------
HYBRID_ARCH = "zamba2-2.7b"
# the kernels the hybrid's serve launches, and the backwards it must not
HYBRID_COUNTED = ("ssd_chunk", "flash_fwd", "silu", "silu_gate",
                  "rf_predict", "flash_bwd", "ssd_chunk_bwd", "silu_bwd",
                  "silu_gate_bwd", "silu_gate_prod_bwd")
# the parity cut: the shared block runs twice, before layers 0 and 6
HYBRID_PARITY_LAYERS = 7
# part (6) of the train phase: the 4-pod run's cut, the parity's (the
# shared block twice; 4 pods' f32 state of 548 M parameters, 35 GB)
HYBRID_POD_LAYERS = HYBRID_PARITY_LAYERS


def hybrid_capture(step) -> dict:
    """Run `step` (the hybrid engine's prefill or decode) and return the
    first call's (args, kwargs) of each kernel wrapper of its path:
    `ssd_chunk` and `silu` (layer 0's), `flash_fwd` (the first shared
    application's) and `silu_gate` twice: the shared MLP's value-only
    gate ("silu_gate_mlp", the first call: the block runs before layer
    0) and layer 0's gated norm ("silu_gate")."""
    seen = {}
    record = first_calls(seen)

    def wrap(name, fn):
        if name != "silu_gate":
            return record(name, fn)
        mlp, norm = record("silu_gate_mlp", fn), record("silu_gate", fn)

        def call(*args, **kw):
            return (mlp if kw.get("with_prod") is False else norm)(*args,
                                                                   **kw)
        call.launches = 0
        return call
    with patched(ops, wrap, ("ssd_chunk", "flash_fwd", "silu", "silu_gate")):
        step()
    return seen


def two_calls_equal(fn, what: str) -> None:
    """`fn` (a kernel wrapper's call) twice on the same inputs: every
    output equal bit for bit; raises otherwise."""
    first, second = fn(), fn()
    sync(first[0].device)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{what}: two calls differ")


def hybrid_serve(cfg, paper, dev) -> tuple:
    """The hybrid phase's serve: `serve_counted` with the hybrid
    captures; per prefill one ssd_chunk a layer and one flash_fwd an
    application of the shared block, per step one silu a layer and one
    silu_gate a layer and an application, no backward kernel."""
    apps = sum(lm_mod.shared_flags(cfg))

    def want_of(n_prefill, n_steps):
        want = dict.fromkeys(HYBRID_COUNTED, 0)
        want.update({"ssd_chunk": n_prefill * cfg.n_layers,
                     "flash_fwd": n_prefill * apps,
                     "silu": n_steps * cfg.n_layers,
                     "silu_gate": n_steps * (cfg.n_layers + apps),
                     "rf_predict": 1})
        return want, (f"per prefill one ssd_chunk a layer and one "
                      f"flash_fwd an application ({apps}); per step one "
                      f"silu a layer and one silu_gate a layer and an "
                      f"application ({n_steps} steps); 1 rf_predict; no "
                      f"backward kernel")
    res = serve_counted(cfg, paper, dev, hybrid_capture, HYBRID_COUNTED,
                        want_of)
    res[0]["shared_applications"] = apps
    return res


def hybrid_kernels(caps, cfg, smi: str, ssd_n128_ms: float) -> dict:
    """The hybrid phase's kernel checks on the serve's captured inputs:
    `ssd_chunk` (layer 0, N = 64) within SSD_TOL of its plain version,
    timed beside its bound and the mamba serve's N = 128 time;
    `flash_fwd` (the first shared application: 32 heads, G = 1, D = 80)
    within 2^-7 of each bf16 row's max, timed beside SDPA and the bound;
    each called twice, equal bit for bit; the SiLU kernels at the
    hybrid's shapes bit-equal to their plain versions, timed at group
    1's prefill."""
    out = {}
    cases, err = [], 0.0
    for step, cap in zip(("prefill1", "prefill2"), caps):
        for b, c, sub in ssd_subsets(cap["ssd_chunk"][0]):
            e, share = check_ssd(sub)
            err = max(err, e)
            cases.append({"step": step, "B": b, "nC": c, "err": e,
                          "tol_share": share})
    args = caps[0]["ssd_chunk"][0]
    two_calls_equal(lambda: ops.ssd_chunk(*args), "ssd_chunk")
    t = time_ssd(args)
    t["n128_ms"] = ssd_n128_ms
    out["ssd_chunk"] = {"cases": cases, "max_abs_err": err, "timing": t}
    log(f"[hybrid] ssd_chunk {t['shape']} {t['dtype']}: within {SSD_TOL} of "
        f"plain at layer 0 of both prefills (max |diff| {err:.3e}, "
        f"{max(c['tol_share'] for c in cases):.3f} of the tolerance), two "
        f"calls equal | kernel {t['ms']:.4f} ms (N=128 in the mamba serve: "
        f"{ssd_n128_ms:.4f} ms) | plain {t['plain_ms']:.4f} ms | bound "
        f"{t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes']} B, "
        f"{t['ops']} ops) | library call: none | {smi}")
    checks = [check_flash_fwd(cap["flash_fwd"][0]) for cap in caps[:2]]
    fargs = caps[0]["flash_fwd"][0]
    two_calls_equal(lambda: ops.flash_fwd(*fargs), "flash_fwd")
    ft = time_flash_fwd(fargs, cfg.n_kv_heads)
    out["flash_fwd"] = {"checks": checks, "timing": ft,
                        "max_err": max(c["out"]["err"] for c in checks)}
    log_flash("hybrid", "fwd", checks[0], ft, smi)
    log(f"[hybrid] flash_fwd {checks[1]['shape']} (group 2's prefill): "
        f"out within {checks[1]['out']['err']:.3g} of the tolerance "
        f"({checks[1]['out']['ulp_apart_share']:.4%} > 1 ulp), lse "
        f"{checks[1]['lse_max_abs_diff']:.3g}; two calls equal")
    silu = {}
    for key, name in (("silu", "silu"), ("silu_gate", "silu_gate"),
                      ("silu_gate_mlp", "silu_gate")):
        errs = [check_silu(name, *cap[key]) for cap in caps]
        silu[key] = time_silu(name, *caps[0][key])
        silu[key]["max_abs_err"] = max(errs)
        s = silu[key]
        log(f"[hybrid] {key} {s['shape']} {s['dtype']} (value only: "
            f"{s['value_only']}): bit-equal to plain at both prefills and "
            f"a decode step; kernel {s['ms']:.5f} ms | plain "
            f"{s['plain_ms']:.5f} ms | bound {s['bound_ms']:.5f} ms by "
            f"{s['bound_by']} ({s['bytes']} B) | library call: "
            f"{lib_text(s)} | {smi}")
    out["silu"] = silu
    return out


def hybrid_parity(dev, cfg, tokens: np.ndarray) -> dict:
    """`cfg` cut to HYBRID_PARITY_LAYERS (the shared block twice) in f32
    on the card and on the host with the same weights, on `tokens`:
    prefill and PARITY_STEPS decodes (`check_parity`); the card's first
    `flash_fwd` call (f32) against its plain version."""
    t0 = time.perf_counter()
    pcfg = cfg.replace(n_layers=HYBRID_PARITY_LAYERS, dtype="float32")
    card_model = registry.build_model(
        pcfg, torch.Generator(device=dev).manual_seed(0), dev)
    host_model = HybridLM(pcfg, torch.device("cpu"), torch.float32)
    host_model.load_state_dict(card_model.state_dict())
    sc = ServeConfig(batch=SERVE_BATCH, s_max=S_MAX)
    seen = {}
    with patched(ops, first_card_calls(seen), ("flash_fwd",)):
        err, mag, compared, equal = check_parity(
            CheckedEngine(pcfg, card_model, sc, device=dev),
            CheckedEngine(pcfg, host_model, sc, device="cpu"), tokens)
    res = {"layers": HYBRID_PARITY_LAYERS,
           "applications": sum(lm_mod.shared_flags(pcfg)),
           "steps": PARITY_STEPS, "prompt": int(tokens.shape[1]),
           "tol": PARITY_TOL, "max_abs_err": err, "max_abs_logit": mag,
           "ids_compared": compared, "ids_equal": equal,
           "flash_fwd": check_flash_fwd(seen["flash_fwd"][0])}
    del seen, card_model, host_model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res["s"] = time.perf_counter() - t0
    return res


def hybrid_phase(paper, dev, smi: str, ssd_n128_ms: float) -> dict:
    """The hybrid phase (see the head comment); every check fatal."""
    t_phase = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    serve, caps, eng, groups = hybrid_serve(cfg, paper, dev)
    log(f"[hybrid] {HYBRID_ARCH} {cfg.n_layers} layers (the shared block "
        f"before {serve['shared_applications']} of them), "
        f"{serve['params']} params on the card in {serve['init_s']:.1f} s; "
        f"{serve['requests']} requests (prompts {serve['prompt_lens']}), "
        f"{serve['tokens']} tokens in {serve['serve_s']:.3f} s = "
        f"{serve['tokens_per_s']:.1f} tokens/s; launches "
        f"{serve['launches']}; replan {serve['replan_s'] * 1e3:.1f} ms, "
        f"schedule {serve['schedule']} | {smi}")
    log("[hybrid] prefill ms per group: " + ", ".join(
        f"{p:.2f} (S={s})" for p, s in zip(serve["prefill_ms"],
                                           serve["group_lens"]))
        + f"; decode ms per step: median {serve['decode_ms_median']:.3f}, "
        f"p90 {serve['decode_ms_p90']:.3f}; peak device memory "
        f"{serve['peak_bytes'] / 2**30:.3f} GiB")
    log("[hybrid] ids: " + "; ".join(f"{k}: {v[:6]}" for k, v in
                                     sorted(serve["out"].items())[:3]))
    # where the device time goes, after the counted run: group 1's
    # prefill, then one decode step, under the profiler
    toks = eng.batch_tokens(groups[0])
    prof = {"prefill": device_kernels(lambda: eng.prefill(toks))}
    nxt = eng.prefill(toks)
    prof["decode"] = device_kernels(lambda: eng.decode(nxt))
    prof["prefill"]["busy_share"] = prof["prefill"]["device_ms"] / \
        serve["prefill_ms"][0]
    prof["decode"]["busy_share"] = prof["decode"]["device_ms"] / \
        serve["decode_ms_median"]
    serve["profile"] = prof
    for phase, pr in prof.items():
        log(f"[hybrid] profile {phase}: {pr['kernels']} device kernels, "
            f"{pr['device_ms']:.2f} ms ({pr['busy_share']:.1%} of the "
            f"untraced wall time); by kind " + ", ".join(
                f"{k} {v:.2f}" for k, v in pr["by_kind"].items()) +
            "; top: " + ", ".join(f"{t['name']} x{t['count']} "
                                  f"{t['ms']:.2f}" for t in pr["top"]))
    kernels = hybrid_kernels(caps, cfg, smi, ssd_n128_ms)
    del eng, caps
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    parity = hybrid_parity(dev, cfg, toks)
    log(f"[hybrid] parity {HYBRID_PARITY_LAYERS} layers f32 (the shared "
        f"block {parity['applications']} times), prompt {parity['prompt']} "
        f"x{SERVE_BATCH}, prefill + {PARITY_STEPS} decode steps: logits "
        f"within {PARITY_TOL} of the host (max |diff| "
        f"{parity['max_abs_err']:.3e}, max |logit| "
        f"{parity['max_abs_logit']:.3f}); ids equal on "
        f"{parity['ids_compared']} clear top-2 gaps ({parity['ids_equal']} "
        f"of {(PARITY_STEPS + 1) * SERVE_BATCH} equal in all); flash_fwd "
        f"{parity['flash_fwd']['shape']} f32 within "
        f"{parity['flash_fwd']['out']['err']:.3g} of its tolerance; "
        f"{parity['s']:.1f} s")
    out = {"serve": serve, "kernels": kernels, "parity": parity,
           "s": time.perf_counter() - t_phase}
    log(f"[hybrid] phase {out['s']:.2f} s")
    return out


# ----------------------------------------------------------------------
# moe phase
# ----------------------------------------------------------------------
MOE_ARCH = "granite-moe-1b-a400m"
MOE_KERNELS = ("moe_slots", "moe_dispatch", "moe_combine")
MOE_KERNEL_NAMES = ("moe_slots_kernel", "moe_dispatch_kernel",
                    "moe_combine_kernel", "moe_dispatch_bwd_kernel",
                    "moe_combine_bwd_kernel", "moe_gates_bwd_kernel")
# the MoE layer's backward kernels (the dispatch's, the combine's in ob
# and in its gates)
MOE_BWD_KERNELS = ("moe_dispatch_bwd", "moe_combine_bwd", "moe_gates_bwd")
# the kernels the MoE serve launches, and those it must not
MOE_COUNTED = MOE_KERNELS + ("silu_gate", "flash_fwd", "rf_predict",
                             "flash_bwd", "silu_gate_bwd", "ssd_chunk",
                             "silu") + MOE_BWD_KERNELS
MOE_PLAIN = {"moe_slots": moe_slots_ref,
             "moe_dispatch": moe_dispatch_gather_ref,
             "moe_combine": moe_combine_ref,
             "moe_dispatch_bwd": moe_dispatch_bwd_ref,
             "moe_combine_bwd": lambda dy, gates, eidx, pos_c, keep, src:
             moe_combine_bwd_ref(dy, gates, eidx, pos_c, keep, *src.shape),
             "moe_gates_bwd": moe_gates_bwd_ref}
MOE_PARITY_LAYERS = PARITY_LAYERS
# the MoE layer's steps, each run inside a profiler range of its label:
# (module, attribute, label); the model looks each up at call time
MOE_STEPS = ((moe_mod, "router_logits", "moe_router"),
             (moe_mod, "route", "moe_softmax_topk"),
             (ops, "moe_slots", "moe_slots"),
             (ops, "moe_dispatch", "moe_dispatch"),
             (moe_mod, "experts", "moe_experts"),
             (ops, "moe_combine", "moe_combine"))
def moe_capture(step) -> dict:
    """Run `step` (the MoE engine's prefill or decode) and return the
    first call's (args, kwargs) of each kernel wrapper of its path:
    `moe_slots`, `moe_dispatch`, `moe_combine` and `silu_gate` (layer
    0's MoE) and `flash_fwd` (layer 0's attention, prefill only)."""
    seen = {}
    with patched(ops, first_calls(seen), MOE_KERNELS + ("silu_gate",
                                                         "flash_fwd")):
        step()
    return seen


def moe_serve(cfg, paper, dev) -> tuple:
    """The moe phase's serve: `serve_counted` with the MoE captures; per
    step one moe_slots, moe_dispatch, moe_combine and silu_gate a layer
    (G = 1), per prefill one flash_fwd a layer, no other kernel."""
    def want_of(n_prefill, n_steps):
        want = dict.fromkeys(MOE_COUNTED, 0)
        want.update({name: n_steps * cfg.n_layers
                     for name in MOE_KERNELS + ("silu_gate",)})
        want.update({"flash_fwd": n_prefill * cfg.n_layers,
                     "rf_predict": 1})
        return want, (f"per step one moe_slots, moe_dispatch, moe_combine "
                      f"and silu_gate a layer ({n_steps} steps x "
                      f"{cfg.n_layers}), per prefill one flash_fwd a layer "
                      f"({n_prefill}) and none in decode, 1 rf_predict, no "
                      f"other kernel")
    return serve_counted(cfg, paper, dev, moe_capture, MOE_COUNTED, want_of)


def moe_bits(t: torch.Tensor) -> torch.Tensor:
    """t's bits as integers (an equality of bits, -0.0 apart from +0.0);
    integers and booleans as they are."""
    if not t.is_floating_point():
        return t
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def moe_info(name: str, args, out) -> dict:
    """A case's shape, dtype, tokens and dropped choices (moe_slots from
    its keep, the others from the routing's keep) or empty slots
    (moe_dispatch)."""
    first = args[0]
    info = {"shape": list(first.shape),
            "dtype": str(first.dtype).replace("torch.", "")}
    if name == "moe_slots":
        info.update(T=int(first.shape[1]), dropped=int((~out[1]).sum()))
    elif name == "moe_dispatch":
        info.update(T=int(first.shape[0]), empty=int((args[1] < 0).sum()))
    else:
        keep = next(a for a in args if torch.is_tensor(a) and
                    a.dtype == torch.bool)
        info.update(T=int(keep.shape[0]), dropped=int((~keep).sum()))
    return info


def check_moe(name: str, args) -> dict:
    """`ops.<name>` (the kernel on the card) against its plain version on
    `args`: equal bit for bit (integer for integer: moe_slots' three
    outputs), finite, and two calls equal; raises otherwise. Returns the
    case's `moe_info`."""
    fn = getattr(ops, name)
    got, again = fn(*args), fn(*args)
    want = MOE_PLAIN[name](*args)
    sync(got[0].device if isinstance(got, tuple) else got.device)
    outs = zip(*(o if isinstance(o, tuple) else (o,)
                 for o in (got, want, again)))
    for g, w, a in outs:
        if g.shape != w.shape or g.dtype != w.dtype or (
                g.is_floating_point() and not torch.isfinite(g).all()):
            raise AssertionError(f"{name}: {g.dtype} {tuple(g.shape)} "
                                 f"against {w.dtype} {tuple(w.shape)}, "
                                 f"or non-finite values")
        if not torch.equal(moe_bits(g), moe_bits(w)):
            n = int((moe_bits(g) != moe_bits(w)).sum())
            raise AssertionError(f"{name} {tuple(g.shape)} {g.dtype}: "
                                 f"{n} elements differ from the plain "
                                 f"version")
        if not torch.equal(moe_bits(g), moe_bits(a)):
            raise AssertionError(f"{name}: two calls differ")
    return moe_info(name, args, got)


def moe_cases(caps) -> list:
    """(label, name, args) of every kernel case of the phase: each
    wrapper's layer-0 inputs at both prefills and a decode step (bf16,
    as served) and in f32; a dropping case (group 1's routing at half
    its capacity: its slots recounted by the plain version, ob cut to
    them); an odd T (group 1's less its last token: 2,563, its slots
    recounted); x with a row of -0.0 (the slots kernel's edges, E =
    160, k = 32, one expert and many groups, are the card tests'); and
    the combine's persistent grid's edges (`combine_edges`)."""
    out = []
    for step, cap in zip(("prefill1", "prefill2", "decode"), caps):
        for name in MOE_KERNELS:
            args = cap[name][0]
            out.append((step, name, args))
            if name != "moe_slots":
                out.append((f"{step} f32", name, tuple(
                    a.float() if torch.is_tensor(a) and a.is_floating_point()
                    and a.dtype != torch.float32 else a for a in args)))
    eidx3, E, C = caps[0]["moe_slots"][0]
    x, src = caps[0]["moe_dispatch"][0]
    ob, eidx, pos_c, keep, gates = caps[0]["moe_combine"][0]
    half = C // 2
    pos2, keep2, src2 = moe_slots_ref(eidx3, E, half)
    out.append(("drops", "moe_slots", (eidx3, E, half)))
    out.append(("drops", "moe_dispatch", (x, src2[0])))
    out.append(("drops", "moe_combine", (ob[:, :half].contiguous(), eidx,
                                         pos2[0], keep2[0], gates)))
    cut3 = eidx3[:, :-1].contiguous()
    pos3, keep3, src3 = moe_slots_ref(cut3, E, C)
    out.append(("ragged", "moe_slots", (cut3, E, C)))
    out.append(("ragged", "moe_dispatch", (x[:-1].contiguous(), src3[0])))
    out.append(("ragged", "moe_combine", (ob, cut3[0], pos3[0], keep3[0],
                                          gates[:-1].contiguous())))
    xz = x.clone()
    xz[1] = -0.0
    out.append(("negative zeros", "moe_dispatch", (xz, src)))
    out += [(label, "moe_combine", args) for label, args in
            combine_edges(ob, eidx, pos_c, keep, gates)]
    return out


def unaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of t on storage one element past 16-byte alignment (the
    kernels' element paths)."""
    store = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = store[1:].view(t.shape)
    out.copy_(t)
    return out


def wide_routing(T: int, E: int, C: int, dev, seed: int) -> tuple:
    """eidx, pos_c, keep [T, E] of T tokens that each choose all E
    experts (k = E, the kernels' widest at E = 32) in a seeded order,
    the slots counted at capacity C."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    eidx = torch.argsort(torch.rand(T, E, generator=g), dim=1).to(dev)
    pos_c, keep, _ = moe_slots_ref(eidx[None], E, C)
    return eidx, pos_c[0], keep[0]


def combine_edges(ob, eidx, pos_c, keep, gates) -> list:
    """(label, args) of moe_combine's persistent grid's edges on group
    1's layer-0 inputs: one token, one token more than the grid's groups
    hold, every token choosing all 32 experts (k = 32, 300 tokens), rows
    of 2,048 (ob and its mirror side by side) and ob one element past
    16-byte alignment."""
    E, C, d = ob.shape
    T = min(moe_kernels.combine_workers(d, ob.dtype) + 1 if ob.is_cuda
            else 2, eidx.shape[0])
    e32, p32, k32 = wide_routing(300, E, C, ob.device, seed=32)
    g32 = torch.rand(300, E, generator=torch.Generator(
        device="cpu").manual_seed(33)).to(ob.device)
    return [("one token", (ob, eidx[:1], pos_c[:1], keep[:1], gates[:1])),
            (f"T = groups + 1 = {T}",
             (ob, eidx[:T], pos_c[:T], keep[:T], gates[:T])),
            (f"k = {E}", (ob, e32, p32, k32, g32)),
            (f"d = {2 * d}", (torch.cat([ob, ob.flip(-1)], -1), eidx, pos_c,
                           keep, gates)),
            ("unaligned", (unaligned(ob), eidx, pos_c, keep, gates))]


def moe_bound(name: str, args):
    """(ms, bound_by, bytes, ops) of one call on these inputs: its inputs
    read once as this routing needs them and its outputs written once.
    moe_slots reads the experts (8 B a choice) and writes pos_c (8 B),
    keep (1 B) and src (4 B a slot); moe_dispatch reads the rows of the
    tokens some slot names and src (4 B a slot) and writes the buffer.
    The other four read keep (1 B) of every choice they look at and, of
    a kept choice only, its eidx and pos_c (8 B each) and its gate (4 B)
    where the function takes one: moe_combine reads the kept choices'
    rows of ob (each its own slot) and their gates, writes y, and takes
    a product and an add an element of a kept row (f32 rate);
    moe_dispatch_bwd reads the same rows and no gate, and takes an add
    an element; moe_combine_bwd reads src, the rows of the tokens some
    slot names and those tokens' choices, and writes every slot;
    moe_gates_bwd reads dy and the kept rows of ob, and writes an f32 a
    choice."""
    if name == "moe_slots":
        eidx, E, C = args
        nbytes = eidx.numel() * 17 + eidx.shape[0] * E * C * 4
        nops = 0
    elif name == "moe_dispatch":
        x, src = args
        e, d = x.element_size(), x.shape[1]
        rows = int(torch.unique(src[src >= 0]).numel())
        nbytes = rows * d * e + src.numel() * 4 + src.numel() * d * e
        nops = 0
    elif name in ("moe_combine", "moe_dispatch_bwd"):
        ob, keep = args[0], args[3]
        T, k = keep.shape
        e, d = ob.element_size(), ob.shape[2]
        kept = int(keep.sum())
        gated = name == "moe_combine"
        nbytes = kept * d * e + T * k + kept * (16 + 4 * gated) + T * d * e
        nops = (2 if gated else 1) * kept * d
    elif name == "moe_combine_bwd":
        dy, keep, src = args[0], args[4], args[5]
        T, k = keep.shape
        e, d = dy.element_size(), dy.shape[1]
        rows = int(torch.unique(src[src >= 0]).numel())
        kept = int(keep.sum())
        nbytes = (rows * d * e + src.numel() * (4 + d * e) + rows * k +
                  kept * 20)
        nops = kept * d
    else:                                           # moe_gates_bwd
        dy, ob, keep = args[0], args[1], args[4]
        T, k = keep.shape
        e, d = ob.element_size(), ob.shape[2]
        kept = int(keep.sum())
        nbytes = kept * d * e + T * d * e + T * k * (1 + 4) + kept * 16
        nops = 2 * kept * d
    return roofline(nbytes, nops) + (nbytes, nops)


def dispatch_library(args):
    """One PyTorch call that computes moe_dispatch's buffer: an
    `index_select` of x's rows, padded with one zero row, by the same
    src (the pad's index for an empty slot; the index is built here,
    outside the timed call). It copies a -0.0 as it is."""
    x, src = args
    T, d = x.shape
    idx = torch.where(src < 0, T, src).reshape(-1).long()
    xpad = torch.cat([x, x.new_zeros((1, d))])
    return lambda: torch.index_select(xpad, 0, idx)


def bag_library(name: str, args):
    """(call, text): one PyTorch call that computes the MoE kernel's
    function up to rounding, its inputs built here, outside the timed
    call: `F.embedding_bag(..., mode="sum", per_sample_weights=...)`
    over the flat slots, with bags of the token's k slots (moe_combine:
    weights the gates, 0 for a dropped choice; moe_dispatch_bwd: keep)
    or of one slot's token (moe_combine_bwd: dy padded with a zero row,
    weights each slot's gate); None and the reason where there is none
    (moe_gates_bwd: no single call gathers the kept rows and takes their
    products with dy) or the call refuses bf16 on the card; any other
    error raises."""
    bag = torch.nn.functional.embedding_bag
    if name in ("moe_combine", "moe_dispatch_bwd"):
        table, eidx, pos_c, keep = args[:4]
        E, C, d = table.shape
        idx = eidx * C + pos_c
        w = (torch.where(keep, args[4], 0.0) if name == "moe_combine" else
             keep.float()).to(table.dtype)
        flat = table.view(E * C, d)

        def call():
            return bag(idx, flat, mode="sum", per_sample_weights=w)
    elif name == "moe_combine_bwd":
        dy, gates, eidx, pos_c, keep, src = args
        T, d = dy.shape
        E, C = src.shape
        slot = (eidx * C + pos_c)[keep]
        w = torch.zeros(E * C, dtype=torch.float32, device=dy.device)
        w[slot] = gates[keep]
        w = w.to(dy.dtype).view(-1, 1)
        idx = torch.where(src < 0, T, src).reshape(-1, 1).long()
        dpad = torch.cat([dy, dy.new_zeros((1, d))])

        def call():
            return bag(idx, dpad, mode="sum", per_sample_weights=w)
    else:
        return None, ("none (no single PyTorch call gathers the kept rows "
                      "and takes their products with dy)")
    try:
        call()
        sync(args[0].device)
    except RuntimeError as e:
        if "not implemented for 'BFloat16'" not in str(e):
            raise
        return None, f"embedding_bag refused bf16 on the card: {e}"
    return call, "embedding_bag (per_sample_weights)"


def time_moe(name: str, args, floor_ms: float) -> dict:
    """Device ms of the wrapper's call (one launch; a CUDA graph of 20
    calls, median of 11 replays) beside its plain version (device ms of
    its eager ops a call), the library call (moe_dispatch:
    `index_select` by the same src; moe_combine and the backwards:
    `bag_library`'s `embedding_bag`; each read in turns with the kernel:
    kernel, library, library, kernel; moe_slots and moe_gates_bwd:
    none), the bound and the launch floor."""
    fn = getattr(ops, name)
    bms, by, nbytes, nops = moe_bound(name, args)
    res = dict(moe_info(name, args, fn(*args)),
               plain_ms=device_ms(lambda: MOE_PLAIN[name](*args),
                                  launches=2, reps=3),
               bound_ms=bms, bound_by=by, bytes=nbytes, ops=nops,
               launch_floor_ms=floor_ms, library_ms=None)
    if name == "moe_dispatch":
        lib, res["library"] = dispatch_library(args), "index_select"
    elif name == "moe_slots":
        lib, res["library"] = None, ("none (no single PyTorch call counts "
                                     "the slots)")
    else:
        lib, res["library"] = bag_library(name, args)
    if lib is not None:
        got = fn(*args)
        other = lib().view(got.shape)
        if name == "moe_dispatch":
            res["library_equal"] = bool(torch.equal(other, got))
        else:
            res["library_max_abs_diff"] = float(
                (other.float() - got.float()).abs().max())
        times = {"kernel": [], "library": []}
        for which in ("kernel", "library", "library", "kernel"):
            times[which].append(graph_ms(
                (lambda: fn(*args)) if which == "kernel" else lib))
        res["ms"] = float(np.mean(times["kernel"]))
        res["library_ms"] = float(np.mean(times["library"]))
    else:
        res["ms"] = graph_ms(lambda: fn(*args))
    return res


def moe_case_text(t: dict) -> str:
    """A case's shape, dtype, tokens and drops (or empty slots), for the
    log."""
    return (f"{t['shape']} {t['dtype']} (T={t['T']}, " +
            (f"{t['empty']} empty slots)" if "empty" in t else
             f"{t['dropped']} choices dropped)"))


def log_moe(tag: str, name: str, t: dict, checks: list, smi: str,
            phase: str = "moe") -> None:
    log(f"[{phase}] {name} {tag} {moe_case_text(t)}: "
        f"{'integer' if name == 'moe_slots' else 'bit'}-equal to plain in "
        f"{len(checks)} cases, two calls equal | kernel {t['ms']:.5f} ms "
        f"(device, graph of 20 calls) | plain {t['plain_ms']:.4f} ms | "
        f"bound {t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes']} B, "
        f"{t['ops']} ops) | launch floor {t['launch_floor_ms']:.5f} ms | "
        f"library call: " + moe_library_text(t) + f" | {smi}")


def moe_library_text(t: dict) -> str:
    """The library call's time and agreement with the kernel, or why
    there is none."""
    if t["library_ms"] is None:
        return t["library"]
    agree = f"equal: {t['library_equal']}" if "library_equal" in t else \
        f"max |diff| {t['library_max_abs_diff']:.3g}, rounding otherwise"
    return f"{t['library']} {t['library_ms']:.5f} ms ({agree})"


def range_kernels(events, label: str, seen: set) -> dict:
    """{kernel name: device ms} of the kernels launched by the CPU ops
    under every range named `label` (each op once; a kernel record
    already in `seen` not again)."""
    out = {}
    stack = [e for e in events if e.name == label and
             e.device_type == torch.autograd.DeviceType.CPU]
    visited = set()
    while stack:
        e = stack.pop()
        if id(e) in visited:
            continue
        visited.add(id(e))
        for kn in e.kernels:
            if id(kn) in seen:
                continue
            seen.add(id(kn))
            out[kn.name] = out.get(kn.name, 0.0) + kn.duration / 1e3
        stack.extend(e.cpu_children)
    return out


def moe_profile(fn) -> dict:
    """Run `fn` under `torch.profiler` (CPU and CUDA activity) with each
    MoE step (`MOE_STEPS`) and the attention core (`ATTN_CORE`) inside a
    `record_function` range, and return the device ms by kind: the MoE
    layer's router product, softmax and top-k (the kernels of the torch
    ops in each range), the slots, the dispatch, the gate and the
    combine (their kernels by name), the three expert products (the
    products in the experts' range); the flash kernels and the attention
    core's other kernels; the other matrix products (projections,
    lm_head); the rest; the kernels run and the five longest by total
    time; and the kernels of a cumulative sum (the eager positions'
    count: none is left on the path)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def annotate(label):
        def wrap(name, f):
            def call(*a, **k):
                with record_function(label):
                    return f(*a, **k)
            call.launches = 0
            return call
        return wrap

    with contextlib.ExitStack() as stack:
        for mod, attr, label in MOE_STEPS:
            stack.enter_context(patched(mod, annotate(label), (attr,)))
        stack.enter_context(patched(att, annotate(ATTN_LABEL), ATTN_CORE))
        prof = stack.enter_context(profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    labels = {label for _, _, label in MOE_STEPS} | {ATTN_LABEL}
    total, n_kernels, by_name, matmul, flash = 0.0, 0, {}, 0.0, 0.0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False) or e.name in labels:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        total += ms
        n_kernels += 1
        flash += ms if is_flash(e.name) else 0.0
        matmul += ms if any(k in e.name.lower() for k in MATMUL_KEYS) \
            else 0.0
        ms0, n0 = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms0 + ms, n0 + 1)
    seen = set()
    per = {label: range_kernels(events, label, seen)
           for _, _, label in MOE_STEPS}
    attn = range_kernels(events, ATTN_LABEL, seen)
    # the hand-written kernels launch through ctypes, outside any torch
    # op, so the profiler ties them to no range: they are read by name
    def named(key):
        return sum(ms for k, (ms, _) in by_name.items() if key in k)
    kinds = {"router": sum(per["moe_router"].values()),
             "softmax_topk": sum(per["moe_softmax_topk"].values()),
             "slots": named("moe_slots_kernel"),
             "dispatch": named("moe_dispatch_kernel"),
             "expert_products": sum(
                 v for k, v in per["moe_experts"].items()
                 if any(m in k.lower() for m in MATMUL_KEYS)),
             "gate": named("silu_gate"),
             "combine": named("moe_combine_kernel"),
             "flash_kernels": flash,
             "attention_plain": sum(v for k, v in attn.items()
                                    if not is_flash(k))}
    in_moe_mm = kinds["expert_products"] + sum(
        v for k, v in per["moe_router"].items()
        if any(m in k.lower() for m in MATMUL_KEYS))
    in_attn_mm = sum(v for k, v in attn.items()
                     if any(m in k.lower() for m in MATMUL_KEYS))
    kinds["other_matmul"] = matmul - in_moe_mm - in_attn_mm
    kinds["rest"] = total - sum(kinds.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"device_ms": total, "kernels": n_kernels, "by_kind": kinds,
            "scan_kernels": {k: n for k, (_, n) in by_name.items()
                             if "tensor_kernel_scan" in k or
                             "DeviceScan" in k},
            "moe_range_calls": {
                label: sum(1 for e in events if e.name == label and
                           e.device_type == torch.autograd.DeviceType.CPU)
                for _, _, label in MOE_STEPS},
            "top": [{"ms": ms, "count": n, "name": k[:60]}
                    for k, (ms, n) in top]}


def plain_calls(name, fn):
    """A `patched` wrapper that runs the plain version of a MoE kernel
    wrapper in its place (on the card: the reference's k-loop as eager
    ops)."""
    def call(*args, **kw):
        return MOE_PLAIN[name](*args)
    call.launches = 0
    return call


def moe_parity(dev, cfg, tokens: np.ndarray) -> dict:
    """`cfg` cut to MOE_PARITY_LAYERS in f32 on the card and on the host
    with the same weights, on `tokens`: prefill and PARITY_STEPS decodes
    (`check_parity`); the card's first `flash_fwd`, `moe_slots`,
    `moe_dispatch` and `moe_combine` calls (f32) against their plain
    versions."""
    t0 = time.perf_counter()
    pcfg = cfg.replace(n_layers=MOE_PARITY_LAYERS, dtype="float32")
    card_model = registry.build_model(
        pcfg, torch.Generator(device=dev).manual_seed(0), dev)
    host_model = MoeLM(pcfg, torch.device("cpu"), torch.float32)
    host_model.load_state_dict(card_model.state_dict())
    sc = ServeConfig(batch=SERVE_BATCH, s_max=S_MAX)
    seen = {}
    with patched(ops, first_card_calls(seen), ("flash_fwd",) + MOE_KERNELS):
        err, mag, compared, equal = check_parity(
            CheckedEngine(pcfg, card_model, sc, device=dev),
            CheckedEngine(pcfg, host_model, sc, device="cpu"), tokens)
    res = {"layers": MOE_PARITY_LAYERS, "steps": PARITY_STEPS,
           "prompt": int(tokens.shape[1]), "tol": PARITY_TOL,
           "max_abs_err": err, "max_abs_logit": mag,
           "ids_compared": compared, "ids_equal": equal,
           "flash_fwd": check_flash_fwd(seen["flash_fwd"][0])}
    for name in MOE_KERNELS:
        res[name] = check_moe(name, seen[name][0])
    del seen, card_model, host_model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res["s"] = time.perf_counter() - t0
    return res


def moe_phase(paper, dev, smi: str, floor_ms: float) -> dict:
    """The moe phase (see the head comment); every check fatal."""
    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the router's f32 product must "
                             "run in full f32")
    cfg = get_config(MOE_ARCH)
    serve, caps, eng, groups = moe_serve(cfg, paper, dev)
    serve["active_params"] = registry.active_param_count(cfg)
    log(f"[moe] {MOE_ARCH} {cfg.n_layers} layers, {cfg.moe.n_experts} "
        f"experts top-{cfg.moe.top_k}, {serve['params']} params "
        f"({serve['active_params']} active a token) on the card in "
        f"{serve['init_s']:.1f} s; {serve['requests']} requests (prompts "
        f"{serve['prompt_lens']}), {serve['tokens']} tokens in "
        f"{serve['serve_s']:.3f} s = {serve['tokens_per_s']:.1f} tokens/s; "
        f"launches {serve['launches']}; replan "
        f"{serve['replan_s'] * 1e3:.1f} ms, schedule {serve['schedule']} | "
        f"{smi}")
    log("[moe] prefill ms per group: " + ", ".join(
        f"{p:.2f} (S={s})" for p, s in zip(serve["prefill_ms"],
                                           serve["group_lens"]))
        + f"; decode ms per step: median {serve['decode_ms_median']:.3f}, "
        f"p90 {serve['decode_ms_p90']:.3f}; peak device memory "
        f"{serve['peak_bytes'] / 2**30:.3f} GiB")
    log("[moe] ids: " + "; ".join(f"{k}: {v[:6]}" for k, v in
                                  sorted(serve["out"].items())[:3]))
    # where the device time goes, after the counted run: group 1's
    # prefill and one decode step under the profiler, the MoE layer's
    # steps in ranges; then the kernels of one decode step with the
    # kernels and with their plain versions in their place
    toks = eng.batch_tokens(groups[0])
    prof = {"prefill": moe_profile(lambda: eng.prefill(toks))}
    nxt = eng.prefill(toks)
    prof["decode"] = moe_profile(lambda: eng.decode(nxt))
    prof["prefill"]["busy_share"] = prof["prefill"]["device_ms"] / \
        serve["prefill_ms"][0]
    prof["decode"]["busy_share"] = prof["decode"]["device_ms"] / \
        serve["decode_ms_median"]
    nxt = eng.prefill(toks)
    with patched(ops, plain_calls, MOE_KERNELS):
        plain_step = device_kernels(lambda: eng.decode(nxt))
    prof["decode"]["plain_kernels"] = plain_step["kernels"]
    prof["decode"]["plain_device_ms"] = plain_step["device_ms"]
    serve["profile"] = prof
    for phase, pr in prof.items():
        if pr["scan_kernels"] or not pr["by_kind"]["slots"]:
            raise AssertionError(
                f"moe {phase}: cumulative-sum kernels {pr['scan_kernels']} "
                f"ran (the eager positions' count), or no moe_slots_kernel "
                f"ran ({pr['by_kind']['slots']} ms)")
    for phase, pr in prof.items():
        log(f"[moe] profile {phase}: {pr['kernels']} device kernels, "
            f"{pr['device_ms']:.3f} ms ({pr['busy_share']:.1%} of the "
            f"untraced wall time); by kind " + ", ".join(
                f"{k} {v:.3f}" for k, v in pr["by_kind"].items()) +
            f"; MoE ranges a run {pr['moe_range_calls']}; cumulative sums "
            f"{pr['scan_kernels']}; top: " +
            ", ".join(f"{t['name']} x{t['count']} {t['ms']:.3f}"
                      for t in pr["top"]))
    log(f"[moe] a decode step launches {prof['decode']['kernels']} kernels "
        f"with the MoE kernels, {plain_step['kernels']} with their plain "
        f"versions in their place ({plain_step['device_ms']:.3f} device "
        f"ms)")
    # the three kernels against their plain versions, bit for bit,
    # timed at group 1's prefill and a decode step; the dispatch's plain
    # gather against the reference's k scatter-adds once
    x, src = caps[0]["moe_dispatch"][0]
    _, eidx, pos_c, keep, _ = caps[0]["moe_combine"][0]
    E, C = src.shape
    if not torch.equal(moe_bits(moe_dispatch_gather_ref(x, src)),
                       moe_bits(moe_dispatch_ref(x, eidx, pos_c, keep, E,
                                                 C))):
        raise AssertionError("the plain gather dispatch differs from the "
                             "reference's scatter-adds at group 1")
    checks = {name: [] for name in MOE_KERNELS}
    for label, name, args in moe_cases(caps):
        c = check_moe(name, args)
        c["case"] = label
        checks[name].append(c)
    kernels = {}
    for name in MOE_KERNELS:
        t = {"prefill1": time_moe(name, caps[0][name][0], floor_ms),
             "decode": time_moe(name, caps[2][name][0], floor_ms)}
        kernels[name] = {"checks": checks[name], "timing": t,
                         "max_abs_err": 0.0}
        for tag, tt in t.items():
            log_moe(tag, name, tt, checks[name], smi)
        log(f"[moe] {name} cases: " + "; ".join(
            f"{c['case']} {moe_case_text(c)}" for c in checks[name]))
    # the expert gate (silu_gate, value only) bit-equal at the MoE's
    # shapes, timed at group 1's prefill
    gate_errs = [check_silu("silu_gate", *cap["silu_gate"]) for cap in caps]
    gate = time_silu("silu_gate", *caps[0]["silu_gate"])
    gate["max_abs_err"] = max(gate_errs)
    kernels["silu_gate"] = gate
    log(f"[moe] silu_gate {gate['shape']} {gate['dtype']} (value only: "
        f"{gate['value_only']}): bit-equal to plain at both prefills and a "
        f"decode step; kernel {gate['ms']:.5f} ms | plain "
        f"{gate['plain_ms']:.5f} ms | bound {gate['bound_ms']:.5f} ms by "
        f"{gate['bound_by']} ({gate['bytes']} B) | library call: "
        f"{lib_text(gate)} | {smi}")
    # flash_fwd at head dim 64 ([4,16,1,S,64] bf16) at both prefills,
    # timed at group 1's beside SDPA and the bound
    fchecks = [check_flash_fwd(cap["flash_fwd"][0]) for cap in caps[:2]]
    fargs = caps[0]["flash_fwd"][0]
    two_calls_equal(lambda: ops.flash_fwd(*fargs), "flash_fwd")
    ft = time_flash_fwd(fargs, cfg.n_kv_heads)
    kernels["flash_fwd"] = {"checks": fchecks, "timing": ft,
                            "max_err": max(c["out"]["err"] for c in fchecks)}
    log_flash("moe", "fwd", fchecks[0], ft, smi)
    log(f"[moe] flash_fwd {fchecks[1]['shape']} (group 2's prefill): out "
        f"within {fchecks[1]['out']['err']:.3g} of the tolerance "
        f"({fchecks[1]['out']['ulp_apart_share']:.4%} > 1 ulp), lse "
        f"{fchecks[1]['lse_max_abs_diff']:.3g}; two calls equal")
    del eng, caps
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    parity = moe_parity(dev, cfg, toks)
    log(f"[moe] parity {MOE_PARITY_LAYERS} layers f32, prompt "
        f"{parity['prompt']} x{SERVE_BATCH}, prefill + {PARITY_STEPS} "
        f"decode steps: logits within {PARITY_TOL} of the host (max |diff| "
        f"{parity['max_abs_err']:.3e}, max |logit| "
        f"{parity['max_abs_logit']:.3f}); ids equal on "
        f"{parity['ids_compared']} clear top-2 gaps ({parity['ids_equal']} "
        f"of {(PARITY_STEPS + 1) * SERVE_BATCH} equal in all); the card's "
        f"first flash_fwd {parity['flash_fwd']['shape']} f32 within "
        f"{parity['flash_fwd']['out']['err']:.3g} of its tolerance, "
        f"moe_slots {parity['moe_slots']['shape']} integer-equal, "
        f"moe_dispatch {parity['moe_dispatch']['shape']} and moe_combine "
        f"{parity['moe_combine']['shape']} f32 bit-equal; {parity['s']:.1f} s")
    out = {"serve": serve, "kernels": kernels, "parity": parity,
           "s": time.perf_counter() - t_phase}
    log(f"[moe] phase {out['s']:.2f} s")
    return out


# ----------------------------------------------------------------------
# mla phase
# ----------------------------------------------------------------------
MLA_ARCH = "minicpm3-4b"
# the attention core of MLA's absorbed decode step (plain torch over the
# latent cache); prefill's is the flash kernel, read by name
MLA_CORE = ("mla_decode_attention",)
# MLA's prefill: ranges around mla_forward and the functions it calls
# that are not its own body (the q projection and rope, the latent)
MLA_BODY, MLA_INNER = "mla_forward", ("mla_q", "mla_latent")
MLA_BODY_CASTS = 2      # c_kv to the compute dtype (v), W_uk to f32 (k_nope)


def mla_capture(step) -> dict:
    """Run `step` (the MLA engine's prefill or decode) and return the
    first call's inputs of `silu_gate`, `ops.flash_fwd_mla` and the
    attention core (`MLA_CORE`)."""
    seen = {}
    record = first_calls(seen)
    with patched(att, record, MLA_CORE), \
            patched(ops, record, ("flash_fwd_mla", "silu_gate")):
        step()
    return seen


def mla_body_ops(fn) -> dict:
    """Run `fn` (group 1's prefill) under `torch.profiler` with
    `mla_forward` and the functions it calls (MLA_INNER) in ranges, and
    count what mla_forward's own body launches: its `aten::cat` ops and
    casts (`aten::_to_copy`) and their device kernels; over the whole
    run, the concatenation kernels (CatArrayBatchedCopy), the flash
    kernels by name and all kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def annotate(label):
        def wrap(name, f):
            def call(*a, **k):
                with record_function(label):
                    return f(*a, **k)
            return call
        return wrap

    with patched(att, annotate(MLA_BODY), (MLA_BODY,)), \
            patched(att, annotate("mla_inner"), MLA_INNER), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    res = {"body_calls": 0, "body_cat": 0, "body_cast": 0,
           "body_cat_cast_kernels": 0}
    cpu = torch.autograd.DeviceType.CPU
    for e in events:
        if e.name != MLA_BODY or e.device_type != cpu:
            continue
        res["body_calls"] += 1
        stack = list(e.cpu_children)
        while stack:
            c = stack.pop()
            if c.name == "mla_inner":
                continue
            kind = {"aten::cat": "body_cat",
                    "aten::_to_copy": "body_cast"}.get(c.name)
            if kind:
                res[kind] += 1
                sub = [c]
                while sub:
                    d = sub.pop()
                    res["body_cat_cast_kernels"] += len(d.kernels)
                    sub.extend(d.cpu_children)
                continue
            stack.extend(c.cpu_children)
    kernels = [e.name for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and
               not getattr(e, "is_user_annotation", False) and
               e.name not in (MLA_BODY, "mla_inner")]
    res.update(kernels=len(kernels),
               cat_kernels=sum("CatArrayBatchedCopy" in n for n in kernels),
               split_kernels=sum("flash_split" in n for n in kernels),
               flash_kernels=sum("flash_fwd_wgmma" in n for n in kernels))
    return res


def flash_instance_report(instance: str = FLASH_MLA_INSTANCE) -> dict:
    """ptxas's registers and spills of one instance of flash_attn.cu's
    kernels, from nvcc's output kept beside the built library."""
    lib = build.library_path("flash_attn")
    log_file = lib.with_name(lib.name + ".nvcc.txt")
    return ptxas_report(log_file.read_text(), (instance,)).get(instance, {})


def mla_serve(cfg, paper, dev) -> tuple:
    """The mla phase's part (1): `serve_counted` with the MLA captures;
    one silu_gate a layer a step, one flash_fwd a layer a prefill."""
    def want_of(n_prefill, n_steps):
        return ({"silu_gate": n_steps * cfg.n_layers,
                 "flash_fwd": n_prefill * cfg.n_layers, "flash_bwd": 0,
                 "rf_predict": 1, "ssd_chunk": 0, "silu": 0},
                f"one silu_gate per layer per step ({n_steps} steps), one "
                f"flash_fwd per layer per prefill ({n_prefill}) and none "
                f"in decode (the absorbed step is plain torch), 1 "
                f"rf_predict, no ssd_chunk or silu")
    return serve_counted(cfg, paper, dev, mla_capture, DENSE_COUNTED,
                         want_of)


def sdpa_backend(q, k, v) -> str:
    """The backend SDPA's dispatcher picks for causal attention on these
    inputs (`torch._fused_sdp_choice`); the profiler cannot tell: a
    cuDNN attention call's kernels do not show in its events."""
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(q, k, v,
                                                  is_causal=True)).name
    except (AttributeError, TypeError, ValueError, RuntimeError) as e:
        return f"not read ({type(e).__name__})"


def time_mla_flash(args) -> dict:
    """`ops.flash_fwd_mla` on MLA's captured parts (q_nope [B,H,S,nd] a
    strided view and q_rope [B,H,S,rd] bf16, k_nope [B,H,S,nd] f32, the
    rope key [B,1,S,rd] bf16, v [B,H,S,Dv] bf16): device ms of the call
    (one kernel, a CUDA graph of 20 calls, so the wrapper's host work
    stays out), of its plain version,
    and of SDPA on the reference's concatenations q = [q_nope, q_rope]
    and k = [k_nope, k_rope] rounded to bf16, made outside the timing,
    and v, in turns with the kernel (the same function rounded
    otherwise), its backend read from its kernels; beside the bound at
    the parts' bytes: q's parts, k_nope (f32), the one rope key and v
    read once, out and lse written once; the products over the causal
    half, QK^T at Dq and PV at Dv, at the bf16 tensor-core rate
    (`split_ops`: the kernel's own second QK^T, for lo, over the nope
    columns, which the function does not need)."""
    q_nope, q_rope, k_nope, k_rope, v = args[:5]
    B, H, S, nd = q_nope.shape
    rd, Dv = q_rope.shape[3], v.shape[3]
    Dq = nd + rd
    nbytes = (B * H * S * Dq + k_rope.numel() + v.numel()) * 2 + \
        k_nope.numel() * 4 + B * H * S * (Dv * 2 + 4)
    used = keys_used(S, 0)
    bms, by, nb, nops = attention_bound(B, H, S, used, Dq, nbytes, Dv=Dv)
    q, k = mla_concatenated(args)
    qs, k16 = q[:, :, 0], k.to(torch.bfloat16)

    def call():
        return ops.flash_fwd_mla(*args)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, k16, v, is_causal=True)
    err, mag, rel = sdpa_diff(call()[0][:, :, 0], lib(), "mla prefill")
    ms, lib_ms = kernel_and_library_ms(call, lib)
    return {"ms": ms, "library_ms": lib_ms,
            "library_backend": sdpa_backend(qs, k16, v),
            "plain_ms": device_ms(lambda: flash_fwd_mla_ref(*args),
                                  launches=2, reps=3),
            "sdpa_max_abs_diff": err, "sdpa_max_abs_out": mag,
            "sdpa_max_row_rel_diff": rel,
            "bound_ms": bms, "bound_by": by, "bytes": nb, "ops": nops,
            "split_ops": 2 * B * H * S * used * nd}


def mla_phase(paper, dev, smi: str) -> dict:
    """The mla phase (see the head comment); every check fatal."""
    t_phase = time.perf_counter()
    cfg = get_config(MLA_ARCH)
    m = cfg.mla
    ops.flash_fwd.copies = 0
    serve, caps, eng, groups = mla_serve(cfg, paper, dev)
    # the parts are read where they lie: no operand copied dense
    serve["flash_fwd_copies"] = ops.flash_fwd.copies
    if ops.flash_fwd.copies:
        raise AssertionError(f"mla serve: flash_fwd_mla copied "
                             f"{ops.flash_fwd.copies} operands dense")
    log(f"[mla] {MLA_ARCH} {cfg.n_layers} layers, {cfg.n_heads} heads "
        f"(kv_lora {m.kv_lora_rank}, q_lora {m.q_lora_rank}, Dq "
        f"{m.qk_nope_head_dim}+{m.qk_rope_head_dim}, Dv {m.v_head_dim}), "
        f"{serve['params']} params on the card in {serve['init_s']:.1f} s; "
        f"{serve['requests']} requests (prompts {serve['prompt_lens']}), "
        f"{serve['tokens']} tokens in {serve['serve_s']:.3f} s = "
        f"{serve['tokens_per_s']:.1f} tokens/s; launches "
        f"{serve['launches']} (flash_fwd: {cfg.n_layers} a prefill x "
        f"{len(groups)}; silu_gate: {cfg.n_layers} a step); replan "
        f"{serve['replan_s'] * 1e3:.1f} ms, schedule {serve['schedule']} | "
        f"{smi}")
    log("[mla] prefill ms per group: " + ", ".join(
        f"{p:.2f} (S={s})" for p, s in zip(serve["prefill_ms"],
                                           serve["group_lens"]))
        + f"; decode ms per step: median {serve['decode_ms_median']:.3f}, "
        f"p90 {serve['decode_ms_p90']:.3f}; peak device memory "
        f"{serve['peak_bytes'] / 2**30:.3f} GiB")
    log("[mla] ids: " + "; ".join(f"{k}: {v[:6]}" for k, v in
                                  sorted(serve["out"].items())[:3]))
    # where the device time goes: group 1's prefill and 4 decode steps
    # again under the profiler, the attention core in ranges
    toks = eng.batch_tokens(groups[0])
    prof = {"prefill": dense_profile(lambda: eng.prefill(toks), MLA_CORE)}
    nxt = eng.prefill(toks)
    prof["decode"] = dense_profile(lambda: [eng.decode(nxt)
                                            for _ in range(PARITY_STEPS)],
                                   MLA_CORE)
    prof["prefill"]["busy_share"] = prof["prefill"]["device_ms"] / \
        serve["prefill_ms"][0]
    prof["decode"]["busy_share"] = prof["decode"]["device_ms"] / \
        PARITY_STEPS / serve["decode_ms_median"]
    prof["decode"]["kernels_per_step"] = prof["decode"]["kernels"] / \
        PARITY_STEPS
    serve["profile"] = prof
    for phase, pr in prof.items():
        log(f"[mla] profile {phase}: {pr['kernels']} device kernels, "
            f"{pr['device_ms']:.2f} ms ({pr['busy_share']:.1%} of the "
            f"untraced wall time), {pr['attention_ranges']} attention "
            f"calls; by kind " + ", ".join(
                f"{k} {v:.3f}" for k, v in pr["by_kind"].items()) +
            "; top: " + ", ".join(f"{t['name']} x{t['count']} "
                                  f"{t['ms']:.2f}" for t in pr["top"]))
    # what mla_forward's own body launches in group 1's prefill: no
    # concatenation, no cast for q or k, no split pass; one flash kernel
    # a layer
    body = mla_body_ops(lambda: eng.prefill(toks))
    serve["body_ops"] = body
    log(f"[mla] group 1's prefill: {body['kernels']} device kernels, "
        f"{body['cat_kernels']} concatenation kernels "
        f"(CatArrayBatchedCopy; apply_rope's), {body['flash_kernels']} "
        f"flash_fwd_wgmma, {body['split_kernels']} flash_split; "
        f"mla_forward's own body over {body['body_calls']} calls: "
        f"{body['body_cat']} aten::cat, {body['body_cast']} casts "
        f"(aten::_to_copy: c_kv to bf16 for v, W_uk to f32 for k_nope), "
        f"{body['body_cat_cast_kernels']} kernels of them; flash_fwd.copies "
        f"{serve['flash_fwd_copies']} in the serve | {smi}")
    # (the profiler may drop kernel events, so the flash kernels are held
    # to having run, and the launch count to one a layer)
    if body["body_cat"] or body["split_kernels"] or \
            body["body_cast"] != MLA_BODY_CASTS * body["body_calls"] or \
            not body["flash_kernels"] or body["body_calls"] != cfg.n_layers:
        raise AssertionError(f"mla prefill: mla_forward's body launched "
                             f"concatenations, casts or splits beyond its "
                             f"own, or no flash kernel: {body}")
    # (2) the flash kernel on layer 0's parts of both prefills (q's parts,
    # the rope key and v bf16, k_nope f32), twice equal, timed at group 1's
    fargs = caps[0]["flash_fwd_mla"][0]
    q_nope, q_rope, k_nope, k_rope, v = fargs[:5]
    if not (q_nope.dtype == q_rope.dtype == k_rope.dtype == v.dtype ==
            torch.bfloat16 and k_nope.dtype == torch.float32 and
            q_nope.shape[-1] == m.qk_nope_head_dim and
            tuple(k_rope.shape[1:]) == (1, q_nope.shape[2],
                                        m.qk_rope_head_dim) and
            v.shape[-1] == m.v_head_dim and not q_nope.is_contiguous()):
        raise AssertionError("mla flash parts: " + ", ".join(
            f"{t.dtype} {tuple(t.shape)} {t.stride()}" for t in fargs[:5]))
    fchecks = [check_flash_mla(cap["flash_fwd_mla"][0]) for cap in caps[:2]]
    two_calls_equal(lambda: ops.flash_fwd_mla(*fargs), "flash_fwd (mla)")
    ft = time_mla_flash(fargs)
    regs = flash_instance_report()
    if not regs or regs.get("spill_stores") or regs.get("spill_loads"):
        raise AssertionError(f"flash_fwd's MLA instance {FLASH_MLA_INSTANCE}:"
                             f" ptxas reports {regs}")
    flash = {"checks": fchecks, "timing": ft, "ptxas": regs,
             "max_err": max(c["out"]["err"] for c in fchecks)}
    serve["flash_fwd"] = flash
    log_flash("mla", "fwd", fchecks[0], ft, smi)
    log(f"[mla] flash_fwd {fchecks[1]['shape']} (group 2's prefill): out "
        f"within {fchecks[1]['out']['err']:.3g} of the tolerance "
        f"({fchecks[1]['out']['ulp_apart_share']:.4%} > 1 ulp), lse "
        f"{fchecks[1]['lse_max_abs_diff']:.3g} ({fchecks[1]['lse_err']:.3g} "
        f"of its tolerance, at most {fchecks[1]['lse_max_tol']:.3g} a row); "
        f"two calls equal")
    log(f"[mla] flash_fwd (one kernel a call): the split's second QK^T "
        f"(nope columns) {ft['split_ops']:.4g} ops beyond the bound's; SDPA "
        f"(q, bf16(k), v) {ft['library_ms']:.5f} ms by "
        f"{ft['library_backend']}, largest row off "
        f"{ft['sdpa_max_row_rel_diff']:.4g} of its max; the MLA instance "
        f"(ptxas): " + ", ".join(f"{k} {v}" for k, v in regs.items()) +
        f" | {smi}")
    # the SwiGLU gate bit-equal at both prefills and a decode step
    gate_errs = [check_silu("silu_gate", *cap["silu_gate"]) for cap in caps]
    serve["silu_gate_max_abs_err"] = max(gate_errs)
    del eng, caps
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # (3) parity: 2 layers in f32 (the f32 kernel at Dq 96, Dv 64)
    parity = dense_parity(dev, [cfg])[MLA_ARCH]
    log(f"[mla] parity {PARITY_LAYERS} layers f32, prompt "
        f"{parity['prompt']} x{SERVE_BATCH}, prefill + {PARITY_STEPS} "
        f"decode steps: logits within {PARITY_TOL} of the host (max |diff| "
        f"{parity['max_abs_err']:.3e}, max |logit| "
        f"{parity['max_abs_logit']:.3f}); ids equal on "
        f"{parity['ids_compared']} clear top-2 gaps ({parity['ids_equal']} "
        f"of {(PARITY_STEPS + 1) * SERVE_BATCH} equal in all); the card's "
        f"first flash_fwd {parity['flash_fwd']['shape']} f32 within "
        f"{parity['flash_fwd']['out']['err']:.3g} of its tolerance, lse "
        f"{parity['flash_fwd']['lse_max_abs_diff']:.3g}; {parity['s']:.1f} s")
    out = {"serve": serve, "parity": parity,
           "s": time.perf_counter() - t_phase}
    log(f"[mla] phase {out['s']:.2f} s")
    return out


# ----------------------------------------------------------------------
# train phase
# ----------------------------------------------------------------------
TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 1024
# the reference training CLI's optimizer (src/repro/launch/train.py:
# lr 3e-4, the default 100-step warm-up): at full size its loss falls
# step by step, where a 2-step warm-up makes it jump (PERF.md, PR 22)
TRAIN_OPT = dict(lr=3e-4)
TRAIN_COUNTED = ("silu_gate", "silu_gate_bwd", "flash_fwd", "flash_bwd",
                 "rf_predict", "quantize", "dequantize", "ssd_chunk",
                 "silu") + SSM_BWD + MOE_KERNELS + MOE_BWD_KERNELS
# part (7): the MoE family's forward kernels (twice a layer a step under
# remat "full") and backward kernels (once)
MOE_TRAIN_FWD = MOE_KERNELS + DENSE_FWD
MOE_TRAIN_BWD = MOE_BWD_KERNELS + DENSE_BWD
MOE_POD_LAYERS = 8              # of 24: 4 pods' f32 state, ~34 GB
MOE_TRAIN_PARITY_LAYERS = 2
# part (8): MLA (minicpm3-4b) trained at full width, cut in depth to
# what the card holds here with 2 GiB free (PERF.md section 4: f32
# parameters, gradients and AdamW's moments at 16 B a parameter and the
# bf16 copy at 2; 58 layers peak at 75.24 GiB of 79.18 in a process of
# their own but ran out after parts (1)-(7), the allocator's cache
# fragmented; 56 ran after them at 72.96), the 4-pod run to 2 layers
# (76.2 GiB: its AdamW temporaries on the 4 pods' [4, 73448, 2560]
# embeddings; 3 layers ran out)
MLA_TRAIN_LAYERS = 56           # of 62
MLA_POD_LAYERS = 2              # of 62
MLA_TRAIN_PARITY_LAYERS = 2
MLA_RAGGED_S = 1000             # a ragged S for flash_bwd_mla's check
LOAD_SUM_TOL = 1e-6             # a step's expert_load over the layers
# part (5): the ssm family trained as part (1) trains the dense one
SSM_TRAIN_ARCH = ARCH
SSD_BWD_TOL = 1e-4              # of max |g|: the kernels vs plain

PARITY_BATCH = 1
# keys of the card-against-host step: h2o-danube-1.8b at the train run's
# 1,024, where flash walks 2 key blocks of 512 forward and in its VJP
# (the 4,096 window not reached); llama3-8b and qwen3-4b (the same flash
# code) at one block of 64: their large heads and AdamW dominate the
# host's step (PERF.md, PR 22)
# and mamba2-2.7b (part (5)) at 2 chunks of 256
# and zamba2-2.7b (part (6)) as mamba2-2.7b, flash over 2 key blocks
PARITY_SEQ = {"h2o-danube-1.8b": TRAIN_SEQ, SSM_TRAIN_ARCH: 512,
              HYBRID_ARCH: 512, MOE_ARCH: 512}
PARITY_SEQ_OTHER = 64
# the kernels whose first card call a parity step holds to plain
PARITY_CHECKED = {"dense": ("flash_fwd", "flash_bwd"),
                  "ssm": ("ssd_chunk_bwd",),
                  "hybrid": ("flash_fwd", "flash_bwd", "ssd_chunk_bwd"),
                  "moe": ("flash_fwd", "flash_bwd") + MOE_BWD_KERNELS,
                  "mla": ("flash_fwd_mla", "flash_bwd_mla")}
# the first step's compressed sync is redone on the host for every leaf
# of at most this many elements a pod (the attention's and the norms':
# all part layouts of the sync but the largest leaves')
HOST_SYNC_MAX = 32 << 20
GRAD_PARITY_TOL = 1e-3          # of each leaf's max |g|, card vs host
POD_LAYERS = 4                  # of 24: 4 pods' f32 state at 16 B a parameter
POD_STEPS, POD_BATCH, POD_FAIL_AT, POD_CKPT_EVERY = 8, 8, 4, 3
ATTN_FWD, ATTN_BWD, XENT, OPTIM = ("attention_fwd", "attention_bwd",
                                   "cross_entropy", "optimizer")
# the hybrid's shared block: its attention (`gqa_forward`) and its MLP
# (`transformer._mlp`: the residual sum, ln2, SwiGLU) in ranges of their
# own, forward and recompute; their backward nodes found by the forward
# ops' sequence numbers
SHARED_ATTN, SHARED_MLP = "shared_attention", "shared_mlp"
# the MoE layer's routing (the router's product, softmax, the top k and
# its renormalisation: `router_logits` and `route`) and its expert
# products (`experts`, less the gate's kernel) in ranges of their own,
# forward and recompute, their backward nodes found as the shared
# block's
MOE_ROUTING, MOE_EXPERTS = "moe_routing", "moe_experts"
BWD_NODE = "autograd::engine::evaluate_function"
XENT_NODES = ("LogsumexpBackward", "GatherBackward", "MeanBackward")
# the port's kernels a train profile sums by name, first match: the
# gates' backwards are one kernel (silu_gate_bwd_kernel: `silu_gate_bwd`,
# `silu_gate_prod_bwd`); SiLU's has its own
KERNEL_KINDS = (("silu_gate_bwd", "silu_gate_bwd_kernel"),
                ("silu_bwd", "silu_bwd_kernel"),
                ("silu_gate", "silu_gate_kernel"), ("silu", "silu_kernel"),
                ("ssd_chunk_bwd", "ssd_bwd_"), ("ssd_chunk", "ssd_"),
                ("moe_bwd", "moe_dispatch_bwd_kernel"),
                ("moe_bwd", "moe_combine_bwd_kernel"),
                ("moe_bwd", "moe_gates_bwd_kernel"), ("moe_fwd", "moe_"))


def profile_ranges(cfg) -> tuple:
    """`train_profile`'s ranged kinds of `cfg`'s family: (module, names,
    label) each."""
    if cfg.family == "hybrid":
        return ((att, ("gqa_forward",), SHARED_ATTN),
                (lm_mod, ("_mlp",), SHARED_MLP))
    if cfg.is_moe:
        return ((moe_mod, ("router_logits", "route"), MOE_ROUTING),
                (moe_mod, ("experts",), MOE_EXPERTS))
    return ()


def train_profile(fn, ranges=()) -> dict:
    """Device ms by kind of `fn` (one train step) under `torch.profiler`:
    the attention core's forward and backward (`ops.flash_fwd` /
    `ops.flash_bwd`, MLA's `ops.flash_fwd_mla` / `ops.flash_bwd_mla`,
    inside `record_function` ranges: the flash kernels, also each by
    name, and what else runs inside), cross-entropy (`chunked_xent`
    in a range, and the kernels of its backward nodes: log-sum-exp,
    gather, mean), the optimizer (`adamw_update` in a range), the port's
    gate and SSD kernels and their backwards (KERNEL_KINDS, by kernel
    name; also each of those kernels' own device ms), the other matrix
    products (cuBLAS / CUTLASS names) and the rest; the kernels run.
    `ranges` (`profile_ranges`) adds kinds of ops in ranges of their
    own, forward, recompute and backward, less the flash and port
    kernels inside them, which keep their own kinds (`shared_port_ms`
    holds those, by range): the hybrid's shared block's attention and
    MLP (SHARED_ATTN, SHARED_MLP), the MoE's routing and expert
    products (MOE_ROUTING, MOE_EXPERTS)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(label):
        def wrap(_, f):
            def call(*a, **k):
                with record_function(label):
                    return f(*a, **k)
            # a kernel wrapper in `ops` counts its launches under its
            # own name, which is this call while patched (not read)
            call.launches = 0
            return call
        return wrap

    kinds = (ATTN_FWD, ATTN_BWD, XENT, OPTIM) + tuple(
        dict.fromkeys(label for _, _, label in ranges))
    with contextlib.ExitStack() as stack:
        for mod, wrap, names in (
                (ops, ranged(ATTN_FWD), ("flash_fwd", "flash_fwd_mla")),
                (ops, ranged(ATTN_BWD), ("flash_bwd", "flash_bwd_mla")),
                (lm_mod, ranged(XENT), ("chunked_xent",)),
                (train_step_mod, ranged(OPTIM), ("adamw_update",))) + tuple(
                    (mod, ranged(label), names)
                    for mod, names, label in ranges):
            stack.enter_context(patched(mod, wrap, names))
        prof = stack.enter_context(profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA

    def is_matmul(name):
        return any(k in name.lower() for k in MATMUL_KEYS)

    total = matmul = 0.0
    by = dict.fromkeys((k for k, _ in KERNEL_KINDS), 0.0)
    port = {}                           # the port's kernels, by name
    flash = {ATTN_FWD: 0.0, ATTN_BWD: 0.0}
    flash_names = {}                    # the flash kernels, by name
    n_kernels = 0
    for e in events:
        if e.device_type != cuda or getattr(e, "is_user_annotation", False) \
                or e.name in kinds:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        total += ms
        n_kernels += 1
        matmul += ms if is_matmul(e.name) else 0.0
        kind = next((k for k, key in KERNEL_KINDS if key in e.name), None)
        if kind is not None:
            by[kind] += ms
            m = re.search(r"\w+_kernel(<\w+>)?", e.name)
            name = m.group(0) if m else e.name
            port[name] = port.get(name, 0.0) + ms
        elif is_flash(e.name):
            flash[ATTN_FWD if "flash_fwd" in e.name else ATTN_BWD] += ms
            m = re.search(r"flash_\w+_kernel", e.name)
            name = m.group(0) if m else e.name
            flash_names[name] = flash_names.get(name, 0.0) + ms

    def subtree(roots, stop=()):
        """CPU ops under `roots`, each once, not entering a range named
        in `stop` (the flash calls' ranges inside the shared block's)."""
        seen, stack = set(), list(roots)
        while stack:
            e = stack.pop()
            if id(e) not in seen:
                seen.add(id(e))
                yield e
                stack.extend(c for c in e.cpu_children if c.name not in stop)

    # the shared block's forward ops (in its ranges: the forward's and the
    # recompute's), keyed as their backward nodes name them
    fwd_kind = {(e.thread, e.sequence_nr): kind
                for kind in kinds[4:] for e in subtree(
                    x for x in events if x.name == kind)
                if e.device_type != cuda and e.sequence_nr >= 0}
    # kernels under each range or backward node, each CPU op once
    ranged_mm, shared_port = 0.0, {}
    for kind in kinds:
        roots = [e for e in events if e.device_type != cuda and (
            e.name == kind or (e.name.startswith(BWD_NODE) and (
                (kind == XENT and any(n in e.name for n in XENT_NODES)) or
                fwd_kind.get((e.fwd_thread, e.sequence_nr)) == kind)))]
        ms = own = 0.0
        for e in subtree(roots, (ATTN_FWD, ATTN_BWD) if kind in kinds[4:]
                         else ()):
            for k in e.kernels:
                if is_flash(k.name) or any(key in k.name for _, key in
                                           KERNEL_KINDS):
                    own += k.duration / 1e3
                    continue
                ms += k.duration / 1e3
                ranged_mm += k.duration / 1e3 if is_matmul(k.name) else 0.0
        by[kind] = ms + flash.get(kind, 0.0)
        if kind in kinds[4:]:
            shared_port[kind] = own
    by["matmul_other"] = matmul - ranged_mm
    by["rest"] = total - sum(by.values())
    return {"device_ms": total, "kernels": n_kernels, "by_kind": by,
            "flash_kernels": flash, "flash_by_name": flash_names,
            "port_kernels": port,
            "shared_port_ms": shared_port}


def check_bwd(args) -> float:
    """The silu_gate_bwd kernel (on the CPU: the wrapper's plain path)
    against its plain version on the same inputs: dy and dz bit-equal,
    finite, of the input's shape. Returns max |diff| (0)."""
    got = ops.silu_gate_bwd(*args)
    want = silu_gate_bwd_ref(*args)
    sync(args[0].device)
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        if g.shape != tuple(args[0].shape) or not np.isfinite(g).all():
            raise AssertionError(f"silu_gate_bwd output {g.shape} or "
                                 f"non-finite values")
        np.testing.assert_array_equal(g, w)
        err = max(err, float(np.max(np.abs(g - w))))
    return err


def bwd_bound(args):
    """(ms, bound_by, bytes, ops): g, y, z read once and dy, dz written
    once (5 elements of the dtype), against 13 f32 operations an element
    (exp, add, divide and a multiply for the logistic and silu, the dy
    product, six more products, a difference and the sum)."""
    n, e = args[0].numel(), args[0].element_size()
    nbytes, nops = 5 * n * e, 13 * n
    return roofline(nbytes, nops) + (nbytes, nops)


def time_bwd(args) -> dict:
    """Device ms of the wrapper's call (one launch) beside the plain
    version and the bound."""
    bound_ms, by, nbytes, nops = bwd_bound(args)
    return {"shape": list(args[0].shape),
            "dtype": str(args[0].dtype).replace("torch.", ""),
            "ms": graph_ms(lambda: ops.silu_gate_bwd(*args), launches=20,
                           reps=11),
            "wrapper_ms": call_ms(lambda: ops.silu_gate_bwd(*args)),
            "plain_ms": call_ms(lambda: silu_gate_bwd_ref(*args)),
            "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
            "ops": nops}


def check_ssd_bwd(args) -> dict:
    """The ssd_chunk_bwd kernels (on the CPU: the wrapper's plain path)
    against their plain version on the same inputs: dx, dB, dC and dda
    within SSD_BWD_TOL of each one's max |g| (bf16 outputs also one bf16
    step, 2^-7 relative: both round once f32 sums taken in other
    orders), finite, of the inputs' shapes; a second call equal bit for
    bit. Returns max |diff| and, per output, the largest share of its
    tolerance."""
    got = ops.ssd_chunk_bwd(*args)
    again = ops.ssd_chunk_bwd(*args)
    want = ssd_chunk_bwd_ref(*args)
    sync(args[0].device)
    out = {"max_abs_err": 0.0, "dtype": str(args[0].dtype).replace(
        "torch.", ""), "shape": list(args[0].shape) + [args[1].shape[-1]]}
    for name, g, a, w in zip(("dx", "dB", "dC", "dda"), got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"ssd_chunk_bwd {name}: two calls on the "
                                 f"same inputs differ")
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        if g.shape != w.shape or not np.isfinite(g).all():
            raise AssertionError(f"ssd_chunk_bwd {name} {g.shape} (plain "
                                 f"{w.shape}) or non-finite values")
        rtol = 2.0 ** -7 if args[0].dtype == torch.bfloat16 and \
            name != "dda" else 0.0
        atol = SSD_BWD_TOL * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"ssd_chunk_bwd {name}")
        diff = np.abs(g - w)
        out["max_abs_err"] = max(out["max_abs_err"], float(diff.max()))
        out[name] = float((diff / (atol + rtol * np.abs(w))).max())
    return out


def ssd_bwd_work(xq, Bq):
    """Bytes the call must move (x, B, C, da, dy and dst read once; dx,
    dB, dC and dda written once) and the operations these inputs need,
    by unit: the contractions (a multiply-add is 2; the causal (q, k)
    pairs): C B^T, dC = dG B and dG^T C once per chunk, shared by the
    heads; per head dS = dy x^T and S^T dy over P, B dst^T and x dst
    over P x N; and the elementwise work (per head and causal pair the
    decay's subtract and exp, S, dS o L, E and its two sums; per head
    and row r's subtract and exp, the rho sum over P and r o (x dst);
    the heads' sums of dG and of r o (x dst); both scans)."""
    B, nC, Q, H, P = xq.shape
    N = Bq.shape[-1]
    chunks, pairs = B * nC, Q * (Q + 1) // 2
    mm_ops = chunks * (3 * 2 * N * pairs +
                       H * (2 * 2 * P * pairs + 2 * 2 * Q * P * N))
    ew_ops = chunks * H * (7 * pairs + Q * (2 + 2 * P + N) + pairs +
                           Q * N + 2 * Q)
    e = xq.element_size()
    nbytes = 2 * (xq.numel() + 2 * Bq.numel()) * e + \
        2 * chunks * H * Q * 4 + xq.numel() * 4 + chunks * H * P * N * 4
    return nbytes, mm_ops, ew_ops


def ssd_bwd_bound(xq, Bq):
    """(ms, bound_by, bytes, ops): as `ssd_bound`, of `ssd_bwd_work`."""
    nbytes, mm_ops, ew_ops = ssd_bwd_work(xq, Bq)
    mm_rate = BF16_TC_OPS_PER_S if xq.dtype == torch.bfloat16 \
        else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(mm_ops / mm_rate, ew_ops / F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes,
            mm_ops + ew_ops)


def time_ssd_bwd(args) -> dict:
    """Device ms of the wrapper's call (its kernels, with the scratch
    they take) over back-to-back calls, beside the plain version and the
    bound; the scratch bytes."""
    bound_ms, by, nbytes, nops = ssd_bwd_bound(args[0], args[1])
    B, nC, Q, H, _ = args[0].shape
    scratch = ssd_scan.bwd_scratch(B, nC, Q, H, args[1].shape[-1],
                                   args[0].dtype == torch.bfloat16)
    return {"ms": device_ms(lambda: ops.ssd_chunk_bwd(*args), launches=10,
                            reps=5),
            "scratch_bytes": 4 * sum(int(np.prod(v))
                                     for v in scratch.values()),
            "wrapper_ms": call_ms(lambda: ops.ssd_chunk_bwd(*args), reps=5),
            "plain_ms": call_ms(lambda: ssd_chunk_bwd_ref(*args), reps=5),
            # no single PyTorch call computes the SSD chunk's gradient
            "library_ms": None,
            "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
            "ops": nops}


SILU_BWD_PLAIN = {"silu_bwd": silu_bwd_ref,
                  "silu_gate_prod_bwd": silu_gate_prod_bwd_ref}


def check_silu_bwd(name: str, args) -> float:
    """The SiLU backward `name` (on the CPU: the wrapper's plain path)
    against its plain version on the same inputs, every output
    bit-equal, finite, of the input's shape; a second call equal bit
    for bit. Returns max |diff| (0)."""
    fn = getattr(ops, name)
    got, again = fn(*args), fn(*args)
    want = SILU_BWD_PLAIN[name](*args)
    sync(args[0].device)
    got, again, want = (t if isinstance(t, tuple) else (t,)
                        for t in (got, again, want))
    err = 0.0
    for g, a, w in zip(got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"{name}: two calls on the same inputs "
                                 f"differ")
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        if g.shape != tuple(args[0].shape) or not np.isfinite(g).all():
            raise AssertionError(f"{name} output {g.shape} or non-finite "
                                 f"values")
        np.testing.assert_array_equal(g, w)
        err = max(err, float(np.max(np.abs(g - w))))
    return err


def silu_bwd_bound(name: str, args):
    """(ms, bound_by, bytes, ops): each input read once and each output
    written once (silu_bwd: g, x in, dx out: 3 elements of the dtype;
    silu_gate_prod_bwd: g_value, y, z in, dy, dz out and the f32 g_prod
    in), against the f32 operations an element (the logistic's exp,
    add and divide, its derivative's six: 10; the gate's 13 and the
    cotangents' add: 14)."""
    n, e = args[0].numel(), args[0].element_size()
    if name == "silu_bwd":
        nbytes, nops = 3 * n * e, 10 * n
    else:
        nbytes, nops = n * (5 * e + 4), 14 * n
    return roofline(nbytes, nops) + (nbytes, nops)


def time_silu_bwd(name: str, args) -> dict:
    """Device ms of the wrapper's call (one launch) beside the plain
    version and the bound."""
    bound_ms, by, nbytes, nops = silu_bwd_bound(name, args)
    fn, plain = getattr(ops, name), SILU_BWD_PLAIN[name]
    lib = SILU_LIBRARY.get(name)
    ms, lib_ms = kernel_and_library_ms(lambda: fn(*args),
                                       lib and (lambda: lib(*args)))
    return {"shape": list(args[0].shape), "strides": [
                list(t.stride()) for t in args],
            "dtype": str(args[0].dtype).replace("torch.", ""),
            "ms": ms,
            "wrapper_ms": call_ms(lambda: fn(*args)),
            "plain_ms": call_ms(lambda: plain(*args)),
            "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
            "ops": nops}


def train_launches(cfg, runs: int, **rest) -> dict:
    """The launches of a training run of `runs` passes over the model
    (steps x pods) under per-layer remat: each forward kernel of cfg's
    family twice a layer a pass (forward, recompute), each of its
    backward kernels once; the hybrid's shared block adds the dense
    family's so for each application (`shared_flags`: recomputed inside
    its layer's region); the MoE family's layer the MoE kernels and the
    dense family's (MOE_TRAIN_FWD, MOE_TRAIN_BWD); every other kernel
    of TRAIN_COUNTED 0 unless `rest` names it."""
    parts = [(MOE_TRAIN_FWD, MOE_TRAIN_BWD, cfg.n_layers)] if cfg.is_moe \
        else [(DENSE_FWD, DENSE_BWD, cfg.n_layers)] \
        if cfg.family == "dense" else [(SSM_FWD, SSM_BWD, cfg.n_layers)]
    if cfg.family == "hybrid":
        parts.append((DENSE_FWD, DENSE_BWD, sum(lm_mod.shared_flags(cfg))))
    want = dict.fromkeys(TRAIN_COUNTED, 0)
    for fwd, bwd, n in parts:
        for k in fwd:
            want[k] += 2 * n * runs
        for k in bwd:
            want[k] += n * runs
    want.update(rest)
    return want


def counted(names=TRAIN_COUNTED) -> dict:
    return {name: getattr(ops, name).launches for name in names}


def zero_train_counts(names=TRAIN_COUNTED) -> None:
    for name in names:
        getattr(ops, name).launches = 0


def train_single(cfg, dev, steps: int = TRAIN_STEPS,
                 batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> dict:
    """Part (1), part (5) for the ssm family, part (6) for the hybrid and
    part (7) for the MoE and part (8) for MLA: `cfg` trained by the
    Trainer on one pod
    (`sync="psum"`, remat "full", random weights from a generator seeded
    0), counts zeroed just before the run and read just after (the
    MoE's: each step's expert_load, summed over the layers, within
    LOAD_SUM_TOL of the layers' count); then one more step under the
    profiler and one capturing the kernels' inputs (dense: the first
    call of each gate and flash kernel; ssm, hybrid and MoE: layer 0's,
    the forwards' first calls and the backwards' last; the hybrid's
    shared block's likewise: its first application's; MLA: flash's
    forward and backward from MLA's parts at layer 0)."""
    dcfg = DataConfig(batch=batch, seq=seq, vocab=cfg.vocab)
    tr = Trainer(cfg, 1, dcfg, LoopConfig(steps=steps, sync="psum"),
                 opt=AdamWConfig(total_steps=steps, **TRAIN_OPT),
                 device=dev)
    loads = []
    if cfg.is_moe:
        build_step = tr._build_step

        def recording(plan):
            fn = build_step(plan)

            def step(*a):
                out = fn(*a)
                loads.append(out[2]["expert_load"].detach().cpu().numpy())
                return out
            return step
        tr._build_step = recording
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    t0 = time.perf_counter()
    params, state = tr.run(0)
    run_s = time.perf_counter() - t0
    got = counted()
    want = train_launches(cfg, steps)
    if got != want:
        raise AssertionError(f"train launches {got}, expected {want}: under "
                             f"per-layer remat each forward kernel runs "
                             f"twice a layer (and a shared application) a "
                             f"step (forward, recompute), each backward "
                             f"once")
    losses = [h["loss"] for h in tr.history]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train losses {losses}: not finite, or no fall")
    load_sums = [float(ld.sum()) / cfg.n_layers for ld in loads]
    if cfg.is_moe and (len(loads) != steps or not all(
            abs(x - 1.0) <= LOAD_SUM_TOL and np.isfinite(x)
            for x in load_sums)):
        raise AssertionError(f"expert_load a step over {cfg.n_layers} "
                             f"layers sums to {load_sums} of the layers "
                             f"({len(loads)} steps recorded)")
    step_ms = [h["time"] * 1e3 for h in tr.history]
    res = {"arch": cfg.arch_id, "layers": cfg.n_layers, "batch": batch,
           "seq": seq, "steps": steps, "params": registry.param_count(cfg),
           "launches": got, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in tr.history],
           "step_ms": step_ms,
           "step_ms_median": float(np.median(step_ms[1:])),
           "step_ms_p90": float(np.percentile(step_ms[1:], 90)),
           "run_s": run_s, "expert_load_sums": load_sums,
           "expert_load": [ld.tolist() for ld in loads],
           "peak_bytes": torch.cuda.max_memory_allocated()
           if dev.type == "cuda" else None}
    res["tokens_per_s"] = batch * seq / (res["step_ms_median"] / 1e3)
    step_fn = tr._get_step()
    data = batches(cfg, dcfg)
    if dev.type == "cuda":
        b = next(data)
        sync(dev)
        t0 = time.perf_counter()
        step_fn(params, state, b)
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        prof = train_profile(lambda: step_fn(params, state, next(data)),
                             profile_ranges(cfg))
        prof["busy_share"] = prof["device_ms"] / wall
        prof["wall_ms"] = wall
        res["profile"] = prof
    seen = {}
    if cfg.is_moe:
        with patched(ops, first_calls(seen), MOE_KERNELS), \
                patched(ops, first_calls(seen, "last"), MOE_BWD_KERNELS):
            step_fn(params, state, next(data))
        res["layer0"] = {n: seen[n][0] for n in MOE_KERNELS +
                         MOE_BWD_KERNELS}
    elif cfg.is_mla:
        with patched(ops, first_calls(seen), ("flash_fwd_mla",)), \
                patched(ops, first_calls(seen, "last"), ("flash_bwd_mla",)):
            step_fn(params, state, next(data))
        res["layer0"] = {n: seen[n][0] for n in ("flash_fwd_mla",
                                                 "flash_bwd_mla")}
    elif cfg.family == "dense":
        with patched(ops, first_calls(seen), ("silu_gate", "silu_gate_bwd",
                                              "flash_fwd", "flash_bwd")):
            step_fn(params, state, next(data))
        res["fwd_call"] = seen["silu_gate"]
        res["bwd_args"] = seen["silu_gate_bwd"][0]
        res["flash_args"] = (seen["flash_fwd"][0], seen["flash_bwd"][0])
    else:
        fwd, bwd = (SSM_FWD, SSM_BWD) if cfg.family == "ssm" else \
            (SSM_FWD + ("flash_fwd",), SSM_BWD + DENSE_BWD)
        with patched(ops, first_calls(seen), fwd), \
                patched(ops, first_calls(seen, "last"), bwd):
            step_fn(params, state, next(data))
        res["layer0"] = {n: seen[n][0] for n in fwd + bwd}
    del tr, params, state, step_fn
    return res


def step_parity(cfg, dev) -> dict:
    """Part (3): one `make_train_step` step of `cfg` (f32) on the card and
    on the host from the same weights and batch (B=1, S from
    PARITY_SEQ): the loss, every gradient leaf (the hybrid's `shared_attn`
    included; within GRAD_PARITY_TOL
    of its max |g|; `_grads_of`, the step's own gradient function) and
    the parameters after AdamW
    wherever |g| is above 1e-2 of the leaf's max (there AdamW's first
    step moves each element by lr times its gradient's sign, which the
    sum order cannot flip): within 1e-6 relative plus a thousandth of
    the step's lr (eps = 1e-8 lets a small gradient's error reach the
    update). The card's first calls of the family's backward kernels
    (f32) are held to their plain versions: dense `flash_fwd` /
    `flash_bwd`, ssm `ssd_chunk_bwd` (part (5)), the hybrid all three
    (part (6)), the MoE flash's two and its three backward kernels, bit
    for bit (part (7)), MLA's flash forward and backward from its parts
    (part (8)))."""
    t0 = time.perf_counter()
    seq = PARITY_SEQ.get(cfg.arch_id, PARITY_SEQ_OTHER)
    card = registry.build_model(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    host = lm_mod.model_class(cfg)(cfg, torch.device("cpu"), torch.float32)
    host.load_state_dict(card.state_dict())
    trees = {"card": stack_layers(param_tree(card)),
             "host": stack_layers(param_tree(host))}
    del card, host
    b = next(batches(cfg, DataConfig(batch=PARITY_BATCH, seq=seq,
                                     vocab=cfg.vocab)))
    out, grads, after, secs = {}, {}, {}, {}
    seen = {}
    for name, params in trees.items():
        t1 = time.perf_counter()
        dev_b = as_batch(b, params["embed"].device)
        with patched(ops, first_card_calls(seen), PARITY_CHECKED[
                "moe" if cfg.is_moe else "mla" if cfg.is_mla
                else cfg.family]):
            _, _, g = train_step_mod._grads_of(cfg, 1, torch.float32,
                                               "full")(params, dev_b)
        grads[name] = tree_map(lambda t: t.cpu(), g)
        del g
        step = make_train_step(cfg, opt=AdamWConfig(), sync="psum")
        params, _, out[name] = step(params, init_opt_state(params), dev_b)
        after[name] = tree_map(lambda t: t.cpu(), params)
        sync(params["embed"].device)
        secs[name] = time.perf_counter() - t1
    del trees, params
    worst = {"loss": abs(float(out["card"]["loss"]) -
                         float(out["host"]["loss"])) /
             abs(float(out["host"]["loss"])), "grad": 0.0, "param": 0.0}
    if not (np.isfinite(float(out["card"]["loss"])) and
            worst["loss"] <= 1e-5):
        raise AssertionError(f"{cfg.arch_id} step parity: loss "
                             f"{float(out['card']['loss'])} vs "
                             f"{float(out['host']['loss'])}")
    lr = float(out["host"]["lr"])
    for (path, gc), (_, gh), (_, c), (_, h) in zip(
            *(tree_items(t) for t in (grads["card"], grads["host"],
                                      after["card"], after["host"]))):
        gc, gh = gc.numpy(), gh.numpy()
        mag = float(np.abs(gh).max())
        err = float(np.abs(gc - gh).max()) / mag
        worst["grad"] = max(worst["grad"], err)
        if not (np.isfinite(gc).all() and err <= GRAD_PARITY_TOL):
            raise AssertionError(f"{cfg.arch_id} {path}: grad off by {err:.3g}"
                                 f" of its max |g| {mag:.3g}")
        clear = np.abs(gh) > 1e-2 * mag
        c, h = c.numpy()[clear], h.numpy()[clear]
        # the excess over the allowance, in units of the step's lr
        excess = float(((np.abs(c - h) - 1e-6 * np.abs(h)) / lr).max()) \
            if c.size else 0.0
        worst["param"] = max(worst["param"], excess)
        if excess > 1e-3:
            raise AssertionError(f"{cfg.arch_id} {path}: parameter after "
                                 f"AdamW off by {excess:.3g} lr beyond 1e-6 "
                                 f"relative")
    checks = {}
    if "flash_bwd" in seen:
        checks["flash"] = {"fwd": check_flash_fwd(seen["flash_fwd"][0]),
                           "bwd": check_flash_bwd(seen["flash_bwd"][0])}
    if "flash_bwd_mla" in seen:
        checks["flash_mla"] = {
            "fwd": check_flash_mla(seen["flash_fwd_mla"][0]),
            "bwd": check_flash_bwd_mla(seen["flash_bwd_mla"][0])}
    if "ssd_chunk_bwd" in seen:
        checks["ssd_chunk_bwd"] = check_ssd_bwd(seen["ssd_chunk_bwd"][0])
    for name in MOE_BWD_KERNELS:
        if name in seen:
            checks[name] = check_moe(name, seen[name][0])
    del seen
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {**worst, "layers": cfg.n_layers, "batch": PARITY_BATCH,
            "seq": seq, "card_s": secs["card"], "host_s": secs["host"],
            **checks, "s": time.perf_counter() - t0}


def tree_items(tree, prefix=""):
    """[(path, tensor)] of a nested dict, in its order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(tree_items(v, f"{prefix}{k}."))
        else:
            out.append((prefix + k, v))
    return out


def sync_launches(plan: WanPlan, shapes, compress: bool) -> int:
    """Quantize (and dequantize) launches of one `wan_allreduce_batched`
    call over leaves of `shapes` (the pod dim left out): a launch per
    part of each leaf in each phase with an int8 payload."""
    return 0 if not compress else sum(
        sync_parts(s, ph["chunks"]) for s in shapes
        for ph in offset_schedule(plan) if ph["bits"] <= 8)


def sync_wire_bytes(plan: WanPlan, leaves, compress: bool) -> list:
    """Bytes one pod puts on the wire in each offset phase of the batched
    sync: every leaf at the phase's bits (1 B an element below 16 bits,
    2 B at 16, its own width at 32) and a 4-byte scale per part below
    16 bits."""
    out = []
    for ph in offset_schedule(plan):
        bits = ph["bits"] if compress else 32
        n = 0
        for x in leaves:
            per = x[0]
            width = 1 if bits <= 8 else 2 if bits == 16 else \
                per.element_size()
            n += per.numel() * width
            n += 4 * sync_parts(tuple(per.shape), ph["chunks"]) \
                if bits <= 8 else 0
        out.append(n)
    return out


class SyncTap:
    """Wraps the train step's `wan_allreduce_batched`: per call the plan,
    the leaves' shapes, the device ms of the call (synchronised around
    it), the wire bytes a pod sends per phase and the codec layouts
    checked during it (`codec`, a CodecCheck). The first call is redone
    on the host for every leaf of at most HOST_SYNC_MAX elements a pod
    (the same function on host copies: the plain codec) and held equal
    to the card's output bit for bit."""

    def __init__(self, codec):
        self.calls, self.codec, self.host = [], codec, None

    def __call__(self, _, fn):
        def call(tree, plan, *, compress=False, mean=True):
            leaves = list(tree_leaves(tree))
            small = [(path, x.detach().cpu()) for path, x in tree_items(tree)
                     if x[0].numel() <= HOST_SYNC_MAX] \
                if self.host is None else []
            checked = len(self.codec.checked)
            sync(leaves[0].device)
            t0 = time.perf_counter()
            out = fn(tree, plan, compress=compress, mean=mean)
            sync(leaves[0].device)
            self.calls.append({
                "signature": repr(plan.signature()), "plan": plan,
                "shapes": [tuple(x.shape[1:]) for x in leaves],
                "ms": (time.perf_counter() - t0) * 1e3,
                "codec_checks": len(self.codec.checked) - checked,
                "wire_bytes": sync_wire_bytes(plan, leaves, compress)})
            if small:
                self.host = host_sync_check(fn, dict(small), out, plan,
                                            compress, mean)
            return out
        return call


def host_sync_check(fn, host_in: dict, out, plan: WanPlan, compress: bool,
                    mean: bool) -> dict:
    """`fn` (the batched sync) on host copies of the leaves `host_in`
    ({path: [P, ...] tensor}) against the card's output `out` at those
    paths: bit-equal. Returns the leaves, their elements and seconds."""
    t0 = time.perf_counter()
    host_out = fn(host_in, plan, compress=compress, mean=mean)
    card = dict(tree_items(out))
    for path, h in host_out.items():
        c = card[path].cpu()
        if c.shape != h.shape or not torch.equal(c, h):
            bad = (c != h).sum().item() if c.shape == h.shape else "all"
            raise AssertionError(f"4-pod sync {path}: the card's compressed "
                                 f"sync differs from the host's ({bad} "
                                 f"elements)")
    return {"leaves": sorted(host_out),
            "elements": sum(h.numel() for h in host_out.values()),
            "s": time.perf_counter() - t0}


class CodecCheck:
    """A `patched` wrapper for `ops.quantize_groups` and
    `ops.dequantize_groups_add` on the train step's sync: the first call
    at each input layout (shapes, strides, dtypes, bits) on `dev` is
    held against the plain version on the same inputs, bit for bit. The
    kernel runs once, as the path's own call, and counts as always;
    calls on another device (the host's redo) pass through."""

    def __init__(self, dev):
        self.dev, self.seen, self.checked = dev, set(), []

    def __call__(self, name, fn):
        def call(*args):
            x = args[0]
            key = (name,) + tuple(
                (tuple(a.shape), a.stride(), a.dtype)
                if isinstance(a, torch.Tensor) else a for a in args)
            if x.device.type != self.dev.type or key in self.seen:
                return fn(*args)
            self.seen.add(key)
            if name == "quantize_groups":
                got = fn(*args)
                want = quantize_groups_ref(*args)
            else:
                q, scale, acc = args
                before = acc.clone()
                got = (fn(*args),)
                want = (dequantize_groups_add_ref(q, scale, before),)
            sync(x.device)
            for g, w in zip(got, want):
                if g.shape != w.shape or not torch.equal(g, w):
                    raise AssertionError(f"{name} at {key[1:]}: kernel != "
                                         f"plain on the sync's part")
            self.checked.append({"kernel": name, "shape": list(x.shape),
                                 "stride": list(x.stride()),
                                 "dtype": str(x.dtype).replace("torch.",
                                                               ""),
                                 "bits": args[1] if name ==
                                 "quantize_groups" else None})
            return got if name == "quantize_groups" else got[0]
        return call


class PredictRecorder:
    """A `patched` wrapper for `BwPredictor.predict_matrix`: keeps every
    call's predictor and snapshot features (`assemble_features`'
    arguments) for `check_kernel` after the run."""

    def __init__(self):
        self.calls = []

    def __call__(self, _, fn):
        def call(pred, n_dcs, snap_bw, mem_util, cpu_load, retrans, dist,
                 *a, **kw):
            self.calls.append((pred, n_dcs) + tuple(
                np.array(v, copy=True) for v in (snap_bw, mem_util,
                                                 cpu_load, retrans, dist)))
            return fn(pred, n_dcs, snap_bw, mem_util, cpu_load, retrans,
                      dist, *a, **kw)
        return call


def train_pods(cfg, dev, forest, steps: int = POD_STEPS,
               batch: int = POD_BATCH, seq: int = TRAIN_SEQ,
               fail_at: int = POD_FAIL_AT) -> dict:
    """Part (4): `cfg` on 4 pods of the one card through the WANify
    Trainer (skew 0.5, `sync="wanify"`, `compress=True`, a replan every
    2 steps fed the skew weights, checkpoints every 3 steps into a
    temporary directory, a simulated failure at `fail_at`), the
    reference CLI's forest on the card; counts zeroed just before the
    Trainer is built (its controller's first plan predicts) and read
    after the run. The codec kernels are held against their plain
    versions at each part layout of the sync (CodecCheck), the first
    sync against the host's (SyncTap), and `rf_predict` against its
    plain version on each of the controller's feature matrices."""
    codec, preds = CodecCheck(dev), PredictRecorder()
    tap = SyncTap(codec)
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as d, \
            patched(train_step_mod, tap, ("wan_allreduce_batched",)), \
            patched(ops, codec, ("quantize_groups",
                                 "dequantize_groups_add")), \
            patched(BwPredictor, preds, ("predict_matrix",)):
        dcfg = DataConfig(batch=batch, seq=seq, vocab=cfg.vocab,
                          n_pods=N_PODS, skew=0.5)
        lc = LoopConfig(steps=steps, ckpt_dir=d, ckpt_every=POD_CKPT_EVERY,
                        sync="wanify", compress=True, replan_every=2)
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        zero_train_counts()
        t0 = time.perf_counter()
        tr = Trainer(cfg, N_PODS, dcfg, lc, opt=AdamWConfig(
            total_steps=steps, **TRAIN_OPT), sim=WanSimulator(seed=0),
            predictor=BwPredictor(forest, device=dev), device=dev)
        first = (tr.plan.conns, tr.plan.compress_bits)
        tr.run(0, fail_at=fail_at)
        run_s = time.perf_counter() - t0
        got = counted()
        ckpt_steps = sorted(os.listdir(d))
    executed = len(tr.history)
    predictions = int(tr.controller.metrics.counters()["replans_total"])
    quant = sum(sync_launches(c["plan"], c["shapes"], True)
                for c in tap.calls)
    want = train_launches(cfg, N_PODS * executed, rf_predict=predictions,
                          quantize=quant, dequantize=quant)
    problems = []
    if got != want:
        problems.append(f"launches {got}, expected {want}")
    if len(tap.calls) != executed:
        problems.append(f"{len(tap.calls)} syncs for {executed} steps")
    if not any(e.startswith("replanned at step") for e in tr.events):
        problems.append("no replan")
    if f"simulated failure at step {fail_at}" not in tr.events or \
            f"restored step {POD_CKPT_EVERY}" not in tr.events:
        problems.append("no restore after the failure")
    losses = [h["loss"] for h in tr.history]
    if not np.isfinite(losses).all():
        problems.append(f"losses {losses}")
    kernels = {c["kernel"] for c in codec.checked}
    if kernels != {"quantize_groups", "dequantize_groups_add"} or \
            tap.host is None:
        problems.append(f"codec layouts checked {codec.checked}, host "
                        f"sync {tap.host}")
    if len(preds.calls) != predictions:
        problems.append(f"{len(preds.calls)} predict_matrix calls for "
                        f"{predictions} predictions")
    if problems:
        raise AssertionError(f"4-pod trainer: {'; '.join(problems)}; events "
                             f"{tr.events}")
    # rf_predict on each feature matrix the controller predicted from
    rf_err = max(check_kernel(pred.forest, assemble_features(*args), dev)
                 for pred, *args in preds.calls)
    # the median over the calls with no codec check in them
    sync_ms = [c["ms"] for c in tap.calls]
    clean_ms = [c["ms"] for c in tap.calls if not c["codec_checks"]]
    res = {"arch": cfg.arch_id, "layers": cfg.n_layers, "pods": N_PODS,
           "batch": batch, "seq": seq, "steps": steps, "fail_at": fail_at,
           "params_per_pod": registry.param_count(cfg),
           "launches": got, "predictions": predictions,
           "steps_run": executed, "events": tr.events,
           "first_plan": {"conns": first[0], "bits": first[1]},
           "plan": {"conns": tr.plan.conns, "bits": tr.plan.compress_bits},
           "signatures": [c["signature"] for c in tap.calls],
           "losses": losses, "step_ms": [h["time"] * 1e3
                                         for h in tr.history],
           "sync_ms": sync_ms,
           "sync_ms_median": float(np.median(clean_ms or sync_ms)),
           "sync_ms_unchecked": len(clean_ms),
           "codec_checked": codec.checked, "host_sync": tap.host,
           "rf_predict_checked": len(preds.calls),
           "rf_predict_max_abs_err": rf_err,
           "wire_bytes": [c["wire_bytes"] for c in tap.calls],
           "checkpoints": ckpt_steps, "run_s": run_s,
           "peak_bytes": torch.cuda.max_memory_allocated()
           if dev.type == "cuda" else None}
    del tr
    return res


def log_single(single: dict, smi: str) -> None:
    """The log lines of a `train_single` run and its profile."""
    log(f"[train] {single['arch']} {single['layers']} layers "
        f"({single['params']} params), B={single['batch']} "
        f"S={single['seq']}, {single['steps']} steps psum, remat full: step "
        f"ms median {single['step_ms_median']:.2f}, p90 "
        f"{single['step_ms_p90']:.2f} (first {single['step_ms'][0]:.1f}); "
        f"{single['tokens_per_s']:.1f} tokens/s; peak device memory "
        f"{(single['peak_bytes'] or 0) / 2**30:.3f} GiB; losses "
        + ", ".join(f"{x:.4f}" for x in single["losses"])
        + f"; launches {single['launches']} | {smi}")
    if "profile" in single:
        pr = single["profile"]
        log(f"[train] profile of one step: {pr['kernels']} device kernels, "
            f"{pr['device_ms']:.2f} ms of a {pr['wall_ms']:.2f} ms step "
            f"({pr['busy_share']:.1%} busy); by kind " + ", ".join(
                f"{k} {v:.2f}" for k, v in pr["by_kind"].items()))


def log_pods(pods: dict, pod_cfg, cfg, smi: str) -> None:
    """The log lines of a `train_pods` run (`pod_cfg`: `cfg` cut)."""
    log(f"[train] 4-pod WANify {pod_cfg.arch_id} {pod_cfg.n_layers} of "
        f"{cfg.n_layers} layers ({pods['params_per_pod']} params a pod), "
        f"B={pods['batch']} S={pods['seq']}: {pods['steps_run']} steps run "
        f"in {pods['run_s']:.1f} s; events {pods['events']}; launches "
        f"{pods['launches']} ({pods['predictions']} predictions); first plan "
        f"{pods['first_plan']}, last {pods['plan']}; sync ms a step median "
        f"{pods['sync_ms_median']:.2f} (all: "
        + ", ".join(f"{x:.1f}" for x in pods["sync_ms"])
        + f"; median over the {pods['sync_ms_unchecked']} with no codec "
        f"check); wire bytes a pod per phase, first step "
        f"{pods['wire_bytes'][0]}"
        f"; checkpoints {pods['checkpoints']}; peak device memory "
        f"{(pods['peak_bytes'] or 0) / 2**30:.3f} GiB; losses "
        + ", ".join(f"{x:.4f}" for x in pods["losses"]) + f" | {smi}")
    hs = pods["host_sync"]
    lengths = [c["shape"][1] for c in pods["codec_checked"]]
    log(f"[train] 4-pod checks: quantize_groups / dequantize_groups_add "
        f"bit-equal to plain at the first call of each of "
        f"{len(pods['codec_checked'])} part layouts (4 pod slices of "
        f"{min(lengths)} to {max(lengths)} elements); the first sync "
        f"redone on the host bit-equal over "
        f"{len(hs['leaves'])} leaves ({hs['elements']} elements, "
        f"{hs['s']:.1f} s); rf_predict bit-equal to plain on all "
        f"{pods['rf_predict_checked']} feature matrices the controller "
        f"predicted from")


def log_parity(p: dict) -> None:
    """The log line of a `step_parity` run."""
    checked = []
    if "flash" in p:
        checked.append(
            f"flash_fwd / flash_bwd {p['flash']['fwd']['shape']} f32 "
            f"against plain: out {p['flash']['fwd']['out']['err']:.3g}, " +
            ", ".join(f"{n} {p['flash']['bwd'][n]['err']:.3g}"
                      for n in ("dq", "dk", "dv")))
    if "flash_mla" in p:
        f, b = p["flash_mla"]["fwd"], p["flash_mla"]["bwd"]
        checked.append(
            f"flash_fwd_mla / flash_bwd_mla {b['shape']} f32 against plain: "
            f"out {f['out']['err']:.3g}, " + ", ".join(
                f"{n} {b[n]['err']:.3g}" for n in ("dq_nope", "dq_rope",
                                                   "dk", "dv")) +
            ", dk_rope the heads' sum of dk")
    if "ssd_chunk_bwd" in p:
        c = p["ssd_chunk_bwd"]
        checked.append(f"ssd_chunk_bwd {c['shape']} f32 against plain: " +
                       ", ".join(f"{n} {c[n]:.3g}" for n in ("dx", "dB",
                                                              "dC", "dda")))
    moe = [n for n in MOE_BWD_KERNELS if n in p]
    if moe:
        checked.append(", ".join(f"{n} {p[n]['shape']}" for n in moe) +
                       " f32 bit-equal to plain: 0")
    checked = "; ".join(checked)
    log(f"[train] step parity {p['arch']} {p['layers']} layers f32, "
        f"B={p['batch']} S={p['seq']} (card {p['card_s']:.1f} s, host "
        f"{p['host_s']:.1f} s): loss {p['loss']:.3g} relative, gradients "
        f"within {p['grad']:.3g} of each leaf's max |g| (limit "
        f"{GRAD_PARITY_TOL}), parameters after AdamW within 1e-6 relative "
        f"+ {p['param']:.3g} lr where |g| is clear of 0 (limit 1e-3 lr); "
        f"{checked} of the tolerance; {p['s']:.1f} s")


def ssm_train(cfg, dev, smi: str, parity_cfg=None) -> dict:
    """Part (5): the ssm family trained as part (1) trains the dense one
    (`train_single`, its exact counts), then its three backward kernels
    against their plain versions on layer 0's inputs of one more step
    (two calls each, bit-equal), timed beside their bounds and plain
    versions, and one card-against-host step (`step_parity`) of
    `parity_cfg` (default: cfg at PARITY_LAYERS, f32)."""
    t0 = time.perf_counter()
    single = train_single(cfg, dev)
    log_single(single, smi)
    calls = single.pop("layer0")
    args = calls.pop("ssd_chunk_bwd")
    k = single["ssd_chunk_bwd"] = {"check": check_ssd_bwd(args)}
    if dev.type == "cuda":
        k["timing"] = t = time_ssd_bwd(args)
        log(f"[train] ssd_chunk_bwd {k['check']['shape']} "
            f"{k['check']['dtype']} at layer 0: within {SSD_BWD_TOL} of each "
            f"output's max |g| of plain (share of the tolerance: " +
            ", ".join(f"{n} {k['check'][n]:.3g}" for n in ("dx", "dB", "dC",
                                                          "dda")) +
            f"), two calls equal bit for bit; kernels {t['ms']:.4f} ms "
            f"(device, events over 10 calls) | wrapper call "
            f"{t['wrapper_ms']:.4f} ms | plain {t['plain_ms']:.4f} ms | "
            f"bound {t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes']} "
            f"B, {t['ops']} ops) | library call: none (no single PyTorch "
            f"call computes the SSD chunk's gradient) | {smi}")
        per_call = {n: v / cfg.n_layers for n, v in
                    single["profile"]["port_kernels"].items()
                    if n.startswith("ssd_bwd_")}
        t["kernels_ms"] = per_call
        log(f"[train] ssd_chunk_bwd kernels in the profiled step (device ms "
            f"a call, {cfg.n_layers} calls): " + ", ".join(
                f"{n} {v:.5f}" for n, v in per_call.items()) +
            f"; scratch {t['scratch_bytes']} B (f32, allocated by the "
            f"wrapper each call) | {smi}")
    del args
    for name in ("silu_bwd", "silu_gate_prod_bwd"):
        args = calls.pop(name)
        k = single[name] = {"max_abs_err": check_silu_bwd(name, args)}
        if dev.type == "cuda":
            k["timing"] = time_silu_bwd(name, args)
            log_bwd_kernel(name, k, smi)
        del args
    del calls
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    p = single["parity"] = step_parity(
        parity_cfg or cfg.replace(n_layers=PARITY_LAYERS, dtype="float32"),
        dev)
    log_parity({**p, "arch": cfg.arch_id})
    single["s"] = time.perf_counter() - t0
    log(f"[train] part (5) {cfg.arch_id}: {single['s']:.1f} s")
    return single


def log_bwd_kernel(name: str, k: dict, smi: str) -> None:
    """The log line of a SiLU backward kernel checked and timed at a
    train step's layer 0 (part (5)) or shared application (part (6))."""
    t = k["timing"]
    log(f"[train] {name} {t['shape']} {t['dtype']} (strides "
        f"{t['strides']}): bit-equal to plain, two calls equal; kernel "
        f"{t['ms']:.5f} ms (device, graph of 20 calls) | wrapper call "
        f"{t['wrapper_ms']:.5f} ms | plain {t['plain_ms']:.5f} ms | bound "
        f"{t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes']} B) | "
        f"library call: {lib_text(t)} | {smi}")


def hybrid_train(cfg, dev, smi: str, forest, ssd_n128_ms=None) -> dict:
    """Part (6): the hybrid trained as part (5) trains the ssm family
    (`train_single`, its exact counts: the Mamba-2 layers' kernels and
    the shared block's for each of its applications), then on one more
    step's captured inputs the Mamba-2 backwards at layer 0
    (`ssd_chunk_bwd` at N = 64 within SSD_BWD_TOL, timed beside its
    bound and `ssd_n128_ms`, part (5)'s N = 128 time; the SiLU backwards
    bit-equal) and the shared block's at its first application
    (`silu_gate_bwd` bit-equal, `flash_fwd` / `flash_bwd` within their
    tolerances, two calls equal), each timed beside its bound and plain
    version; one card-against-host step (`step_parity`) of cfg at
    HYBRID_PARITY_LAYERS in f32 and the 4-pod WANify run (`train_pods`)
    of cfg at HYBRID_POD_LAYERS."""
    t0 = time.perf_counter()
    single = train_single(cfg, dev)
    log_single(single, smi)
    if "profile" in single:
        pr = single["profile"]
        log(f"[train] {cfg.arch_id} shared block in the profiled step: "
            f"attention {pr['by_kind'][SHARED_ATTN]:.2f} ms besides flash's "
            f"{pr['by_kind'][ATTN_FWD]:.2f} + {pr['by_kind'][ATTN_BWD]:.2f}, "
            f"MLP {pr['by_kind'][SHARED_MLP]:.2f} ms besides its gate "
            f"kernels' {pr['shared_port_ms'][SHARED_MLP]:.2f} (forward, "
            f"recompute and backward of {sum(lm_mod.shared_flags(cfg))} "
            f"applications)")
    calls = single.pop("layer0")
    args = calls.pop("ssd_chunk_bwd")
    k = single["ssd_chunk_bwd"] = {"check": check_ssd_bwd(args)}
    if dev.type == "cuda":
        k["timing"] = t = time_ssd_bwd(args)
        t["n128_ms"] = ssd_n128_ms
        t["kernels_ms"] = {n: v / cfg.n_layers for n, v in
                           single["profile"]["port_kernels"].items()
                           if n.startswith("ssd_bwd_")}
        log(f"[train] ssd_chunk_bwd {k['check']['shape']} "
            f"{k['check']['dtype']} at layer 0 (N = 64, padded to the bf16 "
            f"kernels' 128): within {SSD_BWD_TOL} of each output's max |g| "
            f"of plain (share of the tolerance: " + ", ".join(
                f"{n} {k['check'][n]:.3g}" for n in ("dx", "dB", "dC", "dda"))
            + f"), two calls equal bit for bit; kernels {t['ms']:.4f} ms "
            f"(N = 128 in part (5): " + (f"{ssd_n128_ms:.4f} ms" if
                                         ssd_n128_ms else "not measured")
            + f") | wrapper call "
            f"{t['wrapper_ms']:.4f} ms | plain {t['plain_ms']:.4f} ms | "
            f"bound {t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes']} "
            f"B, {t['ops']} ops) | library call: none | by kernel in the "
            f"profiled step: " + ", ".join(
                f"{n} {v:.5f}" for n, v in t["kernels_ms"].items()) +
            f" | {smi}")
    del args
    for name in ("silu_bwd", "silu_gate_prod_bwd"):
        args = calls.pop(name)
        k = single[name] = {"max_abs_err": check_silu_bwd(name, args)}
        if dev.type == "cuda":
            k["timing"] = time_silu_bwd(name, args)
            log_bwd_kernel(name, k, smi)
        del args
    args = calls.pop("silu_gate_bwd")
    k = single["silu_gate_bwd"] = {"max_abs_err": check_bwd(args),
                                   "shape": list(args[0].shape)}
    if dev.type == "cuda":
        k["timing"] = t = time_bwd(args)
        log(f"[train] silu_gate_bwd {t['shape']} {t['dtype']} (the shared "
            f"MLP, first application): bit-equal to plain; kernel "
            f"{t['ms']:.5f} ms (device, graph of 20 calls) | plain "
            f"{t['plain_ms']:.5f} ms | bound {t['bound_ms']:.5f} ms by "
            f"{t['bound_by']} ({t['bytes']} B) | library call: none | {smi}")
    del args
    fargs, bargs = calls.pop("flash_fwd"), calls.pop("flash_bwd")
    single["flash_fwd"] = {"check": check_flash_fwd(fargs)}
    single["flash_bwd"] = {"check": check_flash_bwd(bargs)}
    single["flash_bits"] = flash_bits(fargs, bargs)
    if dev.type == "cuda":
        for which, a, timer in (("fwd", fargs, time_flash_fwd),
                                ("bwd", bargs, time_flash_bwd)):
            t = single[f"flash_{which}"]["timing"] = timer(a, cfg.n_kv_heads)
            log_flash("train", which, single[f"flash_{which}"]["check"], t,
                      smi)
    del fargs, bargs, calls
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    p = single["parity"] = step_parity(
        cfg.replace(n_layers=HYBRID_PARITY_LAYERS, dtype="float32"), dev)
    log_parity({**p, "arch": cfg.arch_id})
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pod_cfg = cfg.replace(n_layers=HYBRID_POD_LAYERS)
    pods = single["pods"] = train_pods(pod_cfg, dev, forest)
    log_pods(pods, pod_cfg, cfg, smi)
    meta = lm_mod.model_class(pod_cfg)(pod_cfg, torch.device("meta"),
                                       torch.float32)
    missed = {path for path, _ in tree_items(
        {"shared_attn": param_tree(meta)["shared_attn"]})} - set(
            pods["host_sync"]["leaves"])
    if missed:
        raise AssertionError(f"4-pod hybrid: the host's redo of the first "
                             f"sync left out {sorted(missed)}")
    single["s"] = time.perf_counter() - t0
    log(f"[train] part (6) {cfg.arch_id}: {single['s']:.1f} s")
    return single


def moe_bwd_cases(calls: dict) -> list:
    """(label, name, args) of the MoE backward kernels' cases on layer
    0's inputs of a train step (`calls`: each kernel's args): as
    captured (bf16), in f32, with drops (the routing's slots recounted
    at half the capacity, the slot tensors cut to it), a ragged T (the
    last token left out, its slots recounted), rows of -0.0 in the
    cotangents and the persistent grids' edges (one token; one token
    past what gates_bwd's warps hold; one past the dispatch's
    backward's token groups; 512 tokens choosing all 32 experts, k = 32;
    rows of 2,048, each row beside its mirror; the three row tensors one
    element past 16-byte alignment)."""
    g, eidx, pos_c, keep = calls["moe_dispatch_bwd"]
    dy, gates, src = (calls["moe_combine_bwd"][i] for i in (0, 1, 5))
    ob = calls["moe_gates_bwd"][1]
    E, C = src.shape

    def of(label, eidx, pos_c, keep, src, g, ob, dy, gates):
        return [(label, "moe_dispatch_bwd", (g, eidx, pos_c, keep)),
                (label, "moe_combine_bwd", (dy, gates, eidx, pos_c, keep,
                                            src)),
                (label, "moe_gates_bwd", (dy, ob, eidx, pos_c, keep))]
    out = of("train", eidx, pos_c, keep, src, g, ob, dy, gates)
    out += of("f32", eidx, pos_c, keep, src, g.float(), ob.float(),
              dy.float(), gates)
    half = C // 2
    p2, k2, s2 = moe_slots_ref(eidx[None], E, half)
    out += of("drops", eidx, p2[0], k2[0], s2[0], g[:, :half].contiguous(),
              ob[:, :half].contiguous(), dy, gates)
    e3 = eidx[:-1].contiguous()
    p3, k3, s3 = moe_slots_ref(e3[None], E, C)
    out += of("ragged", e3, p3[0], k3[0], s3[0], g, ob,
              dy[:-1].contiguous(), gates[:-1].contiguous())
    gz, dz = g.clone(), dy.clone()
    gz[:, 0] = -0.0
    dz[1] = -0.0
    out += of("negative zeros", eidx, pos_c, keep, src, gz, ob, dz, gates)
    # the persistent grids' edges: one token, one token past what
    # gates_bwd's warps hold, one past the dispatch's backward's token
    # groups, k = 32 (512 tokens choosing all 32 experts), rows of 2,048
    # and storage one element past alignment
    warps, groups = (moe_kernels.gates_bwd_workers(ob.shape[2], ob.dtype),
                     moe_kernels.dispatch_bwd_workers(g.shape[2], g.dtype)) \
        if ob.is_cuda else (eidx.shape[1], 2)
    for T, label in ((1, "one token"),
                     (warps // eidx.shape[1] + 1, "warps + k"),
                     (groups + 1, "dispatch groups + 1")):
        T = min(T, eidx.shape[0])
        pT, kT, sT = moe_slots_ref(eidx[None, :T].contiguous(), E, C)
        out += of(label if T == 1 else f"T = {T} ({label})",
                  eidx[:T].contiguous(), pT[0], kT[0], sT[0], g, ob,
                  dy[:T].contiguous(), gates[:T].contiguous())
    e32, p32, k32 = wide_routing(512, E, C, ob.device, seed=32)
    s32 = moe_slots_ref(e32[None], E, C)[2][0]
    d32 = torch.randn(512, dy.shape[1], generator=torch.Generator(
        device="cpu").manual_seed(34)).to(dy.device, dy.dtype)
    out += of(f"k = {E}", e32, p32, k32, s32, g, ob, d32,
              torch.rand(512, E, generator=torch.Generator(
                  device="cpu").manual_seed(33)).to(gates.device))
    out += of(f"d = {2 * ob.shape[2]}", eidx, pos_c, keep, src,
              torch.cat([g, g.flip(-1)], -1), torch.cat([ob, ob.flip(-1)], -1),
              torch.cat([dy, dy.flip(-1)], -1), gates)
    out += of("unaligned", eidx, pos_c, keep, src, unaligned(g),
              unaligned(ob), unaligned(dy), gates)
    return out


def moe_train(cfg, dev, smi: str, forest, parity_cfg=None,
              pod_cfg=None) -> dict:
    """Part (7): the MoE trained as part (6) trains the hybrid
    (`train_single`: its exact counts, every step's expert_load), then
    on layer 0's inputs of one more step each MoE kernel against its
    plain version: the forwards (`moe_slots`, `moe_dispatch`,
    `moe_combine`) at the training shape, the three backwards in five
    cases each (`moe_bwd_cases`), bit for bit, two calls equal; each
    timed beside its bound, its plain version and the library call
    (`embedding_bag` for `moe_combine` and where it computes a
    backward's function); one card-against-host step (`step_parity`) of
    `parity_cfg` (default: cfg at MOE_TRAIN_PARITY_LAYERS, f32) and the
    4-pod WANify run (`train_pods`) of `pod_cfg` (default: cfg at
    MOE_POD_LAYERS)."""
    t0 = time.perf_counter()
    single = train_single(cfg, dev)
    log_single(single, smi)
    log(f"[train] {cfg.arch_id} expert_load a step over {cfg.n_layers} "
        f"layers, summed: " + ", ".join(
            f"{x * cfg.n_layers:.7f}" for x in single["expert_load_sums"]) +
        f" (each within {LOAD_SUM_TOL} of {cfg.n_layers} a layer)")
    calls = single.pop("layer0")
    floor_ms = launch_floor_ms() if dev.type == "cuda" else 0.0
    kernels = {}
    for name in MOE_KERNELS:
        c = check_moe(name, calls[name])
        c["case"] = "train"
        kernels[name] = {"checks": [c], "max_abs_err": 0.0}
        if dev.type == "cuda":
            t = kernels[name]["timing"] = time_moe(name, calls[name],
                                                   floor_ms)
            log_moe("train layer 0", name, t, [c], smi, phase="train")
    checks = {name: [] for name in MOE_BWD_KERNELS}
    for label, name, args in moe_bwd_cases(calls):
        c = check_moe(name, args)
        c["case"] = label
        checks[name].append(c)
    for name in MOE_BWD_KERNELS:
        kernels[name] = {"checks": checks[name], "max_abs_err": 0.0}
        if dev.type == "cuda":
            t = kernels[name]["timing"] = time_moe(name, calls[name],
                                                   floor_ms)
            log_moe("train layer 0", name, t, checks[name], smi,
                    phase="train")
        log(f"[train] {name} cases: " + "; ".join(
            f"{c['case']} {moe_case_text(c)}" for c in checks[name]))
    single["kernels"] = kernels
    del calls
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    p = single["parity"] = step_parity(
        parity_cfg or cfg.replace(n_layers=MOE_TRAIN_PARITY_LAYERS,
                                  dtype="float32"), dev)
    log_parity({**p, "arch": cfg.arch_id})
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pod_cfg = pod_cfg or cfg.replace(n_layers=MOE_POD_LAYERS)
    pods = single["pods"] = train_pods(pod_cfg, dev, forest)
    log_pods(pods, pod_cfg, cfg, smi)
    single["s"] = time.perf_counter() - t0
    log(f"[train] part (7) {cfg.arch_id}: {single['s']:.1f} s")
    return single


def time_flash_bwd_mla(args) -> dict:
    """Device ms of `ops.flash_bwd_mla` (dq with delta, dk / dv, the
    heads' sum) on MLA's captured train-step inputs (g, q_nope, q_rope,
    k_nope, k_rope, v, out, lse, ...), of its plain version and of
    `torch.autograd.grad` through SDPA (`is_causal`) on the reference's
    concatenations q and bf16(k), and v, the last two read in turns
    with the kernel (events over 10 calls each); beside the bound at the
    function's bytes: q's parts, k_nope (f32), the one rope key, v, g,
    out and lse read once, dq (q's dtype), dk_nope (f32), dk_rope and dv
    written once; five products over the causal half, QK^T, dS K and
    dS^T Q at Dq and g V^T and P^T g at Dv, at the bf16 tensor-core
    rate."""
    g, q_nope, q_rope, k_nope, k_rope, v, out, lse = args[:8]
    B, H, S, nd = q_nope.shape
    rd, Dv = q_rope.shape[3], v.shape[3]
    Dq, e, bhs = nd + rd, q_nope.element_size(), B * H * S
    nbytes = e * (2 * bhs * Dq + 2 * k_rope.numel() + 4 * bhs * Dv) + \
        4 * (2 * bhs * nd + bhs)
    nops = 2 * bhs * keys_used(S, 0) * (3 * Dq + 2 * Dv)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_TC_OPS_PER_S
    q, k = mla_concatenated(args[1:])
    qr, kr, vr = (t.detach().requires_grad_() for t in
                  (q[:, :, 0], k.to(q.dtype), v))
    o = torch.nn.functional.scaled_dot_product_attention(qr, kr, vr,
                                                         is_causal=True)
    go = g[:, :, 0]

    def lib():
        return torch.autograd.grad(o, (qr, kr, vr), go, retain_graph=True)
    ms, lib_ms = kernel_and_library_ms(
        lambda: ops.flash_bwd_mla(*args), lib,
        timer=lambda f: device_ms(f, launches=10))
    res = {"ms": ms, "library_ms": lib_ms,
           "library_backend": sdpa_backend(qr, kr, vr),
           "plain_ms": device_ms(lambda: flash_bwd_mla_ref(*args[:8], 512),
                                 launches=2, reps=3),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": nops}
    del o
    return res


def mla_cases(args) -> list:
    """(label, args) of flash_bwd_mla's checks on layer 0's captured
    inputs of a train step: as captured (bf16, g a strided view), a
    ragged S (the first MLA_RAGGED_S rows of every operand: causal, so
    their out and lse are the whole S's), and both in f32 (out and lse
    by the f32 forward kernel on the upcast parts)."""
    g, q_nope, q_rope, k_nope, k_rope, v = args[:6]
    # g, out [B,H,1,S,*] and lse [B,H,1,S] along their dim 3, the parts
    # [B,*,S,*] along dim 2
    cut = tuple(t.narrow(3 if i in (0, 6, 7) else 2, 0, MLA_RAGGED_S)
                for i, t in enumerate(args[:8]))
    out = [("train", args[:8]), (f"S = {MLA_RAGGED_S}", cut)]
    for label, a in (("train f32", args[:8]),
                     (f"S = {MLA_RAGGED_S} f32", cut)):
        parts = [t.float() for t in a[1:6]]
        o, lse = ops.flash_fwd_mla(*parts)
        out.append((label, (a[0].float(), *parts, o, lse)))
    return out


def mla_train(cfg, dev, smi: str, forest, parity_cfg=None,
              pod_cfg=None) -> dict:
    """Part (8): MLA (minicpm3-4b) trained as part (7) trains the MoE
    (`train_single` at MLA_TRAIN_LAYERS: its exact counts, flash's MLA
    forward and backward once a layer a step and the forward again in
    the recompute), then on layer 0's inputs of one more step
    `flash_bwd_mla` against its plain version (`check_flash_bwd_mla`) as
    captured, at a ragged S and both in f32 (`mla_cases`), two calls
    equal, and timed beside its bound, its plain version and SDPA's
    backward (`time_flash_bwd_mla`); one card-against-host step
    (`step_parity`) of `parity_cfg` (default: cfg at
    MLA_TRAIN_PARITY_LAYERS, f32) and the 4-pod WANify run (`train_pods`)
    of `pod_cfg` (default: cfg at MLA_POD_LAYERS)."""
    t0 = time.perf_counter()
    if MLA_TRAIN_LAYERS:
        cfg = cfg.replace(n_layers=MLA_TRAIN_LAYERS)
    resident = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    ops.flash_fwd.copies = 0
    single = train_single(cfg, dev)
    single["flash_copies"] = ops.flash_fwd.copies
    single["resident_before_bytes"] = resident
    log_single(single, smi)
    if single["flash_copies"]:
        raise AssertionError(f"mla train: flash's MLA wrappers copied "
                             f"{single['flash_copies']} operands dense")
    log(f"[train] {cfg.arch_id}: {cfg.n_layers} of "
        f"{get_config(MLA_ARCH).n_layers} layers; device memory held "
        f"before the run {resident / 2**30:.3f} GiB")
    if "profile" in single:
        names = single["profile"]["flash_by_name"]
        log(f"[train] {cfg.arch_id} flash kernels in the profiled step "
            f"(device ms, {cfg.n_layers} layers; the forward's twice a "
            f"layer): " + ", ".join(f"{n} {v:.3f}" for n, v in
                                    names.items()) + f"; copies of flash's "
            f"operands in the run: {single['flash_copies']}")
    calls = single.pop("layer0")
    bargs = calls.pop("flash_bwd_mla")
    checks = []
    for label, a in mla_cases(bargs):
        c = check_flash_bwd_mla(a)
        c["case"] = label
        checks.append(c)
    k = single["flash_bwd_mla"] = {"checks": checks, "max_abs_err": max(
        c["max_abs_diff"] for c in checks)}
    for c in checks:
        log(f"[train] flash_bwd (mla) {c['case']} {c['shape']} Dv {c['Dv']} "
            f"{c['dtype']}: within tolerance (" + ", ".join(
                f"{n} {c[n]['err']:.3g}" for n in ("dq_nope", "dq_rope",
                                                   "dk", "dv")) +
            f" of it; dk_rope the heads' sum of the kernels' own dk, "
            f"{c['dk_rope']['max_abs_diff']:.3g} from plain's, max "
            f"{c['dk_rope']['max_abs']:.3g}), two calls equal bit for bit")
    if dev.type == "cuda":
        t = k["timing"] = time_flash_bwd_mla(bargs)
        per_call = {n: v / cfg.n_layers for n, v in single["profile"][
            "flash_by_name"].items() if "mla" in n or "rope_sum" in n}
        t["kernels_ms"] = per_call
        log(f"[train] flash_bwd (mla) at layer 0: kernels {t['ms']:.5f} ms "
            f"(device, events over 10 calls; in the profiled step a call: "
            + ", ".join(f"{n} {v:.5f}" for n, v in per_call.items()) +
            f") | plain {t['plain_ms']:.4f} ms | bound {t['bound_ms']:.5f} "
            f"ms by {t['bound_by']} ({t['bytes']} B, {t['ops']:.4g} ops) | "
            f"library (autograd.grad through SDPA on q, bf16(k), v) "
            f"{t['library_ms']:.5f} ms by {t['library_backend']} | {smi}")
    del bargs, calls
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    p = single["parity"] = step_parity(
        parity_cfg or cfg.replace(n_layers=MLA_TRAIN_PARITY_LAYERS,
                                  dtype="float32"), dev)
    log_parity({**p, "arch": cfg.arch_id})
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pod_cfg = pod_cfg or cfg.replace(n_layers=MLA_POD_LAYERS)
    pods = single["pods"] = train_pods(pod_cfg, dev, forest)
    log_pods(pods, pod_cfg, get_config(MLA_ARCH), smi)
    single["s"] = time.perf_counter() - t0
    log(f"[train] part (8) {cfg.arch_id}: {single['s']:.1f} s")
    return single


def train_phase(dev, smi: str, cfg=None, pod_cfg=None, parity_cfgs=None,
                ssm_cfg=None, ssm_parity_cfg=None, hybrid_cfg=None,
                moe_cfg=None, mla_cfg=None) -> dict:
    """The train phase (see the head comment); every check fatal. The
    configs default to the full ones (`cfg`: TRAIN_ARCH; `pod_cfg`: it at
    POD_LAYERS; `parity_cfgs`: DENSE_ARCHS at PARITY_LAYERS, f32;
    `ssm_cfg`: SSM_TRAIN_ARCH; `ssm_parity_cfg`: it at PARITY_LAYERS,
    f32; `hybrid_cfg`: HYBRID_ARCH, cut by `hybrid_train`; `moe_cfg`:
    MOE_ARCH, cut by `moe_train`; `mla_cfg`: MLA_ARCH, cut by
    `mla_train`)."""
    t_phase = time.perf_counter()
    # the reference training CLI's forest (src/repro/launch/train.py)
    forest, _, _ = train_default_forest(n_samples=150, n_trees=40)
    cfg = cfg or get_config(TRAIN_ARCH)
    single = train_single(cfg, dev)
    log_single(single, smi)
    fwd_args, fwd_kw = single.pop("fwd_call")
    single["silu_gate"] = {"max_abs_err": check_silu("silu_gate", fwd_args,
                                                     fwd_kw),
                           "shape": list(fwd_args[0].shape),
                           "kw": fwd_kw}
    log(f"[train] silu_gate {list(fwd_args[0].shape)} "
        f"{str(fwd_args[0].dtype).replace('torch.', '')} {fwd_kw} at a "
        f"train step's first layer: bit-equal to plain")
    del fwd_args
    args = single.pop("bwd_args")
    err = check_bwd(args)
    single["silu_gate_bwd"] = {"max_abs_err": err}
    if dev.type == "cuda":
        t = time_bwd(args)
        single["silu_gate_bwd"]["timing"] = t
        log(f"[train] silu_gate_bwd {t['shape']} {t['dtype']}: bit-equal to "
            f"plain; kernel {t['ms']:.5f} ms (device, graph of 20 calls) | "
            f"plain {t['plain_ms']:.5f} ms | bound {t['bound_ms']:.5f} ms by "
            f"{t['bound_by']} ({t['bytes']} B) | library call: none | {smi}")
    del args
    # the flash kernels against their plain versions on layer 0's inputs
    # of one more step, timed there beside the plain versions, SDPA
    # (forward; autograd.grad through it) and the bounds
    fargs, bargs = single.pop("flash_args")
    single["flash_fwd"] = {"check": check_flash_fwd(fargs)}
    single["flash_bwd"] = {"check": check_flash_bwd(bargs)}
    single["flash_bits"] = flash_bits(fargs, bargs)
    log(f"[train] flash_fwd / flash_bwd {single['flash_bits']['shape']} "
        f"{single['flash_bits']['dtype']}: two calls each, out, lse, dq, dk "
        f"and dv equal bit for bit")
    if dev.type == "cuda":
        for which, a, timer in (("fwd", fargs, time_flash_fwd),
                                ("bwd", bargs, time_flash_bwd)):
            t = single[f"flash_{which}"]["timing"] = timer(
                a, cfg.n_kv_heads)
            log_flash("train", which, single[f"flash_{which}"]["check"], t,
                      smi)
    del fargs, bargs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    parity = {}
    for pcfg in parity_cfgs or [get_config(a).replace(
            n_layers=PARITY_LAYERS, dtype="float32") for a in DENSE_ARCHS]:
        parity[pcfg.arch_id] = p = step_parity(pcfg, dev)
        log_parity({**p, "arch": pcfg.arch_id})
    pod_cfg = pod_cfg or cfg.replace(n_layers=POD_LAYERS)
    pods = train_pods(pod_cfg, dev, forest)
    log_pods(pods, pod_cfg, cfg, smi)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ssm_part = ssm_train(ssm_cfg or get_config(SSM_TRAIN_ARCH), dev, smi,
                         ssm_parity_cfg)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    hybrid_part = hybrid_train(
        hybrid_cfg or get_config(HYBRID_ARCH), dev, smi, forest,
        ssm_part["ssd_chunk_bwd"].get("timing", {}).get("ms"))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    moe_part = moe_train(moe_cfg or get_config(MOE_ARCH), dev, smi, forest)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mla_part = mla_train(mla_cfg or get_config(MLA_ARCH), dev, smi, forest)
    out = {"single": single, "parity": parity, "pods": pods,
           "ssm": ssm_part, "hybrid": hybrid_part, "moe": moe_part,
           "mla": mla_part, "s": time.perf_counter() - t_phase}
    log(f"[train] phase {out['s']:.2f} s")
    return out


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
        timing[-1]["us_per_iter_above_floor"] = \
            (timing[-1]["ms"] - floor_ms) * 1e3 / max(max(c["iters"]), 1)
        log(f"[scenarios] waterfill B={B} N={n}: iterations "
            f"{min(c['iters'])}-{max(c['iters'])}, equal to the plain "
            f"version's and the host loop's; max |diff| {c['err_plain']:.3g}"
            f" (plain), {c['err_host']:.3g} (host loop), tolerance {WF_TOL}")
    for t in timing:
        log(f"[scenarios] waterfill B={t['B']} N={t['N']} "
            f"({sum(t['iters'])} iterations in all, {max(t['iters'])} in "
            f"the longest fill): kernel {t['ms']:.5f} ms (device, graph of "
            f"20 calls), {t['us_per_iter']:.3f} us an iteration, "
            f"{t['us_per_iter_above_floor']:.3f} above the launch floor | "
            f"launch floor {floor_ms:.5f} ms | numpy call "
            f"{t['wrapper_us']:.1f} us (host, one C call: copies, launch, "
            f"sync) | host loop {t['host_loop_us']:.1f} us "
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
                                   "silu", "waterfill", "flash_attn", "moe"])
    results["build_s"] = time.perf_counter() - t0
    log(f"[build] rf_predict + ssd_chunk + quantize + silu + waterfill + "
        f"flash_attn + moe in {results['build_s']:.1f} s")
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
    # the backward's kernels (f32: four on the CUDA cores; bf16: three,
    # two of them wgmma): registers and spills; HGMMA in the bf16 wgmma
    # kernels' own SASS (the library's count passes on the forward alone)
    bwd_spills = {n: report.get(n) for n in ssd_scan.BWD_KERNELS
                  if "registers" not in report.get(n, {}) or
                  report[n].get("spill_stores") or
                  report[n].get("spill_loads")}
    if bwd_spills:
        raise AssertionError(f"ssd_chunk's backward kernels missing from "
                             f"ptxas's report or spilling: {bwd_spills}")
    bwd_sass = sass_counts_by_kernel(build.library_path("ssd_chunk"),
                                     ssd_scan.BWD_TC_KERNELS)
    results["build_ssd"]["bwd_sass"] = bwd_sass
    for name in ssd_scan.BWD_TC_KERNELS:
        log(f"[build] ssd_chunk backward {name}: SASS " + ", ".join(
            f"{k} {v}" for k, v in bwd_sass[name].items()) + "; registers "
            f"{report[name]['registers']}, dynamic shared memory "
            f"{report[name]['dynamic_smem']} B (the forward's "
            f"ssd_chunk_bf16_kernel: registers "
            f"{report['ssd_chunk_bf16_kernel'].get('registers')}, "
            f"{report['ssd_chunk_bf16_kernel']['dynamic_smem']} B)")
    no_tc = [n for n in ssd_scan.BWD_TC_KERNELS if bwd_sass[n]["HGMMA"] == 0]
    if no_tc:
        raise AssertionError(f"no HGMMA instruction in the SASS of "
                             f"ssd_chunk's backward kernels {no_tc}")
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

    moe_report = ptxas_report(texts["moe"], MOE_KERNEL_NAMES)
    results["build_moe"] = {"kernels": moe_report}
    for name in MOE_KERNEL_NAMES:
        log(f"[build] moe: {name}: " + ", ".join(
            f"{k} {v}" for k, v in moe_report.get(name, {}).items()))
    moe_spills = {n: r for n, r in moe_report.items()
                  if r.get("spill_stores") or r.get("spill_loads")}
    if set(moe_report) != set(MOE_KERNEL_NAMES) or moe_spills:
        raise AssertionError(f"moe's ptxas report: kernels "
                             f"{sorted(moe_report)}, spills {moe_spills}")

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
    silu_sass = sass_per_element(build.library_path("silu"),
                                 SILU_STREAM_KERNELS, SILU_SLOTS)
    results["build_silu"] = {"kernels": silu_report, "sass": silu_sass}
    for name in SILU_KERNELS:
        sass = silu_sass.get(name)
        log(f"[build] silu: {name}: " + ", ".join(
            f"{k} {v}" for k, v in silu_report.get(name, {}).items()) + (
            "" if sass is None else
            f"; bf16 16-byte walk: {sass['per_element']:.2f} SASS "
            f"instructions an element (a chunk's body, first 16-byte load "
            f"to its last store, {SILU_SLOTS * 8} elements a lane), "
            f"{sass['function']} in the function"))
    missing = sorted(set(SILU_STREAM_KERNELS) - set(silu_sass))
    if missing:
        raise AssertionError(f"silu's SASS: no 16-byte walk found in "
                             f"{missing}")
    silu_spills = {n: r for n, r in silu_report.items()
                   if r.get("spill_stores") or r.get("spill_loads")}
    if set(silu_report) != set(SILU_KERNELS) or silu_spills:
        raise AssertionError(f"silu's ptxas report: kernels "
                             f"{sorted(silu_report)}, spills {silu_spills}")
    # waterfill: registers and spills of each kernel, and its block
    # barriers (BAR) in SASS: none in the warp kernel, whose rounds are
    # warp syncs, shuffles and votes
    wf_report = ptxas_report(texts["waterfill"], WF_KERNELS)
    wf_bars = sass_counts_by_kernel(build.library_path("waterfill"),
                                    WF_KERNELS, sass_ops=("BAR",))
    results["build_waterfill"] = {"kernels": wf_report, "sass": wf_bars}
    for name in WF_KERNELS:
        log(f"[build] waterfill: {name}: " + ", ".join(
            f"{k} {v}" for k, v in wf_report.get(name, {}).items())
            + f"; block barriers (BAR) in SASS {wf_bars[name]['BAR']}")
    wf_spills = {n: r for n, r in wf_report.items()
                 if r.get("spill_stores") or r.get("spill_loads")}
    if set(wf_report) != set(WF_KERNELS) or wf_spills or \
            wf_bars["waterfill_warp_kernel"]["BAR"] or \
            not wf_bars["waterfill_block_kernel"]["BAR"]:
        raise AssertionError(f"waterfill's ptxas report: kernels "
                             f"{sorted(wf_report)}, spills {wf_spills}; "
                             f"BAR in SASS {wf_bars}")
    # flash_attn: registers and spills (the largest of each kernel's
    # template instances: D = 128 and 80), and in the bf16 kernels wgmma
    # (HGMMA) fed by TMA (UTMALDG), none of their instances spilling
    fl_report = ptxas_report(texts["flash_attn"], FLASH_KERNELS)
    fl_sass = sass_counts_by_kernel(build.library_path("flash_attn"),
                                    FLASH_KERNELS)
    results["build_flash"] = {"kernels": fl_report, "sass": fl_sass}
    for name in FLASH_KERNELS:
        log(f"[build] flash_attn: {name}: " + ", ".join(
            f"{k} {v}" for k, v in fl_report.get(name, {}).items())
            + "; SASS " + ", ".join(f"{k} {v}" for k, v in
                                    fl_sass[name].items() if v))
    mla_regs = ptxas_report(texts["flash_attn"], (FLASH_MLA_INSTANCE,))
    results["build_flash"]["mla_instance"] = mla_regs
    log(f"[build] flash_attn: the forward's MLA instance <1, 32, 1, 0, "
        f"true>: " + ", ".join(f"{k} {v}" for k, v in mla_regs.get(
            FLASH_MLA_INSTANCE, {}).items()))
    no_tc = [n for n in FLASH_TC_KERNELS
             if not (fl_sass[n]["HGMMA"] and fl_sass[n]["UTMALDG"])]
    fl_spills = {n: fl_report[n] for n in FLASH_TC_KERNELS
                 if fl_report.get(n, {}).get("spill_stores") or
                 fl_report.get(n, {}).get("spill_loads")}
    if set(fl_report) != set(FLASH_KERNELS) or no_tc or fl_spills:
        raise AssertionError(f"flash_attn: ptxas reports kernels "
                             f"{sorted(fl_report)}; no HGMMA or no UTMALDG "
                             f"in {no_tc}; spills {fl_spills}")

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
            f"B) | library call: {lib_text(t)}")
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
                f" | library call: {quant_lib_text(kname, t, k)}")
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

    # 12. dense: llama3-8b served at full size through the silu_gate
    # kernel, the three dense archs' card-vs-host parity, the attention
    # core beside SDPA
    dense = dense_phase(paper, dev, smi)
    results["dense"] = dense

    # 12b. hybrid: zamba2-2.7b served at full size (its shared attention
    # block nine times a step), its kernels at the hybrid's shapes, a
    # 7-layer card-vs-host parity
    hybrid = hybrid_phase(paper, dev, smi, ssd_timing[0]["ms"])
    results["hybrid"] = hybrid

    # 12c. moe: granite-moe-1b-a400m served at full size through the
    # moe_dispatch / moe_combine kernels, the kernels at the MoE's
    # shapes, a 2-layer card-vs-host parity
    moe_res = moe_phase(paper, dev, smi, floor_ms)
    results["moe"] = moe_res

    # 12d. mla: minicpm3-4b served at full size through flash_fwd's MLA
    # form (Dq 96, Dv 64, f32 keys split hi / lo), the kernel against its
    # plain version, SDPA and the bound, a 2-layer card-vs-host parity
    mla = mla_phase(paper, dev, smi)
    results["mla"] = mla

    # 13. train: h2o-danube-1.8b trained at full size through the
    # silu_gate kernels, the three dense archs' card-vs-host train step,
    # the 4-pod WANify Trainer; then mamba2-2.7b, zamba2-2.7b,
    # granite-moe-1b-a400m and minicpm3-4b trained (parts (5)-(8))
    train = train_phase(dev, smi)
    results["train"] = train

    t = timing[f"n{TICK_ROWS}"]
    s0 = ssd_timing[0]
    wf = scen["waterfill"]["timing"][0]          # one 8-DC fill
    qs = q_timing["part_state_c8"]
    dg = dense["serve"]["silu_gate"]["timing"]["prefill1"]
    tb = train["single"]["silu_gate_bwd"]["timing"]
    ff = dense["serve"]["flash_fwd"]
    fb = train["single"]["flash_bwd"]
    st = train["ssm"]
    ht = train["hybrid"]
    hk = hybrid["kernels"]
    mk = moe_res["kernels"]
    mf = mla["serve"]["flash_fwd"]
    mt = train["moe"]
    ml = train["mla"]
    mb = ml["flash_bwd_mla"]["timing"]
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
        "library_ms": None}, {
        "name": "ssd_chunk (hybrid, N=64)", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:59",
        "launches": hybrid["serve"]["launches"]["ssd_chunk"],
        "max_abs_err": hk["ssd_chunk"]["max_abs_err"],
        "ms": hk["ssd_chunk"]["timing"]["ms"],
        "plain_ms": hk["ssd_chunk"]["timing"]["plain_ms"],
        "bound_ms": hk["ssd_chunk"]["timing"]["bound_ms"],
        "bound_by": hk["ssd_chunk"]["timing"]["bound_by"],
        "library_ms": None}] + [{
        "name": kname, "route": "cuda",
        "source": "src/repro_torch/csrc/quantize.cu",
        "replaces": f"src/repro/kernels/quantize.py:{line}",
        "launches": mig_launches[kname], "max_abs_err": q_err,
        "ms": qs[kname]["ms"], "plain_ms": qs[kname]["plain_ms"],
        "bound_ms": qs[kname]["bound_ms"],
        "bound_by": qs[kname]["bound_by"],
        "library_ms": qs[kname]["library_ms"]}
        for kname, line in (("quantize", 37), ("dequantize", 61))] + [{
        "name": kname, "route": "cuda",
        "source": "src/repro_torch/csrc/silu.cu",
        "replaces": f"src/repro/models/ssm.py:{line}",
        "launches": serve_counts[kname], "max_abs_err": silu_err,
        "ms": silu_timing[f"{kname}_prefill1"]["ms"],
        "plain_ms": silu_timing[f"{kname}_prefill1"]["plain_ms"],
        "bound_ms": silu_timing[f"{kname}_prefill1"]["bound_ms"],
        "bound_by": silu_timing[f"{kname}_prefill1"]["bound_by"],
        "library_ms": silu_timing[f"{kname}_prefill1"]["library_ms"]}
        for kname, line in (("silu", 137), ("silu_gate", 152))] + [{
        "name": "silu_gate (dense MLP)", "route": "cuda",
        "source": "src/repro_torch/csrc/silu.cu",
        "replaces": "src/repro/models/layers.py:89",
        "launches": dense["serve"]["launches"]["silu_gate"],
        "max_abs_err": dense["serve"]["silu_gate"]["max_abs_err"],
        "ms": dg["ms"], "plain_ms": dg["plain_ms"],
        "bound_ms": dg["bound_ms"], "bound_by": dg["bound_by"],
        "library_ms": None}] + [{
        "name": "silu_gate_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/silu.cu",
        "replaces": "src/repro/models/layers.py:89",
        "launches": train["single"]["launches"]["silu_gate_bwd"],
        "max_abs_err": train["single"]["silu_gate_bwd"]["max_abs_err"],
        "ms": tb["ms"], "plain_ms": tb["plain_ms"],
        "bound_ms": tb["bound_ms"], "bound_by": tb["bound_by"],
        "library_ms": None}] + [{
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/models/attention.py:39",
        "launches": dense["serve"]["launches"]["flash_fwd"],
        "max_abs_err": max(c["out"]["max_abs_diff"]
                           for c in ff["checks"]),
        "ms": ff["timing"]["ms"], "plain_ms": ff["timing"]["plain_ms"],
        "bound_ms": ff["timing"]["bound_ms"],
        "bound_by": ff["timing"]["bound_by"],
        "library_ms": ff["timing"]["library_ms"]}, {
        "name": "flash_fwd (hybrid, D=80, MHA)", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/models/attention.py:39",
        "launches": hybrid["serve"]["launches"]["flash_fwd"],
        "max_abs_err": max(c["out"]["max_abs_diff"]
                           for c in hk["flash_fwd"]["checks"]),
        "ms": hk["flash_fwd"]["timing"]["ms"],
        "plain_ms": hk["flash_fwd"]["timing"]["plain_ms"],
        "bound_ms": hk["flash_fwd"]["timing"]["bound_ms"],
        "bound_by": hk["flash_fwd"]["timing"]["bound_by"],
        "library_ms": hk["flash_fwd"]["timing"]["library_ms"]}, {
        "name": "flash_fwd (moe, D=64, MHA)", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/models/attention.py:39",
        "launches": moe_res["serve"]["launches"]["flash_fwd"],
        "max_abs_err": max(c["out"]["max_abs_diff"]
                           for c in mk["flash_fwd"]["checks"]),
        "ms": mk["flash_fwd"]["timing"]["ms"],
        "plain_ms": mk["flash_fwd"]["timing"]["plain_ms"],
        "bound_ms": mk["flash_fwd"]["timing"]["bound_ms"],
        "bound_by": mk["flash_fwd"]["timing"]["bound_by"],
        "library_ms": mk["flash_fwd"]["timing"]["library_ms"]}, {
        "name": "flash_fwd (mla parts, Dq=64+32, Dv=64, f32 keys)",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/models/attention.py:39",
        "launches": mla["serve"]["launches"]["flash_fwd"],
        "max_abs_err": max(c["out"]["max_abs_diff"] for c in mf["checks"]),
        "ms": mf["timing"]["ms"], "plain_ms": mf["timing"]["plain_ms"],
        "bound_ms": mf["timing"]["bound_ms"],
        "bound_by": mf["timing"]["bound_by"],
        "library_ms": mf["timing"]["library_ms"]}, {
        "name": "silu_gate (moe experts)", "route": "cuda",
        "source": "src/repro_torch/csrc/silu.cu",
        "replaces": "src/repro/models/moe.py:104",
        "launches": moe_res["serve"]["launches"]["silu_gate"],
        "max_abs_err": mk["silu_gate"]["max_abs_err"],
        "ms": mk["silu_gate"]["ms"], "plain_ms": mk["silu_gate"]["plain_ms"],
        "bound_ms": mk["silu_gate"]["bound_ms"],
        "bound_by": mk["silu_gate"]["bound_by"],
        "library_ms": mk["silu_gate"]["library_ms"]}] + [{
        "name": f"{kname}{tag}", "route": "cuda",
        "source": "src/repro_torch/csrc/moe.cu",
        "replaces": f"src/repro/models/moe.py:{lines}",
        "launches": moe_res["serve"]["launches"][kname],
        "max_abs_err": mk[kname]["max_abs_err"],
        "ms": mk[kname]["timing"][step]["ms"],
        "plain_ms": mk[kname]["timing"][step]["plain_ms"],
        "bound_ms": mk[kname]["timing"][step]["bound_ms"],
        "bound_by": mk[kname]["timing"][step]["bound_by"],
        "library_ms": mk[kname]["timing"][step]["library_ms"]}
        for kname, lines in (("moe_slots", "83-90"),
                             ("moe_dispatch", "98-100"),
                             ("moe_combine", "115-118"))
        for step, tag in (("prefill1", ""), ("decode", " (decode)"))] + [{
        "name": "flash_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/models/attention.py:99",
        "launches": train["single"]["launches"]["flash_bwd"],
        "max_abs_err": max(fb["check"][n]["max_abs_diff"]
                           for n in ("dq", "dk", "dv")),
        "ms": fb["timing"]["ms"], "plain_ms": fb["timing"]["plain_ms"],
        "bound_ms": fb["timing"]["bound_ms"],
        "bound_by": fb["timing"]["bound_by"],
        "library_ms": fb["timing"]["library_ms"]}, {
        "name": "flash_bwd (MLA)", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/models/attention.py:99",
        "launches": ml["launches"]["flash_bwd"],
        "max_abs_err": ml["flash_bwd_mla"]["max_abs_err"],
        "ms": mb["ms"], "plain_ms": mb["plain_ms"],
        "bound_ms": mb["bound_ms"], "bound_by": mb["bound_by"],
        "library_ms": mb["library_ms"]}] + [{
        "name": kname, "route": "cuda",
        "source": f"src/repro_torch/csrc/{src}",
        "replaces": f"src/repro/models/ssm.py:{line}",
        "launches": st["launches"][kname],
        "max_abs_err": st[kname]["check"]["max_abs_err"]
        if kname == "ssd_chunk_bwd" else st[kname]["max_abs_err"],
        "ms": st[kname]["timing"]["ms"],
        "plain_ms": st[kname]["timing"]["plain_ms"],
        "bound_ms": st[kname]["timing"]["bound_ms"],
        "bound_by": st[kname]["timing"]["bound_by"],
        "library_ms": st[kname]["timing"]["library_ms"]}
        for kname, src, line in (("ssd_chunk_bwd", "ssd_chunk.cu", 59),
                                 ("silu_bwd", "silu.cu", 137),
                                 ("silu_gate_prod_bwd", "silu.cu", 152))] + [{
        "name": f"{kname} (hybrid train)", "route": "cuda",
        "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
        "launches": ht["launches"][kname], "max_abs_err": err,
        "ms": ht[kname]["timing"]["ms"],
        "plain_ms": ht[kname]["timing"]["plain_ms"],
        "bound_ms": ht[kname]["timing"]["bound_ms"],
        "bound_by": ht[kname]["timing"]["bound_by"],
        "library_ms": ht[kname]["timing"].get("library_ms")}
        for kname, src, replaces, err in (
            ("ssd_chunk_bwd", "ssd_chunk.cu", "src/repro/models/ssm.py:59",
             ht["ssd_chunk_bwd"]["check"]["max_abs_err"]),
            ("silu_bwd", "silu.cu", "src/repro/models/ssm.py:137",
             ht["silu_bwd"]["max_abs_err"]),
            ("silu_gate_prod_bwd", "silu.cu", "src/repro/models/ssm.py:152",
             ht["silu_gate_prod_bwd"]["max_abs_err"]),
            ("silu_gate_bwd", "silu.cu", "src/repro/models/layers.py:89",
             ht["silu_gate_bwd"]["max_abs_err"]),
            ("flash_fwd", "flash_attn.cu", "src/repro/models/attention.py:39",
             ht["flash_fwd"]["check"]["out"]["max_abs_diff"]),
            ("flash_bwd", "flash_attn.cu", "src/repro/models/attention.py:99",
             max(ht["flash_bwd"]["check"][n]["max_abs_diff"]
                 for n in ("dq", "dk", "dv"))))] + [{
        "name": f"{kname} (moe train)", "route": "cuda",
        "source": "src/repro_torch/csrc/moe.cu",
        "replaces": f"src/repro/models/moe.py:{lines}",
        "launches": mt["launches"][kname],
        "max_abs_err": mt["kernels"][kname]["max_abs_err"],
        "ms": mt["kernels"][kname]["timing"]["ms"],
        "plain_ms": mt["kernels"][kname]["timing"]["plain_ms"],
        "bound_ms": mt["kernels"][kname]["timing"]["bound_ms"],
        "bound_by": mt["kernels"][kname]["timing"]["bound_by"],
        "library_ms": mt["kernels"][kname]["timing"]["library_ms"]}
        for kname, lines in (("moe_slots", "83-90"),
                             ("moe_dispatch", "98-100"),
                             ("moe_combine", "115-118"),
                             ("moe_dispatch_bwd", "98-100"),
                             ("moe_combine_bwd", "115-118"),
                             ("moe_gates_bwd", "115-118"))] + [{
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
