"""Interleaved A/B of two builds of the SSD chunk's backward on the card.

Builds this tree's `csrc/ssd_chunk.cu` (`kernels/build.py`) and a second
source of its C interface (`--other`, e.g. a parent commit's
`ssd_chunk.cu` unpacked with `git archive`) with the same nvcc flags,
then times `ssd_chunk_bwd` through each library in turn (A B B A in
each of ROUNDS rounds; device ms a call from CUDA events around
back-to-back calls, outputs and scratch allocated in each call as the
wrapper does) at the train shape of mamba2-2.7b in bf16 and at a ragged
shape (SHAPES). A source whose backward takes three scratch buffers
(the four CUDA-core kernels, before the wgmma design) gets them as that
design's wrapper allocated them. Per side it reports the kernels' device
ms by name (`torch.profiler`), the scratch bytes, each output's largest
share of the tolerance against `ssd_chunk_bwd_ref` (as chip_smoke.py's
`check_ssd_bwd`: 1e-4 of each output's max |g|, bf16 outputs also one
bf16 step) and whether two calls give the same bits; beside them the
bound (`chip_smoke.ssd_bwd_bound`). Prints the card's name and power
limit and writes every number to chiprun_out/ssd_bwd_ab.json. Run on
the card, e.g. against a parent unpacked under build/parent:

    python3 scripts/ssd_bwd_ab.py \\
        --other build/parent/src/repro_torch/csrc/ssd_chunk.cu
"""
import argparse
import ctypes
import json
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.ref import ssd_chunk_bwd_ref  # noqa: E402

ROUNDS = 3
# (B, nC, Q, H, P, N): the train step's (4 sequences of 1,024 tokens in
# chunks of 256, 80 heads); full widths with a ragged Q and a partial
# head group
SHAPES = ((4, 4, 256, 80, 64, 128), (1, 2, 200, 13, 64, 128))
OUTS = ("dx", "dB", "dC", "dda")


def inputs(shape, seed=0):
    """x, B, C (bf16), da, dy, dst (f32) on the card, seeded."""
    B, nC, Q, H, P, N = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device="cuda") * scale
    return [randn(B, nC, Q, H, P, scale=0.1).bfloat16(),
            randn(B, nC, Q, N, scale=0.3).bfloat16(),
            randn(B, nC, Q, N, scale=0.3).bfloat16(),
            -randn(B, nC, H, Q).abs() * 0.1, randn(B, nC, Q, H, P),
            randn(B, nC, H, P, N)]


def old_scratch(B, nC, Q, H, N):
    """The three buffers of the CUDA-core design: C B^T, every head's
    dS o L and r o (x dst)."""
    return {"cb": (B * nC, Q, Q), "dGh": (B * nC, H, Q, Q),
            "dB2h": (B * nC, H, Q, N)}


def caller(lib):
    """ssd_chunk_bwd through `lib` as the wrapper calls it; and the
    scratch shapes it allocates."""
    new = hasattr(lib, "ssd_chunk_bwd_heads")
    lib.ssd_chunk_bwd_launch.argtypes = \
        [ctypes.c_void_p] * (15 if new else 13) + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    lib.ssd_chunk_bwd_launch.restype = ctypes.c_int

    def shapes(xq, Bq):
        B, nC, Q, H, _ = xq.shape
        N = Bq.shape[-1]
        return (ssd_scan.bwd_scratch(B, nC, Q, H, N, True) if new
                else old_scratch(B, nC, Q, H, N))

    def call(xq, Bq, Cq, da, dy, dst):
        B, nC, Q, H, P = xq.shape
        outs = [torch.empty_like(xq), torch.empty_like(Bq),
                torch.empty_like(Cq), torch.empty_like(da)]
        scratch = [torch.empty(s, dtype=torch.float32, device="cuda")
                   for s in shapes(xq, Bq).values()]
        if new:
            scratch += [scratch[0]] * (5 - len(scratch))
        err = lib.ssd_chunk_bwd_launch(
            *(t.data_ptr() for t in (xq, Bq, Cq, da, dy, dst, *outs,
                                     *scratch)),
            1, B * nC, Q, H, P, Bq.shape[-1],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ssd_chunk_bwd_launch: error {err}")
        return outs
    return call, shapes


def shares(got, want):
    """Per output, the largest share of chip_smoke's tolerance."""
    out = {}
    for name, g, w in zip(OUTS, got, want):
        g, w = g.float(), w.float()
        rtol = 2.0 ** -7 if name != "dda" else 0.0
        atol = chip_smoke.SSD_BWD_TOL * w.abs().max()
        out[name] = float(((g - w).abs() / (atol + rtol * w.abs())).max())
    return out


def kernel_ms(fn, calls=5) -> dict:
    """Device ms a call of each kernel `fn` launches, by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"\w+_kernel(<\w+>)?", e.name)
            name = m.group(0) if m else e.name
            by[name] = by.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / calls
    return by


def main() -> int:
    """Build both libraries, check and time both sides at SHAPES."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    print(smi)
    mine = ssd_scan._lib()
    res = {"smi": smi, "rounds": ROUNDS, "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        other = build.load_other(args.other, Path(tmp) / "other.so", mine,
                                 ("ssd_chunk_error_string",))
        sides = {"this": caller(mine), "parent": caller(other)}
        for shape in SHAPES:
            a = inputs(shape)
            want = ssd_chunk_bwd_ref(*a)
            bound_ms, by, nbytes, nops = chip_smoke.ssd_bwd_bound(a[0], a[1])
            case = {"shape": list(shape), "bound_ms": bound_ms,
                    "bound_by": by, "bytes": nbytes, "ops": nops}
            for lab, (call, shapes) in sides.items():
                got, again = call(*a), call(*a)
                torch.cuda.synchronize()
                case[lab] = {
                    "scratch_bytes": 4 * sum(int(np.prod(s)) for s in
                                             shapes(a[0], a[1]).values()),
                    "shares": shares(got, want),
                    "bits_equal": all(torch.equal(p, q)
                                      for p, q in zip(got, again)),
                    "kernels_ms": kernel_ms(lambda: call(*a)), "ms": []}
                del got, again
            for _ in range(ROUNDS):
                for lab in ("this", "parent", "parent", "this"):
                    call = sides[lab][0]
                    case[lab]["ms"].append(chip_smoke.device_ms(
                        lambda: call(*a), launches=10, reps=5))
            this_r = np.reshape(case["this"]["ms"], (ROUNDS, 2)).mean(1)
            par_r = np.reshape(case["parent"]["ms"], (ROUNDS, 2)).mean(1)
            case["this_faster_every_round"] = bool(all(this_r < par_r))
            res["cases"]["x".join(map(str, shape))] = case
            for lab in ("this", "parent"):
                c = case[lab]
                print(f"{shape} bf16 {lab}: median {np.median(c['ms']):.5f} "
                      f"ms {np.round(c['ms'], 5).tolist()}; kernels " +
                      ", ".join(f"{k} {v:.5f}" for k, v in
                                c["kernels_ms"].items()) +
                      f"; scratch {c['scratch_bytes']} B; shares of the "
                      f"tolerance " + ", ".join(
                          f"{k} {v:.4f}" for k, v in c["shares"].items()) +
                      f"; two calls equal: {c['bits_equal']}")
            print(f"{shape}: bound {bound_ms:.5f} ms by {by} ({nbytes} B, "
                  f"{nops} ops); this faster in every round: "
                  f"{case['this_faster_every_round']} | {smi}")
            del a, want
            torch.cuda.empty_cache()
    out = ROOT / "chiprun_out" / "ssd_bwd_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
