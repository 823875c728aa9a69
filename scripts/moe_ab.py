"""Interleaved A/B of two builds of the MoE dispatch and combine kernels
on the card.

Builds this tree's `csrc/moe.cu` (`kernels/build.py`) and a second
source of the same C interface (`--other`, e.g. a parent commit's
`moe.cu` unpacked with `git archive`, or an earlier design kept under
build/) with the same nvcc flags, then times `ops.moe_dispatch` and
`ops.moe_combine` through each library in turn (A B B A in each of
ROUNDS rounds; CUDA graphs of 20 calls, no host issue in the reading) at
the MoE serve's shapes of `granite-moe-1b-a400m` (CASES), each beside
`torch.index_select` computing the dispatch's buffer (the library call;
the combine has none), the bound (`chip_smoke.moe_bound`) and the launch
floor. The routing is made from a seed as the serve's is: top-8 of 32
experts by a skewed random score, the first 456 tokens (the left pads of
group 1's four prompts) routed alike, slots by the cumulative count
(`models.moe.positions`). Every output of the two builds is held equal
bit for bit. Prints the card's name and power limit and writes every
number to chiprun_out/moe_ab.json. Run on the card:

    python3 scripts/moe_ab.py --other build/parent/src/repro_torch/csrc/moe.cu
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import moe as _moe  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402

ROUNDS = 3
FNS = ("moe_dispatch_launch", "moe_combine_launch", "moe_error_string")
E, K, D = 32, 8, 1024
# label -> (T, C, pad tokens routed alike): group 1's prefill (4 x 641
# tokens, C = 804), group 2's (4 x 423, C = 532) and a decode step
CASES = {"prefill1": (2564, 804, 456), "prefill2": (1692, 532, 0),
         "decode": (4, 4, 0)}


def routing(T: int, C: int, pads: int, seed: int):
    """(eidx, pos_c, keep) on the card for T tokens."""
    rng = np.random.default_rng(seed)
    score = rng.normal(size=(T, E)) + np.linspace(0.0, 1.0, E)
    score[:pads] = score[0]
    eidx = torch.from_numpy(np.argsort(-score, axis=1)[:, :K].copy()).cuda()
    pos_c, keep = moe_mod.positions(eidx[None], E, C)
    return eidx, pos_c[0].contiguous(), keep[0].contiguous()


def inputs(label: str):
    T, C, pads = CASES[label]
    eidx, pos_c, keep = routing(T, C, pads, seed=T)
    g = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn(T, D, generator=g, device="cuda").bfloat16()
    ob = torch.randn(E, C, D, generator=g, device="cuda").bfloat16()
    gates = torch.rand(T, K, generator=g, device="cuda")
    return ((x, eidx, pos_c, keep, E, C), (ob, eidx, pos_c, keep, gates))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args()
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    mine = _moe._lib()
    floor = chip_smoke.launch_floor_ms()
    out = {"nvidia_smi": smi, "launch_floor_ms": floor, "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        other = build.load_other(args.other, Path(tmp) / "other.so", mine,
                                 FNS)
        libs = {"this": mine, "other": other}

        def use(lab):
            _moe._lib = lambda _l=libs[lab]: _l

        for label in CASES:
            dargs, cargs = inputs(label)
            res = {}
            for name, a in (("moe_dispatch", dargs), ("moe_combine", cargs)):
                fn = getattr(ops, name)
                outs = {}
                for lab in libs:
                    use(lab)
                    outs[lab] = fn(*a)
                torch.cuda.synchronize()
                if not torch.equal(chip_smoke.moe_bits(outs["this"]),
                                   chip_smoke.moe_bits(outs["other"])):
                    raise AssertionError(f"{name} {label}: the two builds "
                                         f"differ")
                times = {lab: [] for lab in libs}
                lib_times = []
                lib = chip_smoke.dispatch_library(a) \
                    if name == "moe_dispatch" else None
                for _ in range(ROUNDS):
                    for lab in ("this", "other", "other", "this"):
                        use(lab)
                        times[lab].append(chip_smoke.graph_ms(
                            lambda: fn(*a)))
                    if lib is not None:
                        lib_times.append(chip_smoke.graph_ms(lib))
                bms, by, nbytes, nops = chip_smoke.moe_bound(name, a)
                res[name] = {
                    "this_ms": float(np.median(times["this"])),
                    "other_ms": float(np.median(times["other"])),
                    "this_all": times["this"], "other_all": times["other"],
                    "library_ms": float(np.median(lib_times))
                    if lib_times else None,
                    "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                    "dropped": int((~a[3]).sum())}
                r = res[name]
                print(f"[moe_ab] {name} {label} T={a[3].shape[0]} "
                      f"dropped {r['dropped']}: this {r['this_ms']:.5f} ms, "
                      f"other {r['other_ms']:.5f} ms (equal bits), library "
                      + (f"{r['library_ms']:.5f} ms" if lib_times else
                         "none") + f", bound {bms:.5f} ms by {by}, launch "
                      f"floor {floor:.5f} ms | {smi}", flush=True)
            out["cases"][label] = res
        use("this")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "moe_ab.json").write_text(json.dumps(out,
                                                                 indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
