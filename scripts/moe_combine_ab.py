"""Interleaved A/B of two builds of the MoE combine, the dispatch's
backward and the gates' backward on the card.

Builds this tree's `csrc/moe.cu` (`kernels/build.py`) and a second
source of its C interface (`--other`, e.g. a parent commit's `moe.cu`
unpacked with `git archive`) with the same nvcc flags, then times each
case through each library in turns (A B B A in each of ROUNDS rounds;
`chip_smoke.graph_ms`: a CUDA graph of 20 calls, the median of 11
replays, outputs allocated in each call as the wrappers do):

- `moe_dispatch_bwd` at a train step's layer 0 (T 4,096, C 1,284),
  where a parent before the redesign still has its block-a-token body;
- `moe_combine` at group 1's prefill (T 2,564, C 804), a decode step
  (T 4, C 4) and the train step's layer 0, and `moe_gates_bwd` there:
  the two kernels whose body this build shares with the dispatch's
  backward, or leaves as it was, so their readings show whether that
  moved them and the calls' spread.

The widths are granite-moe-1b-a400m's (E 32, k 8, d 1,024, bf16). The
routing is made from a seed as `scripts/moe_ab.py` makes it (the top 8
of a score tilted toward the high experts, the prefill's left pads
routed alike, which overloads their experts), the slots counted by
`moe_slots_ref`; ob, dy, the buffer's cotangent and the gates are
random from the seed. Every output is held equal bit for bit to its
plain version and across the two builds, and two calls equal. Prints
this build's ptxas report (registers, spills), the card's name and
power limit, each case's bound (`chip_smoke.moe_bound`) and writes every
number to chiprun_out/moe_combine_ab.json; fails if this build's
`moe_dispatch_bwd_kernel` spills. Run on the card, e.g.
against a parent unpacked under build/parent:

    python3 scripts/moe_combine_ab.py \\
        --other build/parent/src/repro_torch/csrc/moe.cu
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import moe  # noqa: E402
from repro_torch.kernels.ref import (moe_combine_ref,  # noqa: E402
                                     moe_dispatch_bwd_ref, moe_gates_bwd_ref,
                                     moe_slots_ref)

ROUNDS = 3
E, K, D = 32, 8, 1024
# label -> (kernel, T, C, pad tokens routed alike)
CASES = {"dispatch_bwd train": ("moe_dispatch_bwd", 4096, 1284, 0),
         "combine prefill1": ("moe_combine", 2564, 804, 456),
         "combine decode": ("moe_combine", 4, 4, 0),
         "combine train": ("moe_combine", 4096, 1284, 0),
         "gates_bwd train": ("moe_gates_bwd", 4096, 1284, 0)}
PLAIN = {"moe_combine": moe_combine_ref, "moe_gates_bwd": moe_gates_bwd_ref,
         "moe_dispatch_bwd": moe_dispatch_bwd_ref}
FNS = ("moe_combine_launch", "moe_gates_bwd_launch",
       "moe_dispatch_bwd_launch", "moe_error_string")


def inputs(name: str, T: int, C: int, pads: int, seed: int) -> tuple:
    """The kernel's arguments as its wrapper takes them, on the card."""
    rng = np.random.default_rng(seed)
    score = rng.normal(size=(T, E)) + np.linspace(0.0, 1.0, E)
    score[:pads] = score[0]
    eidx = torch.from_numpy(np.argsort(-score, axis=1)[None, :, :K].copy())
    pos_c, keep, _ = moe_slots_ref(eidx, E, C)
    rt = [a[0].cuda() for a in (eidx, pos_c, keep)]
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.randn(E, C, D, generator=g, device="cuda").bfloat16()
    rows[0, 0] = -0.0
    if name == "moe_dispatch_bwd":
        return (rows, *rt)
    if name == "moe_gates_bwd":
        dy = torch.randn(T, D, generator=g, device="cuda").bfloat16()
        return (dy, rows, *rt)
    gates = torch.rand(T, K, generator=g, device="cuda")
    return (rows, *rt, gates / gates.sum(-1, keepdim=True))


def caller(lib, name: str):
    """`name` through `lib`, as `kernels/moe.py` launches it."""
    def call(*args):
        stream = torch.cuda.current_stream().cuda_stream
        if name == "moe_gates_bwd":
            dy, ob, eidx, pos_c, keep = args
            T, k = eidx.shape
            out = torch.empty((T, k), dtype=torch.float32, device="cuda")
            err = lib.moe_gates_bwd_launch(
                dy.data_ptr(), ob.data_ptr(), eidx.data_ptr(),
                pos_c.data_ptr(), keep.data_ptr(), out.data_ptr(), T, k,
                ob.shape[2], ob.shape[1], moe.DTYPES[ob.dtype], stream)
        else:
            rows, eidx, pos_c, keep = args[:4]
            T, k = eidx.shape
            _, C, d = rows.shape
            out = torch.empty((T, d), dtype=rows.dtype, device="cuda")
            ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]
            fn = lib.moe_combine_launch if name == "moe_combine" else \
                lib.moe_dispatch_bwd_launch
            err = fn(*ptrs, T, k, d, C, moe.DTYPES[rows.dtype], stream)
        if err:
            raise RuntimeError(f"{name}: {lib.moe_error_string(err)}")
        return out
    return call


def ptxas_report(text: str) -> list:
    """ptxas's lines for each kernel: its name, registers and spills."""
    return [ln.strip() for ln in text.splitlines()
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln]


def main() -> int:
    """Build both libraries, check and time both sides at CASES."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_combine_ab: needs a CUDA card", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    text = build.compile_sources(["moe"])["moe"]
    report = ptxas_report(text)
    print("\n".join(report), flush=True)
    dbwd = chip_smoke.ptxas_report(text, ("moe_dispatch_bwd_kernel",))
    print(f"[moe_combine_ab] this build's moe_dispatch_bwd_kernel: {dbwd}",
          flush=True)
    rep = dbwd.get("moe_dispatch_bwd_kernel", {})
    if not rep or rep.get("spill_stores") or rep.get("spill_loads"):
        raise AssertionError(f"moe_dispatch_bwd_kernel: not in ptxas's "
                             f"report, or spilling: {dbwd}")
    mine = moe._lib()
    res = {"smi": smi, "rounds": ROUNDS, "ptxas": report,
           "dispatch_bwd_ptxas": dbwd, "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        other = build.load_other(args.other, Path(tmp) / "other.so", mine,
                                 FNS)
        for label, (name, T, C, pads) in CASES.items():
            a = inputs(name, T, C, pads, seed=T + C)
            sides = {"this": caller(mine, name),
                     "parent": caller(other, name)}
            want = PLAIN[name](*a)
            outs = {lab: (call(*a), call(*a)) for lab, call in sides.items()}
            torch.cuda.synchronize()
            for lab, (got, again) in outs.items():
                bits = chip_smoke.moe_bits
                if not (torch.equal(bits(got), bits(want)) and
                        torch.equal(bits(got), bits(again))):
                    raise AssertionError(f"{label} {lab}: not its plain "
                                         f"version's bits, or two calls "
                                         f"differ")
            bound_ms, by, nbytes, nops = chip_smoke.moe_bound(name, a)
            ms = {lab: [] for lab in sides}
            for _ in range(ROUNDS):
                for lab in ("this", "parent", "parent", "this"):
                    call = sides[lab]
                    ms[lab].append(chip_smoke.graph_ms(lambda: call(*a)))
            rounds = {lab: np.reshape(v, (ROUNDS, 2)).mean(1)
                      for lab, v in ms.items()}
            keep = a[-1] if name == "moe_gates_bwd" else a[3]
            case = {"kernel": name, "T": T, "C": C,
                    "dropped": int((~keep).sum()), "bound_ms": bound_ms,
                    "bound_by": by, "bytes": nbytes, "ops": nops,
                    "ms": ms, "median_ms": {lab: float(np.median(v))
                                            for lab, v in ms.items()},
                    "this_faster_every_round": bool(
                        all(rounds["this"] < rounds["parent"])),
                    "equal_bits": True}
            res["cases"][label] = case
            print(f"[moe_combine_ab] {label} ({name}, T={T}, C={C}, "
                  f"{case['dropped']} of {T * K} choices dropped): this "
                  f"{case['median_ms']['this']:.5f} ms "
                  f"{np.round(ms['this'], 5).tolist()} | parent "
                  f"{case['median_ms']['parent']:.5f} ms "
                  f"{np.round(ms['parent'], 5).tolist()} | bound "
                  f"{bound_ms:.5f} ms by {by} ({nbytes} B) | this faster "
                  f"in every round: {case['this_faster_every_round']} | "
                  f"equal bits to plain and across builds | {smi}",
                  flush=True)
            del a, want, outs
    out = ROOT / "chiprun_out" / "moe_combine_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
