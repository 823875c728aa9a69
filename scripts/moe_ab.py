"""The MoE layer's routing slots and dispatch on the card: this tree's
kernel pair against the eager count it replaced and against the
library's path.

Three ways from the choices' experts to what the dispatch needs, each
captured in a CUDA graph (20 calls a replay, no host issue in the
reading) and timed in turns (A B C C B A in each of ROUNDS rounds):

- `pair`: this tree's `ops.moe_slots` and `ops.moe_dispatch` (two
  launches: the routing kernel, then the gather by its src);
- `count`: the eager one-hot cumulative count
  (`ref.moe_positions_ref`) alone, the slots as the earlier path found
  them before its dispatch;
- `library`: the count, its inverse scattered into src by torch ops,
  and `torch.index_select` of x padded with a zero row by that src.

Beside them, each piece alone, in turns: `moe_slots`, the eager count,
`moe_dispatch` and `index_select` by the same src, each with its bound
(`chip_smoke.moe_bound`) and the launch floor. The cases are the MoE
serve's shapes of `granite-moe-1b-a400m` (CASES), with the routing
made from a seed as the serve's is: top-8 of 32 experts by a skewed
random score, the first 456 tokens (the left pads of group 1's four
prompts) routed alike. Every buffer is held equal bit for bit across
the paths, and the slots integer for integer with their plain version.
Prints the card's name and power limit and writes every number to
chiprun_out/moe_ab.json. Run on the card:

    python3 scripts/moe_ab.py
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (moe_positions_ref,  # noqa: E402
                                     moe_slots_ref)

ROUNDS = 3
E, K, D = 32, 8, 1024
# label -> (T, C, pad tokens routed alike): group 1's prefill (4 x 641
# tokens, C = 804), group 2's (4 x 423, C = 532) and a decode step
CASES = {"prefill1": (2564, 804, 456), "prefill2": (1692, 532, 0),
         "decode": (4, 4, 0)}


def experts(T: int, pads: int, seed: int) -> torch.Tensor:
    """eidx [1, T, K] int64 on the card."""
    rng = np.random.default_rng(seed)
    score = rng.normal(size=(T, E)) + np.linspace(0.0, 1.0, E)
    score[:pads] = score[0]
    return torch.from_numpy(np.argsort(-score, axis=1)[None, :, :K].copy()
                            ).cuda()


def eager_src(eidx: torch.Tensor, pos_c, keep, C: int) -> torch.Tensor:
    """src [E, C] int32 of one group by torch ops that a graph can hold
    (no boolean indexing): each kept choice's token scattered to its
    slot, the dropped ones to a spare slot past the end."""
    _, T, k = eidx.shape
    slot = torch.where(keep[0], eidx[0] * C + pos_c[0], E * C).reshape(-1)
    tok = torch.arange(T, dtype=torch.int32, device=eidx.device)
    src = torch.full((E * C + 1,), -1, dtype=torch.int32,
                     device=eidx.device)
    src.scatter_(0, slot, tok[:, None].expand(T, k).reshape(-1))
    return src[:-1].view(E, C)


def padded(x: torch.Tensor) -> torch.Tensor:
    """x with one zero row after its last."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def in_turns(fns: dict, order) -> dict:
    """{name: median graph ms} over ROUNDS rounds of `order`, with every
    reading kept."""
    times = {n: [] for n in fns}
    for _ in range(ROUNDS):
        for n in order:
            times[n].append(chip_smoke.graph_ms(fns[n]))
    return {n: {"ms": float(np.median(v)), "all": v}
            for n, v in times.items()}


def main() -> int:
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    floor = chip_smoke.launch_floor_ms()
    out = {"nvidia_smi": smi, "launch_floor_ms": floor, "cases": {}}
    for label, (T, C, pads) in CASES.items():
        eidx = experts(T, pads, seed=T)
        g = torch.Generator(device="cuda").manual_seed(T)
        x = torch.randn(T, D, generator=g, device="cuda").bfloat16()
        pos_c, keep, src = ops.moe_slots(eidx, E, C)
        want = moe_slots_ref(eidx, E, C)
        for a, b in zip((pos_c, keep, src), want):
            if not torch.equal(a, b):
                raise AssertionError(f"moe_slots {label}: not its plain "
                                     f"version")
        src0, xpad = src[0], padded(x)
        idx = torch.where(src0 < 0, T, src0).reshape(-1).long()
        buf = ops.moe_dispatch(x, src0)
        lib_buf = torch.index_select(xpad, 0, idx).view(E, C, D)
        torch.cuda.synchronize()
        if not torch.equal(chip_smoke.moe_bits(lib_buf),
                           chip_smoke.moe_bits(buf)):
            raise AssertionError(f"{label}: index_select's buffer is not "
                                 f"the dispatch's")

        def pair():
            _, _, s = ops.moe_slots(eidx, E, C)
            return ops.moe_dispatch(x, s[0])

        def library():
            p, kp = moe_positions_ref(eidx, E, C)
            s = eager_src(eidx, p, kp, C)
            i = torch.where(s < 0, T, s).reshape(-1).long()
            return torch.index_select(xpad, 0, i)

        paths = in_turns({"pair": pair,
                          "count": lambda: moe_positions_ref(eidx, E, C),
                          "library": library},
                         ("pair", "count", "library", "library", "count",
                          "pair"))
        pieces = {"moe_slots": lambda: ops.moe_slots(eidx, E, C),
                  "positions": lambda: moe_positions_ref(eidx, E, C),
                  "moe_dispatch": lambda: ops.moe_dispatch(x, src0),
                  "index_select": lambda: torch.index_select(xpad, 0, idx)}
        alone = in_turns(pieces, list(pieces) + list(pieces)[::-1])
        bounds = {n: chip_smoke.moe_bound(n, a)[:3] for n, a in (
            ("moe_slots", (eidx, E, C)), ("moe_dispatch", (x, src0)))}
        res = {"T": T, "C": C, "dropped": int((~keep).sum()),
               "empty": int((src0 < 0).sum()), "paths": paths,
               "alone": alone, "bounds": bounds}
        out["cases"][label] = res
        print(f"[moe_ab] {label} T={T} C={C}, {res['dropped']} choices "
              f"dropped, {res['empty']} empty slots: paths " + ", ".join(
                  f"{n} {v['ms']:.5f} ms" for n, v in paths.items()) +
              " | alone " + ", ".join(
                  f"{n} {v['ms']:.5f}" for n, v in alone.items()) +
              " | bounds " + ", ".join(
                  f"{n} {b[0]:.5f} ms ({b[2]} B)"
                  for n, b in bounds.items()) +
              f" | launch floor {floor:.5f} ms | equal bits | {smi}",
              flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "moe_ab.json").write_text(json.dumps(out,
                                                                 indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
