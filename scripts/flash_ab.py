"""Interleaved A/B of two builds of the flash kernels on the card.

Builds this tree's `csrc/flash_attn.cu` (`kernels/build.py`) and a second
source of the same C interface (`--other`, e.g. a parent commit's
`flash_attn.cu` unpacked with `git archive`) with the same nvcc flags,
then times `ops.flash_fwd` and `ops.flash_bwd` through each library in
turn (A B B A in each of ROUNDS rounds, CUDA graphs: no host issue in
the reading) at the dense family's shapes: `llama3-8b`'s group-1
prefill [4,32,1,641,128] and `h2o-danube-1.8b`'s train step
[4,32,1,1024,80], bf16, causal. It also prints each kernel of this tree's backward (`torch.profiler`) and
the card's name and power limit. Run on the card, e.g. against a
parent unpacked under build/parent:

    python3 scripts/flash_ab.py \
        --other build/parent/src/repro_torch/csrc/flash_attn.cu
"""
import argparse
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash as _flash  # noqa: E402

ROUNDS = 3
SHAPES = {"group 1 prefill": (4, 32, 1, 641, 128),
          "danube train": (4, 32, 1, 1024, 80)}


def inputs(shape, seed: int = 0):
    B, K, G, S, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
            for s in ((B, K, G, S, D), (B, K, S, D), (B, K, S, D),
                      (B, K, G, S, D))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi())
    mine = _flash._lib()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"this": mine, "other": build.load_other(
            args.other, Path(tmp) / "other.so", mine,
            ("flash_fwd_launch", "flash_bwd_launch", "flash_error_string"))}
        for name, shape in SHAPES.items():
            q, k, v, g = inputs(shape)
            out, lse = ops.flash_fwd(q, k, v)
            ms = {lab: {"fwd": [], "bwd": []} for lab in libs}
            for _ in range(ROUNDS):
                for lab in ("this", "other", "other", "this"):
                    _flash._lib = lambda _l=libs[lab]: _l
                    ms[lab]["fwd"].append(chip_smoke.graph_ms(
                        lambda: ops.flash_fwd(q, k, v), launches=10))
                    ms[lab]["bwd"].append(chip_smoke.graph_ms(
                        lambda: ops.flash_bwd(g, q, k, v, out, lse),
                        launches=5))
            _flash._lib = lambda: mine
            for lab, m in ms.items():
                print(f"{name} {list(shape)} {lab}: fwd median "
                      f"{np.median(m['fwd']):.5f} ms {np.round(m['fwd'], 5)}"
                      f"; bwd median {np.median(m['bwd']):.5f} ms "
                      f"{np.round(m['bwd'], 5)}")
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    ops.flash_bwd(g, q, k, v, out, lse)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if "flash" in e.key:
                    kern = re.search(r"flash_\w+(<[^>]*>)?", e.key).group(0)
                    print(f"{name} this bwd kernel {kern}: "
                          f"{e.device_time_total / e.count / 1e3:.5f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
