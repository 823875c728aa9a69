"""Interleaved A/B of two or more builds of the flash kernels on the card.

Builds this tree's `csrc/flash_attn.cu` (`kernels/build.py`) and other
sources (`--other`, repeatable: e.g. a parent commit's `flash_attn.cu`
unpacked with `git archive`, or a file under build/ that `#define`s a
setting and `#include`s this tree's) with the same nvcc flags, then times
each other build against this tree's in turn (A B B A in each of ROUNDS
rounds, CUDA graphs: no host issue in the reading) at the dense family's
shapes, `llama3-8b`'s group-1 prefill [4,32,1,641,128] and
`h2o-danube-1.8b`'s train step [4,32,1,1024,80] (bf16, causal; forward
and backward), and at MLA's, `minicpm3-4b`'s group-1 prefill (40 heads,
S 641: q_nope 64 + q_rope 32 bf16, k_nope f32, the one rope key, v 64;
forward). A build of the interface before MLA's parts (its
`flash_fwd_launch` takes k_hi / k_lo scratch, no `flash_fwd_mla_launch`)
runs MLA's shape on the reference's concatenations, q = [q_nope, q_rope]
and k = [k_nope, k_rope expanded] in f32 (made outside the timing),
split by its own kernel into that scratch. Prints for every shape each
build's times, whether its out and lse equal this tree's bit for bit (or
the share of elements apart), each kernel of this tree's call by the
profiler, and the card's name and power limit. Run on the card, e.g.
against a parent unpacked under build/parent:

    python3 scripts/flash_ab.py \
        --other build/parent/src/repro_torch/csrc/flash_attn.cu
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
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash as _flash  # noqa: E402

ROUNDS = 3
# dense: (B, K, G, S, D); MLA: (B, H, S, nd, rd, Dv)
SHAPES = {"group 1 prefill": (4, 32, 1, 641, 128),
          "danube train": (4, 32, 1, 1024, 80)}
MLA_SHAPES = {"mla group 1 prefill": (4, 40, 641, 64, 32, 64)}
OUT = ROOT / "chiprun_out" / "flash_ab.json"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the forward's C interface before MLA's parts
OLD_FWD_ARGTYPES = [_P] * 7 + [_I] * 7 + [_F, _I, _P, _P]


def inputs(shape, seed: int = 0):
    B, K, G, S, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
            for s in ((B, K, G, S, D), (B, K, S, D), (B, K, S, D),
                      (B, K, G, S, D))]


def mla_inputs(shape, seed: int = 0):
    """MLA's parts as `mla_forward` passes them: q_nope a strided view of
    a [B,S,H,nd + rd] projection, k_nope an f32 strided view of a
    [B,S,H,nd] product, the one rope key [B,1,S,rd]."""
    B, H, S, nd, rd, Dv = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*s):
        return torch.randn(*s, generator=g, device="cuda")
    q = draw(B, S, H, nd + rd).to(torch.bfloat16).transpose(1, 2)
    return (q[..., :nd], q[..., nd:].contiguous(),
            draw(B, S, H, nd).transpose(1, 2),
            draw(B, 1, S, rd).to(torch.bfloat16),
            draw(B, H, S, Dv).to(torch.bfloat16))


def old_fwd(lib, q, k, v):
    """The forward through the interface before MLA's parts: f32 keys
    beside a bf16 q are split into bf16 scratch by its own kernel."""
    B, K, G, S, Dq = q.shape
    Dv = v.shape[3]
    views = [_flash.operand_strides(t) for t in (q, k, v)]
    strides = _flash._strides(*views)
    out = torch.empty((B, K, G, S, Dv), dtype=v.dtype, device=q.device)
    lse = torch.empty((B, K, G, S), dtype=torch.float32, device=q.device)
    hi = lo = None
    if k.dtype != q.dtype:
        parts = torch.empty((2,) + tuple(k.shape), dtype=torch.bfloat16,
                            device=k.device)
        hi, lo = parts[0].data_ptr(), parts[1].data_ptr()
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), hi, lo, B, K, G, S, Dq, Dv, 0, Dq ** -0.5,
        _flash.DTYPES[q.dtype], ctypes.addressof(strides),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the other build's flash_fwd_launch: {err}")
    return out, lse


def load(src: Path, out: Path, mine: ctypes.CDLL):
    """(library, is it this tree's interface) for another source."""
    lib = build.load_other(src, out, mine,
                           ("flash_bwd_launch", "flash_error_string"))
    new = hasattr(lib, "flash_fwd_mla_launch")
    for fn in ("flash_fwd_launch",) + (("flash_fwd_mla_launch",)
                                       if new else ()):
        getattr(lib, fn).argtypes = (getattr(mine, fn).argtypes if new
                                     else OLD_FWD_ARGTYPES)
        getattr(lib, fn).restype = _I
    return lib, new


def using(lib):
    """Route the wrappers through `lib` (this tree's interface)."""
    _flash._lib = lambda _l=lib: _l


def apart(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of elements whose bits differ."""
    return float((a.view(-1) != b.view(-1)).float().mean())


def profile_kernels(fn, calls: int = 5) -> dict:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {re.search(r"flash_\w+(<[^>]*>)?", e.key).group(0):
            e.device_time_total / e.count / 1e3
            for e in prof.key_averages() if "flash" in e.key}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, action="append", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    print(smi)
    mine = _flash._lib()
    report = {"card": smi, "rounds": ROUNDS, "shapes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        others = {}
        for i, src in enumerate(args.other):
            others[str(src)] = load(src, Path(tmp) / f"other{i}.so", mine)
        for name, shape in {**SHAPES, **MLA_SHAPES}.items():
            mla = name in MLA_SHAPES
            if mla:
                parts = mla_inputs(shape)
                q, k = chip_smoke.mla_concatenated(parts)
                v = parts[4]

                def this_fwd():
                    return ops.flash_fwd_mla(*parts)
            else:
                q, k, v, g = inputs(shape)

                def this_fwd():
                    return ops.flash_fwd(q, k, v)
            using(mine)
            want = this_fwd()
            res = {"this": {"kernels": profile_kernels(this_fwd)}}
            for lab, (lib, new) in others.items():
                if new:
                    def other_fwd(_l=lib):
                        using(_l)
                        return this_fwd()
                else:
                    def other_fwd(_l=lib):
                        return old_fwd(_l, q, k, v)
                got = other_fwd()
                using(mine)
                ms = {"this": {"fwd": [], "bwd": []},
                      lab: {"fwd": [], "bwd": []}}
                for _ in range(ROUNDS):
                    for side in ("this", lab, lab, "this"):
                        fwd = this_fwd if side == "this" else other_fwd
                        using(mine if side == "this" else lib)
                        ms[side]["fwd"].append(chip_smoke.graph_ms(
                            fwd, launches=10))
                        if not mla:
                            out, lse = want
                            ms[side]["bwd"].append(chip_smoke.graph_ms(
                                lambda: ops.flash_bwd(g, q, k, v, out, lse),
                                launches=5))
                using(mine)
                entry = {"ms": ms, "out_apart": apart(got[0], want[0]),
                         "lse_apart": apart(got[1], want[1])}
                res[lab] = entry
                for side, m in ms.items():
                    print(f"{name} {list(shape)} {side}: fwd median "
                          f"{np.median(m['fwd']):.5f} ms "
                          f"{np.round(m['fwd'], 5)}" + (
                              f"; bwd median {np.median(m['bwd']):.5f} ms "
                              f"{np.round(m['bwd'], 5)}" if m["bwd"] else ""))
                print(f"{name}: {lab} against this tree: out "
                      f"{entry['out_apart']:.6%} of elements apart, lse "
                      f"{entry['lse_apart']:.6%}" +
                      (" (equal bits)" if entry["out_apart"] == 0 ==
                       entry["lse_apart"] else ""))
            for kern, t in res["this"]["kernels"].items():
                print(f"{name} this fwd kernel {kern}: {t:.5f} ms")
            if not mla:
                out, lse = want
                for kern, t in profile_kernels(
                        lambda: ops.flash_bwd(g, q, k, v, out, lse)).items():
                    print(f"{name} this bwd kernel {kern}: {t:.5f} ms")
            report["shapes"][name] = {"shape": list(shape), **res}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1, default=float))
    print(f"flash_ab: {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
