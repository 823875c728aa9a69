"""Interleaved A/B of two builds of the SiLU kernels on the card.

Builds this tree's `csrc/silu.cu` (`kernels/build.py`) and a second
source of the same C interface (`--other`, e.g. a parent commit's
`silu.cu` unpacked with `git archive`) with the same nvcc flags, then
times the five wrappers through each library in turn (A B B A in each
of ROUNDS rounds, CUDA graphs: no host issue in the reading), each at
its main path's shape in bf16 (CASES). A source without
`silu_bwd_launch` (before SiLU's gradient had a kernel of its own)
runs `silu_bwd` as its gate backward with no y, no f32 cotangent and no
dy. Beside them, once a round: the library calls for `silu` and
`silu_bwd` (`F.silu`, `torch.ops.aten.silu_backward`) and the two
floors of those kernels (`scripts/silu_floors.cu`: the same walk with no
arithmetic; the same arithmetic with no load). Every output of the two
builds is held equal bit for bit. Prints the card's name and power
limit and writes every number to chiprun_out/silu_ab.json. Run on the
card, e.g. against a parent unpacked under build/parent:

    python3 scripts/silu_ab.py \\
        --other build/parent/src/repro_torch/csrc/silu.cu
"""
import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import silu as _silu  # noqa: E402

ROUNDS = 3
FNS = ("silu_launch", "silu_gate_launch", "silu_gate_bwd_launch",
       "silu_error_string")
# wrapper, its call's shape, and the width of the tensor z is a slice of
# (0: dense): the SSM's prefill silu (group 1, [4, 641, 5376]) and its
# train step's silu_bwd ([4, 1024, 5376]); the SSM gate (z out of the
# in-projection's 10,576 columns) forward at group 1 and backward at the
# train step; the dense MLP's gate (llama3-8b's 14,336 at group 1) and
# its backward (h2o-danube-1.8b's 6,912 at the train step)
CASES = (("silu", (4, 641, 5376), 0), ("silu_bwd", (4, 1024, 5376), 0),
         ("silu_gate", (4, 641, 5120), 10576),
         ("silu_gate_value", (4, 641, 14336), 0),
         ("silu_gate_bwd", (4, 1024, 6912), 0),
         ("silu_gate_prod_bwd", (4, 1024, 5120), 10576))
LIBRARY = {"silu": torch.nn.functional.silu,
           "silu_bwd": torch.ops.aten.silu_backward}


def randn(shape, seed, scale=4.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(*shape, generator=g, device="cuda") * scale).to(
        torch.bfloat16)


def args_of(name, shape, wide):
    """The wrapper's inputs and keywords, seeded."""
    z = randn(shape, 1)
    if wide:
        full = torch.zeros((*shape[:-1], wide), dtype=z.dtype, device="cuda")
        full[..., :shape[-1]] = z
        z = full[..., :shape[-1]]
    y, g = randn(shape, 2, 1.0), randn(shape, 3, 1.0)
    if name == "silu":
        return (z,), {}
    if name == "silu_bwd":
        return (g, z), {}
    if name == "silu_gate":
        return (y, z), {}
    if name == "silu_gate_value":
        return (y, z), {"with_prod": False}
    if name == "silu_gate_bwd":
        return (g, y, z), {}
    return (g, randn(shape, 4, 1.0).float(), y, z), {}


def wrapper(name):
    return getattr(ops, "silu_gate" if name == "silu_gate_value" else name)


def outputs(out):
    return [t for t in (out if isinstance(out, tuple) else (out,))
            if t is not None]


def gate_bwd_as_silu_bwd(lib):
    """`launch_bwd` through a library whose SiLU gradient is its gate
    backward's: no y, no f32 cotangent, no dy."""
    def launch_bwd(g, x, dx, views=None):
        (rows, d, ldg, incg), (_, _, ldx, incx) = views or (
            _silu.row_view(g), _silu.row_view(x))
        _silu._check(_silu._on_device(
            x.device, lib.silu_gate_bwd_launch, g.data_ptr(), ldg, incg,
            None, None, 0, 0, x.data_ptr(), ldx, incx, None, dx.data_ptr(),
            rows, d, _silu.DTYPES[x.dtype]), "silu_bwd")
    return launch_bwd


def floors_lib(out: Path) -> ctypes.CDLL:
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                    str(ROOT / "scripts" / "silu_floors.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.silu_copy_floor_launch.argtypes = [i32, ptr, ptr, ptr, i64, ptr]
    lib.silu_issue_floor_launch.argtypes = [i32, i64, ptr, ptr]
    for fn in (lib.silu_copy_floor_launch, lib.silu_issue_floor_launch):
        fn.restype = i32
    return lib


def floor_ms(lib, inputs) -> dict:
    """Device ms of the memory floor and the issue floor of silu (one
    input) or silu_bwd (two), over the same n elements."""
    x = inputs[-1]
    n, n_in = x.numel(), len(inputs)
    out = torch.empty_like(x)
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    a, b = inputs[0].data_ptr(), x.data_ptr()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def copy():
        assert lib.silu_copy_floor_launch(n_in, a, b, out.data_ptr(), n,
                                          stream()) == 0

    def issue():
        assert lib.silu_issue_floor_launch(n_in - 1, n, sink.data_ptr(),
                                           stream()) == 0
    return {"copy_ms": chip_smoke.graph_ms(copy),
            "issue_ms": chip_smoke.graph_ms(issue)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("silu_ab: needs a CUDA card", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    print(smi)
    mine, launch_bwd = _silu._lib(), _silu.launch_bwd
    with tempfile.TemporaryDirectory() as tmp:
        other = build.load_other(args.other, Path(tmp) / "other.so", mine,
                                 FNS)
        floors = floors_lib(Path(tmp) / "floors.so")
        libs = {"this": (mine, launch_bwd),
                "other": (other, launch_bwd if hasattr(
                    other, "silu_bwd_launch") else gate_bwd_as_silu_bwd(
                        other))}
        if hasattr(other, "silu_bwd_launch"):
            other.silu_bwd_launch.argtypes = mine.silu_bwd_launch.argtypes
            other.silu_bwd_launch.restype = mine.silu_bwd_launch.restype

        def use(lab):
            lib, bwd = libs[lab]
            _silu._lib = lambda _l=lib: _l
            _silu.launch_bwd = bwd

        calls = {name: args_of(name, shape, wide)
                 for name, shape, wide in CASES}
        res = {"smi": smi, "cases": {}}
        for name, shape, wide in CASES:
            a, kw = calls[name]
            outs = {}
            for lab in libs:
                use(lab)
                outs[lab] = outputs(wrapper(name)(*a, **kw))
            torch.cuda.synchronize()
            equal = all(torch.equal(p.view(torch.int16) if p.dtype ==
                                    torch.bfloat16 else p,
                                    q.view(torch.int16) if q.dtype ==
                                    torch.bfloat16 else q)
                        for p, q in zip(outs["this"], outs["other"]))
            if not equal:
                raise AssertionError(f"{name}: the two builds' outputs "
                                     f"differ")
            res["cases"][name] = {"shape": list(shape), "z_width": wide,
                                  "bits_equal": equal,
                                  "this": [], "other": []}
        extra = {name: {"library": [], "copy": [], "issue": []}
                 for name in LIBRARY}
        for _ in range(ROUNDS):
            for lab in ("this", "other", "other", "this"):
                use(lab)
                for name, _, _ in CASES:
                    a, kw = calls[name]
                    fn = wrapper(name)
                    res["cases"][name][lab].append(chip_smoke.graph_ms(
                        lambda: fn(*a, **kw)))
            use("this")
            for name, lib_fn in LIBRARY.items():
                a, _ = calls[name]
                extra[name]["library"].append(chip_smoke.graph_ms(
                    lambda: lib_fn(*a)))
                f = floor_ms(floors, a)
                extra[name]["copy"].append(f["copy_ms"])
                extra[name]["issue"].append(f["issue_ms"])
        use("this")
        for name, _, _ in CASES:
            c = res["cases"][name]
            faster = [t < o for t, o in zip(
                np.reshape(c["this"], (ROUNDS, 2)).mean(1),
                np.reshape(c["other"], (ROUNDS, 2)).mean(1))]
            c["this_faster_every_round"] = all(faster)
            line = (f"{name} {c['shape']} z_width {c['z_width']}: this "
                    f"median {np.median(c['this']):.5f} ms "
                    f"{np.round(c['this'], 5).tolist()}; other median "
                    f"{np.median(c['other']):.5f} ms "
                    f"{np.round(c['other'], 5).tolist()}; bits equal; this "
                    f"faster in every round: {all(faster)}")
            if name in extra:
                c.update({k + "_ms": v for k, v in extra[name].items()})
                line += "".join(
                    f"; {k} median {np.median(v):.5f} ms "
                    f"{np.round(v, 5).tolist()}"
                    for k, v in extra[name].items())
            print(line)
    out = ROOT / "chiprun_out" / "silu_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
