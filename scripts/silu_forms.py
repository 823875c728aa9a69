"""The bf16 SiLU kernels' design choices, timed on the card.

`csrc/silu.cu`'s `silu` and `silu_bwd` at the SSM's shapes (`silu` at
group 1's prefill [4, 641, 5376], `silu_bwd` at the train step's
[4, 1024, 5376], bf16), each in the forms the design chose between:

- this: the tree's kernel;
- stores flipped: the output stored streaming where the tree stores it
  write-back, and the other way round (`Silu2` / `SiluBwd2`'s
  `kEvictFirst`);
- grid flipped: `silu` a chunk a warp, `silu_bwd` a persistent grid
  (`launch_stream`'s `kPersistent`);
- bulk: 1-D bulk copies into a shared-memory ring, one producer warp
  (`scripts/silu_bulk.cu`);
- ieee divide: the reciprocal as the IEEE divide (`__fdiv_rn`) in place
  of `rcp.approx`;
- ex2 exp: exp(-x) as `ex2.approx.ftz` of x * -log2(e) in place of
  `expf`;
- library: `F.silu` / `torch.ops.aten.silu_backward`, one PyTorch call.

Each form runs ROUNDS rounds of GRAPHS fresh CUDA graphs (a form can
read bimodally between graphs), the forms in turns. Each form's bits
are compared with this tree's on every bf16 x (`silu_bwd` at g, the
same values reversed) and at the timed inputs: the memory forms must
match; the arithmetic forms report how many outputs differ. Prints the
card's name and power limit and each form's median, least and greatest
ms, and writes them to chiprun_out/silu_forms.json. Run on the card:

    python3 scripts/silu_forms.py
"""
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

ROUNDS, GRAPHS = 3, 2
FNS = ("silu_launch", "silu_bwd_launch", "silu_gate_launch",
       "silu_gate_bwd_launch", "silu_error_string")
SRC = ROOT / "src" / "repro_torch" / "csrc" / "silu.cu"
# (text in the tree's source, its replacement) for each flipped form
STORES = [("  static constexpr int kIn = 1;\n  static constexpr bool "
           "kEvictFirst = false;", "  static constexpr int kIn = 1;\n  "
           "static constexpr bool kEvictFirst = true;"),
          ("  static constexpr int kIn = 2;\n  static constexpr bool "
           "kEvictFirst = true;", "  static constexpr int kIn = 2;\n  "
           "static constexpr bool kEvictFirst = false;")]
DIVIDE = [("""  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fmul_rn(u, 0.25f)));
  return __fmul_rn(r, 0.25f);""", "  return __fdiv_rn(1.0f, u);")]
EX2 = [("constexpr uint32_t kOne2", """
__device__ __forceinline__ float ex2_neg(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * -1.44269504f));
  return r;
}
constexpr uint32_t kOne2"""),
       ("pack_rn(expf(-lo_f32(x)), expf(-hi_f32(x)))",
        "pack_rn(ex2_neg(lo_f32(x)), ex2_neg(hi_f32(x)))")]
GRID = [(f"launch_stream<&silu_kernel<T, {w}, kSlots>, {w}, true>",
         f"launch_stream<&silu_kernel<T, {w}, kSlots>, {w}, false>")
        for w in (8, 4, 2)] + [
        (f"launch_stream<&silu_bwd_kernel<T, {w}, kSlots>, {w}, false>",
         f"launch_stream<&silu_bwd_kernel<T, {w}, kSlots>, {w}, true>")
        for w in (8, 4, 2)]
VARIANTS = {"stores flipped": STORES, "grid flipped": GRID,
            "ieee divide": DIVIDE, "ex2 exp": EX2}
# forms whose bits must equal this tree's
SAME_BITS = ("stores flipped", "grid flipped", "bulk")


def flipped(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"silu.cu no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def nvcc(src: Path, out: Path) -> subprocess.Popen:
    return subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                             str(out), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("silu_forms: needs a CUDA card", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    print(smi)
    mine = _silu._lib()
    text = SRC.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        procs = {}
        for name, edits in VARIANTS.items():
            src = tmp / f"{name.replace(' ', '_')}.cu"
            src.write_text(flipped(text, edits))
            procs[name] = nvcc(src, src.with_suffix(".so"))
        procs["bulk"] = nvcc(ROOT / "scripts" / "silu_bulk.cu",
                             tmp / "bulk.so")
        libs = {"this": mine}
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"{name}: nvcc failed\n{log}")
            libs[name] = ctypes.CDLL(str(tmp / f"{name.replace(' ', '_')}"
                                         f".so"))
        for name in VARIANTS:
            for fn in FNS:
                getattr(libs[name], fn).argtypes = getattr(mine, fn).argtypes
                getattr(libs[name], fn).restype = getattr(mine, fn).restype
        bulk = libs.pop("bulk")
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        bulk.silu_bulk_launch.argtypes = [i32, ptr, ptr, ptr, i64, ptr]
        bulk.silu_bulk_launch.restype = i32

        gen = torch.Generator(device="cuda").manual_seed(0)
        x1 = (torch.randn(4, 641, 5376, generator=gen, device="cuda") *
              4).to(torch.bfloat16)
        x2 = (torch.randn(4, 1024, 5376, generator=gen, device="cuda") *
              4).to(torch.bfloat16)
        g2 = torch.randn(4, 1024, 5376, generator=gen,
                         device="cuda").to(torch.bfloat16)
        calls = {"silu": (x1,), "silu_bwd": (g2, x2)}
        every = torch.arange(65536, dtype=torch.int32, device="cuda").to(
            torch.int16).view(torch.bfloat16)
        domain = {"silu": (every,), "silu_bwd": (every.flip(0), every)}

        def bulk_call(name, args):
            def call():
                out = torch.empty_like(args[-1])
                err = bulk.silu_bulk_launch(
                    int(name == "silu_bwd"), args[0].data_ptr(),
                    args[-1].data_ptr(), out.data_ptr(), out.numel(),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"silu_bulk_launch: {err}")
                return out
            return call

        def wrapper_call(lib, name, args):
            def call():
                _silu._lib = lambda: lib
                try:
                    return getattr(ops, name)(*args)
                finally:
                    _silu._lib = lambda: mine
            return call

        def form_calls(inputs):
            forms = {}
            for name, args in inputs.items():
                for form, lib in libs.items():
                    forms[(name, form)] = wrapper_call(lib, name, args)
                forms[(name, "bulk")] = bulk_call(name, args)
            return forms

        differ = {}
        for inputs in (domain, calls):
            checks = form_calls(inputs)
            for (name, form), fn in checks.items():
                want = checks[(name, "this")]().view(torch.int16)
                n = int((fn().view(torch.int16) != want).sum())
                differ[f"{name}, {form}"] = differ.get(
                    f"{name}, {form}", 0) + n
                if n and form in SAME_BITS:
                    raise AssertionError(f"{name}, {form}: {n} outputs "
                                         f"differ from this tree's")
        forms = form_calls(calls)
        for name, args in calls.items():
            forms[(name, "library")] = (
                lambda a=args: torch.nn.functional.silu(*a)) if \
                name == "silu" else (
                lambda a=args: torch.ops.aten.silu_backward(*a))
        ms = {key: [] for key in forms}
        order = list(forms)
        for r in range(ROUNDS):
            for key in (order if r % 2 == 0 else order[::-1]):
                for _ in range(GRAPHS):
                    ms[key].append(chip_smoke.graph_ms(forms[key]))
    res = {"smi": smi, "forms": {}, "outputs_differing": differ}
    for (name, form), t in ms.items():
        res["forms"][f"{name}, {form}"] = t
        n = differ.get(f"{name}, {form}")
        print(f"{name} {list(calls[name][-1].shape)} {form}: median "
              f"{np.median(t):.5f} ms, least {np.min(t):.5f}, greatest "
              f"{np.max(t):.5f} {np.round(t, 5).tolist()}" + (
                  "" if n is None else f"; {n} outputs differ from this "
                  f"tree's (every bf16 x and the timed inputs)"))
    out = ROOT / "chiprun_out" / "silu_forms.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
