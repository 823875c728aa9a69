"""Builds the port's CUDA kernels from `repro_torch/csrc/` at first use.

Each `csrc/<name>.cu` has a plain C interface. It compiles with `nvcc`
for `sm_90a` into a shared library under `build/torch_ext/` at the
root of the checkout (a git-ignored directory), named by a hash of the
source and the flags, and is loaded with `ctypes`. Nothing here runs
at import: the CPU tests import every module on machines without
`nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else under $CUDA_HOME."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    """Where the built library of `csrc/<name>.cu` lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def _log_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".nvcc.txt")


def compile_sources(names: Sequence[str]) -> Dict[str, str]:
    """Compile each `csrc/<name>.cu` that is not built yet, one `nvcc`
    per source, all started together. Returns nvcc's output per name
    (ptxas's register / shared-memory report; for a library built
    before, the output kept beside it); raises with it if an nvcc
    failed."""
    procs = {}
    texts = {name: "" for name in names}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = _log_path(out)
            texts[name] = log.read_text() if log.exists() else ""
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        texts[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{texts[name]}")
        else:
            _log_path(out).write_text(texts[name])
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return texts


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        compile_sources([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def load_other(src: Path, out: Path, like: ctypes.CDLL,
               fns: Sequence[str]) -> ctypes.CDLL:
    """Another source of a library's C interface (e.g. a parent commit's
    `csrc/<name>.cu`), built with the same flags into `out` and loaded,
    its functions `fns` typed as `like`'s: for comparing two builds on
    the card."""
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for fn in fns:
        getattr(lib, fn).argtypes = getattr(like, fn).argtypes
        getattr(lib, fn).restype = getattr(like, fn).restype
    return lib
