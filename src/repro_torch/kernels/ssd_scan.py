"""Mamba-2 SSD within-chunk scan: the hand-written CUDA kernel.

Port of `repro/kernels/ssd_scan.py::ssd_chunk_pallas`. The kernel
source is `repro_torch/csrc/ssd_chunk.cu`; its head comment says what
bounds it on an H100 and how the design answers that. The TPU cell's
[8, Q, Q] decay mask and scores do not fit a Hopper block's shared
memory, so the kernels tile Q into 64-row tiles. bf16 inputs (the serve
path) take `ssd_chunk_bf16_kernel`: both contractions on the tensor
cores (wgmma), C B^T once per head group, the f32 operands split into
bf16 hi and lo. f32 inputs take the CUDA-core kernels `ssd_diag_kernel`
and `ssd_state_kernel`. The inter-chunk recurrence stays outside, in
`repro_torch/models/ssm.py::ssd_chunked`, as the reference keeps it.

This module binds the library (built at first use by
:mod:`repro_torch.kernels.build`) and launches it. Call it through
:func:`repro_torch.kernels.ops.ssd_chunk`, which checks the inputs,
takes the plain version for CPU tensors and counts launches, and its
backward through :func:`repro_torch.kernels.ops.ssd_chunk_bwd`, the
decay mask and C B^T recomputed, every sum in a fixed order: bf16
inputs (the train path) take three kernels: items of a k-tile and a
group of `BWD_HEADS` heads on wgmma, which keep the heads' sums on chip;
the sums over head groups with dda's scan; dB / dC on wgmma. f32 inputs
take four CUDA-core kernels. `bwd_scratch` gives the f32 scratch each takes.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

# the kernel's limits (csrc/ssd_chunk.cu kMaxP, kMaxN, kMaxQ)
MAX_P, MAX_N, MAX_Q = 64, 128, 4096
MAX_HEADS = 65535
# heads of a bf16 backward item (csrc/ssd_chunk.cu kHeadsB)
BWD_HEADS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_chunk")
    if not getattr(lib, "_typed", False):
        lib.ssd_chunk_launch.argtypes = [_P] * 6 + [_I] * 6 + [_P]
        lib.ssd_chunk_launch.restype = _I
        lib.ssd_chunk_bwd_launch.argtypes = [_P] * 15 + [_I] * 6 + [_P]
        lib.ssd_chunk_bwd_launch.restype = _I
        lib.ssd_chunk_error_string.argtypes = [_I]
        lib.ssd_chunk_error_string.restype = ctypes.c_char_p
        lib.ssd_chunk_smem_bytes.argtypes = [_I] * 4
        lib.ssd_chunk_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_chunk_bwd_scratch_floats.argtypes = [
            _I, ctypes.c_longlong] + [_I] * 4
        lib.ssd_chunk_bwd_scratch_floats.restype = ctypes.c_longlong
        for fn in ("ssd_chunk_max_p", "ssd_chunk_max_n", "ssd_chunk_max_q",
                   "ssd_chunk_bwd_heads"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = _I
        limits = (lib.ssd_chunk_max_p(), lib.ssd_chunk_max_n(),
                  lib.ssd_chunk_max_q(), lib.ssd_chunk_bwd_heads())
        if limits != (MAX_P, MAX_N, MAX_Q, BWD_HEADS):
            raise RuntimeError(f"ssd_chunk library limits {limits} differ "
                               f"from {(MAX_P, MAX_N, MAX_Q, BWD_HEADS)}")
        lib._typed = True
    return lib


# the library's kernels, by the index `ssd_chunk_smem_bytes` takes:
# the forward's three, the f32 backward's four, the bf16 backward's three
KERNELS = ("ssd_diag_kernel", "ssd_state_kernel", "ssd_chunk_bf16_kernel",
           "ssd_bwd_cb_kernel", "ssd_bwd_head_kernel", "ssd_bwd_sum_kernel",
           "ssd_bwd_bc_kernel", "ssd_bwd_wgmma_kernel", "ssd_bwd_gsum_kernel",
           "ssd_bwd_dbc_kernel")
BWD_KERNELS = KERNELS[3:]
# the bf16 backward's kernels that run wgmma (HGMMA in their SASS)
BWD_TC_KERNELS = ("ssd_bwd_wgmma_kernel", "ssd_bwd_dbc_kernel")


def smem_bytes(Q: int, P: int, N: int) -> dict:
    """Dynamic shared memory (bytes) one block of each kernel takes at
    (Q, P, N), as the launcher requests it."""
    lib = _lib()
    return {name: lib.ssd_chunk_smem_bytes(Q, P, N, i)
            for i, name in enumerate(KERNELS)}


def launch(xq: torch.Tensor, Bq: torch.Tensor, Cq: torch.Tensor,
           da: torch.Tensor, y: torch.Tensor, st: torch.Tensor) -> None:
    """Launch the call's kernels (bf16: the wgmma kernel; f32: y, then
    the states) on the current stream of xq's device; inputs are checked
    by the caller. Raises if a launch was refused."""
    lib = _lib()
    B, nC, Q, H, P = xq.shape
    N = Bq.shape[-1]
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.ssd_chunk_launch(
            xq.data_ptr(), Bq.data_ptr(), Cq.data_ptr(), da.data_ptr(),
            y.data_ptr(), st.data_ptr(), int(xq.dtype == torch.bfloat16),
            B * nC, Q, H, P, N, stream)
    if err != 0:
        msg = lib.ssd_chunk_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk launch failed: {msg} ({err})")


def bwd_scratch(B: int, nC: int, Q: int, H: int, N: int,
                bf16: bool) -> Dict[str, Tuple[int, ...]]:
    """The f32 scratch buffers the backward's kernels take, by name, in
    the order `ssd_chunk_bwd_launch` takes them (its
    `ssd_chunk_bwd_scratch_floats` gives the same sizes). bf16 inputs:
    the items' dG tiles (a 64x64 tile per causal (q-tile, k-tile) pair,
    summed over each group of BWD_HEADS heads) and their r o (x dst)
    tiles (64x128 per k-tile), E's row sums per k-tile, its column sums
    and rho. f32 inputs: C B^T, every head's dS o L and r o (x dst)."""
    BC = B * nC
    if not bf16:
        return {"cb": (BC, Q, Q), "dGh": (BC, H, Q, Q),
                "dB2h": (BC, H, Q, N)}
    nT, nG = -(-Q // 64), -(-H // BWD_HEADS)
    return {"dG": (BC, nG, nT * (nT + 1) // 2, 64 * 64),
            "xdst": (BC, nG, nT, 64 * 128), "rowE": (BC, H, nT, Q),
            "colE": (BC, H, Q), "rho": (BC, H, Q)}


def launch_bwd(xq: torch.Tensor, Bq: torch.Tensor, Cq: torch.Tensor,
               da: torch.Tensor, dy: torch.Tensor, dst: torch.Tensor,
               dx: torch.Tensor, dB: torch.Tensor, dC: torch.Tensor,
               dda: torch.Tensor) -> None:
    """Launch the backward's kernels (bf16: the items, the sums over head
    groups with dda, dB / dC; f32: C B^T, per head, the sum over heads,
    dB / dC) on the current stream of xq's device, with the f32 scratch
    of :func:`bwd_scratch` allocated here; inputs are checked by the
    caller. Raises if a launch was refused."""
    lib = _lib()
    B, nC, Q, H, P = xq.shape
    N = Bq.shape[-1]
    bf16 = xq.dtype == torch.bfloat16
    scratch = [torch.empty(shape, dtype=torch.float32, device=xq.device)
               for shape in bwd_scratch(B, nC, Q, H, N, bf16).values()]
    scratch += [scratch[0]] * (5 - len(scratch))
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.ssd_chunk_bwd_launch(
            xq.data_ptr(), Bq.data_ptr(), Cq.data_ptr(), da.data_ptr(),
            dy.data_ptr(), dst.data_ptr(), dx.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), dda.data_ptr(), *(t.data_ptr() for t in scratch),
            int(bf16), B * nC, Q, H, P, N, stream)
    if err != 0:
        msg = lib.ssd_chunk_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk_bwd launch failed: {msg} ({err})")
