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
backward through :func:`repro_torch.kernels.ops.ssd_chunk_bwd`: four
CUDA-core kernels (f32 arithmetic, either input dtype), the decay mask
and C B^T recomputed, the sums over heads in a fixed order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# the kernel's limits (csrc/ssd_chunk.cu kMaxP, kMaxN, kMaxQ)
MAX_P, MAX_N, MAX_Q = 64, 128, 4096
MAX_HEADS = 65535

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_chunk")
    if not getattr(lib, "_typed", False):
        lib.ssd_chunk_launch.argtypes = [_P] * 6 + [_I] * 6 + [_P]
        lib.ssd_chunk_launch.restype = _I
        lib.ssd_chunk_bwd_launch.argtypes = [_P] * 13 + [_I] * 6 + [_P]
        lib.ssd_chunk_bwd_launch.restype = _I
        lib.ssd_chunk_error_string.argtypes = [_I]
        lib.ssd_chunk_error_string.restype = ctypes.c_char_p
        lib.ssd_chunk_smem_bytes.argtypes = [_I] * 4
        lib.ssd_chunk_smem_bytes.restype = ctypes.c_longlong
        for fn in ("ssd_chunk_max_p", "ssd_chunk_max_n", "ssd_chunk_max_q"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = _I
        limits = (lib.ssd_chunk_max_p(), lib.ssd_chunk_max_n(),
                  lib.ssd_chunk_max_q())
        if limits != (MAX_P, MAX_N, MAX_Q):
            raise RuntimeError(f"ssd_chunk library limits {limits} differ "
                               f"from {(MAX_P, MAX_N, MAX_Q)}")
        lib._typed = True
    return lib


# the library's kernels, by the index `ssd_chunk_smem_bytes` takes:
# the forward's three, then the backward's four
KERNELS = ("ssd_diag_kernel", "ssd_state_kernel", "ssd_chunk_bf16_kernel",
           "ssd_bwd_cb_kernel", "ssd_bwd_head_kernel", "ssd_bwd_sum_kernel",
           "ssd_bwd_bc_kernel")
BWD_KERNELS = KERNELS[3:]


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


def launch_bwd(xq: torch.Tensor, Bq: torch.Tensor, Cq: torch.Tensor,
               da: torch.Tensor, dy: torch.Tensor, dst: torch.Tensor,
               dx: torch.Tensor, dB: torch.Tensor, dC: torch.Tensor,
               dda: torch.Tensor) -> None:
    """Launch the backward's four kernels (C B^T, per head, the sum over
    heads, dB / dC) on the current stream of xq's device, with their f32
    scratch (C B^T [BC,Q,Q], the heads' dS o L [BC,H,Q,Q] and r o (x
    dst) [BC,H,Q,N]) allocated here; inputs are checked by the caller.
    Raises if a launch was refused."""
    lib = _lib()
    B, nC, Q, H, P = xq.shape
    N = Bq.shape[-1]
    BC = B * nC
    f32 = dict(dtype=torch.float32, device=xq.device)
    G = torch.empty((BC, Q, Q), **f32)
    dGh = torch.empty((BC, H, Q, Q), **f32)
    dB2h = torch.empty((BC, H, Q, N), **f32)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.ssd_chunk_bwd_launch(
            xq.data_ptr(), Bq.data_ptr(), Cq.data_ptr(), da.data_ptr(),
            dy.data_ptr(), dst.data_ptr(), dx.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), dda.data_ptr(), G.data_ptr(), dGh.data_ptr(),
            dB2h.data_ptr(), int(xq.dtype == torch.bfloat16), BC, Q, H, P,
            N, stream)
    if err != 0:
        msg = lib.ssd_chunk_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk_bwd launch failed: {msg} ({err})")
