"""The batched progressive water-fill: the hand-written CUDA kernel.

Port of `repro/kernels/waterfill.py`, whose `fill_rates_loop` is a jit
`lax.while_loop` (not Pallas). The kernel source is
`repro_torch/csrc/waterfill.cu`; its head comment says what bounds it
on an H100 (the latency of its dependent iterations, and around it the
launch and the copies) and how the design answers that: one block per
fill, one thread per pair, the whole loop on the device.

This module binds the library (built at first use by
:mod:`repro_torch.kernels.build`) and launches it, and
:func:`fill_rates` is the numpy-in / numpy-out call the simulator's
``"cuda"`` and ``"torch"`` backends make. Tensors go through
:func:`repro_torch.kernels.ops.fill_rates`, which checks them, takes
the plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build

EPS_DEN = 1e-12          # weight-denominator clip (matches numpy)
EPS_INC = 1e-9           # smallest meaningful fill-level increment
EPS_SAT = 1e-6           # constraint-saturation slack
MAX_N = 32               # one thread per pair: at most 1,024 a block

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def max_fill_iters(n: int) -> int:
    """The provable iteration bound of the progressive fill: each
    iteration freezes >=1 of the N*(N-1) pairs or stalls; 8*N*N is the
    historical (very generous) cap the numpy loop used silently."""
    return 8 * n * n


def _lib() -> ctypes.CDLL:
    lib = build.load("waterfill")
    if not getattr(lib, "_typed", False):
        lib.waterfill_launch.argtypes = [_P] * 5 + [_L] + [_P] * 4 + \
            [_I] * 3 + [_P]
        lib.waterfill_launch.restype = _I
        lib.waterfill_error_string.argtypes = [_I]
        lib.waterfill_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def launch(c: torch.Tensor, single: torch.Tensor, egress: torch.Tensor,
           ingress: torch.Tensor, w: torch.Tensor, path_cap: torch.Tensor,
           rate: torch.Tensor, iters: torch.Tensor,
           converged: torch.Tensor) -> None:
    """One launch on the current stream of c's device: B fills, a block
    each; inputs and outputs are checked by the caller."""
    B, n, _ = c.shape
    lib = _lib()
    w_stride = 0 if w.dim() == 2 else n * n
    with torch.cuda.device(c.device):
        err = lib.waterfill_launch(
            c.data_ptr(), single.data_ptr(), egress.data_ptr(),
            ingress.data_ptr(), w.data_ptr(), w_stride, path_cap.data_ptr(),
            rate.data_ptr(), iters.data_ptr(), converged.data_ptr(), B, n,
            max_fill_iters(n), torch.cuda.current_stream(c.device).cuda_stream)
    if err != 0:
        msg = lib.waterfill_error_string(err).decode()
        raise RuntimeError(f"waterfill launch failed: {msg} ({err}) at "
                           f"B={B}, N={n}")


def fill_rates(c: np.ndarray, single: np.ndarray, egress: np.ndarray,
               ingress: np.ndarray, w: np.ndarray, path_cap: np.ndarray,
               device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy-in / numpy-out fill in float64: one [N, N] fill, or a batch
    with c / single / path_cap [B, N, N], egress / ingress [B, N] and w
    [N, N] or [B, N, N]. Returns numpy ``(rate, iters, converged)`` with
    the same leading shape (scalars' arrays for one fill).

    `device` None means CUDA (raising without a card): the kernel, one
    launch. ``"cpu"`` runs the plain version. On the card the inputs
    are packed into one host buffer and cross in one host-to-device
    copy; rate, iters and the flag come back in one device-to-host copy
    of one buffer, which synchronises. That round trip is the point of
    the fill's cost on the control loop, beside the launch: a pageable
    copy each way (2,176 bytes in and 517 out for one 8-DC fill) and
    the host's wait for the kernel.
    """
    # ops imports this module (the kernel's binding and constants)
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    one = np.ndim(c) == 2
    c, single, path_cap = (np.asarray(a, np.float64).reshape(
        (-1,) + np.shape(a)[-2:]) for a in (c, single, path_cap))
    egress, ingress = (np.asarray(a, np.float64).reshape(-1, c.shape[-1])
                       for a in (egress, ingress))
    w = np.asarray(w, np.float64)
    B, n = c.shape[0], c.shape[-1]
    # one host buffer: c, single, path_cap, w, egress, ingress
    parts = (c, single, path_cap, w, egress, ingress)
    sizes = [a.size for a in parts]
    buf = np.concatenate([a.reshape(-1) for a in parts])
    flat = torch.from_numpy(buf).to(dev)
    views, ofs = [], 0
    for a, k in zip(parts, sizes):
        views.append(flat[ofs:ofs + k].view(a.shape))
        ofs += k
    tc, tsingle, tcap, tw, te, ti = views
    if dev.type == "cpu":
        rate, iters, ok = ops.fill_rates(tc, tsingle, te, ti, tw, tcap)
        rate, iters, ok = rate.numpy(), iters.numpy(), ok.numpy()
    else:
        # one device buffer: rate f64 [B,N,N], iters int32 [B], flag [B]
        nr = B * n * n * 8
        out = torch.empty(nr + 5 * B, dtype=torch.uint8, device=dev)
        ops.fill_rates(tc, tsingle, te, ti, tw, tcap, out=(
            out[:nr].view(torch.float64).view(B, n, n),
            out[nr:nr + 4 * B].view(torch.int32),
            out[nr + 4 * B:].view(torch.bool)))
        host = out.cpu().numpy()
        rate = host[:nr].view(np.float64).reshape(B, n, n)
        iters = host[nr:nr + 4 * B].view(np.int32)
        ok = host[nr + 4 * B:].view(np.bool_)
    if one:
        return rate[0], iters[0], ok[0]
    return rate, iters, ok
