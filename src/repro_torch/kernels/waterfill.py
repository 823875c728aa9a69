"""The batched progressive water-fill: the hand-written CUDA kernel.

Port of `repro/kernels/waterfill.py`, whose `fill_rates_loop` is a jit
`lax.while_loop` (not Pallas). The kernel source is
`repro_torch/csrc/waterfill.cu`; its head comment says what bounds it
on an H100 (the latency of its dependent iterations, and around it the
launch and the copies) and how the design answers that: a warp a fill
for N <= 8 (several fills a block), a block a fill up to N = 32, one
load-sum round an iteration, the whole loop on the device.

This module binds the library (built at first use by
:mod:`repro_torch.kernels.build`) and launches it. :func:`fill_rates`
is the numpy-in / numpy-out call the simulator's ``"cuda"`` and
``"torch"`` backends make: on the card one C call that stages, copies,
launches and synchronises (:func:`host_fill`). Tensors go through
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
MAX_N = 32               # a block a fill, a thread a pair: 1,024 at most

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
        for fn in (lib.waterfill_launch, lib.waterfill_fill_host):
            fn.argtypes = [_P] * 5 + [_L] + [_P] * 4 + [_I] * 3 + [_P]
            fn.restype = _I
        lib.waterfill_error_string.argtypes = [_I]
        lib.waterfill_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str, B: int, n: int) -> None:
    if err != 0:
        msg = lib.waterfill_error_string(err).decode()
        raise RuntimeError(f"waterfill {what} failed: {msg} ({err}) at "
                           f"B={B}, N={n}")


def launch(c: torch.Tensor, single: torch.Tensor, egress: torch.Tensor,
           ingress: torch.Tensor, w: torch.Tensor, path_cap: torch.Tensor,
           rate: torch.Tensor, iters: torch.Tensor,
           converged: torch.Tensor,
           lib: Optional[ctypes.CDLL] = None) -> None:
    """One launch on the current stream of c's device: B fills (N <= 8:
    a warp each, else a block each); inputs and outputs are checked by
    the caller. `lib` is another build of the library (default this
    tree's)."""
    B, n, _ = c.shape
    lib = _lib() if lib is None else lib
    w_stride = 0 if w.dim() == 2 else n * n
    with torch.cuda.device(c.device):
        err = lib.waterfill_launch(
            c.data_ptr(), single.data_ptr(), egress.data_ptr(),
            ingress.data_ptr(), w.data_ptr(), w_stride, path_cap.data_ptr(),
            rate.data_ptr(), iters.data_ptr(), converged.data_ptr(), B, n,
            max_fill_iters(n), torch.cuda.current_stream(c.device).cuda_stream)
    _raise_on(lib, err, "launch", B, n)


def host_inputs(c, single, egress, ingress, w, path_cap
                ) -> Tuple[np.ndarray, ...]:
    """The six inputs as contiguous f64 arrays of a batch: c / single /
    path_cap [B, N, N], egress / ingress [B, N], w [N, N] or [B, N, N];
    one fill's [N, N] / [N] inputs become B = 1. Raises ValueError on a
    shape the kernel does not take (N outside [1, 32], mismatched
    shapes)."""
    c, single, egress, ingress, w, path_cap = (
        np.ascontiguousarray(a, np.float64)
        for a in (c, single, egress, ingress, w, path_cap))
    if c.ndim not in (2, 3) or c.shape[-1] != c.shape[-2]:
        raise ValueError(f"c must be [N, N] or [B, N, N], got {c.shape}")
    n = c.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"fill_rates takes 1 <= N <= {MAX_N}, got N={n}")
    lead = c.shape[:-2]
    for name, a, shape in (("single", single, c.shape),
                           ("path_cap", path_cap, c.shape),
                           ("egress", egress, lead + (n,)),
                           ("ingress", ingress, lead + (n,))):
        if a.shape != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {a.shape}")
    if w.shape not in ((n, n), c.shape):
        raise ValueError(f"w must be [{n}, {n}] or {list(c.shape)}, got "
                         f"{w.shape}")
    B = c.shape[0] if c.ndim == 3 else 1
    return (c.reshape(B, n, n), single.reshape(B, n, n),
            egress.reshape(B, n), ingress.reshape(B, n),
            w if w.ndim == 2 else w.reshape(B, n, n),
            path_cap.reshape(B, n, n))


def host_fill(c: np.ndarray, single: np.ndarray, egress: np.ndarray,
              ingress: np.ndarray, w: np.ndarray, path_cap: np.ndarray,
              dev: torch.device, lib: Optional[ctypes.CDLL] = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """B >= 1 fills of `host_inputs`' arrays on the card in one C call
    (`waterfill_fill_host`: one copy in through the library's pinned
    buffer, the launch, one copy out, a synchronise, on the current
    stream of `dev`) -> numpy (rate, iters, converged). Raises on any
    CUDA error, naming B and N. `lib` as in :func:`launch`."""
    B, n = c.shape[0], c.shape[-1]
    rate = np.empty((B, n, n), np.float64)
    iters = np.empty(B, np.int32)
    ok = np.empty(B, np.bool_)
    lib = _lib() if lib is None else lib
    with torch.cuda.device(dev):
        err = lib.waterfill_fill_host(
            c.ctypes.data, single.ctypes.data, egress.ctypes.data,
            ingress.ctypes.data, w.ctypes.data, 0 if w.ndim == 2 else n * n,
            path_cap.ctypes.data, rate.ctypes.data, iters.ctypes.data,
            ok.ctypes.data, B, n, max_fill_iters(n),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "host call", B, n)
    return rate, iters, ok


def fill_rates(c: np.ndarray, single: np.ndarray, egress: np.ndarray,
               ingress: np.ndarray, w: np.ndarray, path_cap: np.ndarray,
               device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy-in / numpy-out fill in float64: one [N, N] fill, or a batch
    with c / single / path_cap [B, N, N], egress / ingress [B, N] and w
    [N, N] or [B, N, N]. Returns numpy ``(rate, iters, converged)`` with
    the same leading shape (scalars' arrays for one fill).

    `device` None means CUDA (raising without a card): the kernel, one
    C call (:func:`host_fill`), counted in ``ops.fill_rates.launches``;
    it makes no torch tensor. ``"cpu"`` runs the plain version through
    :func:`repro_torch.kernels.ops.fill_rates`. Shapes are checked
    before either.
    """
    # ops imports this module (the kernel's binding and constants)
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    one = np.ndim(c) == 2
    args = host_inputs(c, single, egress, ingress, w, path_cap)
    if dev.type == "cpu":
        rate, iters, ok = (t.numpy() for t in ops.fill_rates(
            *(torch.tensor(a) for a in args)))
    elif args[0].shape[0] == 0:
        n = args[0].shape[-1]
        rate, iters, ok = (np.empty((0, n, n)), np.empty(0, np.int32),
                           np.empty(0, np.bool_))
    else:
        rate, iters, ok = host_fill(*args, dev)
        ops.fill_rates.launches += 1
    if one:
        return rate[0], iters[0], ok[0]
    return rate, iters, ok
