"""The MoE layer's routing slots, dispatch and combine and the two
latter's backwards: the hand-written CUDA kernels' binding.

The kernel source is `repro_torch/csrc/moe.cu`; its head comment says
which ops of the JAX package's program they replace and how they round.
This module binds the library (built at first use by
:mod:`repro_torch.kernels.build`) and launches it. Call it through
:func:`repro_torch.kernels.ops.moe_slots`,
:func:`~repro_torch.kernels.ops.moe_dispatch`,
:func:`~repro_torch.kernels.ops.moe_combine`,
:func:`~repro_torch.kernels.ops.moe_dispatch_bwd`,
:func:`~repro_torch.kernels.ops.moe_combine_bwd` and
:func:`~repro_torch.kernels.ops.moe_gates_bwd`, which check the inputs,
take the plain versions for CPU tensors and count launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.silu import _on_device

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 32                  # choices a token (a lane each, csrc/moe.cu)
MAX_EXPERTS = 256           # the slots kernel's per-warp counts
MAX_GATES_D = 1 << 20       # moe_gates_bwd's row, at most (int indices)
MAX_TOKENS = 1 << 30        # the token kernels' T, below (int indices)
SLOTS_CHUNK = 512           # choices a block of the slots kernel, at least

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("moe")
    if not getattr(lib, "_typed", False):
        lib.moe_slots_launch.argtypes = [_P, _P, _P, _P, _P, _L, _L, _L, _L,
                                         _L, _L, _P]
        lib.moe_slots_launch.restype = _I
        lib.moe_dispatch_launch.argtypes = [_P, _P, _P, _L, _L, _L, _I, _P]
        lib.moe_dispatch_launch.restype = _I
        lib.moe_combine_launch.argtypes = [_P, _P, _P, _P, _P, _P, _L, _L,
                                           _L, _L, _I, _P]
        lib.moe_combine_launch.restype = _I
        lib.moe_dispatch_bwd_launch.argtypes = [_P, _P, _P, _P, _P, _L, _L,
                                                _L, _L, _I, _P]
        lib.moe_dispatch_bwd_launch.restype = _I
        lib.moe_combine_bwd_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                                               _L, _L, _L, _L, _L, _I, _P]
        lib.moe_combine_bwd_launch.restype = _I
        lib.moe_gates_bwd_launch.argtypes = [_P, _P, _P, _P, _P, _P, _L, _L,
                                             _L, _L, _I, _P]
        lib.moe_gates_bwd_launch.restype = _I
        for fn in (lib.moe_combine_workers, lib.moe_dispatch_bwd_workers,
                   lib.moe_gates_bwd_workers):
            fn.argtypes = [_L, _I, _I]
            fn.restype = _L
        lib.moe_error_string.argtypes = [_I]
        lib.moe_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().moe_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _workers(fn, d: int, dtype: torch.dtype, wide: bool, what: str) -> int:
    n = fn(d, DTYPES[dtype], int(wide))
    if n < 0:
        _check(-n, what)
    return n


def combine_workers(d: int, dtype: torch.dtype, wide: bool = True) -> int:
    """The token groups `moe_combine`'s persistent grid holds on the
    current CUDA device for rows of d elements of dtype, on 16-byte
    storage (`wide`) or not: a group takes a token, and a call of more
    tokens takes several a group."""
    return _workers(_lib().moe_combine_workers, d, dtype, wide,
                    "moe_combine_workers")


def dispatch_bwd_workers(d: int, dtype: torch.dtype, wide: bool = True
                         ) -> int:
    """The token groups `moe_dispatch_bwd`'s persistent grid holds on
    the current CUDA device for rows of d elements of dtype, on 16-byte
    storage (`wide`) or not, as `combine_workers` counts them."""
    return _workers(_lib().moe_dispatch_bwd_workers, d, dtype, wide,
                    "moe_dispatch_bwd_workers")


def _check_tokens(T: int, what: str) -> None:
    """Refuses T at or above MAX_TOKENS before the card: a token
    kernel's persistent grid indexes tokens with ints."""
    if T >= MAX_TOKENS:
        raise ValueError(f"{what} takes fewer than {MAX_TOKENS} tokens on "
                         f"the card, got {T}")


def gates_bwd_workers(d: int, dtype: torch.dtype, wide: bool = True) -> int:
    """The warps `moe_gates_bwd`'s persistent grid holds on the current
    CUDA device (a choice each) for rows of d elements of dtype, on
    16-byte storage (`wide`) or not."""
    return _workers(_lib().moe_gates_bwd_workers, d, dtype, wide,
                    "moe_gates_bwd_workers")


def launch_slots(eidx: torch.Tensor, pos_c: torch.Tensor, keep: torch.Tensor,
                 src: torch.Tensor) -> None:
    """pos_c [G,Tg,k] int64, keep [G,Tg,k] bool and src [G,E,C] int32
    (dense) from the choices' experts eidx [G,Tg,k] int64; one
    cooperative launch on the current stream of eidx's device, with
    scratch for each block's counts of each expert (a group takes at
    most one block a SLOTS_CHUNK choices). Inputs are checked by the
    caller."""
    G, Tg, k = eidx.shape
    _, E, C = src.shape
    blocks = G * -(-Tg * k // SLOTS_CHUNK)
    part = torch.empty(blocks * E, dtype=torch.int32, device=eidx.device)
    _check(_on_device(eidx.device, _lib().moe_slots_launch, eidx.data_ptr(),
                      pos_c.data_ptr(), keep.data_ptr(), src.data_ptr(),
                      part.data_ptr(), part.numel(), G, Tg, k, E, C),
           "moe_slots")


def launch_dispatch(x: torch.Tensor, src: torch.Tensor,
                    buf: torch.Tensor) -> None:
    """buf [E,C,d] (dense, x's dtype) = x's row src[e, c] at each slot,
    zeros where src is -1; one launch on the current stream of x's
    device. Inputs are checked by the caller."""
    T, d = x.shape
    _check(_on_device(x.device, _lib().moe_dispatch_launch, x.data_ptr(),
                      src.data_ptr(), buf.data_ptr(), T, d, src.numel(),
                      DTYPES[x.dtype]), "moe_dispatch")


def launch_combine(ob: torch.Tensor, eidx: torch.Tensor, pos_c: torch.Tensor,
                   keep: torch.Tensor, gates: torch.Tensor,
                   y: torch.Tensor) -> None:
    """y [T,d] (dense, ob's dtype) = the gated sum of each token's k rows
    of ob; one launch (a persistent grid of warps, up to four a token) on
    the current stream of ob's device. Inputs are checked by the
    caller; T at or above MAX_TOKENS raises."""
    T, k = eidx.shape
    _check_tokens(T, "moe_combine")
    _, C, d = ob.shape
    _check(_on_device(ob.device, _lib().moe_combine_launch, ob.data_ptr(),
                      eidx.data_ptr(), pos_c.data_ptr(), keep.data_ptr(),
                      gates.data_ptr(), y.data_ptr(), T, k, d, C,
                      DTYPES[ob.dtype]), "moe_combine")


def launch_dispatch_bwd(g: torch.Tensor, eidx: torch.Tensor,
                        pos_c: torch.Tensor, keep: torch.Tensor,
                        dx: torch.Tensor) -> None:
    """dx [T,d] (dense, g's dtype) = each token's kept choices' rows of
    g [E,C,d], summed last choice first; one launch (the combine's
    persistent grid of warps) on the current stream of g's device.
    Inputs are checked by the caller; T at or above MAX_TOKENS raises."""
    T, k = eidx.shape
    _check_tokens(T, "moe_dispatch_bwd")
    _, C, d = g.shape
    _check(_on_device(g.device, _lib().moe_dispatch_bwd_launch, g.data_ptr(),
                      eidx.data_ptr(), pos_c.data_ptr(), keep.data_ptr(),
                      dx.data_ptr(), T, k, d, C, DTYPES[g.dtype]),
           "moe_dispatch_bwd")


def launch_combine_bwd(dy: torch.Tensor, gates: torch.Tensor,
                       eidx: torch.Tensor, pos_c: torch.Tensor,
                       keep: torch.Tensor, src: torch.Tensor,
                       d_ob: torch.Tensor) -> None:
    """d_ob [E,C,d] (dense, dy's dtype) = dy's row src[e, c] times the
    gate of its choice of the slot, zeros in an empty slot; one launch
    on the current stream of dy's device. Inputs are checked by the
    caller."""
    T, k = eidx.shape
    E, C = src.shape
    _check(_on_device(dy.device, _lib().moe_combine_bwd_launch,
                      dy.data_ptr(), gates.data_ptr(), eidx.data_ptr(),
                      pos_c.data_ptr(), keep.data_ptr(), src.data_ptr(),
                      d_ob.data_ptr(), T, k, dy.shape[1], E * C, C,
                      DTYPES[dy.dtype]), "moe_combine_bwd")


def launch_gates_bwd(dy: torch.Tensor, ob: torch.Tensor, eidx: torch.Tensor,
                     pos_c: torch.Tensor, keep: torch.Tensor,
                     dg: torch.Tensor) -> None:
    """dg [T,k] f32 = each kept choice's row product of dy and ob,
    reduced as XLA's CPU program reduces it; one launch (a persistent
    grid of warps, a choice each) on the current stream of dy's device.
    Inputs are checked by the caller; d above MAX_GATES_D raises."""
    if ob.shape[2] > MAX_GATES_D:
        raise ValueError(f"moe_gates_bwd takes rows of at most "
                         f"{MAX_GATES_D} elements on the card, got "
                         f"{ob.shape[2]}")
    T, k = eidx.shape
    _, C, d = ob.shape
    _check(_on_device(dy.device, _lib().moe_gates_bwd_launch, dy.data_ptr(),
                      ob.data_ptr(), eidx.data_ptr(), pos_c.data_ptr(),
                      keep.data_ptr(), dg.data_ptr(), T, k, d, C,
                      DTYPES[dy.dtype]), "moe_gates_bwd")
