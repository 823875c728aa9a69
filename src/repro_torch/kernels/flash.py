"""Flash attention of the dense family (the forward and the custom VJP's
backward; the forward also MLA's, Dq != Dv with f32 keys): the
hand-written CUDA kernels' binding.

The kernel source is `repro_torch/csrc/flash_attn.cu`; its head comment
says which function of the JAX package it replaces, what bounds it and
how it is laid out. This module reads each operand through its strides
(`operand_strides`), binds the library (built at first use by
:mod:`repro_torch.kernels.build`) and launches it. Call it through
:func:`repro_torch.kernels.ops.flash_fwd` and
:func:`repro_torch.kernels.ops.flash_bwd`, which check the inputs, take
the plain versions for CPU tensors and count launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.silu import _on_device

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
D_STEP, D_MAX = 16, 128        # head dims a multiple of 16, at most 128
DQ_MAX_F32_KEYS = 96           # Dq beside f32 keys (the 64 + 32 layout)
DV_MAX_F32_KEYS = 64           # Dv beside f32 keys (the bf16 kernel's smem)
MAX_HEADS = 65535              # B * K * G: the f32 kernels' grid y

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STRIDES = ctypes.c_longlong * 20


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attn")
    if not getattr(lib, "_typed", False):
        lib.flash_fwd_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                         _I, _I, _I, _I, _I, _F, _I, _P, _P]
        lib.flash_fwd_launch.restype = _I
        lib.flash_bwd_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                         _P, _I, _I, _I, _I, _I, _I, _F, _I,
                                         _P, _P]
        lib.flash_bwd_launch.restype = _I
        lib.flash_error_string.argtypes = [_I]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def check_dims(Dq: int, Dv: int, f32_keys: bool) -> None:
    """Raise unless the card's kernels take head dims Dq (q, k) and Dv
    (v, out): each a multiple of 16 up to 128, and beside f32 keys
    (`f32_keys`) Dq at most 96 (the one instance laid out for them, 64 +
    32 columns) and Dv at most 64 (their hi and lo tiles, q's and v's
    take two stages of shared memory). The plain versions take any."""
    for name, d in (("Dq", Dq), ("Dv", Dv)):
        if d % D_STEP or not 0 < d <= D_MAX:
            raise ValueError(f"head dim {name} = {d}: the card's kernels "
                             f"take a multiple of {D_STEP} up to {D_MAX}")
    for name, d, most in (("Dq", Dq, DQ_MAX_F32_KEYS),
                          ("Dv", Dv, DV_MAX_F32_KEYS)):
        if f32_keys and d > most:
            raise ValueError(f"head dim {name} = {d} beside f32 keys: the "
                             f"card's kernel takes at most {most}")


def operand_strides(t: torch.Tensor) -> Optional[Tuple[int, int, int, int]]:
    """(batch, kv head, group, row) element strides of q-like [B,K,G,S,D]
    or k-like [B,K,S,D] `t` (group 0 for the latter; a dim of size 1
    counts 0), or None where the kernels cannot read it in place: D not
    unit-stride, or (bf16, read by TMA, whose tensor maps take 16-byte
    aligned addresses and non-zero strides of 16-byte multiples) a row
    start off 16-byte alignment or a broadcast (stride 0 on a dim longer
    than 1)."""
    st = [0 if n == 1 else s for n, s in zip(t.shape, t.stride())]
    if t.dim() == 4:
        st.insert(2, 0)
    if t.shape[-1] > 1 and st[-1] != 1:
        return None
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(s % 8 for s in st[:4]) or
            any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape))):
        return None
    return tuple(st[:4])


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().flash_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _strides(*views) -> "ctypes.Array":
    return _STRIDES(*[s for v in views for s in v],
                    *([0] * (20 - 4 * len(views))))


def launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, window: int,
               views) -> None:
    """out [B,K,G,S,Dv] (dense, v's dtype) and lse [B,K,G,S] (dense, f32)
    of causal attention on the current stream of q's device; inputs are
    checked by the caller (`views`: q's, k's and v's
    :func:`operand_strides`). One kernel, or, for f32 keys beside a bf16
    q, two: the split of k into bf16 hi and lo (dense, into a scratch
    buffer of k's bytes), then the attention reading both."""
    B, K, G, S, Dq = q.shape
    Dv = v.shape[3]
    strides = _strides(*views)
    hi = lo = None
    if k.dtype != q.dtype:
        parts = torch.empty((2,) + tuple(k.shape), dtype=torch.bfloat16,
                            device=k.device)
        hi, lo = parts[0].data_ptr(), parts[1].data_ptr()
    _check(_on_device(q.device, _lib().flash_fwd_launch, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      lse.data_ptr(), hi, lo, B, K, G, S, Dq, Dv, window,
                      Dq ** -0.5, DTYPES[q.dtype], ctypes.addressof(strides)),
           "flash_fwd")


def launch_bwd(g: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
               delta: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
               dv: torch.Tensor, window: int, views) -> None:
    """dq (dense, [B,K,G,S,D]), dk and dv (dense, [B,K,S,D]) in the
    operands' dtype given the cotangent g of `out`; `delta` [B,K,G,S]
    f32 scratch. Two kernels on the current stream of q's device in bf16
    (dq with delta, then dk and dv), three in f32 (delta first); inputs
    are checked by the caller (`views`: q's, k's, v's, g's and out's
    :func:`operand_strides`)."""
    B, K, G, S, D = q.shape
    strides = _strides(*views)
    _check(_on_device(q.device, _lib().flash_bwd_launch, g.data_ptr(),
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, K, G,
                      S, D, window, D ** -0.5, DTYPES[q.dtype],
                      ctypes.addressof(strides)),
           "flash_bwd")
