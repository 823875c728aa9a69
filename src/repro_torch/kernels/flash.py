"""Flash attention of the dense family (the forward and the custom VJP's
backward) and MLA's (Dq != Dv, f32 keys, q and k read from their nope
and rope parts, forward and backward): the hand-written CUDA kernels'
binding.

The kernel source is `repro_torch/csrc/flash_attn.cu`; its head comment
says which function of the JAX package it replaces, what bounds it and
how it is laid out. This module reads each operand through its strides
(`operand_strides`), binds the library (built at first use by
:mod:`repro_torch.kernels.build`) and launches it. Call it through
:func:`repro_torch.kernels.ops.flash_fwd`,
:func:`repro_torch.kernels.ops.flash_fwd_mla`,
:func:`repro_torch.kernels.ops.flash_bwd` and
:func:`repro_torch.kernels.ops.flash_bwd_mla`, which check the inputs, take
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
# MLA's parts (`check_dims` with `parts`): nope and v columns in one
# 64-column region, rope columns in a 32-column tail, each a multiple of
# 8 (TMA's 16 bytes of bf16)
PART_STEP = 8
PART_MAX = {"nd": 64, "rd": 32, "Dv": 64}
MAX_HEADS = 65535              # B * K * G: the f32 kernels' grid y

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STRIDES = ctypes.c_longlong * 28   # 4 a view, 7 views at most


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attn")
    if not getattr(lib, "_typed", False):
        lib.flash_fwd_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _I, _I, _F, _I, _P, _P]
        lib.flash_fwd_launch.restype = _I
        lib.flash_fwd_mla_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I,
                                             _I, _I, _I, _I, _I, _F, _I, _P,
                                             _P]
        lib.flash_fwd_mla_launch.restype = _I
        lib.flash_bwd_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                         _P, _I, _I, _I, _I, _I, _I, _F, _I,
                                         _P, _P]
        lib.flash_bwd_launch.restype = _I
        lib.flash_bwd_mla_launch.argtypes = [_P] * 13 + [_I] * 6 + [
            _F, _I, _P, _P]
        lib.flash_bwd_mla_launch.restype = _I
        lib.flash_error_string.argtypes = [_I]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def check_dims(Dq: int, Dv: int,
               parts: Optional[Tuple[int, int]] = None) -> None:
    """Raise unless the card's kernels take head dims Dq (q, k) and Dv
    (v, out): each a multiple of 16 up to 128; or, for MLA's parts
    (`parts` = (nd, rd), Dq = nd + rd), nope columns nd at most 64 (one
    region, where the kernel splits the f32 keys), rope columns rd at
    most 32 (the tail) and Dv at most 64 (the shared memory of q, the
    keys' hi, lo and rope tiles and v), each a positive multiple of 8,
    forward and backward alike. The plain versions take any."""
    if parts is None:
        for name, d in (("Dq", Dq), ("Dv", Dv)):
            if d % D_STEP or not 0 < d <= D_MAX:
                raise ValueError(f"head dim {name} = {d}: the card's "
                                 f"kernels take a multiple of {D_STEP} up "
                                 f"to {D_MAX}")
        return
    nd, rd = parts
    for name, d in (("nd", nd), ("rd", rd), ("Dv", Dv)):
        if d % PART_STEP or not 0 < d <= PART_MAX[name]:
            raise ValueError(f"MLA's head dim {name} = {d}: the card's "
                             f"kernel takes a multiple of {PART_STEP} up to "
                             f"{PART_MAX[name]} (nope 64, rope 32, v 64)")


def operand_strides(t: torch.Tensor, tma: bool = False
                    ) -> Optional[Tuple[int, int, int, int]]:
    """(batch, kv head, group, row) element strides of q-like [B,K,G,S,D]
    or k-like [B,K,S,D] `t` (group 0 for the latter; a dim of size 1
    counts 0), or None where the kernels cannot read it in place: D not
    unit-stride, or (read by TMA, whose tensor maps take 16-byte aligned
    addresses and non-zero strides of 16-byte multiples: bf16, and `tma`
    for f32, MLA's keys) a row start off 16-byte alignment or a
    broadcast (stride 0 on a dim longer than 1)."""
    st = [0 if n == 1 else s for n, s in zip(t.shape, t.stride())]
    if t.dim() == 4:
        st.insert(2, 0)
    if t.shape[-1] > 1 and st[-1] != 1:
        return None
    if (t.dtype == torch.bfloat16 or tma) and (
            t.data_ptr() % 16 or
            any(s * t.element_size() % 16 for s in st[:4]) or
            any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape))):
        return None
    return tuple(st[:4])


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().flash_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _strides(*views) -> "ctypes.Array":
    return _STRIDES(*[s for v in views for s in v],
                    *([0] * (len(_STRIDES()) - 4 * len(views))))


def launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, window: int,
               views) -> None:
    """out [B,K,G,S,Dv] (dense, v's dtype) and lse [B,K,G,S] (dense, f32)
    of causal attention on the current stream of q's device, one kernel;
    inputs (one dtype) are checked by the caller (`views`: q's, k's and
    v's :func:`operand_strides`)."""
    B, K, G, S, Dq = q.shape
    Dv = v.shape[3]
    strides = _strides(*views)
    _check(_on_device(q.device, _lib().flash_fwd_launch, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      lse.data_ptr(), B, K, G, S, Dq, Dv, window,
                      Dq ** -0.5, DTYPES[q.dtype], ctypes.addressof(strides)),
           "flash_fwd")


def launch_fwd_mla(q_nope: torch.Tensor, q_rope: torch.Tensor,
                   k_nope: torch.Tensor, k_rope: torch.Tensor,
                   v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                   views) -> None:
    """out [B,H,1,S,Dv] and lse [B,H,1,S] (dense) of MLA's causal
    attention from its parts, one kernel on the current stream of q's
    device: bf16 q, k_rope and v beside f32 k_nope (split into bf16 hi
    and lo inside the kernel), or all f32; inputs are checked by the
    caller (`views`: the parts' :func:`operand_strides`, k_nope's read
    by TMA in bf16 runs)."""
    B, H, S, nd = q_nope.shape
    rd, Dv = q_rope.shape[3], v.shape[3]
    strides = _strides(*views)
    _check(_on_device(q_nope.device, _lib().flash_fwd_mla_launch,
                      q_nope.data_ptr(), q_rope.data_ptr(),
                      k_nope.data_ptr(), k_rope.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), B, H, S, nd, rd, Dv,
                      (nd + rd) ** -0.5, DTYPES[q_nope.dtype],
                      ctypes.addressof(strides)),
           "flash_fwd (mla)")


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


def launch_bwd_mla(g: torch.Tensor, q_nope: torch.Tensor,
                   q_rope: torch.Tensor, k_nope: torch.Tensor,
                   k_rope: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                   lse: torch.Tensor, delta: torch.Tensor, dq: torch.Tensor,
                   dk: torch.Tensor, dv: torch.Tensor, dk_rope: torch.Tensor,
                   views) -> None:
    """MLA's backward from its parts on the current stream of q_nope's
    device: dq [B,H,S,nd + rd] (q's dtype), dk [B,H,S,nd + rd] (f32), dv
    [B,H,S,Dv] and dk_rope [B,1,S,rd] (dk's rope columns summed over the
    heads, k_rope's dtype), all dense, given the cotangent g of out;
    `delta` [B,H,1,S] f32 scratch. bf16 q, k_rope, v, g and out beside
    f32 k_nope (split into bf16 hi and lo inside the kernels), or all
    f32. Inputs are checked by the caller (`views`: the parts', g's and
    out's :func:`operand_strides`, k_nope's read by TMA in bf16 runs)."""
    B, H, S, nd = q_nope.shape
    rd, Dv = q_rope.shape[3], v.shape[3]
    strides = _strides(*views)
    _check(_on_device(q_nope.device, _lib().flash_bwd_mla_launch,
                      g.data_ptr(), q_nope.data_ptr(), q_rope.data_ptr(),
                      k_nope.data_ptr(), k_rope.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      dk_rope.data_ptr(), B, H, S, nd, rd, Dv,
                      (nd + rd) ** -0.5, DTYPES[q_nope.dtype],
                      ctypes.addressof(strides)),
           "flash_bwd (mla)")
