"""Flash-attention forward: the hand-written CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas/flash_attention.py``
(``_fwd`` / ``_fwd_kernel``). The CUDA source is
``paddle_tpu_torch/csrc/flash_attention_fwd.cu``; its header says what
bounds it on an H100 and how the design answers that. The backward
kernels (``_dq_kernel``, ``_dkv_kernel``) are not ported yet: the port
serves, it does not train.

``flash_attention_fwd`` takes the kernel for CUDA tensors — there is no
fallback: a CUDA input it cannot take raises — and the plain torch
composition ``flash_attention_fwd_plain`` for tensors that do not lie on
a card (the CPU tests, and the build-time shape trace on "meta").
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build

NEG_INF = -1e30   # the reference's masked-score value
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_SOURCE = "flash_attention_fwd.cu"


def _bias_4d(bias: torch.Tensor) -> torch.Tensor:
    if bias.ndim == 2:        # [Sq|1, Sk|1]
        return bias[None, None]
    if bias.ndim == 3:        # [B|1, Sq|1, Sk|1]
        return bias[:, None]
    return bias


def flash_attention_fwd_plain(q, k, v, bias=None, causal: bool = False,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Straightforward torch composition with the kernel's semantics:
    returns (O [B,H,Sq,D], lse [B,H,Sq]) in float32. bias is additive and
    broadcastable to [B,H,Sq,Sk]; causal masks kpos > qpos with NEG_INF;
    a row whose probabilities all vanish gives O = 0."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + _bias_4d(bias).float()
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        qpos = torch.arange(sq, device=s.device)[:, None]
        kpos = torch.arange(sk, device=s.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()) / torch.where(l == 0, torch.ones_like(l), l)
    lse = (m + torch.log(torch.clamp(l, min=1e-37))).squeeze(-1)
    return o.to(q.dtype), lse


def _library() -> ctypes.CDLL:
    lib = build.library(_SOURCE)
    if not getattr(lib, "_paddle_bound", False):
        fn = lib.flash_attention_fwd_f32
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 4
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._paddle_bound = True
    return lib


def _check_inputs(q, k, v, bias):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention_fwd: {name} is {t.dtype}; "
                            "the kernel takes float32 only")
        if t.ndim != 4:
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"[B,H,S,D], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             "contiguous")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d):
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if sq < 1 or sk < 1 or b * h > 65535:
        raise ValueError(f"flash_attention_fwd: unsupported sizes B*H="
                         f"{b * h}, Sq={sq}, Sk={sk}")
    if bias is not None:
        if bias.device != q.device or bias.dtype != torch.float32:
            raise TypeError("flash_attention_fwd: bias must be float32 on "
                            f"{q.device}, got {bias.dtype} on {bias.device}")
        if bias.ndim not in (2, 3, 4):
            raise ValueError("flash_attention_fwd: bias must have 2-4 dims")


def flash_attention_fwd(q, k, v, bias=None, causal: bool = False,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax attention forward: (O [B,H,Sq,D], lse [B,H,Sq]).

    q: [B,H,Sq,D]; k, v: [B,H,Sk,D]; bias additive with any dim
    broadcast (size 1); causal adds the qpos >= kpos mask; sm_scale
    defaults to 1/sqrt(D). CUDA tensors run the hand-written kernel
    (float32, contiguous, D in SUPPORTED_HEAD_DIMS — anything else
    raises); other tensors run flash_attention_fwd_plain."""
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v, bias, causal, sm_scale)
    _check_inputs(q, k, v, bias)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    strides = (0, 0, 0, 0)
    if bias is not None:
        bias4 = _bias_4d(bias)
        try:
            bias = bias4.expand(b, h, sq, sk)
        except RuntimeError as e:
            raise ValueError(f"flash_attention_fwd: bias {tuple(bias4.shape)} "
                             f"does not broadcast to {(b, h, sq, sk)}") from e
        strides = bias.stride()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            o.data_ptr(), lse.data_ptr(), b, h, sq, sk, d, *strides,
            int(bool(causal)), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(
            "flash_attention_fwd kernel launch failed: "
            f"{lib.flash_attention_error_string(err).decode()}")
    flash_attention_fwd.launches += 1
    return o, lse


#: kernel launches since the count was last set to 0 (the wrapper adds
#: one per launch and nowhere else; the plain path does not count)
flash_attention_fwd.launches = 0
