"""Fused conv + BatchNorm prologue/epilogue: the hand-written CUDA kernels
and their plain twins.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas/fused_conv.py``:

  ``conv1x1_bn_act``   ``conv1x1_bn_act`` / ``_conv1x1_kernel``
                       (csrc/fused_conv.cu ``fused_conv1x1_{f32,bf16}``)
  ``conv3x3_bn_act``   ``conv3x3_bn_act`` / ``_conv3x3_kernel``
                       (``fused_conv3x3_{f32,bf16}``)

Layout, as the reference's: NHWC-flat rows, x [M, C] with M = N*H*W;
1x1 weights [K, N]; 3x3 weights tap-major [9C, N] (``pack_w3x3`` turns
OIHW into that). The optional prologue is the producer BatchNorm's
per-input-channel affine ``x*a + b`` (``a``, ``b`` [C] float32) and a
ReLU (``relu=True`` with no affine is ``max(x, 0)``); in the 3x3 conv it
comes before the edge mask, so a padded tap is 0. In bfloat16 the
activated operand is rounded back to bfloat16 before the product, as the
reference rounds it before its MXU dot (a ReLU alone is exact); the
product accumulates in float32 and ``out`` comes back in x's dtype. The
optional epilogue ``stats`` [2, N] is the sum and sum of squares of the
float32 output (before that rounding) over the M rows, what the consumer
BatchNorm needs; with ``stats=False`` it is None. The TPU kernels are
forward only (no VJP), and so are these; no op of either package
dispatches them: the ResNet models' ``conv2d`` runs through the
``conv2d`` op. The CUDA source's header says what bounds the
kernels on an H100 and how the design answers that: tensor cores
(wgmma), bfloat16 in one pass and float32 as three TF32 passes (3xTF32).

Every wrapper takes its kernel for CUDA tensors — there is no fallback:
a CUDA input the kernel cannot take raises, and so does a failed build or
launch — its plain torch twin for CPU tensors, and a shape-only path for
tensors on the "meta" device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build

_SOURCE = "fused_conv.cu"


# -- plain twins ------------------------------------------------------------

def _prologue(x, a, b, relu):
    """act(x) in float32: the affine (then the ReLU when set), rounded to
    x's dtype as the reference rounds it (a no-op in float32), or the ReLU
    alone (exact in any dtype)."""
    xf = x.float()
    if a is not None:
        xf = xf * a.float()[None, :] + b.float()[None, :]
        if relu:
            xf = torch.clamp_min(xf, 0.0)
        return xf.to(x.dtype).float()
    if relu:
        xf = torch.clamp_min(xf, 0.0)
    return xf


def _stats(out):
    return torch.stack([out.sum(0), (out * out).sum(0)])


def conv1x1_bn_act_plain(x, w, a=None, b=None, relu=False, stats=True):
    """The reference's ``reference_conv1x1_bn_act`` in torch, accumulated
    in float32: (act(x) @ w in x's dtype, its [2, N] sum / sum of squares
    of the float32 product over rows, or None)."""
    out = _prologue(x, a, b, relu) @ w.float()
    return out.to(x.dtype), (_stats(out) if stats else None)


def conv3x3_bn_act_plain(x, w, img_h, img_w, a=None, b=None, relu=False,
                         stats=True):
    """The reference's ``_conv3x3_small`` in torch, accumulated in float32:
    the activated images shifted by each tap (torch.roll), zeroed where
    the tap leaves the image, concatenated tap-major into im2col [M, 9C]
    and multiplied by w [9C, N]; out in x's dtype, stats as the 1x1's."""
    m, c = x.shape
    imgs = _prologue(x, a, b, relu).reshape(-1, img_h, img_w, c)
    hi = torch.arange(img_h, device=x.device)[None, :, None, None]
    wi = torch.arange(img_w, device=x.device)[None, None, :, None]
    cols = []
    for dh in (-1, 0, 1):
        for dw in (-1, 0, 1):
            sh = torch.roll(imgs, (-dh, -dw), dims=(1, 2))
            valid = (hi + dh >= 0) & (hi + dh < img_h) & \
                    (wi + dw >= 0) & (wi + dw < img_w)
            cols.append(torch.where(valid, sh, torch.zeros_like(sh)))
    im2col = torch.cat(cols, dim=-1).reshape(m, 9 * c)
    out = im2col @ w.float()
    return out.to(x.dtype), (_stats(out) if stats else None)


def pack_w3x3(w_oihw):
    """[O, I, 3, 3] -> tap-major [9*I, O] for conv3x3_bn_act."""
    o, i, kh, kw = w_oihw.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"pack_w3x3 needs a 3x3 kernel, got {kh}x{kw}")
    return w_oihw.permute(2, 3, 1, 0).reshape(9 * i, o)


# -- the kernels ------------------------------------------------------------

#: the kernels' operand dtypes and their C entry points' suffixes
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the library's C functions."""
    for suffix in _SUFFIX.values():
        one = getattr(lib, f"fused_conv1x1_{suffix}")
        one.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        one.restype = ctypes.c_int
        three = getattr(lib, f"fused_conv3x3_{suffix}")
        three.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        three.restype = ctypes.c_int
    lib.fused_conv_row_tile.argtypes = []
    lib.fused_conv_row_tile.restype = ctypes.c_int
    lib.fused_conv_wpack_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_conv_wpack_bytes.restype = ctypes.c_longlong
    lib.fused_conv_error_string.argtypes = [ctypes.c_int]
    lib.fused_conv_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    lib = build.library(_SOURCE)
    if not getattr(lib, "_paddle_bound", False):
        bind(lib)
        lib._paddle_bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _wpack_bytes(taps, c, n, bf16):
    return _library().fused_conv_wpack_bytes(taps, c, n, int(bf16))


def _check(who, x, w, a, b, k_rows):
    """Raise unless x [M, C] and w [k_rows, N] are contiguous tensors of
    one kernel dtype (float32 or bfloat16) on one card, a and b (given
    together) contiguous float32 [C] there, and every extent fits the
    kernels' 32-bit sizes."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1 or \
            w.shape[1] < 1 or w.shape[0] != k_rows:
        raise ValueError(f"{who}: x must be [M>=1, C>=1] and w "
                         f"[{k_rows}, N>=1], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if (a is None) != (b is None):
        raise ValueError(f"{who}: a and b go together")
    c = x.shape[1]
    if x.dtype not in _SUFFIX:
        raise ValueError(f"{who}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    tensors = dict(x=x, w=w) if a is None else dict(x=x, w=w, a=a, b=b)
    for name, t in tensors.items():
        dtype = torch.float32 if name in "ab" else x.dtype
        if t.device != x.device or t.dtype != dtype or \
                not t.is_contiguous() or \
                (name in "ab" and tuple(t.shape) != (c,)):
            raise ValueError(f"{who}: {name} must be a contiguous {dtype} "
                             f"tensor on {x.device}" + (f" of shape ({c},)"
                                                        if name in "ab"
                                                        else "") +
                             f", got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if max(x.shape[0], k_rows, w.shape[1]) >= 2 ** 31 - 1:
        raise ValueError(f"{who}: an extent exceeds the kernels' int32 "
                         "sizes")


def _launch(who, kind, x, w, a, b, n_out, stats, *sizes):
    """Allocate out [M, n_out] in x's dtype, the packed-weight scratch
    (and the stats and their partial sums), launch the `kind` ("1x1" or
    "3x3") entry point of x's dtype on the current stream, raise on its
    error."""
    lib = _library()
    m, c = x.shape
    taps = 1 if kind == "1x1" else 9
    suffix = _SUFFIX[x.dtype]
    out = torch.empty((m, n_out), dtype=x.dtype, device=x.device)
    wpack = torch.empty((_wpack_bytes(taps, c, n_out, suffix == "bf16"),),
                        dtype=torch.uint8, device=x.device)
    st = partial = None
    if stats:
        tiles = -(-m // lib.fused_conv_row_tile())
        st = torch.empty((2, n_out), dtype=torch.float32, device=x.device)
        partial = torch.empty((tiles, 2, n_out), dtype=torch.float32,
                              device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"fused_conv{kind}_{suffix}")(
            ptr(x), ptr(w), ptr(a), ptr(b), ptr(out), ptr(partial), ptr(st),
            ptr(wpack), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: "
                           f"{lib.fused_conv_error_string(err).decode()}")
    return out, st


def conv1x1_bn_act(x, w, a=None, b=None, relu=False, stats=True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused pointwise conv on NHWC-flat x [M, K] with w [K, N]:
    (act(x) @ w [M, N], stats [2, N] or None). CUDA tensors run the
    kernel of their dtype (x and w float32 or bfloat16, a and b float32,
    contiguous — anything else raises); CPU tensors run
    conv1x1_bn_act_plain; meta tensors get outputs of the right shape."""
    if x.device.type == "meta":
        return (x.new_empty((x.shape[0], w.shape[1])),
                x.new_empty((2, w.shape[1])) if stats else None)
    if not x.is_cuda:
        return conv1x1_bn_act_plain(x, w, a, b, relu, stats)
    _check("conv1x1_bn_act", x, w, a, b, x.shape[1])
    m, k = x.shape
    n = w.shape[1]
    out, st = _launch("conv1x1_bn_act", "1x1", x, w, a, b, n, stats, m, k,
                      n, int(bool(relu)))
    conv1x1_bn_act.launches += 1
    return out, st


#: kernel launches since the count was last set to 0 (one per call of the
#: C function; the plain and meta paths do not count)
conv1x1_bn_act.launches = 0


def conv3x3_bn_act(x, w, img_h, img_w, a=None, b=None, relu=False,
                   stats=True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused 3x3 stride-1 pad-1 conv on NHWC-flat x [M, C] (M a multiple
    of img_h * img_w) with tap-major w [9C, N]: (out [M, N], stats
    [2, N] or None). CUDA tensors run the kernel (same conditions as
    conv1x1_bn_act), CPU tensors conv3x3_bn_act_plain, meta tensors the
    shapes."""
    if x.device.type == "meta":
        return (x.new_empty((x.shape[0], w.shape[1])),
                x.new_empty((2, w.shape[1])) if stats else None)
    if img_h < 1 or img_w < 1 or x.shape[0] % (img_h * img_w):
        raise ValueError(f"conv3x3_bn_act: {x.shape[0]} rows are not whole "
                         f"{img_h}x{img_w} images")
    if not x.is_cuda:
        return conv3x3_bn_act_plain(x, w, img_h, img_w, a, b, relu, stats)
    _check("conv3x3_bn_act", x, w, a, b, 9 * x.shape[1])
    m, c = x.shape
    n = w.shape[1]
    out, st = _launch("conv3x3_bn_act", "3x3", x, w, a, b, n, stats, m, c,
                      n, img_h, img_w, int(bool(relu)))
    conv3x3_bn_act.launches += 1
    return out, st


conv3x3_bn_act.launches = 0
