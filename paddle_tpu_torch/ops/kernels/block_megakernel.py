"""The ghost-BN identity bottleneck block: the hand-written CUDA kernel and
its plain twin, and the four variants of its microbenchmark.

Replaces the Pallas TPU kernels

  ``bottleneck_block``   ``paddle_tpu/ops/pallas/block_megakernel.py``
                         ``bottleneck_block`` / ``_bottleneck_kernel``
  ``roll_micro_block``   ``benchmarks/megakernel_roll_micro.py``
                         ``block`` / ``_kernel``

with one CUDA source, ``csrc/block_megakernel.cu`` (C entry points
``block_megakernel_f32`` and ``block_megakernel_bf16``, the variant an
argument): tensor-core implicit GEMMs (wgmma; float32 as 3xTF32) over
128-row tiles that cross ghost groups, each tile reporting its
statistics per group segment, and GEMM3 run twice on the activated h2
(statistics, then the residual output) so that its accumulator never
reaches device memory. One block is

  1x1 (Cin->Cm) -> ghost BN + ReLU -> 3x3 (Cm->Cm, pad 1) -> ghost BN +
  ReLU -> 1x1 (Cm->Cin) -> ghost BN -> + x -> ReLU

on NHWC-flat rows, forward only (the TPU kernels have no VJP). Layout,
as the reference's: x [N, H*W, Cin]; w1 [Cin, Cm]; w3 [9, Cm, Cm]
tap-major, tap t = (dy+1)*3 + (dx+1) reading pixel (h+dy, w+dx); w2
[Cm, Cin]; bn1, bn2, bn3 [2, C] float32 rows (gamma, beta). Ghost BN
takes its statistics over each group of ``tile`` consecutive images
(tile*H*W rows), single pass: var = E[h^2] - mean^2, a = gamma *
rsqrt(var + eps), b = beta - mean * a. Products are summed in float32;
in bfloat16 the values are rounded where the reference rounds them and
nowhere else: the 3x3's activated taps, the second activation h2 and the
output (the residual adds x in float32).

The micro's variants, at the shapes its caller gives (the reference's
module constants BS, CIN, CM, SIDE, TILE become arguments):

  ``full``     the block above;
  ``strided``  the same function; the reference builds each dy-trio of
               taps with one strided roll, the CUDA kernel stages each
               dy's window of 128 + 2 rows in shared memory and reads its
               three dx taps from it (``full`` stages one halo slab for
               all nine taps);
  ``nobn``     no statistics: every BN is the affine x * p[0] + p[1];
  ``noroll``   wrong on purpose: every tap is relu(acc1 * a1 + b1) of
               its own row, unshifted and unmasked (the cost of the
               shifts and masks is full - noroll).

What is not carried over: the reference's Cin and Cm multiple-of-128
rule (a TPU lane-layout artefact; every width is taken here, Cm 64
included). Its other checks stay, as ValueError: N a multiple of the
tile, H*W equal to h_img * w_img.

Every wrapper takes its kernel for CUDA tensors — there is no fallback:
an input the kernel cannot take raises, and so does a failed build or
launch — its plain twin for CPU tensors, and a shape-only path for
tensors on the "meta" device.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

_SOURCE = "block_megakernel.cu"
EPS = 1e-5
#: the micro's variants, in the reference's order (and the C enum's)
VARIANTS = ("full", "strided", "nobn", "noroll")
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


# -- plain twins ------------------------------------------------------------

def _ghost_bn(h, p, eps, relu, stats=True):
    """h [G, M, C] float32 -> h*a + b (then ReLU), a and b from the
    single-pass statistics of each group (or a = p[0], b = p[1])."""
    p = p.float()
    if stats:
        mean = h.mean(dim=1, keepdim=True)
        var = (h * h).mean(dim=1, keepdim=True) - mean * mean
        a = p[0] * torch.rsqrt(var + eps)
        b = p[1] - mean * a
    else:
        a, b = p[0], p[1]
    y = h * a + b
    return torch.clamp_min(y, 0.0) if relu else y


def _rounded(t, dtype):
    """t rounded to dtype (round to nearest even) and back to float32."""
    return t.to(dtype).float()


def _block_plain(x, w1, w3, w2, p1, p2, p3, h_img, w_img, tile, eps,
                 variant):
    n, hw, cin = x.shape
    cm = w1.shape[1]
    dt = x.dtype
    g = n // tile
    stats = variant != "nobn"
    xg = x.reshape(g, tile * hw, cin).float()
    h1 = _ghost_bn(xg @ w1.float(), p1, eps, True, stats)
    w3f = w3.float()
    if variant == "noroll":
        # each dy-trio reads relu(acc1*a1 + b1) of the row itself, three
        # times, unshifted and unmasked
        tap = _rounded(h1, dt).repeat(1, 1, 9)
        acc2 = tap @ w3f.reshape(9 * cm, cm)
    else:
        img = h1.reshape(n, h_img, w_img, cm)
        padded = F.pad(img, (0, 0, 1, 1, 1, 1))
        acc2 = torch.zeros(n, h_img, w_img, cm, dtype=torch.float32,
                           device=x.device)
        for t in range(9):
            dy, dx = t // 3, t % 3
            tap = padded[:, dy:dy + h_img, dx:dx + w_img, :]
            acc2 = acc2 + _rounded(tap, dt) @ w3f[t]
        acc2 = acc2.reshape(g, tile * hw, cm)
    h2 = _rounded(_ghost_bn(acc2, p2, eps, True, stats), dt)
    y = _ghost_bn(h2 @ w2.float(), p3, eps, False, stats) + xg
    return torch.clamp_min(y, 0.0).to(dt).reshape(n, hw, cin)


def bottleneck_block_plain(x, w1, w3, w2, bn1, bn2, bn3, h_img, w_img,
                           tile=2, eps=EPS):
    """The reference's ``bottleneck_block_reference`` in torch: ghost BN
    per group of ``tile`` images, float32 sums, rounding to x.dtype at
    the reference's points. Returns y [N, H*W, Cin] in x.dtype."""
    _check_shapes("bottleneck_block", x, w1, w3, w2, h_img, w_img, tile)
    return _block_plain(x, w1, w3, w2, bn1, bn2, bn3, h_img, w_img, tile,
                        eps, "full")


def roll_micro_block_plain(x, w1, w3, w2, p1, p2, p3, variant, side, tile):
    """The micro's ``_kernel`` in torch, on x [N*side*side, Cin] as the
    micro lays it out: ``full`` and ``strided`` are
    bottleneck_block_plain, ``nobn`` and ``noroll`` the ablations the
    module docstring names."""
    x3 = _micro_view(x, w1, w3, w2, variant, side, tile)
    return _block_plain(x3, w1, w3, w2, p1, p2, p3, side, side, tile, EPS,
                        variant).reshape(x.shape)


# -- the kernel -------------------------------------------------------------

def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the library's C functions."""
    for dt in _DTYPES.values():
        fn = getattr(lib, f"block_megakernel_{dt}")
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.block_megakernel_workspace.argtypes = [ctypes.c_int] * 5
    lib.block_megakernel_workspace.restype = ctypes.c_longlong
    lib.block_megakernel_error_string.argtypes = [ctypes.c_int]
    lib.block_megakernel_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    lib = build.library(_SOURCE)
    if not getattr(lib, "_paddle_bound", False):
        bind(lib)
        lib._paddle_bound = True
    return lib


def _check_shapes(who, x, w1, w3, w2, h_img, w_img, tile):
    """The reference's checks (ValueError) and the shapes of the
    weights."""
    if x.ndim != 3:
        raise ValueError(f"{who}: x must be [N, H*W, Cin], got "
                         f"{tuple(x.shape)}")
    n, hw, cin = x.shape
    if h_img < 1 or w_img < 1 or hw != h_img * w_img:
        raise ValueError(f"{who}: {hw} rows an image are not "
                         f"{h_img}x{w_img}")
    if tile < 1 or n < 1 or n % tile:
        raise ValueError(f"{who}: {n} images are not whole tiles of "
                         f"{tile}")
    cm = w1.shape[1] if w1.ndim == 2 else -1
    if tuple(w1.shape) != (cin, cm) or tuple(w3.shape) != (9, cm, cm) or \
            tuple(w2.shape) != (cm, cin) or cm < 1:
        raise ValueError(f"{who}: weights must be w1 [Cin, Cm], w3 [9, Cm, "
                         f"Cm], w2 [Cm, Cin] with Cin {cin}, got "
                         f"{tuple(w1.shape)}, {tuple(w3.shape)}, "
                         f"{tuple(w2.shape)}")


def _micro_view(x, w1, w3, w2, variant, side, tile):
    if variant not in VARIANTS:
        raise ValueError(f"roll_micro_block: variant must be one of "
                         f"{VARIANTS}, got {variant!r}")
    hw = side * side
    if x.ndim != 2 or side < 1 or x.shape[0] % hw:
        raise ValueError(f"roll_micro_block: x must be [N*{hw}, Cin], got "
                         f"{tuple(x.shape)}")
    x3 = x.reshape(x.shape[0] // hw, hw, x.shape[1])
    _check_shapes("roll_micro_block", x3, w1, w3, w2, side, side, tile)
    return x3


def _launch(who, x, w1, w3, w2, p1, p2, p3, h_img, w_img, tile, eps,
            variant):
    """Allocate y and the workspace, run the C entry point of x's dtype on
    the current stream, raise on its error."""
    dt = _DTYPES.get(x.dtype)
    if dt is None:
        raise ValueError(f"{who}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    n, hw, cin = x.shape
    cm = w1.shape[1]
    if n // tile >= 65536 or n * hw * max(cin, 9 * cm) >= 2 ** 31 - 1 or \
            9 * cm * cm >= 2 ** 31 - 1:
        raise ValueError(f"{who}: an extent exceeds the kernel's grid or "
                         "int32 sizes")
    for name, t in (("w1", w1), ("w3", w3), ("w2", w2)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{who}: {name} must be {x.dtype} on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    ps = []
    for name, p, c in (("bn1", p1, cm), ("bn2", p2, cm), ("bn3", p3, cin)):
        if p.device != x.device or tuple(p.shape) != (2, c):
            raise ValueError(f"{who}: {name} must be [2, {c}] on "
                             f"{x.device}, got {tuple(p.shape)} on "
                             f"{p.device}")
        ps.append(p.to(torch.float32).contiguous())
    x, w1, w3, w2 = (t.contiguous() for t in (x, w1, w3, w2))
    lib = _library()
    y = torch.empty_like(x)
    ws = torch.empty(lib.block_megakernel_workspace(n, hw, cin, cm, tile),
                     dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"block_megakernel_{dt}")(
            x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            *(p.data_ptr() for p in ps), y.data_ptr(), ws.data_ptr(),
            n, h_img, w_img, cin, cm, tile, eps, VARIANTS.index(variant),
            stream)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: "
                           f"{lib.block_megakernel_error_string(err).decode()}")
    return y


def bottleneck_block(x, w1, w3, w2, bn1, bn2, bn3, h_img, w_img, tile=2,
                     eps=EPS):
    """Fused identity bottleneck block forward with ghost-BN training
    statistics: y [N, H*W, Cin] in x.dtype. CUDA tensors run the kernel
    (x and the weights float32 or bfloat16, one dtype; anything else
    raises), CPU tensors bottleneck_block_plain, meta tensors the shape."""
    if not x.is_cuda and x.device.type != "meta":
        return bottleneck_block_plain(x, w1, w3, w2, bn1, bn2, bn3, h_img,
                                      w_img, tile, eps)
    _check_shapes("bottleneck_block", x, w1, w3, w2, h_img, w_img, tile)
    if x.device.type == "meta":
        return torch.empty_like(x)
    y = _launch("bottleneck_block", x, w1, w3, w2, bn1, bn2, bn3, h_img,
                w_img, tile, eps, "full")
    bottleneck_block.launches += 1
    return y


#: kernel launches since the count was last set to 0 (one per call of the
#: C function; the plain and meta paths do not count)
bottleneck_block.launches = 0


def roll_micro_block(x, w1, w3, w2, p1, p2, p3, variant, side, tile):
    """One block of the micro's ``variant`` on x [N*side*side, Cin]; the
    result has x's shape and dtype. CUDA tensors run the kernel (as
    bottleneck_block), CPU tensors roll_micro_block_plain, meta tensors
    the shape."""
    if not x.is_cuda and x.device.type != "meta":
        return roll_micro_block_plain(x, w1, w3, w2, p1, p2, p3, variant,
                                      side, tile)
    x3 = _micro_view(x, w1, w3, w2, variant, side, tile)
    if x.device.type == "meta":
        return torch.empty_like(x)
    y = _launch("roll_micro_block", x3, w1, w3, w2, p1, p2, p3, side, side,
                tile, EPS, variant)
    roll_micro_block.launches += 1
    return y.reshape(x.shape)


roll_micro_block.launches = 0
