"""Flash attention: the hand-written CUDA kernels and their plain twins.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas/
flash_attention.py``:

  ``flash_attention_fwd``       ``_fwd`` / ``_fwd_kernel``
                                (csrc/flash_attention_fwd.cu)
  ``flash_attention_bwd_dq``    ``_bwd`` / ``_dq_kernel``, with the
                                optional exact bias gradient
                                (csrc/flash_attention_bwd.cu)
  ``flash_attention_bwd_dkv``   ``_bwd`` / ``_dkv_kernel``
                                (csrc/flash_attention_bwd.cu)

Each CUDA source's header says what bounds it on an H100 and how the
design answers that. Each kernel has a float32 and a bfloat16 entry
point, as the Pallas kernels take either dtype. In float32 all three run
their products on the tensor cores in 3xTF32; each call first packs its
B operands into TF32 hi/lo planes, in a scratch buffer the wrapper
allocates (``torch.empty``, sized by the library's ``*_scratch_bytes``).
In bfloat16 they run one bf16 pass a k-step with float32 accumulators,
round P and dS to bf16 before the products that take them, as the
Pallas kernels do, and write O, dq, dk and dv in bf16; softmax
statistics, lse and delta stay float32 and the bias is read as float32.
The bf16 entry points count their launches under their own names
(``flash_attention_fwd_bf16``, ``flash_attention_bwd_dq_bf16``,
``flash_attention_bwd_dkv_bf16``).
``flash_attention_bwd`` runs the whole backward (delta = rowsum(dO * O)
in torch, as the JAX package computes it outside its kernels, then both
kernels); ``FlashAttention`` is the torch.autograd.Function over the
pair, the counterpart of the JAX package's ``jax.custom_vjp``, and
``flash_attention`` applies it.

Every wrapper takes its kernel for CUDA tensors — there is no fallback:
a CUDA input a kernel cannot take raises, and so does a failed build or
launch — and its plain torch twin for tensors that do not lie on a card
(the CPU tests, and the build-time shape trace on "meta").
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
_BWD_SOURCE = "flash_attention_bwd.cu"


def _bias_4d(bias: torch.Tensor) -> torch.Tensor:
    if bias.ndim == 2:        # [Sq|1, Sk|1]
        return bias[None, None]
    if bias.ndim == 3:        # [B|1, Sq|1, Sk|1]
        return bias[:, None]
    return bias


def _rounded(x, dtype):
    """x rounded to `dtype` and back: the Pallas kernels cast P and dS to
    their product partner's dtype (bf16) before the product, and sum
    the exact products in float32. A no-op for float32 and float64."""
    return x.to(dtype).to(x.dtype) if dtype == torch.bfloat16 else x


def flash_attention_fwd_plain(q, k, v, bias=None, causal: bool = False,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Straightforward torch composition with the kernel's semantics:
    returns (O [B,H,Sq,D] in q's dtype, lse [B,H,Sq] in float32, float64
    for float64 inputs), computed in float32 (float64). bias is additive
    and broadcastable to [B,H,Sq,Sk]; causal masks kpos > qpos with
    NEG_INF; a row whose probabilities all vanish gives O = 0. For bf16
    inputs P = exp(s - m) is rounded to bf16 before P.V, as the Pallas
    kernel rounds it (its m is the running max of its key blocks, this
    one the row's: the two roundings differ, see bf16_limits)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, bias, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(_rounded(p, v.dtype), v.to(s.dtype)) / torch.where(
        l == 0, torch.ones_like(l), l)
    lse = (m + torch.log(torch.clamp(l, min=1e-37))).squeeze(-1)
    return o.to(q.dtype), lse


def _scores(q, k, bias, causal, sm_scale):
    """Masked scaled scores [B,H,Sq,Sk], in the reference's order: scale,
    add the bias, then NEG_INF where kpos > qpos under causal."""
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + _bias_4d(bias).to(ct)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        qpos = torch.arange(sq, device=s.device)[:, None]
        kpos = torch.arange(sk, device=s.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
    return s


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument and result types of the forward library's C entry points
    (the built one, or any library with the same interface)."""
    if not getattr(lib, "_paddle_bound", False):
        for kind in _KINDS.values():
            fn = getattr(lib, f"flash_attention_fwd_{kind}")
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 4
                           + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fn = getattr(lib, _scratch_fn("flash_attention_fwd", kind))
            fn.argtypes = [ctypes.c_int] * 5
            fn.restype = ctypes.c_longlong
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._paddle_bound = True
    return lib


def _library() -> ctypes.CDLL:
    return bind(build.library(_SOURCE))


# the C entry points' suffix for each input dtype
_KINDS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _scratch_fn(name, kind):
    """The C function that sizes `name`'s scratch for `kind` ("f32" or
    "bf16")."""
    return f"{name}_scratch_bytes" if kind == "f32" else \
        f"{name}_bf16_scratch_bytes"


def _scratch(nbytes, device):
    """The packed operand planes of one call (the kernels' pack step
    writes them): uninitialized bytes."""
    return torch.empty(int(nbytes), dtype=torch.uint8, device=device)


def _check_inputs(q, k, v, bias, who="flash_attention_fwd"):
    if q.dtype not in _KINDS:
        raise TypeError(f"{who}: q is {q.dtype}; the kernels take "
                        "float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{who}: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{who}: {name} is {t.dtype}, q {q.dtype}; "
                            "the kernels take q, k and v of one dtype")
        if t.ndim != 4:
            raise ValueError(f"{who}: {name} must be "
                             f"[B,H,S,D], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be "
                             "contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{who}: bf16 {name} must start 16-byte "
                             "aligned (the kernels copy it with cp.async)")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d):
        raise ValueError(f"{who}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{who}: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if sq < 1 or sk < 1 or b * h > 65535:
        raise ValueError(f"{who}: unsupported sizes B*H="
                         f"{b * h}, Sq={sq}, Sk={sk}")
    if bias is not None:
        if bias.device != q.device or bias.dtype != torch.float32:
            raise TypeError(f"{who}: bias must be float32 on "
                            f"{q.device}, got {bias.dtype} on {bias.device}")
        if bias.ndim not in (2, 3, 4):
            raise ValueError(f"{who}: bias must have 2-4 dims")


def _bias_strides(bias, shape, who):
    """The bias as a [B,H,Sq,Sk] view with stride 0 on its broadcast dims
    (never expanded in memory), and its four strides; (None, zeros)
    without a bias."""
    if bias is None:
        return None, (0, 0, 0, 0)
    bias4 = _bias_4d(bias)
    try:
        bias = bias4.expand(*shape)
    except RuntimeError as e:
        raise ValueError(f"{who}: bias {tuple(bias4.shape)} does not "
                         f"broadcast to {tuple(shape)}") from e
    return bias, bias.stride()


def flash_attention_fwd(q, k, v, bias=None, causal: bool = False,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax attention forward: (O [B,H,Sq,D] in q's dtype, lse
    [B,H,Sq] float32).

    q: [B,H,Sq,D]; k, v: [B,H,Sk,D]; bias additive (float32) with any dim
    broadcast (size 1); causal adds the qpos >= kpos mask; sm_scale
    defaults to 1/sqrt(D). CUDA tensors run the hand-written kernel
    (float32 or, through flash_attention_fwd_bf16, bfloat16; contiguous,
    D in SUPPORTED_HEAD_DIMS — anything else raises); other tensors run
    flash_attention_fwd_plain."""
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v, bias, causal, sm_scale)
    if q.dtype == torch.bfloat16:
        return flash_attention_fwd_bf16(q, k, v, bias, causal, sm_scale)
    o, lse = _launch_fwd(q, k, v, bias, causal, sm_scale,
                         "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd_bf16(q, k, v, bias=None, causal: bool = False,
                             sm_scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flash_attention_fwd's bfloat16 kernel (its own launch count): bf16
    q, k, v on a card (anything else there raises); other tensors run
    flash_attention_fwd_plain."""
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v, bias, causal, sm_scale)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_fwd_bf16: q is {q.dtype}")
    o, lse = _launch_fwd(q, k, v, bias, causal, sm_scale,
                         "flash_attention_fwd_bf16")
    flash_attention_fwd_bf16.launches += 1
    return o, lse


def _launch_fwd(q, k, v, bias, causal, sm_scale, who):
    _check_inputs(q, k, v, bias, who)
    kind = _KINDS[q.dtype]
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bias, strides = _bias_strides(bias, (b, h, sq, sk), who)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _library()
    scratch = _scratch(getattr(lib, _scratch_fn("flash_attention_fwd", kind))(
        b, h, sq, sk, d), q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"flash_attention_fwd_{kind}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            o.data_ptr(), lse.data_ptr(), scratch.data_ptr(), b, h, sq, sk,
            d, *strides, int(bool(causal)), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(
            f"{who} kernel launch failed: "
            f"{lib.flash_attention_error_string(err).decode()}")
    return o, lse


#: kernel launches since the count was last set to 0 (the wrapper adds
#: one per launch and nowhere else; the plain path does not count)
flash_attention_fwd.launches = 0
flash_attention_fwd_bf16.launches = 0


# -- backward ---------------------------------------------------------------

def _delta(o, do):
    """rowsum(dO * O) [B,H,Sq]: the reference computes it outside its
    kernels too (flash_attention.py _bwd), and so does the port."""
    ct = torch.float64 if o.dtype == torch.float64 else torch.float32
    return (do.to(ct) * o.to(ct)).sum(-1)


def _probs(q, k, bias, lse, causal, sm_scale):
    """p = exp(s - lse), the softmax rebuilt from the forward's lse."""
    s = _scores(q, k, bias, causal, sm_scale)
    return torch.exp(s - lse.to(s.dtype)[..., None])


def flash_attention_bwd_dq_plain(q, k, v, bias, do, lse, delta,
                                 causal: bool = False,
                                 sm_scale: Optional[float] = None,
                                 bias_grad: bool = False):
    """Dense twin of the dq kernel: (dq [B,H,Sq,D], ds [B,H,Sq,Sk] or
    None). ds = p * (dO v^T - delta) is the exact gradient of a full
    [B,H,Sq,Sk] bias (float32, also for bf16 inputs); it is returned only
    with bias_grad. For bf16 inputs ds is rounded to bf16 before dS.K."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, bias, lse, causal, sm_scale)
    dp = torch.matmul(do.to(p.dtype), v.to(p.dtype).transpose(-1, -2))
    ds = p * (dp - delta.to(p.dtype)[..., None])
    dq = sm_scale * torch.matmul(_rounded(ds, k.dtype), k.to(p.dtype))
    return dq.to(q.dtype), (ds if bias_grad else None)


def flash_attention_bwd_dkv_plain(q, k, v, bias, do, lse, delta,
                                  causal: bool = False,
                                  sm_scale: Optional[float] = None):
    """Dense twin of the dk/dv kernel: dv = p^T dO, dk = scale ds^T q
    (for bf16 inputs p and ds rounded to bf16 before their products)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, bias, lse, causal, sm_scale)
    dof = do.to(p.dtype)
    dv = torch.matmul(_rounded(p, do.dtype).transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.to(p.dtype).transpose(-1, -2))
    ds = p * (dp - delta.to(p.dtype)[..., None])
    dk = sm_scale * torch.matmul(_rounded(ds, q.dtype).transpose(-1, -2),
                                 q.to(p.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


def bf16_spacing(x):
    """The spacing of bfloat16 values at |x| (0 at 0), float64."""
    x = x.double()
    mant, exp = torch.frexp(x)
    return torch.where(mant == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), exp - 8))


def bf16_limits(q, k, v, bias, do, lse, delta, causal: bool = False,
                sm_scale: Optional[float] = None, rounding: bool = True):
    """How far two bf16 results of the flash functions may sit apart, per
    element, in float64, one bf16 ulp of the output (bf16_spacing, added
    by the caller) short: {"o", "dq", "dk", "dv"}.

    Each holds 1e-5 of the output's sum of |terms| (O: sum_k p_k |v_kd| /
    l; dq: scale sum_k |ds|_k |k_kd|; dk: scale sum_q |ds|_qk |q_qd|; dv:
    sum_q p_qk |dO_qd|), for two float32 sums of the same products in
    another order, where |ds| = p (sum_e |dO_e| |v_ke| + |delta|): ds =
    p (dp - delta) is a difference of nearly equal terms where a row's p
    sits on one key (a causal row 0: ds is rounding noise about 0), so
    its float32 error scales with those terms, not with ds.

    With `rounding`, each also holds the rounding of the operand its
    product takes in bf16, one bf16 ulp of it per term (sum_k ulp(ds_k)
    |k_kd| for dq, and so on): a CUDA kernel and its twin compute p and
    ds in another order, so one may round a value on a rounding boundary
    to the other neighbour. For O it is 1.5 ulps of p: the CUDA kernel
    rounds exp(s - m) at the running max m of its key tiles, the twin at
    the row's, a factor that is no power of two, so each rounding may
    land up to half an ulp of its own scale away."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v, do = (t.double() for t in (q, k, v, do))
    bias = None if bias is None else bias.double()
    r = 1.0 if rounding else 0.0
    s = _scores(q, k, bias, causal, sm_scale)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    av = v.abs()
    out = {"o": torch.matmul(1e-5 * e + 1.5 * r * bf16_spacing(e), av) / l}
    p = torch.exp(s - lse.double()[..., None])
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - delta.double()[..., None])
    ds_terms = p * (torch.matmul(do.abs(), av.transpose(-1, -2))
                    + delta.double().abs()[..., None])
    ds_w = 1e-5 * ds_terms + r * bf16_spacing(ds)
    out["dq"] = sm_scale * torch.matmul(ds_w, k.abs())
    out["dk"] = sm_scale * torch.matmul(ds_w.transpose(-1, -2), q.abs())
    out["dv"] = torch.matmul((1e-5 * p + r * bf16_spacing(p))
                             .transpose(-1, -2), do.abs())
    return out


def _reduce_dbias(ds, bias):
    """Sum the full-shape bias gradient over every broadcast dim of the
    original bias, back to its shape and dtype (reference _bwd:386-393)."""
    bias4 = _bias_4d(bias)
    for ax in range(4):
        if bias4.shape[ax] == 1 and ds.shape[ax] != 1:
            ds = ds.sum(dim=ax, keepdim=True)
    return ds.reshape(bias.shape).to(bias.dtype)


def flash_attention_bwd_plain(q, k, v, bias, o, lse, do,
                              causal: bool = False,
                              sm_scale: Optional[float] = None,
                              bias_grad: bool = False):
    """The dense flash-attention-2 backward in torch: p = exp(s - lse),
    dv = p^T dO, dp = dO v^T, ds = p (dp - delta), dq = scale ds k,
    dk = scale ds^T q. Returns (dq, dk, dv, dbias or None); dbias is the
    exact bias gradient, summed over its broadcast dims, with bias_grad
    and a bias."""
    delta = _delta(o, do)
    want = bias_grad and bias is not None
    dq, ds = flash_attention_bwd_dq_plain(q, k, v, bias, do, lse, delta,
                                          causal, sm_scale, want)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, bias, do, lse, delta,
                                           causal, sm_scale)
    return dq, dk, dv, (_reduce_dbias(ds, bias) if want else None)


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument and result types of the backward library's C entry points
    (the built one, or any library with the same interface)."""
    if not getattr(lib, "_paddle_bound", False):
        tail = ([ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
                + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        for which in ("dq", "dkv"):
            for kind in _KINDS.values():
                fn = getattr(lib, f"flash_attention_bwd_{which}_{kind}")
                fn.argtypes = [ctypes.c_void_p] * 10 + tail
                fn.restype = ctypes.c_int
                fn = getattr(lib, _scratch_fn(f"flash_attention_bwd_{which}",
                                              kind))
                fn.argtypes = [ctypes.c_int] * 5
                fn.restype = ctypes.c_longlong
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        lib._paddle_bound = True
    return lib


def _bwd_library() -> ctypes.CDLL:
    return bind_bwd(build.library(_BWD_SOURCE))


def _check_bwd_inputs(q, k, v, bias, do, lse, delta, who):
    _check_inputs(q, k, v, bias, who)
    if do.shape != q.shape or do.dtype != q.dtype or \
            do.device != q.device or not do.is_contiguous() or \
            (do.dtype == torch.bfloat16 and do.data_ptr() % 16):
        raise ValueError(f"{who}: dO must be a contiguous (bf16: 16-byte "
                         f"aligned) {q.dtype} "
                         f"{tuple(q.shape)} tensor on {q.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != tuple(q.shape[:3]) or \
                t.dtype != torch.float32 or t.device != q.device or \
                not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous float32 "
                             f"{tuple(q.shape[:3])} tensor on {q.device}")


def _launch_bwd(name, q, k, v, bias, do, lse, delta, out1, out2, causal,
                sm_scale):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kind = _KINDS[q.dtype]
    bias, strides = _bias_strides(bias, (b, h, sq, sk), name)
    lib = _bwd_library()
    # each kernel packs its B operands (dq: K and V; dk/dv: Q and dO) into
    # a scratch of its own, held here until the launch returns
    scratch = _scratch(getattr(lib, _scratch_fn(name, kind))(b, h, sq, sk, d),
                       q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"{name}_{kind}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), out1.data_ptr(),
            out2.data_ptr() if out2 is not None else None,
            scratch.data_ptr(), b, h, sq, sk, d, *strides,
            int(bool(causal)), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(
            f"{name}{'' if kind == 'f32' else '_bf16'} kernel launch failed: "
            f"{lib.flash_attention_bwd_error_string(err).decode()}")


def flash_attention_bwd_dq(q, k, v, bias, do, lse, delta,
                           causal: bool = False,
                           sm_scale: Optional[float] = None,
                           bias_grad: bool = False):
    """dq [B,H,Sq,D] and, with bias_grad and a bias, the full-shape bias
    gradient ds [B,H,Sq,Sk] float32 (zero on causally skipped tiles), from
    the forward's lse and delta = rowsum(dO * O), both [B,H,Sq] float32.
    CUDA tensors run the dq kernel (float32 or, through
    flash_attention_bwd_dq_bf16, bfloat16; contiguous, D in
    SUPPORTED_HEAD_DIMS — anything else raises); other tensors run
    flash_attention_bwd_dq_plain."""
    if not q.is_cuda:
        return flash_attention_bwd_dq_plain(q, k, v, bias, do, lse, delta,
                                            causal, sm_scale, bias_grad)
    if q.dtype == torch.bfloat16:
        return flash_attention_bwd_dq_bf16(q, k, v, bias, do, lse, delta,
                                           causal, sm_scale, bias_grad)
    out = _dq(q, k, v, bias, do, lse, delta, causal, sm_scale, bias_grad,
              "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return out


def flash_attention_bwd_dq_bf16(q, k, v, bias, do, lse, delta,
                                causal: bool = False,
                                sm_scale: Optional[float] = None,
                                bias_grad: bool = False):
    """flash_attention_bwd_dq's bfloat16 kernel (its own launch count):
    bf16 q, k, v and dO on a card (anything else there raises); other
    tensors run flash_attention_bwd_dq_plain."""
    if not q.is_cuda:
        return flash_attention_bwd_dq_plain(q, k, v, bias, do, lse, delta,
                                            causal, sm_scale, bias_grad)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_bwd_dq_bf16: q is {q.dtype}")
    out = _dq(q, k, v, bias, do, lse, delta, causal, sm_scale, bias_grad,
              "flash_attention_bwd_dq_bf16")
    flash_attention_bwd_dq_bf16.launches += 1
    return out


def _dq(q, k, v, bias, do, lse, delta, causal, sm_scale, bias_grad, who):
    _check_bwd_inputs(q, k, v, bias, do, lse, delta, who)
    b, h, sq, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dq = torch.empty_like(q)
    ds = None
    if bias_grad and bias is not None:
        ds = torch.zeros((b, h, sq, k.shape[2]), dtype=torch.float32,
                         device=q.device)
    _launch_bwd("flash_attention_bwd_dq", q, k, v, bias, do, lse, delta, dq,
                ds, causal, sm_scale)
    return dq, ds


def flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta,
                            causal: bool = False,
                            sm_scale: Optional[float] = None):
    """(dk, dv) [B,H,Sk,D] from the forward's lse and delta. CUDA tensors
    run the dk/dv kernel (same conditions as flash_attention_bwd_dq;
    bfloat16 through flash_attention_bwd_dkv_bf16); other tensors run
    flash_attention_bwd_dkv_plain."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_plain(q, k, v, bias, do, lse, delta,
                                             causal, sm_scale)
    if q.dtype == torch.bfloat16:
        return flash_attention_bwd_dkv_bf16(q, k, v, bias, do, lse, delta,
                                            causal, sm_scale)
    out = _dkv(q, k, v, bias, do, lse, delta, causal, sm_scale,
               "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return out


def flash_attention_bwd_dkv_bf16(q, k, v, bias, do, lse, delta,
                                 causal: bool = False,
                                 sm_scale: Optional[float] = None):
    """flash_attention_bwd_dkv's bfloat16 kernel (its own launch count):
    bf16 q, k, v and dO on a card (anything else there raises); other
    tensors run flash_attention_bwd_dkv_plain."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_plain(q, k, v, bias, do, lse, delta,
                                             causal, sm_scale)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_bwd_dkv_bf16: q is {q.dtype}")
    out = _dkv(q, k, v, bias, do, lse, delta, causal, sm_scale,
               "flash_attention_bwd_dkv_bf16")
    flash_attention_bwd_dkv_bf16.launches += 1
    return out


def _dkv(q, k, v, bias, do, lse, delta, causal, sm_scale, who):
    _check_bwd_inputs(q, k, v, bias, do, lse, delta, who)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_attention_bwd_dkv", q, k, v, bias, do, lse, delta,
                dk, dv, causal, sm_scale)
    return dk, dv


def flash_attention_bwd(q, k, v, bias, o, lse, do, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        bias_grad: bool = False):
    """The flash-attention backward: (dq, dk, dv, dbias or None) for the
    forward (q, k, v, bias) -> (o, lse) and the output cotangent do.
    delta = rowsum(dO * O) is a torch reduction; the dq and dk/dv
    kernels do the rest. With bias_grad and a bias, dbias is the exact
    gradient, summed over the bias's broadcast dims; otherwise None.
    Tensors that do not lie on a card take flash_attention_bwd_plain."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, bias, o, lse, do, causal,
                                         sm_scale, bias_grad)
    delta = _delta(o, do).contiguous()
    want = bias_grad and bias is not None
    dq, ds = flash_attention_bwd_dq(q, k, v, bias, do, lse, delta, causal,
                                    sm_scale, want)
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta, causal,
                                     sm_scale)
    return dq, dk, dv, (_reduce_dbias(ds, bias) if want else None)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward kernels — the counterpart of the
    reference's ``jax.custom_vjp`` around ``_flash``. forward saves q, k,
    v, bias, O and lse; backward returns dq, dk, dv and, for a bias that
    needs a gradient, its exact gradient with bias_grad, else zeros (a
    constant mask, as the reference treats it)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale, bias_grad):
        o, lse = flash_attention_fwd(q, k, v, bias, causal, sm_scale)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.sm_scale, ctx.bias_grad = causal, sm_scale, bias_grad
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        want_bias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = flash_attention_bwd(
            q, k, v, bias, o, lse, do.contiguous(), ctx.causal,
            ctx.sm_scale, ctx.bias_grad and want_bias)
        if want_bias and dbias is None:
            dbias = torch.zeros_like(bias)
        return dq, dk, dv, dbias, None, None, None


def flash_attention(q, k, v, bias=None, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    bias_grad: bool = False):
    """Differentiable flash attention [B,H,Sq,D] (see FlashAttention).
    q, k, v must be contiguous for the CUDA kernels."""
    return FlashAttention.apply(q, k, v, bias, bool(causal), sm_scale,
                                bool(bias_grad))


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq_bf16.launches = 0
flash_attention_bwd_dkv_bf16.launches = 0
