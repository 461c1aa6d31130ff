"""NN ops: conv2d, pool2d, batch_norm, layer_norm, lrn, dropout,
cross_entropy, softmax_with_cross_entropy, lookup_table, one_hot,
scaled_dot_product_attention.

The port's compute rules for the ``paddle_tpu/ops/nn_ops.py`` ops its
models' train steps run. conv2d runs through torch's convolution (cuDNN
on a card, TF32 off): the JAX package leaves conv to XLA and writes no
kernel for it, and the fused conv + BN kernels of its Pallas library
(ops/kernels/fused_conv.py here) are dispatched by no op, in either
package. batch_norm keeps the reference's default path, left to
autodiff; its PADDLE_TPU_BN_CUSTOM_VJP arm is not ported.
scaled_dot_product_attention keeps the reference's routing: the
`use_flash` attr when stamped, else the min-seq auto policy — with "the
tensor lies on a CUDA card" in place of "the backend is a TPU". The
flash route runs the hand-written CUDA kernels through their
torch.autograd.Function (ops/kernels/flash_attention.py), so a
``__vjp__`` replay of the op reaches the backward kernels; the naive
route is the matmul/softmax composition. The sequence-parallel branch
waits for a mesh. softmax_with_cross_entropy ports the reference's
default path; its PADDLE_TPU_FUSED_XENT streaming variant is not ported.
conv2d_transpose, depthwise and 3-D convs and the other pools wait for
later slices (conv2d_transpose takes conv2d's AMP cast with it, as the
reference's _conv_transpose_impl does).

Under AMP (amp.py) conv2d takes bf16 operands and its output stays bf16,
as the reference's; every other rule here keeps the reference's dtypes
as they are: pool2d averages a bf16 input in float32 and returns bf16;
batch_norm and layer_norm normalize in float32 with float32 statistics
and return the input's dtype; lrn computes in its input's dtype (a bf16
input stays bf16, each op rounded); dropout returns its input's dtype; the
cross-entropy losses compute in float32; lookup_table returns its
table's dtype; the naive attention promotes as jnp.einsum does (a bf16
score plus a float32 mask is float32).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import flags
from ..amp import amp_cast
from ..core.registry import register_op
from .kernels.flash_attention import NEG_INF, flash_attention


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


# -- convolution ------------------------------------------------------------

def _conv2d_impl(x, w, strides, paddings, dilations, groups):
    """NCHW conv, as the reference's _conv2d_impl: a strided 1x1 conv with
    no padding slices its input first and convolves at stride 1 (the same
    values; the gradient work then matches the reference's). Under
    PADDLE_TPU_CONV_LAYOUT=nhwc it runs on channels_last copies. Under
    AMP both operands drop to bf16 and the output stays bf16 (cuDNN
    accumulates in float32)."""
    if (tuple(w.shape[2:]) == (1, 1) and tuple(paddings) == (0, 0)
            and (strides[0] > 1 or strides[1] > 1) and groups == 1):
        x = x[:, :, ::strides[0], ::strides[1]]
        strides = (1, 1)
    x, w = amp_cast(x, w)
    if flags.get("PADDLE_TPU_CONV_LAYOUT") == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
        w = w.contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, stride=strides, padding=paddings,
                    dilation=dilations, groups=groups)


@register_op("conv2d")
def _conv2d(ctx):
    ctx.set_output("Output", _conv2d_impl(
        ctx.input("Input"), ctx.input("Filter"),
        _pair(ctx.attr("strides", [1, 1])),
        _pair(ctx.attr("paddings", [0, 0])),
        _pair(ctx.attr("dilations", [1, 1])), ctx.attr("groups", 1)))


# -- pooling ----------------------------------------------------------------

@register_op("pool2d")
def _pool2d(ctx):
    """Max or average pooling over NCHW windows with floor output sizes,
    as the reference's reduce_window: max pads with -inf; avg sums over
    zero padding and divides by the window's in-image count ("exclusive",
    the default) or by its full size; global_pooling takes the whole
    image."""
    x = ctx.input("X")
    k = _pair(ctx.attr("ksize", [2, 2]))
    s = _pair(ctx.attr("strides", [2, 2]))
    p = _pair(ctx.attr("paddings", [0, 0]))
    if ctx.attr("global_pooling", False):
        k = (x.shape[2], x.shape[3])
        s = k
        p = (0, 0)
    pad = (p[1], p[1], p[0], p[0])
    if ctx.attr("pooling_type", "max") == "max":
        out = F.max_pool2d(F.pad(x, pad, value=-math.inf), k, s)
    else:
        xf = x.float() if x.dtype == torch.bfloat16 else x
        summed = F.avg_pool2d(F.pad(xf, pad), k, s, divisor_override=1)
        if ctx.attr("exclusive", True) and (p[0] or p[1]):
            ones = torch.ones_like(xf[:1, :1])
            counts = F.avg_pool2d(F.pad(ones, pad), k, s,
                                  divisor_override=1)
            out = (summed / counts).to(x.dtype)
        else:
            out = (summed / (k[0] * k[1])).to(x.dtype)
    ctx.set_output("Out", out)


# -- normalization ----------------------------------------------------------

@register_op("batch_norm")
def _batch_norm(ctx):
    """Inputs X, Scale, Bias, Mean, Variance; outputs Y, MeanOut,
    VarianceOut, SavedMean, SavedVariance (reference: batch_norm_op.cc),
    with the reference's default train path: single-pass float32
    statistics (var = E[x^2] - mean^2, biased — not torch.var, which
    differs where a channel's mean is large), the normalize as the
    per-channel affine x*a + b, running statistics
    Mean*momentum + batch*(1 - momentum), SavedVariance = rsqrt(var +
    eps). is_test normalizes with the running statistics and passes them
    through. A ``__vjp__`` replay writes only its input gradients, so
    the running statistics move once a step."""
    x = ctx.input("X")
    scale = ctx.input("Scale")
    bias = ctx.input("Bias")
    mean_in = ctx.input("Mean")
    var_in = ctx.input("Variance")
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    ch_axis = 1 if ctx.attr("data_layout", "NCHW") == "NCHW" else x.ndim - 1
    red_axes = tuple(i for i in range(x.ndim) if i != ch_axis)
    bshape = [1] * x.ndim
    bshape[ch_axis] = x.shape[ch_axis]
    xf = x.float()

    if ctx.attr("is_test", False):
        a = scale * torch.rsqrt(var_in.float() + eps)
        b = bias - mean_in * a
        ctx.set_output("Y", (xf * a.reshape(bshape)
                             + b.reshape(bshape)).to(x.dtype))
        ctx.set_output("MeanOut", mean_in)
        ctx.set_output("VarianceOut", var_in)
        ctx.set_output("SavedMean", mean_in)
        ctx.set_output("SavedVariance", var_in)
        return

    n = 1
    for i in red_axes:
        n *= x.shape[i]
    mean = torch.sum(xf, dim=red_axes) / n
    var = torch.sum(xf * xf, dim=red_axes) / n - mean * mean
    inv = torch.rsqrt(var + eps)
    a = scale * inv
    b = bias - mean * a
    ctx.set_output("Y", (xf * a.reshape(bshape)
                         + b.reshape(bshape)).to(x.dtype))
    ctx.set_output("MeanOut", mean_in * momentum + mean * (1 - momentum))
    ctx.set_output("VarianceOut", var_in * momentum + var * (1 - momentum))
    ctx.set_output("SavedMean", mean)
    ctx.set_output("SavedVariance", inv)


@register_op("layer_norm")
def _layer_norm(ctx):
    x = ctx.input("X")
    scale = ctx.input("Scale")
    bias = ctx.input("Bias")
    eps = ctx.attr("epsilon", 1e-5)
    begin = ctx.attr("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    xf = x.float()
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.var(xf, dim=axes, keepdim=True, correction=0)
    y = (xf - mean) / torch.sqrt(var + eps)
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    ctx.set_output("Y", y.to(x.dtype))
    ctx.set_output("Mean", mean.reshape(x.shape[:begin]))
    ctx.set_output("Variance", var.reshape(x.shape[:begin]))


@register_op("lrn")
def _lrn(ctx):
    """Cross-channel local response normalization of an NCHW X: Out = X /
    (k + alpha * s)^beta, s the sum of X^2 over the n channels centred on
    each (zeros past the ends), MidOut = k + alpha * s. The op's defaults
    (k 2.0) are the reference op's, not layers.lrn's (k 1.0). No AMP
    cast, as in the reference: every step runs in X's dtype, the window
    summed in the reference's order, and k, alpha and beta rounded to X's
    dtype first, as jnp rounds a Python float meeting a bf16 array; the
    gradient is the generic __vjp__."""
    x = ctx.input("X")
    n = ctx.attr("n", 5)
    k, alpha, beta = (float(torch.tensor(float(ctx.attr(a, d)),
                                         dtype=x.dtype))
                      for a, d in (("k", 2.0), ("alpha", 1e-4),
                                   ("beta", 0.75)))
    half, c = n // 2, x.shape[1]
    pad = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    acc = pad[:, 0:c]
    for i in range(1, n):
        acc = acc + pad[:, i:i + c]
    ctx.set_output("Out", x / torch.pow(k + alpha * acc, beta))
    ctx.set_output("MidOut", k + alpha * acc)


@register_op("dropout", capturable=False)
def _dropout(ctx):
    """Reference dropout_op: keep each element with probability 1 - p.
    The mask comes from an explicit torch.Generator seeded from the op's
    seed attr and the scope's step counter (core/executor.py STEP_VAR),
    so a ``__vjp__`` replay in the same run draws the same mask and a
    run resumed from a checkpoint draws the uninterrupted run's masks. It draws torch's bits, not
    JAX's."""
    x = ctx.input("X")
    prob = ctx.attr("dropout_prob", 0.5)
    if ctx.attr("is_test", False) or prob == 0.0:
        ctx.set_output("Out", x)
        ctx.set_output("Mask", torch.ones_like(x))
        return
    if x.device.type == "meta":
        ctx.set_output("Out", torch.empty_like(x))
        ctx.set_output("Mask", torch.empty_like(x))
        return
    keep = 1.0 - prob
    g = torch.Generator(device=x.device)
    g.manual_seed(int(ctx.attr("seed", 0) or 0) * 1000003
                  + int(ctx.extra.get("step", 0)))
    mask = torch.rand(x.shape, generator=g, device=x.device) < keep
    if ctx.attr("dropout_implementation",
                "downgrade_in_infer") == "upscale_in_train":
        out = torch.where(mask, x / keep, torch.zeros_like(x))
    else:  # reference default: scale at inference instead
        out = torch.where(mask, x, torch.zeros_like(x))
    ctx.set_output("Out", out.to(x.dtype))
    ctx.set_output("Mask", mask.to(x.dtype))


# -- losses -----------------------------------------------------------------

@register_op("cross_entropy", no_grad_slots=["Label"])
def _cross_entropy(ctx):
    """Y [.., 1] = -log(x[label] + 1e-8) of probabilities X (a softmax's
    output), in float32; soft labels: -sum(label * log(x + 1e-8)). A
    hard label may carry a trailing [.., 1] dim."""
    x = ctx.input("X").float()
    label = ctx.input("Label")
    eps = 1e-8
    if ctx.attr("soft_label", False):
        ctx.set_output("Y", -torch.sum(label * torch.log(x + eps), dim=-1,
                                       keepdim=True))
        return
    lab = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
        else label
    picked = torch.gather(x, -1, lab.long().unsqueeze(-1))
    ctx.set_output("Y", -torch.log(picked + eps))


@register_op("softmax_with_cross_entropy", no_grad_slots=["Label"])
def _softmax_with_cross_entropy(ctx):
    """Loss [.., 1] = -log softmax(logits)[label], computed in float32
    through log_softmax and a gather, and the Softmax output."""
    logits = ctx.input("Logits").float()
    label = ctx.input("Label")
    logp = torch.log_softmax(logits, dim=-1)
    if ctx.attr("soft_label", False):
        ctx.set_output("Softmax", torch.exp(logp))
        ctx.set_output("Loss", -torch.sum(label * logp, dim=-1,
                                          keepdim=True))
        return
    lab = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
        else label
    loss = -torch.gather(logp, -1, lab.long().unsqueeze(-1))
    ctx.set_output("Softmax", torch.softmax(logits, dim=-1))
    ctx.set_output("Loss", loss)


@register_op("sigmoid_cross_entropy_with_logits", no_grad_slots=["Label"])
def _sigmoid_xent(ctx):
    """max(x, 0) - x * label + log1p(exp(-|x|)), elementwise: the
    numerically stable form, as the reference writes it (torch.maximum
    splits the gradient at x = 0 as jnp.maximum does)."""
    x = ctx.input("X")
    label = ctx.input("Label")
    ctx.set_output("Out", torch.maximum(x, torch.zeros_like(x)) - x * label
                   + torch.log1p(torch.exp(-torch.abs(x))))


@register_op("square_error_cost")
def _square_error_cost(ctx):
    ctx.set_output("Out", torch.square(ctx.input("X") - ctx.input("Y")))


@register_op("lookup_table", no_grad_slots=["Ids"])
def _lookup_table(ctx):
    """Embedding lookup. Ids may carry a trailing [.., 1] dim. Out-of-range
    ids clamp to the table's edge rows, as the reference's explicit clip
    does."""
    w = ctx.input("W")
    ids = ctx.input("Ids")
    if ids.ndim and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    padding_idx = ctx.attr("padding_idx", -1)
    idx = ids.long().clamp(0, w.shape[0] - 1)
    out = w[idx]
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    ctx.set_output("Out", out)


@register_op("one_hot", no_grad_slots=["X"])
def _one_hot(ctx):
    """float32 one-hot; an index outside [0, depth) gives an all-zero row,
    as jax.nn.one_hot does."""
    x = ctx.input("X")
    depth = ctx.attr("depth")
    if x.ndim and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    classes = torch.arange(depth, device=x.device)
    ctx.set_output("Out", (x.long().unsqueeze(-1) == classes).float())


def _matmul_promoted(a, b):
    """torch.matmul of the two operands promoted to their common dtype,
    as jnp.einsum promotes (torch.matmul refuses a bf16/float32 pair)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _naive_attention(q, k, v, mask, causal, sm_scale):
    scores = _matmul_promoted(q, k.transpose(-1, -2))
    if sm_scale is None:
        # the reference scales by 1 / np.sqrt(d), a numpy float64 scalar,
        # which promotes bf16 scores to float32 (JAX runs without x64);
        # a `scale` attr is a Python float and keeps their dtype
        if scores.dtype == torch.bfloat16:
            scores = scores.float()
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = scores * sm_scale
    if mask is not None:
        scores = scores + mask
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return _matmul_promoted(probs, v)


@register_op("scaled_dot_product_attention", no_grad_slots=["Mask"])
def _sdpa(ctx):
    """Fused attention. The Mask input is an additive bias broadcastable
    to [B, H, Sq, Sk]; attr `causal` adds the qpos >= kpos mask; attr
    `scale` overrides 1/sqrt(d_key). `seq_axis` (context parallelism)
    needs a mesh, which the port does not have yet, so the op computes
    on one device as the reference does without a mesh. Mask is a
    constant (no_grad_slots) on both routes."""
    q, k, v = ctx.input("Q"), ctx.input("K"), ctx.input("V")
    mask = ctx.input("Mask")
    causal = bool(ctx.attr("causal", False))
    sm_scale = ctx.attr("scale", None)
    sm_scale = None if sm_scale is None else float(sm_scale)

    use_flash = ctx.attr("use_flash", None)
    if use_flash and q.ndim != 4:
        use_flash = False
    if use_flash is None:
        min_seq = int(flags.get("PADDLE_TPU_FLASH_MIN_SEQ"))
        use_flash = (q.is_cuda and q.ndim == 4
                     and q.shape[2] >= min_seq and k.shape[2] >= min_seq)
    if use_flash:
        ctx.set_output("Out", flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), mask,
            causal=causal, sm_scale=sm_scale))
        return
    ctx.set_output("Out", _naive_attention(q, k, v, mask, causal, sm_scale))
