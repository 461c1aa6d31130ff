"""Math ops: elementwise (with the reference's axis broadcast), mul,
matmul, reduce_sum, mean, activations, clipping, comparisons and logical ops,
arg_max, cos_sim.

The port's compute rules for the ``paddle_tpu/ops/math_ops.py`` ops its
models' train steps run (softmax and top_k included), plus the few that
the gradient clippers and regularizers (clip.py, regularizer.py)
append.
The matrix products stay torch.matmul: the JAX package left them to XLA
and wrote no kernel for them. Under AMP (amp.py) they take the
reference's _mxu_matmul rule, and a mixed bf16/float32 elementwise pair
computes in bf16.
"""
from __future__ import annotations

import torch

from ..amp import amp_cast, amp_enabled
from ..core.registry import register_op


def _mxu_matmul(x, y):
    """torch.matmul under the reference's AMP rule: bf16 operands and a
    bf16 result wherever the promoted dtype was float32, the products
    accumulated in float32 (cuBLAS on the card; the CPU's bf16 GEMM also
    sums in float32 and rounds once, tests/test_torch_amp.py holds it).
    Without AMP, or for other dtypes, the operands are promoted as
    jnp.matmul promotes them."""
    out_dtype = torch.promote_types(x.dtype, y.dtype)
    x, y = amp_cast(x, y)
    if x.dtype == y.dtype == torch.bfloat16 and out_dtype == torch.float32:
        return torch.matmul(x, y)
    return torch.matmul(x.to(out_dtype), y.to(out_dtype))


def _broadcast_y(x, y, axis: int):
    """Reference elementwise broadcast: align y's dims starting at `axis`
    of x. axis=-1 means trailing alignment."""
    xnd, ynd = x.ndim, y.ndim
    if xnd == ynd:
        return y
    if axis == -1 or axis is None:
        axis = xnd - ynd
    shape = [1] * axis + list(y.shape) + [1] * (xnd - axis - ynd)
    return y.reshape(shape)


def _register_elementwise(name, fn, lax_name):
    @register_op(name)
    def _op(ctx, _fn=fn):
        x = ctx.input("X")
        y = _broadcast_y(x, ctx.input("Y"), ctx.attr("axis", -1))
        # under AMP bf16 wins a mixed bf16/float32 pair (a float32 bias or
        # scale would otherwise promote the activations back to float32)
        if amp_enabled() and {x.dtype, y.dtype} == {torch.bfloat16,
                                                     torch.float32}:
            x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
        try:
            out = _fn(x, y)
        except RuntimeError:
            try:
                torch.broadcast_shapes(x.shape, y.shape)
            except RuntimeError:
                # lax's refusal, word for word (build-time shape
                # inference records it on the op, as the reference's does)
                raise TypeError(
                    f"{lax_name} got incompatible shapes for broadcasting: "
                    f"{tuple(x.shape)}, {tuple(y.shape)}.") from None
            raise
        ctx.set_output("Out", out)


_register_elementwise("elementwise_add", lambda x, y: x + y, "add")
_register_elementwise("elementwise_sub", lambda x, y: x - y, "sub")
_register_elementwise("elementwise_mul", lambda x, y: x * y, "mul")
_register_elementwise("elementwise_div", lambda x, y: x / y, "div")
_register_elementwise("elementwise_max", torch.maximum, "max")


def _prod(dims):
    p = 1
    for d in dims:
        p *= int(d)
    return p


@register_op("mul")
def _mul(ctx):
    """The reference's `mul` op: flatten X to 2-D at x_num_col_dims, Y at
    y_num_col_dims, matmul, restore shape (mul_op.cc)."""
    x = ctx.input("X")
    y = ctx.input("Y")
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    x2 = x.reshape(_prod(x.shape[:xn]), _prod(x.shape[xn:]))
    y2 = y.reshape(_prod(y.shape[:yn]), _prod(y.shape[yn:]))
    if x2.shape[1] != y2.shape[0]:
        # lax.dot_general's refusal, word for word (build-time shape
        # inference records it on the op, as the reference's does)
        raise TypeError(
            "dot_general requires contracting dimensions to have the same "
            f"shape, got ({x2.shape[1]},) and ({y2.shape[0]},).")
    out_shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    ctx.set_output("Out", _mxu_matmul(x2, y2).reshape(out_shape))


@register_op("matmul")
def _matmul(ctx):
    """The reference's `matmul` op (matmul_op.cc): optional transposes
    of the last two axes, a batched product broadcast over the leading
    ones, then `alpha` (after the product, as the reference scales: under
    AMP that is the bf16 result times alpha). Its gradient is the
    generic ``__vjp__``."""
    x = ctx.input("X")
    y = ctx.input("Y")
    if ctx.attr("transpose_X", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = _mxu_matmul(x, y)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.set_output("Out", out)


@register_op("reduce_sum")
def _reduce_sum(ctx):
    x = ctx.input("X")
    dim = ctx.attr("dim", None)
    keep = ctx.attr("keep_dim", False)
    if ctx.attr("reduce_all", False) or dim is None:
        axis = tuple(range(x.ndim))
    else:
        axis = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
    ctx.set_output("Out", torch.sum(x, dim=axis, keepdim=keep))


@register_op("mean")
def _mean(ctx):
    """Mean of every element, a 0-d tensor (jnp.mean's shape)."""
    ctx.set_output("Out", torch.mean(ctx.input("X")))


def _register_act(name, fn):
    @register_op(name)
    def _op(ctx, _fn=fn):
        ctx.set_output("Out", _fn(ctx.input("X")))


_register_act("relu", torch.relu)
_register_act("tanh", torch.tanh)
_register_act("sqrt", torch.sqrt)
_register_act("sign", torch.sign)
_register_act("sigmoid", torch.sigmoid)
_register_act("square", torch.square)


@register_op("clip")
def _clip(ctx):
    ctx.set_output("Out", torch.clamp(ctx.input("X"), ctx.attr("min", -1.0),
                                      ctx.attr("max", 1.0)))


@register_op("clip_by_norm")
def _clip_by_norm(ctx):
    x = ctx.input("X")
    max_norm = ctx.attr("max_norm", 1.0)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    ctx.set_output("Out", x * scale)


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx):
    ctx.set_output("Out", torch.sum(torch.square(ctx.input("X"))))


@register_op("softmax")
def _softmax(ctx):
    """Softmax over attr `axis` (bf16 computed in float32)."""
    x = ctx.input("X")
    xf = x.float() if x.dtype == torch.bfloat16 else x
    ctx.set_output("Out", torch.softmax(xf, dim=ctx.attr("axis", -1))
                   .to(x.dtype))


@register_op("top_k", no_grad_slots=["X"])
def _top_k(ctx):
    """The k largest entries of the last axis, in descending order, and
    their int64 indices (no gradient reaches X)."""
    vals, idxs = torch.topk(ctx.input("X"), ctx.attr("k", 1), dim=-1)
    ctx.set_output("Out", vals)
    ctx.set_output("Indices", idxs.to(torch.int64))


# -- comparisons / logical --------------------------------------------------

def _register_cmp(name, fn):
    @register_op(name, no_grad_slots=["X", "Y"])
    def _op(ctx, _fn=fn):
        x, y = ctx.input("X"), ctx.input("Y")
        y = _broadcast_y(x, y, ctx.attr("axis", -1))
        ctx.set_output("Out", _fn(x, y))


_register_cmp("equal", lambda x, y: x == y)
_register_cmp("not_equal", lambda x, y: x != y)
_register_cmp("less_than", lambda x, y: x < y)
_register_cmp("less_equal", lambda x, y: x <= y)
_register_cmp("greater_than", lambda x, y: x > y)
_register_cmp("greater_equal", lambda x, y: x >= y)

_register_cmp("logical_and", torch.logical_and)
_register_cmp("logical_or", torch.logical_or)


@register_op("logical_not", no_grad_slots=["X"])
def _logical_not(ctx):
    ctx.set_output("Out", torch.logical_not(ctx.input("X")))


@register_op("arg_max", no_grad_slots=["X"])
def _arg_max(ctx):
    ctx.set_output("Out", torch.argmax(ctx.input("X"),
                                       dim=ctx.attr("axis", -1)))


@register_op("cos_sim")
def _cos_sim(ctx):
    """Cosine similarity along the last axis, with the reference's
    ``+ 1e-12`` in the denominator; XNorm and YNorm are the norms."""
    x, y = ctx.input("X"), ctx.input("Y")
    xn = torch.sqrt(torch.sum(torch.square(x), -1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), -1, keepdim=True))
    out = torch.sum(x * y, -1, keepdim=True) / (xn * yn + 1e-12)
    ctx.set_output("Out", out)
    ctx.set_output("XNorm", xn)
    ctx.set_output("YNorm", yn)
