"""Tensor-manipulation ops: reshape, transpose, unsqueeze, slice, gather,
range, concat — the port's compute rules for the
``paddle_tpu/ops/tensor_ops.py`` ops the decoder LM and the GRU
encoder-decoder run. transpose and slice return views, as XLA would
fuse them away; the ops that need contiguous memory ask for it."""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op


def jnp_reshape(x, shape):
    """x.reshape(shape), an impossible shape refused with jnp.reshape's
    TypeError word for word: build-time shape inference records the
    message on the op, as the reference's does."""
    n, known = x.numel(), math.prod(d for d in shape if d != -1)
    if -1 in shape:
        if not known or n % known:
            raise TypeError(
                f"cannot reshape array of shape {tuple(x.shape)} (size {n}) "
                f"into shape {shape} because the product of specified axis "
                f"sizes ({known}) does not evenly divide {n}")
    elif known != n:
        raise TypeError(
            f"cannot reshape array of shape {tuple(x.shape)} (size {n}) "
            f"into shape {shape} (size {known})")
    return x.reshape(shape)


@register_op("reshape")
def _reshape(ctx):
    x = ctx.input("X")
    shape = list(ctx.attr("shape"))
    # Reference semantics: 0 means copy dim from input (reshape_op.cc).
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    ctx.set_output("Out", jnp_reshape(x, shape))


@register_op("transpose")
def _transpose(ctx):
    ctx.set_output("Out", ctx.input("X").permute(*ctx.attr("axis")))


@register_op("unsqueeze")
def _unsqueeze(ctx):
    x = ctx.input("X")
    for ax in sorted(ctx.attr("axes")):
        x = x.unsqueeze(ax)
    ctx.set_output("Out", x)


@register_op("concat")
def _concat(ctx):
    ctx.set_output("Out", torch.cat(ctx.inputs("X"),
                                    dim=ctx.attr("axis", 0)))


@register_op("slice")
def _slice(ctx):
    x = ctx.input("Input")
    idx = [slice(None)] * x.ndim
    for ax, st, en in zip(ctx.attr("axes"), ctx.attr("starts"),
                          ctx.attr("ends")):
        idx[ax] = slice(st, en)
    ctx.set_output("Out", x[tuple(idx)])


@register_op("gather", no_grad_slots=["Index"])
def _gather(ctx):
    x = ctx.input("X")
    index = ctx.input("Index").long()
    if index.ndim == 2 and index.shape[-1] == 1:
        index = index.reshape(-1)
    ctx.set_output("Out", torch.index_select(x, 0, index))


@register_op("range", no_grad_slots=["Start", "End", "Step"],
             constant=True)
def _range(ctx):
    start = ctx.attr("start", 0)
    dtype = torch.int64 if isinstance(start, int) else torch.float32
    ctx.set_output("Out", torch.arange(start, ctx.attr("end"),
                                       ctx.attr("step", 1), dtype=dtype,
                                       device=ctx.device))
