"""Outlined fusion ops: the ops the rewrite pipeline writes in place of
a composed chain (analysis/rewrite.py), so the port runs what its own
pipeline produces.

The port's copy of ``paddle_tpu/ops/fusion_ops.py``. ``se_block`` is the
one op there: the squeeze-excitation gate that ``SEBlockOutlining``
writes. The JAX package computes it outside any Pallas kernel, and so
does the port (torch's reductions and products); its gradient is the
generic ``__vjp__``.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .math_ops import _mxu_matmul


@register_op("se_block")
def _se_block(ctx):
    """Squeeze-excitation channel gate as one op: global average pool
    -> bottleneck FC (relu) -> expand FC (sigmoid) -> per-channel gate.

    X: [n, c, h, w]; W1: [c, r]; B1: [r]; W2: [r, c]; B2: [c].
    Mirrors the composed layer chain the rewrite pipeline outlines into
    this op; the pooled reduction accumulates a bf16 input in float32,
    as pool2d's average does. The biases and the gate promote as the
    reference's jnp arithmetic does (a bf16 product plus a float32 bias
    is float32)."""
    x = ctx.input("X")
    w1, b1 = ctx.input("W1"), ctx.input("B1")
    w2, b2 = ctx.input("W2"), ctx.input("B2")
    xf = x.float() if x.dtype == torch.bfloat16 else x
    pooled = (torch.sum(xf, dim=(2, 3))
              / (x.shape[2] * x.shape[3])).to(x.dtype)     # [n, c]
    h1 = _mxu_matmul(pooled, w1)
    if b1 is not None:
        h1 = h1 + b1.reshape(1, -1)
    h1 = torch.relu(h1)
    g = _mxu_matmul(h1, w2)
    if b2 is not None:
        g = g + b2.reshape(1, -1)
    g = torch.sigmoid(g)
    ctx.set_output("Out", x * g[:, :, None, None])
