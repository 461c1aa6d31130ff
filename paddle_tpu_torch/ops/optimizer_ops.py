"""Optimizer ops: one op per parameter update, writing ParamOut (and the
accumulator outs) back to persistable state.

The port's compute rules for ``sgd``, ``momentum`` and ``adam`` from
``paddle_tpu/ops/optimizer_ops.py`` (reference: sgd_op.cc,
momentum_op.cc, adam_op.cc);
the other update rules and the sparse row-wise variants wait for later
slices. Each rule returns new tensors and the executor writes them to
the scope after the run, as the JAX executor threads them functionally.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("sgd", no_grad_slots=["Param", "Grad", "LearningRate"])
def _sgd(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    lr = ctx.input("LearningRate")
    ctx.set_output("ParamOut", p - lr.reshape(()).to(p.dtype) * g)


@register_op("momentum",
             no_grad_slots=["Param", "Grad", "Velocity", "LearningRate"])
def _momentum(ctx):
    """v' = mu v + g; p' = p - lr v', or with use_nesterov
    p' = p - (g + mu v') lr."""
    p = ctx.input("Param")
    g = ctx.input("Grad")
    v = ctx.input("Velocity")
    lr = ctx.input("LearningRate").reshape(())
    mu = ctx.attr("mu", 0.9)
    v_out = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    ctx.set_output("ParamOut", p_out)
    ctx.set_output("VelocityOut", v_out)


@register_op("adam", no_grad_slots=[
    "Param", "Grad", "Moment1", "Moment2", "LearningRate",
    "Beta1Pow", "Beta2Pow"])
def _adam(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    m1 = ctx.input("Moment1")
    m2 = ctx.input("Moment2")
    lr = ctx.input("LearningRate").reshape(())
    b1p = ctx.input("Beta1Pow").reshape(())
    b2p = ctx.input("Beta2Pow").reshape(())
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    ctx.set_output("ParamOut", p_out)
    ctx.set_output("Moment1Out", m1_out)
    ctx.set_output("Moment2Out", m2_out)
    # the beta powers keep their [1] shape: state written matches state
    # read
    ctx.set_output("Beta1PowOut", ctx.input("Beta1Pow") * b1)
    ctx.set_output("Beta2PowOut", ctx.input("Beta2Pow") * b2)
