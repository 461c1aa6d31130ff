"""Optimizer ops: one op per parameter update, writing ParamOut (and the
accumulator outs) back to persistable state.

The port's compute rules of the dense update ops of
``paddle_tpu/ops/optimizer_ops.py`` (reference: sgd_op.cc,
momentum_op.cc, adam_op.cc, adagrad_op.cc, adamax_op.cc, adadelta_op.cc,
rmsprop_op.cc, decayed_adagrad_op.cc, ftrl_op.cc, lars_momentum_op.cc,
proximal_gd_op.cc, proximal_adagrad_op.cc, average_accumulates_op.h),
with the reference's slots, attrs and defaults; the sparse row-wise
variants wait for a later slice. Each rule returns new tensors and the
executor writes them to the scope after the run, as the JAX executor
threads them functionally.
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


@register_op("adagrad", no_grad_slots=["Param", "Grad", "Moment",
                                       "LearningRate"])
def _adagrad(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    m = ctx.input("Moment")
    lr = ctx.input("LearningRate").reshape(())
    eps = ctx.attr("epsilon", 1e-6)
    m_out = m + torch.square(g)
    ctx.set_output("ParamOut", p - lr * g / (torch.sqrt(m_out) + eps))
    ctx.set_output("MomentOut", m_out)


@register_op("adamax", no_grad_slots=["Param", "Grad", "Moment", "InfNorm",
                                      "LearningRate", "Beta1Pow"])
def _adamax(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    m = ctx.input("Moment")
    u = ctx.input("InfNorm")
    lr = ctx.input("LearningRate").reshape(())
    b1p = ctx.input("Beta1Pow").reshape(())
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_out = b1 * m + (1 - b1) * g
    # epsilon inside the max, on the decayed-norm side (adamax_op.h)
    u_out = torch.maximum(torch.abs(g), b2 * u + eps)
    ctx.set_output("ParamOut", p - (lr / (1 - b1p)) * m_out / u_out)
    ctx.set_output("MomentOut", m_out)
    ctx.set_output("InfNormOut", u_out)


@register_op("adadelta", no_grad_slots=["Param", "Grad", "AvgSquaredGrad",
                                        "AvgSquaredUpdate"])
def _adadelta(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    sg = ctx.input("AvgSquaredGrad")
    su = ctx.input("AvgSquaredUpdate")
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    sg_out = rho * sg + (1 - rho) * torch.square(g)
    update = -torch.sqrt((su + eps) / (sg_out + eps)) * g
    su_out = rho * su + (1 - rho) * torch.square(update)
    ctx.set_output("ParamOut", p + update)
    ctx.set_output("AvgSquaredGradOut", sg_out)
    ctx.set_output("AvgSquaredUpdateOut", su_out)


@register_op("rmsprop", no_grad_slots=["Param", "Grad", "Moment",
                                       "MeanSquare", "LearningRate"])
def _rmsprop(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    mom = ctx.input("Moment")
    ms = ctx.input("MeanSquare")
    lr = ctx.input("LearningRate").reshape(())
    rho = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    mu = ctx.attr("momentum", 0.0)
    ms_out = rho * ms + (1 - rho) * torch.square(g)
    mom_out = mu * mom + lr * g / torch.sqrt(ms_out + eps)
    ctx.set_output("ParamOut", p - mom_out)
    ctx.set_output("MomentOut", mom_out)
    ctx.set_output("MeanSquareOut", ms_out)


@register_op("decayed_adagrad", no_grad_slots=["Param", "Grad", "Moment",
                                               "LearningRate"])
def _decayed_adagrad(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    m = ctx.input("Moment")
    lr = ctx.input("LearningRate").reshape(())
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    m_out = decay * m + (1 - decay) * torch.square(g)
    ctx.set_output("ParamOut", p - lr * g / (torch.sqrt(m_out) + eps))
    ctx.set_output("MomentOut", m_out)


@register_op("ftrl", no_grad_slots=["Param", "Grad", "SquaredAccumulator",
                                    "LinearAccumulator", "LearningRate"])
def _ftrl(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    sq = ctx.input("SquaredAccumulator")
    lin = ctx.input("LinearAccumulator")
    lr = ctx.input("LearningRate").reshape(())
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    power = ctx.attr("lr_power", -0.5)
    new_sq = sq + torch.square(g)
    sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
    lin_out = lin + g - sigma * p
    quad = torch.pow(new_sq, -power) / lr + 2 * l2
    pre = torch.clamp(lin_out, -l1, l1) - lin_out
    p_out = torch.where(torch.abs(lin_out) > l1, pre / quad,
                        torch.zeros_like(p))
    ctx.set_output("ParamOut", p_out)
    ctx.set_output("SquaredAccumOut", new_sq)
    ctx.set_output("LinearAccumOut", lin_out)


@register_op("lars_momentum", no_grad_slots=["Param", "Grad", "Velocity",
                                             "LearningRate"])
def _lars_momentum(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    v = ctx.input("Velocity")
    lr = ctx.input("LearningRate").reshape(())
    mu = ctx.attr("mu", 0.9)
    coeff = ctx.attr("lars_coeff", 0.001)
    decay = ctx.attr("lars_weight_decay", 0.0005)
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = lr * coeff * p_norm / (g_norm + decay * p_norm + 1e-12)
    v_out = mu * v + local_lr * (g + decay * p)
    ctx.set_output("ParamOut", p - v_out)
    ctx.set_output("VelocityOut", v_out)


def _proximal(prox, lr, l1, l2):
    """The soft threshold of proximal_gd_op.cc / proximal_adagrad_op.h,
    its thresholds scaled by the base lr."""
    if l1 > 0:
        return (torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                               min=0.0)) / (1.0 + lr * l2)
    return prox / (1.0 + lr * l2)


@register_op("proximal_gd", no_grad_slots=["Param", "Grad", "LearningRate"])
def _proximal_gd(ctx):
    """prox = param - lr grad, then the soft threshold (l1, l2)."""
    lr = ctx.input("LearningRate").reshape(())
    prox = ctx.input("Param") - lr * ctx.input("Grad")
    ctx.set_output("ParamOut", _proximal(prox, lr, ctx.attr("l1", 0.0),
                                         ctx.attr("l2", 0.0)))


@register_op("proximal_adagrad", no_grad_slots=["Param", "Grad", "Moment",
                                                "LearningRate"])
def _proximal_adagrad(ctx):
    """Adagrad's step, then proximal_gd's soft threshold."""
    g = ctx.input("Grad")
    lr = ctx.input("LearningRate").reshape(())
    m_out = ctx.input("Moment") + g * g
    prox = ctx.input("Param") - lr * g / torch.sqrt(m_out)
    ctx.set_output("ParamOut", _proximal(prox, lr, ctx.attr("l1", 0.0),
                                         ctx.attr("l2", 0.0)))
    ctx.set_output("MomentOut", m_out)


#: kMaxNumAccumulates of average_accumulates_op.h: sum_1 rolls into sum_2
#: every this many updates
_MAX_NUM_ACCUMULATES = 16384


@register_op("average_accumulates", no_grad_slots=[
    "param", "in_sum_1", "in_sum_2", "in_sum_3", "in_num_accumulates",
    "in_old_num_accumulates", "in_num_updates"])
def _average_accumulates(ctx):
    """ModelAverage's sliding-window parameter sums (reference:
    average_accumulates_op.h), as the JAX package computes them: sum_1
    per step, rolled into sum_2 every 16384 updates, both folded into
    sum_3 when the window [min_average_window, min(max_average_window,
    num_updates * average_window)] closes; the counters keep their
    tensors' dtype."""
    p = ctx.input("param")
    s1, s2, s3 = (ctx.input(f"in_sum_{i}") for i in (1, 2, 3))
    counters = [ctx.input(n) for n in ("in_num_accumulates",
                                       "in_old_num_accumulates",
                                       "in_num_updates")]
    num_acc, old_num, num_upd = (c.reshape(()).to(torch.int32)
                                 for c in counters)
    rate = ctx.attr("average_window", 0.0)
    min_w = ctx.attr("min_average_window", 10000)
    max_w = ctx.attr("max_average_window", 10000)
    num_upd = num_upd + 1
    num_acc = num_acc + 1
    o1, o2 = s1 + p, s2
    # the reference's in and out tensors alias one accumulator: its reads
    # after the update see the updated values
    roll = (num_upd % _MAX_NUM_ACCUMULATES) == 0
    o2 = torch.where(roll, o2 + o1, o2)
    o1 = torch.where(roll, torch.zeros_like(o1), o1)
    close = (num_acc >= min_w) & (num_acc.to(torch.float32) >= torch.clamp(
        num_upd.to(torch.float32) * rate, max=float(max_w)))
    o3 = torch.where(close, o1 + o2, s3)
    o1 = torch.where(close, torch.zeros_like(o1), o1)
    o2 = torch.where(close, torch.zeros_like(o2), o2)
    old_num = torch.where(close, num_acc, old_num)
    num_acc = torch.where(close, torch.zeros_like(num_acc), num_acc)
    ctx.set_output("out_sum_1", o1)
    ctx.set_output("out_sum_2", o2)
    ctx.set_output("out_sum_3", o3)
    for name, value, like in (("out_num_accumulates", num_acc, counters[0]),
                              ("out_old_num_accumulates", old_num,
                               counters[1]),
                              ("out_num_updates", num_upd, counters[2])):
        ctx.set_output(name, value.reshape(1).to(like.dtype))
