"""Core ops: constants, random init, sum, cast, scale, and the generic
``__vjp__`` grad op that powers desc-level autodiff.

The port's compute rules for the ``paddle_tpu/ops/core_ops.py`` ops its
models' startup and train programs run. The feed/fetch plumbing and the
other random ops wait for later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.ir import OpDesc
from ..core.lod import RAGGED_TYPES, with_data
from ..core.registry import register_op, run_op

_TORCH_DTYPE = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(name: str) -> torch.dtype:
    return _TORCH_DTYPE[name]


def _is_meta(device) -> bool:
    return torch.device(device).type == "meta"


# -- constants / random -----------------------------------------------------

@register_op("fill_constant", constant=True)
def _fill_constant(ctx):
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    value = ctx.attr("value", 0.0)
    if not (dtype.is_floating_point or dtype.is_complex):
        value = int(value)
    ctx.set_output("Out", torch.full(list(ctx.attr("shape")), value,
                                     dtype=dtype, device=ctx.device))


@register_op("fill_constant_like")
def _fill_constant_like(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", torch.full_like(x, ctx.attr("value", 0.0)))


@register_op("fill_constant_batch_size_like", no_grad_slots=["Input"])
def _fill_constant_batch_size_like(ctx):
    """fill_constant whose dim `output_dim_idx` takes the extent of the
    Input's dim `input_dim_idx` (DynamicRNN.memory(shape=) emits it)."""
    x = ctx.input("Input")
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = \
        x.shape[ctx.attr("input_dim_idx", 0)]
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    value = ctx.attr("value", 0.0)
    if not (dtype.is_floating_point or dtype.is_complex):
        value = int(value)
    ctx.set_output("Out", torch.full(shape, value, dtype=dtype,
                                     device=x.device))


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx):
    ctx.set_output("Out", torch.zeros_like(ctx.input("X")))


def _generator(ctx) -> torch.Generator:
    """An explicit generator for one random op, seeded from the op's
    `seed` attr — which Program.next_seed derives from the program's
    random_seed at build time. It draws torch's numbers, not JAX's: a
    port model gets the JAX model's weights through io.load_param_arrays."""
    g = torch.Generator(device=ctx.device)
    g.manual_seed(int(ctx.attr("seed", 0) or 0))
    return g


@register_op("uniform_random", capturable=False)
def _uniform_random(ctx):
    shape = list(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    if _is_meta(ctx.device):
        ctx.set_output("Out", torch.empty(shape, dtype=dtype,
                                          device="meta"))
        return
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    u = torch.rand(shape, generator=_generator(ctx), dtype=torch.float32,
                   device=ctx.device)
    ctx.set_output("Out", (u * (hi - lo) + lo).to(dtype))


@register_op("gaussian_random", capturable=False)
def _gaussian_random(ctx):
    """mean + std * N(0, 1) of the attr shape, drawn from the op's seeded
    generator in float32, then cast."""
    shape = list(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    if _is_meta(ctx.device):
        ctx.set_output("Out", torch.empty(shape, dtype=dtype,
                                          device="meta"))
        return
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    z = torch.randn(shape, generator=_generator(ctx), dtype=torch.float32,
                    device=ctx.device)
    ctx.set_output("Out", (mean + std * z).to(dtype))


@register_op("assign_value", constant=True)
def _assign_value(ctx):
    shape = list(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    if _is_meta(ctx.device):
        ctx.set_output("Out", torch.empty(shape, dtype=dtype,
                                          device="meta"))
        return
    vals = np.asarray(ctx.attr("values"),
                      dtype=str(dtype).rsplit(".", 1)[-1]).reshape(shape)
    ctx.set_output("Out", torch.from_numpy(vals).to(ctx.device))


# -- basic transforms -------------------------------------------------------

@register_op("assign")
def _assign(ctx):
    ctx.set_output("Out", ctx.input("X"))


@register_op("sum")
def _sum(ctx):
    xs = ctx.inputs("X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.set_output("Out", out)


@register_op("cast")
def _cast(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", x.to(torch_dtype(ctx.attr("out_dtype",
                                                    "float32"))))


@register_op("scale")
def _scale(ctx):
    x = ctx.input("X")
    scale = ctx.attr("scale", 1.0)
    bias = ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        ctx.set_output("Out", x * scale + bias)
    else:
        ctx.set_output("Out", (x + bias) * scale)


@register_op("increment")
def _increment(ctx):
    """x + step in x's own dtype (an integer counter stays an integer
    inside a While); the step is a python scalar, so a CUDA graph
    captures the add."""
    x = ctx.input("X")
    step = ctx.attr("step", 1.0)
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        step = int(step)
    ctx.set_output("Out", x + step)


# -- the generic grad op ----------------------------------------------------

def _dense(v):
    return v.data if isinstance(v, RAGGED_TYPES) else v


def vjp_leaves(names, values, need_grad):
    """The environment a forward rule runs in under autograd, for a
    ``__vjp__`` op: {name: value} over `names`, where each value that
    needs a gradient is a detached leaf copy (a ragged value's leaf is
    its dense data, re-wrapped with the same lengths, so a sequence op
    still sees every row's length). Returns (env, leaves, wrapped): the
    leaves and the values they stand for, in order."""
    leaves, wrapped = [], []
    env = {}
    for n, v, need in zip(names, values, need_grad):
        if need:
            leaf = _dense(v).detach().requires_grad_(True)
            leaves.append(leaf)
            wrapped.append(v)
            v = with_data(v, leaf)
        env[n] = v
    return env, leaves, wrapped


def _aval(t) -> str:
    """A tensor's type as JAX prints an abstract value: float32[2,3]."""
    return f"{str(t.dtype).replace('torch.', '')}[" \
        f"{','.join(str(int(d)) for d in t.shape)}]"


def vjp_grads(outs, grad_out_names, out_grads, leaves, wrapped,
              retain_graph=False):
    """Pull the cotangents `out_grads` of the outputs `grad_out_names` of
    `outs` (a forward rule's outputs, recorded under autograd from
    vjp_leaves' env) back to the leaves: one gradient a leaf, zeros for
    a leaf the outputs do not depend on (as jax.vjp gives), ragged with
    its lengths where the leaf stood for a ragged value."""
    for n, g in zip(grad_out_names, out_grads):
        y, ct = _dense(outs[n]), _dense(g)
        if tuple(y.shape) != tuple(ct.shape):
            # jax.vjp's refusal, word for word (the verifier's re-run of
            # a __vjp__ op's inference records it, as the reference's does)
            raise ValueError(
                "unexpected JAX type (e.g. shape/dtype) for argument to "
                f"VJP function: got {_aval(ct)}, but expected {_aval(y)} "
                "because the corresponding output of the differentiated "
                f"function had JAX type {_aval(y)}")
    with torch.enable_grad():
        pairs = [(_dense(outs[n]), _dense(g))
                 for n, g in zip(grad_out_names, out_grads)
                 if _dense(outs[n]).requires_grad]
        grads = [None] * len(leaves)
        if pairs:
            ys, cts = zip(*pairs)
            grads = torch.autograd.grad(ys, leaves, cts, allow_unused=True,
                                        retain_graph=retain_graph)
    out = []
    for g, leaf, v in zip(grads, leaves, wrapped):
        g = torch.zeros_like(leaf) if g is None else g.detach()
        out.append(with_data(v, g))
    return out


def vjp_out_names(op):
    """The forward outputs of the ``__vjp__`` op `op` that get a
    cotangent, in its OutGrad order."""
    fwd = op.attrs["fwd_op"]
    names = [n for slot in fwd["outputs"].values() for n in slot]
    return [n for n, h in zip(names, op.attrs["out_has_grad"]) if h]


@register_op("__vjp__", ragged_aware=True)
def _vjp(ctx):
    """Gradient of an arbitrary forward op: replay its compute rule under
    torch autograd. See core/backward.py for how this op is built.

    The inputs that need a gradient enter the replay as detached leaf
    copies; torch.autograd.grad then pulls the output cotangents back to
    them. An input the outputs do not depend on gets zeros, as jax.vjp
    gives. The eager executor (Executor(compiled=False)) runs every
    other op under torch.no_grad(); only this replay records a graph,
    and it is dropped when the op returns. Eager torch has no CSE: the
    forward op runs a second time here (for scaled_dot_product_attention
    on the flash route that is a second forward-kernel launch before the
    backward kernels, for lstm on the kernel route a second fused-LSTM
    forward). The compiled executor does not run this rule: it records
    the forward op itself under autograd and hands its graph to this op
    (core/executor.py), through the same vjp_leaves and vjp_grads.

    A sub-block op (While, DynamicRNN, ...) reads outer vars by closure:
    those ride along as extra FwdIn entries (attr closure_names, from
    core/backward.py _sub_block_free_vars), so their gradients come back
    too. The replay runs over the op's whole environment with the FwdIn
    values bound to the forward names, as the JAX package's does.

    Ragged values, as the JAX package's op treats them: a ragged input's
    leaf is its dense data, re-wrapped with the same lengths before the
    forward rule runs; ragged outputs and cotangents enter autograd as
    their data; the gradient of a ragged input comes back ragged with
    its lengths."""
    fwd = OpDesc.from_dict(ctx.attr("fwd_op"))
    replay_names = fwd.input_names() + list(ctx.attr("closure_names", [])
                                            or [])
    local, leaves, wrapped = vjp_leaves(replay_names, ctx.inputs("FwdIn"),
                                        ctx.attr("in_need_grad"))
    env = dict(ctx.env)
    env.update(local)
    with torch.enable_grad():
        outs = run_op(fwd, env, ctx.extra)
    grads = vjp_grads(outs, vjp_out_names(ctx.op), ctx.inputs("OutGrad"),
                      leaves, wrapped)
    for i, g in enumerate(grads):
        ctx.set_output("InGrad", g, index=i)
