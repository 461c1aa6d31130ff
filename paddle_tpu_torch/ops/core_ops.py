"""Core ops: constants, random init, cast, scale.

The port's compute rules for the ``paddle_tpu/ops/core_ops.py`` ops the
decoder LM runs (fill_constant, uniform_random, assign_value, cast,
scale). The feed/fetch plumbing, sum, the other random ops and the
generic ``__vjp__`` grad op wait for later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_op

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


def _generator(ctx) -> torch.Generator:
    """An explicit generator for one random op, seeded from the op's
    `seed` attr — which Program.next_seed derives from the program's
    random_seed at build time. It draws torch's numbers, not JAX's: a
    port model gets the JAX model's weights through io.load_params."""
    g = torch.Generator(device=ctx.device)
    g.manual_seed(int(ctx.attr("seed", 0) or 0))
    return g


@register_op("uniform_random")
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
