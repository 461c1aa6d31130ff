"""Parameter initializers: append init ops to the startup program.

The port's copy of the initializers its models' startups use
(``paddle_tpu/initializer.py``): Constant, Uniform, Normal, Xavier (both
forms). Each appends
one op to the startup program; the op names and attrs are the JAX
package's, so the startup programs serialize identically.
"""
from __future__ import annotations

import math


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", outputs={"Out": var}, attrs={
            "shape": list(var.shape), "dtype": var.dtype,
            "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        seed = self.seed or block.program.desc.next_seed()
        block.append_op("uniform_random", outputs={"Out": var}, attrs={
            "shape": list(var.shape), "dtype": var.dtype,
            "min": self.low, "max": self.high, "seed": seed})


class NormalInitializer(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        seed = self.seed or block.program.desc.next_seed()
        block.append_op("gaussian_random", outputs={"Out": var}, attrs={
            "shape": list(var.shape), "dtype": var.dtype,
            "mean": self.loc, "std": self.scale, "seed": seed})


def fan_in_out_from_shape(shape):
    if len(shape) < 2:
        return int(shape[0]), int(shape[0])
    if len(shape) == 2:
        return int(shape[0]), int(shape[1])
    receptive = 1
    for d in shape[2:]:
        receptive *= int(d)
    return int(shape[1]) * receptive, int(shape[0]) * receptive


class XavierInitializer(Initializer):
    """Glorot init (reference: initializer.py XavierInitializer)."""

    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None,
                 seed: int = 0):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out
        self.seed = seed

    def __call__(self, var, block):
        f_in, f_out = fan_in_out_from_shape(var.shape)
        f_in = self.fan_in if self.fan_in is not None else f_in
        f_out = self.fan_out if self.fan_out is not None else f_out
        seed = self.seed or block.program.desc.next_seed()
        if self.uniform:
            limit = math.sqrt(6.0 / (f_in + f_out))
            block.append_op("uniform_random", outputs={"Out": var}, attrs={
                "shape": list(var.shape), "dtype": var.dtype,
                "min": -limit, "max": limit, "seed": seed})
        else:
            std = math.sqrt(2.0 / (f_in + f_out))
            block.append_op("gaussian_random", outputs={"Out": var},
                            attrs={"shape": list(var.shape),
                                   "dtype": var.dtype, "mean": 0.0,
                                   "std": std, "seed": seed})


# Aliases matching the reference's public names.
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
