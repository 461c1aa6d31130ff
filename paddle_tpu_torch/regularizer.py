"""Weight-decay regularizers: the port's copy of ``paddle_tpu/regularizer.py``
(reference: python/paddle/fluid/regularizer.py — L1Decay/L2Decay appended
as ops on the gradient before the optimizer op)."""
from __future__ import annotations

from .framework import unique_name


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        decay = block.create_var(name=unique_name(f"{param.name}.l2decay"),
                                 shape=param.shape, dtype=param.dtype)
        block.append_op("scale", {"X": [param.name]},
                        {"Out": [decay.name]}, {"scale": self.coeff})
        out = block.create_var(name=unique_name(f"{grad.name}.reg"),
                               shape=param.shape, dtype=param.dtype)
        block.append_op("sum", {"X": [grad.name, decay.name]},
                        {"Out": [out.name]})
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        sign = block.create_var(name=unique_name(f"{param.name}.sign"),
                                shape=param.shape, dtype=param.dtype)
        block.append_op("sign", {"X": [param.name]}, {"Out": [sign.name]})
        decay = block.create_var(name=unique_name(f"{param.name}.l1decay"),
                                 shape=param.shape, dtype=param.dtype)
        block.append_op("scale", {"X": [sign.name]}, {"Out": [decay.name]},
                        {"scale": self.coeff})
        out = block.create_var(name=unique_name(f"{grad.name}.reg"),
                               shape=param.shape, dtype=param.dtype)
        block.append_op("sum", {"X": [grad.name, decay.name]},
                        {"Out": [out.name]})
        return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for param, grad in params_grads:
        regularizer = getattr(param, "regularizer", None) or regularization
        if regularizer is None:
            out.append((param, grad))
            continue
        block = param.block.program.global_block()
        new_grad = regularizer.append_regularization_op(param, grad,
                                                        block)
        out.append((param, new_grad))
    return out
