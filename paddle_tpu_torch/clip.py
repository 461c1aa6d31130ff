"""Gradient clipping: the port's copy of ``paddle_tpu/clip.py`` (reference:
python/paddle/fluid/clip.py — GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm, ErrorClipByValue)."""
from __future__ import annotations

from .framework import default_main_program, unique_name


class BaseGradientClipAttr:
    def process(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def process(self, params_grads):
        out = []
        for p, g in params_grads:
            block = p.block.program.global_block()
            ng = block.create_var(name=unique_name(f"{g.name}.clip"),
                                  shape=p.shape, dtype=p.dtype)
            block.append_op("clip", {"X": [g.name]}, {"Out": [ng.name]},
                            {"min": self.min, "max": self.max})
            out.append((p, ng))
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def process(self, params_grads):
        out = []
        for p, g in params_grads:
            block = p.block.program.global_block()
            ng = block.create_var(name=unique_name(f"{g.name}.clip"),
                                  shape=p.shape, dtype=p.dtype)
            block.append_op("clip_by_norm", {"X": [g.name]},
                            {"Out": [ng.name]},
                            {"max_norm": self.clip_norm})
            out.append((p, ng))
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def process(self, params_grads):
        if not params_grads:
            return params_grads
        block = params_grads[0][0].block.program.global_block()
        sq_names = []
        for p, g in params_grads:
            sq = block.create_var(name=unique_name(f"{g.name}.sq"),
                                  shape=[1], dtype=p.dtype)
            block.append_op("squared_l2_norm", {"X": [g.name]},
                            {"Out": [sq.name]})
            sq_names.append(sq.name)
        total = block.create_var(name=unique_name("global_norm_sq"),
                                 shape=[1], dtype=params_grads[0][0].dtype)
        block.append_op("sum", {"X": sq_names}, {"Out": [total.name]})
        norm = block.create_var(name=unique_name("global_norm"),
                                shape=[1], dtype=params_grads[0][0].dtype)
        block.append_op("sqrt", {"X": [total.name]}, {"Out": [norm.name]})
        # scale = clip_norm / max(norm, clip_norm)
        denom = block.create_var(name=unique_name("global_norm_max"),
                                 shape=[1], dtype=params_grads[0][0].dtype)
        block.append_op("clip", {"X": [norm.name]}, {"Out": [denom.name]},
                        {"min": self.clip_norm, "max": 3.4e38})
        out = []
        for p, g in params_grads:
            # ng = g * clip_norm / max(norm, clip_norm)
            ng = block.create_var(name=unique_name(f"{g.name}.gclip"),
                                  shape=p.shape, dtype=p.dtype)
            block.append_op("elementwise_div",
                            {"X": [g.name], "Y": [denom.name]},
                            {"Out": [ng.name]}, {"axis": -1})
            ng2 = block.create_var(name=unique_name(f"{g.name}.gclip2"),
                                   shape=p.shape, dtype=p.dtype)
            block.append_op("scale", {"X": [ng.name]}, {"Out": [ng2.name]},
                            {"scale": self.clip_norm})
            out.append((p, block.program.global_block().var(ng2.name)))
        return out


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)


def set_gradient_clip(clip, param_list=None, program=None):
    program = program or default_main_program()
    program._gradient_clip = clip


def append_gradient_clip_ops(params_grads):
    if not params_grads:
        return params_grads
    program = params_grads[0][0].block.program
    clip = getattr(program, "_gradient_clip", None)
    per_param = [getattr(p, "gradient_clip_attr", None)
                 for p, _ in params_grads]
    if clip is None and not any(per_param):
        return params_grads
    if clip is not None:
        return clip.process(params_grads)
    out = []
    for (p, g), c in zip(params_grads, per_param):
        if c is None:
            out.append((p, g))
        else:
            out.extend(c.process([(p, g)]))
    return out
