"""LayerHelper: shared parameter/bias/activation plumbing for layer functions.

The port's copy of ``paddle_tpu/layer_helper.py`` (without weight
normalization, which no ported layer uses yet): creates parameters in
the startup program (with initializer ops) and mirrors them into the
main program, stacks them per stage inside a PipelinedStack block,
appends bias/activation ops after a layer's core op.
"""
from __future__ import annotations

from typing import Optional

from . import framework
from .framework import default_main_program, default_startup_program, \
    unique_name
from .initializer import ConstantInitializer, XavierInitializer


class ParamAttr:
    """Reference parity: python/paddle/fluid/param_attr.py."""

    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return None
        raise TypeError(f"bad param_attr {arg!r}")


# Active parameter-stacking contexts (innermost last). While a
# PipelinedStack block is being built, every parameter created inside it
# gets a leading per-stage dim and is recorded — see
# layers/control_flow.py PipelinedStack.
_PARAM_STACK_CTX: list = []


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name or unique_name(layer_type)

    @property
    def main_program(self) -> framework.Program:
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self) -> framework.Program:
        return self.kwargs.get("startup_program") or \
            default_startup_program()

    @property
    def block(self) -> framework.Block:
        return self.main_program.current_block()

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        ba = self.kwargs.get("bias_attr")
        if ba is False:
            return None
        return ParamAttr.to_attr(ba)

    # ------------------------------------------------------------------
    def create_parameter(self, attr: Optional[ParamAttr], shape, dtype,
                         is_bias: bool = False,
                         default_initializer=None) -> framework.Parameter:
        attr = attr or ParamAttr()
        if attr.initializer is not None:
            init = attr.initializer
        elif default_initializer is not None:
            init = default_initializer
        elif is_bias:
            init = ConstantInitializer(0.0)
        else:
            init = XavierInitializer()
        name = attr.name or unique_name(f"{self.name}.w")
        if _PARAM_STACK_CTX:
            n_stages, record = _PARAM_STACK_CTX[-1]
            # a fan-sensitive initializer scales from the PER-STAGE
            # shape, not the stacked [n_stages, ...] one
            from .initializer import XavierInitializer as _Xavier, \
                fan_in_out_from_shape
            if isinstance(init, _Xavier):
                f_in, f_out = fan_in_out_from_shape(list(shape))
                init = _Xavier(
                    uniform=init.uniform,
                    fan_in=init.fan_in if init.fan_in is not None else f_in,
                    fan_out=init.fan_out if init.fan_out is not None
                    else f_out,
                    seed=init.seed)
            shape = [n_stages] + list(shape)
            record(name)
        # Parameter lives in BOTH programs: init op in startup, var in main.
        startup_block = self.startup_program.global_block()
        sp = startup_block.create_parameter(name=name, shape=shape,
                                           dtype=dtype,
                                           trainable=attr.trainable)
        init(sp, startup_block)
        return self.block.program.global_block().create_parameter(
            name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            regularizer=attr.regularizer)

    def create_tmp_variable(self, dtype, lod_level: int = 0,
                            shape=None) -> framework.Variable:
        return self.block.create_var(
            name=unique_name(f"{self.name}.tmp"), dtype=dtype,
            lod_level=lod_level, shape=shape)

    def create_variable(self, **kw) -> framework.Variable:
        return self.block.create_var(**kw)

    def create_global_variable(self, shape, dtype, name=None,
                               persistable=False,
                               stop_gradient=True) -> framework.Variable:
        return self.main_program.global_block().create_var(
            name=name or unique_name(f"{self.name}.global"), shape=shape,
            dtype=dtype, persistable=persistable,
            stop_gradient=stop_gradient)

    def set_variable_initializer(self, var, initializer):
        startup_block = self.startup_program.global_block()
        sv = startup_block.create_var(name=var.name, shape=var.shape,
                                      dtype=var.dtype, persistable=True)
        initializer(sv, startup_block)
        var.desc.persistable = True
        return var

    def append_op(self, **kwargs):
        return self.block.append_op(
            kwargs["type"], kwargs.get("inputs"), kwargs.get("outputs"),
            kwargs.get("attrs"))

    # ------------------------------------------------------------------
    def append_bias_op(self, input_var, size=None):
        bias_attr = self.bias_attr
        if bias_attr is None:
            return input_var
        if size is None:
            size = input_var.shape[-1] if input_var.shape else None
        if size is None:
            raise ValueError("bias size unknown: pass size= explicitly for "
                             "vars without static shape")
        b = self.create_parameter(bias_attr, shape=[int(size)],
                                  dtype=input_var.dtype, is_bias=True)
        out = self.create_tmp_variable(input_var.dtype,
                                       lod_level=input_var.lod_level,
                                       shape=input_var.shape)
        self.append_op(type="elementwise_add",
                       inputs={"X": input_var, "Y": b},
                       outputs={"Out": out}, attrs={"axis": -1})
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, dict):
            act = dict(act)
            act_type = act.pop("type")
            attrs = act
        else:
            act_type = act
            attrs = {}
        out = self.create_tmp_variable(input_var.dtype,
                                       lod_level=input_var.lod_level,
                                       shape=input_var.shape)
        self.append_op(type=act_type, inputs={"X": input_var},
                       outputs={"Out": out}, attrs=attrs)
        return out
