"""Operator overloading on Variable: the port's copy of
``paddle_tpu/layers/math_op_patch.py`` (reference:
python/paddle/fluid/layers/math_op_patch.py). ``0 * ones_like(ids)`` in
the Transformer's pad mask builds its `scale` op through it."""
from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper


def _scalar_op(var, scale, bias):
    helper = LayerHelper("scale")
    out = helper.create_tmp_variable(var.dtype, lod_level=var.lod_level)
    helper.append_op(type="scale", inputs={"X": var}, outputs={"Out": out},
                     attrs={"scale": float(scale), "bias": float(bias)})
    return out


def _binary_creator(op_type, reverse=False):
    def __impl__(self, other):
        if isinstance(other, (int, float)):
            if op_type == "elementwise_add":
                return _scalar_op(self, 1.0, other)
            if op_type == "elementwise_sub":
                if reverse:
                    return _scalar_op(self, -1.0, other)
                return _scalar_op(self, 1.0, -other)
            if op_type == "elementwise_mul":
                return _scalar_op(self, other, 0.0)
            if op_type == "elementwise_div" and not reverse:
                return _scalar_op(self, 1.0 / other, 0.0)
            # fall through: build a constant like self (handles -1 batch dim)
            val = other
            helper_c = LayerHelper("const_like")
            other = helper_c.create_tmp_variable(self.dtype,
                                                 lod_level=self.lod_level)
            helper_c.append_op(type="fill_constant_like",
                               inputs={"X": self}, outputs={"Out": other},
                               attrs={"value": float(val)})
        helper = LayerHelper(op_type)
        out = helper.create_tmp_variable(self.dtype,
                                         lod_level=self.lod_level)
        x, y = (other, self) if reverse else (self, other)
        helper.append_op(type=op_type, inputs={"X": x, "Y": y},
                         outputs={"Out": out}, attrs={"axis": -1})
        return out
    return __impl__


def monkey_patch_variable():
    Variable.__add__ = _binary_creator("elementwise_add")
    Variable.__radd__ = _binary_creator("elementwise_add")
    Variable.__sub__ = _binary_creator("elementwise_sub")
    Variable.__rsub__ = _binary_creator("elementwise_sub", reverse=True)
    Variable.__mul__ = _binary_creator("elementwise_mul")
    Variable.__rmul__ = _binary_creator("elementwise_mul")
    Variable.__truediv__ = _binary_creator("elementwise_div")
    Variable.__rtruediv__ = _binary_creator("elementwise_div", reverse=True)
    Variable.__pow__ = _binary_creator("elementwise_pow")
    Variable.__lt__ = _binary_creator("less_than")
    Variable.__le__ = _binary_creator("less_equal")
    Variable.__gt__ = _binary_creator("greater_than")
    Variable.__ge__ = _binary_creator("greater_equal")
    Variable.__neg__ = lambda self: _scalar_op(self, -1.0, 0.0)
