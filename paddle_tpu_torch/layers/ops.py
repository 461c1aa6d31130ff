"""Unary, comparison and logical layers: the subset of
``paddle_tpu/layers/ops.py`` that the port's models build with (the
decoder LM and the Transformer NMT model; sigmoid and square for
DeepFM; tanh, the comparisons and the logical ops of the
control-flow programs)."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _unary

_UNARY_OPS = ["sigmoid", "tanh", "square"]
_CMP_OPS = ["equal", "not_equal", "less_than", "less_equal",
            "greater_than", "greater_equal", "logical_and", "logical_or"]

__all__ = list(_UNARY_OPS) + list(_CMP_OPS) + ["logical_not"]

sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
square = _unary("square")


def _make_cmp(op_type):
    def fn(x, y, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable("bool", lod_level=x.lod_level)
        out.stop_gradient = True
        helper.append_op(type=op_type, inputs={"X": x, "Y": y},
                         outputs={"Out": out}, attrs={"axis": -1})
        return out
    fn.__name__ = op_type
    return fn


for _op in _CMP_OPS:
    globals()[_op] = _make_cmp(_op)


def logical_not(x, name=None):
    helper = LayerHelper("logical_not", name=name)
    out = helper.create_tmp_variable("bool", lod_level=x.lod_level)
    out.stop_gradient = True
    helper.append_op(type="logical_not", inputs={"X": x},
                     outputs={"Out": out})
    return out
