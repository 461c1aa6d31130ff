"""Unary, comparison and logical layers: the subset of
``paddle_tpu/layers/ops.py`` that the port's models build with (the
decoder LM and the Transformer NMT model; sigmoid and square for
DeepFM)."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _unary

_UNARY_OPS = ["sigmoid", "square"]
_CMP_OPS = ["equal", "less_than", "less_equal"]

__all__ = list(_UNARY_OPS) + list(_CMP_OPS) + ["logical_not"]

sigmoid = _unary("sigmoid")
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


equal = _make_cmp("equal")
less_than = _make_cmp("less_than")
less_equal = _make_cmp("less_equal")


def logical_not(x, name=None):
    helper = LayerHelper("logical_not", name=name)
    out = helper.create_tmp_variable("bool", lod_level=x.lod_level)
    out.stop_gradient = True
    helper.append_op(type="logical_not", inputs={"X": x},
                     outputs={"Out": out})
    return out
