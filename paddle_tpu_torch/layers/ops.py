"""Comparison layers: the subset of ``paddle_tpu/layers/ops.py`` that the
decoder LM builds with."""
from __future__ import annotations

from ..layer_helper import LayerHelper

_CMP_OPS = ["less_than", "less_equal"]

__all__ = list(_CMP_OPS)


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


less_than = _make_cmp("less_than")
less_equal = _make_cmp("less_equal")
