"""Tensor-construction and manipulation layers: the subset of
``paddle_tpu/layers/tensor.py`` that the decoder LM, the Transformer
NMT model and the GRU encoder-decoder build with."""
from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper

__all__ = ["create_parameter", "cast", "concat", "assign",
           "fill_constant", "fill_constant_batch_size_like", "zeros_like",
           "ones_like", "reshape", "transpose", "unsqueeze", "gather",
           "one_hot", "argmax", "range", "slice"]


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    helper = LayerHelper("create_parameter")
    from ..layer_helper import ParamAttr
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_tmp_variable(dtype, lod_level=x.lod_level)
    helper.append_op(type="cast", inputs={"X": x}, outputs={"Out": out},
                     attrs={"out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    """Concatenate along `axis`. The declared shape sums the axis' extents
    when every input has a known shape of one rank (-1 if any extent is
    unknown); an axis outside the declared rank (ragged vars declare their
    feature dims only) leaves the shape to the runtime op."""
    helper = LayerHelper("concat", name=name)
    shape = None
    ranks = {len(v.shape) for v in input if v.shape is not None}
    if len(ranks) == 1 and all(v.shape is not None for v in input):
        shape = list(input[0].shape)
        ax = axis if axis >= 0 else len(shape) + axis
        if 0 <= ax < len(shape):
            dims = [v.shape[ax] for v in input]
            shape[ax] = -1 if any(d is None or d < 0 for d in dims) \
                else sum(dims)
        else:
            shape = None
    out = helper.create_tmp_variable(input[0].dtype,
                                     lod_level=input[0].lod_level,
                                     shape=shape)
    helper.append_op(type="concat", inputs={"X": list(input)},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        output = output or helper.create_tmp_variable(str(input.dtype))
        helper.append_op(type="assign_value", outputs={"Out": output},
                         attrs={"shape": list(input.shape),
                                "dtype": str(input.dtype),
                                "values": input.reshape(-1).tolist()})
    else:
        output = output or helper.create_tmp_variable(input.dtype)
        helper.append_op(type="assign", inputs={"X": input},
                         outputs={"Out": output})
    return output


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    out = out or helper.create_tmp_variable(dtype, shape=list(shape))
    helper.append_op(type="fill_constant", outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": input}, outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    out = out or helper.create_tmp_variable(x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": x},
                     outputs={"Out": out})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    out = out or helper.create_tmp_variable(x.dtype)
    helper.append_op(type="fill_constant_like", inputs={"X": x},
                     outputs={"Out": out}, attrs={"value": 1.0})
    return out


def reshape(x, shape, inplace=False, name=None, act=None):
    helper = LayerHelper("reshape", name=name, act=act)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="reshape", inputs={"X": x}, outputs={"Out": out},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="transpose", inputs={"X": x},
                     outputs={"Out": out}, attrs={"axis": list(perm)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="unsqueeze", inputs={"X": input},
                     outputs={"Out": out}, attrs={"axes": axes})
    return out


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="gather", inputs={"X": input, "Index": index},
                     outputs={"Out": out})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_tmp_variable("float32")
    helper.append_op(type="one_hot", inputs={"X": input},
                     outputs={"Out": out}, attrs={"depth": depth})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("argmax")
    out = helper.create_tmp_variable("int64")
    helper.append_op(type="arg_max", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def range(start, end, step, dtype="int64"):  # noqa: A001 — reference name
    helper = LayerHelper("range")
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="range", outputs={"Out": out},
                     attrs={"start": start, "end": end, "step": step})
    return out


def slice(input, axes, starts, ends):  # noqa: A001 — reference name
    helper = LayerHelper("slice")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="slice", inputs={"Input": input},
                     outputs={"Out": out},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out
