"""Neural-net layer functions: the subset of ``paddle_tpu/layers/nn.py``
that the port's models build with: the decoder LM, the Transformer NMT
model, the LSTM LM, the GRU encoder-decoder of the book's
machine-translation chapter, and the conv models (MNIST, ResNet,
SE-ResNeXt, VGG, GoogLeNet, AlexNet): fc, embedding, dynamic_lstm,
dynamic_gru, conv2d, pool2d, batch_norm, layer_norm, lrn, dropout,
cross_entropy, softmax_with_cross_entropy,
sigmoid_cross_entropy_with_logits, square_error_cost, accuracy,
topk, relu, matmul, softmax, mean, reduce_sum,
elementwise_add/sub/mul/div/max, scale, increment,
scaled_dot_product_attention;
and the sequence layers: sequence_pool, sequence_first_step,
sequence_last_step, sequence_reverse, nested_sequence_flatten,
nested_sequence_pack, sequence_conv, sequence_softmax, sequence_expand,
sequence_reshape, sequence_mask, sequence_pad, sequence_unpad, row_conv,
warpctc, lstm_unit, gru_unit, dynamic_lstmp and ctc_greedy_decoder;
cos_sim, linear_chain_crf and crf_decoding (the book's recommender and
semantic-role chapters).
Each function appends the same ops, with the same attrs and var names,
as its JAX-package counterpart."""
from __future__ import annotations

import math

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper, ParamAttr

__all__ = ["fc", "embedding", "increment", "dynamic_lstm", "dynamic_gru",
           "conv2d",
           "pool2d", "batch_norm", "layer_norm", "lrn", "dropout",
           "cross_entropy", "softmax_with_cross_entropy",
           "sigmoid_cross_entropy_with_logits", "square_error_cost",
           "accuracy",
           "topk", "sequence_pool", "relu", "matmul", "softmax", "mean",
           "reduce_sum",
           "sequence_first_step", "sequence_last_step", "sequence_reverse",
           "nested_sequence_flatten", "nested_sequence_pack",
           "sequence_conv", "sequence_softmax", "sequence_expand",
           "sequence_reshape", "sequence_mask", "sequence_pad",
           "sequence_unpad", "row_conv", "warpctc", "lstm_unit",
           "gru_unit", "dynamic_lstmp", "ctc_greedy_decoder",
           "elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "scale",
           "scaled_dot_product_attention", "cos_sim", "linear_chain_crf",
           "crf_decoding"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None, dtype=None):
    """Fully-connected layer. Multiple inputs are projected separately
    and summed."""
    helper = LayerHelper("fc", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    dtype = dtype or inputs[0].dtype
    mul_results = []
    for inp in inputs:
        in_shape = inp.shape
        flat_dim = 1
        for d in in_shape[num_flatten_dims:]:
            flat_dim *= int(d)
        w = helper.create_parameter(helper.param_attr,
                                    shape=[flat_dim, size], dtype=dtype)
        out_shape = list(in_shape[:num_flatten_dims]) + [size]
        tmp = helper.create_tmp_variable(dtype, lod_level=inp.lod_level,
                                         shape=out_shape)
        helper.append_op(type="mul", inputs={"X": inp, "Y": w},
                         outputs={"Out": tmp},
                         attrs={"x_num_col_dims": num_flatten_dims
                                if inp.lod_level == 0 else inp.lod_level + 1,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": pre_bias})
    pre_act = helper.append_bias_op(pre_bias, size=size)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32",
              shard_axis="model"):
    """Embedding lookup. is_distributed/shard_axis are recorded in the
    op's attrs for IR parity; the port looks up on one device."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype)
    out = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    helper.append_op(type="lookup_table",
                     inputs={"W": w, "Ids": input}, outputs={"Out": out},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "shard_axis": shard_axis,
                            "padding_idx": -1 if padding_idx is None
                            else padding_idx})
    return out


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """Dynamic-length LSTM over a ragged input of gate pre-activations
    [*, 4*hidden] (reference: layers/nn.py:277 / lstm_op.cc)."""
    helper = LayerHelper("dynamic_lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden_size = size // 4
    w = helper.create_parameter(helper.param_attr,
                                shape=[hidden_size, 4 * hidden_size],
                                dtype=dtype)
    bias_size = 4 * hidden_size if not use_peepholes else 7 * hidden_size
    b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                shape=[1, bias_size], dtype=dtype,
                                is_bias=True)
    hidden = helper.create_tmp_variable(dtype, lod_level=1,
                                        shape=[-1, hidden_size])
    cell = helper.create_tmp_variable(dtype, lod_level=1,
                                      shape=[-1, hidden_size])
    last_h = helper.create_tmp_variable(dtype, shape=[-1, hidden_size])
    last_c = helper.create_tmp_variable(dtype, shape=[-1, hidden_size])
    inputs = {"Input": input, "Weight": w, "Bias": b}
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op(type="lstm", inputs=inputs,
                     outputs={"Hidden": hidden, "Cell": cell,
                              "LastH": last_h, "LastC": last_c},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None, h_0=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", dtype="float32"):
    """Dynamic-length GRU over a ragged input of gate pre-activations
    [*, 3*size] (reference: gru_op.cc): weight [size, 3*size], bias
    [1, 3*size]; returns the ragged hidden states."""
    helper = LayerHelper("dynamic_gru", param_attr=param_attr,
                         bias_attr=bias_attr)
    w = helper.create_parameter(helper.param_attr, shape=[size, 3 * size],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                shape=[1, 3 * size], dtype=dtype,
                                is_bias=True)
    hidden = helper.create_tmp_variable(dtype, lod_level=1,
                                        shape=[-1, size])
    last_h = helper.create_tmp_variable(dtype, shape=[-1, size])
    inputs = {"Input": input, "Weight": w, "Bias": b}
    if h_0 is not None:
        inputs["H0"] = h_0
    helper.append_op(type="gru", inputs=inputs,
                     outputs={"Hidden": hidden, "LastH": last_h},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "activation": candidate_activation})
    return hidden


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           use_cudnn=True, name=None):
    """2-D convolution, NCHW; the filter's default init is
    Normal(0, sqrt(2 / fan_in))."""
    helper = LayerHelper("conv2d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = int(input.shape[1])
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, math.sqrt(2.0 / fan_in)))
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(type="conv2d",
                     inputs={"Input": input, "Filter": w},
                     outputs={"Output": pre_bias},
                     attrs={"strides": _pair(stride),
                            "paddings": _pair(padding),
                            "dilations": _pair(dilation),
                            "groups": groups})
    pre_act = _append_channel_bias(helper, pre_bias, num_filters)
    return helper.append_activation(pre_act)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _append_channel_bias(helper, pre_bias, channels=None):
    bias_attr = helper.bias_attr
    if bias_attr is None:
        return pre_bias
    if channels is None:
        channels = int(pre_bias.shape[1]) if pre_bias.shape else None
    b = helper.create_parameter(bias_attr, shape=[channels],
                                dtype=pre_bias.dtype, is_bias=True)
    out = helper.create_tmp_variable(pre_bias.dtype)
    helper.append_op(type="elementwise_add",
                     inputs={"X": pre_bias, "Y": b},
                     outputs={"Out": out}, attrs={"axis": 1})
    return out


def pool2d(input, pool_size=2, pool_type="max", pool_stride=2,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="pool2d", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"pooling_type": pool_type,
                            "ksize": _pair(pool_size),
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding),
                            "global_pooling": global_pooling,
                            "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None):
    """Batch normalization with persistable moving statistics (initialized
    to 0 and 1), updated in place by the op."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    ch = int(input.shape[1] if data_layout == "NCHW" else input.shape[-1])
    scale = helper.create_parameter(
        helper.param_attr, shape=[ch], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                   shape=[ch], dtype=dtype, is_bias=True)
    mean = helper.create_global_variable(
        shape=[ch], dtype=dtype, persistable=True,
        name=moving_mean_name or None)
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        shape=[ch], dtype=dtype, persistable=True,
        name=moving_variance_name or None)
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    mean.stop_gradient = True
    variance.stop_gradient = True

    saved_mean = helper.create_tmp_variable(dtype)
    saved_var = helper.create_tmp_variable(dtype)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="batch_norm",
                     inputs={"X": input, "Scale": scale, "Bias": bias,
                             "Mean": mean, "Variance": variance},
                     outputs={"Y": out, "MeanOut": mean,
                              "VarianceOut": variance,
                              "SavedMean": saved_mean,
                              "SavedVariance": saved_var},
                     attrs={"momentum": momentum, "epsilon": epsilon,
                            "is_test": is_test,
                            "data_layout": data_layout})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_dim = 1
    for d in input.shape[begin_norm_axis:]:
        norm_dim *= int(d)
    inputs = {"X": input}
    if scale:
        s = helper.create_parameter(
            helper.param_attr, shape=[norm_dim], dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = s
    if shift:
        b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                    shape=[norm_dim], dtype=dtype,
                                    is_bias=True)
        inputs["Bias"] = b
    out = helper.create_tmp_variable(dtype)
    mean = helper.create_tmp_variable(dtype)
    var = helper.create_tmp_variable(dtype)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": out, "Mean": mean, "Variance": var},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """Local response normalization across channels (the lrn op; the
    layer's k default 1.0 is written into the op's attrs)."""
    helper = LayerHelper("lrn", name=name)
    out = helper.create_tmp_variable(input.dtype)
    mid = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="lrn", inputs={"X": input},
                     outputs={"Out": out, "MidOut": mid},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def cos_sim(x, y):
    helper = LayerHelper("cos_sim")
    out = helper.create_tmp_variable(x.dtype)
    xn = helper.create_tmp_variable(x.dtype)
    yn = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="cos_sim", inputs={"X": x, "Y": y},
                     outputs={"Out": out, "XNorm": xn, "YNorm": yn})
    return out


def linear_chain_crf(input, label, param_attr=None):
    """Linear-chain CRF negative log-likelihood over ragged sequences.
    Creates the [num_tags + 2, num_tags] transition parameter (rows 0
    and 1 are the start and end weights)."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    num_tags = int(input.shape[-1])
    transition = helper.create_parameter(
        helper.param_attr, shape=[num_tags + 2, num_tags],
        dtype=input.dtype)
    ll = helper.create_tmp_variable(input.dtype)
    alpha = helper.create_tmp_variable(input.dtype)
    em_exps = helper.create_tmp_variable(input.dtype)
    tr_exps = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="linear_chain_crf",
                     inputs={"Emission": input, "Label": label,
                             "Transition": transition},
                     outputs={"LogLikelihood": ll, "Alpha": alpha,
                              "EmissionExps": em_exps,
                              "TransitionExps": tr_exps})
    return ll


def crf_decoding(input, param_attr=None, label=None):
    """Viterbi decode with a CRF transition parameter: the one
    linear_chain_crf created under the same ParamAttr name, else a new
    one (an inference program loads it by name). With `label`, emits
    per-position 0/1 correctness instead of the path."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    attr = helper.param_attr
    num_tags = int(input.shape[-1])
    if attr is not None and attr.name is not None and \
            helper.main_program.global_block().has_var(attr.name):
        transition = helper.main_program.global_block().var(attr.name)
    else:
        transition = helper.create_parameter(
            attr, shape=[num_tags + 2, num_tags], dtype=input.dtype)
    path = helper.create_tmp_variable("int64", lod_level=input.lod_level)
    inputs = {"Emission": input, "Transition": transition}
    if label is not None:
        inputs["Label"] = label
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": path})
    return path


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    mask = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="dropout", inputs={"X": x},
                     outputs={"Out": out, "Mask": mask},
                     attrs={"dropout_prob": dropout_prob,
                            "is_test": is_test,
                            "seed": seed
                            or helper.main_program.desc.next_seed(),
                            "dropout_implementation": dropout_implementation})
    return out


def cross_entropy(input, label, soft_label=False):
    helper = LayerHelper("cross_entropy")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": input, "Label": label},
                     outputs={"Y": out}, attrs={"soft_label": soft_label})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_tmp_variable(logits.dtype)
    loss = helper.create_tmp_variable(logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": logits, "Label": label},
                     outputs={"Softmax": softmax, "Loss": loss},
                     attrs={"soft_label": soft_label})
    return loss


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": x, "Label": label}, outputs={"Out": out})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="square_error_cost",
                     inputs={"X": input, "Y": label}, outputs={"Out": out})
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    """Classification accuracy: top_k over `input`, then the accuracy op
    against `label`."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_tmp_variable(input.dtype)
    topk_indices = helper.create_tmp_variable("int64")
    helper.append_op(type="top_k", inputs={"X": input},
                     outputs={"Out": topk_out, "Indices": topk_indices},
                     attrs={"k": k})
    acc_out = helper.create_tmp_variable("float32")
    correct = correct or helper.create_tmp_variable("int32")
    total = total or helper.create_tmp_variable("int32")
    helper.append_op(type="accuracy",
                     inputs={"Out": topk_out, "Indices": topk_indices,
                             "Label": label},
                     outputs={"Accuracy": acc_out, "Correct": correct,
                              "Total": total})
    return acc_out


def topk(input, k):
    helper = LayerHelper("top_k")
    values = helper.create_tmp_variable(input.dtype)
    indices = helper.create_tmp_variable("int64")
    helper.append_op(type="top_k", inputs={"X": input},
                     outputs={"Out": values, "Indices": indices},
                     attrs={"k": k})
    return values, indices


def sequence_pool(input, pool_type):
    helper = LayerHelper("sequence_pool")
    # reduction keeps the per-step feature shape
    out = helper.create_tmp_variable(
        input.dtype, shape=list(input.shape) if input.shape else None)
    # both spellings circulate: fluid pool2d-style "avg", v2 "average"
    ptype = {"AVG": "AVERAGE"}.get(pool_type.upper(), pool_type.upper())
    helper.append_op(type="sequence_pool", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"pooltype": ptype})
    return out


def sequence_first_step(input):
    helper = LayerHelper("sequence_first_step")
    out = helper.create_tmp_variable(
        input.dtype, shape=list(input.shape) if input.shape else None)
    helper.append_op(type="sequence_first_step", inputs={"X": input},
                     outputs={"Out": out})
    return out


def sequence_last_step(input):
    helper = LayerHelper("sequence_last_step")
    out = helper.create_tmp_variable(
        input.dtype, shape=list(input.shape) if input.shape else None)
    helper.append_op(type="sequence_last_step", inputs={"X": input},
                     outputs={"Out": out})
    return out


def sequence_reverse(x, name=None):
    """Reverse each sequence's valid steps (reference:
    sequence_reverse_op.h)."""
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=1)
    helper.append_op(type="sequence_reverse", inputs={"X": x},
                     outputs={"Y": out})
    return out


def nested_sequence_flatten(input):
    """Nested ragged -> one level shallower (level-2
    paragraph->sentence->token becomes a level-1 batch of sub-sequences;
    deeper LoD peels one level per call). See ops/sequence_ops.py."""
    helper = LayerHelper("nested_sequence_flatten")
    out = helper.create_tmp_variable(
        input.dtype, lod_level=max(1, (input.lod_level or 2) - 1))
    helper.append_op(type="nested_sequence_flatten", inputs={"X": input},
                     outputs={"Out": out})
    return out


def nested_sequence_pack(input, ref):
    """Per-sub-sequence dense rows -> level-1 ragged over the outer level
    of `ref` (a level-2 ragged variable)."""
    helper = LayerHelper("nested_sequence_pack")
    # batch dim becomes the outer level; feature dims carry over (shape
    # inference can't see that input's batch is n*max_sub of ref)
    shape = ([-1] + list(input.shape[1:])) if input.shape else None
    out = helper.create_tmp_variable(input.dtype, lod_level=1, shape=shape)
    helper.append_op(type="nested_sequence_pack",
                     inputs={"X": input, "Ref": ref},
                     outputs={"Out": out})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None):
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act)
    dtype = input.dtype
    in_dim = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr,
                                shape=[filter_size * in_dim, num_filters],
                                dtype=dtype)
    pre_bias = helper.create_tmp_variable(dtype, lod_level=1)
    helper.append_op(type="sequence_conv",
                     inputs={"X": input, "Filter": w},
                     outputs={"Out": pre_bias},
                     attrs={"contextLength": filter_size,
                            "contextStart": -(filter_size // 2),
                            "contextStride": filter_stride})
    pre_act = helper.append_bias_op(pre_bias, size=num_filters)
    return helper.append_activation(pre_act)


def sequence_softmax(input):
    helper = LayerHelper("sequence_softmax")
    out = helper.create_tmp_variable(input.dtype, lod_level=1)
    helper.append_op(type="sequence_softmax", inputs={"X": input},
                     outputs={"Out": out})
    return out


def sequence_expand(x, y, ref_level=-1):
    helper = LayerHelper("sequence_expand")
    out = helper.create_tmp_variable(x.dtype, lod_level=1)
    helper.append_op(type="sequence_expand", inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"ref_level": ref_level})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape")
    out = helper.create_tmp_variable(input.dtype, lod_level=1)
    helper.append_op(type="sequence_reshape", inputs={"X": input},
                     outputs={"Out": out}, attrs={"new_dim": new_dim})
    return out


def sequence_mask(x, maxlen, dtype="float32"):
    helper = LayerHelper("sequence_mask")
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="sequence_mask", inputs={"X": x},
                     outputs={"Y": out}, attrs={"maxlen": maxlen})
    return out


def sequence_pad(x, pad_value=None, maxlen=None):
    helper = LayerHelper("sequence_pad")
    out = helper.create_tmp_variable(x.dtype)
    length = helper.create_tmp_variable("int64")
    helper.append_op(type="sequence_pad", inputs={"X": x},
                     outputs={"Out": out, "Length": length})
    return out, length


def sequence_unpad(x, length):
    helper = LayerHelper("sequence_unpad")
    out = helper.create_tmp_variable(x.dtype, lod_level=1)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": x, "Length": length},
                     outputs={"Out": out})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    dtype = input.dtype
    d = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr,
                                shape=[future_context_size + 1, d],
                                dtype=dtype)
    out = helper.create_tmp_variable(dtype, lod_level=1)
    helper.append_op(type="row_conv",
                     inputs={"X": input, "Filter": w},
                     outputs={"Out": out})
    return helper.append_activation(out)


def warpctc(input, label, blank=0, norm_by_times=False):
    """CTC loss over ragged logits/labels (reference: warpctc_op.cc wraps
    the warp-ctc CUDA lib; here the alpha recursion in torch ops)."""
    helper = LayerHelper("warpctc")
    loss = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="warpctc",
                     inputs={"Logits": input, "Label": label},
                     outputs={"Loss": loss},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


# -- single-step RNN cells (reference: nn.py lstm_unit:  gru_unit:) ---------

def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: projects [x_t, h_prev] to 4*d gates then applies the
    cell update (reference: nn.py lstm_unit — built on lstm_unit op)."""
    helper = LayerHelper("lstm_unit", name=name)
    d = cell_t_prev.shape[-1]
    concat_in = fc(x_t, size=4 * d, bias_attr=bias_attr,
                   param_attr=param_attr)
    h_proj = fc(hidden_t_prev, size=4 * d, bias_attr=False)
    gates = helper.create_tmp_variable(x_t.dtype)
    helper.append_op(type="elementwise_add",
                     inputs={"X": concat_in, "Y": h_proj},
                     outputs={"Out": gates})
    c = helper.create_tmp_variable(x_t.dtype)
    h = helper.create_tmp_variable(x_t.dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": gates, "C_prev": cell_t_prev},
                     outputs={"C": c, "H": h},
                     attrs={"forget_bias": float(forget_bias)})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step (reference: nn.py gru_unit). size = 3*d."""
    helper = LayerHelper("gru_unit")
    d = size // 3
    weight = helper.create_parameter(attr=param_attr, shape=[d, 3 * d],
                                     dtype=input.dtype)
    bias = helper.create_parameter(attr=bias_attr, shape=[1, 3 * d],
                                   dtype=input.dtype, is_bias=True)
    gate = helper.create_tmp_variable(input.dtype)
    reset_h = helper.create_tmp_variable(input.dtype)
    hid = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="gru_unit",
                     inputs={"Input": input, "HiddenPrev": hidden,
                             "Weight": weight, "Bias": bias},
                     outputs={"Gate": gate, "ResetHiddenPrev": reset_h,
                              "Hidden": hid},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation})
    return hid, reset_h, gate


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=False, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  name=None):
    """Projected LSTM over ragged input (reference: nn.py dynamic_lstmp:
    input already projected to [*, 4*d]; recurrence on the p-dim
    projection)."""
    helper = LayerHelper("dynamic_lstmp", name=name)
    d = size // 4
    weight = helper.create_parameter(attr=param_attr, shape=[proj_size, 4 * d],
                                     dtype=input.dtype)
    proj_weight = helper.create_parameter(attr=param_attr,
                                          shape=[d, proj_size],
                                          dtype=input.dtype)
    # peepholes pack W_ic/W_fc/W_oc after the gate bias (reference layout)
    bias_size = 7 * d if use_peepholes else 4 * d
    bias = helper.create_parameter(attr=bias_attr, shape=[1, bias_size],
                                   dtype=input.dtype, is_bias=True)
    proj = helper.create_tmp_variable(input.dtype, lod_level=input.lod_level)
    cell = helper.create_tmp_variable(input.dtype, lod_level=input.lod_level)
    last_h = helper.create_tmp_variable(input.dtype)
    last_c = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="lstmp",
                     inputs={"Input": input, "Weight": weight,
                             "ProjWeight": proj_weight, "Bias": bias},
                     outputs={"Projection": proj, "Cell": cell,
                              "LastH": last_h, "LastC": last_c},
                     attrs={"gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation,
                            "proj_activation": proj_activation,
                            "use_peepholes": use_peepholes,
                            "is_reverse": is_reverse})
    return proj, cell


def ctc_greedy_decoder(input, blank, name=None):
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    out = helper.create_tmp_variable("int32", lod_level=1)
    helper.append_op(type="ctc_greedy_decoder", inputs={"Input": input},
                     outputs={"Out": out}, attrs={"blank": blank})
    return out


def _unary(op_type):
    def fn(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
        helper.append_op(type=op_type, inputs={"X": x},
                         outputs={"Out": out})
        return out
    fn.__name__ = op_type
    return fn


relu = _unary("relu")


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="matmul", inputs={"X": x, "Y": y},
                     outputs={"Out": out},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def softmax(input, axis=-1, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="softmax", inputs={"X": input},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_tmp_variable(x.dtype, shape=[1])
    helper.append_op(type="mean", inputs={"X": x}, outputs={"Out": out})
    return out


def _reduce(op_type):
    def fn(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(input.dtype)
        helper.append_op(type=op_type, inputs={"X": input},
                         outputs={"Out": out},
                         attrs={"dim": dim, "keep_dim": keep_dim,
                                "reduce_all": dim is None})
        return out
    fn.__name__ = op_type
    return fn


reduce_sum = _reduce("reduce_sum")


def _binary(op_type):
    def fn(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
        helper.append_op(type=op_type, inputs={"X": x, "Y": y},
                         outputs={"Out": out}, attrs={"axis": axis})
        return helper.append_activation(out)
    fn.__name__ = op_type
    return fn


elementwise_add = _binary("elementwise_add")
elementwise_sub = _binary("elementwise_sub")
elementwise_mul = _binary("elementwise_mul")
elementwise_div = _binary("elementwise_div")
elementwise_max = _binary("elementwise_max")


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_tmp_variable(x.dtype)
    helper.append_op(type="increment", inputs={"X": x},
                     outputs={"Out": out}, attrs={"step": float(value)})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    helper.append_op(type="scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Attention over [B, Sq, D] queries and [B, Sk, D] keys/values (or
    [B, H, S, D]); the output keeps the queries' lod_level.
    num_heads and dropout_rate are accepted for the reference's API and
    not recorded, as in the JAX package."""
    helper = LayerHelper("scaled_dot_product_attention")
    shape = None
    if queries.shape is not None and values.shape is not None:
        shape = list(queries.shape[:-1]) + [values.shape[-1]]
    out = helper.create_tmp_variable(queries.dtype,
                                     lod_level=queries.lod_level,
                                     shape=shape)
    helper.append_op(type="scaled_dot_product_attention",
                     inputs={"Q": queries, "K": keys, "V": values},
                     outputs={"Out": out})
    return out
