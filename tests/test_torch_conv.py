"""The conv path's ops in paddle_tpu_torch against paddle_tpu, each as a
small program run in both executors on the same numpy inputs.

- conv2d with padding, stride, dilation and groups, and the strided 1x1
  conv that both packages rewrite as slice-then-convolve; pool2d max with
  padding (-inf), exclusive and inclusive avg, and global; batch_norm in
  train mode (Y, the running statistics, SavedMean and SavedVariance =
  rsqrt(var + eps)) over a channel with a large mean, and in is_test
  mode; cross_entropy with hard and soft labels; softmax; top_k;
  accuracy; tanh. Forward values, and the gradients of the float inputs
  under a loss that weights the output with a random cotangent (the
  ``__vjp__`` replay of each op).
- batch_norm's running statistics move once a step: two train steps of a
  program that writes them in place (its backward replays the op) leave
  mean * m^2 + batch_mean * (1 - m)(1 + m) in both packages.
- momentum, plain and Nesterov, one update.
- gaussian_random: the shape, dtype and moments of the port's draw (it
  draws torch's bits, not JAX's, so the values are not compared), and
  the same values for the same seed.

Every program is built by both packages' builders and serializes to
equal JSON (build-time shape inference included).
Tolerance: float32, the same sums in another order: rtol 1e-5, atol
1e-5 * max(|reference|, 1); batch_norm adds the rounding of its
single-pass variance, 8 * 2^-24 * max over channels of E[x^2] / var
(see BN_ROUNDING).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu.core.backward import append_backward as ref_append_backward
from paddle_tpu_torch import framework
from paddle_tpu_torch.core.backward import append_backward

RTOL = 1e-5
# batch_norm's single-pass variance E[x^2] - mean^2 (both packages' form)
# loses float32 digits in proportion to E[x^2] / var: its rounding,
# ~2^-24 per term summed in another order, moves var by up to
# BN_ROUNDING * E[x^2] / var relatively, and everything computed from it
BN_ROUNDING = 8 * 2.0 ** -24
REF = (pt, ref_framework, ref_append_backward)
PORT = (ptt, framework, append_backward)


def _program(pkg, vars_, ops, loss=None, wrt=()):
    """`ops` [(type, inputs, outputs, attrs)] over `vars_` {name: (shape,
    dtype, stop_gradient, persistable)}; with `loss`, the backward of
    reduce_sum(loss * cotangent "ct") w.r.t. `wrt`."""
    _, fw, backward = pkg
    main = fw.Program()
    with fw.isolated_name_scope():
        blk = main.global_block()
        for name, (shape, dtype, stop, persist) in vars_.items():
            blk.create_var(name=name, shape=shape, dtype=dtype,
                           stop_gradient=stop, persistable=persist)
        if loss is not None:
            ops = list(ops) + [
                ("elementwise_mul", {"X": [loss], "Y": ["ct"]},
                 {"Out": ["weighted"]}, {"axis": -1}),
                ("reduce_sum", {"X": ["weighted"]}, {"Out": ["total"]},
                 {"dim": None, "keep_dim": False, "reduce_all": True})]
        for op_type, ins, outs, attrs in ops:
            for names in outs.values():
                for n in names:
                    if not blk.has_var(n):
                        blk.create_var(name=n, dtype=None)
            blk.append_op(op_type, ins, outs, dict(attrs))
        if loss is not None:
            backward(blk.var("total"), parameter_list=list(wrt))
    return main


def _run(pkg, main, feed, fetch, scope=None):
    mod = pkg[0]
    exe = mod.Executor() if mod is pt else mod.Executor(place="cpu")
    return [np.asarray(v) for v in exe.run(
        main, feed=feed, fetch_list=fetch,
        scope=mod.Scope() if scope is None else scope)]


def _both(vars_, ops, feed, fetch, loss=None, wrt=()):
    """Build and run in both packages: (reference fetches, port
    fetches), after holding their JSON equal."""
    if loss is not None:
        # the cotangent takes the loss var's declared shape (-1 batch
        # included) and, from one forward run of the port, its extents
        fwd = _program(PORT, vars_, ops)
        shape = _run(PORT, fwd, feed, [loss])[0].shape
        vars_ = dict(vars_, ct=(list(fwd.global_block().var(loss).shape),
                                "float32", True, False))
        feed = dict(feed, ct=np.random.RandomState(99).randn(*shape)
                    .astype(np.float32))
        fetch = list(fetch) + [n + "@GRAD" for n in wrt]
    mains = [_program(pkg, vars_, ops, loss, wrt) for pkg in (REF, PORT)]
    assert json.loads(mains[0].desc.to_json()) == \
        json.loads(mains[1].desc.to_json())
    return (_run(REF, mains[0], feed, fetch),
            _run(PORT, mains[1], feed, fetch))


def _hold(ref, got, names, rtol=RTOL):
    for name, r, g in zip(names, ref, got):
        assert g.shape == r.shape, f"{name}: {g.shape} vs {r.shape}"
        assert g.dtype == r.dtype or (g.dtype == np.int64
                                      and r.dtype == np.int32), name
        np.testing.assert_allclose(
            g, r, rtol=rtol,
            atol=rtol * max(float(np.abs(r).max(initial=0)), 1.0),
            err_msg=name)


def _bn_rtol(x, ch_axis=1):
    """RTOL plus the single-pass variance's rounding for input x."""
    red = tuple(i for i in range(x.ndim) if i != ch_axis)
    x = x.astype(np.float64)
    ratio = (x ** 2).mean(axis=red) / x.var(axis=red)
    return RTOL + BN_ROUNDING * float(ratio.max())


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# -- conv2d -----------------------------------------------------------------

# (x shape, filter shape, attrs): padding, stride, dilation, groups, the
# strided 1x1 rewrite, and a 1x1 with padding (not rewritten)
CONV_CASES = [
    ((2, 3, 9, 9), (4, 3, 3, 3), dict(strides=[1, 1], paddings=[1, 1])),
    ((2, 3, 10, 9), (5, 3, 3, 2), dict(strides=[2, 1], paddings=[1, 0])),
    ((1, 2, 11, 11), (3, 2, 3, 3), dict(dilations=[2, 2], paddings=[2, 2])),
    ((2, 4, 7, 7), (6, 2, 3, 3), dict(groups=2, paddings=[1, 1])),
    ((2, 8, 10, 10), (6, 8, 1, 1), dict(strides=[2, 2])),
    ((2, 3, 5, 5), (4, 3, 1, 1), dict(strides=[2, 2], paddings=[1, 1])),
]


@pytest.mark.parametrize("xs,ws,attrs", CONV_CASES)
def test_conv2d_matches_reference(xs, ws, attrs):
    rng = np.random.RandomState(sum(xs) + sum(ws))
    attrs = dict(dict(strides=[1, 1], paddings=[0, 0], dilations=[1, 1],
                      groups=1), **attrs)
    vars_ = {"x": (list(xs), "float32", False, False),
             "w": (list(ws), "float32", False, False)}
    ops = [("conv2d", {"Input": ["x"], "Filter": ["w"]},
            {"Output": ["y"]}, attrs)]
    feed = {"x": _f32(rng, *xs), "w": _f32(rng, *ws, scale=0.3)}
    fetch = ["y"]
    ref, got = _both(vars_, ops, feed, fetch, loss="y", wrt=["x", "w"])
    _hold(ref, got, fetch + ["x@GRAD", "w@GRAD"])


def test_conv2d_nhwc_layout_knob(monkeypatch):
    """PADDLE_TPU_CONV_LAYOUT=nhwc runs the convs on channels_last copies;
    the values stay the reference's."""
    monkeypatch.setenv("PADDLE_TPU_CONV_LAYOUT", "nhwc")
    test_conv2d_matches_reference(*CONV_CASES[1])
    test_conv2d_matches_reference(*CONV_CASES[4])


# -- pool2d -----------------------------------------------------------------

POOL_CASES = [
    dict(pooling_type="max", ksize=[3, 3], strides=[2, 2], paddings=[1, 1]),
    dict(pooling_type="max", ksize=[2, 2], strides=[2, 2], paddings=[0, 0]),
    dict(pooling_type="avg", ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
         exclusive=True),
    dict(pooling_type="avg", ksize=[3, 2], strides=[1, 2], paddings=[1, 1],
         exclusive=False),
    dict(pooling_type="avg", ksize=[2, 2], strides=[2, 2], paddings=[0, 0],
         global_pooling=True),
]


@pytest.mark.parametrize("attrs", POOL_CASES)
def test_pool2d_matches_reference(attrs):
    """Odd extents, so floor output sizes bite; the max case feeds a
    ReLU'd input (ties at 0 inside a window)."""
    rng = np.random.RandomState(3)
    vars_ = {"x": ([2, 3, 9, 7], "float32", False, False)}
    x = _f32(rng, 2, 3, 9, 7)
    if attrs["pooling_type"] == "max":
        x = np.maximum(x, 0.0)
    ref, got = _both(vars_, [("pool2d", {"X": ["x"]}, {"Out": ["y"]},
                              attrs)], {"x": x}, ["y"], loss="y", wrt=["x"])
    _hold(ref, got, ["y", "x@GRAD"])


# -- batch_norm -------------------------------------------------------------

BN_OUTS = ["y", "mean_out", "var_out", "saved_mean", "saved_var"]


def _bn(is_test, shape=(4, 3, 5, 5), layout="NCHW"):
    ch = shape[1] if layout == "NCHW" else shape[-1]
    vars_ = {"x": (list(shape), "float32", False, False),
             "scale": ([ch], "float32", False, False),
             "bias": ([ch], "float32", False, False),
             "mean": ([ch], "float32", True, False),
             "var": ([ch], "float32", True, False)}
    ops = [("batch_norm", {"X": ["x"], "Scale": ["scale"], "Bias": ["bias"],
                           "Mean": ["mean"], "Variance": ["var"]},
            {"Y": ["y"], "MeanOut": ["mean_out"], "VarianceOut": ["var_out"],
             "SavedMean": ["saved_mean"], "SavedVariance": ["saved_var"]},
            {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "data_layout": layout})]
    rng = np.random.RandomState(5)
    x = _f32(rng, *shape)
    # one channel far from 0: E[x^2] - mean^2 and torch.var part there
    idx = [slice(None)] * len(shape)
    idx[1 if layout == "NCHW" else -1] = 1
    x[tuple(idx)] += 30.0
    feed = {"x": x, "scale": _f32(rng, ch) + 1.0,
            "bias": _f32(rng, ch), "mean": _f32(rng, ch),
            "var": np.abs(_f32(rng, ch)) + 0.5}
    return vars_, ops, feed


@pytest.mark.parametrize("is_test", [False, True])
def test_batch_norm_matches_reference(is_test):
    vars_, ops, feed = _bn(is_test)
    ref, got = _both(vars_, ops, feed, BN_OUTS, loss="y",
                     wrt=["x", "scale", "bias"])
    _hold(ref, got, BN_OUTS + ["x@GRAD", "scale@GRAD", "bias@GRAD"],
          rtol=_bn_rtol(feed["x"]))
    if not is_test:
        # SavedVariance is an inverse standard deviation
        x = feed["x"].astype(np.float64)
        var = (x ** 2).mean(axis=(0, 2, 3)) - x.mean(axis=(0, 2, 3)) ** 2
        np.testing.assert_allclose(got[4], 1 / np.sqrt(var + 1e-5),
                                   rtol=1e-3)


def test_batch_norm_2d_input_matches_reference():
    """VGG's batch_norm after an fc: [N, C] input, channel axis 1."""
    vars_, ops, feed = _bn(False, shape=(6, 4))
    ref, got = _both(vars_, ops, feed, BN_OUTS, loss="y", wrt=["x"])
    _hold(ref, got, BN_OUTS + ["x@GRAD"], rtol=_bn_rtol(feed["x"]))


def test_batch_norm_running_stats_move_once_a_step():
    """Two train steps of a program whose batch_norm writes its running
    statistics in place and whose backward replays the op: both packages
    leave mean * m^2 + batch_mean * (1 - m)(1 + m) (likewise the
    variance), so the replay updated nothing."""
    vars_, ops, feed = _bn(False)
    vars_["mean"] = vars_["mean"][:3] + (True,)
    vars_["var"] = vars_["var"][:3] + (True,)
    (op_type, ins, outs, attrs), = ops
    ops = [(op_type, ins, dict(outs, MeanOut=["mean"], VarianceOut=["var"]),
            attrs)]
    rng = np.random.RandomState(9)
    ct = _f32(rng, *feed["x"].shape)
    x_feed = {"x": feed["x"], "scale": feed["scale"],
              "bias": feed["bias"], "ct": ct}
    vars_["ct"] = (list(ct.shape), "float32", True, False)
    got = {}
    for pkg in (REF, PORT):
        main = _program(pkg, vars_, ops, loss="y", wrt=["x"])
        scope = pkg[0].Scope()
        for n in ("mean", "var"):
            scope.set(n, feed[n] if pkg is REF else
                      torch.from_numpy(feed[n]))
        for _ in range(2):
            _run(pkg, main, x_feed, ["x@GRAD"], scope)
        got[pkg is PORT] = [np.asarray(scope.get(n)) if pkg is REF
                            else scope.get(n).numpy()
                            for n in ("mean", "var")]
    x = feed["x"].astype(np.float64)
    batch = [x.mean(axis=(0, 2, 3)),
             (x ** 2).mean(axis=(0, 2, 3)) - x.mean(axis=(0, 2, 3)) ** 2]
    for i, n in enumerate(("mean", "var")):
        want = feed[n] * 0.81 + batch[i] * 0.1 * 1.9
        np.testing.assert_allclose(got[True][i], got[False][i],
                                   rtol=_bn_rtol(feed["x"]), err_msg=n)
        np.testing.assert_allclose(got[True][i], want, rtol=1e-4, err_msg=n)


# -- losses, softmax, top_k, accuracy ---------------------------------------

@pytest.mark.parametrize("soft", [False, True])
def test_cross_entropy_matches_reference(soft):
    rng = np.random.RandomState(11)
    logits = _f32(rng, 6, 5)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    prob[0, 2] = 0.0    # the 1e-8 inside the log
    if soft:
        label = np.abs(_f32(rng, 6, 5))
        label /= label.sum(-1, keepdims=True)
        lab_var = ([-1, 5], "float32", True, False)
    else:
        label = rng.randint(0, 5, (6, 1)).astype(np.int64)
        label[0, 0] = 2
        lab_var = ([-1, 1], "int64", True, False)
    vars_ = {"p": ([-1, 5], "float32", False, False), "label": lab_var}
    ref, got = _both(vars_, [("cross_entropy", {"X": ["p"],
                                                "Label": ["label"]},
                              {"Y": ["y"]}, {"soft_label": soft})],
                     {"p": prob, "label": label}, ["y"], loss="y",
                     wrt=["p"])
    _hold(ref, got, ["y", "p@GRAD"])


@pytest.mark.parametrize("op_type,attrs", [("softmax", {"axis": -1}),
                                           ("softmax", {"axis": 1}),
                                           ("tanh", {})])
def test_softmax_and_tanh_match_reference(op_type, attrs):
    rng = np.random.RandomState(12)
    vars_ = {"x": ([-1, 4, 6], "float32", False, False)}
    ref, got = _both(vars_, [(op_type, {"X": ["x"]}, {"Out": ["y"]},
                              attrs)], {"x": _f32(rng, 3, 4, 6, scale=2.0)},
                     ["y"], loss="y", wrt=["x"])
    _hold(ref, got, ["y", "x@GRAD"])


def test_top_k_and_accuracy_match_reference():
    """top_k's values and int64 indices (no gradient to X), then accuracy
    at k 1 and 3: Accuracy float32, Correct and Total int32 scalars."""
    rng = np.random.RandomState(13)
    x = _f32(rng, 8, 10)
    label = rng.randint(0, 10, (8, 1)).astype(np.int64)
    label[:3, 0] = np.argmax(x[:3], axis=1)
    vars_ = {"x": ([-1, 10], "float32", True, False),
             "label": ([-1, 1], "int64", True, False)}
    ops, fetch = [], []
    for k in (1, 3):
        # declared as layers.accuracy declares them (JAX, without x64,
        # would infer int32 indices for an undeclared var)
        vars_.update({f"i{k}": (None, "int64", True, False),
                      f"c{k}": (None, "int32", True, False),
                      f"t{k}": (None, "int32", True, False)})
        ops += [("top_k", {"X": ["x"]}, {"Out": [f"v{k}"],
                                          "Indices": [f"i{k}"]}, {"k": k}),
                ("accuracy", {"Out": [f"v{k}"], "Indices": [f"i{k}"],
                              "Label": ["label"]},
                 {"Accuracy": [f"acc{k}"], "Correct": [f"c{k}"],
                  "Total": [f"t{k}"]}, {})]
        fetch += [f"v{k}", f"i{k}", f"acc{k}", f"c{k}", f"t{k}"]
    ref, got = _both(vars_, ops, {"x": x, "label": label}, fetch)
    _hold(ref, got, fetch)
    by = dict(zip(fetch, got))
    assert by["i1"].dtype == np.int64 and by["acc1"].dtype == np.float32
    assert by["c1"].dtype == np.int32 and by["t1"].dtype == np.int32
    assert by["acc1"].shape == () and int(by["t3"]) == 8
    assert int(by["c1"]) >= 3 and int(by["c3"]) >= int(by["c1"])


# -- momentum, gaussian_random ----------------------------------------------

@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_matches_reference(nesterov):
    rng = np.random.RandomState(14)
    vars_ = {n: ([3, 4], "float32", True, False)
             for n in ("p", "g", "v")}
    vars_["lr"] = ([1], "float32", True, False)
    ops = [("momentum", {"Param": ["p"], "Grad": ["g"], "Velocity": ["v"],
                         "LearningRate": ["lr"]},
            {"ParamOut": ["p_out"], "VelocityOut": ["v_out"]},
            {"mu": 0.9, "use_nesterov": nesterov})]
    feed = {"p": _f32(rng, 3, 4), "g": _f32(rng, 3, 4),
            "v": _f32(rng, 3, 4), "lr": np.asarray([0.1], np.float32)}
    ref, got = _both(vars_, ops, feed, ["p_out", "v_out"])
    _hold(ref, got, ["p_out", "v_out"])
    v = 0.9 * feed["v"] + feed["g"]
    step = feed["g"] + 0.9 * v if nesterov else v
    np.testing.assert_allclose(got[0], feed["p"] - 0.1 * step, rtol=1e-6)


def test_gaussian_random_shape_and_moments():
    """The port's draw has the attr shape and dtype, mean and std within
    5 standard errors of the attrs, and repeats for the same seed."""
    main = framework.Program()
    blk = main.global_block()
    blk.create_var(name="z", shape=[300, 200], dtype="float32")
    blk.append_op("gaussian_random", {}, {"Out": ["z"]},
                  {"shape": [300, 200], "dtype": "float32", "mean": 0.5,
                   "std": 2.0, "seed": 17})
    assert blk.var("z").shape == (300, 200)
    (z,) = _run(PORT, main, {}, ["z"])
    (z2,) = _run(PORT, main, {}, ["z"])
    n = z.size
    assert z.shape == (300, 200) and z.dtype == np.float32
    assert abs(z.mean() - 0.5) < 5 * 2.0 / np.sqrt(n)
    assert abs(z.std() - 2.0) < 5 * 2.0 / np.sqrt(2 * n)
    np.testing.assert_array_equal(z, z2)
