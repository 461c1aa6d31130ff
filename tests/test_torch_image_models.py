"""The image models bench.py runs (SE-ResNeXt, GoogLeNet, AlexNet) and
the lrn op, in paddle_tpu_torch against paddle_tpu.

- Programs: the train and startup programs of SE-ResNeXt at its default
  counts (3, 4, 6, 3) and at the 152 counts (3, 8, 36, 3), GoogLeNet
  with and without its auxiliary heads and AlexNet with and without lrn,
  all at 3x224x224 and 1000 classes, serialize to equal JSON in both
  packages (ops, attrs, seeds, var names and build-time shapes).
- lrn: forward (Out and MidOut) and the __vjp__ gradient over several
  n / k / alpha / beta, through both executors. float32: rtol 1e-6,
  atol 1e-7 (the same window sum in the same order). bf16 under AMP
  (lrn takes no cast, so the bf16 input comes from a bf16 product): Out
  and MidOut stay bf16 in both and are equal bit for bit (the reference
  compiled with excess precision off, as tests/test_torch_amp.py does:
  each bf16 op rounded, k, alpha and beta rounded to bf16 first in
  both); the gradient within 2 bf16 ulps of its largest element (the
  reference's derivative rules round each primitive of the power's and
  the quotient's derivatives, torch's backward formulas round once:
  measured up to 0.54% of the largest element, 1.4 of its ulps).
- Training: each model 2 steps at a small shape, 10 classes, from the
  port's startup values carried into the reference, on the same seeded
  batches: SE-ResNeXt at counts (1, 1, 1, 1), cardinality 8, 3x64x64,
  batch 4; GoogLeNet with its auxiliary heads at 3x96x96 (the smallest
  image whose 4a output still fills the 5x5 auxiliary pool), batch 2;
  AlexNet with lrn at 3x67x67, batch 4. For this numeric check only,
  every dropout op's dropout_prob is set to 0 by the same edit in both
  packages' programs (and in the __vjp__ ops' copies of it): the port's
  dropout draws torch's bits. The JSON equality above covers the
  programs as built. The port runs each step with its ReLUs passing
  exactly where the reference's did (chip_smoke.py's pinned-mask rule):
  a ReLU input within float noise of 0 flips between two summation
  orders (in SE-ResNeXt at batch 8 one flip in the stage-3 block moved
  a gradient by 9% on the CPU) and is not the arithmetic under test.
  Held as tests/test_torch_conv_models.py holds its models: losses atol
  1e-5 * max|loss|, step-1 gradients atol 1e-5 * max|g| per parameter,
  parameters rtol 1e-5 atol 1e-6 (entries whose gradient is within
  1e-6 of 0 left out: Momentum moves them either way). SE-ResNeXt's
  batch_norms normalize as few as 16 values a channel (its last stage at
  2x2), so there each limit is at least NOISE_FACTOR (10) times how far
  the reference itself moves from parameters one ulp away, as for
  ResNet-18 there (at 3x32x32 its stem gradient sat 1.4e-4 of max|g|
  from the reference's with the masks pinned; at 3x64x64 1.4e-5). The
  port's free step (its own masks) takes the first loss within rtol
  1e-5.
- The rewrite pipeline on SE-ResNeXt (counts (1, 1, 1, 1), 3x64x64): the
  rewritten training program and the rewritten inference program (the
  trained program pruned to its prediction and cloned for_test, as
  io.save_inference_model freezes it) are JSON-equal in both packages;
  ``fuse_se`` outlines no gate in the training program (its backward
  reads the gate's intermediates) and one se_block per block (4) in the
  inference program; the port's inference outputs with the pipeline on
  and off agree within rtol 1e-5, atol 1e-6 (se_block sums the pool in
  another order than pool2d's window).
"""
import contextlib
import importlib
import json
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import io as ref_io
from paddle_tpu.models import alexnet as ref_alexnet
from paddle_tpu.models import googlenet as ref_googlenet
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu_torch import amp, io
from paddle_tpu_torch.core.registry import OpRegistry
from paddle_tpu_torch.models import alexnet, googlenet, resnet
from test_torch_amp import _rounding_reference
from test_torch_conv_models import (_BACKWARDS, GRAD_ATOL_FRAC,
                                    LOSS_RTOL, NOISE_FACTOR, PARAM_ATOL,
                                    PARAM_RTOL, TINY_GRAD, _nudged)

_REWRITES = [importlib.import_module(f"{p}.analysis.rewrite")
             for p in ("paddle_tpu", "paddle_tpu_torch")]
PKGS = {"ref": (pt, ref_resnet, ref_googlenet, ref_alexnet),
        "port": (ptt, resnet, googlenet, alexnet)}
SE_SMALL = dict(class_dim=10, image_shape=(3, 64, 64),
                layers_counts=(1, 1, 1, 1), cardinality=8)


@pytest.fixture(autouse=True)
def _fresh():
    pt.amp.enable(False)
    amp.enable(False)
    ptt.reset_default_programs()
    yield
    pt.amp.enable(False)
    amp.enable(False)


def _alexnet_train(pkg, alex, with_lrn, **kw):
    """alexnet.build_train with `with_lrn` (the builder always takes
    lrn): the same program around alexnet(img, with_lrn=...)."""
    lay = pkg.layers
    class_dim = kw.get("class_dim", 1000)
    image_shape = kw.get("image_shape", (3, 224, 224))
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = lay.data("img", list(image_shape), dtype="float32")
        label = lay.data("label", [1], dtype="int64")
        pred = alex.alexnet(img, class_dim, with_lrn=with_lrn)
        loss = lay.mean(lay.cross_entropy(input=pred, label=label))
        acc = lay.accuracy(input=pred, label=label)
        pkg.optimizer.MomentumOptimizer(learning_rate=0.01,
                                        momentum=0.9).minimize(loss)
    return main, startup, {"loss": loss, "acc": acc, "pred": pred}


BUILDERS = {
    "se_resnext50": lambda pkg, res, goog, alex:
        res.build_se_resnext_train(),
    "se_resnext152": lambda pkg, res, goog, alex:
        res.build_se_resnext_train(layers_counts=(3, 8, 36, 3)),
    "googlenet_aux": lambda pkg, res, goog, alex:
        goog.build_train(with_aux=True),
    "googlenet": lambda pkg, res, goog, alex:
        goog.build_train(with_aux=False),
    "alexnet_lrn": lambda pkg, res, goog, alex: alex.build_train(),
    "alexnet": lambda pkg, res, goog, alex:
        _alexnet_train(pkg, alex, False),
    # the small shapes of the numeric checks
    "se_resnext_small": lambda pkg, res, goog, alex:
        res.build_se_resnext_train(**SE_SMALL),
    "googlenet_small": lambda pkg, res, goog, alex:
        goog.build_train(class_dim=10, image_shape=(3, 96, 96)),
    "alexnet_small": lambda pkg, res, goog, alex:
        _alexnet_train(pkg, alex, True, class_dim=10,
                       image_shape=(3, 67, 67)),
}


def _build(name):
    """Both packages' (main, startup, fetches) of `name`, each built from
    a snapshot count of 0 in an isolated name scope."""
    saved = [m._SNAP_COUNTER[0] for m in _BACKWARDS]
    out = {}
    try:
        for who, mods in PKGS.items():
            for m in _BACKWARDS:
                m._SNAP_COUNTER[0] = 0
            with mods[0].framework.isolated_name_scope():
                out[who] = BUILDERS[name](*mods)
    finally:
        for m, n in zip(_BACKWARDS, saved):
            m._SNAP_COUNTER[0] = n
    return out


@pytest.mark.parametrize("name", ["se_resnext50", "se_resnext152",
                                  "googlenet_aux", "googlenet",
                                  "alexnet_lrn", "alexnet"])
def test_model_programs_json_equal(name):
    built = _build(name)
    for r, p, what in zip(built["ref"][:2], built["port"][:2],
                          ("main", "startup")):
        assert json.loads(r.desc.to_json()) == \
            json.loads(p.desc.to_json()), f"{name} {what}"
    ops = [op.type for op in built["port"][0].desc.global_block.ops]
    # SE-ResNeXt: 3 convs and a sigmoid gate a block, the stem conv and
    # a 1x1 shortcut conv opening each stage
    want = {"se_resnext50": {"conv2d": 3 * 16 + 5, "sigmoid": 16},
            "se_resnext152": {"conv2d": 3 * 50 + 5, "sigmoid": 50},
            "googlenet_aux": {"dropout": 3, "conv2d": 59},
            "googlenet": {"dropout": 1, "conv2d": 57},
            "alexnet_lrn": {"lrn": 2, "dropout": 2},
            "alexnet": {"lrn": 0, "dropout": 2}}[name]
    assert {t: ops.count(t) for t in want} == want
    assert "__shape_infer_skipped__" not in built["port"][0].desc.to_json()


# -- lrn ---------------------------------------------------------------------

LRN_CASES = [dict(n=5, k=1.0, alpha=1e-4, beta=0.75),
             dict(n=3, k=2.0, alpha=0.5, beta=0.5),
             dict(n=4, k=1.5, alpha=0.1, beta=1.0),
             dict(n=1, k=0.5, alpha=2.0, beta=0.25)]


def _lrn_program(pkg, case, bf16):
    """lrn over x [N, 6, 5, 5] (or, for bf16, over the bf16 product of x
    with an identity), its outputs, and the gradient of sum(Out * g)."""
    lay = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [6, 5, 5], dtype="float32")
        g = lay.data("g", [6, 5, 5], dtype="float32")
        x.stop_gradient = False
        if bf16:
            eye = lay.data("eye", [5, 5], dtype="float32",
                           append_batch_size=False)
            x = lay.matmul(x, eye)
        out = lay.lrn(x, **case)
        loss = lay.reduce_sum(lay.elementwise_mul(out, g))
        importlib.import_module(
            f"{pkg.__name__}.core.backward").append_backward(loss)
    op = [o for o in main.desc.global_block.ops if o.type == "lrn"][0]
    return main, startup, [op.output("Out")[0], op.output("MidOut")[0],
                           op.input("X")[0] + "@GRAD"]


def _as_f64(v):
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", ""), v.double().numpy()
    return str(v.dtype), np.asarray(np.asarray(v).astype(np.float32),
                                    np.float64)


def _bf16_ulp(x):
    ax = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(ax)) - 7)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("case", range(len(LRN_CASES)))
def test_lrn_matches_reference(case, bf16):
    rng = np.random.RandomState(case)
    feed = {"x": (rng.randn(3, 6, 5, 5) * 2).astype(np.float32),
            "g": rng.randn(3, 6, 5, 5).astype(np.float32)}
    if bf16:
        feed["eye"] = np.eye(5, dtype=np.float32)
    got = {}
    for who, pkg in (("ref", pt), ("port", ptt)):
        main, startup, fetch = _lrn_program(pkg, LRN_CASES[case], bf16)
        exe = pt.Executor() if pkg is pt else ptt.Executor(place="cpu")
        with amp.amp_guard(bf16), pt.amp.amp_guard(bf16), \
                _rounding_reference():
            got[who] = [_as_f64(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch, scope=pkg.Scope(),
                return_numpy=False)]
    for (rt, r), (pt_, p), what in zip(got["ref"], got["port"],
                                       ("Out", "MidOut", "X@GRAD")):
        assert rt == pt_ == ("bfloat16" if bf16 else "float32"), what
        if not bf16:
            np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-7,
                                       err_msg=what)
        elif what == "X@GRAD":
            lim = 2 * _bf16_ulp(np.abs(r).max())
            assert np.abs(p - r).max() <= lim, what
        else:
            assert np.array_equal(p, r), what
    # MidOut is k + alpha * (the window's sum of squares)
    x = feed["x"].astype(np.float64)
    c = LRN_CASES[case]
    if not bf16:
        half, sq = c["n"] // 2, np.pad(x ** 2, ((0, 0), (c["n"] // 2,) * 2,
                                                (0, 0), (0, 0)))
        acc = sum(sq[:, i:i + 6] for i in range(c["n"]))
        np.testing.assert_allclose(got["port"][1][1],
                                   c["k"] + c["alpha"] * acc, rtol=1e-6)
        del half


def test_lrn_op_defaults_are_the_ops():
    """An lrn op appended with no attrs takes the op's defaults (k 2.0),
    the layer writes its own (k 1.0) — in both packages alike."""
    from paddle_tpu_torch.core.registry import run_op
    from paddle_tpu_torch.core.ir import OpDesc
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 2, 2)
                         .astype(np.float32))
    op = OpDesc("lrn", {"X": ["x"]}, {"Out": ["o"], "MidOut": ["m"]}, {})
    outs = run_op(op, {"x": x}, {"device": torch.device("cpu")})
    sq = np.pad(x.numpy() ** 2, ((0, 0), (2, 2), (0, 0), (0, 0)))
    mid = 2.0 + 1e-4 * sum(sq[:, i:i + 3] for i in range(5))
    np.testing.assert_allclose(outs["m"].numpy(), mid, rtol=1e-6)
    np.testing.assert_allclose(outs["o"].numpy(), x.numpy() / mid ** 0.75,
                               rtol=1e-6)
    for pkg in (pt, ptt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            pkg.layers.lrn(pkg.layers.data("x", [3, 2, 2]))
        assert main.desc.global_block.ops[-1].attrs["k"] == 1.0


# -- training at small shapes ------------------------------------------------

def _no_dropout(main):
    """dropout_prob 0 on every dropout op of `main` and in every __vjp__
    op's copy of one."""
    for blk in main.desc.blocks:
        for op in blk.ops:
            if op.type == "dropout":
                op.attrs["dropout_prob"] = 0.0
            fwd = op.attrs.get("fwd_op")
            if isinstance(fwd, dict) and fwd.get("type") == "dropout":
                fwd["attrs"]["dropout_prob"] = 0.0


#: name: (image shape, batch, whether the reference also runs from
#: parameters one ulp away: where batch_norms condition the step)
SMALL = {"se_resnext_small": ((3, 64, 64), 4, True),
         "googlenet_small": ((3, 96, 96), 2, False),
         "alexnet_small": ((3, 67, 67), 4, False)}


@contextlib.contextmanager
def _pinned_relus(masks):
    """Every relu op of the port passes exactly where `masks` (its input
    name -> bool array) says, in the forward and in its __vjp__ alike."""
    relu = OpRegistry.get("relu")
    free = relu.compute

    def pinned(ctx):
        x = ctx.input("X")
        m = torch.from_numpy(masks[ctx.op.input("X")[0]])
        ctx.set_output("Out", torch.where(m, x, torch.zeros_like(x)))

    relu.compute = pinned
    try:
        yield
    finally:
        relu.compute = free


@pytest.fixture(scope="module", params=sorted(SMALL))
def runs(request):
    """2 steps of a small model in both packages from the port's startup
    values (the reference's startup compiles for seconds): {"ref",
    "nudged" (the reference from parameters one ulp away, where `noise`),
    "pinned" (the port with each step's ReLUs passing where the
    reference's did), "free" (the port as it is)}: (losses, step-1
    grads, final params)."""
    name = request.param
    shape, batch, noise = SMALL[name]
    built = _build(name)
    for who in built:
        _no_dropout(built[who][0])
    rng = np.random.RandomState(0)
    feeds = [{"img": rng.rand(batch, *shape).astype(np.float32),
              "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}
             for _ in range(2)]
    (rmain, rstart, rf), (pmain, pstart, pf) = built["ref"], built["port"]
    scope = ptt.Scope()
    ptt.Executor(place="cpu").run(pstart, scope=scope)
    init = {n: scope.get(n).numpy() for n in scope.local_names()}
    rexe, scope = pt.Executor(), pt.Scope()
    for n, v in init.items():
        scope.set(n, jnp.asarray(v))
    params = [p.name for p in pmain.all_parameters()]
    relu_in = [op.input("X")[0] for op in pmain.desc.global_block.ops
               if op.type == "relu"]
    fetch = [pf["loss"].name] + [n + "@GRAD" for n in params]
    out, signs = {"name": name}, []
    losses, grads = [], None
    for step, feed in enumerate(feeds):
        got = [np.asarray(v) for v in rexe.run(
            rmain, feed=feed, fetch_list=fetch + relu_in, scope=scope)]
        losses.append(float(got[0].reshape(-1)[0]))
        grads = grads or dict(zip(params, got[1:len(fetch)]))
        signs.append({n: v > 0 for n, v in zip(relu_in, got[len(fetch):])})
    out["ref"] = (losses, grads, {n: np.asarray(scope.get(n))
                                  for n in params})
    if noise:
        scope = pt.Scope()
        for n, v in _nudged(init, params).items():
            scope.set(n, jnp.asarray(v))
        losses, grads = [], None
        for feed in feeds:
            got = [np.asarray(v) for v in rexe.run(
                rmain, feed=feed, fetch_list=fetch + relu_in, scope=scope)]
            losses.append(float(got[0].reshape(-1)[0]))
            grads = grads or dict(zip(params, got[1:len(fetch)]))
        out["nudged"] = (losses, grads, {n: np.asarray(scope.get(n))
                                         for n in params})
    for arm in ("pinned", "free"):
        exe, scope = ptt.Executor(place="cpu"), ptt.Scope()
        exe.run(pstart, scope=scope)
        ptt.load_param_arrays(scope, init)
        losses, grads = [], None
        for step, feed in enumerate(feeds):
            with _pinned_relus(signs[step]) if arm == "pinned" \
                    else contextlib.nullcontext():
                got = [np.asarray(v) for v in exe.run(
                    pmain, feed=feed, fetch_list=fetch, scope=scope)]
            losses.append(float(got[0].reshape(-1)[0]))
            grads = grads or dict(zip(params, got[1:]))
        out[arm] = (losses, grads, {n: scope.get(n).numpy()
                                    for n in params})
    return out


def _atol(out, part, name, base):
    """`base`, or NOISE_FACTOR times how far parameters one ulp away
    moved the reference's value, where the run measured that and it is
    larger."""
    if "nudged" not in out:
        return base
    ref, nudged = out["ref"][part], out["nudged"][part]
    if name is not None:
        ref, nudged = ref[name], nudged[name]
    return max(base, NOISE_FACTOR
               * float(np.abs(np.subtract(ref, nudged)).max()))


def test_small_model_losses_match(runs):
    r, p = np.asarray(runs["ref"][0]), np.asarray(runs["pinned"][0])
    assert np.all(np.isfinite(p))
    np.testing.assert_allclose(
        p, r, rtol=0,
        atol=_atol(runs, 0, None, LOSS_RTOL * float(np.abs(r).max())))
    np.testing.assert_allclose(runs["free"][0][0], r[0], rtol=LOSS_RTOL)


def test_small_model_step1_gradients_match(runs):
    for name, r in runs["ref"][1].items():
        np.testing.assert_allclose(
            runs["pinned"][1][name], r, rtol=0,
            atol=_atol(runs, 1, name,
                       GRAD_ATOL_FRAC * float(np.abs(r).max())),
            err_msg=f"{runs['name']} {name}@GRAD")


def test_small_model_final_params_match(runs):
    grads = runs["ref"][1]
    for name, r in runs["ref"][2].items():
        keep = np.abs(grads[name]) >= TINY_GRAD * np.abs(grads[name]).max()
        np.testing.assert_allclose(
            runs["pinned"][2][name][keep], r[keep], rtol=PARAM_RTOL,
            atol=_atol(runs, 2, name, PARAM_ATOL),
            err_msg=f"{runs['name']} {name}")


# -- the rewrite pipeline on SE-ResNeXt --------------------------------------

@pytest.fixture(scope="module")
def se_rewrites():
    """Both packages' SE-ResNeXt (counts (1, 1, 1, 1)): the training
    program and its inference program, each as built and rewritten."""
    built = _build("se_resnext_small")
    out = {}
    for (who, (main, startup, f)), io_mod, rw in zip(
            built.items(), (ref_io, io), _REWRITES):
        infer = io_mod._prune(main, ["img"], [f["pred"].name]) \
            .inference_optimize()
        rw._OUTLINE_UID[0] = 0
        train = rw.rewrite_program(main, feed_names=["img", "label"],
                                   fetch_names=[f["loss"].name])
        rw._OUTLINE_UID[0] = 0
        inf = rw.rewrite_program(infer, feed_names=["img"],
                                 fetch_names=[f["pred"].name])
        out[who] = dict(main=main, startup=startup, infer=infer,
                        pred=f["pred"].name, train_rw=train, infer_rw=inf)
    return out


def _ops(desc):
    return [op.type for blk in desc.blocks for op in blk.ops]


def test_se_resnext_rewrites_match_reference(se_rewrites):
    ref, port = se_rewrites["ref"], se_rewrites["port"]
    for key in ("train_rw", "infer_rw"):
        assert port[key].program.to_json() == ref[key].program.to_json(), \
            key
        assert port[key].summary()["passes"] == \
            ref[key].summary()["passes"], key
    assert "se_block" not in _ops(port["train_rw"].program)
    assert port["train_rw"].count("fuse_se") == 0
    assert _ops(port["infer_rw"].program).count("se_block") == 4
    assert port["infer_rw"].count("fuse_se") == 4
    assert "sigmoid" not in _ops(port["infer_rw"].program)


def test_se_resnext_inference_pipeline_on_off(se_rewrites):
    """The port's inference program with the pipeline on (4 se_block
    ops) and off (the composed gates): the same predictions within rtol
    1e-5, atol 1e-6."""
    port = se_rewrites["port"]
    scope = ptt.Scope()
    ptt.Executor(place="cpu").run(port["startup"], scope=scope)
    img = np.random.RandomState(1).rand(4, 3, 32, 32).astype(np.float32)
    preds, ran = {}, {}
    for knob in ("0", "1"):
        with mock.patch.dict(os.environ, {"PADDLE_TPU_OPTIMIZE": knob}):
            exe = ptt.Executor(place="cpu")
            preds[knob] = exe.run(port["infer"], feed={"img": img},
                                  fetch_list=[port["pred"]], scope=scope)[0]
            ran[knob] = _ops(exe.last_compiled.program).count("se_block")
    assert ran == {"0": 0, "1": 4}
    np.testing.assert_allclose(preds["1"], preds["0"], rtol=1e-5,
                               atol=1e-6)
    assert preds["1"].shape == (4, 10)
