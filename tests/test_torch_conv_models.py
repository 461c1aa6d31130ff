"""paddle_tpu_torch builds and trains the conv models as paddle_tpu does.

- The train and startup programs of MNIST conv and mlp, ResNet-18 at
  3x32x32, ResNet-50 at 3x224x224 and VGG-16 (the builders of
  models/mnist.py, resnet.py, vgg.py) serialize to equal JSON in both
  packages: ops, attrs, seeds, var names and the shapes build-time shape
  inference declares. VGG gets no numeric parity: its dropout draws
  torch's bits.
- MNIST conv (Adam, lr 1e-3), fed as tests/test_models.py feeds it (batch
  8 of uniform images and random labels), 5 steps from the JAX startup
  values carried into the port (``load_param_arrays``): the losses, the
  step-1 gradients and the final parameters.
- ResNet-18 at 3x32x32 (10 classes, Momentum 0.9 at lr 0.01), fed as
  tests/test_models.py feeds it (batch 4, a fresh batch each step), 2
  steps: the losses, the step-1 gradients, the final parameters and
  every batch_norm's running mean and variance. It covers the basic
  block, the strided 1x1 shortcut (the slice-then-convolve rewrite), the
  stem's 7x7 stride-2 conv, the padded max pool and the global average
  pool.

Tolerances (float32 on the CPU; the packages sum in other orders): losses
atol 1e-5 * max|loss|; step-1 gradients atol 1e-5 * max|g| per
parameter; parameters and running statistics rtol 1e-5, atol 1e-6. MNIST
conv holds those as they are (Adam's first steps move a weight by
lr * sign(g), so entries whose gradient is within float noise of 0,
|g| < 1e-6 * max|g|, are left out of its parameter check). The ResNet
at batch 4 is ill-conditioned: its batch_norms normalize by single-pass
variances of uncentered activations over as few as 4 values, so float32
rounding moves its gradients by ~1e-4 * max|g|. There each quantity is
held at the larger of those limits and NOISE_FACTOR (10) times how far
the reference itself moves when its parameters are nudged by one ulp
(measured on the CPU: the nudge moves the step-1 gradients by up to
3.8e-4 * max|g|, the port differs by up to 3.7 times the nudge's effect
on the same parameter; a wrong formula moves them by O(1)).
"""
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu.models import mnist as ref_mnist
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu.models import vgg as ref_vgg
from paddle_tpu_torch import framework
from paddle_tpu_torch.models import mnist, resnet, vgg

LOSS_RTOL = 1e-5
GRAD_ATOL_FRAC = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
TINY_GRAD = 1e-6
NOISE_FACTOR = 10.0

BUILDERS = {
    "mnist_conv": (lambda m: m.build_train(net="conv"), ref_mnist, mnist),
    "mnist_mlp": (lambda m: m.build_train(net="mlp"), ref_mnist, mnist),
    "resnet18_cifar": (lambda m: m.build_train(
        class_dim=10, depth=18, image_shape=(3, 32, 32), lr=0.01),
        ref_resnet, resnet),
    "resnet50": (lambda m: m.build_train(), ref_resnet, resnet),
    "vgg16": (lambda m: m.build_train(), ref_vgg, vgg),
}


# each package's backward names its snapshot vars `<name>@PRE.<n>` from a
# count of every snapshot its process has taken
_BACKWARDS = [importlib.import_module(f"{pkg}.core.backward")
              for pkg in ("paddle_tpu", "paddle_tpu_torch")]


def _build(name):
    """Both packages' programs for `name`. Other test files in the same
    process advance one package's snapshot count and not the other's, so
    both builds start it from 0 (and it is restored after)."""
    fn, ref_mod, port_mod = BUILDERS[name]
    saved = [m._SNAP_COUNTER[0] for m in _BACKWARDS]
    for m in _BACKWARDS:
        m._SNAP_COUNTER[0] = 0
    try:
        with ref_framework.isolated_name_scope():
            ref = fn(ref_mod)
        with framework.isolated_name_scope():
            port = fn(port_mod)
    finally:
        for m, n in zip(_BACKWARDS, saved):
            m._SNAP_COUNTER[0] = n
    return ref, port


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_model_programs_json_equal(name):
    ref, port = _build(name)
    for r, p, what in zip(ref[:2], port[:2], ("main", "startup")):
        assert json.loads(r.desc.to_json()) == json.loads(p.desc.to_json()), \
            f"{name} {what}"
    ops = [op.type for op in port[0].desc.global_block.ops]
    if name.startswith("resnet"):
        params = port[0].all_parameters()
        assert ops.count("momentum") == len(params)
        assert ops.count("batch_norm") == (53 if name == "resnet50"
                                           else 20)
    assert "__shape_infer_skipped__" not in port[0].desc.to_json()


def _nudged(arrays, names):
    """`arrays` with every entry of `names` moved one ulp, up or down at
    random (a fixed draw)."""
    rng = np.random.RandomState(1)
    out = dict(arrays)
    for n in names:
        away = np.where(rng.rand(*arrays[n].shape) < 0.5, -np.inf, np.inf)
        out[n] = np.nextafter(arrays[n], away.astype(arrays[n].dtype))
    return out


def _train(name, feeds, noise=False):
    """Both packages' runs of `name` from the JAX startup values, one
    step per feed: {"ref"/"port": (losses, step-1 grads, final params,
    final running statistics)}; with `noise`, also "nudged": the
    reference's run from parameters one ulp away."""
    (rmain, rstart, rf), (pmain, pstart, pf) = _build(name)
    rexe, pexe = pt.Executor(), ptt.Executor(place="cpu")
    init_scope, pscope = pt.Scope(), ptt.Scope()
    rexe.run(rstart, scope=init_scope)
    pexe.run(pstart, scope=pscope)
    init = {n: np.asarray(init_scope.get(n)) for n in pscope.local_names()}
    ptt.load_param_arrays(pscope, init)
    params = [p.name for p in pmain.all_parameters()]
    stats = sorted(n for op in pmain.desc.global_block.ops
                   if op.type == "batch_norm"
                   for n in op.input("Mean") + op.input("Variance"))
    fetch = [pf["loss"].name] + [n + "@GRAD" for n in params]
    arms = [("ref", init), ("port", None)]
    if noise:
        arms.append(("nudged", _nudged(init, params)))
    out = {}
    for who, values in arms:
        if who == "port":
            exe, main, scope = pexe, pmain, pscope
        else:
            exe, main, scope = rexe, rmain, pt.Scope()
            rexe.run(rstart, scope=scope)
            for n, v in values.items():
                scope.set(n, jnp.asarray(v))
        losses, grads = [], None
        for step, feed in enumerate(feeds):
            got = [np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch, scope=scope)]
            losses.append(float(got[0].reshape(-1)[0]))
            if step == 0:
                grads = dict(zip(params, got[1:]))
        final = {n: np.asarray(scope.get(n)) if who != "port"
                 else scope.get(n).numpy() for n in params + stats}
        out[who] = (losses, grads, {n: final[n] for n in params},
                    {n: final[n] for n in stats})
    return out


def _atol(out, part, name, base):
    """`base`, or NOISE_FACTOR times how far the one-ulp nudge of the
    parameters moved the reference's value, where the run measured that
    and it is larger."""
    if "nudged" not in out:
        return base
    ref, nudged = out["ref"][part], out["nudged"][part]
    if name is not None:
        ref, nudged = ref[name], nudged[name]
    return max(base, NOISE_FACTOR
               * float(np.abs(np.subtract(ref, nudged)).max()))


@pytest.fixture(scope="module")
def mnist_runs():
    rng = np.random.RandomState(0)
    batch = {"img": rng.rand(8, 1, 28, 28).astype(np.float32),
             "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    return _train("mnist_conv", [batch] * 5)


@pytest.fixture(scope="module")
def resnet_runs():
    rng = np.random.RandomState(0)
    feeds = [{"img": rng.rand(4, 3, 32, 32).astype(np.float32),
              "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
             for _ in range(2)]
    return _train("resnet18_cifar", feeds, noise=True)


RUNS = ["mnist_runs", "resnet_runs"]


@pytest.mark.parametrize("runs", RUNS)
def test_train_losses_match(runs, request):
    out = request.getfixturevalue(runs)
    r, p = np.asarray(out["ref"][0]), np.asarray(out["port"][0])
    assert np.all(np.isfinite(p))
    if runs == "mnist_runs":
        assert p[-1] < p[0]
    np.testing.assert_allclose(
        p, r, rtol=0,
        atol=_atol(out, 0, None, LOSS_RTOL * float(np.abs(r).max())))


@pytest.mark.parametrize("runs", RUNS)
def test_step1_gradients_match(runs, request):
    out = request.getfixturevalue(runs)
    for name, r in out["ref"][1].items():
        np.testing.assert_allclose(
            out["port"][1][name], r, rtol=0,
            atol=_atol(out, 1, name,
                       GRAD_ATOL_FRAC * float(np.abs(r).max())),
            err_msg=f"{name}@GRAD")


@pytest.mark.parametrize("runs", RUNS)
def test_final_params_match(runs, request):
    out = request.getfixturevalue(runs)
    grads = out["ref"][1]
    for name, r in out["ref"][2].items():
        keep = np.abs(grads[name]) >= TINY_GRAD * np.abs(grads[name]).max()
        np.testing.assert_allclose(
            out["port"][2][name][keep], r[keep], rtol=PARAM_RTOL,
            atol=_atol(out, 2, name, PARAM_ATOL), err_msg=name)


def test_resnet_batch_norm_running_stats_match(resnet_runs):
    """Every batch_norm's running mean and variance after 2 steps (each
    step moves them once: the __vjp__ replays write only gradients)."""
    ref, port = resnet_runs["ref"][3], resnet_runs["port"][3]
    assert len(ref) == 2 * 20
    for name, r in ref.items():
        np.testing.assert_allclose(
            port[name], r, rtol=PARAM_RTOL,
            atol=_atol(resnet_runs, 3, name, PARAM_ATOL), err_msg=name)
        assert not np.allclose(r, 0.0) and not np.allclose(r, 1.0), name
