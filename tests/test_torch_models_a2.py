"""paddle_tpu_torch builds DeepFM and stacked_lstm_net as paddle_tpu does,
and its four new ops compute what the reference's compute.

- ``deepfm.build_train`` and a ``stacked_lstm_net`` classifier serialize
  to JSON equal to the reference's (main and startup programs).
- DeepFM at tests/test_models.py's shapes (1000 features, 5 fields,
  embed 4, batch 8) takes 4 Adam steps from the JAX startup values:
  losses rtol 1e-5, step-1 gradients atol 1e-5 * max|g|, final
  parameters rtol 1e-5, atol 1e-6 (Adam's first steps move a weight by
  lr * sign(g), so entries whose gradient is within float noise of 0,
  |g| < 1e-6 * max|g|, are left out of the parameter check, as in
  tests/test_torch_conv_models.py).
- sigmoid, square, sigmoid_cross_entropy_with_logits and
  square_error_cost: forward and the gradient that reaches the weight
  before them, against the reference, rtol 1e-5, atol 1e-7 (measured:
  max |diff| <= 1.3e-7 * max|reference|).
- tests/test_torch_conv_models.py's MNIST conv run (Adam, batch 8, 5
  steps), driven by Trainer.train, is bit for bit its hand-driven run.
"""
import importlib
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu import layers as ref_layers
from paddle_tpu.models import deepfm as ref_deepfm
from paddle_tpu.models import lstm_lm as ref_lstm_lm
from paddle_tpu_torch import framework, layers
from paddle_tpu_torch.models import deepfm, lstm_lm, mnist
from paddle_tpu_torch.trainer import EndIteration, Trainer

LOSS_RTOL = 1e-5
GRAD_ATOL_FRAC = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
TINY_GRAD = 1e-6
OP_RTOL = 1e-5

_BACKWARDS = [importlib.import_module(f"{pkg}.core.backward")
              for pkg in ("paddle_tpu", "paddle_tpu_torch")]
PKGS = {"ref": (pt, ref_layers, ref_framework, ref_deepfm, ref_lstm_lm),
        "port": (ptt, layers, framework, deepfm, lstm_lm)}


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


def _both(builder):
    """builder(pkg, layers, deepfm, lstm_lm) in each package, from equal
    name and snapshot counts."""
    saved = [m._SNAP_COUNTER[0] for m in _BACKWARDS]
    out = {}
    try:
        for who, (pkg, lay, fw, dfm, lm) in PKGS.items():
            for m in _BACKWARDS:
                m._SNAP_COUNTER[0] = 0
            with fw.isolated_name_scope():
                out[who] = builder(pkg, lay, dfm, lm)
    finally:
        for m, n in zip(_BACKWARDS, saved):
            m._SNAP_COUNTER[0] = n
    return out


def _deepfm(pkg, lay, dfm, lm):
    return dfm.build_train(num_features=1000, num_fields=5, embed_dim=4)


def _stacked_lstm(pkg, lay, dfm, lm):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        words = lay.data("words", [1], dtype="int64", lod_level=1)
        label = lay.data("label", [1], dtype="int64")
        pred = lm.stacked_lstm_net(words, vocab_size=50, hid_dim=8,
                                   emb_dim=8)
        loss = lay.mean(lay.cross_entropy(pred, label))
        pkg.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    return main, startup, {"loss": loss, "pred": pred}


@pytest.mark.parametrize("name", ["deepfm", "stacked_lstm_net"])
@pytest.mark.parametrize("which", ["main", "startup"])
def test_program_json_equal(name, which):
    built = _both({"deepfm": _deepfm, "stacked_lstm_net": _stacked_lstm}[
        name])
    i = ("main", "startup").index(which)
    ref, port = built["ref"][i], built["port"][i]
    assert json.loads(ref.desc.to_json()) == json.loads(port.desc.to_json())
    assert "__shape_infer_skipped__" not in port.desc.to_json()


def test_deepfm_distributed_waits_for_a10():
    with pytest.raises(NotImplementedError, match="A10"):
        deepfm.build_train(num_features=100, num_fields=3, embed_dim=2,
                           distributed=True)


def _deepfm_feeds(steps=4):
    rng = np.random.RandomState(0)
    return [{"feat_ids": rng.randint(0, 1000, (8, 5, 1)).astype(np.int64),
             "feat_vals": rng.rand(8, 5).astype(np.float32),
             "label": rng.randint(0, 2, (8, 1)).astype(np.float32)}
            for _ in range(steps)]


def test_deepfm_adam_steps_match_jax_package():
    built = _both(_deepfm)
    (rmain, rstart, rf), (pmain, pstart, pf) = built["ref"], built["port"]
    rscope, rexe = pt.Scope(), pt.Executor()
    rexe.run(rstart, scope=rscope)
    init = {n: np.asarray(rscope.get(n)) for n in rscope.local_names()}
    pscope, pexe = ptt.Scope(), ptt.Executor("cpu")
    pexe.run(pstart, scope=pscope)
    ptt.load_param_arrays(pscope, init)
    params = [p.name for p in pmain.all_parameters()]
    assert len(params) == 10          # two tables, four fc layers
    fetch = [pf["loss"].name] + [n + "@GRAD" for n in params]
    out = {}
    for who, exe, main, scope in (("ref", rexe, rmain, rscope),
                                  ("port", pexe, pmain, pscope)):
        losses, grads = [], None
        for step, feed in enumerate(_deepfm_feeds()):
            got = [np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch, scope=scope)]
            losses.append(float(got[0].reshape(-1)[0]))
            if step == 0:
                grads = dict(zip(params, got[1:]))
        final = {n: np.asarray(scope.get(n)) for n in params}
        out[who] = (losses, grads, final)
    (rl, rg, rp), (pl, pg, pp) = out["ref"], out["port"]
    assert np.all(np.isfinite(pl))
    np.testing.assert_allclose(pl, rl, rtol=LOSS_RTOL)
    for n in params:
        scale = float(np.abs(rg[n]).max())
        np.testing.assert_allclose(pg[n], rg[n], rtol=0,
                                   atol=GRAD_ATOL_FRAC * scale, err_msg=n)
        live = np.abs(rg[n]) >= TINY_GRAD * scale
        np.testing.assert_allclose(pp[n][live], rp[n][live],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=n)


def _op_program(op):
    def build(pkg, lay, dfm, lm):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = lay.data("x", [6], dtype="float32")
            y = lay.data("y", [4], dtype="float32")
            h = lay.fc(x, size=4, bias_attr=False)
            if op in ("sigmoid", "square"):
                out = getattr(lay, op)(h)
            elif op == "sigmoid_cross_entropy_with_logits":
                out = lay.sigmoid_cross_entropy_with_logits(h, y)
            else:
                out = lay.square_error_cost(h, y)
            loss = lay.mean(out)
            pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
        return main, startup, out
    return build


@pytest.mark.parametrize("op", ["sigmoid", "square",
                                "sigmoid_cross_entropy_with_logits",
                                "square_error_cost"])
def test_new_op_forward_and_gradient_match_reference(op):
    built = _both(_op_program(op))
    (rmain, rstart, rout), (pmain, pstart, pout) = built["ref"], \
        built["port"]
    assert op in [o.type for o in pmain.desc.global_block.ops]
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(5, 6).astype(np.float32) * 2,
            "y": (rng.rand(5, 4) > 0.5).astype(np.float32)}
    w = pmain.all_parameters()[0].name
    rscope, rexe = pt.Scope(), pt.Executor()
    rexe.run(rstart, scope=rscope)
    pscope, pexe = ptt.Scope(), ptt.Executor("cpu")
    pexe.run(pstart, scope=pscope)
    ptt.load_param_arrays(pscope, {n: np.asarray(rscope.get(n))
                                   for n in pscope.local_names()})
    fetch = [pout.name, w + "@GRAD"]
    got = pexe.run(pmain, feed=feed, fetch_list=fetch, scope=pscope)
    want = rexe.run(rmain, feed=feed, fetch_list=fetch, scope=rscope)
    for g, r, what in zip(got, want, ("forward", "gradient")):
        np.testing.assert_allclose(g, np.asarray(r), rtol=OP_RTOL,
                                   atol=1e-7, err_msg=f"{op} {what}")


def test_mnist_conv_through_trainer_equals_hand_driven_run():
    with framework.isolated_name_scope():
        main, startup, f = mnist.build_train(net="conv")
    rng = np.random.RandomState(0)
    batch = {"img": rng.rand(8, 1, 28, 28).astype(np.float32),
             "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    feeds = [batch] * 5
    scratch = ptt.Scope()
    ptt.Executor("cpu").run(startup, scope=scratch)
    init = {n: scratch.get(n).numpy() for n in scratch.local_names()}
    params = [p.name for p in main.all_parameters()]

    exe, scope = ptt.Executor("cpu"), ptt.Scope()
    exe.run(startup, scope=scope)
    ptt.load_param_arrays(scope, init)
    hand = [float(exe.run(main, feed=feed, fetch_list=[f["loss"]],
                          scope=scope)[0].reshape(-1)[0]) for feed in feeds]
    hand_params = {n: scope.get(n).numpy() for n in params}

    t = Trainer(f["loss"], main_program=main, startup_program=startup,
                executor=ptt.Executor("cpu"))
    t.start()
    ptt.load_param_arrays(ptt.global_scope(), init)
    costs = []
    t.train(1, lambda: iter(feeds),
            event_handler=lambda e: costs.append(e.cost)
            if isinstance(e, EndIteration) else None)
    assert costs == hand
    for n in params:
        np.testing.assert_array_equal(ptt.global_scope().get(n).numpy(),
                                      hand_params[n], err_msg=n)
