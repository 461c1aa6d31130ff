"""paddle_tpu_torch trains the Transformer NMT model as paddle_tpu does.

Both packages build ``models.transformer.build_train`` at a tiny size
(1+1 layers, d_model 32, 2 heads, vocabulary 50, max_len 16); the train
programs (forward, backward, Adam) and the startup programs serialize to
equal JSON. With the JAX startup values copied into the port's scope
(``load_param_arrays``: parameters, Adam moments, beta powers, learning
rate), three Adam steps on a batch of 2 with pad ids (so every mask bites) give
the same losses and step-1 gradients, and the same final parameters. It
runs once on the naive attention route and once with ``use_flash=True``
stamped on every attention op and every ``fwd_op`` copy in both
packages: JAX interprets its Pallas forward and backward kernels, the
port takes their plain twins. The desc-level autodiff, SGD and the
clip/regularizer copies are also held against the JAX package on a
two-fc net.

Tolerances (float32 on the CPU, sums in another order): losses
rtol=1e-4; step-1 gradients rtol=1e-4 with atol=1e-6*max|g| per
parameter (the two packages leave under 7e-7*max|g| of absolute noise
on small entries, where the softmax backward cancels terms); final
parameters atol=1e-4, leaving out entries whose step-1 |g| < 1e-7,
where Adam's first step is lr*sign(g) and the sign of float noise
decides it.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu import layers as ref_layers
from paddle_tpu.core.backward import append_backward as ref_append_backward
from paddle_tpu.models import transformer as ref_transformer
from paddle_tpu_torch import framework, layers
from paddle_tpu_torch.core.backward import append_backward
from paddle_tpu_torch.models import transformer

KW = dict(src_vocab=50, trg_vocab=50, max_len=16, n_layer=1, n_head=2,
          d_model=32, d_inner=64, lr=1e-3)
BATCH, STEPS = 2, 3
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 1e-6
PARAM_ATOL, TINY_GRAD = 1e-4, 1e-7


def _feed():
    rng = np.random.RandomState(0)
    ids = {n: rng.randint(0, KW["src_vocab"], (BATCH, KW["max_len"], 1))
           .astype(np.int64) for n in ("src_ids", "trg_ids", "trg_labels")}
    # id 0 is the pad id: pads in every row, a fully padded target start
    for n in ids:
        ids[n][:, -3:] = 0
    ids["trg_ids"][0, 0] = 0
    ids["pos_ids"] = np.arange(KW["max_len"]).astype(np.int64)
    return ids


def _stamp_flash(main):
    """use_flash=True on every attention op and on the fwd_op copy each
    __vjp__ took at append_backward time."""
    for op in main.desc.global_block.ops:
        if op.type == "scaled_dot_product_attention":
            op.attrs["use_flash"] = True
        elif op.type == "__vjp__" and \
                op.attrs["fwd_op"]["type"] == "scaled_dot_product_attention":
            op.attrs["fwd_op"]["attrs"]["use_flash"] = True
    main.desc._bump_version()


def _builds():
    with ref_framework.isolated_name_scope():
        ref = ref_transformer.build_train(**KW)
    with framework.isolated_name_scope():
        port = transformer.build_train(**KW)
    return ref, port


def _train(built, route):
    (rmain, rstart, rf), (pmain, pstart, pf) = built
    if route == "flash":
        _stamp_flash(rmain)
        _stamp_flash(pmain)
    rscope, rexe = pt.Scope(), pt.Executor()
    rexe.run(rstart, scope=rscope)
    pscope, pexe = ptt.Scope(), ptt.Executor(place="cpu")
    pexe.run(pstart, scope=pscope)
    ptt.load_param_arrays(pscope, {n: np.asarray(rscope.get(n))
                                   for n in pscope.local_names()})
    params = [p.name for p in pmain.all_parameters()]
    grads = [n + "@GRAD" for n in params]
    feed = _feed()
    out, losses = {}, {"ref": [], "port": []}
    # one fetch list for every step: the JAX executor compiles once
    fetch = [pf["loss"].name] + grads
    for step in range(STEPS):
        r = [np.asarray(x) for x in
             rexe.run(rmain, feed=feed, fetch_list=fetch, scope=rscope)]
        p = pexe.run(pmain, feed=feed, fetch_list=fetch, scope=pscope)
        losses["ref"].append(r[0])
        losses["port"].append(p[0])
        if step == 0:
            out["grads"] = {n: (a, b)
                            for n, a, b in zip(params, r[1:], p[1:])}
    out["losses"] = losses
    out["params"] = {n: (np.asarray(rscope.get(n)), pscope.get(n).numpy())
                     for n in params}
    return out


@pytest.fixture(scope="module")
def runs():
    """Both packages' programs, built once: their JSON as built, then a
    naive run and a flash run (fresh scopes; the same programs, stamped
    for the second run)."""
    built = _builds()
    (rmain, rstart, _), (pmain, pstart, _) = built
    out = {"json": [(json.loads(r.desc.to_json()),
                     json.loads(p.desc.to_json()))
                    for r, p in ((rmain, pmain), (rstart, pstart))]}
    out["naive"] = _train(built, "naive")
    out["flash"] = _train(built, "flash")
    return out


@pytest.fixture(params=["naive", "flash"])
def trained(request, runs):
    return request.param, runs[request.param]


def test_build_train_programs_json_equal(runs):
    (rmain, pmain), (rstart, pstart) = runs["json"]
    assert rmain == pmain
    assert rstart == pstart
    ops = [op["type"] for op in pmain["blocks"][0]["ops"]]
    assert ops.count("scaled_dot_product_attention") == 3
    assert ops.count("adam") == len([v for v in
                                     pmain["blocks"][0]["vars"].values()
                                     if v["is_parameter"]])


def test_train_losses_match(trained):
    route, out = trained
    ref, port = (np.concatenate(out["losses"][k]) for k in ("ref", "port"))
    assert np.all(np.isfinite(port)) and port[-1] < port[0]
    np.testing.assert_allclose(port, ref, rtol=LOSS_RTOL, err_msg=route)


def test_step1_gradients_match(trained):
    route, out = trained
    for name, (ref, port) in out["grads"].items():
        np.testing.assert_allclose(
            port, ref, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_FRAC * float(np.abs(ref).max()),
            err_msg=f"{route} {name}@GRAD")


def test_final_params_match(trained):
    route, out = trained
    tiny = 0
    for name, (ref, port) in out["params"].items():
        keep = np.abs(out["grads"][name][0]) >= TINY_GRAD
        tiny += int((~keep).sum())
        np.testing.assert_allclose(port[keep], ref[keep], rtol=0,
                                   atol=PARAM_ATOL,
                                   err_msg=f"{route} {name}")
    total = sum(r.size for r, _ in out["params"].values())
    # the embedding rows of ids absent from the batch have exactly zero
    # gradient; beyond those, sign-noise entries are a small minority
    assert tiny < total // 2, (tiny, total)


# -- the two-fc net: append_backward, SGD, clip and regularizer -----------

def _two_fc(pkg_layers, fw, backward, opt_kind):
    """x -> fc(relu) -> h; loss = sum(fc(h) * h): h has two consumers,
    so its gradient goes through the accumulator's sum op."""
    main, startup = fw.Program(), fw.Program()
    main.random_seed = startup.random_seed = 5
    with fw.program_guard(main, startup), fw.isolated_name_scope():
        x = pkg_layers.data("x", [6], dtype="float32")
        h = pkg_layers.fc(x, size=8, act="relu")
        o = pkg_layers.fc(h, size=8)
        loss = pkg_layers.reduce_sum(pkg_layers.elementwise_mul(o, h))
        if opt_kind is None:
            pairs = backward(loss)
        else:
            pairs = opt_kind(loss)
    return main, startup, loss, pairs


# SGD variants: (regularizer, gradient clip), each built from the package
# module it is given
_SGD_CASES = {
    "sgd": (None, None),
    "sgd_l2_clip": (lambda m: m.L2Decay(0.01),
                    lambda m: m.GradientClipByGlobalNorm(0.5)),
    "sgd_l1_clip_value": (lambda m: m.L1Decay(0.01),
                          lambda m: m.GradientClipByValue(0.05)),
    "sgd_clip_norm": (None, lambda m: m.GradientClipByNorm(0.1)),
}


def _sgd(pkg, clip_mod, reg_mod, opt):
    make_reg, make_clip = _SGD_CASES[opt]

    def minimize(loss):
        if make_clip is not None:
            clip_mod.set_gradient_clip(make_clip(clip_mod),
                                       program=loss.block.program)
        return pkg.optimizer.SGDOptimizer(
            learning_rate=0.1,
            regularization=make_reg and make_reg(reg_mod)).minimize(loss)
    return minimize


def _run_two_fc(opt):
    from paddle_tpu import clip as ref_clip
    from paddle_tpu import regularizer as ref_reg
    from paddle_tpu_torch import clip, optimizer, regularizer  # noqa: F401
    ref_opt = port_opt = None
    if opt != "append_backward":
        ref_opt = _sgd(pt, ref_clip, ref_reg, opt)
        port_opt = _sgd(ptt, clip, regularizer, opt)
    ref = _two_fc(ref_layers, ref_framework, ref_append_backward, ref_opt)
    port = _two_fc(layers, framework, append_backward, port_opt)
    return ref, port


@pytest.mark.parametrize("opt", ["append_backward", *_SGD_CASES])
def test_two_fc_net_matches_reference(opt):
    (rmain, rstart, rloss, _), (pmain, pstart, ploss, _) = _run_two_fc(opt)
    for r, p in ((rmain, pmain), (rstart, pstart)):
        assert json.loads(r.desc.to_json()) == json.loads(p.desc.to_json())
    rscope, rexe = pt.Scope(), pt.Executor()
    rexe.run(rstart, scope=rscope)
    pscope, pexe = ptt.Scope(), ptt.Executor(place="cpu")
    pexe.run(pstart, scope=pscope)
    ptt.load_param_arrays(pscope, {n: np.asarray(rscope.get(n))
                                   for n in pscope.local_names()})
    params = [p.name for p in pmain.all_parameters()]
    fetch = [ploss.name] + [n + "@GRAD" for n in params]
    feed = {"x": np.random.RandomState(1).randn(4, 6).astype(np.float32)}
    for _ in range(2):
        r = rexe.run(rmain, feed=feed, fetch_list=fetch, scope=rscope)
        p = pexe.run(pmain, feed=feed, fetch_list=fetch, scope=pscope)
        for a, b in zip(r, p):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5,
                                       atol=1e-6)
    for n in params:
        np.testing.assert_allclose(pscope.get(n).numpy(),
                                   np.asarray(rscope.get(n)), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_vjp_replay_reuses_the_forward_dropout_mask():
    """The __vjp__ replay draws the dropout mask the forward drew (same
    op seed, same run), and the next run draws a new one."""
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        x = layers.data("x", [64], dtype="float32")
        h = layers.fc(x, size=64, bias_attr=False)
        y = layers.dropout(h, 0.5)
        loss = layers.reduce_sum(y)
        append_backward(loss)
    scope, exe = ptt.Scope(), ptt.Executor(place="cpu")
    exe.run(startup, scope=scope)
    mask_name = [op for op in main.desc.global_block.ops
                 if op.type == "dropout"][0].output("Mask")[0]
    feed = {"x": np.ones((2, 64), np.float32)}
    fetch = [mask_name, h.name + "@GRAD"]
    mask, dh = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    np.testing.assert_array_equal(dh, mask)
    assert 0 < mask.mean() < 1
    mask2, _ = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    assert not np.array_equal(mask, mask2)
    assert torch.is_grad_enabled()
