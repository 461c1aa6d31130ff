"""The compiled executor (paddle_tpu_torch/core/executor.py, the default)
against the eager walk (``Executor(compiled=False)``) and against
paddle_tpu.

Five training programs, each built by both packages at a small size:
MNIST conv (Adam, batch 4), the LSTM LM (1 layer, emb 16, hidden 16,
SGD; the fused-LSTM kernel route, whose plain twins run on the CPU),
the book's GRU encoder-decoder (dict 50, emb 8, hidden 8, Adam; the
fused-GRU kernel route and the flash route, each on its plain twins),
NMT (1+1 layers, d_model 32, Adam) and DeepFM (1000 features,
5 fields, embed 4, batch 8, Adam). Each runs five steps from the JAX
startup values in a compiled arm and an eager arm: a synchronous step,
a ``scope.set`` of a parameter, a ``sync=False`` step, then (dense feeds)
one ``run(iterations=3, stacked_feed=True)`` over three batches, or
(ragged feeds) three more steps. The arms must agree bit for bit:
every fetch, every value in the scope (parameters, accumulators) and
the step counter. The compiled arm's first two steps are held against
paddle_tpu (its default routes, which the CPU runs as scans and the
naive attention) at the tolerances of the existing parity tests:
losses rtol 1e-5 (NMT 1e-4), first-step gradients atol 1e-5 * max|g|
(NMT rtol 1e-4, atol 1e-6 * max|g|).

Then: the compile cache counts the hits and misses paddle_tpu's counts,
for a run sequence (two feed shapes, a repeated and a new fetch list, a
``clone(for_test=True)`` program) and for generation requests across two
buckets; each differentiated forward op's compute rule runs once a step
compiled and twice eager; an intermediate is freed before the step
ends; a program holding dropout records that it cannot be captured, and
the five programs record no such op; ``donate_state=False`` leaves the
caches a caller held as they were.
"""
import importlib
import os
import weakref
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu.core.lod import LoDTensor as RefLoDTensor
from paddle_tpu.serving import generation as ref_generation
from paddle_tpu_torch import framework, layers
from paddle_tpu_torch.core.executor import (STEP_VAR, feed_signature,
                                            to_device_value)
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.core.registry import OpRegistry
from paddle_tpu_torch.serving import generation

_BACKWARDS = [importlib.import_module(f"{pkg}.core.backward")
              for pkg in ("paddle_tpu", "paddle_tpu_torch")]
STEPS = 5


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


def _models(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.models.{name}")


def _gru_nmt(pkg):
    lay = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        src = lay.data("src", [1], dtype="int64", lod_level=1)
        trg = lay.data("trg", [1], dtype="int64", lod_level=1)
        lbl = lay.data("lbl", [1], dtype="int64", lod_level=1)
        enc = lay.dynamic_gru(lay.fc(lay.embedding(src, size=[50, 8]),
                                     size=24), size=8)
        dec = lay.dynamic_gru(lay.fc(lay.embedding(trg, size=[50, 8]),
                                     size=24), size=8)
        ctx = lay.scaled_dot_product_attention(dec, enc, enc)
        logits = lay.fc(lay.concat([dec, ctx], axis=-1), size=50)
        tok = lay.softmax_with_cross_entropy(logits, lbl)
        loss = lay.mean(lay.sequence_pool(tok, "average"))
        pkg.optimizer.AdamOptimizer(learning_rate=3e-3).minimize(loss)
    return main, startup, {"loss": loss}


# name -> (build(pkg), port knobs, loss rtol, grad rtol, grad atol frac)
PROGRAMS = {
    "mnist_conv": (lambda pkg: _models(pkg, "mnist").build_train(
        net="conv"), {}, 1e-5, 0.0, 1e-5),
    "lstm_lm": (lambda pkg: _models(pkg, "lstm_lm").build_train(
        vocab_size=50, emb_dim=16, hid_dim=16, num_layers=1),
        {"PADDLE_TPU_PALLAS_LSTM": "force"}, 1e-5, 0.0, 1e-5),
    "gru_nmt": (_gru_nmt, {"PADDLE_TPU_PALLAS_GRU": "force",
                           "PADDLE_TPU_PALLAS_SDPA": "force"}, 1e-5, 0.0,
                1e-5),
    "nmt": (lambda pkg: _models(pkg, "transformer").build_train(
        src_vocab=50, trg_vocab=50, max_len=16, n_layer=1, n_head=2,
        d_model=32, d_inner=64, lr=1e-3), {}, 1e-4, 1e-4, 1e-6),
    "deepfm": (lambda pkg: _models(pkg, "deepfm").build_train(
        num_features=1000, num_fields=5, embed_dim=4), {}, 1e-5, 0.0,
        1e-5),
}
RAGGED = ("lstm_lm", "gru_nmt")


def _both(build):
    """build(pkg) in each package from equal name and snapshot counts:
    {"ref": ..., "port": ...}."""
    saved = [m._SNAP_COUNTER[0] for m in _BACKWARDS]
    out = {}
    try:
        for who, pkg, fw in (("ref", pt, ref_framework),
                             ("port", ptt, framework)):
            for m in _BACKWARDS:
                m._SNAP_COUNTER[0] = 0
            with fw.isolated_name_scope():
                out[who] = build(pkg)
    finally:
        for m, n in zip(_BACKWARDS, saved):
            m._SNAP_COUNTER[0] = n
    return out


def _feeds(name, lod_cls):
    """STEPS feeds of one program, seeded; ragged feeds keep their
    lengths (one padded shape) and change their ids."""
    rng = np.random.RandomState(0)

    def ids(lengths, hi=50):
        return lod_cls.from_sequences(
            [rng.randint(1, hi, (n, 1)).astype(np.int64) for n in lengths])

    feeds = []
    for _ in range(STEPS):
        if name == "mnist_conv":
            feeds.append({"img": rng.rand(4, 1, 28, 28).astype(np.float32),
                          "label": rng.randint(0, 10, (4, 1))
                          .astype(np.int64)})
        elif name == "lstm_lm":
            feeds.append({"words": ids((5, 3, 7, 2)),
                          "targets": ids((5, 3, 7, 2))})
        elif name == "gru_nmt":
            feeds.append({"src": ids((3, 5, 1, 4)), "trg": ids((4, 2, 6, 3)),
                          "lbl": ids((4, 2, 6, 3))})
        elif name == "nmt":
            f = {n: rng.randint(0, 50, (2, 16, 1)).astype(np.int64)
                 for n in ("src_ids", "trg_ids", "trg_labels")}
            for n in f:
                f[n][:, -3:] = 0  # pads: every mask bites
            f["pos_ids"] = np.arange(16).astype(np.int64)
            feeds.append(f)
        else:
            feeds.append({
                "feat_ids": rng.randint(0, 1000, (8, 5, 1)).astype(np.int64),
                "feat_vals": rng.rand(8, 5).astype(np.float32),
                "label": rng.randint(0, 2, (8, 1)).astype(np.float32)})
    return feeds


def _stacked(feeds):
    return {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}


def _port_arm(built, init, feeds, name, compiled):
    """The five steps in a fresh scope: (fetches per call, scope values,
    step counter, the executor)."""
    main, startup, f = built
    exe = ptt.Executor("cpu", compiled=compiled)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    ptt.load_param_arrays(scope, {n: init[n] for n in scope.local_names()
                                  if n in init})
    params = [p.name for p in main.all_parameters()]
    fetch = [f["loss"].name] + [n + "@GRAD" for n in params]
    out = [exe.run(main, feed=feeds[0], fetch_list=fetch, scope=scope)]
    scope.set(params[0], torch.from_numpy(_halved(init[params[0]])))
    res = exe.run(main, feed=feeds[1], fetch_list=fetch, scope=scope,
                  sync=False)
    assert isinstance(res, ptt.executor.StepResult)
    out.append(res.fetches())
    if name in RAGGED:
        for feed in feeds[2:]:
            out.append(exe.run(main, feed=feed, fetch_list=fetch[:1],
                               scope=scope))
    else:
        out.append(exe.run(main, feed=_stacked(feeds[2:]), fetch_list=fetch,
                           scope=scope, iterations=3, stacked_feed=True))
    state = {n: scope.get(n).numpy() for n in scope.local_names()
             if n != STEP_VAR}
    return out, state, int(scope.get(STEP_VAR)), exe


def _halved(a):
    return (np.asarray(a) * 0.5).astype(np.asarray(a).dtype)


def _ref_arm(built, feeds):
    """paddle_tpu's first two steps: (init, [fetches of step 1, 2])."""
    main, startup, f = built
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.get(n)) for n in scope.local_names()}
    params = [p.name for p in main.all_parameters()]
    fetch = [f["loss"].name] + [n + "@GRAD" for n in params]
    out = [exe.run(main, feed=feeds[0], fetch_list=fetch, scope=scope)]
    scope.set(params[0], jnp.asarray(_halved(init[params[0]])))
    out.append(exe.run(main, feed=feeds[1], fetch_list=fetch, scope=scope))
    return init, [[np.asarray(v) for v in step] for step in out]


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b, equal_nan=True), \
        f"{what}: max |diff| {np.max(np.abs(a - b))}"


def _dense(v):
    return v.data if isinstance(v, LoDTensor) else v


@pytest.fixture(scope="module", params=sorted(PROGRAMS))
def arms(request):
    name = request.param
    build, knobs = PROGRAMS[name][:2]
    built = _both(build)
    init, ref = _ref_arm(built["ref"], _feeds(name, RefLoDTensor))
    feeds = _feeds(name, LoDTensor)
    with mock.patch.dict(os.environ, knobs):
        compiled = _port_arm(built["port"], init, feeds, name, True)
        eager = _port_arm(built["port"], init, feeds, name, False)
    return name, built, ref, compiled, eager


def test_compiled_equals_eager_bit_for_bit(arms):
    name, _, _, compiled, eager = arms
    for i, (c_step, e_step) in enumerate(zip(compiled[0], eager[0])):
        assert len(c_step) == len(e_step)
        for j, (c, e) in enumerate(zip(c_step, e_step)):
            _bitwise(_dense(c), _dense(e), f"{name} call {i} fetch {j}")
    assert sorted(compiled[1]) == sorted(eager[1])
    for n in compiled[1]:
        _bitwise(compiled[1][n], eager[1][n], f"{name} state {n}")
    assert compiled[2] == eager[2] == 1 + STEPS


def test_compiled_matches_paddle_tpu(arms):
    name, built, ref, compiled, _ = arms
    loss_rtol, grad_rtol, atol_frac = PROGRAMS[name][2:]
    params = [p.name for p in built["port"][0].all_parameters()]
    for step in range(2):
        r, p = ref[step], compiled[0][step]
        np.testing.assert_allclose(np.asarray(p[0]).reshape(-1),
                                   r[0].reshape(-1), rtol=loss_rtol,
                                   err_msg=f"{name} loss {step}")
        # gradients at the first step, as the parity tests hold them
        # (after an Adam step, weights whose gradient was float noise
        # moved by lr * its sign)
        for n, rg, pg in zip(params, r[1:], p[1:]) if step == 0 else ():
            np.testing.assert_allclose(
                _dense(pg), rg, rtol=grad_rtol,
                atol=atol_frac * float(np.abs(rg).max()),
                err_msg=f"{name} step {step} {n}@GRAD")


def test_programs_are_capturable_and_read_their_records(arms):
    """No op of the five programs keeps them from a CUDA graph, and every
    __vjp__ op reads its forward op's record (none replays)."""
    name, _, _, compiled, _ = arms
    last = compiled[3].last_compiled
    assert last.uncaptured_ops == () and last.replayed == [], name
    assert last.captured is False  # the CPU captures nothing


# -- the compile cache -------------------------------------------------------

def _fc_net(pkg):
    lay = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [6], dtype="float32")
        y = lay.data("y", [1], dtype="int64")
        pred = lay.fc(lay.fc(x, size=8, act="relu"), size=3, act="softmax")
        loss = lay.mean(lay.cross_entropy(pred, y))
        test = main.clone(for_test=True)
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, test, loss, pred


def test_cache_stats_match_paddle_tpu():
    built = _both(_fc_net)
    rng = np.random.RandomState(0)

    def feed(b):
        return {"x": rng.rand(b, 6).astype(np.float32),
                "y": rng.randint(0, 3, (b, 1)).astype(np.int64)}
    feeds = {4: feed(4), 3: feed(3)}
    stats = {}
    for who, exe, scope in (("ref", pt.Executor(), pt.Scope()),
                            ("port", ptt.Executor("cpu"), ptt.Scope())):
        main, startup, test, loss, pred = built[who]
        runs = [(startup, None, []), (main, 4, [loss]), (main, 4, [loss]),
                (main, 3, [loss]), (main, 4, [loss]),
                (main, 4, [loss, pred]), (main, 4, [loss.name, pred]),
                (test, 4, [pred]), (test, 3, [pred]), (test, 4, [pred])]
        seen = []
        for prog, b, fetch in runs:
            exe.run(prog, feed=feeds.get(b, {}), fetch_list=fetch,
                    scope=scope)
            seen.append(dict(exe.cache_stats))
        stats[who] = seen
    assert stats["port"] == stats["ref"]
    assert stats["port"][-1] == {"hits": 4, "misses": 6}
    main = built["port"][0]
    key = ptt.Executor.compile_key(main, feed_signature(feeds[4]), ["l"])
    ref_key = pt.Executor.compile_key(built["ref"][0], (), ["l"], amp=False)
    assert len(key) == len(ref_key) and key[3:] == ref_key[3:]
    ragged = LoDTensor.from_sequences([np.ones((2, 1), np.int64)] * 3)
    sig = feed_signature({"w": to_device_value(ragged, "cpu")})
    assert sig == (("w", ("ragged", (3, 2, 1), "int64", (3,))),)


def test_generation_cache_stats_match_paddle_tpu():
    """Prefills in two prompt buckets and decodes in two cache buckets,
    repeated: the same hits and misses as the reference's model; with
    donate_state=False the cache tensor held before a prefill keeps its
    values, and with donation it is written in place."""
    kw = dict(vocab_size=40, max_seq_len=16, slots=2, prompt_buckets=[4, 8],
              cache_buckets=[8, 16], n_layer=1, n_head=2, d_model=16,
              d_inner=32, seed=3)
    ref = ref_generation.GenerationModel.build(
        ref_generation.GenerationSpec(**kw))
    port = generation.GenerationModel.build(generation.GenerationSpec(**kw),
                                            device="cpu")
    stats = {"ref": [], "port": []}
    for who, m in (("ref", ref), ("port", port)):
        for call in (lambda: m.run_prefill([3, 4, 5], 0),
                     lambda: m.run_prefill([6, 7], 1),
                     lambda: m.run_prefill([1, 2, 3, 4, 5, 6], 0),
                     lambda: m.run_decode(np.array([5, 7]), np.array([6, 2]),
                                          8),
                     lambda: m.run_decode(np.array([1, 2]), np.array([7, 3]),
                                          8),
                     lambda: m.run_decode(np.array([1, 2]), np.array([9, 3]),
                                          16)):
            call()
            stats[who].append(dict(m.executor.cache_stats))
    assert stats["port"] == stats["ref"]
    assert stats["port"][-1] == {"hits": 2, "misses": 5}

    cache = port.cache_names[0]
    held = port.scope.get(cache)
    before = held.clone()
    port.run_prefill([9, 9, 9], 1)
    assert port.scope.get(cache) is held
    assert not torch.equal(held, before)  # written in place
    port.executor = ptt.Executor("cpu", donate_state=False)
    held = port.scope.get(cache)
    before = held.clone()
    port.run_prefill([8, 8, 8, 8], 0)
    assert torch.equal(held, before)
    assert not torch.equal(port.scope.get(cache), before)


# -- one forward a step, release at last use, the capture flag ---------------

def test_each_forward_op_runs_once_compiled_and_twice_eager(monkeypatch):
    built = _both(_gru_nmt)["port"]
    main, startup, f = built
    ops = main.desc.global_block.ops
    types = {op.type for op in ops} | {op.attrs["fwd_op"]["type"]
                                       for op in ops if op.type == "__vjp__"}
    calls = {}
    for t in types:
        opdef = OpRegistry.get(t)

        def counted(ctx, _t=t, _fn=opdef.compute):
            calls[_t] = calls.get(_t, 0) + 1
            return _fn(ctx)
        monkeypatch.setattr(opdef, "compute", counted)
    feed = _feeds("gru_nmt", LoDTensor)[0]
    vjps = {}
    for op in ops:
        if op.type == "__vjp__":
            t = op.attrs["fwd_op"]["type"]
            vjps[t] = vjps.get(t, 0) + 1
    for compiled in (True, False):
        exe, scope = ptt.Executor("cpu", compiled=compiled), ptt.Scope()
        exe.run(startup, scope=scope)
        calls.clear()
        exe.run(main, feed=feed, fetch_list=[f["loss"]], scope=scope)
        for t in types - {"__vjp__"}:
            n = sum(op.type == t for op in ops)
            want = n + (0 if compiled else vjps.get(t, 0))
            assert calls.get(t, 0) == want, (compiled, t)
        assert calls.get("__vjp__", 0) == (0 if compiled else
                                           sum(vjps.values()))
    assert vjps["gru"] == 2 and vjps["scaled_dot_product_attention"] == 1


def test_intermediate_is_freed_before_the_step_ends(monkeypatch):
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        x = layers.data("x", [4], dtype="float32")
        out = layers.reduce_sum(layers.scale(layers.scale(
            layers.scale(x, 2.0), 3.0), 4.0))
    opdef = OpRegistry.get("scale")
    orig, refs, alive = opdef.compute, [], []

    def watched(ctx):
        orig(ctx)
        if len(refs) == 2:  # the third scale: is the first one's output
            alive.append(refs[0]() is not None)  # still held?
        refs.append(weakref.ref(next(iter(ctx.outputs.values()))))
    monkeypatch.setattr(opdef, "compute", watched)
    for compiled in (True, False):
        refs.clear()
        exe = ptt.Executor("cpu", compiled=compiled)
        got = exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                      fetch_list=[out], scope=ptt.Scope())
        assert float(got[0]) == 192.0
    assert alive == [False, True]  # compiled dropped it, eager kept it


def test_dropout_program_is_compiled_but_not_captured():
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        x = layers.data("x", [8], dtype="float32")
        loss = layers.reduce_sum(layers.dropout(
            layers.fc(x, size=8, bias_attr=False), 0.5))
        ptt.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    exe, scope = ptt.Executor("cpu"), ptt.Scope()
    exe.run(startup, scope=scope)
    assert set(exe.last_compiled.uncaptured_ops) <= {"uniform_random",
                                                     "gaussian_random"}
    assert exe.last_compiled.uncaptured_ops
    exe.run(main, feed={"x": np.ones((2, 8), np.float32)},
            fetch_list=[loss], scope=scope)
    last = exe.last_compiled
    assert last.uncaptured_ops == ("dropout",)
    assert last.captured is False and last.replayed == []
