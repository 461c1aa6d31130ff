"""paddle_tpu_torch's analysis package (verifier, cost model, memory
planner) against paddle_tpu's, on the same programs.

Each case is built by both packages from one seed (equal ``to_json``):
the nine networks of the JAX package's loss-identity gate
(tools/lint_ir.py: fc regression, the MNIST MLP and conv nets, a
sequence pool, an embedding LM, While, StaticRNN, DynamicRNN, IfElse),
its token-serving decode step, an SE block, and a 1+1 Transformer NMT
with the composed attention chain at S8, d16. Held, exactly:

- ``verify_program(...).to_json()``: every diagnostic's code, severity,
  block path, op, var, message and hint (the full default passes, the
  uninit-persistable pass with the startup program included, and the
  shape pass's re-run of each op's inference);
- ``program_cost``: per-op FLOPs, bytes, parameter bytes, exactness
  and notes, on the program as built and on the rewritten one;
- ``program_memory``: peak and ideal-peak bytes, resident and
  activation bytes, the high-water op and the top buffers, and the
  budget diagnostic at an explicit ``PADDLE_TPU_HBM_BYTES`` in both
  packages.

test_torch_rewrite.py imports the build functions (``NETWORKS``, ``both``).
"""
import functools
import importlib
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.lod import LoDTensor as RefLoDTensor
from paddle_tpu_torch.core.lod import LoDTensor

PKGS = ("paddle_tpu", "paddle_tpu_torch")
_BACKWARDS = [importlib.import_module(f"{p}.core.backward") for p in PKGS]
_REWRITES = [importlib.import_module(f"{p}.analysis.rewrite") for p in PKGS]
NMT = dict(src_vocab=30, trg_vocab=30, max_len=8, n_layer=1, n_head=2,
           d_model=16, d_inner=32, lr=1e-3)


# -- the networks, each built by either package --------------------------

def _fc_regression(pkg):
    lay = pkg.layers
    x = lay.data("x", [13])
    y = lay.data("y", [1])
    pred = lay.fc(x, size=1)
    loss = lay.mean(lay.square(pred - y))
    pkg.optimizer.SGDOptimizer(learning_rate=0.01).minimize(loss)
    return ["x", "y"], [loss.name]


def _mnist(net):
    def build(pkg):
        lay = pkg.layers
        mnist = importlib.import_module(f"{pkg.__name__}.models.mnist")
        img = lay.data("img", [784] if net == "mlp" else [1, 28, 28])
        label = lay.data("label", [1], dtype="int64")
        fn = mnist.mlp if net == "mlp" else mnist.conv_net
        _pred, loss, acc = fn(img, label)
        pkg.optimizer.AdamOptimizer(learning_rate=0.001).minimize(loss)
        return ["img", "label"], [loss.name, acc.name]
    return build


def _seq_pool(pkg):
    lay = pkg.layers
    seq = lay.data("seq", [16], lod_level=1)
    y = lay.data("y", [1])
    h = lay.fc(seq, size=16, act="tanh")
    pooled = lay.sequence_pool(h, "sum")
    loss = lay.mean(lay.square(lay.fc(pooled, size=1) - y))
    pkg.optimizer.SGDOptimizer(learning_rate=0.01).minimize(loss)
    return ["seq", "y"], [loss.name]


def _embedding_lm(pkg):
    lay = pkg.layers
    words = lay.data("words", [1], dtype="int64", lod_level=1)
    label = lay.data("label", [1], dtype="int64")
    emb = lay.embedding(words, size=[100, 16])
    pooled = lay.sequence_pool(emb, "sum")
    pred = lay.fc(pooled, size=100, act="softmax")
    loss = lay.mean(lay.cross_entropy(input=pred, label=label))
    pkg.optimizer.SGDOptimizer(learning_rate=0.01).minimize(loss)
    return ["words", "label"], [loss.name]


def _while_loop(pkg):
    lay = pkg.layers
    x = lay.data("x", [4])
    i = lay.fill_constant([1], "int32", 0)
    n = lay.fill_constant([1], "int32", 3)
    s = lay.fc(x, size=4)
    w = lay.While(lay.less_than(i, n), max_steps=8)
    with w.block():
        lay.assign(lay.elementwise_add(s, s), s)
        lay.assign(lay.increment(i, in_place=False), i)
    out = lay.mean(s)
    return ["x"], [out.name]


def _static_rnn(pkg):
    lay = pkg.layers
    x = lay.data("x", [5, 4, 8], append_batch_size=False)
    rnn = lay.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        mem = rnn.memory(shape=[4, 8], value=0.0)
        nh = lay.fc(lay.elementwise_add(xt, mem), size=8, act="tanh")
        rnn.update_memory(mem, nh)
        rnn.step_output(nh)
    out = lay.mean(rnn())
    return ["x"], [out.name]


def _dynamic_rnn(pkg):
    lay = pkg.layers
    sent = lay.data("sent", [8], lod_level=1)
    drnn = lay.DynamicRNN()
    with drnn.block():
        wd = drnn.step_input(sent)
        mem = drnn.memory(shape=[8], value=0.0)
        nh = lay.fc(lay.elementwise_add(wd, mem), size=8, act="tanh")
        drnn.update_memory(mem, nh)
        drnn.output(nh)
    last = lay.sequence_last_step(drnn())
    out = lay.mean(lay.fc(last, size=1))
    return ["sent"], [out.name]


def _ifelse(pkg):
    lay = pkg.layers
    x = lay.data("x", [4])
    cond = lay.less_than(lay.mean(x),
                         lay.fill_constant([1], "float32", 0.5))
    ie = lay.IfElse(cond)
    with ie.true_block():
        ie.output(lay.elementwise_add(x, x))
    with ie.false_block():
        ie.output(lay.elementwise_sub(x, x))
    out = lay.mean(ie())
    return ["x"], [out.name]


def _se_block(pkg):
    """The JAX package's models/resnet.py squeeze_excitation, as its
    tests/test_rewrite.py builds it: c 8, reduction 4, SGD."""
    lay = pkg.layers
    x = lay.data("x", [8, 4, 4])
    lbl = lay.data("lbl", [8, 4, 4])
    pool = lay.pool2d(x, pool_type="avg", global_pooling=True)
    squeeze = lay.fc(pool, size=2, act="relu")
    excitation = lay.fc(squeeze, size=8, act="sigmoid")
    gates = lay.reshape(excitation, [-1, 8, 1, 1])
    gated = lay.elementwise_mul(x, gates, axis=0)
    loss = lay.mean(lay.square(gated - lbl))
    pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return ["x", "lbl"], [loss.name]


def _decoder_lm_step(pkg):
    tf = importlib.import_module(f"{pkg.__name__}.models.transformer")
    lm = tf.build_decoder_lm(
        vocab_size=64, max_seq_len=16, slots=2, prompt_buckets=(8, 16),
        cache_buckets=(8, 16), n_layer=1, n_head=2, d_model=16,
        d_inner=32, seed=0)["decode"][16]
    return lm.main, lm.startup, lm.feed_names, [lm.fetch_name]


def _nmt_composed(pkg):
    tf = importlib.import_module(f"{pkg.__name__}.models.transformer")
    main, startup, f = tf.build_train(attention_impl="composed", **NMT)
    return main, startup, ["src_ids", "trg_ids", "trg_labels", "pos_ids"], \
        [f["loss"].name]


def _in_programs(build):
    """Wrap the layer calls of `build` in a fresh (main, startup) pair."""
    def make(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            feeds, fetches = build(pkg)
        return main, startup, feeds, fetches
    return make


#: name -> build(pkg) -> (main, startup, feed names, fetch names)
NETWORKS = {
    "fc_regression": _in_programs(_fc_regression),
    "mnist_mlp": _in_programs(_mnist("mlp")),
    "mnist_conv": _in_programs(_mnist("conv")),
    "seq_pool": _in_programs(_seq_pool),
    "embedding_lm": _in_programs(_embedding_lm),
    "while_loop": _in_programs(_while_loop),
    "static_rnn": _in_programs(_static_rnn),
    "dynamic_rnn": _in_programs(_dynamic_rnn),
    "ifelse": _in_programs(_ifelse),
    "decoder_lm_step": _decoder_lm_step,
    "se_block": _in_programs(_se_block),
    "nmt_composed": _nmt_composed,
}
#: the nine networks of the JAX package's loss-identity gate
GATE = ["fc_regression", "mnist_mlp", "mnist_conv", "seq_pool",
        "embedding_lm", "while_loop", "static_rnn", "dynamic_rnn",
        "ifelse"]


@functools.lru_cache(maxsize=None)
def both(name):
    """{"ref": built by paddle_tpu, "port": by paddle_tpu_torch}, each
    (main, startup, feed names, fetch names), the backward's snapshot
    counter and the outliner's counter started alike in both."""
    out = {}
    saved = [m._SNAP_COUNTER[0] for m in _BACKWARDS]
    try:
        for who, pkg in (("ref", pt), ("port", ptt)):
            for m in _BACKWARDS:
                m._SNAP_COUNTER[0] = 0
            with pkg.framework.isolated_name_scope():
                out[who] = NETWORKS[name](pkg)
    finally:
        for m, n in zip(_BACKWARDS, saved):
            m._SNAP_COUNTER[0] = n
    return out


def rewrite_both(name):
    """rewrite_program of the case in each package, the outliner's
    fresh-name counter started alike."""
    built = both(name)
    out = {}
    for who, mod in zip(("ref", "port"), _REWRITES):
        main, _startup, feeds, fetches = built[who]
        mod._OUTLINE_UID[0] = 0
        out[who] = mod.rewrite_program(main, feed_names=feeds,
                                       fetch_names=fetches)
    return out


def network_feed(name, port=True):
    """The feed of the JAX package's tests/test_rewrite.py _network_feed
    (seed 7), plus the decode step's, the SE block's and the NMT's."""
    lod = LoDTensor if port else RefLoDTensor
    rng = np.random.RandomState(7)
    f32 = np.float32
    if name == "fc_regression":
        return {"x": rng.rand(2, 13).astype(f32),
                "y": rng.rand(2, 1).astype(f32)}
    if name == "mnist_mlp":
        return {"img": rng.rand(2, 784).astype(f32),
                "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
    if name == "mnist_conv":
        return {"img": rng.rand(2, 1, 28, 28).astype(f32),
                "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
    if name == "seq_pool":
        return {"seq": lod(rng.rand(5, 16).astype(f32), [[0, 3, 5]]),
                "y": rng.rand(2, 1).astype(f32)}
    if name == "embedding_lm":
        return {"words": lod(rng.randint(0, 100, (6, 1)).astype(np.int64),
                             [[0, 2, 6]]),
                "label": rng.randint(0, 100, (2, 1)).astype(np.int64)}
    if name in ("while_loop", "ifelse"):
        return {"x": rng.rand(2, 4).astype(f32)}
    if name == "static_rnn":
        return {"x": rng.rand(5, 4, 8).astype(f32)}
    if name == "dynamic_rnn":
        return {"sent": lod(rng.rand(5, 8).astype(f32), [[0, 2, 5]])}
    if name == "se_block":
        return {"x": rng.rand(2, 8, 4, 4).astype(f32),
                "lbl": rng.rand(2, 8, 4, 4).astype(f32)}
    if name == "decoder_lm_step":
        return {"token_ids": rng.randint(1, 64, (2, 1, 1)).astype(np.int64),
                "positions": np.asarray([3, 5], np.int64)}
    if name == "nmt_composed":
        ids = {n: rng.randint(1, NMT["src_vocab"], (2, NMT["max_len"], 1))
               .astype(np.int64)
               for n in ("src_ids", "trg_ids", "trg_labels")}
        for n in ids:   # id 0 pads: every mask bites
            ids[n][:, -2:] = 0
        ids["pos_ids"] = np.arange(NMT["max_len"]).astype(np.int64)
        return ids
    raise KeyError(name)


def _dense_shapes(name):
    return {k: v.shape for k, v in network_feed(name).items()
            if isinstance(v, np.ndarray)}


def _module(who, mod):
    return importlib.import_module(
        f"{dict(ref=PKGS[0], port=PKGS[1])[who]}.analysis.{mod}")


# -- the tests -------------------------------------------------------------

@pytest.mark.parametrize("name", list(NETWORKS))
def test_programs_serialize_equal(name):
    built = both(name)
    for i in (0, 1):
        assert built["ref"][i].desc.to_json() == \
            built["port"][i].desc.to_json()


@pytest.mark.parametrize("name", list(NETWORKS))
def test_verify_report_matches_reference(name):
    reports = {}
    for who in ("ref", "port"):
        main, startup, feeds, fetches = both(name)[who]
        reports[who] = json.loads(_module(who, "verifier").verify_program(
            main, startup=startup, feed_names=feeds,
            fetch_names=fetches).to_json())
    assert reports["port"] == reports["ref"]
    assert reports["port"]["ok"], reports["port"]


@pytest.mark.parametrize("name", list(NETWORKS))
def test_cost_matches_reference(name):
    progs = rewrite_both(name)
    for rewritten in (False, True):
        costs = {}
        for who in ("ref", "port"):
            main = progs[who].program if rewritten else both(name)[who][0]
            cost = _module(who, "cost_model").program_cost(
                main, feed_shapes=_dense_shapes(name)).to_dict()
            cost.pop("label")
            costs[who] = cost
        assert costs["port"] == costs["ref"], rewritten
        assert costs["port"]["flops"] > 0


@pytest.mark.parametrize("name", list(NETWORKS))
def test_memory_matches_reference(name, monkeypatch):
    # an explicit budget in both packages: the port reads no device
    # memory on the CPU, the JAX package would take a TPU core's
    monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", str(1 << 30))
    progs = rewrite_both(name)
    for rewritten in (False, True):
        got = {}
        for who in ("ref", "port"):
            memory = _module(who, "memory")
            main = progs[who].program if rewritten else both(name)[who][0]
            rep = memory.program_memory(
                main, feed_shapes=_dense_shapes(name),
                feed_names=both(name)[who][2])
            d = rep.to_dict()
            d.pop("label")
            fits = memory.check_budget(rep)
            half = memory.check_budget(rep, budget=rep.peak_bytes // 2)
            got[who] = (d, memory.hbm_budget_bytes(), fits.ok,
                        [(x.code, str(x.severity), x.block_path,
                          x.op_index, x.op_type, x.message)
                         for x in half.diagnostics])
        assert got["port"] == got["ref"], rewritten
        d, budget, fits, half = got["port"]
        assert budget == 1 << 30 and fits
        assert 0 < d["ideal_peak_bytes"] <= d["peak_bytes"]
        assert [h[0] for h in half] == ["hbm-oom"]


def test_budget_default_is_the_device_memory(monkeypatch):
    """Unset, the budget is the device's memory on a card and none on
    the CPU; set, it is the environment's ("0" disables the gate)."""
    from paddle_tpu_torch.analysis import memory
    monkeypatch.delenv("PADDLE_TPU_HBM_BYTES", raising=False)
    assert memory.hbm_budget_bytes() == 0
    assert memory.hbm_budget_bytes("cpu") == 0
    monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", "2e9")
    assert memory.hbm_budget_bytes("cpu") == 2_000_000_000
    monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", "0")
    assert memory.hbm_budget_bytes() == 0
