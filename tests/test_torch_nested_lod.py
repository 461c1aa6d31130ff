"""Nested LoD in paddle_tpu_torch (RaggedNested, RaggedTree) against
paddle_tpu on the CPU.

- Host round trips of 2-, 3- and 4-level LoDTensors (from_nested_sequences,
  to/from_nested_padded, from_depth_sequences, to/from_tree_padded):
  the same offsets and padded arrays as the reference's.
- The in-graph values: masks and flatten (padding slots become length-0
  rows) equal to the reference's.
- Nested and tree feeds through both of the port's executors (compiled
  and eager), fetched back as LoDTensors with the feed's LoD; nested
  sequence_pool, each pool type; the compile key's nested signatures;
  ``iterations=K`` with a nested feed; ``device_feed``.
- DataFeeder's nested and tree columns: the same padded arrays and
  buckets as the reference's DataFeeder.
- The 2- and 3-level hierarchical models of tests/test_nested_lod.py and
  the book's sentiment program (tests/test_book.py test_understand_
  sentiment): equal JSON, then 3 Adam steps on both packages from the
  same seeded startup values; the port's compiled and eager executors
  bit for bit equal, and the hierarchical models also through the port's
  fused-LSTM route (its plain twins on the CPU) over the length-0 rows
  the flatten makes.
- The layer wrappers of slice 17 build the reference's programs, their
  parameters carry in by name (``load_param_arrays``), and an
  inference model with a nested feed saves, reloads in the port (bit for
  bit) and in paddle_tpu (same values).

Tolerances (float32 on the CPU, sums in another order): losses rtol
1e-5; step-1 gradients atol 1e-5 * max|g| (over the step's whole
gradient in the training runs); final parameters atol 1e-5
(3 Adam steps at lr <= 1e-2); forward values atol 1e-5; integer values
and LoD exact.
"""
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
from paddle_tpu import framework as ref_framework
from paddle_tpu.core import lod as ref_lod
from paddle_tpu.data_feeder import DataFeeder as RefDataFeeder
from paddle_tpu_torch import framework
from paddle_tpu_torch.core import lod
from paddle_tpu_torch.core.executor import device_feed, feed_signature
from paddle_tpu_torch.data_feeder import DataFeeder

ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_ATOL_FRAC = 1e-5
PKGS = {"ref": (pt, ref_framework, ref_lod), "port": (ptt, framework, lod)}


@pytest.fixture(autouse=True)
def _fresh_port_scope():
    ptt.reset_global_scope()
    yield
    ptt.reset_global_scope()


def _nested_fixture(rng, n=3, feat=4):
    return [[rng.rand(rng.randint(1, 5), feat).astype(np.float32)
             for _ in range(i + 1)] for i in range(n)]


def _tree_fixture(rng, n=3, feat=4):
    return [[[rng.rand(rng.randint(1, 5), feat).astype(np.float32)
              for _ in range(rng.randint(1, 4))] for _ in range(i + 1)]
            for i in range(n)]


def _depth4_fixture(rng):
    return [[[[rng.rand(rng.randint(1, 3), 2).astype(np.float32)
               for _ in range(rng.randint(1, 3))]
              for _ in range(rng.randint(1, 3))] for _ in range(i + 1)]
            for i in range(2)]


def _same_lodtensor(got, want, what, exact=False):
    assert got.lod == want.lod, f"{what}: lod {got.lod} vs {want.lod}"
    g, w = np.asarray(got.data), np.asarray(want.data)
    assert g.shape == w.shape, f"{what}: {g.shape} vs {w.shape}"
    if exact:
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=what)


# -- host round trips --------------------------------------------------------

@pytest.mark.parametrize("depth", [2, 3, 4])
def test_host_round_trips_match_reference(depth):
    rng = np.random.RandomState(depth)
    fixture = {2: _nested_fixture, 3: _tree_fixture,
               4: _depth4_fixture}[depth](rng)
    feat = (4,) if depth < 4 else (2,)
    got, want = (L.LoDTensor.from_depth_sequences(fixture, depth,
                                                  feat_shape=feat)
                 for L in (lod, ref_lod))
    _same_lodtensor(got, want, "from_depth_sequences", exact=True)
    assert len(got.lod) == depth
    data, lengths = got.to_tree_padded()
    rdata, rlengths = want.to_tree_padded()
    np.testing.assert_array_equal(data, rdata)
    for a, b in zip(lengths, rlengths):
        np.testing.assert_array_equal(a, b)
    assert data.ndim == depth + 2
    _same_lodtensor(lod.LoDTensor.from_tree_padded(data, lengths), got,
                    "tree round trip", exact=True)
    if depth == 2:
        nested = lod.LoDTensor.from_nested_sequences(fixture)
        _same_lodtensor(nested, got, "from_nested_sequences", exact=True)
        padded = nested.to_nested_padded()
        for a, b in zip(padded, want.to_nested_padded()):
            np.testing.assert_array_equal(a, b)
        _same_lodtensor(lod.LoDTensor.from_nested_padded(*padded), nested,
                        "nested round trip", exact=True)
        for a_out, b_out in zip(fixture, nested.nested_sequences()):
            assert len(a_out) == len(b_out)
            for a, b in zip(a_out, b_out):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_in_graph_masks_and_flatten_match_reference(depth):
    """mask() and flatten() of the in-graph value, down to level 1: the
    reference's values, padding slots as length-0 rows."""
    rng = np.random.RandomState(10 + depth)
    fixture = {2: _nested_fixture, 3: _tree_fixture,
               4: _depth4_fixture}[depth](rng)
    t = lod.LoDTensor.from_depth_sequences(fixture, depth)
    data, lengths = t.to_tree_padded()

    def build(L, arr):
        ls = [arr(l) for l in lengths]
        if depth == 2:
            return L.RaggedNested(arr(data), *ls)
        return L.RaggedTree(arr(data), ls)

    got = build(lod, torch.from_numpy)
    want = build(ref_lod, jnp.asarray)
    while True:
        np.testing.assert_array_equal(got.mask().numpy(),
                                      np.asarray(want.mask()))
        if isinstance(got, lod.RaggedPair):
            np.testing.assert_array_equal(got.lengths.numpy(),
                                          np.asarray(want.lengths))
            assert (got.lengths == 0).any()
            break
        got, want = got.flatten(), want.flatten()
        assert type(got).__name__ == type(want).__name__
        np.testing.assert_array_equal(got.data.numpy(),
                                      np.asarray(want.data))


# -- feeds and fetches -------------------------------------------------------

def _scale_program(pkg, lod_level):
    mod, fw, _ = PKGS[pkg]
    main, startup = fw.Program(), fw.Program()
    with fw.isolated_name_scope(), fw.program_guard(main, startup):
        x = mod.layers.data("x", [4], dtype="float32", lod_level=lod_level)
        y = mod.layers.scale(x, scale=2.0)
    return main, y


def _executors():
    return [ptt.Executor("cpu"), ptt.Executor("cpu", compiled=False)]


@pytest.mark.parametrize("depth", [2, 3])
def test_nested_feed_fetch_preserves_lod(depth):
    """A scale of the fed value (not ragged-aware: re-wrapped with every
    lengths tensor) comes back as a LoDTensor with the feed's LoD, in
    both executors and in paddle_tpu alike."""
    rng = np.random.RandomState(20 + depth)
    fixture = _nested_fixture(rng) if depth == 2 else _tree_fixture(rng)
    outs = []
    for pkg in ("ref", "port"):
        main, y = _scale_program(pkg, depth)
        t = PKGS[pkg][2].LoDTensor.from_depth_sequences(fixture, depth,
                                                        feat_shape=(4,))
        exes = [pt.Executor()] if pkg == "ref" else _executors()
        for exe in exes:
            (out,) = exe.run(main, feed={"x": t}, fetch_list=[y],
                             scope=PKGS[pkg][0].Scope())
            outs.append(out)
    for out in outs[1:]:
        _same_lodtensor(out, outs[0], f"depth {depth} fetch")
    np.testing.assert_allclose(outs[1].data, 2.0 * t.data, rtol=1e-6)


def test_nested_compile_keys_and_iterations():
    """Nested feeds key the compile cache as the reference's do
    (("ragged2", data shape, dtype, tok_lengths shape), ("raggedk",
    depth, data shape, dtype)); a second batch of the same buckets hits
    the cache; iterations=K with a nested feed runs the block K times
    over the same feed."""
    rng = np.random.RandomState(30)
    nested = lod.LoDTensor.from_nested_sequences(_nested_fixture(rng))
    tree = lod.LoDTensor.from_depth_sequences(_tree_fixture(rng), 3,
                                              feat_shape=(4,))
    dev = torch.device("cpu")
    from paddle_tpu_torch.core.executor import to_device_value
    sig = dict(feed_signature({"a": to_device_value(nested, dev),
                               "b": to_device_value(tree, dev)}))
    data = nested.to_nested_padded()[0]
    assert sig["a"] == ("ragged2", data.shape, "float32",
                        data.shape[:2])
    assert sig["b"] == ("raggedk", 3, tree.to_tree_padded()[0].shape,
                        "float32")
    main, y = _scale_program("port", 2)
    exe, scope = ptt.Executor("cpu"), ptt.Scope()
    exe.run(main, feed={"x": nested}, fetch_list=[y], scope=scope)
    exe.run(main, feed={"x": lod.LoDTensor.from_nested_padded(
        *[np.asarray(a) for a in nested.to_nested_padded()])},
        fetch_list=[y], scope=scope)
    assert exe.cache_stats == {"hits": 1, "misses": 1}
    (out,) = exe.run(main, feed={"x": nested}, fetch_list=[y], scope=scope,
                     iterations=3)
    _same_lodtensor(out, lod.LoDTensor(2.0 * nested.data, nested.lod),
                    "iterations=3")


@pytest.mark.parametrize("ptype", ["SUM", "AVERAGE", "SQRT", "MAX", "LAST",
                                   "FIRST"])
def test_nested_sequence_pool_matches_reference(ptype):
    """Pooling the token level of a nested feed gives a level-1 LoDTensor
    over the outer level; pooling that gives a dense [n, feat]."""
    rng = np.random.RandomState(40)
    fixture = _nested_fixture(rng)
    got = {}
    for pkg in ("ref", "port"):
        mod, fw, L = PKGS[pkg]
        main, startup = fw.Program(), fw.Program()
        with fw.isolated_name_scope(), fw.program_guard(main, startup):
            x = mod.layers.data("x", [4], dtype="float32", lod_level=2)
            inner = mod.layers.sequence_pool(x, ptype)
            outer = mod.layers.sequence_pool(inner, "sum")
        exe = pt.Executor() if pkg == "ref" else ptt.Executor("cpu")
        got[pkg] = exe.run(main, feed={"x": L.LoDTensor.
                                       from_nested_sequences(fixture)},
                           fetch_list=[inner, outer],
                           scope=mod.Scope())
        got[pkg + "_json"] = json.loads(main.desc.to_json())
    assert got["ref_json"] == got["port_json"]
    _same_lodtensor(got["port"][0], got["ref"][0], f"{ptype} inner")
    np.testing.assert_allclose(got["port"][1], np.asarray(got["ref"][1]),
                               rtol=0, atol=ATOL)


def test_device_feed_carries_nested_feeds():
    """device_feed (the Trainer's prefetch and DataFeeder.feed_device)
    converts a nested and a tree column to their in-graph forms."""
    rng = np.random.RandomState(50)
    feed = device_feed({
        "a": lod.LoDTensor.from_nested_sequences(_nested_fixture(rng)),
        "b": lod.LoDTensor.from_depth_sequences(_tree_fixture(rng), 3)},
        "cpu")
    assert isinstance(feed["a"], lod.RaggedNested)
    assert isinstance(feed["b"], lod.RaggedTree) and feed["b"].depth == 3
    assert feed["a"].tok_lengths.dtype == torch.int32
    assert all(l.dtype == torch.int32 for l in feed["b"].lengths)
    main, y = _scale_program("port", 2)
    (out,) = ptt.Executor("cpu").run(main, feed={"x": feed["a"]},
                                     fetch_list=[y], scope=ptt.Scope())
    assert out.lod[0] == [0, 1, 3, 6]


# -- DataFeeder --------------------------------------------------------------

class _Var:
    def __init__(self, name, shape, dtype, lod_level):
        self.name, self.shape, self.dtype = name, shape, dtype
        self.lod_level = lod_level


@pytest.mark.parametrize("kwargs", [{}, {"pad_multiple": 8},
                                    {"sub_pad_multiple": 1},
                                    {"max_lens": {"docs": 3}}])
def test_data_feeder_nested_and_tree_columns_match_reference(kwargs):
    """Nested (lod_level 2) and tree (3) columns: the same padded data,
    lengths and buckets as the reference's DataFeeder."""
    rng = np.random.RandomState(60)
    docs = _Var("docs", [-1, 1], "int64", 2)
    tree = _Var("tree", [-1, 2], "float32", 3)
    batch = []
    for i in range(3):
        doc = [rng.randint(1, 9, rng.randint(1, 7)).tolist()
               for _ in range(rng.randint(1, 6))]
        t = [[rng.rand(rng.randint(1, 4), 2).astype(np.float32)
              for _ in range(rng.randint(1, 3))] for _ in range(i + 1)]
        batch.append((doc, t))
    got = DataFeeder([docs, tree], **kwargs).feed(batch)
    want = RefDataFeeder([docs, tree], **kwargs).feed(batch)
    for name, kind in (("docs", lod.RaggedNested), ("tree", lod.RaggedTree)):
        assert isinstance(got[name], kind)
        g, w = lod.ragged_parts(got[name]), want[name].tree_flatten()[0]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    sub = got["docs"].data.shape[1]
    assert sub % kwargs.get("sub_pad_multiple", 4) == 0


# -- the hierarchical models and the sentiment program -----------------------

VOCAB, EMB, HID = 30, 8, 8


def _hier2(pkg):
    """tests/test_nested_lod.py test_hierarchical_rnn_trains."""
    mod, fw, _ = PKGS[pkg]
    layers = mod.layers
    main, startup = fw.Program(), fw.Program()
    with fw.isolated_name_scope(), fw.program_guard(main, startup):
        docs = layers.data("docs", [1], dtype="int64", lod_level=2)
        label = layers.data("label", [1], dtype="int64")
        e = layers.embedding(docs, size=[VOCAB, EMB])
        toks = layers.nested_sequence_flatten(e)
        h, _ = layers.dynamic_lstm(layers.fc(toks, size=4 * HID),
                                   size=4 * HID)
        sents = layers.nested_sequence_pack(layers.sequence_last_step(h),
                                            docs)
        h2, _ = layers.dynamic_lstm(layers.fc(sents, size=4 * HID),
                                    size=4 * HID)
        logits = layers.fc(layers.sequence_last_step(h2), size=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        mod.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    return main, startup, loss, logits


def _hier3(pkg):
    """tests/test_nested_lod.py test_three_level_hierarchical_model_
    trains."""
    mod, fw, _ = PKGS[pkg]
    layers = mod.layers
    main, startup = fw.Program(), fw.Program()
    with fw.isolated_name_scope(), fw.program_guard(main, startup):
        docs = layers.data("docs", [1], dtype="int64", lod_level=3)
        label = layers.data("label", [1], dtype="int64")
        paras = layers.nested_sequence_flatten(docs)
        sents = layers.nested_sequence_flatten(paras)
        e = layers.embedding(sents, size=[VOCAB, EMB])
        h, _ = layers.dynamic_lstm(layers.fc(e, size=4 * HID), size=4 * HID)
        sent_seq = layers.nested_sequence_pack(layers.sequence_last_step(h),
                                               paras)
        para_seq = layers.nested_sequence_pack(
            layers.sequence_pool(sent_seq, "sum"), docs)
        logits = layers.fc(layers.sequence_pool(para_seq, "sum"), size=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        mod.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    return main, startup, loss, logits


def _sentiment(pkg):
    """tests/test_book.py test_understand_sentiment (conv + LSTM)."""
    mod, fw, _ = PKGS[pkg]
    layers = mod.layers
    main, startup = fw.Program(), fw.Program()
    with fw.isolated_name_scope(), fw.program_guard(main, startup):
        words = layers.data("words", [1], dtype="int64", lod_level=1)
        label = layers.data("label", [1], dtype="int64")
        e = layers.embedding(words, size=[VOCAB, EMB])
        conv = layers.sequence_conv(e, num_filters=HID, filter_size=3,
                                    act="relu")
        pooled = layers.sequence_pool(conv, pool_type="max")
        h, _ = layers.dynamic_lstm(layers.fc(e, size=4 * HID), size=4 * HID)
        last = layers.sequence_last_step(h)
        logits = layers.fc(layers.concat([pooled, last], axis=-1), size=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        mod.optimizer.AdamOptimizer(learning_rate=5e-3).minimize(loss)
    return main, startup, loss, logits


def _feed(model, L):
    rng = np.random.RandomState({"hier2": 3, "hier3": 10,
                                 "sentiment": 0}[model])
    label = np.asarray([[i % 2] for i in range(4)], np.int64)

    def ids(n):
        return rng.randint(1, VOCAB, (n, 1)).astype(np.int64)

    if model == "hier2":
        docs = [[ids(rng.randint(2, 6)) for _ in range(rng.randint(1, 4))]
                for _ in range(4)]
        return {"docs": L.LoDTensor.from_nested_sequences(docs),
                "label": label}
    if model == "hier3":
        trees = [[[ids(rng.randint(2, 5)) for _ in range(rng.randint(1, 3))]
                  for _ in range(rng.randint(1, 3))] for _ in range(4)]
        return {"docs": L.LoDTensor.from_depth_sequences(
            trees, 3, feat_shape=(1,), dtype=np.int64), "label": label}
    return {"words": L.LoDTensor.from_sequences(
        [ids(n) for n in (5, 1, 7, 3)]), "label": label}


BUILDERS = {"hier2": _hier2, "hier3": _hier3, "sentiment": _sentiment}


def seeded_init(startup, seed=0):
    """numpy values for every variable `startup` initializes, drawn from
    `seed` with the distribution its init op names (no startup run: the
    reference's would be one more JAX compile)."""
    rng = np.random.RandomState(seed)
    out = {}
    for op in startup.desc.global_block.ops:
        a = op.attrs
        if op.type == "uniform_random":
            v = rng.uniform(a["min"], a["max"], a["shape"])
        elif op.type == "gaussian_random":
            v = rng.normal(a["mean"], a["std"], a["shape"])
        else:
            assert op.type == "fill_constant", op.type
            v = np.full(a["shape"], a["value"])
        out[op.output("Out")[0]] = v.astype(a.get("dtype", "float32"))
    return out


def _scope_with(pkg, startup, init):
    """A scope holding `init`: the reference's set directly, the port's
    through its startup run and load_param_arrays."""
    if pkg == "ref":
        scope = pt.Scope()
        for n, v in init.items():
            scope.set(n, jnp.asarray(v))
        return scope
    scope = ptt.Scope()
    ptt.Executor("cpu").run(startup, scope=scope)
    ptt.load_param_arrays(scope, init)
    return scope


def _train(pkg, model, built, exe, init, steps=3):
    main, startup, loss, _ = built
    scope = _scope_with(pkg, startup, init)
    params = [p.name for p in main.all_parameters()]
    feed = _feed(model, PKGS[pkg][2])
    losses, grads = [], None
    for step in range(steps):
        out = exe.run(main, feed=feed, scope=scope,
                      fetch_list=[loss.name] + [p + "@GRAD" for p in params])
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        if step == 0:
            grads = {p: np.asarray(g) for p, g in zip(params, out[1:])}
    final = {p: np.asarray(scope.get(p)) if pkg == "ref"
             else scope.get(p).numpy() for p in params}
    return losses, grads, final


@pytest.fixture(scope="module")
def trained():
    out = {}
    for model, build in BUILDERS.items():
        ref, port = build("ref"), build("port")
        out[model, "json"] = [(json.loads(r.desc.to_json()),
                               json.loads(p.desc.to_json()))
                              for r, p in zip(ref[:2], port[:2])]
        init = seeded_init(ref[1])
        out[model, "ref"] = _train("ref", model, ref, pt.Executor(), init)
        out[model, "compiled"] = _train("port", model, port,
                                        ptt.Executor("cpu"), init)
        out[model, "eager"] = _train("port", model, port,
                                     ptt.Executor("cpu", compiled=False),
                                     init)
        if model != "sentiment":
            with mock.patch.dict(os.environ,
                                 {"PADDLE_TPU_PALLAS_LSTM": "force"}):
                out[model, "kernel"] = _train("port", model, port,
                                              ptt.Executor("cpu"), init)
    return out


@pytest.mark.parametrize("model", list(BUILDERS))
def test_programs_serialize_equal(trained, model):
    for ref_json, port_json in trained[model, "json"]:
        assert ref_json == port_json


@pytest.mark.parametrize("arm", ["compiled", "kernel"])
@pytest.mark.parametrize("model", list(BUILDERS))
def test_three_adam_steps_match_reference(trained, model, arm):
    """Losses, step-1 gradients and final parameters against paddle_tpu's
    scan route: the port's compiled executor on its scan route, and on
    its fused-LSTM route (the plain twins, length-0 rows included)."""
    if (model, arm) not in trained:
        assert model == "sentiment" and arm == "kernel"
        arm = "compiled"
    (rl, rg, rf), (pl, pg, pf) = trained[model, "ref"], trained[model, arm]
    np.testing.assert_allclose(pl, rl, rtol=LOSS_RTOL)
    assert set(pg) == set(rg)
    # max|g| of the whole step-1 gradient: the last fc's bias gradient
    # sums per-example terms of ~0.1 that cancel to ~1e-3 (each softmax
    # row sums to 1), so its own max|g| does not bound its rounding
    scale = max(float(np.abs(g).max()) for g in rg.values())
    for p in rg:
        np.testing.assert_allclose(pg[p], rg[p], rtol=0,
                                   atol=GRAD_ATOL_FRAC * scale,
                                   err_msg=f"{p}@GRAD")
        np.testing.assert_allclose(pf[p], rf[p], rtol=0, atol=ATOL,
                                   err_msg=p)
    assert rl[-1] < rl[0]


@pytest.mark.parametrize("model", list(BUILDERS))
def test_compiled_and_eager_executors_equal(trained, model):
    (cl, cg, cf), (el, eg, ef) = trained[model, "compiled"], \
        trained[model, "eager"]
    assert cl == el
    for p in cg:
        assert np.array_equal(cg[p], eg[p]), p
        assert np.array_equal(cf[p], ef[p]), p


# -- the layer wrappers, parameters and the inference model -------------------

def _wrappers(pkg):
    """One program over every layer wrapper slice 17 added, and
    nets.sequence_conv_pool."""
    mod, fw, _ = PKGS[pkg]
    layers = mod.layers
    main, startup = fw.Program(), fw.Program()
    with fw.isolated_name_scope(), fw.program_guard(main, startup):
        x = layers.data("x", [4], dtype="float32", lod_level=1)
        docs = layers.data("docs", [4], dtype="float32", lod_level=2)
        lab = layers.data("lab", [1], dtype="int64", lod_level=1)
        h = layers.data("h", [3], dtype="float32")
        c = layers.data("c", [3], dtype="float32")
        n = layers.data("n", [1], dtype="int64")
        outs = {
            "first": layers.sequence_first_step(x),
            "last": layers.sequence_last_step(x),
            "reverse": layers.sequence_reverse(x),
            "pack": layers.nested_sequence_pack(
                layers.sequence_last_step(
                    layers.nested_sequence_flatten(docs)), docs),
            "conv": layers.sequence_conv(x, num_filters=5, filter_size=3,
                                         act="tanh"),
            "conv_pool": importlib.import_module(
                mod.__name__ + ".nets").sequence_conv_pool(x, 3, 3),
            "softmax": layers.sequence_softmax(layers.fc(x, size=1)),
            "expand": layers.sequence_expand(h, x),
            "reshape": layers.sequence_reshape(x, new_dim=2),
            "mask": layers.sequence_mask(n, maxlen=6),
            "pad": layers.sequence_pad(x)[0],
            "unpad": layers.sequence_unpad(layers.sequence_pad(x)[0], n),
            "row_conv": layers.row_conv(x, future_context_size=2,
                                        act="relu"),
            "ctc": layers.warpctc(layers.fc(x, size=5), lab),
            "decoded": layers.ctc_greedy_decoder(layers.fc(x, size=5), 0),
            "lstm_unit": layers.lstm_unit(h, h, c)[0],
            "gru_unit": layers.gru_unit(layers.fc(h, size=9), h, 9)[0],
            "lstmp": layers.dynamic_lstmp(layers.fc(x, size=12), 12, 2)[0],
        }
    return main, startup, outs


def _wrapper_feed(L):
    rng = np.random.RandomState(70)
    lens = [3, 5, 2, 4]
    return {
        "x": L.LoDTensor.from_sequences(
            [rng.randn(k, 4).astype(np.float32) for k in lens]),
        "docs": L.LoDTensor.from_nested_sequences(
            [[rng.randn(k, 4).astype(np.float32) for k in d]
             for d in ([2, 3], [1], [4, 1, 2], [3])]),
        "lab": L.LoDTensor.from_sequences(
            [rng.randint(1, 5, (k, 1)).astype(np.int64)
             for k in (2, 1, 0, 2)]),
        "h": rng.randn(4, 3).astype(np.float32),
        "c": rng.randn(4, 3).astype(np.float32),
        "n": np.asarray([[3], [5], [2], [4]], np.int64)}


def test_layer_wrappers_and_their_parameters_match_reference(tmp_path):
    """Equal JSON of the wrappers' programs (startup included); from the
    same startup values, carried in by name (sequence_conv's and
    row_conv's filters and lstmp's ProjWeight among them), every output
    matches. Then an inference model with a nested feed: saved by the
    port, reloaded by the port (bit for bit) and by paddle_tpu (same
    values)."""
    ref, port = _wrappers("ref"), _wrappers("port")
    for r, p in zip(ref[:2], port[:2]):
        assert json.loads(r.desc.to_json()) == json.loads(p.desc.to_json())
    init = seeded_init(ref[1])
    assert {"sequence_conv_0.w_0", "row_conv_0.w_0",
            "dynamic_lstmp_0.w_1"} <= set(init)
    names = list(port[2])
    fetch = [port[2][k].name for k in names]
    want = pt.Executor().run(ref[0], feed=_wrapper_feed(ref_lod),
                             scope=_scope_with("ref", ref[1], init),
                             fetch_list=fetch)
    pexe, pscope = ptt.Executor("cpu"), _scope_with("port", port[1], init)
    got = pexe.run(port[0], feed=_wrapper_feed(lod), scope=pscope,
                   fetch_list=fetch)
    for k, g, w in zip(names, got, want):
        if hasattr(w, "lod"):
            _same_lodtensor(g, w, k)
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=0, atol=ATOL, err_msg=k)

    model_dir = str(tmp_path / "nested_model")
    pack = port[2]["pack"]
    with ptt.scope_guard(pscope):
        ptt.io.save_inference_model(model_dir, ["docs"], [pack], pexe,
                                    main_program=port[0])
    feed = {"docs": _wrapper_feed(lod)["docs"]}
    direct = got[names.index("pack")]
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor("cpu")
        prog, feeds, targets = ptt.io.load_inference_model(model_dir, exe)
        assert feeds == ["docs"]
        (reloaded,) = exe.run(prog, feed=feed, fetch_list=targets)
    _same_lodtensor(reloaded, direct, "port reload", exact=True)
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor()
        prog, feeds, targets = pt.io.load_inference_model(model_dir, exe)
        (theirs,) = exe.run(prog, feed={"docs": _wrapper_feed(ref_lod)[
            "docs"]}, fetch_list=targets)
    _same_lodtensor(theirs, direct, "paddle_tpu reload")


def test_trainer_with_prefetch_trains_on_nested_samples():
    """The Trainer over the 2-level hierarchical model, fed sample tuples
    (documents as lists of token lists) through its DataFeeder at
    lod_level 2 and its FeedPrefetcher (device_feed): the same costs and
    parameters as the same batches through DataFeeder.feed and
    Executor.run by hand."""
    from paddle_tpu_torch.trainer import EndIteration, Trainer
    rng = np.random.RandomState(80)
    batches = [[([rng.randint(1, VOCAB, rng.randint(2, 6)).tolist()
                  for _ in range(rng.randint(1, 4))], [i % 2])
                for i in range(4)] for _ in range(3)]
    main, startup, loss, _ = _hier2("port")
    init = seeded_init(startup)
    params = [p.name for p in main.all_parameters()]

    scope = _scope_with("port", startup, init)
    exe = ptt.Executor("cpu")
    docs, label = (main.global_block().var(n) for n in ("docs", "label"))
    feeder = DataFeeder([docs, label])
    want = [float(np.asarray(exe.run(main, feed=feeder.feed(b), scope=scope,
                                     fetch_list=[loss])[0]).reshape(-1)[0])
            for b in batches]
    want_params = {p: scope.get(p).numpy() for p in params}

    ptt.reset_global_scope()
    trainer = Trainer(loss, main_program=main, startup_program=startup,
                      executor=ptt.Executor("cpu"),
                      feed_order=["docs", "label"])
    trainer.start()
    ptt.load_param_arrays(ptt.global_scope(), init)
    costs = []
    trainer.train(num_passes=1, reader=lambda: iter(batches), prefetch=2,
                  event_handler=lambda e: costs.append(float(e.cost))
                  if isinstance(e, EndIteration) else None)
    assert costs == want
    for p in params:
        assert np.array_equal(ptt.global_scope().get(p).numpy(),
                              want_params[p]), p
