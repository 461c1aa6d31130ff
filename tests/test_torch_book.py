"""Six chapters of the Fluid book on paddle_tpu_torch against paddle_tpu:
the chapters of tests/test_book.py but machine_translation (its own
file, tests/test_torch_gru_nmt.py) and understand_sentiment
(tests/test_torch_sequence_ops.py).

- fit_a_line (:47): fc regression on uci_housing, SGD;
- recognize_digits (:69): a conv + pool + fc classifier on mnist, Adam;
- image_classification (:96): resnet_cifar10 at depth 20 on cifar10,
  Adam;
- word2vec (:122): the N-gram LM on imikolov, four embeddings sharing
  one table (ParamAttr name "shared_emb"), Adam;
- label_semantic_roles (:208): embeddings, fc, dynamic_lstm and a
  linear-chain CRF on conll05 (ParamAttr name "crfw", shared by
  crf_decoding), Adam; the ragged feeds padded to 32 as the chapter pads
  them;
- recommender_system (:262): user and movie towers on movielens, the
  title summed by sequence_pool, cos_sim scaled to a rating, Adam.

Each chapter is built by both packages (equal ``to_json`` of the main
and startup programs) and trained for STEPS batches from the port's
startup values carried into the reference, each package fed by its own
``dataset`` reader through its own ``reader.batch``, as the chapter feeds
them (the two readers' samples are equal: tests/test_torch_dataset.py).
Held: every loss within rtol 1e-5 (float32 on the CPU, summed in other
orders; measured at most 1.25e-7 relative on fit_a_line,
recognize_digits and word2vec), and for image_classification rtol 1e-4
(measured 6.9e-5 at the fourth batch: Adam's first steps move a weight
whose gradient is within float noise of 0 by the learning rate either
way, and 20 layers of batch_norm carry that into the later batches).
label_semantic_roles also decodes the feed of its last step with
crf_decoding from the port's trained weights in both packages: the tags
are equal exactly. Then the port's ``_roundtrip`` as the chapter runs it
(tests/test_book.py:28):
io.save_inference_model, io.load_inference_model into the same
executor, one run on the chapter's feed: the output has the chapter's
shape and equals, within rtol 1e-6, what the trained program's forward
(pruned to the target in memory, no file between) gives on the same
feed from the trained scope.
"""
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_conv_models import _BACKWARDS

STEPS = 4


@pytest.fixture(autouse=True)
def _fresh():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


def _fit_a_line(pkg):
    lay = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [13])
        y = lay.data("y", [1])
        pred = lay.fc(x, size=1)
        loss = lay.mean(lay.square_error_cost(pred, y))
        pkg.optimizer.SGDOptimizer(learning_rate=0.01).minimize(loss)

    def feeds():
        for b in pkg.reader.batch(pkg.dataset.uci_housing.train(), 32)():
            yield {"x": np.stack([s[0] for s in b]),
                   "y": np.stack([s[1] for s in b])}
    return dict(main=main, startup=startup, loss=loss, feeds=feeds,
                feed_names=["x"], target=pred,
                probe={"x": np.zeros((4, 13), np.float32)}, shape=(4, 1))


def _recognize_digits(pkg):
    lay = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = lay.data("img", [784])
        label = lay.data("label", [1], dtype="int64")
        x = lay.reshape(img, [-1, 1, 28, 28])
        x = lay.conv2d(x, num_filters=8, filter_size=5, act="relu")
        x = lay.pool2d(x, pool_size=2, pool_stride=2)
        logits = lay.fc(x, size=10)
        loss = lay.mean(lay.softmax_with_cross_entropy(logits, label))
        lay.accuracy(lay.softmax(logits), label)
        pkg.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)

    def feeds():
        for b in pkg.reader.batch(pkg.dataset.mnist.train(), 32)():
            yield {"img": np.stack([s[0] for s in b]),
                   "label": np.array([[s[1]] for s in b], np.int64)}
    return dict(main=main, startup=startup, loss=loss, feeds=feeds,
                feed_names=["img"], target=logits,
                probe={"img": np.zeros((2, 784), np.float32)},
                shape=(2, 10))


def _image_classification(pkg):
    lay = pkg.layers
    resnet = importlib.import_module(f"{pkg.__name__}.models.resnet")
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = lay.data("img", [3, 32, 32])
        label = lay.data("label", [1], dtype="int64")
        logits = resnet.resnet_cifar10(img, class_dim=10, depth=20)
        loss = lay.mean(lay.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)

    def feeds():
        for b in pkg.reader.batch(pkg.dataset.cifar.train10(), 16)():
            yield {"img": np.stack([s[0].reshape(3, 32, 32) for s in b]),
                   "label": np.array([[s[1]] for s in b], np.int64)}
    return dict(main=main, startup=startup, loss=loss, feeds=feeds,
                feed_names=["img"], target=logits,
                probe={"img": np.zeros((2, 3, 32, 32), np.float32)},
                shape=(2, 10))


def _word2vec(pkg):
    lay = pkg.layers
    n = pkg.dataset.imikolov.N
    dict_size = len(pkg.dataset.imikolov.build_dict())
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        words = [lay.data(f"w{i}", [1], dtype="int64") for i in range(n - 1)]
        target = lay.data("target", [1], dtype="int64")
        embs = [lay.embedding(w, size=[dict_size, 32],
                              param_attr=pkg.ParamAttr(name="shared_emb"))
                for w in words]
        hidden = lay.fc(lay.concat(embs, axis=1), size=64, act="relu")
        logits = lay.fc(hidden, size=dict_size)
        loss = lay.mean(lay.softmax_with_cross_entropy(logits, target))
        pkg.optimizer.AdamOptimizer(learning_rate=5e-3).minimize(loss)

    def feeds():
        for b in pkg.reader.batch(pkg.dataset.imikolov.train(), 64)():
            f = {f"w{i}": np.array([[s[i]] for s in b], np.int64)
                 for i in range(n - 1)}
            f["target"] = np.array([[s[n - 1]] for s in b], np.int64)
            yield f
    return dict(main=main, startup=startup, loss=loss, feeds=feeds,
                feed_names=[f"w{i}" for i in range(n - 1)], target=logits,
                probe={f"w{i}": np.zeros((2, 1), np.int64)
                       for i in range(n - 1)}, shape=(2, dict_size))


def _ragged(pkg, seqs, max_len):
    """tests/test_book.py _ragged in `pkg`: int64 [n, max_len, 1] rows
    and their lengths."""
    lod = importlib.import_module(f"{pkg.__name__}.core.lod")
    arrs = [np.asarray(q, np.int64).reshape(len(q), 1) for q in seqs]
    padded, lengths = lod.LoDTensor.from_sequences(arrs).to_padded(
        max_len=max_len)
    return lod.RaggedPair(padded, lengths)


SRL_MAXLEN = 32


def _label_semantic_roles(pkg):
    lay = pkg.layers
    word_dict, verb_dict, label_dict = pkg.dataset.conll05.get_dict()
    wn, vn, ln = len(word_dict), len(verb_dict), len(label_dict)
    emb, hid = 16, 32
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        word = lay.data("word", [1], dtype="int64", lod_level=1)
        verb = lay.data("verb", [1], dtype="int64", lod_level=1)
        mark = lay.data("mark", [1], dtype="int64", lod_level=1)
        target = lay.data("target", [1], dtype="int64", lod_level=1)
        w_emb = lay.embedding(word, size=[wn, emb])
        v_emb = lay.embedding(verb, size=[vn, emb])
        m_emb = lay.embedding(mark, size=[2, emb])
        feat = lay.concat([w_emb, v_emb, m_emb], axis=-1)
        x = lay.fc(feat, size=4 * hid)
        h, _ = lay.dynamic_lstm(x, size=4 * hid)
        emission = lay.fc(h, size=ln)
        crf_cost = lay.linear_chain_crf(
            emission, target, param_attr=pkg.ParamAttr(name="crfw"))
        loss = lay.mean(crf_cost)
        pkg.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
        path = lay.crf_decoding(emission,
                                param_attr=pkg.ParamAttr(name="crfw"))

    def feeds():
        for b in pkg.reader.batch(pkg.dataset.conll05.train(), 16)():
            yield {k: _ragged(pkg, [s[i] for s in b], SRL_MAXLEN)
                   for k, i in (("word", 0), ("verb", 6), ("mark", 7),
                                ("target", 8))}
    probe = next(feeds())
    return dict(main=main, startup=startup, loss=loss, feeds=feeds,
                feed_names=["word", "verb", "mark"], target=path,
                probe={k: probe[k] for k in ("word", "verb", "mark")},
                shape=(int(np.sum(np.asarray(probe["word"].lengths))), 1),
                decode=path)


def _recommender_system(pkg):
    lay, ml = pkg.layers, pkg.dataset.movielens
    emb = 16
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        uid = lay.data("uid", [1], dtype="int64")
        gender = lay.data("gender", [1], dtype="int64")
        age = lay.data("age", [1], dtype="int64")
        job = lay.data("job", [1], dtype="int64")
        mid = lay.data("mid", [1], dtype="int64")
        title = lay.data("title", [1], dtype="int64", lod_level=1)
        rating = lay.data("rating", [1])
        usr = lay.concat([
            lay.embedding(uid, size=[ml.max_user_id() + 1, emb]),
            lay.embedding(gender, size=[2, emb]),
            lay.embedding(age, size=[len(ml.age_table()), emb]),
            lay.embedding(job, size=[ml.max_job_id() + 1, emb]),
        ], axis=1)
        usr_feat = lay.fc(usr, size=32, act="tanh")
        mov_emb = lay.embedding(mid, size=[ml.max_movie_id() + 1, emb])
        title_emb = lay.embedding(
            title, size=[len(ml.get_movie_title_dict()), emb])
        title_feat = lay.sequence_pool(title_emb, pool_type="sum")
        mov = lay.concat([mov_emb, title_feat], axis=1)
        mov_feat = lay.fc(mov, size=32, act="tanh")
        sim = lay.cos_sim(usr_feat, mov_feat)
        pred = lay.scale(sim, scale=5.0)
        loss = lay.mean(lay.square_error_cost(pred, rating))
        pkg.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)

    def feeds():
        for b in pkg.reader.batch(ml.train(), 32)():
            f = {k: np.array([[s[i]] for s in b], np.int64)
                 for k, i in (("uid", 0), ("gender", 1), ("age", 2),
                              ("job", 3), ("mid", 4))}
            f["title"] = _ragged(pkg, [s[6] for s in b], 8)
            f["rating"] = np.array([[s[7]] for s in b], np.float32)
            yield f
    probe = {k: v for k, v in next(feeds()).items() if k != "rating"}
    return dict(main=main, startup=startup, loss=loss, feeds=feeds,
                feed_names=list(probe), target=pred, probe=probe,
                shape=(32, 1))


CHAPTERS = {"fit_a_line": (_fit_a_line, 1e-5),
            "recognize_digits": (_recognize_digits, 1e-5),
            "image_classification": (_image_classification, 1e-4),
            "word2vec": (_word2vec, 1e-5),
            "label_semantic_roles": (_label_semantic_roles, 1e-5),
            "recommender_system": (_recommender_system, 1e-5)}


def _build(name):
    saved = [m._SNAP_COUNTER[0] for m in _BACKWARDS]
    out = {}
    try:
        for who, pkg in (("ref", pt), ("port", ptt)):
            for m in _BACKWARDS:
                m._SNAP_COUNTER[0] = 0
            with pkg.framework.isolated_name_scope():
                out[who] = CHAPTERS[name][0](pkg)
    finally:
        for m, n in zip(_BACKWARDS, saved):
            m._SNAP_COUNTER[0] = n
    return out


@pytest.fixture(scope="module", params=sorted(CHAPTERS))
def chapter(request):
    """Both packages' chapter trained STEPS batches from the port's
    startup values: the losses, and the port's executor and scope."""
    name = request.param
    built = _build(name)
    port = built["port"]
    exe, scope = ptt.Executor(place="cpu"), ptt.Scope()
    exe.run(port["startup"], scope=scope)
    init = {n: scope.get(n).numpy() for n in scope.local_names()}
    losses = {}
    for who, pkg in (("ref", pt), ("port", ptt)):
        c = built[who]
        if pkg is pt:
            run_exe, run_scope = pt.Executor(), pt.Scope()
            for n, v in init.items():
                run_scope.set(n, jnp.asarray(v))
        else:
            run_exe, run_scope = exe, scope
        losses[who] = []
        for _, feed in zip(range(STEPS), c["feeds"]()):
            (lv,) = run_exe.run(c["main"], feed=feed,
                                fetch_list=[c["loss"]], scope=run_scope)
            losses[who].append(float(np.asarray(lv).reshape(-1)[0]))
    decoded = {}
    if "decode" in built["port"]:
        # both packages decode the last step's feed from the port's
        # trained weights
        trained = {n: scope.get(n).numpy() for n in scope.local_names()}
        for who, pkg in (("ref", pt), ("port", ptt)):
            c = built[who]
            feed = list(zip(range(STEPS), c["feeds"]()))[-1][1]
            if pkg is pt:
                run_exe, run_scope = pt.Executor(), pt.Scope()
                for n, v in trained.items():
                    run_scope.set(n, jnp.asarray(v))
            else:
                run_exe, run_scope = exe, scope
            (dv,) = run_exe.run(c["main"], feed=feed,
                                fetch_list=[c["decode"]], scope=run_scope)
            decoded[who] = _data(dv)
    return dict(name=name, built=built, losses=losses, exe=exe,
                scope=scope, decoded=decoded)


def _data(v):
    """A fetch as a numpy array (a ragged fetch by its rows)."""
    return np.asarray(v.data if hasattr(v, "data") else v)


def test_chapter_programs_json_equal(chapter):
    for prog in ("main", "startup"):
        assert json.loads(chapter["built"]["port"][prog].desc.to_json()) \
            == json.loads(chapter["built"]["ref"][prog].desc.to_json()), \
            prog


def test_chapter_losses_match_reference(chapter):
    ref, port = chapter["losses"]["ref"], chapter["losses"]["port"]
    assert len(port) == STEPS and np.all(np.isfinite(port))
    np.testing.assert_allclose(port, ref, rtol=CHAPTERS[chapter["name"]][1])


@pytest.mark.parametrize("chapter", ["label_semantic_roles"],
                         indirect=True)
def test_chapter_crf_decoding_tags_match_reference(chapter):
    ref, port = chapter["decoded"]["ref"], chapter["decoded"]["port"]
    assert port.dtype == np.int64 and port.shape == ref.shape
    np.testing.assert_array_equal(port, ref.astype(np.int64))


def test_chapter_inference_roundtrip(chapter, tmp_path):
    """tests/test_book.py _roundtrip on the port: save, load into the
    same executor, run the chapter's probe feed."""
    c, exe, scope = chapter["built"]["port"], chapter["exe"], \
        chapter["scope"]
    d = str(tmp_path / "model")
    with ptt.scope_guard(scope):
        ptt.io.save_inference_model(d, c["feed_names"], [c["target"]], exe,
                                    main_program=c["main"])
        prog, feeds, fetches = ptt.io.load_inference_model(d, exe)
        got = exe.run(prog, feed=c["probe"], fetch_list=fetches)[0]
    assert feeds == c["feed_names"]
    assert tuple(_data(got).shape) == c["shape"]
    forward = ptt.io._prune(c["main"], c["feed_names"],
                            [c["target"].name]).inference_optimize()
    want = exe.run(forward, feed=c["probe"], fetch_list=[c["target"]],
                   scope=scope)[0]
    np.testing.assert_allclose(_data(got), _data(want), rtol=1e-6,
                               atol=1e-7)


def test_new_op_types_register_the_reference_slots():
    """cos_sim and the two CRF ops: registered as the reference registers
    them (ragged-aware, no_grad_slots)."""
    from paddle_tpu.core.registry import OpRegistry as RefRegistry
    from paddle_tpu_torch.core.registry import OpRegistry
    for t in ("cos_sim", "linear_chain_crf", "crf_decoding"):
        ours, ref = OpRegistry.get(t), RefRegistry.get(t)
        assert ours.no_grad_slots == ref.no_grad_slots, t
        assert ours.ragged_aware == ref.ragged_aware, t
