"""Control-flow programs in paddle_tpu_torch against paddle_tpu: the
programs of tests/test_dynamic_rnn.py (its two exhaustion-flag tests are
in test_torch_control_flow.py), the While, StaticRNN, DynamicRNN and
IfElse networks of tools/lint_ir.py trained by Adam, and the two book
programs that chip_smoke.py phase 19 runs at full width: the
machine-translation train program with a DynamicRNN decoder over a
dynamic_lstm encoder, and the dyn_rnn_lstm sentiment classifier (an LSTM
written out in a DynamicRNN step), here at a small width.

Each program is built by both packages (equal ``to_json`` of the main
and startup programs) and run for 3 steps from paddle_tpu's startup
values through paddle_tpu's executor and through the port's compiled and
eager executors on the CPU, with the same seeded feeds. Held: every
fetch of every step within rtol 1e-5 (atol 1e-6) of paddle_tpu, every
parameter after the 3 steps within rtol 1e-4 (atol 1e-6: Adam's first
steps move a parameter by lr * g / |g|, so a gradient near 0 can move
it either way), and the compiled arm equal to the eager arm bit for bit
(fetches and parameters). The compiled arm pairs every ``__vjp__`` op
with its forward op's record (none is replayed), and names no op that a
CUDA graph cannot capture, except the forward-only counter While's
host-driven route.
"""
import importlib

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.lod import LoDTensor as RefLoDTensor
from paddle_tpu.core.lod import RaggedPair as RefRaggedPair
from paddle_tpu_torch.core.lod import LoDTensor, RaggedPair

_BACKWARDS = [importlib.import_module(f"{pkg}.core.backward")
              for pkg in ("paddle_tpu", "paddle_tpu_torch")]
STEPS = 3


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


def _both(build):
    saved = [m._SNAP_COUNTER[0] for m in _BACKWARDS]
    out = {}
    try:
        for who, pkg in (("ref", pt), ("port", ptt)):
            for m in _BACKWARDS:
                m._SNAP_COUNTER[0] = 0
            with pkg.framework.isolated_name_scope():
                out[who] = build(pkg)
    finally:
        for m, n in zip(_BACKWARDS, saved):
            m._SNAP_COUNTER[0] = n
    return out


def _ragged(pair_cls, seqs, feat, max_len):
    data = np.zeros((len(seqs), max_len, feat), np.float32)
    lens = np.zeros((len(seqs),), np.int32)
    for i, s in enumerate(seqs):
        arr = np.asarray(s, np.float32).reshape(-1, feat)
        data[i, :len(arr)] = arr
        lens[i] = len(arr)
    return pair_cls(data, lens)


# -- tests/test_dynamic_rnn.py ----------------------------------------------

def _masked_cumsum(pkg):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [2], dtype="float32", lod_level=1)
        drnn = cf.DynamicRNN()
        with drnn.block():
            w = drnn.step_input(x)
            prev = drnn.memory(shape=[2], value=0.0)
            s = w + prev
            drnn.update_memory(prev, s)
            drnn.output(s)
        out = drnn()
        last = drnn.last_memory()
    return main, startup, [out, last]


def _drnn_trains(pkg):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [3], dtype="float32", lod_level=1)
        tgt = lay.data("tgt", [4], dtype="float32")
        drnn = cf.DynamicRNN()
        with drnn.block():
            w = drnn.step_input(x)
            prev = drnn.memory(shape=[4], value=0.0)
            nxt = lay.fc(w, size=4, act="tanh") + prev
            drnn.update_memory(prev, nxt)
            drnn.output(nxt)
        drnn()
        loss = lay.mean(lay.square(drnn.last_memory() - tgt))
        pkg.optimizer.AdamOptimizer(learning_rate=0.05).minimize(loss)
    return main, startup, [loss]


def _if_else_rows(pkg):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [1], dtype="float32")
        cond = lay.greater_than(x, lay.fill_constant([1], "float32", 0.0))
        ie = cf.IfElse(cond)
        with ie.true_block():
            ie.output(ie.input(x) * 2.0)
        with ie.false_block():
            ie.output(ie.input(x) - 1.0)
        out = ie()
    return main, startup, [out]


def _unbounded_fc_while(pkg):
    """fc(x) squared 3 times by an unbounded While: the probe-and-replay
    WhileGrad through an fc."""
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [2], dtype="float32")
        x.desc.stop_gradient = False
        s = lay.fc(x, size=2, bias_attr=False)
        s.stop_gradient = False
        counter = lay.fill_constant([1], "int64", 0)
        limit = lay.fill_constant([1], "int64", 3)
        cond = cf.less_than_v(counter, limit)
        w = cf.While(cond)
        with w.block():
            lay.assign(lay.elementwise_mul(s, s), output=s)
            lay.increment(counter, value=1.0, in_place=True)
            cf.less_than_v(counter, limit, cond=cond)
        loss = lay.mean(s)
        pkg.optimizer.SGDOptimizer(learning_rate=0.01).minimize(loss)
    return main, startup, [loss, w.steps]


def _bounded_while_trains(pkg):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [2], dtype="float32")
        x.desc.stop_gradient = False
        s = lay.fc(x, size=2, act="tanh")
        counter = lay.fill_constant([1], "int64", 0)
        limit = lay.fill_constant([1], "int64", 3)
        cond = cf.less_than_v(counter, limit)
        w = cf.While(cond, max_steps=8)
        with w.block():
            lay.assign(lay.scale(s, scale=0.5), output=s)
            lay.increment(counter, value=1.0, in_place=True)
            cf.less_than_v(counter, limit, cond=cond)
        loss = lay.mean(s)
        pkg.optimizer.SGDOptimizer(learning_rate=0.5).minimize(loss)
    return main, startup, [loss, w.steps, w.exhausted]


def _counter_while(max_steps):
    def build(pkg):
        lay, cf = pkg.layers, pkg.layers.control_flow
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            acc = lay.fill_constant([1], "float32", 1.0)
            counter = lay.fill_constant([1], "int64", 0)
            limit = lay.fill_constant([1], "int64", 5)
            cond = cf.less_than_v(counter, limit)
            w = cf.While(cond, max_steps=max_steps)
            with w.block():
                lay.increment(acc, value=3.0, in_place=True)
                lay.increment(counter, value=1.0, in_place=True)
                cf.less_than_v(counter, limit, cond=cond)
        return main, startup, [acc, w.steps]
    return build


def _if_else_trains(pkg):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [4], dtype="float32")
        y = lay.data("y", [1], dtype="float32")
        s = lay.reduce_sum(x, dim=[1], keep_dim=True)
        cond = lay.greater_than(s, lay.fill_constant([1], "float32", 0.0))
        ie = cf.IfElse(cond)
        with ie.true_block():
            ie.output(lay.fc(ie.input(x), size=1))
        with ie.false_block():
            ie.output(lay.fc(ie.input(x), size=1))
        loss = lay.mean(lay.square(ie() - y))
        pkg.optimizer.AdamOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, [loss]


# -- tools/lint_ir.py:96-170, each minimized by Adam -----------------------

def _lint_while(pkg):
    lay = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [4])
        i = lay.fill_constant([1], "int32", 0)
        n = lay.fill_constant([1], "int32", 3)
        s = lay.fc(x, size=4)
        w = lay.While(lay.less_than(i, n), max_steps=8)
        with w.block():
            lay.assign(lay.elementwise_add(s, s), s)
            lay.assign(lay.increment(i, in_place=False), i)
        out = lay.mean(s)
        pkg.optimizer.AdamOptimizer(learning_rate=0.01).minimize(out)
    return main, startup, [out, w.steps, w.exhausted]


def _lint_static_rnn(pkg):
    lay = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [5, 4, 8], append_batch_size=False)
        rnn = lay.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[4, 8], value=0.0)
            nh = lay.fc(lay.elementwise_add(xt, mem), size=8, act="tanh")
            rnn.update_memory(mem, nh)
            rnn.step_output(nh)
        out = lay.mean(rnn())
        pkg.optimizer.AdamOptimizer(learning_rate=0.01).minimize(out)
    return main, startup, [out]


def _lint_dynamic_rnn(pkg):
    lay = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
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
        pkg.optimizer.AdamOptimizer(learning_rate=0.01).minimize(out)
    return main, startup, [out]


def _lint_ifelse(pkg):
    """The lint network's IfElse over fc(x) (the network itself has no
    parameter to train)."""
    lay = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.fc(lay.data("x", [4]), size=4)
        cond = lay.less_than(
            lay.mean(x), lay.fill_constant([1], "float32", 0.5))
        ie = lay.IfElse(cond)
        with ie.true_block():
            ie.output(lay.elementwise_add(x, x))
        with ie.false_block():
            ie.output(lay.elementwise_sub(x, x))
        out = lay.mean(ie())
        pkg.optimizer.AdamOptimizer(learning_rate=0.01).minimize(out)
    return main, startup, [out]


# -- the book programs of chip_smoke.py phase 19, small ---------------------

MT = dict(vocab=40, emb=16, hid=16)
SENT = dict(vocab=50, emb=8, hid=16)


def build_mt(pkg, vocab, emb, hid, lr=1e-3):
    """The Fluid book's machine-translation train program (ch. 8): the
    encoder embedding -> fc(4H, tanh) -> dynamic_lstm ->
    sequence_last_step; the decoder a DynamicRNN over the target
    embedding with memory(init=encoder_last), fc([word, pre_state], H,
    tanh) -> fc(V, softmax) a step; cross_entropy -> mean, Adam."""
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        src = lay.data("src", [1], dtype="int64", lod_level=1)
        trg = lay.data("trg", [1], dtype="int64", lod_level=1)
        lbl = lay.data("lbl", [1], dtype="int64", lod_level=1)
        enc_in = lay.fc(lay.embedding(src, size=[vocab, emb]),
                        size=4 * hid, act="tanh")
        enc, _ = lay.dynamic_lstm(enc_in, size=4 * hid)
        enc_last = lay.sequence_last_step(enc)
        trg_emb = lay.embedding(trg, size=[vocab, emb])
        drnn = cf.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(trg_emb)
            pre = drnn.memory(init=enc_last)
            state = lay.fc([word, pre], size=hid, act="tanh")
            drnn.update_memory(pre, state)
            drnn.output(lay.fc(state, size=vocab, act="softmax"))
        loss = lay.mean(lay.cross_entropy(drnn(), lbl))
        pkg.optimizer.AdamOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, [loss]


def build_dyn_rnn_lstm(pkg, vocab, emb, hid, lr=1e-3):
    """The Fluid book's dyn_rnn_lstm sentiment classifier (ch. 6): an
    LSTM written out in a DynamicRNN step (four gate_common fc pairs,
    the gates' sigmoids and the cell's tanh, two memories), then
    sequence_last_step -> fc(2, softmax), cross_entropy -> mean, Adam."""
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        words = lay.data("words", [1], dtype="int64", lod_level=1)
        label = lay.data("label", [1], dtype="int64")
        sentence = lay.fc(lay.embedding(words, size=[vocab, emb]),
                          size=hid, act="tanh")
        rnn = cf.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(sentence)
            prev_hidden = rnn.memory(value=0.0, shape=[hid])
            prev_cell = rnn.memory(value=0.0, shape=[hid])

            def gate_common(ipt, hidden, size):
                return lay.fc(ipt, size=size) + \
                    lay.fc(hidden, size=size, bias_attr=False)

            forget_gate = lay.sigmoid(gate_common(word, prev_hidden, hid))
            input_gate = lay.sigmoid(gate_common(word, prev_hidden, hid))
            output_gate = lay.sigmoid(gate_common(word, prev_hidden, hid))
            cell_gate = lay.sigmoid(gate_common(word, prev_hidden, hid))
            cell = forget_gate * prev_cell + input_gate * cell_gate
            hidden = output_gate * lay.tanh(cell)
            rnn.update_memory(prev_cell, cell)
            rnn.update_memory(prev_hidden, hidden)
            rnn.output(hidden)
        last = lay.sequence_last_step(rnn())
        prediction = lay.fc(last, size=2, act="softmax")
        loss = lay.mean(lay.cross_entropy(prediction, label))
        pkg.optimizer.AdamOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, [loss]


def _ids(lod_cls, rng, lengths, hi):
    return lod_cls.from_sequences(
        [rng.randint(1, hi, (n, 1)).astype(np.int64) for n in lengths])


def _feeds(name, lod_cls, pair_cls):
    """STEPS seeded feeds of program `name`, as the reference tests draw
    them where they have feeds."""
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(STEPS):
        if name == "masked_cumsum":
            feeds.append({"x": _ragged(pair_cls, [
                [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], [[10.0, 20.0]]],
                2, 4)})
        elif name == "drnn_trains":
            r0 = np.random.RandomState(0)
            seqs = [r0.randn(int(n), 3).tolist() for n in [4, 2, 3]]
            feeds.append({"x": _ragged(pair_cls, seqs, 3, 5),
                          "tgt": r0.randn(3, 4).astype(np.float32)})
        elif name == "if_else_rows":
            feeds.append({"x": np.asarray([[1.0], [-2.0], [3.0], [-4.0]],
                                          np.float32)})
        elif name in ("unbounded_fc_while", "bounded_while_trains"):
            feeds.append({"x": rng.rand(4, 2).astype(np.float32) * 0.5
                          + 0.5})
        elif name == "if_else_trains":
            xv = rng.randn(16, 4).astype(np.float32)
            s = xv.sum(1, keepdims=True)
            feeds.append({"x": xv, "y": np.where(s > 0, s * 2.0, s * -3.0)
                          .astype(np.float32)})
        elif name == "lint_while" or name == "lint_ifelse":
            feeds.append({"x": rng.randn(3, 4).astype(np.float32)})
        elif name == "lint_static_rnn":
            feeds.append({"x": rng.randn(5, 4, 8).astype(np.float32)})
        elif name == "lint_dynamic_rnn":
            feeds.append({"sent": lod_cls.from_sequences(
                [rng.randn(n, 8).astype(np.float32) for n in (3, 5, 1)])})
        elif name == "mt":
            feeds.append({"src": _ids(lod_cls, rng, (5, 3, 7, 2),
                                      MT["vocab"]),
                          "trg": _ids(lod_cls, rng, (4, 6, 2, 5),
                                      MT["vocab"]),
                          "lbl": _ids(lod_cls, rng, (4, 6, 2, 5),
                                      MT["vocab"])})
        elif name == "dyn_rnn_lstm":
            feeds.append({"words": _ids(lod_cls, rng, (6, 3, 8, 1),
                                        SENT["vocab"]),
                          "label": rng.randint(0, 2, (4, 1))
                          .astype(np.int64)})
        else:   # the counter Whiles take no feed
            feeds.append({})
    return feeds


PROGRAMS = {
    "masked_cumsum": _masked_cumsum,
    "drnn_trains": _drnn_trains,
    "if_else_rows": _if_else_rows,
    "unbounded_fc_while": _unbounded_fc_while,
    "bounded_while_trains": _bounded_while_trains,
    "counter_unbounded": _counter_while(None),
    "counter_bounded": _counter_while(16),
    "if_else_trains": _if_else_trains,
    "lint_while": _lint_while,
    "lint_static_rnn": _lint_static_rnn,
    "lint_dynamic_rnn": _lint_dynamic_rnn,
    "lint_ifelse": _lint_ifelse,
    "mt": lambda pkg: build_mt(pkg, **MT),
    "dyn_rnn_lstm": lambda pkg: build_dyn_rnn_lstm(pkg, **SENT),
}


def _value(v):
    return np.asarray(v.data if hasattr(v, "lod") else v)


def _run(pkg, exe, scope, built, feeds, init=None):
    main, startup, fetch = built
    exe.run(startup, scope=scope)
    if init is None:
        init = {n: np.asarray(scope.get(n)) for n in scope.local_names()}
    else:
        ptt.load_param_arrays(scope, {n: init[n] for n in
                                      scope.local_names() if n in init})
    outs = [[_value(v) for v in exe.run(main, feed=f, fetch_list=fetch,
                                        scope=scope)] for f in feeds]
    params = {p.name: np.asarray(scope.get(p.name)) if pkg is pt
              else scope.get(p.name).numpy() for p in main.all_parameters()}
    return init, outs, params


@pytest.fixture(scope="module", params=sorted(PROGRAMS))
def program(request):
    name = request.param
    built = _both(PROGRAMS[name])
    init, ref_outs, ref_params = _run(
        pt, pt.Executor(), pt.Scope(), built["ref"],
        _feeds(name, RefLoDTensor, RefRaggedPair))
    arms = {}
    for compiled in (True, False):
        exe = ptt.Executor("cpu", compiled=compiled)
        arms[compiled] = _run(ptt, exe, ptt.Scope(), built["port"],
                              _feeds(name, LoDTensor, RaggedPair),
                              init)[1:] + (exe,)
    return dict(name=name, built=built, ref=(ref_outs, ref_params),
                arms=arms)


def test_program_json_equals_paddle_tpu(program):
    for prog in (0, 1):
        assert program["built"]["port"][prog].desc.to_json() == \
            program["built"]["ref"][prog].desc.to_json()


def test_program_matches_paddle_tpu(program):
    ref_outs, ref_params = program["ref"]
    outs, params, _ = program["arms"][True]
    for step, (r_step, p_step) in enumerate(zip(ref_outs, outs)):
        for j, (r, p) in enumerate(zip(r_step, p_step)):
            np.testing.assert_allclose(
                p.astype(np.float64), r.astype(np.float64), rtol=1e-5,
                atol=1e-6, err_msg=f"{program['name']} step {step} fetch {j}")
    assert sorted(params) == sorted(ref_params)
    for n in params:
        np.testing.assert_allclose(params[n], ref_params[n], rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_program_compiled_equals_eager_bit_for_bit(program):
    (c_outs, c_params, exe), (e_outs, e_params, _) = \
        program["arms"][True], program["arms"][False]
    for c_step, e_step in zip(c_outs, e_outs):
        for c, e in zip(c_step, e_step):
            assert c.dtype == e.dtype and np.array_equal(c, e)
    for n in c_params:
        assert np.array_equal(c_params[n], e_params[n]), n
    compiled = exe.last_compiled
    assert not compiled.replayed
    # the host-driven While of the forward-only counter is never captured
    assert compiled.uncaptured_ops == (
        ("while",) if program["name"] == "counter_unbounded" else ())


def test_masked_cumsum_values():
    """tests/test_dynamic_rnn.py's expected values, on the port: the
    running sum over ragged rows, and last_memory frozen at each row's
    length."""
    main, startup, fetch = _masked_cumsum(ptt)
    exe = ptt.Executor("cpu")
    exe.run(startup)
    feed = _feeds("masked_cumsum", LoDTensor, RaggedPair)[0]
    out, last = exe.run(main, feed=feed, fetch_list=fetch)
    data = feed["x"].data
    np.testing.assert_allclose(out.data, np.concatenate(
        [np.cumsum(data[0, :3], axis=0), data[1, :1]]))
    np.testing.assert_allclose(last, [data[0, :3].sum(0), [10, 20]])


def test_counter_while_bounded_equals_unbounded():
    outs = []
    for max_steps in (None, 16):
        main, startup, fetch = _counter_while(max_steps)(ptt)
        exe = ptt.Executor("cpu")
        exe.run(startup)
        outs.append(float(exe.run(main, fetch_list=fetch)[0][0]))
    assert outs == [16.0, 16.0]     # 1 + 5 * 3
