"""Control flow in paddle_tpu_torch against paddle_tpu: the WhileGrad
programs of tests/test_while_grad_dynamic.py rebuilt on the port, and
the control-flow ops one by one.

Each program is built by both packages (equal ``to_json``), run from
paddle_tpu's startup values through paddle_tpu's executor and through
the port's compiled and eager executors on the CPU with the same feeds.
Held: every fetch (losses, ``Steps``) and every parameter after each
step within rtol 1e-5 of paddle_tpu (the trip counts exactly); the
port's compiled arm equal to its eager arm bit for bit; the applied SGD
gradient against central finite differences of a host replica of the
loop (rtol 1e-3, eps 1e-3, as the reference test holds it); and for
the first program the analytic ``2 (s - target) n`` within rtol 1e-4.
The compile cache counts one miss per trip-count bucket, as paddle_tpu's.

The op tests hold the tensor arrays (write with a clamped index, read,
length), StaticRNN, the one-device pipeline and the eight supporting op
types against paddle_tpu, forward and backward, within rtol 1e-5.
"""
import importlib
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.lod import LoDTensor as RefLoDTensor
from paddle_tpu_torch.core import executor as port_executor
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.core.registry import OpRegistry, register_op

_BACKWARDS = [importlib.import_module(f"{pkg}.core.backward")
              for pkg in ("paddle_tpu", "paddle_tpu_torch")]
RTOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


def _both(build):
    """build(pkg) in each package from equal name and snapshot counts:
    {"ref": ..., "port": ...}."""
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


def _const(pkg, v):
    return pkg.initializer.ConstantInitializer(v)


def _f32(v):
    return np.asarray([v], np.float32)


# -- the WhileGrad programs (tests/test_while_grad_dynamic.py) --------------

def _while_sum(pkg, lr=0.05, x0=0.3, target=2.0):
    """_build at :19: s walks up by x while s < thr; loss (s - target)^2."""
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.create_parameter(shape=[1], dtype="float32", name="xparam",
                                 default_initializer=_const(pkg, x0))
        thr = lay.data("thr", [1], dtype="float32")
        s = lay.fill_constant([1], "float32", 0.0)
        s.stop_gradient = False
        cond = cf.less_than_v(s, thr)
        w = cf.While(cond)
        with w.block():
            t = lay.elementwise_add(s, x)
            lay.assign(t, output=s)
            cf.less_than_v(s, thr, cond=cond)
        tgt = lay.fill_constant([1], "float32", target)
        loss = lay.reduce_sum(lay.square(lay.elementwise_sub(s, tgt)))
        pkg.optimizer.SGDOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, {"fetch": [loss, w.steps], "param": "xparam",
                           "lr": lr}


def _walk(s, x, thr):
    n = 0
    while s < thr:
        s += x
        n += 1
    return s, n


def _two_whiles(pkg):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.create_parameter(shape=[1], dtype="float32", name="xp2",
                                 default_initializer=_const(pkg, 0.4))
        thr1 = lay.data("thr1", [1], dtype="float32")
        thr2 = lay.data("thr2", [1], dtype="float32")

        def loop(thr):
            s = lay.fill_constant([1], "float32", 0.0)
            s.stop_gradient = False
            cond = cf.less_than_v(s, thr)
            w = cf.While(cond)
            with w.block():
                lay.assign(lay.elementwise_add(s, x), output=s)
                cf.less_than_v(s, thr, cond=cond)
            return s, w

        s1, w1 = loop(thr1)
        s2, w2 = loop(thr2)
        loss = lay.reduce_sum(lay.elementwise_add(lay.square(s1),
                                                  lay.square(s2)))
        pkg.optimizer.SGDOptimizer(learning_rate=0.001).minimize(loss)
    return main, startup, {"fetch": [loss, w1.steps, w2.steps],
                           "param": "xp2", "lr": 0.001}


def _nested_whiles(pkg):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.create_parameter(shape=[1], dtype="float32", name="xp_nest",
                                 default_initializer=_const(pkg, 0.3))
        thr_out = lay.data("thr_out", [1], dtype="float32")
        thr_in = lay.data("thr_in", [1], dtype="float32")
        s = lay.fill_constant([1], "float32", 0.0)
        s.stop_gradient = False
        cond_o = cf.less_than_v(s, thr_out)
        w_o = cf.While(cond_o)
        with w_o.block():
            t = lay.fill_constant([1], "float32", 0.0)
            t.stop_gradient = False
            cond_i = cf.less_than_v(t, thr_in)
            w_i = cf.While(cond_i)
            with w_i.block():
                lay.assign(lay.elementwise_add(t, x), output=t)
                cf.less_than_v(t, thr_in, cond=cond_i)
            lay.assign(lay.elementwise_add(s, t), output=s)
            cf.less_than_v(s, thr_out, cond=cond_o)
        tgt = lay.fill_constant([1], "float32", 2.0)
        loss = lay.reduce_sum(lay.square(lay.elementwise_sub(s, tgt)))
        pkg.optimizer.SGDOptimizer(learning_rate=0.005).minimize(loss)
    return main, startup, {"fetch": [loss, w_o.steps], "param": "xp_nest",
                           "lr": 0.005}


def _host_nested(x, feed):
    s, to, ti = 0.0, float(feed["thr_out"][0]), float(feed["thr_in"][0])
    while s < to:
        s += _walk(0.0, x, ti)[0]
    return (s - 2.0) ** 2


def _while_in_drnn(pkg):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        p = lay.create_parameter(shape=[1], dtype="float32",
                                 name="p_drnn_nest",
                                 default_initializer=_const(pkg, 0.25))
        x = lay.data("x", [1], dtype="float32", lod_level=1)
        drnn = cf.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x)
            prev = drnn.memory(shape=[1], value=0.0)
            t = lay.fill_constant([1], "float32", 0.0)
            t.stop_gradient = False
            thr = lay.reshape(x_t, [1])
            cond_i = cf.less_than_v(t, thr)
            w_i = cf.While(cond_i)
            with w_i.block():
                lay.assign(lay.elementwise_add(t, p), output=t)
                cf.less_than_v(t, thr, cond=cond_i)
            nxt = lay.elementwise_add(prev, lay.reshape(t, [1, 1]))
            drnn.update_memory(prev, nxt)
            drnn.output(nxt)
        drnn()
        loss = lay.reduce_sum(lay.square(drnn.last_memory()))
        pkg.optimizer.SGDOptimizer(learning_rate=2e-4).minimize(loss)
    return main, startup, {"fetch": [loss], "param": "p_drnn_nest",
                           "lr": 2e-4}


def _host_drnn(p, feed):
    s = sum(_walk(0.0, p, xt)[0] for xt in (0.4, 0.9, 0.2))
    return s * s


def _while_in_cond(pkg):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.create_parameter(shape=[1], dtype="float32", name="xp_cond",
                                 default_initializer=_const(pkg, 0.3))
        thr_out = lay.data("thr_out", [1], dtype="float32")
        thr_in = lay.data("thr_in", [1], dtype="float32")
        s = lay.fill_constant([1], "float32", 0.0)
        s.stop_gradient = False
        cond_o = cf.less_than_v(s, thr_out)
        w_o = cf.While(cond_o)
        with w_o.block():
            half = lay.fill_constant([1], "float32", 0.6)
            pred = cf.less_than_v(s, half)

            def walk():
                t = lay.fill_constant([1], "float32", 0.0)
                t.stop_gradient = False
                cond_i = cf.less_than_v(t, thr_in)
                w_i = cf.While(cond_i)
                with w_i.block():
                    lay.assign(lay.elementwise_add(t, x), output=t)
                    cf.less_than_v(t, thr_in, cond=cond_i)
                return t

            inc = cf.cond_op(pred, walk, lambda: lay.scale(x, scale=2.0))
            lay.assign(lay.elementwise_add(s, inc), output=s)
            cf.less_than_v(s, thr_out, cond=cond_o)
        loss = lay.reduce_sum(lay.square(s))
        pkg.optimizer.SGDOptimizer(learning_rate=0.001).minimize(loss)
    return main, startup, {"fetch": [loss, w_o.steps], "param": "xp_cond",
                           "lr": 0.001}


def _host_cond(x, feed):
    s, to, ti = 0.0, float(feed["thr_out"][0]), float(feed["thr_in"][0])
    while s < to:
        s += _walk(0.0, x, ti)[0] if s < 0.6 else 2 * x
    return s * s


def _while_in_if_else(pkg):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.create_parameter(shape=[1], dtype="float32",
                                 name="xp_ifelse",
                                 default_initializer=_const(pkg, 0.3))
        thr = lay.data("thr", [1], dtype="float32")
        sel = lay.data("sel", [1], dtype="float32")
        cond = cf.less_than_v(sel, lay.fill_constant([1], "float32", 0.5))
        ie = cf.IfElse(cond)
        with ie.true_block():
            t = lay.fill_constant([1], "float32", 0.0)
            t.stop_gradient = False
            cond_i = cf.less_than_v(t, thr)
            w_i = cf.While(cond_i)
            with w_i.block():
                lay.assign(lay.elementwise_add(t, x), output=t)
                cf.less_than_v(t, thr, cond=cond_i)
            ie.output(t)
        with ie.false_block():
            ie.output(lay.scale(x, scale=3.0))
        loss = lay.reduce_sum(lay.square(ie()))
        pkg.optimizer.SGDOptimizer(learning_rate=0.001).minimize(loss)
    return main, startup, {"fetch": [loss], "param": "xp_ifelse",
                           "lr": 0.001}


def _host_if_else(x, feed):
    if feed["sel"][0] < 0.5:
        return _walk(0.0, x, 1.0)[0] ** 2
    return (3 * x) ** 2


def _ragged_x(lod_cls):
    return lod_cls.from_sequences([np.asarray([[0.4], [0.9], [0.2]],
                                              np.float32)])


# name -> (build(pkg), feeds(LoDTensor class), host loss(x, feed) for
# finite differences, or None for the analytic gradient)
WHILE_GRAD = {
    "while_sum": (_while_sum, lambda lod: [
        {"thr": _f32(1.0)}, {"thr": _f32(2.0)}, {"thr": _f32(1.0)}],
        lambda x, f: (_walk(0.0, x, float(f["thr"][0]))[0] - 2.0) ** 2),
    # x = 0.4 lands s2 on thr2 exactly: finite differences would cross a
    # trip-count boundary, so the analytic 2 s1 n1 + 2 s2 n2 is held, as
    # the reference test holds it
    "two_whiles": (_two_whiles, lambda lod: [
        {"thr1": _f32(1.0), "thr2": _f32(2.0)}] * 3, None),
    "nested_whiles": (_nested_whiles, lambda lod: [
        {"thr_out": _f32(2.0), "thr_in": _f32(1.0)}] * 3, _host_nested),
    "while_in_dynamic_rnn": (_while_in_drnn, lambda lod: [
        {"x": _ragged_x(lod)}] * 3, _host_drnn),
    "while_in_cond": (_while_in_cond, lambda lod: [
        {"thr_out": _f32(1.5), "thr_in": _f32(1.0)}] * 3, _host_cond),
    "while_in_if_else": (_while_in_if_else, lambda lod: [
        {"thr": _f32(1.0), "sel": _f32(0.0)},
        {"thr": _f32(1.0), "sel": _f32(1.0)},
        {"thr": _f32(1.0), "sel": _f32(0.0)}], _host_if_else),
}


def _ref_arm(built, feeds):
    """paddle_tpu's run of `feeds`: (startup values, the fetches of each
    step, the parameter before and after each step, the executor)."""
    main, startup, h = built
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.get(n)) for n in scope.local_names()}
    outs, params = [], [float(init[h["param"]][0])]
    for feed in feeds:
        outs.append([np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=h["fetch"], scope=scope)])
        params.append(float(np.asarray(scope.get(h["param"]))[0]))
    return init, outs, params, exe


def _port_arm(built, init, feeds, compiled):
    main, startup, h = built
    exe = ptt.Executor("cpu", compiled=compiled)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    ptt.load_param_arrays(scope, {n: init[n] for n in scope.local_names()
                                  if n in init})
    outs, params = [], [float(scope.get(h["param"])[0])]
    for feed in feeds:
        outs.append([np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=h["fetch"], scope=scope)])
        params.append(float(scope.get(h["param"])[0]))
    return outs, params, exe


@pytest.fixture(scope="module", params=sorted(WHILE_GRAD))
def while_grad(request):
    name = request.param
    build, feeds, host = WHILE_GRAD[name]
    built = _both(build)
    init, ref_outs, ref_params, ref_exe = _ref_arm(built["ref"],
                                                   feeds(RefLoDTensor))
    arms = {compiled: _port_arm(built["port"], init, feeds(LoDTensor),
                                compiled) for compiled in (True, False)}
    return dict(name=name, built=built, feeds=feeds(LoDTensor), host=host,
                ref=(ref_outs, ref_params, ref_exe), arms=arms)


def test_while_grad_program_json_equals_paddle_tpu(while_grad):
    for prog in (0, 1):
        assert while_grad["built"]["port"][prog].desc.to_json() == \
            while_grad["built"]["ref"][prog].desc.to_json()


def test_while_grad_program_matches_paddle_tpu(while_grad):
    ref_outs, ref_params, _ = while_grad["ref"]
    outs, params, _ = while_grad["arms"][True]
    for step, (r, p) in enumerate(zip(ref_outs, outs)):
        np.testing.assert_allclose(p[0].reshape(-1), r[0].reshape(-1),
                                   rtol=RTOL, err_msg=f"loss {step}")
        for r_steps, p_steps in zip(r[1:], p[1:]):   # trip counts
            assert int(p_steps) == int(r_steps), step
    np.testing.assert_allclose(params, ref_params, rtol=RTOL)


def test_while_grad_compiled_equals_eager_bit_for_bit(while_grad):
    (c_outs, c_params, _), (e_outs, e_params, _) = \
        while_grad["arms"][True], while_grad["arms"][False]
    for c, e in zip(c_outs, e_outs):
        for cv, ev in zip(c, e):
            assert cv.dtype == ev.dtype and np.array_equal(cv, ev)
    assert c_params == e_params


def test_while_grad_matches_finite_differences(while_grad):
    """The applied SGD gradient (x_before - x_after) / lr of every step
    against central differences of the host replica."""
    _, params, exe = while_grad["arms"][True]
    lr = while_grad["built"]["port"][2]["lr"]
    host, eps = while_grad["host"], 1e-3
    for step, feed in enumerate(while_grad["feeds"]):
        x = params[step]
        if host is None:    # two_whiles
            (s1, n1), (s2, n2) = (_walk(np.float32(0), np.float32(x), thr)
                                  for thr in (1.0, 2.0))
            np.testing.assert_allclose((x - params[step + 1]) / lr,
                                       2 * s1 * n1 + 2 * s2 * n2,
                                       rtol=1e-4, err_msg=f"step {step}")
            continue
        g_fd = (host(x + eps, feed) - host(x - eps, feed)) / (2 * eps)
        np.testing.assert_allclose((x - params[step + 1]) / lr, g_fd,
                                   rtol=1e-3, err_msg=f"step {step}")
    if while_grad["name"] == "while_sum":
        # analytic: dloss/dx = 2 (s - target) n, x = 0.3 and thr 1.0: n 4
        np.testing.assert_allclose((params[0] - params[1]) / lr,
                                   2 * (1.2 - 2.0) * 4, rtol=1e-4)


def test_while_grad_cache_misses_per_bucket(while_grad):
    """One compile key (one miss) per trip-count bucket: the port's cache
    counts what paddle_tpu's counts."""
    ref_exe = while_grad["ref"][2]
    exe = while_grad["arms"][True][2]
    assert exe.cache_stats == ref_exe.cache_stats
    uid = while_grad["built"]["port"][0].desc.uid
    ref_uid = while_grad["built"]["ref"][0].desc.uid
    assert sorted(k[6] for k in exe._cache if k[0] == uid) == \
        sorted(k[6] for k in ref_exe._cache if k[0] == ref_uid)


def test_while_grad_recompiles_per_trip_count_bucket():
    """The reference's bucket test (lr 0 keeps the parameter frozen):
    thr 1.0 runs 4 passes (bucket 4), 2.0 runs 7 (bucket 8), 1.0 again
    hits the first key."""
    built = _both(lambda pkg: _while_sum(pkg, lr=0.0))
    feeds = [{"thr": _f32(v)} for v in (1.0, 2.0, 1.0)]
    init, ref_outs, _, ref_exe = _ref_arm(built["ref"], feeds)
    outs, _, exe = _port_arm(built["port"], init, feeds, True)
    assert [int(o[1]) for o in outs] == [int(o[1]) for o in ref_outs] \
        == [4, 7, 4]
    for o, n in zip(outs, (4, 7, 4)):
        np.testing.assert_allclose(float(o[0]), (0.3 * n - 2.0) ** 2,
                                   rtol=1e-4)
    assert exe.cache_stats == ref_exe.cache_stats == {"hits": 1,
                                                      "misses": 3}
    uid = built["port"][0].desc.uid
    assert sorted(k[6] for k in exe._cache if k[0] == uid) == \
        [(("while_0", 4),), (("while_0", 8),)]


def test_while_grad_keys_capture_except_cond(while_grad):
    """Every key of the probed programs could be captured on the card,
    except where a cond reads its predicate on the host."""
    exe = while_grad["arms"][True][2]
    uid = while_grad["built"]["port"][0].desc.uid
    want = ("cond",) if while_grad["name"] == "while_in_cond" else ()
    for key, compiled in exe._cache.items():
        if key[0] == uid:
            assert compiled.uncaptured_ops == want
            assert not compiled.replayed


def test_forward_only_unbounded_while_needs_no_probe():
    def build(pkg):
        lay, cf = pkg.layers, pkg.layers.control_flow
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            i = lay.fill_constant([1], "float32", 0.0)
            lim = lay.data("lim", [1], dtype="float32")
            cond = cf.less_than_v(i, lim)
            w = cf.While(cond)
            with w.block():
                lay.increment(i, value=1.0, in_place=True)
                cf.less_than_v(i, lim, cond=cond)
        return main, startup, [i, w.steps]

    built = _both(build)
    assert built["port"][0].desc.to_json() == built["ref"][0].desc.to_json()
    for compiled in (True, False):
        main, startup, fetch = built["port"]
        exe = ptt.Executor("cpu", compiled=compiled)
        exe.run(startup)
        iv, steps = exe.run(main, feed={"lim": _f32(5.0)}, fetch_list=fetch)
        assert float(iv.reshape(())) == 5.0 and int(steps) == 5
        assert not exe._probe_cache
        if compiled:    # the host-driven route is never captured
            assert exe.last_compiled.uncaptured_ops == ("while",)


@pytest.fixture
def stateful_op():
    """A stateful op type registered in the port for one test (the
    channel ops that are stateful in paddle_tpu wait for ROADMAP A11)."""
    register_op("test_stateful_marker", stateful=True)(
        lambda ctx: ctx.set_output("Out", ctx.input("X")))
    yield "test_stateful_marker"
    del OpRegistry._ops["test_stateful_marker"]


def test_stateful_op_in_probe_prefix_raises(stateful_op):
    lay, cf = ptt.layers, ptt.layers.control_flow
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = lay.create_parameter(shape=[1], dtype="float32", name="xp_st",
                                 default_initializer=_const(ptt, 0.3))
        v = lay.fill_constant([1], "float32", 1.0)
        main.global_block().append_op(stateful_op, inputs={"X": v},
                                      outputs={"Out": v})
        thr = lay.data("thr_st", [1], dtype="float32")
        s = lay.fill_constant([1], "float32", 0.0)
        s.stop_gradient = False
        cond = cf.less_than_v(s, thr)
        w = cf.While(cond)
        with w.block():
            lay.assign(lay.elementwise_add(s, x), output=s)
            cf.less_than_v(s, thr, cond=cond)
        loss = lay.reduce_sum(lay.square(s))
        ptt.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    for compiled in (True, False):
        exe = ptt.Executor("cpu", compiled=compiled)
        exe.run(startup)
        with pytest.raises(RuntimeError, match="stateful"):
            exe.run(main, feed={"thr_st": _f32(1.0)}, fetch_list=[loss])


def test_iterations_with_probed_bound_refused():
    main, startup, h = _while_sum(ptt)
    exe = ptt.Executor("cpu")
    exe.run(startup)
    with pytest.raises(RuntimeError, match="iterations > 1"):
        exe.run(main, feed={"thr": _f32(1.0)}, fetch_list=h["fetch"],
                iterations=2)


def test_backward_refuses_a_while_without_dynamic_bound():
    """A While built without the dynamic_bound attr (an old program) and
    no max_steps has no gradient route: both packages refuse it with the
    same words."""
    msgs = []
    for pkg in (pt, ptt):
        lay, cf = pkg.layers, pkg.layers.control_flow
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = lay.create_parameter(shape=[1], dtype="float32", name="xo",
                                     default_initializer=_const(pkg, 0.3))
            thr = lay.data("thr", [1], dtype="float32")
            s = lay.fill_constant([1], "float32", 0.0)
            s.stop_gradient = False
            cond = cf.less_than_v(s, thr)
            w = cf.While(cond)
            with w.block():
                lay.assign(lay.elementwise_add(s, x), output=s)
                cf.less_than_v(s, thr, cond=cond)
            for op in main.desc.global_block.ops:
                if op.type == "while":
                    del op.attrs["dynamic_bound"]
            loss = lay.reduce_sum(lay.square(s))
            with pytest.raises(NotImplementedError) as err:
                pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# -- the exhaustion flag (tests/test_dynamic_rnn.py :276-345) ---------------

def _bounded_counter(pkg, max_steps):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        i = lay.fill_constant([1], "float32", 0.0)
        limit = lay.fill_constant([1], "float32", 5.0)
        cond = cf.less_than_v(i, limit)
        w = cf.While(cond, max_steps=max_steps)
        with w.block():
            lay.increment(i, value=1.0, in_place=True)
            cf.less_than_v(i, limit, cond=cond)
    return main, startup, i, w


@pytest.mark.parametrize("compiled", [True, False])
def test_bounded_while_exhaustion_flag(compiled, monkeypatch):
    built = _both(lambda pkg: _bounded_counter(pkg, 8))
    assert built["port"][0].desc.to_json() == built["ref"][0].desc.to_json()
    main, startup, i, w = built["port"]
    exe = ptt.Executor("cpu", compiled=compiled)
    exe.run(startup)
    iv, ex = exe.run(main, fetch_list=[i, w.exhausted])
    assert iv.item() == 5.0 and not ex.item()

    main, startup, i, w = _bounded_counter(ptt, 3)
    exe = ptt.Executor("cpu", compiled=compiled)
    exe.run(startup)
    port_executor._WARNED_WHILE_FLAGS.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        iv, ex = exe.run(main, fetch_list=[i, w.exhausted])
        assert iv.item() == 3.0 and ex.item()
        # checked one run later (no wait on the step in flight), once
        exe.run(main, fetch_list=[i])
        trunc = [c for c in caught if "max_steps" in str(c.message)]
        assert len(trunc) == 1 and trunc[0].category is RuntimeWarning
        exe.run(main, fetch_list=[i])
        exe.close()
        assert len([c for c in caught if "max_steps" in str(c.message)]) == 1

    monkeypatch.setattr(port_executor, "CHECK_WHILE_BOUND", True)
    for fetch in ([i], [i, w.exhausted]):   # fires when the flag is fetched
        exe = ptt.Executor("cpu", compiled=compiled)
        exe.run(startup)
        with pytest.raises(RuntimeError, match="max_steps"):
            exe.run(main, fetch_list=fetch)


# -- the ops one by one ------------------------------------------------------

def _array_program(pkg):
    """array_write (a new array of capacity 4, an existing one, an index
    past the end that clamps to the last slot), array_read, array_length,
    inside a bounded While too; the loss reads every slot."""
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [3], dtype="float32")
        x.desc.stop_gradient = False
        h = lay.fc(x, size=3, act="tanh")
        i0 = lay.fill_constant([1], "int64", 0)
        i1 = lay.fill_constant([1], "int64", 1)
        i9 = lay.fill_constant([1], "int64", 9)
        arr = cf.create_array("float32", capacity=4)
        cf.array_write(h, i0, array=arr)
        cf.array_write(lay.scale(h, scale=2.0), i1, array=arr)
        cf.array_write(lay.scale(h, scale=-1.0), i9, array=arr)
        n = cf.array_length(arr)
        # the While writes slot k the sum of slots 0..k-1, k = 1, 2
        k = lay.fill_constant([1], "int64", 1)
        lim = lay.fill_constant([1], "int64", 3)
        cond = cf.less_than_v(k, lim)
        w = cf.While(cond, max_steps=4)
        with w.block():
            prev = cf.array_read(arr, lay.increment(k, value=-1.0,
                                                    in_place=False))
            cur = cf.array_read(arr, k)
            cf.array_write(lay.elementwise_add(prev, cur), k, array=arr)
            lay.increment(k, value=1.0, in_place=True)
            cf.less_than_v(k, lim, cond=cond)
        reads = [cf.array_read(arr, lay.fill_constant([1], "int64", j))
                 for j in range(4)]
        loss = lay.mean(lay.elementwise_mul(
            lay.concat(reads, axis=1), lay.concat(reads[::-1], axis=1)))
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, {"fetch": [loss, n, k] + reads, "x": x}


def _static_rnn_program(pkg):
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
        out = rnn()
        loss = lay.mean(lay.square(out))
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, {"fetch": [loss, out]}


def _pipeline_program(pkg):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [6], dtype="float32")
        pipe = cf.PipelinedStack(n_stages=3)
        with pipe.block():
            a = pipe.stage_input(x)
            pipe.stage_output(lay.fc(a, size=6, act="tanh"))
        loss = lay.mean(lay.square(pipe()))
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, {"fetch": [loss]}


def _support_ops_program(pkg):
    """The eight supporting op types: fill_constant_batch_size_like,
    increment, greater_than, greater_equal, not_equal, logical_and,
    logical_or, fill_zeros_like (the comparisons gate a select)."""
    lay = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [3], dtype="float32")
        y = lay.data("y", [3], dtype="float32")
        h = lay.fc(x, size=3)
        full = lay.fill_constant_batch_size_like(x, [-1, 3], "float32", 0.5)
        inc = lay.increment(h, value=2.0, in_place=False)
        gt, ge, ne = (lay.greater_than(h, y), lay.greater_equal(h, y),
                      lay.not_equal(h, y))
        both = lay.logical_and(gt, ne)
        either = lay.logical_or(ge, lay.greater_than(y, full))
        zeros = lay.zeros_like(h)
        picked = lay.elementwise_add(
            lay.elementwise_mul(inc, lay.cast(both, "float32")),
            lay.elementwise_mul(lay.elementwise_add(zeros, full),
                                lay.cast(either, "float32")))
        loss = lay.mean(lay.square(picked))
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, {"fetch": [loss, picked, both, either, full]}


def _op_feed(name):
    rng = np.random.RandomState(3)
    if name == "static_rnn":
        return {"x": rng.randn(5, 4, 8).astype(np.float32)}
    if name == "pipeline":
        return {"x": rng.randn(4, 6).astype(np.float32)}
    return {"x": rng.randn(4, 3).astype(np.float32),
            "y": rng.randn(4, 3).astype(np.float32)}


OP_PROGRAMS = {"arrays": _array_program, "static_rnn": _static_rnn_program,
               "pipeline": _pipeline_program,
               "support_ops": _support_ops_program}


@pytest.mark.parametrize("name", sorted(OP_PROGRAMS))
def test_op_program_matches_paddle_tpu(name):
    """Each op program: equal to_json; 3 SGD steps from paddle_tpu's
    startup values through both port executors; fetches, every step-1
    gradient and the parameters after held within rtol 1e-5 (atol 1e-6);
    compiled and eager bit for bit."""
    built = _both(OP_PROGRAMS[name])
    assert built["port"][0].desc.to_json() == built["ref"][0].desc.to_json()
    assert built["port"][1].desc.to_json() == built["ref"][1].desc.to_json()
    feed = _op_feed(name)
    main, startup, h = built["ref"]
    params = [p.name for p in main.all_parameters()]
    fetch = [v.name for v in h["fetch"]] + [p + "@GRAD" for p in params]
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.get(n)) for n in scope.local_names()}
    ref = [[np.asarray(v) for v in exe.run(main, feed=feed,
                                           fetch_list=fetch, scope=scope)]
           for _ in range(3)]
    ref_params = {p: np.asarray(scope.get(p)) for p in params}
    arms = {}
    for compiled in (True, False):
        main, startup, _ = built["port"]
        pexe, pscope = ptt.Executor("cpu", compiled=compiled), ptt.Scope()
        pexe.run(startup, scope=pscope)
        ptt.load_param_arrays(pscope, {n: init[n] for n in
                                       pscope.local_names() if n in init})
        outs = [pexe.run(main, feed=feed, fetch_list=fetch, scope=pscope)
                for _ in range(3)]
        arms[compiled] = (outs, {p: pscope.get(p).numpy() for p in params},
                          pexe)
    outs, port_params, pexe = arms[True]
    for step in range(3):
        for j, (r, p) in enumerate(zip(ref[step], outs[step])):
            np.testing.assert_allclose(
                np.asarray(p, np.float64), np.asarray(r, np.float64),
                rtol=RTOL, atol=1e-6, err_msg=f"{name} step {step} {fetch[j]}")
    for p in params:
        np.testing.assert_allclose(port_params[p], ref_params[p],
                                   rtol=RTOL, atol=1e-6)
    e_outs, e_params, _ = arms[False]
    for c_step, e_step in zip(outs, e_outs):
        for c, e in zip(c_step, e_step):
            assert np.array_equal(c, e)
    for p in params:
        assert np.array_equal(port_params[p], e_params[p])
    assert pexe.last_compiled.uncaptured_ops == ()
    assert not pexe.last_compiled.replayed


def test_array_ops_clamp_and_capacity():
    """array_length is the capacity (int64), the write past the end lands
    in the last slot, and the index never leaves the device."""
    main, startup, h = _array_program(ptt)
    exe = ptt.Executor("cpu")
    exe.run(startup)
    out = exe.run(main, feed=_op_feed("arrays"), fetch_list=h["fetch"])
    assert out[1].dtype == np.int64 and int(out[1]) == 4
    assert int(out[2][0]) == 3                      # the While ran k = 1, 2
    np.testing.assert_array_equal(out[6], -out[3])  # slot 3 = -slot 0


def test_pipeline_on_a_pipe_mesh_waits_for_a11():
    main, startup, h = _pipeline_program(ptt)
    op = next(op for op in main.desc.global_block.ops
              if op.type == "pipeline")
    exe = ptt.Executor("cpu", compiled=False)
    exe.run(startup)

    class Mesh:
        axis_names = ("pipe",)

    env = {n: torch.zeros(4, 6) if n == "x" else ptt.global_scope().get(n)
           for n in op.input_names()}
    from paddle_tpu_torch.core.registry import run_op
    with pytest.raises(NotImplementedError, match="A11"):
        run_op(op, env, {"device": torch.device("cpu"), "mesh": Mesh(),
                         "program": main.desc})


def test_control_flow_op_types_registered():
    """The nine control-flow op types and the eight supporting ones, under
    paddle_tpu's names, slots and attrs: 118 types in all (matmul and
    se_block came with the analysis slice, lrn with the image models,
    cos_sim, linear_chain_crf and crf_decoding with the book's last
    chapters); go waits for the CSP module (ROADMAP A11)."""
    from paddle_tpu.core.registry import OpRegistry as RefRegistry
    new = ["while", "static_rnn", "dynamic_rnn", "cond", "if_else",
           "array_write", "array_read", "array_length", "pipeline",
           "fill_constant_batch_size_like", "increment", "greater_than",
           "greater_equal", "not_equal", "logical_and", "logical_or",
           "fill_zeros_like"]
    port = set(OpRegistry._ops)
    assert set(new) <= port and "go" not in port
    assert len(port) == 118
    for t in new:
        ours, ref = OpRegistry.get(t), RefRegistry.get(t)
        assert ours.no_grad_slots == ref.no_grad_slots, t
        assert ours.ragged_aware == ref.ragged_aware, t
        assert (ours.infer_shape is None) == (ref.infer_shape is None), t


def _frozen_inf(pkg):
    """A bounded While whose body divides by (limit - s): the last two of
    its four passes run on the frozen carry s = limit, where the body's
    x / (limit - s) is inf. The select keeps the frozen value, so the
    forward is finite, but the chain rule through that pass multiplies
    the zero cotangent by an infinite derivative."""
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.create_parameter(shape=[1], dtype="float32", name="xf",
                                 default_initializer=_const(pkg, 0.5))
        limit = lay.fill_constant([1], "float32", 1.0)
        s = lay.fill_constant([1], "float32", 0.0)
        s.stop_gradient = False
        cond = cf.less_than_v(s, limit)
        w = cf.While(cond, max_steps=4)
        with w.block():
            blowup = lay.elementwise_div(x, lay.elementwise_sub(limit, s))
            step = lay.elementwise_add(x, lay.scale(blowup, scale=0.0))
            lay.assign(lay.elementwise_add(s, step), output=s)
            cf.less_than_v(s, limit, cond=cond)
        loss = lay.reduce_sum(lay.square(lay.elementwise_sub(
            s, lay.fill_constant([1], "float32", 2.0))))
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, {"fetch": [loss, w.steps, "xf@GRAD"],
                           "param": "xf"}


def test_masked_loop_frozen_pass_inf_gives_nan_gradient_in_both():
    """ROADMAP C10: a masked loop runs its body on frozen carries too; a
    body that makes inf there turns the frozen pass's zero cotangent into
    NaN. Both packages give the same finite loss and the same NaN
    gradient: the port mirrors the reference and does not mask it."""
    built = _both(_frozen_inf)
    fetch = lambda h: [v if isinstance(v, str) else v.name  # noqa: E731
                       for v in h["fetch"]]
    main, startup, h = built["ref"]
    exe = pt.Executor()
    exe.run(startup)
    ref = exe.run(main, fetch_list=fetch(h))
    for compiled in (True, False):
        main, startup, h = built["port"]
        pexe = ptt.Executor("cpu", compiled=compiled)
        pexe.run(startup)
        got = pexe.run(main, fetch_list=fetch(h))
        assert float(got[0]) == float(ref[0]) == 1.0   # s = 1.0 after 2
        assert int(got[1]) == int(ref[1]) == 2
        assert np.isnan(got[2]).all() and np.isnan(np.asarray(ref[2])).all()
