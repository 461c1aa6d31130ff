"""Control-flow programs under bf16 AMP in paddle_tpu_torch against
paddle_tpu.

(a) The trained programs of tests/test_torch_control_flow_programs.py:
the DynamicRNN programs (``drnn_trains``, ``lint_dynamic_rnn``, the
book's ``dyn_rnn_lstm``), the Whiles (``bounded_while_trains``,
``unbounded_fc_while`` through the probe-and-replay WhileGrad,
``lint_while``), the StaticRNN (``lint_static_rnn``), the IfElses
(``if_else_trains``, ``lint_ifelse``) and the book's MT with its
DynamicRNN decoder on the kernel route (PADDLE_TPU_PALLAS_LSTM=force:
the reference interprets its Pallas kernels, the port runs their plain
twins). Each runs 3 steps under ``amp_guard()`` in both executors from
paddle_tpu's startup values on the same seeded feeds, the reference
compiled with XLA's excess precision off (``_rounding_reference`` of
tests/test_torch_amp.py: the reference then rounds each bf16 op's
result, as the port's op rules do). Held as tests/test_torch_amp.py
holds its programs: every variable the forward produces has the
reference's dtype, and each quantity's distance (2-norm) from the
reference's AMP run is at most AMP_FRACTION = 0.25 of the reference's
own AMP-to-float32 distance for it: at step 1 every forward value and
every parameter's gradient (the biases' within the vector of all
gradients: the reference's CPU backend sums a bias gradient in bf16),
after 3 steps the losses, the weights and the biases, each as one
vector, the biases at ACT_FRACTION (below). On ``drnn_trains`` the
first two losses are equal exactly.

Where a program runs tanh or sigmoid in bf16 (ACT_PROGRAMS), its
gradients, parameters and losses are held at ACT_FRACTION = 2.0 of that
distance instead, and so are the forward values downstream of a bf16
sigmoid (``dyn_rnn_lstm``): the two packages round these ops differently, by a
bounded amount that test_bf16_activations_round_within_bounds pins on
the CPU: XLA computes bf16 sigmoid's forward and both activations'
derivative rules as chains of bf16 primitives, each rounded (the
reference then sits 1-2 bf16 ulps from torch's single rounding: sigmoid
forward within 2 ulps of the output in 34% of elements, tanh's backward
within 2 ulps of the cotangent and sigmoid's within 1 in 41-45%), while
torch's kernels round once. Measured on this file's programs: every
other quantity matches the reference exactly (forward values, losses and
step-1 gradients of the Whiles, the IfElses and the bias-free carries),
the losses of all programs at most 0.054 of the distance, and the
gradients and parameters of ACT_PROGRAMS 0.39-1.49 of it. These figures
are from paddle_tpu's startup values; from the port's (another seeded
draw) the losses of ``dyn_rnn_lstm`` sit 1.21 of the distance away,
``drnn_trains``' first loss one float32 ulp, and ``if_else_trains``'
gradients 0.40 of it (its sub-block biases'): which elements land on a
rounding boundary depends on the draw. The biases
after 3 steps sit 1.07 of it from the reference in ``if_else_trains``
(whose weights agree to 1e-7): a bias's gradient, summed in bf16 by the
reference's CPU backend and in float32 by the port, moves the bias by a
different Adam step at steps 2 and 3. A fault of
the program's arithmetic moves a quantity by O(its size), far above
either bound; a port that skipped AMP would show float32 dtypes.

(b) Carries that change dtype. Under AMP a ``mul`` returns bf16, so a
memory or While carry that enters float32 can leave a pass bf16: a
DynamicRNN whose memory is ``fc([w, prev], bias_attr=False)``, a
StaticRNN whose memory is updated the same way, and a bounded and an
unbounded While whose fill_constant carry is updated by a bias-free fc
(one ``mul``). The reference's lax.scan and lax.while_loop refuse a
carry whose type changes (TypeError while it traces, before any step
runs), except where a jnp.where selects finished rows first (the
DynamicRNN, the bounded While): type promotion keeps that carry float32.
So the DynamicRNN and the bounded While run in both packages: the carry
is float32 at every pass (the port's passes recorded one by one, the
reference's scan has one carry type), the fetched memory and loop output
have the reference's dtypes, and the values are held as in (a). The
StaticRNN and the unbounded While raise TypeError in both packages
before any parameter changes (ROADMAP C12: the port ran both until it
checked its carries).
"""
import importlib
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.lod import LoDTensor as RefLoDTensor
from paddle_tpu.core.lod import RaggedPair as RefRaggedPair
from paddle_tpu_torch import amp
from paddle_tpu_torch.core.lod import LoDTensor, RaggedPair
from paddle_tpu_torch.ops import control_flow_ops
from test_torch_amp import (AMP_FRACTION, _dtype_name, _far, _flat,
                            _forward_vars, _gap, _rounding_reference)
from test_torch_control_flow_programs import (PROGRAMS as CF_PROGRAMS,
                                              _both, _feeds as cf_feeds,
                                              _ragged)

STEPS = 3
FORCE = {"PADDLE_TPU_PALLAS_LSTM": "force"}
ACT_FRACTION = 2.0
#: the programs that run tanh or sigmoid in bf16 under AMP
ACT_PROGRAMS = {"drnn_trains", "dyn_rnn_lstm", "lint_dynamic_rnn",
                "bounded_while_trains", "mt"}
#: and of those, with a bf16 sigmoid in the forward
SIGMOID_PROGRAMS = {"dyn_rnn_lstm"}


@pytest.fixture(autouse=True)
def _amp_off():
    pt.amp.enable(False)
    amp.enable(False)
    ptt.reset_default_programs()
    yield
    pt.amp.enable(False)
    amp.enable(False)


# -- (b): carries that change dtype under AMP --------------------------------

def _drnn_bias_free(pkg):
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [3], dtype="float32", lod_level=1)
        tgt = lay.data("tgt", [4], dtype="float32")
        drnn = cf.DynamicRNN()
        with drnn.block():
            w = drnn.step_input(x)
            prev = drnn.memory(shape=[4], value=0.0)
            nxt = lay.fc([w, prev], size=4, bias_attr=False)
            drnn.update_memory(prev, nxt)
            drnn.output(nxt, prev)
        out, mems = drnn()
        last = drnn.last_memory()
        loss = lay.mean(lay.square(last - tgt))
        pkg.optimizer.AdamOptimizer(learning_rate=0.05).minimize(loss)
    return main, startup, [loss, last, out, mems]


def _static_rnn_bias_free(pkg):
    lay = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [5, 4, 8], append_batch_size=False)
        rnn = lay.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[4, 8], value=0.0)
            nh = lay.fc([xt, mem], size=8, bias_attr=False)
            rnn.update_memory(mem, nh)
            rnn.step_output(nh)
        loss = lay.mean(rnn())
        pkg.optimizer.AdamOptimizer(learning_rate=0.01).minimize(loss)
    return main, startup, [loss]


def _while_mul(max_steps):
    def build(pkg):
        lay, cf = pkg.layers, pkg.layers.control_flow
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = lay.data("x", [4], dtype="float32")
            s = lay.fill_constant([3, 4], "float32", 0.5)
            s.stop_gradient = False
            counter = lay.fill_constant([1], "int64", 0)
            limit = lay.fill_constant([1], "int64", 3)
            cond = cf.less_than_v(counter, limit)
            w = cf.While(cond, max_steps=max_steps)
            with w.block():
                lay.assign(lay.fc(s, size=4, bias_attr=False), output=s)
                lay.increment(counter, value=1.0, in_place=True)
                cf.less_than_v(counter, limit, cond=cond)
            loss = lay.mean(lay.elementwise_mul(s, x))
            pkg.optimizer.SGDOptimizer(learning_rate=0.5).minimize(loss)
        return main, startup, [loss, s, w.steps]
    return build


CARRY_PROGRAMS = {
    "drnn_bias_free": _drnn_bias_free,
    "static_rnn_bias_free": _static_rnn_bias_free,
    "while_mul_bounded": _while_mul(8),
    "while_mul_unbounded": _while_mul(None),
}
REFUSED = ["lint_static_rnn", "static_rnn_bias_free", "while_mul_unbounded"]


def _carry_feeds(name, pair_cls):
    rng = np.random.RandomState(0)
    if name == "drnn_bias_free":
        seqs = [rng.randn(n, 3).tolist() for n in (4, 2, 3)]
        return [{"x": _ragged(pair_cls, seqs, 3, 5),
                 "tgt": rng.randn(3, 4).astype(np.float32)}] * STEPS
    if name == "static_rnn_bias_free":
        return [{"x": rng.randn(5, 4, 8).astype(np.float32)}] * STEPS
    return [{"x": rng.randn(3, 4).astype(np.float32)}] * STEPS


# -- (a) and (b): the arms --------------------------------------------------

A_PROGRAMS = ["drnn_trains", "dyn_rnn_lstm", "lint_dynamic_rnn",
              "bounded_while_trains", "unbounded_fc_while", "lint_while",
              "if_else_trains", "lint_ifelse", "mt"]
RUN_PROGRAMS = A_PROGRAMS + ["drnn_bias_free", "while_mul_bounded"]


def _built(name):
    return _both(CARRY_PROGRAMS.get(name) or CF_PROGRAMS[name])


def _feeds(name, pkg):
    lod, pair = (RefLoDTensor, RefRaggedPair) if pkg is pt else \
        (LoDTensor, RaggedPair)
    if name in CARRY_PROGRAMS:
        return _carry_feeds(name, pair)
    return cf_feeds(name, lod, pair)


def _value(v):
    """(dtype name, float64 array) of a fetch; a ragged one by its
    data."""
    if hasattr(v, "lod") or type(v).__name__ in ("LoDTensor", "RaggedPair"):
        v = v.data
    name = _dtype_name(v)
    if isinstance(v, torch.Tensor):
        return name, v.detach().double().numpy()
    return name, np.asarray(np.asarray(v).astype(np.float32), np.float64)


def _biases(main):
    """The parameters that enter an elementwise op of any block as its
    broadcast operand (the fc biases, in sub-blocks too)."""
    params = {p.name for p in main.all_parameters()}
    return {op.input("Y")[0] for blk in main.desc.blocks for op in blk.ops
            if op.type.startswith("elementwise_")
            and op.input("Y")[0] in params}


def _init(built):
    """paddle_tpu's startup values of `built` (deterministic seeds),
    carried into the port."""
    main, startup, _ = built
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    return {n: np.asarray(scope.get(n)) for n in scope.local_names()}


def _arm(pkg, built, init, feeds, on):
    """STEPS steps of `built` (main, startup, fetch) from `init`, AMP on
    or off: {"losses", "fetch_dtypes", "dtypes", "step1", "params"}."""
    main, startup, fetch = built
    exe = pt.Executor() if pkg is pt else ptt.Executor(place="cpu")
    scope = pkg.Scope()
    if pkg is pt:
        for n, v in init.items():
            scope.set(n, jnp.asarray(v))
    else:
        exe.run(startup, scope=scope)
        ptt.load_param_arrays(scope, {n: init[n] for n in
                                      scope.local_names() if n in init})
    fwd = _forward_vars(main)
    params = [p.name for p in main.all_parameters()]
    names = [f.name for f in fetch] + fwd + [p + "@GRAD" for p in params]
    out = {"losses": []}
    with mock.patch.dict(os.environ, FORCE), pt.amp.amp_guard(on), \
            amp.amp_guard(on):
        for step, feed in enumerate(feeds):
            got = [_value(v) for v in exe.run(
                main, feed=feed, fetch_list=names, scope=scope,
                return_numpy=False)]
            out["losses"].append(float(got[0][1].reshape(-1)[0]))
            if step == 0:
                out["fetch_dtypes"] = [d for d, _ in got[:len(fetch)]]
                out["dtypes"] = {n: d for n, (d, _) in
                                 zip(fwd, got[len(fetch):])}
                out["step1"] = {n: v for n, (d, v) in zip(names, got)
                                if d in ("float32", "bfloat16")}
    out["params"] = {p: _value(scope.get(p))[1] for p in params}
    return out


@pytest.fixture(scope="module")
def trained():
    out = {}
    for name in RUN_PROGRAMS:
        built = _built(name)
        init = _init(built["ref"])
        with _rounding_reference():
            runs = {k: _arm(pt, built["ref"], init, _feeds(name, pt), on)
                    for k, on in (("ref_amp", True), ("ref_f32", False))}
        runs["port_amp"] = _arm(ptt, built["port"], init,
                                _feeds(name, ptt), True)
        runs["biases"] = _biases(built["port"][0])
        out[name] = runs
    return out


@pytest.mark.parametrize("name", RUN_PROGRAMS)
def test_forward_dtypes_match_reference(trained, name):
    """Every variable the global block's forward produces, and every
    fetch, has the reference's dtype (the selected memories and carries
    float32 in both; ragged fetches come back widened in both), and AMP
    moved the reference's run (its step 1 differs from float32)."""
    runs = trained[name]
    ref = runs["ref_amp"]
    assert runs["port_amp"]["dtypes"] == ref["dtypes"]
    assert runs["port_amp"]["fetch_dtypes"] == ref["fetch_dtypes"]
    assert "bfloat16" not in runs["ref_f32"]["dtypes"].values()
    f32 = runs["ref_f32"]["step1"]
    assert any(_gap(v, f32[n]) > 0 for n, v in ref["step1"].items()
               if n in f32)


@pytest.mark.parametrize("name", RUN_PROGRAMS)
def test_step1_reproduces_the_amp_rounding(trained, name):
    """Every forward value and every parameter's gradient at step 1, each
    by 2-norm, and all gradients as one vector, at AMP_FRACTION of the
    reference's AMP-to-float32 distance (ACT_FRACTION where the module
    docstring says); the global block's bias gradients only within the
    vector."""
    runs = trained[name]
    ref, f32 = runs["ref_amp"]["step1"], runs["ref_f32"]["step1"]
    port = runs["port_amp"]["step1"]
    skip = {b + "@GRAD" for b in runs["biases"]}
    pairs = {n: (_gap(port[n], ref[n]), _gap(ref[n], f32[n]))
             for n in ref if n not in skip and n in f32
             and _gap(ref[n], f32[n]) > 0}
    grads = [p + "@GRAD" for p in sorted(runs["ref_amp"]["params"])]
    pairs["every gradient"] = (
        _gap(_flat(port, grads), _flat(ref, grads)),
        _gap(_flat(ref, grads), _flat(f32, grads)))
    assert len(pairs) > 3
    fwd = {n: p for n, p in pairs.items() if n in runs["ref_amp"]["dtypes"]}
    grad = {n: p for n, p in pairs.items() if n not in fwd}
    act = ACT_FRACTION / AMP_FRACTION
    if name in SIGMOID_PROGRAMS:
        fwd = {n: (d / act, lim) for n, (d, lim) in fwd.items()}
    if name in ACT_PROGRAMS:
        grad = {n: (d / act, lim) for n, (d, lim) in grad.items()}
    far = _far({**fwd, **grad})
    assert not far, f"{name}: {far}"


@pytest.mark.parametrize("name", RUN_PROGRAMS)
def test_three_steps_reproduce_the_amp_rounding(trained, name):
    runs = trained[name]
    port, ref, f32 = (runs[k] for k in ("port_amp", "ref_amp", "ref_f32"))
    assert all(np.isfinite(port["losses"]))
    names = sorted(ref["params"])
    act = AMP_FRACTION / ACT_FRACTION
    biases = sorted(runs["biases"])
    weights = [n for n in names if n not in runs["biases"]]
    pairs = {"losses": ((act if name in ACT_PROGRAMS else 1.0)
                        * _gap(port["losses"], ref["losses"]),
                        _gap(ref["losses"], f32["losses"])),
             "weights": ((act if name in ACT_PROGRAMS else 1.0)
                         * _gap(_flat(port["params"], weights),
                                _flat(ref["params"], weights)),
                         _gap(_flat(ref["params"], weights),
                              _flat(f32["params"], weights)))}
    if biases:
        pairs["biases"] = (act * _gap(_flat(port["params"], biases),
                                      _flat(ref["params"], biases)),
                           _gap(_flat(ref["params"], biases),
                                _flat(f32["params"], biases)))
    assert not _far(pairs), f"{name}: {_far(pairs)}"


def test_drnn_trains_first_two_losses_equal(trained):
    """With the reference rounding each bf16 op, drnn_trains' first two
    AMP losses are the reference's exactly."""
    runs = trained["drnn_trains"]
    assert runs["port_amp"]["losses"][:2] == runs["ref_amp"]["losses"][:2]


@pytest.mark.parametrize("name", ["drnn_bias_free", "while_mul_bounded"])
def test_promoted_carry_stays_float32_at_every_pass(trained, name):
    """The selected carry is float32 at every pass in the port (each
    pass's memory as the body reads it, recorded), float32 in the
    reference (its scan's one carry type, the fetched memory or loop
    output), while the body's own update is bf16 in both."""
    runs = trained[name]
    # the last memory / the While's carried var, fetched
    assert runs["ref_amp"]["fetch_dtypes"][1] == "float32"
    assert runs["port_amp"]["fetch_dtypes"][1] == "float32"
    main, startup, fetch = _built(name)["port"]
    carried = _carried_names(main)
    seen = []
    trace = control_flow_ops._trace_sub

    def recording(ctx, block_idx, env):
        seen.append({n: str(env[n].dtype) for n in carried
                     if n in env and env[n].is_floating_point()})
        return trace(ctx, block_idx, env)

    exe = ptt.Executor(place="cpu")
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    with mock.patch.object(control_flow_ops, "_trace_sub", recording), \
            amp.amp_guard():
        exe.run(main, feed=_feeds(name, ptt)[0], fetch_list=fetch,
                scope=scope)
    passes = [s for s in seen if s]
    assert len(passes) >= 3
    assert all(set(s.values()) == {"torch.float32"} for s in passes), \
        passes


def _carried_names(main):
    """The names a loop op of `main`'s global block carries from pass to
    pass: a DynamicRNN's memories as its body reads them, a While's
    carried vars (its counter and condition among them)."""
    out = []
    for op in main.desc.global_block.ops:
        if op.type == "dynamic_rnn":
            out += op.attrs["mem_pre_names"]
        elif op.type == "while":
            out += op.attrs["carried_names"]
    return out


def _bf16_ulp(x):
    ax = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(ax)) - 7)


@pytest.mark.parametrize("act", ["tanh", "sigmoid"])
def test_bf16_activations_round_within_bounds(act):
    """The op-level source of ACT_FRACTION: the two packages' bf16 tanh
    and sigmoid ops (forward and __vjp__ backward), run through both
    executors under AMP on the same 4096 values and cotangents, differ
    only by rounding: forward within FWD_ULPS bf16 ulps of the output
    (tanh exactly, sigmoid up to 2), backward within 2 bf16 ulps of the
    cotangent, and each differs somewhere (the cause is real)."""
    fwd_ulps, bwd_ulps = {"tanh": 0.0, "sigmoid": 2.0}[act], 2.0
    rng = np.random.RandomState(0)
    feed = {"x": (rng.randn(64, 64) * 3).astype(np.float32),
            "g": rng.randn(64, 64).astype(np.float32),
            "eye": np.eye(64, dtype=np.float32)}

    def build(pkg):
        lay = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = lay.data("x", [64], dtype="float32")
            g = lay.data("g", [64], dtype="float32")
            eye = lay.data("eye", [64, 64], dtype="float32",
                           append_batch_size=False)
            x.stop_gradient = False
            # x times the identity under AMP: x rounded to bf16, a bf16
            # activation; g meets the bf16 y as a bf16 cotangent
            xb = lay.matmul(x, eye)
            y = getattr(lay, act)(xb)
            loss = lay.reduce_sum(lay.elementwise_mul(y, g))
            importlib.import_module(
                f"{pkg.__name__}.core.backward").append_backward(loss)
        return main, startup, [y, xb.name + "@GRAD"]

    got = {}
    built = _both(build)
    for pkg, who in ((pt, "ref"), (ptt, "port")):
        main, startup, fetch = built[who]
        exe = pt.Executor() if pkg is pt else ptt.Executor(place="cpu")
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        with amp.amp_guard(), pt.amp.amp_guard(), _rounding_reference():
            got[who] = [_value(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False)]
    (ry_t, ry), (rg_t, rg) = got["ref"]
    (py_t, py), (pg_t, pg) = got["port"]
    assert ry_t == py_t == rg_t == pg_t == "bfloat16"
    ulp_g = _bf16_ulp(np.asarray(np.asarray(feed["g"], np.float32)))
    assert np.max(np.abs(py - ry) / _bf16_ulp(ry)) <= fwd_ulps
    assert np.max(np.abs(pg - rg) / ulp_g) <= bwd_ulps
    assert np.any(pg != rg)
    if fwd_ulps:
        assert np.any(py != ry)


@pytest.mark.parametrize("name", REFUSED)
def test_changed_carry_is_refused_in_both_packages(name):
    """A StaticRNN memory and an unbounded While's carry that a bias-free
    fc turns bf16: the reference's lax.scan / lax.while_loop raise
    TypeError; the port raises TypeError too, and no parameter or
    optimizer state moves in either."""
    built = _built(name)
    init = _init(built["ref"])
    for pkg in (pt, ptt):
        main, startup, fetch = built["ref" if pkg is pt else "port"]
        exe = pt.Executor() if pkg is pt else ptt.Executor(place="cpu")
        scope = pkg.Scope()
        if pkg is pt:
            for n, v in init.items():
                scope.set(n, jnp.asarray(v))
        else:
            exe.run(startup, scope=scope)
            ptt.load_param_arrays(scope, {n: init[n] for n in
                                          scope.local_names() if n in init})
        before = {n: np.asarray(scope.get(n)).copy() if pkg is pt
                  else scope.get(n).numpy().copy()
                  for n in scope.local_names()}
        with amp.amp_guard(), pt.amp.amp_guard(), \
                pytest.raises(TypeError, match="carry input and carry "
                                               "output must have equal types"):
            exe.run(main, feed=_feeds(name, pkg)[0], fetch_list=fetch,
                    scope=scope)
        for n, v in before.items():
            now = np.asarray(scope.get(n)) if pkg is pt \
                else scope.get(n).numpy()
            assert np.array_equal(now, v), (pkg.__name__, n)
        # the same program runs in float32 in both
        with amp.amp_guard(False), pt.amp.amp_guard(False):
            loss = exe.run(main, feed=_feeds(name, pkg)[0],
                           fetch_list=fetch, scope=scope)[0]
        assert np.all(np.isfinite(np.asarray(loss)))


# -- cond whose branches leave different dtypes under AMP ---------------------

def _cond_fc_or_identity(pkg):
    """cond(p, fc(x, bias_attr=False), scale(x, 1.0)): under AMP the fc
    branch's ``mul`` returns bf16, the identity branch float32."""
    lay, cf = pkg.layers, pkg.layers.control_flow
    main, startup = pkg.Program(), pkg.Program()
    with pkg.framework.isolated_name_scope(), \
            pkg.program_guard(main, startup):
        x = lay.data("x", [4])
        p = lay.data("p", [1], dtype="bool", append_batch_size=False)
        out = cf.cond_op(p, lambda: lay.fc(x, size=4, bias_attr=False),
                         lambda: lay.scale(x, scale=1.0))
        loss = lay.mean(out)
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, [loss, out]


@pytest.mark.parametrize("taken", [True, False])
def test_cond_branches_of_other_dtypes_are_refused(taken):
    """The reference's lax.cond refuses branches whose outputs differ in
    dtype (TypeError while it traces, whichever branch the predicate
    takes); the port raises TypeError too before the cond sets its
    output, and no parameter moves in either. In float32 the same
    program runs in both packages with equal outputs."""
    feed = {"x": np.linspace(-1, 1, 8, dtype=np.float32).reshape(2, 4),
            "p": np.array([taken])}
    results = {}
    init = None
    for pkg in (pt, ptt):
        main, startup, fetch = _cond_fc_or_identity(pkg)
        exe = pt.Executor() if pkg is pt else ptt.Executor(place="cpu")
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            init = {n: np.asarray(scope.get(n)) for n in scope.local_names()}
        else:
            ptt.load_param_arrays(scope, {n: init[n] for n in
                                          scope.local_names() if n in init})
        before = {n: _value(scope.get(n))[1]
                  for n in scope.local_names()}
        with amp.amp_guard(), pt.amp.amp_guard(), \
                pytest.raises(TypeError, match="cond branches must have "
                                               "equal output types"):
            exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        for n, v in before.items():
            assert np.array_equal(_value(scope.get(n))[1], v), \
                (pkg.__name__, n)
        results[pkg.__name__] = exe.run(main, feed=feed, fetch_list=fetch,
                                        scope=scope)
    for r, p in zip(results["paddle_tpu"], results["paddle_tpu_torch"]):
        np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-7)
