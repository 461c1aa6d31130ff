"""paddle_tpu_torch's dense optimizers and learning-rate schedules against
paddle_tpu's.

- The ten update ops (adagrad, adamax, adadelta, rmsprop, decayed_adagrad,
  ftrl, lars_momentum, proximal_gd, proximal_adagrad, average_accumulates),
  each as a one-op program in both executors on the inputs and attrs of
  the reference's oracles (tests/test_optimizer_ops.py), chained over
  three steps (each step's outputs fed back in): every output equal to
  the reference's within float32 rounding (rtol 1e-6, atol 1e-7: the
  same float32 expressions; ftrl rtol 1e-5: its sigma divides the
  difference of two fractional powers, which torch's and XLA's pow round
  apart by an ulp, by lr = 0.01, a 3.3e-6 relative gap measured), the
  counters of average_accumulates exactly, over a window that closes.
- The classes (Adagrad, Adamax, DecayedAdagrad, Adadelta, RMSProp, Ftrl,
  LarsMomentum, and ModelAverage over Momentum) minimizing a tiny fc
  net: main and startup programs (and ModelAverage's apply and restore
  programs) serialize to equal JSON; from the reference's startup values,
  3 steps give the reference's losses and every parameter and
  accumulator (rtol 1e-5, atol 1e-6: sums of a few float32 products in
  another order). ModelAverage's apply swaps the averages in and its
  restore swaps the parameters back, as the reference's do. One class
  runs on a schedule through set_lr_in_scope.
- The seven schedules equal the reference's at steps 0, 1, 7 and 100.
"""
import importlib
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu import layers as ref_layers
from paddle_tpu import learning_rate_decay as ref_decay
from paddle_tpu_torch import framework, layers, learning_rate_decay

OP_RTOL, OP_ATOL = 1e-6, 1e-7
FTRL_RTOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
STEPS = 3
PKGS = {"ref": (pt, ref_framework, ref_layers),
        "port": (ptt, framework, layers)}
_BACKWARDS = [importlib.import_module(f"{pkg}.core.backward")
              for pkg in ("paddle_tpu", "paddle_tpu_torch")]


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


def _np(v):
    return v.numpy() if hasattr(v, "numpy") and not isinstance(
        v, np.ndarray) else np.asarray(v)


# -- the ops ------------------------------------------------------------------

def _f32(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


LR = np.array([0.01], np.float32)


def _op_case(op_type):
    """(state {slot: array}, {out slot: the in slot it feeds back}, attrs)
    from the reference's oracle test of `op_type`."""
    rng = np.random.RandomState(5)
    s = (4, 3)
    p = _f32(rng, s)
    zero = np.zeros(s, np.float32)
    cases = {
        "adagrad": ({"Moment": zero, "LearningRate": LR},
                    {"MomentOut": "Moment"}, {"epsilon": 1e-6}),
        "adamax": ({"Moment": zero, "InfNorm": zero, "LearningRate": LR,
                    "Beta1Pow": np.array([0.9], np.float32)},
                   {"MomentOut": "Moment", "InfNormOut": "InfNorm"},
                   {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "adadelta": ({"AvgSquaredGrad": zero, "AvgSquaredUpdate": zero},
                     {"AvgSquaredGradOut": "AvgSquaredGrad",
                      "AvgSquaredUpdateOut": "AvgSquaredUpdate"},
                     {"rho": 0.95, "epsilon": 1e-6}),
        "rmsprop": ({"Moment": zero, "MeanSquare": zero, "LearningRate": LR},
                    {"MomentOut": "Moment", "MeanSquareOut": "MeanSquare"},
                    {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.6}),
        "decayed_adagrad": ({"Moment": zero, "LearningRate": LR},
                            {"MomentOut": "Moment"},
                            {"decay": 0.95, "epsilon": 1e-6}),
        "ftrl": ({"SquaredAccumulator": np.full(s, 0.1, np.float32),
                  "LinearAccumulator": _f32(rng, s, -0.5, 0.5),
                  "LearningRate": LR},
                 {"SquaredAccumOut": "SquaredAccumulator",
                  "LinearAccumOut": "LinearAccumulator"},
                 {"l1": 0.05, "l2": 0.2, "lr_power": -0.3}),
        "lars_momentum": ({"Velocity": zero, "LearningRate": LR},
                          {"VelocityOut": "Velocity"},
                          {"mu": 0.9, "lars_coeff": 0.001,
                           "lars_weight_decay": 0.0005}),
        "proximal_gd": ({"LearningRate": LR}, {}, {"l1": 0.05, "l2": 0.1}),
        "proximal_adagrad": ({"Moment": np.full(s, 0.1, np.float32),
                              "LearningRate": LR}, {"MomentOut": "Moment"},
                             {"l1": 0.05, "l2": 0.1}),
    }
    if op_type == "average_accumulates":
        one = np.zeros(1, np.int32)
        state = {"param": p, "in_sum_1": zero, "in_sum_2": zero,
                 "in_sum_3": zero, "in_num_accumulates": one,
                 "in_old_num_accumulates": one, "in_num_updates": one}
        feed_back = {f"out_{n}": f"in_{n}" for n in
                     ("sum_1", "sum_2", "sum_3", "num_accumulates",
                      "old_num_accumulates", "num_updates")}
        # the window closes at update 2 (min 2, max(2, 3 * 0.5)), then
        # opens again
        return state, feed_back, {"average_window": 0.5,
                                  "min_average_window": 2,
                                  "max_average_window": 3}
    state, feed_back, attrs = cases[op_type]
    state = dict(state, Param=p, Grad=None)
    return state, dict(feed_back, ParamOut="Param"), attrs


def _op_runner(pkg, op_type, state, outs, attrs):
    """A one-op program over the slots of `state` in package `pkg`, built
    once: run(state) -> {out slot: array}."""
    mod, fw, _ = PKGS[pkg]
    main = fw.Program()
    with fw.isolated_name_scope():
        blk = main.global_block()
        for slot, v in state.items():
            blk.create_var(name=slot.lower(), shape=list(v.shape),
                           dtype=str(v.dtype), stop_gradient=True)
        for slot in outs:
            blk.create_var(name=slot.lower() + "_o", dtype="float32")
        blk.append_op(op_type,
                      inputs={s: [s.lower()] for s in state},
                      outputs={s: [s.lower() + "_o"] for s in outs},
                      attrs=attrs)
    exe = mod.Executor() if mod is pt else mod.Executor("cpu")

    def run(st):
        got = exe.run(main, feed={s.lower(): v for s, v in st.items()},
                      fetch_list=[s.lower() + "_o" for s in outs],
                      scope=mod.Scope())
        return {s: _np(v) for s, v in zip(outs, got)}
    return run


OP_TYPES = ["adagrad", "adamax", "adadelta", "rmsprop", "decayed_adagrad",
            "ftrl", "lars_momentum", "proximal_gd", "proximal_adagrad",
            "average_accumulates"]


@pytest.mark.parametrize("op_type", OP_TYPES)
def test_update_op_matches_reference(op_type):
    state, feed_back, attrs = _op_case(op_type)
    outs = list(feed_back)
    rng = np.random.RandomState(6)
    if "Grad" in state:
        state["Grad"] = _f32(rng, state["Param"].shape)
    states = {"ref": dict(state), "port": dict(state)}
    runs = {pkg: _op_runner(pkg, op_type, state, outs, attrs)
            for pkg in states}
    for step in range(STEPS):
        if step and "Grad" in state:
            g = _f32(rng, state["Param"].shape)
            for st in states.values():
                st["Grad"] = g
        got = {pkg: runs[pkg](st) for pkg, st in states.items()}
        for slot in outs:
            want, have = got["ref"][slot], got["port"][slot]
            if want.dtype.kind == "i":
                np.testing.assert_array_equal(have, want,
                                              err_msg=f"{slot} {step}")
            else:
                np.testing.assert_allclose(
                    have, want, rtol=FTRL_RTOL if op_type == "ftrl"
                    else OP_RTOL, atol=OP_ATOL,
                    err_msg=f"{slot} step {step}")
        for pkg, st in states.items():
            st.update({feed_back[s]: got[pkg][s] for s in outs})
    if op_type == "average_accumulates":
        # the window closed and reopened: sum_3 holds the closed sum
        assert int(states["port"]["in_old_num_accumulates"][0]) == 2
        assert np.abs(states["port"]["in_sum_3"]).sum() > 0


# -- the classes ----------------------------------------------------------------

CLASSES = [("AdagradOptimizer", dict(learning_rate=0.1)),
           ("AdamaxOptimizer", dict(learning_rate=0.1)),
           ("DecayedAdagradOptimizer", dict(learning_rate=0.1)),
           ("AdadeltaOptimizer", dict(learning_rate=1.0)),
           ("RMSPropOptimizer", dict(learning_rate=0.1, momentum=0.5)),
           ("FtrlOptimizer", dict(learning_rate=0.5, l1=0.01, l2=0.01)),
           ("LarsMomentumOptimizer", dict(learning_rate=10.0)),
           ("ModelAverage", dict(average_window_rate=0.5,
                                 min_average_window=2,
                                 max_average_window=3)),
           ("schedule", dict())]


def _net(pkg, name, kwargs):
    """The tiny fc net minimized by class `name` in package `pkg`: (main,
    startup, loss, optimizer, {name: program} of extra programs)."""
    mod, fw, lay = PKGS[pkg]
    main, startup = fw.Program(), fw.Program()
    extra = {}
    with fw.program_guard(main, startup):
        x = lay.data("x", [3], dtype="float32")
        y = lay.data("y", [1], dtype="float32")
        pred = lay.fc(lay.fc(x, size=4, act="tanh"), size=1)
        loss = lay.mean(lay.square_error_cost(pred, y))
        if name == "ModelAverage":
            _, params_grads = mod.optimizer.MomentumOptimizer(
                learning_rate=0.1, momentum=0.9).minimize(loss)
            opt = mod.optimizer.ModelAverage(params_grads, **kwargs)
            extra = {"apply": opt.apply_program,
                     "restore": opt.restore_program}
        elif name == "schedule":
            decay = (ref_decay if pkg == "ref" else learning_rate_decay)
            opt = mod.optimizer.AdagradOptimizer(
                learning_rate=decay.exponential_decay(0.5, 2, 0.5))
            opt.minimize(loss)
        else:
            opt = getattr(mod.optimizer, name)(**kwargs)
            opt.minimize(loss)
    return main, startup, loss, opt, extra


def _both(name, kwargs):
    saved = [m._SNAP_COUNTER[0] for m in _BACKWARDS]
    out = {}
    try:
        for pkg, (_, fw, _) in PKGS.items():
            for m in _BACKWARDS:
                m._SNAP_COUNTER[0] = 0
            with fw.isolated_name_scope():
                out[pkg] = _net(pkg, name, kwargs)
    finally:
        for m, n in zip(_BACKWARDS, saved):
            m._SNAP_COUNTER[0] = n
    return out


def _state(scope, names):
    return {n: _np(scope.get(n)).copy() for n in names}


@pytest.mark.parametrize("name,kwargs", CLASSES, ids=[c[0] for c in CLASSES])
def test_optimizer_class_matches_reference(name, kwargs):
    built = _both(name, kwargs)
    for i in (0, 1):
        assert json.loads(built["ref"][i].desc.to_json()) == \
            json.loads(built["port"][i].desc.to_json())
    for key in built["ref"][4]:
        assert json.loads(built["ref"][4][key].desc.to_json()) == \
            json.loads(built["port"][4][key].desc.to_json()), key
    rng = np.random.RandomState(1)
    feeds = [{"x": _f32(rng, (6, 3)), "y": _f32(rng, (6, 1))}
             for _ in range(STEPS)]
    rmain, rstart, rloss, ropt, rextra = built["ref"]
    pmain, pstart, ploss, popt, pextra = built["port"]
    rexe, rscope = pt.Executor(), pt.Scope()
    rexe.run(rstart, scope=rscope)
    names = sorted(rscope.local_names())
    init = _state(rscope, names)
    pexe, pscope = ptt.Executor("cpu"), ptt.Scope()
    pexe.run(pstart, scope=pscope)
    ptt.load_param_arrays(pscope, init)
    losses = {"ref": [], "port": []}
    for step, feed in enumerate(feeds):
        for pkg, exe, main, loss, opt, scope in (
                ("ref", rexe, rmain, rloss, ropt, rscope),
                ("port", pexe, pmain, ploss, popt, pscope)):
            opt.set_lr_in_scope(step, scope)
            out = exe.run(main, feed=feed, fetch_list=[loss.name],
                          scope=scope)
            losses[pkg].append(float(_np(out[0]).reshape(-1)[0]))
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=RTOL)
    want, have = _state(rscope, names), _state(pscope, names)
    for n in names:
        np.testing.assert_allclose(have[n], want[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    if name == "schedule":
        lr = popt.learning_rate_var.name
        assert float(have[lr][0]) == pytest.approx(0.5 * 0.5 ** 1.0)
    if name == "ModelAverage":
        params = [p.name for p in pmain.all_parameters()]
        for pkg, exe, opt, scope in (("ref", rexe, ropt, rscope),
                                     ("port", pexe, popt, pscope)):
            with pt.scope_guard(scope) if pkg == "ref" else \
                    ptt.scope_guard(scope):
                with opt.apply(exe):
                    averaged = _state(scope, params)
                restored = _state(scope, params)
            if pkg == "ref":
                ref_avg = averaged
            else:
                for n in params:
                    np.testing.assert_allclose(averaged[n], ref_avg[n],
                                               rtol=RTOL, atol=ATOL)
                    assert not np.array_equal(averaged[n], have[n])
                    np.testing.assert_array_equal(restored[n], have[n])


# -- the schedules --------------------------------------------------------------

SCHEDULES = [
    ("exponential_decay", (0.5, 3, 0.7), {"staircase": True}),
    ("natural_exp_decay", (0.5, 3, 0.7), {}),
    ("inverse_time_decay", (0.5, 3, 0.7), {"staircase": True}),
    ("polynomial_decay", (0.5, 10), {"power": 2.0, "cycle": True}),
    ("piecewise_decay", ([2, 8], [0.5, 0.1, 0.01]), {}),
    ("noam_decay", (512, 4000), {}),
    ("cosine_decay", (0.5, 10, 5), {}),
]


@pytest.mark.parametrize("name,args,kwargs", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_reference(name, args, kwargs):
    ours = getattr(layers, name)(*args, **kwargs)
    assert getattr(learning_rate_decay, name) is getattr(layers, name)
    ref = getattr(ref_layers, name)(*args, **kwargs)
    for step in (0, 1, 7, 100):
        assert ours(step) == ref(step), (name, step)
