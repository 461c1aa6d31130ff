"""Ragged values, sequence_pool and the lstm op of paddle_tpu_torch
against paddle_tpu, each as a small program run in both executors.

- LoDTensor and RaggedPair feeds come back from a fetch as the same
  LoDTensor; a non-ragged-aware op between them re-wraps its output with
  the input's lengths (core/registry.py run_op), and an output whose
  leading dims differ stays dense.
- sequence_pool, all six pool types, forward and the ragged input's
  gradient (through the __vjp__ op, which re-wraps the leaf with its
  lengths), over a batch with a zero-length row.
- lstm on both of each package's routes: the JAX scan and interpreted
  Pallas kernel (``__pallas__="force"``) against the port's fused-LSTM
  plain twin (``"force"``) and its scan (``"0"``), with is_reverse and
  H0/C0; peepholes on the scan route.
- A stamp that the knob overrides (ROADMAP C4): an lstm op stamped "0"
  takes the kernel route under PADDLE_TPU_PALLAS_LSTM=force in both
  packages (both executors re-stamp it), the scan under "0", and the
  scan under the default "1" on the CPU (the kernel needs a TPU in the
  reference, a CUDA card in the port).
- The zero-length-row discrepancy of the reference: on the kernel route
  a zero-length row's LastH cotangent does not reach H0 (the kernel
  zeroes dh where the row is not alive), on the scan route it passes
  through unchanged. The port mirrors each route; both are pinned here.

Every program is also built by both packages' builders and must
serialize to equal JSON (build-time shape inference with ragged inputs).
Tolerance: float32, the same sums in another order: atol 1e-5.
"""
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
from paddle_tpu.core import registry as ref_registry
from paddle_tpu.core.backward import append_backward as ref_append_backward
from paddle_tpu.core.ir import OpDesc as RefOpDesc
from paddle_tpu_torch import framework
from paddle_tpu_torch.core import lod, registry
from paddle_tpu_torch.core.backward import append_backward
from paddle_tpu_torch.core.ir import OpDesc

ATOL = 1e-5
REF = (pt, ref_framework, ref_lod, ref_append_backward)
PORT = (ptt, framework, lod, append_backward)


def _program(pkg, vars_, ops, loss=None, wrt=()):
    """A program of `ops` [(type, inputs, outputs, attrs)] over `vars_`
    {name: (shape, dtype, lod_level, stop_gradient)}; with `loss`, the
    backward of reduce_sum(loss) w.r.t. the names in `wrt`."""
    _, fw, _, backward = pkg
    main = fw.Program()
    with fw.isolated_name_scope():
        blk = main.global_block()
        for name, (shape, dtype, lod_level, stop) in vars_.items():
            blk.create_var(name=name, shape=shape, dtype=dtype,
                           lod_level=lod_level, stop_gradient=stop)
        for op_type, ins, outs, attrs in ops:
            for names in outs.values():
                for n in names:
                    if not blk.has_var(n):
                        blk.create_var(name=n, dtype=None)
            blk.append_op(op_type, ins, outs, dict(attrs))
        if loss is not None:
            total = blk.create_var(name="total", dtype=None)
            blk.append_op("reduce_sum", {"X": [loss]}, {"Out": ["total"]},
                          {"dim": None, "keep_dim": False,
                           "reduce_all": True})
            backward(total, parameter_list=list(wrt))
    return main


def _run(pkg, main, feed, fetch, ref_route="0"):
    """Run `main` once in a fresh scope with PADDLE_TPU_PALLAS_LSTM set to
    `ref_route`: each package's executor re-stamps every lstm op (and
    fwd_op copy) from that knob before it runs the program."""
    mod, _, lod_mod, _ = pkg
    exe = mod.Executor() if mod is pt else mod.Executor(place="cpu")
    feed = {k: (lod_mod.LoDTensor.from_sequences(v) if isinstance(v, list)
                else v) for k, v in feed.items()}
    with mock.patch.dict(os.environ, {"PADDLE_TPU_PALLAS_LSTM": ref_route}):
        return exe.run(main, feed=feed, fetch_list=fetch,
                       scope=mod.Scope())


def _host(v):
    """(data, lod) of a fetched LoDTensor, or (array, None)."""
    if hasattr(v, "lod"):
        return np.asarray(v.data), v.lod
    return np.asarray(v), None


def _assert_same(got, want, what):
    (gd, gl), (wd, wl) = _host(got), _host(want)
    assert gl == wl, f"{what}: lod {gl} vs {wl}"
    assert gd.shape == wd.shape, f"{what}: {gd.shape} vs {wd.shape}"
    np.testing.assert_allclose(gd, wd, rtol=0, atol=ATOL, err_msg=what)


def _json_equal(ref_main, port_main):
    assert json.loads(ref_main.desc.to_json()) == \
        json.loads(port_main.desc.to_json())


def _seqs(lengths, feat, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, feat).astype(np.float32) for n in lengths]


# -- feed, fetch and the re-wrap rule ---------------------------------------

@pytest.mark.parametrize("kind", ["lodtensor", "raggedpair"])
def test_ragged_feed_fetch_round_trip(kind):
    """A ragged feed, and scale of it (not ragged-aware: re-wrapped), come
    back as LoDTensors with the feed's LoD, in both packages."""
    vars_ = {"x": ([-1, 3], "float32", 1, True)}
    ops = [("scale", {"X": ["x"]}, {"Out": ["y"]},
            {"scale": 2.0, "bias": 0.5, "bias_after_scale": True})]
    seqs = _seqs([3, 1, 0, 4], 3, seed=0)
    results = []
    for pkg in (REF, PORT):
        main = _program(pkg, vars_, ops)
        if kind == "lodtensor":
            feed = {"x": seqs}
        else:
            padded, lengths = pkg[2].LoDTensor.from_sequences(
                seqs).to_padded()
            feed = {"x": pkg[2].RaggedPair(padded, lengths)}
        results.append((main, _run(pkg, main, feed, ["x", "y"])))
    (rmain, (rx, ry)), (pmain, (px, py)) = results
    _json_equal(rmain, pmain)
    want = lod.LoDTensor.from_sequences(seqs)
    _assert_same(px, want, "x round trip")
    _assert_same(py, lod.LoDTensor(2.0 * want.data + 0.5, want.lod), "y")
    _assert_same(px, rx, "x vs paddle_tpu")
    _assert_same(py, ry, "y vs paddle_tpu")


def test_rewrap_rule_matches_reference():
    """run_op of non-ragged-aware ops on a ragged input: an output with
    the input's (batch, time) dims comes back ragged with its lengths,
    any other stays dense — in both packages alike."""
    rng = np.random.RandomState(1)
    data = rng.randn(3, 5, 4).astype(np.float32)
    lengths = np.asarray([5, 2, 0], np.int32)
    w = rng.randn(4, 6).astype(np.float32)
    mul = dict(type="mul", inputs={"X": ["x"], "Y": ["w"]},
               outputs={"Out": ["o"]},
               attrs={"x_num_col_dims": 2, "y_num_col_dims": 1})
    red = dict(type="reduce_sum", inputs={"X": ["x"]},
               outputs={"Out": ["o"]},
               attrs={"dim": None, "keep_dim": False, "reduce_all": True})
    for spec, ragged_out in ((mul, True), (red, False)):
        ref = ref_registry.run_op(
            RefOpDesc(**spec), {"x": ref_lod.RaggedPair(jnp.asarray(data),
                                                        jnp.asarray(lengths)),
                                "w": jnp.asarray(w)})["o"]
        got = registry.run_op(
            OpDesc(**spec), {"x": lod.RaggedPair(torch.from_numpy(data),
                                                 torch.from_numpy(lengths)),
                             "w": torch.from_numpy(w)})["o"]
        assert isinstance(ref, ref_lod.RaggedPair) == ragged_out
        assert isinstance(got, lod.RaggedPair) == ragged_out
        if ragged_out:
            assert torch.equal(got.lengths, torch.from_numpy(lengths))
            ref, got = ref.data, got.data
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)


# -- sequence_pool ----------------------------------------------------------

@pytest.mark.parametrize("ptype", ["SUM", "AVERAGE", "SQRT", "MAX", "LAST",
                                   "FIRST"])
def test_sequence_pool_matches_reference(ptype):
    """Forward, and the gradient of sum(pool(x) * g) w.r.t. the ragged x
    (a LoDTensor with x's LoD), over lengths with a zero-length row."""
    vars_ = {"x": ([-1, 4], "float32", 1, False),
             "g": ([-1, 4], "float32", 0, True)}
    ops = [("sequence_pool", {"X": ["x"]}, {"Out": ["pooled"]},
            {"pooltype": ptype}),
           ("elementwise_mul", {"X": ["pooled"], "Y": ["g"]},
            {"Out": ["weighted"]}, {"axis": -1})]
    seqs = _seqs([3, 0, 5, 1], 4, seed=2)
    feed = {"x": seqs,
            "g": np.random.RandomState(3).randn(4, 4).astype(np.float32)}
    fetch = ["pooled", "x@GRAD"]
    mains = [_program(pkg, vars_, ops, loss="weighted", wrt=["x"])
             for pkg in (REF, PORT)]
    _json_equal(*mains)
    ref, got = (_run(pkg, m, feed, fetch) for pkg, m in zip((REF, PORT),
                                                             mains))
    _assert_same(got[0], ref[0], f"{ptype} pooled")
    _assert_same(got[1], ref[1], f"{ptype} x@GRAD")
    assert got[1].lod == [[0, 3, 3, 8, 9]]


# -- lstm -------------------------------------------------------------------

H = 4
LSTM_LENGTHS = [5, 2, 0, 4]


def _lstm_vars(state, peep=False):
    vars_ = {"x": ([-1, 4 * H], "float32", 1, False),
             "w": ([H, 4 * H], "float32", 0, True),
             "b": ([1, (7 if peep else 4) * H], "float32", 0, True)}
    if state:
        vars_["h0"] = ([-1, H], "float32", 0, False)
        vars_["c0"] = ([-1, H], "float32", 0, True)
    return vars_


def _lstm_feed(state, peep=False):
    rng = np.random.RandomState(4)
    feed = {"x": [s * 0.5 for s in _seqs(LSTM_LENGTHS, 4 * H, seed=5)],
            "w": rng.randn(H, 4 * H).astype(np.float32) * 0.4,
            "b": rng.randn(1, (7 if peep else 4) * H).astype(np.float32)
            * 0.2}
    if state:
        feed["h0"] = rng.randn(4, H).astype(np.float32) * 0.5
        feed["c0"] = rng.randn(4, H).astype(np.float32) * 0.5
    return feed


def _lstm_op(state, attrs):
    ins = {"Input": ["x"], "Weight": ["w"], "Bias": ["b"]}
    if state:
        ins.update(H0=["h0"], C0=["c0"])
    return ("lstm", ins, {"Hidden": ["hidden"], "Cell": ["cell"],
                          "LastH": ["last_h"], "LastC": ["last_c"]},
            attrs)


LSTM_FETCH = ["hidden", "cell", "last_h", "last_c"]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("state", [False, True])
def test_lstm_op_routes_match_reference(reverse, state):
    """Both JAX routes against both port routes (a zero-length row among
    the lengths); the unstamped programs serialize equally."""
    vars_, feed = _lstm_vars(state), _lstm_feed(state)
    out, mains = {}, {}
    for pkg, routes in ((REF, (None, "force")),
                        (PORT, (None, "force", "0"))):
        for route in routes:
            attrs = {"is_reverse": reverse}
            if route is not None:
                attrs["__pallas__"] = route
            main = _program(pkg, vars_, [_lstm_op(state, attrs)])
            mains[(pkg is PORT, route)] = main
            if pkg is REF or route is not None:
                out[route] = _run(pkg, main, feed, LSTM_FETCH,
                                  ref_route=route or "0")
    _json_equal(mains[(False, None)], mains[(True, None)])
    for ref_route in (None, "force"):
        for port_route in ("force", "0"):
            for name, g, r in zip(LSTM_FETCH, out[port_route],
                                  out[ref_route]):
                _assert_same(g, r, f"{name}: port {port_route} vs "
                             f"paddle_tpu {ref_route}")


def test_lstm_peepholes_take_scan_route():
    """use_peepholes with a [1, 7H] bias: the kernel route is ineligible
    in both packages, and the port's scan equals the reference's."""
    vars_, feed = _lstm_vars(True, peep=True), _lstm_feed(True, peep=True)
    attrs = {"is_reverse": True, "use_peepholes": True}
    ref = _run(REF, _program(REF, vars_, [_lstm_op(True, attrs)]), feed,
               LSTM_FETCH)
    for route in ("force", "0"):
        got = _run(PORT, _program(PORT, vars_, [_lstm_op(
            True, dict(attrs, __pallas__=route))]), feed, LSTM_FETCH,
            ref_route=route)
        for name, g, r in zip(LSTM_FETCH, got, ref):
            _assert_same(g, r, f"peepholes {name} (port {route})")


def test_lstm_zero_length_row_last_state_gradient():
    """d sum(LastH) / d H0 for a zero-length row: 1 on the scan routes
    (LastH is H0), 0 on the kernel routes (the reference's fused
    backward zeroes dh where the row is not alive). The port mirrors
    each route of paddle_tpu (ROADMAP Queue C)."""
    vars_, feed = _lstm_vars(True), _lstm_feed(True)
    grads = {}
    for pkg, routes in ((REF, ("0", "force")), (PORT, ("0", "force"))):
        for route in routes:
            main = _program(pkg, vars_, [_lstm_op(
                True, {"__pallas__": route})], loss="last_h", wrt=["h0"])
            grads[(pkg is PORT, route)] = np.asarray(
                _run(pkg, main, feed, ["h0@GRAD"], ref_route=route)[0])
    zero_row = LSTM_LENGTHS.index(0)
    for port_route, ref_route in (("0", "0"), ("force", "force")):
        np.testing.assert_allclose(grads[(True, port_route)],
                                   grads[(False, ref_route)], rtol=0,
                                   atol=ATOL)
    np.testing.assert_array_equal(grads[(True, "0")][zero_row],
                                  np.ones(H, np.float32))
    np.testing.assert_array_equal(grads[(True, "force")][zero_row],
                                  np.zeros(H, np.float32))
    live = [i for i, n in enumerate(LSTM_LENGTHS) if n]
    np.testing.assert_allclose(grads[(True, "force")][live],
                               grads[(True, "0")][live], rtol=0, atol=ATOL)


@pytest.mark.parametrize("knob,dh0", [("force", 0.0), ("0", 1.0),
                                      ("1", 1.0)])
def test_lstm_stamp_follows_the_knob_as_in_reference(knob, dh0):
    """ROADMAP C4: an lstm op stamped __pallas__="0" (one zero-length row)
    takes the route of PADDLE_TPU_PALLAS_LSTM in both packages, as the
    reference's kernel_dispatch rewrite decides it: "force" re-stamps it
    to the kernel route (the reference interprets its Pallas kernel, the
    port runs the plain twin), so the zero-length row's d sum(LastH) /
    d H0 is 0 (C2); "0" keeps the scan, where it is 1; the default "1"
    re-stamps it, but on the CPU both take the scan (the reference's
    kernel needs a TPU, the port's a CUDA card). The caller's program
    keeps its "0" stamp."""
    vars_, feed = _lstm_vars(True), _lstm_feed(True)
    zero_row = LSTM_LENGTHS.index(0)
    got = {}
    for pkg in (REF, PORT):
        main = _program(pkg, vars_, [_lstm_op(True, {"__pallas__": "0"})],
                        loss="last_h", wrt=["h0"])
        got[pkg is PORT] = np.asarray(
            _run(pkg, main, feed, ["h0@GRAD"], ref_route=knob)[0])
        assert [op.attrs.get("__pallas__") for op in main.desc.global_block
                .ops if op.type == "lstm"] == ["0"]
    np.testing.assert_allclose(got[True], got[False], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[True][zero_row],
                                  np.full(H, dh0, np.float32))
