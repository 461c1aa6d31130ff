"""The gru op of paddle_tpu_torch against paddle_tpu, on both routes of
each package, and the fused-GRU plain twins against the JAX kernel.

- The op, as a small program run in both executors: the JAX scan
  (``PADDLE_TPU_PALLAS_GRU=0``) and its interpreted Pallas kernel
  (``force``) against the port's kernel route (``__pallas__="force"``:
  the fused-GRU plain twins on CPU tensors) and its scan (``"0"``), each
  run under the knob of its route (both executors stamp the knob onto
  the op before a run). Hidden, LastH and the gradients of x (ragged),
  Weight, Bias and H0 under a loss that weights both outputs with
  random cotangents; with and
  without is_reverse and H0, over lengths with a zero-length and a
  full-length row. The unstamped programs serialize to equal JSON.
- A zero-length row's LastH is its H0, and d sum(LastH) / d H0 is 1 for
  it on all four routes (its LastH cotangent is 1 in the feed; the GRU's
  fused backward passes the last-state cotangent of such a row straight
  to dH0, unlike the LSTM's).
- Other activations take the scan route in both packages.
- The plain twins (``fused_gru_fwd_plain``/``_bwd_plain``) against
  ``paddle_tpu.ops.pallas.fused_gru.fused_gru`` interpreted, under
  ``jax.vjp``, with an h0 and both output cotangents.

Tolerance: float32, the same sums in another order: rtol 1e-5,
atol 1e-6.
"""
import importlib
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu.core import lod as ref_lod
from paddle_tpu.core.backward import append_backward as ref_append_backward
from paddle_tpu_torch import framework
from paddle_tpu_torch.core import lod
from paddle_tpu_torch.core.backward import append_backward
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import fused_gru as fg

RTOL, ATOL = 1e-5, 1e-6
REF = (pt, ref_framework, ref_lod, ref_append_backward)
PORT = (ptt, framework, lod, append_backward)

H = 4
LENGTHS = [5, 2, 0, 5, 3]   # a zero-length row and two full-length rows


def _program(pkg, state, attrs, wrt):
    """x -> gru -> loss = sum(Hidden * gh) + sum(LastH * gl), and its
    backward w.r.t. `wrt`."""
    _, fw, _, backward = pkg
    main = fw.Program()
    with fw.isolated_name_scope():
        blk = main.global_block()
        vars_ = {"x": ([-1, 3 * H], 1), "w": ([H, 3 * H], 0),
                 "b": ([1, 3 * H], 0), "gh": ([-1, H], 1),
                 "gl": ([-1, H], 0)}
        if state:
            vars_["h0"] = ([-1, H], 0)
        for name, (shape, lod_level) in vars_.items():
            blk.create_var(name=name, shape=shape, dtype="float32",
                           lod_level=lod_level,
                           stop_gradient=name in ("gh", "gl"))
        ins = {"Input": ["x"], "Weight": ["w"], "Bias": ["b"]}
        if state:
            ins["H0"] = ["h0"]
        ops = [("gru", ins, {"Hidden": ["hidden"], "LastH": ["last_h"]},
                attrs),
               ("elementwise_mul", {"X": ["hidden"], "Y": ["gh"]},
                {"Out": ["hw"]}, {"axis": -1}),
               ("elementwise_mul", {"X": ["last_h"], "Y": ["gl"]},
                {"Out": ["lw"]}, {"axis": -1})]
        for red in ("hw", "lw"):
            ops.append(("reduce_sum", {"X": [red]}, {"Out": [red + "_s"]},
                        {"dim": None, "keep_dim": False,
                         "reduce_all": True}))
        ops.append(("elementwise_add", {"X": ["hw_s"], "Y": ["lw_s"]},
                    {"Out": ["total"]}, {"axis": -1}))
        for op_type, op_ins, outs, op_attrs in ops:
            for names in outs.values():
                for n in names:
                    if not blk.has_var(n):
                        blk.create_var(name=n, dtype=None)
            blk.append_op(op_type, op_ins, outs, dict(op_attrs))
        backward(blk.var("total"), parameter_list=list(wrt))
    return main


def _run(pkg, main, feed, fetch, ref_route):
    """One run in a fresh scope with PADDLE_TPU_PALLAS_GRU set to
    `ref_route`: each package's executor re-stamps every gru op (and
    fwd_op copy) from that knob before it runs the program."""
    mod, _, lod_mod, _ = pkg
    exe = mod.Executor() if mod is pt else mod.Executor(place="cpu")
    feed = {k: (lod_mod.LoDTensor.from_sequences(v) if isinstance(v, list)
                else v) for k, v in feed.items()}
    with mock.patch.dict(os.environ, {"PADDLE_TPU_PALLAS_GRU": ref_route}):
        return exe.run(main, feed=feed, fetch_list=fetch, scope=mod.Scope())


def _host(v):
    if hasattr(v, "lod"):
        return np.asarray(v.data), v.lod
    return np.asarray(v), None


def _assert_same(got, want, what):
    (gd, gl), (wd, wl) = _host(got), _host(want)
    assert gl == wl, f"{what}: lod {gl} vs {wl}"
    assert gd.shape == wd.shape, f"{what}: {gd.shape} vs {wd.shape}"
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL, err_msg=what)


def _feed(state):
    """Random inputs and output cotangents; the zero-length row's LastH
    cotangent is 1."""
    rng = np.random.RandomState(7)
    feed = {"x": [rng.randn(n, 3 * H).astype(np.float32) * 0.6
                  for n in LENGTHS],
            "w": rng.randn(H, 3 * H).astype(np.float32) * 0.5,
            "b": rng.randn(1, 3 * H).astype(np.float32) * 0.3,
            "gh": [rng.randn(n, H).astype(np.float32) for n in LENGTHS],
            "gl": rng.randn(len(LENGTHS), H).astype(np.float32)}
    feed["gl"][LENGTHS.index(0)] = 1.0
    if state:
        feed["h0"] = rng.randn(len(LENGTHS), H).astype(np.float32) * 0.5
    return feed


ROUTES = (("ref", "0"), ("ref", "force"), ("port", "force"), ("port", "0"))
_RUNS = {}


def _all_routes(state, attrs):
    """(fetch names, {(package, route): fetches} over ROUTES, the
    unstamped programs of both packages); each case runs once per
    module."""
    key = (state, tuple(sorted(attrs.items())))
    if key in _RUNS:
        return _RUNS[key]
    wrt = ["x", "w", "b"] + (["h0"] if state else [])
    fetch = ["hidden", "last_h"] + [n + "@GRAD" for n in wrt]
    feed = _feed(state)
    out, plain = {}, {}
    for who, route in ROUTES:
        pkg = REF if who == "ref" else PORT
        stamped = dict(attrs, __pallas__=route)
        out[(who, route)] = _run(pkg, _program(pkg, state, stamped, wrt),
                                 feed, fetch, route)
        plain[who] = _program(pkg, state, attrs, wrt)
    _RUNS[key] = fetch, out, plain
    return _RUNS[key]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("state", [False, True])
def test_gru_op_routes_match_reference(reverse, state):
    fetch, out, plain = _all_routes(state, {"is_reverse": reverse})
    assert json.loads(plain["ref"].desc.to_json()) == \
        json.loads(plain["port"].desc.to_json())
    for ref_route in ("0", "force"):
        for port_route in ("force", "0"):
            for name, g, r in zip(fetch, out[("port", port_route)],
                                  out[("ref", ref_route)]):
                _assert_same(g, r, f"{name}: port {port_route} vs "
                             f"paddle_tpu {ref_route}")
    assert kernels.launch_counts()["fused_gru_fwd"] == 0


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_zero_length_row_passes_h0_through(reverse):
    """LastH of a zero-length row is its H0, and d sum(LastH) / d H0 is 1
    there (its LastH cotangent is 1, and its Hidden is all padding) — on
    all four routes."""
    fetch, out, _ = _all_routes(True, {"is_reverse": reverse})
    h0 = _feed(True)["h0"]
    zero = LENGTHS.index(0)
    for key, vals in out.items():
        got = dict(zip(fetch, vals))
        np.testing.assert_array_equal(np.asarray(got["last_h"])[zero],
                                      h0[zero], err_msg=str(key))
        np.testing.assert_array_equal(np.asarray(got["h0@GRAD"])[zero],
                                      np.ones(H, np.float32),
                                      err_msg=str(key))


@pytest.mark.parametrize("gate,cand", [("tanh", "tanh"),
                                       ("sigmoid", "relu")])
def test_gru_other_activations_take_scan_route(gate, cand):
    """Activations other than sigmoid/tanh are ineligible for the kernel
    in both packages: the port's "force" stamp runs its scan, equal to
    the reference's."""
    attrs = {"gate_activation": gate, "activation": cand}
    calls = []
    fused = fg.FusedGRU.apply
    with mock.patch.object(fg.FusedGRU, "apply",
                           lambda *a: calls.append(1) or fused(*a)):
        fetch, out, _ = _all_routes(True, attrs)
    assert not calls
    for name, g, r in zip(fetch, out[("port", "force")],
                          out[("ref", "force")]):
        _assert_same(g, r, f"{gate}/{cand} {name}")


# -- the plain twins against the JAX kernel ---------------------------------

@pytest.mark.parametrize("t,b,h,lens", [(6, 4, 8, [6, 3, 0, 1]),
                                        (1, 3, 5, [1, 0, 1])])
def test_plain_twins_match_jax_kernel(t, b, h, lens):
    ref_fused = importlib.import_module("paddle_tpu.ops.pallas.fused_gru")
    rng = np.random.RandomState(t * 10 + h)
    x = rng.randn(t, b, 3 * h).astype(np.float32) * 0.6
    w = rng.randn(h, 3 * h).astype(np.float32) * 0.4
    h0 = rng.randn(b, h).astype(np.float32) * 0.5
    lengths = np.asarray(lens, np.int32)
    dh_all = rng.randn(t, b, h).astype(np.float32)
    dh_last = rng.randn(b, h).astype(np.float32)

    def ref_fn(x_, w_, h0_):
        return ref_fused.fused_gru(x_, w_, h0_, jnp.asarray(lengths), True)

    (r_all, r_last), vjp = jax.vjp(ref_fn, jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(h0))
    r_grads = vjp((jnp.asarray(dh_all), jnp.asarray(dh_last)))
    tx, tw, th0, tl = (torch.from_numpy(a) for a in (x, w, h0, lengths))
    p_all, p_last, gates = fg.fused_gru_fwd_plain(tx, tw, th0, tl)
    p_grads = fg.fused_gru_bwd_plain(tw, th0, tl, p_all, gates,
                                     torch.from_numpy(dh_all),
                                     torch.from_numpy(dh_last))
    for name, got, want in zip(("h_all", "h_last", "dx", "dw", "dh0"),
                               (p_all, p_last) + tuple(p_grads),
                               (r_all, r_last) + tuple(r_grads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the wrappers take the twins on CPU tensors, and FusedGRU's backward
    # is fused_gru_bwd's
    leaves = [a.clone().requires_grad_(True) for a in (tx, tw, th0)]
    outs = fg.fused_gru(*leaves, tl)
    got = torch.autograd.grad(outs, leaves, (torch.from_numpy(dh_all),
                                             torch.from_numpy(dh_last)))
    for name, g, p in zip(("dx", "dw", "dh0"), got, p_grads):
        assert torch.equal(g, p), name
