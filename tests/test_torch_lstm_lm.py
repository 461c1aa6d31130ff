"""paddle_tpu_torch trains the stacked-LSTM LM as paddle_tpu does.

Both packages build ``models.lstm_lm.build_train`` at a tiny size (2
layers, emb 16, hidden 16, vocabulary 50, SGD at lr 1.0); the train and
startup programs serialize to equal JSON. With the JAX startup values
copied into the port's scope (``load_param_arrays``), three SGD steps on
the ragged LoDTensor feeds of tests/test_models.py (lengths 5, 3, 7, 2) give
the same losses, step-1 gradients and final parameters on every pair of
routes: the JAX package's scan (its CPU default) and its interpreted
Pallas kernels (``__pallas__="force"``), against the port's fused-LSTM
plain twin (``PADDLE_TPU_PALLAS_LSTM=force``: under the default "1" a CPU
tensor takes the scan, as the reference does off a TPU) and its scan
(``__pallas__="0"`` under the knob "0"). Each stamp reaches the lstm ops
and the ``fwd_op`` copies of their ``__vjp__`` ops. Both executors
re-stamp both from PADDLE_TPU_PALLAS_LSTM before a run, so every run
sets that knob to its route as well, and the test checks that the
kernel route traced the Pallas kernel and the scan route did not.

Tolerances (float32 on the CPU, sums in another order; measured gaps in
parentheses): losses rtol 1e-5 (6.1e-8); step-1 gradients atol 1e-5 *
max|g| per parameter (3.8e-7); final parameters atol 1e-5 (8.0e-8).
SGD steps are linear in the gradient, so no sign noise enters here.
"""
import json
import os
from unittest import mock

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu.core.lod import LoDTensor as RefLoDTensor
from paddle_tpu.models import lstm_lm as ref_lstm_lm
from paddle_tpu.ops.pallas import fused_lstm as ref_fused_lstm
from paddle_tpu_torch import framework
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.models import lstm_lm
from paddle_tpu_torch.ops import sequence_ops

KW = dict(vocab_size=50, emb_dim=16, hid_dim=16, num_layers=2)
STEPS = 3
LOSS_RTOL = 1e-5
GRAD_ATOL_FRAC = 1e-5
PARAM_ATOL = 1e-5


def _sequences():
    """The feeds of tests/test_models.py test_lstm_lm_ragged_trains."""
    rng = np.random.RandomState(0)
    seqs = [rng.randint(1, 50, (n, 1)).astype(np.int64)
            for n in (5, 3, 7, 2)]
    return seqs, [np.roll(s, -1) for s in seqs]


def _stamp(main, value):
    """__pallas__=value on every lstm op and on the fwd_op copy each
    __vjp__ took at append_backward time."""
    for op in main.desc.global_block.ops:
        if op.type == "lstm":
            op.attrs["__pallas__"] = value
        elif op.type == "__vjp__" and op.attrs["fwd_op"]["type"] == "lstm":
            op.attrs["fwd_op"]["attrs"]["__pallas__"] = value
    main.desc._bump_version()


def _train(pkg, built, lod_cls, exe, init=None):
    """STEPS SGD steps in a fresh scope (values from `init` when given):
    (losses, step-1 gradients, final parameters)."""
    main, startup, f = built
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    if init is not None:
        ptt.load_param_arrays(scope, {n: init[n]
                                      for n in scope.local_names()})
    params = [p.name for p in main.all_parameters()]
    seqs, tgts = _sequences()
    feed = {"words": lod_cls.from_sequences(seqs),
            "targets": lod_cls.from_sequences(tgts)}
    fetch = [f["loss"].name] + [n + "@GRAD" for n in params]
    losses, grads = [], None
    for step in range(STEPS):
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        if step == 0:
            grads = {n: np.asarray(g) for n, g in zip(params, out[1:])}
    final = {n: np.asarray(scope.get(n)) if pkg is pt
             else scope.get(n).numpy() for n in params}
    return losses, grads, final


@pytest.fixture(scope="module")
def runs():
    """Each package's programs, built once: their JSON as built, then
    one run per route (fresh scopes; the same programs, stamped for the
    second run)."""
    with ref_framework.isolated_name_scope():
        ref = ref_lstm_lm.build_train(**KW)
    with framework.isolated_name_scope():
        port = lstm_lm.build_train(**KW)
    out = {"json": [(json.loads(r.desc.to_json()),
                     json.loads(p.desc.to_json()))
                    for r, p in zip(ref[:2], port[:2])]}
    rexe = pt.Executor()
    init_scope = pt.Scope()
    rexe.run(ref[1], scope=init_scope)
    init = {n: np.asarray(init_scope.get(n))
            for n in init_scope.local_names()}
    traced = []
    kernel = ref_fused_lstm.fused_lstm
    for route, knob in (("ref_scan", "0"), ("ref_kernel", "force")):
        if knob == "force":
            _stamp(ref[0], knob)
        with mock.patch.dict(os.environ, {"PADDLE_TPU_PALLAS_LSTM": knob}), \
                mock.patch.object(ref_fused_lstm, "fused_lstm",
                                  lambda *a: traced.append(1) or kernel(*a)):
            out[route] = _train(pt, ref, RefLoDTensor, rexe)
        out[route + "_traces"] = len(traced)
    pexe = ptt.Executor(place="cpu")
    calls = []
    fused = sequence_ops.fused_lstm
    sequence_ops.fused_lstm = lambda *a: calls.append(1) or fused(*a)
    try:
        with mock.patch.dict(os.environ,
                             {"PADDLE_TPU_PALLAS_LSTM": "force"}):
            out["port_kernel"] = _train(ptt, port, LoDTensor, pexe, init)
        out["kernel_route_calls"] = len(calls)
        _stamp(port[0], "0")
        with mock.patch.dict(os.environ, {"PADDLE_TPU_PALLAS_LSTM": "0"}):
            out["port_scan"] = _train(ptt, port, LoDTensor, pexe, init)
        out["scan_route_calls"] = len(calls) - out["kernel_route_calls"]
    finally:
        sequence_ops.fused_lstm = fused
    return out


PAIRS = [(r, p) for r in ("ref_scan", "ref_kernel")
         for p in ("port_kernel", "port_scan")]


def test_build_train_programs_json_equal(runs):
    (rmain, pmain), (rstart, pstart) = runs["json"]
    assert rmain == pmain
    assert rstart == pstart
    ops = [op["type"] for op in pmain["blocks"][0]["ops"]]
    params = [v for v in pmain["blocks"][0]["vars"].values()
              if v["is_parameter"]]
    # embedding; per layer fc w, b and lstm w, b; the output fc w, b
    assert len(params) == 11
    assert ops.count("lstm") == 2 and ops.count("sgd") == len(params)
    lstm = next(op for op in pmain["blocks"][0]["ops"]
                if op["type"] == "lstm")
    hidden = pmain["blocks"][0]["vars"][lstm["outputs"]["Hidden"][0]]
    assert hidden["lod_level"] == 1 and hidden["shape"] == [-1, 16]


@pytest.mark.parametrize("ref,port", PAIRS)
def test_train_losses_match(runs, ref, port):
    r, p = np.asarray(runs[ref][0]), np.asarray(runs[port][0])
    assert np.all(np.isfinite(p)) and p[-1] < p[0]
    np.testing.assert_allclose(p, r, rtol=LOSS_RTOL)


@pytest.mark.parametrize("ref,port", PAIRS)
def test_step1_gradients_match(runs, ref, port):
    for name, r in runs[ref][1].items():
        np.testing.assert_allclose(
            runs[port][1][name], r, rtol=0,
            atol=GRAD_ATOL_FRAC * float(np.abs(r).max()),
            err_msg=f"{name}@GRAD")


@pytest.mark.parametrize("ref,port", PAIRS)
def test_final_params_match(runs, ref, port):
    for name, r in runs[ref][2].items():
        np.testing.assert_allclose(runs[port][2][name], r, rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_routes_ran_as_stamped(runs):
    """The JAX kernel route traced the Pallas kernel and its scan route
    did not; the port's "force" route called FusedLSTM once for each lstm
    op in every step (the compiled executor runs each forward op once,
    under autograd, and its __vjp__ op reads that record: no replay), the
    "0" stamp never; the CPU run launched no CUDA kernel."""
    from paddle_tpu_torch.ops import kernels
    assert runs["ref_scan_traces"] == 0
    assert runs["ref_kernel_traces"] >= 2 * KW["num_layers"]
    assert runs["kernel_route_calls"] == KW["num_layers"] * STEPS
    assert runs["scan_route_calls"] == 0
    assert kernels.launch_counts()["fused_lstm_fwd"] == 0
    assert kernels.launch_counts()["fused_lstm_bwd"] == 0


def test_default_place_needs_a_card(monkeypatch):
    """Without a place the port runs on the first CUDA card; with none
    it raises instead of falling back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.Executor()
