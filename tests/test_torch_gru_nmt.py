"""paddle_tpu_torch trains the book's GRU encoder-decoder as paddle_tpu
does, and reloads it as an inference model.

The program is the machine-translation chapter of tests/test_book.py
(embedding -> fc(3H) -> dynamic_gru for the source and the target,
scaled_dot_product_attention(dec, enc, enc), concat, fc(V),
softmax_with_cross_entropy, sequence_pool("average"), mean; Adam at
lr 3e-3), built by both packages at dict 50, emb 8, hidden 8; the train
and startup programs serialize to equal JSON. With the JAX startup
values copied into the port's scope (``load_param_arrays``), three Adam
steps on a batch of 4 ragged sequences (source lengths 3, 5, 1, 4 and
target lengths 4, 2, 6, 3: the attention's query and key lengths
differ) give the same losses, step-1 gradients and final parameters on
every pair of routes: the JAX package's scan (``PADDLE_TPU_PALLAS_GRU=0``)
and its interpreted Pallas kernels (``force``; its executor's
kernel_dispatch rewrite re-stamps the gru ops and the ``fwd_op`` copies
from the knob when it compiles), against the port's fused-GRU plain
twins (``PADDLE_TPU_PALLAS_GRU=force``, which its executor stamps the
same way; under the default "1" a CPU tensor takes the scan) and its scan
(``__pallas__="0"`` on every gru op and ``fwd_op`` copy, knob "0").

Then the port saves its trained program with ``io.save_inference_model``;
``paddle_tpu.io.load_inference_model`` loads that directory and runs it
to the port's logits, and the port's own reload gives them bit for bit.
The other direction: paddle_tpu saves a small fc model, which its native
IR library writes as a PTIR binary ``__model__``; the port decodes it
(``io.decode_ptir``) and fetches the same values, and a truncated or
malformed file raises.

Tolerances (float32 on the CPU, sums in another order): losses rtol
1e-5; step-1 gradients atol 1e-5 * max|g| per parameter; final
parameters atol 1e-5 (three Adam steps at lr 3e-3 move a weight by at
most ~9e-3; Adam divides by sqrt(v), so a gradient within float noise
of 0 may take a step of another size, which 1e-5 still bounds at 1/300
of a step); the JAX reload's logits rtol 1e-5, atol 1e-6.
"""
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu.core.lod import LoDTensor as RefLoDTensor
from paddle_tpu.ops.pallas import fused_gru as ref_fused_gru
from paddle_tpu_torch import framework
from paddle_tpu_torch.core.executor import STEP_VAR
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.ops import sequence_ops

DICT, EMB, HID, LR = 50, 8, 8, 3e-3
SRC_LENS, TRG_LENS = (3, 5, 1, 4), (4, 2, 6, 3)
STEPS = 3
LOSS_RTOL = 1e-5
GRAD_ATOL_FRAC = 1e-5
PARAM_ATOL = 1e-5
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6


def build(pkg, fw):
    """The book chapter's program in package `pkg` (its framework `fw`):
    (main, startup, {"logits", "loss"})."""
    layers = pkg.layers
    main, startup = fw.Program(), fw.Program()
    with fw.isolated_name_scope(), fw.program_guard(main, startup):
        src = layers.data("src", [1], dtype="int64", lod_level=1)
        trg = layers.data("trg", [1], dtype="int64", lod_level=1)
        lbl = layers.data("lbl", [1], dtype="int64", lod_level=1)
        src_emb = layers.embedding(src, size=[DICT, EMB])
        enc = layers.dynamic_gru(layers.fc(src_emb, size=3 * HID), size=HID)
        trg_emb = layers.embedding(trg, size=[DICT, EMB])
        dec = layers.dynamic_gru(layers.fc(trg_emb, size=3 * HID), size=HID)
        ctx = layers.scaled_dot_product_attention(dec, enc, enc)
        both = layers.concat([dec, ctx], axis=-1)
        logits = layers.fc(both, size=DICT)
        tok_loss = layers.softmax_with_cross_entropy(logits, lbl)
        loss = layers.mean(layers.sequence_pool(tok_loss, "average"))
        pkg.optimizer.AdamOptimizer(learning_rate=LR).minimize(loss)
    return main, startup, {"logits": logits, "loss": loss}


def _sequences(lod_cls):
    rng = np.random.RandomState(0)

    def ids(lengths):
        return lod_cls.from_sequences(
            [rng.randint(1, DICT, (n, 1)).astype(np.int64)
             for n in lengths])
    return {"src": ids(SRC_LENS), "trg": ids(TRG_LENS),
            "lbl": ids(TRG_LENS)}


def _stamp(main, value):
    """__pallas__=value on every gru op and on the fwd_op copy each
    __vjp__ took at append_backward time."""
    for op in main.desc.global_block.ops:
        if op.type == "gru":
            op.attrs["__pallas__"] = value
        elif op.type == "__vjp__" and op.attrs["fwd_op"]["type"] == "gru":
            op.attrs["fwd_op"]["attrs"]["__pallas__"] = value
    main.desc._bump_version()


def _train(pkg, built, lod_cls, exe, scope, init=None):
    """STEPS Adam steps in `scope` (values from `init` when given):
    (losses, step-1 gradients, final parameters)."""
    main, startup, f = built
    exe.run(startup, scope=scope)
    if init is not None:
        ptt.load_param_arrays(scope, {n: init[n]
                                      for n in scope.local_names()})
    params = [p.name for p in main.all_parameters()]
    feed = _sequences(lod_cls)
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
def runs(tmp_path_factory):
    """Each package's programs, built once: their JSON as built, one
    training run per route (fresh scopes; the same programs, stamped for
    the second run), and the inference model the port's kernel-route run
    saved, with the logits its trained program fetches."""
    ref = build(pt, ref_framework)
    port = build(ptt, framework)
    out = {"json": [(json.loads(r.desc.to_json()),
                     json.loads(p.desc.to_json()))
                    for r, p in zip(ref[:2], port[:2])]}
    rexe = pt.Executor()
    init_scope = pt.Scope()
    rexe.run(ref[1], scope=init_scope)
    init = {n: np.asarray(init_scope.get(n))
            for n in init_scope.local_names()}
    traced = []
    kernel = ref_fused_gru.fused_gru
    for route, knob in (("ref_scan", "0"), ("ref_kernel", "force")):
        _stamp(ref[0], knob)
        with mock.patch.dict(os.environ, {"PADDLE_TPU_PALLAS_GRU": knob}), \
                mock.patch.object(ref_fused_gru, "fused_gru",
                                  lambda *a: traced.append(1) or kernel(*a)):
            out[route] = _train(pt, ref, RefLoDTensor, rexe, pt.Scope())
        out[route + "_traces"] = len(traced)
    pexe = ptt.Executor(place="cpu")
    calls = []
    fused = sequence_ops.fused_gru
    sequence_ops.fused_gru = lambda *a: calls.append(1) or fused(*a)
    try:
        kscope = ptt.Scope()
        with mock.patch.dict(os.environ, {"PADDLE_TPU_PALLAS_GRU": "force"}):
            out["port_kernel"] = _train(ptt, port, LoDTensor, pexe, kscope,
                                        init)
        out["kernel_route_calls"] = len(calls)
        # the trained program's inference model, then the logits one more
        # run of it fetches (under the default knob, as the reloads run):
        # its forward reads the saved weights, before its own Adam update
        model_dir = str(tmp_path_factory.mktemp("gru_nmt") / "model")
        with ptt.scope_guard(kscope):
            ptt.io.save_inference_model(model_dir, ["src", "trg"],
                                        [port[2]["logits"]], pexe,
                                        main_program=port[0],
                                        model_version="step-3")
        out["model_dir"] = model_dir
        (out["logits"],) = pexe.run(port[0], feed=_sequences(LoDTensor),
                                    scope=kscope,
                                    fetch_list=[port[2]["logits"]])
        calls.clear()
        _stamp(port[0], "0")
        with mock.patch.dict(os.environ, {"PADDLE_TPU_PALLAS_GRU": "0"}):
            out["port_scan"] = _train(ptt, port, LoDTensor, pexe,
                                      ptt.Scope(), init)
        out["scan_route_calls"] = len(calls)
    finally:
        sequence_ops.fused_gru = fused
    return out


PAIRS = [(r, p) for r in ("ref_scan", "ref_kernel")
         for p in ("port_kernel", "port_scan")]


def test_book_programs_json_equal(runs):
    (rmain, pmain), (rstart, pstart) = runs["json"]
    assert rmain == pmain
    assert rstart == pstart
    ops = [op["type"] for op in pmain["blocks"][0]["ops"]]
    assert ops.count("gru") == 2 and ops.count("concat") == 1
    assert ops.count("scaled_dot_product_attention") == 1
    blk = pmain["blocks"][0]
    gru = next(op for op in blk["ops"] if op["type"] == "gru")
    assert blk["vars"][gru["inputs"]["Weight"][0]]["shape"] == [HID, 3 * HID]
    assert blk["vars"][gru["inputs"]["Bias"][0]]["shape"] == [1, 3 * HID]
    for op_type, shape in (("gru", [-1, HID]),
                           ("scaled_dot_product_attention", [-1, HID]),
                           ("concat", [-1, 2 * HID])):
        op = next(o for o in blk["ops"] if o["type"] == op_type)
        slot = "Hidden" if op_type == "gru" else "Out"
        var = blk["vars"][op["outputs"][slot][0]]
        assert var["lod_level"] == 1 and var["shape"] == shape, op_type


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
    did not; the port's "force" route called FusedGRU once for each gru
    op in every step (the compiled executor runs each forward op once,
    under autograd, and its __vjp__ op reads that record: no replay), the
    "0" stamp never; the CPU run launched no CUDA kernel."""
    from paddle_tpu_torch.ops import kernels
    assert runs["ref_scan_traces"] == 0
    assert runs["ref_kernel_traces"] >= 2
    assert runs["kernel_route_calls"] == 2 * STEPS
    assert runs["scan_route_calls"] == 0
    assert kernels.launch_counts()["fused_gru_fwd"] == 0
    assert kernels.launch_counts()["fused_gru_bwd"] == 0


def _logits(v):
    return np.asarray(v.data), v.lod


def test_port_inference_model_runs_in_paddle_tpu(runs):
    """paddle_tpu.io.load_inference_model reads the port's artifact (the
    JSON form, the version sidecar) and its program computes the port's
    logits."""
    want, want_lod = _logits(runs["logits"])
    feed = _sequences(RefLoDTensor)
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor()
        prog, feeds, fetches, meta = pt.io.load_inference_model(
            runs["model_dir"], exe, return_meta=True)
        assert feeds == ["src", "trg"] and meta["model_version"] == "step-3"
        assert [op.type for op in prog.desc.global_block.ops].count(
            "adam") == 0
        (got,) = exe.run(prog, feed={k: feed[k] for k in feeds},
                         fetch_list=fetches)
    got, got_lod = _logits(got)
    assert got_lod == want_lod and got.shape == (sum(TRG_LENS), DICT)
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_port_inference_model_reloads_bitwise(runs):
    """The port's own reload, into a fresh scope and executor, fetches
    the trained program's logits bit for bit; its specs keep the LoD."""
    want, want_lod = _logits(runs["logits"])
    feed = _sequences(LoDTensor)
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(place="cpu")
        prog, feeds, fetches, meta = ptt.io.load_inference_model(
            runs["model_dir"], exe, return_meta=True)
        assert meta["feed_specs"]["src"]["lod_level"] == 1
        assert meta["model_version"] == "step-3"
        (got,) = exe.run(prog, feed={k: feed[k] for k in feeds},
                         fetch_list=fetches)
        persist = sorted(n for n, v in prog.desc.global_block.vars.items()
                         if v.persistable)
        # beside the persistables, the scope holds the step counter,
        # advanced once by the one run (as the JAX executor keeps it)
        assert sorted(n for n in ptt.global_scope().local_names()
                      if n != STEP_VAR) == persist
        assert int(ptt.global_scope().get(STEP_VAR)) == 1
        assert all(isinstance(ptt.global_scope().get(n), torch.Tensor)
                   for n in persist)
    got, got_lod = _logits(got)
    assert got_lod == want_lod
    np.testing.assert_array_equal(got, want)


def _fc_model(tmp_path):
    """A two-layer fc classifier that paddle_tpu builds, initializes and
    saves as an inference model into tmp_path: (feed, its fetches)."""
    main, startup = pt.Program(), pt.Program()
    with ref_framework.isolated_name_scope(), \
            pt.program_guard(main, startup):
        x = pt.layers.data("x", [6], dtype="float32")
        hidden = pt.layers.fc(x, size=5, act="relu")
        prob = pt.layers.fc(hidden, size=3, act="softmax")
    feed = {"x": np.random.RandomState(5).randn(4, 6).astype(np.float32)}
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor()
        exe.run(startup)
        pt.io.save_inference_model(str(tmp_path), ["x"], [hidden, prob],
                                   exe, main_program=main,
                                   model_version="v7")
        want = [np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=[hidden, prob])]
    return feed, want


def test_ptir_model_from_paddle_tpu_loads_with_equal_fetches(tmp_path):
    """The native PTIR __model__ that paddle_tpu writes (its native IR
    library builds here) loads in the port: the same feeds, fetches and
    version, and the same fetched values on one feed."""
    feed, want = _fc_model(tmp_path)
    with open(tmp_path / "__model__", "rb") as f:
        assert f.read(4) == b"PTIR", "paddle_tpu wrote no PTIR __model__"
    assert not (tmp_path / "__model__.json").exists()
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(place="cpu")
        prog, feeds, fetches, meta = ptt.io.load_inference_model(
            str(tmp_path), exe, return_meta=True)
        got = exe.run(prog, feed=feed, fetch_list=fetches)
    assert feeds == ["x"] and meta["model_version"] == "v7"
    assert meta["feed_specs"]["x"]["shape"] == [-1, 6]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


@pytest.mark.parametrize("cut,match", [
    (lambda b: b[:-3], "truncated"),
    (lambda b: b[:5] + b"\x09" + b[6:], "unknown tag 9"),
    (lambda b: b[:4] + b"\x02" + b[5:], "unsupported PTIR version 2"),
])
def test_ptir_model_truncated_or_malformed_raises(tmp_path, cut, match):
    """A PTIR __model__ cut short, with an unknown value tag or of
    another format version raises PTIRError naming the file and the
    fault."""
    _fc_model(tmp_path)
    path = tmp_path / "__model__"
    path.write_bytes(cut(path.read_bytes()))
    with pytest.raises(ptt.io.PTIRError, match=match) as err:
        ptt.io.load_inference_model(str(tmp_path),
                                    ptt.Executor(place="cpu"))
    assert str(path) in str(err.value)
