"""paddle_tpu_torch's rewrite pipeline (analysis/rewrite.py) and its
wiring into the executors, the Trainer, the generation model and io,
against paddle_tpu.

- Parity: for each case of test_torch_analysis.py (built by both
  packages), ``rewrite_program(...).program.to_json()`` and the action
  counts per pass are the JAX package's; the kernel-dispatch stamps too,
  under each value of the LSTM and attention knobs.
- Loss identity: PADDLE_TPU_OPTIMIZE=0 against =1, 3 steps of each of
  the nine networks of the JAX package's gate, bit for bit, and the
  eager walk of the rewritten program bit for bit against the compiled
  plan.
- The 1+1 composed NMT (S8, d16): its three attention chains outline
  into scaled_dot_product_attention ops, and 3 Adam steps match
  paddle_tpu (losses rtol 1e-4; parameters atol 1e-4 where the step-1
  gradient is not below 1e-7, the tolerances of
  tests/test_torch_training.py), compiled bit for bit against eager, and
  bit for bit against the fused build of the same weights, on the naive
  route and with PADDLE_TPU_PALLAS_SDPA=force (the flash kernels' plain
  twins on the CPU).
- Buffer reuse under the compiled plan: renamed gradients and renamed
  forward outputs pair every ``__vjp__`` op with its forward op's
  record, and each earlier value of a reused name is released at its
  last reader.
- The reference's semantics: a broken pass falls back to the program as
  built, the caller's program is never changed, the kill switches, the
  memory gate, and the Trainer, GenerationModel and
  save_inference_model raising VerificationError on a malformed program
  in both packages (the Trainer's gate on by default).
"""
import importlib
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.analysis import VerificationError, rewrite
from paddle_tpu_torch.core.executor import _VJP, _flat
from test_torch_analysis import (GATE, NETWORKS, NMT, both, network_feed,
                                 rewrite_both)

STEPS = 3
LOSS_RTOL, PARAM_ATOL, TINY_GRAD = 1e-4, 1e-4, 1e-7


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


def _arrays(values):
    return [v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for v in values]


def _train(main, startup, feed, fetch, compiled=True, arrays=None,
           params=()):
    """STEPS runs of `main` in a fresh scope on the CPU: the fetches of
    each step and the final values of `params`."""
    scope, exe = ptt.Scope(), ptt.Executor("cpu", compiled=compiled)
    exe.run(startup, scope=scope)
    if arrays is not None:
        ptt.load_param_arrays(scope, arrays)
    got = [_arrays(exe.run(main, feed=feed, fetch_list=fetch, scope=scope))
           for _ in range(STEPS)]
    return got, [scope.get(p).numpy().copy() for p in params], exe


def _bitwise(a, b):
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and np.array_equal(u, v, equal_nan=True)


# -- parity with paddle_tpu ------------------------------------------------

@pytest.mark.parametrize("name", list(NETWORKS))
def test_rewrite_matches_reference(name):
    res = rewrite_both(name)
    assert res["port"].program.to_json() == res["ref"].program.to_json()
    ref, port = res["ref"].summary(), res["port"].summary()
    assert port["passes"] == ref["passes"]
    assert port["aborted"] == ref["aborted"] == []
    assert port["changed"] == ref["changed"]
    if name == "nmt_composed":
        assert res["port"].count("fuse_attention", "outline") == 3
    if name == "se_block":
        assert res["port"].count("fuse_se", "outline") == 1


def _lstm_lm(pkg):
    lm = importlib.import_module(f"{pkg.__name__}.models.lstm_lm")
    main, startup, f = lm.build_train(vocab_size=20, emb_dim=8, hid_dim=8,
                                      num_layers=1)
    return main, startup, ["words", "targets"], [f["loss"].name]


@pytest.mark.parametrize("net, knob, value", [
    ("lstm_lm", "PADDLE_TPU_PALLAS_LSTM", "1"),
    ("lstm_lm", "PADDLE_TPU_PALLAS_LSTM", "force"),
    ("lstm_lm", "PADDLE_TPU_PALLAS_LSTM", "0"),
    ("nmt_composed", "PADDLE_TPU_PALLAS_SDPA", "force"),
    ("nmt_composed", "PADDLE_TPU_PALLAS_SDPA", "0"),
])
def test_kernel_dispatch_matches_reference(net, knob, value, monkeypatch):
    """The one copy of the dispatch decision (KernelDispatch) stamps what
    the JAX package's stamps, on the ops and the fwd_op copies."""
    monkeypatch.setenv(knob, value)
    if net == "lstm_lm":
        NETWORKS.setdefault("lstm_lm", _lstm_lm)
    res = rewrite_both(net)
    assert res["port"].program.to_json() == res["ref"].program.to_json()
    kinds = {a["kernel"] for a in res["port"].actions
             if a["pass"] == "kernel_dispatch"}
    want = {"lstm_lm": {"1": {"fused_lstm"}, "force": {"fused_lstm"},
                        "0": set()},
            "nmt_composed": {"force": {"flash_attention"},
                             "0": {"flash_attention"}}}[net][value]
    assert kinds == want


# -- loss identity ----------------------------------------------------------

@pytest.mark.parametrize("name", GATE)
def test_loss_identity(name, monkeypatch):
    main, startup, _feeds, fetches = both(name)["port"]
    feed = network_feed(name)
    params = [p.name for p in main.all_parameters()]
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", "0")
    off, off_p, exe = _train(main, startup, feed, fetches, params=params)
    assert exe.last_compiled.rewrite is None
    assert exe.last_compiled.program is main.desc
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", "1")
    on, on_p, exe = _train(main, startup, feed, fetches, params=params)
    res = exe.last_compiled.rewrite
    assert res is not None and not res.aborted
    assert (exe.last_compiled.program is main.desc) != res.changed
    assert not exe.last_compiled.replayed
    eager, eager_p, _ = _train(main, startup, feed, fetches,
                               compiled=False, params=params)
    _bitwise(off, on)
    _bitwise(on, eager)
    _bitwise([off_p], [on_p])
    _bitwise([on_p], [eager_p])


# -- the composed NMT ---------------------------------------------------------

@pytest.fixture(scope="module")
def nmt():
    """The reference's 3 Adam steps of the composed 1+1 NMT (pipeline
    on), its startup values, and the port's build."""
    built = both("nmt_composed")
    rmain, rstart, _, fetches = built["ref"]
    params = [p.name for p in rmain.all_parameters()]
    fetch = fetches + [p + "@GRAD" for p in params]
    feed = network_feed("nmt_composed")
    rscope, rexe = pt.Scope(), pt.Executor()
    rexe.run(rstart, scope=rscope)
    init = {n: np.asarray(rscope.get(n)) for n in rscope.local_names()}
    ref = [[np.asarray(v) for v in
            rexe.run(rmain, feed=feed, fetch_list=fetch, scope=rscope)]
           for _ in range(STEPS)]
    key = next(k for k in rexe._cache if k[0] == rmain.desc.uid)
    outlined = rexe._cache[key].rewrite.count("fuse_attention", "outline")
    return dict(init=init, ref=ref, fetch=fetch, feed=feed, params=params,
                outlined=outlined,
                ref_params=[np.asarray(rscope.get(p)) for p in params])


def test_composed_nmt_matches_reference(nmt):
    main, startup, _, _ = both("nmt_composed")["port"]
    got, got_p, exe = _train(main, startup, nmt["feed"], nmt["fetch"],
                             arrays=nmt["init"], params=nmt["params"])
    assert nmt["outlined"] == 3
    assert exe.last_compiled.rewrite.count("fuse_attention", "outline") == 3
    ops = [op.type for op in exe.last_compiled.program.global_block.ops]
    assert ops.count("scaled_dot_product_attention") == 3
    assert "softmax" not in ops and "matmul" not in ops
    assert not exe.last_compiled.replayed
    n_par = len(nmt["params"])
    for step in range(STEPS):
        np.testing.assert_allclose(got[step][0], nmt["ref"][step][0],
                                   rtol=LOSS_RTOL)
    grads1 = nmt["ref"][0][1:1 + n_par]
    for name, mine, theirs, g in zip(nmt["params"], got_p,
                                     nmt["ref_params"], grads1):
        keep = np.abs(g) >= TINY_GRAD
        np.testing.assert_allclose(mine[keep], theirs[keep], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    eager, eager_p, _ = _train(main, startup, nmt["feed"], nmt["fetch"],
                               compiled=False, arrays=nmt["init"],
                               params=nmt["params"])
    _bitwise(got, eager)
    _bitwise([got_p], [eager_p])


@pytest.mark.parametrize("route", ["naive", "flash"])
def test_composed_equals_fused_in_port(nmt, route, monkeypatch):
    """The outlined composed build runs the fused build's attention ops:
    the same losses and parameters, bit for bit, from the same weights."""
    if route == "flash":
        monkeypatch.setenv("PADDLE_TPU_PALLAS_SDPA", "force")
    tf = importlib.import_module("paddle_tpu_torch.models.transformer")
    with ptt.framework.isolated_name_scope():
        fmain, fstart, f = tf.build_train(**NMT)
    cmain, cstart, _, fetches = both("nmt_composed")["port"]
    runs = {}
    for arm, (main, start, fetch) in (
            ("fused", (fmain, fstart, [f["loss"].name])),
            ("composed", (cmain, cstart, fetches))):
        got, got_p, exe = _train(main, start, nmt["feed"], fetch,
                                 arrays=nmt["init"], params=nmt["params"])
        sdpa = [op for op in exe.last_compiled.program.global_block.ops
                if op.type == "scaled_dot_product_attention"]
        assert len(sdpa) == 3
        if route == "flash":
            assert all(op.attrs["use_flash"] for op in sdpa)
        runs[arm] = (got, got_p)
    _bitwise(runs["fused"][0], runs["composed"][0])
    _bitwise([runs["fused"][1]], [runs["composed"][1]])


# -- buffer reuse under the compiled plan -----------------------------------

def _mlp():
    lay = ptt.layers
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = lay.data("x", [8])
        y = lay.data("y", [1])
        h = lay.fc(x, size=8, act="relu")
        h = lay.fc(h, size=8, act="tanh")
        h = lay.fc(h, size=8, act="relu")
        loss = lay.mean(lay.square(lay.fc(h, size=1) - y))
        ptt.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    rng = np.random.RandomState(3)
    feed = {"x": rng.rand(4, 8).astype(np.float32),
            "y": rng.rand(4, 1).astype(np.float32)}
    return main, startup, feed, [loss.name]


def _check_plan(compiled, actions):
    """Every __vjp__ op reads its forward op's record, and each reused
    name's earlier value is released at its last reader, before the op
    that writes the name anew."""
    plan = compiled.plan
    assert not compiled.replayed
    ops = [op for op, _, _ in plan.steps]
    for a in actions:
        if a["action"] != "reuse":
            continue
        writer = next(j for j, op in enumerate(ops)
                      if a["into"] in op.output_names()
                      and a["into"] not in op.input_names()
                      and j > min(i for i, o in enumerate(ops)
                                  if a["into"] in o.output_names()))
        before = [j for j in range(writer) if a["into"] in plan.drops[j]]
        assert before, a
        # no step between that release and the new write reads the name
        # (a __vjp__ step that reads a record reads only its OutGrad)
        assert all(a["into"] not in (
            op.input("OutGrad") if kind == _VJP else op.input_names())
            for op, kind, _ in plan.steps[before[-1] + 1:writer]), a


def test_renamed_gradients_under_the_compiled_plan(monkeypatch):
    main, startup, feed, fetch = _mlp()
    params = [p.name for p in main.all_parameters()]
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", "0")
    off, off_p, _ = _train(main, startup, feed, fetch, params=params)
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", "1")
    on, on_p, exe = _train(main, startup, feed, fetch, params=params)
    res = exe.last_compiled.rewrite
    reused = [a for a in res.actions if a["action"] == "reuse"]
    # gradients renamed, one of them onto a dead forward activation
    assert len(reused) >= 8
    assert all(a["var"].endswith("@GRAD") for a in reused)
    assert any(not a["into"].endswith("@GRAD") for a in reused)
    _check_plan(exe.last_compiled, res.actions)
    eager, eager_p, _ = _train(main, startup, feed, fetch, compiled=False,
                               params=params)
    _bitwise(off, on)
    _bitwise(on, eager)
    _bitwise([off_p, on_p], [on_p, eager_p])


def test_renamed_forward_outputs_under_the_compiled_plan(nmt):
    """In the composed NMT buffer reuse renames outputs of forward ops
    whose __vjp__ ops read their records (layer_norm's statistics)."""
    main, startup, _, fetches = both("nmt_composed")["port"]
    _, _, exe = _train(main, startup, nmt["feed"], fetches,
                       arrays=nmt["init"])
    compiled = exe.last_compiled
    fwd_outs = {n for op in compiled.program.global_block.ops
                if op.type == "__vjp__"
                for n in _flat(op.attrs["fwd_op"]["outputs"])}
    renamed = [a for a in compiled.rewrite.actions
               if a["action"] == "reuse" and a["var"] in fwd_outs]
    assert len(renamed) >= 4
    _check_plan(compiled, compiled.rewrite.actions)


# -- the reference's semantics ------------------------------------------------

class _BreakingPass(rewrite.RewritePass):
    """Corrupts the program: a dangling input."""

    name = "deliberately_broken"

    def apply(self, program, ctx):
        root = program.blocks[ctx.block_idx]
        root.ops[0] = type(root.ops[0])(
            "elementwise_add",
            {"X": ["__no_such_var__"], "Y": ["__no_such_var__"]},
            {"Out": root.ops[0].output_names() or ["__broken_out__"]})
        return [{"action": "corrupt"}]


class _RaisingPass(rewrite.RewritePass):
    name = "raising"

    def apply(self, program, ctx):
        raise RuntimeError("pass blew up")


def test_broken_rewrite_falls_back_to_the_program_as_built(monkeypatch):
    main, startup, feed, fetch = _mlp()
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", "0")
    want, _, _ = _train(main, startup, feed, fetch)
    monkeypatch.setattr(rewrite, "default_rewrite_passes",
                        lambda: [_BreakingPass(), _RaisingPass()])
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", "1")
    got, _, exe = _train(main, startup, feed, fetch)
    _bitwise(want, got)
    assert exe.last_compiled.program is main.desc
    res = rewrite.rewrite_program(main, feed_names=["x", "y"],
                                  fetch_names=fetch)
    assert not res.changed and res.program is main.desc
    assert res.aborted == ["deliberately_broken", "raising"]

    def boom(*_a, **_k):
        raise RuntimeError("pipeline blew up")
    monkeypatch.setattr(rewrite, "rewrite_program", boom)
    got, _, exe = _train(main, startup, feed, fetch)
    _bitwise(want, got)
    assert exe.last_compiled.rewrite is None


def test_rewrite_never_mutates_the_callers_program():
    main, startup, _, fetches = both("nmt_composed")["port"]
    before = (main.desc.to_json(), main.desc.version)
    res = rewrite.rewrite_program(main, feed_names=list(network_feed(
        "nmt_composed")), fetch_names=fetches)
    assert res.changed and res.program is not main.desc
    _train(main, startup, network_feed("nmt_composed"), fetches)
    assert (main.desc.to_json(), main.desc.version) == before


def _dangling(pkg):
    """x -> fc -> elementwise_add(., an undeclared var) -> mean: a
    dangling input the pre-compile gate names."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        h = pkg.layers.fc(x, size=3)
        blk = main.global_block().desc
        blk.create_var("bad_out", shape=[-1, 3], dtype="float32")
        blk.append_op("elementwise_add", {"X": [h.name],
                                          "Y": ["__missing__"]},
                      {"Out": ["bad_out"]})
        out = pkg.layers.mean(main.global_block().var("bad_out"))
    return main, startup, out


def test_verify_kill_switch_and_the_gate(monkeypatch):
    main, startup, out = _dangling(ptt)
    feed = {"x": np.zeros((2, 4), np.float32)}
    exe = ptt.Executor("cpu")
    exe.run(startup)
    misses = exe.cache_stats["misses"]
    with pytest.raises(VerificationError, match="dangling-input"):
        exe.run(main, feed=feed, fetch_list=[out])
    assert exe.cache_stats["misses"] == misses
    rmain, rstart, rout = _dangling(pt)
    rexe = pt.Executor()
    rexe.run(rstart)
    with pytest.raises(pt.analysis.VerificationError, match="dangling"):
        rexe.run(rmain, feed=feed, fetch_list=[rout])
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "0")
    with pytest.raises(KeyError, match="__missing__"):
        exe.run(main, feed=feed, fetch_list=[out])


def test_memory_gate(monkeypatch):
    main, startup, feed, fetch = _mlp()
    exe = ptt.Executor("cpu")
    exe.run(startup)
    exe.run(main, feed=feed, fetch_list=fetch)   # no budget on the CPU
    assert exe.last_memory.peak_bytes > 256
    assert exe.last_cost.flops > 0 and "flops" in exe.cost_table()
    assert exe.cost_for(main) is exe.last_cost
    eager = ptt.Executor("cpu", compiled=False)
    eager.run(main, feed=feed, fetch_list=fetch)
    assert eager.last_cost.flops == exe.last_cost.flops
    assert eager.cost_for(main) is eager.last_cost
    assert eager.last_memory.peak_bytes == exe.last_memory.peak_bytes
    monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", "256")
    exe2 = ptt.Executor("cpu")
    with pytest.raises(VerificationError, match="hbm-oom") as err:
        exe2.run(main, feed=feed, fetch_list=fetch)
    assert "PADDLE_TPU_HBM_BYTES" in str(err.value)
    assert not exe2._cache
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "0")
    exe2.run(main, feed=feed, fetch_list=fetch)


def _uninit(pkg):
    """A trainable fc whose startup program never initializes its
    weight."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        loss = pkg.layers.mean(pkg.layers.fc(x, size=2, bias_attr=False))
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    sblk = startup.global_block().desc
    sblk.ops = [op for op in sblk.ops if "fc_0.w_0" not in
                op.output_names()] if pkg is ptt else [
        op for op in sblk.ops if not any(n.endswith(".w_0")
                                         for n in op.output_names())]
    startup.desc._bump_version()
    return main, startup, loss


@pytest.mark.parametrize("verify", [None, "1", "0"])
def test_trainer_setup_gate_is_on_by_default(verify, monkeypatch):
    """The Trainer verifies the (main, startup) pair at setup unless
    PADDLE_TPU_VERIFY=0, as the JAX Trainer does; unset means on."""
    if verify is None:
        monkeypatch.delenv("PADDLE_TPU_VERIFY", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_VERIFY", verify)
    for pkg, err, kw in ((ptt, VerificationError,
                          {"executor": ptt.Executor("cpu")}),
                         (pt, pt.analysis.VerificationError, {})):
        with pkg.framework.isolated_name_scope():
            main, startup, loss = _uninit(pkg)
        trainer_cls = importlib.import_module(
            f"{pkg.__name__}.trainer").Trainer
        trainer = trainer_cls(loss, main_program=main,
                              startup_program=startup, feed_order=["x"],
                              **kw)
        if verify == "0":
            trainer.start()
        else:
            with pytest.raises(err, match="uninit-persistable"):
                trainer.start()


def test_generation_model_and_save_gates(tmp_path):
    """GenerationModel verifies its programs at build and
    save_inference_model the frozen program, in both packages."""
    from paddle_tpu.serving.generation import GenerationModel as RefModel
    from paddle_tpu.serving.generation import GenerationSpec as RefSpec
    from paddle_tpu_torch.serving.generation import (GenerationModel,
                                                     GenerationSpec)
    kw = dict(vocab_size=16, max_seq_len=8, slots=2, prompt_buckets=[8],
              cache_buckets=[8], n_layer=1, n_head=2, d_model=8,
              d_inner=16)
    for pkg, spec, model, err in (
            ("paddle_tpu_torch", GenerationSpec(**kw), GenerationModel,
             VerificationError),
            ("paddle_tpu", RefSpec(**kw), RefModel,
             pt.analysis.VerificationError)):
        tf = importlib.import_module(f"{pkg}.models.transformer")
        programs = tf.build_decoder_lm(
            vocab_size=16, max_seq_len=8, slots=2, prompt_buckets=[8],
            cache_buckets=[8], n_layer=1, n_head=2, d_model=8, d_inner=16)
        blk = programs["decode"][8].main.desc.global_block
        blk.ops.insert(0, type(blk.ops[0])(
            "scale", {"X": ["__missing__"]}, {"Out": ["__scaled__"]}, {}))
        blk.create_var("__scaled__", shape=[1], dtype="float32")
        programs["decode"][8].main.desc._bump_version()
        args = {"device": "cpu"} if pkg == "paddle_tpu_torch" else {}
        with pytest.raises(err, match="GenerationModel load"):
            model(programs, spec, **args)
    for pkg, err in ((ptt, VerificationError),
                     (pt, pt.analysis.VerificationError)):
        with pkg.framework.isolated_name_scope():
            main, startup, out = _dangling(pkg)
        exe = pkg.Executor("cpu") if pkg is ptt else pkg.Executor()
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            exe.run(startup)
            with pytest.raises(err, match="save_inference_model"):
                pkg.io.save_inference_model(
                    os.path.join(tmp_path, pkg.__name__), ["x"], [out],
                    exe, main_program=main)


@pytest.mark.parametrize("stamp, dh0", [
    ("0", 1.0),   # the op's own stamp: the scan
    (None, 0.0),  # no stamp: the op reads the knob, the kernel route
])
def test_lstm_route_without_the_pipeline(stamp, dh0, monkeypatch):
    """The lstm op's route in both packages with the pipeline off
    (PADDLE_TPU_OPTIMIZE=0) and PADDLE_TPU_PALLAS_LSTM=force: the op's
    own stamp, else the knob (ops/sequence_ops.py kernel_route, the
    reference's pallas_dispatch); with the pipeline on the knob wins over
    the stamp (tests/test_torch_sequence.py, ROADMAP C4). A zero-length
    row's d sum(LastH) / d H0 is 0 on the kernel route, 1 on the scan
    (C2)."""
    import test_torch_sequence as seq
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", "0")
    knob = "force"
    attrs = {} if stamp is None else {"__pallas__": stamp}
    vars_, feed = seq._lstm_vars(True), seq._lstm_feed(True)
    zero_row = seq.LSTM_LENGTHS.index(0)
    got = {}
    for pkg in (seq.REF, seq.PORT):
        main = seq._program(pkg, vars_, [seq._lstm_op(True, attrs)],
                            loss="last_h", wrt=["h0"])
        got[pkg is seq.PORT] = np.asarray(
            seq._run(pkg, main, feed, ["h0@GRAD"], ref_route=knob)[0])
    np.testing.assert_allclose(got[True], got[False], rtol=0,
                               atol=seq.ATOL)
    np.testing.assert_array_equal(got[True][zero_row],
                                  np.full(seq.H, dh0, np.float32))
