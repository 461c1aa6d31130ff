"""paddle_tpu_torch's Trainer runs the behaviours of tests/test_trainer.py
and trains as paddle_tpu's Trainer does, on the CPU.

- The nine behaviours of tests/test_trainer.py on the port: events and
  convergence, test() leaves the parameters and the step counter,
  checkpoint resume, DataFeeder's dense, ragged and truncated columns,
  feed-order tuples, steps_per_dispatch with its stride-crossing
  checkpoint and its short tail.
- Where the program trains, the JAX package's Trainer runs over the same
  reader from the same weights (carried with ``load_param_arrays``):
  costs within rtol 1e-5, final parameters within atol 1e-5 (measured
  gaps: costs <= 4.9e-7 relative, parameters <= 3.2e-7).
- Checkpoints: one written by paddle_tpu resumes in the port's Trainer
  and the other way round, with equal step, step counter and
  parameters; a checkpoint whose payload fails its md5 is skipped; a
  ``checkpoint.write`` fault is retried under a RetryPolicy.
- A dropout program stopped after 4 batches, checkpointed and resumed in
  a fresh scope and executor ends bit for bit where the uninterrupted
  run ends: the step counter lives in the scope and the checkpoint, and
  seeds every dropout mask.
"""
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu import layers as ref_layers
from paddle_tpu import trainer as ref_trainer
from paddle_tpu_torch import framework, layers
from paddle_tpu_torch.core.executor import STEP_VAR
from paddle_tpu_torch.core.lod import RaggedPair
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.distributed import checkpoint
from paddle_tpu_torch.resilience import FaultInjector, RetryPolicy
from paddle_tpu_torch.trainer import (BeginPass, CheckpointConfig,
                                      EndIteration, EndPass, Trainer)

COST_RTOL = 1e-5
PARAM_ATOL = 1e-5

_BACKWARDS = [importlib.import_module(f"{pkg}.core.backward")
              for pkg in ("paddle_tpu", "paddle_tpu_torch")]
PKGS = {"ref": (pt, ref_layers, ref_framework),
        "port": (ptt, layers, framework)}


@pytest.fixture(autouse=True)
def fresh_port_programs():
    """The port's default programs and global scope, fresh for each test
    (conftest resets the JAX package's)."""
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


def _regression(pkg, lay, lr=0.05, width=8, bias=False, dropout=None):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [width], dtype="float32")
        y = lay.data("y", [1], dtype="float32")
        h = x
        if dropout is not None:
            h = lay.dropout(lay.fc(x, size=16), dropout_prob=dropout,
                            seed=3)
        pred = lay.fc(h, size=1, bias_attr=None if bias else False)
        loss = lay.mean(lay.square_error_cost(pred, y))
        pkg.optimizer.SGDOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, loss


def _both(builder, **kw):
    """{"ref"/"port": builder's (main, startup, loss)} with equal var
    names: both builds start the name and snapshot counts from 0."""
    saved = [m._SNAP_COUNTER[0] for m in _BACKWARDS]
    out = {}
    try:
        for who, (pkg, lay, fw) in PKGS.items():
            for m in _BACKWARDS:
                m._SNAP_COUNTER[0] = 0
            with fw.isolated_name_scope():
                out[who] = builder(pkg, lay, **kw)
    finally:
        for m, n in zip(_BACKWARDS, saved):
            m._SNAP_COUNTER[0] = n
    return out


def _reader(n_batches=8, bs=16, seed=0):
    W = np.random.RandomState(seed).randn(8, 1).astype(np.float32)

    def read():
        r = np.random.RandomState(seed + 1)
        for _ in range(n_batches):
            x = r.randn(bs, 8).astype(np.float32)
            yield {"x": x, "y": x @ W}
    return read


def _port_trainer(main, startup, loss, **kw):
    return Trainer(loss, main_program=main, startup_program=startup,
                   executor=ptt.Executor("cpu"), **kw)


def _port_params(main):
    scope = ptt.global_scope()
    return {p.name: scope.get(p.name).numpy().copy()
            for p in main.all_parameters()}


def _ref_params(main):
    return {p.name: np.asarray(pt.global_scope().get(p.name))
            for p in main.all_parameters()}


def _init_of(built):
    """The JAX package's startup values of `built`, as numpy arrays."""
    scope = pt.Scope()
    pt.Executor().run(built["ref"][1], scope=scope)
    return {n: np.asarray(scope.get(n)) for n in scope.local_names()}


def _train_both(built, reader, passes=1, feed_order=None, **train_kw):
    """The JAX and the port Trainer over `reader` from the JAX startup
    values: {who: (EndIteration costs, EndPass mean costs, final
    params, trainer)}."""
    out = {}
    init = _init_of(built)
    for who in ("ref", "port"):
        main, startup, loss = built[who]
        if who == "ref":
            t = ref_trainer.Trainer(loss, main_program=main,
                                    startup_program=startup,
                                    feed_order=feed_order)
        else:
            t = _port_trainer(main, startup, loss, feed_order=feed_order)
        t.start()
        if who == "ref":
            for n, v in init.items():
                pt.global_scope().set(n, jnp.asarray(v))
        else:
            ptt.load_param_arrays(ptt.global_scope(), init)
        costs, means = [], []

        def handler(e):
            if type(e).__name__ == "EndIteration":
                costs.append(e.cost)
            elif type(e).__name__ == "EndPass":
                means.append(e.metrics["mean_cost"])
        t.train(num_passes=passes, reader=reader, event_handler=handler,
                **train_kw)
        params = _ref_params(main) if who == "ref" else _port_params(main)
        out[who] = (costs, means, params, t)
    return out


def _hold_against_ref(out):
    (rc, rm, rp, _), (pc, pm, pp, _) = out["ref"], out["port"]
    np.testing.assert_allclose(pc, rc, rtol=COST_RTOL)
    np.testing.assert_allclose(pm, rm, rtol=COST_RTOL)
    for n in rp:
        np.testing.assert_allclose(pp[n], rp[n], rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)


# -- the behaviours of tests/test_trainer.py ---------------------------------

def test_trainer_events_and_convergence():
    out = _train_both(_both(_regression), _reader(), passes=3)
    _hold_against_ref(out)
    costs, means, _, t = out["port"]
    assert len(costs) == 24 and len(means) == 3
    assert means[-1] < means[0] * 0.5
    assert all(isinstance(c, float) for c in costs)
    assert t.step == 24
    events = []
    t.train(num_passes=1, reader=_reader(n_batches=2),
            event_handler=events.append)
    kinds = [type(e).__name__ for e in events]
    assert kinds == ["BeginPass", "BeginIteration", "EndIteration",
                     "BeginIteration", "EndIteration", "EndPass"]
    assert isinstance(events[0], BeginPass)
    assert isinstance(events[-1], EndPass)


def test_trainer_test_does_not_update_params():
    main, startup, loss = _both(_regression)["port"]
    t = _port_trainer(main, startup, loss)
    t.start()
    before = _port_params(main)
    res = t.test(_reader(n_batches=3))
    after = _port_params(main)
    for n in before:
        np.testing.assert_array_equal(before[n], after[n])
    assert np.isfinite(res[loss.name])


def test_trainer_checkpoint_resume(tmp_path):
    main, startup, loss = _both(_regression)["port"]
    d = str(tmp_path / "ck")
    t = _port_trainer(main, startup, loss,
                      checkpoint_config=CheckpointConfig(d,
                                                         every_n_batches=4))
    t.train(num_passes=2, reader=_reader())
    assert t.step == 16
    saved = sorted(x for x in os.listdir(d) if x.startswith("checkpoint_"))
    assert saved == ["checkpoint_12", "checkpoint_16", "checkpoint_8"]
    trained = _port_params(main)
    counter = int(ptt.global_scope().find(STEP_VAR))

    # fresh scope; resume restores step, step counter and params
    ptt.reset_global_scope()
    t2 = _port_trainer(main, startup, loss,
                       checkpoint_config=CheckpointConfig(d,
                                                          every_n_batches=4))
    t2.start(resume=True)
    assert t2.step == 16
    assert int(ptt.global_scope().find(STEP_VAR)) == counter == 17
    for n, v in _port_params(main).items():
        np.testing.assert_array_equal(v, trained[n])


def test_data_feeder_dense_and_ragged():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        words = layers.data("words", [1], dtype="int64", lod_level=1)
        label = layers.data("label", [1], dtype="int64")
    feeder = DataFeeder([words, label], pad_multiple=8)
    batch = [([1, 2, 3], 0), ([4, 5], 1), ([6, 7, 8, 9, 10], 0)]
    feed = feeder.feed(batch)
    w = feed["words"]
    assert isinstance(w, RaggedPair)
    assert w.data.shape == (3, 8, 1)          # padded to multiple of 8
    np.testing.assert_array_equal(np.asarray(w.lengths), [3, 2, 5])
    np.testing.assert_array_equal(np.asarray(w.data[0, :3, 0]), [1, 2, 3])
    assert feed["label"].shape == (3, 1)
    # the JAX package's feeder gives the same arrays
    rmain, rstartup = pt.Program(), pt.Program()
    with pt.program_guard(rmain, rstartup):
        rwords = ref_layers.data("words", [1], dtype="int64", lod_level=1)
        rlabel = ref_layers.data("label", [1], dtype="int64")
    from paddle_tpu.data_feeder import DataFeeder as RefFeeder
    ref = RefFeeder([rwords, rlabel], pad_multiple=8).feed(batch)
    np.testing.assert_array_equal(w.data, np.asarray(ref["words"].data))
    np.testing.assert_array_equal(w.lengths,
                                  np.asarray(ref["words"].lengths))
    np.testing.assert_array_equal(feed["label"], ref["label"])


def _seq_classifier(pkg, lay):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        words = lay.data("words", [1], dtype="int64", lod_level=1)
        label = lay.data("label", [1], dtype="int64")
        emb = lay.embedding(words, size=[50, 8])
        pooled = lay.sequence_pool(emb, pool_type="sum")
        logits = lay.fc(pooled, size=2)
        loss = lay.mean(lay.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.AdamOptimizer(learning_rate=5e-2).minimize(loss)
    return main, startup, loss


def test_trainer_with_feed_order_tuples():
    def read():
        rng = np.random.RandomState(0)
        for _ in range(6):
            batch = []
            for _ in range(8):
                n = rng.randint(2, 9)
                seq = rng.randint(1, 50, n)
                batch.append((seq.tolist(), [int(seq.sum() % 2)]))
            yield batch

    out = _train_both(_both(_seq_classifier), read, passes=2,
                      feed_order=["words", "label"])
    _hold_against_ref(out)
    costs = out["port"][0]
    assert len(costs) == 12 and np.isfinite(costs).all()


def test_data_feeder_max_lens_truncates():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        words = layers.data("words", [1], dtype="int64", lod_level=1)
        nested = layers.data("nested", [1], dtype="int64", lod_level=2)
    feeder = DataFeeder([words], max_lens={"words": 4})
    feed = feeder.feed([(list(range(10)),), ([1, 2],)])
    w = feed["words"]
    assert w.data.shape == (2, 4, 1)
    np.testing.assert_array_equal(np.asarray(w.lengths), [4, 2])
    # nested columns take the same cap on their token level, and their
    # sub-sequence level buckets up to sub_pad_multiple
    n = DataFeeder([nested], max_lens={"nested": 1},
                   sub_pad_multiple=8).feed([([[1, 2], [3]],)])["nested"]
    assert n.data.shape == (1, 8, 1, 1)
    np.testing.assert_array_equal(n.sub_lengths, [2])
    np.testing.assert_array_equal(n.tok_lengths[0, :3], [1, 1, 0])


def test_trainer_test_preserves_step_counter():
    main, startup, loss = _both(_regression)["port"]
    t = _port_trainer(main, startup, loss)
    t.train(num_passes=1, reader=_reader(n_batches=4))
    scope = ptt.global_scope()
    step_before = int(scope.find(STEP_VAR))
    assert step_before == 5             # startup + 4 steps
    t.test(_reader(n_batches=5))
    assert int(scope.find(STEP_VAR)) == step_before


def _stride_model(pkg, lay):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = lay.data("x", [4], dtype="float32")
        label = lay.data("label", [1], dtype="float32")
        pred = lay.fc(x, size=1)
        loss = lay.mean(lay.square_error_cost(pred, label))
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _stride_batches(n, bs, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xv = rng.rand(bs, 4).astype(np.float32)
        out.append({"x": xv, "label": xv.sum(1, keepdims=True)})
    return out


def test_trainer_steps_per_dispatch(tmp_path):
    """K steps per dispatch advance training exactly as K single-step
    dispatches (bit for bit on the port), fire events once per dispatch
    and still hit stride-crossed checkpoint boundaries; the JAX
    package's scan agrees."""
    batches = _stride_batches(12, 16, 0)
    built = _both(_stride_model)
    base = _train_both(built, lambda: iter(batches))
    ptt.reset_global_scope()
    main, startup, loss = built["port"]
    d = str(tmp_path / "ck")
    tr = _port_trainer(main, startup, loss,
                       checkpoint_config=CheckpointConfig(
                           d, every_n_batches=5))
    tr.start()
    ptt.load_param_arrays(ptt.global_scope(), _init_of(built))
    events = []
    tr.train(1, lambda: iter(batches),
             event_handler=lambda e: events.append(e)
             if isinstance(e, EndIteration) else None,
             steps_per_dispatch=4)
    assert len(events) == 3               # one event per dispatch
    assert tr.step == 12                  # every batch consumed once
    assert sorted(os.listdir(d)) == ["checkpoint_12", "checkpoint_8"]
    port_costs = base["port"][0]
    for i, ev in enumerate(events):
        assert ev.cost == port_costs[(i + 1) * 4 - 1]
    for n, v in _port_params(main).items():
        np.testing.assert_array_equal(v, base["port"][2][n], err_msg=n)
    _hold_against_ref(base)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        tr.train(1, lambda: iter(batches), steps_per_dispatch=0)


def test_trainer_steps_per_dispatch_tail():
    """A pass whose batch count is not a multiple of K runs the tail
    batches one at a time — nothing dropped, nothing repeated."""
    batches = _stride_batches(7, 8, 1)      # 7 = 4 + tail of 3
    built = _both(_stride_model)
    out = _train_both(built, lambda: iter(batches), steps_per_dispatch=4)
    _hold_against_ref(out)
    costs, _, params, tr = out["port"]
    assert tr.step == 7
    assert len(costs) == 2                # full dispatch + tail
    ptt.reset_global_scope()
    main, startup, loss = built["port"]
    single = _port_trainer(main, startup, loss)
    single.start()
    ptt.load_param_arrays(ptt.global_scope(), _init_of(built))
    single.train(1, lambda: iter(batches))
    for n, v in _port_params(main).items():
        np.testing.assert_array_equal(v, params[n], err_msg=n)


# -- checkpoints across the two packages ------------------------------------

def test_checkpoint_written_by_jax_package_resumes_in_port(tmp_path):
    d = str(tmp_path / "ck")
    built = _both(_regression)
    main, startup, loss = built["ref"]
    ref = ref_trainer.Trainer(loss, main_program=main,
                              startup_program=startup,
                              checkpoint_config=ref_trainer.CheckpointConfig(
                                  d, every_n_batches=4))
    ref.train(num_passes=1, reader=_reader(n_batches=4))
    want = _ref_params(main)
    counter = int(np.asarray(pt.global_scope().find(STEP_VAR)))
    main, startup, loss = built["port"]
    t = _port_trainer(main, startup, loss,
                      checkpoint_config=CheckpointConfig(d,
                                                         every_n_batches=4))
    t.start(resume=True)
    assert t.step == 4 and counter == 5
    assert int(ptt.global_scope().find(STEP_VAR)) == counter
    for n, v in _port_params(main).items():
        np.testing.assert_array_equal(v, want[n], err_msg=n)


def test_checkpoint_written_by_port_resumes_in_jax_package(tmp_path):
    d = str(tmp_path / "ck")
    built = _both(_regression)
    main, startup, loss = built["port"]
    t = _port_trainer(main, startup, loss,
                      checkpoint_config=CheckpointConfig(d,
                                                         every_n_batches=4))
    t.train(num_passes=1, reader=_reader(n_batches=4))
    want = _port_params(main)
    main, startup, loss = built["ref"]
    ref = ref_trainer.Trainer(loss, main_program=main,
                              startup_program=startup,
                              checkpoint_config=ref_trainer.CheckpointConfig(
                                  d, every_n_batches=4))
    ref.start(resume=True)
    assert ref.step == 4
    assert int(np.asarray(pt.global_scope().find(STEP_VAR))) == 5
    for n, v in _ref_params(main).items():
        np.testing.assert_array_equal(v, want[n], err_msg=n)


def test_checkpoint_with_corrupt_payload_is_skipped(tmp_path):
    d = str(tmp_path / "ck")
    main, startup, loss = _both(_regression)["port"]
    t = _port_trainer(main, startup, loss,
                      checkpoint_config=CheckpointConfig(d,
                                                         every_n_batches=4))
    t.train(num_passes=1, reader=_reader(n_batches=4))
    at_4 = _port_params(main)
    t.train(num_passes=1, reader=_reader(n_batches=4, seed=5))
    payload = os.path.join(d, "checkpoint_8", "__params__.npz")
    with open(payload, "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\0" * 8)
    path, meta = checkpoint.latest_checkpoint(d)
    assert path.endswith("checkpoint_4") and meta["step"] == 4
    ptt.reset_global_scope()
    t2 = _port_trainer(main, startup, loss,
                       checkpoint_config=CheckpointConfig(d,
                                                          every_n_batches=4))
    t2.start(resume=True)
    assert t2.step == 4
    for n, v in _port_params(main).items():
        np.testing.assert_array_equal(v, at_4[n], err_msg=n)


def test_checkpoint_write_fault_is_retried(tmp_path):
    main, startup, loss = _both(_regression)["port"]
    retry = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0,
                        sleep=lambda s: None)
    ok = str(tmp_path / "retried")
    failing = str(tmp_path / "failing")
    with FaultInjector(seed=0) as fi:
        fi.on("checkpoint.write", raises=OSError, times=2)
        t = _port_trainer(main, startup, loss, checkpoint_config=(
            CheckpointConfig(ok, every_n_batches=4, retry=retry)))
        t.train(num_passes=1, reader=_reader(n_batches=4))
        assert fi.triggered("checkpoint.write") == 2
        assert fi.calls("checkpoint.write") == 3
    assert t.checkpoint_failures == 0
    assert os.listdir(ok) == ["checkpoint_4"]
    # without a retry policy the save fails once, warns and training
    # goes on; on_error="raise" raises it
    for on_error in ("warn", "raise"):
        ptt.reset_global_scope()
        with FaultInjector(seed=0) as fi:
            fi.on("checkpoint.write", raises=OSError, times=1)
            t = _port_trainer(main, startup, loss, checkpoint_config=(
                CheckpointConfig(failing, every_n_batches=4,
                                 on_error=on_error)))
            if on_error == "warn":
                with pytest.warns(RuntimeWarning, match="step 4 failed"):
                    t.train(num_passes=1, reader=_reader(n_batches=6))
                assert t.checkpoint_failures == 1 and t.step == 6
            else:
                with pytest.raises(OSError, match="injected fault"):
                    t.train(num_passes=1, reader=_reader(n_batches=6))
        assert not os.path.exists(os.path.join(failing, "checkpoint_4"))


def test_dropout_run_resumed_from_checkpoint_is_bitwise_uninterrupted(
        tmp_path):
    """The dropout masks of batches 5-8 come from the step counter: a run
    stopped after batch 4 and resumed in a fresh scope and executor must
    draw the uninterrupted run's masks and end at its parameters."""
    main, startup, loss = _both(_regression, dropout=0.5)["port"]
    reader8 = _reader(n_batches=8)
    first4 = lambda: (b for i, b in enumerate(reader8()) if i < 4)  # noqa
    last4 = lambda: (b for i, b in enumerate(reader8()) if i >= 4)  # noqa
    whole = _port_trainer(main, startup, loss)
    whole.train(num_passes=1, reader=reader8)
    want = _port_params(main)
    want_counter = int(ptt.global_scope().find(STEP_VAR))

    d = str(tmp_path / "ck")
    ptt.reset_global_scope()
    part = _port_trainer(main, startup, loss,
                         checkpoint_config=CheckpointConfig(
                             d, every_n_batches=4))
    part.train(num_passes=1, reader=first4)
    ptt.reset_global_scope()
    resumed = _port_trainer(main, startup, loss,
                            checkpoint_config=CheckpointConfig(
                                d, every_n_batches=4))
    resumed.start(resume=True)
    resumed.train(num_passes=1, reader=last4)
    assert resumed.step == 8
    assert int(ptt.global_scope().find(STEP_VAR)) == want_counter == 9
    for n, v in _port_params(main).items():
        np.testing.assert_array_equal(v, want[n], err_msg=n)
    # the masks do depend on the step: a resume whose counter restarts
    # from the startup run's ends elsewhere
    ptt.reset_global_scope()
    restarted = _port_trainer(main, startup, loss)
    restarted.start()
    ptt.io.load_persistables(restarted.exe, os.path.join(d, "checkpoint_4"),
                             main)
    restarted.train(num_passes=1, reader=last4)
    assert any(not np.array_equal(v, want[n])
               for n, v in _port_params(main).items())
