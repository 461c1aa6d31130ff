"""paddle_tpu_torch's host pipeline, on the CPU: asynchronous dispatch
(Executor.run sync=False -> StepResult), iterations=K with stacked feeds,
the scope's step counter, the feed prefetcher, the reader decorators and
the checkpoint sync barrier. The cases of tests/test_pipeline_overlap.py
whose surface the port has, and the reader decorators against the JAX
package's.

The invariant throughout, as in the JAX package: pipelining changes
where the host waits, never what the device computes — asynchronous and
synchronous training end at bit-identical weights, and K steps in one
call equal K calls bit for bit (the JAX package's scan within rtol 1e-5;
measured: equal losses, parameters within 3.0e-8).
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu import layers as ref_layers
from paddle_tpu import reader as ref_reader
from paddle_tpu_torch import framework, layers
from paddle_tpu_torch import reader
from paddle_tpu_torch.core.executor import STEP_VAR, DeviceFeed
from paddle_tpu_torch.core.lod import LoDTensor, RaggedPair
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.executor import StepResult
from paddle_tpu_torch.reader import FeedPrefetcher
from paddle_tpu_torch.resilience import FaultInjector
from paddle_tpu_torch.trainer import CheckpointConfig, EndIteration, EndPass
from paddle_tpu_torch.trainer import Trainer

JOIN_S = 5.0


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


def _build_mlp(pkg=ptt, lay=layers, fw=framework, seed=0, in_dim=64,
               hidden=32, classes=10):
    """An MNIST-style MLP classifier, small enough for the CPU; the same
    var names on every build."""
    with fw.isolated_name_scope():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.program_guard(main, startup):
            img = lay.data("img", [in_dim])
            label = lay.data("label", [1], dtype="int64")
            h = lay.fc(img, size=hidden, act="relu")
            logits = lay.fc(h, size=classes)
            loss = lay.mean(
                lay.softmax_with_cross_entropy(logits, label))
            pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _mlp_reader(n_batches=6, bs=16, in_dim=64, classes=10, seed=7):
    def read():
        rng = np.random.RandomState(seed)
        for _ in range(n_batches):
            yield {"img": rng.rand(bs, in_dim).astype(np.float32),
                   "label": rng.randint(0, classes,
                                        (bs, 1)).astype(np.int64)}
    return read


def _params(program):
    scope = ptt.global_scope()
    return {p.name: scope.get(p.name).numpy().copy()
            for p in program.all_parameters()}


def _train_and_snapshot(passes, read, **train_kw):
    ptt.reset_global_scope()
    main, startup, loss = _build_mlp()
    t = Trainer(loss, main_program=main, startup_program=startup,
                executor=ptt.Executor("cpu"))
    t.train(num_passes=passes, reader=read, **train_kw)
    return _params(main)


# -- async dispatch and lazy fetch ------------------------------------------

def test_step_result_async_matches_sync():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = layers.data("x", [8])
        y = layers.fc(x, size=4, act="relu")
    exe = ptt.Executor("cpu")
    exe.run(startup)
    feed = {"x": np.random.RandomState(0).rand(2, 8).astype(np.float32)}
    (ref,) = exe.run(main, feed=feed, fetch_list=[y])
    res = exe.run(main, feed=feed, fetch_list=[y], sync=False)
    assert isinstance(res, StepResult)
    assert res.fetch_names == [y.name]
    assert res.block_until_ready() is res
    assert res.ready
    np.testing.assert_array_equal(res[0], ref)
    # materialization is cached, indexing/iteration agree
    assert len(res) == 1
    np.testing.assert_array_equal(list(res)[0], ref)
    assert res._raw == []
    # return_numpy=False hands out the tensors
    (t,) = exe.run(main, feed=feed, fetch_list=[y], return_numpy=False)
    np.testing.assert_array_equal(t.numpy(), ref)


def test_async_vs_sync_weights_bit_identical():
    """3 passes: the fully pipelined loop (async dispatch, lazy fetch
    every 4th dispatch, depth-2 feed prefetch) trains to BIT-IDENTICAL
    weights vs the synchronous loop."""
    read = _mlp_reader(n_batches=6)
    sync_params = _train_and_snapshot(3, read, log_every=1, prefetch=0)
    pipe_params = _train_and_snapshot(3, read, log_every=4, prefetch=2)
    assert set(sync_params) == set(pipe_params)
    for name in sync_params:
        np.testing.assert_array_equal(sync_params[name],
                                      pipe_params[name], err_msg=name)


def test_log_every_lazy_events_and_mean_cost():
    read = _mlp_reader(n_batches=8)
    main, startup, loss = _build_mlp()
    seen, passes = [], []

    def handler(e):
        if isinstance(e, EndIteration):
            seen.append((e.batch_id, e._cost is not None))
        elif isinstance(e, EndPass):
            passes.append(e.metrics["mean_cost"])

    t = Trainer(loss, main_program=main, startup_program=startup,
                executor=ptt.Executor("cpu"))
    t.train(num_passes=1, reader=read, event_handler=handler, log_every=3)
    # logged dispatches (every 3rd) carry a concrete cost; the others a
    # lazy handle the trainer did not force
    assert [m for _, m in seen] == [(i + 1) % 3 == 0 for i in range(8)]
    ptt.reset_global_scope()
    main2, startup2, loss2 = _build_mlp()
    sync_passes = []
    t2 = Trainer(loss2, main_program=main2, startup_program=startup2,
                 executor=ptt.Executor("cpu"))
    t2.train(num_passes=1, reader=read,
             event_handler=lambda e: sync_passes.append(
                 e.metrics["mean_cost"]) if isinstance(e, EndPass)
             else None)
    assert passes == sync_passes


def test_async_fetch_of_read_written_state_raises():
    main, startup, loss = _build_mlp()
    exe = ptt.Executor("cpu")
    exe.run(startup)
    w = main.all_parameters()[0].name
    feed = next(iter(_mlp_reader(n_batches=1)()))
    with pytest.raises(ValueError, match="donated state"):
        exe.run(main, feed=feed, fetch_list=[loss, w], sync=False)
    # the same fetch is fine synchronously (materialized before the next
    # step can write the state)
    outs = exe.run(main, feed=feed, fetch_list=[loss, w])
    assert np.asarray(outs[1]).shape == (64, 32)


def test_executor_synchronize_and_step_counter():
    main, startup, loss = _build_mlp()
    exe = ptt.Executor("cpu")
    exe.run(startup)
    feed = next(iter(_mlp_reader(n_batches=1)()))
    res = exe.run(main, feed=feed, fetch_list=[loss], sync=False)
    assert res.ready                      # the CPU ran it already
    assert exe.synchronize() is exe
    assert exe._inflight is None
    scope = ptt.global_scope()
    for p in main.all_parameters():
        scope.get(p.name).numpy()
    # the counter lives in the scope: a second executor continues it
    assert int(scope.find(STEP_VAR)) == 2
    ptt.Executor("cpu").run(main, feed=feed, fetch_list=[loss])
    assert int(scope.find(STEP_VAR)) == 3
    assert scope.find(STEP_VAR).dtype == torch.int32


# -- iterations=K, stacked feeds --------------------------------------------

K = 4


def _stacked_feeds():
    batches = list(_mlp_reader(n_batches=K, bs=8)())
    return batches, {n: np.stack([b[n] for b in batches])
                     for n in batches[0]}


def test_stacked_iterations_equal_single_runs_and_jax_scan():
    batches, stacked = _stacked_feeds()
    runs = {}
    for arm in ("single", "stacked"):
        ptt.reset_global_scope()
        main, startup, loss = _build_mlp()
        exe = ptt.Executor("cpu")
        exe.run(startup)
        if arm == "single":
            losses = [exe.run(main, feed=b, fetch_list=[loss])[0]
                      for b in batches]
        else:
            losses = exe.run(main, feed=stacked, fetch_list=[loss],
                             iterations=K, stacked_feed=True)
        runs[arm] = (losses[-1], _params(main),
                     int(ptt.global_scope().find(STEP_VAR)))
    # bit for bit, and the step counter advanced by K either way
    assert runs["single"][2] == runs["stacked"][2] == 1 + K
    np.testing.assert_array_equal(runs["single"][0], runs["stacked"][0])
    for n, v in runs["single"][1].items():
        np.testing.assert_array_equal(v, runs["stacked"][1][n], err_msg=n)

    # the JAX package's scan from the same weights
    rmain, rstartup, rloss = _build_mlp(pt, ref_layers, ref_framework)
    rscope, rexe = pt.Scope(), pt.Executor()
    rexe.run(rstartup, scope=rscope)
    init = {n: np.asarray(rscope.get(n)) for n in rscope.local_names()}
    ptt.reset_global_scope()
    main, startup, loss = _build_mlp()
    exe = ptt.Executor("cpu")
    exe.run(startup)
    ptt.load_param_arrays(ptt.global_scope(), init)
    (got,) = exe.run(main, feed=stacked, fetch_list=[loss], iterations=K,
                     stacked_feed=True)
    (want,) = rexe.run(rmain, feed=stacked, fetch_list=[rloss],
                       iterations=K, stacked_feed=True, scope=rscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    for p in rmain.all_parameters():
        np.testing.assert_allclose(
            ptt.global_scope().get(p.name).numpy(),
            np.asarray(rscope.get(p.name)), rtol=1e-5, atol=1e-6)
    assert int(ptt.global_scope().find(STEP_VAR)) == \
        int(np.asarray(rscope.find(STEP_VAR))) == 1 + K


@pytest.mark.parametrize("kw, feed_of, match", [
    (dict(iterations=1, stacked_feed=True), "stacked",
     "stacked_feed requires iterations > 1"),
    (dict(iterations=3, stacked_feed=True), "stacked",
     r"leading dim \(4,\) != iterations 3"),
    (dict(iterations=0), "single", "iterations must be >= 1"),
    (dict(iterations=2, stacked_feed=True), "ragged", "is not an array"),
])
def test_stacked_feed_validation(kw, feed_of, match):
    batches, stacked = _stacked_feeds()
    main, startup, loss = _build_mlp()
    exe = ptt.Executor("cpu")
    exe.run(startup)
    feed = {"stacked": stacked, "single": batches[0],
            "ragged": {"img": LoDTensor.from_sequences(
                [np.zeros((2, 1), np.float32)] * 2),
                "label": stacked["label"]}}[feed_of]
    with pytest.raises(ValueError, match=match):
        exe.run(main, feed=feed, fetch_list=[loss], **kw)


# -- feed prefetcher ---------------------------------------------------------

def test_prefetcher_basic_and_clean_shutdown():
    produced = list(range(10))
    p = FeedPrefetcher(iter(produced), convert=lambda x: x * 2, depth=2)
    assert list(p) == [x * 2 for x in produced]
    p._thread.join(JOIN_S)
    assert not p._thread.is_alive()
    p.close()  # idempotent
    with pytest.raises(StopIteration):
        next(p)
    with pytest.raises(ValueError, match="depth"):
        FeedPrefetcher(iter(()), depth=0)


@pytest.mark.parametrize("where", ["reader", "convert"])
def test_prefetcher_error_propagates_and_joins(where):
    def gen():
        yield 1
        raise ValueError("reader blew up")

    def bad_convert(b):
        raise TypeError("cannot convert")

    if where == "reader":
        p = FeedPrefetcher(gen(), depth=2)
        assert next(p) == 1
        with pytest.raises(ValueError, match="reader blew up"):
            next(p)
    else:
        p = FeedPrefetcher(iter([1, 2]), convert=bad_convert, depth=2)
        with pytest.raises(TypeError, match="cannot convert"):
            next(p)
    p._thread.join(JOIN_S)
    assert not p._thread.is_alive()


def test_prefetcher_close_unblocks_full_queue_producer():
    p = FeedPrefetcher(iter(range(10 ** 9)), depth=2)
    assert next(p) == 0
    time.sleep(0.05)     # the producer fills the queue and polls
    p.close()
    assert not p._thread.is_alive()
    with pytest.raises(StopIteration):
        next(p)


def test_prefetcher_cross_thread_close_unblocks_consumer():
    """close() from another thread wakes a consumer blocked on an empty
    queue (slow reader)."""
    release = threading.Event()

    def slow():
        yield 1
        release.wait(10)
        yield 2

    p = FeedPrefetcher(slow(), depth=2)
    assert next(p) == 1
    got = []

    def consume():
        try:
            got.append(next(p))
        except StopIteration:
            got.append("stop")

    c = threading.Thread(target=consume, daemon=True)
    c.start()
    time.sleep(0.05)  # let the consumer block in q.get()
    # the producer is parked in the slow reader: join it only briefly
    p.close(timeout=0.1)
    c.join(JOIN_S)
    release.set()
    assert not c.is_alive(), "consumer stranded after cross-thread close"
    assert got == ["stop"]
    p._thread.join(JOIN_S)
    assert not p._thread.is_alive()


def test_reader_next_fault_through_prefetcher():
    """The producer thread fires `reader.next` per pulled batch: an
    injected fault mid-pass re-raises in the training loop, the
    prefetcher shuts down, and the batches before the fault trained."""
    main, startup, loss = _build_mlp()
    t = Trainer(loss, main_program=main, startup_program=startup,
                executor=ptt.Executor("cpu"))
    with FaultInjector(seed=11) as fi:
        fi.on("reader.next", raises=RuntimeError, after=2, times=1)
        t.start()
        before = _params(main)
        with pytest.raises(RuntimeError, match="injected fault"):
            t.train(num_passes=1, reader=_mlp_reader(n_batches=8),
                    prefetch=2, log_every=4)
        assert fi.triggered("reader.next") == 1
        assert fi.calls("reader.next") >= 3
    after = _params(main)
    assert any(not np.array_equal(before[n], after[n]) for n in before)


def test_data_feeder_feed_device():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = layers.data("x", [4])
        lbl = layers.data("lbl", [1], dtype="int64")
        words = layers.data("words", [1], dtype="int64", lod_level=1)
        y = layers.fc(x, size=2)
    feeder = DataFeeder([x, lbl, words], place="cpu")
    batch = [(np.arange(4, dtype=np.float32), 1, [3, 4, 5]),
             (np.ones(4, dtype=np.float32), 0, [6])]
    dev = feeder.feed_device(batch)
    assert isinstance(dev, DeviceFeed) and dev.ready is None
    assert isinstance(dev["x"], torch.Tensor)
    assert isinstance(dev["words"], RaggedPair)
    assert dev["words"].lengths.tolist() == [3, 1]
    # the executor takes device-form feeds as they are
    exe = ptt.Executor("cpu")
    exe.run(startup)
    (out_dev,) = exe.run(main, feed=dev, fetch_list=[y])
    (out_host,) = exe.run(main, feed=feeder.feed(batch), fetch_list=[y])
    np.testing.assert_array_equal(out_dev, out_host)


# -- checkpoint barrier ------------------------------------------------------

def test_checkpoint_during_async_training_not_torn(tmp_path):
    """A checkpoint saved mid-pass under full pipelining snapshots
    exactly the post-step-4 weights: bit-identical to a synchronous run
    of the same 4 batches."""
    d = str(tmp_path / "ck")
    main, startup, loss = _build_mlp()
    t = Trainer(loss, main_program=main, startup_program=startup,
                executor=ptt.Executor("cpu"),
                checkpoint_config=CheckpointConfig(d, every_n_batches=4,
                                                   max_keep=3))
    t.train(num_passes=1, reader=_mlp_reader(n_batches=8), log_every=8,
            prefetch=2)
    ref = _train_and_snapshot(1, _mlp_reader(n_batches=4))
    ptt.reset_global_scope()
    ptt.io.load_persistables(ptt.Executor("cpu"),
                             os.path.join(d, "checkpoint_4"), main)
    got = _params(main)
    for name in ref:
        np.testing.assert_array_equal(ref[name], got[name], err_msg=name)


# -- reader decorators, against the JAX package's ---------------------------

def _samples():
    return iter(range(10))


def _pairs():
    return iter([(i, -i) for i in range(10)])


DECORATED = {
    "map_readers": lambda r: r.map_readers(lambda a, b: a * 10 + b,
                                           _samples, _samples),
    "shuffle": lambda r: r.shuffle(_samples, buf_size=4, seed=3),
    "chain": lambda r: r.chain(_samples, _samples),
    "compose": lambda r: r.compose(_samples, _pairs),
    "buffered": lambda r: r.buffered(_samples, size=3),
    "firstn": lambda r: r.firstn(_samples, 4),
    "xmap_ordered": lambda r: r.xmap_readers(lambda x: x * x, _samples,
                                             process_num=3, buffer_size=4,
                                             order=True),
    "cache": lambda r: r.cache(_samples),
    "batch": lambda r: r.batch(_samples, batch_size=4),
    "batch_drop_last": lambda r: r.batch(_samples, batch_size=4,
                                         drop_last=True),
    "double_buffer": lambda r: r.double_buffer(_samples),
}


@pytest.mark.parametrize("name", sorted(DECORATED))
def test_reader_decorator_matches_jax_package(name):
    port = DECORATED[name](reader)
    ref = DECORATED[name](ref_reader)
    got = list(port())
    assert got == list(ref())
    assert list(port()) == got            # a reader can be read again


def test_reader_unordered_xmap_and_misaligned_compose():
    got = reader.xmap_readers(lambda x: x + 1, _samples, process_num=3,
                              buffer_size=4)()
    assert sorted(got) == list(range(1, 11))
    with pytest.raises(reader.ComposeNotAligned):
        list(reader.compose(_samples, reader.firstn(_samples, 3))())


def test_device_prefetch_on_the_cpu():
    def batches():
        for i in range(3):
            yield (np.full((2, 2), i, np.float32), {"ids": np.arange(i + 1)})

    got = list(reader.device_prefetch(batches, size=2, device="cpu")())
    assert [int(b[0][0, 0]) for b in got] == [0, 1, 2]
    assert all(isinstance(b[0], torch.Tensor)
               for b in got)
    assert got[2][1]["ids"].tolist() == [0, 1, 2]
