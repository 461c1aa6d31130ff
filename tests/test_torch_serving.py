"""paddle_tpu_torch.serving (batch serving) against paddle_tpu.serving,
on the CPU.

- One artifact for both: the MLP of tests/test_serving.py:13 frozen by
  paddle_tpu.io.save_inference_model. Both packages' ServingEngines
  serve it the same requests (sizes chosen so every flush is a
  max-batch flush or the drain: the batches do not depend on timing);
  the outputs agree at rtol 1e-5 and the batch / bucket accounting, the
  compile-cache counts, the static model FLOPs and the stats() keys are
  equal.
- The dynamic batcher's flush rules (deadline, max-batch, bucket and
  seq-bucket padding, backpressure, expiry, close) run through both
  packages on one script under a virtual clock, every step compared.
- Admission control on one scripted sequence through both packages
  (queue depth, rolling p99, an injected ``serving.admission`` fault,
  the shed ledger).
- The port's engine as tests/test_serving.py holds the reference's:
  bit-identical to a direct run, one compile per bucket, padded rows,
  drain on stop, two workers, async dispatch, batch-level fetches,
  unfrozen programs refused, the breaker's trip and half-open recovery
  (virtual clock), and its profiler spans.
"""
import json
import types

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import layers as ref_layers
from paddle_tpu import serving as ref_serving
from paddle_tpu.observability.registry import MetricsRegistry as RefRegistry
from paddle_tpu.serving import admission as ref_admission
from paddle_tpu.serving import batcher as ref_batcher
from paddle_tpu.serving.metrics import ServingMetrics as RefMetrics
from paddle_tpu_torch import profiler, serving
from paddle_tpu_torch.observability.registry import MetricsRegistry
from paddle_tpu_torch.resilience import FaultInjector
from paddle_tpu_torch.resilience.health import (CircuitBreaker,
                                                CircuitOpenError,
                                                HealthMonitor)
from paddle_tpu_torch.serving import admission, batcher
from paddle_tpu_torch.serving.metrics import ServingMetrics


def _freeze(dirname, colsum=False):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 0
    with pt.program_guard(main, startup):
        x = ref_layers.data("x", [8], dtype="float32")
        h = ref_layers.fc(x, size=16, act="relu")
        pred = ref_layers.fc(h, size=4, act="softmax")
        targets = [pred]
        if colsum:
            targets.append(ref_layers.reduce_sum(pred, dim=0))
    exe = pt.Executor()
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        pt.io.save_inference_model(dirname, ["x"], targets, exe, main)
    return dirname


@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    return _freeze(str(tmp_path_factory.mktemp("serving") / "mlp"))


def _load(d):
    return serving.load(d, device="cpu")


def _keys(d):
    """The nested key structure of a stats() dict."""
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


#: the requests' row counts: [1, 2, 1] fill bucket 4, [3, 1] fill it
#: again, the last row is flushed alone by the drain into bucket 1
ROWS = [1, 2, 1, 3, 1, 1]


def _serve(mod, model, engine_kw):
    eng = model.serve(mod.BatchingConfig(
        max_batch_size=4, batch_buckets=[1, 2, 4],
        max_latency_ms=600_000.0), **engine_kw)
    eng.start(warmup=True)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(r, 8).astype(np.float32)} for r in ROWS]
    futures = [eng.submit(f) for f in feeds]
    eng.stop(drain=True, timeout=120)
    return [f.result(timeout=0)[0] for f in futures], eng.stats()


@pytest.mark.parametrize("engine_kw", [{}, {"num_workers": 2},
                                       {"async_dispatch": True}],
                         ids=["one_worker", "two_workers", "async"])
def test_engine_matches_reference_engine(mlp_dir, engine_kw, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")
    ref_out, ref_stats = _serve(ref_serving, ref_serving.load(mlp_dir),
                                engine_kw)
    port_out, port_stats = _serve(serving, _load(mlp_dir), engine_kw)
    for r, p in zip(ref_out, port_out):
        assert p.shape == r.shape
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-7)
    assert _keys(port_stats) == _keys(ref_stats)
    keys = ["requests", "rejected", "timeouts", "errors", "batches",
            "warmup_compiles", "queue_depth", "batch_rows",
            "batch_fill_ratio", "shed_by_reason", "compile_cache",
            "batch_buckets", "seq_buckets", "workers", "async_dispatch",
            "started", "stopped", "shed", "admission"]
    if engine_kw.get("num_workers", 1) == 1:
        # the static FLOPs of the last batch delivered: with two workers
        # either batch of the drain may deliver last
        keys.append("model_flops")
    for k in keys:
        assert port_stats[k] == ref_stats[k], k
    assert port_stats["batch_rows"]["count"] == 3
    assert port_stats["mfu"] > 0 and ref_stats["mfu"] > 0
    rh, ph = ref_stats["health"], port_stats["health"]
    assert ph == rh


# -- the batcher's flush rules under a virtual clock ------------------------

SPECS = {"x": {"shape": [-1, 3], "dtype": "float32", "lod_level": 0},
         "t": {"shape": [-1, -1], "dtype": "int64", "lod_level": 0}}


def _req(rows, length, fill):
    return {"x": np.full((rows, 3), fill, np.float32),
            "t": np.arange(rows * length, dtype=np.int64).reshape(
                rows, length)}


def _batcher_script(mod, metrics_cls, registry_cls, monkeypatch):
    now = [0.0]
    monkeypatch.setattr(mod, "time",
                        types.SimpleNamespace(monotonic=lambda: now[0]))
    m = metrics_cls(registry_cls())
    b = mod.DynamicBatcher(SPECS, mod.BatchingConfig(
        max_batch_size=4, batch_buckets=[1, 2, 4], seq_buckets=[4, 8],
        max_latency_ms=10.0, queue_capacity_rows=6,
        request_timeout_ms=40.0), metrics=m)
    trace, futures = [], []

    def submit(rows, length, fill):
        try:
            futures.append(b.submit(_req(rows, length, fill)))
            trace.append(("queued", b.pending_rows))
        except Exception as e:  # noqa: BLE001 — compared by type
            trace.append(("refused", type(e).__name__))

    def flush():
        batch = b.next_batch(timeout=0.0)
        if batch is None:
            trace.append(("none", b.pending_rows))
            return
        trace.append(("batch", batch.rows, batch.bucket_rows,
                      batch.slices, batch.fill_ratio,
                      {k: v.tolist() for k, v in batch.feed.items()}))

    submit(1, 3, 1.0)
    flush()                      # under the latency deadline: nothing
    now[0] = 0.011
    flush()                      # deadline flush: 1 row into bucket 1
    submit(3, 5, 2.0)
    submit(2, 2, 3.0)
    flush()                      # 5 >= 4 rows: takes 3 (3 + 2 > 4)
    submit(4, 1, 4.0)
    submit(1, 1, 5.0)            # 2 + 4 + 1 > 6: backpressure
    flush()                      # takes the 2 (2 + 4 > 4)
    flush()                      # the 4: a full bucket
    now[0] = 0.02
    submit(1, 7, 6.0)            # deadline 0.06, flush pulled to 0.03
    now[0] = 0.025
    flush()                      # before 0.03: nothing
    now[0] = 0.1
    flush()                      # past 0.06 + 0.01: expired
    submit(1, 2, 7.0)
    b.close(drain=False)         # queued -> ServingStopped
    submit(1, 2, 8.0)            # closed
    trace.append(("oldest_wait", b.oldest_wait_s))
    for f in futures:
        try:
            f.result(timeout=0)
            trace.append(("result",))
        except Exception as e:  # noqa: BLE001 — compared by type
            trace.append(("failed", type(e).__name__))
    stats = m.stats()
    for k in ("latency_s", "queue_wait_s"):
        stats.pop(k)
    return trace, stats


def test_batcher_flush_rules_match_reference(monkeypatch):
    ref = _batcher_script(ref_batcher, RefMetrics, RefRegistry,
                          monkeypatch)
    port = _batcher_script(batcher, ServingMetrics, MetricsRegistry,
                           monkeypatch)
    assert port == ref
    kinds = [t[0] for t in port[0]]
    assert kinds.count("batch") == 4 and ("refused", "QueueFullError") \
        in port[0] and ("failed", "TimeoutError") in port[0]
    assert ("failed", "ServingStopped") in port[0]


@pytest.mark.parametrize("spec", [
    {"shape": [-1, 3], "dtype": "float32", "lod_level": 1},
    {"shape": [3, 3], "dtype": "float32", "lod_level": 0}],
    ids=["lod", "no_batch_axis"])
def test_batcher_refuses_what_the_reference_refuses(spec):
    msgs = []
    for mod in (ref_batcher, batcher):
        with pytest.raises(ValueError) as e:
            mod.DynamicBatcher({"x": spec})
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


# -- admission on a scripted sequence -----------------------------------------

def _admission_script(mod, metrics_cls, registry_cls, faults,
                      monkeypatch):
    now = [0.0]
    monkeypatch.setattr(mod, "time",
                        types.SimpleNamespace(monotonic=lambda: now[0]))
    m = metrics_cls(registry_cls())
    fake = types.SimpleNamespace(pending_rows=0, oldest_wait_s=0.0)
    ctl = mod.AdmissionController(mod.AdmissionConfig(
        max_queue_rows=4, max_p99_s=0.5, p99_min_samples=4,
        p99_refresh_s=1.0, shed_storm_threshold=None), fake, m)
    trace = []

    def check():
        try:
            ctl.check()
            trace.append("admit")
        except mod.ServiceOverloadedError as e:
            trace.append(e.reason)

    check()
    fake.pending_rows = 5
    check()                           # queue depth
    fake.pending_rows = 0
    for v in (0.1, 0.9, 0.9, 0.9):
        m.latency_s.record(v)
    check()                           # p99 cached at t=0 (no samples)
    now[0] = 1.0
    check()                           # refreshed: p99 0.9 > 0.5
    for _ in range(60):
        m.latency_s.record(0.1)
    check()                           # the cached p99 still sheds
    now[0] = 3.0
    check()                           # 64 samples: rank 64 is 0.9
    m.latency_s = type(m.latency_s)(window=8)
    now[0] = 5.0
    check()                           # below the sample floor: admit
    with faults.FaultInjector(seed=0) as fi:
        fi.on("serving.admission", raises=RuntimeError, times=1)
        check()                       # an injected fault sheds
    trace.append(ctl.snapshot())
    trace.append(m.shed_by_reason())
    return trace


def test_admission_matches_reference(monkeypatch):
    from paddle_tpu.resilience import faults as ref_faults
    from paddle_tpu_torch.resilience import faults
    ref = _admission_script(ref_admission, RefMetrics, RefRegistry,
                            ref_faults, monkeypatch)
    port = _admission_script(admission, ServingMetrics, MetricsRegistry,
                             faults, monkeypatch)
    assert port == ref
    assert port[:8] == ["admit", "queue_depth", "admit", "latency_p99",
                        "latency_p99", "latency_p99", "admit", "fault"]
    assert port[-1] == {"queue_depth": 1, "latency_p99": 3, "fault": 1}


# -- the port's engine --------------------------------------------------------

def test_engine_bit_identical_to_direct_run_and_pads(mlp_dir):
    model = _load(mlp_dir)
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(4, 8).astype(np.float32)}
    (direct,) = model.run_direct(feed)
    three = {"x": feed["x"][:3]}
    (direct3,) = model.run_direct(three)
    engine = model.serve(serving.BatchingConfig(
        max_batch_size=4, batch_buckets=[4], max_latency_ms=1.0))
    (before,) = model.predict(feed)      # no engine yet: a direct run
    engine.start(warmup=False)
    try:
        (served,) = engine.predict(feed, timeout=30)
        np.testing.assert_array_equal(served, direct)
        (served2,) = model.predict(feed, timeout=30)
        np.testing.assert_array_equal(served2, direct)
        (padded,) = engine.predict(three, timeout=30)   # 3 -> 4 rows
        np.testing.assert_allclose(padded, direct3, rtol=1e-6, atol=1e-7)
    finally:
        engine.stop()
    (after,) = model.predict(feed)
    np.testing.assert_array_equal(before, after)
    cc = engine.stats()["compile_cache"]
    # the direct runs planned (4, 8) and (3, 8); every later run, the
    # engine's padded (3 -> 4) batch included, reuses the (4, 8) key
    assert cc["misses"] == 2 and cc["hits"] == 5, cc
    json.dumps(engine.stats())


def test_stop_drains_and_refuses_after(mlp_dir):
    model = _load(mlp_dir)
    engine = model.serve(serving.BatchingConfig(
        max_batch_size=8, batch_buckets=[8], max_latency_ms=60_000.0))
    engine.start(warmup=True)
    assert engine.stats()["warmup_compiles"] == 1
    assert engine.warm_captures == 0      # no card: nothing captured
    rng = np.random.RandomState(3)
    feeds = [{"x": rng.rand(1, 8).astype(np.float32)} for _ in range(3)]
    futures = [engine.submit(f) for f in feeds]
    assert not any(f.done() for f in futures)
    engine.stop(drain=True, timeout=120)
    for fut, feed in zip(futures, feeds):
        (out,) = fut.result(timeout=0)
        np.testing.assert_allclose(out, model.run_direct(feed)[0],
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(serving.ServingStopped):
        engine.submit(feeds[0])
    with pytest.raises(RuntimeError, match="already started"):
        engine.start()


def test_batch_level_fetch_delivered_whole(tmp_path):
    model = _load(_freeze(str(tmp_path / "colsum"), colsum=True))
    engine = model.serve(serving.BatchingConfig(
        max_batch_size=4, batch_buckets=[4], max_latency_ms=1.0))
    engine.start(warmup=False)
    try:
        feed = {"x": np.random.RandomState(5).rand(1, 8).astype(
            np.float32)}
        pred_out, colsum_out = engine.predict(feed, timeout=30)
    finally:
        engine.stop()
    assert pred_out.shape == (1, 4) and colsum_out.shape == (4,)


def test_unfrozen_program_rejected():
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.io import inference_model_specs
    lay = ptt.layers
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = lay.data("x", [4], dtype="float32")
        label = lay.data("label", [1], dtype="float32")
        loss = lay.mean(lay.square_error_cost(lay.fc(x, size=1), label))
        ptt.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    feed_specs, fetch_specs = inference_model_specs(
        main, ["x", "label"], [loss.name])
    with pytest.raises(ValueError, match="not frozen"):
        serving.ServableModel(main, ["x", "label"], [loss], ptt.Scope(),
                              feed_specs, fetch_specs, device="cpu")
    with pytest.raises(ValueError, match="together"):
        serving.ServableModel(main, ["x"], [loss], ptt.Scope(), {}, {},
                              run_lock=object(), device="cpu")


def test_breaker_trips_sheds_and_recovers_on_a_virtual_clock(mlp_dir):
    now = [0.0]
    health = HealthMonitor(CircuitBreaker(
        failure_threshold=2, reset_timeout_s=10.0, clock=lambda: now[0]))
    model = _load(mlp_dir)
    engine = model.serve(serving.BatchingConfig(
        max_batch_size=1, batch_buckets=[1], max_latency_ms=1.0),
        health=health)
    engine.start(warmup=False)
    feed = {"x": np.ones((1, 8), np.float32)}
    try:
        with FaultInjector(seed=0) as fi:
            fi.on("serving.batch", raises=RuntimeError, times=2)
            for _ in range(2):
                with pytest.raises(RuntimeError):
                    engine.predict(feed, timeout=30)
        assert health.breaker.state == "open"
        with pytest.raises(CircuitOpenError):
            engine.submit(feed)
        now[0] = 10.0                    # half-open: one probe
        (out,) = engine.predict(feed, timeout=30)
        assert health.breaker.state == "closed"
        np.testing.assert_array_equal(out, model.run_direct(feed)[0])
    finally:
        engine.stop()
    stats = engine.stats()
    assert stats["errors"] == 2 and stats["shed"] == 1
    assert stats["shed_by_reason"] == {"circuit_open": 1}
    assert stats["health"]["breaker"]["opened_total"] == 1


def test_engine_spans_and_attribution(mlp_dir, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")
    model = _load(mlp_dir)
    engine = model.serve(serving.BatchingConfig(
        max_batch_size=2, batch_buckets=[2], max_latency_ms=1.0))
    profiler.start_profiler()
    try:
        engine.start(warmup=True)
        engine.predict({"x": np.ones((2, 8), np.float32)}, timeout=30)
        engine.stop()
    finally:
        profiler.stop_profiler()
    evs = profiler.events(cat=profiler.CAT_SERVING)
    names = [e["name"] for e in evs]
    assert names == ["serving::warmup", "serving::batch_run[2]"]
    assert set(evs[1]["args"]) == {"trace_id", "span_id"}
    stats = engine.stats()
    assert stats["model_flops"] > 0
    assert 0 < stats["mfu"] == engine.metrics.mfu.value


# -- the registry's serving families -------------------------------------------

#: the serving and token-serving families tests/test_metric_names.py
#: expects after its smoke run
SERVING_FAMILIES = frozenset({
    "paddle_tpu_serving_requests_total",
    "paddle_tpu_circuit_breaker_state",
    "paddle_tpu_mfu",
    "paddle_tpu_model_flops",
    "paddle_tpu_serving_swaps_total",
    "paddle_tpu_serving_shed_total",
    "paddle_tpu_serving_model_version",
    "paddle_tpu_serving_canary_requests_total",
    "paddle_tpu_decode_requests_total",
    "paddle_tpu_decode_tokens_total",
    "paddle_tpu_decode_steps_total",
    "paddle_tpu_decode_prefills_total",
    "paddle_tpu_decode_retired_total",
    "paddle_tpu_decode_shed_total",
    "paddle_tpu_decode_step_seconds",
    "paddle_tpu_decode_prefill_seconds",
    "paddle_tpu_decode_slots_active",
    "paddle_tpu_decode_slots_total",
    "paddle_tpu_decode_host_requests_total",
    "paddle_tpu_decode_host_swaps_total",
    "paddle_tpu_decode_host_models",
    "paddle_tpu_memory_peak_bytes",
})
#: the rest of what the port's serving, generation and breaker publish
OTHER_SERVING_FAMILIES = frozenset({
    "paddle_tpu_serving_rejected_total",
    "paddle_tpu_serving_timeouts_total",
    "paddle_tpu_serving_errors_total",
    "paddle_tpu_serving_batches_total",
    "paddle_tpu_serving_warmup_compiles_total",
    "paddle_tpu_serving_queue_depth_rows",
    "paddle_tpu_serving_batch_fill_ratio",
    "paddle_tpu_serving_batch_rows",
    "paddle_tpu_serving_latency_seconds",
    "paddle_tpu_serving_queue_wait_seconds",
    "paddle_tpu_circuit_breaker_opened_total",
    "paddle_tpu_circuit_breaker_shed_total",
})
#: process-wide mirrors that appear once their source has data
PROCESS_FAMILIES = frozenset({
    "paddle_tpu_retry_calls_total", "paddle_tpu_retry_retries_total",
    "paddle_tpu_retry_failures_total",
    "paddle_tpu_flight_recorder_dumps_total",
})


def test_serving_families_after_a_smoke_run(mlp_dir):
    """A ModelHost swap and a GenerationHost with a budget shed on a
    fresh default registry publish exactly the serving families, each
    named by the contract and with help text."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving.generation import (GenerationConfig,
                                                     GenerationHost,
                                                     GenerationSpec)
    prev = obs.set_default_registry(obs.MetricsRegistry())
    try:
        host = serving.ModelHost(
            mlp_dir, config=serving.BatchingConfig(
                max_batch_size=2, batch_buckets=[2], max_latency_ms=1.0),
            admission=serving.AdmissionConfig(max_queue_rows=64),
            warmup=False, device="cpu").start()
        try:
            host.predict({"x": np.zeros((1, 8), np.float32)}, timeout=30)
            assert host.swap(mlp_dir, canary_fraction=0.0,
                             version="v2")["outcome"] == "completed"
        finally:
            host.stop(timeout=120)
        gen = GenerationHost(config=GenerationConfig(max_new_tokens=2),
                             default_budget=1, device="cpu")
        gen.deploy("gm", GenerationSpec(
            vocab_size=32, max_seq_len=8, slots=1, prompt_buckets=(8,),
            cache_buckets=(8,), n_layer=1, n_head=2, d_model=8,
            d_inner=16, seed=0, eos_id=0))
        try:
            gen.generate("gm", [3, 4], timeout=60)
            gen._hosted["gm"].budget = 0
            with pytest.raises(serving.ServiceOverloadedError):
                gen.submit("gm", [5])
        finally:
            gen.stop(timeout=120)
        reg = obs.default_registry()
        fams = reg.families()
    finally:
        obs.set_default_registry(prev)
    names = {f.name for f in fams}
    assert SERVING_FAMILIES <= names, SERVING_FAMILIES - names
    assert names - SERVING_FAMILIES - OTHER_SERVING_FAMILIES <= \
        PROCESS_FAMILIES, names
    for fam in fams:
        assert obs.METRIC_NAME_RE.match(fam.name) and fam.help.strip()
    shed = {k for k, _ in reg.get("paddle_tpu_decode_shed_total").samples()}
    assert any(k[1] == "model_budget" for k in shed), shed


def test_test_mode_batch_norm_is_served_where_the_reference_refuses(
        tmp_path):
    """ROADMAP C13: a frozen program with a test-mode batch_norm lists
    the running statistics as MeanOut / VarianceOut, which it passes
    through unchanged. The reference's ServableModel counts that as a
    write and refuses every such program; the port serves it, and its
    engine's outputs match the reference executor's run of the same
    artifact."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 0
    with pt.program_guard(main, startup):
        img = ref_layers.data("img", [3, 8, 8], dtype="float32")
        x = ref_layers.conv2d(img, num_filters=4, filter_size=3)
        x = ref_layers.batch_norm(x, act="relu")
        pred = ref_layers.fc(x, size=5, act="softmax")
    exe, scope = pt.Executor(), pt.Scope()
    d = str(tmp_path / "bn")
    with pt.scope_guard(scope):
        exe.run(startup)
        pt.io.save_inference_model(d, ["img"], [pred], exe, main)
        prog, _, fetches = pt.io.load_inference_model(d, exe)
        feed = {"img": np.random.RandomState(0).rand(2, 3, 8, 8).astype(
            np.float32)}
        (want,) = exe.run(prog, feed=feed, fetch_list=fetches)
    with pytest.raises(ValueError, match="not frozen"):
        ref_serving.load(d)
    model = _load(d)
    engine = model.serve(serving.BatchingConfig(
        max_batch_size=2, batch_buckets=[2], max_latency_ms=1.0))
    engine.start(warmup=True)
    try:
        (got,) = engine.predict(feed, timeout=30)
    finally:
        engine.stop()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)
