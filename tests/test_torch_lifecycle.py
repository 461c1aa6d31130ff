"""paddle_tpu_torch.serving.ModelHost and admission control on the CPU:
the behaviours of tests/test_lifecycle.py run on the port.

Versions are small MLPs frozen by the port's io.save_inference_model
with a model_version. Held: the version metadata round trip; a hot swap
under closed-loop client traffic with zero client errors, the new
weights served after the cut and no flight-recorder bundle; a swap onto
the live version's executor (one compile cache: the compile key
separates the versions by program uid and version, so the cut serves
the NEW weights, and compiles nothing); old in-flight requests drained
on the old weights; the guard rails; a poisoned candidate and a fault
at a ``serving.swap`` point both rolled back with zero client errors
and a ``rollback`` bundle; admission shedding by queue depth, rolling
p99 and an injected ``serving.admission`` fault, each counted in the
shed ledger; a shed storm's bundle; the retired version's series
pruned from the registry; a stop racing a swap; the fallback future's
cached stable retry.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu_torch import serving
from paddle_tpu_torch.observability import default_registry
from paddle_tpu_torch.observability import flight_recorder as fr
from paddle_tpu_torch.resilience import FaultInjector


def _freeze_mlp(tmp_path, name, seed, version=None):
    lay = ptt.layers
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = seed
    with ptt.framework.isolated_name_scope(), \
            ptt.program_guard(main, startup):
        x = lay.data("x", [8], dtype="float32")
        h = lay.fc(x, size=16, act="relu")
        pred = lay.fc(h, size=4, act="softmax")
    exe, scope = ptt.Executor("cpu"), ptt.Scope()
    dirname = str(tmp_path / name)
    with ptt.scope_guard(scope):
        exe.run(startup)
        ptt.io.save_inference_model(dirname, ["x"], [pred], exe, main,
                                    model_version=version)
    return dirname


def _small_config(**kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("batch_buckets", [4])
    kw.setdefault("max_latency_ms", 1.0)
    return serving.BatchingConfig(**kw)


def _host(d, **kw):
    kw.setdefault("config", _small_config())
    return serving.ModelHost(d, device="cpu", **kw)


def _load(d):
    return serving.load(d, device="cpu")


class _Traffic:
    """Closed-loop background clients; every error is client-visible."""

    def __init__(self, host, feed, clients=2, timeout=60.0):
        self.host, self.feed, self.timeout = host, feed, timeout
        self.errors, self.ok = [], 0
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(clients)]

    def _run(self):
        while not self._stop.is_set():
            try:
                self.host.predict(self.feed, timeout=self.timeout)
                with self._lock:
                    self.ok += 1
            except Exception as e:  # noqa: BLE001 — counted, asserted
                with self._lock:
                    self.errors.append(e)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=120)
        return False


@pytest.fixture
def fresh_recorder(tmp_path):
    rec = fr.FlightRecorder(dump_dir=str(tmp_path / "flightrec"),
                            min_interval_s=0.0).enable()
    prev = fr.set_flight_recorder(rec)
    yield rec
    rec.disable()
    fr.set_flight_recorder(prev)


def _reasons(rec):
    out = []
    for b in rec.dumps():
        with open(os.path.join(b, "meta.json")) as f:
            out.append(json.load(f)["reason"])
    return sorted(out)


@pytest.fixture(scope="module")
def versions(tmp_path_factory):
    d = tmp_path_factory.mktemp("lifecycle")
    return {"v1": _freeze_mlp(d, "v1", seed=0, version="v1"),
            "v2": _freeze_mlp(d, "v2", seed=1, version="v2")}


def test_model_version_metadata_roundtrip(tmp_path):
    d = _freeze_mlp(tmp_path, "m", seed=0, version="ckpt-123")
    assert _load(d).version == "ckpt-123"
    assert _load(_freeze_mlp(tmp_path, "m2", seed=0)).version is None
    # re-freezing without a version drops the stale sidecar
    assert _load(_freeze_mlp(tmp_path, "m", seed=0)).version is None


def test_hot_swap_under_traffic_zero_failures(versions, fresh_recorder):
    host = _host(versions["v1"]).start()
    feed = {"x": np.random.RandomState(0).rand(2, 8).astype(np.float32)}
    try:
        with _Traffic(host, feed) as traffic:
            report = host.swap(versions["v2"], canary_fraction=0.5,
                               canary_min_requests=5,
                               canary_timeout_s=60.0)
        assert report["outcome"] == "completed", report
        assert (report["from_version"], report["to_version"]) == \
            ("v1", "v2")
        assert report["canary"]["successes"] >= 5
        assert report["canary"]["failures"] == 0
        assert traffic.errors == [] and traffic.ok > 0
        (served,) = host.predict(feed, timeout=60)
        (direct,) = _load(versions["v2"]).run_direct(feed)
        np.testing.assert_array_equal(served, direct)
        assert host.current_version == "v2"
    finally:
        host.stop(timeout=120)
    assert fresh_recorder.dumps() == []
    reg = host._registry
    swaps = dict((k, c.value) for k, c in reg.get(
        "paddle_tpu_serving_swaps_total").samples())
    assert swaps[(host.host_label, "completed")] == 1
    ver = dict((k, g.value) for k, g in reg.get(
        "paddle_tpu_serving_model_version").samples())
    assert ver[(host.host_label, "v2")] == 1.0
    assert ver[(host.host_label, "v1")] == 0.0


def test_swap_shares_executor_and_compile_cache(versions):
    host = _host(versions["v1"]).start()
    feed = {"x": np.random.RandomState(2).rand(4, 8).astype(np.float32)}
    try:
        (old,) = host.predict(feed, timeout=60)
        exe_before = host._current.model.executor
        report = host.swap(versions["v2"], canary_fraction=0.0,
                           share_executor=True)
        assert report["outcome"] == "completed"
        assert host._current.model.executor is exe_before
        misses = exe_before.cache_stats["misses"]
        (new,) = host.predict(feed, timeout=60)
        assert exe_before.cache_stats["misses"] == misses
        # one cache, two versions: the key separates them, so the cut
        # serves v2's weights, not v1's step
        np.testing.assert_array_equal(
            new, _load(versions["v2"]).run_direct(feed)[0])
        assert not np.array_equal(new, old)
    finally:
        host.stop(timeout=120)


def test_swap_drains_old_in_flight_requests(versions):
    host = _host(versions["v1"], config=_small_config(
        max_batch_size=8, batch_buckets=[8],
        max_latency_ms=60_000.0)).start()
    rng = np.random.RandomState(3)
    feeds = [{"x": rng.rand(1, 8).astype(np.float32)} for _ in range(3)]
    try:
        futures = [host.submit(f) for f in feeds]
        assert not any(f.done() for f in futures)
        assert host.swap(versions["v2"],
                         canary_fraction=0.0)["outcome"] == "completed"
        v1 = _load(versions["v1"])
        for fut, feed in zip(futures, feeds):
            np.testing.assert_allclose(fut.result(timeout=0)[0],
                                       v1.run_direct(feed)[0],
                                       rtol=1e-6, atol=1e-7)
    finally:
        host.stop(timeout=120)


def test_swap_guard_rails(versions):
    host = _host(versions["v1"])
    with pytest.raises(RuntimeError, match="not started"):
        host.submit({"x": np.zeros((1, 8), np.float32)})
    with pytest.raises(serving.SwapError, match="not serving"):
        host.swap(versions["v1"])
    host.start()
    with pytest.raises(ValueError, match="canary_fraction"):
        host.swap(versions["v1"], canary_fraction=1.5)
    host.stop(timeout=120)
    with pytest.raises(serving.SwapError, match="not serving"):
        host.swap(versions["v1"])


@pytest.mark.parametrize("how", ["poisoned_candidate", "swap_fault"])
def test_failed_swap_rolls_back_with_clients_unharmed(
        versions, fresh_recorder, how):
    """A candidate whose batches fail (canary requests retry on the
    stable version, its breaker or error rate trips) and a fault at the
    post-precompile ``serving.swap`` point: both roll back, no client
    sees an error, v1 keeps serving bit for bit."""
    host = _host(versions["v1"], warmup=False).start()
    feed = {"x": np.ones((1, 8), np.float32)}
    (before,) = host.predict(feed, timeout=60)
    try:
        with _Traffic(host, feed) as traffic:
            if how == "poisoned_candidate":
                bad = serving.ServableModel.load(versions["v2"],
                                                 device="cpu")

                def poisoned_run(feed, sync=True):
                    raise RuntimeError("poisoned candidate batch")

                bad.run_direct = poisoned_run
                report = host.swap(bad, canary_fraction=1.0,
                                   canary_min_requests=6,
                                   canary_max_error_rate=0.25,
                                   canary_timeout_s=60.0)
                assert report["error"] in ("breaker_tripped",
                                           "canary_error_rate"), report
                assert report["canary"]["failures"] > 0
            else:
                with FaultInjector(seed=7) as fi:
                    fi.on("serving.swap", raises=RuntimeError, times=1,
                          after=1)
                    report = host.swap(versions["v2"],
                                       canary_fraction=0.5,
                                       canary_min_requests=3,
                                       canary_timeout_s=60.0)
                assert fi.triggered("serving.swap") == 1
                assert "injected fault" in report["error"]
        assert report["outcome"] == "rolled_back", report
        assert traffic.errors == [] and traffic.ok > 0
        assert host.current_version == "v1"
        np.testing.assert_array_equal(host.predict(feed, timeout=60)[0],
                                      before)
    finally:
        host.stop(timeout=120)
    assert "rollback" in _reasons(fresh_recorder)
    swaps = dict((k, c.value) for k, c in host._registry.get(
        "paddle_tpu_serving_swaps_total").samples())
    assert swaps[(host.host_label, "rolled_back")] == 1


def _engine(d, **kw):
    return _load(d).serve(
        _small_config(max_batch_size=64, batch_buckets=[64],
                      max_latency_ms=60_000.0, queue_capacity_rows=10_000),
        admission=serving.AdmissionConfig(**kw))


def test_admission_sheds_on_queue_depth_and_ledger_accounts(versions):
    engine = _engine(versions["v1"], max_queue_rows=4,
                     shed_storm_threshold=None)
    engine.start(warmup=False)
    feed = {"x": np.ones((1, 8), np.float32)}
    futures, rejected = [], 0
    try:
        for _ in range(12):
            try:
                futures.append(engine.submit(feed))
            except serving.ServiceOverloadedError as e:
                assert e.reason == "queue_depth"
                rejected += 1
    finally:
        engine.stop(drain=True, timeout=120)
    assert rejected == 7 and len(futures) == 5
    for fut in futures:
        fut.result(timeout=0)
    assert engine.metrics.shed_by_reason() == {"queue_depth": rejected}
    assert engine.stats()["admission"]["shed_total"] == rejected


def test_admission_sheds_on_p99_and_on_an_injected_fault(versions):
    model = _load(versions["v1"])
    engine = model.serve(_small_config(), admission=serving.AdmissionConfig(
        max_p99_s=0.5, p99_min_samples=16, p99_refresh_s=0.0,
        shed_storm_threshold=None))
    engine.start(warmup=False)
    feed = {"x": np.ones((1, 8), np.float32)}
    try:
        engine.predict(feed, timeout=60)     # a cold engine admits
        with FaultInjector(seed=3) as fi:
            fi.on("serving.admission", raises=ConnectionError, times=2)
            t0 = time.monotonic()
            for _ in range(2):
                with pytest.raises(serving.ServiceOverloadedError) as ei:
                    engine.submit(feed)
                assert ei.value.reason == "fault"
            assert time.monotonic() - t0 < 5.0
        engine.predict(feed, timeout=60)     # the fault cleared
        for _ in range(32):
            engine.metrics.latency_s.record(2.0)
        with pytest.raises(serving.ServiceOverloadedError) as ei:
            engine.submit(feed)
        assert ei.value.reason == "latency_p99"
    finally:
        engine.stop(drain=True, timeout=120)
    assert engine.metrics.shed_by_reason() == {"fault": 2,
                                               "latency_p99": 1}


def test_shed_storm_triggers_flight_recorder(versions, fresh_recorder):
    engine = _engine(versions["v1"], max_queue_rows=1,
                     shed_storm_threshold=3, shed_storm_window_s=30.0)
    engine.start(warmup=False)
    feed = {"x": np.ones((1, 8), np.float32)}
    shed = 0
    try:
        for _ in range(8):
            try:
                engine.submit(feed)
            except serving.ServiceOverloadedError:
                shed += 1
    finally:
        engine.stop(drain=True, timeout=120)
    assert shed == 6
    assert "shed_storm" in _reasons(fresh_recorder)


def test_retired_version_series_pruned_from_registry(versions):
    host = _host(versions["v1"], warmup=False).start()
    host.predict({"x": np.ones((2, 8), np.float32)}, timeout=60)
    old_label = host._current.engine.metrics.engine_label
    reg = default_registry()

    def engine_labels():
        fam = reg.get("paddle_tpu_serving_requests_total")
        return {key[0] for key, _ in fam.samples()}

    assert old_label in engine_labels()
    try:
        report = host.swap(versions["v2"], canary_fraction=0.0,
                           version="v2")
        assert report["outcome"] == "completed"
        live_label = host._current.engine.metrics.engine_label
        assert old_label not in engine_labels()
        assert live_label in engine_labels()
        with FaultInjector(seed=0) as fi:
            fi.on("serving.swap", raises=RuntimeError, times=1, after=1)
            report = host.swap(versions["v1"], canary_fraction=0.0,
                               version="v3")
        assert report["outcome"] == "rolled_back"
        assert live_label in engine_labels()
        ver = {k[1] for k, _ in reg.get(
            "paddle_tpu_serving_model_version").samples()
            if k[0] == host.host_label}
        assert ver == {"v1", "v2"}      # the rolled-back v3 left none
    finally:
        host.stop(timeout=120)


def test_stop_during_swap_rolls_back_and_stops_candidate(versions):
    host = _host(versions["v1"], warmup=False).start()
    results = {}

    def swapper():
        results["report"] = host.swap(versions["v2"], canary_fraction=0.5,
                                      canary_min_requests=1_000_000,
                                      canary_timeout_s=60.0)

    t = threading.Thread(target=swapper, daemon=True)
    t.start()
    deadline = time.monotonic() + 30.0
    while host._canary is None and time.monotonic() < deadline:
        time.sleep(0.005)
    assert host._canary is not None, "swap never reached canary"
    host.stop(timeout=120)
    t.join(timeout=120)
    report = results["report"]
    assert report["outcome"] == "rolled_back", report
    assert "host_stopped" in report["error"]
    assert host._canary is None


def test_fallback_future_stable_retry_is_cached():
    from paddle_tpu_torch.serving.lifecycle import _FallbackFuture

    class _FailingFut:
        def result(self, timeout=None):
            raise RuntimeError("canary failed")

        def done(self):
            return True

    calls = []

    class _Host:
        def _canary_outcome(self, version, ok):
            calls.append(("outcome", ok))

        def _stable_result(self, feed, timeout, exc):
            calls.append("stable")
            return "stable-answer"

    f = _FallbackFuture(_Host(), "vX", {"x": 1}, _FailingFut())
    assert f.result(timeout=5) == "stable-answer"
    assert f.result(timeout=5) == "stable-answer"
    assert calls == [("outcome", False), "stable"]
