"""ServingEngine: worker threads draining the dynamic batcher into the
executor's bucketed compile cache.

The port's copy of ``paddle_tpu/serving/engine.py``. Lifecycle:
`start()` (optionally warming one compiled step per batch bucket) ->
clients `submit()`/`predict()` -> `stop()` closes the front door and
drains every in-flight batch before joining workers. The engine owns no
compilation machinery: because the batcher pads every flush to a bucket
shape, the executor sees a small closed set of feed signatures and each
bucket is one compile key.

On the card a key's step is captured as a CUDA graph on its second run,
and only by a thread that has run it before (cuBLAS and cuDNN create
their handles per thread, which a capture refuses: core/executor.py).
So after the warm-up each worker thread runs every bucket twice on
itself before it takes traffic — the first run warms the thread, the
second captures (or, for a later worker, replays) — and `start()` waits
for that; the first real request of every bucket then replays a graph.
`warm_captures` counts the buckets the workers found captured.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from .. import profiler
from ..observability import attribution as obs_attr
from ..observability import trace as obs_trace
from ..resilience import faults
from ..resilience import health as health_mod
from ..resilience.health import CircuitOpenError, HealthMonitor
from .admission import AdmissionConfig, AdmissionController
from .batcher import (Batch, BatchingConfig, DynamicBatcher,
                      QueueFullError, ServingFuture)
from .metrics import ServingMetrics

__all__ = ["ServingEngine"]


class ServingEngine:
    def __init__(self, model, config: Optional[BatchingConfig] = None,
                 metrics: Optional[ServingMetrics] = None,
                 num_workers: int = 1,
                 health: Optional[HealthMonitor] = None,
                 async_dispatch: bool = False,
                 admission: Optional[AdmissionConfig] = None):
        self.model = model
        self.config = config or BatchingConfig()
        self.metrics = metrics or ServingMetrics()
        # consecutive-failure circuit breaker: a broken model trips it
        # OPEN and submit() fast-fails (load shedding) until a half-open
        # probe batch succeeds — see resilience/health.py
        self.health = health or HealthMonitor()
        self.batcher = DynamicBatcher(model.feed_specs, self.config,
                                      self.metrics)
        # optional load shedding in front of the batcher: queue-depth /
        # rolling-p99 limits reject with a fast ServiceOverloadedError
        # instead of letting the queue (and every admitted request's
        # latency) grow without bound — see admission.py
        self.admission = AdmissionController(
            admission, self.batcher, self.metrics) \
            if admission is not None else None
        self.num_workers = int(num_workers)
        # opt-in host/device pipelining BETWEEN bucket flushes: each
        # worker dispatches batch N (Executor.run sync=False), then —
        # while the device computes it — dequeues/pads batch N+1 and
        # dispatches that before delivering N's results. One batch per
        # worker stays undelivered at a time, so latency grows by at
        # most one batch while the device never waits for result
        # delivery. Off by default: the sync loop is simpler to reason
        # about under faults and is the latency-optimal choice at low
        # load.
        self.async_dispatch = bool(async_dispatch)
        # per-row vs batch-level fetch split decided from the STATIC
        # fetch specs (leading -1 = batched): a runtime shape check
        # alone would misclassify a batch-level fetch whose leading dim
        # happens to equal the bucket size. None = spec shape unknown,
        # fall back to the runtime check.
        self._per_row_fetch = []
        for name in model.fetch_names:
            shape = (model.fetch_specs.get(name) or {}).get("shape")
            self._per_row_fetch.append(
                None if shape is None else bool(shape and shape[0] == -1))
        self._threads = []
        self._started = False
        self._stopped = False
        #: buckets whose step was captured as a CUDA graph when the
        #: workers' warm-up ended (0 on the CPU)
        self.warm_captures = 0
        self._warm_error: Optional[BaseException] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self, warmup: bool = True):
        if self._started:
            raise RuntimeError("engine already started")
        if self._stopped:
            raise RuntimeError("engine was stopped; build a new one")
        if warmup:
            self.warmup()
        warm = warmup and self.model.executor.device.type == "cuda"
        ready = []
        for i in range(self.num_workers):
            ev = threading.Event()
            t = threading.Thread(target=self._worker_main,
                                 args=(warm, ev),
                                 name=f"serving-worker-{i}", daemon=True)
            t.start()
            self._threads.append(t)
            ready.append(ev)
        for ev in ready:
            ev.wait()
        if self._warm_error is not None:
            self.batcher.close(drain=False)
            for t in self._threads:
                t.join()
            self._threads = []
            self._stopped = True
            raise self._warm_error
        self._started = True
        # only a RUNNING engine captures model.predict; before start /
        # after stop, predict falls back to a direct run
        self.model._engine = self
        return self

    def warmup(self):
        """Plan one compiled step per batch bucket by running a zero
        batch through the model, so the first real request in any bucket
        pays dispatch, not planning. Dynamic non-batch dims warm at the
        smallest seq bucket only (other seq buckets plan on first
        use)."""
        with profiler.RecordEvent("serving::warmup",
                                  cat=profiler.CAT_SERVING):
            for rows in self.config.batch_buckets:
                feed = self._zero_feed(rows)
                before = self.model.executor.cache_stats["misses"]
                self.model.run_direct(feed)
                self.metrics.warmup_compiles.inc(
                    self.model.executor.cache_stats["misses"] - before)

    def _warm_thread(self):
        """Run every bucket twice on this worker thread (the card only):
        the first run warms the thread, the second captures the bucket's
        step as a CUDA graph (or replays one another worker captured)."""
        with profiler.RecordEvent("serving::warm_worker",
                                  cat=profiler.CAT_SERVING):
            captured = 0
            for rows in self.config.batch_buckets:
                feed = self._zero_feed(rows)
                for _ in range(2):
                    with self.model._run_lock:
                        exe = self.model.executor
                        exe.run(self.model.program, feed=feed,
                                fetch_list=self.model.fetch_names,
                                scope=self.model.scope)
                        done = exe.last_compiled is not None and \
                            exe.last_compiled.captured
                captured += int(done)
            self.warm_captures = max(self.warm_captures, captured)

    def _zero_feed(self, rows: int) -> Dict[str, np.ndarray]:
        seq = self.config.seq_buckets[0] if self.config.seq_buckets else 1
        feed = {}
        for name, spec in self.model.feed_specs.items():
            shape = [rows] + [seq if d == -1 else d
                              for d in spec["shape"][1:]]
            feed[name] = np.zeros(shape, dtype=np.dtype(spec["dtype"]))
        return feed

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting requests; with drain=True (default) every
        queued and in-flight request completes before workers exit, so
        no accepted request is dropped."""
        self.batcher.close(drain=drain)
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        for t in self._threads:
            t.join(timeout=None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        self._threads = [t for t in self._threads if t.is_alive()]
        if self._threads:
            raise TimeoutError(
                f"{len(self._threads)} serving worker(s) still draining "
                "after timeout")
        self._stopped = True
        if self.model._engine is self:
            self.model._engine = None

    # -- request path ------------------------------------------------------
    def submit(self, feed: Dict[str, Any]) -> ServingFuture:
        if not self._started:
            raise RuntimeError(
                "engine not started — call engine.start() first "
                "(a request submitted now would wait forever)")
        if self.admission is not None:
            # sheds raise ServiceOverloadedError and count themselves
            # into paddle_tpu_serving_shed_total{reason=}
            self.admission.check()
        admit = self.health.allow_request()
        if not admit:   # already counted in the breaker's shed_total
            self.metrics.shed("circuit_open")
            raise CircuitOpenError(
                "serving circuit is open (batch failures tripped the "
                "breaker) — request shed; see engine.stats()['health']")
        try:
            return self.batcher.submit(feed)
        except BaseException as e:
            # the admitted request never reached a batch (bad feed,
            # queue full): if it held the half-open probe slot, hand it
            # back instead of wedging the breaker — but only then, so a
            # non-probe failure can't mint a second concurrent probe
            if admit is health_mod.PROBE:
                self.health.release_probe()
            if isinstance(e, QueueFullError):
                # backpressure is a rejection too: the shed ledger must
                # account for EVERY turned-away request
                self.metrics.shed("queue_full")
            raise

    def predict(self, feed: Dict[str, Any],
                timeout: Optional[float] = None):
        """Synchronous predict: submit + wait. Returns the fetch list for
        exactly this request's rows (padding stripped)."""
        return self.submit(feed).result(timeout=timeout)

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict:
        """JSON-able snapshot: request/batch counters, fill ratio,
        latency percentiles, queue depth, compile-cache hit rate."""
        out = self.metrics.stats(executor=self.model.executor)
        out["batch_buckets"] = list(self.config.batch_buckets)
        out["seq_buckets"] = (list(self.config.seq_buckets)
                              if self.config.seq_buckets else None)
        out["workers"] = len(self._threads)
        out["async_dispatch"] = self.async_dispatch
        out["started"] = self._started
        out["stopped"] = self._stopped
        out["health"] = self.health.snapshot()
        # convenience alias; the breaker's counter is the single source
        out["shed"] = out["health"]["breaker"]["shed_total"]
        out["admission"] = (self.admission.snapshot()
                            if self.admission is not None else None)
        return out

    # -- worker ------------------------------------------------------------
    def _worker_main(self, warm: bool, ready: threading.Event):
        try:
            if warm:
                self._warm_thread()
        except BaseException as e:  # noqa: BLE001 — start() re-raises it
            self._warm_error = e
        finally:
            ready.set()
        if self._warm_error is None:
            self._worker_loop()

    def _worker_loop(self):
        if not self.async_dispatch:
            while True:
                batch = self.batcher.next_batch()
                if batch is None:
                    return
                self._run_batch(batch)
        # pipelined loop: one undelivered (batch, StepResult) in flight
        # per worker; the NEXT batch is dequeued and dispatched before
        # the previous one's results are materialized and delivered.
        # With a result in flight the dequeue must not sit on it: poll
        # (timeout=0) and, if nothing is flushable RIGHT NOW, deliver
        # the pending result instead of parking it behind the batcher's
        # latency deadline — low traffic degrades to the sync loop, the
        # overlap only engages under sustained load.
        pending = None
        while True:
            if pending is not None:
                batch = self.batcher.next_batch(timeout=0.0)
                if batch is None:
                    self._deliver(*pending)
                    pending = None
                    continue
            else:
                batch = self.batcher.next_batch()
                if batch is None:  # closed and fully drained
                    return
            t0 = time.monotonic()
            try:
                # per-batch root span (worker threads have no inherited
                # context): dispatch events AND the StepResult's later
                # fetch share this batch's trace ids
                with obs_trace.span("serving/batch"):
                    with profiler.RecordEvent(
                            f"serving::batch_dispatch[{batch.bucket_rows}]",
                            cat=profiler.CAT_SERVING):
                        faults.fire("serving.batch")
                        res = self.model.run_direct(batch.feed,
                                                    sync=False)
            except BaseException as e:  # dispatch failed; keep serving
                self._fail_batch(batch, e)
                res = None
            if pending is not None:
                self._deliver(*pending)
            pending = (batch, res, t0) if res is not None else None

    def _run_batch(self, batch: Batch):
        t0 = time.monotonic()
        try:
            # per-batch root span: serving workers run on their own
            # threads with no inherited trace context
            with obs_trace.span("serving/batch"):
                with profiler.RecordEvent(
                        f"serving::batch_run[{batch.bucket_rows}]",
                        cat=profiler.CAT_SERVING):
                    faults.fire("serving.batch")
                    # dispatch async then materialize immediately: the
                    # same run as sync=True, but the result carries THIS
                    # dispatch's static cost — the executor-global
                    # last_cost races with other workers' dispatches
                    res = self.model.run_direct(batch.feed, sync=False)
                    fetches = res.fetches()
        except BaseException as e:  # deliver failures, keep serving
            self._fail_batch(batch, e)
            return
        self._complete(batch, fetches, t0, res.cost)

    def _deliver(self, batch: Batch, res, t0: float):
        """Materialize an async-dispatched batch's StepResult and hand
        each request its rows. Asynchronous device errors surface
        here."""
        try:
            fetches = res.fetches()
        except BaseException as e:
            self._fail_batch(batch, e)
            return
        # res.cost is THIS dispatch's static cost, frozen at dispatch —
        # by delivery time the executor-global last_cost may belong to
        # a later bucket (possibly another worker's)
        self._complete(batch, fetches, t0, res.cost)

    def _fail_batch(self, batch: Batch, e: BaseException):
        self.metrics.errors.inc(len(batch.requests))
        self.health.record_failure(e)
        for req in batch.requests:
            req.future.set_exception(e)

    def _complete(self, batch: Batch, fetches, t0: float, cost=None):
        t1 = time.monotonic()
        self.health.record_success()
        if obs_attr.attribution_enabled():
            # live MFU for THIS engine: static cost of THIS batch's
            # dispatched executable (captured at dispatch — under
            # async overlap executor.last_cost may already belong to
            # the next batch's bucket) / batch wall time / device peak
            if cost is not None and cost.flops and t1 > t0:
                self.metrics.set_mfu(
                    cost.flops / obs_attr.peak_flops() / (t1 - t0),
                    cost.flops)
        for req, (i0, i1) in zip(batch.requests, batch.slices):
            out = []
            for f, per_row in zip(fetches, self._per_row_fetch):
                arr = np.asarray(f)
                # per-row fetches are sliced back to the request's rows;
                # batch-level fetches (scalars / no leading batch axis)
                # are delivered whole
                if per_row is None:  # unknown static shape
                    per_row = arr.ndim >= 1 and \
                        arr.shape[0] == batch.bucket_rows
                out.append(arr[i0:i1] if per_row else arr)
            self.metrics.queue_wait_s.record(t0 - req.t_submit)
            self.metrics.latency_s.record(t1 - req.t_submit)
            req.future.set_result(out)
