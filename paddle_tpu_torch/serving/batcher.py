"""Dynamic request batcher: queue single requests, pad/bucket them into
a small set of batch shapes, flush on max-batch or latency deadline.

The port's copy of ``paddle_tpu/serving/batcher.py``. Why buckets: the
executor plans (and on the card captures) one step per feed signature
(core/executor.py compile_key); padding every flush to the nearest
bucket keeps the key count bounded at
O(len(batch_buckets) * len(seq_buckets)).

Threading model: `submit()` is called from any number of client threads;
`next_batch()` is called by the engine's worker thread(s) and blocks
until a flush condition holds:
  - queued rows reach the largest bucket (max-batch flush), or
  - the oldest request has waited `max_latency_ms` (deadline flush), or
  - the batcher is closed (drain: remaining requests flush immediately).
Backpressure is a bound on queued rows: `submit()` raises
`QueueFullError` instead of queueing unbounded work. LoD (ragged) feeds
are refused, as in the JAX package.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BatchingConfig", "DynamicBatcher", "ServingFuture", "Batch",
           "QueueFullError", "ServingStopped"]


class QueueFullError(RuntimeError):
    """Backpressure: the pending-request queue is at capacity."""


class ServingStopped(RuntimeError):
    """The engine/batcher no longer accepts requests."""


class BatchingConfig:
    """Knobs for the dynamic batcher.

    max_batch_size:    largest rows per flushed batch (= largest bucket).
    batch_buckets:     allowed padded batch sizes; default powers of two
                       up to max_batch_size (1, 2, 4, ..., max).
    seq_buckets:       allowed padded lengths for dynamic non-batch dims
                       (e.g. sequence length); None = pad to the batch
                       max (one executable per distinct max length).
    max_latency_ms:    deadline flush — max time the oldest request waits
                       before a partial batch is flushed.
    queue_capacity_rows: backpressure bound on queued (unflushed) rows.
    request_timeout_ms: per-request time budget from submit; expired
                       requests fail with TimeoutError instead of
                       occupying a batch slot. None = no timeout.
    pad_value:         fill for padded rows/positions.
    """

    def __init__(self, max_batch_size: int = 32,
                 batch_buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 max_latency_ms: float = 5.0,
                 queue_capacity_rows: int = 1024,
                 request_timeout_ms: Optional[float] = None,
                 pad_value: float = 0.0):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.max_batch_size = int(max_batch_size)
        if batch_buckets is None:
            batch_buckets, b = [], 1
            while b < self.max_batch_size:
                batch_buckets.append(b)
                b *= 2
            batch_buckets.append(self.max_batch_size)
        self.batch_buckets = sorted(set(int(b) for b in batch_buckets))
        if self.batch_buckets[-1] != self.max_batch_size:
            raise ValueError("largest batch bucket must equal "
                             "max_batch_size")
        self.seq_buckets = (sorted(set(int(s) for s in seq_buckets))
                            if seq_buckets else None)
        self.max_latency_ms = float(max_latency_ms)
        self.queue_capacity_rows = int(queue_capacity_rows)
        self.request_timeout_ms = request_timeout_ms
        self.pad_value = pad_value


class ServingFuture:
    """Result handle for one submitted request.

    Deliberately NOT concurrent.futures.Future: its cancellation state
    machine turns a client cancel() into InvalidStateError crashes in
    the worker. This is the minimal single-resolve subset serving needs
    (result() raises builtins TimeoutError).
    """

    def __init__(self):
        self._event = threading.Event()
        self._result: Optional[List[np.ndarray]] = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, result):
        self._result = result
        self._event.set()

    def set_exception(self, exc: BaseException):
        self._exc = exc
        self._event.set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request did not complete in time")
        if self._exc is not None:
            raise self._exc
        return self._result


class _Request:
    __slots__ = ("feed", "rows", "future", "t_submit", "deadline")

    def __init__(self, feed, rows, deadline):
        self.feed = feed
        self.rows = rows
        self.future = ServingFuture()
        self.t_submit = time.monotonic()
        self.deadline = deadline  # absolute monotonic time or None


class Batch:
    """A flushed, padded batch: merged feed + per-request row slices."""

    __slots__ = ("feed", "requests", "slices", "rows", "bucket_rows")

    def __init__(self, feed: Dict[str, np.ndarray],
                 requests: List[_Request],
                 slices: List[Tuple[int, int]], rows: int,
                 bucket_rows: int):
        self.feed = feed
        self.requests = requests
        self.slices = slices
        self.rows = rows
        self.bucket_rows = bucket_rows

    @property
    def fill_ratio(self) -> float:
        return self.rows / self.bucket_rows if self.bucket_rows else 0.0


def _bucketize(n: int, buckets: Optional[Sequence[int]]) -> int:
    """Smallest bucket >= n; beyond the largest bucket, n itself (the
    caller bounds batch rows by max_batch_size, so this only happens for
    seq dims longer than every seq bucket)."""
    if buckets:
        for b in buckets:
            if b >= n:
                return b
    return n


class DynamicBatcher:
    def __init__(self, feed_specs: Dict[str, Dict],
                 config: Optional[BatchingConfig] = None, metrics=None):
        """feed_specs: {name: {"shape": [...], "dtype": str,
        "lod_level": int}} as returned by io.load_inference_model(...,
        return_meta=True) / io.inference_model_specs."""
        self.config = config or BatchingConfig()
        self.metrics = metrics
        self.feed_specs = dict(feed_specs)
        for name, spec in self.feed_specs.items():
            shape = spec.get("shape")
            if spec.get("lod_level", 0):
                raise ValueError(
                    f"feed {name!r} is a LoD (ragged) tensor — the "
                    "dynamic batcher only serves dense feeds with a "
                    "leading batch axis (see KNOWN_GAPS)")
            if not shape or shape[0] != -1:
                raise ValueError(
                    f"feed {name!r} has no dynamic leading batch dim "
                    f"(shape {shape}) — unservable via the dynamic "
                    "batcher")
        self._queue: List[_Request] = []
        self._queued_rows = 0
        self._closed = False
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    # -- producer side -----------------------------------------------------
    def submit(self, feed: Dict[str, Any]) -> ServingFuture:
        """Queue one request. `feed` maps every feed name to an array
        whose leading dim is this request's row count (1 for a single
        sample). Returns a ServingFuture; raises QueueFullError under
        backpressure and ServingStopped after close()."""
        arrs, rows = self._validate(feed)
        cfg = self.config
        deadline = None
        if cfg.request_timeout_ms is not None:
            deadline = time.monotonic() + cfg.request_timeout_ms / 1e3
        req = _Request(arrs, rows, deadline)
        with self._cond:
            if self._closed:
                raise ServingStopped("batcher is closed")
            if self._queued_rows + rows > cfg.queue_capacity_rows:
                if self.metrics:
                    self.metrics.rejected.inc()
                raise QueueFullError(
                    f"queue at capacity ({self._queued_rows} rows "
                    f"queued, capacity {cfg.queue_capacity_rows})")
            self._queue.append(req)
            self._queued_rows += rows
            if self.metrics:
                self.metrics.requests.inc()
                self.metrics.queue_depth.set(self._queued_rows)
            self._cond.notify_all()
        return req.future

    def _validate(self, feed) -> Tuple[Dict[str, np.ndarray], int]:
        missing = set(self.feed_specs) - set(feed)
        extra = set(feed) - set(self.feed_specs)
        if missing or extra:
            raise ValueError(
                f"feed names mismatch: missing {sorted(missing)}, "
                f"unexpected {sorted(extra)}")
        arrs, rows = {}, None
        for name, spec in self.feed_specs.items():
            arr = np.asarray(feed[name], dtype=np.dtype(spec["dtype"]))
            shape = spec["shape"]
            if arr.ndim != len(shape):
                # a single sample without the batch axis: add it
                if arr.ndim == len(shape) - 1:
                    arr = arr[None]
                else:
                    raise ValueError(
                        f"feed {name!r}: rank {arr.ndim} does not match "
                        f"spec shape {shape}")
            for ax, dim in enumerate(shape):
                if dim != -1 and arr.shape[ax] != dim:
                    raise ValueError(
                        f"feed {name!r}: dim {ax} is {arr.shape[ax]}, "
                        f"spec requires {dim}")
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise ValueError(
                    "inconsistent leading (batch) dims across feeds: "
                    f"{name!r} has {arr.shape[0]}, expected {rows}")
            arrs[name] = arr
        if rows == 0:
            raise ValueError("empty request (0 rows)")
        if rows > self.config.max_batch_size:
            raise ValueError(
                f"request rows {rows} exceed max_batch_size "
                f"{self.config.max_batch_size}; split the request")
        return arrs, rows

    # -- consumer side -----------------------------------------------------
    def next_batch(self, timeout: Optional[float] = None) -> Optional[Batch]:
        """Block until a flush condition holds and return the assembled
        Batch; None when closed and fully drained (or `timeout` expires
        with nothing to flush)."""
        t_end = (time.monotonic() + timeout) if timeout is not None else None
        with self._cond:
            while True:
                self._fail_expired_locked()
                now = time.monotonic()
                if self._queue:
                    deadline = (self._queue[0].t_submit
                                + self.config.max_latency_ms / 1e3)
                    # a request whose per-request deadline lands before
                    # the latency deadline pulls the flush EARLIER (by
                    # the timeout margin), so it is served rather than
                    # expired; expiry symmetrically waits one margin
                    # PAST the deadline, so wakeup jitter must exceed
                    # half the timeout budget to lose the race
                    req_dls = [r.deadline for r in self._queue
                               if r.deadline is not None]
                    if req_dls:
                        deadline = min(deadline,
                                       min(req_dls) - self._margin_s())
                    if (self._closed
                            or self._queued_rows >= self.config.max_batch_size
                            or now >= deadline):
                        return self._pop_batch_locked()
                    wait = deadline - now
                else:
                    if self._closed:
                        return None
                    wait = None
                if t_end is not None:
                    if now >= t_end:
                        return None
                    wait = min(wait, t_end - now) if wait else t_end - now
                self._cond.wait(timeout=wait)

    def close(self, drain: bool = True):
        """Stop accepting requests. With drain=True (default) queued
        requests remain flushable via next_batch; otherwise they fail
        with ServingStopped immediately."""
        with self._cond:
            self._closed = True
            if not drain:
                for req in self._queue:
                    req.future.set_exception(
                        ServingStopped("engine stopped before this "
                                       "request was scheduled"))
                self._queue.clear()
                self._queued_rows = 0
                if self.metrics:
                    self.metrics.queue_depth.set(0)
            self._cond.notify_all()

    @property
    def pending_rows(self) -> int:
        return self._queued_rows

    @property
    def oldest_wait_s(self) -> float:
        """How long the oldest queued request has been waiting (0.0 when
        the queue is empty) — an admission-control signal: a growing
        oldest-wait means the workers are not keeping up."""
        with self._lock:
            if not self._queue:
                return 0.0
            return max(0.0, time.monotonic() - self._queue[0].t_submit)

    def _margin_s(self) -> float:
        """Scheduling-jitter allowance: 25% of the request timeout
        budget (>= 1ms). The flush deadline is pulled one margin BEFORE
        a request's deadline and expiry fires one margin AFTER it, so a
        flushable request is never expired by a late wakeup alone."""
        return max(1e-3,
                   (self.config.request_timeout_ms or 0.0) / 1e3 * 0.25)

    def _fail_expired_locked(self):
        if self.config.request_timeout_ms is None:
            return
        grace = self._margin_s()
        now = time.monotonic()
        keep = []
        for req in self._queue:
            if req.deadline is not None and now >= req.deadline + grace:
                self._queued_rows -= req.rows
                if self.metrics:
                    self.metrics.timeouts.inc()
                req.future.set_exception(TimeoutError(
                    "request expired in queue before being batched"))
            else:
                keep.append(req)
        if len(keep) != len(self._queue):
            self._queue = keep
            if self.metrics:
                self.metrics.queue_depth.set(self._queued_rows)

    def _pop_batch_locked(self) -> Batch:
        cfg = self.config
        take, rows = [], 0
        for req in self._queue:
            if rows + req.rows > cfg.max_batch_size:
                break
            take.append(req)
            rows += req.rows
        self._queue = self._queue[len(take):]
        self._queued_rows -= rows
        if self.metrics:
            self.metrics.queue_depth.set(self._queued_rows)
        if self._queue:
            # leftovers may already satisfy a flush condition
            self._cond.notify_all()
        return self._assemble(take, rows)

    def _assemble(self, requests: List[_Request], rows: int) -> Batch:
        cfg = self.config
        bucket_rows = _bucketize(rows, cfg.batch_buckets)
        feed: Dict[str, np.ndarray] = {}
        for name, spec in self.feed_specs.items():
            shape = spec["shape"]
            parts = [r.feed[name] for r in requests]
            # pad dynamic non-batch dims (seq lengths) to a shared
            # bucketed target so differently-shaped requests merge
            dyn_axes = [ax for ax, d in enumerate(shape) if d == -1
                        and ax > 0]
            targets = {ax: _bucketize(max(p.shape[ax] for p in parts),
                                      cfg.seq_buckets)
                       for ax in dyn_axes}
            padded = []
            for p in parts:
                pad = [(0, 0)] * p.ndim
                for ax, tgt in targets.items():
                    pad[ax] = (0, tgt - p.shape[ax])
                if any(hi for _, hi in pad):
                    p = np.pad(p, pad, constant_values=cfg.pad_value)
                padded.append(p)
            merged = np.concatenate(padded, axis=0) if len(padded) > 1 \
                else padded[0]
            if bucket_rows > rows:
                pad = [(0, bucket_rows - rows)] + [(0, 0)] * (merged.ndim - 1)
                merged = np.pad(merged, pad, constant_values=cfg.pad_value)
            feed[name] = merged
        slices, start = [], 0
        for req in requests:
            slices.append((start, start + req.rows))
            start += req.rows
        batch = Batch(feed, requests, slices, rows, bucket_rows)
        if self.metrics:
            self.metrics.batches.inc()
            self.metrics.batch_rows.record(rows)
            self.metrics.batch_fill_ratio.record(batch.fill_ratio)
        return batch
