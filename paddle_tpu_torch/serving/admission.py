"""Admission control: shed load *fast* instead of queueing unbounded.

The port's copy of ``paddle_tpu/serving/admission.py``. The admission
layer sits in front of `DynamicBatcher.submit` and rejects with a fast
`ServiceOverloadedError` (no queueing, no model run, O(1) checks) when
either signal crosses its configured limit:

- **queue depth**: rows already waiting in the batcher
  (`paddle_tpu_serving_queue_depth_rows`) exceed `max_queue_rows`;
- **rolling p99**: the engine's request-latency p99, read from the
  `paddle_tpu_serving_latency_seconds` histogram window, exceeds
  `max_p99_s`. The percentile is recomputed at most every
  `p99_refresh_s`.

Every shed is counted in `paddle_tpu_serving_shed_total{reason=}` (the
engine also routes breaker sheds and batcher-backpressure rejections
into the same ledger). A shed *storm* — more than
`shed_storm_threshold` sheds inside `shed_storm_window_s` — triggers a
flight-recorder bundle (reason ``shed_storm``).

The `serving.admission` fault point fires inside every check; an
injected fault surfaces as a shed (`ServiceOverloadedError`), never a
hang.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

from ..resilience import faults

__all__ = ["AdmissionConfig", "AdmissionController",
           "ServiceOverloadedError"]


class ServiceOverloadedError(RuntimeError):
    """Fast-fail: admission control shed this request (overload)."""

    def __init__(self, msg: str, reason: str = "overload"):
        super().__init__(msg)
        self.reason = reason


class AdmissionConfig:
    """Limits for the admission layer.

    max_queue_rows:       shed when the batcher already holds more than
                          this many queued rows (None = no depth limit).
    max_p99_s:            shed when rolling request-latency p99 exceeds
                          this (None = no latency limit).
    p99_min_samples:      latency observations required before the p99
                          limit can shed (a cold engine must admit).
    p99_refresh_s:        recompute the cached p99 at most this often.
    shed_storm_threshold: sheds inside the window that count as a storm
                          (flight-recorder trigger; None = never).
    shed_storm_window_s:  the storm-rate window.
    """

    def __init__(self, max_queue_rows: Optional[int] = None,
                 max_p99_s: Optional[float] = None,
                 p99_min_samples: int = 32,
                 p99_refresh_s: float = 0.25,
                 shed_storm_threshold: Optional[int] = 100,
                 shed_storm_window_s: float = 1.0):
        if max_queue_rows is not None and max_queue_rows < 1:
            raise ValueError("max_queue_rows must be >= 1")
        if max_p99_s is not None and max_p99_s <= 0:
            raise ValueError("max_p99_s must be > 0")
        self.max_queue_rows = max_queue_rows
        self.max_p99_s = max_p99_s
        self.p99_min_samples = int(p99_min_samples)
        self.p99_refresh_s = float(p99_refresh_s)
        self.shed_storm_threshold = shed_storm_threshold
        self.shed_storm_window_s = float(shed_storm_window_s)


class AdmissionController:
    """Per-engine admission gate: `check()` returns (admitting) or
    raises ServiceOverloadedError (shedding). Constructed by
    ServingEngine from an AdmissionConfig; reads the engine's batcher
    for depth and its ServingMetrics latency histogram for p99."""

    def __init__(self, config: AdmissionConfig, batcher, metrics):
        self.config = config
        self.batcher = batcher
        self.metrics = metrics
        self._lock = threading.Lock()
        self._p99_cache = 0.0
        self._p99_cached_at: Optional[float] = None
        self._shed_times: "collections.deque[float]" = collections.deque()
        self.shed_total = 0
        self.admitted_total = 0

    # -- signals -------------------------------------------------------
    def _rolling_p99(self, now: float) -> float:
        # single-flight: the recompute happens UNDER the lock, so an
        # expired cache costs one window sort per refresh interval.
        # Recomputing outside it would let every concurrent submit —
        # i.e. exactly the overload burst admission defends against —
        # sort the 8192-sample window simultaneously. The histogram's
        # own lock nests inside ours and nothing acquires them in the
        # other order.
        with self._lock:
            if self._p99_cached_at is not None and \
                    now - self._p99_cached_at < self.config.p99_refresh_s:
                return self._p99_cache
            hist = self.metrics.latency_s
            p99 = hist.percentile(99.0) if hist.count >= \
                self.config.p99_min_samples else 0.0
            self._p99_cache = p99
            self._p99_cached_at = now
            return p99

    # -- the gate ------------------------------------------------------
    def check(self) -> None:
        """Admit (return) or shed (raise ServiceOverloadedError)."""
        cfg = self.config
        try:
            faults.fire("serving.admission")
        except BaseException as e:
            # an admission fault is an overload answer, not a hang:
            # whatever broke inside the gate, the client gets the same
            # fast shed it would get from a crossed limit
            self._shed("fault")
            raise ServiceOverloadedError(
                f"admission check failed ({e!r}) — request shed",
                reason="fault") from e
        if cfg.max_queue_rows is not None:
            depth = self.batcher.pending_rows
            if depth > cfg.max_queue_rows:
                self._shed("queue_depth")
                raise ServiceOverloadedError(
                    f"queue depth {depth} rows exceeds admission limit "
                    f"{cfg.max_queue_rows} — request shed",
                    reason="queue_depth")
        if cfg.max_p99_s is not None:
            p99 = self._rolling_p99(time.monotonic())
            if p99 > cfg.max_p99_s:
                self._shed("latency_p99")
                raise ServiceOverloadedError(
                    f"rolling p99 {p99 * 1e3:.1f}ms exceeds admission "
                    f"limit {cfg.max_p99_s * 1e3:.1f}ms — request shed",
                    reason="latency_p99")
        with self._lock:
            self.admitted_total += 1

    def _shed(self, reason: str) -> None:
        self.metrics.shed(reason)
        cfg = self.config
        storm = False
        now = time.monotonic()
        with self._lock:
            self.shed_total += 1
            if cfg.shed_storm_threshold is not None:
                self._shed_times.append(now)
                cutoff = now - cfg.shed_storm_window_s
                while self._shed_times and self._shed_times[0] < cutoff:
                    self._shed_times.popleft()
                storm = len(self._shed_times) >= cfg.shed_storm_threshold
        if storm:
            # rate-limited per reason by the recorder itself, so a
            # sustained storm costs one bundle per min_interval_s, not
            # one per shed
            from ..observability.flight_recorder import record_failure
            record_failure("shed_storm", context={
                "reason": reason,
                "sheds_in_window": len(self._shed_times),
                "window_s": cfg.shed_storm_window_s,
                "queue_rows": self.batcher.pending_rows,
            })

    def snapshot(self) -> Dict:
        oldest_wait_s = self.batcher.oldest_wait_s
        with self._lock:
            return {
                "admitted_total": self.admitted_total,
                "shed_total": self.shed_total,
                "max_queue_rows": self.config.max_queue_rows,
                "max_p99_s": self.config.max_p99_s,
                "rolling_p99_s": round(self._p99_cache, 6),
                # backlog age: a growing oldest-wait means the workers
                # are not keeping up even while depth sits under limit
                "oldest_wait_s": round(oldest_wait_s, 6),
            }
