"""Retry with exponential backoff + jitter.

The port's copy of ``paddle_tpu/resilience/retry.py``: the one retry
layer that checkpoint save and load share. A `RetryPolicy` is immutable
configuration; `call()` executes a thunk under it. Backoff is
exponential with decorrelating jitter, bounded by `max_delay_s` and an
overall `deadline_s`. Which exceptions retry is the policy's `retryable`
filter — everything else propagates immediately. `name` labels the
operation in messages and metrics.

Observability: every retry is counted in a module-level registry
(`retry_counters()`) keyed by the operation name, and recorded as a
``retry::<name>`` profiler event spanning the backoff sleep
(cat=profiler.CAT_RESILIENCE). The counters mirror themselves into the
metrics registry at scrape time
(paddle_tpu_retry_{calls,retries,failures}_total{op=...}) through a
global collector.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, Tuple, Type, Union

from .. import profiler
from ..observability.registry import add_global_collector

__all__ = ["RetryPolicy", "RetryError", "retry_counters",
           "reset_retry_counters", "DEFAULT_RETRYABLE"]

#: network + I/O failures that are usually transient. ConnectionError is
#: an OSError subclass; listed for readability.
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    ConnectionError, OSError, TimeoutError)

_counters = {}
_counters_lock = threading.Lock()


def _count(name: str, key: str, n: int = 1):
    with _counters_lock:
        c = _counters.setdefault(
            name, {"calls": 0, "retries": 0, "failures": 0})
        c[key] += n


def retry_counters() -> dict:
    """{op name: {calls, retries, failures}} accumulated process-wide."""
    with _counters_lock:
        return {k: dict(v) for k, v in _counters.items()}


def reset_retry_counters() -> None:
    with _counters_lock:
        _counters.clear()


def _collect_retry_metrics(reg) -> None:
    """Scrape-time mirror of `_counters` into the metrics registry.
    Registered as a global collector so it follows default-registry
    swaps. After a reset_retry_counters() the exposed series DROP to
    the new totals (Counter.set_total passes decreases through) —
    Prometheus rate()/increase() read that as a counter reset, which
    is the correct signal."""
    counters = retry_counters()
    if not counters:
        return
    families = {
        "calls": reg.counter(
            "paddle_tpu_retry_calls_total",
            "Operations executed under a RetryPolicy, by op name.",
            ("op",)),
        "retries": reg.counter(
            "paddle_tpu_retry_retries_total",
            "Retry attempts taken (one backoff sleep each), by op name.",
            ("op",)),
        "failures": reg.counter(
            "paddle_tpu_retry_failures_total",
            "Operations that failed terminally (non-retryable, attempts "
            "exhausted, or deadline exceeded), by op name.", ("op",)),
    }
    for op, c in counters.items():
        for key, fam in families.items():
            fam.labels(op=op).set_total(c[key])


add_global_collector(_collect_retry_metrics)


class RetryError(RuntimeError):
    """Raised when the deadline expires between attempts; carries the
    last attempt's exception as __cause__."""


class RetryPolicy:
    """Exponential backoff with jitter, attempt cap, and deadline.

    max_attempts: total tries including the first (1 = no retry).
    base_delay_s / multiplier / max_delay_s: attempt k (0-based retry
        index) backs off base * multiplier**k, capped at max_delay_s.
    jitter: fraction of the delay randomized symmetrically around it
        (0.1 -> uniform in [0.9d, 1.1d]). Deterministic given `seed`.
    deadline_s: overall wall-clock budget from the first attempt; when
        the next backoff would land past it, raise RetryError instead.
    retryable: exception types (or predicate exc -> bool) that retry.
    sleep / clock: injectable for tests (virtual time).
    """

    def __init__(self, max_attempts: int = 5, base_delay_s: float = 0.05,
                 multiplier: float = 2.0, max_delay_s: float = 2.0,
                 jitter: float = 0.1,
                 deadline_s: Optional[float] = None,
                 retryable: Union[Tuple[Type[BaseException], ...],
                                  Callable[[BaseException], bool]]
                 = DEFAULT_RETRYABLE,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.multiplier = float(multiplier)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.deadline_s = deadline_s
        # a bare exception class is callable, so without this it would
        # fall into the predicate branch and retry EVERYTHING
        if isinstance(retryable, type) and \
                issubclass(retryable, BaseException):
            retryable = (retryable,)
        self.retryable = retryable
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock

    def _is_retryable(self, exc: BaseException) -> bool:
        if callable(self.retryable) and \
                not isinstance(self.retryable, tuple):
            return bool(self.retryable(exc))
        return isinstance(exc, self.retryable)

    def delay(self, retry_index: int) -> float:
        """Backoff before retry `retry_index` (0-based), jittered."""
        d = min(self.base_delay_s * (self.multiplier ** retry_index),
                self.max_delay_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def call(self, fn: Callable, *args,
             name: str = "retry",
             on_retry: Optional[Callable[[int, BaseException], None]]
             = None, **kwargs):
        """Run fn(*args, **kwargs) under this policy; returns its value.

        on_retry(retry_index, exc) runs before each backoff sleep (e.g.
        to close a broken socket so the next attempt reconnects)."""
        _count(name, "calls")
        t0 = self._clock()
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except BaseException as exc:
                last = attempt == self.max_attempts - 1
                if last or not self._is_retryable(exc):
                    _count(name, "failures")
                    raise
                d = self.delay(attempt)
                if self.deadline_s is not None and \
                        self._clock() - t0 + d > self.deadline_s:
                    _count(name, "failures")
                    raise RetryError(
                        f"{name}: deadline {self.deadline_s}s would be "
                        f"exceeded after {attempt + 1} attempt(s)"
                    ) from exc
                _count(name, "retries")
                if on_retry is not None:
                    on_retry(attempt, exc)
                with profiler.RecordEvent(f"retry::{name}",
                                          cat=profiler.CAT_RESILIENCE):
                    if d:
                        self._sleep(d)

    def wrap(self, fn: Callable, name: Optional[str] = None,
             on_retry: Optional[Callable] = None) -> Callable:
        """Decorate fn so every invocation runs under this policy."""
        label = name or getattr(fn, "__name__", "retry")

        def wrapped(*args, **kwargs):
            return self.call(fn, *args, name=label, on_retry=on_retry,
                             **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped

    #: single-attempt policy: call sites take an Optional[RetryPolicy]
    #: and fall back to this, keeping one code path.
    NONE: "RetryPolicy"


RetryPolicy.NONE = RetryPolicy(max_attempts=1)
