"""Serving health: consecutive-failure / error-rate circuit breaker +
rolling health monitor.

The port's copy of ``paddle_tpu/resilience/health.py``. After
`failure_threshold` consecutive batch failures (or, in rate mode, a
windowed error rate at the threshold) the circuit OPENS and the engines'
``submit()`` fast-fails with CircuitOpenError (no queueing, no model
run). After `reset_timeout_s` the breaker goes HALF_OPEN and admits a
limited probe; one successful batch closes the circuit, a failed probe
re-opens it. The HealthMonitor composes the breaker with a rolling
error-rate window and last-error capture, rendered JSON-able for the
engines' ``stats()``. Live breakers mirror their state into the metrics
registry (``paddle_tpu_circuit_breaker_*``) through a global collector,
and a trip dumps a flight-recorder bundle (reason ``circuit_open``).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
import weakref
from typing import Callable, Dict, Optional

from ..observability.registry import add_global_collector

__all__ = ["CircuitBreaker", "CircuitOpenError", "HealthMonitor",
           "CLOSED", "OPEN", "HALF_OPEN", "PROBE"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: gauge encoding for paddle_tpu_circuit_breaker_state
_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

#: live breakers, each holding a stable `breaker="<n>"` label; the
#: scrape-time collector below mirrors their state into the metrics
#: registry and prunes series whose breaker was garbage-collected
_breaker_ids = itertools.count()
_live_breakers: "weakref.WeakSet[CircuitBreaker]" = weakref.WeakSet()


def _collect_breaker_metrics(reg) -> None:
    state_g = reg.gauge(
        "paddle_tpu_circuit_breaker_state",
        "Serving circuit-breaker state: 0 closed, 1 open (shedding), "
        "2 half-open (probing).", ("breaker",))
    opened = reg.counter(
        "paddle_tpu_circuit_breaker_opened_total",
        "Times this breaker tripped open.", ("breaker",))
    shed = reg.counter(
        "paddle_tpu_circuit_breaker_shed_total",
        "Requests fast-failed while this breaker was open.", ("breaker",))
    live = list(_live_breakers)
    keys = set()
    for b in live:
        snap = b.snapshot()
        keys.add((b._obs_label,))
        state_g.labels(breaker=b._obs_label).set(
            _STATE_CODE.get(snap["state"], -1))
        opened.labels(breaker=b._obs_label).set_total(
            snap["opened_total"])
        shed.labels(breaker=b._obs_label).set_total(snap["shed_total"])
    for fam in (state_g, opened, shed):
        fam.retain(keys)


add_global_collector(_collect_breaker_metrics)

#: truthy sentinel returned by allow_request() when the admission
#: consumed a half-open probe slot — callers that fail to turn the
#: request into a batch should release_probe() ONLY in that case
PROBE = "probe"


class CircuitOpenError(RuntimeError):
    """Fast-fail: the serving circuit is open (load shedding)."""


class CircuitBreaker:
    """Breaker over batch outcomes with two trip modes.

    Consecutive mode (always on): `failure_threshold` consecutive
    failures open the circuit — the broken-model case, where every
    batch fails.

    Windowed error-*rate* mode (on when `error_rate_threshold` is set):
    the failure fraction over the last `error_rate_window` outcomes
    reaching the threshold opens the circuit, once at least
    `error_rate_min_samples` outcomes are in the window. This catches
    the slow trickle — poisoned rows failing one batch in three never
    build a consecutive streak, but they do hold a 33% error rate. The
    window is cleared on every open (stale failures must not instantly
    re-trip the circuit a successful half-open probe just closed).

    failure_threshold: consecutive failures that open the circuit.
    reset_timeout_s:   open -> half-open cooldown.
    half_open_probes:  requests admitted while half-open (the probe
                       budget; replenished on each open -> half-open
                       transition).
    error_rate_threshold: failure fraction in [0, 1] that opens the
                       circuit (None = rate mode off).
    error_rate_window: rolling outcome window for the rate.
    error_rate_min_samples: outcomes required before the rate can trip
                       (a floor, so one failure in an empty window is
                       not a 100% error rate).
    clock:             injectable monotonic clock for tests.
    """

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 5.0,
                 half_open_probes: int = 1,
                 error_rate_threshold: Optional[float] = None,
                 error_rate_window: int = 64,
                 error_rate_min_samples: int = 16,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if error_rate_threshold is not None and \
                not 0.0 < error_rate_threshold <= 1.0:
            raise ValueError("error_rate_threshold must be in (0, 1]")
        if error_rate_min_samples < 1:
            raise ValueError("error_rate_min_samples must be >= 1")
        if error_rate_threshold is not None and \
                int(error_rate_window) < int(error_rate_min_samples):
            # the deque's maxlen would cap the sample count BELOW the
            # floor, so the rate mode the caller explicitly enabled
            # could never trip — refuse instead of silently disarming
            raise ValueError(
                f"error_rate_window ({error_rate_window}) must be >= "
                f"error_rate_min_samples ({error_rate_min_samples}); "
                "a window smaller than the min-samples floor can never "
                "accumulate enough outcomes to trip")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_probes = int(half_open_probes)
        self.error_rate_threshold = error_rate_threshold
        self.error_rate_min_samples = int(error_rate_min_samples)
        self._window: "collections.deque[bool]" = collections.deque(
            maxlen=int(error_rate_window))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_budget = 0
        self._probe_taken_at: Optional[float] = None
        self.opened_total = 0   # times the circuit opened
        self.shed_total = 0     # requests fast-failed while open
        # self-registration with the metrics registry: a stable series
        # label for this breaker's lifetime; the module collector
        # mirrors snapshot() into paddle_tpu_circuit_breaker_* at
        # scrape time and drops the series once we're collected
        self._obs_label = str(next(_breaker_ids))
        _live_breakers.add(self)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _maybe_half_open_locked(self):
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.reset_timeout_s:
            self._state = HALF_OPEN
            self._probe_budget = self.half_open_probes
            self._probe_taken_at = None
        elif self._state == HALF_OPEN and self._probe_budget == 0 \
                and self._probe_taken_at is not None \
                and self._clock() - self._probe_taken_at \
                >= self.reset_timeout_s:
            # liveness guard: an admitted probe that never produced a
            # batch outcome (queue-expired, crashed client) would wedge
            # the breaker half-open with no budget; after a further
            # cooldown, hand out a fresh probe
            self._probe_budget = self.half_open_probes
            self._probe_taken_at = None

    def allow_request(self):
        """Submit-side gate. Falsy = shed this request now; truthy =
        admitted (the PROBE sentinel marks an admission that consumed a
        half-open probe slot and must be release_probe()d if the
        request never becomes a batch)."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and self._probe_budget > 0:
                self._probe_budget -= 1
                self._probe_taken_at = self._clock()
                return PROBE
            self.shed_total += 1
            return False

    def release_probe(self) -> None:
        """Return an admitted probe slot whose request never became a
        batch (e.g. the queue rejected it), so the next request can
        probe instead of waiting out the liveness guard."""
        with self._lock:
            if self._state == HALF_OPEN and \
                    self._probe_budget < self.half_open_probes:
                self._probe_budget += 1

    def record_success(self) -> None:
        """A batch completed: a half-open probe's success closes the
        circuit; while OPEN, a straggler batch dispatched before the
        trip is not evidence about recovery — ignored (cooldown +
        probe still required)."""
        with self._lock:
            if self._state == OPEN:
                return
            self._consecutive_failures = 0
            self._window.append(True)
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self._opened_at = None

    def _error_rate_locked(self) -> float:
        n = len(self._window)
        return (1.0 - sum(self._window) / n) if n else 0.0

    def record_failure(self) -> None:
        """A batch failed: re-open a half-open probe immediately, or
        open once the consecutive-failure streak hits the threshold —
        or, in rate mode, once the windowed error rate does."""
        tripped = False
        with self._lock:
            if self._state == OPEN:
                # straggler from a batch dispatched before the trip:
                # the circuit is already open and the freshly-cleared
                # window must not be poisoned, or the first ordinary
                # failure after a successful probe would instantly
                # re-trip over ~100% stale history
                return
            self._consecutive_failures += 1
            self._window.append(False)
            rate_trip = (
                self.error_rate_threshold is not None
                and len(self._window) >= self.error_rate_min_samples
                and self._error_rate_locked() >= self.error_rate_threshold)
            if self._state == HALF_OPEN or (
                    self._state == CLOSED and
                    (self._consecutive_failures >= self.failure_threshold
                     or rate_trip)):
                self._state = OPEN
                self._opened_at = self._clock()
                self._probe_budget = 0
                self.opened_total += 1
                # the window restarts with the circuit: outcomes from
                # before the trip must not re-trip it right after a
                # successful probe closes it
                self._window.clear()
                tripped = True
        if tripped:
            # flight-recorder trigger (outside the breaker lock: the
            # dump snapshots the registry, whose collector re-reads
            # this breaker's state): the bundle holds the serving
            # events leading up to the trip
            from ..observability.flight_recorder import record_failure \
                as _flight_dump
            _flight_dump("circuit_open",
                         context={"breaker": self._obs_label,
                                  "opened_total": self.opened_total})

    def snapshot(self) -> Dict:
        with self._lock:
            self._maybe_half_open_locked()
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "failure_threshold": self.failure_threshold,
                "reset_timeout_s": self.reset_timeout_s,
                "error_rate_threshold": self.error_rate_threshold,
                "window_error_rate": round(self._error_rate_locked(), 6),
                "window_samples": len(self._window),
                "opened_total": self.opened_total,
                "shed_total": self.shed_total,
            }


class HealthMonitor:
    """Rolling batch-outcome window + breaker, one `record_*` call per
    batch from the serving workers; `snapshot()` is the JSON-able health
    block in `ServingEngine.stats()`."""

    def __init__(self, breaker: Optional[CircuitBreaker] = None,
                 window: int = 128):
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._outcomes = collections.deque(maxlen=window)
        self._lock = threading.Lock()
        self._last_error: Optional[str] = None
        self._last_error_time: Optional[float] = None

    def allow_request(self):
        return self.breaker.allow_request()

    def release_probe(self) -> None:
        self.breaker.release_probe()

    def record_success(self) -> None:
        with self._lock:
            self._outcomes.append(True)
        self.breaker.record_success()

    def record_failure(self, exc: Optional[BaseException] = None) -> None:
        with self._lock:
            self._outcomes.append(False)
            if exc is not None:
                self._last_error = repr(exc)
                self._last_error_time = time.time()
        self.breaker.record_failure()

    @property
    def error_rate(self) -> float:
        """Failure fraction over the rolling window (0.0 when empty)."""
        with self._lock:
            if not self._outcomes:
                return 0.0
            return 1.0 - sum(self._outcomes) / len(self._outcomes)

    @property
    def healthy(self) -> bool:
        return self.breaker.state == CLOSED

    def snapshot(self) -> Dict:
        with self._lock:
            n = len(self._outcomes)
            rate = (1.0 - sum(self._outcomes) / n) if n else 0.0
            last_error = self._last_error
            last_error_time = self._last_error_time
        return {
            "error_rate": round(rate, 6),
            "window": n,
            "last_error": last_error,
            "last_error_time": last_error_time,
            "breaker": self.breaker.snapshot(),
        }
