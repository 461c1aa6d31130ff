"""Deterministic fault injection for chaos testing.

The port's copy of ``paddle_tpu/resilience/faults.py``: named fault
points — cheap no-op hooks at the failure-prone call sites — that a test
arms with raise/delay schedules, deterministically under a fixed seed.
The port fires ``checkpoint.write`` and ``checkpoint.read``
(distributed/checkpoint.py), ``reader.next`` (reader/__init__.py
``batch()`` per yielded batch, ``FeedPrefetcher`` per pulled batch, in
its producer thread), ``dataset.download`` (dataset/common.py, before
each transfer attempt), ``serving.admission`` (serving/admission.py,
per admission check: a fault is a fast shed), ``serving.batch``
(serving/engine.py, per batch run), ``serving.swap`` (serving/
lifecycle.py, at ModelHost.swap's phase boundaries: a fault rolls the
swap back) and ``generation.step`` (serving/generation/engine.py, per
decode step: a fault retires the in-flight requests with their tokens
and counts toward the breaker). The other names of ``FAULT_POINTS``
belong to modules not ported yet; arming one is allowed, as in the JAX
package.

`fire(point)` is on hot paths (per batch), so the disabled cost is one
module-global read and an `is None` test. All bookkeeping lives on the
armed `FaultInjector`, which installs itself process-wide for the
duration of a `with` scope and restores the previous injector on exit
(scopes nest; nothing leaks).

    with FaultInjector(seed=7) as fi:
        fi.on("checkpoint.write", raises=OSError, times=2)
        fi.on("reader.next", delay_s=0.01, probability=0.2)
        ...exercise the system...
        assert fi.triggered("checkpoint.write") == 2
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Type, Union

__all__ = ["FaultInjector", "FaultError", "fire", "active", "FAULT_POINTS"]

#: the documented points; `on()` warns-by-raising for typos against this
#: set unless the rule is registered with `unchecked=True`.
FAULT_POINTS = frozenset({
    "checkpoint.write", "checkpoint.read", "master.rpc", "pserver.push",
    "serving.batch", "serving.swap", "serving.admission", "reader.next",
    "reader.shard", "dataset.download", "generation.step",
})

_active: Optional["FaultInjector"] = None


class FaultError(RuntimeError):
    """Raised by a rule armed with neither raises= nor delay_s= (the
    default injection). Deliberately NOT in retry.DEFAULT_RETRYABLE, so
    a bare injected fault fails hard unless the test opts a retryable
    exception type in."""


def fire(point: str) -> None:
    """Fault-point hook. Inert (a global read + None test) unless a
    FaultInjector scope is active."""
    inj = _active
    if inj is not None:
        inj._fire(point)


def active() -> Optional["FaultInjector"]:
    """The currently installed injector, or None (the normal state)."""
    return _active


class _Rule:
    __slots__ = ("raises", "delay_s", "times", "every", "after",
                 "probability", "triggers")

    def __init__(self, raises, delay_s, times, every, after, probability):
        self.raises = raises
        self.delay_s = delay_s
        self.times = times
        self.every = every
        self.after = after
        self.probability = probability
        self.triggers = 0

    def should_trigger(self, call_no: int, rng: random.Random) -> bool:
        """call_no is 1-based per fault point."""
        if self.times is not None and self.triggers >= self.times:
            return False
        if call_no <= self.after:
            return False
        if self.every is not None and \
                (call_no - self.after) % self.every != 0:
            return False
        if self.probability is not None and \
                rng.random() >= self.probability:
            return False
        return True


class FaultInjector:
    """Seed-deterministic fault schedule, installed process-wide inside a
    `with` scope (or via install()/uninstall()). Thread-safe: serving
    workers and trainer threads may hit points concurrently."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._rules: Dict[str, List[_Rule]] = {}
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._prev: Optional[FaultInjector] = None
        self._installed = False

    # -- schedule ------------------------------------------------------
    def on(self, point: str, *,
           raises: Union[BaseException, Type[BaseException], None] = None,
           delay_s: Optional[float] = None,
           times: Optional[int] = None,
           every: Optional[int] = None,
           after: int = 0,
           probability: Optional[float] = None,
           unchecked: bool = False) -> "FaultInjector":
        """Arm `point` with a fault schedule. Returns self for chaining.

        raises:      exception class (instantiated per trigger with a
                     descriptive message) or instance to raise; when
                     neither raises nor delay_s is given, defaults to
                     FaultError.
        delay_s:     sleep this long on trigger (before raising, if both).
        times:       trigger at most this many times (one-shot: times=1).
        every:       trigger on every Nth call to the point.
        after:       skip the first `after` calls.
        probability: trigger with this probability (injector-seed
                     deterministic).
        """
        if not unchecked and point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; known: "
                f"{sorted(FAULT_POINTS)} (use unchecked=True for ad-hoc "
                "points)")
        if raises is None and delay_s is None:
            raises = FaultError
        with self._lock:
            self._rules.setdefault(point, []).append(
                _Rule(raises, delay_s, times, every, after, probability))
        return self

    # -- firing --------------------------------------------------------
    def _fire(self, point: str) -> None:
        with self._lock:
            rules = self._rules.get(point)
            n = self._calls.get(point, 0) + 1
            self._calls[point] = n
            if not rules:
                return
            delay = None
            exc = None
            for rule in rules:
                if not rule.should_trigger(n, self._rng):
                    continue
                rule.triggers += 1
                if rule.delay_s is not None:
                    delay = rule.delay_s
                if rule.raises is not None:
                    exc = rule.raises
                    break  # first raising rule wins
        # sleep/raise outside the lock so a delay fault never serializes
        # unrelated fault points
        if delay is not None:
            time.sleep(delay)
        if exc is not None:
            if isinstance(exc, type):
                raise exc(f"injected fault at {point!r}")
            raise exc

    # -- introspection -------------------------------------------------
    def calls(self, point: str) -> int:
        """How many times execution reached `point` in this scope."""
        with self._lock:
            return self._calls.get(point, 0)

    def triggered(self, point: str) -> int:
        """How many faults actually fired at `point`."""
        with self._lock:
            return sum(r.triggers for r in self._rules.get(point, ()))

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            points = set(self._calls) | set(self._rules)
            return {p: {"calls": self._calls.get(p, 0),
                        "triggered": sum(
                            r.triggers for r in self._rules.get(p, ()))}
                    for p in sorted(points)}

    # -- installation --------------------------------------------------
    def install(self) -> "FaultInjector":
        global _active
        if self._installed:
            raise RuntimeError("injector already installed")
        self._prev, _active = _active, self
        self._installed = True
        return self

    def uninstall(self) -> None:
        global _active
        if not self._installed:
            return
        if _active is not self:
            raise RuntimeError(
                "out-of-order uninstall: another injector was installed "
                "over this one and not removed")
        _active = self._prev
        self._prev = None
        self._installed = False

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False
