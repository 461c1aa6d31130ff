"""Serving lifecycle: atomic zero-downtime weight hot-swap with canary
and automatic rollback.

The port's copy of ``paddle_tpu/serving/lifecycle.py``. `ModelHost` takes
a new checkpoint without a restart, without dropping an in-flight
request, and without betting the whole process on an unproven artifact:

    host = ModelHost("model_v1_dir").start()
    out, = host.predict({"x": batch})          # normal traffic
    report = host.swap("model_v2_dir",         # zero-downtime deploy
                       canary_fraction=0.1)
    assert report["outcome"] == "completed"

The swap sequence (each phase a `serving.swap` fault point — any
failure anywhere in it rolls back to the prior version):

1. **Load + verify**: the candidate loads through `ServableModel.load`,
   which re-runs the static verifier — the deploy gate.
2. **Precompile**: the candidate's engine warms one compiled step per
   batch bucket (on the card its workers capture each bucket's CUDA
   graph) while the old version keeps serving.
3. **Canary**: a configurable fraction of submits routes to the
   candidate, with per-version breaker and error-rate tracking. A
   canary request that fails is transparently retried on the stable
   version — the client never sees a bad canary, the host counts it.
4. **Evaluate -> cut over or roll back**: if the candidate's breaker
   trips or its canary error rate crosses the threshold, the candidate
   is stopped and the old version keeps serving. Otherwise the router
   pointer flips atomically: new requests land on the candidate,
   requests already queued on the old version drain to completion, and
   only then is the old engine stopped.

Rollback writes a flight-recorder bundle (reason ``rollback``) and
counts `paddle_tpu_serving_swaps_total{outcome="rolled_back"}`; the
current/previous deploy identity is exported as
`paddle_tpu_serving_model_version{host=,version=}` (1 = live, 0 =
retired) and canary traffic as
`paddle_tpu_serving_canary_requests_total{outcome=}`. One host, one
process.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, Optional, Union

from ..observability.registry import MetricsRegistry, default_registry
from ..resilience import faults
from ..resilience.health import HealthMonitor
from .admission import AdmissionConfig
from .batcher import BatchingConfig, ServingStopped
from .engine import ServingEngine
from .metrics import ServingMetrics
from .model import ServableModel

__all__ = ["ModelHost", "SwapError"]

_host_ids = itertools.count()

_SWAPS_HELP = ("Hot-swap attempts by this ModelHost, by outcome "
               "(completed, rolled_back).")
_CANARY_HELP = ("Requests routed to a swap candidate during its canary "
                "phase, by outcome (success, failure). Failed canary "
                "requests are retried on the stable version, so a "
                "failure here is NOT a client-visible failure.")
_VERSION_HELP = ("Deploy identity per ModelHost: 1 for the live model "
                 "version, 0 for retired/rolled-back ones.")


class SwapError(RuntimeError):
    """A hot-swap could not even reach the rollback path (e.g. the host
    is stopped, or a swap is already in progress)."""


class _Version:
    """One deployed model version: the servable, its engine, and the
    host-side canary tally."""

    __slots__ = ("name", "model", "engine")

    def __init__(self, name: str, model: ServableModel,
                 engine: ServingEngine):
        self.name = name
        self.model = model
        self.engine = engine


class _FallbackFuture:
    """Future for a canary-routed request: waits on the candidate,
    and on failure transparently retries on the stable version —
    recording the canary outcome either way. The client only fails if
    the STABLE version also fails (or the time budget is exhausted)."""

    __slots__ = ("_host", "_version", "_feed", "_fut", "_outcome_sent",
                 "_retry_lock", "_retry_final")

    def __init__(self, host: "ModelHost", version: str, feed, fut):
        self._host = host
        self._version = version
        self._feed = feed
        self._fut = fut
        self._outcome_sent = False
        self._retry_lock = threading.Lock()
        self._retry_final = None  # ("ok", value) | ("err", exc)

    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None):
        t0 = time.monotonic()
        try:
            out = self._fut.result(timeout=timeout)
        except (KeyboardInterrupt, SystemExit):
            # a client-side interrupt says nothing about the candidate:
            # neither a canary verdict nor grounds for a stable retry
            raise
        except BaseException as e:
            self._record(False)
            # the retry is cached: the canary future re-raises its
            # failure on every result() call, and without the cache a
            # done()-poll-then-result pattern (or a second consumer)
            # would submit a DUPLICATE inference per extra call
            with self._retry_lock:
                if self._retry_final is None:
                    remaining = None
                    if timeout is not None:
                        remaining = timeout - (time.monotonic() - t0)
                        if remaining <= 0:
                            # budget exhausted: nothing to retry with
                            # (not cached — a later, larger budget may)
                            raise
                    try:
                        self._retry_final = ("ok", self._host.
                                             _stable_result(self._feed,
                                                            remaining, e))
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except BaseException as stable_exc:
                        self._retry_final = ("err", stable_exc)
            kind, val = self._retry_final
            if kind == "err":
                raise val
            return val
        self._record(True)
        return out

    def _record(self, ok: bool) -> None:
        if not self._outcome_sent:  # client may call result() twice
            self._outcome_sent = True
            self._host._canary_outcome(self._version, ok)


class ModelHost:
    """Owns the live ServingEngine for one model and performs atomic
    hot-swaps of new versions into it.

    model:          a ServableModel or a `save_inference_model`
                    directory for the initial version.
    config:         BatchingConfig shared by every version's engine.
    admission:      optional AdmissionConfig applied to every version's
                    engine (load shedding under overload).
    num_workers:    worker threads per engine.
    health_factory: builds each version's HealthMonitor (per-version
                    breaker); default = consecutive-failure breaker
                    with an error-rate trip mode, so both the
                    everything-broken and the trickle-poison candidate
                    trip during canary.
    registry:       metrics registry (default: process registry).
    version:        deploy identity for the initial version (default:
                    the artifact's model_version metadata, else "v1").
    device:         torch device of the versions loaded from a
                    directory (None: the first CUDA card; "cpu" on a
                    machine without one).
    """

    def __init__(self, model: Union[str, ServableModel],
                 config: Optional[BatchingConfig] = None,
                 admission: Optional[AdmissionConfig] = None,
                 num_workers: int = 1,
                 health_factory: Optional[Callable[[], HealthMonitor]]
                 = None,
                 registry: Optional[MetricsRegistry] = None,
                 version: Optional[str] = None,
                 warmup: bool = True, device=None):
        self._device = device
        self._config = config or BatchingConfig()
        self._admission = admission
        self._num_workers = int(num_workers)
        self._health_factory = health_factory or _default_health
        self._registry = registry if registry is not None \
            else default_registry()
        self._warmup = bool(warmup)
        self.host_label = str(next(_host_ids))
        reg = self._registry
        self._swaps = reg.counter("paddle_tpu_serving_swaps_total",
                                  _SWAPS_HELP, ("host", "outcome"))
        self._canary_counter = reg.counter(
            "paddle_tpu_serving_canary_requests_total", _CANARY_HELP,
            ("host", "outcome"))
        self._version_gauge = reg.gauge(
            "paddle_tpu_serving_model_version", _VERSION_HELP,
            ("host", "version"))
        # router state: _route_lock is held only for pointer reads and
        # flips — never across a submit, a model run, or a drain — so
        # the front door cannot stall on swap machinery
        self._route_lock = threading.Lock()
        self._current: Optional[_Version] = None
        self._canary: Optional[_Version] = None
        self._canary_permille = 0
        self._route_counter = 0
        self._canary_ok = 0
        self._canary_fail = 0
        self._version_seq = itertools.count(1)
        self._swap_in_progress = False  # guarded by _route_lock
        self._previous: Optional[_Version] = None
        self._stopped = False
        self._initial_model = model
        self._initial_version = version

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ModelHost":
        """Load (if needed), verify, and start serving the initial
        version."""
        if self._current is not None:
            raise RuntimeError("host already started")
        if self._stopped:
            raise RuntimeError("host was stopped; build a new one")
        model = self._load(self._initial_model)
        name = (self._initial_version or model.version
                or f"v{next(self._version_seq)}")
        self._current = self._start_version(model, name)
        self._activate_gauge(name)
        self._initial_model = None  # the host owns the version now
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop serving; with drain=True every accepted request
        completes first. A swap still in flight sees the flag at its
        next phase boundary and rolls back (its candidate engine is
        stopped by the rollback path), so no engine outlives the
        host."""
        with self._route_lock:
            self._stopped = True  # under the lock: a concurrent
            # swap's cutover check cannot miss it and flip afterwards
            cur, can = self._current, self._canary
            self._canary = None
            self._canary_permille = 0
        for rec in (can, cur):
            if rec is not None:
                rec.engine.stop(drain=drain, timeout=timeout)

    # -- request path --------------------------------------------------
    def submit(self, feed: Dict[str, Any]):
        """Route one request: to the canary engine for the configured
        fraction during a swap's canary phase, else to the current
        version. Returns a future with .result(timeout)."""
        while True:
            with self._route_lock:
                cur = self._current
                can = self._canary
                to_canary = False
                if can is not None and self._canary_permille > 0:
                    self._route_counter += 1
                    to_canary = (self._route_counter % 1000) \
                        < self._canary_permille
            if cur is None:
                raise RuntimeError(
                    "host not started — call host.start()")
            if to_canary:
                try:
                    fut = can.engine.submit(feed)
                except Exception:
                    # the canary engine would not even take the request
                    # (shed, stopping mid-rollback): not a model
                    # verdict — route to the stable version instead of
                    # failing the client or skewing the canary rate
                    pass
                else:
                    return _FallbackFuture(self, can.name, feed, fut)
            try:
                return cur.engine.submit(feed)
            except ServingStopped:
                with self._route_lock:
                    retired = self._current is not cur
                if not retired:
                    raise  # the HOST stopped: a real answer
                # a cutover retired this engine between the pointer
                # read and the submit — a request must never fail on
                # swap machinery; re-route to the new current version

    def predict(self, feed: Dict[str, Any],
                timeout: Optional[float] = None):
        return self.submit(feed).result(timeout=timeout)

    def _stable_result(self, feed, timeout, canary_exc):
        """Retry a failed canary request on the current stable
        version (rollback may already have flipped it back)."""
        while True:
            with self._route_lock:
                cur = self._current
            try:
                return cur.engine.submit(feed).result(timeout=timeout)
            except ServingStopped as e:
                with self._route_lock:
                    retired = self._current is not cur
                if not retired:
                    raise e from canary_exc
                # cutover raced the retry: re-route (same as submit)
            except BaseException as e:
                raise e from canary_exc

    def _canary_outcome(self, version: str, ok: bool) -> None:
        with self._route_lock:
            # only tally outcomes for the canary that is still armed: a
            # straggler client resolving a PREVIOUS swap's fallback
            # future must not pollute the current swap's verdict
            if self._canary is not None and self._canary.name == version:
                if ok:
                    self._canary_ok += 1
                else:
                    self._canary_fail += 1
        self._canary_counter.labels(
            host=self.host_label,
            outcome="success" if ok else "failure").inc()

    # -- swap ----------------------------------------------------------
    def swap(self, model: Union[str, ServableModel],
             canary_fraction: float = 0.1,
             canary_min_requests: int = 20,
             canary_max_error_rate: float = 0.25,
             canary_timeout_s: float = 30.0,
             drain_timeout_s: Optional[float] = 120.0,
             version: Optional[str] = None,
             share_executor: bool = False) -> Dict:
        """Atomically hot-swap `model` in as the serving version.

        Returns a JSON-able report with outcome "completed" or
        "rolled_back" — rollback (breaker trip, canary error rate over
        threshold, or any swap-machinery failure) leaves the prior
        version serving untouched and never raises for a candidate
        problem. Zero accepted requests are dropped either way.

        canary_fraction:       share of submits routed to the candidate
                               during canary (0 = skip the canary phase
                               and cut over after precompile).
        canary_min_requests:   canary outcomes to observe before the
                               verdict (the min-samples floor).
        canary_max_error_rate: canary failure fraction that rolls back.
        canary_timeout_s:      max wall time to wait for canary
                               outcomes; on expiry the verdict uses
                               whatever was observed (zero traffic
                               counts as zero failures).
        share_executor:        load the candidate onto the live
                               version's Executor (one compile cache,
                               one run lock for both versions). Off by
                               default: the compile-cache key includes
                               the program identity, so cross-version
                               reuse is nil, while precompile holding
                               the SHARED run lock stalls the live
                               version's completions for the warm-up
                               runs — a latency blip the default (own
                               executor, no contention) avoids. Either
                               way warmup fills the cache the candidate
                               will serve from, so the first
                               post-cutover request never plans.
        """
        if not 0.0 <= canary_fraction <= 1.0:
            raise ValueError("canary_fraction must be in [0, 1]")
        with self._route_lock:
            if self._swap_in_progress:
                raise SwapError("a swap is already in progress")
            self._swap_in_progress = True
        try:
            if self._current is None or self._stopped:
                raise SwapError("host is not serving")
            return self._swap_locked(
                model, canary_fraction, canary_min_requests,
                canary_max_error_rate, canary_timeout_s,
                drain_timeout_s, version, share_executor)
        finally:
            with self._route_lock:
                self._swap_in_progress = False

    def _swap_locked(self, model, fraction, min_requests, max_error_rate,
                     canary_timeout_s, drain_timeout_s, version,
                     share_executor) -> Dict:
        t_start = time.monotonic()
        durations: Dict[str, float] = {}
        candidate: Optional[_Version] = None
        cur = self._current
        with self._route_lock:  # a prior swap's tally must not leak in
            self._canary_ok = 0
            self._canary_fail = 0
        phase = "load"
        try:
            faults.fire("serving.swap")
            t0 = time.monotonic()
            cand_model = self._load(
                model,
                executor=cur.model.executor if share_executor else None,
                run_lock=cur.model._run_lock if share_executor else None)
            name = (version or cand_model.version
                    or f"v{next(self._version_seq)}")
            durations["load"] = time.monotonic() - t0

            phase = "precompile"
            t0 = time.monotonic()
            # start() warms one executable per batch bucket — compiled
            # into the shared cache while the old version keeps serving
            candidate = self._start_version(cand_model, name)
            faults.fire("serving.swap")
            durations["precompile"] = time.monotonic() - t0

            phase = "canary"
            t0 = time.monotonic()
            if fraction > 0.0:
                self._run_canary(candidate, fraction, min_requests,
                                 max_error_rate, canary_timeout_s)
            durations["canary"] = time.monotonic() - t0

            phase = "cutover"
            faults.fire("serving.swap")
            with self._route_lock:
                if self._stopped:
                    # host.stop() raced the swap: never flip the router
                    # of a stopped host (the candidate engine would
                    # keep running with no API path left to stop it)
                    raise _RollbackSignal("host_stopped")
                # final pre-flip verdict under the router lock: no new
                # canary outcome can land between check and cut
                self._check_canary_locked(candidate, max_error_rate)
                old, self._current = self._current, candidate
                self._canary = None
                self._canary_permille = 0
        except _RollbackSignal as sig:
            return self._rollback(candidate, cur, sig.reason, None,
                                  durations, t_start)
        except (KeyboardInterrupt, SystemExit) as e:
            # roll back (the stable version keeps serving), but the
            # interrupt itself must propagate, not become a report
            self._rollback(candidate, cur, f"{phase}_interrupted", e,
                           durations, t_start)
            raise
        except BaseException as e:
            return self._rollback(candidate, cur, f"{phase}_failed", e,
                                  durations, t_start)

        # -- the cut is durable from here: never roll back past it ----
        self._activate_gauge(candidate.name, retired=old.name)
        self._swaps.labels(host=self.host_label,
                           outcome="completed").inc()
        t0 = time.monotonic()
        # requests accepted by the old version before the flip drain to
        # completion; only then do its workers exit. Its weights stay
        # pinned (self._previous) until the NEXT swap retires them —
        # the rolled-back-to state of a future rollback is guaranteed
        # intact. A drain failure (timeout on a wedged old batch) must
        # NOT raise out of a swap that already completed — the caller
        # would retry a version that is already live — so it is
        # reported, not thrown.
        drain_error = None
        try:
            old.engine.stop(drain=True, timeout=drain_timeout_s)
        except Exception as e:
            drain_error = repr(e)
        durations["drain"] = time.monotonic() - t0
        old.engine.metrics.retire()  # scrape forgets the dead engine
        self._previous = old
        durations["total"] = time.monotonic() - t_start
        report = self._report("completed", old.name, candidate.name,
                              None, durations)
        if drain_error is not None:
            report["drain_error"] = drain_error
        return report

    def _run_canary(self, candidate: _Version, fraction: float,
                    min_requests: int, max_error_rate: float,
                    timeout_s: float) -> None:
        with self._route_lock:
            # the tally was zeroed at swap entry and cannot move while
            # _canary is None (outcomes are version-guarded), so arming
            # is the only reset point needed here
            self._canary = candidate
            self._canary_permille = max(1, int(round(fraction * 1000)))
        deadline = time.monotonic() + timeout_s
        while True:
            if self._stopped:
                raise _RollbackSignal("host_stopped")
            brk = candidate.engine.health.breaker
            if brk.state == "open" or brk.opened_total > 0:
                raise _RollbackSignal("breaker_tripped")
            with self._route_lock:
                ok, fail = self._canary_ok, self._canary_fail
            n = ok + fail
            if n >= max(1, min_requests):
                if fail / n > max_error_rate:
                    raise _RollbackSignal("canary_error_rate")
                return  # verdict: healthy
            if time.monotonic() >= deadline:
                # low traffic: judge whatever was observed — zero
                # outcomes is zero failures, not a rollback
                if n and fail / n > max_error_rate:
                    raise _RollbackSignal("canary_error_rate")
                return
            time.sleep(0.005)

    def _check_canary_locked(self, candidate: _Version,
                             max_error_rate: float) -> None:
        brk = candidate.engine.health.breaker
        if brk.state == "open" or brk.opened_total > 0:
            raise _RollbackSignal("breaker_tripped")
        n = self._canary_ok + self._canary_fail
        if n and self._canary_fail / n > max_error_rate:
            raise _RollbackSignal("canary_error_rate")

    def _rollback(self, candidate: Optional[_Version], cur: _Version,
                  reason: str, exc: Optional[BaseException],
                  durations: Dict[str, float], t_start: float) -> Dict:
        # stop routing to the candidate FIRST: from here every submit
        # lands on the untouched stable version
        with self._route_lock:
            self._canary = None
            self._canary_permille = 0
            ok, fail = self._canary_ok, self._canary_fail
        cand_name = candidate.name if candidate is not None else None
        if candidate is not None:
            try:
                # drain, don't axe: in-flight canary batches resolve,
                # and their clients' fallback futures retry on stable
                candidate.engine.stop(drain=True, timeout=30.0)
            except Exception:
                pass
            candidate.engine.metrics.retire()
            # the candidate was never live: drop its series rather than
            # minting a permanent 0-gauge for every failed deploy
            # (swaps_total{outcome="rolled_back"} and the rollback
            # flight bundle carry the signal)
            self._version_gauge.discard((self.host_label,
                                         candidate.name))
        self._swaps.labels(host=self.host_label,
                           outcome="rolled_back").inc()
        from ..observability.flight_recorder import record_failure
        record_failure("rollback", exc=exc, context={
            "host": self.host_label, "reason": reason,
            "stable_version": cur.name, "candidate_version": cand_name,
            "canary_ok": ok, "canary_fail": fail,
        })
        durations["total"] = time.monotonic() - t_start
        return self._report("rolled_back", cur.name, cand_name,
                            reason if exc is None else
                            f"{reason}: {exc!r}", durations)

    # -- helpers -------------------------------------------------------
    def _load(self, model, executor=None, run_lock=None) -> ServableModel:
        if isinstance(model, ServableModel):
            return model
        # loading runs the static verifier — the deploy gate
        return ServableModel.load(model, executor=executor,
                                  run_lock=run_lock, device=self._device)

    def _start_version(self, model: ServableModel,
                       name: str) -> _Version:
        engine = ServingEngine(
            model, config=self._config,
            metrics=ServingMetrics(self._registry),
            num_workers=self._num_workers,
            health=self._health_factory(),
            admission=self._admission)
        try:
            engine.start(warmup=self._warmup)
        except BaseException:
            # the engine never served: release its claimed series so a
            # failing-candidate retry loop cannot grow the registry
            engine.metrics.retire()
            raise
        return _Version(name, model, engine)

    def _activate_gauge(self, live: str,
                        retired: Optional[str] = None) -> None:
        if retired is not None:
            # keep at most two series per host — the live version (1)
            # and the just-retired one (0, so dashboards see the
            # transition); anything older is discarded, or a host
            # swapping every few hours grows scrape cardinality with
            # every deploy it ever made
            keep = {live, retired}
            for key, _ in self._version_gauge.samples():
                if key[0] == self.host_label and key[1] not in keep:
                    self._version_gauge.discard(key)
            self._version_gauge.labels(host=self.host_label,
                                       version=retired).set(0)
        self._version_gauge.labels(host=self.host_label,
                                   version=live).set(1)

    def _report(self, outcome, from_version, to_version, error,
                durations) -> Dict:
        with self._route_lock:
            ok, fail = self._canary_ok, self._canary_fail
        n = ok + fail
        return {
            "outcome": outcome,
            "from_version": from_version,
            "to_version": to_version,
            "error": error,
            "canary": {"successes": ok, "failures": fail,
                       "error_rate": round(fail / n, 6) if n else 0.0},
            "durations_s": {k: round(v, 6)
                            for k, v in durations.items()},
        }

    # -- observability -------------------------------------------------
    @property
    def current_version(self) -> Optional[str]:
        with self._route_lock:
            return self._current.name if self._current else None

    def stats(self) -> Dict:
        """JSON-able host snapshot: versions + per-engine stats."""
        with self._route_lock:
            cur, can, prev = self._current, self._canary, self._previous
            ok, fail = self._canary_ok, self._canary_fail
        out = {
            "host": self.host_label,
            "current_version": cur.name if cur else None,
            "canary_version": can.name if can else None,
            "previous_version": prev.name if prev else None,
            "canary": {"successes": ok, "failures": fail},
        }
        if cur is not None:
            out["engine"] = cur.engine.stats()
        if can is not None:
            out["canary_engine"] = can.engine.stats()
        return out


class _RollbackSignal(Exception):
    """Internal: a rollback condition detected by the swap machinery
    itself (carries the reason; not a candidate-raised error)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _default_health() -> HealthMonitor:
    """Per-version default: consecutive-failure breaker AND a windowed
    error-rate trip (the trickle-poison closure) — a candidate failing
    one batch in three trips during canary even though it never builds
    a consecutive streak."""
    from ..resilience.health import CircuitBreaker
    return HealthMonitor(CircuitBreaker(
        failure_threshold=5, error_rate_threshold=0.5,
        error_rate_window=64, error_rate_min_samples=8))
