"""GenerationEngine: continuous batching over the in-place-KV decode
programs.

The port's copy of the driver loop of ``paddle_tpu/serving/generation/
engine.py``. One driver thread owns the slot array. Each iteration is a
decode-step boundary:

  1. ADMIT — queued requests take free slots (one prefill each: full
     prompt forward writes the slot's KV rows and emits the first
     greedy token).
  2. STEP — one bucketed decode program over the WHOLE slot array
     (single token per slot, cache-length bucket = smallest >= deepest
     active position + 1). Inactive slots ride along as padding.
  3. RETIRE — each slot's new token is delivered; slots finish
     independently on eos / max_new_tokens / max_seq_len and free
     immediately, so the next iteration's admit refills them.

``mode="reforward"`` is the ablation baseline: no KV cache, every step
re-runs the full causal forward over each row's entire history. The
token stream is greedy either way, so cached-vs-reforward outputs are
bit-comparable.

Failure containment mirrors the batch-serving engine: a step failure
records into the HealthMonitor (consecutive failures trip the breaker
OPEN → submit() sheds with CircuitOpenError), and every in-flight
request is retired with the tokens it already completed
(finish_reason="aborted") rather than dropped — a breaker trip never
loses delivered work; the requests taken from the queue and not yet
admitted fail with the error, which ``last_error`` keeps. Each decode
step fires the ``generation.step`` fault point. Prefills and steps are
``generation::*`` profiler events (cat serving); GenerationMetrics
publishes the volume counters, step/prefill histograms and slot gauges,
and each step's cost and memory plans feed the MFU gauge
(observability/attribution.py, the card's peak) and
``paddle_tpu_memory_peak_bytes``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np

from ... import profiler
from ...observability import attribution as obs_attr
from ...resilience import faults
from ...resilience import health as health_mod
from ...resilience.health import CircuitOpenError, HealthMonitor
from ..batcher import QueueFullError, ServingStopped
from .metrics import GenerationMetrics
from .model import bucket_for

__all__ = ["GenerationConfig", "GenerationResult", "GenerationFuture",
           "GenerationEngine", "QueueFullError", "ServingStopped"]


class GenerationConfig:
    """Knobs for one engine.

    max_new_tokens:     default per-request generation budget.
    queue_capacity:     backpressure bound on waiting (unslotted)
                        requests; submit() raises QueueFullError beyond
                        it.
    idle_wait_s:        driver sleep when no slot is active and no
                        request is queued.
    """

    def __init__(self, max_new_tokens: int = 16,
                 queue_capacity: int = 64, idle_wait_s: float = 0.05):
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.max_new_tokens = int(max_new_tokens)
        self.queue_capacity = int(queue_capacity)
        self.idle_wait_s = float(idle_wait_s)


class GenerationResult:
    """Delivered to the future when a request retires."""

    __slots__ = ("tokens", "finish_reason", "prompt_len")

    def __init__(self, tokens: List[int], finish_reason: str,
                 prompt_len: int):
        self.tokens = list(tokens)
        self.finish_reason = finish_reason
        self.prompt_len = prompt_len

    def __repr__(self):
        return (f"GenerationResult(tokens={self.tokens}, "
                f"finish_reason={self.finish_reason!r}, "
                f"prompt_len={self.prompt_len})")


class GenerationFuture:
    """Single-resolve handle for one generation request."""

    def __init__(self):
        self._event = threading.Event()
        self._result: Optional[GenerationResult] = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, result: GenerationResult):
        self._result = result
        self._event.set()

    def set_exception(self, exc: BaseException):
        self._exc = exc
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> GenerationResult:
        if not self._event.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        if self._exc is not None:
            raise self._exc
        return self._result


class _Request:
    __slots__ = ("prompt", "max_new_tokens", "future", "tokens",
                 "submitted_at")

    def __init__(self, prompt, max_new_tokens, future):
        self.prompt = list(int(t) for t in prompt)
        self.max_new_tokens = max_new_tokens
        self.future = future
        self.tokens: List[int] = []
        self.submitted_at = time.monotonic()


class GenerationEngine:
    """Continuous-batching token server for one GenerationModel."""

    def __init__(self, model, config: Optional[GenerationConfig] = None,
                 metrics: Optional[GenerationMetrics] = None,
                 health: Optional[HealthMonitor] = None,
                 mode: str = "cached"):
        if mode not in ("cached", "reforward"):
            raise ValueError(f"mode must be 'cached' or 'reforward', "
                             f"got {mode!r}")
        self.model = model
        self.spec = model.spec
        self.config = config or GenerationConfig()
        self.metrics = metrics or GenerationMetrics()
        self.health = health or HealthMonitor()
        self.mode = mode
        self._slots: List[Optional[_Request]] = [None] * self.spec.slots
        # per-slot history: [slots, max_seq_len] tokens
        self._history = np.zeros(
            (self.spec.slots, self.spec.max_seq_len), np.int64)
        self._lengths = np.zeros(self.spec.slots, np.int64)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._stopping = False
        self._drain = True
        #: the exception of the most recent failed step, or None
        self.last_error: Optional[BaseException] = None
        # effective sequence ceiling: a step's bucket must cover the
        # deepest active position, so generation retires ("length")
        # before outgrowing the largest bucket this mode can run
        top = (self.spec.cache_buckets[-1] if mode == "cached"
               else self.spec.prompt_buckets[-1])
        self._max_len = min(self.spec.max_seq_len, top)
        self.metrics.slots_total.set(self.spec.slots)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._started:
            raise RuntimeError("generation engine already started")
        self._thread = threading.Thread(target=self._driver_loop,
                                        name="generation-driver",
                                        daemon=True)
        self._started = True
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Close the front door. drain=True (default) finishes every
        queued and in-flight request before the driver exits; False
        retires in-flight requests immediately with their completed
        tokens (finish_reason="aborted") and fails queued ones."""
        with self._wake:
            self._stopping = True
            self._drain = drain
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise TimeoutError("generation driver still draining "
                                   "after timeout")
            self._thread = None

    # -- request path ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None
               ) -> GenerationFuture:
        if not self._started:
            raise RuntimeError("generation engine not started — call "
                               "engine.start() first")
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.spec.prompt_buckets[-1]:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds largest prompt "
                f"bucket {self.spec.prompt_buckets[-1]}")
        budget = int(max_new_tokens if max_new_tokens is not None
                     else self.config.max_new_tokens)
        admit = self.health.allow_request()
        if not admit:
            self.metrics.shed("circuit_open")
            raise CircuitOpenError(
                "generation circuit is open (step failures tripped the "
                "breaker) — request shed; see engine.stats()['health']")
        try:
            fut = GenerationFuture()
            with self._wake:
                if self._stopping:
                    raise ServingStopped(
                        "generation engine is stopping")
                if len(self._queue) >= self.config.queue_capacity:
                    self.metrics.shed("queue_full")
                    raise QueueFullError(
                        f"generation queue at capacity "
                        f"({self.config.queue_capacity})")
                self._queue.append(_Request(prompt, budget, fut))
                self.metrics.requests.inc()
                self._wake.notify_all()
            return fut
        except BaseException:
            # admitted but never queued: hand back a consumed half-open
            # probe slot (only then — see ServingEngine.submit)
            if admit is health_mod.PROBE:
                self.health.release_probe()
            raise

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None) -> GenerationResult:
        """Synchronous submit + wait."""
        return self.submit(prompt, max_new_tokens).result(timeout=timeout)

    # -- observability -----------------------------------------------------
    def stats(self):
        out = self.metrics.stats(executor=self.model.executor)
        with self._lock:
            out["queued"] = len(self._queue)
            out["active"] = sum(1 for s in self._slots if s is not None)
        out["mode"] = self.mode
        out["slots"] = self.spec.slots
        out["cache_buckets"] = list(self.spec.cache_buckets)
        out["started"] = self._started
        out["stopping"] = self._stopping
        out["health"] = self.health.snapshot()
        return out

    # -- driver ------------------------------------------------------------
    def _driver_loop(self):
        while True:
            abort_now = False
            with self._wake:
                while (not self._stopping and not self._queue
                       and not any(s is not None for s in self._slots)):
                    self._wake.wait(timeout=self.config.idle_wait_s)
                if self._stopping:
                    if not self._drain:
                        abort_now = True
                    elif (not self._queue and
                          not any(s is not None for s in self._slots)):
                        return  # drained
                pending = deque()
                while self._queue:
                    pending.append(self._queue.popleft())
            if abort_now:
                stopped = ServingStopped(
                    "generation engine stopped without drain")
                for req in pending:
                    self.metrics.retired("aborted")
                    req.future.set_exception(stopped)
                self._abort_all(stopped)
                return
            try:
                self._admit(pending)
                if any(s is not None for s in self._slots):
                    self._step()
            except Exception as e:  # noqa: BLE001 — the driver must live
                # a failed step leaves every active slot's cache state
                # suspect: retire them all with the tokens they already
                # completed, count the failure toward the breaker (the
                # breaker, not a dead thread, decides whether to shed)
                # and keep the loop alive; the requests taken from the
                # queue and not admitted (the one whose prefill failed
                # first) fail with the error
                self.last_error = e
                self.health.record_failure(e)
                for req in pending:
                    self.metrics.retired("error")
                    req.future.set_exception(e)
                self._abort_all(e, reason="error")
            self.metrics.slots_active.set(
                sum(1 for s in self._slots if s is not None))

    def _abort_all(self, exc: BaseException, reason: str = "aborted"):
        """Retire every in-flight slot (delivering completed tokens —
        a failure or stop never drops delivered work; counted under
        `reason`) and fail the queue."""
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            self._slots[i] = None
            self._lengths[i] = 0
            self.metrics.retired(reason)
            req.future.set_result(GenerationResult(
                req.tokens, "aborted", len(req.prompt)))
        with self._lock:
            queued, self._queue = list(self._queue), deque()
        for req in queued:
            self.metrics.retired("aborted")
            req.future.set_exception(exc)

    # -- admit -------------------------------------------------------------
    def _admit(self, pending: deque):
        """Fill free slots from the queue; in cached mode each
        admission is one prefill (prompt forward + KV slot write + first
        token)."""
        requeue = []
        while pending:
            slot = next((i for i, s in enumerate(self._slots)
                         if s is None), None)
            if slot is None:
                requeue.extend(pending)
                pending.clear()
                break
            req = pending.popleft()
            if self.mode == "cached":
                t0 = time.monotonic()
                try:
                    with profiler.RecordEvent(
                            f"generation::prefill[{len(req.prompt)}]",
                            cat=profiler.CAT_SERVING):
                        tok = self.model.run_prefill(req.prompt, slot)
                except BaseException:
                    pending.appendleft(req)
                    raise
                self.metrics.prefills.inc()
                self.metrics.prefill_seconds.record(
                    time.monotonic() - t0)
                self.health.record_success()
                self._install(slot, req)
                self._deliver_token(slot, req, tok)
            else:
                self._install(slot, req)
        if requeue:
            with self._lock:
                self._queue.extendleft(reversed(requeue))

    def _install(self, slot: int, req: _Request):
        self._slots[slot] = req
        p = len(req.prompt)
        self._history[slot, :] = 0
        self._history[slot, :p] = req.prompt
        self._lengths[slot] = p

    # -- step --------------------------------------------------------------
    def _step(self):
        faults.fire("generation.step")
        if self.mode == "cached":
            self._step_cached()
        else:
            self._step_reforward()
        self.metrics.steps.inc()

    def _active(self):
        return [i for i, s in enumerate(self._slots) if s is not None]

    def _step_cached(self):
        """One in-place-KV decode step: feed each active slot's last
        token at its own cache position; inactive slots ride as padding
        (they write garbage at position 0 of their row, which the next
        prefill into that row overwrites)."""
        active = self._active()
        positions = np.zeros(self.spec.slots, np.int64)
        tokens = np.zeros(self.spec.slots, np.int64)
        for i in active:
            positions[i] = self._lengths[i] - 1  # last token's position
            tokens[i] = self._history[i, self._lengths[i] - 1]
        depth = int(max(positions[i] for i in active)) + 1
        bucket = bucket_for(depth, self.spec.cache_buckets)
        if bucket is None:  # deepest slot exceeded every bucket
            bucket = self.spec.cache_buckets[-1]
        t0 = time.monotonic()
        with profiler.RecordEvent(
                f"generation::decode_step[{bucket}]",
                cat=profiler.CAT_SERVING):
            next_tokens = self.model.run_decode(tokens, positions, bucket)
        self._observe_step(t0)
        for i in active:
            self._deliver_token(i, self._slots[i], int(next_tokens[i]))

    def _step_reforward(self):
        """Ablation baseline: full causal forward over every active
        row's whole history — what serving costs without the KV cache."""
        active = self._active()
        depth = int(max(self._lengths[i] for i in active))
        bucket = bucket_for(depth, self.spec.prompt_buckets)
        if bucket is None:
            bucket = self.spec.prompt_buckets[-1]
        matrix = self._history[:, :bucket]
        lengths = np.maximum(self._lengths, 1)  # inactive rows: dummy 1
        t0 = time.monotonic()
        with profiler.RecordEvent(
                f"generation::reforward_step[{bucket}]",
                cat=profiler.CAT_SERVING):
            next_tokens = self.model.run_full(matrix, lengths, bucket)
        self._observe_step(t0)
        for i in active:
            self._deliver_token(i, self._slots[i], int(next_tokens[i]))

    def _observe_step(self, t0: float):
        t1 = time.monotonic()
        self.health.record_success()
        self.metrics.step_seconds.record(t1 - t0)
        if obs_attr.attribution_enabled():
            cost = self.model.last_cost()
            if cost is not None and cost.flops and t1 > t0:
                self.metrics.set_mfu(
                    cost.flops / obs_attr.peak_flops() / (t1 - t0),
                    cost.flops)
        mem = self.model.last_memory()
        if mem is not None:
            from ...analysis.memory import publish_peak
            publish_peak(self.metrics._attr_job, mem.peak_bytes)

    # -- retire ------------------------------------------------------------
    def _deliver_token(self, slot: int, req: _Request, tok: int):
        """Append one generated token to a slot's stream and retire the
        slot if the request is finished."""
        req.tokens.append(tok)
        length = int(self._lengths[slot])
        if length < self.spec.max_seq_len:
            self._history[slot, length] = tok
        self._lengths[slot] = length + 1
        self.metrics.tokens.inc()
        reason = None
        if tok == self.spec.eos_id:
            reason = "eos"
        elif len(req.tokens) >= req.max_new_tokens:
            reason = "max_tokens"
        elif self._lengths[slot] >= self._max_len:
            reason = "length"
        if reason is not None:
            self._slots[slot] = None
            self._lengths[slot] = 0
            self.metrics.retired(reason)
            req.future.set_result(GenerationResult(
                req.tokens, reason, len(req.prompt)))
