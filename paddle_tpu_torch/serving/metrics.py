"""Serving metrics: a thin facade over the process-wide observability
MetricsRegistry.

The port's copy of ``paddle_tpu/serving/metrics.py``: each ServingMetrics
instance claims one ``engine="<n>"`` label in the shared
``paddle_tpu_serving_*`` families (the JAX package's names), so one
scrape shows every live engine while ``stats()`` keeps its JSON shape.
Host-side timing additionally flows through
``profiler.RecordEvent(..., cat=profiler.CAT_SERVING)`` in the engine.
"""
from __future__ import annotations

import itertools
import json
from typing import Dict, Optional

# re-exported for call sites that construct standalone instruments
from ..observability.registry import (Counter, Gauge,  # noqa: F401
                                      Histogram, MetricsRegistry,
                                      default_registry)

__all__ = ["ServingMetrics", "Counter", "Gauge", "Histogram"]

#: monotonically assigned `engine` label values — one per
#: ServingMetrics instance, process-wide
_engine_ids = itertools.count()


class ServingMetrics:
    """All serving-side observability in one place, published to the
    registry under ``paddle_tpu_serving_*{engine="<n>"}``.

    - requests/rejections/timeouts/errors: request-level counters
      (breaker-shed requests are counted by the CircuitBreaker itself
      — one source of truth — and surfaced as stats()["shed"] by the
      engine)
    - batches: batch-level counter; batch_fill_ratio: real rows / bucket
      rows per flushed batch (1.0 = no padding waste)
    - queue_depth: rows waiting, sampled on every submit/flush
    - latency_s: request wall time submit -> result
    - compile cache hits/misses come from the engine's Executor
      (`Executor.cache_stats`) at snapshot time
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = registry if registry is not None else default_registry()
        self.registry = reg
        self.engine_label = str(next(_engine_ids))
        lab = {"engine": self.engine_label}
        # families this instance claimed a series in, for retire()
        self._owned_families = []

        def counter(name, help):
            fam = reg.counter(name, help, ("engine",))
            self._owned_families.append(fam)
            return fam.labels(**lab)

        def histogram(name, help):
            fam = reg.histogram(name, help, ("engine",))
            self._owned_families.append(fam)
            return fam.labels(**lab)

        self.requests = counter(
            "paddle_tpu_serving_requests_total",
            "Requests accepted by the dynamic batcher.")
        self.rejected = counter(
            "paddle_tpu_serving_rejected_total",
            "Requests rejected by queue backpressure (QueueFullError).")
        self.timeouts = counter(
            "paddle_tpu_serving_timeouts_total",
            "Requests that expired in the queue before being batched.")
        self.errors = counter(
            "paddle_tpu_serving_errors_total",
            "Requests failed by a batch dispatch/delivery error.")
        # the complete rejection ledger: EVERY request turned away
        # before reaching a batch lands here exactly once, by reason —
        # queue_depth / latency_p99 / fault (admission layer),
        # circuit_open (breaker), queue_full (batcher backpressure)
        self._shed_family = reg.counter(
            "paddle_tpu_serving_shed_total",
            "Requests shed before batching, by reason: queue_depth and "
            "latency_p99 (admission limits), fault (injected admission "
            "fault), circuit_open (breaker), queue_full (batcher "
            "backpressure).", ("engine", "reason"))
        self.batches = counter(
            "paddle_tpu_serving_batches_total",
            "Batches flushed by the dynamic batcher.")
        self.warmup_compiles = counter(
            "paddle_tpu_serving_warmup_compiles_total",
            "Executables compiled during engine warmup.")
        _depth_fam = reg.gauge(
            "paddle_tpu_serving_queue_depth_rows",
            "Rows waiting in the dynamic batcher queue (sampled on "
            "every submit/flush).", ("engine",))
        self._owned_families.append(_depth_fam)
        self.queue_depth = _depth_fam.labels(**lab)
        self.batch_fill_ratio = histogram(
            "paddle_tpu_serving_batch_fill_ratio",
            "Real rows / padded bucket rows per flushed batch "
            "(1.0 = no padding waste).")
        self.batch_rows = histogram(
            "paddle_tpu_serving_batch_rows",
            "Real (unpadded) rows per flushed batch.")
        self.latency_s = histogram(
            "paddle_tpu_serving_latency_seconds",
            "Request wall time, submit to result delivery.")
        self.queue_wait_s = histogram(
            "paddle_tpu_serving_queue_wait_seconds",
            "Request wall time, submit to batch dispatch.")
        # live attribution: MFU + static model FLOPs of this engine's
        # compiled executable, published under the SAME families the
        # trainer uses (job label distinguishes producers). Registered
        # lazily at the first publication so the attribution kill
        # switch leaves NO zero-valued mfu series behind (the engine
        # never calls set_mfu while attribution is off).
        self._attr_job = f"engine_{self.engine_label}"
        self.mfu = None
        self.model_flops = None

    def shed(self, reason: str) -> None:
        """Count one shed request under `reason` in the
        paddle_tpu_serving_shed_total ledger."""
        self._shed_family.labels(engine=self.engine_label,
                                 reason=reason).inc()

    def shed_by_reason(self) -> Dict[str, float]:
        """This engine's shed counts keyed by reason (JSON-able)."""
        out = {}
        for key, child in self._shed_family.samples():
            if key[0] == self.engine_label:
                out[key[1]] = child.value
        return out

    def retire(self) -> None:
        """Drop every registry series this engine claimed. Called by
        the ModelHost when a version is permanently retired (a
        rolled-back candidate, or the drained-out old version after a
        completed swap) — a long-lived host swapping a new checkpoint
        every few hours must not grow /metrics cardinality and
        histogram-window memory without bound. The instance's own
        instrument references keep working (stats() still answers);
        only the shared scrape forgets the series, the way it forgets
        a garbage-collected breaker's."""
        key = (self.engine_label,)
        for fam in self._owned_families:
            fam.discard(key)
        for k, _ in self._shed_family.samples():
            if k[0] == self.engine_label:
                self._shed_family.discard(k)
        if self.mfu is not None:
            for name in ("paddle_tpu_mfu", "paddle_tpu_model_flops"):
                fam = self.registry.get(name)
                if fam is not None:
                    fam.discard((self._attr_job,))

    def set_mfu(self, mfu: float, flops: float) -> None:
        """Engine callback after each completed batch: publish the live
        MFU and the static per-batch FLOPs of the dispatched
        executable."""
        if self.mfu is None:
            from ..observability import attribution as _attr
            # same-parameter re-registration is idempotent, so a race
            # between worker threads lands on the same family; mfu is
            # assigned LAST because it is the guard — a concurrent
            # worker that sees it non-None must find model_flops set
            self.model_flops = _attr.model_flops_gauge(
                self.registry, self._attr_job)
            self.mfu = _attr.mfu_gauge(self.registry, self._attr_job)
        self.mfu.set(mfu)
        self.model_flops.set(flops)

    def stats(self, executor=None) -> Dict:
        """JSON-able snapshot; pass the engine's Executor to fold in
        compile-cache hit/miss counters."""
        out = {
            "requests": self.requests.value,
            "rejected": self.rejected.value,
            "timeouts": self.timeouts.value,
            "errors": self.errors.value,
            "batches": self.batches.value,
            "warmup_compiles": self.warmup_compiles.value,
            "queue_depth": self.queue_depth.value,
            "batch_fill_ratio": self.batch_fill_ratio.snapshot(),
            "batch_rows": self.batch_rows.snapshot(),
            "latency_s": self.latency_s.snapshot(),
            "queue_wait_s": self.queue_wait_s.snapshot(),
            "shed_by_reason": self.shed_by_reason(),
            "mfu": self.mfu.value if self.mfu is not None else 0.0,
            "model_flops": self.model_flops.value
            if self.model_flops is not None else 0.0,
        }
        if executor is not None:
            cs = dict(executor.cache_stats)
            total = cs["hits"] + cs["misses"]
            cs["hit_rate"] = round(cs["hits"] / total, 6) if total else 0.0
            out["compile_cache"] = cs
        return out

    def stats_json(self, executor=None, **kw) -> str:
        return json.dumps(self.stats(executor=executor), **kw)
