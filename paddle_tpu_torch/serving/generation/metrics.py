"""Generation metrics: the token-serving analog of ServingMetrics.

The port's copy of ``paddle_tpu/serving/generation/metrics.py``. Each
GenerationMetrics instance claims one ``engine="<label>"`` series in the
shared ``paddle_tpu_decode_*`` families; a GenerationHost additionally
publishes per-model routing families under its own ``host``/``model``
labels (host.py). MFU rides the SAME attribution families the
batch-serving engines use, under a ``job="engine_gen_<label>"`` series.
"""
from __future__ import annotations

import itertools
import json
from typing import Dict, Optional

from ...observability.registry import MetricsRegistry, default_registry

__all__ = ["GenerationMetrics"]

#: monotonically assigned `engine` label values, process-wide (its own
#: pool — batch-serving engines number theirs independently)
_engine_ids = itertools.count()


class GenerationMetrics:
    """All generation-side observability in one place, published under
    ``paddle_tpu_decode_*{engine="gen_<n>"}``:

    - requests/tokens/steps/prefills: volume counters (tokens counts
      GENERATED tokens only, not prompt tokens)
    - retired_total{reason}: every request leaves the slot array
      exactly once — eos, max_tokens, length (hit max_seq_len),
      aborted (breaker trip / non-drain stop), error
    - shed_total{reason}: every request turned away BEFORE taking a
      slot — circuit_open, queue_full, model_budget (host routing)
    - step_seconds / prefill_seconds: device step wall time
    - slots_active / slots_total: continuous-batching occupancy
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 label: Optional[str] = None):
        reg = registry if registry is not None else default_registry()
        self.registry = reg
        self.engine_label = label or f"gen_{next(_engine_ids)}"
        lab = {"engine": self.engine_label}
        self._owned_families = []

        def counter(name, help):
            fam = reg.counter(name, help, ("engine",))
            self._owned_families.append(fam)
            return fam.labels(**lab)

        def gauge(name, help):
            fam = reg.gauge(name, help, ("engine",))
            self._owned_families.append(fam)
            return fam.labels(**lab)

        def histogram(name, help):
            fam = reg.histogram(name, help, ("engine",))
            self._owned_families.append(fam)
            return fam.labels(**lab)

        self.requests = counter(
            "paddle_tpu_decode_requests_total",
            "Generation requests admitted into the continuous-batching "
            "queue.")
        self.tokens = counter(
            "paddle_tpu_decode_tokens_total",
            "Tokens generated (decode-step outputs delivered to live "
            "slots; prompt tokens are not counted).")
        self.steps = counter(
            "paddle_tpu_decode_steps_total",
            "Decode steps dispatched (one bucketed single-token "
            "executable run over the whole slot array).")
        self.prefills = counter(
            "paddle_tpu_decode_prefills_total",
            "Prefill executions (full-prompt forward writing one "
            "request's KV-cache slot).")
        self._retired_family = reg.counter(
            "paddle_tpu_decode_retired_total",
            "Requests retired from the in-flight slot array, by "
            "reason: eos, max_tokens, length (max_seq_len reached), "
            "aborted (breaker trip or non-drain stop delivered partial "
            "tokens), error.", ("engine", "reason"))
        self._shed_family = reg.counter(
            "paddle_tpu_decode_shed_total",
            "Generation requests shed before taking a slot, by reason: "
            "circuit_open (breaker), queue_full (engine queue "
            "capacity), model_budget (per-model host admission).",
            ("engine", "reason"))
        self.step_seconds = histogram(
            "paddle_tpu_decode_step_seconds",
            "Wall time of one decode step (dispatch to materialized "
            "next tokens).")
        self.prefill_seconds = histogram(
            "paddle_tpu_decode_prefill_seconds",
            "Wall time of one prefill (full-prompt forward + KV-cache "
            "slot write).")
        self.slots_active = gauge(
            "paddle_tpu_decode_slots_active",
            "In-flight batch slots occupied at the last decode-step "
            "boundary.")
        self.slots_total = gauge(
            "paddle_tpu_decode_slots_total",
            "Slot capacity of the continuous-batching engine.")
        # lazy attribution registration, same contract as ServingMetrics
        self._attr_job = f"engine_gen_{self.engine_label}"
        self.mfu = None
        self.model_flops = None

    def retired(self, reason: str) -> None:
        self._retired_family.labels(engine=self.engine_label,
                                    reason=reason).inc()

    def shed(self, reason: str) -> None:
        self._shed_family.labels(engine=self.engine_label,
                                 reason=reason).inc()

    def _by_reason(self, family) -> Dict[str, float]:
        out = {}
        for key, child in family.samples():
            if key[0] == self.engine_label:
                out[key[1]] = child.value
        return out

    def set_mfu(self, mfu: float, flops: float) -> None:
        """Publish live decode-step MFU + static per-step FLOPs (lazy
        registration so the attribution kill switch leaves no
        zero-valued series — see ServingMetrics.set_mfu)."""
        if self.mfu is None:
            from ...observability import attribution as _attr
            self.model_flops = _attr.model_flops_gauge(
                self.registry, self._attr_job)
            self.mfu = _attr.mfu_gauge(self.registry, self._attr_job)
        self.mfu.set(mfu)
        self.model_flops.set(flops)

    def retire(self) -> None:
        """Drop every series this engine claimed (host version
        retirement — same cardinality contract as
        ServingMetrics.retire)."""
        key = (self.engine_label,)
        for fam in self._owned_families:
            fam.discard(key)
        for family in (self._retired_family, self._shed_family):
            for k, _ in family.samples():
                if k[0] == self.engine_label:
                    family.discard(k)
        if self.mfu is not None:
            for name in ("paddle_tpu_mfu", "paddle_tpu_model_flops"):
                fam = self.registry.get(name)
                if fam is not None:
                    fam.discard((self._attr_job,))

    def stats(self, executor=None) -> Dict:
        out = {
            "requests": self.requests.value,
            "tokens": self.tokens.value,
            "steps": self.steps.value,
            "prefills": self.prefills.value,
            "slots_active": self.slots_active.value,
            "slots_total": self.slots_total.value,
            "step_seconds": self.step_seconds.snapshot(),
            "prefill_seconds": self.prefill_seconds.snapshot(),
            "retired_by_reason": self._by_reason(self._retired_family),
            "shed_by_reason": self._by_reason(self._shed_family),
            "mfu": self.mfu.value if self.mfu is not None else 0.0,
        }
        if executor is not None:
            cs = dict(executor.cache_stats)
            total = cs["hits"] + cs["misses"]
            cs["hit_rate"] = round(cs["hits"] / total, 6) if total else 0.0
            out["compile_cache"] = cs
        return out

    def stats_json(self, executor=None, **kw) -> str:
        return json.dumps(self.stats(executor=executor), **kw)
