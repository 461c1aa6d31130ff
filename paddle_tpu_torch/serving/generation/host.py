"""GenerationHost: one host process serving N named generation models.

The port's copy of ``paddle_tpu/serving/generation/host.py``. Sharing
contract: every hosted model is built/loaded onto ONE Executor (on the
host's device) and ONE run lock — all prefill/decode steps of all models
live in one compile cache, and device dispatch is serialized host-wide.
Each model keeps a private Scope, so weights and KV-cache state never
alias across models.

Per-model isolation: each model gets its own GenerationEngine (own
slot array, queue, circuit breaker, metrics series) plus a host-level
admission budget — a bound on that model's in-flight + queued requests.

Swap: ``swap(name, candidate)`` builds the candidate on the shared
executor while the old version keeps serving, probes it with real
generations (canary), and only then flips routing. The old engine
drains — every in-flight request finishes on the weights it started
with, so a swap never drops a completed token. Probe failure rolls
back: the candidate is discarded, the old version never stopped.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Optional, Union

from ...observability.registry import MetricsRegistry, default_registry
from ...resilience.health import HealthMonitor
from ..admission import ServiceOverloadedError
from .engine import GenerationConfig, GenerationEngine, GenerationFuture
from .metrics import GenerationMetrics
from .model import GenerationModel, GenerationSpec

__all__ = ["GenerationHost", "GenerationSwapError"]

_host_ids = itertools.count()

_HOST_REQ_HELP = ("Generation requests routed by the host, per hosted "
                  "model.")
_HOST_SWAP_HELP = ("Generation model hot-swaps, by outcome: completed, "
                   "rolled_back.")
_HOST_MODELS_HELP = "Generation models currently hosted."


class GenerationSwapError(RuntimeError):
    """A swap failed for a host/machinery reason (unknown model, swap
    already in progress) — candidate-quality failures roll back and
    report instead of raising."""


class _Hosted:
    __slots__ = ("model", "engine", "metrics", "budget", "version")

    def __init__(self, model, engine, metrics, budget, version):
        self.model = model
        self.engine = engine
        self.metrics = metrics
        self.budget = budget
        self.version = version


class GenerationHost:
    """Routes generation requests to N independently-served models that
    share one executor compile cache, on `device` (None: the first CUDA
    card; "cpu" on a machine without one)."""

    def __init__(self, config: Optional[GenerationConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 default_budget: Optional[int] = None, device=None):
        from ... import flags
        self._device = device
        self._config = config or GenerationConfig()
        self._registry = registry if registry is not None \
            else default_registry()
        self._default_budget = (
            int(default_budget) if default_budget is not None
            else int(flags.get("PADDLE_TPU_DECODE_MODEL_BUDGET")))
        self.host_label = f"gh{next(_host_ids)}"
        reg = self._registry
        self._routed = reg.counter(
            "paddle_tpu_decode_host_requests_total", _HOST_REQ_HELP,
            ("host", "model"))
        self._swaps = reg.counter(
            "paddle_tpu_decode_host_swaps_total", _HOST_SWAP_HELP,
            ("host", "outcome"))
        self._models_gauge = reg.gauge(
            "paddle_tpu_decode_host_models", _HOST_MODELS_HELP,
            ("host",)).labels(host=self.host_label)
        # ONE executor + run lock for every hosted model (shared compile
        # cache); created lazily at first deploy so an empty host is
        # free
        self._executor = None
        self._run_lock = threading.Lock()
        self._route_lock = threading.Lock()
        self._hosted: Dict[str, _Hosted] = {}
        self._swap_in_progress = False
        self._stopped = False

    # -- deploy --------------------------------------------------------
    def _materialize(self, model: Union[str, GenerationModel,
                                        GenerationSpec]) -> GenerationModel:
        """str -> load artifact; GenerationSpec -> fresh build; model ->
        adopt (must already share this host's executor)."""
        executor = self.executor
        if isinstance(model, str):
            return GenerationModel.load(model, executor=executor,
                                        run_lock=self._run_lock)
        if isinstance(model, GenerationSpec):
            return GenerationModel.build(model, executor=executor,
                                         run_lock=self._run_lock)
        if model.executor is not executor:
            raise ValueError(
                "hosted models must share the host executor — deploy "
                "with a directory path or GenerationSpec, or build the "
                "model with executor=host.executor, "
                "run_lock=host.run_lock")
        return model

    @property
    def executor(self):
        if self._executor is None:
            from ...executor import Executor
            self._executor = Executor(place=self._device)
        return self._executor

    @property
    def run_lock(self):
        return self._run_lock

    def deploy(self, name: str,
               model: Union[str, GenerationModel, GenerationSpec],
               budget: Optional[int] = None,
               mode: str = "cached") -> "GenerationHost":
        """Start serving `model` under `name`. budget bounds this
        model's concurrently admitted (queued + in-flight) requests —
        the per-model admission control that keeps one hot model from
        starving the rest of the shared device."""
        with self._route_lock:
            if self._stopped:
                raise RuntimeError("host was stopped; build a new one")
            if name in self._hosted:
                raise ValueError(
                    f"model {name!r} already deployed — use swap() to "
                    "replace it")
        gmodel = self._materialize(model)
        rec = self._start_engine(name, gmodel, budget, mode)
        with self._route_lock:
            self._hosted[name] = rec
            self._models_gauge.set(len(self._hosted))
        return self

    def _start_engine(self, name, gmodel, budget, mode) -> _Hosted:
        metrics = GenerationMetrics(registry=self._registry,
                                    label=f"{self.host_label}_{name}")
        engine = GenerationEngine(gmodel, config=self._config,
                                  metrics=metrics,
                                  health=HealthMonitor(), mode=mode)
        engine.start()
        return _Hosted(gmodel, engine, metrics,
                       int(budget) if budget is not None
                       else self._default_budget, gmodel.version)

    # -- request path --------------------------------------------------
    def submit(self, model_name: str, prompt,
               max_new_tokens: Optional[int] = None) -> GenerationFuture:
        with self._route_lock:
            rec = self._hosted.get(model_name)
        if rec is None:
            raise KeyError(f"no model deployed under {model_name!r}; "
                           f"hosted: {sorted(self._hosted)}")
        # per-model budget: queued + in-flight, checked before the
        # engine's own queue/breaker so a budget shed is attributed to
        # the HOST's admission, not the engine's capacity
        eng = rec.engine
        with eng._lock:
            admitted = (len(eng._queue)
                        + sum(1 for s in eng._slots if s is not None))
        if admitted >= rec.budget:
            rec.metrics.shed("model_budget")
            raise ServiceOverloadedError(
                f"model {model_name!r} at its admission budget "
                f"({rec.budget} concurrent requests) — request shed")
        fut = eng.submit(prompt, max_new_tokens=max_new_tokens)
        self._routed.labels(host=self.host_label, model=model_name).inc()
        return fut

    def generate(self, model_name: str, prompt,
                 max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None):
        return self.submit(model_name, prompt,
                           max_new_tokens=max_new_tokens
                           ).result(timeout=timeout)

    # -- swap ----------------------------------------------------------
    def swap(self, name: str,
             model: Union[str, GenerationModel, GenerationSpec],
             probe_prompts=((1, 2, 3),), probe_max_new_tokens: int = 4,
             drain_timeout_s: Optional[float] = 60.0,
             budget: Optional[int] = None) -> Dict:
        """Replace the model served under `name`.

        Phases: build/load the candidate onto the shared executor (old
        version keeps serving, its executables stay cached) -> probe
        the candidate with real generations (every probe must finish
        with a non-error reason) -> flip routing -> drain the old
        engine (in-flight requests FINISH on the old weights — no
        completed token is dropped) -> retire the old metrics series.

        Returns {"outcome": "completed"|"rolled_back", ...}; a
        candidate-quality failure rolls back with the old version never
        having stopped serving."""
        with self._route_lock:
            if self._swap_in_progress:
                raise GenerationSwapError("a swap is already in progress")
            if name not in self._hosted:
                raise GenerationSwapError(
                    f"no model deployed under {name!r}")
            if self._stopped:
                raise GenerationSwapError("host is stopped")
            self._swap_in_progress = True
        old = self._hosted[name]
        t_start = time.monotonic()
        report = {"model": name, "outcome": None, "phases": {},
                  "probes": 0}
        candidate: Optional[_Hosted] = None
        try:
            phase = "load"
            try:
                t0 = time.monotonic()
                cand_model = self._materialize(model)
                candidate = self._start_engine(
                    name, cand_model,
                    budget if budget is not None else old.budget,
                    old.engine.mode)
                report["phases"]["load"] = time.monotonic() - t0

                phase = "probe"
                t0 = time.monotonic()
                for prompt in probe_prompts:
                    res = candidate.engine.generate(
                        list(prompt),
                        max_new_tokens=probe_max_new_tokens,
                        timeout=30.0)
                    report["probes"] += 1
                    if res.finish_reason not in ("eos", "max_tokens",
                                                 "length"):
                        raise RuntimeError(
                            f"canary generation finished "
                            f"{res.finish_reason!r}")
                report["phases"]["probe"] = time.monotonic() - t0
            except BaseException as e:
                # candidate failure: discard it, old version untouched
                if candidate is not None:
                    try:
                        candidate.engine.stop(drain=False, timeout=5.0)
                    except BaseException:
                        pass
                    candidate.metrics.retire()
                report["outcome"] = "rolled_back"
                report["failed_phase"] = phase
                report["error"] = f"{type(e).__name__}: {e}"
                self._swaps.labels(host=self.host_label,
                                   outcome="rolled_back").inc()
                return report

            # cutover: new requests route to the candidate from here on
            with self._route_lock:
                self._hosted[name] = candidate
            t0 = time.monotonic()
            # old engine drains: every already-admitted request finishes
            # on the weights it started with
            old.engine.stop(drain=True, timeout=drain_timeout_s)
            old.metrics.retire()
            report["phases"]["drain"] = time.monotonic() - t0
            report["outcome"] = "completed"
            self._swaps.labels(host=self.host_label,
                               outcome="completed").inc()
            return report
        finally:
            report["total_s"] = time.monotonic() - t_start
            with self._route_lock:
                self._swap_in_progress = False

    # -- lifecycle -----------------------------------------------------
    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        with self._route_lock:
            self._stopped = True
            recs = list(self._hosted.values())
        for rec in recs:
            rec.engine.stop(drain=drain, timeout=timeout)

    def stats(self) -> Dict:
        with self._route_lock:
            hosted = dict(self._hosted)
        out = {"host": self.host_label, "models": {}}
        for name, rec in hosted.items():
            s = rec.engine.stats()
            s["budget"] = rec.budget
            s["version"] = rec.version
            out["models"][name] = s
        if self._executor is not None:
            cs = dict(self._executor.cache_stats)
            total = cs["hits"] + cs["misses"]
            cs["hit_rate"] = round(cs["hits"] / total, 6) if total \
                else 0.0
            out["compile_cache"] = cs
        return out
