"""paddle_tpu_torch.serving — in-process inference serving with dynamic
batching and a bucketed-shape compile cache (the port's copy of
``paddle_tpu/serving``).

Quickstart::

    # freeze (training side; either package's export loads here)
    io.save_inference_model("model_dir", ["x"], [pred], exe, main_prog)

    # serve
    from paddle_tpu_torch import serving
    model = serving.load("model_dir")           # device: the first card
    engine = model.serve(serving.BatchingConfig(max_batch_size=32,
                                                max_latency_ms=5.0))
    engine.start()                     # warms (and captures) each bucket
    out, = model.predict({"x": batch})  # dynamic-batched under the hood
    print(engine.stats())              # JSON-able metrics snapshot
    engine.stop()                      # drains in-flight requests

Production lifecycle::

    host = serving.ModelHost("model_v1_dir",
                             admission=serving.AdmissionConfig(
                                 max_queue_rows=512)).start()
    out, = host.predict({"x": batch})
    report = host.swap("model_v2_dir", canary_fraction=0.1)
    host.stop()

Module map: `model.ServableModel` (frozen program + pinned weights),
`batcher.DynamicBatcher` (bucket padding, deadline/max-batch flush,
backpressure), `engine.ServingEngine` (workers, warmup, drain, and a
circuit breaker — open = submit() fast-fails with CircuitOpenError,
recovery via half-open probe; resilience/health.py),
`admission.AdmissionController` (queue-depth / rolling-p99 load
shedding with ServiceOverloadedError), `lifecycle.ModelHost` (atomic
weight hot-swap: verifier deploy gate, precompile, canary fraction with
stable-fallback, automatic rollback), `metrics.ServingMetrics`
(counters/histograms + stats()).

Token serving lives in the `generation` subpackage.
"""
from ..resilience.health import (CircuitBreaker, CircuitOpenError,  # noqa
                                 HealthMonitor)
from .admission import (AdmissionConfig, AdmissionController,  # noqa
                        ServiceOverloadedError)
from .batcher import (BatchingConfig, DynamicBatcher,  # noqa
                      QueueFullError, ServingFuture, ServingStopped)
from .engine import ServingEngine  # noqa
from .lifecycle import ModelHost, SwapError  # noqa
from .metrics import ServingMetrics  # noqa
from .model import ServableModel  # noqa
from . import generation  # noqa

__all__ = ["load", "ServableModel", "ServingEngine", "ServingMetrics",
           "BatchingConfig", "DynamicBatcher", "ServingFuture",
           "QueueFullError", "ServingStopped", "CircuitBreaker",
           "CircuitOpenError", "HealthMonitor", "ModelHost", "SwapError",
           "AdmissionConfig", "AdmissionController",
           "ServiceOverloadedError", "generation"]


def load(dirname, model_filename=None, params_filename=None, device=None):
    """Load a `save_inference_model` directory into a ServableModel with
    its own scope, weights on `device` (None: the first CUDA card), and
    executor."""
    return ServableModel.load(dirname, model_filename=model_filename,
                              params_filename=params_filename,
                              device=device)
