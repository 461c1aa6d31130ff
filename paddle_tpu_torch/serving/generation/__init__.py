"""Token serving for decoder LMs: continuous batching over a KV cache,
with multi-model hosting (the port's copy of
``paddle_tpu/serving/generation``).

- `model.GenerationModel` — one decoder LM's program family (prefill /
  decode-step / re-forward baseline), pinned weights and persistable
  ``kv_cache.*`` state in a private scope; ``save``/``load`` artifacts.
- `engine.GenerationEngine` — the continuous-batching driver, with the
  health breaker, metrics, profiler spans and attribution.
- `host.GenerationHost` — N named models on ONE executor compile
  cache, per-model budgets/breakers, probe-canaried hot swap that
  drains (never drops) in-flight requests.

Quick start::

    from paddle_tpu_torch.serving.generation import (GenerationModel,
                                                     GenerationSpec)
    spec = GenerationSpec(vocab_size=1000, max_seq_len=64, eos_id=2)
    model = GenerationModel.build(spec)        # the first CUDA card
    engine = model.serve().start()
    result = engine.generate([5, 17, 9], max_new_tokens=8)
    engine.stop()
"""
from .engine import (GenerationConfig, GenerationEngine,  # noqa: F401
                     GenerationFuture, GenerationResult, QueueFullError,
                     ServingStopped)
from .host import GenerationHost, GenerationSwapError  # noqa: F401
from .metrics import GenerationMetrics  # noqa: F401
from .model import GenerationModel, GenerationSpec, bucket_for  # noqa: F401

__all__ = [
    "GenerationSpec", "GenerationModel", "GenerationConfig",
    "GenerationEngine", "GenerationFuture", "GenerationResult",
    "GenerationHost", "GenerationSwapError", "GenerationMetrics",
    "bucket_for",
]
