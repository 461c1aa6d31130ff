"""Token serving for decoder LMs: continuous batching over a KV cache
(the port's copy of ``paddle_tpu/serving/generation``)."""
from .engine import (GenerationConfig, GenerationEngine,  # noqa: F401
                     GenerationFuture, GenerationResult, QueueFullError,
                     ServingStopped)
from .model import GenerationModel, GenerationSpec, bucket_for  # noqa: F401
