"""paddle_tpu_torch.resilience — fault injection and retry/backoff.

The port's copies of ``paddle_tpu/resilience/faults.py`` and
``retry.py``, which checkpoint save/load and the input pipeline use.
Serving health (``health.py``, the circuit breaker) waits for ROADMAP
A8; the retry counters and their metrics wait for A11.
"""
from .faults import (FAULT_POINTS, FaultError, FaultInjector,  # noqa: F401
                     active, fire)
from .retry import DEFAULT_RETRYABLE, RetryError, RetryPolicy  # noqa: F401

__all__ = ["FaultInjector", "FaultError", "fire", "active", "FAULT_POINTS",
           "RetryPolicy", "RetryError", "DEFAULT_RETRYABLE"]
