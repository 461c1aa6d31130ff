"""paddle_tpu_torch.resilience — fault injection, retry/backoff, and
serving health.

The port's copies of ``paddle_tpu/resilience/faults.py``, ``retry.py``
and ``health.py``: named fault points, the shared retry layer with its
per-operation counters and ``retry::<name>`` profiler events, and the
circuit breaker + health monitor the serving and generation engines
shed load with.
"""
from .faults import (FAULT_POINTS, FaultError, FaultInjector,  # noqa: F401
                     active, fire)
from .health import (CLOSED, HALF_OPEN, OPEN, PROBE,  # noqa: F401
                     CircuitBreaker, CircuitOpenError, HealthMonitor)
from .retry import (DEFAULT_RETRYABLE, RetryError, RetryPolicy,  # noqa: F401
                    reset_retry_counters, retry_counters)

__all__ = ["FaultInjector", "FaultError", "fire", "active", "FAULT_POINTS",
           "CircuitBreaker", "CircuitOpenError", "HealthMonitor",
           "CLOSED", "OPEN", "HALF_OPEN", "PROBE",
           "RetryPolicy", "RetryError", "retry_counters",
           "reset_retry_counters", "DEFAULT_RETRYABLE"]
