"""Module-path shim (reference: python/paddle/fluid/learning_rate_decay.py,
as ``paddle_tpu/learning_rate_decay.py``): the decay builders live in
layers/learning_rate_scheduler.py."""
from .layers.learning_rate_scheduler import (  # noqa: F401
    cosine_decay, exponential_decay, inverse_time_decay, natural_exp_decay,
    noam_decay, piecewise_decay, polynomial_decay)

__all__ = ["exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "noam_decay", "cosine_decay"]
