"""Registry of the environment flags the port reads.

The port's own copy of the entries of ``paddle_tpu/flags.py`` that its
modules use; the names and defaults are the JAX package's, so one
environment configures both.
"""
from __future__ import annotations

import os
from typing import Dict

# name -> (default, where it is read, what it does)
FLAGS: Dict[str, tuple] = {
    "PADDLE_TPU_FLASH_MIN_SEQ": (
        "512", "ops/nn_ops.py",
        "minimum query and key length at which scaled_dot_product_attention "
        "on a CUDA tensor auto-routes to the flash-attention kernel; below "
        "it the naive composition runs"),
    "PADDLE_TPU_PALLAS_LSTM": (
        "1", "ops/sequence_ops.py",
        "lstm op route when the op carries no __pallas__ attr: \"1\" or "
        "\"force\" take the fused-LSTM kernel (its plain twin on CPU "
        "tensors), \"0\" the masked torch scan"),
    "PADDLE_TPU_PALLAS_GRU": (
        "1", "ops/sequence_ops.py",
        "gru op route when the op carries no __pallas__ attr: \"1\" or "
        "\"force\" take the fused-GRU kernel (its plain twin on CPU "
        "tensors), \"0\" the masked torch scan"),
    "PADDLE_TPU_DECODE_SLOTS": (
        "4", "serving/generation/model.py",
        "default in-flight slot count of a generation model's "
        "continuous-batching array (per-request KV-cache rows; also "
        "the decode program's batch dimension)"),
    "PADDLE_TPU_DECODE_CACHE_BUCKETS": (
        "16,32,64", "serving/generation/model.py",
        "default cache-length buckets for the decode-step programs, "
        "comma-separated ascending; a step runs the smallest bucket "
        "covering the deepest active position"),
}


def get(name: str) -> str:
    """Current value of a registered flag (env or default)."""
    if name not in FLAGS:
        raise KeyError(f"unknown flag {name!r}; see "
                       "paddle_tpu_torch.flags.FLAGS")
    return os.environ.get(name, FLAGS[name][0])
