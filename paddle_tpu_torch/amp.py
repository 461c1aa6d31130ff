"""Automatic mixed precision in bfloat16.

The port's copy of ``paddle_tpu/amp.py``: one process-wide switch makes
the FLOP-dominant ops (``mul``, ``conv2d``) cast their float32 operands to
bfloat16, accumulate in float32 and return a bfloat16 result, and makes a
mixed bfloat16/float32 elementwise pair compute in bfloat16, so
activations thread through the step at half width. Parameters, optimizer
state and normalization statistics stay float32; a parameter's gradient
comes back through the cast in float32, as jax.vjp gives it.

Enable per process with env PADDLE_TPU_AMP=1 (read at import), or
scoped:

    with paddle_tpu_torch.amp.amp_guard():
        exe.run(main_program, ...)

The flag is part of the executor's compile key (core/executor.py
Executor.compile_key), so a run under the guard and one outside it use
two plans and, on a card, two CUDA graphs.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from . import flags

_state = {"enabled": flags.get("PADDLE_TPU_AMP") == "1"}


def amp_enabled() -> bool:
    return _state["enabled"]


def enable(flag: bool = True) -> None:
    _state["enabled"] = bool(flag)


@contextmanager
def amp_guard(enabled: bool = True):
    prev = _state["enabled"]
    _state["enabled"] = bool(enabled)
    try:
        yield
    finally:
        _state["enabled"] = prev


def amp_cast(*tensors):
    """Cast float32 operands to bfloat16 when AMP is on; pass through else.

    Only float32 is downcast: integer, bool, float64 and bfloat16 operands
    are untouched, so ops can call this unconditionally."""
    if not _state["enabled"]:
        return tensors if len(tensors) > 1 else tensors[0]
    out = tuple(t.to(torch.bfloat16)
                if getattr(t, "dtype", None) == torch.float32 else t
                for t in tensors)
    return out if len(out) > 1 else out[0]
