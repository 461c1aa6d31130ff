"""Top-level Executor + places, and scope_guard. A place names the torch
device an Executor runs on: CUDAPlace (the default when no place is
given) or CPUPlace, which the caller must ask for explicitly."""
from __future__ import annotations

import contextlib

from .core import scope as scope_mod
from .core.executor import (Executor, StepResult,  # noqa: F401 — re-export
                            device_feed)


@contextlib.contextmanager
def scope_guard(scope):
    """Make `scope` the global scope inside the block (io's save/load
    functions and Executor.run without a scope read it)."""
    old = scope_mod._global_scope
    scope_mod._global_scope = scope
    try:
        yield
    finally:
        scope_mod._global_scope = old


class CPUPlace:
    device = "cpu"

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace:
    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    @property
    def device(self) -> str:
        return f"cuda:{self.device_id}"

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"
