"""Top-level Executor + places. A place names the torch device an
Executor runs on: CUDAPlace (the default when no place is given) or
CPUPlace, which the caller must ask for explicitly."""
from __future__ import annotations

from .core.executor import Executor  # noqa: F401 — public re-export


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
