"""Scope: hierarchical name -> value maps holding torch tensors.

Persistable variables (parameters, KV caches) live here between executor
runs as tensors on the executor's device.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self.parent = parent
        self._kids = []

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def set(self, name: str, value: Any) -> None:
        self._vars[name] = value

    def find(self, name: str) -> Optional[Any]:
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has(self, name: str) -> bool:
        return self.find(name) is not None

    def get(self, name: str) -> Any:
        v = self.find(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in scope")
        return v

    def erase(self, name: str) -> None:
        self._vars.pop(name, None)

    def local_names(self) -> Iterator[str]:
        return iter(self._vars)

    def items(self):
        return self._vars.items()

    def __contains__(self, name: str) -> bool:
        return self.has(name)

    def __len__(self):
        return len(self._vars)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def reset_global_scope() -> Scope:
    global _global_scope
    _global_scope = Scope()
    return _global_scope
