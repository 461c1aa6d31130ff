"""Operator registry: one compute rule per op type.

Each op type has ONE compute rule, a plain function over torch tensors
that reads its inputs and attrs from an ExecutionContext and writes its
outputs there. The executor runs the rules eagerly, op by op, on the
tensors' own device. The port is forward only, so no gradient makers
are registered yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class OpDef:
    """Everything the runtime knows about one op type."""

    def __init__(self, type: str, compute: Callable,
                 constant: bool = False):
        self.type = type
        # compute(ctx) -> None; reads ctx.input/attr, writes ctx.set_output.
        self.compute = compute
        # constant ops take no inputs and produce the same tensor from
        # their attrs on every run; the executor materializes them once
        # per (program, device) instead of once per run
        self.constant = constant

    def __repr__(self):
        return f"OpDef({self.type})"


class OpRegistry:
    _ops: Dict[str, OpDef] = {}

    @classmethod
    def register(cls, opdef: OpDef):
        if opdef.type in cls._ops:
            raise ValueError(f"op {opdef.type!r} registered twice")
        cls._ops[opdef.type] = opdef

    @classmethod
    def get(cls, type: str) -> OpDef:
        if type not in cls._ops:
            raise KeyError(f"op {type!r} is not registered; known ops: "
                           f"{sorted(cls._ops)[:20]}...")
        return cls._ops[type]

    @classmethod
    def has(cls, type: str) -> bool:
        return type in cls._ops


def register_op(type: str, constant=False):
    """Decorator: register `fn(ctx)` as the compute rule for op `type`."""
    def deco(fn):
        OpRegistry.register(OpDef(type, fn, constant=constant))
        return fn
    return deco


def run_op(op, env: Dict[str, Any], extra: Optional[Dict] = None
           ) -> Dict[str, Any]:
    """Run one op's compute rule against env; returns {name: tensor}."""
    ctx = ExecutionContext(op, env, extra)
    OpRegistry.get(op.type).compute(ctx)
    return ctx.outputs


class ExecutionContext:
    """Per-op view of the environment during execution.

    `extra` carries run-wide values: "device", the torch.device that
    constant and random ops create their outputs on.
    """

    __slots__ = ("op", "env", "_outputs", "extra")

    def __init__(self, op, env: Dict[str, Any], extra: Optional[Dict] = None):
        self.op = op
        self.env = env
        self._outputs: Dict[str, Any] = {}
        self.extra = extra or {}

    @property
    def device(self):
        return self.extra.get("device", "cpu")

    # inputs -------------------------------------------------------------
    def input(self, slot: str):
        """Single input for slot, or None if absent."""
        names = self.op.input(slot)
        if not names:
            return None
        return self.env[names[0]]

    # attrs --------------------------------------------------------------
    def attr(self, name: str, default=None):
        return self.op.attrs.get(name, default)

    # outputs ------------------------------------------------------------
    def set_output(self, slot: str, value, index: int = 0):
        names = self.op.output(slot)
        if not names:
            return  # optional output not wired
        self._outputs[names[index]] = value

    @property
    def outputs(self) -> Dict[str, Any]:
        return self._outputs
