"""Operator registry: one compute rule per op type, and gradient makers.

Each op type has ONE compute rule, a plain function over torch tensors
that reads its inputs and attrs from an ExecutionContext and writes its
outputs there. The executor runs the rules eagerly, op by op, on the
tensors' own device. Gradients are desc-level, as in the JAX package
(core/backward.py): an op may register a grad maker that appends grad
OpDescs; every other op gets the generic ``__vjp__`` grad op, which
replays the compute rule under torch autograd (the eager executor), or
reads the autograd graph its forward op recorded (the compiled one).

Ragged values (core/lod.py RaggedPair, RaggedNested, RaggedTree) reach
only the ops registered ``ragged_aware``; every other op sees their
dense data, and its outputs are re-wrapped with the first ragged
input's lengths (run_op).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from .lod import RAGGED_TYPES, ragged_lead, with_data

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class OpDef:
    """Everything the runtime knows about one op type."""

    def __init__(self, type: str, compute: Callable,
                 grad_maker: Optional[Callable] = None,
                 no_grad_slots: Optional[List[str]] = None,
                 constant: bool = False, ragged_aware: bool = False,
                 capturable=True, stateful: bool = False,
                 infer_shape: Optional[Callable] = None):
        self.type = type
        # ragged_aware ops receive ragged values as-is; other ops get
        # dense .data views and their outputs are re-wrapped (see run_op).
        self.ragged_aware = ragged_aware
        # compute(ctx) -> None; reads ctx.input/attr, writes ctx.set_output.
        self.compute = compute
        # grad_maker(op, block, acc, no_grad) -> List[OpDesc]
        self.grad_maker = grad_maker
        # input slots that never need gradients (e.g. integer indices)
        self.no_grad_slots = set(no_grad_slots or [])
        # constant ops take no inputs and produce the same tensor from
        # their attrs on every run; the executor materializes them once
        # per (program, device) instead of once per run
        self.constant = constant
        # False for an op whose rule cannot be recorded into a CUDA graph
        # and replayed: it seeds a torch.Generator on the host from its
        # attrs or the step (manual_seed is refused during a capture, and
        # a replay would repeat the captured draw), or that reads a value
        # on the host (cond's predicate). The executor compiles a program
        # that holds one but does not capture it. A callable
        # capturable(op, while_bounds) -> bool decides per op: a While is
        # captured on its masked routes and not on its host-driven one
        self.capturable = capturable
        # an op with host-side effects (the channel ops, go): the
        # WhileGrad probe re-runs its forward prefix, so the executor
        # refuses a stateful op there (and under iterations > 1)
        self.stateful = stateful
        # infer_shape(block_desc, op) -> {name: {"shape", "dtype",
        # "lod_level"}}: an explicit build-time shape rule for an op the
        # meta trace cannot run (the control-flow family, whose rules
        # trace sub-blocks); framework._infer_shapes applies it
        self.infer_shape = infer_shape

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


def register_op(type: str, grad_maker=None, no_grad_slots=None,
                constant=False, ragged_aware=False, capturable=True,
                stateful=False, infer_shape=None):
    """Decorator: register `fn(ctx)` as the compute rule for op `type`."""
    def deco(fn):
        OpRegistry.register(OpDef(type, fn, grad_maker=grad_maker,
                                  no_grad_slots=no_grad_slots,
                                  constant=constant,
                                  ragged_aware=ragged_aware,
                                  capturable=capturable,
                                  stateful=stateful,
                                  infer_shape=infer_shape))
        return fn
    return deco


def op_capturable(op, while_bounds=None) -> bool:
    """Whether the op `op` can be recorded into a CUDA graph under the
    probed While bounds `while_bounds` (OpDef.capturable)."""
    cap = OpRegistry.get(op.type).capturable
    return bool(cap(op, while_bounds or {}) if callable(cap) else cap)


def run_op(op, env: Dict[str, Any], extra: Optional[Dict] = None
           ) -> Dict[str, Any]:
    """Run one op's compute rule against env; returns {name: value}.

    A ragged-aware op sees ragged values as they are. Any other op sees
    their dense padded data, and each of its dense outputs whose leading
    ragged dims (batch, time; batch, sub, token for a RaggedNested; the
    depth + 1 of a RaggedTree) match the first ragged input's comes back
    ragged with that input's lengths: the reference's LoD rule "output
    lod = input lod" on the padded representation
    (paddle_tpu/core/registry.py run_op)."""
    opdef = OpRegistry.get(op.type)
    if opdef.ragged_aware:
        ctx = ExecutionContext(op, env, extra)
        opdef.compute(ctx)
        return ctx.outputs
    ragged_src = None
    local = env
    for name in op.input_names():
        v = env.get(name)
        if isinstance(v, RAGGED_TYPES):
            if ragged_src is None:
                ragged_src = v
                local = dict(env)
            local[name] = v.data
    ctx = ExecutionContext(op, local, extra)
    opdef.compute(ctx)
    if ragged_src is None:
        return ctx.outputs
    n = ragged_lead(ragged_src)
    lead = tuple(ragged_src.data.shape[:n])
    return {k: with_data(ragged_src, v)
            if isinstance(v, torch.Tensor) and v.ndim >= n
            and tuple(v.shape[:n]) == lead else v
            for k, v in ctx.outputs.items()}


class ExecutionContext:
    """Per-op view of the environment during execution.

    `extra` carries run-wide values: "device", the torch.device that
    constant and random ops create their outputs on, "step", the
    scope's step counter for this run (core/executor.py STEP_VAR), which
    per-step random ops fold into their seed, and "program", the
    program whose sub-blocks the control-flow ops run; with them
    "while_bounds", the WhileGrad probe's bounds, when it ran.
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

    def inputs(self, slot: str) -> List[Any]:
        return [self.env[n] for n in self.op.input(slot)]

    # attrs --------------------------------------------------------------
    def attr(self, name: str, default=None):
        return self.op.attrs.get(name, default)

    # outputs ------------------------------------------------------------
    def set_output(self, slot: str, value, index: int = 0):
        names = self.op.output(slot)
        if not names:
            return  # optional output not wired
        self._outputs[names[index]] = value

    def set_outputs(self, slot: str, values: List[Any]):
        for i, v in enumerate(values):
            self.set_output(slot, v, index=i)

    @property
    def outputs(self) -> Dict[str, Any]:
        return self._outputs
