"""Python graph-builder API: Program/Block/Variable/Parameter.

The port's copy of ``paddle_tpu/framework.py``: the builder appends
OpDescs into the core IR (core/ir.py) and gives every variable the same
auto-generated name as the JAX package, so a program built by either
package serializes to the same JSON.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

from .core import ir
from .core.ir import VAR_TYPE_LOD_TENSOR
from .core.registry import OpRegistry


class UniqueNameGenerator:
    def __init__(self):
        self.ids: Dict[str, int] = {}

    def __call__(self, key: str) -> str:
        idx = self.ids.get(key, 0)
        self.ids[key] = idx + 1
        return f"{key}_{idx}"

    def reset(self):
        self.ids = {}


_name_gen = UniqueNameGenerator()


def unique_name(key: str) -> str:
    return _name_gen(key)


@contextlib.contextmanager
def isolated_name_scope():
    """Run a graph build with a FRESH name counter, restoring the
    global one afterwards — deterministic auto names for builders that
    must lower the same graph identically more than once (the decoder
    LM's program set shares weights by name)."""
    saved = _name_gen.ids
    _name_gen.ids = {}
    try:
        yield
    finally:
        _name_gen.ids = saved


class Variable:
    """User-facing handle to a VarDesc inside a Block."""

    def __init__(self, block: "Block", desc: ir.VarDesc):
        self.block = block
        self.desc = desc

    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self):
        return tuple(self.desc.shape) if self.desc.shape is not None else None

    @property
    def dtype(self) -> str:
        return self.desc.dtype

    @property
    def lod_level(self) -> int:
        return self.desc.lod_level

    @property
    def persistable(self) -> bool:
        return self.desc.persistable

    @property
    def stop_gradient(self) -> bool:
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v: bool):
        self.desc.stop_gradient = v

    @property
    def program(self) -> "Program":
        return self.block.program

    def __repr__(self):
        return (f"Variable({self.name}, shape={self.shape}, "
                f"dtype={self.dtype})")


class Parameter(Variable):
    """A trainable persistable Variable."""

    def __init__(self, block: "Block", desc: ir.VarDesc, regularizer=None):
        super().__init__(block, desc)
        self.regularizer = regularizer

    @property
    def trainable(self) -> bool:
        return self.desc.trainable


class Block:
    def __init__(self, program: "Program", desc: ir.BlockDesc):
        self.program = program
        self.desc = desc
        self._var_objs: Dict[str, Variable] = {}

    @property
    def idx(self) -> int:
        return self.desc.idx

    def var(self, name: str) -> Variable:
        if name in self._var_objs:
            return self._var_objs[name]
        vdesc = self.desc.find_var_recursive(name)
        if vdesc is None:
            raise KeyError(f"var {name!r} not in block {self.idx}")
        v = Variable(self, vdesc)
        self._var_objs[name] = v
        return v

    def has_var(self, name: str) -> bool:
        return self.desc.find_var_recursive(name) is not None

    def create_var(self, name: Optional[str] = None, shape=None,
                   dtype="float32", lod_level: int = 0,
                   persistable: bool = False, stop_gradient: bool = False,
                   type: str = VAR_TYPE_LOD_TENSOR) -> Variable:
        name = name or unique_name("tmp")
        vdesc = self.desc.create_var(
            name, shape=shape, dtype=dtype, lod_level=lod_level,
            persistable=persistable, stop_gradient=stop_gradient, type=type)
        v = Variable(self, vdesc)
        self._var_objs[name] = v
        return v

    def create_parameter(self, name: Optional[str] = None, shape=None,
                         dtype="float32", trainable: bool = True,
                         regularizer=None) -> Parameter:
        name = name or unique_name("param")
        vdesc = self.desc.create_var(name, shape=shape, dtype=dtype,
                                     persistable=True, is_parameter=True,
                                     trainable=trainable)
        p = Parameter(self, vdesc, regularizer=regularizer)
        self._var_objs[name] = p
        return p

    def append_op(self, type: str, inputs: Optional[Dict] = None,
                  outputs: Optional[Dict] = None,
                  attrs: Optional[Dict] = None) -> ir.OpDesc:
        if not OpRegistry.has(type):
            raise KeyError(f"op type {type!r} is not registered")
        op = self.desc.append_op(type, _names(inputs), _names(outputs),
                                 attrs)
        _infer_shapes(self.desc, op)
        return op

    @property
    def ops(self) -> List[ir.OpDesc]:
        return self.desc.ops


# Build-time shape inference: run the op's compute rule on tensors of the
# "meta" device (shapes and dtypes, no data, no FLOPs) — the PyTorch
# counterpart of the JAX package's jax.eval_shape trace. The dynamic
# batch dim (-1) maps to a distinctive dummy extent and back; a ragged
# input's data has dummy ragged dims after the batch dim (a time dim at
# level 1, sub-sequence dims and a time dim deeper), and a ragged output
# drops them and keeps its lod_level, as in the JAX package. A batch dim
# made by flattening a nested batch (batch * sub) maps back to -1 too.
_DUMMY_BATCH = 97
_DUMMY_TIME = 13
_DUMMY_SUB = 7

#: OpDesc attr recording that shape inference could not cover this op
#: (and why) — the same attr the JAX package stamps.
SHAPE_INFER_SKIPPED_ATTR = "__shape_infer_skipped__"
#: OpDesc attr recording declared-vs-inferred conflicts found at build
#: time (dicts of analysis/passes.py ShapeDtypePass.compare) — the same
#: attr the JAX package stamps, read by the executor's no-retrace gate.
SHAPE_INFER_CONFLICT_ATTR = "__shape_infer_conflict__"


class _SkipInference(Exception):
    """Inference preconditions unmet (unknown input shape/dtype)."""


#: skip-reason prefix of an explicit rule that left outputs unresolved
#: (the JAX package's framework.RULE_UNRESOLVED_PREFIX)
RULE_UNRESOLVED_PREFIX = "explicit rule left outputs unresolved: "


def _infer_shapes(block_desc: ir.BlockDesc, op: ir.OpDesc) -> None:
    """Fill output VarDesc shapes/dtypes for a just-appended op, only
    where the layer left them unknown.

    The meta trace runs first; when it cannot, the op's explicit rule
    (OpDef.infer_shape: the control-flow family, whose compute rules
    trace sub-blocks) gets a chance. An op covered by neither, or whose
    rule leaves an output unresolved, is marked with
    SHAPE_INFER_SKIPPED_ATTR and the reason, word for word as the JAX
    package marks it."""
    outs, skip = infer_op_outputs(block_desc, op)
    if outs is not None:
        op.attrs.pop(SHAPE_INFER_SKIPPED_ATTR, None)
        _apply_inferred(block_desc, op, outs)
        return
    rule = OpRegistry.get(op.type).infer_shape
    if rule is not None:
        try:
            explicit = rule(block_desc, op)
        except Exception as e:  # noqa: BLE001 — a failed rule is a skip
            skip = f"explicit rule failed: {type(e).__name__}"
        else:
            if explicit:
                _apply_inferred(block_desc, op, explicit)
            unresolved = unresolved_outputs(block_desc, op,
                                            covered=explicit or ())
            if unresolved:
                op.attrs[SHAPE_INFER_SKIPPED_ATTR] = \
                    RULE_UNRESOLVED_PREFIX + str(unresolved[:3])
            else:
                op.attrs.pop(SHAPE_INFER_SKIPPED_ATTR, None)
            return
    op.attrs[SHAPE_INFER_SKIPPED_ATTR] = str(skip)[:200]


def unresolved_outputs(block_desc: ir.BlockDesc, op: ir.OpDesc,
                       covered=()) -> List[str]:
    """Output names still lacking a declared shape or dtype, minus the
    names in `covered` (specs an explicit rule provided): the one
    definition shared by the build-time markers and the verifier's
    retrace (the JAX package's framework.unresolved_outputs)."""
    out = []
    for n in op.output_names():
        if n in covered:
            continue
        v = block_desc.find_var_recursive(n)
        if v is not None and (v.shape is None or v.dtype is None):
            out.append(n)
    return out


def _apply_inferred(block_desc: ir.BlockDesc, op: ir.OpDesc, outs) -> None:
    """Write inferred {name: {shape, dtype, lod_level}} onto the
    VarDescs, filling only what the layer left unknown, and stamp
    declared-vs-inferred conflicts on the op (the verifier's
    ShapeDtypePass.compare decides what a conflict is)."""
    from .analysis.passes import ShapeDtypePass  # lazy: no import cycle
    conflicts = []
    for name, spec in outs.items():
        v = block_desc.find_var_recursive(name)
        if v is None:
            continue
        conflicts.extend(ShapeDtypePass.compare(name, v, spec))
        if v.shape is None and spec.get("shape") is not None:
            v.shape = list(spec["shape"])
        if spec.get("lod_level"):
            v.lod_level = max(v.lod_level, spec["lod_level"])
        if v.dtype is None and spec.get("dtype") is not None:
            v.dtype = spec["dtype"]
    if conflicts:
        op.attrs[SHAPE_INFER_CONFLICT_ATTR] = conflicts
    else:
        op.attrs.pop(SHAPE_INFER_CONFLICT_ATTR, None)


def infer_op_outputs(block_desc: ir.BlockDesc, op: ir.OpDesc):
    """Abstractly evaluate one op's compute rule: ``(outputs, skip)``.

    ``outputs`` is {name: {"shape": [...], "dtype": str, "lod_level":
    int}} with dummy extents mapped back to -1, or None when inference
    could not run — then ``skip`` carries the reason."""
    import torch
    from .core.lod import RaggedNested, RaggedPair, RaggedTree
    from .core.registry import run_op
    from .ops.core_ops import torch_dtype

    def meta(shape, dtype):
        return torch.empty(list(shape), dtype=dtype, device="meta")

    env = {}
    for name in op.input_names():
        v = block_desc.find_var_recursive(name)
        if v is None or v.shape is None or v.dtype is None:
            return None, f"input {name!r} has no declared shape/dtype"
        shape = [(_DUMMY_BATCH if d == -1 else int(d)) for d in v.shape]
        dt = torch_dtype(v.dtype)
        if v.lod_level >= 3:
            k = v.lod_level
            env[name] = RaggedTree(
                meta([shape[0]] + [_DUMMY_SUB] * (k - 1) + [_DUMMY_TIME]
                     + shape[1:], dt),
                [meta([shape[0]] + [_DUMMY_SUB] * i, torch.int32)
                 for i in range(k)])
        elif v.lod_level == 2:
            env[name] = RaggedNested(
                meta([shape[0], _DUMMY_SUB, _DUMMY_TIME] + shape[1:], dt),
                meta([shape[0]], torch.int32),
                meta([shape[0], _DUMMY_SUB], torch.int32))
        elif v.lod_level == 1:
            env[name] = RaggedPair(
                meta([shape[0], _DUMMY_TIME] + shape[1:], dt),
                meta([shape[0]], torch.int32))
        else:
            env[name] = meta(shape, dt)
    try:
        outs = run_op(op, env, extra={"device": torch.device("meta")})
    except Exception as e:  # noqa: BLE001 — any rule failure means "skip"
        return None, f"trace failed: {type(e).__name__}: {e}"
    from .core.ir import canon_dtype
    batch = (_DUMMY_BATCH, _DUMMY_BATCH * _DUMMY_SUB)
    result = {}
    for name, t in outs.items():
        if isinstance(t, RaggedTree):
            lod, ragged = t.depth, range(1, t.depth + 1)
        elif isinstance(t, RaggedNested):
            lod, ragged = 2, (1, 2)
        elif isinstance(t, RaggedPair):
            lod, ragged = 1, (1,)
        else:
            lod, ragged = 0, ()
        # as the reference maps them: a RaggedNested's batch dim is the
        # batch alone; elsewhere a flattened batch is a batch too
        batch_dims = batch[:1] if lod == 2 else batch
        t = t.data if lod else t
        result[name] = {"shape": [(-1 if d in batch_dims else int(d))
                                  for i, d in enumerate(t.shape)
                                  if i not in ragged],
                        "dtype": canon_dtype(t.dtype), "lod_level": lod}
    return result, None


def _names(slot_map: Optional[Dict]) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for slot, vs in (slot_map or {}).items():
        if vs is None:
            continue
        if not isinstance(vs, (list, tuple)):
            vs = [vs]
        names = []
        for v in vs:
            if v is None:
                continue
            names.append(v if isinstance(v, str) else v.name)
        if names:
            out[slot] = names
    return out


class Program:
    """Python Program wrapping the core IR program."""

    def __init__(self):
        self.desc = ir.Program()
        self._blocks = [Block(self, self.desc.global_block)]
        self._current_block_idx = 0

    @property
    def random_seed(self):
        return self.desc.random_seed

    @random_seed.setter
    def random_seed(self, seed):
        self.desc.random_seed = seed

    def global_block(self) -> Block:
        return self._blocks[0]

    def current_block(self) -> Block:
        return self._blocks[self._current_block_idx]

    def block(self, idx: int) -> Block:
        return self._blocks[idx]

    def create_block(self) -> Block:
        """A new sub-block whose parent is the current block; it becomes
        the current block (the control-flow layers build their bodies
        in it)."""
        parent = self.current_block()
        bdesc = self.desc.append_block(parent.desc)
        blk = Block(self, bdesc)
        self._blocks.append(blk)
        self._current_block_idx = bdesc.idx
        return blk

    def rollback(self):
        """Make the current block's parent current again."""
        self._current_block_idx = \
            self.current_block().desc.parent_idx

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    def list_vars(self):
        for blk in self._blocks:
            for name in list(blk.desc.vars):
                yield blk.var(name)

    def all_parameters(self) -> List[Parameter]:
        out = []
        for blk in self._blocks:
            for name, vdesc in blk.desc.vars.items():
                if vdesc.is_parameter:
                    out.append(blk.var(name))
        return out

    def clone(self, for_test: bool = False) -> "Program":
        p = Program()
        p.desc = self.desc.clone()
        p._blocks = [Block(p, bd) for bd in p.desc.blocks]
        if for_test:
            for bd in p.desc.blocks:
                for op in bd.ops:
                    if "is_test" in _TEST_ATTR_OPS.get(op.type, ()):
                        op.attrs["is_test"] = True
        return p

    def inference_optimize(self) -> "Program":
        """Flip train-mode attrs (BN batch stats, dropout) to inference,
        as save_inference_model does on the pruned program."""
        return self.clone(for_test=True)

    def to_string(self) -> str:
        return str(self.desc)

    def __str__(self):
        return self.to_string()


_TEST_ATTR_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
}

# -- default programs -------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


def reset_default_programs():
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
    _name_gen.reset()
