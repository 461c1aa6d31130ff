"""Program IR: serializable descriptions of variables, operators, and blocks.

The same ProgramDesc/BlockDesc/OpDesc/VarDesc data structure as the JAX
package's ``paddle_tpu/core/ir.py``, kept format-compatible: a program
serialized by either package with ``Program.to_json`` loads in the other
with ``Program.from_json``. The IR is pure data; the PyTorch executor
(core/executor.py) interprets it op by op.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional

import numpy as np

# Op attrs naming a sub-block the executor descends into.
SUB_BLOCK_ATTRS = ("sub_block", "sub_block_idx", "true_block_idx",
                   "false_block_idx")

# Variable types (reference: framework.proto VarType).
VAR_TYPE_LOD_TENSOR = "lod_tensor"
VAR_TYPE_SELECTED_ROWS = "selected_rows"
VAR_TYPE_READER = "reader"
VAR_TYPE_STEP_SCOPES = "step_scopes"
VAR_TYPE_RAW = "raw"

_DTYPE_CANON = {
    "float32": "float32",
    "float64": "float64",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "int8": "int8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "uint8": "uint8",
    "bool": "bool",
}


def canon_dtype(dtype) -> str:
    """Normalize a dtype spec (str / np.dtype / torch.dtype) to a
    canonical string."""
    if isinstance(dtype, str):
        name = dtype
    elif hasattr(dtype, "is_floating_point"):   # torch.dtype
        name = str(dtype).rsplit(".", 1)[-1]
    else:
        name = np.dtype(dtype).name
    if name not in _DTYPE_CANON:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPE_CANON[name]


class VarDesc:
    """Description of a variable: name, shape, dtype, and runtime attributes.

    shape may contain -1 for the batch dimension (resolved at feed time).
    """

    __slots__ = (
        "name", "shape", "dtype", "type", "persistable", "is_parameter",
        "lod_level", "stop_gradient", "initializer", "trainable",
    )

    def __init__(self, name: str, shape=None, dtype="float32",
                 type: str = VAR_TYPE_LOD_TENSOR, persistable: bool = False,
                 is_parameter: bool = False, lod_level: int = 0,
                 stop_gradient: bool = False, trainable: bool = True):
        self.name = name
        self.shape = list(shape) if shape is not None else None
        self.dtype = canon_dtype(dtype) if dtype is not None else None
        self.type = type
        self.persistable = persistable
        self.is_parameter = is_parameter
        self.lod_level = lod_level
        self.stop_gradient = stop_gradient
        self.trainable = trainable
        self.initializer = None  # optional dict set by the builder

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "shape": self.shape, "dtype": self.dtype,
            "type": self.type, "persistable": self.persistable,
            "is_parameter": self.is_parameter, "lod_level": self.lod_level,
            "stop_gradient": self.stop_gradient, "trainable": self.trainable,
            "initializer": self.initializer,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VarDesc":
        v = cls(d["name"], d.get("shape"), d.get("dtype", "float32"),
                d.get("type", VAR_TYPE_LOD_TENSOR), d.get("persistable", False),
                d.get("is_parameter", False), d.get("lod_level", 0),
                d.get("stop_gradient", False), d.get("trainable", True))
        v.initializer = d.get("initializer")
        return v

    def __repr__(self):
        return (f"VarDesc({self.name!r}, shape={self.shape}, dtype={self.dtype},"
                f" persistable={self.persistable})")


class OpDesc:
    """Description of one operator: type, named input/output slots, attributes.

    Slots map slot-name -> list of variable names. attrs must be
    JSON-serializable.
    """

    __slots__ = ("type", "inputs", "outputs", "attrs")

    def __init__(self, type: str, inputs: Optional[Dict[str, List[str]]] = None,
                 outputs: Optional[Dict[str, List[str]]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def to_dict(self) -> Dict[str, Any]:
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": self.attrs}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OpDesc":
        return cls(d["type"], d.get("inputs"), d.get("outputs"), d.get("attrs"))

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"{self.type}({ins}) -> ({outs})"


class BlockDesc:
    """An ordered list of ops plus the variables they reference. Blocks
    form a tree (parent_idx); block 0 is the global block."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, VarDesc] = {}
        self.ops: List[OpDesc] = []

    # -- vars ---------------------------------------------------------------
    def var(self, name: str) -> VarDesc:
        v = self.find_var_recursive(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def find_var_recursive(self, name: str) -> Optional[VarDesc]:
        blk: Optional[BlockDesc] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = (self.program.blocks[blk.parent_idx]
                   if blk.parent_idx >= 0 else None)
        return None

    def create_var(self, name: str, **kwargs) -> VarDesc:
        if name in self.vars:
            return self.vars[name]
        v = VarDesc(name, **kwargs)
        self.vars[name] = v
        return v

    # -- ops ----------------------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> OpDesc:
        op = OpDesc(type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> OpDesc:
        op = OpDesc(type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    def to_dict(self) -> Dict[str, Any]:
        return {
            "idx": self.idx, "parent_idx": self.parent_idx,
            "vars": {k: v.to_dict() for k, v in self.vars.items()},
            "ops": [op.to_dict() for op in self.ops],
        }

    @classmethod
    def from_dict(cls, program: "Program", d: Dict[str, Any]) -> "BlockDesc":
        blk = cls(program, d["idx"], d.get("parent_idx", -1))
        blk.vars = {k: VarDesc.from_dict(v) for k, v in d["vars"].items()}
        blk.ops = [OpDesc.from_dict(o) for o in d["ops"]]
        return blk


class Program:
    """A whole program: a tree of blocks. Serializable to/from JSON.
    `version` is bumped on every mutation."""

    _uid_counter = 0

    def __init__(self):
        self.blocks: List[BlockDesc] = [BlockDesc(self, 0, -1)]
        self._version = 0
        # process-unique id (id() can be recycled after GC; this cannot)
        Program._uid_counter += 1
        self.uid = Program._uid_counter
        self._seed_counter = 0
        # Random ops get a program-unique seed at append time unless the
        # user pinned one.
        self.random_seed: Optional[int] = None

    # -- structure ----------------------------------------------------------
    @property
    def global_block(self) -> BlockDesc:
        return self.blocks[0]

    def block(self, idx: int) -> BlockDesc:
        return self.blocks[idx]

    def append_block(self, parent: BlockDesc) -> BlockDesc:
        blk = BlockDesc(self, len(self.blocks), parent.idx)
        self.blocks.append(blk)
        self._bump_version()
        return blk

    def _bump_version(self):
        self._version += 1

    @property
    def version(self) -> int:
        return self._version

    def next_seed(self) -> int:
        self._seed_counter += 1
        base = self.random_seed if self.random_seed is not None else 0
        return base * 1000003 + self._seed_counter

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"blocks": [b.to_dict() for b in self.blocks],
                "random_seed": self.random_seed}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Program":
        p = cls()
        p.blocks = [BlockDesc.from_dict(p, bd) for bd in d["blocks"]]
        p.random_seed = d.get("random_seed")
        return p

    @classmethod
    def from_json(cls, s: str) -> "Program":
        return cls.from_dict(json.loads(s))

    def clone(self) -> "Program":
        return Program.from_dict(copy.deepcopy(self.to_dict()))

    # -- introspection ------------------------------------------------------
    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def all_parameters(self) -> List[VarDesc]:
        return [v for v in self.list_vars() if v.is_parameter]

    def __str__(self):
        lines = []
        for blk in self.blocks:
            lines.append(f"-- block {blk.idx} (parent {blk.parent_idx}) --")
            for v in blk.vars.values():
                flag = "P" if v.is_parameter else ("s" if v.persistable else " ")
                lines.append(f"  var[{flag}] {v.name}: {v.dtype}{v.shape}")
            for op in blk.ops:
                lines.append(f"  op {op}")
        return "\n".join(lines)
