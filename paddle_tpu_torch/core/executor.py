"""Executor: run a Program block eagerly, op by op, on one torch device.

The JAX package traces a whole block into one jitted function. PyTorch
runs eagerly, so this executor walks the block and calls each op's
compute rule (core/registry.py) in order: feeds and persistable state go
in, fetches and written state come out. Read-write persistable state
(the KV caches of the generation programs) is updated IN PLACE by its
ops, which is what the JAX executor gets from buffer donation. Every op
runs under torch.no_grad(); a training program's gradients come from
its ``__vjp__`` grad ops (core/backward.py), each of which replays its
forward op under autograd by itself. Every forward value stays in the
run's environment until the run ends, as the JAX trace keeps it live
for the grad ops. Before a run, the kernel-dispatch stamps of the JAX
executor's rewrite are applied to a copy of the program (core/dispatch.py),
cached per program, program version and knob values.

Not ported yet: the compile cache, While probing, stacked multi-step
runs, async StepResult, and the cost/memory reports.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dispatch
from .ir import BlockDesc, Program, SUB_BLOCK_ATTRS
from .lod import LoDTensor, RaggedPair
from .registry import OpRegistry, run_op
from .scope import Scope, global_scope


def resolve_device(place=None) -> torch.device:
    """The torch.device an entry point runs on. None means the first
    CUDA card; with no card present that raises — the CPU is taken only
    when the caller names it ("cpu", torch.device("cpu"), CPUPlace())."""
    if place is None:
        place = "cuda"
    dev = getattr(place, "device", place)
    dev = torch.device(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass place/device='cpu' "
            "explicitly to run on the CPU")
    return dev


def to_tensor(value, device: torch.device) -> torch.Tensor:
    """A feed value (numpy array, python scalar or tensor) as a tensor
    on `device`. Integer and float widths are kept as given."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.ascontiguousarray(np.asarray(value))
    return torch.from_numpy(arr).to(device)


def to_device_value(value, device: torch.device):
    """A feed value in its in-graph form on `device`: a LoDTensor with one
    LoD level, or a RaggedPair of arrays, becomes a RaggedPair of the
    padded data and int32 lengths (paddle_tpu/core/executor.py
    _to_device_value); anything else goes through to_tensor. Deeper LoD
    is not ported yet."""
    if isinstance(value, LoDTensor):
        if len(value.lod) > 1:
            raise NotImplementedError(
                "the port feeds level-1 LoD only; nested LoD (RaggedNested"
                "/RaggedTree) is not ported yet")
        if not value.lod:
            return to_tensor(value.data, device)
        value = RaggedPair(*value.to_padded())
    if isinstance(value, RaggedPair):
        return RaggedPair(to_tensor(value.data, device),
                          to_tensor(value.lengths, device).to(torch.int32))
    return to_tensor(value, device)


def to_host_value(value):
    """A fetched value on the host: a RaggedPair comes back as a LoDTensor
    of its valid rows, anything else as a numpy array."""
    if isinstance(value, RaggedPair):
        return LoDTensor.from_padded(to_numpy(value.data),
                                     value.lengths.cpu().numpy())
    return to_numpy(value)


def to_numpy(value) -> np.ndarray:
    """Tensor -> numpy at the fetch boundary (bf16 widened to f32:
    numpy has no bfloat16)."""
    t = value.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _collect_state_names(program: Program, block: BlockDesc,
                         scope: Scope) -> Tuple[List[str], List[str]]:
    """Names of persistable vars this block reads (from scope) and writes."""
    reads, writes = [], []
    seen_r, seen_w = set(), set()

    def visit(blk: BlockDesc):
        for op in blk.ops:
            for name in op.input_names():
                v = blk.find_var_recursive(name)
                if v is not None and v.persistable and name not in seen_r:
                    seen_r.add(name)
                    reads.append(name)
            for name in op.output_names():
                v = blk.find_var_recursive(name)
                if v is not None and v.persistable and name not in seen_w:
                    seen_w.add(name)
                    writes.append(name)
            for attr in SUB_BLOCK_ATTRS:
                idx = op.attrs.get(attr)
                if isinstance(idx, int) and 0 <= idx < len(program.blocks):
                    visit(program.blocks[idx])

    visit(block)
    # Only read state that actually exists in scope (written-only vars like
    # freshly initialized params have no prior value).
    reads = [n for n in reads if scope.has(n)]
    return reads, writes


class Executor:
    """Runs Programs on one device. `place` defaults to the first CUDA
    card and raises without one; pass "cpu" (or CPUPlace()) to run on
    the CPU."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        # The JAX reference computes in full float32; TF32 keeps about
        # three decimal digits, so it is switched off for matmuls and
        # convolutions alike.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # outputs of constant ops (register_op(constant=True)), keyed by
        # (program uid, version, op index): the position table's
        # assign_value alone is a list of max_seq_len * d_model floats
        self._const_cache: Dict[Tuple, Dict[str, torch.Tensor]] = {}
        # runs so far: random ops that must draw anew each step (dropout)
        # fold it into their seed, as the JAX executor folds its step
        self._runs = 0
        # program uid -> (version, knob values, dispatch-stamped program)
        self._stamped: Dict[int, Tuple[int, Tuple, Program]] = {}

    def _dispatched(self, program: Program) -> Program:
        """`program` with the kernel-dispatch stamps of the knobs in force
        (core/dispatch.py): itself, or a stamped copy made once per
        program version and knob values."""
        knob = dispatch.knobs()
        hit = self._stamped.get(program.uid)
        if hit is None or hit[0] != program.version or hit[1] != knob:
            hit = (program.version, knob, dispatch.stamped(program, knob))
            self._stamped[program.uid] = hit
        return hit[2]

    def run(self, program, feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None) -> List[np.ndarray]:
        """Execute the global block of `program` with `feed`; return the
        fetches as numpy arrays.

        feed values: numpy arrays, python scalars, tensors, or ragged
        values (LoDTensor, RaggedPair). fetch_list entries: var names or
        objects with a `.name`; a ragged fetch comes back as a
        LoDTensor."""
        if hasattr(program, "desc"):  # accept the python builder wrapper
            program = program.desc
        source, program = program, self._dispatched(program)
        scope = global_scope() if scope is None else scope
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        block = program.global_block
        read_names, write_names = _collect_state_names(program, block, scope)

        env: Dict[str, Any] = {n: scope.get(n) for n in read_names}
        for k, v in (feed or {}).items():
            env[k] = to_device_value(v, self.device)
        extra = {"device": self.device, "step": self._runs}
        self._runs += 1
        with torch.no_grad():
            for i, op in enumerate(block.ops):
                opdef = OpRegistry.get(op.type)
                if opdef.constant and not any(
                        n in write_names for n in op.output_names()):
                    key = (source.uid, source.version, i)
                    outs = self._const_cache.get(key)
                    if outs is None:
                        outs = run_op(op, env, extra)
                        self._const_cache[key] = outs
                else:
                    outs = run_op(op, env, extra)
                env.update(outs)
        for n in write_names:
            if n in env:
                scope.set(n, env[n])
        return [to_host_value(env[n]) for n in fetch_names]
