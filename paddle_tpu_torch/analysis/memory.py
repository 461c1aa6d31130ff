"""Static memory planner: liveness, peak device-memory estimate, the
budget gate.

The port's copy of ``paddle_tpu/analysis/memory.py``. It walks every
reachable op of a program (the verifier's execution-order traversal,
cycle-guarded sub-block descent) and assigns each referenced variable a
*buffer* with a live interval over the global op order. Shapes come from
the declared+inferred VarDescs with the cost model's ``-1`` binding:
feed shapes bind exactly, a declared leading ``-1`` binds to the fed
batch, other dynamic dims bind to 1.

Two numbers come out of the same walk:

- ``peak_bytes`` — the *arena* model: one buffer per distinct var name,
  allocated at its first reference and held to the end of the step.
  Persistable vars (params, optimizer state, KV caches) are resident for
  the whole step. The ``inplace_reuse`` rewrite pass tightens it:
  renaming a dead buffer's successor onto it removes one arena slot.
- ``ideal_peak_bytes`` — the free-at-last-use interval sweep: what a
  perfect allocator could reach on the unfused graph. The port's
  compiled executor releases values at their last use, so its measured
  peak lies near this bound; the eager walk keeps every value, near the
  arena.

:func:`check_budget` turns an over-budget report into a structured
``hbm-oom`` diagnostic that the Executor raises before the program runs.
The budget (:func:`hbm_budget_bytes`) is ``PADDLE_TPU_HBM_BYTES`` when
set (``0`` disables the gate); unset, it is the executor device's total
memory as torch reports it on a CUDA card, and no gate on the CPU, which
has no device memory to read. (The JAX package defaults to one TPU
core's 16 GiB; that number is a TPU's and is not the port's.)
``publish_peak`` sets the ``paddle_tpu_memory_peak_bytes{job}`` gauge of
the observability registry (the generation engine publishes each step's
plan); the Trainer's publication is ROADMAP A11.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import flags
from ..core import ir
from .cost_model import _ITEMSIZE, _prod
from .diagnostics import Diagnostic, Severity, VerifyReport
from .passes import (AnalysisPass, PassContext, SUB_BLOCK_ATTRS,
                     register_pass)

__all__ = ["VarInterval", "MemoryReport", "program_memory",
           "MemoryPass", "check_budget", "hbm_budget_bytes"]

def hbm_budget_bytes(device=None) -> int:
    """The budget of the memory gate, in bytes: ``PADDLE_TPU_HBM_BYTES``
    when set (``0`` disables the gate); unset (or unreadable), the total
    memory of `device` when it is a CUDA card, else 0 — no gate."""
    raw = flags.get("PADDLE_TPU_HBM_BYTES")
    if raw.strip():
        try:
            return max(0, int(float(raw)))
        except (TypeError, ValueError):
            pass
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.get_device_properties(
            torch.device(device)).total_memory)
    return 0


def _fmt_bytes(n: int) -> str:
    if n >= 1024 ** 3:
        return f"{n / 1024 ** 3:.2f} GiB"
    if n >= 1024 ** 2:
        return f"{n / 1024 ** 2:.2f} MiB"
    return f"{n} B"


class VarInterval:
    """One planned buffer: a var name, its bound shape/bytes, and the
    [first, last] op-step interval over the global execution order."""

    __slots__ = ("name", "shape", "dtype", "bytes", "kind",
                 "first", "last")

    def __init__(self, name: str, shape: Optional[List[int]],
                 dtype: Optional[str], nbytes: int, kind: str,
                 first: int, last: int):
        self.name = name
        self.shape = shape
        self.dtype = dtype
        self.bytes = int(nbytes)
        self.kind = kind            # "resident" | "activation"
        self.first = int(first)
        self.last = int(last)

    def to_dict(self) -> Dict:
        return {"name": self.name, "shape": self.shape,
                "dtype": self.dtype, "bytes": self.bytes,
                "kind": self.kind, "first": self.first,
                "last": self.last}

    def __repr__(self):
        return (f"VarInterval({self.name!r}, {self.bytes} B, "
                f"{self.kind}, [{self.first}, {self.last}])")


class MemoryReport:
    """Liveness intervals plus the peak-HBM estimate of one block tree.

    ``peak_bytes`` is the arena (no mid-step free) watermark:
    ``resident_bytes`` + one buffer per distinct activation name.
    ``ideal_peak_bytes`` is the interval-sweep lower bound a perfect
    allocator could reach. ``high_water`` locates the op at which the
    arena watermark is reached (the last first-allocation)."""

    def __init__(self, intervals: List[VarInterval], n_ops: int,
                 batch: int, block_idx: int,
                 order: List[Tuple[Tuple[int, ...], int, str]],
                 unresolved: int, label: str = "program"):
        self.intervals = intervals
        self.n_ops = int(n_ops)
        self.batch = int(batch)
        self.block_idx = int(block_idx)
        self.unresolved = int(unresolved)
        self.label = label
        self.resident_bytes = sum(v.bytes for v in intervals
                                  if v.kind == "resident")
        self.activation_bytes = sum(v.bytes for v in intervals
                                    if v.kind == "activation")
        self.peak_bytes = self.resident_bytes + self.activation_bytes
        acts = [v for v in intervals
                if v.kind == "activation" and v.bytes]
        # arena watermark is non-decreasing: it tops out at the LAST
        # first-allocation of any non-empty activation buffer
        self.high_water_step = max((v.first for v in acts), default=0)
        self.high_water = None
        if order and 0 <= self.high_water_step < len(order):
            path, op_i, op_type = order[self.high_water_step]
            self.high_water = {"block_path": list(path),
                               "op_index": op_i, "op_type": op_type,
                               "step": self.high_water_step}
        # free-at-last-use sweep: the ideal-allocator lower bound
        delta: Dict[int, int] = {}
        for v in acts:
            delta[v.first] = delta.get(v.first, 0) + v.bytes
            delta[v.last + 1] = delta.get(v.last + 1, 0) - v.bytes
        cur = peak = 0
        for t in sorted(delta):
            cur += delta[t]
            peak = max(peak, cur)
        self.ideal_peak_bytes = self.resident_bytes + peak

    def top(self, k: int = 10) -> List[VarInterval]:
        """The k largest buffers live at the peak (under the arena
        model every planned buffer is live there)."""
        return sorted(self.intervals, key=lambda v: -v.bytes)[:k]

    def table(self, limit: int = 10) -> str:
        hw = ""
        if self.high_water is not None:
            loc = "/".join(str(b) for b in
                           self.high_water["block_path"])
            hw = (f", high water @ b{loc}:op"
                  f"{self.high_water['op_index']} "
                  f"({self.high_water['op_type']})")
        lines = [
            f"memory {self.label} (block {self.block_idx}, "
            f"batch={self.batch}): peak {_fmt_bytes(self.peak_bytes)} "
            f"= {_fmt_bytes(self.resident_bytes)} resident + "
            f"{_fmt_bytes(self.activation_bytes)} activations over "
            f"{self.n_ops} op(s){hw}; ideal-allocator bound "
            f"{_fmt_bytes(self.ideal_peak_bytes)}"
            + (f"; {self.unresolved} name(s) unresolved"
               if self.unresolved else ""),
            f"{'bytes':>14s} {'kind':>10s} {'live':>13s}  var",
        ]
        for v in self.top(limit):
            lines.append(
                f"{v.bytes:14d} {v.kind:>10s} "
                f"{f'[{v.first},{v.last}]':>13s}  {v.name} "
                f"{v.shape if v.shape is not None else '?'} "
                f"{v.dtype or '?'}")
        if len(self.intervals) > limit:
            lines.append(
                f"  ... {len(self.intervals) - limit} more buffer(s)")
        return "\n".join(lines)

    def to_dict(self, top_k: int = 10) -> Dict:
        return {
            "label": self.label, "block_idx": self.block_idx,
            "batch": self.batch, "n_ops": self.n_ops,
            "n_buffers": len(self.intervals),
            "peak_bytes": self.peak_bytes,
            "resident_bytes": self.resident_bytes,
            "activation_bytes": self.activation_bytes,
            "ideal_peak_bytes": self.ideal_peak_bytes,
            "high_water": self.high_water,
            "unresolved": self.unresolved,
            "top": [v.to_dict() for v in self.top(top_k)],
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def __repr__(self):
        return (f"MemoryReport({self.label}, "
                f"peak={self.peak_bytes}, "
                f"resident={self.resident_bytes}, "
                f"buffers={len(self.intervals)})")


# ---------------------------------------------------------------------------
def program_memory(program, block_idx: int = 0,
                   feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
                   batch: Optional[int] = None,
                   feed_names: Optional[Sequence[str]] = None,
                   label: Optional[str] = None) -> MemoryReport:
    """Liveness + peak-HBM plan for ``program`` (Python wrapper or
    core ``ir.Program``), rooted at ``block_idx``.

    Walks ops in EXECUTION order (an op's inputs are read before its
    sub-blocks run; its outputs are written after), so sub-block
    references land between the enclosing op's reads and writes.
    Buffers are keyed by var name program-wide — exactly the executor's
    name-keyed trace env. Feeds are materialized before op 0, so their
    intervals are pinned to start at step 0.
    """
    desc = program.desc if hasattr(program, "desc") else program
    feed_shapes = {k: tuple(int(d) for d in v)
                   for k, v in (feed_shapes or {}).items()}
    feeds = set(feed_names if feed_names is not None
                else feed_shapes.keys())
    root = desc.blocks[block_idx]
    if batch is None:
        batch = 1
        for name, shape in feed_shapes.items():
            v = root.find_var_recursive(name)
            if v is not None and v.shape and shape \
                    and len(v.shape) == len(shape) and v.shape[0] == -1:
                batch = int(shape[0])
                break
    batch = max(1, int(batch))

    order: List[Tuple[Tuple[int, ...], int, str]] = []
    # name -> [shape, dtype, bytes, persistable, resolvable, first, last]
    bufs: Dict[str, list] = {}
    resolve_cache: Dict[Tuple[int, str], Optional[tuple]] = {}

    def resolve(blk: ir.BlockDesc, name: str) -> Optional[tuple]:
        key = (blk.idx, name)
        if key in resolve_cache:
            return resolve_cache[key]
        v = blk.find_var_recursive(name)
        spec = None
        if v is not None:
            if name in feed_shapes:
                shape = list(feed_shapes[name])
            elif v.shape is not None:
                shape = [
                    (batch if j == 0 else 1)
                    if (not isinstance(d, int) or d == -1) else int(d)
                    for j, d in enumerate(v.shape)]
            else:
                shape = None
            nbytes = (_prod(shape)
                      * _ITEMSIZE.get(v.dtype or "float32", 4)
                      if shape is not None else 0)
            spec = (shape, v.dtype, nbytes, bool(v.persistable),
                    shape is not None)
        resolve_cache[key] = spec
        return spec

    def touch(blk: ir.BlockDesc, name: str, t: int):
        buf = bufs.get(name)
        if buf is None:
            spec = resolve(blk, name)
            if spec is None:
                return
            bufs[name] = list(spec) + [t, t]
        else:
            buf[5] = min(buf[5], t)
            buf[6] = max(buf[6], t)

    seen_blocks: set = set()

    def visit(blk: ir.BlockDesc, path: Tuple[int, ...]):
        if blk.idx in seen_blocks:
            return
        seen_blocks.add(blk.idx)
        for i, op in enumerate(blk.ops):
            t = len(order)
            order.append((path, i, op.type))
            for name in op.input_names():
                touch(blk, name, t)
            for attr in SUB_BLOCK_ATTRS:
                idx = op.attrs.get(attr)
                if isinstance(idx, int) \
                        and 0 <= idx < len(desc.blocks):
                    visit(desc.blocks[idx], path + (idx,))
            # writes land after the op's sub-blocks finished: the last
            # step issued so far (== t when there is no sub-block)
            t_out = len(order) - 1
            for name in op.output_names():
                touch(blk, name, t_out)

    # feeds exist before the first op runs
    for name in sorted(feeds):
        touch(root, name, 0)
    visit(root, (block_idx,))

    n_ops = len(order)
    last_step = max(0, n_ops - 1)
    intervals: List[VarInterval] = []
    unresolved = 0
    for name, (shape, dtype, nbytes, persistable, resolvable,
               first, last) in sorted(bufs.items()):
        if not resolvable:
            unresolved += 1
        if persistable:
            # params / optimizer state / KV caches: resident all step
            intervals.append(VarInterval(name, shape, dtype, nbytes,
                                         "resident", 0, last_step))
        else:
            if name in feeds:
                first = 0
            intervals.append(VarInterval(name, shape, dtype, nbytes,
                                         "activation", first, last))
    return MemoryReport(intervals, n_ops, batch, block_idx, order,
                        unresolved,
                        label=label or f"program uid={desc.uid}")


# ---------------------------------------------------------------------------
def check_budget(report: MemoryReport, budget: Optional[int] = None,
                 top_k: int = 5) -> VerifyReport:
    """Diagnose ``report.peak_bytes`` against the budget (default
    :func:`hbm_budget_bytes` with no device: the environment's, or none).

    Returns a :class:`VerifyReport` that is clean when the plan fits
    (or the gate is disabled with budget 0) and carries one structured
    ``hbm-oom`` ERROR — top-K offenders, high-water op index, fix
    hint — when it does not. Callers gate with ``raise_if_errors()``.
    """
    if budget is None:
        budget = hbm_budget_bytes()
    vr = VerifyReport(program_label=report.label)
    vr.memory = report
    if budget <= 0 or report.peak_bytes <= budget:
        return vr
    offenders = ", ".join(
        f"{v.name} {_fmt_bytes(v.bytes)} ({v.kind})"
        for v in report.top(top_k))
    hw = report.high_water or {}
    vr.add(Diagnostic(
        Severity.ERROR, "hbm-oom",
        f"static peak-HBM estimate {_fmt_bytes(report.peak_bytes)} "
        f"({_fmt_bytes(report.resident_bytes)} resident + "
        f"{_fmt_bytes(report.activation_bytes)} activations) exceeds "
        f"the {_fmt_bytes(budget)} budget; top buffers: {offenders}",
        block_path=hw.get("block_path") or (report.block_idx,),
        op_index=hw.get("op_index"), op_type=hw.get("op_type"),
        hint="reduce batch/sequence length or cache buckets, keep "
             "PADDLE_TPU_INPLACE_REUSE=1, or raise PADDLE_TPU_HBM_BYTES "
             "(0 disables this gate); the estimate is the arena "
             "(no-reuse) upper bound — see the `memory` analysis pass"))
    return vr


# ---------------------------------------------------------------------------
@register_pass
class MemoryPass(AnalysisPass):
    """Attach a :class:`MemoryReport` to the verify report
    (``report.memory``). Like the cost pass it produces no diagnostics
    by itself — budget enforcement is :func:`check_budget`, wired into
    the Executor's pre-compile gate."""

    name = "memory"

    def __init__(self, feed_shapes=None, batch=None):
        self.feed_shapes = feed_shapes
        self.batch = batch

    def run(self, ctx: PassContext) -> None:
        ctx.report.memory = program_memory(
            ctx.program, ctx.block_idx, feed_shapes=self.feed_shapes,
            batch=self.batch, feed_names=ctx.feed_names,
            label=ctx.report.program_label)


_obs_cache = None


def publish_peak(job: str, peak_bytes: int) -> None:
    """Best-effort gauge of the most recent dispatch's static peak
    (``paddle_tpu_memory_peak_bytes{job}``), the family cached per
    registry."""
    global _obs_cache
    try:
        from ..observability import default_registry
        reg = default_registry()
        if reg is None:
            return
        cache = _obs_cache
        if cache is None or cache[0] is not reg:
            g = reg.gauge(
                "paddle_tpu_memory_peak_bytes",
                "Static pre-compile peak-HBM estimate of the most "
                "recently dispatched program (arena model, bytes)",
                ("job",))
            cache = _obs_cache = (reg, g)
        cache[1].labels(job=str(job)).set(float(peak_bytes))
    except Exception:  # noqa: BLE001 — telemetry must never break a run
        pass
