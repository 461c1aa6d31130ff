"""ProgramDesc rewrite passes: the transform layer on the analysis
framework.

The port's copy of ``paddle_tpu/analysis/rewrite.py``: the same nine
passes in the same order, so a program rewritten by either package comes
out the same (``to_json`` for ``to_json``).

- ``const_fold``     constant folding of ops whose inputs are all
                     startup-independent literals (fill_constant /
                     assign_value chains), evaluated on the CPU with the
                     op's own compute rule and written into the program
                     as an ``assign_value`` literal;
- ``cse``            common-subexpression elimination over pure ops
                     with identical inputs and attrs;
- ``dce``            dead-op elimination (liveness against the fetch
                     set, same effect rules as the dead_code verifier
                     pass, but conservative enough to delete);
- ``grad_prune``     dead-gradient pruning: ``__vjp__`` outputs nobody
                     reads are dropped, cascading up dead chains;
- ``fuse_attention`` pattern-match the composed scaled-dot-product
                     attention chain (matmul -> [scale] -> [+mask] ->
                     softmax -> matmul) and outline it into ONE
                     ``scaled_dot_product_attention`` op — the op that
                     routes to the flash-attention kernels — with the
                     chain's ``__vjp__`` grad ops merged into one
                     ``__vjp__`` of it, so the backward kernels engage
                     too;
- ``fuse_se``        same outlining for the SE (squeeze-excitation)
                     block into a ``se_block`` op (ops/fusion_ops.py);
- ``kernel_dispatch`` stamp the kernel route onto lstm/gru (and sdpa)
                     ops as a program attr (``__pallas__``/``use_flash``)
                     from the PADDLE_TPU_PALLAS_* knobs: the one copy of
                     that decision in the port;
- ``inplace_reuse``  rename an op's output onto a dead same-signature
                     buffer.

Safety contract: every pass runs on a CLONE; after each pass the
``fast_passes()`` verifier re-checks the program and a failed
verification discards that pass's changes. The executor falls back to
the unrewritten program when the pipeline raises. Rewrites never touch
persistable state names, never remove ops with sub-blocks or host side
effects, and never rename a name referenced from op attrs (control-flow
carried/cond names).

Wired into both executors' compile-cache-miss path behind
``PADDLE_TPU_OPTIMIZE`` (default on, flags.py). The JAX package also
publishes the pipeline's time and action counts to its observability
registry; the port's hook is ROADMAP A11.
"""
from __future__ import annotations

import copy
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import flags
from ..core import ir
from ..core.ir import SUB_BLOCK_ATTRS
from ..core.registry import OpRegistry, run_op
from .cost_model import ITEMSIZE as _ITEMSIZE
from .passes import fast_passes, iter_blocks, iter_ops, rw_state_names
from .verifier import verify_program

__all__ = ["optimize_enabled", "RewritePass", "RewriteResult",
           "default_rewrite_passes", "rewrite_program",
           "REWRITE_PASS_REGISTRY"]

#: build-time bookkeeping attrs — never part of an op's semantic identity
_MARKER_ATTRS = ("__shape_infer_skipped__", "__shape_infer_conflict__",
                 "__dead_vars__")

#: ops whose compute draws from the per-step PRNG (or host state) —
#: never CSE'd, never folded
_RANDOM_OPS = frozenset({
    "dropout", "uniform_random", "gaussian_random",
    "truncated_gaussian_random", "randint", "sampling_id", "nce",
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
})

#: plumbing ops that must survive any rewrite
_KEEP_OPS = frozenset({"feed", "fetch", "print"})


def optimize_enabled() -> bool:
    """The PADDLE_TPU_OPTIMIZE kill switch, read per call (same pattern
    as verifier.verify_enabled)."""
    return flags.get("PADDLE_TPU_OPTIMIZE") != "0"


def _desc(program) -> ir.Program:
    return program.desc if hasattr(program, "desc") else program


def _has_sub_block(op: ir.OpDesc) -> bool:
    return any(isinstance(op.attrs.get(a), int) for a in SUB_BLOCK_ATTRS)


def _is_stateful(op: ir.OpDesc) -> bool:
    """Host-side effects: the op's own compute, or — for the generic
    grad op — the embedded forward op it REPLAYS under autograd."""
    if not OpRegistry.has(op.type):
        return True  # unknown op: assume the worst
    if OpRegistry.get(op.type).stateful:
        return True
    if op.type == "__vjp__":
        fwd_type = (op.attrs.get("fwd_op") or {}).get("type")
        if fwd_type is None or not OpRegistry.has(fwd_type):
            return True
        return OpRegistry.get(fwd_type).stateful
    return False


# -- literal lists -------------------------------------------------------
# An assign_value literal carries its values as one attr list: a causal
# mask at S 2048 is 4M floats, a position table 1M. Such a list names no
# var and no pass changes it in place, so one pipeline run shares it
# between its clones (by identity) and reads each one once: whether it is
# all numbers, and its key for CSE. Results are the same as with deep
# copies and full walks; the run takes seconds less at full width.
_RUN = threading.local()
_LITERAL_MIN = 256
_NUMBER_TYPES = frozenset({int, float, bool})


def _literal(v) -> bool:
    """True when `v` is a long list of numbers (memoized per run)."""
    if type(v) not in (list, tuple) or len(v) < _LITERAL_MIN:
        return False
    memo = getattr(_RUN, "memo", None)
    hit = memo.get(id(v)) if memo is not None else None
    if hit is None:
        kinds = set(map(type, v))
        hit = [v, kinds <= _NUMBER_TYPES, None, kinds]
        if memo is not None:
            memo[id(v)] = hit
    return hit[1]


def _literal_key(v):
    """A key of a literal list equal for two lists exactly when their
    json.dumps are (memoized per run): a list of floats only by the
    bytes of its float64 values (json writes each float's repr, one
    string per value; numpy's NaN is the one NaN a literal holds), any
    other by its JSON."""
    memo = getattr(_RUN, "memo", None)
    hit = memo.get(id(v)) if memo is not None else None
    if hit is None:
        _literal(v)
        hit = memo.get(id(v)) if memo is not None else None
        if hit is None:
            return ("json", json.dumps(v))
    if hit[2] is None:
        hit[2] = ("f64", np.asarray(v, np.float64).tobytes()) \
            if hit[3] == {float} else ("json", json.dumps(v))
    return hit[2]


def _clone(program: ir.Program) -> ir.Program:
    """``program.clone()``, with its literal lists shared, not copied."""
    keep = {}
    for blk in program.blocks:
        for op in blk.ops:
            for v in op.attrs.values():
                if _literal(v):
                    keep[id(v)] = v
    return ir.Program.from_dict(copy.deepcopy(program.to_dict(), keep))


def _attrs_key(attrs: Dict[str, Any]) -> Tuple:
    """A key equal for two attr dicts exactly when their
    ``json.dumps(..., sort_keys=True, default=str)`` are equal, with the
    literal lists' keys memoized."""
    lits = tuple(sorted((k, _literal_key(v)) for k, v in attrs.items()
                        if _literal(v)))
    rest = {k: v for k, v in attrs.items() if not _literal(v)}
    return json.dumps(rest, sort_keys=True, default=str), lits


def _attr_referenced_names(program: ir.Program, block_idx: int
                           ) -> Set[str]:
    """Every string appearing in op attrs (except the embedded
    ``fwd_op`` replay dicts and build-time markers). Control-flow ops read
    outer vars by attr name (``cond_name``, ``carried_names``, ...);
    any such name must be treated as live and never renamed."""
    names: Set[str] = set()

    def collect(v):
        if isinstance(v, str):
            names.add(v)
        elif isinstance(v, (list, tuple)):
            if _literal(v):
                return
            for e in v:
                collect(e)
        elif isinstance(v, dict):
            for e in v.values():
                collect(e)

    for _blk, _path, _i, op in iter_ops(program, block_idx):
        for key, v in op.attrs.items():
            if key == "fwd_op" or key in _MARKER_ATTRS:
                continue
            collect(v)
    return names


def _writer_counts(program: ir.Program, block_idx: int) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for _blk, _path, _i, op in iter_ops(program, block_idx):
        for n in op.output_names():
            counts[n] = counts.get(n, 0) + 1
    return counts


def _clean_attrs(op: ir.OpDesc) -> Dict[str, Any]:
    return {k: v for k, v in op.attrs.items() if k not in _MARKER_ATTRS}


class RewriteContext:
    """Everything one rewrite pass may consult (mirror of PassContext,
    for transforms)."""

    def __init__(self, block_idx: int = 0,
                 feed_names: Optional[Sequence[str]] = None,
                 fetch_names: Optional[Sequence[str]] = None):
        self.block_idx = block_idx
        self.feed_names = set(feed_names or ())
        self.fetch_names = list(fetch_names or ())


class RewritePass:
    """Base class: subclasses set ``name`` and implement
    ``apply(program, ctx) -> list[action dict]`` mutating ``program``
    in place. Actions are ``{"action": ..., "op_type": ..., ...}``."""

    name = "rewrite"

    def apply(self, program: ir.Program, ctx: RewriteContext
              ) -> List[Dict]:
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


REWRITE_PASS_REGISTRY: Dict[str, type] = {}


def register_rewrite_pass(cls):
    REWRITE_PASS_REGISTRY[cls.name] = cls
    return cls


# ---------------------------------------------------------------------------
# dead-op elimination
# ---------------------------------------------------------------------------
@register_rewrite_pass
class DeadOpElimination(RewritePass):
    """Remove root-block ops that contribute to no fetch target and have
    no effects. The liveness mirrors the ``dead_code`` verifier pass,
    tightened for deletion: ops with sub-blocks, host-stateful ops,
    persistable writers, and plumbing (feed/fetch/print) are always
    kept, and every name read from a sub-block (closure) or referenced
    from an op attr (control-flow carried/cond names) is a liveness
    root."""

    name = "dce"

    def apply(self, program, ctx) -> List[Dict]:
        root = program.blocks[ctx.block_idx]
        needed: Set[str] = set(ctx.fetch_names)
        needed |= _attr_referenced_names(program, ctx.block_idx)
        # closure reads: every input of every reachable non-root op
        for blk, _path in iter_blocks(program, ctx.block_idx):
            if blk is root:
                continue
            for op in blk.ops:
                needed.update(op.input_names())

        def must_keep(op: ir.OpDesc) -> bool:
            if op.type in _KEEP_OPS or _has_sub_block(op) \
                    or _is_stateful(op):
                return True
            for n in op.output_names():
                v = root.find_var_recursive(n)
                if v is not None and v.persistable:
                    return True
            return False

        keep = [False] * len(root.ops)
        for i in range(len(root.ops) - 1, -1, -1):
            op = root.ops[i]
            if must_keep(op) or needed.intersection(op.output_names()):
                keep[i] = True
                needed.update(op.input_names())

        actions: List[Dict] = []
        for i in range(len(root.ops) - 1, -1, -1):
            if not keep[i]:
                actions.append({"action": "remove_op",
                                "op_type": root.ops[i].type,
                                "op_index": i})
                del root.ops[i]
        if actions:
            program._bump_version()
        return actions


# ---------------------------------------------------------------------------
# common-subexpression elimination
# ---------------------------------------------------------------------------
@register_rewrite_pass
class CommonSubexpressionElimination(RewritePass):
    """Merge root-block ops with identical (type, inputs, attrs): the
    second op is removed and every read of its outputs is renamed to the
    first op's outputs (the read must RESOLVE to the root declaration —
    shadowed sub-block names are left alone). Only pure, single-writer,
    non-random ops participate; ops whose outputs are fetched,
    persistable, or attr-referenced are skipped."""

    name = "cse"

    def apply(self, program, ctx) -> List[Dict]:
        root = program.blocks[ctx.block_idx]
        writers = _writer_counts(program, ctx.block_idx)
        attr_names = _attr_referenced_names(program, ctx.block_idx)
        fetches = set(ctx.fetch_names)
        alias: Dict[str, str] = {}
        # single-writer positions: (block idx, op idx) — the ordering
        # check below needs to know WHERE the one write happens
        writer_pos: Dict[str, Tuple[int, int]] = {}
        for blk, _path, j, op in iter_ops(program, ctx.block_idx):
            for n in op.output_names():
                writer_pos[n] = (blk.idx, j)

        def resolve(n: str) -> str:
            while n in alias:
                n = alias[n]
            return n

        def mergeable(op: ir.OpDesc) -> bool:
            if op.type in _KEEP_OPS or op.type in _RANDOM_OPS \
                    or _has_sub_block(op) or _is_stateful(op):
                return False
            if op.type == "__vjp__":
                fwd = (op.attrs.get("fwd_op") or {}).get("type")
                if fwd in _RANDOM_OPS or fwd is None:
                    return False
            outs = op.output_names()
            if not outs:
                return False
            for n in outs:
                v = root.find_var_recursive(n)
                if v is None or v.persistable or n in fetches \
                        or n in attr_names or writers.get(n, 0) != 1:
                    return False
            # inputs must be single-assignment so both occurrences see
            # the same value (feeds / startup-initialized persistables
            # have zero in-program writers); once-written inputs get an
            # ordering check at merge time
            for n in op.input_names():
                if writers.get(resolve(n), 0) > 1:
                    return False
            return True

        def same_value(op: ir.OpDesc, i1: int, i2: int) -> bool:
            """Both candidate positions observe the same input values:
            every once-written input's single write must be a ROOT op
            strictly outside the [first, second] candidate span — a
            persistable param updated by its optimizer between a
            pre-update and a post-update read (sgd writes it exactly
            once), or an in-place self-write where one CANDIDATE is
            the writer (increment(x, in_place=True) at i1 or i2),
            would otherwise alias a read to the wrong-epoch value."""
            for n in op.input_names():
                rn = resolve(n)
                if writers.get(rn, 0) != 1:
                    continue  # zero writers: feed / startup-initialized
                blk_idx, p = writer_pos[rn]
                if blk_idx != root.idx:
                    return False  # sub-block write: order unknowable
                if i1 <= p <= i2:
                    return False
            return True

        seen: Dict[Tuple, Tuple[ir.OpDesc, int]] = {}
        removed: List[int] = []
        actions: List[Dict] = []
        for i, op in enumerate(root.ops):
            if not mergeable(op):
                continue
            key = (op.type,
                   json.dumps({s: [resolve(n) for n in ns]
                               for s, ns in sorted(op.inputs.items())}),
                   _attrs_key(_clean_attrs(op)),
                   json.dumps(sorted((s, len(ns))
                              for s, ns in op.outputs.items())))
            hit = seen.get(key)
            if hit is None:
                seen[key] = (op, i)
                continue
            first, i1 = hit
            if not same_value(op, i1, i):
                continue
            ok = True
            pairs = []
            for slot, names in op.outputs.items():
                fnames = first.outputs.get(slot, [])
                if len(fnames) != len(names):
                    ok = False
                    break
                pairs.extend(zip(names, fnames))
            if not ok:
                continue
            for dup, keep_name in pairs:
                alias[dup] = keep_name
            removed.append(i)
            actions.append({"action": "merge_op", "op_type": op.type,
                            "op_index": i})

        if not removed:
            return []
        for i in reversed(removed):
            del root.ops[i]
        # rename reads program-wide where resolution reaches the root
        # declaration (a same-named sub-block var shadows and stays)
        for blk, _path in iter_blocks(program, ctx.block_idx):
            for op in blk.ops:
                for slot, names in op.inputs.items():
                    op.inputs[slot] = [
                        resolve(n) if n in alias and
                        blk.find_var_recursive(n) is root.vars.get(n)
                        else n
                        for n in names]
                # legacy memory-optimize annotations may pin liveness
                # decisions made before the merge — scrub touched names
                dead = op.attrs.get("__dead_vars__")
                if dead:
                    op.attrs["__dead_vars__"] = [
                        n for n in dead
                        if n not in alias and n not in alias.values()]
        program._bump_version()
        return actions


# ---------------------------------------------------------------------------
# constant folding
# ---------------------------------------------------------------------------
@register_rewrite_pass
class ConstantFolding(RewritePass):
    """Evaluate ops whose inputs are all literal constants and replace
    them with ``assign_value`` ops carrying the result. Evaluation runs
    the op's own compute rule on CPU tensors (the same math a run
    would do); folding is capped at ``MAX_ELEMS`` output elements so the
    program JSON never bloats."""

    name = "const_fold"

    #: literal producers that seed the constant environment
    SOURCE_OPS = frozenset({"fill_constant", "assign_value", "fill"})
    #: pure shape/arith ops safe to evaluate ahead of time
    FOLDABLE_OPS = frozenset({
        "cast", "scale", "reshape", "reshape2", "transpose",
        "transpose2", "unsqueeze", "squeeze", "concat",
        "elementwise_add", "elementwise_sub", "elementwise_mul",
        "elementwise_div", "elementwise_max", "elementwise_min",
        "elementwise_pow", "sum", "reduce_sum", "reduce_mean",
        "reduce_max", "reduce_min", "reduce_prod", "matmul", "mul",
        "one_hot", "expand", "stack", "relu", "abs", "sign",
        "fill_zeros_like", "fill_constant_like", "equal", "less_than",
        "logical_not", "logical_and", "logical_or", "ones_like",
        "zeros_like",
    })
    MAX_ELEMS = 65536
    _SAFE_DTYPES = frozenset({"float32", "float64", "int32", "int64",
                              "int16", "int8", "uint8", "bool"})

    _SAFE_TORCH = frozenset({torch.float32, torch.float64, torch.int32,
                             torch.int64, torch.int16, torch.int8,
                             torch.uint8, torch.bool})

    def apply(self, program, ctx) -> List[Dict]:
        root = program.blocks[ctx.block_idx]
        writers = _writer_counts(program, ctx.block_idx)
        fetches = set(ctx.fetch_names)
        consts: Dict[str, np.ndarray] = {}
        actions: List[Dict] = []
        cpu = {"device": torch.device("cpu")}

        def out_ok(name: str) -> bool:
            v = root.find_var_recursive(name)
            return (v is not None and not v.persistable
                    and name not in fetches
                    and writers.get(name, 0) == 1)

        def too_big(op: ir.OpDesc) -> bool:
            # a literal source whose shape attr already exceeds the cap
            # would be evaluated only to be refused below (a causal mask
            # of S x S floats at S 2048 is 4M of them)
            shape = op.attrs.get("shape")
            if not isinstance(shape, (list, tuple)) or \
                    not all(isinstance(d, int) and d >= 0 for d in shape):
                return False
            n = 1
            for d in shape:
                n *= d
            return n > self.MAX_ELEMS

        def evaluate(op: ir.OpDesc) -> Optional[np.ndarray]:
            env = {n: torch.as_tensor(consts[n])
                   for n in op.input_names()}
            try:
                outs = run_op(op, env, cpu)
            except Exception:
                return None
            name = op.output_names()[0]
            t = outs.get(name)
            if not isinstance(t, torch.Tensor) \
                    or t.dtype not in self._SAFE_TORCH \
                    or t.numel() > self.MAX_ELEMS:
                return None
            val = t.detach().cpu().numpy()
            if val.dtype.name not in self._SAFE_DTYPES:
                return None
            return val

        for i, op in enumerate(root.ops):
            outs = op.output_names()
            if op.type in self.SOURCE_OPS:
                if len(outs) == 1 and out_ok(outs[0]) \
                        and not op.input_names() and not too_big(op):
                    val = evaluate(op)
                    if val is not None:
                        consts[outs[0]] = val
                continue
            if op.type not in self.FOLDABLE_OPS or len(outs) != 1 \
                    or not out_ok(outs[0]) or _has_sub_block(op):
                continue
            ins = op.input_names()
            if not ins or any(n not in consts for n in ins):
                continue
            val = evaluate(op)
            if val is None:
                continue
            consts[outs[0]] = val
            root.ops[i] = ir.OpDesc(
                "assign_value", {}, {"Out": [outs[0]]},
                {"shape": list(val.shape),
                 "dtype": ir.canon_dtype(val.dtype.name),
                 "values": val.reshape(-1).tolist(),
                 "__folded_from__": op.type})
            actions.append({"action": "fold_op", "op_type": op.type,
                            "op_index": i})
        if actions:
            program._bump_version()
        return actions


# ---------------------------------------------------------------------------
# dead-gradient pruning
# ---------------------------------------------------------------------------
@register_rewrite_pass
class DeadGradPruning(RewritePass):
    """Trim ``__vjp__`` gradient outputs nobody consumes.

    The generic grad op computes one cotangent per ``in_need_grad=True``
    entry; a gradient that flows to no optimizer, no fetch, and no
    downstream grad op is pure wasted backward compute (the classic
    case: an attention mask built from ``cast(equal(...))`` — the mask
    is float and differentiable, so backward dutifully grinds out
    mask-path gradients that dead-end at the non-differentiable cast).
    Flipping the flag to False removes that cotangent from the vjp; a
    grad op left with NO outputs is deleted, which un-reads ITS
    out-grads and lets the pruning cascade up the dead chain. Besides
    the saved compute, this unblocks fusion outlining on masked
    attention (the outliner refuses sites whose mask needs a
    gradient)."""

    name = "grad_prune"

    def apply(self, program, ctx) -> List[Dict]:
        root = program.blocks[ctx.block_idx]
        fetches = set(ctx.fetch_names)
        attr_names = _attr_referenced_names(program, ctx.block_idx)
        actions: List[Dict] = []
        changed = True
        while changed:
            changed = False
            readers: Dict[str, int] = {}
            for _blk, _path, _i, op in iter_ops(program, ctx.block_idx):
                for n in op.input_names():
                    readers[n] = readers.get(n, 0) + 1
            drop: List[int] = []
            for i, op in enumerate(root.ops):
                if op.type == "sum":
                    # gradient-accumulator sums orphaned by an earlier
                    # trim: removing them un-reads their contributions
                    # so the prune cascades through multi-consumer vars
                    outs = op.output_names()
                    if outs and all(
                            readers.get(n, 0) == 0 and n not in fetches
                            and n not in attr_names
                            and (root.find_var_recursive(n) is None
                                 or not root.find_var_recursive(n)
                                 .persistable)
                            for n in outs):
                        drop.append(i)
                        changed = True
                        actions.append({"action": "remove_op",
                                        "op_type": "sum",
                                        "op_index": i})
                    continue
                if op.type != "__vjp__" or _is_stateful(op):
                    continue
                fwd = ir.OpDesc.from_dict(op.attrs.get("fwd_op") or {})
                entries = fwd.input_names() + list(
                    op.attrs.get("closure_names") or [])
                need = list(op.attrs.get("in_need_grad") or [])
                grads = list(op.outputs.get("InGrad", []))
                if len(entries) != len(need) \
                        or sum(map(bool, need)) != len(grads):
                    continue  # malformed bookkeeping: leave untouched
                gi = 0
                kept: List[str] = []
                pruned = False
                for pos, nd in enumerate(need):
                    if not nd:
                        continue
                    g = grads[gi]
                    gi += 1
                    v = root.find_var_recursive(g)
                    if readers.get(g, 0) == 0 and g not in fetches \
                            and g not in attr_names \
                            and (v is None or not v.persistable):
                        need[pos] = False
                        pruned = True
                        actions.append({"action": "prune_grad",
                                        "op_type": fwd.type, "var": g})
                    else:
                        kept.append(g)
                if not pruned:
                    continue
                changed = True
                if kept:
                    op.outputs["InGrad"] = kept
                    op.attrs["in_need_grad"] = need
                else:
                    # outputless grad op: delete it so its out-grads
                    # become unread and the prune cascades upstream
                    drop.append(i)
                    actions.append({"action": "remove_op",
                                    "op_type": op.type, "op_index": i})
            for i in reversed(drop):
                del root.ops[i]
        if actions:
            program._bump_version()
        return actions


# ---------------------------------------------------------------------------
# subgraph outlining machinery (shared by the attention and SE passes)
# ---------------------------------------------------------------------------
class _Graph:
    """Reader/writer index over one program snapshot."""

    def __init__(self, program: ir.Program, block_idx: int,
                 ctx: RewriteContext):
        self.program = program
        self.block_idx = block_idx
        self.root = program.blocks[block_idx]
        self.fetches = set(ctx.fetch_names)
        self.attr_names = _attr_referenced_names(program, block_idx)
        self.writers: Dict[str, List[ir.OpDesc]] = {}
        self.readers: Dict[str, List[ir.OpDesc]] = {}
        self.nonroot_readers: Dict[str, List[ir.OpDesc]] = {}
        for blk, _path, _i, op in iter_ops(program, block_idx):
            for n in op.output_names():
                self.writers.setdefault(n, []).append(op)
            tgt = self.readers if blk is self.root \
                else self.nonroot_readers
            for n in set(op.input_names()):
                tgt.setdefault(n, []).append(op)

    def sole_root_producer(self, name: str) -> Optional[ir.OpDesc]:
        ws = self.writers.get(name, [])
        if len(ws) != 1:
            return None
        op = ws[0]
        return op if op in self.root.ops else None

    def internal_ok(self, name: str, allowed: Set[int]) -> bool:
        """True when ``name`` is a pure intermediate: declared
        non-persistable, single writer, not fetched or attr-referenced,
        and every reader is in ``allowed`` (a set of id(op))."""
        v = self.root.find_var_recursive(name)
        if v is None or v.persistable or name in self.fetches \
                or name in self.attr_names:
            return False
        if len(self.writers.get(name, [])) != 1:
            return False
        if self.nonroot_readers.get(name):
            return False
        return all(id(r) in allowed for r in self.readers.get(name, []))


def _vjp_of(graph: _Graph, fwd_op: ir.OpDesc) -> Optional[ir.OpDesc]:
    """The __vjp__ op embedding ``fwd_op`` (matched on type + exact
    input/output wiring — attr drift, e.g. build-time markers stamped after
    backward ran, is tolerated)."""
    found = None
    for op in graph.root.ops:
        if op.type != "__vjp__":
            continue
        fwd = op.attrs.get("fwd_op") or {}
        if fwd.get("type") == fwd_op.type \
                and fwd.get("inputs") == fwd_op.inputs \
                and fwd.get("outputs") == fwd_op.outputs:
            if found is not None:
                return None  # ambiguous: refuse
            found = op
    return found


def _vjp_grad_map(bop: ir.OpDesc) -> List[Tuple[str, str]]:
    """[(fwd input name, produced grad name)] for one __vjp__ op."""
    fwd = ir.OpDesc.from_dict(bop.attrs["fwd_op"])
    entries = fwd.input_names() + list(
        bop.attrs.get("closure_names") or [])
    need = bop.attrs.get("in_need_grad") or []
    grads = bop.outputs.get("InGrad", [])
    out: List[Tuple[str, str]] = []
    gi = 0
    for name, n in zip(entries, need):
        if n:
            if gi < len(grads):
                out.append((name, grads[gi]))
            gi += 1
    return out


_OUTLINE_UID = [0]


def _outline_subgraph(graph: _Graph, chain: List[ir.OpDesc],
                      mega: ir.OpDesc, out_name: str,
                      interface_in: List[str]) -> bool:
    """Replace ``chain`` (forward ops, dataflow order, last op produces
    ``out_name``) with ``mega``, merging the chain's ``__vjp__`` grad
    ops — when present — into one ``__vjp__`` of ``mega``. Returns False
    (program untouched) when any safety condition fails.

    ``interface_in`` is the mega op's flattened input-name order (the
    order ``mega.input_names()`` yields); duplicates allowed.
    """
    root = graph.root
    program = graph.program
    chain_ids = {id(o) for o in chain}

    # backward set: one vjp per chain op that has one (an ambiguous
    # match resolves to None; the orphaned vjps then trip the
    # intermediate-visibility checks below, refusing the site)
    vjps: Dict[int, ir.OpDesc] = {}
    for op in chain:
        b = _vjp_of(graph, op)
        if b is not None:
            vjps[id(op)] = b
    b_ops = list(vjps.values())
    b_ids = {id(b) for b in b_ops}
    allowed = chain_ids | b_ids

    # chain intermediates must be invisible outside the outlined region
    produced_names = {n for o in chain for n in o.output_names()}
    for name in produced_names:
        if name == out_name:
            continue
        if not graph.internal_ok(name, allowed):
            return False
    # the chain output keeps its name; the mega op writes it
    if len(graph.writers.get(out_name, [])) != 1:
        return False

    merged_vjp = None
    first_b_op = None
    if b_ops:
        last_op = chain[-1]
        tail_vjp = vjps.get(id(last_op))
        if tail_vjp is None:
            return False
        # grads of intermediates must stay inside B; grads of interface
        # inputs are the merged op's outputs
        iface_set = set(interface_in)
        produced_grads: Dict[str, List[str]] = {}
        for b in b_ops:
            for fwd_in, gname in _vjp_grad_map(b):
                if fwd_in in iface_set:
                    produced_grads.setdefault(fwd_in, []).append(gname)
                else:
                    if not graph.internal_ok(gname, allowed):
                        return False
            # every OutGrad must be produced inside B, except the tail's
            for g in b.inputs.get("OutGrad", []):
                ws = graph.writers.get(g, [])
                internal = ws and all(id(w) in b_ids for w in ws)
                if b is tail_vjp:
                    if internal:
                        return False
                elif not internal:
                    return False
        out_grads = tail_vjp.inputs.get("OutGrad", [])
        if len(out_grads) != 1:
            return False
        # mask-style inputs whose grad the original program consumed
        # outside the region are only safe when the merged op also
        # produces them — handled below; inputs with NO produced grad
        # simply get in_need_grad=False.
        grad_out_names: List[str] = []
        in_need: List[bool] = []
        #: (accumulator sum op, contribution names to drop, fresh
        #: merged grad name, source fwd var to copy shape/dtype from)
        sum_edits: List[Tuple[ir.OpDesc, List[str], str, str]] = []
        # a duplicated interface name only carries gradient at its LAST
        # position: the __vjp__ replay binds env[name] sequentially, so
        # earlier positional args of the same name see zero cotangents
        # (backward.py's accumulator sums them away; here we just skip
        # the dead positions)
        last_pos = {n: i for i, n in enumerate(interface_in)}
        for pos, name in enumerate(interface_in):
            if last_pos[name] != pos:
                in_need.append(False)
                continue
            gnames = produced_grads.get(name, [])
            if not gnames:
                in_need.append(False)
                continue
            in_need.append(True)
            if len(gnames) == 1:
                grad_out_names.append(gnames[0])
                continue
            # several internal contributions: they must all feed one
            # accumulator `sum` op — replace them there with one merged
            # contribution
            consumers = [r for g in gnames
                         for r in graph.readers.get(g, [])
                         if id(r) not in b_ids]
            consumer_ids = {id(c) for c in consumers}
            if len(consumer_ids) != 1:
                return False
            acc = consumers[0]
            if acc.type != "sum" or id(acc) in allowed:
                return False
            for g in gnames:
                if graph.nonroot_readers.get(g):
                    return False
            _OUTLINE_UID[0] += 1
            fresh = f"{name}@GRAD@OUTLINED@{_OUTLINE_UID[0]}"
            sum_edits.append((acc, gnames, fresh, name))
            grad_out_names.append(fresh)
        merged_vjp = ir.OpDesc(
            "__vjp__",
            inputs={"FwdIn": list(interface_in),
                    "OutGrad": list(out_grads)},
            outputs={"InGrad": grad_out_names},
            attrs={"fwd_op": mega.to_dict(),
                   "out_has_grad": [True],
                   "in_need_grad": list(in_need),
                   "closure_names": []})
        # mutations start only here, after every validation passed
        for acc, gnames, fresh, src in sum_edits:
            fv = root.find_var_recursive(src)
            root.create_var(fresh,
                            shape=(fv.shape if fv is not None else None),
                            dtype=(fv.dtype if fv is not None
                                   else "float32"))
            xs = [n for n in acc.inputs.get("X", []) if n not in gnames]
            acc.inputs["X"] = [fresh] + xs
        first_b_op = min(b_ops, key=lambda b: root.ops.index(b))

    # single rebuild: replace the tail forward op with the mega op, the
    # earliest backward op with the merged vjp, drop the rest
    replace: Dict[int, ir.OpDesc] = {id(chain[-1]): mega}
    drop: Set[int] = {id(o) for o in chain[:-1]}
    if merged_vjp is not None:
        replace[id(first_b_op)] = merged_vjp
        drop |= {id(b) for b in b_ops if b is not first_b_op}
    root.ops = [replace.get(id(o), o) for o in root.ops
                if id(o) not in drop]
    program._bump_version()
    return True


# ---------------------------------------------------------------------------
# attention outlining
# ---------------------------------------------------------------------------
@register_rewrite_pass
class AttentionOutlining(RewritePass):
    """Outline the composed scaled-dot-product attention chain

        matmul(Q, K, transpose_Y) -> [scale] -> [elementwise_add mask]
            -> softmax(axis=-1) -> matmul(probs, V)

    into one ``scaled_dot_product_attention`` op carrying the chain's
    exact softmax scale as an attr, so the flash-attention kernels
    (forward, and dq and dk/dv via the merged ``__vjp__``) apply to any
    user program — not only graphs built through the fused layer.
    Sites where the additive mask itself needs a gradient are skipped
    (flash treats the bias as a constant)."""

    name = "fuse_attention"

    def apply(self, program, ctx) -> List[Dict]:
        actions: List[Dict] = []
        failed: Set[int] = set()  # anchor ids of refused sites
        graph: Optional[_Graph] = None
        while True:
            if graph is None:  # (re)index only after a mutation
                graph = _Graph(program, ctx.block_idx, ctx)
            m = self._find(graph, failed)
            if m is None:
                return actions
            chain, q, k, v, mask, scale, out_name = m
            inputs = {"Q": [q], "K": [k], "V": [v]}
            interface = [q, k, v]
            if mask is not None:
                inputs["Mask"] = [mask]
                interface.append(mask)
            mega = ir.OpDesc(
                "scaled_dot_product_attention", inputs,
                {"Out": [out_name]},
                {"causal": False, "scale": float(scale),
                 "__outlined__": "attention"})
            if not _outline_subgraph(graph, chain, mega, out_name,
                                     interface):
                # this site is unsafe (shared intermediates, odd grad
                # topology, ...) — skip it and keep scanning; later
                # sites in the same program must still outline. A
                # refusal leaves the program untouched: keep the index.
                failed.add(id(chain[-2]))  # the softmax anchor
                continue
            graph = None  # program mutated
            actions.append({"action": "outline",
                            "op_type": "scaled_dot_product_attention",
                            "ops_fused": len(chain)})

    # -- matching -----------------------------------------------------
    @staticmethod
    def _shapes_compatible(root, q, k, v) -> bool:
        sq = (root.find_var_recursive(q) or ir.VarDesc(q)).shape
        sk = (root.find_var_recursive(k) or ir.VarDesc(k)).shape
        sv = (root.find_var_recursive(v) or ir.VarDesc(v)).shape
        if not sq or not sk or not sv:
            return False
        if not (len(sq) == len(sk) == len(sv)) or len(sq) < 3:
            return False
        # equal leading (batch/head) dims; dynamic (-1) matches dynamic
        if sq[:-2] != sk[:-2] or sk[:-2] != sv[:-2]:
            return False
        # K and V share the key sequence length when both are static
        if isinstance(sk[-2], int) and isinstance(sv[-2], int) \
                and sk[-2] > 0 and sv[-2] > 0 and sk[-2] != sv[-2]:
            return False
        # head dim must be static (it anchors the softmax scale)
        return isinstance(sq[-1], int) and sq[-1] > 0 \
            and sq[-1] == sk[-1]

    def _find(self, graph: _Graph, skip: Set[int] = frozenset()):
        root = graph.root
        for sm in root.ops:
            if sm.type != "softmax" \
                    or sm.attrs.get("axis", -1) != -1 \
                    or sm.attrs.get("__outlined__") \
                    or id(sm) in skip:
                continue
            probs = sm.output("Out")
            sm_in = sm.input("X")
            if not probs or not sm_in:
                continue
            probs, sm_in = probs[0], sm_in[0]
            # downstream: the only non-vjp consumer is matmul(probs, V)
            d = None
            for r in graph.readers.get(probs, []):
                if r.type == "matmul" and r.input("X") == [probs]:
                    d = r
            if d is None or d.attrs.get("transpose_X") \
                    or d.attrs.get("transpose_Y") \
                    or d.attrs.get("alpha", 1.0) != 1.0:
                continue
            # upstream: [mask add] <- [scale] <- matmul(Q, K^T)
            chain_tail: List[ir.OpDesc] = []
            cur = sm_in
            mask = None
            prod = graph.sole_root_producer(cur)
            if prod is not None and prod.type == "elementwise_add":
                x_in, y_in = prod.input("X"), prod.input("Y")
                if not x_in or not y_in:
                    continue
                ax = prod.attrs.get("axis", -1)
                if ax != -1:
                    continue
                mask = y_in[0]
                chain_tail.append(prod)
                cur = x_in[0]
                prod = graph.sole_root_producer(cur)
            scale = 1.0
            if prod is not None and prod.type == "scale":
                if prod.attrs.get("bias", 0.0) != 0.0:
                    continue
                scale = float(prod.attrs.get("scale", 1.0))
                chain_tail.append(prod)
                cur = prod.input("X")[0]
                prod = graph.sole_root_producer(cur)
            a = prod
            if a is None or a.type != "matmul" \
                    or not a.attrs.get("transpose_Y") \
                    or a.attrs.get("transpose_X"):
                continue
            scale *= float(a.attrs.get("alpha", 1.0))
            q_in, k_in = a.input("X"), a.input("Y")
            v_in = d.input("Y")
            if not q_in or not k_in or not v_in:
                continue
            q, k, v = q_in[0], k_in[0], v_in[0]
            if not self._shapes_compatible(root, q, k, v):
                continue
            chain = [a] + list(reversed(chain_tail)) + [sm, d]
            out_name = d.output("Out")[0]
            # the additive mask must not need a gradient: the flash
            # kernel treats it as a constant bias
            if mask is not None:
                madd = next((o for o in chain
                             if o.type == "elementwise_add"), None)
                bop = _vjp_of(graph, madd) if madd is not None else None
                if bop is not None:
                    gm = dict(_vjp_grad_map(bop))
                    if mask in gm:
                        continue
            return chain, q, k, v, mask, scale, out_name
        return None


# ---------------------------------------------------------------------------
# SE-block outlining
# ---------------------------------------------------------------------------
@register_rewrite_pass
class SEBlockOutlining(RewritePass):
    """Outline the squeeze-excitation gate

        pool2d(avg, global) -> mul(W1) -> +B1 -> relu -> mul(W2) -> +B2
            -> sigmoid -> reshape([-1, C, 1, 1]) -> elementwise_mul(X, .)

    into one ``se_block`` mega-op (ops/fusion_ops.py) so the whole gate
    is a single op for the cost model, the fusion layer, and —
    eventually — a hand kernel (ROADMAP item 2's SE fusion)."""

    name = "fuse_se"

    def apply(self, program, ctx) -> List[Dict]:
        actions: List[Dict] = []
        failed: Set[int] = set()
        graph: Optional[_Graph] = None
        while True:
            if graph is None:
                graph = _Graph(program, ctx.block_idx, ctx)
            m = self._find(graph, failed)
            if m is None:
                return actions
            chain, x, w1, b1, w2, b2, out_name = m
            mega = ir.OpDesc(
                "se_block",
                {"X": [x], "W1": [w1], "B1": [b1], "W2": [w2],
                 "B2": [b2]},
                {"Out": [out_name]}, {"__outlined__": "se_block"})
            if not _outline_subgraph(graph, chain, mega, out_name,
                                     [x, w1, b1, w2, b2]):
                failed.add(id(chain[0]))  # the pool2d anchor
                continue
            graph = None  # program mutated
            actions.append({"action": "outline", "op_type": "se_block",
                            "ops_fused": len(chain)})

    def _find(self, graph: _Graph, skip: Set[int] = frozenset()):
        root = graph.root

        def sole_consumer(name, types):
            rs = [r for r in graph.readers.get(name, [])
                  if r.type != "__vjp__"]
            if len(rs) == 1 and rs[0].type in types:
                return rs[0]
            return None

        for pool in root.ops:
            if pool.type != "pool2d" \
                    or not pool.attrs.get("global_pooling") \
                    or pool.attrs.get("pooling_type") != "avg" \
                    or id(pool) in skip:
                continue
            x_in = pool.input("X")
            p_out = pool.output("Out")
            if not x_in or not p_out:
                continue
            x, cur = x_in[0], p_out[0]
            mul1 = sole_consumer(cur, {"mul"})
            if mul1 is None or mul1.input("X") != [cur] \
                    or mul1.attrs.get("x_num_col_dims", 1) != 1:
                continue
            add1 = sole_consumer(mul1.output("Out")[0],
                                 {"elementwise_add"})
            if add1 is None:
                continue
            relu = sole_consumer(add1.output("Out")[0], {"relu"})
            if relu is None:
                continue
            mul2 = sole_consumer(relu.output("Out")[0], {"mul"})
            if mul2 is None or mul2.attrs.get("x_num_col_dims", 1) != 1:
                continue
            add2 = sole_consumer(mul2.output("Out")[0],
                                 {"elementwise_add"})
            if add2 is None:
                continue
            sig = sole_consumer(add2.output("Out")[0], {"sigmoid"})
            if sig is None:
                continue
            rshp = sole_consumer(sig.output("Out")[0], {"reshape"})
            if rshp is None:
                continue
            emul = sole_consumer(rshp.output("Out")[0],
                                 {"elementwise_mul"})
            if emul is None or emul.input("X") != [x] \
                    or emul.input("Y") != rshp.output("Out"):
                continue
            # gates must come back as [-1, C, 1, 1]
            shp = rshp.attrs.get("shape")
            xv = root.find_var_recursive(x)
            if not shp or len(shp) != 4 or shp[2:] != [1, 1] \
                    or xv is None or not xv.shape or len(xv.shape) != 4:
                continue
            chain = [pool, mul1, add1, relu, mul2, add2, sig, rshp,
                     emul]
            return (chain, x, mul1.input("Y")[0], add1.input("Y")[0],
                    mul2.input("Y")[0], add2.input("Y")[0],
                    emul.output("Out")[0])
        return None


# ---------------------------------------------------------------------------
# kernel dispatch annotation
# ---------------------------------------------------------------------------
@register_rewrite_pass
class KernelDispatch(RewritePass):
    """Stamp the kernel dispatch decision onto eligible ops as a
    program attr, in place of a run-time environment read:

    - ``lstm``/``gru`` ops get ``__pallas__`` from the
      PADDLE_TPU_PALLAS_LSTM / PADDLE_TPU_PALLAS_GRU policy when it is
      "1" or "force" (the compute rules prefer the attr over the env;
      ops/sequence_ops.py kernel_route);
    - ``scaled_dot_product_attention`` ops get ``use_flash`` under
      PADDLE_TPU_PALLAS_SDPA: "force" engages the flash kernel anywhere
      (its plain twins on CPU tensors), "0" pins the naive composition;
      the default "1" leaves the op's min-seq auto policy in charge.

    Annotation only — no op is added or removed, so this pass is safe
    inside sub-blocks too."""

    name = "kernel_dispatch"

    _STD_LSTM = {"gate_activation": "sigmoid", "cell_activation": "tanh",
                 "candidate_activation": "tanh"}

    def _annotate(self, op_type: str, attrs: Dict,
                  knobs: Dict[str, str]) -> Optional[Tuple[str, str]]:
        """Mutate ``attrs`` with the dispatch decision for ``op_type``;
        returns (attr set, kernel name) or None when nothing changed."""
        if op_type == "lstm":
            knob = knobs["lstm"]
            if knob in ("1", "force") \
                    and not attrs.get("use_peepholes") \
                    and all(attrs.get(k, d) == d
                            for k, d in self._STD_LSTM.items()) \
                    and attrs.get("__pallas__") != knob:
                attrs["__pallas__"] = knob
                return "__pallas__", "fused_lstm"
        elif op_type == "gru":
            knob = knobs["gru"]
            if knob in ("1", "force") \
                    and attrs.get("gate_activation",
                                  "sigmoid") == "sigmoid" \
                    and attrs.get("activation", "tanh") == "tanh" \
                    and attrs.get("__pallas__") != knob:
                attrs["__pallas__"] = knob
                return "__pallas__", "fused_gru"
        elif op_type == "scaled_dot_product_attention":
            knob = knobs["sdpa"]
            if knob in ("force", "0") and not attrs.get("seq_axis"):
                want = knob == "force"
                if attrs.get("use_flash") != want:
                    attrs["use_flash"] = want
                    return "use_flash", "flash_attention"
        return None

    def apply(self, program, ctx) -> List[Dict]:
        actions: List[Dict] = []
        knobs = {
            "lstm": flags.get("PADDLE_TPU_PALLAS_LSTM"),
            "gru": flags.get("PADDLE_TPU_PALLAS_GRU"),
            "sdpa": flags.get("PADDLE_TPU_PALLAS_SDPA"),
        }
        for _blk, _path, _i, op in iter_ops(program, ctx.block_idx):
            hit = self._annotate(op.type, op.attrs, knobs)
            if hit is not None:
                actions.append({"action": "dispatch",
                                "op_type": op.type, "kernel": hit[1]})
            if op.type == "__vjp__":
                # the generic grad op REPLAYS its embedded forward op:
                # annotate the embedded copy too, so the kernel's
                # backward engages (flash bwd, fused scan bwd) — not
                # only the forward instance
                fwd = op.attrs.get("fwd_op") or {}
                fattrs = fwd.get("attrs")
                if isinstance(fattrs, dict):
                    hit = self._annotate(fwd.get("type"), fattrs, knobs)
                    if hit is not None:
                        actions.append({"action": "dispatch",
                                        "op_type":
                                            f"{fwd.get('type')}@vjp",
                                        "kernel": hit[1]})
        if actions:
            program._bump_version()
        return actions


# ---------------------------------------------------------------------------
# in-place buffer reuse
# ---------------------------------------------------------------------------
@register_rewrite_pass
class InplaceBufferReuse(RewritePass):
    """Liveness-driven buffer reuse: rename an op's output var onto a
    same-signature buffer whose live interval already ended, so the
    executor's name-keyed env holds ONE
    buffer where the unoptimized program declared two. The classic
    win: backward grads folding into the dead forward activations of
    the same shape (analysis/memory.py's ``peak_bytes`` is exactly the
    number this shrinks).

    Root-block scoped and value-preserving — a pure renaming, so the
    loss-identity gate stays bit-exact. A name participates (as donor
    or target) only when it is root-declared, non-persistable, not a
    parameter, un-initialized, dense (lod 0), single-writer, not fed /
    fetched / attr-referenced / donated rw state, and never referenced
    from a sub-block; targets additionally must not be written by
    plumbing (feed/fetch/print), stateful, or sub-block-carrying ops.
    Signature = exact dtype + exact dims with ``-1`` kept symbolic, so
    two dynamic-batch buffers match only when their runtime sizes are
    equal for every batch. A donor frees AFTER the op holding its last
    reference (never within it), which rules out aliasing an op's
    input to its own output.

    Runs LAST in the pipeline: the outliners match ``__vjp__`` grad
    ops against the forward op's exact input/output names, which
    renaming would break."""

    name = "inplace_reuse"

    def apply(self, program, ctx) -> List[Dict]:
        if flags.get("PADDLE_TPU_INPLACE_REUSE") == "0":
            return []
        root = program.blocks[ctx.block_idx]
        writers = _writer_counts(program, ctx.block_idx)
        attr_names = _attr_referenced_names(program, ctx.block_idx)
        fetches = set(ctx.fetch_names)
        feeds = set(ctx.feed_names)
        donated = set(rw_state_names(program, ctx.block_idx))
        # names a sub-block touches read the enclosing scope closure
        # style — renaming them needs a cross-block sweep; stay
        # root-scoped (KNOWN_GAPS: memory-planning boundaries)
        nonroot: Set[str] = set()
        for blk, _path, _i, op in iter_ops(program, ctx.block_idx):
            if blk.idx != root.idx:
                nonroot.update(op.input_names())
                nonroot.update(op.output_names())

        def sig(name: str) -> Optional[Tuple]:
            v = root.vars.get(name)
            if v is None or v.shape is None or v.dtype is None:
                return None
            dims = []
            for d in v.shape:
                if not isinstance(d, int):
                    return None  # symbolic placeholder: size unknowable
                dims.append(int(d))
            return (v.dtype, tuple(dims))

        def static_bytes(s: Tuple) -> int:
            n = 1
            for d in s[1]:
                n *= 1 if d == -1 else d
            return n * _ITEMSIZE.get(s[0], 4)

        def eligible(name: str) -> bool:
            v = root.vars.get(name)
            if v is None or v.persistable or v.is_parameter:
                return False
            if v.initializer is not None or v.lod_level:
                return False
            if v.type != ir.VAR_TYPE_LOD_TENSOR:
                return False
            if name in fetches or name in feeds or name in attr_names \
                    or name in nonroot or name in donated:
                return False
            if writers.get(name, 0) != 1:
                return False
            return sig(name) is not None

        last_ref: Dict[str, int] = {}
        for i, op in enumerate(root.ops):
            for n in op.input_names():
                last_ref[n] = i
            for n in op.output_names():
                last_ref[n] = i
        deaths: Dict[int, List[str]] = {}
        for n, i in last_ref.items():
            if eligible(n):
                deaths.setdefault(i, []).append(n)

        assignments: Dict[str, str] = {}  # renamed name -> buffer name
        free: Dict[Tuple, List[str]] = {}
        actions: List[Dict] = []
        for i, op in enumerate(root.ops):
            if op.type not in _KEEP_OPS and not _has_sub_block(op) \
                    and not _is_stateful(op):
                ins = set(op.input_names())
                for n in op.output_names():
                    if n in assignments or n in ins or not eligible(n):
                        continue
                    s = sig(n)
                    pool = free.get(s)
                    if not pool:
                        continue
                    donor = pool.pop()
                    assignments[n] = donor
                    actions.append({"action": "reuse",
                                    "op_type": op.type, "op_index": i,
                                    "var": n, "into": donor,
                                    "bytes": static_bytes(s)})
            # a buffer whose last reference sits at op i is reusable
            # from op i+1 on; a renamed var's death returns the
            # UNDERLYING buffer to the pool (chained reuse)
            for n in sorted(deaths.get(i, ())):
                free.setdefault(sig(n), []).append(
                    assignments.get(n, n))

        if not assignments:
            return []
        for op in root.ops:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [assignments.get(n, n)
                                   for n in names]
            for slot, names in op.outputs.items():
                op.outputs[slot] = [assignments.get(n, n)
                                    for n in names]
            # legacy memory-optimize annotations pin liveness decisions
            # made before the renaming — scrub touched names
            dead = op.attrs.get("__dead_vars__")
            if dead:
                keep = set(assignments) | set(assignments.values())
                op.attrs["__dead_vars__"] = [n for n in dead
                                             if n not in keep]
        for n in assignments:
            root.vars.pop(n, None)
        program._bump_version()
        return actions


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
def default_rewrite_passes() -> List[RewritePass]:
    """THE rewrite pipeline, in order: fold and dedup first (cheaper
    graphs for the matchers), prune dead gradients (which unblocks
    outlining on masked attention), outline fusable subgraphs, sweep
    dead ops (including producers orphaned by folding/outlining), stamp
    kernel dispatch, then alias dead buffers (last: the outliners match
    grad ops by exact forward names, which renaming would break)."""
    return [ConstantFolding(), CommonSubexpressionElimination(),
            DeadOpElimination(), DeadGradPruning(),
            AttentionOutlining(), SEBlockOutlining(),
            DeadOpElimination(), KernelDispatch(),
            InplaceBufferReuse()]


class RewriteResult:
    """Outcome of one rewrite pipeline run."""

    def __init__(self, program: ir.Program, changed: bool,
                 actions: List[Dict], aborted: List[str],
                 seconds: float):
        #: the rewritten program (the ORIGINAL desc when changed=False)
        self.program = program
        self.changed = changed
        #: every applied action, each carrying its pass name
        self.actions = actions
        #: passes whose post-verify failed (their changes discarded)
        self.aborted = aborted
        self.seconds = seconds

    def count(self, pass_name: Optional[str] = None,
              action: Optional[str] = None) -> int:
        return sum(1 for a in self.actions
                   if (pass_name is None or a["pass"] == pass_name)
                   and (action is None or a["action"] == action))

    def summary(self) -> Dict:
        per_pass: Dict[str, Dict[str, int]] = {}
        for a in self.actions:
            bucket = per_pass.setdefault(a["pass"], {})
            bucket[a["action"]] = bucket.get(a["action"], 0) + 1
        return {"changed": self.changed, "seconds": self.seconds,
                "aborted": self.aborted, "passes": per_pass,
                "total_actions": len(self.actions)}


def rewrite_program(program, block_idx: int = 0,
                    feed_names: Optional[Sequence[str]] = None,
                    fetch_names: Optional[Sequence[str]] = None,
                    donate: bool = False, async_dispatch: bool = False,
                    passes: Optional[Sequence[RewritePass]] = None,
                    label: str = "program") -> RewriteResult:
    """Run the rewrite pipeline over a CLONE of ``program``.

    Each pass applies to a fresh clone of the last-known-good program
    and is adopted only when the shared ``fast_passes()`` verifier finds
    no error-severity diagnostics afterwards — a broken rewrite is
    discarded (and counted as ``aborted``), never compiled. The original
    program object is never mutated.
    """
    desc = _desc(program)
    ctx = RewriteContext(block_idx, feed_names, fetch_names)
    t0 = time.perf_counter()
    _RUN.memo = {}
    try:
        return _run_pipeline(desc, ctx, block_idx, donate, async_dispatch,
                             passes, label, t0)
    finally:
        _RUN.memo = None


def _run_pipeline(desc, ctx, block_idx, donate, async_dispatch, passes,
                  label, t0) -> RewriteResult:
    current: Optional[ir.Program] = None  # None = unchanged so far
    candidate: Optional[ir.Program] = None
    actions: List[Dict] = []
    aborted: List[str] = []
    for p in (default_rewrite_passes() if passes is None else passes):
        # an action-less pass contractually leaves its program
        # untouched, so the clone carries over to the next pass — one
        # clone per ADOPTED-or-discarded pass, not one per pass
        if candidate is None:
            candidate = _clone(current if current is not None else desc)
        try:
            pass_actions = p.apply(candidate, ctx)
        except Exception:
            aborted.append(p.name)
            candidate = None  # possibly half-mutated: discard
            continue
        if not pass_actions:
            continue
        report = verify_program(
            candidate, feed_names=ctx.feed_names or None,
            fetch_names=ctx.fetch_names or None, block_idx=block_idx,
            donate=donate, async_dispatch=async_dispatch,
            passes=fast_passes(),
            program_label=f"{label} (post-{p.name})")
        if not report.ok:
            aborted.append(p.name)
            candidate = None
            continue
        current, candidate = candidate, None
        for a in pass_actions:
            a["pass"] = p.name
        actions.extend(pass_actions)
    seconds = time.perf_counter() - t0
    return RewriteResult(current if current is not None else desc,
                         current is not None, actions, aborted, seconds)
