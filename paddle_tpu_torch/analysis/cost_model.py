"""Static per-op cost model over ProgramDesc IR: FLOPs, bytes accessed,
parameter bytes.

The port's copy of ``paddle_tpu/analysis/cost_model.py``, rule for
rule. It walks the reachable ops (the verifier's ``iter_ops``),
resolves each operand's shape from the declared and build-time-inferred
VarDescs (dynamic ``-1`` dims bound from the feed shapes), and applies a
per-op-type FLOP rule. It counts work only: it states no peak and no
rate of any device.

Accuracy contract: matmul/conv-family ops are counted exactly (2 x
MACs); ``__vjp__`` grad ops are costed at 2x their embedded forward op
(a train step totals ~3x the forward); everything else is approximated
at one FLOP per output element. ``bytes_accessed`` is the per-op operand
traffic (every op reads its inputs and writes its outputs).

The model is pure and cheap (one O(ops) walk, no device): the executor
attaches it to every compile-cache miss (``Executor.last_cost``,
``Executor.cost_table``).
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core import ir
from .passes import AnalysisPass, PassContext, iter_ops, register_pass

__all__ = ["OpCost", "ProgramCost", "program_cost", "CostModelPass",
           "ZERO_FLOP_OPS", "ITEMSIZE"]

_ITEMSIZE = {"float64": 8, "int64": 8, "float32": 4, "int32": 4,
             "float16": 2, "bfloat16": 2, "int16": 2, "int8": 1,
             "uint8": 1, "bool": 1}

#: public alias — the memory planner (analysis/memory.py) binds shapes
#: to bytes with the same table so the two analyses can never disagree
ITEMSIZE = _ITEMSIZE

#: ops that move/alias/select data without arithmetic — zero FLOPs by
#: contract (their bytes still count: a transpose is pure HBM traffic)
ZERO_FLOP_OPS = frozenset({
    "feed", "fetch", "assign", "share_data", "print", "shape",
    "fill_constant", "fill_constant_like",
    "fill_constant_batch_size_like", "fill_zeros_like", "fill",
    "assign_value", "reshape", "reshape2", "squeeze", "unsqueeze",
    "flatten", "transpose", "transpose2", "concat", "split", "slice",
    "strided_slice", "cast", "one_hot", "stack", "unstack", "expand",
    "expand_as", "tile", "reverse", "pad", "pad2d", "gather",
    "gather_nd", "lookup_table", "embedding_bag", "kv_cache_write",
    "kv_cache_append",
})

#: FLOPs per parameter element for each optimizer update rule (read +
#: decay + moment updates + write, counted from the compute rules)
_OPTIMIZER_FLOPS = {
    "sgd": 2, "momentum": 5, "adam": 12, "adagrad": 6, "adamax": 9,
    "adadelta": 9, "rmsprop": 9, "decayed_adagrad": 7, "ftrl": 12,
    "lars_momentum": 9, "proximal_gd": 6, "proximal_adagrad": 9,
}

#: same per-element rules for the sparse (touched-rows-only) variants
#: (ops/optimizer_ops.py sparse_sgd/sparse_adagrad/sparse_adam) — but
#: keyed on the DEDUPED row-grad numel, not Param numel: charging the
#: dense rule's Param numel would overcount by vocab/touched, which at
#: embedding scale is ~1e5x (PAPER sparse update path)
_SPARSE_OPTIMIZER_FLOPS = {
    "sparse_sgd": 2, "sparse_adagrad": 6, "sparse_adam": 12,
}


def _prod(dims: Sequence[int]) -> int:
    p = 1
    for d in dims:
        p *= int(d)
    return p


class _VarInfo:
    """Resolved operand: concrete shape (``-1`` bound), element count,
    bytes, and persistability."""

    __slots__ = ("name", "shape", "numel", "bytes", "persistable")

    def __init__(self, name: str, shape: List[int], itemsize: int,
                 persistable: bool):
        self.name = name
        self.shape = shape
        self.numel = _prod(shape)
        self.bytes = self.numel * itemsize
        self.persistable = persistable


class OpCost:
    """Cost of one op: FLOPs, operand bytes, parameter bytes read."""

    __slots__ = ("op_type", "block_path", "op_index", "flops",
                 "bytes_accessed", "param_bytes", "exact", "note")

    def __init__(self, op_type: str, block_path: Tuple[int, ...],
                 op_index: int, flops: int, bytes_accessed: int,
                 param_bytes: int, exact: bool,
                 note: Optional[str] = None):
        self.op_type = op_type
        self.block_path = tuple(block_path)
        self.op_index = op_index
        self.flops = int(flops)
        self.bytes_accessed = int(bytes_accessed)
        self.param_bytes = int(param_bytes)
        self.exact = bool(exact)
        self.note = note

    def to_dict(self) -> Dict:
        return {"op_type": self.op_type,
                "block_path": list(self.block_path),
                "op_index": self.op_index, "flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "param_bytes": self.param_bytes, "exact": self.exact,
                "note": self.note}

    def __repr__(self):
        return (f"OpCost({self.op_type}, flops={self.flops}, "
                f"bytes={self.bytes_accessed})")


class ProgramCost:
    """Per-op costs plus program totals for one block tree.

    ``param_bytes`` deduplicates persistable vars program-wide (a param
    read by forward, backward, and its optimizer op counts once) —
    the resident-weights number; per-op ``param_bytes`` keeps every
    read for traffic accounting.
    """

    def __init__(self, ops: List[OpCost], param_bytes: int, batch: int,
                 block_idx: int, label: str = "program"):
        self.ops = ops
        self.param_bytes = int(param_bytes)
        self.batch = int(batch)
        self.block_idx = int(block_idx)
        self.label = label
        self.flops = sum(c.flops for c in ops)
        self.bytes_accessed = sum(c.bytes_accessed for c in ops)
        self.unresolved = sum(1 for c in ops
                              if c.note == "unresolved shapes")

    @property
    def arithmetic_intensity(self) -> float:
        """FLOPs per byte of pre-fusion operand traffic (a LOWER bound
        on the fused executable's intensity)."""
        return self.flops / self.bytes_accessed if self.bytes_accessed \
            else 0.0

    @property
    def exact_flops_fraction(self) -> float:
        """Fraction of total FLOPs carried by exactly-counted ops (the
        matmul/conv/optimizer family) — how much of the total is rule-
        derived rather than one-flop-per-element approximation."""
        if not self.flops:
            return 0.0
        return sum(c.flops for c in self.ops if c.exact) / self.flops

    def top_ops(self, limit: int = 20) -> List[OpCost]:
        return sorted(self.ops, key=lambda c: -c.flops)[:limit]

    def table(self, limit: int = 20) -> str:
        """Human-readable cost table, heaviest ops first."""
        lines = [
            f"cost {self.label} (block {self.block_idx}, "
            f"batch={self.batch}): {len(self.ops)} ops, "
            f"{self.flops / 1e9:.3f} GFLOP, "
            f"{self.bytes_accessed / 1e6:.2f} MB accessed, "
            f"{self.param_bytes / 1e6:.2f} MB params, "
            f"intensity {self.arithmetic_intensity:.1f} flop/B "
            f"({self.exact_flops_fraction * 100:.0f}% of flops exact, "
            f"{self.unresolved} op(s) unresolved)",
            f"{'flops':>14s} {'bytes':>12s} {'params':>10s}  op",
        ]
        for c in self.top_ops(limit):
            loc = "/".join(str(b) for b in c.block_path)
            note = f"  [{c.note}]" if c.note else ""
            lines.append(
                f"{c.flops:14d} {c.bytes_accessed:12d} "
                f"{c.param_bytes:10d}  b{loc}:op{c.op_index} "
                f"{c.op_type}{note}")
        if len(self.ops) > limit:
            lines.append(f"  ... {len(self.ops) - limit} more op(s)")
        return "\n".join(lines)

    def to_dict(self) -> Dict:
        return {
            "label": self.label, "block_idx": self.block_idx,
            "batch": self.batch, "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "param_bytes": self.param_bytes,
            "arithmetic_intensity": round(self.arithmetic_intensity, 4),
            "exact_flops_fraction":
                round(self.exact_flops_fraction, 4),
            "unresolved_ops": self.unresolved,
            "ops": [c.to_dict() for c in self.ops],
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def __repr__(self):
        return (f"ProgramCost({self.label}, flops={self.flops}, "
                f"bytes={self.bytes_accessed}, "
                f"params={self.param_bytes})")


# ---------------------------------------------------------------------------
# FLOP rules
# ---------------------------------------------------------------------------
def _flops_for(op: ir.OpDesc,
               lookup: Callable[[str], Optional[_VarInfo]]
               ) -> Tuple[Optional[int], bool, Optional[str]]:
    """(flops, exact, note) for one op; flops None = needed shapes are
    unresolvable (caller falls back to the generic estimate)."""

    def first(slot: str) -> Optional[_VarInfo]:
        names = op.input(slot)
        return lookup(names[0]) if names else None

    def out(slot: str) -> Optional[_VarInfo]:
        names = op.output(slot)
        return lookup(names[0]) if names else None

    t = op.type
    if t in ZERO_FLOP_OPS:
        return 0, True, None

    if t == "mul":
        x, y = first("X"), first("Y")
        if x is None or y is None:
            return None, False, None
        xn = int(op.attrs.get("x_num_col_dims", 1))
        yn = int(op.attrs.get("y_num_col_dims", 1))
        m = _prod(x.shape[:xn])
        k = _prod(x.shape[xn:])
        n = _prod(y.shape[yn:])
        return 2 * m * k * n, True, None

    if t == "matmul":
        x, o = first("X"), out("Out")
        if x is None or o is None or not x.shape:
            return None, False, None
        k = x.shape[-2] if op.attrs.get("transpose_X") and \
            len(x.shape) > 1 else x.shape[-1]
        return 2 * o.numel * int(k), True, None

    if t in ("conv2d", "depthwise_conv2d", "conv3d"):
        o, w = out("Output"), first("Filter")
        if o is None or w is None or len(w.shape) < 2:
            return None, False, None
        # filter [Cout, Cin/groups, *k]: MACs per output element
        return 2 * o.numel * _prod(w.shape[1:]), True, None

    if t in ("conv2d_transpose", "conv3d_transpose"):
        x, w = first("Input"), first("Filter")
        if x is None or w is None or len(w.shape) < 2:
            return None, False, None
        # filter [Cin, Cout, *k]: every input element hits Cout*k MACs
        return 2 * x.numel * _prod(w.shape[1:]), True, None

    if t in ("pool2d", "pool3d", "adaptive_pool2d"):
        o = out("Out")
        if o is None:
            return None, False, None
        k = op.attrs.get("ksize") or [1]
        return o.numel * _prod(k), False, None

    if t in ("softmax", "log_softmax"):
        x = first("X")
        return (None, False, None) if x is None else \
            (5 * x.numel, False, None)

    if t == "softmax_with_cross_entropy":
        x = first("Logits")
        return (None, False, None) if x is None else \
            (6 * x.numel, False, None)

    if t == "batch_norm":
        x = first("X")
        return (None, False, None) if x is None else \
            (6 * x.numel, False, None)

    if t == "layer_norm":
        x = first("X")
        return (None, False, None) if x is None else \
            (8 * x.numel, False, None)

    if t == "scaled_dot_product_attention":
        # the outlined attention mega-op (analysis/rewrite.py): two
        # seq^2 contractions plus the online softmax. Without this rule
        # the generic 1-flop/elem fallback would book ~Sq*d instead of
        # ~4*Sq*Sk*d and silently crater reported MFU post-rewrite.
        q, k = first("Q"), first("K")
        if q is None or k is None or len(q.shape) < 3:
            return None, False, None
        lead = _prod(q.shape[:-2])
        sq, d = q.shape[-2], q.shape[-1]
        sk = k.shape[-2]
        return (4 * lead * sq * sk * d + 5 * lead * sq * sk,
                True, None)

    if t in ("lstm", "gru"):
        # the fused recurrence mega-ops (ops/sequence_ops.py, the
        # fused_lstm/fused_gru kernels): the per-step recurrent matmul
        # [n,h]x[h,Gh] over all timesteps dominates; +12 flop/elem
        # covers the gate nonlinearities. The leading dims product is
        # n*t for a padded [n, t, Gh] input and the declared row count
        # for a ragged 2-D declaration (the padded time extent is not
        # statically known — same documented approximation as the
        # generic -1 binding).
        x, w = first("Input"), first("Weight")
        if x is None or w is None or len(x.shape) < 2 \
                or len(w.shape) != 2:
            return None, False, None
        nt = _prod(x.shape[:-1])
        h = w.shape[0]
        gates = 4 if t == "lstm" else 3
        return 2 * nt * h * gates * h + 12 * nt * h, True, None

    if t == "se_block":
        # outlined squeeze-excitation gate (ops/fusion_ops.py): global
        # pool + gate multiply sweep the activation twice; the two
        # bottleneck FCs are 2*MAC each
        x, w1 = first("X"), first("W1")
        if x is None or w1 is None or len(x.shape) != 4 \
                or len(w1.shape) != 2:
            return None, False, None
        n, c = x.shape[0], x.shape[1]
        r = w1.shape[1]
        return 2 * x.numel + 4 * n * c * r, True, None

    if t in _OPTIMIZER_FLOPS:
        p = first("Param")
        if p is None:
            return None, False, None
        return _OPTIMIZER_FLOPS[t] * p.numel, True, None

    if t in _SPARSE_OPTIMIZER_FLOPS:
        g = first("Grad")
        if g is None:
            return None, False, None
        return (_SPARSE_OPTIMIZER_FLOPS[t] * g.numel, True,
                "sparse apply: touched rows only")

    if t == "__vjp__":
        fwd_dict = op.attrs.get("fwd_op")
        if not fwd_dict:
            return None, False, None
        fwd = ir.OpDesc.from_dict(fwd_dict)
        f_flops, _f_exact, _ = _flops_for(fwd, lookup)
        if f_flops is None:
            # fall back on the forward op's output sizes
            f_flops = sum((lookup(n).numel if lookup(n) else 0)
                          for n in fwd.output_names())
        # backward ~= 2x forward (input-grad + weight-grad each pay one
        # forward-sized contraction for the matmul/conv family)
        return 2 * f_flops, False, f"vjp x2 of {fwd.type}"

    return None, False, None


def _bytes_override(op: ir.OpDesc,
                    lookup: Callable[[str], Optional[_VarInfo]]
                    ) -> Optional[Tuple[int, str]]:
    """Op types whose generic operand-bytes walk badly overcounts."""
    if op.type in ("lookup_table", "embedding_bag", "gather",
                   "gather_nd"):
        # a gather touches the SELECTED rows, not the whole table
        # (MULTICHIP_r05: model-axis gather traffic scales with touched
        # rows) — count ids + read of gathered rows + write of output
        touched = 0
        for names in op.outputs.values():
            for n in names:
                v = lookup(n)
                if v is not None:
                    touched += v.bytes
        ids = 0
        for slot in ("Ids", "Index"):
            v_names = op.input(slot)
            if v_names:
                v = lookup(v_names[0])
                if v is not None:
                    ids += v.bytes
        return 2 * touched + ids, "gather: touched rows only"
    if op.type in ("kv_cache_write", "kv_cache_append"):
        # an in-place dynamic-update-slice touches the UPDATED rows,
        # not the whole cache: counting the full [slots, h, max_seq, d]
        # cache as read+written per decoded token would overstate
        # decode-step traffic by max_seq/1 and crater reported
        # arithmetic intensity. The cache-READ traffic of attention is
        # booked on the consumer (slice + scaled_dot_product_attention
        # operands), not here.
        new_b = 0
        names = op.input("New")
        if names:
            v = lookup(names[0])
            if v is not None:
                new_b = v.bytes
        idx = 0
        for slot in ("Slot", "Pos"):
            v_names = op.input(slot)
            if v_names:
                v = lookup(v_names[0])
                if v is not None:
                    idx += v.bytes
        return 2 * new_b + idx, "kv cache: updated rows only"
    if op.type in ("sparse_sgd", "sparse_adagrad", "sparse_adam"):
        # sparse apply touches the DEDUPED rows only: the generic walk
        # would charge the full [vocab, dim] param (and each slot) as
        # read+written, overstating a billion-row table's update
        # traffic by vocab/touched. Real traffic per touched row:
        # param read+write + grad read (3x touched) plus a read+write
        # of every row-wise slot (adagrad: moment; adam: m1+m2), plus
        # the deduped ids. Scalar beta-pow accumulators are noise.
        touched = 0
        names = op.input("Grad")
        if names:
            v = lookup(names[0])
            if v is not None:
                touched = v.bytes
        n_slots = {"sparse_sgd": 0, "sparse_adagrad": 1,
                   "sparse_adam": 2}[op.type]
        ids = 0
        names = op.input("Ids")
        if names:
            v = lookup(names[0])
            if v is not None:
                ids = v.bytes
        return ((3 + 2 * n_slots) * touched + ids,
                "sparse apply: touched rows + slots only")
    if op.type == "slice":
        # a slice reads exactly the rows it keeps — the decode step
        # slices the first L rows out of a [slots, h, max_seq, d]
        # cache, and charging the full cache read here would double the
        # whole point of cache-length bucketing
        out_b = 0
        for names in op.outputs.values():
            for n in names:
                v = lookup(n)
                if v is not None:
                    out_b += v.bytes
        return 2 * out_b, "slice: kept rows only"
    return None


# ---------------------------------------------------------------------------
def program_cost(program, block_idx: int = 0,
                 feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
                 batch: Optional[int] = None,
                 label: Optional[str] = None) -> ProgramCost:
    """Walk every reachable op of ``program`` (Python wrapper or core
    ``ir.Program``) and return its :class:`ProgramCost`.

    ``feed_shapes`` maps feed names to concrete shapes (the executor
    passes the current dispatch's device-feed shapes); a declared
    leading ``-1`` then resolves to the fed batch. Without feeds,
    ``batch`` (default 1) binds the dynamic batch dim. Non-leading
    dynamic dims bind to 1 (documented approximation — ragged padded
    time dims are not statically known).
    """
    desc = program.desc if hasattr(program, "desc") else program
    feed_shapes = {k: tuple(int(d) for d in v)
                   for k, v in (feed_shapes or {}).items()}
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

    param_reads: Dict[str, int] = {}
    op_costs: List[OpCost] = []

    # one resolution cache per block, shared by every op in it: params
    # and activations are read by several ops (fwd, __vjp__, optimizer)
    # and the parent-chain walk is the expensive part
    block_caches: Dict[int, Dict[str, Optional[_VarInfo]]] = {}

    for blk, path, i, op in iter_ops(desc, block_idx):
        cache = block_caches.setdefault(id(blk), {})

        def lookup(name: str, _blk=blk, _cache=cache
                   ) -> Optional[_VarInfo]:
            if name in _cache:
                return _cache[name]
            v = _blk.find_var_recursive(name)
            info = None
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
                if shape is not None:
                    info = _VarInfo(
                        name, shape,
                        _ITEMSIZE.get(v.dtype or "float32", 4),
                        v.persistable)
            _cache[name] = info
            return info

        flops, exact, note = _flops_for(op, lookup)
        in_infos = [lookup(n) for n in dict.fromkeys(op.input_names())]
        out_infos = [lookup(n) for n in dict.fromkeys(op.output_names())]
        if flops is None:
            # generic estimate: one FLOP per output element
            resolved_out = [v for v in out_infos if v is not None]
            if resolved_out:
                flops, exact, note = (
                    sum(v.numel for v in resolved_out), False, "generic")
            else:
                flops, exact, note = 0, False, "unresolved shapes"

        ov = _bytes_override(op, lookup)
        if ov is not None:
            bytes_acc, bnote = ov
            note = note or bnote
        else:
            bytes_acc = sum(v.bytes for v in in_infos if v is not None) \
                + sum(v.bytes for v in out_infos if v is not None)
        pbytes = 0
        for v in in_infos:
            if v is not None and v.persistable:
                pbytes += v.bytes
                param_reads.setdefault(v.name, v.bytes)
        op_costs.append(OpCost(op.type, path, i, flops, bytes_acc,
                               pbytes, exact, note))

    return ProgramCost(op_costs, sum(param_reads.values()), batch,
                       block_idx,
                       label=label or f"program uid={desc.uid}")


# ---------------------------------------------------------------------------
@register_pass
class CostModelPass(AnalysisPass):
    """Attach a :class:`ProgramCost` to the verify report
    (``report.cost``). Produces no diagnostics — it is an attribution
    pass on the same framework, runnable alongside the verifier
    (``ProgramVerifier(passes=[..., "cost_model"])``) or standalone via
    :func:`program_cost`."""

    name = "cost_model"

    def __init__(self, feed_shapes=None, batch=None):
        self.feed_shapes = feed_shapes
        self.batch = batch

    def run(self, ctx: PassContext) -> None:
        ctx.report.cost = program_cost(
            ctx.program, ctx.block_idx, feed_shapes=self.feed_shapes,
            batch=self.batch, label=ctx.report.program_label)
