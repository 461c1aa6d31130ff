"""Composable static-analysis passes over core IR programs.

The port's copy of ``paddle_tpu/analysis/passes.py``: the same passes,
codes, severities and messages (a program built by either package gets
the same diagnostics), over the port's own IR and op registry.

Each pass inspects one `ir.Program` (plus optional context: the paired
startup program, feed/fetch names, executor donation mode) and appends
`Diagnostic`s to the shared report. Passes never mutate the program —
they are safe to run between transformations (backward, pruning,
donation, serving freeze).

Walk order mirrors the executor's: blocks are visited depth-first
through the same sub-block attrs the executor follows
(``sub_block`` / ``sub_block_idx`` / ``true_block_idx`` /
``false_block_idx``), so every diagnostic carries the block path the
op would execute under. ``ShapeDtypePass(retrace=True)`` re-runs the
port's meta-device inference (`framework.infer_op_outputs`) and each
op's explicit ``infer_shape`` rule.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..core import ir
from ..core.registry import OpRegistry
from .diagnostics import Diagnostic, Severity, VerifyReport

__all__ = ["PassContext", "AnalysisPass", "default_passes",
           "register_pass", "PASS_REGISTRY", "iter_ops", "iter_blocks",
           "rw_state_names", "DONATED_FETCH_HINT"]

#: op attrs naming a sub-block the tracer descends into — the shared
#: canonical list (core/ir.py) the executor walks with
from ..core.ir import SUB_BLOCK_ATTRS  # noqa: E402  (re-export)

#: op attrs whose names are *machinery-defined* inside a sub-block: the
#: enclosing control-flow op injects these values into the trace env
#: (step inputs, pre-memories), so no OpDesc ever writes them.
MACHINERY_DEF_ATTRS = ("step_in_names", "mem_pre_names", "stage_in_name")

#: var types that never flow through the dense trace env as plain reads
_OPAQUE_VAR_TYPES = (ir.VAR_TYPE_READER, ir.VAR_TYPE_STEP_SCOPES,
                     ir.VAR_TYPE_RAW)

DONATED_FETCH_HINT = ("fetch it with sync=True, or build the Executor "
                      "with donate_state=False")

_DTYPE_FAMILY = {
    "float16": "float", "bfloat16": "float", "float32": "float",
    "float64": "float",
    "int8": "int", "int16": "int", "int32": "int", "int64": "int",
    "uint8": "int",
    "bool": "bool",
}


def iter_blocks(program: ir.Program, block_idx: int = 0):
    """Yield ``(block, path)`` depth-first from ``block_idx``, following
    the sub-block attrs of each op (the executor's reachability). Each
    block is visited at most once: a corrupted program whose sub-block
    attr points at itself (or an ancestor) must yield diagnostics, not
    a RecursionError."""
    seen = set()

    def visit(blk: ir.BlockDesc, path: Tuple[int, ...]):
        if blk.idx in seen:
            return
        seen.add(blk.idx)
        yield blk, path
        for op in blk.ops:
            for attr in SUB_BLOCK_ATTRS:
                idx = op.attrs.get(attr)
                if isinstance(idx, int) and 0 <= idx < len(program.blocks):
                    yield from visit(program.blocks[idx], path + (idx,))
    yield from visit(program.blocks[block_idx], (block_idx,))


def iter_ops(program: ir.Program, block_idx: int = 0):
    """Yield ``(block, path, op_index, op)`` over every reachable op."""
    for blk, path in iter_blocks(program, block_idx):
        for i, op in enumerate(blk.ops):
            yield blk, path, i, op


def _written_names(program: ir.Program, block_idx: int = 0) -> Set[str]:
    """Every name some reachable op writes, plus machinery-injected
    names (step inputs / pre-memories of RNN-family ops)."""
    written: Set[str] = set()
    for _blk, _path, _i, op in iter_ops(program, block_idx):
        written.update(op.output_names())
        for attr in MACHINERY_DEF_ATTRS:
            v = op.attrs.get(attr)
            if isinstance(v, str):
                written.add(v)
            elif isinstance(v, (list, tuple)):
                written.update(n for n in v if isinstance(n, str))
    return written


def _write_positions(program: ir.Program, block_idx: int = 0
                     ) -> Dict[str, List[Tuple[int, int]]]:
    """{name: [(block idx, op position), ...]} for every op write."""
    pos: Dict[str, List[Tuple[int, int]]] = {}
    for blk, _path, i, op in iter_ops(program, block_idx):
        for name in op.output_names():
            pos.setdefault(name, []).append((blk.idx, i))
    return pos


def rw_state_names(program: ir.Program, block_idx: int = 0) -> List[str]:
    """Persistable vars the program both reads and writes — the set the
    executor donates to the jitted step (params + optimizer state)."""
    reads, writes = set(), set()
    for blk, _path, _i, op in iter_ops(program, block_idx):
        for name in op.input_names():
            v = blk.find_var_recursive(name)
            if v is not None and v.persistable:
                reads.add(name)
        for name in op.output_names():
            v = blk.find_var_recursive(name)
            if v is not None and v.persistable:
                writes.add(name)
    return sorted(reads & writes)


class PassContext:
    """Everything a pass may consult for one verification run."""

    def __init__(self, program: ir.Program,
                 startup: Optional[ir.Program] = None,
                 feed_names: Optional[Iterable[str]] = None,
                 fetch_names: Optional[Sequence[str]] = None,
                 block_idx: int = 0,
                 donate: bool = False,
                 async_dispatch: bool = False,
                 report: Optional[VerifyReport] = None):
        self.program = program
        self.startup = startup
        self.feed_names = (None if feed_names is None
                           else set(feed_names))
        self.fetch_names = (None if fetch_names is None
                            else list(fetch_names))
        self.block_idx = block_idx
        self.donate = donate
        self.async_dispatch = async_dispatch
        self.report = report if report is not None else VerifyReport()
        # memoized across passes
        self._written: Optional[Set[str]] = None

    @property
    def written(self) -> Set[str]:
        if self._written is None:
            self._written = _written_names(self.program, self.block_idx)
        return self._written

    def diag(self, severity, code, message, path, op_index=None,
             op_type=None, var=None, hint=None) -> Diagnostic:
        return self.report.add(Diagnostic(
            severity, code, message, block_path=path, op_index=op_index,
            op_type=op_type, var=var, hint=hint))


class AnalysisPass:
    """Base class: subclasses set `name` and implement run(ctx)."""

    name = "pass"

    def run(self, ctx: PassContext) -> None:
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


PASS_REGISTRY: Dict[str, type] = {}


def register_pass(cls):
    """Class decorator: make a pass available by name to the verifier
    (``ProgramVerifier(passes=["def_use", ...])``)."""
    PASS_REGISTRY[cls.name] = cls
    return cls


def default_passes() -> List[AnalysisPass]:
    return [DefBeforeUsePass(), ShapeDtypePass(), UninitPersistablePass(),
            DeadCodePass(), DonationHazardPass()]


def fast_passes(with_uninit: bool = False) -> List[AnalysisPass]:
    """THE no-retrace gate pipeline: structural passes plus the
    marker-reading shape pass — pure Python, O(ops), what the hot
    executor gate runs per compile miss. ``with_uninit=True`` adds
    uninitialized-persistable detection for callers that know the
    startup program (trainer setup, the lint CLI's network mode).
    Defined once so the gates cannot drift from each other."""
    passes: List[AnalysisPass] = [DefBeforeUsePass(),
                                  ShapeDtypePass(retrace=False)]
    if with_uninit:
        passes.append(UninitPersistablePass())
    passes.extend([DeadCodePass(), DonationHazardPass()])
    return passes


# ---------------------------------------------------------------------------
@register_pass
class DefBeforeUsePass(AnalysisPass):
    """Dangling-name and def-before-use resolution.

    - ``dangling-input`` (error): an op input that resolves to NO
      VarDesc anywhere along the block parent chain — the trace env
      lookup would KeyError deep inside the run.
    - ``read-never-written`` (error in the root block when the feed set
      is known, warning otherwise): a declared non-persistable var that
      is read but written by no op, not fed, and not injected by
      control-flow machinery.
    - ``read-before-write`` (same severity scheme): the var IS written,
      but every write sits at a LATER position in the SAME block as the
      first read — there is no earlier same-block write and no writer
      in any other block (a loop-carry initialized outside the body, or
      a parent-block producer, excuses the pattern), so the first
      execution reads an undefined value.
    """

    name = "def_use"

    def run(self, ctx: PassContext) -> None:
        written = ctx.written
        writes_at = _write_positions(ctx.program, ctx.block_idx)
        feeds = ctx.feed_names
        flagged: Set[str] = set()
        for blk, path, i, op in iter_ops(ctx.program, ctx.block_idx):
            for name in op.input_names():
                v = blk.find_var_recursive(name)
                if v is None:
                    ctx.diag(
                        Severity.ERROR, "dangling-input",
                        f"op input {name!r} does not resolve to any "
                        f"variable along the block parent chain",
                        path, i, op.type, var=name,
                        hint="declare the variable in this block (or an "
                             "ancestor), or fix the op's input wiring")
                    continue
                if name in flagged:
                    continue
                if name in written:
                    ws = writes_at.get(name)
                    # op-written (not machinery-injected): ordered
                    # check — only definite when every writer is a
                    # later op of THIS block (any outside-block or
                    # earlier writer may feed the first execution)
                    if ws and not v.persistable \
                            and (feeds is None or name not in feeds) \
                            and all(b == blk.idx and j > i
                                    for b, j in ws):
                        flagged.add(name)
                        in_root = len(path) == 1
                        ctx.diag(
                            Severity.ERROR if in_root
                            and feeds is not None else Severity.WARNING,
                            "read-before-write",
                            f"var {name!r} is read here but only "
                            f"written later in this block (op "
                            f"position(s) {sorted(j for _, j in ws)}) "
                            f"— the first execution reads an "
                            f"undefined value",
                            path, i, op.type, var=name,
                            hint="move the producer before this op, "
                                 "or initialize the variable first")
                    continue
                if v.persistable or v.initializer is not None:
                    continue
                if v.type in _OPAQUE_VAR_TYPES:
                    continue
                if feeds is not None and name in feeds:
                    continue
                in_root = len(path) == 1
                if feeds is None:
                    # without a feed set, a never-written root-block var
                    # is indistinguishable from a feed placeholder
                    if not in_root:
                        flagged.add(name)
                        ctx.diag(
                            Severity.WARNING, "read-never-written",
                            f"var {name!r} is read but no op or "
                            f"control-flow machinery writes it",
                            path, i, op.type, var=name,
                            hint="if this is a feed, pass feed names to "
                                 "the verifier to silence this")
                    continue
                flagged.add(name)
                ctx.diag(
                    Severity.ERROR if in_root else Severity.WARNING,
                    "read-never-written",
                    f"var {name!r} is read by this op but never written "
                    f"by any op and not in the feed set",
                    path, i, op.type, var=name,
                    hint="feed the variable, or add the op that "
                         "produces it before this point")


# ---------------------------------------------------------------------------
@register_pass
class ShapeDtypePass(AnalysisPass):
    """Declared vs inferred dtype/shape consistency, plus inference
    coverage.

    Re-runs the registry's abstract inference
    (`framework.infer_op_outputs` — pure, never mutates the program)
    per op and compares against the declared VarDescs:

    - ``dtype-mismatch``: inferred and declared dtypes are in
      different families (float/int/bool). A bool⇄number conflict is
      an ERROR (almost always a condition wired to the wrong slot);
      int⇄float drift is a WARNING — python-scalar promotion routinely
      floats an int tensor (e.g. ``scale``) while the declared dtype
      stays behind, and the runtime follows the trace, not the
      declaration. Same-family width drift (f32 vs bf16 under AMP,
      i32 vs i64 under x64-off) is tolerated outright.
    - ``shape-mismatch`` (warning): rank differs, or two static extents
      conflict (-1 wildcards match anything).
    - ``shape-coverage`` (warning): the op has neither a traceable
      compute rule nor an explicit `infer_shape` rule — its outputs
      flow through the layer calls unchecked.
    """

    name = "shape_dtype"

    def __init__(self, retrace: bool = True):
        # retrace=True re-runs abstract inference per op — thorough,
        # used by the standalone verifier / CLI / serving load.
        # retrace=False reads the markers stamped at BUILD time
        # (SHAPE_INFER_SKIPPED_ATTR / SHAPE_INFER_CONFLICT_ATTR): pure
        # dict walks, cheap enough for the per-compile executor gate.
        self.retrace = retrace

    def run(self, ctx: PassContext) -> None:
        from ..framework import (SHAPE_INFER_CONFLICT_ATTR,
                                 SHAPE_INFER_SKIPPED_ATTR,
                                 infer_op_outputs)
        for blk, path, i, op in iter_ops(ctx.program, ctx.block_idx):
            if not self.retrace:
                skip = op.attrs.get(SHAPE_INFER_SKIPPED_ATTR)
                if skip is not None:
                    self._coverage(ctx, path, i, op, skip)
                for c in op.attrs.get(SHAPE_INFER_CONFLICT_ATTR) or ():
                    self._conflict_diag(ctx, path, i, op, c)
                continue
            outs, skip = infer_op_outputs(blk, op)
            if outs is None:
                # the generic trace can't run this op — give its
                # explicit infer_shape rule (control-flow family) a
                # chance, so the full-retrace cold gates check those
                # conflicts too, not just build-time markers
                opdef = (OpRegistry.get(op.type)
                         if OpRegistry.has(op.type) else None)
                rule = opdef.infer_shape if opdef is not None else None
                if rule is not None:
                    try:
                        outs, skip = rule(blk, op) or {}, None
                    except Exception as e:
                        skip = ("explicit rule failed: "
                                f"{type(e).__name__}")
                if outs is not None:
                    # a partial rule (resolves only some outputs) must
                    # still report the rest as uncovered — same
                    # definition as build-time marker stamping
                    from ..framework import (RULE_UNRESOLVED_PREFIX,
                                             unresolved_outputs)
                    unresolved = unresolved_outputs(blk, op,
                                                    covered=outs)
                    if unresolved:
                        self._coverage(
                            ctx, path, i, op,
                            RULE_UNRESOLVED_PREFIX + str(unresolved[:3]))
            if outs is None:
                self._coverage(ctx, path, i, op, skip)
                continue
            for name, spec in outs.items():
                v = blk.find_var_recursive(name)
                if v is None:
                    continue  # def_use reports the dangling name
                for c in self.compare(name, v, spec):
                    self._conflict_diag(ctx, path, i, op, c)

    @staticmethod
    def compare(name, v, spec) -> List[Dict]:
        """Declared VarDesc vs inferred spec: a list of conflict dicts
        (empty = consistent). Shared by this pass and the build-time
        conflict stamping (framework._apply_inferred) so gate-time
        marker reads and full re-traces agree on what a conflict is."""
        conflicts: List[Dict] = []
        inferred_dt = spec.get("dtype")
        if v.dtype is not None and inferred_dt is not None:
            fam_d = _DTYPE_FAMILY.get(v.dtype)
            fam_i = _DTYPE_FAMILY.get(inferred_dt)
            if fam_d and fam_i and fam_d != fam_i:
                conflicts.append({"kind": "dtype", "var": name,
                                  "declared": v.dtype,
                                  "inferred": inferred_dt})
        inferred_sh = spec.get("shape")
        if v.shape is None or inferred_sh is None:
            return conflicts
        # ragged outputs compare feature dims only when levels agree;
        # a level mismatch changes which axes the declared shape omits
        if spec.get("lod_level", 0) != v.lod_level:
            return conflicts
        if len(v.shape) != len(inferred_sh):
            conflicts.append({"kind": "rank", "var": name,
                              "declared": list(v.shape),
                              "inferred": list(inferred_sh)})
            return conflicts
        for d, (a, b) in enumerate(zip(v.shape, inferred_sh)):
            # anything non-static (-1, None, or a non-int placeholder)
            # is a wildcard — only two concrete ints can conflict
            if not isinstance(a, int) or not isinstance(b, int):
                continue
            if a != -1 and b != -1 and a != b:
                conflicts.append({"kind": "dim", "var": name, "dim": d,
                                  "declared": list(v.shape),
                                  "inferred": list(inferred_sh)})
                break
        return conflicts

    @staticmethod
    def _coverage(ctx, path, i, op, skip):
        opdef = (OpRegistry.get(op.type)
                 if OpRegistry.has(op.type) else None)
        rule_failed = isinstance(skip, str) and \
            skip.startswith("explicit rule")
        if opdef is not None and opdef.infer_shape is not None \
                and not rule_failed:
            return  # covered by an explicit rule (that worked)
        ctx.diag(
            Severity.WARNING, "shape-coverage",
            f"op has no shape-inference coverage ({skip}); its "
            f"outputs are unchecked until the executor trace",
            path, i, op.type,
            hint="register an infer_shape rule on the OpDef, or "
                 "declare input shapes")

    @staticmethod
    def _conflict_diag(ctx, path, i, op, c):
        name = c.get("var")
        if c.get("kind") == "dtype":
            fam_d = _DTYPE_FAMILY.get(c["declared"])
            fam_i = _DTYPE_FAMILY.get(c["inferred"])
            # bool⇄number: a condition wired into a numeric slot (or
            # vice versa) — error. int⇄float: benign scalar-promotion
            # drift; the executor follows the trace — warning.
            sev = Severity.ERROR if "bool" in (fam_d, fam_i) \
                else Severity.WARNING
            ctx.diag(
                sev, "dtype-mismatch",
                f"output {name!r} is declared {c['declared']} but the "
                f"op's compute rule produces {c['inferred']}",
                path, i, op.type, var=name,
                hint=f"fix the variable's declared dtype (or cast the "
                     f"op result to {c['declared']})")
        elif c.get("kind") == "rank":
            ctx.diag(
                Severity.WARNING, "shape-mismatch",
                f"output {name!r} is declared rank "
                f"{len(c['declared'])} {c['declared']} but the compute "
                f"rule produces rank {len(c['inferred'])} "
                f"{c['inferred']}",
                path, i, op.type, var=name)
        else:
            ctx.diag(
                Severity.WARNING, "shape-mismatch",
                f"output {name!r} dim {c.get('dim')}: declared "
                f"{c['declared']} vs inferred {c['inferred']}",
                path, i, op.type, var=name)


# ---------------------------------------------------------------------------
@register_pass
class UninitPersistablePass(AnalysisPass):
    """Persistable vars read by the main program must be initialized by
    the paired startup program (or carry a build-time initializer) — a
    miss surfaces at runtime as a scope KeyError mid-trace, or worse,
    as stale state from an earlier test. Runs only when the verifier is
    given the startup program (weights loaded from a checkpoint are
    initialized out-of-band, so the pass would false-positive there).
    """

    name = "uninit_persistable"

    def run(self, ctx: PassContext) -> None:
        if ctx.startup is None:
            return
        startup_writes = _written_names(ctx.startup)
        program = ctx.program
        # first access of each persistable var in EXECUTION order: a
        # sub-block executes at its enclosing control-flow op, so its
        # reads/writes are interleaved there (an op's own inputs are
        # read before its body runs; its outputs are written after) —
        # iter_ops' blocks-last order would mis-attribute a body read
        # that precedes a later root-block write
        first: Dict[str, Tuple[str, Tuple[int, ...], int, str]] = {}
        seen_blocks: set = set()

        def record(blk, name, kind, path, i, op_type):
            v = blk.find_var_recursive(name)
            if v is not None and v.persistable and name not in first:
                first[name] = (kind, path, i, op_type)

        def visit(blk: ir.BlockDesc, path: Tuple[int, ...]):
            if blk.idx in seen_blocks:
                return
            seen_blocks.add(blk.idx)
            for i, op in enumerate(blk.ops):
                for name in op.input_names():
                    record(blk, name, "read", path, i, op.type)
                for attr in SUB_BLOCK_ATTRS:
                    idx = op.attrs.get(attr)
                    if isinstance(idx, int) \
                            and 0 <= idx < len(program.blocks):
                        visit(program.blocks[idx], path + (idx,))
                for name in op.output_names():
                    record(blk, name, "write", path, i, op.type)

        visit(program.blocks[ctx.block_idx], (ctx.block_idx,))
        for name, (kind, path, op_i, op_type) in sorted(first.items()):
            if kind != "read" or name in startup_writes:
                continue
            blk = ctx.program.blocks[path[-1]]
            v = blk.find_var_recursive(name)
            if v is not None and v.initializer is not None:
                continue
            ctx.diag(
                Severity.ERROR, "uninit-persistable",
                f"persistable var {name!r} is read before any write, "
                f"but the startup program never initializes it",
                path, op_i, op_type, var=name,
                hint="add an initializer op for it to the startup "
                     "program (or load it from a checkpoint before "
                     "running)")


# ---------------------------------------------------------------------------
@register_pass
class DeadCodePass(AnalysisPass):
    """Dead ops and unreachable vars relative to the fetch targets.

    Backward liveness over the root block: an op is live when an output
    is (transitively) needed by a fetch, or it has effects — writes
    persistable state, is host-stateful (channels/readers), or contains
    such an op in a sub-block. Root block only: liveness inside a
    sub-block depends on the enclosing op's carry semantics
    (KNOWN_GAPS: lints are heuristic).
    """

    name = "dead_code"

    def run(self, ctx: PassContext) -> None:
        if not ctx.fetch_names:
            return
        program = ctx.program
        root = program.blocks[ctx.block_idx]
        needed: Set[str] = set(ctx.fetch_names)
        live: List[bool] = [False] * len(root.ops)
        for i in range(len(root.ops) - 1, -1, -1):
            op = root.ops[i]
            if needed.intersection(op.output_names()) \
                    or self._has_effects(program, root, op):
                live[i] = True
                needed.update(op.input_names())
                needed.update(self._closure_reads(program, op))
        for i, op in enumerate(root.ops):
            if not live[i]:
                ctx.diag(
                    Severity.WARNING, "dead-op",
                    f"op contributes to no fetch target and has no "
                    f"side effects (fetches: {ctx.fetch_names})",
                    (ctx.block_idx,), i, op.type,
                    hint="remove it, or fetch one of its outputs")
        self._unreachable_vars(ctx, root)

    @staticmethod
    def _has_effects(program: ir.Program, block: ir.BlockDesc,
                     op: ir.OpDesc) -> bool:
        seen: Set[int] = set()   # guards corrupt self-referential blocks

        def visit(blk: ir.BlockDesc, o: ir.OpDesc) -> bool:
            if OpRegistry.has(o.type) and OpRegistry.get(o.type).stateful:
                return True
            for name in o.output_names():
                # resolve along the op's OWN parent chain — a same-named
                # persistable var in an unrelated block is not an effect
                v = blk.find_var_recursive(name)
                if v is not None and v.persistable:
                    return True
            for attr in SUB_BLOCK_ATTRS:
                idx = o.attrs.get(attr)
                if isinstance(idx, int) and 0 <= idx < len(program.blocks) \
                        and idx not in seen:
                    seen.add(idx)
                    sub = program.blocks[idx]
                    if any(visit(sub, s) for s in sub.ops):
                        return True
            return False
        return visit(block, op)

    @staticmethod
    def _closure_reads(program: ir.Program, op: ir.OpDesc,
                       _seen: Optional[Set[int]] = None) -> Set[str]:
        """Sub-block ops read enclosing-scope vars directly (closure
        style); a live control-flow op therefore needs every name its
        body reads."""
        seen = set() if _seen is None else _seen
        reads: Set[str] = set()
        for attr in SUB_BLOCK_ATTRS:
            idx = op.attrs.get(attr)
            if isinstance(idx, int) and 0 <= idx < len(program.blocks) \
                    and idx not in seen:
                seen.add(idx)
                for sub_op in program.blocks[idx].ops:
                    reads.update(sub_op.input_names())
                    reads.update(DeadCodePass._closure_reads(
                        program, sub_op, seen))
        return reads

    def _unreachable_vars(self, ctx: PassContext, root: ir.BlockDesc):
        referenced: Set[str] = set()
        for _blk, _path, _i, op in iter_ops(ctx.program, ctx.block_idx):
            referenced.update(op.input_names())
            referenced.update(op.output_names())
        feeds = ctx.feed_names or set()
        fetches = set(ctx.fetch_names or ())
        for name, v in root.vars.items():
            if name in referenced or name in feeds or name in fetches:
                continue
            if v.persistable or v.is_parameter:
                continue
            ctx.diag(
                Severity.INFO, "unreachable-var",
                f"var {name!r} is declared but referenced by no op, "
                f"feed, or fetch", (ctx.block_idx,), var=name,
                hint="drop the declaration, or wire it into the graph")


# ---------------------------------------------------------------------------
@register_pass
class DonationHazardPass(AnalysisPass):
    """Fetches of donated rw-state vars.

    With state donation on, the executor aliases read-write persistable
    buffers (params + optimizer accumulators) into the jitted step: an
    ASYNC fetch of such a var would hand back a lazy handle onto a
    buffer the next step donates (and XLA deletes). Previously this
    was only caught at runtime in core/executor.py; here the same
    hazard is flagged statically — as an error under
    (donate, async dispatch), as a warning otherwise (the sync
    materialize-before-next-step path is safe).
    """

    name = "donation"

    def run(self, ctx: PassContext) -> None:
        if not ctx.fetch_names:
            return
        rw = set(rw_state_names(ctx.program, ctx.block_idx))
        hazardous = [n for n in ctx.fetch_names if n in rw]
        if not hazardous:
            return
        is_error = ctx.donate and ctx.async_dispatch
        for name in hazardous:
            ctx.diag(
                Severity.ERROR if is_error else Severity.WARNING,
                "donated-fetch",
                f"fetch of donated state var {name!r}: with state "
                f"donation the lazy StepResult would hold a buffer the "
                f"next step donates (and XLA deletes)"
                + ("" if is_error else
                   " — safe now, but breaks under async dispatch "
                   "(sync=False) with donation on"),
                (ctx.block_idx,), var=name,
                hint=DONATED_FETCH_HINT)
