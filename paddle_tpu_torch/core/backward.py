"""Desc-level autodiff: append gradient ops to a Program.

The port's copy of ``paddle_tpu/core/backward.py`` (reference:
python/paddle/fluid/backward.py:273-425 + grad_op_desc_maker.h:33): ops
are walked in reverse, a grad-op description is appended per forward op,
and duplicate gradient contributions are summed. Ops may register an
explicit grad maker; every op without one gets the generic ``__vjp__``
grad op, whose compute rule (ops/core_ops.py) replays the forward
compute rule under torch autograd — exact gradients with no per-op
adjoint code. The descs it appends are the JAX package's, so a program
with its backward serializes to the same JSON in both packages. Eager
torch has no CSE, so each ``__vjp__`` recomputes its forward op once.
A sub-block op's closure reads (at every nesting level) become extra
``__vjp__`` inputs, and an in-place carry's pre-op value is snapshotted
for the replay, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from .ir import BlockDesc, OpDesc, Program, SUB_BLOCK_ATTRS, VarDesc
from .registry import OpRegistry, grad_var_name

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def _is_differentiable(var: Optional[VarDesc]) -> bool:
    if var is None:
        return False
    if var.stop_gradient:
        return False
    return var.dtype in _FLOAT_DTYPES


class _GradAccumulator:
    """Tracks gradient contributions per forward var; sums duplicates."""

    def __init__(self, block: BlockDesc):
        self.block = block
        self.contribs: Dict[str, List[str]] = {}
        self._uid = 0

    def fresh_name(self, fwd_name: str) -> str:
        self._uid += 1
        return f"{grad_var_name(fwd_name)}@RENAME@{self._uid}"

    def add(self, fwd_name: str, grad_name: str):
        self.contribs.setdefault(fwd_name, []).append(grad_name)

    def has(self, fwd_name: str) -> bool:
        return bool(self.contribs.get(fwd_name))

    def materialize(self, fwd_name: str) -> str:
        """Return the name of the (summed) gradient of fwd_name, appending a
        sum op if there are multiple contributions."""
        names = self.contribs[fwd_name]
        target = grad_var_name(fwd_name)
        if len(names) == 1:
            if names[0] != target:
                # single renamed contribution: alias via identity-sum
                self.block.append_op("sum", {"X": [names[0]]}, {"Out": [target]})
                self._declare_grad_var(fwd_name, target)
                self.contribs[fwd_name] = [target]
            return target
        self.block.append_op("sum", {"X": list(names)}, {"Out": [target]})
        self._declare_grad_var(fwd_name, target)
        self.contribs[fwd_name] = [target]
        return target

    def _declare_grad_var(self, fwd_name: str, grad_name: str):
        fwd = self.block.find_var_recursive(fwd_name)
        if fwd is not None and not self.block.has_var(grad_name):
            self.block.create_var(grad_name, shape=fwd.shape, dtype=fwd.dtype,
                                  lod_level=fwd.lod_level)


_SUB_BLOCK_ATTRS = SUB_BLOCK_ATTRS


def _sub_block_free_vars(op: OpDesc, block: BlockDesc) -> List[str]:
    """Outer-block variables a sub-block op's body reads via closure (e.g.
    fc parameters created inside a DynamicRNN/While/StaticRNN block).
    These must become explicit __vjp__ inputs so gradients flow to them —
    the replay only differentiates w.r.t. its FwdIn values."""
    idxs = [op.attrs.get(a) for a in _SUB_BLOCK_ATTRS
            if isinstance(op.attrs.get(a), int)]
    if not idxs:
        return []
    program = block.program
    free: List[str] = []
    seen = set(op.input_names())

    def visit(blk: BlockDesc):
        local = set(blk.vars)
        for sub_op in blk.ops:
            for n in sub_op.input_names():
                if n in local or n in seen:
                    continue
                seen.add(n)
                if block.find_var_recursive(n) is not None:
                    free.append(n)
            for a in _SUB_BLOCK_ATTRS:
                v = sub_op.attrs.get(a)
                if isinstance(v, int) and 0 <= v < len(program.blocks):
                    visit(program.blocks[v])
            # names written by body ops are block-local for later ops
            local.update(sub_op.output_names())

    for idx in idxs:
        visit(program.blocks[idx])
    return free


def _generic_grad_op(op: OpDesc, block: BlockDesc, acc: _GradAccumulator,
                     no_grad: Set[str]) -> Optional[OpDesc]:
    """Build the generic vjp-based grad op for `op`. Returns None if no input
    needs a gradient or no output has one."""
    opdef = OpRegistry.get(op.type)

    fwd_in_entries: List[Tuple[str, str]] = []   # (slot, var name), flattened
    for slot, names in op.inputs.items():
        for n in names:
            fwd_in_entries.append((slot, n))
    closure_names = _sub_block_free_vars(op, block)
    for n in closure_names:
        fwd_in_entries.append(("__closure__", n))
    fwd_out_names = op.output_names()

    out_has_grad = [acc.has(n) for n in fwd_out_names]
    if not any(out_has_grad):
        return None

    in_need_grad = []
    for slot, n in fwd_in_entries:
        var = block.find_var_recursive(n)
        need = (slot not in opdef.no_grad_slots and n not in no_grad
                and _is_differentiable(var))
        in_need_grad.append(need)
    if not any(in_need_grad):
        return None

    if op.type == "while" and \
            not (isinstance(op.attrs.get("max_steps"), int)
                 and op.attrs.get("max_steps", 0) > 0) and \
            not op.attrs.get("dynamic_bound"):
        # the host-driven While route has no gradient in the JAX package
        # (lax.while_loop); the reference's WhileGrad (while_op.cc:96)
        # replays step scopes. The trainable paths: While(cond,
        # max_steps=N), a While built by the current layer
        # (dynamic_bound: the executor's probe-and-replay bakes a bucketed
        # bound into a masked loop), or DynamicRNN / StaticRNN. Only While
        # ops built without the dynamic_bound attr land here.
        raise NotImplementedError(
            "gradients through this unbounded While loop are not "
            "supported: pass max_steps=N to While (bounded, "
            "differentiable scan lowering), rebuild it with the current "
            "While layer (executor probe-and-replay), use DynamicRNN / "
            "StaticRNN for recurrences, or mark the loop's inputs "
            "stop_gradient")

    out_grad_names = [acc.materialize(n)
                      for n, h in zip(fwd_out_names, out_has_grad) if h]

    # In-place pattern (output aliases an input/closure name, e.g. While
    # carries): the cotangent of the post-op value is consumed HERE; the
    # pre-op value's grad is only what the replay produces below — drop
    # the consumed contribution so it isn't double counted upstream.
    in_name_set = {n for _, n in fwd_in_entries}
    for n, h in zip(fwd_out_names, out_has_grad):
        if h and n in in_name_set:
            acc.contribs[n] = []

    grad_outputs: List[str] = []
    produced: Dict[str, str] = {}
    for (slot, n), need in zip(fwd_in_entries, in_need_grad):
        if not need:
            continue
        # Duplicate appearances of the same var each get a renamed grad
        # output; the accumulator sums them later.
        gname = acc.fresh_name(n) if (n in produced or acc.has(n)) \
            else grad_var_name(n)
        produced.setdefault(n, gname)
        grad_outputs.append(gname)
        acc.add(n, gname)
        fwd = block.find_var_recursive(n)
        if fwd is not None:
            block.create_var(gname, shape=fwd.shape, dtype=fwd.dtype,
                             lod_level=fwd.lod_level)

    # In-place mutation (an output name that is also an input/closure
    # name — While carries, assign(output=existing), in-place
    # increments): by the time this grad op runs, env[name] holds the
    # POST-op value, so replaying the forward from it linearizes at the
    # wrong point (a While whose condition depends on the carry would
    # replay ZERO iterations). Snapshot the pre-op value into the
    # forward pass and feed the grad op the snapshot; the replay binds
    # values positionally to the ORIGINAL names, so the rule is
    # untouched. (Reference analog: WhileGrad's recorded step scopes,
    # while_op.cc:96.)
    mutated = set(fwd_out_names)
    snap_names: Dict[str, str] = {}
    fwd_in_value_names = []
    for _, n in fwd_in_entries:
        if n in mutated:
            if n not in snap_names:
                snap_names[n] = _snapshot_pre_value(op, block, n)
            fwd_in_value_names.append(snap_names[n])
        else:
            fwd_in_value_names.append(n)

    gop = OpDesc(
        "__vjp__",
        inputs={"FwdIn": fwd_in_value_names,
                "OutGrad": out_grad_names},
        outputs={"InGrad": grad_outputs},
        attrs={"fwd_op": op.to_dict(),
               "out_has_grad": out_has_grad,
               "in_need_grad": in_need_grad,
               "closure_names": closure_names},
    )
    return gop


_SNAP_COUNTER = [0]


def _snapshot_pre_value(op: OpDesc, block: BlockDesc, name: str) -> str:
    """Insert `assign(name -> snapshot)` right before `op` in the
    forward section; returns the snapshot var name."""
    _SNAP_COUNTER[0] += 1
    snap = f"{name}@PRE.{_SNAP_COUNTER[0]}"
    v = block.find_var_recursive(name)
    block.create_var(snap,
                     shape=(v.shape if v is not None else None),
                     dtype=(v.dtype if v is not None else "float32"),
                     lod_level=getattr(v, "lod_level", 0) if v else 0)
    sop = OpDesc("assign", inputs={"X": [name]}, outputs={"Out": [snap]},
                 attrs={})
    block.ops.insert(block.ops.index(op), sop)
    return snap


def append_backward(loss, parameter_list: Optional[Sequence[str]] = None,
                    no_grad_set: Optional[Set[str]] = None,
                    program: Optional[Program] = None):
    """Append grad ops computing d(loss)/d(param) for every trainable param.

    `loss` is a Variable (has .name/.block) or a var name in the program's
    global block. Returns [(param VarDesc-or-Variable, grad name)] pairs.
    """
    from .. import framework  # late import to avoid cycle

    if hasattr(loss, "block"):
        block = loss.block.desc if hasattr(loss.block, "desc") else loss.block
        prog = loss.block.program if hasattr(loss.block, "program") else program
        loss_name = loss.name
    else:
        prog = program or framework.default_main_program()
        block = prog.desc.global_block if hasattr(prog, "desc") \
            else prog.global_block
        loss_name = loss
    if hasattr(prog, "desc"):
        prog_desc = prog.desc
    else:
        prog_desc = prog

    no_grad = set(no_grad_set or ())
    for v in block.vars.values():
        if v.stop_gradient:
            no_grad.add(v.name)

    acc = _GradAccumulator(block)

    # Seed: d(loss)/d(loss) = 1.
    loss_var = block.var(loss_name)
    seed_name = grad_var_name(loss_name)
    block.create_var(seed_name, shape=loss_var.shape or [1],
                     dtype=loss_var.dtype)
    fwd_op_count = len(block.ops)
    block.append_op("fill_constant_like",
                    {"X": [loss_name]}, {"Out": [seed_name]},
                    {"value": 1.0, "dtype": loss_var.dtype})
    acc.add(loss_name, seed_name)

    # Reverse walk over the forward ops only.
    for op in reversed(block.ops[:fwd_op_count]):
        opdef = OpRegistry.get(op.type)
        if opdef.grad_maker is not None:
            if not any(acc.has(n) for n in op.output_names()):
                continue
            grad_ops = opdef.grad_maker(op, block, acc, no_grad)
            for gop in grad_ops or []:
                block.ops.append(gop)
        else:
            gop = _generic_grad_op(op, block, acc, no_grad)
            if gop is not None:
                block.ops.append(gop)
    prog_desc._bump_version()

    # Materialize summed grads for all trainable parameters.
    params_and_grads = []
    if parameter_list is not None:
        param_names = list(parameter_list)
    else:
        param_names = [v.name for v in prog_desc.all_parameters()
                       if v.trainable]
    for pname in param_names:
        if pname in no_grad or not acc.has(pname):
            continue
        gname = acc.materialize(pname)
        params_and_grads.append((pname, gname))
    return params_and_grads


def calc_gradient(targets, inputs, program: Optional[Program] = None):
    """Gradients of sum(targets) w.r.t. arbitrary vars (fluid.gradients
    parity). Returns list of grad var names aligned with `inputs`."""
    tgt = list(targets) if isinstance(targets, (list, tuple)) else [targets]
    if len(tgt) > 1:
        # Differentiate the sum of all targets, as fluid.gradients does.
        first = tgt[0]
        block = first.block.desc if hasattr(first.block, "desc") \
            else first.block
        from ..framework import unique_name
        total_name = unique_name("grad_targets_sum")
        t0 = block.var(tgt[0].name if hasattr(tgt[0], "name") else tgt[0])
        block.create_var(total_name, shape=t0.shape, dtype=t0.dtype)
        block.append_op(
            "sum",
            {"X": [t.name if hasattr(t, "name") else t for t in tgt]},
            {"Out": [total_name]})
        target = total_name
        prog = first.block.program if hasattr(first, "block") else program
        pairs = append_backward(target, parameter_list=[
            i if isinstance(i, str) else i.name for i in
            (inputs if isinstance(inputs, (list, tuple)) else [inputs])],
            program=prog)
    else:
        pairs = append_backward(tgt[0], parameter_list=[
            i if isinstance(i, str) else i.name for i in
            (inputs if isinstance(inputs, (list, tuple)) else [inputs])],
            program=program)
    by_name = dict(pairs)
    names = [i if isinstance(i, str) else i.name
             for i in (inputs if isinstance(inputs, (list, tuple)) else [inputs])]
    return [by_name.get(n) for n in names]
