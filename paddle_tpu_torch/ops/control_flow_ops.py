"""Control-flow ops: sub-blocks run by the op runner, as masked loops of
a fixed length wherever the JAX package lowers to lax.scan.

The port's copy of ``paddle_tpu/ops/control_flow_ops.py`` (reference:
paddle/fluid/operators/{while_op.cc:35, recurrent_op.cc:222,
conditional_block_op.cc, tensor_array_read_write_op.cc}). A sub-block
runs through the same op runner as the block that holds it, over a copy
of the enclosing environment (its locals never leak out). The JAX
package's lowerings map onto torch as:

- lax.scan (static_rnn, dynamic_rnn, a While with a bound): a host loop
  of that fixed length whose state updates are ``torch.where`` selects.
  It never reads a device value on the host, so a CUDA graph captures
  it, and torch autograd differentiates it as jax.vjp does the scan;
- lax.while_loop (a While with no bound): a host loop that reads the
  condition each pass. It cannot be captured (registered capturable
  per op: see ``_while_capturable``);
- lax.cond (cond): reads the predicate on the host and runs the taken
  branch; registered capturable=False. lax.cond refuses branches whose
  outputs differ in dtype or shape (under AMP a bias-free fc in one
  branch returns bf16 where the other returns float32), so the port
  also runs the branch not taken, once per input signature and without
  gradients, and raises the same TypeError whichever branch is taken
  (``_branch_type``).

lax.scan and lax.while_loop refuse a body whose carry leaves with another
dtype or shape than it entered (under AMP a bf16 ``mul`` can turn a
float32 memory into bf16), and the reference raises TypeError before the
program runs. Every loop here checks each carry after each pass
(``_check_carry``) and raises TypeError in the same cases, before any
optimizer op of the step; where the reference selects finished rows
with jnp.where (dynamic_rnn, a bounded While), the check reads the
selected value, which type promotion keeps float32 when a float32
memory meets a bf16 update, as there.

``go`` (channels) waits for the CSP module (ROADMAP A11).
"""
from __future__ import annotations

from functools import partial

import torch

from ..core.lod import RAGGED_TYPES, RaggedPair, ragged_like, ragged_parts
from ..amp import amp_enabled
from ..core.registry import OpRegistry, register_op, run_op

register_op_CF = partial(register_op, ragged_aware=True)


def _trace_sub(ctx, block_idx, env):
    """Run every op of sub-block `block_idx` over `env` (mutated and
    returned), with the enclosing op's run-wide extra."""
    prog = ctx.extra["program"]
    for op in prog.blocks[block_idx].ops:
        env.update(run_op(op, env, ctx.extra))
    return env


def nested_dynamic_wids(program, blk_idx):
    """while_ids of every unbounded (dynamic_bound) While nested
    anywhere under block `blk_idx`, in deterministic program order.
    Static program structure."""
    out = []

    def visit(bi):
        for op in program.blocks[bi].ops:
            if op.type == "while" and op.attrs.get("dynamic_bound") and \
                    int(op.attrs.get("max_steps", 0) or 0) <= 0:
                out.append(op.attrs.get("while_id"))
            for attr in ("sub_block_idx", "true_block_idx",
                         "false_block_idx"):
                idx = op.attrs.get(attr)
                if isinstance(idx, int):
                    visit(idx)

    visit(blk_idx)
    return out


def union_nested_wids(program, blk_idxs):
    """Deduped union of nested_dynamic_wids over several blocks, in
    block order — the one ordering contract between an op's declared
    nested_while_ids attr, its NestedSteps outputs and the executor's
    zip of the two."""
    wids = []
    for b in blk_idxs:
        for w in nested_dynamic_wids(program, b):
            if w not in wids:
                wids.append(w)
    return wids


def _collect_reports(ctx, trace_fn):
    """Run `trace_fn()` with a fresh nested-steps report dict in
    ctx.extra; returns (its result, {wid: steps tensor}) reported by the
    dynamic Whiles run inside it. Each level max-accumulates its
    children's per-pass trip counts in its own state, so the WhileGrad
    probe reads one bound per nesting level."""
    extra = ctx.extra
    saved = extra.get("nested_steps_report")
    extra["nested_steps_report"] = {}
    try:
        result = trace_fn()
        rep = extra["nested_steps_report"]
    finally:
        extra["nested_steps_report"] = saved
    return result, rep


def _publish_report(ctx, entries):
    """Report {wid: steps} to an enclosing collector, if any."""
    rep = ctx.extra.get("nested_steps_report")
    if rep is not None:
        rep.update(entries)


def _zero_steps(ctx):
    return torch.zeros((), dtype=torch.int32, device=ctx.device)


def _select(mask, new, old):
    """torch.where(mask, new, old) over a tensor or over every tensor of
    a ragged value (its data and lengths), mask broadcast from the
    leading dims."""
    def one(n, o):
        m = mask.reshape(tuple(mask.shape) + (1,) * (n.ndim - mask.ndim))
        return torch.where(m, n, o)
    if isinstance(new, RAGGED_TYPES):
        return ragged_like(new, [one(n, o) for n, o in
                                 zip(ragged_parts(new), ragged_parts(old))])
    return one(new, old)


def _dt(t):
    return str(t.dtype).replace("torch.", "")


def _check_carry(lowering, names, before, after):
    """TypeError where a carry leaves a pass with another dtype or shape
    than it entered it (each part of a ragged carry), as `lowering`
    ("scan" or "while_loop") refuses such a body in the reference."""
    for name, old, new in zip(names, before, after):
        for o, n in zip(ragged_parts(old), ragged_parts(new)):
            if o.dtype != n.dtype or o.shape != n.shape:
                raise TypeError(
                    f"{lowering} body function carry input and carry output"
                    f" must have equal types, but they differ: the carry "
                    f"{name!r} enters as {_dt(o)}{list(o.shape)} and "
                    f"leaves as {_dt(n)}{list(n.shape)}")


def _max_steps(maxes, rep, nested, ctx):
    return [torch.maximum(m, rep.get(w, _zero_steps(ctx)))
            for w, m in zip(nested, maxes)]


@register_op_CF("static_rnn")
def _static_rnn(ctx):
    """A loop over the leading time axis of each step input; the step
    outputs stacked on that axis."""
    xs = ctx.inputs("X")                 # each [T, ...]
    carry = list(ctx.inputs("MemInit"))
    step_in = ctx.attr("step_in_names")
    mem_pre = ctx.attr("mem_pre_names")
    mem_new = ctx.attr("mem_new_names")
    out_names = ctx.attr("out_names")
    blk_idx = ctx.attr("sub_block_idx")
    outer = dict(ctx.env)
    nested = nested_dynamic_wids(ctx.extra["program"], blk_idx)
    maxes = [_zero_steps(ctx) for _ in nested]
    stacked = [[] for _ in out_names]
    for t in range(xs[0].shape[0]):
        def trace(carry=carry, t=t):
            env = dict(outer)
            env.update(zip(mem_pre, carry))
            env.update(zip(step_in, [x[t] for x in xs]))
            return _trace_sub(ctx, blk_idx, env)

        env, rep = _collect_reports(ctx, trace)
        maxes = _max_steps(maxes, rep, nested, ctx)
        new = [env[n] for n in mem_new]
        _check_carry("scan", mem_pre, carry, new)
        carry = new
        for acc, n in zip(stacked, out_names):
            acc.append(env[n])
    ctx.set_outputs("Out", [torch.stack(acc) for acc in stacked])
    ctx.set_outputs("NestedSteps", maxes)
    _publish_report(ctx, dict(zip(nested, maxes)))


def _while_capturable(op, while_bounds):
    """A While is captured on its masked routes: a max_steps bound, or a
    bound the WhileGrad probe gave it. Its host-driven route reads the
    condition on the host every pass."""
    return int(op.attrs.get("max_steps", 0) or 0) > 0 or \
        op.attrs.get("while_id") in while_bounds


@register_op_CF("while", capturable=_while_capturable)
def _while(ctx):
    """While loop, by three routes:

    (a) a positive `max_steps` attr: `max_steps` body passes, the state
        kept where the loop is still active (the JAX package's bounded
        masked scan). `Steps` counts the active passes, `Exhausted` says
        the condition still held at the end (silent truncation);
    (b) no max_steps, a bound for its while_id in extra["while_bounds"]:
        the same masked loop at that bound — the probed route of the
        probe-and-replay WhileGrad (core/executor.py);
    (c) no bound: a host loop that reads the condition every pass (the
        JAX package's lax.while_loop). Forward only in the JAX package;
        never captured here."""
    cond_name = ctx.attr("cond_name")
    carried = ctx.attr("carried_names")
    blk_idx = ctx.attr("sub_block_idx")
    max_steps = int(ctx.attr("max_steps", 0) or 0)
    wid = ctx.attr("while_id")
    if max_steps <= 0:
        bounds = ctx.extra.get("while_bounds") or {}
        if wid in bounds:
            max_steps = int(bounds[wid])
    outer = dict(ctx.env)
    cond0 = ctx.input("Cond").reshape(()).to(torch.bool)
    vals = [outer[n] for n in carried]
    nested = nested_dynamic_wids(ctx.extra["program"], blk_idx)
    maxes = [_zero_steps(ctx) for _ in nested]

    def body(vals, maxes):
        def trace():
            env = dict(outer)
            env.update(zip(carried, vals))
            return _trace_sub(ctx, blk_idx, env)

        env, rep = _collect_reports(ctx, trace)
        return (env[cond_name].reshape(()).to(torch.bool),
                [env[n] for n in carried], _max_steps(maxes, rep, nested,
                                                      ctx))

    if max_steps > 0:
        active, count = cond0, _zero_steps(ctx)
        for _ in range(max_steps):
            new_cond, new_vals, new_maxes = body(vals, maxes)
            new_vals = [_select(active, n, o) for n, o in zip(new_vals, vals)]
            _check_carry("scan", carried, vals, new_vals)
            vals = new_vals
            maxes = [torch.where(active, nm, m)
                     for nm, m in zip(new_maxes, maxes)]
            count = count + active.to(torch.int32)
            active = active & new_cond
        ctx.set_outputs("Out", vals)
        ctx.set_output("Exhausted", active)
        ctx.set_output("Steps", count)
        ctx.set_outputs("NestedSteps", maxes)
        _publish_report(ctx, dict(zip(nested, maxes)))
        return

    cond, steps = cond0, 0
    while bool(cond):
        cond, new_vals, maxes = body(vals, maxes)
        _check_carry("while_loop", carried, vals, new_vals)
        vals = new_vals
        steps += 1
    steps = torch.tensor(steps, dtype=torch.int32).to(ctx.device)
    ctx.set_outputs("Out", vals)
    ctx.set_output("Steps", steps)
    ctx.set_outputs("NestedSteps", maxes)
    _publish_report(ctx, {wid: steps, **dict(zip(nested, maxes))})


def _value_type(v):
    """(dtype, shape) of each part of a tensor or ragged value."""
    return tuple((_dt(t), tuple(t.shape)) for t in ragged_parts(v))


#: (program uid, version, block, AMP state, input types) -> the type of
#: the block's output: what a branch's output type is, learned from one
#: run of the branch (bounded: cleared when it outgrows _TYPES_MAX)
_BRANCH_TYPES = {}
_TYPES_MAX = 4096


def _branch_type(ctx, blk, out_name, env_type, value=None):
    """The output type of branch `blk` on inputs of type `env_type`:
    from `value` (the branch just ran), the cache, or one run of the
    branch without gradients whose nested trip counts are dropped (the
    branch lax.cond traces but does not take)."""
    prog = ctx.extra["program"]
    key = (prog.uid, prog.version, blk, amp_enabled(), env_type)
    typ = _BRANCH_TYPES.get(key)
    if typ is None:
        if value is None:
            with torch.no_grad():
                env, _ = _collect_reports(
                    ctx, lambda: _trace_sub(ctx, blk, dict(ctx.env)))
            value = env[out_name]
        typ = _value_type(value)
        if len(_BRANCH_TYPES) >= _TYPES_MAX:
            _BRANCH_TYPES.clear()
        _BRANCH_TYPES[key] = typ
    return typ


def _type_str(typ):
    return ", ".join(f"{d}[{','.join(map(str, s))}]" for d, s in typ)


@register_op_CF("cond", capturable=False)
def _cond(ctx):
    """Runs the branch the predicate takes, read on the host (the JAX
    package's lax.cond). The dynamic Whiles inside either branch report
    their trip counts as NestedSteps: 0 for a loop of the branch not
    taken, which can only under-report — the probe needs counts only for
    what ran. Raises TypeError, before the output is set, where the two
    branches' outputs differ in dtype or shape, as lax.cond refuses
    them."""
    pred = ctx.input("Pred")
    prog = ctx.extra["program"]
    tb = ctx.attr("true_block_idx")
    fb = ctx.attr("false_block_idx")
    wids = ctx.attr("nested_while_ids", None)
    if wids is None:   # op built without the layer: same union, same order
        wids = union_nested_wids(prog, (tb, fb))
    taken = bool(pred.reshape(()))
    blk, out_name = (tb, ctx.attr("true_out")) if taken \
        else (fb, ctx.attr("false_out"))
    env_type = tuple(sorted((n, _value_type(v)) for n, v in ctx.env.items()
                            if isinstance(v, (torch.Tensor,) + RAGGED_TYPES)))
    env, rep = _collect_reports(
        ctx, lambda: _trace_sub(ctx, blk, dict(ctx.env)))
    types = {blk: _branch_type(ctx, blk, out_name, env_type, env[out_name])}
    other, other_out = (fb, ctx.attr("false_out")) if taken \
        else (tb, ctx.attr("true_out"))
    types[other] = _branch_type(ctx, other, other_out, env_type)
    if types[tb] != types[fb]:
        raise TypeError(
            "cond branches must have equal output types but they differ: "
            f"the output of true_fun has type {_type_str(types[tb])} but "
            "the corresponding output of false_fun has type "
            f"{_type_str(types[fb])}")
    steps = [rep.get(w, _zero_steps(ctx)) for w in wids]
    ctx.set_output("Out", env[out_name])
    ctx.set_outputs("NestedSteps", steps)
    _publish_report(ctx, dict(zip(wids, steps)))


# -- tensor arrays (dense fixed-capacity form) ------------------------------

def _index(ctx, cap):
    """The I input as a 1-element int64 device tensor clamped into
    [0, cap - 1], as dynamic_update_index_in_dim clamps it (torch
    indexing would raise); never read on the host."""
    i = ctx.input("I").reshape(1).to(torch.int64)
    return torch.clamp(i, 0, cap - 1)


@register_op_CF("array_write", no_grad_slots=["I"])
def _array_write(ctx):
    x = ctx.input("X")
    arr = ctx.input("Array")
    if arr is None:
        cap = ctx.attr("capacity", 128)
        arr = torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
    i = _index(ctx, arr.shape[0])
    ctx.set_output("Out", arr.index_copy(0, i, x.unsqueeze(0)))


@register_op_CF("array_read", no_grad_slots=["I"])
def _array_read(ctx):
    arr = ctx.input("Array")
    ctx.set_output("Out", arr.index_select(
        0, _index(ctx, arr.shape[0])).squeeze(0))


@register_op_CF("array_length", no_grad_slots=["Array"])
def _array_length(ctx):
    """The capacity of the dense backing, not the count of writes (the
    JAX package's quirk, mirrored)."""
    arr = ctx.input("Array")
    ctx.set_output("Out", torch.full((), arr.shape[0], dtype=torch.int64,
                                     device=arr.device))


@register_op_CF("dynamic_rnn")
def _dynamic_rnn(ctx):
    """Ragged-batch RNN (reference: DynamicRNN control_flow.py:1354 with
    lod_rank_table/shrink_rnn_memory). The batch stays dense [B, T, ...]
    over t_max steps: finished rows freeze their memory (a where) and
    their outputs are zero past each row's length. The FIRST input's
    lengths drive the mask (the reference rejects mismatched LoD; a
    mismatch follows the first input here, as in the JAX package)."""
    xs_in = ctx.inputs("X")
    carry = list(ctx.inputs("MemInit"))
    step_in = ctx.attr("step_in_names")
    mem_pre = ctx.attr("mem_pre_names")
    mem_new = ctx.attr("mem_new_names")
    out_names = ctx.attr("out_names")
    blk_idx = ctx.attr("sub_block_idx")
    outer = dict(ctx.env)
    rags = [x if isinstance(x, RaggedPair) else RaggedPair(
        x, torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                      device=x.device)) for x in xs_in]
    lengths = rags[0].lengths
    t_max = rags[0].data.shape[1]
    nested = nested_dynamic_wids(ctx.extra["program"], blk_idx)
    maxes = [_zero_steps(ctx) for _ in nested]
    stacked = [[] for _ in out_names]
    for t in range(t_max):
        active = lengths > t             # [B]

        def trace(carry=carry, t=t):
            env = dict(outer)
            env.update(zip(mem_pre, carry))
            env.update(zip(step_in, [r.data[:, t] for r in rags]))
            return _trace_sub(ctx, blk_idx, env)

        env, rep = _collect_reports(ctx, trace)
        maxes = _max_steps(maxes, rep, nested, ctx)
        new = [_select(active, env[n], old)
               for old, n in zip(carry, mem_new)]
        _check_carry("scan", mem_pre, carry, new)
        carry = new
        for acc, n in zip(stacked, out_names):
            o = env[n]
            acc.append(_select(active, o, torch.zeros_like(o)))
    ctx.set_outputs("Out", [RaggedPair(torch.stack(acc, 1), lengths)
                            for acc in stacked])
    ctx.set_outputs("LastMem", carry)
    ctx.set_outputs("NestedSteps", maxes)
    _publish_report(ctx, dict(zip(nested, maxes)))


@register_op_CF("if_else")
def _if_else(ctx):
    """Row-wise two-branch select (reference: IfElse control_flow.py:1252
    over split_lod_tensor/merge_lod_tensor). Both branches run over the
    whole batch and rows are merged by the condition — the JAX package's
    dense form, which a CUDA graph captures."""
    cond = ctx.input("Cond")
    outer = dict(ctx.env)
    prog = ctx.extra["program"]
    tb = ctx.attr("true_block_idx")
    fb = ctx.attr("false_block_idx")
    wids = ctx.attr("nested_while_ids", None)
    if wids is None:
        wids = union_nested_wids(prog, (tb, fb))
    env_t, rep_t = _collect_reports(
        ctx, lambda: _trace_sub(ctx, tb, dict(outer)))
    env_f, rep_f = _collect_reports(
        ctx, lambda: _trace_sub(ctx, fb, dict(outer)))
    c = cond.reshape(-1).to(torch.bool)
    merged = []
    for tn, fn in zip(ctx.attr("true_out_names"),
                      ctx.attr("false_out_names")):
        tv, fv = env_t[tn], env_f[fn]
        merged.append(torch.where(
            c.reshape((-1,) + (1,) * (tv.ndim - 1)), tv, fv))
    ctx.set_outputs("Out", merged)
    # both branches run in the dense form: report the max
    maxes = [torch.maximum(rep_t.get(w, _zero_steps(ctx)),
                           rep_f.get(w, _zero_steps(ctx))) for w in wids]
    ctx.set_outputs("NestedSteps", maxes)
    _publish_report(ctx, dict(zip(wids, maxes)))


@register_op_CF("pipeline")
def _pipeline(ctx):
    """Program-level GPipe pipeline (layers/control_flow.py
    PipelinedStack), its one-device arm: the stages composed in
    sequence, stage i reading slice i of every stacked parameter. The
    JAX package's microbatched arm over a mesh's pipe axis waits for
    the port's meshes (ROADMAP A11)."""
    x = ctx.input("X")
    params = ctx.inputs("StageParams")
    names = ctx.attr("param_names")
    axis = ctx.attr("axis", "pipe")
    mesh = ctx.extra.get("mesh")
    if mesh is not None and axis in getattr(mesh, "axis_names", ()):
        raise NotImplementedError(
            f"pipeline over the mesh axis {axis!r}: the port runs the "
            "one-device arm only; the pipe-axis arm waits for ROADMAP A11")
    outer = dict(ctx.env)
    a = x
    for i in range(ctx.attr("n_stages")):
        env = dict(outer)
        env.update((n, p[i]) for n, p in zip(names, params))
        env[ctx.attr("stage_in_name")] = a
        a = _trace_sub(ctx, ctx.attr("sub_block_idx"),
                       env)[ctx.attr("stage_out_name")]
    ctx.set_output("Out", a)


# ---------------------------------------------------------------------------
# Explicit shape-inference rules for the control-flow family (the JAX
# package's, rule for rule). The meta trace cannot run these ops (their
# rules trace sub-blocks and read extra["program"]), so the outputs'
# metadata is derived from the program's structure:
#
# - while:      Out re-writes already-declared parent carries; the
#               Exhausted/Steps/NestedSteps flags are scalars.
# - if_else:    Out[i] mirrors the true branch's i-th output var.
# - static_rnn: Out[i] = [T, *step_out_shape].
# - dynamic_rnn: Out[i] mirrors the sub-block step output (ragged,
#               lod_level 1); LastMem[i] mirrors the init memory.

def _scalar_specs(op, slots_dtypes):
    specs = {}
    for slot, dtype in slots_dtypes:
        for n in op.output(slot):
            specs[n] = {"shape": [], "dtype": dtype, "lod_level": 0}
    return specs


def _sub_var(block_desc, blk_idx, name):
    prog = block_desc.program
    if not isinstance(blk_idx, int) or not 0 <= blk_idx < len(prog.blocks):
        return None
    return prog.blocks[blk_idx].find_var_recursive(name)


def _while_infer(block_desc, op):
    return _scalar_specs(op, [("Exhausted", "bool"), ("Steps", "int32"),
                              ("NestedSteps", "int32")])


def _if_else_infer(block_desc, op):
    specs = _scalar_specs(op, [("NestedSteps", "int32")])
    tb = op.attrs.get("true_block_idx")
    for out, tn in zip(op.output("Out"),
                       op.attrs.get("true_out_names") or []):
        tv = _sub_var(block_desc, tb, tn)
        if tv is not None and tv.shape is not None:
            specs[out] = {"shape": list(tv.shape), "dtype": tv.dtype,
                          "lod_level": tv.lod_level}
    return specs


def _static_rnn_infer(block_desc, op):
    specs = _scalar_specs(op, [("NestedSteps", "int32")])
    t_dim = -1
    for xn in op.input("X"):
        xv = block_desc.find_var_recursive(xn)
        if xv is not None and xv.shape:
            t_dim = xv.shape[0]
            break
    blk_idx = op.attrs.get("sub_block_idx")
    for out, sn in zip(op.output("Out"),
                       op.attrs.get("out_names") or []):
        sv = _sub_var(block_desc, blk_idx, sn)
        if sv is not None and sv.shape is not None:
            specs[out] = {"shape": [t_dim] + list(sv.shape),
                          "dtype": sv.dtype, "lod_level": 0}
    return specs


def _dynamic_rnn_infer(block_desc, op):
    specs = _scalar_specs(op, [("NestedSteps", "int32")])
    blk_idx = op.attrs.get("sub_block_idx")
    for out, sn in zip(op.output("Out"),
                       op.attrs.get("out_names") or []):
        sv = _sub_var(block_desc, blk_idx, sn)
        if sv is not None and sv.shape is not None:
            specs[out] = {"shape": list(sv.shape), "dtype": sv.dtype,
                          "lod_level": 1}
    for out, mn in zip(op.output("LastMem"), op.input("MemInit")):
        mv = block_desc.find_var_recursive(mn)
        if mv is not None and mv.shape is not None:
            specs[out] = {"shape": list(mv.shape), "dtype": mv.dtype,
                          "lod_level": 0}
    return specs


for _t, _rule in (("while", _while_infer), ("if_else", _if_else_infer),
                  ("static_rnn", _static_rnn_infer),
                  ("dynamic_rnn", _dynamic_rnn_infer)):
    OpRegistry.get(_t).infer_shape = _rule
