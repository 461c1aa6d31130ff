"""Control-flow layers: StaticRNN, DynamicRNN, IfElse, While, the
tensor-array helpers, cond_op and PipelinedStack.

The port's copy of ``paddle_tpu/layers/control_flow.py`` (reference:
python/paddle/fluid/layers/control_flow.py StaticRNN:383, While:608,
IfElse:1252, DynamicRNN:1354, array ops). Each layer builds its body as
a sub-block (Program.create_block / rollback) and appends the op the
executor runs it through (ops/control_flow_ops.py), with the same ops,
attrs and var names as the JAX package's layer.
"""
from __future__ import annotations

from typing import List, Optional

from ..framework import Variable, default_main_program
from ..layer_helper import LayerHelper

__all__ = ["StaticRNN", "DynamicRNN", "IfElse", "While", "Switch",
           "PipelinedStack",
           "increment_shared", "array_write", "array_read", "array_length",
           "create_array", "less_than_v", "cond_op"]


class StaticRNN:
    """Fixed-length RNN over the time axis, run as one static_rnn op.

    Usage parity with reference StaticRNN (control_flow.py:383):
        rnn = StaticRNN()
        with rnn.step():
            word = rnn.step_input(x_t)           # x_t: [T, B, D]
            prev = rnn.memory(init=h0)           # or shape/value init
            h = some_layers(word, prev)
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        outs = rnn()
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._inputs: List[Variable] = []
        self._mem_init: List[Variable] = []
        self._mem_pre: List[Variable] = []
        self._mem_new: List[Optional[Variable]] = []
        self._outputs: List[Variable] = []
        self._block = None
        self._parent_prog = None
        self._entered = False

    class _StepGuard:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            prog = default_main_program()
            self.rnn._parent_prog = prog
            self.rnn._block = prog.create_block()
            self.rnn._entered = True
            return self.rnn

        def __exit__(self, exc_type, *exc):
            self.rnn._entered = False
            prog = self.rnn._parent_prog
            prog.rollback()
            if exc_type is None:
                self.rnn._finalize()
            return False

    def step(self):
        return StaticRNN._StepGuard(self)

    def step_input(self, x: Variable) -> Variable:
        """x: [T, ...]; returns the per-step slice variable."""
        sv = self._block.create_var(
            name=f"{x.name}@step", shape=list(x.shape[1:]) if x.shape
            else None, dtype=x.dtype)
        self._inputs.append((x, sv))
        return sv

    def memory(self, init: Variable = None, shape=None, value=0.0,
               dtype="float32") -> Variable:
        if init is None:
            # The init constant must live in the PARENT block (it feeds the
            # static_rnn op there), not the step sub-block we're inside.
            prog = self._parent_prog
            parent = prog.block(self._block.desc.parent_idx)
            from ..framework import unique_name
            init = parent.create_var(name=unique_name("rnn_mem_init"),
                                     shape=list(shape), dtype=dtype)
            parent.append_op("fill_constant", outputs={"Out": init},
                             attrs={"shape": list(shape), "dtype": dtype,
                                    "value": float(value)})
        pre = self._block.create_var(name=f"{init.name}@pre",
                                     shape=list(init.shape)
                                     if init.shape else None,
                                     dtype=init.dtype)
        self._mem_init.append(init)
        self._mem_pre.append(pre)
        self._mem_new.append(None)
        return pre

    def update_memory(self, pre: Variable, new: Variable):
        idx = self._mem_pre.index(pre)
        self._mem_new[idx] = new

    def step_output(self, out: Variable):
        self._outputs.append(out)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _finalize(self):
        helper = self.helper
        self._result_vars = [
            helper.create_tmp_variable(o.dtype) for o in self._outputs]
        outputs = {"Out": self._result_vars}
        attrs = {"sub_block_idx": self._block.idx,
                 "step_in_names": [sv.name for _, sv in self._inputs],
                 "mem_pre_names": [v.name for v in self._mem_pre],
                 "mem_new_names": [v.name for v in self._mem_new],
                 "out_names": [o.name for o in self._outputs]}
        _wire_nested_steps(helper, self._parent_prog,
                           [self._block.desc.idx], outputs, attrs)
        helper.append_op(
            type="static_rnn",
            inputs={"X": [x for x, _ in self._inputs],
                    "MemInit": self._mem_init},
            outputs=outputs, attrs=attrs)

    def __call__(self):
        res = self._result_vars
        return res[0] if len(res) == 1 else res


class DynamicRNN:
    """Ragged-sequence RNN (reference: control_flow.py DynamicRNN:1354).

    Usage parity with the reference:
        drnn = DynamicRNN()
        with drnn.block():
            word = drnn.step_input(sentence)      # ragged [B, T, D]
            prev = drnn.memory(shape=[H], value=0.0)   # or init=...
            h = some_layers(word, prev)
            drnn.update_memory(prev, h)
            drnn.output(h)
        out = drnn()          # ragged [B, T, H]

    The reference shrinks the running batch as short sequences end
    (lod_rank_table + shrink_rnn_memory); here the dense masked loop
    freezes finished rows instead — see ops/control_flow_ops.py
    dynamic_rnn."""

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._inputs = []            # (outer ragged var, step var)
        self._static = []
        self._mem_init: List[Variable] = []
        self._mem_pre: List[Variable] = []
        self._mem_new: List[Optional[Variable]] = []
        self._outputs: List[Variable] = []
        self._block = None
        self._parent_prog = None

    class _Guard:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            prog = default_main_program()
            self.rnn._parent_prog = prog
            self.rnn._block = prog.create_block()
            return self.rnn

        def __exit__(self, exc_type, *exc):
            self.rnn._parent_prog.rollback()
            if exc_type is None:
                self.rnn._finalize()
            return False

    def block(self):
        return DynamicRNN._Guard(self)

    def step_input(self, x: Variable) -> Variable:
        """x: ragged var (declared [batch, *feature] — the time axis is
        implicit in lod_level=1 data); the per-step slice has the same
        declared shape."""
        sv = self._block.create_var(name=f"{x.name}@dstep",
                                    shape=list(x.shape) if x.shape
                                    else None, dtype=x.dtype)
        self._inputs.append((x, sv))
        return sv

    def static_input(self, x: Variable) -> Variable:
        """Non-sequence input visible unchanged at every step (closure
        over the outer env — no slicing)."""
        self._static.append(x)
        return x

    def memory(self, init: Variable = None, shape=None, value=0.0,
               dtype="float32") -> Variable:
        if init is None:
            if not self._inputs:
                raise ValueError("DynamicRNN.memory(shape=...) needs a "
                                 "step_input first (for the batch size)")
            prog = self._parent_prog
            parent = prog.block(self._block.desc.parent_idx)
            from ..framework import unique_name
            ref = self._inputs[0][0]
            init = parent.create_var(name=unique_name("drnn_mem_init"),
                                     shape=[-1] + list(shape), dtype=dtype)
            parent.append_op(
                "fill_constant_batch_size_like",
                inputs={"Input": ref}, outputs={"Out": init},
                attrs={"shape": [-1] + list(shape), "dtype": dtype,
                       "value": float(value), "input_dim_idx": 0,
                       "output_dim_idx": 0})
        pre = self._block.create_var(name=f"{init.name}@dpre",
                                     shape=list(init.shape)
                                     if init.shape else None,
                                     dtype=init.dtype)
        self._mem_init.append(init)
        self._mem_pre.append(pre)
        self._mem_new.append(None)
        return pre

    def update_memory(self, pre: Variable, new: Variable):
        self._mem_new[self._mem_pre.index(pre)] = new

    def output(self, *outputs):
        self._outputs.extend(outputs)

    def _finalize(self):
        for i, new in enumerate(self._mem_new):
            if new is None:
                raise ValueError(
                    f"DynamicRNN memory #{i} "
                    f"({self._mem_pre[i].name!r}) was declared but "
                    "update_memory() was never called for it")
        helper = self.helper
        # carry the per-step feature shape onto the ragged results so
        # downstream layers (fc after sequence_pool/last_step) can
        # size their parameters (declared shape convention: [batch,
        # *feature], time axis implicit in lod_level=1)
        self._result_vars = [
            helper.create_tmp_variable(
                o.dtype, lod_level=1,
                shape=list(o.shape) if o.shape else None)
            for o in self._outputs]
        self._last_mem_vars = [
            helper.create_tmp_variable(m.dtype, shape=list(m.shape)
                                       if m.shape else None)
            for m in self._mem_init]
        outputs = {"Out": self._result_vars,
                   "LastMem": self._last_mem_vars}
        attrs = {"sub_block_idx": self._block.idx,
                 "step_in_names": [sv.name for _, sv in self._inputs],
                 "mem_pre_names": [v.name for v in self._mem_pre],
                 "mem_new_names": [v.name for v in self._mem_new],
                 "out_names": [o.name for o in self._outputs]}
        _wire_nested_steps(helper, self._parent_prog,
                           [self._block.desc.idx], outputs, attrs)
        helper.append_op(
            type="dynamic_rnn",
            inputs={"X": [x for x, _ in self._inputs],
                    "MemInit": self._mem_init},
            outputs=outputs, attrs=attrs)

    def __call__(self):
        res = self._result_vars
        return res[0] if len(res) == 1 else res

    def last_memory(self, idx=0):
        """Final memory value per sequence (reference users get this via
        sequence_last_step; provided directly because the masked loop
        already has it)."""
        return self._last_mem_vars[idx]


class IfElse:
    """Row-wise conditional (reference: control_flow.py IfElse:1252).

    with ie.true_block(): ... ie.output(t)
    with ie.false_block(): ... ie.output(f)
    out = ie()   # rows where cond from true branch, else false

    Both branches run over the FULL batch and rows are merged by the
    condition (the dense form of split/merge_lod_tensor)."""

    def __init__(self, cond: Variable, name=None):
        self.helper = LayerHelper("if_else", name=name)
        self.cond = cond
        self._blocks = {}        # "true"/"false" -> block
        self._outs = {"true": [], "false": []}
        self._active = None
        self._prog = None

    class _Branch:
        def __init__(self, ie, which):
            self.ie = ie
            self.which = which

        def __enter__(self):
            prog = default_main_program()
            self.ie._prog = prog
            self.ie._blocks[self.which] = prog.create_block()
            self.ie._active = self.which
            return self.ie

        def __exit__(self, exc_type, *exc):
            self.ie._prog.rollback()
            self.ie._active = None
            if exc_type is None and "true" in self.ie._blocks \
                    and "false" in self.ie._blocks:
                self.ie._finalize()
            return False

    def true_block(self):
        return IfElse._Branch(self, "true")

    def false_block(self):
        return IfElse._Branch(self, "false")

    def input(self, x: Variable) -> Variable:
        """Reference API shim: rows are not physically split in the
        dense form, so the input is used as-is."""
        return x

    def output(self, *outs):
        if self._active is None:
            raise RuntimeError("IfElse.output() outside a branch block")
        self._outs[self._active].extend(outs)

    def _finalize(self):
        t_outs, f_outs = self._outs["true"], self._outs["false"]
        if len(t_outs) != len(f_outs):
            raise ValueError("IfElse branches must output the same "
                             f"number of vars ({len(t_outs)} vs "
                             f"{len(f_outs)})")
        helper = self.helper
        self._result_vars = [helper.create_tmp_variable(o.dtype)
                             for o in t_outs]
        outputs = {"Out": self._result_vars}
        attrs = {"true_block_idx": self._blocks["true"].idx,
                 "false_block_idx": self._blocks["false"].idx,
                 "true_out_names": [o.name for o in t_outs],
                 "false_out_names": [o.name for o in f_outs]}
        # dynamic Whiles in either branch surface their trip counts
        # (both branches EXECUTE in the dense lowering, so the op
        # reports the max over branches)
        _wire_nested_steps(helper, default_main_program(),
                           [self._blocks["true"].idx,
                            self._blocks["false"].idx],
                           outputs, attrs)
        helper.append_op(type="if_else", inputs={"Cond": self.cond},
                         outputs=outputs, attrs=attrs)

    def __call__(self):
        res = self._result_vars
        return res[0] if len(res) == 1 else res


def _wire_nested_steps(helper, prog, blk_idxs, outputs, attrs):
    """Dynamic (unbounded) Whiles nested anywhere under the blocks in
    `blk_idxs` get one parent-block int32 var each, wired as the
    enclosing op's NestedSteps outputs: the op max-accumulates every
    nested loop's per-iteration trip count into them, and the
    executor's probe-and-replay WhileGrad reads them to bake one static
    bound per nesting level (reference: while_op.cc:96 step scopes,
    which nest freely). Ordering is owned by ONE function
    (ops/control_flow_ops.union_nested_wids) shared by the layers, the
    op lowerings, and the executor's zip."""
    from ..ops.control_flow_ops import union_nested_wids
    wids = union_nested_wids(prog.desc, blk_idxs)
    if wids:
        step_vars = [
            helper.create_variable(
                name=f"{helper.name}.nested_steps.{i}", dtype="int32",
                shape=[], stop_gradient=True)
            for i in range(len(wids))]
        outputs["NestedSteps"] = [v.name for v in step_vars]
        attrs["nested_while_ids"] = wids


class While:
    """While loop over a boolean condition var (reference:
    control_flow.py:608 / while_op.cc). Loop-carried state is every var
    the body writes that exists before the loop; run as a host loop on
    the condition — or, with `max_steps`, as a bounded masked loop that
    is fully differentiable (the WhileGrad-capability path)."""

    def __init__(self, cond: Variable, name=None, max_steps=None):
        if max_steps is not None and (not isinstance(max_steps, int)
                                      or max_steps <= 0):
            raise ValueError(
                f"While max_steps must be a positive int, got "
                f"{max_steps!r}")
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.max_steps = max_steps
        self._block = None

    def block(self):
        return While._Guard(self)

    class _Guard:
        def __init__(self, w):
            self.w = w

        def __enter__(self):
            prog = default_main_program()
            self.w._prog = prog
            self.w._block = prog.create_block()
            return self.w

        def __exit__(self, *exc):
            prog = self.w._prog
            prog.rollback()
            self.w._finalize()
            return False

    def _finalize(self):
        blk = self._block
        # loop-carried state: vars written in body that exist in parent
        parent = self._prog.block(blk.desc.parent_idx)
        written = []
        for op in blk.desc.ops:
            for n in op.output_names():
                if parent.desc.find_var_recursive(n) is not None \
                        and n not in written:
                    written.append(n)
        outputs = {"Out": written}
        self.exhausted = None
        if self.max_steps:
            # True iff the condition was still true after max_steps —
            # fetch it (or set PADDLE_TPU_CHECK_WHILE_BOUND=1) to catch
            # silent truncation of the bounded lowering
            self.exhausted = self.helper.create_variable(
                name=f"{self.helper.name}.exhausted", dtype="bool",
                shape=[], stop_gradient=True)
            outputs["Exhausted"] = [self.exhausted.name]
        # iteration count — and, for an unbounded loop, the handle the
        # executor's probe-and-replay WhileGrad uses to measure a bound
        # (core/executor.py _probe_while_bounds)
        self.steps = self.helper.create_variable(
            name=f"{self.helper.name}.steps", dtype="int32",
            shape=[], stop_gradient=True)
        outputs["Steps"] = [self.steps.name]
        attrs = {"sub_block_idx": blk.idx,
                 "carried_names": written,
                 "cond_name": self.cond_var.name,
                 "max_steps": int(self.max_steps or 0),
                 "while_id": self.helper.name,
                 "dynamic_bound": self.max_steps is None}
        _wire_nested_steps(self.helper, self._prog,
                           [blk.desc.idx], outputs, attrs)
        self.helper.append_op(
            type="while", inputs={"Cond": self.cond_var},
            outputs=outputs, attrs=attrs)


class Switch:
    """Reference parity for layers.Switch (control_flow.py:1163): builds
    nested conds. Minimal host-side version for LR schedules."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.cases = []

    def case(self, condition):
        raise NotImplementedError(
            "Switch is provided via learning_rate_scheduler host-side "
            "schedules in this build")

    def default(self):
        raise NotImplementedError


def increment_shared(x, value=1.0):
    from .nn import increment
    return increment(x, value)


def create_array(dtype, capacity=None):
    """Declare an empty TensorArray for array_write (reference:
    layers/control_flow.py create_array creating a LOD_TENSOR_ARRAY
    var). The array materializes at its first write; `capacity` fixes
    the dense backing size then."""
    helper = LayerHelper("create_array")
    arr = helper.create_tmp_variable(dtype)
    arr.desc.type = "tensor_array"
    arr._is_fresh_array = True
    arr._fresh_capacity = capacity
    return arr


def array_write(x, i, array=None, capacity=None):
    """TensorArray write (reference: tensor_array_read_write_op.cc).
    Arrays are dense [capacity, ...] tensors updated at a clamped index.
    Writes back into the array var itself (reference in-place semantics)
    so a write inside a While body carries the array through the loop.
    `capacity` sizes a NEW array only — an existing array's capacity is
    fixed at creation (writes past it clamp to the last slot)."""
    helper = LayerHelper("array_write")
    inputs = {"X": x, "I": i}
    attrs = {}
    if array is not None and getattr(array, "_is_fresh_array", False):
        # declared by create_array, not yet written: this write creates
        # the backing tensor in the declared var
        attrs["capacity"] = (capacity or array._fresh_capacity or 128)
        array._is_fresh_array = False
    elif array is None:
        array = helper.create_tmp_variable(x.dtype)
        array.desc.type = "tensor_array"
        attrs["capacity"] = capacity if capacity is not None else 128
    else:
        if capacity is not None:
            raise ValueError(
                "array_write: capacity only applies when creating a new "
                "array; this array's capacity was fixed at creation")
        inputs["Array"] = array
    helper.append_op(type="array_write", inputs=inputs,
                     outputs={"Out": array}, attrs=attrs)
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(array.dtype)
    helper.append_op(type="array_read", inputs={"Array": array, "I": i},
                     outputs={"Out": out})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_tmp_variable("int64")
    helper.append_op(type="array_length", inputs={"Array": array},
                     outputs={"Out": out})
    return out


def less_than_v(x, y, cond=None):
    """cond= writes the result into an existing var — the book-test idiom
    for refreshing a While condition inside the loop body."""
    helper = LayerHelper("less_than")
    out = cond if cond is not None else helper.create_tmp_variable("bool")
    helper.append_op(type="less_than", inputs={"X": x, "Y": y},
                     outputs={"Out": out})
    return out


def cond_op(pred, true_fn, false_fn):
    """Functional cond: both branches are built as sub-blocks; the cond op
    runs the one its predicate takes (reference capability:
    conditional_block_op.cc)."""
    prog = default_main_program()
    helper = LayerHelper("cond")

    tb = prog.create_block()
    true_out = true_fn()
    prog.rollback()
    fb = prog.create_block()
    false_out = false_fn()
    prog.rollback()

    out = helper.create_tmp_variable(true_out.dtype)
    outputs = {"Out": out}
    attrs = {"true_block_idx": tb.idx,
             "false_block_idx": fb.idx,
             "true_out": true_out.name,
             "false_out": false_out.name}
    # dynamic Whiles in either branch surface their trip counts
    _wire_nested_steps(helper, prog, [tb.idx, fb.idx], outputs, attrs)
    helper.append_op(type="cond", inputs={"Pred": pred},
                     outputs=outputs, attrs=attrs)
    return out


class PipelinedStack:
    """Program-level GPipe pipeline parallelism (beyond reference parity;
    the reference's closest relative is layer-device model parallelism,
    ParallelNeuralNetwork.h:34).

    Builds ONE stage body as a sub-block; every parameter created inside
    gets a leading [n_stages] dim (one slice per stage — the stacked
    tensor is one random draw, so stages initialize independently). The
    port runs the JAX package's one-device arm: the stages in sequence
    on one device, the same math and gradients as its microbatched arm
    over a mesh's `pipe` axis, which waits for ROADMAP A11.

        pipe = PipelinedStack(n_stages=4, n_micro=8)
        with pipe.block():
            x = pipe.stage_input(h)       # [batch, d]
            y = layers.fc(x, size=d, act="relu")   # stage body, d -> d
            pipe.stage_output(y)
        out = pipe()                      # [batch, d]

    Constraint (standard GPipe): the stage body maps activations
    of one fixed shape to the same shape (transformer-block style).
    """

    def __init__(self, n_stages: int, n_micro: int = 1, axis: str = "pipe",
                 name=None):
        if n_stages < 1:
            raise ValueError(f"n_stages must be >= 1 (got {n_stages})")
        if n_micro < 1:
            raise ValueError(f"n_micro must be >= 1 (got {n_micro})")
        self.helper = LayerHelper("pipeline", name=name)
        self.n_stages = n_stages
        self.n_micro = n_micro
        self.axis = axis
        self._param_names: List[str] = []
        self._in_outer = None
        self._in_stage = None
        self._out_stage = None
        self._block = None
        self._parent_prog = None

    class _Guard:
        def __init__(self, pipe):
            self.pipe = pipe

        def __enter__(self):
            from ..layer_helper import _PARAM_STACK_CTX
            if _PARAM_STACK_CTX:
                raise NotImplementedError(
                    "nested PipelinedStack blocks are not supported — "
                    "compose stages inside one pipeline body instead")
            prog = default_main_program()
            self.pipe._parent_prog = prog
            self.pipe._block = prog.create_block()
            _PARAM_STACK_CTX.append(
                (self.pipe.n_stages, self.pipe._param_names.append))
            return self.pipe

        def __exit__(self, exc_type, *exc):
            from ..layer_helper import _PARAM_STACK_CTX
            _PARAM_STACK_CTX.pop()
            self.pipe._parent_prog.rollback()
            if exc_type is None:
                self.pipe._finalize()
            return False

    def block(self):
        return PipelinedStack._Guard(self)

    def stage_input(self, x: Variable) -> Variable:
        if self._in_outer is not None:
            raise ValueError("PipelinedStack takes exactly one stage_input")
        self._in_outer = x
        self._in_stage = self._block.create_var(
            name=f"{x.name}@stage_in",
            shape=list(x.shape) if x.shape else None, dtype=x.dtype)
        return self._in_stage

    def stage_output(self, y: Variable):
        if self._out_stage is not None:
            raise ValueError("PipelinedStack takes exactly one stage_output")
        self._out_stage = y

    def _finalize(self):
        if self._in_outer is None or self._out_stage is None:
            raise ValueError("PipelinedStack block needs stage_input() and "
                             "stage_output()")
        in_shape = self._in_stage.shape
        out_shape = self._out_stage.shape
        if in_shape and out_shape and \
                list(in_shape[1:]) != list(out_shape[1:]):
            raise ValueError(
                "PipelinedStack stage body must map activations to the "
                f"SAME shape (stage chaining): input {list(in_shape)} vs "
                f"output {list(out_shape)}")
        helper = self.helper
        parent = self._parent_prog.global_block()
        out = helper.create_tmp_variable(
            self._out_stage.dtype,
            shape=list(self._in_outer.shape) if self._in_outer.shape
            else None)
        helper.append_op(
            type="pipeline",
            inputs={"X": self._in_outer,
                    "StageParams": [parent.var(n)
                                    for n in self._param_names]},
            outputs={"Out": out},
            attrs={"sub_block_idx": self._block.idx,
                   "stage_in_name": self._in_stage.name,
                   "stage_out_name": self._out_stage.name,
                   "param_names": list(self._param_names),
                   "n_stages": self.n_stages,
                   "n_micro": self.n_micro,
                   "axis": self.axis})
        self._result = out

    def __call__(self):
        return self._result
