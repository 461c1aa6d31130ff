"""Executor: run a Program block on one torch device, compiled (the
default) or eagerly, op by op.

The JAX package traces a whole block into one jitted function, cached per
compile key. The port's form of that is a plan, built once per key
(`Executor.compile_key`: program uid and version, feed signature, fetch
list, the AMP flag, iterations, stacked_feed, donate_state), held in a
`CompiledProgram`:

- every op's compute rule (core/registry.py) resolved once, the
  constant ops' outputs materialized once (register_op(constant=True));
- each forward op paired with the ``__vjp__`` grad op whose ``fwd_op`` it
  is (core/backward.py). The step runs that forward op once, under
  autograd, with the inputs that need a gradient as detached leaves, and
  hands the rest of the block its detached outputs; the grad op pulls its
  cotangents through the recorded graph and drops it. That is what XLA's
  CSE gives the reference: no second forward. A ``__vjp__`` op whose
  forward op is not in the block as its ``fwd_op`` copy describes it (a
  ``clone(for_test=True)`` re-stamps ``is_test`` on the op, not the copy)
  replays its copy, as the eager arm does (`CompiledProgram.replayed`).
  A sub-block op (While, DynamicRNN, ...) records the same way, its
  closure values (the outer parameters its body reads) among the
  leaves;
- each value dropped from the step's environment after its last reader,
  a sub-block's reads counted at the op that runs it, except the
  fetches and the written state (autograd keeps what a recorded graph
  saved): the role of XLA's buffer assignment;
- on a CUDA card, the whole planned step captured once as a
  ``torch.cuda.CUDAGraph`` and replayed: the first run of a key runs the
  plan eagerly (it is also the warm-up: cuBLAS and cuDNN handles, kernel
  builds), the second captures and replays it, later runs replay (a
  thread that has not run the key yet warms up first: the libraries'
  handles are per thread, and a capture cannot create one). Feeds
  are copied into static input buffers; read state lives in static
  buffers the scope points at, and the captured step writes the new
  state into them (the counterpart of donation); a state tensor set into
  the scope from outside between runs is copied in before the replay;
  fetches are copied out of the graph's outputs. The kernel wrappers'
  launch counts the capture added are credited on every replay. A
  program holding an op, in any block, that cannot be captured (a
  random op seeding a host generator; cond, which reads its predicate
  on the host; a While with no bound) is compiled but never captured:
  `CompiledProgram.uncaptured_ops` names those ops. A capture or replay
  error raises; nothing is rerouted.

`Executor(compiled=False)` is the eager walk: every op's compute rule in
order under torch.no_grad(), each ``__vjp__`` grad op replaying its
forward op under autograd by itself, every value kept until the run ends.
Read-write persistable state (the KV caches of the generation programs)
is updated IN PLACE by its ops on both paths; with
``donate_state=False`` the compiled path updates copies, and the tensors
a caller held before a run are left as they were.

The analysis layer (analysis/) runs as in the JAX executor. Every run
first passes the pre-compile gate (``executor_gate``: def-use, the
build-time shape markers, dead code, donation hazards; memoized per
program version; PADDLE_TPU_VERIFY=0 skips it). Both executors then run
the rewrite pipeline's output (``rewrite_program``: folding, CSE, dead
ops and gradients, attention and SE outlining, the kernel-dispatch
stamps, buffer reuse; PADDLE_TPU_OPTIMIZE=0 runs the program as built),
cached per program version, feed and fetch names and knob values; a
pipeline that raises falls back to the program as built. Per compile
key, the static memory plan of the program that runs is held against
the device's memory (``hbm_budget_bytes``: a VerificationError before
anything runs when it does not fit) and the cost model priced:
``CompiledProgram.rewrite/.memory/.cost``, ``Executor.last_cost``,
``last_memory`` and ``cost_table()``. Buffer reuse gives one name
several values: the plan pairs a ``__vjp__`` op with its forward op
through the names its FwdIn reads, and releases each value at its last
reader before the next write of its name.

The step counter lives in the scope, as in the JAX package: ``STEP_VAR``
holds a 0-d int32 tensor on the host (it seeds host-side generators, so
reading it never waits for the card). ``run`` reads it, hands each op
``step + i`` on iteration i, and stores ``step + iterations``; so a
second executor on the same scope, ``Trainer.test`` and a checkpoint
resume all continue one count. ``run(..., iterations=K)`` runs the block
K times (K replays once captured), state chained from one run to the
next; ``sync=False`` returns a ``StepResult`` whose fetches convert to
the host only when read.

Feeds and fetches may be ragged at any LoD depth: a LoDTensor feed with
one, two or more LoD levels runs as a RaggedPair, RaggedNested or
RaggedTree (core/lod.py), and a ragged fetch comes back as a LoDTensor
with its LoD.

Control flow (ops/control_flow_ops.py): every op gets the program in
``extra["program"]``, and a sub-block runs through the same op runner.
The probe-and-replay WhileGrad is the JAX package's: when a ``__vjp__``
op differentiates an unbounded While (directly or nested in a replayed
While, DynamicRNN, StaticRNN, cond or IfElse), both executors first run
the forward prefix up to the last such op once, with its state writes
discarded (`_probe_while_bounds`), read each trip count and bucket it to
a power of two; the step then runs with those bounds in
``extra["while_bounds"]`` (the masked-loop route of each While), and the
bounds are part of the compile key. The probe runs before the key's
graph replays, outside it. A bounded While's Exhausted flag is fetched
with every run of its block and checked one run later (a warning, once
per program and flag), or at once under PADDLE_TPU_CHECK_WHILE_BOUND=1
(an error); `close()` and interpreter exit check the last ones.

"""
from __future__ import annotations

import atexit
import threading
import warnings
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import flags
from ..amp import amp_enabled
from .ir import BlockDesc, OpDesc, Program, SUB_BLOCK_ATTRS
from .lod import (RAGGED_TYPES, LoDTensor, RaggedNested, RaggedPair,
                  RaggedTree, ragged_like, ragged_parts, with_data)
from .registry import OpRegistry, op_capturable, run_op
from .scope import Scope, global_scope

STEP_VAR = "@step_counter@"

# the knobs the rewrite pipeline reads: a change gives another rewrite
_REWRITE_KNOBS = ("PADDLE_TPU_OPTIMIZE", "PADDLE_TPU_INPLACE_REUSE",
                  "PADDLE_TPU_PALLAS_LSTM", "PADDLE_TPU_PALLAS_GRU",
                  "PADDLE_TPU_PALLAS_SDPA")

# A bounded While that hit max_steps with its condition still true warns
# once per (program, flag) by default; PADDLE_TPU_CHECK_WHILE_BOUND=1
# raises instead (read at import, as in the JAX package).
CHECK_WHILE_BOUND = flags.get("PADDLE_TPU_CHECK_WHILE_BOUND") == "1"
_WARNED_WHILE_FLAGS: set = set()


def _check_while_flag(key, value, raise_: bool):
    """key = (program uid, flag var name); value = the fetched bool."""
    if not bool(np.asarray(to_numpy(value)
                           if isinstance(value, torch.Tensor)
                           else value).reshape(-1)[0]):
        return
    msg = (f"bounded While loop flag {key[1]!r}: the loop hit max_steps "
           "with its condition still true — it was truncated; raise "
           "max_steps")
    if raise_:
        raise RuntimeError(msg)
    if key not in _WARNED_WHILE_FLAGS:
        _WARNED_WHILE_FLAGS.add(key)
        warnings.warn(msg, RuntimeWarning, stacklevel=4)


def donate_state_default() -> bool:
    """Executor(donate_state=None)'s value: PADDLE_TPU_DONATE_STATE, on
    unless "0" (paddle_tpu/core/executor.py DONATE_STATE_DEFAULT)."""
    return flags.get("PADDLE_TPU_DONATE_STATE") != "0"


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


def _lod_value(value: LoDTensor):
    """A LoDTensor in its padded in-graph form, on the host: a RaggedPair
    (one LoD level), RaggedNested (two) or RaggedTree (three or more) of
    numpy arrays (paddle_tpu/core/executor.py _to_device_value), or its
    dense data when it has no LoD."""
    if len(value.lod) > 2:
        data, lengths = value.to_tree_padded()
        return RaggedTree(data, lengths)
    if len(value.lod) == 2:
        return RaggedNested(*value.to_nested_padded())
    if value.lod:
        return RaggedPair(*value.to_padded())
    return value.data


def _ragged_on(value, put):
    """The ragged value `value` with `put` applied to each of its
    tensors, the lengths as int32."""
    data, *lengths = ragged_parts(value)
    return ragged_like(value, [put(data)]
                       + [put(l).to(torch.int32) for l in lengths])


def to_device_value(value, device: torch.device):
    """A feed value in its in-graph form on `device`: a LoDTensor becomes
    a RaggedPair, RaggedNested or RaggedTree of the padded data and int32
    lengths by its number of LoD levels, and a ragged value of arrays
    goes up as it is (paddle_tpu/core/executor.py _to_device_value);
    anything else goes through to_tensor."""
    if isinstance(value, LoDTensor):
        value = _lod_value(value)
    if isinstance(value, RAGGED_TYPES):
        return _ragged_on(value, lambda t: to_tensor(t, device))
    return to_tensor(value, device)


class DeviceFeed(dict):
    """A feed dict already in device form (`device_feed`). On the card
    `ready` is the event recorded after its uploads on a side stream:
    `Executor.run` makes its own stream wait on it before the first op
    reads a value. None on the CPU."""

    ready = None


# the side stream feed uploads run on, one per card, made on first use
_UPLOAD_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def pinned_upload(value, device: torch.device) -> torch.Tensor:
    """A host array or tensor on the card `device`, copied into pinned
    memory and from there with a non-blocking copy on the current
    stream. A tensor already on `device` passes through."""
    if isinstance(value, torch.Tensor):
        if value.device == device:
            return value
        host = value
    else:
        host = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    return host.pin_memory().to(device, non_blocking=True)


def upload_on_side_stream(make, device: torch.device):
    """Run `make()`, which issues `pinned_upload` copies, on the card's
    upload side stream; returns its result and an event recorded after
    the copies. The consumer hands both to `await_upload`."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _UPLOAD_STREAMS.get(index)
    if stream is None:
        stream = _UPLOAD_STREAMS.setdefault(
            index, torch.cuda.Stream(torch.device("cuda", index)))
    with torch.cuda.stream(stream):
        out = make()
        ready = torch.cuda.Event()
        ready.record(stream)
    return out, ready


def await_upload(ready, tensors, device: torch.device) -> None:
    """The consumer's half of an upload: the current stream waits on
    `ready` (the host does not), and each tensor is marked in use there,
    so the caching allocator does not give its memory back to the side
    stream while a later kernel still reads it."""
    stream = torch.cuda.current_stream(device)
    stream.wait_event(ready)
    for t in tensors:
        t.record_stream(stream)


def device_feed(feed: Dict[str, Any], device=None) -> DeviceFeed:
    """Upload a host feed dict to its in-graph device form (idempotent:
    values already on the device pass through). The shared convert and
    upload step behind DataFeeder.feed_device and the Trainer's feed
    prefetch, which runs it on its producer thread.

    On the card each host array goes up through `pinned_upload` on the
    card's upload side stream, so the upload can overlap the step in
    flight on the compute stream; the returned dict's `ready` event
    marks the end of its copies. (A plain copy from pageable memory
    would queue behind the step's kernels on the shared default
    stream.)"""
    device = resolve_device(device)
    if device.type != "cuda":
        return DeviceFeed((k, to_device_value(v, device))
                          for k, v in feed.items())

    def make():
        out = DeviceFeed()
        for k, v in feed.items():
            if isinstance(v, LoDTensor):
                v = _lod_value(v)
            if isinstance(v, RAGGED_TYPES):
                out[k] = _ragged_on(v, lambda t: pinned_upload(t, device))
            else:
                out[k] = pinned_upload(v, device)
        return out

    out, ready = upload_on_side_stream(make, device)
    out.ready = ready
    return out


def to_host_value(value, return_numpy: bool = True):
    """A fetched value on the host: a ragged value comes back as a
    LoDTensor of its valid rows with its LoD (one, two or depth levels),
    anything else as a numpy array (as the tensor itself with
    return_numpy=False)."""
    if isinstance(value, RAGGED_TYPES):
        data, *lengths = ragged_parts(value)
        data = to_numpy(data)
        lengths = [l.cpu().numpy() for l in lengths]
        if isinstance(value, RaggedPair):
            return LoDTensor.from_padded(data, *lengths)
        if isinstance(value, RaggedNested):
            return LoDTensor.from_nested_padded(data, *lengths)
        return LoDTensor.from_tree_padded(data, lengths)
    return to_numpy(value) if return_numpy else value


def to_numpy(value) -> np.ndarray:
    """Tensor -> numpy at the fetch boundary (bf16 widened to f32:
    numpy has no bfloat16)."""
    t = value.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _abstractify(value):
    if isinstance(value, RaggedPair):
        return ("ragged", tuple(value.data.shape), _dtype_name(value.data),
                tuple(value.lengths.shape))
    if isinstance(value, RaggedNested):
        return ("ragged2", tuple(value.data.shape), _dtype_name(value.data),
                tuple(value.tok_lengths.shape))
    if isinstance(value, RaggedTree):
        return ("raggedk", value.depth, tuple(value.data.shape),
                _dtype_name(value.data))
    return (tuple(value.shape), _dtype_name(value))


def _dtype_name(value) -> str:
    return str(value.dtype).replace("torch.", "")


def feed_signature(feed_vals) -> Tuple:
    """Hashable (name, abstract shape/dtype) signature of a feed dict —
    the per-request part of the executor's compile key. Feed values must
    already be in device form (`to_device_value`). A RaggedPair is
    ("ragged", data shape, dtype, lengths shape), a RaggedNested
    ("ragged2", data shape, dtype, tok_lengths shape) and a RaggedTree
    ("raggedk", depth, data shape, dtype), as in the reference; numpy
    arrays and anything else with .shape/.dtype work too."""
    return tuple(sorted((k, _abstractify(v)) for k, v in feed_vals.items()))


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


class _BlockPrefix:
    """A view of a block truncated to its first `n` ops (the WhileGrad
    probe runs only the forward prefix up to the last dynamic While)."""

    def __init__(self, block: BlockDesc, n: int):
        self._block = block
        self.ops = list(block.ops[:n])

    def __getattr__(self, name):
        return getattr(self._block, name)


def _dynamic_while_targets(block: BlockDesc):
    """{while_id: steps_var_name} for every unbounded While a ``__vjp__``
    op replays — directly, or NESTED inside a replayed While /
    DynamicRNN / StaticRNN / cond / IfElse (their ops max-accumulate
    nested trip counts into NestedSteps outputs) — plus the index one
    past the last such forward op, the probe prefix length
    (paddle_tpu/core/executor.py _dynamic_while_targets)."""
    def op_key(t, attrs):
        if t == "while":
            return ("while", attrs.get("while_id"))
        if t in ("dynamic_rnn", "static_rnn"):
            return (t, attrs.get("sub_block_idx"))
        if t in ("cond", "if_else"):
            return (t, attrs.get("true_block_idx"),
                    attrs.get("false_block_idx"))
        return None

    grad_keys = set()
    for op in block.ops:
        if op.type != "__vjp__":
            continue
        fwd = op.attrs.get("fwd_op") or {}
        key = op_key(fwd.get("type"), fwd.get("attrs") or {})
        if key is not None:
            grad_keys.add(key)
    if not grad_keys:
        return {}, 0
    targets, prefix = {}, 0
    for i, op in enumerate(block.ops):
        key = op_key(op.type, op.attrs)
        if key is None or key not in grad_keys:
            continue
        found = False
        if op.type == "while" and op.attrs.get("dynamic_bound") and \
                int(op.attrs.get("max_steps", 0) or 0) <= 0:
            steps = op.outputs.get("Steps")
            if not steps:
                raise RuntimeError(
                    f"dynamic While {op.attrs.get('while_id')!r} has no "
                    "Steps output — rebuild the program with the "
                    "current While layer")
            targets[op.attrs["while_id"]] = steps[0]
            found = True
        nested = op.attrs.get("nested_while_ids") or []
        if nested:
            ns_vars = op.outputs.get("NestedSteps") or []
            if len(ns_vars) != len(nested):
                raise RuntimeError(
                    f"{op.type} op has nested dynamic Whiles {nested} "
                    "but no matching NestedSteps outputs — rebuild the "
                    "program with the current control-flow layers")
            targets.update(zip(nested, ns_vars))
            found = True
        if found:
            prefix = i + 1
    return targets, prefix


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def _sub_blocks(program: Program, op: OpDesc) -> List[BlockDesc]:
    return [program.blocks[op.attrs[a]] for a in SUB_BLOCK_ATTRS
            if isinstance(op.attrs.get(a), int)
            and 0 <= op.attrs[a] < len(program.blocks)]


def _stateful_ops_in(program: Program, ops) -> List[str]:
    """Op types registered stateful (host-side effects: the channel ops,
    go) reachable from `ops`, sub-blocks included. The WhileGrad probe
    re-runs its forward prefix, so a stateful op there would fire twice
    a step — refused rather than silently doubled."""
    found: List[str] = []

    def visit(op_list):
        for op in op_list:
            if OpRegistry.has(op.type) and OpRegistry.get(op.type).stateful:
                found.append(op.type)
            for blk in _sub_blocks(program, op):
                visit(blk.ops)

    visit(ops)
    return found


def _uncaptured_ops(program: Program, ops, while_bounds) -> Tuple[str, ...]:
    """Sorted op types among `ops`, their sub-blocks and the forward ops
    their ``__vjp__`` ops replay, that cannot be captured into a CUDA
    graph under `while_bounds` (registry.op_capturable)."""
    found = set()

    def visit(op_list):
        for op in op_list:
            if op.type == "__vjp__":
                op = OpDesc.from_dict(op.attrs["fwd_op"])
            if not op_capturable(op, while_bounds):
                found.add(op.type)
            for blk in _sub_blocks(program, op):
                visit(blk.ops)

    visit(ops)
    return tuple(sorted(found))


def _outer_reads(program: Program, op: OpDesc) -> List[str]:
    """Names a sub-block op reads from the environment around it beyond
    its own inputs: every name its sub-blocks (at any depth) read before
    writing it, and a While's carried names. The plan keeps them alive
    until the op has run."""
    out: List[str] = list(op.attrs.get("carried_names") or [])

    def visit(blk: BlockDesc):
        local = set(blk.vars)
        for sub in blk.ops:
            out.extend(n for n in sub.input_names() if n not in local)
            for b in _sub_blocks(program, sub):
                visit(b)
            local.update(sub.output_names())

    for blk in _sub_blocks(program, op):
        visit(blk)
    return out


# Bounded-While truncation flags are checked one run later (so the
# warning never waits for the step in flight); the ones left at
# interpreter exit are checked then, so a truncation on the process's
# last run still warns without Executor.close().
_LIVE_EXECUTORS: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _flush_deferred_while_flags():
    for ex in list(_LIVE_EXECUTORS):
        ex._flush_while_flags()


class StepResult:
    """Undelivered fetches of an asynchronous ``Executor.run(...,
    sync=False)``.

    Holds the dispatched step's tensors; nothing waits until a fetched
    value is read. On the card, `event` is recorded on the compute stream
    after the dispatch: `ready` queries it and `block_until_ready()`
    waits for it without converting. `fetches()` (and indexing and
    iteration) converts to the host once, then drops the device
    references so the buffers are not held for the result's lifetime.
    On the CPU the ops ran before `run` returned, and `ready` is always
    True. `cost` is the static ProgramCost of THIS dispatch (a later
    run moves the executor's `last_cost`, this one stays)."""

    def __init__(self, raw_fetches, fetch_names, return_numpy: bool,
                 event=None, cost=None):
        self._raw = list(raw_fetches)
        self.fetch_names = list(fetch_names)
        self._return_numpy = return_numpy
        self._event = event
        self.cost = cost
        self._values: Optional[List[Any]] = None

    @property
    def ready(self) -> bool:
        """True once the dispatched step has finished on the device
        (always True after materialization and on the CPU)."""
        return self._values is not None or self._event is None \
            or self._event.query()

    def block_until_ready(self) -> "StepResult":
        """Wait for the device computation; does NOT convert to host."""
        if self._values is None and self._event is not None:
            self._event.synchronize()
        return self

    def fetches(self) -> List[Any]:
        """Materialized fetch values (cached after the first call)."""
        if self._values is None:
            self._values = [to_host_value(v, self._return_numpy)
                            for v in self._raw]
            self._raw = []  # release device references
            self._event = None
        return list(self._values)

    def __len__(self):
        return len(self.fetch_names)

    def __getitem__(self, i):
        return self.fetches()[i]

    def __iter__(self):
        return iter(self.fetches())


def _detached(value):
    if isinstance(value, RAGGED_TYPES):
        return with_data(value, value.data.detach())
    return value.detach() if isinstance(value, torch.Tensor) else value


def _clone(value):
    """A copy of a tensor or a ragged value: its data and every lengths
    tensor (a captured step's static feed holds them all)."""
    return ragged_like(value, [t.clone() for t in ragged_parts(value)])


def _copy_into(static, value, what: str) -> None:
    """static.copy_(value), for a tensor or a ragged value (its data and
    every lengths tensor), after checking that the two agree in shape
    and dtype."""
    for dst, src in zip(ragged_parts(static), ragged_parts(value)):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(
                f"{what}: a {src.dtype} {tuple(src.shape)} tensor cannot "
                f"take the place of the captured step's {dst.dtype} "
                f"{tuple(dst.shape)} buffer")
        dst.copy_(src)


def _flat(slots: Dict[str, List[str]]) -> List[str]:
    return [n for names in slots.values() for n in names]


def _is_forward_of(op: OpDesc, fwd: Dict[str, Any], fwd_in: List[str]
                   ) -> bool:
    """True when `op` is the op the ``fwd_op`` dict `fwd` of a
    ``__vjp__`` op (whose FwdIn names are `fwd_in`) was copied from: the
    same type, attrs and slot layout, and each input name the one the
    ``__vjp__`` op reads in its place. The rewrite pipeline's buffer reuse
    renames an op's inputs and outputs and the ``__vjp__`` op's FwdIn
    alike but not the ``fwd_op`` copy, so names are held against FwdIn,
    not against the copy; an input the op also writes (read by the
    ``__vjp__`` op through its ``@PRE.`` snapshot) keeps its own name."""
    if op.type != fwd.get("type"):
        return False
    try:
        if op.attrs != fwd.get("attrs", {}):
            return False
    except (TypeError, ValueError):  # attrs that do not compare as bools
        return False
    for mine, theirs in ((op.inputs, fwd["inputs"]),
                         (op.outputs, fwd["outputs"])):
        if list(mine) != list(theirs) or any(
                len(mine[k]) != len(theirs[k]) for k in mine):
            return False
    mutated = set(_flat(fwd["outputs"]))
    for mine, orig, read in zip(op.input_names(), _flat(fwd["inputs"]),
                                fwd_in):
        if mine != (orig if orig in mutated else read):
            return False
    return True


# the kinds of a plan step
_RUN, _CONST, _RECORD, _VJP = range(4)


class _Plan:
    """What one compile key runs: each op of the block with its kind
    (plain, constant, forward recorded for a ``__vjp__`` op, ``__vjp__``
    reading that record), and the names dropped after it."""

    def __init__(self, program: Program, block: BlockDesc, keep,
                 while_bounds=None):
        ops = list(block.ops)
        # __vjp__ op index -> (forward index, the record's names of its
        # cotangent outputs)
        fwd_of: Dict[int, Tuple[int, List[str]]] = {}
        # forward index -> (in_need_grad, the __vjp__'s closure names)
        need: Dict[int, Tuple[List[bool], List[str]]] = {}
        by_type: Dict[str, List[int]] = {}   # op type -> op indices
        producer: Dict[str, int] = {}
        self.replayed: List[int] = []
        for j, op in enumerate(ops):
            if op.type != "__vjp__":
                by_type.setdefault(op.type, []).append(j)
                producer.update((n, j) for n in op.output_names())
                continue
            fwd = op.attrs["fwd_op"]
            fwd_in = op.input("FwdIn")
            cands = [i for i in by_type.get(fwd["type"], ())
                     if _is_forward_of(ops[i], fwd, fwd_in)]
            # the op that wrote exactly the copy's outputs, where one did
            # (no buffer reuse renamed them)
            cands = [i for i in cands if ops[i].outputs == fwd["outputs"]] \
                or cands
            # an op that writes its own input (a While carry, an in-place
            # array_write or increment) is the first such op after the
            # assign that snapshotted its pre-op value (backward.py
            # _snapshot_pre_value): FwdIn reads the snapshot at each
            # position whose name the op also writes; otherwise the
            # latest candidate
            mutated = set(_flat(fwd["outputs"]))
            snaps = [producer[n] for n, orig in
                     zip(fwd_in, _flat(fwd["inputs"]))
                     if orig in mutated and n in producer]
            cands = [i for i in cands if i > max(snaps)][:1] if snaps \
                else cands[-1:]
            flags_ = (list(op.attrs["in_need_grad"]),
                      list(op.attrs.get("closure_names") or []))
            if cands and need.setdefault(cands[0], flags_) == flags_:
                # the record's names of the cotangent outputs
                # (ops/core_ops.py vjp_out_names, through the renaming)
                outs = zip(ops[cands[0]].output_names(),
                           op.attrs["out_has_grad"])
                fwd_of[j] = (cands[0], [n for n, h in outs if h])
            else:
                self.replayed.append(j)
        # the last __vjp__ op reading a record drops it
        last_vjp = {i: j for j, (i, _) in fwd_of.items()}
        self.steps: List[Tuple[OpDesc, int, Any]] = []
        self.drops: List[List[str]] = [[] for _ in ops]
        last: Dict[str, int] = {}
        for j, op in enumerate(ops):
            opdef = OpRegistry.get(op.type)
            if j in fwd_of:
                i, out_names = fwd_of[j]
                kind, arg = _VJP, (i, last_vjp[i] == j, out_names)
                reads = op.input("OutGrad")
            else:
                if j in need:
                    kind, arg = _RECORD, need[j]
                else:
                    kind = _CONST if opdef.constant and not any(
                        n in keep for n in op.output_names()) else _RUN
                    arg = None
                fwd = OpDesc.from_dict(op.attrs["fwd_op"]) \
                    if op.type == "__vjp__" else op
                reads = op.input_names() + _outer_reads(program, fwd)
            self.steps.append((op, kind, arg))
            for n in reads:
                last[n] = j
            for n in op.output_names():
                # a write that does not read the name starts a new value
                # under it (buffer reuse gives one name several): the
                # value before dies at its last reader
                prev = last.get(n)
                if prev is not None and prev < j and n not in keep and \
                        n not in reads:
                    self.drops[prev].append(n)
                last[n] = j
        for n, j in last.items():
            if n not in keep:
                self.drops[j].append(n)
        self.uncaptured_ops = _uncaptured_ops(program, ops, while_bounds)


class CompiledProgram:
    """The compiled form of (program, feed signature, fetch list): the
    state names, the plan (`_Plan`) and, once a card has captured it, the
    CUDA graph with its static buffers.

    `captured` is True once the step has been captured; it stays False on
    the CPU and for a program holding an op in `uncaptured_ops` (the op
    types, in any block, that cannot be captured under the key's While
    bounds). `replayed` lists the ``__vjp__`` op types that replay their
    forward op instead of reading its record."""

    def __init__(self, plan: _Plan, program: Program, read_names,
                 write_names, fetch_names, ro_names=(), rw_names=(),
                 while_bounds=None):
        self.plan = plan
        # the program this key runs: the rewrite pipeline's output, or
        # the program as built (PADDLE_TPU_OPTIMIZE=0, or a failed rewrite)
        self.program = program
        # the analysis reports of this key (analysis/): the rewrite
        # pipeline's RewriteResult (None when it did not run or raised),
        # the static MemoryReport and ProgramCost of `program` at this
        # key's feed shapes
        self.rewrite = None
        self.memory = None
        self.cost = None
        # the probed While bounds of this key ({while_id: bound}) or None
        self.while_bounds = while_bounds
        self.read_names = list(read_names)
        self.write_names = list(write_names)
        self.fetch_names = list(fetch_names)
        self.ro_names = list(ro_names)
        self.rw_names = list(rw_names)
        self.uncaptured_ops = plan.uncaptured_ops
        self.replayed = [plan.steps[j][0].attrs["fwd_op"]["type"]
                         for j in plan.replayed]
        self.captured = False
        # the threads that have run the planned step of this key: cuBLAS
        # and cuDNN create their handles per thread on first use, which a
        # capture refuses, so a thread captures only a key it warmed up
        self.warm_threads = set()
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.static_feed: Dict[str, Any] = {}
        self.static_state: Dict[str, torch.Tensor] = {}
        # state name -> its tensor after a replay; the fetches' tensors
        self.static_writes: Dict[str, Any] = {}
        self.static_fetches: List[Any] = []
        # kernel launches one replay makes ({wrapper name: count})
        self.launches: Dict[str, int] = {}


class Executor:
    """Runs Programs on one device. `place` defaults to the first CUDA
    card and raises without one; pass "cpu" (or CPUPlace()) to run on
    the CPU. `compiled=False` runs the eager walk instead of the compiled
    plan; `donate_state=None` reads PADDLE_TPU_DONATE_STATE (on unless
    "0")."""

    def __init__(self, place=None, donate_state: Optional[bool] = None,
                 compiled: bool = True):
        self.place = place
        self.device = resolve_device(place)
        self.compiled = bool(compiled)
        self.donate_state = donate_state_default() if donate_state is None \
            else bool(donate_state)
        # The JAX reference computes in full float32; TF32 keeps about
        # three decimal digits, so it is switched off for matmuls and
        # convolutions alike.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # outputs of constant ops (register_op(constant=True)), keyed by
        # (program uid, version, op index): the position table's
        # assign_value alone is a list of max_seq_len * d_model floats
        self._const_cache: Dict[Tuple, Dict[str, torch.Tensor]] = {}
        # (program uid, version, feed names, fetch names, knob values,
        # donate_state) -> (the program the run executes, its
        # RewriteResult): the rewrite pipeline runs once per entry
        self._rewrites: Dict[Tuple, Tuple[Program, Any]] = {}
        # the eager walk's (program run, MemoryReport, ProgramCost) per
        # compile key (the compiled path keeps them on CompiledProgram)
        self._eager_reports: Dict[Tuple, Tuple[Program, Any, Any]] = {}
        # the static ProgramCost and MemoryReport of the most recent run
        # (analysis/cost_model.py, analysis/memory.py)
        self.last_cost = None
        self.last_memory = None
        # the event recorded after the last dispatch on the card, until
        # synchronize() has waited for it
        self._inflight: Optional[torch.cuda.Event] = None
        # compile key -> CompiledProgram; the hits and misses of its
        # lookups (a miss plans a new key), as the reference counts them
        self._cache: Dict[Tuple, CompiledProgram] = {}
        self.cache_stats: Dict[str, int] = {"hits": 0, "misses": 0}
        # the CompiledProgram of the most recent compiled run
        self.last_compiled: Optional[CompiledProgram] = None
        # (program uid, version, prefix length) -> the state the WhileGrad
        # probe reads, and the part of it the prefix writes
        self._probe_cache: Dict[Tuple, Tuple[List[str], List[str]]] = {}
        # (program uid, version) -> the stateful op types of the block
        self._stateful_cache: Dict[Tuple, List[str]] = {}
        # bounded-While Exhausted flags of earlier runs, not checked yet:
        # ((program uid, flag name), value, the event after its run)
        self._deferred_flags: List[Tuple[Tuple, Any, Any]] = []
        _LIVE_EXECUTORS.add(self)

    @staticmethod
    def compile_key(program, feed_sig, fetch_names, block_idx: int = 0,
                    while_bounds=None, iterations: int = 1,
                    stacked_feed: bool = False, amp=None,
                    donate=None) -> Tuple:
        """The compile-cache key of one (program, feed signature, fetch
        list) combination, in the reference's field layout
        (paddle_tpu/core/executor.py Executor.compile_key). `feed_sig`
        comes from `feed_signature`; `amp=None` reads the ambient AMP
        state (amp.py), as run() does, so a run under amp_guard and one
        outside it are two keys. `while_bounds` is the WhileGrad probe's
        {while_id: bound} (None without one): each trip-count bucket is a
        key of its own. `donate=None` reads the process default."""
        if hasattr(program, "desc"):
            program = program.desc
        return (program.uid, program.version, feed_sig,
                tuple(fetch_names), block_idx,
                amp_enabled() if amp is None else bool(amp),
                tuple(sorted(while_bounds.items())) if while_bounds
                else None, iterations, stacked_feed,
                donate_state_default() if donate is None else bool(donate))

    def _rewritten(self, program: Program, feed_names,
                   fetch_names) -> Tuple[Program, Any]:
        """(the program a run of `program` executes, its RewriteResult):
        the rewrite pipeline's output (analysis/rewrite.py) under
        PADDLE_TPU_OPTIMIZE, else `program` itself and None. Cached per
        program version, feed and fetch names and knob values; the
        caller's program is never changed. A pipeline that raises falls
        back to the program as built, as the JAX executor's does. Its
        passes are verified as for a synchronous run: the one verdict
        an asynchronous run changes, a fetch of donated state, is the
        gate's error before the rewrite."""
        from ..analysis import rewrite as _rewrite
        knob = tuple(flags.get(k) for k in _REWRITE_KNOBS)
        key = (program.uid, program.version, tuple(sorted(feed_names)),
               tuple(fetch_names), knob, self.donate_state)
        hit = self._rewrites.get(key)
        if hit is None:
            result = None
            if _rewrite.optimize_enabled():
                try:
                    result = _rewrite.rewrite_program(
                        program, 0, feed_names=list(feed_names),
                        fetch_names=list(fetch_names),
                        donate=self.donate_state,
                        label=f"program uid={program.uid} block=0")
                except Exception:  # noqa: BLE001 — run the program as built
                    result = None
            exec_program = result.program if result is not None \
                and result.changed else program
            hit = self._rewrites[key] = (exec_program, result)
        return hit

    def _reports(self, source: Program, program: Program, feed_vals,
                 stacked_feed: bool):
        """(MemoryReport, ProgramCost) of `program`, the program a run
        executes, at this run's feed shapes (a stacked feed's leading
        axis stripped: both are per step). The memory gate: when
        verification is on and the static peak exceeds the device budget
        (analysis/memory.py hbm_budget_bytes), a VerificationError before
        anything runs. The reports themselves are best effort."""
        from ..analysis import cost_model as _cost_model
        from ..analysis import memory as _memory
        from ..analysis import verifier as _verifier
        fs = {}
        for k, v in feed_vals.items():
            shp = getattr(v, "shape", None)
            if isinstance(shp, tuple):
                fs[k] = tuple(shp)[1:] if stacked_feed else tuple(shp)
        label = f"program uid={source.uid} block=0"
        try:
            mem = _memory.program_memory(program, 0, feed_shapes=fs,
                                         feed_names=feed_vals.keys(),
                                         label=label)
        except Exception:  # noqa: BLE001 — the plan never fails a run
            mem = None
        if mem is not None and _verifier.verify_enabled():
            budget = _memory.hbm_budget_bytes(self.device)
            if budget > 0 and mem.peak_bytes > budget:
                _memory.check_budget(mem, budget).raise_if_errors(
                    context="pre-compile memory gate")
        try:
            cost = _cost_model.program_cost(program, 0, feed_shapes=fs)
        except Exception:  # noqa: BLE001 — the cost never fails a run
            cost = None
        return mem, cost

    def cost_for(self, program):
        """The static ProgramCost of a compiled key of `program` (any
        feed signature) at its current version, or None when this
        executor compiled none yet."""
        desc = program.desc if hasattr(program, "desc") else program
        for k, compiled in list(self._cache.items()):
            if k[0] == desc.uid and k[1] == desc.version \
                    and compiled.cost is not None:
                return compiled.cost
        for k, (_prog, _mem, cost) in list(self._eager_reports.items()):
            if k[0] == desc.uid and k[1] == desc.version \
                    and cost is not None:
                return cost
        return None

    def cost_table(self, program=None, limit: int = 20) -> Optional[str]:
        """The rendered per-op cost table of `program` (default: the
        most recent run's)."""
        cost = self.cost_for(program) if program is not None \
            else self.last_cost
        return None if cost is None else cost.table(limit=limit)

    def _feed_values(self, feed) -> Dict[str, Any]:
        """The feed in device form; a `device_feed` upload is awaited on
        the current stream first."""
        if isinstance(feed, DeviceFeed):
            feed_vals = dict(feed)
            if feed.ready is not None:
                await_upload(feed.ready, [t for v in feed_vals.values()
                                          for t in ragged_parts(v)],
                             self.device)
            return feed_vals
        return {k: to_device_value(v, self.device) for k, v in feed.items()}

    @staticmethod
    def _check_iterations(feed_vals, iterations: int,
                          stacked_feed: bool) -> None:
        if stacked_feed:
            if iterations == 1:
                raise ValueError("stacked_feed requires iterations > 1")
            for k, v in feed_vals.items():
                if not isinstance(v, torch.Tensor):
                    raise ValueError(
                        f"stacked_feed: feed {k!r} is not an array "
                        "(ragged/LoDTensor feeds cannot be stacked — "
                        "their padded length may differ per batch)")
                if tuple(v.shape[:1]) != (iterations,):
                    raise ValueError(
                        f"stacked_feed: feed {k!r} leading dim "
                        f"{tuple(v.shape[:1])} != iterations {iterations}")
        if iterations < 1:
            raise ValueError(
                f"iterations must be >= 1, got {iterations}: a "
                "zero-length scan would return zero-initialized "
                "fetches without running anything")

    def _probe_while_bounds(self, program: Program, feed_vals, scope: Scope,
                            step: int):
        """Probe-and-replay WhileGrad, phase 1 (reference analog:
        while_op.cc:96 step scopes, which RECORD per-step state; here,
        as in the JAX package, the forward prefix up to the last
        differentiated dynamic While RE-RUNS to measure each trip count,
        and the step then runs with the bucketed bounds as masked loops).
        The prefix's state writes are discarded (an op that writes in
        place writes a copy). Returns {while_id: bound} or None."""
        block = program.global_block
        targets, prefix = _dynamic_while_targets(block)
        if not targets:
            return None
        stateful = _stateful_ops_in(program, block.ops[:prefix])
        if stateful:
            raise RuntimeError(
                "cannot differentiate an unbounded While in a program "
                f"whose forward prefix has stateful ops {sorted(set(stateful))}: "
                "the trip-count probe re-executes that prefix, which "
                "would fire each channel/select/go op twice per step. "
                "Give the While an explicit max_steps, or move the CSP "
                "ops after the last dynamic While.")
        pkey = (program.uid, program.version, prefix)
        names = self._probe_cache.get(pkey)
        if names is None:
            reads, writes = _collect_state_names(
                program, _BlockPrefix(block, prefix), scope)
            names = (reads, [n for n in reads if n in set(writes)])
            self._probe_cache[pkey] = names
        reads, rw = names
        env = {n: scope.get(n) for n in reads}
        env.update((n, _clone(env[n])) for n in rw)
        env.update(feed_vals)
        extra = {"device": self.device, "step": step, "program": program}
        with torch.no_grad():
            for op in block.ops[:prefix]:
                env.update(run_op(op, env, extra))
        return {wid: _next_pow2(int(env[n].reshape(-1)[0]))
                for wid, n in targets.items()}

    def _prepare(self, source: Program, program: Program, feed_vals, scope,
                 step: int, iterations: int, stacked_feed: bool):
        """The WhileGrad probe's bounds for this run (None without a
        differentiated dynamic While), after the refusals of the JAX
        executor: iterations > 1 with probed bounds, and iterations > 1
        with stateful ops."""
        probe_feed = {k: v[0] for k, v in feed_vals.items()} \
            if stacked_feed else feed_vals
        bounds = self._probe_while_bounds(program, probe_feed, scope, step)
        if iterations > 1:
            if bounds:
                raise RuntimeError(
                    "iterations > 1 is incompatible with unbounded-While "
                    "gradients: the trip-count probe measures the initial "
                    "state only, but later iterations may need a larger "
                    "bound. Run steps one at a time.")
            skey = (source.uid, source.version)
            stateful = self._stateful_cache.get(skey)
            if stateful is None:
                stateful = _stateful_ops_in(program,
                                            program.global_block.ops)
                self._stateful_cache[skey] = stateful
            if stateful:
                raise RuntimeError(
                    f"iterations > 1 with stateful ops "
                    f"{sorted(set(stateful))}: host-side channel/select/go "
                    "ops inside a repeated step are unverified. Run steps "
                    "one at a time.")
        return bounds

    def _check_flags(self, source: Program, names, values) -> None:
        """The Exhausted flags `values` of this run (named `names`):
        checked at once under CHECK_WHILE_BOUND, else deferred, and the
        deferred flags whose runs have finished checked now."""
        if CHECK_WHILE_BOUND:
            for n, v in zip(names, values):
                _check_while_flag((source.uid, n), v, raise_=True)
            return
        still = []
        for key, v, ev in self._deferred_flags:
            if ev is None or ev.query():
                _check_while_flag(key, v, raise_=False)
            else:
                still.append((key, v, ev))
        if names:
            ev = None
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
            still.extend(((source.uid, n), v, ev)
                         for n, v in zip(names, values))
        self._deferred_flags = still

    def _flush_while_flags(self) -> None:
        flags_, self._deferred_flags = self._deferred_flags, []
        for key, v, _ in flags_:
            _check_while_flag(key, v, raise_=False)

    def close(self) -> None:
        """Check the Exhausted flags still deferred (a warning each, as
        the run after would give), and drop the compiled keys."""
        self._flush_while_flags()
        self._cache.clear()
        self._probe_cache.clear()
        self._stateful_cache.clear()
        self._rewrites.clear()
        self._eager_reports.clear()

    def run(self, program, feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            iterations: int = 1, stacked_feed: bool = False,
            sync: bool = True):
        """Execute the global block of `program` with `feed`; return the
        fetches as numpy arrays.

        feed values: numpy arrays, python scalars, tensors, or ragged
        values (LoDTensor with any number of LoD levels, RaggedPair,
        RaggedNested, RaggedTree); a `device_feed` dict is used as
        it is. fetch_list entries: var names or objects with a `.name`; a
        ragged fetch comes back as a LoDTensor. return_numpy=False
        returns dense fetches as the device tensors.

        iterations > 1 runs the block that many times, the persistable
        state each run writes read by the next, as that many single runs
        would. With stacked_feed=True each feed carries a leading axis of
        length `iterations` and iteration i reads slice i: K distinct
        batches in one call. Fetches are the last iteration's; the step
        counter advances by `iterations`.

        sync=False returns a `StepResult` instead of materialized
        fetches: the ops are dispatched and the scope already holds the
        new state, but nothing waits for the card until a fetched value
        is read. Fetching a read-written persistable (a parameter, an
        optimizer accumulator, a KV cache) that way is rejected, by the
        JAX executor's donated-state rule: the compiled step writes such
        state in place (the eager arm's KV-cache ops too), so a lazy
        handle would read a later step's values. Fetch such vars with
        sync=True, or (compiled) build the Executor with
        donate_state=False.

        The Exhausted flag of every bounded While of the block is
        fetched with the run and checked (see CHECK_WHILE_BOUND)."""
        from ..analysis import verifier as _verifier
        if hasattr(program, "desc"):  # accept the python builder wrapper
            program = program.desc
        source = program
        scope = global_scope() if scope is None else scope
        feed = feed or {}
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        n_user = len(fetch_names)
        # appended even when the caller fetches one too: the checked tail
        # must be complete
        fetch_names += [op.outputs["Exhausted"][0]
                        for op in source.global_block.ops
                        if op.type == "while" and op.outputs.get("Exhausted")]
        # the pre-compile gate (analysis/verifier.py): structural checks
        # before anything runs, memoized per program version
        if _verifier.verify_enabled():
            _verifier.executor_gate(source, 0, fetch_names[:n_user],
                                    feed.keys(), self.donate_state, sync)
        feed_vals = self._feed_values(feed)
        self._check_iterations(feed_vals, iterations, stacked_feed)
        program, rewrite = self._rewritten(source, list(feed_vals),
                                           fetch_names)
        counter = scope.find(STEP_VAR)
        step = 0 if counter is None else int(counter)
        bounds = self._prepare(source, program, feed_vals, scope, step,
                               iterations, stacked_feed)
        key = self.compile_key(source, feed_signature(feed_vals),
                               fetch_names, while_bounds=bounds,
                               iterations=iterations,
                               stacked_feed=stacked_feed,
                               donate=self.donate_state)
        if not self.compiled:
            reports = self._eager_reports.get(key)
            if reports is None or reports[0] is not program:
                reports = (program,) + self._reports(
                    source, program, feed_vals, stacked_feed)
                self._eager_reports[key] = reports
            _, self.last_memory, self.last_cost = reports
            fetched = self._run_eager(source, program, feed_vals,
                                      fetch_names, n_user, scope,
                                      iterations, stacked_feed, sync, step,
                                      bounds)
        else:
            fetched = self._run_compiled(key, source, program, rewrite,
                                         feed_vals, fetch_names, n_user,
                                         scope, iterations, stacked_feed,
                                         sync, step, bounds)
        scope.set(STEP_VAR, torch.tensor(step + iterations,
                                         dtype=torch.int32))
        result = self._result(fetched[:n_user], fetch_names[:n_user],
                              return_numpy, sync)
        self._check_flags(source, fetch_names[n_user:], fetched[n_user:])
        return result

    def _run_compiled(self, key, source, program, rewrite, feed_vals,
                      fetch_names, n_user, scope, iterations, stacked_feed,
                      sync, step, bounds):
        compiled = self._cache.get(key)
        if compiled is None or compiled.program is not program:
            self.cache_stats["misses"] += 1
            mem, cost = self._reports(source, program, feed_vals,
                                      stacked_feed)
            compiled = self._compile(program, fetch_names, scope, bounds)
            compiled.rewrite, compiled.memory, compiled.cost = \
                rewrite, mem, cost
            self._cache[key] = compiled
        else:
            self.cache_stats["hits"] += 1
        self.last_compiled = compiled
        self.last_cost, self.last_memory = compiled.cost, compiled.memory
        if not sync and self.donate_state:
            aliased = [n for n in fetch_names[:n_user]
                       if n in compiled.rw_names]
            if aliased:
                raise ValueError(
                    f"sync=False cannot fetch donated state vars "
                    f"{aliased}: the lazy StepResult would hold a buffer "
                    "a later step writes in place. Fetch them with "
                    "sync=True, or build the Executor with "
                    "donate_state=False.")

        captures = self.device.type == "cuda" and \
            not compiled.uncaptured_ops
        for i in range(iterations):
            feed_i = {k: v[i] for k, v in feed_vals.items()} \
                if stacked_feed else feed_vals
            thread = threading.get_ident()
            if captures and (compiled.graph is not None
                             or thread in compiled.warm_threads):
                fetched = self._replay(source, compiled, feed_i, scope,
                                       step + i)
            else:
                fetched = self._step(source, compiled, feed_i, scope,
                                     step + i)
                compiled.warm_threads.add(thread)
        return fetched

    def _result(self, fetched, fetch_names, return_numpy, sync):
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._inflight = event
        result = StepResult(fetched, fetch_names, return_numpy, event,
                            cost=self.last_cost)
        return result.fetches() if sync else result

    # -- the compiled path ---------------------------------------------------
    def _compile(self, program: Program, fetch_names, scope: Scope,
                 while_bounds=None) -> CompiledProgram:
        block = program.global_block
        read_names, write_names = _collect_state_names(program, block, scope)
        written = set(write_names)
        plan = _Plan(program, block, set(fetch_names) | written,
                     while_bounds)
        return CompiledProgram(
            plan, program, read_names, write_names, fetch_names,
            ro_names=[n for n in read_names if n not in written],
            rw_names=[n for n in read_names if n in written],
            while_bounds=while_bounds)

    def _extra(self, program: Program, step: int, while_bounds) -> Dict:
        """The run-wide values every op of a run sees (registry
        ExecutionContext)."""
        extra = {"device": self.device, "step": step, "program": program}
        if while_bounds:
            extra["while_bounds"] = while_bounds
        return extra

    def _run_plan(self, source: Program, compiled: CompiledProgram,
                  env: Dict[str, Any], step: int) -> None:
        """The planned step over `env`, as run number `step`."""
        plan = compiled.plan
        extra = self._extra(compiled.program, step, compiled.while_bounds)
        records: Dict[int, Tuple] = {}
        from ..ops.core_ops import vjp_grads, vjp_leaves
        with torch.no_grad():
            for j, (op, kind, arg) in enumerate(plan.steps):
                if kind == _RUN:
                    outs = run_op(op, env, extra)
                elif kind == _CONST:
                    key = (compiled.program.uid, compiled.program.version,
                           j)
                    outs = self._const_cache.get(key)
                    if outs is None:
                        outs = run_op(op, env, extra)
                        self._const_cache[key] = outs
                elif kind == _RECORD:
                    # a sub-block op's closure values are leaves too
                    need_grad, closure = arg
                    names = op.input_names() + closure
                    leaf_env, leaves, wrapped = vjp_leaves(
                        names, [env[n] for n in names], need_grad)
                    local = dict(env)
                    local.update(leaf_env)
                    with torch.enable_grad():
                        recorded = run_op(op, local, extra)
                    records[j] = (recorded, leaves, wrapped)
                    outs = {n: _detached(v) for n, v in recorded.items()}
                else:
                    i, last_use, out_names = arg
                    recorded, leaves, wrapped = records[i] if not last_use \
                        else records.pop(i)
                    grads = vjp_grads(recorded, out_names,
                                      [env[n] for n in op.input("OutGrad")],
                                      leaves, wrapped,
                                      retain_graph=not last_use)
                    outs = dict(zip(op.output("InGrad"), grads))
                env.update(outs)
                for n in plan.drops[j]:
                    env.pop(n, None)

    def _step(self, source, compiled: CompiledProgram, feed_i, scope,
              step: int) -> List[Any]:
        """One planned step run as it is (the CPU; on the card, a key's
        first run and a program that is not captured)."""
        env = {n: scope.get(n) for n in compiled.read_names}
        if not self.donate_state:  # in-place ops write into copies
            env.update((n, _clone(env[n])) for n in compiled.rw_names)
        env.update(feed_i)
        self._run_plan(source, compiled, env, step)
        for n in compiled.write_names:
            if n in env:
                scope.set(n, env[n])
        return [env[n] for n in compiled.fetch_names]

    def _capture(self, source, compiled: CompiledProgram, feed_i, scope,
                 step: int) -> None:
        """Capture the planned step into `compiled.graph`: static buffers
        for the feeds and the read state (with donation, the scope's own
        tensors), the new state written into them inside the graph."""
        from ..ops import kernels
        compiled.static_feed = {k: _clone(v) for k, v in feed_i.items()}
        statics: Dict[int, torch.Tensor] = {}
        for n in compiled.read_names:
            v = scope.get(n)
            if not isinstance(v, torch.Tensor) or not v.is_cuda or \
                    self.device.index not in (None, v.device.index):
                raise ValueError(
                    f"state {n!r} is not a tensor on {self.device}: the "
                    "captured step reads state from the card")
            # a buffer two names share is given to one of them
            if not self.donate_state or (v.numel() and
                                         v.data_ptr() in statics):
                v = v.clone()
            if v.numel():
                statics[v.data_ptr()] = v
            compiled.static_state[n] = v
            if self.donate_state:
                scope.set(n, v)
        fixed = set(statics)
        fixed.update(t.data_ptr() for v in compiled.static_feed.values()
                     for t in ragged_parts(v))
        fixed.update(v.data_ptr() for outs in self._const_cache.values()
                     for v in outs.values() if isinstance(v, torch.Tensor))

        def owned(v):
            """v itself, or a copy of it when its memory is a static
            buffer or a cached constant (state must own its memory)."""
            if any(t.numel() and t.data_ptr() in fixed
                   for t in ragged_parts(v)):
                return _clone(v)
            return v

        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            env = dict(compiled.static_state)
            env.update(compiled.static_feed)
            self._run_plan(source, compiled, env, step)
            copies = []
            for n in compiled.write_names:
                if n not in env:
                    continue
                dst = compiled.static_state.get(n)
                if dst is None:
                    compiled.static_writes[n] = owned(env[n])
                    continue
                if env[n] is not dst:
                    # every source is read before any buffer is written
                    copies.append((n, dst, owned(env[n])))
                compiled.static_writes[n] = dst
            for n, dst, src in copies:
                _copy_into(dst, src, f"state {n!r}")
            compiled.static_fetches = [env[n]
                                       for n in compiled.fetch_names]
            del env, copies
        after = kernels.launch_counts()
        compiled.launches = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
        # the capture ran the wrappers but launched nothing
        kernels.credit_launches({k: -c for k, c in
                                 compiled.launches.items()})
        compiled.graph = graph
        compiled.captured = True

    def _replay(self, source, compiled: CompiledProgram, feed_i, scope,
                step: int) -> List[Any]:
        """One step through the captured graph (captured first on the
        key's second run)."""
        from ..ops import kernels
        if compiled.graph is None:
            self._capture(source, compiled, feed_i, scope, step)
        else:
            for n, static in compiled.static_state.items():
                v = scope.get(n)
                if v is not static:
                    _copy_into(static, v, f"state {n!r}")
                    if self.donate_state:
                        scope.set(n, static)
            for k, static in compiled.static_feed.items():
                _copy_into(static, feed_i[k], f"feed {k!r}")
        compiled.graph.replay()
        kernels.credit_launches(compiled.launches)
        for n, v in compiled.static_writes.items():
            scope.set(n, v if self.donate_state else _clone(v))
        return [_clone(v) for v in compiled.static_fetches]

    # -- the eager walk ------------------------------------------------------
    def _run_eager(self, source, program, feed_vals, fetch_names, n_user,
                   scope, iterations, stacked_feed, sync, step, bounds):
        block = program.global_block
        read_names, write_names = _collect_state_names(program, block, scope)
        if not sync:
            rw = set(read_names) & set(write_names)
            aliased = [n for n in fetch_names[:n_user] if n in rw]
            if aliased:
                raise ValueError(
                    f"sync=False cannot fetch donated state vars "
                    f"{aliased}: the lazy StepResult would hold a buffer "
                    "a later step may write in place (the KV-cache ops "
                    "do). Fetch them with sync=True.")
        for i in range(iterations):
            env: Dict[str, Any] = {n: scope.get(n) for n in read_names}
            env.update({k: v[i] for k, v in feed_vals.items()}
                       if stacked_feed else feed_vals)
            self._run_block(source, program, env, write_names, step + i,
                            bounds)
            for n in write_names:
                if n in env:
                    scope.set(n, env[n])
        return [env[n] for n in fetch_names]

    def _run_block(self, source: Program, program: Program,
                   env: Dict[str, Any], write_names: List[str], step: int,
                   while_bounds=None) -> None:
        """Every op of the global block of `program` in order over `env`,
        as run number `step` (random ops fold it into their seed)."""
        extra = self._extra(program, step, while_bounds)
        with torch.no_grad():
            for i, op in enumerate(program.global_block.ops):
                opdef = OpRegistry.get(op.type)
                if opdef.constant and not any(
                        n in write_names for n in op.output_names()):
                    key = (program.uid, program.version, i)
                    outs = self._const_cache.get(key)
                    if outs is None:
                        outs = run_op(op, env, extra)
                        self._const_cache[key] = outs
                else:
                    outs = run_op(op, env, extra)
                env.update(outs)

    def synchronize(self) -> "Executor":
        """Barrier: wait until every op dispatched by this executor has
        finished on the card. Checkpoint saves during asynchronous
        training call it before snapshotting persistable state, so a
        snapshot never races the step in flight (and an asynchronous
        CUDA error surfaces here). A no-op on the CPU."""
        if self._inflight is not None:
            self._inflight.synchronize()
            self._inflight = None
        return self
