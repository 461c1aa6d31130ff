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
  replays its copy, as the eager arm does (`CompiledProgram.replayed`);
  one with sub-block closures (A4b) is refused;
- each value dropped from the step's environment after its last reader,
  except the fetches and the written state (autograd keeps what a
  recorded graph saved): the role of XLA's buffer assignment;
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
  program holding an op registered capturable=False (a random op seeding
  a host generator) is compiled but never captured:
  `CompiledProgram.uncaptured_ops` names those ops. A capture or replay
  error raises; nothing is rerouted.

`Executor(compiled=False)` is the eager walk: every op's compute rule in
order under torch.no_grad(), each ``__vjp__`` grad op replaying its
forward op under autograd by itself, every value kept until the run ends.
Read-write persistable state (the KV caches of the generation programs)
is updated IN PLACE by its ops on both paths; with
``donate_state=False`` the compiled path updates copies, and the tensors
a caller held before a run are left as they were. Before a run, the
kernel-dispatch stamps of the JAX executor's rewrite are applied to a
copy of the program (core/dispatch.py), cached per program, program
version and knob values.

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

Not ported yet: While probing (A4b), and the cost/memory reports and the
rewrite pipeline (A6).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import flags
from ..amp import amp_enabled
from . import dispatch
from .ir import BlockDesc, OpDesc, Program, SUB_BLOCK_ATTRS
from .lod import (RAGGED_TYPES, LoDTensor, RaggedNested, RaggedPair,
                  RaggedTree, ragged_like, ragged_parts, with_data)
from .registry import OpRegistry, run_op
from .scope import Scope, global_scope

STEP_VAR = "@step_counter@"


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
    True."""

    def __init__(self, raw_fetches, fetch_names, return_numpy: bool,
                 event=None):
        self._raw = list(raw_fetches)
        self.fetch_names = list(fetch_names)
        self._return_numpy = return_numpy
        self._event = event
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


def _same_op(op: OpDesc, fwd: Dict[str, Any]) -> bool:
    """True when `op` is the op the ``fwd_op`` dict `fwd` was copied
    from, attrs included."""
    try:
        return bool(op.to_dict() == fwd)
    except (TypeError, ValueError):  # attrs that do not compare as bools
        return False


def _outputs_key(op_type: str, outputs: Dict[str, List[str]]) -> Tuple:
    return (op_type, tuple(sorted((k, tuple(v)) for k, v in outputs.items())))


# the kinds of a plan step
_RUN, _CONST, _RECORD, _VJP = range(4)


class _Plan:
    """What one compile key runs: each op of the block with its kind
    (plain, constant, forward recorded for a ``__vjp__`` op, ``__vjp__``
    reading that record), and the names dropped after it."""

    def __init__(self, block: BlockDesc, keep):
        ops = list(block.ops)
        fwd_of: Dict[int, int] = {}     # __vjp__ op index -> forward index
        need: Dict[int, List[bool]] = {}  # forward index -> in_need_grad
        latest: Dict[Tuple, int] = {}
        self.replayed: List[int] = []
        for j, op in enumerate(ops):
            if op.type != "__vjp__":
                latest[_outputs_key(op.type, op.outputs)] = j
                continue
            if op.attrs.get("closure_names"):
                raise NotImplementedError(
                    f"op {j} (__vjp__ of {op.attrs['fwd_op']['type']!r}) "
                    "differentiates a sub-block: the compiled executor does "
                    "not run sub-blocks yet (ROADMAP A4b); run the program "
                    "with Executor(compiled=False)")
            fwd = op.attrs["fwd_op"]
            i = latest.get(_outputs_key(fwd["type"], fwd["outputs"]))
            flags_ = list(op.attrs["in_need_grad"])
            if i is not None and _same_op(ops[i], fwd) and \
                    need.setdefault(i, flags_) == flags_:
                fwd_of[j] = i
            else:
                self.replayed.append(j)
        # the last __vjp__ op reading a record drops it
        last_vjp = {i: j for j, i in fwd_of.items()}
        self.steps: List[Tuple[OpDesc, int, Any]] = []
        last: Dict[str, int] = {}
        for j, op in enumerate(ops):
            opdef = OpRegistry.get(op.type)
            if j in fwd_of:
                i = fwd_of[j]
                kind, arg = _VJP, (i, last_vjp[i] == j)
                reads = op.input("OutGrad")
            elif j in need:
                kind, arg = _RECORD, need[j]
                reads = op.input_names()
            else:
                kind = _CONST if opdef.constant and not any(
                    n in keep for n in op.output_names()) else _RUN
                arg, reads = None, op.input_names()
            self.steps.append((op, kind, arg))
            for n in reads + op.output_names():
                last[n] = j
        self.drops: List[List[str]] = [[] for _ in ops]
        for n, j in last.items():
            if n not in keep:
                self.drops[j].append(n)
        self.uncaptured_ops = tuple(sorted({
            op.type for op in ops
            if not OpRegistry.get(op.type).capturable}))


class CompiledProgram:
    """The compiled form of (program, feed signature, fetch list): the
    state names, the plan (`_Plan`) and, once a card has captured it, the
    CUDA graph with its static buffers.

    `captured` is True once the step has been captured; it stays False on
    the CPU and for a program holding an op in `uncaptured_ops` (the op
    types registered capturable=False). `replayed` lists the ``__vjp__``
    op types that replay their forward op instead of reading its record."""

    def __init__(self, plan: _Plan, stamped: Program, read_names,
                 write_names, fetch_names, ro_names=(), rw_names=()):
        self.plan = plan
        self.stamped = stamped
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
        # program uid -> (version, knob values, dispatch-stamped program)
        self._stamped: Dict[int, Tuple[int, Tuple, Program]] = {}
        # the event recorded after the last dispatch on the card, until
        # synchronize() has waited for it
        self._inflight: Optional[torch.cuda.Event] = None
        # compile key -> CompiledProgram; the hits and misses of its
        # lookups (a miss plans a new key), as the reference counts them
        self._cache: Dict[Tuple, CompiledProgram] = {}
        self.cache_stats: Dict[str, int] = {"hits": 0, "misses": 0}
        # the CompiledProgram of the most recent compiled run
        self.last_compiled: Optional[CompiledProgram] = None

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
        outside it are two keys. While bounds are not ported yet:
        `while_bounds` is None. `donate=None` reads the process
        default."""
        if hasattr(program, "desc"):
            program = program.desc
        return (program.uid, program.version, feed_sig,
                tuple(fetch_names), block_idx,
                amp_enabled() if amp is None else bool(amp),
                tuple(sorted(while_bounds.items())) if while_bounds
                else None, iterations, stacked_feed,
                donate_state_default() if donate is None else bool(donate))

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
        donate_state=False."""
        if hasattr(program, "desc"):  # accept the python builder wrapper
            program = program.desc
        if not self.compiled:
            return self._run_eager(program, feed, fetch_list, scope,
                                   return_numpy, iterations, stacked_feed,
                                   sync)
        source, program = program, self._dispatched(program)
        scope = global_scope() if scope is None else scope
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        feed_vals = self._feed_values(feed or {})
        self._check_iterations(feed_vals, iterations, stacked_feed)
        key = self.compile_key(source, feed_signature(feed_vals),
                               fetch_names, iterations=iterations,
                               stacked_feed=stacked_feed,
                               donate=self.donate_state)
        compiled = self._cache.get(key)
        if compiled is None or compiled.stamped is not program:
            self.cache_stats["misses"] += 1
            compiled = self._compile(program, fetch_names, scope)
            self._cache[key] = compiled
        else:
            self.cache_stats["hits"] += 1
        self.last_compiled = compiled
        if not sync and self.donate_state:
            aliased = [n for n in fetch_names if n in compiled.rw_names]
            if aliased:
                raise ValueError(
                    f"sync=False cannot fetch donated state vars "
                    f"{aliased}: the lazy StepResult would hold a buffer "
                    "a later step writes in place. Fetch them with "
                    "sync=True, or build the Executor with "
                    "donate_state=False.")

        counter = scope.find(STEP_VAR)
        step = 0 if counter is None else int(counter)
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
        scope.set(STEP_VAR, torch.tensor(step + iterations,
                                         dtype=torch.int32))
        return self._result(fetched, fetch_names, return_numpy, sync)

    def _result(self, fetched, fetch_names, return_numpy, sync):
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._inflight = event
        result = StepResult(fetched, fetch_names, return_numpy, event)
        return result.fetches() if sync else result

    # -- the compiled path ---------------------------------------------------
    def _compile(self, program: Program, fetch_names,
                 scope: Scope) -> CompiledProgram:
        block = program.global_block
        read_names, write_names = _collect_state_names(program, block, scope)
        written = set(write_names)
        plan = _Plan(block, set(fetch_names) | written)
        return CompiledProgram(
            plan, program, read_names, write_names, fetch_names,
            ro_names=[n for n in read_names if n not in written],
            rw_names=[n for n in read_names if n in written])

    def _run_plan(self, source: Program, compiled: CompiledProgram,
                  env: Dict[str, Any], step: int) -> None:
        """The planned step over `env`, as run number `step`."""
        plan = compiled.plan
        extra = {"device": self.device, "step": step}
        records: Dict[int, Tuple] = {}
        from ..ops.core_ops import vjp_grads, vjp_leaves, vjp_out_names
        with torch.no_grad():
            for j, (op, kind, arg) in enumerate(plan.steps):
                if kind == _RUN:
                    outs = run_op(op, env, extra)
                elif kind == _CONST:
                    key = (source.uid, source.version, j)
                    outs = self._const_cache.get(key)
                    if outs is None:
                        outs = run_op(op, env, extra)
                        self._const_cache[key] = outs
                elif kind == _RECORD:
                    names = op.input_names()
                    local, leaves, wrapped = vjp_leaves(
                        names, [env[n] for n in names], arg)
                    with torch.enable_grad():
                        recorded = run_op(op, local, extra)
                    records[j] = (recorded, leaves, wrapped)
                    outs = {n: _detached(v) for n, v in recorded.items()}
                else:
                    i, last_use = arg
                    recorded, leaves, wrapped = records[i] if not last_use \
                        else records.pop(i)
                    grads = vjp_grads(recorded, vjp_out_names(op),
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
    def _run_eager(self, program, feed, fetch_list, scope, return_numpy,
                   iterations, stacked_feed, sync):
        source, program = program, self._dispatched(program)
        scope = global_scope() if scope is None else scope
        feed = feed or {}
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        block = program.global_block
        read_names, write_names = _collect_state_names(program, block, scope)
        feed_vals = self._feed_values(feed)
        self._check_iterations(feed_vals, iterations, stacked_feed)
        if not sync:
            rw = set(read_names) & set(write_names)
            aliased = [n for n in fetch_names if n in rw]
            if aliased:
                raise ValueError(
                    f"sync=False cannot fetch donated state vars "
                    f"{aliased}: the lazy StepResult would hold a buffer "
                    "a later step may write in place (the KV-cache ops "
                    "do). Fetch them with sync=True.")

        counter = scope.find(STEP_VAR)
        step = 0 if counter is None else int(counter)
        for i in range(iterations):
            env: Dict[str, Any] = {n: scope.get(n) for n in read_names}
            env.update({k: v[i] for k, v in feed_vals.items()}
                       if stacked_feed else feed_vals)
            self._run_block(source, block, env, write_names, step + i)
            for n in write_names:
                if n in env:
                    scope.set(n, env[n])
        scope.set(STEP_VAR, torch.tensor(step + iterations,
                                         dtype=torch.int32))
        return self._result([env[n] for n in fetch_names], fetch_names,
                            return_numpy, sync)

    def _run_block(self, source: Program, block: BlockDesc,
                   env: Dict[str, Any], write_names: List[str],
                   step: int) -> None:
        """Every op of `block` in order over `env`, as run number
        `step` (random ops fold it into their seed)."""
        extra = {"device": self.device, "step": step}
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
