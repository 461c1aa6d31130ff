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

The step counter lives in the scope, as in the JAX package: ``STEP_VAR``
holds a 0-d int32 tensor on the host (it seeds host-side generators, so
reading it never waits for the card). ``run`` reads it, hands each op
``step + i`` on iteration i, and stores ``step + iterations``; so a
second executor on the same scope, ``Trainer.test`` and a checkpoint
resume all continue one count. ``run(..., iterations=K)`` runs the block
K times, state chained from one run to the next; ``sync=False`` returns
a ``StepResult`` whose fetches convert to the host only when read.

Not ported yet: the compile cache, While probing, and the cost/memory
reports (ROADMAP A3, A6).
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

STEP_VAR = "@step_counter@"


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
                v = to_device_value(v, torch.device("cpu"))
            if isinstance(v, RaggedPair):
                out[k] = RaggedPair(
                    pinned_upload(v.data, device),
                    pinned_upload(v.lengths, device).to(torch.int32))
            else:
                out[k] = pinned_upload(v, device)
        return out

    out, ready = upload_on_side_stream(make, device)
    out.ready = ready
    return out


def _feed_tensors(value):
    return [value.data, value.lengths] if isinstance(value, RaggedPair) \
        else [value]


def to_host_value(value, return_numpy: bool = True):
    """A fetched value on the host: a RaggedPair comes back as a LoDTensor
    of its valid rows, anything else as a numpy array (as the tensor
    itself with return_numpy=False)."""
    if isinstance(value, RaggedPair):
        return LoDTensor.from_padded(to_numpy(value.data),
                                     value.lengths.cpu().numpy())
    return to_numpy(value) if return_numpy else value


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
        # program uid -> (version, knob values, dispatch-stamped program)
        self._stamped: Dict[int, Tuple[int, Tuple, Program]] = {}
        # the event recorded after the last dispatch on the card, until
        # synchronize() has waited for it
        self._inflight: Optional[torch.cuda.Event] = None

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
            scope: Optional[Scope] = None, return_numpy: bool = True,
            iterations: int = 1, stacked_feed: bool = False,
            sync: bool = True):
        """Execute the global block of `program` with `feed`; return the
        fetches as numpy arrays.

        feed values: numpy arrays, python scalars, tensors, or ragged
        values (LoDTensor, RaggedPair); a `device_feed` dict is used as
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
        JAX executor's donated-state rule: the KV-cache ops write their
        state in place, so a lazy handle would read a later step's
        values. Fetch such vars with sync=True."""
        if hasattr(program, "desc"):  # accept the python builder wrapper
            program = program.desc
        source, program = program, self._dispatched(program)
        scope = global_scope() if scope is None else scope
        feed = feed or {}
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        block = program.global_block
        read_names, write_names = _collect_state_names(program, block, scope)

        if isinstance(feed, DeviceFeed):
            feed_vals = dict(feed)
            if feed.ready is not None:
                await_upload(feed.ready, [t for v in feed_vals.values()
                                          for t in _feed_tensors(v)],
                             self.device)
        else:
            feed_vals = {k: to_device_value(v, self.device)
                         for k, v in feed.items()}
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
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._inflight = event
        result = StepResult([env[n] for n in fetch_names], fetch_names,
                            return_numpy, event)
        return result.fetches() if sync else result

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
