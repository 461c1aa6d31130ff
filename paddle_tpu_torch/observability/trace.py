"""Step tracing: span IDs over the profiler events.

The port's copy of ``paddle_tpu/observability/trace.py``:

- ``step_trace(step)`` opens a root span with a fresh 64-bit trace id;
  ``span(name)`` opens a child span under the current one. Contexts
  nest via a contextvar, so concurrent serving workers and the trainer
  thread each see their own chain.
- While a span is active, EVERY profiler RecordEvent closed on that
  thread is stamped with ``args={"trace_id", "span_id"}`` (profiler.py
  calls back through ``set_trace_args_provider`` — the profiler stays
  import-free of this package).
- ``use_span(ctx)`` re-activates an existing span on another thread
  without an event of its own.

Boundaries: contextvars do not cross threads, so work handed to another
thread starts a fresh chain unless it opens its own span or
``use_span``s the owner's; the context is two hex ids, no wire format.
The JAX package also stamps the context into its JSON-RPC requests; the
port has no RPC layer.
"""
from __future__ import annotations

import contextlib
import contextvars
import random
import threading
from typing import Dict, Iterator, Optional

from .. import profiler

__all__ = ["SpanContext", "current", "step_trace", "span", "use_span",
           "current_trace_args"]

_current: "contextvars.ContextVar[Optional[SpanContext]]" = \
    contextvars.ContextVar("paddle_tpu_trace_span", default=None)

# span ids only need uniqueness within a process's traces; a module rng
# (seeded from urandom) behind a lock keeps id generation cheap and
# thread-safe without per-span os.urandom syscalls
_rng = random.Random()
_rng_lock = threading.Lock()


def _new_id() -> str:
    with _rng_lock:
        return f"{_rng.getrandbits(64):016x}"


class SpanContext:
    """One span: (trace_id, span_id, parent_id, name). Ids are
    immutable; ``discard()`` marks a span that turned out to cover no
    work (e.g. the trainer opened a step span and the reader was
    exhausted), suppressing its own trace event on exit."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "discarded")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.discarded = False

    def discard(self) -> None:
        self.discarded = True

    def wire(self) -> Dict[str, str]:
        """The propagation payload stamped into RPC requests."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def __repr__(self):
        return (f"SpanContext(name={self.name!r}, "
                f"trace={self.trace_id}, span={self.span_id}, "
                f"parent={self.parent_id})")


def current() -> Optional[SpanContext]:
    """The active span on this thread/context, or None."""
    return _current.get()


def current_trace_args() -> Optional[Dict[str, str]]:
    """Profiler hook: args to stamp onto events closed under a span."""
    ctx = _current.get()
    return None if ctx is None else ctx.wire()


@contextlib.contextmanager
def _activate(ctx: SpanContext, event_name: str,
              cat: str) -> Iterator[SpanContext]:
    token = _current.set(ctx)
    # opened AFTER the contextvar is set, so the span's own event
    # carries its own ids via the provider
    ev = profiler.RecordEvent(event_name, cat=cat)
    ev.__enter__()
    try:
        yield ctx
    finally:
        if not ctx.discarded:
            ev.__exit__()
        _current.reset(token)


def step_trace(step, name: Optional[str] = None):
    """Open a ROOT span for one training step (fresh trace id). Every
    profiler event closed inside — feed assembly, dispatch, RPC
    attempts — shares the step's trace id::

        with trace.step_trace(trainer.step):
            ...one dispatch...
    """
    label = name or f"step/{step}"
    ctx = SpanContext(_new_id(), _new_id(), None, label)
    return _activate(ctx, f"trace::{label}", profiler.CAT_TRACE)


@contextlib.contextmanager
def use_span(ctx: Optional[SpanContext]):
    """Re-activate an EXISTING span on this thread, emitting no event of
    its own — the cross-thread handoff closing the documented trace
    boundary: a FeedPrefetcher producer converting a step's batch, a
    serving worker delivering a dispatched batch, or a lazy
    ``StepResult.fetches()`` materialized after its step's span exited
    all stamp their profiler events with the OWNING step's ids instead
    of whatever contextvar happens to be active (or none).
    ``ctx=None`` is a no-op, so call sites need no conditional."""
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def span(name: str):
    """Open a CHILD span under the current context (or a fresh root
    trace when none is active)."""
    parent = _current.get()
    if parent is None:
        ctx = SpanContext(_new_id(), _new_id(), None, name)
    else:
        ctx = SpanContext(parent.trace_id, _new_id(), parent.span_id,
                          name)
    return _activate(ctx, f"span::{name}", profiler.CAT_TRACE)


# every RecordEvent closed under an active span inherits its ids
profiler.set_trace_args_provider(current_trace_args)
