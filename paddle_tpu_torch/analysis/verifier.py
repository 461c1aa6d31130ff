"""ProgramVerifier: run analysis passes over a program, and the
safety gates built on it.

The port's copy of ``paddle_tpu/analysis/verifier.py``. Every consumer
that is about to run or pin a program first gets a structured report
instead of a deep runtime error or a silent wrong answer:

- ``Executor.run`` verifies on every run, memoized per program version
  (``executor_gate``), before the compile key;
- ``serving.generation.GenerationModel`` verifies its programs at build;
- ``trainer.Trainer`` verifies the (main, startup) pair once at setup;
- ``io.save_inference_model`` verifies the pruned program before it is
  written to disk.

All gates honor ``PADDLE_TPU_VERIFY=0`` (read per call, so tests can
flip it). The JAX package also publishes verify wall time to its
observability registry; the port keeps the report and publishes nothing
yet (the hook is ROADMAP A11).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from .. import flags
from ..core import ir
from .diagnostics import Severity, VerificationError, VerifyReport
from .passes import (PASS_REGISTRY, AnalysisPass, PassContext,
                     default_passes)

__all__ = ["ProgramVerifier", "verify_program", "verify_enabled",
           "executor_gate", "clear_gate_cache"]


def verify_enabled() -> bool:
    """The PADDLE_TPU_VERIFY kill switch, read per call (flippable in
    tests / emergencies without re-importing)."""
    return flags.get("PADDLE_TPU_VERIFY") != "0"


def _desc(program) -> ir.Program:
    """Accept the Python Program wrapper or the core ir.Program."""
    return program.desc if hasattr(program, "desc") else program


class ProgramVerifier:
    """Run a configurable pass pipeline over one program.

    ``passes`` accepts pass instances or registered names
    (see ``analysis.passes.PASS_REGISTRY``); default: all of them.
    """

    def __init__(self, passes: Optional[Sequence[
            Union[str, AnalysisPass]]] = None):
        if passes is None:
            self.passes: List[AnalysisPass] = default_passes()
        else:
            self.passes = [PASS_REGISTRY[p]() if isinstance(p, str) else p
                           for p in passes]

    def verify(self, program, startup=None,
               feed_names: Optional[Iterable[str]] = None,
               fetch_names: Optional[Sequence[str]] = None,
               block_idx: int = 0, donate: bool = False,
               async_dispatch: bool = False,
               program_label: str = "program") -> VerifyReport:
        report = VerifyReport(program_label=program_label)
        ctx = PassContext(
            _desc(program),
            startup=_desc(startup) if startup is not None else None,
            feed_names=feed_names, fetch_names=fetch_names,
            block_idx=block_idx, donate=donate,
            async_dispatch=async_dispatch, report=report)
        for p in self.passes:
            p.run(ctx)
        return report


def verify_program(program, startup=None, feed_names=None,
                   fetch_names=None, block_idx: int = 0,
                   donate: bool = False, async_dispatch: bool = False,
                   passes=None, program_label: str = "program"
                   ) -> VerifyReport:
    """One-shot convenience wrapper around ProgramVerifier."""
    return ProgramVerifier(passes=passes).verify(
        program, startup=startup, feed_names=feed_names,
        fetch_names=fetch_names, block_idx=block_idx, donate=donate,
        async_dispatch=async_dispatch, program_label=program_label)


# ---------------------------------------------------------------------------
# the executor's pre-compile gate, memoized per program version
# ---------------------------------------------------------------------------
_GATE_CACHE_MAX = 512
_gate_cache: Dict[Tuple, bool] = {}
# serving workers and a trainer thread can hit the gate concurrently;
# the membership check / FIFO eviction must be atomic
_gate_cache_lock = threading.Lock()


def clear_gate_cache() -> None:
    with _gate_cache_lock:
        _gate_cache.clear()


def executor_gate(program, block_idx: int,
                  fetch_names: Sequence[str],
                  feed_names: Iterable[str],
                  donate: bool, sync: bool) -> None:
    """Error-severity verification before the executor populates its
    compile cache. Raises VerificationError (a ValueError) with the
    full rendered error list; memoized on (program uid, version, fetch
    list, feeds, donation context) so repeated dispatches of the same
    program pay a dict lookup.
    """
    desc = _desc(program)
    feed_key = frozenset(feed_names)
    key = (desc.uid, desc.version, block_idx, tuple(fetch_names),
           feed_key, bool(donate), bool(sync))
    with _gate_cache_lock:
        if _gate_cache.get(key):
            return
    from .passes import fast_passes
    report = verify_program(
        desc, feed_names=feed_key, fetch_names=list(fetch_names),
        block_idx=block_idx, donate=donate, async_dispatch=not sync,
        # the hot path runs the shared no-retrace pipeline (build-time
        # markers only): pure Python, O(ops) — the full
        # abstract-inference re-trace stays on the cold gates
        # (generation model build, save_inference_model)
        passes=fast_passes(),
        program_label=f"program uid={desc.uid} block={block_idx}")
    report.raise_if_errors(context="pre-compile gate")
    with _gate_cache_lock:
        while len(_gate_cache) >= _GATE_CACHE_MAX:
            _gate_cache.pop(next(iter(_gate_cache)), None)
        _gate_cache[key] = True
