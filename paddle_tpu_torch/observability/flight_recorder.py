"""Failure flight recorder: a bounded ring buffer of recent profiler
events that auto-dumps a chrome-trace + JSON bundle when a failure
trigger fires.

The port's copy of ``paddle_tpu/observability/flight_recorder.py``. The
recorder keeps the last ``capacity`` profiler events (serving batches,
generation steps, trace spans — everything RecordEvent emits, captured
through the always-on ``profiler.add_event_listener`` hook, so no
profiling session needs to be active) and, on a trigger, writes one
bundle directory:

    flightrec_<millis>_<pid>_<seq>_<reason>/
        trace.json   chrome://tracing-loadable {"traceEvents": [...]}
        meta.json    reason, exception, caller context, and a full
                     metrics-registry snapshot at dump time

Triggers the port fires: ``circuit_open`` (resilience/health.py, a
breaker tripped open), ``rollback`` (serving/lifecycle.py, a hot-swap
rolled back) and ``shed_storm`` (serving/admission.py, more sheds inside
the rolling window than the configured threshold). The JAX package
also dumps on a NaN fetch, a failed checkpoint save and a
VerificationError; the port's Trainer and gates do not yet (ROADMAP
A11).

Nothing is ever written on a clean run. Dumps go under the directory the
caller gives (``FlightRecorder(dump_dir=...)``), else
``PADDLE_TPU_FLIGHT_DIR``, else ``<tempfile.gettempdir()>/
paddle_tpu_flightrec``; they are rate-limited per reason
(``min_interval_s``) and pruned to this process's ``max_dumps`` newest,
so a failure storm cannot fill a disk. ``PADDLE_TPU_FLIGHT_RECORDER=0``
disables the recorder entirely (no listener, zero overhead).
"""
from __future__ import annotations

import collections
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Deque, Dict, List, Optional

from .. import profiler

__all__ = ["FlightRecorder", "flight_recorder", "set_flight_recorder",
           "record_failure"]

DEFAULT_CAPACITY = 4096
DEFAULT_MAX_DUMPS = 8
DEFAULT_MIN_INTERVAL_S = 1.0

_DUMPS_HELP = ("Flight-recorder bundles written, by failure reason "
               "(nan_fetch, checkpoint_failure, circuit_open, "
               "verification_error, rollback, shed_storm).")


def _default_dump_dir() -> str:
    return os.environ.get("PADDLE_TPU_FLIGHT_DIR") or os.path.join(
        tempfile.gettempdir(), "paddle_tpu_flightrec")


def recorder_enabled_by_env() -> bool:
    return os.environ.get("PADDLE_TPU_FLIGHT_RECORDER", "1") != "0"


class FlightRecorder:
    """Ring buffer + dump logic. ``enable()`` installs the profiler
    event listener (idempotent); ``disable()`` removes it — a disabled
    recorder records nothing and ``trigger`` is a no-op returning
    None."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 dump_dir: Optional[str] = None,
                 max_dumps: int = DEFAULT_MAX_DUMPS,
                 min_interval_s: float = DEFAULT_MIN_INTERVAL_S):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_dumps < 1:
            # entries[:-0] would slice to [] and prune NOTHING — there
            # is no "keep zero dumps" mode; disable() is the off switch
            raise ValueError(f"max_dumps must be >= 1, got {max_dumps}")
        self._events: Deque[Dict] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._last_dump: Dict[str, float] = {}
        self.dump_dir = dump_dir or _default_dump_dir()
        self.max_dumps = int(max_dumps)
        self.min_interval_s = float(min_interval_s)
        self._seq = 0  # disambiguates same-millisecond bundles
        self._enabled = False

    # -- lifecycle -----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> "FlightRecorder":
        if not self._enabled:
            self._enabled = True
            profiler.add_event_listener(self._on_event)
        return self

    def disable(self) -> "FlightRecorder":
        if self._enabled:
            self._enabled = False
            profiler.remove_event_listener(self._on_event)
        return self

    # -- capture -------------------------------------------------------
    def _on_event(self, ev: Dict) -> None:
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[Dict]:
        """Snapshot of the ring buffer (newest last)."""
        with self._lock:
            return list(self._events)

    # -- dumping -------------------------------------------------------
    def trigger(self, reason: str, exc: Optional[BaseException] = None,
                context: Optional[Dict] = None) -> Optional[str]:
        """Write a bundle for ``reason``; returns its path, or None when
        disabled or rate-limited. Never raises — a broken dump path
        must not mask the failure that triggered it."""
        if not self._enabled:
            return None
        try:
            return self._dump(reason, exc, context)
        except Exception:
            return None

    def _dump(self, reason: str, exc, context) -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < self.min_interval_s:
                return None
            self._last_dump[reason] = now
            events = list(self._events)
            self._seq += 1
            seq = self._seq
        # zero-padded seq keeps lexicographic dir order chronological
        # and makes two min_interval_s=0 triggers in the same
        # millisecond distinct instead of colliding at os.replace
        name = (f"flightrec_{int(time.time() * 1000)}_{os.getpid()}"
                f"_{seq:04d}_{reason}")
        final = os.path.join(self.dump_dir, name)
        tmp = final + ".tmp"
        try:
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "trace.json"), "w") as f:
                json.dump({"traceEvents": events}, f)
            meta = {
                "reason": reason,
                "time": time.time(),
                "pid": os.getpid(),
                "exception": repr(exc) if exc is not None else None,
                "context": context or {},
                "num_events": len(events),
            }
            try:
                from .registry import default_registry
                meta["metrics"] = default_registry().snapshot()
            except Exception:
                meta["metrics"] = None
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f, default=repr)
            os.replace(tmp, final)  # atomic publish: no half-written bundle
        except Exception:
            # a failed write (disk full, unwritable dir) must not leave
            # a .tmp orphan NOR consume the rate-limit slot — the next
            # trigger, possibly against a writable dir, should dump
            shutil.rmtree(tmp, ignore_errors=True)
            with self._lock:
                if self._last_dump.get(reason) == now:
                    del self._last_dump[reason]
            raise
        self._prune()
        try:
            from .registry import default_registry
            default_registry().counter(
                "paddle_tpu_flight_recorder_dumps_total", _DUMPS_HELP,
                ("reason",)).labels(reason=reason).inc()
        except Exception:
            pass
        return final

    def _prune(self) -> None:
        # prune only THIS process's bundles (the pid is embedded in the
        # name): the default dump dir is host-shared, and one process's
        # failure storm must not delete another's only crash bundle
        mine = str(os.getpid())
        try:
            # positional pid match (flightrec_<ms>_<pid>_<seq>_<reason>):
            # a substring test would also hit another process's bundle
            # whose zero-padded seq field happens to equal this pid
            entries = sorted(
                d for d in os.listdir(self.dump_dir)
                if d.startswith("flightrec_")
                and d.split("_")[2:3] == [mine]
                and not d.endswith(".tmp"))
        except OSError:
            return
        for d in entries[:-self.max_dumps]:
            shutil.rmtree(os.path.join(self.dump_dir, d),
                          ignore_errors=True)

    def dumps(self) -> List[str]:
        """Bundle paths currently on disk (oldest first)."""
        try:
            return [os.path.join(self.dump_dir, d)
                    for d in sorted(os.listdir(self.dump_dir))
                    if d.startswith("flightrec_")
                    and not d.endswith(".tmp")]
        except OSError:
            return []


# ---------------------------------------------------------------------------
# process default
# ---------------------------------------------------------------------------
_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """The process-default recorder. ``observability/__init__.py``
    calls this at import so the ring is already capturing when the
    first failure fires (enabled unless PADDLE_TPU_FLIGHT_RECORDER=0
    at import time)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder()
            if recorder_enabled_by_env():
                _default.enable()
        return _default


def set_flight_recorder(rec: Optional[FlightRecorder]
                        ) -> Optional[FlightRecorder]:
    """Swap the process default (tests point dumps at a tmp dir);
    returns the previous recorder. The previous recorder keeps its
    enabled state — disable it explicitly if it should stop
    capturing."""
    global _default
    with _default_lock:
        prev, _default = _default, rec
    return prev


def record_failure(reason: str, exc: Optional[BaseException] = None,
                   context: Optional[Dict] = None) -> Optional[str]:
    """The one-liner every trigger site calls: dump a bundle for
    ``reason`` on the default recorder. Never raises; returns the
    bundle path or None."""
    try:
        return flight_recorder().trigger(reason, exc=exc,
                                         context=context)
    except Exception:
        return None
