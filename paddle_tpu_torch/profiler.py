"""Profiler: host RecordEvent tables, chrome-trace export, and a merged
host + CUDA table.

The port's copy of ``paddle_tpu/profiler.py`` (reference:
platform/profiler.h RecordEvent tables, the CUPTI device tracer and
tools/timeline.py's chrome-trace export). Host events, their categories,
the always-on event listeners and the trace-args hook are the JAX
package's, unchanged. Device activity comes from ``torch.profiler`` with
CUDA activity (CUPTI underneath) where the JAX package reads an xprof
trace: ``device_profiler`` writes a chrome trace of it, and
``merged_profile`` joins the host events with the CUDA kernel rows in one
table and one timeline (``MergedProfile``).
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Callable, Dict, List, Optional

_events: List[Dict] = []
_enabled = False
# Guards _events against concurrent RecordEvent emission (serving
# workers, prefetcher, trainer thread all append) racing a reader:
# export_chrome_trace/events/summary snapshot the list under this lock
# instead of iterating the live list, so a mid-export append can never
# tear the JSON or skip/duplicate events.
_events_lock = threading.Lock()

# Optional callback returning {"trace_id": ..., "span_id": ...} for the
# current thread — installed by observability.trace so every event
# closed under an active StepTrace span is attributable to its step.
# Kept as a late-bound hook: the profiler must not import observability.
_trace_args_provider: Optional[Callable[[], Optional[Dict]]] = None

# Always-on event listeners: called with every CLOSED RecordEvent's
# dict, even while the profiler itself is disabled. This is the feed
# for the observability layer's live attribution (step-phase breakdown)
# and the flight recorder's ring buffer — neither may depend on a user
# having started a profiling session. Listeners must be cheap and must
# not raise (exceptions are swallowed); with no listener installed the
# disabled-profiler cost stays one list truthiness test.
_event_listeners: List[Callable[[Dict], None]] = []
_listeners_lock = threading.Lock()


def add_event_listener(fn: Callable[[Dict], None]) -> None:
    """Register ``fn(event_dict)`` to observe every closed RecordEvent
    (profiler enabled or not). Idempotent and thread-safe: concurrent
    registration of the same listener installs it exactly once."""
    with _listeners_lock:
        if fn not in _event_listeners:
            _event_listeners.append(fn)


def remove_event_listener(fn: Callable[[Dict], None]) -> None:
    with _listeners_lock:
        try:
            _event_listeners.remove(fn)
        except ValueError:
            pass


def has_event_listener(fn: Callable[[Dict], None]) -> bool:
    with _listeners_lock:
        return fn in _event_listeners


def set_trace_args_provider(fn: Optional[Callable[[], Optional[Dict]]]):
    """Install a callable whose (dict) result is merged into each
    recorded event's chrome-trace ``args`` (None = no-op)."""
    global _trace_args_provider
    _trace_args_provider = fn

# Event categories ("cat" in the chrome-trace schema). Host events from
# the serving runtime (serving/) are tagged so a trace of a
# live server separates queueing/batching/compile time from model time.
CAT_SERVING = "serving"
# Retry/backoff spans from resilience/retry.py: each retry::<op>
# event covers the backoff sleep before that retry attempt.
CAT_RESILIENCE = "resilience"
# Host/device pipelining spans (in the JAX package: core/executor.py,
# trainer.py and the reader's FeedPrefetcher; the port's executor and
# Trainer do not emit them yet, ROADMAP A11). The first four names
# partition a training step's SERIAL host-side time
# (observability.attribution maps them to the
# feed/dispatch/fetch_sync/prefetch_wait phases; anything else lands in
# the device residual):
#   pipeline::dispatch      - enqueueing the jitted step (async, cheap)
#   pipeline::fetch_sync    - materializing fetched values to host
#   pipeline::prefetch_wait - consumer waiting on the feed prefetcher
#   pipeline::host_blocked  - inline (un-prefetched) reader+feed assembly
#   pipeline::sync_barrier  - explicit device barriers (checkpoint
#                             snapshot, Executor.synchronize): device
#                             drain, deliberately NOT a feed phase
#   pipeline::prefetch_fill - producer-thread convert+upload; overlaps
#                             device compute, so never part of the
#                             serial step breakdown
CAT_PIPELINE = "pipeline"
# Per-attempt RPC spans (rpc::<op>) of the JAX package's
# distributed/jsonrpc.py, which the port does not have; the category is
# kept so one trace schema serves both.
CAT_RPC = "rpc"
# StepTrace root/child spans (observability/trace.py): trace::step/N
# covers one dispatched training step; every event closed inside it
# carries the step's trace_id/span_id in its args.
CAT_TRACE = "trace"


class RecordEvent:
    """RAII event (reference: profiler.h:106). `cat` is an optional
    chrome-trace category (e.g. CAT_SERVING) used to filter summaries;
    `args` lands in the chrome-trace event's args dict (merged with the
    active StepTrace context, when one is installed)."""

    def __init__(self, name: str, cat: Optional[str] = None,
                 args: Optional[Dict] = None):
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        listeners = _event_listeners
        if not _enabled and not listeners:
            return False
        ev = {"name": self.name, "ts": self.t0 * 1e6,
              "dur": (time.perf_counter() - self.t0) * 1e6,
              "ph": "X", "pid": 0, "tid": 0}
        if self.cat:
            ev["cat"] = self.cat
        args = dict(self.args) if self.args else {}
        if _trace_args_provider is not None:
            targs = _trace_args_provider()
            if targs:
                args.update(targs)
        if args:
            ev["args"] = args
        if _enabled:
            with _events_lock:
                _events.append(ev)
        # snapshot: a concurrent remove_event_listener must not skip
        # another listener mid-iteration
        for fn in list(listeners):
            try:
                fn(ev)
            except Exception:
                pass  # a broken listener must never break the hot path
        return False


def events(cat: Optional[str] = None) -> List[Dict]:
    """Snapshot of recorded host events, optionally filtered by category."""
    with _events_lock:
        snap = list(_events)
    return [e for e in snap if cat is None or e.get("cat") == cat]


def start_profiler(state: str = "All"):
    global _enabled
    _enabled = True
    with _events_lock:
        _events.clear()


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None):
    global _enabled
    _enabled = False
    if profile_path:
        export_chrome_trace(profile_path)
    return summary()


def summary(cat: Optional[str] = None):
    agg: Dict[str, Dict] = {}
    for e in events(cat=cat):
        a = agg.setdefault(e["name"], {"calls": 0, "total_us": 0.0})
        a["calls"] += 1
        a["total_us"] += e["dur"]
    return agg


def export_chrome_trace(path: str):
    # snapshot under the lock: exporting while serving workers /
    # prefetcher threads still emit RecordEvents must serialize a
    # consistent list, not iterate one being appended to
    with _events_lock:
        snap = list(_events)
    with open(path, "w") as f:
        json.dump({"traceEvents": snap}, f)


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             profile_path: Optional[str] = None):
    """Context manager parity with fluid.profiler.profiler (profiler.py:126)."""
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def device_profiler(logdir: str):
    """A CUDA (and CPU) activity trace of the scope by ``torch.profiler``,
    written as a chrome trace to ``<logdir>/device_trace.json``. Replaces
    the reference's CUPTI DeviceTracer."""
    import os

    import torch
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "device_trace.json"))


def _activities():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _device_events(prof) -> List[Dict]:
    """The CUDA kernel (and memcpy/memset) rows of a finished
    torch.profiler session as flat chrome-trace 'X' events, their
    ``proc`` "cuda"."""
    out = []
    for e in prof.events():
        dev = getattr(e, "device_type", None)
        if dev is None or "CUDA" not in str(dev):
            continue
        tr = e.time_range
        out.append({"name": e.name, "ts": float(tr.start),
                    "dur": float(tr.end - tr.start), "ph": "X",
                    "pid": int(getattr(e, "device_index", 0) or 0),
                    "tid": 0, "proc": "cuda"})
    return out


class MergedProfile:
    """One sorted per-op table + one timeline combining host
    RecordEvents with the card's kernel activity (reference:
    platform/device_tracer.cc:40-74 + profiler.h:153-158, which fold
    CUPTI device records into the CPU event table)."""

    def __init__(self):
        self.host_events: List[Dict] = []
        self.device_events: List[Dict] = []

    def table(self, limit: Optional[int] = None) -> List[Dict]:
        agg: Dict = {}
        for place, evs in (("host", self.host_events),
                           ("device", self.device_events)):
            for e in evs:
                a = agg.setdefault((place, e["name"]),
                                   {"calls": 0, "total_us": 0.0})
                a["calls"] += 1
                a["total_us"] += e["dur"]
        rows = [{"place": k[0], "name": k[1], **v} for k, v in agg.items()]
        rows.sort(key=lambda r: -r["total_us"])
        return rows[:limit] if limit else rows

    def export_chrome_trace(self, path: str):
        """Host and device events in ONE timeline (host pid 0; device
        events under pid 1000 + the card's index)."""
        events = list(self.host_events)
        for e in self.device_events:
            d = dict(e)
            d.pop("proc", None)
            d["pid"] = 1000 + int(d.get("pid", 0))
            events.append(d)
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)

    def __str__(self):
        lines = [f"{'place':8s} {'total ms':>10s} {'calls':>7s}  name"]
        for r in self.table(limit=40):
            lines.append(f"{r['place']:8s} {r['total_us'] / 1e3:10.3f} "
                         f"{r['calls']:7d}  {r['name'][:70]}")
        return "\n".join(lines)


@contextlib.contextmanager
def merged_profile():
    """Capture host RecordEvents AND the card's kernel activity in one
    scope; yields a MergedProfile filled on exit.

        with profiler.merged_profile() as prof:
            train_steps()
        print(prof)                          # one sorted host+device table
        prof.export_chrome_trace("t.json")   # one merged timeline
    """
    import torch

    global _enabled
    prof = MergedProfile()
    with _events_lock:
        prev_events = list(_events)
        _events.clear()
    _enabled = True
    try:
        with torch.profiler.profile(activities=_activities()) as tprof:
            yield prof
    finally:
        _enabled = False
        with _events_lock:
            prof.host_events = list(_events)
            _events.clear()
            _events.extend(prev_events)
    prof.device_events = _device_events(tprof)
