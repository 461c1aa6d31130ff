"""Live performance attribution: MFU gauges and the step-phase
breakdown, fed by the always-on profiler event listener.

The port's copy of ``paddle_tpu/observability/attribution.py``. The
static cost model (``analysis/cost_model.py``) says how many FLOPs one
step SHOULD execute; this module divides that by measured wall time and
the device peak to publish a live ``paddle_tpu_mfu`` gauge per job (each
serving and generation engine), plus a
``paddle_tpu_step_phase_seconds{phase=...}`` histogram family that
partitions a training step's wall time into:

    feed           inline reader + feed assembly (pipeline::host_blocked)
    prefetch_wait  consumer stalls on the FeedPrefetcher
    dispatch       enqueueing the step
    fetch_sync     device->host materialization of fetched values
    device         the residual: wall time not accounted to any host
                   phase

The phase feed comes from ``profiler.add_event_listener``: CAT_PIPELINE
events accumulate into a process-wide bucket a training loop drains
once per dispatch (the port's Trainer does not publish the phases yet:
ROADMAP A11). Always-on; the kill switches are a disabled default
registry, or ``PADDLE_TPU_ATTRIBUTION=0``.

The peak is the card's: ``PEAK_FLOPS_DEFAULT`` is the NVIDIA H100 SXM's
dense bf16 tensor-core rate, 989e12 FLOP/s (the card as nvidia-smi
names it: "NVIDIA H100 80GB HBM3, 700.00 W"), the figure chip_smoke.py's
bounds use. ``PADDLE_TPU_PEAK_FLOPS`` overrides it (read per call); on a
CPU the gauge is self-consistent but not meaningful as an absolute.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from .. import profiler

__all__ = ["PHASES", "PHASE_BY_EVENT", "peak_flops",
           "attribution_enabled", "set_attribution_enabled",
           "drain_phases", "mfu_gauge", "model_flops_gauge",
           "phase_histogram"]

#: NVIDIA H100 80GB HBM3 (700 W) dense bf16 tensor-core peak, FLOP/s;
#: PADDLE_TPU_PEAK_FLOPS overrides for other cards or power limits.
PEAK_FLOPS_DEFAULT = 989e12


def peak_flops() -> float:
    """Device peak FLOP/s the MFU gauge is normalized against (env
    ``PADDLE_TPU_PEAK_FLOPS``, read per call so tests/benchmarks can
    flip it)."""
    try:
        return float(os.environ.get("PADDLE_TPU_PEAK_FLOPS",
                                    PEAK_FLOPS_DEFAULT))
    except ValueError:
        return PEAK_FLOPS_DEFAULT


_enabled_override: Optional[bool] = None


def attribution_enabled() -> bool:
    """Kill switch for MFU/phase publication: a programmatic override
    (``set_attribution_enabled``) wins, else ``PADDLE_TPU_ATTRIBUTION``
    (default on). The metrics-registry ``enabled=False`` arm disables
    it too, since every instrument here lives in the registry."""
    if _enabled_override is not None:
        return _enabled_override
    on = os.environ.get("PADDLE_TPU_ATTRIBUTION", "1") != "0"
    if on and not profiler.has_event_listener(_phase_listener):
        # env flipped 0 -> 1 after import: install the listener now, or
        # the phase buckets stay empty and every step reads as 100%
        # device while the MFU gauges publish
        profiler.add_event_listener(_phase_listener)
    return on


def set_attribution_enabled(v: Optional[bool]) -> Optional[bool]:
    """Override the env toggle (None restores env-driven behaviour) —
    the A/B lever for benchmarks/telemetry_overhead.py. Also installs/
    removes the profiler event listener, so the disabled arm restores
    the listener-free hot path (one list truthiness test per event).
    Returns the previous override so callers can restore it."""
    global _enabled_override
    prev = _enabled_override
    _enabled_override = None if v is None else bool(v)
    _sync_listener()
    return prev


#: the published phase set, in scrape-stable order
PHASES = ("feed", "dispatch", "device", "fetch_sync", "prefetch_wait")

#: CAT_PIPELINE event name -> phase. pipeline::prefetch_fill (producer-
#: thread convert+upload) is deliberately absent: that work OVERLAPS
#: device compute, so charging it to the step's serial breakdown would
#: double-count hidden time.
PHASE_BY_EVENT = {
    "pipeline::host_blocked": "feed",
    "pipeline::prefetch_wait": "prefetch_wait",
    "pipeline::dispatch": "dispatch",
    "pipeline::fetch_sync": "fetch_sync",
}


class _PhaseAccumulator:
    """Thread-safe per-phase second totals since the last drain."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seconds: Dict[str, float] = {}

    def add(self, phase: str, seconds: float) -> None:
        with self._lock:
            self._seconds[phase] = self._seconds.get(phase, 0.0) + seconds

    def drain(self) -> Dict[str, float]:
        with self._lock:
            out, self._seconds = self._seconds, {}
        return out


_acc = _PhaseAccumulator()


def _phase_listener(ev: Dict) -> None:
    # attribution_enabled() re-checked per event: belt-and-braces for
    # an env flip after the listener was installed
    if ev.get("cat") != profiler.CAT_PIPELINE or not attribution_enabled():
        return
    phase = PHASE_BY_EVENT.get(ev["name"])
    if phase is not None:
        _acc.add(phase, ev["dur"] / 1e6)


def _sync_listener() -> None:
    """Install the phase listener only while attribution is on, so the
    kill switch restores profiler.py's listener-free disabled path
    (RecordEvent never builds the event dict). Env-var flips AFTER
    import self-heal: 1 -> 0 leaves the listener installed but inert
    (the per-event check above); 0 -> 1 re-installs it at the next
    attribution_enabled() call."""
    if attribution_enabled():
        profiler.add_event_listener(_phase_listener)
    else:
        profiler.remove_event_listener(_phase_listener)


_sync_listener()


def drain_phases() -> Dict[str, float]:
    """Host-phase seconds accumulated since the last drain (the Trainer
    calls this once per dispatch, and once at train() start to reset
    the window)."""
    return _acc.drain()


# ---------------------------------------------------------------------------
# instrument declarations — defined ONCE so the trainer and every
# serving engine agree on name/help/labels (the registry rejects
# conflicting re-registration)
# ---------------------------------------------------------------------------
_MFU_HELP = ("Model FLOPs utilization of the most recent step/batch: "
             "static cost-model FLOPs / wall time / device peak "
             "(PADDLE_TPU_PEAK_FLOPS).")
_FLOPS_HELP = ("Static cost-model FLOPs per step of the currently "
               "compiled program for this job.")
_PHASE_HELP = ("Per-step wall-time breakdown by phase (feed, dispatch, "
               "device, fetch_sync, prefetch_wait); the phases of one "
               "step sum to its wall time, device is the host-side "
               "residual.")


def mfu_gauge(reg, job: str):
    return reg.gauge("paddle_tpu_mfu", _MFU_HELP, ("job",)) \
        .labels(job=job)


def model_flops_gauge(reg, job: str):
    return reg.gauge("paddle_tpu_model_flops", _FLOPS_HELP, ("job",)) \
        .labels(job=job)


def phase_histogram(reg):
    return reg.histogram("paddle_tpu_step_phase_seconds", _PHASE_HELP,
                         ("phase",))
