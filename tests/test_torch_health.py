"""The port's circuit breaker and health monitor (resilience/health.py)
against paddle_tpu's, on the CPU.

Each scenario of tests/test_resilience.py:260-460 and :730 is one script
of breaker calls on a virtual clock; the script runs through both
packages' CircuitBreaker and every call's return value and the
snapshot after it must be equal (the half-open probe's PROBE sentinel
included). The constructors refuse the same bad arguments with the same
messages, HealthMonitor snapshots agree, and the port's live breakers
mirror their state into the metrics registry and dump a flight-recorder
bundle when they trip, as the reference's do.
"""
import gc
import json

import pytest

from paddle_tpu.resilience import health as ref_health
from paddle_tpu_torch.observability import flight_recorder as fr
from paddle_tpu_torch.observability.registry import MetricsRegistry
from paddle_tpu_torch.resilience import health

# (constructor kwargs, script): "F" record_failure, "S" record_success,
# "A" allow_request, "R" release_probe, "T<s>" advance the clock s seconds
SCRIPTS = {
    # test_breaker_state_machine_with_virtual_clock
    "state_machine": (dict(failure_threshold=3, reset_timeout_s=10.0),
                      "A F F S F F F A T10 A A F T10 A S A"),
    # test_breaker_straggler_success_while_open_does_not_close
    "straggler_success": (dict(failure_threshold=2, reset_timeout_s=10.0),
                          "F F S A T10 A S"),
    # test_breaker_released_and_lost_probes_do_not_wedge_half_open
    "released_and_lost_probes": (
        dict(failure_threshold=1, reset_timeout_s=5.0),
        "F T5 A A R A A T5 A S R"),
    # test_breaker_error_rate_mode_trips_on_trickle
    "trickle": (dict(failure_threshold=5, reset_timeout_s=10.0,
                     error_rate_threshold=0.3, error_rate_window=12,
                     error_rate_min_samples=6),
                "S S F S S F S S F S S F A"),
    # test_breaker_error_rate_min_samples_floor
    "min_samples_floor": (dict(failure_threshold=100,
                               error_rate_threshold=0.5,
                               error_rate_window=32,
                               error_rate_min_samples=8),
                          "F F F F F F F F"),
    # test_breaker_error_rate_half_open_interaction
    "rate_half_open": (dict(failure_threshold=100, reset_timeout_s=10.0,
                            error_rate_threshold=0.5, error_rate_window=8,
                            error_rate_min_samples=4),
                       "F F F F T10 A S S S F F F T10 A F"),
    # test_breaker_open_stragglers_do_not_poison_window
    "open_stragglers": (dict(failure_threshold=100, reset_timeout_s=10.0,
                             error_rate_threshold=0.5, error_rate_window=8,
                             error_rate_min_samples=4),
                        "F F F F F F F F F F S T10 A S F"),
}


def _run(mod, kwargs, script):
    now = [0.0]
    b = mod.CircuitBreaker(clock=lambda: now[0], **kwargs)
    trace = []
    for step in script.split():
        out = None
        if step == "F":
            b.record_failure()
        elif step == "S":
            b.record_success()
        elif step == "A":
            out = b.allow_request()
        elif step == "R":
            b.release_probe()
        else:
            now[0] += float(step[1:])
        trace.append((step, out, b.state, b.snapshot()))
    return trace


@pytest.fixture(autouse=True)
def _quiet_recorder(tmp_path):
    """The port's default flight recorder dumps into this test's dir."""
    rec = fr.FlightRecorder(dump_dir=str(tmp_path / "flightrec"),
                            min_interval_s=0.0).enable()
    prev = fr.set_flight_recorder(rec)
    yield rec
    rec.disable()
    fr.set_flight_recorder(prev)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_breaker_script_matches_reference(name):
    kwargs, script = SCRIPTS[name]
    ref = _run(ref_health, kwargs, script)
    port = _run(health, kwargs, script)
    assert port == ref
    # every script trips the circuit at least once
    assert port[-1][3]["opened_total"] >= 1


def test_probe_sentinel_is_the_reference_value():
    assert health.PROBE == ref_health.PROBE == "probe"
    trace = dict((i, t) for i, t in enumerate(
        _run(health, *SCRIPTS["released_and_lost_probes"])))
    assert trace[2][1] is health.PROBE and trace[3][1] is False


@pytest.mark.parametrize("kwargs", [
    dict(error_rate_threshold=1.5), dict(error_rate_threshold=0.0),
    dict(error_rate_threshold=0.5, error_rate_min_samples=0),
    dict(error_rate_threshold=0.5, error_rate_window=8,
         error_rate_min_samples=16),
    dict(error_rate_threshold=0.5, error_rate_window=0),
    dict(failure_threshold=0)])
def test_breaker_refuses_what_the_reference_refuses(kwargs):
    with pytest.raises(ValueError) as ref_err:
        ref_health.CircuitBreaker(**kwargs)
    with pytest.raises(ValueError) as port_err:
        health.CircuitBreaker(**kwargs)
    assert str(port_err.value) == str(ref_err.value)
    # rate mode off: the window / floor interplay is irrelevant
    health.CircuitBreaker(error_rate_window=8, error_rate_min_samples=16)


def test_health_monitor_snapshot_matches_reference():
    snaps = []
    for mod in (ref_health, health):
        hm = mod.HealthMonitor(mod.CircuitBreaker(failure_threshold=100),
                               window=10)
        for _ in range(6):
            hm.record_success()
        for _ in range(4):
            hm.record_failure(RuntimeError("boom"))
        assert hm.error_rate == pytest.approx(0.4) and hm.healthy
        snap = json.loads(json.dumps(hm.snapshot()))
        assert snap.pop("last_error_time") is not None
        snaps.append(snap)
    assert snaps[1] == snaps[0]
    assert "boom" in snaps[1]["last_error"]


def test_live_breaker_mirrors_into_registry_and_dumps_on_trip(
        _quiet_recorder):
    b = health.CircuitBreaker(failure_threshold=1)
    label = b._obs_label
    b.record_failure()
    assert not b.allow_request()
    reg = MetricsRegistry()
    snap = reg.snapshot()
    state = {s["labels"]["breaker"]: s["value"] for s in
             snap["paddle_tpu_circuit_breaker_state"]["samples"]}
    assert state[label] == 1.0
    shed = {s["labels"]["breaker"]: s["value"] for s in
            snap["paddle_tpu_circuit_breaker_shed_total"]["samples"]}
    assert shed[label] == 1
    assert [d.rsplit("_", 1)[-1] for d in _quiet_recorder.dumps()] == \
        ["open"]
    with open(_quiet_recorder.dumps()[0] + "/meta.json") as f:
        meta = json.load(f)
    assert meta["reason"] == "circuit_open"
    assert meta["context"]["breaker"] == label
    # a collected breaker's series is pruned at the next scrape
    del b
    gc.collect()
    samples = reg.snapshot()["paddle_tpu_circuit_breaker_state"]["samples"]
    assert label not in {s["labels"]["breaker"] for s in samples}
