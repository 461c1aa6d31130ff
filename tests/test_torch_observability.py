"""The port's observability core (profiler.py, observability/) against
paddle_tpu's, on the CPU.

- Registry: one scripted sequence of counter / gauge / histogram calls
  (labels, escapes, a nearest-rank window, a broken collector, a
  disabled registry) runs through both packages' MetricsRegistry; the
  Prometheus text exposition and the JSON snapshot are equal, and the
  same bad declarations raise ValueError in both.
- Tracing: span nesting and ids, and the trace args every RecordEvent
  closed under a span carries.
- The profiler's export under concurrent emission, bounded: four threads
  emit BURST events each and 8 exports run meanwhile, under tmp_path
  (the reference's form spins without a bound).
- Attribution: the default peak is the card's (989e12, not a TPU's),
  PADDLE_TPU_PEAK_FLOPS overrides it in both packages, the phase
  listener accumulates pipeline events.
- The flight recorder: bundles under the directory given, rate-limited
  per reason and pruned to max_dumps.
- retry_counters and the retry::<name> events; merged_profile's host
  table on the CPU.
"""
import json
import threading

import pytest

from paddle_tpu import profiler as ref_profiler
from paddle_tpu.observability import attribution as ref_attribution
from paddle_tpu.observability import registry as ref_registry
from paddle_tpu.resilience import retry as ref_retry
from paddle_tpu_torch import profiler
from paddle_tpu_torch.observability import attribution, trace
from paddle_tpu_torch.observability import flight_recorder as fr
from paddle_tpu_torch.observability import registry
from paddle_tpu_torch.resilience import retry

BURST = 200      # events per emitting thread
EXPORTS = 8      # exports while they emit


def _scripted(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("paddle_tpu_rpc_total", "rpcs\nby op", ("op",))
    c.labels(op="get").inc()
    c.labels(op="get").inc(2)
    c.labels(op='p"u\\t').inc()
    reg.counter("paddle_tpu_plain_total", "plain").inc(4)
    g = reg.gauge("paddle_tpu_depth", "depth", ("engine",))
    g.labels(engine="0").set(3.5)
    g.labels(engine="1").set(float("inf"))
    g.labels(engine="2").set(1e20)
    h = reg.histogram("paddle_tpu_lat_seconds", "latency", ("engine",),
                      window=4)
    for v in (0.5, 0.25, 1.0, 2.0, 0.125, 0.75):
        h.labels(engine="0").record(v)
    h.labels(engine="1")  # an empty window renders zeros
    reg.histogram("paddle_tpu_one_seconds", "one sample").record(7.5)
    fam = reg.counter("paddle_tpu_gone_total", "retired", ("engine",))
    fam.labels(engine="a").inc()
    fam.labels(engine="b").inc()
    fam.discard(("a",))
    fam.retain([("b",)])

    def broken_collector(r):
        raise RuntimeError("boom")

    reg.register_collector(broken_collector)
    return reg


def _own(text, names):
    """The exposition blocks of the families in `names`: each package's
    process-wide collectors (live breakers, retry counters of earlier
    tests) add families of their own to every registry."""
    blocks = text.split("# HELP ")
    return [b for b in blocks[1:] if b.split(" ", 1)[0] in names]


SCRIPTED = {"paddle_tpu_rpc_total", "paddle_tpu_plain_total",
            "paddle_tpu_depth", "paddle_tpu_lat_seconds",
            "paddle_tpu_one_seconds", "paddle_tpu_gone_total",
            "paddle_tpu_observability_collector_errors_total"}


def test_exposition_and_snapshot_match_reference():
    ref, port = _scripted(ref_registry), _scripted(registry)
    for _ in range(2):   # the broken collector is isolated every scrape
        text = port.render_prometheus()
        assert _own(text, SCRIPTED) == \
            _own(ref.render_prometheus(), SCRIPTED)
    assert len(_own(text, SCRIPTED)) == len(SCRIPTED)
    assert 'paddle_tpu_observability_collector_errors_total' \
        '{collector="broken_collector"} 2' in text
    assert 'paddle_tpu_rpc_total{op="p\\"u\\\\t"} 1' in text
    assert "# HELP paddle_tpu_rpc_total rpcs\\nby op" in text
    assert {k: v for k, v in port.snapshot().items() if k in SCRIPTED} \
        == {k: v for k, v in ref.snapshot().items() if k in SCRIPTED}
    assert [n for n in port.names() if n in SCRIPTED] == \
        [n for n in ref.names() if n in SCRIPTED]


@pytest.mark.parametrize("bad", [
    ("counter", "bad_name_total", "help", ()),
    ("counter", "paddle_tpu_UpperCase", "help", ()),
    ("counter", "paddle_tpu_ok_total", "", ()),
    ("gauge", "paddle_tpu_g", "help", ("0bad",)),
    ("gauge", "paddle_tpu_ok_total", "help", ()),
    ("counter", "paddle_tpu_ok_total", "help", ("op",)),
    ("counter", "paddle_tpu_ok_total", "different help", ())])
def test_registry_refuses_what_the_reference_refuses(bad):
    kind, name, help_, labels = bad
    errors = []
    for mod in (ref_registry, registry):
        reg = mod.MetricsRegistry()
        reg.counter("paddle_tpu_ok_total", "help")
        with pytest.raises(ValueError) as e:
            getattr(reg, kind)(name, help_, labels)
        errors.append(str(e.value))
    assert errors[1] == errors[0]


def test_labels_monotonic_and_disabled_registry():
    reg = registry.MetricsRegistry()
    fam = reg.counter("paddle_tpu_rpc_total", "rpcs", ("op",))
    with pytest.raises(ValueError):
        fam.labels(method="get")
    with pytest.raises(ValueError):
        fam.inc()
    with pytest.raises(ValueError):
        fam.labels(op="get").inc(-1)
    off = registry.MetricsRegistry(enabled=False)
    c = off.counter("paddle_tpu_x_total", "help")
    c.inc(5)
    assert c.value == 0 and off.names() == []
    assert off.render_prometheus() == "\n"
    h = registry.Histogram(window=8)
    assert h.snapshot() == ref_registry.Histogram(window=8).snapshot()
    h.record(7.5)
    h.record(10.0)
    assert (h.percentile(50), h.percentile(51), h.percentile(0)) == \
        (7.5, 10.0, 7.5)


def test_span_nesting_ids_and_event_args():
    assert trace.current() is None
    profiler.start_profiler()
    try:
        with trace.step_trace(3) as root:
            assert trace.current() is root and root.parent_id is None
            with trace.span("feed") as child:
                assert child.trace_id == root.trace_id
                assert child.parent_id == root.span_id
                with profiler.RecordEvent("pipeline::dispatch",
                                          cat=profiler.CAT_PIPELINE):
                    pass
            assert trace.current() is root
        with profiler.RecordEvent("outside"):
            pass
        # use_span hands a span to another thread without an event
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            _under(root)), daemon=True)
        t.start()
        t.join(timeout=30)
    finally:
        profiler.stop_profiler()
    evs = {e["name"]: e for e in profiler.events()}
    assert evs["pipeline::dispatch"]["args"] == child.wire()
    assert evs["trace::step/3"]["args"]["span_id"] == root.span_id
    assert evs["span::feed"]["cat"] == profiler.CAT_TRACE
    assert "args" not in evs["outside"]
    assert seen == [root.wire()]
    assert trace.current() is None
    with trace.step_trace(4) as other:
        assert other.trace_id != root.trace_id


def _under(ctx):
    with trace.use_span(ctx):
        with profiler.RecordEvent("handoff"):
            pass
    return [e for e in profiler.events()
            if e["name"] == "handoff"][0]["args"]


def test_export_chrome_trace_under_bounded_concurrent_emission(tmp_path):
    """Exports taken while four threads emit BURST events each load as
    whole JSON; after the threads end the last export holds every
    event."""
    profiler.start_profiler()
    go = threading.Event()

    def emit():
        go.wait(timeout=30)
        for _ in range(BURST):
            with profiler.RecordEvent("spin", cat="test"):
                pass

    threads = [threading.Thread(target=emit, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    try:
        go.set()
        for i in range(EXPORTS):
            path = tmp_path / f"trace_{i}.json"
            profiler.export_chrome_trace(str(path))
            with open(path) as f:
                data = json.load(f)
            assert all(e["name"] == "spin" for e in data["traceEvents"])
    finally:
        for t in threads:
            t.join(timeout=60)
        profiler.stop_profiler(profile_path=str(tmp_path / "last.json"))
    with open(tmp_path / "last.json") as f:
        assert len(json.load(f)["traceEvents"]) == 4 * BURST
    assert profiler.summary(cat="test")["spin"]["calls"] == 4 * BURST


def test_peak_is_the_cards_and_the_override_reads_alike(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    assert attribution.PEAK_FLOPS_DEFAULT == 989e12
    assert attribution.peak_flops() == 989e12
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1.5e12")
    assert attribution.peak_flops() == ref_attribution.peak_flops() \
        == 1.5e12
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "not a number")
    assert attribution.peak_flops() == 989e12
    from paddle_tpu_torch import flags
    assert float(flags.FLAGS["PADDLE_TPU_PEAK_FLOPS"][0]) == 989e12


def test_phase_listener_and_attribution_gauges():
    attribution.drain_phases()
    with profiler.RecordEvent("pipeline::dispatch",
                              cat=profiler.CAT_PIPELINE):
        pass
    with profiler.RecordEvent("pipeline::prefetch_fill",
                              cat=profiler.CAT_PIPELINE):
        pass
    phases = attribution.drain_phases()
    assert set(phases) == {"dispatch"} and phases["dispatch"] >= 0.0
    prev = attribution.set_attribution_enabled(False)
    try:
        assert not attribution.attribution_enabled()
        with profiler.RecordEvent("pipeline::dispatch",
                                  cat=profiler.CAT_PIPELINE):
            pass
        assert attribution.drain_phases() == {}
    finally:
        attribution.set_attribution_enabled(prev)
    reg = registry.MetricsRegistry()
    attribution.mfu_gauge(reg, "engine_x").set(0.25)
    attribution.model_flops_gauge(reg, "engine_x").set(1e9)
    attribution.phase_histogram(reg).labels(phase="device").record(0.1)
    ref_reg = ref_registry.MetricsRegistry()
    ref_attribution.mfu_gauge(ref_reg, "engine_x").set(0.25)
    ref_attribution.model_flops_gauge(ref_reg, "engine_x").set(1e9)
    ref_attribution.phase_histogram(ref_reg).labels(
        phase="device").record(0.1)
    attr = {"paddle_tpu_mfu", "paddle_tpu_model_flops",
            "paddle_tpu_step_phase_seconds"}
    assert _own(reg.render_prometheus(), attr) == \
        _own(ref_reg.render_prometheus(), attr)
    assert len(_own(reg.render_prometheus(), attr)) == 3


def test_flight_recorder_bundles_rate_limit_and_prune(tmp_path):
    rec = fr.FlightRecorder(capacity=3, dump_dir=str(tmp_path / "fr"),
                            max_dumps=2, min_interval_s=3600.0).enable()
    try:
        for i in range(5):
            with profiler.RecordEvent(f"ev{i}", cat=profiler.CAT_SERVING):
                pass
        assert [e["name"] for e in rec.events()] == ["ev2", "ev3", "ev4"]
        first = rec.trigger("rollback", exc=RuntimeError("x"),
                            context={"host": "0"})
        assert first is not None
        assert rec.trigger("rollback") is None      # rate-limited
        rec.min_interval_s = 0.0
        for reason in ("shed_storm", "circuit_open"):
            rec.trigger(reason)
        dumps = rec.dumps()
        assert len(dumps) == 2 and first not in dumps   # pruned
        with open(dumps[-1] + "/meta.json") as f:
            meta = json.load(f)
        assert meta["reason"] == "circuit_open" and meta["num_events"] == 3
        with open(dumps[-1] + "/trace.json") as f:
            assert len(json.load(f)["traceEvents"]) == 3
    finally:
        rec.disable()
    assert rec.trigger("rollback") is None          # disabled: no-op
    with pytest.raises(ValueError):
        fr.FlightRecorder(max_dumps=0)


def test_retry_counters_and_events_match_reference():
    out = []
    for mod, prof in ((ref_retry, ref_profiler), (retry, profiler)):
        mod.reset_retry_counters()
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("transient")
            return "ok"

        prof.start_profiler()
        try:
            p = mod.RetryPolicy(max_attempts=4, base_delay_s=0.0,
                                sleep=lambda s: None)
            assert p.call(flaky, name="t_obs") == "ok"
        finally:
            prof.stop_profiler()
        events = [e["name"] for e in prof.events(
            cat=prof.CAT_RESILIENCE)]
        out.append((mod.retry_counters(), events))
    assert out[1] == out[0]
    assert out[1][0]["t_obs"] == {"calls": 1, "retries": 2, "failures": 0}
    reg = registry.MetricsRegistry()
    assert 'paddle_tpu_retry_retries_total{op="t_obs"} 2' in \
        reg.render_prometheus()


def test_merged_profile_host_table_on_the_cpu(tmp_path):
    with profiler.merged_profile() as prof:
        with profiler.RecordEvent("serving::batch_run[4]",
                                  cat=profiler.CAT_SERVING):
            pass
    rows = prof.table()
    assert rows[0]["place"] == "host" and rows[0]["calls"] == 1
    assert prof.device_events == []    # no card: no kernel rows
    prof.export_chrome_trace(str(tmp_path / "merged.json"))
    with open(tmp_path / "merged.json") as f:
        assert json.load(f)["traceEvents"][0]["name"] == \
            "serving::batch_run[4]"
    assert "serving::batch_run[4]" in str(prof)
