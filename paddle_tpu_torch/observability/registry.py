"""Process-wide metrics registry: labeled counters, gauges, and
windowed histograms behind one scrapeable namespace.

The port's copy of ``paddle_tpu/observability/registry.py``, unchanged in
behaviour: the same validated ``paddle_tpu_*`` names, mandatory help
text and exposition types, so one scrape of either package reads alike.

- A *family* is (name, help, type, label names); a *child* is one
  labeled time series inside it. Unlabeled families delegate
  ``inc/set/record`` straight to their single child.
- Histograms keep a bounded most-recent window and answer percentile
  queries with the **nearest-rank** method (see ``Histogram.percentile``
  for the boundary contract: empty -> 0.0, a single sample answers
  every quantile). They render as Prometheus *summaries* (p50/p90/p99
  quantile samples + ``_sum``/``_count``).
- *Collectors* adapt pull-model producers (``retry_counters()``, live
  CircuitBreakers): each registered callback runs at scrape/snapshot
  time and mirrors its source into registry instruments. Global
  collectors run against EVERY registry, so swapping the default
  registry never loses the resilience series.
- ``MetricsRegistry(enabled=False)`` hands out shared no-op
  instruments (the "off" arm of an overhead measurement).

Thread-safety: instrument creation, child lookup, mutation, and
rendering all take fine-grained locks; ``render_prometheus()`` can run
concurrently with serving workers and the training loop.
"""
from __future__ import annotations

import collections
import math
import re
import threading
import weakref
from typing import (Callable, Deque, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

__all__ = ["METRIC_NAME_RE", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "CounterFamily", "GaugeFamily", "HistogramFamily",
           "default_registry", "set_default_registry",
           "add_global_collector"]

#: every metric name must match this — enforced at registration so
#: ad-hoc names cannot drift in.
METRIC_NAME_RE = re.compile(r"^paddle_tpu_[a-z0-9_]+$")
_LABEL_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

#: summary quantiles rendered per histogram child
_QUANTILES = ((0.5, 50.0), (0.9, 90.0), (0.99, 99.0))


def _nearest_rank(sorted_vals: Sequence[float], p: float) -> float:
    """Nearest-rank percentile over an already-sorted window: rank =
    ceil(p/100 * n), clamped to 1..n; empty -> 0.0. The ONE place the
    boundary contract lives (Histogram docstring documents it)."""
    if not sorted_vals:
        return 0.0
    p = min(100.0, max(0.0, float(p)))
    rank = min(len(sorted_vals),
               max(1, math.ceil(p / 100.0 * len(sorted_vals))))
    return sorted_vals[rank - 1]


# ---------------------------------------------------------------------------
# children (one labeled time series each; standalone-constructible, so
# serving code that wants a detached counter can still build one)
# ---------------------------------------------------------------------------
class Counter:
    """Monotonic counter."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._v += n

    def set_total(self, v):
        """Collector mirror: overwrite with an externally accumulated
        total (e.g. retry_counters()). A DECREASE is passed through
        deliberately: it means the source was reset, and Prometheus
        rate()/increase() treat a dropped counter as a reset — clamping
        instead would silently hide all post-reset activity until the
        old maximum was re-crossed."""
        with self._lock:
            self._v = v

    @property
    def value(self):
        return self._v


class Gauge:
    """Last-set value (queue depth, breaker state, toggles)."""

    __slots__ = ("_v",)

    def __init__(self):
        self._v = 0.0

    def set(self, v: float):
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Bounded-reservoir histogram: the most recent ``window``
    observations, plus lifetime count/sum.

    Percentiles use the nearest-rank method over the current window:
    rank = ceil(p/100 * n), 1-based into the sorted window. The window
    boundaries are part of the contract:

    - empty window  -> 0.0 for every quantile (there is no observation
      to report; exposition still emits the quantile samples so the
      series shape is stable from the first scrape)
    - single sample -> that sample for EVERY quantile (rank clamps to
      1..n, so p0 and p99.9 alike answer the only datum — no
      interpolation against a value that was never observed)
    - ``p`` is clamped to [0, 100]; p=0 reports the window minimum.

    """

    __slots__ = ("_vals", "_count", "_sum", "_lock")

    def __init__(self, window: int = 8192):
        if window < 1:
            raise ValueError(f"histogram window must be >= 1, got {window}")
        self._vals: Deque[float] = collections.deque(maxlen=window)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def record(self, v: float):
        v = float(v)
        with self._lock:
            self._vals.append(v)
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def quantiles(self, ps: Sequence[float]) -> List[float]:
        """Nearest-rank values for several percentiles with ONE locked
        sort of the window (see the class docstring for the
        empty/single-sample boundary contract) — the shared primitive
        under percentile(), snapshot(), and the exposition renderer."""
        with self._lock:
            vals = sorted(self._vals)
        return [_nearest_rank(vals, p) for p in ps]

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the current window."""
        return self.quantiles((p,))[0]

    def snapshot(self) -> Dict[str, float]:
        """JSON-able {count, mean, p50, p90, p99} (nearest-rank)."""
        p50, p90, p99 = self.quantiles((50.0, 90.0, 99.0))
        return {"count": self._count, "mean": round(self.mean, 6),
                "p50": round(p50, 6), "p90": round(p90, 6),
                "p99": round(p99, 6)}


class _NullInstrument:
    """Shared no-op child AND family for a disabled registry: every
    mutator swallows its arguments, every reader answers zero."""

    def labels(self, **kv):
        return self

    def retain(self, keys):
        pass

    def discard(self, key):
        pass

    def samples(self):
        return []

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def set_total(self, v):
        pass

    def record(self, v):
        pass

    def percentile(self, p):
        return 0.0

    def snapshot(self):
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0,
                "p99": 0.0}

    value = 0
    count = 0
    sum = 0.0
    mean = 0.0


_NULL = _NullInstrument()


# ---------------------------------------------------------------------------
# families
# ---------------------------------------------------------------------------
class _Family:
    """One named metric family; children keyed by label-value tuples."""

    exposition_type = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 child_factory: Callable[[], object]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._child_factory = child_factory
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, **kv):
        """Get-or-create the child for these label values. Label keys
        must exactly match the family's declared label names."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} do not match declared "
                f"label names {sorted(self.labelnames)}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child_factory()
            return child

    def retain(self, keys: Iterable[Tuple[str, ...]]):
        """Drop children NOT in ``keys`` — collectors mirroring
        per-instance sources (live breakers) prune series whose owner
        was garbage-collected."""
        keep = set(keys)
        with self._lock:
            for k in [k for k in self._children if k not in keep]:
                del self._children[k]

    def discard(self, key: Tuple[str, ...]):
        """Drop ONE child series if present — the inverse of labels()
        for producers that retire a label value (e.g. a ModelHost
        dropping a retired engine's series so long-lived swap cycles
        do not grow scrape cardinality without bound)."""
        with self._lock:
            self._children.pop(tuple(str(k) for k in key), None)

    def samples(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is declared with labels {self.labelnames}; "
                "use .labels(...) to pick a series")
        return self.labels()


class CounterFamily(_Family):
    exposition_type = "counter"

    def __init__(self, name, help, labelnames):
        super().__init__(name, help, labelnames, Counter)

    def inc(self, n=1):
        self._default_child().inc(n)

    @property
    def value(self):
        return self._default_child().value


class GaugeFamily(_Family):
    exposition_type = "gauge"

    def __init__(self, name, help, labelnames):
        super().__init__(name, help, labelnames, Gauge)

    def set(self, v):
        self._default_child().set(v)

    @property
    def value(self):
        return self._default_child().value


class HistogramFamily(_Family):
    #: windowed histograms render as summaries (quantiles + sum/count)
    exposition_type = "summary"

    def __init__(self, name, help, labelnames, window=8192):
        self.window = int(window)
        super().__init__(name, help, labelnames,
                         lambda: Histogram(window=self.window))

    def record(self, v):
        self._default_child().record(v)

    def percentile(self, p):
        return self._default_child().percentile(p)

    def snapshot(self):
        return self._default_child().snapshot()


_FAMILY_TYPES = {"counter": CounterFamily, "gauge": GaugeFamily,
                 "summary": HistogramFamily}


# ---------------------------------------------------------------------------
# global collectors: pull-model producers that must survive a default-
# registry swap (each registry runs them against ITSELF at scrape time)
# ---------------------------------------------------------------------------
_global_collectors: List[Callable[["MetricsRegistry"], None]] = []
_global_collectors_lock = threading.Lock()


def add_global_collector(fn: Callable[["MetricsRegistry"], None]) -> None:
    """Register ``fn(registry)`` to run at every registry's scrape/
    snapshot time. The callback mirrors an external source into
    instruments it gets-or-creates on the registry it is handed
    (resilience.retry and resilience.health register theirs at import)."""
    with _global_collectors_lock:
        if fn not in _global_collectors:
            _global_collectors.append(fn)


class MetricsRegistry:
    """Named, validated, scrapeable metric families.

    ``enabled=False`` builds a registry whose instruments are shared
    no-ops: registration returns immediately, nothing is recorded, and
    rendering emits an empty exposition — the control arm for measuring
    instrumentation overhead.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._families: "collections.OrderedDict[str, _Family]" = \
            collections.OrderedDict()
        self._collectors: List[Tuple[Callable, Optional[weakref.ref]]] = []
        self._lock = threading.RLock()

    # -- registration ---------------------------------------------------
    def _get_or_create(self, typ: str, name: str, help: str,
                       labelnames: Sequence[str], **kw):
        if not self.enabled:
            return _NULL
        if not METRIC_NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} does not match "
                f"{METRIC_NAME_RE.pattern!r} — all metrics are namespaced "
                "paddle_tpu_* (lowercase, digits, underscores)")
        if not help or not help.strip():
            raise ValueError(f"metric {name!r} needs non-empty help text")
        labelnames = tuple(labelnames)
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln):
                raise ValueError(
                    f"metric {name!r}: bad label name {ln!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                # EVERY declared attribute must match on re-registration
                # — two producers silently disagreeing on help text or
                # histogram window is exactly the drift this registry
                # exists to prevent. Read-only access goes via get().
                mismatch = None
                if fam.exposition_type != typ:
                    mismatch = f"type {fam.exposition_type} != {typ}"
                elif fam.labelnames != labelnames:
                    mismatch = f"labels {fam.labelnames} != {labelnames}"
                elif fam.help != help:
                    mismatch = "help text differs"
                elif kw.get("window") is not None and \
                        kw["window"] != fam.window:
                    mismatch = f"window {fam.window} != {kw['window']}"
                if mismatch:
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        f"conflicting declaration ({mismatch}); use "
                        "registry.get() for read-only access")
                return fam
            fam = _FAMILY_TYPES[typ](name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def get(self, name: str):
        """The registered family for ``name``, or None — read-only
        access that does not require repeating the declaration."""
        with self._lock:
            return self._families.get(name)

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> CounterFamily:
        return self._get_or_create("counter", name, help, labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> GaugeFamily:
        return self._get_or_create("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  window: int = 8192) -> HistogramFamily:
        return self._get_or_create("summary", name, help, labelnames,
                                   window=window)

    # -- collectors -----------------------------------------------------
    def register_collector(self, fn: Callable[["MetricsRegistry"], None],
                           owner: Optional[object] = None) -> None:
        """Instance-local collector; with ``owner``, pruned automatically
        once the owner is garbage-collected."""
        with self._lock:
            self._collectors.append(
                (fn, weakref.ref(owner) if owner is not None else None))

    def _run_collectors(self) -> None:
        if not self.enabled:
            return
        with _global_collectors_lock:
            global_fns = list(_global_collectors)
        with self._lock:
            live = [(fn, ref) for fn, ref in self._collectors
                    if ref is None or ref() is not None]
            self._collectors = live
            local_fns = [fn for fn, _ in live]
        for fn in global_fns + local_fns:
            try:
                fn(self)
            except Exception:
                # one broken collector must not make every healthy
                # family unscrapeable (mirrors /statusz's per-provider
                # isolation); the failure is surfaced as its own
                # series, so a scrape shows WHICH mirror is broken
                # instead of silently missing data
                self.counter(
                    "paddle_tpu_observability_collector_errors_total",
                    "Collector callbacks that raised during a scrape/"
                    "snapshot, by callback name.", ("collector",)
                ).labels(collector=getattr(
                    fn, "__name__", repr(fn))).inc()

    # -- introspection / exposition ------------------------------------
    def families(self, run_collectors: bool = True) -> List[_Family]:
        if run_collectors:
            self._run_collectors()
        with self._lock:
            return list(self._families.values())

    def names(self) -> List[str]:
        with self._lock:
            return list(self._families)

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-able dump of every family (the /statusz payload)."""
        out: Dict[str, Dict] = {}
        for fam in self.families():
            samples = []
            for key, child in fam.samples():
                labels = dict(zip(fam.labelnames, key))
                if isinstance(child, Histogram):
                    samples.append({"labels": labels,
                                    **child.snapshot(),
                                    "sum": round(child.sum, 6)})
                else:
                    samples.append({"labels": labels,
                                    "value": child.value})
            out[fam.name] = {"help": fam.help,
                             "type": fam.exposition_type,
                             "samples": samples}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        lines: List[str] = []
        for fam in self.families():
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.exposition_type}")
            for key, child in fam.samples():
                labels = list(zip(fam.labelnames, key))
                if isinstance(child, Histogram):
                    qvals = child.quantiles([p for _, p in _QUANTILES])
                    for (q, _), v in zip(_QUANTILES, qvals):
                        lines.append(_sample_line(
                            fam.name, labels + [("quantile", repr(q))],
                            v))
                    lines.append(_sample_line(f"{fam.name}_sum", labels,
                                              child.sum))
                    lines.append(_sample_line(f"{fam.name}_count", labels,
                                              child.count))
                else:
                    lines.append(_sample_line(fam.name, labels,
                                              child.value))
        return "\n".join(lines) + "\n"


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _sample_line(name: str, labels: Sequence[Tuple[str, str]], value) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                        for k, v in labels)
        return f"{name}{{{body}}} {_format_value(value)}"
    return f"{name} {_format_value(value)}"


# ---------------------------------------------------------------------------
# process default
# ---------------------------------------------------------------------------
_default = MetricsRegistry()
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every built-in producer publishes to."""
    return _default


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests, the overhead benchmark); returns
    the previous registry so callers can restore it. Producers that
    CACHE instruments re-resolve on their next use; producers that
    captured children at construction (a ServingMetrics built earlier)
    keep publishing to the old registry — build them after the swap."""
    global _default
    with _default_lock:
        prev, _default = _default, reg
    return prev
