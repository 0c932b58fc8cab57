"""Metric registry: Counter/Gauge/Histogram families with labels.

One queryable namespace for every counter the pool keeps — the
provisioner's preview-memo and free-digest hit rates, the collector's
no-op-memo and fused-negotiation counters, the ClassAd LRU caches, the
job-lifecycle histograms, and the negotiation-cycle profiler all
register here (`repro_*` families), and the service tier renders the
whole registry as Prometheus text exposition (`GET /metrics.prom`).

Cost model: a counter child is one attribute increment on a dedicated
object (`child.value += 1` — the same cost as the bespoke int
attributes these families replaced), histogram observation is one
bisect over ~10 edges, and exposition/serialization walk the registry
only when asked.  Gauges that mirror live state (pool depths, cache
sizes) are set by *collect hooks* at exposition time, so an unscraped
registry never polls anything.

The registry serializes (`state_dict`/`load_state`) so snapshot/resume
carries telemetry forward; values are plain floats and label values are
coerced to strings, keeping the state JSON-safe.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Any, Callable, Iterable

# sim-time latency edges (seconds): job wait/run spans 1s..1 day
SIM_SECONDS_BUCKETS = (1.0, 5.0, 15.0, 60.0, 300.0, 1200.0, 3600.0,
                       14400.0, 86400.0)
# wall-time phase edges (seconds): negotiation phases run µs..seconds
WALL_SECONDS_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0)


class Counter:
    """Monotone child; `value` is public for hot-path `+= 1` increments."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0):
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def inc(self, n: float = 1.0):
        self.value += n


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: `le` edges,
    an implicit +Inf bucket, plus running sum and count)."""

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: tuple[float, ...]):
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        self.counts[bisect_right(self.edges, v)] += 1
        self.sum += v
        self.count += 1


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """Named group of children keyed by label-value tuples."""

    def __init__(self, name: str, help: str, kind: str,
                 label_names: tuple[str, ...] = (),
                 buckets: tuple[float, ...] | None = None):
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.help = help
        self.kind = kind
        self.label_names = tuple(label_names)
        self.buckets = tuple(buckets) if buckets is not None else None
        self.children: dict[tuple[str, ...], Any] = {}

    def _make_child(self):
        if self.kind == "histogram":
            return Histogram(self.buckets or SIM_SECONDS_BUCKETS)
        return _KINDS[self.kind]()

    def labels(self, *values) -> Any:
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name} wants labels {self.label_names}, got {key}")
        child = self.children.get(key)
        if child is None:
            child = self.children[key] = self._make_child()
        return child


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(names: Iterable[str], values: Iterable[str],
                extra: tuple[str, str] | None = None) -> str:
    pairs = [(n, v) for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    inner = ",".join(
        '%s="%s"' % (n, v.replace("\\", r"\\").replace('"', r"\"")
                     .replace("\n", r"\n"))
        for n, v in pairs)
    return "{" + inner + "}"


class MetricRegistry:
    def __init__(self):
        self._families: dict[str, MetricFamily] = {}
        self._collect_hooks: list[Callable[[], None]] = []

    # -- family constructors (idempotent: same name returns the family) ------
    def _family(self, name, help, kind, label_names, buckets=None):
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.label_names != tuple(label_names):
                raise ValueError(
                    f"metric {name!r} re-registered with a different "
                    f"kind/labels")
            return fam
        fam = MetricFamily(name, help, kind, tuple(label_names), buckets)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()):
        """Unlabeled: returns the single Counter child.  Labeled: returns
        the family (call `.labels(...)` for children)."""
        fam = self._family(name, help, "counter", labels)
        return fam if labels else fam.labels()

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()):
        fam = self._family(name, help, "gauge", labels)
        return fam if labels else fam.labels()

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] | None = None):
        fam = self._family(name, help, "histogram", labels, buckets)
        return fam if labels else fam.labels()

    def family(self, name: str) -> MetricFamily:
        return self._families[name]

    def get_value(self, name: str, *label_values) -> float:
        """Convenience read of one counter/gauge child (0.0 if the child
        has never been touched)."""
        fam = self._families[name]
        key = tuple(str(v) for v in label_values)
        child = fam.children.get(key)
        return float(child.value) if child is not None else 0.0

    # -- collect hooks (set live-state gauges at exposition time) ------------
    def add_collect_hook(self, fn: Callable[[], None]):
        self._collect_hooks.append(fn)

    def collect(self):
        for fn in self._collect_hooks:
            fn()

    # -- Prometheus text exposition (format version 0.0.4) -------------------
    def prometheus_text(self) -> str:
        self.collect()
        lines: list[str] = []
        for fam in self._families.values():
            lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.children.items():
                if fam.kind == "histogram":
                    cum = 0
                    for edge, n in zip(child.edges, child.counts):
                        cum += n
                        lab = _fmt_labels(fam.label_names, key,
                                          ("le", _fmt(edge)))
                        lines.append(f"{fam.name}_bucket{lab} {cum}")
                    cum += child.counts[-1]
                    lab = _fmt_labels(fam.label_names, key, ("le", "+Inf"))
                    lines.append(f"{fam.name}_bucket{lab} {cum}")
                    lab = _fmt_labels(fam.label_names, key)
                    lines.append(f"{fam.name}_sum{lab} {_fmt(child.sum)}")
                    lines.append(f"{fam.name}_count{lab} {child.count}")
                else:
                    lab = _fmt_labels(fam.label_names, key)
                    lines.append(f"{fam.name}{lab} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> dict:
        fams = {}
        for fam in self._families.values():
            children = []
            for key, child in fam.children.items():
                if fam.kind == "histogram":
                    payload: Any = {"counts": list(child.counts),
                                    "sum": child.sum, "count": child.count}
                else:
                    payload = child.value
                children.append([list(key), payload])
            fams[fam.name] = {
                "kind": fam.kind,
                "help": fam.help,
                "labels": list(fam.label_names),
                "buckets": (list(fam.buckets)
                            if fam.buckets is not None else None),
                "children": children,
            }
        return {"families": fams}

    def load_state(self, state: dict):
        for name, fs in state.get("families", {}).items():
            buckets = fs.get("buckets")
            fam = self._family(
                name, fs.get("help", ""), fs["kind"],
                tuple(fs.get("labels", ())),
                tuple(buckets) if buckets is not None else None)
            for key, payload in fs.get("children", []):
                child = fam.labels(*key)
                if fam.kind == "histogram":
                    child.counts = [int(n) for n in payload["counts"]]
                    child.sum = float(payload["sum"])
                    child.count = int(payload["count"])
                else:
                    child.value = float(payload)
