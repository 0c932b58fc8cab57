"""Unified telemetry: metric registry, lifecycle spans, cycle profiler.

`Telemetry` is the facade the rest of the tree talks to.  The metric
*registry* is always live — the collector/provisioner/classad cache
counters that tests and benchmarks read moved into it, so they must
keep counting whether or not richer telemetry is on.  The `enabled`
flag gates the two pieces with per-event cost: job-lifecycle span
hooks (never installed when disabled) and the wall-clock cycle
profiler (every site guards on `profiler is not None`).

    sim = Simulation(..., telemetry=True)
    sim.telemetry.prometheus_text()   # exposition, also GET /metrics.prom
    sim.dump_trace("trace.json")      # Chrome trace-event JSON (Perfetto)

Snapshot semantics: registry values and the lifecycle event log are
sim-time data and serialize with the simulation; the profiler's
per-cycle wall-clock deques reset on restore (documented in
`Telemetry.state_dict`).
"""
from __future__ import annotations

import json

from .registry import (Counter, Gauge, Histogram, MetricFamily,
                       MetricRegistry, SIM_SECONDS_BUCKETS,
                       WALL_SECONDS_BUCKETS)
from .spans import LifecycleTracker
from .profiler import CycleProfiler

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricRegistry",
    "SIM_SECONDS_BUCKETS", "WALL_SECONDS_BUCKETS",
    "LifecycleTracker", "CycleProfiler", "Telemetry", "as_telemetry",
]

# pool gauges exported on scrape — the same series Recorder samples
# for the Fig 2/3 curves, read live via a registry collect hook.
_POOL_GAUGE_HELP = {
    "idle_jobs": "Idle jobs across all schedds",
    "running_jobs": "Running jobs across all schedds",
    "pending_pods": "Pods submitted but not yet placed",
    "running_pods": "Pods running",
    "ready_workers": "Advertised workers alive and ready",
    "busy_workers": "Workers with at least one claim",
    "live_nodes": "Live nodes across backends",
    "provisioned_cores": "CPU cores provisioned across backends",
    "cost_rate": "Aggregate cost rate across backends",
}


class Telemetry:
    def __init__(self, enabled: bool = True, *,
                 event_log_max: int = 20000, cycle_log_max: int = 4096):
        self.enabled = bool(enabled)
        self.registry = MetricRegistry()
        self.lifecycle = (LifecycleTracker(self.registry,
                                           event_log_max=event_log_max)
                          if self.enabled else None)
        self.profiler = (CycleProfiler(self.registry,
                                       cycle_log_max=cycle_log_max)
                         if self.enabled else None)
        self._sim = None
        self._pool_gauges = None
        self._cache_g = None
        self._mm_buckets_g = None

    # -- wiring --------------------------------------------------------------
    def attach_queue(self, q):
        if self.lifecycle is not None:
            self.lifecycle.attach_queue(q)

    def bind_collector(self, collector):
        if self.lifecycle is not None:
            self.lifecycle.bind_collector(collector)

    def attach_simulation(self, sim):
        """Register scrape-time pool gauges and span hooks on every
        schedd queue.  Pool gauges are registered even when `enabled`
        is False — they cost nothing until someone scrapes."""
        self._sim = sim
        if self._pool_gauges is None:
            self._pool_gauges = {
                name: self.registry.gauge("repro_pool_" + name, help)
                for name, help in _POOL_GAUGE_HELP.items()}
            self.registry.add_collect_hook(self._collect_pool)
            # ClassAd LRU effectiveness, read off the live caches at
            # scrape time (gauges, not counters: restores rebuild the
            # caches cold and counter resets would violate monotonicity)
            self._cache_g = {
                stat: self.registry.gauge(
                    "repro_classad_cache_" + stat,
                    f"ClassAd LRU memo {stat} (live cache object)",
                    ("cache",))
                for stat in ("hits", "misses", "entries")}
            self.registry.add_collect_hook(self._collect_caches)
            # every distinct padding bucket the jitted backend has seen
            # is one XLA trace; this counts ALL of them, including the
            # ones the provisioner's preview path triggers outside any
            # recorded negotiation cycle (which is why it can exceed
            # the profiler's cycle-attributed jit_compiles)
            self._mm_buckets_g = self.registry.gauge(
                "repro_matchmaker_seen_buckets",
                "Distinct padding buckets traced by the matchmaker "
                "backend (== XLA compiles, preview included)",
                ("backend",))
            self.registry.add_collect_hook(self._collect_matchmaker)
        for q in sim.queues:
            self.attach_queue(q)
        self.bind_collector(sim.collector)

    def _collect_pool(self):
        sim = self._sim
        if sim is None:
            return
        g = self._pool_gauges
        g["idle_jobs"].value = float(sim.pool_queue.n_idle())
        g["running_jobs"].value = float(sim.pool_queue.n_running())
        g["pending_pods"].value = float(
            len(sim.cluster_view.pending_pods()))
        g["running_pods"].value = float(
            len(sim.cluster_view.running_pods()))
        g["ready_workers"].value = float(
            len(sim.collector.alive_workers(sim.now)))
        g["busy_workers"].value = float(
            sum(1 for w in sim.collector.workers.values() if w.claimed))
        g["live_nodes"].value = float(
            sum(len(b.cluster.nodes) for b in sim.backends))
        g["provisioned_cores"].value = float(
            sum(n.capacity.get("cpu", 0)
                for b in sim.backends for n in b.cluster.nodes.values()))
        g["cost_rate"].value = float(
            sum(b.cost_rate() for b in sim.backends))

    def _collect_matchmaker(self):
        sim = self._sim
        if sim is None:
            return
        mm = sim.collector.matchmaker
        buckets = getattr(mm, "_seen_buckets", None)
        if buckets is not None:
            name = getattr(mm, "name", type(mm).__name__)
            self._mm_buckets_g.labels(name).value = float(len(buckets))

    def _collect_caches(self):
        sim = self._sim
        if sim is None:
            return
        for cname, cache in (("match", sim.collector._match_cache),
                             ("poll", sim.collector._poll_cache)):
            self._cache_g["hits"].labels(cname).value = float(cache.hits)
            self._cache_g["misses"].labels(cname).value = float(
                cache.misses)
            self._cache_g["entries"].labels(cname).value = float(
                len(cache))

    # -- exporters -----------------------------------------------------------
    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (object form) — load in Perfetto or
        chrome://tracing.  Job spans run on sim-time microseconds
        (pid 1); negotiation/reconcile phases on wall-clock offsets
        from profiler start (pid 2)."""
        if not self.enabled:
            raise ValueError(
                "telemetry is disabled; build with telemetry=True to trace")
        events = self.lifecycle.chrome_events(pid=1)
        events += self.profiler.chrome_events(pid=2)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_trace(self, path: str) -> int:
        trace = self.chrome_trace()
        with open(path, "w") as fh:
            json.dump(trace, fh)
        return len(trace["traceEvents"])

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> dict:
        """Registry values + lifecycle event log (sim-time data, safe to
        resume).  The profiler's wall-clock cycle log is intentionally
        dropped: it measures a process that no longer exists, so a
        restored simulation starts it empty while the cumulative
        phase histograms (registry) carry over."""
        state = {"version": 1, "registry": self.registry.state_dict()}
        if self.lifecycle is not None:
            state["lifecycle"] = self.lifecycle.state_dict()
        return state

    def load_state(self, state: dict):
        self.registry.load_state(state.get("registry", {}))
        if self.lifecycle is not None and "lifecycle" in state:
            self.lifecycle.load_state(state["lifecycle"])


def as_telemetry(value) -> Telemetry:
    """Coerce the `Simulation(telemetry=...)` argument: None/False ->
    disabled shell (registry only), True -> fully enabled, a Telemetry
    instance passes through (shared between sims if you want one
    registry across a fleet)."""
    if isinstance(value, Telemetry):
        return value
    return Telemetry(enabled=bool(value))
