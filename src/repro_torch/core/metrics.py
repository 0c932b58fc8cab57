"""Time-series + summary metrics for the provisioning experiments.

Records per-tick gauges (queue depth, pods pending/running, workers busy,
nodes live) and derives the paper's headline quantities:

  * demand-tracking lag (Fig 3): time from a job arriving idle to a worker
    slot being available for its group
  * harvested compute (Fig 2): busy resource-seconds on provisioned pods
  * utilization / waste: busy / alive on workers, empty-node fraction
  * scale-down latency (C2): worker idle time before self-termination
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Recorder:
    """Gauge time-series store.

    Sampling cadence is the CALLER's business (the event engine installs
    its own periodic metrics callback; see simulation.py); as a guard for
    tick-loop callers that record every step, an optional
    `sample_interval_s` rate-limits aggregate samples so recording cost is
    decoupled from tick cadence at 100k-job scale."""

    series: dict[str, list[tuple[float, float]]] = dataclasses.field(
        default_factory=dict)
    sample_interval_s: float | None = None
    _last_sample: float = dataclasses.field(default=-1e18, repr=False)

    def _sample_ok(self, now: float) -> bool:
        """Shared rate-limit gate: aggregate and per-backend series stay
        on the SAME sample grid (a timestamp either records everywhere or
        nowhere)."""
        if self.sample_interval_s is None:
            return True
        if now == self._last_sample:      # same instant as an accepted one
            return True
        if now - self._last_sample >= self.sample_interval_s - 1e-9:
            self._last_sample = now
            return True
        return False

    def record(self, now: float, **gauges: float):
        if not self._sample_ok(now):
            return
        for key, val in gauges.items():
            self.series.setdefault(key, []).append((now, float(val)))

    # -- per-backend series (federation) -----------------------------------
    def record_backend(self, now: float, backend: str, **gauges: float):
        """Record gauges attributed to one scaling backend; stored under
        ``key@backend`` so aggregate keys stay untouched.  Honours the
        same sampling grid as `record`."""
        if not self._sample_ok(now):
            return
        for key, val in gauges.items():
            self.series.setdefault(f"{key}@{backend}", []).append(
                (now, float(val)))

    def backend_values(self, key: str, backend: str) -> list[float]:
        return self.values(f"{key}@{backend}")

    def backends_recorded(self) -> list[str]:
        return sorted({k.split("@", 1)[1] for k in self.series
                       if "@" in k and "@schedd:" not in k
                       and "@user:" not in k})

    # -- per-schedd / per-user series (flocking fair-share) ------------------
    def record_schedd(self, now: float, schedd: str, **gauges: float):
        """Gauges attributed to one submit host, stored under
        ``key@schedd:<name>`` (same sampling grid as `record`)."""
        if not self._sample_ok(now):
            return
        for key, val in gauges.items():
            self.series.setdefault(f"{key}@schedd:{schedd}", []).append(
                (now, float(val)))

    def record_user(self, now: float, user: str, **gauges: float):
        """Gauges attributed to one submitter (pool-global, like the
        accountant's ledger), stored under ``key@user:<name>``."""
        if not self._sample_ok(now):
            return
        for key, val in gauges.items():
            self.series.setdefault(f"{key}@user:{user}", []).append(
                (now, float(val)))

    def schedd_values(self, key: str, schedd: str) -> list[float]:
        return self.values(f"{key}@schedd:{schedd}")

    def user_values(self, key: str, user: str) -> list[float]:
        return self.values(f"{key}@user:{user}")

    def schedds_recorded(self) -> list[str]:
        return sorted({k.split("@schedd:", 1)[1] for k in self.series
                       if "@schedd:" in k})

    def users_recorded(self) -> list[str]:
        return sorted({k.split("@user:", 1)[1] for k in self.series
                       if "@user:" in k})

    def values(self, key: str) -> list[float]:
        return [v for _, v in self.series.get(key, [])]

    def times(self, key: str) -> list[float]:
        return [t for t, _ in self.series.get(key, [])]

    def last(self, key: str, default: float = 0.0) -> float:
        s = self.series.get(key)
        return s[-1][1] if s else default

    def integral(self, key: str) -> float:
        """Trapezoid integral of a gauge over time."""
        s = self.series.get(key, [])
        out = 0.0
        for (t0, v0), (t1, v1) in zip(s, s[1:]):
            out += 0.5 * (v0 + v1) * (t1 - t0)
        return out

    def mean(self, key: str) -> float:
        v = self.values(key)
        return sum(v) / len(v) if v else 0.0

    def max(self, key: str) -> float:
        v = self.values(key)
        return max(v) if v else 0.0

    # -- derived summaries ------------------------------------------------------
    def tracking_lag(self, demand_key: str, supply_key: str,
                     threshold: float = 0.95) -> float:
        """Mean time for supply to reach `threshold`×(new demand level) after
        each upward demand step."""
        dem = self.series.get(demand_key, [])
        sup = self.series.get(supply_key, [])
        if not dem or not sup:
            return 0.0
        lags = []
        prev = dem[0][1]
        for (t, v) in dem[1:]:
            if v > prev:  # upward step
                target = threshold * v
                t_hit = None
                for (ts, vs) in sup:
                    if ts >= t and vs >= target:
                        t_hit = ts
                        break
                if t_hit is not None:
                    lags.append(t_hit - t)
            prev = v
        return sum(lags) / len(lags) if lags else 0.0


def percentile(vals: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) of an unsorted list."""
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]


def summarize_jobs(completed: list, now: float) -> dict[str, Any]:
    if not completed:
        return {"n": 0}
    waits = [j.started_at - j.submitted_at for j in completed
             if j.started_at >= 0]
    wasted = sum(j.wasted_s for j in completed)
    done_work = sum(j.runtime_s for j in completed)
    return {
        "n": len(completed),
        "mean_wait_s": sum(waits) / len(waits) if waits else 0.0,
        "p95_wait_s": sorted(waits)[int(0.95 * (len(waits) - 1))]
        if waits else 0.0,
        "preemptions": sum(j.preempt_count for j in completed),
        "wasted_s": wasted,
        "goodput": done_work / (done_work + wasted)
        if done_work + wasted > 0 else 1.0,
    }


class CompletedStats:
    """Streaming completed-job aggregator for trace replay at scale.

    Installed as a `JobQueue.add_complete_hook` observer (usually with
    ``queue.keep_completed = False``): it folds each completion into
    scalar accumulators plus a wait-time sample — plain floats, so a
    100k-job campaign costs one small list, not 100k retained `Job`
    objects.  `summary()` yields the wait-time percentiles and
    core/GPU-hour totals the policy-comparison harness (workload/
    compare.py) builds its Fig 2/3-style tables and conservation checks
    from."""

    WAIT_QUANTILES = (0.5, 0.9, 0.95, 0.99)

    def __init__(self):
        self.n = 0
        self.runtime_s = 0.0
        self.core_seconds = 0.0       # request_cpus × runtime
        self.gpu_seconds = 0.0        # request_gpus × runtime
        self.wasted_s = 0.0
        self.preemptions = 0
        self.waits: list[float] = []
        self.last_completed_at = 0.0

    def observe(self, job):
        self.n += 1
        self.runtime_s += job.runtime_s
        cpus = float(job.ad.get("request_cpus", 1) or 1)
        gpus = float(job.ad.get("request_gpus", 0) or 0)
        self.core_seconds += cpus * job.runtime_s
        self.gpu_seconds += gpus * job.runtime_s
        self.wasted_s += job.wasted_s
        self.preemptions += job.preempt_count
        if job.started_at >= 0:
            self.waits.append(job.started_at - job.submitted_at)
        self.last_completed_at = max(self.last_completed_at,
                                     job.completed_at)

    def merge(self, other: "CompletedStats") -> "CompletedStats":
        """Fold another aggregator in (cross-schedd totals under
        flocking: one CompletedStats per replayer, merged for the
        pool-level conservation checks).  Returns self."""
        self.n += other.n
        self.runtime_s += other.runtime_s
        self.core_seconds += other.core_seconds
        self.gpu_seconds += other.gpu_seconds
        self.wasted_s += other.wasted_s
        self.preemptions += other.preemptions
        self.waits.extend(other.waits)
        self.last_completed_at = max(self.last_completed_at,
                                     other.last_completed_at)
        return self

    # -- persistence (pool-service snapshot/resume) --------------------------
    def state_dict(self) -> dict:
        return {
            "n": self.n,
            "runtime_s": self.runtime_s,
            "core_seconds": self.core_seconds,
            "gpu_seconds": self.gpu_seconds,
            "wasted_s": self.wasted_s,
            "preemptions": self.preemptions,
            "waits": list(self.waits),
            "last_completed_at": self.last_completed_at,
        }

    def load_state(self, state: dict) -> None:
        self.n = int(state.get("n", 0))
        self.runtime_s = float(state.get("runtime_s", 0.0))
        self.core_seconds = float(state.get("core_seconds", 0.0))
        self.gpu_seconds = float(state.get("gpu_seconds", 0.0))
        self.wasted_s = float(state.get("wasted_s", 0.0))
        self.preemptions = int(state.get("preemptions", 0))
        self.waits = [float(w) for w in state.get("waits", [])]
        self.last_completed_at = float(state.get("last_completed_at", 0.0))

    def summary(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "n": self.n,
            "mean_wait_s": (sum(self.waits) / len(self.waits)
                            if self.waits else 0.0),
            "preemptions": self.preemptions,
            "wasted_s": self.wasted_s,
            "goodput": (self.runtime_s / (self.runtime_s + self.wasted_s)
                        if self.runtime_s + self.wasted_s > 0 else 1.0),
            "core_hours": self.core_seconds / 3600.0,
            "gpu_hours": self.gpu_seconds / 3600.0,
        }
        for q in self.WAIT_QUANTILES:
            out[f"p{int(q * 100)}_wait_s"] = percentile(self.waits, q)
        return out


def timeline(recorder: Recorder, keys: tuple[str, ...],
             max_points: int = 200) -> dict[str, dict[str, list[float]]]:
    """Extract gauge series (queue depth, provisioned cores, cost rate …)
    as JSON-ready {key: {"t": [...], "v": [...]}} tables, stride-
    downsampled to at most `max_points` points (last sample always
    kept) — the Fig 2/3-style curves the comparison harness emits."""
    out: dict[str, dict[str, list[float]]] = {}
    for key in keys:
        s = recorder.series.get(key, [])
        if not s:
            out[key] = {"t": [], "v": []}
            continue
        stride = max(1, -(-len(s) // max_points))
        pts = s[::stride]
        if pts[-1] != s[-1]:
            pts.append(s[-1])
        out[key] = {"t": [round(t, 3) for t, _ in pts],
                    "v": [v for _, v in pts]}
    return out


def summarize_backends(backends: list) -> dict[str, dict[str, Any]]:
    """Per-backend attribution: pods submitted/reclaimed, integrated cost,
    deprovisioning waste (Fig 3; definitionally 0 for a static pool), and
    harvested GPU-seconds (Fig 2 split per provider)."""
    out: dict[str, dict[str, Any]] = {}
    for b in backends:
        cap_s, busy_s = b.cluster.resource_seconds("gpu")
        out[b.name] = {
            "pods_submitted": b.stats.pods_submitted,
            "pods_reclaimed": b.stats.pods_reclaimed,
            "cost": b.stats.cost_total,
            "waste_fraction": (b.autoscaler.waste_fraction()
                               if b.autoscaler is not None else 0.0),
            "gpu_utilization": b.cluster.utilization("gpu"),
            "gpu_seconds_provisioned": cap_s,
            "gpu_seconds_busy": busy_s,
            "live_nodes": len(b.cluster.nodes),
            "spot": b.spot,
        }
    return out


def summarize_workers(workers: list) -> dict[str, Any]:
    alive = sum(w.alive_s for w in workers)
    busy = sum(w.busy_s for w in workers)
    return {
        "n_workers": len(workers),
        "alive_s": alive,
        "busy_s": busy,
        "utilization": busy / alive if alive > 0 else 0.0,
    }
