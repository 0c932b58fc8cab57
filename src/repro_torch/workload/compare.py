"""Policy-comparison harness: one trace, many provisioning configurations.

The paper's Fig 2/3 compare demand (idle/running jobs) against supply
(provisioned cores) over time for a given provisioning setup; the
interesting engineering question is how that picture CHANGES with the
knobs — routing policy (fill-first vs cheapest-first vs
spot-with-fallback) and NAP headroom (elastic node caps).  `compare()`
replays the SAME trace through each `PolicySpec`'s federation and emits a
JSON document with, per policy:

  * Fig 2/3-style series: idle/running jobs, provisioned cores, live
    nodes, cost rate, idle-cohort count (downsampled timelines)
  * job outcomes: completions, wait-time mean/percentiles, preemptions,
    goodput, core/GPU-hours
  * provisioning totals: pods submitted, cost, per-backend split

plus cross-policy CONSERVATION checks: every policy must complete every
replayed job and deliver the trace's exact core/GPU-hours — policies may
move work in time and across providers, but demand is conserved.  A
violation means a simulator bug, not a policy difference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable, Sequence

from repro_torch.core import Simulation, load_ini
from repro_torch.core.metrics import CompletedStats, timeline
from repro_torch.workload.replay import replay_flock, replay_trace
from repro_torch.workload.trace import Trace, split_trace

SERIES_KEYS = ("idle_jobs", "running_jobs", "provisioned_cores",
               "live_nodes", "cost_rate", "idle_cohorts")
SCHEDD_SERIES_KEYS = ("idle_jobs", "running_jobs", "deficit")

# the standard 3-provider federation the CLI and examples compare on:
# donated on-prem base + billed elastic cloud + cheap reclaimable spot
FEDERATION_INI = """\
[provision]
submit_interval_s=60
idle_timeout_s=600
startup_delay_s=30
max_pods_per_group=2000
max_total_pods=4000
routing_policy={routing}

[k8s]
priority_class=opportunistic

[backend:onprem]
kind=static
nodes={onprem_nodes}
capacity_dict=cpu:64,gpu:4,memory:512,disk:1024

[backend:cloud]
kind=autoscale
capacity_dict=cpu:64,gpu:4,memory:512,disk:1024
max_nodes={cloud_max_nodes}
node_hourly_cost=2.5
provision_delay_s=90
scale_down_delay_s=300

[backend:spot]
kind=autoscale
spot=true
capacity_dict=cpu:64,gpu:4,memory:512,disk:1024
max_nodes={spot_max_nodes}
node_hourly_cost=0.8
provision_delay_s=90
scale_down_delay_s=300
"""


@dataclasses.dataclass
class PolicySpec:
    """One provisioning configuration to replay the trace under."""

    name: str
    ini: str
    tick_s: float = 30.0
    negotiate_interval_s: float = 60.0
    metrics_interval_s: float = 300.0
    seed: int = 0

    def build(self, **kw) -> Simulation:
        """Extra keyword arguments (e.g. ``schedds=``, ``fairshare=``)
        pass straight through to the Simulation constructor."""
        cfg = load_ini(self.ini)
        return Simulation.from_config(
            cfg, tick_s=self.tick_s,
            negotiate_interval_s=self.negotiate_interval_s,
            metrics_interval_s=self.metrics_interval_s,
            seed=self.seed, **kw)


def standard_policy(routing: str, *, headroom: int = 24,
                    onprem_nodes: int = 4, name: str | None = None,
                    **kw) -> PolicySpec:
    """A PolicySpec over the standard federation: `routing` picks the
    deficit split, `headroom` caps BOTH elastic providers' node count
    (the NAP headroom knob)."""
    ini = FEDERATION_INI.format(routing=routing,
                                onprem_nodes=onprem_nodes,
                                cloud_max_nodes=headroom,
                                spot_max_nodes=headroom)
    return PolicySpec(name=name or routing, ini=ini, **kw)


def standard_policies(routings: Sequence[str] = ("fill-first",
                                                 "cheapest-first"),
                      headrooms: Sequence[int] = (24,),
                      **kw) -> list[PolicySpec]:
    """The routing × NAP-headroom grid.  With one headroom the policy is
    named after the routing alone; with several, `<routing>/nap<N>`."""
    out = []
    for routing in routings:
        for headroom in headrooms:
            name = (routing if len(headrooms) == 1
                    else f"{routing}/nap{headroom}")
            out.append(standard_policy(routing, headroom=headroom,
                                       name=name, **kw))
    return out


def run_policy(trace: Trace | Iterable, spec: PolicySpec, *,
               speed: float = 1.0, coalesce_s: float = 10.0,
               start_s: float = 0.0, until_s: float | None = None,
               max_t: float = 5e6, max_points: int = 200,
               schedds: int = 1, split_by: str = "group",
               fairshare: bool = False,
               telemetry: bool = True) -> dict[str, Any]:
    """Replay one trace through one policy's federation until drained;
    returns the per-policy summary block.

    With ``telemetry=True`` (default) the simulation runs with the
    cycle profiler on and the block gains a ``phases`` section — the
    negotiation wall time attributed to build/match/apply/reconcile,
    cycle counts by kind, and jit compile count — so a policy's cost
    in *solver* time is visible next to its cost in dollars.

    ``schedds=N`` runs the multi-schedd flocking scenario: the trace is
    split per schedd by its ``split_by`` label (`split_trace`), each
    sub-trace streams into its own queue on the shared event loop, and
    the block gains a per-schedd section (job outcomes + Fig 2/3-style
    idle/running/deficit series per submit host).  The pool-level
    totals are the cross-schedd merge, so the conservation checks hold
    unchanged.  ``fairshare=True`` negotiates with the hierarchical
    fair-share accountant instead of plain flocking order."""
    if schedds < 1:
        raise ValueError(f"schedds must be >= 1, got {schedds}")
    flocking = schedds > 1 or fairshare
    if flocking:
        if not isinstance(trace, Trace):
            trace = Trace.from_records(trace)
        parts = split_trace(trace, by=split_by, n_schedds=schedds)
        sim = spec.build(schedds=list(parts),
                         fairshare=True if fairshare else None,
                         telemetry=telemetry)
        replayers = replay_flock(
            sim, parts, speed=speed, coalesce_s=coalesce_s,
            start_s=start_s, until_s=until_s, compact_completed=True)
    else:
        sim = spec.build(telemetry=telemetry)
        replayers = {"schedd": replay_trace(
            sim, trace, speed=speed, coalesce_s=coalesce_s,
            start_s=start_s, until_s=until_s, compact_completed=True)}
    t0 = time.time()
    sim.run_until_drained(max_t=max_t)
    wall_s = time.time() - t0
    if not sim.drained():
        idle = sum(q.n_idle() for q in sim.queues)
        running = sum(q.n_running() for q in sim.queues)
        raise RuntimeError(
            f"policy {spec.name!r} failed to drain by t={max_t} "
            f"({idle} idle, {running} running)")
    done = CompletedStats()
    for rep in replayers.values():
        assert rep.stats.completed is not None
        done.merge(rep.stats.completed)
    s = sim.summary()
    out = {
        "policy": spec.name,
        "wall_s": round(wall_s, 3),
        "makespan_s": round(sim.now, 3),
        "jobs": done.summary(),
        "replay": {
            "submitted": sum(r.stats.submitted
                             for r in replayers.values()),
            "truncated": sum(r.stats.truncated
                             for r in replayers.values()),
            "batches": sum(r.stats.batches for r in replayers.values()),
            "max_batch": max(r.stats.max_batch
                             for r in replayers.values()),
        },
        "pods_submitted": s["pods_submitted"],
        "cost_total": round(s["cost_total"], 4),
        "gpu_utilization": round(s["gpu_utilization"], 4),
        "backends": s["backends"],
        "series": timeline(sim.recorder, SERIES_KEYS,
                           max_points=max_points),
        # raw totals for the conservation check (pre-rounding)
        "_core_seconds": done.core_seconds,
        "_gpu_seconds": done.gpu_seconds,
    }
    prof = sim.telemetry.profiler
    if prof is not None:
        out["phases"] = prof.phase_totals()
    if flocking:
        out["schedds"] = _per_schedd_block(sim, replayers, max_points)
        users = _per_user_block(sim)
        if users:
            out["users"] = users
        if fairshare and "fairshare" in s:
            out["fairshare"] = s["fairshare"]
    return out


def _per_schedd_block(sim: Simulation, replayers: dict,
                      max_points: int) -> dict[str, Any]:
    """Per-submit-host outcomes + Fig 2/3-style series."""
    out: dict[str, Any] = {}
    for name, rep in replayers.items():
        keys = tuple(f"{k}@schedd:{name}" for k in SCHEDD_SERIES_KEYS)
        series = timeline(sim.recorder, keys, max_points=max_points)
        out[name] = {
            "jobs": rep.stats.completed.summary(),
            "replay": {"submitted": rep.stats.submitted,
                       "truncated": rep.stats.truncated},
            "series": {k: series[f"{k}@schedd:{name}"]
                       for k in SCHEDD_SERIES_KEYS},
        }
    return out


def _per_user_block(sim: Simulation) -> dict[str, Any]:
    """Per-submitter fair-share gauges, summarized: peak starvation age
    and mean running slots over the run (full series stay in the
    recorder for callers that want them)."""
    out: dict[str, Any] = {}
    for user in sim.recorder.users_recorded():
        running = sim.recorder.user_values("running_jobs", user)
        entry = {
            "max_starvation_age_s": round(
                max(sim.recorder.user_values("starvation_age_s", user),
                    default=0.0), 3),
            "mean_running_jobs": round(
                sum(running) / len(running) if running else 0.0, 3),
        }
        eup = sim.recorder.user_values("effective_priority", user)
        if eup:
            entry["last_effective_priority"] = round(eup[-1], 6)
        out[user] = entry
    return out


def _conservation(trace_stats: dict[str, Any],
                  runs: list[dict[str, Any]],
                  truncated: bool) -> dict[str, Any]:
    """Per-policy and cross-policy demand conservation.  When the replay
    window truncates the trace, totals are compared across policies only
    (each policy saw the same window, whatever it was)."""
    jobs = [r["jobs"]["n"] for r in runs]
    cores = [r.pop("_core_seconds") for r in runs]
    gpus = [r.pop("_gpu_seconds") for r in runs]
    rel = 1e-6
    close = (lambda a, b:
             abs(a - b) <= rel * max(1.0, abs(a), abs(b)))
    out: dict[str, Any] = {
        "jobs_completed": jobs,
        "core_hours": [round(c / 3600.0, 4) for c in cores],
        "gpu_hours": [round(g / 3600.0, 4) for g in gpus],
        "policies_agree": (len({*jobs}) <= 1
                           and all(close(c, cores[0]) for c in cores)
                           and all(close(g, gpus[0]) for g in gpus)),
    }
    if not truncated:
        out["trace_jobs"] = trace_stats["n"]
        out["trace_core_hours"] = round(
            trace_stats["core_seconds"] / 3600.0, 4)
        out["matches_trace"] = (
            all(n == trace_stats["n"] for n in jobs)
            and all(close(c, trace_stats["core_seconds"]) for c in cores)
            and all(close(g, trace_stats["gpu_seconds"]) for g in gpus))
    out["ok"] = bool(out["policies_agree"]
                     and out.get("matches_trace", True))
    return out


def compare(trace: Trace, policies: Sequence[PolicySpec], *,
            speed: float = 1.0, coalesce_s: float = 10.0,
            start_s: float = 0.0, until_s: float | None = None,
            max_t: float = 5e6, max_points: int = 200,
            schedds: int = 1, split_by: str = "group",
            fairshare: bool = False,
            telemetry: bool = True) -> dict[str, Any]:
    """Run one trace across every policy; returns the JSON-ready
    comparison document (trace stats, per-policy summaries+series,
    conservation verdict).  ``schedds=N`` replays the trace split per
    schedd (`split_by` label) through each policy's federation — the
    conservation checks then verify the CROSS-SCHEDD totals against the
    trace, demand being conserved however it is partitioned."""
    if not policies:
        raise ValueError("need at least one PolicySpec")
    names = [p.name for p in policies]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate policy names: {names}")
    trace.validate()
    trace_stats = trace.stats()           # one O(n) pass, reused below
    runs = [
        run_policy(trace, spec, speed=speed, coalesce_s=coalesce_s,
                   start_s=start_s, until_s=until_s, max_t=max_t,
                   max_points=max_points, schedds=schedds,
                   split_by=split_by, fairshare=fairshare,
                   telemetry=telemetry)
        for spec in policies
    ]
    truncated = (start_s > 0.0 or until_s is not None)
    conservation = _conservation(trace_stats, runs, truncated)
    return {
        "trace": {**trace.meta, **trace_stats},
        "replay": {"speed": speed, "coalesce_s": coalesce_s,
                   "start_s": start_s, "until_s": until_s,
                   "schedds": schedds, "split_by": split_by,
                   "fairshare": fairshare},
        "policies": {r["policy"]: r for r in runs},
        "conservation": conservation,
    }


def comparison_table(doc: dict[str, Any]) -> str:
    """Human-readable summary of a compare() document.  When the runs
    carried the cycle profiler, two phase-attribution columns follow:
    negotiation wall (build+match+apply) and reconcile wall."""
    phased = any("phases" in r for r in doc["policies"].values())
    head = (f"{'policy':<24s} {'jobs':>7s} {'p95 wait':>9s} "
            f"{'makespan':>9s} {'pods':>6s} {'cost $':>9s}")
    if phased:
        head += f" {'neg ms':>8s} {'recon ms':>9s}"
    rows = [head]
    for name, r in doc["policies"].items():
        row = (f"{name:<24s} {r['jobs']['n']:>7d} "
               f"{r['jobs']['p95_wait_s']:>8.0f}s "
               f"{r['makespan_s']:>8.0f}s {r['pods_submitted']:>6d} "
               f"{r['cost_total']:>9.2f}")
        ph = r.get("phases")
        if phased and ph is not None:
            neg_ms = 1e3 * (ph["build_s"] + ph["match_s"]
                            + ph["apply_s"])
            row += (f" {neg_ms:>8.1f} {1e3 * ph['reconcile_s']:>9.1f}")
        rows.append(row)
    c = doc["conservation"]
    rows.append(f"conservation: ok={c['ok']} "
                f"(jobs={c['jobs_completed']}, "
                f"core-hours={c['core_hours']})")
    return "\n".join(rows)
