"""Job-lifecycle spans.

Attaches to the existing `JobQueue` hook lists (idle/claim/release/
complete) — the same mechanism the provisioner uses for incremental
deficits — so enabling spans costs one extra callback per state
transition and disabling them costs nothing: the hooks are simply
never installed.

Every submitted job closes exactly one lifecycle span when it
completes.  At that instant all phase boundaries are already on the
`Job` record, so the tracker derives:

    wait = started_at - submitted_at     (idle + matchmaking latency)
    run  = completed_at - started_at     (final, successful execution)

and the invariant  wait + run == completed_at - submitted_at  holds
exactly (both in sim seconds).  Preemptions show up separately: each
release bumps `repro_job_preemptions_total` and the span records the
job's final `preempt_count`/`wasted_s`.

A bounded deque of structured events (submit/claim/release/span) with
job/schedd/backend labels doubles as the source for the Chrome-trace
exporter; sim time maps to trace microseconds.
"""
from __future__ import annotations

from collections import deque

from .registry import MetricRegistry, SIM_SECONDS_BUCKETS


class LifecycleTracker:
    def __init__(self, registry: MetricRegistry, *,
                 event_log_max: int = 20000):
        self.wait_h = registry.histogram(
            "repro_job_wait_seconds",
            "Sim seconds from submit to final start, per schedd",
            ("schedd",), SIM_SECONDS_BUCKETS)
        self.run_h = registry.histogram(
            "repro_job_run_seconds",
            "Sim seconds from final start to completion, per schedd",
            ("schedd",), SIM_SECONDS_BUCKETS)
        self.submits = registry.counter(
            "repro_job_submits_total", "Jobs submitted", ("schedd",))
        self.claims = registry.counter(
            "repro_job_claims_total", "Worker claims handed out",
            ("schedd",))
        self.preemptions = registry.counter(
            "repro_job_preemptions_total",
            "Claims released by preemption/reclaim", ("schedd",))
        self.spans = registry.counter(
            "repro_job_spans_total", "Lifecycle spans closed (completions)",
            ("schedd",))
        self.events: deque = deque(maxlen=int(event_log_max))
        self.event_log_max = int(event_log_max)
        self._collector = None
        self._attached: set[int] = set()

    def bind_collector(self, collector):
        """Lets claim events carry the worker's backend label."""
        self._collector = collector

    def attach_queue(self, q):
        if id(q) in self._attached:
            return
        self._attached.add(id(q))
        name = q.name
        q.add_idle_hook(lambda job, delta, _n=name: self._on_idle(job, delta, _n))
        q.add_claim_hook(lambda job, now, _n=name: self._on_claim(job, now, _n))
        q.add_release_hook(lambda job, now, _n=name: self._on_release(job, now, _n))
        q.add_complete_hook(lambda job, _n=name: self._on_complete(job, _n))

    # -- hook bodies ---------------------------------------------------------
    def _on_idle(self, job, delta, schedd):
        # A job entering IDLE that has never started is a fresh submit;
        # re-idling after a release re-fires with started_at reset < 0 too,
        # so the claim/release events disambiguate in the log.
        if delta == +1 and job.started_at < 0 and job.preempt_count == 0:
            self.submits.labels(schedd).value += 1
            self.events.append({"ev": "submit", "t": job.submitted_at,
                                "jid": job.jid, "schedd": schedd})

    def _worker_backend(self, wname):
        col = self._collector
        if col is None or wname is None:
            return ""
        w = col.workers.get(wname)
        return getattr(w, "backend", None) or ""

    def _on_claim(self, job, now, schedd):
        self.claims.labels(schedd).value += 1
        self.events.append({"ev": "claim", "t": now, "jid": job.jid,
                            "schedd": schedd, "worker": job.claimed_by,
                            "backend": self._worker_backend(job.claimed_by)})

    def _on_release(self, job, now, schedd):
        self.preemptions.labels(schedd).value += 1
        self.events.append({"ev": "release", "t": now, "jid": job.jid,
                            "schedd": schedd})

    def _on_complete(self, job, schedd):
        start = job.started_at if job.started_at >= 0 else job.completed_at
        wait = start - job.submitted_at
        run = job.completed_at - start
        self.wait_h.labels(schedd).observe(wait)
        self.run_h.labels(schedd).observe(run)
        self.spans.labels(schedd).value += 1
        self.events.append({"ev": "span", "jid": job.jid, "schedd": schedd,
                            "submit": job.submitted_at, "start": start,
                            "end": job.completed_at,
                            "preempts": job.preempt_count,
                            "wasted_s": job.wasted_s})

    # -- Chrome-trace rows (sim time -> microseconds) ------------------------
    def chrome_events(self, pid: int = 1) -> list:
        out = [{"ph": "M", "pid": pid, "name": "process_name",
                "args": {"name": "job lifecycle (sim time)"}}]
        for ev in self.events:
            if ev["ev"] == "span":
                tid = ev["jid"] % 256
                args = {"jid": ev["jid"], "schedd": ev["schedd"],
                        "preempts": ev["preempts"]}
                out.append({"ph": "X", "pid": pid, "tid": tid,
                            "name": f"wait j{ev['jid']}",
                            "cat": "job,wait",
                            "ts": ev["submit"] * 1e6,
                            "dur": (ev["start"] - ev["submit"]) * 1e6,
                            "args": args})
                out.append({"ph": "X", "pid": pid, "tid": tid,
                            "name": f"run j{ev['jid']}",
                            "cat": "job,run",
                            "ts": ev["start"] * 1e6,
                            "dur": (ev["end"] - ev["start"]) * 1e6,
                            "args": args})
            elif ev["ev"] == "release":
                out.append({"ph": "i", "pid": pid, "tid": ev["jid"] % 256,
                            "name": f"release j{ev['jid']}", "cat": "job",
                            "ts": ev["t"] * 1e6, "s": "t"})
        return out

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> dict:
        return {"events": [dict(ev) for ev in self.events]}

    def load_state(self, state: dict):
        self.events = deque(
            (dict(ev) for ev in state.get("events", [])),
            maxlen=self.event_log_max)
