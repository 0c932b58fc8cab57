"""PoolService: the long-running pool daemon, plus its two clients.

A `PoolService` owns one `Simulation` (built from the same INI format the
compare harness uses), a `WallClockDriver` pacing it, and the streaming
bookkeeping the batch harness never needed:

  * per-schedd `CompletedStats` aggregators (queues run with
    ``keep_completed=False`` so a week of arrivals never accumulates Job
    objects) plus a bounded terminal-state index for `condor_q`-style
    lookups of finished jobs
  * a serializable pending-operation ledger: submissions scheduled at
    trace times and delayed reconfigurations (drain-at-t) are kept as
    plain records, so a snapshot can carry them even though the event
    loop itself only holds closures — `resume()` re-schedules them
  * snapshot/resume: ``snapshot()`` wraps `Simulation.state_dict()` with
    the service-level state above; ``PoolService.resume(state)`` rebuilds
    the simulation from the stored config (re-adding runtime-added
    backends first), restores it, and re-arms the pending ledger — a
    killed service continues exactly where the uninterrupted one would be

Every public method routes through the driver's quiescent injection
point, so the HTTP layer and in-process callers can hit a LIVE paced
pool from any thread.  `PoolClient` is the in-process client (same
surface as `RemoteClient`, the urllib one in this module, and the HTTP
endpoints in http.py).
"""
from __future__ import annotations

import itertools
import json
import urllib.request
from collections import OrderedDict
from typing import Any, Iterable

from repro_torch.core import Simulation, load_ini
from repro_torch.core.backend import build_backends
from repro_torch.core.metrics import CompletedStats, summarize_backends, timeline
from repro_torch.workload.compare import SERIES_KEYS
from repro_torch.workload.trace import TraceRecord

# condor_history analogue: remember the last N terminal jobs, not all
TERMINAL_INDEX_MAX = 20_000


class PoolService:
    def __init__(self, ini: str, *, schedds=None, fairshare: bool = False,
                 tick_s: float = 30.0, negotiate_interval_s: float = 60.0,
                 metrics_interval_s: float = 300.0, seed: int = 0,
                 speed: float | None = 1.0, telemetry: bool = True):
        # everything needed to rebuild an identical Simulation at
        # resume() — the snapshot stores this verbatim
        self._config: dict[str, Any] = {
            "ini": ini,
            "schedds": schedds,
            "fairshare": bool(fairshare),
            "tick_s": tick_s,
            "negotiate_interval_s": negotiate_interval_s,
            "metrics_interval_s": metrics_interval_s,
            "seed": seed,
            "speed": speed,
            "telemetry": bool(telemetry),
        }
        self.sim = self._build_sim()
        self.completed: dict[str, CompletedStats] = {}
        self._terminal: OrderedDict[int, dict] = OrderedDict()
        self._wire_queues()
        self._seq = itertools.count()
        self._pending: dict[int, dict] = {}     # seq -> {at, kind, payload}
        self._added_backend_ini: list[str] = []
        from repro_torch.service.driver import WallClockDriver
        self.driver = WallClockDriver(self.sim, speed=speed)

    # -- construction --------------------------------------------------------
    def _build_sim(self) -> Simulation:
        c = self._config
        cfg = load_ini(c["ini"])
        return Simulation.from_config(
            cfg, tick_s=c["tick_s"],
            negotiate_interval_s=c["negotiate_interval_s"],
            metrics_interval_s=c["metrics_interval_s"],
            seed=c["seed"], schedds=c["schedds"],
            fairshare=True if c["fairshare"] else None,
            telemetry=c.get("telemetry", True))

    def _wire_queues(self):
        """Streaming completion stats + terminal index on every queue not
        yet wired (base queues, then runtime-added schedds)."""
        for q in self.sim.queues:
            if q.name in self.completed:
                continue
            cs = CompletedStats()
            self.completed[q.name] = cs

            def hook(job, _cs=cs):
                _cs.observe(job)
                self._remember(job.jid, "completed", job.completed_at)

            q.keep_completed = False
            q.add_complete_hook(hook)

    def _remember(self, jid: int, state: str, t: float):
        self._terminal[int(jid)] = {"state": state, "t": t}
        while len(self._terminal) > TERMINAL_INDEX_MAX:
            self._terminal.popitem(last=False)

    def _call(self, fn):
        return self.driver.call(fn)

    # -- the pending-operation ledger ----------------------------------------
    def _schedule_op(self, at: float, kind: str, payload: dict,
                     seq: int | None = None):
        """Schedule a serializable operation at sim time `at`.  The loop
        holds only the firing closure; the (at, kind, payload) record in
        `_pending` is what a snapshot carries and resume() re-schedules."""
        if seq is None:
            seq = next(self._seq)
        self._pending[seq] = {"at": at, "kind": kind, "payload": payload}

        def fire(sim, now):
            self._pending.pop(seq, None)
            self._dispatch(sim, now, kind, payload)

        self.sim.at(at, fire, name=f"svc:{kind}")

    def _dispatch(self, sim, now: float, kind: str, payload: dict):
        if kind == "submit":
            rec = TraceRecord.from_obj(payload["record"])
            sim.queue_named(payload["schedd"]).submit(rec.to_job(), now)
        elif kind == "drain_backend":
            sim.drain_backend(payload["name"])
        elif kind == "drain_schedd":
            sim.drain_schedd(payload["name"])
        else:
            raise ValueError(f"unknown pending op {kind!r}")

    # -- submission surface --------------------------------------------------
    def submit(self, records: Iterable[TraceRecord | dict], *,
               schedd=None, at_trace_times: bool = False,
               at: float | None = None) -> dict:
        """Submit jobs.  Default: every record enters the queue at the
        CURRENT sim time (`condor_submit` now), returning the jids.  With
        `at_trace_times=True` each record is scheduled at
        ``base + arrival_s`` (base = `at`, default now) — the streaming
        analogue of a trace replay, snapshot-safe via the ledger."""
        recs = [r if isinstance(r, TraceRecord) else TraceRecord.from_obj(r)
                for r in records]
        for r in recs:
            r.validate()

        def op(sim):
            q = sim.queue_named(schedd)
            if getattr(q, "draining", False):
                raise ValueError(f"schedd {q.name!r} is draining")
            if not at_trace_times:
                jids = [q.submit(r.to_job(), sim.now) for r in recs]
                return {"jids": jids, "t": sim.now, "schedd": q.name}
            base = sim.now if at is None else float(at)
            for r in recs:
                self._schedule_op(base + r.arrival_s, "submit",
                                  {"schedd": q.name, "record": r.to_obj()})
            return {"scheduled": len(recs), "base_t": base,
                    "schedd": q.name}

        return self._call(op)

    def rm(self, jid: int) -> dict:
        """condor_rm: drop the job wherever it is — a running job's claim
        is released on its worker, an idle one just leaves the queue."""

        def op(sim):
            for q in sim.queues:
                job = q._jobs.get(jid)
                if job is None:
                    continue
                if job.claimed_by is not None:
                    w = sim.collector.workers.get(job.claimed_by)
                    if w is not None:
                        w.drop_claim(jid)
                q.remove(jid, sim.now)
                self._remember(jid, "removed", sim.now)
                return {"jid": jid, "removed": True, "schedd": q.name}
            return {"jid": jid, "removed": False,
                    "terminal": self._terminal.get(int(jid))}

        return self._call(op)

    # -- observation ---------------------------------------------------------
    def status(self) -> dict:
        def op(sim):
            schedds = {
                q.name: {
                    "idle": q.n_idle(),
                    "running": q.n_running(),
                    "completed": self.completed[q.name].n,
                    "draining": bool(getattr(q, "draining", False)),
                }
                for q in sim.queues
            }
            drained = (sim.drained() and sim._external_pending == 0
                       and not self._pending)
            return {
                "t": sim.now,
                "drained": drained,
                "pending_ops": len(self._pending),
                "schedds": schedds,
                "completed": sum(cs.n for cs in self.completed.values()),
                "backends": [self._backend_health(b)
                             for b in sim.backends],
                "detached_backends": [b.name
                                      for b in sim.detached_backends],
                "driver": {"running": self.driver.running,
                           "speed": self.driver.speed},
            }

        return self._call(op)

    @staticmethod
    def _backend_health(b) -> dict:
        health = getattr(b, "health", None)
        return health() if health is not None else {"name": b.name}

    def job_status(self, jid: int) -> dict:
        def op(sim):
            for q in sim.queues:
                job = q._jobs.get(jid)
                if job is not None:
                    return {"jid": jid, "state": job.state.value,
                            "schedd": q.name,
                            "claimed_by": job.claimed_by}
            rec = self._terminal.get(int(jid))
            if rec is not None:
                return {"jid": jid, **rec}
            return {"jid": jid, "state": "unknown"}

        return self._call(op)

    def metrics(self) -> dict:
        """Live gauges + per-backend cost/waste attribution + per-user
        fair-share (EUP) + the downsampled Fig 2/3-style series — the
        /metrics JSON document."""

        def op(sim):
            now = sim.now
            sim._flush_accounting()
            every = sim.backends + sim.detached_backends
            out: dict[str, Any] = {
                "t": now,
                "gauges": {
                    "idle_jobs": sim.pool_queue.n_idle(),
                    "running_jobs": sim.pool_queue.n_running(),
                    "completed_jobs": sum(cs.n
                                          for cs in self.completed.values()),
                    "pending_pods": len(sim.cluster_view.pending_pods()),
                    "running_pods": len(sim.cluster_view.running_pods()),
                    "ready_workers": len(sim.collector.alive_workers(now)),
                    "provisioned_cores": sum(
                        n.capacity.get("cpu", 0)
                        for b in sim.backends
                        for n in b.cluster.nodes.values()),
                    "cost_rate": sum(b.cost_rate() for b in sim.backends),
                    "cost_total": sum(b.stats.cost_total for b in every),
                },
                "backends": summarize_backends(every),
                "series": timeline(sim.recorder, SERIES_KEYS,
                                   max_points=200),
            }
            if sim.accountant is not None:
                out["fairshare"] = sim.accountant.snapshot(now)
            return out

        return self._call(op)

    def metrics_prom(self) -> str:
        """Prometheus text exposition (format 0.0.4) — the /metrics.prom
        body.  Collect hooks read the live pool at a quiescent instant."""
        return self._call(lambda sim: sim.prometheus_text())

    def trace(self) -> dict:
        """Chrome trace-event JSON document (the /trace body).  Raises
        ValueError when the pool was built with telemetry=False."""
        return self._call(lambda sim: sim.telemetry.chrome_trace())

    def summary(self) -> dict:
        return self._call(lambda sim: sim.summary())

    def completed_stats(self) -> CompletedStats:
        """Pool-wide completion aggregate (merged across schedds)."""
        def op(sim):
            total = CompletedStats()
            for cs in self.completed.values():
                total.merge(cs)
            return total

        return self._call(op)

    # -- reconfiguration -----------------------------------------------------
    def drain_backend(self, name: str, *, at: float | None = None) -> dict:
        def op(sim):
            if at is not None and at > sim.now:
                self._schedule_op(float(at), "drain_backend",
                                  {"name": name})
                return {"backend": name, "drain_at": float(at)}
            sim.drain_backend(name)
            return {"backend": name, "draining": True, "t": sim.now}

        return self._call(op)

    def add_backend(self, ini: str) -> dict:
        """Attach the backend(s) declared by `[backend:<name>]` sections
        of an INI snippet.  The snippet is remembered so resume() can
        re-create the backend before restoring its state."""

        def op(sim):
            names = self._add_backends_from_ini(ini)
            self._added_backend_ini.append(ini)
            return {"added": names, "t": sim.now}

        return self._call(op)

    def _add_backends_from_ini(self, ini: str) -> list[str]:
        cfg = load_ini(ini)
        if not cfg.backends:
            raise ValueError("no [backend:<name>] sections in snippet")
        names = []
        for b in build_backends(cfg):
            self.sim.add_backend(b)
            names.append(b.name)
        return names

    def add_schedd(self, name: str, *, quota: float = 1.0) -> dict:
        def op(sim):
            sim.add_schedd(name, quota=quota)
            self._wire_queues()
            return {"schedd": name, "quota": quota, "t": sim.now}

        return self._call(op)

    def drain_schedd(self, name: str, *, at: float | None = None) -> dict:
        def op(sim):
            if at is not None and at > sim.now:
                self._schedule_op(float(at), "drain_schedd",
                                  {"name": name})
                return {"schedd": name, "drain_at": float(at)}
            sim.drain_schedd(name)
            return {"schedd": name, "draining": True, "t": sim.now}

        return self._call(op)

    def detach_schedd(self, name: str) -> dict:
        def op(sim):
            sim.detach_schedd(name)
            return {"schedd": name, "detached": True, "t": sim.now}

        return self._call(op)

    # -- lifecycle -----------------------------------------------------------
    def start(self, *, speed: float | None = "unchanged"):
        if speed != "unchanged":
            self.driver.speed = speed
        self.driver.start()

    def stop(self):
        if self.driver.running:
            self.driver.stop()

    def run_until_drained(self, max_t: float = 1e6):
        """As-fast batch drive (driver must not be running) — the same
        semantics as `Simulation.run_until_drained`, ledger included
        (pending ops count as external events)."""
        if self.driver.running:
            raise RuntimeError("stop the driver before batch-driving")
        self.sim.run_until_drained(max_t)

    # -- snapshot / resume ---------------------------------------------------
    def snapshot(self) -> dict:
        """Full-state snapshot: the simulation's state_dict wrapped with
        the service-level state (config, completion aggregates, terminal
        index, pending-operation ledger, runtime-added backend INIs)."""

        def op(sim):
            return {
                "service": {
                    "version": 1,
                    "config": dict(self._config),
                    "added_backend_ini": list(self._added_backend_ini),
                    "pending": [{"seq": seq, **entry}
                                for seq, entry
                                in sorted(self._pending.items())],
                    "completed": {n: cs.state_dict()
                                  for n, cs in self.completed.items()},
                    "terminal": [[jid, rec]
                                 for jid, rec in self._terminal.items()],
                },
                "sim": sim.state_dict(allow_pending_external=True),
            }

        return self._call(op)

    def save_snapshot(self, path: str) -> dict:
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f)
        return {"path": path, "t": snap["sim"]["t"]}

    @classmethod
    def resume(cls, state: dict | str, *,
               speed: float | None = "unchanged") -> "PoolService":
        """Rebuild a service from a snapshot (dict or file path) such
        that it continues exactly where the uninterrupted run would be.
        The driver is NOT started — call start() when ready."""
        if isinstance(state, str):
            with open(state) as f:
                state = json.load(f)
        svc_state = state["service"]
        c = dict(svc_state["config"])
        if speed != "unchanged":
            c["speed"] = speed
        svc = cls(c["ini"], schedds=c["schedds"],
                  fairshare=c["fairshare"], tick_s=c["tick_s"],
                  negotiate_interval_s=c["negotiate_interval_s"],
                  metrics_interval_s=c["metrics_interval_s"],
                  seed=c["seed"], speed=c["speed"],
                  telemetry=c.get("telemetry", True))
        # runtime-added backends must exist before restore() can load
        # their state (and possibly re-detach them)
        for ini in svc_state["added_backend_ini"]:
            svc._add_backends_from_ini(ini)
            svc._added_backend_ini.append(ini)
        svc.sim.restore(state["sim"])
        svc._wire_queues()           # wire schedds added at runtime
        for name, cs_state in svc_state["completed"].items():
            if name not in svc.completed:
                raise ValueError(f"snapshot has stats for unknown "
                                 f"schedd {name!r}")
            svc.completed[name].load_state(cs_state)
        svc._terminal = OrderedDict(
            (int(jid), rec) for jid, rec in svc_state["terminal"])
        pending = svc_state["pending"]
        for entry in pending:        # seq order == original schedule order
            svc._schedule_op(entry["at"], entry["kind"], entry["payload"],
                             seq=int(entry["seq"]))
        next_seq = (max(int(e["seq"]) for e in pending) + 1
                    if pending else 0)
        svc._seq = itertools.count(next_seq)
        return svc


class PoolClient:
    """In-process client: the same verbs the HTTP surface exposes, bound
    directly to a PoolService (each call still goes through the driver's
    quiescent injection point, so it is safe from any thread)."""

    def __init__(self, service: PoolService):
        self.service = service

    def submit(self, records, **kw) -> dict:
        return self.service.submit(records, **kw)

    def status(self) -> dict:
        return self.service.status()

    def job_status(self, jid: int) -> dict:
        return self.service.job_status(jid)

    def rm(self, jid: int) -> dict:
        return self.service.rm(jid)

    def metrics(self) -> dict:
        return self.service.metrics()

    def metrics_prom(self) -> str:
        return self.service.metrics_prom()

    def trace(self) -> dict:
        return self.service.trace()

    def snapshot(self) -> dict:
        return self.service.snapshot()

    def drain_backend(self, name: str, **kw) -> dict:
        return self.service.drain_backend(name, **kw)

    def add_backend(self, ini: str) -> dict:
        return self.service.add_backend(ini)

    def add_schedd(self, name: str, **kw) -> dict:
        return self.service.add_schedd(name, **kw)

    def drain_schedd(self, name: str, **kw) -> dict:
        return self.service.drain_schedd(name, **kw)


class RemoteClient:
    """urllib client for a served pool — the CLI's transport.  Mirrors
    PoolClient's surface; every method returns the decoded JSON body."""

    def __init__(self, url: str, timeout: float = 30.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(self.url + path,
                                    timeout=self.timeout) as r:
            return json.loads(r.read().decode())

    def _get_text(self, path: str) -> str:
        with urllib.request.urlopen(self.url + path,
                                    timeout=self.timeout) as r:
            return r.read().decode()

    def _post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read().decode())

    def healthz(self) -> dict:
        return self._get("/healthz")

    def status(self) -> dict:
        return self._get("/status")

    def metrics(self) -> dict:
        return self._get("/metrics")

    def metrics_prom(self) -> str:
        return self._get_text("/metrics.prom")

    def trace(self) -> dict:
        return self._get("/trace")

    def job_status(self, jid: int) -> dict:
        return self._get(f"/job?jid={int(jid)}")

    def submit(self, records, *, schedd=None, at_trace_times=False,
               at=None) -> dict:
        recs = [r.to_obj() if isinstance(r, TraceRecord) else r
                for r in records]
        body = {"records": recs, "at_trace_times": at_trace_times}
        if schedd is not None:
            body["schedd"] = schedd
        if at is not None:
            body["at"] = at
        return self._post("/submit", body)

    def rm(self, jid: int) -> dict:
        return self._post("/rm", {"jid": int(jid)})

    def snapshot(self, path: str | None = None) -> dict:
        return self._post("/snapshot", {"path": path} if path else {})

    def drain_backend(self, name: str, at: float | None = None) -> dict:
        body: dict[str, Any] = {"name": name}
        if at is not None:
            body["at"] = at
        return self._post("/drain-backend", body)

    def add_backend(self, ini: str) -> dict:
        return self._post("/add-backend", {"ini": ini})

    def add_schedd(self, name: str, quota: float = 1.0) -> dict:
        return self._post("/add-schedd", {"name": name, "quota": quota})

    def drain_schedd(self, name: str, at: float | None = None) -> dict:
        body: dict[str, Any] = {"name": name}
        if at is not None:
            body["at"] = at
        return self._post("/drain-schedd", body)

    def start(self, speed: float | None = None) -> dict:
        return self._post("/start", {"speed": speed})

    def shutdown(self) -> dict:
        return self._post("/shutdown", {})
