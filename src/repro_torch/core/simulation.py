"""Event-driven simulation harness wiring all control-plane components.

One `Simulation` owns: JobQueue (schedd), Collector (pool), N
`ScalingBackend`s (each a KubeCluster + optional NodeAutoscaler + cost
model), Provisioner, optional fault injectors, and a Recorder.

The core is a discrete-event `EventLoop` (core/events.py).  Control-plane
activities are periodic callbacks at their EXACT cadence — no tick
quantization, no `last = now` drift:

  priority 0   external events (job arrivals, spot reclaims, failures)
  priority 10  provisioner reconcile, every submit_interval_s — C1/C3/C4
  priority 20  per-backend tick: node autoscaler (C7), kube scheduler
               (priorities/preemption, §5), cost accounting
  priority 30  negotiator matches idle-job cohorts to workers
  priority 40  straggler mitigation (beyond-paper)
  priority 50  metrics sampling (own cadence, decoupled from tick_s)

Between events, continuous state — running jobs, worker busy/alive time —
is integrated lazily: before ANY event fires, `_advance_to(t)` advances
the workers to exactly `t`, so a spot reclaim at t=12.5 sees job progress
up to 12.5 and completions land at their exact finish times (C2 wakeups).

Compatibility: `tick_s`, `step()`, and `run(until)` keep their seed
meaning (a step advances one tick's worth of events).  `engine="tick"`
retains the seed's fixed-tick O(n)-scan loop verbatim — it is the
baseline for benchmarks/bench_event_engine.py and the oracle for
differential tests.

Single-backend compatibility: the seed constructor signature
(`nodes=`, `node_template=`, `max_nodes=`) still works — it is adapted
into a one-element backend list, and `sim.cluster` / `sim.autoscaler`
keep pointing at that backend's internals.  Multi-provider federations
pass `backends=[...]` or use `Simulation.from_config` with a config
declaring `[backend:<name>]` sections.

Multi-schedd flocking: `schedds=N` (or a list of `ScheddSpec`s with
quotas and per-user priority factors) builds N submit-host queues
sharing one pool-unique jid counter, negotiated as ONE cycle in
flocking order (`Collector.run_cycle`); `fairshare=True` (or an
`Accountant`) adds hierarchical fair-share — per-schedd quotas, then
per-user effective priority with usage decay.  The single-queue
construction path is untouched (`sim.queue` keeps meaning the first/
only schedd), matching the backend-adapter compat pattern.

The same Provisioner/Worker code runs under wall-clock in the examples
(launch/train.py elastic mode) — the simulator only replaces the clock and
the job payloads, not the decision logic (paper-faithfulness hinges on
this separation).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Iterable

import numpy as np

from repro_torch.core.backend import (
    FederatedClusterView, KubeBackend, build_backends,
)
from repro_torch.core.cluster import KubeCluster, Node
from repro_torch.core.config import ProvisionerConfig
from repro_torch.core.events import EventLoop
from repro_torch.core.fairshare import Accountant, ScheddSpec, make_schedd_specs
from repro_torch.core.jobqueue import FlockedQueues, Job, JobQueue
from repro_torch.core.metrics import (
    Recorder, summarize_backends, summarize_jobs, summarize_workers,
)
from repro_torch.core.nodescaler import NodeAutoscaler, NodeTemplate
from repro_torch.core.provisioner import Provisioner
from repro_torch.core.stragglers import StragglerPolicy
from repro_torch.core.worker import (
    Collector, advance_workers, worker_from_state, worker_state,
)
from repro_torch.observability import as_telemetry

# same-timestamp ordering, mirroring the seed's intra-tick sequence
P_EXTERNAL = 0
P_RECONCILE = 10
P_BACKEND = 20
P_NEGOTIATE = 30
P_STRAGGLER = 40
P_METRICS = 50


@dataclasses.dataclass
class TimedEvent:
    at: float
    fn: Callable[["Simulation", float], None]
    name: str = ""


class Simulation:
    def __init__(
        self,
        cfg: ProvisionerConfig,
        *,
        nodes: list[Node] | None = None,
        node_template: NodeTemplate | None = None,
        max_nodes: int = 64,
        backends: list | None = None,
        tick_s: float = 5.0,
        negotiate_interval_s: float = 15.0,
        metrics_interval_s: float | None = None,
        seed: int = 0,
        straggler_policy: StragglerPolicy | None = None,
        engine: str = "event",
        schedds: int | list | None = None,
        fairshare: Accountant | bool | None = None,
        negotiate_quantum: int = 1,
        matchmaker=None,
        negotiation_batch: int | None = None,
        telemetry=None,
    ):
        if engine not in ("event", "tick"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.cfg = cfg
        self.tick_s = tick_s
        self.negotiate_interval_s = negotiate_interval_s
        self.metrics_interval_s = metrics_interval_s or tick_s

        # one schedd (the seed signature) or a flocking federation of
        # them — `schedds=N` / `schedds=[ScheddSpec(...), ...]` makes N
        # queues sharing one pool-unique jid counter; `fairshare=True`
        # (or an Accountant) turns on hierarchical fair-share in the
        # negotiation cycle
        self.flocking = schedds is not None or fairshare is not None
        self.negotiate_quantum = negotiate_quantum
        if fairshare and engine == "tick":
            # the tick engine's scan_cycle is the seed oracle and
            # knows nothing of the accountant — silently dropping the
            # configured fair-share would be worse than refusing
            raise ValueError(
                "fairshare requires engine='event' (the tick baseline "
                "negotiates per-job FIFO scans in flocking order only)")
        if self.flocking:
            self.schedd_specs = make_schedd_specs(
                schedds if schedds is not None else 1)
            ids = itertools.count()
            self.queues = [JobQueue(name=s.name, ids=ids)
                           for s in self.schedd_specs]
            if fairshare is True:
                fairshare = Accountant()
            self.accountant = fairshare or None
            if self.accountant is not None:
                for spec, q in zip(self.schedd_specs, self.queues):
                    self.accountant.set_quota(spec.name, spec.quota)
                    for user, f in spec.priority_factors.items():
                        self.accountant.set_priority_factor(user, f)
                    self.accountant.attach_queue(spec.name, q)
            self.pool_queue = FlockedQueues(self.queues)
        else:
            self.schedd_specs = [ScheddSpec(name="schedd")]
            self.queues = [JobQueue()]
            self.accountant = None
            self.pool_queue = self.queues[0]
        self.queue = self.queues[0]
        # negotiation backend: the explicit arg wins, else the INI
        # `[provision] matchmaker=` key (core/matchmaker — "numpy"
        # reference, "jax" jitted, "scan" oracle, or an instance)
        if matchmaker is None:
            matchmaker = getattr(cfg, "matchmaker", None)
        # staged-negotiation capacity: the explicit arg wins, else the
        # INI `[provision] negotiation_batch=` key.  The LIVE engines
        # quiesce every staged cycle immediately (claims feed worker
        # advancement between events, so deferral would break causality)
        # — batch>1 pays off for drivers that legitimately batch, e.g.
        # the streaming service flushing an arrival backlog or the e2e
        # bench (benchmarks/bench_matchmaking.py)
        if negotiation_batch is None:
            negotiation_batch = getattr(cfg, "negotiation_batch", 1)
        # telemetry=True turns on lifecycle spans + the cycle profiler;
        # the metric registry (consolidated counters, pool gauges) is
        # live either way.  Pass a Telemetry instance to share one
        # registry across simulations.
        self.telemetry = as_telemetry(telemetry)
        self.collector = Collector(matchmaker=matchmaker,
                                   negotiation_batch=negotiation_batch,
                                   telemetry=self.telemetry)
        if backends is None:
            # single-backend compatibility adapter (seed signature)
            cluster = KubeCluster(nodes or [])
            autoscaler = (
                NodeAutoscaler(cluster, node_template, max_nodes=max_nodes)
                if node_template is not None else None
            )
            backends = [KubeBackend("default", cluster, autoscaler)]
        self.backends = list(backends)
        # backends drained at runtime move here once empty — kept so
        # their accrued cost / stats stay in summary()
        self.detached_backends: list = []
        self.cluster = self.backends[0].cluster
        self.autoscaler = self.backends[0].autoscaler
        self.cluster_view = FederatedClusterView(self.backends)
        self.provisioner = Provisioner(
            cfg, self.queues, self.collector, self.backends,
            schedd_quotas={s.name: s.quota for s in self.schedd_specs},
        )
        self.straggler_policy = straggler_policy
        self.recorder = Recorder()
        self.events: list[TimedEvent] = []      # tick engine's flat list
        self.now = 0.0
        self._last_negotiate = -1e18            # tick engine (drifts; see
        #                                         event engine for the fix)
        self.rng = np.random.default_rng(seed)
        self.all_workers: list = []  # includes terminated (for accounting)

        # track every worker the provisioner makes
        orig_factory = self.provisioner.worker_factory
        from repro_torch.core.worker import Worker as _W

        def tracking_factory(**kw):
            w = (orig_factory or _W)(**kw)
            self.all_workers.append(w)
            return w

        self.provisioner.worker_factory = tracking_factory

        # span hooks on every queue + scrape-time pool gauges (a no-op
        # shell when telemetry is disabled beyond gauge registration)
        self.telemetry.attach_simulation(self)

        self.loop = EventLoop()
        self._advanced_until = 0.0
        self._external_pending = 0
        # live-fusion deferral horizon: while a negotiation backlog is
        # staged, pre-event advancement is parked up to this time and
        # replayed by flush_staged at the staged timestamps (the
        # collector's advance_hook below).  -inf == nothing deferred.
        self._defer_until = -math.inf
        # every periodic handle is retained by name so runtime
        # reconfiguration (drain_backend) can cancel a backend's timers
        # and restore() can re-install the full set on a fresh loop
        self._timers: dict[str, Any] = {}
        self._backend_timers: dict[str, list] = {}
        if engine == "event":
            self.collector.advance_hook = self._advance_unchecked
            self._install_periodics()

    @staticmethod
    def _next_cadence(t: float, interval: float, first0: float) -> float:
        """First point of the periodic grid ``first0 + k*interval``
        STRICTLY after `t` — restore() re-phases every periodic so a
        resumed run fires them at exactly the timestamps the
        uninterrupted run would have (events at `t` itself already fired
        before a quiescent snapshot)."""
        k = max(0, math.floor((t - first0) / interval + 1e-9) + 1)
        return first0 + k * interval

    def _install_backend_timer(self, backend, *, prime: bool,
                               first: float | None = None):
        """Periodic tick for one backend, with the drain watch built in:
        after each tick, a draining backend with zero live pods is
        detached (claims completed and workers retired — nothing left to
        let finish).  The handles are retained so drain/restore can
        cancel or re-install them."""
        name = backend.name
        handles = []

        def tick(now: float, dt: float, _b=backend):
            _b.tick(now, dt)
            if getattr(_b, "draining", False) and _b.live_pods() == 0:
                self._detach_backend(_b, now)

        if prime:
            # zero-dt priming pass so pods submitted by the first
            # reconcile place immediately (the seed's first tick did)
            handles.append(self.loop.schedule(
                self.loop.now, lambda now: tick(now, 0.0),
                name=f"backend:{name}:prime", priority=P_BACKEND))
        if first is None:
            first = self._next_cadence(self.loop.now, self.tick_s, 0.0)
        handles.append(self.loop.every(
            self.tick_s, lambda now: tick(now, self.tick_s),
            first=first, name=f"backend:{name}", priority=P_BACKEND))
        self._backend_timers[name] = handles

    def _install_periodics(self):
        """Exact-cadence control-plane callbacks (the seed polled these
        every tick, accumulating up to tick_s of drift per period).
        Install ORDER is part of the determinism contract: events landing
        on the same (timestamp, priority) fire in install order, and
        restore() re-installs in this same order."""
        self._timers["reconcile"] = self.provisioner.schedule_on(
            self.loop, first=0.0, priority=P_RECONCILE)
        for backend in self.backends:
            self._install_backend_timer(backend, prime=True)
        self._timers["negotiate"] = self.loop.every(
            self.negotiate_interval_s, self._negotiate_cb,
            first=0.0, name="negotiate", priority=P_NEGOTIATE)
        if self.straggler_policy is not None:
            self._timers["stragglers"] = self.loop.every(
                self.tick_s, self._straggler_cb,
                first=self.tick_s, name="stragglers", priority=P_STRAGGLER)
        self._timers["metrics"] = self.loop.every(
            self.metrics_interval_s, self._record_cb,
            first=0.0, name="metrics", priority=P_METRICS)

    # -- periodic callbacks (event engine) -----------------------------------
    def _negotiate_cb(self, now: float):
        self._last_negotiate = now
        if self.flocking:
            self.collector.run_cycle(
                self.queues, now, accountant=self.accountant,
                quantum=self.negotiate_quantum)
        elif self.collector.negotiation_batch > 1:
            # live backlog fusion: stage this cycle, and DEFER the flush
            # when nothing can observe or change pool state before the
            # next negotiation firing — no event in the window, no
            # completion, no idle-timeout expiry (`_defer_ok`).  The
            # next firing extends the backlog, so negotiation_batch=K
            # engages in live mode; the eventual flush replays worker
            # advancement at the staged timestamps (the collector's
            # advance_hook), keeping claim maps bit-identical to the
            # per-cycle path.  Any veto quiesces in the same instant —
            # exactly the old behavior.
            self.collector.stage_cycle(self.queue, now)
            if self.collector._staged_times and self._defer_ok(now):
                h = self._timers["negotiate"]
                self._defer_until = h.first + (h.k + 1) * h.interval
            else:
                self.collector.quiesce()
                self._defer_until = -math.inf
        else:
            self.collector.run_cycle(self.queue, now)

    def _defer_ok(self, now: float) -> bool:
        """May the staged negotiation backlog stay unflushed until the
        next negotiate firing?  Yes only when the window [now, t_next]
        is provably unobservable:

          * no live event fires before the (t_next, P_NEGOTIATE) slot —
            reconciles, backend ticks, stragglers, metrics, external
            injections, and same-instant followers all veto
            (`EventLoop.has_event_before`);
          * no running claim can complete inside the window (capacity
            return would have to be negotiated), and none runs an
            opaque `work_fn`;
          * no worker's idle timeout can expire inside it (C2
            self-termination is a pool change).

        Completion times are computed from `_advanced_until` — claim
        remaining_s is exact as of the last advancement, which deferral
        itself parks — so the check stays exact across chained
        windows."""
        h = self._timers.get("negotiate")
        if h is None or h.cancelled:
            return False
        t_next = h.first + (h.k + 1) * h.interval
        if self.loop.has_event_before(t_next, P_NEGOTIATE):
            return False
        margin = 1e-6
        horizon = t_next + margin
        base = self._advanced_until
        for w in self.collector.workers.values():
            if w.terminated:
                continue
            if w.idle_timeout <= (t_next - now) + margin:
                return False
            if w.claimed:
                for job in w.claimed.values():
                    if job.work_fn is not None:
                        return False
                    rate = w.work_rate
                    need = (job.remaining_s / rate if rate > 0
                            else math.inf)
                    if base + need <= horizon:
                        return False
            elif (not w.draining and w.idle_since >= 0
                    and w.idle_since + w.idle_timeout <= horizon):
                return False
        return True

    def quiesce_negotiation(self) -> int:
        """Flush any deferred negotiation backlog NOW and bring worker
        advancement back up to the current instant — the boundary call
        every external observer goes through (snapshots, runtime
        reconfiguration, service-driver injections, end of run()).
        Returns claims made by the flush."""
        if self.engine != "event":
            return 0
        claims = self.collector.quiesce()
        self._defer_until = -math.inf
        self._advance_unchecked(self.loop.now)
        return claims

    def _straggler_cb(self, now: float):
        self.straggler_policy.tick(self.pool_queue, self.collector,
                                   self.cluster_view, now)

    def _record_cb(self, now: float):
        self.recorder.record(
            now,
            idle_jobs=self.pool_queue.n_idle(),
            running_jobs=self.pool_queue.n_running(),
            pending_pods=len(self.cluster_view.pending_pods()),
            running_pods=len(self.cluster_view.running_pods()),
            ready_workers=len(self.collector.alive_workers(now)),
            busy_workers=sum(
                1 for w in self.collector.workers.values() if w.claimed
            ),
            live_nodes=sum(len(b.cluster.nodes) for b in self.backends),
            idle_cohorts=self.pool_queue.n_idle_cohorts(),
            provisioned_cores=sum(
                n.capacity.get("cpu", 0)
                for b in self.backends for n in b.cluster.nodes.values()
            ),
            cost_rate=sum(b.cost_rate() for b in self.backends),
        )
        if len(self.backends) > 1:
            for b in self.backends:
                self.recorder.record_backend(
                    now, b.name,
                    pending_pods=b.pending(None),
                    live_pods=b.live_pods(),
                    live_nodes=len(b.cluster.nodes),
                    cost_rate=b.cost_rate(),
                )
        if self.flocking:
            self._record_flocking(now)

    def _record_flocking(self, now: float):
        """Per-schedd and per-user fair-share gauges (idle, running,
        effective priority, starvation age) — the Fig 2/3-style series
        split by community that the compare harness surfaces."""
        deficits = self.provisioner.stats.per_schedd_deficit
        # per-user gauges are aggregated across schedds (users are
        # pool-global in the accountant, as in HTCondor)
        idle_u: dict[str, tuple[int, float]] = {}
        running_u: dict[str, int] = {}
        for q in self.queues:
            self.recorder.record_schedd(
                now, q.name,
                idle_jobs=q.n_idle(),
                running_jobs=q.n_running(),
                deficit=deficits.get(q.name, 0),
            )
            for user, (n, age) in q.idle_by_user(now).items():
                pn, page = idle_u.get(user, (0, 0.0))
                idle_u[user] = (pn + n, max(page, age))
            for user, n in q.running_by_user.items():
                running_u[user] = running_u.get(user, 0) + n
        for user in sorted(set(idle_u) | set(running_u)):
            n, age = idle_u.get(user, (0, 0.0))
            gauges = {
                "idle_jobs": n,
                "running_jobs": running_u.get(user, 0),
                "starvation_age_s": age,
            }
            if self.accountant is not None:
                gauges["effective_priority"] = (
                    self.accountant.effective_priority(user, now))
            self.recorder.record_user(now, user, **gauges)

    def _advance_to(self, t: float):
        """Integrate continuous state (running jobs, worker clocks) up to
        exactly `t` — called before every event fires.  While a
        negotiation backlog is deferred (staged cycles pending and `t`
        inside the armed horizon) advancement is parked: `flush_staged`
        replays it segment-by-segment at the staged timestamps through
        `Collector.advance_hook`, reproducing the per-cycle run's exact
        advancement boundaries."""
        if self.collector._staged_times:
            if t <= self._defer_until + 1e-9:
                return
            # horizon overrun (should not happen: _defer_ok vetoes any
            # event inside the window) — flush before advancing past it
            self.collector.quiesce()
        self._advance_unchecked(t)

    def _advance_unchecked(self, t: float):
        if t <= self._advanced_until:
            return
        dt = t - self._advanced_until
        advance_workers(self.collector, self.pool_queue, self.cluster_view,
                        self._advanced_until, dt)
        self._advanced_until = t

    @classmethod
    def from_config(cls, cfg: ProvisionerConfig, **kw) -> "Simulation":
        """Build the federation declared by `[backend:<name>]` sections;
        falls back to the single-backend constructor when none exist."""
        if cfg.backends and "backends" not in kw:
            kw["backends"] = build_backends(cfg)
        return cls(cfg, **kw)

    def backend(self, name: str):
        return self.provisioner.backend(name)

    # -- runtime reconfiguration (pool service) ------------------------------
    def drain_backend(self, name: str):
        """Gracefully retire a backend without restarting the pool: stop
        routing to it (healthy() goes False), delete its never-placed
        pending pods, and flag its booted workers `draining` so they take
        no new claims and retire the moment their running jobs complete.
        The backend's periodic tick keeps firing until `live_pods()`
        reaches zero, then `_detach_backend` freezes its accounting and
        cancels its timers.  Event engine only."""
        if self.engine != "event":
            raise ValueError("drain_backend requires engine='event'")
        self.quiesce_negotiation()  # staged cycles see the pre-drain pool
        b = self.provisioner.backend(name)      # KeyError on unknown
        b.draining = True
        now = self.loop.now
        owned = lambda p: p.labels.get("owner") == "prp-provisioner"
        for pod in list(b.cluster.pending_pods(owned)):
            # pending pods never placed — nothing is running on them
            b.cluster.delete_pod(pod.name, now, "drain")
        running = {p.name for p in b.cluster.running_pods(owned)}
        for w in self.collector.workers.values():
            if w.pod_name in running:
                w.draining = True
        if b.live_pods() == 0:
            self._detach_backend(b, now)

    def _detach_backend(self, b, now: float):
        """Remove an emptied, draining backend from the live federation:
        flush its accounting to `now` (cost accrual FREEZES here — a
        detached backend bills nothing further), cancel its tick timers,
        and move it to `detached_backends` so summary() still counts its
        accrued cost, node-seconds, and stats."""
        b.cluster.tick_accounting(0.0, now)
        accrue = getattr(b, "accrue_cost", None)
        if accrue is not None:
            accrue(now)
        for h in self._backend_timers.pop(b.name, []):
            self.loop.cancel(h)
        self.backends.remove(b)
        if b in self.provisioner.backends:
            self.provisioner.backends.remove(b)
        if b in self.cluster_view.backends:
            self.cluster_view.backends.remove(b)
        self.detached_backends.append(b)

    def add_backend(self, backend):
        """Attach a new resource provider at runtime.  Its periodic tick
        lands on the same global tick grid as the original backends (next
        multiple of tick_s), preceded by a zero-dt priming pass so the
        next reconcile's pods place immediately.  Cost accrual and node
        alive-time start at attach, not at the epoch."""
        if self.engine != "event":
            raise ValueError("add_backend requires engine='event'")
        self.quiesce_negotiation()
        taken = ({b.name for b in self.backends}
                 | {b.name for b in self.detached_backends})
        if backend.name in taken:
            raise ValueError(f"backend {backend.name!r} already exists")
        rebase = getattr(backend, "rebase", None)
        if rebase is not None:
            rebase(self.loop.now)
        self.backends.append(backend)
        self.provisioner.backends.append(backend)
        self.cluster_view.backends.append(backend)
        self._install_backend_timer(backend, prime=True)

    def add_schedd(self, name: str, *, quota: float = 1.0):
        """Attach a new submit host at runtime (flocking pools only).
        The queue shares the pool-unique jid counter, joins the flocking
        negotiation order LAST, and gets a fair-share quota if an
        accountant is wired."""
        if not self.flocking:
            raise ValueError(
                "add_schedd requires a flocking simulation "
                "(construct with schedds=... or fairshare=...)")
        if any(q.name == name for q in self.queues):
            raise ValueError(f"schedd {name!r} already exists")
        self.quiesce_negotiation()  # flocking order changes below
        q = JobQueue(name=name, ids=self.queues[0]._ids)
        self.queues.append(q)
        self.pool_queue.queues.append(q)
        self.provisioner.attach_queue(q)
        self.provisioner.schedd_quotas[name] = quota
        if self.accountant is not None:
            self.accountant.set_quota(name, quota)
            self.accountant.attach_queue(name, q)
        self.schedd_specs.append(ScheddSpec(name=name, quota=quota))
        self.telemetry.attach_queue(q)
        return q

    def drain_schedd(self, name: str):
        """Stop accepting submissions on one schedd; its queued and
        running jobs keep negotiating and complete normally.  Call
        `detach_schedd` once it has fully drained."""
        self.quiesce_negotiation()
        self.queue_named(name).draining = True

    def detach_schedd(self, name: str):
        """Remove a drained, empty schedd from the federation.  The
        accountant keeps its historical usage (decayed as usual)."""
        q = self.queue_named(name)
        if not q.draining:
            raise ValueError(f"schedd {name!r} is not draining")
        if not q.drained():
            raise ValueError(f"schedd {name!r} still has jobs")
        if len(self.queues) == 1:
            raise ValueError("cannot detach the last schedd")
        self.quiesce_negotiation()
        self.queues.remove(q)
        self.pool_queue.queues.remove(q)
        self.provisioner.detach_queue(q)
        self.provisioner.schedd_quotas.pop(name, None)
        self.schedd_specs = [s for s in self.schedd_specs
                             if s.name != name]
        self.queue = self.queues[0]
        self.provisioner.queue = self.provisioner.queues[0]

    # -- snapshot / resume ---------------------------------------------------
    def state_dict(self, *, allow_pending_external: bool = False) -> dict:
        """Serialize the COMPLETE pool state as a JSON-safe dict, such
        that `restore()` on a freshly constructed, identically configured
        Simulation continues bit-identically to the uninterrupted run.

        Iteration orders are state here (advertise order drives
        advance_workers, node order breaks best-fit ties, cohort order
        drives negotiation FIFO) — every dict below is serialized in its
        live order and rebuilt by insertion, never recomputed or sorted.

        Requires a QUIESCENT instant: every event at `self.now` has
        fired (run()/the service driver guarantee this between timestamp
        groups).  Periodic timers are NOT serialized — restore()
        re-installs them re-phased onto their original grids.  External
        events scheduled via `at()` cannot be serialized (arbitrary
        closures); callers owning such events as data — the pool service
        keeps its pending arrivals as trace records — pass
        `allow_pending_external=True` and re-schedule them after
        restore().  Straggler-policy internal memory is not carried."""
        if self.engine != "event":
            raise ValueError("state_dict requires engine='event'")
        self.quiesce_negotiation()  # staged cycles are not serializable
        if self._external_pending > 0 and not allow_pending_external:
            raise ValueError(
                f"{self._external_pending} external event(s) still "
                "pending — their closures cannot be serialized; either "
                "run past them or pass allow_pending_external=True and "
                "re-schedule them after restore()")
        nxt = self.loop.next_at()
        if nxt is not None and nxt <= self.now:
            raise ValueError(
                f"snapshot requires a quiescent instant: events still "
                f"due at t={nxt} (now={self.now})")
        self._flush_accounting()
        # peek the shared jid counter non-destructively
        next_jid = next(self.queues[0]._ids)
        shared = itertools.count(next_jid)
        for q in self.queues:
            q._ids = shared
        state: dict[str, Any] = {
            "version": 1,
            "t": self.now,
            "flocking": self.flocking,
            "next_jid": next_jid,
            "schedds": [{"name": s.name, "quota": s.quota}
                        for s in self.schedd_specs],
            "queues": [q.state_dict() for q in self.queues],
            "accountant": (self.accountant.state_dict()
                           if self.accountant is not None else None),
            "workers": [worker_state(w) for w in self.all_workers],
            "advertised": list(self.collector.workers.keys()),
            "backends": [b.state_dict() for b in self.backends],
            "detached_backends": [b.state_dict()
                                  for b in self.detached_backends],
            "provisioner": self.provisioner.state_dict(),
            "recorder": {
                "series": {k: [[t, v] for t, v in pts]
                           for k, pts in self.recorder.series.items()},
                "last_sample": self.recorder._last_sample,
                "sample_interval_s": self.recorder.sample_interval_s,
            },
            "rng": self.rng.bit_generator.state,
            "last_negotiate": self._last_negotiate,
        }
        if self.telemetry.enabled:
            # registry values + lifecycle event log (sim-time data);
            # the profiler's wall-clock cycle log intentionally resets
            # on restore (see Telemetry.state_dict).  The key is absent
            # for telemetry-disabled sims, so their snapshots are
            # byte-identical to pre-telemetry ones.
            state["telemetry"] = self.telemetry.state_dict()
        return state

    def restore(self, state: dict):
        """Load a `state_dict()` snapshot into this freshly constructed
        Simulation (same config, same constructor arguments; schedds
        added at runtime before the snapshot are re-created here, but
        runtime-added BACKENDS must be `add_backend`ed by the caller
        first — the pool service does this from its stored config).  A
        fresh EventLoop is started at the snapshot time and every
        periodic is re-installed, in original install order, re-phased
        onto its original cadence grid."""
        if self.engine != "event":
            raise ValueError("restore requires engine='event'")
        if self.now != 0.0 or self.all_workers:
            raise ValueError(
                "restore() requires a freshly constructed Simulation")
        if bool(state["flocking"]) != self.flocking:
            raise ValueError("flocking mismatch between snapshot and sim")

        # schedds: re-create runtime-added ones, then validate order
        specs = state["schedds"]
        for spec in specs[len(self.queues):]:
            self.add_schedd(spec["name"],
                            quota=float(spec.get("quota", 1.0)))
        names = [q.name for q in self.queues]
        if names != [s["name"] for s in specs]:
            raise ValueError(
                f"schedd mismatch: snapshot has "
                f"{[s['name'] for s in specs]}, sim has {names}")

        shared = itertools.count(int(state["next_jid"]))
        for q, qs in zip(self.queues, state["queues"]):
            q._ids = shared
            q.load_state(qs)
        jobs_by_jid = {j.jid: j
                       for q in self.queues for j in q._jobs.values()}

        acc_state = state.get("accountant")
        if (acc_state is None) != (self.accountant is None):
            raise ValueError(
                "accountant presence mismatch between snapshot and sim")
        if acc_state is not None:
            self.accountant.restore(acc_state)

        self.all_workers = [worker_from_state(ws, jobs_by_jid)
                            for ws in state["workers"]]
        by_name = {w.name: w for w in self.all_workers}
        self.collector.workers = {n: by_name[n]
                                  for n in state["advertised"]}

        live = {b.name: b for b in self.backends}
        for bs in state["backends"]:
            b = live.get(bs["name"])
            if b is None:
                raise ValueError(
                    f"snapshot backend {bs['name']!r} not present — "
                    "add_backend() it before restore()")
            b.load_state(bs)
        for ds in state["detached_backends"]:
            b = live.get(ds["name"])
            if b is None:
                raise ValueError(
                    f"snapshot detached backend {ds['name']!r} not "
                    "present — add_backend() it before restore()")
            b.load_state(ds)
            self.backends.remove(b)
            self.provisioner.backends.remove(b)
            self.cluster_view.backends.remove(b)
            self.detached_backends.append(b)
        want = [bs["name"] for bs in state["backends"]]
        have = [b.name for b in self.backends]
        if have != want:
            raise ValueError(
                f"backend order mismatch: snapshot {want}, sim {have}")

        self.provisioner.load_state(state["provisioner"])
        self.provisioner.rewire_pods(by_name)

        rec = state["recorder"]
        self.recorder.series = {
            k: [(float(t), float(v)) for t, v in pts]
            for k, pts in rec["series"].items()}
        self.recorder._last_sample = float(rec["last_sample"])
        if rec.get("sample_interval_s") is not None:
            self.recorder.sample_interval_s = rec["sample_interval_s"]

        self.rng.bit_generator.state = state["rng"]
        self._last_negotiate = float(state["last_negotiate"])

        tel_state = state.get("telemetry")
        if tel_state is not None and self.telemetry.enabled:
            self.telemetry.load_state(tel_state)

        t = float(state["t"])
        self.loop = EventLoop(t)
        self.now = t
        self._advanced_until = t
        self._defer_until = -math.inf   # snapshots are quiescent
        self._external_pending = 0
        self._timers = {}
        self._backend_timers = {}
        self._reinstall_periodics_at(t)
        return self

    def _reinstall_periodics_at(self, t: float):
        """Re-install every periodic on a fresh loop, re-phased onto its
        ORIGINAL grid (reconcile/negotiate/metrics anchored at 0,
        backends on the tick grid, stragglers offset one tick), in the
        same order as `_install_periodics` — same-(t, priority) firing
        order is part of the determinism contract."""
        self._timers["reconcile"] = self.provisioner.schedule_on(
            self.loop,
            first=self._next_cadence(t, self.cfg.submit_interval_s, 0.0),
            priority=P_RECONCILE)
        for backend in self.backends:
            self._install_backend_timer(backend, prime=False)
        self._timers["negotiate"] = self.loop.every(
            self.negotiate_interval_s, self._negotiate_cb,
            first=self._next_cadence(t, self.negotiate_interval_s, 0.0),
            name="negotiate", priority=P_NEGOTIATE)
        if self.straggler_policy is not None:
            self._timers["stragglers"] = self.loop.every(
                self.tick_s, self._straggler_cb,
                first=self._next_cadence(t, self.tick_s, self.tick_s),
                name="stragglers", priority=P_STRAGGLER)
        self._timers["metrics"] = self.loop.every(
            self.metrics_interval_s, self._record_cb,
            first=self._next_cadence(t, self.metrics_interval_s, 0.0),
            name="metrics", priority=P_METRICS)

    # -- event helpers -------------------------------------------------------
    def at(self, t: float, fn: Callable[["Simulation", float], None],
           name: str = ""):
        """Schedule an external event; under the event engine it fires at
        EXACTLY `t` (the seed fired it at the first tick >= t).  A time
        at or before `now` fires as soon as the clock next advances —
        the seed accepted late events the same way."""
        if self.engine == "tick":
            self.events.append(TimedEvent(t, fn, name))
            return
        self._external_pending += 1

        def fire(now: float):
            self._external_pending -= 1
            fn(self, now)

        self.loop.schedule(max(t, self.loop.now), fire, name=name,
                           priority=P_EXTERNAL)

    def queue_named(self, schedd: str | int | None) -> JobQueue:
        """Resolve a schedd by name or flocking index (None: first)."""
        if schedd is None:
            return self.queue
        if isinstance(schedd, int):
            return self.queues[schedd]
        for q in self.queues:
            if getattr(q, "name", None) == schedd:
                return q
        raise KeyError(f"no schedd named {schedd!r}; "
                       f"have {[q.name for q in self.queues]}")

    def submit_jobs(self, t: float, jobs: Iterable[Job],
                    schedd: str | int | None = None):
        """Submit a batch at time `t`, to one schedd's queue (`schedd`
        names or indexes it; default: the first/only queue).  Lists/
        tuples are counted up front (for the event name); any OTHER
        iterable — a generator, a streaming trace reader — is kept lazy
        and only drawn when the event fires, so scheduling a 100k-job
        campaign materializes zero `Job` objects until its arrival time
        (workload/replay.py spreads the draw across many events).  Lazy
        iterables are consumed exactly once: re-running the simulation
        needs a fresh one."""
        target = self.queue_named(schedd)
        if getattr(target, "draining", False):
            raise ValueError(
                f"schedd {target.name!r} is draining and accepts no "
                "new submissions")
        if isinstance(jobs, (list, tuple)):
            batch = list(jobs)

            def fire(sim: "Simulation", now: float):
                for j in batch:
                    target.submit(j, now)

            self.at(t, fire, name=f"submit x{len(batch)}")
            return

        def fire_lazy(sim: "Simulation", now: float):
            for j in jobs:
                target.submit(j, now)

        self.at(t, fire_lazy, name="submit (lazy)")

    def inject_node_failure(self, t: float, node_name: str | None = None,
                            backend: str | None = None):
        def fire(sim: "Simulation", now: float):
            cluster = (sim.backend(backend).cluster if backend is not None
                       else sim.cluster)
            names = list(cluster.nodes)
            if not names:
                return
            target = node_name or names[
                int(sim.rng.integers(0, len(names)))
            ]
            cluster.fail_node(target, now)

        self.at(t, fire, name="node_failure")

    def inject_slow_workers(self, t: float, frac: float = 0.3,
                            rate: float = 0.2):
        """Degrade a fraction of BUSY workers to `rate` speed (straggling
        nodes: thermal throttling, failing HBM, noisy neighbours)."""

        def fire(sim: "Simulation", now: float):
            busy = [w for w in sim.collector.workers.values() if w.claimed]
            k = max(1, int(len(busy) * frac)) if busy else 0
            idx = sim.rng.permutation(len(busy))[:k]
            for i in idx:
                busy[i].work_rate = rate

        self.at(t, fire, name="slow_workers")

    def inject_pod_preemption(self, t: float, frac: float = 0.5,
                              backend: str | None = None):
        """Spot-style reclaim of a fraction of running provisioner pods —
        across the whole federation, or on one named backend."""

        def fire(sim: "Simulation", now: float):
            if backend is not None:
                sim.backend(backend).reclaim(frac, now, sim.rng)
                return
            pods = sim.cluster_view.running_pods(
                lambda p: p.labels.get("owner") == "prp-provisioner"
            )
            k = max(1, int(len(pods) * frac)) if pods else 0
            idx = sim.rng.permutation(len(pods))[:k]
            by_name = {b.name: b for b in sim.backends}
            for i in idx:
                owner = by_name.get(pods[i].labels.get("backend", ""))
                sim.cluster_view.delete_pod(pods[i].name, now, "preempted")
                if owner is not None:
                    owner.stats.pods_reclaimed += 1

        self.at(t, fire, name="pod_preemption")

    # -- main loop --------------------------------------------------------------
    def step(self):
        """Advance one tick's worth of simulated time (compat shim; the
        event engine fires every event in (now, now+tick_s] exactly)."""
        if self.engine == "tick":
            self._step_tick()
        else:
            self.run(self.now + self.tick_s)

    def _step_tick(self):
        """The seed's fixed-tick loop, kept verbatim as the benchmark
        baseline: O(events) scan, per-job negotiation, drifting cadences,
        tick-quantized event firing."""
        now, dt = self.now, self.tick_s

        # 1. external events (fire up to tick_s late; see event engine)
        due = [e for e in self.events if e.at <= now]
        self.events = [e for e in self.events if e.at > now]
        for e in sorted(due, key=lambda e: e.at):
            e.fn(self, now)

        # 2. provisioner
        self.provisioner.maybe_reconcile(now)

        # 3. backends: autoscale, schedule, account (C7 + §5).  The seed
        #    integrated [now, now+dt] forward; with lazy accounting that
        #    means bringing the integrals up to the interval END.
        for backend in self.backends:
            backend.tick(now, dt)
            backend.cluster.tick_accounting(0.0, now + dt)

        # 4. negotiation (last = now accumulates drift when the interval
        #    is not a multiple of tick_s — the event engine fixes this)
        if now - self._last_negotiate >= self.negotiate_interval_s:
            # flocking order, per-queue scans: the tick engine stays the
            # seed's per-job oracle (candidates re-listed per queue so
            # partial capacity carries across schedds via live offers)
            for q in self.queues:
                self.collector.scan_cycle(q, now)
            self._last_negotiate = now

        # 5. workers advance (per-job idle polling, tick-quantized
        #    completions — the seed's exact semantics)
        advance_workers(self.collector, self.pool_queue, self.cluster_view,
                        now, dt, scan_matches=True, exact_completions=False)

        # 5b. straggler mitigation (beyond-paper; see core/stragglers.py)
        if self.straggler_policy is not None:
            self.straggler_policy.tick(self.pool_queue, self.collector,
                                       self.cluster_view, now)

        # 6. metrics
        self._record_cb(now)
        self.now += dt

    def run(self, until: float):
        if self.engine == "tick":
            while self.now < until:
                self._step_tick()
            self._flush_accounting()
            return
        if until <= self.now:
            return
        self.loop.run_until(until, pre=self._advance_to)
        # a deferred negotiation backlog must not outlive the run call:
        # callers observe state between runs
        self.quiesce_negotiation()
        self._advance_unchecked(until)
        self.now = until
        self._flush_accounting()

    def drained(self) -> bool:
        """Every schedd's queue is empty (single-queue: the queue's)."""
        return self.pool_queue.drained()

    def run_until_drained(self, max_t: float = 1e6):
        if self.engine == "tick":
            while ((self.events or not self.drained())
                   and self.now < max_t):
                self._step_tick()
            self._flush_accounting()
            return
        while ((self._external_pending > 0 or not self.drained())
               and self.now < max_t):
            t = self.loop.next_at()
            if t is None or t > max_t:
                self.run(max_t)
                break
            self._advance_to(t)
            self.loop.fire_next()
            self.now = self.loop.now
        self.quiesce_negotiation()
        self._flush_accounting()

    def _flush_accounting(self):
        """Bring every backend's lazy node integrals AND cost accrual up
        to `self.now` — run()/run_until_drained() can stop between
        backend ticks, and the summary must not read integrals stale by
        a partial tick (or miss the final partial interval's cost)."""
        for b in self.backends:
            b.cluster.tick_accounting(0.0, self.now)
            accrue = getattr(b, "accrue_cost", None)
            if accrue is not None:
                accrue(self.now)

    # -- telemetry exporters -------------------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition of the pool registry (the service
        tier serves this at GET /metrics.prom).  Works with telemetry
        disabled too — pool gauges and consolidated cache counters are
        always live; spans/profiler series appear when enabled."""
        return self.telemetry.prometheus_text()

    def dump_trace(self, path: str) -> int:
        """Write Chrome trace-event JSON (Perfetto / chrome://tracing)
        of lifecycle spans + negotiation/reconcile phases.  Requires
        telemetry=True.  Returns the number of trace events written."""
        return self.telemetry.dump_trace(path)

    # -- summaries -----------------------------------------------------------------
    def summary(self) -> dict[str, Any]:
        self._flush_accounting()
        out: dict[str, Any] = {}
        completed = (self.queue.completed_log if not self.flocking
                     else [j for q in self.queues
                           for j in q.completed_log])
        out["jobs"] = summarize_jobs(completed, self.now)
        if self.flocking:
            out["schedds"] = {
                q.name: summarize_jobs(q.completed_log, self.now)
                for q in self.queues
            }
            if self.accountant is not None:
                out["fairshare"] = self.accountant.snapshot(self.now)
        out["workers"] = summarize_workers(self.all_workers)
        out["pods_submitted"] = self.provisioner.stats.submitted
        if self.autoscaler is not None:
            out["nodes"] = {
                "provisioned": self.autoscaler.provisioned_total,
                "deprovisioned": self.autoscaler.deprovisioned_total,
                "waste_fraction": self.autoscaler.waste_fraction(),
            }
        # detached (drained) backends stopped accruing at detach but
        # their history still counts toward utilization and spend
        every = self.backends + self.detached_backends
        cap = busy = 0.0
        for b in every:
            c, u = b.cluster.resource_seconds("gpu")
            cap += c
            busy += u
        out["gpu_utilization"] = busy / cap if cap > 0 else 0.0
        out["cost_total"] = sum(b.stats.cost_total for b in every)
        out["backends"] = summarize_backends(every)
        return out


# ---------------------------------------------------------------------------
# Convenience builders used by benchmarks/examples
# ---------------------------------------------------------------------------

def gpu_job(runtime_s: float, *, gpus: int = 1, cpus: int = 1,
            memory_gb: int = 4, arch: str | None = None,
            checkpoint_interval_s: float | None = None,
            extra_ad: dict | None = None) -> Job:
    ad: dict[str, Any] = {
        "request_cpus": cpus,
        "request_gpus": gpus,
        "request_memory": memory_gb,
        "request_disk": 8,
    }
    if arch is not None:
        ad["arch"] = arch
    if checkpoint_interval_s:
        ad["checkpoint_interval_s"] = checkpoint_interval_s
    ad.update(extra_ad or {})
    return Job(ad=ad, runtime_s=runtime_s)


def onprem_nodes(n: int, *, gpus: int = 8, cpus: int = 64,
                 memory_gb: int = 512, labels: dict | None = None,
                 prefix: str = "onprem") -> list[Node]:
    return [
        Node(
            name=f"{prefix}-{i}",
            capacity={"cpu": cpus, "gpu": gpus, "memory": memory_gb,
                      "disk": 1024},
            labels=dict(labels or {}),
        )
        for i in range(n)
    ]
