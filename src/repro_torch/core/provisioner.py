"""The auto-scaling provisioning service (paper §2–§3).

Reconciliation loop (C1), run every ``submit_interval_s``:

  1. snapshot idle jobs ACROSS EVERY SCHEDD feeding the pool; keep
     those passing the job filter (C3)
  2. subtract what the next negotiation cycle will absorb anyway: a
     claim-free dry run (`Collector.preview`) of the idle
     cohorts against current free capacity — including partial slots —
     leaves the POST-negotiation idle demand (the old unclaimed-worker
     count double-counted jobs about to match existing capacity)
  3. group the remainder by requirement signature (C4); per group:
     deficit = post-negotiation idle − pending pods of the group
  4. split ``min(deficit, limits)`` across the scaling backends via the
     configured RoutingPolicy; submit pods whose requests equal the
     signature and whose START expression is the pushed-down filter

Flocking: the provisioner serves an ordered list of schedd queues (a
single `JobQueue` still works — it becomes a one-element list, the same
compat pattern as the backend adapter).  Deficits are attributed per
schedd, and when pod-count room is scarce, groups are served by OWED
SHARE — demand weighted by 1/quota of the schedds it came from — rather
than raw idle counts, so an underserved community's demand is
provisioned for first.

Scale-down is NOT here: workers self-terminate when idle (C2, worker.py),
exactly as in the paper ("pods are configured to self-terminate if no user
jobs are waiting").  The provisioner also never deletes pending pods by
default — HTCondor demand is bursty and a pending pod is free; an optional
``cancel_stale_pending_s`` reaps pods pending longer than the horizon
(useful with the node autoscaler off).

Federation (backend API): the provisioner holds an ordered list of
`ScalingBackend`s (see core/backend.py) instead of one hard-wired
`KubeCluster`; passing a bare `KubeCluster` still works and becomes the
single default backend — the paper's original deployment shape.

Anti-affinity convention from the paper's INI (config.py): node_affinity
keys starting with ^ must NOT match.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Any, Callable

from repro_torch.core.backend import (
    KubeBackend, PodSpec, RoutingPolicy, adapt_single_cluster,
    make_routing_policy,
)
from repro_torch.core.cluster import KubeCluster, Pod
from repro_torch.core.config import ProvisionerConfig
from repro_torch.core.groups import (
    GroupSignature, group_jobs, matches_signature, signature_of,
)
from repro_torch.core.jobqueue import JobQueue
from repro_torch.core.worker import Collector, LRUCache, Worker


@dataclasses.dataclass
class ProvisionStats:
    submitted: int = 0
    reaped_pending: int = 0
    per_group_submitted: dict = dataclasses.field(default_factory=dict)
    per_backend_submitted: dict = dataclasses.field(default_factory=dict)
    # post-negotiation idle demand attributed to each schedd at the
    # last reconcile (owed-share routing reads this; so do metrics)
    per_schedd_deficit: dict = dataclasses.field(default_factory=dict)


class Provisioner:
    """One instance per HTCondor pool; federates any number of resource
    providers — the paper's operation mode (a); mode (b) layers a dedicated
    local pool in front (see examples/grid_portal.py)."""

    COHORT_CACHE_MAX = 50_000    # entries; reset-on-full (pure caches)
    PREVIEW_CACHE_MAX = 256      # per-candidate dry-run memo entries

    def __init__(
        self,
        cfg: ProvisionerConfig,
        queue: JobQueue | list | tuple,
        collector: Collector,
        backends: KubeCluster | list | tuple,
        *,
        routing: RoutingPolicy | None = None,
        cancel_stale_pending_s: float | None = None,
        worker_factory: Callable[..., Worker] | None = None,
        schedd_quotas: dict[str, float] | None = None,
        debug_exact_deficits: bool = False,
        telemetry=None,
    ):
        self.cfg = cfg
        # one schedd or a flocking-ordered list of them (compat adapter,
        # mirroring the single-cluster backend adapter)
        self.queues = (list(queue) if isinstance(queue, (list, tuple))
                       else [queue])
        if not self.queues:
            raise ValueError("Provisioner needs at least one queue")
        self.queue = self.queues[0]
        self.schedd_quotas = dict(schedd_quotas or {})
        self.collector = collector
        if isinstance(backends, KubeCluster):
            backends = [adapt_single_cluster(backends)]
        elif not isinstance(backends, (list, tuple)):
            backends = [backends]          # a single ScalingBackend
        self.backends = list(backends)
        if not self.backends:
            raise ValueError("Provisioner needs at least one backend")
        self.routing = routing or make_routing_policy(cfg.routing_policy)
        self.filter = cfg.filter_expr()
        self.start_expr = cfg.start_expr()
        self.cancel_stale_pending_s = cancel_stale_pending_s
        self.worker_factory = worker_factory
        self._ids = itertools.count()
        self._last_run = -1e18
        self.stats = ProvisionStats()
        # per-cohort memoization: the filter verdict and the group
        # signature are pure functions of a cohort's (identical) ads
        self._cohort_filter: dict[tuple, bool] = {}
        self._cohort_sig: dict[tuple, GroupSignature] = {}
        # per-candidate LRU memo over the negotiation dry run: an IDLE
        # pool reconciles every interval against unchanged demand and
        # capacity, and the preview is the expensive half of the pass.
        # Keyed on (per-queue idle fingerprint, ready-worker free-matrix
        # digest): any claim/release/boot/death changes a worker's free
        # vector, any submit/remove changes an idle count, and a
        # cohort-set change bumps idle_version — so a hit implies an
        # identical dry run.  Multi-entry (was: latest-only) so each
        # distinct candidate pool state keeps its own dry run and a
        # state that recurs non-consecutively — an A/B/A claim-release
        # flap, or alternating flocking phases — still hits.
        self._preview_cache = LRUCache(self.PREVIEW_CACHE_MAX)
        # shares the collector's telemetry (one registry per pool)
        # unless explicitly handed its own
        if telemetry is None:
            self.telemetry = collector.telemetry
        else:
            from repro_torch.observability import as_telemetry
            self.telemetry = as_telemetry(telemetry)
        reg = self.telemetry.registry
        self._c_preview_hits = reg.counter(
            "repro_preview_cache_hits_total",
            "Reconciles served by the memoized negotiation dry run")
        self._c_preview_misses = reg.counter(
            "repro_preview_cache_misses_total",
            "Reconciles that re-ran the negotiation dry run")
        # worker free-matrix digest reuse (Worker.free_rev dirty flag):
        # an unclaimed-pool poll costs an int compare per worker, not a
        # vector rebuild + serialization
        self._c_digest_hits = reg.counter(
            "repro_free_digest_hits_total",
            "Worker free-digest polls answered by the free_rev flag")
        self._c_digest_misses = reg.counter(
            "repro_free_digest_misses_total",
            "Worker free-digest polls that rebuilt the vector digest")
        self._preview_s = 0.0     # preview wall accrued this reconcile
        # incremental deficit counters: filtered PRE-preview idle demand
        # per (group signature, schedd), maintained in O(changes) by the
        # queues' idle hooks instead of recounted per reconcile.  Stale
        # until first use and after queue attach/detach or load_state
        # (restores bypass hooks) — then rebuilt once from live cohorts.
        self._inc_counts: dict[GroupSignature, dict[str, int]] = {}
        self._counts_stale = True
        self._idle_hook_of: dict[int, Callable] = {}   # id(queue) -> fn
        for q in self.queues:
            self._register_idle_hook(q)
        #: differential oracle: re-derive deficits with the retired
        #: per-cycle scan on every reconcile and assert equality (debug
        #: flag; the flocking differential suite runs with it on)
        self.debug_exact_deficits = debug_exact_deficits

    # compat properties over the registry counters (the pre-registry int
    # attributes are part of the test surface)
    @property
    def preview_hits(self) -> int:
        return int(self._c_preview_hits.value)

    @property
    def preview_misses(self) -> int:
        return int(self._c_preview_misses.value)

    @property
    def digest_hits(self) -> int:
        return int(self._c_digest_hits.value)

    @property
    def digest_misses(self) -> int:
        return int(self._c_digest_misses.value)

    @property
    def cluster(self) -> KubeCluster:
        """Primary backend's placement surface (single-backend compat)."""
        return self.backends[0].cluster

    def backend(self, name: str):
        for b in self.backends:
            if b.name == name:
                return b
        raise KeyError(name)

    # -- helpers --------------------------------------------------------------
    def _pod_group_label(self, sig: GroupSignature) -> str:
        # stable across processes/restarts (builtin hash() is salted by
        # PYTHONHASHSEED and would orphan pending-pod counts on restart)
        payload = repr(dataclasses.astuple(sig)).encode()
        return f"grp-{hashlib.sha1(payload).hexdigest()[:10]}"

    def _group_pending(self, label: str) -> int:
        return sum(b.pending(label) for b in self.backends)

    def _group_unclaimed(self, sig: GroupSignature) -> int:
        return self.collector.unclaimed_capacity(
            lambda ad: matches_signature(ad, sig)
        )

    def _total_live_pods(self) -> int:
        return sum(b.live_pods() for b in self.backends)

    def _schedd_name(self, qi: int) -> str:
        return getattr(self.queues[qi], "name", None) or f"schedd{qi:02d}"

    def _cohort_ok(self, key, rep) -> bool:
        ok = self._cohort_filter.get(key)
        if ok is None:
            ok = self.filter.evaluate(rep.ad)
            if len(self._cohort_filter) >= self.COHORT_CACHE_MAX:
                # unique-ad workloads: bound the memos (pure caches,
                # safe to drop wholesale) — checked per insertion so
                # one huge pass cannot blow past the cap
                self._cohort_filter.clear()
                self._cohort_sig.clear()
            self._cohort_filter[key] = ok
        return ok

    def _cohort_signature(self, key, rep) -> GroupSignature:
        sig = self._cohort_sig.get(key)
        if sig is None:
            sig = signature_of(rep)
            self._cohort_sig[key] = sig
        return sig

    def _preview_cached(self, now: float) -> list[dict]:
        """Memoized `Collector.preview` dry run (see __init__)."""
        workers = []
        for w in self.collector.workers.values():
            if w.ready(now) and not w.draining:
                # the digest is cached on the worker's claim-set
                # revision (free_rev dirty flag): an unchanged worker
                # costs an int compare, not a vector rebuild + hash
                cached = w._free_digest
                if cached is not None and cached[0] == w.free_rev:
                    self._c_digest_hits.value += 1
                else:
                    self._c_digest_misses.value += 1
                workers.append((w.name, w.free_digest()))
        key = (
            tuple((q.idle_version, q.n_idle()) for q in self.queues),
            tuple(workers),
        )
        cached = self._preview_cache.get(key)
        if cached is not None:
            self._c_preview_hits.value += 1
            return cached
        self._c_preview_misses.value += 1
        prof = self.telemetry.profiler
        t_p0 = prof.now() if prof is not None else 0.0
        previews = self.collector.preview(self.queues, now)
        if prof is not None:
            self._preview_s += prof.now() - t_p0
        self._preview_cache.put(key, previews)
        return previews

    # -- incremental deficit counters (idle hooks) ---------------------------
    def _register_idle_hook(self, q) -> None:
        if not hasattr(q, "add_idle_hook") or id(q) in self._idle_hook_of:
            return
        name = getattr(q, "name", None) or "schedd"

        def on_idle(job, delta: int, *, _name=name):
            if self._counts_stale:
                return          # a full rebuild is already scheduled
            key = job.cohort_key
            if not self._cohort_ok(key, job):
                return
            sig = self._cohort_signature(key, job)
            per = self._inc_counts.setdefault(sig, {})
            n = per.get(_name, 0) + delta
            if n:
                per[_name] = n
            else:
                per.pop(_name, None)
                if not per:
                    self._inc_counts.pop(sig, None)

        q.add_idle_hook(on_idle)
        self._idle_hook_of[id(q)] = on_idle

    def attach_queue(self, q) -> None:
        """Add a schedd queue to the federation at runtime: joins the
        deficit attribution LAST (flocking order) and gets an idle hook
        so the incremental counters keep tracking it."""
        if q not in self.queues:
            self.queues.append(q)
        self._register_idle_hook(q)
        self._counts_stale = True

    def detach_queue(self, q) -> None:
        """Remove a (drained) schedd queue: unhook it so later activity
        on the detached queue cannot leak into the counters."""
        self.queues.remove(q)
        self.queue = self.queues[0]
        fn = self._idle_hook_of.pop(id(q), None)
        if fn is not None and hasattr(q, "_idle_hooks"):
            q._idle_hooks.remove(fn)
        self._counts_stale = True

    def _rebuild_idle_counts(self) -> None:
        """One full recount of the filtered idle demand — only after
        construction, queue attach/detach, or a state restore (all of
        which bypass the hooks).  Every reconcile in between maintains
        the counters in O(idle-set changes)."""
        self._inc_counts = {}
        for qi, q in enumerate(self.queues):
            if not hasattr(q, "idle_cohorts"):
                continue
            name = self._schedd_name(qi)
            for key, jobs in q.idle_cohorts():
                if not jobs:
                    continue
                rep = next(iter(jobs.values()))
                if not self._cohort_ok(key, rep):
                    continue
                sig = self._cohort_signature(key, rep)
                per = self._inc_counts.setdefault(sig, {})
                per[name] = per.get(name, 0) + len(jobs)
        self._counts_stale = False

    def _idle_group_counts(self, now: float) -> tuple[
            dict[GroupSignature, int], dict[GroupSignature, dict], bool]:
        """Filtered POST-NEGOTIATION idle demand per requirement
        signature (C3 + C4), attributed per schedd.

        The pre-negotiation counts come from the incremental hook-fed
        counters (`_inc_counts` — O(changes) maintenance, not a recount;
        one ClassAd filter evaluation and one signature derivation per
        distinct ad ever).  What `Collector.preview` says the next
        negotiation cycle will absorb with capacity that already exists
        is then subtracted cohort-by-cohort, leaving post-negotiation
        demand.  Returns ``(counts, by_schedd, legacy)`` where `legacy`
        flags the foreign-queue fallback (pre-negotiation counts; the
        caller must subtract unclaimed workers as the seed did)."""
        if not all(hasattr(q, "idle_cohorts") for q in self.queues):
            # foreign queue exposing only the seed surface
            counts: dict[GroupSignature, int] = {}
            by_schedd: dict[GroupSignature, dict] = {}
            for qi, q in enumerate(self.queues):
                name = self._schedd_name(qi)
                idle = [j for j in q.idle_jobs()
                        if self.filter.evaluate(j.ad)]
                for sig, jobs in group_jobs(idle).items():
                    counts[sig] = counts.get(sig, 0) + len(jobs)
                    per = by_schedd.setdefault(sig, {})
                    per[name] = per.get(name, 0) + len(jobs)
            return counts, by_schedd, True
        if self._counts_stale:
            self._rebuild_idle_counts()
        previews = self._preview_cached(now)
        counts = {}
        by_schedd = {}
        for sig, per in self._inc_counts.items():
            n = sum(per.values())
            if n > 0:
                counts[sig] = n
                by_schedd[sig] = dict(per)
        # subtract preview absorption: map each absorbed cohort back to
        # its signature (memoized; cohorts absorbed is bounded by free
        # capacity, not queue depth)
        for qi, q in enumerate(self.queues):
            name = self._schedd_name(qi)
            for key, n_abs in previews[qi].items():
                rep = q.cohort_rep(key)
                if rep is None or not self._cohort_ok(key, rep):
                    continue
                sig = self._cohort_signature(key, rep)
                per = by_schedd.get(sig)
                if per is None:
                    continue
                take = min(int(n_abs), per.get(name, 0))
                if take <= 0:
                    continue
                per[name] -= take
                counts[sig] -= take
                if per[name] <= 0:
                    per.pop(name, None)
                if counts[sig] <= 0:
                    counts.pop(sig, None)
                    by_schedd.pop(sig, None)
        if self.debug_exact_deficits:
            oracle = self._idle_group_counts_scan(previews)
            assert (counts, by_schedd) == oracle, (
                "incremental deficits diverged from the dry-run oracle:"
                f"\n incremental: {(counts, by_schedd)}"
                f"\n oracle:      {oracle}")
        return counts, by_schedd, False

    def _idle_group_counts_scan(self, previews: list[dict]) -> tuple[
            dict[GroupSignature, int], dict[GroupSignature, dict]]:
        """The retired per-reconcile recount, kept verbatim as the
        differential oracle for the incremental counters
        (`debug_exact_deficits`; the flocking differential suite runs
        with it on)."""
        counts: dict[GroupSignature, int] = {}
        by_schedd: dict[GroupSignature, dict] = {}
        for qi, q in enumerate(self.queues):
            absorbed = previews[qi]
            name = self._schedd_name(qi)
            for key, jobs in q.idle_cohorts():
                if not jobs:
                    continue
                rep = next(iter(jobs.values()))
                if not self._cohort_ok(key, rep):
                    continue
                n = len(jobs) - absorbed.get(key, 0)
                if n <= 0:
                    continue
                sig = self._cohort_signature(key, rep)
                counts[sig] = counts.get(sig, 0) + n
                per = by_schedd.setdefault(sig, {})
                per[name] = per.get(name, 0) + n
        return counts, by_schedd

    def _owed_weight(self, n: int, per_schedd: dict) -> float:
        """Demand weighted by owed share: each schedd's contribution
        counts 1/quota-fold, so an underserved small-quota community
        does not get starved behind a big queue's raw counts.  With one
        schedd (or no quotas) this is exactly the raw idle count — the
        seed's ordering."""
        if len(self.queues) == 1 or not per_schedd:
            return float(n)
        return sum(k / self.schedd_quotas.get(s, 1.0)
                   for s, k in per_schedd.items())

    # -- the loop body ----------------------------------------------------------
    def reconcile(self, now: float) -> ProvisionStats:
        """One pass of the provisioning logic. Idempotent at fixed demand."""
        stats = ProvisionStats()
        prof = self.telemetry.profiler
        t_r0 = 0.0
        if prof is not None:
            t_r0 = prof.now()
            self._preview_s = 0.0

        groups, by_schedd, legacy = self._idle_group_counts(now)
        for sig, per in by_schedd.items():
            for name, k in per.items():
                stats.per_schedd_deficit[name] = (
                    stats.per_schedd_deficit.get(name, 0) + k)

        # ties on owed weight break on the stable group label, NOT dict
        # insertion order — a restored run rebuilds `groups` from
        # serialized cohort order and must submit pods identically
        for sig, n_idle in sorted(
            groups.items(),
            key=lambda kv: (-self._owed_weight(kv[1],
                                               by_schedd.get(kv[0], {})),
                            self._pod_group_label(kv[0]))
        ):
            label = self._pod_group_label(sig)
            pending = self._group_pending(label)
            if legacy:
                # seed semantics for foreign queues: pre-negotiation
                # idle minus zero-claim workers of the group
                deficit = n_idle - pending - self._group_unclaimed(sig)
            else:
                # n_idle is already post-negotiation (preview-adjusted)
                deficit = n_idle - pending
            if deficit <= 0:
                continue
            room_group = self.cfg.max_pods_per_group - pending
            room_total = self.cfg.max_total_pods - self._total_live_pods()
            n = max(0, min(deficit, room_group, room_total))
            if n <= 0:
                continue
            alloc = self.routing.split(
                n, sig.as_pod_request(), self.backends, now)
            submitted = 0
            for backend, k in alloc:
                for _ in range(k):
                    self._submit_pod(sig, label, now, backend)
                submitted += k
                stats.per_backend_submitted[backend.name] = (
                    stats.per_backend_submitted.get(backend.name, 0) + k)
            if submitted:
                stats.submitted += submitted
                stats.per_group_submitted[sig] = submitted

        if self.cancel_stale_pending_s is not None:
            for backend in self.backends:
                for pod in backend.cluster.pending_pods(
                    lambda p: p.labels.get("owner") == "prp-provisioner"
                ):
                    if now - pod.created_at > self.cancel_stale_pending_s:
                        backend.cluster.delete_pod(
                            pod.name, now, "stale_pending")
                        stats.reaped_pending += 1

        self.stats.submitted += stats.submitted
        self.stats.reaped_pending += stats.reaped_pending
        for name, k in stats.per_backend_submitted.items():
            self.stats.per_backend_submitted[name] = (
                self.stats.per_backend_submitted.get(name, 0) + k)
        # deficits are a gauge, not a counter: keep the latest snapshot
        self.stats.per_schedd_deficit = dict(stats.per_schedd_deficit)
        if prof is not None:
            prof.record_reconcile(
                t=now, w_start=t_r0, wall_s=prof.now() - t_r0,
                preview_s=self._preview_s, submitted=stats.submitted)
        return stats

    def maybe_reconcile(self, now: float) -> ProvisionStats | None:
        """Tick-poll compat: reconcile if a full interval elapsed (drifts
        when the interval is not a tick multiple — event-loop users get
        exact cadence from `schedule_on`)."""
        if now - self._last_run >= self.cfg.submit_interval_s:
            self._last_run = now
            return self.reconcile(now)
        return None

    def schedule_on(self, loop, *, first: float = 0.0, priority: int = 0):
        """Register the reconcile pass as an exact-interval callback on a
        discrete-event loop (core/events.py): firing k lands at
        ``first + k*submit_interval_s``, never quantized to a tick."""
        def fire(now: float):
            self._last_run = now
            self.reconcile(now)

        return loop.every(self.cfg.submit_interval_s, fire, first=first,
                          name="reconcile", priority=priority)

    # -- pod/worker wiring --------------------------------------------------------
    def _pod_callbacks(self, worker: Worker):
        """(on_start, on_stop) closures for one provisioner pod/worker
        pair — factored out so `rewire_pods` can rebuild them on a
        restored pod (closures don't serialize)."""
        def on_start(pod: Pod, t: float, *, _w=worker):
            _w.booted_at = t + _w.startup_delay
            self.collector.advertise(_w)

        def on_stop(pod: Pod, t: float, reason: str, *, _w=worker):
            if reason != "completed":
                from repro_torch.core.worker import kill_worker
                kill_worker(self.collector, self.queue, _w.name, t)

        return on_start, on_stop

    def rewire_pods(self, workers_by_name: dict[str, Worker]) -> int:
        """Re-attach lifecycle closures to restored provisioner pods:
        each live pod labelled ours is matched to its Worker by name
        (pod name == worker name == worker.pod_name, by construction in
        `_submit_pod`).  Foreign pods are left callback-less.  Returns
        pods rewired."""
        n = 0
        for b in self.backends:
            cluster = b.cluster
            for pod in itertools.chain(cluster._pending.values(),
                                       cluster._running.values()):
                if pod.labels.get("owner") != "prp-provisioner":
                    continue
                w = workers_by_name.get(pod.name)
                if w is None:
                    raise ValueError(
                        f"restored pod {pod.name!r} has no worker")
                pod.on_start, pod.on_stop = self._pod_callbacks(w)
                n += 1
        return n

    # -- persistence ----------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe snapshot: the pod-name counter (pod/worker names
        MUST keep incrementing where they left off — they key claims and
        collector entries), the reconcile clock, and cumulative stats.
        The cohort/preview memos are pure caches and simply refill."""
        nid = next(self._ids)
        self._ids = itertools.count(nid)   # non-destructive peek
        return {
            "next_id": nid,
            "last_run": self._last_run,
            "stats": {
                "submitted": self.stats.submitted,
                "reaped_pending": self.stats.reaped_pending,
                "per_group_submitted": [
                    [list(dataclasses.astuple(sig)), k]
                    for sig, k in self.stats.per_group_submitted.items()
                ],
                "per_backend_submitted":
                    dict(self.stats.per_backend_submitted),
                "per_schedd_deficit": dict(self.stats.per_schedd_deficit),
            },
        }

    def load_state(self, state: dict) -> None:
        self._ids = itertools.count(int(state.get("next_id", 0)))
        self._last_run = float(state.get("last_run", -1e18))
        s = state.get("stats", {})
        self.stats = ProvisionStats(
            submitted=int(s.get("submitted", 0)),
            reaped_pending=int(s.get("reaped_pending", 0)),
            per_group_submitted={
                GroupSignature(*vals): int(k)
                for vals, k in s.get("per_group_submitted", [])
            },
            per_backend_submitted=dict(s.get("per_backend_submitted", {})),
            per_schedd_deficit=dict(s.get("per_schedd_deficit", {})),
        )
        self._preview_cache.invalidate()
        self._cohort_filter.clear()
        self._cohort_sig.clear()
        # restores rebuild the queues WITHOUT firing idle hooks — the
        # incremental counters must recount from the restored cohorts
        self._counts_stale = True

    def _submit_pod(self, sig: GroupSignature, label: str, now: float,
                    backend=None):
        backend = backend or self.backends[0]
        name = f"htc-exec-{next(self._ids)}"
        worker_ad = sig.as_worker_ad()
        worker_ad.update(self.cfg.envs)  # advertised extra attrs (Fig 1)

        factory = self.worker_factory or Worker
        worker = factory(
            name=name,
            ad=worker_ad,
            start_expr=self.start_expr,
            idle_timeout=self.cfg.idle_timeout_s,
            startup_delay=self.cfg.startup_delay_s,
            pod_name=name,
        )
        # stamp the owning backend so lifecycle spans can label claims
        # (set post-factory: custom factories need not accept the kwarg)
        worker.backend = backend.name

        on_start, on_stop = self._pod_callbacks(worker)

        selector = {}
        anti = {}
        for k, v in self.cfg.node_affinity.items():
            if k.startswith("^"):
                anti[k[1:]] = v
            else:
                selector[k] = v
        spec = PodSpec(
            name=name,
            request=sig.as_pod_request(),
            priority_class=self.cfg.priority_class,
            tolerations=self.cfg.tolerations,
            node_selector=selector,
            anti_affinity=anti,
            labels={
                "owner": "prp-provisioner",
                "provision-group": label,
            },
            on_start=on_start,
            on_stop=on_stop,
        )
        backend.submit(spec, now)
