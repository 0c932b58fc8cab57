"""HTCondor execute side: startd workers + the collector/negotiator.

A Worker is the HTCondor execute service living inside a Kubernetes pod.
Lifecycle (paper §2):

  pod PENDING -> pod RUNNING -> startd boots (startup_delay) -> advertises
  to the collector -> claims matching idle jobs (START expr, pushed down
  from the provisioner per C3) -> runs them -> when no matching idle job
  exists for `idle_timeout` seconds, SELF-TERMINATES (C2) -> pod succeeds.

Partitionable-slot semantics: a worker claims as many jobs as fit its
resources simultaneously (cpus/gpus/chips), like a partitionable startd
slot — one pod can serve several 1-GPU jobs on an 8-GPU request.

The collector is the pool registry; `run_cycle()` is a single
matchmaking cycle pairing idle jobs with unclaimed worker capacity
(symmetric_match: job.Requirements against the worker ad AND the worker
START against the job ad).

Negotiation architecture (core/matchmaker/): the cycle splits into a
*pure* array core and the stateful glue that stays here.

  * `Collector._build_problem` turns live queues + workers into a
    `MatchProblem` — request/demand/free matrices plus a (cohort ×
    worker) compatibility mask evaluated ONCE per (cohort, slot shape)
    through the bounded LRU memo (`cohort_match` semantics: the mask
    holds full-ad verdicts, and the matchmakers' fits>0 gate supplies
    the live-offer quantity check, so the pair is equivalent to
    evaluating each shrinking offer for quantity-blind expressions).
  * a swappable `Matchmaker` backend solves it — "numpy" (the legacy
    vectorized loop, reference), "jax" (jitted XLA water-fill), "scan"
    (the seed's per-job oracle) — selected via
    `Collector(matchmaker=...)` / `Simulation(matchmaker=...)` / the
    `[provision] matchmaker=` INI key.
  * `Collector._apply_plan` turns the plan back into state: queue
    claims, worker claim vectors, fair-share charges.

Expressions that READ offered quantities (e.g. ``gpus >= 2``) cannot be
block-evaluated once per cycle; cycles containing any such cohort or
worker fall back to the legacy per-claim path (`_match_cohorts`), which
re-evaluates against every shrinking offer — exactness over speed.

Flocking (multi-schedd): `run_cycle(queues, ...)` runs ONE matchmaking
cycle over an ordered list of schedd queues feeding the same pool —
capacity drains through a shared free matrix, plain mode serves queues
strictly in flocking order, and with a fair-share `Accountant`
(core/fairshare.py) the cycle water-fills capacity by per-schedd quota
and per-user effective priority in quantum-sized `match(budget=...)`
slices.  `preview()` is the claim-free dry run the provisioner
subtracts from idle counts so it never provisions for jobs the next
cycle will match anyway.  `negotiate`, `negotiate_scan`, and
`preview_matches` remain as deprecated shims over the new entry points.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import warnings
from collections import OrderedDict
from typing import Any, Callable

import numpy as np

from repro_torch.core.classad import ClassAdExpr, symmetric_match
from repro_torch.core.fairshare import job_cores
from repro_torch.core.jobqueue import (
    Job, JobQueue, JobState, canonical_ad, user_of,
)
from repro_torch.core.matchmaker import (
    MatchPlan, MatchProblem, Matchmaker, cohort_fits, make_matchmaker,
)
from repro_torch.core.matchmaker.base import (
    CycleDelta, match_cycles, sequential_preview_many,
)
from repro_torch.core.matchmaker.base import RESOURCE_KEYS  # noqa: F401
from repro_torch.observability import as_telemetry
#   (re-exported: RESOURCE_KEYS moved to matchmaker.base with the
#   protocol split; long-standing importers keep working)

# offer-ad attributes whose values shrink as a slot fills; expressions
# reading them cannot be block-evaluated once per negotiation cycle
_QUANTITY_ATTRS = frozenset(RESOURCE_KEYS)


def _num(v: Any) -> float:
    return float(v) if isinstance(v, (int, float)) else 0.0


def _job_req_vec(job: Job) -> np.ndarray:
    """Job request over RESOURCE_KEYS, cached on the job (ads are fixed)."""
    v = getattr(job, "_req_vec", None)
    if v is None:
        v = np.array([_num(job.ad.get(f"request_{r}"))
                      for r in RESOURCE_KEYS], dtype=np.float64)
        job._req_vec = v
    return v


class LRUCache:
    """Bounded memo with least-recently-used eviction.

    The collector's ClassAd-eval memos used to reset wholesale when
    full; week-long streaming replays with churning cohorts now evict
    one cold entry at a time instead, and `invalidate` drops entries
    selectively (e.g. every verdict involving one cohort)."""

    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._d: OrderedDict = OrderedDict()
        # effectiveness stats, surfaced as repro_classad_cache_* gauges
        # by the telemetry collect hook
        self.hits = 0
        self.misses = 0

    def get(self, key, default=None):
        try:
            value = self._d[key]
        except KeyError:
            self.misses += 1
            return default
        self.hits += 1
        self._d.move_to_end(key)
        return value

    def put(self, key, value):
        d = self._d
        if key in d:
            d.move_to_end(key)
        d[key] = value
        if len(d) > self.maxsize:
            d.popitem(last=False)

    def invalidate(self, match: Callable[[Any], bool] | None = None) -> int:
        """Drop entries whose key satisfies `match` (all, when None).
        Returns how many were dropped."""
        if match is None:
            n = len(self._d)
            self._d.clear()
            return n
        stale = [k for k in self._d if match(k)]
        for k in stale:
            del self._d[k]
        return len(stale)

    def clear(self):
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d


@dataclasses.dataclass
class Worker:
    name: str
    ad: dict[str, Any]                       # resources + advertised attrs
    start_expr: ClassAdExpr                  # pushed-down filter (C3)
    idle_timeout: float = 300.0
    startup_delay: float = 30.0
    pod_name: str | None = None
    work_rate: float = 1.0          # <1.0 models a straggling node
    backend: str | None = None      # owning ScalingBackend (span labels)

    booted_at: float = -1.0                  # when startd became ready
    idle_since: float = -1.0
    claimed: dict[int, Job] = dataclasses.field(default_factory=dict)
    terminated: bool = False
    # a draining worker (its backend is being detached) takes NO new
    # claims — the negotiator/preview skip it via alive_workers — and
    # self-terminates as soon as its current claims complete
    draining: bool = False
    # accounting
    busy_s: float = 0.0
    alive_s: float = 0.0
    _match_key: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _res_vec: Any = dataclasses.field(default=None, repr=False,
                                      compare=False)
    _used_vec: Any = dataclasses.field(default=None, repr=False,
                                       compare=False)
    #: claim-set revision — bumped on every add/drop/clear, so "has this
    #: worker's free capacity changed?" is an int compare instead of a
    #: vector rebuild + hash (provisioner preview memo, collector
    #: staging fingerprint)
    free_rev: int = dataclasses.field(default=0, repr=False, compare=False)
    _free_digest: Any = dataclasses.field(default=None, repr=False,
                                          compare=False)

    def ready(self, now: float) -> bool:
        return self.booted_at >= 0 and now >= self.booted_at and not self.terminated

    # -- incremental resource vectors (hot path of the negotiator) -----------
    def res_vec(self) -> np.ndarray:
        if self._res_vec is None:
            self._res_vec = np.array(
                [_num(self.ad.get(r)) for r in RESOURCE_KEYS],
                dtype=np.float64)
        return self._res_vec

    def free_vec(self) -> np.ndarray:
        if self._used_vec is None:
            return self.res_vec().copy()
        return self.res_vec() - self._used_vec

    def add_claim(self, job: Job):
        self.claimed[job.jid] = job
        if self._used_vec is None:
            self._used_vec = np.zeros(len(RESOURCE_KEYS), dtype=np.float64)
        self._used_vec += _job_req_vec(job)
        self.free_rev += 1

    def drop_claim(self, jid: int) -> Job | None:
        job = self.claimed.pop(jid, None)
        if job is not None and self._used_vec is not None:
            self._used_vec -= _job_req_vec(job)
            self.free_rev += 1
        return job

    def clear_claims(self):
        self.claimed.clear()
        self._used_vec = None
        self.free_rev += 1

    def free_digest(self) -> bytes:
        """Byte digest of the free-capacity vector, recomputed only when
        the claim set changed (`free_rev` dirty flag) — the provisioner
        polls this every reconcile for every worker, and an unchanged
        pool must cost an int compare per worker, not a vector rebuild."""
        cached = self._free_digest
        if cached is not None and cached[0] == self.free_rev:
            return cached[1]
        digest = self.free_vec().tobytes()
        self._free_digest = (self.free_rev, digest)
        return digest

    def free_resources(self) -> dict[str, float]:
        free = dict(self.ad)
        for job in self.claimed.values():
            for res in RESOURCE_KEYS:
                want = job.ad.get(f"request_{res}", 0) or 0
                if res in free and isinstance(free[res], (int, float)):
                    free[res] = free[res] - want
        return free

    def offer_ad(self) -> dict[str, Any]:
        """Current (partial-slot) offer: remaining resources + attrs."""
        return self.free_resources()

    def match_key(self) -> tuple:
        """Matchmaking-equivalence key of the FULL slot (ads are fixed at
        provisioning time, so this is computed once).  Uses the same ad
        canonicalization as the job-side cohort_key_of — the two halves
        jointly key the collector's match cache."""
        if self._match_key is None:
            self._match_key = (self.start_expr.src, canonical_ad(self.ad))
        return self._match_key


# -- worker (de)serialization -------------------------------------------------
def worker_state(w: Worker) -> dict:
    """JSON-safe snapshot: the START expression serializes as source
    text, claims as an ORDERED jid list (the claim dict's iteration
    order feeds completion order for same-instant finishes).  The cached
    resource vectors are NOT serialized — `worker_from_state` rebuilds
    `_used_vec` through `add_claim`, summing the same small integral
    requests, so the float result is identical."""
    return {
        "name": w.name,
        "ad": dict(w.ad),
        "start_src": w.start_expr.src,
        "idle_timeout": float(w.idle_timeout),
        "startup_delay": float(w.startup_delay),
        "pod_name": w.pod_name,
        "work_rate": w.work_rate,
        "backend": w.backend,
        "booted_at": w.booted_at,
        "idle_since": w.idle_since,
        "terminated": w.terminated,
        "draining": w.draining,
        "busy_s": w.busy_s,
        "alive_s": w.alive_s,
        "claimed": list(w.claimed.keys()),
    }


def worker_from_state(state: dict, jobs_by_jid: dict[int, Job]) -> Worker:
    w = Worker(
        name=state["name"],
        ad=dict(state["ad"]),
        start_expr=ClassAdExpr(state["start_src"]),
        idle_timeout=float(state.get("idle_timeout", 300.0)),
        startup_delay=float(state.get("startup_delay", 30.0)),
        pod_name=state.get("pod_name"),
        work_rate=float(state.get("work_rate", 1.0)),
        backend=state.get("backend"),
    )
    w.booted_at = float(state.get("booted_at", -1.0))
    w.idle_since = float(state.get("idle_since", -1.0))
    w.terminated = bool(state.get("terminated", False))
    w.draining = bool(state.get("draining", False))
    w.busy_s = float(state.get("busy_s", 0.0))
    w.alive_s = float(state.get("alive_s", 0.0))
    for jid in state.get("claimed", []):
        w.add_claim(jobs_by_jid[int(jid)])
    return w


class Collector:
    """Pool registry + negotiator."""

    MATCH_CACHE_MAX = 100_000    # LRU entries (per-cohort×shape verdicts)

    def __init__(self, matchmaker: str | Matchmaker | None = None, *,
                 negotiation_batch: int = 1, telemetry=None):
        self.workers: dict[str, Worker] = {}
        self._ids = itertools.count()
        self.matchmaker: Matchmaker = make_matchmaker(matchmaker)
        # a pool matchmaker serves previews from the first reconcile on;
        # backends that can pre-compile their canonical preview bucket
        # (jax's 512-lane floor) do it here, at pool startup, instead of
        # inside the first reconcile's preview wall
        warm = getattr(self.matchmaker, "warm_preview", None)
        if warm is not None:
            warm()
        self._scan_oracle: Matchmaker = make_matchmaker("scan")
        # telemetry: the registry half is always live (the introspection
        # counters below moved into it and tests/benchmarks read them);
        # the wall-clock profiler is None unless telemetry is enabled,
        # and every timing site guards on that
        self.telemetry = as_telemetry(telemetry)
        self.profiler = self.telemetry.profiler
        # (job cohort, worker slot shape) -> bool; symmetric_match is a
        # pure function of the two ads, so entries never go stale on
        # their own — the LRU bound handles cohort churn, and
        # `invalidate_cohort` handles callers that mutate ads in place
        self._match_cache = LRUCache(self.MATCH_CACHE_MAX)
        # C2 idle-poll verdicts per SLOT SHAPE: {match_key: (idle-cohort
        # version, any-match verdict)} — valid until the idle-cohort SET
        # changes; a pool of identical idle workers polls once per
        # version, not once per worker per event
        self._poll_cache = LRUCache(self.MATCH_CACHE_MAX)
        # -- fused negotiation staging (stage_cycle / flush_staged) ----------
        #: how many consecutive cycles to accumulate before flushing
        #: through the backend's fused multi-cycle jit (1 = stage
        #: nothing, every cycle runs immediately)
        self.negotiation_batch = max(1, int(negotiation_batch))
        self._staged_times: list[float] = []
        self._staged_queues: list | None = None
        self._staged_fp: tuple | None = None
        # introspection counters, now registry families (tests + bench
        # read them through the compat properties below)
        reg = self.telemetry.registry
        self._c_fused_batches = reg.counter(
            "repro_fused_batches_total",
            "Staged batches run through the fused multi-cycle jit")
        self._c_fused_cycles = reg.counter(
            "repro_fused_cycles_total",
            "Negotiation cycles covered by fused batches")
        self._c_fallbacks = reg.counter(
            "repro_fused_fallbacks_total",
            "Staged batches replayed sequentially, by reason", ("reason",))
        self._c_noop_hits = reg.counter(
            "repro_noop_memo_hits_total",
            "Negotiation cycles skipped by the no-op memo")
        self._c_preview_legacy = reg.counter(
            "repro_preview_legacy_total",
            "Previews forced onto the legacy live-offer walk by "
            "quantity-reading expressions (estimate, not exact — see "
            "Collector.preview)")
        self._noop_memo: tuple | None = None
        # -- live-fusion advancement hook (backlog-driven batching) ----------
        #: when set (the event engine installs `Simulation.
        #: _advance_unchecked`), `flush_staged` interleaves worker
        #: advancement with the staged cycles: before applying the plan
        #: (or replaying the fallback cycle) for staged time t, the pool
        #: is advanced to t — exactly the pre-event advancement the
        #: deferred cycles skipped.  None (the default) keeps the
        #: pre-advanced bench/replay semantics: flushes assume the
        #: caller already advanced the pool past the staged window.
        self.advance_hook = None

    # compat properties over the registry families — the pre-registry
    # int attributes these replaced are part of the test/bench surface
    @property
    def fused_batches(self) -> int:
        return int(self._c_fused_batches.value)

    @property
    def fused_cycles(self) -> int:
        return int(self._c_fused_cycles.value)

    @property
    def staged_fallbacks(self) -> int:
        return int(sum(c.value
                       for c in self._c_fallbacks.children.values()))

    @property
    def noop_hits(self) -> int:
        return int(self._c_noop_hits.value)

    @property
    def preview_legacy(self) -> int:
        return int(self._c_preview_legacy.value)

    def advertise(self, worker: Worker):
        self.workers[worker.name] = worker

    def invalidate(self, name: str):
        self.workers.pop(name, None)

    def invalidate_cohort(self, cohort_key=None) -> int:
        """Explicitly drop memoized ClassAd verdicts: all of them, or
        only entries involving `cohort_key`.  Call on a cohort-version
        bump whose ads were mutated in place (the caches are otherwise
        pure and only ever LRU-evicted).  Returns entries dropped."""
        if cohort_key is None:
            n = self._match_cache.invalidate()
        else:
            n = self._match_cache.invalidate(
                lambda k: k[0] == cohort_key)
        # poll verdicts aggregate over cohorts; any cohort change can
        # flip them regardless of the idle_version guard
        self._poll_cache.invalidate()
        return n

    def alive_workers(self, now: float) -> list[Worker]:
        return [w for w in self.workers.values()
                if w.ready(now) and not w.draining]

    def unclaimed_capacity(self, group_matcher=None) -> int:
        """Workers with zero claims (counted by the provisioner against the
        deficit so it never over-submits; paper §2)."""
        n = 0
        for w in self.workers.values():
            if w.terminated or w.draining or w.claimed:
                continue
            if group_matcher is None or group_matcher(w.ad):
                n += 1
        return n

    # -- cohort-level matchmaking -------------------------------------------
    def cohort_match(self, rep: Job, worker: Worker) -> bool:
        """Would `worker`'s slot match this cohort? Evaluated against the
        live offer for partially-claimed workers; memoized for unclaimed
        ones (offer == full ad)."""
        if worker.claimed:
            return symmetric_match(rep.ad, worker.offer_ad(),
                                   rep.requirements, worker.start_expr)
        return self._shape_match(rep, worker)

    def _shape_match(self, rep: Job, worker: Worker) -> bool:
        """Memoized FULL-AD verdict for (cohort, slot shape) — the
        compatibility-mask entry.  Combined with the matchmakers'
        fits>0 gate this equals the live-offer verdict whenever the
        expressions are quantity-blind (the only cycles routed to the
        array backends)."""
        key = (rep.cohort_key, worker.match_key())
        hit = self._match_cache.get(key)
        if hit is None:
            hit = symmetric_match(rep.ad, worker.ad, rep.requirements,
                                  worker.start_expr)
            self._match_cache.put(key, hit)
        return hit

    def any_cohort_matches(self, worker: Worker, queue: JobQueue) -> bool:
        """C2 idle poll: does ANY idle job match this worker? One check
        per cohort, cache-hit for the common (idle worker) case.

        For an UNCLAIMED worker the verdict is a pure function of (slot
        shape, idle-cohort set) — matching uses the full slot ad — so it
        is cached per `worker.match_key()` against `queue.idle_version`:
        however many identical workers sit idle, each cohort-set change
        costs ONE rescan per distinct slot shape, and every other poll
        is a dict hit."""
        version = getattr(queue, "idle_version", None)
        cacheable = version is not None and not worker.claimed
        if cacheable:
            cached = self._poll_cache.get(worker.match_key())
            if cached is not None and cached[0] == version:
                return cached[1]
        hit = False
        for _key, jobs in queue.idle_cohorts():
            rep = next(iter(jobs.values()))
            if self.cohort_match(rep, worker):
                hit = True
                break
        if cacheable:
            self._poll_cache.put(worker.match_key(), (version, hit))
        return hit

    # -- problem building / plan application (the stateful half) -------------
    def _quantity_sensitive(self, reps, workers) -> bool:
        """Any expression in the cycle reading offered quantities forces
        the legacy per-claim path — block evaluation would miss the
        shrinking-offer rechecks."""
        for w in workers:
            qs = w.__dict__.get("_qsens")
            if qs is None:
                qs = bool(w.start_expr.refs & _QUANTITY_ATTRS)
                w._qsens = qs
            if qs:
                return True
        for rep in reps:
            req = rep.requirements
            if req is not None and (req.refs & _QUANTITY_ATTRS):
                return True
        return False

    def _build_problem(self, rows, workers, *,
                       scan_jobs=None) -> MatchProblem:
        """Assemble the pure arrays from live state.  `rows` is the
        cohort list [(queue idx, cohort key, jobs dict), ...] ALREADY in
        processing order; the compat mask is evaluated once per
        (cohort, distinct slot shape) through the LRU memo, then
        broadcast to worker columns."""
        C, W = len(rows), len(workers)
        R = len(RESOURCE_KEYS)
        keys = []
        reps = []
        requests = np.zeros((C, R), dtype=np.float64)
        demand = np.zeros(C, dtype=np.int64)
        for c, (qi, key, jobs) in enumerate(rows):
            rep = next(iter(jobs.values()))
            keys.append((qi, key))
            reps.append(rep)
            requests[c] = _job_req_vec(rep)
            demand[c] = len(jobs)
        free = np.stack([w.free_vec() for w in workers])
        capacity = np.stack([w.res_vec() for w in workers])
        # distinct slot shapes -> one expression eval per (cohort, shape)
        shape_of = np.zeros(W, dtype=np.int64)
        shape_reps: list[Worker] = []
        shape_idx: dict = {}
        for wi, w in enumerate(workers):
            mk = w.match_key()
            si = shape_idx.get(mk)
            if si is None:
                si = shape_idx[mk] = len(shape_reps)
                shape_reps.append(w)
            shape_of[wi] = si
        compat_s = np.zeros((C, len(shape_reps)), dtype=bool)
        for c, rep in enumerate(reps):
            for si, w in enumerate(shape_reps):
                compat_s[c, si] = self._shape_match(rep, w)
        scan_order = None
        if scan_jobs is not None:
            row_of = {key: c for c, (_qi, key, _j) in enumerate(rows)}
            scan_order = np.array(
                [row_of[j.cohort_key] for j in scan_jobs], dtype=np.int64)
        return MatchProblem(
            keys=keys, requests=requests, demand=demand,
            order=np.arange(C, dtype=np.int64), free=free,
            capacity=capacity, compat=compat_s[:, shape_of],
            scan_order=scan_order)

    def _apply_plan(self, queues, problem: MatchProblem, plan: MatchPlan,
                    workers, now: float, *, on_claim=None) -> int:
        """Turn a pure plan into state: claim each cohort's FIFO jobs to
        its workers in index order.  Free capacity only shrinks within a
        cycle, so a cohort's first-fit worker index is non-decreasing —
        dealing FIFO jobs to index-ordered workers reproduces the exact
        (job, worker) pairs of the legacy claiming walks."""
        claims = 0
        takes = plan.takes
        for c in problem.order:
            row = takes[c]
            total = int(row.sum())
            if total <= 0:
                continue
            qi, key = problem.keys[c]
            q = queues[qi]
            pending = q.cohort_jobs_sorted(key, total)
            ji = 0
            for wi in np.nonzero(row)[0]:
                w = workers[wi]
                for job in pending[ji:ji + int(row[wi])]:
                    q.claim(job.jid, w.name, now)
                    w.add_claim(job)
                    if on_claim is not None:
                        on_claim(job)
                    ji += 1
                w.idle_since = -1.0
            claims += ji
        return claims

    # -- negotiation entry points (the Matchmaker-backed API) ----------------
    def run_cycle(self, queues, now: float, *, accountant=None,
                  quantum: int = 1, max_submit: float | None = None) -> int:
        """One matchmaking cycle; THE canonical negotiation entry point.

        `queues` is a single schedd queue or the flocking-ordered list of
        them.  Without an accountant, queues drain strictly in that
        order (FIFO cohorts within each) against one shared free matrix;
        with an `Accountant` the cycle water-fills hierarchically — most
        owed schedd, then best-priority user, `quantum` claims per slice
        (see core/fairshare.py).  `max_submit` restricts the plain path
        to jobs submitted at or before that time (replay drivers hand
        pre-loaded queues cycle timestamps).  Returns new claims."""
        if hasattr(queues, "claim"):
            queues = [queues]
        else:
            queues = list(queues)
        if accountant is None:
            return self._plain_cycle(queues, now, max_submit=max_submit)
        if max_submit is not None:
            raise ValueError("max_submit is a plain-cycle knob; "
                             "fair-share cycles see the live queue")
        return self._fairshare_cycle(queues, now, accountant, quantum)

    def negotiate_cycle(self, queues, now: float, *, accountant=None,
                        quantum: int = 1) -> int:
        """Alias of `run_cycle` (the pre-protocol flocking name)."""
        return self.run_cycle(queues, now, accountant=accountant,
                              quantum=quantum)

    # -- fused multi-cycle negotiation (staging buffer -> fused jit) ----------
    def _pool_fingerprint(self, now: float) -> tuple:
        """(name, free_rev) of every alive worker — two equal
        fingerprints mean no worker joined, left, booted, drained, or
        changed a claim in between, so staged cycles only differ by job
        arrivals and are fusable."""
        return tuple((w.name, w.free_rev) for w in self.alive_workers(now))

    def stage_cycle(self, queues, now: float) -> int:
        """Stage one plain negotiation cycle at time `now` instead of
        running it; once `negotiation_batch` cycles are staged (or on
        `quiesce()`), the whole batch flushes through the matchmaker's
        fused multi-cycle path in ONE device dispatch.  Returns claims
        made by any flush this call triggered (0 while the batch is
        still filling).

        Only pools the fused jit can serve are staged at all: foreign
        queues, quantity-reading expressions, and fair-share cycles run
        immediately (fair-share goes through `run_cycle` as before).
        Claims land with the STAGED cycle's timestamp, and the flush is
        claim-for-claim identical to running each cycle at its staged
        time — `flush_staged` falls back to a sequential time-cutoff
        replay whenever fusion can't prove that."""
        if hasattr(queues, "claim"):
            queues = [queues]
        else:
            queues = list(queues)
        if (self.negotiation_batch <= 1
                or any(not hasattr(q, "idle_cohorts") for q in queues)):
            return self._plain_cycle(queues, now)
        claims = 0
        if self._staged_times and self._staged_queues != queues:
            claims += self.flush_staged()
        if not self._staged_times:
            self._staged_queues = queues
            self._staged_fp = self._pool_fingerprint(now)
        self._staged_times.append(now)
        if len(self._staged_times) >= self.negotiation_batch:
            claims += self.flush_staged()
        return claims

    def quiesce(self) -> int:
        """Flush any staged cycles NOW.  Every external operation that
        observes or mutates pool state mid-stream (snapshot, backend
        attach/drain, schedd add/drain, flocking-order change) must call
        this first — staged-but-unflushed negotiation is invisible to
        them.  Returns claims made by the flush."""
        return self.flush_staged()

    def flush_staged(self) -> int:
        """Run every staged cycle.  The fused path builds ONE problem
        from the current idle cohorts, splits each cohort's demand into
        per-cycle arrival deltas on the jobs' submit times, and hands the
        K-cycle batch to `match_cycles` — device state stays resident
        across the K cycles and the K plans apply back in staged order
        with their staged timestamps.  Falls back to a sequential
        time-cutoff replay (bit-identical by construction) when the
        batch is not provably fusable: a single staged cycle, workers
        changed mid-batch, quantity-reading expressions, or a cohort
        that fully drains mid-batch and re-arrives (its cross-cohort
        FIFO key would re-seed — see jobqueue._cohort_min)."""
        if not self._staged_times:
            return 0
        times = self._staged_times
        queues = self._staged_queues
        fp0 = self._staged_fp
        self._staged_times = []
        self._staged_queues = None
        self._staged_fp = None

        prof = self.profiler
        t_f0 = prof.now() if prof is not None else 0.0
        workers = self.alive_workers(times[-1])
        rows = deltas = None
        t_m0 = t_a0 = t_f0
        # fallback chain, first failing condition names the reason (the
        # repro_fused_fallbacks_total{reason} series — the profiler's
        # answer to "why didn't this batch fuse?")
        reason = None
        if len(times) < 2:
            reason = "single_cycle"
        elif not workers:
            reason = "no_workers"
        elif self._pool_fingerprint(times[-1]) != fp0:
            reason = "pool_changed"
        if reason is None:
            rows, deltas = self._staged_rows(queues, times)
            if rows is None:
                reason = "no_rows"
        if reason is None:
            reps = [next(iter(j.values())) for _qi, _k, j in rows]
            if self._quantity_sensitive(reps, workers):
                reason = "quantity_exprs"
        if reason is None:
            problem = self._build_problem(rows, workers)
            problem.demand = np.zeros_like(problem.demand)
            t_m0 = prof.now() if prof is not None else 0.0
            plans = match_cycles(self.matchmaker, problem, deltas)
            t_a0 = prof.now() if prof is not None else 0.0
            if self._reseed_hazard(plans, deltas):
                reason = "reseed_hazard"
        if (reason is None and self.advance_hook is not None
                and self._advance_hazard(queues, problem, plans,
                                         workers, times)):
            reason = "completion_hazard"
        hook = self.advance_hook
        if reason is not None:
            self._c_fallbacks.labels(reason).value += 1
            claims = 0
            for t in times:
                if hook is not None:
                    hook(t)
                claims += self._plain_cycle(queues, t, max_submit=t)
            return claims
        self._c_fused_batches.value += 1
        self._c_fused_cycles.value += len(times)
        claims = 0
        for t, plan in zip(times, plans):
            if hook is not None:
                hook(t)
            claims += self._apply_plan(queues, problem, plan, workers, t)
        if prof is not None:
            lc = getattr(self.matchmaker, "last_call", None)
            prof.record_cycle(
                t=times[-1], kind="fused", w_start=t_f0,
                build_s=t_m0 - t_f0, match_s=t_a0 - t_m0,
                apply_s=prof.now() - t_a0, claims=claims,
                backend=getattr(self.matchmaker, "name", ""),
                compiled=None if lc is None else lc.get("compiled"),
                fused_k=len(times))
        return claims

    def _staged_rows(self, queues, times):
        """Union cohort rows (cross-queue FIFO order, as `_plain_cycle`
        sorts them) plus per-cycle arrival deltas: a job submitted at s
        first becomes visible to the earliest staged cycle with
        `times[k] >= s`; jobs submitted after `times[-1]` are invisible
        to the whole batch."""
        entries = []
        for qi, q in enumerate(queues):
            for key, jobs in q.idle_cohorts():
                if jobs:
                    entries.append(
                        (q.cohort_first_submit(key), qi, key, jobs))
        if not entries:
            return None, None
        entries.sort(key=lambda e: (e[0], e[1]))
        rows = [(qi, key, jobs) for _first, qi, key, jobs in entries]
        K, C = len(times), len(rows)
        arrivals = np.zeros((K, C), dtype=np.int64)
        for c, (_qi, _key, jobs) in enumerate(rows):
            for job in jobs.values():
                k = bisect.bisect_left(times, job.submitted_at)
                if k < K:
                    arrivals[k, c] += 1
        return rows, [CycleDelta(arrivals=arrivals[k]) for k in range(K)]

    @staticmethod
    def _reseed_hazard(plans, deltas) -> bool:
        """True when some cohort fully drains in one fused cycle and
        receives arrivals in a LATER one — the sequential path would
        re-seed its cross-cohort FIFO key at re-birth and may process
        the batch in a different order, so such batches replay
        sequentially instead of trusting the fused plans."""
        K = len(plans)
        C = len(deltas[0].arrivals)
        # later[k]: does any cohort entry see arrivals strictly after k?
        later = np.zeros((K, C), dtype=bool)
        for k in range(K - 2, -1, -1):
            later[k] = later[k + 1] | (deltas[k + 1].arrivals > 0)
        d = np.zeros_like(deltas[0].arrivals)
        for k in range(K - 1):
            d = d + deltas[k].arrivals
            drained = (d > 0) & (plans[k].per_cohort() >= d)
            if np.any(drained & later[k]):
                return True
            d = d - plans[k].per_cohort()
        return False

    def _advance_hazard(self, queues, problem, plans, workers,
                        times) -> bool:
        """Live-fusion guard: True when interleaved advancement could
        return capacity (or retire a worker) MID-BATCH — state the fused
        plans, computed for the whole window up front, did not see.
        Checked only when `advance_hook` is set (event-engine mode):

          * a worker whose idle timeout is shorter than the staged span,
            or whose already-running idle clock expires inside it, could
            self-terminate (C2) between two staged cycles;
          * a claim made by a NON-FINAL staged cycle that completes (or
            runs an opaque `work_fn`) before the final staged time would
            free capacity a later fused cycle should have re-matched.

        Pre-existing claims need no walk here: the event engine only
        defers a window after proving none of them can complete inside
        it (`Simulation._defer_ok`), and the flush never advances past
        the last staged time.  Conservative by construction — a hazard
        falls back to the exact sequential replay, it never mis-fuses."""
        margin = 1e-6
        span = times[-1] - times[0]
        for w in workers:
            if w.idle_timeout <= span + margin:
                return True
            if (not w.claimed and w.idle_since >= 0
                    and w.idle_since + w.idle_timeout
                    <= times[-1] + margin):
                return True
        K = len(times)
        if K < 2:
            return False
        C = problem.n_cohorts
        # claims of cycles 0..K-2 consume the cohort FIFO prefix in
        # staged order — walk the exact (job, worker) pairs _apply_plan
        # will create, before creating them
        totals = np.zeros(C, dtype=np.int64)
        for plan in plans[:-1]:
            totals += plan.per_cohort()
        pending: list = [None] * C
        used = np.zeros(C, dtype=np.int64)
        for t, plan in zip(times[:-1], plans[:-1]):
            takes = plan.takes
            for c in problem.order:
                row = takes[c]
                if int(row.sum()) <= 0:
                    continue
                if pending[c] is None:
                    qi, key = problem.keys[c]
                    pending[c] = queues[qi].cohort_jobs_sorted(
                        key, int(totals[c]))
                jobs = pending[c]
                ji = int(used[c])
                for wi in np.nonzero(row)[0]:
                    rate = workers[wi].work_rate
                    for job in jobs[ji:ji + int(row[wi])]:
                        if job.work_fn is not None:
                            return True
                        need = (job.remaining_s / rate if rate > 0
                                else float("inf"))
                        if t + need <= times[-1] + margin:
                            return True
                        ji += 1
                used[c] = ji
        return False

    def _plain_cycle(self, queues, now: float, *,
                     max_submit: float | None = None) -> int:
        """One plain (no fair-share) cycle.  `max_submit` restricts the
        pass to jobs submitted at or before that time — the staged-flush
        fallback replays deferred cycles with the visibility each would
        have had at its own timestamp."""
        workers = self.alive_workers(now)
        if not workers:
            return 0
        if any(not hasattr(q, "idle_cohorts") for q in queues):
            # foreign queues exposing only the seed surface negotiate
            # per-job against live offers; cohort-capable queues before/
            # after them see the drained capacity via fresh free vectors
            total = 0
            for q in queues:
                if hasattr(q, "idle_cohorts"):
                    total += self._plain_cycle([q], now)
                else:
                    total += self.scan_cycle(q, now)
            return total
        # no-op memo: a cycle that claimed NOTHING stays a no-op until
        # the idle set (idle_seq) or some worker's claims/liveness (the
        # pool fingerprint) change — drained-backlog steady states pay
        # two int-tuple compares per cycle instead of a full match
        memo_key = None
        if max_submit is None:
            memo_key = (tuple((id(q), q.idle_seq) for q in queues),
                        self._pool_fingerprint(now))
            if memo_key == self._noop_memo:
                self._c_noop_hits.value += 1
                return 0
        prof = self.profiler
        t_c0 = prof.now() if prof is not None else 0.0
        rows = []
        for qi, q in enumerate(queues):
            cohorts = []
            for k, j in q.idle_cohorts():
                if max_submit is not None:
                    j = {jid: job for jid, job in j.items()
                         if job.submitted_at <= max_submit}
                if j:
                    cohorts.append((k, j))
            cohorts.sort(key=lambda kv: q.cohort_first_submit(kv[0]))
            rows.extend((qi, k, j) for k, j in cohorts)
        if not rows:
            self._noop_memo = memo_key
            return 0
        reps = [next(iter(j.values())) for _qi, _k, j in rows]
        if self._quantity_sensitive(reps, workers):
            free = np.stack([w.free_vec() for w in workers])
            total = 0
            for qi, q in enumerate(queues):
                cohorts = [(k, j) for rqi, k, j in rows if rqi == qi]
                total += self._match_cohorts(q, cohorts, workers, free,
                                             now)
            if total == 0 and memo_key is not None:
                self._noop_memo = memo_key
            if prof is not None:
                prof.record_cycle(
                    t=now, kind="legacy", w_start=t_c0, build_s=0.0,
                    match_s=prof.now() - t_c0, apply_s=0.0,
                    claims=total, backend="legacy")
            return total
        problem = self._build_problem(rows, workers)
        t_m0 = prof.now() if prof is not None else 0.0
        plan = self.matchmaker.match(problem)
        t_a0 = prof.now() if prof is not None else 0.0
        claims = self._apply_plan(queues, problem, plan, workers, now)
        if claims == 0 and memo_key is not None:
            self._noop_memo = memo_key
        if prof is not None:
            lc = getattr(self.matchmaker, "last_call", None)
            prof.record_cycle(
                t=now, kind="plain", w_start=t_c0,
                build_s=t_m0 - t_c0, match_s=t_a0 - t_m0,
                apply_s=prof.now() - t_a0, claims=claims,
                backend=getattr(self.matchmaker, "name", ""),
                compiled=None if lc is None else lc.get("compiled"))
        return claims

    def _fairshare_cycle(self, queues, now: float, accountant,
                         quantum: int) -> int:
        workers = self.alive_workers(now)
        if not workers:
            return 0
        prof = self.profiler
        t_c0 = prof.now() if prof is not None else 0.0
        accountant.reset_cycle()
        names = [getattr(q, "name", f"schedd{i:02d}")
                 for i, q in enumerate(queues)]
        rows = []
        group_of = []                       # (schedd idx, user) per row
        for qi, q in enumerate(queues):
            cohorts = [(k, j) for k, j in q.idle_cohorts() if j]
            cohorts.sort(key=lambda kv: q.cohort_first_submit(kv[0]))
            for k, j in cohorts:
                rows.append((qi, k, j))
                group_of.append((qi, user_of(next(iter(j.values())))))
        if not rows:
            return 0
        reps = [next(iter(j.values())) for _qi, _k, j in rows]
        quantum = max(1, int(quantum))
        total = 0

        if self._quantity_sensitive(reps, workers):
            # legacy per-claim ladder: identical water-fill, with the
            # shrinking-offer expression rechecks the array path can't do
            free = np.stack([w.free_vec() for w in workers])
            active: dict[tuple[int, str], list] = {}
            for (si, user), (qi, k, j) in zip(group_of, rows):
                active.setdefault((si, user), []).append((k, j))
            total = self._fairshare_ladder(
                queues, names, active, workers, free, now, accountant,
                quantum,
                match=lambda q, cohorts, budget, observe: (
                    self._match_cohorts(q, cohorts, workers, free, now,
                                        budget=budget, on_claim=observe)))
            accountant.reset_cycle()
            if prof is not None:
                prof.record_cycle(
                    t=now, kind="legacy", w_start=t_c0, build_s=0.0,
                    match_s=prof.now() - t_c0, apply_s=0.0,
                    claims=total, backend="legacy")
            return total

        problem = self._build_problem(rows, workers)
        t_b1 = prof.now() if prof is not None else 0.0
        match_s = apply_s = 0.0
        group_rows: dict[tuple[int, str], list[int]] = {}
        for c, g in enumerate(group_of):
            group_rows.setdefault(g, []).append(c)
        C = problem.n_cohorts
        while group_rows:
            si = min({i for i, _ in group_rows},
                     key=lambda i: (accountant.group_owed(names[i], now),
                                    i))
            user = min((u for i, u in group_rows if i == si),
                       key=lambda u: (
                           accountant.effective_priority(u, now), u))
            cores = [0.0]

            def observe(job, _c=cores):
                _c[0] += job_cores(job)

            mask = np.zeros(C, dtype=bool)
            mask[group_rows[(si, user)]] = True
            t_s0 = prof.now() if prof is not None else 0.0
            plan = self.matchmaker.match(problem, budget=quantum,
                                         active=mask)
            t_s1 = prof.now() if prof is not None else 0.0
            got = self._apply_plan(queues, problem, plan, workers, now,
                                   on_claim=observe)
            if prof is not None:
                match_s += t_s1 - t_s0
                apply_s += prof.now() - t_s1
            problem.free = plan.free_after
            problem.demand = problem.demand - plan.per_cohort()
            if got:
                accountant.charge_virtual(names[si], user, cores[0])
                total += got
            if got < quantum:
                # demand or matching capacity exhausted for this user —
                # neither can grow within the cycle, so retire the entry
                del group_rows[(si, user)]
        # claims are real running-core rates now; outside-the-cycle
        # priority queries (metrics, owed-share deficits) must not see
        # stale virtual charges on top of them
        accountant.reset_cycle()
        if prof is not None:
            lc = getattr(self.matchmaker, "last_call", None)
            prof.record_cycle(
                t=now, kind="fairshare", w_start=t_c0,
                build_s=t_b1 - t_c0, match_s=match_s, apply_s=apply_s,
                claims=total, backend=getattr(self.matchmaker, "name", ""),
                compiled=None if lc is None else lc.get("compiled"))
        return total

    def _fairshare_ladder(self, queues, names, active, workers, free,
                          now, accountant, quantum, *, match) -> int:
        """The water-fill loop shared by the legacy fallback: argmin
        schedd by owed share, argmin user by effective priority, one
        quantum-capped slice each, retire on exhaustion."""
        total = 0
        while active:
            si = min({i for i, _ in active},
                     key=lambda i: (accountant.group_owed(names[i], now),
                                    i))
            user = min((u for i, u in active if i == si),
                       key=lambda u: (
                           accountant.effective_priority(u, now), u))
            cores = [0.0]

            def observe(job, _c=cores):
                _c[0] += job_cores(job)

            got = match(queues[si], active[(si, user)], quantum, observe)
            if got:
                accountant.charge_virtual(names[si], user, cores[0])
                total += got
            if got < quantum:
                del active[(si, user)]
        return total

    def preview(self, queues, now: float) -> list[dict]:
        """Dry-run of the next negotiation cycle through the pure
        matchmaker: how many of each cohort's idle jobs CURRENT free
        capacity would absorb, without claiming anything.  Returns one
        {cohort_key: absorbed} dict per queue.  The provisioner computes
        deficits from the remaining (post-negotiation) idle cohorts, so
        a job about to be matched to existing capacity — including
        partial slots the old unclaimed-worker count missed — is not
        provisioned for again.

        Estimate caveat (quantity-reading expressions): a START or
        Requirements expression that reads offered quantities forces the
        legacy live-offer walk (`_preview_legacy`, counted by
        `repro_preview_legacy_total`), which evaluates each cohort's
        expression against the worker's LIVE offer instead of the
        virtually-drained one.  The error is bounded at **one cohort
        slice per worker**: for each worker the walk hands out at most
        one `min(fits, remaining)` slice per cohort under a stale
        verdict, and a verdict can only go stale once per worker —
        capacity only shrinks within the dry run — so the over-count
        never exceeds the first mis-admitted slice, `fits(live free)`
        jobs, per worker.  Under-count cannot happen: a job admitted by
        the drained offer is admitted by the live one.
        tests/test_preview_counters.py pins this bound."""
        return self.preview_candidates(queues, now)[0]

    def preview_candidates(self, queues, now: float,
                           frees: list | None = None) -> list[list[dict]]:
        """Batched preview: evaluate N candidate free matrices against
        ONE problem built from the current idle cohorts, in ONE
        matchmaker dispatch where the backend supports it (the jax
        backend's vmapped `preview_many`; others run the sequential
        reference).  ``frees`` is a list of (W, R) candidate matrices
        over `alive_workers(now)` row order — None means one candidate,
        the live free matrix.  Returns one per-queue absorption list
        (the `preview` shape) per candidate.

        The jax fast path keeps the problem's cohort constants
        device-resident across calls keyed on the problem STRUCTURE
        (cohort keys + worker slot shapes), so the per-reconcile cost is
        shipping the free matrix down and Cp ints back — not rebuilding
        and re-uploading the padded problem."""
        if hasattr(queues, "claim"):
            queues = [queues]
        else:
            queues = list(queues)
        # staged-but-unflushed cycles are invisible to a dry run: flush
        # them (with interleaved advancement in live-fusion mode) so the
        # preview sees post-negotiation truth
        if self._staged_times:
            self.flush_staged()
        n_cand = 1 if frees is None else len(frees)
        outs: list[list[dict]] = [[{} for _ in queues]
                                  for _ in range(n_cand)]
        workers = self.alive_workers(now)
        if not workers:
            return outs
        entries = []
        for qi, q in enumerate(queues):
            if not hasattr(q, "idle_cohorts"):
                continue          # foreign queue: no preview possible
            for key, jobs in q.idle_cohorts():
                if jobs:
                    entries.append(
                        (q.cohort_first_submit(key), qi, key, jobs))
        if not entries:
            return outs
        entries.sort(key=lambda e: (e[0], e[1]))
        rows = [(qi, key, jobs) for _first, qi, key, jobs in entries]
        reps = [next(iter(j.values())) for _qi, _k, j in rows]
        if self._quantity_sensitive(reps, workers):
            self._c_preview_legacy.value += 1
            if frees is None:
                return [self._preview_legacy(queues, rows, workers)]
            return [self._preview_legacy(queues, rows, workers, free=f)
                    for f in frees]
        problem = self._build_problem(rows, workers)
        cand = [problem.free] if frees is None else list(frees)
        fused = getattr(self.matchmaker, "preview_many", None)
        if fused is not None:
            # structure token for the backend's device-constant session
            # (worker identity is irrelevant — only slot shapes feed the
            # request/compat constants)
            token = (tuple(problem.keys),
                     tuple(w.match_key() for w in workers))
            pers = fused(problem, cand, session=token)
            prof = self.profiler
            if prof is not None:
                lc = getattr(self.matchmaker, "last_call", None)
                if lc is not None and lc.get("compiled"):
                    prof.note_compile("preview")
        else:
            pers = sequential_preview_many(self.matchmaker, problem,
                                           cand)
        for out, per in zip(outs, pers):
            for c, (qi, key, _jobs) in enumerate(rows):
                if per[c]:
                    out[qi][key] = int(per[c])
        return outs

    def _preview_legacy(self, queues, rows, workers, *,
                        free: np.ndarray | None = None) -> list[dict]:
        """Pre-protocol preview walk, kept for quantity-reading
        expressions (live-offer evals; see the caveat on `preview`)."""
        out: list[dict] = [{} for _ in queues]
        if free is None:
            free = np.stack([w.free_vec() for w in workers])
        else:
            free = np.array(free, dtype=np.float64, copy=True)
        for qi, key, jobs in rows:
            rep = next(iter(jobs.values()))
            want = _job_req_vec(rep)
            fits = cohort_fits(free, want, len(jobs))
            if fits.sum() <= 0:
                continue
            left = len(jobs)
            absorbed = 0
            for wi, w in enumerate(workers):
                if left <= 0:
                    break
                k = int(fits[wi])
                if k <= 0:
                    continue
                if not self.cohort_match(rep, w):
                    continue
                take = min(k, left)
                free[wi] -= want * take
                absorbed += take
                left -= take
            if absorbed:
                out[qi][key] = absorbed
        return out

    def scan_cycle(self, queue: JobQueue, now: float) -> int:
        """The seed's per-job FIFO cycle behind the protocol — the
        tick-engine baseline and the oracle for differential tests.
        Cohort-capable queues with quantity-blind expressions route
        through `ScanMatchmaker` on the pure problem; anything else runs
        the seed loop verbatim against live offers."""
        workers = self.alive_workers(now)
        if not workers:
            return 0
        if not hasattr(queue, "idle_cohorts"):
            return self._scan_legacy(queue, now)
        rows = [(0, k, j) for k, j in queue.idle_cohorts() if j]
        if not rows:
            return 0
        reps = [next(iter(j.values())) for _qi, _k, j in rows]
        if self._quantity_sensitive(reps, workers):
            return self._scan_legacy(queue, now)
        idle = sorted(queue.idle_jobs(), key=lambda j: j.submitted_at)
        problem = self._build_problem(rows, workers, scan_jobs=idle)
        plan = self._scan_oracle.match(problem)
        return self._apply_plan([queue], problem, plan, workers, now)

    def _scan_legacy(self, queue, now: float) -> int:
        """The seed's per-job O(idle × workers) loop, verbatim."""
        claims = 0
        idle = sorted(queue.idle_jobs(), key=lambda j: j.submitted_at)
        candidates = list(self.alive_workers(now))
        for job in idle:
            if not candidates:
                break
            matched = None
            for w in candidates:
                if symmetric_match(job.ad, w.offer_ad(),
                                   job.requirements, w.start_expr):
                    matched = w
                    break
            if matched is None:
                continue
            queue.claim(job.jid, matched.name, now)
            matched.add_claim(job)
            matched.idle_since = -1.0
            claims += 1
            free = matched.free_resources()
            exhausted = any(
                isinstance(v, (int, float)) and v <= 0
                for k, v in free.items()
                if k in ("cpus", "gpus", "chips") and matched.ad.get(k)
            )
            if exhausted:
                candidates.remove(matched)
        return claims

    # -- legacy per-claim claiming loop (quantity-expression fallback) -------
    def _match_cohorts(self, queue: JobQueue, cohorts: list, workers: list,
                       free: np.ndarray, now: float, *,
                       budget: int | None = None,
                       on_claim=None) -> int:
        """The pre-protocol vectorized claiming loop over pre-sorted
        cohorts, against a SHARED worker free-resource matrix (`free`
        mutates in place, so several schedds in one negotiation cycle
        see capacity drain as earlier ones claim).  Kept as the exact
        path for quantity-reading expressions: `budget` caps new claims
        (fair-share hands out capacity in bounded slices); `on_claim(job)`
        observes each claim (the cycle charges usage from it)."""
        claims = 0
        for key, jobs in cohorts:
            if not jobs:
                continue               # drained by an earlier slice
            if budget is not None and claims >= budget:
                break
            rep = next(iter(jobs.values()))
            want = _job_req_vec(rep)
            fits = cohort_fits(free, want, len(jobs))
            if fits.sum() <= 0:
                continue
            pending = queue.cohort_jobs_sorted(
                key, None if budget is None else budget - claims)
            if len(pending) > len(jobs):
                # a staged time-cutoff replay negotiates a submit-time
                # PREFIX of the cohort: the dict handed in is the
                # demand, and FIFO order makes the prefix exactly it
                pending = pending[:len(jobs)]
            # A START/Requirements expression that reads offered QUANTITIES
            # (e.g. 'gpus >= 2') must be re-evaluated against the shrinking
            # offer after every claim — block-claiming is only exact for
            # quantity-blind policies (the common pushed-down filters).
            per_claim_check = bool(
                (rep.requirements.refs if rep.requirements is not None
                 else frozenset()) & _QUANTITY_ATTRS)
            ji = 0
            for wi, w in enumerate(workers):
                if ji >= len(pending):
                    break
                k = int(fits[wi])
                if k <= 0:
                    continue
                if not self.cohort_match(rep, w):
                    continue
                recheck = per_claim_check or bool(
                    w.start_expr.refs & _QUANTITY_ATTRS)
                take = min(k, len(pending) - ji)
                taken = 0
                for job in pending[ji:ji + take]:
                    if recheck and taken > 0 and not self.cohort_match(
                            rep, w):
                        break
                    queue.claim(job.jid, w.name, now)
                    w.add_claim(job)
                    if on_claim is not None:
                        on_claim(job)
                    taken += 1
                w.idle_since = -1.0
                free[wi] -= want * taken
                ji += taken
                claims += taken
        return claims

    # -- deprecated shims ----------------------------------------------------
    def negotiate(self, queue: JobQueue, now: float) -> int:
        """Deprecated: use `run_cycle(queue, now)`."""
        warnings.warn(
            "Collector.negotiate is deprecated; use Collector.run_cycle",
            DeprecationWarning, stacklevel=2)
        return self.run_cycle(queue, now)

    def negotiate_scan(self, queue: JobQueue, now: float) -> int:
        """Deprecated: use `scan_cycle(queue, now)`."""
        warnings.warn(
            "Collector.negotiate_scan is deprecated; use "
            "Collector.scan_cycle", DeprecationWarning, stacklevel=2)
        return self.scan_cycle(queue, now)

    def preview_matches(self, queues, now: float) -> list[dict]:
        """Deprecated: use `preview(queues, now)`."""
        warnings.warn(
            "Collector.preview_matches is deprecated; use "
            "Collector.preview", DeprecationWarning, stacklevel=2)
        return self.preview(queues, now)


def advance_workers(
    collector: Collector,
    queue: JobQueue,
    cluster,
    now: float,
    dt: float,
    *,
    scan_matches: bool = False,
    exact_completions: bool = True,
) -> list[str]:
    """Advance all workers over [now, now+dt]: run claimed jobs, complete
    them AT THEIR EXACT FINISH TIME (not quantized to the interval end),
    start the idle-timeout clock, self-terminate (C2).  Returns names of
    workers that self-terminated.

    `scan_matches=True` / `exact_completions=False` together reproduce
    the seed tick loop verbatim (per-job C2 idle poll, completions
    quantized to now+dt, no mid-interval boot credit) — the tick-engine
    baseline; the defaults are the event engine's exact semantics."""
    t1 = now + dt
    terminated = []
    for w in list(collector.workers.values()):
        if exact_completions:
            if w.terminated or w.booted_at < 0 or w.booted_at >= t1:
                continue
            seg0 = max(now, w.booted_at)
            seg = t1 - seg0
            if seg <= 0:
                continue
        else:                      # seed: whole ticks, gated at tick start
            if w.terminated or not w.ready(now):
                continue
            seg0, seg = now, dt
        w.alive_s += seg
        idle_from = seg0         # idleness cannot predate the boot
        if w.claimed:
            busy_until = seg0
            for jid, job in list(w.claimed.items()):
                if job.work_fn is not None:
                    done = job.work_fn(job, seg)
                    t_done = t1
                elif exact_completions:
                    rate = w.work_rate
                    need = (job.remaining_s / rate if rate > 0
                            else float("inf"))
                    if need <= seg + 1e-9:
                        job.remaining_s = 0.0
                        done = True
                        t_done = min(seg0 + need, t1)
                    else:
                        job.remaining_s -= seg * rate
                        done = False
                        t_done = t1
                else:               # seed: progress and finish in dt units
                    job.remaining_s -= dt * w.work_rate
                    done = job.remaining_s <= 1e-9
                    t_done = t1
                if done:
                    # route to the owning schedd: under flocking, one
                    # worker serves jobs from several queues (`queue`
                    # here may be a FlockedQueues view)
                    (job.schedd or queue).complete(jid, t_done)
                    w.drop_claim(jid)
                busy_until = max(busy_until, t_done)
            w.busy_s += (busy_until - seg0 if exact_completions else dt)
            if not w.claimed and exact_completions:
                idle_from = busy_until   # idle clock starts at the EXACT
                #                          last-completion time, not the
                #                          segment start
        if w.claimed:
            w.idle_since = -1.0
            continue
        if w.draining:
            # backend drain: claims done — retire immediately instead of
            # waiting out idle_timeout (no new claims can arrive anyway)
            w.terminated = True
            terminated.append(w.name)
            collector.invalidate(w.name)
            if w.pod_name is not None and cluster is not None:
                cluster.succeed_pod(w.pod_name, t1)
            continue
        # idle: does any matching idle job exist? (C2 poll)
        if scan_matches:
            has_match = any(
                symmetric_match(j.ad, w.offer_ad(), j.requirements,
                                w.start_expr)
                for j in queue.idle_jobs()
            )
        else:
            has_match = collector.any_cohort_matches(w, queue)
        if has_match:
            w.idle_since = -1.0  # negotiator will claim next cycle
            continue
        if w.idle_since < 0:
            w.idle_since = idle_from
        elif t1 - w.idle_since >= w.idle_timeout:
            w.terminated = True
            terminated.append(w.name)
            collector.invalidate(w.name)
            if w.pod_name is not None and cluster is not None:
                cluster.succeed_pod(w.pod_name, t1)
    return terminated


def kill_worker(collector: Collector, queue: JobQueue, worker_name: str,
                now: float):
    """Pod/node preemption path (§5): release claimed jobs back to IDLE;
    HTCondor reschedules them transparently."""
    w = collector.workers.get(worker_name)
    if w is None:
        return
    for jid, job in list(w.claimed.items()):
        (job.schedd or queue).release(jid, now, preempted=True)
    w.clear_claims()
    w.terminated = True
    collector.invalidate(worker_name)
