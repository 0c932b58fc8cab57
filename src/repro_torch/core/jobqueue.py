"""The schedd: job queue with HTCondor-like job states and ads.

Jobs are pleasantly-parallel work units (the paper's OSG payload model).
Each job carries an ad (requirements + arbitrary advertised attributes) and
a simulated runtime; the "real mode" used by the examples attaches a
work_fn that advances actual JAX training steps instead.

Preemption semantics (paper §5): a preempted job transparently returns to
IDLE and reruns elsewhere; `preempt_count` and total wasted work are
tracked for the benchmarks.

Scale: the queue is fully indexed.  Jobs live in per-state buckets, so
`n_idle()` / `n_running()` are O(1), and idle jobs are additionally
bucketed into COHORTS — groups with identical ads and requirement
expressions, hence identical matchmaking behaviour.  A 100k-job campaign
of uniform jobs is ONE cohort: the negotiator and the provisioner evaluate
ClassAd expressions once per cohort instead of once per job.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, Callable, Iterable, Iterator

from repro_torch.core.classad import ClassAdExpr


class JobState(enum.Enum):
    IDLE = "idle"
    RUNNING = "running"
    COMPLETED = "completed"
    HELD = "held"
    REMOVED = "removed"


#: ad attribute naming the submitter; jobs without one are accounted
#: under a single anonymous submitter
USER_ATTR = "user"
DEFAULT_USER = "unknown"


def user_of(job: "Job") -> str:
    """Submitter a job is accounted to (its ad's ``user`` attribute)."""
    u = job.ad.get(USER_ATTR)
    return str(u) if u else DEFAULT_USER


@dataclasses.dataclass
class Job:
    ad: dict[str, Any]
    runtime_s: float = 60.0
    requirements: ClassAdExpr | None = None
    work_fn: Callable[["Job", float], bool] | None = None  # (job, dt) -> done
    jid: int = -1

    # lifecycle
    state: JobState = JobState.IDLE
    submitted_at: float = 0.0
    started_at: float = -1.0          # first claim (wait-time metric)
    attempt_started_at: float = -1.0  # latest claim (straggler detection)
    completed_at: float = -1.0
    remaining_s: float = dataclasses.field(default=-1.0)
    preempt_count: int = 0
    wasted_s: float = 0.0         # work lost to preemption
    claimed_by: str | None = None
    cohort_key: tuple | None = None   # assigned at submit; ad-derived
    # owning queue, stamped at submit: with several schedds flocking
    # into one pool, a worker's completions must route back to the
    # schedd the job came from (worker.py advance_workers)
    schedd: Any = dataclasses.field(default=None, repr=False,
                                    compare=False)

    def __post_init__(self):
        if self.remaining_s < 0:
            self.remaining_s = self.runtime_s


def _freeze(v: Any) -> Any:
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    return repr(v)


def canonical_ad(ad: dict[str, Any]) -> tuple:
    """Hashable canonical form of an ad.  Job cohorts AND worker slot
    shapes use this SAME canonicalization — the two halves jointly key
    the collector's match cache, so they must never diverge."""
    return tuple(sorted((str(k), _freeze(v)) for k, v in ad.items()))


def cohort_key_of(job: Job) -> tuple:
    """Matchmaking-equivalence key: two jobs with the same key match the
    same workers (same ad contents, same Requirements expression)."""
    req = job.requirements.src if job.requirements is not None else ""
    return (req, canonical_ad(job.ad))


# -- job (de)serialization ----------------------------------------------------
def job_state(job: Job) -> dict:
    """JSON-safe snapshot of a Job.  Requirements serialize as their
    source text (recompiled on load — ClassAdExpr compilation is pure);
    `work_fn` jobs cannot snapshot: an arbitrary Python closure has no
    faithful serial form, and resuming it mid-flight would silently
    change semantics."""
    if job.work_fn is not None:
        raise ValueError(
            f"job {job.jid} has a work_fn; live-callable jobs cannot be "
            "snapshotted")
    return {
        "jid": job.jid,
        "ad": dict(job.ad),
        "runtime_s": job.runtime_s,
        "requirements": (job.requirements.src
                         if job.requirements is not None else None),
        "state": job.state.value,
        "submitted_at": job.submitted_at,
        "started_at": job.started_at,
        "attempt_started_at": job.attempt_started_at,
        "completed_at": job.completed_at,
        "remaining_s": job.remaining_s,
        "preempt_count": job.preempt_count,
        "wasted_s": job.wasted_s,
        "claimed_by": job.claimed_by,
    }


def job_from_state(state: dict, *, schedd: "JobQueue | None" = None) -> Job:
    req_src = state.get("requirements")
    job = Job(
        ad=dict(state["ad"]),
        runtime_s=float(state["runtime_s"]),
        requirements=ClassAdExpr(req_src) if req_src else None,
        jid=int(state["jid"]),
        state=JobState(state["state"]),
        submitted_at=float(state["submitted_at"]),
        started_at=float(state.get("started_at", -1.0)),
        attempt_started_at=float(state.get("attempt_started_at", -1.0)),
        completed_at=float(state.get("completed_at", -1.0)),
        remaining_s=float(state["remaining_s"]),
        preempt_count=int(state.get("preempt_count", 0)),
        wasted_s=float(state.get("wasted_s", 0.0)),
        claimed_by=state.get("claimed_by"),
        schedd=schedd,
    )
    job.cohort_key = cohort_key_of(job)
    return job


class JobQueue:
    """Single schedd. The provisioner and the workers both query it — the
    workers through the collector's matchmaking (worker.py).

    Completion streaming: `add_complete_hook(fn)` registers observers
    called once per completed job, and `keep_completed = False` stops the
    queue retaining completed `Job` objects in `completed_log` — together
    they let a 100k-arrival trace replay aggregate wait/goodput stats
    without ever holding more than the in-flight jobs alive
    (workload/replay.py)."""

    def __init__(self, name: str = "schedd", ids=None):
        # `name` identifies this schedd in a flocking federation (metric
        # scopes, deficit attribution); `ids` lets several queues share
        # one job-id counter so jids stay pool-unique — a worker's claim
        # table is keyed by jid across every schedd it serves
        self.name = name
        self._jobs: dict[int, Job] = {}
        self._ids = ids if ids is not None else itertools.count()
        self.completed_log: list[Job] = []
        self.keep_completed = True
        self._complete_hooks: list[Callable[[Job], None]] = []
        self._claim_hooks: list[Callable[[Job, float], None]] = []
        self._release_hooks: list[Callable[[Job, float], None]] = []
        # fn(job, +1|-1) on every IDLE entry/exit — the provisioner's
        # incremental deficit counters live off these (O(changes)
        # maintenance instead of a per-cycle recount)
        self._idle_hooks: list[Callable[[Job, int], None]] = []
        # per-user running-job counts (fair-share metrics read these;
        # the accountant tracks core RATES itself via the hooks)
        self.running_by_user: dict[str, int] = {}
        # bumped whenever the SET of idle cohorts changes (a cohort is
        # born or drained) — the collector's C2 idle-poll verdict for an
        # unclaimed worker is a pure function of this set, so workers
        # cache it per version (worker.py any_cohort_matches)
        self.idle_version = 0
        # bumped on EVERY job entering or leaving IDLE — the fine-grained
        # companion of idle_version (which only moves on cohort births/
        # drains): "has the idle set changed at all?" is one int compare
        self.idle_seq = 0
        # indexes: per-state buckets + idle cohorts (jid -> Job each)
        self._by_state: dict[JobState, dict[int, Job]] = {
            s: {} for s in JobState
        }
        self._idle_cohorts: dict[tuple, dict[int, Job]] = {}
        # per-cohort FIFO bookkeeping: earliest (submitted_at, jid) seen
        # (sort key across cohorts) and whether insertion order ever
        # violated FIFO (a released job re-entering behind newer ones) —
        # only then does cohort_jobs_sorted() actually have to sort
        self._cohort_min: dict[tuple, tuple] = {}
        self._cohort_tail: dict[tuple, tuple] = {}
        self._cohort_unsorted: set[tuple] = set()
        # a draining schedd stops ACCEPTING submissions (the pool
        # service refuses them) but keeps negotiating until empty, then
        # detaches — the schedd-side mirror of backend draining
        self.draining = False

    # -- index maintenance ---------------------------------------------------
    def _enter_state(self, job: Job, state: JobState):
        self._by_state[state][job.jid] = job
        job.state = state
        if state == JobState.IDLE:
            key = job.cohort_key
            cohort = self._idle_cohorts.get(key)
            if cohort is None:
                cohort = self._idle_cohorts[key] = {}
                self.idle_version += 1
            cohort[job.jid] = job
            order = (job.submitted_at, job.jid)
            cur_min = self._cohort_min.get(key)
            if cur_min is None or order < cur_min:
                self._cohort_min[key] = order
            tail = self._cohort_tail.get(key)
            if tail is not None and order < tail:
                self._cohort_unsorted.add(key)
            if tail is None or order > tail:
                self._cohort_tail[key] = order
            self.idle_seq += 1
            for hook in self._idle_hooks:
                hook(job, +1)

    def _leave_state(self, job: Job):
        self._by_state[job.state].pop(job.jid, None)
        if job.state == JobState.IDLE:
            key = job.cohort_key
            cohort = self._idle_cohorts.get(key)
            if cohort is not None:
                cohort.pop(job.jid, None)
                if not cohort:
                    del self._idle_cohorts[key]
                    self._cohort_min.pop(key, None)
                    self._cohort_tail.pop(key, None)
                    self._cohort_unsorted.discard(key)
                    self.idle_version += 1
            self.idle_seq += 1
            for hook in self._idle_hooks:
                hook(job, -1)

    def submit(self, job: Job, now: float = 0.0) -> int:
        job.jid = next(self._ids)
        job.submitted_at = now
        job.schedd = self
        if job.cohort_key is None:
            job.cohort_key = cohort_key_of(job)
        self._jobs[job.jid] = job
        self._enter_state(job, JobState.IDLE)
        return job.jid

    def jobs(self, state: JobState | None = None) -> list[Job]:
        if state is None:
            return list(self._jobs.values())
        return list(self._by_state[state].values())

    def idle_jobs(self) -> list[Job]:
        return list(self._by_state[JobState.IDLE].values())

    def idle_cohorts(self) -> Iterator[tuple[tuple, dict[int, Job]]]:
        """(cohort_key, {jid: job}) for every non-empty idle cohort.
        Every job in a cohort matches exactly the same workers."""
        return iter(list(self._idle_cohorts.items()))

    def cohort_rep(self, key: tuple) -> Job | None:
        """One representative member of an idle cohort (all members
        carry matchmaking-identical ads), or None if the cohort is not
        currently idle.  O(1) — consumers holding bare cohort keys (the
        provisioner mapping preview absorption onto group signatures)
        must not pay a cohort scan per lookup."""
        cohort = self._idle_cohorts.get(key)
        if not cohort:
            return None
        return next(iter(cohort.values()))

    def cohort_first_submit(self, key: tuple) -> tuple:
        """Earliest (submitted_at, jid) a cohort has held while idle —
        the negotiator's cross-cohort FIFO key.  May be slightly stale
        after the oldest member leaves; a lower bound is fine for
        ordering."""
        return self._cohort_min.get(key, (float("inf"), -1))

    def cohort_jobs_sorted(self, key: tuple,
                           limit: int | None = None) -> list[Job]:
        """A cohort's idle jobs in FIFO (submission) order.  Insertion
        order already IS submission order unless a released job re-entered
        behind newer ones — then ONE sort is paid and the cohort dict is
        rebuilt in order (flag + tail reset), restoring the O(n) fast
        path for subsequent cycles.  `limit` returns only the first N —
        fair-share hands out claim budgets of a few jobs at a time, and
        must not copy a 10k-job cohort to take one."""
        cohort = self._idle_cohorts.get(key)
        if not cohort:
            return []
        if key in self._cohort_unsorted:
            jobs = sorted(cohort.values(),
                          key=lambda j: (j.submitted_at, j.jid))
            self._idle_cohorts[key] = {j.jid: j for j in jobs}
            self._cohort_unsorted.discard(key)
            last = jobs[-1]
            self._cohort_tail[key] = (last.submitted_at, last.jid)
            return jobs if limit is None else jobs[:limit]
        if limit is None or limit >= len(cohort):
            return list(cohort.values())
        return list(itertools.islice(cohort.values(), limit))

    def get(self, jid: int) -> Job:
        return self._jobs[jid]

    # -- transitions (driven by workers) -------------------------------------
    def claim(self, jid: int, worker_name: str, now: float) -> Job:
        job = self._jobs[jid]
        assert job.state == JobState.IDLE, (jid, job.state)
        self._leave_state(job)
        self._enter_state(job, JobState.RUNNING)
        job.claimed_by = worker_name
        job.attempt_started_at = now
        if job.started_at < 0:
            job.started_at = now
        user = user_of(job)
        self.running_by_user[user] = self.running_by_user.get(user, 0) + 1
        for hook in self._claim_hooks:
            hook(job, now)
        return job

    def _drop_running_user(self, job: Job):
        user = user_of(job)
        n = self.running_by_user.get(user, 0) - 1
        if n > 0:
            self.running_by_user[user] = n
        else:
            self.running_by_user.pop(user, None)

    def add_complete_hook(self, fn: Callable[[Job], None]):
        """Observe every completion as it happens (streaming stats)."""
        self._complete_hooks.append(fn)

    def add_claim_hook(self, fn: Callable[[Job, float], None]):
        """Observe every claim as it happens — the fair-share accountant
        bumps the submitter's running-core rate here."""
        self._claim_hooks.append(fn)

    def add_release_hook(self, fn: Callable[[Job, float], None]):
        """Observe every RUNNING -> IDLE release (preemption / worker
        death) — the accounting mirror of the claim hook."""
        self._release_hooks.append(fn)

    def add_idle_hook(self, fn: Callable[[Job, int], None]):
        """Observe every idle-set mutation as `fn(job, +1|-1)` — +1 when
        a job enters IDLE (submit, release), -1 when it leaves (claim,
        complete, remove).  NOT replayed by `load_state`; counter-style
        consumers must rebuild from `idle_jobs()` after a restore."""
        self._idle_hooks.append(fn)

    def complete(self, jid: int, now: float):
        job = self._jobs.pop(jid)
        if job.state == JobState.RUNNING:
            self._drop_running_user(job)
        self._leave_state(job)
        job.state = JobState.COMPLETED
        job.completed_at = now
        job.claimed_by = None
        for hook in self._complete_hooks:
            hook(job)
        if self.keep_completed:
            self.completed_log.append(job)

    def release(self, jid: int, now: float, *, preempted: bool = True):
        """Job returns to IDLE (preemption / worker death). Progress on the
        current attempt is lost — HTCondor restarts vanilla-universe jobs."""
        job = self._jobs[jid]
        if job.state != JobState.RUNNING:
            return
        if preempted:
            job.preempt_count += 1
            done = job.runtime_s - job.remaining_s  # progress so far
            # Jobs restart from scratch (HTCondor vanilla universe) unless
            # they self-checkpoint (OSG best practice; our JAX training
            # jobs do): then only progress past the last boundary is lost.
            ckpt_every = job.ad.get("checkpoint_interval_s") or 0
            kept = (done // ckpt_every) * ckpt_every if ckpt_every else 0.0
            job.wasted_s += done - kept
            job.remaining_s = job.runtime_s - kept
        self._drop_running_user(job)
        self._leave_state(job)
        self._enter_state(job, JobState.IDLE)
        job.claimed_by = None
        for hook in self._release_hooks:
            hook(job, now)

    def remove(self, jid: int, now: float) -> Job | None:
        """`condor_rm`: take a job out of the queue entirely.  Running
        jobs are released first so the release hooks fire (the fair-share
        accountant's core rates stay exact); the CALLER must also drop
        the worker-side claim (`job.claimed_by` names it).  Returns the
        removed Job, or None if the jid is unknown."""
        job = self._jobs.get(jid)
        if job is None:
            return None
        if job.state == JobState.RUNNING:
            self._drop_running_user(job)
            for hook in self._release_hooks:
                hook(job, now)
        self._leave_state(job)
        self._jobs.pop(jid, None)
        job.state = JobState.REMOVED
        job.claimed_by = None
        return job

    # -- persistence ----------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe snapshot.  Iteration ORDERS are part of the state:
        negotiation sorts are stable, best-fit ties break on insertion
        order, and `_cohort_min` is a possibly-stale lower bound that
        cross-cohort FIFO ordering depends on — so the snapshot carries
        jobs in `_jobs` order, per-state jid lists, the idle-cohort
        member lists in cohort order, and the raw min/tail/unsorted
        bookkeeping rather than anything recomputed.  Hooks and the
        (possibly shared) jid counter are NOT serialized — the restoring
        Simulation re-attaches hooks at construction and re-seeds the
        shared counter itself."""
        idle_order = []
        cohort_meta = []
        for key, cohort in self._idle_cohorts.items():
            idle_order.append(list(cohort.keys()))
            m = self._cohort_min.get(key)
            t = self._cohort_tail.get(key)
            cohort_meta.append({
                "min": list(m) if m is not None else None,
                "tail": list(t) if t is not None else None,
                "unsorted": key in self._cohort_unsorted,
            })
        return {
            "name": self.name,
            "draining": self.draining,
            "keep_completed": self.keep_completed,
            "idle_version": self.idle_version,
            "idle_seq": self.idle_seq,
            "jobs": [job_state(j) for j in self._jobs.values()],
            "by_state": {
                s.value: list(self._by_state[s].keys())
                for s in JobState if self._by_state[s]
            },
            "idle_order": idle_order,
            "cohort_meta": cohort_meta,
            "completed": [job_state(j) for j in self.completed_log],
        }

    def load_state(self, state: dict) -> None:
        """Restore from `state_dict()` output, rebuilding every index in
        the serialized order (NOT via submit(): that would re-fire hooks
        and reassign jids).  Leaves hooks and `_ids` untouched."""
        self.draining = bool(state.get("draining", False))
        self.keep_completed = bool(state.get("keep_completed", True))
        jobs = [job_from_state(s, schedd=self) for s in state.get("jobs", [])]
        self._jobs = {j.jid: j for j in jobs}
        self._by_state = {s: {} for s in JobState}
        for sval, jids in state.get("by_state", {}).items():
            bucket = self._by_state[JobState(sval)]
            for jid in jids:
                bucket[jid] = self._jobs[jid]
        self._idle_cohorts = {}
        self._cohort_min = {}
        self._cohort_tail = {}
        self._cohort_unsorted = set()
        for jids, meta in zip(state.get("idle_order", []),
                              state.get("cohort_meta", [])):
            members = {jid: self._jobs[jid] for jid in jids}
            key = next(iter(members.values())).cohort_key
            self._idle_cohorts[key] = members
            if meta.get("min") is not None:
                self._cohort_min[key] = tuple(meta["min"])
            if meta.get("tail") is not None:
                self._cohort_tail[key] = tuple(meta["tail"])
            if meta.get("unsorted"):
                self._cohort_unsorted.add(key)
        self.idle_version = int(state.get("idle_version", 0))
        self.idle_seq = int(state.get("idle_seq", 0))
        self.completed_log = [job_from_state(s, schedd=self)
                              for s in state.get("completed", [])]
        self.running_by_user = {}
        for j in self._by_state[JobState.RUNNING].values():
            u = user_of(j)
            self.running_by_user[u] = self.running_by_user.get(u, 0) + 1

    # -- stats ----------------------------------------------------------------
    def n_idle(self) -> int:
        return len(self._by_state[JobState.IDLE])

    def n_idle_cohorts(self) -> int:
        """Distinct matchmaking-equivalence classes currently idle — how a
        trace's requirement mix materializes in the queue (a uniform burst
        is 1; a replayed OSG day is kinds × users × Requirements)."""
        return len(self._idle_cohorts)

    def n_running(self) -> int:
        return len(self._by_state[JobState.RUNNING])

    def idle_by_user(self, now: float | None = None
                     ) -> dict[str, tuple[int, float]]:
        """{user: (idle count, starvation age)} from the idle cohorts —
        starvation age is `now` minus the oldest idle submission the
        user has CURRENTLY pending (0.0 when `now` is omitted).  One
        pass over cohorts, not jobs: the oldest live member is the
        cohort's first FIFO entry (`_cohort_min` would do — but it is
        only reset when a cohort fully drains, so a continuously-fed
        cohort would pin the age at its first-ever arrival)."""
        out: dict[str, tuple[int, float]] = {}
        for key, jobs in self._idle_cohorts.items():
            rep = next(iter(jobs.values()))
            user = user_of(rep)
            oldest = self.cohort_jobs_sorted(key, 1)[0].submitted_at
            n, prev_oldest = out.get(user, (0, float("inf")))
            out[user] = (n + len(jobs), min(prev_oldest, oldest))
        return {
            u: (n, max(0.0, (now - t) if now is not None
                       and t != float("inf") else 0.0))
            for u, (n, t) in out.items()
        }

    def drained(self) -> bool:
        return not self._jobs


class FlockedQueues:
    """Federation view over several schedds' queues, for pool
    components that held a single-queue handle (the C2 idle poll, the
    tick engine's scan negotiation, straggler mitigation).  Claims and
    completions do NOT go through this view — they route to the owning
    queue via `job.schedd`; only `release` routes here, by jid, for
    callers that hold job ids rather than Job objects."""

    def __init__(self, queues: Iterable[JobQueue]):
        self.queues = list(queues)

    @property
    def idle_version(self) -> int:
        # sum of per-queue versions: monotonic, and it changes whenever
        # any queue's idle-cohort SET changes — the property the
        # collector's C2 poll cache keys on
        return sum(q.idle_version for q in self.queues)

    @property
    def idle_seq(self) -> int:
        return sum(q.idle_seq for q in self.queues)

    def idle_cohorts(self) -> Iterator[tuple[tuple, dict[int, Job]]]:
        for q in self.queues:
            yield from q.idle_cohorts()

    def idle_jobs(self) -> list[Job]:
        out: list[Job] = []
        for q in self.queues:
            out.extend(q.idle_jobs())
        return out

    def jobs(self, state: JobState | None = None) -> list[Job]:
        out: list[Job] = []
        for q in self.queues:
            out.extend(q.jobs(state))
        return out

    def release(self, jid: int, now: float, *, preempted: bool = True):
        """Route a release to the owning queue (jids are pool-unique
        when the queues share an id counter — the straggler policy
        holds jids, not Job objects)."""
        for q in self.queues:
            if jid in q._jobs:
                q.release(jid, now, preempted=preempted)
                return
        raise KeyError(jid)

    def n_idle(self) -> int:
        return sum(q.n_idle() for q in self.queues)

    def n_idle_cohorts(self) -> int:
        return sum(q.n_idle_cohorts() for q in self.queues)

    def n_running(self) -> int:
        return sum(q.n_running() for q in self.queues)

    def drained(self) -> bool:
        return all(q.drained() for q in self.queues)
