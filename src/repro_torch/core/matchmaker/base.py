"""The Matchmaker protocol: pure array matchmaking behind one interface.

The negotiation cycle splits into two halves:

  * the *pure* half — given cohort demand, worker free capacity, and a
    compatibility mask, decide how many jobs of each cohort every worker
    absorbs (`Matchmaker.match`).  No queues, no claims, no ledgers: a
    `MatchProblem` of NumPy arrays in, a `MatchPlan` of NumPy arrays
    out.  Backends are swappable (`make_matchmaker("numpy"|"jax"|
    "scan")`) and must be *claim-for-claim identical* — the differential
    suite (tests/test_matchmaker_differential.py) pins this.
  * the *stateful* half — building the problem from live queues/workers
    (memoized ClassAd evals) and applying the plan back (queue.claim,
    worker.add_claim, accountant charges).  That stays in
    `core.worker.Collector`, identical regardless of backend.

Semantics contract (all backends): cohorts are processed in
``problem.order``; each cohort greedily takes ``min(fits, remaining
demand)`` from workers in INDEX order (the seed's first-match rule),
where ``fits = floor(min_r free_r/want_r + 1e-9)`` over the cohort's
positive requests — the exact arithmetic of the legacy vectorized
negotiator, so `floor(7.6/0.4 + eps) == 19` everywhere.  A zero-request
cohort fits anywhere, bounded by demand.  ``budget`` caps total claims
(fair-share hands out quantum-sized slices); ``active`` restricts the
pass to a subset of cohorts (one (schedd, user) group per slice) without
re-building the problem.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np

#: Resource quantities a slot offers / a job requests, in matrix column
#: order.  The negotiator's free-resource matrices, the quantity sanity
#: in classad.symmetric_match, and the scan oracle's exhausted-worker
#: rule all index into this tuple.
RESOURCE_KEYS = ("cpus", "gpus", "memory", "disk", "chips", "hbm_gb")

#: Columns whose exhaustion retires a worker from the scan oracle's
#: candidate list (cpus, gpus, chips — the "countable" slot resources).
EXHAUSTIBLE_IDX = (0, 1, 4)

#: The eps added before floor() when converting free/want ratios into
#: whole job slots (7.6/0.4 is 18.999...96 in binary floats and must
#: count as 19 — the scan oracle never divides, so it would claim it).
FIT_EPS = 1e-9


@dataclasses.dataclass
class MatchProblem:
    """A pure matchmaking instance: C cohorts × W workers × R resources.

    Built once per negotiation cycle by `Collector._build_problem`;
    `free` and `demand` are threaded through successive fair-share
    slices (assign ``free = plan.free_after`` and decrement ``demand``
    by the per-cohort take sums between `match` calls).
    """
    keys: list          # per cohort: (queue index, cohort key)
    requests: np.ndarray      # (C, R) float64 — per-job request vector
    demand: np.ndarray        # (C,)  int64 — idle jobs in the cohort
    order: np.ndarray         # (C,)  int64 — cohort processing order
    free: np.ndarray          # (W, R) float64 — live free capacity
    capacity: np.ndarray      # (W, R) float64 — full-slot capacity
    compat: np.ndarray        # (C, W) bool — expression compatibility
    scan_order: np.ndarray | None = None
    #: per-JOB cohort indices in global FIFO (submit-time) order — only
    #: the scan oracle consumes this; (sum(demand),) int64.

    @property
    def n_cohorts(self) -> int:
        return int(self.compat.shape[0])

    @property
    def n_workers(self) -> int:
        return int(self.compat.shape[1])


@dataclasses.dataclass
class MatchPlan:
    """The pure result: how many jobs of cohort c worker w absorbs."""
    takes: np.ndarray         # (C, W) int64
    free_after: np.ndarray    # (W, R) float64

    @property
    def claimed(self) -> int:
        return int(self.takes.sum())

    def per_cohort(self) -> np.ndarray:
        return self.takes.sum(axis=1)


@dataclasses.dataclass
class CycleDelta:
    """Host-staged state change applied BEFORE one fused negotiation
    cycle: demand that arrived since the previous cycle, capacity that
    was returned (completions), and the cycle's claim budget.

    `match_cycles` semantics (every backend, and the shared
    `sequential_match_cycles` reference): starting from the problem's
    demand/free, for each delta in order apply ``demand += arrivals``
    and ``free += free_add``, solve one plain cycle (no ``active``
    mask — fair-share slices stay on the per-cycle path), then carry
    ``demand -= plan.per_cohort()`` and ``free = plan.free_after`` into
    the next cycle.  K cycles, K plans, bit-identical to K sequential
    `match` calls with the same deltas applied host-side."""
    arrivals: np.ndarray            # (C,) int64 — demand added
    free_add: np.ndarray | None = None   # (W, R) float64 — capacity back
    budget: int | None = None       # per-cycle claim cap


@runtime_checkable
class Matchmaker(Protocol):
    """Anything with a ``name`` and a pure ``match``; see the module
    docstring for the semantics every implementation must honour."""

    name: str

    def match(self, problem: MatchProblem, *,
              budget: int | None = None,
              active: np.ndarray | None = None) -> MatchPlan:
        """Solve one matchmaking pass.  Must NOT mutate the problem."""
        ...


def sequential_match_cycles(mm: "Matchmaker", problem: MatchProblem,
                            deltas: list[CycleDelta]) -> list[MatchPlan]:
    """The K-cycle reference semantics: K independent `match` calls with
    the deltas applied host-side between them.  Backends without a fused
    `match_cycles` route here; the fused jax path must be bit-identical
    to this loop (tests/test_fused_negotiation.py pins it)."""
    demand = np.asarray(problem.demand, dtype=np.int64).copy()
    free = np.array(problem.free, dtype=np.float64, copy=True)
    plans: list[MatchPlan] = []
    for d in deltas:
        demand = demand + np.asarray(d.arrivals, dtype=np.int64)
        if d.free_add is not None:
            free = free + d.free_add
        sub = dataclasses.replace(problem, demand=demand, free=free)
        plan = mm.match(sub, budget=d.budget)
        demand = demand - plan.per_cohort()
        free = plan.free_after
        plans.append(plan)
    return plans


def match_cycles(mm: "Matchmaker", problem: MatchProblem,
                 deltas: list[CycleDelta]) -> list[MatchPlan]:
    """Dispatch K consecutive cycles to the backend's fused
    implementation when it has one, else the sequential reference."""
    fused = getattr(mm, "match_cycles", None)
    if fused is not None:
        return fused(problem, deltas)
    return sequential_match_cycles(mm, problem, deltas)


def sequential_preview_many(mm: "Matchmaker", problem: MatchProblem,
                            frees: list[np.ndarray],
                            demands: list[np.ndarray] | None = None,
                            ) -> list[np.ndarray]:
    """The batched-preview reference semantics: N INDEPENDENT previews of
    the same cohort structure, candidate i solved against ``frees[i]``
    (and ``demands[i]`` when given, else the problem's demand), each
    returning only the per-cohort absorbed counts ``plan.per_cohort()``.
    Candidates do NOT carry state into each other — this is the
    provisioner asking "what WOULD each candidate pool shape absorb",
    not a fused multi-cycle negotiation.  Backends with a vectorised
    `preview_many` must match this loop exactly
    (tests/test_preview_many.py pins it against the numpy reference)."""
    out: list[np.ndarray] = []
    for i, f in enumerate(frees):
        sub = dataclasses.replace(
            problem, free=f,
            demand=problem.demand if demands is None else demands[i])
        out.append(mm.match(sub).per_cohort())
    return out


def preview_many(mm: "Matchmaker", problem: MatchProblem,
                 frees: list[np.ndarray],
                 demands: list[np.ndarray] | None = None,
                 ) -> list[np.ndarray]:
    """Dispatch a batch of independent previews to the backend's
    vectorised implementation when it has one (the jax backend evaluates
    all candidates in ONE jitted vmap dispatch), else the sequential
    reference."""
    fused = getattr(mm, "preview_many", None)
    if fused is not None:
        return fused(problem, frees, demands)
    return sequential_preview_many(mm, problem, frees, demands)


def cohort_fits(free: np.ndarray, want: np.ndarray,
                demand: int) -> np.ndarray:
    """How many `want`-sized jobs each worker row of `free` absorbs —
    the shared fits arithmetic (see FIT_EPS).  Zero-request cohorts fit
    anywhere, bounded by demand."""
    pos = want > 0
    if pos.any():
        fits = np.floor((free[:, pos] / want[pos]).min(axis=1) + FIT_EPS)
        return np.maximum(fits, 0.0)
    return np.full(free.shape[0], float(demand))


# -- registry ----------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., Matchmaker]] = {}


def register_matchmaker(name: str, factory: Callable[..., Matchmaker]):
    """Register a backend factory under `name` (how to add a backend:
    implement `match`, register a factory, and run the differential
    suite against the numpy reference — see README 'Negotiation
    architecture')."""
    _REGISTRY[name] = factory


def matchmaker_names() -> list[str]:
    return sorted(_REGISTRY)


def make_matchmaker(spec: Any = "numpy", **kwargs) -> Matchmaker:
    """Resolve a backend: an instance passes through, a registered name
    is constructed (kwargs forwarded to the factory)."""
    if spec is None:
        spec = "numpy"
    if isinstance(spec, str):
        try:
            factory = _REGISTRY[spec]
        except KeyError:
            raise ValueError(
                f"unknown matchmaker {spec!r}; "
                f"registered: {matchmaker_names()}") from None
        return factory(**kwargs)
    if isinstance(spec, Matchmaker):
        return spec
    raise TypeError(f"matchmaker must be a name or Matchmaker instance, "
                    f"got {spec!r}")


# -- problems carried across from another implementation ---------------------

def _carried(obj: Any, field: str, dtype, shape: tuple) -> np.ndarray:
    arr = np.asarray(getattr(obj, field))
    if arr.dtype != dtype:
        raise TypeError(f"MatchProblem.{field} must be {np.dtype(dtype)}, "
                        f"got {arr.dtype}")
    if arr.shape != shape:
        raise ValueError(f"MatchProblem.{field} must have shape {shape}, "
                         f"got {arr.shape}")
    return arr.copy()


def problem_from_reference(obj: Any) -> MatchProblem:
    """This package's `MatchProblem` from any object that carries the
    same fields as NumPy arrays (typically the JAX package's
    `MatchProblem`).  Every array is copied, so the two problems share
    no memory, and its dtype and shape are checked against the field
    table of `MatchProblem`: a problem built elsewhere is solved here
    exactly as given, or refused."""
    C, W = np.shape(obj.compat)
    R = np.shape(obj.requests)[-1]
    scan_order = getattr(obj, "scan_order", None)
    if scan_order is not None:
        scan_order = _carried(obj, "scan_order", np.int64,
                              (len(scan_order),))
    return MatchProblem(
        keys=list(obj.keys),
        requests=_carried(obj, "requests", np.float64, (C, R)),
        demand=_carried(obj, "demand", np.int64, (C,)),
        order=_carried(obj, "order", np.int64, (C,)),
        free=_carried(obj, "free", np.float64, (W, R)),
        capacity=_carried(obj, "capacity", np.float64, (W, R)),
        compat=_carried(obj, "compat", np.bool_, (C, W)),
        scan_order=scan_order,
    )
