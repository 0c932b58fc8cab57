"""Seeded synthetic workload generators: OSG-shaped traces at any scale.

The OSG follow-up paper (arXiv:2308.11733) characterizes the demand the
provisioner must track: Poisson-like arrivals modulated by a diurnal
cycle, heavy-tailed runtimes (log-normal body, Pareto tail), a small set
of requirement shapes (single-core dominates, with multicore / high-mem /
GPU minorities), and correlated bursts where one user dumps thousands of
near-identical jobs at once.  These generators reproduce each ingredient
separately and compose them into campaigns, so we can produce realistic
traces at any scale without shipping data.

Everything is driven by one `numpy` Generator seeded by the caller:
the same seed yields a byte-identical serialized trace (trace.py's
determinism contract), different seeds yield different traces — the
property tests pin both.

Arrival sampling draws exactly `n` arrivals from the normalized rate
profile via inverse-CDF (a Poisson process conditioned on its count), so
`--jobs 10000` means 10000 records, not "about 10000".
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.workload.trace import Trace, TraceRecord

DAY_S = 86400.0


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------

def diurnal_profile(amplitude: float = 0.6, period_s: float = DAY_S,
                    phase_s: float = 0.75 * DAY_S) -> Callable:
    """Day/night demand modulation: rate(t) ∝ 1 + amplitude·sin(...),
    peaking mid-"working day" for the default phase.  amplitude in
    [0, 1) keeps the rate strictly positive."""
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")

    def rate(t):
        return 1.0 + amplitude * np.sin(
            2.0 * np.pi * (t - phase_s) / period_s)

    return rate


def arrival_times(rng: np.random.Generator, n: int, duration_s: float,
                  profile: Callable | None = None,
                  grid: int = 2048) -> np.ndarray:
    """Exactly `n` sorted arrival times on [0, duration_s) drawn from the
    density ∝ profile(t) (uniform when None) — a Poisson process
    conditioned on its total count, sampled by inverse-CDF over a
    discretized rate integral."""
    if n <= 0:
        return np.empty(0)
    u = np.sort(rng.random(n))
    if profile is None:
        return u * duration_s
    ts = np.linspace(0.0, duration_s, grid + 1)
    rates = np.maximum(np.asarray([profile(t) for t in ts]), 1e-12)
    cdf = np.concatenate([[0.0], np.cumsum(
        0.5 * (rates[1:] + rates[:-1]) * np.diff(ts))])
    cdf /= cdf[-1]
    return np.interp(u, cdf, ts)


def poisson_arrivals(rng: np.random.Generator, rate_per_s: float,
                     duration_s: float, t0: float = 0.0) -> np.ndarray:
    """Open-ended homogeneous Poisson process: exponential inter-arrivals
    at `rate_per_s` until `duration_s` (count is random)."""
    if rate_per_s <= 0:
        raise ValueError(f"rate must be positive, got {rate_per_s}")
    n_guess = max(16, int(rate_per_s * duration_s * 1.25) + 16)
    out: list[float] = []
    t = t0
    while True:
        gaps = rng.exponential(1.0 / rate_per_s, size=n_guess)
        for g in gaps:
            t += g
            if t >= t0 + duration_s:
                return np.asarray(out)
            out.append(t)


# ---------------------------------------------------------------------------
# Runtime models (heavy-tailed)
# ---------------------------------------------------------------------------

def lognormal_runtimes(rng: np.random.Generator, n: int, median_s: float,
                       sigma: float, min_s: float = 1.0) -> np.ndarray:
    return np.maximum(min_s,
                      median_s * np.exp(sigma * rng.standard_normal(n)))


def pareto_runtimes(rng: np.random.Generator, n: int, min_s: float,
                    alpha: float, cap_s: float | None = None) -> np.ndarray:
    out = min_s * (1.0 + rng.pareto(alpha, size=n))
    return np.minimum(out, cap_s) if cap_s is not None else out


# ---------------------------------------------------------------------------
# Requirement mix
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JobKind:
    """One requirement shape in a mix, with its own runtime model.
    `runtime_dist` is 'lognormal' (median/sigma) or 'pareto'
    (min/alpha, capped); `attrs`/`requirements` ride into the job ad so
    each kind forms its own provisioning group and idle cohorts."""

    name: str
    weight: float = 1.0
    cpus: int = 1
    gpus: int = 0
    memory_gb: float = 2.0
    disk_gb: float = 8.0
    requirements: str = ""
    attrs: tuple[tuple[str, str], ...] = ()
    runtime_dist: str = "lognormal"
    runtime_median_s: float = 1800.0
    runtime_sigma: float = 1.0
    runtime_min_s: float = 30.0
    runtime_alpha: float = 1.6
    runtime_cap_s: float = 6.0 * 3600.0

    def sample_runtimes(self, rng: np.random.Generator,
                        n: int) -> np.ndarray:
        if self.runtime_dist == "lognormal":
            return lognormal_runtimes(rng, n, self.runtime_median_s,
                                      self.runtime_sigma,
                                      min_s=self.runtime_min_s)
        if self.runtime_dist == "pareto":
            return pareto_runtimes(rng, n, self.runtime_min_s,
                                   self.runtime_alpha,
                                   cap_s=self.runtime_cap_s)
        raise ValueError(f"unknown runtime_dist {self.runtime_dist!r}")


# the OSG-shaped default mix: single-core dominates; multicore, high-mem,
# GPU, and a Pareto-tailed scavenger class make up the rest (2308.11733)
OSG_KINDS: tuple[JobKind, ...] = (
    JobKind("cpu-short", weight=0.50, cpus=1, memory_gb=2,
            runtime_median_s=1200.0, runtime_sigma=1.1),
    JobKind("cpu-multicore", weight=0.18, cpus=8, memory_gb=16,
            runtime_median_s=3600.0, runtime_sigma=0.8),
    JobKind("cpu-highmem", weight=0.10, cpus=4, memory_gb=32,
            requirements="memory >= 32",
            runtime_median_s=2700.0, runtime_sigma=0.9),
    JobKind("scavenger", weight=0.12, cpus=1, memory_gb=2,
            runtime_dist="pareto", runtime_min_s=120.0, runtime_alpha=1.5),
    JobKind("gpu", weight=0.10, cpus=4, gpus=1, memory_gb=16,
            attrs=(("arch", "gpu"),),
            requirements="arch == 'gpu'",
            runtime_median_s=5400.0, runtime_sigma=0.7),
)


def sample_kinds(rng: np.random.Generator, kinds: Sequence[JobKind],
                 n: int) -> np.ndarray:
    w = np.asarray([max(k.weight, 0.0) for k in kinds])
    if w.sum() <= 0:
        raise ValueError("kind weights sum to zero")
    return rng.choice(len(kinds), size=n, p=w / w.sum())


def zipf_users(rng: np.random.Generator, n: int, n_users: int,
               s: float = 1.1) -> np.ndarray:
    """User indices with a Zipf-ish popularity profile — a few heavy
    submitters dominate, matching OSG accounting data."""
    ranks = np.arange(1, n_users + 1, dtype=np.float64)
    p = ranks ** (-s)
    return rng.choice(n_users, size=n, p=p / p.sum())


# ---------------------------------------------------------------------------
# Campaign composition
# ---------------------------------------------------------------------------

def synthesize(
    n_jobs: int,
    duration_s: float = DAY_S,
    *,
    seed: int = 0,
    kinds: Sequence[JobKind] = OSG_KINDS,
    profile: Callable | None = None,
    n_users: int = 24,
    burst_frac: float = 0.25,
    n_bursts: int = 8,
    burst_width_s: float = 600.0,
    name: str = "synthetic",
) -> Trace:
    """Compose a campaign: profile-modulated base arrivals with a sampled
    kind/user mix, plus `burst_frac` of jobs delivered as correlated
    user bursts (one user, one kind, one tight arrival cluster each —
    the pattern that stresses cohort-granular provisioning).  Fully
    determined by `seed`."""
    if n_jobs <= 0:
        raise ValueError(f"n_jobs must be positive, got {n_jobs}")
    rng = np.random.default_rng(seed)
    n_burst_total = int(n_jobs * burst_frac) if n_bursts > 0 else 0
    n_base = n_jobs - n_burst_total

    rows: list[tuple[float, int, str]] = []   # (arrival, kind idx, user)

    base_t = arrival_times(rng, n_base, duration_s, profile)
    base_kind = sample_kinds(rng, kinds, n_base)
    base_user = zipf_users(rng, n_base, n_users)
    rows.extend(
        (float(t), int(k), f"user{u:02d}")
        for t, k, u in zip(base_t, base_kind, base_user))

    if n_burst_total > 0:
        sizes = rng.multinomial(
            n_burst_total, np.full(n_bursts, 1.0 / n_bursts))
        centers = arrival_times(rng, n_bursts, duration_s, profile)
        for b, (size, center) in enumerate(zip(sizes, centers)):
            if size <= 0:
                continue
            kind = int(sample_kinds(rng, kinds, 1)[0])
            user = f"user{int(rng.integers(0, n_users)):02d}"
            ts = np.clip(
                center + burst_width_s * rng.standard_normal(size),
                0.0, max(duration_s - 1e-3, 0.0))
            rows.extend((float(t), kind, user) for t in ts)

    rows.sort(key=lambda r: r[0])
    order_kinds = np.asarray([r[1] for r in rows])

    # per-kind runtime sampling in one vectorized draw each, scattered
    # back in arrival order (keeps the stream deterministic AND cheap)
    runtimes = np.empty(len(rows))
    for ki, kind in enumerate(kinds):
        idx = np.nonzero(order_kinds == ki)[0]
        if len(idx):
            runtimes[idx] = kind.sample_runtimes(rng, len(idx))

    records = []
    for (t, ki, user), rt in zip(rows, runtimes):
        kind = kinds[ki]
        records.append(TraceRecord(
            arrival_s=round(t, 3),
            runtime_s=round(float(rt), 3),
            cpus=kind.cpus,
            gpus=kind.gpus,
            memory_gb=kind.memory_gb,
            disk_gb=kind.disk_gb,
            requirements=kind.requirements,
            group=kind.name,
            user=user,
            attrs=dict(kind.attrs),
        ))

    meta = {
        "name": name,
        "seed": seed,
        "n_jobs": n_jobs,
        "duration_s": duration_s,
        "kinds": [k.name for k in kinds],
        "n_users": n_users,
        "burst_frac": burst_frac,
        "n_bursts": n_bursts,
    }
    return Trace.from_records(records, meta=meta)


def diurnal_day(n_jobs: int, *, seed: int = 0,
                duration_s: float = DAY_S, amplitude: float = 0.6,
                **kw) -> Trace:
    """An OSG-shaped day: diurnal arrivals, OSG kind mix, user bursts."""
    return synthesize(n_jobs, duration_s, seed=seed,
                      profile=diurnal_profile(amplitude=amplitude),
                      name="diurnal", **kw)


def uniform_burst(n_jobs: int, *, seed: int = 0, runtime_s: float = 600.0,
                  at_s: float = 0.0, cpus: int = 1,
                  gpus: int = 0) -> Trace:
    """The repo's old hand-rolled scenario as a trace: every job
    identical, all at once — the single-cohort baseline."""
    del seed  # deterministic by construction; kept for a uniform API
    kind_name = f"burst-{cpus}c{gpus}g"
    records = [TraceRecord(arrival_s=at_s, runtime_s=runtime_s, cpus=cpus,
                           gpus=gpus, memory_gb=4.0, group=kind_name)
               for _ in range(n_jobs)]
    return Trace.from_records(
        records, meta={"name": "uniform_burst", "n_jobs": n_jobs,
                       "runtime_s": runtime_s})


PRESETS: dict[str, Callable[..., Trace]] = {
    "diurnal": diurnal_day,
    "poisson": lambda n_jobs, **kw: synthesize(
        n_jobs, profile=None, name="poisson", **kw),
    "uniform-burst": lambda n_jobs, **kw: uniform_burst(
        n_jobs, **{k: v for k, v in kw.items() if k in ("seed",)}),
}


def generate_preset(preset: str, n_jobs: int, *, seed: int = 0,
                    duration_s: float = DAY_S) -> Trace:
    try:
        builder = PRESETS[preset]
    except KeyError:
        raise ValueError(f"unknown preset {preset!r}; "
                         f"known: {sorted(PRESETS)}") from None
    # each preset lambda keeps only the kwargs it understands
    # (uniform-burst has no duration: every arrival is at t=0)
    return builder(n_jobs, seed=seed, duration_s=duration_s)
