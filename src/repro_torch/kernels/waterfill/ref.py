"""Plain PyTorch water-fill: the oracle the Hopper kernel must reproduce
bit-for-bit in float64.

Semantics (the seed negotiator's greedy first-match walk, closed form):
cohorts are visited in the given row order; per cohort the per-worker
fit count is ``floor(min_r free_r/want_r + FIT_EPS)`` over the cohort's
request vector (zero-request resources never constrain), masked by
compat, capped at the cohort's remaining demand, and allocated greedily
worker-by-worker via the exclusive prefix sum.  An optional claim
budget caps the total takes across the whole cycle.

Deliberately UNCHUNKED and unguarded (no drain skip, no padding), so it
stays an independent check on the kernel rather than a re-statement of
it.  Every step is its own tensor op (``free - want*take`` is a multiply
then a subtract, never ``addcmul``) and nothing here may run under
``torch.compile``: a fused multiply-subtract rounds once where the
reference rounds twice, which changes ``free_after`` for fractional
requests.

`reciprocal_fits` mirrors how the kernel decides most fits without a
divide (``free * (1/safe)``, checked against a margin, divided only
where the check cannot decide); ``waterfill_reference(...,
reciprocal=True)`` runs the water-fill on it, and must equal the
divide.  `waterfill_cycles_reference` and `waterfill_preview_reference`
are the K-cycle and N-candidate loops the kernel runs in one launch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.matchmaker.base import FIT_EPS

_ZERO_WANT_BIG = 1e15     # ratio offset for zero-request resource lanes

# The reciprocal test's margin, relative and absolute, and the range of
# safe whose reciprocal the bound covers (a normal number with a normal
# reciprocal).  |free * RN(1/safe) - RN(free/safe)| is at most
# (3u + u^2)|free/safe| with u = 2^-53 (2^-24 in float32), plus a few
# subnormal steps; the margins are 4x and far above those.
RECIP_REL = {torch.float64: 2.0 ** -49, torch.float32: 2.0 ** -20}
RECIP_ABS = {torch.float64: 2.0 ** -1000, torch.float32: 2.0 ** -120}
RECIP_RANGE = {torch.float64: 2.0 ** 1000, torch.float32: 2.0 ** 120}


def reciprocals(safe):
    """``1 / safe`` where safe lies in [2^-1000, 2^1000] (float32: 2^-120,
    2^120), NaN elsewhere: a NaN product sends the lane to the divide.
    The kernel's reciprocal path reads exactly this array.  Takes a
    tensor or a NumPy array (IEEE division rounds alike in both)."""
    if isinstance(safe, np.ndarray):
        lim = RECIP_RANGE[torch.from_numpy(safe[:0]).dtype]
        ok = (safe >= 1.0 / lim) & (safe <= lim)
        with np.errstate(divide="ignore"):
            inv = safe.dtype.type(1.0) / safe
        return np.where(ok, inv, safe.dtype.type(math.nan))
    lim = RECIP_RANGE[safe.dtype]
    ok = (safe >= 1.0 / lim) & (safe <= lim)
    return torch.where(ok, 1.0 / safe, torch.full_like(safe, math.nan))


def reciprocal_fits(freeT, safe, big, inv, d, crow):
    """One cohort's fits on every worker lane, decided as the kernel's
    reciprocal path decides them: ``m = min_r(free_r * inv_r + big_r)``,
    then ``floor(x + FIT_EPS)`` clipped to [0, d] at x = m - delta and at
    x = m + delta, delta = |m| * RECIP_REL + RECIP_ABS.  The divide's m
    lies in that interval (each product is within 3 ulps of its
    quotient, and the min of perturbed values moves no further than the
    perturbation), and floor(RN(x + eps)) is monotone in x, so equal ends
    are the answer; where they differ, or a product is not finite, the
    lane divides.  Returns (fits (W,), fell back (W,) bool); fits equal
    the divide's bit for bit."""
    dt = freeT.dtype
    zero = torch.zeros((), dtype=dt, device=freeT.device)
    on = crow != 0
    q = freeT * inv[:, None]
    bad = ~(q.abs() <= torch.finfo(dt).max).all(dim=0)
    m = (q + big[:, None]).min(dim=0).values
    delta = m.abs() * RECIP_REL[dt] + RECIP_ABS[dt]

    def clip(x):
        return torch.minimum(torch.maximum(x, zero), d)

    lo = clip(torch.floor((m - delta) + FIT_EPS))
    hi = clip(torch.floor((m + delta) + FIT_EPS))
    fell = on & (bad | (lo != hi))
    exact = clip(torch.floor(
        (freeT / safe[:, None] + big[:, None]).min(dim=0).values + FIT_EPS))
    fits = torch.where(fell, exact, lo)
    return torch.where(on, fits, zero), fell


def waterfill_reference(
    free: torch.Tensor,       # (W, R) free capacity per worker
    requests: torch.Tensor,   # (C, R) per-job request vector per cohort
    demand: torch.Tensor,     # (C,)   idle jobs per cohort
    compat: torch.Tensor,     # (C, W) 0/1 requirements mask
    budget: float = math.inf,
    *,
    reciprocal: bool = False,
):
    """Returns (takes (C, W) int32, free_after (W, R)), on the inputs'
    device and in ``free``'s dtype.  ``reciprocal=True`` decides the fits
    by `reciprocal_fits` (the kernel's way) instead of dividing."""
    dt, dev = free.dtype, free.device
    C, W = compat.shape
    freeT = free.T                                   # (R, W)
    requests = requests.to(dt)
    pos = requests > 0
    safe = torch.where(pos, requests, torch.ones((), dtype=dt, device=dev))
    big = torch.where(pos, torch.zeros((), dtype=dt, device=dev),
                      torch.full((), _ZERO_WANT_BIG, dtype=dt, device=dev))
    inv = reciprocals(safe) if reciprocal else None
    crow = compat.to(dt)
    demand = demand.to(dt)
    left = torch.full((), budget, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    takes = torch.zeros((C, W), dtype=torch.int32, device=dev)
    for c in range(C):
        d = torch.minimum(demand[c], left)
        if reciprocal:
            fits, _fell = reciprocal_fits(freeT, safe[c], big[c], inv[c], d,
                                          crow[c])
        else:
            ratio = freeT / safe[c][:, None] + big[c][:, None]
            fits = torch.maximum(
                torch.floor(ratio.min(dim=0).values + FIT_EPS), zero)
            fits = torch.minimum(fits, d) * crow[c]
        cum = torch.cumsum(fits, dim=0)
        take = torch.minimum(torch.maximum(d - (cum - fits), zero), fits)
        freeT = freeT - requests[c][:, None] * take[None, :]
        left = left - take.sum()
        takes[c] = torch.round(take).to(torch.int32)
    return takes, freeT.T


def waterfill_cycles_reference(
    free: torch.Tensor,       # (W, R) free capacity before the first cycle
    requests: torch.Tensor,   # (C, R)
    demand: torch.Tensor,     # (C,) demand before the first cycle
    arrivals: torch.Tensor,   # (K, C) demand added before each cycle
    free_add: torch.Tensor,   # (K, W, R) capacity returned before each
    add_free: torch.Tensor,   # (K,) bool: cycle k adds free_add[k]
    budgets: torch.Tensor,    # (K,) each cycle's claim budget (inf: none)
    compat: torch.Tensor,     # (C, W)
):
    """K cycles, each one `waterfill_reference` on the carried state: per
    cycle ``demand += arrivals[k]``, ``free += free_add[k]`` where
    ``add_free[k]``, solve, then ``demand -= takes.sum(1)`` and ``free =
    free_after`` -- `base.sequential_match_cycles` in tensors.  Returns
    (takes (K, C, W) int32, free_after (K, W, R), totals (K, C) int32)."""
    demand = demand.to(free.dtype)
    takes, frees, totals = [], [], []
    for k in range(arrivals.shape[0]):
        demand = demand + arrivals[k].to(free.dtype)
        if bool(add_free[k]):
            free = free + free_add[k]
        t, free = waterfill_reference(free, requests, demand, compat,
                                      budget=float(budgets[k]))
        per = t.sum(dim=1)
        demand = demand - per.to(free.dtype)
        takes.append(t)
        frees.append(free)
        totals.append(per.to(torch.int32))
    return torch.stack(takes), torch.stack(frees), torch.stack(totals)


def waterfill_preview_reference(
    frees: torch.Tensor,      # (N, W, R) candidate free matrices
    demands: torch.Tensor,    # (N, C) candidate demands
    requests: torch.Tensor,   # (C, R)
    compat: torch.Tensor,     # (C, W)
):
    """N independent one-cycle water-fills, no budget; returns what each
    candidate absorbs per cohort, (N, C) int32 --
    `base.sequential_preview_many` in tensors."""
    return torch.stack([
        waterfill_reference(frees[i], requests, demands[i], compat)[0]
        .sum(dim=1).to(torch.int32) for i in range(frees.shape[0])])
