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
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.matchmaker.base import FIT_EPS

_ZERO_WANT_BIG = 1e15     # ratio offset for zero-request resource lanes


def waterfill_reference(
    free: torch.Tensor,       # (W, R) free capacity per worker
    requests: torch.Tensor,   # (C, R) per-job request vector per cohort
    demand: torch.Tensor,     # (C,)   idle jobs per cohort
    compat: torch.Tensor,     # (C, W) 0/1 requirements mask
    budget: float = math.inf,
):
    """Returns (takes (C, W) int32, free_after (W, R)), on the inputs'
    device and in ``free``'s dtype."""
    dt, dev = free.dtype, free.device
    C, W = compat.shape
    freeT = free.T                                   # (R, W)
    requests = requests.to(dt)
    pos = requests > 0
    safe = torch.where(pos, requests, torch.ones((), dtype=dt, device=dev))
    big = torch.where(pos, torch.zeros((), dtype=dt, device=dev),
                      torch.full((), _ZERO_WANT_BIG, dtype=dt, device=dev))
    crow = compat.to(dt)
    demand = demand.to(dt)
    left = torch.full((), budget, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    takes = torch.zeros((C, W), dtype=torch.int32, device=dev)
    for c in range(C):
        d = torch.minimum(demand[c], left)
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
