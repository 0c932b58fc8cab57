"""Reference matchmaker: the legacy vectorized-NumPy negotiation core.

This is the claiming loop that lived inline in
`Collector._match_cohorts` (PR 3), made pure: per cohort a vectorized
fits row over the worker free matrix, then the seed's first-match walk
handing each worker ``min(fits, remaining)`` jobs in index order.  Every
other backend is differentially tested against this one.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.matchmaker.base import (
    MatchPlan, MatchProblem, cohort_fits,
)


class NumpyMatchmaker:
    """The reference implementation (`make_matchmaker("numpy")`)."""

    name = "numpy"

    def match(self, p: MatchProblem, *, budget: int | None = None,
              active: np.ndarray | None = None) -> MatchPlan:
        free = np.array(p.free, dtype=np.float64, copy=True)
        C, W = p.compat.shape
        takes = np.zeros((C, W), dtype=np.int64)
        left = math.inf if budget is None else int(budget)
        for c in p.order:
            if left <= 0:
                break
            if active is not None and not active[c]:
                continue
            d = int(p.demand[c])
            if d <= 0:
                continue
            d = min(d, left) if left != math.inf else d
            want = p.requests[c]
            fits = cohort_fits(free, want, d)
            if not fits.any():      # the legacy drained-pool fast path
                continue
            crow = p.compat[c]
            row = takes[c]
            remaining = d
            for wi in range(W):
                if remaining <= 0:
                    break
                k = int(fits[wi])
                if k <= 0 or not crow[wi]:
                    continue
                t = k if k < remaining else remaining
                row[wi] = t
                free[wi] -= want * t
                remaining -= t
            left -= d - remaining
        return MatchPlan(takes=takes, free_after=free)
