"""Differential oracle: the seed's per-job O(jobs × workers) scan.

`Collector.negotiate_scan` kept the seed's tick-era loop as the
baseline; this backend is that loop behind the `Matchmaker` interface,
operating on the pure problem arrays.  Jobs are visited one at a time
in global FIFO order (``problem.scan_order``), each claiming the first
candidate worker whose live free capacity covers the request
(``want <= free`` exactly, matching `classad.symmetric_match`'s
quantity sanity — the scan's arithmetic never divides).  A worker drops
off the candidate list once any declared countable resource
(cpus/gpus/chips) is exhausted, exactly as the seed did.

Useful as the ground truth in differential tests — never as the fast
path (it is the O(jobs × workers) baseline the vectorized backends are
measured against).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.matchmaker.base import (
    EXHAUSTIBLE_IDX, MatchPlan, MatchProblem,
)


class ScanMatchmaker:
    """The per-job FIFO oracle (`make_matchmaker("scan")`)."""

    name = "scan"

    def match(self, p: MatchProblem, *, budget: int | None = None,
              active: np.ndarray | None = None) -> MatchPlan:
        free = np.array(p.free, dtype=np.float64, copy=True)
        C, W = p.compat.shape
        takes = np.zeros((C, W), dtype=np.int64)
        if p.scan_order is not None:
            scan_order = p.scan_order
        else:
            # no per-job submit order provided: jobs of each cohort are
            # contiguous at the cohort's place in the processing order
            scan_order = np.repeat(p.order, p.demand[p.order])
        left = math.inf if budget is None else int(budget)
        # candidate workers in advertisement (index) order; a worker is
        # retired once any declared countable resource hits zero
        alive = [wi for wi in range(W)]
        given = np.zeros(C, dtype=np.int64)
        for c in scan_order:
            if left <= 0 or not alive:
                break
            if active is not None and not active[c]:
                continue
            if given[c] >= p.demand[c]:
                continue
            want = p.requests[c]
            matched = -1
            for wi in alive:
                if not p.compat[c, wi]:
                    continue
                if np.any(want > free[wi]):
                    continue
                matched = wi
                break
            if matched < 0:
                continue
            takes[c, matched] += 1
            given[c] += 1
            left -= 1
            free[matched] -= want
            exhausted = any(
                free[matched, r] <= 0
                for r in EXHAUSTIBLE_IDX if p.capacity[matched, r]
            )
            if exhausted:
                alive.remove(matched)
        return MatchPlan(takes=takes, free_after=free)
