"""PyTorch matchmaker: the single-cycle water-fill on a hand-written
Hopper kernel (`make_matchmaker("torch")`).

Host plumbing is the JAX package's, kept in NumPy exactly as it is there
(`JaxMatchmaker._prep`/`match`): cohorts permuted into processing order
and padded to whole chunks of 64 (pad cohorts have demand 0), workers
padded to 128-lane multiples (pad workers have zero free capacity),
zero-request resources given the ``_ZERO_WANT_BIG`` ratio offset, the
compat mask shipped as uint8, and the drain guard's per-chunk
componentwise-minimum live request computed here.  The resource axis
stays at its natural width R=6.

The solve itself is `kernels.waterfill.waterfill`: the CUDA kernel when
the matchmaker's device is a GPU, the plain PyTorch version when the
caller asked for ``device="cpu"``.  There is no silent fallback: with no
GPU, the default device raises.

dtype: ``float64`` (default) is bit-identical to the NumPy backend.
Against the JAX backend it is bitwise on integer-valued problems and
within atol 1e-7 on fractional ones, because XLA:CPU contracts
``free - want * take`` into a fused multiply-add under jit.  ``float32``
is exact only while resource quantities and the
per-cohort fit sums stay integer-valued below 2**24, as in the JAX
package.

`match_cycles` and `preview_many` are not defined: the Collector routes
them through `sequential_match_cycles`/`sequential_preview_many`, which
call `match` once per cycle or candidate and are exact by construction.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.matchmaker.base import MatchPlan, MatchProblem
from repro_torch.kernels.waterfill import ops as waterfill_ops

_ZERO_WANT_BIG = 1e15     # ratio offset for zero-request resource lanes
_CHUNK = 64               # cohorts per drain-guard chunk
_W_LANES = 128            # worker-axis padding bucket
_DTYPES = {"float64": torch.float64, "float32": torch.float32}


class TorchMatchmaker:
    """The PyTorch/CUDA backend (`make_matchmaker("torch")`)."""

    name = "torch"

    def __init__(self, *, dtype: str = "float64",
                 device: str | torch.device | None = None):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be float64|float32, got {dtype!r}")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "matchmaker='torch' runs its water-fill kernel on a CUDA "
                "device and none is available; pass device='cpu' to run "
                "the plain PyTorch version on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {dev}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.dtype = dtype
        self.chunk = _CHUNK
        self.device = dev
        # padding-bucket telemetry, read by the cycle profiler and the
        # metric registry (`last_call`, `_seen_buckets`): the first call
        # on a bucket is flagged `compiled`, as the JAX backend flags a
        # fresh trace; here nothing is traced, but the bucket count still
        # says how many distinct shapes the pool went through
        self._seen_buckets: set[tuple] = set()
        self.last_call: dict | None = None

    def _prep(self, p: MatchProblem, active=None):
        """Order-permuted, padded host arrays (pad cohorts have demand 0
        and pad workers have zero free capacity -- both take nothing)."""
        C, W = p.compat.shape
        R = p.requests.shape[1]
        chunk = self.chunk
        Cp = max(chunk, ((C + chunk - 1) // chunk) * chunk)
        Wp = max(_W_LANES, ((W + _W_LANES - 1) // _W_LANES) * _W_LANES)
        order = np.concatenate(
            [np.asarray(p.order, dtype=np.int64),
             np.arange(C, Cp, dtype=np.int64)])
        req_o = np.zeros((Cp, R))
        req_o[:C] = p.requests[order[:C]]
        d_o = np.zeros(Cp)
        d_o[:C] = p.demand[order[:C]]
        if active is not None:
            d_o[:C] *= active[order[:C]]
        crow_o = np.zeros((Cp, Wp), dtype=np.uint8)
        crow_o[:C, :W] = p.compat[order[:C]]
        freeT = np.zeros((R, Wp))
        freeT[:, :W] = p.free.T
        pos = req_o > 0
        safe = np.where(pos, req_o, 1.0)
        big = np.where(pos, 0.0, _ZERO_WANT_BIG)
        return order, req_o, d_o, crow_o, freeT, safe, big, Cp, Wp

    def kernel_inputs(self, p: MatchProblem, *, budget: int | None = None,
                      active: np.ndarray | None = None):
        """The water-fill's arguments for one `match` call, as tensors on
        this matchmaker's device: a dict for
        `kernels.waterfill.waterfill(**args)`, and the padded cohort
        processing order that maps its rows back to ``p``'s cohorts."""
        R = p.requests.shape[1]
        chunk = self.chunk
        (order, req_o, d_o, crow_o, freeT, safe, big,
         Cp, Wp) = self._prep(p, active)
        # per-chunk componentwise-min request among demanding cohorts
        # (the drain guard's lower bound; inf where a chunk is empty)
        req_live = np.where((d_o > 0)[:, None], req_o, np.inf)
        chunk_min = req_live.reshape(-1, chunk, R).min(axis=1)
        nch = Cp // chunk
        dev, dt = self.device, _DTYPES[self.dtype]

        def put(a, *shape):
            return torch.from_numpy(
                np.ascontiguousarray(a).reshape(shape)).to(dev, dt)

        args = {
            "freeT": put(freeT, R, Wp),
            "left": math.inf if budget is None else float(budget),
            "want": put(req_o, nch, chunk, R),
            "safe": put(safe, nch, chunk, R),
            "big": put(big, nch, chunk, R),
            "demand": put(d_o, nch, chunk),
            "crow": torch.from_numpy(crow_o.reshape(nch, chunk, Wp)).to(dev),
            "chunk_min": put(chunk_min, nch, R),
        }
        return args, order

    def match(self, p: MatchProblem, *, budget: int | None = None,
              active: np.ndarray | None = None) -> MatchPlan:
        C, W = p.compat.shape
        chunk = self.chunk
        args, order = self.kernel_inputs(p, budget=budget, active=active)
        nch, Wp = args["crow"].shape[0], args["crow"].shape[2]
        bucket = (nch, Wp, self.dtype)
        self.last_call = {"kind": "match", "bucket": bucket,
                          "compiled": bucket not in self._seen_buckets}
        self._seen_buckets.add(bucket)
        takes_t, freeT_t, ran_t = waterfill_ops.waterfill(**args)
        ran = ran_t.cpu().numpy()

        # scatter back to original cohort rows -- only chunks that ran
        # (skipped chunks are all-zero by construction), and only those
        # rows and the real worker columns leave the device
        takes = np.zeros((nch * chunk, W), dtype=np.int64)
        live_chunks = np.nonzero(ran)[0]
        if live_chunks.size:
            idx = torch.from_numpy(live_chunks).to(takes_t.device)
            rows = takes_t.index_select(0, idx)[:, :, :W].cpu().numpy()
            live = (live_chunks[:, None] * chunk
                    + np.arange(chunk)[None, :]).reshape(-1)
            takes[order[live]] = rows.reshape(-1, W)
        free_after = freeT_t[:, :W].T.to(torch.float64).cpu().numpy()
        return MatchPlan(takes=takes[:C], free_after=free_after.copy())
