"""PyTorch matchmaker: the water-fill on a hand-written Hopper kernel
(`make_matchmaker("torch")`), one launch per call of each kind -- one
cycle (`match`), K fused cycles (`match_cycles`), N candidate previews
(`preview_many`).

Host plumbing is the JAX package's, kept in NumPy exactly as it is there
(`JaxMatchmaker._prep`, `match`, `match_cycles`, `preview_many`):
cohorts permuted into processing order and padded to whole chunks of 64
(pad cohorts have demand 0), workers padded to 128-lane multiples (pad
workers have zero free capacity; previews use a power-of-two bucket of
at least 512 lanes), zero-request resources given the ``_ZERO_WANT_BIG``
ratio offset, the compat mask shipped as uint8, and the drain guard's
per-chunk componentwise-minimum live request computed here for `match`
(on the device for the other two).  The resource axis stays at its
natural width R=6.  Beside them ships ``1/safe`` (`ref.reciprocals`),
from which the kernel decides most fits by a multiply.

One feed a call: a call's arrays are packed into one reused pinned host
buffer and sent with one non-blocking host-to-device copy; the kernel's
arguments are views of the device buffer they land in.  The host buffer
is written again only once that copy has completed.  What comes back:
the free matrices, per-cohort totals and ran flags in one
device-to-host copy, and the takes rows of the chunks that ran in a
second, made only when a chunk ran.  `preview_many` keeps the last
problem's cohort rows on the device (a one-entry session keyed on the
caller's token, the shape and the order), so that a hit ships only free
and demand.

The solve itself is `kernels.waterfill`: the CUDA kernel when the
matchmaker's device is a GPU, the plain PyTorch versions when the
caller asked for ``device="cpu"``.  There is no silent fallback: with no
GPU, the default device raises.  Problems wider than the kernel's staged
instance takes (above 8,192 lanes) run `match_cycles` and `preview_many`
as `sequential_match_cycles`/`sequential_preview_many`.

dtype: ``float64`` (default) is bit-identical to the NumPy backend.
Against the JAX backend it is bitwise on integer-valued problems and
within atol 1e-7 on fractional ones, because XLA:CPU contracts
``free - want * take`` into a fused multiply-add under jit.  ``float32``
is exact only while resource quantities and the
per-cohort fit sums stay integer-valued below 2**24, as in the JAX
package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.matchmaker.base import (
    CycleDelta, MatchPlan, MatchProblem, sequential_match_cycles,
    sequential_preview_many,
)
from repro_torch.kernels.waterfill import ops as waterfill_ops
from repro_torch.kernels.waterfill.ref import reciprocals

_ZERO_WANT_BIG = 1e15     # ratio offset for zero-request resource lanes
_CHUNK = 64               # cohorts per drain-guard chunk
_W_LANES = 128            # worker-axis padding bucket
_PREVIEW_LANES = 512      # preview lane floor
_ALIGN = 128              # bytes between arrays in a feed
_DTYPES = {"float64": torch.float64, "float32": torch.float32}
_NUMPY = {torch.float64: np.float64, torch.float32: np.float32,
          torch.uint8: np.uint8, torch.bool: np.bool_}


class _Feed:
    """Ships a call's host arrays to the device in one copy: packed into
    one pinned host buffer (reused, grown as needed), copied without
    blocking into one device buffer, handed out as views."""

    def __init__(self, device: torch.device):
        self.device = device
        self._host: torch.Tensor | None = None
        self._dev: torch.Tensor | None = None
        self._copied: torch.cuda.Event | None = None

    def ship(self, arrays, *, keep: bool = False) -> dict:
        """``arrays``: (name, ndarray, torch dtype) triples.  Returns the
        views by name.  ``keep=True`` lands them in a fresh device buffer
        the caller may hold; otherwise in the reused one, which the next
        call overwrites."""
        layout, total = [], 0
        for name, a, dt in arrays:
            layout.append((name, total, a, dt))
            total += -(-a.size * dt.itemsize // _ALIGN) * _ALIGN
        total = max(total, _ALIGN)
        if self.device.type == "cpu":
            buf = torch.empty(total, dtype=torch.uint8)
            self._fill(buf, layout)
            return self._views(buf, layout)
        if self._copied is not None:
            self._copied.synchronize()      # the last copy read the buffer
        if self._host is None or self._host.numel() < total:
            self._host = torch.empty(2 * total, dtype=torch.uint8,
                                     pin_memory=True)
        host = self._host[:total]
        self._fill(host, layout)
        if keep:
            dev = torch.empty(total, dtype=torch.uint8, device=self.device)
        else:
            if self._dev is None or self._dev.numel() < total:
                self._dev = torch.empty(2 * total, dtype=torch.uint8,
                                        device=self.device)
            dev = self._dev[:total]
        dev.copy_(host, non_blocking=True)
        if self._copied is None:
            self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(self.device))
        return self._views(dev, layout)

    @staticmethod
    def _fill(buf: torch.Tensor, layout) -> None:
        raw = buf.numpy()
        for _name, off, a, dt in layout:
            n = a.size * dt.itemsize
            raw[off:off + n].view(_NUMPY[dt]).reshape(a.shape)[...] = a

    @staticmethod
    def _views(buf: torch.Tensor, layout) -> dict:
        # one view of the whole buffer per element type, then a slice and
        # a shape per array (offsets are multiples of _ALIGN bytes)
        typed: dict = {}
        out = {}
        for name, off, a, dt in layout:
            if dt not in typed:
                typed[dt] = buf.view(dt)
            i = off // dt.itemsize
            out[name] = typed[dt][i:i + a.size].view(a.shape)
        return out


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
        self._feed = _Feed(dev)
        # one-entry preview session: the last previewed problem's cohort
        # rows on the device, validated on (caller token, shape, order);
        # demand is never cached (it changes within a session)
        self._preview_session: dict | None = None
        # padding-bucket telemetry, read by the cycle profiler and the
        # metric registry (`last_call`, `_seen_buckets`): the first call
        # on a bucket is flagged `compiled`, as the JAX backend flags a
        # fresh trace; here nothing is traced, but the bucket count still
        # says how many distinct shapes the pool went through
        self._seen_buckets: set[tuple] = set()
        self.last_call: dict | None = None

    @property
    def _dt(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def _note_call(self, kind: str, bucket: tuple):
        compiled = bucket not in self._seen_buckets
        self._seen_buckets.add(bucket)
        self.last_call = {"kind": kind, "bucket": bucket,
                          "compiled": compiled}

    def warm_preview(self):
        """On cuda, builds the kernel library and sets the device up for
        it (launching nothing), so that the first preview pays neither;
        on the CPU there is nothing to warm."""
        if self.device.type == "cuda":
            waterfill_ops.warm(self.device)

    def _staged(self, Wp: int) -> bool:
        """Does the kernel's staged instance take Wp lanes (the cycle and
        candidate entry points run on it only)?  Always on the CPU."""
        return (self.device.type == "cpu"
                or waterfill_ops.staged_plan(self._dt, Wp) is not None)

    def _prep(self, p: MatchProblem, active=None, *, lanes=None):
        """Order-permuted, padded host arrays (pad cohorts have demand 0
        and pad workers have zero free capacity -- both take nothing).
        ``lanes`` widens the worker padding beyond the 128-lane
        granularity (the preview bucket)."""
        C, W = p.compat.shape
        R = p.requests.shape[1]
        chunk = self.chunk
        Cp = max(chunk, ((C + chunk - 1) // chunk) * chunk)
        Wp = max(_W_LANES, ((W + _W_LANES - 1) // _W_LANES) * _W_LANES)
        if lanes is not None:
            Wp = max(Wp, int(lanes))
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

    def _cohort_arrays(self, req_o, safe, big, crow_o, Cp, Wp):
        """The cohort rows every entry point stages, in the chunked
        layout, with ``1/safe`` as the kernel's reciprocal path reads it."""
        dt, chunk = self._dt, self.chunk
        R = req_o.shape[1]
        nch = Cp // chunk
        inv = reciprocals(safe.astype(_NUMPY[dt]))
        return [("want", req_o.reshape(nch, chunk, R), dt),
                ("safe", safe.reshape(nch, chunk, R), dt),
                ("big", big.reshape(nch, chunk, R), dt),
                ("inv", inv.reshape(nch, chunk, R), dt),
                ("crow", crow_o.reshape(nch, chunk, Wp), torch.uint8)]

    def _match_arrays(self, p: MatchProblem, active=None):
        """`match`'s host half: the padded arrays to ship, and the padded
        processing order that maps kernel rows back to ``p``'s cohorts."""
        R = p.requests.shape[1]
        chunk, dt = self.chunk, self._dt
        (order, req_o, d_o, crow_o, freeT, safe, big,
         Cp, Wp) = self._prep(p, active)
        # per-chunk componentwise-min request among demanding cohorts
        # (the drain guard's lower bound; inf where a chunk is empty)
        req_live = np.where((d_o > 0)[:, None], req_o, np.inf)
        chunk_min = req_live.reshape(-1, chunk, R).min(axis=1)
        nch = Cp // chunk
        arrays = [("freeT", freeT, dt),
                  *self._cohort_arrays(req_o, safe, big, crow_o, Cp, Wp),
                  ("demand", d_o.reshape(nch, chunk), dt),
                  ("chunk_min", chunk_min, dt)]
        return arrays, order

    def kernel_inputs(self, p: MatchProblem, *, budget: int | None = None,
                      active: np.ndarray | None = None):
        """The water-fill's arguments for one `match` call, as tensors on
        this matchmaker's device (views of one buffer of their own,
        shipped in one copy): a dict for
        `kernels.waterfill.waterfill(**args)`, and the padded cohort
        processing order that maps its rows back to ``p``'s cohorts."""
        arrays, order = self._match_arrays(p, active)
        args = self._feed.ship(arrays, keep=True)
        args["left"] = math.inf if budget is None else float(budget)
        return args, order

    def _plans(self, out: waterfill_ops.Solved, order, C: int,
               W: int) -> list[MatchPlan]:
        """The plans of a solve whose free, totals and ran are on the
        host: the takes rows of the chunks that ran come over in one
        copy, and each cohort's row is gathered from them (the chunks the
        guard skipped take nothing)."""
        chunk = self.chunk
        ran = out.ran.numpy()
        K, nch = ran.shape
        live = np.flatnonzero(ran.reshape(-1))
        rows = None
        if live.size:
            rows = out.takes[:live.size].cpu().numpy().reshape(
                live.size * chunk, -1)
        free = out.free.to(torch.float64).numpy()
        pos = np.empty(C, dtype=np.int64)      # cohort -> padded position
        pos[order[:C]] = np.arange(C)
        plans = []
        for k in range(K):
            slot = np.full(nch, -1, dtype=np.int64)
            ran_k = np.flatnonzero(ran[k])
            slot[ran_k] = np.searchsorted(live, k * nch + ran_k)
            at = slot[pos // chunk] * chunk + pos % chunk
            if ran_k.size == nch:
                takes = rows[at, :W].astype(np.int64)
            else:
                takes = np.zeros((C, W), dtype=np.int64)
                ok = at >= 0
                if ok.any():
                    takes[ok] = rows[at[ok], :W]
            plans.append(MatchPlan(takes=takes,
                                   free_after=free[k][:, :W].T.copy()))
        return plans

    def match(self, p: MatchProblem, *, budget: int | None = None,
              active: np.ndarray | None = None) -> MatchPlan:
        C, W = p.compat.shape
        arrays, order = self._match_arrays(p, active)
        args = self._feed.ship(arrays)
        args["left"] = math.inf if budget is None else float(budget)
        nch, _chunk, Wp = args["crow"].shape
        self._note_call("match", (nch, Wp, self.dtype))
        out = waterfill_ops.waterfill_solve(**args).to_host()
        return self._plans(out, order, C, W)[0]

    def _cycles_arrays(self, p: MatchProblem, deltas: list[CycleDelta]):
        """`match_cycles`' host half: the arrays to ship (the deltas
        permuted and padded like the problem, ``add_free`` marking the
        cycles that return capacity), the order, and Wp."""
        C, W = p.compat.shape
        R = p.requests.shape[1]
        chunk, dt = self.chunk, self._dt
        (order, req_o, d_o, crow_o, freeT, safe, big,
         Cp, Wp) = self._prep(p)
        nch = Cp // chunk
        K = len(deltas)
        arrivals = np.zeros((K, Cp))
        free_add = np.zeros((K, R, Wp))
        add_free = np.zeros(K, dtype=bool)
        budgets = np.empty(K)
        for k, d in enumerate(deltas):
            arrivals[k, :C] = np.asarray(d.arrivals, dtype=np.float64)[
                order[:C]]
            if d.free_add is not None:
                free_add[k, :, :W] = np.asarray(d.free_add).T
                add_free[k] = True
            budgets[k] = math.inf if d.budget is None else float(d.budget)
        arrays = [
            ("freeT", freeT, dt), ("demand", d_o.reshape(nch, chunk), dt),
            ("arrivals", arrivals.reshape(K, nch, chunk), dt),
            ("free_add", free_add, dt), ("add_free", add_free, torch.bool),
            ("budgets", budgets, dt),
            *self._cohort_arrays(req_o, safe, big, crow_o, Cp, Wp)]
        return arrays, order, Wp

    def cycles_inputs(self, p: MatchProblem, deltas: list[CycleDelta]):
        """`kernels.waterfill.waterfill_cycles`' arguments for one
        `match_cycles` call, as tensors on this matchmaker's device (views
        of one buffer of their own), and the padded cohort order."""
        arrays, order, _Wp = self._cycles_arrays(p, deltas)
        return self._feed.ship(arrays, keep=True), order

    def match_cycles(self, p: MatchProblem,
                     deltas: list[CycleDelta]) -> list[MatchPlan]:
        """K fused negotiation cycles in ONE kernel launch -- see
        `base.sequential_match_cycles` for the semantics this reproduces
        bit for bit.  The free matrix and the live demand stay on the
        device between cycles; only the staged deltas ship down and only
        the K plans come back."""
        if not deltas:
            return []
        C, W = p.compat.shape
        arrays, order, Wp = self._cycles_arrays(p, deltas)
        if not self._staged(Wp):
            return sequential_match_cycles(self, p, deltas)
        args = self._feed.ship(arrays)
        nch = args["demand"].shape[0]
        self._note_call("match_cycles", (nch, Wp, len(deltas), self.dtype))
        out = waterfill_ops.waterfill_cycles(**args).to_host()
        return self._plans(out, order, C, W)

    def _preview_rows(self, p: MatchProblem, session):
        """The cohort rows of a preview on the device, from the session
        when it holds this problem's (same token, shape and order), else
        shipped now (and kept as the session when a token is given).
        Returns (rows by name, order, Cp, Wp), or None where the preview
        bucket is wider than the kernel's staged instance takes."""
        C, W = p.compat.shape
        R = p.requests.shape[1]
        order_key = np.asarray(p.order, dtype=np.int64).tobytes()
        sess = self._preview_session
        if (session is not None and sess is not None
                and sess["token"] == session
                and sess["shape"] == (C, W, R)
                and sess["order"] == order_key):
            return sess["consts"], sess["order_arr"], *sess["pad"]
        # power-of-two lane bucket with a 512-lane floor, as the JAX
        # backend pads (pad workers have zero free and take nothing); the
        # 128-lane pad where the bucket is wider than the kernel's staged
        # instance takes
        lanes = max(_PREVIEW_LANES, 1 << max(0, W - 1).bit_length())
        if not self._staged(lanes):
            lanes = None
        (order, req_o, _d_o, crow_o, _freeT, safe, big,
         Cp, Wp) = self._prep(p, lanes=lanes)
        if not self._staged(Wp):
            self._preview_session = None
            return None
        consts = self._feed.ship(
            self._cohort_arrays(req_o, safe, big, crow_o, Cp, Wp), keep=True)
        self._preview_session = None if session is None else {
            "token": session, "shape": (C, W, R), "order": order_key,
            "order_arr": order, "pad": (Cp, Wp), "consts": consts,
        }
        return consts, order, Cp, Wp

    def _preview_arrays(self, p: MatchProblem, frees, demands, order,
                        Cp: int, Wp: int):
        """The candidates' stacked free matrices and demands to ship."""
        C, W = p.compat.shape
        R = p.requests.shape[1]
        N, chunk, dt = len(frees), self.chunk, self._dt
        dd = np.zeros((N, Cp))
        for i in range(N):
            dv = p.demand if demands is None else demands[i]
            dd[i, :C] = np.asarray(dv, dtype=np.float64)[order[:C]]
        fstack = np.zeros((N, R, Wp))
        for i, f in enumerate(frees):
            fstack[i, :, :W] = np.asarray(f, dtype=np.float64).T
        return [("frees", fstack, dt),
                ("demands", dd.reshape(N, Cp // chunk, chunk), dt)]

    def preview_inputs(self, p: MatchProblem, frees: list,
                       demands: list | None = None, *, session=None):
        """`kernels.waterfill.waterfill_preview`'s arguments for one
        `preview_many` call, as tensors on this matchmaker's device, and
        the padded cohort order."""
        consts, order, Cp, Wp = self._preview_rows(p, session)
        args = self._feed.ship(
            self._preview_arrays(p, frees, demands, order, Cp, Wp),
            keep=True)
        return {**args, **consts}, order

    def preview_many(self, p: MatchProblem, frees: list,
                     demands: list | None = None, *,
                     session=None) -> list[np.ndarray]:
        """N independent candidate previews in ONE kernel launch -- see
        `base.sequential_preview_many` for the semantics this reproduces
        bit for bit.  ``session`` is an opaque hashable token naming the
        problem STRUCTURE (cohort keys + worker shapes): consecutive
        calls with the same token, shape and cohort order reuse the
        device-resident cohort rows and ship only the stacked free
        matrices and demand vectors."""
        N = len(frees)
        if N == 0:
            return []
        C = p.compat.shape[0]
        rows = self._preview_rows(p, session)
        if rows is None:
            return sequential_preview_many(self, p, frees, demands)
        consts, order, Cp, Wp = rows
        self._note_call("preview", (Cp // self.chunk, Wp, N, self.dtype))
        var = self._feed.ship(
            self._preview_arrays(p, frees, demands, order, Cp, Wp))
        out = waterfill_ops.waterfill_preview(
            var["frees"], var["demands"], **consts).to_host()
        flat = out.totals.reshape(N, Cp).numpy()
        result: list[np.ndarray] = []
        for i in range(N):
            res = np.zeros(C, dtype=np.int64)
            res[order[:C]] = flat[i, :C]
            result.append(res)
        return result
