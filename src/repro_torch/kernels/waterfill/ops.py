"""Water-fill entry points: the Hopper kernel for CUDA tensors, the plain
PyTorch versions for CPU tensors.

They take the matchmaker's chunked layout -- the (nch, 64, R) cohort rows
and (R, Wp) free matrices the JAX package's scans and Pallas kernel
consume, with R = 6 left at its natural width (no TPU sublane pad) --
and share one CUDA source, `waterfill.cu`:

  * `waterfill`: one negotiation cycle, the JAX package's `waterfill`
    contract; `waterfill_solve` is the same launch returning `Solved`;
  * `waterfill_cycles`: K cycles in one launch, the staged deltas
    (arrivals, returned capacity, budgets) applied on the device;
  * `waterfill_preview`: N independent candidates in one launch, a block
    each, only what each cohort absorbs coming back.

`route` picks the instance of a one-cycle call from shape and dtype:
``"staged"`` (tiles staged ahead into shared memory, the free carry in
registers, fits by a checked multiply; up to 8,192 lanes) or
``"rounds"`` (PR 11's kernel, for wider problems).  The cycle and
candidate entry points run on "staged" only.  The staged instance writes
the takes rows of the chunks that ran, and nothing else (`Solved`);
`dense_takes` spreads them over every chunk.  On a CUDA tensor each
entry point launches the kernel or raises; on a CPU tensor, and only
there, it runs the plain version from `ref.py`.
``launch_counts["waterfill"]`` moves by one per launch of any entry
point, `route_counts` by instance and `kind_counts` by entry point.

The CUDA source is built at first use by `repro_torch.kernels.build`
(nvcc into ``build/repro_torch/``, bound with ctypes, no PyTorch
headers).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.core.matchmaker.base import FIT_EPS
from repro_torch.kernels.build import build_library, launch_counts
from repro_torch.kernels.waterfill.ref import (
    reciprocals, waterfill_cycles_reference, waterfill_preview_reference,
    waterfill_reference,
)

SOURCE = Path(__file__).with_name("waterfill.cu")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

R = 6                                 # resources: the kernel's compile-time width
CHUNK = 64                            # cohorts per drain-guard chunk
H100_SMEM = 232_448                   # a block's opt-in shared memory on the H100
_DTYPES = {torch.float64: 0, torch.float32: 1}
_WARP_TOTALS_BYTES = 2 * 32 * 8       # the rounds kernel's static shared memory
#: the staged instances, as waterfill.cu's WATERFILL_STAGED_INSTANCES
#: lists them: (lanes a thread, resources kept in registers, most threads)
_STAGED = {torch.float64: ((1, 6, 512), (2, 6, 512), (4, 6, 512),
                           (8, 3, 512), (16, 2, 384), (16, 3, 512)),
           torch.float32: ((1, 6, 512), (2, 6, 512), (4, 6, 512),
                           (8, 6, 512), (16, 4, 512))}
_SUBS = (64, 32, 16, 8, 4, 2)         # cohorts a tile, largest first
_CARRY_OFFSET = 1088                  # the staged kernel's shared header
_MODES = {"single": 0, "cycles": 1, "preview": 2}
_FITS = {"divide": 0, "reciprocal": 1, "probe": 2}
#: how the staged instance decides fits (PERF.md, PR 18: the divide probe)
FIT = "reciprocal"

#: launches by instance and by entry point, beside launch_counts["waterfill"]
route_counts = {"staged": 0, "rounds": 0}
kind_counts = {"single": 0, "cycles": 0, "preview": 0}

_lib: ctypes.CDLL | None = None
#: the opt-in dynamic shared-memory limit of each device set up so far
_max_smem: dict[int, int] = {}
#: nvcc's output (ptxas register and shared-memory report) of the build
#: this process loaded, or None before the first build.
build_log: str | None = None


class Plan(NamedTuple):
    """A staged launch's shape: lanes a thread, resources whose carry
    stays in registers, threads, cohorts a tile, dynamic shared memory."""
    lanes: int
    rreg: int
    threads: int
    sub: int
    smem: int


@functools.lru_cache(maxsize=None)
def staged_plan(dtype: torch.dtype, Wp: int,
                max_smem: int = H100_SMEM) -> Plan | None:
    """The staged instance's plan for Wp worker lanes, or None where it
    does not take them: the fewest lanes a thread whose thread count its
    instance allows, then the largest tile whose two stages fit beside
    the shared part of the carry.  Mirrors the kernel's shared-memory
    layout (header, carry, two stages of 4 row arrays and compat rows)."""
    if dtype not in _STAGED or Wp <= 0 or Wp % 32:
        return None
    item = 8 if dtype == torch.float64 else 4
    for lanes, rreg, most in _STAGED[dtype]:
        threads = -(-(-(-Wp // lanes)) // 32) * 32
        if threads > most:
            continue
        fixed = _CARRY_OFFSET + (R - rreg) * lanes * threads * item
        for sub in _SUBS:
            smem = fixed + 2 * (4 * sub * R * item + sub * Wp)
            if smem <= max_smem:
                return Plan(lanes, rreg, threads, sub, smem)
        return None
    return None


class Solved(NamedTuple):
    """One launch's outputs.  ``free``, ``totals`` and ``ran`` are views
    of ``packed``, one byte buffer, so `to_host` brings them back in one
    copy; ``takes`` stay where they are: (K * nch, 64, Wp) int32 holding
    the n-th chunk that ran (in cycle, then chunk order: ``ran``'s
    nonzeros) at [n], nothing else written (`dense_takes`)."""
    takes: torch.Tensor | None     # int32; None: preview
    free: torch.Tensor | None      # (K, R, Wp) free after each cycle
    totals: torch.Tensor           # (K or N, nch, 64) int32 taken a cohort
    ran: torch.Tensor | None       # (K, nch) bool: chunks the guard ran
    packed: torch.Tensor           # uint8: free, totals, ran back to back

    def to_host(self) -> "Solved":
        host = self.packed.cpu()
        return Solved(self.takes,
                      *_carve(host, _parts(self.free, self.totals, self.ran)),
                      host)


def dense_takes(out: Solved) -> torch.Tensor:
    """``out``'s takes as (K, nch, 64, Wp): the rows of each chunk that
    ran, zeros for every chunk the guard skipped.  A gather on the takes'
    device; nothing waits for the kernel."""
    K, nch = out.ran.shape
    ran = out.ran.to(out.takes.device).reshape(-1)
    slot = (torch.cumsum(ran, 0) - 1).clamp_(min=0)
    rows = out.takes.index_select(0, slot)
    return torch.where(ran[:, None, None], rows, 0).view(
        K, nch, CHUNK, out.takes.shape[-1])


def _parts(free, totals, ran):
    return [None if t is None else (tuple(t.shape), t.dtype)
            for t in (free, totals, ran)]


def _carve(buf: torch.Tensor, parts) -> list:
    out, off = [], 0
    for part in parts:
        if part is None:
            out.append(None)
            continue
        shape, dtype = part
        n = math.prod(shape) * dtype.itemsize
        out.append(buf[off:off + n].view(dtype).view(shape))
        off += -(-n // 16) * 16
    return out


def _packed(device, free_shape, dtype, totals_shape, ran_shape) -> Solved:
    parts = [None if free_shape is None else (free_shape, dtype),
             (totals_shape, torch.int32),
             None if ran_shape is None else (ran_shape, torch.bool)]
    n = sum(-(-math.prod(p[0]) * p[1].itemsize // 16) * 16
            for p in parts if p is not None)
    buf = torch.empty(n, dtype=torch.uint8, device=device)
    return Solved(None, *_carve(buf, parts), buf)


def build() -> Path:
    """Compile `waterfill.cu` unless this source and these flags were
    built before; returns the shared library's path."""
    global build_log
    out, log = build_library(SOURCE, NVCC_FLAGS)
    if log is not None:
        build_log = log
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.waterfill_launch.argtypes = [
            i, i, vp, d, vp, vp, vp, vp, vp, vp, vp, vp, vp,
            i, i, i, i, i, d, vp]
        lib.waterfill_launch.restype = i
        lib.waterfill_staged_launch.argtypes = (
            [i] * 6 + [vp] * 17 + [d, d] + [i] * 7 + [vp])
        lib.waterfill_staged_launch.restype = i
        lib.waterfill_init.argtypes = [i]
        lib.waterfill_init.restype = i
        lib.waterfill_step_floor.argtypes = [i, i, i, i, vp, vp]
        lib.waterfill_step_floor.restype = i
        lib.waterfill_error_string.argtypes = [i]
        lib.waterfill_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _device_smem(lib: ctypes.CDLL, index: int) -> int:
    """The device's opt-in shared-memory limit; the first call per device
    also lets every kernel use all of it."""
    if index not in _max_smem:
        got = lib.waterfill_init(index)
        if got < 0:
            raise RuntimeError("waterfill kernel set-up failed: "
                               + lib.waterfill_error_string(-got).decode())
        _max_smem[index] = got
    return _max_smem[index]


def warm(device: torch.device) -> None:
    """Builds the library and sets ``device`` up for it, launching
    nothing."""
    _device_smem(_library(), device.index)


def _check(name: str, t: torch.Tensor, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"waterfill: {name} must be {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"waterfill: {name} must have shape {tuple(shape)},"
                         f" got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"waterfill: {name} is on {t.device}, "
                         f"expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"waterfill: {name} must be contiguous")


def _check_cohorts(want, safe, big, crow, inv, dt, dev):
    """Raises on cohort rows the kernel does not take (``inv`` given, or
    made here from ``safe``); returns nch, Wp."""
    if dev.type != "cuda":
        raise ValueError(f"waterfill: no kernel for device {dev}")
    if dt not in _DTYPES:
        raise TypeError(f"waterfill: float64 or float32 only, got {dt}")
    nch, chunk, r = want.shape
    Wp = crow.shape[-1]
    if r != R:
        raise ValueError(f"waterfill: the kernel is built for R = {R} "
                         f"resources, got {r}")
    if chunk != CHUNK:
        raise ValueError(f"waterfill: chunks of {CHUNK} cohorts only, "
                         f"got {chunk}")
    for name, t in (("want", want), ("safe", safe), ("big", big),
                    ("inv", inv)):
        _check(name, t, dt, (nch, chunk, R), dev)
    _check("crow", crow, torch.uint8, (nch, chunk, Wp), dev)
    if Wp % 32:       # whole warps: the scans shuffle across all 32 lanes
        raise ValueError(f"waterfill: Wp must be a multiple of 32, got {Wp}")
    return nch, Wp


def _check_aligned(*staged: torch.Tensor | None) -> None:
    if any(t is not None and t.data_ptr() % 16 for t in staged):
        raise ValueError("waterfill: the staged instance's bulk copies need "
                         "want, safe, big, inv and crow 16-byte aligned")


def route(freeT: torch.Tensor, want: torch.Tensor, safe: torch.Tensor,
          big: torch.Tensor, crow: torch.Tensor,
          inv: torch.Tensor | None = None) -> str:
    """The instance a one-cycle CUDA launch takes: ``"staged"`` when the
    staged instance has a plan at this dtype and width (up to 8,192
    lanes), ``"rounds"`` otherwise.  Raises where the arrays "staged"
    copies in bulk are not 16-byte aligned (a view into another tensor;
    the matchmaker's feed aligns every array to 128 bytes)."""
    if staged_plan(freeT.dtype, crow.shape[-1]) is None:
        return "rounds"
    _check_aligned(want, safe, big, crow, inv)
    return "staged"


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch_staged(lib, mode: str, fit: str, dev, dt, Wp: int, nch: int, *,
                   free_in, want, safe, big, inv, crow, demand, totals,
                   chunk_min=None, arrivals=None, free_add=None,
                   add_free=None, budgets=None, takes=None, ran=None,
                   free_out=None, scratch=None, left=math.inf, K=1, N=1):
    plan = staged_plan(dt, Wp, _device_smem(lib, dev.index))
    if plan is None:
        raise ValueError(f"waterfill: the staged instance takes no "
                         f"{dt} problem {Wp} lanes wide")
    _check_aligned(want, safe, big, crow, inv)
    err = lib.waterfill_staged_launch(
        dev.index, _DTYPES[dt], plan.lanes, plan.rreg, _MODES[mode],
        _FITS[fit], _ptr(free_in), _ptr(want), _ptr(safe), _ptr(big),
        _ptr(inv), _ptr(crow), _ptr(demand), _ptr(chunk_min), _ptr(arrivals),
        _ptr(free_add), _ptr(add_free), _ptr(budgets), _ptr(takes),
        _ptr(ran), _ptr(totals), _ptr(free_out), _ptr(scratch),
        float(left), FIT_EPS, K, N, Wp, nch, plan.sub, plan.threads,
        plan.smem, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("waterfill kernel launch failed: "
                           + lib.waterfill_error_string(err).decode())


def _count(instance: str, kind: str) -> None:
    launch_counts["waterfill"] += 1
    route_counts[instance] += 1
    kind_counts[kind] += 1


def _reciprocals(safe, inv):
    return reciprocals(safe) if inv is None else inv


def _solve(freeT, left, want, safe, big, demand, crow, chunk_min, inv,
           instance, fit, counted) -> Solved:
    dev, dt = freeT.device, freeT.dtype
    nch, Wp = _check_cohorts(want, safe, big, crow, inv, dt, dev)
    _check("freeT", freeT, dt, (R, Wp), dev)
    _check("demand", demand, dt, (nch, CHUNK), dev)
    _check("chunk_min", chunk_min, dt, (nch, R), dev)
    lib = _library()
    takes = torch.empty((nch, CHUNK, Wp), dtype=torch.int32, device=dev)
    out = _packed(dev, (1, R, Wp), dt, (1, nch, CHUNK), (1, nch))
    if instance == "staged":
        _launch_staged(lib, "single", fit, dev, dt, Wp, nch, free_in=freeT,
                       want=want, safe=safe, big=big, inv=inv, crow=crow,
                       demand=demand, chunk_min=chunk_min, takes=takes,
                       ran=out.ran, totals=out.totals, free_out=out.free,
                       left=left)
    else:
        dense = torch.empty_like(takes)     # zeroed by PR 11's memset
        ran = torch.empty(nch, dtype=torch.int32, device=dev)
        smem = R * Wp * freeT.element_size()
        in_smem = smem + _WARP_TOTALS_BYTES <= _device_smem(lib, dev.index)
        err = lib.waterfill_launch(
            dev.index, _DTYPES[dt], freeT.data_ptr(), float(left),
            want.data_ptr(), safe.data_ptr(), big.data_ptr(),
            demand.data_ptr(), crow.data_ptr(), chunk_min.data_ptr(),
            dense.data_ptr(), ran.data_ptr(), out.free.data_ptr(), R, Wp,
            nch, CHUNK, int(in_smem), FIT_EPS,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError("waterfill kernel launch failed: "
                               + lib.waterfill_error_string(err).decode())
        # PR 11's kernel writes neither totals nor u8 flags, and dense
        # takes: more kernels on this route only (the chunks that ran
        # first, in order, as the staged instance lays them out)
        out.ran[0].copy_(ran)
        torch.sum(dense, dim=-1, dtype=torch.int32, out=out.totals[0])
        first = torch.argsort((ran == 0).to(torch.int32), stable=True)
        torch.index_select(dense, 0, first, out=takes)
    if counted:
        _count(instance, "single")
    return out._replace(takes=takes)


def waterfill_solve(
    freeT: torch.Tensor,       # (R, Wp)
    left: float,               # claim budget (may be inf)
    want: torch.Tensor,        # (nch, 64, R)
    safe: torch.Tensor,        # (nch, 64, R)
    big: torch.Tensor,         # (nch, 64, R)
    demand: torch.Tensor,      # (nch, 64)
    crow: torch.Tensor,        # (nch, 64, Wp) uint8
    chunk_min: torch.Tensor,   # (nch, R)
    inv: torch.Tensor | None = None,   # (nch, 64, R): ref.reciprocals(safe)
) -> Solved:
    """One cycle, outputs as `Solved` with K = 1 (takes: only the rows of
    the chunks that ran).  The staged instance decides most fits from
    ``inv`` by a multiply (`ref.reciprocal_fits`: the same bits as the
    divide); made here from ``safe`` when not given.  The CPU branch runs
    every chunk (the plain version has no drain guard; a chunk the guard
    would skip takes nothing either way), so its ``ran`` is all True."""
    nch, chunk, r = want.shape
    Wp = crow.shape[-1]
    if freeT.device.type not in ("cpu", "cuda"):
        raise ValueError(f"waterfill: no kernel for device {freeT.device}")
    if freeT.device.type == "cpu":
        takes, free_after = waterfill_reference(
            freeT.T, want.reshape(nch * chunk, r),
            demand.reshape(nch * chunk), crow.reshape(nch * chunk, Wp),
            budget=left)
        out = _packed(freeT.device, (1, r, Wp), freeT.dtype, (1, nch, chunk),
                      (1, nch))
        out.free[0] = free_after.T
        out.totals[0] = takes.sum(dim=1).reshape(nch, chunk)
        out.ran.fill_(True)
        return out._replace(takes=takes.reshape(nch, chunk, Wp))
    inv = _reciprocals(safe, inv)
    instance = route(freeT, want, safe, big, crow, inv)
    return _solve(freeT, left, want, safe, big, demand, crow, chunk_min, inv,
                  instance, FIT, True)


def waterfill(freeT, left, want, safe, big, demand, crow, chunk_min,
              inv=None):
    """Returns (takes (nch, 64, Wp) int32, freeT_after (R, Wp), ran (nch,)
    bool) on the inputs' device -- the JAX package's `waterfill`
    contract: `waterfill_solve`, its takes spread by `dense_takes`."""
    out = waterfill_solve(freeT, left, want, safe, big, demand, crow,
                          chunk_min, inv)
    return dense_takes(out)[0], out.free[0], out.ran[0]


def _waterfill_instance(instance: str, freeT, left, want, safe, big, demand,
                        crow, chunk_min, inv=None, *,
                        fit: str = FIT) -> Solved:
    """`waterfill_solve` on CUDA tensors through ``instance``
    (``"staged"`` or ``"rounds"``) and, on "staged", ``fit``
    (``"divide"``: every lane divides, or ``"reciprocal"``), rather than
    what `route` and `FIT` pick: to time one against the other (the port
    itself calls `waterfill_solve`).  Counted like its launches."""
    if instance not in route_counts or fit not in ("divide", "reciprocal"):
        raise ValueError(f"waterfill: no instance {instance!r} / {fit!r}")
    inv = _reciprocals(safe, inv)
    if instance == "staged" and route(freeT, want, safe, big, crow,
                                      inv) != "staged":
        raise ValueError("waterfill: the staged instance does not take "
                         "this call")
    return _solve(freeT, left, want, safe, big, demand, crow, chunk_min, inv,
                  instance, fit, True)


def divide_probe(freeT, left, want, safe, big, demand, crow, chunk_min,
                 inv) -> Solved:
    """Launches the divide probe on the current stream: the staged
    instance with every fit taken from the unchecked product ``free *
    (1/safe)`` -- no divide anywhere.  Its time beside the divide's says
    what the divides cost a step.  A measurement aid: its takes may
    differ from the water-fill's, and it is not counted in
    `launch_counts`."""
    if route(freeT, want, safe, big, crow, inv) != "staged":
        raise ValueError("divide_probe: the staged instance does not take "
                         "this call")
    return _solve(freeT, left, want, safe, big, demand, crow, chunk_min, inv,
                  "staged", "probe", False)


def waterfill_cycles(
    freeT: torch.Tensor,       # (R, Wp) free before the first cycle
    demand: torch.Tensor,      # (nch, 64) demand before the first cycle
    arrivals: torch.Tensor,    # (K, nch, 64) demand added before each
    free_add: torch.Tensor,    # (K, R, Wp) capacity returned before each
    add_free: torch.Tensor,    # (K,) bool: cycle k adds free_add[k]
    budgets: torch.Tensor,     # (K,) each cycle's claim budget (inf: none)
    want: torch.Tensor,        # (nch, 64, R)
    safe: torch.Tensor,
    big: torch.Tensor,
    crow: torch.Tensor,        # (nch, 64, Wp) uint8
    inv: torch.Tensor | None = None,
) -> Solved:
    """K negotiation cycles in one launch on the staged instance: per
    cycle the deltas applied, the drain guard's chunk minima recomputed
    from the live demand, the budget reset, the chunks run, and takes
    (the rows of the chunks that ran), ran, the free snapshot and each
    cohort's total written; the live demand then loses the totals.
    `ref.waterfill_cycles_reference` on CPU tensors (``ran`` all True
    there)."""
    nch, chunk, r = want.shape
    Wp = crow.shape[-1]
    K = arrivals.shape[0]
    if freeT.device.type == "cpu":
        takes, frees, totals = waterfill_cycles_reference(
            freeT.T, want.reshape(-1, r), demand.reshape(-1),
            arrivals.reshape(K, -1), free_add.transpose(1, 2), add_free,
            budgets, crow.reshape(-1, Wp))
        out = _packed(freeT.device, (K, r, Wp), freeT.dtype, (K, nch, chunk),
                      (K, nch))
        out.free.copy_(frees.transpose(1, 2))
        out.totals.copy_(totals.reshape(K, nch, chunk))
        out.ran.fill_(True)
        return out._replace(takes=takes.reshape(K * nch, chunk, Wp))
    dev, dt = freeT.device, freeT.dtype
    inv = _reciprocals(safe, inv)
    nch, Wp = _check_cohorts(want, safe, big, crow, inv, dt, dev)
    _check("freeT", freeT, dt, (R, Wp), dev)
    _check("demand", demand, dt, (nch, CHUNK), dev)
    _check("arrivals", arrivals, dt, (K, nch, CHUNK), dev)
    _check("free_add", free_add, dt, (K, R, Wp), dev)
    _check("add_free", add_free, torch.bool, (K,), dev)
    _check("budgets", budgets, dt, (K,), dev)
    lib = _library()
    takes = torch.empty((K * nch, CHUNK, Wp), dtype=torch.int32, device=dev)
    out = _packed(dev, (K, R, Wp), dt, (K, nch, CHUNK), (K, nch))
    scratch = torch.empty(nch * CHUNK + nch * R, dtype=dt, device=dev)
    _launch_staged(lib, "cycles", FIT, dev, dt, Wp, nch, free_in=freeT,
                   want=want, safe=safe, big=big, inv=inv, crow=crow,
                   demand=demand, arrivals=arrivals, free_add=free_add,
                   add_free=add_free, budgets=budgets, takes=takes,
                   ran=out.ran, totals=out.totals, free_out=out.free,
                   scratch=scratch, K=K)
    _count("staged", "cycles")
    return out._replace(takes=takes)


def waterfill_preview(
    frees: torch.Tensor,       # (N, R, Wp) candidate free matrices
    demands: torch.Tensor,     # (N, nch, 64) candidate demands
    want: torch.Tensor,        # (nch, 64, R)
    safe: torch.Tensor,
    big: torch.Tensor,
    crow: torch.Tensor,        # (nch, 64, Wp) uint8
    inv: torch.Tensor | None = None,
) -> Solved:
    """N independent one-cycle water-fills (no budget) against shared
    cohort rows, in one launch on the staged instance, a block each;
    only ``totals`` (N, nch, 64), what each cohort absorbs, is written.
    `ref.waterfill_preview_reference` on CPU tensors."""
    nch, chunk, r = want.shape
    Wp = crow.shape[-1]
    N = frees.shape[0]
    if frees.device.type == "cpu":
        totals = waterfill_preview_reference(
            frees.transpose(1, 2), demands.reshape(N, -1),
            want.reshape(-1, r), crow.reshape(-1, Wp))
        out = _packed(frees.device, None, frees.dtype, (N, nch, chunk), None)
        out.totals.copy_(totals.reshape(N, nch, chunk))
        return out
    dev, dt = frees.device, frees.dtype
    inv = _reciprocals(safe, inv)
    nch, Wp = _check_cohorts(want, safe, big, crow, inv, dt, dev)
    _check("frees", frees, dt, (N, R, Wp), dev)
    _check("demands", demands, dt, (N, nch, CHUNK), dev)
    lib = _library()
    out = _packed(dev, None, dt, (N, nch, CHUNK), None)
    scratch = torch.empty(N * nch * R, dtype=dt, device=dev)
    _launch_staged(lib, "preview", FIT, dev, dt, Wp, nch, free_in=frees,
                   want=want, safe=safe, big=big, inv=inv, crow=crow,
                   demand=demands, totals=out.totals, scratch=scratch, N=N)
    _count("staged", "preview")
    return out


def step_floor(steps: int, threads: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Launches the step-floor probe on the current stream: ``steps``
    rounds of the water-fill's cohort step with only its scans and
    barrier left, in one block of ``threads`` threads.  Its time is the
    floor the serial chain of cohort steps puts under the water-fill.  A
    measurement aid: it is not the water-fill and is not counted in
    `launch_counts`."""
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"step_floor: threads must be a multiple of 32 "
                         f"in [32, 1024], got {threads}")
    lib = _library()
    out = torch.empty(1, dtype=dtype, device=device)
    err = lib.waterfill_step_floor(
        out.device.index, _DTYPES[dtype], steps, threads, out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError("step-floor probe launch failed: "
                           + lib.waterfill_error_string(err).decode())
    return out


__all__ = ["waterfill", "waterfill_solve", "waterfill_cycles",
           "waterfill_preview", "waterfill_reference", "reciprocals",
           "route", "route_counts", "kind_counts", "staged_plan", "Solved",
           "dense_takes",
           "build", "warm", "launch_counts", "step_floor", "divide_probe"]
