"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package.  Phases, in
order; any failure raises and exits non-zero (nothing is caught):

  1. the card: name and power limit as nvidia-smi reports them;
  2. build the water-fill kernel from the checkout's CUDA source;
  3. the kernel against its plain PyTorch version on the card, on the
     matchmaking tiers (10k/100k/1m jobs), a fractional-request problem,
     a finite budget with an `active` mask, a drained pool, worker
     counts 129/1000/1500/6000 (one and several lanes per thread, free
     carry in shared and in device memory) and float32: takes equal and
     free_after bitwise; the matchmaker's plan against the NumPy
     backend's: takes equal, free_after within 1e-7.  Kernel time is
     the median of CUDA-event timings, printed beside its bytes/operations
     bound and beside the time of the step-floor probe (the kernel's
     scan-and-barrier skeleton alone, one step per cohort it works on);
  4. end to end: `run_policy` over the 10k-job diurnal day on the
     standard 3-provider federation with ``[provision] matchmaker=torch``
     against the same run on the NumPy backend (equal jobs, pods, cost
     and Fig 2/3 series, every job completed), then a 2k-job 3-schedd
     fair-share day the same way.  The kernel's launch count is read
     from each run;
  5. a JSON line per kernel, the card line, and the result line.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
R = 6
TIERS = {
    "10k": dict(jobs=10_000, C=512, W=128),
    "100k": dict(jobs=100_000, C=4_096, W=512),
    "1m": dict(jobs=1_000_000, C=16_384, W=1_024),
}
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the FP64 rate outside
# the tensor cores (the water-fill's divides and compares are vector ops)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12
KERNEL_REPS = 20


def build_problem(MatchProblem, jobs: int, C: int, W: int, seed: int = 0):
    """The matchmaking benchmark's paper-regime problem: heterogeneous
    1-4 cpu / 0-1 gpu requests, cohort-compressed backlog, a pool that
    drains mid-cycle."""
    rng = np.random.default_rng(seed)
    requests = np.zeros((C, R))
    requests[:, 0] = rng.integers(1, 5, size=C)           # cpus
    requests[:, 1] = rng.integers(0, 2, size=C)           # gpus
    requests[:, 2] = rng.integers(1, 9, size=C)           # memory GB
    demand = np.full(C, jobs // C, dtype=np.int64)
    demand[: jobs % C] += 1
    free = np.zeros((W, R))
    free[:, 0] = rng.integers(8, 65, size=W)
    free[:, 1] = rng.integers(0, 9, size=W)
    free[:, 2] = rng.integers(32, 257, size=W)
    compat = rng.random((C, W)) < 0.9
    return MatchProblem(
        keys=[(0, c) for c in range(C)], requests=requests,
        demand=demand, order=rng.permutation(C).astype(np.int64),
        free=free, capacity=free.copy(),
        compat=np.asarray(compat, dtype=bool))


def fractional_problem(MatchProblem, C: int, W: int, seed: int):
    """Fractional cpu and memory requests (7.6/0.4-style ratios), sparse
    compat, a random processing order."""
    rng = np.random.default_rng(seed)
    requests = np.zeros((C, R))
    requests[:, 0] = rng.integers(1, 5, size=C) + rng.choice(
        [0.0, 0.25, 0.5], size=C)
    requests[:, 1] = rng.integers(0, 3, size=C)
    requests[:, 2] = rng.integers(0, 9, size=C) * 0.4
    free = np.zeros((W, R))
    free[:, 0] = rng.integers(1, 17, size=W)
    free[:, 1] = rng.integers(0, 9, size=W)
    free[:, 2] = rng.integers(0, 65, size=W) * 0.4
    return MatchProblem(
        keys=[(0, c) for c in range(C)], requests=requests,
        demand=rng.integers(1, 60, size=C).astype(np.int64),
        order=rng.permutation(C).astype(np.int64), free=free,
        capacity=free.copy(), compat=rng.random((C, W)) < 0.8)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (after one warm
    run), each bracketed by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(view), b.contiguous().view(view))


def kernel_bound(C: int, W: int, args, takes, ran):
    """Least time the card could take for this call's work, counting only
    what this run's data needs: the real W x R free values in and out,
    demand for the real cohorts of the chunks that ran, the request row
    and u8 compat row of those among them that could take anything
    (d = min(demand, left) > 0: cohorts masked out, padding and cohorts
    after the budget ran out take nothing), and the real C x W i32 takes
    out.  Padding and the host-derived safe, big and chunk_min arrays are
    left out.  Against that, the live cohorts' per-lane arithmetic (R
    divides, adds and multiply-subtracts, the min/floor/clip chain, one
    scan add: about 4R + 8 operations) over the vector rate.  Returns
    (bound ms, what bounds it, bytes, operations, live cohorts)."""
    nch, chunk, r = args["want"].shape
    item = args["freeT"].element_size()
    rows = torch.arange(nch * chunk, device=takes.device)
    real_ran = ran[:, None].expand(nch, chunk).reshape(-1) & (rows < C)
    taken = takes.reshape(nch * chunk, -1).sum(1, dtype=torch.float64)
    left_before = args["left"] - (taken.cumsum(0) - taken)
    live = real_ran & (args["demand"].reshape(-1) > 0) & (left_before > 0)
    n_real, n_live = int(real_ran.sum().item()), int(live.sum().item())
    nbytes = (2 * W * r * item                       # free in + out
              + n_real * item                        # demand
              + n_live * (r * item + W)              # want, u8 compat
              + C * W * 4)                           # i32 takes out
    ops = n_live * W * (4 * r + 8)
    rate = FP64_OPS_PER_S if item == 8 else FP32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes", nbytes, ops, n_live
    return 1e3 * t_ops, "operations", nbytes, ops, n_live


def check_case(label, p, mm, ref_mm, ops, waterfill_reference, *,
               budget=None, active=None, plain_reps=1):
    """Kernel vs plain version on the card (takes exact, free bitwise),
    then the matchmaker's plan vs the NumPy backend's; returns timings."""
    args, _order = mm.kernel_inputs(p, budget=budget, active=active)
    nch, chunk, r = args["want"].shape
    Wp = args["crow"].shape[2]
    takes_k, free_k, ran = ops.waterfill(**args)

    def plain():
        return waterfill_reference(
            args["freeT"].T, args["want"].reshape(nch * chunk, r),
            args["demand"].reshape(nch * chunk),
            args["crow"].reshape(nch * chunk, Wp), budget=args["left"])

    takes_p, free_p = plain()
    torch.cuda.synchronize()
    if not torch.equal(takes_k.reshape(nch * chunk, Wp), takes_p):
        bad = (takes_k.reshape(nch * chunk, Wp) != takes_p).sum().item()
        raise AssertionError(f"{label}: kernel takes differ from the plain "
                             f"version in {bad} cells")
    if not bitwise_equal(free_k, free_p.T):
        raise AssertionError(f"{label}: kernel free_after is not bitwise "
                             f"equal to the plain version's")
    max_abs_err = float((free_k - free_p.T).abs().max().item())

    kw = {"budget": budget, "active": active}
    plan, plan_np = mm.match(p, **kw), ref_mm.match(p, **kw)
    if not np.array_equal(plan.takes, plan_np.takes):
        raise AssertionError(f"{label}: matchmaker takes differ from the "
                             f"numpy backend's")
    if not np.allclose(plan.free_after, plan_np.free_after, rtol=0,
                       atol=1e-7):
        raise AssertionError(f"{label}: matchmaker free_after differs from "
                             f"the numpy backend's beyond 1e-7")

    ms = cuda_ms(lambda: ops.waterfill(**args), KERNEL_REPS)
    plain_ms = cuda_ms(plain, plain_reps)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        mm.match(p, **kw)
        walls.append(time.perf_counter() - t0)
    bound_ms, bound_by, nbytes, nops, n_live = kernel_bound(
        p.n_cohorts, p.n_workers, args, takes_k, ran)
    # the floor of the serial chain: the kernel's scan-and-barrier skeleton
    # alone, one step per live cohort and lane round, at its block size
    threads = min(Wp, 1024)
    steps = n_live * -(-Wp // threads)
    dt, dev = args["freeT"].dtype, args["freeT"].device
    floor_ms = cuda_ms(lambda: ops.step_floor(steps, threads, dt, dev),
                       KERNEL_REPS)
    empty_ms = cuda_ms(lambda: ops.step_floor(0, threads, dt, dev),
                       KERNEL_REPS)
    row = {"case": label, "C": p.n_cohorts, "W": p.n_workers,
           "nch": nch, "Wp": Wp, "dtype": mm.dtype,
           "ran_chunks": int(ran.sum().item()), "claimed": plan.claimed,
           "ms": ms, "plain_ms": plain_ms,
           "match_wall_ms": 1e3 * statistics.median(walls),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": nops, "steps": steps, "threads": threads,
           "step_floor_ms": floor_ms, "empty_launch_ms": empty_ms,
           "max_abs_err": max_abs_err}
    print(json.dumps(row), flush=True)
    return row


class LargestProblem:
    """Wraps a built Simulation's matchmaker so that, for the timing
    phase, a copy of the largest problem it was asked to solve is kept."""

    def __init__(self):
        self.largest: tuple | None = None

    def wrap(self, sim):
        mm = sim.collector.matchmaker
        inner = mm.match

        def match(p, **kw):
            if (self.largest is None
                    or p.compat.size > self.largest[0].compat.size):
                self.largest = (copy.deepcopy(p), copy.deepcopy(kw))
            return inner(p, **kw)

        mm.match = match
        return sim


def policy(PolicySpec, standard_policy, matchmaker: str, recorder=None):
    base = standard_policy("fill-first")
    ini = base.ini.replace("[provision]\n",
                           f"[provision]\nmatchmaker={matchmaker}\n", 1)
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(PolicySpec)}
    fields["ini"] = ini

    class Spec(PolicySpec):
        def build(self, **kw):
            sim = super().build(**kw)
            return recorder.wrap(sim) if recorder is not None else sim

    return Spec(**fields)


def comparable(block: dict) -> dict:
    """A run_policy block without its host wall-clock fields."""
    return {k: v for k, v in block.items() if k not in ("wall_s", "phases")}


def run_e2e(label, trace, mods, **kw):
    """The port's run_policy on the card vs on the NumPy backend."""
    PolicySpec, standard_policy, run_policy, ops = mods
    rec = LargestProblem()
    ops.launch_counts["waterfill"] = 0
    t0 = time.perf_counter()
    out_t = run_policy(trace, policy(PolicySpec, standard_policy, "torch",
                                     rec), **kw)
    wall_t = time.perf_counter() - t0
    launches = ops.launch_counts["waterfill"]
    t0 = time.perf_counter()
    out_n = run_policy(trace, policy(PolicySpec, standard_policy, "numpy"),
                       **kw)
    wall_n = time.perf_counter() - t0
    for key in ("jobs", "pods_submitted", "cost_total", "series"):
        if out_t[key] != out_n[key]:
            raise AssertionError(f"{label}: {key} differs between the torch "
                                 f"and numpy runs")
    if comparable(out_t) != comparable(out_n):
        raise AssertionError(f"{label}: run_policy blocks differ")
    if out_t["jobs"]["n"] != len(trace):
        raise AssertionError(f"{label}: {out_t['jobs']['n']} of "
                             f"{len(trace)} jobs completed")
    if launches == 0:
        raise AssertionError(f"{label}: the water-fill kernel never ran")
    print(json.dumps({"e2e": label, "jobs": len(trace),
                      "pods_submitted": out_t["pods_submitted"],
                      "cost_total": out_t["cost_total"],
                      "torch_wall_s": wall_t, "numpy_wall_s": wall_n,
                      "waterfill_launches": launches}), flush=True)
    return launches, rec.largest


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # phase 1: the card
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.matchmaker import (
        MatchProblem, NumpyMatchmaker, TorchMatchmaker,
    )
    from repro_torch.kernels.waterfill import ops
    from repro_torch.kernels.waterfill.ref import waterfill_reference
    from repro_torch.workload import (
        PolicySpec, diurnal_day, run_policy, standard_policy,
    )

    # phase 2: build
    t0 = time.perf_counter()
    lib = ops.build()
    print(f"built {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if ops.build_log:
        print(ops.build_log.strip(), flush=True)

    # phase 3: kernel vs plain version, matchmaker vs numpy
    mm, ref_mm = TorchMatchmaker(), NumpyMatchmaker()
    check = dict(mm=mm, ref_mm=ref_mm, ops=ops,
                 waterfill_reference=waterfill_reference)
    for tier, spec in TIERS.items():
        check_case(f"tier-{tier}", build_problem(MatchProblem, **spec),
                   **check)
    check_case("fractional", fractional_problem(MatchProblem, 300, 200, 5),
               **check)
    p = build_problem(MatchProblem, jobs=10_000, C=512, W=128, seed=3)
    active = np.random.default_rng(3).random(512) < 0.6
    check_case("budget+active", p, budget=3_000, active=active, **check)
    drain = fractional_problem(MatchProblem, 600, 4, 17)
    drain.requests[300:, 0] = 0.0           # zero-cpu cohorts, late chunks
    check_case("drained-pool", drain, **check)
    for W in (129, 1000, 1500, 6000):
        check_case(f"W={W}", build_problem(MatchProblem, jobs=20_000, C=512,
                                           W=W, seed=W), **check)
    check_case("float32-10k", build_problem(MatchProblem, **TIERS["10k"]),
               mm=TorchMatchmaker(dtype="float32"), ref_mm=ref_mm, ops=ops,
               waterfill_reference=waterfill_reference)

    # phase 4: end to end through run_policy
    mods = (PolicySpec, standard_policy, run_policy, ops)
    launches, largest = run_e2e("diurnal-10k", diurnal_day(10_000, seed=7),
                                mods)
    run_e2e("diurnal-2k-3schedd-fairshare", diurnal_day(2_000, seed=11),
            mods, schedds=3, fairshare=True)

    # the kernel line: timed at the largest problem the 10k day solved
    p, kw = largest
    row = check_case("main-path-largest", p, budget=kw.get("budget"),
                     active=kw.get("active"), plain_reps=3, **check)
    print(json.dumps({"kernels": [{
        "name": "waterfill", "route": "cuda",
        "source": "src/repro_torch/kernels/waterfill/waterfill.cu",
        "replaces": "src/repro/kernels/waterfill/kernel.py:120",
        "launches": launches, "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
