"""The port's water-fill against the JAX package's, on the CPU.

Two layers, each on problems made from numpy seeds and handed to both
packages as numpy arrays:

  * the plain PyTorch version (`repro_torch.kernels.waterfill.ref`)
    against the JAX reference (`repro.kernels.waterfill.ref`) in
    processing order, unchunked: float64 bitwise;
  * the port's chunked entry point (`repro_torch.kernels.waterfill.ops
    .waterfill`, whose CPU branch runs the plain version) against the
    Pallas kernel in interpret mode on the identical chunked layout:
    takes equal, free_after bitwise.

Float32 is held on integer-valued problems, where it is exact.

Tolerances.  Takes are always compared exactly.  free_after is compared
bit for bit against the NumPy reference backend on every case, and
against the JAX functions bit for bit on integer-valued problems.  On
fractional requests the JAX functions are held to the reference's own
atol of 1e-7 instead: XLA:CPU's jit (jax 0.9) contracts
``free - want*take`` into a fused multiply-add, rounding once where the
NumPy reference and this port round twice, so the last bit of a
fractional free value can differ (`test_jax_jit_contracts_multiply_sub`
pins that fact about the reference).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.matchmaker import NumpyMatchmaker
from repro.kernels.waterfill.ops import waterfill as pallas_waterfill
from repro.kernels.waterfill.ref import waterfill_reference as jax_reference
from repro_torch.core.matchmaker import TorchMatchmaker, problem_from_reference
from repro_torch.core.matchmaker.base import FIT_EPS
from repro_torch.kernels.waterfill import launch_counts, ops, waterfill
from repro_torch.kernels.waterfill.ops import (
    Solved, dense_takes, waterfill_cycles, waterfill_preview, waterfill_solve,
)
from repro_torch.kernels.waterfill.ref import (
    reciprocal_fits, reciprocals, waterfill_reference,
)
from test_torch_matchmaker import jax_backend, one_torch_thread  # noqa: F401

R = 6


def make_problem(seed, *, C=None, W=None, fractional=False, drain=False):
    """A reference MatchProblem whose processing order is the identity,
    so its rows feed the unchunked water-fills as they are."""
    from repro.core.matchmaker import MatchProblem
    rng = np.random.default_rng(seed)
    C = C if C is not None else int(rng.integers(1, 90))
    W = W if W is not None else int(rng.integers(1, 40))
    requests = np.zeros((C, R))
    requests[:, 0] = rng.integers(1, 5, size=C)
    requests[:, 1] = rng.integers(0, 3, size=C)
    requests[:, 2] = rng.integers(0, 9, size=C)
    if fractional:
        requests[:, 0] += rng.choice([0.0, 0.25, 0.5], size=C)
        requests[:, 2] *= 0.4
    free = np.zeros((W, R))
    free[:, 0] = rng.integers(1, 17, size=W)
    free[:, 1] = rng.integers(0, 9, size=W)
    free[:, 2] = rng.integers(0, 65, size=W) * (0.4 if fractional else 1.0)
    if drain:
        requests[C // 2:, 0] = 0.0          # zero-cpu cohorts, late chunks
    demand = rng.integers(1, 60, size=C).astype(np.int64)
    compat = rng.random((C, W)) < 0.8
    return MatchProblem(
        keys=[(0, c) for c in range(C)], requests=requests, demand=demand,
        order=np.arange(C, dtype=np.int64), free=free, capacity=free.copy(),
        compat=compat)


CASES = {
    "random": dict(),
    "fractional": dict(fractional=True),
    "budget": dict(budget=True),
    "fractional-budget": dict(fractional=True, budget=True),
    "drain": dict(C=600, W=4, drain=True),
    "wide": dict(C=70, W=300, fractional=True),
}
INTEGER_CASES = ["random", "budget", "drain"]


def case_problem(name, trial):
    kw = dict(CASES[name])
    budgeted = kw.pop("budget", False)
    p = make_problem(1000 * trial + len(name), **kw)
    budget = math.inf
    if budgeted:
        rng = np.random.default_rng(trial)
        budget = float(rng.integers(1, 1 + int(p.demand.sum())))
    return p, budget


def assert_bitwise(a: np.ndarray, b: np.ndarray, label: str):
    assert a.shape == b.shape, label
    assert a.dtype == b.dtype, label
    np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64),
                                  err_msg=label)


def assert_free_vs_jax(name, free_t, free_j, label):
    if CASES[name].get("fractional"):
        np.testing.assert_allclose(free_t, free_j, rtol=0, atol=1e-7,
                                   err_msg=label)
    else:
        assert_bitwise(free_t, free_j, label)


def numpy_free(p, budget):
    """free_after of the NumPy reference backend (processing order is
    the identity in these problems)."""
    plan = NumpyMatchmaker().match(
        p, budget=None if math.isinf(budget) else int(budget))
    return plan.takes, plan.free_after


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_bitwise_vs_jax_reference(name):
    for trial in range(4):
        p, budget = case_problem(name, trial)
        takes_t, free_t = waterfill_reference(
            torch.from_numpy(p.free), torch.from_numpy(p.requests),
            torch.from_numpy(p.demand), torch.from_numpy(p.compat),
            budget=budget)
        with jax.enable_x64(True):
            takes_j, free_j = jax_reference(
                jnp.asarray(p.free), jnp.asarray(p.requests),
                jnp.asarray(p.demand), jnp.asarray(p.compat),
                jnp.asarray(budget, dtype=jnp.float64))
            takes_j, free_j = np.asarray(takes_j), np.asarray(free_j)
        label = f"{name} trial={trial}"
        np.testing.assert_array_equal(takes_t.numpy(), takes_j, err_msg=label)
        assert takes_t.dtype == torch.int32
        assert_free_vs_jax(name, free_t.numpy(), free_j, label + " free")
        takes_n, free_n = numpy_free(p, budget)
        np.testing.assert_array_equal(takes_t.numpy(), takes_n, err_msg=label)
        assert_bitwise(free_t.numpy(), free_n, label + " free vs numpy")


def chunked(p, budget, dtype="float64"):
    mm = TorchMatchmaker(device="cpu", dtype=dtype)
    budget = None if math.isinf(budget) else int(budget)
    args, _order = mm.kernel_inputs(problem_from_reference(p), budget=budget)
    return args


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_entry_point_bitwise_vs_pallas_interpret(name):
    before = launch_counts["waterfill"]
    for trial in range(3):
        p, budget = case_problem(name, trial)
        args = chunked(p, budget)
        takes_t, free_t, ran_t = waterfill(**args)
        # the Pallas kernel divides: it takes no reciprocals
        np_args = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                   for k, v in args.items() if k != "inv"}
        with jax.enable_x64(True):
            takes_p, free_p, _ran_p = pallas_waterfill(
                **np_args, dtype=jnp.float64, interpret=True)
            takes_p, free_p = np.asarray(takes_p), np.asarray(free_p)
        label = f"{name} trial={trial}"
        np.testing.assert_array_equal(takes_t.numpy(), takes_p, err_msg=label)
        W = p.n_workers
        free_t = free_t.contiguous().numpy()
        assert_free_vs_jax(name, free_t, free_p, label + " free")
        assert_bitwise(np.ascontiguousarray(free_t[:, :W].T),
                       numpy_free(p, budget)[1], label + " free vs numpy")
        assert ran_t.dtype == torch.bool and bool(ran_t.all())
    # the CPU branch is the plain version: it launches no kernel
    assert launch_counts["waterfill"] == before


@pytest.mark.parametrize("name", INTEGER_CASES)
def test_float32_exact_on_integer_problems(name):
    """Integer-valued quantities: float32 must agree with the JAX
    reference run in float32 (no x64), bit for bit."""
    for trial in range(3):
        p, budget = case_problem(name, trial)
        f32 = {k: getattr(p, k).astype(np.float32)
               for k in ("free", "requests")}
        takes_t, free_t = waterfill_reference(
            torch.from_numpy(f32["free"]), torch.from_numpy(f32["requests"]),
            torch.from_numpy(p.demand), torch.from_numpy(p.compat),
            budget=budget)
        takes_j, free_j = jax_reference(
            jnp.asarray(f32["free"]), jnp.asarray(f32["requests"]),
            jnp.asarray(p.demand.astype(np.int32)), jnp.asarray(p.compat),
            jnp.asarray(budget, dtype=jnp.float32))
        label = f"{name} trial={trial}"
        np.testing.assert_array_equal(takes_t.numpy(), np.asarray(takes_j),
                                      err_msg=label)
        assert free_t.dtype == torch.float32
        np.testing.assert_array_equal(
            free_t.numpy().view(np.int32),
            np.asarray(free_j).view(np.int32), err_msg=label)


def test_tensor_on_another_device_raises():
    """A tensor on a device other than cpu/cuda gets no silent fallback."""
    p, budget = case_problem("random", 0)
    args = chunked(p, budget)
    args["freeT"] = args["freeT"].to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        waterfill(**args)


def test_jax_jit_contracts_multiply_sub():
    """The fact behind the fractional tolerance above: under jit, XLA:CPU
    rounds ``f - w*t`` once (a fused multiply-add), eager NumPy twice.
    Should a jax release stop contracting, this fails and the fractional
    JAX comparisons can go back to bitwise."""
    f, w, t = 1.0, 0.1, 9.0
    with jax.enable_x64(True):
        jit = float(jax.jit(lambda f, w, t: f - w * t)(f, w, t))
    assert jit != f - w * t
    assert float(np.float64(f) - np.float64(w) * np.float64(t)) == f - w * t


# -- the reciprocal decision: `ref.reciprocal_fits` --------------------------

SAFES = [0.1, 0.3, 0.4, 0.7, 1.7, 2.5, 3.0, 7.0, 1e-3, 123.456, 0.25]


def adversarial_lanes(dtype, n_max=40, ulps=8):
    """Worker lanes whose quotient free/safe lies within +-`ulps` units in
    the last place of n - FIT_EPS, for every n < `n_max` and every safe
    in SAFES: the values where floor(q + FIT_EPS) turns over."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    frees, safes = [], []
    for s in SAFES:
        s = npdt(s)
        for n in range(1, n_max):
            x = npdt(n) - npdt(1e-9)
            for _ in range(ulps):
                x = np.nextafter(x, npdt(-np.inf))
            for _ in range(2 * ulps + 1):
                frees.append(npdt(x * s))
                safes.append(s)
                x = np.nextafter(x, npdt(np.inf))
    return np.array(frees, dtype=npdt), np.array(safes, dtype=npdt)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reciprocal_fits_exact_at_the_boundaries(dtype):
    """Within +-8 ulp of n - FIT_EPS the product free * (1/safe) can fall
    on the other side of n; the margin test sends exactly those lanes to
    the divide, so the fits equal the divide's everywhere."""
    free, safe = adversarial_lanes(dtype)
    W = free.size
    freeT = torch.zeros((R, W), dtype=dtype)
    freeT[0] = torch.from_numpy(free)
    freeT[1:] = 1e6                     # the other resources never bind
    fits_all, fell_all, wrong = [], [], 0
    for s in sorted(set(safe.tolist())):
        lanes = torch.from_numpy(safe == np.asarray(s, safe.dtype))
        want = torch.ones(R, dtype=dtype)
        want[0] = s
        safe_c, big_c = want, torch.zeros(R, dtype=dtype)
        inv_c = reciprocals(safe_c)
        d = torch.tensor(1e4, dtype=dtype)
        crow = lanes.to(dtype)
        fits, fell = reciprocal_fits(freeT, safe_c, big_c, inv_c, d, crow)
        exact = torch.minimum(torch.maximum(torch.floor(
            (freeT / safe_c[:, None] + big_c[:, None]).min(dim=0).values
            + FIT_EPS), torch.zeros((), dtype=dtype)), d) * crow
        assert torch.equal(fits, exact), f"safe={s}"
        unchecked = torch.floor((freeT * inv_c[:, None]).min(dim=0).values
                                + FIT_EPS)
        wrong += int(((unchecked != exact) & lanes).sum())
        fits_all.append(fits[lanes])
        fell_all.append(fell[lanes])
    fell = torch.cat(fell_all)
    # the margin catches every lane the product alone gets wrong, and
    # sends only a minority to the divide
    assert wrong > 0
    assert 0 < int(fell.sum()) < fell.numel()


@pytest.mark.parametrize("name", sorted(CASES))
def test_reciprocal_reference_equals_divide(name):
    for trial in range(3):
        p, budget = case_problem(name, trial)
        args = (torch.from_numpy(p.free), torch.from_numpy(p.requests),
                torch.from_numpy(p.demand), torch.from_numpy(p.compat))
        takes_d, free_d = waterfill_reference(*args, budget=budget)
        takes_r, free_r = waterfill_reference(*args, budget=budget,
                                              reciprocal=True)
        assert torch.equal(takes_d, takes_r), f"{name} trial={trial}"
        assert_bitwise(free_r.numpy(), free_d.numpy(),
                       f"{name} trial={trial}")


def test_reciprocals_mark_the_unbounded_range():
    safe = torch.tensor([1.0, 0.1, 2.0 ** -1001, 2.0 ** 1001, 3.0],
                        dtype=torch.float64)
    inv = reciprocals(safe)
    assert torch.equal(inv[[0, 1, 4]], 1.0 / safe[[0, 1, 4]])
    assert bool(inv[2].isnan()) and bool(inv[3].isnan())
    f32 = reciprocals(torch.tensor([2.0 ** -121, 0.5], dtype=torch.float32))
    assert bool(f32[0].isnan()) and float(f32[1]) == 2.0


# -- K cycles and N candidates: the plain loops against the JAX scans ---------

def fused_inputs(p, deltas=None, lanes=None):
    """The chunked numpy arrays the JAX fused scans and the port's fused
    entry points take, from the port matchmaker's own padding."""
    mm = TorchMatchmaker(device="cpu")
    q = problem_from_reference(p)
    (order, req_o, d_o, crow_o, freeT, safe, big, Cp, Wp) = mm._prep(
        q, lanes=lanes)
    nch = Cp // 64
    out = dict(order=order, freeT=freeT, d_o=d_o.reshape(nch, 64),
               want=req_o.reshape(nch, 64, R), safe=safe.reshape(nch, 64, R),
               big=big.reshape(nch, 64, R),
               crow=crow_o.reshape(nch, 64, Wp), nch=nch, Wp=Wp)
    if deltas is not None:
        K, (C, W) = len(deltas), p.compat.shape
        arr = np.zeros((K, Cp))
        fadd = np.zeros((K, R, Wp))
        budgets = np.empty(K)
        for k, d in enumerate(deltas):
            arr[k, :C] = d.arrivals[order[:C]]
            if d.free_add is not None:
                fadd[k, :, :W] = d.free_add.T
            budgets[k] = math.inf if d.budget is None else d.budget
        out.update(arrivals=arr.reshape(K, nch, 64), free_add=fadd,
                   budgets=budgets)
    return out


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("fractional", [False, True])
def test_cycles_plain_loop_vs_jax_cycles_scan(jax_backend, K, fractional):
    """`ops.waterfill_cycles` on CPU tensors (`ref.
    waterfill_cycles_reference`) against the JAX package's fused
    `_build_cycles_scan` on the same chunked arrays: takes equal, each
    cycle's free bitwise on integer problems, within 1e-7 on fractional
    ones (the FMA above); every delta adds its free (the scan adds zeros
    where there is none)."""
    from test_fused_negotiation import random_deltas
    from test_matchmaker_differential import random_problem
    rng = np.random.default_rng(61 + K + 10 * fractional)
    fn = jax_backend._build_cycles_scan(64, 4)
    for trial in range(3):
        p = random_problem(rng, C=70, W=40, fractional=fractional)
        p.demand = np.zeros_like(p.demand)
        deltas = random_deltas(rng, p, K)
        a = fused_inputs(p, deltas)
        with jax.enable_x64(True):
            tk_j, _ran_j, fp_j = fn(*(jnp.asarray(a[k]) for k in (
                "freeT", "d_o", "arrivals", "free_add", "budgets", "want",
                "safe", "big", "crow")))
            tk_j, fp_j = np.asarray(tk_j), np.asarray(fp_j)
        t = {k: torch.from_numpy(np.ascontiguousarray(a[k])) for k in (
            "freeT", "arrivals", "free_add", "budgets", "want", "safe",
            "big", "crow")}
        out = waterfill_cycles(
            t["freeT"], torch.from_numpy(a["d_o"]), t["arrivals"],
            t["free_add"], torch.ones(K, dtype=torch.bool), t["budgets"],
            t["want"], t["safe"], t["big"], t["crow"])
        label = f"K={K} trial={trial}"
        np.testing.assert_array_equal(
            dense_takes(out).numpy().reshape(tk_j.shape), tk_j, err_msg=label)
        np.testing.assert_array_equal(out.totals.numpy(), tk_j.sum(axis=-1),
                                      err_msg=label)
        if fractional:
            np.testing.assert_allclose(out.free.numpy(), fp_j, rtol=0,
                                       atol=1e-7, err_msg=label)
        else:
            assert_bitwise(out.free.numpy(), fp_j, label)


def test_preview_plain_loop_vs_jax_preview_scan(jax_backend):
    """`ops.waterfill_preview` on CPU tensors against the JAX package's
    vmapped `_build_preview_scan`, on the preview bucket's 512 lanes."""
    from test_matchmaker_differential import random_problem
    rng = np.random.default_rng(67)
    fn = jax_backend._build_preview_scan(64, 1)
    for trial in range(3):
        p = random_problem(rng, C=70, W=40, fractional=trial == 2)
        a = fused_inputs(p, lanes=512)
        N, W = 4, p.n_workers
        frees = np.zeros((N, R, a["Wp"]))
        demands = np.zeros((N, a["nch"] * 64))
        for i in range(N):
            frees[i, :, :W] = (p.free * rng.choice([0.0, 0.5, 1.0, 2.0])).T
            demands[i, :p.n_cohorts] = rng.integers(
                0, 40, p.n_cohorts)[a["order"][:p.n_cohorts]]
        demands = demands.reshape(N, a["nch"], 64)
        with jax.enable_x64(True):
            want = np.asarray(fn(jnp.asarray(frees), jnp.asarray(demands),
                                 *(jnp.asarray(a[k]) for k in (
                                     "want", "safe", "big", "crow"))))
        out = waterfill_preview(
            torch.from_numpy(frees), torch.from_numpy(demands),
            *(torch.from_numpy(np.ascontiguousarray(a[k]))
              for k in ("want", "safe", "big", "crow")))
        np.testing.assert_array_equal(out.totals.numpy(), want,
                                      err_msg=f"trial={trial}")
        assert out.takes is None and out.free is None and out.ran is None


def test_cpu_entry_points_launch_nothing_and_compact_matches_dense():
    """The solve's takes hold the rows of the chunks that ran (every chunk
    on the CPU), and `waterfill`'s dense takes are them spread out."""
    p, budget = case_problem("random", 1)
    args = chunked(p, budget)
    before = dict(launch_counts)
    out = waterfill_solve(**args)
    takes, free, ran = waterfill(**args)
    assert launch_counts == before
    nch = args["want"].shape[0]
    assert out.takes.shape == (nch, 64, args["crow"].shape[-1])
    assert bool(ran.all()) and torch.equal(out.takes, takes)
    assert torch.equal(dense_takes(out)[0], takes)
    host = out.to_host()
    assert host.packed.numel() == out.packed.numel()
    assert torch.equal(host.free, out.free) and torch.equal(host.free[0], free)


def test_dense_takes_spreads_the_rows_of_the_chunks_that_ran():
    """Over K = 2 cycles of 3 chunks, the n-th chunk that ran (in cycle,
    then chunk order) sits at [n]; every skipped chunk comes out zero,
    whatever the unused slots hold."""
    ran = torch.tensor([[True, False, True], [False, False, True]])
    takes = torch.full((6, 64, 32), -9, dtype=torch.int32)
    for n in range(3):
        takes[n] = n + 1
    out = Solved(takes, None, torch.zeros(2, 3, 64, dtype=torch.int32), ran,
                 torch.empty(0, dtype=torch.uint8))
    dense = dense_takes(out)
    assert dense.shape == (2, 3, 64, 32) and dense.dtype == torch.int32
    want = [[1, 0, 2], [0, 0, 3]]
    for k in range(2):
        for ch in range(3):
            assert bool((dense[k, ch] == want[k][ch]).all()), (k, ch)


# -- the staged instance's plan and route (pure Python) -----------------------

def test_staged_plan_mirrors_the_kernel_table():
    """ops._STAGED is waterfill.cu's WATERFILL_STAGED_INSTANCES, and each
    plan fits the card's shared memory with two stages of whole tiles."""
    import re
    src = ops.SOURCE.read_text()
    table = re.findall(r"X\((double|float), (\d+), (\d+), (\d+)\)", src)
    mirror = [(t, *map(int, rest)) for t, *rest in table]
    assert mirror == [("double",) + i for i in ops._STAGED[torch.float64]] + \
        [("float",) + i for i in ops._STAGED[torch.float32]]
    for dt, top in ((torch.float64, 8192), (torch.float32, 8192)):
        for Wp in (32, 128, 768, 1024, 1056, 2048, 4096, 6016, 6176, top):
            plan = ops.staged_plan(dt, Wp)
            assert plan is not None, (dt, Wp)
            assert plan.threads * plan.lanes >= Wp
            assert plan.threads % 32 == 0 and 64 % plan.sub == 0
            assert plan.smem <= ops.H100_SMEM
        assert ops.staged_plan(dt, top + 32) is None
        assert ops.staged_plan(dt, 100) is None        # not whole warps


def test_route_picks_staged_where_it_fits_and_is_aligned():
    """"staged" up to 8,192 lanes in either dtype, "rounds" beyond; a
    view the staged instance's bulk copies cannot take is refused."""
    p, budget = case_problem("wide", 0)
    args = chunked(p, budget)
    keys = ("freeT", "want", "safe", "big", "crow", "inv")
    assert ops.route(*(args[k] for k in keys)) == "staged"
    shifted = torch.empty(args["want"].numel() + 1,
                          dtype=torch.float64)[1:].view_as(args["want"])
    moved = dict(args, want=shifted)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.route(*(moved[k] for k in keys))
    for lanes, want in ((6144 + 128, "staged"), (8192, "staged"),
                        (8192 + 128, "rounds")):
        wide = torch.zeros((R, lanes), dtype=torch.float64)
        crow = torch.zeros((1, 64, lanes), dtype=torch.uint8)
        assert ops.route(wide, args["want"][:1], args["safe"][:1],
                         args["big"][:1], crow) == want, lanes
        assert ops.route(wide.float(), args["want"][:1].float(),
                         args["safe"][:1].float(), args["big"][:1].float(),
                         crow) == want, lanes
