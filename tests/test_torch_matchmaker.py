"""`TorchMatchmaker(device="cpu")` against the JAX package's matchmakers.

Problems are made from numpy seeds with the reference suite's own
generators, built as the JAX package's `MatchProblem`, and carried into
the port through `problem_from_reference` (copied arrays, checked dtypes
and shapes).  Takes are compared exactly everywhere.  free_after is
compared exactly against the NumPy backend and, on integer-valued
problems, against the JAX backend; on fractional requests the JAX
backend is held to the reference's atol of 1e-7, because its jitted
water-fill rounds ``free - want*take`` once (XLA:CPU contracts it into a
fused multiply-add) where NumPy and the port round twice
(tests/test_torch_waterfill.py pins that fact).

The JAX package's backend module gates on `jax.experimental.enable_x64`,
which this jax moved to `jax.enable_x64`; the `jax_backend` fixture
hands the module that context manager for the test's duration, leaving
the package itself untouched.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core.matchmaker import NumpyMatchmaker as RefNumpy
from repro_torch import core as port_core
from repro_torch.core.matchmaker import (
    TorchMatchmaker, make_matchmaker, problem_from_reference,
)
from repro_torch.core.matchmaker.base import (
    sequential_match_cycles, sequential_preview_many,
)
from test_fused_negotiation import random_deltas
from test_matchmaker_differential import random_problem


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version is a loop of tiny tensor ops: one intra-op
    thread runs it fastest, and several test workers with a thread pool
    each would oversubscribe the host's cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_backend(monkeypatch):
    """The JAX package's jax_backend module, made runnable under this jax
    (see the module docstring)."""
    from repro.core.matchmaker import jax_backend as jb
    if not jb.HAVE_JAX:
        monkeypatch.setattr(jb, "jax", jax)
        monkeypatch.setattr(jb, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)
        monkeypatch.setattr(jb, "HAVE_JAX", True)
    return jb


def port_mm(**kw):
    return TorchMatchmaker(device="cpu", **kw)


def assert_plans(port, jaxp, nump, label, *, fractional):
    np.testing.assert_array_equal(port.takes, jaxp.takes, err_msg=label)
    np.testing.assert_array_equal(port.takes, nump.takes, err_msg=label)
    assert port.takes.dtype == np.int64
    np.testing.assert_array_equal(port.free_after, nump.free_after,
                                  err_msg=label + " free vs numpy")
    if fractional:
        np.testing.assert_allclose(port.free_after, jaxp.free_after,
                                   rtol=0, atol=1e-7, err_msg=label)
    else:
        np.testing.assert_array_equal(port.free_after, jaxp.free_after,
                                      err_msg=label + " free vs jax")


@pytest.mark.parametrize("fractional", [False, True])
def test_random_problems(jax_backend, fractional):
    jm, nm, tm = jax_backend.JaxMatchmaker(), RefNumpy(), port_mm()
    rng = np.random.default_rng(7 + fractional)
    for trial in range(25):
        p = random_problem(rng, fractional=fractional)
        assert_plans(tm.match(problem_from_reference(p)), jm.match(p),
                     nm.match(p), f"trial={trial}", fractional=fractional)


def test_budget_and_active(jax_backend):
    jm, nm, tm = jax_backend.JaxMatchmaker(), RefNumpy(), port_mm()
    rng = np.random.default_rng(11)
    for trial in range(15):
        p = random_problem(rng)
        q = problem_from_reference(p)
        budget = int(rng.integers(1, 1 + int(p.demand.sum())))
        active = rng.random(p.n_cohorts) < 0.6
        for kw in ({"budget": budget}, {"active": active},
                   {"budget": budget, "active": active}):
            assert_plans(tm.match(q, **kw), jm.match(p, **kw),
                         nm.match(p, **kw), f"trial={trial} {sorted(kw)}",
                         fractional=False)


@pytest.mark.parametrize("C", [63, 64, 65])
@pytest.mark.parametrize("W", [127, 128, 129])
def test_padding_boundaries(jax_backend, C, W):
    """Cohort counts straddling the 64-cohort chunk and worker counts
    straddling the 128-lane bucket: pad rows and lanes take nothing."""
    jm, nm, tm = jax_backend.JaxMatchmaker(), RefNumpy(), port_mm()
    p = random_problem(np.random.default_rng(C * 1000 + W), C=C, W=W)
    assert_plans(tm.match(problem_from_reference(p)), jm.match(p),
                 nm.match(p), f"C={C} W={W}", fractional=False)


def test_drain_guard_exact_when_pool_exhausts(jax_backend):
    """Demand >> supply, including zero-cpu cohorts in late chunks that
    disarm the guard."""
    jm, nm, tm = jax_backend.JaxMatchmaker(), RefNumpy(), port_mm()
    rng = np.random.default_rng(17)
    p = random_problem(rng, C=600, W=4)
    assert_plans(tm.match(problem_from_reference(p)), jm.match(p),
                 nm.match(p), "drain", fractional=False)
    p2 = random_problem(rng, C=600, W=4)
    p2.requests[300:, 0] = 0.0
    assert_plans(tm.match(problem_from_reference(p2)), jm.match(p2),
                 nm.match(p2), "drain+zero-cpu", fractional=False)


@pytest.mark.parametrize("K", [1, 2, 8])
def test_sequential_match_cycles_equal_reference_fused(jax_backend, K):
    """The port has no fused `match_cycles`: the Collector routes K
    cycles through `sequential_match_cycles`, which must equal the JAX
    backend's fused K-cycle dispatch."""
    jm, tm = jax_backend.JaxMatchmaker(), port_mm()
    assert getattr(tm, "match_cycles", None) is None
    rng = np.random.default_rng(100 + K)
    for trial in range(4):
        p = random_problem(rng)
        p.demand = np.zeros_like(p.demand)     # arrivals carry the demand
        deltas = random_deltas(rng, p, K)
        fused = jm.match_cycles(p, deltas)
        seq = sequential_match_cycles(tm, problem_from_reference(p), deltas)
        assert len(seq) == len(fused) == K
        for k in range(K):
            label = f"K={K} trial={trial} cycle={k}"
            np.testing.assert_array_equal(seq[k].takes, fused[k].takes,
                                          err_msg=label)
            np.testing.assert_array_equal(seq[k].free_after,
                                          fused[k].free_after, err_msg=label)


def test_sequential_preview_many_equals_reference_batched(jax_backend):
    jm, tm = jax_backend.JaxMatchmaker(), port_mm()
    assert getattr(tm, "preview_many", None) is None
    rng = np.random.default_rng(23)
    for trial in range(4):
        p = random_problem(rng)
        frees = [p.free * rng.integers(0, 3) for _ in range(3)] + [p.free]
        demands = [np.maximum(p.demand - rng.integers(0, 9, p.n_cohorts), 0)
                   for _ in frees]
        for dm in (None, demands):
            want = jm.preview_many(p, frees, dm)
            got = sequential_preview_many(tm, problem_from_reference(p),
                                          frees, dm)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"trial={trial}")


def test_float32_on_integer_problems(jax_backend):
    jm = jax_backend.JaxMatchmaker(dtype="float32")
    tm = port_mm(dtype="float32")
    rng = np.random.default_rng(29)
    for trial in range(10):
        p = random_problem(rng)
        a, b = tm.match(problem_from_reference(p)), jm.match(p)
        np.testing.assert_array_equal(a.takes, b.takes, err_msg=str(trial))
        np.testing.assert_array_equal(a.free_after, b.free_after,
                                      err_msg=str(trial))


def test_torch_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_matchmaker("torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchMatchmaker(dtype="float32")
    assert TorchMatchmaker(device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        TorchMatchmaker(device="cpu", dtype="float16")


def test_problem_from_reference_copies_and_checks():
    p = random_problem(np.random.default_rng(3), C=5, W=4)
    q = problem_from_reference(p)
    for f in ("requests", "demand", "order", "free", "capacity", "compat"):
        assert not np.shares_memory(getattr(p, f), getattr(q, f)), f
        np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
    with pytest.raises(TypeError, match="demand"):
        problem_from_reference(dataclasses.replace(
            p, demand=p.demand.astype(np.float64)))
    with pytest.raises(ValueError, match="free"):
        problem_from_reference(dataclasses.replace(p, free=p.free[:3]))


# -- the Collector around the matchmaker: claim maps and fair-share books ----

def build_pool(core, matchmaker, rng_seed=0, n_workers=12, n_jobs=200):
    """The reference suite's pool, built from either package's classes."""
    rng = np.random.default_rng(rng_seed)
    col = core.Collector(matchmaker=matchmaker)
    for i in range(n_workers):
        ad = {"cpus": int(rng.integers(2, 17)),
              "memory": int(rng.integers(8, 65))}
        g = int(rng.integers(0, 5))
        if g:
            ad["gpus"] = g
        w = core.Worker(name=f"w{i:02d}", ad=ad,
                        start_expr=core.ClassAdExpr("true"))
        w.booted_at = 0.0
        col.advertise(w)
    q = core.JobQueue()
    for i in range(n_jobs):
        ad = {"request_cpus": int(rng.integers(1, 5)),
              "request_memory": int(rng.integers(1, 9)),
              "user": f"u{int(rng.integers(0, 4))}"}
        g = int(rng.integers(0, 2))
        if g:
            ad["request_gpus"] = g
        q.submit(core.Job(ad=ad, runtime_s=60), float(i))
    return col, q


def claim_map(q):
    return {j.jid: j.claimed_by for j in q.jobs() if j.claimed_by}


def test_collector_claim_maps_equal_reference(jax_backend):
    for seed in range(4):
        ca, qa = build_pool(ref_core, "jax", rng_seed=seed)
        cb, qb = build_pool(port_core, port_mm(), rng_seed=seed)
        assert ca.run_cycle(qa, 0.0) == cb.run_cycle(qb, 0.0)
        assert claim_map(qa) == claim_map(qb), f"seed={seed}"


def build_federation(core, matchmaker, rng_seed=1):
    rng = np.random.default_rng(rng_seed)
    specs = [core.ScheddSpec(name="osg", quota=3.0,
                             priority_factors={"heavy": 4.0}),
             core.ScheddSpec(name="cms", quota=1.0),
             core.ScheddSpec(name="icecube", quota=2.0)]
    acct = core.Accountant()
    col = core.Collector(matchmaker=matchmaker)
    for i in range(16):
        w = core.Worker(name=f"w{i:02d}", ad={"cpus": 4, "memory": 32},
                        start_expr=core.ClassAdExpr("true"))
        w.booted_at = 0.0
        col.advertise(w)
    queues = []
    for spec in specs:
        q = core.JobQueue(name=spec.name)
        acct.set_quota(spec.name, spec.quota)
        for u, f in spec.priority_factors.items():
            acct.set_priority_factor(u, f)
        acct.attach_queue(spec.name, q)
        for i in range(40):
            q.submit(core.Job(ad={
                "request_cpus": int(rng.integers(1, 3)),
                "request_memory": int(rng.integers(1, 5)),
                "user": rng.choice(["alice", "bob", "heavy"]),
            }, runtime_s=300), float(i))
        queues.append(q)
    return col, queues, acct


@pytest.mark.parametrize("quantum", [1, 2])
def test_flocking_fairshare_books_equal_reference(jax_backend, quantum):
    ca, qsa, aa = build_federation(ref_core, "jax")
    cb, qsb, ab = build_federation(port_core, port_mm())
    na = ca.run_cycle(qsa, 0.0, accountant=aa, quantum=quantum)
    nb = cb.run_cycle(qsb, 0.0, accountant=ab, quantum=quantum)
    assert na == nb and na > 0
    for qa, qb in zip(qsa, qsb):
        assert claim_map(qa) == claim_map(qb), qa.name
    assert aa.snapshot(0.0) == ab.snapshot(0.0)
