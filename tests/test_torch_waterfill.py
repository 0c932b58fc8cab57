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
from repro_torch.kernels.waterfill import launch_counts, waterfill
from repro_torch.kernels.waterfill.ref import waterfill_reference
from test_torch_matchmaker import one_torch_thread  # noqa: F401

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
        np_args = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                   for k, v in args.items()}
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
