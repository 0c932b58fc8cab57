"""The water-fill kernel on the card (marker ``cuda``; skips without a
GPU).  Imports nothing of JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each case builds the kernel's inputs through `TorchMatchmaker`, launches
the kernel and holds it against the plain version on the same CUDA
tensors (takes equal, free_after bit for bit), then holds the
matchmaker's plan against the NumPy backend's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.matchmaker import (
    MatchProblem, NumpyMatchmaker, TorchMatchmaker,
)
from repro_torch.kernels.waterfill import launch_counts, waterfill
from repro_torch.kernels.waterfill.ref import waterfill_reference

pytestmark = pytest.mark.cuda
R = 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def problem(seed, C, W, *, fractional=False):
    rng = np.random.default_rng(seed)
    requests = np.zeros((C, R))
    requests[:, 0] = rng.integers(1, 5, size=C)
    requests[:, 1] = rng.integers(0, 3, size=C)
    requests[:, 2] = rng.integers(0, 9, size=C)
    free = np.zeros((W, R))
    free[:, 0] = rng.integers(1, 33, size=W)
    free[:, 1] = rng.integers(0, 9, size=W)
    free[:, 2] = rng.integers(0, 129, size=W)
    if fractional:
        requests[:, 0] += rng.choice([0.0, 0.25, 0.5], size=C)
        requests[:, 2] *= 0.4
        free[:, 2] *= 0.4
    return MatchProblem(
        keys=[(0, c) for c in range(C)], requests=requests,
        demand=rng.integers(1, 60, size=C).astype(np.int64),
        order=rng.permutation(C).astype(np.int64), free=free,
        capacity=free.copy(), compat=rng.random((C, W)) < 0.8)


CASES = {
    "small": dict(C=40, W=30),
    "fractional": dict(C=130, W=200, fractional=True),
    "budget": dict(C=100, W=64, budget=200),
    "active": dict(C=100, W=64, active=0.5),
    "drain": dict(C=600, W=4),
    "two-rounds": dict(C=70, W=1500, fractional=True),
    "device-memory-carry": dict(C=64, W=5000),
}


# float32 is exact on integer-valued problems only
RUNS = [(name, dtype) for name in sorted(CASES)
        for dtype in ("float64", "float32")
        if dtype == "float64" or not CASES[name].get("fractional")]


@pytest.mark.parametrize("name,dtype", RUNS)
def test_kernel_equals_plain_version_and_numpy(cuda, name, dtype):
    kw = dict(CASES[name])
    budget, active = kw.pop("budget", None), kw.pop("active", None)
    p = problem(len(name), **kw)
    if active is not None:
        active = np.random.default_rng(1).random(p.n_cohorts) < active
    mm = TorchMatchmaker(device=cuda, dtype=dtype)
    args, _order = mm.kernel_inputs(p, budget=budget, active=active)
    nch, chunk, r = args["want"].shape
    Wp = args["crow"].shape[2]

    before = launch_counts["waterfill"]
    takes_k, free_k, ran = waterfill(**args)
    assert launch_counts["waterfill"] == before + 1
    takes_p, free_p = waterfill_reference(
        args["freeT"].T, args["want"].reshape(-1, r),
        args["demand"].reshape(-1), args["crow"].reshape(-1, Wp),
        budget=args["left"])
    torch.cuda.synchronize()
    assert takes_k.device == cuda and ran.shape == (nch,)
    assert torch.equal(takes_k.reshape(nch * chunk, Wp), takes_p)
    view = torch.int64 if dtype == "float64" else torch.int32
    assert torch.equal(free_k.view(view), free_p.T.contiguous().view(view))

    plan, ref = mm.match(p, budget=budget, active=active), \
        NumpyMatchmaker().match(p, budget=budget, active=active)
    np.testing.assert_array_equal(plan.takes, ref.takes)
    np.testing.assert_allclose(plan.free_after, ref.free_after, rtol=0,
                               atol=1e-7)


def test_no_budget_left_skips_every_chunk(cuda):
    p = problem(5, C=130, W=40)
    mm = TorchMatchmaker(device=cuda)
    args, _ = mm.kernel_inputs(p, budget=0)
    takes, free, ran = waterfill(**args)
    assert not bool(ran.any()) and int(takes.abs().sum()) == 0
    assert torch.equal(free, args["freeT"])


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    mm = TorchMatchmaker(device=cuda)
    args, _ = mm.kernel_inputs(problem(7, C=20, W=10))
    bad = dict(args, crow=args["crow"].to(torch.int32))
    with pytest.raises(TypeError, match="crow"):
        waterfill(**bad)
    bad = dict(args, want=torch.stack([args["want"]] * 2, dim=-1)[..., 0])
    assert torch.equal(bad["want"], args["want"])
    with pytest.raises(ValueError, match="contiguous"):
        waterfill(**bad)
