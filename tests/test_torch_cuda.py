"""The port's kernels on the card (marker ``cuda``; skips without a
GPU).  Imports nothing of JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Water-fill: each case builds the kernel's inputs through
`TorchMatchmaker`, launches the kernel and holds it against the plain
version on the same CUDA tensors (takes equal, free_after bit for bit),
then holds the matchmaker's plan against the NumPy backend's; the same
on each instance ("staged", PR 11's "rounds"), which `ops.route` picks
from width and dtype; K cycles (`waterfill_cycles`) and N
candidates (`waterfill_preview`) against their plain loops, each one
launch; the rows of skipped chunks zero with no memset; the drain
guard leaving zero chunk minima out.

Flash attention: the reference suite's eight cases, the fully masked
rows and the rolling-window permutation, qwen2-1.5b's serving shapes and
the tensor-core instance's edge cases, the group sizes G = 9, 8 and 5
(prefills on the tensor cores, decode ticks on the split) and
granite-8b's, starcoder2-7b's, qwen3-32b's and llama4-scout's prefill
and tick, each against the plain version in
float32 on the same CUDA tensors, at the reference's tolerances (2e-5 for
float32 inputs, 2e-2 for bfloat16), each through the instance
`flash_route` names (the decode split for at most 32 query rows per kv
head, the tensor cores for bfloat16 with Dh 64 or 128, SIMT otherwise);
two calls of each instance give the same bits.

SSD: the reference suite's four cases, mamba2-1.3b's serving shapes
(B = 1, 64 heads of 64, d_state 128, chunk 256, S = 512, 1024 and a
ragged 777, with and without an initial state), in float32 and
bfloat16, the tensor-core instance's edge cases and mamba2's and
jamba's timed bfloat16 shapes, y and the final state against the plain
chunked version and the sequential oracle at the reference's tolerances
(2e-3 and 5e-2), each call through the instance `ssd_route` names (the
tensor-core passes for bfloat16 with P and N 64 or 128 and a chunk that
is a multiple of 64, SIMT otherwise); two calls of each instance give
the same bits.

Grouped matmul: the reference suite's four cases, ragged groups (empty,
unaligned, a tail), the tensor-core edge cases (one group holding every
row, a short group between long ones, N and K ending inside a tile) and
jamba-v0.1-52b's and llama4-scout's decode and prefill expert products
(16 experts, 4096 x 14336 and 5120 x 8192), in float32 and bfloat16 and with float32 output, against the
plain version on the same CUDA tensors at the reference's tolerances
(1e-4 and 5e-2), each through the instance `gmm_route` names (tensor
cores for bfloat16 with K and N multiples of 8, SIMT otherwise); two
tensor-core calls give the same bits.

Flash-attention backward: each forward instance's log-sum-exp against
the plain one; chip_smoke's `FLASH_BWD_CASES` (the reference suite's
shapes, fully masked rows, softcap, window, G = 1, 4 and 6, a shape the
forward sends to the decode split) and qwen2-1.5b's training shapes, in
float32 (1e-4 of each gradient's max) and bfloat16 (2e-2), against the
plain backward on the same CUDA tensors, through the instance
`flash_bwd_route` names (`bwd_route`: the tensor cores for bfloat16 at Dh
64 or 128, SIMT otherwise) and through each instance forced; two calls
give the same bits; autograd through `flash_attention` launches one
forward and one backward; the wrapper refuses a missing, mis-shaped,
wrong-dtype or CPU lse.

SSD backward: chip_smoke's `check_ssd_bwd` (the backward kernel against
the plain backward given the states the forward kept, each gradient
within 1e-4 (f32) / 2e-2 (bf16) of its max, in its input's dtype, on the
instance `ssd_route` names, two calls bitwise) on the reference suite's
cases in both dtypes, the tensor-core edge cases, the final-state
gradient case, and the SIMT instance on the tensor-core forward's
states; autograd through `ssd` launching one forward and one backward,
counted by instance; the wrapper refusing missing or mismatched states.

Grouped-matmul backward: chip_smoke's `check_gmm_bwd` (the backward
kernel against the plain backward, each gradient within 1e-4 (f32) / 2e-2
(bf16) of its max, in its input's dtype, the padding rows' dlhs and the
empty groups' drhs exactly 0, on the instance `gmm_route` names, two calls
bitwise) on the reference suite's, the ragged, the tensor-core edge, the
stage-edge and the tile-edge cases (`GMM_BWD_TILE_CASES`: 128 x 256 tiles
in clusters of two at the edges of groups, K and N); its floor probe
counting nothing; autograd through `gmm` launching one forward and
one backward, counted by instance, and only the gradients asked for; the
wrapper refusing what it does not take; serving's calls under
`torch.no_grad()` launching no backward.

Training: `matmul_f32`'s gradient; a small dense model's, a small
mamba2's and small jamba's and llama4-scout's (head dim 32: attention's
kernel takes 32, 64 and 128) loss and gradients on the card against the
same model on the CPU.

The cases, inputs and checks are chip_smoke.py's own, so the two cannot
drift apart.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.matchmaker import (
    MatchProblem, NumpyMatchmaker, TorchMatchmaker,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import (
    route_counts as flash_routes,
)
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm.ops import (
    gmm, gmm_plain, route_counts, stream_floor,
)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd, ssd_chunked
from repro_torch.kernels.ssd.ops import route_counts as ssd_routes
from repro_torch.kernels.ssd.ops import _ssd_instance
from repro_torch.kernels.ssd.ref import ssd_reference
from repro_torch.kernels.waterfill import launch_counts, ops, waterfill
from repro_torch.kernels.waterfill.ref import (
    waterfill_cycles_reference, waterfill_preview_reference,
    waterfill_reference,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402
    FLASH_BWD_CASES, FLASH_BWD_TIMED, FLASH_BWD_TOL, LSE_TOL, check_flash_bwd,
    check_gmm_bwd, check_lse, check_ssd_bwd, flash_bwd_inputs,
    flash_bwd_route, GMM_BWD_STAGE_CASES, GMM_BWD_TILE_CASES,
    gmm_bwd_inputs,
    FLASH_CASES, FLASH_TOL, FLASH_WGMMA_CASES, GMM_CASES, GMM_RAGGED,
    MODAL_FLASH_CALLS, modal_flash_inputs,
    CONFIG_FLASH_CALLS, FLASH_GROUP_CASES, FLASH_GROUP_DECODE, LLAMA4_ARCH,
    LLAMA4_PREFILLS, flash_group_decode_inputs,
    GMM_TC_CASES, GMM_TOL, SSD_BWD_DFINAL, SSD_BWD_TC_CASES, SSD_CASES,
    SSD_TC_CASES, SSD_TOL,
    attention_inputs, bitwise_equal, check_fully_masked_rows, fused_deltas,
    guard_problem,
    check_rolling_window, flash_route, flash_wgmma_inputs, gmm_arrays,
    gmm_inputs, gmm_route, moe_serving_inputs, moe_serving_shapes,
    serving_shapes, ssd_arrays, ssd_bwd_arrays, ssd_inputs, ssd_route,
    ssd_serving_cases, ssd_tc_inputs, ssd_timed_cases,
)

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
    "sixteen-lanes-512-threads": dict(C=64, W=8000),
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


def plain_single(args):
    nch, chunk, r = args["want"].shape
    Wp = args["crow"].shape[2]
    return waterfill_reference(
        args["freeT"].T, args["want"].reshape(-1, r),
        args["demand"].reshape(-1), args["crow"].reshape(-1, Wp),
        budget=args["left"])


def counts():
    return (launch_counts["waterfill"], dict(ops.route_counts),
            dict(ops.kind_counts))


@pytest.mark.parametrize("instance", ["staged", "rounds"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_each_instance_equals_plain_version(cuda, name, instance):
    kw = dict(CASES[name])
    budget, active = kw.pop("budget", None), kw.pop("active", None)
    p = problem(len(name) + 100, **kw)
    if active is not None:
        active = np.random.default_rng(2).random(p.n_cohorts) < active
    args, _ = TorchMatchmaker(device=cuda).kernel_inputs(
        p, budget=budget, active=active)
    n, routes, kinds = counts()
    out = ops._waterfill_instance(instance, **args)
    takes_k, free_k = ops.dense_takes(out)[0], out.free[0]
    takes_p, free_p = plain_single(args)
    torch.cuda.synchronize()
    assert torch.equal(takes_k.reshape(takes_p.shape), takes_p)
    assert bitwise_equal(free_k, free_p.T)
    assert launch_counts["waterfill"] == n + 1
    assert ops.route_counts[instance] == routes[instance] + 1
    assert ops.kind_counts["single"] == kinds["single"] + 1


def test_route_picks_the_instance(cuda):
    mm = TorchMatchmaker(device=cuda)
    keys = ("freeT", "want", "safe", "big", "crow", "inv")
    for W, dtype, want in ((100, "float64", "staged"),
                           (6100, "float64", "staged"),
                           (6200, "float64", "staged"),
                           (8100, "float32", "staged"),
                           (8300, "float64", "rounds")):
        p = problem(W, C=20, W=W)
        args, _ = TorchMatchmaker(device=cuda, dtype=dtype).kernel_inputs(p)
        assert ops.route(*(args[k] for k in keys)) == want, (W, dtype)
        _n, routes, _k = counts()
        waterfill(**args)
        assert ops.route_counts[want] == routes[want] + 1
    args, _ = mm.kernel_inputs(problem(3, C=20, W=30))
    moved = torch.empty(args["want"].numel() + 1, dtype=torch.float64,
                        device=cuda)[1:].view_as(args["want"])
    moved.copy_(args["want"])
    args["want"] = moved
    _n, routes, _k = counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        waterfill(**args)
    assert ops.route_counts == routes


@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("fractional", [False, True])
def test_cycles_kernel_equals_plain_loop(cuda, K, fractional):
    """One launch for K cycles against the plain loop on the same tensors
    (takes, each cycle's free bitwise, totals); the takes hold the rows
    of the chunks that ran, in order."""
    p = problem(K + 10 * fractional, C=150, W=90, fractional=fractional)
    p.demand = np.zeros_like(p.demand)
    deltas = fused_deltas(np.random.default_rng(K), p, K)
    a, _ = TorchMatchmaker(device=cuda).cycles_inputs(p, deltas)
    Wp = a["crow"].shape[2]
    n, routes, kinds = counts()
    out = ops.waterfill_cycles(**a)
    assert launch_counts["waterfill"] == n + 1
    assert ops.kind_counts["cycles"] == kinds["cycles"] + 1
    assert ops.route_counts["staged"] == routes["staged"] + 1
    takes_p, free_p, tot_p = waterfill_cycles_reference(
        a["freeT"].T, a["want"].reshape(-1, 6), a["demand"].reshape(-1),
        a["arrivals"].reshape(K, -1), a["free_add"].transpose(1, 2),
        a["add_free"], a["budgets"], a["crow"].reshape(-1, Wp))
    torch.cuda.synchronize()
    dense = ops.dense_takes(out)
    assert torch.equal(dense.reshape(K, -1, Wp), takes_p)
    assert bitwise_equal(out.free, free_p.transpose(1, 2))
    assert torch.equal(out.totals.reshape(K, -1), tot_p)
    live = out.ran.reshape(-1)
    assert torch.equal(out.takes[:int(live.sum())],
                       dense.reshape(-1, 64, Wp)[live])


@pytest.mark.parametrize("with_demands", [False, True])
def test_preview_kernel_equals_plain_loop(cuda, with_demands):
    p = problem(31, C=150, W=90)
    rng = np.random.default_rng(5)
    frees = [p.free * s for s in (0.0, 0.5, 1.0, 2.0, 1.0, 0.5, 2.0, 3.0)]
    demands = ([rng.integers(0, 40, p.n_cohorts) for _ in frees]
               if with_demands else None)
    a, _ = TorchMatchmaker(device=cuda).preview_inputs(p, frees, demands)
    Wp = a["crow"].shape[2]
    n, _routes, kinds = counts()
    out = ops.waterfill_preview(**a)
    assert launch_counts["waterfill"] == n + 1
    assert ops.kind_counts["preview"] == kinds["preview"] + 1
    want = waterfill_preview_reference(
        a["frees"].transpose(1, 2), a["demands"].reshape(len(frees), -1),
        a["want"].reshape(-1, 6), a["crow"].reshape(-1, Wp))
    torch.cuda.synchronize()
    assert torch.equal(out.totals.reshape(len(frees), -1), want)


def test_skipped_chunks_take_zero_rows_without_a_memset(cuda):
    """A pool that drains in the first chunk: the later chunks are
    skipped; the solve is one kernel launch and no memset, writes only
    the ran chunk's rows, and `waterfill`'s dense takes (spread from
    them in the wrapper) are zero for the skipped chunks, from memory
    that held something else."""
    from torch.profiler import ProfilerActivity, profile
    p = problem(9, C=600, W=4)
    args, _ = TorchMatchmaker(device=cuda).kernel_inputs(p)
    nch, chunk, _r = args["want"].shape
    Wp = args["crow"].shape[2]
    junk = torch.full((nch * chunk * Wp,), -7, dtype=torch.int32,
                      device=cuda)
    del junk                       # its block goes back to the allocator
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = ops.waterfill_solve(**args)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "staged_kernel" in names[0], names
    assert not bool(out.ran.all())
    junk = torch.full((nch * chunk * Wp,), -7, dtype=torch.int32,
                      device=cuda)
    del junk
    takes, _free, ran = waterfill(**args)
    skipped = ~ran
    assert bool(skipped.any())
    assert int(takes[skipped].abs().sum()) == 0
    takes_p, _ = plain_single(args)
    assert torch.equal(takes.reshape(takes_p.shape), takes_p)


@pytest.mark.parametrize("instance", ["staged", "rounds"])
def test_drain_guard_leaves_zero_minima_out(cuda, instance):
    """A memory a rounding below zero must not retire a worker for a
    cohort that asks no memory: 3 claims, as the NumPy backend makes."""
    from repro_torch.core.matchmaker import MatchProblem
    p = guard_problem(MatchProblem)
    args, _ = TorchMatchmaker(device=cuda).kernel_inputs(p)
    out = ops._waterfill_instance(instance, **args)
    takes, ran = ops.dense_takes(out)[0], out.ran[0]
    assert bool(ran[0]) and int(takes[0, 0, 0]) == 3
    assert TorchMatchmaker(device=cuda).match(p).claimed == 3


def test_fused_matchmaker_calls_equal_numpy(cuda):
    from repro_torch.core.matchmaker.base import (
        sequential_match_cycles, sequential_preview_many,
    )
    mm, ref = TorchMatchmaker(device=cuda), NumpyMatchmaker()
    p = problem(41, C=150, W=90, fractional=True)
    q = problem(41, C=150, W=90, fractional=True)
    q.demand = np.zeros_like(q.demand)
    deltas = fused_deltas(np.random.default_rng(3), q, 8)
    for a, b in zip(mm.match_cycles(q, deltas),
                    sequential_match_cycles(ref, q, deltas)):
        np.testing.assert_array_equal(a.takes, b.takes)
        np.testing.assert_array_equal(a.free_after, b.free_after)
    frees = [p.free, p.free * 0.5]
    for a, b in zip(mm.preview_many(p, frees, session="s"),
                    sequential_preview_many(ref, p, frees)):
        np.testing.assert_array_equal(a, b)



def assert_kernel_matches_plain(q, k, v, qp, kp, **kw):
    before, routed = launch_counts["flash_attention"], dict(flash_routes)
    out = flash_attention(q, k, v, qp, kp, **kw)
    assert launch_counts["flash_attention"] == before + 1
    want = flash_route(q.dtype, q.shape[1], q.shape[2], k.shape[2],
                       q.shape[3])
    assert {n: flash_routes[n] - routed[n] for n in routed} == {
        n: int(n == want) for n in routed}
    ref = attention_reference(q.float(), k.float(), v.float(), qp, kp, **kw)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    return out


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_equals_plain_version(cuda, case, dtype):
    B, Sq, Skv, Hq, Hkv, Dh, causal, window, softcap = case
    q, k, v, qp, kp = attention_inputs(0, B, Sq, Skv, Hq, Hkv, Dh, dtype,
                                       cuda)
    assert_kernel_matches_plain(q, k, v, qp, kp, causal=causal,
                                window=window, softcap=softcap)


@pytest.mark.parametrize("label,seed,B,Sq,Skv,lengths", serving_shapes())
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_qwen2_serving_shapes(cuda, label, seed, B, Sq, Skv,
                                              lengths, dtype):
    """Prefill and decode at qwen2-1.5b's attention widths (12 query
    heads over 2 kv heads, d_head 128), with empty slots."""
    q, k, v, qp, kp = attention_inputs(seed, B, Sq, Skv, 12, 2, 128, dtype,
                                       cuda, lengths=lengths)
    assert_kernel_matches_plain(q, k, v, qp, kp, causal=True)


@pytest.mark.parametrize("call", MODAL_FLASH_CALLS, ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_modal_calls(cuda, call, dtype):
    """whisper-medium's encoder, cross and decoder calls (G = 1 at Dh 64,
    1500 frames, no causal mask on the encoder and cross calls) and
    llava's prefix prefill and tick."""
    _, inputs, kw, _ = modal_flash_inputs(call, dtype, cuda)
    assert_kernel_matches_plain(*inputs, **kw)


def test_flash_fully_masked_rows_give_zero(cuda):
    check_fully_masked_rows(flash_attention, cuda)


def test_flash_rolling_window_is_permutation_invariant(cuda):
    check_rolling_window(flash_attention, cuda)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, qp, kp = attention_inputs(4, 1, 4, 8, 2, 1, 32, torch.float32,
                                       cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half(), qp, kp)
    with pytest.raises(TypeError, match="q_pos"):
        flash_attention(q, k, v, qp.long(), kp)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, torch.cat([k, k], dim=-1)[..., :32], v, qp, kp)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :16].contiguous(), k[..., :16].contiguous(),
                        v[..., :16].contiguous(), qp, kp)


@pytest.mark.parametrize("case", FLASH_WGMMA_CASES)
def test_flash_tensor_cores_take_edge_cases(cuda, case):
    """Sq and Skv ending inside a tile, Sq > Skv, G = 6 and G = 3, a
    window, a softcap, no causal mask, a batch row whose cache is empty,
    one and two consumer warpgroups a block."""
    inputs, kw = flash_wgmma_inputs(case, cuda)
    out = assert_kernel_matches_plain(*inputs, **kw)
    if case[-1]:                    # the empty row attends nothing: zeros
        assert not bool(out[-1].any())


@pytest.mark.parametrize("case", FLASH_GROUP_CASES)
def test_flash_tensor_cores_take_the_new_group_sizes(cuda, case):
    """G = 9, 8 and 5 at Dh 128 (starcoder2-7b, qwen3-32b, llama4-scout):
    7, 8 and 12 positions a warpgroup, Sq ending inside a packed tile,
    an empty batch row; two calls bitwise equal."""
    inputs, kw = flash_wgmma_inputs(case, cuda)
    out = assert_kernel_matches_plain(*inputs, **kw)
    if case[-1]:                    # the empty row attends nothing: zeros
        assert not bool(out[-1].any())
    assert bitwise_equal(out, flash_attention(*inputs, **kw))


@pytest.mark.parametrize("Hq,Hkv", FLASH_GROUP_DECODE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_split_takes_the_new_group_sizes(cuda, Hq, Hkv, dtype):
    """A decode tick of 8 slots at G = 9, 8 and 5 on the split: 9, 8 and
    5 live rows of a block's 32; two calls bitwise equal."""
    inputs = flash_group_decode_inputs(Hq, Hkv, dtype, cuda)
    out = assert_kernel_matches_plain(*inputs, causal=True)
    assert bitwise_equal(out, flash_attention(*inputs, causal=True))


@pytest.mark.parametrize("call", CONFIG_FLASH_CALLS, ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_config_calls(cuda, call, dtype):
    """granite-8b's, starcoder2-7b's, qwen3-32b's and llama4-scout's
    1024-token prefill and decode tick."""
    _, inputs, kw, _ = modal_flash_inputs(call, dtype, cuda)
    assert_kernel_matches_plain(*inputs, **kw)


def flash_instance_inputs(instance, device):
    """A call of each instance: qwen2's decode tick (split), its 512-token
    prefill in bfloat16 (wgmma) and in float32 (simt)."""
    label, seed, B, Sq, Skv, lengths = serving_shapes()[
        2 if instance == "split" else 0]
    dtype = torch.float32 if instance == "simt" else torch.bfloat16
    return attention_inputs(seed, B, Sq, Skv, 12, 2, 128, dtype, device,
                            lengths=lengths)


@pytest.mark.parametrize("instance", ["split", "wgmma", "simt"])
def test_flash_instances_are_deterministic(cuda, instance):
    """Two calls give the same bits: the split's parts merge in a fixed
    order, and no instance uses atomics."""
    q, k, v, qp, kp = flash_instance_inputs(instance, cuda)
    before = dict(flash_routes)
    a = flash_attention(q, k, v, qp, kp)
    b = flash_attention(q, k, v, qp, kp)
    assert flash_routes[instance] == before[instance] + 2
    assert bitwise_equal(a.float(), b.float())


def test_flash_wrapper_refuses_what_no_instance_takes(cuda):
    q, k, v, qp, kp = attention_inputs(4, 1, 64, 64, 12, 2, 64,
                                       torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous(), qp, kp)
    with pytest.raises(ValueError, match="at most 32 per group"):
        flash_attention(torch.cat([q] * 3, dim=2), k[:, :, :1].contiguous(),
                        v[:, :, :1].contiguous(), qp, kp)
    flat = torch.empty(q.numel() + 8, dtype=q.dtype, device=cuda)
    shifted = flat[1:1 + q.numel()].view(q.shape)       # 2 bytes off
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(shifted, k, v, qp, kp)
    with pytest.raises(ValueError, match="kv_pos"):
        flash_attention(q, k, v, qp, kp[:, :8].contiguous())
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, qp, kp, window=0)


def assert_ssd_matches_plain(case, seed, dtype, device, inputs=None):
    B, S, H, P, G, N, chunk, init = case[:8]
    x, dt, A, Bm, Cm, D, st = inputs or ssd_inputs(seed, B, S, H, P, G, N,
                                                   init, dtype, device)
    want = ssd_route(dtype, P, N, chunk)
    before, routed = launch_counts["ssd"], dict(ssd_routes)
    y, fin = ssd(x, dt, A, Bm, Cm, D, chunk=chunk, initial_state=st)
    assert launch_counts["ssd"] == before + 1
    assert {k: ssd_routes[k] - routed[k] for k in routed} == {
        k: int(k == want) for k in routed}
    plain = ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk, initial_state=st)
    oracle = ssd_reference(x, dt, A, Bm, Cm, D, initial_state=st)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    assert fin.dtype == torch.float32 and fin.shape == (B, H, P, N)
    tol = SSD_TOL[dtype]
    for yr, fr in (plain, oracle):
        torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(fin, fr, atol=tol, rtol=tol)
    return y, fin


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_equals_plain_version(cuda, case, dtype):
    assert_ssd_matches_plain(case, 0, dtype, cuda)


@pytest.mark.parametrize("label,seed,case", ssd_serving_cases())
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_at_mamba2_serving_shapes(cuda, label, seed, case, dtype):
    assert_ssd_matches_plain(case, seed, dtype, cuda)


def test_ssd_kernel_reads_views_through_their_strides(cuda):
    """x, B and C as views of one fused projection, as the model passes
    them: the kernel's result is the contiguous copies' result."""
    B, S, H, P, G, N = 2, 100, 4, 32, 2, 16
    x, dt, A, Bm, Cm, D, _ = ssd_inputs(8, B, S, H, P, G, N, False,
                                        torch.bfloat16, cuda)
    fused = torch.cat([x.flatten(2), Bm.flatten(2), Cm.flatten(2)], dim=-1)
    xv, bv, cv = torch.split(fused, [H * P, G * N, G * N], dim=-1)
    y, fin = ssd(xv.unflatten(-1, (H, P)), dt, A, bv.unflatten(-1, (G, N)),
                 cv.unflatten(-1, (G, N)), D, chunk=32)
    y_c, fin_c = ssd(x, dt, A, Bm, Cm, D, chunk=32)
    assert torch.equal(y, y_c) and torch.equal(fin, fin_c)


@pytest.mark.parametrize("case", SSD_TC_CASES)
def test_ssd_tensor_cores_take_edge_cases(cuda, case):
    """S = 1, 63, 65, 200 and 777 (a tile, a chunk ending inside a tile),
    one chunk and several, 2 and 4 heads a group, N and P 64 and 128,
    with and without an initial state, strided views of one projection."""
    assert_ssd_matches_plain(case, 6, torch.bfloat16, cuda,
                             inputs=ssd_tc_inputs(case, cuda))


@pytest.mark.parametrize("label,seed,case", ssd_timed_cases())
def test_ssd_kernel_at_the_timed_shapes(cuda, label, seed, case):
    """mamba2's and jamba's bfloat16 prefill at S = 512 and 1024."""
    assert_ssd_matches_plain(case, seed, torch.bfloat16, cuda)


@pytest.mark.parametrize("instance", ["mma", "simt"])
def test_ssd_instances_are_deterministic(cuda, instance):
    """Two calls give the same bits: no atomics, and each pass sums in a
    fixed order.  mamba2's 1024-token prefill with an initial state."""
    x, dt, A, Bm, Cm, D, st = ssd_inputs(11, 1, 1024, 64, 64, 1, 128, True,
                                         torch.bfloat16, cuda)
    a = _ssd_instance(instance, x, dt, A, Bm, Cm, D, initial_state=st)
    b = _ssd_instance(instance, x, dt, A, Bm, Cm, D, initial_state=st)
    assert all(bitwise_equal(u.float(), v.float()) for u, v in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_route_counts_move_by_one_per_call(cuda, dtype):
    """Each call adds one launch, on the instance `ssd_route` predicts,
    whatever the number of passes."""
    x, dt, A, Bm, Cm, D, st = ssd_inputs(12, 1, 300, 4, 64, 1, 64, True,
                                         dtype, cuda)
    want = ssd_route(dtype, 64, 64, 256)
    for n in range(1, 4):
        before, routed = launch_counts["ssd"], dict(ssd_routes)
        ssd(x, dt, A, Bm, Cm, D, initial_state=st)
        assert launch_counts["ssd"] == before + 1
        assert ssd_routes[want] == routed[want] + 1
        assert sum(ssd_routes.values()) == sum(routed.values()) + 1


def test_ssd_wrapper_refuses_what_no_instance_takes(cuda):
    x, dt, A, Bm, Cm, D, st = ssd_inputs(13, 1, 64, 2, 64, 1, 64, True,
                                         torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ssd(torch.cat([x, x[..., :32]], dim=-1), dt, A, Bm, Cm, D)
    with pytest.raises(ValueError, match="d_state"):
        ssd(x, dt, A, torch.cat([Bm] * 4, dim=-1),
            torch.cat([Cm] * 4, dim=-1), D)
    with pytest.raises(ValueError, match="chunk"):
        ssd(x, dt, A, Bm, Cm, D, chunk=320)
    with pytest.raises(ValueError, match="does not take"):
        _ssd_instance("mma", x.float(), dt, A, Bm.float(), Cm.float(), D)
    with pytest.raises(ValueError, match="does not take"):
        _ssd_instance("mma", x, dt, A, Bm, Cm, D, chunk=100)
    with pytest.raises(ValueError, match="no instance"):
        _ssd_instance("wgmma", x, dt, A, Bm, Cm, D)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, A, Bm, Cm, D, st = ssd_inputs(9, 1, 16, 2, 16, 1, 16, True,
                                         torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd(x.half(), dt, A, Bm.half(), Cm.half(), D)
    with pytest.raises(TypeError, match="Bm"):
        ssd(x, dt, A, Bm.bfloat16(), Cm, D)
    with pytest.raises(TypeError, match="dt"):
        ssd(x, dt.double(), A, Bm, Cm, D)
    with pytest.raises(ValueError, match="last axis"):
        ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm, D)
    with pytest.raises(ValueError, match="dt must be contiguous"):
        ssd(x, dt.transpose(1, 2).contiguous().transpose(1, 2), A, Bm, Cm,
            D)
    with pytest.raises(ValueError, match="head dim"):
        ssd(x[..., :8], dt, A, Bm, Cm, D)
    with pytest.raises(ValueError, match="d_state"):
        ssd(x, dt, A, Bm[..., :8], Cm[..., :8], D)
    with pytest.raises(ValueError, match="chunk"):
        ssd(x, dt, A, Bm, Cm, D, chunk=512)
    with pytest.raises(ValueError, match="initial_state"):
        ssd(x, dt, A, Bm, Cm, D, initial_state=st[..., :8])


def assert_gmm_matches_plain(lhs, rhs, gs, out_dtype=None):
    before, routed = launch_counts["gmm"], dict(route_counts)
    out = gmm(lhs, rhs, gs, out_dtype=out_dtype)
    assert launch_counts["gmm"] == before + 1
    want = gmm_route(lhs.dtype, lhs.shape[1], rhs.shape[2])
    assert {k: route_counts[k] - routed[k] for k in routed} == {
        k: int(k == want) for k in routed}
    ref = gmm_plain(lhs, rhs, gs, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == (out_dtype or lhs.dtype)
    assert out.shape == (lhs.shape[0], rhs.shape[2])
    tol = GMM_TOL[lhs.dtype]
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    return out


@pytest.mark.parametrize("case", GMM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_equals_plain_version(cuda, case, dtype):
    E, K, N, _bt, sizes, tail = case
    assert_gmm_matches_plain(*gmm_inputs(0, E, K, N, sizes, tail, dtype,
                                         cuda))


@pytest.mark.parametrize("case", GMM_RAGGED)
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.float32)])
def test_gmm_kernel_takes_ragged_groups(cuda, case, dtype, out_dtype):
    E, K, N, sizes, tail = case
    out = assert_gmm_matches_plain(
        *gmm_inputs(1, E, K, N, sizes, tail, dtype, cuda), out_dtype)
    assert not bool(out[sum(sizes):].any())


@pytest.mark.parametrize("label,rows,K,N", moe_serving_shapes())
def test_gmm_kernel_at_jamba_serving_shapes(cuda, label, rows, K, N):
    lhs, rhs, gs = moe_serving_inputs(rows, K, N, torch.bfloat16, cuda)
    assert gmm_route(lhs.dtype, K, N) == "wgmma"
    assert_gmm_matches_plain(lhs, rhs, gs, torch.float32)


def test_stacked_dense_init_holds_one_layer_in_float32(cuda, monkeypatch):
    """A stacked bfloat16 weight over `DENSE_DRAW_MAX` values is drawn a
    layer at a time: the peak over the output is one layer's float32 draw
    and trunc_normal_'s own temporaries of it, not the stack's float32
    copy (qwen3-32b's MLP weights could not be made on one card that
    way)."""
    from repro_torch.models import param
    from repro_torch.models.param import Init
    monkeypatch.setattr(param, "DENSE_DRAW_MAX", 1024 * 4096)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    layers, shape = 16, (1024, 4096)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    w = Init(gen, cuda).stacked(layers).dense(shape, "bfloat16")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    layer_f32 = shape[0] * shape[1] * 4
    assert w.shape == (layers, *shape) and w.dtype == torch.bfloat16
    assert peak <= w.numel() * 2 + 4 * layer_f32 < layers * layer_f32


@pytest.mark.parametrize("label,rows,K,N",
                         moe_serving_shapes(LLAMA4_ARCH, LLAMA4_PREFILLS))
def test_gmm_kernel_at_llama4_serving_shapes(cuda, label, rows, K, N):
    """llama4-scout's expert products (16 experts, 5120 <-> 8192, top-1
    at capacity 1.25) at a 1024-token prefill and a decode tick."""
    lhs, rhs, gs = moe_serving_inputs(rows, K, N, torch.bfloat16, cuda,
                                      arch=LLAMA4_ARCH)
    assert gmm_route(lhs.dtype, K, N) == "wgmma"
    assert_gmm_matches_plain(lhs, rhs, gs, torch.float32)


@pytest.mark.parametrize("case", GMM_TC_CASES)
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_gmm_tensor_cores_take_edge_cases(cuda, case, out_dtype):
    """One group holding every row while the mean group is small, a group
    shorter than a row tile between two long ones, N not a multiple of the
    column tile, K and N ending inside a TMA box; bfloat16 and float32
    output; the tail rows stay zero."""
    E, K, N, sizes, tail = case
    out = assert_gmm_matches_plain(
        *gmm_inputs(2, E, K, N, sizes, tail, torch.bfloat16, cuda), out_dtype)
    assert not bool(out[sum(sizes):].any())


def ragged_inputs(case, device):
    E, K, N, sizes, tail = case
    return gmm_inputs(2, E, K, N, sizes, tail, torch.bfloat16, device)


def decode_inputs(device):
    _label, rows, K, N = moe_serving_shapes()[-1]
    return moe_serving_inputs(rows, K, N, torch.bfloat16, device)


@pytest.mark.parametrize("inputs", [
    lambda dev: ragged_inputs(GMM_RAGGED[1], dev),
    lambda dev: ragged_inputs(GMM_TC_CASES[0], dev), decode_inputs],
    ids=["ragged", "one-group", "jamba-decode-down"])
def test_gmm_tensor_cores_are_deterministic(cuda, inputs):
    lhs, rhs, gs = inputs(cuda)
    for out_dtype in (torch.bfloat16, torch.float32):
        a = gmm(lhs, rhs, gs, out_dtype=out_dtype)
        b = gmm(lhs, rhs, gs, out_dtype=out_dtype)
        assert bitwise_equal(a.float(), b.float())


def test_gmm_stream_floor_probe_counts_nothing(cuda):
    """The stream-only probe runs the ring without its products: zeros,
    and no launch counted on the main path's counts."""
    E, K, N, sizes, tail = GMM_TC_CASES[1]
    lhs, rhs, gs = gmm_inputs(2, E, K, N, sizes, tail, torch.bfloat16, cuda)
    before, routed = dict(launch_counts), dict(route_counts)
    out = stream_floor(lhs, rhs, gs)
    torch.cuda.synchronize()
    assert not bool(out.any())
    assert launch_counts == before and route_counts == routed
    with pytest.raises(ValueError, match="tensor-core"):
        stream_floor(lhs.float(), rhs.float(), gs)


def test_gmm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    lhs, rhs, gs = gmm_inputs(3, 2, 16, 8, [3, 5], 0, torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gmm(lhs.half(), rhs.half(), gs)
    with pytest.raises(TypeError, match="rhs"):
        gmm(lhs, rhs.bfloat16(), gs)
    with pytest.raises(TypeError, match="out_dtype"):
        gmm(lhs, rhs, gs, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="group_sizes"):
        gmm(lhs, rhs, gs.long())
    with pytest.raises(ValueError, match="group_sizes"):
        gmm(lhs, rhs, gs.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        gmm(lhs.T.contiguous().T, rhs, gs)
    with pytest.raises(ValueError, match="K="):
        gmm(lhs[:, :8].contiguous(), rhs, gs)
    with pytest.raises(ValueError, match="shape"):
        gmm(lhs, rhs, gs[:1].contiguous())


# ---------------------------------------------------------------------------
# flash-attention backward and training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_equals_plain_version(cuda, case, dtype):
    inputs, kw, dout = flash_bwd_inputs(case, dtype, cuda)
    check_flash_bwd(f"case{case}", fa_ops, inputs, kw, dout, masked=case[9])


@pytest.mark.parametrize("instance", ["split", "wgmma", "simt"])
def test_flash_forward_lse_of_each_instance(cuda, instance):
    """Each forward instance's log-sum-exp (qwen2's decode tick, its
    bfloat16 and float32 prefill) against the plain one, and the output
    the same bits as `flash_attention`'s, which writes no lse."""
    q, k, v, qp, kp = flash_instance_inputs(instance, cuda)
    before = dict(flash_routes)
    out, lse = fa_ops.flash_attention_forward(q, k, v, qp, kp)
    assert flash_routes[instance] == before[instance] + 1
    check_lse(instance, q, k, v, qp, kp, lse, {})
    assert bitwise_equal(out.float(), flash_attention(q, k, v, qp,
                                                      kp).float())


@pytest.mark.parametrize("instance", ["split", "wgmma", "simt"])
def test_flash_forward_lse_of_rows_that_see_no_key(cuda, instance):
    """A row that sees no key gets lse = +inf on every instance."""
    dtype = torch.float32 if instance == "simt" else torch.bfloat16
    Sq = 1 if instance == "split" else 100
    q, k, v, qp, kp = attention_inputs(9, 2, Sq, 100, 12, 2, 128, dtype,
                                       cuda)
    kp[1] = -1
    out, lse = fa_ops.flash_attention_forward(q, k, v, qp, kp)
    check_lse(f"{instance}-masked", q, k, v, qp, kp, lse, {})
    assert bool(torch.isposinf(lse[1]).all())
    assert not bool(out[1].any())


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_route_on_every_case(cuda, case, dtype):
    inputs, _, _ = flash_bwd_inputs(case, dtype, cuda)
    assert fa_ops.bwd_route(*inputs[:3]) == flash_bwd_route(dtype, case[5])


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
@pytest.mark.parametrize("instance", ["wgmma", "simt"])
def test_flash_backward_instances_equal_plain_and_are_bitwise(cuda, case,
                                                              instance):
    """Each instance forced (`_backward_instance`): the SIMT one on every
    case in both dtypes, the tensor-core one on the bfloat16 cases it
    takes; each against the plain backward, two calls the same bits."""
    dtypes = [torch.bfloat16] if instance == "wgmma" else [torch.float32,
                                                            torch.bfloat16]
    if instance == "wgmma" and flash_bwd_route(torch.bfloat16,
                                               case[5]) != "wgmma":
        with pytest.raises(ValueError, match="does not take"):
            inputs, kw, dout = flash_bwd_inputs(case, torch.bfloat16, cuda)
            out, lse = fa_ops.flash_attention_forward(*inputs, **kw)
            fa_ops._backward_instance("wgmma", *inputs[:3], out, dout, lse,
                                      *inputs[3:], **kw)
        return
    for dtype in dtypes:
        inputs, kw, dout = flash_bwd_inputs(case, dtype, cuda)
        got, *_ = check_flash_bwd(f"{instance}{case}", fa_ops, inputs, kw,
                                  dout, masked=case[9], instance=instance)
        out, lse = fa_ops.flash_attention_forward(*inputs, **kw)
        again = fa_ops._backward_instance(instance, *inputs[:3], out, dout,
                                          lse, *inputs[3:], **kw)
        assert all(bitwise_equal(a.float(), b.float())
                   for a, b in zip(got, again))


@pytest.mark.parametrize("B,S", FLASH_BWD_TIMED)
def test_flash_backward_at_qwen2_training_shapes(cuda, B, S):
    case = (B, S, S, 12, 2, 128, True, None, None, 0)
    inputs, kw, dout = flash_bwd_inputs(case, torch.bfloat16, cuda)
    check_flash_bwd(f"qwen2-train-{B}x{S}", fa_ops, inputs, kw, dout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(cuda, dtype):
    """No atomics: on the tensor cores the packed rows (positions x the
    group's G heads) are the reduction dimension of dK and dV, so the sum
    over the group's heads happens inside one block, and its two consumer
    warpgroups' sums meet in a fixed order; the SIMT instance loops over
    the heads inside one block."""
    inputs, kw, dout = flash_bwd_inputs(FLASH_BWD_CASES[8], dtype, cuda)
    out, lse = fa_ops.flash_attention_forward(*inputs, **kw)
    a = fa_ops.flash_attention_backward(*inputs[:3], out, dout, lse,
                                        *inputs[3:], **kw)
    b = fa_ops.flash_attention_backward(*inputs[:3], out, dout, lse,
                                        *inputs[3:], **kw)
    assert all(bitwise_equal(x.float(), y.float()) for x, y in zip(a, b))


def test_autograd_through_flash_attention_launches_the_backward(cuda):
    """One forward launch (with its lse) and one backward launch, on the
    tensor cores; the gradients equal a direct backward call's."""
    inputs, kw, dout = flash_bwd_inputs(FLASH_BWD_CASES[2], torch.bfloat16,
                                        cuda)
    leaves = [t.clone().requires_grad_() for t in inputs[:3]]
    before, bwd_before = dict(launch_counts), dict(fa_ops.bwd_route_counts)
    out = flash_attention(*leaves, *inputs[3:], **kw)
    grads = torch.autograd.grad(out, leaves, dout.transpose(1, 2)
                                .contiguous().transpose(1, 2))
    assert launch_counts["flash_attention"] == before["flash_attention"] + 1
    assert launch_counts["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    assert fa_ops.bwd_route_counts["wgmma"] == bwd_before["wgmma"] + 1
    _, lse = fa_ops.flash_attention_forward(*inputs, **kw)
    want = fa_ops.flash_attention_backward(*inputs[:3], out.detach(), dout,
                                           lse, *inputs[3:], **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    backwards = launch_counts["flash_attention_bwd"]
    with torch.no_grad():
        flash_attention(*leaves, *inputs[3:], **kw)
    assert launch_counts["flash_attention_bwd"] == backwards


def test_flash_backward_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    (q, k, v, qp, kp), kw, dout = flash_bwd_inputs(FLASH_BWD_CASES[1],
                                                   torch.float32, cuda)
    out, lse = fa_ops.flash_attention_forward(q, k, v, qp, kp, **kw)
    bwd = fa_ops.flash_attention_backward
    with pytest.raises(TypeError, match="dout"):
        bwd(q, k, v, out, dout.bfloat16(), lse, qp, kp)
    with pytest.raises(ValueError, match="contiguous"):
        bwd(q, torch.cat([k, k], dim=-1)[..., :64], v, out, dout, lse, qp,
            kp)
    with pytest.raises(ValueError, match="out"):
        bwd(q, k, v, out[:, :1].contiguous(), dout, lse, qp, kp)
    with pytest.raises(ValueError, match="window"):
        bwd(q, k, v, out, dout, lse, qp, kp, window=0)
    with pytest.raises(ValueError, match="head dim"):
        bwd(*(t[..., :16].contiguous() for t in (q, k, v, out, dout)), lse,
            qp, kp)


def test_flash_backward_wrapper_refuses_a_bad_lse(cuda):
    """lse is required, float32, (B, Sq, Hq), on q's device."""
    (q, k, v, qp, kp), kw, dout = flash_bwd_inputs(FLASH_BWD_CASES[8],
                                                   torch.bfloat16, cuda)
    out, lse = fa_ops.flash_attention_forward(q, k, v, qp, kp, **kw)
    bwd = fa_ops.flash_attention_backward
    before = dict(launch_counts)
    with pytest.raises(TypeError, match="lse is required"):
        bwd(q, k, v, out, dout, None, qp, kp)
    with pytest.raises(TypeError):
        bwd(q, k, v, out, dout, qp, kp)             # lse left out
    with pytest.raises(ValueError, match="lse must have shape"):
        bwd(q, k, v, out, dout, lse[:, :-1].contiguous(), qp, kp)
    with pytest.raises(TypeError, match="lse must be torch.float32"):
        bwd(q, k, v, out, dout, lse.bfloat16(), qp, kp)
    with pytest.raises(ValueError, match="lse is on cpu"):
        bwd(q, k, v, out, dout, lse.cpu(), qp, kp)
    assert launch_counts == before


def test_matmul_f32_gradient(cuda):
    """bfloat16 operands: the forward accumulates in float32 (unchanged),
    the backward's products take the cotangent rounded to bfloat16 and
    return each gradient in its operand's dtype; both gradients agree
    with float32 autograd of ``x.float() @ w.float()`` within bfloat16's
    rounding (the cotangent's and the result's: 1e-2 of each gradient's
    max), and each operand alone gets its gradient."""
    from repro_torch.models.layers import matmul_f32
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((2, 48, 64), generator=gen, device=cuda).bfloat16()
    w = torch.randn((64, 96), generator=gen, device=cuda).bfloat16()
    dy = torch.randn((2, 48, 96), generator=gen, device=cuda)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = matmul_f32(xr, wr)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x.float() @ w.float(), atol=1e-4,
                               rtol=1e-5)
    dx, dw = torch.autograd.grad(y, (xr, wr), dy)
    assert dx.dtype == dw.dtype == torch.bfloat16
    dyb = dy.bfloat16().float()
    torch.testing.assert_close(dx.float(), dyb @ w.float().T, atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(dw.float(), (x.float().reshape(-1, 64).T
                                            @ dyb.reshape(-1, 96)),
                               atol=2e-2, rtol=2e-2)
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    dx_ref, dw_ref = torch.autograd.grad(xf @ wf, (xf, wf), dy)
    for got, want in ((dx, dx_ref), (dw, dw_ref)):
        err = (got.float() - want).abs().max() / want.abs().max()
        assert float(err) <= 1e-2
    (dx_only,) = torch.autograd.grad(matmul_f32(xr, w), xr, dy)
    (dw_only,) = torch.autograd.grad(matmul_f32(x, wr), wr, dy)
    assert torch.equal(dx_only, dx) and torch.equal(dw_only, dw)


def test_dense_model_gradients_on_the_card_match_the_cpu(cuda):
    """A small qwen2 (d_head 32, float32): loss and gradients with the
    kernels on the card against the plain versions on the CPU."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import tree_leaves, tree_map
    cfg = dataclasses.replace(reduced_config("qwen2-1.5b"), d_head=32,
                              n_heads=6, n_kv_heads=1)
    params = model_lib.init_model(cfg, device="cpu")
    tok = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 65)), dtype=torch.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def grads(ps, device):
        req = tree_map(lambda p: p.to(device).requires_grad_(), ps)
        loss, _ = model_lib.loss_fn(req, cfg, batch, remat="full")
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(req))

    before = dict(launch_counts)
    loss, g = grads(params, cuda)
    assert launch_counts["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + cfg.n_layers
    loss_cpu, g_cpu = grads(params, "cpu")
    assert abs(float(loss) - float(loss_cpu)) <= 1e-5 * abs(float(loss_cpu))
    for a, b in zip(g, g_cpu):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max().clamp(min=1e-30))


# ---------------------------------------------------------------------------
# the SSD scan's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_equals_plain_version(cuda, case, dtype):
    """Each gradient within 1e-4 (f32) / 2e-2 (bf16) of its max, on the
    routed instance, two calls bitwise; a final-state gradient where the
    case has an initial state."""
    check_ssd_bwd(f"bwd{case}", ssd_ops, case, 0, dtype, cuda,
                  dfinal=case[7])


@pytest.mark.parametrize("case", SSD_TC_CASES)
def test_ssd_backward_tensor_cores_take_edge_cases(cuda, case):
    """One step, a chunk ending inside a tile, a one-row second chunk, a
    ragged last chunk, 2 and 4 heads a group, P and N 64 and 128, fused
    views of one projection."""
    check_ssd_bwd(f"bwd-tc{case}", ssd_ops, case, 6, torch.bfloat16, cuda,
                  inputs=ssd_tc_inputs(case, cuda), dfinal=True)


@pytest.mark.parametrize("case", SSD_BWD_TC_CASES)
def test_ssd_backward_tensor_core_pass_edges(cuda, case):
    """The key and query passes' own edges: two splits a group (the
    scores read by group), a short last key tile, S under one tile, P 64
    with N 64 and 128, an odd split (the second warpgroup idle), P 128
    (one head a stage), an initial state with a final-state gradient;
    two calls bitwise."""
    check_ssd_bwd(f"bwd-tc-edge{case}", ssd_ops, case, 9, torch.bfloat16,
                  cuda, dfinal=case[7])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_with_a_final_state_gradient(cuda, dtype):
    check_ssd_bwd(f"bwd-dfinal{SSD_BWD_DFINAL}", ssd_ops, SSD_BWD_DFINAL, 3,
                  dtype, cuda, dfinal=True)


@pytest.mark.parametrize("case", SSD_TC_CASES)
def test_ssd_backward_simt_takes_the_tensor_core_states(cuda, case):
    """The SIMT instance forced on the tensor-core forward's bf16 hi + lo
    states: the same gates."""
    check_ssd_bwd(f"bwd-tc{case}-simt", ssd_ops, case, 6, torch.bfloat16,
                  cuda, inputs=ssd_tc_inputs(case, cuda), dfinal=True,
                  instance="simt")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_recorded_call_launches_the_backward(cuda, dtype):
    """Autograd through `ssd`: one forward launch, then one backward
    launch on the instance `ssd_route` names; the gradients are the
    backward's on the states the forward kept."""
    x, dt, A, Bm, Cm, D, st = ssd_inputs(14, 1, 300, 4, 64, 1, 64, True,
                                         dtype, cuda)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D, st)]
    want = ssd_route(dtype, 64, 64, 256)
    before, routed = dict(launch_counts), dict(ssd_ops.bwd_route_counts)
    y, fin = ssd(*leaves[:6], initial_state=leaves[6])
    assert launch_counts["ssd"] == before["ssd"] + 1
    assert launch_counts["ssd_bwd"] == before["ssd_bwd"]
    dy = torch.randn(y.shape, device=cuda).to(dtype)
    grads = torch.autograd.grad((y.float() * dy.float()).sum()
                                + fin.sum(), leaves)
    assert launch_counts["ssd_bwd"] == before["ssd_bwd"] + 1
    assert ssd_ops.bwd_route_counts[want] == routed[want] + 1
    assert sum(ssd_ops.bwd_route_counts.values()) == sum(routed.values()) + 1
    _, _, kept = ssd_ops.ssd_forward(x, dt, A, Bm, Cm, D, initial_state=st)
    again = ssd_ops.ssd_backward(x, dt, A, Bm, Cm, D, dy, initial_state=st,
                                 dfinal=torch.ones_like(fin), kept=kept)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_ssd_backward_wrapper_refuses_bad_states(cuda):
    x, dt, A, Bm, Cm, D, st = ssd_inputs(15, 1, 128, 2, 64, 1, 64, True,
                                         torch.bfloat16, cuda)
    dy = torch.ones_like(x)
    _, _, kept = ssd_ops.ssd_forward(x, dt, A, Bm, Cm, D, initial_state=st)
    _, _, kept_f32 = ssd_ops._launch(
        "simt", ssd_ops._checked(x, dt, A, Bm, Cm, D, 256, st), x, dt, A, Bm,
        Cm, D, 256, st, keep=True)
    bwd = ssd_ops.ssd_backward
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="kept entering states"):
        bwd(x, dt, A, Bm, Cm, D, dy, initial_state=st)
    with pytest.raises(ValueError, match="kept must have shape"):
        bwd(x, dt, A, Bm, Cm, D, dy, initial_state=st, kept=kept[:, :, :1])
    with pytest.raises(ValueError, match="mma instance reads"):
        bwd(x, dt, A, Bm, Cm, D, dy, initial_state=st, kept=kept_f32)
    with pytest.raises(TypeError, match="dfinal"):
        bwd(x, dt, A, Bm, Cm, D, dy, initial_state=st, kept=kept,
            dfinal=torch.ones_like(st).double())
    assert launch_counts["ssd_bwd"] == before["ssd_bwd"]
    got = ssd_ops._backward_instance("simt", x, dt, A, Bm, Cm, D, dy,
                                     initial_state=st, kept=kept_f32)
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)


def test_mamba2_gradients_on_the_card_match_the_cpu(cuda):
    """A small mamba2 (float32): loss and gradients with the kernels on
    the card (one scan and one backward a layer) against the plain
    versions on the CPU."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import tree_leaves, tree_map
    cfg = reduced_config("mamba2-1.3b")
    params = model_lib.init_model(cfg, device="cpu")
    tok = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 97)), dtype=torch.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def grads(ps, device):
        req = tree_map(lambda p: p.to(device).requires_grad_(), ps)
        loss, _ = model_lib.loss_fn(req, cfg, batch, remat="none")
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(req))

    before = dict(launch_counts)
    loss, g = grads(params, cuda)
    assert launch_counts["ssd"] == before["ssd"] + cfg.n_layers
    assert launch_counts["ssd_bwd"] == before["ssd_bwd"] + cfg.n_layers
    loss_cpu, g_cpu = grads(params, "cpu")
    assert abs(float(loss) - float(loss_cpu)) <= 1e-5 * abs(float(loss_cpu))
    for a, b in zip(g, g_cpu):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max().clamp(min=1e-30))


# ---------------------------------------------------------------------------
# the grouped matmul's backward
# ---------------------------------------------------------------------------

GMM_BWD_CASES = ([(E, K, N, sizes, tail) for E, K, N, _bt, sizes, tail
                  in GMM_CASES] + GMM_RAGGED + GMM_BWD_STAGE_CASES
                 + GMM_BWD_TILE_CASES)


@pytest.mark.parametrize("case", GMM_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_backward_equals_plain_version(cuda, case, dtype):
    check_gmm_bwd(f"bwd{case}", gmm_ops, *gmm_bwd_inputs(12, *case, dtype,
                                                         cuda))


@pytest.mark.parametrize("case", GMM_TC_CASES)
def test_gmm_backward_tensor_cores_take_edge_cases(cuda, case):
    check_gmm_bwd(f"bwd-tc{case}", gmm_ops,
                  *gmm_bwd_inputs(12, *case, torch.bfloat16, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_recorded_call_launches_the_backward(cuda, dtype):
    """Autograd through `gmm` on CUDA tensors: one forward and one
    backward launch on the routed instance, the gradients those of the
    plain backward, and only the gradients autograd asks for."""
    from repro_torch.kernels.moe_gmm.ref import gmm_backward_reference
    E, K, N, sizes, tail = GMM_RAGGED[1]
    lhs, rhs, gs, dout = gmm_bwd_inputs(13, E, K, N, sizes, tail, dtype,
                                        cuda)
    want = gmm_route(dtype, K, N)
    before, routed = dict(launch_counts), dict(gmm_ops.bwd_route_counts)
    lr, rr = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    out = gmm(lr, rr, gs, out_dtype=torch.float32)
    assert out.grad_fn is not None
    dl, dr = torch.autograd.grad(out, (lr, rr), dout)
    assert launch_counts["gmm"] == before["gmm"] + 1
    assert launch_counts["gmm_bwd"] == before["gmm_bwd"] + 1
    assert {k: gmm_ops.bwd_route_counts[k] - routed[k] for k in routed} == {
        k: int(k == want) for k in routed}
    plain = gmm_backward_reference(lhs, rhs, gs, dout)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, p in zip((dl, dr), plain):
        assert g.dtype == dtype
        assert float((g.float() - p.float()).abs().max()) <= tol * float(
            p.float().abs().max())
    (dl_only,) = torch.autograd.grad(gmm(lr, rhs, gs), lr,
                                     torch.ones(lhs.shape[0], N,
                                                dtype=dtype, device=cuda))
    assert dl_only.shape == lhs.shape
    only = gmm_ops.gmm_backward(lhs, rhs, gs, dout, need=(False, True))
    assert only[0] is None and torch.equal(only[1], dr)


@pytest.mark.parametrize("which", ["dlhs", "drhs"])
def test_gmm_backward_floor_probe_counts_nothing(cuda, which):
    """The backward's floor probe runs one gradient's kernel without its
    products: a launch, no count on the main path's counts, and it
    refuses a float32 cotangent and inputs the tensor cores do not
    take."""
    E, K, N, sizes, tail = GMM_BWD_TILE_CASES[0]
    lhs, rhs, gs, dout = gmm_bwd_inputs(15, E, K, N, sizes, tail,
                                        torch.bfloat16, cuda)
    before, routed = dict(launch_counts), dict(gmm_ops.bwd_route_counts)
    out = gmm_ops.bwd_stream_floor(lhs, rhs, gs, dout.bfloat16(), which)
    torch.cuda.synchronize()
    assert out.shape == (lhs if which == "dlhs" else rhs).shape
    assert launch_counts == before and gmm_ops.bwd_route_counts == routed
    with pytest.raises(ValueError, match="tensor-core"):
        gmm_ops.bwd_stream_floor(lhs, rhs, gs, dout, which)
    with pytest.raises(TypeError, match="rhs"):
        gmm_ops.bwd_stream_floor(lhs, rhs.float(), gs, dout.bfloat16(),
                                 which)


def test_gmm_backward_drhs_grid_fits_the_card(cuda):
    """drhs's persistent grid: at least one cluster of two blocks, at
    most one block an SM."""
    n = gmm_ops.drhs_clusters(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 1 <= n and 2 * n <= sms


def test_gmm_backward_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    lhs, rhs, gs, dout = gmm_bwd_inputs(14, 2, 16, 8, [3, 5], 0,
                                        torch.float32, cuda)
    bwd = gmm_ops.gmm_backward
    before = dict(launch_counts)
    with pytest.raises(TypeError, match="dout"):
        bwd(lhs, rhs, gs, dout.half())
    with pytest.raises(ValueError, match="dout must have shape"):
        bwd(lhs, rhs, gs, dout[:, :4])
    with pytest.raises(ValueError, match="dout is on cpu"):
        bwd(lhs, rhs, gs, dout.cpu())
    with pytest.raises(TypeError, match="rhs"):
        bwd(lhs, rhs.bfloat16(), gs, dout)
    with pytest.raises(TypeError, match="group_sizes"):
        bwd(lhs, rhs, gs.long(), dout)
    assert bwd(lhs, rhs, gs, dout, need=(False, False)) == (None, None)
    assert launch_counts == before


def test_moe_serving_launches_no_backward(cuda):
    """The MoE layer under `torch.no_grad()` (serving), with parameters
    that require grad: the three expert products launch as before, on
    the tensor cores in bfloat16, and nothing records a graph."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.param import Init
    cfg = dataclasses.replace(reduced_config("jamba-v0.1-52b"),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = {k: v.requires_grad_() if k != "shared" else v
         for k, v in moe_mod.init_moe(Init(gen, cuda), cfg).items()}
    x = torch.randn((2, 32, cfg.d_model), generator=gen,
                    device=cuda).bfloat16()
    before, routed = dict(launch_counts), dict(route_counts)
    with torch.no_grad():
        y, _ = moe_mod.moe_forward_dense(p, cfg, x)
    assert y.grad_fn is None
    assert {k: launch_counts[k] - before[k] for k in before} == {
        k: 3 * (k == "gmm") for k in before}
    assert {k: route_counts[k] - routed[k] for k in routed} == {
        "wgmma": 3, "simt": 0}


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "llama4-scout-17b-a16e"])
def test_moe_model_gradients_on_the_card_match_the_cpu(cuda, arch):
    """Small jamba and llama4-scout (float32, head dim 32): loss and
    gradients with the kernels on the card (three `gmm` launches and three
    `gmm_bwd` launches an MoE layer) against the plain versions on the
    CPU."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import tree_leaves, tree_map
    cfg = dataclasses.replace(reduced_config(arch), d_head=32)
    params = model_lib.init_model(cfg, device="cpu")
    tok = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 65)), dtype=torch.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def grads(ps, device):
        req = tree_map(lambda p: p.to(device).requires_grad_(), ps)
        loss, _ = model_lib.loss_fn(req, cfg, batch, remat="none")
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(req))

    before = dict(launch_counts)
    loss, g = grads(params, cuda)
    moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.n_layers))
    assert launch_counts["gmm"] == before["gmm"] + 3 * moe
    assert launch_counts["gmm_bwd"] == before["gmm_bwd"] + 3 * moe
    loss_cpu, g_cpu = grads(params, "cpu")
    assert abs(float(loss) - float(loss_cpu)) <= 1e-5 * abs(float(loss_cpu))
    for a, b in zip(g, g_cpu):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max().clamp(min=1e-30))


def test_parallel_phase_at_small_size_on_the_card(cuda, tmp_path):
    """chip_smoke's phase 26 at small size (`PARALLEL_PLAN_SMALL`: the
    reduced jamba MoE layer expert-parallel on (4, 2), the reduced qwen2
    sequence-parallel on (1, 8), its sharded zero3 and int8-compressed
    steps) in a world of 8 ranks on the card: every part's gates, and
    each rank's launches equal to the shapes' exactly."""
    from chip_smoke import (
        PARALLEL_PLAN_SMALL, parallel_launches, parallel_phase,
    )
    by_part = parallel_phase(PARALLEL_PLAN_SMALL, device="cuda")
    want = parallel_launches(PARALLEL_PLAN_SMALL)
    assert by_part == {part: {k: 8 * v for k, v in counts.items()}
                       for part, counts in want.items()}
    assert by_part["ep"]["gmm"] == 8 * 3
    assert by_part["sp"]["flash_attention"] > 0


@pytest.mark.parametrize("part", ["elastic", "serve_mesh"])
def test_mesh_phase_at_small_size_on_the_card(cuda, part):
    """chip_smoke's phase 27 at small size (`MESH_PLAN_SMALL`, the reduced
    qwen2 with head dim 32) in a world of 8 ranks on the card: elastic
    training (rescales 0 -> 4 -> 8, the losses and final parameters of a
    one-device run_fixed, a planted fault above the parameters' bar), or
    the meshed engine under decode and decode_sp (float32 greedy tokens
    equal to one device's, the bfloat16 first tick within its bar and a
    dropped cache part above it, each rank's flash instances exact); each
    rank's launches equal to the shapes' exactly."""
    from chip_smoke import (
        MESH_PLAN_SMALL, PARALLEL_RANKS, parallel_launches, parallel_phase,
    )
    plan = {part: MESH_PLAN_SMALL[part]}
    by_part = parallel_phase(plan, device="cuda")
    want = [parallel_launches(plan, r)[part] for r in range(PARALLEL_RANKS)]
    assert by_part == {part: {k: sum(w[k] for w in want)
                              for k in by_part[part]}}
    assert by_part[part]["flash_attention"] > 0


@pytest.mark.parametrize("part", ["tp_serve", "tp_train"])
def test_tp_phase_at_small_size_on_the_card(cuda, part):
    """chip_smoke's phase 28 at small size (`TP_PLAN_SMALL`: the reduced
    qwen2 and mamba2, head dim 32) in a world of 8 ranks on the card:
    serving under decode on (4, 2) and (2, 4), each rank with its part of
    the heads (float32 greedy tokens equal to one device's, the bfloat16
    first tick within its bar and a dropped partial above it), or mamba2
    trained under base on (4, 2) (the one-device losses and parameters,
    a dropped partial above the loss bar); each rank's launches equal to
    the shapes' exactly."""
    from chip_smoke import (
        PARALLEL_RANKS, TP_PLAN_SMALL, parallel_launches, parallel_phase,
    )
    plan = {part: TP_PLAN_SMALL[part]}
    by_part = parallel_phase(plan, device="cuda")
    want = [parallel_launches(plan, r)[part] for r in range(PARALLEL_RANKS)]
    assert by_part == {part: {k: sum(w[k] for w in want)
                              for k in by_part[part]}}
    assert by_part[part]["ssd"] > 0


def test_prefill_rows_phase_at_small_size_on_the_card(cuda):
    """chip_smoke's phase 30 at small size (`ROWS_PLAN_SMALL`: the reduced
    qwen2, mamba2 and jamba, head dim 32, 8 prompts of 32 tokens) in a
    world of 8 ranks on the card: a batched prefill with its rows cut
    over {"data": 8}, (4, 2) and (2, 4) (jamba under ep), the float32
    logits and every rank's cache part against one device's, a planted
    fault (every rank prefills its neighbour's rows) above the bars, the
    bfloat16 logits within theirs; each rank's kernels at its rows and its
    launches by instance equal to the shapes' exactly."""
    from chip_smoke import (
        PARALLEL_RANKS, ROWS_PLAN_SMALL, parallel_launches, parallel_phase,
    )
    part = "prefill_rows"
    plan = {part: ROWS_PLAN_SMALL[part]}
    by_part = parallel_phase(plan, device="cuda")
    want = [parallel_launches(plan, r)[part] for r in range(PARALLEL_RANKS)]
    assert by_part == {part: {k: sum(w[k] for w in want)
                              for k in by_part[part]}}
    for kernel in ("flash_attention", "ssd", "gmm"):
        assert by_part[part][kernel] > 0, kernel


def test_collectives_carry_cuda_tensors_on_gloo(cuda, tmp_path):
    """The collectives phase 26 uses, on CUDA tensors in a gloo world of
    4 ranks on the card: bfloat16 all-gather and all-to-all (as bytes),
    the float32 and bfloat16 psum (the same bits on every rank), int32
    sums and float32 max."""
    from repro_torch.launch.mesh import spawn_world
    import torch_world
    out = spawn_world(torch_world.cuda_collectives, 4, backend="gloo",
                      device="cuda", init_file=tmp_path / "store",
                      timeout_s=180.0, threads=None)
    for r in out[1:]:
        for k in out[0]:
            assert np.array_equal(r[k], out[0][k]) or k.startswith("own"), k
    assert (out[0]["psum_i32"] == sum(range(4))).all()


def test_dryrun_step_phase_at_small_size_on_the_card(cuda):
    """chip_smoke's phase 29(b) at small size: the reduced qwen2 (head dim
    32, bfloat16) trained by `run_fixed` on the card, its launches per
    step, state bytes and step times measured as `train_phase` measures
    them; the dry-run's analysis of the same step must count its
    launches as sites, its state's bytes exactly, and bound its median
    step."""
    import dataclasses
    import statistics

    from chip_smoke import card_line, dryrun_step_phase, state_items
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.build import launch_counts
    from repro_torch.launch import train as launch_train

    cfg = dataclasses.replace(reduced_config("qwen2-1.5b"), d_head=32,
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    train = dict(steps=4, batch=2, seq=64)
    seconds, state_bytes = [], []

    def on_step(i, state, metrics, s):
        seconds.append(s)
        if i == 0:
            state_bytes.append(sum(
                t.numel() * t.element_size() for tree in (
                    state.params, state.opt["mu"], state.opt["nu"])
                for _, t in state_items(tree)))

    for name in launch_counts:
        launch_counts[name] = 0
    torch.cuda.reset_peak_memory_stats()
    launch_train.run_fixed(cfg, steps=train["steps"], batch=train["batch"],
                           seq=train["seq"], ckpt_dir=None, device=cuda,
                           log_every=10, on_step=on_step)
    trained = {"steps": train["steps"], "launch_counts": dict(launch_counts),
               "state_bytes": state_bytes[0],
               "step_ms_median_3_6": 1e3 * statistics.median(seconds[2:]),
               "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9}
    row = dryrun_step_phase(cfg, trained, card_line(), train=train)
    assert row["sites_per_step"] == {"flash_attention": cfg.n_layers,
                                     "flash_attention_bwd": cfg.n_layers}
    assert 0 < row["bound_over_measured"] <= 1.05
