"""The port's grouped matmul on CPU tensors against the JAX package's
Pallas kernel (interpret mode), its oracle and its off-TPU path.

On a CPU tensor the port's `gmm` runs its plain version, one float32
matmul per group; the same numpy inputs (made by chip_smoke.py's
`gmm_arrays`, the reference suite's draws) go through
`gmm_pallas(interpret=True)`, `gmm_reference` and the reference's
``ops.gmm`` (``lax.ragged_dot``).  Tolerances are the reference suite's
own (tests/test_kernel_moe_gmm.py): 1e-4 for float32 inputs and 5e-2
for bfloat16, whose inputs are rounded to bf16 on both sides and whose
output is rounded to bf16; the port's oracle is held to the same.

Which instance a CUDA launch would take is a pure function of dtype,
shape and alignment (`route`), so it is checked here on CPU tensors:
every bfloat16 case whose K and N are multiples of 8, and each of
jamba's bfloat16 expert products, goes to the tensor cores; float32
calls, bfloat16 with K = 100 and misaligned tensors go to the SIMT
instance.

The backward: `ref.gmm_backward_reference` and `GmmFn` (whose backward
on CPU tensors is that plain backward) against ``jax.vjp`` of the
reference's ``ops.gmm`` (``lax.ragged_dot``'s VJP), the oracle of the
backward kernel, on the reference, ragged and tensor-core edge cases and
on random ragged groups: float32 within 1e-5 of each gradient's max;
bfloat16 inputs give bfloat16 gradients within 5e-2 of its max; the
padding rows' dlhs and an empty group's drhs are exactly 0.  The
backward's instance (`bwd_route`) is the forward's `route`.  The
tensor-core backward's tile walks, in their plain-Python models
(`ops.dlhs_tile`, `ops.drhs_walk`): dlhs's clusters cover every
(row, 256-column tile) of dlhs exactly once, each row with its own
expert or the zero tail, experts never decreasing; drhs's persistent
clusters cover every (expert, pair of K tiles, N tile) exactly once,
each cluster's experts never decreasing; on `GMM_BWD_TILE_CASES`,
`GMM_BWD_STAGE_CASES` and jamba's training products.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.moe_gmm.kernel import gmm_pallas
from repro.kernels.moe_gmm.kernel import tile_expert_map as ref_tile_map
from repro.kernels.moe_gmm.ops import gmm as ref_gmm
from repro.kernels.moe_gmm.ref import expert_of_row as ref_expert_of_row
from repro.kernels.moe_gmm.ref import gmm_reference as ref_oracle
from repro_torch.kernels.build import launch_counts
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm.ops import (
    GmmFn, bwd_route, gmm, gmm_backward, gmm_plain, route, route_counts,
    row_tile, tc_tile, tile_expert_map,
)
from repro_torch.kernels.moe_gmm.ref import (
    expert_of_row, gmm_backward_reference, gmm_reference,
)
from test_kernel_moe_gmm import CASES
from test_torch_cuda import (
    GMM_BWD_STAGE_CASES, GMM_BWD_TILE_CASES, GMM_CASES, GMM_RAGGED,
    GMM_TC_CASES, gmm_arrays, moe_serving_shapes,
)
from test_torch_matchmaker import one_torch_thread  # noqa: F401

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(a, b, tol):
    np.testing.assert_allclose(as_f32(a), as_f32(b), atol=tol, rtol=tol)


def both(arrays, dtype):
    """The same arrays as port (torch) and reference (jax) inputs."""
    lhs, rhs, gs = arrays
    port = (torch.from_numpy(lhs).to(TORCH[dtype]),
            torch.from_numpy(rhs).to(TORCH[dtype]), torch.from_numpy(gs))
    ref = (jnp.asarray(lhs, JAX[dtype]), jnp.asarray(rhs, JAX[dtype]),
           jnp.asarray(gs))
    return port, ref


def test_cuda_cases_are_the_reference_cases():
    assert GMM_CASES == CASES


@pytest.mark.parametrize("E,K,N,BT,sizes,tail", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_pallas_and_oracle(E, K, N, BT, sizes, tail, dtype):
    (lhs, rhs, gs), (jl, jr, jg) = both(gmm_arrays(0, E, K, N, sizes, tail),
                                        dtype)
    out = gmm(lhs, rhs, gs)
    assert out.dtype == TORCH[dtype] and out.shape == (sum(sizes) + tail, N)
    pallas = gmm_pallas(jl, jr, jg, block_t=BT, interpret=True)
    oracle = ref_oracle(jl, jr, jg)
    close(out, pallas, TOL[dtype])
    close(out, oracle, TOL[dtype])
    close(gmm_reference(lhs, rhs, gs), oracle, TOL[dtype])
    assert not out[sum(sizes):].any()


EXTRA_RAGGED = [(4, 16, 24, [0, 0, 0, 9], 0), (1, 8, 8, [5], 3)]


@pytest.mark.parametrize("E,K,N,sizes,tail",
                         GMM_RAGGED + EXTRA_RAGGED + GMM_TC_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_groups_match_ragged_dot(E, K, N, sizes, tail, dtype):
    """Unaligned sizes, empty groups and a tail: the reference's off-TPU
    ``ops.gmm`` (``lax.ragged_dot``), which the Pallas kernel cannot
    take."""
    (lhs, rhs, gs), (jl, jr, jg) = both(gmm_arrays(1, E, K, N, sizes, tail),
                                        dtype)
    out = gmm(lhs, rhs, gs)
    close(out, ref_gmm(jl, jr, jg), TOL[dtype])
    close(out, ref_oracle(jl, jr, jg), TOL[dtype])


def test_float32_output_of_bfloat16_inputs():
    """``out_dtype=float32``: the float32 sums of the bf16 inputs, not
    rounded to bf16 (the MoE's ``preferred_element_type``)."""
    E, K, N, sizes, tail = GMM_RAGGED[1]
    (lhs, rhs, gs), _ = both(gmm_arrays(2, E, K, N, sizes, tail), "bfloat16")
    out = gmm(lhs, rhs, gs, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    ref = ref_oracle(jnp.asarray(lhs.float().numpy()),
                     jnp.asarray(rhs.float().numpy()), jnp.asarray(gs))
    close(out, ref, TOL["float32"])
    assert not torch.equal(out, out.bfloat16().float())


def test_groups_reaching_past_the_rows_are_cut():
    lhs = torch.ones(5, 3)
    rhs = torch.stack([torch.full((3, 2), float(e + 1)) for e in range(3)])
    out = gmm_plain(lhs, rhs, torch.tensor([2, 6, 4], dtype=torch.int32))
    assert out[:, 0].tolist() == [3.0, 3.0, 6.0, 6.0, 6.0]


def test_cpu_tensors_launch_nothing():
    before, routed = dict(launch_counts), dict(route_counts)
    gmm(torch.zeros(4, 8), torch.zeros(2, 8, 8),
        torch.tensor([2, 2], dtype=torch.int32))
    gmm(torch.zeros(4, 8, dtype=torch.bfloat16),
        torch.zeros(2, 8, 8, dtype=torch.bfloat16),
        torch.tensor([2, 2], dtype=torch.int32))
    assert launch_counts == before and route_counts == routed


@pytest.mark.parametrize("sizes", [[3, 0, 9], [0, 0], [16, 16, 1], [7]])
def test_expert_of_row_matches_reference(sizes):
    T = sum(sizes) + 4
    gs = np.asarray(sizes, np.int32)
    np.testing.assert_array_equal(
        expert_of_row(torch.from_numpy(gs), T).numpy(),
        np.asarray(ref_expert_of_row(jnp.asarray(gs), T)))


@settings(max_examples=50, deadline=None)
@given(sizes=st.lists(st.integers(0, 8), min_size=1, max_size=8),
       bt=st.sampled_from([2, 4, 8]))
def test_tile_expert_map_property(sizes, bt):
    """The reference's property (tests/test_kernel_moe_gmm.py): the map
    agrees with expert_of_row at every tile start when groups are
    bt-aligned; and the port's map is the reference's."""
    sizes_aligned = [s * bt for s in sizes]
    n_tiles = max(1, (sum(sizes_aligned) + 2 * bt) // bt)
    gs = np.asarray(sizes_aligned, np.int32)
    tmap = tile_expert_map(torch.from_numpy(gs), n_tiles, bt).numpy()
    emap = expert_of_row(torch.from_numpy(gs), n_tiles * bt).numpy()
    np.testing.assert_array_equal(tmap, emap[::bt])
    np.testing.assert_array_equal(
        tmap, np.asarray(ref_tile_map(jnp.asarray(gs), n_tiles, bt)))


def test_row_tile_follows_the_mean_group():
    """jamba's decode tick (8 slots: 16 experts of C = 2 rows) takes the
    small tile; its prefills (C = 80 and 160) the large one."""
    assert row_tile(32, 16) == 8
    assert row_tile(1280, 16) == row_tile(2560, 16) == 64


def shaped(T, K, E, N, dtype, out_dtype=torch.float32):
    """lhs, rhs and out of these shapes, as views of one element each (no
    memory: `route` reads dtype, shape and address only)."""
    one = torch.zeros(1, dtype=dtype)
    return (one.expand(T, K), one.expand(E, K, N),
            torch.zeros(1, dtype=out_dtype).expand(T, N))


@pytest.mark.parametrize("E,K,N,BT,sizes,tail", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_of_the_reference_cases(E, K, N, BT, sizes, tail, dtype):
    """bfloat16 goes to the tensor cores except at K = 100 (rows of 200
    bytes, which TMA cannot stride); float32 always to the SIMT
    instance."""
    (lhs, rhs, _), _ = both(gmm_arrays(0, E, K, N, sizes, tail), dtype)
    out = torch.empty(lhs.shape[0], N)
    tc = dtype == "bfloat16" and K != 100
    assert route(lhs, rhs, out) == ("wgmma" if tc else "simt")


@pytest.mark.parametrize("E,K,N,sizes,tail",
                         GMM_RAGGED + EXTRA_RAGGED + GMM_TC_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_of_the_ragged_and_edge_cases(E, K, N, sizes, tail, dtype):
    """Every ragged and edge case has K and N multiples of 8: bfloat16
    takes the tensor cores, float32 the SIMT instance."""
    (lhs, rhs, _), _ = both(gmm_arrays(1, E, K, N, sizes, tail), dtype)
    out = torch.empty(lhs.shape[0], N, dtype=torch.bfloat16)
    assert route(lhs, rhs, out) == ("wgmma" if dtype == "bfloat16"
                                    else "simt")


@pytest.mark.parametrize("label,rows,K,N", moe_serving_shapes())
def test_jamba_expert_products_take_the_tensor_cores(label, rows, K, N):
    """The MoE layer's calls at jamba's serving shapes: bfloat16 in,
    float32 out on the tensor cores; the float32 model's on the SIMT
    instance."""
    assert route(*shaped(rows, K, 16, N, torch.bfloat16)) == "wgmma"
    assert route(*shaped(rows, K, 16, N, torch.float32)) == "simt"


def test_route_needs_tma_strides_and_alignment():
    """K or N not a multiple of 8, or a tensor off a 16-byte boundary,
    keeps bfloat16 on the SIMT instance."""
    assert route(*shaped(64, 100, 2, 64, torch.bfloat16)) == "simt"
    assert route(*shaped(64, 64, 2, 60, torch.bfloat16)) == "simt"
    lhs, rhs, out = shaped(64, 64, 2, 64, torch.bfloat16)
    off = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16)[1:].view(64, 64)
    assert route(off, rhs, out) == "simt"
    assert route(lhs, rhs, torch.zeros(64 * 64 + 1)[1:].view(64, 64)) == \
        "simt"
    assert route(lhs, rhs, out) == "wgmma"


def test_tensor_core_tile_holds_the_mean_group():
    """jamba's decode tick (16 groups of C = 2) takes 8-row tiles, its
    prefills of 512 and 1024 tokens (C = 80 and 160) 128 and 192 rows:
    one block a group, so each weight tile is read once."""
    assert tc_tile(32, 16) == 8
    assert tc_tile(1280, 16) == 128
    assert tc_tile(2560, 16) == 192
    assert tc_tile(16 * 30, 16) == 64
    assert tc_tile(100_000, 4) == 192


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

#: the backward's float32 gate on max |port - jax| / max |jax| of each
#: gradient (float32 sums in another order), and bfloat16's (both sides
#: round each gradient once to bfloat16)
BWD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
BWD_CASES = ([(E, K, N, sizes, tail) for E, K, N, _bt, sizes, tail in CASES]
             + GMM_RAGGED + EXTRA_RAGGED + GMM_TC_CASES + GMM_BWD_TILE_CASES)


def cotangent(T, N, seed=5):
    return np.random.default_rng(seed).standard_normal((T, N)).astype(
        np.float32)


def jax_vjp(jl, jr, jg, dout):
    """``jax.vjp`` of the reference's ``ops.gmm`` at (lhs, rhs): the
    gradients (dlhs, drhs) for ``dout``."""
    _, pullback = jax.vjp(lambda a, b: ref_gmm(a, b, jg), jl, jr)
    return pullback(dout)


def rel_close(got, want, tol):
    got, want = as_f32(got), as_f32(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def grads_of_gmm_fn(lhs, rhs, gs, dout):
    lr, rr = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    out = GmmFn.apply(lr, rr, gs, None)
    return torch.autograd.grad(out, (lr, rr), dout)


@pytest.mark.parametrize("E,K,N,sizes,tail", BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_vjp(E, K, N, sizes, tail, dtype):
    """The plain backward and `GmmFn`'s backward against ``jax.vjp`` of
    the reference's ``gmm``, in the inputs' dtype: float32 within 1e-5 of
    each gradient's max, bfloat16 within 5e-2, each gradient in its
    input's dtype; the padding rows' dlhs and the empty groups' drhs are
    exactly 0."""
    (lhs, rhs, gs), (jl, jr, jg) = both(gmm_arrays(3, E, K, N, sizes, tail),
                                        dtype)
    d = cotangent(lhs.shape[0], N)
    dout, jdout = torch.from_numpy(d).to(TORCH[dtype]), jnp.asarray(
        d, JAX[dtype])
    want = jax_vjp(jl, jr, jg, jdout)
    for got in (gmm_backward_reference(lhs, rhs, gs, dout),
                grads_of_gmm_fn(lhs, rhs, gs, dout)):
        for g, w, x in zip(got, want, (lhs, rhs)):
            assert g.dtype == x.dtype and g.shape == x.shape
            rel_close(g, w, BWD_TOL[dtype])
        dlhs, drhs = got
        assert not dlhs[sum(sizes):].any()
        for e, size in enumerate(sizes):
            if size == 0:
                assert not drhs[e].any()


@pytest.mark.parametrize("E,K,N,sizes,tail", GMM_RAGGED + GMM_TC_CASES)
def test_backward_of_float32_output(E, K, N, sizes, tail):
    """The MoE layer's call: bfloat16 inputs, float32 output, so a float32
    cotangent; the gradients come back in bfloat16, within bfloat16's
    rounding of the float32 gradients of the widened inputs."""
    (lhs, rhs, gs), _ = both(gmm_arrays(4, E, K, N, sizes, tail), "bfloat16")
    dout = torch.from_numpy(cotangent(lhs.shape[0], N, 6))
    lr, rr = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    out = GmmFn.apply(lr, rr, gs, torch.float32)
    assert out.dtype == torch.float32
    dlhs, drhs = torch.autograd.grad(out, (lr, rr), dout)
    assert dlhs.dtype == drhs.dtype == torch.bfloat16
    _, pullback = jax.vjp(lambda a, b: ref_gmm(a, b, jnp.asarray(gs.numpy())),
                          jnp.asarray(lhs.float().numpy()),
                          jnp.asarray(rhs.float().numpy()))
    for g, w in zip((dlhs, drhs), pullback(jnp.asarray(dout.numpy()))):
        rel_close(g, w, 2 ** -8)


@settings(max_examples=25, deadline=None)
@given(sizes=st.lists(st.integers(0, 6), min_size=4, max_size=4),
       seed=st.integers(0, 2 ** 16))
def test_backward_property_over_ragged_groups(sizes, seed):
    """Random group sizes (empty ones, and any tail up to 24 rows) over 24
    rows: the plain backward equals ``jax.vjp`` of the reference's
    ``gmm`` within 1e-5, with every padding row's dlhs and every empty
    group's drhs exactly 0."""
    T, K, N = 24, 16, 24
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((T, K)).astype(np.float32)
    rhs = rng.standard_normal((4, K, N)).astype(np.float32)
    d = rng.standard_normal((T, N)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    dlhs, drhs = gmm_backward_reference(
        torch.from_numpy(lhs), torch.from_numpy(rhs), torch.from_numpy(gs),
        torch.from_numpy(d))
    want = jax_vjp(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs),
                   jnp.asarray(d))
    rel_close(dlhs, want[0], BWD_TOL["float32"])
    rel_close(drhs, want[1], BWD_TOL["float32"])
    assert not dlhs[sum(sizes):].any()
    assert all(not drhs[e].any() for e, g in enumerate(sizes) if g == 0)


def test_gmm_fn_equals_autograd_of_the_plain_version():
    """On CPU tensors `GmmFn` is `gmm_plain` with the plain backward: the
    same output and, to float32 rounding, the gradients autograd takes
    through `gmm_plain`."""
    E, K, N, sizes, tail = GMM_RAGGED[1]
    (lhs, rhs, gs), _ = both(gmm_arrays(7, E, K, N, sizes, tail), "float32")
    dout = torch.from_numpy(cotangent(lhs.shape[0], N, 8))
    lr, rr = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    out = gmm_plain(lr, rr, gs)
    want = torch.autograd.grad(out, (lr, rr), dout)
    assert torch.equal(GmmFn.apply(lhs, rhs, gs, None), out.detach())
    for g, w in zip(grads_of_gmm_fn(lhs, rhs, gs, dout), want):
        rel_close(g, w, 1e-6)


def test_gmm_fn_asks_only_for_the_gradients_autograd_needs(monkeypatch):
    """`GmmFn` passes ``needs_input_grad`` to `gmm_backward` and returns
    None for an input that needs no gradient."""
    asked = []

    def recorded(lhs, rhs, gs, dout, *, need=(True, True)):
        asked.append(need)
        return gmm_backward_reference(lhs, rhs, gs, dout)

    monkeypatch.setattr(gmm_ops, "gmm_backward", recorded)
    (lhs, rhs, gs), _ = both(gmm_arrays(9, 3, 16, 24, [5, 0, 7], 2),
                             "float32")
    lr, rr = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    GmmFn.apply(lr, rhs, gs, None).sum().backward()
    GmmFn.apply(lhs, rr, gs, None).sum().backward()
    assert asked == [(True, False), (False, True)]
    assert lr.grad is not None and rr.grad is not None


def test_cpu_backward_launches_nothing():
    before = dict(launch_counts)
    routed = dict(gmm_ops.bwd_route_counts)
    (lhs, rhs, gs), _ = both(gmm_arrays(9, 3, 16, 24, [5, 0, 7], 2),
                             "bfloat16")
    dl, dr = gmm_backward(lhs, rhs, gs, torch.ones(14, 24))
    assert dl.dtype == dr.dtype == torch.bfloat16
    assert launch_counts == before and gmm_ops.bwd_route_counts == routed


@pytest.mark.parametrize("E,K,N,sizes,tail", BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cotangent_dtype", ["float32", "input"])
def test_bwd_route_is_the_forward_route(E, K, N, sizes, tail, dtype,
                                        cotangent_dtype):
    """The backward's instance is the one the forward took for the same
    lhs and rhs, whatever the cotangent's dtype (float32 from the MoE
    layer's float32 output, or the input's)."""
    (lhs, rhs, _), _ = both(gmm_arrays(1, E, K, N, sizes, tail), dtype)
    out_dtype = torch.float32 if cotangent_dtype == "float32" else lhs.dtype
    out = torch.empty(lhs.shape[0], N, dtype=out_dtype)
    assert bwd_route(lhs, rhs, torch.empty_like(out)) == route(lhs, rhs, out)
    assert bwd_route(lhs, rhs, out) == ("wgmma" if dtype == "bfloat16"
                                        and K % 8 == 0 and N % 8 == 0
                                        else "simt")


# ---------------------------------------------------------------------------
# the tensor-core backward's tile walks
# ---------------------------------------------------------------------------

#: (E, K, N, sizes, T): the tile and stage cases, a group cut at row T,
#: and jamba's training products (16 groups of 640 rows)
WALK_CASES = ([(E, K, N, sizes, sum(sizes) + tail)
               for E, K, N, sizes, tail
               in GMM_BWD_TILE_CASES + GMM_BWD_STAGE_CASES]
              + [(3, 64, 64, [100, 50, 80], 160),
                 (16, 4096, 14336, [640] * 16, 10240),
                 (16, 14336, 4096, [640] * 16, 10240)])


@pytest.mark.parametrize("E,K,N,sizes,T", WALK_CASES)
def test_dlhs_walk_covers_every_output_tile_once(E, K, N, sizes, T):
    """Every cluster of dlhs's grid, both blocks: each (row, 256-column
    tile of K) of dlhs is computed by exactly one block, a tile's rows
    all of its expert (the zero tail's past the groups), at most 128 of
    them; a pair's second tile past K is only a partner; clusters past
    the tiles leave; experts never decrease along the grid."""
    n_col = -(-K // gmm_ops.BWD_TILE[1])
    owner = expert_of_row(torch.tensor(sizes, dtype=torch.int32), T).numpy()
    owner = np.where(owner >= E, -1, owner)
    seen = np.zeros((T, n_col), np.int64)
    order, done = [], False
    for q in range(gmm_ops.dlhs_clusters(T, K, E)):
        e, r0, r1, pair = gmm_ops.dlhs_tile(q, sizes, T, K)
        if e == -2:
            done = True
            continue
        assert not done, "a tile after the end of the walk"
        assert 0 < r1 - r0 <= gmm_ops.BWD_TILE[0]
        assert (owner[r0:r1] == e).all()
        for rank in range(gmm_ops.BWD_CLUSTER):
            col = gmm_ops.BWD_CLUSTER * pair + rank
            if col < n_col:
                seen[r0:r1, col] += 1
            else:
                assert rank == 1 and col == n_col
        order.append(E if e == -1 else e)
    assert (seen == 1).all()
    assert order == sorted(order)


@pytest.mark.parametrize("E,K,N,sizes,T", WALK_CASES)
@pytest.mark.parametrize("clusters", [1, 7, 66, 100_000])
def test_drhs_walk_covers_every_tile_once(E, K, N, sizes, T, clusters):
    """drhs's persistent grid of ``clusters`` (cut to the tiles, as the
    launch cuts it): every (expert, pair of 128-row tiles of K, 256
    columns of N) exactly once, each cluster's experts never
    decreasing, and the clusters' tiles spread evenly (no cluster walks
    more than one tile beyond another)."""
    n_k = -(-K // gmm_ops.BWD_TILE[1])
    n_n = -(-N // gmm_ops.BWD_TILE[1])
    clusters = min(clusters, gmm_ops.drhs_tiles(E, K, N))
    walks = [gmm_ops.drhs_walk(c, clusters, E, K, N)
             for c in range(clusters)]
    for walk in walks:
        experts = [t[0] for t in walk]
        assert experts == sorted(experts)
    tiles = [t for walk in walks for t in walk]
    assert sorted(tiles) == [(e, k * gmm_ops.BWD_TILE[1],
                              n * gmm_ops.BWD_TILE[1])
                             for e in range(E) for k in range(n_k)
                             for n in range(n_n)]
    lengths = [len(w) for w in walks]
    assert max(lengths) - min(lengths) <= 1
