"""The port's SSD scan on CPU tensors against the JAX package's Pallas
kernel (interpret mode) and its sequential oracle.

On a CPU tensor the port's `ssd` runs its plain chunked version; the
same numpy inputs (the reference suite's `_mk` draws, made once in
chip_smoke.py) go through `ssd_pallas(interpret=True)` and
`ssd_reference`.  Tolerances are the reference suite's own
(tests/test_kernel_ssd.py): 2e-3 for float32 inputs and 5e-2 for
bfloat16, whose x, B and C are rounded to bf16 on both sides and whose
y is rounded to bf16.  The two oracles and the two one-token updates
compute the same float32 sums in nearly the same order, so they are held
to 1e-5 and 1e-6.

The tensor-core instance's three passes run here as their plain mirror,
`ref.ssd_passes` (64-row tiles, and in bfloat16 the kernel's roundings:
w x and the scores to bf16, the entering state to bf16 hi + lo), held
against Pallas and the oracle at the same tolerances, on the reference
cases and on ragged ones (a last chunk of 9 rows; a prompt shorter than
one tile).  Its entering states are the chunked version's within 1e-5:
the same float32 sums, chunk by chunk.  The design study's chunked scan
(`study.rounded_scan`) is the oracle without roundings and the mirror
with the kernel's.  `ops.route` is held against chip_smoke.py's
`ssd_route` on every reference, serving and edge shape.

The backward: `ref.ssd_backward_reference`, the plain version that
`ssd_bwd.cu` is held against on the card, against ``jax.vjp`` of the
JAX package's chunked scan and of its sequential oracle on the same
numpy inputs with a random output and final-state gradient (with and
without an initial state, ragged tails, G > 1, S shorter than a chunk),
within 1e-5 of each gradient's max (float32 sums in another order);
`SSDFn` on CPU tensors against autograd through `ssd_chunked`, and under
``torch.autograd.gradcheck`` in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.kernel import ssd_pallas
from repro.kernels.ssd.ops import ssd_chunked_jnp
from repro.kernels.ssd.ops import ssd_decode_step as ref_decode_step
from repro.kernels.ssd.ref import ssd_reference as ref_oracle
from repro_torch.kernels.build import launch_counts
from repro_torch.kernels.ssd import ssd, ssd_chunked, ssd_decode_step
from repro_torch.kernels.ssd import bwd_study, study
from repro_torch.kernels.ssd.ops import (
    SSDFn, bwd_route, bwd_route_counts, route, route_counts, ssd_backward,
    ssd_forward,
)
from repro_torch.kernels.ssd.ref import (
    ssd_backward_reference, ssd_passes, ssd_reference,
)
from test_kernel_ssd import CASES
from test_torch_cuda import (
    SSD_BWD_DFINAL, SSD_CASES, SSD_TC_CASES, ssd_arrays, ssd_bwd_arrays,
    ssd_inputs, ssd_route, ssd_serving_cases, ssd_timed_cases,
)
from test_torch_matchmaker import one_torch_thread  # noqa: F401

TOL = {"float32": 2e-3, "bfloat16": 5e-2}
ORACLE_TOL = 1e-5
STEP_TOL = 1e-6
CPU = torch.device("cpu")
# ragged cases for the passes (B, S, H, P, G, N, chunk, init): a last
# chunk of 9 rows (777 = 3 x 256 + 9), and a prompt shorter than one
# 64-row tile
RAGGED_CASES = [(1, 777, 2, 64, 1, 64, 256, True),
                (2, 40, 2, 64, 1, 128, 256, False)]
# shapes `route` sends elsewhere than a tensor-core call: head dims and
# d_states the instance does not take, a chunk that is not a multiple of
# 64 (B, S, H, P, G, N, chunk, init)
# shapes of the design study's scan (S a multiple of the chunk; B, S, H,
# P, G, N, chunk)
STUDY_CASES = [(1, 256, 4, 64, 1, 64, 64), (2, 128, 4, 32, 2, 32, 32)]
# the backward's cases (B, S, H, P, G, N, chunk, init, dfinal): the
# reference cases with and without a final-state gradient, chip_smoke's
# dfinal case, a ragged tail with G = 2 and an initial state, S shorter
# than the chunk, one step
BWD_CASES = ([(*c, dfinal) for c in CASES for dfinal in (False, True)]
             + [(*SSD_BWD_DFINAL, True),
                (2, 77, 4, 16, 2, 16, 32, True, True),
                (1, 40, 2, 32, 1, 16, 64, False, False),
                (1, 1, 2, 16, 1, 16, 64, False, True)])
BWD_TOL = 1e-5
ROUTE_EDGE_CASES = [(1, 128, 4, 32, 1, 64, 256, False),
                    (1, 128, 4, 64, 1, 32, 256, False),
                    (1, 128, 4, 64, 1, 64, 96, False),
                    (1, 128, 4, 128, 2, 128, 32, True)]


def jax_inputs(arrays, dtype):
    x, dt, A, Bm, Cm, D, st = arrays
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt), jnp.asarray(D),
            None if st is None else jnp.asarray(st))


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(a, b, tol):
    np.testing.assert_allclose(as_f32(a), as_f32(b), atol=tol, rtol=tol)


def test_cuda_cases_are_the_reference_cases():
    assert SSD_CASES == CASES


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,init", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_pallas_and_oracle(B, S, H, P, G, N, chunk, init,
                                        dtype):
    tdt = getattr(torch, dtype)
    x, dt, A, Bm, Cm, D, st = ssd_inputs(0, B, S, H, P, G, N, init, tdt, CPU)
    before = dict(launch_counts)
    y, fin = ssd(x, dt, A, Bm, Cm, D, chunk=chunk, initial_state=st)
    assert launch_counts == before          # the CPU branch launches nothing
    assert y.dtype == tdt and y.shape == (B, S, H, P)
    assert fin.dtype == torch.float32 and fin.shape == (B, H, P, N)
    jx = jax_inputs(ssd_arrays(0, B, S, H, P, G, N, init), dtype)
    pallas = ssd_pallas(*jx[:6], chunk=chunk, initial_state=jx[6],
                        interpret=True)
    oracle = ref_oracle(*jx[:6], initial_state=jx[6])
    for yr, fr in (pallas, oracle):
        close(y, yr, TOL[dtype])
        close(fin, fr, TOL[dtype])


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,init", CASES)
def test_oracle_matches_the_jax_oracle(B, S, H, P, G, N, chunk, init):
    arrays = ssd_arrays(1, B, S, H, P, G, N, init)
    x, dt, A, Bm, Cm, D, st = (None if a is None else torch.from_numpy(a)
                               for a in arrays)
    y, fin = ssd_reference(x, dt, A, Bm, Cm, D, initial_state=st)
    jx = jax_inputs(arrays, "float32")
    yr, fr = ref_oracle(*jx[:6], initial_state=jx[6])
    close(y, yr, ORACLE_TOL)
    close(fin, fr, ORACLE_TOL)


def test_decode_steps_match_full_sequence():
    """Running ssd_decode_step token by token reproduces the full-sequence
    scan (the prefill->decode handoff invariant), and each step equals
    the JAX package's step from the same state."""
    B, S, H, P, G, N = 1, 48, 2, 16, 1, 32
    arrays = ssd_arrays(2, B, S, H, P, G, N, True)
    x, dt, A, Bm, Cm, D, st = (torch.from_numpy(a) for a in arrays)
    y_full, state_full = ssd_reference(x, dt, A, Bm, Cm, D,
                                       initial_state=st)
    state, ys = st, []
    for t in range(S):
        args = (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D)
        ref_state, ref_y = ref_decode_step(
            jnp.asarray(state.numpy()), *(jnp.asarray(a.numpy())
                                          for a in args))
        state, y_t = ssd_decode_step(state, *args)
        close(state, ref_state, STEP_TOL)
        close(y_t, ref_y, STEP_TOL)
        ys.append(y_t)
    close(torch.stack(ys, dim=1), y_full, 1e-4)
    close(state, state_full, 1e-4)


def test_decode_step_writes_in_place():
    arrays = ssd_arrays(3, 2, 1, 4, 16, 2, 16, True)
    x, dt, A, Bm, Cm, D, st = (torch.from_numpy(a) for a in arrays)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D)
    want_state, want_y = ssd_decode_step(st, *args)
    state = st.clone()
    got_state, got_y = ssd_decode_step(state, *args, out=state)
    assert got_state.data_ptr() == state.data_ptr()
    assert torch.equal(state, want_state) and torch.equal(got_y, want_y)


def test_state_passthrough_on_padding():
    """dt = 0 steps leave the state unchanged (the padding invariant the
    chunked version and the kernel's ragged tail rely on)."""
    B, S, H, P, G, N = 1, 32, 2, 16, 1, 16
    x, dt, A, Bm, Cm, D, st = ssd_inputs(4, B, S, H, P, G, N, True,
                                         torch.float32, CPU)
    _, fin = ssd_chunked(x, torch.zeros_like(dt), A, Bm, Cm, D, chunk=16,
                         initial_state=st)
    close(fin, st, STEP_TOL)


def test_views_of_one_projection_are_taken_as_they_are():
    """The model hands the scan x, B and C as views of one projection;
    the result is the contiguous copies' result."""
    B, S, H, P, G, N = 1, 40, 4, 16, 2, 16
    x, dt, A, Bm, Cm, D, _ = ssd_inputs(5, B, S, H, P, G, N, False,
                                        torch.float32, CPU)
    fused = torch.cat([x.flatten(2), Bm.flatten(2), Cm.flatten(2)], dim=-1)
    xv, bv, cv = torch.split(fused, [H * P, G * N, G * N], dim=-1)
    y, fin = ssd(xv.unflatten(-1, (H, P)), dt, A, bv.unflatten(-1, (G, N)),
                 cv.unflatten(-1, (G, N)), D, chunk=16)
    y_c, fin_c = ssd(x, dt, A, Bm, Cm, D, chunk=16)
    assert torch.equal(y, y_c) and torch.equal(fin, fin_c)


def test_other_devices_are_refused():
    x = torch.zeros((1, 4, 2, 16), device="meta")
    bc = torch.zeros((1, 4, 1, 16), device="meta")
    h = torch.zeros((2,), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ssd(x, torch.zeros((1, 4, 2), device="meta"), h, bc, bc, h)


def test_cpu_branch_counts_no_instance():
    x, dt, A, Bm, Cm, D, _ = ssd_inputs(0, 1, 64, 2, 64, 1, 64, False,
                                        torch.bfloat16, CPU)
    before = dict(route_counts)
    ssd(x, dt, A, Bm, Cm, D)
    assert route_counts == before


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,init", CASES + RAGGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_passes_match_pallas_and_oracle(B, S, H, P, G, N, chunk, init,
                                        dtype):
    """The three passes' mirror, with the kernel's bf16 roundings, against
    the Pallas kernel and the oracle at the reference suite's tolerance."""
    tdt = getattr(torch, dtype)
    x, dt, A, Bm, Cm, D, st = ssd_inputs(0, B, S, H, P, G, N, init, tdt, CPU)
    y, fin, entering = ssd_passes(x, dt, A, Bm, Cm, D, chunk=chunk,
                                  initial_state=st)
    assert y.dtype == tdt and y.shape == (B, S, H, P)
    assert fin.dtype == torch.float32 and fin.shape == (B, H, P, N)
    assert entering.shape == (B, -(-S // min(chunk, S)), H, P, N)
    jx = jax_inputs(ssd_arrays(0, B, S, H, P, G, N, init), dtype)
    pallas = ssd_pallas(*jx[:6], chunk=chunk, initial_state=jx[6],
                        interpret=True)
    oracle = ref_oracle(*jx[:6], initial_state=jx[6])
    for yr, fr in (pallas, oracle):
        close(y, yr, TOL[dtype])
        close(fin, fr, TOL[dtype])


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,init", CASES + RAGGED_CASES)
def test_passes_entering_states_are_the_chunked_ones(B, S, H, P, G, N,
                                                     chunk, init):
    """Pass 2's entering states (and the final state) are the chunked
    version's `prev_states`: the state entering chunk c is the chunked
    scan's final state over the first c chunks, the same float32
    recurrence."""
    x, dt, A, Bm, Cm, D, st = ssd_inputs(3, B, S, H, P, G, N, init,
                                         torch.float32, CPU)
    _, fin, entering = ssd_passes(x, dt, A, Bm, Cm, D, chunk=chunk,
                                  initial_state=st)
    Q = min(chunk, S)
    first = torch.zeros_like(entering[:, 0]) if st is None else st
    close(entering[:, 0], first, 0.0)
    for c in range(1, entering.shape[1]):
        steps = slice(0, c * Q)
        _, prev = ssd_chunked(x[:, steps], dt[:, steps], A, Bm[:, steps],
                              Cm[:, steps], D, chunk=chunk, initial_state=st)
        close(entering[:, c], prev, ORACLE_TOL)
    close(fin, ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk,
                           initial_state=st)[1], ORACLE_TOL)


def test_passes_never_exponentiate_masked_pairs():
    """A decay steep enough that exp(cumA_i - cumA_j) overflows for
    j > i: masked pairs are set to 0, never multiplied by their decay, so
    y stays finite."""
    x, dt, A, Bm, Cm, D, _ = ssd_inputs(4, 1, 128, 2, 64, 1, 64, False,
                                        torch.float32, CPU)
    A = torch.full_like(A, -30.0)
    dt = torch.full_like(dt, 1.0)
    y, fin, _ = ssd_passes(x, dt, A, Bm, Cm, D, chunk=128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
    close(y, ssd_reference(x, dt, A, Bm, Cm, D)[0], TOL["float32"])


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", STUDY_CASES)
def test_study_scan_without_roundings_is_the_oracle(B, S, H, P, G, N, chunk):
    """The design study's chunked scan with no bf16 rounding is the
    float32 scan: the oracle within its float32 tolerance."""
    x, dt, A, Bm, Cm, D, st = study.inputs(5, B, S, H, P, G, N, True, CPU,
                                           dtype=torch.float32)
    y, fin = study.rounded_scan(x, dt, A, Bm, Cm, D, chunk=chunk,
                                initial_state=st, round_wx=False,
                                round_scores=False, state_parts=0)
    yr, fr = ssd_reference(x, dt, A, Bm, Cm, D, initial_state=st)
    close(y, yr, ORACLE_TOL)
    close(fin, fr, ORACLE_TOL)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", STUDY_CASES)
def test_study_scan_with_the_kernels_roundings_is_the_mirror(B, S, H, P, G,
                                                             N, chunk):
    """With the kernel's roundings (w x and the scores to bf16, the
    entering state to bf16 hi + lo) the study's scan on bf16 values is
    `ssd_passes` on the bf16 inputs: the same state, and y but for its
    rounding to bf16."""
    x, dt, A, Bm, Cm, D, st = study.inputs(5, B, S, H, P, G, N, True, CPU)
    y, fin = study.rounded_scan(x.float(), dt, A, Bm.float(), Cm.float(), D,
                                chunk=chunk, initial_state=st,
                                round_wx=True, round_scores=True,
                                state_parts=2)
    yp, fp, _ = ssd_passes(x, dt, A, Bm, Cm, D, chunk=chunk,
                           initial_state=st)
    close(fin, fp, ORACLE_TOL)
    close(y, yp, TOL["bfloat16"])


def route_shapes():
    """Every reference, serving, timed and edge shape, with a label."""
    cases = [(f"ref{c}", c) for c in CASES]
    cases += [(label, c) for label, _, c in ssd_serving_cases()]
    cases += [(label, c) for label, _, c in ssd_timed_cases()]
    cases += [(f"tc{c}", c) for c in SSD_TC_CASES]
    cases += [(f"edge{c}", c) for c in ROUTE_EDGE_CASES]
    return cases


@pytest.mark.parametrize("label,case", route_shapes())
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_is_chip_smokes(label, case, dtype):
    """`ops.route` picks the instance chip_smoke.py's `ssd_route` names,
    on fresh tensors and on the tensor-core edge cases' fused views."""
    B, S, H, P, G, N, chunk = case[:7]
    if len(case) == 9 and case[8]:  # x, B and C as views of one projection
        fused = torch.empty((B, S, H * P + 2 * G * N), dtype=dtype)
        x = fused[..., :H * P].unflatten(-1, (H, P))
        Bm = fused[..., H * P:H * P + G * N].unflatten(-1, (G, N))
        Cm = fused[..., H * P + G * N:].unflatten(-1, (G, N))
    else:
        x = torch.empty((B, S, H, P), dtype=dtype)
        Bm = torch.empty((B, S, G, N), dtype=dtype)
        Cm = torch.empty((B, S, G, N), dtype=dtype)
    assert route(x, Bm, Cm, chunk) == ssd_route(dtype, P, N, chunk), label


def test_route_sends_misaligned_views_to_simt():
    """A view 2 bytes off a 16-byte boundary, or whose rows are not a
    multiple of 8 elements apart, takes the SIMT instance."""
    B, S, H, P, G, N = 1, 64, 2, 64, 1, 64
    bf = torch.bfloat16
    x = torch.empty((B, S, H, P), dtype=bf)
    Bm = torch.empty((B, S, G, N), dtype=bf)
    assert route(x, Bm, Bm, 256) == "mma"
    flat = torch.empty(x.numel() + 8, dtype=bf)
    shifted = flat[1:1 + x.numel()].view(x.shape)
    assert route(shifted, Bm, Bm, 256) == "simt"
    wide = torch.empty((B, S, H * P + 4), dtype=bf)     # rows 132 apart
    assert route(wide[..., :H * P].unflatten(-1, (H, P)), Bm, Bm,
                 256) == "simt"
    assert route(x, Bm, Bm, 256 - 64) == "mma"
    assert route(x, Bm, Bm, 100) == "simt"


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

def bwd_tensors(seed, case, dtype=torch.float32):
    """A backward case's numpy draws (`ssd_bwd_arrays`) as CPU tensors:
    x, B, C and dy in ``dtype``, the rest float32 (float64 for
    float64)."""
    B, S, H, P, G, N, chunk, init, dfinal = case
    arrays, dy, df = ssd_bwd_arrays(seed, B, S, H, P, G, N, init, dfinal)
    rest = torch.float64 if dtype == torch.float64 else torch.float32

    def t(a, to=rest):
        return None if a is None else torch.from_numpy(a).to(to)

    x, dt, A, Bm, Cm, D, st = arrays
    return ((t(x, dtype), t(dt), t(A), t(Bm, dtype), t(Cm, dtype), t(D),
             t(st)), t(dy, dtype), t(df))


def worst_rel(got, want) -> float:
    """max |got - want| / max |want| (0 where both are exactly 0: one
    step's dA)."""
    got, want = as_f32(got), as_f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("oracle", ["chunked", "sequential"])
def test_backward_reference_matches_jax_vjp(case, oracle):
    B, S, H, P, G, N, chunk, init, dfinal = case
    (x, dt, A, Bm, Cm, D, st), dy, df = bwd_tensors(3, case)
    got = ssd_backward_reference(x, dt, A, Bm, Cm, D, st, dy, df, chunk)
    arrays, dy_np, df_np = ssd_bwd_arrays(3, B, S, H, P, G, N, init,
                                          dfinal)
    jx = jax_inputs(arrays, "float32")
    primals = jx[:6] + ((jx[6],) if init else ())

    def f(*a):
        state = a[6] if init else None
        if oracle == "chunked":
            return ssd_chunked_jnp(*a[:6], chunk=chunk, initial_state=state)
        return ref_oracle(*a[:6], initial_state=state)

    (y, fin), vjp = jax.vjp(jax.jit(f), *primals)
    want = vjp((jnp.asarray(dy_np), jnp.zeros_like(fin) if df_np is None
                else jnp.asarray(df_np)))
    names = ["dx", "ddt", "dA", "dB", "dC", "dD", "dinit"]
    assert (got[6] is None) == (not init)
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert worst_rel(g, w) <= BWD_TOL, (name, worst_rel(g, w))


@pytest.mark.parametrize("case", BWD_CASES[-4:])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssdfn_matches_autograd_through_the_chunked_scan(case, dtype):
    """`SSDFn` on CPU tensors (`ssd_chunked` forward, the plain backward)
    against autograd through `ssd_chunked`, both outputs used; in
    bfloat16 the gradients of x, B and C come back in bfloat16."""
    chunk, init, dfinal = case[6:]
    inputs, dy, df = bwd_tensors(4, case, dtype)
    needs = [t.clone().requires_grad_() for t in inputs if t is not None]
    again = [t.clone().requires_grad_() for t in inputs if t is not None]
    state = (lambda ts: ts[6] if init else None)

    y, fin = SSDFn.apply(*needs[:6], state(needs), chunk)
    y_ref, fin_ref = ssd_chunked(*again[:6], chunk=chunk,
                                 initial_state=state(again))
    assert torch.equal(y, y_ref) and torch.equal(fin, fin_ref)
    loss = (y.float() * dy.float()).sum()
    loss_ref = (y_ref.float() * dy.float()).sum()
    if dfinal:
        loss = loss + (fin * df).sum()
        loss_ref = loss_ref + (fin_ref * df).sum()
    got = torch.autograd.grad(loss, needs)
    want = torch.autograd.grad(loss_ref, again)
    for g, w, t in zip(got, want, needs):
        assert g.dtype == t.dtype
        tol = BWD_TOL if dtype == torch.float32 else TOL["bfloat16"]
        assert worst_rel(g, w) <= tol


def test_chunked_gradient_stays_finite_where_masked_decays_overflow():
    """Decays of pairs j > i overflow float32 at mamba2's largest dt * |A|
    (0.1 x 16 a step: exp(+101) within a 64-step chunk); autograd through
    `ssd_chunked` must not turn their masked zeros into NaN.  Its
    gradients against the float64 plain backward: 1e-5 of each max, but
    dA's float32 sums cancel (autograd's is 4e-4 off here; the plain
    backward's float32 one 4e-5), so dA is held to 1e-3."""
    B, S, H, P, G, N, chunk = 1, 64, 2, 16, 1, 16, 64
    (x, dt, A, Bm, Cm, D, _), dy, _ = bwd_tensors(
        8, (B, S, H, P, G, N, chunk, False, False))
    dt = torch.full_like(dt, 0.1)
    A = torch.full_like(A, -16.0)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
    y, _ = ssd_chunked(*leaves, chunk=chunk)
    got = torch.autograd.grad((y * dy).sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    want = ssd_backward_reference(*(t.double() for t in (x, dt, A, Bm, Cm,
                                                          D)),
                                  None, dy.double(), None, chunk)
    for name, g, w in zip(["dx", "ddt", "dA", "dB", "dC", "dD"], got, want):
        tol = 1e-3 if name == "dA" else BWD_TOL
        assert worst_rel(g, w) <= tol, (name, worst_rel(g, w))


def test_ssdfn_unused_final_state_gives_no_gradient_tensor(monkeypatch):
    """Autograd hands the backward None for a final state nobody uses,
    and the backward makes no zeros for it."""
    case = BWD_CASES[-3]
    (x, dt, A, Bm, Cm, D, st), dy, _ = bwd_tensors(5, case)
    seen = []

    def spy(*args, dfinal=None, **kw):
        seen.append(dfinal)
        return ssd_backward_reference(*args[:6], kw["initial_state"],
                                      args[6], dfinal, kw["chunk"])

    monkeypatch.setattr("repro_torch.kernels.ssd.ops.ssd_backward", spy)
    x.requires_grad_()
    y, _ = SSDFn.apply(x, dt, A, Bm, Cm, D, st, case[6])
    (gx,) = torch.autograd.grad((y * dy).sum(), [x])
    assert seen == [None]
    want = ssd_backward_reference(x.detach(), dt, A, Bm, Cm, D, st, dy, None,
                                  case[6])[0]
    assert torch.equal(gx, want)


@pytest.mark.parametrize("init", [False, True])
def test_ssdfn_gradcheck(init):
    """Finite differences of `SSDFn` in float64 (the plain forward and
    backward accumulate in float64 there): every input, both outputs,
    a ragged second chunk and G = 2."""
    case = (1, 7, 4, 3, 2, 2, 4, init, True)
    inputs, _, _ = bwd_tensors(6, case, torch.float64)
    leaves = [t.requires_grad_() for t in inputs if t is not None]

    def fn(*ts):
        return SSDFn.apply(*ts[:6], ts[6] if init else None, 4)

    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-7)


def test_bwd_study_needs_a_card(monkeypatch, capsys):
    """The backward study times device work only: without a CUDA device
    it prints why and returns 1, timing nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bwd_study.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_cpu_backward_entry_points_are_the_plain_versions():
    """On CPU tensors `ssd_forward` keeps nothing and `ssd_backward` is
    the plain backward; neither counts a launch."""
    case = BWD_CASES[-4]
    (x, dt, A, Bm, Cm, D, st), dy, df = bwd_tensors(7, case)
    before = dict(launch_counts), dict(bwd_route_counts)
    y, fin, kept = ssd_forward(x, dt, A, Bm, Cm, D, chunk=case[6],
                               initial_state=st)
    assert kept is None
    assert all(torch.equal(a, b) for a, b in zip(
        (y, fin), ssd_chunked(x, dt, A, Bm, Cm, D, chunk=case[6],
                              initial_state=st)))
    got = ssd_backward(x, dt, A, Bm, Cm, D, dy, chunk=case[6],
                       initial_state=st, dfinal=df)
    want = ssd_backward_reference(x, dt, A, Bm, Cm, D, st, dy, df, case[6])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (dict(launch_counts), dict(bwd_route_counts)) == before


@pytest.mark.parametrize("label,case", route_shapes())
def test_bwd_route_is_the_forwards(label, case):
    """The backward takes the forward's instance, so the tensor-core
    backward always finds the tensor-core forward's bf16 states."""
    B, S, H, P, G, N, chunk = case[:7]
    x = torch.empty((B, S, H, P), dtype=torch.bfloat16)
    bc = torch.empty((B, S, G, N), dtype=torch.bfloat16)
    assert bwd_route(x, bc, bc, chunk) == route(x, bc, bc, chunk), label
