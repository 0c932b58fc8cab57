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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.kernel import ssd_pallas
from repro.kernels.ssd.ops import ssd_decode_step as ref_decode_step
from repro.kernels.ssd.ref import ssd_reference as ref_oracle
from repro_torch.kernels.build import launch_counts
from repro_torch.kernels.ssd import ssd, ssd_chunked, ssd_decode_step
from repro_torch.kernels.ssd.ref import ssd_reference
from test_kernel_ssd import CASES
from test_torch_cuda import SSD_CASES, ssd_arrays, ssd_inputs
from test_torch_matchmaker import one_torch_thread  # noqa: F401

TOL = {"float32": 2e-3, "bfloat16": 5e-2}
ORACLE_TOL = 1e-5
STEP_TOL = 1e-6
CPU = torch.device("cpu")


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
