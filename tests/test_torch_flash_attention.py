"""The port's `flash_attention` on CPU tensors against the JAX package's
Pallas kernel (interpret mode) and its dense oracle.

On a CPU tensor the port's wrapper runs its plain PyTorch version; the
same numpy inputs go through `flash_attention_pallas(interpret=True)` and
`attention_reference`.  Tolerances are the reference suite's own
(tests/test_kernel_flash_attention.py): 2e-5 for float32 inputs, 2e-2
for bfloat16, whose output is rounded to bf16 (an ulp of 2^-8 relative)
on both sides.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.build import launch_counts
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_mask
from test_kernel_flash_attention import CASES
from test_torch_cuda import (
    FLASH_CASES, check_fully_masked_rows, check_rolling_window,
)
from test_torch_matchmaker import one_torch_thread  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def inputs(rng, B, Sq, Skv, Hq, Hkv, Dh, dtype):
    """The reference suite's `_mk`: normal q/k/v, queries at the last Sq
    positions, every 7th cache slot empty."""
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    q = rng.standard_normal((B, Sq, Hq, Dh)).astype(np_dt)
    k = rng.standard_normal((B, Skv, Hkv, Dh)).astype(np_dt)
    v = rng.standard_normal((B, Skv, Hkv, Dh)).astype(np_dt)
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32),
                         (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    kp[:, ::7] = -1
    return q, k, v, qp, kp


def to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_cuda_cases_are_the_reference_cases():
    assert FLASH_CASES == CASES


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh,causal,window,softcap", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_pallas_and_oracle(rng, B, Sq, Skv, Hq, Hkv, Dh,
                                        causal, window, softcap, dtype):
    q, k, v, qp, kp = inputs(rng, B, Sq, Skv, Hq, Hkv, Dh, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = dict(launch_counts)
    out = flash_attention(*map(to_torch, (q, k, v, qp, kp)), **kw)
    assert launch_counts == before          # the CPU branch launches nothing
    assert out.dtype == to_torch(q).dtype and out.shape == q.shape
    jx = [jnp.asarray(a) for a in (q, k, v, qp, kp)]
    pallas = flash_attention_pallas(*jx, interpret=True, **kw)
    oracle = attention_reference(*jx, **kw)
    tol = TOL[dtype]
    for ref in (pallas, oracle):
        np.testing.assert_allclose(as_f32(out), as_f32(ref), atol=tol,
                                   rtol=tol)


def test_fully_masked_rows_give_zero():
    check_fully_masked_rows(flash_attention, torch.device("cpu"))


def test_rolling_window_is_permutation_invariant():
    check_rolling_window(flash_attention, torch.device("cpu"))


def test_mask_rule():
    qp = torch.tensor([[5, 9]], dtype=torch.int32)
    kp = torch.tensor([[-1, 3, 5, 6, 8]], dtype=torch.int32)
    m = attention_mask(qp, kp, causal=True, window=4)
    assert m.tolist() == [[[False, True, True, False, False],
                           [False, False, False, True, True]]]
    # only empty slots are masked: broadcastable over queries, as in JAX
    m = attention_mask(qp, kp, causal=False, window=None)
    assert m.expand(1, 2, 5).tolist() == [[[False, True, True, True, True]] * 2]


def test_other_devices_are_refused():
    q = torch.zeros((1, 1, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(q, q, q, torch.zeros((1, 1), dtype=torch.int32),
                        torch.zeros((1, 1), dtype=torch.int32))
