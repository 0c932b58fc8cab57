"""Oracle for the expert-grouped matmul (ragged GEMM, MegaBlocks-style).

The port of the JAX package's ``repro/kernels/moe_gmm/ref.py``; the
Hopper kernel (`gmm.cu`) and the plain version (`ops.gmm_plain`) are held
against it.  Layout: tokens are pre-sorted by expert into one flat
activation matrix.

  lhs:         (T, K)    sorted token activations
  rhs:         (E, K, N) per-expert weights
  group_sizes: (E,)      int32; sum(group_sizes) <= T (tail rows are padding)

out[t] = lhs[t] @ rhs[e(t)] where e(t) is the expert owning row t, i.e. the
unique e with  offsets[e] <= t < offsets[e+1],  offsets = cumsum(group_sizes).
Padding rows (t >= sum(group_sizes)) produce zeros.
"""
from __future__ import annotations

import torch


def expert_of_row(group_sizes: torch.Tensor, T: int) -> torch.Tensor:
    """(T,) int32 expert id per row; rows past the total get E (out of
    range)."""
    offsets = torch.cumsum(group_sizes, 0)          # (E,) end offset per expert
    rows = torch.arange(T, dtype=offsets.dtype, device=group_sizes.device)
    # expert id = number of offsets <= row index
    return (rows[:, None] >= offsets[None, :]).sum(1).to(torch.int32)


def gmm_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                  group_sizes: torch.Tensor) -> torch.Tensor:
    T = lhs.shape[0]
    E = rhs.shape[0]
    eid = expert_of_row(group_sizes, T).long()
    valid = eid < E
    w = rhs[eid.clamp(max=E - 1)]       # (T, K, N) gather: oracle only, at test sizes
    out = torch.einsum("tk,tkn->tn", lhs.float(), w.float())
    out = torch.where(valid[:, None], out, 0.0)
    return out.to(lhs.dtype)


__all__ = ["expert_of_row", "gmm_reference"]
