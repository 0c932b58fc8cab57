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

The gradient (`gmm_backward_reference`, the plain backward that
`gmm_bwd.cu` is held against) is that of ``jax.vjp`` of the JAX
package's ``ops.gmm`` (``lax.ragged_dot``):

  dlhs[t] = dout[t] @ rhs[e(t)]^T            (zero for padding rows)
  drhs[e] = lhs[rows of e]^T @ dout[rows of e]   (zero for an empty group)
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


def gmm_backward_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                           group_sizes: torch.Tensor, dout: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dlhs, drhs) of ``gmm(lhs, rhs, group_sizes)`` for the output
    gradient ``dout`` (T, N): one float32 product pair per group, no
    gather; padding rows' dlhs and an empty group's drhs are zero, and a
    group reaching past row T is cut there, as ``ops.gmm_plain`` cuts it.
    The gradients come back in lhs's and rhs's dtypes."""
    T = lhs.shape[0]
    dlhs = torch.zeros(lhs.shape, dtype=torch.float32, device=lhs.device)
    drhs = torch.zeros(rhs.shape, dtype=torch.float32, device=rhs.device)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), T)
        if end > start:
            d = dout[start:end].float()
            dlhs[start:end] = d @ rhs[g].float().T
            drhs[g] = lhs[start:end].float().T @ d
        start = end
    return dlhs.to(lhs.dtype), drhs.to(rhs.dtype)


__all__ = ["expert_of_row", "gmm_reference", "gmm_backward_reference"]
