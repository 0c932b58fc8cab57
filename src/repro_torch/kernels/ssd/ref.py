"""Sequential-scan oracle for the Mamba2 SSD (state-space duality) op.

The port of the JAX package's ``repro/kernels/ssd/ref.py``; the Hopper
kernel (`ssd.cu`) and the plain chunked version (`ops.ssd_chunked`) are
held against it.  Shapes (Mamba2 conventions):

  x:  (B, S, H, P)   inputs per head            (P = head_dim)
  dt: (B, S, H)      positive step sizes        (softplus already applied)
  A:  (H,)           negative decay per head    (A = -exp(A_log))
  Bm: (B, S, G, N)   input projections          (N = d_state, G = ngroups)
  Cm: (B, S, G, N)   output projections
  D:  (H,)           skip connection

Recurrence (per head h, group g = h // (H // G)):

  state_t = exp(dt_t * A_h) * state_{t-1} + dt_t * x_t  (outer) Bm_t
  y_t     = state_t @ Cm_t + D_h * x_t

state: (P, N).  All math in float32; the output is cast back to x.dtype.
"""
from __future__ import annotations

import torch


def expand_groups(t: torch.Tensor, n_heads: int, axis: int) -> torch.Tensor:
    """Repeats each group of ``t`` along ``axis`` over its heads (group g
    to heads g*H/G .. (g+1)*H/G - 1), as ``jnp.repeat`` does."""
    G = t.shape[axis]
    shape = list(t.shape)
    shape.insert(axis + 1, n_heads // G)
    return t.unsqueeze(axis + 1).expand(shape).flatten(axis, axis + 1)


def ssd_reference(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    xf, dtf, Af, Df = x.float(), dt.float(), A.float(), D.float()
    Bh = expand_groups(Bm.float(), H, 2)            # (B, S, H, N)
    Ch = expand_groups(Cm.float(), H, 2)
    if initial_state is None:
        state = torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                            device=x.device)
    else:
        state = initial_state.float()
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)[:, :, None, None]
        delta = (dtf[:, t, :, None] * xf[:, t])[..., None] \
            * Bh[:, t, :, None, :]
        state = decay * state + delta
        yt = torch.einsum("bhpn,bhn->bhp", state, Ch[:, t])
        ys.append(yt + Df[None, :, None] * xf[:, t])
    y = torch.stack(ys, dim=1).to(x.dtype)
    return y, state
