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

`ssd_passes` is the plain-PyTorch mirror of the tensor-core instance of
`ssd.cu` (its chunk-parallel passes, 64-row tiles, and, for
bfloat16 inputs, its bf16 roundings), held against the oracle by the
tests.
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


#: rows of the tensor-core instance's query and key tiles
TILE = 64


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def ssd_passes(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 256,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three passes of the tensor-core instance, in plain PyTorch:
    (1) per chunk, cumA and the state contribution (w x)^T B with
    w_j = exp(tot - cumA_j) dt_j; (2) the chunk-to-chunk recurrence; (3)
    per 64-row query tile, the inter-chunk term exp(cumA_i) C_i S_enter^T
    and the key tiles at or before the diagonal (scores masked, decayed
    and scaled by dt on pairs j <= i only), then D x.  Chunks are Q =
    min(chunk, S) steps, the last one ragged.  For bfloat16 x it rounds
    where the kernel does: w x to bf16, the scores to bf16 before
    scores @ x, and the entering state to bf16 hi + lo.  Returns (y
    (B,S,H,P) in x's dtype, final state (B,H,P,N), the state entering
    each chunk (B,nc,H,P,N))."""
    Bsz, S, H, P = x.shape
    Q = min(chunk, S)
    n_chunks = -(-S // Q)
    bf16 = x.dtype == torch.bfloat16

    def rnd(t):
        return _round_bf16(t) if bf16 else t

    xf, dtf, Af, Df = x.float(), dt.float(), A.float(), D.float()
    Bh = expand_groups(Bm.float(), H, 2)            # (B, S, H, N)
    Ch = expand_groups(Cm.float(), H, 2)
    spans = [(t0, min(Q, S - t0)) for t0 in range(0, S, Q)]

    # pass 1: cumA and the chunk's own state contribution
    cums, contribs = [], []
    for t0, L in spans:
        steps = slice(t0, t0 + L)
        cum = torch.cumsum(dtf[:, steps] * Af, dim=1)        # (B, L, H)
        w = torch.exp(cum[:, -1:] - cum) * dtf[:, steps]
        wx = rnd(w[..., None] * xf[:, steps])
        contribs.append(torch.einsum("bjhp,bjhn->bhpn", wx, Bh[:, steps]))
        cums.append(cum)

    # pass 2: the state entering each chunk, and the final state
    state = (torch.zeros((Bsz, H, *contribs[0].shape[2:]),
                         dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    entering = []
    for cum, contrib in zip(cums, contribs):
        entering.append(state)
        state = torch.exp(cum[:, -1])[:, :, None, None] * state + contrib

    # pass 3: the chunk's outputs, tile by tile
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
    for (t0, L), cum, enter in zip(spans, cums, entering):
        if bf16:
            hi = _round_bf16(enter)
            enter = hi + _round_bf16(enter - hi)
        for i0 in range(0, L, TILE):
            i1 = min(i0 + TILE, L)
            Ci = Ch[:, t0 + i0:t0 + i1]
            ci = cum[:, i0:i1]
            acc = torch.einsum("bihn,bhpn->bihp", Ci, enter) \
                * torch.exp(ci)[..., None]
            for j0 in range(0, i0 + 1, TILE):
                j1 = min(j0 + TILE, L)
                keys = slice(t0 + j0, t0 + j1)
                scores = torch.einsum("bihn,bjhn->bijh", Ci, Bh[:, keys])
                rows = torch.arange(i0, i1, device=x.device)[:, None]
                cols = torch.arange(j0, j1, device=x.device)[None]
                mask = (cols <= rows)[None, :, :, None]
                diff = ci[:, :, None, :] - cum[:, None, j0:j1, :]
                decay = torch.where(mask, torch.exp(torch.where(mask, diff,
                                                                0.0)), 0.0)
                scores = rnd(scores * decay * dtf[:, None, keys, :])
                acc = acc + torch.einsum("bijh,bjhp->bihp", scores,
                                         xf[:, keys])
            y[:, t0 + i0:t0 + i1] = acc + Df[None, None, :, None] \
                * xf[:, t0 + i0:t0 + i1]
    return y.to(x.dtype), state, torch.stack(entering, dim=1)
