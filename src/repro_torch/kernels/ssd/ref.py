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

`ssd_backward_reference` is the plain backward of the chunked scan: the
gradients of y and the final state with respect to every input, from
closed forms chunk by chunk (no autograd).  It is the oracle of
`ssd_bwd.cu` and is held against ``jax.vjp`` of the JAX package's
chunked scan by the tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation dtype: float64 for float64
    inputs (gradcheck), float32 for everything else."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def ssd_backward_reference(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    initial_state: torch.Tensor | None,
    dy: torch.Tensor | None,
    dfinal: torch.Tensor | None,
    chunk: int = 256,
) -> tuple:
    """The gradients (dx, ddt, dA, dBm, dCm, dD, dinit) of the chunked
    scan (`ops.ssd_chunked`) for the output gradient ``dy`` (B,S,H,P) and
    the final state's ``dfinal`` (B,H,P,N); None for either means 0.
    Each comes back in its input's dtype; dinit is None without an
    initial state.  Per batch row, head and chunk (Q = min(chunk, S)
    steps, the last one ragged), with a_t = dt_t A, cum the inclusive
    cumsum of a over the chunk, tot its last value, L_ij = exp(cum_i -
    cum_j) on j <= i, w_j = exp(tot - cum_j) dt_j, S_prev / S_after the
    states entering and leaving the chunk and G the gradient of S_after:

      G_{c-1} = exp(tot_c) G_c + sum_i exp(cum_i) dy_i^T C_i
      dx_j  = sum_{i>=j} (C_i.B_j) L_ij dt_j dy_i + w_j G B_j + D dy_j
      dB_j  = sum_{i>=j} (dy_i.x_j) L_ij dt_j C_i + w_j G^T x_j
      dC_i  = sum_{j<=i} (dy_i.x_j) L_ij dt_j B_j + exp(cum_i) S_prev^T dy_i
      dcum_i = sum_{j<i} M_ij - sum_{k>i} M_ki + dy_i.y_inter_i,
               M_ij = (C_i.B_j) L_ij dt_j (dy_i.x_j),
               y_inter_i = exp(cum_i) S_prev C_i
      da_j  = sum_{i>=j} dcum_i + sum_{i<j} T_i + exp(tot) <G, S_prev>,
               T_i = w_i x_i.G B_i
      ddt_j = sum_{i>=j} (C_i.B_j) L_ij (dy_i.x_j)
              + exp(tot - cum_j) x_j.G B_j + A da_j,   dA = sum dt da

    (da's state terms are the gradient of tot, <G, S_after>, less the
    weights' sum_{i>=j} T_i, folded so that the two do not cancel.)

    dB and dC sum over each group's heads; dD = sum dy.x."""
    Bsz, S, H, P = x.shape
    G_, N = Bm.shape[2], Bm.shape[3]
    f = acc_dtype(x)
    dev = x.device
    Q = min(chunk, S)
    xf, dtf, Af, Df = x.to(f), dt.to(f), A.to(f), D.to(f)
    Bh = expand_groups(Bm.to(f), H, 2)               # (B, S, H, N)
    Ch = expand_groups(Cm.to(f), H, 2)
    dyf = (torch.zeros_like(xf) if dy is None else dy.to(f))
    spans = [(t0, min(Q, S - t0)) for t0 in range(0, S, Q)]

    # forward: cum per chunk and the state entering each chunk
    state = (torch.zeros((Bsz, H, P, N), dtype=f, device=dev)
             if initial_state is None else initial_state.to(f))
    cums, entering = [], []
    for t0, L in spans:
        steps = slice(t0, t0 + L)
        cum = torch.cumsum(dtf[:, steps] * Af, dim=1)          # (B, L, H)
        w = torch.exp(cum[:, -1:] - cum) * dtf[:, steps]
        entering.append(state)
        state = torch.exp(cum[:, -1])[:, :, None, None] * state \
            + torch.einsum("bjh,bjhp,bjhn->bhpn", w, xf[:, steps],
                           Bh[:, steps])
        cums.append(cum)

    dx = torch.empty_like(xf)
    ddt = torch.empty_like(dtf)
    dBh = torch.empty_like(Bh)
    dCh = torch.empty_like(Ch)
    dA = torch.zeros(H, dtype=f, device=dev)
    Gc = (torch.zeros((Bsz, H, P, N), dtype=f, device=dev)
          if dfinal is None else dfinal.to(f))
    for (t0, L), cum, S_prev in reversed(list(zip(spans, cums, entering))):
        steps = slice(t0, t0 + L)
        xc, dyc, dtc = xf[:, steps], dyf[:, steps], dtf[:, steps]
        Bc, Cc = Bh[:, steps], Ch[:, steps]
        tot = cum[:, -1]                                         # (B, H)
        ones = torch.ones((L, L), dtype=torch.bool, device=dev)
        mask = torch.tril(ones)[None, :, :, None]
        below = torch.tril(ones, -1)[None, :, :, None]
        diff = cum[:, :, None, :] - cum[:, None, :, :]           # (B,i,j,H)
        Lij = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)),
                          0.0)
        CB = torch.einsum("bihn,bjhn->bijh", Cc, Bc)
        DX = torch.einsum("bihp,bjhp->bijh", dyc, xc)
        Wij = Lij * dtc[:, None, :, :]
        e_tot = torch.exp(tot[:, None, :] - cum)                 # (B, L, H)
        w = e_tot * dtc
        e_cum = torch.exp(cum)
        GB = torch.einsum("bhpn,bjhn->bjhp", Gc, Bc)
        Gx = torch.einsum("bhpn,bjhp->bjhn", Gc, xc)
        Sdy = torch.einsum("bhpn,bihp->bihn", S_prev, dyc) \
            * e_cum[..., None]
        dx[:, steps] = (torch.einsum("bijh,bihp->bjhp", CB * Wij, dyc)
                        + w[..., None] * GB + Df[:, None] * dyc)
        dBh[:, steps] = (torch.einsum("bijh,bihn->bjhn", DX * Wij, Cc)
                         + w[..., None] * Gx)
        dCh[:, steps] = (torch.einsum("bijh,bjhn->bihn", DX * Wij, Bc)
                         + Sdy)
        z = (xc * GB).sum(-1)                                    # (B, L, H)
        # M_ii is added and taken away: both sums leave it out
        M = torch.where(below, CB * Wij * DX, 0.0)
        dcum = M.sum(2) - M.sum(1) + (Cc * Sdy).sum(-1)
        T_before = torch.cumsum(w * z, 1)[:, :-1]
        da = (torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
              + F.pad(T_before, (0, 0, 1, 0))
              + (torch.exp(tot) * (Gc * S_prev).sum((-2, -1)))[:, None])
        ddt[:, steps] = ((CB * Lij * DX).sum(1) + e_tot * z
                         + Af * da)
        dA += (dtc * da).sum((0, 1))
        Gc = torch.exp(tot)[:, :, None, None] * Gc + torch.einsum(
            "bih,bihp,bihn->bhpn", e_cum, dyc, Cc)
    dD = (dyf * xf).sum((0, 1, 3))
    dB = dBh.unflatten(2, (G_, H // G_)).sum(3)
    dC = dCh.unflatten(2, (G_, H // G_)).sum(3)
    dinit = None if initial_state is None else Gc.to(initial_state.dtype)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(Bm.dtype), dC.to(Cm.dtype), dD.to(D.dtype), dinit)
