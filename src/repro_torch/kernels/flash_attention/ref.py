"""Plain PyTorch version of position-masked GQA attention.

The same semantics as the JAX package's dense oracle
(``repro/kernels/flash_attention/ref.py``), which the Hopper kernel
(`flash_attention.cu`) is held against:

  q:      (B, Sq, Hq, Dh)
  k, v:   (B, Skv, Hkv, Dh)   with Hq % Hkv == 0 (GQA, group-major heads)
  q_pos:  (B, Sq)  int32 absolute positions of the query tokens
  kv_pos: (B, Skv) int32 absolute positions of cached kv tokens; -1 = empty

  valid(b, i, j) =  kv_pos[b,j] >= 0
                  & (not causal  or kv_pos[b,j] <= q_pos[b,i])
                  & (window is None or q_pos[b,i] - kv_pos[b,j] < window)

Softmax and the value sum are computed in float32 over the valid set;
fully masked rows return 0.  Optional logit soft-capping:
logits = cap * tanh(logits / cap).

With ``return_lse`` `attention_reference` also returns each row's
log-sum-exp of its valid logits, m + log l, float32 (B, Sq, Hq), +inf for
a row that sees no key: what the forward kernel writes for the backward.

`attention_backward_reference` is the plain version of the backward
kernel (`flash_attention_bwd.cu`): the gradients of `attention_reference`
by their explicit formulas, given its output and log-sum-exp, in float32
math (the SIMT instance's).  `attention_backward_passes` mirrors the
tensor-core instance's roundings: P and dS rounded to bfloat16 before
their products, float32 sums.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                   causal: bool, window: int | None) -> torch.Tensor:
    """Boolean mask (B, Sq, Skv); True = attend."""
    qp = q_pos[:, :, None].to(torch.int32)
    kp = kv_pos[:, None, :].to(torch.int32)
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window is not None:
        valid = valid & ((qp - kp) < window)
    return valid


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)

    qf = q.float().reshape(B, Sq, Hkv, G, Dh)
    kf, vf = k.float(), v.float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)

    mask = attention_mask(q_pos, kv_pos, causal=causal,
                          window=window)[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    # guard fully masked rows: their max is NEG_INF; shift to avoid NaN
    m = torch.clamp(m, min=NEG_INF / 2)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.clamp(l, min=1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    out = out.reshape(B, Sq, Hq, Dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), torch.inf)[..., 0]
    return out, lse.permute(0, 3, 1, 2).reshape(B, Sq, Hq)


def attention_split_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    keys_per_split: int,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """The decode instance's two passes in plain torch, for the tests:
    each range of ``keys_per_split`` cache slots gives a part (m floored
    at NEG_INF/2, l, acc) of each query row, and the parts are merged in
    order: m = max m_s, weights exp(m_s - m), out = sum w acc_s / max(sum
    w l_s, 1e-30).  A part with no valid key has l = 0 and acc = 0."""
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    qf = q.float().reshape(B, Sq, Hkv, G, Dh)
    mask = attention_mask(q_pos, kv_pos, causal=causal,
                          window=window)[:, None, None]
    parts = []
    for s0 in range(0, Skv, keys_per_split):
        ks = slice(s0, min(Skv, s0 + keys_per_split))
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                              k[:, ks].float()) * scale
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        mk = mask[..., ks]
        logits = torch.where(mk, logits, NEG_INF)
        m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
        p = torch.where(mk, torch.exp(logits - m), 0.0)
        acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, ks].float())
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
    m = torch.clamp(torch.stack([m for m, _, _ in parts]).amax(0),
                    min=NEG_INF / 2)
    l = sum(torch.exp(ms - m) * ls for ms, ls, _ in parts)
    acc = sum(torch.exp(ms - m) * a for ms, _, a in parts)
    out = acc / torch.clamp(l, min=1e-30)                 # (B, Hkv, G, Sq, Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)


def _backward_terms(q, k, v, o, dout, lse, q_pos, kv_pos, causal, window,
                    softcap, scale):
    """P, dS and the float32 operands of the backward's products: q and k
    as (B, Hkv, G, Sq, Dh) / (B, Skv, Hkv, Dh) float32, P = exp(c - lse)
    over the valid keys and 0 elsewhere, dS = P (dP - D) (times 1 - tanh^2
    under a softcap)."""
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    qf = q.float().reshape(B, Sq, Hkv, G, Dh)
    of = o.float().reshape(B, Sq, Hkv, G, Dh)
    dof = dout.float().reshape(B, Sq, Hkv, G, Dh)
    kf, vf = k.float(), v.float()
    raw = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    logits = raw
    if softcap is not None:
        tanh = torch.tanh(raw / softcap)
        logits = softcap * tanh
    mask = attention_mask(q_pos, kv_pos, causal=causal,
                          window=window)[:, None, None]
    rows = lse.float().reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)[..., None]
    # a row that sees no key has lse = +inf: exp(c - lse) = 0 everywhere
    p = torch.where(mask, torch.exp(logits - rows), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    D = (dof * of).sum(dim=-1).permute(0, 2, 3, 1)[..., None]  # (B,Hkv,G,Sq,1)
    ds = p * (dp - D)
    if softcap is not None:
        ds = ds * (1.0 - tanh * tanh)
    return p, ds, qf, kf, dof, scale


def attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of `attention_reference` at output ``o``
    for the output gradient ``dout``, given its log-sum-exp ``lse``
    ((B, Sq, Hq), as ``return_lse`` gives it), in float32 math, returned
    in q's and k's dtypes.  With raw scores s = scale q.k, logits c = s,
    or cap tanh(s / cap), and P = exp(c - lse) over the valid keys (0
    elsewhere), as the kernel forms it:

        dP = dO V^T,   D = sum_d dO * O   (per query row and head),
        dS = P * (dP - D) * (1 - tanh^2(s / cap) with a softcap),
        dq = scale dS K,  dk = scale dS^T Q,  dv = P^T dO,

    dk and dv summed over the G query heads of each kv head.  A fully
    masked row has lse = +inf and P = 0, so it gives dq = 0 and adds
    nothing to dk, dv."""
    B, Sq, Hq, Dh = q.shape
    p, ds, qf, kf, dof, scale = _backward_terms(
        q, k, v, o, dout, lse, q_pos, kv_pos, causal, window, softcap, scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(B, Sq, Hq, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_backward_passes(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tensor-core instance's roundings in plain torch, for the
    tests: P and dS formed in float32 as `attention_backward_reference`
    forms them (dS from the float32 P), then each rounded to bfloat16
    before its products (dv = P^T dO, dk = scale dS^T Q, dq = scale dS K,
    float32 sums), each gradient rounded once to its input's dtype."""
    B, Sq, Hq, Dh = q.shape
    p, ds, qf, kf, dof, scale = _backward_terms(
        q, k, v, o, dout, lse, q_pos, kv_pos, causal, window, softcap, scale)
    p = p.to(torch.bfloat16).float()
    ds = ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(B, Sq, Hq, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


__all__ = ["NEG_INF", "attention_mask", "attention_reference",
           "attention_split_reference", "attention_backward_reference",
           "attention_backward_passes"]
