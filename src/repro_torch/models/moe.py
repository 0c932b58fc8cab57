"""Mixture-of-Experts block: top-k router and the capacity dispatch.

The port of the JAX package's ``models/moe.py`` (``moe_forward_dense``):
GShard-style capacity dispatch.  Each token picks its top-k experts from
a float32 softmax router; an (expert, rank) place is kept only while the
rank, counted over the flattened (token, slot) assignments in token-major
order, is below the capacity C = max(1, ceil(T·k·cf/E)), so the same
tokens overflow and are dropped as in the reference (standard Switch
behaviour), and a Switch-style load-balancing auxiliary loss is
returned beside the output.

The reference's expert products are the capacity-padded einsums
``ecd,edf->ecf``: a grouped matmul with every group of C rows, rows
sorted by expert.  Here they go through `kernels.moe_gmm.gmm` on the
(E·C, d) capacity buffer with ``group_sizes = [C]*E`` and float32 output
(the einsums' ``preferred_element_type``): the Hopper kernel on CUDA
tensors, its plain version on CPU tensors.  The dispatch and combine
einsums over one-hot tensors (``tec,td->ecd``, ``tec,ecd->td``) become an
exact index write and gather of the same values: each (expert, rank)
place holds at most one token, and a token's k gated expert outputs are
summed in float32 and rounded once to the activation dtype, as the
combine einsum does.

The layer is differentiable as it stands.  The expert products' gradient
is `gmm`'s (`moe_gmm.ops.GmmFn`: the backward kernel on CUDA tensors, its
float32 cotangent rounded once to bfloat16 for the tensor cores, the plain
backward on CPU tensors); autograd differentiates the rest: the index
write and the gather, ``repeat_interleave``, the float32 ``silu`` product
and the router's float32 softmax and top-k.  The gather's backward
accumulates with duplicate indices only into the overflow row ``E·C``,
whose gradient is discarded, so nothing the model uses depends on the
order of those atomic adds: two backward passes give the same bits.

The expert-parallel all-to-all path (``moe_forward_ep``) belongs to the
reference's ``parallel/`` work and is not ported (ROADMAP Queue 1 item
14).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm.ops import gmm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, init_mlp
from repro_torch.models.param import Init


def init_moe(init: Init, cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, dt = cfg.d_model, cfg.param_dtype
    f = m.d_ff_expert
    p = {
        "router": init.dense((d, m.n_experts), "float32"),
        "gate": init.dense((m.n_experts, d, f), dt, fan_in=d),
        "up": init.dense((m.n_experts, d, f), dt, fan_in=d),
        "down": init.dense((m.n_experts, f, d), dt, fan_in=f),
    }
    if m.n_shared_experts > 0:
        p["shared"] = init_mlp(init, d, f * m.n_shared_experts, dt,
                               gated=cfg.gated_mlp)
    return p


def _router_topk(logits: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 softmax router.  Returns (probs (T,E), gates (T,k), idx
    (T,k))."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return probs, gates, idx


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Switch load-balance loss: E * sum_e f_e * P_e (local estimate)."""
    T = probs.shape[0]
    counts = torch.zeros((n_experts,), dtype=torch.float32,
                         device=probs.device)
    counts.index_add_(0, idx.reshape(-1),
                      torch.ones(idx.numel(), device=probs.device))
    f = counts / max(T * idx.shape[1], 1)
    return n_experts * torch.sum(f * probs.mean(dim=0))


def capacity(cfg: ModelConfig, T: int) -> int:
    m = cfg.moe
    return max(1, math.ceil(T * m.top_k * m.capacity_factor / m.n_experts))


def moe_forward_dense(p: dict, cfg: ModelConfig, x: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, d) in x's dtype, aux (float32 scalar))."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    logits = xt.float() @ p["router"].float()
    probs, gates, idx = _router_topk(logits, k)
    aux = _aux_loss(probs, idx, E)

    C = capacity(cfg, T)
    # rank of each (token, slot) within its expert queue, counted over the
    # token-major flattened assignments
    flat = F.one_hot(idx.reshape(T * k), E)                 # (T·k, E)
    rank = ((torch.cumsum(flat, dim=0) * flat).sum(dim=1) - 1)
    kept = rank < C
    # capacity place of each assignment; overflow goes to a scratch row
    place = torch.where(kept, idx.reshape(-1) * C + rank, E * C)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[place] = xt.repeat_interleave(k, dim=0)
    ex_in = buf[:E * C]

    sizes = torch.full((E,), C, dtype=torch.int32, device=x.device)
    h = gmm(ex_in, p["gate"], sizes, out_dtype=torch.float32)
    u = gmm(ex_in, p["up"], sizes, out_dtype=torch.float32)
    h = (F.silu(h) * u).to(x.dtype)
    ex_out = gmm(h, p["down"], sizes, out_dtype=torch.float32).to(x.dtype)

    out_rows = torch.cat([ex_out, ex_out.new_zeros((1, d))])[place]
    g = gates.to(x.dtype).reshape(T * k, 1)
    y = (g.float() * out_rows.float()).reshape(T, k, d).sum(dim=1)
    y = y.to(x.dtype)

    if "shared" in p:
        y = y + apply_mlp(p["shared"], xt, gated=cfg.gated_mlp, act=cfg.act)
    return y.reshape(B, S, d), aux


def moe_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense dispatch; a mesh (the reference's expert-parallel path)
    is refused."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_forward with a mesh (the expert-parallel all-to-all "
            "moe_forward_ep) is not ported yet (ROADMAP Queue 1 item 14)")
    return moe_forward_dense(p, cfg, x)


__all__ = ["init_moe", "moe_forward_dense", "moe_forward", "capacity"]
