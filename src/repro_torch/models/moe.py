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

Expert parallelism (``moe_forward_ep``, the reference's shard_map body
``_ep_local``) runs on a `launch.mesh.WorkerMesh`, one rank per mesh
coordinate: experts cut over "data" (E/|data| a rank), the expert FF dim
over "model", the block replicated over "pod".  Each rank routes its own
tokens, sorts the (token, slot) assignments by destination rank into
buffers of ``C_send`` rows (overflow dropped), exchanges them and their
local expert ids with an all-to-all over "data", sorts what it received
by local expert into groups of ``cap_e`` rows, runs the three expert
products on `gmm` over those groups (the reference's einsums; the Hopper
kernel on CUDA tensors, forward and backward), sums the down-projection
partials over "model" in the activation dtype (bfloat16 on the wire),
sends the rows back with the reverse all-to-all and combines them at the
sender with the gates, summed in float32 as the dense path does.  ``aux``
is the mean of the ranks' local estimates (`parallel.collectives.
share_mean`).  Where the model's rows are also cut over "model" (the
zero3 presets) the "model" group's rows are gathered first and each rank
keeps its own after.  `moe_forward` picks EP under the reference's
conditions; otherwise, under a mesh, every rank runs the dense dispatch
on the gathered batch (capacity and drops are global, as in the
reference) and keeps its rows.  Under the "model" cut of the rules that
cut activations (`parallel.sharding.model_cut`: ep, base, decode) the
"model" group shares its rows and computes them alike: the experts and
the shared experts are the rank's FF columns as stored, entered by
`collectives.to_model` and summed by `collectives.from_model`, and the
aux's mean is over the other axes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm.ops import gmm
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (
    Constrainer, cuts, default_rows, model_tp, no_constraint,
)
from repro_torch.models.layers import apply_mlp, init_mlp
from repro_torch.models.param import Init


def init_moe(init: Init, cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, dt = cfg.d_model, cfg.param_dtype
    f = m.d_ff_expert
    p = {
        "router": init.dense((d, m.n_experts), "float32",
                             axes=("embed", None)),
        "gate": init.dense((m.n_experts, d, f), dt, fan_in=d,
                           axes=("expert", "embed", "mlp")),
        "up": init.dense((m.n_experts, d, f), dt, fan_in=d,
                         axes=("expert", "embed", "mlp")),
        "down": init.dense((m.n_experts, f, d), dt, fan_in=f,
                           axes=("expert", "mlp", "embed")),
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


def _pick(buf: torch.Tensor, place: torch.Tensor) -> torch.Tensor:
    """Rows ``buf[place]`` with the scratch place (len(buf)) read as 0."""
    return torch.cat([buf, buf.new_zeros((1, *buf.shape[1:]))])[place]


def moe_forward_dense(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      constrain=no_constraint
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, d) in x's dtype, aux (float32 scalar)).  Under a
    call that cuts the expert FF dim over "model" ("mlp_act") the experts
    are the rank's FF columns (and rows of ``down``): the capacity buffer
    enters them by `collectives.to_model`, the down products' float32
    partials are summed over "model" and rounded once, and the shared
    experts are the MLP's column/row cut."""
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

    mesh = None
    if cuts(constrain, "mlp_act", m.d_ff_expert):
        mesh = constrain.mesh
        for name in ("gate", "up", "down"):
            coll.part_of_leaf(p[name], m.d_ff_expert, 1 if name == "down"
                              else 2, mesh)
        ex_in = coll.to_model(ex_in, mesh)
    sizes = torch.full((E,), C, dtype=torch.int32, device=x.device)
    host = (C,) * E
    h = gmm(ex_in, p["gate"], sizes, out_dtype=torch.float32,
            host_sizes=host)
    u = gmm(ex_in, p["up"], sizes, out_dtype=torch.float32, host_sizes=host)
    h = (F.silu(h) * u).to(x.dtype)
    ex_out = gmm(h, p["down"], sizes, out_dtype=torch.float32,
                 host_sizes=host)
    if mesh is not None:
        ex_out = coll.from_model(ex_out, mesh)
    ex_out = ex_out.to(x.dtype)

    out_rows = _pick(ex_out, place)
    g = gates.to(x.dtype).reshape(T * k, 1)
    y = (g.float() * out_rows.float()).reshape(T, k, d).sum(dim=1)
    y = y.to(x.dtype)

    if "shared" in p:
        y = y + _shared(p["shared"], cfg, xt, constrain)
    return y.reshape(B, S, d), aux


def _shared(p: dict, cfg: ModelConfig, x: torch.Tensor, constrain):
    """The shared experts: one MLP of ``n_shared_experts`` x the expert FF
    width."""
    m = cfg.moe
    return apply_mlp(p, x, gated=cfg.gated_mlp, act=cfg.act,
                     d_ff=m.d_ff_expert * m.n_shared_experts,
                     constrain=constrain)


# ---------------------------------------------------------------------------
# Expert-parallel (all-to-all) dispatch
# ---------------------------------------------------------------------------

def _sort_dispatch(values: torch.Tensor, key: torch.Tensor, n_buckets: int,
                   capacity: int):
    """Stable-sorts the rows of ``values`` into (n_buckets, capacity) with
    overflow dropped; keys >= n_buckets are dropped too.

    Returns (buffer (n_buckets, capacity, ...), order, kept_sorted,
    place_sorted): ``order`` is the stable sort permutation and
    ``buffer.flat[place] = values[order]`` for the kept rows (a dropped
    row's place is the scratch row n_buckets*capacity)."""
    A = key.shape[0]
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    # the bucket sizes by a scatter, whose shape does not depend on the keys
    # (bincount's does), so a trace on fake tensors gets through
    counts = torch.zeros(n_buckets + 1, dtype=torch.int64,
                         device=key.device).scatter_add_(
        0, key_s.clamp(max=n_buckets).long(),
        torch.ones_like(key_s, dtype=torch.int64))[:n_buckets]
    starts = torch.cumsum(counts, 0) - counts              # exclusive
    rank = torch.arange(A, device=key.device) - starts[
        key_s.clamp(0, n_buckets - 1)]
    kept = (rank >= 0) & (rank < capacity) & (key_s < n_buckets)
    place = torch.where(kept, key_s * capacity + rank, n_buckets * capacity)
    buf = values.new_zeros((n_buckets * capacity + 1, *values.shape[1:]))
    buf[place] = values[order]
    return (buf[:n_buckets * capacity].reshape(
        n_buckets, capacity, *values.shape[1:]), order, kept, place)


def _ep_local(xt, router_w, w_gate, w_up, w_down, *, m: MoEConfig, mesh,
              data_axis: str, model_axis: str, cf: float, tp: bool = False):
    """The per-rank body. xt: (T_loc, d) the rank's tokens; w_*: the
    rank's expert shards, (E_loc, d, f_loc) and (E_loc, f_loc, d).
    Returns (y (T_loc, d), the rank's local aux estimate).  With ``tp``
    the "model" group back-propagates one loss alike (the "model" cut,
    `parallel.sharding.model_cut`): the grouped rows enter the rank's FF
    columns by `collectives.to_model` and the partials are summed by
    `collectives.from_model`."""
    T_loc, d = xt.shape
    E, k = m.n_experts, m.top_k
    dsz = mesh.shape[data_axis]
    E_loc = E // dsz
    logits = xt.float() @ router_w.float()
    probs, gates, idx = _router_topk(logits, k)
    aux = _aux_loss(probs, idx, E)

    A = T_loc * k
    expert_id = idx.reshape(A)
    gate_val = gates.reshape(A)
    dst = expert_id // E_loc                       # destination rank
    e_local = expert_id % E_loc

    C_send = max(1, math.ceil(A * cf / dsz))
    send_x, order, kept, place = _sort_dispatch(
        xt.repeat_interleave(k, dim=0), dst, dsz, C_send)
    send_meta = torch.full((dsz * C_send + 1,), -1, dtype=torch.int32,
                           device=xt.device)
    send_meta[place] = torch.where(kept, e_local[order].to(torch.int32), -1)
    send_meta = send_meta[:-1].reshape(dsz, C_send)

    recv_x = coll.all_to_all(send_x, mesh, data_axis)
    recv_meta = coll.all_to_all(send_meta, mesh, data_axis)

    n_recv = dsz * C_send
    rx = recv_x.reshape(n_recv, d)
    rm = recv_meta.reshape(n_recv).long()
    cap_e = max(1, math.ceil(n_recv * cf / max(E_loc, 1)))
    grouped, order2, _, place2 = _sort_dispatch(
        rx, torch.where(rm < 0, E_loc, rm), E_loc, cap_e)

    sizes = torch.full((E_loc,), cap_e, dtype=torch.int32, device=xt.device)
    host = (cap_e,) * E_loc
    flat = grouped.reshape(E_loc * cap_e, d)
    if tp:
        flat = coll.to_model(flat, mesh, model_axis)
    h = gmm(flat, w_gate, sizes, out_dtype=torch.float32, host_sizes=host)
    u = gmm(flat, w_up, sizes, out_dtype=torch.float32, host_sizes=host)
    h = (F.silu(h) * u).to(xt.dtype)
    y_g = gmm(h, w_down, sizes, out_dtype=torch.float32,
              host_sizes=host).to(xt.dtype)
    # the down-projection partials summed over "model" in the activation
    # dtype (the float32 accumulation happened inside the products)
    y_g = (coll.from_model if tp else coll.psum)(y_g, mesh, model_axis)

    # expert outputs back to the received order, then the reverse a2a
    ry = _pick(y_g, place2)[torch.argsort(order2)]
    back = coll.all_to_all(ry.reshape(dsz, C_send, d), mesh, data_axis)
    # combine at the sender: assignment a (sorted) came back at place[a]
    y_a = _pick(back.reshape(n_recv, d), place)[torch.argsort(order)]
    g = gate_val.to(xt.dtype).reshape(A, 1)
    y = (g.float() * y_a.float()).reshape(T_loc, k, d).sum(dim=1)
    return y.to(xt.dtype), aux


def _local_experts(w: torch.Tensor, E_loc: int, f: int, f_dim: int, mesh,
                   data_axis: str, model_axis: str) -> torch.Tensor:
    """The rank's expert shard of ``w``: its E_loc experts (sliced when
    ``w`` holds every expert) and its part of the FF dim ``f_dim`` (sliced
    when ``w`` holds it whole, ``f`` wide)."""
    if w.shape[0] != E_loc:
        w = coll.own_slice(w, mesh, data_axis, 0)
    if w.shape[f_dim] == f:
        w = coll.own_slice(w, mesh, model_axis, f_dim)
    return w.contiguous()


def moe_forward_ep(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh, *,
                   rows: tuple[str, ...] | None = None,
                   data_axis: str = "data", model_axis: str = "model",
                   constrain=no_constraint
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dispatch on this rank.  ``x`` (B_loc, S, d): the
    rank's rows, cut over ``rows`` (by default the batch axes ("pod",
    "data") present; with "model" among them the model group's rows are
    gathered first).  ``p``'s experts are whole or this rank's shards
    (under the "model" cut of ``constrain`` its FF part as stored);
    the router is whole.  Returns (y like x, aux: the mean of the ranks'
    local estimates)."""
    m = cfg.moe
    d = x.shape[-1]
    E_loc = m.n_experts // mesh.shape[data_axis]
    if rows is None:
        rows = default_rows(mesh)
    tp = model_tp(constrain) > 1
    gathered = model_axis in rows and mesh.shape[model_axis] > 1
    xb = coll.all_gather(x, mesh, model_axis, 0) if gathered else x
    w = {name: _local_experts(p[name], E_loc, m.d_ff_expert,
                              1 if name == "down" else 2, mesh, data_axis,
                              model_axis)
         for name in ("gate", "up", "down")}
    y, aux = _ep_local(xb.reshape(-1, d), p["router"], w["gate"], w["up"],
                       w["down"], m=m, mesh=mesh, data_axis=data_axis,
                       model_axis=model_axis, cf=m.capacity_factor, tp=tp)
    y = y.reshape(xb.shape)
    if gathered:
        y = coll.own_slice(y, mesh, model_axis, 0)
    aux = coll.share_mean(aux, mesh, _share_axes(mesh, constrain))
    if "shared" in p:
        y = y + _shared(p["shared"], cfg, x, constrain)
    return y, aux


def _share_axes(mesh, constrain) -> tuple[str, ...]:
    """The axes whose ranks hold shares of the auxiliary loss's mean."""
    if isinstance(constrain, Constrainer):
        return constrain.share_axes()
    return mesh.axis_names


def use_ep(cfg: ModelConfig, mesh, batch: int) -> bool:
    """The reference's selector: EP when the mesh has a "data" axis of
    size > 1, the experts divide it, the global ``batch`` rows divide the
    batch axes ("pod", "data") and the expert FF dim divides "model"."""
    if mesh is None or mesh.shape.get("data", 1) <= 1:
        return False
    psize = math.prod(mesh.shape[a] for a in ("pod", "data")
                      if a in mesh.shape)
    return (cfg.moe.n_experts % mesh.shape["data"] == 0
            and batch % psize == 0
            and cfg.moe.d_ff_expert % mesh.shape.get("model", 1) == 0)


def moe_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh=None, *,
                rows: tuple[str, ...] | None = None,
                constrain=no_constraint
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch selector.  Without a mesh: the dense dispatch.  With one
    (``x`` the rank's rows, cut over ``rows``): EP where `use_ep` holds,
    else the dense dispatch over the gathered batch, this rank keeping
    its rows; aux is then a mean over the ranks (`share_mean`).  Under
    the "model" cut of ``constrain`` the experts are the rank's FF
    part."""
    if mesh is None:
        return moe_forward_dense(p, cfg, x)
    if rows is None:
        rows = default_rows(mesh)
    if use_ep(cfg, mesh, x.shape[0] * mesh.size(rows)):
        return moe_forward_ep(p, cfg, x, mesh, rows=rows,
                              constrain=constrain)
    y, aux = moe_forward_dense(p, cfg, coll.all_gather(x, mesh, rows, 0),
                               constrain=constrain)
    return (coll.own_slice(y, mesh, rows, 0),
            coll.share_mean(aux, mesh, _share_axes(mesh, constrain)))


__all__ = ["init_moe", "moe_forward_dense", "moe_forward_ep", "moe_forward",
           "use_ep", "capacity"]
