"""GQA attention block: projections, RoPE, QK-norm, KV caches, windows.

The port of the JAX package's ``models/attention.py``.  The (q, k, v) ->
o core is `kernels.flash_attention.flash_attention`: the Hopper kernel on
CUDA tensors, the plain version on CPU tensors.  Everything is
position-driven, so the same code covers the full-sequence forward,
prefill, rolling-window decode and cross-attention over an encoder's
output (keys at positions 0..F-1, no RoPE, no causal mask).

KV cache layout per attention layer (stacked over the scan axis by the
stack):
  k:   (B, C, Hkv, Dh)    C = capacity (full seq len, or window for local layers)
  v:   (B, C, Hkv, Dh)
  pos: (B, C) int32       absolute position held in each slot; -1 = empty

Rolling-window layers write slot = position % C; global layers slot =
position.  RoPE is applied before caching, so cached keys never need
re-rotation.  Unlike the reference, whose arrays are immutable,
`cache_fill` writes the cache in place (and returns it), which saves a
copy of the whole cache per layer and token.  A cross-attention cache
holds the encoder output's keys and values: the prefill writes it once,
and a decode step only reads it.

Sequence-parallel attention (the reference's ``_sp_attention``) runs
under a mesh (`launch.mesh.WorkerMesh`) where the head count does not
divide the "model" axis (`_use_sp`): each rank of the "model" group
takes one part of the sequence of its group's rows, all-gathers the
keys, values and their positions over "model", and runs
`flash_attention` (the kernel, forward and backward, on CUDA) on its
query rows; absolute positions keep causality exact.  Where the rows
are replicated over "model" (the base/ep presets) the rank slices its
part of the sequence and the outputs are all-gathered back; where they
are cut over "model" too (zero3) an all-to-all over "model" turns the
rank's rows into its part of the sequence and back.  Every collective is
differentiable (`parallel.collectives`).

Where the rules cut the heads over "model" and they divide it
(`parallel.sharding.Constrainer.cuts`: base, ep, decode, ...) the rank
attends with its H/M query heads, from its columns of ``wq`` (and of
``wk``/``wv`` and their biases where the kv heads divide too; else
``wk``/``wv`` are gathered over "model" and the rank reads the kv heads
its query heads use, `_kv_for_heads`), and ``wo`` is row-parallel: the
ranks' float32 partials summed over "model" (Megatron's pair).  Its
decode cache holds its kv heads, or, where the kv heads do not divide,
its part of the slots over "model" (the reference's fallback): every
query head's output over its slots is merged by `merge_partials`.

Serving under a mesh whose rules cut the KV cache's slots over mesh axes
(``decode_sp``: "data"; `parallel.sharding.serving_layout`) holds on each
rank its part of every cache's slots: `cache_fill` writes a position on
the rank that owns its slot, and `attn_decode` runs the flash kernel over
the rank's part (`flash_attention_forward`, the decode split with each
row's log-sum-exp) and merges the ranks' outputs in float32
(`merge_partials`), as the split kernel merges its own parts.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import sites
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_forward,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_linear, apply_rmsnorm, apply_rope, init_linear, matmul_f32,
)
from repro_torch.models.param import Init, torch_dtype
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (
    cuts, layout_rows, model_tp, no_constraint,
)


def init_attention(init: Init, cfg: ModelConfig) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = cfg.param_dtype
    p = {
        "wq": init_linear(init, d, H * Dh, dt, axes=("embed", "heads"),
                          bias=cfg.qkv_bias, bias_axis="heads"),
        "wk": init_linear(init, d, Hkv * Dh, dt, axes=("embed", "kv"),
                          bias=cfg.qkv_bias, bias_axis="kv"),
        "wv": init_linear(init, d, Hkv * Dh, dt, axes=("embed", "kv"),
                          bias=cfg.qkv_bias, bias_axis="kv"),
        "wo": init_linear(init, H * Dh, d, dt, axes=("heads", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": init.ones((Dh,), dt, axes=(None,))}
        p["k_norm"] = {"scale": init.ones((Dh,), dt, axes=(None,))}
    return p


def _heads_cut(cfg: ModelConfig, constrain) -> tuple[bool, bool]:
    """(query heads cut, kv heads cut) over "model" on this call: the
    reference constrainer's decision for q's "heads_act" and k's
    "kv_act" (`parallel.sharding.Constrainer.cuts`)."""
    return (cuts(constrain, "heads_act", cfg.n_heads),
            cuts(constrain, "kv_act", cfg.n_kv_heads))


def _linear_of(lin: dict, n: int, constrain, *, cut: bool,
               alike: bool) -> dict:
    """A projection with ``n`` output columns (cut over "model" by the
    storage where ``n`` divides) as the call uses it: the rank's columns
    (``cut``), or the whole (gathered over "model" where stored cut; see
    `collectives.whole_leaf` for ``alike``)."""
    if model_tp(constrain) == 1:
        return lin
    mesh = constrain.mesh
    if cut:
        return {k: coll.part_of_leaf(w, n, w.dim() - 1, mesh)
                for k, w in lin.items()}
    return {k: coll.whole_leaf(w, n, w.dim() - 1, mesh, alike=alike)
            for k, w in lin.items()}


def _row_parallel(lin: dict, o: torch.Tensor, n: int, constrain, *,
                  cut: bool) -> torch.Tensor:
    """The output projection over ``n`` input rows: with ``cut`` the
    rank's rows, its float32 partial product summed over "model" and
    rounded once (`collectives.from_model`); else the whole leaf."""
    if not cut:
        if model_tp(constrain) > 1:
            lin = {"w": coll.whole_leaf(lin["w"], n, -2, constrain.mesh,
                                        alike=True)}
        return apply_linear(lin, o)
    mesh = constrain.mesh
    w = coll.part_of_leaf(lin["w"], n, 0, mesh)
    return coll.from_model(matmul_f32(o, w), mesh).to(o.dtype)


def _project_qkv(p: dict, cfg: ModelConfig, xq: torch.Tensor,
                 xkv: torch.Tensor | None, *, rope_on: bool,
                 q_positions: torch.Tensor, kv_positions: torch.Tensor,
                 constrain=no_constraint):
    """q, k and v (k and v None without ``xkv``).  Where the call cuts
    the query heads over "model" q holds the rank's heads, and k and v
    the rank's kv heads where those divide too, else every kv head (the
    rank then reads the ones its query heads use: `_kv_for_heads`)."""
    B, Sq, _ = xq.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    hcut, kvcut = _heads_cut(cfg, constrain)
    tp = model_tp(constrain)

    def own(t):           # a replicated tensor entering the rank's heads
        return coll.to_model(t, constrain.mesh) if hcut else t

    xq_in = own(xq)
    q = apply_linear(_linear_of(p["wq"], H * Dh, constrain, cut=hcut,
                                alike=not hcut), xq_in)
    q = q.reshape(B, Sq, H // tp if hcut else H, Dh)
    if cfg.qk_norm:
        q = apply_rmsnorm({"scale": own(p["q_norm"]["scale"])}, q,
                          cfg.norm_eps)
    if rope_on:
        q = apply_rope(q, q_positions, cfg.rope_theta)
    if xkv is None:
        return q, None, None
    Skv = xkv.shape[1]
    xkv_in = xq_in if xkv is xq else own(xkv)
    hk = Hkv // tp if kvcut else Hkv
    k, v = (apply_linear(_linear_of(p[name], Hkv * Dh, constrain,
                                    cut=kvcut, alike=not hcut),
                         xkv_in).reshape(B, Skv, hk, Dh)
            for name in ("wk", "wv"))
    if cfg.qk_norm:
        k = apply_rmsnorm({"scale": own(p["k_norm"]["scale"])}, k,
                          cfg.norm_eps)
    if rope_on:
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


@torch.no_grad()
def serving_leaves(p: dict, cfg: ModelConfig, constrain) -> dict:
    """The block's (stacked) projections as a serving rank keeps them, so
    that no decode call gathers a weight: the ones the call uses whole
    (`_linear_of`, `_row_parallel` without the cut: every projection
    where the query heads do not divide "model", ``wk`` and ``wv`` where
    only the kv heads do not) gathered once, the rest as stored."""
    hcut, kvcut = _heads_cut(cfg, constrain)
    if model_tp(constrain) == 1 or kvcut:
        return p
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    out = dict(p)
    for name, n in (("wk", Hkv * Dh), ("wv", Hkv * Dh)) + (
            () if hcut else (("wq", H * Dh),)):
        out[name] = _linear_of(p[name], n, constrain, cut=False, alike=True)
    if not hcut:
        out["wo"] = {"w": coll.whole_leaf(p["wo"]["w"], H * Dh, -2,
                                          constrain.mesh, alike=True)}
    return out


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                  mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Of every kv head, those the rank's query heads (the "model" group's
    equal part) read, in GQA order for them: a slice where the rank's
    heads cover whole groups or lie in one, else one kv head per query
    head."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    hq, g = H // mesh.shape["model"], H // Hkv
    first = mesh.index("model") * hq
    if hq % g == 0 or g % hq == 0:
        n = max(hq // g, 1)
        return tuple(t.narrow(2, first // g, n).contiguous() for t in (k, v))
    idx = torch.arange(first, first + hq, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def default_positions(B: int, S: int, device) -> torch.Tensor:
    """(B, S) int32 positions 0..S-1, contiguous (the kernel's layout)."""
    return torch.arange(S, dtype=torch.int32,
                        device=device).expand(B, S).contiguous()


def _sp_attention(q, k, v, q_pos, kv_pos, mesh, rows, *, causal, window,
                  softcap, tp: bool = False):
    """Sequence-parallel attention on this rank of the "model" group:
    q, k, v (B_loc, S, H, Dh) and positions (B_loc, S) of the rank's rows
    (cut over ``rows``).  With ``tp`` the call runs under the "model" cut
    (`parallel.sharding.model_cut`): the rows are replicated over "model"
    and the group's ranks back-propagate one loss alike, so the rank's
    part of the sequence is `collectives.scatter_to_model`'s and the
    outputs come back by `collectives.gather_from_model`."""
    tp_size = mesh.shape["model"]
    B, S = q.shape[:2]
    if "model" in rows:             # rows cut over "model": rows -> seq
        def to_seq(t):
            t = t.reshape(B, tp_size, S // tp_size, *t.shape[2:]
                          ).transpose(0, 1)
            t = coll.all_to_all(t.contiguous(), mesh, "model")
            return t.reshape(tp_size * B, S // tp_size, *t.shape[3:])

        def to_rows(t):
            t = coll.all_to_all(t.reshape(tp_size, B, S // tp_size,
                                          *t.shape[2:]), mesh, "model")
            return t.transpose(0, 1).reshape(B, S, *t.shape[3:])
    elif tp:                        # replicated rows, one loss per group
        def to_seq(t):
            return coll.scatter_to_model(t, mesh, "model", 1)

        def to_rows(t):
            return coll.gather_from_model(t, mesh, "model", 1)
    else:                           # rows replicated over "model"
        def to_seq(t):
            return coll.own_slice(t, mesh, "model", 1).contiguous()

        def to_rows(t):
            return coll.all_gather(t, mesh, "model", 1)
    q_l, k_l, v_l, qp_l, kp_l = map(to_seq, (q, k, v, q_pos, kv_pos))
    k_f = coll.all_gather(k_l, mesh, "model", 1)
    v_f = coll.all_gather(v_l, mesh, "model", 1)
    kp_f = coll.all_gather(kp_l, mesh, "model", 1)
    o = flash_attention(q_l, k_f, v_f, qp_l, kp_f, causal=causal,
                        window=window, softcap=softcap)
    return to_rows(o)


def _use_sp(cfg: ModelConfig, mesh, Sq: int, Skv: int, B: int,
            cross: bool) -> bool:
    if mesh is None or cross:
        return False
    tp = dict(mesh.shape).get("model", 1)
    if tp <= 1 or cfg.n_heads % tp == 0:
        return False  # the heads are cut, or attention is whole per rank
    return Sq > 1 and Sq % tp == 0 and Skv % tp == 0


def attn_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                 rope_on: bool = True, window: int | None = None,
                 causal: bool = True, positions: torch.Tensor | None = None,
                 kv_ctx: torch.Tensor | None = None,
                 constrain=no_constraint, return_kv: bool = False,
                 mesh=None):
    """Full-sequence attention (training / prefill / encoder / cross).
    With ``kv_ctx`` (the encoder's output, (B, F, d_model)) it is
    cross-attention: keys and values projected from ``kv_ctx`` at
    positions 0..F-1, no RoPE, no causal mask.
    With return_kv=True returns (out, (k, v)) for cache filling -- k is
    post-RoPE, matching the decode path's cache convention.  Under a
    ``mesh`` (x the rank's rows, laid out as ``constrain`` says) the rank
    attends with its part of the heads where the call cuts them (its
    returned k and v are then those `_project_qkv` describes), and it is
    sequence-parallel where `_use_sp` holds."""
    B, S, _ = x.shape
    if positions is None:
        positions = default_positions(B, S, x.device)
    positions = positions.to(torch.int32).contiguous()
    if kv_ctx is None:                              # self-attention
        xkv, kv_positions = x, positions
    else:                                           # over the encoder output
        xkv, causal, rope_on = kv_ctx, False, False
        kv_positions = default_positions(B, xkv.shape[1], x.device)
    q, k, v = _project_qkv(p, cfg, x, xkv, rope_on=rope_on,
                           q_positions=positions, kv_positions=kv_positions,
                           constrain=constrain)
    hcut, kvcut = _heads_cut(cfg, constrain)
    if hcut:
        ka, va = (k, v) if kvcut else _kv_for_heads(k, v, cfg, mesh)
        o = flash_attention(q, ka, va, positions, kv_positions,
                            causal=causal, window=window,
                            softcap=cfg.attn_logit_softcap)
    elif _use_sp(cfg, mesh, q.shape[1], k.shape[1], q.shape[0],
                 kv_ctx is not None):
        o = _sp_attention(q, k, v, positions, kv_positions, mesh,
                          layout_rows(constrain, mesh), causal=causal,
                          window=window, softcap=cfg.attn_logit_softcap,
                          tp=model_tp(constrain) > 1)
    else:
        o = flash_attention(q, k, v, positions, kv_positions, causal=causal,
                            window=window, softcap=cfg.attn_logit_softcap)
    out = _row_parallel(p["wo"], o.reshape(B, S, -1),
                        cfg.n_heads * cfg.d_head, constrain, cut=hcut)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# KV-cache decode path
# ---------------------------------------------------------------------------

def kv_slots(cfg: ModelConfig, mesh, constrain) -> tuple[str, ...]:
    """The mesh axes a call's self-attention caches cut their slots over
    (`parallel.sharding.Constrainer.kv_slots`; none without a mesh)."""
    if mesh is None or not hasattr(constrain, "kv_slots"):
        return ()
    return constrain.kv_slots(cfg.n_kv_heads)


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, *,
                  device: torch.device, layout=no_constraint,
                  slots: bool = True) -> dict:
    """A cache of ``batch`` rows and ``capacity`` slots; under a serving
    ``layout`` (a `parallel.sharding.Constrainer`) the rank's part: its
    kv heads where the layout cuts them over "model", and (with
    ``slots``) its part of the slots over `kv_slots`."""
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    dt = torch_dtype(dtype)
    mesh = getattr(layout, "mesh", None)
    if _heads_cut(cfg, layout)[1]:
        Hkv //= model_tp(layout)
    if slots and mesh is not None:
        n = mesh.size(kv_slots(cfg, mesh, layout))
        if capacity % n:
            raise ValueError(f"serving: a cache of {capacity} slots does "
                             f"not divide over {kv_slots(cfg, mesh, layout)}"
                             f" ({n})")
        capacity //= n
    return {
        "k": torch.zeros((batch, capacity, Hkv, Dh), dtype=dt, device=device),
        "v": torch.zeros((batch, capacity, Hkv, Dh), dtype=dt, device=device),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                          device=device),
    }


def kv_cache_part(cache: dict, cfg: ModelConfig, layout, *,
                  slots: bool = True) -> dict:
    """The rank's part of a whole cache (leading stack axes allowed) as
    `init_kv_cache` lays it out under ``layout``: its rows over the
    layout's ``rows``, its slots over `kv_slots` (with ``slots``) and its
    kv heads over "model" where the layout cuts them."""
    mesh, rows = layout.mesh, layout.rows
    axes = kv_slots(cfg, mesh, layout) if slots else ()
    kvcut = _heads_cut(cfg, layout)[1]
    out = {}
    for name, t in cache.items():
        b = t.dim() - (2 if name == "pos" else 4)       # the rows' dim
        t = coll.own_slice(coll.own_slice(t, mesh, rows, b), mesh, axes,
                           b + 1)
        if name != "pos" and kvcut:
            t = coll.own_slice(t, mesh, "model", b + 2)
        out[name] = t.contiguous()
    return out


def cache_fill(cache: dict, k: torch.Tensor, v: torch.Tensor,
               positions: torch.Tensor, *, mesh=None,
               axes: tuple[str, ...] = ()) -> dict:
    """Writes keys/values in place at slot = position % capacity (exact
    for global layers, rolling for local windows) and returns the cache.
    When one write covers more positions than the cache holds, only the
    last C are written: later positions overwrite earlier slots, as the
    window semantics and the reference's scatter have it.  One indexed
    write serves both of the reference's forms (its masked update for
    B = S = 1 and its scatter).

    With a ``mesh`` and ``axes`` the cache is this rank's part of a
    cache whose slots are cut over ``axes`` (C = the part's slots times
    the group's size), and the rank writes only the positions whose slot
    it owns."""
    n = mesh.size(axes) if mesh is not None else 1
    part = cache["k"].shape[1]
    C = part * n
    if positions.shape[1] > C:
        k, v, positions = k[:, -C:], v[:, -C:], positions[:, -C:]
    slots = (positions % C).long()
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    if n > 1 and sites.recorder is not None:
        # the dry-run traces shapes, and a boolean selection has none: the
        # rank's writes stand as its share of each row's positions
        m = -(-slots.shape[1] // n)
        bidx = bidx.expand_as(slots)[:, :m]
        slots, positions = slots[:, :m] % part, positions[:, :m]
        k, v = k[:, :m], v[:, :m]
    elif n > 1:
        mine = slots // part == mesh.index(axes)
        bidx = bidx.expand_as(slots)[mine]
        slots, positions = slots[mine] % part, positions[mine]
        k, v = k[mine], v[mine]
    cache["k"][bidx, slots] = k.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v.to(cache["v"].dtype)
    cache["pos"][bidx, slots] = positions.to(torch.int32)
    return cache


def merge_partials(o: torch.Tensor, lse: torch.Tensor, mesh,
                   axes) -> torch.Tensor:
    """Attention over keys cut over the ranks of ``axes``, from each
    rank's output ``o`` (B, Sq, H, Dh) over its keys and each row's
    log-sum-exp ``lse`` (B, Sq, H), float32: sum_r w_r o_r / sum_r w_r
    with w_r = exp(lse_r - max_r lse_r), in float32.  A row that sees no
    key on a rank (lse = +inf there, as `flash_attention_forward` gives
    it) weighs 0; a row that sees none anywhere is 0.  One all-gather of
    the ranks' (o, lse); every rank merges them in group order, so all
    hold the same bits."""
    both = torch.cat([o.float(), lse.float()[..., None]], dim=-1)
    parts = coll.all_gather(both[None], mesh, axes, 0)
    o_r, lse_r = parts[..., :-1], parts[..., -1]
    lse_r = torch.where(torch.isposinf(lse_r), float("-inf"), lse_r)
    top = lse_r.max(dim=0).values
    w = torch.exp(lse_r - torch.where(torch.isneginf(top), 0.0, top))
    den = w.sum(dim=0)[..., None]
    out = torch.where(den > 0, (w[..., None] * o_r).sum(dim=0)
                      / den.clamp(min=1e-30), 0.0)
    return out.to(o.dtype)


def attn_decode(p: dict, cfg: ModelConfig, x_t: torch.Tensor, cache: dict,
                lengths: torch.Tensor, *, rope_on: bool = True,
                window: int | None = None, cross: bool = False,
                mesh=None, constrain=no_constraint):
    """One decode step: x_t (B, 1, d_model) at positions ``lengths``
    (B,).  Returns (out, cache), the cache updated in place.  With
    ``cross`` the cache is the encoder output's, read and never written:
    q alone is projected, and attends every filled slot with no causal
    mask and no window.  Under a ``mesh`` the cache is this rank's part
    (`init_kv_cache`'s ``layout``): its kv heads where ``constrain`` cuts
    them, and its slots over `kv_slots` -- it fills the slots it owns and
    its part's attention is merged over those axes (`merge_partials`),
    for every query head where the slots are cut over "model" (the
    rank's query heads gathered first)."""
    B = x_t.shape[0]
    H, Dh = cfg.n_heads, cfg.d_head
    hcut, kvcut = _heads_cut(cfg, constrain)
    q_positions = lengths[:, None].to(torch.int32).contiguous()
    if cross:
        q, _, _ = _project_qkv(p, cfg, x_t, None, rope_on=False,
                               q_positions=q_positions,
                               kv_positions=q_positions, constrain=constrain)
        k, v = cache["k"], cache["v"]
        if hcut and not kvcut:
            k, v = _kv_for_heads(k, v, cfg, mesh)
        o = flash_attention(q, k, v, q_positions, cache["pos"], causal=False,
                            window=None, softcap=cfg.attn_logit_softcap)
        return _row_parallel(p["wo"], o.reshape(B, 1, -1), H * Dh,
                             constrain, cut=hcut), cache
    q, k_t, v_t = _project_qkv(p, cfg, x_t, x_t, rope_on=rope_on,
                               q_positions=q_positions,
                               kv_positions=q_positions, constrain=constrain)
    slots = kv_slots(cfg, mesh, constrain)
    every_head = hcut and "model" in slots
    if every_head:               # the ranks' parts of the slots, every head
        q = coll.gather_from_model(q, mesh, "model", 2)
    if slots:
        cache = cache_fill(cache, k_t, v_t, q_positions, mesh=mesh,
                           axes=slots)
        o, lse = flash_attention_forward(
            q, cache["k"], cache["v"], q_positions, cache["pos"],
            causal=True, window=window, softcap=cfg.attn_logit_softcap)
        o = merge_partials(o, lse, mesh, slots)
    else:
        cache = cache_fill(cache, k_t, v_t, q_positions)
        o = flash_attention(q, cache["k"], cache["v"], q_positions,
                            cache["pos"], causal=True, window=window,
                            softcap=cfg.attn_logit_softcap)
    if every_head:
        o = coll.own_slice(o, mesh, "model", 2)
    return _row_parallel(p["wo"], o.reshape(B, 1, -1), H * Dh, constrain,
                         cut=hcut), cache
