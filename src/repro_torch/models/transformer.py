"""Layer-stack composition: pre-norm blocks looped over depth.

The port of the JAX package's ``models/transformer.py`` for the dense
family (mixer ``attn``, ffn ``dense``), the Mamba2 family (mixer
``ssm``, ffn ``none``: a Mamba2 block has no separate FFN), the MoE
family (ffn ``moe``), the jamba hybrid (Mamba slots and one attention
slot per period, dense and MoE FFNs alternating), and the encoder-decoder
family: an encoder stack (`init_stack` with its own ``n_layers``, run
without a causal mask) and decoder blocks whose cross-attention
sub-block (``norm_ca``, ``cross``) follows the mixer.  Parameters keep the
reference's structure, ``{"slot0": stacked, ..., "slot{p-1}": stacked}``
with each leaf stacked over ``n_scan = n_layers // p``, and the
reference's ``lax.scan`` over depth becomes a Python loop over the stack
axis.

Decode and prefill thread per-layer caches the same way (attention slots
carry {"self": {k, v, pos}}, SSM slots {"ssm": {conv, ssm}}, side by side
in one tree for the hybrid, and cross-attention slots add {"crosskv": {k,
v, pos}} of the encoder's length, filled by the prefill and only read by
decode); here the caches are written in place, layer by layer, through
views of the stacked cache tensors.  `stack_forward`
returns the MoE layers' summed auxiliary loss beside the activations, as
the reference does.

`stack_forward` is differentiable, and takes the reference's ``remat``
policies for training: ``"full"`` recomputes each step of the depth loop
(one period of blocks, the reference's ``jax.checkpoint(step)``) in the
backward pass (`torch.utils.checkpoint`, non-reentrant); ``"dots"``
keeps the outputs of the plain matrix products (``aten.mm``/``addmm``:
products with no batch axis, as ``checkpoint_dots_with_no_batch_dims``
keeps the reference's) and recomputes the rest; ``"none"`` keeps
everything.

``unroll`` is the reference's switch between ``lax.scan`` over depth and
a fully unrolled stack, which only the dry-run's cost analysis asks for
(XLA counts a loop body once).  Here the depth loop is a Python loop with
every layer a separate call either way, so ``unroll=True`` computes
exactly what ``unroll=False`` does; it is accepted on every entry point.

A block's norms run under the program span ``"block.norm"``, an
attention, MLP or MoE sublayer under ``"attn"``, ``"mlp"`` or ``"moe"``
(`observability.steps.span`; the SSD mixer's spans are `models.ssm`'s).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_mlp, apply_norm, init_mlp, init_norm,
)
from repro_torch.models.param import Init
from repro_torch.observability.steps import span
from repro_torch.parallel.sharding import no_constraint


# ---------------------------------------------------------------------------
# Static per-slot layer description
# ---------------------------------------------------------------------------

class SlotSpec:
    """Static description of sublayer slot `s` of the period."""

    def __init__(self, cfg: ModelConfig, slot: int, *, cross: bool = False):
        self.slot = slot
        self.mixer = cfg.mixer_kind(slot)
        self.ffn = cfg.ffn_kind(slot)
        self.cross = cross
        self.rope_on = cfg.layer_uses_rope(slot)
        if self.mixer == "attn":
            if cfg.attn_window is not None and not cfg.layer_uses_global_attn(slot):
                self.window = cfg.attn_window
            else:
                self.window = None
        else:
            self.window = None

    def cache_capacity(self, cfg: ModelConfig, seq_len: int) -> int:
        if self.window is not None:
            return min(self.window, seq_len)
        return seq_len


def slot_specs(cfg: ModelConfig, *, cross: bool = False) -> list[SlotSpec]:
    return [SlotSpec(cfg, s, cross=cross) for s in range(cfg.period)]


REMAT_POLICIES = ("none", "full", "dots")


def _check_modes(*, remat: str = "none"):
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat}")


#: the products whose outputs ``remat="dots"`` keeps: matrix products
#: with no batch axis (a linear layer's ``x @ w`` reaches aten as mm)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.mm.dtype}


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _rematted(step, remat: str):
    """``step`` under the remat policy (see the module docstring)."""
    if remat == "none":
        return step
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, step, use_reentrant=False, **kw)


def _layers(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked tree, as views (so cache writes land
    in the stacked tensors) made by one unbind a leaf: in training its
    backward stacks the layers' gradients once, where indexing each layer
    out would make autograd add a zero-padded copy of the whole stack per
    layer."""
    parts = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: parts[k][i] for k in tree} for i in range(n)]


# ---------------------------------------------------------------------------
# Single block init/apply
# ---------------------------------------------------------------------------

def init_block(init: Init, cfg: ModelConfig, spec: SlotSpec) -> dict:
    d, dt = cfg.d_model, cfg.param_dtype
    p = {"norm1": init_norm(init, cfg.norm, d, dt)}
    if spec.mixer == "attn":
        p["mixer"] = attn.init_attention(init, cfg)
    else:
        p["mixer"] = ssm_mod.init_ssm(init, cfg)
    if spec.cross:
        p["norm_ca"] = init_norm(init, cfg.norm, d, dt)
        p["cross"] = attn.init_attention(init, cfg)
    if spec.ffn == "dense":
        p["norm2"] = init_norm(init, cfg.norm, d, dt)
        p["ffn"] = init_mlp(init, d, cfg.d_ff, dt, gated=cfg.gated_mlp)
    elif spec.ffn == "moe":
        p["norm2"] = init_norm(init, cfg.norm, d, dt)
        p["ffn"] = moe_mod.init_moe(init, cfg)
    return p


def _ffn(p: dict, cfg: ModelConfig, spec: SlotSpec, x: torch.Tensor, *,
         mesh=None, constrain=no_constraint
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block's FFN with its residual; returns (x, the MoE auxiliary
    loss or None)."""
    if spec.ffn == "none":
        return x, None
    with span("block.norm"):
        h = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    if spec.ffn == "moe":
        with span("moe"):
            y, aux = moe_mod.moe_forward(
                p["ffn"], cfg, h, mesh, rows=getattr(constrain, "rows", None),
                constrain=constrain)
        return x + y, aux
    with span("mlp"):
        y = apply_mlp(p["ffn"], h, gated=cfg.gated_mlp, act=cfg.act,
                      d_ff=cfg.d_ff, constrain=constrain)
    return x + y, None


def _cross(p: dict, cfg: ModelConfig, x: torch.Tensor,
           enc_out: torch.Tensor, return_kv: bool = False, *, mesh=None,
           constrain=no_constraint):
    """The cross-attention sub-block with its residual over the encoder's
    output; with ``return_kv`` also its (k, v) for the cross cache."""
    with span("block.norm"):
        h = apply_norm(cfg.norm, p["norm_ca"], x, cfg.norm_eps)
    with span("attn"):
        y = attn.attn_forward(p["cross"], cfg, h, kv_ctx=enc_out,
                              return_kv=return_kv, mesh=mesh,
                              constrain=constrain)
    if return_kv:
        return x + y[0], y[1]
    return x + y


def apply_block(p: dict, cfg: ModelConfig, spec: SlotSpec, x: torch.Tensor,
                *, positions: torch.Tensor, causal: bool,
                enc_out: torch.Tensor | None = None, mesh=None,
                constrain=no_constraint
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Full-sequence block.  Returns (x, MoE aux or None)."""
    with span("block.norm"):
        h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    if spec.mixer == "attn":
        with span("attn"):
            mix = attn.attn_forward(p["mixer"], cfg, h,
                                    rope_on=spec.rope_on, window=spec.window,
                                    causal=causal, positions=positions,
                                    constrain=constrain, mesh=mesh)
    else:
        mix = ssm_mod.ssm_forward(p["mixer"], cfg, h, constrain=constrain)
    x = x + mix
    if spec.cross:
        x = _cross(p, cfg, x, enc_out, mesh=mesh, constrain=constrain)
    return _ffn(p, cfg, spec, x, mesh=mesh, constrain=constrain)


# ---------------------------------------------------------------------------
# Stack init
# ---------------------------------------------------------------------------

def init_stack(init: Init, cfg: ModelConfig, *, n_layers: int | None = None,
               cross: bool = False) -> dict:
    """Stacked params: {"slotS": leaf(n_scan, ...)}, over ``n_layers``
    (cfg's by default; an encoder's own)."""
    n_layers = cfg.n_layers if n_layers is None else n_layers
    if n_layers % cfg.period:
        raise ValueError((n_layers, cfg.period))
    stacked = init.stacked(n_layers // cfg.period)
    return {f"slot{spec.slot}": init_block(stacked, cfg, spec)
            for spec in slot_specs(cfg, cross=cross)}


def _n_scan(params: dict) -> int:
    leaf = params["slot0"]["norm1"]["scale"]
    return leaf.shape[0]


def serving_stack(params: dict, cfg: ModelConfig, constrain, *,
                  cross: bool = False) -> dict:
    """The stacked parameters as a serving rank keeps them under
    ``constrain``'s "model" cut (`attn.serving_leaves`,
    `ssm_mod.serving_leaves`: the weights a decode call would gather,
    gathered once)."""
    out = {}
    for spec in slot_specs(cfg, cross=cross):
        p = dict(params[f"slot{spec.slot}"])
        leaves = (attn.serving_leaves if spec.mixer == "attn"
                  else ssm_mod.serving_leaves)
        p["mixer"] = leaves(p["mixer"], cfg, constrain)
        if spec.cross:
            p["cross"] = attn.serving_leaves(p["cross"], cfg, constrain)
        out[f"slot{spec.slot}"] = p
    return out


# ---------------------------------------------------------------------------
# Stack forward (prefill-as-forward)
# ---------------------------------------------------------------------------

def stack_forward(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  positions: torch.Tensor | None = None, causal: bool = True,
                  cross: bool = False, enc_out: torch.Tensor | None = None,
                  mesh=None, constrain=no_constraint, remat: str = "none",
                  unroll: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, the MoE layers' summed auxiliary loss, float32).  With
    ``cross`` each block attends ``enc_out`` after its mixer.  Under a
    ``mesh``, x holds the rank's rows (laid out as ``constrain`` says):
    attention is sequence-parallel and the MoE layers expert-parallel
    where the reference's selectors say so."""
    _check_modes(remat=remat)
    B, S, _ = x.shape
    if positions is None:
        positions = attn.default_positions(B, S, x.device)
    specs = slot_specs(cfg, cross=cross)

    def step(x, slices):
        """One period of blocks; returns (x, its MoE aux, float32)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for spec in specs:
            x, aux_l = apply_block(slices[f"slot{spec.slot}"], cfg, spec, x,
                                   positions=positions, causal=causal,
                                   enc_out=enc_out, mesh=mesh,
                                   constrain=constrain)
            if aux_l is not None:
                aux = aux + aux_l
        return x, aux

    step = _rematted(step, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for slices in _layers(params, _n_scan(params)):
        x, aux_l = step(x, slices)
        aux = aux + aux_l
    return x, aux


# ---------------------------------------------------------------------------
# Decode: caches threaded through the layer loop
# ---------------------------------------------------------------------------

def init_stack_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, *,
                     device: torch.device, cross: bool = False,
                     n_enc: int = 0, layout=no_constraint) -> dict:
    """Cache tree matching the stacked params; each leaf has a leading
    n_scan axis.  With ``cross`` each slot also holds a ``crosskv``
    cache of ``n_enc`` slots (the encoder's length).  Under a serving
    ``layout`` each cache is the rank's part (`attn.init_kv_cache`,
    `ssm_mod.init_ssm_state`; a cross cache keeps every slot)."""
    n_scan = cfg.n_scan
    out = {}
    for spec in slot_specs(cfg, cross=cross):
        slot = {}
        if spec.mixer == "attn":
            cap = spec.cache_capacity(cfg, seq_len)
            slot["self"] = attn.init_kv_cache(cfg, batch, cap, dtype,
                                              device=device, layout=layout)
        else:
            slot["ssm"] = ssm_mod.init_ssm_state(cfg, batch, dtype,
                                                 device=device,
                                                 layout=layout)
        if spec.cross:
            slot["crosskv"] = attn.init_kv_cache(cfg, batch, n_enc, dtype,
                                                 device=device,
                                                 layout=layout, slots=False)
        out[f"slot{spec.slot}"] = {
            kind: {k: t[None].repeat(n_scan, *([1] * t.dim()))
                   for k, t in base.items()}
            for kind, base in slot.items()}
    return out


def stack_cache_part(cache: dict, cfg: ModelConfig, layout, *,
                     cross: bool = False) -> dict:
    """The rank's part of a whole stack cache (`init_stack_cache`'s tree)
    as `init_stack_cache` lays it out under ``layout``."""
    out = {}
    for spec in slot_specs(cfg, cross=cross):
        c = cache[f"slot{spec.slot}"]
        slot = {}
        if "self" in c:
            slot["self"] = attn.kv_cache_part(c["self"], cfg, layout)
        if "ssm" in c:
            slot["ssm"] = ssm_mod.ssm_state_part(c["ssm"], cfg, layout)
        if "crosskv" in c:
            slot["crosskv"] = attn.kv_cache_part(c["crosskv"], cfg, layout,
                                                 slots=False)
        out[f"slot{spec.slot}"] = slot
    return out


def apply_block_decode(p: dict, cfg: ModelConfig, spec: SlotSpec,
                       x_t: torch.Tensor, cache: dict,
                       lengths: torch.Tensor, *, mesh=None,
                       constrain=no_constraint) -> torch.Tensor:
    h = apply_norm(cfg.norm, p["norm1"], x_t, cfg.norm_eps)
    if spec.mixer == "attn":
        mix, _ = attn.attn_decode(p["mixer"], cfg, h, cache["self"], lengths,
                                  rope_on=spec.rope_on, window=spec.window,
                                  mesh=mesh, constrain=constrain)
    else:
        mix, _ = ssm_mod.ssm_decode(p["mixer"], cfg, h, cache["ssm"],
                                    constrain=constrain)
    x_t = x_t + mix
    if spec.cross:
        h = apply_norm(cfg.norm, p["norm_ca"], x_t, cfg.norm_eps)
        y, _ = attn.attn_decode(p["cross"], cfg, h, cache["crosskv"],
                                lengths, cross=True, mesh=mesh,
                                constrain=constrain)
        x_t = x_t + y
    return _ffn(p, cfg, spec, x_t, mesh=mesh, constrain=constrain)[0]


def stack_decode(params: dict, cfg: ModelConfig, x_t: torch.Tensor,
                 cache: dict, lengths: torch.Tensor, *, cross: bool = False,
                 mesh=None, constrain=no_constraint,
                 unroll: bool = False) -> tuple[torch.Tensor, dict]:
    """One token per row through every layer; the cache is updated in
    place and returned.  Under a ``mesh`` x_t, the cache and lengths are
    this rank's parts, laid out as ``constrain`` says (its ``rows``; the
    attention caches' slots cut over its ``kv_seq``)."""
    specs = slot_specs(cfg, cross=cross)
    n = _n_scan(params)
    for p, c in zip(_layers(params, n), _layers(cache, n)):
        for spec in specs:
            key = f"slot{spec.slot}"
            x_t = apply_block_decode(p[key], cfg, spec, x_t, c[key], lengths,
                                     mesh=mesh, constrain=constrain)
    return x_t, cache


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also fills the decode caches
# ---------------------------------------------------------------------------

def apply_block_prefill(p: dict, cfg: ModelConfig, spec: SlotSpec,
                        x: torch.Tensor, cache: dict, *,
                        positions: torch.Tensor,
                        enc_out: torch.Tensor | None = None, mesh=None,
                        constrain=no_constraint) -> torch.Tensor:
    h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    if spec.mixer == "attn":
        mix, (k, v) = attn.attn_forward(
            p["mixer"], cfg, h, rope_on=spec.rope_on, window=spec.window,
            causal=True, positions=positions, return_kv=True, mesh=mesh,
            constrain=constrain)
        attn.cache_fill(cache["self"], k, v, positions, mesh=mesh,
                        axes=attn.kv_slots(cfg, mesh, constrain))
    else:
        mix, state = ssm_mod.ssm_forward(p["mixer"], cfg, h,
                                         return_state=True,
                                         constrain=constrain)
        ssm_mod.ssm_fill(cache["ssm"], state)
    x = x + mix
    if spec.cross:
        x, (xk, xv) = _cross(p, cfg, x, enc_out, return_kv=True, mesh=mesh,
                             constrain=constrain)
        attn.cache_fill(cache["crosskv"], xk, xv, attn.default_positions(
            xk.shape[0], xk.shape[1], xk.device))
    return _ffn(p, cfg, spec, x, mesh=mesh, constrain=constrain)[0]


def stack_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  cache: dict, *, positions: torch.Tensor | None = None,
                  cross: bool = False, enc_out: torch.Tensor | None = None,
                  mesh=None, constrain=no_constraint,
                  unroll: bool = False) -> tuple[torch.Tensor, dict]:
    B, S, _ = x.shape
    if positions is None:
        positions = attn.default_positions(B, S, x.device)
    specs = slot_specs(cfg, cross=cross)
    n = _n_scan(params)
    for p, c in zip(_layers(params, n), _layers(cache, n)):
        for spec in specs:
            key = f"slot{spec.slot}"
            x = apply_block_prefill(p[key], cfg, spec, x, c[key],
                                    positions=positions, enc_out=enc_out,
                                    mesh=mesh, constrain=constrain)
    return x, cache


__all__ = ["SlotSpec", "slot_specs", "init_block", "apply_block",
           "init_stack", "serving_stack", "stack_forward", "init_stack_cache",
           "stack_cache_part",
           "apply_block_decode", "stack_decode", "apply_block_prefill",
           "stack_prefill"]
