"""Top-level model: embeddings + stack + prefill/decode entry points.

The port of the JAX package's ``models/model.py``: the dense, Mamba2, MoE
and hybrid decoders, the encoder-decoder family (whisper) and the VLM
family (llava).  Batch conventions:
  tokens : (B, S_text)         token ids (int)
  labels : (B, S_text)         next-token targets; -1 = ignore
  frames : (B, F, d_model)     [encdec] precomputed frame embeddings (stub)
  patches: (B, P, d_input)     [vlm]    precomputed patch embeddings (stub)

For VLM archs the model sequence is [projected patches ++ token embeds]
and logits (and the loss) cover the text positions only; the positions
run over prefix and text, so decode starts at P + S_text.  For enc-dec
the encoder (a non-causal stack over ``frames``) runs once per forward
or prefill and the decoder cross-attends to its output.  Models without
RoPE (mamba2, whisper) add sinusoidal absolute position embeddings at
the input (and whisper's encoder at its frames), in float32, as the
reference does.

The model's parameters live on one device, chosen when they are made:
`init_model` defaults to cuda and raises without a GPU unless the caller
passes ``device="cpu"``, which runs every kernel's plain version.  The
other entry points follow the parameters' device.

`forward` and `loss_fn` are differentiable (parameters that require
grad get gradients; serving's do not, so no graph is built there).  On a
CUDA device, training runs the backward kernels of attention, the SSD
scan and the grouped matmul (the MoE layer's expert products), so every
family trains there; on the CPU every family trains through the plain
versions.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_embedding, apply_linear, apply_norm, apply_unembed, init_embedding,
    init_linear, init_norm, matmul_f32,
)
from repro_torch.models.param import Init, PyTree, torch_dtype, tree_map
from repro_torch.parallel.collectives import own_slice, psum
from repro_torch.parallel.sharding import (
    Constrainer, no_constraint, row_axes, rules_for,
)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """cuda unless the caller says otherwise; raises when cuda is asked
    for (or left as the default) and there is no GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the model runs its kernels (attention, SSD scan, grouped "
            "matmul) on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: str | torch.device | None = None) -> PyTree:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (cuda by default): the reference's tree, with
    ``encoder.{stack,final_norm}`` for enc-dec archs and the patch
    ``projector`` for VLM archs."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _init_tree(Init(gen, dev), cfg)


def leaf_tree(cfg: ModelConfig) -> PyTree:
    """The parameter tree's `Leaf` (full shape, logical axes and dtype)
    at each leaf, with `init_model`'s paths; nothing is drawn (the
    reference's ``abstract_values(init_model(cfg))``, a restore's
    target)."""
    return _init_tree(Init(None, None, record=True), cfg)


def axes_tree(cfg: ModelConfig) -> PyTree:
    """The logical axes of every parameter: the reference's
    ``axes_tree(init_model(cfg))`` (a stack axis is ``"layers"``)."""
    return tree_map(lambda leaf: leaf.axes, leaf_tree(cfg))


def _init_tree(init: Init, cfg: ModelConfig) -> PyTree:
    cross = cfg.encoder is not None
    p = {
        "embed": init_embedding(init, cfg.vocab_size, cfg.d_model,
                                cfg.param_dtype),
        "stack": tfm.init_stack(init, cfg, cross=cross),
        "final_norm": init_norm(init, cfg.norm, cfg.d_model, cfg.param_dtype),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = {"w": init.dense((cfg.d_model, cfg.vocab_size),
                                        cfg.param_dtype,
                                        axes=("embed", "vocab"))}
    if cross:
        p["encoder"] = {
            "stack": tfm.init_stack(init, cfg, n_layers=cfg.encoder.n_layers),
            "final_norm": init_norm(init, cfg.norm, cfg.d_model,
                                    cfg.param_dtype),
        }
    if cfg.frontend is not None:
        p["projector"] = init_linear(init, cfg.frontend.d_input, cfg.d_model,
                                     cfg.param_dtype, axes=(None, "embed"))
    return p


def params_device(params: PyTree) -> torch.device:
    return params["embed"]["table"].device


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) int -> (B, S, d) float32 sinusoidal embeddings."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _maybe_abs_pos(cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope:
        return x
    return (x.float() + sinusoidal(positions, cfg.d_model)).to(x.dtype)


def _unembed(params: PyTree, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """float32 logits."""
    if cfg.tie_embeddings:
        return apply_unembed(params["embed"], x)
    return matmul_f32(x, params["unembed"]["w"])


def _encode(params: PyTree, cfg: ModelConfig, frames: torch.Tensor, *,
            mesh=None, constrain=no_constraint, remat: str = "none",
            unroll: bool = False) -> torch.Tensor:
    """The encoder over ``frames`` (B, F, d_model): sinusoidal positions
    added in float32, a non-causal stack, its final norm."""
    frames = frames.to(params_device(params))
    B, F, _ = frames.shape
    pos = torch.arange(F, dtype=torch.int32,
                       device=frames.device).expand(B, F).contiguous()
    x = (frames.float() + sinusoidal(pos, cfg.d_model)).to(
        torch_dtype(cfg.activation_dtype))
    x, _ = tfm.stack_forward(params["encoder"]["stack"], cfg, x,
                             positions=pos, causal=False, mesh=mesh,
                             constrain=constrain, remat=remat,
                             unroll=unroll)
    return apply_norm(cfg.norm, params["encoder"]["final_norm"], x,
                      cfg.norm_eps)


def _enc_out(params: PyTree, cfg: ModelConfig, batch: dict, *,
             mesh=None, constrain=no_constraint, remat: str = "none",
             unroll: bool = False):
    """The encoder's output for an enc-dec batch, None otherwise."""
    if cfg.encoder is None:
        return None
    return _encode(params, cfg, batch["frames"], mesh=mesh,
                   constrain=constrain, remat=remat, unroll=unroll)


def _input_embeds(params: PyTree, cfg: ModelConfig, batch: dict
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d), positions (B,S)); prepends the projected
    patches for VLM archs."""
    tokens = batch["tokens"].to(params_device(params))
    x = apply_embedding(params["embed"], tokens)
    if cfg.frontend is not None:
        patches = batch["patches"].to(device=x.device, dtype=x.dtype)
        x = torch.cat([apply_linear(params["projector"], patches), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S).contiguous()
    x = _maybe_abs_pos(cfg, x, positions)
    return x.to(torch_dtype(cfg.activation_dtype)), positions


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _forward(params: PyTree, cfg: ModelConfig, batch: dict, *,
             remat: str, unroll: bool, mesh=None, constrain=no_constraint
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, S_text, vocab) float32, the MoE auxiliary loss)."""
    enc_out = _enc_out(params, cfg, batch, mesh=mesh, constrain=constrain,
                       remat=remat, unroll=unroll)
    x, positions = _input_embeds(params, cfg, batch)
    x, aux = tfm.stack_forward(params["stack"], cfg, x, positions=positions,
                               causal=True, cross=enc_out is not None,
                               enc_out=enc_out, mesh=mesh,
                               constrain=constrain, remat=remat,
                               unroll=unroll)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    if cfg.frontend is not None:        # only text positions produce logits
        x = x[:, cfg.frontend.n_prefix:, :]
    return _unembed(params, cfg, x), aux


def _rank_batch(cfg: ModelConfig, batch: dict, mesh, constrain):
    """This rank's rows of a global batch, and the constrainer that says
    how they are cut (`parallel.sharding.row_axes` of the rules, which
    default to the training preset)."""
    rules = getattr(constrain, "rules", None) or rules_for(cfg, "train")
    rows = row_axes(rules, mesh, batch["tokens"].shape[0])
    local = {k: own_slice(v, mesh, rows, 0) for k, v in batch.items()}
    return local, Constrainer(rules, mesh, rows=rows)


def forward(params: PyTree, cfg: ModelConfig, batch: dict, *,
            mesh=None, constrain=no_constraint, remat: str = "none",
            unroll: bool = False) -> torch.Tensor:
    """Returns logits (B, S_text, vocab) float32.  (The MoE auxiliary loss
    that the stack returns beside them goes to `loss_fn`.)  Under a
    ``mesh`` every rank passes the same global batch and whole
    parameters, and gets the logits of its own rows."""
    if mesh is not None:
        batch, constrain = _rank_batch(cfg, batch, mesh, constrain)
    return _forward(params, cfg, batch, remat=remat, unroll=unroll,
                    mesh=mesh, constrain=constrain)[0]


def loss_fn(params: PyTree, cfg: ModelConfig, batch: dict, *,
            mesh=None, constrain=no_constraint, remat: str = "full",
            z_loss: float = 1e-4, unroll: bool = False,
            mean_axes: tuple[str, ...] | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy over the labels >= 0, plus ``z_loss`` times
    the mean squared log-normaliser and the MoE auxiliary loss times its
    weight.  Returns (loss, metrics) with the reference's metrics
    (``loss``, ``ce``, ``z_loss``, ``moe_aux``, ``tokens``), float32.

    Under a ``mesh`` see `_mesh_loss`."""
    if mesh is not None:
        return _mesh_loss(params, cfg, batch, mesh=mesh, constrain=constrain,
                          remat=remat, z_loss=z_loss, unroll=unroll,
                          mean_axes=mean_axes)
    logits, aux = _forward(params, cfg, batch, remat=remat, unroll=unroll)
    labels = batch["labels"].to(logits.device)
    valid = labels >= 0
    labels_c = labels.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    ce = (logz - gold) * valid
    n = valid.sum().clamp(min=1)
    ce_mean = ce.sum() / n
    zl = z_loss * (logz.square() * valid).sum() / n
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    total = ce_mean + zl + aux_w * aux
    metrics = {"loss": total, "ce": ce_mean, "z_loss": zl, "moe_aux": aux,
               "tokens": n.float()}
    return total, metrics


def _mesh_loss(params, cfg, batch, *, mesh, constrain, remat, z_loss,
               unroll, mean_axes):
    """`loss_fn` on one rank of a mesh.  Every rank passes the same global
    batch and whole parameters; the rank computes its own rows
    (`_rank_batch`).  The loss is the mean over the valid labels of the
    ranks of ``mean_axes`` (every mesh axis by default; the compressed
    train step leaves "pod" out), their count from an all-reduce.

    The returned loss has the value of that mean, and the gradient of
    this rank's share of it: its rows' sum over the count, divided by the
    ranks that hold the same rows (``rep``), plus its share of the MoE
    auxiliary loss (a mean over the ranks, `share_mean`).  The shares of
    the ranks of ``mean_axes`` add up to the loss, so the gradient is the
    sum of the ranks' gradients over ``mean_axes``.  The metrics are the
    reference's, for the whole group."""
    axes = mesh.axis_names if mean_axes is None else mesh.canonical(
        mean_axes)
    batch, constrain = _rank_batch(cfg, batch, mesh, constrain)
    logits, aux = _forward(params, cfg, batch, remat=remat, unroll=unroll,
                           mesh=mesh, constrain=constrain)
    labels = batch["labels"].to(logits.device)
    valid = labels >= 0
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None]
                        )[..., 0]
    rep = mesh.size(axes) // mesh.size(
        [a for a in constrain.rows if a in axes])
    n = psum(valid.sum().to(torch.int32), mesh, axes) // rep
    n = n.clamp(min=1)
    sums = torch.stack([((logz - gold) * valid).sum(),
                        (logz.square() * valid).sum()])
    share = (sums[0] + z_loss * sums[1]) / n / rep
    total_sums = psum(sums.detach(), mesh, axes) / rep
    ce_mean = total_sums[0] / n
    zl = z_loss * total_sums[1] / n
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    total = ce_mean + zl + aux_w * aux.detach()
    share = share + aux_w * aux
    loss = share + (total - share).detach()
    metrics = {"loss": total, "ce": ce_mean, "z_loss": zl,
               "moe_aux": aux.detach(), "tokens": n.float()}
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: str | torch.device | None = None) -> PyTree:
    """``seq_len`` counts every position of the decoder's sequence (a VLM
    prefix included); enc-dec archs add a cross cache of the encoder's
    frames."""
    n_enc = cfg.encoder.n_frames if cfg.encoder is not None else 0
    return tfm.init_stack_cache(cfg, batch, seq_len,
                                torch_dtype(cfg.activation_dtype),
                                device=resolve_device(device),
                                cross=cfg.encoder is not None, n_enc=n_enc)


def _serving_mesh(mesh) -> None:
    """Serving runs under meshes without a "model" axis: there the
    reference's presets cut heads and MLP activations over "model"
    (activation tensor parallelism), which is not ported."""
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"serving on a mesh with a \"model\" axis of "
            f"{mesh.shape['model']}: activation tensor parallelism is not "
            f"ported yet (ROADMAP Queue 1 item 19)")


@torch.no_grad()
def prefill(params: PyTree, cfg: ModelConfig, batch: dict, cache: PyTree, *,
            mesh=None, constrain=no_constraint, unroll: bool = False
            ) -> tuple[torch.Tensor, PyTree, torch.Tensor]:
    """Processes the prompt (and ``frames`` or ``patches``), fills the
    cache (in place).  Returns (last_logits (B, V) float32, cache,
    lengths (B,) int32: the positions filled, a VLM prefix included).

    Under a ``mesh`` (serving: no "model" axis) every rank passes the
    same whole batch and a whole cache and computes it all: ``constrain``
    is a `Constrainer` whose ``rows`` are ``()`` (`serve.engine.
    make_prefill_step` makes it; ``rules_for(cfg, "prefill")`` when none
    is given), and the MoE layers dispatch over the mesh as `moe.
    moe_forward` picks for rows replicated on every rank.  A caller that
    holds a part of the cache keeps its part of the one filled here
    (`serve.engine.ServeEngine`)."""
    if mesh is not None:
        _serving_mesh(mesh)
        if not isinstance(constrain, Constrainer):
            constrain = Constrainer(rules_for(cfg, "prefill"), mesh, rows=())
    enc_out = _enc_out(params, cfg, batch, mesh=mesh, constrain=constrain,
                       unroll=unroll)
    x, positions = _input_embeds(params, cfg, batch)
    x, cache = tfm.stack_prefill(params["stack"], cfg, x, cache,
                                 positions=positions,
                                 cross=enc_out is not None, enc_out=enc_out,
                                 mesh=mesh, constrain=constrain,
                                 unroll=unroll)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, -1, :])
    lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                         device=x.device)
    return logits, cache, lengths


@torch.no_grad()
def decode_step(params: PyTree, cfg: ModelConfig, tokens_t: torch.Tensor,
                cache: PyTree, lengths: torch.Tensor, *, mesh=None,
                constrain=no_constraint, unroll: bool = False
                ) -> tuple[torch.Tensor, PyTree, torch.Tensor]:
    """One token per sequence.  tokens_t: (B, 1).  Returns (logits (B, V)
    float32, cache (updated in place; a cross cache is only read), new
    lengths).

    Under a ``mesh`` (serving: no "model" axis) the tokens, the cache
    and the lengths are this rank's parts and the logits its rows', laid
    out as ``constrain`` says (`parallel.sharding.serving_layout`: the
    rows cut over its ``rows``, the attention caches' slots over its
    ``kv_seq``)."""
    if mesh is not None:
        _serving_mesh(mesh)
    dev = params_device(params)
    lengths = lengths.to(dev)
    x = apply_embedding(params["embed"], tokens_t.to(dev))
    x = _maybe_abs_pos(cfg, x, lengths[:, None])
    x = x.to(torch_dtype(cfg.activation_dtype))
    x, cache = tfm.stack_decode(params["stack"], cfg, x, cache, lengths,
                                cross=cfg.encoder is not None, mesh=mesh,
                                constrain=constrain, unroll=unroll)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, 0, :])
    return logits, cache, lengths + 1


__all__ = ["init_model", "leaf_tree", "axes_tree", "init_cache", "forward",
           "loss_fn", "prefill", "decode_step", "resolve_device",
           "params_device", "sinusoidal"]
