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

The training forward runs its input embedding, final norm and loss (the
unembedding, then log-sum-exp, CE and z-loss) under the program spans
``"embed"``, ``"final_norm"`` and ``"loss"`` (`observability.steps`).
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
from repro_torch.observability.steps import span
from repro_torch.parallel.collectives import (
    from_model, gather_from_model, own_slice, part_of_leaf, psum, shard_of,
    to_model, vocab_logsumexp,
)
from repro_torch.parallel.sharding import (
    Constrainer, cuts, no_constraint, row_axes, rules_for,
)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """cuda unless the caller says otherwise; raises when cuda is asked
    for (or left as the default) and there is no GPU.  "meta" (shapes and
    dtypes only, nothing allocated: `configs.input_specs`) is taken as
    it is."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the model runs its kernels (attention, SSD scan, grouped "
            "matmul) on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be cuda, cpu or meta, got {dev}")
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


def _unembed(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
             constrain=no_constraint) -> torch.Tensor:
    """float32 logits: the rank's vocabulary columns under a call that
    cuts the vocabulary over "model" ("vocab_act")."""
    V = cfg.vocab_size
    if cfg.tie_embeddings:
        return apply_unembed(params["embed"], x, vocab=V,
                             constrain=constrain)
    w = params["unembed"]["w"]
    if cuts(constrain, "vocab_act", V):
        x = to_model(x, constrain.mesh)
        part_of_leaf(w, V, 1, constrain.mesh)
    return matmul_f32(x, w)


def _whole_logits(logits: torch.Tensor, cfg: ModelConfig,
                  constrain) -> torch.Tensor:
    """The logits over the whole vocabulary (gathered over "model" where
    the call cut it)."""
    if cuts(constrain, "vocab_act", cfg.vocab_size):
        return gather_from_model(logits, constrain.mesh, "model", -1)
    return logits


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


def _input_embeds(params: PyTree, cfg: ModelConfig, batch: dict,
                  constrain=no_constraint
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d), positions (B,S)); prepends the projected
    patches for VLM archs."""
    tokens = batch["tokens"].to(params_device(params))
    x = apply_embedding(params["embed"], tokens, vocab=cfg.vocab_size,
                        constrain=constrain)
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
    """(logits (B, S_text, vocab) float32 -- the rank's vocabulary
    columns under a call that cuts them -- the MoE auxiliary loss)."""
    enc_out = _enc_out(params, cfg, batch, mesh=mesh, constrain=constrain,
                       remat=remat, unroll=unroll)
    with span("embed"):
        x, positions = _input_embeds(params, cfg, batch, constrain)
    x, aux = tfm.stack_forward(params["stack"], cfg, x, positions=positions,
                               causal=True, cross=enc_out is not None,
                               enc_out=enc_out, mesh=mesh,
                               constrain=constrain, remat=remat,
                               unroll=unroll)
    with span("final_norm"):
        x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    if cfg.frontend is not None:        # only text positions produce logits
        x = x[:, cfg.frontend.n_prefix:, :]
    with span("loss"):
        return _unembed(params, cfg, x, constrain), aux


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
    ``mesh`` every rank passes the same global batch and the parameters
    as `model_part` cuts them (whole where the rules keep activations
    uncut over "model"), and gets the logits of its own rows, over the
    whole vocabulary."""
    if mesh is not None:
        batch, constrain = _rank_batch(cfg, batch, mesh, constrain)
    logits = _forward(params, cfg, batch, remat=remat, unroll=unroll,
                      mesh=mesh, constrain=constrain)[0]
    return _whole_logits(logits, cfg, constrain)


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
    with span("loss"):
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
    batch and the parameters as `model_part` cuts them; the rank computes
    its own rows (`_rank_batch`).  The loss is the mean over the valid
    labels of the ranks of ``mean_axes`` (every mesh axis by default; the
    compressed train step leaves "pod" out), their count from an
    all-reduce.

    The ranks that share a set of rows hold shares of the loss: every
    rank of ``mean_axes`` when the activations are not cut over "model",
    else every rank of ``mean_axes`` but "model" -- a "model" group (the
    "model" cut, `parallel.sharding.model_cut`) computes its rows' loss
    once, alike on its ranks: the logits are the rank's vocabulary
    columns, log-sum-exp and the gold logit summed over "model"
    (`collectives.vocab_logsumexp`, `from_model`), and each rank's
    backward gives its own slices' gradient and the replicated leaves'
    whole.  The returned loss has the value of the mean, and the gradient
    of this rank's share: its rows' sum over the count, divided by the
    share-holding ranks that hold the same rows (``rep``), plus its share
    of the MoE auxiliary loss (a mean over the share-holding ranks,
    `share_mean`).  The gradient is the sum of the ranks' gradients over
    the share-holding axes (`train.train_step`).  The metrics are the
    reference's, for the whole group."""
    axes = mesh.axis_names if mean_axes is None else mesh.canonical(
        mean_axes)
    batch, constrain = _rank_batch(cfg, batch, mesh, constrain)
    axes = tuple(a for a in axes if a in constrain.share_axes())
    logits, aux = _forward(params, cfg, batch, remat=remat, unroll=unroll,
                           mesh=mesh, constrain=constrain)
    with span("loss"):
        labels = batch["labels"].to(logits.device)
        valid = labels >= 0
        labels_c = labels.clamp(min=0).long()
        if cuts(constrain, "vocab_act", cfg.vocab_size):
            logz = vocab_logsumexp(logits, mesh, "model")
            part = logits.shape[-1]
            local = labels_c - mesh.index("model") * part
            mine = (local >= 0) & (local < part)
            gold = torch.gather(logits, -1,
                                local.clamp(0, part - 1)[..., None])[..., 0]
            gold = from_model(torch.where(mine, gold, 0.0), mesh, "model")
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels_c[..., None])[..., 0]
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


def model_specs(cfg: ModelConfig, rules, mesh) -> PyTree:
    """The cut over "model" of every parameter that a call under
    (``rules``, ``mesh``) uses as stored: the "model" entries of its
    shape-aware spec where the rules cut activations over "model"
    (`parallel.sharding.model_cut`), none elsewhere."""
    from repro_torch.parallel.sharding import (
        P, model_cut, param_spec_tree, split_model,
    )
    tp = model_cut(rules, mesh)
    return tree_map(lambda s: split_model(s)[0] if tp > 1 else P(),
                    param_spec_tree(leaf_tree(cfg), rules, mesh))


def model_part(params: PyTree, cfg: ModelConfig, rules, mesh) -> PyTree:
    """This rank's part (copies) of whole parameters as a call under
    (``rules``, ``mesh``) takes them (`model_specs`)."""
    return tree_map(lambda t, s: shard_of(t, s, mesh).clone(), params,
                    model_specs(cfg, rules, mesh))


def serving_part(params: PyTree, cfg: ModelConfig, rules, mesh) -> PyTree:
    """`model_part` as a serving rank keeps it: under the "model" cut the
    weights its calls would gather every call (the kv projections whose
    heads do not divide "model", the SSM's ``in_proj`` and conv as the
    rank's heads' columns: `transformer.serving_stack`) gathered once."""
    part = model_part(params, cfg, rules, mesh)
    constrain = Constrainer(rules, mesh, rows=())
    if constrain.tp == 1:
        return part
    part["stack"] = tfm.serving_stack(part["stack"], cfg, constrain,
                                      cross=cfg.encoder is not None)
    if cfg.encoder is not None:
        part["encoder"]["stack"] = tfm.serving_stack(
            part["encoder"]["stack"], cfg, constrain)
    return part


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: str | torch.device | None = None,
               layout=no_constraint) -> PyTree:
    """``seq_len`` counts every position of the decoder's sequence (a VLM
    prefix included); enc-dec archs add a cross cache of the encoder's
    frames.  Under a serving ``layout`` (a `parallel.sharding.
    Constrainer` on a mesh) each cache of the ``batch`` rows is the rank's
    part, as the reference's decode-cache layout cuts it (its dry-run's
    ``cache_shardings``): the kv heads over "model" where the call cuts
    them, else the slots (with the layout's ``kv_seq``:
    `attention.kv_slots`); the SSM state by head and the conv window's
    channels of those heads (`ssm.init_ssm_state`)."""
    n_enc = cfg.encoder.n_frames if cfg.encoder is not None else 0
    return tfm.init_stack_cache(cfg, batch, seq_len,
                                torch_dtype(cfg.activation_dtype),
                                device=resolve_device(device),
                                cross=cfg.encoder is not None, n_enc=n_enc,
                                layout=layout)


def cache_part(cache: PyTree, cfg: ModelConfig, layout) -> PyTree:
    """The rank's part of a whole cache, as `init_cache` lays it
    out under a serving ``layout`` (its rows, and its kv heads, slots and
    SSM heads as the layout cuts them): what a rank's prefill under that
    layout fills."""
    return tfm.stack_cache_part(cache, cfg, layout,
                                cross=cfg.encoder is not None)


@torch.no_grad()
def prefill(params: PyTree, cfg: ModelConfig, batch: dict, cache: PyTree, *,
            mesh=None, constrain=no_constraint, unroll: bool = False
            ) -> tuple[torch.Tensor, PyTree, torch.Tensor]:
    """Processes the prompt (and ``frames`` or ``patches``), fills the
    cache (in place).  Returns (last_logits (B, V) float32, cache,
    lengths (B,) int32: the positions filled, a VLM prefix included).

    Under a ``mesh`` ``batch`` holds this rank's rows, as ``constrain``
    (a `Constrainer`) cuts them over its ``rows``: the rank's part of a
    batch that `serve.engine.make_prefill_step` cuts
    (`parallel.sharding.prefill_layout`), or every row where ``rows`` is
    ``()`` (the engine's prefill of one request; ``rules_for(cfg,
    "prefill")`` with every row when no constrainer is given).  The
    parameters are `model_part`'s under its rules and the cache is the
    rank's part of the rows' cache (`init_cache` with
    ``layout=constrain``): where the rules cut activations over "model"
    the rank computes its heads, MLP columns, SSM heads and vocabulary
    part; the logits are its rows', whole over the vocabulary; the
    encoder runs over its rows' frames, the MoE layers dispatch over the
    mesh as `moe.moe_forward` picks for rows cut over ``rows``
    (expert-parallel on the rank's rows under ``ep``), and attention is
    sequence-parallel over "model" on its rows where the heads do not
    divide it (`attention._use_sp`).
    """
    if mesh is not None and not isinstance(constrain, Constrainer):
        constrain = Constrainer(rules_for(cfg, "prefill"), mesh, rows=())
    enc_out = _enc_out(params, cfg, batch, mesh=mesh, constrain=constrain,
                       unroll=unroll)
    x, positions = _input_embeds(params, cfg, batch, constrain)
    x, cache = tfm.stack_prefill(params["stack"], cfg, x, cache,
                                 positions=positions,
                                 cross=enc_out is not None, enc_out=enc_out,
                                 mesh=mesh, constrain=constrain,
                                 unroll=unroll)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = _whole_logits(_unembed(params, cfg, x[:, -1, :], constrain),
                           cfg, constrain)
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

    Under a ``mesh`` the tokens, the cache and the lengths are this
    rank's parts and the logits its rows', over the whole vocabulary,
    laid out as ``constrain`` says (`parallel.sharding.serving_layout`:
    the rows cut over its ``rows``, the attention caches' slots over its
    ``kv_seq``, and the "model" cut as `prefill` has it)."""
    dev = params_device(params)
    lengths = lengths.to(dev)
    x = apply_embedding(params["embed"], tokens_t.to(dev),
                        vocab=cfg.vocab_size, constrain=constrain)
    x = _maybe_abs_pos(cfg, x, lengths[:, None])
    x = x.to(torch_dtype(cfg.activation_dtype))
    x, cache = tfm.stack_decode(params["stack"], cfg, x, cache, lengths,
                                cross=cfg.encoder is not None, mesh=mesh,
                                constrain=constrain, unroll=unroll)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = _whole_logits(_unembed(params, cfg, x[:, 0, :], constrain),
                           cfg, constrain)
    return logits, cache, lengths + 1


__all__ = ["init_model", "leaf_tree", "axes_tree", "init_cache", "forward",
           "loss_fn", "model_specs", "model_part", "serving_part",
           "cache_part", "prefill", "decode_step", "resolve_device",
           "params_device", "sinusoidal"]
