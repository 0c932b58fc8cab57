"""Top-level model: embeddings + stack + prefill/decode entry points.

The port of the JAX package's ``models/model.py`` for token-only
decoders (the dense, Mamba2, MoE and hybrid families).  Batch conventions:
  tokens : (B, S)     token ids (int)

Models without RoPE (mamba2) add sinusoidal absolute position embeddings
at the input, in float32, as the reference does.

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

Not on this slice: the encoder of enc-dec models and the VLM patch
prefix (item 11).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_embedding, apply_norm, apply_unembed, init_embedding, init_norm,
    matmul_f32,
)
from repro_torch.models.param import Init, PyTree, torch_dtype


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


def _check_family(cfg: ModelConfig):
    if cfg.encoder is not None or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the encoder and the VLM prefix are not ported yet "
            f"(ROADMAP Queue 1 item 11)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: str | torch.device | None = None) -> PyTree:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (cuda by default)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init = Init(gen, dev)
    p = {
        "embed": init_embedding(init, cfg.vocab_size, cfg.d_model,
                                cfg.param_dtype),
        "stack": tfm.init_stack(init, cfg),
        "final_norm": init_norm(init, cfg.norm, cfg.d_model, cfg.param_dtype),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = {"w": init.dense((cfg.d_model, cfg.vocab_size),
                                        cfg.param_dtype)}
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


def _input_embeds(params: PyTree, cfg: ModelConfig, batch: dict
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d), positions (B,S)) for a token-only batch."""
    _check_family(cfg)
    tokens = batch["tokens"].to(params_device(params))
    B, S = tokens.shape
    x = apply_embedding(params["embed"], tokens)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S).contiguous()
    x = _maybe_abs_pos(cfg, x, positions)
    return x.to(torch_dtype(cfg.activation_dtype)), positions


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _forward(params: PyTree, cfg: ModelConfig, batch: dict, *,
             remat: str, unroll: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, S, vocab) float32, the MoE auxiliary loss)."""
    x, positions = _input_embeds(params, cfg, batch)
    x, aux = tfm.stack_forward(params["stack"], cfg, x, positions=positions,
                               causal=True, remat=remat, unroll=unroll)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x), aux


def forward(params: PyTree, cfg: ModelConfig, batch: dict, *,
            remat: str = "none", unroll: bool = False) -> torch.Tensor:
    """Returns logits (B, S, vocab) float32.  (The MoE auxiliary loss that
    the stack returns beside them goes to `loss_fn`.)"""
    return _forward(params, cfg, batch, remat=remat, unroll=unroll)[0]


def loss_fn(params: PyTree, cfg: ModelConfig, batch: dict, *,
            remat: str = "full", z_loss: float = 1e-4,
            unroll: bool = False) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy over the labels >= 0, plus ``z_loss`` times
    the mean squared log-normaliser and the MoE auxiliary loss times its
    weight.  Returns (loss, metrics) with the reference's metrics
    (``loss``, ``ce``, ``z_loss``, ``moe_aux``, ``tokens``), float32."""
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


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: str | torch.device | None = None) -> PyTree:
    _check_family(cfg)
    return tfm.init_stack_cache(cfg, batch, seq_len,
                                torch_dtype(cfg.activation_dtype),
                                device=resolve_device(device))


@torch.no_grad()
def prefill(params: PyTree, cfg: ModelConfig, batch: dict, cache: PyTree
            ) -> tuple[torch.Tensor, PyTree, torch.Tensor]:
    """Processes the prompt, fills the cache (in place).  Returns
    (last_logits (B, V) float32, cache, lengths (B,) int32)."""
    x, positions = _input_embeds(params, cfg, batch)
    x, cache = tfm.stack_prefill(params["stack"], cfg, x, cache,
                                 positions=positions)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, -1, :])
    lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                         device=x.device)
    return logits, cache, lengths


@torch.no_grad()
def decode_step(params: PyTree, cfg: ModelConfig, tokens_t: torch.Tensor,
                cache: PyTree, lengths: torch.Tensor
                ) -> tuple[torch.Tensor, PyTree, torch.Tensor]:
    """One token per sequence.  tokens_t: (B, 1).  Returns (logits (B, V)
    float32, cache (updated in place), new lengths)."""
    _check_family(cfg)
    dev = params_device(params)
    lengths = lengths.to(dev)
    x = apply_embedding(params["embed"], tokens_t.to(dev))
    x = _maybe_abs_pos(cfg, x, lengths[:, None])
    x = x.to(torch_dtype(cfg.activation_dtype))
    x, cache = tfm.stack_decode(params["stack"], cfg, x, cache, lengths)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, 0, :])
    return logits, cache, lengths + 1


__all__ = ["init_model", "init_cache", "forward", "loss_fn", "prefill",
           "decode_step", "resolve_device", "params_device", "sinusoidal"]
