"""Core layer primitives: norms, linears, embeddings, RoPE, MLPs.

The port of the JAX package's ``models/layers.py``: each ``init_*``
returns a dict of tensors drawn by an `Init`, each ``apply_*`` reads the
same dict.  The arithmetic follows the reference step for step:

  * norms, RoPE and the MLP's activation run in float32 and cast back to
    the input dtype;
  * a linear layer casts its (float32-accumulated) product to the input
    dtype *before* adding the bias;
  * the MLP's up and gate products, and the unembedding's logits, stay in
    float32 (the reference's ``preferred_element_type=float32``);
  * LayerNorm uses the population variance; ``gelu`` is the tanh
    approximation (``jax.nn.gelu``'s default);
  * RoPE rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` with
    frequencies computed in float64 by numpy, then cast to float32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.sites import card_path
from repro_torch.models.param import Init
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import cuts, no_constraint


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` for 2-D CUDA operands of a 16-bit dtype, accumulated and
    returned in float32 (``torch.mm(..., out_dtype=float32)``, which has
    no derivative of its own).  The backward's products, dx = dy w^T and
    dw = x^T dy, take the float32 cotangent rounded to the operands'
    dtype, so that they run on the tensor cores as the other 16-bit
    products' gradients do, accumulate in float32 and are returned in x's
    and w's dtypes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(dy, w.T, out_dtype=torch.float32).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x.T, dy, out_dtype=torch.float32).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with float32 products and accumulation, returned in
    float32 whatever the inputs' dtype; differentiable.  16-bit operands
    take `_MatmulF32` on the card's path (`kernels.sites.card_path`)."""
    if x.dtype == torch.float32:
        return x @ w.float()
    if card_path(x):
        y = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(init: Init, d: int, dtype) -> dict:
    return {"scale": init.ones((d,), dtype, axes=("embed",))}


def apply_rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_layernorm(init: Init, d: int, dtype) -> dict:
    return {"scale": init.ones((d,), dtype, axes=("embed",)),
            "bias": init.zeros((d,), dtype, axes=("embed",))}


def apply_layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def init_norm(init: Init, kind: str, d: int, dtype) -> dict:
    if kind == "layernorm":
        return init_layernorm(init, d, dtype)
    return init_rmsnorm(init, d, dtype)


def apply_norm(kind: str, p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    if kind == "layernorm":
        return apply_layernorm(p, x, eps)
    return apply_rmsnorm(p, x, eps)


# ---------------------------------------------------------------------------
# Linear / embedding
# ---------------------------------------------------------------------------

def init_linear(init: Init, d_in: int, d_out: int, dtype, *,
                axes=(None, None), bias: bool = False,
                bias_axis: str | None = None) -> dict:
    p = {"w": init.dense((d_in, d_out), dtype, fan_in=d_in, axes=axes)}
    if bias:
        p["b"] = init.zeros((d_out,), dtype, axes=(bias_axis,))
    return p


def apply_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    # a product in x's dtype is the float32-accumulated product cast to
    # it, which is what the reference computes before the bias
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def init_embedding(init: Init, vocab: int, d: int, dtype) -> dict:
    return {"table": init.embed((vocab, d), dtype, axes=("vocab", "embed"))}


def apply_embedding(p: dict, tokens: torch.Tensor, *,
                    vocab: int | None = None,
                    constrain=no_constraint) -> torch.Tensor:
    """The rows of ``tokens``.  Under a call that cuts the ``vocab`` over
    "model" ("vocab_act"; the storage cuts the table's rows alike) the
    table is the rank's rows: ids outside them read 0, and the ranks'
    rows are summed (`collectives.from_model`)."""
    table = p["table"]
    if not cuts(constrain, "vocab_act", vocab):
        return table[tokens]
    mesh = constrain.mesh
    part = coll.part_of_leaf(table, vocab, 0, mesh).shape[0]
    local = tokens - mesh.index("model") * part
    mine = (local >= 0) & (local < part)
    rows = table[local.clamp(0, part - 1)]
    return coll.from_model(torch.where(mine[..., None], rows, 0), mesh)


def apply_unembed(p: dict, x: torch.Tensor, *, vocab: int | None = None,
                  constrain=no_constraint) -> torch.Tensor:
    """Tied unembedding: logits = x @ table^T (float32 logits); under a
    call that cuts the ``vocab``, the rank's vocabulary columns."""
    table = p["table"]
    if cuts(constrain, "vocab_act", vocab):
        coll.part_of_leaf(table, vocab, 0, constrain.mesh)
        x = coll.to_model(x, constrain.mesh)
    return matmul_f32(x, table.T)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64) / d_head))


@functools.lru_cache(maxsize=None)
def _rope_freqs(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    """The float32 frequencies on ``device``, made once: the reference's
    jit folds them into a constant, and a copy from the host per call
    would synchronise the stream twice per layer.  Rounded to float32 by
    numpy and made a tensor outside the dispatcher: the card does no work
    for it per call, and a trace of the call (`launch.dryrun`) counts
    none."""
    host = torch.from_numpy(rope_frequencies(d_head, theta).astype(np.float32))
    return host.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate pairs (x[..., ::2], x[..., 1::2]).  x: [..., seq, heads,
    d_head], positions: broadcastable to [..., seq]."""
    freqs = _rope_freqs(x.shape[-1], float(theta), x.device)
    angles = positions[..., :, None].float() * freqs     # [..., S, d/2]
    cos = torch.cos(angles)[..., :, None, :]             # over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Feed-forward blocks
# ---------------------------------------------------------------------------

def init_mlp(init: Init, d_model: int, d_ff: int, dtype, *,
             gated: bool = True) -> dict:
    p = {
        "up": init.dense((d_model, d_ff), dtype, axes=("embed", "mlp")),
        "down": init.dense((d_ff, d_model), dtype, fan_in=d_ff,
                           axes=("mlp", "embed")),
    }
    if gated:
        p["gate"] = init.dense((d_model, d_ff), dtype, axes=("embed", "mlp"))
    return p


def _activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {name}")


def apply_mlp(p: dict, x: torch.Tensor, *, gated: bool = True,
              act: str = "silu", d_ff: int | None = None,
              constrain=no_constraint) -> torch.Tensor:
    """The feed-forward block.  Under a call that cuts the ``d_ff``
    columns over "model" ("mlp_act"), ``up``/``gate`` are the rank's
    columns and ``down`` its rows (Megatron's column- and row-parallel
    pair): the rank's float32 partial products are summed over "model"
    and rounded once to x's dtype."""
    mesh = None
    if cuts(constrain, "mlp_act", d_ff):
        mesh = constrain.mesh
        for name, w in p.items():
            coll.part_of_leaf(w, d_ff, 0 if name == "down" else 1, mesh)
        x_in = coll.to_model(x, mesh)
    else:
        x_in = x
    up = matmul_f32(x_in, p["up"])
    if gated:
        h = _activation(act, matmul_f32(x_in, p["gate"])) * up
    else:
        h = _activation(act, up)
    if mesh is not None:
        return coll.from_model(matmul_f32(h.to(x.dtype), p["down"]),
                               mesh).to(x.dtype)
    return h.to(x.dtype) @ p["down"].to(x.dtype)
