"""Mamba2 (SSD) block: fused input projection, causal depthwise conv,
selective state-space scan, gated RMS norm, output projection.

The port of the JAX package's ``models/ssm.py``.  The scan core is
`kernels.ssd.ssd`: the Hopper kernel on CUDA tensors, the plain chunked
version on CPU tensors.  Everything around it is plain PyTorch, as the
reference computes it outside its kernel: the projections, the 4-tap
depthwise conv (written as shifted multiply-adds in float32, so no
cuDNN and no TF32), softplus, the gated RMS norm and the one-token
decode update.

Decode state per layer:
  conv:  (B, d_conv-1, conv_ch)   rolling conv window (conv_ch = di + 2*G*N)
  ssm:   (B, H, P, N) float32     recurrent state

Unlike the reference, whose arrays are immutable, prefill and decode
write the state in place through the cache views they are given, as
`attention.cache_fill` does for the KV cache.  The prefill's conv window
is the last d_conv-1 raw inputs, zero-padded at the front when the prompt
is shorter: the zeros the causal conv itself saw.  (The reference keeps
fewer rows then, which its decode cannot take.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.ops import ssd, ssd_decode_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_linear, init_linear
from repro_torch.models.param import Init, torch_dtype


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    conv_ch = di + 2 * s.ngroups * s.d_state
    return s, di, H, conv_ch


def init_ssm(init: Init, cfg: ModelConfig) -> dict:
    s, di, H, conv_ch = _dims(cfg)
    d, dt = cfg.d_model, cfg.param_dtype
    proj_out = 2 * di + 2 * s.ngroups * s.d_state + H  # [z, xBC, dt]
    return {
        "in_proj": init_linear(init, d, proj_out, dt, axes=("embed", "ssm")),
        "conv_w": init.dense((s.d_conv, conv_ch), dt, fan_in=s.d_conv,
                             axes=("conv", "ssm")),
        "conv_b": init.zeros((conv_ch,), dt, axes=("ssm",)),
        "A_log": init.a_log((H,), axes=(None,)),
        "D": init.ones((H,), "float32", axes=(None,)),
        "dt_bias": init.dt_bias((H,), axes=(None,)),
        "norm_scale": init.ones((di,), dt, axes=("ssm",)),
        "out_proj": init_linear(init, di, d, dt, axes=("ssm", "embed")),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    s, di, H, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    z, xbc, dt = torch.split(proj, [di, di + 2 * gn, H], dim=-1)
    return z, xbc, dt  # dt: (..., H)


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    """Views of ``xbc``: x (..., H, P), B and C (..., G, N)."""
    s, di, H, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    x, B, C = torch.split(xbc, [di, gn, gn], dim=-1)
    x = x.unflatten(-1, (H, s.head_dim))
    B = B.unflatten(-1, (s.ngroups, s.d_state))
    C = C.unflatten(-1, (s.ngroups, s.d_state))
    return x, B, C


def _gated_norm(p: dict, y: torch.Tensor, z: torch.Tensor,
                eps: float) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    var = yf.square().mean(dim=-1, keepdim=True)
    out = yf * torch.rsqrt(var + eps) * p["norm_scale"].float()
    return out.to(y.dtype)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps (K, C): the K-1
    rows before the sequence are 0.  Products and sums in float32, the
    result rounded to the input dtype before the bias, as the
    reference's convolution in the input dtype does."""
    K, S = w.shape[0], xbc.shape[1]
    wf = w.to(xbc.dtype).float()
    xp = F.pad(xbc.float(), (0, 0, K - 1, 0))
    out = xp[:, 0:S] * wf[0]
    for k in range(1, K):
        out = out + xp[:, k:k + S] * wf[k]
    out = out.to(xbc.dtype)
    return out + b.to(out.dtype)


def _conv_window(xbc_raw: torch.Tensor, K: int) -> torch.Tensor:
    """The last K-1 raw conv inputs, with zeros in front of a shorter
    sequence."""
    S = xbc_raw.shape[1]
    tail = xbc_raw[:, max(S - (K - 1), 0):]
    return F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))


def ssm_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                initial_state: torch.Tensor | None = None,
                return_state: bool = False):
    """Full-sequence Mamba2 block. x: (B, S, d_model).  ``initial_state``
    (B, H, P, N) float32 is the scan's entering state (a state carried
    from an earlier chunk of the sequence; the conv starts from zeros, as
    the reference's does).  With return_state=True returns (out, {"ssm",
    "conv"}), the decode-ready state."""
    s, di, H, _ = _dims(cfg)
    proj = apply_linear(p["in_proj"], x)
    z, xbc_raw, dt = _split_proj(cfg, proj)
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xs, B, C = _split_xbc(cfg, xbc)

    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssd(xs, dt, A, B, C, p["D"], chunk=s.chunk,
                   initial_state=initial_state)
    y = y.reshape(*y.shape[:-2], di)
    y = _gated_norm(p, y, z, cfg.norm_eps)
    out = apply_linear(p["out_proj"], y)
    if return_state:
        return out, {"ssm": state, "conv": _conv_window(xbc_raw, s.d_conv)}
    return out


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------

def init_ssm_state(cfg: ModelConfig, batch: int, dtype, *,
                   device: torch.device) -> dict:
    s, di, H, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch),
                            dtype=torch_dtype(dtype), device=device),
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def ssm_fill(state: dict, new: dict) -> dict:
    """Writes a prefill's decode-ready state into ``state`` in place."""
    state["conv"].copy_(new["conv"])
    state["ssm"].copy_(new["ssm"])
    return state


def ssm_decode(p: dict, cfg: ModelConfig, x_t: torch.Tensor,
               state: dict) -> tuple[torch.Tensor, dict]:
    """One token: x_t (B, 1, d_model).  Returns (out (B, 1, d_model),
    state), the state updated in place."""
    s, di, H, conv_ch = _dims(cfg)
    B = x_t.shape[0]
    proj = apply_linear(p["in_proj"], x_t[:, 0])  # (B, proj_out)
    z, xbc, dt = _split_proj(cfg, proj)

    # rolling conv: a new window, so writing its tail back overlaps nothing
    window = torch.cat([state["conv"], xbc[:, None, :].to(
        state["conv"].dtype)], dim=1)
    conv_out = (window.float() * p["conv_w"].float()).sum(dim=1) \
        + p["conv_b"].float()
    xbc_t = F.silu(conv_out).to(x_t.dtype)
    state["conv"].copy_(window[:, 1:])

    xs, Bm, Cm = _split_xbc(cfg, xbc_t)  # (B,H,P), (B,G,N), (B,G,N)
    dtf = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    _, y = ssd_decode_step(state["ssm"], xs, dtf, A, Bm, Cm, p["D"],
                           out=state["ssm"])
    y = y.reshape(B, di)
    y = _gated_norm(p, y, z, cfg.norm_eps)
    out = apply_linear(p["out_proj"], y)[:, None, :]  # (B,1,d)
    return out, state


__all__ = ["init_ssm", "ssm_forward", "init_ssm_state", "ssm_fill",
           "ssm_decode"]
