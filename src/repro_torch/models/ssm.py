"""Mamba2 (SSD) block: fused input projection, causal depthwise conv,
selective state-space scan, gated RMS norm, output projection.

The port of the JAX package's ``models/ssm.py``.  The scan core is
`kernels.ssd.ssd`: the Hopper kernel on CUDA tensors, the plain chunked
version on CPU tensors.  Everything around it is plain PyTorch, as the
reference computes it outside its kernel: the projections, the 4-tap
depthwise conv (written as shifted multiply-adds in float32, so no
cuDNN and no TF32), softplus, the gated RMS norm and the one-token
decode update.  Each of these runs under its program span
(``"mixer.in_proj"``, ``"mixer.conv"``, ``"mixer.dt"``, ``"mixer.ssd"``,
``"mixer.gate_norm"``, ``"mixer.out_proj"``: `observability.steps`).

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
from repro_torch.models.layers import apply_linear, init_linear, matmul_f32
from repro_torch.models.param import Init, torch_dtype
from repro_torch.observability.steps import span
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import cuts, model_tp, no_constraint


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


def _split_proj(cfg: ModelConfig, proj: torch.Tensor, tp: int = 1):
    """z, xBC and dt of the projection (of the rank's ``1/tp`` of the
    heads: see `_mixer`)."""
    s, di, H, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    di, H = di // tp, H // tp
    z, xbc, dt = torch.split(proj, [di, di + 2 * gn, H], dim=-1)
    return z, xbc, dt  # dt: (..., H)


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor, tp: int = 1):
    """Views of ``xbc``: x (..., H, P), B and C (..., G, N)."""
    s, di, H, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    di, H = di // tp, H // tp
    x, B, C = torch.split(xbc, [di, gn, gn], dim=-1)
    x = x.unflatten(-1, (H, s.head_dim))
    B = B.unflatten(-1, (s.ngroups, s.d_state))
    C = C.unflatten(-1, (s.ngroups, s.d_state))
    return x, B, C


def _gated_norm(p: dict, y: torch.Tensor, z: torch.Tensor,
                eps: float, mesh=None, width: int | None = None
                ) -> torch.Tensor:
    """RMS norm of y * silu(z) over d_inner.  With a ``mesh`` y and z hold
    the rank's ``width / M`` channels of it: the sum of squares is summed
    over "model" (`collectives.psum`, whose gradient is summed alike:
    every rank's channels depend on it)."""
    yf = y.float() * F.silu(z.float())
    if mesh is None:
        var = yf.square().mean(dim=-1, keepdim=True)
    else:
        var = coll.psum(yf.square().sum(dim=-1, keepdim=True), mesh,
                        "model") / width
    out = yf * torch.rsqrt(var + eps) * p["norm_scale"].float()
    return out.to(y.dtype)


def _rank_columns(cfg: ModelConfig, index: int, tp: int, device,
                  conv: bool) -> torch.Tensor:
    """The columns of ``in_proj`` (or, with ``conv``, the channels of the
    conv) that the rank's heads read: z and x of its heads, B and C
    whole (``ngroups`` = 1 is never cut), dt of its heads."""
    s, di, H, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    dr, hr = di // tp, H // tp

    def span(a, n):
        return torch.arange(a, a + n, device=device)
    if conv:
        return torch.cat([span(index * dr, dr), span(di, 2 * gn)])
    return torch.cat([span(index * dr, dr), span(di + index * dr, dr),
                      span(2 * di, 2 * gn), span(2 * di + 2 * gn + index * hr,
                                                 hr)])


def _mixer(p: dict, cfg: ModelConfig, constrain, device):
    """The block's leaves as the call uses them, and the "model" group's
    size ``tp`` its heads are cut over (1: every head).

    Under a call that cuts the SSM heads over "model" ("ssm_heads") the
    rank computes its ``H / M`` heads: ``in_proj`` and the conv's taps
    and bias are gathered over "model" (their contiguous cut does not
    fall on head boundaries: the projection's output is [z, xBC, dt])
    and the rank takes its heads' columns (`_rank_columns`; leaves that
    hold those columns already, `serving_leaves`', are taken as they
    are); ``A_log``, ``D`` and ``dt_bias`` are sliced
    (`collectives.scatter_to_model`); ``norm_scale`` and ``out_proj`` are
    the rank's as stored.  Where the heads do not divide, every rank
    computes every head with the whole leaves (`collectives.whole_leaf`,
    used alike).  Leaves may carry leading stack axes."""
    tp = model_tp(constrain)
    if tp == 1:
        return p, 1
    s, di, H, conv_ch = _dims(cfg)
    mesh = constrain.mesh
    proj_out = 2 * di + 2 * s.ngroups * s.d_state + H
    if not constrain.cuts("ssm_heads", H):
        def whole(w, full, dim):
            return coll.whole_leaf(w, full, dim, mesh, alike=True)
        return {"in_proj": {"w": whole(p["in_proj"]["w"], proj_out, -1)},
                "conv_w": whole(p["conv_w"], conv_ch, -1),
                "conv_b": whole(p["conv_b"], conv_ch, -1),
                "A_log": p["A_log"], "D": p["D"], "dt_bias": p["dt_bias"],
                "norm_scale": whole(p["norm_scale"], di, -1),
                "out_proj": {"w": whole(p["out_proj"]["w"], di, -2)}}, 1
    index = mesh.index("model")
    cols = _rank_columns(cfg, index, tp, device, conv=False)
    chans = _rank_columns(cfg, index, tp, device, conv=True)

    def gathered(w, full, idx):
        if w.shape[-1] == len(idx):
            return w
        return coll.whole_leaf(w, full, -1, mesh, alike=False
                               ).index_select(w.dim() - 1, idx)
    return {"in_proj": {"w": gathered(p["in_proj"]["w"], proj_out, cols)},
            "conv_w": gathered(p["conv_w"], conv_ch, chans),
            "conv_b": gathered(p["conv_b"], conv_ch, chans),
            **{k: coll.scatter_to_model(p[k], mesh, "model", -1)
               for k in ("A_log", "D", "dt_bias")},
            "norm_scale": coll.part_of_leaf(p["norm_scale"], di, -1, mesh),
            "out_proj": {"w": coll.part_of_leaf(p["out_proj"]["w"], di, -2,
                                                mesh)}}, tp


@torch.no_grad()
def serving_leaves(p: dict, cfg: ModelConfig, constrain) -> dict:
    """The block's (stacked) leaves as a serving rank keeps them, so that
    no decode call gathers a weight: where the call cuts the SSM heads,
    ``in_proj`` and the conv as the rank's heads' columns (`_mixer`), the
    rest as stored; where it does not, every leaf whole."""
    q, tp = _mixer(p, cfg, constrain, p["conv_b"].device)
    if tp == 1:
        return {**p, **q}
    return {**p, **{k: q[k] for k in ("in_proj", "conv_w", "conv_b")}}


def _out(q: dict, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
         constrain, tp: int) -> torch.Tensor:
    """The gated norm and the output projection: with the heads cut
    (``tp`` > 1) the norm's sum of squares over "model" and the rank's
    rows of ``out_proj``, its float32 partial summed over "model"
    (`collectives.from_model`) and rounded once."""
    mesh = constrain.mesh if tp > 1 else None
    with span("mixer.gate_norm"):
        y = _gated_norm(q, y, z, cfg.norm_eps, mesh, _dims(cfg)[1])
    with span("mixer.out_proj"):
        if tp == 1:
            return apply_linear(q["out_proj"], y)
        return coll.from_model(matmul_f32(y, q["out_proj"]["w"]), mesh
                               ).to(y.dtype)


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
                return_state: bool = False, constrain=no_constraint):
    """Full-sequence Mamba2 block. x: (B, S, d_model).  ``initial_state``
    (B, H, P, N) float32 is the scan's entering state (a state carried
    from an earlier chunk of the sequence; the conv starts from zeros, as
    the reference's does).  With return_state=True returns (out, {"ssm",
    "conv"}), the decode-ready state.  Under a call that cuts the SSM
    heads over "model" (`_mixer`) the scan, the states and ``conv``'s
    channels are the rank's heads'."""
    s = cfg.ssm
    q, tp = _mixer(p, cfg, constrain, x.device)
    x_in = coll.to_model(x, constrain.mesh) if tp > 1 else x
    with span("mixer.in_proj"):
        proj = apply_linear(q["in_proj"], x_in)
        z, xbc_raw, dt = _split_proj(cfg, proj, tp)
    with span("mixer.conv"):
        xbc = F.silu(_causal_conv(xbc_raw, q["conv_w"], q["conv_b"]))
        xs, B, C = _split_xbc(cfg, xbc, tp)
    with span("mixer.dt"):
        dt = F.softplus(dt.float() + q["dt_bias"])
        A = -torch.exp(q["A_log"])
    with span("mixer.ssd"):
        y, state = ssd(xs, dt, A, B, C, q["D"], chunk=s.chunk,
                       initial_state=initial_state)
        y = y.reshape(*y.shape[:-2], -1)
    out = _out(q, cfg, y, z, constrain, tp)
    if return_state:
        return out, {"ssm": state, "conv": _conv_window(xbc_raw, s.d_conv)}
    return out


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------

def init_ssm_state(cfg: ModelConfig, batch: int, dtype, *,
                   device: torch.device, layout=no_constraint) -> dict:
    """The decode state of ``batch`` rows; under a serving ``layout``
    that cuts the SSM heads over "model", the rank's heads and the conv
    channels they read (`_rank_columns`)."""
    s, di, H, conv_ch = _dims(cfg)
    if cuts(layout, "ssm_heads", H):
        tp = model_tp(layout)
        H, conv_ch = H // tp, conv_ch - di + di // tp
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch),
                            dtype=torch_dtype(dtype), device=device),
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def ssm_state_part(state: dict, cfg: ModelConfig, layout) -> dict:
    """The rank's part of a whole decode state (leading stack axes
    allowed) as `init_ssm_state` lays it out under ``layout``: its rows
    over the layout's ``rows``, and where the layout cuts the SSM heads
    its heads and the conv channels they read (`_rank_columns`)."""
    mesh, rows = layout.mesh, layout.rows
    conv, h = state["conv"], state["ssm"]
    conv = coll.own_slice(conv, mesh, rows, conv.dim() - 3)
    h = coll.own_slice(h, mesh, rows, h.dim() - 4)
    if cuts(layout, "ssm_heads", _dims(cfg)[2]):
        conv = conv.index_select(conv.dim() - 1, _rank_columns(
            cfg, mesh.index("model"), model_tp(layout), conv.device,
            conv=True))
        h = coll.own_slice(h, mesh, "model", h.dim() - 3)
    return {"conv": conv.contiguous(), "ssm": h.contiguous()}


def ssm_fill(state: dict, new: dict) -> dict:
    """Writes a prefill's decode-ready state into ``state`` in place."""
    state["conv"].copy_(new["conv"])
    state["ssm"].copy_(new["ssm"])
    return state


def ssm_decode(p: dict, cfg: ModelConfig, x_t: torch.Tensor,
               state: dict, *, constrain=no_constraint
               ) -> tuple[torch.Tensor, dict]:
    """One token: x_t (B, 1, d_model).  Returns (out (B, 1, d_model),
    state), the state updated in place (the rank's heads' where the call
    cuts them, as `ssm_forward`)."""
    q, tp = _mixer(p, cfg, constrain, x_t.device)
    B = x_t.shape[0]
    x_in = coll.to_model(x_t, constrain.mesh) if tp > 1 else x_t
    proj = apply_linear(q["in_proj"], x_in[:, 0])  # (B, proj_out)
    z, xbc, dt = _split_proj(cfg, proj, tp)

    # rolling conv: a new window, so writing its tail back overlaps nothing
    window = torch.cat([state["conv"], xbc[:, None, :].to(
        state["conv"].dtype)], dim=1)
    conv_out = (window.float() * q["conv_w"].float()).sum(dim=1) \
        + q["conv_b"].float()
    xbc_t = F.silu(conv_out).to(x_t.dtype)
    state["conv"].copy_(window[:, 1:])

    xs, Bm, Cm = _split_xbc(cfg, xbc_t, tp)  # (B,H,P), (B,G,N), (B,G,N)
    dtf = F.softplus(dt.float() + q["dt_bias"])
    A = -torch.exp(q["A_log"])
    _, y = ssd_decode_step(state["ssm"], xs, dtf, A, Bm, Cm, q["D"],
                           out=state["ssm"])
    y = y.reshape(B, -1)
    out = _out(q, cfg, y, z, constrain, tp)[:, None, :]  # (B,1,d)
    return out, state
