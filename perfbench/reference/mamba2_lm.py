"""Plain PyTorch reference of the benchmark's language model: the Mamba-2
(SSD) stack, every layer a pre-norm residual SSD mixer.

Written from the published equations and the configuration file's sizes;
it imports nothing of the program.  Every product and sum runs in
float32 with TF32 off (`exact_matmuls`); the weights are the benchmark's
bfloat16 draws (`perfbench.weights`), read as float32.  ``prec="fp8"``
rounds both operands of every linear layer to float8 e4m3 (one scale a
tensor) first: the control that a lower precision has to fail.

Layer equations (RMS norms with eps):
  input    x = E[token] + sinusoidal(position)            (no RoPE)
  SSD      [z, xBC, dt] = h W_in;  xBC = silu(causal_conv4(xBC) + b)
           dt = softplus(dt + dt_bias);  A = -exp(A_log)
           S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T;  y_t = S_t C_t + D x_t
           out = rmsnorm(y * silu(z)) * g  W_out
  output   logits = rmsnorm(x) W_unembed   (E^T when tied)
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from perfbench import weights

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_matmuls():
    """float32 products without TF32 while the block runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    gradient passes straight through the rounding)."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


def mm(a: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        return fp8(a) @ fp8(w)
    return a @ w


# ---------------------------------------------------------------------------
# sizes and layer pattern
# ---------------------------------------------------------------------------

class Sizes:
    """The configuration file's ``sizes`` (an SSD stack: ``family`` "ssm",
    its layers in one stack at ``stack.slot0``)."""

    def __init__(self, s: dict):
        if s["family"] != "ssm":
            raise ValueError(f"no reference for family {s['family']!r}")
        self.s = s
        self.n_layers = s["n_layers"]
        self.d = s["d_model"]
        self.vocab = s["vocab_size"]
        self.eps = s["norm_eps"]
        self.tied = s["tie_embeddings"]
        self.ssm = s["ssm"]
        self.di = self.ssm["expand"] * self.d
        self.H = self.di // self.ssm["head_dim"]
        self.gn = self.ssm["ngroups"] * self.ssm["d_state"]
        self.conv_ch = self.di + 2 * self.gn

    def layers(self):
        """(stack index, slot) of each layer in depth order."""
        return [(i, 0) for i in range(self.n_layers)]

    def layer_shapes(self, slot: int) -> dict:
        """path under ``stack.slot{slot}`` -> shape of one layer's leaf."""
        c, d = self.ssm, self.d
        return {"norm1.scale": (d,),
                "mixer.in_proj.w": (d, 2 * self.di + 2 * self.gn + self.H),
                "mixer.conv_w": (c["d_conv"], self.conv_ch),
                "mixer.conv_b": (self.conv_ch,),
                "mixer.A_log": (self.H,), "mixer.D": (self.H,),
                "mixer.dt_bias": (self.H,), "mixer.norm_scale": (self.di,),
                "mixer.out_proj.w": (self.di, d)}


FLOAT32_LEAVES = ("A_log", "D", "dt_bias")


def leaf(seed: int, path: str, index: int, shape, dtype, device
         ) -> torch.Tensor:
    """A weight as float32, from the benchmark's draw in its stored
    dtype (float32 for the scan parameters and the router)."""
    name = path.rsplit(".", 1)[-1]
    stored = torch.float32 if name in FLOAT32_LEAVES else dtype
    return weights.draw(seed, path, index, shape, stored, device).float()


def layer_weights(z: Sizes, seed: int, index: int, slot: int, dtype,
                  device) -> dict:
    return {k: leaf(seed, f"stack.slot{slot}.{k}", index, shp, dtype, device)
            for k, shp in z.layer_shapes(slot).items()}


def top_weights(z: Sizes, seed: int, dtype, device) -> dict:
    w = {"embed": leaf(seed, "embed.table", -1, (z.vocab, z.d), dtype,
                       device),
         "final_norm": leaf(seed, "final_norm.scale", -1, (z.d,), dtype,
                            device)}
    w["unembed"] = (w["embed"].T if z.tied else
                    leaf(seed, "unembed.w", -1, (z.d, z.vocab), dtype,
                         device))
    return w


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def sinusoidal(pos: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=pos.device) / max(half - 1, 1))
    ang = pos[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed(top: dict, z: Sizes, tokens, pos):
    return top["embed"][tokens] + sinusoidal(pos, z.d)


def ssd_scan(x, dt, A, B, C, D, chunk: int):
    """The SSD recurrence from a zero state, chunked: x (b, S, H, P), dt
    (b, S, H), B and C (b, S, G, N).  Returns y (b, S, H, P)."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, B, C))
    nc = x.shape[1] // Q
    x = x.reshape(b, nc, Q, H, P)
    B = B.reshape(b, nc, Q, G, N)
    C = C.reshape(b, nc, Q, G, N)
    dt = dt.reshape(b, nc, Q, H)
    cum = torch.cumsum(dt * A, dim=2)                       # (b,nc,Q,H)
    heads = torch.arange(H, device=x.device) // (H // G)
    scores = torch.einsum("bcign,bcjgn->bcgij", C, B)[:, :, heads]
    diff = cum.transpose(2, 3)[..., :, None] - cum.transpose(2, 3)[..., None, :]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal, diff, float("-inf")))
    m = scores * decay * dt.transpose(2, 3)[..., None, :]   # (b,nc,H,Q,Q)
    y = torch.einsum("bchij,bcjhp->bcihp", m, x)
    # each chunk's own contribution to the state at its end
    last = cum[:, :, -1:, :]
    w = torch.exp(last - cum) * dt                          # (b,nc,Q,H)
    Bh = B[:, :, :, heads]                                  # (b,nc,Q,H,N)
    own = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", w, x, Bh)
    states, state = [], torch.zeros_like(own[:, 0])
    for c in range(nc):
        states.append(state)
        state = state * torch.exp(last[:, c, 0])[..., None, None] + own[:, c]
    entering = torch.stack(states, dim=1)                   # (b,nc,H,P,N)
    Ch = C[:, :, :, heads]
    y = y + torch.einsum("bcih,bcihn,bchpn->bcihp", torch.exp(cum), Ch,
                         entering)
    y = y + D[:, None] * x
    return y.reshape(b, nc * Q, H, P)[:, :S]


def ssm_mixer(w: dict, z: Sizes, h: torch.Tensor, prec: str):
    """h (b, S, d), every row a sequence from position 0."""
    c = z.ssm
    b, S, _ = h.shape
    proj = mm(h, w["mixer.in_proj.w"], prec)
    zg, xbc, dt = torch.split(proj, [z.di, z.conv_ch, z.H], dim=-1)
    K = c["d_conv"]
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(xp[:, k:k + S] * w["mixer.conv_w"][k] for k in range(K))
    xbc = F.silu(conv + w["mixer.conv_b"])
    xs, Bm, Cm = torch.split(xbc, [z.di, z.gn, z.gn], dim=-1)
    xs = xs.reshape(b, S, z.H, c["head_dim"])
    Bm = Bm.reshape(b, S, c["ngroups"], c["d_state"])
    Cm = Cm.reshape(b, S, c["ngroups"], c["d_state"])
    dt = F.softplus(dt + w["mixer.dt_bias"])
    A = -torch.exp(w["mixer.A_log"])
    y = ssd_scan(xs, dt, A, Bm, Cm, w["mixer.D"], c["chunk"])
    y = y.reshape(b, S, z.di) * F.silu(zg)
    y = rmsnorm(y, w["mixer.norm_scale"], z.eps)
    return mm(y, w["mixer.out_proj.w"], prec)


# ---------------------------------------------------------------------------
# training: the loss of a batch of rows
# ---------------------------------------------------------------------------

def forward(lw: list, top: dict, z: Sizes, tokens, prec: str = "f32"):
    """Logits (b, S, V) of rows ``tokens`` (b, S), each from position 0."""
    b, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(b, S)
    x = embed(top, z, tokens, pos)
    for w in lw:
        x = x + ssm_mixer(w, z, rmsnorm(x, w["norm1.scale"], z.eps), prec)
    x = rmsnorm(x, top["final_norm"], z.eps)
    return mm(x, top["unembed"], prec)


def train_loss(lw: list, top: dict, z: Sizes, tokens, labels, prec: str,
               z_loss: float, n_total: int):
    """The sum over ``tokens`` (b, S) of next-token cross-entropy and
    ``z_loss`` times the squared log-normaliser, over ``n_total`` (the
    whole batch's labelled tokens): a row block's share of the batch's
    loss."""
    logits = forward(lw, top, z, tokens, prec)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return ((logz - gold).sum() + z_loss * logz.square().sum()) / n_total
