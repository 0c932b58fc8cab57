"""The plain version of the Mamba mixer's causal depthwise conv and its
SiLU: the model's own code before the kernel (`models.ssm`), which the
CPU runs and the kernel is held to on the card (the forward bit for bit)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv(xbc: torch.Tensor, w: torch.Tensor,
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


def causal_conv_silu(xbc: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """silu(`causal_conv`) in the input dtype."""
    return F.silu(causal_conv(xbc, w, b))


__all__ = ["causal_conv", "causal_conv_silu"]
