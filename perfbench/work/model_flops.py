"""Model FLOPs of a token's forward pass through an SSD stack, from a
configuration's sizes: the work the model's equations need, whatever a
kernel does on top (recomputation, the chunked scan's extra products).

Per token and layer: 2 FLOPs a weight of the input and output
projections, the causal conv (2 a tap and channel), and the SSD
recurrence (4 P N a head: the state update and the output); and 2 d V
for the token's logits.
"""
from __future__ import annotations


def token_flops(s: dict) -> float:
    """One token's forward FLOPs, its logits included."""
    if s["family"] != "ssm":
        raise ValueError(f"no model FLOPs for family {s['family']!r}")
    d, c = s["d_model"], s["ssm"]
    di = c["expand"] * d
    H = di // c["head_dim"]
    gn = c["ngroups"] * c["d_state"]
    layer = (2 * d * (2 * di + 2 * gn + H) + 2 * di * d
             + 2 * c["d_conv"] * (di + 2 * gn)
             + 4 * H * c["head_dim"] * c["d_state"])
    return s["n_layers"] * layer + 2 * d * s["vocab_size"]
