"""(bytes, FLOPs) of one training step's pair of calls, forward and
backward, of the port's causal conv kernels (the Mamba mixer's depthwise
conv with its bias and SiLU), frozen here so that the benchmark's
yardstick stays as it is when the program changes.  Each activation is
counted read or written once: x and y forward; dy, x and dx backward;
the K taps and the bias in, and their gradients out."""
from __future__ import annotations


def conv_cost(B: int, S: int, C: int, K: int, item: int) -> tuple[int, int]:
    """A forward and a backward call at (B, S, C) activations of ``item``
    bytes and K taps: 5 B S C + 3 K C + 2 C elements moved; 2 K FLOPs an
    element forward (a product and a sum a tap), 4 K backward (dx's and
    dw's)."""
    nbytes = (5 * B * S * C + 3 * K * C + 2 * C) * item
    return nbytes, 6 * K * B * S * C
