"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity), at the full 700 W power limit."""
BF16_FLOPS_PER_S = 989e12       # tensor cores, bfloat16 and float16
HBM_BYTES_PER_S = 3.35e12       # HBM3


def bound_s(nbytes: float, flops: float,
            flops_per_s: float = BF16_FLOPS_PER_S) -> float:
    """The least time a call that moves ``nbytes`` through HBM and does
    ``flops`` can take: the larger of its two terms."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)
