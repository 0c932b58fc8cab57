from repro_torch.kernels.causal_conv.ops import causal_conv_silu  # noqa: F401
