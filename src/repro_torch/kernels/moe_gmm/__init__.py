from repro_torch.kernels.moe_gmm.ops import gmm  # noqa: F401
