from repro_torch.kernels.ssd.ops import ssd, ssd_chunked, ssd_decode_step  # noqa: F401
