from repro_torch.kernels.waterfill.ops import (  # noqa: F401
    launch_counts, waterfill, waterfill_reference,
)
