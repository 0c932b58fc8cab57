"""The dry-run's hook into the kernel wrappers.

`launch.dryrun` counts what a step does on fake tensors, with no card.
While it records, ``recorder`` holds its recorder, and each kernel
wrapper of the port -- `flash_attention`, `flash_attention_forward`,
`flash_attention_backward`, `ssd`, `ssd_forward`, `ssd_backward`, `gmm`,
`gmm_backward`, `causal_conv_silu` -- hands its call to it before anything else: the
recorder notes the call as a site (its shapes, dtype and mask) and
returns outputs of the right shapes, so no kernel is built or launched
and no plain version runs.  Everywhere else ``recorder`` is None, and the
wrappers take their routes and count their launches as they always do.

The dry-run traces on fake CPU tensors (see `launch.dryrun`), so the one
branch of the model that depends on the device outside the kernels
(`models.layers.matmul_f32`) asks `card_path` which way to go.
"""
from __future__ import annotations

#: the dry-run's recorder while it records, else None
recorder = None


def card_path(t) -> bool:
    """Whether a call on ``t`` takes the card's path: ``t`` is a CUDA
    tensor, or the dry-run is recording."""
    return t.is_cuda or recorder is not None


__all__ = ["recorder", "card_path"]
