"""Deterministic synthetic token pipeline: the port of the JAX package's
``data/pipeline.py``.

Batch `i` is a pure function of (seed, i), so a worker that restarts
from a checkpointed step counter regenerates exactly the same batch
stream.  The "text" mixes Zipf-ish unigram draws with short repeated
motifs, so the loss curve has learnable structure.

The batches are numpy arrays made by numpy's generators:
``SyntheticTokenPipeline`` (its fields, ``__post_init__`` and
``batch_at``) and `stub_modality_inputs` are the reference's code letter
for letter, so both packages draw the same arrays from the same seeds
(tests/test_torch_train.py and tests/test_torch_copies.py hold them to
it).  `torch_batch_at` takes the place of ``jax_batch_at`` and puts a
batch on one device.  Under a mesh every rank draws the same global batch
from the seed and takes its own rows (`models.model.loss_fn`), so the
global batch is bit-equal to one device's; `make_batch_specs` is the
reference's spec tree for it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import batch_spec


@dataclasses.dataclass
class SyntheticTokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # fixed motif bank (shared across batches; part of the "dataset")
        self.motifs = rng.integers(
            0, self.vocab_size, size=(self.n_motifs, self.motif_len),
            dtype=np.int64,
        )
        # Zipf-ish unigram distribution over a capped head of the vocab
        head = min(self.vocab_size, 4096)
        w = 1.0 / np.arange(1, head + 1)
        self.head = head
        self.unigram = w / w.sum()

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Batch for global step `step` (pure function of seed+step)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )
        B, S = self.global_batch, self.seq_len
        toks = rng.choice(self.head, size=(B, S + 1), p=self.unigram)
        # overwrite random spans with motifs (learnable repetition)
        n_spans = max(1, S // (4 * self.motif_len))
        for b in range(B):
            for _ in range(n_spans):
                m = rng.integers(0, self.n_motifs)
                start = rng.integers(0, max(S + 1 - self.motif_len, 1))
                toks[b, start:start + self.motif_len] = self.motifs[m]
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def torch_batch_at(self, step: int,
                       device: str | torch.device | None = None
                       ) -> dict[str, torch.Tensor]:
        """`batch_at` as int32 tensors on ``device`` (cuda unless the
        caller asks for the CPU: `models.model.resolve_device`)."""
        from repro_torch.models.model import resolve_device

        dev = resolve_device(device)
        return {k: torch.from_numpy(v).to(dev)
                for k, v in self.batch_at(step).items()}


def make_batch_specs(cfg: ModelConfig, mesh):
    """PartitionSpec tree for a training batch of this model family."""
    specs = {
        "tokens": batch_spec(mesh, None),
        "labels": batch_spec(mesh, None),
    }
    if cfg.encoder is not None:
        specs["frames"] = batch_spec(mesh, None, None)
    if cfg.frontend is not None:
        specs["patches"] = batch_spec(mesh, None, None)
    return specs


def stub_modality_inputs(cfg: ModelConfig, batch: int, rng_seed: int = 0):
    """Precomputed frame/patch embeddings for audio/VLM archs (the modality
    frontend is a stub per the assignment: input_specs provides these)."""
    rng = np.random.default_rng(rng_seed)
    out = {}
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder.n_frames, cfg.d_model)
        ).astype(np.float32)
    if cfg.frontend is not None:
        out["patches"] = rng.standard_normal(
            (batch, cfg.frontend.n_prefix, cfg.frontend.d_input)
        ).astype(np.float32)
    return out


__all__ = ["SyntheticTokenPipeline", "stub_modality_inputs"]
