"""The assigned input-shape cells and their applicability rules.

LM transformer shapes (seq_len × global_batch):
  train_4k     4,096 × 256   training        -> lowers train_step
  prefill_32k  32,768 × 32   inference       -> lowers prefill
  decode_32k   32,768 × 128  inference       -> lowers serve_step (1 token,
                                               KV cache of seq_len)
  long_500k    524,288 × 1   long-context    -> serve_step; SUB-QUADRATIC
                                               archs only (skip + note in
                                               DESIGN.md for the rest)
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str              # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """(runs?, reason-if-skipped). Encoder-only archs would skip decode
    cells, but none are assigned (whisper is enc-dec and decodes)."""
    if cell.name == "long_500k" and not cfg.is_subquadratic():
        return False, (
            f"{cfg.name}: pure full-attention arch — 500k-token decode is "
            "quadratic-cost/unbounded-KV; skipped per assignment"
        )
    if cell.name == "long_500k" and cfg.encoder is not None:
        return False, (
            f"{cfg.name}: enc-dec decoder context (448 tokens for whisper) "
            "is far below 500k; skipped per assignment"
        )
    return True, ""
