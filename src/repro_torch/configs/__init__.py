"""Architecture registry: ``--arch <id>`` resolution, reduced smoke
configs, and the dry-run's input specs.

The port of the JAX package's registry.  ``get_config`` gives the
published widths; ``reduced_config`` the tiny same-family version the
CPU tests run.  The input specs (the reference's ShapeDtypeStructs) are
tensors on the "meta" device: shapes and dtypes, nothing allocated, so
FULL configs are only ever touched abstractly (`launch.dryrun` makes
fake tensors of them).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable
from repro_torch.models.config import (
    EncoderConfig, FrontendConfig, ModelConfig, MoEConfig, SSMConfig,
)

_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "whisper-medium": "whisper_medium",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen2-1.5b": "qwen2_1_5b",
    "starcoder2-7b": "starcoder2_7b",
    "granite-8b": "granite_8b",
    "qwen3-32b": "qwen3_32b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "mamba2-1.3b": "mamba2_1_3b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def reduced_config(name: str, *, n_layers: int | None = None) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: same layer pattern /
    attention flavor / MoE+SSM structure, small widths."""
    cfg = get_config(name)
    period = cfg.period
    layers = n_layers or max(period, 2)
    if layers % period:
        layers = period * max(1, layers // period)
    d_model = 64
    changes: dict = dict(
        n_layers=layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=0 if cfg.family == "ssm" else 128,
        vocab_size=512,
        max_seq_len=512,
        attn_window=16 if cfg.attn_window is not None else None,
        param_dtype="float32",
        activation_dtype="float32",
    )
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(
            n_experts=4,
            top_k=cfg.moe.top_k,
            d_ff_expert=128,
            every=cfg.moe.every,
            n_shared_experts=cfg.moe.n_shared_experts,
            capacity_factor=2.0,
        )
    if cfg.ssm is not None:
        changes["ssm"] = SSMConfig(
            d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32,
            ngroups=cfg.ssm.ngroups,
        )
    if cfg.encoder is not None:
        changes["encoder"] = EncoderConfig(n_layers=2, n_frames=24)
    if cfg.frontend is not None:
        changes["frontend"] = FrontendConfig(n_prefix=8, d_input=32)
    return dataclasses.replace(cfg, **changes)


# ---------------------------------------------------------------------------
# Input specs (meta tensors, never allocate) for every (arch × shape)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """VLM cells reserve the patch prefix inside the assigned seq_len."""
    if cfg.frontend is not None:
        return max(seq_len - cfg.frontend.n_prefix, 1)
    return seq_len


def train_input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    B, S = cell.global_batch, cell.seq_len
    St = _text_len(cfg, S)
    specs = {
        "tokens": _spec((B, St), torch.int32),
        "labels": _spec((B, St), torch.int32),
    }
    if cfg.encoder is not None:
        specs["frames"] = _spec((B, cfg.encoder.n_frames, cfg.d_model),
                                torch.float32)
    if cfg.frontend is not None:
        specs["patches"] = _spec(
            (B, cfg.frontend.n_prefix, cfg.frontend.d_input), torch.float32)
    return specs


def prefill_input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    specs = train_input_specs(cfg, cell)
    specs.pop("labels")
    return specs


def decode_input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """serve_step inputs: one new token against a seq_len cache."""
    from repro_torch.models import model as model_lib

    B, S = cell.global_batch, cell.seq_len
    return {
        "tokens_t": _spec((B, 1), torch.int32),
        "cache": model_lib.init_cache(cfg, B, S, device="meta"),
        "lengths": _spec((B,), torch.int32),
    }


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    if cell.kind == "train":
        return train_input_specs(cfg, cell)
    if cell.kind == "prefill":
        return prefill_input_specs(cfg, cell)
    if cell.kind == "decode":
        return decode_input_specs(cfg, cell)
    raise ValueError(cell.kind)


def all_cells():
    """Yield (arch, cell, runs, skip_reason) for all 40 assigned cells."""
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for cell in SHAPES.values():
            runs, reason = applicable(cfg, cell)
            yield arch, cell, runs, reason


__all__ = [
    "ARCH_NAMES", "SHAPES", "ShapeCell", "get_config", "reduced_config",
    "input_specs", "train_input_specs", "prefill_input_specs",
    "decode_input_specs", "all_cells", "applicable",
]
