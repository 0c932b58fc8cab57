"""Architecture registry: ``--arch <id>`` resolution and reduced smoke
configs.

The port of the JAX package's registry without its ShapeDtypeStruct
input specs, which only the dry-run reads (the dry-run is not ported
yet).  ``get_config`` gives the published widths; ``reduced_config``
the tiny same-family version the CPU tests run.
"""
from __future__ import annotations

import dataclasses
import importlib

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


def all_cells():
    """Yield (arch, cell, runs, skip_reason) for all 40 assigned cells."""
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for cell in SHAPES.values():
            runs, reason = applicable(cfg, cell)
            yield arch, cell, runs, reason


__all__ = [
    "ARCH_NAMES", "SHAPES", "ShapeCell", "get_config", "reduced_config",
    "all_cells", "applicable",
]
