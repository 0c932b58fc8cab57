"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=25_600,
    vocab_size=151_936,
    rope=True,
    rope_theta=1_000_000.0,
    qk_norm=True,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    max_seq_len=40_960,
)
