"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, QKV bias, tied embeddings. [arXiv:2407.10671; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab_size=151_936,
    rope=True,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    max_seq_len=32_768,
)
