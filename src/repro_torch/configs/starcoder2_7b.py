"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, RoPE. [arXiv:2402.19173; hf]

StarCoder2 flavor: LayerNorm (with bias), non-gated GELU MLP, QKV bias.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_head=128,
    d_ff=18_432,
    vocab_size=49_152,
    rope=True,
    rope_theta=100_000.0,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    max_seq_len=32_768,
)
