"""whisper-medium [audio] — enc-dec, 24L decoder (+24L encoder)
d_model=1024 16H (kv=16) d_ff=4096 vocab=51865. [arXiv:2212.04356]

Conv frontend is a STUB per the assignment: input_specs provides 1500
precomputed frame embeddings (batch, 1500, d_model).  Whisper flavor:
LayerNorm, GELU non-gated MLP, absolute sinusoidal positions (no RoPE),
QKV bias, tied embeddings, decoder cross-attends to the encoder output.
"""
from repro_torch.models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=51_865,
    rope=False,
    qkv_bias=True,
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    tie_embeddings=True,
    max_seq_len=32_768,
)
