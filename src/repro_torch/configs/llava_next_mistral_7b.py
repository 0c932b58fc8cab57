"""llava-next-mistral-7b [vlm] — mistral-7b backbone: 32L d_model=4096
32H (GQA kv=8) d_ff=14336 vocab=32000; anyres tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The modality frontend is a STUB per the assignment: input_specs provides
precomputed CLIP-L patch embeddings (batch, 576, 1024) — the base-res
24×24 anyres grid — and a learned projector maps them into the token
sequence (model.py prepends them; loss applies to text positions only).
"""
from repro_torch.models.config import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14_336,
    vocab_size=32_000,
    rope=True,
    rope_theta=10_000.0,
    frontend=FrontendConfig(n_prefix=576, d_input=1024),
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    max_seq_len=32_768,
)
