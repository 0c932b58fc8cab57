"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Scout: MoE on every layer (16 experts + 1 shared), same iRoPE/chunked
attention backbone as Maverick.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=202_048,
    rope=True,
    rope_theta=500_000.0,
    attn_window=8_192,
    global_attn_every=4,
    moe=MoEConfig(
        n_experts=16,
        top_k=1,
        d_ff_expert=8_192,
        every=1,                # MoE every layer (Scout)
        n_shared_experts=1,
        capacity_factor=1.25,
    ),
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    max_seq_len=524_288,
)
