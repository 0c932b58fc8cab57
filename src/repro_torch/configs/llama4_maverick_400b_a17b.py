"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Llama4 specifics modeled: interleaved chunked attention (8k window) with
every 4th layer global + NoPE (iRoPE), MoE on alternating layers with one
shared expert, top-1 routing.  bf16 optimizer moments (the 400B total
params must fit 256 × 16 GB with state; see DESIGN.md §9).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
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
    attn_window=8_192,          # chunked attention
    global_attn_every=4,        # every 4th layer global (NoPE there: iRoPE)
    moe=MoEConfig(
        n_experts=128,
        top_k=1,
        d_ff_expert=8_192,
        every=2,                # MoE on alternating layers (Maverick)
        n_shared_experts=1,
        capacity_factor=1.25,
    ),
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    max_seq_len=524_288,
    optimizer_state_dtype="bfloat16",
)
