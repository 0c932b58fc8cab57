"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave. [arXiv:2403.19887]

Period-8 block: layers 0..6 are Mamba mixers, layer 7 is attention; MoE
replaces the dense FFN on every other layer (every=2).  Hardware
adaptation (DESIGN.md): Jamba's Mamba-1 layers are implemented with the
Mamba-2 SSD formulation (chunked-MXU-friendly); state geometry follows the
SSD paper rather than Jamba's d_state=16.
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14_336,
    vocab_size=65_536,
    rope=False,                 # jamba uses no positional encoding
    attn_every=8,               # 1:7 attn:mamba interleave
    moe=MoEConfig(
        n_experts=16,
        top_k=2,
        d_ff_expert=14_336,
        every=2,
        capacity_factor=1.25,
    ),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    max_seq_len=524_288,
)
