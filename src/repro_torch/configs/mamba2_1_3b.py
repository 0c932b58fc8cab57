"""mamba2-1.3b [ssm] — 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060; unverified]

Pure Mamba-2 stack: each block is in_proj -> causal conv -> SSD scan ->
gated RMS norm -> out_proj, no separate FFN.  n_heads/d_head below are the
(unused) attention fields; the SSM geometry is d_inner = 2*2048 = 4096,
64 heads of head_dim 64, d_state 128.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab_size=50_280,
    rope=False,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256,
                  ngroups=1),
    norm="rmsnorm",
    act="silu",
    gated_mlp=False,
    tie_embeddings=True,
    max_seq_len=524_288,
)
