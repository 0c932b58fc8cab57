"""Model configuration dataclasses + per-layer structure resolution.

A single ``ModelConfig`` covers all assigned families:
  dense       — llama-style decoder (qwen2, starcoder2, granite, qwen3)
  moe         — MoE decoder (llama4 maverick/scout)
  ssm         — attention-free Mamba2 / SSD stack (mamba2-1.3b)
  hybrid      — attn:ssm interleave with MoE (jamba)
  encdec      — encoder-decoder (whisper; conv frontend stubbed)
  vlm         — decoder with a vision-embedding prefix stub (llava-next)

The layer pattern is expressed as a *period*: layer i's mixer/ffn kind is a
pure function of ``i % period``, so stacks scan over ``n_layers // period``
steps of ``period`` sublayers with stackable parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

MixerKind = Literal["attn", "ssm"]
FfnKind = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int                 # per-expert hidden size
    every: int = 1                   # MoE on layers where i % every == every-1
    n_shared_experts: int = 0        # always-on shared expert(s)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256                 # SSD chunk length
    ngroups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack of an enc-dec model (whisper). Frontend is stubbed:
    inputs arrive as precomputed frame embeddings of shape
    (batch, n_frames, d_model)."""
    n_layers: int
    n_frames: int                    # e.g. 1500 for whisper 30s windows


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: `input_specs` provides precomputed patch/frame
    embeddings (batch, n_prefix, d_input); a learned projector maps them to
    d_model and they are prepended to the token sequence."""
    n_prefix: int                    # e.g. 576 anyres patches
    d_input: int                     # e.g. 1024 (CLIP-L) for llava


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # attention flavor
    rope: bool = True
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_window: int | None = None        # local/chunked attention width
    global_attn_every: int | None = None  # every k-th layer is global (llama4)
    attn_logit_softcap: float | None = None

    # layer-pattern knobs
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    attn_every: int | None = None         # hybrid: i % attn_every == attn_every-1

    # enc-dec / frontends
    encoder: EncoderConfig | None = None
    frontend: FrontendConfig | None = None

    # misc
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    act: str = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = False
    max_seq_len: int = 8192

    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    # optimizer state dtype policy (consumed by train/optimizer.py)
    optimizer_state_dtype: str = "float32"

    # ------------------------------------------------------------------
    # layer pattern
    # ------------------------------------------------------------------
    @property
    def period(self) -> int:
        p = 1
        if self.attn_every:
            p = math.lcm(p, self.attn_every)
        if self.moe is not None and self.moe.every > 1:
            p = math.lcm(p, self.moe.every)
        if self.global_attn_every:
            p = math.lcm(p, self.global_attn_every)
        if self.n_layers % p != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by period={p}"
            )
        return p

    def mixer_kind(self, i: int) -> MixerKind:
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            assert self.attn_every is not None
            return "attn" if i % self.attn_every == self.attn_every - 1 else "ssm"
        return "attn"

    def ffn_kind(self, i: int) -> FfnKind:
        if self.family == "ssm":
            return "none"  # mamba2 blocks have no separate FFN
        if self.moe is not None and i % self.moe.every == self.moe.every - 1:
            return "moe"
        return "dense"

    def layer_uses_global_attn(self, i: int) -> bool:
        """Llama4-style: chunked attention except every k-th layer (global,
        NoPE). When global_attn_every is unset, a layer is global iff no
        window is configured."""
        if self.attn_window is None:
            return True
        if self.global_attn_every is None:
            return False
        return i % self.global_attn_every == self.global_attn_every - 1

    def layer_uses_rope(self, i: int) -> bool:
        """Llama4 iRoPE: global-attention layers are NoPE."""
        if not self.rope:
            return False
        if self.global_attn_every and self.layer_uses_global_attn(i):
            return False
        return True

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------
    @property
    def n_scan(self) -> int:
        return self.n_layers // self.period

    def kv_cache_len(self, i: int, seq_len: int) -> int:
        """Per-layer KV length: windowed layers only keep the window."""
        if self.mixer_kind(i) != "attn":
            return 0
        if self.attn_window is not None and not self.layer_uses_global_attn(i):
            return min(self.attn_window, seq_len)
        return seq_len

    def is_subquadratic(self) -> bool:
        """Can this arch run the long_500k decode cell? SSM/hybrid always;
        attention archs only if all-global layers are bounded by a window or
        the global layers are a strict subset (llama4 chunked+global)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_window is not None

    def param_count_estimate(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for i in range(self.n_layers):
            mixer = self.mixer_kind(i)
            if mixer == "attn":
                q = d * self.n_heads * self.d_head
                kv = 2 * d * self.n_kv_heads * self.d_head
                o = self.n_heads * self.d_head * d
                total += q + kv + o
            else:
                assert self.ssm is not None
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                # in_proj -> [z, x, B, C, dt]; out_proj
                total += d * (2 * di + 2 * s.ngroups * s.d_state + nh)
                total += di * d
                total += s.d_conv * (di + 2 * s.ngroups * s.d_state)
            ffn = self.ffn_kind(i)
            if ffn == "dense":
                total += d * dff * (3 if self.gated_mlp else 2)
            elif ffn == "moe":
                m = self.moe
                per_exp = d * m.d_ff_expert * (3 if self.gated_mlp else 2)
                total += m.n_experts * per_exp + m.n_shared_experts * per_exp
                total += d * m.n_experts  # router
        if self.encoder is not None:
            # encoder layers: attn + dense ffn (+ cross-attn lives in decoder count above? no:)
            for _ in range(self.encoder.n_layers):
                total += 4 * d * self.n_heads * self.d_head  # self-attn
                total += d * dff * (3 if self.gated_mlp else 2)
            # decoder cross-attention (one per decoder layer)
            total += self.n_layers * 4 * d * self.n_heads * self.d_head
        if self.frontend is not None:
            total += self.frontend.d_input * d  # projector
        return total

    def active_param_count_estimate(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count_estimate()
        m = self.moe
        total = self.param_count_estimate()
        per_exp = self.d_model * m.d_ff_expert * (3 if self.gated_mlp else 2)
        n_moe_layers = sum(
            1 for i in range(self.n_layers) if self.ffn_kind(i) == "moe"
        )
        inactive = n_moe_layers * (m.n_experts - m.top_k) * per_exp
        return total - inactive
