"""Model configuration schema for the architecture zoo.

One frozen dataclass covers all 10 assigned families (dense GQA, MoE,
MLA+MoE, SSM, RG-LRU hybrid, VLM cross-attn, audio enc-dec).  Exact
assigned configs live in sibling modules; every arch also provides a
``smoke()`` reduction for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: Optional[int] = None      # per-expert hidden dim (routed)
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ---
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    local_window: int = 0               # 0 = full causal

    # --- SSM (mamba2 SSD) ---
    attention_free: bool = False
    ssm_state: int = 0                  # N
    ssm_head_dim: int = 64              # P
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_kernel: int = 4

    # --- hybrid (recurrentgemma) ---
    rglru: bool = False
    block_pattern: Tuple[str, ...] = () # e.g. ("rec", "rec", "local")
    rglru_width: int = 0                # lru width (defaults d_model)

    # --- VLM ---
    cross_attn_every: int = 0           # cross-attn layer every N layers
    vision_tokens: int = 0

    # --- enc-dec (whisper) ---
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500             # whisper 30 s of frames

    # --- numerics / system ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    # --------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attention_free:  # mamba2
            d_in = self.ssm_expand * d
            n_heads_ssm = d_in // self.ssm_head_dim
            per_layer += d * (2 * d_in + 2 * self.ssm_state + n_heads_ssm)
            per_layer += self.conv_kernel * (d_in + 2 * self.ssm_state)
            per_layer += d_in * d + 2 * d  # out proj + norms
        else:
            if self.mla:
                q_in = self.q_lora_rank or d
                per_layer += d * self.q_lora_rank if self.q_lora_rank else 0
                per_layer += q_in * n_q * (self.nope_head_dim + self.rope_head_dim)
                per_layer += d * (self.kv_lora_rank + self.rope_head_dim)
                per_layer += self.kv_lora_rank * n_q * (
                    self.nope_head_dim + self.v_head_dim
                )
                per_layer += n_q * self.v_head_dim * d
            else:
                per_layer += d * hd * (n_q + 2 * n_kv) + n_q * hd * d
            if self.moe:
                ff = self.moe_d_ff or self.d_ff
                per_layer += d * self.n_experts  # router
                per_layer += self.n_experts * 3 * d * ff
                per_layer += self.n_shared_experts * 3 * d * self.d_ff
            else:
                per_layer += 3 * d * self.d_ff  # swiglu
            per_layer += 2 * d  # norms
        total = emb + self.n_layers * per_layer
        if self.encoder_decoder:
            enc_layer = d * hd * (n_q + 2 * n_kv) + n_q * hd * d + 3 * d * self.d_ff
            total += self.n_encoder_layers * enc_layer
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        ff = self.moe_d_ff or self.d_ff
        routed_all = self.n_layers * self.n_experts * 3 * self.d_model * ff
        routed_active = (
            self.n_layers * self.experts_per_token * 3 * self.d_model * ff
        )
        return full - routed_all + routed_active
