"""deepseek-v2-lite-16b — 27L d2048 16H d_ff(expert)=1408 vocab=102400,
MLA kv_lora=512, MoE top-6 with 2 shared experts.  [arXiv:2405.04434; hf]

Assignment-sheet note: the assignment line reads "MoE 64e top-6" in the
structured field and "160 routed" in the free-text tail; the published
DeepSeek-V2-Lite has 64 routed experts (top-6) + 2 shared with per-expert
hidden 1408 — we follow the structured field (64), matching the paper.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=True,
    n_experts=64,
    experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    mla=True,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    rope_theta=10000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab_size=257,
        moe=True,
        n_experts=8,
        experts_per_token=2,
        n_shared_experts=1,
        moe_d_ff=32,
        capacity_factor=2.0,
        mla=True,
        kv_lora_rank=16,
        rope_head_dim=8,
        nope_head_dim=16,
        v_head_dim=16,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
