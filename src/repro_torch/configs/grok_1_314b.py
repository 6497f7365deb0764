"""grok-1-314b — 64L d6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    moe=True,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=32768,
    rope_theta=10000.0,
)


def smoke() -> ModelConfig:
    """Reduced same-family config: small width, few experts, tiny vocab."""
    return ModelConfig(
        name="grok-1-314b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=257,
        head_dim=16,
        moe=True,
        n_experts=4,
        experts_per_token=2,
        moe_d_ff=128,
        capacity_factor=2.0,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
