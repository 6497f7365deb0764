"""llama-3.2-vision-90b — 100L d8192 64H (GQA kv=8) d_ff=28672
vocab=128256, gated cross-attn image layers every 5th layer; vision
frontend STUB (precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    cross_attn_every=5,
    vision_tokens=1024,
    rope_theta=500000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke", family="vlm", n_layers=4,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=257,
        head_dim=16, cross_attn_every=2, vision_tokens=8,
        param_dtype="float32", compute_dtype="float32", remat=False,
    )
