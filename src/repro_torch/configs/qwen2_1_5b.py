"""qwen2-1.5b — 28L d1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
QKV bias.  [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=257, head_dim=16,
        qkv_bias=True, param_dtype="float32", compute_dtype="float32",
        remat=False,
    )
