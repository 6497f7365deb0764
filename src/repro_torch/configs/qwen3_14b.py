"""qwen3-14b — 40L d5120 40H (GQA kv=8) d_ff=17408 vocab=151936,
qk_norm.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=257, head_dim=16,
        qk_norm=True, param_dtype="float32", compute_dtype="float32",
        remat=False,
    )
