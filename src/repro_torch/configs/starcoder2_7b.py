"""starcoder2-7b — 32L d4608 36H (GQA kv=4) d_ff=18432 vocab=49152,
RoPE.  [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    rope_theta=100000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=257, head_dim=16,
        param_dtype="float32", compute_dtype="float32", remat=False,
    )
