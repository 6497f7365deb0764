"""recurrentgemma-9b — 38L d4096 16H (MQA kv=1) d_ff=12288 vocab=256000,
RG-LRU + local attention, 1:2 pattern, window 2048.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    rglru=True,
    block_pattern=("rec", "rec", "local"),
    local_window=2048,
    rglru_width=4096,
    conv_kernel=4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke", family="hybrid", n_layers=5,
        d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=257,
        head_dim=16, rglru=True, block_pattern=("rec", "rec", "local"),
        local_window=8, rglru_width=64, conv_kernel=4,
        param_dtype="float32", compute_dtype="float32", remat=False,
    )
