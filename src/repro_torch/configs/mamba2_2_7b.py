"""mamba2-2.7b — 64L d2560, attention-free SSD, ssm_state=128,
vocab=50280.  [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,          # attention-free; unused
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    attention_free=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    conv_kernel=4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=257,
        attention_free=True, ssm_state=16, ssm_head_dim=8, ssm_expand=2,
        ssm_chunk=8, conv_kernel=4,
        param_dtype="float32", compute_dtype="float32", remat=False,
    )
