"""whisper-tiny — enc-dec, 4L+4L d384 6H d_ff=1536 vocab=51865,
conv frontend STUB (precomputed frame embeddings, 1500 frames/30 s).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq=1500,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=257, head_dim=16,
        encoder_decoder=True, n_encoder_layers=2, encoder_seq=12,
        param_dtype="float32", compute_dtype="float32", remat=False,
    )
