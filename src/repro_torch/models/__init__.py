"""Model zoo, every family of the configs: layers, attention, MoE, RG-LRU,
SSD; DecoderLM, GriffinLM, Mamba2LM, EncDecLM, VisionLM."""
from repro_torch.models.model import build_model, from_jax_flat, load_flat

__all__ = ["build_model", "from_jax_flat", "load_flat"]
