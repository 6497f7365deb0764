"""Model zoo (dense GQA, MoE / MLA and hybrid Griffin families ported):
layers, attention, MoE, RG-LRU, DecoderLM, GriffinLM."""
from repro_torch.models.model import build_model, from_jax_flat, load_flat

__all__ = ["build_model", "from_jax_flat", "load_flat"]
