"""Model zoo (dense GQA family ported): layers, attention, DecoderLM."""
from repro_torch.models.model import build_model, from_jax_flat, load_flat

__all__ = ["build_model", "from_jax_flat", "load_flat"]
