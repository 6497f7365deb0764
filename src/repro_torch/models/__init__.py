"""Model zoo (dense GQA and MoE / MLA families ported): layers,
attention, MoE, DecoderLM."""
from repro_torch.models.model import build_model, from_jax_flat, load_flat

__all__ = ["build_model", "from_jax_flat", "load_flat"]
