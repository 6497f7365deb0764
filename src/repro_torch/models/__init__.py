"""Model zoo, every family of the configs: layers, attention, MoE, RG-LRU,
SSD; DecoderLM, GriffinLM, Mamba2LM, EncDecLM, VisionLM."""
from repro_torch.models.model import (
    SHAPES,
    build_model,
    from_jax_flat,
    input_specs,
    load_flat,
    shape_applicable,
)

__all__ = ["SHAPES", "build_model", "from_jax_flat", "input_specs",
           "load_flat", "shape_applicable"]
