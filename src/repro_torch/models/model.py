"""Model zoo dispatch, and weights carried in from flat named arrays.

``build_model(cfg, device="cuda")`` returns the family implementation on
``device`` (a card that is not there raises; ``device="cpu"`` for the
tests): the dense and MoE families (the MoE family's DeepSeek-V2-Lite
with MLA attention) run ``DecoderLM``, the hybrid family (Griffin /
RecurrentGemma: RG-LRU and local attention) ``GriffinLM``, the SSM
family (Mamba-2's SSD) ``Mamba2LM``, the audio family (Whisper's
encoder–decoder) ``EncDecLM`` and the vision family (Llama-3.2-Vision's
gated cross-attention) ``VisionLM``.
``SHAPES`` is the reference's grid of input shapes, ``shape_applicable``
its skip rule and ``input_specs(cfg, shape)`` the stand-ins for every
input of an (arch × shape) cell: ``meta`` tensors (shapes and dtypes, no
storage), the dry-run's contract.  Tokens and labels are int64, as the
port's data pipeline makes them (the reference's are int32); the cache's
``len`` is an int32 scalar, the context embeddings are bf16.
``load_flat`` / ``from_jax_flat`` fill a model from
``flatten_tree(params)`` of the JAX package, or from a merged snapshot
of such a tree (the same names): numpy arrays, bf16 as the store's
``uint16`` words.  ``train_state_from_flat`` does the same for a
training state: the JAX package's ``flatten_tree(TrainState)`` (params,
optimizer moments and step, error feedback) becomes the port's
``TrainState`` over the model's parameters; the port's ``flatten_tree``
of that state gives the same names back.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.griffin_model import GriffinLM
from repro_torch.models.mamba_model import Mamba2LM
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.vlm import VisionLM
from repro_torch.store.checkpoint import copy_into, pick, to_tensor
from repro_torch.train.grad_compress import init_error_feedback
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_state import TrainState, model_params

#: assigned input-shape grid (LM shapes: seq_len × global_batch)
SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

#: families with sub-quadratic sequence mixing (run long_500k)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")

_FAMILIES = {"dense": DecoderLM, "moe": DecoderLM, "hybrid": GriffinLM,
             "ssm": Mamba2LM, "audio": EncDecLM, "vlm": VisionLM}


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family](cfg, device=device, generator=generator)


def shape_applicable(cfg: ModelConfig, shape: str) -> Optional[str]:
    """None if runnable; otherwise the skip reason (recorded in tables)."""
    if shape == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return "skip(full-attn): quadratic attention at 524k context"
    return None


def input_specs(cfg: ModelConfig, shape: str,
                batch_override: Optional[int] = None) -> Dict[str, Any]:
    """``meta`` tensors for the inputs of the step of (cfg × shape)."""
    sh = SHAPES[shape]
    b = batch_override or sh["batch"]
    s = sh["seq"]

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    ctx = {"vlm": ("vision", "vision_embeds", (b, cfg.vision_tokens)),
           "audio": ("audio_embeds", "audio_embeds", (b, cfg.encoder_seq))}
    if sh["kind"] in ("train", "prefill"):
        out: Dict[str, Any] = {"tokens": meta((b, s), torch.int64)}
        if sh["kind"] == "train":
            out["labels"] = meta((b, s), torch.int64)
        if cfg.family in ctx:
            prefill_key, train_key, lead = ctx[cfg.family]
            key = train_key if sh["kind"] == "train" else prefill_key
            out[key] = meta(lead + (cfg.d_model,), torch.bfloat16)
        return {"batch": out} if sh["kind"] == "train" else out

    # decode: one new token against a cache of size seq
    model = build_model(cfg, device="meta")
    return {
        "tokens": meta((b, 1), torch.int64),
        "cache": {name: meta(shp, dt) for name, (shp, dt)
                  in model.cache_specs(b, s).items()},
    }


@torch.no_grad()
def load_flat(model: torch.nn.Module,
              flat: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy ``flat`` into ``model``'s parameters by their ``/``-joined
    names (missing names and wrong shapes raise; extra names are
    ignored); values are cast to each parameter's dtype and device."""
    for name, param in model.state_dict(keep_vars=True).items():
        arr = pick(flat, name.replace(".", "/"), param.shape)
        param.copy_(to_tensor(arr).to(param.dtype))
    return model


def from_jax_flat(cfg: ModelConfig, flat: Mapping[str, np.ndarray],
                  device="cuda") -> torch.nn.Module:
    """``build_model(cfg, device)`` filled from a JAX-layout flat dict."""
    return load_flat(build_model(cfg, device=device), flat)


def train_state_from_flat(model: torch.nn.Module,
                          flat: Mapping[str, np.ndarray],
                          grad_compression: bool = False) -> TrainState:
    """A ``TrainState`` over ``model``'s parameters, filled from a flat
    train state (``params/...``, ``opt/m/...``, ``opt/v/...``,
    ``opt/step``, and ``ef/...`` with ``grad_compression``)."""
    params = model_params(model)
    ef = init_error_feedback(params) if grad_compression else None
    return copy_into(TrainState(params, init_opt_state(params), ef), flat)
