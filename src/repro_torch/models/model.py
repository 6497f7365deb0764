"""Model zoo dispatch, and weights carried in from flat named arrays.

``build_model(cfg, device="cuda")`` returns the family implementation on
``device`` (a card that is not there raises; ``device="cpu"`` for the
tests).  Only the dense family is ported; the others raise.
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

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DecoderLM
from repro_torch.store.checkpoint import copy_into, pick, to_tensor
from repro_torch.train.grad_compress import init_error_feedback
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_state import TrainState, model_params

_NOT_PORTED = ("moe", "ssm", "hybrid", "vlm", "audio")


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None) -> DecoderLM:
    if cfg.family == "dense":
        return DecoderLM(cfg, device=device, generator=generator)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet")
    raise KeyError(f"unknown family {cfg.family!r}")


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
