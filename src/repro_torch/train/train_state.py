"""Train state + train / eval step builders — the JAX package's
``train/train_state.py`` in torch.

``TrainState.params`` is the model's own parameters by flat name
(``attn/wq``, ``embed/embedding``, ...: the names ``flatten_tree`` gives
and the JAX package uses), so the step updates the model in place and
``flatten_tree(state)`` names every tensor as the reference's
``flatten_tree(TrainState)`` does: ``params/<...>``, ``opt/m/<...>``,
``opt/v/<...>``, ``opt/step`` and, with compression, ``ef/<...>``.
There is no ``jit``: a step runs eagerly.  Under a device mesh the
parameters, their moments and the batch are DTensors (the moments
placed as their parameters), and the step's metrics come back whole.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.train import grad_compress
from repro_torch.train.optimizer import (
    AdamWConfig,
    OptState,
    adamw_update,
    init_opt_state,
)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (a collective: every rank calls it); a
    plain tensor itself."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt: OptState
    ef: Optional[Dict[str, torch.Tensor]] = None  # error feedback


def model_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters by flat name, in sorted order."""
    named = {n.replace(".", "/"): p for n, p in model.named_parameters()}
    return {n: named[n] for n in sorted(named)}


def init_train_state(
    model, generator: Optional[torch.Generator] = None,
    grad_compression: bool = False,
) -> TrainState:
    """Redraw the model's parameters from ``generator`` (in place) and
    start the optimizer (and error-feedback) state at zero."""
    model.init(generator)
    params = model_params(model)
    ef = grad_compress.init_error_feedback(params) if grad_compression else None
    return TrainState(params=params, opt=init_opt_state(params), ef=ef)


def make_train_step(
    model, opt_cfg: AdamWConfig, grad_compression: bool = False
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Returns train_step(state, batch) -> (state, metrics): the loss and
    its gradients by ``loss.backward()``, compression if asked, AdamW in
    place, grads cleared.  ``state.params`` must be ``model``'s own
    parameters (as :func:`init_train_state` and the checkpoint loader
    leave them)."""
    own = model_params(model)

    def train_step(state: TrainState, batch: Dict):
        if state.params.keys() != own.keys() or any(
                state.params[n] is not p for n, p in own.items()):
            raise ValueError("train_step: state.params are not the model's "
                             "parameters")
        loss = model.loss_fn(batch)
        loss.backward()
        grads = {n: p.grad for n, p in own.items()}
        ef = state.ef
        if grad_compression:
            grads, ef = grad_compress.compress_decompress(grads, ef)
        _, opt, om = adamw_update(opt_cfg, state.params, grads, state.opt)
        for p in own.values():
            p.grad = None
        metrics = {"loss": loss.detach(), **om}
        return TrainState(state.params, opt, ef), {
            k: whole(v) for k, v in metrics.items()}

    return train_step


def make_eval_step(model) -> Callable[[Dict], torch.Tensor]:
    @torch.no_grad()
    def eval_step(batch: Dict) -> torch.Tensor:
        return model.loss_fn(batch)

    return eval_step
