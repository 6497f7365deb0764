"""AdamW + schedules + clipping — the JAX package's
``train/optimizer.py`` in torch.

Params, grads and the moments are name -> tensor mappings (the flat
names of ``flatten_tree``); m and v are float32 on the params' device.
:func:`adamw_update` updates params and state in place under
``torch.no_grad()`` (the reference returns new trees; in place keeps
one copy of the 16 bytes per parameter that training holds), in the
reference's float32 order: m and v, then ``mhat`` and ``vhat`` each
divided by its bias correction, then ``delta``, then ``p - lr*delta``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

Tree = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: torch.Tensor  # 0-d int32


def init_opt_state(params: Tree) -> OptState:
    def zeros():  # placed as the params are (a DTensor's moments too)
        return {n: torch.zeros_like(p, dtype=torch.float32,
                                    requires_grad=False)
                for n, p in params.items()}

    device = next(iter(params.values())).device
    return OptState(m=zeros(), v=zeros(),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio; float32 0-d."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree: Tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for g in tree.values()]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def clip_by_global_norm(grads: Tree,
                        max_norm: float) -> Tuple[Dict[str, torch.Tensor],
                                                  torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: Tree,
    grads: Tree,
    state: OptState,
) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: params, ``state.m``, ``state.v`` and
    ``state.step`` are updated in place and returned."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    state.step.add_(1)
    lr = lr_schedule(cfg, state.step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = state.step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for n, p in params.items():
        gf = grads[n].float()
        m, v = state.m[n], state.v[n]
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr}
