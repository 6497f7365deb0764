"""Shared neural building blocks: norms, SwiGLU MLP, RoPE, embedding,
loss and init helpers — the JAX package's ``models/layers.py`` in torch.

Parameters are tensors in ``nn.ParameterDict``s with the JAX layout:
layer-stacked tensors carry a leading layer axis, matrices are
(in, out) and contracted with ``einsum`` as in the reference.  Norm
weights use the ``1 + w`` convention (zeros at init).  Init draws from an
explicit ``torch.Generator``; its numbers differ from ``jax.random``'s,
so tests carry weights across instead of re-drawing them.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


# ------------------------------------------------------------------- init
def dense_init(shape: Sequence[int], generator: Optional[torch.Generator],
               device, dtype, in_axis: int = -2) -> torch.Tensor:
    """LeCun-normal on the reduction dim."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    x = torch.randn(tuple(shape), generator=generator, device=device)
    # in place: one float32 copy of the draw (DeepSeek-V2-Lite's expert
    # stacks are 20 GB each in float32)
    return x.div_(math.sqrt(fan_in)).to(dtype)


def embed_init(shape: Sequence[int], generator: Optional[torch.Generator],
               device, dtype) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator,
                       device=device).to(dtype)


def init_mlp(n_layers: int, d_model: int, d_ff: int, generator, device,
             dtype) -> dict:
    return {
        "w_gate": dense_init((n_layers, d_model, d_ff), generator, device,
                             dtype),
        "w_up": dense_init((n_layers, d_model, d_ff), generator, device, dtype),
        "w_down": dense_init((n_layers, d_ff, d_model), generator, device,
                             dtype),
    }


def init_embed(vocab: int, d_model: int, generator, device, dtype) -> dict:
    return {"embedding": embed_init((vocab, d_model), generator, device,
                                    dtype)}


# ------------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def head_rmsnorm(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMSNorm over the head_dim axis (qwen3)."""
    return rmsnorm(x, w, eps)


# -------------------------------------------------------------------- MLP
def swiglu_mlp(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D)."""
    h = F.silu(torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype)))
    h = h * torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(x.dtype))


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, n_heads, head_dim), positions (..., S); split halves."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- embed
def embed_tokens(p: Mapping[str, torch.Tensor], tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    # gather, then cast: the same values as casting the whole table first
    return p["embedding"][tokens].to(compute_dtype)


def unembed(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Tied output projection onto the embedding table."""
    return torch.einsum("bsd,vd->bsv", x, p["embedding"].to(x.dtype))


# ------------------------------------------------------------------- loss
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL; logits (B, S, V)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
