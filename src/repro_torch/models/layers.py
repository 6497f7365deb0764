"""Shared neural building blocks: norms, SwiGLU MLP, RoPE, embedding,
loss and init helpers — the JAX package's ``models/layers.py`` in torch.

Parameters are tensors in ``nn.ParameterDict``s with the JAX layout:
layer-stacked tensors carry a leading layer axis, matrices are
(in, out) and contracted with ``einsum`` as in the reference.  Norm
weights use the ``1 + w`` convention (zeros at init).  Init draws from an
explicit ``torch.Generator``; its numbers differ from ``jax.random``'s,
so tests carry weights across instead of re-drawing them.
:class:`StackedLM` is what every family's model shares (its parameters
held and redrawn from the family's tree, its device, its zero-filled
decode cache), :func:`unbind_stack` its per-layer views.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or wider where it is wider (float64: a check's
    reference precision): the reference's float32 islands (norm
    statistics, the SSD) widen bf16 and float16 and never narrow."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


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
    xf = at_least_f32(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.to(xf.dtype))).to(x.dtype)


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


# ------------------------------------------------------------ model base
def unbind_stack(tree: Mapping[str, torch.Tensor],
                 n: int) -> List[Dict[str, torch.Tensor]]:
    """``n`` dicts of views, one per entry of each tensor's leading axis,
    from one ``unbind`` a tensor: autograd stacks the entries' gradients
    once, where indexing ``v[i]`` per entry would add a full-size,
    zero-filled gradient per entry (n² traffic)."""
    parts = {k: v.unbind(0) for k, v in tree.items()}
    return [{k: t[i] for k, t in parts.items()} for i in range(n)]


class StackedLM(nn.Module):
    """What every family's model shares: its parameters are the tree
    ``self._draw(device, generator)`` returns (the reference's parameter
    tree: a dict node becomes an ``nn.ParameterDict``, a tensor an
    ``nn.Parameter``, under the tree's names, so the ``/``-joined flat
    names are the JAX ``flatten_tree`` names), redrawn in place by
    :meth:`init`; its decode cache is ``cache_specs`` zero-filled."""

    def _hold(self, tree: Dict) -> None:
        for name, node in tree.items():
            setattr(self, name, nn.ParameterDict(node) if isinstance(
                node, dict) else nn.Parameter(node))

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None):
        """Redraw every parameter from ``generator``, in place."""
        tree = self._draw(self.device, generator)
        for name, p in self.named_parameters():
            node = tree
            for part in name.split("."):
                node = node[part]
            p.copy_(node)
        return self

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    def _compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.compute_dtype)

    def init_cache(self, batch: int, max_len: int) -> Dict:
        specs = self.cache_specs(batch, max_len)
        cache = {name: torch.zeros(shape, dtype=dt, device=self.device)
                 for name, (shape, dt) in specs.items() if name != "len"}
        cache["len"] = 0
        return cache
