"""Attention: GQA projections, flash attention for prefill and forward,
and single-token decode against a KV cache — the JAX package's
``models/attention.py`` in torch.

:func:`flash_attention` is the kernel wrapper: on CUDA tensors it
launches the Hopper kernel (``csrc/flash_attention.cu``), on CPU tensors
it runs the plain chunked version.  :func:`decode_attention` is plain
torch, as the reference computes it outside any kernel.  GQA never
repeats KV: queries are reshaped to (B, S, Hkv, g, hd).  MLA and
cross-attention are not ported yet (the model refuses those configs).
"""
from __future__ import annotations

import math
from typing import Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.models.layers import apply_rope, dense_init, head_rmsnorm

_NEG = -1.0e30


# ------------------------------------------------------------------ params
def init_attention(cfg: ModelConfig, n_layers: int, generator, device,
                   dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init((n_layers, d, nq, hd), generator, device, dtype, 1),
        "wk": dense_init((n_layers, d, nkv, hd), generator, device, dtype, 1),
        "wv": dense_init((n_layers, d, nkv, hd), generator, device, dtype, 1),
        "wo": dense_init((n_layers, nq, hd, d), generator, device, dtype, 2),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n_layers, nq, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n_layers, nkv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((n_layers, nkv, hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((n_layers, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((n_layers, hd), dtype=dtype, device=device)
    return p


def qkv_project(
    pl: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, Hkv, hd), roped+normed."""
    q = torch.einsum("bsd,dhk->bshk", x, pl["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, pl["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, pl["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + pl["bq"].to(x.dtype)
        k = k + pl["bk"].to(x.dtype)
        v = v + pl["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = head_rmsnorm(q, pl["q_norm"], cfg.norm_eps)
        k = head_rmsnorm(k, pl["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ------------------------------------------------------------------ decode
def decode_attention(
    q: torch.Tensor,        # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S_max, Hkv, hd)
    v_cache: torch.Tensor,
    length: int,            # valid cache entries, this token included
    window: int = 0,
) -> torch.Tensor:
    b, _, h, hd = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    hdv = v_cache.shape[-1]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, 1, hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k_cache.float()) * scale  # (B, Hkv, g, 1, S_max)
    kpos = torch.arange(s_max, device=q.device)
    valid = kpos < length
    if window > 0:
        valid = valid & (length - 1 - kpos < window)
    s = torch.where(valid, s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return out.reshape(b, 1, h, hdv).to(q.dtype)

