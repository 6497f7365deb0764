"""Attention: GQA projections, DeepSeek-V2's multi-head latent attention
(MLA), flash attention for prefill and forward, and single-token decode
against a KV cache — the JAX package's ``models/attention.py`` in torch.

:func:`flash_attention` is the kernel wrapper: on CUDA tensors it
launches the Hopper kernel (``csrc/flash_attention.cu``), on CPU tensors
it runs the plain chunked version.  :func:`decode_attention` is plain
torch, as the reference computes it outside any kernel.  GQA never
repeats KV: queries are reshaped to (B, S, Hkv, g, hd).  MLA caches the
compressed latent and expands it to per-head k (qk head dim nope + rope)
and v (v head dim) with :func:`mla_expand_kv`.  Cross-attention (the
encoder–decoder's and the vision model's gated layers) attends from the
decoder stream over a context with no mask and no RoPE, through
:func:`flash_attention` with ``causal=False`` (Sq ≠ Sk).
"""
from __future__ import annotations

import math
from typing import Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.models.layers import (
    apply_rope,
    contract,
    dense_init,
    head_rmsnorm,
    rmsnorm,
)
from repro_torch.models.shardctx import constrain

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


def attention_specs(cfg: ModelConfig) -> dict:
    """:func:`init_attention`'s logical axes."""
    s = {
        "wq": ("stack", "fsdp", "heads", None),
        "wk": ("stack", "fsdp", "kv_heads", None),
        "wv": ("stack", "fsdp", "kv_heads", None),
        "wo": ("stack", "heads", None, "fsdp"),
    }
    if cfg.qkv_bias:
        s.update(bq=("stack", "heads", None), bk=("stack", "kv_heads", None),
                 bv=("stack", "kv_heads", None))
    if cfg.qk_norm:
        s.update(q_norm=("stack", None), k_norm=("stack", None))
    return s


def qkv_project(
    pl: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, Hkv, hd), roped+normed."""
    q = contract(x, pl["wq"])
    k = contract(x, pl["wk"])
    v = contract(x, pl["wv"])
    if cfg.qkv_bias:
        q = q + pl["bq"].to(x.dtype)
        k = k + pl["bk"].to(x.dtype)
        v = v + pl["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = head_rmsnorm(q, pl["q_norm"], cfg.norm_eps)
        k = head_rmsnorm(k, pl["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, ("batch", None, "heads", None))
    k = constrain(k, ("batch", None, "kv_heads", None))
    v = constrain(v, ("batch", None, "kv_heads", None))
    return q, k, v


# ------------------------------------------------------------------ decode
def decode_attention(
    q: torch.Tensor,        # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S_max, Hkv, hd)
    v_cache: torch.Tensor,
    length: int,            # valid cache entries, this token included
    window: int = 0,
) -> torch.Tensor:
    """One query position over a cache.  On DTensors each rank attends
    over its own shard through ``local_map``, with flash attention's
    placements (``local_placements``: batch and matching head shards
    kept, a sequence-sharded cache gathered first)."""
    if hasattr(q, "device_mesh") or hasattr(k_cache, "device_mesh"):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import local_map

        from repro_torch.kernels.flash_attention import local_placements

        mesh = next(t.device_mesh for t in (q, k_cache, v_cache)
                    if isinstance(t, DTensor))
        pq, pkv = local_placements(q, k_cache, v_cache, mesh)
        return local_map(_decode_attention, out_placements=(pq,),
                         in_placements=(pq, pkv, pkv, None, None),
                         device_mesh=mesh, redistribute_inputs=True)(
                             q, k_cache, v_cache, length, window)
    return _decode_attention(q, k_cache, v_cache, length, window)


def _decode_attention(q, k_cache, v_cache, length: int,
                      window: int) -> torch.Tensor:
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



# --------------------------------------------------------------------- MLA
def init_mla(cfg: ModelConfig, n_layers: int, generator, device,
             dtype) -> dict:
    """DeepSeek-V2 Multi-head Latent Attention parameters (the
    reference's names and shapes)."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {
        "wq": dense_init((n_layers, d, h, dn + dr), generator, device, dtype,
                         1),
        "w_dkv": dense_init((n_layers, d, r + dr), generator, device, dtype,
                            1),
        "ckv_norm": torch.zeros((n_layers, r), dtype=dtype, device=device),
        "w_uk": dense_init((n_layers, r, h, dn), generator, device, dtype, 1),
        "w_uv": dense_init((n_layers, r, h, dv), generator, device, dtype, 1),
        "wo": dense_init((n_layers, h, dv, d), generator, device, dtype, 2),
    }


MLA_SPECS = {
    "wq": ("stack", "fsdp", "heads", None),
    "w_dkv": ("stack", "fsdp", None),
    "ckv_norm": ("stack", None),
    "w_uk": ("stack", "fsdp", "heads", None),
    "w_uv": ("stack", "fsdp", "heads", None),
    "wo": ("stack", "heads", None, "fsdp"),
}


def mla_project(
    pl: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, S, H, dn + dr), the normed latent c_kv (B, S,
    r) and the roped shared key k_rope (B, S, dr); the v side and the
    per-head keys come from :func:`mla_expand_kv`, so decode can cache the
    compressed latent."""
    dn, r = cfg.nope_head_dim, cfg.kv_lora_rank
    q = contract(x, pl["wq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)
    ckv_full = contract(x, pl["w_dkv"])
    c_kv, k_rope = ckv_full[..., :r], ckv_full[..., r:]
    c_kv = rmsnorm(c_kv, pl["ckv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return q, c_kv, k_rope


def mla_expand_kv(
    pl: Mapping[str, torch.Tensor], c_kv: torch.Tensor, k_rope: torch.Tensor,
    x_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """c_kv (B, S, r), k_rope (B, S, dr) -> k (B, S, H, dn + dr), v (B, S,
    H, dv): the shared roped key broadcast to every head."""
    k_nope = contract(c_kv, pl["w_uk"])
    v = contract(c_kv, pl["w_uv"])
    h = k_nope.shape[2]
    k_rope_b = k_rope[:, :, None, :].expand(*k_nope.shape[:2], h,
                                            k_rope.shape[-1])
    return torch.cat([k_nope, k_rope_b], dim=-1), v


# ------------------------------------------------------------- cross-attn
def init_cross_attention(cfg: ModelConfig, n_layers: int, generator, device,
                         dtype) -> dict:
    """Cross-attention (VLM image layers / enc-dec): q from the decoder
    stream, k / v from frozen context states (vision embeddings / encoder
    output), and a tanh-gated residual (zeros at init, llama-vision)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": dense_init((n_layers, d, nq, hd), generator, device, dtype, 1),
        "wk": dense_init((n_layers, d, nkv, hd), generator, device, dtype, 1),
        "wv": dense_init((n_layers, d, nkv, hd), generator, device, dtype, 1),
        "wo": dense_init((n_layers, nq, hd, d), generator, device, dtype, 2),
        "gate": torch.zeros((n_layers,), dtype=dtype, device=device),
    }


CROSS_SPECS = {
    "wq": ("stack", "fsdp", "heads", None),
    "wk": ("stack", "fsdp", "kv_heads", None),
    "wv": ("stack", "fsdp", "kv_heads", None),
    "wo": ("stack", "heads", None, "fsdp"),
    "gate": ("stack",),
}


def cross_attention(
    pl: Mapping[str, torch.Tensor], x: torch.Tensor, context: torch.Tensor,
    cfg: ModelConfig,
) -> torch.Tensor:
    """x (B, S, D) attends over context (B, Sc, D); no mask, no rope."""
    q = contract(x, pl["wq"])
    k = contract(context, pl["wk"])
    v = contract(context, pl["wv"])
    out = flash_attention(q, k, v, causal=False)
    out = contract(out, pl["wo"], 2)
    return torch.tanh(pl["gate"]).to(x.dtype) * out
