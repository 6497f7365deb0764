"""Mamba-2 SSD (state-space duality) block, chunked — the JAX package's
``models/ssm.py`` in torch.

Selective state space per head h (head dim P, state dim N):

    S_t = a_t · S_{t-1} + (Δ_t x_t) B_tᵀ          (P × N state)
    y_t = S_t C_t + D_h · x_t

with a_t = exp(-exp(A_log_h) · Δ_t), Δ_t = softplus(dt_raw + dt_bias).

Training / prefill use the chunked SSD algorithm: the sequence is split
into chunks of Q steps; within a chunk the contribution is a masked
(Q × Q) matmul (the "duality"), and chunk states are carried from chunk
to chunk (the reference's ``lax.scan``, here a loop over the T/Q
chunks in the same order).  Decode is the O(1) recurrence on a (B, H,
P, N) state cache.  B / C are shared across heads (one group), as in
Mamba-2.  The SSD math runs in float32 whatever the compute dtype, as in
the reference (float64 under a float64 compute dtype, a check's
reference precision).  The reference has no Pallas kernel here: plain
tensor ops, einsums and matmuls are the port (the decode step uses
matmuls and broadcasts: it runs 64 layers a token, and an einsum costs
tens of microseconds of host time).

Two deliberate differences in :func:`ssd_chunked`, both on the
log decay between two steps of a chunk.  It masks the exponent before
the exp (``exp(where(tril, seg_ij, -inf))``): the reference takes
``exp(cum_i - cum_j)`` for every (i, j) and masks after, so once a
chunk's summed log-decay passes ~88 the upper triangle overflows to inf
in float32: the forward is the same, but the gradient is inf·0 = NaN.
Here the forward is the same and the gradient finite.  And it sums that
log decay directly (:func:`_segsum`, as Mamba-2's own reference code
does) instead of cancelling two cumulative sums: the same values, less
float32 rounding, which 64 layers amplify.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    at_least_f32,
    contract,
    dense_init,
    pad_time,
    rmsnorm,
)


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_state


def init_ssm(cfg: ModelConfig, n_layers: int, generator, device,
             dtype) -> dict:
    d = cfg.d_model
    d_in, h, n = ssm_dims(cfg)
    conv_dim = d_in + 2 * n

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        # packs [z gate (d_in), x (d_in), B (n), C (n), dt (h)]
        "in_proj": dense_init((n_layers, d, 2 * d_in + 2 * n + h), generator,
                              device, dtype, 1),
        "conv_w": dense_init((n_layers, cfg.conv_kernel, conv_dim), generator,
                             device, dtype, 1),
        "conv_b": zeros(n_layers, conv_dim),
        "A_log": zeros(n_layers, h, dt=torch.float32),
        "D": torch.ones((n_layers, h), dtype=torch.float32, device=device),
        "dt_bias": zeros(n_layers, h, dt=torch.float32),
        "out_norm": zeros(n_layers, d_in),
        "out_proj": dense_init((n_layers, d_in, d), generator, device, dtype,
                               1),
    }


SSM_SPECS = {
    "in_proj": ("stack", "fsdp", "mlp"),
    "conv_w": ("stack", None, "mlp"),
    "conv_b": ("stack", "mlp"),
    "A_log": ("stack", None),
    "D": ("stack", None),
    "dt_bias": ("stack", None),
    "out_norm": ("stack", "mlp"),
    "out_proj": ("stack", "mlp", "fsdp"),
}


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    d_in, h, n = ssm_dims(cfg)
    z = proj[..., :d_in]
    xbc = proj[..., d_in: 2 * d_in + 2 * n]
    dt = proj[..., 2 * d_in + 2 * n:]
    return z, xbc, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xbc (B, T, C), w (K, C)."""
    k = w.shape[0]
    pad = pad_time(xbc, k - 1)
    t = xbc.shape[1]
    out = sum(pad[:, i: i + t, :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + bias[None, None, :])


def conv_tail(xbc: torch.Tensor, k: int) -> torch.Tensor:
    """The last k - 1 rows of the conv's input (B, T, C), the decode
    cache's conv history: left-padded with zeros when T < k - 1, which
    is what :func:`_causal_conv` saw before the prompt.  (The reference
    keeps only T rows there, and its decode step then fails on a prompt
    of 1 or 2 tokens.)"""
    t = xbc.shape[1]
    if t < k - 1:
        xbc = pad_time(xbc, k - 1 - t)
    return xbc[:, -(k - 1):, :]


def _segsum(la: torch.Tensor) -> torch.Tensor:
    """la (B, NC, Q, H) -> (B, NC, Q, Q, H): Σ_{j<k<=i} la_k, the log decay
    from step j to step i of a chunk (0 where i <= j), summed directly:
    the reference's cum_i - cum_j cancels two sums of up to Q terms, and
    at Mamba-2's decays (~-1 a step, |cum| ~ 100 over a 128-step chunk)
    loses ~1e-5 of each decay factor to float32 rounding."""
    q = la.shape[2]
    strict = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=la.device), -1)   # [k, j]: k > j
    z = torch.where(strict[None, None, :, :, None], la[:, :, :, None, :],
                    0.0)
    return torch.cumsum(z, dim=2)


def ssd_chunked(
    xh: torch.Tensor,    # (B, T, H, P)  Δ-scaled inputs  (x̄ = Δ·x)
    la: torch.Tensor,    # (B, T, H)     log decay  (log a_t, ≤ 0)
    Bm: torch.Tensor,    # (B, T, N)
    Cm: torch.Tensor,    # (B, T, N)
    chunk: int,
    s0: Optional[torch.Tensor] = None,  # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel SSD. Returns (y (B,T,H,P), final_state (B,H,P,N)).
    On DTensors each rank runs its own shard through ``local_map``
    (:func:`_ssd_sharded`)."""
    if hasattr(xh, "device_mesh"):
        return _ssd_sharded(xh, la, Bm, Cm, chunk, s0)
    b, t, h, p = xh.shape
    n = Bm.shape[-1]
    q = min(chunk, t)
    pad = (-t) % q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        la = F.pad(la, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = xh.shape[1] // q
    xh = xh.reshape(b, nc, q, h, p)
    la = la.reshape(b, nc, q, h)
    Bm = Bm.reshape(b, nc, q, n)
    Cm = Cm.reshape(b, nc, q, n)

    cum = torch.cumsum(la, dim=2)                     # (B, NC, Q, H) Σ log a
    seg = _segsum(la)                                 # (B, NC, Q, Q, H)
    # intra-chunk: y_i = Σ_{j<=i} (C_i·B_j) exp(cum_i - cum_j) x̄_j
    G = torch.einsum("bcin,bcjn->bcij", Cm, Bm)       # (B, NC, Q, Q)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    # masked before the exp: the upper triangle is exp(-inf) = 0, never inf
    decay = torch.exp(torch.where(mask[None, None, :, :, None], seg,
                                  float("-inf")))
    M = G[..., None] * decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xh)

    # chunk summaries: S_c = Σ_j exp(cum_Q - cum_j) x̄_j B_jᵀ
    tail = torch.exp(seg[:, :, -1])                   # (B, NC, Q, H)
    S_c = torch.einsum("bcjh,bcjhp,bcjn->bchpn", tail, xh, Bm)
    a_chunk = torch.exp(cum[:, :, -1, :])             # (B, NC, H) total decay

    s = (torch.zeros((b, h, p, n), dtype=xh.dtype, device=xh.device)
         if s0 is None else s0)
    s_prevs = []
    for c in range(nc):                               # the reference's scan
        s_prevs.append(s)
        s = a_chunk[:, c, :, None, None] * s + S_c[:, c]
    s_prev = torch.stack(s_prevs, dim=1)              # (B, NC, H, P, N)

    # inter-chunk: y_i += exp(cum_i) · C_i · S_prev
    y_inter = torch.einsum("bcih,bcin,bchpn->bcihp", torch.exp(cum), Cm,
                           s_prev)
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)
    return y[:, :t], s


def _ssd_sharded(xh, la, Bm, Cm, chunk: int, s0):
    """:func:`ssd_chunked` shard by shard: per mesh dim, a batch shard of
    ``xh`` keeps every input batch-sharded; a head shard of ``xh`` and
    ``la`` keeps them (and the state) head-sharded, B and C whole, their
    gradients partial sums over the head shards; anything else (a shard
    of the time axis, which the chunk recurrence runs along) is
    gathered."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xh.device_mesh

    def placed(t):
        return (tuple(t.placements) if isinstance(t, DTensor)
                else (Replicate(),) * mesh.ndim)

    cols = [[] for _ in range(5)]
    for px, pa in zip(placed(xh), placed(la)):
        if px == Shard(0):
            row = (Shard(0), Shard(0), Shard(0), Shard(0), Shard(0))
        elif px == pa == Shard(2):
            row = (Shard(2), Shard(2), Replicate(), Partial(), Shard(1))
        else:
            row = (Replicate(),) * 5
        for col, p in zip(cols, row):
            col.append(p)
    x_p, la_p, bc_p, bc_grad, s_p = (tuple(c) for c in cols)
    s0_p = None if s0 is None else s_p
    return local_map(ssd_chunked, out_placements=(x_p, s_p),
                     in_placements=(x_p, la_p, bc_p, bc_p, None, s0_p),
                     in_grad_placements=(x_p, la_p, bc_grad, bc_grad, None,
                                         s0_p),
                     device_mesh=mesh, redistribute_inputs=True)(
                         xh, la, Bm, Cm, chunk, s0)


def _ssd_inputs(pl: Mapping[str, torch.Tensor], xbc: torch.Tensor,
                dt_raw: torch.Tensor, cfg: ModelConfig):
    """The SSD's float32 inputs from the conv's output (float64 where the
    compute dtype is): x per head (B, T, H, P), the step Δ (B, T, H), the
    log decay, B and C."""
    d_in, h, n = ssm_dims(cfg)
    xs = xbc[..., :d_in]
    Bm = at_least_f32(xbc[..., d_in: d_in + n])
    Cm = at_least_f32(xbc[..., d_in + n:])
    dt = _softplus(at_least_f32(dt_raw) + pl["dt_bias"])         # (B,T,H)
    a = -torch.exp(pl["A_log"])[None, None, :] * dt              # log decay
    xh = at_least_f32(xs.reshape(*xs.shape[:2], h, cfg.ssm_head_dim))
    return xh, dt, a, Bm, Cm


def _gated_out(pl: Mapping[str, torch.Tensor], y: torch.Tensor,
               xh: torch.Tensor, z: torch.Tensor, cfg: ModelConfig):
    """D skip, the gated norm and the output projection: (B, T, D)."""
    y = y + pl["D"][None, None, :, None] * xh
    y = y.reshape(*z.shape[:2], -1).to(z.dtype)
    y = rmsnorm(y * F.silu(z), pl["out_norm"], cfg.norm_eps)    # gated norm
    return contract(y, pl["out_proj"])


def ssm_mixer(pl: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The mixer over a whole sequence: (output (B, T, D), final SSD state
    (B, H, P, N) float32, the conv's input (B, T, C) for the decode
    cache's tail)."""
    proj = contract(x, pl["in_proj"])
    z, xbc_in, dt_raw = _split_proj(proj, cfg)
    xbc = _causal_conv(xbc_in, pl["conv_w"].to(x.dtype),
                       pl["conv_b"].to(x.dtype))
    xh, dt, a, Bm, Cm = _ssd_inputs(pl, xbc, dt_raw, cfg)
    y, s_final = ssd_chunked(xh * dt[..., None], a, Bm, Cm, cfg.ssm_chunk)
    return _gated_out(pl, y, xh, z, cfg), s_final, xbc_in


def ssm_block(pl: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Full Mamba-2 mixer for training/prefill. x (B, T, D) -> (B, T, D)."""
    return ssm_mixer(pl, x, cfg)[0]


# ------------------------------------------------------------------ decode
def ssm_decode_step(
    pl: Mapping[str, torch.Tensor],
    x: torch.Tensor,                 # (B, 1, D)
    state: Dict[str, torch.Tensor],  # {"s": (B,H,P,N), "conv": (B, K-1, C)}
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    d_in, h, n = ssm_dims(cfg)
    proj = contract(x, pl["in_proj"])
    z, xbc, dt_raw = _split_proj(proj, cfg)

    conv_hist = torch.cat([state["conv"], xbc], dim=1)          # (B, K, C)
    xbc_t = F.silu((conv_hist * pl["conv_w"].to(x.dtype)).sum(1, keepdim=True)
                   + pl["conv_b"].to(x.dtype))
    new_conv = conv_hist[:, 1:]

    xh, dt, a, Bm, Cm = _ssd_inputs(pl, xbc_t, dt_raw, cfg)
    xh, dt, Bm, Cm = xh[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0]
    a = torch.exp(a[:, 0])                                      # (B,H)
    xh_bar = xh * dt[..., None]

    s = state["s"]
    s = a[..., None, None] * s + xh_bar[..., None] * Bm[:, None, None, :]
    y = (s @ Cm[:, None, :, None])[..., 0]
    out = _gated_out(pl, y[:, None], xh[:, None], z, cfg)
    return out, {"s": s, "conv": new_conv}
