"""RG-LRU recurrent block (RecurrentGemma / Griffin) — the JAX package's
``models/rglru.py`` in torch.

Gated diagonal linear recurrence over time:

    r_t = σ(W_r x_t + b_r)                    recurrence gate
    i_t = σ(W_i x_t + b_i)                    input gate
    a_t = exp(-c · softplus(Λ) · r_t)         per-channel decay, c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Training/prefill uses a parallel prefix over the linear recurrence
(:func:`rglru_scan`, the reference's ``jax.lax.associative_scan``: an XLA
op, not a Pallas kernel, so here plain tensor ops in the same odd–even
recursion and so the same combine order) — O(log T) depth of a few
elementwise launches each, no loop over T.  Decode is the O(1) per-step
update on an (B, width) state.

The full Griffin *recurrent block* wraps the LRU with the gated two-branch
structure: [linear -> GeLU gate] ⊙ [linear -> causal conv(4) -> RG-LRU],
followed by a down projection.  Where the two frameworks differ, the
reference's numbers are kept: ``jax.nn.gelu`` is the tanh approximation,
``jax.nn.softplus`` is ``logaddexp(x, 0)``, and the causal conv is a
shifted sum in the compute dtype, term 0 first, bias last.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import contract, dense_init, pad_time

_C = 8.0


def init_rglru_block(cfg: ModelConfig, n_layers: int, generator, device,
                     dtype) -> Dict[str, torch.Tensor]:
    """The reference's parameters (names, shapes; the biases and Λ in
    float32 whatever ``dtype``)."""
    d = cfg.d_model
    w = cfg.rglru_width or d
    f32 = torch.float32
    return {
        "w_gate_branch": dense_init((n_layers, d, w), generator, device, dtype,
                                    1),
        "w_rec_branch": dense_init((n_layers, d, w), generator, device, dtype,
                                   1),
        "conv_w": dense_init((n_layers, cfg.conv_kernel, w), generator, device,
                             dtype, 1),
        "conv_b": torch.zeros((n_layers, w), dtype=dtype, device=device),
        "w_r": dense_init((n_layers, w, w), generator, device, dtype, 1),
        "b_r": torch.zeros((n_layers, w), dtype=f32, device=device),
        "w_i": dense_init((n_layers, w, w), generator, device, dtype, 1),
        "b_i": torch.zeros((n_layers, w), dtype=f32, device=device),
        "lam": torch.full((n_layers, w), 2.0, dtype=f32, device=device),
        "w_out": dense_init((n_layers, w, d), generator, device, dtype, 1),
    }


RGLRU_SPECS = {
    "w_gate_branch": ("stack", "fsdp", "mlp"),
    "w_rec_branch": ("stack", "fsdp", "mlp"),
    "conv_w": ("stack", None, "mlp"),
    "conv_b": ("stack", "mlp"),
    "w_r": ("stack", "fsdp", "mlp"),
    "b_r": ("stack", "mlp"),
    "w_i": ("stack", "fsdp", "mlp"),
    "b_i": ("stack", "mlp"),
    "lam": ("stack", "mlp"),
    "w_out": ("stack", "mlp", "fsdp"),
}


def _gates(pl: Dict[str, torch.Tensor], u: torch.Tensor):
    """u (B, T, W) -> per-step decay a_t (f32) and gated input.

    The W×W gate matmuls run in the compute dtype; the recurrence math
    (sigmoid / softplus / exp and the scan itself) stays float32."""
    uf = u.float()
    r = torch.sigmoid(
        contract(u, pl["w_r"]).float()
        + pl["b_r"])
    i = torch.sigmoid(
        contract(u, pl["w_i"]).float()
        + pl["b_i"])
    lam = pl["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -_C * softplus[None, None, :] * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, gated


def _combine(left, right):
    a_l, b_l = left
    a_r, b_r = right
    return a_l * a_r, a_r * b_l + b_r


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along axis 1 (``even`` one longer or equal)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n, *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(elems):
    """``jax.lax.associative_scan``'s recursion over axis 1: combine
    adjacent pairs, scan the half, fill in the even positions."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Parallel prefix for h_t = a_t h_{t-1} + b_t over axis 1.  On
    DTensors each rank scans its own shard through ``local_map``: batch
    (dim 0) and width (dim 2) shards are kept, a shard of the time axis
    is gathered."""
    if hasattr(a, "device_mesh"):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
                   for p in a.placements)
        ph = None if h0 is None else tuple(
            Shard(1) if p == Shard(2) else p for p in pl)
        return local_map(rglru_scan, out_placements=(pl,),
                         in_placements=(pl, pl, ph), device_mesh=a.device_mesh,
                         redistribute_inputs=True)(a, b, h0)
    if h0 is not None:
        # fold initial state into the first step
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    _, h = _scan([a, b])
    return h


def causal_conv(pl: Dict[str, torch.Tensor], u: torch.Tensor,
                k: int) -> torch.Tensor:
    """Causal depthwise conv(k) over axis 1 of u (B, T, W): the
    reference's shifted sum in u's dtype, term 0 first, bias last."""
    t = u.shape[1]
    pad = pad_time(u, k - 1)
    out = pad[:, 0:t, :] * pl["conv_w"][0][None, None, :].to(u.dtype)
    for i in range(1, k):
        out = out + pad[:, i:i + t, :] * pl["conv_w"][i][None, None, :].to(
            u.dtype)
    return out + pl["conv_b"][None, None, :].to(u.dtype)


def rglru_block(pl: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Griffin recurrent block for training/prefill. x (B,T,D) -> (B,T,D)."""
    gate = F.gelu(
        contract(x, pl["w_gate_branch"]),
        approximate="tanh")
    u = contract(x, pl["w_rec_branch"])
    u = causal_conv(pl, u, cfg.conv_kernel)
    a, gated = _gates(pl, u)
    h = rglru_scan(a, gated).to(x.dtype)
    out = h * gate
    return contract(out, pl["w_out"])


def rglru_decode_step(
    pl: Dict[str, torch.Tensor], x: torch.Tensor,
    state: Dict[str, torch.Tensor], cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. state = {"h": (B, W), "conv": (B, K-1, W)}."""
    gate = F.gelu(
        contract(x, pl["w_gate_branch"]),
        approximate="tanh")
    u_new = contract(x, pl["w_rec_branch"])
    hist = torch.cat([state["conv"], u_new], dim=1)  # (B, K, W)
    u = (torch.einsum("bkw,kw->bw", hist, pl["conv_w"].to(x.dtype))
         + pl["conv_b"].to(x.dtype))[:, None, :]
    a, gated = _gates(pl, u)
    h = a[:, 0] * state["h"] + gated[:, 0]
    out = h[:, None, :].to(x.dtype) * gate
    out = contract(out, pl["w_out"])
    return out, {"h": h, "conv": hist[:, 1:]}
