"""Mixture-of-Experts FFN with sort-based capacity dispatch — the JAX
package's ``models/moe.py`` in torch.

The reference's dropping implementation (MaxText-style):
  1. router top-k over experts (float32), weights renormalized;
  2. token-expert pairs sorted by expert id (stable); each expert
     receives a *static-capacity* slice C and overflow pairs are dropped
     (GShard semantics);
  3. per-expert batched GEMMs, ``einsum('becd,edf->becf')``, in the
     compute dtype;
  4. results gathered back to token order and combined with the router
     weights in float32.

:func:`moe_ffn` routes each sequence row alone (the reference's ``vmap``
over rows is a batch dimension written out here) with the per-row
capacity ``max(k, _row_capacity(S))``; :func:`moe_ffn_global` is the
reference's global-token dispatch over all B·S tokens.  The reference's
``shard_map`` over a device mesh has no counterpart on one card
(``shardctx.get_mesh()`` is None).  Expert weights are (L, E, D, F);
shared experts (DeepSeek) run as one dense SwiGLU of width
``n_shared_experts · F``.  The JAX package has no kernel here: the
products stay ``torch.einsum``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.models.shardctx import constrain


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    raw = int(
        n_tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts
    )
    return max(128, ((raw + 127) // 128) * 128)


def _row_capacity(seq: int, cfg: ModelConfig) -> int:
    raw = int(seq * cfg.experts_per_token * cfg.capacity_factor
              / cfg.n_experts)
    return max(8, ((raw + 7) // 8) * 8)


def init_moe(cfg: ModelConfig, n_layers: int, generator, device,
             dtype) -> dict:
    """The reference's names and shapes; the router is float32."""
    d, e = cfg.d_model, cfg.n_experts
    f = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": dense_init((n_layers, d, e), generator, device,
                             torch.float32, 1),
        "w_gate": dense_init((n_layers, e, d, f), generator, device, dtype, 2),
        "w_up": dense_init((n_layers, e, d, f), generator, device, dtype, 2),
        "w_down": dense_init((n_layers, e, f, d), generator, device, dtype, 2),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p["ws_gate"] = dense_init((n_layers, d, fs), generator, device, dtype)
        p["ws_up"] = dense_init((n_layers, d, fs), generator, device, dtype)
        p["ws_down"] = dense_init((n_layers, fs, d), generator, device, dtype)
    return p


def route(x: torch.Tensor, router: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., T, D) -> renormalized top-k weights and expert ids (...,
    T, k): a float32 softmax over the experts, the weights over
    ``max(sum, 1e-9)``."""
    logits = torch.einsum("...td,de->...te", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx


def dispatch(x: torch.Tensor, idx: torch.Tensor, n_experts: int,
             cap: int) -> Tuple[torch.Tensor, Tuple]:
    """Sort-based dispatch of each row of x (R, T, D) by its expert ids
    ``idx`` (R, T, k) into a buffer (R, E, C, D), each row on its own.

    The T·k pairs of a row are sorted by expert (stable), each takes the
    slot ``seg_pos`` = its rank among its expert's pairs, and a pair with
    ``seg_pos >= cap`` is dropped (it adds zeros to slot C - 1, as in
    the reference).  Returns the buffer and the routing state
    ``(sorted_e, slot, keep, sort_idx)``, each (R, T·k)."""
    r, t, d = x.shape
    k = idx.shape[-1]
    flat_e = idx.reshape(r, t * k)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    tok_of_pair = sort_idx // k
    rows = torch.arange(r, device=x.device)[:, None]
    # each row's pairs per expert (the reference's bincount; a scatter-add
    # of ones, since torch.bincount on a card waits for the device to size
    # its output)
    counts = torch.zeros((r, n_experts), dtype=flat_e.dtype, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts
    seg_pos = (torch.arange(t * k, device=x.device)
               - torch.gather(starts, 1, sorted_e))
    keep = seg_pos < cap
    slot = torch.where(keep, seg_pos, cap - 1)
    gathered = torch.gather(x, 1, tok_of_pair[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered, 0.0).to(x.dtype)
    buf = torch.zeros((r * n_experts * cap, d), dtype=x.dtype,
                      device=x.device)
    buf.index_add_(0, ((rows * n_experts + sorted_e) * cap + slot).reshape(-1),
                   gathered.reshape(-1, d))
    return buf.view(r, n_experts, cap, d), (sorted_e, slot, keep, sort_idx)


def combine(y_exp: torch.Tensor, state: Tuple, w: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """Gather each row's expert outputs y_exp (R, E, C, D) back to token
    order and sum them with the router weights ``w`` (R, T, k) in
    float32; a dropped pair contributes zero.  Returns (R, T, D)."""
    sorted_e, slot, keep, sort_idx = state
    r, n_experts, cap, d = y_exp.shape
    t, k = w.shape[1], w.shape[2]
    flat = y_exp.reshape(r * n_experts * cap, d)
    rows = torch.arange(r, device=y_exp.device)[:, None]
    y_sorted = flat[(rows * n_experts + sorted_e) * cap + slot]  # (R, T·k, D)
    y_sorted = torch.where(keep[..., None], y_sorted, 0.0)
    # inverse permutation: pair i sits at position inv[i] of the sort
    inv = torch.empty_like(sort_idx).scatter_(
        1, sort_idx, torch.arange(t * k, device=y_exp.device).expand(r, -1))
    y_pair = torch.gather(y_sorted, 1, inv[..., None].expand(-1, -1, d))
    return torch.einsum("rtkd,rtk->rtd", y_pair.reshape(r, t, k, d).float(),
                        w).to(out_dtype)


def _experts(pl: Dict[str, torch.Tensor], buf: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLU over a dispatch buffer (..., E, C, D)."""
    dt = buf.dtype
    h = F.silu(torch.einsum("...ecd,edf->...ecf", buf, pl["w_gate"].to(dt)))
    h = h * torch.einsum("...ecd,edf->...ecf", buf, pl["w_up"].to(dt))
    h = constrain(h, ("batch", None, None, "mlp"))
    return torch.einsum("...ecf,efd->...ecd", h, pl["w_down"].to(dt))


def _shared(pl: Dict[str, torch.Tensor], x2: torch.Tensor) -> torch.Tensor:
    """The shared experts, one dense SwiGLU over tokens x2 (T, D)."""
    dt = x2.dtype
    hs = F.silu(torch.einsum("td,df->tf", x2, pl["ws_gate"].to(dt)))
    hs = hs * torch.einsum("td,df->tf", x2, pl["ws_up"].to(dt))
    return torch.einsum("tf,fd->td", hs, pl["ws_down"].to(dt))


def moe_ffn(pl: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D), each sequence row routed alone with the
    per-row capacity C = max(k, _row_capacity(S))."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(k, _row_capacity(s, cfg))
    w, idx = route(x, pl["router"], k)
    buf, state = dispatch(x, idx, e, cap)                 # (B, E, C, D)
    y = combine(_experts(pl, buf), state, w, x.dtype)
    y = constrain(y, ("batch", None, None))
    if cfg.n_shared_experts:
        y = y + _shared(pl, x.reshape(b * s, d)).reshape(b, s, d)
    return y


def moe_ffn_global(pl: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """The reference's global-token dispatch (its ablation baseline): one
    routing over all B·S tokens with capacity ``_capacity(B·S)``."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    x2 = x.reshape(1, t, d)
    w, idx = route(x2, pl["router"], k)
    buf, state = dispatch(x2, idx, e, _capacity(t, cfg))  # (1, E, C, D)
    buf = constrain(buf, (None, None, "batch", None))
    y = combine(_experts(pl, buf), state, w, x.dtype)[0]
    if cfg.n_shared_experts:
        y = y + _shared(pl, x2[0])
    return y.reshape(b, s, d)
