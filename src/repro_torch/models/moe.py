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
reference's global-token dispatch over all B·S tokens.  Under a device
mesh whose batch axes divide B (:func:`_batch_axes`), routing, dispatch
and combine run on each batch shard alone through ``local_map``, the
reference's ``shard_map``: the only cross-device traffic left is the
expert GEMMs' (their weights gathered, their partial sums reduced).
Expert weights are (L, E, D, F);
shared experts (DeepSeek) run as one dense SwiGLU of width
``n_shared_experts · F``.  The JAX package has no kernel here: the
products stay ``torch.einsum``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models import shardctx
from repro_torch.models.layers import contract, dense_init
from repro_torch.models.shardctx import constrain, get_mesh


def _batch_axes(b: int, mesh) -> tuple:
    """Mesh axes carrying the batch dim (divisibility-checked), else ()."""
    if mesh is None:
        return ()
    axes = shardctx.resolve_axes(("batch",), (b,))[0]
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


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


def moe_specs(cfg: ModelConfig) -> dict:
    """:func:`init_moe`'s logical axes: D FSDP-sharded over "data", F
    tensor-parallel over "model", E unsharded."""
    s = {
        "router": ("stack", "fsdp", None),
        "w_gate": ("stack", None, "fsdp", "mlp"),
        "w_up": ("stack", None, "fsdp", "mlp"),
        "w_down": ("stack", None, "mlp", "fsdp"),
    }
    if cfg.n_shared_experts:
        s.update(ws_gate=("stack", "fsdp", "mlp"),
                 ws_up=("stack", "fsdp", "mlp"),
                 ws_down=("stack", "mlp", "fsdp"))
    return s


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


def _route_dispatch(x: torch.Tensor, router: torch.Tensor, k: int,
                    n_experts: int, cap: int):
    """:func:`route`, then :func:`dispatch` (called through the module):
    (buf, state, w)."""
    w, idx = route(x, router, k)
    buf, state = dispatch(x, idx, n_experts, cap)
    return buf, state, w


def _hidden(pl: Dict[str, torch.Tensor], buf: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLU activations over a dispatch buffer
    (..., E, C, D) -> (..., E, C, F)."""
    dt = buf.dtype
    h = F.silu(torch.einsum("...ecd,edf->...ecf", buf, pl["w_gate"].to(dt)))
    return h * torch.einsum("...ecd,edf->...ecf", buf, pl["w_up"].to(dt))


def _down(pl: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ecf,efd->...ecd", h, pl["w_down"].to(h.dtype))


def _local_experts(buf, w_gate, w_up, w_down) -> torch.Tensor:
    """The per-row path's experts (B, E, C, D) -> (B, E, C, D)."""
    pl = {"w_gate": w_gate, "w_up": w_up, "w_down": w_down}
    h = constrain(_hidden(pl, buf), ("batch", None, None, "mlp"))
    return _down(pl, h)


def _shard_local(b: int, f: int, mesh):
    """:func:`moe_ffn`'s three stages on batch-sharded DTensors, each
    through ``local_map``: routing + dispatch and combine on each batch
    shard alone (the router gathered, its gradient a partial sum over the
    batch shards), and the experts on each (batch shard, F shard) with
    the expert weights gathered over "data" and split over F where "mlp"
    divides it, their output a partial sum over the F shards (the
    reference's constraint on the hidden activations, made explicit)."""
    bt = shardctx.resolve(("batch",), (b,))
    f_on = shardctx.resolve((None, None, "mlp"), (1, 1, f))
    rep = tuple(Replicate() for _ in bt)

    def per_dim(batch, mlp, other=Replicate()):
        return tuple(batch if p == Shard(0) else mlp if q == Shard(2)
                     else other for p, q in zip(bt, f_on))

    part = Partial()
    routed = local_map(_route_dispatch, out_placements=(bt,) * 6,
                       in_placements=(bt, rep, None, None, None),
                       in_grad_placements=(bt, per_dim(part, Replicate()),
                                           None, None, None),
                       device_mesh=mesh, redistribute_inputs=True)
    w_in, wd_in = per_dim(Replicate(), Shard(2)), per_dim(Replicate(), Shard(1))
    w_grad = per_dim(part, Shard(2))
    wd_grad = per_dim(part, Shard(1))
    experts = local_map(_local_experts, out_placements=(per_dim(Shard(0),
                                                                part),),
                        in_placements=(bt, w_in, w_in, wd_in),
                        in_grad_placements=(per_dim(Shard(0), part), w_grad,
                                            w_grad, wd_grad),
                        device_mesh=mesh, redistribute_inputs=True)
    merge = local_map(combine, out_placements=(bt,),
                      in_placements=(bt,) * 6 + (None,),
                      device_mesh=mesh, redistribute_inputs=True)
    return routed, experts, merge


def _shared(pl: Dict[str, torch.Tensor], x2: torch.Tensor) -> torch.Tensor:
    """The shared experts, one dense SwiGLU over tokens x2 (T, D)."""
    dt = x2.dtype
    hs = F.silu(contract(x2, pl["ws_gate"]))
    hs = hs * contract(x2, pl["ws_up"])
    return contract(hs, pl["ws_down"])


def moe_ffn(pl: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D), each sequence row routed alone with the
    per-row capacity C = max(k, _row_capacity(S))."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(k, _row_capacity(s, cfg))
    mesh = get_mesh()
    if _batch_axes(b, mesh):
        routed, experts, merge = _shard_local(b, pl["w_gate"].shape[-1], mesh)
    else:
        routed, experts, merge = _route_dispatch, _local_experts, combine
    buf, state, w = routed(x, pl["router"], k, e, cap)   # (B, E, C, D)
    y = merge(experts(buf, pl["w_gate"], pl["w_up"], pl["w_down"]), state, w,
              x.dtype)
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
    h = constrain(_hidden(pl, buf), (None, None, "batch", "mlp"))
    y = combine(_down(pl, h), state, w, x.dtype)[0]
    if cfg.n_shared_experts:
        y = y + _shared(pl, x2[0])
    return y.reshape(b, s, d)
