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

from repro_torch.models.shardctx import constrain

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


# ---------------------------------------------------------- logical specs
#: each parameter's logical axes (the reference's init specs); a leading
#: "stack" is the layer axis
MLP_SPECS = {
    "w_gate": ("stack", "fsdp", "mlp"),
    "w_up": ("stack", "fsdp", "mlp"),
    "w_down": ("stack", "mlp", "fsdp"),
}
EMBED_SPECS = {"embedding": ("vocab", "fsdp")}


def stacked_twice(specs: Mapping[str, tuple]) -> Dict[str, tuple]:
    """Specs of a stack reshaped to (n_super, per_block, ...)."""
    return {k: ("stack", "stack") + tuple(v[1:]) for k, v in specs.items()}


def flat_specs(tree: Mapping, prefix: str = "") -> Dict[str, tuple]:
    """A nested spec tree -> {``/``-joined name: logical axes}."""
    out: Dict[str, tuple] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flat_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v)
    return out


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
    h = F.silu(contract(x, p["w_gate"])) * contract(x, p["w_up"])
    h = constrain(h, ("batch", None, "mlp"))
    return contract(h, p["w_down"])


def _contract_local(x: torch.Tensor, w: torch.Tensor,
                    n_c: int) -> torch.Tensor:
    if n_c == 1 and w.ndim == 2:
        return torch.matmul(x, w.to(x.dtype))
    return torch.tensordot(x, w.to(x.dtype), dims=n_c)


def _contract_placements(x, w, n_c: int, mesh) -> tuple:
    """Per mesh dim: x's and w's placements for the local product, the
    product's, and x's and w's gradients'."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    rep = (Replicate(),) * mesh.ndim
    px = tuple(x.placements) if isinstance(x, DTensor) else rep
    pw = tuple(w.placements) if isinstance(w, DTensor) else rep
    lead = x.ndim - n_c
    cols = [[] for _ in range(5)]
    for a, b in zip(px, pw):
        xs = a.dim if isinstance(a, Shard) else None
        ws = b.dim if isinstance(b, Shard) else None
        if xs is not None and xs < lead:        # x's rows: w gathered
            row = (Shard(xs), Replicate(), Shard(xs), Shard(xs), Partial())
        elif xs is not None and ws == xs - lead:  # one contracted dim
            row = (Shard(xs), Shard(ws), Partial(), Shard(xs), Shard(ws))
        elif xs is None and ws is not None and ws >= n_c:  # w's columns
            row = (Replicate(), Shard(ws), Shard(lead + ws - n_c), Partial(),
                   Shard(ws))
        else:                                   # gathered
            row = (Replicate(),) * 5
        for col, p in zip(cols, row):
            col.append(p)
    return tuple(tuple(c) for c in cols)


def contract(x: torch.Tensor, w: torch.Tensor, n_c: int = 1) -> torch.Tensor:
    """x (..., C1..Cn) · w (C1..Cn, O...) -> (..., O...) in x's dtype: the
    reference's weight einsums (``bsd,df->bsf``, ``bshk,hkd->bsd``,
    ``bsd,dhk->bshk``, ...) as one ``tensordot`` over the n = ``n_c``
    contracted dims.

    On DTensors the layout is explicit, through ``local_map`` (DTensor's
    own einsum flattens dims it then cannot split, or gathers whole
    activations): per mesh dim, rows of x that are sharded stay sharded
    and w is gathered there (FSDP); a contracted dim sharded in both
    stays sharded and the product is a partial sum (row-parallel); an
    output dim of w that is sharded stays sharded, x whole (column-
    parallel); anything else is gathered.  A partial product is reduced
    at once, as the reference's partitioner does, not carried into the
    norms that follow.  Gradients come back as the matching shards or
    partial sums."""
    if not hasattr(x, "device_mesh") and not hasattr(w, "device_mesh"):
        return _contract_local(x, w, n_c)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    from torch.distributed.tensor import Partial, Replicate

    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    x_in, w_in, out, x_grad, w_grad = _contract_placements(x, w, n_c, mesh)
    y = local_map(_contract_local, out_placements=(out,),
                  in_placements=(x_in, w_in, None),
                  in_grad_placements=(x_grad, w_grad, None),
                  device_mesh=mesh, redistribute_inputs=True)(x, w, n_c)
    if Partial() in out:  # reduced at once, in the product's dtype
        y = y.redistribute(mesh, tuple(Replicate() if p == Partial() else p
                                       for p in out))
    return y


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
def _embed_local(table: torch.Tensor, tokens: torch.Tensor,
                 v0: int) -> torch.Tensor:
    """The rows of ``tokens`` in this vocabulary shard [v0, v0 + V), 0
    for the others."""
    idx = tokens - v0
    inside = (idx >= 0) & (idx < table.shape[0])
    rows = table[idx.clamp(0, table.shape[0] - 1)]
    return torch.where(inside[..., None], rows, 0.0)


def _embed_sharded(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` on DTensors, through ``local_map`` (DTensor's
    own gather plans its gradient's scatter with placements some torch
    releases cannot normalise): per mesh dim, a batch shard of the tokens
    gathers the table there (FSDP) and its gradient is a partial sum; a
    vocabulary shard of the table looks up each rank's rows, the rows a
    partial sum over the shards; anything else is gathered."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    pt = (tuple(tokens.placements) if isinstance(tokens, DTensor)
          else (Replicate(),) * mesh.ndim)
    cols = [[] for _ in range(4)]
    for a, b in zip(pt, table.placements):
        if a == Shard(0):
            row = (Replicate(), Shard(0), Shard(0), Partial())
        elif b == Shard(0):
            row = (Shard(0), Replicate(), Partial(), Shard(0))
        else:
            row = (Replicate(),) * 4
        for col, p in zip(cols, row):
            col.append(p)
    tab_in, tok_in, out, tab_grad = (tuple(c) for c in cols)
    v0 = compute_local_shape_and_global_offset(table.shape, mesh,
                                               tab_in)[1][0]
    return local_map(_embed_local, out_placements=(out,),
                     in_placements=(tab_in, tok_in, None),
                     in_grad_placements=(tab_grad, tok_in, None),
                     device_mesh=mesh, redistribute_inputs=True)(
                         table, tokens, v0)


def embed_tokens(p: Mapping[str, torch.Tensor], tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    # gather, then cast: the same values as casting the whole table first
    table = p["embedding"]
    rows = (_embed_sharded(table, tokens) if hasattr(table, "device_mesh")
            else table[tokens])
    return constrain(rows.to(compute_dtype), ("batch", None, None))


def unembed(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Tied output projection onto the embedding table."""
    logits = contract(x, p["embedding"].t())
    return constrain(logits, ("batch", None, "vocab"))


# ------------------------------------------------------------------- loss
def _pick_local(logits: torch.Tensor, labels: torch.Tensor,
                v0: int) -> torch.Tensor:
    """The logits of the labels in this vocabulary shard [v0, v0 + V), 0
    for the others."""
    idx = labels.long() - v0
    inside = (idx >= 0) & (idx < logits.shape[-1])
    got = torch.gather(logits, -1, idx.clamp(0, logits.shape[-1] - 1)[
        ..., None]).squeeze(-1)
    return torch.where(inside, got, 0.0)


def pick_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``.  On a DTensor sharded over the vocabulary
    each rank picks the labels in its shard and the pick is the sum over
    the shards (a partial sum): DTensor's own gather plans that as a
    masked partial its reduction cannot apply to this shape."""
    if not hasattr(logits, "device_mesh"):
        return _pick_local(logits, labels, 0)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    from torch.distributed.tensor.experimental import local_map

    mesh, last = logits.device_mesh, logits.ndim - 1
    out = tuple(Partial() if p == Shard(last) else p
                for p in logits.placements)
    lab = tuple(Replicate() if p == Partial() else p for p in out)
    v0 = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)[1][last]
    return local_map(_pick_local, out_placements=(out,),
                     in_placements=(tuple(logits.placements), lab, None),
                     device_mesh=mesh, redistribute_inputs=True)(
                         logits, labels, v0)


class _ShardedLogSumExp(torch.autograd.Function):
    """logsumexp over a vocabulary-sharded DTensor's last dim, step by
    step: the max over the shards, then the sum of exponentials over them
    (each a per-shard reduction and one all-reduce); the gradient
    ``exp(logits - logz) · g`` stays sharded as the logits are."""

    @staticmethod
    def forward(ctx, logits):
        m = logits.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), 0.0, m)  # as torch.logsumexp does
        logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m.squeeze(-1)
        ctx.save_for_backward(logits, logz)
        return logz

    @staticmethod
    def backward(ctx, g):
        logits, logz = ctx.saved_tensors
        return torch.exp(logits - logz.unsqueeze(-1)) * g.unsqueeze(-1)


def vocab_logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the last dim; on a DTensor sharded over the
    vocabulary, :class:`_ShardedLogSumExp` (DTensor's own logsumexp
    gathers the whole batch to each vocabulary shard, and its autograd
    of the steps moves whole rows between the shards)."""
    last = logits.ndim - 1
    if not any(getattr(p, "dim", None) == last
               for p in getattr(logits, "placements", ())):
        return torch.logsumexp(logits, dim=-1)
    return _ShardedLogSumExp.apply(logits)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL; logits (B, S, V)."""
    logits = logits.float()
    logz = vocab_logsumexp(logits)
    gold = pick_labels(logits, labels)
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


# ------------------------------------------------------------ time axis
def _pad_time_local(u: torch.Tensor, before: int) -> torch.Tensor:
    return F.pad(u, (0, 0, before, 0))


def pad_time(u: torch.Tensor, before: int) -> torch.Tensor:
    """u (B, T, C) with ``before`` zero rows in front of T: the causal
    convolutions' padding.  On a DTensor through ``local_map``, batch and
    channel shards kept, a time shard gathered (torch 2.11's DTensor pad
    returns placements of the wrong length on a 2-D mesh)."""
    if not hasattr(u, "device_mesh"):
        return _pad_time_local(u, before)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
               for p in u.placements)
    return local_map(_pad_time_local, out_placements=(pl,),
                     in_placements=(pl, None), device_mesh=u.device_mesh,
                     redistribute_inputs=True)(u, before)


# ------------------------------------------------------------ decode
def write_position(cache: torch.Tensor, pos: int,
                   value: torch.Tensor) -> None:
    """``cache[:, pos] = value`` in place: one layer's cache (B, S, ...)
    and the step's entry (B, ...).  On a DTensor cache the entry is placed
    as the cache is (a sequence shard replicated) and written into the
    local shard of the rank that holds position ``pos`` (a cache sharded
    over S: DTensor would write a gathered copy)."""
    if not hasattr(cache, "device_mesh"):
        cache[:, pos] = value.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    mesh = cache.device_mesh
    placements = tuple(
        Replicate() if p == Shard(1) else
        Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p
        for p in cache.placements)
    if hasattr(value, "device_mesh"):
        local = value.redistribute(mesh, placements).to_local()
    else:
        from torch.distributed.tensor import distribute_tensor

        local = distribute_tensor(value, mesh, placements,
                                  src_data_rank=None).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    if offset[1] <= pos < offset[1] + shape[1]:
        cache.to_local()[:, pos - offset[1]] = local.to(cache.dtype)


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

    def param_specs(self) -> Dict[str, tuple]:
        """Each parameter's logical axes by its flat name: the reference's
        ``param_specs()`` with its tree ``/``-joined."""
        return flat_specs(self._spec_tree())

    def _compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.compute_dtype)

    def init_cache(self, batch: int, max_len: int) -> Dict:
        specs = self.cache_specs(batch, max_len)
        cache = {name: torch.zeros(shape, dtype=dt, device=self.device)
                 for name, (shape, dt) in specs.items() if name != "len"}
        cache["len"] = 0
        return cache
