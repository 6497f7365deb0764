"""Logical axes -> DTensor placements for parameter and cache trees — the
JAX package's ``launch/sharding.py`` over a ``DeviceMesh``.

The models name every parameter's logical spec (``model.param_specs()``,
keyed by the ``/``-joined parameter names) and every cache entry's
(``model.cache_logical_specs()``); this module binds those specs to a
mesh under the train or serve rule set, with per-dim divisibility checks
(indivisible axes are dropped => replicated, never an error).  Where the
reference returns a ``NamedSharding``, these return the placements, one
per mesh dim (``models/shardctx.py`` ``axes_spec`` turns them back into
the reference's ``PartitionSpec`` entries);
:func:`distribute_parameters` / :func:`distribute` place tensors by
them.
"""
from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.models import shardctx

#: when two dims of one tensor resolve to the same mesh axis, the dim with
#: the higher-priority logical name wins (e.g. kv_heads over seq for KV
#: caches when kv_heads divides the model axis; seq takes over otherwise)
AXIS_PRIORITY = (
    "batch", "fsdp", "vocab", "expert", "heads", "kv_heads", "mlp",
    "state", "seq",
)


def spec_axes(mesh, rules: Dict, logical: tuple,
              shape: tuple) -> List[shardctx.AxisEntry]:
    """The reference's ``PartitionSpec`` entries for one tensor."""
    sizes = shardctx.mesh_sizes(mesh)
    prio = {n: i for i, n in enumerate(AXIS_PRIORITY)}
    order = sorted(
        range(len(logical)),
        key=lambda i: prio.get(logical[i], len(AXIS_PRIORITY)),
    )
    out: List[shardctx.AxisEntry] = [None] * len(logical)
    used: set = set()
    for i in order:
        name = logical[i]
        axes = rules.get(name) if name else None
        if not axes:
            continue
        if any(a in used for a in axes):
            continue  # axis already consumed by a higher-priority dim
        extent = 1
        for a in axes:
            extent *= sizes.get(a, 1)
        if i >= len(shape) or shape[i] % extent != 0:
            continue
        used.update(axes)
        out[i] = axes[0] if len(axes) == 1 else tuple(axes)
    return out


def spec_to_sharding(mesh, rules: Dict, logical: tuple, shape: tuple) -> tuple:
    """One tensor's placements (one per mesh dim)."""
    return shardctx.to_placements(mesh, spec_axes(mesh, rules, logical,
                                                  tuple(shape)))


def tree_shardings(mesh, rules: Dict, specs: Dict[str, tuple],
                   shapes: Dict[str, Any]) -> Dict[str, tuple]:
    """Name -> placements for parallel (specs, tensors-or-shapes) dicts."""
    return {name: spec_to_sharding(mesh, rules, specs[name],
                                   tuple(getattr(s, "shape", s)))
            for name, s in shapes.items()}


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def batch_sharding(mesh, rules: Dict, shape: tuple) -> tuple:
    """Token/label arrays: shard dim 0 over the batch axes."""
    logical = ("batch",) + (None,) * (len(shape) - 1)
    return spec_to_sharding(mesh, rules, logical, shape)


def distribute(t, mesh, placements):
    """``t`` (the same full tensor on every rank) as a DTensor: each rank
    keeps its own shard, no communication."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def distribute_parameters(model, mesh, rules: Dict) -> Dict[str, tuple]:
    """Replace every parameter of ``model`` by a DTensor parameter placed
    by ``model.param_specs()`` under ``rules``, in place; returns the
    placements by flat name."""
    import torch

    specs = model.param_specs()
    placed = {}
    for mod_name, mod in model.named_modules():
        for key, p in list(mod._parameters.items()):
            name = "/".join(filter(None, mod_name.split(".") + [key]))
            placed[name] = spec_to_sharding(mesh, rules, specs[name],
                                            tuple(p.shape))
            mod._parameters[key] = torch.nn.Parameter(
                distribute(p.detach(), mesh, placed[name]),
                requires_grad=p.requires_grad)
    return placed
