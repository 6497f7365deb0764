"""Elastic scaling & straggler policy — the JAX package's
``launch/elastic.py`` over ``torch.distributed``.

Checkpoints are mesh-agnostic (logical tensors by flat name, no device
layout baked in: store/checkpoint.py), so a job that loses a pod
restarts on any mesh whose axes divide the logical dims: the launcher
re-resolves placements against the new mesh.  ``replan_mesh`` picks the
largest valid (data, model) grid for the surviving device count, over a
default group of that many ranks.  The pod axis is the failure domain:
batch is sharded over ("pod", "data"), so losing a pod halves the
global batch but never splits a model shard.
"""
from __future__ import annotations

from typing import Optional, Tuple


def replan_shape(n_chips: int, model_parallel: int = 16,
                 want_pods: Optional[int] = None
                 ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The mesh shape and axis names :func:`replan_mesh` builds."""
    if n_chips % model_parallel:
        raise ValueError(
            f"{n_chips} chips not divisible by model_parallel={model_parallel}"
        )
    data = n_chips // model_parallel
    if want_pods and want_pods > 1:
        if data % want_pods:
            raise ValueError(f"data axis {data} not divisible by {want_pods} pods")
        return ((want_pods, data // want_pods, model_parallel),
                ("pod", "data", "model"))
    return (data, model_parallel), ("data", "model")


def replan_mesh(
    n_chips: int,
    model_parallel: int = 16,
    want_pods: Optional[int] = None,
    device_type: str = "cuda",
):
    """Largest valid mesh for a (possibly reduced) chip count.

    Keeps the model axis fixed (re-sharding weights across a different TP
    degree would change per-op layouts); absorbs chip loss on the
    data/pod axes."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = replan_shape(n_chips, model_parallel, want_pods)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def degraded_batch(global_batch: int, lost_fraction: float) -> int:
    """Keep per-chip batch constant when chips are lost (linear scaling
    rule); callers rescale LR accordingly."""
    b = int(global_batch * (1 - lost_fraction))
    return max(1, b)
