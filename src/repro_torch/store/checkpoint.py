"""Flat named tensors of a parameter tree, and training checkpoints —
the JAX package's ``store/checkpoint.py`` in torch.

A tree is a nested mapping, a ``NamedTuple`` (a ``TrainState``, its
``OptState``) or an ``nn.Module``; its leaves are torch tensors or numpy
arrays, and ``None`` is an empty subtree, as in ``jax.tree_util``.  Flat
names are the ``/``-joined key paths (mapping keys sorted, as
``jax.tree_util`` orders them; a named tuple's field names; a module's
dotted parameter names split at the dots), so a model's or a train
state's flat names equal the JAX package's for the same tree and a
checkpoint written by either package loads into the other.  Flat values
are host arrays in storage form: bf16 as ``uint16`` words
(``store/dtypes.py``).

A train checkpoint IS a MergePipe snapshot: params + optimizer state are
flattened to named tensors, staged, hash-validated, and atomically
published.  Crash mid-save never corrupts the latest checkpoint
(publish-point atomicity), and the catalog gives checkpoint lineage for
free.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.store import dtypes
from repro_torch.store.snapshot import SnapshotStore
from repro_torch.store.tensorstore import load_model_arrays


def _paths(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if tree is None:
        return
    if isinstance(tree, torch.nn.Module):
        for name, leaf in tree.state_dict(keep_vars=True).items():
            yield path + tuple(name.split(".")), leaf
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for key in tree._fields:
            yield from _paths(getattr(tree, key), path + (key,))
    elif isinstance(tree, Mapping):
        for key in sorted(tree, key=str):
            yield from _paths(tree[key], path + (str(key),))
    else:
        yield path, tree


def tree_leaves(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Tree -> {path: leaf} with '/'-joined key paths; tensors stay where
    they are."""
    return {prefix + "/".join(p): leaf for p, leaf in _paths(tree)}


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Tree -> {path: host array} with '/'-joined key paths."""
    return {name: dtypes.as_storage(leaf)
            for name, leaf in tree_leaves(tree, prefix).items()}


def pick(flat: Mapping[str, np.ndarray], key: str, shape) -> np.ndarray:
    """``flat[key]``, checked against the shape the tree expects."""
    if key not in flat:
        raise KeyError(f"checkpoint missing tensor {key!r}")
    arr = flat[key]
    if shape is not None and tuple(arr.shape) != tuple(shape):
        raise ValueError(
            f"checkpoint tensor {key!r} has shape {arr.shape}, "
            f"model expects {tuple(shape)}"
        )
    return arr


def unflatten_like(template: Any, flat: Mapping[str, np.ndarray],
                   prefix: str = "") -> Any:
    """The arrays of ``flat`` in the nested-dict shape of ``template``
    (a module becomes the nested dict of its parameter names)."""
    out: Dict[str, Any] = {}
    for path, leaf in _paths(template):
        arr = pick(flat, prefix + "/".join(path),
                   getattr(leaf, "shape", None))
        if not path:
            return arr
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = arr
    return out


def to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array in storage form (bf16 as ``uint16`` words, or an
    ``ml_dtypes`` bfloat16 array) as a float32 CPU tensor, exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' type: same 2-byte words
        arr = arr.view(dtypes.BFLOAT16)
    out = np.ascontiguousarray(dtypes.to_float32(arr))
    if not out.flags.writeable:  # e.g. a view of a JAX buffer
        out = out.copy()
    return torch.from_numpy(out)


@torch.no_grad()
def copy_into(tree: Any, flat: Mapping[str, np.ndarray], prefix: str = "") -> Any:
    """Copy ``flat`` into the tensors of ``tree`` in place, by their flat
    names (missing names and wrong shapes raise; extra names are
    ignored), each cast to its tensor's dtype and device; returns
    ``tree``."""
    for path, leaf in _paths(tree):
        arr = pick(flat, prefix + "/".join(path), leaf.shape)
        leaf.copy_(to_tensor(arr).to(leaf.dtype) if leaf.is_floating_point()
                   else torch.from_numpy(np.array(arr)).to(leaf.dtype))
    return tree


def save_train_checkpoint(
    snapshots: SnapshotStore,
    step: int,
    state: Any,
    run_id: str = "train",
    extra_meta: Optional[Dict] = None,
) -> str:
    """Atomically publish checkpoint ``<run_id>-step-<step>``."""
    sid = f"{run_id}-step-{step:08d}"
    flat = flatten_tree(state)
    writer = snapshots.open_staging_writer()
    for name, arr in sorted(flat.items()):
        shape = arr.shape  # before ascontiguousarray (it promotes 0-d to 1-d)
        writer.begin_tensor(name, shape, arr.dtype)
        writer.write_block(name, 0, np.ascontiguousarray(arr))
        writer.finish_tensor(name)
    writer.validate_hashes()
    manifest = {
        "sid": sid,
        "plan_id": "-",
        "base_id": "-",
        "expert_ids": [],
        "op": "checkpoint",
        "budget_b": -1,
        "c_expert_run": 0,
        "step": step,
        "run_id": run_id,
        **(extra_meta or {}),
    }
    snapshots.atomic_publish(writer, manifest)
    return sid


def latest_checkpoint(snapshots: SnapshotStore, run_id: str = "train") -> Optional[str]:
    cks = [s for s in snapshots.list_snapshots() if s.startswith(f"{run_id}-step-")]
    return max(cks) if cks else None


def load_train_checkpoint(
    snapshots: SnapshotStore, sid: str, template: Any
) -> Tuple[Any, int]:
    """Returns (state, step): the checkpoint copied into ``template``'s
    tensors in place (the reference builds a new tree; in place, a
    ``TrainState`` whose params are a model's parameters loads into the
    model), on their device."""
    man = snapshots.manifest(sid)
    flat = load_model_arrays(snapshots.models, sid, category="meta")
    return copy_into(template, flat), int(man["step"])
