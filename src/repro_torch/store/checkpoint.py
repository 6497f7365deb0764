"""Flat named tensors of a parameter tree — the JAX package's
``store/checkpoint.py`` (``flatten_tree`` / ``unflatten_like``) in torch.

A tree is a nested mapping or an ``nn.Module``; its leaves are torch
tensors or numpy arrays.  Flat names are the ``/``-joined key paths
(mapping keys sorted, as ``jax.tree_util`` orders them; a module's
dotted parameter names split at the dots), so a model's flat names equal
the JAX package's for the same tree.  Flat values are host arrays in
storage form: bf16 as ``uint16`` words (``store/dtypes.py``).  Training
checkpoints are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.store import dtypes


def _paths(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, torch.nn.Module):
        for name, leaf in tree.state_dict(keep_vars=True).items():
            yield path + tuple(name.split(".")), leaf
    elif isinstance(tree, Mapping):
        for key in sorted(tree, key=str):
            yield from _paths(tree[key], path + (str(key),))
    else:
        yield path, tree


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Tree -> {path: host array} with '/'-joined key paths."""
    return {prefix + "/".join(p): dtypes.as_storage(leaf)
            for p, leaf in _paths(tree)}


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
