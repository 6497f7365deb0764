"""Dtype registry — numpy <-> on-disk names, including bfloat16.

numpy has no native bfloat16 and this package does not depend on
``ml_dtypes``.  The on-disk format is unchanged: a ``"bfloat16"`` tensor
is raw little-endian 2-byte words.  On the host those words are carried
as ``uint16`` bit patterns — ``uint16`` is the *storage* dtype of
bfloat16 here and is never a checkpoint dtype of its own, so the name
<-> dtype mapping stays a bijection.

Every float32 conversion goes through :func:`to_float32` /
:func:`from_float32`: a plain ``np.asarray(x, np.float32)`` or
``.astype(dtype)`` on a ``uint16`` view would convert the bit patterns
as integers, which is wrong.  f32 -> bf16 rounds to nearest even, as
``ml_dtypes`` and ``torch`` both do.
"""
from __future__ import annotations

import numpy as np

#: host storage dtype of bfloat16 (raw bit patterns)
BFLOAT16 = np.dtype(np.uint16)

_CANONICAL = {
    "float32": np.dtype(np.float32),
    "float16": np.dtype(np.float16),
    "float64": np.dtype(np.float64),
    "int8": np.dtype(np.int8),
    "uint8": np.dtype(np.uint8),
    "int16": np.dtype(np.int16),
    "int32": np.dtype(np.int32),
    "int64": np.dtype(np.int64),
    "bool": np.dtype(np.bool_),
    "bfloat16": BFLOAT16,
}


def to_np_dtype(name: str) -> np.dtype:
    if name not in _CANONICAL:
        raise ValueError(f"unknown checkpoint dtype {name!r}")
    return _CANONICAL[name]


def dtype_name(dt) -> str:
    dt = np.dtype(dt)
    for name, cand in _CANONICAL.items():
        if dt == cand:
            return name
    raise ValueError(f"unsupported checkpoint dtype {dt!r}")


def is_bfloat16(dt) -> bool:
    return np.dtype(dt) == BFLOAT16


def to_float32(arr: np.ndarray) -> np.ndarray:
    """Exact upcast to float32 (bf16 words shift into the high half)."""
    arr = np.asarray(arr)
    if arr.dtype == BFLOAT16:
        # shifted in place: one pass over the widened copy
        out = arr.astype(np.uint32)
        np.left_shift(out, 16, out=out)
        return out.view(np.float32)
    return np.asarray(arr, dtype=np.float32)


def from_float32(arr: np.ndarray, dt) -> np.ndarray:
    """Downcast float32 to storage dtype ``dt`` (bf16: round half to
    even; every NaN becomes the canonical quiet NaN of its sign, as in
    ``ml_dtypes``)."""
    dt = np.dtype(dt)
    if dt != BFLOAT16:
        return np.asarray(arr).astype(dt)
    u = np.ascontiguousarray(arr, dtype=np.float32).view(np.uint32)
    rounded = (u + (0x7FFF + ((u >> 16) & 1))) >> 16
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    out = np.where(nan, ((u >> 16) & 0x8000) | 0x7FC0, rounded)
    return out.astype(np.uint16)


def as_storage(arr) -> np.ndarray:
    """A host array in storage form: numpy arrays pass through; torch
    tensors (any device) are copied to the host, bf16 as raw words.  A
    CPU tensor is copied too, so the array is a snapshot that a later
    in-place update (an optimizer step) does not reach."""
    if isinstance(arr, np.ndarray):
        return arr
    import torch

    if isinstance(arr, torch.Tensor):
        if hasattr(arr, "full_tensor"):  # a DTensor: its whole value
            arr = arr.full_tensor()
        t = arr.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BFLOAT16)
        return t.numpy()
    return np.asarray(arr)
