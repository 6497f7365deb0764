"""``merge_blocks`` and ``sketch_blocks`` — the executor's entry to the
merge kernels and ANALYZE's entry to the sketch kernel.

``merge_blocks(op, x0s, Ds, theta, masks=None, device=...)`` has the JAX
package's signature and result (a float32 ``(NB, W)`` ndarray) plus the
device to run on:

    * a CUDA device -> the Hopper kernels of :mod:`.merge_block`
      (launched, or raising — never a quiet CPU run);
    * ``"cpu"``     -> their plain PyTorch versions (:mod:`.ref`).

Inputs are staged to the device as they come: base blocks in their
storage dtype (bf16 as its raw 16-bit words, half the bytes of float32)
and upcast there; deltas as float32.  ``out_dtype`` casts the result on
the device before the copy back, so a bf16 merge returns half the bytes.
The TIES trim threshold (the keep-th largest |Δ| per row) comes from its
own kernel on a CUDA device (:func:`.merge_block.ties_thresholds`, a
radix select), where the JAX package leaves it to an XLA sort outside
its Pallas kernel; on the CPU from ``torch.kthvalue``.

``sketch_blocks(x, device=..., widths=None)`` is the counterpart of the
JAX package's ``kernels/ops.sketch_blocks``: (NB, W) blocks ->
(NB, 3) float32 ``[l2, absmax, mean]``, through the sketch kernel on a
CUDA device.  The mean divides by each row's true element count
(``widths``, default W), as ``np.mean`` of the unpadded block does;
zero padding leaves Σx², Σx and max|x| exact.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch.kernels import merge_block as mb
from repro_torch.store import dtypes

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float64,
}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """A CUDA device that is not there raises; it never becomes the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run the plain versions on the host)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Stage a host block stack on ``device`` as float32."""
    arr = np.ascontiguousarray(arr)
    if dtypes.is_bfloat16(arr.dtype):
        t = torch.from_numpy(arr.view(np.int16)).to(device)
        return t.view(torch.bfloat16).float()
    return torch.from_numpy(arr).to(device).float()


def from_device(out: torch.Tensor, out_dtype) -> np.ndarray:
    """Cast on the device, then copy to the host in storage form."""
    dt = np.dtype(out_dtype)
    if dtypes.is_bfloat16(dt):
        words = out.to(torch.bfloat16).view(torch.int16).cpu().numpy()
        return words.view(dtypes.BFLOAT16)
    return out.to(_TORCH_DTYPES[dt]).cpu().numpy()


def merge_blocks(
    op: str,
    x0s,
    Ds,
    theta: Dict,
    masks=None,
    device: Union[str, torch.device] = "cuda",
    out_dtype=np.float32,
) -> np.ndarray:
    """Apply operator ``op`` to a batch of blocks.

    x0s (NB, W) in any checkpoint float dtype; Ds (NB, K, W) float;
    masks (NB, K, W) bool for DARE.  Returns an ``out_dtype`` ndarray
    (NB, W), float32 by default.
    """
    dev = resolve_device(device)
    x0 = to_device(x0s, dev)
    D = to_device(Ds, dev)
    lam = float(theta.get("lam", 1.0))
    op = op.lower()
    if op == "avg":
        out = mb.linear_merge(x0, D, 1.0, float(D.shape[1] + 1))
    elif op == "ta":
        out = mb.linear_merge(x0, D, lam, 1.0)
    elif op == "ties":
        thresh = mb.ties_thresholds(D, float(theta.get("trim_frac", 0.2)))
        out = mb.ties_merge(x0, D, thresh, lam)
    elif op == "dare":
        if masks is None:
            raise ValueError("dare requires masks")
        m = torch.from_numpy(np.ascontiguousarray(masks, dtype=np.bool_)).to(dev)
        out = mb.dare_merge(x0, D, m, float(theta.get("density", 0.5)), lam)
    else:
        raise KeyError(f"unknown operator {op!r}")
    return from_device(out, out_dtype)


def sketch_blocks(x, device: Union[str, torch.device] = "cuda",
                  widths=None) -> np.ndarray:
    """(NB, W) -> (NB, 3) float32 ``[l2, absmax, mean]``.

    ``x`` is a host block stack in any checkpoint float dtype (staged as
    :func:`to_device` does: bf16 as raw words, upcast on the device) or a
    tensor, moved to ``device`` as float32 if it is not there already.
    ``widths`` (NB,) are the rows' true element counts when rows carry
    zero padding."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        xt = x.to(device=dev, dtype=torch.float32).contiguous()
    else:
        xt = to_device(x, dev)
    nb, w = xt.shape
    stats = mb.sketch_blocks(xt).cpu().numpy()
    n = (np.full(nb, w, dtype=np.float32) if widths is None
         else np.asarray(widths, dtype=np.float32))
    return np.stack([np.sqrt(stats[:, 0]), stats[:, 1], stats[:, 2] / n],
                    axis=1)
