"""Int8 gradient compression with error feedback — the JAX package's
``train/grad_compress.py`` in torch (off by default).

Gradients are quantized to int8 with a per-tensor scale and the
quantization residual is kept as error feedback, added to the next
step's gradient (1-bit Adam / EF-SGD).  On one card nothing is
all-reduced, so this only reproduces the numerics: the same int8 values
and the same residuals as the reference (``torch.round`` rounds half to
even, as ``jnp.round`` does).  Enabled by ``--grad-compress``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

Tree = Mapping[str, torch.Tensor]


def init_error_feedback(params: Tree) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_decompress(grads: Tree, ef: Tree) -> Tuple[Dict[str, torch.Tensor],
                                                        Dict[str, torch.Tensor]]:
    """Returns (decompressed grads, new error-feedback state)."""
    out_g, out_e = {}, {}
    for n, g in grads.items():
        gf = g.float() + ef[n]
        q, scale = _quantize(gf)
        deq = q.float() * scale
        out_g[n], out_e[n] = deq.to(g.dtype), gf - deq
    return out_g, out_e
