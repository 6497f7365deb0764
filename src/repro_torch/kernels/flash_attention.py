"""Hopper flash-attention kernel (``csrc/flash_attention.cu``) and its
wrapper.

:func:`flash_attention` takes the JAX package's layout, q (B, Sq, H, hd)
and k / v (B, Sk, Hkv, hd):

* on CPU tensors it runs the plain version,
  :func:`repro_torch.kernels.ref.flash_attention_ref`, with the given
  chunk sizes and ``skip_masked_chunks``;
* otherwise it checks the operands (one CUDA device, float32 or bfloat16,
  ``hdv == hd`` in :data:`HEAD_DIMS`, unit stride on the head dim, no
  gradient), allocates the output in q's dtype, launches the kernel on
  the current stream, raises on a non-zero CUDA status and adds one to
  ``LAUNCHES["flash_attention"]``.  The kernel always bounds its key loop
  to the causal / window reach (skipping a fully masked tile is exact),
  so ``cq``, ``ck`` and ``skip_masked_chunks`` do not change its result.

Forward only: an operand that requires grad raises (the backward comes
with training).  The kernel replaces the Pallas kernel
``flash_attention_pallas`` of the JAX package's
``kernels/flash_attention.py``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

#: launches since the last :func:`reset_launches`
LAUNCHES = {"flash_attention": 0}
#: head dims the kernel is built for (hdv == hd)
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fa_forward.argtypes = [p, p, p, p, ctypes.POINTER(ctypes.c_longlong),
                               i, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.fa_forward.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attention.cu", _declare)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int, q_offset: int) -> None:
    """Validate the kernel's operands; raise on what it does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: want q (B, Sq, H, hd), "
                         "k and v (B, Sk, Hkv, hd)")
    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    if (k.shape[0] != b or k.shape[3] != hd or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if v.shape[3] != hd:
        raise ValueError(f"flash_attention: hdv {v.shape[3]} != hd {hd} "
                         "is not ported yet")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if min(b, sq, sk, h, hkv) == 0 or h % hkv != 0:
        raise ValueError(f"flash_attention: unsupported shape q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if b * h > 65535 or max(sq, sk) + q_offset > _INT32_MAX:
        raise ValueError("flash_attention: shape beyond the kernel's grid")
    if window < 0 or q_offset < 0:
        raise ValueError("flash_attention: window and q_offset must be >= 0")
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("flash_attention: operands must share one CUDA "
                             "device")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: want float32 or bfloat16 "
                             f"operands of one dtype, got {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError("flash_attention: the head dim must have "
                             "stride 1")
        if t.requires_grad:
            raise ValueError("flash_attention: forward only; an operand "
                             "requires grad")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    cq: int = 512,
    ck: int = 1024,
    skip_masked_chunks: bool = False,
) -> torch.Tensor:
    """Attention of q over k / v; (B, Sq, H, hd) in q's dtype."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.flash_attention_ref(q, k, v, causal, window, q_offset,
                                       cq, ck, skip_masked_chunks)
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window, q_offset)
    lib = LIBRARY.load()
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, out) for s in t.stride()[:3]])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, sq, sk, h, hkv, hd, int(bool(causal)), window, q_offset,
            1.0 / math.sqrt(hd), _DTYPES[q.dtype], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"status {rc}")
    LAUNCHES["flash_attention"] += 1
    return out
