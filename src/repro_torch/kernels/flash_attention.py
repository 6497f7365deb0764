"""Hopper flash-attention kernels (``csrc/flash_attention.cu``) and their
wrapper.

:func:`flash_attention` takes the JAX package's layout, q (B, Sq, H, hd)
and k / v (B, Sk, Hkv, hd):

* on CPU tensors it runs the plain version,
  :func:`repro_torch.kernels.ref.flash_attention_ref`, with the given
  chunk sizes and ``skip_masked_chunks``;
* otherwise it checks the operands (one CUDA device, float32 or bfloat16,
  ``hdv == hd`` in :data:`HEAD_DIMS`, unit stride on the head dim, no
  gradient), picks a kernel by :func:`_route`, allocates the output in
  q's dtype, launches the kernel on the current stream, raises on a
  non-zero CUDA status and adds one to ``LAUNCHES["flash_attention"]``
  (every launch) and, on the tensor-core route, to
  ``LAUNCHES["flash_attention_tc"]``.  Both kernels bound their key loop
  to the causal / window reach (skipping a fully masked tile is exact),
  so ``cq``, ``ck`` and ``skip_masked_chunks`` do not change the result.

The route rule (:func:`_route`): bfloat16 with hd in
:data:`TC_HEAD_DIMS` runs ``flash_attention_tc_kernel`` (tensor cores,
``wgmma``; q, k, v need 16-byte-aligned storage and b / s / h
strides in multiples of 8 elements, else the wrapper raises); float32,
and bfloat16 with hd = 8, run ``flash_attention_kernel`` (float32 FMAs).
Nothing falls back from one route to the other.

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

#: launches since the last :func:`reset_launches`: every launch, and
#: those of the tensor-core route
LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0}
#: head dims the kernels are built for (hdv == hd)
HEAD_DIMS = (8, 16, 32, 64, 128)
#: head dims of the tensor-core route (bfloat16 only)
TC_HEAD_DIMS = (16, 32, 64, 128)
ROUTES = ("tc", "fma")
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
    lib.fa_forward_tc.argtypes = lib.fa_forward.argtypes[:-2] + [p]
    lib.fa_forward_tc.restype = ctypes.c_int


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


def _route(dtype: torch.dtype, hd: int) -> str:
    """The kernel for operands of ``dtype`` and head dim ``hd``: ``"tc"``
    (tensor cores) for bfloat16 with hd in :data:`TC_HEAD_DIMS`, else
    ``"fma"`` (float32 FMAs)."""
    return "tc" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "fma"


def _check_tc(*tensors: torch.Tensor) -> None:
    """The tensor-core route's 16-byte copies: raise unless every operand
    starts on a 16-byte boundary and its b, s and h strides (of the
    dimensions longer than 1) are multiples of 8 elements."""
    for t in tensors:
        if t.data_ptr() % 16 != 0:
            raise ValueError("flash_attention: the tensor-core route needs "
                             "16-byte-aligned operands")
        if any(n > 1 and st % 8 != 0
               for n, st in zip(t.shape[:3], t.stride()[:3])):
            raise ValueError(f"flash_attention: the tensor-core route needs "
                             f"strides in multiples of 8 elements (16 "
                             f"bytes), got {t.stride()}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int, q_offset: int, route: str) -> torch.Tensor:
    """Check the operands and launch the ``route`` kernel ("tc" or
    "fma") on CUDA tensors.  :func:`flash_attention` passes
    :func:`_route`'s choice; a caller may name the other route only to
    time or test it."""
    if route not in ROUTES:
        raise ValueError(f"flash_attention: route {route!r} not in {ROUTES}")
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window, q_offset)
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if route == "tc":
        if _route(q.dtype, hd) != "tc":
            raise ValueError(f"flash_attention: the tensor-core route takes "
                             f"bfloat16 with hd in {TC_HEAD_DIMS}, got "
                             f"{q.dtype}, hd {hd}")
        _check_tc(q, k, v)
    lib = LIBRARY.load()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    # a dimension of length 1 is never stepped over: its stride is 0 here
    strides = (ctypes.c_longlong * 12)(
        *[st if n > 1 else 0 for t in (q, k, v, out)
          for n, st in zip(t.shape[:3], t.stride()[:3])])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, sq, sk, h, hkv, hd, int(bool(causal)), window, q_offset,
            1.0 / math.sqrt(hd))
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = (lib.fa_forward_tc(*args, stream) if route == "tc" else
              lib.fa_forward(*args, _DTYPES[q.dtype], stream))
    if rc != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"status {rc}")
    LAUNCHES["flash_attention"] += 1
    if route == "tc":
        LAUNCHES["flash_attention_tc"] += 1
    return out


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
    return launch(q, k, v, causal, window, q_offset,
                  _route(q.dtype, q.shape[-1]))
