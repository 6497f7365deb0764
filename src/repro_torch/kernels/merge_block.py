"""Hopper merge and ANALYZE sketch kernels (``csrc/merge_block.cu``) and
their wrappers.

The CUDA source is compiled on first use with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (:mod:`.build`), cached
under ``build/`` beside this package by the source's hash, and loaded
with ``ctypes``.  Importing this module builds nothing.

Every wrapper takes torch tensors in the executor's batched layout
(see :mod:`repro_torch.kernels.ref`):

* on CPU tensors it runs the plain PyTorch version from ``ref``;
* on CUDA tensors it checks device, dtype, shape and contiguity,
  allocates the output, launches its kernel on the current stream,
  raises on a non-zero CUDA status, and adds one to its entry in
  :data:`LAUNCHES`.  There is no fallback: what the kernel does not
  take raises.

The kernels replace the Pallas kernels of the JAX package's
``kernels/merge_block.py`` (``_linear_kernel``, ``_ties_kernel``,
``_dare_kernel``, ``_sketch_kernel``) and, in
:func:`ties_thresholds`, the XLA sort that computes the TIES trim
threshold outside the Pallas kernel (``kernels/ref.py``
``ties_thresholds``); the source says what bounds them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES = {"linear_merge": 0, "ties_merge": 0, "dare_merge": 0,
            "sketch_blocks": 0, "ties_threshold": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f, d = ctypes.c_float, ctypes.c_double
    lib.mb_linear.argtypes = [p, p, p, i, i, ll, f, f, p]
    lib.mb_ties.argtypes = [p, p, p, p, i, i, ll, d, p]
    lib.mb_dare.argtypes = [p, p, p, p, i, i, ll, f, f, p]
    lib.mb_sketch.argtypes = [p, p, i, ll, p]
    lib.mb_ties_threshold.argtypes = [p, p, i, ll, i, p]
    for fn in (lib.mb_linear, lib.mb_ties, lib.mb_dare, lib.mb_sketch,
               lib.mb_ties_threshold):
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("merge_block.cu", _declare)


def _check(name: str, x0: torch.Tensor, D: torch.Tensor, extras) -> None:
    """Validate the kernel's operands (all on one CUDA device)."""
    if x0.dim() != 2 or D.dim() != 3:
        raise ValueError(f"{name}: want x0 (NB, W) and D (NB, K, W)")
    nb, k, w = D.shape
    if tuple(x0.shape) != (nb, w):
        raise ValueError(f"{name}: x0 {tuple(x0.shape)} vs D {tuple(D.shape)}")
    if nb == 0 or k == 0 or w == 0 or nb > 65535:
        raise ValueError(f"{name}: unsupported shape {tuple(D.shape)}")
    for t, dtype, shape in [(x0, torch.float32, None), (D, torch.float32, None),
                            *extras]:
        if t.device != D.device or t.device.type != "cuda":
            raise ValueError(f"{name}: operands must share one CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: operand shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _launch(name: str, fn, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with status {rc}")
    LAUNCHES[name] += 1


def linear_merge(
    x0: torch.Tensor, D: torch.Tensor, mul: float = 1.0, div: float = 1.0
) -> torch.Tensor:
    """out = x0 + (mul · Σ_k Δ_k) / div.  AVG: mul=1, div=K+1; TA: mul=λ."""
    if x0.device.type == "cpu":
        return ref.linear_ref(x0, D, mul, div)
    _check("linear_merge", x0, D, [])
    lib = LIBRARY.load()
    nb, k, w = D.shape
    out = torch.empty_like(x0)
    with torch.cuda.device(D.device):
        _launch("linear_merge", lib.mb_linear, x0.data_ptr(), D.data_ptr(),
                out.data_ptr(), nb, k, w, mul, div)
    return out


def ties_thresholds(D: torch.Tensor, trim_frac: float) -> torch.Tensor:
    """(NB, K, W) float32 -> (NB, K) float32: the keep-th largest |Δ| of
    each row, ``keep = ref.ties_keep(trim_frac, W)``; ``-inf`` without a
    launch when every entry is kept.  Bit for bit ``np.partition``'s
    threshold (NaN sorts above +inf and keeps its payload) and
    ``torch.kthvalue``'s, except that on the card ``kthvalue`` returns any
    NaN as 0x7FFFFFFF."""
    if D.device.type == "cpu":
        return ref.ties_thresholds(D, trim_frac)
    if D.dim() != 3:
        raise ValueError("ties_thresholds: want D (NB, K, W)")
    nb, k, w = D.shape
    if nb * k == 0 or w == 0 or nb * k > 2**31 - 1 or w > 2**31 - 1:
        raise ValueError(f"ties_thresholds: unsupported shape {tuple(D.shape)}")
    if D.device.type != "cuda":
        raise ValueError("ties_thresholds: D must lie on a CUDA device")
    if D.dtype != torch.float32:
        raise ValueError(f"ties_thresholds: want torch.float32, got {D.dtype}")
    if not D.is_contiguous():
        raise ValueError("ties_thresholds: D must be contiguous")
    keep = ref.ties_keep(trim_frac, w)
    if keep >= w:
        return torch.full((nb, k), float("-inf"), dtype=torch.float32,
                          device=D.device)
    lib = LIBRARY.load()
    out = torch.empty((nb, k), dtype=torch.float32, device=D.device)
    with torch.cuda.device(D.device):
        _launch("ties_threshold", lib.mb_ties_threshold, D.data_ptr(),
                out.data_ptr(), nb * k, w, keep)
    return out


def ties_merge(
    x0: torch.Tensor, D: torch.Tensor, thresh: torch.Tensor, lam: float = 1.0
) -> torch.Tensor:
    """TIES given per-(block, expert) trim thresholds (NB, K)."""
    if x0.device.type == "cpu":
        return ref.ties_apply_ref(x0, D, thresh, lam)
    nb, k, w = D.shape
    _check("ties_merge", x0, D, [(thresh, torch.float32, (nb, k))])
    lib = LIBRARY.load()
    out = torch.empty_like(x0)
    with torch.cuda.device(D.device):
        _launch("ties_merge", lib.mb_ties, x0.data_ptr(), D.data_ptr(),
                thresh.data_ptr(), out.data_ptr(), nb, k, w, lam)
    return out


def dare_merge(
    x0: torch.Tensor,
    D: torch.Tensor,
    masks: torch.Tensor,
    density: float = 0.5,
    lam: float = 1.0,
) -> torch.Tensor:
    """out = x0 + λ · Σ_k(m_k ? Δ_k / density : 0); masks uint8 or bool."""
    if x0.device.type == "cpu":
        return ref.dare_ref(x0, D, masks, density, lam)
    if masks.dtype == torch.bool:
        masks = masks.view(torch.uint8)  # one byte, 0 or 1: same storage
    _check("dare_merge", x0, D, [(masks, torch.uint8, tuple(D.shape))])
    lib = LIBRARY.load()
    nb, k, w = D.shape
    out = torch.empty_like(x0)
    with torch.cuda.device(D.device):
        _launch("dare_merge", lib.mb_dare, x0.data_ptr(), D.data_ptr(),
                masks.data_ptr(), out.data_ptr(), nb, k, w, density, lam)
    return out


def sketch_blocks(x: torch.Tensor) -> torch.Tensor:
    """(NB, W) float32 -> (NB, 3) float32 per-row [Σx², max|x|, Σx]."""
    if x.device.type == "cpu":
        return ref.sketch_ref(x)
    if x.dim() != 2:
        raise ValueError("sketch_blocks: want x (NB, W)")
    nb, w = x.shape
    if nb == 0 or w == 0 or nb > 2**31 - 1:
        raise ValueError(f"sketch_blocks: unsupported shape {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError("sketch_blocks: x must lie on a CUDA device")
    if x.dtype != torch.float32:
        raise ValueError(f"sketch_blocks: want torch.float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("sketch_blocks: x must be contiguous")
    lib = LIBRARY.load()
    out = torch.empty((nb, 3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("sketch_blocks", lib.mb_sketch, x.data_ptr(), out.data_ptr(),
                nb, w)
    return out
