"""Hopper flash-attention kernels (``csrc/flash_attention.cu``, the
forward; ``csrc/flash_attention_bwd.cu``, the backward; two libraries
that build in parallel) and their wrapper.

:func:`flash_attention` takes the JAX package's layout, q (B, Sq, H, hd),
k (B, Sk, Hkv, hd) and v (B, Sk, Hkv, hdv), and returns (B, Sq, H, hdv):

* on CPU (or ``meta``: the dry-run) tensors it runs the plain version,
  :func:`repro_torch.kernels.ref.flash_attention_ref`, with the given
  chunk sizes and ``skip_masked_chunks``;
* otherwise it checks the operands (one CUDA device, float32 or bfloat16,
  ``(hd, hdv)`` in :data:`HEAD_DIMS`, unit stride on the head dim, no
  gradient), picks a kernel by :func:`_route`, allocates the output in
  q's dtype, launches the kernel on the current stream, raises on a
  non-zero CUDA status and adds one to ``LAUNCHES["flash_attention"]``
  (every launch) and, on the tensor-core routes, to
  ``LAUNCHES["flash_attention_tc"]`` (bfloat16) or
  ``LAUNCHES["flash_attention_tf32x3"]`` (float32).  Every kernel bounds
  its key loop to the causal / window reach (skipping a fully masked tile
  is exact), so ``cq``, ``ck`` and ``skip_masked_chunks`` do not change
  the result.

The route rule (:func:`_route`): bfloat16 with (hd, hdv) in
:data:`TC_HEAD_DIMS` takes the tensor cores (``wgmma``; q, k, v need
16-byte-aligned storage and b / s / h strides in multiples of 8
elements, else the wrapper raises): ``flash_attention_tc_kernel`` (one
warpgroup a CTA) up to hd 128, ``flash_attention_ws_kernel`` past it (a
TMA producer warpgroup and two consumer warpgroups of 64 query rows
each, taking turns on the tensor cores), and at a pair of
:data:`NARROW_PAIRS` with at most :data:`NARROW_MAX_LEN` keys
``flash_attention_narrow_kernel`` (a cluster of four one-warpgroup CTAs
a q tile, one key tile each, widths padded to the next k16 step;
``LAUNCHES["flash_attention_narrow"]``), and at a pair of
:data:`SPLIT_PAIRS`, for a launch without a mask whose CTAs leave SMs
idle (:func:`_split`), ``flash_attention_ws_kernel`` split over a
cluster (its CTAs share a 128-row q tile and split its key range;
``LAUNCHES["flash_attention_split"]``); float32 with (hd, hdv) in
:data:`TC_HEAD_DIMS` takes the tensor cores too (``"tf32x3"``, the same
alignment in 16 bytes: strides in multiples of 4 elements):
``flash_attention_tf32_kernel``, each float32 product as three TF32
products of split operands (a = hi + lo: hi.hi + hi.lo + lo.hi), as
accurate as float32's FMAs within the float32 tolerance; hd = 8 (either
dtype) runs ``flash_attention_kernel`` (float32 FMAs), which any pair
also takes when a caller names ``"fma"``.  Nothing falls back
from one route to another.  hd ≠ hdv is DeepSeek-V2's MLA: (192, 128)
published, (24, 16) in its smoke config; (256, 256) is RecurrentGemma's
local attention; a pair outside :data:`HEAD_DIMS` has no kernel and
raises ``ValueError`` from the shapes alone, before any device work.
:func:`forward_plan` gives a launch's kernel, grid, threads and shared
memory from the shapes alone, :func:`forward_tile_work` each
warpgroup's role and tensor work a tile, :func:`tc_attributes` (card
only) what the loaded library's launch uses.

The gradient: where grad mode is on and an operand requires grad,
:func:`flash_attention` on CUDA tensors goes through
:class:`FlashAttentionFn`, whose forward launches the routed kernel with
its per-row log-sum-exp (``lse``, float32 (B, H, Sq)) and whose backward
launches the backward kernels (:func:`backward`), routed by the same
rule (but float32 at :data:`FMA_BACKWARD_PAIRS`, which keeps the FMA
backward), at every pair of :data:`HEAD_DIMS`:

* ``"tc"`` (bfloat16, (hd, hdv) in :data:`TC_HEAD_DIMS`):
  ``fa_backward_tc``, four kernels: ``D = rowsum(dO o)`` over hdv
  (16-byte loads), then on the tensor cores dK / dV per (query head, key
  tile) into float32 partials ((B, Sk, H, hd) and (B, Sk, H, hdv)), their
  sum over the g query heads of each kv head in head order (only where H
  > Hkv), and dQ per query tile; past hd 128 each CTA is two warpgroups
  that split a tile's queries (dK / dV) or keys (dQ), so S and dP are
  computed once a tile (:func:`backward_tile_work`); operands aligned as
  the forward's
  tensor-core route wants (a misaligned upstream gradient is copied, q, k
  and v raise); ``LAUNCHES["flash_attention_bwd_tc"]``; at a pair of
  :data:`NARROW_PAIRS` with at most :data:`NARROW_MAX_LEN` queries and
  keys, one launch, ``fa_backward_narrow`` (a cluster of four CTAs per
  (b, kv head), one a query tile: D, dQ, dK and dV in one kernel;
  ``LAUNCHES["flash_attention_bwd_narrow"]``); at (64, 64) with H ==
  Hkv (:func:`_one_grid`), ``fa_backward_tc`` with ``one_grid``: D, then
  the dK / dV and the dQ CTAs in one grid, ``fa_bwd_dkdv_dq_tc_kernel``
  (``LAUNCHES["flash_attention_bwd_one_grid"]``);
* ``"tf32x3"`` (float32, (hd, hdv) in :data:`TC_HEAD_DIMS` but
  :data:`FMA_BACKWARD_PAIRS`): ``fa_backward_tf32``, the FMA route's ``D``, then on the tensor cores
  as split TF32 dK / dV per (query head, key tile of 32 keys, 16 at
  (256, 256)) and dQ per query tile, one warpgroup a CTA, with the same
  GQA reduction; operands aligned as the forward's tensor-core routes
  want (a misaligned upstream gradient is copied, q, k and v raise);
  ``LAUNCHES["flash_attention_bwd_tf32x3"]``;
* ``"fma"`` (hd 8, either dtype; float32 at
  :data:`FMA_BACKWARD_PAIRS`; any pair when named): ``fa_backward``,
  three kernels of float32 FMAs (``D``, dK / dV per query head and key
  tile, dQ; 32-row streamed tiles past hd 128), and the same GQA
  reduction of float32 partials where H > Hkv.

Both are deterministic (no float atomics); ``LAUNCHES
["flash_attention_bwd"]`` counts every backward call.
:func:`backward_plan` gives a route's launches and scratch from the
shapes alone.  :func:`launch` itself stays forward only and raises on an
operand that requires grad.
On CPU tensors autograd runs through the plain version.  The backward
takes ``q_offset = 0`` (training); any other ``q_offset`` raises.  Nothing
falls back to the plain version on the card.

Under a device mesh the operands are DTensors, and :func:`flash_attention`
runs each rank's shard through ``local_map`` (the reference's GSPMD
partitions its attention the same way): per mesh dim, a batch shard of q
takes k and v batch-sharded too, a head shard stays where q, k and v are
all head-sharded, and any other layout (a head-sharded q over replicated
kv heads, a sequence-sharded KV cache, a partial sum) is gathered first
(:func:`local_placements`).  The local call is the same wrapper on plain
tensors, so the card's shards launch the kernels, forward and backward,
and nothing routes to the plain version because an input is a DTensor.

The forward kernels replace the Pallas kernel ``flash_attention_pallas``
of the JAX package's ``kernels/flash_attention.py``; the JAX package has
no backward kernel (XLA differentiates its jnp attention).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

#: launches since the last :func:`reset_launches`: every forward launch,
#: those of the tensor-core route, every backward call (each one call of
#: ``fa_backward``, ``fa_backward_tc``, ``fa_backward_narrow`` or
#: ``fa_backward_tf32``: all its kernels), and those of the tensor-core
#: route; of these, the narrow forward's and the one-launch backward's
#: (:data:`NARROW_PAIRS`); the float32 tensor-core route's forward
#: launches and backward calls (``"tf32x3"``)
LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
            "flash_attention_narrow": 0, "flash_attention_bwd_narrow": 0,
            "flash_attention_split": 0, "flash_attention_bwd_one_grid": 0,
            "flash_attention_tf32x3": 0, "flash_attention_bwd_tf32x3": 0}
#: (hd, hdv) pairs the forward kernels are built for: q.k's head dim and
#: v's; (24, 16) and (192, 128) are DeepSeek-V2-Lite's MLA (smoke,
#: published), (256, 256) RecurrentGemma-9B's local attention
HEAD_DIMS = ((8, 8), (16, 16), (24, 16), (32, 32), (64, 64), (128, 128),
             (192, 128), (256, 256))
#: the pairs of the tensor-core forward and backward: bfloat16 on
#: ``"tc"``, float32 on ``"tf32x3"`` (split TF32)
TC_HEAD_DIMS = tuple(p for p in HEAD_DIMS if p[0] >= 16)
ROUTES = ("tc", "tf32x3", "fma")
#: the pairs whose float32 backward stays on the FMA kernels
#: (:func:`_route`): there the "tf32x3" backward lost to them in turns
FMA_BACKWARD_PAIRS = ((16, 16),)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the tensor-core pairs with a narrow CTA for short sequences: the forward
#: ``flash_attention_narrow_kernel`` where Sk <= :data:`NARROW_MAX_LEN`,
#: the one-launch backward ``fa_bwd_narrow_tc_kernel`` where Sq and Sk are
#: (DeepSeek-V2-Lite's smoke pair); longer shapes take the pair's general
#: kernels
NARROW_PAIRS = ((24, 16),)
#: the narrow kernels' warpgroups a q tile, one 64-key tile each (the
#: forward: four one-warpgroup CTAs of a cluster; the backward: a
#: cluster of four CTAs, one a query tile, of four warpgroups each)
_NARROW_WARPGROUPS = 4
NARROW_MAX_LEN = 64 * _NARROW_WARPGROUPS
#: the tensor-core pairs whose forward runs the warp-specialised CTA split
#: over a cluster (:func:`_split`): unmasked launches that leave SMs idle
SPLIT_PAIRS = ((64, 64),)
#: the H100's SMs, and the most CTAs of a split cluster
_SMS = 132
_MAX_SPLIT = 4
#: keys a tile of the float32 tensor-core forward
_TF32_KEYS = 32
#: rows and keys per tile of the backward kernels; threads of a CTA of the
#: preprocess kernel and of the GQA reduction (four elements a thread)
_TILE = 64
_BWD_THREADS = 256
_INT32_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_STRIDES = ctypes.POINTER(ctypes.c_longlong)


def _declare_forward(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # q, k, v, o, strides, b, sq, sk, h, hkv, hd, hdv, causal, window,
    # q_offset, scale, lse, [dtype,] stream
    lib.fa_forward.argtypes = [p, p, p, p, _STRIDES,
                               i, i, i, i, i, i, i, i, i, i, f, p, i, p]
    lib.fa_forward.restype = ctypes.c_int
    lib.fa_forward_tc.argtypes = lib.fa_forward.argtypes[:-2] + [p]
    lib.fa_forward_tc.restype = ctypes.c_int
    lib.fa_forward_narrow.argtypes = lib.fa_forward_tc.argtypes
    lib.fa_forward_narrow.restype = ctypes.c_int
    # ..., lse, cluster, stream
    lib.fa_forward_split.argtypes = lib.fa_forward_tc.argtypes[:-1] + [i, p]
    lib.fa_forward_split.restype = ctypes.c_int
    lib.fa_forward_tf32.argtypes = lib.fa_forward_tc.argtypes
    lib.fa_forward_tf32.restype = ctypes.c_int
    for name in ("tc", "narrow", "split", "tf32"):
        fn = getattr(lib, f"fa_forward_{name}_attributes")
        fn.argtypes = [i, i, ctypes.POINTER(i)]
        fn.restype = ctypes.c_int


def _declare_backward(lib: ctypes.CDLL) -> None:
    p, i, f, strides = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, _STRIDES
    # q, k, v, o, dO, lse, delta, dq, dk, dv, dk_part, dv_part, strides,
    # b, sq, sk, h, hkv, hd, hdv, causal, window, scale, [dtype,] stream
    lib.fa_backward.argtypes = [p] * 12 + [strides] + [i] * 9 + [f, i, p]
    lib.fa_backward.restype = ctypes.c_int
    # ..., scale, one_grid, stream
    lib.fa_backward_tc.argtypes = [p] * 12 + [strides] + [i] * 9 + [f, i, p]
    lib.fa_backward_tc.restype = ctypes.c_int
    # q, k, v, o, dO, lse, dq, dk, dv, strides, b, sq, sk, h, hkv, hd, hdv,
    # causal, window, scale, stream
    lib.fa_backward_narrow.argtypes = [p] * 9 + [strides] + [i] * 9 + [f, p]
    lib.fa_backward_narrow.restype = ctypes.c_int
    # the arguments of fa_backward without dtype
    lib.fa_backward_tf32.argtypes = [p] * 12 + [strides] + [i] * 9 + [f, p]
    lib.fa_backward_tf32.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attention.cu", _declare_forward)
BWD_LIBRARY = CudaLibrary("flash_attention_bwd.cu", _declare_backward)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int, q_offset: int) -> None:
    """Validate the kernel's operands; raise on what it does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: want q (B, Sq, H, hd), "
                         "k (B, Sk, Hkv, hd) and v (B, Sk, Hkv, hdv)")
    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    hdv = v.shape[3]
    if (k.shape[0] != b or k.shape[3] != hd or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    _check_pair(hd, hdv)
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


def _check_pair(hd: int, hdv: int) -> None:
    """Raise ``ValueError`` for head dims no kernel is built for."""
    if (hd, hdv) not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: no kernel is built for head dims (hd {hd}, "
            f"hdv {hdv}); the kernels take (hd, hdv) in {HEAD_DIMS}")


def _route(dtype: torch.dtype, hd: int, hdv: int,
           backward: bool = False) -> str:
    """The kernel for operands of ``dtype`` and head dims ``hd`` (q.k)
    and ``hdv`` (v), with (hd, hdv) in :data:`TC_HEAD_DIMS`: ``"tc"``
    (tensor cores, bf16 operands) for bfloat16, ``"tf32x3"`` (tensor
    cores, each float32 product as three TF32 products of split
    operands: float32-accurate) for float32; else ``"fma"`` (float32
    FMAs: hd 8, and any other dtype).  ``backward``: the gradient's
    kernels, where the float32 pairs of :data:`FMA_BACKWARD_PAIRS` keep
    the FMA route.  Timed in turns with the FMA kernels on an H100 80GB
    HBM3 at 700 W (``chip_smoke.py``'s kernels phase, PERF.md), the
    float32 tensor-core kernels won at every row but one, the
    launch-bound ones too: (24, 16) at (2, 256, 256, 4, 4) 0.0236
    against 0.0290 ms forward and 0.0644 against 0.0709 backward (CUDA
    events).  The one is the hd-16 backward at (1, 512, 512, 4, 2), the
    smoke configs' attention (32 CTAs a kernel): 0.0990 against 0.0984
    ms of device time, 0.1069 against 0.1058 by events; so (16, 16)
    keeps the FMA backward.  The shapes alone decide, before any
    launch."""
    if (hd, hdv) not in TC_HEAD_DIMS:
        return "fma"
    if dtype == torch.bfloat16:
        return "tc"
    if dtype == torch.float32:
        return ("fma" if backward and (hd, hdv) in FMA_BACKWARD_PAIRS
                else "tf32x3")
    return "fma"


def _narrow(hd: int, hdv: int, sq: int, sk: int,
            backward: bool = False) -> bool:
    """Does the tensor-core route take its narrow CTA at these shapes: a
    pair of :data:`NARROW_PAIRS` with Sk (and, for the backward, Sq) at
    most :data:`NARROW_MAX_LEN`?  The shapes alone decide, before any
    launch."""
    return ((hd, hdv) in NARROW_PAIRS and sk <= NARROW_MAX_LEN
            and (not backward or sq <= NARROW_MAX_LEN))


def _split(b: int, sq: int, sk: int, h: int, hkv: int, hd: int, hdv: int,
           causal: bool, window: int) -> int:
    """The CTAs of a cluster over which the tensor-core forward splits a
    q tile's key range, from the shapes alone, or 0
    (``flash_attention_tc_kernel``).  Only a pair of :data:`SPLIT_PAIRS`,
    without a mask (not causal, no window), with at least 128 queries: S
    CTAs a (b, h, 128-row q tile) each walking a share of its key tiles,
    S the most (up to :data:`_MAX_SPLIT` and the key tiles) that the
    :data:`_SMS` SMs hold at once, two CTAs an SM, where that is 2 or
    more.  (A pair of query heads sharing K / V by multicast at (128,
    128), and the split there, lost to the one-warpgroup kernel at
    Llama-3.2-Vision's cross-attention: PERF.md.)"""
    if ((hd, hdv) not in SPLIT_PAIRS or causal or window > 0
            or sq < 2 * _TILE):
        return 0
    split = min(_MAX_SPLIT, 2 * _SMS // (b * h * _cdiv(sq, 2 * _TILE)),
                _cdiv(sk, _TILE))
    return split if split >= 2 else 0


def _one_grid(hd: int, hdv: int, h: int, hkv: int) -> bool:
    """Does the tensor-core backward launch its dK / dV and dQ CTAs in one
    grid: (64, 64) with H == Hkv, every backward of whisper-tiny, where it
    was timed to win?  The shapes alone decide.  The kernels take it at
    any pair up to hd 128 with H == Hkv; the other pairs' rows keep the
    separate launches (PERF.md)."""
    return (hd, hdv) == (64, 64) and h == hkv


def _k16(w: int) -> int:
    """A width padded to the next 16-element wgmma k-step."""
    return -(-w // 16) * 16


def _tc_aligned(t: torch.Tensor) -> bool:
    """Does ``t`` start on a 16-byte boundary, with b, s and h strides (of
    the dimensions longer than 1) in multiples of 16 bytes (8 bfloat16
    elements, 4 float32)?"""
    n16 = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n <= 1 or st % n16 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]))


def _check_tc(*tensors: torch.Tensor) -> None:
    """The tensor-core routes' 16-byte copies: raise unless every operand
    is :func:`_tc_aligned`."""
    for t in tensors:
        if t.data_ptr() % 16 != 0:
            raise ValueError("flash_attention: the tensor-core route needs "
                             "16-byte-aligned operands")
        if not _tc_aligned(t):
            raise ValueError(f"flash_attention: the tensor-core route needs "
                             f"strides in multiples of "
                             f"{16 // t.element_size()} elements (16 "
                             f"bytes), got {t.stride()}")


def _check_named_route(route: str, dtype: torch.dtype, hd: int, hdv: int,
                       what: str = "flash_attention") -> None:
    """A tensor-core route named by a caller must be the one the rule
    gives these operands (``"fma"`` may be named at any pair); ``what``
    prefixes the error."""
    if route not in ROUTES:
        raise ValueError(f"{what}: route {route!r} not in {ROUTES}")
    if route == "tc" and _route(dtype, hd, hdv) != "tc":
        raise ValueError(f"{what}: the tensor-core route takes bfloat16 "
                         f"with (hd, hdv) in {TC_HEAD_DIMS}, got {dtype}, "
                         f"({hd}, {hdv})")
    if route == "tf32x3" and _route(dtype, hd, hdv) != "tf32x3":
        raise ValueError(f"{what}: the tf32x3 route takes float32 with (hd, "
                         f"hdv) in {TC_HEAD_DIMS}, got {dtype}, ({hd}, "
                         f"{hdv})")


def _strides(*tensors: torch.Tensor) -> ctypes.Array:
    """The (b, s, h) element strides of each tensor, in order; a dimension
    of length 1 is never stepped over, so its stride is 0 here."""
    vals = [st if n > 1 else 0 for t in tensors
            for n, st in zip(t.shape[:3], t.stride()[:3])]
    return (ctypes.c_longlong * len(vals))(*vals)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int, q_offset: int, route: str) -> torch.Tensor:
    """Check the operands and launch the ``route`` kernel ("tc",
    "tf32x3" or "fma") on CUDA tensors.  :func:`flash_attention` passes
    :func:`_route`'s choice; a caller may name the other route only to
    time or test it.  Forward only: an operand that requires grad raises
    (:class:`FlashAttentionFn` is the differentiable entry)."""
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention: launch is forward only; an "
                         "operand requires grad")
    return _forward(q, k, v, causal, window, q_offset, route)[0]


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: int, q_offset: int, route: str,
             with_lse: bool = False):
    """Launch the ``route`` forward kernel; returns (out, lse), lse a
    float32 (B, H, Sq) tensor when ``with_lse``, else None."""
    if route not in ROUTES:
        raise ValueError(f"flash_attention: route {route!r} not in {ROUTES}")
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window, q_offset)
    b, sq, h, hd = q.shape
    sk, hkv, hdv = k.shape[1], k.shape[2], v.shape[3]
    if route != "fma":
        _check_named_route(route, q.dtype, hd, hdv)
        _check_tc(q, k, v)
    lib = LIBRARY.load()
    out = torch.empty((b, sq, h, hdv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _strides(q, k, v, out), b, sq, sk, h, hkv, hd, hdv,
            int(bool(causal)), window, q_offset, 1.0 / math.sqrt(hd),
            lse.data_ptr() if with_lse else None)
    narrow = route == "tc" and _narrow(hd, hdv, sq, sk)
    split = (_split(b, sq, sk, h, hkv, hd, hdv, causal, window)
             if route == "tc" and not narrow else 0)
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if route == "fma":
            rc = lib.fa_forward(*args, _DTYPES[q.dtype], stream)
        elif route == "tf32x3":
            rc = lib.fa_forward_tf32(*args, stream)
        elif narrow:
            rc = lib.fa_forward_narrow(*args, stream)
        elif split:
            rc = lib.fa_forward_split(*args, split, stream)
        else:
            rc = lib.fa_forward_tc(*args, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"status {rc}")
    LAUNCHES["flash_attention"] += 1
    if route == "tc":
        LAUNCHES["flash_attention_tc"] += 1
    if route == "tf32x3":
        LAUNCHES["flash_attention_tf32x3"] += 1
    if narrow:
        LAUNCHES["flash_attention_narrow"] += 1
    if split:
        LAUNCHES["flash_attention_split"] += 1
    return out, lse


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tf32_q_reg_steps(hd: int) -> int:
    """Q's k8 steps the float32 tensor-core forward holds in registers:
    12 of 24 at hd 192 (so that two CTAs share an SM), none elsewhere."""
    return 12 if hd == 192 else 0


def _w32(w: int) -> int:
    """A width padded to whole 32-float (128-byte) rows of a swizzle atom."""
    return _cdiv(w, 32) * 32


def forward_plan(b: int, sq: int, sk: int, h: int, hkv: int, hd: int,
                 dtype: torch.dtype, route: str | None = None, *,
                 hdv: int | None = None, causal: bool = True,
                 window: int = 0) -> dict:
    """The forward's launch for these shapes, from the shapes alone (the
    constants of ``csrc/flash_attention.cu``): ``route`` (None takes
    :func:`_route`), the ``kernel``'s name, its ``grid``, ``threads`` a
    CTA, ``rows`` (queries a CTA), ``smem_bytes`` (dynamic shared memory)
    and ``static_smem_bytes`` (the warp-specialised kernel's mbarriers,
    as ptxas counts them); past hd 128 also ``stages``, the K / V ring's
    slots.  At a pair of :data:`NARROW_PAIRS` with sk at most
    :data:`NARROW_MAX_LEN` the tensor-core route takes the narrow CTAs:
    a ``cluster`` of four one-warpgroup CTAs a q tile, one key tile
    each.  At a pair of :data:`SPLIT_PAIRS` without a mask (``causal``
    False, ``window`` 0) :func:`_split` may split the warp-specialised CTA
    over a ``cluster`` of that many CTAs.  The ``"tf32x3"`` route
    (float32) is ``flash_attention_tf32_kernel``: one warpgroup a 64-row q
    tile over tiles of ``keys`` (32) keys.
    ``hdv`` defaults to ``hd``.  Raises ``ValueError`` for a pair outside
    :data:`HEAD_DIMS`, an unknown route or a tensor-core route that the
    dtype or head dims do not take."""
    hdv = hd if hdv is None else hdv
    _check_pair(hd, hdv)
    if route is None:
        route = _route(dtype, hd, hdv)
    _check_named_route(route, dtype, hd, hdv)
    if route == "tf32x3":
        # K (32 keys, hd padded to whole 32-float atom rows) and V^T (hdv
        # rows of 32 keys), each with its lo part; Q's rows past the k-steps
        # held in registers (``q_reg_steps``), pitch their width + 4
        # floats; 1,024 bytes of alignment slack
        keys, qr = _TF32_KEYS, _tf32_q_reg_steps(hd)
        return {"route": route, "kernel": "flash_attention_tf32_kernel",
                "grid": (b * h, _cdiv(sq, _TILE)), "threads": 128,
                "rows": _TILE, "keys": keys, "q_reg_steps": qr,
                "smem_bytes": 2 * 4 * keys * (_w32(hd) + hdv)
                + _TILE * (hd - 8 * qr + 4) * 4 + 1024,
                "static_smem_bytes": 0}
    if route == "fma":   # float32 tiles: Q, K (padded), V, P, m / l / alpha
        floats = (_TILE * hd + _TILE * (hd + 1) + _TILE * hdv
                  + _TILE * (_TILE + 1) + 3 * _TILE)
        return {"route": route, "kernel": "flash_attention_kernel",
                "grid": (_cdiv(sq, _TILE), b * h), "threads": 256,
                "rows": _TILE, "smem_bytes": 4 * floats,
                "static_smem_bytes": 0}
    if _narrow(hd, hdv, sq, sk):
        # a cluster of four one-warpgroup CTAs a q tile, one key tile each:
        # Q, the CTA's K and V tiles at widths padded to the next k16 step,
        # the hand-over of three CTAs' O, m and l (12 floats a thread, read
        # in rank 0); 1,024 bytes of alignment slack
        wgs = _NARROW_WARPGROUPS
        return {"route": route, "kernel": "flash_attention_narrow_kernel",
                "grid": (wgs * b * h, _cdiv(sq, _TILE)), "threads": 128,
                "rows": _TILE, "cluster": wgs,
                "smem_bytes": 2 * _TILE * (2 * _k16(hd) + _k16(hdv))
                + (wgs - 1) * 12 * 128 * 4 + 1024,
                "static_smem_bytes": 0}
    split = _split(b, sq, sk, h, hkv, hd, hdv, causal, window)
    if split:  # Q of two warpgroups, three K / V stages
        return {"route": route, "kernel": "flash_attention_ws_kernel",
                "grid": (b * h * split, _cdiv(sq, 2 * _TILE)),
                # two CTAs an SM: the consumers and a producer warp
                "threads": 288, "rows": 2 * _TILE, "stages": 3,
                "cluster": split,
                "smem_bytes": 2 * _TILE * (2 * hd + 3 * (hd + hdv)) + 1024,
                "static_smem_bytes": 1024}
    if hd <= 128:  # Q, two K and two V stages, widths padded to 64
        hdp, hdvp = max(hd, _TILE), max(hdv, _TILE)
        return {"route": route, "kernel": "flash_attention_tc_kernel",
                "grid": (b * h, _cdiv(sq, _TILE)), "threads": 128,
                "rows": _TILE, "smem_bytes": 2 * _TILE * (3 * hdp + 2 * hdvp)
                + 1024, "static_smem_bytes": 0}
    stages = 2 if hd + hdv > 320 else 3   # K / V ring slots
    return {"route": route, "kernel": "flash_attention_ws_kernel",
            "grid": (b * h, _cdiv(sq, 2 * _TILE)), "threads": 384,
            "rows": 2 * _TILE, "stages": stages,
            "smem_bytes": 2 * _TILE * (2 * hd + stages * (hd + hdv)) + 1024,
            # 1 + 4 stages mbarriers of 8 bytes, padded to the 1,024-byte
            # alignment of the dynamic tiles that follow them
            "static_smem_bytes": _cdiv(8 * (1 + 4 * stages), 1024) * 1024}


def forward_tile_work(hd: int, hdv: int, *, narrow: bool | None = None,
                      split: bool = False) -> dict:
    """The tensor-core forward's CTA per 64-key tile, from the head dims
    alone: its ``kernel``, ``rows`` (queries a CTA), each warpgroup's
    ``roles`` and ``hd_units`` (its tensor work: the widths of its 64 x N
    products over the tile, S counted by hd and P.V by hdv), and
    ``hd_units_per_64_rows``.  ``narrow`` (None: wherever the pair has
    one, i.e. at short key ranges) takes the narrow CTAs of
    :data:`NARROW_PAIRS`: four one-warpgroup CTAs of a cluster, each one
    key tile of the q tile's range at widths padded to the next k16
    step.  Up to hd 128 one warpgroup copies (cp.async) and multiplies on
    widths padded to 64.  Past it a producer warpgroup streams tiles by
    TMA and two consumers each own 64 rows, so S is computed once for
    each (query, key): hd + hdv a consumer.  ``split`` (a pair of
    :data:`SPLIT_PAIRS`) takes that CTA at hd <= 128.
    Raises ``ValueError`` for a pair outside :data:`TC_HEAD_DIMS`,
    ``narrow`` at a pair without narrow CTAs, or ``split`` at a pair
    without the split."""
    if (hd, hdv) not in TC_HEAD_DIMS:
        raise ValueError(f"flash_attention: no tensor-core forward at "
                         f"(hd, hdv) = ({hd}, {hdv})")
    if narrow is None:
        narrow = (hd, hdv) in NARROW_PAIRS
    if narrow:
        if (hd, hdv) not in NARROW_PAIRS:
            raise ValueError(f"flash_attention: no narrow forward at "
                             f"(hd, hdv) = ({hd}, {hdv})")
        units = _k16(hd) + _k16(hdv)
        return {"kernel": "flash_attention_narrow_kernel", "rows": _TILE,
                "roles": ["key_tile"] * _NARROW_WARPGROUPS,
                "hd_units": [units] * _NARROW_WARPGROUPS,
                "hd_units_per_64_rows": units}
    if split:
        if (hd, hdv) not in SPLIT_PAIRS:
            raise ValueError(f"flash_attention: no split forward at "
                             f"(hd, hdv) = ({hd}, {hdv})")
        return {"kernel": "flash_attention_ws_kernel", "rows": 2 * _TILE,
                "roles": ["producer", "consumer", "consumer"],
                "hd_units": [0, hd + hdv, hd + hdv],
                "hd_units_per_64_rows": hd + hdv}
    if hd <= 128:
        units = max(hd, _TILE) + max(hdv, _TILE)
        return {"kernel": "flash_attention_tc_kernel", "rows": _TILE,
                "roles": ["copy_and_multiply"], "hd_units": [units],
                "hd_units_per_64_rows": units}
    return {"kernel": "flash_attention_ws_kernel", "rows": 2 * _TILE,
            "roles": ["producer", "consumer", "consumer"],
            "hd_units": [0, hd + hdv, hd + hdv],
            "hd_units_per_64_rows": hd + hdv}


def tc_attributes(hd: int, hdv: int,
                  kernel: str = "flash_attention_tc_kernel") -> dict:
    """What a tensor-core forward's launch at (hd, hdv) uses, from the
    loaded library (card only): ``threads``, ``smem_bytes`` (dynamic) and
    ``rows`` from the source's constants, then ``static_smem_bytes``,
    ``registers`` and ``max_dynamic_smem_bytes`` from
    ``cudaFuncGetAttributes`` once the launch's attribute is set.
    ``kernel`` is :func:`forward_plan`'s ``kernel``: the one-warpgroup or
    (past hd 128) warp-specialised kernel, the narrow CTA (a pair of
    :data:`NARROW_PAIRS`), the warp-specialised CTA's split over a
    cluster (``flash_attention_ws_kernel`` at a pair of
    :data:`SPLIT_PAIRS`) or the float32 route's
    ``flash_attention_tf32_kernel``."""
    split = kernel == "flash_attention_ws_kernel" and (hd, hdv) in SPLIT_PAIRS
    entry, pairs = (("fa_forward_split_attributes", SPLIT_PAIRS) if split
                    else _ATTRIBUTES.get(kernel, (None, ())))
    if (hd, hdv) not in pairs:
        raise ValueError(f"flash_attention: no tensor-core forward "
                         f"{kernel} at (hd, hdv) = ({hd}, {hdv})")
    out = (ctypes.c_int * 6)()
    rc = getattr(LIBRARY.load(), entry)(hd, hdv, out)
    if rc != 0:
        raise RuntimeError(f"flash_attention: attributes failed with "
                           f"status {rc}")
    return dict(zip(("threads", "smem_bytes", "rows", "static_smem_bytes",
                     "registers", "max_dynamic_smem_bytes"), out))


# forward_plan's kernel -> the library's attribute entry and the pairs it
# is built at (the split: tc_attributes)
_ATTRIBUTES = {
    "flash_attention_tc_kernel": ("fa_forward_tc_attributes", TC_HEAD_DIMS),
    "flash_attention_ws_kernel": ("fa_forward_tc_attributes", TC_HEAD_DIMS),
    "flash_attention_narrow_kernel": ("fa_forward_narrow_attributes",
                                      NARROW_PAIRS),
    "flash_attention_tf32_kernel": ("fa_forward_tf32_attributes",
                                    TC_HEAD_DIMS),
}


def backward_plan(b: int, sq: int, sk: int, h: int, hkv: int, hd: int,
                  dtype: torch.dtype, route: str | None = None, *,
                  hdv: int | None = None) -> dict:
    """The backward's launches for these shapes, from the shapes alone:
    ``route`` (None takes :func:`_route`'s backward route), ``kernels``
    as (name, grid) in launch order, and ``scratch_floats``, the float32
    elements of the dK and dV partials, b·sk·h·(hd + hdv) where H > Hkv
    (0 where none).  At a
    pair of :data:`NARROW_PAIRS` with sq and sk at most
    :data:`NARROW_MAX_LEN` the tensor-core route is one launch of
    ``fa_bwd_narrow_tc_kernel`` with no scratch: a ``cluster`` of four
    CTAs per (b, kv head), one a query tile; that plan also gives a CTA's
    ``threads`` and ``smem_bytes``.  Where :func:`_one_grid`, two
    launches: D, then ``fa_bwd_dkdv_dq_tc_kernel``,
    the dK / dV CTAs (grid rows below nk) and the dQ CTAs (the rest) in
    one grid.  The ``"tf32x3"`` route (float32): the FMA route's
    preprocess, then ``fa_bwd_dkdv_tf32_kernel`` over tiles of ``keys``
    keys (:func:`_tf32_bwd_keys`), the reduction where H > Hkv, and
    ``fa_bwd_dq_tf32_kernel``, one warpgroup a CTA; ``smem_bytes`` gives
    the dK / dV and the dQ kernels' dynamic shared memory.  ``hdv`` (v's
    head dim) defaults to ``hd``.  Raises ``ValueError`` for a pair
    outside :data:`HEAD_DIMS`, an unknown route or a tensor-core route
    that the dtype or head dims do not take."""
    hdv = hd if hdv is None else hdv
    _check_pair(hd, hdv)
    if route is None:
        route = _route(dtype, hd, hdv, backward=True)
    _check_named_route(route, dtype, hd, hdv, "flash_attention backward")
    nq, nk = _cdiv(sq, _TILE), _cdiv(sk, _TILE)
    if route == "tf32x3":
        keys = _tf32_bwd_keys(hd, hdv)
        # K, V and their lo parts (keys x widths padded to 32 floats), Q
        # and dO rows of pitch width + 4; P^T, dS^T and their lo parts
        # (dK / dV) or dS and its lo part (dQ: 64 rows of 128 bytes) and
        # the rows' lse and D; 1,024 bytes of alignment slack
        shared = (2 * 4 * keys * (_w32(hd) + _w32(hdv))
                  + _TILE * (hd + hdv + 8) * 4 + 1024)
        kernels = [("fa_bwd_preprocess_kernel", (nq, b * h)),
                   ("fa_bwd_dkdv_tf32_kernel", (b * h, _cdiv(sk, keys)))]
        scratch = 0
        if h != hkv:
            scratch = b * sk * h * (hd + hdv)
            kernels.append(("fa_bwd_gqa_reduce_kernel",
                            (_cdiv(b * sk * hkv * max(hd, hdv) // 4,
                                   _BWD_THREADS),)))
        return {"route": route,
                "kernels": kernels + [("fa_bwd_dq_tf32_kernel",
                                       (b * h, nq))],
                "scratch_floats": scratch, "threads": 128, "keys": keys,
                "smem_bytes": {"dkdv": shared + 4 * 4 * keys * _TILE
                               + 2 * _TILE * 4,
                               "dq": shared + 2 * _TILE * 128
                               + 2 * _TILE * 4}}
    if route == "tc" and _narrow(hd, hdv, sq, sk, backward=True):
        # a CTA: K and V of the whole head and its query tile's Q and dO
        # (hd and hdv wide), that tile's lse and D, each warpgroup's P^T,
        # dS^T hi and lo (64 x 64 bf16), two sets of its dQ partial (64 x
        # hd float32), 1,024 bytes of alignment slack
        wgs = _NARROW_WARPGROUPS
        return {"route": route,
                "kernels": [("fa_bwd_narrow_tc_kernel", (wgs * b * hkv,))],
                "scratch_floats": 0, "threads": 128 * wgs, "cluster": wgs,
                "smem_bytes": (NARROW_MAX_LEN + _TILE) * 2
                * (_k16(hd) + _k16(hdv)) + 2 * _TILE * 4
                + wgs * 3 * _TILE * _TILE * 2
                + 2 * wgs * _TILE * _k16(hd) * 4 + 1024}
    if route == "tc" and _one_grid(hd, hdv, h, hkv):
        # D, then grid (b H, nk + nq): y below nk a dK / dV CTA, else a dQ
        # CTA; no partials (H == Hkv)
        return {"route": route,
                "kernels": [("fa_bwd_preprocess_tc_kernel", (nq, b * h)),
                            ("fa_bwd_dkdv_dq_tc_kernel", (b * h, nk + nq))],
                "scratch_floats": 0}
    if route == "fma":
        kernels = [("fa_bwd_preprocess_kernel", (nq, b * h)),
                   ("fa_bwd_dkdv_kernel", (nk, b * h))]
        last = ("fa_bwd_dq_kernel", (nq, b * h))
    else:
        kernels = [("fa_bwd_preprocess_tc_kernel", (nq, b * h)),
                   ("fa_bwd_dkdv_tc_kernel", (b * h, nk))]
        last = ("fa_bwd_dq_tc_kernel", (b * h, nq))
    scratch = 0
    if h != hkv:  # per-query-head partials, summed per kv head
        scratch = b * sk * h * (hd + hdv)
        kernels.append(("fa_bwd_gqa_reduce_kernel",
                        (_cdiv(b * sk * hkv * max(hd, hdv) // 4,
                               _BWD_THREADS),)))
    return {"route": route, "kernels": kernels + [last],
            "scratch_floats": scratch}


def _tf32_bwd_keys(hd: int, hdv: int) -> int:
    """Keys a tile of the float32 tensor-core backward (the N of S and dP,
    the keys of a dK / dV CTA): 32, 16 at (256, 256) so that the tiles fit
    a CTA's shared memory."""
    return 16 if hd + hdv > 384 else 32


def backward_tile_work(hd: int, hdv: int, *,
                       narrow: bool | None = None) -> dict:
    """The tensor-core backward's products per (64-query, 64-key) tile, from
    the head dims alone (``csrc/flash_attention_bwd.cu``'s layout): for the
    dK / dV CTA and the dQ CTA, its ``layout``, its ``products`` and
    ``hd_units``, each warpgroup's tensor work, counted as the widths of
    64 x N products over the tile's 64 rows (dK and dQ twice: dS enters as
    bf16 hi + lo).  ``narrow`` (None: wherever the pair has one, i.e. for
    short heads) takes the one-launch kernel of :data:`NARROW_PAIRS`
    instead, under the key ``"one_launch"``: each of a CTA's four
    warpgroups one key tile of the CTA's query tile, every product once
    at widths padded to the next k16 step (S, dK and dQ at 32 for hd 24,
    dP and dV at 16).  Up to hd 128 one warpgroup does every product on
    widths padded to 64.  Past it two warpgroups split S and dP by the
    tile's queries (dK / dV) or keys (dQ), 32 each; dK / dV then
    accumulate over each warpgroup's queries (``"by_queries"``) where the
    partials fit its registers, (hd + hdv) / 2 <= 160 floats a thread,
    else over all 64 with each warpgroup a half of the columns
    (``"by_columns"``).  Raises ``ValueError`` for a pair outside
    :data:`TC_HEAD_DIMS`, or ``narrow`` at a pair without the one-launch
    kernel."""
    if (hd, hdv) not in TC_HEAD_DIMS:
        raise ValueError(f"flash_attention backward: no tensor-core kernel "
                         f"at (hd, hdv) = ({hd}, {hdv})")
    if narrow is None:
        narrow = (hd, hdv) in NARROW_PAIRS
    if narrow:
        if (hd, hdv) not in NARROW_PAIRS:
            raise ValueError(f"flash_attention backward: no one-launch "
                             f"kernel at (hd, hdv) = ({hd}, {hdv})")
        hdp, hdvp = _k16(hd), _k16(hdv)
        return {"one_launch": {
            "layout": "key_tile_per_warpgroup",
            "products": ["S", "dP", "dV", "dK hi", "dK lo", "dQ hi",
                         "dQ lo"],
            "hd_units": [5 * hdp + 2 * hdvp] * _NARROW_WARPGROUPS}}
    products = {"dkdv": ["S", "dP", "dV", "dK hi", "dK lo"],
                "dq": ["S", "dP", "dQ hi", "dQ lo"]}
    if hd <= 128:
        hdp, hdvp = max(hd, _TILE), max(hdv, _TILE)
        return {"dkdv": {"layout": "one_warpgroup",
                         "products": products["dkdv"],
                         "hd_units": [3 * hdp + 2 * hdvp]},
                "dq": {"layout": "one_warpgroup", "products": products["dq"],
                       "hd_units": [3 * hdp + hdvp]}}
    layout = "by_queries" if hd + hdv <= 320 else "by_columns"
    return {"dkdv": {"layout": layout, "products": products["dkdv"],
                     "hd_units": [(3 * hd + 2 * hdv) // 2] * 2},
            "dq": {"layout": "by_keys", "products": products["dq"],
                   "hd_units": [(3 * hd + hdv) // 2] * 2}}


def backward(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
             causal: bool, window: int, route: str | None = None,
             one_grid: bool | None = None):
    """Launch the backward kernels on CUDA tensors: (dq, dk, dv) in q's
    dtype and shapes, from the upstream gradient ``do`` (shaped as
    ``o``), the forward's operands, its output ``o`` and its ``lse``
    (float32 (B, H, Sq)).  ``q_offset`` is 0 (the training forward).
    ``route`` None takes :func:`_route`, ``one_grid`` None the plan's
    (:func:`_one_grid`); a caller may name the other route, or the
    separate or the one-grid launches of the tensor-core route (up to hd
    128 with H == Hkv; else the launch raises), only to time or test
    them.  The head dims and the route are checked first, before the
    operands' device."""
    if q.dim() == 4 and k.dim() == 4 and v.dim() == 4:  # else _check raises
        plan = backward_plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                             k.shape[2], q.shape[3], q.dtype, route,
                             hdv=v.shape[3])
    window = int(window)
    _check(q, k, v, window, 0)
    b, sq, h, hd = q.shape
    sk, hkv, hdv = k.shape[1], k.shape[2], v.shape[3]
    route = plan["route"]
    if do.stride(3) != 1 or (route != "fma" and not _tc_aligned(do)):
        # a copy, not another route (a contiguous view may start off the
        # 16-byte boundary, so not .contiguous())
        do = do.clone(memory_format=torch.contiguous_format)
    for t in (o, do):
        if (t.shape != (b, sq, h, hdv) or t.dtype != q.dtype
                or t.device != q.device or t.stride(3) != 1):
            raise ValueError(f"flash_attention backward: o / dO "
                             f"{tuple(t.shape)} {t.dtype} do not match "
                             f"{(b, sq, h, hdv)} {q.dtype}")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("flash_attention backward: want a contiguous "
                         "float32 lse of shape (B, H, Sq) on q's device")
    if route != "fma":
        _check_tc(q, k, v, o, do)
    lib = BWD_LIBRARY.load()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    narrow = plan["kernels"][0][0] == "fa_bwd_narrow_tc_kernel"
    if one_grid is None:
        one_grid = plan["kernels"][-1][0] == "fa_bwd_dkdv_dq_tc_kernel"
    elif one_grid and (route != "tc" or narrow):
        raise ValueError("flash_attention backward: one grid is a launch "
                         "of the tensor-core route's four-kernel backward")
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           do.data_ptr(), lse.data_ptr())
    outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    dims = (_strides(q, k, v, o, do, dq, dk, dv), b, sq, sk, h, hkv, hd,
            hdv, int(bool(causal)), window, 1.0 / math.sqrt(hd))
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if narrow:  # D in the kernel, no partials
            rc = lib.fa_backward_narrow(*ins, *outs, *dims, stream)
        else:
            delta = torch.empty_like(lse)
            # dK's partials (B, Sk, H, hd), then dV's (B, Sk, H, hdv)
            part = (torch.empty(plan["scratch_floats"], dtype=torch.float32,
                                device=q.device)
                    if plan["scratch_floats"] else None)
            parts = ((part.data_ptr(), part[b * sk * h * hd:].data_ptr())
                     if part is not None else (None, None))
            args = (*ins, delta.data_ptr(), *outs, *parts, *dims)
            rc = (lib.fa_backward_tc(*args, int(one_grid), stream)
                  if route == "tc"
                  else lib.fa_backward_tf32(*args, stream)
                  if route == "tf32x3"
                  else lib.fa_backward(*args, _DTYPES[q.dtype], stream))
    if rc != 0:
        raise RuntimeError(f"flash_attention backward: CUDA launch failed "
                           f"with status {rc}")
    LAUNCHES["flash_attention_bwd"] += 1
    if route == "tc":
        LAUNCHES["flash_attention_bwd_tc"] += 1
    if route == "tf32x3":
        LAUNCHES["flash_attention_bwd_tf32x3"] += 1
    if narrow:
        LAUNCHES["flash_attention_bwd_narrow"] += 1
    if one_grid:
        LAUNCHES["flash_attention_bwd_one_grid"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention on CUDA tensors with a kernel for its gradient:
    the forward saves q, k, v, the output and the per-row ``lse``; the
    backward is :func:`backward`.  Both take :func:`_route`'s route at
    every (hd, hdv) pair of :data:`HEAD_DIMS`: the tensor cores with the
    pair in :data:`TC_HEAD_DIMS`, bfloat16 (forward
    ``flash_attention_tc_kernel`` or, past hd 128,
    ``flash_attention_ws_kernel``; backward ``fa_backward_tc``) or
    float32 as split TF32 (``flash_attention_tf32_kernel``;
    ``fa_backward_tf32``, but the FMA backward at
    :data:`FMA_BACKWARD_PAIRS`), float32 FMAs at hd 8.  ``q_offset`` is
    0."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _forward(q, k, v, causal, window, 0,
                            _route(q.dtype, q.shape[-1], v.shape[-1]),
                            with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = bool(causal), int(window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = backward(do, q, k, v, out, lse, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


#: the plain version's query and key chunk on ``meta`` tensors (the
#: dry-run): a tile a 2,048 x 2,048 block, 8-16x fewer ops to trace than
#: the CPU's 512 x 1,024, its causal skip at that grain
META_CHUNK = 2048


class PlainRecomputeFn(torch.autograd.Function):
    """The plain version holding what :class:`FlashAttentionFn` holds
    (q, k, v and the output) and recomputing the rest in its backward, as
    the backward kernels do: the dry-run's attention on ``meta`` tensors,
    so its memory count sees the kernels' activations between the forward
    and the backward, not the plain version's autograd tiles."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out = ref.flash_attention_ref(q, k, v, causal, window, 0,
                                      META_CHUNK, META_CHUNK)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = bool(causal), int(window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, _ = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.flash_attention_ref(*qkv, ctx.causal, ctx.window, 0,
                                          META_CHUNK, META_CHUNK)
            dq, dk, dv = torch.autograd.grad(out, qkv, do)
        return dq, dk, dv, None, None


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_placements(q, k, v, mesh) -> tuple:
    """(q's and the output's placements, k's and v's) for a rank-local
    attention: per mesh dim, batch (dim 0) sharded for all three where q
    is; heads (dim 2) sharded where q, k and v all are and both head
    counts divide; else replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def placements(t):
        return (tuple(t.placements) if isinstance(t, DTensor)
                else (Replicate(),) * mesh.ndim)

    pq, pk, pv = placements(q), placements(k), placements(v)
    out_q, out_kv = [], []
    for m in range(mesh.ndim):
        n = mesh.size(m)
        if pq[m] == Shard(0):
            out_q.append(Shard(0))
            out_kv.append(Shard(0))
        elif (pq[m] == pk[m] == pv[m] == Shard(2)
              and q.shape[2] % n == 0 and k.shape[2] % n == 0):
            out_q.append(Shard(2))
            out_kv.append(Shard(2))
        else:
            out_q.append(Replicate())
            out_kv.append(Replicate())
    return tuple(out_q), tuple(out_kv)


def _sharded(q, k, v, *args):
    """:func:`flash_attention` of DTensor operands, shard by shard."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t.device_mesh for t in (q, k, v) if isinstance(t, DTensor))
    pq, pkv = local_placements(q, k, v, mesh)
    return local_map(flash_attention, out_placements=(pq,),
                     in_placements=(pq, pkv, pkv) + (None,) * len(args),
                     device_mesh=mesh, redistribute_inputs=True)(
                         q, k, v, *args)


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
    """Attention of q over k / v; (B, Sq, H, hdv) in q's dtype.  On CUDA
    tensors with grad mode on and an operand that requires grad, the
    differentiable :class:`FlashAttentionFn` (``q_offset`` must be 0).
    DTensor operands (a device mesh) go shard by shard through
    ``local_map``."""
    if any(type(t) is not torch.Tensor and _is_dtensor(t) for t in (q, k, v)):
        return _sharded(q, k, v, causal, window, q_offset, cq, ck,
                        skip_masked_chunks)
    if all(t.device.type == "meta" for t in (q, k, v)):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return PlainRecomputeFn.apply(q, k, v, causal, window)
        cq = ck = META_CHUNK
    if all(t.device.type in ("cpu", "meta") for t in (q, k, v)):
        return ref.flash_attention_ref(q, k, v, causal, window, q_offset,
                                       cq, ck, skip_masked_chunks)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if int(q_offset) != 0:
            raise ValueError(f"flash_attention: the backward kernels take "
                             f"q_offset 0, got {q_offset}")
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return launch(q, k, v, causal, window, q_offset,
                  _route(q.dtype, q.shape[-1], v.shape[-1]))
