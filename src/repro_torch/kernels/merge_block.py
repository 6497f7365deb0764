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

TIES has two routes on the card, chosen by :func:`ties_route` from the
shape alone: ``"fused"`` (:func:`ties_fused`, one thread-block-cluster
kernel that trims, elects and applies from slices staged in shared
memory) where those slices fit a CTA's shared memory and the launch has
at most :data:`FUSED_MAX_K` experts and :data:`FUSED_MAX_ROWS` rows, and
``"pair"``
(:func:`ties_thresholds`, then :func:`ties_merge`) otherwise: K or W too
large to stage, or enough rows or experts that the pair is faster.  Both give the
same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES = {"linear_merge": 0, "ties_merge": 0, "dare_merge": 0,
            "sketch_blocks": 0, "ties_threshold": 0, "ties_fused": 0}
#: the fused TIES kernel's launch plan, as ``fused_plan`` in
#: ``csrc/merge_block.cu``: clusters of up to 16 CTAs along W, at least
#: 2,048 elements per CTA, within a CTA's 232,448 bytes of shared memory
FUSED_MAX_CLUSTER = 16
FUSED_MIN_SLICE = 2048
SMEM_LIMIT = 232448
#: the most (block, expert) rows, and the most experts K, ties_route
#: sends to the fused kernel: where the two routes cross by wall time per
#: call (host time included, as the host-bound merge pays it) on the H100
#: (chip_smoke.py's ROUTE_CASES, tools/ties_route_sweep.py)
FUSED_MAX_ROWS = 48
FUSED_MAX_K = 6
#: the threshold kernel's launch plan, as ``sel_plan`` in
#: ``csrc/merge_block.cu``: CTAs of 256 threads over slices of 1,024 to
#: 16,384 elements, enough for about 264 CTAs (two an H100 SM); per row 8
#: header words, 2,048 + 1,024 histogram bins and a candidate buffer
SELECT_THREADS = 256
SELECT_SLICE_MIN = 1024
SELECT_SLICE_MAX = 16384
SELECT_TARGET_CTAS = 264
SELECT_CAND_MIN = 1024
SELECT_ROW_WORDS = 8 + 2048 + 1024
#: launches of at least SELECT_ROW_MIN_ROWS rows of at most SELECT_ROW_MAX_W
#: elements take one CTA of 1,024 threads a row instead (no scratch)
SELECT_ROW_MIN_ROWS = 16
SELECT_ROW_MAX_W = 131072
SELECT_ROW_THREADS = 1024
#: the pair's apply kernel (``apply_tile`` in ``csrc/merge_block.cu``):
#: tiles of T columns, the largest power of two <= 4,096 with K·T <=
#: 6,144 floats, staged twice (a two-stage ring) in shared memory; at
#: most APPLY_MAX_K experts (T >= 32)
APPLY_TILE_MAX = 4096
APPLY_STAGE_FLOATS = 6144
APPLY_MAX_K = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f, d = ctypes.c_float, ctypes.c_double
    lib.mb_linear.argtypes = [p, p, p, i, i, ll, f, f, p, p]
    lib.mb_ties.argtypes = [p, p, p, p, i, i, ll, d, p]
    lib.mb_dare.argtypes = [p, p, p, p, i, i, ll, f, f, p]
    lib.mb_sketch.argtypes = [p, p, i, ll, p]
    lib.mb_ties_threshold.argtypes = [p, p, p, ll, ll, ll, i, p]
    lib.mb_ties_threshold_plan.argtypes = [ll, ll, ctypes.POINTER(ll)]
    lib.mb_ties_fused.argtypes = [p, p, p, p, i, i, ll, i, d, p]
    lib.mb_ties_fused_plan.argtypes = [i, ll, ctypes.POINTER(ll)]
    for fn in (lib.mb_linear, lib.mb_ties, lib.mb_dare, lib.mb_sketch,
               lib.mb_ties_threshold, lib.mb_ties_threshold_plan,
               lib.mb_ties_fused, lib.mb_ties_fused_plan):
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
    x0: torch.Tensor, D: torch.Tensor, mul: float = 1.0, div: float = 1.0,
    div_rows: torch.Tensor = None,
) -> torch.Tensor:
    """out = x0 + (mul · Σ_k Δ_k) / div.  AVG: mul=1, div=K+1; TA: mul=λ.
    ``div_rows`` (NB,) float32, when given, is each row's divisor in
    place of ``div`` (the whole-shard AVG's k_sel + 1)."""
    if x0.device.type == "cpu":
        return ref.linear_ref(x0, D, mul, div, div_rows)
    nb, k, w = D.shape
    _check("linear_merge", x0, D, [] if div_rows is None
           else [(div_rows, torch.float32, (nb,))])
    lib = LIBRARY.load()
    out = torch.empty_like(x0)
    with torch.cuda.device(D.device):
        _launch("linear_merge", lib.mb_linear, x0.data_ptr(), D.data_ptr(),
                out.data_ptr(), nb, k, w, mul, div,
                None if div_rows is None else div_rows.data_ptr())
    return out


def ties_thresholds(D: torch.Tensor, trim_frac: float) -> torch.Tensor:
    """(NB, K, W) float32 -> (NB, K) float32: the keep-th largest |Δ| of
    each row, ``keep = ref.ties_keep(trim_frac, W)``; ``-inf`` without a
    launch when every entry is kept.  Bit for bit ``np.partition``'s
    threshold (NaN sorts above +inf and keeps its payload) and
    ``torch.kthvalue``'s, except that on the card ``kthvalue`` returns any
    NaN as 0x7FFFFFFF.  :func:`ties_threshold_plan` names the kernels the
    shape takes."""
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
    plan = ties_threshold_plan(nb * k, w)
    if keep >= w:
        return torch.full((nb, k), float("-inf"), dtype=torch.float32,
                          device=D.device)
    lib = LIBRARY.load()
    out = torch.empty((nb, k), dtype=torch.float32, device=D.device)
    scratch = (torch.empty(plan["scratch"] // 4, dtype=torch.int32,
                           device=D.device) if plan["scratch"] else None)
    with torch.cuda.device(D.device):
        _launch("ties_threshold", lib.mb_ties_threshold, D.data_ptr(),
                out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                plan["scratch"], nb * k, w, keep)
    return out


def ties_threshold_plan(rows: int, w: int) -> dict:
    """The threshold kernel's launch for ``rows`` rows of width W
    (``csrc/merge_block.cu`` ``sel_plan``).  ``variant`` "row" for at
    least SELECT_ROW_MIN_ROWS rows of at most SELECT_ROW_MAX_W elements:
    one CTA a row, no scratch.  Otherwise "sliced": ``slices`` a row of
    ``slice`` elements each (a multiple of 4), one CTA of ``threads`` a
    slice, ``ctas`` in each of its three passes, ``scratch`` bytes of
    per-row state (8 header words, 2,048 + 1,024 histogram bins and the
    candidate buffer, 4 bytes each).  ``capacity``: candidate keys a row
    (past them a row takes the dense path)."""
    if rows < 1 or w < 1:
        raise ValueError(f"ties_threshold_plan: unsupported {(rows, w)}")
    cap = min(w, max(SELECT_CAND_MIN, -(-w // 8)))
    cap = -(-cap // 4) * 4
    if rows >= SELECT_ROW_MIN_ROWS and w <= SELECT_ROW_MAX_W:
        return {"variant": "row", "slices": 1, "slice": -(-w // 4) * 4,
                "ctas": rows, "threads": SELECT_ROW_THREADS, "capacity": cap,
                "scratch": 0}
    want = -(-SELECT_TARGET_CTAS // rows)
    slices = max(-(-w // SELECT_SLICE_MAX), min(want, -(-w // SELECT_SLICE_MIN)))
    sl = -(-w // slices)
    sl = -(-sl // 4) * 4
    slices = -(-w // sl)
    return {"variant": "sliced", "slices": slices, "slice": sl,
            "ctas": rows * slices,
            "threads": SELECT_THREADS, "capacity": cap,
            "scratch": 4 * rows * (SELECT_ROW_WORDS + cap)}


def ties_threshold_launch_plan(rows: int, w: int) -> dict:
    """:func:`ties_threshold_plan` as the C side computes it
    (``mb_ties_threshold_plan``).  Builds the library; needs a card."""
    lib = LIBRARY.load()
    out = (ctypes.c_longlong * 7)()
    rc = lib.mb_ties_threshold_plan(rows, w, out)
    if rc != 0:
        raise RuntimeError(f"ties_threshold_launch_plan: CUDA status {rc}")
    return {"variant": "row" if out[6] else "sliced", "slices": out[0],
            "slice": out[1], "ctas": out[2], "threads": out[3],
            "capacity": out[5], "scratch": out[4]}


def ties_merge(
    x0: torch.Tensor, D: torch.Tensor, thresh: torch.Tensor, lam: float = 1.0
) -> torch.Tensor:
    """TIES given per-(block, expert) trim thresholds (NB, K).  On the
    card K <= :data:`APPLY_MAX_K`."""
    if x0.device.type == "cpu":
        return ref.ties_apply_ref(x0, D, thresh, lam)
    nb, k, w = D.shape
    _check("ties_merge", x0, D, [(thresh, torch.float32, (nb, k))])
    if k > APPLY_MAX_K:
        raise ValueError(f"ties_merge: K = {k} experts, the apply kernel "
                         f"takes at most {APPLY_MAX_K}")
    lib = LIBRARY.load()
    out = torch.empty_like(x0)
    with torch.cuda.device(D.device):
        _launch("ties_merge", lib.mb_ties, x0.data_ptr(), D.data_ptr(),
                thresh.data_ptr(), out.data_ptr(), nb, k, w, lam)
    return out


def ties_apply_plan(nb: int, k: int, w: int) -> dict:
    """The pair's apply kernel for (NB, K, W): ``tile`` columns of the K
    rows a work item, ``items`` = NB · ceil(W / tile) (block, tile) pairs
    walked by a persistent grid, ``smem`` bytes of dynamic shared memory
    per CTA (two stages of K x tile floats, two mbarriers)."""
    if nb < 1 or not 1 <= k <= APPLY_MAX_K or w < 1:
        raise ValueError(f"ties_apply_plan: unsupported shape {(nb, k, w)}")
    tile = APPLY_TILE_MAX
    while tile > 32 and tile * k > APPLY_STAGE_FLOATS:
        tile //= 2
    return {"tile": tile, "items": nb * -(-w // tile),
            "smem": 2 * k * tile * 4 + 16}


def ties_fused_plan(k: int, w: int) -> dict:
    """The fused kernel's launch for K rows of width W: ``cluster`` CTAs
    per block, ``slice`` elements of each row per CTA (a multiple of 4)
    and ``smem`` bytes of dynamic shared memory per CTA (K delta slices,
    K local 256-bin histograms, the CTA's share of 4 passes' cluster
    histograms, per-row prefixes, ranks and thresholds, K mbarriers)."""
    cluster = max(1, min(FUSED_MAX_CLUSTER, -(-w // FUSED_MIN_SLICE)))
    sl = -(-w // cluster)
    sl = -(-sl // 4) * 4
    groups = -(-32 // cluster)  # 8-bin groups of a row one CTA owns
    smem = 4 * k * sl + 1024 * k + 4 * k * groups * 8 * 4
    smem += -(-12 * k // 8) * 8 + 8 * k
    return {"cluster": cluster, "slice": sl, "smem": smem}


def ties_fused_fits(k: int, w: int) -> bool:
    """Whether the fused kernel can stage K rows of width W (K <= 13 at
    the merge path's W = 65,536)."""
    return ties_fused_plan(k, w)["smem"] <= SMEM_LIMIT


def ties_route(nb: int, k: int, w: int) -> str:
    """``"fused"`` where the fused kernel fits (:func:`ties_fused_fits`)
    and the launch has at most :data:`FUSED_MAX_K` experts and
    :data:`FUSED_MAX_ROWS` (block, expert) rows, else ``"pair"``
    (threshold kernel, then apply kernel).  The shape alone decides: a failure of
    either route raises, and neither stands in for the other."""
    if nb < 1 or k < 1 or w < 1:
        raise ValueError(f"ties_route: unsupported shape {(nb, k, w)}")
    fused = (ties_fused_fits(k, w) and k <= FUSED_MAX_K
             and nb * k <= FUSED_MAX_ROWS)
    return "fused" if fused else "pair"


def ties_fused_occupancy(k: int, w: int) -> dict:
    """:func:`ties_fused_plan` on the current card, with ``clusters``:
    how many of its clusters the card holds at once (0: none fits, and a
    launch raises).  Builds the library; needs a card."""
    lib = LIBRARY.load()
    out = (ctypes.c_longlong * 4)()
    rc = lib.mb_ties_fused_plan(k, w, out)
    if rc != 0:
        raise RuntimeError(f"ties_fused_occupancy: CUDA status {rc}")
    return {"cluster": out[0], "slice": out[1], "smem": out[2],
            "clusters": out[3]}


def ties_fused(
    x0: torch.Tensor, D: torch.Tensor, trim_frac: float = 0.2,
    lam: float = 1.0, thresholds: bool = False,
):
    """The whole TIES merge in one kernel: trim each (block, expert) row
    to its ``keep = ref.ties_keep(trim_frac, W)`` largest |Δ|, elect
    signs, take the sign-matched mean, out = x0 + λ·mean.  Bit for bit
    :func:`ties_thresholds` followed by :func:`ties_merge`.  With
    ``thresholds`` it returns ``(out, thresh)``, thresh the (NB, K) trim
    thresholds (``-inf`` where every entry is kept).  On the card it
    takes every shape it can stage (:func:`ties_fused_fits`) and raises
    on others; :func:`ties_route` says which shapes the merge sends it."""
    if x0.device.type == "cpu":
        thresh = ref.ties_thresholds(D, trim_frac)
        out = ref.ties_apply_ref(x0, D, thresh, lam)
        return (out, thresh) if thresholds else out
    _check("ties_fused", x0, D, [])
    nb, k, w = D.shape
    if not ties_fused_fits(k, w):
        raise ValueError(f"ties_fused: {tuple(D.shape)} does not fit the "
                         f"fused kernel's shared memory")
    keep = min(ref.ties_keep(trim_frac, w), w)
    lib = LIBRARY.load()
    out = torch.empty_like(x0)
    thresh = (torch.empty((nb, k), dtype=torch.float32, device=D.device)
              if thresholds else None)
    with torch.cuda.device(D.device):
        _launch("ties_fused", lib.mb_ties_fused, x0.data_ptr(), D.data_ptr(),
                out.data_ptr(), None if thresh is None else thresh.data_ptr(),
                nb, k, w, keep, lam)
    return (out, thresh) if thresholds else out


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
