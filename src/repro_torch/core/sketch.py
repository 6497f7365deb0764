"""ANALYZE phase — block-level sketches persisted to the catalog (§2.3).

ANALYZE reads a checkpoint **once**, computes per-block statistics, and
persists them as ``BlockMeta`` rows.  Afterwards every merge plans from
metadata alone (G2): the planner never touches parameter bytes.

Sketch fields per block:
    l2        — block L2 norm
    absmax    — max |x|
    mean      — mean(x)
    sign_sig  — 64-bit signature of signs at 64 deterministic positions
                (cheap TIES-style conflict hint: popcount(xor) between two
                experts' signatures estimates sign disagreement)
    l2_delta  — L2 norm of (x - x_base) when a base model is supplied, or
                of x itself for delta-kind experts (task-vector salience,
                the planner's primary ranking signal)
    cos_base  — cosine(x, x_base) hint

ANALYZE reads are tagged ``analyze`` in iostats: they are a one-time,
amortized cost (paper §6.5) and are *not* charged against the per-merge
expert budget B, which governs execution-time expert reads.
"""
from __future__ import annotations

import functools
import hashlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import blocks as blk
from repro_torch.core.catalog import Catalog
from repro_torch.store.dtypes import from_float32, to_float32
from repro_torch.store.tensorstore import CheckpointStore, ModelReader

#: number of sampled sign positions in the signature
_SIGN_BITS = 64


def sign_signature(x: np.ndarray) -> int:
    """64-bit sign signature at evenly spaced positions (deterministic).

    Returned as a *signed* 64-bit reinterpretation so it fits SQLite's
    INTEGER; consumers view it back as uint64 for bit math.
    """
    if x.size == 0:
        return 0
    return _pack_signs(x.ravel()[_sign_positions(x.size)])


@functools.lru_cache(maxsize=256)
def _sign_positions(n: int) -> np.ndarray:
    """The signature's evenly spaced positions in ``n`` elements (shared,
    read-only: a block size has one)."""
    idx = np.linspace(0, n - 1, num=_SIGN_BITS, dtype=np.int64)
    idx.setflags(write=False)
    return idx


def _pack_signs(v: np.ndarray) -> int:
    """The signature of the values at the sampled positions."""
    bits = (v < 0).astype(np.uint64)
    packed = np.bitwise_or.reduce(bits << np.arange(_SIGN_BITS, dtype=np.uint64))
    return int(np.uint64(packed).astype(np.int64))


def sign_disagreement(sig_a: int, sig_b: int) -> float:
    """Fraction of sampled positions whose signs differ."""
    ua = int(np.int64(sig_a).astype(np.uint64))
    ub = int(np.int64(sig_b).astype(np.uint64))
    return bin(ua ^ ub).count("1") / _SIGN_BITS


#: float32 bytes of full-width blocks staged per sketch launch
LAUNCH_BYTES = 256 << 20


def _sampled(x: np.ndarray) -> np.ndarray:
    """float32 values of a (non-empty) block at the signature's positions:
    :func:`_pack_signs` of them is the block's :func:`sign_signature`."""
    return to_float32(x.ravel()[_sign_positions(x.size)])


def _launch_groups(ranges: List[blk.BlockRange], itemsize: int):
    """Consecutive block ranges of one byte size, at most
    :data:`LAUNCH_BYTES` of float32 per group: a tensor's full-width
    blocks in one launch (or a few), its ragged tail block alone."""
    group: List[blk.BlockRange] = []
    for rng in ranges:
        if group and (
            rng.nbytes != group[0].nbytes
            or (len(group) + 1) * (rng.nbytes // itemsize) * 4 > LAUNCH_BYTES
        ):
            yield group
            group = []
        group.append(rng)
    if group:
        yield group


def _sketch_rows(
    xs: List[np.ndarray], x0s: Optional[List[np.ndarray]], device
) -> List[Tuple[float, float, float, Optional[float], Optional[float]]]:
    """Per block ``(l2, absmax, mean, l2_delta, cos_base)`` of equal-width
    blocks ``xs`` through the sketch kernel on ``device``: one launch for
    ``xs`` and, with bases ``x0s``, one each for ``x0s`` and ``xs − x0s``
    (float32 subtraction on the device, exact as numpy's).  ``cos_base``
    comes from the three norms by the polarization identity,
    ``x·x0 = (‖x‖² + ‖x0‖² − ‖x − x0‖²) / 2``, in float64: its error is
    about 1e-7·(‖x‖/‖x0‖ + ‖x0‖/‖x‖).  Without bases the last two are
    None."""
    from repro_torch.kernels import ops

    X = ops.to_device(np.stack(xs), device)
    stats = ops.sketch_blocks(X, device)
    if x0s is None:
        return [(float(l2), float(mx), float(mean), None, None)
                for l2, mx, mean in stats]
    X0 = ops.to_device(np.stack(x0s), device)
    l2_base = ops.sketch_blocks(X0, device)[:, 0]
    l2_diff = ops.sketch_blocks(X - X0, device)[:, 0]
    rows = []
    for (l2, mx, mean), l2b, l2d in zip(stats, l2_base, l2_diff):
        l2, l2b, l2d = float(l2), float(l2b), float(l2d)
        denom = l2 * l2b
        cos = (l2 * l2 + l2b * l2b - l2d * l2d) / 2 / denom if denom > 0 else 0.0
        rows.append((l2, float(mx), float(mean), l2d, cos))
    return rows


def _analyze_adapter(
    catalog: Catalog,
    reader: ModelReader,
    base_reader: Optional[ModelReader],
    model_id: str,
    block_size: int,
    device,
) -> Dict[str, float]:
    """ANALYZE for LoRA-adapter experts.

    The physical checkpoint holds factor pairs ``<t>::lora_A/B``; merging
    targets tensor ``<t>`` of the base.  We materialize the (tiny-rank)
    delta once, sketch it on the *base tensor's block grid* (so planner
    selections align with the executor's output grid), and prorate the
    factor I/O bytes across the virtual delta blocks — block ``bytes``
    then reflect true physical read cost, keeping both the cost model and
    budget soundness exact for adapters.
    """
    scale = float(reader.meta.get("scale", 1.0))
    targets = sorted(
        n[: -len("::lora_A")] for n in reader.tensor_names()
        if n.endswith("::lora_A")
    )
    tensor_rows = []
    block_rows: List[Tuple] = []
    n_blocks = 0
    for t in targets:
        a_spec = reader.spec(f"{t}::lora_A")
        b_spec = reader.spec(f"{t}::lora_B")
        factor_bytes = a_spec.nbytes + b_spec.nbytes
        tensor_rows.append(
            (t, str([b_spec.shape[0], a_spec.shape[1]]), a_spec["dtype"],
             factor_bytes)
        )
        if base_reader is None or t not in base_reader.specs:
            continue  # tensor-level fallback handles this expert
        base_spec = base_reader.spec(t)
        A = to_float32(reader.read_tensor(f"{t}::lora_A", "analyze"))
        B = to_float32(reader.read_tensor(f"{t}::lora_B", "analyze"))
        delta = from_float32((scale * (B @ A)).reshape(-1), base_spec.dtype)
        ranges = blk.partition(base_spec.nbytes, block_size)
        per_block = factor_bytes // max(len(ranges), 1)
        itemsize = base_spec.dtype.itemsize
        for group in _launch_groups(ranges, itemsize):
            xs = [delta[rng.offset // itemsize : rng.end // itemsize]
                  for rng in group]
            for rng, x, (l2, absmax, mean, _, _) in zip(
                group, xs, _sketch_rows(xs, None, device)
            ):
                i = rng.block_idx
                cost_bytes = (
                    factor_bytes - per_block * (len(ranges) - 1)
                    if i == len(ranges) - 1 else per_block
                )
                xf = to_float32(x)
                h = hashlib.blake2b(xf.tobytes(), digest_size=8)
                block_rows.append(
                    (model_id, t, block_size, i, cost_bytes,
                     h.hexdigest(), l2, absmax, mean, sign_signature(xf), l2,
                     None)
                )
                n_blocks += 1
    catalog.upsert_tensor_meta(model_id, tensor_rows)
    if block_rows:
        catalog.upsert_block_meta(block_rows)
    return {"model_id": model_id, "cached": False, "blocks": n_blocks}


def analyze_model(
    catalog: Catalog,
    store: CheckpointStore,
    model_id: str,
    block_size: int,
    base_id: Optional[str] = None,
    force: bool = False,
    device="cuda",
) -> Dict[str, float]:
    """Run (or reuse) ANALYZE for ``model_id``. Returns summary stats.

    Catalog hit => metadata-only, zero parameter I/O (the paper's reuse
    path).  Miss => one full scan of the checkpoint, tagged ``analyze``.

    The block statistics (l2, absmax, mean, l2_delta, cos_base) come from
    the sketch kernel on ``device``, a tensor's blocks batched per launch
    (:func:`_launch_groups`): a CUDA device (the default) launches it and
    raises when there is none; ``"cpu"`` runs its plain version.  The
    reads, the blake2b block hashes and the sign signatures stay on the
    host, as in the reference.
    """
    from repro_torch.kernels.ops import resolve_device  # lazy: torch

    device = resolve_device(device)
    t0 = time.time()
    if catalog.has_analysis(model_id, block_size) and not force:
        return {"model_id": model_id, "cached": True, "seconds": 0.0, "blocks": 0}

    with store.open_model(model_id) as reader:
        kind = reader.meta.get("kind", "full")
        is_delta = kind == "delta"
        base_reader: Optional[ModelReader] = None
        if base_id is not None and not is_delta:
            base_reader = store.open_model(base_id)

        if kind == "adapter":
            out = _analyze_adapter(
                catalog, reader, base_reader, model_id, block_size, device
            )
            if base_reader is not None:
                base_reader.close()
            catalog.mark_analyzed(model_id, block_size, base_id)
            out["seconds"] = time.time() - t0
            return out

        tensor_rows = []
        block_rows: List[Tuple] = []
        n_blocks = 0
        for tensor_id in reader.tensor_names():
            spec = reader.spec(tensor_id)
            tensor_rows.append(
                (tensor_id, str(list(spec.shape)), spec["dtype"], spec.nbytes)
            )
            base_spec = None
            if base_reader is not None and tensor_id in base_reader.specs:
                bs = base_reader.spec(tensor_id)
                if bs.shape == spec.shape and bs["dtype"] == spec["dtype"]:
                    base_spec = bs
            with_base = base_spec is not None and not is_delta
            ranges = blk.partition(spec.nbytes, block_size)
            for group in _launch_groups(ranges, spec.dtype.itemsize):
                # the reads are the reference's, block by block (x, then
                # its base block); only the arithmetic is batched
                xs, x0s = [], []
                for rng in group:
                    xs.append(reader.read_block(
                        tensor_id, rng.block_idx, block_size, "analyze"))
                    if with_base:
                        x0s.append(base_reader.read_block(
                            tensor_id, rng.block_idx, block_size, "analyze"))
                stats = _sketch_rows(xs, x0s if with_base else None, device)
                for i, (rng, x, (l2, absmax, mean, l2_delta, cos_base)) in \
                        enumerate(zip(group, xs, stats)):
                    if is_delta:
                        l2_delta = l2
                    sampled = _sampled(x)
                    if with_base:  # signature of the task vector
                        sampled = sampled - _sampled(x0s[i])
                    # the raw block bytes, hashed in place (no copy)
                    h = hashlib.blake2b(np.ascontiguousarray(x),
                                        digest_size=8)
                    block_rows.append(
                        (
                            model_id,
                            tensor_id,
                            block_size,
                            rng.block_idx,
                            rng.nbytes,
                            h.hexdigest(),
                            l2,
                            absmax,
                            mean,
                            _pack_signs(sampled),
                            l2_delta,
                            cos_base,
                        )
                    )
                    n_blocks += 1
        if base_reader is not None:
            base_reader.close()

    catalog.upsert_tensor_meta(model_id, tensor_rows)
    catalog.upsert_block_meta(block_rows)
    catalog.mark_analyzed(model_id, block_size, base_id)
    return {
        "model_id": model_id,
        "cached": False,
        "seconds": time.time() - t0,
        "blocks": n_blocks,
    }
