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
    n = x.size
    if n == 0:
        return 0
    idx = np.linspace(0, n - 1, num=_SIGN_BITS, dtype=np.int64)
    bits = (x.ravel()[idx] < 0).astype(np.uint64)
    packed = np.bitwise_or.reduce(bits << np.arange(_SIGN_BITS, dtype=np.uint64))
    return int(np.uint64(packed).astype(np.int64))


def sign_disagreement(sig_a: int, sig_b: int) -> float:
    """Fraction of sampled positions whose signs differ."""
    ua = int(np.int64(sig_a).astype(np.uint64))
    ub = int(np.int64(sig_b).astype(np.uint64))
    return bin(ua ^ ub).count("1") / _SIGN_BITS


def _block_stats(x: np.ndarray) -> Tuple[float, float, float, int]:
    xf = to_float32(x)
    l2 = float(np.linalg.norm(xf))
    absmax = float(np.max(np.abs(xf))) if xf.size else 0.0
    mean = float(np.mean(xf)) if xf.size else 0.0
    return l2, absmax, mean, sign_signature(xf)


def _analyze_adapter(
    catalog: Catalog,
    reader: ModelReader,
    base_reader: Optional[ModelReader],
    model_id: str,
    block_size: int,
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
    import hashlib

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
        for i, rng in enumerate(ranges):
            x = to_float32(delta[rng.offset // itemsize : rng.end // itemsize])
            l2, absmax, mean, sig = _block_stats(x)
            cost_bytes = (
                factor_bytes - per_block * (len(ranges) - 1)
                if i == len(ranges) - 1 else per_block
            )
            h = hashlib.blake2b(x.tobytes(), digest_size=8)
            block_rows.append(
                (model_id, t, block_size, rng.block_idx, cost_bytes,
                 h.hexdigest(), l2, absmax, mean, sig, l2, None)
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
) -> Dict[str, float]:
    """Run (or reuse) ANALYZE for ``model_id``. Returns summary stats.

    Catalog hit => metadata-only, zero parameter I/O (the paper's reuse
    path).  Miss => one full scan of the checkpoint, tagged ``analyze``.
    """
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
                catalog, reader, base_reader, model_id, block_size
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
            for rng in blk.partition(spec.nbytes, block_size):
                x = reader.read_block(tensor_id, rng.block_idx, block_size, "analyze")
                xf = to_float32(x)
                l2, absmax, mean, sig = _block_stats(xf)
                l2_delta: Optional[float] = None
                cos_base: Optional[float] = None
                if is_delta:
                    l2_delta = l2
                elif base_spec is not None:
                    x0 = base_reader.read_block(
                        tensor_id, rng.block_idx, block_size, "analyze"
                    )
                    x0f = to_float32(x0)
                    l2_delta = float(np.linalg.norm(xf - x0f))
                    denom = l2 * float(np.linalg.norm(x0f))
                    cos_base = float(np.dot(xf, x0f) / denom) if denom > 0 else 0.0
                    sig = sign_signature(xf - x0f)  # signature of the task vector
                import hashlib

                h = hashlib.blake2b(np.ascontiguousarray(x).tobytes(), digest_size=8)
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
                        sig,
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
