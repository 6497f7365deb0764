"""Naive baseline — the stateless, one-shot merging pipeline (paper §1, §6.1).

Faithful model of existing open-source merging scripts: every invocation
(i) loads the FULL base model, (ii) loads EVERY expert checkpoint in full
(`C_expert^naive = Σ_i Σ_T size(T)` — the O(K) term), (iii) applies the
operator tensor-at-a-time in memory, (iv) writes the output.  No catalog,
no planning, no reuse, no budget, no transactional publish.

This is the comparison target for every paper table; it shares the
operator implementations with MergePipe so measured deltas isolate the
*execution model*, exactly as the paper argues (§6.2 "baseline
strengthening": same metric interface, same operators).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.operators import apply_operator, dare_mask
from repro_torch.store.dtypes import to_float32
from repro_torch.store.tensorstore import CheckpointStore


def naive_merge(
    store: CheckpointStore,
    base_id: str,
    expert_ids: Sequence[str],
    op: str,
    theta: Optional[Dict] = None,
    out_id: Optional[str] = None,
) -> str:
    """One-shot full-scan merge. Returns the output model id."""
    t0 = time.time()
    theta = dict(theta or {})
    seed = int(theta.get("seed", 0))
    out_id = out_id or f"naive-{op}-{int(t0)}"

    base_reader = store.open_model(base_id)
    expert_readers = [store.open_model(e) for e in expert_ids]

    merged: Dict[str, np.ndarray] = {}
    try:
        for tensor_id in base_reader.tensor_names():
            spec = base_reader.spec(tensor_id)
            x0 = base_reader.read_tensor(tensor_id, "base")
            flat0 = to_float32(x0).reshape(-1)
            deltas: List[np.ndarray] = []
            eidxs: List[int] = []
            for ei, r in enumerate(expert_readers):
                # stateless pipeline: scans the expert tensor IN FULL,
                # every invocation, for every expert (the O(K) behavior)
                if r.meta.get("kind") == "adapter":
                    a = f"{tensor_id}::lora_A"
                    if a not in r.specs:
                        continue
                    A = to_float32(r.read_tensor(a, "expert"))
                    B = to_float32(
                        r.read_tensor(f"{tensor_id}::lora_B", "expert")
                    )
                    d = (B @ A).reshape(-1) * float(r.meta.get("scale", 1.0))
                elif tensor_id in r.specs:
                    x = r.read_tensor(tensor_id, "expert")
                    xf = to_float32(x).reshape(-1)
                    d = xf if r.meta.get("kind") == "delta" else xf - flat0
                else:
                    continue
                deltas.append(d)
                eidxs.append(ei)

            is_float = spec["dtype"] in ("bfloat16", "float16", "float32", "float64")
            if deltas and is_float:
                D = np.stack(deltas)
                if op.lower() == "dare":
                    theta["_masks"] = np.stack(
                        [
                            dare_mask(seed, ei, tensor_id, 0, flat0.size,
                                      float(theta.get("density", 0.5)))
                            for ei in eidxs
                        ]
                    )
                out = apply_operator(
                    x0.reshape(-1), D, op, theta
                ).reshape(spec.shape)
                theta.pop("_masks", None)
            else:
                out = x0
            merged[tensor_id] = out
    finally:
        base_reader.close()
        for r in expert_readers:
            r.close()

    store.write_model(out_id, merged, meta={"naive": True, "op": op})
    return out_id
