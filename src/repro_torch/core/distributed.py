"""Sharded merge execution on the port: the packed whole-shard merge.

The JAX package's version (``repro.core.distributed``) merges a plan
across a TPU mesh.  Here the same packed layout runs on one device (the
shard worker's ``kernel="mesh"``, :mod:`repro_torch.dist.worker`); the
device meshes come with the port's mesh layer.

Layout: model parameters are flattened, padded, and viewed as a block
matrix ``(NB, W)``, ``W`` the stored block's element count.  The plan's
selection becomes a dense ``(K, NB)`` mask that gates expert deltas;
zeroed (unselected) deltas are mathematically inert for every operator
(TA/DARE: zero contribution; AVG: per-block count divisor; TIES: zero
rows can never win the sign election) so the result matches the
streaming executor block-for-block (TIES: but for the tail blocks of
ragged tensors, see :func:`pack_arrays`).

The packing and mask builders are copies of the reference's, on numpy.
:func:`merge_blocks_masked` applies the operator to the whole stack on
a device: the port's Hopper merge kernels on a CUDA device (AVG divides
each row by its own ``k_sel + 1`` through the linear kernel's per-row
divisor), their plain versions on the CPU.  :func:`build_merge_step`
binds it to one device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.plan import MergePlan

#: the most rows one merge kernel launch takes (the grid's y extent)
MAX_LAUNCH_ROWS = 65535


# ----------------------------------------------------------- param packing
def pack_arrays(
    arrays: Dict[str, np.ndarray], block_elems: int
) -> Tuple[np.ndarray, List[Tuple[str, Tuple[int, ...], int, int]]]:
    """Flatten float tensors into a padded (NB, W) block matrix.

    Each tensor is padded *individually* to a block multiple, so packed
    blocks map 1:1 onto the per-tensor block grid used by plans (exact
    selection, no boundary straddling).  Returns (blocks, meta) with
    meta = [(name, shape, size, block_offset)].  Non-float tensors are
    excluded (they pass through unmerged).

    Tail-block note: the last block of a ragged tensor carries zero
    padding; for TIES the trim count is computed over the padded width,
    which can deviate from the streaming engine on that one block per
    tensor (bounded, measured in tests; <1e-4 of params at LLM scale).
    """
    metas: List[Tuple[str, Tuple[int, ...], int, int]] = []
    chunks: List[np.ndarray] = []
    block_off = 0
    for name in sorted(arrays):
        a = arrays[name]
        if not np.issubdtype(np.asarray(a).dtype, np.floating):
            continue
        flat = np.asarray(a, np.float32).reshape(-1)
        pad = (-flat.size) % block_elems
        padded = np.pad(flat, (0, pad))
        chunks.append(padded)
        metas.append((name, tuple(a.shape), flat.size, block_off))
        block_off += padded.size // block_elems
    if not chunks:
        return np.zeros((0, block_elems), np.float32), metas
    return np.concatenate(chunks).reshape(-1, block_elems), metas


def unpack_arrays(
    blocks: np.ndarray, metas: List[Tuple[str, Tuple[int, ...], int, int]]
) -> Dict[str, np.ndarray]:
    flat = np.asarray(blocks)
    w = flat.shape[1]
    flat = flat.reshape(-1)
    out: Dict[str, np.ndarray] = {}
    for name, shape, size, block_off in metas:
        lo = block_off * w
        out[name] = flat[lo : lo + size].reshape(shape)
    return out


def selection_mask(
    plan: MergePlan,
    metas: List[Tuple[str, Tuple[int, ...], int, int]],
    block_elems: int,
    n_blocks: int,
) -> np.ndarray:
    """Dense (K, NB) mask over the packed block space from plan.selection.

    With per-tensor aligned packing, per-tensor block ``tb`` of tensor
    ``t`` is exactly packed block ``block_offset(t) + tb`` — selection is
    exact, and budget accounting matches the plan."""
    sel = np.zeros((len(plan.expert_ids), n_blocks), dtype=bool)
    offsets = {name: block_off for name, _s, _n, block_off in metas}
    for ei, e in enumerate(plan.expert_ids):
        for tensor_id, t_blocks in plan.selection.get(e, {}).items():
            if tensor_id not in offsets:
                continue
            base = offsets[tensor_id]
            for tb in t_blocks:
                sel[ei, base + tb] = True
    return sel


def dare_masks_packed(
    plan: MergePlan,
    metas: List[Tuple[str, Tuple[int, ...], int, int]],
    block_elems: int,
    n_blocks: int,
) -> np.ndarray:
    """(K, NB, W) keep-masks matching the streaming engine's Philox masks.

    The Philox stream has the prefix property (first n draws are identical
    regardless of how many are requested), so padded-width masks agree
    with the streaming engine on every real element."""
    from repro_torch.core.operators import dare_mask

    seed = int(plan.theta.get("seed", 0))
    density = float(plan.theta.get("density", 0.5))
    offsets = {name: block_off for name, _s, _n, block_off in metas}
    masks = np.zeros((len(plan.expert_ids), n_blocks, block_elems), dtype=bool)
    for ei, e in enumerate(plan.expert_ids):
        for tensor_id, t_blocks in plan.selection.get(e, {}).items():
            if tensor_id not in offsets:
                continue
            base = offsets[tensor_id]
            for tb in t_blocks:
                masks[ei, base + tb] = dare_mask(
                    seed, ei, tensor_id, tb, block_elems, density
                )
    return masks


# ------------------------------------------------------- whole-shard step
def merge_blocks_masked(
    base,                   # (NB, W)
    experts,                # (K, NB, W)  deltas (kind="delta") or weights
    select,                 # (K, NB) bool
    op: str,
    theta: Dict,
    kind: str = "delta",
    dare_masks=None,        # (K, NB, W) bool, DARE only
    device="cuda",
):
    """The reference's ``_merge_blocks_masked`` on ``device``: returns
    the (NB, W) float32 merged blocks as a tensor there.

    Inputs are arrays or tensors; they are not modified.  The deltas are
    staged once into the kernels' (NB, K, W) layout, unselected rows set
    to +0.0 (the reference multiplies by the mask), and each operator
    runs through its kernel wrapper, in launches of at most
    :data:`MAX_LAUNCH_ROWS` blocks: AVG through ``linear_merge`` with
    the per-row divisor ``k_sel + 1``, TA through ``linear_merge``, TIES
    by the route ``ties_route`` names for the launch, DARE through
    ``dare_merge``.
    """
    import torch

    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels.ops import resolve_device

    dev = resolve_device(device)
    if kind not in ("full", "delta"):
        raise ValueError(f"unknown model kind {kind!r}")
    if op == "dare" and dare_masks is None:
        raise ValueError("dare requires masks")
    if op not in ("avg", "ta", "ties", "dare"):
        raise KeyError(op)
    x0 = torch.as_tensor(base, dtype=torch.float32).to(dev).contiguous()
    sel = torch.as_tensor(select, dtype=torch.bool).to(dev)
    E = torch.as_tensor(experts, dtype=torch.float32).to(dev)
    k, nb, w = E.shape
    if tuple(x0.shape) != (nb, w) or tuple(sel.shape) != (k, nb):
        raise ValueError(f"want base (NB, W), experts (K, NB, W), select "
                         f"(K, NB); got {tuple(x0.shape)}, {tuple(E.shape)}, "
                         f"{tuple(sel.shape)}")
    D = torch.empty((nb, k, w), dtype=torch.float32, device=dev)
    D.copy_(E.transpose(0, 1))
    del E
    if kind == "full":
        D.sub_(x0[:, None])
    D.masked_fill_(~sel.t()[:, :, None], 0.0)
    M = None
    if op == "dare":
        M = torch.empty((nb, k, w), dtype=torch.uint8, device=dev)
        M.copy_(torch.as_tensor(dare_masks, dtype=torch.bool).to(dev)
                .transpose(0, 1))
    lam = float(theta.get("lam", 1.0))
    div_rows = sel.sum(dim=0).float() + 1.0 if op == "avg" else None
    parts = []
    for lo in range(0, nb, MAX_LAUNCH_ROWS):
        hi = min(nb, lo + MAX_LAUNCH_ROWS)
        x, d = x0[lo:hi], D[lo:hi]
        if op == "avg":
            parts.append(mb.linear_merge(x, d, 1.0, 1.0,
                                         div_rows=div_rows[lo:hi]))
        elif op == "ta":
            parts.append(mb.linear_merge(x, d, lam, 1.0))
        elif op == "ties":
            trim = float(theta.get("trim_frac", 0.2))
            if mb.ties_route(*d.shape) == "fused":
                parts.append(mb.ties_fused(x, d, trim, lam))
            else:
                parts.append(mb.ties_merge(x, d, mb.ties_thresholds(d, trim),
                                           lam))
        else:
            parts.append(mb.dare_merge(x, d, M[lo:hi],
                                       float(theta.get("density", 0.5)), lam))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def build_merge_step(op: str, theta: Dict, kind: str = "delta",
                     device="cuda"):
    """:func:`merge_blocks_masked` bound to one device (resolved now, so
    a missing card fails before any work): ``step(base, experts,
    select, dare_masks=None)``."""
    from repro_torch.kernels.ops import resolve_device

    dev = resolve_device(device)

    def step(base, experts, select, dare_masks=None):
        return merge_blocks_masked(base, experts, select, op, theta, kind,
                                   dare_masks, dev)

    return step


def shard_plan_by_host(
    plan: MergePlan, n_hosts: int, catalog=None
) -> List[Dict]:
    """Partition a plan's selected (expert, tensor, block) triples across
    hosts so each host reads <= ceil(Ĉ_expert / n_hosts) bytes (per-host
    budget).  Deterministic greedy (LPT) over size-sorted units.

    With ``catalog`` the cost model matches the planner's marginal-byte
    accounting (``planner._selection_bytes``): ragged tail blocks are
    billed at their physical size, elided packed blocks at zero, and the
    triples that share one packed extent form a single atomic unit so
    the shared extent is charged — and read — once per host.  Without a
    catalog every block falls back to the legacy ``plan.block_size``
    estimate (an upper bound that overcounts tails and dedup)."""
    # unit = [(bytes, expert, tensor, blk), ...] scheduled atomically;
    # multi-item units are the triples sharing one packed extent
    units: List[List[Tuple[int, str, str, int]]] = []
    if catalog is not None:
        from repro_torch.core.planner import _selection_bytes

        costs = _selection_bytes(catalog, plan, {})
        by_extent: Dict[str, List[Tuple[int, str, str, int]]] = {}
        for e, per_t in plan.selection.items():
            for t, bs in per_t.items():
                for b in bs:
                    nbytes, extent_key = costs.get(
                        (e, t, b), (plan.block_size, None))
                    if extent_key is None:
                        units.append([(nbytes, e, t, b)])
                    else:
                        by_extent.setdefault(extent_key, []).append(
                            (nbytes, e, t, b))
        for key in sorted(by_extent):
            grp = sorted(by_extent[key], key=lambda it: (it[1], it[2], it[3]))
            # the extent moves once per host no matter how many triples
            # it serves: bill its physical size on the first item only
            units.append([grp[0]] + [(0, e, t, b) for _n, e, t, b in grp[1:]])
    else:
        for e, per_t in plan.selection.items():
            for t, bs in per_t.items():
                for b in bs:
                    units.append([(plan.block_size, e, t, b)])
    units.sort(
        key=lambda u: (-sum(it[0] for it in u), u[0][1], u[0][2], u[0][3])
    )
    buckets: List[Dict] = [
        {"host": h, "bytes": 0, "items": []} for h in range(n_hosts)
    ]
    for unit in units:
        tgt = min(buckets, key=lambda bkt: (bkt["bytes"], bkt["host"]))
        for nbytes, e, t, b in unit:
            tgt["items"].append((e, t, b))
            tgt["bytes"] += nbytes
    return buckets
