"""DeltaIterator — unified streaming access to heterogeneous experts (§5.2).

For tensor ``t``, ``InitDeltaIterator(t, π, M0, {Mi})`` builds an iterator
whose ``pull(b)`` returns exactly the selected expert contributions
{Δ_i} for block ``b`` — and performs expert I/O *iff* (i, t, b) is in the
plan's realized read set (budget soundness, §5.1).

Supported expert kinds (checkpoint meta ``kind``):
    full     — expert stores full weights;        Δ = expert_block - base_block
    delta    — expert stores task vectors;        Δ = expert_block
    adapter  — expert stores LoRA factors         Δ = scale · (B @ A), sliced
               ``<tensor>::lora_A`` (r, in) and    blockwise from the
               ``<tensor>::lora_B`` (out, r);      materialized product

Physical reads go through the coalescing path by default (adjacent
selected blocks become one sequential read — beyond-paper optimization;
set ``coalesce=False`` for the paper-faithful per-block I/O pattern).
Both paths move exactly the same expert bytes; only the syscall pattern
differs, so budget accounting is identical.

Two materialization modes:

* **lazy** (default) — the first ``pull`` reads the tensor's whole
  realized selection per expert (the stream/batched executor paths);
* **windowed** — the pipelined executor calls ``prefetch(blocks)`` ahead
  of compute (from its reader pool) and ``release_blocks(blocks)`` /
  ``release_adapters()`` behind it, so resident expert blocks stay
  bounded by the pipeline window instead of the tensor's full selection.
  ``pull`` then serves from the window cache only and performs **no I/O
  on the compute thread**.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import blocks as blk
from repro_torch.core.plan import MergePlan
from repro_torch.store.dtypes import from_float32, to_float32
from repro_torch.store.tensorstore import ModelReader

#: sentinel returned by a source for an elided packed block: the delta is
#: exactly zero, synthesized with no expert I/O at all (the packed layout
#: stores such blocks as metadata-only entries — store/packed)
ELIDED = object()


class _ExpertTensorSource:
    """Per (expert, tensor) block source implementing the three kinds."""

    def __init__(
        self,
        reader: ModelReader,
        tensor_id: str,
        base_spec,
        selected: Sequence[int],
        block_size: int,
        coalesce: bool,
        windowed: bool = False,
        coalesce_gap: int = 0,
    ):
        self.reader = reader
        self.tensor_id = tensor_id
        self.base_spec = base_spec
        self.block_size = block_size
        self.kind = reader.meta.get("kind", "full")
        self.scale = float(reader.meta.get("scale", 1.0))
        self.selected = list(selected)
        self._selected_set = frozenset(self.selected)
        self.coalesce = coalesce
        self.coalesce_gap = coalesce_gap
        self.windowed = windowed
        # packed-layout readers mark (near-)zero-delta blocks as elided:
        # those selected blocks cost zero reads — pull() synthesizes them
        elided = getattr(reader, "elided_blocks", None)
        self._elided = (
            frozenset(elided(tensor_id)) & self._selected_set
            if elided is not None else frozenset()
        )
        self._read_list = [b for b in self.selected if b not in self._elided]
        self._cache: Dict[int, np.ndarray] = {}
        self._adapter_delta: Optional[np.ndarray] = None
        self._prefetched = False
        #: serializes adapter materialization when the pipelined engine
        #: stages several windows of this tensor concurrently (the block
        #: sets are disjoint, but the factor read must happen once)
        self._adapter_lock = threading.Lock()

    # ---------------------------------------------------------------- kinds
    def _prefetch_direct(self) -> None:
        """full/delta kinds: read the selected blocks (coalesced or not)."""
        if self.coalesce:
            self._cache = self.reader.read_blocks_coalesced(
                self.tensor_id, self._read_list, self.block_size, "expert",
                gap_bytes=self.coalesce_gap,
            )
        else:
            for b in self._read_list:
                self._cache[b] = self.reader.read_block(
                    self.tensor_id, b, self.block_size, "expert"
                )
        self._prefetched = True

    def _materialize_adapter(self) -> None:
        """adapter kind: Δ-tensor = scale · (B @ A); factors are tiny and
        read in full (counted as expert reads), then sliced blockwise."""
        a_name = f"{self.tensor_id}::lora_A"
        b_name = f"{self.tensor_id}::lora_B"
        A = self.reader.read_tensor(a_name, "expert")
        B = self.reader.read_tensor(b_name, "expert")
        delta = (to_float32(B) @ to_float32(A)) * self.scale
        self._adapter_delta = from_float32(
            delta.reshape(-1), self.base_spec.dtype
        )
        self._prefetched = True

    # ------------------------------------------------- windowed prefetch
    def prefetch(self, blocks: Sequence[int]) -> int:
        """Read the plan-selected subset of ``blocks`` ahead of compute.

        Called from the pipelined executor's reader pool (never from the
        compute thread).  Returns the number of expert blocks now newly
        resident, so the engine can account in-flight memory.  Adapter
        experts materialize their (tiny-factor) Δ-tensor on first touch
        and count as one resident unit thereafter.
        """
        want = [
            b for b in blocks
            if b in self._selected_set
            and b not in self._elided  # elided: synthesized, never read
            and b not in self._cache
        ]
        if not want:
            return 0
        if self.kind == "adapter":
            with self._adapter_lock:
                if self._prefetched:
                    return 0
                self._materialize_adapter()
            return 1
        if self.coalesce:
            self._cache.update(
                self.reader.read_blocks_coalesced(
                    self.tensor_id, want, self.block_size, "expert",
                    gap_bytes=self.coalesce_gap,
                )
            )
        else:
            for b in want:
                self._cache[b] = self.reader.read_block(
                    self.tensor_id, b, self.block_size, "expert"
                )
        self._prefetched = True
        return len(want)

    def release_blocks(self, blocks: Sequence[int]) -> int:
        """Drop exactly these cached blocks (one retired window; windows
        are disjoint, so concurrent staging of other windows is unaffected).
        The adapter Δ-tensor is kept until the tensor finishes — it is
        materialized once per tensor and sliced by every window — and is
        retired via :meth:`release_adapter`."""
        if self.kind == "adapter":
            return 0
        n = 0
        for b in blocks:
            if self._cache.pop(b, None) is not None:
                n += 1
        return n

    def release_adapter(self) -> int:
        """Drop the materialized adapter Δ-tensor (tensor complete).
        Returns the resident units retired (matching what ``prefetch``
        charged), so the engine's residency gauge balances."""
        if self._adapter_delta is None:
            return 0
        self._adapter_delta = None
        return 1

    def resident_blocks(self) -> int:
        return len(self._cache) + (1 if self._adapter_delta is not None else 0)

    def has_tensor(self) -> bool:
        if self.kind == "adapter":
            return f"{self.tensor_id}::lora_A" in self.reader.specs
        return self.tensor_id in self.reader.specs

    def pull(self, block_idx: int) -> Optional[np.ndarray]:
        if block_idx not in self._selected_set:
            return None
        if block_idx in self._elided:
            return ELIDED  # zero delta, zero I/O — caller synthesizes
        if not self._prefetched:
            if self.windowed:
                raise RuntimeError(
                    f"windowed source for {self.tensor_id}: block {block_idx} "
                    f"pulled before prefetch (pipeline ordering bug)"
                )
            if self.kind == "adapter":
                self._materialize_adapter()
            else:
                self._prefetch_direct()
        if self.kind == "adapter":
            rng = blk.block_range(
                self.base_spec.nbytes, block_idx, self.block_size
            )
            itemsize = self.base_spec.dtype.itemsize
            lo = rng.offset // itemsize
            hi = rng.end // itemsize
            return self._adapter_delta[lo:hi]
        arr = self._cache.get(block_idx)
        if arr is None and self.windowed:
            raise RuntimeError(
                f"windowed source for {self.tensor_id}: selected block "
                f"{block_idx} not resident (released early or never prefetched)"
            )
        return arr


class DeltaIterator:
    """Algorithm 2's ``D`` for one tensor: pull(b) -> stacked Δ (K_sel, n)."""

    def __init__(
        self,
        tensor_id: str,
        plan: MergePlan,
        base_reader: ModelReader,
        expert_readers: Dict[str, ModelReader],
        coalesce: bool = True,
        windowed: bool = False,
        coalesce_gap: int = 0,
        read_from: int = 0,
    ):
        """``read_from`` restricts the realized read set to blocks at or
        above that index — the resume path: blocks below the journaled
        high-water mark are already staged, so their expert bytes must
        never be read (or charged) again."""
        self.tensor_id = tensor_id
        self.plan = plan
        self.base_spec = base_reader.spec(tensor_id)
        self.block_size = plan.block_size
        self._used_experts: List[str] = []
        self._sources: List[Tuple[int, str, _ExpertTensorSource]] = []
        for ei, e in enumerate(plan.expert_ids):
            sel = plan.blocks_for(e, tensor_id)
            if read_from > 0:
                sel = [b for b in sel if b >= read_from]
            if not sel:
                continue
            src = _ExpertTensorSource(
                expert_readers[e],
                tensor_id,
                self.base_spec,
                sel,
                self.block_size,
                coalesce,
                windowed=windowed,
                coalesce_gap=coalesce_gap,
            )
            if src.has_tensor():
                self._sources.append((ei, e, src))

    # ------------------------------------------------- windowed prefetch
    def prefetch_source(self, source_pos: int, blocks: Sequence[int]) -> int:
        """Prefetch one expert source's share of a window (the pipelined
        engine fans sources out over its reader pool as separate tasks)."""
        return self._sources[source_pos][2].prefetch(blocks)

    @property
    def n_sources(self) -> int:
        return len(self._sources)

    def release_blocks(self, blocks: Sequence[int]) -> int:
        """Retire a completed window: drop exactly its resident blocks."""
        return sum(src.release_blocks(blocks) for _, _, src in self._sources)

    def release_adapters(self) -> int:
        """Retire materialized adapter Δ-tensors (tensor complete)."""
        return sum(src.release_adapter() for _, _, src in self._sources)

    def resident_blocks(self) -> int:
        return sum(src.resident_blocks() for _, _, src in self._sources)

    def pull(
        self, block_idx: int, base_block: np.ndarray
    ) -> Tuple[np.ndarray, List[int], List[str]]:
        """Returns (stacked deltas (K_sel, n) float32, expert indexes,
        expert ids).  Performs expert I/O iff the plan selected the block."""
        deltas: List[np.ndarray] = []
        idxs: List[int] = []
        ids: List[str] = []
        base_f = None
        for ei, e, src in self._sources:
            x = src.pull(block_idx)
            if x is None:
                continue
            if x is ELIDED:
                # packed-layout elision: the stored block equals the base
                # (full kind) or zero (delta kind) bit-exactly, so its
                # delta row is exactly what the flat path would compute —
                # all zeros — at zero expert I/O.
                deltas.append(np.zeros(base_block.size, dtype=np.float32))
                idxs.append(ei)
                ids.append(e)
                continue
            xf = to_float32(x)
            if src.kind == "full":
                if base_f is None:
                    base_f = to_float32(base_block)
                xf = xf - base_f
            deltas.append(xf)
            idxs.append(ei)
            ids.append(e)
        self._used_experts = ids
        if deltas:
            return np.stack(deltas), idxs, ids
        n = base_block.size
        return np.zeros((0, n), dtype=np.float32), [], []

    def used_experts(self) -> List[str]:
        """Experts that contributed to the most recent block (coverage)."""
        return self._used_experts
