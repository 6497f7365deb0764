"""Block partitioning — the paper's ``Partition(T; s)`` (§2.2, §3.3).

A model checkpoint is a collection of named tensors.  Each tensor ``T`` is
partitioned by a *deterministic* function ``Partition(T; s)`` into fixed-size
blocks, where ``s`` is the block size **in bytes**.  A block id
``(model_id, tensor_id, block_idx)`` uniquely locates a physical block in
storage.  Blocks are contiguous byte ranges over the row-major flattened
tensor, so block_idx -> byte range is pure arithmetic and never requires
reading the tensor.

This module is dependency-free (no jax/numpy) so every layer — catalog,
planner, executor, storage — can share one definition of block geometry.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

#: Default block size in bytes (paper Table 6: 64k–128k is the robust
#: sweet spot; we default to 128 KiB).
DEFAULT_BLOCK_SIZE = 128 * 1024


@dataclasses.dataclass(frozen=True, order=True)
class BlockId:
    """Stable identifier ``⟨model_id, tensor_id, block_idx⟩`` (§2.2)."""

    model_id: str
    tensor_id: str
    block_idx: int

    def key(self) -> Tuple[str, str, int]:
        return (self.model_id, self.tensor_id, self.block_idx)

    def __str__(self) -> str:  # used in manifests / lineage records
        return f"{self.model_id}::{self.tensor_id}::{self.block_idx}"

    @staticmethod
    def parse(s: str) -> "BlockId":
        model_id, tensor_id, idx = s.rsplit("::", 2)
        return BlockId(model_id, tensor_id, int(idx))


@dataclasses.dataclass(frozen=True)
class BlockRange:
    """Byte range of one block inside a tensor's flat byte buffer."""

    block_idx: int
    offset: int  # byte offset into the flattened tensor
    nbytes: int  # length of this block (last block may be short)

    @property
    def end(self) -> int:
        return self.offset + self.nbytes


def num_blocks(tensor_nbytes: int, block_size: int = DEFAULT_BLOCK_SIZE) -> int:
    """Number of blocks produced by ``Partition(T; s)`` for a tensor."""
    if tensor_nbytes < 0:
        raise ValueError(f"negative tensor size {tensor_nbytes}")
    if block_size <= 0:
        raise ValueError(f"block size must be positive, got {block_size}")
    if tensor_nbytes == 0:
        return 0
    return -(-tensor_nbytes // block_size)  # ceil div


def block_range(
    tensor_nbytes: int, block_idx: int, block_size: int = DEFAULT_BLOCK_SIZE
) -> BlockRange:
    """Byte range of block ``block_idx``; deterministic, never reads data."""
    n = num_blocks(tensor_nbytes, block_size)
    if not 0 <= block_idx < n:
        raise IndexError(
            f"block_idx {block_idx} out of range for tensor of {tensor_nbytes} "
            f"bytes with block_size {block_size} ({n} blocks)"
        )
    offset = block_idx * block_size
    nbytes = min(block_size, tensor_nbytes - offset)
    return BlockRange(block_idx, offset, nbytes)


def partition(
    tensor_nbytes: int, block_size: int = DEFAULT_BLOCK_SIZE
) -> List[BlockRange]:
    """``Partition(T; s)`` — the full deterministic block list for a tensor."""
    return [
        block_range(tensor_nbytes, i, block_size)
        for i in range(num_blocks(tensor_nbytes, block_size))
    ]


def iter_block_ids(
    model_id: str,
    tensor_id: str,
    tensor_nbytes: int,
    block_size: int = DEFAULT_BLOCK_SIZE,
) -> Iterator[BlockId]:
    for i in range(num_blocks(tensor_nbytes, block_size)):
        yield BlockId(model_id, tensor_id, i)


def coalesce_ranges(
    ranges: List[BlockRange], gap: int = 0
) -> List[Tuple[int, int]]:
    """Merge adjacent block ranges into maximal contiguous (offset, nbytes)
    runs.  This is the beyond-paper "batched block streaming" optimization:
    planning stays block-granular but physical reads become large sequential
    I/O (removes the small-block penalty of paper Table 6).

    ``gap`` tolerates up to that many unselected bytes between two ranges
    before splitting the run: on high-latency storage one slightly larger
    sequential read beats two round trips.  Runs may then cover bytes no
    range requested; callers account those separately (see
    ``ModelReader.read_blocks_coalesced``).  ``gap=0`` merges only
    strictly adjacent ranges (the historical behavior).
    """
    if gap < 0:
        raise ValueError(f"coalesce gap must be >= 0, got {gap}")
    if not ranges:
        return []
    ordered = sorted(ranges, key=lambda r: r.offset)
    runs: List[Tuple[int, int]] = []
    start, end = ordered[0].offset, ordered[0].end
    for r in ordered[1:]:
        if r.offset <= end + gap:  # within tolerance — extend the run
            end = max(end, r.end)
        else:
            runs.append((start, end - start))
            start, end = r.offset, r.end
    runs.append((start, end - start))
    return runs
