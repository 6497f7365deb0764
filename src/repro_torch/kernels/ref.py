"""Plain PyTorch versions of the merge kernels.

Shapes (the executor's batched layout):
    x0     (NB, W)        base blocks, float32
    D      (NB, K, W)     stacked expert deltas, float32
    masks  (NB, K, W)     DARE keep masks (bool or uint8)
    thresh (NB, K)        TIES per-(block, expert) trim thresholds

Each function repeats the host numpy operator's float operations in the
same order (:mod:`repro_torch.core.operators`): the K sum starts from
row 0 and adds rows in order, and TIES finishes in float64 as numpy
promotes its integer count there.  The Hopper kernels in
``csrc/merge_block.cu`` do the same, so on equal inputs all three agree
bit for bit.  These are the CPU path of the kernel wrappers
(:mod:`repro_torch.kernels.merge_block`) and the oracle the kernels are
held against on the card.
"""
from __future__ import annotations

import torch


def ties_keep(trim_frac: float, w: int) -> int:
    """Entries kept per row: ``max(1, round(ρ·W))`` with Python's
    round-half-to-even, as the numpy operator."""
    return max(1, int(round(trim_frac * w)))


def ties_thresholds(D: torch.Tensor, trim_frac: float) -> torch.Tensor:
    """keep-th largest |Δ| per (block, expert) row; ``-inf`` when every
    entry is kept.  Entries equal to the threshold are kept (``>=``)."""
    nb, k, w = D.shape
    keep = ties_keep(trim_frac, w)
    if keep >= w:
        return torch.full((nb, k), float("-inf"), dtype=torch.float32,
                          device=D.device)
    return torch.kthvalue(D.abs(), w - keep + 1, dim=-1).values


def _ksum(X: torch.Tensor) -> torch.Tensor:
    """Sum (NB, K, W) over K in order, starting from row 0 (numpy's
    axis-0 sum of a (K, W) stack)."""
    acc = X[:, 0]
    for k in range(1, X.shape[1]):
        acc = acc + X[:, k]
    return acc


def _f32(x: float, device) -> torch.Tensor:
    """A float32 scalar: the operand numpy's float32 arithmetic uses."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def linear_ref(
    x0: torch.Tensor, D: torch.Tensor, mul: float = 1.0, div: float = 1.0
) -> torch.Tensor:
    """out = x0 + (mul · Σ_k Δ_k) / div (AVG: mul=1, div=K+1; TA: mul=λ)."""
    return x0 + (_f32(mul, D.device) * _ksum(D)) / _f32(div, D.device)


def avg_ref(x0: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    return linear_ref(x0, D, 1.0, float(D.shape[1] + 1))


def ta_ref(x0: torch.Tensor, D: torch.Tensor, lam: float = 1.0) -> torch.Tensor:
    return linear_ref(x0, D, lam, 1.0)


def ties_apply_ref(
    x0: torch.Tensor, D: torch.Tensor, thresh: torch.Tensor, lam: float = 1.0
) -> torch.Tensor:
    """Trim (by precomputed thresholds) -> elect sign -> sign-matched mean."""
    mask = D.abs() >= thresh[..., None]
    Dt = torch.where(mask, D, 0.0)
    elected = torch.sign(_ksum(Dt))
    agree = (torch.sign(Dt) == elected[:, None, :]) & mask & (elected != 0)[:, None, :]
    num = _ksum(torch.where(agree, Dt, 0.0))
    cnt = agree.sum(dim=1).clamp(min=1)
    mean = num.double() / cnt.double()
    return (x0.double() + lam * mean).float()


def ties_ref(
    x0: torch.Tensor, D: torch.Tensor, trim_frac: float = 0.2, lam: float = 1.0
) -> torch.Tensor:
    return ties_apply_ref(x0, D, ties_thresholds(D, trim_frac), lam)


def dare_ref(
    x0: torch.Tensor,
    D: torch.Tensor,
    masks: torch.Tensor,
    density: float = 0.5,
    lam: float = 1.0,
) -> torch.Tensor:
    rescaled = torch.where(masks.bool(), D, 0.0) / _f32(density, D.device)
    return x0 + _f32(lam, D.device) * _ksum(rescaled)
