"""Plain PyTorch versions of the Hopper kernels: merge, ANALYZE sketch
and attention.

Merge shapes (the executor's batched layout):
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

:func:`sketch_ref` is the plain version of the ANALYZE sketch kernel
(``sketch_kernel`` in ``csrc/merge_block.cu``): per row Σx², max|x|
and Σx in float32.  Its kernel agrees within a tolerance on the sums
(another summation order) and bit for bit on max|x|.

:func:`flash_attention_ref` is the plain version of the flash-attention
kernel (``csrc/flash_attention.cu``), a port of the JAX package's chunked
attention; its kernel agrees within a tolerance, not bit for bit (sums
over head dim and keys run in another order).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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
    x0: torch.Tensor, D: torch.Tensor, mul: float = 1.0, div: float = 1.0,
    div_rows: torch.Tensor = None,
) -> torch.Tensor:
    """out = x0 + (mul · Σ_k Δ_k) / div (AVG: mul=1, div=K+1; TA: mul=λ);
    ``div_rows`` (NB,), when given, divides row b by ``div_rows[b]``."""
    d = _f32(div, D.device) if div_rows is None else div_rows[:, None]
    return x0 + (_f32(mul, D.device) * _ksum(D)) / d


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


def sketch_ref(x: torch.Tensor) -> torch.Tensor:
    """(NB, W) float32 -> (NB, 3) float32 per-row [Σx², max|x|, Σx].
    A NaN in a row makes its max|x| NaN, as ``np.max`` does."""
    return torch.stack([(x * x).sum(dim=1), x.abs().amax(dim=1),
                        x.sum(dim=1)], dim=1)


# ------------------------------------------------------- flash attention
_NEG = -1.0e30


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, hdv)
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    cq: int = 512,
    ck: int = 1024,
    skip_masked_chunks: bool = False,
) -> torch.Tensor:
    """Chunked online-softmax attention: the JAX package's
    ``models/attention.py::flash_attention`` step for step (pad to whole
    chunks, GQA by reshaping queries to (Hkv, g), float32 scores and
    accumulator, ``-1e30`` for masked scores, ``acc / max(l, 1e-30)``).
    ``skip_masked_chunks`` bounds the key loop to the causal / window
    reach of each query chunk, as the reference does at prefill."""
    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    hdv = v.shape[-1]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)

    cq = min(cq, sq)
    ck = min(ck, sk)
    pad_q = (-sq) % cq
    pad_k = (-sk) % ck
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = qp.shape[1] // cq, kp.shape[1] // ck
    qc = qp.reshape(b, nq, cq, hkv, g, hd)
    kc = kp.reshape(b, nk, ck, hkv, hd)
    vc = vp.reshape(b, nk, ck, hkv, hdv)
    dev = q.device
    out = torch.empty((b, nq * cq, h, hdv), dtype=torch.float32, device=dev)

    for qi in range(nq):
        qblk = qc[:, qi].float()  # (B, cq, Hkv, g, hd)
        qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, hkv, g, cq), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, hdv), dtype=torch.float32,
                          device=dev)
        if skip_masked_chunks and (causal or window > 0):
            q_hi = q_offset + qi * cq + cq
            hi = min(nk, _cdiv(q_hi, ck)) if causal else nk
            lo = max(0, (q_offset + qi * cq - window + 1) // ck) \
                if window > 0 else 0
            tiles = range(lo, hi)
        else:
            tiles = range(nk)
        for kj in tiles:
            kpos = kj * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk,
                             kc[:, kj].float()) * scale  # (B, Hkv, g, cq, ck)
            valid = (kpos < sk)[None, :]
            if causal:
                valid = valid & (qpos[:, None] >= kpos[None, :])
            if window > 0:
                valid = valid & (qpos[:, None] - kpos[None, :] < window)
            s = torch.where(valid, s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None]) * valid.float()
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vc[:, kj].float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        # (B, Hkv, g, cq, hdv) -> (B, cq, H, hdv)
        out[:, qi * cq:(qi + 1) * cq] = o.permute(0, 3, 1, 2, 4).reshape(
            b, cq, h, hdv)
    return out[:, :sq].to(q.dtype)
