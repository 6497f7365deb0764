"""The float32 tensor-core route's arithmetic ("tf32x3") on the CPU.

``flash_attention_tf32_kernel`` and ``fa_backward_tf32`` (csrc/) take
each float32 product on the tensor cores as three TF32 products of split
operands: x = hi + lo, hi = rna(x) (x rounded to the nearest TF32 value,
ties away from zero: the low 13 mantissa bits cleared), lo = x - hi
(exact in float32), of which a TF32 product reads trunc(lo) (its low 13
bits dropped); a.b = hi_a.hi_b + hi_a.lo_b + lo_a.hi_b.  Here that split
is mirrored bit for bit in torch, and so is the kernels' order of sums:
each k8 step's three ``wgmma`` (m64nNk8) add eight products to an
accumulator, which this model takes as the float64 sum of the
accumulator and the products truncated toward zero to float32, and the
kernels' fresh accumulators (S's and dP's k-steps, P.V a key tile, dK /
dV a query tile, dQ a key tile, S at (192, 128)'s dK / dV and in the dQ
kernel excepted) are added in float32, rounded to nearest.  The forward
(o, lse) and its gradients, so computed for inputs made from a seed with
numpy at each pair the route takes, causal and windowed, are held
against the JAX package's ``flash_attention`` and its ``jax.vjp`` at the
float32 tolerances the card tests use (FA_TOL 2e-5; BWD_TOL rtol 1e-4,
atol 1e-5).  One TF32 product alone misses 2e-5 at hd 128: why the split
exists.  Running accumulators (one accumulator a product, as a plain
wgmma chain sums) drift further than the fresh ones.  The tensor cores
align the products with few guard bits before they truncate, so they
lose more than this model does: on the card a running S or dP failed
BWD_TOL at RecurrentGemma's float32 training shape (PERF.md), here the
running sums' errors are 2-5x the fresh ones' and stay inside, so the
test records the direction, not the card's size.  The route's plans are pinned under a
CTA's 232,448 bytes of shared memory."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

FA_TOL = 2e-5
BWD_TOL = {"rtol": 1e-4, "atol": 1e-5}
# (B, Sq, Sk, H, Hkv) and the masks (causal, window): small heads of the
# shapes the route serves and trains, GQA, a window past and inside a tile
SHAPE = (1, 128, 128, 4, 2)
MASKS = [(True, 0), (True, 48), (False, 0)]


def _trunc(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 operand is read as: the float32 word with its low 13
    mantissa bits cleared (sign, exponent and 10 mantissa bits kept)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _rna(x: torch.Tensor) -> torch.Tensor:
    """The kernels' ``tf32_rna``: x rounded to the nearest TF32 value, ties
    away from zero (0x1000 added to the word, then the low 13 bits
    cleared)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -8192).view(
        torch.float32)


def _split(x: torch.Tensor):
    """The kernels' ``tf32_split`` as the tensor cores read it: hi =
    rna(x), and trunc(lo) of lo = x - hi."""
    hi = _rna(x)
    return hi, _trunc(x - hi)


def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _wgmma(d: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One wgmma k8 step as this model takes it: d + a.b (a (..., M, 8),
    b (..., 8, N), TF32 values: each product exact in float64) summed in
    float64 and truncated toward zero to float32."""
    return _rz(d.double() + a.double() @ b.double())


def _gemm(a: torch.Tensor, b: torch.Tensor, fresh: bool = True,
          passes: int = 3, d: torch.Tensor | None = None) -> torch.Tensor:
    """a @ b (K a multiple of 8) as the kernels take it: each k8 step the
    three wgmma of the split operands (hi.hi, hi.lo, lo.hi), into a fresh
    accumulator added to the sum in float32 (``fresh``: gemm_tf32x3_rn)
    or all into one running accumulator starting from ``d`` (gemm_tf32x3,
    and P.V within a key tile); with ``passes`` 1, one wgmma a step of
    the float32 words as a TF32 product reads them (trunc(a).trunc(b))."""
    if passes == 1:
        (ha, la), (hb, lb) = (_trunc(a), None), (_trunc(b), None)
    else:
        (ha, la), (hb, lb) = _split(a), _split(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:]) if d is None else d
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        acc = torch.zeros_like(out) if fresh else out
        acc = _wgmma(acc, ha[..., ks], hb[..., ks, :])
        if passes == 3:
            acc = _wgmma(acc, ha[..., ks], lb[..., ks, :])
            acc = _wgmma(acc, la[..., ks], hb[..., ks, :])
        out = out + acc if fresh else acc
    return out


def _valid(sq, sk, causal, window):
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        valid &= qpos >= kpos
    if window > 0:
        valid &= qpos - kpos < window
    return valid


def _heads(q, k, *rest):
    """(B, S, H, w) -> (B, H, S, w), k and the rest repeated over each kv
    head's query heads."""
    g = q.shape[2] // k.shape[2]
    return [q.transpose(1, 2)] + [t.repeat_interleave(g, dim=2).transpose(
        1, 2) for t in (k, *rest)]


def _forward(q, k, v, causal, window, passes=3, running=False):
    """The forward kernel's arithmetic, a 32-key tile at a time: S = Q.K^T
    (fresh k-steps), scores scaled by 1/sqrt(hd), masked scores -1e30,
    the online softmax in natural units, P.V a tile into a fresh
    accumulator, O = alpha O + it (one rounding: the kernel's fmaf); o =
    O / max(l, 1e-30), lse = m + log(max(l, 1e-30)); (B, H, Sq, hdv) and
    (B, H, Sq).  ``running``: S over one accumulator, O scaled by alpha
    and the tile's P.V added into it."""
    qh, kh, vh = _heads(q, k, v)
    scale = torch.tensor(1.0 / q.shape[-1] ** 0.5)
    valid = _valid(q.shape[1], k.shape[1], causal, window)
    neg = torch.tensor(-1e30)
    m = torch.full(qh.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(qh.shape[:-1] + vh.shape[-1:])
    for k0 in range(0, k.shape[1], 32):
        ks = slice(k0, k0 + 32)
        s = _gemm(qh, kh[..., ks, :].transpose(-1, -2), not running, passes)
        s = torch.where(valid[:, ks], s * scale, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        m = m_new
        p = torch.where(valid[:, ks], torch.exp(s - m), torch.tensor(0.0))
        l = l * alpha + p.sum(-1, keepdim=True)
        if running:
            acc = _gemm(p, vh[..., ks, :], False, passes, d=acc * alpha)
        else:
            t = _gemm(p, vh[..., ks, :], False, passes)
            acc = (acc.double() * alpha.double() + t.double()).float()
    l = l.clamp(min=1e-30)
    return acc / l, (m + torch.log(l)).squeeze(-1)


def _backward(q, k, v, do, causal, window, running=False):
    """The backward kernels' arithmetic: the forward's o and lse; D =
    rowsum(dO o) (float32 FMAs); dP = dO.V^T (fresh k-steps); P =
    exp(scale S - lse) on the attended pairs, dS = P (dP - D), with S from
    fresh k-steps in the dK / dV kernel but at (192, 128), from one
    running accumulator in the dQ kernel; dV^T = dO^T.P and dK^T = Q^T.dS
    a 64-query tile into a fresh accumulator, dQ^T = K^T.dS^T a key tile
    (32 keys, 16 at (256, 256)) so; dK and dQ scaled at the store, dK and
    dV summed over each kv head's query heads in head order.
    ``running``: every product over one accumulator."""
    hd, hdv = q.shape[-1], v.shape[-1]
    hkv = k.shape[2]
    g = q.shape[2] // hkv
    scale = torch.tensor(1.0 / hd ** 0.5)
    bn = 16 if (hd, hdv) == (256, 256) else 32
    o, lse = _forward(q, k, v, causal, window, running=running)
    qh, kh, vh = _heads(q, k, v)
    doh = do.transpose(1, 2)
    valid = _valid(q.shape[1], k.shape[1], causal, window)
    d = (doh * o).sum(-1, keepdim=True)
    dp = _gemm(doh, vh.transpose(-1, -2), not running)

    def p_ds(fresh_s):
        s = _gemm(qh, kh.transpose(-1, -2), fresh_s)
        p = torch.where(valid, torch.exp(s * scale - lse[..., None]),
                        torch.tensor(0.0))
        return p, p * (dp - d)

    def tiles(a, b, step):  # a^T.b over the rows in tiles of `step`
        if running:
            return _gemm(a.transpose(-1, -2), b, False)
        return sum(_gemm(a[..., i:i + step, :].transpose(-1, -2),
                         b[..., i:i + step, :], False)
                   for i in range(0, a.shape[-2], step))

    p, ds = p_ds(not running and hd != 192)
    _, ds_q = p_ds(False)
    dv = tiles(doh, p, 64).transpose(-1, -2)
    dk = (tiles(qh, ds, 64) * scale).transpose(-1, -2)
    dq = (tiles(kh, ds_q.transpose(-1, -2), bn) * scale).transpose(-1, -2)

    def per_kv(x):  # (B, H, Sk, w) -> (B, Sk, Hkv, w), heads in order
        b, _, sk, w = x.shape
        return x.view(b, hkv, g, sk, w).sum(2).transpose(1, 2)

    return dq.transpose(1, 2), per_kv(dk), per_kv(dv)


def _inputs(hd, hdv, seed=0):
    b, sq, sk, h, hkv = SHAPE
    rng = np.random.default_rng(seed + hd + hdv)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hdv),
                      (b, sq, h, hdv))]


def _lse64(q, k, causal, window):
    """Each row's log-sum-exp of its scaled scores over the keys it
    attends, in float64 (B, H, Sq)."""
    g = q.shape[2] // k.shape[2]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  np.repeat(k, g, axis=2).astype(np.float64))
    s = s / np.sqrt(q.shape[-1])
    s = np.where(_valid(q.shape[1], k.shape[1], causal, window).numpy(), s,
                 -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


PAIRS = [pytest.param(hd, hdv, id=f"{hd}-{hdv}")
         for hd, hdv in tfa.TC_HEAD_DIMS]
MASK_IDS = [f"{'causal' if c else 'full'}-w{w}" for c, w in MASKS]


def test_split_is_exact():
    """hi and trunc(lo) are TF32 values (the tensor cores read them
    whole), lo = x - hi is exact in float32, and hi + trunc(lo) is within
    2^-21 of |x|, with errors of either sign: the ~22 bits of the split,
    where the TF32 word of x alone (trunc) keeps 11, all toward zero."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=4096).astype(np.float32)) * 10.0 ** torch.arange(
            -3, 5).repeat(512).float()
    hi, lo = _split(x)
    assert torch.equal(_trunc(hi), hi) and torch.equal(_trunc(lo), lo)
    assert torch.equal((x.double() - hi.double()).float().double(),
                       x.double() - hi.double())
    err = (hi.double() + lo.double() - x.double()) / x.double().abs()
    assert float(err.abs().max()) <= 2.0 ** -21
    assert float(err.min()) < 0 < float(err.max())
    one = (_trunc(x).double() - x.double()) / x.double().abs()
    assert float(one.abs().max()) > 2.0 ** -12
    assert bool((_trunc(x).abs() <= x.abs()).all())


@pytest.mark.parametrize("causal,window", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("hd,hdv", PAIRS)
def test_tf32x3_forward_matches_jax(hd, hdv, causal, window):
    """The forward with split products (o, lse) against the JAX package's
    flash_attention (o) and a float64 log-sum-exp (lse) at FA_TOL."""
    q, k, v, _ = _inputs(hd, hdv)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, cq=64, ck=64)
    o, lse = _forward(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                      window)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), np.asarray(want),
                               rtol=FA_TOL, atol=FA_TOL)
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k, causal, window),
                               rtol=FA_TOL, atol=FA_TOL)


@pytest.mark.parametrize("causal,window", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("hd,hdv", PAIRS)
def test_tf32x3_gradients_match_jax_vjp(hd, hdv, causal, window):
    """dq, dk, dv with every product of the backward split (and the
    forward's o and lse so computed) against ``jax.vjp`` of the JAX
    package's flash_attention at BWD_TOL."""
    q, k, v, do = _inputs(hd, hdv, seed=1)

    def f(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, causal=causal,
                                     window=window, cq=64, ck=64)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = _backward(*(torch.from_numpy(a) for a in (q, k, v, do)), causal,
                    window)
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), **BWD_TOL,
                                   err_msg=name)


def test_one_tf32_product_misses_the_float32_tolerance():
    """At hd 128 the forward with each product taken once in TF32 (hi.hi
    only) is outside FA_TOL of the JAX reference, where the split's three
    products are inside it."""
    q, k, v, _ = _inputs(128, 128)
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cq=64, ck=64))
    errs = {}
    for passes in (1, 3):
        o, _ = _forward(*(torch.from_numpy(a) for a in (q, k, v)), True, 0,
                        passes=passes)
        errs[passes] = float(np.abs(o.transpose(1, 2).numpy() - want).max())
    assert errs[3] <= FA_TOL < errs[1], errs


def test_running_accumulators_drift_further():
    """At a training length (512 queries and keys, hd 128, causal) the
    kernels' fresh accumulators against one running accumulator a
    product: the running sums' o, dq, dk and dv are each further from the
    JAX reference (``jax.vjp``) than the fresh sums', and the fresh ones
    are inside FA_TOL / BWD_TOL."""
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.normal(size=s).astype(np.float32)
                   for s in ((1, 512, 2, 128), (1, 512, 1, 128),
                             (1, 512, 1, 128), (1, 512, 2, 128)))

    def f(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, cq=64, ck=64)

    want_o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(want_o)] + [np.asarray(w) for w in vjp(
        jnp.asarray(do))]
    args = [torch.from_numpy(a) for a in (q, k, v, do)]
    err = {}
    for running in (False, True):
        o, _ = _forward(*args[:3], True, 0, running=running)
        got = [o.transpose(1, 2)] + list(_backward(*args, True, 0,
                                                    running=running))
        err[running] = [float(np.abs(g.numpy() - w).max())
                        for g, w in zip(got, want)]
        if not running:
            np.testing.assert_allclose(got[0].numpy(), want[0], rtol=FA_TOL,
                                       atol=FA_TOL)
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g.numpy(), w, **BWD_TOL)
    assert all(r > f_ for f_, r in zip(err[False], err[True])), err


# (hd, hdv) -> (forward, dK / dV, dQ) dynamic shared memory bytes of the
# float32 tensor-core kernels by hand: forward Q rows (64 x (hd + 4)
# floats; at hd 192 the 96 columns past the 12 k-steps in registers, 64 x
# 100), K and its lo part (32 keys x hd padded to 32), V^T and its lo
# part (hdv x 32); backward K, V and lo parts (keys x widths padded to
# 32), Q and dO rows (64 x (width + 4)), P^T, dS^T and their lo parts
# (keys x 64 each) or dS and its lo part (64 x 32 each), the rows' lse and
# D (64 each); 1,024 bytes of alignment slack each
TF32_SMEM = {
    (16, 16): (18432, 60928, 44544),
    (24, 16): (20480, 62976, 46592),
    (32, 32): (26624, 69120, 52736),
    (64, 64): (51200, 101888, 85504),
    (128, 128): (100352, 167424, 151040),
    (192, 128): (108544, 200192, 183808),   # 12 of Q's steps in registers
    (256, 256): (198656, 216576, 216576),   # 16-key tiles in the backward
}


@pytest.mark.parametrize("hd,hdv", PAIRS)
def test_tf32x3_plans_fit_shared_memory(hd, hdv):
    """The float32 tensor-core plans' shared memory, pinned by hand at
    every pair, fits the 232,448 bytes a CTA may opt into."""
    fwd = tfa.forward_plan(1, 2048, 2048, 16, 16, hd, torch.float32, hdv=hdv)
    bwd = tfa.backward_plan(1, 2048, 2048, 16, 2, hd, torch.float32,
                            "tf32x3", hdv=hdv)
    got = (fwd["smem_bytes"], bwd["smem_bytes"]["dkdv"],
           bwd["smem_bytes"]["dq"])
    assert got == TF32_SMEM[(hd, hdv)]
    assert max(got) <= 232448
    keys = 16 if (hd, hdv) == (256, 256) else 32
    assert (fwd["keys"], bwd["keys"]) == (32, keys)
    assert fwd["kernel"] == "flash_attention_tf32_kernel"
    assert [n for n, _ in bwd["kernels"]] == [
        "fa_bwd_preprocess_kernel", "fa_bwd_dkdv_tf32_kernel",
        "fa_bwd_gqa_reduce_kernel", "fa_bwd_dq_tf32_kernel"]
