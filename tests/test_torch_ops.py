"""The port's ``merge_blocks`` (device "cpu": the kernels' plain
versions) against the JAX package's ``repro.kernels.ops.merge_blocks``
on its jnp path and its forced-Pallas path (interpret mode), all four
operators, as tests/test_kernels.py checks the two JAX paths."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.operators import apply_operator  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.store import dtypes  # noqa: E402

CASES = [
    ("avg", {}),
    ("ta", {"lam": 0.3}),
    ("ties", {"trim_frac": 0.4}),
    ("dare", {"density": 0.5}),
]


def _inputs(nb=4, k=3, w=300, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(nb, w)).astype(np.float32)
    D = rng.normal(size=(nb, k, w)).astype(np.float32)
    masks = rng.random((nb, k, w)) < 0.5
    return x0, D, masks


@pytest.mark.parametrize("force_pallas", ["0", "1"])
@pytest.mark.parametrize("op,theta", CASES)
def test_merge_blocks_matches_jax(monkeypatch, force_pallas, op, theta):
    x0, D, masks = _inputs()
    kw = {"masks": masks} if op == "dare" else {}
    monkeypatch.setenv("REPRO_FORCE_PALLAS", force_pallas)
    want = jops.merge_blocks(op, x0, D, theta, **kw)
    got = tops.merge_blocks(op, x0, D, theta, device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == x0.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op,theta", CASES)
def test_merge_blocks_bf16_in_and_out(op, theta):
    """bf16 base words in, bf16 words out: per block, bit-identical to
    the numpy operator on the same words."""
    x0, D, masks = _inputs(seed=1)
    words = dtypes.from_float32(x0, dtypes.BFLOAT16)
    kw = {"masks": masks} if op == "dare" else {}
    got = tops.merge_blocks(op, words, D, theta, device="cpu",
                            out_dtype=dtypes.BFLOAT16, **kw)
    assert got.dtype == dtypes.BFLOAT16
    for b in range(x0.shape[0]):
        th = dict(theta)
        if op == "dare":
            th["_masks"] = masks[b]
        np.testing.assert_array_equal(got[b], apply_operator(words[b], D[b], op, th))


def test_merge_blocks_rejects_unknown_and_missing_masks():
    x0, D, _ = _inputs()
    with pytest.raises(KeyError):
        tops.merge_blocks("nope", x0, D, {}, device="cpu")
    with pytest.raises(ValueError):
        tops.merge_blocks("dare", x0, D, {}, device="cpu")


# base words: -NaN and +NaN (quiet), payload NaNs of each sign (a
# signalling-style payload too), and ±inf beside them
NAN_WORDS = np.array([0xFFC0, 0x7FC0, 0x7FC1, 0xFFA5, 0x7F81, 0xFF80, 0x7F80],
                     dtype=np.uint16)
# float32 delta NaNs: ±quiet, payloads of each sign
NAN_DELTAS = np.array([0x7FC00000, 0xFFC00000, 0x7FA00001, 0xFF812345],
                      dtype=np.uint32).view(np.float32)


@pytest.mark.parametrize("op,theta", CASES)
def test_merge_blocks_bf16_nan_bits_match_numpy_operator(op, theta):
    """A bf16 merge gives ``dtypes.from_float32``'s bits for NaN outputs
    (round to nearest even; every NaN to sign|0x7FC0), as the numpy
    operator does: NaN base words of both signs and with payloads, and
    (for the linear operators and DARE) NaN deltas."""
    x0, D, masks = _inputs(seed=2)
    words = dtypes.from_float32(x0, dtypes.BFLOAT16)
    n = len(NAN_WORDS)
    words[:, 3:3 + n] = NAN_WORDS
    if op != "ties":  # TIES with NaN deltas is a documented divergence
        D[:, 1, 50:50 + len(NAN_DELTAS)] = NAN_DELTAS
        masks[:, 1, 50:50 + len(NAN_DELTAS)] = True
    kw = {"masks": masks} if op == "dare" else {}
    got = tops.merge_blocks(op, words, D, theta, device="cpu",
                            out_dtype=dtypes.BFLOAT16, **kw)
    for b in range(x0.shape[0]):
        th = dict(theta)
        if op == "dare":
            th["_masks"] = masks[b]
        want = apply_operator(words[b], D[b], op, th)
        np.testing.assert_array_equal(got[b], want)
    nan = (got & 0x7FFF) > 0x7F80
    assert nan.sum() >= 5 * x0.shape[0]
    assert set(np.unique(got[nan]).tolist()) <= {0x7FC0, 0xFFC0}


def test_bf16_words_follow_from_float32():
    """The device rule on every class of float32 bits: normals, the
    rounding ties, subnormals, overflow to inf, ±inf and NaNs."""
    rng = np.random.default_rng(0)
    bits = np.concatenate([
        rng.integers(0, 2 ** 32, size=20000, dtype=np.uint64),
        [0x00008000, 0x00018000, 0x3F808000, 0x3F818000, 0x7F7FFFFF,
         0xFF7FFFFF, 0x7F800000, 0xFF800000, 0x7F800001, 0xFFFFFFFF,
         0x7FFF8000, 0x80000000, 0, 0x00000001],
    ]).astype(np.uint32)
    x = bits.view(np.float32)
    got = tops.bf16_words(torch.from_numpy(x)).numpy().view(dtypes.BFLOAT16)
    np.testing.assert_array_equal(got, dtypes.from_float32(x, dtypes.BFLOAT16))
    ok = ~np.isnan(x)  # torch's own cast agrees wherever there is no NaN
    cast = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got[ok], cast.view(dtypes.BFLOAT16)[ok])
