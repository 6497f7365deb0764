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
