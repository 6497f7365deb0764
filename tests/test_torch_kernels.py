"""The port's merge kernels (repro_torch.kernels) against the JAX
package's: plain PyTorch versions vs ``repro.kernels.ref`` (through its
jitted wrappers in ``repro.kernels.ops``) and vs the Pallas kernels in
interpret mode (float32 cases; interpret mode is slow), over the same
shape / K / trim / density sweeps as tests/test_kernels.py.  The Hopper kernels themselves
run only on a card: tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import merge_block as jmb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ops import _pallas_padded  # noqa: E402
from repro_torch.core.operators import ties_merge  # noqa: E402
from repro_torch.kernels import merge_block as tmb  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SHAPES = [(3, 257), (8, 1024), (5, 700), (16, 2048), (1, 64)]
DTYPES = ["float32", "bfloat16"]
KS = [1, 2, 5]
TOL = dict(rtol=1e-5, atol=1e-5)


def _mk(nb, k, w, dtype, seed=0):
    """Inputs made with numpy; bf16 cases are bf16-rounded float32."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(nb, w)).astype(np.float32)
    D = rng.normal(size=(nb, k, w)).astype(np.float32)
    if dtype == "bfloat16":
        x0 = np.asarray(jnp.asarray(x0).astype(jnp.bfloat16).astype(jnp.float32))
        D = np.asarray(jnp.asarray(D).astype(jnp.bfloat16).astype(jnp.float32))
    return x0, D


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ AVG / TA
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_plain_matches_jax(shape, k, dtype):
    nb, w = shape
    x0, D = _mk(nb, k, w, dtype)
    got = tmb.linear_merge(_t(x0), _t(D), 0.37, 1.0).numpy()
    if dtype == "float32":
        pallas = _pallas_padded(jmb.linear_merge_pallas, jnp.asarray(x0),
                                jnp.asarray(D), coeff=0.37)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jops._ta_jit(jnp.asarray(x0), jnp.asarray(D), 0.37)), **TOL)
    avg = tref.avg_ref(_t(x0), _t(D)).numpy()
    np.testing.assert_allclose(
        avg, np.asarray(jops._avg_jit(jnp.asarray(x0), jnp.asarray(D))), **TOL)


# ----------------------------------------------------------------- TIES
@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("trim", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ties_plain_matches_jax(shape, k, trim, dtype):
    nb, w = shape
    x0, D = _mk(nb, k, w, dtype, seed=k)
    thresh = tref.ties_thresholds(_t(D), trim)
    jthresh = jops._ties_thresh_jit(jnp.asarray(D), trim)
    np.testing.assert_array_equal(thresh.numpy(), np.asarray(jthresh))
    got = tmb.ties_merge(_t(x0), _t(D), thresh, 0.9).numpy()
    if dtype == "float32":
        pallas = _pallas_padded(jmb.ties_merge_pallas, jnp.asarray(x0),
                                jnp.asarray(D), jthresh, lam=0.9)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    want = jops._ties_apply_jit(jnp.asarray(x0), jnp.asarray(D), jthresh, 0.9)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("trim", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ties_fused_plain_matches_jax(shape, k, trim, dtype):
    """The fused TIES wrapper's CPU path (the plain threshold and apply)
    against the JAX package's jitted threshold + apply and, in float32,
    its Pallas kernel in interpret mode; its thresholds bit for bit."""
    nb, w = shape
    x0, D = _mk(nb, k, w, dtype, seed=k + 7)
    got, thresh = tmb.ties_fused(_t(x0), _t(D), trim, 0.9, thresholds=True)
    jthresh = jops._ties_thresh_jit(jnp.asarray(D), trim)
    np.testing.assert_array_equal(thresh.numpy().view(np.uint32),
                                  np.asarray(jthresh).view(np.uint32))
    want = jops._ties_apply_jit(jnp.asarray(x0), jnp.asarray(D), jthresh, 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if dtype == "float32":
        pallas = _pallas_padded(jmb.ties_merge_pallas, jnp.asarray(x0),
                                jnp.asarray(D), jthresh, lam=0.9)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    # without thresholds: the merged blocks alone, the same bits
    np.testing.assert_array_equal(
        tmb.ties_fused(_t(x0), _t(D), trim, 0.9).numpy(), got.numpy())


@pytest.mark.parametrize("nb,k,w,route", [
    (5, 3, 65536, "fused"),     # the smoke's median launch (128 KiB blocks)
    (1, 4, 65536, "fused"),     # its most common launch
    (13, 2, 65536, "fused"),
    (46, 1, 65536, "fused"),    # its most rows in one launch
    (4, 5, 65536, "fused"),     # K = 5
    (12, 4, 65536, "fused"),    # FUSED_MAX_ROWS rows
    (49, 1, 65536, "pair"),     # more rows: the pair is faster
    (15, 4, 65536, "pair"),
    (16, 4, 65536, "pair"),
    (32, 4, 65536, "pair"),
    (2, 6, 65536, "fused"),     # FUSED_MAX_K experts
    (1, 8, 65536, "pair"),      # more experts: the pair is faster
    (1, 13, 65536, "pair"),     # the most rows a CTA stages at W = 65,536
    (1, 14, 65536, "pair"),     # K too large to stage
    (3, 1, 1001, "fused"),      # a ragged tail block
    (7, 5, 257, "fused"),
    (2, 2, 524288, "pair"),     # 2 MiB float32 blocks: W too large
])
def test_ties_route(nb, k, w, route):
    assert tmb.ties_route(nb, k, w) == route
    plan = tmb.ties_fused_plan(k, w)
    fits = plan["smem"] <= tmb.SMEM_LIMIT
    assert tmb.ties_fused_fits(k, w) == fits
    assert (route == "fused") == (fits and k <= tmb.FUSED_MAX_K
                                  and nb * k <= tmb.FUSED_MAX_ROWS)
    assert 1 <= plan["cluster"] <= tmb.FUSED_MAX_CLUSTER
    assert plan["slice"] % 4 == 0 and plan["slice"] * plan["cluster"] >= w


def test_ties_route_refuses_empty_shapes():
    with pytest.raises(ValueError):
        tmb.ties_route(0, 4, 65536)


@pytest.mark.parametrize("route", ["fused", "pair"])
@pytest.mark.parametrize("nb,k,w", [(3, 4, 1000), (2, 1, 257), (4, 5, 64)])
def test_merge_blocks_ties_routes_equal_numpy_operator(monkeypatch, route,
                                                       nb, k, w):
    """merge_blocks("ties", device="cpu") through either route (the route
    forced by replacing ``ties_route``) equals the numpy operator bit for
    bit, block by block."""
    from repro_torch.kernels import ops as tops

    x0, D = _mk(nb, k, w, "float32", seed=w)
    theta = {"trim_frac": 0.3, "lam": 0.8}
    monkeypatch.setattr(tmb, "ties_route", lambda *shape: route)
    got = tops.merge_blocks("ties", x0, D, theta, device="cpu")
    for b in range(nb):
        want = ties_merge(x0[b], D[b], theta).astype(np.float32)
        np.testing.assert_array_equal(got[b].view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("trim,w", [
    (1.0, 64),     # keep >= W: -inf, every entry kept
    (0.0, 64),     # keep floors at 1
    (0.5, 5),      # round(2.5) = 2: half to even
    (0.3, 5),      # round(1.5) = 2
    (0.125, 4),    # round(0.5) = 0 -> floored at 1
])
def test_ties_threshold_edges(trim, w):
    x0, D = _mk(2, 3, w, "float32", seed=11)
    D[0, 1] = 0.0                  # an all-zero row
    D[1, 2, : w // 2] = 0.0        # a partly zero row
    thresh = tref.ties_thresholds(_t(D), trim)
    np.testing.assert_array_equal(
        thresh.numpy(), np.asarray(jops._ties_thresh_jit(jnp.asarray(D), trim)))
    keep = max(1, int(round(trim * w)))
    assert tref.ties_keep(trim, w) == keep
    if keep >= w:
        assert torch.isneginf(thresh).all()
    # per block, the plain version equals the numpy operator bit for bit
    got = tmb.ties_merge(_t(x0), _t(D), thresh, 0.8).numpy()
    for b in range(2):
        want = ties_merge(x0[b], D[b], {"trim_frac": trim, "lam": 0.8})
        np.testing.assert_array_equal(got[b], want.astype(np.float32))


def _edge_rows(w, seed):
    """(2, 6, w) float32 deltas with the TIES trim's edge rows."""
    rng = np.random.default_rng(seed)
    D = (0.02 * rng.normal(size=(2, 6, w))).astype(np.float32)
    D[0, 0] = 0.0                                          # all zeros
    D[0, 1] = 0.25 * rng.integers(-3, 4, size=w)           # many duplicates
    D[0, 2] = np.where(rng.random(w) < 0.5, -0.0, 0.0)     # +-0.0 ...
    D[0, 2, : w // 3] = D[1, 0, : w // 3]                  # ... and values
    D[0, 3, ::7] = np.inf                                  # +-inf
    D[0, 3, 3::11] = -np.inf
    D[0, 4, w // 2] = np.nan                               # a NaN
    D[0, 5, ::3] = -D[0, 5, ::3]
    return D


@pytest.mark.parametrize("w", [1, 2, 5, 257, 1001])
@pytest.mark.parametrize("trim", [0.0, 0.3, 0.999, 1.0])
def test_ties_threshold_edge_rows(w, trim):
    """The threshold (torch.kthvalue, the kernel's plain version) equals
    the JAX package's sort and the numpy operator's np.partition bit for
    bit on rows of zeros, +-0.0, duplicates, +-inf and a NaN (NaN sorts
    above +inf)."""
    D = _edge_rows(w, w)
    keep = tref.ties_keep(trim, w)
    got = tref.ties_thresholds(_t(D), trim)
    bits = got.numpy().view(np.uint32)
    jax_bits = np.asarray(jops._ties_thresh_jit(jnp.asarray(D), trim))
    np.testing.assert_array_equal(bits, jax_bits.view(np.uint32))
    if keep < w:
        part = np.partition(np.abs(D), w - keep, axis=-1)[..., w - keep]
        np.testing.assert_array_equal(bits, part.view(np.uint32))
    else:
        assert torch.isneginf(got).all()
    # the wrapper's CPU path is the plain version
    np.testing.assert_array_equal(
        tmb.ties_thresholds(_t(D), trim).numpy().view(np.uint32), bits)


def test_ties_zero_deltas_return_base():
    x0, _ = _mk(3, 4, 300, "float32", seed=5)
    D = np.zeros((3, 4, 300), np.float32)
    got = tref.ties_ref(_t(x0), _t(D), 0.3, 1.0).numpy()
    np.testing.assert_array_equal(got, x0)
    pallas = _pallas_padded(
        jmb.ties_merge_pallas, jnp.asarray(x0), jnp.asarray(D),
        jops._ties_thresh_jit(jnp.asarray(D), 0.3), lam=1.0)
    np.testing.assert_array_equal(np.asarray(pallas), x0)


# ----------------------------------------------------------------- DARE
@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("density", [0.25, 0.75])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dare_plain_matches_jax(shape, k, density, dtype):
    nb, w = shape
    x0, D = _mk(nb, k, w, dtype, seed=k + 1)
    masks = np.random.default_rng(7).random((nb, k, w)) < density
    got = tmb.dare_merge(_t(x0), _t(D), _t(masks), density, 1.1).numpy()
    if dtype == "float32":
        pallas = _pallas_padded(jmb.dare_merge_pallas, jnp.asarray(x0),
                                jnp.asarray(D), jnp.asarray(masks),
                                density=density, lam=1.1)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    want = jops._dare_jit(jnp.asarray(x0), jnp.asarray(D), jnp.asarray(masks),
                          density, 1.1)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
