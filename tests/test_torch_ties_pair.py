"""TIES's pair route on the card, held on the CPU: the launch plans of the
threshold kernel (``ties_threshold_plan``) and the apply kernel
(``ties_apply_plan``), and a numpy model of the threshold kernel's digit
schedule (csrc/merge_block.cu, design note above
``ties_threshold_kernel``: slices, the 11-bit first digit, the compaction
into a candidate buffer of the plan's capacity, the 10-bit second and
third digits, the dense path when the bucket overflows the buffer)
against the JAX package's ``ref.ties_thresholds`` (an XLA sort), the
port's ``ref.ties_thresholds`` (``torch.kthvalue``) and ``np.partition``.
The kernels themselves run only on a card: tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import merge_block as tmb  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _select(hist, krem):
    """The bin holding rank krem from the top, and the keys above it."""
    above = 0
    for b in range(len(hist) - 1, -1, -1):
        if above + hist[b] >= krem:
            return b, above
        above += int(hist[b])
    raise AssertionError("rank beyond the histogram's total")


def radix_select_model(row: np.ndarray, keep: int) -> tuple:
    """The threshold kernel's schedule on one float32 row: returns the
    keep-th largest |x| (as float32) and the path the row took
    ("compact" or "dense")."""
    w = row.size
    plan = tmb.ties_threshold_plan(1, w)
    keys = row.view(np.uint32) & np.uint32(0x7FFFFFFF)
    slices = [keys[s * plan["slice"]:(s + 1) * plan["slice"]]
              for s in range(plan["slices"])]
    assert sum(s.size for s in slices) == w
    # pass 1: per-slice histograms of bits 30..20 summed into the row's
    hist1 = sum(np.bincount(s >> 20, minlength=2048) for s in slices)
    b1, above = _select(hist1, keep)
    krem = keep - above
    dense = hist1[b1] > plan["capacity"]
    # pass 2: bits 19..10 of the bucket's keys; compact rows append them
    cand, hist2 = [], np.zeros(1024, np.int64)
    for s in slices:
        c = s[(s >> 20) == b1]
        hist2 += np.bincount((c >> 10) & 0x3FF, minlength=1024)
        if not dense:
            cand.append(c)
    cand = np.concatenate(cand) if cand else np.zeros(0, np.uint32)
    assert dense or cand.size == hist1[b1] <= plan["capacity"]
    b2, above = _select(hist2, krem)
    krem -= above
    prefix = (b1 << 20) | (b2 << 10)
    # the last digit: over the candidates, or over the row again
    src = slices if dense else [cand]
    hist3 = sum(np.bincount(s[(s >> 10) == prefix >> 10] & 0x3FF,
                            minlength=1024) for s in src)
    b3, _ = _select(hist3, krem)
    return np.uint32(prefix | b3).view(np.float32), "dense" if dense else "compact"


def _rows(kind: str, w: int, seed: int) -> np.ndarray:
    """(2, 3, w) float32 deltas of one kind."""
    rng = np.random.default_rng(seed)
    D = (0.02 * rng.normal(size=(2, 3, w))).astype(np.float32)
    if kind == "zero":
        D[:] = 0.0
    elif kind == "equal":
        D[:] = np.float32(0.25)
        D[1, 1] = np.float32(-0.25)
    elif kind == "two":
        D[:] = np.where(rng.random((2, 3, w)) < 0.5, 0.5, -0.125)
    elif kind == "specials":
        D[0, 0, ::7] = np.inf
        D[0, 0, 3::11] = -np.inf
        D[0, 1] = np.where(rng.random(w) < 0.5, -0.0, 0.0)
        D[0, 1, : w // 3] = D[1, 0, : w // 3]
        # NaNs of one payload (both signs), so the order among NaN keys
        # does not matter
        D[1, 2, 1::5] = np.uint32(0x7FA00001).view(np.float32)
        D[1, 2, 2::5] = np.uint32(0xFFA00001).view(np.float32)
    return D.astype(np.float32)


def _want(D, trim):
    """np.partition's threshold, as the numpy operator takes it."""
    w = D.shape[-1]
    keep = tref.ties_keep(trim, w)
    return np.partition(np.abs(D), w - keep, axis=-1)[..., w - keep]


def _same_bits_or_nan(a, b):
    nan = np.isnan(b)
    np.testing.assert_array_equal(np.isnan(a), nan)
    np.testing.assert_array_equal(a.view(np.uint32)[~nan], b.view(np.uint32)[~nan])


@pytest.mark.parametrize("kind", ["gauss", "zero", "equal", "two", "specials"])
@pytest.mark.parametrize("w", [5, 1001, 4096, 20011])
@pytest.mark.parametrize("trim", ["keep1", 0.3, "keepw-1"])
def test_radix_select_model_equals_sorts(kind, w, trim):
    """The model of the kernel's schedule equals np.partition bit for bit
    (NaN payload and all), and the JAX package's sort and the port's
    kthvalue bit for bit where the threshold is not NaN (by NaN-ness
    where it is)."""
    D = _rows(kind, w, seed=w)
    trim = {"keep1": 1.0 / w, "keepw-1": 1.0 - 1.0 / w}.get(trim, trim)
    keep = tref.ties_keep(trim, w)
    assert 1 <= keep < w
    got = np.array([[radix_select_model(D[b, k], keep)[0] for k in range(3)]
                    for b in range(2)], dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _want(D, trim).view(np.uint32))
    _same_bits_or_nan(got, np.asarray(jref.ties_thresholds(jnp.asarray(D), trim)))
    _same_bits_or_nan(got, tref.ties_thresholds(torch.from_numpy(D), trim).numpy())


@pytest.mark.parametrize("kind,w,path", [
    ("gauss", 65536, "compact"),          # ~5% of the row in the bucket
    ("gauss", 1 << 20, "compact"),        # ~50,000 candidates
    ("zero", 65536, "dense"),             # one bucket holds the row
    ("equal", 65536, "dense"),
    ("two", 65536, "dense"),
    ("zero", 1000, "compact"),            # the buffer holds a short row
])
def test_radix_select_model_paths(kind, w, path):
    """Which path a row takes follows from its first bucket's count, and
    every path gives np.partition's threshold."""
    row = _rows(kind, w, seed=3)[0, 0]
    keep = tref.ties_keep(0.3, w)
    got, took = radix_select_model(row, keep)
    assert took == path
    want = np.partition(np.abs(row), w - keep)[w - keep]
    assert got.view(np.uint32) == want.view(np.uint32)


@pytest.mark.parametrize("nb,k,w", [(1, 4, 1 << 20), (5, 3, 65536),
                                    (1, 1, 1 << 20), (1, 16, 1 << 20),
                                    (3, 5, 65536), (1, 1, 2)])
def test_threshold_plan_fills_the_card(nb, k, w):
    """No more one CTA a row for few or wide rows: such a launch gets at
    least one CTA for each of the H100's 132 SMs (or one CTA a 1,024
    elements where the rows are shorter)."""
    plan = tmb.ties_threshold_plan(nb * k, w)
    assert plan["variant"] == "sliced"
    assert plan["ctas"] == nb * k * plan["slices"]
    assert plan["ctas"] >= min(132, nb * k * -(-w // tmb.SELECT_SLICE_MIN))
    assert plan["threads"] == 256


@pytest.mark.parametrize("nb,k,w", [(4, 16, 65536), (32, 4, 65536),
                                    (32, 2, 32768), (16, 1, 131072)])
def test_threshold_plan_one_cta_a_row_for_many_rows(nb, k, w):
    """Launches of many rows (the merge path's pair launches) take one
    1,024-thread CTA a row: the second read then follows the first on
    one SM while the row is in L2."""
    plan = tmb.ties_threshold_plan(nb * k, w)
    assert plan["variant"] == "row"
    assert (plan["ctas"], plan["threads"]) == (nb * k, 1024)


@pytest.mark.parametrize("rows,w", [(1, 2), (1, 5), (2, 1001), (15, 65536),
                                    (128, 65536), (4, 1 << 20), (3, 16385),
                                    (1, 2**31 - 1), (200, 1 << 20)])
def test_threshold_plan_slices_and_scratch(rows, w):
    """The sliced variant (a launch of fewer than SELECT_ROW_MIN_ROWS rows,
    or rows wider than SELECT_ROW_MAX_W): the slices tile the row in
    multiples of 4 within the plan's bounds, and the scratch is the
    design note's rows x (8 + 2,048 + 1,024 + cap) words.  The row
    variant: one CTA a row, no scratch.  Both: the candidate capacity is
    positive and at most W rounded up to 4."""
    plan = tmb.ties_threshold_plan(rows, w)
    row = rows >= tmb.SELECT_ROW_MIN_ROWS and w <= tmb.SELECT_ROW_MAX_W
    assert plan["variant"] == ("row" if row else "sliced")
    sl, n = plan["slice"], plan["slices"]
    assert (n - 1) * sl < w <= n * sl and sl % 4 == 0
    cap = plan["capacity"]
    assert 0 < cap and cap % 4 == 0
    assert cap == -(-min(w, max(1024, -(-w // 8))) // 4) * 4
    if row:
        assert (n, plan["ctas"], plan["threads"], plan["scratch"]) == (
            1, rows, tmb.SELECT_ROW_THREADS, 0)
    else:
        assert sl <= tmb.SELECT_SLICE_MAX and plan["ctas"] == rows * n
        assert plan["scratch"] == 4 * rows * (8 + 2048 + 1024 + cap)


@pytest.mark.parametrize("rows,w,variant", [
    (tmb.SELECT_ROW_MIN_ROWS - 1, 65536, "sliced"),
    (tmb.SELECT_ROW_MIN_ROWS, 65536, "row"),
    (tmb.SELECT_ROW_MIN_ROWS, tmb.SELECT_ROW_MAX_W, "row"),
    (tmb.SELECT_ROW_MIN_ROWS, tmb.SELECT_ROW_MAX_W + 1, "sliced"),
    (1000, 1, "row"),
])
def test_threshold_plan_variant_follows_the_shape(rows, w, variant):
    """The shape alone picks the kernel, on each side of both limits."""
    assert tmb.ties_threshold_plan(rows, w)["variant"] == variant


def test_threshold_plan_refuses_empty():
    with pytest.raises(ValueError):
        tmb.ties_threshold_plan(0, 10)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 13, 14, 16, 20, 32, 256])
def test_apply_plan_stages_fit_two_ctas(k):
    """The apply's tile: a power of two, two stages of K x tile floats in
    at most 49,152 bytes (64 KiB at K = 256, where T floors at 32),
    so at least two CTAs (and their 1
    KiB of thresholds) share an SM's 228 KB."""
    plan = tmb.ties_apply_plan(32, k, 65536)
    t = plan["tile"]
    assert t & (t - 1) == 0 and 32 <= t <= 4096
    assert k * t <= tmb.APPLY_STAGE_FLOATS or t == 32  # T floors at 32
    assert plan["smem"] == 2 * k * t * 4 + 16
    assert 2 * (plan["smem"] + 4 * tmb.APPLY_MAX_K + 1024) <= 233472
    assert plan["items"] == 32 * -(-65536 // t)


def test_apply_plan_refuses_too_many_experts():
    with pytest.raises(ValueError):
        tmb.ties_apply_plan(1, tmb.APPLY_MAX_K + 1, 100)
