"""Card-only tests of the port: the Hopper kernels against their plain
versions, merge_blocks on the card against the CPU, MergePipe on the
card against the numpy stream engine, ANALYZE and a Session merge graph
on the card against the CPU, and the models' prefill and serving on the
card against the CPU (the dense family, and Griffin at head dims 16 and
256).  Imports nothing of JAX, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider tests/test_torch_cuda.py

Every test skips where ``torch.cuda.is_available()`` is False."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import MergeSpec, Session  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.api import MergePipe  # noqa: E402
from repro_torch.core.catalog import Catalog  # noqa: E402
from repro_torch.core.sketch import analyze_model  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import merge_block as tmb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import build_model, load_flat  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.store.checkpoint import flatten_tree  # noqa: E402

pytestmark = pytest.mark.cuda

OPS = [("avg", {}), ("ta", {"lam": 0.7}), ("ties", {"trim_frac": 0.3}),
       ("dare", {"density": 0.5, "seed": 3})]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mk(nb, k, w, seed=3):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(nb, w)).astype(np.float32)
    D = (0.02 * rng.normal(size=(nb, k, w))).astype(np.float32)
    masks = rng.random((nb, k, w)) < 0.5
    return x0, D, masks


@pytest.mark.parametrize("shape", [(3, 257), (32, 65536), (5, 700)])
@pytest.mark.parametrize("k", [1, 4])
def test_kernels_match_plain_bitwise(cuda, shape, k):
    """Vector (W % 4 == 0) and scalar widths: bit for bit."""
    nb, w = shape
    x0, D, masks = _mk(nb, k, w)
    x0c, Dc = torch.from_numpy(x0).to(cuda), torch.from_numpy(D).to(cuda)
    mc = torch.from_numpy(masks).to(cuda)
    thresh = tref.ties_thresholds(Dc, 0.3).contiguous()
    pairs = [
        (tmb.linear_merge(x0c, Dc, 1.0, float(k + 1)), tref.avg_ref(x0c, Dc)),
        (tmb.linear_merge(x0c, Dc, 0.7, 1.0), tref.ta_ref(x0c, Dc, 0.7)),
        (tmb.ties_merge(x0c, Dc, thresh, 0.9),
         tref.ties_apply_ref(x0c, Dc, thresh, 0.9)),
        (tmb.dare_merge(x0c, Dc, mc, 0.5, 1.1),
         tref.dare_ref(x0c, Dc, mc, 0.5, 1.1)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_refuse_bad_operands(cuda):
    x0, D, _ = _mk(2, 2, 64)
    x0c, Dc = torch.from_numpy(x0).to(cuda), torch.from_numpy(D).to(cuda)
    with pytest.raises(ValueError):
        tmb.linear_merge(x0c.double(), Dc)               # dtype
    with pytest.raises(ValueError):
        tmb.linear_merge(x0c, Dc.transpose(0, 1))        # shape / layout
    with pytest.raises(ValueError):
        tmb.linear_merge(x0c[:, ::2], Dc[:, :, ::2])     # not contiguous
    with pytest.raises(ValueError):
        tmb.ties_merge(x0c, Dc, torch.zeros(2, 2))       # thresholds on CPU


@pytest.mark.parametrize("op,theta", OPS)
def test_merge_blocks_card_equals_cpu(cuda, op, theta):
    x0, D, masks = _mk(6, 3, 1000)
    kw = {"masks": masks} if op == "dare" else {}
    tmb.reset_launches()
    a = ops.merge_blocks(op, x0, D, theta, device="cuda", **kw)
    b = ops.merge_blocks(op, x0, D, theta, device="cpu", **kw)
    np.testing.assert_array_equal(a, b)
    # TIES: the fused kernel, or the threshold kernel and then the apply
    # kernel, as ties_route names
    fused = tmb.ties_route(6, 3, 1000) == "fused"
    assert sum(tmb.LAUNCHES.values()) == (1 if op != "ties" or fused else 2)
    assert tmb.LAUNCHES["ties_threshold"] == (op == "ties" and not fused)
    assert tmb.LAUNCHES["ties_fused"] == (op == "ties" and fused)


def _on_card(a, cuda, offset):
    """``a`` on the card, ``offset`` float32 elements into its storage (a
    contiguous view off the 16-byte grid when offset is 1)."""
    buf = torch.zeros(a.size + offset, device=cuda)
    t = buf[offset:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


def _threshold_rows(shape, seed):
    """(NB, K, W) float32 deltas with the edge rows of the TIES trim in
    its first rows (as many as fit, the last row left Gaussian): all
    zeros, many duplicates, +-0.0 and values, +-inf, a NaN, a negated
    row, all equal, two values, NaNs of one payload.  The all-zero,
    all-equal and two-valued rows take the threshold kernel's dense path
    where W exceeds its candidate buffer."""
    nb, k, w = shape
    rng = np.random.default_rng(seed)
    D = (0.02 * rng.normal(size=shape)).astype(np.float32)
    rows = D.reshape(nb * k, w)
    gauss = rows[-1].copy()
    payload = np.uint32(0x7FA00001).view(np.float32)
    kinds = [
        lambda r: r.fill(0.0),                                  # all zeros
        lambda r: r.__setitem__(slice(None), 0.25 * rng.integers(-3, 4, size=w)),
        lambda r: (r.__setitem__(slice(None), np.where(rng.random(w) < 0.5,
                                                       -0.0, 0.0)),
                   r.__setitem__(slice(None, w // 3), gauss[: w // 3])),
        lambda r: (r.__setitem__(slice(None, None, 7), np.inf),
                   r.__setitem__(slice(3, None, 11), -np.inf)),
        lambda r: r.__setitem__(w // 2, np.nan),                # a NaN
        lambda r: r.__setitem__(slice(None, None, 3), -r[::3]),
        lambda r: r.fill(0.25),                                 # all equal
        lambda r: r.__setitem__(slice(None), np.where(rng.random(w) < 0.5,
                                                      0.5, -0.125)),
        lambda r: (r.__setitem__(slice(1, None, 5), payload),   # NaN payloads
                   r.__setitem__(slice(2, None, 5), -payload)),
    ]
    for i, kind in enumerate(kinds[: max(0, nb * k - 1)]):
        kind(rows[i])
    return D


# edge rows at several W on the sliced kernels (12 rows) and on one CTA a
# row (16 rows), the parity phase's 2 MiB blocks, K past the fused kernel,
# 128 rows, and each side of SELECT_ROW_MAX_W
THRESHOLD_SHAPES = ([(nb, k, w) for nb, k in ((2, 6), (4, 4))
                     for w in (1, 2, 3, 5, 1001, 4096, 65536, 65537)]
                    + [(2, 6, 1 << 20), (1, 4, 1 << 20), (1, 1, 1 << 20),
                       (4, 16, 65536), (4, 20, 65536), (32, 4, 65536),
                       (4, 4, 131072), (4, 4, 131073)])


@pytest.mark.parametrize("shape", [(5, 3, 256), (7, 4, 65536), (3, 2, 701)])
def test_linear_kernel_per_row_divisor_bitwise(cuda, shape):
    """``linear_merge(div_rows=)`` (the whole-shard AVG's k_sel + 1 a
    row) bit for bit, NaNs of both signs and a payload among the deltas
    and the base: against numpy's float32 arithmetic in the kernel's
    order (x86's NaN rule, which the kernel keeps), and against
    ``linear_ref`` on the card (whose float32 add gives the canonical
    NaN: NaN-ness equal there, every other bit equal); the refusals of a
    bad divisor operand."""
    nb, k, w = shape
    x0, D, _ = _mk(nb, k, w, seed=5)
    D[1, 0, 3] = np.nan
    D[2, k - 1, 7] = -np.nan
    x0[0, 5] = np.float32(np.nan)
    x0.view(np.int32)[3 % nb, 9] = 0x7FA00001  # a payload NaN
    rows = (np.arange(nb) % (k + 1) + 1).astype(np.float32)
    x0c, Dc = torch.from_numpy(x0).to(cuda), torch.from_numpy(D).to(cuda)
    rc = torch.from_numpy(rows).to(cuda)
    got = tmb.linear_merge(x0c, Dc, 1.0, 1.0, div_rows=rc)
    acc = D[:, 0]
    for j in range(1, k):
        acc = acc + D[:, j]
    with np.errstate(invalid="ignore"):
        host = x0 + (np.float32(1.0) * acc) / rows[:, None]
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                  host.view(np.int32))
    want = tref.linear_ref(x0c, Dc, 1.0, 1.0, rc)
    nan = torch.isnan(want)
    assert int(nan.sum()) >= 3 and torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])
    with pytest.raises(ValueError):
        tmb.linear_merge(x0c, Dc, 1.0, 1.0, div_rows=rc[:-1])
    with pytest.raises(ValueError):
        tmb.linear_merge(x0c, Dc, 1.0, 1.0, div_rows=rc.double())


@pytest.mark.parametrize("kind", ["delta", "full"])
@pytest.mark.parametrize("op,theta", OPS)
def test_merge_blocks_masked_on_card_matches_plain(cuda, op, theta, kind):
    """The whole-shard step on the card against its plain version on the
    same inputs, rows of 0..K selected experts: bit for bit, and the
    card's launches on the operator's kernels."""
    from repro_torch.core import distributed as dist

    rng = np.random.default_rng(17)
    k, nb, w = 4, 13, 65536
    base = rng.normal(size=(nb, w)).astype(np.float32)
    experts = (0.02 * rng.normal(size=(k, nb, w))).astype(np.float32)
    if kind == "full":
        experts = experts + base[None]
    select = np.zeros((k, nb), bool)
    for b in range(nb):
        select[rng.permutation(k)[: b % (k + 1)], b] = True
    masks = rng.random((k, nb, w)) < 0.5
    args = [base, experts, select] + ([masks] if op == "dare" else [])
    before = dict(tmb.LAUNCHES)
    got = dist.build_merge_step(op, theta, kind=kind, device=cuda)(*args)
    torch.cuda.synchronize()
    launched = {n for n in tmb.LAUNCHES if tmb.LAUNCHES[n] > before[n]}
    want = dist.build_merge_step(op, theta, kind=kind, device="cpu")(*args)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert launched & {"avg": {"linear_merge"}, "ta": {"linear_merge"},
                       "dare": {"dare_merge"},
                       "ties": {"ties_fused", "ties_merge"}}[op]


@pytest.mark.parametrize("shape", THRESHOLD_SHAPES)
@pytest.mark.parametrize("trim", [0.0, 0.3, 0.999, 1.0])
@pytest.mark.parametrize("offset", [0, 1])
def test_ties_threshold_kernel_equals_kthvalue(cuda, shape, trim, offset):
    """Bit for bit: np.partition, as the numpy operator takes it, and
    torch.kthvalue on the card, whose abs and radix select return every
    NaN as the canonical 0x7FFFFFFF (the kernel keeps the payload, as
    np.abs does; a NaN threshold keeps nothing in either); -inf without
    a launch when keep >= W.  Shapes: edge rows at several W on both
    kernels the shape picks from (sliced below 16 rows, one CTA a row from
    16 rows of at most 131,072), the parity phase's 2 MiB blocks (1, 4 /
    1, 1,048,576), K past the fused kernel (16, 20), 128 rows; ``offset``
    1 puts every row off the 16-byte grid."""
    nb, k, w = shape
    D = _threshold_rows(shape, w + k)
    Dc = _on_card(D, cuda, offset)
    keep = tref.ties_keep(trim, w)
    tmb.reset_launches()
    got = tmb.ties_thresholds(Dc, trim)
    assert tmb.LAUNCHES["ties_threshold"] == (keep < w)
    want = tref.ties_thresholds(Dc, trim)
    torch.cuda.synchronize()
    assert got.shape == (nb, k) and got.dtype == torch.float32
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])
    if keep < w:
        part = np.partition(np.abs(D), w - keep, axis=-1)[..., w - keep]
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                      part.view(np.uint32))
    else:
        assert torch.isneginf(got).all()


def test_ties_threshold_plan_matches_library(cuda):
    """ties_threshold_plan (Python) is the launch the C side makes."""
    for rows in (1, 4, 15, 16, 64, 128, 1000):
        for w in (2, 5, 1001, 65536, 131072, 131073, 1 << 20):
            assert (tmb.ties_threshold_launch_plan(rows, w)
                    == tmb.ties_threshold_plan(rows, w))


@pytest.mark.parametrize("k", [1, 2, 4, 13, 16, 20, 32])
@pytest.mark.parametrize("nb,w,offset", [(3, 65536, 0), (2, 65536, 1),
                                         (2, 1001, 0)])
def test_ties_merge_kernel_equals_numpy_operator(cuda, k, nb, w, offset):
    """The pair's apply kernel, given the trim thresholds, bit for bit
    against the numpy operator (which takes its thresholds by
    np.partition) and its plain version, at K up to 32; ``offset`` 1 and
    the ragged W take its plain-load staging."""
    from repro_torch.core.operators import ties_merge

    x0, D, _ = _mk(nb, k, w, seed=k + w)
    D[0, 0] = 0.0
    theta = {"trim_frac": 0.3, "lam": 0.9}
    x0c, Dc = _on_card(x0, cuda, offset), _on_card(D, cuda, offset)
    thresh = tref.ties_thresholds(Dc, 0.3).contiguous()
    tmb.reset_launches()
    got = tmb.ties_merge(x0c, Dc, thresh, 0.9)
    assert tmb.LAUNCHES["ties_merge"] == 1
    want = tref.ties_apply_ref(x0c, Dc, thresh, 0.9)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    out = got.cpu().numpy()
    for b in range(nb):
        np_b = np.asarray(ties_merge(x0[b], D[b], theta), dtype=np.float32)
        np.testing.assert_array_equal(out[b].view(np.uint32),
                                      np_b.view(np.uint32))


def test_ties_merge_refuses_too_many_experts(cuda):
    k = tmb.APPLY_MAX_K + 1
    x0 = torch.zeros((1, 64), device=cuda)
    D = torch.zeros((1, k, 64), device=cuda)
    with pytest.raises(ValueError):
        tmb.ties_merge(x0, D, torch.zeros((1, k), device=cuda))


def test_ties_threshold_wrapper_refuses(cuda):
    D = torch.randn(2, 3, 100, device=cuda)
    with pytest.raises(ValueError):
        tmb.ties_thresholds(D.double(), 0.3)              # dtype
    with pytest.raises(ValueError):
        tmb.ties_thresholds(D[:, :, ::2], 0.3)            # not contiguous
    with pytest.raises(ValueError):
        tmb.ties_thresholds(D[0], 0.3)                    # not (NB, K, W)


def test_ties_merge_blocks_on_card_equal_numpy_operator(cuda):
    """merge_blocks("ties") on the card, threshold kernel and all, against
    the numpy operator at the smoke's widths (128 KiB bf16 blocks)."""
    from repro_torch.core.operators import ties_merge

    x0, D, _ = _mk(3, 4, 65536, seed=9)
    theta = {"trim_frac": 0.3, "lam": 1.0}
    tmb.reset_launches()
    got = ops.merge_blocks("ties", x0, D, theta, device="cuda")
    _assert_ties_route(tmb.ties_route(3, 4, 65536))
    for b in range(3):
        want = np.asarray(ties_merge(x0[b], D[b], theta), dtype=np.float32)
        np.testing.assert_array_equal(got[b].view(np.uint32),
                                      want.view(np.uint32))


def _assert_ties_route(route):
    """The launches since reset_launches are one TIES merge by ``route``."""
    want = ({"ties_fused": 1} if route == "fused"
            else {"ties_threshold": 1, "ties_merge": 1})
    assert {k: v for k, v in tmb.LAUNCHES.items() if v} == want


@pytest.mark.parametrize("route", ["fused", "pair"])
def test_ties_merge_blocks_on_card_forced_route(cuda, monkeypatch, route):
    """Either route forced (by replacing ``ties_route``), the same bits as
    the numpy operator at the smoke's widths."""
    from repro_torch.core.operators import ties_merge

    x0, D, _ = _mk(5, 3, 65536, seed=10)
    theta = {"trim_frac": 0.3, "lam": 0.7}
    monkeypatch.setattr(tmb, "ties_route", lambda *shape: route)
    tmb.reset_launches()
    got = ops.merge_blocks("ties", x0, D, theta, device="cuda")
    _assert_ties_route(route)
    for b in range(5):
        want = np.asarray(ties_merge(x0[b], D[b], theta), dtype=np.float32)
        np.testing.assert_array_equal(got[b].view(np.uint32),
                                      want.view(np.uint32))


FUSED_SHAPES = [(1, 4, 65536), (5, 3, 65536), (13, 2, 65536), (32, 4, 65536),
                (3, 1, 1001), (7, 5, 257)]


def _fused_inputs(nb, k, w, seed):
    """x0 and D with an all-zero row and a row of one repeated value."""
    x0, D, _ = _mk(nb, k, w, seed=seed)
    D[0, 0] = 0.0
    if k > 1:
        D[-1, 1] = 0.25
    return x0, D


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("trim", [0.0, 0.3, 0.999, 1.0])
@pytest.mark.parametrize("offset", [0, 1])
def test_ties_fused_kernel_matches_plain_and_numpy(cuda, shape, trim, offset):
    """The fused kernel bit for bit against its plain version
    (ref.ties_ref: torch.kthvalue thresholds, then the apply) and the
    numpy operator, its thresholds bit for bit against torch.kthvalue;
    ``offset`` 1 puts every operand off the 16-byte grid (the kernel's
    plain-load staging)."""
    from repro_torch.core.operators import ties_merge

    nb, k, w = shape
    x0, D = _fused_inputs(nb, k, w, seed=w + k)
    x0c, Dc = _on_card(x0, cuda, offset), _on_card(D, cuda, offset)
    tmb.reset_launches()
    got, thresh = tmb.ties_fused(x0c, Dc, trim, 0.9, thresholds=True)
    assert tmb.LAUNCHES["ties_fused"] == 1
    want_t = tref.ties_thresholds(Dc, trim)
    want = tref.ties_apply_ref(x0c, Dc, want_t, 0.9)
    torch.cuda.synchronize()
    assert thresh.shape == (nb, k) and got.shape == (nb, w)
    assert torch.equal(thresh.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    theta = {"trim_frac": trim, "lam": 0.9}
    out = got.cpu().numpy()
    for b in range(nb):
        np_b = np.asarray(ties_merge(x0[b], D[b], theta), dtype=np.float32)
        np.testing.assert_array_equal(out[b].view(np.uint32),
                                      np_b.view(np.uint32))


@pytest.mark.parametrize("trim", [0.0, 0.3, 1.0])
def test_ties_fused_kernel_nan_row(cuda, trim):
    """A NaN delta (ROADMAP, known differences): never kept by the
    kernel or its plain version; a NaN threshold (keep = 1, NaN sorts
    above +inf) keeps nothing of its row; the kernel keeps the NaN's
    payload in the threshold where torch.kthvalue returns 0x7FFFFFFF.
    The numpy operator agrees except at keep >= W, where it keeps the
    NaN: the elected sign of its column is NaN, nothing agrees, and the
    element stays x0."""
    from repro_torch.core.operators import ties_merge

    nb, k, w = 2, 3, 65536
    x0, D = _fused_inputs(nb, k, w, seed=5)
    D[1, 2, w // 3] = np.nan
    x0c, Dc = torch.from_numpy(x0).to(cuda), torch.from_numpy(D).to(cuda)
    got, thresh = tmb.ties_fused(x0c, Dc, trim, 1.0, thresholds=True)
    want_t = tref.ties_thresholds(Dc, trim)
    want = tref.ties_apply_ref(x0c, Dc, want_t, 1.0)
    torch.cuda.synchronize()
    nan = torch.isnan(want_t)
    assert torch.equal(torch.isnan(thresh), nan)
    assert torch.equal(thresh.view(torch.int32)[~nan],
                       want_t.view(torch.int32)[~nan])
    assert bool(nan[1, 2]) == (tref.ties_keep(trim, w) == 1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.isnan(got).any()
    np_b = np.asarray(ties_merge(x0[1], D[1], {"trim_frac": trim}),
                      dtype=np.float32)
    same = np.ones(w, dtype=bool)
    if tref.ties_keep(trim, w) >= w:
        assert np_b[w // 3] == x0[1, w // 3]
        same[w // 3] = False
    np.testing.assert_array_equal(got[1].cpu().numpy()[same].view(np.uint32),
                                  np_b[same].view(np.uint32))


def test_ties_fused_wrapper_refuses(cuda):
    x0, D, _ = _mk(2, 3, 100)
    x0c, Dc = torch.from_numpy(x0).to(cuda), torch.from_numpy(D).to(cuda)
    with pytest.raises(ValueError):
        tmb.ties_fused(x0c, Dc.cpu(), 0.3)                # D on the CPU
    with pytest.raises(ValueError):
        tmb.ties_fused(x0c.double(), Dc, 0.3)             # dtype
    with pytest.raises(ValueError):
        tmb.ties_fused(x0c[:, ::2], Dc[:, :, ::2], 0.3)   # not contiguous
    with pytest.raises(ValueError):
        tmb.ties_fused(x0c, Dc[0], 0.3)                   # not (NB, K, W)
    big = torch.zeros((1, 14, 65536), device=cuda)        # does not fit
    with pytest.raises(ValueError):
        tmb.ties_fused(torch.zeros((1, 65536), device=cuda), big, 0.3)


def test_ties_fused_occupancy_places_a_cluster(cuda):
    """Every shape of the fused route gets a cluster the card can place."""
    for nb, k, w in FUSED_SHAPES:
        plan = tmb.ties_fused_occupancy(k, w)
        assert plan["clusters"] >= 1
        assert plan == {**tmb.ties_fused_plan(k, w),
                        "clusters": plan["clusters"]}


@pytest.mark.parametrize("op,theta", OPS)
def test_mergepipe_on_card_matches_stream(cuda, tmp_path, op, theta):
    """bf16 checkpoints registered from card tensors; the card's
    pipelined merge equals the numpy stream engine bit for bit."""
    g = torch.Generator().manual_seed(0)
    shapes = {f"l{i}": (64, 96 + i) for i in range(3)}
    base = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    mp = MergePipe(str(tmp_path / "ws"), block_size=4096)
    mp.register_model("base", {k: v.to(torch.bfloat16).to(cuda)
                               for k, v in base.items()})
    ids = [f"e{e}" for e in range(3)]
    for e in ids:
        mp.register_model(e, {
            k: (v + 0.02 * torch.randn(v.shape, generator=g)).to(
                torch.bfloat16).to(cuda)
            for k, v in base.items()})
    tmb.reset_launches()
    rk = mp.merge("base", ids, op, theta=theta, budget=0.5)
    assert sum(tmb.LAUNCHES.values()) > 0
    rs = mp.merge("base", ids, op, theta=theta, budget=0.5, compute="stream")
    a, b = mp.load(rk.sid), mp.load(rs.sid)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    mp.close()


def _sketch_close(got, want, w):
    """tests/test_kernels.py's bars (l2 rtol 1e-4, mean rtol 1e-3 / atol
    1e-6) on the raw sums; max|x| bit for bit."""
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=2e-4, atol=0)
    torch.testing.assert_close(got[:, 1], want[:, 1], rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(got[:, 2], want[:, 2], rtol=1e-3,
                               atol=1e-6 * w)


@pytest.mark.parametrize("shape", [(1, 1), (1, 3), (3, 1001), (7, 257),
                                   (64, 65536), (1, 1 << 22)])
@pytest.mark.parametrize("offset", [0, 1])
def test_sketch_kernel_matches_plain(cuda, shape, offset):
    """Ragged widths, NB = 1, a wide row; ``offset`` starts the rows off
    the 16-byte grid (a contiguous view at a 4-byte storage offset)."""
    nb, w = shape
    rng = np.random.default_rng(w)
    buf = torch.from_numpy(
        rng.normal(size=nb * w + offset).astype(np.float32)).to(cuda)
    x = buf[offset:].view(nb, w)
    tmb.reset_launches()
    got = tmb.sketch_blocks(x)
    assert tmb.LAUNCHES["sketch_blocks"] == 1
    want = tref.sketch_ref(x)
    torch.cuda.synchronize()
    assert got.shape == (nb, 3) and got.dtype == torch.float32
    _sketch_close(got, want, w)


def test_sketch_kernel_nan_and_refusals(cuda):
    x = torch.randn(4, 300, device=cuda)
    x[2, 17] = float("nan")
    got, want = tmb.sketch_blocks(x), tref.sketch_ref(x)
    assert torch.isnan(got[2, 1]) and torch.isnan(want[2, 1])
    _sketch_close(got[[0, 1, 3]], want[[0, 1, 3]], 300)
    with pytest.raises(ValueError):
        tmb.sketch_blocks(x.double())                     # dtype
    with pytest.raises(ValueError):
        tmb.sketch_blocks(x[:, ::2])                      # not contiguous
    with pytest.raises(ValueError):
        tmb.sketch_blocks(x[0])                           # not (NB, W)


def _experts(g, n=3):
    shapes = {"l0/w": (64, 96), "l0/b": (96,), "emb": (300, 130),
              "l1/w": (40, 70)}
    base = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    arrays = {"base": base}
    for e in range(n):
        arrays[f"e{e}"] = {k: v + 0.02 * torch.randn(v.shape, generator=g)
                           for k, v in base.items()}
    return arrays


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_analyze_on_card_matches_cpu(cuda, tmp_path, dtype):
    """Catalog rows of ANALYZE on the card against ANALYZE on the CPU:
    bytes, hashes and signatures equal; stats within tolerance."""
    arrays = _experts(torch.Generator().manual_seed(1))
    mp = MergePipe(str(tmp_path / "ws"), block_size=4096)
    for name, a in arrays.items():
        mp.register_model(name, {k: v.to(dtype) for k, v in a.items()})
    cpu_cat = Catalog(str(tmp_path / "cpu.sqlite"))
    tmb.reset_launches()
    for name in arrays:
        base = None if name == "base" else "base"
        analyze_model(mp.catalog, mp.snapshots.models, name, 4096,
                      base_id=base)
        analyze_model(cpu_cat, mp.snapshots.models, name, 4096,
                      base_id=base, device="cpu")
    assert tmb.LAUNCHES["sketch_blocks"] > 0
    for name in arrays:
        a = mp.catalog.block_metas(name, 4096)
        b = cpu_cat.block_metas(name, 4096)
        assert len(a) == len(b) > 0
        for ra, rb in zip(a, b):
            # tensor, block, bytes, hash; absmax; sign signature
            assert ra[:4] == rb[:4] and ra[5] == rb[5] and ra[7] == rb[7]
            for i, rel, tol in ((4, 1e-5, 1e-6), (6, 1e-5, 1e-6),
                                (8, 1e-5, 1e-6), (9, 0, 1e-5)):
                if ra[i] is None:  # l2, mean, l2_delta, cos_base
                    assert rb[i] is None
                else:
                    assert ra[i] == pytest.approx(rb[i], rel=rel, abs=tol)
    cpu_cat.close()
    mp.close()


def test_session_graph_on_card_matches_cpu(cuda, tmp_path):
    """A nested merge graph through Session.run on the card (the child
    snapshot ANALYZEd by the sketch kernel) equals the CPU run bit for
    bit."""
    arrays = _experts(torch.Generator().manual_seed(2))
    child = MergeSpec.build("base", ["e1", "e2"], op="ties",
                            theta={"trim_frac": 0.3}, budget="60%")
    spec = MergeSpec.build(child, ["e0"], op="avg", budget="50%",
                           name="graph")
    out = []
    for device in ("cuda", "cpu"):
        with Session(str(tmp_path / device), block_size=4096,
                     device=device) as sess:
            for name, a in arrays.items():
                sess.register_model(name, {k: v.to(torch.bfloat16)
                                           for k, v in a.items()})
            tmb.reset_launches()
            res = sess.run(spec)
            if device == "cuda":
                assert tmb.LAUNCHES["sketch_blocks"] > 0
                assert tmb.LAUNCHES["linear_merge"] > 0
                # TIES by either route (merge_block.ties_route)
                assert tmb.LAUNCHES["ties_fused"] + tmb.LAUNCHES["ties_merge"] > 0
            else:
                assert sum(tmb.LAUNCHES.values()) == 0
            assert sess.verify(res.sid)
            out.append(sess.load(res.sid))
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k], out[1][k])


# (B, Sq, Sk, H, Hkv, hd, causal, window, q_offset): the JAX package's
# FA_CASES (tests/test_kernels.py), the smoke's shapes and the serve
# path's prefill lengths
FA_CASES = [
    (2, 64, 64, 4, 2, 16, True, 0, 0),
    (1, 50, 50, 4, 1, 8, True, 13, 0),
    (2, 33, 70, 6, 6, 16, False, 0, 0),
    (1, 1, 40, 4, 2, 16, True, 0, 39),
    (1, 2048, 2048, 12, 2, 128, True, 0, 0),
    (1, 2048, 2048, 12, 2, 128, True, 512, 0),
    (1, 1, 2048, 12, 2, 128, True, 0, 2047),
    (2, 100, 300, 4, 4, 64, False, 70, 200),
    (1, 256, 256, 12, 2, 128, True, 0, 0),
    (1, 1000, 1000, 12, 2, 128, True, 0, 0),
    (1, 1000, 1000, 12, 2, 128, True, 512, 0),
    (3, 77, 77, 4, 2, 32, True, 0, 0),
]
# tests/test_kernels.py:133,149: float32 sums in another order; bf16
# outputs one rounding apart
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(case, dtype, device, seed=0):
    b, sq, sk, h, hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(device=device, dtype=dtype)
            for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    causal, window, q_offset = case[6:]
    q, k, v = _qkv(case, dtype, cuda)
    tfa.reset_launches()
    got = tfa.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    assert tfa.LAUNCHES["flash_attention"] == 1
    # hd >= 16 runs on the tensor cores (bf16 "tc", float32 "tf32x3");
    # hd 8 on FMAs
    tc = dtype == torch.bfloat16 and case[5] >= 16
    assert tfa.LAUNCHES["flash_attention_tc"] == int(tc)
    assert tfa.LAUNCHES["flash_attention_tf32x3"] == int(
        dtype == torch.float32 and case[5] >= 16)
    want = tref.flash_attention_ref(q, k, v, causal, window, q_offset,
                                    skip_masked_chunks=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL[dtype],
                               atol=FA_TOL[dtype])


# (B, Sq, Sk, H, Hkv, hd, hdv, causal, window, q_offset): DeepSeek-V2-Lite's
# multi-head latent attention, qk 192 / v 128 published and 24 / 16 in its
# smoke config: its prefill shape, ragged tiles, GQA cross attention with
# a window and q_offset, a decode-style single query
MLA_FA_CASES = [
    (1, 2048, 2048, 16, 16, 192, 128, True, 0, 0),
    (2, 130, 130, 4, 4, 192, 128, True, 0, 0),
    (1, 100, 300, 4, 2, 192, 128, False, 70, 200),
    (1, 1000, 1000, 16, 16, 192, 128, True, 512, 0),
    (1, 1, 300, 16, 16, 192, 128, True, 0, 299),
    (2, 77, 77, 4, 4, 24, 16, True, 0, 0),
    (1, 50, 90, 4, 2, 24, 16, True, 13, 40),
    (1, 70, 130, 4, 4, 24, 16, False, 0, 0),
]
MLA_PARAMS = [pytest.param(case, dtype, route, id=f"{name}-{route}-{i}")
              for i, case in enumerate(MLA_FA_CASES)
              for name, dtype, route in (("f32", torch.float32, "tf32x3"),
                                         ("f32", torch.float32, "fma"),
                                         ("bf16", torch.bfloat16, "fma"),
                                         ("bf16", torch.bfloat16, "tc"))]


@pytest.mark.parametrize("case,dtype,route", MLA_PARAMS)
def test_flash_attention_mla_head_dims_match_plain(cuda, case, dtype, route):
    """Both forward kernels at hd != hdv against the plain version: the
    output (B, Sq, H, hdv), 16-byte aligned on the tensor-core route."""
    b, sq, sk, h, hkv, hd, hdv = case[:7]
    causal, window, q_offset = case[7:]
    rng = np.random.default_rng(sum(case[:7]))
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(device=cuda, dtype=dtype)
               for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hdv)))
    assert tfa._route(torch.bfloat16, hd, hdv) == "tc"
    tfa.reset_launches()
    got = tfa.launch(q, k, v, causal, window, q_offset, route)
    assert tfa.LAUNCHES["flash_attention"] == 1
    assert tfa.LAUNCHES["flash_attention_tc"] == int(route == "tc")
    assert tfa.LAUNCHES["flash_attention_tf32x3"] == int(route == "tf32x3")
    want = tref.flash_attention_ref(q, k, v, causal, window, q_offset,
                                    skip_masked_chunks=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, sq, h, hdv)
    assert tfa._tc_aligned(got)
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL[dtype],
                               atol=FA_TOL[dtype])


def test_flash_attention_mla_instantiations_do_not_spill(cuda):
    """ptxas -v of the library: the forward kernels at (192, 128) and
    (24, 16), both routes (the tensor cores' one-warpgroup kernel and the
    narrow CTA at (24, 16), the warp-specialised one at (192, 128)), spill
    no registers."""
    import re

    tfa.LIBRARY.build()
    with open(tfa.LIBRARY.log_path()) as f:
        log = f.read()
    found = {}
    for name, body in re.findall(
            r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
            log, re.S):
        if re.search(r"flash_attention_(tc_|ws_|narrow_)?kernelI\w*"
                     r"Li(192ELi128|24ELi16)E", name):
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          body)
            found[name] = (int(m.group(1)), int(m.group(2)))
    # float32 and bf16 FMA kernels and the tensor-core kernel, two pairs,
    # and the narrow CTA at (24, 16)
    assert len(found) == 7, found
    assert all(v == (0, 0) for v in found.values()), found


# (B, Sq, Sk, H, Hkv, causal, window, q_offset) at (24, 16): the smoke's
# shape, the narrow CTA's key limit and one past it (the general kernel),
# GQA, a window, appended queries and a decode step (q_offset), ragged
# and cross lengths, Sq past the limit (the forward's limit is Sk's)
NARROW_FA_CASES = [
    (2, 256, 256, 4, 4, True, 0, 0),
    (2, 257, 257, 4, 4, True, 0, 0),
    (1, 300, 256, 4, 2, False, 0, 0),
    (1, 200, 200, 8, 2, True, 0, 0),
    (1, 256, 256, 4, 4, True, 70, 0),
    (1, 50, 256, 4, 2, True, 13, 206),
    (2, 1, 256, 4, 4, True, 0, 255),
    (1, 1, 257, 4, 4, True, 0, 256),
    (2, 77, 77, 4, 4, True, 0, 0),
    (1, 70, 130, 4, 4, False, 0, 0),
    (1, 130, 40, 2, 1, True, 0, 0),
]


@pytest.mark.parametrize("case", NARROW_FA_CASES)
def test_flash_attention_narrow_matches_plain(cuda, case):
    """The tensor-core forward at (24, 16) against the plain version
    (bf16, 2e-2) on both sides of NARROW_MAX_LEN keys: the plan names the
    narrow CTA up to it and the general kernel past it, and the launch
    counters agree; lse against the FMA kernel's on the same inputs in
    float32 (1e-5)."""
    b, sq, sk, h, hkv, causal, window, q_offset = case
    q, k, v = _ws_qkv((b, sq, sk, h, hkv, 24, 16), cuda, seed=sum(case))
    narrow = sk <= tfa.NARROW_MAX_LEN
    plan = tfa.forward_plan(b, sq, sk, h, hkv, 24, torch.bfloat16, hdv=16)
    assert plan["kernel"] == ("flash_attention_narrow_kernel" if narrow
                              else "flash_attention_tc_kernel")
    tfa.reset_launches()
    got, lse = tfa._forward(q, k, v, causal, window, q_offset, "tc",
                            with_lse=True)
    assert tfa.LAUNCHES["flash_attention_tc"] == 1
    assert tfa.LAUNCHES["flash_attention_narrow"] == int(narrow)
    want = tref.flash_attention_ref(q, k, v, causal, window, q_offset,
                                    skip_masked_chunks=True)
    _, lse_fma = tfa._forward(q.float(), k.float(), v.float(), causal,
                              window, q_offset, "fma", with_lse=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, h, 16)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, lse_fma, rtol=1e-5, atol=1e-5)
    again = tfa.launch(q, k, v, causal, window, q_offset, "tc")
    assert torch.equal(got, again)


# (B, Sq, Sk, H, Hkv, causal, window) at (24, 16): the smoke's training
# shape, the one-launch limit on both lengths and one past it (three
# kernels), GQA (a CTA walks its kv head's query heads), a window, Sq !=
# Sk either way, ragged lengths, a key tile no query reaches
NARROW_BWD_CASES = [
    (2, 256, 256, 4, 4, True, 0),
    (2, 257, 257, 4, 4, True, 0),
    (1, 256, 257, 4, 4, False, 0),
    (1, 256, 256, 8, 2, True, 0),
    (1, 256, 256, 4, 4, True, 70),
    (1, 150, 150, 4, 2, False, 40),
    (1, 100, 256, 2, 2, False, 0),
    (1, 256, 100, 2, 1, True, 0),
    (2, 77, 77, 4, 4, True, 0),
    (1, 64, 200, 2, 2, True, 0),
]


@pytest.mark.parametrize("case", NARROW_BWD_CASES)
def test_flash_attention_narrow_backward_matches_plain(cuda, case):
    """The tensor-core backward at (24, 16) through FlashAttentionFn
    against autograd through the plain version (BWD_TOL): one launch of
    fa_bwd_narrow_tc_kernel where Sq and Sk are at most NARROW_MAX_LEN,
    the three kernels past it; two backward runs give the same bits."""
    b, sq, sk, h, hkv, causal, window = case
    qkv, do = _bwd_inputs((b, sq, sk, h, hkv, 24), torch.bfloat16, cuda,
                          seed=sum(case), hdv=16)
    narrow = max(sq, sk) <= tfa.NARROW_MAX_LEN
    plan = tfa.backward_plan(b, sq, sk, h, hkv, 24, torch.bfloat16, hdv=16)
    assert [n for n, _ in plan["kernels"]] == (
        ["fa_bwd_narrow_tc_kernel"] if narrow else
        ["fa_bwd_preprocess_tc_kernel", "fa_bwd_dkdv_tc_kernel"]
        + (["fa_bwd_gqa_reduce_kernel"] if h > hkv else [])
        + ["fa_bwd_dq_tc_kernel"])
    tfa.reset_launches()
    out = tfa.flash_attention(*qkv, causal=causal, window=window)
    got = torch.autograd.grad(out, qkv, do, retain_graph=True)
    again = torch.autograd.grad(out, qkv, do)
    assert tfa.LAUNCHES["flash_attention_bwd_tc"] == 2
    assert tfa.LAUNCHES["flash_attention_bwd_narrow"] == 2 * narrow
    ref_out = tref.flash_attention_ref(*qkv, causal, window, 0, 64, 64)
    want = torch.autograd.grad(ref_out, qkv, do)
    torch.cuda.synchronize()
    for g, g2, w, t in zip(got, again, want, qkv):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        assert torch.equal(g.view(torch.int16), g2.view(torch.int16))
        torch.testing.assert_close(g.float(), w.float(),
                                   **BWD_TOL[torch.bfloat16])


def test_narrow_kernels_do_not_spill_or_serialise(cuda):
    """ptxas -v of both libraries: the narrow forward and the one-launch
    backward at (24, 16) (four warpgroups, 128 registers a thread at
    most) spill nothing, and no "(C75xx)" note (wgmma serialised) names
    either."""
    import re

    for lib, kernel in ((tfa.LIBRARY, "flash_attention_narrow_kernel"),
                        (tfa.BWD_LIBRARY, "fa_bwd_narrow_tc_kernel")):
        lib.build()
        with open(lib.log_path()) as f:
            log = f.read()
        found = {name: body for name, body in re.findall(
            r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
            log, re.S) if kernel in name}
        assert len(found) == 1, (kernel, list(found))
        (name, body), = found.items()
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      body)
        assert (int(m.group(1)), int(m.group(2))) == (0, 0), body
        notes = re.findall(r"\((C75\d\d)\).*? in the function '(\S+?)'",
                           log)
        assert not [n for n in notes if n[1] == name], notes


def test_flash_attention_kernel_reads_strided_views(cuda):
    """q/k/v sliced out of a fused projection: strides, no copies."""
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.normal(size=(2, 40, 8, 16)).astype(
        np.float32)).to(cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = tfa.flash_attention(q, k, v, causal=True)
    want = tref.flash_attention_ref(q, k, v, True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", [FA_CASES[0], FA_CASES[4], FA_CASES[6]])
def test_flash_attention_fma_route_bf16(cuda, case):
    """The float32-FMA kernel named for bf16 operands the rule sends to
    the tensor cores (the smoke times both routes)."""
    causal, window, q_offset = case[6:]
    q, k, v = _qkv(case, torch.bfloat16, cuda, seed=4)
    tfa.reset_launches()
    got = tfa.launch(q, k, v, causal, window, q_offset, route="fma")
    assert tfa.LAUNCHES == {"flash_attention": 1, "flash_attention_tc": 0,
                            "flash_attention_bwd": 0,
                            "flash_attention_bwd_tc": 0,
                            "flash_attention_narrow": 0,
                            "flash_attention_bwd_narrow": 0,
                            "flash_attention_split": 0,
                            "flash_attention_bwd_one_grid": 0,
                            "flash_attention_tf32x3": 0,
                            "flash_attention_bwd_tf32x3": 0}
    want = tref.flash_attention_ref(q, k, v, causal, window, q_offset,
                                    skip_masked_chunks=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_flash_attention_tc_reads_strided_views(cuda):
    """bf16 q/k/v sliced out of a fused projection (B, S, H + 2 Hkv, hd)
    go through the tensor-core kernel in place."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.normal(size=(2, 90, 8, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    tfa.reset_launches()
    got = tfa.flash_attention(q, k, v, causal=True)
    assert tfa.LAUNCHES["flash_attention_tc"] == 1
    want = tref.flash_attention_ref(q, k, v, True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# the tensor-core routes' 16-byte rule: (route, dtype, the dtype the
# route refuses, the words' integer view, a head stride that breaks the
# rule, the rule's stride multiple, the refusal of the other dtype)
ALIGN_ROUTES = [
    pytest.param("tc", torch.bfloat16, torch.float32, torch.int16, 20, 8,
                 "tensor-core route takes", id="tc"),
    pytest.param("tf32x3", torch.float32, torch.bfloat16, torch.int32, 18, 4,
                 "tf32x3 route takes", id="tf32x3"),
]


@pytest.mark.parametrize("route,dtype,other,words,stride,mult,refusal",
                         ALIGN_ROUTES)
def test_flash_attention_tc_refuses_misaligned(cuda, route, dtype, other,
                                               words, stride, mult,
                                               refusal):
    """The tensor-core routes (bf16 "tc", float32 "tf32x3") raise on
    operands their 16-byte copies cannot read (a start off the boundary,
    a head stride that is no multiple of 16 bytes); they never fall back
    to the FMA kernel."""
    q, k, v = _qkv((1, 8, 8, 4, 2, 16), dtype, cuda)
    tfa.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(_misaligned(q), k, v)           # 2-byte offset
    wide = torch.zeros((1, 8, 2, stride), dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match=f"multiples of {mult}"):
        tfa.flash_attention(q, wide[..., :16], v)
    with pytest.raises(ValueError, match=refusal):
        tfa.launch(q.to(other), k.to(other), v.to(other), True, 0, 0,
                   route=route)
    assert tfa.LAUNCHES == {"flash_attention": 0, "flash_attention_tc": 0,
                            "flash_attention_bwd": 0,
                            "flash_attention_bwd_tc": 0,
                            "flash_attention_narrow": 0,
                            "flash_attention_bwd_narrow": 0,
                            "flash_attention_split": 0,
                            "flash_attention_bwd_one_grid": 0,
                            "flash_attention_tf32x3": 0,
                            "flash_attention_bwd_tf32x3": 0}


def test_flash_attention_wrapper_refuses(cuda):
    q, k, v = _qkv((1, 8, 8, 4, 2, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._check(q.cpu(), k.cpu(), v.cpu(), 0, 0)        # CPU operands
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k.cpu(), v)                  # mixed devices
    with pytest.raises(ValueError, match="grad"):   # launch: forward only
        tfa.launch(q.clone().requires_grad_(), k, v, True, 0, 0, "fma")
    with pytest.raises(ValueError, match="q_offset"):  # backward: offset 0
        tfa.flash_attention(q.clone().requires_grad_(), k, v, q_offset=1)
    q96, k96, v96 = _qkv((1, 8, 8, 4, 2, 96), torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q96, k96, v96)                  # head dim 96
    with pytest.raises(ValueError, match="hdv"):
        tfa.flash_attention(q, k, v[..., :8])               # MLA-style hdv
    with pytest.raises(ValueError):
        tfa.flash_attention(q.half(), k.half(), v.half())   # float16
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v.bfloat16())             # mixed dtypes


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-14b"])
def test_prefill_and_serve_on_card_match_cpu(cuda, arch):
    """float32: DecoderLM.prefill through the kernel on the card against
    the plain version on the CPU (1e-4: sums in another order), and the
    same greedy tokens from both engines."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = load_flat(build_model(cfg, device=cuda), flatten_tree(cpu))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 70)))
    tfa.reset_launches()
    lc, cc = card.prefill(toks.to(cuda))
    assert tfa.LAUNCHES["flash_attention"] == cfg.n_layers
    lh, ch = cpu.prefill(toks)
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        torch.testing.assert_close(cc[name].cpu(), ch[name], rtol=1e-4,
                                   atol=1e-4)

    prompts = [np.arange(n, dtype=np.int32) * 7 % cfg.vocab_size
               for n in (5, 40, 12, 70, 3)]
    out = []
    for model in (card, cpu):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        ServeEngine(model, batch_slots=2, max_len=96).run(reqs)
        out.append([r.out_tokens for r in reqs])
    assert out[0] == out[1]


# (B, Sq, Sk, H, Hkv, hd, hdv, causal, window): the backward takes
# q_offset 0; past the hd == hdv cases, DeepSeek-V2-Lite's MLA at (192,
# 128) and its smoke config's (24, 16), MHA as the model runs it and with
# GQA, and RecurrentGemma-9B's (256, 256) with its window masking keys, 16
# query heads over one kv head (the GQA reduction at g = 16), and without
# a mask
BWD_CASES = [
    (2, 130, 130, 4, 2, 16, 16, True, 0),      # GQA causal, ragged tiles
    (1, 200, 200, 6, 2, 8, 8, True, 70),       # window, hd 8
    (1, 100, 150, 4, 4, 32, 32, False, 0),     # cross, MHA, ragged
    (1, 150, 150, 2, 1, 64, 64, False, 40),    # window without causal
    (1, 256, 256, 12, 2, 128, 128, True, 0),   # the model's heads
    (1, 64, 64, 2, 1, 128, 128, True, 1),      # each row attends itself
    (2, 1000, 1000, 12, 2, 128, 128, True, 0),  # the model's heads, ragged
    (2, 130, 130, 4, 4, 192, 128, True, 0),
    (1, 200, 200, 4, 2, 192, 128, True, 70),
    (1, 100, 150, 2, 2, 192, 128, False, 0),
    (2, 100, 100, 4, 4, 24, 16, True, 0),
    (1, 150, 150, 4, 2, 24, 16, False, 40),
    (1, 300, 300, 16, 1, 256, 256, True, 100),
    (2, 130, 130, 4, 1, 256, 256, True, 0),
    (1, 100, 150, 4, 4, 256, 256, False, 0),
    # past hd 128 each warpgroup takes 32 of a tile's 64 queries (dK / dV)
    # or keys (dQ): Sq != Sk under the causal mask (keys no query reaches,
    # rows that reach a tile's first half only), a length 32 past a
    # multiple of 64 (a tile with one warpgroup's half empty), windows
    # whose edge cuts a half, and (256, 256) with g = 4
    (1, 160, 96, 2, 1, 192, 128, True, 0),
    (1, 96, 160, 2, 2, 192, 128, True, 0),
    (1, 160, 160, 4, 2, 192, 128, True, 0),
    (1, 200, 200, 2, 2, 192, 128, True, 48),
    (1, 160, 96, 4, 4, 256, 256, True, 0),
    (1, 96, 160, 4, 1, 256, 256, True, 0),
    (1, 160, 160, 8, 2, 256, 256, True, 0),
    (1, 200, 200, 8, 2, 256, 256, False, 80),
]
# (dtype, backward route): float32 the split-TF32 tensor-core route and
# the FMA route (named); bf16 both its routes; the tensor cores only with
# (hd, hdv) in TC_HEAD_DIMS
BWD_PARAMS = [
    pytest.param(case, dtype, route, id=f"{name}-{route}-{i}")
    for i, case in enumerate(BWD_CASES)
    for name, dtype, route in (("f32", torch.float32, "tf32x3"),
                               ("f32", torch.float32, "fma"),
                               ("bf16", torch.bfloat16, "fma"),
                               ("bf16", torch.bfloat16, "tc"))
    if route == "fma" or (case[5], case[6]) in tfa.TC_HEAD_DIMS
]
# the backward against autograd through the plain version: float32 sums
# in another order; bf16 gradients one bf16 rounding apart (the forward's
# P is rounded to bf16 on the tensor-core route)
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _bwd_inputs(case, dtype, device, seed=0, hdv=None):
    b, sq, sk, h, hkv, hd = case[:6]
    hdv = hd if hdv is None else hdv
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(device=device, dtype=dtype)
               for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hdv)))
    do = torch.from_numpy(np.random.default_rng(seed + 9).normal(
        size=(b, sq, h, hdv)).astype(np.float32)).to(device=device, dtype=dtype)
    return [t.requires_grad_() for t in (q, k, v)], do


@pytest.mark.parametrize("case,dtype,route", BWD_PARAMS)
def test_flash_attention_fn_grads_match_plain_autograd(cuda, case, dtype,
                                                       route, monkeypatch):
    """FlashAttentionFn (forward kernel with lse, backward kernels on the
    given route; in float32 a forced FMA backward from the FMA forward)
    against autograd through ``flash_attention_ref`` on the card; two
    backward runs give the same bits."""
    import functools

    causal, window = case[7:]
    qkv, do = _bwd_inputs(case, dtype, cuda, hdv=case[6])
    monkeypatch.setattr(tfa, "backward",
                        functools.partial(tfa.backward, route=route))
    if dtype == torch.float32 and route == "fma":
        # the FMA pair: its backward from the FMA forward's o and lse
        monkeypatch.setattr(tfa, "_route", lambda *_, **__: "fma")
    tfa.reset_launches()
    out = tfa.flash_attention(*qkv, causal=causal, window=window)
    got = torch.autograd.grad(out, qkv, do, retain_graph=True)
    again = torch.autograd.grad(out, qkv, do)
    assert tfa.LAUNCHES["flash_attention"] == 1
    assert tfa.LAUNCHES["flash_attention_bwd"] == 2
    assert tfa.LAUNCHES["flash_attention_bwd_tc"] == (2 if route == "tc"
                                                      else 0)
    assert tfa.LAUNCHES["flash_attention_bwd_tf32x3"] == (
        2 if route == "tf32x3" else 0)
    ref_out = tref.flash_attention_ref(*qkv, causal, window, 0, 64, 64)
    want = torch.autograd.grad(ref_out, qkv, do)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=FA_TOL[dtype],
                               atol=FA_TOL[dtype])
    for g, g2, w, t in zip(got, again, want, qkv):
        assert g.dtype == dtype and g.shape == t.shape
        assert torch.equal(g.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                           g2.view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32))
        torch.testing.assert_close(g.float(), w.float(), **BWD_TOL[dtype])


def test_flash_attention_backward_tc_does_not_spill(cuda):
    """ptxas -v of the library: no tensor-core backward kernel spills, at
    any pair (preprocess at each hdv, dK / dV and dQ at each pair, the
    GQA reduction into bf16 and into float32, the one-launch kernel at
    (24, 16), the one-grid kernel at the five one-warpgroup pairs), and
    ptxas serialises the wgmma of none of the two-warpgroup dK / dV and
    dQ kernels past hd 128 and of the one-launch kernel (no "(C7520)
    Potential Performance Loss" note names them)."""
    import re

    tfa.BWD_LIBRARY.build()
    with open(tfa.BWD_LIBRARY.log_path()) as f:
        log = f.read()
    found = {}
    for name, body in re.findall(
            r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
            log, re.S):
        if re.search(r"fa_bwd_\w*(tc|reduce)_kernel", name):
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          body)
            found[name] = (int(m.group(1)), int(m.group(2)))
    # 5 preprocess (hdv 16, 32, 64, 128, 256), 7 dK / dV, 7 dQ, 2
    # reductions, the one-launch kernel at (24, 16), the one-grid kernel
    # at (16, 16), (24, 16), (32, 32), (64, 64) and (128, 128)
    assert len(found) == 27, found
    assert all(v == (0, 0) for v in found.values()), found
    wide = [n for n in found if re.search(
        r"fa_bwd_(dkdv|dq)_tc_kernelI(Li192ELi128E|Li256ELi256E)", n)]
    assert len(wide) == 4, wide
    # the one-launch kernel's four warpgroups run one instruction stream
    wide += [n for n in found if "fa_bwd_narrow_tc_kernel" in n]
    assert len(wide) == 5, wide
    serialised = re.findall(r"Potential Performance Loss: wgmma\S* "
                            r"instructions are serialized.*? in the function "
                            r"'(\S+?)'", log)
    assert not set(serialised) & set(wide), serialised


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "recurrentgemma-9b"])
def test_launch_train_trains_on_card(cuda, tmp_path, arch):
    """``launch.train --smoke --steps 2`` on the card: the smoke config
    (float32: the split-TF32 backward at (24, 16) and (16, 16)) trains through
    the flash kernels, one forward and one backward an attention layer a
    step (remat off), and checkpoints."""
    from repro_torch.launch import train as train_cli
    from repro_torch.store import checkpoint as tckpt
    from repro_torch.store.snapshot import SnapshotStore

    cfg = get_smoke_config(arch)
    attn_layers = (cfg.n_layers // 3 if cfg.block_pattern
                   else cfg.n_layers)
    ws = str(tmp_path / "ws")
    tfa.reset_launches()
    train_cli.main(["--arch", arch, "--smoke", "--steps", "2",
                    "--ckpt-every", "2", "--batch", "2", "--seq", "32",
                    "--workspace", ws])
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == 2 * attn_layers
    assert tfa.LAUNCHES["flash_attention_bwd"] == 2 * attn_layers
    assert tckpt.latest_checkpoint(SnapshotStore(ws)) == "train-step-00000002"


def test_flash_attention_fn_forward_equals_launch(cuda):
    """The lse-writing forward gives the serving kernel's bits; lse is
    the row log-sum-exp of the scaled scores."""
    case = (2, 100, 100, 4, 2, 16, True, 0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(case, dtype, cuda)
        route = tfa._route(dtype, 16, 16)
        out, lse = tfa._forward(q, k, v, True, 0, 0, route, with_lse=True)
        plain = tfa.launch(q, k, v, True, 0, 0, route)
        torch.cuda.synchronize()
        assert torch.equal(out, plain)
        kk = k.float().repeat_interleave(2, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / 4.0
        s = s.masked_fill(~torch.ones(100, 100, dtype=torch.bool,
                                      device=cuda).tril(), float("-inf"))
        torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5,
                                   atol=1e-5)


def test_flash_attention_fn_takes_the_tc_backward_for_bf16(cuda):
    """The route rule: with (hd, hdv) in TC_HEAD_DIMS bf16 trains through
    the tensor-core backward, float32 through the split-TF32 one, but at
    FMA_BACKWARD_PAIRS ((16, 16)) through the split-TF32 forward and the
    FMA backward."""
    for hd in (32, 16):
        case = (1, 64, 64, 4, 2, hd, True, 0)
        for dtype, tc in ((torch.bfloat16, 1), (torch.float32, 0)):
            qkv, do = _bwd_inputs(case, dtype, cuda)
            tfa.reset_launches()
            torch.autograd.grad(tfa.flash_attention(*qkv), qkv, do)
            tf32_bwd = 1 - tc if hd == 32 else 0
            assert tfa.LAUNCHES["flash_attention_bwd"] == 1
            assert tfa.LAUNCHES["flash_attention_bwd_tc"] == tc
            assert tfa.LAUNCHES["flash_attention_bwd_tf32x3"] == tf32_bwd
            assert tfa.LAUNCHES["flash_attention_tf32x3"] == 1 - tc


def _misaligned(t):
    """The same values in a view that starts 2 bytes past a 16-byte
    boundary (so not on the tensor-core route's boundary)."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("route,dtype,other,words,stride,mult,refusal",
                         ALIGN_ROUTES)
def test_flash_attention_backward_tc_copies_misaligned_grad(
        cuda, route, dtype, other, words, stride, mult, refusal):
    """An upstream gradient off the 16-byte rule (an offset view, or a
    head stride that is no multiple of 16 bytes) is copied, not refused,
    on either tensor-core route: the same bits as from the aligned
    gradient."""
    case = (2, 70, 70, 4, 2, 16, True, 0)
    qkv, do = _bwd_inputs(case, dtype, cuda)
    q, k, v = (t.detach() for t in qkv)
    out, lse = tfa._forward(q, k, v, True, 0, 0, route, with_lse=True)
    wide = torch.zeros((2, 70, 4, stride), dtype=dtype, device=cuda)
    wide[..., :16] = do
    views = [_misaligned(do), wide[..., :16]]
    assert not any(tfa._tc_aligned(t) for t in views)
    want = tfa.backward(do, q, k, v, out, lse, True, 0, route=route)
    for view in views:
        got = tfa.backward(view, q, k, v, out, lse, True, 0, route=route)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.view(words), w.view(words))


@pytest.mark.parametrize("route,dtype,other,words,stride,mult,refusal",
                         ALIGN_ROUTES)
def test_flash_attention_backward_tc_refuses_misaligned_qkv(
        cuda, route, dtype, other, words, stride, mult, refusal):
    """q, k or v off the 16-byte rule is refused on either tensor-core
    route (no copy, no other route)."""
    qkv, do = _bwd_inputs((1, 64, 64, 4, 2, 16, True, 0), dtype, cuda)
    q, k, v = (t.detach() for t in qkv)
    out, lse = tfa._forward(q, k, v, True, 0, 0, route, with_lse=True)
    tfa.reset_launches()
    for i in range(3):
        ops = [q, k, v]
        ops[i] = _misaligned(ops[i])
        with pytest.raises(ValueError, match="tensor-core route"):
            tfa.backward(do, *ops, out, lse, True, 0, route=route)
    assert tfa.LAUNCHES["flash_attention_bwd"] == 0


def test_flash_attention_backward_refuses(cuda):
    qkv, do = _bwd_inputs((1, 8, 8, 4, 2, 16), torch.float32, cuda)
    q, k, v = (t.detach() for t in qkv)
    out, lse = tfa._forward(q, k, v, True, 0, 0, "fma", with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        tfa.backward(do, q, k, v, out, lse[:, :, :4], True, 0)
    with pytest.raises(ValueError, match="o / dO"):
        tfa.backward(do.bfloat16(), q, k, v, out, lse, True, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.backward(do.cpu(), q.cpu(), k.cpu(), v.cpu(), out.cpu(),
                     lse.cpu(), True, 0)


@pytest.mark.parametrize("op,theta", OPS)
def test_merge_blocks_bf16_nan_bits_on_card(cuda, op, theta):
    """C1 on the card: NaN outputs downcast by from_float32's rule (sign
    | 0x7FC0), every other element equal to the numpy operator."""
    from repro_torch.core.operators import apply_operator
    from repro_torch.store import dtypes

    x0, D, masks = _mk(4, 3, 300, seed=2)
    words = dtypes.from_float32(x0, dtypes.BFLOAT16)
    words[:, 3:10] = [0xFFC0, 0x7FC0, 0x7FC1, 0xFFA5, 0x7F81, 0xFF80, 0x7F80]
    if op != "ties":
        D[:, 1, 50:54] = np.array([0x7FC00000, 0xFFC00000, 0x7FA00001,
                                   0xFF812345], np.uint32).view(np.float32)
        masks[:, 1, 50:54] = True
    kw = {"masks": masks} if op == "dare" else {}
    got = ops.merge_blocks(op, words, D, theta, device=cuda,
                           out_dtype=dtypes.BFLOAT16, **kw)
    for b in range(4):
        th = dict(theta, _masks=masks[b]) if op == "dare" else theta
        np.testing.assert_array_equal(got[b], apply_operator(words[b], D[b],
                                                             op, th))


def test_train_step_on_card_matches_cpu(cuda):
    """float32 smoke model, remat on: a train step on the card (flash
    forward and backward kernels) against the same step on the CPU
    (plain attention) from the same weights: loss, gradient norm, and
    the gradients through AdamW's first moment m = (1 - b1) g (float32
    sums in another order; entries that cancel near zero get a slack of
    1e-5 of the tensor's largest magnitude)."""
    import dataclasses

    from repro_torch.models.model import train_state_from_flat
    from repro_torch.train.data import synth_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), remat=True)
    card = build_model(cfg, device=cuda)
    states = [init_train_state(card, torch.Generator(device=cuda)
                               .manual_seed(0))]
    cpu = build_model(cfg, device="cpu")
    states.append(train_state_from_flat(cpu, flatten_tree(states[0])))
    tokens = synth_batch(0, 0, 2, 100, cfg.vocab_size)
    out = []
    for model, state in zip((card, cpu), states):
        batch = {k: torch.from_numpy(v).long().to(model.device)
                 for k, v in tokens.items()}
        tfa.reset_launches()
        state, m = make_train_step(model, AdamWConfig(lr=1e-3))(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    flatten_tree(state.opt.m)))
        if model is card:
            # forward + remat recompute per layer, one backward per layer
            assert tfa.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
            assert tfa.LAUNCHES["flash_attention_bwd"] == cfg.n_layers
    (lc, nc, mc), (lh, nh, mh) = out
    assert lc == pytest.approx(lh, rel=1e-5)
    assert nc == pytest.approx(nh, rel=1e-4)
    for n in mc:
        np.testing.assert_allclose(mc[n], mh[n], rtol=1e-4,
                                   atol=1e-5 * float(np.abs(mh[n]).max()))


# (B, Sq, Sk, H, Hkv, causal, window, q_offset) at (hd, hdv) = (256, 256),
# RecurrentGemma-9B's local attention: its prefill shape (16 query heads
# over one kv head, window 2,048), causal, a window, ragged Sq / Sk with
# GQA, MQA with a q_offset, decode-style single queries, no mask
RG_FA_CASES = [
    (1, 3072, 3072, 16, 1, True, 2048, 0),
    (2, 130, 130, 4, 1, True, 0, 0),
    (1, 300, 300, 16, 1, True, 100, 0),
    (2, 77, 200, 4, 2, True, 50, 70),
    (1, 40, 300, 16, 1, True, 0, 260),
    (1, 1, 2048, 16, 1, True, 2048, 2047),
    (1, 1, 300, 16, 1, True, 0, 299),
    (1, 100, 300, 4, 4, False, 0, 0),
]
RG_PARAMS = [pytest.param(case, dtype, route, id=f"{name}-{route}-{i}")
             for i, case in enumerate(RG_FA_CASES)
             for name, dtype, route in (("f32", torch.float32, "tf32x3"),
                                        ("f32", torch.float32, "fma"),
                                        ("bf16", torch.bfloat16, "fma"),
                                        ("bf16", torch.bfloat16, "tc"))]


@pytest.mark.parametrize("case,dtype,route", RG_PARAMS)
def test_flash_attention_256_matches_plain(cuda, case, dtype, route):
    """Both forward kernels at (256, 256) against the plain version (the
    tensor-core route: the warp-specialised CTA, a TMA producer and two
    consumer warpgroups of 64 rows each)."""
    b, sq, sk, h, hkv, causal, window, q_offset = case
    rng = np.random.default_rng(sum(case[:5]))
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(device=cuda, dtype=dtype)
               for s in ((b, sq, h, 256), (b, sk, hkv, 256),
                         (b, sk, hkv, 256)))
    assert tfa._route(torch.bfloat16, 256, 256) == "tc"
    tfa.reset_launches()
    if route == tfa._route(dtype, 256, 256):
        got = tfa.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    else:
        got = tfa.launch(q, k, v, causal, window, q_offset, route)
    assert tfa.LAUNCHES["flash_attention"] == 1
    assert tfa.LAUNCHES["flash_attention_tc"] == int(route == "tc")
    assert tfa.LAUNCHES["flash_attention_tf32x3"] == int(route == "tf32x3")
    want = tref.flash_attention_ref(q, k, v, causal, window, q_offset,
                                    skip_masked_chunks=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, sq, h, 256)
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL[dtype],
                               atol=FA_TOL[dtype])


def test_flash_attention_256_lse_matches_fma(cuda):
    """The tensor-core forward's per-row lse at (256, 256) (each consumer
    warpgroup writes its rows') against the FMA kernel's on the same
    inputs in float32."""
    q, k, v = (torch.randn(s, device=cuda).to(torch.bfloat16)
               for s in ((1, 200, 4, 256), (1, 200, 1, 256),
                         (1, 200, 1, 256)))
    _, lse_tc = tfa._forward(q, k, v, True, 64, 0, "tc", with_lse=True)
    _, lse = tfa._forward(q.float(), k.float(), v.float(), True, 64, 0, "fma",
                          with_lse=True)
    torch.testing.assert_close(lse_tc, lse, rtol=1e-5, atol=1e-5)


def test_flash_attention_256_tc_refuses_misaligned(cuda):
    """At (256, 256) too the tensor-core route raises on operands its
    16-byte copies cannot read."""
    q = torch.zeros((1, 8, 4, 256), dtype=torch.bfloat16, device=cuda)
    buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    q_off = buf[1:].view(q.shape)                           # 2-byte offset
    tfa.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(q_off, q, q)
    wide = torch.zeros((1, 8, 2, 260), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa.flash_attention(q, wide[..., :256], wide[..., :256])
    assert tfa.LAUNCHES["flash_attention"] == 0


def test_flash_attention_256_tc_does_not_spill(cuda):
    """ptxas -v of the library: the (256, 256) forward kernels spill no
    registers."""
    import re

    tfa.LIBRARY.build()
    with open(tfa.LIBRARY.log_path()) as f:
        log = f.read()
    found = {}
    for name, body in re.findall(
            r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
            log, re.S):
        if re.search(r"flash_attention_(tc_|ws_)?kernelI\w*Li256ELi256E",
                     name):
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          body)
            found[name] = (int(m.group(1)), int(m.group(2)))
    assert len(found) == 3, found          # float32, bf16 FMA; tensor cores
    assert all(v == (0, 0) for v in found.values()), found


@pytest.mark.parametrize("head_dim", [16, 256])
def test_griffin_prefill_and_serve_on_card_match_cpu(cuda, head_dim):
    """float32: GriffinLM.prefill through the kernel on the card (one
    launch an attention layer) against the plain version on the CPU
    (1e-4: sums in another order), its cache entries, and the same greedy
    tokens from both engines, prompts past the window of 8; at the smoke
    config's head dim and at the published 256."""
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-9b"),
                              head_dim=head_dim)
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = load_flat(build_model(cfg, device=cuda), flatten_tree(cpu))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 70)))
    tfa.reset_launches()
    lc, cc = card.prefill(toks.to(cuda))
    assert tfa.LAUNCHES["flash_attention"] == cfg.n_layers // 3
    lh, ch = cpu.prefill(toks)
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-4)
    assert set(cc) == set(ch)
    for name in set(ch) - {"len"}:
        torch.testing.assert_close(cc[name].cpu(), ch[name], rtol=1e-4,
                                   atol=1e-4)

    prompts = [np.arange(n, dtype=np.int32) * 7 % cfg.vocab_size
               for n in (5, 40, 12, 70, 3)]
    out = []
    for model in (card, cpu):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        ServeEngine(model, batch_slots=2, max_len=96).run(reqs)
        out.append([r.out_tokens for r in reqs])
    assert out[0] == out[1]


# (B, Sq, Sk, H, Hkv, hd, hdv, causal, window, q_offset): the
# warp-specialised forward past hd 128 (128 q rows a CTA, two consumer
# warpgroups of 64): ragged Sq across its 128-row tiles (1,000, 65, 129),
# Sq != Sk with a q_offset, decode-style Sq = 1, windows of 64 and 2,048,
# g = 16 and g = 1, and B = 3, where a tile's rows run past one batch's
# end (TMA's boxes are clipped at Sq per batch, never read the next one)
WS_FA_CASES = [
    (1, 1000, 1000, 16, 16, 192, 128, True, 0, 0),
    (1, 65, 65, 4, 4, 192, 128, True, 64, 0),
    (3, 129, 129, 4, 2, 192, 128, True, 0, 0),
    (3, 65, 200, 4, 1, 192, 128, True, 0, 135),
    (1, 100, 300, 4, 2, 192, 128, False, 70, 200),
    (1, 1, 300, 16, 16, 192, 128, True, 0, 299),
    (1, 1000, 1000, 16, 1, 256, 256, True, 2048, 0),
    (1, 129, 129, 4, 4, 256, 256, True, 64, 0),
    (3, 65, 65, 16, 1, 256, 256, True, 64, 0),
    (2, 77, 200, 4, 2, 256, 256, True, 50, 123),
    (1, 1, 2048, 16, 1, 256, 256, True, 2048, 2047),
    (3, 129, 129, 4, 4, 256, 256, False, 0, 0),
]


def _ws_qkv(case, device, seed):
    b, sq, sk, h, hkv, hd, hdv = case[:7]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(device=device, dtype=torch.bfloat16)
            for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hdv))]


@pytest.mark.parametrize("case", WS_FA_CASES,
                         ids=[f"{c[5]}-{c[6]}-{i}"
                              for i, c in enumerate(WS_FA_CASES)])
def test_flash_attention_ws_matches_plain(cuda, case):
    """The warp-specialised tensor-core forward against the plain version
    (bf16, 2e-2: outputs one bf16 rounding apart), and its lse against the
    FMA kernel's on the same inputs in float32 (1e-5: the same scores
    summed in another order)."""
    b, sq, sk, h, hkv, hd, hdv = case[:7]
    causal, window, q_offset = case[7:]
    q, k, v = _ws_qkv(case, cuda, seed=sum(case[:7]))
    assert tfa.forward_plan(b, sq, sk, h, hkv, hd, torch.bfloat16,
                            hdv=hdv)["kernel"] == "flash_attention_ws_kernel"
    tfa.reset_launches()
    got, lse = tfa._forward(q, k, v, causal, window, q_offset, "tc",
                            with_lse=True)
    assert tfa.LAUNCHES["flash_attention_tc"] == 1
    want = tref.flash_attention_ref(q, k, v, causal, window, q_offset,
                                    skip_masked_chunks=True)
    _, lse_fma = tfa._forward(q.float(), k.float(), v.float(), causal,
                              window, q_offset, "fma", with_lse=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, h, hdv)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, lse_fma, rtol=1e-5, atol=1e-5)


def test_flash_attention_ws_reads_strided_views(cuda):
    """q, k and v as views (no copies) through the warp-specialised
    kernel's tensor maps: q / k / v sliced out of a fused (B, S, H + 2 Hkv,
    256) projection, and at (192, 128) v a transposed (B, Hkv, S, 128)
    tensor, whose s stride is below its h stride."""
    rng = np.random.default_rng(6)

    def bf16(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda, torch.bfloat16)

    qkv = bf16((2, 150, 6, 256))
    cases = [(qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:], 64)]
    qk = bf16((2, 150, 6, 192))
    v = bf16((2, 2, 150, 128)).transpose(1, 2)
    cases.append((qk[:, :, :4], qk[:, :, 4:], v, 0))
    for q, k, v, window in cases:
        assert not q.is_contiguous() and tfa._tc_aligned(v)
        tfa.reset_launches()
        got = tfa.flash_attention(q, k, v, causal=True, window=window)
        assert tfa.LAUNCHES["flash_attention_tc"] == 1
        want = tref.flash_attention_ref(q, k, v, True, window)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


def test_flash_attention_ws_refuses_misaligned(cuda):
    """At (192, 128) too the tensor-core route raises on operands its TMA
    boxes cannot read, before any launch."""
    q, k, v = _ws_qkv((1, 8, 8, 4, 4, 192, 128), cuda, seed=1)
    buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    q_off = buf[1:].view(q.shape)                           # 2-byte offset
    q_off.copy_(q)
    tfa.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(q_off, k, v)
    wide = torch.zeros((1, 8, 4, 196), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa.flash_attention(q, wide[..., :192], v)          # h stride 196
    assert tfa.LAUNCHES["flash_attention"] == 0


def _forward_ptxas():
    import re

    tfa.LIBRARY.build()
    with open(tfa.LIBRARY.log_path()) as f:
        log = f.read()
    found = {}
    for name, body in re.findall(
            r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
            log, re.S):
        m = re.search(r"flash_attention_ws_kernelILi(\d+)ELi(\d+)ELi(\d)E",
                      name)
        if m:
            found[tuple(int(x) for x in m.groups())] = (name, body)
    return log, found


def test_flash_attention_ws_does_not_spill_or_serialise(cuda):
    """ptxas -v of the library: the warp-specialised forwards at (192,
    128) and (256, 256) spill no registers, and no "(C7520)" or "(C7515)"
    note (wgmma serialised: in a divergent path; an accumulator written
    between issue and wait) names them."""
    import re

    log, found = _forward_ptxas()
    # (hd, hdv, mode): past hd 128 mode 0 (no cluster); the split (mode
    # 1) at (64, 64)
    assert sorted(found) == [(64, 64, 1), (192, 128, 0),
                             (256, 256, 0)], found
    for name, body in found.values():
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      body)
        assert (int(m.group(1)), int(m.group(2))) == (0, 0), name
    notes = re.findall(r"\((C75\d\d)\).*? in the function '(\S+?)'", log)
    names = {name for name, _ in found.values()}
    assert not [n for n in notes if n[1] in names], notes


def test_forward_plan_smem_matches_ptxas_and_launch(cuda):
    """forward_plan's shared memory, threads and rows at every
    tensor-core pair against the source's launch (the dynamic bytes it
    sets on the kernel) and, past hd 128, ptxas's static bytes and
    registers; a launch at each pair then runs."""
    import re

    _, found = _forward_ptxas()
    # at a narrow pair, the narrow CTA (64 keys) and the general kernel
    # (past NARROW_MAX_LEN keys)
    sks = {pair: (64, tfa.NARROW_MAX_LEN + 1) for pair in tfa.NARROW_PAIRS}
    for hd, hdv in tfa.TC_HEAD_DIMS:
        for sk in sks.get((hd, hdv), (64,)):
            plan = tfa.forward_plan(1, 64, sk, 4, 4, hd, torch.bfloat16,
                                    hdv=hdv)
            narrow = plan["kernel"] == "flash_attention_narrow_kernel"
            assert narrow == (sk == 64 and (hd, hdv) in tfa.NARROW_PAIRS)
            attrs = tfa.tc_attributes(hd, hdv, plan["kernel"])
            assert attrs["smem_bytes"] == attrs["max_dynamic_smem_bytes"]
            assert (plan["smem_bytes"], plan["static_smem_bytes"],
                    plan["threads"], plan["rows"]) == (
                attrs["smem_bytes"], attrs["static_smem_bytes"],
                attrs["threads"], attrs["rows"]), (hd, hdv, sk)
            if hd > 128:
                _, body = found[(hd, hdv, 0)]
                m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem",
                              body)
                assert (int(m.group(1)), int(m.group(2))) == (
                    attrs["registers"], plan["static_smem_bytes"])
            q, k, v = _ws_qkv((1, 70, sk, 4, 4, hd, hdv), cuda, seed=hd)
            tfa.reset_launches()
            out = tfa.launch(q, k, v, True, 0, 0, "tc")
            torch.cuda.synchronize()
            assert out.shape == (1, 70, 4, hdv)
            assert tfa.LAUNCHES["flash_attention_narrow"] == int(narrow)


# the warp-specialised CTA split over a cluster at (64, 64), for launches
# without a mask (B, Sq, Sk, H, Hkv, hd, hdv): whisper-tiny's encoder
# (over 3 CTAs), ragged lengths, g = 3, a ragged q tile past one batch's
# end; each with its cluster
SPLIT_FA_CASES = [
    ((1, 1500, 1500, 6, 6, 64, 64), 3),
    ((1, 200, 333, 2, 2, 64, 64), 4),
    ((2, 129, 70, 3, 1, 64, 64), 2),
    ((3, 300, 1000, 4, 4, 64, 64), 4),
]


@pytest.mark.parametrize("case,split", SPLIT_FA_CASES,
                         ids=[f"split{s}-{i}" for i, (c, s)
                              in enumerate(SPLIT_FA_CASES)])
def test_flash_attention_split_matches_plain(cuda, case, split):
    """The warp-specialised forward split over a cluster against the plain
    version (bf16, 2e-2), its lse against the FMA kernel's (float32,
    1e-5): the plan names the cluster from the shapes, the launch counts
    on flash_attention_split, and a second launch gives the same bits
    (the split's rank-order sum)."""
    b, sq, sk, h, hkv, hd, hdv = case
    plan = tfa.forward_plan(b, sq, sk, h, hkv, hd, torch.bfloat16, hdv=hdv,
                            causal=False)
    assert (plan["kernel"], plan["cluster"]) == (
        "flash_attention_ws_kernel", split)
    q, k, v = _ws_qkv(case, cuda, seed=sum(case))
    tfa.reset_launches()
    got, lse = tfa._forward(q, k, v, False, 0, 0, "tc", with_lse=True)
    assert tfa.LAUNCHES["flash_attention_split"] == 1
    want = tref.flash_attention_ref(q, k, v, False, 0, 0)
    _, lse_fma = tfa._forward(q.float(), k.float(), v.float(), False, 0, 0,
                              "fma", with_lse=True)
    again = tfa.launch(q, k, v, False, 0, 0, "tc")
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, h, hdv)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, lse_fma, rtol=1e-5, atol=1e-5)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


def test_flash_attention_split_reads_strided_views(cuda):
    """q, k and v sliced out of a fused projection (no copies) through
    the split's tensor maps."""
    rng = np.random.default_rng(8)
    wide = torch.from_numpy(rng.normal(size=(1, 200, 6, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k, v = wide[:, :, :2], wide[:, :, 2:4], wide[:, :, 4:]
    plan = tfa.forward_plan(1, 200, 200, 2, 2, 64, torch.bfloat16,
                            causal=False)
    assert plan.get("cluster") == 4, plan
    assert not q.is_contiguous() and tfa._tc_aligned(k)
    tfa.reset_launches()
    got = tfa.flash_attention(q, k, v, causal=False)
    assert tfa.LAUNCHES["flash_attention_split"] == 1
    want = tref.flash_attention_ref(q, k, v, False)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_flash_attention_split_refuses_misaligned(cuda):
    """The split's tensor maps take what the other tensor-core
    kernels take: a q two bytes off its 16-byte boundary raises before
    any launch."""
    q, k, v = _ws_qkv((1, 256, 256, 6, 6, 64, 64), cuda, seed=2)
    assert tfa.forward_plan(1, 256, 256, 6, 6, 64, torch.bfloat16,
                            causal=False)["cluster"] == 4
    buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    q_off = buf[1:].view(q.shape)
    q_off.copy_(q)
    tfa.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(q_off, k, v, causal=False)
    assert tfa.LAUNCHES["flash_attention"] == 0


def test_split_plan_smem_matches_launch(cuda):
    """forward_plan's shared memory, threads and rows in the split against
    the loaded library's launch attributes and ptxas's static bytes and
    registers."""
    import re

    _, found = _forward_ptxas()
    for (hd, hdv, mode), (name, body) in found.items():
        if mode == 0:
            continue
        plan = tfa.forward_plan(1, 1500, 1500, 6, 6, hd, torch.bfloat16,
                                hdv=hdv, causal=False)
        attrs = tfa.tc_attributes(hd, hdv, plan["kernel"])
        assert plan["cluster"] == 3, (hd, plan)
        assert (plan["smem_bytes"], plan["static_smem_bytes"],
                plan["threads"], plan["rows"]) == (
            attrs["smem_bytes"], attrs["static_smem_bytes"],
            attrs["threads"], attrs["rows"]), (hd, hdv)
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", body)
        assert (int(m.group(1)), int(m.group(2))) == (
            attrs["registers"], plan["static_smem_bytes"])


# the backward at (64, 64) with H == Hkv, its dK / dV and dQ CTAs in one
# grid (B, Sq, Sk, H, causal): whisper-tiny's encoder in training, its
# decoder's cross-attention (Sq != Sk) and self-attention (causal),
# ragged lengths, one key tile
ONE_GRID_BWD_CASES = [
    (8, 1500, 1500, 6, False),
    (8, 448, 1500, 6, False),
    (8, 448, 448, 6, True),
    (1, 200, 333, 2, False),
    (2, 65, 64, 3, True),
    (1, 1000, 130, 2, False),
]


@pytest.mark.parametrize("case", ONE_GRID_BWD_CASES)
def test_flash_attention_one_grid_backward_matches_plain(cuda, case):
    """The one-grid backward through FlashAttentionFn against autograd
    through the plain version (BWD_TOL): two launches (D, then
    fa_bwd_dkdv_dq_tc_kernel), counted on flash_attention_bwd_one_grid;
    two backward runs give the same bits, and so does the four-kernel
    route whose CTAs it runs."""
    b, sq, sk, h, causal = case
    qkv, do = _bwd_inputs((b, sq, sk, h, h, 64), torch.bfloat16, cuda,
                          seed=sum(case))
    plan = tfa.backward_plan(b, sq, sk, h, h, 64, torch.bfloat16)
    assert [n for n, _ in plan["kernels"]] == [
        "fa_bwd_preprocess_tc_kernel", "fa_bwd_dkdv_dq_tc_kernel"]
    tfa.reset_launches()
    out = tfa.flash_attention(*qkv, causal=causal)
    got = torch.autograd.grad(out, qkv, do, retain_graph=True)
    again = torch.autograd.grad(out, qkv, do)
    assert tfa.LAUNCHES["flash_attention_bwd_one_grid"] == 2
    ref_out = tref.flash_attention_ref(*qkv, causal, 0, 0, 256, 256)
    want = torch.autograd.grad(ref_out, qkv, do)
    # the same CTAs launched as the two kernels (the separate launches
    # named): the same bits
    with torch.no_grad():
        o, lse = tfa._forward(*[t.detach() for t in qkv], causal, 0, 0,
                              "tc", with_lse=True)
    two = tfa.backward(do, *[t.detach() for t in qkv], o, lse, causal, 0,
                       one_grid=False)
    torch.cuda.synchronize()
    for g, g2, g3, w, t in zip(got, again, two, want, qkv):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        assert torch.equal(g.view(torch.int16), g2.view(torch.int16))
        assert torch.equal(g.view(torch.int16), g3.view(torch.int16))
        torch.testing.assert_close(g.float(), w.float(),
                                   **BWD_TOL[torch.bfloat16])


def test_flash_attention_one_grid_backward_strided_and_misaligned(cuda):
    """The one-grid backward reads q, k and v as views of a fused
    projection; a misaligned q raises before any launch."""
    rng = np.random.default_rng(9)
    qkv = torch.from_numpy(rng.normal(size=(2, 300, 12, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16).requires_grad_()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    do = torch.from_numpy(rng.normal(size=(2, 300, 4, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    tfa.reset_launches()
    out = tfa.flash_attention(q, k, v, causal=False)
    got, = torch.autograd.grad(out, qkv, do)
    assert tfa.LAUNCHES["flash_attention_bwd_one_grid"] == 1
    ref = tref.flash_attention_ref(q, k, v, False, 0, 0, 256, 256)
    want, = torch.autograd.grad(ref, qkv, do)
    torch.testing.assert_close(got.float(), want.float(),
                               **BWD_TOL[torch.bfloat16])
    (q, k, v), _ = _bwd_inputs((1, 128, 128, 2, 2, 64), torch.bfloat16,
                               cuda, seed=4)
    with torch.no_grad():
        buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
        q_off = buf[1:].view(q.shape)
        q_off.copy_(q)
    lse = torch.zeros((1, 2, 128), dtype=torch.float32, device=cuda)
    tfa.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        tfa.backward(q, q_off, k, v, q, lse, False, 0)
    assert tfa.LAUNCHES["flash_attention_bwd"] == 0


# the one-grid launch named at the other one-warpgroup pairs, H == Hkv
# (B, Sq, Sk, H, hd, hdv, causal): the (24, 16) pair past NARROW_MAX_LEN
# (the smoke's mla_smoke_257), ragged lengths at the rest
ONE_GRID_NAMED_CASES = [
    (2, 257, 257, 4, 24, 16, True),
    (1, 200, 333, 2, 16, 16, False),
    (2, 130, 130, 3, 32, 32, True),
    (1, 300, 200, 2, 128, 128, False),
]


@pytest.mark.parametrize("case", ONE_GRID_NAMED_CASES)
def test_flash_attention_one_grid_named_matches_separate(cuda, case):
    """fa_backward_tc's one-grid launch where a caller names it (the plan
    keeps the separate launches at these pairs): the same bits as the
    separate launches, within BWD_TOL of the plain version; GQA and a
    pair past hd 128 refuse it."""
    b, sq, sk, h, hd, hdv, causal = case
    (q, k, v), do = _bwd_inputs((b, sq, sk, h, h, hd), torch.bfloat16, cuda,
                                seed=sum(case), hdv=hdv)
    plan = tfa.backward_plan(b, sq, sk, h, h, hd, torch.bfloat16, hdv=hdv)
    assert plan["kernels"][-1][0] == "fa_bwd_dq_tc_kernel"
    o, lse = tfa._forward(q.detach(), k.detach(), v.detach(), causal, 0, 0,
                          "tc", with_lse=True)
    args = (do, q.detach(), k.detach(), v.detach(), o, lse, causal, 0)
    tfa.reset_launches()
    one = tfa.backward(*args, one_grid=True)
    two = tfa.backward(*args)
    assert tfa.LAUNCHES["flash_attention_bwd_one_grid"] == 1
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = tref.flash_attention_ref(*qkv, causal, 0, 0, 256, 256)
    want = torch.autograd.grad(ref, qkv, do)
    for g, g2, w in zip(one, two, want):
        assert torch.equal(g.view(torch.int16), g2.view(torch.int16))
        torch.testing.assert_close(g.float(), w.float(),
                                   **BWD_TOL[torch.bfloat16])
    (q, k, v), do = _bwd_inputs((1, 300, 300, 4, 2, hd), torch.bfloat16,
                                cuda, seed=1, hdv=hdv)
    o, lse = tfa._forward(q.detach(), k.detach(), v.detach(), True, 0, 0,
                          "tc", with_lse=True)
    with pytest.raises(RuntimeError, match="status"):
        tfa.backward(do, q.detach(), k.detach(), v.detach(), o, lse, True,
                     0, one_grid=True)
    (q, k, v), do = _bwd_inputs((1, 300, 300, 2, 2, 192), torch.bfloat16,
                                cuda, seed=1, hdv=128)
    o, lse = tfa._forward(q.detach(), k.detach(), v.detach(), True, 0, 0,
                          "tc", with_lse=True)
    with pytest.raises(RuntimeError, match="status"):
        tfa.backward(do, q.detach(), k.detach(), v.detach(), o, lse, True,
                     0, one_grid=True)


# (library, the kernels' mangled-name pattern, how many instantiations):
# the one-grid backward at each one-warpgroup pair, the split of the
# warp-specialised forward, and the float32 tensor-core ("tf32x3")
# forward and both backward kernels at every pair
NEW_KERNELS = [
    pytest.param("forward", r"flash_attention_ws_kernelILi64", 1,
                 id="ws_split"),
    pytest.param("backward", r"fa_bwd_dkdv_dq_tc_kernel", 5, id="one_grid"),
    pytest.param("forward", r"flash_attention_tf32_kernel", 7,
                 id="tf32x3_forward"),
    pytest.param("backward", r"fa_bwd_(dkdv|dq)_tf32_kernel", 14,
                 id="tf32x3_backward"),
]


@pytest.mark.parametrize("library,kernel,n", NEW_KERNELS)
def test_new_flash_kernels_do_not_spill_or_serialise(cuda, library, kernel,
                                                     n):
    """ptxas -v: each kernel spills nothing, and no "(C75xx)" note
    (wgmma serialised: C7520 in a divergent path, C7515 an accumulator
    touched between issue and wait, C7512 too few registers) names it."""
    import re

    lib = tfa.LIBRARY if library == "forward" else tfa.BWD_LIBRARY
    lib.build()
    with open(lib.log_path()) as f:
        log = f.read()
    found = {name: body for name, body in re.findall(
        r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
        log, re.S) if re.search(kernel, name)}
    assert len(found) == n, list(found)
    # C7520 / C7515 say "in the function", C7512 (too few registers)
    # "for the function"
    notes = re.findall(r"\((C75\d\d)\).*? (?:in|for) the function "
                       r"'(\S+?)'", log)
    for name, body in found.items():
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", body)
        assert (int(m.group(1)), int(m.group(2))) == (0, 0), name
        assert not [nt for nt in notes if nt[1] == name], notes


# (B, Sq, Sk, H, Hkv, hd, hdv, causal, window, q_offset) for the float32
# tensor-core route ("tf32x3") at every pair it takes: the serving and
# training shapes cut short, GQA, ragged tiles (Sq and Sk off multiples
# of 64 and of the 32-key tile), cross lengths, windows, appended queries
# and decode steps
TF32_FA_CASES = [
    (2, 130, 130, 4, 2, 16, 16, True, 0, 0),
    (1, 77, 200, 4, 4, 16, 16, False, 50, 100),
    (2, 256, 256, 4, 4, 24, 16, True, 0, 0),
    (1, 50, 90, 4, 2, 24, 16, True, 13, 40),
    (3, 77, 77, 4, 2, 32, 32, True, 0, 0),
    (1, 100, 150, 4, 4, 32, 32, False, 0, 0),
    (1, 300, 300, 6, 6, 64, 64, False, 0, 0),
    (2, 100, 300, 4, 4, 64, 64, False, 70, 200),
    (1, 1000, 1000, 12, 2, 128, 128, True, 0, 0),
    (1, 1000, 1000, 12, 2, 128, 128, True, 512, 0),
    (1, 1, 2048, 12, 2, 128, 128, True, 0, 2047),
    (1, 200, 100, 8, 2, 128, 128, False, 0, 0),
    (2, 130, 130, 4, 4, 192, 128, True, 0, 0),
    (1, 1000, 1000, 16, 16, 192, 128, True, 512, 0),
    (1, 1, 300, 16, 16, 192, 128, True, 0, 299),
    (1, 300, 300, 16, 1, 256, 256, True, 100, 0),
    (2, 77, 200, 4, 2, 256, 256, True, 50, 70),
    (1, 100, 300, 4, 4, 256, 256, False, 0, 0),
]


def _tf32_qkv(case, device):
    b, sq, sk, h, hkv, hd, hdv = case[:7]
    rng = np.random.default_rng(sum(case[:7]))
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
            for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hdv))]


def _lse_plain(q, k, v, causal, window, q_offset):
    """Each row's log-sum-exp of the scaled scores over the keys it
    attends, in float64 (B, H, Sq), and which rows attend any key."""
    g = q.shape[2] // k.shape[2]
    kk = k.double().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) / q.shape[-1] ** 0.5
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = torch.ones_like(qpos >= kpos)
    if causal:
        valid &= qpos >= kpos
    if window > 0:
        valid &= qpos - kpos < window
    lse = torch.logsumexp(s.masked_fill(~valid, float("-inf")), -1)
    return lse, valid.any(-1).expand_as(lse)


@pytest.mark.parametrize("case", TF32_FA_CASES,
                         ids=[f"tf32x3-{c[5]}-{c[6]}-{i}"
                              for i, c in enumerate(TF32_FA_CASES)])
def test_flash_attention_tf32x3_matches_plain(cuda, case):
    """The float32 tensor-core forward (three TF32 wgmma a product of
    split operands) against the plain version in float32 (FA_TOL, 2e-5):
    the output and each row's lse, which the route rule picks for
    float32 at every pair of TC_HEAD_DIMS; a second launch gives the
    same bits."""
    b, sq, sk, h, hkv, hd, hdv = case[:7]
    causal, window, q_offset = case[7:]
    q, k, v = _tf32_qkv(case, cuda)
    assert tfa._route(torch.float32, hd, hdv) == "tf32x3"
    tfa.reset_launches()
    got, lse = tfa._forward(q, k, v, causal, window, q_offset, "tf32x3",
                            with_lse=True)
    assert tfa.LAUNCHES["flash_attention_tf32x3"] == 1
    assert tfa.LAUNCHES["flash_attention_tc"] == 0
    want = tref.flash_attention_ref(q, k, v, causal, window, q_offset,
                                    skip_masked_chunks=True)
    lse_want, live = _lse_plain(q, k, v, causal, window, q_offset)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b, sq, h, hdv)
    torch.testing.assert_close(got, want, rtol=FA_TOL[torch.float32],
                               atol=FA_TOL[torch.float32])
    torch.testing.assert_close(lse[live].double(), lse_want[live],
                               rtol=FA_TOL[torch.float32],
                               atol=FA_TOL[torch.float32])
    assert torch.equal(got, tfa.launch(q, k, v, causal, window, q_offset,
                                       "tf32x3"))


def test_flash_attention_tf32x3_reads_strided_views(cuda):
    """float32 q / k / v sliced out of a fused projection (B, S, H + 2
    Hkv, hd) go through the float32 tensor-core kernel in place, forward
    and backward, against the plain version."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 90, 8, 64)).astype(
        np.float32)).to(cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert all(tfa._tc_aligned(t) for t in (q, k, v))
    tfa.reset_launches()
    got = tfa.flash_attention(q, k, v, causal=True)
    assert tfa.LAUNCHES["flash_attention_tf32x3"] == 1
    want = tref.flash_attention_ref(q, k, v, True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    views = [t.detach().requires_grad_() for t in (q, k, v)]
    do = torch.from_numpy(rng.normal(size=(2, 90, 4, 64)).astype(
        np.float32)).to(cuda)
    grads = torch.autograd.grad(tfa.flash_attention(*views), views, do)
    assert tfa.LAUNCHES["flash_attention_bwd_tf32x3"] == 1
    plain = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tref.flash_attention_ref(*plain, True),
                               plain, do)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, **BWD_TOL[torch.float32])


def test_flash_attention_tf32x3_backward_is_deterministic(cuda):
    """Two backward runs of the float32 tensor-core route give the same
    bits, with the GQA reduction (H > Hkv) and without, at the pairs
    past hd 128."""
    for case in ((1, 300, 300, 16, 1, 256, 256, True, 100),
                 (2, 200, 200, 4, 4, 192, 128, True, 0),
                 (1, 260, 260, 12, 2, 128, 128, True, 0)):
        qkv, do = _bwd_inputs(case, torch.float32, cuda, hdv=case[6])
        out = tfa.flash_attention(*qkv, causal=case[7], window=case[8])
        first = torch.autograd.grad(out, qkv, do, retain_graph=True)
        second = torch.autograd.grad(out, qkv, do)
        for a, b in zip(first, second):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_flash_attention_tf32x3_plans_match_the_library(cuda):
    """forward_plan's shared memory for the float32 tensor-core kernel is
    what the loaded library's launch sets, at every pair, under a CTA's
    232,448 bytes."""
    for hd, hdv in tfa.TC_HEAD_DIMS:
        plan = tfa.forward_plan(1, 256, 256, 4, 4, hd, torch.float32,
                                hdv=hdv)
        attrs = tfa.tc_attributes(hd, hdv, plan["kernel"])
        assert attrs["smem_bytes"] == plan["smem_bytes"] <= 232448
        assert attrs["max_dynamic_smem_bytes"] >= plan["smem_bytes"]
        assert attrs["threads"] == plan["threads"] == 128
