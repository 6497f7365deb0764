"""Card-only tests of the port: the Hopper kernels against their plain
versions, merge_blocks on the card against the CPU, MergePipe on the
card against the numpy stream engine, ANALYZE and a Session merge graph
on the card against the CPU, and the model's prefill on the card
against the CPU.  Imports nothing of JAX, so it
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
    # bf16 with hd >= 16 runs on the tensor cores; the rest on FMAs
    tc = dtype == torch.bfloat16 and case[5] >= 16
    assert tfa.LAUNCHES["flash_attention_tc"] == int(tc)
    want = tref.flash_attention_ref(q, k, v, causal, window, q_offset,
                                    skip_masked_chunks=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL[dtype],
                               atol=FA_TOL[dtype])


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
                            "flash_attention_bwd_tc": 0}
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


def test_flash_attention_tc_refuses_misaligned(cuda):
    """The tensor-core route raises on operands its 16-byte copies cannot
    read; it never falls back to the FMA kernel."""
    q, k, v = _qkv((1, 8, 8, 4, 2, 16), torch.bfloat16, cuda)
    buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    q_off = buf[1:].view(q.shape)                           # 2-byte offset
    q_off.copy_(q)
    tfa.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(q_off, k, v)
    wide = torch.zeros((1, 8, 2, 20), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa.flash_attention(q, wide[..., :16], v)           # h stride 20
    with pytest.raises(ValueError, match="tensor-core route takes"):
        tfa.launch(q.float(), k.float(), v.float(), True, 0, 0, route="tc")
    assert tfa.LAUNCHES == {"flash_attention": 0, "flash_attention_tc": 0,
                            "flash_attention_bwd": 0,
                            "flash_attention_bwd_tc": 0}


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


# (B, Sq, Sk, H, Hkv, hd, causal, window): the backward takes q_offset 0
BWD_CASES = [
    (2, 130, 130, 4, 2, 16, True, 0),      # GQA causal, ragged tiles
    (1, 200, 200, 6, 2, 8, True, 70),      # window, hd 8
    (1, 100, 150, 4, 4, 32, False, 0),     # cross, MHA, ragged
    (1, 150, 150, 2, 1, 64, False, 40),    # window without causal
    (1, 256, 256, 12, 2, 128, True, 0),    # the model's heads
    (1, 64, 64, 2, 1, 128, True, 1),       # each row attends itself
    (2, 1000, 1000, 12, 2, 128, True, 0),  # the model's heads, ragged
]
# (dtype, backward route): float32 takes the FMA route; bf16 both, the
# tensor cores only with hd in TC_HEAD_DIMS
BWD_PARAMS = [
    pytest.param(case, dtype, route, id=f"{name}-{route}-{i}")
    for i, case in enumerate(BWD_CASES)
    for name, dtype, route in (("f32", torch.float32, "fma"),
                               ("bf16", torch.bfloat16, "fma"),
                               ("bf16", torch.bfloat16, "tc"))
    if route == "fma" or case[5] in tfa.TC_HEAD_DIMS
]
# the backward against autograd through the plain version: float32 sums
# in another order; bf16 gradients one bf16 rounding apart (the forward's
# P is rounded to bf16 on the tensor-core route)
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _bwd_inputs(case, dtype, device, seed=0):
    b, sq, sk, h, hkv, hd = case[:6]
    q, k, v = _qkv(case, dtype, device, seed)
    do = torch.from_numpy(np.random.default_rng(seed + 9).normal(
        size=(b, sq, h, hd)).astype(np.float32)).to(device=device, dtype=dtype)
    return [t.requires_grad_() for t in (q, k, v)], do


@pytest.mark.parametrize("case,dtype,route", BWD_PARAMS)
def test_flash_attention_fn_grads_match_plain_autograd(cuda, case, dtype,
                                                       route, monkeypatch):
    """FlashAttentionFn (forward kernel with lse, backward kernels on the
    given route) against autograd through ``flash_attention_ref`` on the
    card; two backward runs give the same bits."""
    import functools

    causal, window = case[6:]
    qkv, do = _bwd_inputs(case, dtype, cuda)
    monkeypatch.setattr(tfa, "backward",
                        functools.partial(tfa.backward, route=route))
    tfa.reset_launches()
    out = tfa.flash_attention(*qkv, causal=causal, window=window)
    got = torch.autograd.grad(out, qkv, do, retain_graph=True)
    again = torch.autograd.grad(out, qkv, do)
    assert tfa.LAUNCHES["flash_attention"] == 1
    assert tfa.LAUNCHES["flash_attention_bwd"] == 2
    assert tfa.LAUNCHES["flash_attention_bwd_tc"] == (2 if route == "tc"
                                                      else 0)
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


def test_flash_attention_fn_forward_equals_launch(cuda):
    """The lse-writing forward gives the serving kernel's bits; lse is
    the row log-sum-exp of the scaled scores."""
    case = (2, 100, 100, 4, 2, 16, True, 0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(case, dtype, cuda)
        route = tfa._route(dtype, 16)
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
    """The route rule: bf16 with hd in TC_HEAD_DIMS trains through the
    tensor-core backward, float32 through the FMA one."""
    case = (1, 64, 64, 4, 2, 32, True, 0)
    for dtype, tc in ((torch.bfloat16, 1), (torch.float32, 0)):
        qkv, do = _bwd_inputs(case, dtype, cuda)
        tfa.reset_launches()
        torch.autograd.grad(tfa.flash_attention(*qkv), qkv, do)
        assert tfa.LAUNCHES["flash_attention_bwd"] == 1
        assert tfa.LAUNCHES["flash_attention_bwd_tc"] == tc


def _misaligned(t):
    """The same values in a view that starts 2 bytes past a 16-byte
    boundary (so not on the tensor-core route's boundary)."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def test_flash_attention_backward_tc_copies_misaligned_grad(cuda):
    """An upstream gradient off the 16-byte rule (an offset view, or a
    head stride that is no multiple of 8) is copied, not refused: the
    same bits as from the aligned gradient."""
    case = (2, 70, 70, 4, 2, 16, True, 0)
    qkv, do = _bwd_inputs(case, torch.bfloat16, cuda)
    q, k, v = (t.detach() for t in qkv)
    out, lse = tfa._forward(q, k, v, True, 0, 0, "tc", with_lse=True)
    wide = torch.zeros((2, 70, 4, 20), dtype=torch.bfloat16, device=cuda)
    wide[..., :16] = do
    views = [_misaligned(do), wide[..., :16]]
    assert not any(tfa._tc_aligned(t) for t in views)
    want = tfa.backward(do, q, k, v, out, lse, True, 0, route="tc")
    for view in views:
        got = tfa.backward(view, q, k, v, out, lse, True, 0, route="tc")
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int16), w.view(torch.int16))


def test_flash_attention_backward_tc_refuses_misaligned_qkv(cuda):
    """q, k or v off the 16-byte rule is refused on the tensor-core
    route (no copy, no other route)."""
    qkv, do = _bwd_inputs((1, 64, 64, 4, 2, 16, True, 0), torch.bfloat16,
                          cuda)
    q, k, v = (t.detach() for t in qkv)
    out, lse = tfa._forward(q, k, v, True, 0, 0, "tc", with_lse=True)
    tfa.reset_launches()
    for i in range(3):
        ops = [q, k, v]
        ops[i] = _misaligned(ops[i])
        with pytest.raises(ValueError, match="tensor-core route"):
            tfa.backward(do, *ops, out, lse, True, 0, route="tc")
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
