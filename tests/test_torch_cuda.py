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
    # TIES: the threshold kernel, then the apply kernel
    assert sum(tmb.LAUNCHES.values()) == (2 if op == "ties" else 1)
    assert tmb.LAUNCHES["ties_threshold"] == (op == "ties")


def _threshold_rows(w, seed):
    """(2, 6, w) float32 deltas with the edge rows of the TIES trim."""
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


@pytest.mark.parametrize("w", [1, 2, 3, 5, 1001, 4096, 65536, 65537,
                               1 << 20])
@pytest.mark.parametrize("trim", [0.0, 0.3, 0.999, 1.0])
@pytest.mark.parametrize("offset", [0, 1])
def test_ties_threshold_kernel_equals_kthvalue(cuda, w, trim, offset):
    """Bit for bit: np.partition, as the numpy operator takes it, and
    torch.kthvalue on the card, whose abs and radix select return every
    NaN as the canonical 0x7FFFFFFF (the kernel keeps the payload, as
    np.abs does; a NaN threshold keeps nothing in either); -inf without
    a launch when keep >= W."""
    D = _threshold_rows(w, w)
    buf = torch.zeros(D.size + offset, device=cuda)
    Dc = buf[offset:].view(D.shape)                        # rows off 16 B
    Dc.copy_(torch.from_numpy(D))
    keep = tref.ties_keep(trim, w)
    tmb.reset_launches()
    got = tmb.ties_thresholds(Dc, trim)
    assert tmb.LAUNCHES["ties_threshold"] == (keep < w)
    want = tref.ties_thresholds(Dc, trim)
    torch.cuda.synchronize()
    assert got.shape == (2, 6) and got.dtype == torch.float32
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
    assert tmb.LAUNCHES["ties_threshold"] == 1
    assert tmb.LAUNCHES["ties_merge"] == 1
    for b in range(3):
        want = np.asarray(ties_merge(x0[b], D[b], theta), dtype=np.float32)
        np.testing.assert_array_equal(got[b].view(np.uint32),
                                      want.view(np.uint32))


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
                assert tmb.LAUNCHES["ties_merge"] > 0
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
    assert tfa.LAUNCHES == {"flash_attention": 1, "flash_attention_tc": 0}
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
    assert tfa.LAUNCHES == {"flash_attention": 0, "flash_attention_tc": 0}


def test_flash_attention_wrapper_refuses(cuda):
    q, k, v = _qkv((1, 8, 8, 4, 2, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._check(q.cpu(), k.cpu(), v.cpu(), 0, 0)        # CPU operands
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k.cpu(), v)                  # mixed devices
    with pytest.raises(ValueError, match="grad"):
        tfa.flash_attention(q.clone().requires_grad_(), k, v)
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
